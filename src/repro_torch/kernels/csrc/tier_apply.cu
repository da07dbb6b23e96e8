// Fused tier-stack APPLY prologue for Hopper (sm_90a): tier membership plus
// the hot-tier insert linearization and the eviction policy's victim choice.
//
// Replaces the Pallas kernel `tier_apply_tiles` / `_ta_kernel` /
// `spill_chunk_probe` in src/repro/kernels/tier_apply/kernel.py (both warm
// layouts: the level-major `level_walk` or, with `blocked`, the block-major
// `TeamBlockWalk` of the reference's `warm_blocked` branch; with and without
// spill; policies none / lru / size). Lanes come in sorted (slot, key) order
// with the key-run and slot-run starts precomputed by the glue (`krs[i]` is
// i or `krs[i - 1]`, and so is `srs[i]`); the nine outputs are the
// reference's, in the same lane order: in_warm, in_spill, placed, exists,
// dup, need_ev (int8) and col, vcol, ecol (int32).
//
// Two launches:
//   1. `tier_apply_member_kernel`, a team of lanes a lane (probe.cuh):
//      the bucket row and its metadata in one round (a ballot gives the
//      existence column and the empty mask; under a policy the victim
//      order, a counting rank over the score row with ties by column and
//      empty cells last, is counted across the team with shuffles and
//      packed 4 bits a column); then, only for an inserting lane that the
//      hot tier misses, the warm walk (`level_walk` on one lane of the team,
//      or the warp's whole-node counts, `TeamBlockWalk<32>`) and, if
//      that misses, the team's k-ary search of the spill runs
//      (`team_spill_probe`). It also zeroes the
//      scan launch's tile states and ticket. The team is 32 lanes in the
//      block layout, whose node counts read 128 keys a node. In the level
//      layout the walk runs on one lane, so a wider team only pays where
//      the card would otherwise hold idle thread slots: the widest of 16,
//      8, 4, 2 and 1 lanes whose k teams fit the card's resident threads
//      at once (kernel.py, `member_team`; `tier_apply_member_slots`).
//   2. `tier_apply_scan_kernel`, one block of TA_TILE lanes a tile, tiles
//      taken in order from an atomic ticket. Of the reference's three
//      K-wide prefix sums, two are only read as counts within a run: dup is
//      "an inserting lane earlier in the same key run", and a candidate's
//      rank counts the candidates earlier in its slot run. A tile counts
//      them with in-tile prefix sums from the run's start; a run open at the
//      tile's start takes its carry from the earlier tiles' published run
//      words (a decoupled look-back that stops at the first tile holding a
//      run start). Only the need-evict count against `max_evict` is a prefix
//      over the whole batch: a single-pass chained scan with decoupled
//      look-back. The outputs depend on a slot-run rank only up to 2B, so
//      its carry saturates at 32.
//
// Bound: memory latency. The membership launch's rounds per lane are one
// for the bucket row, L + 1 for the level walk (or one a node for the block
// walk) and ~log_(g+1) of a run's length for the spill search (g lanes a
// run), where one thread alone took up to B + L + 1 + 19 x runs dependent
// reads. The scan launch is a few block-wide prefix sums a tile plus up to
// three look-backs, each usually answered by the previous tile.
#include <limits.h>

#include "probe.cuh"

#define TA_TILE 256   // lanes a scan tile, one a thread

// A published tile word: READY | FLAG | value (30 bits). FLAG marks a run
// start in the tile (run words) or an inclusive prefix (evict words).
#define TA_READY 0x80000000u
#define TA_FLAG 0x40000000u
#define TA_VALUE 0x3FFFFFFFu
#define TA_RANK_SAT 32

// The victim order of a bucket row, by the team: lru evicts the oldest
// stamp, size the largest weight; empty cells rank last; ties by column.
// A counting rank over the row's scores, each column's position counted
// across the team with shuffles, packed 4 bits a position (every lane gets
// the packed order).
template <int TEAM>
__device__ __forceinline__ u64 team_victim_order(const int* meta_row,
                                                 unsigned empty, int b,
                                                 int policy,
                                                 const Team<TEAM>& tm) {
  constexpr int COLS = Team<TEAM>::COLS;
  int sc[COLS], pos[COLS];
#pragma unroll
  for (int j = 0; j < COLS; ++j) {
    const int c = tm.lane + j * TEAM;
    const int mv = c < b ? meta_row[c] : 0;
    sc[j] = c < b && !((empty >> c) & 1)
                ? (policy == 1 ? mv : (int)(0u - (unsigned)mv))
                : INT_MAX;
    pos[j] = 0;
  }
#pragma unroll
  for (int q = 0; q < MAX_BUCKET; ++q) {
    if (q >= b) break;
    const int sq = __shfl_sync(tm.warp, sc[q / TEAM], q % TEAM, TEAM);
#pragma unroll
    for (int j = 0; j < COLS; ++j)
      pos[j] += (sq < sc[j] || (sq == sc[j] && q < tm.lane + j * TEAM)) ? 1
                                                                         : 0;
  }
  u64 packed = 0;
#pragma unroll
  for (int j = 0; j < COLS; ++j) {
    const int c = tm.lane + j * TEAM;
    if (c < b) packed |= (u64)c << (4 * pos[j]);
  }
#pragma unroll
  for (int o = TEAM / 2; o > 0; o >>= 1)
    packed |= __shfl_xor_sync(tm.warp, packed, o, TEAM);
  return packed;
}

#define TA_MEMBER_THREADS 256

// A team of TEAM lanes a lane; BLOCKED picks the warm layout. A team of 16
// or 32: at most 32 registers, 8 blocks (every warp slot) an SM; a
// narrower team, whose plans are the wide ones, keeps more of its probes'
// loads in registers (at most 128).
template <int TEAM, bool BLOCKED>
__global__ void __launch_bounds__(TA_MEMBER_THREADS, TEAM >= 16 ? 8 : 2)
    tier_apply_member_kernel(
    const u64* __restrict__ sk, const int* __restrict__ ss,
    const int8_t* __restrict__ sm, int k, const u64* __restrict__ hot_keys,
    const int* __restrict__ meta, int m, int b,
    const u64* __restrict__ warm_keys, const int* __restrict__ lvl_child,
    const int* __restrict__ lvl_off, int levels, int width,
    const u64* __restrict__ term_keys, const int8_t* __restrict__ term_mark,
    int cap, int n_pad, const u64* __restrict__ sp_keys,
    const int8_t* __restrict__ sp_dead, const int* __restrict__ run_off,
    int runs, int s, int policy,
    int8_t* __restrict__ in_warm, int8_t* __restrict__ in_spill,
    int* __restrict__ ecol, int8_t* __restrict__ flags, int* __restrict__ emask,
    u64* __restrict__ vorder, unsigned* __restrict__ scan_state, int n_state) {
  __shared__ int off[MAX_LEVELS + 1];
  __shared__ int roff[MAX_RUNS + 1];
  __shared__ int live[MAX_RUNS];
  __shared__ int n_live;
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid < n_state) scan_state[gid] = 0;
  if (!BLOCKED) load_table(off, lvl_off, levels + 1);
  if (runs > 0) load_runs(roff, live, &n_live, run_off, runs);
  const long long li = gid / TEAM;
  const Team<TEAM> tm = this_team<TEAM>(li < k);
  if (li >= k) return;                 // whole teams leave together
  const int i = (int)li;

  const bool smb = sm[i] != 0;
  const u64 key = sk[i];
  const int slot = ss[i];
  unsigned empty;
  const unsigned hits = team_bucket_row(key, slot, hot_keys, m, b, tm, &empty);
  const bool any = hits != 0;

  // membership, falling through the tiers: a masked-off lane, or one the
  // hot tier holds, is in no lower tier; a warm hit skips the spill. The
  // team bodies sync over the whole warp, so every lane reaches them.
  const bool probe = smb && !any;
  bool f_warm = false, f_sp = false;
  int unused;
  if constexpr (BLOCKED) {
    // the warp counts each whole node (the same for the whole warp)
    TeamBlockWalk<TEAM> walk(key, warm_keys, levels, width, term_keys,
                             term_mark, cap, n_pad, tm, probe);
    run_side(walk, tm);
    f_warm = walk.found;
  } else {
    bool w = false;
    if (probe && tm.lane == 0)
      w = level_walk(key, warm_keys, lvl_child, off, levels, width,
                     term_keys, term_mark, cap, &unused);
    f_warm = team_ballot(tm, w) != 0;
  }
  NoSide none;                         // the search waits on the walk
  if (runs > 0)
    f_sp = team_spill_probe(key, probe && !f_warm, sp_keys, sp_dead, roff,
                            live, n_live, s, tm, &unused, none);

  if (policy != 0) {
    const u64 packed = team_victim_order(
        meta + (long long)clampi(slot, 0, m - 1) * b, empty, b, policy, tm);
    if (tm.lane == 0) vorder[i] = packed;
  }
  if (tm.lane == 0) {
    const bool sm_ins = smb && !f_warm && !f_sp;
    in_warm[i] = f_warm ? 1 : 0;
    in_spill[i] = f_sp ? 1 : 0;
    ecol[i] = any ? __ffs(hits) - 1 : 0;
    emask[i] = (int)empty;
    flags[i] = (sm_ins ? 1 : 0) | (any ? 2 : 0);
  }
}

// Warp 0: the sum of the values of tiles tile - 1, tile - 2, ... back to and
// including the first one whose word is FLAGged (tile 0's always is),
// saturated at `sat`; waits for each word to be published.
__device__ __forceinline__ int ta_lookback(const volatile unsigned* words,
                                           int tile, int sat) {
  const int lane = threadIdx.x & 31;
  int sum = 0;
  for (int p = tile - 1; p >= 0 && sum < sat; p -= 32) {
    const int q = p - lane;
    unsigned w = 0;
    if (q >= 0)
      do w = words[q]; while (!(w & TA_READY));
    const unsigned flagged = __ballot_sync(0xffffffffu, q < 0 || (w & TA_FLAG));
    const int upto = flagged ? __ffs(flagged) - 1 : 31;
    int v = lane <= upto ? (int)(w & TA_VALUE) : 0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    sum = min(sum + v, sat);
    if (flagged) break;
  }
  return sum;
}

// Block-wide exclusive prefix of v into ex[0 .. TA_TILE - 1], the total in
// ex[TA_TILE]. Every thread must call it.
__device__ __forceinline__ void ta_scan(int v, int* ex) {
  int total;
  const int e = block_exclusive_scan(v, &total);
  ex[threadIdx.x] = e;
  if (threadIdx.x == 0) ex[TA_TILE] = total;
  __syncthreads();
}

__global__ void __launch_bounds__(TA_TILE) tier_apply_scan_kernel(
    int k, int b, int policy, const int* __restrict__ krs,
    const int* __restrict__ srs, const int8_t* __restrict__ flags,
    const int* __restrict__ emask, const u64* __restrict__ vorder,
    const int* __restrict__ max_evict, unsigned* state,
    int8_t* __restrict__ placed, int8_t* __restrict__ exists,
    int8_t* __restrict__ dup, int8_t* __restrict__ need_ev,
    int* __restrict__ col, int* __restrict__ vcol) {
  __shared__ int ex[TA_TILE + 1];
  __shared__ int s_tile, s_carry;
  // state: the ticket, then one key-run, slot-run and evict word a tile
  const int ntiles = gridDim.x;
  volatile unsigned* kw = state + 1;
  volatile unsigned* sw = kw + ntiles;
  volatile unsigned* ew = sw + ntiles;
  if (threadIdx.x == 0) s_tile = (int)atomicAdd(state, 1u);
  __syncthreads();
  const int tile = s_tile;
  const int t0 = tile * TA_TILE;
  const int t1 = min(t0 + TA_TILE, k);
  const int i = t0 + threadIdx.x;
  const bool in = i < t1;
  const int fl = in ? flags[i] : 0;
  const int smi = fl & 1;
  const int kr = in ? krs[i] : i;
  const int s0 = in ? srs[i] : i;
  const int last_kr = krs[t1 - 1];
  const int last_sr = srs[t1 - 1];
  const bool k_open = krs[t0] < t0;    // the first key run began earlier
  const bool s_open = srs[t0] < t0;

  // 1. key runs: an inserting lane earlier in the lane's key run
  ta_scan(smi, ex);
  if (threadIdx.x == 0) {
    const int from = last_kr >= t0 ? last_kr - t0 : 0;
    kw[tile] = TA_READY | (last_kr >= t0 ? TA_FLAG : 0u) |
               (ex[TA_TILE] - ex[from] > 0 ? 1u : 0u);
  }
  if (threadIdx.x < 32) {
    const int c = k_open ? ta_lookback(kw, tile, 1) : 0;
    if (threadIdx.x == 0) s_carry = c;
  }
  __syncthreads();
  const bool d = smi && (ex[threadIdx.x] - ex[max(kr, t0) - t0] > 0 ||
                         (kr < t0 && s_carry > 0));
  const bool e = smi && (fl & 2) && !d;
  const bool c = smi && !d && !e;
  __syncthreads();                     // ex and s_carry are reused

  // 2. slot runs: the candidates earlier in the lane's slot run
  ta_scan(c ? 1 : 0, ex);
  if (threadIdx.x == 0) {
    const int from = last_sr >= t0 ? last_sr - t0 : 0;
    sw[tile] = TA_READY | (last_sr >= t0 ? TA_FLAG : 0u) |
               (unsigned)min(ex[TA_TILE] - ex[from], TA_RANK_SAT);
  }
  if (threadIdx.x < 32) {
    const int cs = s_open ? ta_lookback(sw, tile, TA_RANK_SAT) : 0;
    if (threadIdx.x == 0) s_carry = cs;
  }
  __syncthreads();
  const int rank = ex[threadIdx.x] - ex[max(s0, t0) - t0] +
                   (s0 < t0 ? s_carry : 0);

  // within-slot placement: the nth empty column, else the victim column
  const int em = in ? emask[i] : 0;
  const int n_empty = __popc(em);
  int col_e = b, seen = 0;
  bool fit = false;
  for (int j = 0; j < b; ++j) {
    if ((em >> j) & 1) {
      if (++seen == rank + 1) {
        col_e = j;
        fit = true;
        break;
      }
    }
  }
  int vc = 0;
  bool ne = false;
  if (policy != 0 && in) {
    const int ev_rank = rank - n_empty;
    vc = (int)((vorder[i] >> (4 * clampi(ev_rank, 0, b - 1))) & 0xF);
    ne = c && !fit && (ev_rank < b - n_empty);
  }
  __syncthreads();                     // ex and s_carry are reused

  // 3. need-evict: the count over the whole batch against max_evict
  ta_scan(ne ? 1 : 0, ex);
  if (threadIdx.x < 32) {
    const unsigned agg = (unsigned)ex[TA_TILE];
    int before = 0;
    if (tile > 0) {
      if (threadIdx.x == 0) ew[tile] = TA_READY | agg;
      before = ta_lookback(ew, tile, INT_MAX);
    }
    if (threadIdx.x == 0) {
      ew[tile] = TA_READY | TA_FLAG | ((unsigned)before + agg);
      s_carry = before;
    }
  }
  __syncthreads();
  if (!in) return;
  const bool fin = ne && (s_carry + ex[threadIdx.x] < max_evict[0]);
  dup[i] = d ? 1 : 0;
  exists[i] = e ? 1 : 0;
  vcol[i] = vc;
  col[i] = fit ? col_e : vc;
  placed[i] = ((c && fit) || fin) ? 1 : 0;
  need_ev[i] = fin ? 1 : 0;
}

#define TA_MEMBER_ARGS                                                      \
  (const u64*)sk, (const int*)ss, (const int8_t*)sm, k, (const u64*)hot_keys, \
      (const int*)meta, m, b, (const u64*)warm_keys, (const int*)lvl_child,   \
      (const int*)lvl_off, levels, width, (const u64*)term_keys,              \
      (const int8_t*)term_mark, cap, n_pad, (const u64*)sp_keys,              \
      (const int8_t*)sp_dead, (const int*)run_off, runs, s, policy,           \
      (int8_t*)in_warm, (int8_t*)in_spill, (int*)ecol, (int8_t*)flags,        \
      (int*)emask, (u64*)vorder, (unsigned*)scan_state, n_state

// Resident threads an SM of the level layout's membership instance for
// `team` on the current device (the occupancy API), 0 for a width it does
// not have.
template <int TEAM>
static int ta_member_slots() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, tier_apply_member_kernel<TEAM, false>, TA_MEMBER_THREADS,
          0) != cudaSuccess)
    return 0;
  return blocks * TA_MEMBER_THREADS;
}

extern "C" int tier_apply_member_slots(int team) {
  switch (team) {
    case 16: return ta_member_slots<16>();
    case 8: return ta_member_slots<8>();
    case 4: return ta_member_slots<4>();
    case 2: return ta_member_slots<2>();
    case 1: return ta_member_slots<1>();
    default: return 0;
  }
}

// `scan_state` is [1 + 3 * ceil(k / TA_TILE)] int32 scratch; the
// membership launch zeroes it for the scan launch. `team` is the lanes a
// lane: 32 in the block layout, 1, 2, 4, 8 or 16 in the level layout
// (kernel.py, `member_team`).
extern "C" int tier_apply_member_launch(
    const void* sk, const void* ss, const void* sm, int k, const void* hot_keys,
    const void* meta, int m, int b, int blocked, const void* warm_keys,
    const void* lvl_child, const void* lvl_off, int levels, int width,
    const void* term_keys, const void* term_mark, int cap, int n_pad,
    const void* sp_keys, const void* sp_dead, const void* run_off, int runs,
    int s, int policy, void* in_warm,
    void* in_spill, void* ecol, void* flags, void* emask, void* vorder,
    void* scan_state, int n_state, int team, void* stream) {
  if (k == 0) return 0;
  const int threads = TA_MEMBER_THREADS;
  long long total = (long long)k * team;
  if (total < n_state) total = n_state;
  const int grid = (int)((total + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  if (blocked && team == 32)
    tier_apply_member_kernel<32, true><<<grid, threads, 0, st>>>(TA_MEMBER_ARGS);
  else if (blocked)
    return (int)cudaErrorInvalidValue;
  else if (team == 16)
    tier_apply_member_kernel<16, false><<<grid, threads, 0, st>>>(TA_MEMBER_ARGS);
  else if (team == 8)
    tier_apply_member_kernel<8, false><<<grid, threads, 0, st>>>(TA_MEMBER_ARGS);
  else if (team == 4)
    tier_apply_member_kernel<4, false><<<grid, threads, 0, st>>>(TA_MEMBER_ARGS);
  else if (team == 2)
    tier_apply_member_kernel<2, false><<<grid, threads, 0, st>>>(TA_MEMBER_ARGS);
  else if (team == 1)
    tier_apply_member_kernel<1, false><<<grid, threads, 0, st>>>(TA_MEMBER_ARGS);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int tier_apply_scan_launch(
    int k, int b, int policy, const void* krs, const void* srs,
    const void* flags, const void* emask, const void* vorder,
    const void* max_evict, void* scan_state, void* placed, void* exists,
    void* dup, void* need_ev, void* col, void* vcol, void* stream) {
  if (k == 0) return 0;
  tier_apply_scan_kernel<<<(k + TA_TILE - 1) / TA_TILE, TA_TILE, 0,
                           (cudaStream_t)stream>>>(
      k, b, policy, (const int*)krs, (const int*)srs, (const int8_t*)flags,
      (const int*)emask, (const u64*)vorder, (const int*)max_evict,
      (unsigned*)scan_state, (int8_t*)placed, (int8_t*)exists, (int8_t*)dup,
      (int8_t*)need_ev, (int*)col, (int*)vcol);
  return (int)cudaGetLastError();
}
