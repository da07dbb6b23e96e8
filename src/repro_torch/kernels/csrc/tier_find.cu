// Fused tier-stack FIND for Hopper (sm_90a): hot bucket probe, warm walk and
// the spill runs' search in one launch, a team of lanes a query.
//
// Replaces the Pallas kernel `tier_find_tiles` / `_tf_kernel` /
// `spill_run_probe` in src/repro/kernels/tier_find/kernel.py, both warm
// layouts. The raw per-tier results come out, as the reference's: hot hit
// and column, warm hit and terminal index, spill hit and cell; the
// fall-through masking stays in the glue. Every lane runs all three probes.
//
// Design (the bodies in probe.cuh): a team of TEAM lanes a query reads the
// bucket row in one round (`team_bucket_row`; the column is the lowest hit)
// and searches the non-empty spill runs side by side, a (g + 1)-ary search
// a run (`team_spill_probe`). The warm walk does not depend on the spill
// search, so its rounds run inside the search's (the walk is a stepper the
// search issues and takes each round): a query's chain of dependent rounds
// is 1 + max(walk, spill) instead of 1 + walk + spill. The level layout
// walks on the team's first lane (`LevelWalk`, L + 1 rounds); in the block
// layout the whole team walks (`TeamBlockWalk`: a warp counts each 128-key
// node in one round, a narrower team searches it). The team width comes
// from the wrapper (kernel.py, `find_team`): the widest of the layout's
// instances whose teams are all resident, by the occupancy of this file's
// instances (`tier_find_slots`). On the H100 that is 16 (level) or 32
// (block) lanes at 4,096 queries and 2 at 65,536 in both layouts.
//
// Bound: memory latency, and at the preload width the sectors the probes
// read. One thread a query (the first design) ran 1 + (L + 1) + runs x ~19
// dependent reads back to back (a 2^19-cell run's binary search), the
// block walk reading each 1-KB node alone; a team searches g + 1 ways at
// once and overlaps the walk, and only the probes' cells are read from
// global memory, the level and run offset tables coming from shared
// memory.
#include "probe.cuh"

#define TF_THREADS 256

template <int TEAM, bool BLOCKED>
__global__ void __launch_bounds__(TF_THREADS, 4) tier_find_kernel(
    const u64* __restrict__ q, const int* __restrict__ slots, int t,
    const u64* __restrict__ hot_keys, int m, int b,
    const u64* __restrict__ warm_keys, const int* __restrict__ lvl_child,
    const int* __restrict__ lvl_off, int levels, int width,
    const u64* __restrict__ term_keys, const int8_t* __restrict__ term_mark,
    int cap, int n_pad, const u64* __restrict__ sp_keys,
    const int8_t* __restrict__ sp_dead, const int* __restrict__ run_off,
    int runs, int s,
    int8_t* __restrict__ hot_found, int* __restrict__ hot_col,
    int8_t* __restrict__ warm_found, int* __restrict__ warm_idx,
    int8_t* __restrict__ sp_found, int* __restrict__ sp_cell) {
  __shared__ int off[MAX_LEVELS + 1];
  __shared__ int roff[MAX_RUNS + 1];
  __shared__ int live[MAX_RUNS];
  __shared__ int n_live;
  if (!BLOCKED) load_table(off, lvl_off, levels + 1);
  if (runs > 0) load_runs(roff, live, &n_live, run_off, runs);
  const long long qi =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / TEAM;
  const Team<TEAM> tm = this_team<TEAM>(qi < t);
  if (qi >= t) return;                 // whole teams leave together
  const int i = (int)qi;
  const u64 key = q[i];
  unsigned empty;
  const unsigned hits = team_bucket_row(key, slots[i], hot_keys, m, b, tm,
                                        &empty);
  // the spill search with the warm walk's rounds inside it, or the walk
  // alone when there is no spill tier
  bool f_warm, f_sp = false;
  int at, cell = 0;
  auto probe = [&](auto& walk) {
    if (runs > 0)
      f_sp = team_spill_probe(key, true, sp_keys, sp_dead, roff, live,
                              n_live, s, tm, &cell, walk);
    else
      run_side(walk, tm);
  };
  if constexpr (BLOCKED) {
    TeamBlockWalk<TEAM> walk(key, warm_keys, levels, width, term_keys,
                             term_mark, cap, n_pad, tm, true);
    probe(walk);
    f_warm = walk.found;
    at = walk.idx;
  } else {
    LevelWalk walk(key, warm_keys, lvl_child, off, levels, width, term_keys,
                   term_mark, cap, tm.lane == 0);
    probe(walk);
    f_warm = team_ballot(tm, walk.found) != 0;
    at = __shfl_sync(tm.warp, walk.idx, 0, TEAM);
  }
  if (tm.lane == 0) {
    hot_found[i] = hits ? 1 : 0;
    hot_col[i] = hits ? __ffs(hits) - 1 : 0;
    warm_found[i] = f_warm ? 1 : 0;
    warm_idx[i] = at;
    if (runs > 0) {
      sp_found[i] = f_sp ? 1 : 0;
      sp_cell[i] = cell;
    }
  }
}

// Resident threads an SM of the instance for (`team`, `blocked`) on the
// current device (the occupancy API), 0 for a width it does not have.
template <int TEAM, bool BLOCKED>
static int tf_slots() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, tier_find_kernel<TEAM, BLOCKED>, TF_THREADS, 0) !=
      cudaSuccess)
    return 0;
  return blocks * TF_THREADS;
}

extern "C" int tier_find_slots(int team, int blocked) {
  if (blocked) {
    switch (team) {
      case 32: return tf_slots<32, true>();
      case 16: return tf_slots<16, true>();
      case 8: return tf_slots<8, true>();
      case 4: return tf_slots<4, true>();
      case 2: return tf_slots<2, true>();
      case 1: return tf_slots<1, true>();
      default: return 0;
    }
  }
  switch (team) {
    case 16: return tf_slots<16, false>();
    case 8: return tf_slots<8, false>();
    case 4: return tf_slots<4, false>();
    case 2: return tf_slots<2, false>();
    case 1: return tf_slots<1, false>();
    default: return 0;
  }
}

#define TF_ARGS                                                              \
  (const u64*)q, (const int*)slots, t, (const u64*)hot_keys, m, b,           \
      (const u64*)warm_keys, (const int*)lvl_child, (const int*)lvl_off,     \
      levels, width, (const u64*)term_keys, (const int8_t*)term_mark, cap,   \
      n_pad, (const u64*)sp_keys, (const int8_t*)sp_dead,                    \
      (const int*)run_off, runs, s, (int8_t*)hot_found, (int*)hot_col,       \
      (int8_t*)warm_found, (int*)warm_idx, (int8_t*)sp_found, (int*)sp_cell

// `team` is the lanes a query: 32 down to 1 in the block layout, 16 down to
// 1 in the level layout (kernel.py, `find_team`); `b` <= MAX_BUCKET.
extern "C" int tier_find_launch(
    const void* q, const void* slots, int t, const void* hot_keys, int m,
    int b, int blocked, const void* warm_keys, const void* lvl_child,
    const void* lvl_off, int levels, int width, const void* term_keys,
    const void* term_mark, int cap, int n_pad, const void* sp_keys,
    const void* sp_dead, const void* run_off, int runs, int s, void* hot_found,
    void* hot_col, void* warm_found, void* warm_idx, void* sp_found,
    void* sp_cell, int team, void* stream) {
  if (t == 0) return 0;
  if (b > MAX_BUCKET) return (int)cudaErrorInvalidValue;
  const int grid = (int)(((long long)t * team + TF_THREADS - 1) / TF_THREADS);
  cudaStream_t st = (cudaStream_t)stream;
#define TF_LAUNCH(T, B) \
  tier_find_kernel<T, B><<<grid, TF_THREADS, 0, st>>>(TF_ARGS)
  if (blocked) {
    switch (team) {
      case 32: TF_LAUNCH(32, true); break;
      case 16: TF_LAUNCH(16, true); break;
      case 8: TF_LAUNCH(8, true); break;
      case 4: TF_LAUNCH(4, true); break;
      case 2: TF_LAUNCH(2, true); break;
      case 1: TF_LAUNCH(1, true); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (team) {
      case 16: TF_LAUNCH(16, false); break;
      case 8: TF_LAUNCH(8, false); break;
      case 4: TF_LAUNCH(4, false); break;
      case 2: TF_LAUNCH(2, false); break;
      case 1: TF_LAUNCH(1, false); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef TF_LAUNCH
  return (int)cudaGetLastError();
}
