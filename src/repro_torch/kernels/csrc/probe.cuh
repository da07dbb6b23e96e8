// Shared device-side probe bodies of the store kernels (sm_90a).
//
// The reference Pallas kernels share their bodies the same way:
// `bucket_probe` (kernels/hash_probe), `level_walk` (kernels/skiplist_search),
// `block_walk` (kernels/bskiplist_walk) and `spill_run_probe`
// (kernels/tier_find) are each written once and reused by the fused tier
// kernels and the pq pop. The team bodies at the end (`team_bucket_row`,
// `team_spill_probe`, with `block_walk<32>`) serve one query with a team of
// lanes and give the same results. Keys arrive as int64 bit patterns and
// are compared here as unsigned 64-bit integers: the card has native u64
// compares, so the TPU's (hi, lo) u32 split does not exist on this side.
//
// Every body reproduces the reference conventions exactly:
//   * the first-true argmax of an all-false row is 0;
//   * the level walk clips indices as `level_walk` does on the padded
//     [L, C1] rectangle: a level index is clipped to [0, c1 - 1], and a read
//     past the level's own capacity sees the rectangle's padding (KEY_INF
//     key, child 0); terminal reads clip to [0, C - 1];
//   * the block walk clips a node id to [0, W/B - 1] on every index row and
//     the terminal block to [0, NB - 1], and reads the terminal planes with
//     the padded length NB*B: a cell at or past C is a KEY_INF key, mark 0;
//   * the hot column of a miss is 0;
//   * the spill cell of a miss is the clipped search position in run 0.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;

#define KEY_INF_U64 0xFFFFFFFFFFFFFFFFull
#define MAX_LEVELS 64
#define MAX_RUNS 64

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Fixed-hash bucket probe: first column of row `slot` (clipped to [0, m-1])
// holding `q`. Returns hit; *col = first hit column, 0 on a miss.
__device__ __forceinline__ bool bucket_probe(u64 q, int slot, const u64* keys,
                                             int m, int b, int* col) {
  const u64* row = keys + (long long)clampi(slot, 0, m - 1) * b;
  for (int j = 0; j < b; ++j) {
    if (row[j] == q) {
      *col = j;
      return true;
    }
  }
  *col = 0;
  return false;
}

// The first of a row's 4 candidates with q <= key, 0 when none is.
__device__ __forceinline__ int first_le(u64 q, const u64 (&key)[4]) {
  int sel = 0;
#pragma unroll
  for (int p = 3; p >= 1; --p)
    if (q <= key[p]) sel = p;
  return q <= key[0] ? 0 : sel;
}

// v[sel] by selects, so the candidates stay in registers (an indexed read
// of a register array would go through local memory).
template <typename T>
__device__ __forceinline__ T pick(const T (&v)[4], int sel) {
  T out = v[0];
#pragma unroll
  for (int p = 1; p < 4; ++p)
    if (sel == p) out = v[p];
  return out;
}

// Level-major descent with one memory round trip a level. Row r's four
// candidates (start + j, j < 4) are loaded together with their child
// entries, all at once; the first with q <= key is picked from registers
// and its child, already loaded, is the next row's start. The top row
// starts at 0; row 0's children point into the terminal planes, whose four
// candidate keys and marks make the last round. So a walk is L + 1 rounds
// of independent loads, against up to 5 dependent loads a level for a
// walk that reads the child start first and then the keys one by one.
//
// The result is the reference `level_walk`'s on the padded [L, C1]
// rectangle exactly: a candidate index clips to [0, c1 - 1] and one past
// its level's capacity reads KEY_INF and child 0; terminal candidates clip
// to [0, C - 1]; the first-true of an all-false row is 0. (The top row's
// capacity is >= 4 and c1 >= 4, so its unclipped probe is the same.) The
// speculative loads are the cells the reference reads on some path; the
// work's own reads (chip_smoke.py's bound) do not count them.
//
// One thread a query; `off` holds levels + 1 offsets (in shared memory).
// Returns found; *idx = terminal index.
__device__ __forceinline__ bool level_walk(u64 q, const u64* lvl_keys,
                                           const int* lvl_child, const int* off,
                                           int levels, int c1,
                                           const u64* term_keys,
                                           const int8_t* term_mark, int cap,
                                           int* idx) {
  int start = 0;
  int hi = off[levels];
  for (int r = levels - 1; r >= 0; --r) {
    const int lo = off[r];
    u64 key[4];
    int child[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int c = clampi(start + p, 0, c1 - 1);
      const bool in = c < hi - lo;
      key[p] = in ? lvl_keys[lo + c] : KEY_INF_U64;
      child[p] = in ? lvl_child[lo + c] : 0;
    }
    start = pick(child, first_le(q, key));
    hi = lo;
  }
  u64 key[4];
  int at[4], hit[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {          // keys and marks in one round
    at[p] = clampi(start + p, 0, cap - 1);
    key[p] = term_keys[at[p]];
    hit[p] = key[p] == q && term_mark[at[p]] == 0;
  }
  const int sel = first_le(q, key);
  *idx = pick(at, sel);
  return pick(hit, sel) != 0;
}

// Keys per B-skiplist node (core.layout.BSKIP_BLOCK).
#define BSKIP_B 128

// How many of the B entries node[start + j] (j < B) are below q; an entry
// at or past `cap` is padding (KEY_INF, never below q). TEAM = 1: one
// thread reads the whole node. TEAM = 32: the calling warp reads it, lane l
// taking entries l, l + 32, l + 64, l + 96 (each round one coalesced 256-byte
// read), and a ballot counts the compares; every lane gets the count. The
// count does not depend on the order of the entries.
template <int TEAM>
__device__ __forceinline__ int node_count_lt(const u64* node, int start,
                                             int cap, u64 q) {
  static_assert(TEAM == 1 || TEAM == 32, "a thread or a warp");
  const int lane = TEAM == 1 ? 0 : (threadIdx.x & 31);
  int n = 0;
  if constexpr (TEAM == 1) {
#pragma unroll 4
    for (int j = 0; j < BSKIP_B; ++j) {
      int c = start + j;
      n += c < cap && node[c] < q ? 1 : 0;
    }
  } else {
    // all of the lane's BSKIP_B / TEAM reads in one round
    bool lt[BSKIP_B / TEAM];
#pragma unroll
    for (int r = 0; r < BSKIP_B / TEAM; ++r) {
      int c = start + lane + r * TEAM;
      lt[r] = c < cap && node[c] < q;
    }
#pragma unroll
    for (int r = 0; r < BSKIP_B / TEAM; ++r)
      n += __popc(__ballot_sync(0xffffffffu, lt[r]));
  }
  return n;
}

// Block-major B-skiplist descent: one whole-node count per index row, from
// the root (node 0 of row levels - 1) down, the child being base + count;
// then the count in the terminal block, and the exact match with the
// tombstone. `blk` is the [levels, w] row stack; the terminal planes hold
// `cap` cells read with the padded length n_pad = NB * B. Returns found;
// *idx = terminal index (clipped to [0, n_pad - 1]). Under TEAM = 32 every
// lane of the warp must call it, and every lane gets the result.
template <int TEAM>
__device__ __forceinline__ bool block_walk(u64 q, const u64* blk, int levels,
                                           int w, const u64* term_keys,
                                           const int8_t* term_mark, int cap,
                                           int n_pad, int* idx) {
  int i = 0;
  for (int r = levels - 1; r >= 0; --r) {
    int base = clampi(i, 0, w / BSKIP_B - 1) * BSKIP_B;
    i = base + node_count_lt<TEAM>(blk + (long long)r * w, base, w, q);
  }
  int tb = clampi(i, 0, n_pad / BSKIP_B - 1) * BSKIP_B;
  i = clampi(tb + node_count_lt<TEAM>(term_keys, tb, cap, q), 0, n_pad - 1);
  *idx = i;
  if (i >= cap) return q == KEY_INF_U64;   // padding: KEY_INF key, mark 0
  return term_keys[i] == q && term_mark[i] == 0;
}

// The warm tier's walk in either layout: `blocked` selects the block-major
// rows (`keys` = the [levels, width] row stack, `child` and `off` unused) or
// the level-major levels (`keys` / `child` flat, `off` the level offsets,
// width = c1). One thread per query.
__device__ __forceinline__ bool warm_walk(u64 q, int blocked, const u64* keys,
                                          const int* child, const int* off,
                                          int levels, int width,
                                          const u64* term_keys,
                                          const int8_t* term_mark, int cap,
                                          int n_pad, int* idx) {
  if (blocked)
    return block_walk<1>(q, keys, levels, width, term_keys, term_mark, cap,
                         n_pad, idx);
  return level_walk(q, keys, child, off, levels, width, term_keys,
                    term_mark, cap, idx);
}

// Cold-tier probe: searchsorted-left of q in every sorted run
// [off[r], off[r + 1]) of the spill planes; the first live match wins.
// Returns found; *cell = matched cell, or the clipped position in run 0.
__device__ __forceinline__ bool spill_probe(u64 q, const u64* sp_keys,
                                            const int8_t* sp_dead,
                                            const int* run_off, int runs,
                                            int s, int* cell) {
  int miss_cell = 0;
  for (int r = 0; r < runs; ++r) {
    int lo = run_off[r];
    int end = run_off[r + 1];
    int hi = end;
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (sp_keys[mid] < q) lo = mid + 1; else hi = mid;
    }
    int pos = clampi(lo, 0, s - 1);
    if (r == 0) miss_cell = pos;
    if (lo < end && sp_keys[pos] == q && sp_dead[pos] == 0) {
      *cell = pos;
      return true;
    }
  }
  *cell = miss_cell;
  return false;
}

// Copy a small int32 table (level or run offsets) into shared memory.
__device__ __forceinline__ void load_table(int* dst, const int* src, int n) {
  for (int t = threadIdx.x; t < n; t += blockDim.x) dst[t] = src[t];
  __syncthreads();
}

// Exclusive prefix of v over the block (blockDim.x a multiple of 32, at most
// 1024); *total receives the block sum. Every thread of the block must call
// it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[32];
  int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
  int nw = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  int excl = x - v + (warp > 0 ? warp_sums[warp - 1] : 0);
  *total = warp_sums[nw - 1];
  __syncthreads();
  return excl;
}

// ---------------------------------------------------------------------------
// Team probe bodies: TEAM consecutive lanes of a warp (a power of two, 1 to
// 32) serve one query together, so a probe's independent reads go out in
// one round instead of one after another. Every lane of the team calls
// them, with the same query, and every lane gets the result. Each gives its
// one-thread counterpart's result exactly, at every TEAM.
//
// Their ballots and shuffles run over all the warp's live lanes (`warp`),
// never the team's alone: warp-synchronous calls whose masks differ from
// team to team run the warp's teams one after another (on the H100 a warp
// of 32 one-lane teams ran 4.3x slower so). So every live lane of the warp
// must reach each body, a team with nothing to probe passing `active`
// false.
// ---------------------------------------------------------------------------

#define MAX_BUCKET 16   // columns of a bucket row (the wrappers refuse more)

template <int TEAM>
struct Team {
  static_assert(TEAM >= 1 && TEAM <= 32 && (TEAM & (TEAM - 1)) == 0,
                "a power of two lanes of one warp");
  // columns of a bucket row a lane holds: c = lane + j * TEAM, j < COLS
  static constexpr int COLS = (MAX_BUCKET + TEAM - 1) / TEAM;
  static constexpr unsigned BITS = 0xffffffffu >> (32 - TEAM);
  int lane;        // 0 .. TEAM - 1
  int base;        // the team's first lane in its warp
  unsigned warp;   // the warp's live lanes (whole teams)
};

// Every lane of the warp must call it; `live`: the lane's team serves a
// query (the same for the whole team).
template <int TEAM>
__device__ __forceinline__ Team<TEAM> this_team(bool live) {
  Team<TEAM> t;
  t.lane = threadIdx.x & (TEAM - 1);
  t.base = threadIdx.x & 31 & ~(TEAM - 1);
  t.warp = __ballot_sync(0xffffffffu, live);
  return t;
}

// Bit j = p on team lane j.
template <int TEAM>
__device__ __forceinline__ unsigned team_ballot(const Team<TEAM>& t, bool p) {
  return (__ballot_sync(t.warp, p) >> t.base) & Team<TEAM>::BITS;
}

// The bucket row of `slot` (clipped to [0, m - 1]) in one round: each lane
// reads its columns (b <= MAX_BUCKET). Returns the columns holding q (bit
// j; `bucket_probe` hits iff it is non-zero, at its lowest bit); *empty =
// the KEY_INF cells.
template <int TEAM>
__device__ __forceinline__ unsigned team_bucket_row(u64 q, int slot,
                                                    const u64* keys, int m,
                                                    int b, const Team<TEAM>& t,
                                                    unsigned* empty) {
  const u64* row = keys + (long long)clampi(slot, 0, m - 1) * b;
  u64 kj[Team<TEAM>::COLS];
#pragma unroll
  for (int j = 0; j < Team<TEAM>::COLS; ++j) {
    const int c = t.lane + j * TEAM;
    kj[j] = c < b ? row[c] : 0;
  }
  unsigned hits = 0, emp = 0;
#pragma unroll
  for (int j = 0; j < Team<TEAM>::COLS; ++j) {
    const bool in = t.lane + j * TEAM < b;
    hits |= team_ballot(t, in && kj[j] == q) << (j * TEAM);
    emp |= team_ballot(t, in && kj[j] == KEY_INF_U64) << (j * TEAM);
  }
  *empty = emp;
  return hits;
}

// The runs of [runs + 1] offsets that hold cells, in run order, into
// shared memory (`live`, *n_live): an empty run never matches, so the team
// probe searches only these. Every thread of the block must call it.
__device__ __forceinline__ void load_runs(int* roff, int* live, int* n_live,
                                          const int* run_off, int runs) {
  load_table(roff, run_off, runs + 1);
  if (threadIdx.x == 0) {
    int n = 0;
    for (int r = 0; r < runs; ++r)
      if (roff[r] < roff[r + 1]) live[n++] = r;
    *n_live = n;
  }
  __syncthreads();
}

// Pivot u (< g) of a k-ary search round over [lo, lo + n), n > g: near
// lo + (u + 1) n / (g + 1), in float (a 64-bit division a pivot cost more
// than the round's loads). Any positions that do not decrease in u and
// stay inside the interval give the same search result: the narrowing
// reads the same positions back, and the pivots below q and those at or
// above it never share a position.
__device__ __forceinline__ int kary_pivot(int lo, int n, int u, float part) {
  return lo + min((int)((float)(u + 1) * ((float)n * part)), n - 1);
}

// Cold-tier probe by a team: `spill_probe`'s result exactly (the first live
// match in run order wins; a miss reports the clipped searchsorted-left
// position in run 0). The non-empty runs are split over the team: a group
// of g = TEAM / G lanes a run, G the power of two >= n_live (at most TEAM;
// more runs go in passes). A group runs a (g + 1)-ary search for its run's
// searchsorted-left position: each round its lanes read g spaced pivots of
// the open interval [lo, hi), and the count of pivots below q (a prefix of
// them, the run being sorted) narrows the interval to one of the g + 1
// parts; an interval of at most g cells is read whole. A 2^19-cell run
// takes 12 rounds at g = 2 (16 lanes, 5 to 8 runs), against 19 for a
// binary search (g = 1, which a team of 4 runs on 4 runs at once and a
// team of 1 on one run after another), and the runs are searched side by
// side. A team with `active` false finds nothing.
template <int TEAM>
__device__ __forceinline__ bool team_spill_probe(u64 q, bool active,
                                                 const u64* sp_keys,
                                                 const int8_t* sp_dead,
                                                 const int* run_off,
                                                 const int* live, int n_live,
                                                 int s, const Team<TEAM>& t,
                                                 int* cell) {
  int groups = 1;
  while (groups < n_live && groups < TEAM) groups <<= 1;
  const int g = TEAM / groups;
  const int grp = t.lane / g;
  const int sub = t.lane - grp * g;
  const unsigned gbits = 0xffffffffu >> (32 - g);
  const float part = 1.0f / (float)(g + 1);
  // an empty run 0 leaves its search at its start
  int miss = clampi(run_off[0], 0, s - 1);
  bool found = false;
  int at = 0;
  for (int r0 = 0; r0 < n_live; r0 += groups) {
    if (!__any_sync(t.warp, active && !found)) break;
    const bool act = active && !found && r0 + grp < n_live;
    const int r = act ? live[r0 + grp] : 0;
    int lo = act ? run_off[r] : 0;
    const int end = act ? run_off[r + 1] : 0;
    int hi = end;
    while (__any_sync(t.warp, lo < hi)) {
      const int n = hi - lo;
      const bool open = lo < hi;
      const bool whole = n <= g;
      const int p = whole ? lo + sub : kary_pivot(lo, n, sub, part);
      const bool lt = open && (!whole || sub < n) && sp_keys[p] < q;
      const int cnt = __popc((team_ballot(t, lt) >> (grp * g)) & gbits);
      if (open) {
        if (whole) {
          lo += cnt;
          hi = lo;
        } else {
          // the part after pivot cnt - 1 and before pivot cnt
          const int nlo = cnt > 0 ? kary_pivot(lo, n, cnt - 1, part) + 1 : lo;
          if (cnt < g) hi = kary_pivot(lo, n, cnt, part);
          lo = nlo;
        }
      }
    }
    const int pos = clampi(lo, 0, s - 1);
    if (r0 == 0) {
      const int pos0 = __shfl_sync(t.warp, pos, 0, TEAM);
      if (live[0] == 0) miss = pos0;   // run 0 holds cells
    }
    const bool hit = act && sub == 0 && lo < end && sp_keys[pos] == q &&
                     sp_dead[pos] == 0;
    const unsigned hits = team_ballot(t, hit);
    // the first group that hit: the earliest run of this pass
    const int hpos = __shfl_sync(t.warp, pos, hits ? __ffs(hits) - 1 : 0,
                                 TEAM);
    if (hits) {
      found = true;
      at = hpos;
    }
  }
  *cell = found ? at : miss;
  return found;
}
