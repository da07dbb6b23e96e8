// Shared device-side probe bodies of the store kernels (sm_90a).
//
// The reference Pallas kernels share their bodies the same way:
// `bucket_probe` (kernels/hash_probe, here `team_bucket_row`), `level_walk`
// (kernels/skiplist_search), `block_walk` (kernels/bskiplist_walk, here
// `TeamBlockWalk`) and `spill_run_probe` (kernels/tier_find, here
// `team_spill_probe`) are each written once and reused by the fused tier
// kernels and the pq pop. The team bodies at the end (`team_bucket_row`,
// `team_kary_search`, `team_spill_probe`, `TeamBlockWalk`) serve one query
// with a team of lanes and give the same results as one thread; the walks
// are steppers (`LevelWalk`, `TeamBlockWalk`), so a kernel can run a walk's
// rounds inside a search's. Keys arrive as int64 bit patterns and
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

#include <type_traits>

typedef unsigned long long u64;

#define KEY_INF_U64 0xFFFFFFFFFFFFFFFFull
#define MAX_LEVELS 64
#define MAX_RUNS 64

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
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
// A round is written once, as the loads and the picks below, and run by
// two walks: `level_walk`, its rounds back to back, and `LevelWalk`, the
// same rounds as a stepper.

// Level row [lo, hi)'s four candidates from `start` and their children.
__device__ __forceinline__ void level_row(const u64* keys, const int* child,
                                          int lo, int hi, int c1, int start,
                                          u64 (&key)[4], int (&val)[4]) {
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int c = clampi(start + p, 0, c1 - 1);
    const bool in = c < hi - lo;
    key[p] = in ? keys[lo + c] : KEY_INF_U64;
    val[p] = in ? child[lo + c] : 0;
  }
}

// The terminal round's four candidates from `start`: their cells, keys and
// whether each is a live match of q.
__device__ __forceinline__ void term_row(u64 q, const u64* term_keys,
                                         const int8_t* term_mark, int cap,
                                         int start, u64 (&key)[4],
                                         int (&hit)[4], int (&at)[4]) {
#pragma unroll
  for (int p = 0; p < 4; ++p) {          // keys and marks in one round
    at[p] = clampi(start + p, 0, cap - 1);
    key[p] = term_keys[at[p]];
    hit[p] = key[p] == q && term_mark[at[p]] == 0;
  }
}

// The terminal pick: found = a live match; *idx = the picked cell.
__device__ __forceinline__ bool term_pick(u64 q, const u64 (&key)[4],
                                          const int (&hit)[4],
                                          const int (&at)[4], int* idx) {
  const int sel = first_le(q, key);
  *idx = pick(at, sel);
  return pick(hit, sel) != 0;
}

// The whole walk, its rounds back to back: the body of the kernels that
// walk alone (skiplist_search, pq_pop's select, tier_apply's level
// membership), a loop that compiles leaner there than the stepper (pq_pop's
// select ran 20% slower on the stepper, PERF.md). Returns found; *idx =
// terminal index.
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
    level_row(lvl_keys, lvl_child, lo, hi, c1, start, key, child);
    start = pick(child, first_le(q, key));
    hi = lo;
  }
  u64 key[4];
  int at[4], hit[4];
  term_row(q, term_keys, term_mark, cap, start, key, hit, at);
  return term_pick(q, key, hit, at, idx);
}

// The walk as a stepper, so that a caller can run its rounds beside other
// independent work (tier_find runs them inside the spill search's rounds):
// `issue` loads a round's candidates, `take` picks from them, and a caller
// puts its own loads between the two. One thread walks; `off` holds
// levels + 1 offsets (in shared memory).
struct LevelWalk {
  u64 q;
  const u64* keys;
  const int* child;
  const int* off;
  int c1;
  const u64* term_keys;
  const int8_t* term_mark;
  int cap;
  int r;            // the next row, levels - 1 down to 0; -1: the terminal
                    // round; -2: done
  int start, hi;
  u64 key[4];
  int val[4];       // a row's children, or the terminal live matches
  int at[4];        // the terminal candidates' cells
  bool found;       // the result: a live match, at terminal index `idx`
  int idx;

  __device__ __forceinline__ LevelWalk(u64 q_, const u64* keys_,
                                       const int* child_, const int* off_,
                                       int levels, int c1_,
                                       const u64* term_keys_,
                                       const int8_t* term_mark_, int cap_,
                                       bool active)
      : q(q_), keys(keys_), child(child_), off(off_), c1(c1_),
        term_keys(term_keys_), term_mark(term_mark_), cap(cap_),
        r(active ? levels - 1 : -2), start(0), hi(off_[levels]),
        found(false), idx(0) {}

  __device__ __forceinline__ bool pending() const { return r >= -1; }

  __device__ __forceinline__ void issue() {
    if (r >= 0)
      level_row(keys, child, off[r], hi, c1, start, key, val);
    else if (r == -1)
      term_row(q, term_keys, term_mark, cap, start, key, val, at);
  }

  __device__ __forceinline__ void take() {
    if (r < -1) return;
    if (r >= 0) {
      start = pick(val, first_le(q, key));
      hi = off[r];
    } else {
      found = term_pick(q, key, val, at, &idx);
    }
    --r;
  }
};

// Keys per B-skiplist node (core.layout.BSKIP_BLOCK).
#define BSKIP_B 128

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

// Bit j = p on team lane j (a team of one lane needs no ballot).
template <int TEAM>
__device__ __forceinline__ unsigned team_ballot(const Team<TEAM>& t, bool p) {
  if constexpr (TEAM == 1) return p ? 1u : 0u;
  return (__ballot_sync(t.warp, p) >> t.base) & Team<TEAM>::BITS;
}

// The bucket row of `slot` (clipped to [0, m - 1]) in one round: each lane
// reads its columns (b <= MAX_BUCKET), all of them at once. Returns the
// columns holding q (bit j; the reference `bucket_probe` hits iff it is
// non-zero, at its lowest bit); *empty = the KEY_INF cells, unless `empty`
// is null (the hash_probe kernel), when those ballots are not made.
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
    if (empty != nullptr)
      emp |= team_ballot(t, in && kj[j] == KEY_INF_U64) << (j * TEAM);
  }
  if (empty != nullptr) *empty = emp;
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

// A team split into groups of g = TEAM / groups lanes, one search a group:
// this lane is lane `sub` of group `grp`; `bits` masks a group's ballot
// bits, `part` = 1 / (g + 1).
struct KaryGroup {
  int g, grp, sub;
  unsigned bits;
  float part;
};

template <int TEAM>
__device__ __forceinline__ KaryGroup kary_group(const Team<TEAM>& t,
                                                int groups) {
  KaryGroup k;
  k.g = TEAM / groups;
  k.grp = t.lane / k.g;
  k.sub = t.lane - k.grp * k.g;
  k.bits = 0xffffffffu >> (32 - k.g);
  k.part = 1.0f / (float)(k.g + 1);
  return k;
}

// A stepper with nothing to do, for a caller with no work beside the spill
// search.
struct NoSide {
  __device__ __forceinline__ bool pending() const { return false; }
  __device__ __forceinline__ void issue() {}
  __device__ __forceinline__ void take() {}
};

// Run a stepper's remaining rounds; every live lane of the warp calls it.
template <int TEAM, class Side>
__device__ __forceinline__ void run_side(Side& side, const Team<TEAM>& t) {
  while (__any_sync(t.warp, side.pending())) {
    side.issue();
    side.take();
  }
}

// A group's (g + 1)-ary search of the sorted cells keys[lo, hi) for q's
// searchsorted-left position: it narrows [lo, hi) (the same on every lane
// of the group) until it holds at most `stop` cells, every cell before lo
// being below q and every cell from hi on not; with stop = 0, lo is the
// position. Each round the group's lanes read g spaced pivots of the open
// interval, and the count of pivots below q (a prefix of them, the cells
// being sorted) narrows it to one of the g + 1 parts; an interval of at
// most g cells is read whole. With ONE_GROUP (g = TEAM, the split-order
// row's search) the pivots are integers over a constant divisor,
// lo + (u + 1) n / (TEAM + 1), so a round costs a few integer
// instructions and a team of one runs a plain binary search; with several
// groups (the spill runs) g is known only at run time and the pivots are
// `kary_pivot`'s. `side` is a stepper whose rounds run inside the
// search's (`NoSide` for none): each round issues its loads beside the
// pivots' and takes its result after them. Every live lane of the warp
// calls it, and the loop runs until every group of the warp is done (a
// team of one with no stepper has nothing to sync and loops alone).
template <int TEAM, bool ONE_GROUP, class Side>
__device__ __forceinline__ void team_kary_search(u64 q, const u64* keys,
                                                 int& lo, int& hi, int stop,
                                                 const KaryGroup& k,
                                                 const Team<TEAM>& t,
                                                 Side& side) {
  auto pivot = [&](int n, int u) {
    if constexpr (ONE_GROUP)   // (u + 1) n < 2^32 (n < 2^27, the launcher)
      return lo + (int)((unsigned)(u + 1) * (unsigned)n / (TEAM + 1u));
    else
      return kary_pivot(lo, n, u, k.part);
  };
  // a lone lane with nothing beside its search loops on its own: a vote a
  // round cost a one-lane split-order search 4.6% at 65,536 lanes (PERF.md)
  auto more = [&] {
    if constexpr (TEAM == 1 && std::is_same<Side, NoSide>::value)
      return hi - lo > stop;
    else
      return __any_sync(t.warp, hi - lo > stop) != 0;
  };
  while (more()) {
    side.issue();
    const int n = hi - lo;
    const bool open = n > stop;
    const bool whole = n <= k.g;
    const int p = whole ? lo + k.sub : pivot(n, k.sub);
    const bool rd = open && (!whole || k.sub < n);
    const u64 pk = rd ? keys[p] : 0;
    side.take();
    const bool lt = rd && pk < q;
    const int cnt = __popc((team_ballot(t, lt) >> (k.grp * k.g)) & k.bits);
    if (open) {
      if (whole) {
        lo += cnt;
        hi = lo;
      } else {
        // the part after pivot cnt - 1 and before pivot cnt
        const int nlo = cnt > 0 ? pivot(n, cnt - 1) + 1 : lo;
        if (cnt < k.g) hi = pivot(n, cnt);
        lo = nlo;
      }
    }
  }
}

// Cold-tier probe by a team: the plain version's result exactly (the first
// live match in run order wins; a miss reports the clipped searchsorted-left
// position in run 0). The non-empty runs are split over the team: a group
// of g = TEAM / G lanes a run, G the power of two >= n_live (at most TEAM;
// more runs go in passes). A group runs a (g + 1)-ary search for its run's
// searchsorted-left position (`team_kary_search`). A 2^19-cell run
// takes 12 rounds at g = 2 (16 lanes, 5 to 8 runs), against 19 for a
// binary search (g = 1, which a team of 4 runs on 4 runs at once and a
// team of 1 on one run after another), and the runs are searched side by
// side. A team with `active` false finds nothing.
//
// `side` is a stepper (`LevelWalk`, `TeamBlockWalk`, or `NoSide`) whose
// rounds run inside the search's: each round issues the side's loads
// beside the pivots' and takes its result after them, so a walk and the
// spill search independent of it cost the longer of the two chains, not
// their sum. What is left of the side after the last round runs alone
// (`run_side`).
template <int TEAM, class Side>
__device__ __forceinline__ bool team_spill_probe(u64 q, bool active,
                                                 const u64* sp_keys,
                                                 const int8_t* sp_dead,
                                                 const int* run_off,
                                                 const int* live, int n_live,
                                                 int s, const Team<TEAM>& t,
                                                 int* cell, Side& side) {
  int groups = 1;
  while (groups < n_live && groups < TEAM) groups <<= 1;
  const KaryGroup kg = kary_group(t, groups);
  const int grp = kg.grp;
  // an empty run 0 leaves its search at its start
  int miss = clampi(run_off[0], 0, s - 1);
  bool found = false;
  int at = 0;
  for (int r0 = 0; r0 < n_live; r0 += groups) {
    if (!__any_sync(t.warp, active && !found)) break;
    const bool act = active && !found && r0 + grp < n_live;
    const int r = act ? live[r0 + grp] : 0;
    const int end = act ? run_off[r + 1] : 0;
    int lo = act ? run_off[r] : 0, hi = end;
    team_kary_search<TEAM, false>(q, sp_keys, lo, hi, 0, kg, t, side);
    const int pos = clampi(lo, 0, s - 1);
    if (r0 == 0) {
      const int pos0 = __shfl_sync(t.warp, pos, 0, TEAM);
      if (live[0] == 0) miss = pos0;   // run 0 holds cells
    }
    const bool hit = act && kg.sub == 0 && lo < end && sp_keys[pos] == q &&
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
  run_side(side, t);
  *cell = found ? at : miss;
  return found;
}

// Block-major B-skiplist descent by a team, as a stepper: one node of each
// index row from the root (node 0 of row levels - 1) down, the child being
// base + the node's count of entries below q, then the terminal block, then
// the exact match with the tombstone. `blk` is the [levels, w] row stack;
// the terminal planes hold `cap` cells read with the padded length
// n_pad = NB * B: a cell at or past its row's end (w, or cap) is padding, a
// KEY_INF key never below q and mark 0, and is not read. The result is the
// plain version's (its whole-node counts) exactly.
//
// The node step follows from TEAM. A warp counts each whole node in one
// round: lane l reads entries l + j * 32 (j < PER = 4, coalesced) and
// ballots sum the compares; the count does not depend on the entries'
// order. A narrower team (PER = 1) searches the node: every node row is
// sorted with its KEY_INF padding at the end (the terminal keys are,
// tombstones keeping their keys in place, and each index row takes every
// B-th entry of the row below; core.layout), so the count is the node's
// searchsorted-left position, which the team finds by the (TEAM + 1)-ary
// search of `team_spill_probe`: each round its lanes read TEAM spaced
// pivots of the open interval of positions and the count of pivots below q
// narrows it; an interval of at most TEAM cells is read whole. A 128-key
// node takes 2 rounds at TEAM 16, 3 at 8, 4 at 4, 5 at 2 and 8 at 1, and
// reads a few 32-byte sectors where the count reads 1 KB. Then one round
// reads the matched cell's key and tombstone. Every lane of the team walks
// and gets the result; `take` syncs over the warp's live lanes, so every
// one of them must call it.
template <int TEAM>
struct TeamBlockWalk {
  // cells a lane reads a round: a warp's whole-node count, else a pivot
  static constexpr int PER = TEAM == 32 ? BSKIP_B / TEAM : 1;
  u64 q;
  const u64* blk;
  int w;
  const u64* term_keys;
  const int8_t* term_mark;
  int cap, n_pad;
  Team<TEAM> t;
  float part;
  int r;            // the row, levels - 1 down to 0; -1: the terminal
                    // block; -2: the match round; -3: done
  int base;         // the node's first cell in its row
  int lo, hi;       // the open interval of positions in the node
  u64 k[PER];       // the cells this lane read this round
  int mark;
  bool found;       // the result: a live match, at terminal index `idx`
  int idx;

  __device__ __forceinline__ TeamBlockWalk(u64 q_, const u64* blk_,
                                           int levels, int w_,
                                           const u64* term_keys_,
                                           const int8_t* term_mark_, int cap_,
                                           int n_pad_, const Team<TEAM>& t_,
                                           bool active)
      : q(q_), blk(blk_), w(w_), term_keys(term_keys_),
        term_mark(term_mark_), cap(cap_), n_pad(n_pad_), t(t_),
        part(1.0f / (float)(TEAM + 1)), r(active ? levels - 1 : -3), base(0),
        lo(0), hi(BSKIP_B), mark(0), found(false), idx(0) {}

  __device__ __forceinline__ bool pending() const { return r >= -2; }

  __device__ __forceinline__ void issue() {
#pragma unroll
    for (int j = 0; j < PER; ++j) k[j] = KEY_INF_U64;
    if (r >= -1) {
      const u64* row = r >= 0 ? blk + (long long)r * w : term_keys;
      const int end = r >= 0 ? w : cap;
      if constexpr (PER > 1) {
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const int c = base + t.lane + j * TEAM;
          if (c < end) k[j] = row[c];
        }
      } else {
        const int n = hi - lo;
        const bool whole = n <= TEAM;
        const int c = base + (whole ? lo + t.lane
                                    : kary_pivot(lo, n, t.lane, part));
        if ((!whole || t.lane < n) && c < end) k[0] = row[c];
      }
    } else if (r == -2 && idx < cap) {
      k[0] = term_keys[idx];
      mark = term_mark[idx];
    }
  }

  __device__ __forceinline__ void take() {
    const bool search = r >= -1;
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < PER; ++j)
      cnt += __popc(team_ballot(t, search && k[j] < q));
    if (search) {
      const int n = hi - lo;
      if (PER > 1 || n <= TEAM) {
        lo += cnt;
        hi = lo;
      } else {
        const int nlo = cnt > 0 ? kary_pivot(lo, n, cnt - 1, part) + 1 : lo;
        if (cnt < TEAM) hi = kary_pivot(lo, n, cnt, part);
        lo = nlo;
      }
      if (lo >= hi) {                  // the node's count: the next node
        const int i = base + lo;
        if (r > 0)
          base = clampi(i, 0, w / BSKIP_B - 1) * BSKIP_B;
        else if (r == 0)
          base = clampi(i, 0, n_pad / BSKIP_B - 1) * BSKIP_B;
        else
          idx = clampi(i, 0, n_pad - 1);
        lo = 0;
        hi = BSKIP_B;
        --r;
      }
    } else if (r == -2) {
      found = idx < cap ? k[0] == q && mark == 0 : q == KEY_INF_U64;
      --r;
    }
  }
};
