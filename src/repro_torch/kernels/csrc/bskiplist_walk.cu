// Batched B-skiplist FIND for Hopper (sm_90a).
//
// Replaces the Pallas kernel `bskiplist_walk_tiles` / `block_walk` in
// src/repro/kernels/bskiplist_walk/kernel.py. The index is the block-major
// view of core/layout.py `bskiplist_layout`: [L, W] rows of 128-key nodes,
// the root at row L-1, and the state's own terminal planes read with the
// padded length NB*128. A walk is L + 1 node steps: per row the number of
// entries below q is the searchsorted-left position, and the child is
// base + count; then the match with the tombstone.
//
// Design: a team of TEAM lanes a query runs the shared `TeamBlockWalk`
// (probe.cuh), the body of tier_find's block layout. A warp (TEAM 32)
// counts each whole 1-KB node in one coalesced round with ballots, which is
// the reference's `sum(key_lt)`; a team of 2 (or 1) finds the same count
// as the node's searchsorted-left position by a ternary (binary) search of
// the sorted node, reading a few 32-byte sectors instead of 1 KB. The
// width comes from the wrapper (kernel.py, `walk_team`): the widest of
// 32, 2 and 1 whose teams are all resident (`bskiplist_walk_slots`), so a
// 4,096-lane plan keeps the warp's one round a node and a 65,536-lane one
// runs in one wave of teams of 2, where a warp a query made 7.75. There
// are no instances of 16, 8 and 4 lanes: at 65,536 lanes, a card filled
// by teams of 4 searching 5-ary (4 rounds, ~12 loads a node) ran slower
// than half of it filled by teams of 2 (5 rounds, ~9 loads), the walk
// there being bound by the sectors it reads more than by its rounds
// (PERF.md).
//
// Bound: memory latency, and at the preload width the sectors read: at
// C = 2^24 a walk is 4 dependent node steps (3 index rows + the terminal
// block); the upper rows are shared by every query and stay in L2, the
// terminal block is a distinct node per query (1 KB counted, ~9 cells in
// as many sectors searched by a team of 2).
#include "probe.cuh"

#define BW_THREADS 256

template <int TEAM>
__global__ void __launch_bounds__(BW_THREADS, 8) bskiplist_walk_kernel(
    const u64* __restrict__ q, int t, const u64* __restrict__ blk, int levels,
    int w, const u64* __restrict__ term_keys,
    const int8_t* __restrict__ term_mark, int cap, int n_pad,
    int8_t* __restrict__ found, int* __restrict__ idx) {
  const long long qi =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / TEAM;
  const Team<TEAM> tm = this_team<TEAM>(qi < t);
  if (qi >= t) return;                 // whole teams leave together
  TeamBlockWalk<TEAM> walk(q[qi], blk, levels, w, term_keys, term_mark, cap,
                           n_pad, tm, true);
  run_side(walk, tm);
  if (tm.lane == 0) {
    found[qi] = walk.found ? 1 : 0;
    idx[qi] = walk.idx;
  }
}

// Resident threads an SM of the instance for `team` on the current device
// (the occupancy API), 0 for a width it does not have.
template <int TEAM>
static int bw_slots() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, bskiplist_walk_kernel<TEAM>, BW_THREADS, 0) != cudaSuccess)
    return 0;
  return blocks * BW_THREADS;
}

extern "C" int bskiplist_walk_slots(int team) {
  switch (team) {
    case 32: return bw_slots<32>();
    case 2: return bw_slots<2>();
    case 1: return bw_slots<1>();
    default: return 0;
  }
}

// `team` is the lanes a query: 32, 2 or 1 (kernel.py, `walk_team`).
extern "C" int bskiplist_walk_launch(const void* q, int t, const void* blk,
                                     int levels, int w, const void* term_keys,
                                     const void* term_mark, int cap, int n_pad,
                                     void* found, void* idx, int team,
                                     void* stream) {
  if (t == 0) return 0;
  const int grid = (int)(((long long)t * team + BW_THREADS - 1) / BW_THREADS);
  cudaStream_t st = (cudaStream_t)stream;
#define BW_LAUNCH(T)                                                       \
  bskiplist_walk_kernel<T><<<grid, BW_THREADS, 0, st>>>(                   \
      (const u64*)q, t, (const u64*)blk, levels, w, (const u64*)term_keys, \
      (const int8_t*)term_mark, cap, n_pad, (int8_t*)found, (int*)idx)
  switch (team) {
    case 32: BW_LAUNCH(32); break;
    case 2: BW_LAUNCH(2); break;
    case 1: BW_LAUNCH(1); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef BW_LAUNCH
  return (int)cudaGetLastError();
}
