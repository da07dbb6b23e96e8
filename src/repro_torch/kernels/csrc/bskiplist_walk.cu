// Batched B-skiplist FIND for Hopper (sm_90a).
//
// Replaces the Pallas kernel `bskiplist_walk_tiles` / `block_walk` in
// src/repro/kernels/bskiplist_walk/kernel.py. The index is the block-major
// view of core/layout.py `bskiplist_layout`: [L, W] rows of 128-key nodes,
// the root at row L-1, and the state's own terminal planes read with the
// padded length NB*128. A walk is L + 1 whole-node counts: per row the number
// of entries below q is the searchsorted-left position, and the child is
// base + count.
//
// Design: one warp per query. A 128-key node is 1 KB; the warp reads it in
// four coalesced 256-byte rounds (lane l takes entries l, l + 32, l + 64,
// l + 96) and counts the compares with a ballot, which is the reference's
// `sum(key_lt)` whatever the order of the row. The body is `block_walk<32>`
// in probe.cuh; the fused tier kernels run the same body one thread per
// query (`block_walk<1>`).
//
// Bound: memory latency. At C = 2^24 a walk is 4 dependent 1-KB node reads
// (3 index rows + the terminal block); the upper rows are shared by every
// query and stay in L2, the terminal block is a distinct 1 KB per query. A
// warp per query keeps 32 loads of each node in flight at once, where one
// thread per query would issue 128 of them one after another.
#include "probe.cuh"

__global__ void bskiplist_walk_kernel(const u64* __restrict__ q, int t,
                                      const u64* __restrict__ blk, int levels,
                                      int w, const u64* __restrict__ term_keys,
                                      const int8_t* __restrict__ term_mark,
                                      int cap, int n_pad,
                                      int8_t* __restrict__ found,
                                      int* __restrict__ idx) {
  int qi = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (qi >= t) return;                 // the whole warp leaves together
  int at;
  bool f = block_walk<32>(q[qi], blk, levels, w, term_keys, term_mark, cap,
                          n_pad, &at);
  if ((threadIdx.x & 31) == 0) {
    found[qi] = f ? 1 : 0;
    idx[qi] = at;
  }
}

extern "C" int bskiplist_walk_launch(const void* q, int t, const void* blk,
                                     int levels, int w, const void* term_keys,
                                     const void* term_mark, int cap, int n_pad,
                                     void* found, void* idx, void* stream) {
  if (t == 0) return 0;
  const int threads = 256;             // 8 queries per block
  const int per_block = threads / 32;
  bskiplist_walk_kernel<<<(t + per_block - 1) / per_block, threads, 0,
                          (cudaStream_t)stream>>>(
      (const u64*)q, t, (const u64*)blk, levels, w, (const u64*)term_keys,
      (const int8_t*)term_mark, cap, n_pad, (int8_t*)found, (int*)idx);
  return (int)cudaGetLastError();
}
