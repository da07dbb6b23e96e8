// Batched priority-queue pop (rank-select + descent) for Hopper (sm_90a).
//
// Replaces the Pallas kernel `pq_pop_tiles` / `rank_select` in
// src/repro/kernels/pq_pop/kernel.py. Pop-min is rank selection over the live
// terminal prefix (live = unmarked and not KEY_INF): rank r selects the first
// cell whose inclusive live prefix reaches r + 1, a rank past the live total
// selects nothing (KEY_INF), and the selected key goes through the shared
// `level_walk` (probe.cuh), so key -> terminal index has one implementation
// across FIND and POP. The TPU kernel compares every rank with every prefix
// entry ([T, C]); that matrix is never built here.
//
// Three launches:
//   1. `pq_count_kernel`: one warp per chunk of PQ_CHUNK cells counts the live
//      cells (ballot + popc over coalesced rounds of 32 cells).
//   2. `pq_scan_kernel`: ONE block of 1024 threads turns the chunk counts
//      into their inclusive prefix in place (each thread a contiguous run
//      of counts); the last entry is the live total.
//   3. `pq_select_kernel`: one warp per rank binary-searches the chunk prefix
//      for the first chunk that reaches r + 1, walks that chunk 32 cells a
//      round to the (r + 1 - before)-th live cell, and lane 0 runs
//      `level_walk` on its key.
//
// Bound: bytes. Launch 1 reads the whole terminal key and mark planes
// (9 bytes a cell, 151 MB at C = 2^24) whatever the ranks need; the work
// the ranks need is the prefix up to the furthest selected cell. Reading
// only that prefix (an ordered scan that stops early) is the next step; the
// chunk count keeps the cost independent of the tombstone run that pops
// leave at the head, which a cell-by-cell search from the front would not.
#include "probe.cuh"

#define PQ_CHUNK 512

__device__ __forceinline__ bool live_cell(const u64* term_keys,
                                          const int8_t* term_mark, int cap,
                                          int c) {
  return c < cap && term_mark[c] == 0 && term_keys[c] != KEY_INF_U64;
}

__global__ void pq_count_kernel(const u64* __restrict__ term_keys,
                                const int8_t* __restrict__ term_mark, int cap,
                                int nchunks, int* __restrict__ counts) {
  int chunk = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (chunk >= nchunks) return;        // the whole warp leaves together
  int base = chunk * PQ_CHUNK;
  int n = 0;
#pragma unroll 4
  for (int j = lane; j < PQ_CHUNK; j += 32)
    n += __popc(__ballot_sync(0xffffffffu,
                              live_cell(term_keys, term_mark, cap, base + j)));
  if (lane == 0) counts[chunk] = n;
}

__global__ void pq_scan_kernel(int nchunks, int* __restrict__ prefix) {
  int per = (nchunks + blockDim.x - 1) / blockDim.x;
  int lo = threadIdx.x * per;
  int hi = min(lo + per, nchunks);
  int local = 0, total;
  for (int i = lo; i < hi; ++i) local += prefix[i];
  int run = block_exclusive_scan(local, &total);
  for (int i = lo; i < hi; ++i) {
    run += prefix[i];
    prefix[i] = run;
  }
}

__global__ void pq_select_kernel(
    const int* __restrict__ ranks, const int8_t* __restrict__ mask, int t,
    const int* __restrict__ prefix, int nchunks,
    const u64* __restrict__ lvl_keys, const int* __restrict__ lvl_child,
    const int* __restrict__ lvl_off, int levels, int c1,
    const u64* __restrict__ term_keys, const int8_t* __restrict__ term_mark,
    int cap, int8_t* __restrict__ found, int* __restrict__ idx) {
  __shared__ int off[MAX_LEVELS + 1];
  load_table(off, lvl_off, levels + 1);
  int qi = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (qi >= t) return;                 // the whole warp leaves together
  int want = (int)((unsigned)ranks[qi] + 1u);
  int total = nchunks > 0 ? prefix[nchunks - 1] : 0;
  bool sel = mask[qi] != 0 && want >= 1 && want <= total;   // warp-uniform
  u64 key = KEY_INF_U64;
  if (sel) {
    int lo = 0, hi = nchunks;          // first chunk with prefix >= want
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (prefix[mid] < want) lo = mid + 1; else hi = mid;
    }
    int need = want - (lo > 0 ? prefix[lo - 1] : 0);
    int base = lo * PQ_CHUNK;
    for (int j = 0; j < PQ_CHUNK; j += 32) {
      bool live = live_cell(term_keys, term_mark, cap, base + j + lane);
      unsigned bits = __ballot_sync(0xffffffffu, live);
      int n = __popc(bits);
      if (need <= n) {
        int before = __popc(bits & ((1u << lane) - 1u));
        unsigned win = __ballot_sync(0xffffffffu, live && before == need - 1);
        key = term_keys[base + j + __ffs(win) - 1];
        break;
      }
      need -= n;
    }
  }
  if (lane != 0) return;
  int at = 0;
  bool f = sel && level_walk(key, lvl_keys, lvl_child, off, levels, c1,
                             term_keys, term_mark, cap, &at);
  found[qi] = f ? 1 : 0;
  idx[qi] = f ? at : 0;
}

// `prefix` is [ceil(cap / PQ_CHUNK)] int32 scratch.
extern "C" int pq_pop_launch(const void* ranks, const void* mask, int t,
                             const void* lvl_keys, const void* lvl_child,
                             const void* lvl_off, int levels, int c1,
                             const void* term_keys, const void* term_mark,
                             int cap, void* prefix, void* found, void* idx,
                             int stage, void* stream) {
  const int threads = 256;             // 8 warps per block
  const int warps = threads / 32;
  int nchunks = (cap + PQ_CHUNK - 1) / PQ_CHUNK;
  cudaStream_t s = (cudaStream_t)stream;
  if (stage == 0) {
    if (nchunks > 0)
      pq_count_kernel<<<(nchunks + warps - 1) / warps, threads, 0, s>>>(
          (const u64*)term_keys, (const int8_t*)term_mark, cap, nchunks,
          (int*)prefix);
  } else if (stage == 1) {
    if (nchunks > 0) pq_scan_kernel<<<1, 1024, 0, s>>>(nchunks, (int*)prefix);
  } else if (t > 0) {
    pq_select_kernel<<<(t + warps - 1) / warps, threads, 0, s>>>(
        (const int*)ranks, (const int8_t*)mask, t, (const int*)prefix,
        nchunks, (const u64*)lvl_keys, (const int*)lvl_child,
        (const int*)lvl_off, levels, c1, (const u64*)term_keys,
        (const int8_t*)term_mark, cap, (int8_t*)found, (int*)idx);
  }
  return (int)cudaGetLastError();
}
