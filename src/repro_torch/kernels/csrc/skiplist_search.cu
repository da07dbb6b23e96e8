// Batched deterministic-skiplist FIND for Hopper (sm_90a).
//
// Replaces the Pallas kernel `skiplist_search_tiles` / `level_walk` in
// src/repro/kernels/skiplist_search/kernel.py. Each query walks the
// level-major index straight from HBM with the shared `level_walk`
// (probe.cuh): L + 1 rounds, each loading a row's four candidate keys and
// their four child entries at once, so a round is one memory round trip.
//
// Bound: memory latency, not bandwidth. The bytes a launch must move are a
// few hundred per query (the 32-byte sectors of its walk); the time goes to
// the L + 1 dependent rounds (L ~ 22 at C = 2^24). The design answers with
// independent loads inside a round and with the queries spread over the
// whole card: one thread a query, in blocks of `threads`, which the wrapper
// chooses (`walk_geometry`) so that a 4,096-query plan still covers every
// SM. The TPU kernel's padded [L, C1] rectangle is not built: levels
// arrive as the state's one flat key buffer and one child buffer with an
// offset table (copied to shared memory), and reads past a level's
// capacity see the rectangle's padding (probe.cuh).
#include "probe.cuh"

__global__ void skiplist_search_kernel(const u64* __restrict__ q, int t,
                                       const u64* __restrict__ lvl_keys,
                                       const int* __restrict__ lvl_child,
                                       const int* __restrict__ lvl_off,
                                       int levels, int c1,
                                       const u64* __restrict__ term_keys,
                                       const int8_t* __restrict__ term_mark,
                                       int cap, int8_t* __restrict__ found,
                                       int* __restrict__ idx) {
  __shared__ int off[MAX_LEVELS + 1];
  load_table(off, lvl_off, levels + 1);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= t) return;
  int at;
  bool f = level_walk(q[i], lvl_keys, lvl_child, off, levels, c1, term_keys,
                      term_mark, cap, &at);
  found[i] = f ? 1 : 0;
  idx[i] = at;
}

// threads: a multiple of 32, at most 1024.
extern "C" int skiplist_search_launch(const void* q, int t,
                                      const void* lvl_keys,
                                      const void* lvl_child,
                                      const void* lvl_off, int levels, int c1,
                                      const void* term_keys,
                                      const void* term_mark, int cap,
                                      void* found, void* idx, int threads,
                                      void* stream) {
  if (t == 0) return 0;
  if (threads <= 0 || threads % 32 != 0 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  const int blocks = (t + threads - 1) / threads;
  skiplist_search_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const u64*)q, t, (const u64*)lvl_keys, (const int*)lvl_child,
      (const int*)lvl_off, levels, c1, (const u64*)term_keys,
      (const int8_t*)term_mark, cap, (int8_t*)found, (int*)idx);
  return (int)cudaGetLastError();
}
