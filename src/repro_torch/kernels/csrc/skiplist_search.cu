// Batched deterministic-skiplist FIND for Hopper (sm_90a).
//
// Replaces the Pallas kernel `skiplist_search_tiles` / `level_walk` in
// src/repro/kernels/skiplist_search/kernel.py. One thread per query walks the
// level-major index straight from HBM: a top fan-out-4 probe, then exactly L
// steps, each reading one child start and up to 4 keys of the level below.
//
// Bound: memory latency, not bandwidth. A walk is L + 1 dependent gathers of
// 8-byte keys at random addresses (L ~ 22 at C = 2^24); the bytes a launch
// must move are a few hundred per query, so the card's time goes to waiting on
// dependent loads. The design answer for now is plain occupancy: 256-thread
// blocks, no shared-memory staging beyond the [L + 1] level-offset table, so
// many walks are in flight per SM. The TPU kernel's padded [L, C1] rectangle is
// not built: levels arrive as the state's one flat key buffer and one child
// buffer with an offset table, and reads past a level's capacity see the
// rectangle's padding (probe.cuh).
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

extern "C" int skiplist_search_launch(const void* q, int t,
                                      const void* lvl_keys,
                                      const void* lvl_child,
                                      const void* lvl_off, int levels, int c1,
                                      const void* term_keys,
                                      const void* term_mark, int cap,
                                      void* found, void* idx, void* stream) {
  if (t == 0) return 0;
  const int threads = 256;
  skiplist_search_kernel<<<(t + threads - 1) / threads, threads, 0,
                           (cudaStream_t)stream>>>(
      (const u64*)q, t, (const u64*)lvl_keys, (const int*)lvl_child,
      (const int*)lvl_off, levels, c1, (const u64*)term_keys,
      (const int8_t*)term_mark, cap, (int8_t*)found, (int*)idx);
  return (int)cudaGetLastError();
}
