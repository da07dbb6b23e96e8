// Fused tier-stack FIND for Hopper (sm_90a): hot bucket probe, warm walk and
// the per-run spill binary search in one launch.
//
// Replaces the Pallas kernel `tier_find_tiles` / `_tf_kernel` /
// `spill_run_probe` in src/repro/kernels/tier_find/kernel.py, both warm
// layouts: `blocked` = 0 walks the level-major levels (`level_walk`),
// `blocked` = 1 the block-major B-skiplist rows (`block_walk<1>`, a thread
// counting each 128-key node alone, as the reference's `warm_blocked`
// branch). One thread per query runs the three probes back to back with the
// bodies shared with the single-tier kernels (probe.cuh). Raw per-tier
// results come out; the fall-through masking stays in the glue, as in the
// reference.
//
// Bound: memory latency. Each query makes one random row read, L + 1
// dependent gathers for the level walk (or L + 1 dependent 1-KB node reads
// for the block walk) and, per live spill run, a binary search of
// ~log2(run length) dependent 8-byte reads. The design keeps every query in
// its own thread with the level and run offset tables in shared memory, so
// the only global traffic is the probes themselves.
#include "probe.cuh"

__global__ void tier_find_kernel(
    const u64* __restrict__ q, const int* __restrict__ slots, int t,
    const u64* __restrict__ hot_keys, int m, int b, int blocked,
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
  if (!blocked) load_table(off, lvl_off, levels + 1);
  if (runs > 0) load_table(roff, run_off, runs + 1);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= t) return;
  u64 key = q[i];
  int col;
  hot_found[i] = bucket_probe(key, slots[i], hot_keys, m, b, &col) ? 1 : 0;
  hot_col[i] = col;
  int at;
  warm_found[i] = warm_walk(key, blocked, warm_keys, lvl_child, off, levels,
                            width, term_keys, term_mark, cap, n_pad, &at)
                      ? 1 : 0;
  warm_idx[i] = at;
  if (runs > 0) {
    int cell;
    sp_found[i] = spill_probe(key, sp_keys, sp_dead, roff, runs, s, &cell) ? 1 : 0;
    sp_cell[i] = cell;
  }
}

extern "C" int tier_find_launch(
    const void* q, const void* slots, int t, const void* hot_keys, int m,
    int b, int blocked, const void* warm_keys, const void* lvl_child,
    const void* lvl_off, int levels, int width, const void* term_keys,
    const void* term_mark, int cap, int n_pad, const void* sp_keys,
    const void* sp_dead, const void* run_off, int runs, int s, void* hot_found,
    void* hot_col, void* warm_found, void* warm_idx, void* sp_found,
    void* sp_cell, void* stream) {
  if (t == 0) return 0;
  const int threads = 256;
  tier_find_kernel<<<(t + threads - 1) / threads, threads, 0,
                     (cudaStream_t)stream>>>(
      (const u64*)q, (const int*)slots, t, (const u64*)hot_keys, m, b, blocked,
      (const u64*)warm_keys, (const int*)lvl_child, (const int*)lvl_off,
      levels, width, (const u64*)term_keys, (const int8_t*)term_mark, cap,
      n_pad, (const u64*)sp_keys, (const int8_t*)sp_dead, (const int*)run_off,
      runs, s,
      (int8_t*)hot_found, (int*)hot_col, (int8_t*)warm_found, (int*)warm_idx,
      (int8_t*)sp_found, (int*)sp_cell);
  return (int)cudaGetLastError();
}
