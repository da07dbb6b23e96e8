// Two-level split-order FIND for Hopper (sm_90a).
//
// Replaces the Pallas kernel `splitorder_probe_tiles` / `table_search` in
// src/repro/kernels/splitorder_probe/kernel.py. One thread per query: a
// binary search (searchsorted-left) of the query's bit-reversed hash over its
// table's row [tbl * C2, tbl * C2 + C2) of the rk plane, KEY_INF padding
// sorting last, then the first (rk, key) match among the WINDOW cells
// clip(pos + w, 0, C2 - 1). Keys and rk are the state's own int64 planes,
// compared here as unsigned 64-bit integers: there is no (hi, lo) split.
//
// Bound: memory latency. A query is log2(C2) + 1 dependent 8-byte loads
// (22 at C2 = 2^21) and up to WINDOW more; the first midpoints of a table
// are shared by every query of that table and stay in L2, the rest are
// random sectors. The design answer is plain occupancy: 256-thread blocks,
// no shared memory, many searches in flight per SM.
#include "probe.cuh"

#define WINDOW 4  // must equal core.splitorder.WINDOW

__global__ void splitorder_probe_kernel(const u64* __restrict__ q_rk,
                                        const u64* __restrict__ q_key,
                                        const int* __restrict__ tables, int t,
                                        const u64* __restrict__ rk,
                                        const u64* __restrict__ keys,
                                        int n_tables, int c2,
                                        int8_t* __restrict__ found,
                                        int* __restrict__ at) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= t) return;
  const u64 qr = q_rk[i], qk = q_key[i];
  const long long base = (long long)clampi(tables[i], 0, n_tables - 1) * c2;
  const u64* row = rk + base;
  int lo = 0, hi = c2;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (row[mid] < qr) lo = mid + 1;
    else hi = mid;
  }
  int off = 0;
  bool f = false;
  for (int w = 0; w < WINDOW; ++w) {
    int c = clampi(lo + w, 0, c2 - 1);
    if (row[c] == qr && keys[base + c] == qk) {
      off = w;
      f = true;
      break;
    }
  }
  found[i] = f ? 1 : 0;
  at[i] = clampi(lo + off, 0, c2 - 1);
}

extern "C" int splitorder_probe_launch(const void* q_rk, const void* q_key,
                                       const void* tables, int t,
                                       const void* rk, const void* keys,
                                       int n_tables, int c2, void* found,
                                       void* at, void* stream) {
  if (t == 0) return 0;
  const int threads = 256;
  splitorder_probe_kernel<<<(t + threads - 1) / threads, threads, 0,
                            (cudaStream_t)stream>>>(
      (const u64*)q_rk, (const u64*)q_key, (const int*)tables, t,
      (const u64*)rk, (const u64*)keys, n_tables, c2, (int8_t*)found,
      (int*)at);
  return (int)cudaGetLastError();
}
