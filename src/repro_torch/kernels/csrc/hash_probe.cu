// Batched fixed-hash bucket probe for Hopper (sm_90a).
//
// Replaces the Pallas kernel `hash_probe_tiles` / `bucket_probe` in
// src/repro/kernels/hash_probe/kernel.py. One thread per query loops over the
// B <= 16 columns of its bucket row (slot precomputed by `hash_slot` in the
// glue, as in the reference) and reports the first matching column.
//
// Bound: bytes. A probe reads one row of B 8-byte keys (one or two 64-byte
// segments) at a random slot; the bytes per query are fixed and small, so the
// launch is limited by random-access memory traffic and latency. The design
// keeps one independent row read per thread and enough 256-thread blocks in
// flight to cover it.
#include "probe.cuh"

__global__ void hash_probe_kernel(const u64* __restrict__ q,
                                  const int* __restrict__ slots, int t,
                                  const u64* __restrict__ keys, int m, int b,
                                  int8_t* __restrict__ found,
                                  int* __restrict__ col) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= t) return;
  int c;
  bool f = bucket_probe(q[i], slots[i], keys, m, b, &c);
  found[i] = f ? 1 : 0;
  col[i] = c;
}

extern "C" int hash_probe_launch(const void* q, const void* slots, int t,
                                 const void* keys, int m, int b, void* found,
                                 void* col, void* stream) {
  if (t == 0) return 0;
  const int threads = 256;
  hash_probe_kernel<<<(t + threads - 1) / threads, threads, 0,
                      (cudaStream_t)stream>>>(
      (const u64*)q, (const int*)slots, t, (const u64*)keys, m, b,
      (int8_t*)found, (int*)col);
  return (int)cudaGetLastError();
}
