// Fused selective scan (the mamba-1 recurrence) for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_ss_kernel` / `selective_scan_blocks` in
// src/repro/kernels/selective_scan/kernel.py. Per batch b, channel d and
// state n:
//
//   h_t[d, n] = exp(dt_t * A[d, n]) * h_{t-1}[d, n] + (dt_t * x_t[d]) * B_t[n]
//   y_t[d]    = sum_n h_t[d, n] * C_t[n]
//
//   x   [B, S, D]  f32     dt  [B, S] f32    bmat, cmat [B, S, N] f32
//   a   [D, N]     f32     h0  [B, D, N] f32 (or null: zeros)
//   y   [B, S, D]  f32     h_last [B, D, N] f32
//
// Unlike the TPU kernel, this one starts from h0 and returns the last
// state: the model carries the state from prefill into decode, and every
// decode step is a scan of length 1 from the cached state.
//
// Design: one thread per (batch, channel) holds h[N] and A[d, :] in
// registers for the whole sequence (the TPU kernel's VMEM scratch that
// persists across its sequential chunk axis) and steps the recurrence in
// order. dt, B and C of a batch are the same for all its channels: a
// block of SS_THREADS channels stages them in shared memory SS_CHUNK
// steps at a time, together with its x tile; loads and the y stores are
// coalesced along the channel. The math is f32 with expf, as the plain
// version's; only the order of the y sum differs from it.
//
// Bound: the larger of the bytes (x and y, the B/C/dt rows, A, h0 and
// h_last, each once) over the HBM rate and the B*S*D*N exps over the
// SFU's rate (16 a clock per SM), with B*S*D*N*4 FMAs beside them.
// With 25,600 threads at the served prefill (B 8, D 3,200) the card
// holds under 200 threads per SM: splitting N across a few lanes per
// channel (a shuffle reduction for y) is the next step.
#include <cuda_runtime.h>
#include <stdint.h>

#define SS_THREADS 128
#define SS_CHUNK 32

template <int N>
__global__ void __launch_bounds__(SS_THREADS) selective_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ bmat, const float* __restrict__ cmat,
    const float* __restrict__ a, const float* __restrict__ h0,
    float* __restrict__ y, float* __restrict__ h_last, int s, int d) {
  __shared__ float dt_s[SS_CHUNK];
  __shared__ float b_s[SS_CHUNK][N];
  __shared__ float c_s[SS_CHUNK][N];
  __shared__ float x_s[SS_CHUNK][SS_THREADS];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * SS_THREADS;
  const int ch = d0 + threadIdx.x;
  const bool live = ch < d;
  const int width = min(SS_THREADS, d - d0);   // channels of this block

  float h[N], av[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    av[n] = live ? a[(size_t)ch * N + n] : 0.f;
    h[n] = (live && h0 != nullptr) ? h0[((size_t)b * d + ch) * N + n] : 0.f;
  }

  const float* xb = x + (size_t)b * s * d;
  float* yb = y + (size_t)b * s * d;
  for (int t0 = 0; t0 < s; t0 += SS_CHUNK) {
    const int steps = min(SS_CHUNK, s - t0);
    __syncthreads();                  // the last chunk's reads are done
    for (int e = threadIdx.x; e < steps * N; e += SS_THREADS) {
      const int t = e / N, n = e % N;
      const size_t off = ((size_t)b * s + t0 + t) * N + n;
      b_s[t][n] = bmat[off];
      c_s[t][n] = cmat[off];
    }
    if (threadIdx.x < steps) dt_s[threadIdx.x] = dt[(size_t)b * s + t0 +
                                                    threadIdx.x];
    for (int t = 0; t < steps; ++t)
      if (threadIdx.x < width)
        x_s[t][threadIdx.x] = xb[(size_t)(t0 + t) * d + ch];
    __syncthreads();
    if (!live) continue;
    for (int t = 0; t < steps; ++t) {
      const float dtt = dt_s[t];
      const float dx = dtt * x_s[t][threadIdx.x];
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = expf(dtt * av[n]) * h[n] + dx * b_s[t][n];
        acc = fmaf(h[n], c_s[t][n], acc);
      }
      yb[(size_t)(t0 + t) * d + ch] = acc;
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_last[((size_t)b * d + ch) * N + n] = h[n];
  }
}

// h0 may be null (a zero state). Returns the launch's cudaGetLastError();
// N must be one of the instantiated state sizes (a multiple of 4 up to
// 64).
extern "C" int selective_scan_launch(const void* x, const void* dt,
                                     const void* bmat, const void* cmat,
                                     const void* a, const void* h0, void* y,
                                     void* h_last, int b, int s, int d, int n,
                                     void* stream) {
  if (b == 0 || d == 0) return 0;
  dim3 grid((d + SS_THREADS - 1) / SS_THREADS, b);
  cudaStream_t st = (cudaStream_t)stream;
#define SS_CASE(NN)                                                       \
  case NN:                                                                \
    selective_scan_kernel<NN><<<grid, SS_THREADS, 0, st>>>(               \
        (const float*)x, (const float*)dt, (const float*)bmat,            \
        (const float*)cmat, (const float*)a, (const float*)h0, (float*)y, \
        (float*)h_last, s, d);                                            \
    break;
  switch (n) {
    SS_CASE(4)
    SS_CASE(8)
    SS_CASE(16)
    SS_CASE(32)
    SS_CASE(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SS_CASE
  return (int)cudaGetLastError();
}
