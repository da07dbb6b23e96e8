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
// Bound: the B*S*D*N exps over the SFU's rate (16 a clock per SM); beside
// each exp four f32 ops (dt*A, dx*B, the h FMA, the C FMA), and the bytes
// far below. What the design does about it:
//
//   * Registers hold the state: a thread owns PER = min(N, 8) consecutive
//     states of one channel (h, and A with log2(e) folded in, for the
//     whole sequence), and a group of G = N / PER consecutive lanes covers
//     the channel's N states; y_t's partial sums meet in a shuffle-xor
//     butterfly over the group, and the group's first lane stores y_t.
//     At hymba's prefill (B 8, D 3,200, N 16) that is 51,200 threads in
//     400 blocks of SS_THREADS, against one thread a channel before.
//   * One MUFU op an element: exp(dt A) = ex2.approx.ftz(dt * (A log2 e)).
//     It moves h by a few ulps against expf, and the y sum runs in another
//     order than the plain scans'; both stay within the checks.
//   * dt, B, C (shared by the block's channels) and the block's x tile are
//     staged SS_CHUNK steps at a time with cp.async into a ring of
//     SS_SLOTS buffers, two chunks ahead of the recurrence, with one block
//     barrier a chunk.
//   * h0, A and h_last move as contiguous float4s per lane.
#include <cuda_runtime.h>
#include <stdint.h>

#define SS_THREADS 128
#define SS_PER 8                  // states a lane, at most
#define SS_CHUNK 32
#define SS_SLOTS 3
#define SS_LOG2E 1.4426950408889634f

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// cp.async of 4 or 16 bytes; with `valid` false the destination is zero
// filled and nothing is read.
__device__ __forceinline__ void cp4(float* dst, const float* src, bool valid) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     bool valid) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int PENDING>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// PER contiguous floats at src (or zeros when src is null).
template <int PER>
__device__ __forceinline__ void load_row(float (&v)[PER], const float* src,
                                         bool vec) {
#pragma unroll
  for (int k = 0; k < PER; k += 4) {
    if (src == nullptr) {
      v[k] = v[k + 1] = v[k + 2] = v[k + 3] = 0.f;
    } else if (vec) {
      float4 f = *reinterpret_cast<const float4*>(src + k);
      v[k] = f.x, v[k + 1] = f.y, v[k + 2] = f.z, v[k + 3] = f.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[k + j] = src[k + j];
    }
  }
}

// Copy rows [0, steps) of a tile whose rows hold `w` units of UNIT floats:
// unit (t, u) goes from src + t * src_stride + UNIT * u to dst + t * w * UNIT
// + UNIT * u, zero filled where `col_ok(u)` is false. Threads take units in
// row-major order, so a warp copies consecutive units of a row.
template <int UNIT, typename Ok>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          size_t src_stride, int steps, int w,
                                          Ok col_ok) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (nt >= w) {                             // whole rows per pass
    const int u = tid % w, rows = nt / w;
    if (tid >= rows * w) return;
    const bool ok = col_ok(u);
    for (int t = tid / w; t < steps; t += rows) {
      float* to = dst + (t * w + u) * UNIT;
      const float* from = ok ? src + t * src_stride + u * UNIT : src;
      if (UNIT == 4) cp16(to, from, ok); else cp4(to, from, ok);
    }
  } else {
    for (int t = 0; t < steps; ++t)
      for (int u = tid; u < w; u += nt) {
        const bool ok = col_ok(u);
        float* to = dst + (t * w + u) * UNIT;
        const float* from = ok ? src + t * src_stride + u * UNIT : src;
        if (UNIT == 4) cp16(to, from, ok); else cp4(to, from, ok);
      }
  }
}

// One buffer of the staging ring: dt[SS_CHUNK], B and C [SS_CHUNK][N],
// x [SS_CHUNK][ch] (ch = the block's channels). Only the chunk's `steps`
// rows are copied: the recurrence reads no others.
template <int N>
__device__ __forceinline__ void stage_chunk(
    float* buf, int ch, const float* __restrict__ x,
    const float* __restrict__ dt, const float* __restrict__ bmat,
    const float* __restrict__ cmat, int b, int s, int d, int d0, int t0,
    bool vec_bc, bool vec_x) {
  const int steps = min(SS_CHUNK, s - t0);
  const size_t row = (size_t)b * s + t0;     // (b, t0) in [B, S]
  float* dts = buf;
  float* bs = dts + SS_CHUNK;
  float* cs = bs + SS_CHUNK * N;
  float* xs = cs + SS_CHUNK * N;
  auto all = [](int) { return true; };
  copy_rows<1>(dts, dt + row, 1, steps, 1, all);
  if (vec_bc) {
    copy_rows<4>(bs, bmat + row * N, N, steps, N / 4, all);
    copy_rows<4>(cs, cmat + row * N, N, steps, N / 4, all);
  } else {
    copy_rows<1>(bs, bmat + row * N, N, steps, N, all);
    copy_rows<1>(cs, cmat + row * N, N, steps, N, all);
  }
  const float* xr = x + row * d + d0;
  const int live = d - d0;                   // columns left of the edge
  if (vec_x)                                 // d % 4 == 0 (ch is)
    copy_rows<4>(xs, xr, d, steps, ch / 4,
                 [live](int u) { return 4 * u < live; });
  else
    copy_rows<1>(xs, xr, d, steps, ch, [live](int u) { return u < live; });
}

// The block's channel count at state size N.
template <int N>
__host__ __device__ constexpr int ss_channels() {
  return SS_THREADS / (N / (N < SS_PER ? N : SS_PER));
}

// Dynamic shared memory of one launch: the SS_SLOTS staging buffers.
template <int N>
__host__ __device__ constexpr size_t ss_smem_bytes() {
  return SS_SLOTS * sizeof(float) * SS_CHUNK *
         (1 + 2 * N + ss_channels<N>());
}

template <int N>
__global__ void __launch_bounds__(SS_THREADS) selective_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ bmat, const float* __restrict__ cmat,
    const float* __restrict__ a, const float* __restrict__ h0,
    float* __restrict__ y, float* __restrict__ h_last, int s, int d) {
  constexpr int PER = N < SS_PER ? N : SS_PER;  // states a lane
  constexpr int G = N / PER;                    // lanes a channel
  constexpr int CH = ss_channels<N>();          // channels a block
  constexpr int STAGE = SS_CHUNK * (1 + 2 * N + CH);
  static_assert(PER % 4 == 0 && G <= 32, "lane split");
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int c = threadIdx.x / G, g = threadIdx.x % G;
  const int chan = d0 + c;
  const bool live = chan < d;

  float av[PER], h[PER];
  const size_t st = ((size_t)b * d + chan) * N + g * PER;
  load_row<PER>(av, live ? a + (size_t)chan * N + g * PER : nullptr,
                aligned16(a));
  load_row<PER>(h, live && h0 != nullptr ? h0 + st : nullptr, aligned16(h0));
#pragma unroll
  for (int j = 0; j < PER; ++j) av[j] *= SS_LOG2E;

  const bool vec_bc = aligned16(bmat) && aligned16(cmat);
  const bool vec_x = aligned16(x) && d % 4 == 0;
  const int chunks = (s + SS_CHUNK - 1) / SS_CHUNK;
  for (int kc = 0; kc < 2 && kc < chunks; ++kc) {
    stage_chunk<N>(smem + kc * STAGE, CH, x, dt, bmat, cmat, b, s, d, d0,
                   kc * SS_CHUNK, vec_bc, vec_x);
    cp_commit();
  }
  for (int kc = 0; kc < chunks; ++kc) {
    const int t0 = kc * SS_CHUNK;
    if (kc + 1 < chunks)
      cp_wait<1>();
    else
      cp_wait<0>();
    // chunk kc is in for everyone, and everyone is done with chunk kc - 1,
    // whose slot takes chunk kc + 2
    __syncthreads();
    if (kc + 2 < chunks) {
      stage_chunk<N>(smem + ((kc + 2) % SS_SLOTS) * STAGE, CH, x, dt, bmat,
                     cmat, b, s, d, d0, t0 + 2 * SS_CHUNK, vec_bc, vec_x);
      cp_commit();
    }
    const float* dts = smem + (kc % SS_SLOTS) * STAGE;
    const float* bs = dts + SS_CHUNK + g * PER;
    const float* cs = bs + SS_CHUNK * N;
    const float* xs = dts + SS_CHUNK + 2 * SS_CHUNK * N + c;
    float* yt = y + ((size_t)b * s + t0) * d + chan;
    const int steps = min(SS_CHUNK, s - t0);
#pragma unroll 4
    for (int t = 0; t < steps; ++t) {
      const float dtt = dts[t];
      const float dx = dtt * xs[t * CH];
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < PER; j += 4) {
        const float4 fb = *reinterpret_cast<const float4*>(bs + t * N + j);
        const float4 fc = *reinterpret_cast<const float4*>(cs + t * N + j);
        const float bv[4] = {fb.x, fb.y, fb.z, fb.w};
        const float cv[4] = {fc.x, fc.y, fc.z, fc.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          h[j + i] = fmaf(ex2(dtt * av[j + i]), h[j + i], dx * bv[i]);
          acc = fmaf(h[j + i], cv[i], acc);
        }
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (g == 0 && live) yt[(size_t)t * d] = acc;
    }
  }
  if (!live) return;
  float* out = h_last + st;
  if (aligned16(h_last)) {
#pragma unroll
    for (int j = 0; j < PER; j += 4)
      *reinterpret_cast<float4*>(out + j) =
          make_float4(h[j], h[j + 1], h[j + 2], h[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < PER; ++j) out[j] = h[j];
  }
}

template <int N>
static int ss_launch(int b, cudaStream_t st, const void* x, const void* dt,
                     const void* bmat, const void* cmat, const void* a,
                     const void* h0, void* y, void* h_last, int s, int d) {
  constexpr size_t smem = ss_smem_bytes<N>();
  // once per instantiation: allow the ring's dynamic shared memory (over
  // the default 48 KB at N 4, 8 and 64), and let the SM give shared memory
  // its largest share, so that a balanced grid's blocks are all resident
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        selective_scan_kernel<N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        selective_scan_kernel<N>,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
  }();
  if (attr != cudaSuccess) return (int)attr;
  constexpr int ch = ss_channels<N>();
  dim3 grid((d + ch - 1) / ch, b);
  selective_scan_kernel<N><<<grid, SS_THREADS, smem, st>>>(
      (const float*)x, (const float*)dt, (const float*)bmat,
      (const float*)cmat, (const float*)a, (const float*)h0, (float*)y,
      (float*)h_last, s, d);
  return (int)cudaGetLastError();
}

// h0 may be null (a zero state). Returns the launch's cudaGetLastError(),
// or cudaErrorInvalidValue for a state size the kernel is not built for.
extern "C" int selective_scan_launch(const void* x, const void* dt,
                                     const void* bmat, const void* cmat,
                                     const void* a, const void* h0, void* y,
                                     void* h_last, int b, int s, int d, int n,
                                     void* stream) {
  if (b == 0 || d == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define SS_CASE(NN)                                                         \
  case NN:                                                                  \
    return ss_launch<NN>(b, st, x, dt, bmat, cmat, a, h0, y, h_last, s, d);
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
}
