// Shared by the selective scan kernels (`selective_scan.cu`, the forward
// and the bf16 scan; `selective_scan_bwd.cu`, the backward): the lane
// split, the cp.async staging of a chunk of dt, B, C and x (and dy for
// the backward) and the launch attributes. A lane holds PER consecutive
// states of one channel (PER in 1, 2, 4, 8), N / PER consecutive lanes a
// channel; the host picks PER and the block's lanes for each launch
// (`kernels/selective_scan/kernel.py:scan_geometry`).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define SS_THREADS 128           // lanes a block
#define SS_PER 8                  // states a lane, at most
#define SS_CHUNK 32               // steps a staging buffer holds
#define SS_SAVE 16                // steps between saved states: a window
#define SS_BATCH 16               // a lane's elements a forward batch holds
#define SS_SLOTS 3
#define SS_LOG2E 1.4426950408889634f

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

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

// PER contiguous floats at src (or zeros when src is null); `vec`: src is
// 16-byte aligned (float4s when PER is a multiple of 4).
template <int PER>
__device__ __forceinline__ void load_row(float (&v)[PER], const float* src,
                                         bool vec) {
  if (src == nullptr) {
#pragma unroll
    for (int k = 0; k < PER; ++k) v[k] = 0.f;
    return;
  }
  if constexpr (PER % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int k = 0; k < PER; k += 4) {
        float4 f = *reinterpret_cast<const float4*>(src + k);
        v[k] = f.x, v[k + 1] = f.y, v[k + 2] = f.z, v[k + 3] = f.w;
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) v[k] = src[k];
}

// PER contiguous floats of shared memory at p, whose offset is a multiple
// of PER floats (the staged B or C row of a lane's states).
template <int PER>
__device__ __forceinline__ void lds_row(float (&v)[PER], const float* p) {
  if constexpr (PER % 4 == 0) {
#pragma unroll
    for (int k = 0; k < PER; k += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + k);
      v[k] = f.x, v[k + 1] = f.y, v[k + 2] = f.z, v[k + 3] = f.w;
    }
  } else if constexpr (PER == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x, v[1] = f.y;
  } else {
    v[0] = p[0];
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
// x [SS_CHUNK][ch] (ch = the block's channels), and for the backward dy
// [SS_CHUNK][ch] after x. Only the chunk's `steps` rows are copied: the
// recurrence reads no others.
template <int N>
__device__ __forceinline__ void stage_chunk(
    float* buf, int ch, const float* __restrict__ x,
    const float* __restrict__ dt, const float* __restrict__ bmat,
    const float* __restrict__ cmat, int b, int s, int d, int d0, int t0,
    bool vec_bc, bool vec_x, const float* __restrict__ dy = nullptr) {
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
  const int live = d - d0;                   // columns left of the edge
  // a block wholly past D (the backward's cluster padding) reads nothing
  const size_t xo = live > 0 ? row * d + d0 : 0;
  const float* xr = x + xo;
  // vec_x: d % 4 == 0 (ch is) and x (and dy) 16-byte aligned
  auto rows = [&](float* to, const float* from) {
    if (vec_x)
      copy_rows<4>(to, from, d, steps, ch / 4,
                   [live](int u) { return 4 * u < live; });
    else
      copy_rows<1>(to, from, d, steps, ch, [live](int u) { return u < live; });
  };
  rows(xs, xr);
  if (dy != nullptr) rows(xs + SS_CHUNK * ch, dy + xo);
}

// The block's channel count at state size N, PER states a lane.
template <int N, int PER>
__host__ __device__ constexpr int ss_channels() {
  return SS_THREADS / (N / PER);
}

// Dynamic shared memory of one forward launch: the SS_SLOTS staging
// buffers.
template <int N, int PER>
__host__ __device__ constexpr size_t ss_smem_bytes() {
  return SS_SLOTS * sizeof(float) * SS_CHUNK *
         (1 + 2 * N + ss_channels<N, PER>());
}

// once per kernel: allow `smem` bytes of dynamic shared memory (over the
// default 48 KB), and let the SM give shared memory its largest share, so
// that a balanced grid's blocks are all resident
template <typename K>
static cudaError_t ss_attrs(K kernel, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}
