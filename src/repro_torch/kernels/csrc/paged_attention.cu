// Paged GQA decode attention over block-pool pages for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_pa_kernel` / `paged_attention_grouped` in
// src/repro/kernels/paged_attention/kernel.py. One new token per request
// attends over that request's pages of the paper's §V block pool:
//
//   q       [B, Hkv * G, D]  (query head h = kv_head * G + g)
//   k, v    [N, page, Hkv, D] one layer's pools
//   tables  [B, P] int32 page ids, -1 = no page
//   lengths [B] int32 tokens to attend over
//   out     [B, Hkv * G, D] in q's type (float or bf16)
//
// Page j of request b is live when tables[b, j] >= 0 and j * page <
// lengths[b]; inside a live page a token at position >= lengths[b] is the
// ragged tail. The TPU kernel masks that tail with -1e30 and adds its zero
// weights; here it is skipped, which gives the same sums (the first token
// of a live page is always valid, so the running max is finite and the
// weight of a masked token, exp(-1e30 - m), is exactly 0). The softmax is
// online and in f32; the result is acc / max(l, 1e-30), so a request with
// no live page gives zeros.
//
// Design: one block per (request, KV head) walks the block table in a loop
// (the TPU's sequential page axis and its scalar prefetch of the table).
// The block's 128 threads form groups of D / VEC threads, VEC elements a
// thread (one 16-byte load: 8 bf16 or 4 f32); a group takes one token of a
// page at a time, the groups interleaved over the page's tokens. Each
// thread keeps the G query heads of its VEC dimensions in registers; the
// score of a token is the group's shuffle-reduced dot product, and each
// group runs its own online softmax (running max m, sum l, accumulator
// acc over its VEC dimensions). At the end the groups' partial softmaxes
// are merged through shared memory (flash-decoding's merge inside one
// block) and written in q's type.
//
// Bound: bytes. Each token below a request's length on a live page has
// its K and V rows of one KV head (2 * D elements, whole 32-byte sectors)
// read once, plus q, out and the table entries below the length (the
// unread ragged tail is not counted); the work is about 4 * G * D
// flops a token, far below the f32 rate. Split-KV across blocks (more
// blocks in flight for long requests) and cp.async / TMA staging of pages
// are the next steps (ROADMAP.md §3).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PA_THREADS 128
#define PA_NEG_INF -1e30f

template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
  __device__ __forceinline__ static float store(float x) { return x; }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static __nv_bfloat16 store(float x) {
    return __float2bfloat16(x);
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int G>
__global__ void __launch_bounds__(PA_THREADS) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ lengths, T* __restrict__ out, int hkv, int d,
    int page, int p, float scale) {
  constexpr int VEC = Vec16<T>::N;
  // the groups' partial softmaxes, merged at the end
  __shared__ float m_s[PA_THREADS][G];
  __shared__ float l_s[PA_THREADS][G];
  __shared__ float acc_s[PA_THREADS * VEC * G];

  const int b = blockIdx.x / hkv;
  const int h = blockIdx.x % hkv;
  const int tpg = d / VEC;               // threads per group (power of 2)
  const int ngroups = PA_THREADS / tpg;
  const int grp = threadIdx.x / tpg;
  const int d0 = (threadIdx.x % tpg) * VEC;

  float qr[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qp = q + ((size_t)b * hkv * G + (size_t)h * G + g) * d + d0;
#pragma unroll
    for (int i = 0; i < VEC; ++i) qr[g][i] = to_float(qp[i]);
  }
  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = PA_NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  }

  const int len = lengths[b];
  const size_t row = (size_t)hkv * d;    // elements of one token row
  for (int j = 0; j < p; ++j) {
    const int pid = tables[(size_t)b * p + j];
    if (pid < 0 || j * page >= len) continue;    // the same for every thread
    const T* kp = k_pool + (size_t)pid * page * row + (size_t)h * d + d0;
    const T* vp = v_pool + (size_t)pid * page * row + (size_t)h * d + d0;
    // every thread runs the same trips, so the shuffles stay convergent
    for (int t0 = 0; t0 < page; t0 += ngroups) {
      const int t = t0 + grp;
      const bool valid = t < page && j * page + t < len;
      float kr[VEC];
      if (valid) {
        Vec16<T>::load(kp + (size_t)t * row, kr);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kr[i] = 0.f;
      }
      float s[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float a = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) a = fmaf(qr[g][i], kr[i], a);
        for (int off = tpg >> 1; off > 0; off >>= 1)
          a += __shfl_xor_sync(0xffffffffu, a, off);
        s[g] = a * scale;
      }
      if (valid) {
        float vr[VEC];
        Vec16<T>::load(vp + (size_t)t * row, vr);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float mn = fmaxf(m[g], s[g]);
          const float alpha = expf(m[g] - mn);
          const float w = expf(s[g] - mn);
          l[g] = l[g] * alpha + w;
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            acc[g][i] = fmaf(acc[g][i], alpha, w * vr[i]);
          m[g] = mn;
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (d0 == 0) {
      m_s[grp][g] = m[g];
      l_s[grp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      acc_s[((size_t)grp * G + g) * d + d0 + i] = acc[g][i];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < G * d; e += PA_THREADS) {
    const int g = e / d, dd = e % d;
    float mx = PA_NEG_INF;
    for (int k = 0; k < ngroups; ++k) mx = fmaxf(mx, m_s[k][g]);
    float lsum = 0.f, o = 0.f;
    for (int k = 0; k < ngroups; ++k) {
      const float c = expf(m_s[k][g] - mx);
      lsum = fmaf(l_s[k][g], c, lsum);
      o = fmaf(acc_s[((size_t)k * G + g) * d + dd], c, o);
    }
    out[((size_t)b * hkv * G + (size_t)h * G + g) * d + dd] =
        Vec16<T>::store(o / fmaxf(lsum, 1e-30f));
  }
}

template <typename T>
static int launch_g(int g, dim3 grid, cudaStream_t stream, const void* q,
                    const void* k, const void* v, const void* tables,
                    const void* lengths, void* out, int hkv, int d, int page,
                    int p, float scale) {
#define PA_CASE(GG)                                                      \
  case GG:                                                               \
    paged_attention_kernel<T, GG><<<grid, PA_THREADS, 0, stream>>>(      \
        (const T*)q, (const T*)k, (const T*)v, (const int*)tables,       \
        (const int*)lengths, (T*)out, hkv, d, page, p, scale);           \
    break;
  // the group sizes of the ported configs (qwen3-1.7b: 16 / 8); another
  // G is added with the config that needs it and chip_smoke.py's check
  switch (g) {
    PA_CASE(2)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PA_CASE
  return (int)cudaGetLastError();
}

// is_bf16: 1 for bfloat16 tensors, 0 for float32. The wrapper checks the
// shapes; the checks here refuse what the kernel cannot take: D a multiple
// of one 16-byte vector with D / VEC a power of two of at most 32 threads
// (a group stays inside one warp), and G = 2.
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool, const void* tables,
                                      const void* lengths, void* out, int b,
                                      int hkv, int g, int d, int page, int p,
                                      int is_bf16, float scale,
                                      void* stream) {
  if (b == 0 || hkv == 0) return 0;
  const int vec = is_bf16 ? 8 : 4;
  const int tpg = d / vec;
  if (d % vec != 0 || tpg < 1 || tpg > 32 || (tpg & (tpg - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid(b * hkv);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_g<__nv_bfloat16>(g, grid, s, q, k_pool, v_pool, tables,
                                   lengths, out, hkv, d, page, p, scale);
  return launch_g<float>(g, grid, s, q, k_pool, v_pool, tables, lengths,
                         out, hkv, d, page, p, scale);
}
