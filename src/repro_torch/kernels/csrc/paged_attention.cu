// Paged GQA decode attention over block-pool pages for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_pa_kernel` / `paged_attention_grouped`
// (src/repro/kernels/paged_attention/kernel.py:67, `pallas_call` at line
// 96). One new token per request attends over that request's pages of the
// paper's §V block pool:
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
// Bound: bytes. Each token below a request's length on a live page has
// its K and V rows of one KV head (2 * D elements) read once, plus q, out
// and the table entries below the length; the work is about 4 * G * D
// flops a token, far below the f32 rate. So the design keeps enough bytes
// in flight to fill the HBM pipe:
//
// - Split-KV (flash-decoding). The grid is (request, KV head, split): a
//   split owns `pps` consecutive table entries (the wrapper picks pps from
//   B * Hkv and the table width P, so the served batch of 32 x 8 heads
//   runs 2,048 blocks of at most 16 pages, several waves on 132 SMs).
// - Asynchronous staging. A split lists its live pages, then streams them
//   through a ring of PA_STAGES page slots in shared memory with 16-byte
//   `cp.async` (K and V rows of the tokens below the length), so
//   PA_STAGES - 1 pages are in flight while one is scored.
// - One softmax update per page. The block scores the whole page for all
//   G query heads (8 threads per token, each a 16-byte slice of the row,
//   shuffle-reduced; fewer where a row has fewer slices: 2 for a bf16 row
//   of 16, the reduced configs' heads), then one warp per head takes the
//   page's max, the rescale and the weights (one lane per token), then
//   each thread adds the weighted V column it owns for its heads.
// - A merge. Each split writes its (m, l, acc) in f32 to scratch; a second
//   kernel, launched by the same launcher, combines the splits of each
//   (request, KV head) in f32 and writes q's type. A split with no live
//   page writes m = -1e30, l = 0, acc = 0: zero weight beside a live
//   split, and zeros when every split is empty.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PA_THREADS 128
#define PA_STAGES 4
#define PA_MAX_PPS 16     // table entries a split owns, at most
#define PA_MAX_PAGE 32    // tokens a page, at most (one warp lane each)
#define PA_NEG -1e30f

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// sixteen bytes of a row as floats
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// shared floats ahead of the page ring: q [G][D], scores and weights
// [G][32], the per-head rescale [G] padded to 16
__host__ __device__ constexpr int pa_head_floats(int g, int d) {
  return g * d + 2 * g * PA_MAX_PAGE + (g + 15) / 16 * 16;
}

template <typename T, int G, int D>
__global__ void __launch_bounds__(PA_THREADS) paged_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ lengths, float* __restrict__ ml,
    float* __restrict__ acc_out, int hkv, int page, int p, int pps,
    int n_split, float scale) {
  constexpr int VEC = 16 / sizeof(T);   // elements of a 16-byte chunk
  constexpr int NCH = D / VEC;          // chunks of a row
  constexpr int TPT = NCH < 8 ? NCH : 8;  // scoring threads a token
  constexpr int CPP = NCH / TPT;        // chunks of a row a scoring thread
  constexpr int R = PA_THREADS / D;     // threads of one V column
  constexpr int GT = (G + R - 1) / R;   // heads a thread accumulates
  constexpr int GW = (G + 3) / 4;       // heads a warp weighs
  extern __shared__ __align__(16) float pa_smem[];
  float* q_s = pa_smem;
  float* sc = q_s + G * D;
  float* ps = sc + G * PA_MAX_PAGE;
  float* al = ps + G * PA_MAX_PAGE;
  T* ring = reinterpret_cast<T*>(pa_smem + pa_head_floats(G, D));
  __shared__ int list_j[PA_MAX_PPS], list_pid[PA_MAX_PPS], n_live;

  const int split = blockIdx.x % n_split;
  const int bh = blockIdx.x / n_split;
  const int b = bh / hkv, h = bh % hkv;
  const int len = lengths[b];
  const int tid = threadIdx.x;
  const size_t row = (size_t)hkv * D;   // elements of one token row

  for (int e = tid; e < G * D; e += PA_THREADS)
    q_s[e] = to_float(q[(size_t)bh * G * D + e]);
  if (tid == 0) {
    int n = 0;
    const int j1 = min(p, (split + 1) * pps);
    for (int j = split * pps; j < j1; ++j) {
      const int pid = tables[(size_t)b * p + j];
      if (pid >= 0 && j * page < len) {
        list_j[n] = j;
        list_pid[n] = pid;
        ++n;
      }
    }
    n_live = n;
  }
  __syncthreads();
  const int n = n_live;

  // stage live page i of the split into slot i % PA_STAGES (one commit
  // group per call, empty past the last page)
  auto stage = [&](int i) {
    if (i < n) {
      const int nv = min(page, len - list_j[i] * page);
      T* ks = ring + (size_t)(i % PA_STAGES) * 2 * page * D;
      T* vs = ks + page * D;
      const size_t off = (size_t)list_pid[i] * page * row + (size_t)h * D;
      for (int e = tid; e < nv * NCH; e += PA_THREADS) {
        const int t = e / NCH, c = (e % NCH) * VEC;
        cp_async16(ks + t * D + c, k_pool + off + t * row + c);
        cp_async16(vs + t * D + c, v_pool + off + t * row + c);
      }
    }
    cp_async_commit();
  };

  const int part = tid % TPT, tok = tid / TPT;      // scoring
  const int warp = tid / 32, lane = tid % 32;       // weighing
  const int col = tid % D, g0 = tid / D;            // accumulating
  float m_r[GW], l_r[GW], acc[GT];
#pragma unroll
  for (int i = 0; i < GW; ++i) {
    m_r[i] = PA_NEG;
    l_r[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < GT; ++i) acc[i] = 0.f;

#pragma unroll
  for (int i = 0; i < PA_STAGES - 1; ++i) stage(i);
  for (int i = 0; i < n; ++i) {
    cp_async_wait<PA_STAGES - 2>();
    __syncthreads();          // page i is in; page i - 1 is fully used
    stage(i + PA_STAGES - 1);
    const int nv = min(page, len - list_j[i] * page);
    const T* ks = ring + (size_t)(i % PA_STAGES) * 2 * page * D;
    const T* vs = ks + page * D;
    // scores: TPT threads a token (8, or a whole row's 16-byte chunks
    // when a row has fewer: 2 a token for bf16 rows of 16), thread `part`
    // on chunks part + TPT c (at D >= 64 a quarter warp reads one
    // contiguous 128 bytes); every thread runs the same trips so the
    // shuffles stay convergent, and only tokens below nv are read (at
    // D 16 a pass covers 64 tokens, past the page's slot)
    for (int t = tok; t - tok < page; t += PA_THREADS / TPT) {
      float kf[CPP][VEC];
#pragma unroll
      for (int c = 0; c < CPP; ++c) {
        if (t < nv) {
          load16(ks + t * D + (part + TPT * c) * VEC, kf[c]);
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v) kf[c][v] = 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float a = 0.f;
#pragma unroll
        for (int c = 0; c < CPP; ++c) {
          const float* qv = q_s + g * D + (part + TPT * c) * VEC;
#pragma unroll
          for (int v = 0; v < VEC; ++v) a = fmaf(qv[v], kf[c][v], a);
        }
#pragma unroll
        for (int o = 1; o < TPT; o <<= 1)
          a += __shfl_xor_sync(0xffffffffu, a, o);
        if (part == 0 && t < nv) sc[g * PA_MAX_PAGE + t] = a * scale;
      }
    }
    __syncthreads();
    // one softmax update per page and head: warp w weighs heads w + 4i,
    // lane t token t
#pragma unroll
    for (int i2 = 0; i2 < GW; ++i2) {
      const int g = warp + 4 * i2;
      if (g < G) {
        const bool valid = lane < nv;
        const float s = valid ? sc[g * PA_MAX_PAGE + lane] : -INFINITY;
        float mx = s;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float mn = fmaxf(m_r[i2], mx);
        const float w = valid ? expf(s - mn) : 0.f;
        float sum = w;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        const float alpha = expf(m_r[i2] - mn);
        l_r[i2] = l_r[i2] * alpha + sum;
        m_r[i2] = mn;
        ps[g * PA_MAX_PAGE + lane] = w;
        if (lane == 0) al[g] = alpha;
      }
    }
    __syncthreads();
    // acc = acc * alpha + sum_t w_t v_t over the page's valid tokens
#pragma unroll
    for (int i2 = 0; i2 < GT; ++i2) {
      const int g = g0 + i2 * R;
      if (g < G) {
        float a = acc[i2] * al[g];
        for (int t = 0; t < nv; ++t)
          a = fmaf(ps[g * PA_MAX_PAGE + t], to_float(vs[t * D + col]), a);
        acc[i2] = a;
      }
    }
  }

  const size_t base = ((size_t)bh * n_split + split) * G;
  if (lane == 0) {
#pragma unroll
    for (int i2 = 0; i2 < GW; ++i2) {
      const int g = warp + 4 * i2;
      if (g < G) {
        ml[(base + g) * 2] = m_r[i2];
        ml[(base + g) * 2 + 1] = l_r[i2];
      }
    }
  }
#pragma unroll
  for (int i2 = 0; i2 < GT; ++i2) {
    const int g = g0 + i2 * R;
    if (g < G) acc_out[(base + g) * D + col] = acc[i2];
  }
}

// out = sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30) over
// the splits s of one (request, KV head), M the splits' largest m
template <typename T, int G, int D>
__global__ void __launch_bounds__(PA_THREADS) paged_merge_kernel(
    const float* __restrict__ ml, const float* __restrict__ acc,
    T* __restrict__ out, int n_split) {
  const int bh = blockIdx.x;
  const float* mlb = ml + (size_t)bh * n_split * G * 2;
  const float* ab = acc + (size_t)bh * n_split * G * D;
  for (int e = threadIdx.x; e < G * D; e += PA_THREADS) {
    const int g = e / D, d = e % D;
    float mx = PA_NEG;
    for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, mlb[(s * G + g) * 2]);
    float l = 0.f, o = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float w = expf(mlb[(s * G + g) * 2] - mx);
      l = fmaf(mlb[(s * G + g) * 2 + 1], w, l);
      o = fmaf(ab[((size_t)s * G + g) * D + d], w, o);
    }
    from_float(out + (size_t)bh * G * D + e, o / fmaxf(l, 1e-30f));
  }
}

template <typename T, int G, int D>
static int launch_gd(dim3 grid, int smem, cudaStream_t st, const void* q,
                     const void* k, const void* v, const void* tables,
                     const void* lengths, void* out, void* ml, void* acc,
                     int b, int hkv, int page, int p, int pps, int n_split,
                     float scale) {
  cudaError_t e = cudaFuncSetAttribute(
      paged_split_kernel<T, G, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  paged_split_kernel<T, G, D><<<grid, PA_THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)tables,
      (const int*)lengths, (float*)ml, (float*)acc, hkv, page, p, pps,
      n_split, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  paged_merge_kernel<T, G, D><<<b * hkv, PA_THREADS, 0, st>>>(
      (const float*)ml, (const float*)acc, (T*)out, n_split);
  return (int)cudaGetLastError();
}

template <typename T, int D>
static int launch_d(int g, dim3 grid, cudaStream_t st, const void* q,
                    const void* k, const void* v, const void* tables,
                    const void* lengths, void* out, void* ml, void* acc,
                    int b, int hkv, int page, int p, int pps, int n_split,
                    float scale) {
  // the GQA groups of the reference's configs: musicgen and minicpm3 1,
  // qwen3-1.7b 2, llava 4, llama4-scout 5, qwen1.5-110b 8, llama3-405b
  // and qwen3-moe 16 (kernel.py's GROUPS)
#define PA_CASE(GG)                                                        \
  case GG:                                                                 \
    return launch_gd<T, GG, D>(                                            \
        grid, (pa_head_floats(GG, D)) * 4 + PA_STAGES * 2 * page * D *     \
                                                (int)sizeof(T),            \
        st, q, k, v, tables, lengths, out, ml, acc, b, hkv, page, p, pps,  \
        n_split, scale);
  switch (g) {
    PA_CASE(1)
    PA_CASE(2)
    PA_CASE(4)
    PA_CASE(5)
    PA_CASE(8)
    PA_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PA_CASE
}

// is_bf16: 1 for bfloat16 tensors, 0 for float32. ml [B * Hkv * n_split *
// G * 2] and acc [B * Hkv * n_split * G * D] are f32 scratch; split s owns
// table entries [s * pps, (s + 1) * pps), pps = ceil(P / n_split). The
// wrapper checks the shapes; the checks here refuse what the kernel cannot
// take: D 16, 32, 64 or 128, a page of 1..32 tokens, at most PA_MAX_PPS
// entries a split, G in (1, 2, 4, 5, 8, 16).
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool, const void* tables,
                                      const void* lengths, void* out,
                                      void* ml, void* acc, int b, int hkv,
                                      int g, int d, int page, int p,
                                      int n_split, int is_bf16, float scale,
                                      void* stream) {
  if (b == 0 || hkv == 0) return 0;
  if (page < 1 || page > PA_MAX_PAGE || n_split < 1 || p < 0)
    return (int)cudaErrorInvalidValue;
  const int pps = (p + n_split - 1) / n_split;
  if (pps > PA_MAX_PPS) return (int)cudaErrorInvalidValue;
  dim3 grid(b * hkv * n_split);
  cudaStream_t st = (cudaStream_t)stream;
#define PA_ARGS                                                          \
  g, grid, st, q, k_pool, v_pool, tables, lengths, out, ml, acc, b, hkv, \
      page, p, pps, n_split, scale
#define PA_D(DD)                                          \
  if (d == DD)                                            \
    return is_bf16 ? launch_d<__nv_bfloat16, DD>(PA_ARGS) \
                   : launch_d<float, DD>(PA_ARGS);
  PA_D(16)
  PA_D(32)
  PA_D(64)
  PA_D(128)
#undef PA_D
#undef PA_ARGS
  return (int)cudaErrorInvalidValue;
}
