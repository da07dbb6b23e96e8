// Causal (or full) GQA flash attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_fa_kernel` / `flash_attention_bhsd` in
// src/repro/kernels/flash_attention/kernel.py, and runs the function of
// `attend_causal(impl="xla_flash")` (src/repro/models/common.py:107,
// `_attend_flash_xla`), which names that kernel as its true form:
//
//   q   [B, Sq, H, D]     k, v [B, Sk, Hkv, D]   (kv head of q head h: h / G)
//   out [B, Sq, H, D]     float or bf16; inputs float or bf16
//
// Query row i sits at position i + q_offset; key j is allowed when
// (!causal || j <= i + q_offset) && (window <= 0 || j > i + q_offset -
// window). Allowed scores are q.k * scale, disallowed ones -1e30, keys
// past Sk do not exist (-inf: no weight). Online softmax in f32 with
// m0 = -1e30, l0 = 0; the result is acc / max(l, 1e-30).
//
// Two modes:
//  0 "xla_flash", the model path: q, k, p and v rounded to bf16 (round to
//    nearest even), products summed in f32, l summed from the unrounded
//    f32 p, as `_attend_flash_xla` does. The reference's tiles are 512
//    keys and p is rounded after subtracting its tile's running max, so
//    the 64-key tiles here round p at other points: the result agrees
//    with the plain mirror to bf16 level, not bit for bit.
//  1 "f32": the `flash_attention` op's contract, every product and sum
//    in f32 (no tensor cores).
//
// Design, mode 0: one block of 4 warps per (batch, head, 64-query tile);
// each warp owns 16 query rows and runs the FlashAttention-2 loop with
// `mma.sync.m16n8k16` bf16 tensor-core products and f32 accumulators in
// registers: its q rows are A fragments loaded once, each 64-key tile of
// K (row-major) and V (transposed) is staged in shared memory (rows
// padded by 8 elements so the fragment loads hit 32 distinct banks), S =
// Q.K^T comes out in C fragments whose rows are spread over a quad of
// lanes (row max and sum by two shuffles), and P is repacked in
// registers as the A fragments of P.V. Key tiles wholly past the causal
// limit or before the window of every row of the q tile are skipped;
// inside a tile each element is masked. Query tiles are launched from
// the last (the longest causal rows) to the first.
//
// Mode 1: one warp per query row (8 a block), the lanes splitting D;
// keys walked one at a time over the allowed range with a per-key
// online softmax, K and V read through L1/L2. Its callers are the
// op's test shapes, not the model.
//
// Bound: 4 * D flops per allowed (q, k) pair of every head over the bf16
// tensor-core peak, against the bytes of q, k, v and out once. At the
// served prefill (B 8, S 4,096, H 25, Hkv 5, D 64) the flops bound it.
// Double-buffered cp.async / TMA staging, ldmatrix fragment loads and
// wgmma are the next steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FA_BQ 64
#define FA_BK 64
#define FA_WARPS 4
#define FA_NEG -1e30f
#define FA_ROWS_F32 8

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_one(float* p, float a) { *p = a; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float a) {
  *p = __float2bfloat16(a);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two consecutive elements as a packed bf16 pair (lower address low)
__device__ __forceinline__ uint32_t load_pair(const float* p) {
  float2 v = *reinterpret_cast<const float2*>(p);
  return pack_bf16(v.x, v.y);
}
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// eight consecutive elements rounded to bf16
__device__ __forceinline__ void load8(const float* p, __nv_bfloat16* out) {
  float4 a = *reinterpret_cast<const float4*>(p);
  float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = __float2bfloat16(a.x);
  out[1] = __float2bfloat16(a.y);
  out[2] = __float2bfloat16(a.z);
  out[3] = __float2bfloat16(a.w);
  out[4] = __float2bfloat16(b.x);
  out[5] = __float2bfloat16(b.y);
  out[6] = __float2bfloat16(b.z);
  out[7] = __float2bfloat16(b.w);
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      __nv_bfloat16* out) {
  *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ bool allowed(int qpos, int key, int causal,
                                        int window) {
  return (!causal || key <= qpos) && (window <= 0 || key > qpos - window);
}

// The key range [lo, hi] some row of positions [p0, p1] may attend to.
__device__ __forceinline__ void key_range(int p0, int p1, int sk, int causal,
                                          int window, int* lo, int* hi) {
  *hi = causal ? min(sk - 1, p1) : sk - 1;
  *lo = window > 0 ? max(0, p0 - window + 1) : 0;
}

template <typename TI, typename TO, int D>
__global__ void __launch_bounds__(FA_WARPS * 32) flash_mma_kernel(
    const TI* __restrict__ q, const TI* __restrict__ k,
    const TI* __restrict__ v, TO* __restrict__ out, int sq, int sk, int h,
    int hkv, int q_offset, int window, int causal, float scale) {
  constexpr int KS = D + 8;           // padded row of the K tile
  constexpr int VS = FA_BK + 8;       // padded row of the V^T tile
  constexpr int DK = D / 16;          // k-steps of Q.K^T
  constexpr int NK = FA_BK / 8;       // n-tiles of S (keys)
  constexpr int ND = D / 8;           // n-tiles of O (dims)
  __shared__ __align__(16) __nv_bfloat16 ks[FA_BK * KS];
  __shared__ __align__(16) __nv_bfloat16 vt[D * VS];

  const int n_qt = (sq + FA_BQ - 1) / FA_BQ;
  const int qt = n_qt - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int bb = bh / h, hh = bh % h;
  const int hk = hh / (h / hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = qt * FA_BQ;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;    // this thread's rows
  const size_t qrow = (size_t)h * D, krow = (size_t)hkv * D;

  // q rows as A fragments (zeros past Sq)
  uint32_t qa[DK][4];
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) {
    const int c = kk * 16 + 2 * t4;
    const TI* p0 = q + ((size_t)bb * sq + r0) * qrow + (size_t)hh * D + c;
    const TI* p1 = q + ((size_t)bb * sq + r1) * qrow + (size_t)hh * D + c;
    qa[kk][0] = r0 < sq ? load_pair(p0) : 0u;
    qa[kk][1] = r1 < sq ? load_pair(p1) : 0u;
    qa[kk][2] = r0 < sq ? load_pair(p0 + 8) : 0u;
    qa[kk][3] = r1 < sq ? load_pair(p1 + 8) : 0u;
  }
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {FA_NEG, FA_NEG}, l[2] = {0.f, 0.f};

  int lo, hi;
  key_range(q0 + q_offset, min(q0 + FA_BQ, sq) - 1 + q_offset, sk, causal,
            window, &lo, &hi);
  const TI* kb = k + (size_t)bb * sk * krow + (size_t)hk * D;
  const TI* vb = v + (size_t)bb * sk * krow + (size_t)hk * D;
  const int pos0 = r0 + q_offset, pos1 = r1 + q_offset;

  for (int kt = lo / FA_BK; hi >= lo && kt <= hi / FA_BK; ++kt) {
    const int k0 = kt * FA_BK;
    __syncthreads();                  // the last tile's reads are done
    // K rows, 8 elements a thread per step; V the same, transposed, with
    // consecutive threads on consecutive keys
    for (int e = threadIdx.x; e < FA_BK * D / 8; e += FA_WARPS * 32) {
      const int key = e / (D / 8), c = (e % (D / 8)) * 8;
      __nv_bfloat16 tmp[8];
      if (k0 + key < sk) {
        load8(kb + (size_t)(k0 + key) * krow + c, tmp);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) tmp[i] = __float2bfloat16(0.f);
      }
      *reinterpret_cast<uint4*>(&ks[key * KS + c]) =
          *reinterpret_cast<uint4*>(tmp);
    }
    for (int e = threadIdx.x; e < FA_BK * D / 8; e += FA_WARPS * 32) {
      const int key = e % FA_BK, c = (e / FA_BK) * 8;
      __nv_bfloat16 tmp[8];
      if (k0 + key < sk) {
        load8(vb + (size_t)(k0 + key) * krow + c, tmp);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) tmp[i] = __float2bfloat16(0.f);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) vt[(c + i) * VS + key] = tmp[i];
    }
    __syncthreads();

    // S = Q.K^T for this warp's 16 rows and the tile's 64 keys
    float s[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kr = &ks[(j * 8 + g) * KS + 2 * t4];
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8);
        mma_bf16(s[j], qa[kk], b0, b1);
      }
    }
    // scale, mask, and the rows' maxima
    float mx[2] = {FA_NEG, FA_NEG};
#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t4 + (e & 1);
        const int pos = e < 2 ? pos0 : pos1;
        float x = s[j][e] * scale;
        if (key >= sk) {
          x = -INFINITY;
        } else if (!allowed(pos, key, causal, window)) {
          x = FA_NEG;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - mn);
      m[r] = mn;
    }
    // p = exp(s - m) in f32 (l sums these), rounded to bf16 for P.V
    uint32_t pa[NK / 2][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
      pa[j / 2][(j & 1) * 2 + 0] = pack_bf16(s[j][0], s[j][1]);
      pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(s[j][2], s[j][3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
    // O = O * alpha + P.V
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
      const __nv_bfloat16* vr = &vt[(j * 8 + g) * VS + 2 * t4];
#pragma unroll
      for (int kk = 0; kk < NK / 2; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(vr + kk * 16);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(vr + kk * 16 + 8);
        mma_bf16(o[j], pa[kk], b0, b1);
      }
    }
  }

  const float inv0 = 1.f / fmaxf(l[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l[1], 1e-30f);
  TO* ob = out + (size_t)hh * D + 2 * t4;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    if (r0 < sq)
      store_pair(ob + ((size_t)bb * sq + r0) * qrow + j * 8,
                 o[j][0] * inv0, o[j][1] * inv0);
    if (r1 < sq)
      store_pair(ob + ((size_t)bb * sq + r1) * qrow + j * 8,
                 o[j][2] * inv1, o[j][3] * inv1);
  }
}

// Mode 1: one warp per query row, f32 throughout; D a multiple of 32, at
// most 128 (each lane holds D / 32 dimensions).
template <typename TI, typename TO, int DL>
__global__ void __launch_bounds__(FA_ROWS_F32 * 32) flash_f32_kernel(
    const TI* __restrict__ q, const TI* __restrict__ k,
    const TI* __restrict__ v, TO* __restrict__ out, int sq, int sk, int h,
    int hkv, int q_offset, int window, int causal, float scale) {
  constexpr int D = DL * 32;
  const int row = blockIdx.x * FA_ROWS_F32 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bb = blockIdx.y / h, hh = blockIdx.y % h;
  const int hk = hh / (h / hkv);
  if (row >= sq) return;
  const size_t qrow = (size_t)h * D, krow = (size_t)hkv * D;
  const TI* qp = q + ((size_t)bb * sq + row) * qrow + (size_t)hh * D + lane;
  float qv[DL], acc[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) {
    qv[i] = to_f(qp[i * 32]);
    acc[i] = 0.f;
  }
  float m = FA_NEG, l = 0.f;
  const int pos = row + q_offset;
  int lo, hi;
  key_range(pos, pos, sk, causal, window, &lo, &hi);
  const TI* kb = k + (size_t)bb * sk * krow + (size_t)hk * D + lane;
  const TI* vb = v + (size_t)bb * sk * krow + (size_t)hk * D + lane;
  for (int key = lo; key <= hi; ++key) {
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i)
      dot = fmaf(qv[i], to_f(kb[(size_t)key * krow + i * 32]), dot);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    const float x = dot * scale;
    const float mn = fmaxf(m, x);
    const float alpha = expf(m - mn), p = expf(x - mn);
    l = l * alpha + p;
#pragma unroll
    for (int i = 0; i < DL; ++i)
      acc[i] = fmaf(acc[i], alpha, p * to_f(vb[(size_t)key * krow + i * 32]));
    m = mn;
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  TO* op = out + ((size_t)bb * sq + row) * qrow + (size_t)hh * D + lane;
#pragma unroll
  for (int i = 0; i < DL; ++i) store_one(op + i * 32, acc[i] * inv);
}

template <typename TI, typename TO>
static int launch_typed(int mode, const void* q, const void* k,
                        const void* v, void* out, int b, int sq, int sk,
                        int h, int hkv, int d, int q_offset, int window,
                        int causal, float scale, cudaStream_t st) {
  const TI* qi = (const TI*)q;
  const TI* ki = (const TI*)k;
  const TI* vi = (const TI*)v;
  TO* o = (TO*)out;
  if (mode == 0) {
    dim3 grid((sq + FA_BQ - 1) / FA_BQ, b * h);
    if (d == 64)
      flash_mma_kernel<TI, TO, 64><<<grid, FA_WARPS * 32, 0, st>>>(
          qi, ki, vi, o, sq, sk, h, hkv, q_offset, window, causal, scale);
    else if (d == 128)
      flash_mma_kernel<TI, TO, 128><<<grid, FA_WARPS * 32, 0, st>>>(
          qi, ki, vi, o, sq, sk, h, hkv, q_offset, window, causal, scale);
    else
      return (int)cudaErrorInvalidValue;
  } else {
    dim3 grid((sq + FA_ROWS_F32 - 1) / FA_ROWS_F32, b * h);
#define FA_F32_CASE(DL)                                                   \
  case DL * 32:                                                           \
    flash_f32_kernel<TI, TO, DL><<<grid, FA_ROWS_F32 * 32, 0, st>>>(      \
        qi, ki, vi, o, sq, sk, h, hkv, q_offset, window, causal, scale);  \
    break;
    switch (d) {
      FA_F32_CASE(1)
      FA_F32_CASE(2)
      FA_F32_CASE(3)
      FA_F32_CASE(4)
      default:
        return (int)cudaErrorInvalidValue;
    }
#undef FA_F32_CASE
  }
  return (int)cudaGetLastError();
}

// mode: 0 xla_flash (bf16 operands, tensor cores; D 64 or 128), 1 f32 (D
// a multiple of 32 up to 128). in_bf16 / out_bf16: 1 for bfloat16
// tensors, 0 for float32. H must be a multiple of Hkv; the wrapper checks
// the shapes and the 16-byte alignment of q, k, v and out.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int b, int sq,
                                      int sk, int h, int hkv, int d,
                                      int q_offset, int window, int causal,
                                      int mode, int in_bf16, int out_bf16,
                                      float scale, void* stream) {
  if (b == 0 || sq == 0 || h == 0) return 0;
  if (hkv <= 0 || h % hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (in_bf16 && out_bf16)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(
        mode, q, k, v, out, b, sq, sk, h, hkv, d, q_offset, window, causal,
        scale, st);
  if (in_bf16)
    return launch_typed<__nv_bfloat16, float>(mode, q, k, v, out, b, sq, sk,
                                              h, hkv, d, q_offset, window,
                                              causal, scale, st);
  if (out_bf16)
    return launch_typed<float, __nv_bfloat16>(mode, q, k, v, out, b, sq, sk,
                                              h, hkv, d, q_offset, window,
                                              causal, scale, st);
  return launch_typed<float, float>(mode, q, k, v, out, b, sq, sk, h, hkv, d,
                                    q_offset, window, causal, scale, st);
}
