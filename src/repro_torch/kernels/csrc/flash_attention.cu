// Causal (or full) GQA flash attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_fa_kernel` / `flash_attention_bhsd`
// (src/repro/kernels/flash_attention/kernel.py:67, `pallas_call` at line
// 83), and runs the function of `attend_causal(impl="xla_flash")`
// (src/repro/models/common.py:107, `_attend_flash_xla`), which names that
// kernel as its true form:
//
//   q   [B, Sq, H, D]     k, v [B, Sk, Hkv, D]   (kv head of q head h: h / G)
//   out [B, Sq, H, D]     float or bf16
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
//    f32 p, as `_attend_flash_xla` does; p is rounded after its 64-key
//    tile's running max (`TILE` in kernel.py). The reference's tiles are
//    512 keys, so the result agrees with the plain mirror at 512 keys to
//    bf16 level, and with the mirror at 64 keys up to f32 noise that tips
//    a p across a bf16 rounding tie. The kernel takes bf16 q, k, v (the
//    wrapper rounds f32 inputs with the same round to nearest even).
//  1 "f32": the `flash_attention` op's contract, every product and sum
//    in f32 (no tensor cores).
//
// Bound, mode 0: 4 * D flops per allowed (q, k) pair of every head over
// the dense bf16 tensor-core peak (`wgmma`), against the bytes of q, k, v
// and out once. At the served prefill (B 8, S 4,096, H 25, Hkv 5, D 64)
// the flops bound it; at D 64 the softmax's exps (one per pair, on the
// SFU) cost about as much as the two products, so the design keeps both
// pipes busy at once.
//
// Design, mode 0 (the FlashAttention-3 shape): one block per (batch,
// head, query tile) with one producer warp and WG consumer warpgroups of
// 64 query rows each (WG = 3 at D 64, a 192-row tile: every K/V tile is
// read from L2 once for 192 rows; 2 at D 128, where three do not fit the
// registers). The producer issues every load with TMA
// (`cp.async.bulk.tensor`, rank-4 tensor maps over the [B, S, heads, D]
// layout as it lies, 64 x 64 boxes, 128-byte swizzle): the block's Q
// once, then K and V tiles of 64 keys into a ring of 4 slots, each
// completing on its `full` mbarrier; a key past Sk (or a row past Sq)
// arrives as zeros. A consumer warpgroup runs S = Q.K^T as
// `wgmma.m64n64k16` with both operands read from shared memory by
// descriptor (K-major), takes the row max and sum over each quad of lanes
// (the accumulator's rows), computes p = exp2(s * scale * log2(e) - m)
// (the scale folded into one fma: p differs from exp(s * scale - m) by a
// few f32 ulps, which the check's allowance for a tipped p covers), rounds
// p to bf16 in registers as the A operand of O += P.V, a register-A
// `wgmma` that reads V from shared memory as a transposed (MN-major) B,
// so V is never transposed by a store, and arrives on the slot's `empty`
// mbarrier once P.V is done so the producer refills it. The loop is
// software-pipelined: S of tile i is issued before P.V of tile i - 1, so
// the softmax of tile i runs while the tensor cores do P.V. Only tiles
// that cross the causal diagonal, the window's lower edge or Sk are
// masked; a tile wholly past every row's causal limit, or wholly before
// every row's window, is skipped by the warpgroup whose 64 rows it misses,
// exactly as the plain mirror's 64-row tiles skip it (the first allowed
// key would wipe what it left with exp(-1e30 - m) = 0). Query tiles are
// launched longest first: the grid's slow axis walks them from the last.
//
// Mode 1: one warp per query row (8 a block), the lanes splitting D;
// keys walked one at a time over the allowed range with a per-key
// online softmax, K and V read through L1/L2. Its callers are the
// op's test shapes, not the model.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FA_BK 64                   // keys of a tile
#define FA_CHUNK (64 * 64 * 2)     // one 64 x 64 bf16 box: 8 KB
#define FA_NEG -1e30f
#define FA_ROWS_F32 8

// A block: WG consumer warpgroups of 64 query rows each (three at D 64,
// two at D 128, as many as the registers of one block an SM hold without
// spilling) and one producer warp.
template <int D>
struct FaShape {
  static constexpr int CH = D / 64;                // 64-column boxes a row
  static constexpr int TILE = CH * FA_CHUNK;       // 64 rows of q, k or v
  static constexpr int WG = D == 64 ? 3 : 2;
  static constexpr int BQ = 64 * WG;               // query rows of a block
  static constexpr int CONSUMERS = 128 * WG;
  static constexpr int THREADS = CONSUMERS + 32;
  static constexpr int STAGES = 4;                 // K/V ring slots
  // Q of every warpgroup, the ring, and 1 KB to align the base
  static constexpr int SMEM = WG * TILE + STAGES * 2 * TILE + 1024;
};

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

// --- shared-memory barriers, TMA and wgmma (PTX) --------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}
// one 64 x 64 box of a rank-4 map at (c0, c1, c2, c3), innermost first
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A shared-memory matrix descriptor of a 128-byte-swizzled tile (rows of
// 128 bytes, 8-row groups 1,024 bytes apart; the tile 1,024-byte aligned).
// Both byte offsets are 1,024: for a K-major operand the leading offset is
// unused and the stride offset steps 8 rows; for the MN-major V with N = 64
// (one swizzle span) the stride offset steps 8 keys and the leading offset
// is unused.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or reuses of a register across the
// asynchronous product that owns it
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
template <int N>
__device__ __forceinline__ void fence_all(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) reg_fence(r[i]);
}
template <int N, int M>
__device__ __forceinline__ void fence_all(float (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_all(r[i]);
}
template <int N, int M>
__device__ __forceinline__ void fence_all(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) reg_fence(r[i][j]);
}
// 2^x on the SFU; a result below 2^-126 flushes to 0 (such a p weighs
// nothing an f32 output can show)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

#define FA_D32(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])
#define FA_R32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FA_D32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}
// d[64 x 64] += A[64 x 16] . B[16 x 64], A in registers (the m16n8k16 A
// fragment of each warp's 16 rows), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// --- mode 0 ----------------------------------------------------------------

// What a thread's two rows need to mask a tile: their positions, the
// thread's first column in each 8-key group, and the scale in the exp2
// domain (scale * log2(e)).
struct FaRows {
  int pos0, pos1, col, sk, causal, window;
  float scale_log2;
};

// S = Q.K^T of one tile (Q of the group and K in 128-byte-swizzled boxes
// of 64 columns; k-step kk is 16 columns: 32 bytes into box kk / 4)
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[32], uint32_t qw,
                                         uint32_t ks) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * FA_CHUNK + (kk % 4) * 32;
    wgmma_ss(sc, sw128_desc(qw + off), sw128_desc(ks + off), kk > 0);
  }
}

// O += P.V (k-step kk is keys 16kk..16kk+15: 16 rows of 128 bytes into
// each 64-column box of V)
template <int CH>
__device__ __forceinline__ void issue_pv(float (&o)[CH][32],
                                         uint32_t (&pa)[4][4], uint32_t vs) {
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(o[c], pa[kk], sw128_desc(vs + c * FA_CHUNK + kk * 2048));
}

// The online softmax of one tile for the thread's two rows: raw scores in,
// f32 p = exp2(s * scale * log2(e) - m) out; m and l (this thread's share
// of the row sum) updated, alpha the rescale of the earlier sum. Only an
// edge tile is masked (-1e30 disallowed, -inf past Sk); an interior tile
// takes its max on the raw scores (the scale is positive, so the scaled
// max is the max of the scaled scores) and folds the scale into one fma.
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             bool edge, int k0,
                                             const FaRows& r) {
  float mx[2];
  if (edge) {
    mx[0] = mx[1] = FA_NEG;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int key = k0 + (e / 4) * 8 + r.col + (e & 1);
      float x = sc[e] * r.scale_log2;
      if (key >= r.sk) {
        x = -INFINITY;
      } else if (!allowed((e & 2) ? r.pos1 : r.pos0, key, r.causal,
                          r.window)) {
        x = FA_NEG;
      }
      sc[e] = x;
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x);
    }
  } else {
    mx[0] = mx[1] = -INFINITY;
#pragma unroll
    for (int e = 0; e < 32; ++e)
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
    mx[0] *= r.scale_log2;
    mx[1] *= r.scale_log2;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float mn = fmaxf(m[h], mx[h]);
    alpha[h] = ex2(m[h] - mn);
    m[h] = mn;
  }
  if (edge) {
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = ex2(sc[e] - m[(e >> 1) & 1]);
  } else {
#pragma unroll
    for (int e = 0; e < 32; ++e)
      sc[e] = ex2(fmaf(sc[e], r.scale_log2, -m[(e >> 1) & 1]));
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) sum[(e >> 1) & 1] += sc[e];
  l[0] = l[0] * alpha[0] + sum[0];
  l[1] = l[1] * alpha[1] + sum[1];
}

// p rounded to bf16 as the A fragments of P.V: k-step kk covers keys
// 16kk..16kk+15, the m16n8k16 A layout of each warp's 16 rows
__device__ __forceinline__ void pack_p(const float (&p)[32],
                                       uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pa[kk][0] = pack_bf16(p[8 * kk + 0], p[8 * kk + 1]);
    pa[kk][1] = pack_bf16(p[8 * kk + 2], p[8 * kk + 3]);
    pa[kk][2] = pack_bf16(p[8 * kk + 4], p[8 * kk + 5]);
    pa[kk][3] = pack_bf16(p[8 * kk + 6], p[8 * kk + 7]);
  }
}


template <typename TO, int D>
__global__ void __launch_bounds__(FaShape<D>::THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       TO* __restrict__ out, int sq, int sk, int h, int hkv,
                       int q_offset, int window, int causal,
                       float scale_log2) {
  using S = FaShape<D>;
  __shared__ __align__(8) uint64_t full_bar[S::STAGES];
  __shared__ __align__(8) uint64_t empty_bar[S::STAGES];
  __shared__ __align__(8) uint64_t q_bar;
  extern __shared__ uint8_t fa_smem[];
  const uint32_t q_s = (smem_u32(fa_smem) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + S::WG * S::TILE;   // slot s: K, then V

  const int bh = blockIdx.x;
  const int bb = bh / h, hh = bh % h, hk = hh / (h / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * S::BQ;
  int lo, hi;
  key_range(q0 + q_offset, min(q0 + S::BQ, sq) - 1 + q_offset, sk, causal,
            window, &lo, &hi);
  const int kt0 = lo / FA_BK;
  const int n_kt = hi >= lo ? hi / FA_BK - kt0 + 1 : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], S::CONSUMERS);
    }
    mbar_init(&q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= S::CONSUMERS) {
    // the producer: one thread keeps the ring full
    if (threadIdx.x == S::CONSUMERS) {
      mbar_expect_tx(&q_bar, S::WG * S::TILE);
      for (int w = 0; w < S::WG; ++w)
        for (int c = 0; c < S::CH; ++c)
          tma_load(q_s + w * S::TILE + c * FA_CHUNK, &tq, &q_bar, c * 64, hh,
                   q0 + 64 * w, bb);
      for (int i = 0; i < n_kt; ++i) {
        const int s = i % S::STAGES;
        mbar_wait(&empty_bar[s], ((i / S::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full_bar[s], 2 * S::TILE);
        const uint32_t ks = kv_s + s * 2 * S::TILE;
        const int k0 = (kt0 + i) * FA_BK;
        for (int c = 0; c < S::CH; ++c) {
          tma_load(ks + c * FA_CHUNK, &tk, &full_bar[s], c * 64, hk, k0, bb);
          tma_load(ks + S::TILE + c * FA_CHUNK, &tv, &full_bar[s], c * 64,
                   hk, k0, bb);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: 64 query rows; each thread holds rows r0 and r1
  // (the accumulator's layout: warp w of the group has rows 16w..16w+15,
  // lane l rows l/4 and l/4 + 8, columns 8j + 2(l%4) + {0, 1})
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, t4 = lane % 4;
  const int rw0 = q0 + 64 * wg;                 // the group's first row
  const int pf = rw0 + q_offset;
  const int pl = min(rw0 + 63, sq - 1) + q_offset;
  const int r0 = rw0 + warp * 16 + lane / 4, r1 = r0 + 8;
  const uint32_t qw = q_s + wg * S::TILE;
  const FaRows rows{r0 + q_offset, r1 + q_offset, 2 * t4, sk, causal,
                    window, scale_log2};

  // the group's own tiles [w0, w1): the block's tiles wholly past its
  // rows' causal limit or before their window (only at the two ends) are
  // skipped, as the plain mirror's 64-row tiles skip them
  auto outside = [&](int i) {
    const int k0 = (kt0 + i) * FA_BK;
    return (causal && k0 > pl) ||
           (window > 0 && min(k0 + FA_BK, sk) - 1 <= pf - window);
  };
  // a tile that crosses Sk, the causal diagonal or the window's lower edge
  auto edge = [&](int i) {
    const int k0 = (kt0 + i) * FA_BK;
    return k0 + FA_BK > sk || (causal && k0 + FA_BK - 1 > pf) ||
           (window > 0 && k0 <= pl - window);
  };
  auto k_slot = [&](int i) { return kv_s + (i % S::STAGES) * 2 * S::TILE; };
  int w0 = 0, w1 = rw0 < sq ? n_kt : 0;
  while (w0 < w1 && outside(w0)) ++w0;
  while (w1 > w0 && outside(w1 - 1)) --w1;

  float o[S::CH][32];
#pragma unroll
  for (int c = 0; c < S::CH; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[c][e] = 0.f;
  float m[2] = {FA_NEG, FA_NEG}, l[2] = {0.f, 0.f};

  mbar_wait(&q_bar, 0);
  for (int i = 0; i < w0; ++i) {
    mbar_wait(&full_bar[i % S::STAGES], (i / S::STAGES) & 1);
    mbar_arrive(&empty_bar[i % S::STAGES]);
  }
  if (w0 < w1) {
    // software pipeline: S of tile i is issued before P.V of tile i - 1,
    // so the tile's softmax runs while the tensor cores do P.V
    float sc[32], alpha[2];
    uint32_t pa[4][4];
    mbar_wait(&full_bar[w0 % S::STAGES], (w0 / S::STAGES) & 1);
    __syncwarp();
    wgmma_fence();
    issue_qk<D>(sc, qw, k_slot(w0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(sc);
    softmax_tile(sc, m, l, alpha, edge(w0), (kt0 + w0) * FA_BK, rows);
    pack_p(sc, pa);
    for (int i = w0 + 1; i < w1; ++i) {
      mbar_wait(&full_bar[i % S::STAGES], (i / S::STAGES) & 1);
      __syncwarp();
      wgmma_fence();
      issue_qk<D>(sc, qw, k_slot(i));
      wgmma_commit();
      issue_pv(o, pa, k_slot(i - 1) + S::TILE);
      wgmma_commit();
      wgmma_wait<1>();
      fence_all(sc);
      softmax_tile(sc, m, l, alpha, edge(i), (kt0 + i) * FA_BK, rows);
      wgmma_wait<0>();
      fence_all(o);
      fence_all(pa);
      mbar_arrive(&empty_bar[(i - 1) % S::STAGES]);
#pragma unroll
      for (int c = 0; c < S::CH; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[c][e] *= alpha[(e >> 1) & 1];
      pack_p(sc, pa);
    }
    wgmma_fence();
    issue_pv(o, pa, k_slot(w1 - 1) + S::TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(o);
    fence_all(pa);
    mbar_arrive(&empty_bar[(w1 - 1) % S::STAGES]);
  }
  for (int i = w1; i < n_kt; ++i) {
    mbar_wait(&full_bar[i % S::STAGES], (i / S::STAGES) & 1);
    mbar_arrive(&empty_bar[i % S::STAGES]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv0 = 1.f / fmaxf(l[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l[1], 1e-30f);
  const size_t qrow = (size_t)h * D;
  TO* ob = out + (size_t)hh * D + 2 * t4;
#pragma unroll
  for (int c = 0; c < S::CH; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c * 64 + j * 8;
      if (r0 < sq)
        store_pair(ob + ((size_t)bb * sq + r0) * qrow + col,
                   o[c][4 * j] * inv0, o[c][4 * j + 1] * inv0);
      if (r1 < sq)
        store_pair(ob + ((size_t)bb * sq + r1) * qrow + col,
                   o[c][4 * j + 2] * inv1, o[c][4 * j + 3] * inv1);
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


// --- launch ----------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = (EncodeTiled)p;
  }
  return fn;
}

// A bf16 [B, S, heads, D] tensor as a rank-4 map (innermost first) read
// in 64-column, 64-row boxes with the 128-byte swizzle; out-of-range
// elements arrive as zeros.
static int make_map(CUtensorMap* map, const void* p, int b, int s,
                    int heads, int d) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)s * heads * d * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(p), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename TO, int D>
static int launch_wgmma(const void* q, const void* k, const void* v,
                        void* out, int b, int sq, int sk, int h, int hkv,
                        int q_offset, int window, int causal, float scale,
                        cudaStream_t st) {
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, b, sq, h, D);
  if (err == 0) err = make_map(&mk, k, b, sk, hkv, D);
  if (err == 0) err = make_map(&mv, v, b, sk, hkv, D);
  if (err != 0) return err;
  const int smem = FaShape<D>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      flash_wgmma_kernel<TO, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(b * h, (sq + FaShape<D>::BQ - 1) / FaShape<D>::BQ);
  flash_wgmma_kernel<TO, D><<<grid, FaShape<D>::THREADS, smem, st>>>(
      mq, mk, mv, (TO*)out, sq, sk, h, hkv, q_offset, window, causal,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <typename TI, typename TO>
static int launch_f32(const void* q, const void* k, const void* v,
                      void* out, int b, int sq, int sk, int h, int hkv,
                      int d, int q_offset, int window, int causal,
                      float scale, cudaStream_t st) {
  const TI* qi = (const TI*)q;
  const TI* ki = (const TI*)k;
  const TI* vi = (const TI*)v;
  TO* o = (TO*)out;
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
  return (int)cudaGetLastError();
}

// mode: 0 xla_flash (bf16 q, k, v only, D 64 or 128: the wrapper rounds
// f32 inputs to bf16), 1 f32 (D a multiple of 32 up to 128). in_bf16 /
// out_bf16: 1 for bfloat16 tensors, 0 for float32. H must be a multiple of
// Hkv; the wrapper checks the shapes and the 16-byte alignment of q, k, v
// and out.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int b, int sq,
                                      int sk, int h, int hkv, int d,
                                      int q_offset, int window, int causal,
                                      int mode, int in_bf16, int out_bf16,
                                      float scale, void* stream) {
  if (b == 0 || sq == 0 || h == 0) return 0;
  if (hkv <= 0 || h % hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 0) {
    if (!in_bf16 || sk == 0) return (int)cudaErrorInvalidValue;
#define FA_WGMMA(TO)                                                     \
  (d == 64 ? launch_wgmma<TO, 64>(q, k, v, out, b, sq, sk, h, hkv,       \
                                  q_offset, window, causal, scale, st)   \
   : d == 128 ? launch_wgmma<TO, 128>(q, k, v, out, b, sq, sk, h, hkv,   \
                                      q_offset, window, causal, scale,   \
                                      st)                                \
              : (int)cudaErrorInvalidValue)
    return out_bf16 ? FA_WGMMA(__nv_bfloat16) : FA_WGMMA(float);
#undef FA_WGMMA
  }
  if (in_bf16 && out_bf16)
    return launch_f32<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, out, b, sq, sk, h, hkv, d, q_offset, window, causal, scale,
        st);
  if (in_bf16)
    return launch_f32<__nv_bfloat16, float>(q, k, v, out, b, sq, sk, h, hkv,
                                            d, q_offset, window, causal,
                                            scale, st);
  if (out_bf16)
    return launch_f32<float, __nv_bfloat16>(q, k, v, out, b, sq, sk, h, hkv,
                                            d, q_offset, window, causal,
                                            scale, st);
  return launch_f32<float, float>(q, k, v, out, b, sq, sk, h, hkv, d,
                                  q_offset, window, causal, scale, st);
}
