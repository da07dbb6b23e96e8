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
// below. At one training microbatch of hymba-1.5b (B 2, S 4,096, D 3,200,
// N 16) the saving forward's 419,430,400 exps take 0.1003 ms, its 316.7 MB
// (x, y and the saved states 104.9 MB each) 0.0945 ms; no scratch. Each
// lane walks all S steps in order, so a lane's latency a step, not the
// card's rates, sets the time; the design overlaps as much of it as it can:
//
//   * Registers hold the state: a thread owns PER consecutive states of
//     one channel (h, and A with log2(e) folded in, for the whole
//     sequence), and a group of G = N / PER consecutive lanes covers the
//     channel's N states. Blocks of SS_THREADS (128) lanes, 128 / G
//     channels a block, a grid of ceil(D / channels) x B.
//   * The host picks PER (`scan_geometry` in
//     kernels/selective_scan/kernel.py): the most states a lane (8, 4, 2
//     or 1) whose lanes still give every SM 6 warps. On the H100 (132
//     SMs):
//       hymba's prefill and decode (B 8, D 3,200, N 16): PER 8, 64
//         channels a block, 400 blocks, 51,200 lanes;
//       one training microbatch (B 2): PER 4, 32 channels a block, 200
//         blocks and 25,600 lanes (6 warps an SM), against PER 8's 100
//         blocks and 12,800 lanes (one warp a scheduler on 100 SMs). 2
//         states a lane (51,200 lanes) measured slower: each lane's step
//         costs about as much, and there are twice the steps to walk; so
//         did 64-lane blocks of PER 4 (400 blocks, 3 an SM).
//     The saving forward takes the same split as the plain one at the
//     same shape, so their y and h_last are the same bits.
//   * A whole 32-step chunk runs as straight-line code in batches of
//     SS_BATCH / PER steps (SS_BATCH elements a lane): the batch's exps
//     and loads first, then h's chain (one FMA a step) with the lanes'
//     parts of y_t, then y_t's sums over the channel's G lanes. Those run
//     as a transpose where the batch holds a multiple of G steps and G <=
//     8 (each round halves what a lane holds: G - 1 shuffles for G steps,
//     and lane g stores step g), else as a butterfly whose first lane
//     stores every step. A ragged last chunk runs step by step.
//   * One MUFU op an element: exp(dt A) = ex2.approx.ftz(dt * (A log2 e)).
//     It moves h by a few ulps against expf, and the y sum runs in another
//     order than the plain scans'; both stay within the checks.
//   * dt, B, C (shared by the block's channels) and the block's x tile are
//     staged SS_CHUNK steps at a time with cp.async into a ring of
//     SS_SLOTS buffers, two chunks ahead of the recurrence, with one block
//     barrier a chunk; a lane reads its PER states of B_t and C_t as one
//     float4 / float2 / float, x in float4s (a multiple of 4 channels a
//     block).
//   * h0, A and h_last move as contiguous float4s per lane (PER >= 4).
//
// Under autograd the forward (`h_chunks` non-null) also writes the state
// entering each window of SS_SAVE (16) steps, [B, ceil(S / SS_SAVE), D, N]
// f32, for the backward (whose window of h and exp(dt A) then fits in
// registers; see selective_scan_bwd.cu).
//
// The bf16 scan (`ssm_scan_dtype` bfloat16: `selective_scan_bf16_kernel`)
// is the reference's chunked associative scan in bf16
// (src/repro/models/ssm.py:100-111), whose rounding depends on its tree:
// a sequential bf16 scan, or an f32 one, lies further from it than its
// checks allow over a long chunk (with exp(dt A) rounded to 1 a bf16 sum
// of 256 steps drifts). So it runs that tree: a lane a (channel, state),
// the chunk's odd/even up-sweep of (a, b) pairs into bf16 levels kept in
// the lane's local memory (at most 256 pairs), then the down-sweep, each
// combine (al ar, ar bl + br) rounded to bf16 op by op as the reference's
// bf16 arithmetic rounds; the level-0 pairs (1, h) and (exp(dt A), dt B
// x) rounded to bf16 are recomputed from the staged chunk where needed.
// y sums bf16 states times C in f32; inputs and outputs stay f32.
#include "selective_scan.cuh"

template <int N, int PER>
__global__ void __launch_bounds__(SS_THREADS) selective_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ bmat, const float* __restrict__ cmat,
    const float* __restrict__ a, const float* __restrict__ h0,
    float* __restrict__ y, float* __restrict__ h_last,
    float* __restrict__ h_chunks, int s, int d) {
  constexpr int G = N / PER;                    // lanes a channel
  constexpr int CH = ss_channels<N, PER>();     // channels a block
  constexpr int STAGE = SS_CHUNK * (1 + 2 * N + CH);
  static_assert((PER == 1 || PER == 2 || PER % 4 == 0) && PER <= SS_PER &&
                    G >= 1 && G <= 32 && CH % 4 == 0,
                "lane split");
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
  const int wins = (s + SS_SAVE - 1) / SS_SAVE;   // saved states
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
    float* yg = yt + (size_t)g * d;          // step g of a transposed batch
    const int steps = min(SS_CHUNK, s - t0);
    // steps [t, t + M) in three passes, so that their latencies overlap:
    // the exps and loads, then h's chain (one FMA a step) with the lanes'
    // parts of y_t, then the sums of those parts over the channel's G
    // lanes: a transpose when M is a multiple of G (each round halves what
    // a lane holds; lane g ends with step g of each G steps and stores it),
    // else a butterfly whose first lane stores every step
    auto batch = [&](auto m, int t) {
      constexpr int M = decltype(m)::value;
      float ea[M][PER], ub[M][PER], cv[M][PER], acc[M];
#pragma unroll
      for (int k = 0; k < M; ++k) {
        const float dtt = dts[t + k];
        const float dx = dtt * xs[(t + k) * CH];
        float bv[PER];
        lds_row<PER>(bv, bs + (t + k) * N);
        lds_row<PER>(cv[k], cs + (t + k) * N);
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          ea[k][j] = ex2(dtt * av[j]);
          ub[k][j] = dx * bv[j];
        }
      }
#pragma unroll
      for (int k = 0; k < M; ++k) {
        acc[k] = 0.f;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          h[j] = fmaf(ea[k][j], h[j], ub[k][j]);
          acc[k] = fmaf(h[j], cv[k][j], acc[k]);
        }
      }
      if constexpr (G > 1 && G <= 8 && M % G == 0) {
#pragma unroll
        for (int q = 0; q < M; q += G) {
#pragma unroll
          for (int half = G / 2; half > 0; half /= 2) {
            const bool hi = g & half;
#pragma unroll
            for (int i = 0; i < half; ++i) {
              const float send = hi ? acc[q + i] : acc[q + i + half];
              acc[q + i] = (hi ? acc[q + i + half] : acc[q + i]) +
                           __shfl_xor_sync(0xffffffffu, send, half);
            }
          }
          if (live) yg[(size_t)(t + q) * d] = acc[q];
        }
      } else {
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1)
#pragma unroll
          for (int k = 0; k < M; ++k)
            acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], o);
        if (g == 0 && live) {
#pragma unroll
          for (int k = 0; k < M; ++k) yt[(size_t)(t + k) * d] = acc[k];
        }
      }
    };
    // the state entering each window of SS_SAVE steps is saved first
    auto save = [&](int lo) {
      if (h_chunks != nullptr && live) {
        float* hc = h_chunks + (((size_t)b * wins + (t0 + lo) / SS_SAVE) * d +
                                chan) * N + g * PER;
#pragma unroll
        for (int j = 0; j < PER; ++j) hc[j] = h[j];
      }
    };
    if (steps == SS_CHUNK) {        // straight-line code, SS_BATCH elements
      constexpr int M = SS_BATCH / PER;           // a batch a time
#pragma unroll
      for (int tb = 0; tb < SS_CHUNK; tb += M) {
        if (tb % SS_SAVE == 0) save(tb);
        batch(std::integral_constant<int, M>{}, tb);
      }
    } else {
#pragma unroll 1
      for (int t = 0; t < steps; ++t) {
        if (t % SS_SAVE == 0) save(t);
        batch(std::integral_constant<int, 1>{}, t);
      }
    }
  }
  if (!live) return;
  float* out = h_last + st;
  if constexpr (PER % 4 == 0) {
    if (aligned16(h_last)) {
#pragma unroll
      for (int j = 0; j < PER; j += 4)
        *reinterpret_cast<float4*>(out + j) =
            make_float4(h[j], h[j + 1], h[j + 2], h[j + 3]);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) out[j] = h[j];
}

template <int N, int PER>
static int ss_launch(int b, cudaStream_t st, const void* x, const void* dt,
                     const void* bmat, const void* cmat, const void* a,
                     const void* h0, void* y, void* h_last, void* h_chunks,
                     int s, int d) {
  constexpr size_t smem = ss_smem_bytes<N, PER>();
  static const cudaError_t attr =
      ss_attrs(selective_scan_kernel<N, PER>, smem);
  if (attr != cudaSuccess) return (int)attr;
  constexpr int ch = ss_channels<N, PER>();
  dim3 grid((d + ch - 1) / ch, b);
  selective_scan_kernel<N, PER><<<grid, SS_THREADS, smem, st>>>(
      (const float*)x, (const float*)dt, (const float*)bmat,
      (const float*)cmat, (const float*)a, (const float*)h0, (float*)y,
      (float*)h_last, (float*)h_chunks, s, d);
  return (int)cudaGetLastError();
}

// The f32 scan at state size N with `per` states a lane: the instances
// (N, per) with per in 1, 2, 4, 8, per <= N and N / per <= 32.
template <int N>
static int ss_launch_per(int per, int b, cudaStream_t st, const void* x,
                         const void* dt, const void* bmat, const void* cmat,
                         const void* a, const void* h0, void* y,
                         void* h_last, void* h_chunks, int s, int d) {
#define SS_PER_CASE(PP)                                                      \
  case PP:                                                                   \
    if constexpr (PP <= N && N / PP <= 32)                                   \
      return ss_launch<N, PP>(b, st, x, dt, bmat, cmat, a, h0, y, h_last,    \
                              h_chunks, s, d);                               \
    return (int)cudaErrorInvalidValue;
  switch (per) {
    SS_PER_CASE(1)
    SS_PER_CASE(2)
    SS_PER_CASE(4)
    SS_PER_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SS_PER_CASE
}

// ---------------------------------------------------------------------------
// the bf16 scan: the reference's associative scan, chunk by chunk
// ---------------------------------------------------------------------------

#define SS_BF_MAX_CHUNK 256      // steps of a chunk, at most
#define SS_BF_MAX_LEVELS 10      // levels of its tree, 257 pairs at most

__device__ __forceinline__ unsigned short bf_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float bf_val(unsigned short u) {
  return __bfloat162float(__ushort_as_bfloat16(u));
}

template <int N>
__host__ __device__ constexpr size_t ss_bf_smem_bytes() {
  return sizeof(float) * SS_BF_MAX_CHUNK *
         (1 + 2 * N + SS_THREADS / N);
}

// One lane a (channel, state); the channel's N lanes are consecutive and
// sum y_t by shuffles. Chunks of L = min(scan chunk, S) steps, the last
// padded with (1, 0) pairs as the reference pads dt with 0. Level 0 of a
// chunk is (1, h) then the L steps' (bf16 exp(dt A), bf16 ((dt B) x));
// level k + 1 holds combine(level k [2i], level k [2i + 1]); the down-
// sweep gives position 2i + 1 of level k the result i of level k + 1 and
// position 2i + 2 combine(result i, level k [2i + 2]), in place (only the
// b half of a result is needed: a result is only ever a left operand).
template <int N>
__global__ void __launch_bounds__(SS_THREADS) selective_scan_bf16_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ bmat, const float* __restrict__ cmat,
    const float* __restrict__ a, const float* __restrict__ h0,
    float* __restrict__ y, float* __restrict__ h_last, int s, int d,
    int L) {
  constexpr int CH = SS_THREADS / N;          // channels a block
  extern __shared__ __align__(16) float smem[];
  float* dts = smem;                          // [L]
  float* bs = dts + SS_BF_MAX_CHUNK;          // [L][N]
  float* cs = bs + SS_BF_MAX_CHUNK * N;       // [L][N]
  float* xs = cs + SS_BF_MAX_CHUNK * N;       // [L][CH]
  const int b = blockIdx.y, d0 = blockIdx.x * CH;
  const int c = threadIdx.x / N, nn = threadIdx.x % N;
  const int chan = d0 + c;
  const bool live = chan < d;
  const float av = live ? a[(size_t)chan * N + nn] : 0.f;
  float h = live && h0 != nullptr ? bf(h0[((size_t)b * d + chan) * N + nn])
                                  : 0.f;
  unsigned short la[SS_BF_MAX_CHUNK], lb[SS_BF_MAX_CHUNK];
  int off[SS_BF_MAX_LEVELS], cnt[SS_BF_MAX_LEVELS];
  int levels = 0;                             // levels above level 0
  for (int n0 = L + 1, o = 0; n0 >= 2; n0 /= 2, ++levels) {
    off[levels] = o;
    cnt[levels] = n0 / 2;
    o += n0 / 2;
  }
  for (int t0 = 0; t0 < s; t0 += L) {
    __syncthreads();          // everyone is done with the last chunk
    for (int e = threadIdx.x; e < L; e += SS_THREADS)
      dts[e] = t0 + e < s ? dt[(size_t)b * s + t0 + e] : 0.f;
    for (int e = threadIdx.x; e < L * N; e += SS_THREADS) {
      const int t = e / N;
      const size_t g = ((size_t)b * s + t0 + t) * N + e % N;
      bs[e] = t0 + t < s ? bmat[g] : 0.f;
      cs[e] = t0 + t < s ? cmat[g] : 0.f;
    }
    for (int e = threadIdx.x; e < L * CH; e += SS_THREADS) {
      const int t = e / CH, col = d0 + e % CH;
      xs[e] = t0 + t < s && col < d ? x[((size_t)b * s + t0 + t) * d + col]
                                    : 0.f;
    }
    __syncthreads();
    // level 0, position i: (1, h), then step i - 1's pair
    auto leaf_a = [&](int i) {
      return i == 0 ? 1.f : bf(expf(dts[i - 1] * av));
    };
    auto leaf_b = [&](int i) {
      return i == 0 ? h
                    : bf((dts[i - 1] * bs[(i - 1) * N + nn]) *
                         xs[(i - 1) * CH + c]);
    };
    // up-sweep
    for (int i = 0; i < cnt[0]; ++i) {
      const float al = leaf_a(2 * i), bl = leaf_b(2 * i);
      const float ar = leaf_a(2 * i + 1), br = leaf_b(2 * i + 1);
      la[i] = bf_bits(al * ar);
      lb[i] = bf_bits(bf(ar * bl) + br);
    }
    for (int k = 1; k < levels; ++k) {
      const int p = off[k - 1], q = off[k];
      for (int i = 0; i < cnt[k]; ++i) {
        const float al = bf_val(la[p + 2 * i]), bl = bf_val(lb[p + 2 * i]);
        const float ar = bf_val(la[p + 2 * i + 1]);
        const float br = bf_val(lb[p + 2 * i + 1]);
        la[q + i] = bf_bits(al * ar);
        lb[q + i] = bf_bits(bf(ar * bl) + br);
      }
    }
    // down-sweep over levels >= 1, in place (the top level is its own
    // result); level k's result at 2i + 2 reads level k's pair there
    for (int k = levels - 2; k >= 0; --k) {
      const int p = off[k], q = off[k + 1];
      for (int i = 0; 2 * i + 2 < cnt[k]; ++i) {
        const float bl = bf_val(lb[q + i]);
        const float ar = bf_val(la[p + 2 * i + 2]);
        const float br = bf_val(lb[p + 2 * i + 2]);
        lb[p + 2 * i + 2] = bf_bits(bf(ar * bl) + br);
      }
      for (int i = 0; i < cnt[k + 1]; ++i) lb[p + 2 * i + 1] = lb[q + i];
    }
    // level 0's results at positions 1..L: h after each step
    for (int j = 1; j <= L; ++j) {
      float hj;
      if (j & 1) {
        hj = bf_val(lb[(j - 1) / 2]);
      } else {
        const float bl = bf_val(lb[j / 2 - 1]);
        hj = bf(bf(leaf_a(j) * bl) + leaf_b(j));
      }
      float acc = hj * cs[(j - 1) * N + nn];
#pragma unroll
      for (int o = N / 2; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      const int t = t0 + j - 1;
      if (nn == 0 && live && t < s) y[((size_t)b * s + t) * d + chan] = acc;
      if (j == L) h = hj;           // the state carried to the next chunk
    }
  }
  if (live) h_last[((size_t)b * d + chan) * N + nn] = h;
}

template <int N>
static int ss_bf_launch(int b, cudaStream_t st, const void* x, const void* dt,
                        const void* bmat, const void* cmat, const void* a,
                        const void* h0, void* y, void* h_last, int s, int d,
                        int chunk) {
  constexpr size_t smem = ss_bf_smem_bytes<N>();
  static const cudaError_t attr = ss_attrs(selective_scan_bf16_kernel<N>,
                                           smem);
  if (attr != cudaSuccess) return (int)attr;
  constexpr int ch = SS_THREADS / N;
  dim3 grid((d + ch - 1) / ch, b);
  selective_scan_bf16_kernel<N><<<grid, SS_THREADS, smem, st>>>(
      (const float*)x, (const float*)dt, (const float*)bmat,
      (const float*)cmat, (const float*)a, (const float*)h0, (float*)y,
      (float*)h_last, s, d, s < chunk ? s : chunk);
  return (int)cudaGetLastError();
}

// h0 may be null (a zero state); h_chunks null skips the chunk states
// ([B, ceil(S / SS_SAVE), D, N] otherwise); `per` is the f32 scan's
// states a lane (`scan_geometry`); bf16_chunk 0 runs the f32 scan, > 0
// the bf16 scan of the reference's chunk of that many steps (at most
// SS_BF_MAX_CHUNK, N at most 32, no chunk states; `per` unused). Returns
// the launch's cudaGetLastError(), or cudaErrorInvalidValue for what the
// kernels are not built for.
extern "C" int selective_scan_launch(const void* x, const void* dt,
                                     const void* bmat, const void* cmat,
                                     const void* a, const void* h0, void* y,
                                     void* h_last, void* h_chunks, int b,
                                     int s, int d, int n, int per,
                                     int bf16_chunk, void* stream) {
  if (b == 0 || d == 0) return 0;
  if (bf16_chunk < 0 || bf16_chunk > SS_BF_MAX_CHUNK ||
      (bf16_chunk > 0 && (n > 32 || h_chunks != nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16_chunk > 0 && s > 0) {
    switch (n) {
      case 4: return ss_bf_launch<4>(b, st, x, dt, bmat, cmat, a, h0, y,
                                     h_last, s, d, bf16_chunk);
      case 8: return ss_bf_launch<8>(b, st, x, dt, bmat, cmat, a, h0, y,
                                     h_last, s, d, bf16_chunk);
      case 16: return ss_bf_launch<16>(b, st, x, dt, bmat, cmat, a, h0, y,
                                       h_last, s, d, bf16_chunk);
      case 32: return ss_bf_launch<32>(b, st, x, dt, bmat, cmat, a, h0, y,
                                       h_last, s, d, bf16_chunk);
      default: return (int)cudaErrorInvalidValue;
    }
  }
#define SS_CASE(NN)                                                         \
  case NN:                                                                  \
    return ss_launch_per<NN>(per, b, st, x, dt, bmat, cmat, a, h0, y,     \
                             h_last, h_chunks, s, d);
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
