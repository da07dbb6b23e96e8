// The selective scan's backward for Hopper (sm_90a): the gradient of
// `selective_scan.cu`'s f32 forward (whose header states the recurrence),
// `selective_scan_bwd_kernel`. No TPU kernel has it: the reference trains
// through its plain chunked scan and autograd. With
// g_t = dL/dh_t and the carry a_{t+1} g_{t+1}:
//
//   g_t     = C_t dy_t + exp(dt_{t+1} A) g_{t+1}   (g_{S-1} adds dh_last)
//   dx_t[d] = dt_t sum_n g_t B_t            dB_t[n] = dt_t sum_d g_t x_t
//   dC_t[n] = sum_d h_t dy_t                dt_t   += sum_{d,n} g_t (A a_t
//   dA      = sum_{b,t} g_t dt_t a_t h_{t-1}           h_{t-1} + B_t x_t)
//   dh0     = exp(dt_0 A) g_0
//
// It runs on the forward's grid and lane split. A block walks its chunks
// in reverse, staged by the same cp.async ring (plus dy); inside a chunk
// it recomputes h from the saved state with the forward's arithmetic (so
// the same bits) into a per-thread array of SS_CHUNK steps, then steps
// back through the chunk with g in registers. dx is written directly.
// dB, dC and dt sum over D: a warp reduces its channels by shuffles, the
// block its 4 warps in order through shared memory, and each block
// writes its partials; `selective_scan_bwd_reduce` then sums the blocks
// in order, and dA (kept per (b, d, n) in registers) over B. No atomics:
// two runs give the same bits. Bound: like the forward, about two exps
// an element (the recompute and the step back) over the SFU's rate, and
// x, dy, dx and the chunk states' bytes.
#include "selective_scan.cuh"

// Partials a step of the backward: dB [N], dC [N], dt.
__host__ __device__ constexpr int ss_bwd_k(int n) { return 2 * n + 1; }

// Dynamic shared memory of one backward launch: the SS_SLOTS staging
// buffers (dt, B, C, x, dy) and the warps' partials of one chunk.
template <int N>
__host__ __device__ constexpr size_t ss_bwd_smem_bytes() {
  return sizeof(float) * SS_CHUNK *
         (SS_SLOTS * (1 + 2 * N + 2 * ss_channels<N>()) +
          SS_THREADS / 32 * ss_bwd_k(N));
}

template <int N>
__global__ void __launch_bounds__(SS_THREADS) selective_scan_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ bmat, const float* __restrict__ cmat,
    const float* __restrict__ a, const float* __restrict__ h_chunks,
    const float* __restrict__ dy, const float* __restrict__ dh_last,
    float* __restrict__ dx, float* __restrict__ part,
    float* __restrict__ part_da, float* __restrict__ dh0, int s, int d) {
  constexpr int PER = N < SS_PER ? N : SS_PER;  // states a lane
  constexpr int G = N / PER;                    // lanes a channel
  constexpr int CH = ss_channels<N>();          // channels a block
  constexpr int STAGE = SS_CHUNK * (1 + 2 * N + 2 * CH);
  constexpr int W = SS_THREADS / 32;            // warps a block
  constexpr int K = ss_bwd_k(N);
  extern __shared__ __align__(16) float smem[];
  float* pw = smem + SS_SLOTS * STAGE;          // [W][SS_CHUNK][K]
  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int d0 = blk * CH;
  const int c = threadIdx.x / G, g = threadIdx.x % G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chan = d0 + c;
  const bool live = chan < d;

  // A, A log2(e), the carry exp(dt_{t+1} A) g_{t+1} (dh_last at first),
  // and this lane's sum of dA over the sequence
  float ar[PER], al2[PER], gc[PER], da[PER];
  const size_t st = ((size_t)b * d + chan) * N + g * PER;
  load_row<PER>(ar, live ? a + (size_t)chan * N + g * PER : nullptr,
                aligned16(a));
  load_row<PER>(gc, live && dh_last != nullptr ? dh_last + st : nullptr,
                aligned16(dh_last));
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    al2[j] = ar[j] * SS_LOG2E;
    da[j] = 0.f;
  }

  const bool vec_bc = aligned16(bmat) && aligned16(cmat);
  const bool vec_x = aligned16(x) && aligned16(dy) && d % 4 == 0;
  const int chunks = (s + SS_CHUNK - 1) / SS_CHUNK;
  // step i of the walk takes chunk chunks - 1 - i, from slot i % SS_SLOTS
  for (int i = 0; i < 2 && i < chunks; ++i) {
    stage_chunk<N>(smem + i * STAGE, CH, x, dt, bmat, cmat, b, s, d, d0,
                   (chunks - 1 - i) * SS_CHUNK, vec_bc, vec_x, dy);
    cp_commit();
  }
  // the state entering the chunk, then h after each of its steps
  float hs[SS_CHUNK + 1][PER];
  for (int i = 0; i < chunks; ++i) {
    const int kc = chunks - 1 - i;
    const int t0 = kc * SS_CHUNK;
    if (i + 1 < chunks)
      cp_wait<1>();
    else
      cp_wait<0>();
    // chunk kc is in for everyone, and everyone is done with the last
    // step's slot and partials
    __syncthreads();
    if (i + 2 < chunks) {
      stage_chunk<N>(smem + ((i + 2) % SS_SLOTS) * STAGE, CH, x, dt, bmat,
                     cmat, b, s, d, d0, t0 - 2 * SS_CHUNK, vec_bc, vec_x,
                     dy);
      cp_commit();
    }
    const float* dts = smem + (i % SS_SLOTS) * STAGE;
    const float* bs = dts + SS_CHUNK + g * PER;
    const float* cs = bs + SS_CHUNK * N;
    const float* xs = dts + SS_CHUNK + 2 * SS_CHUNK * N + c;
    const float* dys = xs + SS_CHUNK * CH;
    const int steps = min(SS_CHUNK, s - t0);
    {  // the forward's arithmetic from the saved state: the same bits
      float h[PER];
      load_row<PER>(h,
                    live ? h_chunks + (((size_t)b * chunks + kc) * d + chan) *
                                          N + g * PER
                         : nullptr,
                    aligned16(h_chunks));
#pragma unroll
      for (int j = 0; j < PER; ++j) hs[0][j] = h[j];
      for (int t = 0; t < steps; ++t) {
        const float dtt = dts[t];
        const float dxv = dtt * xs[t * CH];
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          h[j] = fmaf(ex2(dtt * al2[j]), h[j], dxv * bs[t * N + j]);
          hs[t + 1][j] = h[j];
        }
      }
    }
    for (int t = steps - 1; t >= 0; --t) {
      const float dtt = dts[t], xv = xs[t * CH], dyv = dys[t * CH];
      float pb[PER], pc[PER], sdx = 0.f, sdt = 0.f;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const float bv = bs[t * N + j], cv = cs[t * N + j];
        const float av = ex2(dtt * al2[j]);
        const float ah = av * hs[t][j];            // a_t h_{t-1}
        const float gr = fmaf(cv, dyv, gc[j]);      // dL/dh_t
        pb[j] = gr * dtt * xv;
        pc[j] = hs[t + 1][j] * dyv;
        sdx = fmaf(gr, bv, sdx);
        sdt = fmaf(gr, fmaf(ar[j], ah, bv * xv), sdt);
        da[j] = fmaf(gr * dtt, ah, da[j]);
        gc[j] = av * gr;
      }
      // dx over the channel's G lanes, dB and dC over the warp's
      // channels, dt over the whole warp
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
        sdx += __shfl_xor_sync(0xffffffffu, sdx, o);
      if (g == 0 && live) dx[((size_t)b * s + t0 + t) * d + chan] = sdx * dtt;
#pragma unroll
      for (int o = G; o < 32; o <<= 1) {
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          pb[j] += __shfl_xor_sync(0xffffffffu, pb[j], o);
          pc[j] += __shfl_xor_sync(0xffffffffu, pc[j], o);
        }
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1)
        sdt += __shfl_xor_sync(0xffffffffu, sdt, o);
      if (lane < G) {                         // the warp's first channel
        float* pt = pw + (warp * SS_CHUNK + t) * K;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          pt[g * PER + j] = pb[j];
          pt[N + g * PER + j] = pc[j];
        }
        if (lane == 0) pt[2 * N] = sdt;
      }
    }
    __syncthreads();     // the warps' partials of the chunk are in
    for (int e = threadIdx.x; e < steps * K; e += SS_THREADS) {
      const int t = e / K, k = e % K;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) v += pw[(w * SS_CHUNK + t) * K + k];
      part[(((size_t)b * nblk + blk) * s + t0 + t) * K + k] = v;
    }
  }
  if (!live) return;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    part_da[st + j] = da[j];
    dh0[st + j] = gc[j];
  }
}

// The second pass: dB, dC [B, S, N] and dt [B, S] as the blocks' partials
// summed in block order, dA [D, N] as the batch's summed in batch order.
__global__ void selective_scan_bwd_reduce(
    const float* __restrict__ part, const float* __restrict__ part_da,
    float* __restrict__ dbmat, float* __restrict__ dcmat,
    float* __restrict__ ddt, float* __restrict__ da, int b, int s, int d,
    int n, int nblk) {
  const int k_n = ss_bwd_k(n);
  const size_t row = (size_t)s * k_n;        // a batch row of one block
  const size_t n_bc = (size_t)b * row, total = n_bc + (size_t)d * n;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    if (e < n_bc) {
      const size_t bi = e / row, r = e % row;
      const float* p = part + bi * nblk * row + r;
      float v = 0.f;
      for (int q = 0; q < nblk; ++q) v += p[(size_t)q * row];
      const size_t bt = bi * s + r / k_n;
      const int k = (int)(r % k_n);
      if (k < n)
        dbmat[bt * n + k] = v;
      else if (k < 2 * n)
        dcmat[bt * n + k - n] = v;
      else
        ddt[bt] = v;
    } else {
      const size_t i = e - n_bc;
      float v = 0.f;
      for (int q = 0; q < b; ++q) v += part_da[(size_t)q * d * n + i];
      da[i] = v;
    }
  }
}

template <int N>
static int ss_bwd_launch(int b, cudaStream_t st, const void* x,
                         const void* dt, const void* bmat, const void* cmat,
                         const void* a, const void* h_chunks, const void* dy,
                         const void* dh_last, void* dx, void* part,
                         void* part_da, void* dbmat, void* dcmat, void* ddt,
                         void* da, void* dh0, int s, int d) {
  constexpr size_t smem = ss_bwd_smem_bytes<N>();
  static const cudaError_t attr = ss_attrs(selective_scan_bwd_kernel<N>,
                                           smem);
  if (attr != cudaSuccess) return (int)attr;
  constexpr int ch = ss_channels<N>();
  const int nblk = (d + ch - 1) / ch;
  selective_scan_bwd_kernel<N><<<dim3(nblk, b), SS_THREADS, smem, st>>>(
      (const float*)x, (const float*)dt, (const float*)bmat,
      (const float*)cmat, (const float*)a, (const float*)h_chunks,
      (const float*)dy, (const float*)dh_last, (float*)dx, (float*)part,
      (float*)part_da, (float*)dh0, s, d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t total = (size_t)b * s * ss_bwd_k(N) + (size_t)d * N;
  const int blocks = (int)((total + 255) / 256 < 132 * 16
                               ? (total + 255) / 256 : 132 * 16);
  selective_scan_bwd_reduce<<<blocks, 256, 0, st>>>(
      (const float*)part, (const float*)part_da, (float*)dbmat,
      (float*)dcmat, (float*)ddt, (float*)da, b, s, d, N, nblk);
  return (int)cudaGetLastError();
}

// Blocks of the backward's grid along D at state size n: the wrapper
// sizes the partials [B, blocks, S, 2n + 1] and [B, D, n] by it.
extern "C" int selective_scan_bwd_blocks(int d, int n) {
  switch (n) {
    case 4: return (d + ss_channels<4>() - 1) / ss_channels<4>();
    case 8: return (d + ss_channels<8>() - 1) / ss_channels<8>();
    case 16: return (d + ss_channels<16>() - 1) / ss_channels<16>();
    case 32: return (d + ss_channels<32>() - 1) / ss_channels<32>();
    case 64: return (d + ss_channels<64>() - 1) / ss_channels<64>();
    default: return -1;
  }
}

// The backward of selective_scan_launch (f32) from its chunk states
// h_chunks [B, ceil(S / SS_CHUNK), D, N]: dy [B, S, D] and dh_last [B, D,
// N] (null: zeros) in; dx [B, S, D], dbmat, dcmat [B, S, N], ddt [B, S],
// da [D, N] and dh0 [B, D, N] out; part [B, blocks,
// S, 2N + 1] and part_da [B, D, N] f32 scratch. Two launches (the
// kernel, then the reduction); b > 0 and d > 0.
extern "C" int selective_scan_bwd_launch(
    const void* x, const void* dt, const void* bmat, const void* cmat,
    const void* a, const void* h_chunks, const void* dy, const void* dh_last,
    void* dx, void* part, void* part_da, void* dbmat, void* dcmat, void* ddt,
    void* da, void* dh0, int b, int s, int d, int n, void* stream) {
  if (b <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define SS_CASE(NN)                                                       \
  case NN:                                                                \
    return ss_bwd_launch<NN>(b, st, x, dt, bmat, cmat, a, h_chunks, dy,   \
                             dh_last, dx, part, part_da, dbmat, dcmat,    \
                             ddt, da, dh0, s, d);
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
