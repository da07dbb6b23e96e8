// The selective scan's backward for Hopper (sm_90a): the gradient of
// `selective_scan.cu`'s f32 forward (whose header states the recurrence),
// `selective_scan_bwd_kernel`. No TPU kernel has it: the reference trains
// through its plain chunked scan and autograd. With g_t = dL/dh_t,
// a_t = exp(dt_t A) and u_t = g_t a_t h_{t-1}:
//
//   g_t     = C_t dy_t + a_{t+1} g_{t+1}      (g_{S-1} adds dh_last)
//   dx_t[d] = dt_t sum_n g_t B_t              dB_t[n] = dt_t sum_d g_t x_t
//   dC_t[n] = sum_d h_t dy_t
//   dt_t    = sum_d (sum_n A u_t + x_t[d] sum_n g_t B_t)
//   dA      = sum_{b,t} dt_t u_t              dh0 = a_0 g_0
//
// Bound, at one training microbatch of hymba-1.5b (B 2, S 4,096, D 3,200,
// N 16: 419,430,400 (b, t, d, n) elements): the exps (one an element)
// over the SFU's 16 a clock per SM, 0.1003 ms, above the bytes the
// function must move, 317.1 MB (x, dt, B, C, A and dy read, dx, dt, dB,
// dC, dA written, each once) over 3.35 TB/s, 0.0947 ms. The saved states
// (104.9 MB read) and the partials below are the design's own traffic,
// outside the bound.
//
// The design:
//
//   * Geometry (`scan_geometry`): 2 states a lane, G = N / 2 lanes a
//     channel, SS_THREADS / G channels a block (16 at N 16), a grid of
//     ceil(D / channels) blocks (rounded up to the cluster) x B: at the
//     training shape 400 blocks of 128 lanes, 51,200 lanes, 3.03 blocks
//     an SM, all resident at once (the registers allow 4).
//   * One exp an element, no local array: the forward saves the state
//     entering every window of SS_SAVE = 16 steps; a block walks its
//     32-step chunks in reverse, staged by the forward's cp.async ring
//     (plus dy), and each chunk's two windows later one first. In a window
//     the recompute runs the forward's arithmetic from the saved state
//     (the same bits), all 16 steps' exps first, then h's chain, keeping
//     h_{t-1} and a_t = exp(dt_t A) of every step in registers (hs[17][2],
//     as[16][2]: 66 of the lane's 128, so 4 blocks an SM fit); the step
//     back reads a_t from there instead of a second ex2, the carry g in
//     registers. A 32-step window (the staging chunk) would need 130
//     registers for the window alone: 3 blocks an SM, 396 slots for 400
//     blocks, a second wave. The states saved every 16 steps cost the
//     forward 52.4 MB more written and the backward as many more read at
//     the training shape than states every 32. S is not split: every lane
//     walks the whole sequence, and segments would add a pass of one exp
//     an element (the carries' local sums) for warps the register file has
//     no room for.
//   * The step back runs SS_BWD_BATCH (4) steps at a time: their loads,
//     the carry's chain (two ops a step), the rest, then their sums side
//     by side. Sums over n in the warp: (sum_n g B, sum_n A u) of a
//     channel meet in one transpose round and log2(G) - 1 butterfly rounds
//     over its G lanes; its first lane stages dx_t (rows of the block's
//     channels, written in float4s after the chunk) and its dt partial.
//   * Sums over d, without atomics and in a fixed order: the 2 x 2 dB and
//     dC partials of a lane meet over the warp's 32 / G channels in two
//     transpose rounds (then butterflies), each lane left with one of the
//     warp's 2N sums; the block adds its 4 warps in order through shared
//     memory ([32 steps][2N + 1] a chunk), and a thread block cluster of
//     up to 8 blocks (`scan_geometry`) adds its blocks' rows in rank order
//     through distributed shared memory, each block a slice of the rows,
//     before anything reaches HBM. The cluster barrier is pipelined by one
//     chunk (rows double-buffered: a block arrives after writing a chunk's
//     rows and waits for them while it ends the next). The scratch, part
//     [B, clusters, S, 2N + 1] f32, is 2 x 25 x 4,096 x 33 x 4 B = 27.0 MB
//     at the training shape (a row of each 16-channel block would take
//     216 MB), plus part_da [B, D, N] 0.4 MB.
//     `selective_scan_bwd_reduce` sums the clusters in order (dB takes its
//     dt there) and dA (kept per (b, d, n) in registers) over B. Two runs
//     give the same bits. Two launches a call.
//   * Shared memory a block at N 16: the ring 24,960 B, the warps' and
//     dx's staging 20,480 B, the cluster rows 8,448 B: 53,888 B, 4 blocks
//     an SM.
#include <cooperative_groups.h>

#include "selective_scan.cuh"

namespace cg = cooperative_groups;

#define SS_BWD_PER 2            // states a lane
#define SS_BWD_MIN_BLOCKS 4     // blocks an SM the registers must allow
#define SS_BWD_MAX_CLUSTER 8    // blocks a cluster (the portable limit)
#define SS_BWD_BATCH 4          // steps of the step back run side by side

// A window of SS_SAVE steps as straight-line code when whole, with a
// guard a step at the sequence's ragged end.
using Whole = std::true_type;
using Ragged = std::false_type;

// Partials a step of the backward: dB [N] (before its dt), dC [N], dt.
__host__ __device__ constexpr int ss_bwd_k(int n) { return 2 * n + 1; }

template <int N>
__host__ __device__ constexpr int ss_bwd_channels() {
  return SS_THREADS / (N / SS_BWD_PER);
}

// Dynamic shared memory of one backward launch, in floats: the SS_SLOTS
// staging buffers (dt, B, C, x, dy), the warps' dB / dC sums [W][SS_CHUNK]
// [2N], the channels' dt partials [W][SS_CHUNK][32 / G], dx [SS_CHUNK]
// [channels], and the block's rows [2][SS_CHUNK][2N + 1].
template <int N>
__host__ __device__ constexpr int ss_bwd_smem_floats() {
  return SS_CHUNK * (SS_SLOTS * (1 + 2 * N + 2 * ss_bwd_channels<N>()) +
                     SS_THREADS / 32 * 2 * N +
                     SS_THREADS / 32 * (32 * SS_BWD_PER / N) +
                     ss_bwd_channels<N>() + 2 * ss_bwd_k(N));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// (p, q) of M steps summed over the G lanes of a channel (lane bits below
// G), the M steps' rounds side by side: after it the channel's first lane
// holds each step's sum p in p and sum q in q. `hi`: lane bit G / 2.
template <int G, int M>
__device__ __forceinline__ void channel_pair_sums(float (&p)[M],
                                                  float (&q)[M], bool hi) {
  constexpr int TOP = G / 2;
  const unsigned full = 0xffffffffu;
  float keep[M];
#pragma unroll
  for (int k = 0; k < M; ++k)
    keep[k] = (hi ? q[k] : p[k]) + __shfl_xor_sync(full, hi ? p[k] : q[k],
                                                   TOP);
#pragma unroll
  for (int o = TOP / 2; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < M; ++k) keep[k] += __shfl_xor_sync(full, keep[k], o);
#pragma unroll
  for (int k = 0; k < M; ++k) {
    p[k] = keep[k];                          // lanes g < TOP: sum p
    q[k] = __shfl_xor_sync(full, keep[k], TOP);
  }
}

// v[k] = (dB partial of states 2g and 2g + 1, then dC's) of step k summed
// over the warp's 32 / G channels (lane bits G..16) and stored to row k
// (`row` + 2N k; `row` already at the lane's slot): two transpose rounds
// on lane bits 16 and 8 (each halves what a lane holds; `h16`, `h8` the
// lane's bits), butterflies on the channel bits below 8; a lane then
// holds one of the warp's 2N sums (two or four where the warp has one or
// two channels; `writer` one lane of each group holding the same sum).
// The M steps' rounds run side by side.
template <int N, int M>
__device__ __forceinline__ void warp_state_sums(float (&v)[M][4], bool h16,
                                                bool h8, bool writer,
                                                float* row) {
  constexpr int G = N / SS_BWD_PER;
  constexpr int L = 32 / G;                  // channels a warp
  const unsigned full = 0xffffffffu;
  if constexpr (L == 1) {
#pragma unroll
    for (int k = 0; k < M; ++k) {
      float* r = row + 2 * N * k;
      r[0] = v[k][0], r[1] = v[k][1], r[N] = v[k][2], r[N + 1] = v[k][3];
    }
  } else {
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const float s0 = h16 ? v[k][0] : v[k][2], s1 = h16 ? v[k][1] : v[k][3];
      v[k][0] = (h16 ? v[k][2] : v[k][0]) + __shfl_xor_sync(full, s0, 16);
      v[k][1] = (h16 ? v[k][3] : v[k][1]) + __shfl_xor_sync(full, s1, 16);
    }
    if constexpr (L == 2) {
#pragma unroll
      for (int k = 0; k < M; ++k) {
        row[2 * N * k] = v[k][0];
        row[2 * N * k + 1] = v[k][1];
      }
    } else {
      float w[M];
#pragma unroll
      for (int k = 0; k < M; ++k)
        w[k] = (h8 ? v[k][1] : v[k][0]) +
               __shfl_xor_sync(full, h8 ? v[k][0] : v[k][1], 8);
#pragma unroll
      for (int o = 4; o >= G; o >>= 1)
#pragma unroll
        for (int k = 0; k < M; ++k) w[k] += __shfl_xor_sync(full, w[k], o);
      if (writer) {
#pragma unroll
        for (int k = 0; k < M; ++k) row[2 * N * k] = w[k];
      }
    }
  }
}

template <int N>
__global__ void __launch_bounds__(SS_THREADS, SS_BWD_MIN_BLOCKS)
    selective_scan_bwd_kernel(
        const float* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ bmat, const float* __restrict__ cmat,
        const float* __restrict__ a, const float* __restrict__ h_chunks,
        const float* __restrict__ dy, const float* __restrict__ dh_last,
        float* __restrict__ dx, float* __restrict__ part,
        float* __restrict__ part_da, float* __restrict__ dh0, int s,
        int d) {
  constexpr int PER = SS_BWD_PER;
  constexpr int G = N / PER;                    // lanes a channel
  constexpr int CH = ss_bwd_channels<N>();      // channels a block
  constexpr int L = 32 / G;                     // channels a warp
  constexpr int W = SS_THREADS / 32;            // warps a block
  constexpr int K = ss_bwd_k(N);
  constexpr int STAGE = SS_CHUNK * (1 + 2 * N + 2 * CH);
  static_assert(G >= 2 && G <= 32 && CH % 4 == 0, "lane split");
  extern __shared__ __align__(16) float smem[];
  float* pw = smem + SS_SLOTS * STAGE;          // [W][SS_CHUNK][2N]
  float* pt = pw + W * SS_CHUNK * 2 * N;        // [W][SS_CHUNK][L]
  float* dxs = pt + W * SS_CHUNK * L;           // [SS_CHUNK][CH]
  float* rows = dxs + SS_CHUNK * CH;            // [2][SS_CHUNK][K]
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y, blk = blockIdx.x;
  const int ncl = gridDim.x / cs, cl = blk / cs;
  const int d0 = blk * CH;
  const int c = threadIdx.x / G, g = threadIdx.x % G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chan = d0 + c;
  const bool live = chan < d;
  // the lane's parts in the sums: its bits, and its slots of a step's
  // rows of warp sums (pw) and of channel dt partials (pt)
  const bool hi = g & (G / 2), h16 = lane & 16, h8 = lane & 8;
  const bool writer = L < 4 || (lane & (8 - G)) == 0;
  const int pw_slot = L == 1   ? 2 * g
                      : L == 2 ? (h16 ? N : 0) + 2 * g
                               : (h16 ? N : 0) + 2 * g + (h8 ? 1 : 0);
  const int pt_slot = c % L;

  // A, A log2(e), the carry a_{t+1} g_{t+1} (dh_last at first), and this
  // lane's dA over the sequence
  float ar[PER], al2[PER], gc[PER], da[PER];
  const size_t st = ((size_t)b * d + chan) * N + g * PER;
  load_row<PER>(ar, live ? a + (size_t)chan * N + g * PER : nullptr, false);
  load_row<PER>(gc, live && dh_last != nullptr ? dh_last + st : nullptr,
                false);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    al2[j] = ar[j] * SS_LOG2E;
    da[j] = 0.f;
  }

  const bool vec_bc = aligned16(bmat) && aligned16(cmat);
  const bool vec_x = aligned16(x) && aligned16(dy) && d % 4 == 0;
  const int chunks = (s + SS_CHUNK - 1) / SS_CHUNK;
  const int wins = (s + SS_SAVE - 1) / SS_SAVE;
  auto saved = [&](int w) {                     // the state entering window w
    return live ? h_chunks + (((size_t)b * wins + w) * d + chan) * N + g * PER
                : nullptr;
  };
  // step i of the walk takes chunk chunks - 1 - i, from slot i % SS_SLOTS
  for (int i = 0; i < 2 && i < chunks; ++i) {
    stage_chunk<N>(smem + i * STAGE, CH, x, dt, bmat, cmat, b, s, d, d0,
                   (chunks - 1 - i) * SS_CHUNK, vec_bc, vec_x, dy);
    cp_commit();
  }
  // step j of the walk's rows summed over the cluster's blocks in rank
  // order, this block taking every cs-th SS_THREADS of them, into part
  auto emit = [&](int j) {
    const int t0 = (chunks - 1 - j) * SS_CHUNK;
    const int steps = min(SS_CHUNK, s - t0);
    const float* rq = rows + (j & 1) * SS_CHUNK * K;
    float* out = part + (((size_t)b * ncl + cl) * s + t0) * K;
    for (int e = rank * SS_THREADS + threadIdx.x; e < steps * K;
         e += cs * SS_THREADS) {
      float v = 0.f;
      for (int r = 0; r < cs; ++r) v += cluster.map_shared_rank(rq, r)[e];
      out[e] = v;
    }
  };
  float hn[PER];                                // the next window's state
  load_row<PER>(hn, saved(wins - 1), false);
  for (int i = 0; i < chunks; ++i) {
    const int kc = chunks - 1 - i;
    const int t0 = kc * SS_CHUNK;
    if (i + 1 < chunks)
      cp_wait<1>();
    else
      cp_wait<0>();
    // chunk kc is in for everyone, and everyone is done with the last
    // step's slot and staging
    __syncthreads();
    if (i + 2 < chunks) {
      stage_chunk<N>(smem + ((i + 2) % SS_SLOTS) * STAGE, CH, x, dt, bmat,
                     cmat, b, s, d, d0, t0 - 2 * SS_CHUNK, vec_bc, vec_x,
                     dy);
      cp_commit();
    }
    const float* dts = smem + (i % SS_SLOTS) * STAGE;
    const float* bs = dts + SS_CHUNK + g * PER;
    const float* cs_ = bs + SS_CHUNK * N;
    const float* xs = dts + SS_CHUNK + 2 * SS_CHUNK * N + c;
    const float* dys = xs + SS_CHUNK * CH;
    const int steps = min(SS_CHUNK, s - t0);
    // steps [lo, lo + n) of the chunk, n = SS_SAVE when whole: the
    // recompute keeps h_{t-1} (hs) and a_t (as) of each step in registers,
    // then the step back walks them in reverse
    auto window = [&](auto whole, int lo, int n) {
      constexpr bool WHOLE = decltype(whole)::value;
      // the window's rows of the staged chunk and of the sums
      const float* dtw = dts + lo;
      const float* xw = xs + lo * CH;
      const float* dyw = dys + lo * CH;
      const float* bw = bs + lo * N;
      const float* cw = cs_ + lo * N;
      float* pww = pw + (warp * SS_CHUNK + lo) * 2 * N + pw_slot;
      float* ptw = pt + (warp * SS_CHUNK + lo) * L + pt_slot;
      float* dxw = dxs + lo * CH + c;
      float hs[SS_SAVE + 1][PER], as[SS_SAVE][PER];
#pragma unroll
      for (int j = 0; j < PER; ++j) hs[0][j] = hn[j];
      const int w = (t0 + lo) / SS_SAVE;
      if (w > 0) load_row<PER>(hn, saved(w - 1), false);
      // the recompute: every step's exps first, then h's chain (one FMA a
      // step), so that the exps' latencies overlap
#pragma unroll
      for (int tt = 0; tt < SS_SAVE; ++tt) {
        if (WHOLE || tt < n) {
#pragma unroll
          for (int j = 0; j < PER; ++j) as[tt][j] = ex2(dtw[tt] * al2[j]);
        }
      }
#pragma unroll
      for (int tt = 0; tt < SS_SAVE; ++tt) {
        if (WHOLE || tt < n) {                  // the forward's arithmetic
          const float dxv = dtw[tt] * xw[tt * CH];
          float bv[PER];
          lds_row<PER>(bv, bw + tt * N);
#pragma unroll
          for (int j = 0; j < PER; ++j)
            hs[tt + 1][j] = fmaf(as[tt][j], hs[tt][j], dxv * bv[j]);
        }
      }
      // the step back, M steps at a time (descending): their loads, the
      // carry's chain (two ops a step), the rest, then their sums over n
      // and over the warp's channels side by side
      constexpr int M = WHOLE ? SS_BWD_BATCH : 1;
#pragma unroll
      for (int tb = SS_SAVE - M; tb >= 0; tb -= M) {
        if (WHOLE || tb < n) {
          float sdx[M], sa[M], v[M][4], gr[M][PER], bv[M][PER], cv[M][PER];
          float dtv[M], xv[M], dyv[M];
#pragma unroll
          for (int k = 0; k < M; ++k) {
            const int tt = tb + k;
            dtv[k] = dtw[tt], xv[k] = xw[tt * CH], dyv[k] = dyw[tt * CH];
            lds_row<PER>(bv[k], bw + tt * N);
            lds_row<PER>(cv[k], cw + tt * N);
          }
#pragma unroll
          for (int k = M - 1; k >= 0; --k) {
            const int tt = tb + k;
#pragma unroll
            for (int j = 0; j < PER; ++j) {
              gr[k][j] = fmaf(cv[k][j], dyv[k], gc[j]);   // dL/dh_t
              gc[j] = as[tt][j] * gr[k][j];
            }
          }
#pragma unroll
          for (int k = M - 1; k >= 0; --k) {
            const int tt = tb + k;
            sdx[k] = 0.f, sa[k] = 0.f;
#pragma unroll
            for (int j = 0; j < PER; ++j) {
              const float u = gr[k][j] * (as[tt][j] * hs[tt][j]);
              sa[k] = fmaf(ar[j], u, sa[k]);
              da[j] = fmaf(dtv[k], u, da[j]);
              sdx[k] = fmaf(gr[k][j], bv[k][j], sdx[k]);
              v[k][j] = gr[k][j] * xv[k];
              v[k][PER + j] = hs[tt + 1][j] * dyv[k];
            }
          }
          channel_pair_sums<G, M>(sdx, sa, hi);
          if (g == 0) {
#pragma unroll
            for (int k = 0; k < M; ++k) {
              dxw[(tb + k) * CH] = sdx[k] * dtv[k];
              ptw[(tb + k) * L] = fmaf(xv[k], sdx[k], sa[k]);
            }
          }
          warp_state_sums<N, M>(v, h16, h8, writer, pww + tb * 2 * N);
        }
      }
    };
    // the later window first; one copy of the whole window's body, so
    // that the hot code stays in the instruction cache
#pragma unroll 1
    for (int lo = SS_CHUNK - SS_SAVE; lo >= 0; lo -= SS_SAVE) {
      const int n = min(steps - lo, SS_SAVE);
      if (n == SS_SAVE)
        window(Whole{}, lo, n);
      else if (n > 0)
        window(Ragged{}, lo, n);
    }
    __syncthreads();     // the warps' sums and dx of the chunk are in
    // the cluster's rows of the last chunk, which every block wrote before
    // it arrived; their buffer (the other one) is then free again, since
    // every block read the rows before those first
    if (i > 0) {
      cluster_wait();
      emit(i - 1);
    }
    // the block's rows: SS_THREADS / SS_CHUNK threads a step, each every
    // such k of the step's 2N + 1 (the warps added in order)
    float* rq = rows + (i & 1) * SS_CHUNK * K;
    constexpr int Q = SS_THREADS / SS_CHUNK;
    const int tr = threadIdx.x / Q, q = threadIdx.x % Q;
    if (tr < steps) {
#pragma unroll
      for (int k = q; k < 2 * N; k += Q) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < W; ++w) v += pw[(w * SS_CHUNK + tr) * 2 * N + k];
        rq[tr * K + k] = v;
      }
      if (q == 0) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < W; ++w)
#pragma unroll
          for (int l = 0; l < L; ++l) v += pt[(w * SS_CHUNK + tr) * L + l];
        rq[tr * K + 2 * N] = v;
      }
    }
    cluster_arrive();
    // dx rows of the block's channels, a float4 of 4 channels a thread
    // (d and the block's first channel are multiples of 4 when x is)
    for (int e = threadIdx.x; e < steps * CH / 4; e += SS_THREADS) {
      const int t = e / (CH / 4), col = d0 + 4 * (e % (CH / 4));
      float* out = dx + ((size_t)b * s + t0 + t) * d + col;
      const float* in = dxs + 4 * e;
      if (vec_x && col < d) {
        *reinterpret_cast<float4*>(out) = *reinterpret_cast<const float4*>(in);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (col + u < d) out[u] = in[u];
      }
    }
  }
  if (chunks > 0) {
    cluster_wait();
    emit(chunks - 1);
  }
  // no block leaves while another may read its rows
  cluster_arrive();
  cluster_wait();
  if (!live) return;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    part_da[st + j] = da[j];
    dh0[st + j] = gc[j];
  }
}

// The second pass: dB (times dt), dC [B, S, N] and dt [B, S] as the
// clusters' partials summed in cluster order, dA [D, N] as the batch's
// summed in batch order.
__global__ void selective_scan_bwd_reduce(
    const float* __restrict__ part, const float* __restrict__ part_da,
    const float* __restrict__ dt, float* __restrict__ dbmat,
    float* __restrict__ dcmat, float* __restrict__ ddt,
    float* __restrict__ da, int b, int s, int d, int n, int ncl) {
  const int k_n = ss_bwd_k(n);
  const size_t row = (size_t)s * k_n;        // a batch row of one cluster
  const size_t n_bc = (size_t)b * row, total = n_bc + (size_t)d * n;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    if (e < n_bc) {
      const size_t bi = e / row, r = e % row;
      const float* p = part + bi * ncl * row + r;
      float v = 0.f;
      for (int q = 0; q < ncl; ++q) v += p[(size_t)q * row];
      const size_t bt = bi * s + r / k_n;
      const int k = (int)(r % k_n);
      if (k < n)
        dbmat[bt * n + k] = v * dt[bt];
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
                         void* da, void* dh0, int s, int d, int cluster) {
  constexpr size_t smem = sizeof(float) * ss_bwd_smem_floats<N>();
  static const cudaError_t attr = ss_attrs(selective_scan_bwd_kernel<N>,
                                           smem);
  if (attr != cudaSuccess) return (int)attr;
  constexpr int ch = ss_bwd_channels<N>();
  const int nblk = (d + ch - 1) / ch;
  const int gx = (nblk + cluster - 1) / cluster * cluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gx, b);
  cfg.blockDim = dim3(SS_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, selective_scan_bwd_kernel<N>, (const float*)x, (const float*)dt,
      (const float*)bmat, (const float*)cmat, (const float*)a,
      (const float*)h_chunks, (const float*)dy, (const float*)dh_last,
      (float*)dx, (float*)part, (float*)part_da, (float*)dh0, s, d);
  if (e != cudaSuccess) return (int)e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t total = (size_t)b * s * ss_bwd_k(N) + (size_t)d * N;
  const int blocks = (int)((total + 255) / 256 < 132 * 16
                               ? (total + 255) / 256 : 132 * 16);
  selective_scan_bwd_reduce<<<blocks, 256, 0, st>>>(
      (const float*)part, (const float*)part_da, (const float*)dt,
      (float*)dbmat, (float*)dcmat, (float*)ddt, (float*)da, b, s, d, N,
      gx / cluster);
  return (int)cudaGetLastError();
}

// The backward of selective_scan_launch (f32) from its saved states
// h_chunks [B, ceil(S / SS_SAVE), D, N]: dy [B, S, D] and dh_last [B, D,
// N] (null: zeros) in; dx [B, S, D], dbmat, dcmat [B, S, N], ddt [B, S],
// da [D, N] and dh0 [B, D, N] out; part [B, clusters, S, 2N + 1] and
// part_da [B, D, N] f32 scratch, clusters = ceil(ceil(D / (256 / N)) /
// cluster), SS_BWD_PER states a lane; `cluster` 1 to 8 (`scan_geometry`).
// Two launches (the kernel, then the reduction); b > 0 and d > 0.
extern "C" int selective_scan_bwd_launch(
    const void* x, const void* dt, const void* bmat, const void* cmat,
    const void* a, const void* h_chunks, const void* dy, const void* dh_last,
    void* dx, void* part, void* part_da, void* dbmat, void* dcmat, void* ddt,
    void* da, void* dh0, int b, int s, int d, int n, int cluster,
    void* stream) {
  if (b <= 0 || d <= 0 || cluster < 1 || cluster > SS_BWD_MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define SS_CASE(NN)                                                       \
  case NN:                                                                \
    return ss_bwd_launch<NN>(b, st, x, dt, bmat, cmat, a, h_chunks, dy,   \
                             dh_last, dx, part, part_da, dbmat, dcmat,    \
                             ddt, da, dh0, s, d, cluster);
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
