// Batched priority-queue pop (rank-select + descent) for Hopper (sm_90a).
//
// Replaces the Pallas kernel `pq_pop_tiles` / `rank_select` in
// src/repro/kernels/pq_pop/kernel.py. Pop-min is rank selection over the live
// terminal prefix (live = unmarked and not KEY_INF): rank r selects the first
// cell whose inclusive live prefix reaches r + 1, a rank past the live total
// selects nothing (KEY_INF), and the selected key goes through the shared
// `level_walk` (probe.cuh), so key -> terminal index has one implementation
// across FIND and POP. The TPU kernel compares every rank with every prefix
// entry ([T, C]); that matrix is never built here.
//
// The ranks need the live prefix only up to the first chunk whose inclusive
// count reaches want_max = 1 + the largest masked-in rank: all of it only
// when want_max exceeds the live total, none of it when no lane is masked in
// or every masked-in rank is negative. Two launches:
//   1. `pq_scan_kernel`: an ordered single-pass scan over PQ_CHUNK-cell
//      chunks. Blocks take tiles of PQ_TILE chunks in order from an atomic
//      ticket; the first ticket's block computes want_max (a block-wide max
//      over the lanes) and publishes it. A warp counts a chunk (ballot +
//      popc over coalesced rounds of 32 cells, so the cost does not depend
//      on where the tombstone run lies), keeping each round's count; the
//      block publishes its tile's count, then its inclusive prefix after a
//      decoupled look-back, and the chunks' inclusive prefixes. The tile
//      holding the first chunk that reaches want_max publishes it as the
//      stop index; a block whose ticket lies past the stop returns without
//      reading the plane.
//   2. `pq_select_kernel`: one thread a rank binary-searches the published
//      prefix [0, stop] for the first chunk that reaches r + 1, picks the
//      32-cell round from the chunk's round counts, finds the live cell in
//      it, and runs `level_walk` on its key.
//
// The scan's scratch (`words`) lives across calls, zeroed once when the
// wrapper allocates it: two tickets, used by turns (a call zeroes the next
// call's), the want_max word, the stop word and one word a tile, each
// tagged with the call's epoch (the wrapper counts the calls that launch),
// so a word left by an earlier call reads as unpublished and nothing needs
// clearing between calls.
//
// Bound: bytes. The scan reads the terminal key and mark planes (9 bytes a
// cell) up to the stop chunk's tile, and none of them without a pop lane;
// the select reads each rank's search path, one 32-cell round and its walk.
#include <limits.h>

#include "probe.cuh"

#define PQ_CHUNK 512     // cells a prefix entry: a warp's 16 rounds of 32
#define PQ_ROUNDS (PQ_CHUNK / 32)
#define PQ_TILE 8        // chunks a ticket, a warp each
#define PQ_THREADS (PQ_TILE * 32)

// scratch words: [0], [1] the tickets, [2] want_max, [3] stop + 1, then the
// tiles. A word is (epoch << 34 | status << 32 | value).
#define PQ_WM 2
#define PQ_STOP 3
#define PQ_TILES 4
#define PQ_AGG 1ull
#define PQ_INC 2ull

// The key and the mark are read together, not one after the other.
__device__ __forceinline__ bool live_cell(const u64* term_keys,
                                          const int8_t* term_mark, int cap,
                                          int c) {
  if (c >= cap) return false;
  const int8_t mk = term_mark[c];
  const u64 key = term_keys[c];
  return mk == 0 && key != KEY_INF_U64;
}

__device__ __forceinline__ bool pq_tagged(u64 w, int epoch) {
  return (w >> 34) == (u64)epoch;
}

__device__ __forceinline__ u64 pq_word(int epoch, u64 status, int value) {
  return ((u64)epoch << 34) | (status << 32) | (unsigned)value;
}

// The stop index (-1: nothing needed) once published, else `unknown`.
__device__ __forceinline__ int pq_stop(const volatile u64* words, int epoch,
                                       int unknown) {
  const u64 w = words[PQ_STOP];
  return pq_tagged(w, epoch) ? (int)(unsigned)w - 1 : unknown;
}

// The rank a lane selects, plus one; 0 when it selects nothing.
__device__ __forceinline__ int pq_want(const int* ranks, const int8_t* mask,
                                       int i) {
  const int want = (int)((unsigned)ranks[i] + 1u);
  return mask[i] != 0 && want >= 1 ? want : 0;
}

// want_max over the t lanes, by the whole block: the masks 16 lanes a load,
// 8 loads of a thread in flight (the ranks only where a mask is set).
// Every thread must call it.
__device__ int pq_want_max(const int* ranks, const int8_t* mask, int t) {
  __shared__ int warp_max[PQ_THREADS / 32];
  int best = 0;
  int head = 0;
  if (((size_t)mask & 15) == 0) {
    head = t & ~15;
    const int nv = head / 16;
    // 8 mask loads of a thread at once, then the ranks of the set ones
    for (int v0 = threadIdx.x; v0 < nv; v0 += 8 * blockDim.x) {
      int4 mv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int v = v0 + u * blockDim.x;
        mv[u] = v < nv ? reinterpret_cast<const int4*>(mask)[v]
                       : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if ((mv[u].x | mv[u].y | mv[u].z | mv[u].w) == 0) continue;
        const int v = v0 + u * blockDim.x;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          best = max(best, pq_want(ranks, mask, v * 16 + j));
      }
    }
  }
  for (int i = head + threadIdx.x; i < t; i += blockDim.x)
    best = max(best, pq_want(ranks, mask, i));
  for (int o = 16; o > 0; o >>= 1)
    best = max(best, __shfl_xor_sync(0xffffffffu, best, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = best;
  __syncthreads();
  best = 0;
  for (int w = 0; w < PQ_THREADS / 32; ++w) best = max(best, warp_max[w]);
  return best;
}

// Warp 0: the sum of the counts of tiles tile - 1, tile - 2, ... back to the
// first inclusive prefix. Returns false, leaving *sum, if the stop is
// published below `first_chunk` while a tile is still unpublished: that
// tile's block has left, and so may this one.
__device__ __forceinline__ bool pq_lookback(volatile u64* words, int epoch,
                                            int tile, int first_chunk,
                                            int* sum) {
  const int lane = threadIdx.x & 31;
  int acc = 0;
  for (int p = tile - 1;; p -= 32) {
    const int q = p - lane;
    u64 w = 0;
    bool quit = false;
    if (q >= 0) {
      for (;;) {
        w = words[PQ_TILES + q];
        if (pq_tagged(w, epoch)) break;
        if (pq_stop(words, epoch, INT_MAX) < first_chunk) {
          quit = true;
          break;
        }
      }
    }
    if (__any_sync(0xffffffffu, quit)) return false;
    const unsigned inc = __ballot_sync(
        0xffffffffu, q < 0 || ((w >> 32) & 3ull) == PQ_INC);
    const int upto = inc ? __ffs(inc) - 1 : 31;
    int v = lane <= upto && q >= 0 ? (int)(unsigned)w : 0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    acc += v;
    if (inc) break;
  }
  *sum = acc;
  return true;
}

__global__ void __launch_bounds__(PQ_THREADS) pq_scan_kernel(
    const int* __restrict__ ranks, const int8_t* __restrict__ mask, int t,
    const u64* __restrict__ term_keys, const int8_t* __restrict__ term_mark,
    int cap, int nchunks, u64* words_, int* __restrict__ prefix,
    uint8_t* __restrict__ rounds, int epoch) {
  __shared__ int s_ticket, s_wm, s_stop, s_quit;
  __shared__ int cnt[PQ_TILE];
  volatile u64* words = words_;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ntiles = (nchunks + PQ_TILE - 1) / PQ_TILE;
  if (blockIdx.x == 0 && threadIdx.x == 0) words[(epoch + 1) & 1] = 0;
  bool know_wm = false;
  for (;;) {
    if (threadIdx.x == 0)
      s_ticket = (int)atomicAdd((unsigned long long*)&words_[epoch & 1], 1ull);
    __syncthreads();
    const int tile = s_ticket;
    if (tile >= ntiles) break;
    if (tile == 0) {
      const int wm = pq_want_max(ranks, mask, t);
      if (threadIdx.x == 0) {
        s_wm = wm;
        words[PQ_STOP] = pq_word(epoch, PQ_AGG, wm > 0 ? nchunks : 0);
        __threadfence();
        words[PQ_WM] = pq_word(epoch, PQ_AGG, wm);
      }
      know_wm = true;
    } else if (!know_wm) {
      if (threadIdx.x == 0) {
        u64 w;
        do w = words[PQ_WM]; while (!pq_tagged(w, epoch));
        s_wm = (int)(unsigned)w;
      }
      know_wm = true;
    }
    if (threadIdx.x == 0) {
      __threadfence();
      s_stop = pq_stop(words, epoch, nchunks - 1);
      s_quit = 0;
    }
    __syncthreads();
    const int first = tile * PQ_TILE;
    if (first > s_stop) break;         // past the stop (or nothing needed)

    // a warp counts a chunk, 32 cells a round, all rounds' loads at once
    const int c = first + warp;
    int n = 0;
    if (c < nchunks) {
      bool lv[PQ_ROUNDS];
#pragma unroll
      for (int j = 0; j < PQ_ROUNDS; ++j)
        lv[j] = live_cell(term_keys, term_mark, cap,
                          c * PQ_CHUNK + j * 32 + lane);
      int mine = 0;
#pragma unroll
      for (int j = 0; j < PQ_ROUNDS; ++j) {
        const int r = __popc(__ballot_sync(0xffffffffu, lv[j]));
        n += r;
        if (lane == j) mine = r;
      }
      if (lane < PQ_ROUNDS) rounds[c * PQ_ROUNDS + lane] = (uint8_t)mine;
    }
    if (lane == 0) cnt[warp] = n;
    __syncthreads();

    if (warp == 0) {
      int v = lane < PQ_TILE ? cnt[lane] : 0;
      for (int o = 1; o < PQ_TILE; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += y;
      }
      const int agg = __shfl_sync(0xffffffffu, v, PQ_TILE - 1);
      int before = 0;
      bool ok = true;
      if (tile > 0) {
        if (lane == 0) words[PQ_TILES + tile] = pq_word(epoch, PQ_AGG, agg);
        ok = pq_lookback(words, epoch, tile, first, &before);
      }
      if (!ok) {
        if (lane == 0) s_quit = 1;
      } else {
        if (lane == 0)
          words[PQ_TILES + tile] = pq_word(epoch, PQ_INC, before + agg);
        const int wm = s_wm;
        const int incl = before + v;
        const bool mine = lane < PQ_TILE && first + lane < nchunks;
        if (mine) prefix[first + lane] = incl;
        // the first chunk whose inclusive prefix reaches want_max
        const unsigned reach = __ballot_sync(0xffffffffu, mine && incl >= wm);
        if (before < wm && reach) {
          __threadfence();             // the prefixes before the stop
          if (lane == 0)
            words[PQ_STOP] = pq_word(epoch, PQ_AGG, first + __ffs(reach));
        }
        if (lane == 0 && (before >= wm || reach)) s_quit = 1;
      }
    }
    __syncthreads();
    if (s_quit) break;
  }
}

__global__ void pq_select_kernel(
    const int* __restrict__ ranks, const int8_t* __restrict__ mask, int t,
    const u64* words_, const int* __restrict__ prefix,
    const uint8_t* __restrict__ rounds, int epoch,
    const u64* __restrict__ lvl_keys, const int* __restrict__ lvl_child,
    const int* __restrict__ lvl_off, int levels, int c1,
    const u64* __restrict__ term_keys, const int8_t* __restrict__ term_mark,
    int cap, int8_t* __restrict__ found, int* __restrict__ idx) {
  __shared__ int off[MAX_LEVELS + 1];
  load_table(off, lvl_off, levels + 1);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= t) return;
  const int stop = pq_stop(words_, epoch, -1);
  const int want = pq_want(ranks, mask, i);
  const int top = stop >= 0 ? prefix[stop] : 0;
  const bool sel = want >= 1 && want <= top;
  u64 key = KEY_INF_U64;
  if (sel) {
    int lo = 0, hi = stop;             // first chunk with prefix >= want
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (prefix[mid] < want) lo = mid + 1; else hi = mid;
    }
    int need = want - (lo > 0 ? prefix[lo - 1] : 0);
    const uint4 rv = reinterpret_cast<const uint4*>(rounds)[lo];
    const unsigned rw[4] = {rv.x, rv.y, rv.z, rv.w};
    int r = 0;
    for (; r < PQ_ROUNDS - 1; ++r) {
      const int nr = (rw[r >> 2] >> (8 * (r & 3))) & 0xFF;
      if (need <= nr) break;
      need -= nr;
    }
    const int base = lo * PQ_CHUNK + r * 32;
    unsigned bits = 0;
#pragma unroll
    for (int x = 0; x < 32; ++x)
      bits |= live_cell(term_keys, term_mark, cap, base + x) ? 1u << x : 0u;
    for (int x = 0; x < 32; ++x) {
      if (((bits >> x) & 1) && --need == 0) {
        key = term_keys[base + x];
        break;
      }
    }
  }
  int at = 0;
  const bool f = sel && level_walk(key, lvl_keys, lvl_child, off, levels, c1,
                                   term_keys, term_mark, cap, &at);
  found[i] = f ? 1 : 0;
  idx[i] = f ? at : 0;
}

// `words` is [4 + ceil(nchunks / PQ_TILE)] u64, `prefix` [nchunks] int32 and
// `rounds` [nchunks * 16] uint8 scratch (nchunks = ceil(cap / PQ_CHUNK)),
// the words zeroed when allocated; `epoch` in [1, 2^30) differs from every
// earlier call's on the same words. Stage 0 is the scan on `grid` blocks,
// stage 1 the select.
extern "C" int pq_pop_launch(const void* ranks, const void* mask, int t,
                             const void* lvl_keys, const void* lvl_child,
                             const void* lvl_off, int levels, int c1,
                             const void* term_keys, const void* term_mark,
                             int cap, void* words, void* prefix, void* rounds,
                             int epoch, int grid, void* found, void* idx,
                             int stage, void* stream) {
  const int nchunks = (cap + PQ_CHUNK - 1) / PQ_CHUNK;
  cudaStream_t s = (cudaStream_t)stream;
  if (stage == 0) {
    if (nchunks > 0 && grid > 0)
      pq_scan_kernel<<<grid, PQ_THREADS, 0, s>>>(
          (const int*)ranks, (const int8_t*)mask, t, (const u64*)term_keys,
          (const int8_t*)term_mark, cap, nchunks, (u64*)words, (int*)prefix,
          (uint8_t*)rounds, epoch);
  } else if (t > 0) {
    const int threads = 256;
    pq_select_kernel<<<(t + threads - 1) / threads, threads, 0, s>>>(
        (const int*)ranks, (const int8_t*)mask, t, (const u64*)words,
        (const int*)prefix, (const uint8_t*)rounds, epoch,
        (const u64*)lvl_keys, (const int*)lvl_child, (const int*)lvl_off,
        levels, c1, (const u64*)term_keys, (const int8_t*)term_mark, cap,
        (int8_t*)found, (int*)idx);
  }
  return (int)cudaGetLastError();
}
