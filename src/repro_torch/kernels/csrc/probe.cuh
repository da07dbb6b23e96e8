// Shared device-side probe bodies of the store kernels (sm_90a).
//
// The reference Pallas kernels share their bodies the same way:
// `bucket_probe` (kernels/hash_probe), `level_walk` (kernels/skiplist_search),
// `block_walk` (kernels/bskiplist_walk) and `spill_run_probe`
// (kernels/tier_find) are each written once and reused by the fused tier
// kernels and the pq pop. Keys arrive as int64 bit patterns and are
// compared here as unsigned 64-bit integers: the card has native u64 compares,
// so the TPU's (hi, lo) u32 split does not exist on this side.
//
// Every body reproduces the reference conventions exactly:
//   * the first-true argmax of an all-false row is 0;
//   * the level walk clips indices as `level_walk` does on the padded
//     [L, C1] rectangle: a level index is clipped to [0, c1 - 1], and a read
//     past the level's own capacity sees the rectangle's padding (KEY_INF
//     key, child 0); terminal reads clip to [0, C - 1];
//   * the block walk clips a node id to [0, W/B - 1] on every index row and
//     the terminal block to [0, NB - 1], and reads the terminal planes with
//     the padded length NB*B: a cell at or past C is a KEY_INF key, mark 0;
//   * the hot column of a miss is 0;
//   * the spill cell of a miss is the clipped search position in run 0.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;

#define KEY_INF_U64 0xFFFFFFFFFFFFFFFFull
#define MAX_LEVELS 64
#define MAX_RUNS 64

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Fixed-hash bucket probe: first column of row `slot` (clipped to [0, m-1])
// holding `q`. Returns hit; *col = first hit column, 0 on a miss.
__device__ __forceinline__ bool bucket_probe(u64 q, int slot, const u64* keys,
                                             int m, int b, int* col) {
  const u64* row = keys + (long long)clampi(slot, 0, m - 1) * b;
  for (int j = 0; j < b; ++j) {
    if (row[j] == q) {
      *col = j;
      return true;
    }
  }
  *col = 0;
  return false;
}

// Key of level r at index idx (already clipped to [0, c1 - 1]); past the
// level's capacity the padded rectangle holds KEY_INF.
__device__ __forceinline__ u64 level_key(const u64* lvl_keys, const int* off,
                                         int r, int idx) {
  int cap = off[r + 1] - off[r];
  return idx < cap ? lvl_keys[off[r] + idx] : KEY_INF_U64;
}

// Level-major descent: the top fan-out-4 probe, then `levels` steps each
// taking the first of 4 children with q <= key. `off` holds levels + 1
// offsets (in shared memory). Returns found; *idx = terminal index.
__device__ __forceinline__ bool level_walk(u64 q, const u64* lvl_keys,
                                           const int* lvl_child, const int* off,
                                           int levels, int c1,
                                           const u64* term_keys,
                                           const int8_t* term_mark, int cap,
                                           int* idx) {
  int i = 0;
  for (int j = 0; j < 4; ++j) {        // top row: capacity >= 4 always
    if (q <= lvl_keys[off[levels - 1] + j]) {
      i = j;
      break;
    }
  }
  for (int r = levels - 1; r >= 0; --r) {
    int ic = clampi(i, 0, c1 - 1);
    int cap_r = off[r + 1] - off[r];
    int start = ic < cap_r ? lvl_child[off[r] + ic] : 0;
    int sel = 0;
    if (r == 0) {
      for (int j = 0; j < 4; ++j) {
        if (q <= term_keys[clampi(start + j, 0, cap - 1)]) {
          sel = j;
          break;
        }
      }
    } else {
      for (int j = 0; j < 4; ++j) {
        if (q <= level_key(lvl_keys, off, r - 1, clampi(start + j, 0, c1 - 1))) {
          sel = j;
          break;
        }
      }
    }
    i = start + sel;
  }
  i = clampi(i, 0, cap - 1);
  *idx = i;
  return term_keys[i] == q && term_mark[i] == 0;
}

// Keys per B-skiplist node (core.layout.BSKIP_BLOCK).
#define BSKIP_B 128

// How many of the B entries node[start + j] (j < B) are below q; an entry
// at or past `cap` is padding (KEY_INF, never below q). TEAM = 1: one
// thread reads the whole node. TEAM = 32: the calling warp reads it, lane l
// taking entries l, l + 32, l + 64, l + 96 (each round one coalesced 256-byte
// read), and a ballot counts the compares; every lane gets the count. The
// count does not depend on the order of the entries.
template <int TEAM>
__device__ __forceinline__ int node_count_lt(const u64* node, int start,
                                             int cap, u64 q) {
  static_assert(TEAM == 1 || TEAM == 32, "a thread or a warp");
  const int lane = TEAM == 1 ? 0 : (threadIdx.x & 31);
  int n = 0;
#pragma unroll 4
  for (int j = lane; j < BSKIP_B; j += TEAM) {
    int c = start + j;
    bool lt = c < cap && node[c] < q;
    if (TEAM == 1)
      n += lt ? 1 : 0;
    else
      n += __popc(__ballot_sync(0xffffffffu, lt));
  }
  return n;
}

// Block-major B-skiplist descent: one whole-node count per index row, from
// the root (node 0 of row levels - 1) down, the child being base + count;
// then the count in the terminal block, and the exact match with the
// tombstone. `blk` is the [levels, w] row stack; the terminal planes hold
// `cap` cells read with the padded length n_pad = NB * B. Returns found;
// *idx = terminal index (clipped to [0, n_pad - 1]). Under TEAM = 32 every
// lane of the warp must call it, and every lane gets the result.
template <int TEAM>
__device__ __forceinline__ bool block_walk(u64 q, const u64* blk, int levels,
                                           int w, const u64* term_keys,
                                           const int8_t* term_mark, int cap,
                                           int n_pad, int* idx) {
  int i = 0;
  for (int r = levels - 1; r >= 0; --r) {
    int base = clampi(i, 0, w / BSKIP_B - 1) * BSKIP_B;
    i = base + node_count_lt<TEAM>(blk + (long long)r * w, base, w, q);
  }
  int tb = clampi(i, 0, n_pad / BSKIP_B - 1) * BSKIP_B;
  i = clampi(tb + node_count_lt<TEAM>(term_keys, tb, cap, q), 0, n_pad - 1);
  *idx = i;
  if (i >= cap) return q == KEY_INF_U64;   // padding: KEY_INF key, mark 0
  return term_keys[i] == q && term_mark[i] == 0;
}

// The warm tier's walk in either layout: `blocked` selects the block-major
// rows (`keys` = the [levels, width] row stack, `child` and `off` unused) or
// the level-major levels (`keys` / `child` flat, `off` the level offsets,
// width = c1). One thread per query.
__device__ __forceinline__ bool warm_walk(u64 q, int blocked, const u64* keys,
                                          const int* child, const int* off,
                                          int levels, int width,
                                          const u64* term_keys,
                                          const int8_t* term_mark, int cap,
                                          int n_pad, int* idx) {
  if (blocked)
    return block_walk<1>(q, keys, levels, width, term_keys, term_mark, cap,
                         n_pad, idx);
  return level_walk(q, keys, child, off, levels, width, term_keys, term_mark,
                    cap, idx);
}

// Cold-tier probe: searchsorted-left of q in every sorted run
// [off[r], off[r + 1]) of the spill planes; the first live match wins.
// Returns found; *cell = matched cell, or the clipped position in run 0.
__device__ __forceinline__ bool spill_probe(u64 q, const u64* sp_keys,
                                            const int8_t* sp_dead,
                                            const int* run_off, int runs,
                                            int s, int* cell) {
  int miss_cell = 0;
  for (int r = 0; r < runs; ++r) {
    int lo = run_off[r];
    int end = run_off[r + 1];
    int hi = end;
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (sp_keys[mid] < q) lo = mid + 1; else hi = mid;
    }
    int pos = clampi(lo, 0, s - 1);
    if (r == 0) miss_cell = pos;
    if (lo < end && sp_keys[pos] == q && sp_dead[pos] == 0) {
      *cell = pos;
      return true;
    }
  }
  *cell = miss_cell;
  return false;
}

// Copy a small int32 table (level or run offsets) into shared memory.
__device__ __forceinline__ void load_table(int* dst, const int* src, int n) {
  for (int t = threadIdx.x; t < n; t += blockDim.x) dst[t] = src[t];
  __syncthreads();
}

// Exclusive prefix of v over the block (blockDim.x a multiple of 32, at most
// 1024); *total receives the block sum. Every thread of the block must call
// it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[32];
  int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
  int nw = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  int excl = x - v + (warp > 0 ? warp_sums[warp - 1] : 0);
  *total = warp_sums[nw - 1];
  __syncthreads();
  return excl;
}
