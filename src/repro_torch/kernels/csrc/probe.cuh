// Shared device-side probe bodies of the store kernels (sm_90a).
//
// The reference Pallas kernels share their bodies the same way:
// `bucket_probe` (kernels/hash_probe), `level_walk` (kernels/skiplist_search)
// and `spill_run_probe` (kernels/tier_find) are each written once and reused
// by the fused tier kernels. Keys arrive as int64 bit patterns and are
// compared here as unsigned 64-bit integers: the card has native u64 compares,
// so the TPU's (hi, lo) u32 split does not exist on this side.
//
// Every body reproduces the reference conventions exactly:
//   * the first-true argmax of an all-false row is 0;
//   * the level walk clips indices as `level_walk` does on the padded
//     [L, C1] rectangle: a level index is clipped to [0, c1 - 1], and a read
//     past the level's own capacity sees the rectangle's padding (KEY_INF
//     key, child 0); terminal reads clip to [0, C - 1];
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
