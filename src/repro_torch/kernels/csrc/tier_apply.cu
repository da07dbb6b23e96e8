// Fused tier-stack APPLY prologue for Hopper (sm_90a): tier membership plus
// the hot-tier insert linearization and the eviction policy's victim choice.
//
// Replaces the Pallas kernel `tier_apply_tiles` / `_ta_kernel` /
// `spill_chunk_probe` in src/repro/kernels/tier_apply/kernel.py (both warm
// layouts: the level-major `level_walk` or, with `blocked`, the block-major
// `block_walk<1>` of the reference's `warm_blocked` branch; with and without
// spill; policies none / lru / size). Lanes come
// in sorted (slot, key) order with the key-run and slot-run starts
// precomputed by the glue; the nine outputs are the reference's, in the same
// lane order: in_warm, in_spill, placed, exists, dup, need_ev (int8) and col,
// vcol, ecol (int32).
//
// Two launches:
//   1. `tier_apply_member_kernel`, one thread per lane: the membership probes
//      (bucket probe, warm walk, binary search of every spill run straight
//      from HBM; the TPU's chunked spill streaming and scalar prefetch exist
//      only because of VMEM and give the same found bit), the miss
//      fall-through, and the lane's pre-batch bucket row: existence column,
//      empty-cell mask and, under a policy, the columns in victim order
//      (counting rank over the score row, ties by column) packed 4 bits each.
//   2. `tier_apply_scan_kernel`, ONE block of 1024 threads: the three
//      dependent K-wide prefix sums (c1 over the insert mask, read back at
//      the key-run starts; c2 over the candidates, read back at the slot-run
//      starts; the need-evict count against `max_evict`). Each thread owns a
//      contiguous chunk of lanes, a block-wide scan carries the prefix, and
//      the scanned values go through global scratch.
//
// Bound: the membership launch is bound by memory latency (dependent random
// gathers, as tier_find); the scan launch by its single block, i.e. by a few
// passes over K lanes at one SM's rate. Both are simple first versions.
#include <limits.h>

#include "probe.cuh"

__global__ void tier_apply_member_kernel(
    const u64* __restrict__ sk, const int* __restrict__ ss,
    const int8_t* __restrict__ sm, int k, const u64* __restrict__ hot_keys,
    const int* __restrict__ meta, int m, int b, int blocked,
    const u64* __restrict__ warm_keys, const int* __restrict__ lvl_child,
    const int* __restrict__ lvl_off, int levels, int width,
    const u64* __restrict__ term_keys, const int8_t* __restrict__ term_mark,
    int cap, int n_pad, const u64* __restrict__ sp_keys,
    const int8_t* __restrict__ sp_dead, const int* __restrict__ run_off,
    int runs, int s, int policy,
    int8_t* __restrict__ in_warm, int8_t* __restrict__ in_spill,
    int* __restrict__ ecol, int8_t* __restrict__ flags, int* __restrict__ emask,
    u64* __restrict__ vorder) {
  __shared__ int off[MAX_LEVELS + 1];
  __shared__ int roff[MAX_RUNS + 1];
  if (!blocked) load_table(off, lvl_off, levels + 1);
  if (runs > 0) load_table(roff, run_off, runs + 1);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;

  // membership: masked-off lanes probe with the KEY_INF sentinel
  bool smb = sm[i] != 0;
  u64 key = sk[i];
  u64 mq = smb ? key : KEY_INF_U64;
  int unused;
  bool f_hot = bucket_probe(mq, ss[i], hot_keys, m, b, &unused) && smb;
  bool f_warm = warm_walk(mq, blocked, warm_keys, lvl_child, off, levels,
                          width, term_keys, term_mark, cap, n_pad, &unused) &&
                smb;
  bool f_sp = runs > 0 &&
              spill_probe(mq, sp_keys, sp_dead, roff, runs, s, &unused) && smb;
  bool iw = f_warm && !f_hot;
  bool isp = f_sp && !f_hot && !f_warm;
  bool sm_ins = smb && !iw && !isp;
  in_warm[i] = iw ? 1 : 0;
  in_spill[i] = isp ? 1 : 0;

  // the lane's pre-batch bucket row
  int row_at = clampi(ss[i], 0, m - 1) * b;
  int em = 0, ec = 0;
  bool any = false;
  for (int j = 0; j < b; ++j) {
    u64 kj = hot_keys[row_at + j];
    if (kj == KEY_INF_U64) em |= 1 << j;
    if (!any && kj == key) {
      any = true;
      ec = j;
    }
  }
  ecol[i] = ec;
  emask[i] = em;
  flags[i] = (sm_ins ? 1 : 0) | (any ? 2 : 0);

  if (policy != 0) {
    // victim order: lru evicts the oldest stamp, size the largest weight;
    // empty cells rank last; ties by column
    int score[16];
    for (int j = 0; j < b; ++j) {
      int mv = meta[row_at + j];
      int sc = policy == 1 ? mv : (int)(0u - (unsigned)mv);
      score[j] = ((em >> j) & 1) ? INT_MAX : sc;
    }
    u64 packed = 0;
    for (int j = 0; j < b; ++j) {
      int pos = 0;
      for (int q = 0; q < b; ++q)
        pos += (score[q] < score[j] || (score[q] == score[j] && q < j)) ? 1 : 0;
      packed |= (u64)j << (4 * pos);
    }
    vorder[i] = packed;
  }
}

__global__ void tier_apply_scan_kernel(
    int k, int b, int policy, const int* __restrict__ krs,
    const int* __restrict__ srs, const int8_t* __restrict__ flags,
    const int* __restrict__ emask, const u64* __restrict__ vorder,
    const int* __restrict__ max_evict, int* __restrict__ c1,
    int* __restrict__ c2, int8_t* __restrict__ placed,
    int8_t* __restrict__ exists, int8_t* __restrict__ dup,
    int8_t* __restrict__ need_ev, int* __restrict__ col,
    int* __restrict__ vcol) {
  int per = (k + blockDim.x - 1) / blockDim.x;
  int lo = threadIdx.x * per;
  int hi = min(lo + per, k);
  int total, run, local;

  // pass 1: c1 = inclusive cumsum of the insert mask
  local = 0;
  for (int i = lo; i < hi; ++i) local += flags[i] & 1;
  run = block_exclusive_scan(local, &total);
  for (int i = lo; i < hi; ++i) {
    run += flags[i] & 1;
    c1[i] = run;
  }
  __syncthreads();

  // pass 2: in-batch duplicate rank (key-run starts), existence, candidates
  // (held in `placed` until pass 3); c2 = inclusive cumsum of candidates
  local = 0;
  for (int i = lo; i < hi; ++i) {
    int smi = flags[i] & 1;
    int kr = krs[i];
    int before_k = c1[kr] - (flags[kr] & 1);
    bool d = smi && (c1[i] - smi - before_k > 0);
    bool e = smi && (flags[i] & 2) && !d;
    bool c = smi && !d && !e;
    dup[i] = d ? 1 : 0;
    exists[i] = e ? 1 : 0;
    placed[i] = c ? 1 : 0;
    local += c ? 1 : 0;
  }
  run = block_exclusive_scan(local, &total);
  for (int i = lo; i < hi; ++i) {
    run += placed[i];
    c2[i] = run;
  }
  __syncthreads();

  // pass 3: within-slot rank, nth-empty column, victim column, need-evict
  local = 0;
  for (int i = lo; i < hi; ++i) {
    int ci = placed[i];
    int s0 = srs[i];
    int rank = c2[i] - (s0 > 0 ? c2[s0 - 1] : 0) - ci;
    int em = emask[i];
    int n_empty = __popc(em);
    int col_e = b, seen = 0;
    bool fit = false;
    for (int j = 0; j < b; ++j) {
      if ((em >> j) & 1) {
        if (++seen == rank + 1) {
          col_e = j;
          fit = true;
          break;
        }
      }
    }
    int vc = 0;
    bool ne = false;
    if (policy != 0) {
      int ev_rank = rank - n_empty;
      vc = (int)((vorder[i] >> (4 * clampi(ev_rank, 0, b - 1))) & 0xF);
      ne = ci && !fit && (ev_rank < b - n_empty);
    }
    vcol[i] = vc;
    col[i] = fit ? col_e : vc;
    placed[i] = (ci && fit) ? 1 : 0;
    need_ev[i] = ne ? 1 : 0;
    local += ne ? 1 : 0;
  }
  run = block_exclusive_scan(local, &total);
  int cap_ev = max_evict[0];
  for (int i = lo; i < hi; ++i) {
    run += need_ev[i];
    bool fin = need_ev[i] && (run - 1 < cap_ev);
    need_ev[i] = fin ? 1 : 0;
    if (fin) placed[i] = 1;
  }
}

extern "C" int tier_apply_member_launch(
    const void* sk, const void* ss, const void* sm, int k, const void* hot_keys,
    const void* meta, int m, int b, int blocked, const void* warm_keys,
    const void* lvl_child, const void* lvl_off, int levels, int width,
    const void* term_keys, const void* term_mark, int cap, int n_pad,
    const void* sp_keys, const void* sp_dead, const void* run_off, int runs,
    int s, int policy, void* in_warm,
    void* in_spill, void* ecol, void* flags, void* emask, void* vorder,
    void* stream) {
  if (k == 0) return 0;
  const int threads = 256;
  tier_apply_member_kernel<<<(k + threads - 1) / threads, threads, 0,
                             (cudaStream_t)stream>>>(
      (const u64*)sk, (const int*)ss, (const int8_t*)sm, k,
      (const u64*)hot_keys, (const int*)meta, m, b, blocked,
      (const u64*)warm_keys, (const int*)lvl_child, (const int*)lvl_off, levels,
      width, (const u64*)term_keys, (const int8_t*)term_mark, cap, n_pad,
      (const u64*)sp_keys, (const int8_t*)sp_dead, (const int*)run_off, runs, s,
      policy,
      (int8_t*)in_warm, (int8_t*)in_spill, (int*)ecol, (int8_t*)flags,
      (int*)emask, (u64*)vorder);
  return (int)cudaGetLastError();
}

extern "C" int tier_apply_scan_launch(
    int k, int b, int policy, const void* krs, const void* srs,
    const void* flags, const void* emask, const void* vorder,
    const void* max_evict, void* c1, void* c2, void* placed, void* exists,
    void* dup, void* need_ev, void* col, void* vcol, void* stream) {
  if (k == 0) return 0;
  tier_apply_scan_kernel<<<1, 1024, 0, (cudaStream_t)stream>>>(
      k, b, policy, (const int*)krs, (const int*)srs, (const int8_t*)flags,
      (const int*)emask, (const u64*)vorder, (const int*)max_evict, (int*)c1,
      (int*)c2, (int8_t*)placed, (int8_t*)exists, (int8_t*)dup,
      (int8_t*)need_ev, (int*)col, (int*)vcol);
  return (int)cudaGetLastError();
}
