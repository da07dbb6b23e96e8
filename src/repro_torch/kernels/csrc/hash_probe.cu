// Batched fixed-hash bucket probe for Hopper (sm_90a).
//
// Replaces the Pallas kernel `hash_probe_tiles` / `bucket_probe` in
// src/repro/kernels/hash_probe/kernel.py. The slot comes precomputed by
// `hash_slot` in the glue, as in the reference; the kernel reports whether
// the query's bucket row (slot clipped to [0, M - 1]) holds it, and the
// lowest column that does (0 on a miss).
//
// Design: a team of TEAM lanes a query reads the row in one round
// (`team_bucket_row`, probe.cuh: lane l reads columns l, l + TEAM, ...,
// every load issued at once) and ballots the matches; the column is the
// lowest set bit. The first design ran one thread a query through a loop
// that stopped at the first match, so it waited on up to four 32-byte
// sectors of the 128-byte row one after another, and a miss (every
// preload query is a fresh key) read the whole row so. The team width
// comes from the wrapper (kernel.py, `probe_team`): the widest of 16, 8,
// 4, 2 and 1 whose teams are all resident (`hash_probe_slots`).
//
// Bound: bytes. A probe reads one row of B 8-byte keys at a random slot
// (a 128-byte line at B = 16); at the preload width the rows of 65,536
// queries are 8 MB of lines that no cache holds, so the launch is bound by
// those sectors and their latency.
#include "probe.cuh"

#define HP_THREADS 256

template <int TEAM>
__global__ void __launch_bounds__(HP_THREADS, TEAM == 1 ? 4 : 8)
    hash_probe_kernel(const u64* __restrict__ q,
                      const int* __restrict__ slots, int t,
                      const u64* __restrict__ keys, int m, int b,
                      int8_t* __restrict__ found, int* __restrict__ col) {
  const long long qi =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / TEAM;
  const Team<TEAM> tm = this_team<TEAM>(qi < t);
  if (qi >= t) return;                 // whole teams leave together
  const unsigned hits =
      team_bucket_row(q[qi], slots[qi], keys, m, b, tm, nullptr);
  if (tm.lane == 0) {
    found[qi] = hits ? 1 : 0;
    col[qi] = hits ? __ffs(hits) - 1 : 0;
  }
}

// Resident threads an SM of the instance for `team` on the current device
// (the occupancy API), 0 for a width it does not have.
template <int TEAM>
static int hp_slots() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, hash_probe_kernel<TEAM>, HP_THREADS, 0) != cudaSuccess)
    return 0;
  return blocks * HP_THREADS;
}

extern "C" int hash_probe_slots(int team) {
  switch (team) {
    case 16: return hp_slots<16>();
    case 8: return hp_slots<8>();
    case 4: return hp_slots<4>();
    case 2: return hp_slots<2>();
    case 1: return hp_slots<1>();
    default: return 0;
  }
}

// `team` is the lanes a query: 16, 8, 4, 2 or 1 (kernel.py, `probe_team`);
// `b` <= MAX_BUCKET.
extern "C" int hash_probe_launch(const void* q, const void* slots, int t,
                                 const void* keys, int m, int b, void* found,
                                 void* col, int team, void* stream) {
  if (t == 0) return 0;
  if (b > MAX_BUCKET) return (int)cudaErrorInvalidValue;
  const int grid = (int)(((long long)t * team + HP_THREADS - 1) / HP_THREADS);
  cudaStream_t st = (cudaStream_t)stream;
#define HP_LAUNCH(T)                                                    \
  hash_probe_kernel<T><<<grid, HP_THREADS, 0, st>>>(                    \
      (const u64*)q, (const int*)slots, t, (const u64*)keys, m, b,      \
      (int8_t*)found, (int*)col)
  switch (team) {
    case 16: HP_LAUNCH(16); break;
    case 8: HP_LAUNCH(8); break;
    case 4: HP_LAUNCH(4); break;
    case 2: HP_LAUNCH(2); break;
    case 1: HP_LAUNCH(1); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef HP_LAUNCH
  return (int)cudaGetLastError();
}
