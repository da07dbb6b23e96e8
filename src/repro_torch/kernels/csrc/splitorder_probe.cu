// Two-level split-order FIND for Hopper (sm_90a).
//
// Replaces the Pallas kernel `splitorder_probe_tiles` / `table_search` in
// src/repro/kernels/splitorder_probe/kernel.py. Per query: the
// searchsorted-left position of its bit-reversed hash in its table's row
// [tbl * C2, tbl * C2 + C2) of the rk plane (the table clipped to
// [0, T - 1]; the row sorted by rk, KEY_INF padding last), then the first
// (rk, key) match among the WINDOW cells clip(pos + w, 0, C2 - 1); `at` is
// clip(pos + w) of that match, clip(pos) on a miss. Keys and rk are the
// state's own int64 planes, compared here as unsigned 64-bit integers:
// there is no (hi, lo) split.
//
// Design: a team of TEAM lanes a query searches the row (TEAM + 1)-ary
// (`team_kary_search`, probe.cuh, the body the tier kernels' spill search
// runs on each run, here with integer pivots over a constant divisor)
// down to a few cells, then reads those cells and the WINDOW cells after
// them in one round: they hold q's position (the cells below q) and its
// window, whose keys are read only behind an rk match; the first match is
// the lowest set bit of a ballot. The first design ran one thread a query
// through a binary search, 22 dependent loads at C2 = 2^21, then the
// window's WINDOW more one after another. The team width comes from the
// wrapper (kernel.py, `probe_team`): the widest of 16, 8 and 1 whose teams
// are all resident (`splitorder_probe_slots`), so a 4,096-lane plan runs
// teams of 16 (5 rounds) and a 65,536-lane one a thread a query (20: a
// binary search to 4 cells, then 8 cells at once). There are no instances
// of 32, 4 and 2 lanes: on the H100 32 lanes ran slower than 16 at 4,096
// lanes, and at 65,536 every team ran slower than one thread, the wider
// the slower (PERF.md): there the launch is bound by the sectors its
// pivots read, a team of g reading g a round.
//
// Bound: memory latency at the workload width, and at the preload width
// the sector reads of the searches: the first pivots of a table are shared
// by every query of that table and stay in L1 and L2, the deep rounds' are
// distinct random sectors. Reading the window's keys only behind an rk
// match keeps a fresh key's probe to its rk sectors.
#include "probe.cuh"

#define WINDOW 4  // must equal core.splitorder.WINDOW
#define SO_THREADS 256
#define SO_MAX_ROW (1 << 27)  // cells a row: the integer pivots' limit

// A team of one holds its last round's 8 cells in registers: it gets up to
// 64 (under the 32 of 8 blocks an SM it spilled and ran 1.4% slower at
// 65,536 lanes, PERF.md).
template <int TEAM>
__global__ void __launch_bounds__(SO_THREADS, TEAM == 1 ? 4 : 8)
    splitorder_probe_kernel(const u64* __restrict__ q_rk,
                            const u64* __restrict__ q_key,
                            const int* __restrict__ tables, int t,
                            const u64* __restrict__ rk,
                            const u64* __restrict__ keys, int n_tables,
                            int c2, int8_t* __restrict__ found,
                            int* __restrict__ at) {
  // the search narrows the row to at most F cells; then one round reads
  // them and the WINDOW cells after them, J a lane (cell i on lane
  // i % TEAM), which hold both q's position and its window (a team of one
  // reads 8 cells: 2 rounds of its binary search and the window's)
  constexpr int J = TEAM == 1 ? 2 * WINDOW : 2;
  constexpr int F = J * TEAM - WINDOW;
  const long long qi =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / TEAM;
  const Team<TEAM> tm = this_team<TEAM>(qi < t);
  if (qi >= t) return;                 // whole teams leave together
  const u64 qr = q_rk[qi];
  const long long base = (long long)clampi(tables[qi], 0, n_tables - 1) * c2;
  const u64* row = rk + base;
  NoSide none;
  int lo = 0, hi = c2;
  team_kary_search<TEAM, true>(qr, row, lo, hi, F, kary_group(tm, 1), tm,
                               none);
  const int n = hi - lo;
  u64 cell[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = tm.lane + j * TEAM;
    cell[j] = i < n + WINDOW ? row[clampi(lo + i, 0, c2 - 1)] : 0;
  }
  int below = 0;                       // cells of [lo, hi) below q
#pragma unroll
  for (int j = 0; j < J; ++j)
    below += __popc(team_ballot(tm, tm.lane + j * TEAM < n && cell[j] < qr));
  // window cell w is cell below + w: its key is read only behind an rk
  // match (a fresh key's window reads no key); bit i of `hits` = cell i
  const u64 qk = q_key[qi];
  unsigned hits = 0;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = tm.lane + j * TEAM;
    const bool win = i >= below && i < below + WINDOW && cell[j] == qr;
    hits |= team_ballot(tm, win && keys[base + clampi(lo + i, 0, c2 - 1)] ==
                                       qk) << (j * TEAM);
  }
  hits >>= below;
  if (tm.lane == 0) {
    found[qi] = hits ? 1 : 0;
    at[qi] = clampi(lo + below + (hits ? __ffs(hits) - 1 : 0), 0, c2 - 1);
  }
}

// Resident threads an SM of the instance for `team` on the current device
// (the occupancy API), 0 for a width it does not have.
template <int TEAM>
static int so_slots() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, splitorder_probe_kernel<TEAM>, SO_THREADS, 0) !=
      cudaSuccess)
    return 0;
  return blocks * SO_THREADS;
}

extern "C" int splitorder_probe_slots(int team) {
  switch (team) {
    case 16: return so_slots<16>();
    case 8: return so_slots<8>();
    case 1: return so_slots<1>();
    default: return 0;
  }
}

// `team` is the lanes a query: 16, 8 or 1 (kernel.py, `probe_team`).
extern "C" int splitorder_probe_launch(const void* q_rk, const void* q_key,
                                       const void* tables, int t,
                                       const void* rk, const void* keys,
                                       int n_tables, int c2, void* found,
                                       void* at, int team, void* stream) {
  if (t == 0) return 0;
  if (c2 >= SO_MAX_ROW) return (int)cudaErrorInvalidValue;
  const int grid = (int)(((long long)t * team + SO_THREADS - 1) / SO_THREADS);
  cudaStream_t st = (cudaStream_t)stream;
#define SO_LAUNCH(T)                                                      \
  splitorder_probe_kernel<T><<<grid, SO_THREADS, 0, st>>>(                \
      (const u64*)q_rk, (const u64*)q_key, (const int*)tables, t,         \
      (const u64*)rk, (const u64*)keys, n_tables, c2, (int8_t*)found,     \
      (int*)at)
  switch (team) {
    case 16: SO_LAUNCH(16); break;
    case 8: SO_LAUNCH(8); break;
    case 1: SO_LAUNCH(1); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SO_LAUNCH
  return (int)cudaGetLastError();
}
