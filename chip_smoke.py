#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the KV store on one GPU and check it.

    python3 chip_smoke.py [--seed 0]

Phases (each prints its seconds; any failed check raises, so the exit code
is non-zero and no result line is printed):

1. Device and build: require CUDA, print the card's name and power limit
   (`nvidia-smi`), build the six CUDA kernels from `src/repro_torch/
   kernels/csrc/` (one `nvcc` per source, in parallel).
2. Kernels: each kernel's wrapper on CUDA tensors at the main path's
   shapes, held bit for bit against its plain PyTorch version on the same
   inputs: skiplist_search and bskiplist_walk on the flat 2^24 skiplist;
   hash_probe; tier_find with and without spill and tier_apply under
   none / lru / size, with and without spill, at eviction caps 4,096 and
   64, each in both warm layouts (level-major and block-major), the block
   layout also held against the level layout; pq_pop on a 2^24 heap with
   a tombstone run at its head, on a plan's pop ranks and on ranks past
   the live total. Median time per call from CUDA events, the plain
   version's time, a library call's time where one computes the same
   function, the whole `gpu` dispatch's time (kernel plus glue) and the
   bound: the distinct 32-byte sectors the kernel's work needs, found by
   replaying each probe on this run's data, plus each per-lane input and
   output once, over the HBM rate (a block walk is replayed as a binary
   search of each sorted 128-key node, and a block-layout row's bound is
   at most the level layout's on the same state and queries).
3. Main path: `paper_kvstore`'s per-chip store (capacity 65,536, 4,096
   lanes) across the 256 chips of its 16x16 mesh folded onto one card,
   i.e. capacity 2^24. A seeded stream — a preload of 0.75 * 2^24 fresh
   keys in plans of 65,536 lanes, then 16 plans of Workload 1 (10% insert /
   90% find) and 16 of Workload 2 (plus 2% erase), 4,096 lanes each —
   runs through `StoreEngine` for det_skiplist (2^24), hash+skiplist
   (2^24), tiered3/lru and tiered3/b128 (2^23: hot + 2^23 warm + 2^23
   spill, so the spill runs, the lru victims and the block walk's three
   index rows are live), the unfused twin of tiered3/b128 (gpu only; its
   warm probe is the bskiplist_walk kernel) and fixed_hash (2^24), in
   exec modes `gpu` and `torch`. gpu == torch per plan and on the final
   state; every ordered cell == det_skiplist == a host dict oracle per
   plan; the unfused twin's final state == tiered3/b128's (fixed_hash
   drops inserts on full buckets: gpu vs torch only). Then the `pq` cell,
   the serving scheduler's admission queue at capacity 2^24 on its own
   stream (`make_pq_stream`) against a host oracle of per-band FIFOs.
   Each cell's kernel launch counts are set to 0 just before it and read
   just after; every cell must launch its kernels (tiered3/b128 the
   block layout of tier_find and tier_apply and never the level layout).
4. A `kernels` JSON line, then the last line
   `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OP_NONE, OP_FIND, OP_INSERT, OP_DELETE = -1, 0, 1, 2
OP_POPMIN, OP_POPK, OP_RANGE_DELETE = 4, 5, 6
DEV = "cuda"
LOG2_CAPACITY = 24          # the flat store's capacity, 2^24 (see above)
PRELOAD_LANES = 65536
WL_LANES = 4096
WL_PLANS = 16
# the pq cell (make_pq_stream): capacity 2^24, preloaded half full, band 0
# (urgent) 32,768 keys of the preload; workload plans of 2,048 inserts,
# 1,024 POPMIN and 1,024 POPK, plus 64 finds in the second workload
PQ_LOG2_CAPACITY = 24
PQ_URGENT = 32768
PQ_INSERTS = 2048
PQ_POPS = 1024
PQ_FINDS = 64
PQ_CANCEL_PLANS = (7, 15)   # the second workload's plans 8 and 16
INVERSION_EVERY = 6         # serving/traffic.py: every 6th request urgent
RID_BASE = 1 << 40          # request ids: RID_BASE + ticket
# (name, path of the CUDA source, file:line of the TPU kernel it replaces)
KERNELS = [
    ("skiplist_search", "src/repro_torch/kernels/csrc/skiplist_search.cu",
     "src/repro/kernels/skiplist_search/kernel.py:72"),
    ("hash_probe", "src/repro_torch/kernels/csrc/hash_probe.cu",
     "src/repro/kernels/hash_probe/kernel.py:47"),
    ("tier_find", "src/repro_torch/kernels/csrc/tier_find.cu",
     "src/repro/kernels/tier_find/kernel.py:136"),
    ("tier_apply", "src/repro_torch/kernels/csrc/tier_apply.cu",
     "src/repro/kernels/tier_apply/kernel.py:253"),
    ("bskiplist_walk", "src/repro_torch/kernels/csrc/bskiplist_walk.cu",
     "src/repro/kernels/bskiplist_walk/kernel.py:75"),
    ("pq_pop", "src/repro_torch/kernels/csrc/pq_pop.cu",
     "src/repro/kernels/pq_pop/kernel.py:63"),
]
BOTH = ("gpu", "torch")
# the main path's cells on make_stream: (label, backend, capacity shift,
# exec modes, launch counts that must be > 0 in the cell); the unfused
# twin of tiered3/b128 is built by `tiers.unfused_twin`
MAIN_CELLS = [
    ("det_skiplist", "det_skiplist", 0, BOTH, ("skiplist_search",)),
    ("hash+skiplist", "hash+skiplist", 0, BOTH,
     ("tier_find/level", "tier_apply/level")),
    ("tiered3/lru", "tiered3/lru", 1, BOTH,
     ("tier_find/level", "tier_apply/level")),
    ("tiered3/b128", "tiered3/b128", 1, BOTH,
     ("tier_find/block", "tier_apply/block")),
    ("tiered3/b128 unfused", "tiered3/b128", 1, ("gpu",),
     ("bskiplist_walk", "hash_probe")),
    ("fixed_hash", "fixed_hash", 0, BOTH, ("hash_probe",)),
]
PQ_KERNELS = ("pq_pop", "skiplist_search")
SIGN = -(1 << 63)           # u64 order = signed order of x ^ SIGN
INF_ORDERED = (1 << 63) - 1  # KEY_INF in that order
SECTOR = 32                 # bytes: the smallest HBM transfer
# NVIDIA H100 SXM5 80 GB data sheet: HBM3 rate, and the float32 rate
# outside the tensor cores (the rate a key compare runs at, at most)
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def phase(name: str):
    t0 = time.perf_counter()
    print(f"== phase {name}", flush=True)
    return lambda: print(f"== phase {name}: {time.perf_counter() - t0:.3f} s",
                         flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def median_ms(torch, fn, reps: int = 15) -> float:
    """Median device time of one call of `fn`, from CUDA events. A sleep
    kernel ahead of each call keeps the device busy while the host
    enqueues, so the events bracket the call's own device work."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


class Reads:
    """The cells a probe reads, per buffer, gathered by the replays below
    for the bound. HBM moves whole 32-byte sectors, so a buffer's bytes
    are its DISTINCT sectors read: a cell that many queries share (the
    upper index levels, the first midpoints of a run's binary search)
    counts once. `n` counts cell reads, one key compare each."""

    def __init__(self):
        self.cells = {}
        self.n = 0

    def add(self, buf: str, size: int, idx, mask=None) -> None:
        idx = idx.reshape(-1) if mask is None else idx[mask]
        self.cells.setdefault(buf, (size, []))[1].append(idx.long())
        self.n += idx.numel()

    def sector_bytes(self, torch) -> int:
        return sum(SECTOR * torch.unique(torch.cat(parts) * size // SECTOR)
                   .numel() for size, parts in self.cells.values())


def bound(torch, reads: Reads, stream_bytes: int):
    """(bound_ms, bound_by): the larger of the bytes time (the distinct
    sectors the probes read, plus each per-lane input read once and each
    output written once) over the HBM rate, and the operations time (one
    compare per cell read) over the non-tensor-core rate."""
    t_bytes = (reads.sector_bytes(torch) + stream_bytes) / HBM_BYTES_PER_S
    t_ops = reads.n / OPS_PER_S
    return ((t_bytes * 1e3, "bytes") if t_bytes >= t_ops
            else (t_ops * 1e3, "operations"))


def walk_reads(torch, reads: Reads, q, lay):
    """Replay of `level_walk` (csrc/probe.cuh) on the flat level view,
    recording each cell it reads: per step the child start and the keys
    up to the first with q <= key (all four when none is; a read past a
    level's capacity is padding and reads nothing), then the terminal key
    and, on a key match, its mark. Returns (found int8, idx int32) so the
    replay is held against the kernel."""
    off, c1, L = lay.offsets, lay.c1, lay.num_levels
    cap = lay.term_keys.numel()
    fan = torch.arange(4, device=q.device)
    qo = (q ^ SIGN)[:, None]

    def first_le(keys):
        le = qo <= keys
        sel = le.to(torch.uint8).argmax(1)
        n = torch.where(le.any(1), sel + 1, 4)
        return sel, fan[None, :] < n[:, None]

    top = (off[L - 1] + fan).expand(q.numel(), 4)
    i, rd = first_le(lay.lvl_keys[top] ^ SIGN)
    reads.add("lvl_keys", 8, top, rd)
    for r in range(L - 1, -1, -1):
        ic = i.clamp(0, c1 - 1)
        cap_r = off[r + 1] - off[r]
        has = ic < cap_r
        at = off[r] + ic.clamp(max=cap_r - 1)
        reads.add("lvl_child", 4, at, has)
        start = torch.where(has, lay.lvl_child[at].long(), 0)
        if r == 0:
            pos = (start[:, None] + fan).clamp(0, cap - 1)
            sel, rd = first_le(lay.term_keys[pos] ^ SIGN)
            reads.add("term_keys", 8, pos, rd)
        else:
            pos = (start[:, None] + fan).clamp(0, c1 - 1)
            cap_b = off[r] - off[r - 1]
            inb = pos < cap_b
            at = off[r - 1] + pos.clamp(max=cap_b - 1)
            sel, rd = first_le(torch.where(inb, lay.lvl_keys[at] ^ SIGN,
                                           INF_ORDERED))
            reads.add("lvl_keys", 8, at, rd & inb)
        i = start + sel
    i = i.clamp(0, cap - 1)
    reads.add("term_keys", 8, i)
    hit = lay.term_keys[i] == q
    reads.add("term_mark", 1, i, hit)
    return ((hit & (lay.term_mark[i] == 0)).to(torch.int8),
            i.to(torch.int32))


def bucket_reads(torch, reads: Reads, q, slots, keys, whole_row: bool):
    """Replay of `bucket_probe`: the row's keys up to the first hit, the
    whole row on a miss or when `whole_row` (tier_apply reads the row
    again for its empty cells). Returns (found int8, col int32)."""
    m, b = keys.shape
    row = slots.long().clamp(0, m - 1)
    cols = torch.arange(b, device=q.device)
    eq = keys[row] == q[:, None]
    hit = eq.any(1)
    col = torch.where(hit, eq.to(torch.uint8).argmax(1), 0)
    rd = None if whole_row else cols[None, :] <= torch.where(hit, col,
                                                             b)[:, None]
    reads.add("hot_keys", 8, row[:, None] * b + cols, rd)
    return hit.to(torch.int8), col.to(torch.int32)


def spill_reads(torch, reads: Reads, q, sp):
    """Replay of `spill_probe`: each run's binary search, in run order
    until the first live match, then the searched cell's key and, on a
    key match, its tombstone. Returns (found int8, cell int32)."""
    keys, dead = sp.keys, sp.dead
    s = keys.numel()
    off = sp.run_off.tolist()
    ko, qo = keys ^ SIGN, q ^ SIGN
    active = torch.ones(q.numel(), dtype=torch.bool, device=q.device)
    found = torch.zeros_like(active)
    cell = None
    for r in range(len(off) - 1):
        end = off[r + 1]
        lo = torch.full(q.shape, off[r], dtype=torch.long, device=q.device)
        hi = torch.full_like(lo, end)
        for _ in range(max(end - off[r], 1).bit_length()):
            cont = active & (lo < hi)
            mid = (lo + hi) >> 1
            reads.add("sp_keys", 8, mid, cont)
            less = ko[mid.clamp(max=s - 1)] < qo
            lo = torch.where(cont & less, mid + 1, lo)
            hi = torch.where(cont & ~less, mid, hi)
        pos = lo.clamp(0, s - 1)
        if cell is None:
            cell = pos
        chk = active & (lo < end)
        reads.add("sp_keys", 8, pos, chk)
        eq = chk & (keys[pos] == q)
        reads.add("sp_dead", 1, pos, eq)
        live = eq & (dead[pos] == 0)
        cell = torch.where(live, pos, cell)
        found |= live
        active &= ~live
    return found.to(torch.int8), cell.to(torch.int32)


def block_reads(torch, reads: Reads, q, lay):
    """Replay of `block_walk` (csrc/probe.cuh) on the block-major view.
    Its outputs, held against the kernel, come from the kernel's own count
    of each 128-key node's entries below q. The cells it records for the
    bound are the ones a binary search of each node reads: every node row
    is sorted (the terminal keys are, tombstones staying in place and the
    `KEY_INF` padding at the end, and each index row takes every B-th
    entry of the row below), so the count is the node's searchsorted-left
    position, which the replay checks. Terminal cells at or past C are
    padding and read nothing; then the selected terminal key and, on a key
    match, its mark. Returns (found int8, idx int32)."""
    B = 128
    L, W = lay.blk.shape
    cap = lay.term_keys.numel()
    lanes = torch.arange(B, device=q.device)
    qo = (q ^ SIGN)[:, None]

    def node_count(buf, at, cells, node, limit):
        count = (node < qo).sum(1)
        lo, hi = torch.zeros_like(count), torch.full_like(count, B)
        for _ in range(B.bit_length()):
            cont = lo < hi
            mid = ((lo + hi) >> 1).clamp(max=B - 1)
            cell = cells[:, 0] + mid
            reads.add(buf, 8, at + cell, cont & (cell < limit))
            less = node.gather(1, mid[:, None])[:, 0] < qo[:, 0]
            lo = torch.where(cont & less, mid + 1, lo)
            hi = torch.where(cont & ~less, mid, hi)
        check(torch.equal(lo, count), f"block_reads: a {buf} node is not "
              f"sorted")
        return cells[:, 0] + count

    i = torch.zeros(q.numel(), dtype=torch.long, device=q.device)
    for r in range(L - 1, -1, -1):
        cells = (i.clamp(0, W // B - 1) * B)[:, None] + lanes
        i = node_count("blk", r * W, cells, lay.blk[r][cells] ^ SIGN, W)
    cells = (i.clamp(0, lay.n_pad // B - 1) * B)[:, None] + lanes
    tk = torch.where(cells < cap, lay.term_keys[cells.clamp(max=cap - 1)]
                     ^ SIGN, INF_ORDERED)
    i = node_count("term_keys", 0, cells, tk, cap).clamp(0, lay.n_pad - 1)
    has = i < cap
    ic = i.clamp(max=cap - 1)
    reads.add("term_keys", 8, ic, has)
    hit = has & (lay.term_keys[ic] == q)
    reads.add("term_mark", 1, ic, hit)
    found = torch.where(has, hit & (lay.term_mark[ic] == 0), q == -1)
    return found.to(torch.int8), i.to(torch.int32)


def pq_reads(torch, reads: Reads, ranks, mask, lay, found, idx):
    """The cells a rank select needs: the terminal keys and marks from the
    first cell to the furthest selected one (all of them when a masked-in
    rank exceeds the live total), then the level walk of each selected
    key, replayed and held against the kernel's idx."""
    tk, tm = lay.term_keys, lay.term_mark
    total = int(((tm == 0) & (tk != -1)).sum())
    want = ranks.long() + 1
    f = found.bool()
    if bool(((mask != 0) & (want > total)).any()):
        far = tk.numel()
    else:
        far = int(idx[f].max()) + 1 if bool(f.any()) else 0
    cells = torch.arange(far, device=tk.device)
    reads.add("term_keys", 8, cells)
    reads.add("term_mark", 1, cells)
    wf, wi = walk_reads(torch, reads, tk[idx[f].long()], lay)
    check(bool(wf.all()) and torch.equal(wi, idx[f]),
          "pq_pop: the bound's replay differs from the kernel")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def max_abs_err(torch, got, ref) -> int:
    check(len(got) == len(ref), "output count")
    err = 0
    for g, r in zip(got, ref):
        check(g.dtype == r.dtype and g.shape == r.shape, "output dtype/shape")
        if g.numel():
            err = max(err, int((g.long() - r.long()).abs().max()))
    return err


def build_kernel_inputs(torch, rng):
    """States at the main path's sizes, built with the port's own batch
    functions on the card: the flat skiplist (C = 2^LOG2_CAPACITY, 75%
    full, 0.5% tombstones), the fixed hash table, and a tiered3 stack at
    C / 2 whose spill tier holds several sorted runs with tombstones."""
    from repro_torch.core import det_skiplist as dsl
    from repro_torch.core import hashtable as ht
    from repro_torch.core.bits import from_u64
    from repro_torch.store import tiers
    C = 1 << LOG2_CAPACITY
    n = 3 * C // 4
    keys = np.unique(rng.integers(1, 2**64 - 2, n + n // 64, dtype=np.uint64))
    keys = rng.permutation(keys)[:n]
    tk = from_u64(keys, DEV)
    flat = dsl.skiplist_init(C, device=DEV)
    flat, _, _ = dsl.insert_batch(flat, tk, tk ^ 0x5A5A)
    flat, _ = dsl.delete_batch(flat, tk[: n // 200])
    table = ht.fixed_init(C // 16, 16, device=DEV)
    table, _, _ = ht.fixed_insert(table, tk, tk + 1)

    half = C // 2
    t3 = tiers.TIERED3.init(half, device=DEV)
    hot_n = t3.hot.keys.numel() * 9 // 10
    hot, _, _ = ht.fixed_insert(t3.hot, tk[:hot_n], tk[:hot_n] + 2)
    warm = dsl.skiplist_init(half, device=DEV)
    warm, _, _ = dsl.insert_batch(warm, tk[hot_n:hot_n + half * 7 // 8],
                                  tk[hot_n:hot_n + half * 7 // 8] + 3)
    sp = t3.spill
    run = half // 16
    base = hot_n + half * 7 // 8
    for r in range(6):
        part = tk[base + r * run: base + (r + 1) * run]
        sp, _ = tiers.spill_append(sp, part, part + 4,
                                   torch.ones_like(part, dtype=torch.bool))
    sp, _ = tiers.spill_discard(sp, tk[base: base + run // 10],
                                torch.ones(run // 10, dtype=torch.bool,
                                           device=DEV))
    meta = torch.from_numpy(rng.integers(0, 64, tuple(hot.keys.shape),
                                         dtype=np.int32)).to(DEV)
    t3 = t3._replace(hot=hot, hot_meta=meta, cold=warm, spill=sp)
    t2 = tiers.HASH_SKIPLIST.init(C, device=DEV)
    hot2, _, _ = ht.fixed_insert(t2.hot, tk[:hot_n], tk[:hot_n] + 2)
    t2 = t2._replace(hot=hot2, hot_meta=meta.repeat(2, 1), cold=flat)
    return keys, flat, table, t3, t2


def mixed_keys(rng, keys, width):
    """Lanes: 3/4 stored keys, the rest fresh; two in-batch duplicates."""
    fresh = rng.integers(1, 2**64 - 2, width, dtype=np.uint64)
    out = np.where(rng.random(width) < 0.75, rng.choice(keys, width), fresh)
    out[-2:] = out[:2]
    return out


def pq_preload(rng):
    """The pq cell's preload: tickets 0.. of capacity / 2 requests, band 0
    (urgent) holding PQ_URGENT of them and the rest split evenly over
    bands 1 and 2, in a seeded order. Returns (priority, ticket) uint64."""
    n = (1 << PQ_LOG2_CAPACITY) // 2
    rest = n - PQ_URGENT
    prio = np.repeat(np.arange(3, dtype=np.uint64),
                     [PQ_URGENT, rest // 2, rest - rest // 2])
    return rng.permutation(prio), np.arange(n, dtype=np.uint64)


def build_pq_heap(torch, rng):
    """The pq heap at the main path's size: the preload's priority keys in
    a 2^PQ_LOG2_CAPACITY skiplist, the smallest fifth of them popped, so
    a run of tombstones sits at the head, below the compaction
    threshold."""
    from repro_torch.core import det_skiplist as dsl
    from repro_torch.core.bits import from_u64
    prio, ticket = pq_preload(rng)
    tk = from_u64((prio << np.uint64(32)) | ticket, DEV)
    s = dsl.skiplist_init(1 << PQ_LOG2_CAPACITY, device=DEV)
    s, _, _ = dsl.insert_batch(s, tk, from_u64(RID_BASE + ticket, DEV))
    n_dead = ticket.size // 5
    ranks = torch.arange(n_dead, dtype=torch.int32, device=DEV)
    found, _, idx = dsl.pop_rank_select(s, ranks, torch.ones_like(
        ranks, dtype=torch.bool))
    s = dsl.pop_mark(s, idx, found)
    check(int(s.n_marked) == n_dead, "pq heap: the head tombstone run")
    return s


def print_row(name, r, lanes):
    print(f"kernel {name}: {r['ms']:.6f} ms/call (plain "
          f"{r['plain_ms']:.6f} ms, library {r['library_ms']}, bound "
          f"{r['bound_ms']:.7f} ms by {r['bound_by']}, "
          f"{r['ms'] / r['bound_ms']:.1f}x the bound) at {lanes} lanes; "
          f"whole gpu dispatch {r['dispatch_ms']:.6f} ms, glue "
          f"{r['dispatch_ms'] - r['ms']:.6f} ms", flush=True)


def kernel_phase(torch, seed: int):
    """Returns the rows of the six kernels (the tier kernels in the level
    layout); the block-layout rows of tier_find and tier_apply are
    printed. The bound of a block walk (bskiplist_walk, the block rows) is
    the smaller of its own and the level walk's on the same state and
    queries: both walks give the same answers, so the cheaper one is what
    the work needs."""
    from repro_torch.core.bits import from_u64, ordered
    from repro_torch.core.layout import (bskiplist_layout, hash_slot,
                                         skiplist_layout, spill_layout)
    from repro_torch.kernels.bskiplist_walk.kernel import bskiplist_walk_tiles
    from repro_torch.kernels.bskiplist_walk.ref import bskiplist_walk_ref
    from repro_torch.kernels.hash_probe.kernel import hash_probe_tiles
    from repro_torch.kernels.hash_probe.ref import hash_probe_ref
    from repro_torch.kernels.pq_pop.kernel import pq_pop_tiles
    from repro_torch.kernels.pq_pop.ref import pq_pop_ref
    from repro_torch.kernels.skiplist_search.kernel import skiplist_search_tiles
    from repro_torch.kernels.skiplist_search.ref import skiplist_search_ref
    from repro_torch.kernels.tier_apply.kernel import tier_apply_tiles
    from repro_torch.kernels.tier_apply.ops import sorted_lanes
    from repro_torch.kernels.tier_apply.ref import tier_apply_planes_ref
    from repro_torch.kernels.tier_find.kernel import tier_find_tiles
    from repro_torch.kernels.tier_find.ref import tier_find_planes_ref
    from repro_torch.store import exec as exec_
    rng = np.random.default_rng(seed)
    keys, flat, table, t3, t2 = build_kernel_inputs(torch, rng)
    torch.cuda.synchronize()
    T = WL_LANES
    q = from_u64(mixed_keys(rng, keys, T), DEV)
    q[5] = -1                                       # KEY_INF query
    rows, block_rows = {}, {}

    def replay_matches(got, replayed, name):
        check(max_abs_err(torch, got, replayed) == 0,
              f"{name}: the bound's replay differs from the kernel")

    # skiplist_search
    lay = skiplist_layout(flat)
    got = skiplist_search_tiles(q, lay)
    ref = skiplist_search_ref(q, lay)
    err = max_abs_err(torch, got, ref)
    check(err == 0, "skiplist_search differs from its plain version")
    check(int(got[0].sum()) > T // 2, "skiplist_search finds stored keys")
    level_found = got[0]
    reads = Reads()
    replay_matches(got, walk_reads(torch, reads, q, lay), "skiplist_search")
    oterm, oq = ordered(flat.term_keys), ordered(q)
    rows["skiplist_search"] = dict(
        max_abs_err=err,
        ms=median_ms(torch, lambda: skiplist_search_tiles(q, lay)),
        plain_ms=median_ms(torch, lambda: skiplist_search_ref(q, lay), 5),
        library_ms=median_ms(torch, lambda: torch.searchsorted(oterm, oq)),
        dispatch_ms=median_ms(torch, lambda: exec_.skiplist_find(
            flat, q, mode="gpu")),
        bound=bound(torch, reads, T * (8 + 1 + 4)
                    + 4 * len(lay.offsets)))

    # bskiplist_walk, on the same skiplist and queries
    blay = bskiplist_layout(flat)
    got = bskiplist_walk_tiles(q, blay)
    err = max_abs_err(torch, got, bskiplist_walk_ref(q, blay))
    check(err == 0, "bskiplist_walk differs from its plain version")
    check(torch.equal((got[0] != 0) & (q != -1), (level_found != 0)
                      & (q != -1)), "bskiplist_walk finds what "
          "skiplist_search finds")
    reads = Reads()
    replay_matches(got, block_reads(torch, reads, q, blay), "bskiplist_walk")
    rows["bskiplist_walk"] = dict(
        max_abs_err=err,
        ms=median_ms(torch, lambda: bskiplist_walk_tiles(q, blay)),
        plain_ms=median_ms(torch, lambda: bskiplist_walk_ref(q, blay), 5),
        library_ms=median_ms(torch, lambda: torch.searchsorted(oterm, oq)),
        dispatch_ms=median_ms(torch, lambda: exec_.bskiplist_find(
            flat, q, mode="gpu")),
        bound=bound(torch, reads, T * (8 + 1 + 4)))
    print(f"bskiplist_walk: {blay.num_levels} index rows of "
          f"{blay.blk.shape[1]} cells", flush=True)

    # hash_probe
    slots = hash_slot(q, table.num_slots)
    got = hash_probe_tiles(q, slots, table.keys)
    err = max_abs_err(torch, got, hash_probe_ref(q, slots, table.keys))
    check(err == 0, "hash_probe differs from its plain version")
    reads = Reads()
    replay_matches(got, bucket_reads(torch, reads, q, slots, table.keys,
                                     False), "hash_probe")
    rows["hash_probe"] = dict(
        max_abs_err=err,
        ms=median_ms(torch, lambda: hash_probe_tiles(q, slots, table.keys)),
        plain_ms=median_ms(torch, lambda: hash_probe_ref(q, slots,
                                                         table.keys), 5),
        library_ms=None,
        dispatch_ms=median_ms(torch, lambda: exec_.hash_find_cols(
            table, q, mode="gpu")),
        bound=bound(torch, reads, T * (8 + 4 + 1 + 4)))

    # tier_find, with and without spill, in both warm layouts
    for st, label in ((t3, "spill"), (t2, "no spill")):
        slots = hash_slot(q, st.hot.num_slots)
        sp = (None if st.spill is None else
              spill_layout(st.spill.keys, st.spill.dead, st.spill.run_start,
                           st.spill.n))
        outs = {}
        for warm_layout, wl in (("level", skiplist_layout(st.cold)),
                                ("block", bskiplist_layout(st.cold))):
            got = tier_find_tiles(q, slots, st.hot.keys, wl, sp)
            err = max_abs_err(torch, got, tier_find_planes_ref(
                q, slots, st.hot.keys, wl, sp))
            check(err == 0, f"tier_find ({label}, {warm_layout}) differs "
                  f"from its plain version")
            outs[warm_layout] = got
            if sp is None:
                continue
            check(all(int(got[i].sum()) > 0 for i in (0, 2, 4)),
                  "tier_find hits every tier")
            reads = Reads()
            walk = walk_reads if warm_layout == "level" else block_reads
            replay_matches(got, bucket_reads(torch, reads, q, slots,
                                             st.hot.keys, False)
                           + walk(torch, reads, q, wl)
                           + spill_reads(torch, reads, q, sp), "tier_find")
            table_bytes = 4 * (len(wl.offsets) if warm_layout == "level"
                               else 0)
            (rows if warm_layout == "level" else block_rows)["tier_find"] = \
                dict(max_abs_err=err,
                     ms=median_ms(torch, lambda: tier_find_tiles(
                         q, slots, st.hot.keys, wl, sp)),
                     plain_ms=median_ms(torch, lambda: tier_find_planes_ref(
                         q, slots, st.hot.keys, wl, sp), 5),
                     library_ms=None,
                     dispatch_ms=median_ms(torch, lambda: exec_.tier_find(
                         st.hot, st.cold, st.spill, q, mode="gpu",
                         warm_layout=warm_layout)),
                     bound=bound(torch, reads, T * (8 + 4 + 3 * (1 + 4))
                                 + table_bytes + 4 * sp.run_off.numel()))
        # raw outputs: the two walks agree on every hit; a KEY_INF query's
        # raw warm bit is the layout's own (the glue masks it)
        lv, bk = outs["level"], outs["block"]
        lf, bf = (lv[2] != 0) & (q != -1), (bk[2] != 0) & (q != -1)
        check(all(torch.equal(lv[i], bk[i]) for i in range(len(lv))
                  if i not in (2, 3))
              and torch.equal(lf, bf)
              and torch.equal(torch.where(lf, lv[3], 0),
                              torch.where(bf, bk[3], 0)),
              f"tier_find ({label}): the block layout differs from the "
              f"level layout")
        print(f"tier_find {label}: bit-identical, both layouts", flush=True)

    # tier_apply: none / lru / size, with and without spill, both layouts
    vals = from_u64(rng.integers(0, 2**64 - 1, T, dtype=np.uint64), DEV)
    mask = torch.from_numpy(rng.random(T) > 0.05).to(DEV)
    for st, label in ((t3, "spill"), (t2, "no spill")):
        inv, ss, sk, sv, sm, krs, srs = sorted_lanes(st.hot.num_slots, q,
                                                     vals, mask)
        sp = (None if st.spill is None else
              spill_layout(st.spill.keys, st.spill.dead, st.spill.run_start,
                           st.spill.n))
        warms = {"level": skiplist_layout(st.cold),
                 "block": bskiplist_layout(st.cold)}
        for policy in ("none", "lru", "size"):
            for cap_ev in (T, 64):
                me = torch.tensor([cap_ev], dtype=torch.int32, device=DEV)
                outs = {}
                for warm_layout, wl in warms.items():
                    args = (sk, ss, sm, krs, srs, st.hot.keys, st.hot_meta,
                            wl, me, sp, policy)
                    got = tier_apply_tiles(*args)
                    err = max_abs_err(torch, got,
                                      tier_apply_planes_ref(*args))
                    check(err == 0, f"tier_apply ({policy}, {label}, cap "
                          f"{cap_ev}, {warm_layout}) differs from its "
                          f"plain version")
                    outs[warm_layout] = got
                    if policy != "lru" or sp is None or cap_ev != T:
                        continue
                    mq = torch.where(sm != 0, sk, -1)
                    reads = Reads()
                    f_hot, _ = bucket_reads(torch, reads, mq, ss,
                                            st.hot.keys, True)
                    walk = (walk_reads if warm_layout == "level"
                            else block_reads)
                    f_warm, _ = walk(torch, reads, mq, wl)
                    spill_reads(torch, reads, mq, sp)
                    check(torch.equal(got[0].bool(), f_warm.bool()
                                      & (f_hot == 0) & (sm != 0)),
                          "tier_apply: the bound's replay differs")
                    cells = (ss.long()[:, None] * st.hot.bucket
                             + torch.arange(st.hot.bucket, device=DEV))
                    reads.add("meta", 4, cells)
                    table_bytes = 4 * (len(wl.offsets)
                                       if warm_layout == "level" else 0)
                    (rows if warm_layout == "level"
                     else block_rows)["tier_apply"] = dict(
                        max_abs_err=err,
                        ms=median_ms(torch, lambda: tier_apply_tiles(*args)),
                        plain_ms=median_ms(
                            torch, lambda: tier_apply_planes_ref(*args), 5),
                        library_ms=None,
                        dispatch_ms=median_ms(torch, lambda: exec_.tier_apply(
                            st.hot, st.hot_meta, st.clock, st.cold, st.spill,
                            q, vals, mask, policy, me, mode="gpu",
                            warm_layout=warm_layout)),
                        bound=bound(torch, reads, T * (8 + 4 + 1 + 4 + 4)
                                    + T * (6 + 3 * 4) + 4 + table_bytes
                                    + 4 * sp.run_off.numel()))
                check(max_abs_err(torch, outs["block"], outs["level"]) == 0,
                      f"tier_apply ({policy}, {label}, cap {cap_ev}): the "
                      f"block layout differs from the level layout")
                got = outs["block"]
                if policy != "none" and cap_ev == T:
                    check(int(got[5].sum()) > 0, "some lanes evict")
                print(f"tier_apply {policy} {label} cap={cap_ev}: "
                      f"bit-identical, both layouts (placed "
                      f"{int(got[2].sum())}, evict {int(got[5].sum())})",
                      flush=True)
    del flat, table, t3, t2
    torch.cuda.empty_cache()

    # pq_pop: a heap with a tombstone run at its head; a plan's pop lanes
    # (ranks 0..T/2-1 in a seeded lane order, the rest masked off), then
    # ranks straddling the live total, -1 ranks and masked-off lanes
    heap = build_pq_heap(torch, rng)
    lay = skiplist_layout(heap)
    total = int(heap.n_term - heap.n_marked)
    pop = torch.from_numpy(rng.permutation(T) < T // 2).to(DEV)
    ranks = torch.cumsum(pop.to(torch.int32), 0, dtype=torch.int32) - 1
    m8 = pop.to(torch.int8)
    ranks_x = (total - T // 2 + torch.arange(T, device=DEV)).to(torch.int32)
    ranks_x[:8] = -1
    mask_x = torch.from_numpy(rng.random(T) > 0.1).to(DEV).to(torch.int8)
    errs = []
    for r, m, label in ((ranks, m8, "plan"), (ranks_x, mask_x, "misses")):
        got = pq_pop_tiles(r, m, lay)
        errs.append(max_abs_err(torch, got, pq_pop_ref(r, m, lay)))
        check(errs[-1] == 0, f"pq_pop ({label}) differs from its plain "
              f"version")
        g = exec_.pq_pop(heap, r, m != 0, mode="gpu")
        t = exec_.pq_pop(heap, r, m != 0, mode="torch")
        check(all(torch.equal(a, b) for a, b in zip(g, t)),
              f"pq_pop ({label}): gpu dispatch != torch dispatch")
        n_found = int(got[0].sum())
        if label == "plan":
            check(n_found == int(m.sum()), "pq_pop: every pop lane of the "
                  "plan is found")
        print(f"pq_pop {label}: bit-identical ({n_found} found of "
              f"{int(m.sum())} masked-in lanes, live total {total})",
              flush=True)
    check(0 < n_found < int(mask_x.sum()), "pq_pop: misses and hits")
    got = pq_pop_tiles(ranks, m8, lay)
    reads = Reads()
    pq_reads(torch, reads, ranks, m8, lay, got[0], got[1])
    rows["pq_pop"] = dict(
        max_abs_err=max(errs),
        ms=median_ms(torch, lambda: pq_pop_tiles(ranks, m8, lay)),
        plain_ms=median_ms(torch, lambda: pq_pop_ref(ranks, m8, lay), 5),
        library_ms=None,
        dispatch_ms=median_ms(torch, lambda: exec_.pq_pop(
            heap, ranks, pop, mode="gpu")),
        bound=bound(torch, reads, T * (4 + 1 + 1 + 4)
                    + 4 * len(lay.offsets)))
    del heap, lay
    torch.cuda.empty_cache()

    for name, r, lv in ([("bskiplist_walk", rows["bskiplist_walk"],
                          rows["skiplist_search"])]
                        + [(f"{k}/block", r, rows[k])
                           for k, r in block_rows.items()]):
        print(f"{name}: bound {r['bound'][0]:.7f} ms by the block walk's "
              f"reads, {lv['bound'][0]:.7f} ms by the level walk's",
              flush=True)
        r["bound"] = min(r["bound"], lv["bound"])
    for name, r in list(rows.items()) + [(f"{k}/block", v)
                                         for k, v in block_rows.items()]:
        r["bound_ms"], r["bound_by"] = r.pop("bound")
        print_row(name, r, T)
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def make_stream(seed: int):
    """The seeded plan stream: preload, Workload 1, Workload 2, as
    (tag, ops int32, keys uint64, vals uint64) per plan."""
    rng = np.random.default_rng(seed)
    n_pre = 3 * (1 << LOG2_CAPACITY) // 4
    n_fresh = WL_PLANS * 2 * (WL_LANES // 10)
    keys = np.unique(rng.integers(1, 2**64 - 2, n_pre + n_fresh + 4096,
                                  dtype=np.uint64))
    keys = rng.permutation(keys)
    pre, fresh = keys[:n_pre], keys[n_pre:n_pre + n_fresh]
    plans = []
    for i in range(0, n_pre, PRELOAD_LANES):
        k = pre[i:i + PRELOAD_LANES]
        plans.append(("preload", np.full(len(k), OP_INSERT, np.int32), k,
                      rng.integers(0, 2**64 - 1, len(k), dtype=np.uint64)))
    n_ins = WL_LANES // 10
    n_del = WL_LANES // 50
    f = 0
    for wl, erase in (("wl1", False), ("wl2", True)):
        for _ in range(WL_PLANS):
            nd = n_del if erase else 0
            ops = np.concatenate([np.full(n_ins, OP_INSERT, np.int32),
                                  np.full(nd, OP_DELETE, np.int32),
                                  np.full(WL_LANES - n_ins - nd, OP_FIND,
                                          np.int32)])
            k = np.concatenate([fresh[f:f + n_ins],
                                rng.choice(pre, WL_LANES - n_ins)])
            f += n_ins
            perm = rng.permutation(WL_LANES)
            plans.append((wl, ops[perm], k[perm],
                          rng.integers(0, 2**64 - 1, WL_LANES,
                                       dtype=np.uint64)))
    return plans


def dict_oracle(plans):
    """Host-side reference semantics, sharing no code with the port:
    inserts (insert-if-absent, first lane wins), then deletes, then finds.
    Returns per plan (ok bool[K], vals uint64[K])."""
    d = {}
    out = []
    for _, ops, keys, vals in plans:
        ok = np.zeros(len(ops), bool)
        res = np.zeros(len(ops), np.uint64)
        kl, vl = keys.tolist(), vals.tolist()
        for i in np.flatnonzero(ops == OP_INSERT).tolist():
            if kl[i] in d:
                ok[i], res[i] = True, 1
            else:
                d[kl[i]] = vl[i]
                ok[i] = True
        for i in np.flatnonzero(ops == OP_DELETE).tolist():
            if kl[i] in d:
                del d[kl[i]]
                ok[i] = True
        for i in np.flatnonzero(ops == OP_FIND).tolist():
            v = d.get(kl[i])
            if v is not None:
                ok[i], res[i] = True, v
        out.append((ok, res))
    return out, len(d)


def make_pq_stream(seed: int):
    """The pq cell: the serving scheduler's admission queue (keys
    (priority << 32) | ticket with one monotone ticket counter, values the
    request ids RID_BASE + ticket), with its expected results from a host
    oracle of per-band FIFOs that shares no code with the port.

    Preload: capacity / 2 requests in plans of PRELOAD_LANES inserts
    (`pq_preload`). Workload P1: WL_PLANS plans of PQ_INSERTS fresh
    requests (priority 0 for every INVERSION_EVERY-th ticket, else 1 or
    2), PQ_POPS POPMIN and PQ_POPS POPK lanes in a seeded order. Workload
    P2: the same plus PQ_FINDS finds, half on pending and half on popped
    keys, and one more lane: idle, or in plans PQ_CANCEL_PLANS the band-2
    cancel (`serving/scheduler.py: cancel_class`), a RANGE_DELETE over
    [2 << 32, 3 << 32). Linearization per plan: inserts, the cancel, the
    pops in lane order (the j-th pop lane takes the j-th smallest live
    key), then the finds. Returns (plans, expected (ok, vals) per plan,
    final {size, pops, pop_empty})."""
    rng = np.random.default_rng(seed)
    prio, ticket = pq_preload(rng)
    n_all = ticket.size + 2 * WL_PLANS * PQ_INSERTS
    prio_of = np.zeros(n_all, np.uint64)
    prio_of[:ticket.size] = prio
    live = np.zeros(n_all, bool)
    bands = [ticket[prio == b] for b in range(3)]   # FIFO = ticket order
    heads = [0, 0, 0]
    popped_log = []
    counters = {"pops": 0, "pop_empty": 0}
    key_of = lambda t: (prio_of[t] << np.uint64(32)) | t.astype(np.uint64)
    plans, expect = [], []
    for i in range(0, ticket.size, PRELOAD_LANES):
        t = ticket[i:i + PRELOAD_LANES]
        plans.append(("preload", np.full(t.size, OP_INSERT, np.int32),
                      key_of(t), RID_BASE + t))
        expect.append((np.ones(t.size, bool), np.zeros(t.size, np.uint64)))
    live[:ticket.size] = True
    nxt = ticket.size
    for wl in ("pq1", "pq2"):
        for p in range(WL_PLANS):
            new = np.arange(nxt, nxt + PQ_INSERTS, dtype=np.uint64)
            nxt += PQ_INSERTS
            urgent = (new + 1) % INVERSION_EVERY == 0
            prio_of[new] = np.where(urgent, 0, rng.integers(
                1, 3, new.size)).astype(np.uint64)
            ops = [np.full(new.size, OP_INSERT, np.int32),
                   np.full(PQ_POPS, OP_POPMIN, np.int32),
                   np.full(PQ_POPS, OP_POPK, np.int32)]
            keys = [key_of(new), np.zeros(2 * PQ_POPS, np.uint64)]
            vals = [RID_BASE + new, np.zeros(2 * PQ_POPS, np.uint64)]
            if wl == "pq2":
                probe = rng.integers(0, nxt - new.size, 8 * PQ_FINDS)
                pend = probe[live[probe]][:PQ_FINDS // 2]
                gone = (rng.choice(np.concatenate(popped_log), PQ_FINDS
                                   - pend.size) if popped_log else
                        probe[:PQ_FINDS - pend.size])
                f = np.concatenate([pend, gone]).astype(np.uint64)
                cancel = p in PQ_CANCEL_PLANS
                ops += [np.full(PQ_FINDS, OP_FIND, np.int32),
                        np.array([OP_RANGE_DELETE if cancel else OP_NONE],
                                 np.int32)]
                keys += [key_of(f), np.array([2 << 32], np.uint64)]
                vals += [np.zeros(PQ_FINDS, np.uint64),
                         np.array([3 << 32], np.uint64)]
            perm = rng.permutation(sum(o.size for o in ops))
            ops = np.concatenate(ops)[perm]
            keys = np.concatenate(keys)[perm]
            vals = np.concatenate(vals)[perm]
            plans.append((wl, ops, keys, vals))

            # the oracle, in linearization order
            ok = np.zeros(ops.size, bool)
            res = np.zeros(ops.size, np.uint64)
            ins = ops == OP_INSERT
            ok[ins] = True
            live[new] = True
            for b in range(3):
                bands[b] = np.concatenate([bands[b], new[prio_of[new] == b]])
            rd = np.flatnonzero(ops == OP_RANGE_DELETE)
            if rd.size:
                gone_t = bands[2][heads[2]:]
                live[gone_t] = False
                heads[2] = bands[2].size
                ok[rd], res[rd] = gone_t.size > 0, gone_t.size
            pops = np.flatnonzero((ops == OP_POPMIN) | (ops == OP_POPK))
            take = []
            for b in range(3):
                n = min(pops.size - sum(x.size for x in take),
                        bands[b].size - heads[b])
                take.append(bands[b][heads[b]:heads[b] + n])
                heads[b] += n
            took = np.concatenate(take)
            live[took] = False
            popped_log.append(took)
            hit = pops[:took.size]
            ok[hit] = True
            res[hit] = np.where(ops[hit] == OP_POPMIN, RID_BASE + took,
                                key_of(took))
            counters["pops"] += took.size
            counters["pop_empty"] += pops.size - took.size
            fi = np.flatnonzero(ops == OP_FIND)
            ft = keys[fi] & np.uint64(0xFFFFFFFF)
            ok[fi] = live[ft]
            res[fi] = np.where(live[ft], RID_BASE + ft, 0)
            expect.append((ok, res))
    counters["size"] = int(live.sum())
    return plans, expect, counters


def to_device(torch, plans):
    from repro_torch.core.bits import from_u64
    return [(tag, torch.from_numpy(ops).to(DEV), from_u64(k, DEV),
             from_u64(v, DEV)) for tag, ops, k, v in plans]


def run_cell(torch, label, backend, cap, modes, dev_plans, on_plan):
    """Drive one cell: every plan through a `StoreEngine` per exec mode,
    gpu == torch per plan and on the final state, `on_plan(p, ok, vals)`
    on the gpu results (numpy). The launch counts are set to 0 just
    before the cell and read just after. Returns (report row, final
    states by mode, stats, launches)."""
    from repro_torch.convert import tree_leaves
    from repro_torch.kernels import cuda
    from repro_torch.store import exec as exec_
    from repro_torch.store.engine import StoreEngine
    t_be = time.perf_counter()
    widths = sorted({ops.shape[0] for _, ops, _, _ in dev_plans})
    engines = {(m, w): StoreEngine(w, backend, device=DEV, exec_mode=m)
               for m in modes for w in widths}
    states = {m: engines[(m, widths[0])].init(cap) for m in modes}
    secs = {(m, t): 0.0 for m in modes for t in ("preload", "wl")}
    lanes = {"preload": 0, "wl": 0}
    disp = {}
    torch.cuda.synchronize()
    cuda.reset_launches()
    for p, (tag, ops, keys, vals) in enumerate(dev_plans):
        t = "preload" if tag == "preload" else "wl"
        lanes[t] += ops.shape[0]
        res = {}
        for m in modes:
            eng = engines[(m, ops.shape[0])]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with exec_.measure_dispatches() as meter:
                states[m], rv, rok, _ = eng.step(states[m], ops, keys, vals)
            torch.cuda.synchronize()
            secs[(m, t)] += time.perf_counter() - t0
            res[m] = (rok, rv)
            if m == "gpu":
                disp[t] = (meter.n, meter.probe, meter.update)
        if "torch" in modes:
            check(torch.equal(res["gpu"][0], res["torch"][0])
                  and torch.equal(res["gpu"][1], res["torch"][1]),
                  f"{label} plan {p}: gpu != torch")
        on_plan(p, res["gpu"][0].cpu().numpy(),
                res["gpu"][1].cpu().numpy().view(np.uint64))
    torch.cuda.synchronize()
    launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    if "torch" in modes:
        for a, b in zip(tree_leaves(states["gpu"]),
                        tree_leaves(states["torch"])):
            check(torch.equal(a, b), f"{label}: final state gpu != torch")
    stats = {k: int(v) for k, v in
             engines[("gpu", widths[0])].stats(states["gpu"]).items()
             if k != "seq"}
    row = {"capacity": cap, "stats": {k: v for k, v in stats.items() if v}}
    for m in modes:
        for t in ("preload", "wl"):
            row[f"{m}_{t}_ops_per_s"] = lanes[t] / secs[(m, t)]
    row["dispatches_per_plan"] = {t: dict(zip(("n", "probe", "update"), v))
                                  for t, v in disp.items()}
    row["launches"] = launches
    print(f"backend {label}: " + json.dumps(row), flush=True)
    print(f"backend {label}: {time.perf_counter() - t_be:.3f} s", flush=True)
    return row, states, stats, launches


def main_path(torch, plans, oracle, n_live, pq_plans, pq_expect, pq_final):
    """Every cell of the main path, each checked; returns the launches per
    kernel summed over the cells."""
    from repro_torch.convert import tree_leaves
    from repro_torch.kernels import cuda
    from repro_torch.store import tiers
    C = 1 << LOG2_CAPACITY
    dev_plans = to_device(torch, plans)
    torch.cuda.synchronize()
    flat_results = []
    totals = {k: 0 for k in cuda.LAUNCHES}
    b128_final = None

    def check_ordered(label):
        def on_plan(p, ok, rv):
            check(np.array_equal(ok, oracle[p][0])
                  and np.array_equal(rv, oracle[p][1]),
                  f"{label} plan {p}: results differ from the dict oracle")
            if label == "det_skiplist":
                flat_results.append((ok, rv))
            else:
                check(np.array_equal(ok, flat_results[p][0])
                      and np.array_equal(rv, flat_results[p][1]),
                      f"{label} plan {p}: results differ from det_skiplist")
        return on_plan

    def expect_launches(label, launches, names):
        for name in names:
            check(launches.get(name, 0) > 0, f"kernel {name} never "
                  f"launched in the {label} cell")
        for k, v in launches.items():
            totals[k] += v

    for label, name, shift, modes, need in MAIN_CELLS:
        backend = (tiers.unfused_twin(name) if label.endswith("unfused")
                   else name)
        on_plan = ((lambda p, ok, rv: None) if name == "fixed_hash"
                   else check_ordered(label))
        _, states, stats, launches = run_cell(
            torch, label, backend, C >> shift, modes, dev_plans, on_plan)
        expect_launches(label, launches, need)
        if name != "fixed_hash":
            check(stats["size"] == n_live, f"{label}: size {stats['size']} "
                  f"!= oracle {n_live}")
        if label == "tiered3/b128":
            check(not launches.get("tier_find/level")
                  and not launches.get("tier_apply/level"),
                  "tiered3/b128 ran the level-major walk")
            b128_final = states["gpu"]
        elif label == "tiered3/b128 unfused":
            for a, b in zip(tree_leaves(states["gpu"]),
                            tree_leaves(b128_final)):
                check(torch.equal(a, b), "tiered3/b128: unfused final "
                      "state != fused")
            b128_final = None
        del states
        torch.cuda.empty_cache()
    del dev_plans

    def check_pq(p, ok, rv):
        check(np.array_equal(ok, pq_expect[p][0])
              and np.array_equal(rv, pq_expect[p][1]),
              f"pq plan {p}: results differ from the per-band FIFO oracle")

    _, states, stats, launches = run_cell(
        torch, "pq", "pq", 1 << PQ_LOG2_CAPACITY, BOTH,
        to_device(torch, pq_plans), check_pq)
    expect_launches("pq", launches, PQ_KERNELS)
    for k, v in pq_final.items():
        check(stats[k] == v, f"pq: {k} {stats[k]} != oracle {v}")
    del states
    torch.cuda.empty_cache()
    print("main-path launches: " + json.dumps(totals), flush=True)
    return totals


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import cuda as rt

    done = phase("1 device and build")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, "nvidia-smi")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}",
          flush=True)
    t0 = time.perf_counter()
    rt.build_all()
    for name, _, _ in KERNELS:
        rt.library(name)
    print(f"build: {time.perf_counter() - t0:.3f} s", flush=True)
    done()

    done = phase("2 kernels")
    rows = kernel_phase(torch, args.seed + 1)
    done()

    done = phase("3 main path")
    plans = make_stream(args.seed)
    t0 = time.perf_counter()
    oracle, n_live = dict_oracle(plans)
    pq_plans, pq_expect, pq_final = make_pq_stream(args.seed)
    print(f"stream: {len(plans)} plans, {sum(len(p[1]) for p in plans)} "
          f"lanes; pq stream: {len(pq_plans)} plans, "
          f"{sum(len(p[1]) for p in pq_plans)} lanes, final {pq_final}; "
          f"oracles {time.perf_counter() - t0:.3f} s", flush=True)
    launches = main_path(torch, plans, oracle, n_live, pq_plans, pq_expect,
                         pq_final)
    done()

    out = []
    for name, source, replaces in KERNELS:
        r = rows[name]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
