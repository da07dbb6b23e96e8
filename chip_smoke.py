#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the KV store on one GPU and check it.

    python3 chip_smoke.py [--seed 0]

Phases (each prints its seconds; any failed check raises, so the exit code
is non-zero and no result line is printed):

1. Device and build: require CUDA, print the card's name and power limit
   (`nvidia-smi`), build the four CUDA kernels from `src/repro_torch/
   kernels/csrc/` (one `nvcc` per source, in parallel).
2. Kernels: each kernel's wrapper on CUDA tensors at the main path's
   shapes, held bit for bit against its plain PyTorch version on the same
   inputs (tier_find with and without spill; tier_apply under none / lru /
   size, with and without spill). Median time per call from CUDA events,
   the plain version's time, a library call's time where one computes the
   same function, the whole `gpu` dispatch's time (kernel plus glue) and
   the bound: the distinct 32-byte sectors the probes read, found by
   replaying each probe on this run's data, plus each per-lane input and
   output once, over the HBM rate.
3. Main path: `paper_kvstore`'s per-chip store (capacity 65,536, 4,096
   lanes) across the 256 chips of its 16x16 mesh folded onto one card,
   i.e. capacity 2^24. A seeded stream — a preload of 0.75 * 2^24 fresh
   keys in plans of 65,536 lanes, then 16 plans of Workload 1 (10% insert /
   90% find) and 16 of Workload 2 (plus 2% erase), 4,096 lanes each —
   runs through `StoreEngine` for det_skiplist (2^24), hash+skiplist
   (2^24), tiered3/lru (2^23: hot + 2^23 warm + 2^23 spill, so the spill
   runs and the lru victims are live) and fixed_hash (2^24), in exec modes
   `gpu` and `torch`. gpu == torch per plan and on the final state;
   det_skiplist == hash+skiplist == tiered3/lru == a host dict oracle per
   plan (fixed_hash drops inserts on full buckets: gpu vs torch only). The
   kernel launch counters are zeroed just before and read just after.
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
OP_FIND, OP_INSERT, OP_DELETE = 0, 1, 2
DEV = "cuda"
LOG2_CAPACITY = 24          # the flat store's capacity, 2^24 (see above)
PRELOAD_LANES = 65536
WL_LANES = 4096
WL_PLANS = 16
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
]
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


def kernel_phase(torch, seed: int):
    from repro_torch.core.bits import from_u64, ordered
    from repro_torch.core.layout import (hash_slot, skiplist_layout,
                                         spill_layout)
    from repro_torch.kernels.hash_probe.kernel import hash_probe_tiles
    from repro_torch.kernels.hash_probe.ref import hash_probe_ref
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
    rows = {}

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

    # tier_find, with and without spill
    for st, label in ((t3, "spill"), (t2, "no spill")):
        slots = hash_slot(q, st.hot.num_slots)
        wl = skiplist_layout(st.cold)
        sp = (None if st.spill is None else
              spill_layout(st.spill.keys, st.spill.dead, st.spill.run_start,
                           st.spill.n))
        got = tier_find_tiles(q, slots, st.hot.keys, wl, sp)
        err = max_abs_err(torch, got, tier_find_planes_ref(q, slots,
                                                           st.hot.keys, wl,
                                                           sp))
        check(err == 0, f"tier_find ({label}) differs from its plain version")
        if sp is not None:
            check(all(int(got[i].sum()) > 0 for i in (0, 2, 4)),
                  "tier_find hits every tier")
            reads = Reads()
            replay_matches(got, bucket_reads(torch, reads, q, slots,
                                             st.hot.keys, False)
                           + walk_reads(torch, reads, q, wl)
                           + spill_reads(torch, reads, q, sp), "tier_find")
            rows["tier_find"] = dict(
                max_abs_err=err,
                ms=median_ms(torch, lambda: tier_find_tiles(
                    q, slots, st.hot.keys, wl, sp)),
                plain_ms=median_ms(torch, lambda: tier_find_planes_ref(
                    q, slots, st.hot.keys, wl, sp), 5),
                library_ms=None,
                dispatch_ms=median_ms(torch, lambda: exec_.tier_find(
                    st.hot, st.cold, st.spill, q, mode="gpu")),
                bound=bound(torch, reads, T * (8 + 4 + 3 * (1 + 4))
                            + 4 * (len(wl.offsets) + sp.run_off.numel())))
        print(f"tier_find {label}: bit-identical", flush=True)

    # tier_apply: none / lru / size, with and without spill
    vals = from_u64(rng.integers(0, 2**64 - 1, T, dtype=np.uint64), DEV)
    mask = torch.from_numpy(rng.random(T) > 0.05).to(DEV)
    for st, label in ((t3, "spill"), (t2, "no spill")):
        inv, ss, sk, sv, sm, krs, srs = sorted_lanes(st.hot.num_slots, q,
                                                     vals, mask)
        wl = skiplist_layout(st.cold)
        sp = (None if st.spill is None else
              spill_layout(st.spill.keys, st.spill.dead, st.spill.run_start,
                           st.spill.n))
        for policy in ("none", "lru", "size"):
            for cap_ev in (T, 64):
                me = torch.tensor([cap_ev], dtype=torch.int32, device=DEV)
                args = (sk, ss, sm, krs, srs, st.hot.keys, st.hot_meta, wl,
                        me, sp, policy)
                got = tier_apply_tiles(*args)
                err = max_abs_err(torch, got, tier_apply_planes_ref(*args))
                check(err == 0, f"tier_apply ({policy}, {label}, cap "
                      f"{cap_ev}) differs from its plain version")
                if policy != "none" and cap_ev == T:
                    check(int(got[5].sum()) > 0, "some lanes evict")
                print(f"tier_apply {policy} {label} cap={cap_ev}: "
                      f"bit-identical (placed {int(got[2].sum())}, evict "
                      f"{int(got[5].sum())})", flush=True)
                if policy == "lru" and sp is not None and cap_ev == T:
                    mq = torch.where(sm != 0, sk, -1)
                    reads = Reads()
                    f_hot, _ = bucket_reads(torch, reads, mq, ss,
                                            st.hot.keys, True)
                    f_warm, _ = walk_reads(torch, reads, mq, wl)
                    spill_reads(torch, reads, mq, sp)
                    check(torch.equal(got[0].bool(), f_warm.bool()
                                      & (f_hot == 0) & (sm != 0)),
                          "tier_apply: the bound's replay differs")
                    cells = (ss.long()[:, None] * st.hot.bucket
                             + torch.arange(st.hot.bucket, device=DEV))
                    reads.add("meta", 4, cells)
                    rows["tier_apply"] = dict(
                        max_abs_err=err,
                        ms=median_ms(torch, lambda: tier_apply_tiles(*args)),
                        plain_ms=median_ms(
                            torch, lambda: tier_apply_planes_ref(*args), 5),
                        library_ms=None,
                        dispatch_ms=median_ms(torch, lambda: exec_.tier_apply(
                            st.hot, st.hot_meta, st.clock, st.cold, st.spill,
                            q, vals, mask, policy, me, mode="gpu")),
                        bound=bound(torch, reads, T * (8 + 4 + 1 + 4 + 4)
                                    + T * (6 + 3 * 4) + 4
                                    + 4 * (len(wl.offsets)
                                           + sp.run_off.numel())))
    for name, r in rows.items():
        r["bound_ms"], r["bound_by"] = r.pop("bound")
        print(f"kernel {name}: {r['ms']:.6f} ms/call (plain "
              f"{r['plain_ms']:.6f} ms, library {r['library_ms']}, bound "
              f"{r['bound_ms']:.7f} ms by {r['bound_by']}, "
              f"{r['ms'] / r['bound_ms']:.1f}x the bound) at {T} lanes; "
              f"whole gpu dispatch "
              f"{r['dispatch_ms']:.6f} ms, glue "
              f"{r['dispatch_ms'] - r['ms']:.6f} ms", flush=True)
    del flat, table, t3, t2
    torch.cuda.empty_cache()
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


def main_path(torch, plans, oracle, n_live):
    from repro_torch.convert import tree_leaves
    from repro_torch.core.bits import from_u64
    from repro_torch.kernels import cuda
    from repro_torch.store import exec as exec_
    from repro_torch.store.engine import StoreEngine
    C = 1 << LOG2_CAPACITY
    backends = [("det_skiplist", C), ("hash+skiplist", C),
                ("tiered3/lru", C // 2), ("fixed_hash", C)]
    dev_plans = [(tag, torch.from_numpy(ops).to(DEV), from_u64(k, DEV),
                  from_u64(v, DEV)) for tag, ops, k, v in plans]
    torch.cuda.synchronize()
    flat_results = []
    report = {}
    cuda.reset_launches()
    for name, cap in backends:
        t_be = time.perf_counter()
        engines = {(m, w): StoreEngine(w, name, exec_mode=m)
                   for m in ("gpu", "torch") for w in (PRELOAD_LANES,
                                                       WL_LANES)}
        states = {m: engines[(m, WL_LANES)].init(cap)
                  for m in ("gpu", "torch")}
        secs = {(m, t): 0.0 for m in states for t in ("preload", "wl")}
        lanes = {"preload": 0, "wl": 0}
        disp = {}
        for p, (tag, ops, keys, vals) in enumerate(dev_plans):
            t = "preload" if tag == "preload" else "wl"
            lanes[t] += ops.shape[0]
            res = {}
            for m in states:
                eng = engines[(m, ops.shape[0])]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with exec_.measure_dispatches() as meter:
                    states[m], rv, rok, _ = eng.step(states[m], ops, keys,
                                                     vals)
                torch.cuda.synchronize()
                secs[(m, t)] += time.perf_counter() - t0
                res[m] = (rok, rv)
                if m == "gpu":
                    disp[t] = (meter.n, meter.probe, meter.update)
            check(torch.equal(res["gpu"][0], res["torch"][0])
                  and torch.equal(res["gpu"][1], res["torch"][1]),
                  f"{name} plan {p}: gpu != torch")
            ok = res["gpu"][0].cpu().numpy()
            rv = res["gpu"][1].cpu().numpy().view(np.uint64)
            if name != "fixed_hash":
                check(np.array_equal(ok, oracle[p][0])
                      and np.array_equal(rv, oracle[p][1]),
                      f"{name} plan {p}: results differ from the dict oracle")
                if name == "det_skiplist":
                    flat_results.append((ok, rv))
                else:
                    check(np.array_equal(ok, flat_results[p][0])
                          and np.array_equal(rv, flat_results[p][1]),
                          f"{name} plan {p}: results differ from det_skiplist")
        for a, b in zip(tree_leaves(states["gpu"]),
                        tree_leaves(states["torch"])):
            check(torch.equal(a, b), f"{name}: final state gpu != torch")
        stats = {k: int(v) for k, v in
                 engines[("gpu", WL_LANES)].stats(states["gpu"]).items()
                 if k != "seq"}
        if name != "fixed_hash":
            check(stats["size"] == n_live, f"{name}: size {stats['size']} "
                  f"!= oracle {n_live}")
        row = {"capacity": cap, "stats": {k: v for k, v in stats.items()
                                          if v}}
        for m in states:
            for t in ("preload", "wl"):
                row[f"{m}_{t}_ops_per_s"] = lanes[t] / secs[(m, t)]
        row["dispatches_per_plan"] = {t: dict(zip(("n", "probe", "update"),
                                                  v)) for t, v in disp.items()}
        report[name] = row
        print(f"backend {name}: " + json.dumps(row), flush=True)
        print(f"backend {name}: {time.perf_counter() - t_be:.3f} s",
              flush=True)
        del states, engines
        torch.cuda.empty_cache()
    launches = dict(cuda.LAUNCHES)
    print("main-path launches: " + json.dumps(launches), flush=True)
    for name, _, _ in KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched on the "
              f"main path")
    return launches, report


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
    print(f"stream: {len(plans)} plans, {sum(len(p[1]) for p in plans)} "
          f"lanes; dict oracle {time.perf_counter() - t0:.3f} s", flush=True)
    launches, _ = main_path(torch, plans, oracle, n_live)
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
