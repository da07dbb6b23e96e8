"""MWMR hash tables (paper §VII), PyTorch port of `repro.core.hashtable`:
the fixed-slot table (version 1) and the two-level table (version 2).

A bucket is one contiguous `[B]`-wide row of an `[M, B]` key plane. A
batch linearizes by a stable (slot, key) lane sort; in-batch duplicates
resolve to the lowest lane and within-slot ranks come from a segmented
cumsum that hands out distinct empty columns. Keys are int64 bit patterns
(`core.bits`).

Two-level: every L1 slot has an inline bucket; overflow expands the slot
into an L2 table block allocated from a `core.blockpool` pool (the
paper's per-slot memory manager), hashed by the NEXT log2(M2) bits of the
same hash.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.bits import EMPTY, dup_in_run, hash64, ordered, shr
from repro_torch.core.blockpool import BlockPool, blockpool_init, pool_alloc
from repro_torch.core.layout import (block_arrays, first_true, hash_slot,
                                     inverse_perm, is_pow2, kv_arrays,
                                     scatter_drop)


def _lex_sort_slots_keys(slots: torch.Tensor, keys: torch.Tensor):
    """Stable lexicographic argsort by (slot, key): sort by key, then
    stable sort by slot."""
    o1 = torch.argsort(ordered(keys), stable=True)
    o2 = torch.argsort(slots[o1], stable=True)
    return o1[o2]


def _batch_plan(slots: torch.Tensor, keys: torch.Tensor, mask: torch.Tensor):
    """Shared linearization plan: (order, sorted slots/keys/mask, in-batch
    duplicate mask, slot-run starts, inverse permutation)."""
    dev = keys.device
    order = _lex_sort_slots_keys(slots, keys)
    ss, sk, sm = slots[order], keys[order], mask[order]
    same = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                      (sk[1:] == sk[:-1]) & (ss[1:] == ss[:-1])])
    dup = dup_in_run(same, sm)
    run_start = torch.searchsorted(ss, ss, out_int32=True)
    return order, ss, sk, sm, dup, run_start, inverse_perm(order)


def _seg_rank(cand: torch.Tensor, run_start: torch.Tensor) -> torch.Tensor:
    """0-based rank of each candidate lane within its slot run."""
    ci = cand.to(torch.int32)
    c = torch.cumsum(ci, 0, dtype=torch.int32)
    before = torch.where(run_start > 0,
                         c[torch.clamp(run_start - 1, min=0).long()], 0)
    return c - before - ci


def _nth_empty(rows_keys: torch.Tensor, rank: torch.Tensor):
    """Column of the (rank+1)-th EMPTY cell of each `[B]` row; B when the
    row has fewer empties. Returns (col int32, ok bool)."""
    B = rows_keys.shape[1]
    empty = rows_keys == EMPTY
    cum = torch.cumsum(empty.to(torch.int32), 1, dtype=torch.int32)
    hit = empty & (cum == rank[:, None] + 1)
    ok = hit.any(dim=1)
    return torch.where(ok, first_true(hit), B).to(torch.int32), ok


class FixedHash(NamedTuple):
    keys: torch.Tensor   # [M, B] int64 (u64 bits), EMPTY padding
    vals: torch.Tensor   # [M, B] int64
    count: torch.Tensor  # () int64 live entries

    @property
    def num_slots(self) -> int:
        return self.keys.shape[0]

    @property
    def bucket(self) -> int:
        return self.keys.shape[1]


def fixed_init(num_slots: int, bucket: int, *, device) -> FixedHash:
    if not is_pow2(num_slots):
        raise ValueError(f"num_slots must be a power of two, got {num_slots}")
    keys, vals = kv_arrays((num_slots, bucket), device=device)
    return FixedHash(keys=keys, vals=vals,
                     count=torch.tensor(0, dtype=torch.int64, device=device))


class BucketInsertPlan(NamedTuple):
    """The insert-linearization prologue of a fixed-slot table, in sorted
    (slot, key) lane order; shared by `fixed_insert` and the tier stack's
    policy-driven insert."""
    inv: torch.Tensor     # [K] inverse permutation
    ss: torch.Tensor      # [K] slots, sorted order
    sk: torch.Tensor      # [K] keys, sorted order
    sv: torch.Tensor      # [K] vals, sorted order
    sm: torch.Tensor      # [K] mask, sorted order
    rows: torch.Tensor    # [K, B] pre-batch bucket rows
    dup: torch.Tensor     # [K] in-batch duplicate
    exists: torch.Tensor  # [K] key already stored (pre-batch)
    cand: torch.Tensor    # [K] insert candidate
    rank: torch.Tensor    # [K] within-slot rank among candidates
    col_e: torch.Tensor   # [K] empty-column placement for `rank`
    fit_e: torch.Tensor   # [K] candidate fits an empty column


def bucket_insert_plan(h: FixedHash, keys, vals, mask) -> BucketInsertPlan:
    """Build the `BucketInsertPlan` for one batched insert."""
    mask = mask & (keys != EMPTY)
    slots = hash_slot(keys, h.num_slots)
    order, ss, sk, sm, dup, run_start, inv = _batch_plan(slots, keys, mask)
    rows = h.keys[ss.long()]
    exists = sm & (rows == sk[:, None]).any(dim=1) & ~dup
    cand = sm & ~dup & ~exists
    rank = _seg_rank(cand, run_start)
    col_e, fit_e = _nth_empty(rows, rank)
    return BucketInsertPlan(inv=inv, ss=ss, sk=sk, sv=vals[order], sm=sm,
                            rows=rows, dup=dup, exists=exists, cand=cand,
                            rank=rank, col_e=col_e, fit_e=fit_e)


def fixed_insert(h: FixedHash, keys: torch.Tensor, vals: torch.Tensor,
                 mask: torch.Tensor | None = None):
    """Returns (h', inserted[K], existed[K]); bucket-full lanes fail."""
    K = keys.shape[0]
    M, B = h.num_slots, h.bucket
    if mask is None:
        mask = torch.ones(K, dtype=torch.bool, device=keys.device)
    p = bucket_insert_plan(h, keys, vals, mask)
    ins = p.cand & p.fit_e
    flat = torch.where(ins, p.ss * B + p.col_e, M * B)
    nk = scatter_drop(h.keys.reshape(-1), flat, p.sk).reshape(M, B)
    nv = scatter_drop(h.vals.reshape(-1), flat, p.sv).reshape(M, B)
    h2 = FixedHash(keys=nk, vals=nv, count=h.count + ins.sum())
    inv = p.inv.long()
    return h2, ins[inv], (p.exists | p.dup)[inv]


def fixed_find_cols(h: FixedHash, keys: torch.Tensor):
    """(found[K], vals[K], col[K] int32): `col` is the first matching
    bucket column (0 on a miss)."""
    slots = hash_slot(keys, h.num_slots).long()
    hit = h.keys[slots] == keys[:, None]
    found = hit.any(dim=1) & (keys != EMPTY)
    col = first_true(hit)
    vals = torch.where(found, h.vals[slots, col.long()], 0)
    return found, vals, col


def fixed_find(h: FixedHash, keys: torch.Tensor):
    return fixed_find_cols(h, keys)[:2]


def fixed_delete(h: FixedHash, keys: torch.Tensor,
                 mask: torch.Tensor | None = None):
    """Returns (h', deleted[K]). In-batch duplicate deletes of one key
    dedupe by cell; non-found lanes park at the sentinel cell so a miss
    whose col is 0 never aliases a genuine hit at column 0."""
    K = keys.shape[0]
    M, B = h.num_slots, h.bucket
    if mask is None:
        mask = torch.ones(K, dtype=torch.bool, device=keys.device)
    slots = hash_slot(keys, h.num_slots)
    hit = h.keys[slots.long()] == keys[:, None]
    found = hit.any(dim=1) & mask & (keys != EMPTY)
    col = first_true(hit)
    cell = torch.where(found, slots * B + col, M * B)
    o = torch.argsort(cell, stable=True)
    cs = cell[o]
    fdup = torch.cat([torch.zeros(1, dtype=torch.bool, device=keys.device),
                      cs[1:] == cs[:-1]]) & found[o]
    eff = found & ~fdup[inverse_perm(o).long()]
    flat = torch.where(eff, cell, M * B)
    nk = scatter_drop(h.keys.reshape(-1), flat, EMPTY).reshape(M, B)
    return FixedHash(keys=nk, vals=h.vals, count=h.count - eff.sum()), eff


# ---------------------------------------------------------------------------
# Version 2: two-level (inline L1 bucket + pooled L2 tables)
# ---------------------------------------------------------------------------

class TwoLevelHash(NamedTuple):
    l1_keys: torch.Tensor   # [M1, B1] int64 (u64 bits)
    l1_vals: torch.Tensor   # [M1, B1]
    l2_block: torch.Tensor  # [M1] int32 block id, -1 = not expanded
    l2_keys: torch.Tensor   # [P, M2, B2] pooled second-level tables
    l2_vals: torch.Tensor   # [P, M2, B2]
    pool: BlockPool         # allocator over the P blocks
    count: torch.Tensor     # () int64 live entries

    @property
    def m1(self) -> int:
        return self.l1_keys.shape[0]

    @property
    def m2(self) -> int:
        return self.l2_keys.shape[1]


def twolevel_init(m1: int, b1: int, m2: int, b2: int, pool_blocks: int, *,
                  device) -> TwoLevelHash:
    if not (is_pow2(m1) and is_pow2(m2)):
        raise ValueError(f"m1 and m2 must be powers of two, got {m1}, {m2}")
    l1_keys, l1_vals = kv_arrays((m1, b1), device=device)
    l2_keys, l2_vals = block_arrays(pool_blocks, (m2, b2), device=device)
    return TwoLevelHash(
        l1_keys=l1_keys, l1_vals=l1_vals,
        l2_block=torch.full((m1,), -1, dtype=torch.int32, device=device),
        l2_keys=l2_keys, l2_vals=l2_vals,
        pool=blockpool_init(pool_blocks, device=device),
        count=torch.tensor(0, dtype=torch.int64, device=device))


def _slots12(h: TwoLevelHash, keys: torch.Tensor):
    """(L1 slot, L2 bucket): the low log2(M1) hash bits, then the next
    log2(M2) bits (paper §VIII), both int32."""
    hv = hash64(keys)
    s1 = (hv & (h.m1 - 1)).to(torch.int32)
    s2 = (shr(hv, h.m1.bit_length() - 1) & (h.m2 - 1)).to(torch.int32)
    return s1, s2


def _probe2(h: TwoLevelHash, keys: torch.Tensor, s1, s2):
    """Both levels' probes: (hit1 [K, B1], hit2 [K, B2], blk, safe blk)."""
    hit1 = h.l1_keys[s1.long()] == keys[:, None]
    blk = h.l2_block[s1.long()]
    safe = torch.clamp(blk, min=0)
    hit2 = ((h.l2_keys[safe.long(), s2.long()] == keys[:, None])
            & (blk >= 0)[:, None])
    return hit1, hit2, blk, safe


def twolevel_find(h: TwoLevelHash, keys: torch.Tensor):
    """(found[K], vals[K])."""
    s1, s2 = _slots12(h, keys)
    hit1, hit2, _, safe = _probe2(h, keys, s1, s2)
    f1, f2 = hit1.any(dim=1), hit2.any(dim=1)
    v1 = h.l1_vals[s1.long(), first_true(hit1).long()]
    v2 = h.l2_vals[safe.long(), s2.long(), first_true(hit2).long()]
    found = (f1 | f2) & (keys != EMPTY)
    return found, torch.where(f1, v1, torch.where(f2, v2, 0))


def twolevel_insert(h: TwoLevelHash, keys: torch.Tensor, vals: torch.Tensor,
                    mask: torch.Tensor | None = None):
    """L1 inline bucket first; on overflow the slot expands into a pooled
    L2 table (the first overflowing lane of a slot run allocates it) and
    the lane is placed there. Returns (h', inserted[K], existed[K])."""
    K = keys.shape[0]
    M1, B1 = h.l1_keys.shape
    P, M2, B2 = h.l2_keys.shape
    dev = keys.device
    if mask is None:
        mask = torch.ones(K, dtype=torch.bool, device=dev)
    mask = mask & (keys != EMPTY)
    s1, s2 = _slots12(h, keys)
    order, ss, sk, sm, dup, run_start, inv = _batch_plan(s1, keys, mask)
    sv, ss2 = vals[order], s2[order]
    ssl, ss2l = ss.long(), ss2.long()

    # existence across both levels (pre-batch state)
    rows1 = h.l1_keys[ssl]
    blk0 = h.l2_block[ssl]
    rows2 = h.l2_keys[torch.clamp(blk0, min=0).long(), ss2l]
    exists = sm & ~dup & ((rows1 == sk[:, None]).any(dim=1)
                          | ((rows2 == sk[:, None]).any(dim=1) & (blk0 >= 0)))
    cand = sm & ~dup & ~exists

    # L1 placement by within-slot rank over the remaining empties
    col1, fit1 = _nth_empty(rows1, _seg_rank(cand, run_start))
    put1 = cand & fit1

    # overflow lanes go to L2; the first needing lane of a slot run allocates
    over = cand & ~fit1
    need_alloc = over & (blk0 < 0)
    do_alloc = need_alloc & (_seg_rank(need_alloc, run_start) == 0)
    pool2, ids, _, got = pool_alloc(h.pool, do_alloc)
    l2_block = scatter_drop(h.l2_block, torch.where(do_alloc & got, ss, M1),
                            ids)

    blk = l2_block[ssl]                                 # post-allocation view
    has_l2 = over & (blk >= 0)
    # lanes of one (s1, s2) pair need distinct columns: rank over the pair
    pair = ss.to(torch.int64) * M2 + ss2.to(torch.int64)
    po = torch.argsort(pair, stable=True)
    ppair = pair[po]
    prun = torch.searchsorted(ppair, ppair, out_int32=True)
    rank2 = torch.empty(K, dtype=torch.int32, device=dev)
    rank2[po] = _seg_rank(has_l2[po], prun)
    rows2b = h.l2_keys[torch.clamp(blk, min=0).long(), ss2l]
    col2, fit2 = _nth_empty(rows2b, rank2)
    put2 = has_l2 & fit2

    flat1 = torch.where(put1, ss * B1 + col1, M1 * B1)
    nk1 = scatter_drop(h.l1_keys.reshape(-1), flat1, sk).reshape(M1, B1)
    nv1 = scatter_drop(h.l1_vals.reshape(-1), flat1, sv).reshape(M1, B1)
    flat2 = torch.where(put2, (blk.to(torch.int64) * M2 + ss2) * B2 + col2,
                        P * M2 * B2)
    nk2 = scatter_drop(h.l2_keys.reshape(-1), flat2, sk).reshape(P, M2, B2)
    nv2 = scatter_drop(h.l2_vals.reshape(-1), flat2, sv).reshape(P, M2, B2)

    ins = put1 | put2
    h2 = TwoLevelHash(l1_keys=nk1, l1_vals=nv1, l2_block=l2_block,
                      l2_keys=nk2, l2_vals=nv2, pool=pool2,
                      count=h.count + ins.sum())
    inv = inv.long()
    return h2, ins[inv], (exists | dup)[inv]


def twolevel_delete(h: TwoLevelHash, keys: torch.Tensor,
                    mask: torch.Tensor | None = None):
    """Delete from either level: EMPTY into the matched cell. In-batch
    duplicate deletes of one key dedupe by a global cell id (L1 cells,
    then L2 cells), first lane wins. Expanded L2 tables stay allocated.
    Returns (h', deleted[K])."""
    K = keys.shape[0]
    M1, B1 = h.l1_keys.shape
    P, M2, B2 = h.l2_keys.shape
    dev = keys.device
    if mask is None:
        mask = torch.ones(K, dtype=torch.bool, device=dev)
    mask = mask & (keys != EMPTY)
    s1, s2 = _slots12(h, keys)
    hit1, hit2, _, safe = _probe2(h, keys, s1, s2)
    f1 = hit1.any(dim=1) & mask
    f2 = hit2.any(dim=1) & mask & ~f1
    col1, col2 = first_true(hit1), first_true(hit2)

    found = f1 | f2
    cell1 = s1.to(torch.int64) * B1 + col1
    cell2l = (safe.to(torch.int64) * M2 + s2) * B2 + col2
    cell = torch.where(f1, cell1, torch.where(f2, M1 * B1 + cell2l,
                                              M1 * B1 + P * M2 * B2))
    o = torch.argsort(cell, stable=True)
    cs = cell[o]
    fdup = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                      cs[1:] == cs[:-1]]) & found[o]
    eff = found & ~fdup[inverse_perm(o).long()]

    nk1 = scatter_drop(h.l1_keys.reshape(-1),
                       torch.where(eff & f1, cell1, M1 * B1),
                       EMPTY).reshape(M1, B1)
    nk2 = scatter_drop(h.l2_keys.reshape(-1),
                       torch.where(eff & f2, cell2l, P * M2 * B2),
                       EMPTY).reshape(P, M2, B2)
    return h._replace(l1_keys=nk1, l2_keys=nk2,
                      count=h.count - eff.sum()), eff
