"""MWMR fixed-slot hash table (paper §VII, version 1), PyTorch port of the
fixed table in `repro.core.hashtable`.

A bucket is one contiguous `[B]`-wide row of an `[M, B]` key plane. A
batch linearizes by a stable (slot, key) lane sort; in-batch duplicates
resolve to the lowest lane and within-slot ranks come from a segmented
cumsum that hands out distinct empty columns. Keys are int64 bit patterns
(`core.bits`). The two-level table waits for a later slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.bits import EMPTY, dup_in_run, ordered
from repro_torch.core.layout import (first_true, hash_slot, inverse_perm,
                                     is_pow2, kv_arrays, scatter_drop)


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
