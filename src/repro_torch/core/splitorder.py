"""Split-order hash tables (paper §VII-VIII, after Shalev & Shavit),
PyTorch port of `repro.core.splitorder`.

Entries are kept in one array sorted by the BIT-REVERSED hash `rk`; a
table of `n_slots` = 2^m slots partitions that order into contiguous
segments, and doubling `n_slots` splits every segment without moving
data. The paper's linked list and dummy nodes become a sorted array and
computed segment anchors (`splitorder_slot_bounds`). Resizing is a bump
of `n_slots` under the occupancy rule n > n_slots * max_load, at most
once per plan.

The two-level variant routes a key by its TOP hash bits to one of T
tables of C2 cells, each a one-level table with its own `n` and
`n_slots`. Its FIND is a per-table binary search over flat indices
`table * C2 + mid` (the `splitorder_probe` kernel and its plain
version): gathering one [C2] row per lane would need K * C2 cells.

Keys, `rk` and values are int64 bit patterns (`core.bits`); every u64
compare goes through `ordered`, every right shift through `shr`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.bits import (KEY_INF, bitrev64, dup_in_run, hash64,
                                   ordered, shr, u64_lt)
from repro_torch.core.layout import (first_true, inverse_perm, is_pow2,
                                     kv_arrays, scatter_drop)

WINDOW = 4  # rk-collision scan width (64-bit hash collisions are ~0)


class SplitOrderHash(NamedTuple):
    rk: torch.Tensor       # [C] int64 bit-reversed hash, sorted, KEY_INF pad
    keys: torch.Tensor     # [C] original keys
    vals: torch.Tensor     # [C]
    n: torch.Tensor        # () int32
    n_slots: torch.Tensor  # () int32, a power of two that only doubles
    max_load: int

    @property
    def capacity(self) -> int:
        return self.rk.shape[0]


def splitorder_init(capacity: int, seed_slots: int, max_load: int = 16, *,
                    device) -> SplitOrderHash:
    if not is_pow2(seed_slots):
        raise ValueError(f"seed_slots must be a power of two, got "
                         f"{seed_slots}")
    keys, vals = kv_arrays(capacity, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return SplitOrderHash(rk=torch.full((capacity,), KEY_INF,
                                        dtype=torch.int64, device=device),
                          keys=keys, vals=vals, n=torch.tensor(0, **i32),
                          n_slots=torch.tensor(seed_slots, **i32),
                          max_load=max_load)


def _rk_of(keys: torch.Tensor) -> torch.Tensor:
    return bitrev64(hash64(keys))


def _search(sorted_rk: torch.Tensor, q: torch.Tensor,
            right: bool = False) -> torch.Tensor:
    """u64 searchsorted (left unless `right`), int32."""
    return torch.searchsorted(ordered(sorted_rk), ordered(q), right=right,
                              out_int32=True)


def _window_match(rk_arr, key_arr, pos, rk_q, key_q):
    """First (rk, key) match in the WINDOW cells from pos (collision
    runs). Returns (found, at) with at clipped to [0, C - 1]."""
    C = rk_arr.shape[0]
    w = torch.arange(WINDOW, dtype=torch.int32, device=pos.device)
    idx = torch.clamp(pos[:, None] + w, 0, C - 1).long()
    hit = (rk_arr[idx] == rk_q[:, None]) & (key_arr[idx] == key_q[:, None])
    at = torch.clamp(pos + first_true(hit), 0, C - 1)
    return hit.any(dim=1), at


def splitorder_find(h: SplitOrderHash, keys: torch.Tensor):
    """(found[K], vals[K])."""
    rkq = _rk_of(keys)
    found, at = _window_match(h.rk, h.keys, _search(h.rk, rkq), rkq, keys)
    found = found & (keys != KEY_INF)
    return found, torch.where(found, h.vals[at.long()], 0)


def splitorder_insert(h: SplitOrderHash, keys: torch.Tensor,
                      vals: torch.Tensor, mask: torch.Tensor | None = None):
    """Bulk sorted merge by reversed hash, then the occupancy-triggered
    slot doubling. Returns (h', inserted[K], existed[K])."""
    K = keys.shape[0]
    C = h.capacity
    dev = keys.device
    if mask is None:
        mask = torch.ones(K, dtype=torch.bool, device=dev)
    mask = mask & (keys != KEY_INF)
    rkq = _rk_of(keys)

    order = torch.argsort(ordered(rkq), stable=True)
    srk, sk, sv, sm = rkq[order], keys[order], vals[order], mask[order]
    same = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                      (srk[1:] == srk[:-1]) & (sk[1:] == sk[:-1])])
    dup = dup_in_run(same, sm)

    exists, _ = _window_match(h.rk, h.keys, _search(h.rk, srk), srk, sk)
    exists = exists & sm & ~dup

    new = sm & ~dup & ~exists
    rank = torch.cumsum(new.to(torch.int32), 0, dtype=torch.int32) - 1
    new = new & (h.n + rank < C)
    n_new = new.sum().to(torch.int32)

    crank = torch.where(new, rank, K)
    fill = torch.full((K,), KEY_INF, dtype=torch.int64, device=dev)
    nrk = scatter_drop(fill, crank, srk)
    nk = scatter_drop(fill, crank, sk)
    nv = scatter_drop(torch.zeros(K, dtype=torch.int64, device=dev), crank,
                      sv)

    # two-way sorted merge by destination scatter (old before new on ties)
    old_idx = torch.arange(C, dtype=torch.int32, device=dev)
    dest_old = torch.where(old_idx < h.n, old_idx + _search(nrk, h.rk), C)
    kidx = torch.arange(K, dtype=torch.int32, device=dev)
    dest_new = torch.where(kidx < n_new,
                           _search(h.rk, nrk, right=True) + kidx, C)

    def merged(fill_value, old, new_cells):
        out = torch.full((C,), fill_value, dtype=torch.int64, device=dev)
        return scatter_drop(scatter_drop(out, dest_old, old), dest_new,
                            new_cells)

    n2 = h.n + n_new
    grow = n2 > h.n_slots * h.max_load
    h2 = h._replace(rk=merged(KEY_INF, h.rk, nrk),
                    keys=merged(KEY_INF, h.keys, nk),
                    vals=merged(0, h.vals, nv), n=n2,
                    n_slots=torch.where(grow, h.n_slots * 2, h.n_slots))
    inv = inverse_perm(order).long()
    return h2, new[inv], (exists | dup)[inv]


def splitorder_delete(h: SplitOrderHash, keys: torch.Tensor,
                      mask: torch.Tensor | None = None):
    """Batched delete: locate by (rk, key), then compact the survivors
    (`n_slots` never shrinks). In-batch duplicate deletes of one key
    resolve to the first lane. Returns (h', deleted[K])."""
    K = keys.shape[0]
    C = h.capacity
    dev = keys.device
    if mask is None:
        mask = torch.ones(K, dtype=torch.bool, device=dev)
    mask = mask & (keys != KEY_INF)
    rkq = _rk_of(keys)
    found, at = _window_match(h.rk, h.keys, _search(h.rk, rkq), rkq, keys)
    found = found & mask

    cell = torch.where(found, at, C)
    o = torch.argsort(cell, stable=True)
    cs = cell[o]
    fdup = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                      cs[1:] == cs[:-1]]) & found[o]
    eff = found & ~fdup[inverse_perm(o).long()]

    dead = scatter_drop(torch.zeros(C, dtype=torch.bool, device=dev),
                        torch.where(eff, at, C), True)
    keep = ~dead & (torch.arange(C, device=dev) < h.n)
    dest = torch.where(keep, torch.cumsum(keep.to(torch.int32), 0,
                                          dtype=torch.int32) - 1, C)

    def compacted(fill_value, old):
        return scatter_drop(torch.full((C,), fill_value, dtype=torch.int64,
                                       device=dev), dest, old)

    return h._replace(rk=compacted(KEY_INF, h.rk),
                      keys=compacted(KEY_INF, h.keys),
                      vals=compacted(0, h.vals),
                      n=keep.sum().to(torch.int32)), eff


def splitorder_slot_bounds(h: SplitOrderHash, keys: torch.Tensor):
    """Segment [lo, hi) of each key's slot under the current `n_slots`:
    the implicit dummy-node anchors (the locality bench of table VI).
    Reads `n_slots` on the host."""
    m = int(h.n_slots).bit_length() - 1
    slot = hash64(keys) & (h.n_slots.to(torch.int64) - 1)
    lo_rk = bitrev64(slot)                      # slot bits land at the top
    step = shr(torch.full_like(lo_rk, KEY_INF), m)  # segment width in rk
    hi_rk = lo_rk + step                        # wrapping u64 add
    wrap = u64_lt(hi_rk, lo_rk)                 # last slot: array end
    hi = torch.where(wrap, h.n, _search(h.rk, hi_rk))
    return _search(h.rk, lo_rk), hi


# ---------------------------------------------------------------------------
# Two-level split-order: route by the top hash bits to T small tables
# ---------------------------------------------------------------------------

class TwoLevelSplitOrder(NamedTuple):
    rk: torch.Tensor       # [T, C2] int64
    keys: torch.Tensor     # [T, C2]
    vals: torch.Tensor     # [T, C2]
    n: torch.Tensor        # [T] int32
    n_slots: torch.Tensor  # [T] int32, resized per table
    max_load: int

    @property
    def num_tables(self) -> int:
        return self.rk.shape[0]

    @property
    def table_capacity(self) -> int:
        return self.rk.shape[1]


def twolevel_splitorder_init(num_tables: int, capacity: int, seed_slots: int,
                             max_load: int = 16, *,
                             device) -> TwoLevelSplitOrder:
    if not is_pow2(num_tables):
        raise ValueError(f"num_tables must be a power of two, got "
                         f"{num_tables}")
    keys, vals = kv_arrays((num_tables, capacity), device=device)
    return TwoLevelSplitOrder(
        rk=torch.full((num_tables, capacity), KEY_INF, dtype=torch.int64,
                      device=device),
        keys=keys, vals=vals,
        n=torch.zeros(num_tables, dtype=torch.int32, device=device),
        n_slots=torch.full((num_tables,), seed_slots, dtype=torch.int32,
                           device=device),
        max_load=max_load)


def _table_of(h: TwoLevelSplitOrder, keys: torch.Tensor) -> torch.Tensor:
    """Owner table of each key: the top log2(T) hash bits, int32."""
    t_bits = h.num_tables.bit_length() - 1
    if not t_bits:
        return torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    return shr(hash64(keys), 64 - t_bits).to(torch.int32)


def twolevel_splitorder_find(h: TwoLevelSplitOrder, keys: torch.Tensor):
    """(found[K], vals[K]): a per-table searchsorted-left of the query's
    rk, then the first (rk, key) match in the WINDOW cells from there;
    the plain version of the `splitorder_probe` kernel."""
    from repro_torch.kernels.splitorder_probe.ref import splitorder_probe_ref
    t = _table_of(h, keys)
    found, at = splitorder_probe_ref(_rk_of(keys), keys, t, h.rk, h.keys)
    found = found.bool() & (keys != KEY_INF)
    return found, torch.where(found, h.vals[t.long(), at.long()], 0)


def _table(h: TwoLevelSplitOrder, t: int) -> SplitOrderHash:
    return SplitOrderHash(rk=h.rk[t], keys=h.keys[t], vals=h.vals[t],
                          n=h.n[t], n_slots=h.n_slots[t],
                          max_load=h.max_load)


def _per_table(h: TwoLevelSplitOrder, keys: torch.Tensor,
               mask: torch.Tensor | None, fn):
    """Run the one-level `fn(table, keys, mask_of_its_lanes)` on every
    table (the reference `vmap`s it over the T tables); returns the new
    state's planes by table and the lane results OR-ed over tables."""
    if mask is None:
        mask = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    mask = mask & (keys != KEY_INF)
    t = _table_of(h, keys)
    subs, lanes = [], None
    for tbl in range(h.num_tables):
        sub, *res = fn(_table(h, tbl), mask & (t == tbl))
        subs.append(sub)
        lanes = res if lanes is None else [a | b for a, b in zip(lanes, res)]
    planes = {f: torch.stack([getattr(s, f) for s in subs])
              for f in ("rk", "keys", "vals", "n", "n_slots")}
    return planes, lanes


def twolevel_splitorder_insert(h: TwoLevelSplitOrder, keys: torch.Tensor,
                               vals: torch.Tensor,
                               mask: torch.Tensor | None = None):
    """Route lanes to their tables, then each table's sorted merge and
    resize. Returns (h', inserted[K], existed[K])."""
    planes, (ins, ex) = _per_table(
        h, keys, mask, lambda sub, m: splitorder_insert(sub, keys, vals, m))
    return h._replace(**planes), ins, ex


def twolevel_splitorder_delete(h: TwoLevelSplitOrder, keys: torch.Tensor,
                               mask: torch.Tensor | None = None):
    """Route lanes to their tables, then each table's compacting delete.
    Returns (h', deleted[K])."""
    planes, (eff,) = _per_table(
        h, keys, mask, lambda sub, m: splitorder_delete(sub, keys, m))
    return h._replace(**planes), eff
