"""Randomized skiplist (paper §VI / Pugh), PyTorch port of
`repro.core.rand_skiplist`: the paper's comparator for the deterministic
1-2-3-4 skiplist.

Node heights are geometric(1/4) from splitmix64(key) (`geometric_height`),
so level intervals have random widths: a batched descent scans every
lane MAX_GAP cells per level in PROBE-wide chunks (2 * MAX_GAP on the
terminal level). The rebuild force-promotes a key wherever a level gap
would reach MAX_GAP (`_promote`), which keeps shapes static.

Index levels are stored as in `det_skiplist`: one flat key buffer and one
child buffer, each level a view of it (`LevelPlanes`), so a rebuild
writes every level into two fresh buffers and copies nothing after.
Keys are int64 bit patterns; every u64 `<=` goes through `core.bits`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.bits import (KEY_INF, dup_in_run, geometric_height,
                                   ordered, u64_le)
from repro_torch.core.det_skiplist import LevelPlanes, _i32, _searchsorted
from repro_torch.core.layout import first_true, inverse_perm, scatter_drop

MAX_GAP = 16   # static probe width per index level
PROBE = 8      # gather chunk


class RandSkiplist(NamedTuple):
    term_keys: torch.Tensor    # [C] int64 (u64 bits) sorted, KEY_INF pad
    term_vals: torch.Tensor    # [C] int64
    term_mark: torch.Tensor    # [C] bool tombstones
    n_term: torch.Tensor       # () int32 physical entries
    n_marked: torch.Tensor     # () int32
    level_keys: LevelPlanes    # L views [C_l] int64
    level_child: LevelPlanes   # L views [C_l] int32, position in level below
    level_count: torch.Tensor  # [L] int32
    forced: torch.Tensor       # () int32 gap-cap promotions (telemetry)

    @property
    def capacity(self) -> int:
        return self.term_keys.shape[0]

    @property
    def num_levels(self) -> int:
        return len(self.level_keys)

    def size(self) -> torch.Tensor:
        return self.n_term - self.n_marked


def _level_caps(capacity: int) -> list[int]:
    caps, c = [], capacity
    while c > MAX_GAP:
        c = (c + 1) // 2   # gaps >= 2 on average, so counts at least halve
        caps.append(max(c, MAX_GAP))
    return caps or [MAX_GAP]


def rand_skiplist_init(capacity: int, *, device) -> RandSkiplist:
    caps = _level_caps(capacity)
    total = sum(caps)
    return RandSkiplist(
        term_keys=torch.full((capacity,), KEY_INF, dtype=torch.int64,
                             device=device),
        term_vals=torch.zeros(capacity, dtype=torch.int64, device=device),
        term_mark=torch.zeros(capacity, dtype=torch.bool, device=device),
        n_term=_i32(0, device), n_marked=_i32(0, device),
        level_keys=LevelPlanes(torch.full((total,), KEY_INF,
                                          dtype=torch.int64, device=device),
                               caps),
        level_child=LevelPlanes(torch.zeros(total, dtype=torch.int32,
                                            device=device), caps),
        level_count=torch.zeros(len(caps), dtype=torch.int32, device=device),
        forced=_i32(0, device))


def _promote(keys: torch.Tensor, n: torch.Tensor, want_level: int):
    """Membership mask of the next level: hash height >= want_level, gaps
    capped at MAX_GAP by forced promotion, position 0 always promoted.
    Returns (mask, forced count int32)."""
    C = keys.shape[0]
    idx = torch.arange(C, dtype=torch.int32, device=keys.device)
    live = idx < n
    want = live & (geometric_height(keys, want_level) >= want_level)
    # the last wanted position at or before each idx (-1 before the first):
    # the reference's running max, as a gather of the c-th wanted position
    # (`torch.cummax` over a 2^24-cell level takes ~4 ms on the card)
    c = torch.cumsum(want.to(torch.int32), 0, dtype=torch.int32)
    at = scatter_drop(torch.zeros(C, dtype=torch.int32, device=keys.device),
                      torch.where(want, c - 1, C), idx)
    last = torch.where(c > 0, at[torch.clamp(c - 1, min=0).long()], -1)
    force = live & ~want & ((idx - last) % MAX_GAP == 0) & (last < idx)
    head = live & (idx == 0)
    return want | force | head, force.sum().to(torch.int32)


def _rebuild(s: RandSkiplist) -> RandSkiplist:
    """Rebuild every index level from the terminal array into fresh flat
    buffers. Level cell r takes the member of rank r (a searchsorted over
    the members' running count). A level whose members exceed its
    capacity keeps its first cap - 1 members and, in its last cell, the
    last one: the reference's `min(rank, cap - 1)` scatter, where the
    last write wins."""
    offs = s.level_keys.offsets
    caps = [b - a for a, b in zip(offs, offs[1:])]
    dev = s.term_keys.device
    lkeys = LevelPlanes(torch.empty(offs[-1], dtype=torch.int64, device=dev),
                        caps)
    lchild = LevelPlanes(torch.empty(offs[-1], dtype=torch.int32,
                                     device=dev), caps)
    counts = []
    prev_keys, n_prev = s.term_keys, s.n_term
    forced = _i32(0, dev)
    for l, cap_l in enumerate(caps):
        memb, fn = _promote(prev_keys, n_prev, l + 1)
        forced = forced + fn
        csum = torch.cumsum(memb.to(torch.int32), 0, dtype=torch.int32)
        g = csum[-1]
        r = torch.arange(cap_l, dtype=torch.int32, device=dev)
        want = torch.where((r == cap_l - 1) & (g > cap_l), g, r + 1)
        src = torch.clamp(torch.searchsorted(csum, want),
                          max=prev_keys.shape[0] - 1)
        dead = r >= torch.clamp(g, max=cap_l)
        torch.index_select(prev_keys, 0, src, out=lkeys[l])
        lkeys[l].masked_fill_(dead, KEY_INF)
        lchild[l].copy_(src).masked_fill_(dead, 0)
        g = torch.clamp(g, max=cap_l)
        counts.append(g)
        prev_keys, n_prev = lkeys[l], g
    return s._replace(level_keys=lkeys, level_child=lchild,
                      level_count=torch.stack(counts).to(torch.int32),
                      forced=forced)


def _scan(keys_l: torch.Tensor, i: torch.Tensor, q: torch.Tensor,
          chunks: int) -> torch.Tensor:
    """First j in [i, i + chunks * PROBE) with q <= keys_l[j] (reads
    clipped to the level, j unclipped), -1 where there is none."""
    cap = keys_l.shape[0]
    lane = torch.arange(PROBE, dtype=torch.int32, device=i.device)
    best = torch.full_like(i, -1)
    for c in range(chunks):
        idx = torch.clamp(i[:, None] + c * PROBE + lane, 0, cap - 1)
        hit = u64_le(q[:, None], keys_l[idx.long()])
        cand = i + c * PROBE + first_true(hit)
        best = torch.where((best < 0) & hit.any(dim=1), cand, best)
    return best


def find_batch(s: RandSkiplist, queries: torch.Tensor):
    """Batched Find: per level, scan right up to MAX_GAP cells for the
    first key >= q and descend from the previous cell's child; then a
    2 * MAX_GAP terminal scan. Returns (found[Q], vals[Q], term_idx[Q])."""
    i = torch.zeros(queries.shape, dtype=torch.int32, device=queries.device)
    for l in range(s.num_levels - 1, -1, -1):
        keys_l, child_l = s.level_keys[l], s.level_child[l]
        cap = keys_l.shape[0]
        best = _scan(keys_l, i, queries, MAX_GAP // PROBE)
        j = torch.where(best >= 0, best, torch.clamp(i + MAX_GAP - 1,
                                                     max=cap - 1))
        # the reference's gathers clamp an index past the level's end
        prev_j = torch.clamp(j - 1, 0, cap - 1)
        i = torch.where(j > 0, child_l[prev_j.long()], 0)
    best = _scan(s.term_keys, i, queries, MAX_GAP // PROBE * 2)
    ti = torch.clamp(torch.where(best >= 0, best, 0), 0, s.capacity - 1)
    til = ti.long()
    found = ((s.term_keys[til] == queries) & ~s.term_mark[til]
             & (queries != KEY_INF))
    return found, torch.where(found, s.term_vals[til], 0), ti


def _sorted_lanes(keys: torch.Tensor, mask: torch.Tensor):
    """Stable key order, in-batch duplicates (first masked lane wins)."""
    order = torch.argsort(ordered(keys), stable=True)
    sk = keys[order]
    same = torch.cat([torch.zeros(1, dtype=torch.bool, device=keys.device),
                      sk[1:] == sk[:-1]])
    return order, sk, dup_in_run(same, mask[order])


def insert_batch(s: RandSkiplist, keys: torch.Tensor, vals: torch.Tensor,
                 mask: torch.Tensor | None = None):
    """Bulk sorted merge (a marked match revives in place), then the level
    rebuild from hash heights. Returns (s', inserted[K], existed[K])."""
    K = keys.shape[0]
    C = s.capacity
    dev = keys.device
    if mask is None:
        mask = torch.ones(K, dtype=torch.bool, device=dev)
    mask = mask & (keys != KEY_INF)
    order, sk, dup = _sorted_lanes(keys, mask)
    sv, sm = vals[order], mask[order]

    pos = _searchsorted(s.term_keys, sk)
    posc = torch.clamp(pos, 0, C - 1).long()
    match = sm & (pos < C) & (s.term_keys[posc] == sk)
    revive = match & s.term_mark[posc] & ~dup
    exists = match & ~s.term_mark[posc]

    rpos = torch.where(revive, posc, C)
    term_mark = scatter_drop(s.term_mark, rpos, False)
    term_vals = scatter_drop(s.term_vals, rpos, sv)
    n_marked = s.n_marked - revive.sum().to(torch.int32)

    new = sm & ~match & ~dup
    rank = torch.cumsum(new.to(torch.int32), 0, dtype=torch.int32) - 1
    new = new & (s.n_term + rank < C)
    n_new = new.sum().to(torch.int32)

    crank = torch.where(new, rank, K)
    newk = scatter_drop(torch.full((K,), KEY_INF, dtype=torch.int64,
                                   device=dev), crank, sk)
    newv = scatter_drop(torch.zeros(K, dtype=torch.int64, device=dev), crank,
                        sv)

    old_idx = torch.arange(C, dtype=torch.int32, device=dev)
    dest_old = torch.where(old_idx < s.n_term,
                           old_idx + _searchsorted(newk, s.term_keys), C)
    kidx = torch.arange(K, dtype=torch.int32, device=dev)
    dest_new = torch.where(kidx < n_new,
                           _searchsorted(s.term_keys, newk) + kidx, C)

    def merged(fill, old, new_cells):
        return scatter_drop(scatter_drop(fill, dest_old, old), dest_new,
                            new_cells)

    tk = merged(torch.full((C,), KEY_INF, dtype=torch.int64, device=dev),
                s.term_keys, newk)
    tv = merged(torch.zeros(C, dtype=torch.int64, device=dev), term_vals,
                newv)
    tm = scatter_drop(torch.zeros(C, dtype=torch.bool, device=dev), dest_old,
                      term_mark)
    s2 = _rebuild(s._replace(term_keys=tk, term_vals=tv, term_mark=tm,
                             n_term=s.n_term + n_new, n_marked=n_marked))
    inv = inverse_perm(order).long()
    return s2, (new | revive)[inv], (exists | dup)[inv]


def delete_batch(s: RandSkiplist, keys: torch.Tensor,
                 mask: torch.Tensor | None = None):
    """Tombstone matching terminal entries (no compaction). Returns (s',
    deleted[K])."""
    C = s.capacity
    if mask is None:
        mask = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    mask = mask & (keys != KEY_INF)
    order, sk, dup = _sorted_lanes(keys, mask)
    sm = mask[order]
    pos = _searchsorted(s.term_keys, sk)
    posc = torch.clamp(pos, 0, C - 1).long()
    hit = (sm & ~dup & (pos < C) & (s.term_keys[posc] == sk)
           & ~s.term_mark[posc])
    mark = scatter_drop(s.term_mark, torch.where(hit, posc, C), True)
    s2 = s._replace(term_mark=mark,
                    n_marked=s.n_marked + hit.sum().to(torch.int32))
    return s2, hit[inverse_perm(order).long()]
