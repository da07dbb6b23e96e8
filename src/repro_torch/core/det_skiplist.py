"""Concurrent deterministic 1-2-3-4 skiplist (paper §II), PyTorch port of
`repro.core.det_skiplist`.

Same encoding as the reference: a sorted terminal level (`KEY_INF`
padding, tombstone marks, insert stamps) plus index levels of
max-of-group keys and group-start children, rebuilt after every batch by
the deterministic grouping of threes (arity in {2, 3}). Keys are int64 bit
patterns (`core.bits`); every ordered compare and `searchsorted` runs on
the sign-flipped copy. Functions take and return `DetSkiplist` tuples of
tensors; the threshold compaction is a host-side branch on a scalar
(the reference's `lax.cond`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.bits import KEY_INF, dup_in_run, ordered, u64_le
from repro_torch.core.layout import (bskiplist_layout, first_true,
                                     inverse_perm, kv_arrays, scatter_drop)

FANOUT = 4  # 1-2-3-4: arity in [2, 4]
# compact when tombstones exceed COMPACT_NUM / COMPACT_DEN of the entries
COMPACT_NUM, COMPACT_DEN = 1, 4


class LevelPlanes(tuple):
    """One plane kind of the index levels (max-of-group keys or group-start
    children): a tuple of per-level tensors, as the reference's state
    holds them, that are views of ONE flat buffer `flat` (level l at
    `[offsets[l], offsets[l + 1])`). The level walk kernels read `flat`,
    so handing the levels to them copies nothing."""

    def __new__(cls, flat: torch.Tensor, caps):
        offs = [0]
        for c in caps:
            offs.append(offs[-1] + int(c))
        self = super().__new__(cls, (flat[a:b] for a, b in zip(offs, offs[1:])))
        self.flat = flat
        self.offsets = tuple(offs)
        return self

    @classmethod
    def stack(cls, levels) -> "LevelPlanes":
        """Copy separate per-level tensors into one flat buffer."""
        levels = list(levels)
        return cls(torch.cat(levels), [t.shape[0] for t in levels])


class DetSkiplist(NamedTuple):
    term_keys: torch.Tensor    # [C] int64 (u64 bits) sorted; marked stay
    term_vals: torch.Tensor    # [C] int64 (u64 bits)
    term_mark: torch.Tensor    # [C] bool tombstones
    term_stamp: torch.Tensor   # [C] int32 batch clock at insert/revive
    n_term: torch.Tensor       # () int32 physical entries
    n_marked: torch.Tensor     # () int32
    clock: torch.Tensor        # () int32, ticked once per apply
    level_keys: LevelPlanes    # L views [C_l] int64 (max of group)
    level_child: LevelPlanes   # L views [C_l] int32 (group start)
    level_count: torch.Tensor  # [L] int32

    @property
    def capacity(self) -> int:
        return self.term_keys.shape[0]

    @property
    def num_levels(self) -> int:
        return len(self.level_keys)


def _level_caps(capacity: int) -> list[int]:
    """Index-level capacities: groups are >= 2 wide so counts at least halve."""
    caps, c = [], capacity
    while c > FANOUT:
        c = (c + 1) // 2
        caps.append(max(c, FANOUT))
    return caps or [FANOUT]


def _i32(v: int, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=device)


def skiplist_init(capacity: int, *, device) -> DetSkiplist:
    caps = _level_caps(capacity)
    term_keys, term_vals = kv_arrays(capacity, device=device)
    total = sum(caps)
    return DetSkiplist(
        term_keys=term_keys,
        term_vals=term_vals,
        term_mark=torch.zeros(capacity, dtype=torch.bool, device=device),
        term_stamp=torch.zeros(capacity, dtype=torch.int32, device=device),
        n_term=_i32(0, device), n_marked=_i32(0, device),
        clock=_i32(0, device),
        level_keys=LevelPlanes(torch.full((total,), KEY_INF,
                                          dtype=torch.int64, device=device),
                               caps),
        level_child=LevelPlanes(torch.zeros(total, dtype=torch.int32,
                                            device=device), caps),
        level_count=torch.zeros(len(caps), dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# rebuild (the batched top-down rebalance)
# ---------------------------------------------------------------------------

def _group(n_prev: torch.Tensor, prev_keys: torch.Tensor,
           keys_out: torch.Tensor, child_out: torch.Tensor) -> torch.Tensor:
    """Deterministic 1-2-3-4 grouping of a sorted level of n_prev keys:
    boundaries b_j = min(3j, max(n_prev - 2, 0)), arity in {2, 3}. Writes
    the level's keys and children into `keys_out` / `child_out` (views of
    the flat level buffers) and returns its group count."""
    j = torch.arange(keys_out.shape[0], dtype=torch.int32,
                     device=prev_keys.device)
    g = torch.where(n_prev > 0, (n_prev + 2) // 3, 0).to(torch.int32)
    tail = torch.clamp(n_prev - 2, min=0)
    lo = torch.minimum(3 * j, tail)
    hi = torch.where(j + 1 < g, torch.minimum(3 * (j + 1), tail), n_prev)
    dead = j >= g
    kidx = torch.clamp(hi - 1, 0, prev_keys.shape[0] - 1).long()
    torch.index_select(prev_keys, 0, kidx, out=keys_out)
    keys_out.masked_fill_(dead, KEY_INF)
    child_out.copy_(lo).masked_fill_(dead, 0)
    return g


def _rebuild_levels(s: DetSkiplist) -> DetSkiplist:
    """Rebuild every index level from the terminal array, into fresh flat
    level buffers."""
    offs = s.level_keys.offsets
    caps = [b - a for a, b in zip(offs, offs[1:])]
    dev = s.term_keys.device
    lkeys = LevelPlanes(torch.empty(offs[-1], dtype=torch.int64, device=dev),
                        caps)
    lchild = LevelPlanes(torch.empty(offs[-1], dtype=torch.int32,
                                     device=dev), caps)
    counts = []
    prev_keys, n_prev = s.term_keys, s.n_term
    for l in range(s.num_levels):
        g = _group(n_prev, prev_keys, lkeys[l], lchild[l])
        counts.append(g)
        prev_keys, n_prev = lkeys[l], g
    return s._replace(level_keys=lkeys, level_child=lchild,
                      level_count=torch.stack(counts).to(torch.int32))


# ---------------------------------------------------------------------------
# Find
# ---------------------------------------------------------------------------

def find_batch(s: DetSkiplist, queries: torch.Tensor):
    """Batched Find: exactly L descent steps of a 4-wide probe. Returns
    (found[Q] bool, vals[Q] int64, term_idx[Q] int32)."""
    dev = queries.device
    top = s.num_levels - 1
    fan = torch.arange(FANOUT, dtype=torch.int32, device=dev)
    q = queries[:, None]
    i = first_true(u64_le(q, s.level_keys[top][:FANOUT][None, :]))
    for l in range(top, -1, -1):
        child = s.level_child[l]
        start = child[torch.clamp(i, 0, child.shape[0] - 1).long()]
        below = s.term_keys if l == 0 else s.level_keys[l - 1]
        idx = torch.clamp(start[:, None] + fan[None, :], 0, below.shape[0] - 1)
        i = start + first_true(u64_le(q, below[idx.long()]))
    i = torch.clamp(i, 0, s.capacity - 1)
    il = i.long()
    found = ((s.term_keys[il] == queries) & ~s.term_mark[il]
             & (queries != KEY_INF))
    return found, torch.where(found, s.term_vals[il], 0), i


def find_batch_blocked(s: DetSkiplist, queries: torch.Tensor):
    """Batched Find through the block-major B-skiplist view
    (`core.layout.bskiplist_layout`): the same contract and the same
    found/vals as `find_batch`, in L + 1 whole-block compares (the walk
    of `kernels.bskiplist_walk.ref.bskiplist_walk_ref`)."""
    from repro_torch.kernels.bskiplist_walk.ref import bskiplist_walk_ref
    _, i = bskiplist_walk_ref(queries, bskiplist_layout(s))
    i = torch.clamp(i, 0, s.capacity - 1)
    il = i.long()
    found = ((s.term_keys[il] == queries) & ~s.term_mark[il]
             & (queries != KEY_INF))
    return found, torch.where(found, s.term_vals[il], 0), i


# ---------------------------------------------------------------------------
# Addition (bulk, deterministic linearization)
# ---------------------------------------------------------------------------

def _searchsorted(sorted_keys: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """u64 searchsorted-left, int32."""
    return torch.searchsorted(ordered(sorted_keys), ordered(q),
                              out_int32=True)


def insert_batch(s: DetSkiplist, keys: torch.Tensor, vals: torch.Tensor,
                 mask: torch.Tensor | None = None):
    """Batched Addition. Returns (s', inserted[K] bool, existed[K] bool).
    Lanes sort by (key, lane); in-batch duplicates resolve to the lowest
    lane; a key matching a marked entry revives it in place; capacity
    overflow fails the highest-ranked lanes."""
    K = keys.shape[0]
    C = s.capacity
    dev = keys.device
    if mask is None:
        mask = torch.ones(K, dtype=torch.bool, device=dev)
    mask = mask & (keys != KEY_INF)

    order = torch.argsort(ordered(keys), stable=True)
    sk, sv, sm = keys[order], vals[order], mask[order]
    same = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                      sk[1:] == sk[:-1]])
    dup = dup_in_run(same, sm)

    pos = _searchsorted(s.term_keys, sk)
    posc = torch.clamp(pos, 0, C - 1).long()
    match = sm & (pos < C) & (s.term_keys[posc] == sk)
    revive = match & s.term_mark[posc] & ~dup
    exists = match & ~s.term_mark[posc]

    # revive in place; a revival re-stamps with the current batch clock
    rpos = torch.where(revive, posc, C)
    term_mark = scatter_drop(s.term_mark, rpos, False)
    term_vals = scatter_drop(s.term_vals, rpos, sv)
    term_stamp = scatter_drop(s.term_stamp, rpos, s.clock)
    n_marked = s.n_marked - revive.sum().to(torch.int32)

    new = sm & ~match & ~dup
    rank = torch.cumsum(new.to(torch.int32), 0, dtype=torch.int32) - 1
    new = new & (s.n_term + rank < C)                  # overflow -> fail lanes
    n_new = new.sum().to(torch.int32)

    # compact the new keys into a sorted [K] buffer (KEY_INF padding)
    crank = torch.where(new, rank, K)
    newk = scatter_drop(torch.full((K,), KEY_INF, dtype=torch.int64,
                                   device=dev), crank, sk)
    newv = scatter_drop(torch.zeros(K, dtype=torch.int64, device=dev),
                        crank, sv)

    # two-way sorted merge by destination scatter
    old_idx = torch.arange(C, dtype=torch.int32, device=dev)
    dest_old = old_idx + _searchsorted(newk, s.term_keys)
    dest_old = torch.where(old_idx < s.n_term, dest_old, C)
    kidx = torch.arange(K, dtype=torch.int32, device=dev)
    dest_new = _searchsorted(s.term_keys, newk) + kidx
    dest_new = torch.where(kidx < n_new, dest_new, C)

    def merged(fill, old, new_vals):
        out = scatter_drop(fill, dest_old, old)
        return scatter_drop(out, dest_new, new_vals)

    tk = merged(torch.full((C,), KEY_INF, dtype=torch.int64, device=dev),
                s.term_keys, newk)
    tv = merged(torch.zeros(C, dtype=torch.int64, device=dev), term_vals,
                newv)
    tm = scatter_drop(torch.zeros(C, dtype=torch.bool, device=dev), dest_old,
                      term_mark)
    ts = merged(torch.zeros(C, dtype=torch.int32, device=dev), term_stamp,
                s.clock)

    s2 = s._replace(term_keys=tk, term_vals=tv, term_mark=tm, term_stamp=ts,
                    n_term=s.n_term + n_new, n_marked=n_marked)
    s2 = _rebuild_levels(s2)

    inv = inverse_perm(order).long()
    return s2, (new | revive)[inv], (exists | dup)[inv]


# ---------------------------------------------------------------------------
# Deletion (lazy marks + threshold compaction)
# ---------------------------------------------------------------------------

def _maybe_compact(s: DetSkiplist) -> DetSkiplist:
    if bool(s.n_marked * COMPACT_DEN > s.n_term * COMPACT_NUM):
        return compact(s)
    return s


def delete_batch(s: DetSkiplist, keys: torch.Tensor,
                 mask: torch.Tensor | None = None):
    """Batched Deletion: tombstone terminal entries, leave index levels
    stale; compact past the tombstone threshold. Returns (s',
    deleted[K])."""
    K = keys.shape[0]
    C = s.capacity
    dev = keys.device
    if mask is None:
        mask = torch.ones(K, dtype=torch.bool, device=dev)

    order = torch.argsort(ordered(keys), stable=True)
    sk = keys[order]
    sm = mask[order] & (sk != KEY_INF)
    same = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                      sk[1:] == sk[:-1]])
    dup = dup_in_run(same, sm)

    pos = _searchsorted(s.term_keys, sk)
    posc = torch.clamp(pos, 0, C - 1).long()
    hit = (sm & ~dup & (pos < C) & (s.term_keys[posc] == sk)
           & ~s.term_mark[posc])

    mark = scatter_drop(s.term_mark, torch.where(hit, posc, C), True)
    s2 = s._replace(term_mark=mark,
                    n_marked=s.n_marked + hit.sum().to(torch.int32))
    s2 = _maybe_compact(s2)
    return s2, hit[inverse_perm(order).long()]


def compact(s: DetSkiplist) -> DetSkiplist:
    """Physically remove tombstones and rebuild all levels."""
    C = s.capacity
    dev = s.term_keys.device
    keep = (~s.term_mark) & (torch.arange(C, device=dev) < s.n_term)
    dest = torch.where(keep, torch.cumsum(keep.to(torch.int32), 0,
                                          dtype=torch.int32) - 1, C)
    tk = scatter_drop(torch.full((C,), KEY_INF, dtype=torch.int64,
                                 device=dev), dest, s.term_keys)
    tv = scatter_drop(torch.zeros(C, dtype=torch.int64, device=dev), dest,
                      s.term_vals)
    ts = scatter_drop(torch.zeros(C, dtype=torch.int32, device=dev), dest,
                      s.term_stamp)
    s2 = s._replace(term_keys=tk, term_vals=tv, term_stamp=ts,
                    term_mark=torch.zeros_like(s.term_mark),
                    n_term=keep.sum().to(torch.int32),
                    n_marked=torch.zeros_like(s.n_marked))
    return _rebuild_levels(s2)


# ---------------------------------------------------------------------------
# Range search
# ---------------------------------------------------------------------------

def range_query(s: DetSkiplist, lo: torch.Tensor, hi: torch.Tensor,
                max_out: int, as_of_batch=None):
    """Keys in [lo, hi), batched over Q rows. Returns (count[Q] int32,
    keys[Q, max_out], vals[Q, max_out], valid[Q, max_out]).
    `as_of_batch` hides entries stamped after that batch clock."""
    dev = lo.device
    i_lo = _searchsorted(s.term_keys, lo)
    i_hi = _searchsorted(s.term_keys, hi)
    offs = torch.arange(max_out, dtype=torch.int32, device=dev)[None, :]
    idx = torch.clamp(i_lo[:, None] + offs, 0, s.capacity - 1).long()
    in_range = (i_lo[:, None] + offs) < i_hi[:, None]
    valid = in_range & ~s.term_mark[idx]
    live = (~s.term_mark) & (s.term_keys != KEY_INF)
    if as_of_batch is not None:
        vis = s.term_stamp <= int(as_of_batch)
        valid = valid & vis[idx]
        live = live & vis
    cs = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                    torch.cumsum(live.to(torch.int32), 0, dtype=torch.int32)])
    count = cs[i_hi.long()] - cs[i_lo.long()]
    return count, s.term_keys[idx], s.term_vals[idx], valid


# ---------------------------------------------------------------------------
# Priority-queue extraction (pop-min as rank-select over the live prefix)
# ---------------------------------------------------------------------------

def pop_rank_select(s: DetSkiplist, ranks: torch.Tensor, mask: torch.Tensor):
    """The rank-th smallest live key per lane (rank 0 = minimum). Returns
    (found[K] bool, keys[K] int64, idx[K] int32); a pure read, committed
    with `pop_mark`. Live = unmarked and not padding, the `range_query`
    formula; the live total is `n_term - n_marked`. Lanes whose rank
    exceeds the live population, or with mask False, return found=False,
    keys=KEY_INF, idx=0. The first cell whose inclusive live prefix
    reaches rank + 1 is a searchsorted-left over that prefix."""
    C = s.capacity
    live = (~s.term_mark) & (s.term_keys != KEY_INF)
    prefix = torch.cumsum(live.to(torch.int32), 0, dtype=torch.int32)
    total = s.n_term - s.n_marked
    want = ranks.to(torch.int32) + 1
    found = mask & (want >= 1) & (want <= total)
    idx = torch.searchsorted(prefix, want, out_int32=True)
    idx = torch.where(found, torch.clamp(idx, 0, C - 1), 0)
    keys = torch.where(found, s.term_keys[idx.long()], KEY_INF)
    return found, keys, idx


def pop_mark(s: DetSkiplist, idx: torch.Tensor,
             hit: torch.Tensor) -> DetSkiplist:
    """Commit a batch of pops: tombstone the selected terminal cells (the
    lazy path of `delete_batch`; index levels stay stale), then the
    threshold compaction. Rows with hit=False are ignored; lanes target
    distinct cells (distinct ranks)."""
    mark = scatter_drop(s.term_mark, torch.where(hit, idx.long(), s.capacity),
                        True)
    s2 = s._replace(term_mark=mark,
                    n_marked=s.n_marked + hit.sum().to(torch.int32))
    return _maybe_compact(s2)


# ---------------------------------------------------------------------------
# Range deletion
# ---------------------------------------------------------------------------

def range_delete_batch(s: DetSkiplist, lo: torch.Tensor, hi: torch.Tensor,
                       mask: torch.Tensor | None = None):
    """Tombstone every live key in [lo, hi) per lane. Returns
    (s', counts[K] int32); an entry covered by several lanes counts for the
    FIRST covering lane.

    The reference builds the [K, C] cover matrix at once. Here a lane's
    cover is the index interval `[searchsorted(lo), searchsorted(hi))` of
    the sorted terminal level (the same set), and only masked lanes are
    walked, in lane order and in chunks that keep the matrix near 2^24
    cells, so plans without range deletes cost two searchsorted calls."""
    K = lo.shape[0]
    C = s.capacity
    dev = lo.device
    if mask is None:
        mask = torch.ones(K, dtype=torch.bool, device=dev)
    lanes = torch.nonzero(mask).flatten().to(torch.int32)
    if lanes.numel() == 0:      # no range-delete lanes: no entry changes
        return (_maybe_compact(s),
                torch.zeros(K, dtype=torch.int32, device=dev))
    live = (~s.term_mark) & (s.term_keys != KEY_INF)
    a = _searchsorted(s.term_keys, lo)
    b = _searchsorted(s.term_keys, hi)
    first = torch.full((C,), K, dtype=torch.int32, device=dev)
    step = max(1, (1 << 24) // max(C, 1))
    e = torch.arange(C, dtype=torch.int32, device=dev)[None, :]
    for c0 in range(0, lanes.shape[0], step):
        ln = lanes[c0:c0 + step]
        cover = ((e >= a[ln.long()][:, None]) & (e < b[ln.long()][:, None])
                 & live[None, :])
        got = cover.any(dim=0) & (first == K)
        first = torch.where(got, ln[torch.argmax(cover.to(torch.uint8),
                                                  dim=0)], first)
    hitany = first < K
    counts = torch.zeros(K + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, first.long(), torch.ones_like(first))
    s2 = s._replace(term_mark=s.term_mark | hitany,
                    n_marked=s.n_marked + hitany.sum().to(torch.int32))
    s2 = _maybe_compact(s2)
    return s2, counts[:K].contiguous()


# ---------------------------------------------------------------------------
# invariant checker
# ---------------------------------------------------------------------------

def check_invariants(s: DetSkiplist) -> dict:
    """Host-side structural validation. Returns dict of violation counts."""
    out = {}
    tk = s.term_keys.cpu().numpy().view(np.uint64)
    n = int(s.n_term)
    out["terminal_sorted"] = (int(np.sum(tk[1:n] < tk[:n - 1]))
                              if n > 1 else 0)
    out["padding_inf"] = int(np.sum(tk[n:] != np.uint64(0xFFFFFFFFFFFFFFFF)))
    prev_keys, n_prev = tk, n
    bad_arity = bad_maxkey = bad_subset = 0
    counts = s.level_count.cpu().numpy()
    for l in range(s.num_levels):
        lk = s.level_keys[l].cpu().numpy().view(np.uint64)
        lc = s.level_child[l].cpu().numpy()
        g = int(counts[l])
        live_prev = set(prev_keys[:n_prev].tolist())
        for j in range(g):
            lo = int(lc[j])
            hi = int(lc[j + 1]) if j + 1 < g else n_prev
            arity = hi - lo
            if not (1 <= arity <= FANOUT) or (arity == 1 and n_prev != 1):
                bad_arity += 1
            if hi >= 1 and lk[j] != prev_keys[hi - 1]:
                bad_maxkey += 1
            if int(lk[j]) not in live_prev:
                bad_subset += 1
        prev_keys, n_prev = lk, g
    out["bad_arity"] = bad_arity
    out["bad_maxkey"] = bad_maxkey
    out["bad_subset"] = bad_subset
    return out
