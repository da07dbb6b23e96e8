"""Unbounded lock-free queue, LCRQ-adapted (paper §III, algorithms 7-10),
PyTorch port of `repro.core.ringqueue`.

A chain of fixed-size array blocks with per-block monotone `front`/`rear`
counters, full/empty flags `fe` (0 empty, 1 full, 2 consumed),
`wclosed`/`rclosed` flags, a `use[]` bitmap over a preallocated pool of
blocks, `next` links and a per-block recycle counter (the ABA guard).
Threads become batch lanes: a batch's fetch-adds are a cumsum over the
lane mask, so each lane gets a distinct slot; the one functional state
update is the linearization point. A batched push of K lanes spans at most
ceil(K/B) + 1 blocks, so block discovery is an unrolled walk.

Payloads are int64 (u64 keys travel as their bit patterns); the
reference's uint32 `recycles` are int32 with the same bits.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.layout import add_drop, scatter_drop

FE_EMPTY, FE_FULL, FE_CONSUMED = 0, 1, 2
NO_BLK = -1


class RingQueue(NamedTuple):
    data: torch.Tensor      # [M, B] payload
    fe: torch.Tensor        # [M, B] int8
    front: torch.Tensor     # [M] int32
    rear: torch.Tensor      # [M] int32
    wclosed: torch.Tensor   # [M] bool
    rclosed: torch.Tensor   # [M] bool
    nxt: torch.Tensor       # [M] int32, -1 = none
    use: torch.Tensor       # [M] bool
    recycles: torch.Tensor  # [M] int32 (the reference's uint32 bits)
    head_blk: torch.Tensor  # () int32 (listhead)
    tail_blk: torch.Tensor  # () int32 (cn)
    pushed: torch.Tensor    # () int64 monotone
    popped: torch.Tensor    # () int64 monotone

    @property
    def max_blocks(self) -> int:
        return self.data.shape[0]

    @property
    def block_size(self) -> int:
        return self.data.shape[1]


def queue_init(max_blocks: int, block_size: int, dtype=torch.int64, *,
               device) -> RingQueue:
    i32 = dict(dtype=torch.int32, device=device)
    m = max_blocks
    use = torch.zeros(m, dtype=torch.bool, device=device)
    use[0] = True
    return RingQueue(
        data=torch.zeros((m, block_size), dtype=dtype, device=device),
        fe=torch.zeros((m, block_size), dtype=torch.int8, device=device),
        front=torch.zeros(m, **i32),
        rear=torch.zeros(m, **i32),
        wclosed=torch.zeros(m, dtype=torch.bool, device=device),
        rclosed=torch.zeros(m, dtype=torch.bool, device=device),
        nxt=torch.full((m,), NO_BLK, **i32),
        use=use,
        recycles=torch.zeros(m, **i32),
        head_blk=torch.tensor(0, **i32),
        tail_blk=torch.tensor(0, **i32),
        pushed=torch.tensor(0, dtype=torch.int64, device=device),
        popped=torch.tensor(0, dtype=torch.int64, device=device),
    )


def queue_size(q: RingQueue) -> torch.Tensor:
    return q.pushed - q.popped


def _chain(q: RingQueue, start: torch.Tensor, span: int):
    """Unrolled walk of `span` chain blocks from `start`; -1 past the end.
    Returns ([span] ids, the continuation id after the last one)."""
    ids = []
    cur = start
    for _ in range(span):
        ids.append(cur)
        safe = torch.clamp(cur, min=0).long()
        cur = torch.where(cur >= 0, q.nxt[safe], NO_BLK).to(torch.int32)
    return torch.stack(ids), cur


def push_batch(q: RingQueue, vals: torch.Tensor, mask: torch.Tensor):
    """Batched push (paper algs. 7+8). Returns (q', pushed_mask). Lanes
    fail only when the block pool is exhausted (addNode's false)."""
    k_lanes = vals.shape[0]
    b, m = q.block_size, q.max_blocks
    span = math.ceil(k_lanes / b) + 1
    dev = vals.device
    i32 = dict(dtype=torch.int32, device=dev)

    mask = mask.bool()
    offs = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
    k = mask.to(torch.int32).sum()

    tail = q.tail_blk.long()
    room0 = b - q.rear[tail]
    n_new = torch.clamp(-((room0 - k) // b), min=0)     # ceil div, >= 0

    # allocate up to span new blocks from the use[] bitmap (one ranking)
    free = ~q.use
    frank = torch.cumsum(free.to(torch.int32), 0, dtype=torch.int32) - 1
    slot_of = torch.where(free & (frank < span), frank, span)
    new_ids = scatter_drop(torch.full((span,), NO_BLK, **i32), slot_of,
                           torch.arange(m, **i32))
    j_idx = torch.arange(span, **i32)
    alloc = (j_idx < n_new) & (new_ids >= 0)           # blocks truly taken

    # lane -> (block, slot); allocation shortfalls cut a suffix of the
    # needed blocks, so failed lanes are a FIFO-safe tail
    in_tail = offs < room0
    j_lane = torch.where(in_tail, 0, (offs - room0) // b)
    blk = torch.where(
        in_tail, q.tail_blk,
        torch.where(j_lane < span,
                    new_ids[torch.clamp(j_lane, 0, span - 1).long()], NO_BLK))
    slot = torch.where(in_tail, q.rear[tail] + offs, (offs - room0) % b)
    ok = mask & (blk >= 0) & (slot < b)

    flat = torch.where(ok, blk * b + slot, m * b)      # out of range: drop
    data = scatter_drop(q.data.reshape(-1), flat,
                        vals.to(q.data.dtype)).reshape(m, b)
    fe = scatter_drop(q.fe.reshape(-1), flat, FE_FULL).reshape(m, b)

    # counters and links
    k_ok = ok.to(torch.int32).sum()
    take_tail = torch.minimum(k_ok, torch.clamp(room0, min=0))
    rear = add_drop(q.rear, tail[None], take_tail[None])
    new_counts = torch.clamp(k_ok - take_tail - j_idx * b, 0, b).to(
        torch.int32)
    alloc_rows = torch.where(alloc, new_ids, m)
    rear = scatter_drop(rear, alloc_rows, new_counts)
    front = scatter_drop(q.front, alloc_rows, 0)
    use = scatter_drop(q.use, alloc_rows, True)
    # wclose every block that is now full: the tail and full new blocks
    wclosed = q.wclosed.clone()
    wclosed[tail] = (rear[tail] >= b) | q.wclosed[tail]
    full_new = alloc & (new_counts >= b)
    wclosed = scatter_drop(wclosed, torch.where(full_new, new_ids, m), True)

    # chain links: tail -> new0 -> new1 -> ...
    prev = torch.cat([q.tail_blk[None], new_ids[:-1]])
    nxt = scatter_drop(q.nxt, torch.where(alloc, prev, m), new_ids)
    n_alloc = alloc.to(torch.int32).sum()
    tail_blk = torch.where(
        n_alloc > 0, new_ids[torch.clamp(n_alloc - 1, min=0).long()],
        q.tail_blk)

    q2 = q._replace(data=data, fe=fe, front=front, rear=rear,
                    wclosed=wclosed, nxt=nxt, use=use, tail_blk=tail_blk,
                    pushed=q.pushed + k_ok.to(torch.int64))
    return q2, ok


def pop_batch(q: RingQueue, n_lanes: int, want: torch.Tensor | None = None):
    """Batched pop (paper algs. 9+10). Returns (q', vals, got_mask).

    Exhausted wclosed blocks are rclosed, unlinked, reset and recycled
    (recycle counter bump, the ABA guard); the tail block is never
    recycled (alg. 10's `n != cn` check)."""
    b, m = q.block_size, q.max_blocks
    span = math.ceil(n_lanes / b) + 1
    dev = q.data.device
    if want is None:
        want = torch.ones(n_lanes, dtype=torch.bool, device=dev)
    want = want.bool()
    rank = torch.cumsum(want.to(torch.int32), 0, dtype=torch.int32) - 1

    ids, follow = _chain(q, q.head_blk, span)
    safe = torch.clamp(ids, min=0).long()
    valid_blk = ids >= 0
    fronts = torch.where(valid_blk, q.front[safe], 0)
    rears = torch.where(valid_blk, q.rear[safe], 0)
    avail = torch.clamp(rears - fronts, min=0)
    cum = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                     torch.cumsum(avail, 0, dtype=torch.int32)])
    total = cum[-1]

    got = want & (rank < total)
    j = torch.searchsorted(cum[1:].contiguous(), rank, right=True)
    j = torch.clamp(j, 0, span - 1)
    blk = safe[j]
    slot = fronts[j] + rank - cum[j]
    flat = torch.where(got, blk * b + slot, m * b)

    gidx = torch.clamp(flat, max=m * b - 1)
    vals = q.data.reshape(-1)[gidx]
    fe_at = q.fe.reshape(-1)[gidx]
    got = got & (fe_at == FE_FULL)               # invariant guard (retry)
    vals = torch.where(got, vals, torch.zeros((), dtype=q.data.dtype,
                                              device=dev))

    fe = scatter_drop(q.fe.reshape(-1), torch.where(got, flat, m * b),
                      FE_CONSUMED).reshape(m, b)
    k = got.to(torch.int32).sum()
    taken_j = torch.minimum(torch.clamp(k - cum[:-1], min=0), avail)
    front = add_drop(q.front, torch.where(valid_blk, ids, m), taken_j)

    # recycle exhausted blocks (deleteNode)
    new_fronts = fronts + taken_j
    dead = (valid_blk & q.wclosed[safe] & (new_fronts >= b)
            & (ids != q.tail_blk))
    dead_rows = torch.where(dead, ids, m)
    fe = scatter_drop(fe, dead_rows, FE_EMPTY)
    front = scatter_drop(front, dead_rows, 0)
    rear = scatter_drop(q.rear, dead_rows, 0)
    wclosed = scatter_drop(q.wclosed, dead_rows, False)
    rclosed = scatter_drop(q.rclosed, dead_rows, False)
    nxt = scatter_drop(q.nxt, dead_rows, NO_BLK)
    use = scatter_drop(q.use, dead_rows, False)
    recycles = add_drop(q.recycles, dead_rows, 1)

    # the head advances past the dead prefix: to the first alive chain
    # block, else to the chain's continuation (jumping straight to the
    # tail would orphan unconsumed blocks in between)
    alive = valid_blk & ~dead
    first_alive = torch.argmax(alive.to(torch.uint8))
    cont = torch.where(follow >= 0, follow, q.tail_blk)
    head_blk = torch.where(alive.any(), safe[first_alive].to(torch.int32),
                           cont)

    q2 = q._replace(fe=fe, front=front, rear=rear, wclosed=wclosed,
                    rclosed=rclosed, nxt=nxt, use=use, recycles=recycles,
                    head_blk=head_blk, popped=q.popped + k.to(torch.int64))
    return q2, vals, got


def push_one(q: RingQueue, val) -> tuple[RingQueue, torch.Tensor]:
    """Push one value (a u64 as its int64 bit pattern). Returns (q', ok)."""
    dev = q.data.device
    vals = torch.as_tensor([val], dtype=q.data.dtype, device=dev)
    q2, ok = push_batch(q, vals, torch.ones(1, dtype=torch.bool, device=dev))
    return q2, ok[0]


def pop_one(q: RingQueue):
    """Pop one value. Returns (q', val, got); val is 0 when nothing was
    there."""
    q2, vals, got = pop_batch(q, 1)
    return q2, vals[0], got[0]
