"""Block memory manager (paper §V), PyTorch port of `repro.core.blockpool`.

A fixed set of block ids; the free list is an array ring with monotone
int64 head/tail counters (a batch's fetch-adds become a cumsum that hands
out distinct ring slots), and per-block generation counters replace the
paper's recycle refcounts as the ABA guard. `BlockPool` manages ids and
generations only; the payload arrays live with the user (the two-level
hash's L2 tables).

The reference's generations are uint32. PyTorch has no `+` for uint32,
so `gen` is carried as int32 (same bits, same wrap-around);
`repro_torch.convert` gives uint32 back. A handle is the u64
`(gen << 32) | id` as its int64 bit pattern.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.bits import KEY_INF, shr
from repro_torch.core.layout import scatter_drop

_LOW32 = 0xFFFFFFFF


class FreeRing(NamedTuple):
    """MPMC ring of int32 ids; slot = counter mod capacity, head == tail
    means empty."""
    buf: torch.Tensor    # [cap] int32
    head: torch.Tensor   # () int64, pop side
    tail: torch.Tensor   # () int64, push side

    @property
    def capacity(self) -> int:
        return self.buf.shape[0]

    def size(self) -> torch.Tensor:
        return self.tail - self.head


def freering_init(capacity: int, fill_ids: int | None = None, *,
                  device) -> FreeRing:
    """A ring, optionally pre-filled with ids 0..fill_ids-1 (a fresh pool)."""
    buf = torch.zeros(capacity, dtype=torch.int32, device=device)
    n = 0
    if fill_ids:
        if fill_ids > capacity:
            raise ValueError(f"fill_ids {fill_ids} > capacity {capacity}")
        buf[:fill_ids] = torch.arange(fill_ids, dtype=torch.int32,
                                      device=device)
        n = fill_ids
    i64 = dict(dtype=torch.int64, device=device)
    return FreeRing(buf=buf, head=torch.tensor(0, **i64),
                    tail=torch.tensor(n, **i64))


def freering_push(ring: FreeRing, ids: torch.Tensor,
                  mask: torch.Tensor) -> FreeRing:
    """Batched push of ids where mask (ids < 0 are skipped)."""
    mask = mask & (ids >= 0)
    offs = torch.cumsum(mask.to(torch.int64), 0) - 1
    pos = ((ring.tail + offs) % ring.capacity).to(torch.int32)
    pos = torch.where(mask, pos, ring.capacity)
    buf = scatter_drop(ring.buf, pos, ids.to(torch.int32))
    return FreeRing(buf=buf, head=ring.head,
                    tail=ring.tail + mask.to(torch.int64).sum())


def freering_pop(ring: FreeRing, want: torch.Tensor):
    """Batched pop: lane i (with want[i]) receives an id iff its rank among
    wanting lanes < available. Returns (ring, ids [-1 on failure], got)."""
    rank = torch.cumsum(want.to(torch.int64), 0) - 1
    got = want & (rank < ring.tail - ring.head)
    pos = ((ring.head + rank) % ring.capacity).long()
    ids = torch.where(got, ring.buf[pos], -1).to(torch.int32)
    return (FreeRing(buf=ring.buf, head=ring.head + got.to(torch.int64).sum(),
                     tail=ring.tail), ids, got)


class BlockPool(NamedTuple):
    """Id/generation pool; the gen bump on free is the recycle counter."""
    free: FreeRing
    gen: torch.Tensor      # [num_blocks] int32 (the reference's uint32 bits)
    in_use: torch.Tensor   # [num_blocks] bool, the paper's use[] bitmap

    @property
    def num_blocks(self) -> int:
        return self.gen.shape[0]

    def num_free(self) -> torch.Tensor:
        return self.free.size()


def blockpool_init(num_blocks: int, *, device) -> BlockPool:
    return BlockPool(
        free=freering_init(num_blocks, fill_ids=num_blocks, device=device),
        gen=torch.zeros(num_blocks, dtype=torch.int32, device=device),
        in_use=torch.zeros(num_blocks, dtype=torch.bool, device=device))


def _gen_u64(gen: torch.Tensor) -> torch.Tensor:
    """int32 generations -> their uint32 values in int64."""
    return gen.to(torch.int64) & _LOW32


def pool_alloc(pool: BlockPool, want: torch.Tensor):
    """Batched alloc. Returns (pool, ids [-1 on failure], handles [KEY_INF
    on failure], got)."""
    free, ids, got = freering_pop(pool.free, want)
    safe = torch.where(got, ids, 0).long()
    handles = (_gen_u64(pool.gen[safe]) << 32) | safe
    handles = torch.where(got, handles, KEY_INF)
    in_use = scatter_drop(pool.in_use, torch.where(got, ids, pool.num_blocks),
                          True)
    return BlockPool(free=free, gen=pool.gen, in_use=in_use), ids, handles, got


def pool_free(pool: BlockPool, ids: torch.Tensor,
              mask: torch.Tensor) -> BlockPool:
    """Batched free: generation bump (wrapping) and push back on the ring."""
    mask = mask & (ids >= 0)
    nb = pool.num_blocks
    safe = torch.where(mask, ids, nb).long()
    gen = torch.cat([pool.gen, pool.gen.new_zeros(1)])
    gen.index_add_(0, safe, torch.ones_like(safe, dtype=torch.int32))
    in_use = scatter_drop(pool.in_use, safe, False)
    return BlockPool(free=freering_push(pool.free, ids, mask), gen=gen[:nb],
                     in_use=in_use)


def handle_valid(pool: BlockPool, handles: torch.Tensor) -> torch.Tensor:
    """ABA check: a handle is valid iff its block is in use and its
    generation matches the pool's."""
    ids = handles & _LOW32
    ok_id = ids < pool.num_blocks
    safe = torch.clamp(ids, 0, pool.num_blocks - 1)
    return (ok_id & (_gen_u64(pool.gen[safe]) == shr(handles, 32))
            & pool.in_use[safe])


def expected_blocks_in_use(n_ops: int, block_size: int) -> float:
    """Paper eq. (5): the average number of blocks in use over all valid
    prefixes of `n_ops` news and deletes with blocks of `block_size`,

      sum_{k=1..N} sum_{i=0..k} ceil((k-i)/C) / sum_{i=1..N} i

    (k news, i deletes, C the block size)."""
    num = 0
    for k in range(1, n_ops + 1):
        num += sum(-(-(k - i) // block_size) for i in range(k + 1))
    return num / (n_ops * (n_ops + 1) // 2)
