"""Hierarchical key routing over a folded shard mesh (counterpart of
`repro.core.routing`; paper §I, §VI, §VII).

The paper's pattern: partition the key space by top key bits, one
structure instance per NUMA node; queues carry each key to its owner node,
so all structure memory accesses stay local. The reference maps NUMA node
-> mesh shard and the queue hop -> `all_to_all` inside `shard_map`, one
mesh axis at a time, coarsest first.

Here every shard lives on one device, so a `ShardMesh` names the axes and
their sizes (shard linear id row-major, coarsest axis first) and the
routing runs batched over all S shards at once: per-shard arrays are
`[S, n]` tensors. A stage over axis `a` buckets each shard's lanes with a
stable per-row sort into `[S, size_a, cap]`; its `all_to_all` is the swap
of mesh axis `a` with the bucket axis (chunk i of shard c goes to the
shard whose coordinate on `a` is i, received chunks in source-coordinate
order), then a flatten and `_compact` back to the per-shard pool. So a
shard's pool holds its lanes in exactly the reference's order, which is
not global lane order.

Buckets are capacity-bounded; overflow lanes are dropped and counted per
shard (sender side for `bucketize`, receiver side for `_compact`), as in
the reference. `route_back` drops silently, and a lane it drops reads
ok=False, value 0.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from repro_torch.core.bits import KEY_INF, shr


class ShardMesh(NamedTuple):
    """Axis names and sizes of a shard mesh folded onto one device (the
    reference's `jax.sharding.Mesh`): shard ids are row-major over the
    axes, coarsest first."""
    axis_names: tuple
    axis_sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def n_shards(self) -> int:
        return int(math.prod(self.axis_sizes))


class RouteResult(NamedTuple):
    keys: torch.Tensor      # [S, P] routed keys (KEY_INF padding)
    vals: torch.Tensor      # [S, P] routed payloads
    aux: torch.Tensor       # [S, P] routed aux (the op codes), int32
    origin: torch.Tensor    # [S, P] int64: src_shard << 32 | src_lane
    valid: torch.Tensor     # [S, P] bool
    dropped: torch.Tensor   # [S] int32 capacity overflow per shard


def owner_of(keys: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Owner shard from the top log2(n_shards) key bits (u64 order)."""
    b = int(math.log2(n_shards))
    if b == 0:
        return torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    return shr(keys, 64 - b).to(torch.int32)


def _scatter(p: torch.Tensor, slot: torch.Tensor, size: int) -> torch.Tensor:
    """Write p[..., i] to [..., slot[..., i]] of a zero buffer of `size`
    cells along the last dim; slot == size lands in a cell cut off after
    (the reference's mode="drop")."""
    buf = torch.zeros(p.shape[:-1] + (size + 1,), dtype=p.dtype,
                      device=p.device)
    return buf.scatter_(-1, slot.long(), p)[..., :size]


def bucketize(dest: torch.Tensor, valid: torch.Tensor,
              payloads: Sequence[torch.Tensor], n_dest: int, capacity: int):
    """Group lanes by destination with per-destination capacity, per row
    of `[..., n]` inputs. Returns ([..., n_dest, capacity] buffers...,
    valid[..., n_dest, capacity], dropped[...] int32). Lanes sort stably
    by dest; overflow drops the highest ranks."""
    n = dest.shape[-1]
    sort_key = torch.where(valid, dest.to(torch.int32),
                           torch.full_like(dest, n_dest, dtype=torch.int32))
    order = torch.argsort(sort_key, dim=-1, stable=True)
    sd = torch.gather(sort_key, -1, order)
    sv = torch.gather(valid, -1, order)
    run_start = torch.searchsorted(sd.contiguous(), sd.contiguous(),
                                   side="left", out_int32=True)
    rank = torch.arange(n, dtype=torch.int32, device=dest.device) - run_start
    keep = sv & (rank < capacity) & (sd < n_dest)
    dropped = (sv & ~keep).sum(-1, dtype=torch.int32)
    slot = torch.where(keep, sd * capacity + rank,
                       torch.full_like(sd, n_dest * capacity))
    lead = dest.shape[:-1]
    out = [_scatter(torch.gather(p, -1, order), slot, n_dest * capacity
                    ).reshape(lead + (n_dest, capacity)) for p in payloads]
    vbuf = _scatter(keep, slot, n_dest * capacity)
    return out, vbuf.reshape(lead + (n_dest, capacity)), dropped


def _compact(payloads: Sequence[torch.Tensor], valid: torch.Tensor,
             out_size: int):
    """Compact valid lanes to a prefix of a fixed-size pool, per row.
    Returns (*payloads, valid, dropped[...] int32): overflow is counted,
    never silent."""
    rank = torch.cumsum(valid.to(torch.int32), -1, dtype=torch.int32) - 1
    keep = valid & (rank < out_size)
    dropped = (valid & ~keep).sum(-1, dtype=torch.int32)
    slot = torch.where(keep, rank, torch.full_like(rank, out_size))
    outs = [_scatter(p, slot, out_size) for p in payloads]
    return (*outs, _scatter(keep, slot, out_size), dropped)


def _weights(axis_sizes: Sequence[int]) -> list:
    """Digit weights, coarsest first: owner = d0 * (s1 * s2 ..) + d1 *
    (s2 ..) + ..."""
    out, rem = [], int(math.prod(axis_sizes))
    for s in axis_sizes:
        rem //= s
        out.append(rem)
    return out


def _a2a(x: torch.Tensor, axis_sizes: Sequence[int], axis: int):
    """The queue hop of one stage: x [S, size_a, cap] per shard; chunk i
    of the shard at coordinate c on mesh axis `axis` lands as chunk c of
    the shard at coordinate i. Returns the [S, size_a * cap] receive
    buffers, chunks in source-coordinate order."""
    k = len(axis_sizes)
    m = x.reshape(tuple(axis_sizes) + x.shape[1:])
    m = m.transpose(axis, k).contiguous()
    return m.reshape(x.shape[0], -1)


def route_to_owners(keys: torch.Tensor, vals: torch.Tensor,
                    aux: torch.Tensor, valid: torch.Tensor,
                    axis_names: Sequence[str], axis_sizes: Sequence[int],
                    pool: int) -> RouteResult:
    """Route (key, val, aux) lanes `[S, n]` to their owner shards, one
    mesh axis a stage, coarsest first: the hierarchical NUMA route. `pool`
    is the per-shard lane budget after every stage."""
    assert len(axis_names) == len(axis_sizes)
    S, n = keys.shape
    dev = keys.device
    n_shards = int(math.prod(axis_sizes))
    assert S == n_shards, (S, n_shards)
    me = torch.arange(S, dtype=torch.int64, device=dev)[:, None]
    lane = torch.arange(n, dtype=torch.int64, device=dev)[None, :]
    origin = ((me << 32) | lane).expand(S, n)
    dropped = torch.zeros(S, dtype=torch.int32, device=dev)
    for a, (size, w) in enumerate(zip(axis_sizes, _weights(axis_sizes))):
        digit = (owner_of(keys, n_shards) // w) % size
        cap = max(1, -(-pool // size))
        bufs, vb, drop = bucketize(digit, valid, [keys, vals, aux, origin],
                                   size, cap)
        dropped = dropped + drop
        keys, vals, aux, origin, valid = (_a2a(x, axis_sizes, a)
                                          for x in (*bufs, vb))
        keys, vals, aux, origin, valid, drop2 = _compact(
            [keys, vals, aux, origin], valid, pool)
        dropped = dropped + drop2
    keys = torch.where(valid, keys, KEY_INF)
    return RouteResult(keys=keys, vals=vals, aux=aux, origin=origin,
                       valid=valid, dropped=dropped)


def route_back(results: torch.Tensor, found: torch.Tensor,
               origin: torch.Tensor, valid: torch.Tensor,
               axis_names: Sequence[str], axis_sizes: Sequence[int],
               lanes_out: int):
    """Send per-op results `[S, P]` back to their source shard and lane,
    finest axis first (the return queue). Returns (results[S, lanes_out],
    found[S, lanes_out]) in the original lane positions."""
    src = shr(origin, 32).to(torch.int32)
    lane = (origin & 0xFFFFFFFF).to(torch.int32)
    pool = results.shape[-1]
    found = found.to(torch.int32)
    stages = list(enumerate(zip(axis_sizes, _weights(axis_sizes))))
    for a, (size, w) in reversed(stages):
        digit = (src // w) % size
        cap = max(1, -(-pool // size))
        bufs, vb, _ = bucketize(digit, valid, [results, found, src, lane],
                                size, cap)
        results, found, src, lane, valid = (_a2a(x, axis_sizes, a)
                                            for x in (*bufs, vb))
        results, found, src, lane, valid, _ = _compact(
            [results, found, src, lane], valid, pool)
    slot = torch.where(valid, lane, torch.full_like(lane, lanes_out))
    out_r = _scatter(results, slot, lanes_out)
    out_f = _scatter(found.bool() & valid, slot, lanes_out)
    return out_r, out_f
