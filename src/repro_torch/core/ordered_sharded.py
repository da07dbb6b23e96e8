"""Sharded ordered-set service: routing + deterministic skiplist (paper §VI;
counterpart of `repro.core.ordered_sharded`).

The paper's flagship experiment: 8 skiplists, one per NUMA node, the key
space partitioned by the top 3 key bits, queues carrying each key to a
thread on the owner node. Here: one skiplist per shard of a folded
`routing.ShardMesh`, the key space partitioned by the top log2(n_shards)
key bits, the hierarchical route (coarsest axis first), batched ops
applied per shard, results routed back to the requesting shard and lane.

Batch linearization order (deterministic): INSERTS, then DELETES, then
FINDS. A find in batch t observes every insert/delete of batches <= t.

A compatibility veneer over `repro_torch.store.engine`, which runs the
same step over any registered backend: these wrappers pin the backend the
paper used, the deterministic skiplist.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.core.routing import ShardMesh
from repro_torch.store import engine as store_engine
# op codes are canonical in repro_torch.store.api; re-exported for callers
from repro_torch.store.api import (OP_DELETE, OP_FIND, OP_INSERT,  # noqa: F401
                                   OP_NONE, OP_RANGE)

store_sharding = store_engine.store_sharding


def sharded_store_init(n_shards: int, capacity_per_shard: int, *,
                       device="cuda") -> tuple:
    """One skiplist state per shard."""
    return store_engine.sharded_init("det_skiplist", n_shards,
                                     capacity_per_shard, device=device)


def make_store_step(mesh: ShardMesh, axis_names: Sequence[str], lanes: int,
                    pool_factor: int = 2):
    """The skiplist-backed batched-op step (see engine.make_store_step)."""
    return store_engine.make_store_step(mesh, axis_names, lanes,
                                        backend="det_skiplist",
                                        pool_factor=pool_factor)


def make_range_step(mesh: ShardMesh, axis_names: Sequence[str], lanes: int,
                    max_out: int, pool_factor: int = 2):
    """The skiplist-backed range step (see engine.make_range_step)."""
    return store_engine.make_range_step(mesh, axis_names, lanes, max_out,
                                        backend="det_skiplist",
                                        pool_factor=pool_factor)
