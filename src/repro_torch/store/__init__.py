"""repro_torch.store — the Store API over the ported structures.

api       op codes, `OpPlan` / `OpResults`, `STATS_SCHEMA`, the registry
exec      the execution layer: `torch` (plain versions) | `gpu` (CUDA
          kernels, the default), with the probe/update dispatch meter
obs       trace spans and the metrics collection frames
backends  `det_skiplist` and `fixed_hash`
tiers     the §IX tier stacks: `hash+skiplist`, `tiered3[/lru|/size|/b128]`
pq        the priority queue over the skiplist: `pq`
engine    the single-shard `StoreEngine`
"""
from repro_torch.store.api import (OP_DELETE, OP_FIND, OP_INSERT, OP_NONE,
                                   OP_POPK, OP_POPMIN, OP_RANGE,
                                   OP_RANGE_DELETE, STATS_SCHEMA, OpPlan,
                                   OpResults, get_backend, make_plan,
                                   register, uniform_stats)

__all__ = ["OP_DELETE", "OP_FIND", "OP_INSERT", "OP_NONE", "OP_POPK",
           "OP_POPMIN", "OP_RANGE", "OP_RANGE_DELETE", "STATS_SCHEMA",
           "OpPlan", "OpResults", "get_backend", "make_plan", "register",
           "uniform_stats"]
