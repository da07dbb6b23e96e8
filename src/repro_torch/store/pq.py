"""Priority-queue `Store` backend over the deterministic skiplist, PyTorch
port of `repro.store.pq` (the design of arXiv:1509.07053: the minimum is
the leftmost live terminal entry).

Two lane ops extract the minimum:

  OP_POPMIN  result vals = the popped entry's VALUE
  OP_POPK    result vals = the popped entry's KEY

All pop lanes of a plan share ONE rank pool in lane order: the j-th pop
lane (POPMIN and POPK counted together) extracts the j-th smallest live
key, so k pop lanes are a deterministic bulk pop of k. A pop lane's key is
ignored (the single-shard engine routes nothing).

Pops run as rank-select plus lazy tombstones: `exec.pq_pop` (the plain
`pop_rank_select`, or the `pq_pop` kernel) finds the rank-th smallest live
key and `det_skiplist.pop_mark` commits the extraction through the
tombstone and compaction path of deletes. FIND / INSERT / DELETE /
RANGE_DELETE lanes behave exactly as on `det_skiplist`, and the whole
linearization is INSERTS -> DELETES -> RANGE_DELETES -> POPS -> FINDS.
The counters `pops` and `pop_empty` ride in `stats()` and, while metrics
are collected, in the metrics frame.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import det_skiplist as dsl
from repro_torch.core.bits import KEY_INF
from repro_torch.core.layout import resolve_device
from repro_torch.store import exec as exec_
from repro_torch.store import obs
from repro_torch.store.api import (OP_POPK, OP_POPMIN, OpPlan, OpResults,
                                   register, uniform_stats)
from repro_torch.store.backends import apply_linearized


class PQState(NamedTuple):
    """The pq backend's state: the skiplist heap and the pop counters."""
    heap: dsl.DetSkiplist
    n_pops: torch.Tensor       # () int64 successful pop lanes
    n_pop_empty: torch.Tensor  # () int64 pop lanes that found it empty


class PQSkiplistBackend:
    name = "pq"
    ordered = True

    def init(self, capacity: int, device="cuda", **kw) -> PQState:
        dev = resolve_device(device)
        z = torch.tensor(0, dtype=torch.int64, device=dev)
        return PQState(heap=dsl.skiplist_init(capacity, device=dev),
                       n_pops=z, n_pop_empty=z.clone())

    def apply(self, state: PQState, plan: OpPlan):
        valid = plan.mask & (plan.ops >= 0)
        is_pop = (plan.ops == OP_POPMIN) | (plan.ops == OP_POPK)
        pop_m = valid & is_pop
        popped_state = {}

        def popping_find(heap, queries):
            # `apply_linearized` calls its find closure once, after every
            # update phase: committing the pops here puts them between the
            # range deletes and the finds
            ranks = torch.cumsum(pop_m.to(torch.int32), 0,
                                 dtype=torch.int32) - 1
            with obs.span("pop", backend=self.name):
                popped, pkeys, pidx = exec_.pq_pop(heap, ranks, pop_m)
                pvals = torch.where(popped, heap.term_vals[pidx.long()], 0)
                heap = dsl.pop_mark(heap, pidx, popped)
            obs.record("pops", lambda: popped.sum())
            obs.record("pop_empty", lambda: (pop_m & ~popped).sum())
            popped_state.update(heap=heap, res=(popped, pkeys, pvals))
            return exec_.skiplist_find(heap, queries)[:2]

        _, res = apply_linearized(
            state.heap, plan, dsl.insert_batch, dsl.delete_batch,
            popping_find, KEY_INF, range_delete_fn=dsl.range_delete_batch)
        heap = popped_state["heap"]
        popped, pkeys, pvals = popped_state["res"]

        # pop lanes: ok = a live entry was extracted; vals = its VALUE
        # (POPMIN) or its KEY (POPK)
        pres = torch.where(popped,
                           torch.where(plan.ops == OP_POPMIN, pvals, pkeys),
                           0)
        res = OpResults(ok=torch.where(is_pop, popped, res.ok),
                        vals=torch.where(is_pop & valid, pres, res.vals))
        # the batch clock ticks once per apply, as on det_skiplist
        return PQState(heap=heap._replace(clock=heap.clock + 1),
                       n_pops=state.n_pops + popped.sum(),
                       n_pop_empty=state.n_pop_empty
                       + (pop_m & ~popped).sum()), res

    def scan(self, state: PQState, lo, hi, max_out: int, as_of_batch=None):
        return dsl.range_query(state.heap, lo, hi, max_out,
                               as_of_batch=as_of_batch)

    def stats(self, state: PQState):
        return uniform_stats(
            size=state.heap.n_term - state.heap.n_marked,
            tombstones=state.heap.n_marked,
            capacity=state.heap.term_keys.shape[0],
            pops=state.n_pops, pop_empty=state.n_pop_empty)


PQ = register(PQSkiplistBackend())
