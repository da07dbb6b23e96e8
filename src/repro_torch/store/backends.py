"""Flat `Store` backends of the port: `det_skiplist` and `fixed_hash`
(counterpart of `repro.store.backends`; the other flat structures wait
for later slices).

All backends share one linearization: INSERTS apply first
(insert-if-absent, first lane wins on in-batch duplicates), then DELETES
(first lane wins), then RANGE_DELETES on ordered backends, then FINDS
observe the post-update state.
"""
from __future__ import annotations

import torch

from repro_torch.core import det_skiplist as dsl
from repro_torch.core import hashtable as ht
from repro_torch.core.bits import EMPTY, KEY_INF
from repro_torch.core.layout import pow2_floor, resolve_device
from repro_torch.store import exec as exec_
from repro_torch.store import obs
from repro_torch.store.api import (OP_DELETE, OP_FIND, OP_INSERT,
                                   OP_RANGE_DELETE, OpPlan, OpResults,
                                   register, uniform_stats)


def finalize_results(ops, valid, found, fvals, inserted, existed,
                     deleted) -> OpResults:
    """The per-lane (ok, vals) encoding every backend shares."""
    ok = torch.where(ops == OP_FIND, found,
                     torch.where(ops == OP_INSERT, inserted | existed,
                                 deleted)) & valid
    res = torch.where(valid & (ops == OP_FIND), fvals,
                      torch.where(valid & (ops == OP_INSERT),
                                  existed.to(torch.int64), 0))
    return OpResults(ok=ok, vals=res)


def apply_linearized(state, plan: OpPlan, insert_fn, delete_fn, find_fn,
                     absent_key, range_delete_fn=None):
    """The shared INSERTS -> DELETES -> [RANGE_DELETES ->] FINDS execution
    over masked batch primitives. `find_fn(state, keys) -> (found, vals)`;
    `range_delete_fn(state, lo, hi, mask) -> (state, counts)` serves
    `OP_RANGE_DELETE` lanes (keys = lo, vals = hi)."""
    valid = plan.mask & (plan.ops >= 0)
    ins_m = valid & (plan.ops == OP_INSERT)
    del_m = valid & (plan.ops == OP_DELETE)
    state, inserted, existed = insert_fn(state, plan.keys, plan.vals, ins_m)
    state, deleted = delete_fn(state, plan.keys, del_m)
    rd_counts = None
    if range_delete_fn is not None:
        rd_m = valid & (plan.ops == OP_RANGE_DELETE)
        state, rd_counts = range_delete_fn(state, plan.keys, plan.vals, rd_m)
    found, fvals = find_fn(state, torch.where(valid, plan.keys, absent_key))
    res = finalize_results(plan.ops, valid, found, fvals, inserted, existed,
                           deleted)
    if rd_counts is not None:
        is_rd = valid & (plan.ops == OP_RANGE_DELETE)
        res = OpResults(ok=torch.where(is_rd, rd_counts > 0, res.ok),
                        vals=torch.where(is_rd, rd_counts.to(torch.int64),
                                         res.vals))
    return state, res


class DetSkiplistBackend:
    name = "det_skiplist"
    ordered = True

    def init(self, capacity: int, device="cuda", **kw):
        return dsl.skiplist_init(capacity, device=resolve_device(device))

    def apply(self, state, plan: OpPlan):
        state, res = apply_linearized(
            state, plan, dsl.insert_batch, dsl.delete_batch,
            lambda s, q: exec_.skiplist_find(s, q)[:2], KEY_INF,
            range_delete_fn=dsl.range_delete_batch)
        # batch clock: entries inserted by apply #b carry stamp b
        return state._replace(clock=state.clock + 1), res

    def scan(self, state, lo, hi, max_out: int, as_of_batch=None):
        return dsl.range_query(state, lo, hi, max_out,
                               as_of_batch=as_of_batch)

    def stats(self, state):
        return uniform_stats(size=state.n_term - state.n_marked,
                             tombstones=state.n_marked,
                             capacity=state.term_keys.shape[0])


class FixedHashBackend:
    name = "fixed_hash"
    ordered = False

    def init(self, capacity: int, bucket: int = 16, device="cuda", **kw):
        return ht.fixed_init(pow2_floor(max(capacity // bucket, 1)), bucket,
                             device=resolve_device(device))

    def apply(self, state, plan: OpPlan):
        def find(h, queries):
            obs.record("bucket_collisions",
                       lambda: obs.bucket_collision_count(h, queries))
            return exec_.hash_find(h, queries)
        return apply_linearized(state, plan, ht.fixed_insert, ht.fixed_delete,
                                find, EMPTY)

    def scan(self, state, lo, hi, max_out: int):
        raise NotImplementedError(
            f"{self.name} is unordered: no range scan (pick an ordered "
            f"backend or a tier stack)")

    def stats(self, state):
        return uniform_stats(size=state.count, capacity=state.keys.numel())


DET_SKIPLIST = register(DetSkiplistBackend())
FIXED_HASH = register(FixedHashBackend())
