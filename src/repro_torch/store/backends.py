"""Flat `Store` backends of the port (counterpart of
`repro.store.backends`): `det_skiplist`, `rand_skiplist`, `fixed_hash`,
`twolevel_hash`, `splitorder` and `twolevel_splitorder`.

All backends share one linearization: INSERTS apply first
(insert-if-absent, first lane wins on in-batch duplicates), then DELETES
(first lane wins), then RANGE_DELETES on ordered backends, then FINDS
observe the post-update state.
"""
from __future__ import annotations

import torch

from repro_torch.core import det_skiplist as dsl
from repro_torch.core import hashtable as ht
from repro_torch.core import rand_skiplist as rsl
from repro_torch.core import splitorder as so
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
    kernelized = True      # FIND -> kernels/skiplist_search

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


class RandSkiplistBackend:
    name = "rand_skiplist"
    ordered = True
    kernelized = False     # the MAX_GAP walk stays plain in every mode

    def init(self, capacity: int, device="cuda", **kw):
        return rsl.rand_skiplist_init(capacity, device=resolve_device(device))

    def apply(self, state, plan: OpPlan):
        return apply_linearized(
            state, plan, rsl.insert_batch, rsl.delete_batch,
            lambda s, q: exec_.rand_skiplist_find(s, q)[:2], KEY_INF)

    def scan(self, state, lo, hi, max_out: int):
        # the same contiguous sorted terminal level as det_skiplist
        return dsl.range_query(state, lo, hi, max_out)

    def stats(self, state):
        return uniform_stats(size=state.n_term - state.n_marked,
                             tombstones=state.n_marked,
                             capacity=state.term_keys.shape[0])


class _Unordered:
    ordered = False
    kernelized = False

    def scan(self, state, lo, hi, max_out: int):
        raise NotImplementedError(
            f"{self.name} is unordered: no range scan (pick an ordered "
            f"backend or a tier stack)")


class FixedHashBackend(_Unordered):
    name = "fixed_hash"
    kernelized = True      # probe -> kernels/hash_probe

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

    def stats(self, state):
        return uniform_stats(size=state.count, capacity=state.keys.numel())


class TwoLevelHashBackend(_Unordered):
    name = "twolevel_hash"

    def init(self, capacity: int, b1: int = 8, m2: int = 16, b2: int = 8,
             pool_blocks: int | None = None, device="cuda", **kw):
        m1 = pow2_floor(max(capacity // (2 * b1), 1))
        if pool_blocks is None:
            # every L1 slot can expand once (paper table V)
            pool_blocks = max(m1, 8)
        return ht.twolevel_init(m1, b1, m2, b2, pool_blocks,
                                device=resolve_device(device))

    def apply(self, state, plan: OpPlan):
        return apply_linearized(state, plan, ht.twolevel_insert,
                                ht.twolevel_delete, exec_.twolevel_hash_find,
                                EMPTY)

    def stats(self, state):
        return uniform_stats(
            size=state.count,
            capacity=state.l1_keys.numel() + state.l2_keys.numel(),
            l2_tables=(state.l2_block >= 0).sum())


class SplitOrderBackend(_Unordered):
    name = "splitorder"

    def init(self, capacity: int, seed_slots: int = 4, max_load: int = 16,
             device="cuda", **kw):
        return so.splitorder_init(capacity, seed_slots, max_load,
                                  device=resolve_device(device))

    def apply(self, state, plan: OpPlan):
        return apply_linearized(state, plan, so.splitorder_insert,
                                so.splitorder_delete, exec_.splitorder_find,
                                KEY_INF)

    def stats(self, state):
        return uniform_stats(size=state.n, capacity=state.rk.shape[0],
                             slots=state.n_slots)


class TwoLevelSplitOrderBackend(_Unordered):
    name = "twolevel_splitorder"
    kernelized = True      # probe -> kernels/splitorder_probe

    def init(self, capacity: int, num_tables: int = 8, seed_slots: int = 2,
             max_load: int = 16, device="cuda", **kw):
        per_table = max(capacity // num_tables, 16)
        return so.twolevel_splitorder_init(num_tables, per_table, seed_slots,
                                           max_load,
                                           device=resolve_device(device))

    def apply(self, state, plan: OpPlan):
        return apply_linearized(state, plan, so.twolevel_splitorder_insert,
                                so.twolevel_splitorder_delete,
                                exec_.twolevel_splitorder_find, KEY_INF)

    def stats(self, state):
        return uniform_stats(size=state.n.sum(), capacity=state.rk.numel(),
                             slots=state.n_slots.sum())


DET_SKIPLIST = register(DetSkiplistBackend())
RAND_SKIPLIST = register(RandSkiplistBackend())
FIXED_HASH = register(FixedHashBackend())
TWOLEVEL_HASH = register(TwoLevelHashBackend())
SPLITORDER = register(SplitOrderBackend())
TWOLEVEL_SPLITORDER = register(TwoLevelSplitOrderBackend())
