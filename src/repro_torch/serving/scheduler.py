"""Request scheduler on the Store API (counterpart of
`repro.serving.scheduler`): an `obs:pq` priority-queue store plus the §III
ring queue as the arrival buffer.

Pending requests enter the LCRQ-style ring (arrival order = FIFO ticket);
the priority index is the `pq` Store backend, keyed by (priority << 32 |
ticket) with POPMIN extraction, driven through the cached single-shard
`store.engine.local_store_engine`: submission is an OP_INSERT plan,
admission one plan of k OP_POPMIN lanes (a bulk pop of k), and
`cancel_class` drops a whole priority band with ONE OP_RANGE_DELETE lane
over [priority << 32, (priority + 1) << 32). The arrival ring is not
drained on cancellation (the store is the authoritative pending set).

Fault tolerance: `scheduler_init(resilient=True)` attaches a
`SchedResilience` record, a write-ahead `resilience.Journal` of every
store plan plus a snapshot of the empty store, so a dropped store
(`inject_fault`, the serving engine's fault plan; detected by the
`state_alive` probe before the next plan touches it) is rebuilt to the
exact pre-fault state by `recover()`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core.bits import make_priority_key
from repro_torch.core.layout import resolve_device
from repro_torch.core.ringqueue import (RingQueue, pop_batch, push_batch,
                                        queue_init)
from repro_torch.store import engine as engine_mod
from repro_torch.store import exec as exec_
from repro_torch.store import obs
from repro_torch.store import resilience as res_mod
from repro_torch.store.api import (OP_INSERT, OP_NONE, OP_POPMIN,
                                   OP_RANGE_DELETE)

BACKEND = "obs:pq"

# lane width of a cancel_class plan (one RANGE_DELETE lane, padded so the
# cached engine of this width is shared across calls)
CANCEL_LANES = 4


@dataclasses.dataclass
class SchedResilience:
    """Host-side mutable resilience record riding in the Scheduler: the
    write-ahead journal of every store plan, the snapshot it replays
    from, the resilience tally (`obs.RESILIENCE_SCHEMA`) and the plan seq
    counter."""
    journal: res_mod.Journal
    snapshot: res_mod.Snapshot
    tally: dict
    seq: int = 0


class Scheduler(NamedTuple):
    arrivals: RingQueue          # §III queue of packed (priority, ticket)
    store: Any                   # `obs:pq` store state (one shard)
    next_ticket: torch.Tensor    # () int64, monotone (the low 32 bits key)
    res: Optional[SchedResilience] = None   # journaled mode (host-side)


def _engine(lanes: int, device) -> engine_mod.StoreEngine:
    # the mode is read at call time, so `exec.exec_mode(...)` blocks flip
    # the scheduler's store between the kernels and the plain versions
    return engine_mod.local_store_engine(BACKEND, lanes, exec_.get_mode(),
                                         str(device))


def scheduler_init(max_pending: int, queue_blocks: int = 16,
                   block_size: int = 64, resilient: bool = False,
                   device="cuda") -> Scheduler:
    dev = resolve_device(device)
    store = _engine(1, dev).init(max_pending)
    res = None
    if resilient:
        res = SchedResilience(journal=res_mod.Journal(base_seq=0),
                              snapshot=res_mod.take_snapshot(store, 0),
                              tally=obs.resilience_zero())
    return Scheduler(
        arrivals=queue_init(queue_blocks, block_size, torch.int64,
                            device=dev),
        store=store,
        next_ticket=torch.tensor(0, dtype=torch.int64, device=dev),
        res=res)


def health(s: Scheduler) -> bool:
    """Liveness probe of the (one-shard) scheduler store."""
    return bool(res_mod.state_alive(s.store, 1)[0])


def recover(s: Scheduler):
    """Rebuild the scheduler store from snapshot + journal: every
    journaled plan replayed through the same cached engine steps the live
    calls used (an entry's lane width selects the engine). Returns the
    rebuilt store; the ring and the ticket counter are untouched (the
    fault model targets the store)."""
    r = s.res
    if r is None:
        raise ValueError("scheduler_init(resilient=True) required to recover")
    dev = s.next_ticket.device
    state = res_mod.snapshot_state(r.snapshot, dev)
    replayed = 0
    with obs.span("recover", mode="scheduler", replay=len(r.journal)):
        for e in r.journal.entries:
            plan = res_mod.journal.device_plan(e.ops, e.keys, e.vals, dev)
            state, _, _, _ = _engine(e.ops.shape[0], dev).step(state, *plan)
            replayed += e.n_ops
    r.tally["recoveries"] += 1
    r.tally["replayed_ops"] += replayed
    return state


def inject_fault(s: Scheduler) -> Scheduler:
    """Drop the scheduler store (zero its one shard): the serving engine's
    chaos hook, counted in `faults_injected`."""
    if s.res is not None:
        s.res.tally["faults_injected"] += 1
    return s._replace(store=res_mod.inject_shard_drop(s.store, 0))


def _store_step(s: Scheduler, ops, keys, vals):
    """Every scheduler plan funnels through here: in journaled mode, check
    health (recovering a dropped store before the plan touches it), then
    journal the plan, then step the cached engine."""
    store = s.store
    if s.res is not None:
        if not health(s):
            store = recover(s)
        s.res.journal.append(s.res.seq, ops, keys, vals)
        s.res.seq += 1
    return _engine(ops.shape[0], ops.device).step(store, ops, keys, vals)


def submit(s: Scheduler, priorities: torch.Tensor, req_ids: torch.Tensor,
           mask: torch.Tensor):
    """Enqueue arrivals: one ring push + one OP_INSERT plan (key =
    priority/ticket word, value = req_id). Returns (s', ok)."""
    tickets = s.next_ticket + torch.cumsum(mask.to(torch.int64), 0) - 1
    keys = make_priority_key(priorities, tickets)
    q, ok = push_batch(s.arrivals, keys, mask)
    ops = torch.where(mask & ok, OP_INSERT, OP_NONE).to(torch.int32)
    store, _, ins, _ = _store_step(s, ops, keys, req_ids.to(torch.int64))
    nt = s.next_ticket + mask.sum()
    return Scheduler(arrivals=q, store=store, next_ticket=nt, res=s.res), ins


def pop_min(s: Scheduler, k: int):
    """Admit the k highest-priority (lowest-key) requests: ONE plan of k
    OP_POPMIN lanes (lane j extracts the j-th smallest pending key; the
    result is the popped req_id). Returns (s', req_ids[k] int32,
    valid[k])."""
    dev = s.next_ticket.device
    ops = torch.full((k,), OP_POPMIN, dtype=torch.int32, device=dev)
    zeros = torch.zeros(k, dtype=torch.int64, device=dev)
    store, vals, popped, _ = _store_step(s, ops, zeros, zeros)
    q, _, _ = pop_batch(s.arrivals, k, popped)    # keep queue and index even
    return (Scheduler(arrivals=q, store=store, next_ticket=s.next_ticket,
                      res=s.res), vals.to(torch.int32), popped)


def cancel_class(s: Scheduler, priority: int):
    """Cancel EVERY pending request of one priority band with one
    OP_RANGE_DELETE lane over [priority << 32, (priority + 1) << 32).
    Returns (s', cancelled count). The arrival ring is not drained."""
    dev = s.next_ticket.device
    ops = torch.tensor([OP_RANGE_DELETE] + [OP_NONE] * (CANCEL_LANES - 1),
                       dtype=torch.int32, device=dev)
    keys = torch.zeros(CANCEL_LANES, dtype=torch.int64, device=dev)
    vals = torch.zeros_like(keys)
    keys[0] = priority << 32
    vals[0] = (priority + 1) << 32
    store, out, ok, _ = _store_step(s, ops, keys, vals)
    cancelled = int(out[0]) if bool(ok[0]) else 0
    return Scheduler(arrivals=s.arrivals, store=store,
                     next_ticket=s.next_ticket, res=s.res), cancelled


def pending(s: Scheduler) -> int:
    return int(engine_mod.sharded_stats(BACKEND, s.store)["size"][0])


def metrics(s: Scheduler) -> dict:
    """The scheduler store's metrics plane (pops, pop_empty, inserts_new,
    ... over `obs.METRICS_SCHEMA`) as host ints. The resilience counters
    are zeros here; `serving.engine.Engine.resilience_metrics` merges the
    host tallies in."""
    per = engine_mod.sharded_metrics(BACKEND, s.store)
    return {k: int(v[0]) for k, v in per.items()}
