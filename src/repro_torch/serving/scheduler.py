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

The journaled fault-tolerant mode (`resilient=True`, `health`,
`recover`, `inject_fault`) waits for the port of `store/resilience/`
(ROADMAP.md §1) and raises `NotImplementedError`.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core.bits import make_priority_key
from repro_torch.core.layout import resolve_device
from repro_torch.core.ringqueue import (RingQueue, pop_batch, push_batch,
                                        queue_init)
from repro_torch.store import engine as engine_mod
from repro_torch.store import exec as exec_
from repro_torch.store.api import (OP_INSERT, OP_NONE, OP_POPMIN,
                                   OP_RANGE_DELETE)

BACKEND = "obs:pq"

# lane width of a cancel_class plan (one RANGE_DELETE lane, padded so the
# cached engine of this width is shared across calls)
CANCEL_LANES = 4


class Scheduler(NamedTuple):
    arrivals: RingQueue          # §III queue of packed (priority, ticket)
    store: Any                   # `obs:pq` store state
    next_ticket: torch.Tensor    # () int64, monotone (the low 32 bits key)
    res: Optional[Any] = None    # the journaled mode (not ported)


def _not_ported(what: str):
    return NotImplementedError(
        f"{what}: the journaled scheduler waits for the port of "
        f"store/resilience/ (ROADMAP.md §1)")


def _engine(lanes: int, device) -> engine_mod.StoreEngine:
    # the mode is read at call time, so `exec.exec_mode(...)` blocks flip
    # the scheduler's store between the kernels and the plain versions
    return engine_mod.local_store_engine(BACKEND, lanes, exec_.get_mode(),
                                         str(device))


def scheduler_init(max_pending: int, queue_blocks: int = 16,
                   block_size: int = 64, resilient: bool = False,
                   device="cuda") -> Scheduler:
    if resilient:
        raise _not_ported("scheduler_init(resilient=True)")
    dev = resolve_device(device)
    return Scheduler(
        arrivals=queue_init(queue_blocks, block_size, torch.int64,
                            device=dev),
        store=_engine(1, dev).init(max_pending),
        next_ticket=torch.tensor(0, dtype=torch.int64, device=dev))


def health(s: Scheduler) -> bool:
    raise _not_ported("health")


def recover(s: Scheduler):
    raise _not_ported("recover")


def inject_fault(s: Scheduler) -> Scheduler:
    raise _not_ported("inject_fault")


def _store_step(s: Scheduler, ops, keys, vals):
    return _engine(ops.shape[0], ops.device).step(s.store, ops, keys, vals)


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


def pending(s: Scheduler) -> torch.Tensor:
    return _engine(1, s.next_ticket.device).stats(s.store)["size"]


def metrics(s: Scheduler) -> dict:
    """The scheduler store's metrics plane (pops, pop_empty, inserts_new,
    ... over `obs.METRICS_SCHEMA`) as host ints."""
    per = _engine(1, s.next_ticket.device).metrics(s.store)
    return {k: int(v) for k, v in per.items()}
