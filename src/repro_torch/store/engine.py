"""Single-shard storage engine over any registered backend (counterpart of
the one-shard case of `repro.store.engine`).

With one shard the routing is the identity: a step's lanes execute in
their original order, idle lanes (op < 0) become masked `KEY_INF` lanes,
and results come back in place (idle lanes report ok=False, value 0).
The mesh-sharded engine and `core/routing.py` wait for a later slice.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.bits import KEY_INF
from repro_torch.core.layout import resolve_device
from repro_torch.store import exec as exec_
from repro_torch.store import obs
from repro_torch.store.api import OpPlan, Store, get_backend


def resolve(backend) -> Store:
    """Accept a backend instance or a registry name."""
    return get_backend(backend) if isinstance(backend, str) else backend


class StoreEngine:
    """Backend + exec mode + device, one object.

    >>> eng = StoreEngine(4096, "tiered3/lru")          # device="cuda"
    >>> state = eng.init(1 << 16)
    >>> state, vals, ok, dropped = eng.step(state, ops, keys, vals)

    `device` defaults to "cuda" and raises without a card unless "cpu" is
    passed; `exec_mode` (None = the `store.exec` default, "gpu") is applied
    around every step."""

    def __init__(self, lanes: int, backend="det_skiplist", *, device="cuda",
                 exec_mode: str | None = None):
        self.device = resolve_device(device)
        self.lanes = lanes
        self.backend = resolve(backend)
        self.exec_mode = exec_mode
        # host-side step sequence number: one per `step()` call
        self.seq = 0

    def init(self, capacity: int, **kw):
        return self.backend.init(capacity, device=self.device, **kw)

    def step(self, state, ops: torch.Tensor, keys: torch.Tensor,
             vals: torch.Tensor):
        """One batched-op step. Returns (state', vals[lanes] int64,
        ok[lanes] bool, dropped int)."""
        if ops.shape[0] != self.lanes:
            raise ValueError(f"step expects {self.lanes} lanes, "
                             f"got {ops.shape[0]}")
        seq = self.seq
        self.seq += 1
        with obs.span("step", backend=self.backend.name, lanes=self.lanes,
                      shards=1, seq=seq):
            valid = ops >= 0
            plan = OpPlan(ops=ops, keys=torch.where(valid, keys, KEY_INF),
                          vals=vals, mask=valid)
            with exec_.exec_mode(self.exec_mode):
                state, res = self.backend.apply(state, plan)
            return (state, torch.where(valid, res.vals, 0), res.ok & valid, 0)

    def stats(self, state) -> dict:
        """The backend's `STATS_SCHEMA` scalars plus the engine's `seq`."""
        out = dict(self.backend.stats(state))
        out["seq"] = self.seq
        return out


@functools.lru_cache(maxsize=None)
def local_store_engine(backend: str, lanes: int, exec_mode: str | None = None,
                       device: str = "cuda") -> StoreEngine:
    """A cached single-shard StoreEngine per (backend, lanes, mode,
    device): the serving layer's route into the Store API."""
    return StoreEngine(lanes, backend, device=device, exec_mode=exec_mode)
