"""Storage-engine protocol, PyTorch port of `repro.store.api`.

* `OpPlan` — a batch of K ops as parallel tensors (ops int32, keys and
  vals as int64 u64 bit patterns, mask bool); one linearization unit with
  the order INSERTS -> DELETES -> RANGE_DELETES -> POPS -> FINDS, first
  lane wins on in-batch duplicates.
* `OpResults` — per-lane (ok, vals): FIND -> (hit, value); INSERT ->
  (applied or existed, existed flag); DELETE -> (removed, 0);
  RANGE_DELETE -> (any deleted, count); POPMIN / POPK -> (popped, the
  popped value / key).
* `STATS_SCHEMA` / `uniform_stats` — the closed occupancy key set.
* the registry — backends register under their reference names.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core.bits import from_u64

OP_NONE, OP_FIND, OP_INSERT, OP_DELETE, OP_RANGE = -1, 0, 1, 2, 3
OP_POPMIN, OP_POPK, OP_RANGE_DELETE = 4, 5, 6

# The closed set of executable lane op codes (OP_NONE is the idle lane, not
# an op); the resilience layer treats any other value as a poisoned lane.
VALID_OPS = frozenset((OP_FIND, OP_INSERT, OP_DELETE, OP_RANGE,
                       OP_POPMIN, OP_POPK, OP_RANGE_DELETE))


class OpPlan(NamedTuple):
    """A batch of K ops as parallel tensors — the unit of linearization."""
    ops: torch.Tensor    # [K] int32 op codes (OP_NONE lanes are idle)
    keys: torch.Tensor   # [K] int64 (u64 bits)
    vals: torch.Tensor   # [K] int64 (u64 bits)
    mask: torch.Tensor   # [K] bool

    @property
    def width(self) -> int:
        return self.ops.shape[0]


class OpResults(NamedTuple):
    ok: torch.Tensor     # [K] bool
    vals: torch.Tensor   # [K] int64 (u64 bits)


def _keys(x, device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.int64)
    return from_u64(x, device)


def make_plan(ops, keys, vals=None, mask=None, *, device) -> OpPlan:
    """Plan constructor: numpy/sequence u64 keys and vals (or int64
    tensors) on `device`, default zero vals and all-true mask."""
    if not torch.is_tensor(ops):
        ops = torch.from_numpy(np.asarray(ops, np.int32))
    ops = ops.to(device=device, dtype=torch.int32)
    keys = _keys(keys, device)
    vals = torch.zeros_like(keys) if vals is None else _keys(vals, device)
    if mask is None:
        mask = torch.ones(ops.shape, dtype=torch.bool, device=device)
    elif not torch.is_tensor(mask):
        mask = torch.from_numpy(np.asarray(mask, bool))
    mask = mask.to(device=device, dtype=torch.bool)
    return OpPlan(ops=ops, keys=keys, vals=vals, mask=mask)


@runtime_checkable
class Store(Protocol):
    """Backend protocol: `init(capacity, device=..., **kw)` builds a state
    (a NamedTuple of tensors); `apply(state, plan)` executes a plan;
    `scan` is the ordered range query; `stats` returns `STATS_SCHEMA`."""

    name: str
    ordered: bool

    def init(self, capacity: int, device="cuda", **kw) -> Any:
        ...

    def apply(self, state: Any, plan: OpPlan) -> tuple[Any, OpResults]:
        ...

    def scan(self, state: Any, lo, hi, max_out: int):
        ...

    def stats(self, state: Any) -> Dict[str, torch.Tensor]:
        ...


STATS_SCHEMA = ("size", "capacity", "tombstones", "hot_size", "cold_size",
                "spill_size", "l2_tables", "slots", "evictions", "promotions",
                "pops", "pop_empty")


def uniform_stats(**counters) -> Dict[str, torch.Tensor]:
    """Pad a backend's counters to `STATS_SCHEMA` (missing keys become
    int64 zeros; unknown keys are an error)."""
    unknown = set(counters) - set(STATS_SCHEMA)
    if unknown:
        raise ValueError(f"stats keys {sorted(unknown)} not in STATS_SCHEMA; "
                         f"extend api.STATS_SCHEMA to add a counter")
    return {k: torch.as_tensor(counters.get(k, 0)).to(torch.int64)
            for k in STATS_SCHEMA}


_REGISTRY: Dict[str, Store] = {}


def register(backend: Store) -> Store:
    """Register a backend instance under its `name`."""
    if backend.name in _REGISTRY:
        raise ValueError(f"store backend {backend.name!r} already registered")
    _REGISTRY[backend.name] = backend
    return backend


def _ensure_builtin() -> None:
    from repro_torch.store import backends, pq, tiers  # noqa: F401


def get_backend(name: str) -> Store:
    """Look up a registered backend by its registry string. The `obs:`
    prefix wraps any registered backend in `obs.ObservedStore`, whose
    state carries the metrics plane."""
    if name.startswith("obs:"):
        from repro_torch.store.obs import ObservedStore
        return ObservedStore(get_backend(name[len("obs:"):]))
    _ensure_builtin()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown store backend {name!r}; "
                       f"available: {sorted(_REGISTRY)}") from None


def available_backends() -> list[str]:
    """Sorted registry strings of every registered backend."""
    _ensure_builtin()
    return sorted(_REGISTRY)
