"""Store observability, first part: host trace spans and metrics frames
(counterpart of `repro.store.obs`).

* `span(name, **args)` records wall-clock spans into a context-local
  `Tracer` installed with `tracing()`; without a tracer it costs one
  context-variable read. Spans time host code: around a device call they
  measure enqueue time unless the caller synchronizes.
* `collect()` opens a metrics frame; `record(name, value)` accumulates an
  int64 counter into the innermost frame and evaluates a thunk `value` only
  when a frame is active, so un-observed stores pay nothing. The backends
  call `record` at the same points as the reference.

The `ObservedStore` wrapper, the `obs:` registry prefix and the serving /
resilience schemas wait for a later slice of the port; until then no
state carries a metrics plane and `absorb_frame` returns states unchanged.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Any, Dict, NamedTuple

import torch

from repro_torch.core.bits import EMPTY, KEY_INF
from repro_torch.core.layout import hash_slot

# the store-plane counter names (the reference's METRICS_SCHEMA without the
# host-tallied resilience counters); `record` accepts these names only
METRICS_SCHEMA = (
    "ops_find", "ops_insert", "ops_delete",
    "find_hits", "find_misses",
    "inserts_new", "inserts_existing", "deletes_hit",
    "bucket_collisions", "warm_probe_steps", "spill_runs_searched",
    "hot_hits", "warm_hits", "spill_hits",
    "evictions", "demotions", "promotions",
    "spill_appends", "tombstones_reclaimed",
    "pops", "pop_empty",
    "routed_ops", "routed_bytes",
)


class MetricsFrame:
    """Accumulator: metric name -> int64 scalar tensor."""

    __slots__ = ("acc",)

    def __init__(self):
        self.acc: Dict[str, torch.Tensor] = {}

    def add(self, name: str, value) -> None:
        if name not in METRICS_SCHEMA:
            raise ValueError(f"unknown metric {name!r}; extend "
                             f"obs.METRICS_SCHEMA")
        v = torch.as_tensor(value).to(torch.int64)
        self.acc[name] = self.acc[name] + v if name in self.acc else v


_FRAMES: ContextVar[tuple] = ContextVar("repro_torch_obs_frames", default=())


@contextmanager
def collect():
    """Open a metrics frame; frames nest and `record` lands in the
    innermost one."""
    frame = MetricsFrame()
    token = _FRAMES.set(_FRAMES.get() + (frame,))
    try:
        yield frame
    finally:
        _FRAMES.reset(token)


def collecting() -> bool:
    return bool(_FRAMES.get())


def record(name: str, value) -> None:
    """Accumulate `value` (or a zero-arg thunk's result) into the innermost
    active frame; a no-op without one."""
    frames = _FRAMES.get()
    if not frames:
        return
    frames[-1].add(name, value() if callable(value) else value)


def absorb_frame(state, frame) -> Any:
    """Fold an external frame into an observed state. No state of this
    slice carries a metrics plane, so states pass through unchanged."""
    return state


def bucket_collision_count(table, queries: torch.Tensor) -> torch.Tensor:
    """Live non-matching cells in every probed lane's bucket row (query not
    a sentinel): the probe-chain length analogue."""
    rows = table.keys[hash_slot(queries, table.num_slots).long()]
    live = (queries != EMPTY) & (queries != KEY_INF)
    coll = (rows != EMPTY) & (rows != queries[:, None])
    return (coll & live[:, None]).sum().to(torch.int64)


class Span(NamedTuple):
    name: str
    cat: str
    ts_ns: int
    dur_ns: int
    args: Dict[str, Any]


class Tracer:
    """Span sink: the spans plus the recording epoch `t0_ns`."""

    def __init__(self):
        self.t0_ns = time.perf_counter_ns()
        self.spans: list[Span] = []

    def add(self, name, cat, ts_ns, dur_ns, args) -> None:
        self.spans.append(Span(name=name, cat=cat, ts_ns=ts_ns,
                               dur_ns=dur_ns, args=args))


_TRACER: ContextVar[Tracer | None] = ContextVar("repro_torch_obs_tracer",
                                                default=None)


@contextmanager
def tracing(tracer: Tracer | None = None):
    """Install a Tracer for the block; yields it."""
    tr = tracer if tracer is not None else Tracer()
    token = _TRACER.set(tr)
    try:
        yield tr
    finally:
        _TRACER.reset(token)


@contextmanager
def span(name: str, cat: str = "host", **args):
    """One host wall-clock span, recorded when a Tracer is installed."""
    tr = _TRACER.get()
    if tr is None:
        yield
        return
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        tr.add(name, cat, t0, time.perf_counter_ns() - t0, args)
