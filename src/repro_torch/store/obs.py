"""Store observability (counterpart of `repro.store.obs`): in-state
metrics and host trace spans.

* `span(name, **args)` records wall-clock spans into a context-local
  `Tracer` installed with `tracing()`; without a tracer it costs one
  context-variable read. Spans time host code: around a device call they
  measure enqueue time unless the caller synchronizes.
* `collect()` opens a metrics frame; `record(name, value)` accumulates an
  int64 counter into the innermost frame and evaluates a thunk `value` only
  when a frame is active, so un-observed stores pay nothing. The backends
  call `record` at the same points as the reference.
* `ObservedStore` (the `obs:` registry prefix of `api.get_backend`) wraps
  any backend: its state is `ObservedState(inner, metrics)`, `apply`
  records the plan-level counters and folds every frame into the
  `metrics` plane, and `metrics(state)` reads it over `METRICS_SCHEMA`;
  `flush` proxies a tier stack's bulk demotion the same way.
* The six resilience counters of `METRICS_SCHEMA` never live in a state:
  they are host tallies (`resilience_zero`) merged into a metrics view by
  `merge_resilience`. The serving engine's host counters report through
  the closed `SERVING_SCHEMA` (`uniform_serving_metrics`).
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Any, Dict, NamedTuple

import torch

from repro_torch.core.bits import EMPTY, KEY_INF
from repro_torch.core.layout import (hash_slot, metrics_plane,
                                     resolve_device)

# the reference's counter names; `record` accepts these names only
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
    # host-tallied (never accumulated inside a state; `merge_resilience`)
    "faults_injected", "recoveries", "replayed_ops",
    "deadline_expired", "shed", "retries",
)

RESILIENCE_SCHEMA = ("faults_injected", "recoveries", "replayed_ops",
                     "deadline_expired", "shed", "retries")

# host-side serving-engine counters (`serving.engine.Engine.metrics()`)
SERVING_SCHEMA = ("ring_depth", "prefix_hits", "prefix_lookups",
                  "prefix_hit_rate", "batch_fill", "decode_steps",
                  "decode_tokens")

# span names; `span` accepts any name, but the instrumented modules keep
# to the reference's taxonomy so traces of the two packages line up
SPAN_TAXONOMY = ("route", "step", "find", "update", "insert", "delete",
                 "pop", "demote", "promote", "compact", "flush", "scan",
                 "admit", "prefill", "decode",
                 # a quarantined shard's snapshot + journal rebuild
                 # (store/resilience/restore.py)
                 "recover")

# bytes one routed op carries through the engine's queues: key u64 + val
# u64 + op i32 + origin i32 (the reference's routing lane payload)
ROUTED_OP_BYTES = 24


def resilience_zero() -> Dict[str, int]:
    """A zeroed host-side resilience tally (plain ints)."""
    return {k: 0 for k in RESILIENCE_SCHEMA}


def merge_resilience(metrics: Dict[str, Any],
                     tally: Dict[str, int]) -> Dict[str, Any]:
    """A metrics view with a host-side resilience tally folded in (values
    added to the store plane's zeros; other keys pass through)."""
    unknown = set(tally) - set(RESILIENCE_SCHEMA)
    if unknown:
        raise ValueError(f"resilience tally keys {sorted(unknown)} not in "
                         f"obs.RESILIENCE_SCHEMA")
    return {k: (v + tally[k] if k in tally else v)
            for k, v in metrics.items()}


def metrics_zero(device) -> Dict[str, torch.Tensor]:
    """A zeroed metrics plane over `METRICS_SCHEMA` on `device`."""
    return metrics_plane(METRICS_SCHEMA, device=device)


def uniform_serving_metrics(**counters) -> Dict[str, Any]:
    """Pad host-side serving counters to the closed `SERVING_SCHEMA`
    (unknown keys are an error)."""
    unknown = set(counters) - set(SERVING_SCHEMA)
    if unknown:
        raise ValueError(f"serving metric keys {sorted(unknown)} not in "
                         f"SERVING_SCHEMA; extend obs.SERVING_SCHEMA")
    return {k: counters.get(k, 0) for k in SERVING_SCHEMA}


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


def merge_metrics(metrics: Dict[str, torch.Tensor],
                  frame: MetricsFrame) -> Dict[str, torch.Tensor]:
    """metrics plane + one frame's accumulations (schema-complete)."""
    return {k: (metrics[k] + frame.acc[k]) if k in frame.acc else metrics[k]
            for k in METRICS_SCHEMA}


def absorb_frame(state, frame) -> Any:
    """Fold an external frame (the engine's routing counters) into an
    observed state; other states pass through unchanged."""
    if isinstance(state, ObservedState) and frame is not None and frame.acc:
        return ObservedState(inner=state.inner,
                             metrics=merge_metrics(state.metrics, frame))
    return state


class ObservedState(NamedTuple):
    """An observed backend's state: the wrapped backend's state plus the
    metrics plane."""
    inner: Any
    metrics: Dict[str, torch.Tensor]


class ObservedStore:
    """`Store` adapter adding the metrics plane to any backend
    (`get_backend("obs:<name>")`). `apply` opens a collection frame around
    the inner apply, records the plan-level counters and folds the frame
    into `state.metrics`; `scan` and `stats` proxy through, and `flush`
    proxies a tier stack's with its counters folded in."""

    def __init__(self, inner):
        self.inner = inner
        self.name = f"obs:{inner.name}"
        self.ordered = inner.ordered
        self.kernelized = getattr(inner, "kernelized", False)

    def init(self, capacity: int, device="cuda", **kw) -> ObservedState:
        dev = resolve_device(device)
        return ObservedState(inner=self.inner.init(capacity, device=dev,
                                                   **kw),
                             metrics=metrics_zero(dev))

    def apply(self, state: ObservedState, plan):
        with collect() as frame:
            inner2, res = self.inner.apply(state.inner, plan)
            _record_plan_metrics(plan, res)
        return (ObservedState(inner=inner2,
                              metrics=merge_metrics(state.metrics, frame)),
                res)

    def scan(self, state: ObservedState, lo, hi, max_out: int, **kw):
        with span("scan", backend=self.inner.name):
            return self.inner.scan(state.inner, lo, hi, max_out, **kw)

    def stats(self, state: ObservedState):
        return self.inner.stats(state.inner)

    def metrics(self, state: ObservedState) -> Dict[str, torch.Tensor]:
        """The accumulated metrics plane (every schema key; untouched
        counters are zero)."""
        return dict(state.metrics)

    def flush(self, state: ObservedState) -> ObservedState:
        """The inner tier stack's bulk demotion, inside a collection frame,
        so its demotions and spill appends land in the same counters."""
        with collect() as frame:
            inner2 = self.inner.flush(state.inner)
        return ObservedState(inner=inner2,
                             metrics=merge_metrics(state.metrics, frame))


def _record_plan_metrics(plan, res) -> None:
    """The backend-generic counters, derived from the plan and the shared
    `OpResults` encoding (FIND -> (hit, val); INSERT -> (applied,
    existed); DELETE -> (removed, 0))."""
    from repro_torch.store.api import OP_DELETE, OP_FIND, OP_INSERT
    valid = plan.mask & (plan.ops >= 0)
    find_m = valid & (plan.ops == OP_FIND)
    ins_m = valid & (plan.ops == OP_INSERT)
    del_m = valid & (plan.ops == OP_DELETE)
    record("ops_find", lambda: find_m.sum())
    record("ops_insert", lambda: ins_m.sum())
    record("ops_delete", lambda: del_m.sum())
    record("find_hits", lambda: (find_m & res.ok).sum())
    record("find_misses", lambda: (find_m & ~res.ok).sum())
    existed = res.vals != 0
    record("inserts_new", lambda: (ins_m & res.ok & ~existed).sum())
    record("inserts_existing", lambda: (ins_m & res.ok & existed).sum())
    record("deletes_hit", lambda: (del_m & res.ok).sum())


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


def current_tracer() -> Tracer | None:
    """The Tracer `tracing()` installed in this context, or None."""
    return _TRACER.get()


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
