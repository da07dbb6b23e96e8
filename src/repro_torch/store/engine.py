"""Mesh-sharded storage engine over any registered `Store` backend
(counterpart of `repro.store.engine`).

The paper's flagship experiment (§VI: 8 skiplists, one per NUMA node,
keys partitioned by their top bits, queues carrying each key to its owner
node) generalised to any backend or tier stack: one backend instance per
shard of a `routing.ShardMesh`, the hierarchical route (coarsest axis
first), each shard's `apply` run on its own pool, and the results routed
back to the requesting shard and lane.

The mesh is folded onto one device: a sharded state is a tuple of S
per-shard backend states, each the backend's own state type (the
backends and their kernels take one state), and the route runs batched
over all shards as `[S, n]` tensors (`core.routing`). The per-shard
`apply`s run in a plain loop, each with its own launches and syncs.
Global op streams are `[S * lanes]` tensors, shard-major, as the
reference's sharded arrays are.

The single-shard engine is the one-shard mesh (`local_store_engine`,
pool_factor 1): its route keeps every valid lane in lane order, so pop
lanes see the exact global pop-min.
"""
from __future__ import annotations

import functools
import math
from contextlib import nullcontext
from typing import Sequence

import torch

from repro_torch.core.layout import resolve_device
from repro_torch.core.routing import ShardMesh, route_back, route_to_owners
from repro_torch.store import exec as exec_
from repro_torch.store import obs
from repro_torch.store.api import OpPlan, Store, get_backend

LOCAL_MESH = ShardMesh(("local",), (1,))


def resolve(backend) -> Store:
    """Accept a backend instance or a registry name."""
    return get_backend(backend) if isinstance(backend, str) else backend


def sharded_init(backend, n_shards: int, capacity_per_shard: int, *,
                 device="cuda", **kw) -> tuple:
    """A tuple of `n_shards` fresh backend states on `device`."""
    be = resolve(backend)
    dev = resolve_device(device)
    return tuple(be.init(capacity_per_shard, device=dev, **kw)
                 for _ in range(n_shards))


def store_sharding(mesh: ShardMesh, axis_names: Sequence[str],
                   device="cuda") -> torch.device:
    """Where a folded mesh's states and op streams live: one device."""
    return resolve_device(device)


def _per_shard(state, fn) -> dict:
    """`fn(shard_state)` dicts of scalars over the shards -> dict of [S]
    numpy int64 arrays, read back in one transfer."""
    per = [fn(st) for st in state]
    keys = list(per[0])
    dev = next(iter(per[0].values()))
    dev = dev.device if torch.is_tensor(dev) else "cpu"
    flat = torch.stack([torch.as_tensor(p[k], device=dev).reshape(())
                        .to(torch.int64) for p in per for k in keys])
    host = flat.cpu().numpy().reshape(len(per), len(keys))
    return {k: host[:, i] for i, k in enumerate(keys)}


def make_store_step(mesh: ShardMesh, axis_names: Sequence[str], lanes: int,
                    backend="det_skiplist", pool_factor: int = 2,
                    exec_mode: str | None = None):
    """The batched-op step for `backend`: (state, ops[S * lanes] int32,
    keys[S * lanes] int64, vals[S * lanes] int64) -> (state', results,
    ok, dropped), S the shards of the routing axes, each contributing
    `lanes` requests ("threads fill queues, then operate", §IX).
    `dropped` is a 0-d int32 tensor. `exec_mode` (None = the current mode
    at call time) applies to the per-shard `apply` only."""
    be = resolve(backend)
    axis_sizes = [mesh.shape[a] for a in axis_names]
    S = int(math.prod(axis_sizes))
    pool = lanes * pool_factor
    # per-shard routing counters land in the engine's own frame, opened
    # only around the route (the backend's apply opens its own)
    observed = isinstance(be, obs.ObservedStore)

    def step(state, ops, keys, vals):
        if ops.shape[0] != S * lanes or len(state) != S:
            raise ValueError(f"step expects {S} shards x {lanes} lanes, got "
                             f"{len(state)} shards and {ops.shape[0]} lanes")
        ops, keys, vals = (x.reshape(S, lanes) for x in (ops, keys, vals))
        with obs.span("route", backend=be.name):
            rr = route_to_owners(keys, vals, ops, ops >= 0, axis_names,
                                 axis_sizes, pool)
        live = rr.valid & (rr.aux >= 0)
        routed = live.sum(-1, dtype=torch.int64) if observed else None
        out, res_v, res_ok = [], [], []
        for s, st in enumerate(state):
            with (obs.collect() if observed else nullcontext()) as frame:
                if observed:
                    obs.record("routed_ops", routed[s])
                    obs.record("routed_bytes",
                               routed[s] * obs.ROUTED_OP_BYTES)
            plan = OpPlan(ops=rr.aux[s], keys=rr.keys[s], vals=rr.vals[s],
                          mask=rr.valid[s])
            with exec_.exec_mode(exec_mode):
                st, res = be.apply(st, plan)
            out.append(obs.absorb_frame(st, frame))
            res_v.append(res.vals)
            res_ok.append(res.ok)
        with obs.span("route_back", backend=be.name):
            rv, rok = route_back(torch.stack(res_v), torch.stack(res_ok),
                                 rr.origin, live, axis_names, axis_sizes,
                                 lanes)
        return tuple(out), rv.reshape(-1), rok.reshape(-1), rr.dropped.sum()

    return step


def make_range_step(mesh: ShardMesh, axis_names: Sequence[str], lanes: int,
                    max_out: int, backend="det_skiplist",
                    pool_factor: int = 2):
    """Range counting over an ORDERED backend: [lo, hi) per lane. Every
    shard scans every gathered range, its counts masked by `valid`, and
    the counts are summed over the shards; each lane reads its own
    range's count. (The reference's all_gather over the axes in turn
    gathers finest-axis-major, so on a mesh of two axes or more its
    shards take back other shards' counts; ROADMAP.md §3.)"""
    be = resolve(backend)
    if not be.ordered:
        raise ValueError(f"backend {be.name!r} is unordered: range steps "
                         f"need an ordered backend or tier stack")
    S = int(math.prod(mesh.shape[a] for a in axis_names))

    def range_step(state, los, his, valid):
        if los.shape[0] != S * lanes or len(state) != S:
            raise ValueError(f"range step expects {S} shards x {lanes} "
                             f"lanes, got {len(state)} and {los.shape[0]}")
        total = torch.zeros(los.shape, dtype=torch.int32, device=los.device)
        for st in state:
            cnt = be.scan(st, los, his, max_out)[0]
            total = total + torch.where(valid, cnt, 0).to(torch.int32)
        return total

    return range_step


def sharded_stats(backend, state) -> dict:
    """Host-side per-shard `Store.stats`: dict of [S] numpy int64 arrays."""
    return _per_shard(state, resolve(backend).stats)


def sharded_metrics(backend, state) -> dict:
    """Host-side per-shard metrics plane: dict of [S] numpy int64 arrays
    over `obs.METRICS_SCHEMA`. Requires an `obs:`-wrapped backend."""
    be = resolve(backend)
    if not isinstance(be, obs.ObservedStore):
        raise ValueError(f"backend {be.name!r} carries no metrics plane; "
                         f"construct the engine with an 'obs:'-prefixed "
                         f"backend string (e.g. 'obs:tiered3/lru')")
    return _per_shard(state, be.metrics)


class StoreEngine:
    """Backend + folded mesh + step, one object.

    >>> mesh = ShardMesh(("data", "model"), (16, 16))
    >>> eng = StoreEngine(mesh, ("data", "model"), 4096, "det_skiplist")
    >>> state = eng.init(1 << 16)                 # 256 shard states
    >>> state, res, ok, dropped = eng.step(state, ops, keys, vals)
    >>> eng.stats(state)["size"]                  # per-shard live sizes

    `device` defaults to "cuda" and raises without a card unless "cpu" is
    passed; `exec_mode` (None = the `store.exec` default, "gpu") applies
    to every shard's `apply`."""

    def __init__(self, mesh: ShardMesh, axis_names: Sequence[str],
                 lanes: int, backend="det_skiplist", pool_factor: int = 2,
                 exec_mode: str | None = None, *, device="cuda"):
        self.mesh = mesh
        self.axis_names = tuple(axis_names)
        self.lanes = lanes
        self.backend = resolve(backend)
        self.exec_mode = exec_mode
        self.pool_factor = pool_factor
        self.n_shards = int(math.prod(mesh.shape[a] for a in self.axis_names))
        self.device = store_sharding(mesh, self.axis_names, device)
        self._step = make_store_step(mesh, self.axis_names, lanes,
                                     backend=self.backend,
                                     pool_factor=pool_factor,
                                     exec_mode=exec_mode)
        # host-side step sequence number: one per `step()` call (the
        # resilience journal keys its entries off it); not a state leaf
        self.seq = 0

    def step(self, state, ops: torch.Tensor, keys: torch.Tensor,
             vals: torch.Tensor):
        """One batched-op step over [S * lanes] lanes, in the "step" trace
        span. Returns (state', vals int64, ok bool, dropped 0-d int32)."""
        seq = self.seq
        self.seq += 1
        with obs.span("step", backend=self.backend.name, lanes=self.lanes,
                      shards=self.n_shards, seq=seq):
            return self._step(state, ops, keys, vals)

    def init(self, capacity_per_shard: int, **kw) -> tuple:
        return sharded_init(self.backend, self.n_shards, capacity_per_shard,
                            device=self.device, **kw)

    def range_step(self, max_out: int, pool_factor: int = 2):
        return make_range_step(self.mesh, self.axis_names, self.lanes,
                               max_out, backend=self.backend,
                               pool_factor=pool_factor)

    def stats(self, state) -> dict:
        """Per-shard `STATS_SCHEMA` arrays plus the engine's `seq`."""
        out = sharded_stats(self.backend, state)
        out["seq"] = self.seq
        return out

    def metrics(self, state) -> dict:
        """Per-shard metrics plane (`sharded_metrics`); raises unless the
        engine runs an `obs:` backend."""
        return sharded_metrics(self.backend, state)


@functools.lru_cache(maxsize=None)
def local_store_engine(backend: str, lanes: int, exec_mode: str | None = None,
                       device: str = "cuda") -> StoreEngine:
    """A cached one-shard StoreEngine per (backend, lanes, mode, device):
    the serving layer's route into the Store API. pool_factor 1: the
    pooled plan is exactly the lane set."""
    return StoreEngine(LOCAL_MESH, LOCAL_MESH.axis_names, lanes, backend,
                       pool_factor=1, exec_mode=exec_mode, device=device)
