"""Execution-mode dispatch (counterpart of `repro.store.exec`).

Every backend's probe phase and the tier stacks' write prologue call
through here, so the implementation is swappable without touching
backend logic. Two modes, bit-identical for all integer work:

  torch  the plain PyTorch versions (the references the JAX `jnp` mode
         runs: `core.det_skiplist.find_batch` / `find_batch_blocked` /
         `pop_rank_select`, `core.hashtable.fixed_find_cols`,
         `kernels.tier_find.ref.tier_find_ref`,
         `kernels.tier_apply.ref.tier_apply_ref`) — CPU or CUDA tensors
  gpu    the hand-written CUDA kernels (`kernels/*`), the default; CPU
         tensors raise

`spill_find` and `hot_update` run their plain versions in both modes, as
in the reference (they serve only the unfused chain; the fused
`tier_find` / `tier_apply` are the kernelized forms).

Every entry counts as ONE dispatch of kind "probe" or "update"; in an
eager framework the count is per call, i.e. per launch of the step.
`measure_dispatches()` yields a context-local, nestable `DispatchMeter`.
"""
from __future__ import annotations

import functools
from contextlib import contextmanager
from contextvars import ContextVar

import torch

from repro_torch.core.layout import warm_layout_of
from repro_torch.store import obs

MODES = ("torch", "gpu")


def _check(mode: str) -> str:
    if mode not in MODES:
        raise ValueError(f"unknown store exec mode {mode!r}; one of {MODES}")
    return mode


_MODE: ContextVar[str] = ContextVar("repro_torch_exec_mode", default="gpu")


def set_mode(mode: str) -> None:
    _MODE.set(_check(mode))


@contextmanager
def exec_mode(mode: str | None):
    """Scoped mode override (None keeps the current mode)."""
    token = _MODE.set(_check(mode)) if mode is not None else None
    try:
        yield
    finally:
        if token is not None:
            _MODE.reset(token)


def _resolve(mode: str | None) -> str:
    return _check(mode) if mode is not None else _MODE.get()


def _gpu_tensors(name: str, *tensors) -> None:
    """gpu mode runs CUDA kernels: refuse CPU tensors."""
    for t in tensors:
        if torch.is_tensor(t) and not t.is_cuda:
            raise RuntimeError(f"exec mode 'gpu' ({name}) needs CUDA tensors; "
                               f"use exec mode 'torch' on the CPU")


# ---------------------------------------------------------------------------
# dispatch accounting (context-local, nestable)
# ---------------------------------------------------------------------------

_METERS: ContextVar[tuple] = ContextVar("repro_torch_exec_meters", default=())


class DispatchMeter:
    """Dispatch counter of one `measure_dispatches` block (`n`, with the
    `probe` / `update` split)."""

    __slots__ = ("_n", "_probe", "_update")

    def __init__(self):
        self._n = 0
        self._probe = 0
        self._update = 0

    @property
    def n(self) -> int:
        return self._n

    @property
    def probe(self) -> int:
        return self._probe

    @property
    def update(self) -> int:
        return self._update


def _bump(kind: str) -> None:
    for meter in _METERS.get():
        meter._n += 1
        if kind == "probe":
            meter._probe += 1
        else:
            meter._update += 1


@contextmanager
def measure_dispatches():
    """Count the dispatches issued inside the block."""
    meter = DispatchMeter()
    token = _METERS.set(_METERS.get() + (meter,))
    try:
        yield meter
    finally:
        _METERS.reset(token)


def _entry(kind: str):
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kw):
            _bump(kind)
            with obs.span("find" if kind == "probe" else "update",
                          cat="dispatch", probe=fn.__name__):
                return fn(*args, **kw)
        return wrapped
    return deco


# ---------------------------------------------------------------------------
# probes
# ---------------------------------------------------------------------------

@_entry("probe")
def skiplist_find(s, queries, mode: str | None = None):
    """Deterministic-skiplist FIND: (found[Q], vals[Q], term_idx[Q])."""
    if _resolve(mode) == "torch":
        from repro_torch.core import det_skiplist as dsl
        return dsl.find_batch(s, queries)
    _gpu_tensors("skiplist_find", queries)
    from repro_torch.kernels.skiplist_search.ops import skiplist_find as fn
    return fn(s, queries)


@_entry("probe")
def bskiplist_find(s, queries, mode: str | None = None):
    """Deterministic-skiplist FIND through the block-major B-skiplist view
    (`core.layout.bskiplist_layout`): the contract and the found/vals of
    `skiplist_find`, in one 128-key node compare per row; the warm probe
    of the unfused `tiered3/b128`."""
    if _resolve(mode) == "torch":
        from repro_torch.core import det_skiplist as dsl
        return dsl.find_batch_blocked(s, queries)
    _gpu_tensors("bskiplist_find", queries)
    from repro_torch.kernels.bskiplist_walk.ops import bskiplist_find as fn
    return fn(s, queries)


@_entry("probe")
def pq_pop(s, ranks, mask, mode: str | None = None):
    """Priority-queue rank-select on a DetSkiplist: the rank-th smallest
    live key per lane. Returns (found[K], keys[K], idx[K] int32), a pure
    read committed by the pq backend with `pop_mark`. Both modes mask a
    lane that is not found the same way (keys KEY_INF, idx 0)."""
    if _resolve(mode) == "torch":
        from repro_torch.core import det_skiplist as dsl
        return dsl.pop_rank_select(s, ranks, mask)
    _gpu_tensors("pq_pop", ranks)
    from repro_torch.kernels.pq_pop.ops import pq_pop_ranks
    return pq_pop_ranks(s, ranks, mask)


def _hash_probe(h, queries, mode):
    if _resolve(mode) == "torch":
        from repro_torch.core import hashtable as ht
        return ht.fixed_find_cols(h, queries)
    _gpu_tensors("hash_find", queries)
    from repro_torch.kernels.hash_probe.ops import fixed_hash_find_cols
    return fixed_hash_find_cols(h, queries)


@_entry("probe")
def hash_find(h, queries, mode: str | None = None):
    """Fixed-slot hash probe: (found[Q], vals[Q])."""
    return _hash_probe(h, queries, mode)[:2]


@_entry("probe")
def hash_find_cols(h, queries, mode: str | None = None):
    """Fixed-slot hash probe with the hit column: (found, vals, col)."""
    return _hash_probe(h, queries, mode)


@_entry("probe")
def spill_find(sp, queries, mode: str | None = None):
    """Cold spill-tier membership: (found[Q], vals[Q]); the per-run binary
    search in every mode (the fused `tier_find` is the kernelized form)."""
    _resolve(mode)
    from repro_torch.kernels.tier_find.ref import spill_find_runs
    return spill_find_runs(sp.keys, sp.vals, sp.dead, sp.run_start, sp.n,
                           queries)


@_entry("probe")
def tier_find(hot, cold, spill, queries, mode: str | None = None,
              warm_layout: str = "level"):
    """FUSED tier-stack FIND as ONE dispatch, with the miss fall-through
    (a warm hit counts only on a hot miss, a spill hit only on a hot+warm
    miss). The warm walk is level-major or, with `warm_layout="block"`,
    the block-major B-skiplist walk (the same results). Returns ((hot
    found, vals, col), (warm found, vals), (spill found, vals))."""
    if _resolve(mode) == "torch":
        from repro_torch.kernels.tier_find.ref import tier_find_ref
        hot_r, warm_r, sp_r = tier_find_ref(hot, cold, spill, queries,
                                            warm_layout)
    else:
        _gpu_tensors("tier_find", queries)
        from repro_torch.kernels.tier_find.ops import tier_find_fused
        hot_r, warm_r, sp_r = tier_find_fused(
            hot, cold, spill, queries, warm_layout_of(cold, warm_layout))
    f_hot, v_hot, c_hot = hot_r
    f_warm, v_warm = warm_r
    f_sp, v_sp = sp_r
    f_warm = f_warm & ~f_hot
    f_sp = f_sp & ~f_hot & ~f_warm
    return ((f_hot, v_hot, c_hot),
            (f_warm, torch.where(f_warm, v_warm, 0)),
            (f_sp, torch.where(f_sp, v_sp, 0)))


# ---------------------------------------------------------------------------
# updates (the write half of an apply)
# ---------------------------------------------------------------------------

@_entry("update")
def hot_update(hot, meta, clock, keys, vals, mask, policy, max_evict,
               mode: str | None = None):
    """Hot-tier insert prologue of the UNFUSED write path, plain in every
    mode. Returns (hot', meta', ins, exists, ev_key, ev_val, ev_mask)."""
    _resolve(mode)
    from repro_torch.kernels.tier_apply.ref import hot_insert_evict
    if policy == "none":
        from repro_torch.core import hashtable as ht
        hot2, ins, exists = ht.fixed_insert(hot, keys, vals, mask)
        k = keys.shape[0]
        z64 = torch.zeros(k, dtype=torch.int64, device=keys.device)
        return (hot2, meta, ins, exists, z64, z64.clone(),
                torch.zeros(k, dtype=torch.bool, device=keys.device))
    return hot_insert_evict(hot, meta, clock, keys, vals, mask, policy,
                            max_evict)


@_entry("update")
def tier_apply(hot, meta, clock, cold, spill, keys, vals, mask, policy,
               max_evict, mode: str | None = None,
               warm_layout: str = "level"):
    """FUSED tier-stack APPLY prologue as ONE dispatch: membership probes
    (the warm walk in `warm_layout`), the hot insert plan and victim
    selection. Returns (hot', meta', in_warm, in_spill, ins, exists,
    ev_key, ev_val, ev_mask)."""
    if _resolve(mode) == "torch":
        from repro_torch.kernels.tier_apply.ref import tier_apply_ref
        return tier_apply_ref(hot, meta, clock, cold, spill, keys, vals,
                              mask, policy, max_evict, warm_layout)
    _gpu_tensors("tier_apply", keys)
    from repro_torch.kernels.tier_apply.ops import tier_apply_fused
    return tier_apply_fused(hot, meta, clock, cold, spill, keys, vals, mask,
                            policy, max_evict,
                            warm_layout_of(cold, warm_layout))
