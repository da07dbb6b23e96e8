"""Carry store states across packages as numpy arrays.

`state_from_numpy(backend_name, tree)` builds the port's state from a
reference state whose leaves are numpy arrays (or anything `np.asarray`
takes): `DetSkiplist`, `FixedHash`, `TierState` (with its `SpillTier` or
None), `PQState`. Fields are matched by name, u64 leaves become int64 views of the
same bits, every other dtype is kept leaf for leaf. `state_to_numpy` is
the inverse: the same structure with numpy leaves, u64 fields restored to
uint64, so `tree_leaves` of both sides compare leaf for leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.det_skiplist import DetSkiplist, LevelPlanes
from repro_torch.core.hashtable import FixedHash
from repro_torch.core.layout import resolve_device
from repro_torch.store.pq import PQState
from repro_torch.store.tiers import SpillTier, TierState

# fields that hold u64 keys or values, per state type
_U64_FIELDS = {
    DetSkiplist: {"term_keys", "term_vals", "level_keys"},
    FixedHash: {"keys", "vals"},
    SpillTier: {"keys", "vals"},
    TierState: set(),
    PQState: set(),
}
_NESTED = {TierState: {"hot": FixedHash, "cold": DetSkiplist,
                       "spill": SpillTier},
           PQState: {"heap": DetSkiplist}}
_TIERED = ("hash+skiplist", "tiered3", "tiered3/lru", "tiered3/size",
           "tiered3/b128")


def _state_type(backend_name: str):
    if backend_name == "det_skiplist":
        return DetSkiplist
    if backend_name == "fixed_hash":
        return FixedHash
    if backend_name in _TIERED:
        return TierState
    if backend_name == "pq":
        return PQState
    raise KeyError(f"no state conversion for backend {backend_name!r}")


def _leaf_in(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _leaf_out(t: torch.Tensor, u64: bool) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.view(np.uint64) if u64 else a


def _build(cls, tree, device):
    fields = {}
    for f in cls._fields:
        v = getattr(tree, f)
        sub = _NESTED.get(cls, {}).get(f)
        if sub is not None:
            fields[f] = None if v is None else _build(sub, v, device)
        elif isinstance(v, (tuple, list)):     # DetSkiplist index levels
            fields[f] = LevelPlanes.stack(_leaf_in(x, device) for x in v)
        else:
            fields[f] = _leaf_in(v, device)
    return cls(**fields)


def _unbuild(state):
    cls = type(state)
    u64 = _U64_FIELDS[cls]
    fields = {}
    for f in cls._fields:
        v = getattr(state, f)
        if f in _NESTED.get(cls, {}):
            fields[f] = None if v is None else _unbuild(v)
        elif isinstance(v, tuple):
            fields[f] = tuple(_leaf_out(x, f in u64) for x in v)
        else:
            fields[f] = _leaf_out(v, f in u64)
    return cls(**fields)


def state_from_numpy(backend_name: str, tree, device="cuda"):
    """Reference state (numpy leaves) -> the port's state on `device`
    (CUDA unless the caller passes device="cpu"; raises without a card)."""
    return _build(_state_type(backend_name), tree, resolve_device(device))


def state_to_numpy(state):
    """The port's state -> the same structure with numpy leaves (u64
    fields as uint64)."""
    return _unbuild(state)


def tree_leaves(tree) -> list:
    """Leaves of a nested NamedTuple/tuple structure in field order, None
    subtrees skipped (the order `jax.tree.leaves` gives the reference's
    states)."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        out = []
        for x in tree:
            out.extend(tree_leaves(x))
        return out
    return [tree]
