"""Carry store states across packages as numpy arrays.

`state_from_numpy(backend_name, tree)` builds the port's state from a
reference state whose leaves are numpy arrays (or anything `np.asarray`
takes): `DetSkiplist`, `RandSkiplist`, `FixedHash`, `TwoLevelHash` (with
its `BlockPool` and `FreeRing`), `SplitOrderHash`, `TwoLevelSplitOrder`,
`TierState` (with its `SpillTier` or None), `PQState`. Fields are matched
by name; u64 leaves become int64 views of the same bits and uint32 leaves
(the pool's generations) int32 views; every other dtype is kept leaf for
leaf; `max_load` is a static int and stays an int. `state_to_numpy` is
the inverse: the same structure with numpy leaves, u64 and u32 fields
restored to their unsigned types, so `tree_leaves` of both sides compare
leaf for leaf. An `obs:` backend's `ObservedState` carries its metrics
plane across as int64 leaves. `sharded_state_from_numpy` /
`sharded_state_to_numpy` carry a sharded engine's state, a tuple of
per-shard states, to and from the reference's layout, every leaf with a
leading shard dim; `tree_map` maps a port state's tensors and static
ints, keeping `LevelPlanes` views of one buffer.

The serving slice adds `params_from_jax` (the reference's parameter
pytree as numpy leaves, block leaves stacked `[n_groups, ...]`, into the
port's `models.model.LM`; dense, moe and hymba blocks), `caches_from_jax` /
`caches_to_numpy` (the contiguous caches of `prefill` / `decode_step`)
and `paged_kv_from_jax` / `paged_kv_to_numpy` (a `serving.kvcache.PagedKV`
with its `BlockPool`). bfloat16 leaves
(numpy's `ml_dtypes` type) travel as their 16-bit patterns.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.blockpool import BlockPool, FreeRing
from repro_torch.core.det_skiplist import DetSkiplist, LevelPlanes
from repro_torch.core.hashtable import FixedHash, TwoLevelHash
from repro_torch.core.layout import resolve_device
from repro_torch.core.rand_skiplist import RandSkiplist
from repro_torch.core.splitorder import SplitOrderHash, TwoLevelSplitOrder
from repro_torch.store.obs import METRICS_SCHEMA, ObservedState
from repro_torch.store.pq import PQState
from repro_torch.store.tiers import SpillTier, TierState

# fields that hold u64 keys or values, per state type
_U64_FIELDS = {
    DetSkiplist: {"term_keys", "term_vals", "level_keys"},
    RandSkiplist: {"term_keys", "term_vals", "level_keys"},
    FixedHash: {"keys", "vals"},
    TwoLevelHash: {"l1_keys", "l1_vals", "l2_keys", "l2_vals"},
    BlockPool: set(),
    FreeRing: set(),
    SplitOrderHash: {"rk", "keys", "vals"},
    TwoLevelSplitOrder: {"rk", "keys", "vals"},
    SpillTier: {"keys", "vals"},
    TierState: set(),
    PQState: set(),
}
_U32_FIELDS = {BlockPool: {"gen"}}
_STATIC_INT = {"max_load"}
_NESTED = {TierState: {"hot": FixedHash, "cold": DetSkiplist,
                       "spill": SpillTier},
           PQState: {"heap": DetSkiplist},
           TwoLevelHash: {"pool": BlockPool},
           BlockPool: {"free": FreeRing}}
_TIERED = ("hash+skiplist", "tiered3", "tiered3/lru", "tiered3/size",
           "tiered3/b128")
_FLAT = {"det_skiplist": DetSkiplist, "rand_skiplist": RandSkiplist,
         "fixed_hash": FixedHash, "twolevel_hash": TwoLevelHash,
         "splitorder": SplitOrderHash,
         "twolevel_splitorder": TwoLevelSplitOrder, "pq": PQState}


def _state_type(backend_name: str):
    if backend_name in _FLAT:
        return _FLAT[backend_name]
    if backend_name in _TIERED:
        return TierState
    raise KeyError(f"no state conversion for backend {backend_name!r}")


def _leaf_in(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    elif a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _leaf_out(t: torch.Tensor, unsigned=None) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a if unsigned is None else a.view(unsigned)


def _build(cls, tree, device):
    fields = {}
    for f in cls._fields:
        v = getattr(tree, f)
        sub = _NESTED.get(cls, {}).get(f)
        if sub is not None:
            fields[f] = None if v is None else _build(sub, v, device)
        elif f in _STATIC_INT:
            fields[f] = int(np.asarray(v))
        elif isinstance(v, (tuple, list)):     # skiplist index levels
            fields[f] = LevelPlanes.stack(_leaf_in(x, device) for x in v)
        else:
            fields[f] = _leaf_in(v, device)
    return cls(**fields)


def _unbuild(state):
    cls = type(state)
    unsigned = {f: np.uint64 for f in _U64_FIELDS[cls]}
    unsigned.update({f: np.uint32 for f in _U32_FIELDS.get(cls, ())})
    fields = {}
    for f in cls._fields:
        v = getattr(state, f)
        if f in _NESTED.get(cls, {}):
            fields[f] = None if v is None else _unbuild(v)
        elif f in _STATIC_INT:
            fields[f] = v
        elif isinstance(v, tuple):
            fields[f] = tuple(_leaf_out(x, unsigned.get(f)) for x in v)
        else:
            fields[f] = _leaf_out(v, unsigned.get(f))
    return cls(**fields)


def state_from_numpy(backend_name: str, tree, device="cuda"):
    """Reference state (numpy leaves) -> the port's state on `device`
    (CUDA unless the caller passes device="cpu"; raises without a card)."""
    dev = resolve_device(device)
    if backend_name.startswith("obs:"):
        return ObservedState(
            inner=state_from_numpy(backend_name[len("obs:"):], tree.inner,
                                   dev),
            metrics={k: _leaf_in(tree.metrics[k], dev)
                     for k in METRICS_SCHEMA})
    return _build(_state_type(backend_name), tree, dev)


def state_to_numpy(state):
    """The port's state -> the same structure with numpy leaves (u64
    fields as uint64)."""
    if isinstance(state, ObservedState):
        return ObservedState(inner=_unbuild(state.inner),
                             metrics={k: _leaf_out(v)
                                      for k, v in state.metrics.items()})
    return _unbuild(state)


def _np_stack(trees):
    """Stack the leaves of same-structure numpy trees on a new leading
    dim; static ints become an int64 array, as the reference's
    `sharded_init` promotes them."""
    t = trees[0]
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: _np_stack([x[k] for x in trees]) for k in t}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(_np_stack(list(x)) for x in zip(*trees)))
    if isinstance(t, (tuple, list)):
        return type(t)(_np_stack(list(x)) for x in zip(*trees))
    return np.stack([np.asarray(x, np.int64 if isinstance(x, int) else None)
                     for x in trees])


def sharded_state_from_numpy(backend_name: str, tree, device="cuda") -> tuple:
    """A reference sharded state (every leaf `[S, ...]`, numpy) -> the
    port's tuple of S per-shard states on `device`."""
    n = tree_leaves(tree)[0].shape[0]
    return tuple(state_from_numpy(backend_name,
                                  tree_map(lambda x: np.asarray(x)[s], tree),
                                  device)
                 for s in range(n))


def sharded_state_to_numpy(state: tuple):
    """The port's tuple of per-shard states -> the reference's sharded
    layout: one tree, every leaf stacked on a leading shard dim."""
    return _np_stack([state_to_numpy(st) for st in state])


def tree_map(fn, tree):
    """Map `fn` over the leaves of a state tree (NamedTuples, tuples,
    dicts, None): a port state's tensors and static ints, or a reference
    state's numpy leaves. `LevelPlanes` map their one flat buffer, so the
    levels stay views of it."""
    if tree is None:
        return None
    if isinstance(tree, LevelPlanes):
        offs = tree.offsets
        return LevelPlanes(fn(tree.flat),
                           [b - a for a, b in zip(offs, offs[1:])])
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _tensor(x, device) -> torch.Tensor:
    """A numpy leaf as a tensor; bfloat16 and float8_e4m3fn (ml_dtypes,
    which `torch.from_numpy` refuses) through their bits, u64 and u32 as
    the int64 / int32 views of the same bits."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.int16), copy=True)).view(
            torch.bfloat16).to(device)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(np.array(a.view(np.uint8), copy=True)).view(
            torch.float8_e4m3fn).to(device)
    return _leaf_in(a, device)


def params_from_jax(tree, cfg, device="cuda"):
    """The reference's parameters (`jax.tree.map(np.asarray, params)`) as
    the port's `LM`, one `Block` per layer, on `device`: the dense block's
    leaves (its `attn` group GQA, or MLA where it holds `wdq`), the moe
    block's `ffn` group (router [D, E], wi / wu [E, D, F], wd [E, F, D]
    and the `shared` MLP), hymba's `mamba` group, `attn_ln` and
    `mamba_ln`, and xLSTM's `cell` group (sLSTM where it holds `wx`, else
    mLSTM). Row g of the reference's `blocks[i]` leaves `[n_groups, ...]`
    is the port's layer g·P + i, P the period of block kinds."""
    from torch import nn

    from repro_torch.models.attention import GQA, MLA
    from repro_torch.models.blocks import Block
    from repro_torch.models.mlp import MLP
    from repro_torch.models.model import LM
    from repro_torch.models.moe import MoE
    from repro_torch.models.ssm import MLSTM, SLSTM, Mamba

    def cls_of(name, d):
        if name == "attn":
            return MLA if "wdq" in d else GQA
        if name == "ffn":
            return MoE if "router" in d else MLP
        if name == "cell":
            return SLSTM if "wx" in d else MLSTM
        return {"mamba": Mamba, "shared": MLP}[name]

    dev = resolve_device(device)
    period = len(tree["blocks"])

    def leaf(v, g):
        return _tensor(np.asarray(v)[g], dev)

    def group(name, d, g):
        return cls_of(name, d)(**{k: group(k, v, g) if isinstance(v, dict)
                                  else leaf(v, g) for k, v in d.items()})

    def block(layer):
        stacked = tree["blocks"][layer % period]
        g = layer // period
        return Block(**{name: (group(name, d, g) if isinstance(d, dict)
                               else leaf(d, g))
                        for name, d in stacked.items()})

    blocks = nn.ModuleList(block(i) for i in range(cfg.n_layers))
    p = dict(blocks=blocks, final_norm=_tensor(tree["final_norm"], dev),
             embed=_tensor(tree["embed"], dev))
    if "lm_head" in tree:
        p["lm_head"] = _tensor(tree["lm_head"], dev)
    return LM(**p)


def caches_from_jax(tree, device="cuda") -> tuple:
    """The reference's contiguous caches (`prefill`'s, as numpy leaves:
    a tuple over the period of dicts stacked `[n_groups, ...]`, e.g.
    hymba's ({"k", "v", "conv", "ssm"},), xLSTM's seven mlstm dicts and
    one slstm dict) as the port's, on `device`, dtypes
    kept (bfloat16 and float8_e4m3fn through their bits)."""
    dev = resolve_device(device)
    return tuple({name: _tensor(leaf, dev) for name, leaf in c.items()}
                 for c in tree)


def caches_to_numpy(caches) -> tuple:
    """The port's contiguous caches -> the same structure with numpy
    leaves; bfloat16 and float8_e4m3fn leaves come back as their float32
    values (exact: the reference takes them back with `.astype`)."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype in (torch.bfloat16, torch.float8_e4m3fn)
                else t).numpy()
    return tuple({name: leaf(t) for name, t in c.items()} for c in caches)


_PAGED_KV_INTS = ("block_tables", "lengths", "active", "refcount")


def paged_kv_from_jax(tree, device="cuda"):
    """A reference `PagedKV` with numpy leaves -> the port's, on
    `device`."""
    from repro_torch.serving.kvcache import PagedKV
    dev = resolve_device(device)
    return PagedKV(pool=_build(BlockPool, tree.pool, dev),
                   k=_tensor(tree.k, dev), v=_tensor(tree.v, dev),
                   **{f: _tensor(getattr(tree, f), dev)
                      for f in _PAGED_KV_INTS})


def paged_kv_to_numpy(kv):
    """The port's `PagedKV` -> the same structure with numpy leaves (the
    pool's generations as uint32, bf16 pools as float32 values)."""
    def page(t):
        return t.detach().float().cpu().numpy()
    return type(kv)(pool=_unbuild(kv.pool), k=page(kv.k), v=page(kv.v),
                    **{f: _leaf_out(getattr(kv, f)) for f in _PAGED_KV_INTS})


def tree_leaves(tree) -> list:
    """Leaves of a nested NamedTuple/tuple/dict structure in field order,
    dicts by sorted key, None subtrees skipped (the order `jax.tree.leaves`
    gives the reference's states)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return tree_leaves([tree[k] for k in sorted(tree)])
    if isinstance(tree, (tuple, list)):
        out = []
        for x in tree:
            out.extend(tree_leaves(x))
        return out
    return [tree]
