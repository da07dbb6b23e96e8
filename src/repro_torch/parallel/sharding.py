"""Mesh context and sharding rules (counterpart of
`repro.parallel.sharding`).

Model internals read the mesh a caller opened with `use_mesh`: under it,
the MoE FFN runs its expert-parallel dispatch over the model axis
(`models.blocks._moe_sharded`); with no mesh open it runs the one-shard
dense dispatch. The mesh is a `core.routing.ShardMesh`, every shard folded
onto one device, so the dispatch runs each shard's share batched over the
shards.

The rules are the reference's (2D "fsdp x tp", MaxText-style), by the
parameter name's last part and its shape:
  embed [V, D]          -> P(tp, None)   (vocab-parallel)
  lm_head [D, V]        -> P(None, tp)
  wo / wd / down / out_proj / out [big_in, D] -> P(tp, fsdp)
  wi / wu / wq / wk / wv / wx / wh / up / in_proj / x_proj / wdq / wuq /
    wdkv / wuk / wuv / wkr / router [D, F] -> P(fsdp, tp);
    as experts [E, D, F] -> P(tp, None, fsdp)
  other 3-D             -> P(tp, None, None)
  other 2-D             -> P(fsdp, None);  scalars / norms -> P()
A dim its axes do not divide is replicated. Here they say where each
tensor's shards would live on the open mesh, which the dry run
(`launch.dryrun`) reckons its per-device bytes and collectives from;
the folded mesh keeps every tensor whole on the device.
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager

from torch import nn

from repro_torch.core.routing import ShardMesh

_ctx = threading.local()


@contextmanager
def use_mesh(mesh: ShardMesh, dp_axes=("data",), tp_axis="model"):
    for a in (*dp_axes, tp_axis):
        if a not in mesh.axis_names:
            raise ValueError(f"axis {a!r} is not an axis of {mesh}")
    prev = getattr(_ctx, "cfg", None)
    _ctx.cfg = {"mesh": mesh, "dp_axes": tuple(dp_axes), "tp_axis": tp_axis}
    try:
        yield
    finally:
        _ctx.cfg = prev


def current_mesh() -> ShardMesh | None:
    cfg = getattr(_ctx, "cfg", None)
    return cfg["mesh"] if cfg else None


def mesh_cfg() -> dict | None:
    return getattr(_ctx, "cfg", None)


class P(tuple):
    """A PartitionSpec: one entry a dim, each an axis name, a tuple of
    names, or None (replicated); trailing dims it leaves out are
    replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def axes(self) -> tuple:
        """Every axis name the spec uses, in order."""
        out = []
        for part in self:
            if part is not None:
                out.extend(part if isinstance(part, tuple) else (part,))
        return tuple(out)


def _size(axes, mesh) -> int:
    return math.prod(mesh.shape[a] for a in
                     (axes if isinstance(axes, tuple) else (axes,)))


def _divides(dim: int, axes, mesh) -> bool:
    return dim % _size(axes, mesh) == 0


def _maybe(axis, dim, mesh):
    """axis if it divides dim, else None (replicate)."""
    if axis is None:
        return None
    return axis if _divides(dim, axis, mesh) else None


_ROW_PARALLEL = ("wo", "wd", "down", "out_proj", "out")
_COL_PARALLEL = ("wi", "wu", "wq", "wk", "wv", "wx", "wh", "up", "in_proj",
                 "x_proj", "wdq", "wuq", "wdkv", "wuk", "wuv", "wkr",
                 "router")


def param_spec(path: str, shape: tuple, mesh, dp_axes=("data",),
               tp_axis="model") -> P:
    """The reference's rule for one parameter, by the last part of its
    name (split on "/" or ".") and its shape. `mesh` needs only `.shape`,
    the axis -> size dict."""
    fsdp = tuple(dp_axes)          # ZeRO-3: the non-TP dim over data
    name = path.replace("/", ".").split(".")[-1]
    nd = len(shape)
    if nd <= 1:
        return P()
    if name == "embed":
        return P(_maybe(tp_axis, shape[0], mesh), None)
    if name == "lm_head":
        return P(None, _maybe(tp_axis, shape[-1], mesh))
    if name in _ROW_PARALLEL:
        return P(_maybe(tp_axis, shape[0], mesh),
                 fsdp if _divides(shape[1], fsdp, mesh) else None)
    if name in _COL_PARALLEL:
        if nd == 3:                # experts [E, D, F]: EP over the model
            return P(_maybe(tp_axis, shape[0], mesh), None,
                     fsdp if _divides(shape[2], fsdp, mesh) else None)
        return P(fsdp if _divides(shape[0], fsdp, mesh) else None,
                 _maybe(tp_axis, shape[1], mesh))
    if nd == 3:
        return P(_maybe(tp_axis, shape[0], mesh), None, None)
    return P(fsdp if _divides(shape[0], fsdp, mesh) else None, None)


def params_shardings(params, mesh, dp_axes=("data",),
                     tp_axis="model") -> dict:
    """{parameter name: spec} for an `nn.Module` (or a name -> tensor
    mapping). The port's layers are a `ModuleList` with no stacked layer
    dim, so no spec has the reference's leading None; port layer g·P + i
    gets the spec of row g of the reference's `blocks[i]`."""
    items = (params.named_parameters() if isinstance(params, nn.Module)
             else params.items())
    return {n: param_spec(n, tuple(t.shape), mesh, dp_axes, tp_axis)
            for n, t in items}


def constrain(x, spec: P):
    """The reference's sharding-constraint hint. On the folded mesh the
    device holds the whole tensor, so `x` comes back as it is; a spec
    longer than x's rank, or one naming an axis the open mesh lacks,
    raises. No mesh open: a no-op."""
    mesh = current_mesh()
    if mesh is None:
        return x
    if len(spec) > x.ndim:
        raise ValueError(f"spec {spec} has {len(spec)} entries for a "
                         f"rank-{x.ndim} tensor")
    for part in spec:
        if part is None:
            continue
        for a in (part if isinstance(part, tuple) else (part,)):
            if a not in mesh.axis_names:
                raise ValueError(f"spec {spec} names axis {a!r}, not an "
                                 f"axis of {mesh}")
    return x
