"""Mesh context (counterpart of the mesh context of
`repro.parallel.sharding`).

Model internals read the mesh a caller opened with `use_mesh`: under it,
the MoE FFN runs its expert-parallel dispatch over the model axis
(`models.blocks._moe_sharded`); with no mesh open it runs the one-shard
dense dispatch. The mesh is a `core.routing.ShardMesh`, every shard folded
onto one device, so the dispatch runs each shard's share batched over the
shards.

The reference's sharding rules (`param_spec`, `params_shardings`,
`constrain`) place GSPMD shardings and wait for a later slice.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

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
