"""Production mesh builders (counterpart of `repro.launch.mesh`): the
reference's TPU meshes as `core.routing.ShardMesh`es, whose shards the
port folds onto one device. The dry run reckons per-device memory and
collectives on them."""
from __future__ import annotations

import math

from repro_torch.core.routing import ShardMesh


def make_production_mesh(*, multi_pod: bool = False) -> ShardMesh:
    """Single pod: 256 chips (16, 16) ("data", "model"). Multi-pod: 2 pods
    = 512 chips (2, 16, 16) ("pod", "data", "model"); the pod axis is the
    slow hop, routed and reduced coarsest first."""
    if multi_pod:
        return ShardMesh(("pod", "data", "model"), (2, 16, 16))
    return ShardMesh(("data", "model"), (16, 16))


def dp_axes_of(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def n_devices(mesh) -> int:
    return int(math.prod(mesh.shape[a] for a in mesh.axis_names))
