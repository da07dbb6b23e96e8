"""SwiGLU MLP (counterpart of `repro.models.mlp`)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init
from repro_torch.models.params import Weights


class MLP(Weights):
    """gate `wi`, up `wu`, down `wd`."""
    MATMUL = ("wi", "wu", "wd")


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             dtype="float32") -> MLP:
    return MLP(wi=dense_init(gen, d_model, d_ff, dtype),
               wu=dense_init(gen, d_model, d_ff, dtype),
               wd=dense_init(gen, d_ff, d_model, dtype))


def mlp(p: MLP, x: torch.Tensor, compute_dtype="bfloat16") -> torch.Tensor:
    g = x @ p.w("wi", compute_dtype)
    u = x @ p.w("wu", compute_dtype)
    return (F.silu(g) * u) @ p.w("wd", compute_dtype)
