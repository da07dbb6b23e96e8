"""Plain PyTorch version of the hash_probe kernel: gather each query's
bucket row (slot clipped to [0, M - 1]) and take the first matching
column; a miss has column 0."""
from __future__ import annotations

import torch

from repro_torch.core.layout import first_true


def hash_probe_ref(q: torch.Tensor, slots: torch.Tensor, keys: torch.Tensor):
    """q: [T] int64; slots: [T] int32; keys: [M, B] int64. Returns
    (found int8[T], col int32[T])."""
    s = torch.clamp(slots, 0, keys.shape[0] - 1).long()
    hit = keys[s] == q[:, None]
    return hit.any(dim=1).to(torch.int8), first_true(hit)
