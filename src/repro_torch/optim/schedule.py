"""LR schedules (counterpart of `repro.optim.schedule`)."""
from __future__ import annotations

import math

import torch


def cosine_with_warmup(step, *, peak_lr: float, warmup_steps: int,
                       total_steps: int, min_ratio: float = 0.1):
    """Linear warmup to `peak_lr`, then a cosine down to `min_ratio` of
    it at `total_steps`; `step` a tensor (any dtype) -> f32 lr."""
    step = torch.as_tensor(step).float()
    warm = peak_lr * step / max(warmup_steps, 1)
    t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps,
                                                1), 0, 1)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5
                     * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup_steps, warm, cos)
