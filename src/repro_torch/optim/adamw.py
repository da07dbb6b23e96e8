"""AdamW with global-norm clipping (counterpart of `repro.optim.adamw`).

Parameters are an `nn.Module` (or a name -> tensor mapping); gradients
and the moments `m` / `v` are dicts keyed by the parameters' names, the
moments in f32 whatever the parameters' dtype. `adamw_update` updates
the parameters and the moments in place, one parameter at a time, in
the reference's arithmetic order (so its temporaries are one
parameter's size). `torch.optim.AdamW` places eps and the decay
differently and rounds otherwise.
"""
from __future__ import annotations

import torch
from torch import nn


def named(params) -> dict:
    """name -> tensor of an `nn.Module` (its parameters) or a mapping."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def adamw_init(params) -> dict:
    ps = named(params)
    dev = next(iter(ps.values())).device
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": {n: zeros(p) for n, p in ps.items()},
            "v": {n: zeros(p) for n, p in ps.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


@torch.no_grad()
def adamw_update(grads: dict, state: dict, params, lr, *, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, clip_norm=1.0):
    """One AdamW step. Returns (params, state', grad norm): `params` and
    the moments updated in place, `state'["step"]` a new int32 tensor."""
    gn = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gn, min=1e-6), max=1.0)
    step = state["step"] + 1
    c1 = 1.0 - torch.pow(b1, step.float())
    c2 = 1.0 - torch.pow(b2, step.float())
    for name, p in named(params).items():
        g = grads[name].float() * scale
        m, v = state["m"][name], state["v"][name]
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        mh = m / c1
        vh = v / c2
        delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    return params, {"m": state["m"], "v": state["v"], "step": step}, gn
