"""Gradient compression over the pod axis (counterpart of
`repro.optim.compress`).

int8 quantization with error feedback: each pod adds its kept
quantization residual to its gradient, sends the int8 payload and one
f32 scale a leaf, and keeps the new residual; the mean over pods is the
scales against the dequantised payloads. The reference runs it inside a
`shard_map` over the pod axis, where the exchange is an `all_gather` of
the payloads. Here the pods of a `core.routing.ShardMesh` are folded
onto one device: a pod's payload is made from its own gradients
(`quantize_pod`), and the all_gather is the stacking of the P payloads
`[P, ...]` and scales `[P]` (`exchange`). So only the int8 payloads and
the scales of the P pods are held at once, never P f32 gradient trees.

Gradients and residuals are dicts keyed by parameter name (the port's
trees). The reference quantizes a leaf of its tree with one scale, and
its layers' leaves are stacked over the groups of the block period: row
g of `blocks[i]`'s leaf is the port's layer g·P + i. So one scale covers
every port parameter of one reference leaf (`stacked_leaves`), as the
train step passes them. Residuals are f32 `[P, *shape]`: row p is pod
p's own error, which the reference keeps on pod p's devices (its
`out_specs=P()` with `check_vma=False` returns one array whose shard on
each device is that device's pod's error; reading it whole gives pod
0's, row 0 here).

The arithmetic is the reference's: scale = max(max|g|, 1e-30) / 127,
q = clip(round_half_even(g / scale), -127, 127) as int8, err = g32 -
q * scale, mean = (scales . q) / P cast to the gradient's dtype.
"""
from __future__ import annotations

import re
from typing import Iterable, Mapping, Sequence

import torch

from repro_torch.optim.adamw import named


def compress_state_init(params, n_pods: int = 1) -> dict:
    """Zero f32 residuals, name -> [n_pods, *shape], on the parameters'
    devices."""
    return {n: torch.zeros((n_pods,) + tuple(p.shape), dtype=torch.float32,
                           device=p.device)
            for n, p in named(params).items()}


def stacked_leaves(names, period: int) -> dict:
    """name -> the reference's leaf it is part of: "blocks.{g·P + i}.rest"
    is row g of the reference's `blocks[i]` leaf "rest"; other names are
    leaves of their own."""
    out = {}
    for n in names:
        m = re.fullmatch(r"blocks\.(\d+)\.(.+)", n)
        out[n] = f"blocks.{int(m.group(1)) % period}.{m.group(2)}" if m else n
    return out


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax, min=1e-30) / 127.0


def _q(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def _quant(g: torch.Tensor):
    """(int8 payload, f32 () scale) of an f32 tensor."""
    scale = _scale(torch.max(torch.abs(g)))
    return _q(g, scale), scale


def quantize_pod(grads: Mapping[str, torch.Tensor], residuals: dict,
                 pod: int, leaves: Mapping[str, str] | None = None) -> dict:
    """Pod `pod`'s payloads, name -> (q int8, scale f32 ()), of its
    gradients plus its residuals; `residuals[name][pod]` becomes the new
    error, in place. The names `leaves` maps to one leaf share its scale
    (default: a scale a name). g + r is formed twice, for the leaf's max
    and for its payload, so only one f32 copy of a tensor lives at once."""
    members: dict = {}
    for n in grads:
        members.setdefault(leaves[n] if leaves else n, []).append(n)
    out = {}
    for names in members.values():
        amax = torch.stack([torch.max(torch.abs(grads[n].float()
                                                + residuals[n][pod]))
                            for n in names]).max()
        scale = _scale(amax)
        for n in names:
            r = residuals[n][pod]
            g32 = grads[n].float() + r
            q = _q(g32, scale)
            r.copy_(g32 - q.float() * scale)
            out[n] = (q, scale)
    return out


def exchange(payloads: Sequence[Mapping[str, tuple]],
             dtypes: Mapping[str, torch.dtype]) -> dict:
    """The all_gather and the local dequant-sum over the P pods' payloads:
    name -> (sum_p scale_p * q_p) / P in `dtypes[name]`."""
    n = len(payloads)
    out = {}
    for name in payloads[0]:
        qg = torch.stack([pl[name][0] for pl in payloads])     # [P, ...]
        sg = torch.stack([pl[name][1] for pl in payloads])     # [P]
        summed = torch.tensordot(sg, qg.float(), dims=([0], [0]))
        out[name] = (summed / n).to(dtypes[name])
    return out


def pod_allreduce_compressed(grads: Iterable[Mapping[str, torch.Tensor]],
                             residuals: dict, mesh, axis: str = "pod",
                             leaves: Mapping[str, str] | None = None):
    """Per leaf: g' = mean over pods of dequant(quant(g_p + r_p)), and r_p
    the pod's new error. `grads` yields the P pods' gradient trees in pod
    order; each is quantized as it comes, so a generator that makes a
    pod's gradients only when asked holds one f32 tree at a time.
    `leaves` as `quantize_pod` takes it. Returns (g', residuals), the
    residuals updated in place."""
    n_pods = mesh.shape[axis]
    payloads, dtypes = [], {}
    # no enumerate: its cached (pod, tree) pair would keep the tree alive
    for tree in grads:
        if len(payloads) == n_pods:
            raise ValueError(f"more than {n_pods} gradient trees for "
                             f"{n_pods} pods")
        payloads.append(quantize_pod(tree, residuals, len(payloads), leaves))
        dtypes = {k: v.dtype for k, v in tree.items()}
        del tree                    # before the next pod's tree is made
    if len(payloads) != n_pods:
        raise ValueError(f"{len(payloads)} gradient trees for {n_pods} pods")
    return exchange(payloads, dtypes), residuals


def pod_allreduce_plain(grads: Sequence[Mapping[str, torch.Tensor]], mesh,
                        axis: str = "pod") -> dict:
    """Per leaf: the mean over the P pods' trees (the reference's
    `pmean`)."""
    n_pods = mesh.shape[axis]
    if len(grads) != n_pods:
        raise ValueError(f"{len(grads)} gradient trees for {n_pods} pods")
    return {k: torch.stack([t[k] for t in grads]).sum(0) / n_pods
            for k in grads[0]}
