"""Wrapper of the CUDA fused tier find (`csrc/tier_find.cu`).

Replaces `repro/kernels/tier_find/kernel.py:tier_find_tiles`, both warm
layouts. On CUDA tensors it launches the kernel (one thread per query:
bucket probe, warm walk, spill binary searches); on CPU tensors it runs
`ref.tier_find_planes_ref`."""
from __future__ import annotations

import torch

from repro_torch.core.layout import (BSkiplistLayout, SkiplistLayout,
                                     SpillLayout)
from repro_torch.kernels import cuda
from repro_torch.kernels.tier_find.ref import tier_find_planes_ref


def tier_find_tiles(q: torch.Tensor, slots: torch.Tensor,
                    hot_keys: torch.Tensor,
                    warm: SkiplistLayout | BSkiplistLayout,
                    spill: SpillLayout | None = None):
    """q: [T] int64; slots: [T] int32; hot_keys: [M, B] int64; warm: the
    level-major or the block-major view. Returns (hot int8, col int32,
    warm int8, idx int32) plus (spill int8, cell int32) when `spill` is
    given."""
    if not q.is_cuda:
        return tier_find_planes_ref(q, slots, hot_keys, warm, spill)
    sp = spill if spill is not None else SpillLayout(None, None, None)
    cuda.check_cuda("tier_find", q, slots, hot_keys, *sp)
    wargs, layout = cuda.warm_args("tier_find", warm)
    runs = 0 if spill is None else spill.run_off.shape[0] - 1
    if runs > 64:
        raise ValueError("tier_find: at most 64 spill runs")
    t = q.shape[0]
    dev = q.device
    outs = [torch.empty(t, dtype=d, device=dev)
            for d in (torch.int8, torch.int32) * (3 if spill is not None else 2)]
    sp_out = outs[4:] if spill is not None else [None, None]
    cuda.launch("tier_find", "tier_find_launch", cuda.ptr(q), cuda.ptr(slots),
                t, cuda.ptr(hot_keys), hot_keys.shape[0], hot_keys.shape[1],
                *wargs, cuda.ptr(sp.keys), cuda.ptr(sp.dead),
                cuda.ptr(sp.run_off), runs,
                0 if spill is None else spill.keys.shape[0],
                *[cuda.ptr(o) for o in outs[:4]],
                *[cuda.ptr(o) for o in sp_out], layout=layout)
    return tuple(outs)
