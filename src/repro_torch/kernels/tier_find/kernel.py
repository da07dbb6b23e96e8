"""Wrapper of the CUDA fused tier find (`csrc/tier_find.cu`).

Replaces `repro/kernels/tier_find/kernel.py:tier_find_tiles` for the
level-major warm walk. On CUDA tensors it launches the kernel (one thread
per query: bucket probe, level walk, spill binary searches); on CPU
tensors it runs `ref.tier_find_planes_ref`."""
from __future__ import annotations

import torch

from repro_torch.core.layout import SkiplistLayout, SpillLayout
from repro_torch.kernels import cuda
from repro_torch.kernels.tier_find.ref import tier_find_planes_ref


def tier_find_tiles(q: torch.Tensor, slots: torch.Tensor,
                    hot_keys: torch.Tensor, warm: SkiplistLayout,
                    spill: SpillLayout | None = None):
    """q: [T] int64; slots: [T] int32; hot_keys: [M, B] int64. Returns
    (hot int8, col int32, warm int8, idx int32) plus (spill int8,
    cell int32) when `spill` is given."""
    if not q.is_cuda:
        return tier_find_planes_ref(q, slots, hot_keys, warm, spill)
    sp = spill if spill is not None else SpillLayout(None, None, None)
    cuda.check_cuda("tier_find", q, slots, hot_keys, warm.lvl_keys,
                    warm.lvl_child, warm.lvl_off, warm.term_keys,
                    warm.term_mark, *sp)
    if warm.num_levels > 64:
        raise ValueError("tier_find: at most 64 index levels")
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
                cuda.ptr(warm.lvl_keys), cuda.ptr(warm.lvl_child),
                cuda.ptr(warm.lvl_off), warm.num_levels, warm.c1,
                cuda.ptr(warm.term_keys), cuda.ptr(warm.term_mark),
                warm.term_keys.shape[0], cuda.ptr(sp.keys), cuda.ptr(sp.dead),
                cuda.ptr(sp.run_off), runs,
                0 if spill is None else spill.keys.shape[0],
                *[cuda.ptr(o) for o in outs[:4]],
                *[cuda.ptr(o) for o in sp_out])
    return tuple(outs)
