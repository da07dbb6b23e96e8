"""Wrapper of the CUDA fused tier apply (`csrc/tier_apply.cu`).

Replaces `repro/kernels/tier_apply/kernel.py:tier_apply_tiles`, both warm
layouts. On CUDA tensors one dispatch is two launches: the
per-lane membership kernel, then the one-block scan kernel for the three
dependent prefix sums (each counted in `cuda.LAUNCHES["tier_apply"]`). On
CPU tensors it runs `ref.tier_apply_planes_ref`."""
from __future__ import annotations

import torch

from repro_torch.core.layout import (BSkiplistLayout, SkiplistLayout,
                                     SpillLayout)
from repro_torch.kernels import cuda
from repro_torch.kernels.tier_apply.ref import (POLICY_CODES,
                                                tier_apply_planes_ref)


def tier_apply_tiles(sk, ss, sm, krs, srs, hot_keys, meta,
                     warm: SkiplistLayout | BSkiplistLayout, max_evict,
                     spill: SpillLayout | None, policy: str):
    """See `ref.tier_apply_planes_ref` for the arguments. Returns
    (in_warm, in_spill, placed, exists, dup, need_ev) int8 and
    (col, vcol, ecol) int32, all [K] in sorted lane order."""
    if not sk.is_cuda:
        return tier_apply_planes_ref(sk, ss, sm, krs, srs, hot_keys, meta,
                                     warm, max_evict, spill, policy)
    sp = spill if spill is not None else SpillLayout(None, None, None)
    cuda.check_cuda("tier_apply", sk, ss, sm, krs, srs, hot_keys, meta,
                    max_evict, *sp)
    wargs, layout = cuda.warm_args("tier_apply", warm)
    m, b = hot_keys.shape
    if b > 16:
        raise ValueError("tier_apply: bucket width must be <= 16")
    runs = 0 if spill is None else spill.run_off.shape[0] - 1
    if runs > 64:
        raise ValueError("tier_apply: at most 64 spill runs")
    k = sk.shape[0]
    dev = sk.device
    i8 = [torch.empty(k, dtype=torch.int8, device=dev) for _ in range(6)]
    i32 = [torch.empty(k, dtype=torch.int32, device=dev) for _ in range(3)]
    in_warm, in_spill, placed, exists, dup, need_ev = i8
    col, vcol, ecol = i32
    flags = torch.empty(k, dtype=torch.int8, device=dev)
    emask = torch.empty(k, dtype=torch.int32, device=dev)
    vorder = torch.empty(k, dtype=torch.int64, device=dev)
    c1 = torch.empty(k, dtype=torch.int32, device=dev)
    c2 = torch.empty(k, dtype=torch.int32, device=dev)
    code = POLICY_CODES[policy]
    cuda.launch("tier_apply", "tier_apply_member_launch", cuda.ptr(sk),
                cuda.ptr(ss), cuda.ptr(sm), k, cuda.ptr(hot_keys),
                cuda.ptr(meta), m, b, *wargs, cuda.ptr(sp.keys),
                cuda.ptr(sp.dead), cuda.ptr(sp.run_off), runs,
                0 if spill is None else spill.keys.shape[0], code,
                cuda.ptr(in_warm), cuda.ptr(in_spill), cuda.ptr(ecol),
                cuda.ptr(flags), cuda.ptr(emask), cuda.ptr(vorder),
                layout=layout)
    cuda.launch("tier_apply", "tier_apply_scan_launch", k, b, code,
                cuda.ptr(krs), cuda.ptr(srs), cuda.ptr(flags),
                cuda.ptr(emask), cuda.ptr(vorder), cuda.ptr(max_evict),
                cuda.ptr(c1), cuda.ptr(c2), cuda.ptr(placed),
                cuda.ptr(exists), cuda.ptr(dup), cuda.ptr(need_ev),
                cuda.ptr(col), cuda.ptr(vcol), layout=layout)
    return (in_warm, in_spill, placed, exists, dup, need_ev, col, vcol, ecol)
