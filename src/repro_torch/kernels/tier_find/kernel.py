"""Wrapper of the CUDA fused tier find (`csrc/tier_find.cu`).

Replaces `repro/kernels/tier_find/kernel.py:tier_find_tiles`, both warm
layouts. On CUDA tensors it launches the kernel: a team of `find_team`
lanes a query reads the bucket row in one round and searches the spill
runs side by side, the warm walk's rounds running inside the spill
search's. On CPU tensors it runs `ref.tier_find_planes_ref`."""
from __future__ import annotations

import functools

import torch

from repro_torch.core.layout import (BSkiplistLayout, SkiplistLayout,
                                     SpillLayout)
from repro_torch.kernels import cuda
from repro_torch.kernels.tier_find.ref import tier_find_planes_ref

# the team widths tier_find.cu has instances for, widest first
TEAMS = {"level": (16, 8, 4, 2, 1), "block": (32, 16, 8, 4, 2, 1)}
MAX_BUCKET = 16    # columns of a bucket row (csrc/probe.cuh)


def find_team(k: int, layout: str, sms: int, slots) -> int:
    """Lanes a query in a launch of k queries on a card of `sms` SMs;
    `slots(team)` is the resident threads an SM of the layout's instance
    for `team`: `cuda.team_width` over the layout's widths (`TEAMS`). The
    level layout walks on one lane of the team, so its widest team is 16;
    in the block layout the whole team walks, a warp counting each node."""
    return cuda.team_width(k, TEAMS[layout], sms, slots)


@functools.lru_cache(maxsize=None)
def find_slots(index: int, layout: str, team: int) -> int:
    """Resident threads an SM of tier_find's instance for (`layout`,
    `team`) on CUDA device `index` (`tier_find_slots`)."""
    with torch.cuda.device(index):
        return cuda.library("tier_find").tier_find_slots(
            team, int(layout == "block"))


def tier_find_tiles(q: torch.Tensor, slots: torch.Tensor,
                    hot_keys: torch.Tensor,
                    warm: SkiplistLayout | BSkiplistLayout,
                    spill: SpillLayout | None = None):
    """q: [T] int64; slots: [T] int32; hot_keys: [M, B] int64 (B <= 16);
    warm: the level-major or the block-major view. Returns (hot int8, col
    int32, warm int8, idx int32) plus (spill int8, cell int32) when
    `spill` is given."""
    if not q.is_cuda:
        return tier_find_planes_ref(q, slots, hot_keys, warm, spill)
    sp = spill if spill is not None else SpillLayout(None, None, None)
    cuda.check_cuda("tier_find", q, slots, hot_keys, *sp)
    wargs, layout = cuda.warm_args("tier_find", warm)
    if hot_keys.shape[1] > MAX_BUCKET:
        raise ValueError("tier_find: bucket width must be <= 16")
    runs = 0 if spill is None else spill.run_off.shape[0] - 1
    if runs > 64:
        raise ValueError("tier_find: at most 64 spill runs")
    t = q.shape[0]
    dev = q.device
    outs = [torch.empty(t, dtype=d, device=dev)
            for d in (torch.int8, torch.int32) * (3 if spill is not None else 2)]
    sp_out = outs[4:] if spill is not None else [None, None]
    team = find_team(t, layout, cuda.sm_count(dev),
                     functools.partial(find_slots, dev.index or 0, layout))
    cuda.launch("tier_find", "tier_find_launch", cuda.ptr(q), cuda.ptr(slots),
                t, cuda.ptr(hot_keys), hot_keys.shape[0], hot_keys.shape[1],
                *wargs, cuda.ptr(sp.keys), cuda.ptr(sp.dead),
                cuda.ptr(sp.run_off), runs,
                0 if spill is None else spill.keys.shape[0],
                *[cuda.ptr(o) for o in outs[:4]],
                *[cuda.ptr(o) for o in sp_out], team, variant=layout, shape=t)
    return tuple(outs)
