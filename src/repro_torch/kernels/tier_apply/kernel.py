"""Wrapper of the CUDA fused tier apply (`csrc/tier_apply.cu`).

Replaces `repro/kernels/tier_apply/kernel.py:tier_apply_tiles`, both warm
layouts. On CUDA tensors one dispatch is two launches (each counted in
`cuda.LAUNCHES["tier_apply"]`): the membership kernel, a team of
`member_team` threads a lane, and the scan kernel, one block a tile of `TILE` lanes, which counts
the in-run ranks within its tile and chains the need-evict prefix across
tiles. On CPU tensors it runs `ref.tier_apply_planes_ref`."""
from __future__ import annotations

import functools

import torch

from repro_torch.core.layout import (BSkiplistLayout, SkiplistLayout,
                                     SpillLayout)
from repro_torch.kernels import cuda
from repro_torch.kernels.tier_apply.ref import (POLICY_CODES,
                                                tier_apply_planes_ref)

TILE = 256    # lanes a scan tile (csrc/tier_apply.cu, TA_TILE)
BLOCK_TEAM = 32        # the membership team in the block layout
LEVEL_TEAMS = (16, 8, 4, 2, 1)   # the level layout's membership teams


def scan_state_words(k: int) -> int:
    """int32 words of the scan launch's scratch for k lanes: the tile
    ticket, then a key-run, a slot-run and a need-evict word a tile. The
    membership launch zeroes them."""
    return 1 + 3 * -(-k // TILE)


def member_team(k: int, layout: str, sms: int, slots) -> int:
    """Threads a lane in the membership launch of k lanes on a card of
    `sms` SMs; `slots(team)` is the resident threads an SM of the level
    layout's instance for `team`. The block layout's node counts read 128
    keys a node, so its team is a warp. The level layout's walk runs on
    one thread of the team: `cuda.team_width` over LEVEL_TEAMS."""
    if layout == "block":
        return BLOCK_TEAM
    return cuda.team_width(k, LEVEL_TEAMS, sms, slots)


@functools.lru_cache(maxsize=None)
def member_slots(index: int, team: int) -> int:
    """Resident threads an SM of the level layout's membership instance for
    `team` on CUDA device `index` (`tier_apply_member_slots`)."""
    with torch.cuda.device(index):
        return cuda.library("tier_apply").tier_apply_member_slots(team)


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
    state = torch.empty(scan_state_words(k), dtype=torch.int32, device=dev)
    code = POLICY_CODES[policy]
    cuda.launch("tier_apply", "tier_apply_member_launch", cuda.ptr(sk),
                cuda.ptr(ss), cuda.ptr(sm), k, cuda.ptr(hot_keys),
                cuda.ptr(meta), m, b, *wargs, cuda.ptr(sp.keys),
                cuda.ptr(sp.dead), cuda.ptr(sp.run_off), runs,
                0 if spill is None else spill.keys.shape[0], code,
                cuda.ptr(in_warm), cuda.ptr(in_spill), cuda.ptr(ecol),
                cuda.ptr(flags), cuda.ptr(emask), cuda.ptr(vorder),
                cuda.ptr(state), state.numel(),
                member_team(k, layout, cuda.sm_count(dev),
                            functools.partial(member_slots, dev.index or 0)),
                variant=layout, shape=k)
    cuda.launch("tier_apply", "tier_apply_scan_launch", k, b, code,
                cuda.ptr(krs), cuda.ptr(srs), cuda.ptr(flags),
                cuda.ptr(emask), cuda.ptr(vorder), cuda.ptr(max_evict),
                cuda.ptr(state), cuda.ptr(placed), cuda.ptr(exists),
                cuda.ptr(dup), cuda.ptr(need_ev), cuda.ptr(col),
                cuda.ptr(vcol), variant=layout, shape=k)
    return (in_warm, in_spill, placed, exists, dup, need_ev, col, vcol, ecol)
