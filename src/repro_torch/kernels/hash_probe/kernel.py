"""Wrapper of the CUDA fixed-hash bucket probe (`csrc/hash_probe.cu`).

Replaces `repro/kernels/hash_probe/kernel.py:hash_probe_tiles`. On CUDA
tensors it launches the kernel: a team of `probe_team` lanes a query
reads the bucket row in one round. On CPU tensors it runs
`ref.hash_probe_ref`."""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.hash_probe.ref import hash_probe_ref

# the team widths hash_probe.cu has instances for, widest first
TEAMS = (16, 8, 4, 2, 1)
MAX_BUCKET = 16    # columns of a bucket row (csrc/probe.cuh)


def probe_team(t: int, sms: int, slots) -> int:
    """Lanes a query for t queries on a card of `sms` SMs, `slots(team)`
    the resident threads an SM of the instance for `team`:
    `cuda.team_width` over `TEAMS`."""
    return cuda.team_width(t, TEAMS, sms, slots)


@functools.lru_cache(maxsize=None)
def probe_slots(index: int, team: int) -> int:
    """Resident threads an SM of the instance for `team` on CUDA device
    `index` (`hash_probe_slots`)."""
    with torch.cuda.device(index):
        return cuda.library("hash_probe").hash_probe_slots(team)


def hash_probe_tiles(q: torch.Tensor, slots: torch.Tensor,
                     keys: torch.Tensor):
    """q: [T] int64; slots: [T] int32; keys: [M, B] int64 (B <= 16).
    Returns (found int8[T], col int32[T])."""
    if not q.is_cuda:
        return hash_probe_ref(q, slots, keys)
    cuda.check_cuda("hash_probe", q, slots, keys)
    if slots.dtype != torch.int32 or keys.dtype != torch.int64:
        raise ValueError("hash_probe: slots int32, keys int64 expected")
    if keys.shape[1] > MAX_BUCKET:
        raise ValueError("hash_probe: bucket width must be <= 16")
    t = q.shape[0]
    found = torch.empty(t, dtype=torch.int8, device=q.device)
    col = torch.empty(t, dtype=torch.int32, device=q.device)
    team = probe_team(t, cuda.sm_count(q.device),
                      functools.partial(probe_slots, q.device.index or 0))
    cuda.launch("hash_probe", "hash_probe_launch", cuda.ptr(q),
                cuda.ptr(slots), t, cuda.ptr(keys), keys.shape[0],
                keys.shape[1], cuda.ptr(found), cuda.ptr(col), team, shape=t)
    return found, col
