"""Wrapper of the CUDA two-level split-order probe
(`csrc/splitorder_probe.cu`).

Replaces `repro/kernels/splitorder_probe/kernel.py:splitorder_probe_tiles`.
On CUDA tensors it launches the kernel: a team of `probe_team` lanes a
query searches its table's row (team + 1)-ary, then reads the window. On
CPU tensors it runs the plain version (`ref.splitorder_probe_ref`)."""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.splitorder_probe.ref import splitorder_probe_ref

# the team widths splitorder_probe.cu has instances for, widest first: no
# 32 (slower than 16 at 4,096 lanes), no 4 or 2 (slower than one lane a
# query at 65,536; PERF.md)
TEAMS = (16, 8, 1)
MAX_ROW = 1 << 27  # cells a row (the kernel's integer pivots)


def probe_team(t: int, sms: int, slots) -> int:
    """Lanes a query for t queries on a card of `sms` SMs, `slots(team)`
    the resident threads an SM of the instance for `team`:
    `cuda.team_width` over `TEAMS`."""
    return cuda.team_width(t, TEAMS, sms, slots)


@functools.lru_cache(maxsize=None)
def probe_slots(index: int, team: int) -> int:
    """Resident threads an SM of the instance for `team` on CUDA device
    `index` (`splitorder_probe_slots`)."""
    with torch.cuda.device(index):
        return cuda.library("splitorder_probe").splitorder_probe_slots(team)


def splitorder_probe_tiles(q_rk: torch.Tensor, q_key: torch.Tensor,
                           tables: torch.Tensor, rk: torch.Tensor,
                           keys: torch.Tensor):
    """q_rk, q_key: [T] int64; tables: [T] int32; rk, keys: [T_tables, C2]
    int64. Returns (found int8[T], at int32[T])."""
    if not q_rk.is_cuda:
        return splitorder_probe_ref(q_rk, q_key, tables, rk, keys)
    cuda.check_cuda("splitorder_probe", q_rk, q_key, tables, rk, keys)
    if tables.dtype != torch.int32 or rk.dtype != torch.int64 \
            or keys.shape != rk.shape:
        raise ValueError("splitorder_probe: int32 tables and int64 [T, C2] "
                         "rk / key planes of one shape expected")
    if rk.shape[1] >= MAX_ROW:
        raise ValueError("splitorder_probe: rows must be < 2^27 cells")
    t = q_rk.shape[0]
    found = torch.empty(t, dtype=torch.int8, device=q_rk.device)
    at = torch.empty(t, dtype=torch.int32, device=q_rk.device)
    team = probe_team(t, cuda.sm_count(q_rk.device),
                      functools.partial(probe_slots, q_rk.device.index or 0))
    cuda.launch("splitorder_probe", "splitorder_probe_launch",
                cuda.ptr(q_rk), cuda.ptr(q_key), cuda.ptr(tables), t,
                cuda.ptr(rk), cuda.ptr(keys), rk.shape[0], rk.shape[1],
                cuda.ptr(found), cuda.ptr(at), team, shape=t)
    return found, at
