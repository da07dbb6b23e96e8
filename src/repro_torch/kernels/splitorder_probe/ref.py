"""Plain PyTorch version of the splitorder_probe kernel: per query, a
searchsorted-left of its bit-reversed hash over its table's row, then
the first (rk, key) match in the WINDOW cells from there.

The reference oracle gathers one whole [C2] row per query; here the
search is a batched binary search over flat indices `table * C2 + mid`,
as the kernel does, so nothing of size K * C2 exists. u64 compares go
through `core.bits`.
"""
from __future__ import annotations

import torch

from repro_torch.core.bits import u64_lt
from repro_torch.core.layout import first_true

WINDOW = 4  # must equal core.splitorder.WINDOW


def splitorder_probe_ref(q_rk: torch.Tensor, q_key: torch.Tensor,
                         tables: torch.Tensor, rk: torch.Tensor,
                         keys: torch.Tensor):
    """q_rk, q_key: [T] int64; tables: [T] int32 (clipped to [0, T_tables));
    rk, keys: [T_tables, C2] int64 rows sorted by rk (as u64). Returns
    (found int8[T], at int32[T]); `at` is clipped to [0, C2) and is the
    first hit of the window (its start on a miss)."""
    n_tables, c2 = rk.shape
    frk, fkey = rk.reshape(-1), keys.reshape(-1)
    base = torch.clamp(tables, 0, n_tables - 1).to(torch.int64) * c2
    lo = torch.zeros_like(base)
    hi = torch.full_like(base, c2)
    for _ in range(max(c2.bit_length(), 1)):
        cont = lo < hi
        mid = (lo + hi) // 2
        less = u64_lt(frk[base + torch.clamp(mid, 0, c2 - 1)], q_rk)
        lo = torch.where(cont & less, mid + 1, lo)
        hi = torch.where(cont & ~less, mid, hi)
    w = torch.arange(WINDOW, device=lo.device)
    idx = base[:, None] + torch.clamp(lo[:, None] + w, 0, c2 - 1)
    hit = (frk[idx] == q_rk[:, None]) & (fkey[idx] == q_key[:, None])
    at = torch.clamp(lo + first_true(hit), 0, c2 - 1).to(torch.int32)
    return hit.any(dim=1).to(torch.int8), at
