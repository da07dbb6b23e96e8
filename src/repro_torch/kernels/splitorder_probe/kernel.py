"""Wrapper of the CUDA two-level split-order probe
(`csrc/splitorder_probe.cu`).

Replaces `repro/kernels/splitorder_probe/kernel.py:splitorder_probe_tiles`.
On CUDA tensors it launches the kernel (one thread per query); on CPU
tensors it runs the plain version (`ref.splitorder_probe_ref`)."""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.splitorder_probe.ref import splitorder_probe_ref


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
    t = q_rk.shape[0]
    found = torch.empty(t, dtype=torch.int8, device=q_rk.device)
    at = torch.empty(t, dtype=torch.int32, device=q_rk.device)
    cuda.launch("splitorder_probe", "splitorder_probe_launch",
                cuda.ptr(q_rk), cuda.ptr(q_key), cuda.ptr(tables), t,
                cuda.ptr(rk), cuda.ptr(keys), rk.shape[0], rk.shape[1],
                cuda.ptr(found), cuda.ptr(at), shape=t)
    return found, at
