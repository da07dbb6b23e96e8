"""Wrapper of the CUDA fixed-hash bucket probe (`csrc/hash_probe.cu`).

Replaces `repro/kernels/hash_probe/kernel.py:hash_probe_tiles`. On CUDA
tensors it launches the kernel (one thread per query, a loop over the
B <= 16 bucket columns); on CPU tensors it runs `ref.hash_probe_ref`."""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.hash_probe.ref import hash_probe_ref


def hash_probe_tiles(q: torch.Tensor, slots: torch.Tensor,
                     keys: torch.Tensor):
    """q: [T] int64; slots: [T] int32; keys: [M, B] int64. Returns
    (found int8[T], col int32[T])."""
    if not q.is_cuda:
        return hash_probe_ref(q, slots, keys)
    cuda.check_cuda("hash_probe", q, slots, keys)
    if slots.dtype != torch.int32 or keys.dtype != torch.int64:
        raise ValueError("hash_probe: slots int32, keys int64 expected")
    t = q.shape[0]
    found = torch.empty(t, dtype=torch.int8, device=q.device)
    col = torch.empty(t, dtype=torch.int32, device=q.device)
    cuda.launch("hash_probe", "hash_probe_launch", cuda.ptr(q),
                cuda.ptr(slots), t, cuda.ptr(keys), keys.shape[0],
                keys.shape[1], cuda.ptr(found), cuda.ptr(col), shape=t)
    return found, col
