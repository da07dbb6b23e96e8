"""Wrapper of the CUDA selective scan (`csrc/selective_scan.cu`).

Replaces `repro/kernels/selective_scan/kernel.py:selective_scan_blocks`.
On CUDA tensors it launches the kernel, a group of lanes a (batch,
channel) pair, each lane holding up to 8 of the channel's N states in
registers, counted in `cuda.LAUNCHES["selective_scan"]`; on CPU tensors
it runs the plain version the model's exec mode `torch` runs
(`ref.selective_scan_chunked`).
Unlike the TPU kernel it takes the initial state `h0` and returns the
last one, so one wrapper serves prefill (h0 = 0) and every decode step (a
scan of length 1 from the cached state)."""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.selective_scan.ref import selective_scan_chunked

# state sizes the kernel is instantiated for
STATE_SIZES = (4, 8, 16, 32, 64)


def selective_scan_fused(x, dt, bmat, cmat, a, h0=None):
    """x: [B,S,D]; dt: [B,S]; bmat/cmat: [B,S,N]; a: [D,N]; h0: [B,D,N]
    or None (zeros); all float32, N one of STATE_SIZES (checked on either
    device). Returns (y [B,S,D], h_last [B,D,N])."""
    b, s, d = x.shape
    n = bmat.shape[-1]
    if (dt.shape != (b, s) or bmat.shape != (b, s, n)
            or cmat.shape != (b, s, n) or a.shape != (d, n)
            or (h0 is not None and h0.shape != (b, d, n))):
        raise ValueError("selective_scan: x [B,S,D], dt [B,S], B/C [B,S,N], "
                         "A [D,N], h0 [B,D,N]")
    if any(t is not None and t.dtype != torch.float32
           for t in (x, dt, bmat, cmat, a, h0)):
        raise ValueError("selective_scan: float32 inputs")
    if n not in STATE_SIZES:
        raise ValueError(f"selective_scan: N={n} must be one of "
                         f"{STATE_SIZES}")
    if not x.is_cuda:
        return selective_scan_chunked(x, dt, bmat, cmat, a, h0)
    cuda.check_cuda("selective_scan", x, dt, bmat, cmat, a, h0)
    y = torch.empty_like(x)
    h_last = torch.empty((b, d, n), dtype=torch.float32, device=x.device)
    cuda.launch("selective_scan", "selective_scan_launch", cuda.ptr(x),
                cuda.ptr(dt), cuda.ptr(bmat), cuda.ptr(cmat), cuda.ptr(a),
                cuda.ptr(h0), cuda.ptr(y), cuda.ptr(h_last), b, s, d, n)
    return y, h_last
