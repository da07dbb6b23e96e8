"""Glue for the fused selective scan (counterpart of
`repro.kernels.selective_scan.ops`): float32, contiguous operands into the
kernel wrapper. The TPU op's `d_block` / `chunk` tiling knobs have no
counterpart (the CUDA kernel tiles itself)."""
from __future__ import annotations

import torch

from repro_torch.kernels.selective_scan.kernel import selective_scan_fused


def selective_scan(x, dt, bmat, cmat, a, h0=None):
    """Fused mamba-1 scan: x [B,S,D], dt [B,S], B/C [B,S,N], A [D,N], h0
    [B,D,N] or None -> (y [B,S,D] f32, h_last [B,D,N] f32)."""
    def f32(t):
        return None if t is None else t.to(torch.float32).contiguous()
    return selective_scan_fused(f32(x), f32(dt), f32(bmat), f32(cmat),
                                f32(a), f32(h0))
