"""Glue for the fused selective scan (counterpart of
`repro.kernels.selective_scan.ops`): float32, contiguous operands into the
kernel wrappers, and under autograd the `SelectiveScan` Function, whose
backward is the backward kernel. The TPU op's `d_block` / `chunk` tiling
knobs have no counterpart (the CUDA kernel tiles itself)."""
from __future__ import annotations

import torch

from repro_torch.kernels.selective_scan.kernel import (selective_scan_bwd,
                                                       selective_scan_fused)

BF16_BACKWARD_REFUSAL = (
    "the selective_scan kernel's bfloat16 scan has no backward: train "
    "with ssm_scan_dtype 'float32', or in exec mode 'torch'")


class SelectiveScan(torch.autograd.Function):
    """(y, h_last) of the f32 scan, differentiable in x, dt, B, C, A and
    h0. The forward keeps the state entering every 16 steps; the backward
    recomputes h inside each such window from it. On CPU tensors both run the plain
    versions (the chunked scan, `selective_scan_bwd_ref`)."""

    @staticmethod
    def forward(ctx, x, dt, bmat, cmat, a, h0):
        y, h_last, chunks = selective_scan_fused(x, dt, bmat, cmat, a, h0,
                                                 save_chunks=True)
        ctx.save_for_backward(x, dt, bmat, cmat, a, h0, chunks)
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        x, dt, bmat, cmat, a, h0, chunks = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.float().contiguous()
        if dh_last is not None:
            dh_last = dh_last.float().contiguous()
        dx, ddt, db, dc, da, dh0 = selective_scan_bwd(
            x, dt, bmat, cmat, a, h0, chunks, dy, dh_last)
        dh0 = dh0 if ctx.needs_input_grad[5] else None
        return dx, ddt, db, dc, da, dh0


def selective_scan(x, dt, bmat, cmat, a, h0=None, scan_dtype=torch.float32,
                   scan_chunk: int = 256):
    """Fused mamba-1 scan: x [B,S,D], dt [B,S], B/C [B,S,N], A [D,N], h0
    [B,D,N] or None -> (y [B,S,D] f32, h_last [B,D,N] f32); `scan_dtype`
    and `scan_chunk` the reference's `ssm_scan_dtype` and `scan_chunk`.
    Under autograd (an input that requires grad) it goes through
    `SelectiveScan`; the bfloat16 scan has no backward and refuses."""
    def f32(t):
        return None if t is None else t.to(torch.float32).contiguous()
    args = [f32(t) for t in (x, dt, bmat, cmat, a, h0)]
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in args):
        if scan_dtype != torch.float32:
            raise NotImplementedError(BF16_BACKWARD_REFUSAL)
        return SelectiveScan.apply(*args)
    return selective_scan_fused(*args, scan_dtype=scan_dtype,
                                scan_chunk=scan_chunk)
