"""Wrappers of the CUDA selective scan (`csrc/selective_scan.cu`).

`selective_scan_fused` replaces
`repro/kernels/selective_scan/kernel.py:selective_scan_blocks`. On CUDA
tensors it launches the kernel, a group of lanes a (batch, channel) pair,
each lane holding up to 8 of the channel's N states in registers, counted
in `cuda.LAUNCHES["selective_scan"]`; on CPU tensors it runs the plain
version the model's exec mode `torch` runs (`ref.selective_scan_chunked`).
Unlike the TPU kernel it takes the initial state `h0` and returns the
last one, so one wrapper serves prefill (h0 = 0) and every decode step (a
scan of length 1 from the cached state). `scan_dtype` bfloat16 is the
reference's `ssm_scan_dtype` lever; `save_chunks` also returns the state
entering every `SS_SAVE` steps, what the backward starts from (such a
launch is also counted in `cuda.LAUNCHES["selective_scan/save"]`).

`selective_scan_bwd` is the backward (no TPU counterpart: the reference
trains through its plain scan), counted in
`cuda.LAUNCHES["selective_scan_bwd"]`; on CPU tensors it runs
`ref.selective_scan_bwd_ref`.

`scan_geometry` picks each launch's lane split (states a lane, lanes a
channel, channels a block, and the backward's cluster) from the shape and
the card's SM count; the csrc headers give the reckoning."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.selective_scan.ref import (selective_scan_bwd_ref,
                                                    selective_scan_chunked)

# state sizes the kernel is instantiated for
STATE_SIZES = (4, 8, 16, 32, 64)
SCAN_DTYPES = (torch.float32, torch.bfloat16)
SS_CHUNK = 32             # steps a staging buffer holds (csrc's SS_CHUNK)
SS_SAVE = 16              # steps between saved states (csrc's SS_SAVE)
SS_THREADS = 128          # lanes a block (csrc's SS_THREADS)
# the forward's lane splits, most states a lane first (csrc: PER in 8, 4,
# 2, 1 with N / PER lanes a channel, at most a warp)
FORWARD_PERS = (8, 4, 2, 1)
BACKWARD_PER = 2          # the backward's states a lane (SS_BWD_PER)
MAX_CLUSTER = 8           # blocks a backward cluster (SS_BWD_MAX_CLUSTER)
# the forward takes the most states a lane whose lanes still give every SM
# MIN_WARPS_PER_SM warps
MIN_WARPS_PER_SM = 6
GEOMETRY_KINDS = ("forward", "backward")
# the bf16 scan (the reference's associative scan, its tree per lane in
# local memory): chunks of at most BF16_MAX_CHUNK steps, N at most
# BF16_MAX_STATE (a channel's lanes in one warp)
BF16_MAX_CHUNK = 256
BF16_MAX_STATE = 32


class ScanGeometry(NamedTuple):
    """One launch's lane split: `per` states a lane, `lanes` (N / per)
    lanes a channel, `channels` a block of SS_THREADS lanes, `blocks`
    along D, and `cluster` blocks a thread block cluster (the backward
    sums its dB / dC / dt partials over a cluster's blocks before they
    reach HBM; 1 for the forward)."""
    per: int
    lanes: int
    channels: int
    blocks: int
    cluster: int


def forward_pers(n: int) -> tuple:
    """The forward's lane splits built for state size n (a channel's
    lanes within a warp), most states a lane first."""
    return tuple(p for p in FORWARD_PERS if p <= n and n // p <= 32)


def split(d: int, n: int, per: int, cluster: int = 1) -> ScanGeometry:
    """The geometry of `per` states a lane in blocks of SS_THREADS
    lanes."""
    lanes = n // per
    channels = SS_THREADS // lanes
    blocks = -(-d // channels)
    return ScanGeometry(per, lanes, channels, blocks,
                        max(1, min(cluster, blocks)))


def scan_geometry(b: int, s: int, d: int, n: int, sms: int,
                  kind: str = "forward") -> ScanGeometry:
    """The lane split of a scan launch over [B, S, D] x N states on a card
    of `sms` SMs. Each lane walks all S steps in order, so a lane's
    latency a step sets the time, and more states a lane overlap more of
    it: the forward (saving or not, so that both give the same bits)
    takes the most states a lane whose B * D * N / per lanes still give
    every SM MIN_WARPS_PER_SM warps (else the fewest); S does not enter (a
    decode step takes its prefill's split). The backward keeps
    BACKWARD_PER states a lane (its window of h and exp(dt A) lives in
    registers) in clusters of up to MAX_CLUSTER blocks."""
    if kind not in GEOMETRY_KINDS:
        raise ValueError(f"scan_geometry: kind {kind!r} not in "
                         f"{GEOMETRY_KINDS}")
    if kind == "backward":
        return split(d, n, BACKWARD_PER, MAX_CLUSTER)
    pers = forward_pers(n)
    return split(d, n, next((p for p in pers
                             if b * d * n // p >= sms * MIN_WARPS_PER_SM * 32),
                            pers[-1]))


def check_inputs(x, dt, bmat, cmat, a, h0=None) -> None:
    """x: [B,S,D]; dt: [B,S]; bmat/cmat: [B,S,N]; a: [D,N]; h0: [B,D,N]
    or None; all float32, N one of STATE_SIZES (checked on either
    device)."""
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


def selective_scan_fused(x, dt, bmat, cmat, a, h0=None, *,
                         scan_dtype=torch.float32, scan_chunk: int = 256,
                         save_chunks=False):
    """x: [B,S,D]; dt: [B,S]; bmat/cmat: [B,S,N]; a: [D,N]; h0: [B,D,N]
    or None (zeros); all float32 (`check_inputs`). `scan_chunk` is the
    reference's chunk (`cfg.scan_chunk`), where its bf16 scan carries a
    bf16 state (the f32 scan does not depend on it). Returns (y [B,S,D],
    h_last [B,D,N]), and with `save_chunks` also the states entering each
    SS_SAVE steps, [B, ceil(S / SS_SAVE), D, N] f32 (None on the CPU,
    whose backward starts from h0)."""
    check_inputs(x, dt, bmat, cmat, a, h0)
    if scan_dtype not in SCAN_DTYPES:
        raise ValueError(f"selective_scan: scan dtype {scan_dtype} not in "
                         f"{SCAN_DTYPES}")
    if scan_chunk < 1:
        raise ValueError(f"selective_scan: scan chunk {scan_chunk} < 1")
    if scan_dtype == torch.bfloat16 and (
            scan_chunk > BF16_MAX_CHUNK or bmat.shape[-1] > BF16_MAX_STATE
            or save_chunks):
        raise ValueError(f"selective_scan: the bf16 scan takes chunks of "
                         f"at most {BF16_MAX_CHUNK} steps and N at most "
                         f"{BF16_MAX_STATE}, and has no backward")
    if not x.is_cuda:
        y, h = selective_scan_chunked(x, dt, bmat, cmat, a, h0, scan_chunk,
                                      scan_dtype)
        return (y, h, None) if save_chunks else (y, h)
    b, s, d = x.shape
    n = bmat.shape[-1]
    cuda.check_cuda("selective_scan", x, dt, bmat, cmat, a, h0)
    y = torch.empty_like(x)
    h_last = torch.empty((b, d, n), dtype=torch.float32, device=x.device)
    chunks = (torch.empty((b, -(-s // SS_SAVE), d, n), dtype=torch.float32,
                          device=x.device) if save_chunks else None)
    geo = scan_geometry(b, s, d, n, cuda.sm_count(x.device))
    cuda.launch("selective_scan", "selective_scan_launch", cuda.ptr(x),
                cuda.ptr(dt), cuda.ptr(bmat), cuda.ptr(cmat), cuda.ptr(a),
                cuda.ptr(h0), cuda.ptr(y), cuda.ptr(h_last),
                cuda.ptr(chunks), b, s, d, n, geo.per,
                scan_chunk if scan_dtype == torch.bfloat16 else 0,
                variant="save" if save_chunks else None)
    return (y, h_last, chunks) if save_chunks else (y, h_last)


def selective_scan_bwd(x, dt, bmat, cmat, a, h0, h_chunks, dy,
                       dh_last=None):
    """The f32 scan's gradient for the cotangents dy [B,S,D] and dh_last
    [B,D,N] (None: zeros), from the forward's inputs and, on CUDA, its
    chunk states (`selective_scan_fused(..., save_chunks=True)`). Returns
    (dx, ddt, dB, dC, dA, dh0) in the shapes of (x, dt, B, C, A, h0)."""
    check_inputs(x, dt, bmat, cmat, a, h0)
    if not x.is_cuda:
        return selective_scan_bwd_ref(x, dt, bmat, cmat, a, h0, dy, dh_last)
    b, s, d = x.shape
    n = bmat.shape[-1]
    if dy.shape != x.shape or dy.dtype != torch.float32 or (
            dh_last is not None and (dh_last.shape != (b, d, n)
                                     or dh_last.dtype != torch.float32)):
        raise ValueError("selective_scan_bwd: f32 dy [B,S,D], dh_last "
                         "[B,D,N]")
    if h_chunks is None or h_chunks.shape != (b, -(-s // SS_SAVE), d, n):
        raise ValueError("selective_scan_bwd: the forward's chunk states "
                         "[B, ceil(S / 16), D, N]")
    cuda.check_cuda("selective_scan_bwd", x, dt, bmat, cmat, a, h_chunks,
                    dy, dh_last)
    f32 = dict(dtype=torch.float32, device=x.device)
    if b == 0 or d == 0:
        return (torch.zeros_like(x), torch.zeros((b, s), **f32),
                torch.zeros((b, s, n), **f32), torch.zeros((b, s, n), **f32),
                torch.zeros((d, n), **f32), torch.zeros((b, d, n), **f32))
    geo = scan_geometry(b, s, d, n, cuda.sm_count(x.device), "backward")
    part = torch.empty((b, -(-geo.blocks // geo.cluster), s, 2 * n + 1),
                       **f32)
    part_da = torch.empty((b, d, n), **f32)
    dx = torch.empty_like(x)
    ddt = torch.empty((b, s), **f32)
    db = torch.empty((b, s, n), **f32)
    dc = torch.empty((b, s, n), **f32)
    da = torch.empty((d, n), **f32)
    dh0 = torch.empty((b, d, n), **f32)
    cuda.launch("selective_scan_bwd", "selective_scan_bwd_launch",
                *(cuda.ptr(t) for t in (x, dt, bmat, cmat, a, h_chunks, dy,
                                        dh_last, dx, part, part_da, db, dc,
                                        ddt, da, dh0)), b, s, d, n,
                geo.cluster)
    return dx, ddt, db, dc, da, dh0
