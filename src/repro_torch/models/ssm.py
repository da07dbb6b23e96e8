"""The selective SSM (mamba-style) of hymba's hybrid block (counterpart of
the mamba half of `repro.models.ssm`; mLSTM and sLSTM wait).

State per layer: {"conv": [B, K-1, d_inner] (compute dtype),
"ssm": [B, d_inner, d_state] f32}. Prefill and decode run the same
`mamba_forward`; a decode step is a sequence of length 1 from the cached
state.

The exec mode (`repro_torch.exec`) picks the scan: `gpu` (the default)
launches the `selective_scan` CUDA kernel on (x_conv, dt, B, C, A, h0),
which is forward-only: it refuses inputs that autograd tracks, and CPU
tensors; `torch` runs the reference's chunked associative scan
(`kernels.selective_scan.ref.selective_scan_chunked`). The D skip, the
SiLU gate and the output projection stay plain ops around the scan in
both, as they sit outside the reference's Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.selective_scan.ops import selective_scan
from repro_torch.kernels.selective_scan.ref import selective_scan_chunked
from repro_torch.models.common import dense_init, dtype_of
from repro_torch.models.params import Weights
from repro_torch import exec as exec_


class Mamba(Weights):
    """in_proj (x and gate z), conv_w (depthwise, K taps), x_proj (dt, B,
    C), a_log, d_skip, out_proj."""
    MATMUL = ("in_proj", "conv_w", "x_proj", "out_proj")


def init_mamba(gen: torch.Generator, cfg) -> Mamba:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    pd = dtype_of(cfg.param_dtype)
    dev = gen.device
    conv = torch.randn((cfg.ssm_conv, di), generator=gen,
                       dtype=torch.float32, device=dev) * 0.1
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=dev))[None, :].repeat(di, 1)
    return Mamba(in_proj=dense_init(gen, d, 2 * di, cfg.param_dtype),
                 conv_w=conv.to(pd),
                 x_proj=dense_init(gen, di, 1 + 2 * n, cfg.param_dtype),
                 a_log=a_log.to(pd),
                 d_skip=torch.ones(di, dtype=pd, device=dev),
                 out_proj=dense_init(gen, di, d, cfg.param_dtype))


def init_state(cfg, b: int, device, conv_dtype) -> dict:
    """Zero state: conv in `conv_dtype`, ssm in f32."""
    di = cfg.ssm_expand * cfg.d_model
    return {"conv": torch.zeros((b, cfg.ssm_conv - 1, di), dtype=conv_dtype,
                                device=device),
            "ssm": torch.zeros((b, di, cfg.ssm_state), dtype=torch.float32,
                               device=device)}


def _mamba_core(p: Mamba, cfg, xz, conv_state):
    """xz: [B, S, 2*di] after in_proj; returns (x_conv, z, new conv
    state): the causal depthwise conv of K taps over [conv state, x], then
    SiLU."""
    di = xz.shape[-1] // 2
    x, z = xz[..., :di], xz[..., di:]
    k = cfg.ssm_conv
    xp = torch.cat([conv_state, x], dim=1)                 # [B, K-1+S, di]
    w = p.w("conv_w", cfg.compute_dtype)
    n = xp.shape[1]
    xc = sum(xp[:, i:n - (k - 1 - i)] * w[i] for i in range(k))
    return F.silu(xc), z, xp[:, n - (k - 1):]


def mamba_forward(p: Mamba, cfg, x, state=None, chunk: int | None = None):
    """x: [B, S, D] -> (y [B, S, D], new state)."""
    b, s, d = x.shape
    chunk = cfg.scan_chunk if chunk is None else chunk
    n = cfg.ssm_state
    ct = cfg.compute_dtype
    if state is None:
        state = init_state(cfg, b, x.device, dtype_of(ct))
    gpu = exec_.resolve(None) == "gpu"
    if gpu:
        if cfg.ssm_scan_dtype != "float32":
            raise NotImplementedError(
                f"the selective_scan kernel runs in float32; ssm_scan_dtype "
                f"{cfg.ssm_scan_dtype!r} runs in exec mode 'torch' only")
        exec_.no_autograd("selective_scan", x, state["ssm"],
                          *p.parameters())
        exec_.gpu_tensors("mamba_forward", x)
    xz = x @ p.w("in_proj", ct)
    xc, z, new_conv = _mamba_core(p, cfg, xz, state["conv"])
    dbc = xc @ p.w("x_proj", ct)                                # [B,S,1+2n]
    dt = dbc[..., :1].float()
    dt = torch.logaddexp(dt, torch.zeros_like(dt))              # softplus
    bmat = dbc[..., 1:1 + n].float()
    cmat = dbc[..., 1 + n:].float()
    a = -torch.exp(p.a_log.float())                             # [di, n]
    if gpu:
        y, h_last = selective_scan(xc, dt[..., 0], bmat, cmat, a,
                                   state["ssm"])
    else:
        y, h_last = selective_scan_chunked(
            xc, dt[..., 0], bmat, cmat, a, state["ssm"], chunk,
            dtype_of(cfg.ssm_scan_dtype))
    y = y + xc.float() * p.d_skip.float()
    y = (y * F.silu(z.float())).to(dtype_of(ct))
    return y @ p.w("out_proj", ct), {"conv": new_conv, "ssm": h_last}


def mamba_decode(p: Mamba, cfg, x, state):
    """One token, x: [B, 1, D], from `state`: O(1) in the context length."""
    return mamba_forward(p, cfg, x, state)
