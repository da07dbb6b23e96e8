"""Recurrent sequence mixers (counterpart of `repro.models.ssm`): the
selective SSM (mamba-style) of hymba's hybrid block, and xLSTM's cells,
the mLSTM matrix memory and the sLSTM scalar memory.

State per layer:
  mamba: {"conv": [B, K-1, d_inner] (compute dtype),
          "ssm": [B, d_inner, d_state] f32}
  mlstm: {"conv": [B, K-1, d_inner] (compute dtype), "c": [B, H, dk, dv],
          "n": [B, H, dk], "m": [B, H]} (f32)
  slstm: {"c", "n", "h", "m"}: [B, d] f32
Prefill and decode run the same `mamba_forward`; a decode step is a
sequence of length 1 from the cached state. The mLSTM prefills chunkwise
(quadratic only inside a chunk, the chunks folded into the stabilised
(C, n, m) state that decode steps); the sLSTM is a true recurrence, a
loop over the sequence. No kernel runs in either: the reference's are
`lax.scan`s over plain ops.

The exec mode (`repro_torch.exec`) picks the scan: `gpu` (the default)
launches the `selective_scan` CUDA kernel on (x_conv, dt, B, C, A, h0),
in f32 or as the reference's bf16 scan (`ssm_scan_dtype`), and refuses
CPU tensors; under autograd it goes through the kernel's
`torch.autograd.Function`, whose backward is the `selective_scan_bwd`
kernel (f32 only: the bf16 scan refuses autograd). `torch` runs the
reference's chunked associative scan
(`kernels.selective_scan.ref.selective_scan_chunked`). The D skip, the
SiLU gate, the output projection and A = -exp(a_log) stay plain ops
around the scan in both, as they sit outside the reference's Pallas
kernel, so autograd takes dA on to a_log.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.selective_scan.ops import (BF16_BACKWARD_REFUSAL,
                                                    selective_scan)
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


def check_scan_kernel(cfg, training: bool = False) -> None:
    """The selective_scan kernels' refusals: a scan dtype they lack, and
    the bf16 scan under autograd (it has no backward)."""
    if cfg.ssm_scan_dtype not in ("float32", "bfloat16"):
        raise NotImplementedError(
            f"the selective_scan kernel runs in float32 or bfloat16; "
            f"ssm_scan_dtype {cfg.ssm_scan_dtype!r} runs in exec mode "
            f"'torch' only")
    if training and cfg.ssm_scan_dtype != "float32":
        raise NotImplementedError(BF16_BACKWARD_REFUSAL)


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
        check_scan_kernel(cfg)
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
                                   state["ssm"],
                                   dtype_of(cfg.ssm_scan_dtype), chunk)
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


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix memory)
# ---------------------------------------------------------------------------

class MLSTM(Weights):
    """up (x and gate z), conv_w (depthwise, K taps), wq, wk, wv, wif (the
    i and f gates a head), ln (a scale, not a norm), down."""
    MATMUL = ("up", "conv_w", "wq", "wk", "wv", "wif", "ln", "down")


def init_mlstm(gen: torch.Generator, cfg) -> MLSTM:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    pd = dtype_of(cfg.param_dtype)
    dev = gen.device
    conv = torch.randn((cfg.ssm_conv, di), generator=gen,
                       dtype=torch.float32, device=dev) * 0.1
    return MLSTM(up=dense_init(gen, d, 2 * di, cfg.param_dtype),
                 conv_w=conv.to(pd),
                 wq=dense_init(gen, di, di, cfg.param_dtype),
                 wk=dense_init(gen, di, di, cfg.param_dtype),
                 wv=dense_init(gen, di, di, cfg.param_dtype),
                 wif=dense_init(gen, di, 2 * cfg.n_heads, cfg.param_dtype),
                 ln=torch.ones(di, dtype=pd, device=dev),
                 down=dense_init(gen, di, d, cfg.param_dtype))


def mlstm_init_state(cfg, b: int, device) -> dict:
    """Zero state: conv in the compute dtype, (C, n, m) in f32; the
    stabiliser m starts at 0."""
    h = cfg.n_heads
    di = cfg.ssm_expand * cfg.d_model
    dh = di // h
    f32 = dict(dtype=torch.float32, device=device)
    return {"conv": torch.zeros((b, cfg.ssm_conv - 1, di),
                                dtype=dtype_of(cfg.compute_dtype),
                                device=device),
            "c": torch.zeros((b, h, dh, dh), **f32),
            "n": torch.zeros((b, h, dh), **f32),
            "m": torch.zeros((b, h), **f32)}


def _mlstm_in(p: MLSTM, cfg, x, conv_state):
    """x: [B, S, D] -> (xm, z, q, k, v, log_i, log_f, new conv state): v
    from the pre-conv xm, q, k and the gates from the conv'd xc; k scaled
    by 1/sqrt(dh); the gates in f32, [B, S, H]."""
    b, s, d = x.shape
    h = cfg.n_heads
    di = cfg.ssm_expand * d
    dh = di // h
    ct = cfg.compute_dtype
    xu = x @ p.w("up", ct)
    xm, z = xu[..., :di], xu[..., di:]
    k_ = cfg.ssm_conv
    xp = torch.cat([conv_state.to(xm.dtype), xm], dim=1)  # [B, K-1+S, di]
    w = p.w("conv_w", ct)
    n = xp.shape[1]
    xc = F.silu(sum(xp[:, i:n - (k_ - 1 - i)] * w[i] for i in range(k_)))
    q = (xc @ p.w("wq", ct)).reshape(b, s, h, dh)
    k = (xc @ p.w("wk", ct)).reshape(b, s, h, dh) / math.sqrt(dh)
    v = (xm @ p.w("wv", ct)).reshape(b, s, h, dh)
    gif = (xc @ p.w("wif", ct)).float()
    return (z, q, k, v, gif[..., :h], F.logsigmoid(gif[..., h:]),
            xp[:, n - (k_ - 1):])


def _mlstm_out(p: MLSTM, cfg, y, z):
    """y: [B, S, di] f32 -> (y * silu(z) * ln) @ down, in the compute
    dtype."""
    ct = cfg.compute_dtype
    y = y.to(dtype_of(ct)) * F.silu(z) * p.w("ln", ct)
    return y @ p.w("down", ct)


def _chunks(a: torch.Tensor, length: int, fill: float) -> torch.Tensor:
    """[B, S, ...] -> [B, NC, L, ...], the tail padded with `fill`."""
    b, s = a.shape[:2]
    pad = (-s) % length
    if pad:
        a = torch.cat([a, a.new_full((b, pad) + a.shape[2:], fill)], dim=1)
    return a.reshape((b, -1, length) + a.shape[2:])


def mlstm_forward(p: MLSTM, cfg, x, state=None, chunk: int | None = None):
    """Chunkwise-parallel mLSTM, x: [B, S, D] -> (y [B, S, D], new state).
    Inside a chunk of L steps the causal decay matrix is [B, L, L, H];
    between chunks the stabilised (C, n, m) carries, the state decode
    steps. The chunk maths runs in f32 whatever the compute dtype; the
    padded tail has log_i = -1e30 (it never writes) and log_f = 0 (it
    never decays). The chunk's write into C folds its decay into k and
    contracts the L steps as a batched matmul, so no [B, L, H, dk, dv]
    product is built."""
    b, s, d = x.shape
    chunk = cfg.scan_chunk if chunk is None else chunk
    if state is None:
        state = mlstm_init_state(cfg, b, x.device)
    z, q, k, v, log_i, log_f, new_conv = _mlstm_in(p, cfg, x,
                                                   state["conv"])
    L = min(chunk, s)
    qc = _chunks(q.float(), L, 0.0)
    kc = _chunks(k.float(), L, 0.0)
    vc = _chunks(v.float(), L, 0.0)
    lic = _chunks(log_i, L, -1e30)
    lfc = _chunks(log_f, L, 0.0)
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    causal = causal[None, :, :, None]                       # [1, t, s, 1]
    C, n, m = state["c"], state["n"], state["m"]
    ys = []
    for j in range(qc.shape[1]):
        qj, kj, vj, lij = qc[:, j], kc[:, j], vc[:, j], lic[:, j]
        cf = torch.cumsum(lfc[:, j], dim=1)                 # [B, L, H]
        # intra-chunk decay D_ts = cf_t - cf_s + li_s (causal)
        dm = cf[:, :, None, :] - cf[:, None, :, :] + lij[:, None, :, :]
        dm = dm.masked_fill(~causal, float("-inf"))
        b_t = cf + m[:, None, :]                            # carry's decay
        m_t = torch.maximum(dm.amax(dim=2), b_t)            # [B, L, H]
        scores = (torch.einsum("blhd,bshd->blsh", qj, kj)
                  * torch.exp(dm - m_t[:, :, None, :]))
        num = torch.einsum("blsh,bshd->blhd", scores, vj)
        den = scores.sum(dim=2)
        cfac = torch.exp(b_t - m_t)
        num = num + torch.einsum("blhd,bhde->blhe", qj, C) * cfac[..., None]
        den = den + torch.einsum("blhd,bhd->blh", qj, n) * cfac
        ys.append(num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None])
        # fold the chunk into the state
        cf_last = cf[:, -1]                                 # [B, H]
        dk_s = cf_last[:, None, :] - cf + lij               # [B, L, H]
        m_next = torch.maximum(cf_last + m, dk_s.amax(dim=1))
        sfac = torch.exp(dk_s - m_next[:, None, :])
        decay = torch.exp(cf_last + m - m_next)
        C = (C * decay[..., None, None]
             + torch.einsum("blhd,blhe->bhde", kj * sfac[..., None], vj))
        n = n * decay[..., None] + torch.einsum("blh,blhd->bhd", sfac, kj)
        m = m_next
    y = torch.cat(ys, dim=1)[:, :s].reshape(b, s, -1)
    new_state = {"conv": new_conv, "c": C, "n": n, "m": m}
    return _mlstm_out(p, cfg, y, z), new_state


def mlstm_decode(p: MLSTM, cfg, x, state):
    """One token, x: [B, 1, D]: the stabilised recurrent step
    C_t = f C_{t-1} + i k v^T, O(1) in the context length."""
    b = x.shape[0]
    z, q, k, v, log_i, log_f, new_conv = _mlstm_in(p, cfg, x,
                                                   state["conv"])
    q, k, v = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    log_i, log_f = log_i[:, 0], log_f[:, 0]                 # [B, H]
    m_new = torch.maximum(state["m"] + log_f, log_i)
    fdec = torch.exp(state["m"] + log_f - m_new)[..., None]
    iexp = torch.exp(log_i - m_new)[..., None]
    c = (state["c"] * fdec[..., None]
         + iexp[..., None] * k[..., :, None] * v[..., None, :])
    n = state["n"] * fdec + iexp * k
    num = torch.einsum("bhd,bhde->bhe", q, c)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", q, n).abs(),
                        torch.exp(-m_new))[..., None]
    y = (num / den).reshape(b, 1, -1)
    return _mlstm_out(p, cfg, y, z), {"conv": new_conv, "c": c, "n": n,
                                      "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, a true recurrence)
# ---------------------------------------------------------------------------

class SLSTM(Weights):
    """wx and wh (the z, i, f, o pre-activations from x and from h), b,
    out. wx, wh and b are read at f32 from the parameters whatever the
    compute dtype, as the reference reads them, so only `out` has a
    compute copy."""
    MATMUL = ("out",)


def init_slstm(gen: torch.Generator, cfg) -> SLSTM:
    d = cfg.d_model
    pd = dtype_of(cfg.param_dtype)
    return SLSTM(wx=dense_init(gen, d, 4 * d, cfg.param_dtype),
                 wh=dense_init(gen, d, 4 * d, cfg.param_dtype,
                               scale=0.5 / math.sqrt(d)),
                 b=torch.zeros(4 * d, dtype=pd, device=gen.device),
                 out=dense_init(gen, d, d, cfg.param_dtype))


def slstm_init_state(cfg, b: int, device) -> dict:
    z = dict(dtype=torch.float32, device=device)
    d = cfg.d_model
    return {name: torch.zeros((b, d), **z) for name in ("c", "n", "h", "m")}


def _slstm_step(p: SLSTM, carry, xw):
    """One step from the carry (c, n, h, m) and xw = x_t @ wx, f32."""
    c, n, hprev, m = carry
    pre = xw + hprev @ p.wh.float() + p.b.float()
    z, i, f, o = torch.chunk(pre, 4, dim=-1)
    z = torch.tanh(z)
    o = torch.sigmoid(o)
    log_f = F.logsigmoid(f)
    m_new = torch.maximum(log_f + m, i)
    ie = torch.exp(i - m_new)
    fe = torch.exp(log_f + m - m_new)
    c2 = fe * c + ie * z
    n2 = fe * n + ie
    h2 = o * c2 / torch.clamp(n2, min=1.0)
    return c2, n2, h2, m_new


def slstm_forward(p: SLSTM, cfg, x, state=None):
    """x: [B, S, D] -> (y [B, S, D], new state). x @ wx for every step is
    one f32 GEMM (the reference's per-step products in another summation
    order); the recurrence is a loop over the S steps."""
    if state is None:
        state = slstm_init_state(cfg, x.shape[0], x.device)
    xw = x.float() @ p.wx.float()                           # [B, S, 4D]
    carry = (state["c"], state["n"], state["h"], state["m"])
    hs = []
    for t in range(x.shape[1]):
        carry = _slstm_step(p, carry, xw[:, t])
        hs.append(carry[2])
    y = torch.stack(hs, dim=1).to(x.dtype)
    new_state = dict(zip(("c", "n", "h", "m"), carry))
    return y @ p.w("out", cfg.compute_dtype), new_state


def slstm_decode(p: SLSTM, cfg, x, state):
    """One token, x: [B, 1, D], from `state`."""
    return slstm_forward(p, cfg, x, state)
