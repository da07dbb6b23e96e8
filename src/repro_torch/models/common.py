"""Shared model components: norms, rotary embeddings, init, dtype policy
(counterpart of `repro.models.common`).

The reference feeds its attention einsums bf16 operands with f32
accumulation (`preferred_element_type`) whatever the compute dtype is.
PyTorch has no matmul with a wider output than its inputs, so
`bf16_einsum` rounds the operands to bf16 and multiplies them in f32:
a product of two bf16 values is exact in f32, so only the order of the
f32 sums differs from the reference. On the card this relies on full f32
matmuls (`torch.backends.cuda.matmul.allow_tf32 = False`, PyTorch's
default, which `chip_smoke.py` sets explicitly).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_fused
from repro_torch.kernels.flash_attention.ref import attend_flash_ref
from repro_torch import exec as exec_

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float8_e4m3fn": torch.float8_e4m3fn}
NEG_INF = float("-inf")
# ml_dtypes (the reference's float8_e4m3fn) rounds |x| > 464 and +-inf to
# a NaN of x's sign (464 itself to 448); torch saturates them to +-448
FP8_NAN_ABOVE = 464.0


def dtype_of(name: str) -> torch.dtype:
    try:
        return DTYPES[name]
    except KeyError:
        raise KeyError(f"dtype {name!r} not supported; one of "
                       f"{sorted(DTYPES)}") from None


def to_cache(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`x` in a KV cache's dtype (`kv_cache_dtype`), cast as the reference
    casts: to float8_e4m3fn with NaN where |x| > FP8_NAN_ABOVE or x is
    infinite, where torch alone would saturate."""
    if dtype != torch.float8_e4m3fn:
        return x.to(dtype)
    # in x's own dtype (bf16 or f32: 464 and the compare are exact in both)
    nan = torch.copysign(torch.full_like(x, torch.nan), x)     # signed
    return torch.where(x.abs() > FP8_NAN_ABOVE, nan, x).to(dtype)


def cast(x: torch.Tensor, dtype_str: str) -> torch.Tensor:
    return x.to(dtype_of(dtype_str))


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype="float32",
               scale: float | None = None) -> torch.Tensor:
    """N(0, 1) / sqrt(d_in) (or * `scale`), drawn in f32 from `gen` on its
    device."""
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * s).to(dtype_of(dtype))


def embed_init(gen: torch.Generator, n: int, d: int,
               dtype="float32") -> torch.Tensor:
    """N(0, 1) * 0.02, drawn in f32 from `gen` on its device."""
    w = torch.randn((n, d), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * 0.02).to(dtype_of(dtype))


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight.float()).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: [..., S, H, Dh] with positions [..., S]; half-dim rotation."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                 # [dh/2]
    ang = positions[..., None].float() * freqs              # [..., S, dh/2]
    cos = torch.cos(ang)[..., None, :]                      # over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def causal_mask(s_q: int, s_k: int, q_offset: int = 0, window: int = 0,
                device=None) -> torch.Tensor:
    """[s_q, s_k] additive f32 mask; window > 0 = sliding-window."""
    qi = torch.arange(s_q, device=device)[:, None] + q_offset
    ki = torch.arange(s_k, device=device)[None, :]
    ok = (ki <= qi) & ((window <= 0) | (ki > qi - window))
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ok, zero, NEG_INF)


def bf16_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum of bf16-rounded operands with f32 accumulation."""
    return torch.einsum(eq, a.to(torch.bfloat16).float(),
                        b.to(torch.bfloat16).float())


ATTEND_BLOCK_Q = 512


def attend_causal(q, k, v, window: int = 0, compute_dtype="bfloat16",
                  block_q: int = ATTEND_BLOCK_Q, impl: str = "xla",
                  q_offset: int = 0):
    """Causal (optionally windowed) attention, q: [B,Sq,H,Dh]; k/v:
    [B,Sk,Hkv,Dh] -> [B,Sq,H,Dh].

    impl="xla": chunked over query blocks of `block_q` rows, the scores of
    a chunk materialize as [B, block_q, Hkv, G, Sk]. The reference requires
    Sq to be a multiple of `block_q` above it; here the last chunk may be
    shorter (a row's arithmetic does not depend on its chunk), so prompts
    of any length prefill.

    impl="xla_flash": the online-softmax flash algorithm, no [.., Sk]-wide
    score tensor. The exec mode (`repro_torch.exec`) picks its form: `gpu`
    (the default) launches the `flash_attention` CUDA kernel (64-key
    tiles, tensor cores), which is forward-only: it refuses inputs that
    autograd tracks, and CPU tensors; `torch` runs the plain mirror
    of the reference's `_attend_flash_xla` over `block_q`-square tiles
    (`kernels.flash_attention.ref.attend_flash_ref`). Both round q, k, p
    and v to bf16 and sum in f32 as the reference does; p is rounded after
    its tile's running max, so the two agree to bf16 level. Like "xla",
    the last q or kv tile may be shorter than the reference allows."""
    if impl == "xla_flash":
        if exec_.resolve(None) == "gpu":
            exec_.no_autograd("flash_attention", q, k, v)
            exec_.gpu_tensors("attend_causal", q)
            return flash_attention_fused(
                q.contiguous(), k.contiguous(), v.contiguous(),
                q_offset=q_offset, window=window,
                out_dtype=dtype_of(compute_dtype))
        return attend_flash_ref(q, k, v, window, dtype_of(compute_dtype),
                                block_q, q_offset)
    if impl != "xla":
        raise ValueError(f"attend_causal impl {impl!r}: 'xla' or "
                         f"'xla_flash'")
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    if sq <= block_q:
        return softmax_attend(q, k, v,
                              causal_mask(sq, sk, q_offset=q_offset,
                                          window=window, device=q.device),
                              compute_dtype)
    ki_idx = torch.arange(sk, device=q.device)[None, :]
    outs = []
    for lo in range(0, sq, block_q):
        qi = q[:, lo:lo + block_q]
        bq = qi.shape[1]
        qg = qi.reshape(b, bq, hkv, g, dh)
        s = bf16_einsum("bqkgd,bskd->bqkgs", qg, k)
        s = s / math.sqrt(dh)
        qi_idx = q_offset + lo + torch.arange(bq, device=q.device)[:, None]
        ok = (ki_idx <= qi_idx) & ((window <= 0) | (ki_idx > qi_idx - window))
        s = torch.where(ok[None, :, None, None, :], s, NEG_INF)
        w = torch.softmax(s, dim=-1)
        o = bf16_einsum("bqkgs,bskd->bqkgd", w, v)
        outs.append(o.reshape(b, bq, h, dh).to(dtype_of(compute_dtype)))
    return torch.cat(outs, dim=1)


def softmax_attend(q, k, v, mask, compute_dtype="bfloat16"):
    """q:[B,Sq,H,Dh] k/v:[B,Sk,Hkv,Dh] -> [B,Sq,H,Dh]; GQA broadcast of kv,
    bf16 operands, f32 scores and softmax."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, dh)
    scores = bf16_einsum("bqkgd,bskd->bqkgs", qg, k)
    scores = scores / math.sqrt(dh)
    scores = scores + mask[None, :, None, None, :]
    w = torch.softmax(scores, dim=-1)
    out = bf16_einsum("bqkgs,bskd->bqkgd", w, v)
    return out.reshape(b, sq, h, dh).to(dtype_of(compute_dtype))
