"""Attention variants (counterpart of `repro.models.attention`): GQA with
qk-norm / bias / sliding window, and minicpm3's MLA (a latent-compressed
KV and a decoupled rope key shared by the heads).

  gqa_forward  full-sequence causal
  gqa_prefill  forward + the KV cache (padded to cache_len, in
               `kv_cache_dtype`, float8_e4m3fn cast as the reference casts:
               `common.to_cache`), optionally after a cached prefix `past`
  gqa_decode   one token against a contiguous KV cache
  mla_forward, mla_prefill, mla_decode   the same for MLA, whose cache is
               {"ckv": [B, S, kv_lora_rank], "kpe": [B, S, qk_rope_dim]}

The serving engine's paged attention lives in `serving.paged_decode` and
`kernels.paged_attention`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import (NEG_INF, apply_rope, attend_causal,
                                       bf16_einsum, causal_mask, dense_init,
                                       dtype_of, rms_norm, to_cache)
from repro_torch.models.params import Weights


class GQA(Weights):
    MATMUL = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")


def init_gqa(gen: torch.Generator, cfg) -> GQA:
    d, h, hkv, dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    pd = dtype_of(cfg.param_dtype)
    dev = gen.device
    p = dict(wq=dense_init(gen, d, h * dh, cfg.param_dtype),
             wk=dense_init(gen, d, hkv * dh, cfg.param_dtype),
             wv=dense_init(gen, d, hkv * dh, cfg.param_dtype),
             wo=dense_init(gen, h * dh, d, cfg.param_dtype))
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(h * dh, dtype=pd, device=dev)
        p["bk"] = torch.zeros(hkv * dh, dtype=pd, device=dev)
        p["bv"] = torch.zeros(hkv * dh, dtype=pd, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(dh, dtype=pd, device=dev)
        p["k_norm"] = torch.ones(dh, dtype=pd, device=dev)
    return GQA(**p)


def _qkv(p: GQA, cfg, x: torch.Tensor):
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    ct = cfg.compute_dtype
    q = x @ p.w("wq", ct)
    k = x @ p.w("wk", ct)
    v = x @ p.w("wv", ct)
    if cfg.qkv_bias:
        q = q + p.w("bq", ct)
        k = k + p.w("bk", ct)
        v = v + p.w("bv", ct)
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, hkv, dh)
    v = v.reshape(b, s, hkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    return q, k, v


def gqa_forward(p: GQA, cfg, x, positions, window: int = 0):
    """x: [B, S, D], positions: [B, S] int. Returns [B, S, D]."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attend_causal(q, k, v, window, cfg.compute_dtype,
                      block_q=cfg.attn_block_q, impl=cfg.attn_impl)
    return o.reshape(b, s, -1) @ p.w("wo", cfg.compute_dtype)


def gqa_prefill(p: GQA, cfg, x, positions, cache_len: int, window: int = 0,
                past=None):
    """Forward + the KV cache padded to cache_len, in `kv_cache_dtype`.

    `past`: {"k","v"} [B, S_past, Hkv, Dh] already-roped prefix KV (prefix
    cache reuse): the suffix attends over past+new with the right offset."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    off = 0
    if past is not None:
        off = past["k"].shape[1]
        k = torch.cat([past["k"].to(k.dtype), k], dim=1)
        v = torch.cat([past["v"].to(v.dtype), v], dim=1)
    o = attend_causal(q, k, v, window, cfg.compute_dtype,
                      block_q=cfg.attn_block_q, impl=cfg.attn_impl,
                      q_offset=off)
    y = o.reshape(b, s, -1) @ p.w("wo", cfg.compute_dtype)
    pad = cache_len - s - off
    kt = dtype_of(cfg.kv_cache_dtype)
    kc = to_cache(F.pad(k, (0, 0, 0, 0, 0, pad)), kt)
    vc = to_cache(F.pad(v, (0, 0, 0, 0, 0, pad)), kt)
    return y, {"k": kc, "v": vc}


def gqa_decode(p: GQA, cfg, x, pos, cache, window: int = 0):
    """x: [B, 1, D]; pos: [B] int (write position); contiguous cache
    {"k","v"} [B, S_max, Hkv, Dh]. The new token's K/V enter the cache as
    the reference's bf16 one-hot sum, then attention over positions
    <= pos."""
    b = x.shape[0]
    hkv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = _qkv(p, cfg, x)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)

    s_max = cache["k"].shape[1]
    kt = cache["k"].dtype
    bf = torch.bfloat16
    oh = F.one_hot(pos.long(), s_max).to(bf)[:, :, None, None]
    kc = to_cache(cache["k"].to(bf) + oh * k.to(bf), kt)
    vc = to_cache(cache["v"].to(bf) + oh * v.to(bf), kt)

    ki = torch.arange(s_max, device=x.device)[None, :]
    ok = (ki <= pos[:, None]) & ((window <= 0) | (ki > pos[:, None] - window))
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    mask = torch.where(ok, zero, NEG_INF)                          # [B, S]

    h = cfg.n_heads
    g = h // hkv
    qg = q.reshape(b, hkv, g, dh)
    scores = bf16_einsum("bkgd,bskd->bkgs", qg, kc)
    scores = scores / math.sqrt(dh) + mask[:, None, None, :]
    w = torch.softmax(scores, dim=-1)
    o = bf16_einsum("bkgs,bskd->bkgd", w, vc)
    o = o.reshape(b, 1, h * dh).to(x.dtype)
    y = o @ p.w("wo", cfg.compute_dtype)
    return y, {"k": kc, "v": vc}


# ---------------------------------------------------------------------------
# MLA (minicpm3): latent-compressed KV, decoupled rope key
# ---------------------------------------------------------------------------

class MLA(Weights):
    """wdq, q_ln, wuq (q's low-rank down, norm and up projections), wdkv,
    kv_ln (the latent's down projection and norm), wuk, wuv (the latent's
    expansion to the heads' nope keys and values), wkr (the rope key),
    wo."""
    MATMUL = ("wdq", "wuq", "wdkv", "wuk", "wuv", "wkr", "wo")


def init_mla(gen: torch.Generator, cfg) -> MLA:
    d, h = cfg.d_model, cfg.n_heads
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim
    pd = dtype_of(cfg.param_dtype)
    dev = gen.device
    return MLA(
        wdq=dense_init(gen, d, cfg.q_lora_rank, cfg.param_dtype),
        q_ln=torch.ones(cfg.q_lora_rank, dtype=pd, device=dev),
        wuq=dense_init(gen, cfg.q_lora_rank, h * qd, cfg.param_dtype),
        wdkv=dense_init(gen, d, cfg.kv_lora_rank, cfg.param_dtype),
        kv_ln=torch.ones(cfg.kv_lora_rank, dtype=pd, device=dev),
        wuk=dense_init(gen, cfg.kv_lora_rank, h * cfg.qk_nope_dim,
                       cfg.param_dtype),
        wuv=dense_init(gen, cfg.kv_lora_rank, h * cfg.v_head_dim,
                       cfg.param_dtype),
        wkr=dense_init(gen, d, cfg.qk_rope_dim, cfg.param_dtype),
        wo=dense_init(gen, h * cfg.v_head_dim, d, cfg.param_dtype))


def _mla_qckv(p: MLA, cfg, x, positions):
    """x: [B, S, D] -> (q_nope [B,S,H,nope], q_pe [B,S,H,rope] roped, ckv
    [B,S,r] normed, kpe [B,S,rope] roped once for all heads)."""
    b, s, _ = x.shape
    nope = cfg.qk_nope_dim
    ct = cfg.compute_dtype
    cq = rms_norm(x @ p.w("wdq", ct), p.q_ln, cfg.norm_eps)
    q = (cq @ p.w("wuq", ct)).reshape(b, s, cfg.n_heads, -1)
    q_pe = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    ckv = rms_norm(x @ p.w("wdkv", ct), p.kv_ln, cfg.norm_eps)
    kpe = apply_rope((x @ p.w("wkr", ct))[:, :, None, :], positions,
                     cfg.rope_theta)[:, :, 0, :]
    return q[..., :nope], q_pe, ckv, kpe


def _mla_expand(p: MLA, cfg, ckv):
    """The latent [B, Sk, r] -> the heads' nope keys and values."""
    b = ckv.shape[0]
    ct = cfg.compute_dtype
    ckv = ckv.to(dtype_of(ct))
    k_nope = (ckv @ p.w("wuk", ct)).reshape(b, -1, cfg.n_heads,
                                            cfg.qk_nope_dim)
    v = (ckv @ p.w("wuv", ct)).reshape(b, -1, cfg.n_heads, cfg.v_head_dim)
    return k_nope, v


def _mla_attend(p: MLA, cfg, q_nope, q_pe, k_nope, v, kpe, mask):
    """q_*: [B,Sq,H,*]; k_nope, v: [B,Sk,H,*]; kpe: [B,Sk,rope]; mask
    broadcasts to the scores [B,Sq,H,Sk]. bf16 operands, f32 scores and
    softmax. Returns [B, Sq, D]."""
    b, sq = q_nope.shape[:2]
    ct = cfg.compute_dtype
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    scores = (bf16_einsum("bqhd,bshd->bqhs", q_nope, k_nope)
              + bf16_einsum("bqhd,bsd->bqhs", q_pe, kpe)) * scale + mask
    w = torch.softmax(scores, dim=-1)
    o = bf16_einsum("bqhs,bshd->bqhd", w, v)
    return o.reshape(b, sq, -1).to(dtype_of(ct)) @ p.w("wo", ct)


MLA_BLOCK_Q = 512


def _mla_attend_causal(p: MLA, cfg, q_nope, q_pe, ckv, kpe, window):
    """Causal MLA over query chunks of min(512, attn_block_q) rows (one
    chunk when S <= attn_block_q): the scores never exceed [B, bq, H, Sk].
    The reference requires S to be a multiple of the chunk; here the last
    chunk may be shorter. The latent is expanded to the heads once per
    call, not once per chunk: the same inputs, so the same values."""
    s = q_nope.shape[1]
    k_nope, v = _mla_expand(p, cfg, ckv)
    bq = s if s <= cfg.attn_block_q else min(MLA_BLOCK_Q, cfg.attn_block_q)
    outs = []
    for lo in range(0, s, bq):
        hi = min(lo + bq, s)
        mask = causal_mask(hi - lo, s, q_offset=lo, window=window,
                           device=q_nope.device)[None, :, None, :]
        outs.append(_mla_attend(p, cfg, q_nope[:, lo:hi], q_pe[:, lo:hi],
                                k_nope, v, kpe, mask))
    return torch.cat(outs, dim=1)


def mla_forward(p: MLA, cfg, x, positions, window: int = 0):
    """x: [B, S, D], positions: [B, S] int. Returns [B, S, D]."""
    q_nope, q_pe, ckv, kpe = _mla_qckv(p, cfg, x, positions)
    return _mla_attend_causal(p, cfg, q_nope, q_pe, ckv, kpe, window)


def mla_prefill(p: MLA, cfg, x, positions, cache_len: int, window: int = 0):
    """Forward + the latent cache {"ckv", "kpe"} zero-padded to cache_len,
    in `kv_cache_dtype`."""
    s = x.shape[1]
    q_nope, q_pe, ckv, kpe = _mla_qckv(p, cfg, x, positions)
    y = _mla_attend_causal(p, cfg, q_nope, q_pe, ckv, kpe, window)
    kt = dtype_of(cfg.kv_cache_dtype)
    pad = cache_len - s
    return y, {"ckv": to_cache(F.pad(ckv, (0, 0, 0, pad)), kt),
               "kpe": to_cache(F.pad(kpe, (0, 0, 0, pad)), kt)}


def mla_decode(p: MLA, cfg, x, pos, cache, window: int = 0):
    """x: [B, 1, D]; pos: [B] int (write position). The new token's latent
    and rope key enter the cache as the reference's bf16 one-hot sum
    (equal to a write, as the slot holds zero), and the whole cache is
    re-expanded to the heads: the cache holds r + rope values a token."""
    q_nope, q_pe, ckv_new, kpe_new = _mla_qckv(p, cfg, x, pos[:, None])
    s_max = cache["ckv"].shape[1]
    kt = cache["ckv"].dtype
    bf = torch.bfloat16
    oh = F.one_hot(pos.long(), s_max).to(bf)[:, :, None]
    ckv = to_cache(cache["ckv"].to(bf) + oh * ckv_new.to(bf), kt)
    kpe = to_cache(cache["kpe"].to(bf) + oh * kpe_new.to(bf), kt)
    ki = torch.arange(s_max, device=x.device)[None, :]
    ok = (ki <= pos[:, None]) & ((window <= 0) | (ki > pos[:, None] - window))
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    mask = torch.where(ok, zero, NEG_INF)[:, None, None, :]
    k_nope, v = _mla_expand(p, cfg, ckv)
    y = _mla_attend(p, cfg, q_nope, q_pe, k_nope, v, kpe, mask)
    return y, {"ckv": ckv, "kpe": kpe}
