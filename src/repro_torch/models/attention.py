"""GQA attention with qk-norm / bias / sliding window (counterpart of the
GQA half of `repro.models.attention`; MLA waits for a later slice).

  gqa_forward  full-sequence causal
  gqa_prefill  forward + the KV cache (padded to cache_len, in
               `kv_cache_dtype`), optionally after a cached prefix `past`
  gqa_decode   one token against a contiguous KV cache

The serving engine's paged attention lives in `serving.paged_decode` and
`kernels.paged_attention`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import (NEG_INF, apply_rope, attend_causal,
                                       bf16_einsum, dense_init, dtype_of,
                                       rms_norm)
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
    kc = F.pad(k, (0, 0, 0, 0, 0, pad)).to(kt)
    vc = F.pad(v, (0, 0, 0, 0, 0, pad)).to(kt)
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
    kc = (cache["k"].to(bf) + oh * k.to(bf)).to(kt)
    vc = (cache["v"].to(bf) + oh * v.to(bf)).to(kt)

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
