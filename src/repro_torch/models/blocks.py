"""Decoder blocks (counterpart of `repro.models.blocks`), the `dense` kind
only: the reference's moe, mlstm, slstm and hymba kinds raise
`NotImplementedError` until their slices are ported."""
from __future__ import annotations

import torch

from repro_torch.models import attention as att
from repro_torch.models.common import dtype_of, rms_norm
from repro_torch.models.mlp import init_mlp, mlp
from repro_torch.models.params import Weights


class Block(Weights):
    """ln1 -> attn -> ln2 -> ffn, the reference's dense block dict."""


def _dense_only(kind: str) -> None:
    if kind != "dense":
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP.md §1); the "
            f"port runs the 'dense' GQA transformer block")


def block_kinds(cfg) -> list[str]:
    """The per-period list of block kinds for this config."""
    if cfg.block_pattern == "xlstm":
        p = cfg.slstm_every or 8
        return ["mlstm"] * (p - 1) + ["slstm"]
    if cfg.block_pattern == "hybrid":
        return ["hymba"]
    if cfg.is_moe:
        return ["moe"]
    return ["dense"]


def layer_windows(cfg) -> list[int]:
    """Per-layer sliding-window sizes (0 = global). With a window, layer 0,
    the middle layer and the last layer stay global (hymba)."""
    n = cfg.n_layers
    if cfg.sliding_window <= 0:
        return [0] * n
    w = [cfg.sliding_window] * n
    for g in (0, n // 2, n - 1):
        w[g] = 0
    return w


def init_block(gen: torch.Generator, cfg, kind: str) -> Block:
    _dense_only(kind)
    if cfg.attn_type != "gqa":
        raise NotImplementedError(f"attn_type {cfg.attn_type!r} is not "
                                  f"ported yet (ROADMAP.md §1)")
    pd = dtype_of(cfg.param_dtype)
    ones = dict(dtype=pd, device=gen.device)
    return Block(ln1=torch.ones(cfg.d_model, **ones),
                 attn=att.init_gqa(gen, cfg),
                 ln2=torch.ones(cfg.d_model, **ones),
                 ffn=init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.param_dtype))


def block_forward(p: Block, cfg, kind, x, positions, window):
    """x: [B,S,D] -> (x', aux)."""
    _dense_only(kind)
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    x = x + att.gqa_forward(p.attn, cfg, h, positions, window)
    h2 = rms_norm(x, p.ln2, cfg.norm_eps)
    return x + mlp(p.ffn, h2, cfg.compute_dtype), 0.0


def block_prefill(p: Block, cfg, kind, x, positions, cache_len, window,
                  past=None):
    """Returns (x', cache, aux). `past`: roped prefix KV (prefix-cache
    reuse skips recomputing the shared pages)."""
    _dense_only(kind)
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    a, cache = att.gqa_prefill(p.attn, cfg, h, positions, cache_len, window,
                               past=past)
    x = x + a
    h2 = rms_norm(x, p.ln2, cfg.norm_eps)
    return x + mlp(p.ffn, h2, cfg.compute_dtype), cache, 0.0


def block_decode(p: Block, cfg, kind, x, pos, cache, window):
    """x: [B,1,D]; returns (x', cache')."""
    _dense_only(kind)
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    a, cache = att.gqa_decode(p.attn, cfg, h, pos, cache, window)
    x = x + a
    h2 = rms_norm(x, p.ln2, cfg.norm_eps)
    return x + mlp(p.ffn, h2, cfg.compute_dtype), cache
