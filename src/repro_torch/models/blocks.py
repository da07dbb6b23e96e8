"""Decoder blocks (counterpart of `repro.models.blocks`): the `dense` kind
and hymba's `hymba` kind (GQA attention and a mamba head side by side on
the same normed input, each output normed, averaged into the residual,
then the MLP). The reference's moe, mlstm and slstm kinds raise
`NotImplementedError` until their slices are ported.

Caches per layer: dense {"k", "v"}; hymba {"k", "v", "conv", "ssm"}."""
from __future__ import annotations

import torch

from repro_torch.models import attention as att
from repro_torch.models import ssm
from repro_torch.models.common import dtype_of, rms_norm
from repro_torch.models.mlp import init_mlp, mlp
from repro_torch.models.params import Weights


class Block(Weights):
    """ln1 -> attn -> ln2 -> ffn, the reference's dense block dict (hymba
    adds mamba, attn_ln and mamba_ln)."""


PORTED_KINDS = ("dense", "hymba")


def _check_kind(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP.md §1); the "
            f"port runs the {PORTED_KINDS} blocks")


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
    _check_kind(kind)
    if cfg.attn_type != "gqa":
        raise NotImplementedError(f"attn_type {cfg.attn_type!r} is not "
                                  f"ported yet (ROADMAP.md §1)")
    pd = dtype_of(cfg.param_dtype)
    ones = dict(dtype=pd, device=gen.device)
    p = dict(ln1=torch.ones(cfg.d_model, **ones),
             attn=att.init_gqa(gen, cfg),
             ln2=torch.ones(cfg.d_model, **ones),
             ffn=init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.param_dtype))
    if kind == "hymba":
        p.update(mamba=ssm.init_mamba(gen, cfg),
                 attn_ln=torch.ones(cfg.d_model, **ones),
                 mamba_ln=torch.ones(cfg.d_model, **ones))
    return Block(**p)


def _mix(p: Block, cfg, x, a, m):
    """hymba: x + (norm(attn) + norm(mamba)) / 2, then the MLP."""
    a = rms_norm(a, p.attn_ln, cfg.norm_eps)
    m = rms_norm(m, p.mamba_ln, cfg.norm_eps)
    x = x + 0.5 * (a + m)
    h2 = rms_norm(x, p.ln2, cfg.norm_eps)
    return x + mlp(p.ffn, h2, cfg.compute_dtype)


def block_forward(p: Block, cfg, kind, x, positions, window):
    """x: [B,S,D] -> (x', aux)."""
    _check_kind(kind)
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if kind == "hymba":
        a = att.gqa_forward(p.attn, cfg, h, positions, window)
        m, _ = ssm.mamba_forward(p.mamba, cfg, h)
        return _mix(p, cfg, x, a, m), 0.0
    x = x + att.gqa_forward(p.attn, cfg, h, positions, window)
    h2 = rms_norm(x, p.ln2, cfg.norm_eps)
    return x + mlp(p.ffn, h2, cfg.compute_dtype), 0.0


def block_prefill(p: Block, cfg, kind, x, positions, cache_len, window,
                  past=None):
    """Returns (x', cache, aux). `past`: roped prefix KV (prefix-cache
    reuse skips recomputing the shared pages; dense only)."""
    _check_kind(kind)
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if kind == "hymba":
        if past is not None:
            raise NotImplementedError("prefix reuse: GQA transformer "
                                      "families")
        a, kv = att.gqa_prefill(p.attn, cfg, h, positions, cache_len, window)
        st0 = ssm.init_state(cfg, x.shape[0], x.device, h.dtype)
        m, st = ssm.mamba_forward(p.mamba, cfg, h, st0)
        return _mix(p, cfg, x, a, m), {**kv, **st}, 0.0
    a, cache = att.gqa_prefill(p.attn, cfg, h, positions, cache_len, window,
                               past=past)
    x = x + a
    h2 = rms_norm(x, p.ln2, cfg.norm_eps)
    return x + mlp(p.ffn, h2, cfg.compute_dtype), cache, 0.0


def block_decode(p: Block, cfg, kind, x, pos, cache, window):
    """x: [B,1,D]; returns (x', cache')."""
    _check_kind(kind)
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if kind == "hymba":
        a, kv = att.gqa_decode(p.attn, cfg, h, pos,
                               {"k": cache["k"], "v": cache["v"]}, window)
        m, st = ssm.mamba_decode(p.mamba, cfg, h, {"conv": cache["conv"],
                                                   "ssm": cache["ssm"]})
        return _mix(p, cfg, x, a, m), {**kv, **st}
    a, cache = att.gqa_decode(p.attn, cfg, h, pos, cache, window)
    x = x + a
    h2 = rms_norm(x, p.ln2, cfg.norm_eps)
    return x + mlp(p.ffn, h2, cfg.compute_dtype), cache
