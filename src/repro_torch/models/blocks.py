"""Decoder blocks (counterpart of `repro.models.blocks`): the `dense` kind
(attention, GQA or MLA by `attn_type`, then the MLP), the `moe` kind (the
dense block with a mixture-of-experts FFN), hymba's `hymba` kind (GQA
attention and a mamba head side by side on the same normed input, each
output normed, averaged into the residual, then the MLP) and xLSTM's
`mlstm` (the mLSTM cell on the residual) and `slstm` (the sLSTM cell, then
an MLP max(d_ff, 4 d / 3) wide) kinds. An arch's layers repeat a period of
kinds (`block_kinds`: xLSTM's seven mlstm and one slstm).

The MoE FFN dispatches by the mesh context (`parallel.sharding`): with no
mesh open, or `moe_impl="dense"`, the one-shard dense dispatch; under
`use_mesh`, the expert-parallel dispatch `cfg.moe_impl` names. Either way
the shared expert is added exactly once. The reference adds it twice on
one device under an expert-parallel `moe_impl` (its `_ffn_apply` adds it
to the dense fallback's output, which holds it already), and once on
every other path: the port follows those (ROADMAP.md §3).

Caches per layer (`block_init_cache`): dense and moe {"k", "v"}, or
{"ckv", "kpe"} under MLA; hymba {"k", "v", "conv", "ssm"}; mlstm
{"conv", "c", "n", "m"}; slstm {"c", "n", "h", "m"}."""
from __future__ import annotations

import math

import torch

from repro_torch.models import attention as att
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.common import dtype_of, rms_norm
from repro_torch.models.mlp import init_mlp, mlp
from repro_torch.models.params import Weights
from repro_torch.parallel.sharding import current_mesh, mesh_cfg


class Block(Weights):
    """ln1 -> attn -> ln2 -> ffn, the reference's dense block dict (the
    moe kind's ffn is a `moe.MoE`; hymba adds mamba, attn_ln and
    mamba_ln); ln1 -> cell for mlstm, and ln1 -> cell -> ln2 -> ffn for
    slstm."""


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
    d = cfg.d_model
    pd = dtype_of(cfg.param_dtype)
    ones = dict(dtype=pd, device=gen.device)
    p = dict(ln1=torch.ones(d, **ones))
    if kind in ("dense", "moe", "hymba"):
        p.update(attn=(att.init_mla(gen, cfg) if cfg.attn_type == "mla"
                       else att.init_gqa(gen, cfg)),
                 ln2=torch.ones(d, **ones),
                 ffn=(moe_mod.init_moe(gen, cfg) if kind == "moe" else
                      init_mlp(gen, d, cfg.d_ff, cfg.param_dtype)))
        if kind == "hymba":
            p.update(mamba=ssm.init_mamba(gen, cfg),
                     attn_ln=torch.ones(d, **ones),
                     mamba_ln=torch.ones(d, **ones))
    elif kind == "mlstm":
        p["cell"] = ssm.init_mlstm(gen, cfg)
    elif kind == "slstm":
        p.update(cell=ssm.init_slstm(gen, cfg), ln2=torch.ones(d, **ones),
                 ffn=init_mlp(gen, d, max(cfg.d_ff, 4 * d // 3),
                              cfg.param_dtype))
    else:
        raise ValueError(f"block kind {kind!r}")
    return Block(**p)


def block_init_cache(cfg, kind: str, batch: int, cache_len: int,
                     device="cuda") -> dict:
    """A layer's empty cache (zeros) for `batch` sequences of up to
    `cache_len` tokens: the shapes and dtypes `block_prefill` returns."""
    kt = dict(dtype=dtype_of(cfg.kv_cache_dtype), device=device)
    if kind in ("dense", "moe", "hymba"):
        if cfg.attn_type == "mla" and kind != "hymba":
            return {"ckv": torch.zeros((batch, cache_len, cfg.kv_lora_rank),
                                       **kt),
                    "kpe": torch.zeros((batch, cache_len, cfg.qk_rope_dim),
                                       **kt)}
        shape = (batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        kv = {"k": torch.zeros(shape, **kt), "v": torch.zeros(shape, **kt)}
        if kind == "hymba":
            kv.update(ssm.init_state(cfg, batch, device,
                                     dtype_of(cfg.compute_dtype)))
        return kv
    if kind == "mlstm":
        return ssm.mlstm_init_state(cfg, batch, device)
    if kind == "slstm":
        return ssm.slstm_init_state(cfg, batch, device)
    raise ValueError(f"block kind {kind!r}")


def _ffn_apply(p, cfg, x):
    """MLP or MoE on [B, S, D]; returns (y, aux)."""
    if not isinstance(p, moe_mod.MoE):
        return mlp(p, x, cfg.compute_dtype), 0.0
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    if cfg.moe_impl == "dense" or current_mesh() is None:
        y2, aux = moe_mod.moe_dense_ffn(p, cfg, x2)
    else:
        y2, aux = _moe_sharded(p, cfg, x2, cfg.moe_impl)
        if cfg.n_shared_experts:
            y2 = y2 + mlp(p.shared, x2, cfg.compute_dtype)
    return y2.reshape(b, s, d).to(x.dtype), aux


def _moe_sharded(p, cfg, x2d, impl: str):
    """The expert-parallel dispatch `impl` over the open mesh's model axis
    (the reference's manual region over the data axes and the model axis),
    the shared expert not added; with no mesh open, the dense dispatch
    (the shared expert added). Tokens split over the data axes
    ("replicated_psum") or over the data axes and then the model axis
    ("routed_a2a"), row-major, as the reference's token specs split them.
    Under "routed_a2a" a token count that does not divide over the
    shards (a decode batch smaller than the mesh, which the reference's
    token spec refuses) is padded with zero rows that route nowhere and
    leave aux out. aux is the mean of the losses of the shards that hold
    a live token (every shard where the count divides). Returns (y2d,
    aux)."""
    mesh = current_mesh()
    if mesh is None:
        return moe_mod.moe_dense_ffn(p, cfg, x2d)
    mc = mesh_cfg()
    tp = mesh.shape[mc["tp_axis"]]
    dp = math.prod(mesh.shape[a] for a in mc["dp_axes"])
    t, d = x2d.shape
    if cfg.n_experts % tp:
        raise ValueError(f"{cfg.n_experts} experts over a model axis of {tp}")
    if impl == "routed_a2a":
        pad = -t % (dp * tp)
        if not pad:
            y, aux = moe_mod.moe_routed_a2a(
                p, cfg, x2d.reshape(dp, tp, t // (dp * tp), d))
            return y.reshape(t, d), aux.mean()
        per = (t + pad) // (dp * tp)
        xp = torch.cat([x2d, x2d.new_zeros(pad, d)])
        y, aux = moe_mod.moe_routed_a2a(p, cfg, xp.reshape(dp, tp, per, d),
                                        n_valid=t)
        return y.reshape(t + pad, d)[:t], aux.sum() / -(-t // per)
    if impl != "replicated_psum":
        raise ValueError(f"moe_impl {impl!r}: 'dense', 'replicated_psum' or "
                         f"'routed_a2a'")
    if t % dp:
        raise ValueError(f"{t} tokens over {dp} data shards")
    x = x2d.reshape(dp, 1, t // dp, d).expand(dp, tp, t // dp, d)
    y, aux = moe_mod.moe_replicated_psum(p, cfg, x)
    return y[:, 0].reshape(t, d), aux.mean()


def _mix(p: Block, cfg, x, a, m):
    """hymba: x + (norm(attn) + norm(mamba)) / 2, then the MLP."""
    a = rms_norm(a, p.attn_ln, cfg.norm_eps)
    m = rms_norm(m, p.mamba_ln, cfg.norm_eps)
    x = x + 0.5 * (a + m)
    h2 = rms_norm(x, p.ln2, cfg.norm_eps)
    return x + mlp(p.ffn, h2, cfg.compute_dtype)


def _ffn_residual(p: Block, cfg, x):
    """x + ffn(norm(x)) and the FFN's aux."""
    f, aux = _ffn_apply(p.ffn, cfg, rms_norm(x, p.ln2, cfg.norm_eps))
    return x + f, aux


def block_forward(p: Block, cfg, kind, x, positions, window):
    """x: [B,S,D] -> (x', aux)."""
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if kind == "hymba":
        a = att.gqa_forward(p.attn, cfg, h, positions, window)
        m, _ = ssm.mamba_forward(p.mamba, cfg, h)
        return _mix(p, cfg, x, a, m), 0.0
    if kind == "mlstm":
        return x + ssm.mlstm_forward(p.cell, cfg, h)[0], 0.0
    if kind == "slstm":
        return _ffn_residual(p, cfg, x + ssm.slstm_forward(p.cell, cfg, h)[0])
    if cfg.attn_type == "mla":
        a = att.mla_forward(p.attn, cfg, h, positions, window)
    else:
        a = att.gqa_forward(p.attn, cfg, h, positions, window)
    return _ffn_residual(p, cfg, x + a)


def block_prefill(p: Block, cfg, kind, x, positions, cache_len, window,
                  past=None):
    """Returns (x', cache, aux). `past`: roped prefix KV (prefix-cache
    reuse skips recomputing the shared pages; dense and moe under GQA)."""
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if past is not None and (kind not in ("dense", "moe")
                             or cfg.attn_type != "gqa"):
        # the reference ignores `past` under MLA; refuse rather than
        # return a cache without the prefix
        raise NotImplementedError("prefix reuse: GQA transformer families")
    b = x.shape[0]
    if kind == "hymba":
        a, kv = att.gqa_prefill(p.attn, cfg, h, positions, cache_len, window)
        st0 = ssm.init_state(cfg, b, x.device, h.dtype)
        m, st = ssm.mamba_forward(p.mamba, cfg, h, st0)
        return _mix(p, cfg, x, a, m), {**kv, **st}, 0.0
    if kind == "mlstm":
        y, st = ssm.mlstm_forward(p.cell, cfg, h,
                                  ssm.mlstm_init_state(cfg, b, x.device))
        return x + y, st, 0.0
    if kind == "slstm":
        y, st = ssm.slstm_forward(p.cell, cfg, h,
                                  ssm.slstm_init_state(cfg, b, x.device))
        x, aux = _ffn_residual(p, cfg, x + y)
        return x, st, aux
    if cfg.attn_type == "mla":
        a, cache = att.mla_prefill(p.attn, cfg, h, positions, cache_len,
                                   window)
    else:
        a, cache = att.gqa_prefill(p.attn, cfg, h, positions, cache_len,
                                   window, past=past)
    x, aux = _ffn_residual(p, cfg, x + a)
    return x, cache, aux


def block_decode(p: Block, cfg, kind, x, pos, cache, window):
    """x: [B,1,D]; returns (x', cache', aux). The moe kind runs the dense
    dispatch over the B tokens whatever the mesh, as the reference's
    decode does."""
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if kind == "hymba":
        a, kv = att.gqa_decode(p.attn, cfg, h, pos,
                               {"k": cache["k"], "v": cache["v"]}, window)
        m, st = ssm.mamba_decode(p.mamba, cfg, h, {"conv": cache["conv"],
                                                   "ssm": cache["ssm"]})
        return _mix(p, cfg, x, a, m), {**kv, **st}, 0.0
    if kind == "mlstm":
        y, st = ssm.mlstm_decode(p.cell, cfg, h, cache)
        return x + y, st, 0.0
    if kind == "slstm":
        y, st = ssm.slstm_decode(p.cell, cfg, h, cache)
        x, aux = _ffn_residual(p, cfg, x + y)
        return x, st, aux
    if cfg.attn_type == "mla":
        a, cache = att.mla_decode(p.attn, cfg, h, pos, cache, window)
    else:
        a, cache = att.gqa_decode(p.attn, cfg, h, pos, cache, window)
    x = x + a
    h2 = rms_norm(x, p.ln2, cfg.norm_eps)
    if kind == "moe":
        b, _, d = h2.shape
        f, aux = moe_mod.moe_dense_ffn(p.ffn, cfg, h2.reshape(b, d))
        return x + f.reshape(b, 1, d).to(x.dtype), cache, aux
    return x + mlp(p.ffn, h2, cfg.compute_dtype), cache, 0.0
