"""Decode step reading and writing KV through the paged block pool
(counterpart of `repro.serving.paged_decode`), for the GQA transformer
family and its MoE variant.

Per layer: project q/k/v for the new token, write its K/V into its page
(before attending: the token attends to itself), paged attention over the
pool pages, then the MLP (an MoE block's FFN: the dense dispatch over
the batch's tokens, as the reference's). The exec mode (`repro_torch.exec`) picks the
attention: `gpu` (the default) launches the `paged_attention` CUDA kernel
and refuses CPU tensors; `torch` runs the plain version, as the
reference's `use_kernel=False` runs its jnp oracle. The pools are written
in place, and lanes that must not write (masked padding lanes, which alias
slot 0, and lanes without a page) are filtered out once per step.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.models.common import apply_rope, rms_norm
from repro_torch.models.mlp import mlp
from repro_torch.models.moe import MoE, moe_dense_ffn
from repro_torch.models.model import _head
from repro_torch.serving.kvcache import PagedKV, decode_write_lanes
from repro_torch import exec as exec_

# a codebook model's tokens are [B, n_cb, S] grids and its embed a table a
# codebook: neither the engine's [S] prompts nor the paged step's embed
# gather carry them, and the reference's engine fails on them too
# (`models/model.py`'s `_embed` indexes tokens[:, c, :] of a [1, S]
# prompt; `paged_decode_step` gathers embed[tokens] from [n_cb, Vp, D])
CODEBOOK_REFUSAL = ("the paged engine serves one token stream a request; "
                    "a codebook model (n_codebooks > 0, musicgen) decodes "
                    "[B, n_codebooks, 1] grids through models.model's "
                    "prefill and decode_step")


def paged_decode_step(params, cfg, tokens, slots, kv: PagedKV, mask=None,
                      mode: str | None = None):
    """tokens: [B, 1] int; slots: [B] request slots (rows of the block
    tables). Call AFTER grow_for_decode: lengths already count the new
    token. `mask`: [B] bool; padding lanes must not write pages. Returns
    (logits [B, V] f32, kv) with kv's pools updated in place."""
    if cfg.attn_type != "gqa" or cfg.block_pattern != "transformer":
        raise NotImplementedError("paged decode: GQA transformer families")
    if cfg.n_codebooks:
        raise NotImplementedError(CODEBOOK_REFUSAL)
    b = tokens.shape[0]
    if mask is None:
        mask = torch.ones(b, dtype=torch.bool, device=tokens.device)
    if exec_.resolve(mode) == "gpu":
        exec_.gpu_tensors("paged_decode_step", tokens, kv.k)
        attend = paged_attention
    else:
        attend = paged_attention_ref
    ct = cfg.compute_dtype
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    x = params.w("embed", ct)[tokens.long()]                 # [B, 1, D]
    rows = slots.long()
    pos = kv.lengths[rows] - 1                               # new token
    tables = kv.block_tables[rows]
    lengths = kv.lengths[rows]
    lane, pid, off = decode_write_lanes(kv, slots, mask)

    for i, bp in enumerate(params.blocks):
        p = bp.attn
        hn = rms_norm(x, bp.ln1, cfg.norm_eps)
        q = (hn @ p.w("wq", ct)).reshape(b, h, dh)
        kn = (hn @ p.w("wk", ct)).reshape(b, 1, hkv, dh)
        vn = (hn @ p.w("wv", ct)).reshape(b, 1, hkv, dh)
        if cfg.qkv_bias:
            q = q + p.w("bq", ct).reshape(h, dh)
            kn = kn + p.w("bk", ct).reshape(1, hkv, dh)
            vn = vn + p.w("bv", ct).reshape(1, hkv, dh)
        if cfg.qk_norm:
            q = rms_norm(q, p.q_norm, cfg.norm_eps)
            kn = rms_norm(kn, p.k_norm, cfg.norm_eps)
        q = apply_rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
        kn = apply_rope(kn, pos[:, None], cfg.rope_theta)
        k_pool, v_pool = kv.k[i], kv.v[i]
        k_pool[pid, off] = kn[lane, 0].to(k_pool.dtype)
        v_pool[pid, off] = vn[lane, 0].to(v_pool.dtype)
        o = attend(q, k_pool, v_pool, tables, lengths)
        x = x + o.reshape(b, 1, h * dh).to(x.dtype) @ p.w("wo", ct)
        h2 = rms_norm(x, bp.ln2, cfg.norm_eps)
        if isinstance(bp.ffn, MoE):
            f, _ = moe_dense_ffn(bp.ffn, cfg, h2.reshape(b, -1))
            x = x + f.reshape(b, 1, -1).to(x.dtype)
        else:
            x = x + mlp(bp.ffn, h2, ct)

    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return _head(params, cfg, x[:, 0]), kv
