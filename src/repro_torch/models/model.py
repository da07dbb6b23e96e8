"""LM assembly: embeddings -> blocks -> head (counterpart of
`repro.models.model` for the single-kind families: the dense GQA
transformer, its MoE variant and hymba).

The reference scans over stacked layer groups; here the layers are an
`nn.ModuleList` walked by a Python loop, and the caches come back stacked
over layers as `({"k": [L, B, S, Hkv, Dh], "v": ...},)` (hymba adds
"conv" [L, B, K-1, d_inner] and "ssm" [L, B, d_inner, d_state]), the
reference's `[n_groups, ...]` leaves for a period of one block.

  forward            [B,S] tokens -> ([B,S,V] logits, aux)
  prefill            + contiguous KV caches
  prefill_with_past  suffix prefill after cached prefix KV
  decode_step        one token against the caches
  cross_entropy      the training loss over `forward`'s logits

With `cfg.remat` and grad enabled, `forward` keeps only each layer's
input and recomputes the layer in the backward pass (the reference's
`jax.checkpoint` of a layer group).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.blocks import (block_decode, block_forward,
                                       block_kinds, block_prefill,
                                       init_block, layer_windows)
from repro_torch.models.common import dtype_of, embed_init, rms_norm
from repro_torch.models.params import Weights


class LM(Weights):
    """embed, final_norm, blocks (one `Block` per layer) and, untied,
    lm_head."""
    MATMUL = ("embed", "lm_head")


def init_params(cfg, generator: torch.Generator) -> LM:
    """Random parameters in `param_dtype` from `generator` (on the
    generator's device): matmul weights N(0,1)/sqrt(d_in), embeddings
    N(0,1)*0.02, norms one, as the reference draws them."""
    kinds = block_kinds(cfg)
    if cfg.n_codebooks:
        raise NotImplementedError("codebook models are not ported yet")
    blocks = nn.ModuleList(init_block(generator, cfg, kinds[0])
                           for _ in range(cfg.n_layers))
    dev = generator.device
    p = dict(blocks=blocks,
             final_norm=torch.ones(cfg.d_model, dtype=dtype_of(
                 cfg.param_dtype), device=dev),
             embed=embed_init(generator, cfg.padded_vocab, cfg.d_model,
                              cfg.param_dtype))
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(generator, cfg.padded_vocab, cfg.d_model,
                                  cfg.param_dtype).T.contiguous()
    return LM(**p)


def _embed(p: LM, cfg, tokens: torch.Tensor) -> torch.Tensor:
    return p.w("embed", cfg.compute_dtype)[tokens.long()]


def _head(p: LM, cfg, x: torch.Tensor) -> torch.Tensor:
    ct = cfg.compute_dtype
    tied = getattr(p, "lm_head", None) is None
    w = p.w("embed", ct).T if tied else p.w("lm_head", ct)
    logits = (x @ w).float()
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(logits.shape[-1], device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits


def _positions(b: int, s: int, start: int, device) -> torch.Tensor:
    return (start + torch.arange(s, dtype=torch.int32,
                                 device=device))[None].expand(b, s)


def _stack(caches: list[dict]) -> tuple:
    return ({name: torch.stack([c[name] for c in caches])
             for name in caches[0]},)


def forward(p: LM, cfg, tokens, positions=None):
    """Returns (logits, aux); aux is the blocks' summed MoE load-balance
    loss (0 without experts)."""
    x = _embed(p, cfg, tokens)
    b, s, _ = x.shape
    if positions is None:
        positions = _positions(b, s, 0, x.device)
    kind = block_kinds(cfg)[0]
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), device=x.device)
    for bp, win in zip(p.blocks, layer_windows(cfg)):
        if remat:
            x, a = checkpoint(block_forward, bp, cfg, kind, x, positions,
                              win, use_reentrant=False)
        else:
            x, a = block_forward(bp, cfg, kind, x, positions, win)
        aux = aux + a
    x = rms_norm(x, p.final_norm, cfg.norm_eps)
    return _head(p, cfg, x), aux


def prefill(p: LM, cfg, tokens, cache_len: int, positions=None):
    """Returns (logits, caches, aux), aux summed over the blocks as
    `forward`'s (the reference's prefill returns 0)."""
    x = _embed(p, cfg, tokens)
    b, s, _ = x.shape
    if positions is None:
        positions = _positions(b, s, 0, x.device)
    kind = block_kinds(cfg)[0]
    caches = []
    aux = torch.zeros((), device=x.device)
    for bp, win in zip(p.blocks, layer_windows(cfg)):
        x, c, a = block_prefill(bp, cfg, kind, x, positions, cache_len, win)
        caches.append(c)
        aux = aux + a
    x = rms_norm(x, p.final_norm, cfg.norm_eps)
    return _head(p, cfg, x), _stack(caches), aux


def prefill_with_past(p: LM, cfg, tokens, past_k, past_v, cache_len: int):
    """Suffix prefill against cached prefix KV (prefix-cache reuse).
    past_k/v: [L, B, S_past, Hkv, Dh] roped. Returns (logits, caches, aux)
    with caches covering past+suffix. The moe kind too, which the
    reference's refuses: its FFN sees only the suffix's tokens, so where
    the full prompt's dispatch would drop lanes the two can differ."""
    kind = block_kinds(cfg)[0]
    if kind not in ("dense", "moe"):
        raise NotImplementedError("prefix reuse: GQA transformer families")
    x = _embed(p, cfg, tokens)
    b, s, _ = x.shape
    positions = _positions(b, s, past_k.shape[2], x.device)
    caches = []
    aux = torch.zeros((), device=x.device)
    for i, (bp, win) in enumerate(zip(p.blocks, layer_windows(cfg))):
        x, c, a = block_prefill(bp, cfg, kind, x, positions, cache_len,
                                win, past={"k": past_k[i], "v": past_v[i]})
        caches.append(c)
        aux = aux + a
    x = rms_norm(x, p.final_norm, cfg.norm_eps)
    return _head(p, cfg, x), _stack(caches), aux


def decode_step(p: LM, cfg, token, pos, caches):
    """token: [B,1]; pos: [B] int; caches as `prefill` returns them.
    Returns (logits [B,1,V], caches')."""
    x = _embed(p, cfg, token)
    kind = block_kinds(cfg)[0]
    new = []
    for i, (bp, win) in enumerate(zip(p.blocks, layer_windows(cfg))):
        x, c, _ = block_decode(bp, cfg, kind, x, pos,
                            {name: t[i] for name, t in caches[0].items()},
                            win)
        new.append(c)
    x = rms_norm(x, p.final_norm, cfg.norm_eps)
    return _head(p, cfg, x), _stack(new)


def cross_entropy(logits, labels, mask=None):
    """Mean f32 negative log-likelihood of `labels` [B,S] under `logits`
    [B,S,V], over the positions where the optional [B,S] `mask` is set."""
    if logits.ndim == 4:
        raise NotImplementedError("codebook models are not ported yet")
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(nll)
