"""LM assembly: embeddings -> blocks -> head (counterpart of
`repro.models.model`: the dense GQA transformer, its MoE variant,
minicpm3's MLA, hymba and xLSTM).

The reference scans over groups of a period of block kinds (`block_kinds`,
one kind for most archs, xLSTM's 7 mlstm + 1 slstm), with stacked
parameters. Here the layers are an `nn.ModuleList` walked by a Python
loop: layer g·P + i has kind `block_kinds(cfg)[i]` and the window
`layer_windows(cfg)[g·P + i]`. The caches keep the reference's layout, a
tuple over the period of dicts whose leaves are stacked over the groups,
`[n_groups, B, ...]`: `({"k": [L, B, S, Hkv, Dh], "v": ...},)` for a
period of one GQA block (hymba adds "conv" and "ssm"; MLA's are "ckv"
and "kpe"), and for xLSTM seven mlstm dicts and one slstm dict of
[L / 8, B, ...] leaves.

  forward            [B,S] tokens -> ([B,S,V] logits, aux)
  init_caches        the empty caches `prefill` fills
  prefill            + contiguous caches
  prefill_with_past  suffix prefill after cached prefix KV (GQA)
  decode_step        one token against the caches
  cross_entropy      the training loss over `forward`'s logits

The modality frontends are stubs, as the reference's: `forward` and
`prefill` take `prefix_embeds` [B, ft, D], precomputed patch or frame
embeddings put before the token embeddings (llava), and a codebook model
(musicgen, `cfg.n_codebooks`) takes [B, n_cb, S] token grids, sums the
codebooks' embeddings and gives [B, S, n_cb, V] logits from one head of
n_cb·Vp columns.

With `cfg.remat` and grad enabled, `forward` keeps only each layer's
input and recomputes the layer in the backward pass (the reference's
`jax.checkpoint` of a layer group), in the exec mode of the forward: on
CUDA the recompute runs in the autograd engine's thread, which the
caller's mode (a `ContextVar`) does not reach.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import exec as exec_
from repro_torch.models.blocks import (block_decode, block_forward,
                                       block_init_cache, block_kinds,
                                       block_prefill, init_block,
                                       layer_windows)
from repro_torch.models.common import dtype_of, embed_init, rms_norm
from repro_torch.models.params import Weights


class LM(Weights):
    """embed, final_norm, blocks (one `Block` per layer) and, untied,
    lm_head. A codebook model's embed is [n_cb, Vp, D] and its lm_head
    [D, n_cb·Vp]."""
    MATMUL = ("embed", "lm_head")


def init_params(cfg, generator: torch.Generator) -> LM:
    """Random parameters in `param_dtype` from `generator` (on the
    generator's device): matmul weights N(0,1)/sqrt(d_in), embeddings
    N(0,1)*0.02, norms one, as the reference draws them; a codebook
    model's n_cb embedding tables and its head drawn as one [n_cb·Vp, D]
    table, transposed."""
    blocks = nn.ModuleList(init_block(generator, cfg, kind)
                           for kind in _layer_kinds(cfg))
    dev = generator.device
    vp, d, pt = cfg.padded_vocab, cfg.d_model, cfg.param_dtype
    p = dict(blocks=blocks,
             final_norm=torch.ones(d, dtype=dtype_of(pt), device=dev))
    if cfg.n_codebooks:
        p["embed"] = torch.stack([embed_init(generator, vp, d, pt)
                                  for _ in range(cfg.n_codebooks)])
        p["lm_head"] = embed_init(generator, cfg.n_codebooks * vp, d,
                                  pt).T.contiguous()
    else:
        p["embed"] = embed_init(generator, vp, d, pt)
        if not cfg.tie_embeddings:
            p["lm_head"] = embed_init(generator, vp, d, pt).T.contiguous()
    return LM(**p)


def _embed(p: LM, cfg, tokens: torch.Tensor,
           prefix_embeds=None) -> torch.Tensor:
    """Token embeddings in the compute dtype: a codebook grid [B, n_cb, S]
    sums its codebooks' rows in the parameter dtype and then casts, as
    the reference does; `prefix_embeds` [B, ft, D], cast, goes first."""
    tokens = tokens.long()
    if cfg.n_codebooks:
        x = sum(p.embed[c][tokens[:, c]] for c in range(cfg.n_codebooks))
        x = x.to(dtype_of(cfg.compute_dtype))
    else:
        x = p.w("embed", cfg.compute_dtype)[tokens]
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    return x


def _head(p: LM, cfg, x: torch.Tensor) -> torch.Tensor:
    ct = cfg.compute_dtype
    tied = getattr(p, "lm_head", None) is None
    w = p.w("embed", ct).T if tied else p.w("lm_head", ct)
    logits = (x @ w).float()
    if cfg.n_codebooks:
        logits = logits.reshape(*logits.shape[:2], cfg.n_codebooks,
                                cfg.padded_vocab)
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(logits.shape[-1], device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits


def _positions(b: int, s: int, start: int, device) -> torch.Tensor:
    return (start + torch.arange(s, dtype=torch.int32,
                                 device=device))[None].expand(b, s)


def _layer_kinds(cfg) -> list[str]:
    """Each layer's block kind: layer g·P + i has the period's kind i."""
    kinds = block_kinds(cfg)
    if cfg.n_layers % len(kinds):
        raise ValueError(f"{cfg.n_layers} layers in periods of "
                         f"{len(kinds)} blocks")
    return kinds * (cfg.n_layers // len(kinds))


def _layers(p: LM, cfg):
    """(layer, kind, window, params) for every layer."""
    return zip(range(cfg.n_layers), _layer_kinds(cfg), layer_windows(cfg),
               p.blocks)


def _stack(cfg, caches: list[dict]) -> tuple:
    """Per-layer caches -> a tuple over the period of dicts stacked over
    the groups (layer g·P + i is row g of dict i)."""
    period = len(block_kinds(cfg))
    return tuple({name: torch.stack([c[name] for c in caches[i::period]])
                  for name in caches[i]} for i in range(period))


def _layer_cache(cfg, caches: tuple, layer: int) -> dict:
    period = len(block_kinds(cfg))
    return {name: t[layer // period]
            for name, t in caches[layer % period].items()}


def init_caches(p: LM, cfg, batch: int, cache_len: int) -> tuple:
    """Empty caches for `batch` sequences of up to `cache_len` tokens, on
    the parameters' device, in `prefill`'s layout."""
    ng = cfg.n_layers // len(block_kinds(cfg))
    dev = p.embed.device
    return tuple({name: t.expand((ng,) + t.shape).contiguous()
                  for name, t in block_init_cache(cfg, kind, batch,
                                                  cache_len, dev).items()}
                 for kind in block_kinds(cfg))


def forward(p: LM, cfg, tokens, positions=None, prefix_embeds=None):
    """Returns (logits, aux); aux is the blocks' summed MoE load-balance
    loss (0 without experts). The default positions run over the prefix
    and the tokens."""
    x = _embed(p, cfg, tokens, prefix_embeds)
    b, s, _ = x.shape
    if positions is None:
        positions = _positions(b, s, 0, x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), device=x.device)
    mode = exec_.get_mode()
    for _, kind, win, bp in _layers(p, cfg):
        if remat:
            x, a = checkpoint(_block_in_mode, mode, bp, cfg, kind, x,
                              positions, win, use_reentrant=False)
        else:
            x, a = block_forward(bp, cfg, kind, x, positions, win)
        aux = aux + a
    x = rms_norm(x, p.final_norm, cfg.norm_eps)
    return _head(p, cfg, x), aux


def _block_in_mode(mode: str, *args):
    """`block_forward(*args)` in exec mode `mode` (remat's recompute)."""
    with exec_.exec_mode(mode):
        return block_forward(*args)


def prefill(p: LM, cfg, tokens, cache_len: int, positions=None,
            prefix_embeds=None):
    """Returns (logits, caches, aux), aux summed over the blocks as
    `forward`'s (the reference's prefill returns 0). The caches cover the
    prefix and the tokens."""
    x = _embed(p, cfg, tokens, prefix_embeds)
    b, s, _ = x.shape
    if positions is None:
        positions = _positions(b, s, 0, x.device)
    caches = []
    aux = torch.zeros((), device=x.device)
    for _, kind, win, bp in _layers(p, cfg):
        x, c, a = block_prefill(bp, cfg, kind, x, positions, cache_len, win)
        caches.append(c)
        aux = aux + a
    x = rms_norm(x, p.final_norm, cfg.norm_eps)
    return _head(p, cfg, x), _stack(cfg, caches), aux


def prefill_with_past(p: LM, cfg, tokens, past_k, past_v, cache_len: int):
    """Suffix prefill against cached prefix KV (prefix-cache reuse).
    past_k/v: [L, B, S_past, Hkv, Dh] roped. Returns (logits, caches, aux)
    with caches covering past+suffix. The moe kind too, which the
    reference's refuses: its FFN sees only the suffix's tokens, so where
    the full prompt's dispatch would drop lanes the two can differ. MLA
    raises, where the reference ignores `past`."""
    if (block_kinds(cfg)[0] not in ("dense", "moe")
            or cfg.attn_type != "gqa"):
        raise NotImplementedError("prefix reuse: GQA transformer families")
    x = _embed(p, cfg, tokens)
    b, s, _ = x.shape
    positions = _positions(b, s, past_k.shape[2], x.device)
    caches = []
    aux = torch.zeros((), device=x.device)
    for i, kind, win, bp in _layers(p, cfg):
        x, c, a = block_prefill(bp, cfg, kind, x, positions, cache_len,
                                win, past={"k": past_k[i], "v": past_v[i]})
        caches.append(c)
        aux = aux + a
    x = rms_norm(x, p.final_norm, cfg.norm_eps)
    return _head(p, cfg, x), _stack(cfg, caches), aux


def decode_step(p: LM, cfg, token, pos, caches):
    """token: [B,1] (a codebook model's [B,n_cb,1]); pos: [B] int; caches
    as `prefill` returns them. Returns (logits [B,1,V] or [B,1,n_cb,V],
    caches')."""
    x = _embed(p, cfg, token)
    new = []
    for i, kind, win, bp in _layers(p, cfg):
        x, c, _ = block_decode(bp, cfg, kind, x, pos,
                               _layer_cache(cfg, caches, i), win)
        new.append(c)
    x = rms_norm(x, p.final_norm, cfg.norm_eps)
    return _head(p, cfg, x), _stack(cfg, new)


def cross_entropy(logits, labels, mask=None):
    """Mean f32 negative log-likelihood of `labels` [B,S] under `logits`
    [B,S,V], over the positions where the optional [B,S] `mask` is set.
    Codebook logits [B,S,n_cb,V] take labels [B,n_cb,S]: a position's
    loss is the mean over its codebooks."""
    logits = logits.float()
    labels = labels.long()
    if logits.ndim == 4:
        labels = labels.transpose(1, 2)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = lse - ll
    if logits.ndim == 4:
        nll = torch.mean(nll, dim=-1)
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(nll)
