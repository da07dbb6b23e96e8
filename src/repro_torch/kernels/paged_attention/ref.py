"""Plain PyTorch version of paged decode attention over block-pool pages
(counterpart of `repro.kernels.paged_attention.ref.paged_attention_ref`):
gather every table page, mask positions past the length and pages with
id -1 to -inf, softmax in f32. A request of length 0 gives NaN, as in the
reference (the kernel gives zeros)."""
from __future__ import annotations

import math

import torch


def paged_attention_ref(q, k_pool, v_pool, block_tables, lengths, *,
                        scale: float | None = None):
    """q: [B, H, D] one decode token per request.
    k_pool/v_pool: [N_pages, page, Hkv, D] (the §V block pool's data).
    block_tables: [B, P] int32 page ids (-1 pad); lengths: [B] int32.
    `scale` multiplies the scores (default: divide by sqrt(D), as the
    reference does). Returns [B, H, D] f32."""
    b, h, d = q.shape
    _, page, hkv, _ = k_pool.shape
    p = block_tables.shape[1]
    g = h // hkv
    safe = torch.clamp(block_tables, min=0).long()
    k = k_pool[safe].reshape(b, p * page, hkv, d)        # [B, P*page, Hkv, D]
    v = v_pool[safe].reshape(b, p * page, hkv, d)
    pos = torch.arange(p * page, device=q.device)[None, :]
    valid = ((pos < lengths[:, None])
             & (block_tables >= 0).repeat_interleave(page, dim=1))
    qg = q.reshape(b, hkv, g, d).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k.float())
    scores = scores / math.sqrt(d) if scale is None else scores * scale
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    w = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", w, v.float())
    return o.reshape(b, h, d)
