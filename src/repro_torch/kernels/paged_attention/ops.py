"""Glue: [B, H, D] queries + one layer's pool pages -> the paged attention
kernel (counterpart of `repro.kernels.paged_attention.ops`). The query
heads of a KV head are contiguous, so [B, H, D] is [B, Hkv, G, D] as it
lies; no padding (the reference pads D to 128 for the TPU), and the
kernel's scale is 1/sqrt(D) of the true D."""
from __future__ import annotations

from repro_torch.kernels.paged_attention.kernel import paged_attention_grouped


def paged_attention(q, k_pool, v_pool, block_tables, lengths):
    """q: [B, H, D]; pools: [N_pages, page, Hkv, D]; tables [B, P] int32
    (-1 pad); lengths [B] int32. Returns [B, H, D] in q's dtype."""
    b, h, d = q.shape
    hkv = k_pool.shape[2]
    o = paged_attention_grouped(q.contiguous().reshape(b, hkv, h // hkv, d),
                                k_pool, v_pool, block_tables, lengths)
    return o.reshape(b, h, d)
