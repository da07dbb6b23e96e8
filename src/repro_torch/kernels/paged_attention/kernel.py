"""Wrapper of the CUDA paged decode attention (`csrc/paged_attention.cu`).

Replaces `repro/kernels/paged_attention/kernel.py:paged_attention_grouped`.
On CUDA tensors it launches the kernel, one block per (request, KV head),
counted in `cuda.LAUNCHES["paged_attention"]`; on CPU tensors it runs the
plain version (`ref.paged_attention_ref`) and returns q's dtype. The
reference pads D to 128 for the TPU's lanes; the kernel takes D as it is
(a multiple of one 16-byte vector), so nothing is padded and `scale`
defaults to 1/sqrt(D)."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

# query heads per KV head the kernel is built for: those of the ported
# configs (qwen3-1.7b: 16 / 8), each checked on the card by chip_smoke.py
GROUPS = (2,)


def paged_attention_grouped(q, k_pool, v_pool, block_tables, lengths, *,
                            scale: float | None = None):
    """q: [B, Hkv, G, D]; pools: [N, page, Hkv, D]; tables: [B, P] int32;
    lengths: [B] int32 -> [B, Hkv, G, D] in q's dtype."""
    b, hkv, g, d = q.shape
    n, page, hkv_p, d_p = k_pool.shape
    p = block_tables.shape[1]
    if not q.is_cuda:
        o = _ref_grouped(q, k_pool, v_pool, block_tables, lengths, scale)
        return o.to(q.dtype)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    cuda.check_cuda("paged_attention", q, k_pool, v_pool, block_tables,
                    lengths)
    if (hkv_p, d_p) != (hkv, d) or v_pool.shape != k_pool.shape:
        raise ValueError("paged_attention: q [B, Hkv, G, D] and pools "
                         "[N, page, Hkv, D] disagree")
    if block_tables.shape[0] != b or lengths.shape != (b,):
        raise ValueError("paged_attention: tables [B, P], lengths [B]")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged_attention: int32 tables and lengths")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k_pool.dtype == v_pool.dtype):
        raise ValueError("paged_attention: q and pools both float32 or "
                         "both bfloat16")
    vec = 16 // q.element_size()
    tpg = d // vec
    if g not in GROUPS or d % vec or tpg < 1 or tpg > 32 or tpg & (tpg - 1):
        raise ValueError(f"paged_attention: G={g} must be in {GROUPS} and "
                         f"D={d} a power-of-two multiple of {vec}, at most "
                         f"{32 * vec}")
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("paged_attention: 16-byte aligned q and pools")
    out = torch.empty_like(q)
    cuda.launch("paged_attention", "paged_attention_launch", cuda.ptr(q),
                cuda.ptr(k_pool), cuda.ptr(v_pool), cuda.ptr(block_tables),
                cuda.ptr(lengths), cuda.ptr(out), b, hkv, g, d, page, p,
                int(q.dtype == torch.bfloat16), float(scale))
    return out


def _ref_grouped(q, k_pool, v_pool, block_tables, lengths, scale):
    """The plain version on the grouped layout (`scale` None: divide the
    scores by sqrt(D), as the reference's plain version does)."""
    b, hkv, g, d = q.shape
    o = paged_attention_ref(q.reshape(b, hkv * g, d), k_pool, v_pool,
                            block_tables, lengths, scale=scale)
    return o.reshape(b, hkv, g, d)
