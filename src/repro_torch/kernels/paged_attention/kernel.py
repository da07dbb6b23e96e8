"""Wrapper of the CUDA paged decode attention (`csrc/paged_attention.cu`).

Replaces `repro/kernels/paged_attention/kernel.py:paged_attention_grouped`.
On CUDA tensors it launches the split-KV kernel and its merge (one
launcher call, counted once in `cuda.LAUNCHES["paged_attention"]`), with
f32 scratch for the splits' partial softmaxes allocated here; on CPU
tensors it runs the plain version (`ref.paged_attention_ref`) and returns
q's dtype. The reference pads D to 128 for the TPU's lanes; the kernel
takes D 16, 32, 64 or 128 as it is (16: every reduced config's heads),
so nothing is padded and `scale` defaults to 1/sqrt(D)."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

# query heads per KV head the kernel is built for: the GQA groups of the
# reference's configs (musicgen and minicpm3 1, qwen3-1.7b 2, llava 4,
# llama4-scout 5, qwen1.5-110b 8, llama3-405b and qwen3-moe 16), each held
# against the plain version on the card by chip_smoke.py
GROUPS = (1, 2, 4, 5, 8, 16)
HEAD_DIMS = (16, 32, 64, 128)
MAX_PAGE = 32             # tokens a page (one lane of a warp each)
MAX_SPLIT_PAGES = 16      # table entries a split owns, at most
_BLOCKS = 2048            # blocks to aim for: many waves on 132 SMs


def split_pages(b: int, hkv: int, p: int) -> int:
    """Table entries a split owns: enough splits that B * Hkv * splits
    blocks fill the card several times over, each split at most
    `MAX_SPLIT_PAGES` and (for few requests) at least 4 entries."""
    want = -(-(b * hkv * p) // _BLOCKS)
    return max(1, min(p, MAX_SPLIT_PAGES, max(4, want)))


def check_launch(q, k_pool, v_pool, block_tables, lengths) -> None:
    """Raise on what the kernel does not take (shapes, types, the group
    size G, D, the page size); the device is checked apart."""
    b, hkv, g, d = q.shape
    n, page, hkv_p, d_p = k_pool.shape
    if (hkv_p, d_p) != (hkv, d) or v_pool.shape != k_pool.shape:
        raise ValueError("paged_attention: q [B, Hkv, G, D] and pools "
                         "[N, page, Hkv, D] disagree")
    if block_tables.dim() != 2 or block_tables.shape[0] != b \
            or lengths.shape != (b,):
        raise ValueError("paged_attention: tables [B, P], lengths [B]")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged_attention: int32 tables and lengths")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k_pool.dtype == v_pool.dtype):
        raise ValueError("paged_attention: q and pools both float32 or "
                         "both bfloat16")
    if g not in GROUPS:
        raise ValueError(f"paged_attention: G={g} query heads per KV head; "
                         f"the kernel is built for G in {GROUPS}")
    if d not in HEAD_DIMS or not 1 <= page <= MAX_PAGE:
        raise ValueError(f"paged_attention: D={d} must be in {HEAD_DIMS} "
                         f"and the page 1..{MAX_PAGE} tokens, not {page}")


def paged_attention_grouped(q, k_pool, v_pool, block_tables, lengths, *,
                            scale: float | None = None):
    """q: [B, Hkv, G, D]; pools: [N, page, Hkv, D]; tables: [B, P] int32;
    lengths: [B] int32 -> [B, Hkv, G, D] in q's dtype."""
    if not q.is_cuda:
        o = _ref_grouped(q, k_pool, v_pool, block_tables, lengths, scale)
        return o.to(q.dtype)
    b, hkv, g, d = q.shape
    p = block_tables.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    cuda.check_cuda("paged_attention", q, k_pool, v_pool, block_tables,
                    lengths)
    check_launch(q, k_pool, v_pool, block_tables, lengths)
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("paged_attention: 16-byte aligned q and pools")
    n_split = max(1, -(-p // split_pages(b, hkv, p)))
    out = torch.empty_like(q)
    ml = torch.empty((b, hkv, n_split, g, 2), dtype=torch.float32,
                     device=q.device)
    acc = torch.empty((b, hkv, n_split, g, d), dtype=torch.float32,
                      device=q.device)
    cuda.launch("paged_attention", "paged_attention_launch", cuda.ptr(q),
                cuda.ptr(k_pool), cuda.ptr(v_pool), cuda.ptr(block_tables),
                cuda.ptr(lengths), cuda.ptr(out), cuda.ptr(ml),
                cuda.ptr(acc), b, hkv, g, d, k_pool.shape[1], p, n_split,
                int(q.dtype == torch.bfloat16), float(scale))
    return out


def _ref_grouped(q, k_pool, v_pool, block_tables, lengths, scale):
    """The plain version on the grouped layout (`scale` None: divide the
    scores by sqrt(D), as the reference's plain version does)."""
    b, hkv, g, d = q.shape
    o = paged_attention_ref(q.reshape(b, hkv * g, d), k_pool, v_pool,
                            block_tables, lengths, scale=scale)
    return o.reshape(b, hkv, g, d)
