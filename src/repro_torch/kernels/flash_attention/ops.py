"""The flash attention op (counterpart of
`repro.kernels.flash_attention.ops.flash_attention`): [B, S, H, D] in,
[B, S, H, D] out in q's dtype, f32 arithmetic. The TPU op transposes to
[B*H, S, D] and pads D to 128; the CUDA kernel reads the [B, S, H, D]
layout itself, so nothing is moved. With Sq != Sk the causal mask is
aligned to the bottom right, as the reference's oracle aligns it (the
TPU kernel aligns it to the top left: ROADMAP.md §4); its block sizes
have no counterpart here."""
from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import flash_attention_fused


def flash_attention(q, k, v, *, causal: bool = True):
    """q: [B, Sq, H, D]; k/v: [B, Sk, Hkv, D] -> [B, Sq, H, D] (q.dtype)."""
    sq, sk = q.shape[1], k.shape[1]
    return flash_attention_fused(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
        q_offset=sk - sq if causal else 0, mode="f32")
