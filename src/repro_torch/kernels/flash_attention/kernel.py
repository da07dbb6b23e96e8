"""Wrapper of the CUDA flash attention (`csrc/flash_attention.cu`).

Replaces `repro/kernels/flash_attention/kernel.py:flash_attention_bhsd`
and carries `attend_causal(impl="xla_flash")`. The kernel takes the
model's [B, S, heads, D] layout as it lies (no transpose to [B*H, S, D]
and no padding of D to 128, which the TPU's lanes wanted); the kv head
of query head h is h // G. On CUDA tensors it launches the kernel,
counted in `cuda.LAUNCHES["flash_attention"]` (one per call); on CPU
tensors it runs the plain version of the same mode (`ref.attend_flash_ref`
at the kernel's `TILE`-key tiles, or `ref.flash_attention_ref`).

Modes: "xla_flash" (q, k, p, v rounded to bf16, f32 sums: the model path,
`wgmma` tensor cores fed by TMA; D 64 or 128; f32 q, k, v are rounded to
bf16 here, round to nearest even as the kernel's own rounding would) and
"f32" (f32 throughout: the op's contract; D a multiple of 32 up to 128).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.flash_attention.ref import (attend_flash_ref,
                                                     flash_attention_ref,
                                                     ref_scale)

MODES = {"xla_flash": 0, "f32": 1}
TILE = 64                 # the kernel's key tile: p rounds after its max
_DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_fused(q, k, v, *, causal: bool = True, q_offset: int = 0,
                          window: int = 0, mode: str = "xla_flash",
                          out_dtype=None):
    """q: [B, Sq, H, D]; k/v: [B, Sk, Hkv, D] (float32 or bfloat16, all
    alike) -> [B, Sq, H, D] in `out_dtype` (default q's). Query row 0 sits
    at position `q_offset`; `window` > 0 keeps the last `window` keys of
    each row (causal only). Scores are scaled by the reference's f32
    1/sqrt(D)."""
    if mode not in MODES:
        raise ValueError(f"flash_attention: mode {mode!r}, one of "
                         f"{sorted(MODES)}")
    out_dtype = q.dtype if out_dtype is None else out_dtype
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = ref_scale(d)
    if window > 0 and not causal:
        raise ValueError("flash_attention: a window needs causal attention")
    if not q.is_cuda:
        if mode == "f32":
            return flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                       q_offset=q_offset,
                                       window=window).to(out_dtype)
        if not causal:
            raise ValueError("flash_attention: mode 'xla_flash' is causal")
        return attend_flash_ref(q, k, v, window, out_dtype, TILE, q_offset)
    cuda.check_cuda("flash_attention", q, k, v)
    if k.shape != (b, sk, hkv, d) or v.shape != k.shape or hkv == 0 \
            or h % hkv:
        raise ValueError("flash_attention: q [B,Sq,H,D], k/v [B,Sk,Hkv,D] "
                         "with H a multiple of Hkv")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype) \
            or out_dtype not in _DTYPES:
        raise ValueError("flash_attention: q, k, v all float32 or all "
                         "bfloat16")
    if mode == "xla_flash" and d not in (64, 128):
        raise ValueError(f"flash_attention: mode 'xla_flash' takes D 64 or "
                         f"128, not {d}")
    if mode == "f32" and (d % 32 or d > 128):
        raise ValueError(f"flash_attention: mode 'f32' takes D a multiple "
                         f"of 32 up to 128, not {d}")
    if causal and q_offset + sq > sk:
        raise ValueError("flash_attention: causal rows past the last key")
    out = torch.empty((b, sq, h, d), dtype=out_dtype, device=q.device)
    if any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("flash_attention: 16-byte aligned tensors")
    bf = torch.bfloat16
    if mode == "xla_flash" and q.dtype != bf:
        q, k, v = q.to(bf), k.to(bf), v.to(bf)
    cuda.launch("flash_attention", "flash_attention_launch", cuda.ptr(q),
                cuda.ptr(k), cuda.ptr(v), cuda.ptr(out), b, sq, sk, h, hkv,
                d, q_offset, window, int(causal), MODES[mode],
                int(q.dtype == bf), int(out_dtype == bf), float(scale))
    return out
