"""Plain PyTorch versions of causal GQA attention (counterparts of
`repro.kernels.flash_attention.ref.flash_attention_ref` and of
`repro.models.common._attend_flash_xla`).

`flash_attention_ref` is the op's oracle: full f32 scores, a causal mask
aligned to the bottom right (`tril(k=Sk-Sq)`), softmax, f32 output.

`attend_flash_ref` is the online-softmax double loop of the reference
model's `attend_causal(impl="xla_flash")`, at its rounding points: q and
k rounded to bf16 and multiplied in f32 (exact products; PyTorch has no
bf16 matmul with f32 output, so the operands are rounded and the matmul
runs in f32, TF32 off), the scale, disallowed scores set to -1e30, f32
running max `m` (from -1e30) and sum `l` (of the unrounded p), p and v
rounded to bf16 for P.V, and `acc / max(l, 1e-30)`. Tiles are `block`
queries by `block` keys. The reference asserts that Sq and Sk are
multiples of the tile; here the last q or kv tile may be shorter (each
row's arithmetic is its own). Key tiles past the causal limit of every
row of the q tile are skipped, as the reference's `where(live, ...)`
discards them; so are key tiles before the window of every row, which
the reference computes and then wipes: a row meets them while its
running max is still -1e30, and the first allowed key multiplies what
they left by exp(-1e30 - m) = 0.
"""
from __future__ import annotations

import torch

NEG = -1e30


def ref_scale(d: int) -> float:
    """1 / sqrt(D) rounded as the reference's f32 arithmetic rounds it."""
    return float(1.0 / torch.tensor(float(d), dtype=torch.float32).sqrt())


def flash_attention_ref(q, k, v, *, causal: bool = True, scale=None,
                        q_offset: int | None = None, window: int = 0):
    """q: [B, Sq, H, D]; k/v: [B, Sk, Hkv, D] -> [B, Sq, H, D] f32.
    `q_offset` (default Sk - Sq, the oracle's alignment) is the position
    of query row 0; `window` > 0 keeps keys within `window` positions."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    off = sk - sq if q_offset is None else q_offset
    qg = q.reshape(b, sq, hkv, g, d).float()
    scores = torch.einsum("bqkgd,bskd->bqkgs", qg, k.float()) * scale
    qi = torch.arange(sq, device=q.device)[:, None] + off
    ki = torch.arange(sk, device=q.device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (ki <= qi)
    if window > 0:
        ok = ok & (ki > qi - window)
    scores = scores.masked_fill(~ok[None, :, None, None, :], float("-inf"))
    w = torch.softmax(scores, dim=-1)
    o = torch.einsum("bqkgs,bskd->bqkgd", w, v.float())
    return o.reshape(b, sq, h, d)


def attend_flash_ref(q, k, v, window: int = 0, out_dtype=torch.bfloat16,
                     block: int = 512, q_offset: int = 0):
    """q: [B,Sq,H,D]; k/v: [B,Sk,Hkv,D] -> [B,Sq,H,D] in `out_dtype`;
    causal with query row 0 at position `q_offset`."""
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    bq, bk = min(block, sq), min(block, sk)
    scale = ref_scale(dh)
    bf = torch.bfloat16
    dev = q.device
    outs = []
    for lo in range(0, sq, bq):
        nq = min(bq, sq - lo)
        qg = q[:, lo:lo + nq].reshape(b, nq, hkv, g, dh).to(bf).float()
        qpos = q_offset + lo + torch.arange(nq, device=dev)[:, None]
        m = torch.full((b, nq, hkv, g), NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((b, nq, hkv, g), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, nq, hkv, g, dh), dtype=torch.float32,
                          device=dev)
        for klo in range(0, sk, bk):
            nk = min(bk, sk - klo)
            if klo > q_offset + lo + nq - 1:
                break                          # past every row's causal limit
            if window > 0 and klo + nk - 1 <= q_offset + lo - window:
                continue                       # before every row's window
            kj = k[:, klo:klo + nk].to(bf).float()
            vj = v[:, klo:klo + nk].to(bf).float()
            s = torch.einsum("bqkgd,bskd->bqkgs", qg, kj) * scale
            kpos = klo + torch.arange(nk, device=dev)[None, :]
            ok = kpos <= qpos
            if window > 0:
                ok = ok & (kpos > qpos - window)
            s = s.masked_fill(~ok[None, :, None, None, :], NEG)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqkgs,bskd->bqkgd", p.to(bf).float(), vj)
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(o.reshape(b, nq, h, dh).to(out_dtype))
    return torch.cat(outs, dim=1)
