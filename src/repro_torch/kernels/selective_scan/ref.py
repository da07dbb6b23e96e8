"""Plain PyTorch versions of the selective scan, the mamba-1 recurrence
(counterparts of `repro.kernels.selective_scan.ref` and of the chunked
scan in `repro.models.ssm.mamba_forward`):

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t * B_t   (per channel d, state n)
    y_t = sum_n h_t[d, n] * C_t[n]

`selective_scan_ref` steps the recurrence one position at a time, as the
reference's oracle does; `selective_scan_bwd_ref` steps its gradient
back the same way, the plain version of the backward kernel.
`selective_scan_chunked` is what the reference model computes and what
exec mode `torch` runs: the sequence in chunks of
`chunk` steps, each chunk an associative scan of (exp(dt A), dt B x)
pairs seeded with the carried state, in `associative_scan`'s order of
operations (a copy of `jax.lax.associative_scan`'s odd/even recursion),
so its f32 sums round as the reference's do. The two forms differ in
summation order only.
"""
from __future__ import annotations

import torch


def selective_scan_ref(x, dt, bmat, cmat, a, h0=None):
    """x: [B,S,D]; dt: [B,S]; bmat/cmat: [B,S,N]; a: [D,N] (negative);
    h0: [B,D,N] or None (zeros). Returns (y [B,S,D] f32, h_last [B,D,N]
    f32)."""
    b, s, d = x.shape
    n = bmat.shape[-1]
    h = (torch.zeros((b, d, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    x, dt, bmat, cmat, a = (t.float() for t in (x, dt, bmat, cmat, a))
    ys = []
    for t in range(s):
        da = torch.exp(dt[:, t, None, None] * a[None])           # [B,D,N]
        h = da * h + (dt[:, t, None] * x[:, t])[..., None] \
            * bmat[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cmat[:, t]))
    y = (torch.stack(ys, 1) if ys
         else torch.zeros((b, 0, d), dtype=torch.float32, device=x.device))
    return y, h


def selective_scan_bwd_ref(x, dt, bmat, cmat, a, h0, dy, dh_last=None):
    """The gradient of `selective_scan_ref` (y, h_last) for the cotangents
    dy [B,S,D] and dh_last [B,D,N] (None: zeros), one step at a time: with
    g_t = dL/dh_t = C_t dy_t + exp(dt_{t+1} A) g_{t+1} (plus dh_last at
    the last step),

        dx_t[d] = dt_t sum_n g_t B_t      dB_t[n] = dt_t sum_d g_t x_t
        dC_t[n] = sum_d h_t dy_t
        ddt_t   = sum_{d,n} g_t (A exp(dt_t A) h_{t-1} + B_t x_t)
        dA      = sum_{b,t} g_t dt_t exp(dt_t A) h_{t-1}
        dh0     = exp(dt_0 A) g_0

    Returns (dx [B,S,D], ddt [B,S], dB [B,S,N], dC [B,S,N], dA [D,N],
    dh0 [B,D,N]), all f32."""
    b, s, d = x.shape
    n = bmat.shape[-1]
    f32 = dict(dtype=torch.float32, device=x.device)
    x, dt, bmat, cmat, a, dy = (t.float() for t in (x, dt, bmat, cmat, a,
                                                    dy))
    h = torch.zeros((b, d, n), **f32) if h0 is None else h0.float()
    hs = [h]                                          # h_{-1}, h_0, ...
    for t in range(s):
        da = torch.exp(dt[:, t, None, None] * a[None])
        h = da * h + (dt[:, t, None] * x[:, t])[..., None] \
            * bmat[:, t, None, :]
        hs.append(h)
    gc = (torch.zeros((b, d, n), **f32) if dh_last is None
          else dh_last.float())
    dx = torch.empty((b, s, d), **f32)
    ddt = torch.empty((b, s), **f32)
    db = torch.empty((b, s, n), **f32)
    dc = torch.empty((b, s, n), **f32)
    dA = torch.zeros((d, n), **f32)
    for t in reversed(range(s)):
        at = torch.exp(dt[:, t, None, None] * a[None])             # [B,D,N]
        g = cmat[:, t, None, :] * dy[:, t, :, None] + gc
        dx[:, t] = dt[:, t, None] * (g * bmat[:, t, None, :]).sum(-1)
        db[:, t] = dt[:, t, None] * (g * x[:, t, :, None]).sum(1)
        dc[:, t] = (hs[t + 1] * dy[:, t, :, None]).sum(1)
        ah = at * hs[t]
        ddt[:, t] = (g * (a[None] * ah + bmat[:, t, None, :]
                          * x[:, t, :, None])).sum((1, 2))
        dA += (g * dt[:, t, None, None] * ah).sum(0)
        gc = at * g
    return dx, ddt, db, dc, dA, gc


def _combine(left, right):
    al, bl = left
    ar, br = right
    return al * ar, ar * bl + br


def _interleave(even, odd, dim):
    n = even.shape[dim] + odd.shape[dim]
    shape = list(even.shape)
    shape[dim] = n
    out = even.new_empty(shape)
    idx = [slice(None)] * even.dim()
    idx[dim] = slice(0, n, 2)
    out[tuple(idx)] = even
    idx[dim] = slice(1, n, 2)
    out[tuple(idx)] = odd
    return out


def associative_scan(elems, dim: int):
    """Inclusive scan of the (A, b) pairs `elems` along `dim` under
    (al, bl) . (ar, br) = (al * ar, ar * bl + br), in the order of
    operations of `jax.lax.associative_scan`."""
    def sl(t, start, stop=None, step=1):
        idx = [slice(None)] * t.dim()
        idx[dim] = slice(start, stop, step)
        return t[tuple(idx)]

    n = elems[0].shape[dim]
    if n < 2:
        return list(elems)
    reduced = _combine([sl(e, 0, n - 1, 2) for e in elems],
                       [sl(e, 1, None, 2) for e in elems])
    odd = associative_scan(reduced, dim)
    if n % 2 == 0:
        even = _combine([sl(e, 0, -1) for e in odd],
                        [sl(e, 2, None, 2) for e in elems])
    else:
        even = _combine(odd, [sl(e, 2, None, 2) for e in elems])
    even = [torch.cat([sl(e, 0, 1), r], dim) for e, r in zip(elems, even)]
    return [_interleave(e, o, dim) for e, o in zip(even, odd)]


def selective_scan_chunked(x, dt, bmat, cmat, a, h0=None, chunk: int = 256,
                           scan_dtype=torch.float32):
    """The reference model's chunked scan (`mamba_forward`, ssm.py:80-118)
    on the kernel's contract: x [B,S,D], dt [B,S], bmat/cmat [B,S,N], a
    [D,N], h0 [B,D,N] or None. The [B, L, D, N] hidden tensor exists for
    one chunk at a time (L = min(chunk, S)); the last chunk is padded with
    dt = 0, which leaves the state as it is. `scan_dtype` is the
    reference's `ssm_scan_dtype`. Returns (y [B,S,D] f32, h_last [B,D,N]
    f32)."""
    b, s, d = x.shape
    n = bmat.shape[-1]
    dev = x.device
    h = (torch.zeros((b, d, n), dtype=torch.float32, device=dev)
         if h0 is None else h0.float())
    if s == 0:
        return torch.zeros((b, 0, d), dtype=torch.float32, device=dev), h
    L = min(chunk, s)
    pad = (-s) % L

    def padded(t):
        t = t.float()
        if not pad:
            return t
        shape = list(t.shape)
        shape[1] = pad
        return torch.cat([t, t.new_zeros(shape)], 1)

    x, dt, bmat, cmat = (padded(t) for t in (x, dt[..., None], bmat, cmat))
    a = a.float()
    ones = torch.ones((b, 1, d, n), dtype=scan_dtype, device=dev)
    ys = []
    for lo in range(0, s + pad, L):
        dtj, bj, xj, cj = (t[:, lo:lo + L] for t in (dt, bmat, x, cmat))
        da = torch.exp(dtj[..., None] * a[None, None])           # [B,L,D,N]
        dbx = dtj[..., None] * bj[:, :, None, :] * xj[..., None]
        aa = torch.cat([ones, da.to(scan_dtype)], 1)
        bb = torch.cat([h[:, None].to(scan_dtype), dbx.to(scan_dtype)], 1)
        _, hs = associative_scan([aa, bb], 1)
        ys.append(torch.einsum("bldn,bln->bld", hs[:, 1:].float(), cj))
        h = hs[:, -1].float()
    return torch.cat(ys, 1)[:, :s], h
