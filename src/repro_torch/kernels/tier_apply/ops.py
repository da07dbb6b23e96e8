"""Glue: tier-stack state -> ONE fused tier_apply dispatch.

The host side owns everything sort-shaped and every scatter, as in the
reference: the (slot, key) lane sort and its key-run / slot-run starts
(mask-independent, so computed before the kernel decides membership), the
victim gathers, and the key / value / metadata scatters, copied term for
term from `ref.hot_insert_evict` / `core.hashtable.fixed_insert`."""
from __future__ import annotations

import torch

from repro_torch.core import hashtable as ht
from repro_torch.core.bits import EMPTY
from repro_torch.core.layout import (BSkiplistLayout, SkiplistLayout,
                                     hash_slot, inverse_perm, scatter_drop,
                                     spill_layout, val_weight)
from repro_torch.kernels.tier_apply.kernel import tier_apply_tiles
from repro_torch.kernels.tier_apply.ref import _empty_apply


def sorted_lanes(num_slots: int, keys, vals, mask):
    """The (slot, key) lane sort of one insert batch: returns (inv, ss,
    sk, sv, sm, krs, srs) — inverse permutation, sorted slots / keys /
    vals, int8 insert mask, key-run and slot-run starts (int32)."""
    k = keys.shape[0]
    dev = keys.device
    m_eff = mask & (keys != EMPTY)
    slots = hash_slot(keys, num_slots)
    order = ht._lex_sort_slots_keys(slots, keys)
    ss, sk, sv, sm = slots[order], keys[order], vals[order], m_eff[order]
    idx = torch.arange(k, dtype=torch.int32, device=dev)
    same = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                      (sk[1:] == sk[:-1]) & (ss[1:] == ss[:-1])])
    krs = torch.cummax(torch.where(~same, idx, -1), 0).values.to(torch.int32)
    srs = torch.searchsorted(ss, ss, out_int32=True)
    return (inverse_perm(order).long(), ss.contiguous(), sk.contiguous(), sv,
            sm.to(torch.int8), krs, srs)


def tier_apply_fused(hot, meta, clock, cold, spill, keys, vals, mask,
                     policy: str, max_evict,
                     warm: SkiplistLayout | BSkiplistLayout):
    """One dispatch over the whole apply prologue; the same 9-tuple as
    `ref.tier_apply_ref`. `warm` is the warm tier's view, which picks the
    warm membership walk (`core.layout.warm_layout_of`)."""
    K = keys.shape[0]
    M, B = hot.num_slots, hot.bucket
    dev = keys.device
    if K == 0:
        return _empty_apply(hot, meta, keys)

    inv, ss, sk, sv, sm, krs, srs = sorted_lanes(M, keys, vals, mask)
    max_ev = torch.as_tensor(max_evict, device=dev).to(torch.int32).reshape(1)
    sp = (None if spill is None else
          spill_layout(spill.keys, spill.dead, spill.run_start, spill.n))
    out = tier_apply_tiles(sk, ss, sm, krs, srs, hot.keys.contiguous(),
                           meta.contiguous(), warm, max_ev, sp, policy)
    in_warm, in_spill, placed, exists, dup, need_ev = (o.bool()
                                                       for o in out[:6])
    col, vcol, ecol = out[6:]

    ssl = ss.long()
    if policy == "none":
        ev_key = torch.zeros(K, dtype=torch.int64, device=dev)
        ev_val = torch.zeros(K, dtype=torch.int64, device=dev)
    else:
        ev_key = hot.keys[ssl, vcol.long()]
        ev_val = hot.vals[ssl, vcol.long()]

    flat = torch.where(placed, ss * B + col, M * B)
    nk = scatter_drop(hot.keys.reshape(-1), flat, sk).reshape(M, B)
    nv = scatter_drop(hot.vals.reshape(-1), flat, sv).reshape(M, B)
    nm = meta
    if policy != "none":
        stamp = (clock.to(torch.int32).expand(K) if policy == "lru"
                 else val_weight(sv))
        nm = scatter_drop(meta.reshape(-1), flat, stamp)
        if policy == "lru":
            eflat = torch.where(exists, ss * B + ecol, M * B)
            nm = scatter_drop(nm, eflat, stamp)
        nm = nm.reshape(M, B)
    hot2 = ht.FixedHash(keys=nk, vals=nv,
                        count=hot.count + (placed & ~need_ev).sum())
    return (hot2, nm, in_warm[inv], in_spill[inv], placed[inv],
            (exists | dup)[inv], ev_key[inv], ev_val[inv], need_ev[inv])
