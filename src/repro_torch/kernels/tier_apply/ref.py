"""Plain PyTorch versions for the fused tier apply.

* `hot_insert_evict` — the policy-driven hot-tier insert (empties first,
  then victims in policy order, evictions capped at `max_evict`). It IS
  the unfused write path: `store.exec.hot_update` and the tier stack's
  promotion call it.
* `tier_apply_ref` — the fused-apply prologue at state level: lower-tier
  membership with the fall-through masking of `store.exec.tier_find`,
  then the hot insert. What the `torch` exec mode runs.
* `tier_apply_planes_ref` — the kernel on its planes, term by term with
  the reference kernel body: nine outputs in sorted (slot, key) lane
  order.
"""
from __future__ import annotations

import torch

from repro_torch.core import hashtable as ht
from repro_torch.core.bits import EMPTY, KEY_INF
from repro_torch.core.layout import (BSkiplistLayout, SkiplistLayout,
                                     SpillLayout, first_true, scatter_drop,
                                     val_weight)
from repro_torch.kernels.hash_probe.ref import hash_probe_ref
from repro_torch.kernels.tier_find.ref import (spill_run_probe_ref,
                                               tier_find_ref, warm_walk_ref)

POLICY_CODES = {"none": 0, "lru": 1, "size": 2}
_I32_MAX = 2**31 - 1


def _policy_scores(metar, empty, policy: str):
    """Evict-first score row: lru = oldest stamp, size = largest weight
    (negated); empty cells rank last."""
    score = metar if policy == "lru" else -metar
    return torch.where(~empty, score, _I32_MAX).to(torch.int32)


def hot_insert_evict(hot: ht.FixedHash, meta, clock, keys, vals, mask,
                     policy: str, max_evict):
    """Insert-if-absent into the hot tier, evicting policy victims from
    full buckets (pre-batch contents only; at most `max_evict` lanes
    evict). Returns (hot', meta', placed[K], existed[K], ev_key[K],
    ev_val[K], ev_mask[K])."""
    K = keys.shape[0]
    M, B = hot.num_slots, hot.bucket
    p = ht.bucket_insert_plan(hot, keys, vals, mask)
    ssl = p.ss.long()
    vrows = hot.vals[ssl]
    empty = p.rows == EMPTY
    n_empty = empty.sum(dim=1).to(torch.int32)
    ev_rank = p.rank - n_empty
    vorder = torch.argsort(_policy_scores(meta[ssl], empty, policy), dim=1,
                           stable=True)
    vcol = vorder.gather(1, torch.clamp(ev_rank, 0, B - 1).long()[:, None])
    vcol = vcol[:, 0].to(torch.int32)
    need_ev = p.cand & ~p.fit_e & (ev_rank < (~empty).sum(dim=1))
    need_ev = need_ev & (torch.cumsum(need_ev.to(torch.int32), 0,
                                      dtype=torch.int32) - 1 < max_evict)
    ev_key = p.rows.gather(1, vcol.long()[:, None])[:, 0]
    ev_val = vrows.gather(1, vcol.long()[:, None])[:, 0]

    placed = (p.cand & p.fit_e) | need_ev
    col = torch.where(p.fit_e, p.col_e, vcol)
    flat = torch.where(placed, p.ss * B + col, M * B)
    nk = scatter_drop(hot.keys.reshape(-1), flat, p.sk).reshape(M, B)
    nv = scatter_drop(hot.vals.reshape(-1), flat, p.sv).reshape(M, B)
    stamp = (clock.to(torch.int32).expand(K) if policy == "lru"
             else val_weight(p.sv))
    nm = scatter_drop(meta.reshape(-1), flat, stamp)
    if policy == "lru":
        # an INSERT that finds its key hot-resident refreshes its stamp
        ecol = first_true(p.rows == p.sk[:, None])
        eflat = torch.where(p.exists, p.ss * B + ecol, M * B)
        nm = scatter_drop(nm, eflat, stamp)
    hot2 = ht.FixedHash(keys=nk, vals=nv,
                        count=hot.count + (p.cand & p.fit_e).sum())
    inv = p.inv.long()
    return (hot2, nm.reshape(M, B), placed[inv], (p.exists | p.dup)[inv],
            ev_key[inv], ev_val[inv], need_ev[inv])


def _empty_apply(hot, meta, keys):
    zb = torch.zeros(0, dtype=torch.bool, device=keys.device)
    z64 = torch.zeros(0, dtype=torch.int64, device=keys.device)
    return hot, meta, zb, zb, zb, zb, z64, z64, zb


def tier_apply_ref(hot, meta, clock, cold, spill, keys, vals, mask,
                   policy: str, max_evict, warm_layout: str = "level"):
    """The fused-apply prologue at state level. Returns (hot', meta',
    in_warm[K], in_spill[K], ins[K], exists[K], ev_key[K], ev_val[K],
    ev_mask[K]); `warm_layout` picks the warm membership walk."""
    K = keys.shape[0]
    if K == 0:
        return _empty_apply(hot, meta, keys)
    qk = torch.where(mask, keys, KEY_INF)
    (f_hot, _, _), (f_warm, _), (f_sp, _) = tier_find_ref(
        hot, cold, spill, qk, warm_layout)
    in_warm = f_warm & ~f_hot
    in_spill = f_sp & ~f_hot & ~f_warm
    try_hot = mask & ~in_warm & ~in_spill
    if policy == "none":
        hot2, ins, exists = ht.fixed_insert(hot, keys, vals, try_hot)
        z64 = torch.zeros(K, dtype=torch.int64, device=keys.device)
        return (hot2, meta, in_warm, in_spill, ins, exists, z64, z64,
                torch.zeros(K, dtype=torch.bool, device=keys.device))
    hot2, meta2, ins, exists, ev_k, ev_v, ev_m = hot_insert_evict(
        hot, meta, clock, keys, vals, try_hot, policy, max_evict)
    return hot2, meta2, in_warm, in_spill, ins, exists, ev_k, ev_v, ev_m


def tier_apply_planes_ref(sk, ss, sm, krs, srs, hot_keys, meta,
                          warm: SkiplistLayout | BSkiplistLayout, max_evict,
                          spill: SpillLayout | None, policy: str):
    """The fused kernel on its planes. sk: [K] int64 keys in sorted
    (slot, key) lane order; ss/krs/srs: [K] int32 (slot, key-run start,
    slot-run start); sm: [K] int8 insert mask; hot_keys/meta: [M, B];
    max_evict: [1] int32. Returns (in_warm, in_spill, placed, exists, dup,
    need_ev) int8 and (col, vcol, ecol) int32."""
    k = sk.shape[0]
    m, b = hot_keys.shape
    dev = sk.device
    smb = sm != 0
    mq = torch.where(smb, sk, KEY_INF)

    # membership compose + fall-through
    f_hot = hash_probe_ref(mq, ss, hot_keys)[0].bool() & smb
    f_warm = warm_walk_ref(mq, warm)[0].bool() & smb
    if spill is not None:
        f_sp = spill_run_probe_ref(mq, spill.keys, spill.dead,
                                   spill.run_off)[0] & smb
    else:
        f_sp = torch.zeros(k, dtype=torch.bool, device=dev)
    in_warm = f_warm & ~f_hot
    in_spill = f_sp & ~f_hot & ~f_warm
    sm_ins = smb & ~in_warm & ~in_spill
    smi = sm_ins.to(torch.int32)

    # in-batch duplicate rank within the (slot, key) run
    krl = krs.long()
    c1 = torch.cumsum(smi, 0, dtype=torch.int32)
    dup = sm_ins & ((c1 - smi - (c1[krl] - smi[krl])) > 0)

    # pre-batch bucket rows: existence, empties, victims
    ssc = torch.clamp(ss, 0, m - 1).long()
    rows = hot_keys[ssc]
    hit_e = rows == sk[:, None]
    ecol = first_true(hit_e)
    exists = sm_ins & hit_e.any(dim=1) & ~dup
    cand = sm_ins & ~dup & ~exists

    # within-slot candidate rank
    ci = cand.to(torch.int32)
    c2 = torch.cumsum(ci, 0, dtype=torch.int32)
    before_s = torch.where(srs > 0, c2[torch.clamp(srs - 1, min=0).long()], 0)
    rank = c2 - before_s - ci

    # nth-empty placement column
    empty = rows == KEY_INF
    cum_e = torch.cumsum(empty.to(torch.int32), 1, dtype=torch.int32)
    hit_n = empty & (cum_e == rank[:, None] + 1)
    fit_e = hit_n.any(dim=1)
    col_e = torch.where(fit_e, first_true(hit_n), b).to(torch.int32)

    if policy != "none":
        n_empty = empty.sum(dim=1).to(torch.int32)
        ev_rank = rank - n_empty
        score = _policy_scores(meta[ssc], empty, policy)
        # counting rank of column j: #{q: (score_q, q) < (score_j, j)}
        iota = torch.arange(b, device=dev)
        sj, sq = score[:, :, None], score[:, None, :]
        less = (sq < sj) | ((sq == sj) & (iota[None, None, :]
                                          < iota[None, :, None]))
        pos = less.sum(dim=2)
        tgt = torch.clamp(ev_rank, 0, b - 1)
        vcol = first_true(pos == tgt[:, None])
        need_ev = cand & ~fit_e & (ev_rank < b - n_empty)
        need_ev = need_ev & (torch.cumsum(need_ev.to(torch.int32), 0,
                                          dtype=torch.int32) - 1
                             < max_evict.reshape(-1)[0])
    else:
        vcol = torch.zeros(k, dtype=torch.int32, device=dev)
        need_ev = torch.zeros(k, dtype=torch.bool, device=dev)

    placed = (cand & fit_e) | need_ev
    col = torch.where(fit_e, col_e, vcol)
    i8 = torch.int8
    return (in_warm.to(i8), in_spill.to(i8), placed.to(i8), exists.to(i8),
            dup.to(i8), need_ev.to(i8), col.to(torch.int32), vcol, ecol)
