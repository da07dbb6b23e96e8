"""Hierarchical tier stack (paper §IX), PyTorch port of `repro.store.tiers`.

Every live key resides in EXACTLY ONE tier:

  hot    fixed-slot hash (`core.hashtable.FixedHash`) with a per-entry
         policy-metadata plane (`core.layout.policy_arrays`)
  warm   the deterministic skiplist (field `cold`, the reference's name)
  cold   `SpillTier` (depth 3 only): append-only sorted runs, probed by a
         per-run binary search over the `core.layout.run_offsets` plane,
         compacted when tombstones pass 1/4 of the appended total or the
         run count nears `MAX_SPILL_RUNS`

The reference places the spill planes in pinned host memory on a TPU
(`_pin_spill_host`); the port has no counterpart: the planes stay in
device memory beside the other tiers, which the card's 80 GB holds at the
slice's sizes.

Probe execution (`fused`, default True): one `exec.tier_apply` dispatch
for the insert phase and one `exec.tier_find` dispatch for the FIND
phase, 2 per apply whatever the depth; `fused=False` keeps the
dispatch-per-tier chain with bit-identical results and residency. The
warm walk (`warm_layout`) is the level-major fan-out-4 walk or the
block-major B-skiplist walk (`tiered3/b128`), another execution knob with
the same results and residency.

Policies (`none` | `lru` | `size`), eviction capped at the lower tiers'
free headroom, promotion of warm/spill-served FIND lanes, `flush`, and the
merged ordered `scan` follow the reference term by term. Every tier
configuration gives the same results as the flat `det_skiplist` backend
for the same plan stream.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import det_skiplist as dsl
from repro_torch.core import hashtable as ht
from repro_torch.core.bits import EMPTY, KEY_INF, dup_in_run, ordered
from repro_torch.core.layout import (SpillLayout, hash_slot, inverse_perm,
                                     policy_arrays, pow2_floor,
                                     resolve_device, scatter_drop,
                                     spill_arrays)
from repro_torch.kernels.tier_apply.ref import hot_insert_evict
from repro_torch.kernels.tier_find.ref import spill_run_cells
from repro_torch.store import exec as exec_
from repro_torch.store import obs
from repro_torch.store.api import (OP_DELETE, OP_FIND, OP_INSERT, OpPlan,
                                   get_backend, register, uniform_stats)
from repro_torch.store.backends import finalize_results

POLICIES = ("none", "lru", "size")


class SpillTier(NamedTuple):
    """Cold spill tier: append-only sorted runs."""
    keys: torch.Tensor       # [S] int64 (u64 bits), KEY_INF pad
    vals: torch.Tensor       # [S] int64
    dead: torch.Tensor       # [S] bool tombstones
    run_start: torch.Tensor  # [S] bool, True at the first entry of a run
    n: torch.Tensor          # () int32 append cursor
    n_dead: torch.Tensor     # () int32


def spill_init(capacity: int, *, device) -> SpillTier:
    keys, vals, dead, run_start = spill_arrays(capacity, device=device)
    z = torch.tensor(0, dtype=torch.int32, device=device)
    return SpillTier(keys=keys, vals=vals, dead=dead, run_start=run_start,
                     n=z, n_dead=z.clone())


def spill_append(sp: SpillTier, keys, vals, mask):
    """Append the masked lanes as ONE sorted run (in-batch duplicates keep
    the first lane); lanes past capacity are dropped. Returns
    (sp', appended[K])."""
    S = sp.keys.shape[0]
    dev = keys.device
    mask = mask & (keys != KEY_INF)
    order = torch.argsort(ordered(keys), stable=True)
    sk, sv, sm = keys[order], vals[order], mask[order]
    same = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                      sk[1:] == sk[:-1]])
    put = sm & ~dup_in_run(same, sm)
    rank = torch.cumsum(put.to(torch.int32), 0, dtype=torch.int32) - 1
    ok = put & (sp.n + rank < S)
    dest = torch.where(ok, sp.n + rank, S)
    cnt = ok.sum().to(torch.int32)
    rs = scatter_drop(sp.run_start, torch.where(cnt > 0, sp.n, S).reshape(1),
                      True)
    obs.record("spill_appends", lambda: ok.sum())
    sp2 = sp._replace(keys=scatter_drop(sp.keys, dest, sk),
                      vals=scatter_drop(sp.vals, dest, sv), run_start=rs,
                      n=sp.n + cnt)
    return sp2, ok[inverse_perm(order).long()]


def spill_compact(sp: SpillTier) -> SpillTier:
    """Merge the runs: drop tombstones and rewrite the live entries as ONE
    sorted run."""
    live = ~sp.dead & (sp.keys != KEY_INF)
    skey = torch.where(live, sp.keys, KEY_INF)
    o = torch.argsort(ordered(skey), stable=True)
    n_live = live.sum().to(torch.int32)
    rs = torch.zeros_like(sp.run_start)
    rs[0] = n_live > 0
    return SpillTier(keys=skey[o], vals=torch.where(live, sp.vals, 0)[o],
                     dead=torch.zeros_like(sp.dead), run_start=rs, n=n_live,
                     n_dead=torch.zeros_like(sp.n_dead))


def spill_discard(sp: SpillTier, keys, mask):
    """Tombstone live matches (DELETE and promotion); in-batch duplicate
    lanes dedupe by cell. Returns (sp', hit[K])."""
    S = sp.keys.shape[0]
    dev = keys.device
    hit, at = spill_run_cells(sp.keys, sp.dead, sp.run_start, sp.n, keys)
    found = hit & mask & (keys != KEY_INF)
    cell = torch.where(found, at, S)
    o = torch.argsort(cell, stable=True)
    cs = cell[o]
    fdup = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                      cs[1:] == cs[:-1]]) & found[o]
    eff = found & ~fdup[inverse_perm(o).long()]
    nd = scatter_drop(sp.dead, torch.where(eff, cell, S), True)
    return sp._replace(dead=nd, n_dead=sp.n_dead
                       + eff.sum().to(torch.int32)), eff


def spill_maintain(sp: SpillTier) -> SpillTier:
    """Compact when tombstones pass 1/COMPACT_DEAD_FRAC of the appended
    total, or when the next apply could push the live run count past
    MAX_RUNS."""
    churn = sp.n_dead * SpillLayout.COMPACT_DEAD_FRAC > sp.n
    runs = sp.run_start.to(torch.int32).sum()
    if bool(churn | (runs + SpillLayout.RUNS_PER_APPLY > SpillLayout.MAX_RUNS)):
        return spill_compact(sp)
    return sp


class TierState(NamedTuple):
    hot: ht.FixedHash            # fixed-slot table (the fast tier)
    hot_meta: torch.Tensor       # [M, B] int32 policy metadata
    clock: torch.Tensor          # () int32 batch clock
    n_evict: torch.Tensor        # () int64 cumulative evictions
    n_promote: torch.Tensor      # () int64 cumulative promotions
    cold: dsl.DetSkiplist        # warm ordered tier
    spill: Optional[SpillTier]   # cold spill runs; None on 2-tier stacks


class TieredBackend:
    """The tier stack behind `hash+skiplist` (depth 2) and
    `tiered3[/lru|/size|/b128]` (depth 3)."""

    ordered = True
    kernelized = True      # fused tier_find / tier_apply -> kernels

    def __init__(self, depth: int = 2, policy: str = "none",
                 fused: bool = True, warm_layout: str = "level"):
        if depth not in (2, 3):
            raise ValueError("depth must be 2 (hash->skiplist) or 3 (+spill)")
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}")
        if warm_layout not in ("level", "block"):
            raise ValueError("warm_layout must be 'level' or 'block'")
        self.depth = depth
        self.policy = policy
        self.fused = fused
        self.warm_layout = warm_layout
        base = "hash+skiplist" if depth == 2 else "tiered3"
        name = base if policy == "none" else f"{base}/{policy}"
        self.name = name + ("/b128" if warm_layout == "block" else "")

    def init(self, capacity: int, hot_bucket: int = 8, hot_frac: int = 8,
             spill_cap: int | None = None, device="cuda",
             **kw) -> TierState:
        """Warm tier sized at `capacity`; hot tier at ~capacity/hot_frac
        cells; depth-3 spill runs at `spill_cap` (default `capacity`)."""
        dev = resolve_device(device)
        hot_slots = pow2_floor(max(capacity // (hot_frac * hot_bucket), 1))
        z32 = torch.tensor(0, dtype=torch.int32, device=dev)
        z64 = torch.tensor(0, dtype=torch.int64, device=dev)
        return TierState(
            hot=ht.fixed_init(hot_slots, hot_bucket, device=dev),
            hot_meta=policy_arrays((hot_slots, hot_bucket), device=dev),
            clock=z32, n_evict=z64, n_promote=z64.clone(),
            cold=dsl.skiplist_init(capacity, device=dev),
            spill=(spill_init(capacity if spill_cap is None else spill_cap,
                              device=dev) if self.depth == 3 else None))

    # -- tier movement helpers ----------------------------------------------

    def _demote(self, cold, spill, keys, vals, mask):
        """Push lanes down: warm first, then the spill runs (depth 3) or
        drop (depth 2)."""
        with obs.span("demote", backend=self.name):
            cold, ok_c, ex_c = dsl.insert_batch(cold, keys, vals, mask)
            ok = ok_c | ex_c
            if spill is not None:
                spill, ok_s = spill_append(spill, keys, vals, mask & ~ok)
                ok = ok | ok_s
            obs.record("demotions", lambda: (ok & mask).sum())
        return cold, spill, ok

    def _record_probe_cost(self, cold, spill, queries):
        """`warm_probe_steps` / `spill_runs_searched` of one lower-tier
        probe phase, from the probe inputs."""
        if not obs.collecting():
            return
        lanes = (queries != KEY_INF).sum()
        obs.record("warm_probe_steps", lanes * (cold.num_levels + 1))
        if spill is not None:
            live = torch.arange(spill.run_start.shape[0],
                                device=queries.device) < spill.n
            obs.record("spill_runs_searched",
                       lanes * (spill.run_start & live).sum())

    def _warm_find(self, cold, queries):
        """The unfused warm probe in the stack's layout."""
        if self.warm_layout == "block":
            return exec_.bskiplist_find(cold, queries)
        return exec_.skiplist_find(cold, queries)

    def _headroom(self, cold, spill):
        """Free lower-tier slots = the eviction budget."""
        free = cold.term_keys.shape[0] - cold.n_term
        if spill is not None:
            free = free + (spill.keys.shape[0] - spill.n)
        return free

    # -- apply ---------------------------------------------------------------

    def apply(self, state: TierState, plan: OpPlan):
        hot, meta, clock = state.hot, state.hot_meta, state.clock
        cold, spill = state.cold, state.spill
        n_evict, n_promote = state.n_evict, state.n_promote
        ops, keys, vals = plan.ops, plan.keys, plan.vals
        K = keys.shape[0]
        dev = keys.device
        valid = plan.mask & (ops >= 0)
        ins_m = valid & (ops == OP_INSERT)
        del_m = valid & (ops == OP_DELETE)
        qk = torch.where(valid, keys, KEY_INF)
        zb = torch.zeros(K, dtype=torch.bool, device=dev)

        # INSERTS: insert-if-absent across ALL tiers; lanes absent
        # everywhere try hot first, the rest fall down
        with obs.span("insert", backend=self.name):
            ins_k = torch.where(ins_m, keys, KEY_INF)
            self._record_probe_cost(cold, spill, ins_k)
            if self.fused:
                (hot, meta, in_cold, in_spill, ins_hot, ex_hot,
                 ev_k, ev_v, ev_m) = exec_.tier_apply(
                    hot, meta, clock, cold, spill, keys, vals, ins_m,
                    self.policy, self._headroom(cold, spill),
                    warm_layout=self.warm_layout)
                try_hot = ins_m & ~in_cold & ~in_spill
            else:
                in_cold = self._warm_find(cold, ins_k)[0]
                in_spill = (exec_.spill_find(spill, ins_k)[0]
                            if spill is not None else zb)
                try_hot = ins_m & ~in_cold & ~in_spill
                (hot, meta, ins_hot, ex_hot,
                 ev_k, ev_v, ev_m) = exec_.hot_update(
                    hot, meta, clock, keys, vals, try_hot, self.policy,
                    self._headroom(cold, spill))
            if self.policy != "none":
                n_evict = n_evict + ev_m.sum()
                obs.record("evictions", lambda: ev_m.sum())
                # victims demote first: the eviction cap guarantees they fit
                cold, spill, _ = self._demote(cold, spill, ev_k, ev_v, ev_m)
            down = try_hot & ~ins_hot & ~ex_hot
            cold, spill, down_ok = self._demote(
                cold, spill, torch.where(down, keys, KEY_INF), vals, down)
            inserted = ins_hot | down_ok
            existed = ex_hot | in_cold | in_spill

        # DELETES: single-tier residency means exactly one tier can hit
        with obs.span("delete", backend=self.name):
            hot, del_hot = ht.fixed_delete(hot, keys, del_m)
            cold, del_cold = dsl.delete_batch(cold, keys, del_m & ~del_hot)
            if spill is not None:
                spill, del_spill = spill_discard(
                    spill, keys, del_m & ~del_hot & ~del_cold)
            else:
                del_spill = zb
            deleted = del_hot | del_cold | del_spill

        # FINDS observe the post-update state of every tier
        with obs.span("find", backend=self.name):
            self._record_probe_cost(cold, spill, qk)
            if self.fused:
                ((f_hot, v_hot, c_hot), (f_cold, v_cold),
                 (f_spill, v_spill)) = exec_.tier_find(
                    hot, cold, spill, qk, warm_layout=self.warm_layout)
            else:
                f_hot, v_hot, c_hot = exec_.hash_find_cols(hot, qk)
                f_cold, v_cold, _ = self._warm_find(cold, qk)
                if spill is not None:
                    f_spill, v_spill = exec_.spill_find(spill, qk)
                else:
                    f_spill = zb
                    v_spill = torch.zeros(K, dtype=torch.int64, device=dev)
            fnd_m = valid & (ops == OP_FIND)
            obs.record("hot_hits", lambda: (fnd_m & f_hot).sum())
            obs.record("warm_hits", lambda: (fnd_m & f_cold).sum())
            obs.record("spill_hits", lambda: (fnd_m & f_spill).sum())
            obs.record("bucket_collisions",
                       lambda: obs.bucket_collision_count(hot, qk))
            found = f_hot | f_cold | f_spill
            fvals = torch.where(f_hot, v_hot,
                                torch.where(f_cold, v_cold, v_spill))
            if self.policy == "lru":
                touch = fnd_m & f_hot
                tslots = hash_slot(qk, hot.num_slots)
                cell = torch.where(touch, tslots * hot.bucket + c_hot,
                                   hot.keys.numel())
                meta = scatter_drop(meta.reshape(-1), cell,
                                    clock.to(torch.int32).expand(K)
                                    ).reshape(meta.shape)

        # PROMOTION (after the linearization point; membership-neutral)
        with obs.span("promote", backend=self.name):
            prom = valid & (ops == OP_FIND) & found & ~f_hot
            pv = torch.where(f_cold, v_cold, v_spill)
            if self.policy == "none":
                hot, prom_ok, _ = ht.fixed_insert(hot, keys, pv, prom)
            else:
                (hot, meta, prom_ok, _,
                 ev_k, ev_v, ev_m) = hot_insert_evict(
                    hot, meta, clock, keys, pv, prom, self.policy,
                    self._headroom(cold, spill))
                n_evict = n_evict + ev_m.sum()
                obs.record("evictions", lambda: ev_m.sum())
                cold, spill, _ = self._demote(cold, spill, ev_k, ev_v, ev_m)
            n_promote = n_promote + prom_ok.sum()
            obs.record("promotions", lambda: prom_ok.sum())
            cold, _ = dsl.delete_batch(cold, keys, prom & prom_ok & f_cold)
            if spill is not None:
                spill, _ = spill_discard(spill, keys, prom & prom_ok & f_spill)

        # spill-run maintenance (churn threshold + the static run cap)
        if spill is not None:
            with obs.span("compact", backend=self.name):
                pre_dead = spill.n_dead
                spill = spill_maintain(spill)
                obs.record("tombstones_reclaimed",
                           lambda: pre_dead - spill.n_dead)

        state2 = TierState(hot=hot, hot_meta=meta, clock=clock + 1,
                           n_evict=n_evict, n_promote=n_promote,
                           cold=cold, spill=spill)
        return state2, finalize_results(ops, valid, found, fvals, inserted,
                                        existed, deleted)

    # -- ordered scan over all tiers -----------------------------------------

    def scan(self, state: TierState, lo, hi, max_out: int):
        cnt_c, k_c, v_c, val_c = dsl.range_query(state.cold, lo, hi, max_out)
        olo, ohi = ordered(lo)[:, None], ordered(hi)[:, None]

        def tier_rows(tk, tv, live):
            """In-range count + per-query sorted top-max_out of a flat
            (keys, vals, live) tier view."""
            otk = ordered(tk)[None, :]
            in_r = (otk >= olo) & (otk < ohi) & live[None, :]
            cnt = in_r.sum(dim=1).to(cnt_c.dtype)
            sk = torch.where(in_r, tk[None, :], KEY_INF)
            o = torch.argsort(ordered(sk), dim=1, stable=True)[:, :max_out]
            return (cnt, sk.gather(1, o),
                    tv[None, :].expand(sk.shape).gather(1, o))

        hk = state.hot.keys.reshape(-1)
        cnt_h, hkeys, hvals = tier_rows(hk, state.hot.vals.reshape(-1),
                                        hk != EMPTY)
        count = cnt_c + cnt_h
        parts_k = [torch.where(val_c, k_c, KEY_INF), hkeys]
        parts_v = [torch.where(val_c, v_c, 0), hvals]
        if state.spill is not None:
            sp = state.spill
            cnt_s, skeys, svals = tier_rows(sp.keys, sp.vals,
                                            ~sp.dead & (sp.keys != KEY_INF))
            count = count + cnt_s
            parts_k.append(skeys)
            parts_v.append(svals)
        allk = torch.cat(parts_k, dim=1)
        allv = torch.cat(parts_v, dim=1)
        om = torch.argsort(ordered(allk), dim=1, stable=True)[:, :max_out]
        keys = allk.gather(1, om)
        return count, keys, allv.gather(1, om), keys != KEY_INF

    # -- movement / stats ----------------------------------------------------

    def flush(self, state: TierState) -> TierState:
        """Bulk demotion of every hot entry into warm (spill absorbs warm
        overflow on depth 3); entries the lower tiers cannot absorb stay
        hot with their metadata. Clock and movement counters persist."""
        with obs.span("flush", backend=self.name):
            shape = state.hot.keys.shape
            hk = state.hot.keys.reshape(-1)
            hv = state.hot.vals.reshape(-1)
            cold, spill, ok = self._demote(state.cold, state.spill, hk, hv,
                                           hk != EMPTY)
            if spill is not None:
                with obs.span("compact", backend=self.name):
                    pre_dead = spill.n_dead
                    spill = spill_maintain(spill)
                    obs.record("tombstones_reclaimed",
                               lambda: pre_dead - spill.n_dead)
            keep = (hk != EMPTY) & ~ok
            hot = state.hot._replace(
                keys=torch.where(keep, hk, EMPTY).reshape(shape),
                vals=torch.where(keep, hv, 0).reshape(shape),
                count=keep.sum())
            meta = torch.where(keep.reshape(shape), state.hot_meta, 0)
        return state._replace(hot=hot, hot_meta=meta, cold=cold, spill=spill)

    def stats(self, state: TierState):
        hot_size = state.hot.count.to(torch.int64)
        cold_size = (state.cold.n_term - state.cold.n_marked).to(torch.int64)
        spill_size = spill_dead = 0
        capacity = state.hot.keys.numel() + state.cold.term_keys.shape[0]
        if state.spill is not None:
            spill_size = (state.spill.n - state.spill.n_dead).to(torch.int64)
            spill_dead = state.spill.n_dead.to(torch.int64)
            capacity += state.spill.keys.shape[0]
        return uniform_stats(
            size=hot_size + cold_size + spill_size, hot_size=hot_size,
            cold_size=cold_size, spill_size=spill_size,
            tombstones=state.cold.n_marked + spill_dead,
            evictions=state.n_evict, promotions=state.n_promote,
            capacity=capacity)


def unfused_twin(name: str) -> TieredBackend:
    """A `fused=False` twin of a registered tier config."""
    be = get_backend(name)
    if not isinstance(be, TieredBackend):
        raise ValueError(f"{name!r} is not a tier stack")
    return TieredBackend(depth=be.depth, policy=be.policy, fused=False,
                         warm_layout=be.warm_layout)


HASH_SKIPLIST = register(TieredBackend())
TIERED3 = register(TieredBackend(depth=3))
TIERED3_LRU = register(TieredBackend(depth=3, policy="lru"))
TIERED3_SIZE = register(TieredBackend(depth=3, policy="size"))
TIERED3_B128 = register(TieredBackend(depth=3, warm_layout="block"))
