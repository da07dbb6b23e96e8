"""ResilientEngine: fault detection + deterministic recovery over a
`store.engine.StoreEngine` (counterpart of
`repro.store.resilience.restore`).

Each step runs the fault-tolerance loop:

  1. **snapshot cadence** — every `snapshot_every` steps (of a healthy
     state), `journal.take_snapshot` copies the state to the host.
  2. **write-ahead journal** — the caller's plan is journaled before the
     wire, so in-flight corruption is repaired from intent.
  3. **inject** — the seeded `FaultPlan`'s faults for this seq (shard
     zeroed / wire op poisoned / stall ticks).
  4. **detect** — poisoned lanes via `sanitize_ops` (repaired from the
     journaled intent, counted in `retries`); dead shards via the health
     epoch (`state_alive`).
  5. **recover** — the dead shard is rebuilt from the latest snapshot
     plus the journal tail, under the `"recover"` trace span.

Two recovery modes:

* ``sync`` (default) — the rebuild completes inside the detecting step,
  and the rebuilt shard equals the fault-free shard, state and metrics
  plane: per-shard replay selects the shard's lanes by owner in global
  lane order, pads them to the engine's pool and records the routed-op
  counters by hand, which for distinct keys is what the engine computed.
* ``degraded`` — healthy shards keep serving while the dead shard
  replays `replay_per_tick` journal entries a step. Lanes owned by the
  dead shard are deferred (masked to OP_NONE, so callers see ok=False at
  their seq) and applied as journaled catch-up steps once the rebuild is
  done; their true results land in `self.completions[(seq, lane)]`,
  equal to the fault-free answers (per-shard linearization), while the
  state's batch clocks shift: results equal, digests not.

The resilience tally (`obs.RESILIENCE_SCHEMA`) is host-side and merged
into the read-side `metrics()` view by `obs.merge_resilience`.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import List, Optional

import numpy as np
import torch

from repro_torch.store import exec as exec_
from repro_torch.store import obs
from repro_torch.store.api import OP_NONE, OpPlan
from repro_torch.store.resilience import faults as F
from repro_torch.store.resilience import journal as J


def _np_owner(keys: np.ndarray, n_shards: int) -> np.ndarray:
    """Host-side `routing.owner_of` (top log2(S) bits of uint64 keys)."""
    b = int(np.log2(n_shards)) if n_shards > 1 else 0
    if b == 0:
        return np.zeros(keys.shape, np.int32)
    return (keys >> np.uint64(64 - b)).astype(np.int32)


def _make_replayer(be, mode):
    def run(state, plan):
        with exec_.exec_mode(mode):
            return be.apply(state, plan)
    return run


def rebuild_shard(be, snap: J.Snapshot, entries, shard: int, n_shards: int,
                  pool: int, exec_mode: str | None, replayer=None,
                  start: int = 0, stop: Optional[int] = None,
                  slice_state=None, *, device="cuda"):
    """Replay shard `shard`'s sub-stream of `entries[start:stop]` onto its
    snapshot state: lanes selected by owner in global lane order, padded
    (key 0, mask False) to the engine's per-shard pool, applied directly
    under `exec_mode`, with the engine's routed-op counters recorded by
    hand. Lanes beyond the pool are cut, as the router drops them.

    Returns (shard state, replayed op count). Pass `slice_state` to
    continue an incremental (degraded-mode) rebuild."""
    if slice_state is None:
        slice_state = J.copy_to(snap.state[shard], device)
    if replayer is None:
        replayer = _make_replayer(be, exec_mode)
    observed = isinstance(be, obs.ObservedStore)
    replayed = 0
    for e in entries[start:stop]:
        owner = _np_owner(e.keys, n_shards)
        sel = np.nonzero((owner == shard) & (e.ops >= 0))[0][:pool]
        n = len(sel)
        replayed += n
        p_ops = np.full(pool, OP_NONE, np.int32)
        p_keys = np.zeros(pool, np.uint64)
        p_vals = np.zeros(pool, np.uint64)
        p_ops[:n], p_keys[:n], p_vals[:n] = (e.ops[sel], e.keys[sel],
                                             e.vals[sel])
        ops, keys, vals = J.device_plan(p_ops, p_keys, p_vals, device)
        plan = OpPlan(ops=ops, keys=keys, vals=vals,
                      mask=torch.arange(pool, device=ops.device) < n)
        with obs.collect() if observed else nullcontext() as frame:
            if observed:
                obs.record("routed_ops", n)
                obs.record("routed_bytes", n * obs.ROUTED_OP_BYTES)
        slice_state, _ = replayer(slice_state, plan)
        slice_state = obs.absorb_frame(slice_state, frame)
    return slice_state, replayed


def splice_shard(state: tuple, slice_state, shard: int) -> tuple:
    """Write a rebuilt shard state back into the sharded state."""
    return tuple(slice_state if s == shard else st
                 for s, st in enumerate(state))


class _Quarantine:
    """Degraded-mode rebuild in progress for one shard."""

    __slots__ = ("shard", "snap", "entries", "pos", "slice", "replayed",
                 "deferred")

    def __init__(self, shard: int, snap: J.Snapshot, entries):
        self.shard = shard
        self.snap = snap
        self.entries = entries          # journal tail to replay
        self.pos = 0                    # next entry index
        self.slice = None               # rebuilt shard state
        self.replayed = 0
        self.deferred: List[tuple] = []  # (seq, ops, keys, vals) per step


class ResilientEngine:
    """The fault-tolerance wrapper: drop-in for `StoreEngine.step` (same
    signature and return), plus the journal/snapshot/fault machinery.

    >>> reng = ResilientEngine(eng, snapshot_every=4,
    ...                        fault_plan=make_fault_plan(seed, ...))
    >>> state, res, ok, dropped = reng.step(state, ops, keys, vals)
    >>> reng.tally["recoveries"], reng.completions   # degraded catch-ups
    """

    def __init__(self, eng, *, snapshot_every: int = 4,
                 fault_plan: Optional[F.FaultPlan] = None,
                 mode: str = "sync", replay_per_tick: int = 2):
        if mode not in ("sync", "degraded"):
            raise ValueError(f"recovery mode {mode!r}: sync | degraded")
        self.eng = eng
        self.snapshot_every = int(snapshot_every)
        self.fault_plan = fault_plan
        self.mode = mode
        self.replay_per_tick = int(replay_per_tick)
        self.journal = J.Journal(base_seq=eng.seq)
        self.snapshots: List[J.Snapshot] = []
        self.tally = obs.resilience_zero()
        self.completions = {}            # (seq, lane) -> (ok, val)
        self.stall_ticks = 0
        self.epoch = 0
        self.last_seen = np.zeros(eng.n_shards, np.int64)
        self.quarantine: Optional[_Quarantine] = None
        self._pool = eng.lanes * eng.pool_factor
        self._replayer = _make_replayer(eng.backend, eng.exec_mode)

    # -- health ---------------------------------------------------------
    @property
    def virtual_ticks(self) -> int:
        """The deadline clock: engine steps plus injected stall ticks."""
        return self.eng.seq + self.stall_ticks

    def _detect_dead(self, state) -> List[int]:
        """Advance the health epoch; shards whose liveness heartbeat lags
        the epoch are failed."""
        self.epoch += 1
        alive = F.state_alive(state, self.eng.n_shards)
        self.last_seen[alive] = self.epoch
        return [int(s) for s in np.nonzero(self.last_seen < self.epoch)[0]]

    # -- recovery -------------------------------------------------------
    def _latest_snapshot(self) -> J.Snapshot:
        if not self.snapshots:
            raise RuntimeError("shard failed before the first snapshot; "
                               "snapshot_every must cover step 0")
        return self.snapshots[-1]

    def _rebuild(self, snap, entries, shard, **kw):
        return rebuild_shard(self.eng.backend, snap, entries, shard,
                             self.eng.n_shards, self._pool,
                             self.eng.exec_mode, replayer=self._replayer,
                             device=self.eng.device, **kw)

    def _recover_sync(self, state, shard: int):
        snap = self._latest_snapshot()
        entries = self.journal.tail(snap.seq)
        with obs.span("recover", shard=shard, mode="sync",
                      replay=len(entries)):
            sl, n = self._rebuild(snap, entries, shard)
            state = splice_shard(state, sl, shard)
        self.tally["recoveries"] += 1
        self.tally["replayed_ops"] += n
        return state

    def _advance_degraded(self, state):
        q = self.quarantine
        stop = min(q.pos + self.replay_per_tick, len(q.entries))
        with obs.span("recover", shard=q.shard, mode="degraded",
                      replay=stop - q.pos):
            q.slice, n = self._rebuild(q.snap, q.entries, q.shard,
                                       start=q.pos, stop=stop,
                                       slice_state=q.slice)
            q.pos = stop
            q.replayed += n
        if q.pos < len(q.entries):
            return state
        # rebuild complete: splice, then apply the deferred lanes as
        # journaled catch-up steps (their results land in `completions`)
        state = splice_shard(state, q.slice, q.shard)
        self.tally["recoveries"] += 1
        self.tally["replayed_ops"] += q.replayed
        deferred, self.quarantine = q.deferred, None
        for dseq, dops, dkeys, dvals in deferred:
            self.journal.append(self.eng.seq, dops, dkeys, dvals)
            state, res, ok, _ = self.eng.step(
                state, *J.device_plan(dops, dkeys, dvals, self.eng.device))
            okh, vh = ok.cpu().numpy(), res.cpu().numpy()
            for lane in np.nonzero(dops >= 0)[0]:
                self.completions[(dseq, int(lane))] = (bool(okh[lane]),
                                                       int(vh[lane]))
        return state

    # -- the step -------------------------------------------------------
    def step(self, state, ops, keys, vals):
        seq = self.eng.seq
        ops_h, keys_h, vals_h = J.host_plan(ops, keys, vals)

        # 1) snapshot cadence (healthy states only: a quarantined state
        # carries a dead shard that must never become a restore point)
        if self.quarantine is None and seq % self.snapshot_every == 0:
            self.snapshots.append(J.take_snapshot(state, seq))

        # 2) write-ahead intent (the poison repair source); the wire copy
        # is what faults corrupt
        wire_ops = ops_h.copy()

        # 3) inject this step's scheduled faults
        for f in (self.fault_plan.at(seq) if self.fault_plan else []):
            self.tally["faults_injected"] += 1
            if f.kind == "poison":
                wire_ops = F.poison_ops(wire_ops, f.lane)
            elif f.kind == "shard_drop":
                state = F.inject_shard_drop(state, f.shard)
            elif f.kind == "stall":
                self.stall_ticks += f.ticks

        # 4a) detect + repair wire corruption: the journaled intent is
        # authoritative, so the repair is a re-read (one retry a lane)
        clean, poisoned = F.sanitize_ops(wire_ops)
        n_poisoned = int(np.sum(poisoned))
        if n_poisoned:
            self.tally["retries"] += n_poisoned
            wire_ops = ops_h
        else:
            wire_ops = clean

        # 4b) detect dead shards via the health epoch
        dead = self._detect_dead(state)
        if dead and self.quarantine is None:
            if self.mode == "sync":
                for s in dead:
                    state = self._recover_sync(state, s)
            else:
                snap = self._latest_snapshot()
                self.quarantine = _Quarantine(dead[0], snap,
                                              self.journal.tail(snap.seq))

        # 5) degraded mode: defer the dead shard's lanes, journal + apply
        # the masked plan, advance the background rebuild
        applied_ops = np.asarray(wire_ops, np.int32)
        if self.quarantine is not None:
            q = self.quarantine
            sel = ((_np_owner(keys_h, self.eng.n_shards) == q.shard)
                   & (applied_ops >= 0))
            if sel.any():
                q.deferred.append((seq, np.where(sel, applied_ops, OP_NONE)
                                   .astype(np.int32), keys_h, vals_h))
                applied_ops = np.where(sel, OP_NONE,
                                       applied_ops).astype(np.int32)

        self.journal.append(seq, applied_ops, keys_h, vals_h)
        state, res, ok, dropped = self.eng.step(
            state, *J.device_plan(applied_ops, keys_h, vals_h,
                                  self.eng.device))
        if self.quarantine is not None:
            state = self._advance_degraded(state)
        return state, res, ok, dropped

    # -- read side ------------------------------------------------------
    def stats(self, state) -> dict:
        out = self.eng.stats(state)
        out["seq"] = self.eng.seq
        return out

    def metrics(self, state) -> dict:
        """Global (summed over shards) metrics view with the host-side
        resilience tally folded in (`obs.merge_resilience`); per-shard
        planes stay available through `self.eng.metrics`."""
        per = self.eng.metrics(state)
        summed = {k: int(np.sum(v)) for k, v in per.items()}
        return obs.merge_resilience(summed, self.tally)
