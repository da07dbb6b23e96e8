"""Write-ahead op-plan journal + state snapshots: determinism as recovery
(counterpart of `repro.store.resilience.journal`).

One op stream gives one bit-identical state, in every exec mode and on
any mesh. So a periodic SNAPSHOT of the state plus every `OpPlan` batch
applied after it rebuilds any later state by replaying the journal tail
through the same `apply` path the live run used.

* `JournalEntry` — one applied batch: `seq` (the engine's host step
  counter), the plan as host numpy copies (ops int32, keys and vals
  uint64) and a chained blake2b digest over (previous digest, seq,
  arrays), so truncation, reordering or corruption is detectable
  (`Journal.verify()`).
* `Snapshot` — `(seq, leaves, state, digest)`: `leaves` are the state's
  host numpy leaves in the reference's layout and order (a sharded state
  stacked on a leading shard dim), `state` a host copy of the port's
  state that `snapshot_state` moves back onto a device.
* `restore(eng, snapshot, entries)` — the snapshot back on the engine's
  device, `eng.seq` reset, the tail replayed through `eng.step`.

Digests hash each array's dtype name, shape and bytes, in the reference's
dtypes (u64 keys as `uint64`) and leaf order, so a journal over the same
plans, or a converted state, digests as the reference's does.
"""
from __future__ import annotations

import hashlib
from typing import Any, List, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.convert import (sharded_state_to_numpy, state_to_numpy,
                                 tree_leaves, tree_map)
from repro_torch.core.bits import from_u64

# chain seed: a fixed tag, so an empty journal still has a well-defined
# head digest distinct from "no journal" (the reference's tag)
GENESIS = hashlib.blake2b(b"repro.store.resilience/journal",
                          digest_size=16).hexdigest()


def _chain(prev_hex: str, seq: int, arrays: Sequence[np.ndarray]) -> str:
    """blake2b over (previous digest, seq, each array's dtype+shape+bytes)
    — the per-entry link of the journal's digest chain."""
    h = hashlib.blake2b(digest_size=16)
    h.update(bytes.fromhex(prev_hex))
    h.update(int(seq).to_bytes(8, "little", signed=True))
    for a in arrays:
        a = np.asarray(a)
        h.update(str(a.dtype).encode())
        h.update(np.asarray(a.shape, np.int64).tobytes())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _is_sharded(state) -> bool:
    """A sharded engine state is a plain tuple of per-shard states."""
    return isinstance(state, tuple) and not hasattr(state, "_fields")


def host_leaves(state) -> list:
    """The state's leaves as numpy arrays in the reference's layout, dtypes
    and leaf order (static ints as int64 scalars)."""
    tree = (sharded_state_to_numpy(state) if _is_sharded(state)
            else state_to_numpy(state))
    return [np.asarray(x, np.int64) if isinstance(x, int) else np.asarray(x)
            for x in tree_leaves(tree)]


def state_digest(state) -> str:
    """Canonical digest of a state: two states are "bit-identical" iff
    their digests match."""
    leaves = host_leaves(state)
    return _chain(GENESIS, len(leaves), leaves)


class JournalEntry(NamedTuple):
    """One applied batch: plan arrays as host copies + the chain digest."""
    seq: int
    ops: np.ndarray      # [K] int32 (OP_NONE lanes idle; masked lanes too)
    keys: np.ndarray     # [K] uint64
    vals: np.ndarray     # [K] uint64
    digest: str

    @property
    def n_ops(self) -> int:
        """Valid (executable) lanes this entry carries."""
        return int(np.sum(self.ops >= 0))


class Snapshot(NamedTuple):
    """A state at step `seq`: reference-layout host leaves, a host copy of
    the port's state, and the leaves' digest."""
    seq: int
    leaves: tuple
    state: Any
    digest: str


def take_snapshot(state, seq: int) -> Snapshot:
    """Copy a state (any backend, sharded or not) to the host."""
    host = copy_to(state, "cpu")
    leaves = tuple(host_leaves(host))
    return Snapshot(seq=int(seq), leaves=leaves, state=host,
                    digest=_chain(GENESIS, len(leaves), leaves))


def copy_to(state, device):
    """A fresh copy of a state's tensors on `device`."""
    dev = torch.device(device)
    return tree_map(lambda x: x.to(dev, copy=True) if torch.is_tensor(x)
                    else x, state)


def snapshot_state(snap: Snapshot, device="cuda"):
    """The snapshot's state on `device` (a fresh copy each call)."""
    return copy_to(snap.state, device)


def host_plan(ops, keys, vals):
    """A plan's arrays as host numpy copies: ops int32, keys and vals as
    uint64 (tensors hold the u64 bits as int64)."""
    def u64(x):
        a = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
        return np.array(a, copy=True).view(np.uint64) \
            if a.dtype == np.int64 else np.array(a, np.uint64)
    ops = np.array(ops.cpu() if torch.is_tensor(ops) else ops, np.int32)
    return ops, u64(keys), u64(vals)


def device_plan(ops: np.ndarray, keys: np.ndarray, vals: np.ndarray, device):
    """Host plan arrays -> (ops int32, keys int64, vals int64) tensors."""
    return (torch.from_numpy(np.array(ops, np.int32)).to(device),
            from_u64(keys, device), from_u64(vals, device))


class Journal:
    """Append-only, digest-chained record of applied `OpPlan` batches,
    seq-contiguous from `base_seq`; `verify()` recomputes every link."""

    def __init__(self, base_seq: int = 0):
        self.base_seq = int(base_seq)
        self.entries: List[JournalEntry] = []
        self.head_digest = GENESIS

    def __len__(self) -> int:
        return len(self.entries)

    @property
    def next_seq(self) -> int:
        return self.base_seq + len(self.entries)

    def append(self, seq: int, ops, keys, vals) -> JournalEntry:
        if int(seq) != self.next_seq:
            raise ValueError(f"journal expects seq {self.next_seq}, "
                             f"got {seq} (entries must be gap-free)")
        ops, keys, vals = host_plan(ops, keys, vals)
        self.head_digest = _chain(self.head_digest, int(seq),
                                  (ops, keys, vals))
        e = JournalEntry(seq=int(seq), ops=ops, keys=keys, vals=vals,
                         digest=self.head_digest)
        self.entries.append(e)
        return e

    def tail(self, from_seq: int) -> List[JournalEntry]:
        """Entries with seq >= from_seq (what a restore from a snapshot
        taken at `from_seq` replays)."""
        return [e for e in self.entries if e.seq >= from_seq]

    def verify(self) -> bool:
        """Recompute the whole chain; raises ValueError at the first entry
        whose digest or seq does not match."""
        prev = GENESIS
        for i, e in enumerate(self.entries):
            want = _chain(prev, e.seq, (e.ops, e.keys, e.vals))
            if e.digest != want:
                raise ValueError(f"journal digest chain broken at entry {i} "
                                 f"(seq {e.seq})")
            if e.seq != self.base_seq + i:
                raise ValueError(f"journal seq gap at entry {i}: "
                                 f"{e.seq} != {self.base_seq + i}")
            prev = e.digest
        return True


def restore(eng, snap: Snapshot, entries: Sequence[JournalEntry]):
    """Snapshot + journal tail -> (state, replayed_ops), through the normal
    `eng.step` path (`eng` a `store.engine.StoreEngine`: `.step`,
    `.device`, `.seq`)."""
    state = snapshot_state(snap, eng.device)
    eng.seq = snap.seq
    replayed = 0
    for e in entries:
        if e.seq != eng.seq:
            raise ValueError(f"replay expects seq {eng.seq}, entry has "
                             f"{e.seq} (snapshot/journal mismatch)")
        state, _, _, _ = eng.step(state, *device_plan(e.ops, e.keys, e.vals,
                                                      eng.device))
        replayed += e.n_ops
    return state, replayed


def replay_plans(apply_fn, state, entries: Sequence[JournalEntry],
                 mask_from_ops: bool = True, *, device="cuda"):
    """Single-instance replay for direct backends (no engine): fold
    `apply_fn(state, plan)` over the journal tail, plans on `device`."""
    from repro_torch.store.api import make_plan
    replayed = 0
    for e in entries:
        mask = (e.ops >= 0) if mask_from_ops else np.ones(e.ops.shape, bool)
        state, _ = apply_fn(state, make_plan(e.ops, e.keys, e.vals,
                                             mask=mask, device=device))
        replayed += e.n_ops
    return state, replayed
