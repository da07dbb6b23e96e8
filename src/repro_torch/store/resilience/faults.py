"""Seeded deterministic fault injection for the store engine (counterpart
of `repro.store.resilience.faults`).

A `FaultPlan` is a pure function of its seed, so "the run where shard 3
dies at step 5" is a reproducible artifact, not a flake. Faults are
injected at the engine step boundary by `restore.ResilientEngine` (never
inside a kernel) and tallied in `faults_injected`
(`obs.RESILIENCE_SCHEMA`). Three kinds:

* ``shard_drop`` — shard `shard`'s state is zeroed at step `step` (a lost
  NUMA node or device). Detected by the health epoch (`state_alive`: a
  live state always has a nonzero leaf, key planes hold KEY_INF from
  init on), then rebuilt from snapshot + journal.
* ``poison`` — lane `lane`'s op code becomes `POISON_OP` (outside
  `api.VALID_OPS`) on the wire copy of the plan. Detected by
  `sanitize_ops`; repaired by re-reading the journaled intent (`retries`).
* ``stall`` — `ticks` virtual ticks charged to the engine's stall clock.

`REPRO_FAULTS=<seed>` (read by `default_seed`) re-seeds suite-level plans.

A sharded state is the engine's tuple of per-shard states; shard s of it
is what the reference's stacked layout holds at index s on every leaf.
"""
from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.convert import tree_leaves, tree_map
from repro_torch.store.api import OP_NONE, VALID_OPS

# the poisoned-lane op code: far outside VALID_OPS, recognizable in dumps
POISON_OP = 113

FAULT_KINDS = ("shard_drop", "poison", "stall")


class Fault(NamedTuple):
    """One scheduled fault. `shard` is used by shard_drop, `lane` by
    poison, `ticks` by stall; the unused fields are -1/0."""
    kind: str
    step: int
    shard: int = -1
    lane: int = -1
    ticks: int = 0


class FaultPlan:
    """The deterministic fault schedule: seed in, same faults out, always.
    `at(step)` returns the faults due at an engine step (possibly empty)."""

    def __init__(self, seed: int, faults: Sequence[Fault]):
        self.seed = int(seed)
        self.faults = sorted(faults, key=lambda f: (f.step, f.kind, f.shard,
                                                    f.lane))
        self._by_step: Dict[int, List[Fault]] = {}
        for f in self.faults:
            self._by_step.setdefault(f.step, []).append(f)

    def at(self, step: int) -> List[Fault]:
        return self._by_step.get(int(step), [])

    def __len__(self) -> int:
        return len(self.faults)

    def __repr__(self) -> str:
        return f"FaultPlan(seed={self.seed}, faults={self.faults!r})"


def default_seed(fallback: int = 0) -> int:
    """The suite-level fault seed: `REPRO_FAULTS` when set, else
    `fallback`."""
    v = os.environ.get("REPRO_FAULTS", "").strip()
    return int(v) if v else int(fallback)


def make_fault_plan(seed: int, n_steps: int, n_shards: int, lanes: int, *,
                    n_faults: int = 3,
                    kinds: Sequence[str] = FAULT_KINDS) -> FaultPlan:
    """Draw `n_faults` faults over steps [1, n_steps) from one seeded
    generator (the reference's draws, one for one). Step 0 is excluded so
    there is always a pre-fault snapshot; at most one shard_drop a
    step."""
    if n_steps < 2:
        raise ValueError("need n_steps >= 2 (step 0 is fault-free)")
    bad = set(kinds) - set(FAULT_KINDS)
    if bad:
        raise ValueError(f"unknown fault kinds {sorted(bad)}; "
                         f"valid: {FAULT_KINDS}")
    rng = np.random.default_rng(seed)
    out: List[Fault] = []
    drop_steps: set[int] = set()
    for _ in range(n_faults):
        kind = str(rng.choice(list(kinds)))
        step = int(rng.integers(1, n_steps))
        if kind == "shard_drop":
            while step in drop_steps:
                step = int(rng.integers(1, n_steps))
            drop_steps.add(step)
            out.append(Fault(kind=kind, step=step,
                             shard=int(rng.integers(0, n_shards))))
        elif kind == "poison":
            out.append(Fault(kind=kind, step=step,
                             lane=int(rng.integers(0, lanes))))
        else:
            out.append(Fault(kind=kind, step=step,
                             ticks=int(rng.integers(1, 5))))
    return FaultPlan(seed, out)


# ---------------------------------------------------------------------------
# injection primitives
# ---------------------------------------------------------------------------

def _zero(x):
    return torch.zeros_like(x) if torch.is_tensor(x) else 0


def inject_shard_drop(state: tuple, shard: int) -> tuple:
    """Zero every leaf of shard `shard` (static ints too, as the
    reference's stacked leaves are). The zeroed shard is dead by the
    `state_alive` criterion."""
    return tuple(tree_map(_zero, st) if s == shard else st
                 for s, st in enumerate(state))


def poison_ops(ops, lane: int):
    """The wire-corruption model: lane `lane`'s op code becomes POISON_OP
    (on a copy: a tensor stays a tensor, anything else becomes numpy)."""
    out = (ops.clone() if torch.is_tensor(ops)
           else np.array(ops, np.int32, copy=True))
    out[lane] = POISON_OP
    return out


def sanitize_ops(ops):
    """Split a wire plan's op codes into (clean, poisoned_mask), host numpy:
    codes outside `api.VALID_OPS` (and not the idle OP_NONE) are masked to
    OP_NONE."""
    ops = np.asarray(ops.cpu() if torch.is_tensor(ops) else ops, np.int32)
    ok = np.isin(ops, np.asarray(sorted(VALID_OPS), np.int32)) \
        | (ops == OP_NONE)
    clean = np.where(ok, ops, OP_NONE).astype(np.int32)
    return clean, ~ok


def state_alive(state: tuple, n_shards: int) -> np.ndarray:
    """Per-shard liveness: shard s is alive iff any leaf has a nonzero
    element. One any-reduce a leaf, read back in one transfer."""
    if len(state) != n_shards:
        raise ValueError(f"{len(state)} shard states, expected {n_shards}")
    flags, host = [], []
    for st in state:
        leaves = tree_leaves(st)
        ts = [x for x in leaves if torch.is_tensor(x)]
        flags.append(torch.stack([(x != 0).any() for x in ts]).any())
        host.append(any(x != 0 for x in leaves if not torch.is_tensor(x)))
    return torch.stack(flags).cpu().numpy() | np.asarray(host, bool)
