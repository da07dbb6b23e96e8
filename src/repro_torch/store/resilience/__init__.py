"""Deterministic fault tolerance over the Store API (counterpart of
`repro.store.resilience`).

Three layers, importable a la carte:

* `journal` — write-ahead op-plan journal (seq-numbered, digest-chained)
  plus state snapshots; `restore()` replays the tail through the normal
  `apply` path to a bit-identical state and metrics digest.
* `faults` — seeded deterministic fault plans (shard drop, poisoned op
  lane, maintenance stall) injected at the engine step boundary;
  `REPRO_FAULTS=<seed>` re-seeds the suites.
* `restore` — `ResilientEngine`: per-step health epoch, quarantine, and
  snapshot + journal rebuild in sync or degraded mode.
"""
from repro_torch.store.resilience.faults import (FAULT_KINDS, Fault,
                                                 FaultPlan, POISON_OP,
                                                 default_seed,
                                                 inject_shard_drop,
                                                 make_fault_plan, poison_ops,
                                                 sanitize_ops, state_alive)
# the restore MODULE import must precede the journal's `restore` FUNCTION
# import: a submodule import binds the package attribute to the module, and
# the later from-import rebinds it to the function (the public name)
from repro_torch.store.resilience.restore import (ResilientEngine,
                                                  rebuild_shard, splice_shard)
from repro_torch.store.resilience.journal import (GENESIS, Journal,
                                                  JournalEntry, Snapshot,
                                                  replay_plans, restore,
                                                  snapshot_state,
                                                  state_digest,
                                                  take_snapshot)

__all__ = [
    "FAULT_KINDS", "Fault", "FaultPlan", "POISON_OP", "default_seed",
    "inject_shard_drop", "make_fault_plan", "poison_ops", "sanitize_ops",
    "state_alive", "GENESIS", "Journal", "JournalEntry", "Snapshot",
    "replay_plans", "restore", "snapshot_state", "state_digest",
    "take_snapshot", "ResilientEngine", "rebuild_shard", "splice_shard",
]
