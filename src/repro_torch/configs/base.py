"""The store fields of the reference's `ModelConfig` (`repro.configs.base`):
the port runs no model yet, so its config carries the kvstore fields only."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class StoreConfig:
    name: str
    family: str = "kvstore"
    store_capacity: int = 0
    store_lanes: int = 0
    store_backend: str = "det_skiplist"  # any repro_torch.store registry name
    store_exec: str = "gpu"              # store.exec mode: torch | gpu

    def replace(self, **kw) -> "StoreConfig":
        return dataclasses.replace(self, **kw)
