"""Glue: FixedHash state -> bucket probe kernel; the contract of
`core.hashtable.fixed_find_cols`."""
from __future__ import annotations

import torch

from repro_torch.core.bits import EMPTY
from repro_torch.core.layout import hash_slot
from repro_torch.kernels.hash_probe.kernel import hash_probe_tiles


def fixed_hash_find_cols(h, keys: torch.Tensor):
    """(found bool[K], vals int64[K], col int32[K]) through the kernel."""
    keys = keys.contiguous()
    slots = hash_slot(keys, h.num_slots)
    found, col = hash_probe_tiles(keys, slots, h.keys.contiguous())
    found = found.bool() & (keys != EMPTY)
    vals = torch.where(found, h.vals[slots.long(), col.long()], 0)
    return found, vals, col
