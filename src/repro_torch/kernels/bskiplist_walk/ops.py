"""Glue: DetSkiplist state -> block-major view -> bskiplist_walk kernel;
the contract of `core.det_skiplist.find_batch_blocked`."""
from __future__ import annotations

import torch

from repro_torch.core.bits import KEY_INF
from repro_torch.core.layout import bskiplist_layout
from repro_torch.kernels.bskiplist_walk.kernel import bskiplist_walk_tiles


def bskiplist_find(s, queries: torch.Tensor):
    """(found bool[T], vals int64[T], idx int32[T]) through the kernel."""
    found, idx = bskiplist_walk_tiles(queries.contiguous(),
                                      bskiplist_layout(s))
    found = found.bool() & (queries != KEY_INF)
    vals = torch.where(found,
                       s.term_vals[torch.clamp(idx, 0, s.capacity - 1).long()],
                       0)
    return found, vals, idx
