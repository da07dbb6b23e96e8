"""Glue: DetSkiplist state -> flat level view -> skiplist_search kernel;
the contract of `core.det_skiplist.find_batch`."""
from __future__ import annotations

import torch

from repro_torch.core.bits import KEY_INF
from repro_torch.core.layout import skiplist_layout
from repro_torch.kernels.skiplist_search.kernel import skiplist_search_tiles


def skiplist_find(s, queries: torch.Tensor):
    """(found bool[T], vals int64[T], idx int32[T]) through the kernel."""
    found, idx = skiplist_search_tiles(queries.contiguous(), skiplist_layout(s))
    found = found.bool() & (queries != KEY_INF)
    vals = torch.where(found,
                       s.term_vals[torch.clamp(idx, 0, s.capacity - 1).long()],
                       0)
    return found, vals, idx
