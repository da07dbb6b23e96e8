"""Glue: DetSkiplist state -> flat level view -> pq_pop kernel; the
contract of `core.det_skiplist.pop_rank_select`, including its masking of
lanes that are not found (keys `KEY_INF`, idx 0)."""
from __future__ import annotations

import torch

from repro_torch.core.bits import KEY_INF
from repro_torch.core.layout import skiplist_layout
from repro_torch.kernels.pq_pop.kernel import pq_pop_tiles


def pq_pop_ranks(s, ranks: torch.Tensor, mask: torch.Tensor):
    """(found bool[K], keys int64[K], idx int32[K]) through the kernel."""
    found, idx = pq_pop_tiles(ranks.to(torch.int32).contiguous(),
                              mask.to(torch.int8).contiguous(),
                              skiplist_layout(s))
    found = found.bool()
    idx = torch.where(found, torch.clamp(idx, 0, s.capacity - 1), 0)
    keys = torch.where(found, s.term_keys[idx.long()], KEY_INF)
    return found, keys, idx
