"""Glue: TwoLevelSplitOrder state -> splitorder_probe kernel; the
contract of `core.splitorder.twolevel_splitorder_find`. The queries'
bit-reversed hashes and owner tables are computed here with torch ops;
the value gather runs after the kernel."""
from __future__ import annotations

import torch

from repro_torch.core.bits import KEY_INF, bitrev64, hash64
from repro_torch.core.splitorder import _table_of
from repro_torch.kernels.splitorder_probe.kernel import splitorder_probe_tiles


def twolevel_splitorder_probe(h, keys: torch.Tensor):
    """(found bool[K], vals int64[K]) through the kernel."""
    keys = keys.contiguous()
    tbl = _table_of(h, keys)
    found, at = splitorder_probe_tiles(bitrev64(hash64(keys)), keys, tbl,
                                       h.rk, h.keys)
    found = found.bool() & (keys != KEY_INF)
    return found, torch.where(found, h.vals[tbl.long(), at.long()], 0)
