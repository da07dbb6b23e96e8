"""Plain PyTorch version of the bskiplist_walk kernel: the block-major
descent over `core.layout.BSkiplistLayout`, vectorized over queries. Per
index row it counts the node's entries below q (the searchsorted-left
position, whatever the row's order), the child being `base + count`; then
the count in the terminal block and the exact match with the tombstone.
Terminal reads at or past C see the reference's padding: a `KEY_INF` key,
mark 0."""
from __future__ import annotations

import torch

from repro_torch.core.bits import KEY_INF, ordered
from repro_torch.core.layout import BSKIP_BLOCK, BSkiplistLayout


def _padded(plane: torch.Tensor, cells: torch.Tensor, pad):
    """plane[cells] where cells < len(plane), else `pad` (cells >= 0)."""
    n = plane.shape[0]
    return torch.where(cells < n, plane[torch.clamp(cells, max=n - 1).long()],
                       pad)


def bskiplist_walk_ref(q: torch.Tensor, lay: BSkiplistLayout):
    """q: [T] int64. Returns (found int8[T], idx int32[T]) exactly as the
    kernel does (found is raw: no KEY_INF query masking)."""
    B = BSKIP_BLOCK
    L, W = lay.blk.shape
    lanes = torch.arange(B, dtype=torch.int32, device=q.device)[None, :]
    oq = ordered(q)[:, None]
    i = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    for r in range(L - 1, -1, -1):
        base = torch.clamp(i, 0, W // B - 1) * B
        node = ordered(lay.blk[r])[(base[:, None] + lanes).long()]
        i = base + (node < oq).sum(dim=1, dtype=torch.int32)
    tb = torch.clamp(i, 0, lay.n_pad // B - 1) * B
    node = _padded(lay.term_keys, tb[:, None] + lanes, KEY_INF)
    i = tb + (ordered(node) < oq).sum(dim=1, dtype=torch.int32)
    i = torch.clamp(i, 0, lay.n_pad - 1)
    found = ((_padded(lay.term_keys, i, KEY_INF) == q)
             & (_padded(lay.term_mark, i, 0) == 0))
    return found.to(torch.int8), i
