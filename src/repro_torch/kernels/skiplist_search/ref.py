"""Plain PyTorch version of the skiplist_search kernel: the level walk over
the flat level view (`core.layout.SkiplistLayout`), vectorized over
queries. It reproduces the reference kernel's `level_walk` on the padded
`[L, C1]` rectangle: level indices clip to [0, c1 - 1] and reads past a
level's own capacity see `KEY_INF` keys and child 0."""
from __future__ import annotations

import torch

from repro_torch.core.bits import KEY_INF, u64_le
from repro_torch.core.layout import SkiplistLayout, first_true


def _row_read(buf: torch.Tensor, lo: int, cap: int, idx: torch.Tensor, pad):
    """buf[lo + idx] where idx < cap, else `pad` (idx already >= 0)."""
    return torch.where(idx < cap, buf[lo + torch.clamp(idx, max=cap - 1).long()],
                       pad)


def skiplist_search_ref(q: torch.Tensor, lay: SkiplistLayout):
    """q: [T] int64. Returns (found int8[T], idx int32[T]) exactly as the
    kernel does (found is raw: no KEY_INF query masking)."""
    off, c1 = lay.offsets, lay.c1
    L = lay.num_levels
    cap = lay.term_keys.shape[0]
    fan = torch.arange(4, dtype=torch.int32, device=q.device)[None, :]
    qc = q[:, None]
    top = lay.lvl_keys[off[L - 1]:off[L - 1] + 4]
    i = first_true(u64_le(qc, top[None, :]))
    for r in range(L - 1, -1, -1):
        ic = torch.clamp(i, 0, c1 - 1)
        start = _row_read(lay.lvl_child, off[r], off[r + 1] - off[r], ic, 0)
        if r == 0:
            ck = lay.term_keys[torch.clamp(start[:, None] + fan, 0,
                                           cap - 1).long()]
        else:
            idx = torch.clamp(start[:, None] + fan, 0, c1 - 1)
            ck = _row_read(lay.lvl_keys, off[r - 1], off[r] - off[r - 1], idx,
                           KEY_INF)
        i = (start + first_true(u64_le(qc, ck))).to(torch.int32)
    i = torch.clamp(i, 0, cap - 1)
    il = i.long()
    found = (lay.term_keys[il] == q) & (lay.term_mark[il] == 0)
    return found.to(torch.int8), i
