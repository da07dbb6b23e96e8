"""Plain PyTorch version of the pq_pop kernel: rank-select over the live
terminal prefix, then the level walk of `skiplist_search` on the selected
keys. The reference forms a [T, C] compare matrix of ranks against the
prefix; here the first cell whose inclusive live prefix reaches r + 1 is a
searchsorted-left over that prefix (the prefix never decreases, so it is
the same cell). The live total is the prefix's last entry, as in the
kernel."""
from __future__ import annotations

import torch

from repro_torch.core.bits import KEY_INF
from repro_torch.core.layout import SkiplistLayout
from repro_torch.kernels.skiplist_search.ref import skiplist_search_ref


def pq_pop_ref(ranks: torch.Tensor, mask: torch.Tensor, lay: SkiplistLayout):
    """ranks: [T] int32; mask: [T] int8. Returns (found int8[T],
    idx int32[T]); a lane that is not found has idx 0."""
    tk, tm = lay.term_keys, lay.term_mark
    live = (tm == 0) & (tk != KEY_INF)
    prefix = torch.cumsum(live.to(torch.int32), 0, dtype=torch.int32)
    total = prefix[-1]
    want = ranks.to(torch.int32) + 1
    sel = (mask != 0) & (want >= 1) & (want <= total)
    cell = torch.clamp(torch.searchsorted(prefix, want, out_int32=True), 0,
                       tk.shape[0] - 1)
    key = torch.where(sel, tk[cell.long()], KEY_INF)
    walked, idx = skiplist_search_ref(key, lay)
    found = sel & (walked != 0)
    return found.to(torch.int8), torch.where(found, idx, 0)
