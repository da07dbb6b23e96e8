"""Glue: tier-stack state -> bucket / warm (level or block) / spill views
-> ONE fused tier_find launch. Value gathers happen here; the fall-through
masking lives in `store.exec.tier_find`, shared with the plain path."""
from __future__ import annotations

import torch

from repro_torch.core.bits import KEY_INF
from repro_torch.core.layout import (BSkiplistLayout, SkiplistLayout,
                                     hash_slot, spill_layout)
from repro_torch.kernels.tier_find.kernel import tier_find_tiles


def tier_find_fused(hot, cold, spill, queries: torch.Tensor,
                    warm: SkiplistLayout | BSkiplistLayout):
    """One dispatch over the whole tier stack. Returns ((found, vals, col),
    (found, vals), (found, vals)), the raw per-tier contract of
    `ref.tier_find_ref`. `warm` is the warm tier's view, which picks the
    warm walk (`core.layout.warm_layout_of`)."""
    queries = queries.contiguous()
    t = queries.shape[0]
    slots = hash_slot(queries, hot.num_slots)
    sp = (None if spill is None else
          spill_layout(spill.keys, spill.dead, spill.run_start, spill.n))
    out = tier_find_tiles(queries, slots, hot.keys.contiguous(),
                          warm, sp)
    valid = queries != KEY_INF
    f_hot = out[0].bool() & valid
    c_hot = out[1]
    v_hot = torch.where(f_hot, hot.vals[slots.long(), c_hot.long()], 0)
    f_warm = out[2].bool() & valid
    i_warm = torch.clamp(out[3], 0, cold.capacity - 1).long()
    v_warm = torch.where(f_warm, cold.term_vals[i_warm], 0)
    if spill is not None:
        f_sp = out[4].bool() & valid
        i_sp = torch.clamp(out[5], 0, spill.keys.shape[0] - 1).long()
        v_sp = torch.where(f_sp, spill.vals[i_sp], 0)
    else:
        f_sp = torch.zeros(t, dtype=torch.bool, device=queries.device)
        v_sp = torch.zeros(t, dtype=torch.int64, device=queries.device)
    return (f_hot, v_hot, c_hot), (f_warm, v_warm), (f_sp, v_sp)
