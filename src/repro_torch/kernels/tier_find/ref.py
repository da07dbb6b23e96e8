"""Plain PyTorch versions for the fused tier find.

* `spill_run_probe_ref` — the kernel's cold-tier body: a searchsorted-left
  binary search of every sorted run `[off[r], off[r + 1])`, all runs in
  parallel, the first live match wins; a miss reports the clipped search
  position in run 0.
* `tier_find_planes_ref` — the whole kernel on its planes (hot bucket
  probe, warm level or block walk, spill probe), raw per-tier results.
* `spill_run_cells` / `spill_find_runs` / `tier_find_ref` — the
  state-level references (counterparts of the JAX `ref.py`); the `torch`
  exec mode runs `tier_find_ref`, and the tier stack's tombstone path
  shares `spill_run_cells`.
"""
from __future__ import annotations

import torch

from repro_torch.core.bits import KEY_INF, ordered
from repro_torch.core.layout import (BSkiplistLayout, SkiplistLayout,
                                     SpillLayout, first_true, run_offsets)
from repro_torch.kernels.bskiplist_walk.ref import bskiplist_walk_ref
from repro_torch.kernels.hash_probe.ref import hash_probe_ref
from repro_torch.kernels.skiplist_search.ref import skiplist_search_ref


def spill_run_probe_ref(q: torch.Tensor, keys: torch.Tensor,
                        dead: torch.Tensor, run_off: torch.Tensor):
    """Per-run binary search. Returns (found bool[Q], cell int32[Q]); no
    KEY_INF query masking (the callers apply it)."""
    nq = q.shape[0]
    s = keys.shape[0]
    r = run_off.shape[0] - 1
    lo = run_off[:r][None, :].expand(nq, r).to(torch.int32)
    end = run_off[1:][None, :].expand(nq, r).to(torch.int32)
    hi = end
    ko = ordered(keys)
    qo = ordered(q)[:, None]
    for _ in range(max(s.bit_length(), 1)):
        cont = lo < hi
        mid = torch.clamp((lo + hi) // 2, 0, s - 1)
        less = ko[mid.long()] < qo
        lo = torch.where(cont & less, mid + 1, lo)
        hi = torch.where(cont & ~less, mid, hi)
    pos = torch.clamp(lo, 0, s - 1)
    pl = pos.long()
    live = (lo < end) & (keys[pl] == q[:, None]) & (dead[pl] == 0)
    cell = pos.gather(1, first_true(live).long()[:, None])[:, 0]
    return live.any(dim=1), cell


def warm_walk_ref(q: torch.Tensor, warm: SkiplistLayout | BSkiplistLayout):
    """The warm walk of the fused kernels in the view's layout: (found
    int8, idx int32)."""
    if isinstance(warm, BSkiplistLayout):
        return bskiplist_walk_ref(q, warm)
    return skiplist_search_ref(q, warm)


def tier_find_planes_ref(q: torch.Tensor, slots: torch.Tensor,
                         hot_keys: torch.Tensor,
                         warm: SkiplistLayout | BSkiplistLayout,
                         spill: SpillLayout | None = None):
    """The fused kernel's raw outputs: (hot int8, col int32, warm int8,
    idx int32) plus (spill int8, cell int32) when `spill` is given."""
    hot, col = hash_probe_ref(q, slots, hot_keys)
    wf, widx = warm_walk_ref(q, warm)
    out = (hot, col, wf, widx)
    if spill is not None:
        sf, cell = spill_run_probe_ref(q, spill.keys, spill.dead,
                                       spill.run_off)
        out += (sf.to(torch.int8), cell)
    return out


def spill_run_cells(keys, dead, run_start, n, queries):
    """Per-run binary-searched LIVE-cell lookup over the spill planes:
    (found[Q] bool, cell[Q] int32)."""
    found, cell = spill_run_probe_ref(queries, keys, dead,
                                      run_offsets(run_start, n))
    return found & (queries != KEY_INF), cell


def spill_find_runs(keys, vals, dead, run_start, n, queries):
    """Membership form of `spill_run_cells`: (found[Q] bool, vals[Q])."""
    found, cell = spill_run_cells(keys, dead, run_start, n, queries)
    return found, torch.where(found, vals[cell.long()], 0)


def tier_find_ref(hot, cold, spill, queries, warm_layout: str = "level"):
    """Raw per-tier probes with the reference implementations:
    ((hot found, vals, col), (warm found, vals), (spill found, vals));
    spill=None yields all-miss spill results. The warm probe walks the
    stack's layout: `find_batch` (level) or `find_batch_blocked` (block),
    the same found/vals either way."""
    from repro_torch.core import det_skiplist as dsl
    from repro_torch.core import hashtable as ht
    f_hot, v_hot, c_hot = ht.fixed_find_cols(hot, queries)
    warm_find = (dsl.find_batch_blocked if warm_layout == "block"
                 else dsl.find_batch)
    f_warm, v_warm, _ = warm_find(cold, queries)
    if spill is None:
        f_sp = torch.zeros(queries.shape, dtype=torch.bool,
                           device=queries.device)
        v_sp = torch.zeros(queries.shape, dtype=torch.int64,
                           device=queries.device)
    else:
        f_sp, v_sp = spill_find_runs(spill.keys, spill.vals, spill.dead,
                                     spill.run_start, spill.n, queries)
    return (f_hot, v_hot, c_hot), (f_warm, v_warm), (f_sp, v_sp)
