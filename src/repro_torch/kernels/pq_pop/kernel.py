"""Wrapper of the CUDA priority-queue pop (`csrc/pq_pop.cu`).

Replaces `repro/kernels/pq_pop/kernel.py:pq_pop_tiles`. On CUDA tensors
one dispatch is three launches, each counted in `cuda.LAUNCHES["pq_pop"]`:
the per-chunk live count, the one-block scan of the chunk counts, and the
per-rank select and level walk (one warp per rank). On CPU tensors it runs
the plain version (`ref.pq_pop_ref`)."""
from __future__ import annotations

import torch

from repro_torch.core.layout import SkiplistLayout
from repro_torch.kernels import cuda
from repro_torch.kernels.pq_pop.ref import pq_pop_ref

PQ_CHUNK = 512     # terminal cells per live count (csrc/pq_pop.cu)


def pq_pop_tiles(ranks: torch.Tensor, mask: torch.Tensor,
                 lay: SkiplistLayout):
    """ranks: [T] int32; mask: [T] int8; lay: the flat level view. Returns
    (found int8[T], idx int32[T])."""
    if not ranks.is_cuda:
        return pq_pop_ref(ranks, mask, lay)
    cuda.check_cuda("pq_pop", ranks, mask, lay.lvl_keys, lay.lvl_child,
                    lay.lvl_off, lay.term_keys, lay.term_mark)
    if ranks.dtype != torch.int32 or mask.dtype != torch.int8:
        raise ValueError("pq_pop: ranks int32, mask int8 expected")
    if lay.num_levels > 64:
        raise ValueError("pq_pop: at most 64 index levels")
    t = ranks.shape[0]
    cap = lay.term_keys.shape[0]
    dev = ranks.device
    found = torch.empty(t, dtype=torch.int8, device=dev)
    idx = torch.empty(t, dtype=torch.int32, device=dev)
    prefix = torch.empty(-(-cap // PQ_CHUNK), dtype=torch.int32, device=dev)
    args = (cuda.ptr(ranks), cuda.ptr(mask), t, cuda.ptr(lay.lvl_keys),
            cuda.ptr(lay.lvl_child), cuda.ptr(lay.lvl_off), lay.num_levels,
            lay.c1, cuda.ptr(lay.term_keys), cuda.ptr(lay.term_mark), cap,
            cuda.ptr(prefix), cuda.ptr(found), cuda.ptr(idx))
    for stage in range(3):     # count, scan, select
        cuda.launch("pq_pop", "pq_pop_launch", *args, stage)
    return found, idx
