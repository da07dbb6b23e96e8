"""Wrapper of the CUDA det-skiplist search (`csrc/skiplist_search.cu`).

Replaces `repro/kernels/skiplist_search/kernel.py:skiplist_search_tiles`.
On CUDA tensors it launches the kernel (one thread a query, blocks sized by
`walk_geometry`); on CPU tensors it runs the plain version
(`ref.skiplist_search_ref`)."""
from __future__ import annotations

import torch

from repro_torch.core.layout import SkiplistLayout
from repro_torch.kernels import cuda
from repro_torch.kernels.skiplist_search.ref import skiplist_search_ref

BLOCK_SIZES = (256, 128, 64, 32)


def walk_geometry(t: int, sms: int) -> int:
    """Threads per block for `t` queries: the largest of BLOCK_SIZES whose
    grid still gives every one of the `sms` SMs a block (the walk is
    latency-bound, so a plan of a few thousand queries must not sit on a
    few SMs), 32 when none does."""
    for threads in BLOCK_SIZES:
        if -(-t // threads) >= sms:
            return threads
    return BLOCK_SIZES[-1]


def skiplist_search_tiles(q: torch.Tensor, lay: SkiplistLayout):
    """q: [T] int64; lay: the flat level view. Returns (found int8[T],
    idx int32[T])."""
    if not q.is_cuda:
        return skiplist_search_ref(q, lay)
    cuda.check_cuda("skiplist_search", q, lay.lvl_keys, lay.lvl_child,
                    lay.lvl_off, lay.term_keys, lay.term_mark)
    if lay.num_levels > 64:
        raise ValueError("skiplist_search: at most 64 index levels")
    t = q.shape[0]
    found = torch.empty(t, dtype=torch.int8, device=q.device)
    idx = torch.empty(t, dtype=torch.int32, device=q.device)
    cuda.launch("skiplist_search", "skiplist_search_launch",
                cuda.ptr(q), t, cuda.ptr(lay.lvl_keys),
                cuda.ptr(lay.lvl_child), cuda.ptr(lay.lvl_off),
                lay.num_levels, lay.c1, cuda.ptr(lay.term_keys),
                cuda.ptr(lay.term_mark), lay.term_keys.shape[0],
                cuda.ptr(found), cuda.ptr(idx),
                walk_geometry(t, cuda.sm_count(q.device)), shape=t)
    return found, idx
