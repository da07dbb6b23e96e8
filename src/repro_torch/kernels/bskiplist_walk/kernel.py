"""Wrapper of the CUDA B-skiplist search (`csrc/bskiplist_walk.cu`).

Replaces `repro/kernels/bskiplist_walk/kernel.py:bskiplist_walk_tiles`. On
CUDA tensors it launches the kernel (one warp per query, a ballot count
per 128-key node); on CPU tensors it runs the plain version
(`ref.bskiplist_walk_ref`)."""
from __future__ import annotations

import torch

from repro_torch.core.layout import BSkiplistLayout
from repro_torch.kernels import cuda
from repro_torch.kernels.bskiplist_walk.ref import bskiplist_walk_ref


def bskiplist_walk_tiles(q: torch.Tensor, lay: BSkiplistLayout):
    """q: [T] int64; lay: the block-major view. Returns (found int8[T],
    idx int32[T])."""
    if not q.is_cuda:
        return bskiplist_walk_ref(q, lay)
    cuda.check_cuda("bskiplist_walk", q, lay.blk, lay.term_keys,
                    lay.term_mark)
    t = q.shape[0]
    found = torch.empty(t, dtype=torch.int8, device=q.device)
    idx = torch.empty(t, dtype=torch.int32, device=q.device)
    cuda.launch("bskiplist_walk", "bskiplist_walk_launch", cuda.ptr(q), t,
                cuda.ptr(lay.blk), lay.num_levels, lay.blk.shape[1],
                cuda.ptr(lay.term_keys), cuda.ptr(lay.term_mark),
                lay.term_keys.shape[0], lay.n_pad, cuda.ptr(found),
                cuda.ptr(idx))
    return found, idx
