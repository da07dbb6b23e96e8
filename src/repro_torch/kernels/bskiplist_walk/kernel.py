"""Wrapper of the CUDA B-skiplist search (`csrc/bskiplist_walk.cu`).

Replaces `repro/kernels/bskiplist_walk/kernel.py:bskiplist_walk_tiles`. On
CUDA tensors it launches the kernel (a team of `walk_team` lanes a query:
a warp counts each 128-key node with ballots, a team of 2 or 1 searches
it); on CPU tensors it runs the plain version (`ref.bskiplist_walk_ref`)."""
from __future__ import annotations

import functools

import torch

from repro_torch.core.layout import BSkiplistLayout
from repro_torch.kernels import cuda
from repro_torch.kernels.bskiplist_walk.ref import bskiplist_walk_ref

# the team widths bskiplist_walk.cu has instances for, widest first: a
# warp counts each node, 2 lanes or 1 search it (4 searched slower at the
# preload width, PERF.md)
TEAMS = (32, 2, 1)


def walk_team(t: int, sms: int, slots) -> int:
    """Lanes a query for t queries on a card of `sms` SMs, `slots(team)`
    the resident threads an SM of the instance for `team`:
    `cuda.team_width` over `TEAMS`."""
    return cuda.team_width(t, TEAMS, sms, slots)


@functools.lru_cache(maxsize=None)
def walk_slots(index: int, team: int) -> int:
    """Resident threads an SM of the instance for `team` on CUDA device
    `index` (`bskiplist_walk_slots`)."""
    with torch.cuda.device(index):
        return cuda.library("bskiplist_walk").bskiplist_walk_slots(team)


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
    team = walk_team(t, cuda.sm_count(q.device),
                     functools.partial(walk_slots, q.device.index or 0))
    cuda.launch("bskiplist_walk", "bskiplist_walk_launch", cuda.ptr(q), t,
                cuda.ptr(lay.blk), lay.num_levels, lay.blk.shape[1],
                cuda.ptr(lay.term_keys), cuda.ptr(lay.term_mark),
                lay.term_keys.shape[0], lay.n_pad, cuda.ptr(found),
                cuda.ptr(idx), team, shape=t)
    return found, idx
