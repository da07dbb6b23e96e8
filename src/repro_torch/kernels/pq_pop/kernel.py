"""Wrapper of the CUDA priority-queue pop (`csrc/pq_pop.cu`).

Replaces `repro/kernels/pq_pop/kernel.py:pq_pop_tiles`. On CUDA tensors
one dispatch is two launches, each counted in `cuda.LAUNCHES["pq_pop"]`:
the ordered scan of the live chunk counts, which stops at the first chunk
that reaches the largest masked-in rank, and the per-rank select and level
walk (one thread a rank). On CPU tensors it runs the plain version
(`ref.pq_pop_ref`).

The scan's scratch is kept across calls on each (device, stream) and its
words are tagged with a per-call epoch counted on the host, so no launch
clears it. A CUDA graph would replay one captured epoch against words its
earlier replays left published, so the wrapper refuses to run while its
stream is being captured."""
from __future__ import annotations

import torch

from repro_torch.core.layout import SkiplistLayout
from repro_torch.kernels import cuda
from repro_torch.kernels.pq_pop.ref import pq_pop_ref

PQ_CHUNK = 512     # terminal cells a prefix entry (csrc/pq_pop.cu)
PQ_ROUNDS = 16     # 32-cell rounds a chunk, a count byte each
PQ_TILE = 8        # chunks a scan ticket
SCAN_BLOCKS_PER_SM = 2
WORDS_FIXED = 4    # the two tickets, want_max and the stop index
STOP_WORD = 3      # (epoch << 34 | 1 << 32 | stop index + 1) once published
EPOCH_LIMIT = 1 << 30

# the scan's scratch by (device index, stream): [int64 buffer, last epoch]
_SCRATCH: dict = {}


def scan_geometry(cap: int, sms: int):
    """(chunks, tiles, scan blocks) for a heap of `cap` cells on a card of
    `sms` SMs: every tile of PQ_TILE chunks is a ticket, and the scan's
    blocks loop over tickets, SCAN_BLOCKS_PER_SM to an SM."""
    chunks = -(-cap // PQ_CHUNK)
    tiles = -(-chunks // PQ_TILE)
    return chunks, tiles, min(tiles, SCAN_BLOCKS_PER_SM * sms)


def scratch_layout(cap: int):
    """The scan's scratch for a heap of `cap` cells, in int64 words: the
    fixed words and one a tile, then the chunks' int32 prefixes, then their
    PQ_ROUNDS round counts (a byte each), each part on a 16-byte boundary.
    Returns (prefix start, rounds start, total)."""
    chunks, tiles, _ = scan_geometry(cap, 1)
    at_prefix = -(-(WORDS_FIXED + tiles) // 2) * 2
    at_rounds = at_prefix + 2 * -(-chunks // 4)
    return at_prefix, at_rounds, at_rounds + PQ_ROUNDS * chunks // 8


def scan_scratch(dev: torch.device, cap: int):
    """The scan's scratch on the current stream and this call's epoch:
    (words, prefix, rounds) views of one int64 buffer, and the epoch. The
    buffer is kept across calls and zeroed only when (re)allocated; every
    call's words carry a new epoch, so a word of an earlier call reads as
    unpublished and nothing is cleared between calls."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    at_prefix, at_rounds, need = scratch_layout(cap)
    entry = _SCRATCH.get(key)
    if (entry is None or entry[0].numel() < need
            or entry[1] + 1 >= EPOCH_LIMIT):
        entry = [torch.zeros(need, dtype=torch.int64, device=dev), 0]
        _SCRATCH[key] = entry
    entry[1] += 1
    buf = entry[0]
    return (buf[:at_prefix], buf[at_prefix:at_rounds], buf[at_rounds:need],
            entry[1])


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
    if cap == 0:
        raise ValueError("pq_pop: an empty terminal plane")
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("pq_pop: its scan's scratch is tagged with a "
                           "per-call epoch, so it cannot be captured in a "
                           "CUDA graph")
    dev = ranks.device
    found = torch.empty(t, dtype=torch.int8, device=dev)
    idx = torch.empty(t, dtype=torch.int32, device=dev)
    words, prefix, rounds, epoch = scan_scratch(dev, cap)
    _, _, grid = scan_geometry(cap, cuda.sm_count(dev))
    args = (cuda.ptr(ranks), cuda.ptr(mask), t, cuda.ptr(lay.lvl_keys),
            cuda.ptr(lay.lvl_child), cuda.ptr(lay.lvl_off), lay.num_levels,
            lay.c1, cuda.ptr(lay.term_keys), cuda.ptr(lay.term_mark), cap,
            cuda.ptr(words), cuda.ptr(prefix), cuda.ptr(rounds), epoch, grid,
            cuda.ptr(found), cuda.ptr(idx))
    for stage in range(2):     # scan, select
        cuda.launch("pq_pop", "pq_pop_launch", *args, stage,
                    shape=(t, cap))
    return found, idx
