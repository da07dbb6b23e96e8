"""Shared flat-memory layout layer (counterpart of `repro.core.layout`).

Allocation conventions and the probe views the CUDA kernels consume:

* key/value arrays: int64 key bit patterns padded with `KEY_INF`, int64
  zero values (`kv_arrays`); policy metadata is an int32 plane of the key
  plane's shape (`policy_arrays`);
* spill runs: append-only key/value planes plus bool tombstones and
  run-start marks (`spill_arrays`), probed through the
  `[MAX_SPILL_RUNS + 1]` run-boundary plane (`run_offsets`);
* the level-major skiplist view (`skiplist_layout`): the reference stacks
  the index levels into a padded `[L, C1]` rectangle because a TPU kernel
  wants VMEM-resident rows. On the card that rectangle would be rebuilt
  on every dispatch (about 2 GB at C = 2^24), so here the state keeps its
  levels in ONE flat key buffer and ONE child buffer, read through an
  `[L + 1]` offset table. Reads past a level's own capacity but below `c1` behave as the
  rectangle's padding (`KEY_INF` keys, child 0), which keeps the walk
  bit-identical to the reference kernel;
* the bucket view: an `[M, B]` int64 key plane, one bucket per row.

There is no (hi, lo) u32 split: kernels compare u64 natively.

`resolve_device` is the one place that turns a `device=` argument into a
`torch.device` and refuses CUDA when no card is present (no silent CPU
fallback).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core.bits import KEY_INF, hash64, shr, u64_le

# ---------------------------------------------------------------------------
# devices and sizing helpers
# ---------------------------------------------------------------------------


def resolve_device(device) -> torch.device:
    """`device=` argument -> torch.device; raises for CUDA without a card."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run on the CPU")
    return d


def pow2_floor(n: int) -> int:
    """Largest power of two <= max(n, 1)."""
    return 1 << max(int(n).bit_length() - 1, 0)


def is_pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def scatter_drop(base: torch.Tensor, idx: torch.Tensor, src) -> torch.Tensor:
    """`base` with `base[idx[i]] = src[i]` (or the scalar `src`), dropping
    indices outside [0, len) — the reference's `.at[idx].set(src,
    mode="drop")` on a 1-D plane. Returns a new tensor: out-of-range lanes
    land in one trailing trash cell that is sliced away, so no host sync
    is needed to filter them."""
    n = base.shape[0]
    idx = idx.long()
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    out = torch.cat([base, base[:1] if n else base.new_zeros(1)])
    out[idx] = src if torch.is_tensor(src) else torch.tensor(
        src, dtype=base.dtype, device=base.device)
    return out[:n]


def add_drop(base: torch.Tensor, idx: torch.Tensor, src) -> torch.Tensor:
    """`base` with `src[i]` (or the scalar `src`) added at `base[idx[i]]`,
    repeated indices accumulating and indices outside [0, len) dropped —
    the reference's `.at[idx].add(src, mode="drop")` along dim 0. Returns
    a new tensor (a trailing trash row takes the dropped lanes)."""
    n = base.shape[0]
    idx = idx.long()
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    out = torch.cat([base, base.new_zeros((1,) + tuple(base.shape[1:]))])
    if not torch.is_tensor(src):
        src = torch.full((idx.shape[0],) + tuple(base.shape[1:]), src,
                         dtype=base.dtype, device=base.device)
    out.index_add_(0, idx, src.to(base.dtype))
    return out[:n]


def inverse_perm(order: torch.Tensor) -> torch.Tensor:
    """int32 inverse of a permutation (`inv[order] = arange`)."""
    k = order.shape[0]
    inv = torch.empty(k, dtype=torch.int32, device=order.device)
    inv[order.long()] = torch.arange(k, dtype=torch.int32, device=order.device)
    return inv


def first_true(m: torch.Tensor) -> torch.Tensor:
    """int32 column of the first True per row; 0 for an all-False row (the
    argmax convention every reference kernel relies on)."""
    return torch.argmax(m.to(torch.uint8), dim=1).to(torch.int32)


# ---------------------------------------------------------------------------
# flat key/value storage, policy metadata, spill planes
# ---------------------------------------------------------------------------

def kv_arrays(shape, *, device):
    """The shared (keys, vals) allocation: int64 keys filled with
    `KEY_INF`, int64 zero values."""
    if isinstance(shape, int):
        shape = (shape,)
    return (torch.full(shape, KEY_INF, dtype=torch.int64, device=device),
            torch.zeros(shape, dtype=torch.int64, device=device))


def block_arrays(num_blocks: int, block_shape, *, device):
    """Pooled `[P, ...]` key/value payload arrays for a `core.blockpool`
    allocator of `num_blocks` ids (the two-level hash's L2 tables)."""
    if isinstance(block_shape, int):
        block_shape = (block_shape,)
    return kv_arrays((num_blocks,) + tuple(block_shape), device=device)


def metrics_plane(names, *, device) -> dict:
    """The observability layer's counter allocation: one int64 zero scalar
    per metric name, a dict that rides inside an observed store state (the
    schema, which names, is `repro_torch.store.obs.METRICS_SCHEMA`)."""
    return {n: torch.zeros((), dtype=torch.int64, device=device)
            for n in names}


def policy_arrays(shape, *, device) -> torch.Tensor:
    """Per-entry eviction-policy metadata, int32 zeros of the key plane's
    shape (LRU: batch clock of the last touch; size: `val_weight`)."""
    if isinstance(shape, int):
        shape = (shape,)
    return torch.zeros(shape, dtype=torch.int32, device=device)


def val_weight(vals: torch.Tensor) -> torch.Tensor:
    """The size-aware policy's payload weight: bytes needed to encode the
    u64 value (1..8), int32."""
    v = vals
    bits = torch.zeros(v.shape, dtype=torch.int32, device=v.device)
    for shift in (32, 16, 8, 4, 2, 1):
        big = ~u64_le(v, (1 << shift) - 1)          # v >= 2**shift
        bits = bits + torch.where(big, shift, 0).to(torch.int32)
        v = torch.where(big, shr(v, shift), v)
    bits = bits + v.to(torch.int32)                 # +1 when any bit remains
    return torch.clamp((bits + 7) // 8, min=1).to(torch.int32)


def spill_arrays(capacity: int, *, device):
    """The cold spill tier's planes: append-only (keys, vals), bool
    tombstones and bool run-start marks."""
    keys, vals = kv_arrays(capacity, device=device)
    z = torch.zeros(capacity, dtype=torch.bool, device=device)
    return keys, vals, z, z.clone()


# MAX_SPILL_RUNS: the static cap on live sorted runs in a spill tier (the
# run-boundary plane the probes search is this long + 1). The thresholds
# below are the tier stack's compaction policy (`store.tiers.spill_maintain`):
#   SPILL_COMPACT_DEAD_FRAC  compact when tombstones exceed 1/FRAC of the
#                            appended total
#   SPILL_RUNS_PER_APPLY     most runs one apply can append (eviction
#                            demotes, insert overflow, promotion demotes)
MAX_SPILL_RUNS = 16
SPILL_COMPACT_DEAD_FRAC = 4
SPILL_RUNS_PER_APPLY = 3


def run_offsets(run_start: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """The run-boundary plane: int32 `[MAX_SPILL_RUNS + 1]`, entry r =
    start cell of run r, every entry past the live run count (and the
    sentinel) = the append cursor `n`. Run r spans `[off[r], off[r + 1])`.

    The reference scatters every cell with a `min` into the plane; on the
    card that is `S` atomics on one sentinel cell (milliseconds at
    S = 2^23). Run r starts at the first cell where the running count of
    run starts reaches r + 1, so a searchsorted over that count gives the
    same plane with `MAX_SPILL_RUNS` lookups."""
    dev = run_start.device
    count = torch.cumsum(run_start.to(torch.int32), 0, dtype=torch.int32)
    want = torch.arange(1, MAX_SPILL_RUNS + 1, dtype=torch.int32, device=dev)
    pos = torch.searchsorted(count, want, out_int32=True)
    n = n.to(torch.int32).reshape(1)
    return torch.cat([torch.minimum(pos, n), n])


class SpillLayout(NamedTuple):
    """A spill tier's probe view: int64 keys, int8 tombstones and the
    run-boundary plane. Values stay outside the kernels."""
    keys: torch.Tensor      # [S] int64
    dead: torch.Tensor      # [S] int8
    run_off: torch.Tensor   # [MAX_SPILL_RUNS + 1] int32

    MAX_RUNS = MAX_SPILL_RUNS
    COMPACT_DEAD_FRAC = SPILL_COMPACT_DEAD_FRAC
    RUNS_PER_APPLY = SPILL_RUNS_PER_APPLY


def spill_layout(keys, dead, run_start, n) -> SpillLayout:
    """SpillTier planes -> kernel view."""
    return SpillLayout(keys=keys.contiguous(), dead=dead.view(torch.int8),
                       run_off=run_offsets(run_start, n))


# ---------------------------------------------------------------------------
# level-major skiplist view (det_skiplist -> skiplist_search kernel)
# ---------------------------------------------------------------------------

class SkiplistLayout(NamedTuple):
    """The deterministic skiplist as flat planes for the level walk.

    Level r (bottom-up, r = 0 is the lowest index level) occupies
    `[offsets[r], offsets[r + 1])` of `lvl_keys` / `lvl_child`; `c1` is
    the widest level's capacity, i.e. the row width of the reference's
    padded rectangle, which sets the walk's index clipping."""
    lvl_keys: torch.Tensor   # [sum C_l] int64 max-of-group keys
    lvl_child: torch.Tensor  # [sum C_l] int32 group start in the level below
    lvl_off: torch.Tensor    # [L + 1] int32 level offsets (device copy)
    offsets: tuple           # the same offsets as Python ints
    c1: int
    term_keys: torch.Tensor  # [C] int64
    term_mark: torch.Tensor  # [C] int8 tombstones

    @property
    def num_levels(self) -> int:
        return len(self.offsets) - 1


@functools.lru_cache(maxsize=None)
def _offset_table(offsets: tuple, device: torch.device) -> torch.Tensor:
    """The level offsets as a device tensor, made once per (shape, device):
    they depend on the capacity only."""
    return torch.tensor(offsets, dtype=torch.int32, device=device)


def skiplist_layout(s) -> SkiplistLayout:
    """DetSkiplist -> flat level view. The state keeps its levels as views
    of one flat buffer per plane (`det_skiplist.LevelPlanes`) and the
    tombstones are viewed as int8, so this copies nothing."""
    offs = s.level_keys.offsets
    return SkiplistLayout(
        lvl_keys=s.level_keys.flat, lvl_child=s.level_child.flat,
        lvl_off=_offset_table(offs, s.term_keys.device), offsets=offs,
        c1=offs[1] - offs[0], term_keys=s.term_keys.contiguous(),
        term_mark=s.term_mark.view(torch.int8))


# ---------------------------------------------------------------------------
# block-major B-skiplist view (det_skiplist -> bskiplist_walk kernel)
# ---------------------------------------------------------------------------

# One B-skiplist node holds this many sorted keys (a warp reads a node as
# 32 lanes x 4 keys).
BSKIP_BLOCK = 128


class BSkiplistLayout(NamedTuple):
    """The deterministic skiplist re-blocked into fat nodes of `BSKIP_BLOCK`
    sorted keys, derived at probe time from the unchanged state.

    Index rows are stacked bottom-up into `blk` ([L, W], row L-1 is the
    root node; node j of a row spans cells [j*B, (j+1)*B); W = the widest
    row's node count * B, `KEY_INF` padding). Row 0 holds the maxima of
    the NB = ceil(C / B) terminal blocks; each row above holds the maxima
    of the nodes of the row below. The reference pads the terminal planes
    to NB*B cells; here they are the state's own [C] planes, read with
    the padded length `n_pad`: a read at or past C sees a `KEY_INF` key
    and mark 0, so nothing of size C is copied per dispatch."""
    blk: torch.Tensor        # [L, W] int64 index-node entries
    term_keys: torch.Tensor  # [C] int64
    term_mark: torch.Tensor  # [C] int8 tombstones
    n_pad: int               # NB * B

    @property
    def num_levels(self) -> int:
        return self.blk.shape[0]


def bskip_num_levels(capacity: int, block: int = BSKIP_BLOCK) -> int:
    """Index rows a `bskiplist_layout` over `capacity` terminals has; the
    blocked walk makes this + 1 whole-block compares."""
    nb = -(-capacity // block)
    levels = 1
    while -(-nb // block) > 1:
        nb = -(-nb // block)
        levels += 1
    return levels


def bskiplist_layout(s, block: int = BSKIP_BLOCK) -> BSkiplistLayout:
    """DetSkiplist (or any state with sorted, KEY_INF-padded `term_keys`
    and `term_mark`) -> block-major view. A block's maximum is its LAST
    entry (blocks are sorted, padding at the end), so every row is a
    strided view of the row below: row 0 is `term_keys[B-1::B]` (plus a
    `KEY_INF` maximum for a ragged last block). Only the ~C/B index cells
    are written."""
    B = block
    C = s.term_keys.shape[0]
    n = -(-C // B)                       # terminal blocks = row-0 entries
    blk = torch.full((bskip_num_levels(C, B), -(-n // B) * B), KEY_INF,
                     dtype=torch.int64, device=s.term_keys.device)
    blk[0, :C // B] = s.term_keys[B - 1::B]
    for r in range(1, blk.shape[0]):
        nodes = -(-n // B)               # nodes of row r - 1 = entries of r
        blk[r, :nodes] = blk[r - 1, B - 1:nodes * B:B]
        n = nodes
    return BSkiplistLayout(blk=blk, term_keys=s.term_keys.contiguous(),
                           term_mark=s.term_mark.view(torch.int8),
                           n_pad=-(-C // B) * B)


def warm_layout_of(cold, warm_layout: str):
    """The warm tier's view for the fused tier kernels: the block-major
    B-skiplist rows (`"block"`) or the level-major levels (`"level"`)."""
    return bskiplist_layout(cold) if warm_layout == "block" else \
        skiplist_layout(cold)


# ---------------------------------------------------------------------------
# bucket-major hash view (FixedHash -> hash_probe kernel)
# ---------------------------------------------------------------------------

def hash_slot(keys: torch.Tensor, num_slots: int) -> torch.Tensor:
    """The shared slot function: s = splitmix64(k) mod M (M a power of
    two), int32."""
    return (hash64(keys) & (num_slots - 1)).to(torch.int32)
