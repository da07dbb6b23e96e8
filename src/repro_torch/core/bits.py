"""Key/bit utilities: the u64 rules of the port, in one place.

The reference keeps keys as uint64 with x64 enabled. PyTorch's UInt64 lacks
ordered compares, `>>`, `max` and `searchsorted`, so every u64 travels here
as its int64 BIT PATTERN (`torch.int64`, same 8 bytes), under three rules:

* Ordered compares and sorts use the sign-flipped copy `x ^ (1 << 63)`
  (`ordered`), which maps unsigned order onto signed order; `KEY_INF`
  (all ones, -1 as int64) therefore still sorts last.
* Logical right shifts are masked (`shr`): int64 `>>` is arithmetic.
* `splitmix64` relies on wrapping int64 add/multiply, which gives the same
  low 64 bits as the u64 arithmetic.

CUDA kernels reinterpret the int64 storage as `unsigned long long` and
compare natively; no (hi, lo) u32 split exists on the card.
"""
from __future__ import annotations

import numpy as np
import torch

# Sentinels (int64 bit patterns): the paper's head key 2**64 - 1 is +inf
# padding ("tail"); 2**64 - 2 is the largest storable key.
KEY_INF = -1                   # 0xFFFFFFFFFFFFFFFF
KEY_MAX = -2                   # 0xFFFFFFFFFFFFFFFE
EMPTY = KEY_INF                # empty hash-table slot marker

_SIGN = -(1 << 63)             # the sign bit as an int64 value


def i64(c: int) -> int:
    """A u64 constant (0 <= c < 2**64) as its int64 bit pattern."""
    c &= (1 << 64) - 1
    return c - (1 << 64) if c >= (1 << 63) else c


def from_u64(a, device) -> torch.Tensor:
    """numpy uint64 (or anything numpy can view as u64) -> int64 tensor with
    the same bits, on `device`."""
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint64))
    return torch.from_numpy(a.view(np.int64).copy()).to(device)


def ordered(x: torch.Tensor) -> torch.Tensor:
    """Sign-flipped copy whose signed order is x's unsigned order."""
    return x ^ _SIGN


def u64_lt(a, b) -> torch.Tensor:
    """Unsigned a < b over int64 bit patterns."""
    return ordered(a) < ordered(b)


def u64_le(a, b) -> torch.Tensor:
    """Unsigned a <= b over int64 bit patterns."""
    return ordered(a) <= ordered(b)


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift by a static 0 < s < 64 (int64 `>>` is
    arithmetic, so the sign-extended high bits are masked off)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer on int64 bit patterns (wrapping arithmetic)."""
    x = x + i64(0x9E3779B97F4A7C15)
    x = (x ^ shr(x, 30)) * i64(0xBF58476D1CE4E5B9)
    x = (x ^ shr(x, 27)) * i64(0x94D049BB133111EB)
    return x ^ shr(x, 31)


def hash64(x: torch.Tensor) -> torch.Tensor:
    return splitmix64(x)


def make_priority_key(priority: torch.Tensor,
                      ticket: torch.Tensor) -> torch.Tensor:
    """(priority, ticket) -> orderable u64 bit pattern: priority in the
    high 32 bits, the ticket's low 32 bits below it (the scheduler's key;
    the ticket breaks ties in linearization order)."""
    return (priority.to(torch.int64) << 32) | (ticket.to(torch.int64)
                                               & 0xFFFFFFFF)


def dup_in_run(same_as_prev: torch.Tensor, masked: torch.Tensor) -> torch.Tensor:
    """In-batch duplicate mask over a SORTED batch: True for every masked
    lane that is not the FIRST MASKED lane of its equal-key run.

    `same_as_prev[i]` says lane i has the same key(s) as lane i-1
    (`same_as_prev[0]` is False). The run start is a running max of the
    run-opening lane ids (`torch.cummax`, the reference's associative max
    scan); the first masked lane of a run wins."""
    k = same_as_prev.shape[0]
    idx = torch.arange(k, dtype=torch.int32, device=masked.device)
    run_first = torch.cummax(torch.where(~same_as_prev, idx, -1), 0).values.long()
    m_i = masked.to(torch.int32)
    c = torch.cumsum(m_i, 0, dtype=torch.int32)
    before = c[run_first] - m_i[run_first]
    rank = c - m_i - before
    return masked & (rank > 0)
