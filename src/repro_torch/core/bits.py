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
    """Logical right shift by a static 0 <= s < 64 (int64 `>>` is
    arithmetic, so the sign-extended high bits are masked off)."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer on int64 bit patterns (wrapping arithmetic)."""
    x = x + i64(0x9E3779B97F4A7C15)
    x = (x ^ shr(x, 30)) * i64(0xBF58476D1CE4E5B9)
    x = (x ^ shr(x, 27)) * i64(0x94D049BB133111EB)
    return x ^ shr(x, 31)


def hash64(x: torch.Tensor) -> torch.Tensor:
    return splitmix64(x)


def bitrev64(x: torch.Tensor) -> torch.Tensor:
    """Reverse the 64 bits (split-ordering sorts keys by reversed hash):
    the reference's log-step swap network, with every right shift
    logical (`shr`): `(x & 0xAAAA...) >> 1` on int64 would smear the
    sign bit."""
    for s, m in ((1, 0x5555555555555555), (2, 0x3333333333333333),
                 (4, 0x0F0F0F0F0F0F0F0F), (8, 0x00FF00FF00FF00FF),
                 (16, 0x0000FFFF0000FFFF)):
        lo, hi = i64(m), i64(m << s)
        x = ((x & lo) << s) | shr(x & hi, s)
    return (x << 32) | shr(x, 32)


def geometric_height(key: torch.Tensor, max_height: int,
                     p_shift: int = 2) -> torch.Tensor:
    """Random-skiplist node height from the key's hash, P(h >= j) =
    (1/4)^j: the count of consecutive zero 2-bit groups from the LSB of
    splitmix64(key), capped at `max_height` (int32)."""
    h = splitmix64(key)
    height = torch.zeros(key.shape, dtype=torch.int32, device=key.device)
    alive = torch.ones(key.shape, dtype=torch.bool, device=key.device)
    for j in range(max_height):
        alive = alive & ((shr(h, p_shift * j) & ((1 << p_shift) - 1)) == 0)
        height = height + alive.to(torch.int32)
    return height


def make_priority_key(priority: torch.Tensor,
                      ticket: torch.Tensor) -> torch.Tensor:
    """(priority, ticket) -> orderable u64 bit pattern: priority in the
    high 32 bits, the ticket's low 32 bits below it (the scheduler's key;
    the ticket breaks ties in linearization order)."""
    return (priority.to(torch.int64) << 32) | (ticket.to(torch.int64)
                                               & 0xFFFFFFFF)


def pack_key_payload(key_hi32: torch.Tensor,
                     payload: torch.Tensor) -> torch.Tensor:
    """A 32-bit key tag and a 32-bit payload in one u64 (its int64 bit
    pattern): tag in the high half, payload's low 32 bits in the low."""
    hi = key_hi32.to(torch.int64) & 0xFFFFFFFF
    return (hi << 32) | (payload.to(torch.int64) & 0xFFFFFFFF)


def unpack_key_payload(word: torch.Tensor):
    """(tag, payload) of `pack_key_payload`'s words, each the u32's bits
    in an int64 (torch's uint32 lacks shifts and compares)."""
    return shr(word, 32), word & 0xFFFFFFFF


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
