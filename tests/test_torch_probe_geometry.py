"""The host side of the redesigned hash_probe and splitorder_probe kernels,
and numpy mirrors of their team bodies, on the CPU.

The kernels run only on the card (chip_smoke.py holds them bit for bit
against their plain versions there, at every team width, on edge sweeps).
Here: the shared team-width rule (`cuda.team_width`) as both wrappers apply
it, with the H100's occupancy of each instance, against the instances the
CUDA sources have; a mirror of `team_bucket_row` (lane l of a team reads
columns l, l + TEAM, ...; the ballots put column c at bit c; the hit column
is the lowest set bit, 0 on a miss) against `hash_probe_ref` at every
width; and a mirror of the split-order kernel (a team's (TEAM + 1)-ary
search of the row with the kernel's integer pivots, down to a few cells,
then one round over those cells and the window after them, a key read
behind each rk match) against `splitorder_probe_ref` at every width, on
edge cases at small row lengths, and its rounds on the main path's row.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.bits import from_u64
from repro_torch.kernels.hash_probe import kernel as hpk
from repro_torch.kernels.hash_probe.ref import hash_probe_ref
from repro_torch.kernels.splitorder_probe import kernel as sok
from repro_torch.kernels.splitorder_probe.ref import WINDOW, \
    splitorder_probe_ref

CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc")
H100_SMS = 132
INF = np.uint64(2**64 - 1)

# resident threads an SM of each instance on an H100, as the occupancy API
# gives them for the build's registers (chip_smoke.py's edge sweeps print
# them): hash_probe's team of one holds 16 keys in registers (45 of them),
# splitorder_probe's its last round's 8 cells (launch bounds of 4 blocks)
HP_SLOTS = {16: 2048, 8: 2048, 4: 2048, 2: 2048, 1: 1280}
SO_SLOTS = {16: 2048, 8: 2048, 1: 1536}


# ---------------------------------------------------------------------------
# the team-width rule against the sources
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 4096, 65536])
def test_team_width_rule(k):
    """The widest team whose k teams are all resident on the H100: 16
    lanes at a workload plan for both kernels; at a preload plan 4 for
    hash_probe and one lane (a binary search) for splitorder_probe."""
    team = hpk.probe_team(k, H100_SMS, HP_SLOTS.get)
    assert team == {1: 16, 4096: 16, 65536: 4}[k]
    assert k * team <= H100_SMS * HP_SLOTS[team]
    team = sok.probe_team(k, H100_SMS, SO_SLOTS.get)
    assert team == {1: 16, 4096: 16, 65536: 1}[k]
    assert k * team <= H100_SMS * SO_SLOTS[team]
    # one SM of 2,048 slots: a wide plan takes the narrowest instance
    assert hpk.probe_team(k, 1, lambda t: 2048) == {1: 16, 4096: 1,
                                                    65536: 1}[k]
    assert sok.probe_team(k, 1, lambda t: 2048) == {1: 16, 4096: 1,
                                                    65536: 1}[k]


def _instances(file: str) -> set:
    """The team widths a source's launcher dispatches to, which must be
    those its occupancy export answers for."""
    src = (CSRC / file).read_text()
    launched = {int(t) for t in re.findall(r"case (\d+): \w+_LAUNCH\(\1\)",
                                           src)}
    answered = {int(t) for t in re.findall(
        r"case (\d+): return \w+_slots<\1>\(\)", src)}
    assert launched and launched == answered, file
    return launched


def test_every_width_the_rules_pick_is_instantiated():
    """Each kernel's widths (`TEAMS`, widest first) are exactly its
    source's instances, and at every plan width up to 2^20 lanes the rule
    picks one of them, narrowing as plans widen."""
    assert _instances("hash_probe.cu") == set(hpk.TEAMS)
    assert _instances("splitorder_probe.cu") == set(sok.TEAMS)
    for mod, slots in ((hpk, HP_SLOTS), (sok, SO_SLOTS)):
        assert list(mod.TEAMS) == sorted(mod.TEAMS, reverse=True)
        ks = [1, 100, 4096, 16896, 16897, 33792, 33793, 65536, 67584,
              67585, 135168, 135169, 168960, 270336, 270337, 1 << 20]
        picks = [mod.probe_team(k, H100_SMS, slots.get) for k in ks]
        assert all(p in mod.TEAMS for p in picks)
        assert picks == sorted(picks, reverse=True)
    src = (CSRC / "splitorder_probe.cu").read_text()
    assert re.search(r"#define SO_MAX_ROW \(1 << 27\)", src)
    assert sok.MAX_ROW == 1 << 27
    bucket = re.search(r"#define MAX_BUCKET (\d+)",
                       (CSRC / "probe.cuh").read_text())
    assert hpk.MAX_BUCKET == int(bucket.group(1))


# ---------------------------------------------------------------------------
# hash_probe: the team bucket row
# ---------------------------------------------------------------------------

def team_bucket_row(row, q, team):
    """`team_bucket_row` for one query: lane l holds columns l + j * team
    (j < ceil(16 / team)); ballot j of the team's lanes, shifted by
    j * team, sets bit c for each column c holding q."""
    b = len(row)
    hits = 0
    for j in range(-(-16 // team)):
        bits = 0
        for lane in range(team):
            c = lane + j * team
            if c < b and row[c] == q:
                bits |= 1 << lane
        hits |= bits << (j * team)
    return hits


def hash_probe_mirror(q, slots, plane, team):
    """The kernel's (found, col): the clipped slot's row, found = any hit,
    col = the lowest set bit (0 on a miss)."""
    m = plane.shape[0]
    found, col = [], []
    for qi, s in zip(q, slots):
        hits = team_bucket_row(plane[min(max(int(s), 0), m - 1)], qi, team)
        found.append(int(hits != 0))
        col.append((hits & -hits).bit_length() - 1 if hits else 0)
    return np.array(found, np.int8), np.array(col, np.int32)


def _bucket_plane(rng, m, b):
    """Rows filled from column 0, KEY_INF after; row 0 full, row 1 empty,
    row 2 full with one key at columns 1 and b - 2."""
    plane = rng.integers(1, 2**64 - 2, (m, b), dtype=np.uint64)
    fill = rng.integers(0, b + 1, m)
    fill[0], fill[1], fill[2] = b, 0, b
    plane[np.arange(b)[None, :] >= fill[:, None]] = INF
    plane[2, b - 2] = plane[2, 1]
    return plane


@pytest.mark.parametrize("team", hpk.TEAMS)
def test_team_bucket_row_is_hash_probe_ref(team):
    """At every width, on rows of 16 and of 5 columns: hits at the first
    and last columns, a key held twice (the lowest column wins), full and
    empty rows, slots below 0 and past M - 1, KEY_INF queries, stored keys
    and fresh ones."""
    rng = np.random.default_rng(team)
    for b in (16, 5):
        m = 37
        plane = _bucket_plane(rng, m, b)
        stored = np.argwhere(plane != INF)
        pick = stored[rng.integers(0, len(stored), 300)]
        q = np.where(rng.random(300) < 0.7, plane[pick[:, 0], pick[:, 1]],
                     rng.integers(1, 2**64 - 2, 300, dtype=np.uint64))
        s = np.where(rng.random(300) < 0.8, pick[:, 0],
                     rng.integers(-3, m + 3, 300)).astype(np.int32)
        special = [(plane[0, 0], 0), (plane[0, b - 1], 0), (plane[2, 1], 2),
                   (plane[0, 1], -7), (plane[m - 1, 0], m + 5), (INF, 1),
                   (INF, 0), (q[0], 1)]
        for i, (qq, ss) in enumerate(special):
            q[i], s[i] = qq, ss
        want = hash_probe_ref(from_u64(q, "cpu"), torch.from_numpy(s),
                              from_u64(plane.reshape(-1), "cpu")
                              .reshape(m, b))
        got = hash_probe_mirror(q, s, plane, team)
        assert np.array_equal(got[0], want[0].numpy())
        assert np.array_equal(got[1], want[1].numpy())
        assert got[1][2] == 1 and got[0][2] == 1          # lowest of two
        assert got[1][1] == b - 1 and got[0][5] == 1      # last col; INF row
        assert got[0][6] == 0                             # INF on a full row


# ---------------------------------------------------------------------------
# splitorder_probe: the team row search and the window
# ---------------------------------------------------------------------------

def team_narrow(row, q, team, stop):
    """`team_kary_search<TEAM, true>` on one row: each round the team's
    lanes read the pivots lo + (u + 1) n // (team + 1), u < team, of the
    open interval [lo, lo + n) (an interval of at most `team` cells is read
    whole), and the count below q narrows it, until it holds at most
    `stop` cells. Returns (lo, hi, rounds)."""
    lo, hi = 0, len(row)
    rounds = 0
    while hi - lo > stop:
        n = hi - lo
        rounds += 1
        if n <= team:
            lo += sum(int(row[lo + j]) < q for j in range(n))
            hi = lo
            break
        piv = [lo + (u + 1) * n // (team + 1) for u in range(team)]
        below = [int(row[p]) < q for p in piv]
        cnt = sum(below)
        assert below == [True] * cnt + [False] * (team - cnt)  # a prefix
        nlo = piv[cnt - 1] + 1 if cnt > 0 else lo
        if cnt < team:
            hi = piv[cnt]
        lo = nlo
    return lo, hi, rounds


def last_round(team):
    """(J, F): the cells a lane reads in the kernel's last round and the
    interval the search narrows to before it (J * team - WINDOW)."""
    j = 2 * WINDOW if team == 1 else 2
    return j, j * team - WINDOW


def splitorder_mirror(q_rk, q_key, tables, rk, keys, team):
    """The kernel's (found, at): the clipped table's row narrowed by a
    team to at most F cells, then one round over those cells and the
    WINDOW after them: q's position is lo + the cells below q, window cell
    w is cell `below + w` (clipped to C2 - 1), a key read only behind an
    rk match; the first match wins (at clip(pos) on a miss). Returns
    (found, at, rounds)."""
    n_tables, c2 = rk.shape
    found, at, rounds = [], [], []
    _, stop = last_round(team)
    for qr, qk, t in zip(q_rk, q_key, tables):
        tb = min(max(int(t), 0), n_tables - 1)
        lo, hi, r = team_narrow(rk[tb], int(qr), team, stop)
        n = hi - lo
        cell = [rk[tb, min(max(lo + i, 0), c2 - 1)] for i in range(n + WINDOW)]
        below = sum(int(c) < int(qr) for c in cell[:n])
        hits = 0
        for w in range(WINDOW):
            c = min(max(lo + below + w, 0), c2 - 1)
            if cell[below + w] == qr and keys[tb, c] == qk:
                hits |= 1 << w
        off = (hits & -hits).bit_length() - 1 if hits else 0
        found.append(int(hits != 0))
        at.append(min(max(lo + below + off, 0), c2 - 1))
        rounds.append(r + 1)
    return np.array(found, np.int8), np.array(at, np.int32), rounds


def _splitorder_planes(rng, n_tables, c2):
    """Table 0 full, table 1 empty, the rest 3/4 full, rows sorted by rk
    with KEY_INF padding; table 2 holds a 5-cell run of one rk at c2 // 4,
    table 0's last 3 cells share one rk."""
    rk = np.sort(rng.integers(1, 2**64 - 2, (n_tables, c2), dtype=np.uint64),
                 axis=1)
    keys = rng.integers(1, 2**64 - 2, (n_tables, c2), dtype=np.uint64)
    fill = np.full(n_tables, 3 * c2 // 4)
    fill[0], fill[1] = c2, 0
    pad = np.arange(c2)[None, :] >= fill[:, None]
    rk[pad], keys[pad] = INF, INF
    a = c2 // 4
    rk[2, a:a + 5] = rk[2, a]
    rk[0, c2 - 3:] = rk[0, c2 - 3]
    return rk, keys, fill


@pytest.mark.parametrize("team", sok.TEAMS)
def test_team_row_search_and_window_is_splitorder_probe_ref(team):
    """At every width, on rows of 300 and 64 cells: queries below and above
    every rk of a table, the full and the empty table, tables -1 and T,
    the collision run (4 found in the window, the 5th not), KEY_INF rk
    queries, positions within 3 cells of C2 - 1 where the window clips,
    then stored (rk, key, table) triples and fresh ones."""
    rng = np.random.default_rng(100 + team)
    top = np.uint64(2**64 - 2)
    for n_tables, c2 in ((5, 300), (8, 64)):
        rk, keys, fill = _splitorder_planes(rng, n_tables, c2)
        a, e = c2 // 4, c2 - 3
        stored = np.argwhere(rk != INF)
        k = 200
        pick = stored[rng.integers(0, len(stored), k)]
        hit = rng.random(k) < 0.7
        qr = np.where(hit, rk[pick[:, 0], pick[:, 1]],
                      rng.integers(1, 2**64 - 2, k, dtype=np.uint64))
        qk = np.where(hit, keys[pick[:, 0], pick[:, 1]],
                      rng.integers(1, 2**64 - 2, k, dtype=np.uint64))
        tb = np.where(hit, pick[:, 0],
                      rng.integers(0, n_tables, k)).astype(np.int32)
        special = [  # (rk, key, table, (found, at))
            (np.uint64(0), qk[0], 3, (0, 0)),
            (top, qk[1], 3, (0, fill[3])),
            (rk[0, 9], keys[0, 9], -1, (1, 9)),
            (rk[n_tables - 1, 3], keys[n_tables - 1, 3], n_tables, (1, 3)),
            (qr[2], qk[2], 1, (0, 0)),
            (INF, INF, 1, (1, 0)),
            (INF, qk[3], 3, (0, fill[3])),
            (rk[0, e], keys[0, c2 - 1], 0, (1, c2 - 1)),
            (rk[0, e], qk[4], 0, (0, e)),
            (top, qk[5], 0, (0, c2 - 1))]
        special += [(rk[2, a], keys[2, a + j], 2,
                     (1, a + j) if j < 4 else (0, a)) for j in range(5)]
        for i, (r, kk, t, _) in enumerate(special):
            qr[i], qk[i], tb[i] = r, kk, t
        args = (from_u64(qr, "cpu"), from_u64(qk, "cpu"),
                torch.from_numpy(tb), from_u64(rk.reshape(-1), "cpu")
                .reshape(n_tables, c2), from_u64(keys.reshape(-1), "cpu")
                .reshape(n_tables, c2))
        want = splitorder_probe_ref(*args)
        got = splitorder_mirror(qr, qk, tb, rk, keys, team)
        assert got[1].min() >= 0 and got[1].max() < c2
        assert np.array_equal(got[0], want[0].numpy())
        assert np.array_equal(got[1], want[1].numpy())
        for i, (*_, expect) in enumerate(special):
            assert (got[0][i], got[1][i]) == expect, i


@pytest.mark.parametrize("team", sok.TEAMS)
def test_team_row_search_rounds(team):
    """On a 2^21-cell row 3/4 full (the main path's), an empty one and a
    full one: narrowed to nothing, the search gives
    np.searchsorted(side="left") in at most ceil(log_(team + 1)(2^21)) + 1
    rounds; the kernel's narrowing to F cells and its last round take 20
    rounds at one lane (a binary search takes 22 and then the window), 7
    at 8 and 5 at 16."""
    rng = np.random.default_rng(7 + team)
    c2 = 1 << 21
    bound = int(np.ceil(21 / np.log2(team + 1))) + 1
    _, stop = last_round(team)
    kernel_rounds = {1: 20, 8: 7, 16: 5}[team]
    for fill in (3 * c2 // 4, 0, c2):
        row = np.full(c2, INF, dtype=np.uint64)
        row[:fill] = np.sort(rng.integers(1, 2**64 - 2, fill, dtype=np.uint64))
        qs = [np.uint64(0), INF, np.uint64(2**64 - 2)] + list(
            rng.integers(1, 2**64 - 2, 12, dtype=np.uint64))
        if fill:
            qs += list(row[rng.integers(0, fill, 12)])
        for q in qs:
            pos, hi, rounds = team_narrow(row, int(q), team, 0)
            assert pos == hi == int(np.searchsorted(row, q, "left"))
            assert rounds <= bound
            lo, hi, rounds = team_narrow(row, int(q), team, stop)
            assert lo <= pos <= hi and hi - lo <= stop
            assert rounds + 1 <= kernel_rounds
