"""The host side of the redesigned tier_find and bskiplist_walk kernels, and
numpy mirrors of their team searches, on the CPU.

The kernels run only on the card (chip_smoke.py holds them bit for bit
against their plain versions there, at every team width their rules
pick). Here: the shared team-width rule (`cuda.team_width`) as both
wrappers apply it, with the H100's occupancy of each instance, against the
instances the CUDA sources have; and mirrors of the team bodies in
`csrc/probe.cuh`, with the kernels' float pivots: the (g + 1)-ary search
of one sorted run against `np.searchsorted(side="left")` at every group
size g, the whole team spill probe (runs split over the team's groups, in
passes) against the plain `spill_run_probe_ref`, and the team block walk
(a whole-node count or a search of each sorted node) against
`np.searchsorted` node by node and against `bskiplist_walk_ref`.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import det_skiplist as tdsl
from repro_torch.core.bits import from_u64
from repro_torch.core.layout import BSKIP_BLOCK, bskiplist_layout
from repro_torch.kernels import cuda
from repro_torch.kernels.bskiplist_walk import kernel as bwk
from repro_torch.kernels.bskiplist_walk.ref import bskiplist_walk_ref
from repro_torch.kernels.tier_apply import kernel as ta
from repro_torch.kernels.tier_find import kernel as tfk
from repro_torch.kernels.tier_find.ref import spill_run_probe_ref

CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc")
H100_SMS = 132
INF = np.uint64(2**64 - 1)
F32 = np.float32

# resident threads an SM of each instance on an H100, as the occupancy API
# gives them for the build's registers (chip_smoke.py's edge sweeps print
# them)
TF_SLOTS = {"level": {16: 1024, 8: 1024, 4: 1024, 2: 1024, 1: 1024},
            "block": {32: 1024, 16: 1280, 8: 1280, 4: 1280, 2: 1280,
                      1: 1280}}
BW_SLOTS = {32: 2048, 2: 2048, 1: 2048}


# ---------------------------------------------------------------------------
# the team-width rule against the sources
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 4096, 65536])
def test_team_width_rule(k):
    """The widest team whose k teams are all resident on the H100, down to
    each kernel's narrowest instance; tier_apply's level membership keeps
    its rule through the shared function."""
    want = {"level": {1: 16, 4096: 16, 65536: 2},
            "block": {1: 32, 4096: 32, 65536: 2}}
    for layout in ("level", "block"):
        slots = TF_SLOTS[layout]
        team = tfk.find_team(k, layout, H100_SMS, slots.get)
        assert team == want[layout][k], (layout, k)
        assert k * team <= H100_SMS * slots[team] or team == min(slots)
    team = bwk.walk_team(k, H100_SMS, BW_SLOTS.get)
    assert team == {1: 32, 4096: 32, 65536: 2}[k]
    assert k * team <= H100_SMS * BW_SLOTS[team]
    # one SM of 2,048 slots: a wide plan takes the narrowest instance
    assert tfk.find_team(k, "level", 1, lambda t: 2048) == \
        {1: 16, 4096: 1, 65536: 1}[k]
    assert bwk.walk_team(k, 1, lambda t: 2048) == {1: 32, 4096: 1,
                                                   65536: 1}[k]
    assert ta.member_team(k, "level", 1, lambda t: 2048) == \
        tfk.find_team(k, "level", 1, lambda t: 2048)


def _instances(file: str) -> set:
    """The (team, blocked) instances a source's launcher dispatches to, and
    those its occupancy export answers for, which must be the same."""
    src = (CSRC / file).read_text()

    def found(pattern):
        return {(int(t), b == "true") for t, b in re.findall(pattern, src)}
    launched = found(r"case (\d+): \w+_LAUNCH\(\1(?:, (true|false))?\)")
    answered = found(r"case (\d+): return \w+_slots<\1(?:, (true|false))?>")
    assert launched and launched == answered, file
    return launched


def test_every_width_the_rules_pick_is_instantiated():
    """Each kernel's widths (`TEAMS`) are exactly its source's instances,
    and at every plan width up to 2^20 lanes the rules pick one of them,
    narrowing as plans widen."""
    tf = _instances("tier_find.cu")
    assert tf == {(t, False) for t in tfk.TEAMS["level"]} | \
        {(t, True) for t in tfk.TEAMS["block"]}
    bw = _instances("bskiplist_walk.cu")
    assert bw == {(t, False) for t in bwk.TEAMS}
    ks = [1, 100, 4096, 4224, 4225, 8448, 8449, 16896, 16897, 33792, 33793,
          42240, 42241, 65536, 67584, 67585, 84480, 84481, 135168, 135169,
          168960, 168961, 1 << 20]
    for layout in ("level", "block"):
        picks = [tfk.find_team(k, layout, H100_SMS, TF_SLOTS[layout].get)
                 for k in ks]
        assert all((p, layout == "block") in tf for p in picks)
        assert picks == sorted(picks, reverse=True)
    picks = [bwk.walk_team(k, H100_SMS, BW_SLOTS.get) for k in ks]
    assert all((p, False) in bw for p in picks)
    assert picks == sorted(picks, reverse=True)
    assert cuda.team_width(10**9, (16, 4, 1), H100_SMS, lambda t: 0) == 1
    assert cuda.team_width(0, (16, 4, 1), H100_SMS, lambda t: 0) == 16
    assert cuda.team_width(3, (16, 4, 1), 1, lambda t: 12) == 4


# ---------------------------------------------------------------------------
# numpy mirrors of the team searches
# ---------------------------------------------------------------------------

def kary_pivot(lo, n, u, part):
    """probe.cuh `kary_pivot`, in the kernel's float32 arithmetic."""
    return lo + min(int(F32(u + 1) * (F32(n) * part)), n - 1)


def kary_search(key_at, lo, hi, q, g):
    """A group of g lanes' (g + 1)-ary search of [lo, hi) for q's
    searchsorted-left position; `key_at(p)` reads a cell. Returns
    (position, rounds)."""
    part = F32(1) / F32(g + 1)
    rounds = 0
    while lo < hi:
        n = hi - lo
        rounds += 1
        if n <= g:
            cnt = sum(key_at(lo + j) < q for j in range(n))
            lo += cnt
            hi = lo
            continue
        piv = [kary_pivot(lo, n, u, part) for u in range(g)]
        below = [key_at(p) < q for p in piv]
        cnt = sum(below)
        assert below == [True] * cnt + [False] * (g - cnt)   # a prefix
        nlo = kary_pivot(lo, n, cnt - 1, part) + 1 if cnt > 0 else lo
        if cnt < g:
            hi = kary_pivot(lo, n, cnt, part)
        lo = nlo
    return lo, rounds


def _sorted_keys(rng, n, dup=False):
    k = rng.integers(1, 2**64 - 2, n, dtype=np.uint64)
    if dup and n > 3:
        k[: n // 3] = k[0]
    return np.sort(k)


@pytest.mark.parametrize("g", [1, 2, 4, 8, 16, 32])
def test_kary_search_is_searchsorted_left(g):
    """One run's (g + 1)-ary search gives np.searchsorted(side="left") on
    runs of 0, 1, 2, g, g + 1, 300 and 2^19 cells (one with a long run of
    equal keys), for q = 0, 2^64 - 1, stored keys, the keys beside them
    and fresh ones; its rounds stay within ceil(log_(g+1)(n)) + 1."""
    rng = np.random.default_rng(g)
    for n in (0, 1, 2, g, g + 1, 300, 1 << 19):
        for dup in (False, True):
            keys = _sorted_keys(rng, n, dup)
            base = int(rng.integers(0, 50))
            cells = np.concatenate([np.full(base, INF), keys])
            qs = [np.uint64(0), INF] + list(rng.integers(
                1, 2**64 - 2, 8, dtype=np.uint64))
            if n:
                pick = keys[rng.integers(0, n, min(n, 16))]
                qs += list(pick) + [np.uint64(int(x) + 1) for x in pick] + \
                    [np.uint64(int(x) - 1) for x in pick]
            for q in qs:
                pos, rounds = kary_search(lambda p: cells[p], base, base + n,
                                          q, g)
                assert pos == base + int(np.searchsorted(keys, q, "left"))
                if n > 1:
                    assert rounds <= np.ceil(np.log(n) / np.log(g + 1)) + 1


def team_spill_mirror(q, keys, dead, run_off, lanes):
    """`team_spill_probe` for one query, its team having `lanes` lanes: the
    non-empty runs in groups of g = lanes / G (G the power of two >= their
    count, at most lanes), passes of G runs, each run's (g + 1)-ary search,
    the first live match in run order; a miss reports the clipped
    position in run 0. Returns (found, cell)."""
    s = len(keys)
    runs = len(run_off) - 1
    live = [r for r in range(runs) if run_off[r] < run_off[r + 1]]
    groups = 1
    while groups < len(live) and groups < lanes:
        groups *= 2
    g = lanes // groups
    miss = min(max(int(run_off[0]), 0), s - 1)
    for r0 in range(0, len(live), groups):
        hit = None
        for grp in range(groups):
            if r0 + grp >= len(live):
                break
            r = live[r0 + grp]
            lo, end = int(run_off[r]), int(run_off[r + 1])
            lo, _ = kary_search(lambda p: keys[p], lo, end, q, g)
            pos = min(max(lo, 0), s - 1)
            if r0 == 0 and grp == 0 and live[0] == 0:
                miss = pos
            if hit is None and lo < end and keys[pos] == q and not dead[pos]:
                hit = pos
        if hit is not None:
            return True, hit
    return False, miss


def _spill(rng, case):
    """Spill planes of one case: sizes of its runs, the runs all of whose
    cells are tombstones, KEY_INF padding after them."""
    sizes, dead_runs = {
        "empty runs": ([0] * 16, ()),
        "one-cell run": ([0, 1, 5, 1], ()),
        "all-tombstone run": ([40, 60, 3], (1,)),
        "64 runs": ([int(x) for x in rng.integers(0, 50, 64)], (9,)),
    }[case]
    if case == "64 runs":
        sizes[0], sizes[3], sizes[9] = 0, 1, 30
    parts, dead, off = [], [], [0]
    for r, n in enumerate(sizes):
        parts.append(_sorted_keys(rng, n))
        d = (rng.random(n) < 0.2) & (n > 1)
        dead.append(np.ones(n, bool) if r in dead_runs else d)
        off.append(off[-1] + n)
    keys = np.concatenate(parts + [np.full(8, INF)])
    dead = np.concatenate(dead + [np.zeros(8, bool)])
    return keys, dead, np.array(off, np.int32)


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("case", ["empty runs", "one-cell run",
                                  "all-tombstone run", "64 runs"])
def test_team_spill_probe_mirror(case, lanes):
    """The team probe's (found, cell), at every team width, equals the
    plain per-run binary search's for every query: stored keys (live,
    tombstoned, in a one-cell run, in an all-tombstone run), q = 0,
    q = 2^64 - 1 and fresh keys."""
    rng = np.random.default_rng([lanes, len(case)])
    keys, dead, off = _spill(rng, case)
    stored = keys[: off[-1]]
    qs = np.concatenate([np.array([0, 2**64 - 1], np.uint64),
                         rng.choice(stored, min(len(stored), 40))
                         if len(stored) else np.zeros(0, np.uint64),
                         rng.integers(1, 2**64 - 2, 12, dtype=np.uint64)])
    found, cell = spill_run_probe_ref(
        from_u64(qs, "cpu"), from_u64(keys, "cpu"),
        torch.from_numpy(dead.astype(np.int8)), torch.from_numpy(off))
    got = [team_spill_mirror(q, keys, dead, off, lanes) for q in qs]
    assert [f for f, _ in got] == found.tolist()
    assert [c for _, c in got] == cell.tolist()
    if case != "empty runs":
        assert any(f for f, _ in got)
    if case in ("one-cell run", "64 runs"):
        one = keys[off[3]]
        assert team_spill_mirror(one, keys, dead, off, lanes) == (True,
                                                                 int(off[3]))
    if case == "all-tombstone run":
        assert not team_spill_mirror(keys[off[1]], keys, dead, off, lanes)[0]


def team_block_walk_mirror(q, blk, term_keys, term_mark, n_pad, g):
    """`TeamBlockWalk` reading g cells a round for one query (g = TEAM *
    PER): per node the (g + 1)-ary search of a team of g lanes (g = B: a
    warp counting the whole node in one round), cells at or past the row's end padding, never below q;
    then the match. Also checks each node's position against
    np.searchsorted(side="left") of the padded node. Returns (found,
    idx)."""
    B = BSKIP_BLOCK
    L, w = blk.shape
    cap = len(term_keys)

    def node_pos(row, end, base):
        cells = np.array([row[base + j] if base + j < end else INF
                          for j in range(B)], np.uint64)
        pos, rounds = kary_search(lambda p: cells[p], 0, B, q, g)
        assert rounds <= {128: 1, 16: 2, 8: 3, 4: 4, 2: 5, 1: 8}[g]
        if g == B:
            assert pos == int((cells < q).sum())
        assert pos == int(np.searchsorted(cells, q, "left"))
        return base + pos

    i = 0
    for r in range(L - 1, -1, -1):
        base = min(max(i, 0), w // B - 1) * B
        i = node_pos(blk[r], w, base)
    tb = min(max(i, 0), n_pad // B - 1) * B
    i = min(max(node_pos(term_keys, cap, tb), 0), n_pad - 1)
    if i >= cap:
        return q == INF, i
    return bool(term_keys[i] == q and term_mark[i] == 0), i


@pytest.mark.parametrize("cap", [100, 1000, 4096, 40000])
def test_team_block_walk_mirror(cap):
    """The block walk's node step at every team width the kernels have
    (a warp's whole-node count, g = 128 cells a round; the narrower
    teams' searches, g = TEAM = 16 down to 1) gives the plain version's (found, idx) on a skiplist 3/4 full
    with a tenth tombstoned, ragged last nodes with KEY_INF padding (C =
    100, 1,000, 40,000), and every node's position equals np.searchsorted;
    queries: stored, tombstoned, 0, 2^64 - 2, KEY_INF, past the last key,
    fresh."""
    rng = np.random.default_rng(cap)
    keys = np.unique(rng.integers(1, 2**64 - 3, cap, dtype=np.uint64))
    keys = rng.permutation(keys)[: 3 * cap // 4]
    tk = from_u64(keys, "cpu")
    s = tdsl.skiplist_init(cap, device="cpu")
    s, _, _ = tdsl.insert_batch(s, tk, tk ^ 0x5A5A)
    s, _ = tdsl.delete_batch(s, tk[: len(keys) // 10])
    lay = bskiplist_layout(s)
    qs = np.concatenate([np.array([0, 2**64 - 2, 2**64 - 1,
                                   int(keys.max()) + 1], np.uint64),
                         rng.choice(keys, 24),
                         rng.integers(1, 2**64 - 2, 8, dtype=np.uint64)])
    found, idx = bskiplist_walk_ref(from_u64(qs, "cpu"), lay)
    blk = lay.blk.numpy().view(np.uint64)
    term = lay.term_keys.numpy().view(np.uint64)
    mark = lay.term_mark.numpy()
    for g in (128, 16, 8, 4, 2, 1):
        got = [team_block_walk_mirror(q, blk, term, mark, lay.n_pad, g)
               for q in qs]
        assert [int(f) for f, _ in got] == found.tolist(), g
        assert [i for _, i in got] == idx.tolist(), g
    assert bool(found.any()) and not bool(found.all())
