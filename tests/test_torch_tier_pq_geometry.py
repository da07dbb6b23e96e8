"""The host side of the redesigned tier_apply and pq_pop kernels, and plain
mirrors of their new formulations, on the CPU.

The kernels run only on the card (chip_smoke.py holds them bit for bit
against their plain versions there). Here: the wrappers' scratch and grid
helpers against the constants of the CUDA sources; a tile-by-tile mirror
of tier_apply's scan launch (counts within a key run and a slot run from
each tile's own prefix sums plus a carry looked back from the earlier
tiles, the need-evict count chained across tiles) held against
`tier_apply_planes_ref` and the reference's state-level `tier_apply_ref`;
and a mirror of pq_pop's early-stopping chunk scan and select held
against `pq_pop_ref` and the reference's `pq_pop_ref`, with the edge cases
of both at small sizes.
"""
import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro  # noqa: F401  (enables x64)
from repro.core import det_skiplist as jdsl
from repro.core import layout as jlay
from repro.kernels.pq_pop.ref import pq_pop_ref as j_pq_ref
from repro.kernels.tier_apply import ref as j_ta_ref
from repro.store import get_backend as j_backend
from repro_torch.convert import state_to_numpy, tree_leaves
from repro_torch.core import det_skiplist as tdsl
from repro_torch.core.bits import KEY_INF, from_u64
from repro_torch.core.layout import (first_true, hash_slot, skiplist_layout,
                                     spill_layout)
from repro_torch.kernels.hash_probe.ref import hash_probe_ref
from repro_torch.kernels.pq_pop import kernel as pq
from repro_torch.kernels.pq_pop.ref import pq_pop_ref
from repro_torch.kernels.skiplist_search.ref import skiplist_search_ref
from repro_torch.kernels.tier_apply import kernel as ta
from repro_torch.kernels.tier_apply import ops as ta_ops
from repro_torch.kernels.tier_apply.ref import (tier_apply_planes_ref,
                                                tier_apply_ref)
from repro_torch.kernels.tier_find.ref import (spill_run_probe_ref,
                                               warm_walk_ref)
from repro_torch.store import exec as t_exec
from repro_torch.store import get_backend as t_backend
from repro_torch.store import make_plan as t_plan

CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc")
H100_SMS = 132
LANES = (1, 4096, 65536)
RANK_SAT = 32       # tier_apply.cu: TA_RANK_SAT


def _define(name: str, file: str) -> int:
    m = re.search(rf"#define {name} \(?(\w+)", (CSRC / file).read_text())
    return int(m.group(1))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_same(ref_tree, port_tree, ctx=""):
    la = [np.asarray(x) for x in jax.tree.leaves(ref_tree)]
    lb = [_np(x) for x in tree_leaves(port_tree)]
    assert len(la) == len(lb), (ctx, len(la), len(lb))
    for i, (a, b) in enumerate(zip(la, lb)):
        if a.dtype == np.uint64 and b.dtype == np.int64:
            b = b.view(np.uint64)
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, i)
        assert np.array_equal(a, b), (ctx, i)


# ---------------------------------------------------------------------------
# host-side helpers against the CUDA sources
# ---------------------------------------------------------------------------

def test_constants_match_the_sources():
    assert ta.TILE == _define("TA_TILE", "tier_apply.cu")
    assert _define("MAX_BUCKET", "probe.cuh") == 16
    assert pq.PQ_CHUNK == _define("PQ_CHUNK", "pq_pop.cu")
    assert pq.PQ_TILE == _define("PQ_TILE", "pq_pop.cu")
    assert pq.PQ_ROUNDS * 32 == pq.PQ_CHUNK
    assert RANK_SAT == _define("TA_RANK_SAT", "tier_apply.cu")
    assert pq.STOP_WORD == _define("PQ_STOP", "pq_pop.cu")
    assert pq.WORDS_FIXED == _define("PQ_TILES", "pq_pop.cu")


def _member_instances():
    """The (team, blocked) instances of the membership kernel that the
    launcher dispatches to."""
    src = (CSRC / "tier_apply.cu").read_text()
    return {(int(t), b == "true") for t, b in re.findall(
        r"tier_apply_member_kernel<(\d+), (true|false)><<<", src)}


# resident membership threads an SM of each level instance on an H100, as
# the occupancy API gives them for the build's registers (32 at teams of
# 16 and 32, 48 at 2 to 8, 64 at 1)
H100_SLOTS = {16: 2048, 8: 1280, 4: 1280, 2: 1280, 1: 1024}


@pytest.mark.parametrize("k", LANES)
def test_tier_apply_scan_state_and_team(k):
    """One ticket word, then three words a tile; the membership launch's
    team width: a warp in the block layout; in the level layout the
    widest team whose k teams are all resident at once."""
    tiles = -(-k // ta.TILE)
    assert ta.scan_state_words(k) == 1 + 3 * tiles
    assert {1: 1, 4096: 16, 65536: 256}[k] == tiles
    level = ta.member_team(k, "level", H100_SMS, H100_SLOTS.get)
    assert ta.member_team(k, "block", H100_SMS, H100_SLOTS.get) == 32
    assert level == {1: 16, 4096: 16, 65536: 2}[k]
    assert k * level <= H100_SMS * H100_SLOTS[level]
    # one SM of 2,048 slots at every width: 1 lane takes a team of 16,
    # wider plans one thread a lane
    assert ta.member_team(k, "level", 1, lambda team: 2048) == \
        {1: 16, 4096: 1, 65536: 1}[k]


def test_member_team_widths_are_instantiated():
    """Every width `member_team` picks, at any plan width, has a kernel
    instance in its layout (and a case in `tier_apply_member_slots`), and the
    widths narrow as plans widen."""
    inst = _member_instances()
    assert inst == {(32, True), (16, False), (8, False), (4, False),
                    (2, False), (1, False)}
    src = (CSRC / "tier_apply.cu").read_text()
    assert {int(t) for t in re.findall(
        r"case (\d+): return ta_member_slots<\1>\(\);", src)} == \
        {t for t, blocked in inst if not blocked}
    widths = [ta.member_team(k, "level", H100_SMS, H100_SLOTS.get)
              for k in (1, 16896, 16897, 21120, 21121, 42240, 42241, 84480,
                        84481, 135168, 1 << 20)]
    assert widths == [16, 16, 8, 8, 4, 4, 2, 2, 1, 1, 1]
    assert all((w, False) in inst for w in widths)


@pytest.mark.parametrize("cap", [1, 4096, 65536, 1000, 1 << 24])
def test_pq_scan_geometry_and_scratch(cap):
    chunks, tiles, grid = pq.scan_geometry(cap, H100_SMS)
    assert chunks * pq.PQ_CHUNK >= cap > (chunks - 1) * pq.PQ_CHUNK
    assert tiles * pq.PQ_TILE >= chunks > (tiles - 1) * pq.PQ_TILE
    assert 1 <= grid <= min(tiles, pq.SCAN_BLOCKS_PER_SM * H100_SMS)
    at_prefix, at_rounds, total = pq.scratch_layout(cap)
    # words: 4 fixed + one a tile; prefix: an int32 a chunk; rounds: 16
    # bytes a chunk; every part on a 16-byte boundary
    assert at_prefix >= pq.WORDS_FIXED + tiles and at_prefix % 2 == 0
    assert (at_rounds - at_prefix) * 8 >= 4 * chunks and at_rounds % 2 == 0
    assert (total - at_rounds) * 8 == pq.PQ_ROUNDS * chunks


# ---------------------------------------------------------------------------
# tier_apply: the tiled scan mirror
# ---------------------------------------------------------------------------

def _lookback(words, tile, sat):
    """The kernel's `ta_lookback`: the values of tiles tile - 1, ... back to
    and including the first flagged one, summed and saturated."""
    total = 0
    for p in range(tile - 1, -1, -1):
        flag, value = words[p]
        total = min(total + value, sat)
        if flag or total >= sat:
            break
    return total


def member_mirror(sk, ss, sm, hot_keys, meta, warm, spill, policy):
    """The membership launch on the planes: (in_warm, in_spill, flags,
    emask, vorder, ecol), flags = inserting | existing-column << 1."""
    m, b = hot_keys.shape
    smb = sm != 0
    hit = hash_probe_ref(sk, ss, hot_keys)[0].bool()
    probe = smb & ~hit
    f_warm = warm_walk_ref(sk, warm)[0].bool() & probe
    f_sp = torch.zeros_like(probe)
    if spill is not None:
        f_sp = spill_run_probe_ref(sk, spill.keys, spill.dead,
                                   spill.run_off)[0] & probe & ~f_warm
    rows = hot_keys[ss.clamp(0, m - 1).long()]
    empty = rows == KEY_INF
    cols = torch.arange(b)
    emask = (empty.long() << cols).sum(1)
    ecol = first_true(rows == sk[:, None])
    flags = ((smb & ~f_warm & ~f_sp).long()
             | ((rows == sk[:, None]).any(1).long() << 1))
    vorder = torch.zeros_like(sk)
    if policy != "none":
        mrow = meta[ss.clamp(0, m - 1).long()].long()
        score = torch.where(empty, 2**31 - 1,
                            mrow if policy == "lru" else -mrow)
        less = ((score[:, None, :] < score[:, :, None])
                | ((score[:, None, :] == score[:, :, None])
                   & (cols[None, None, :] < cols[None, :, None])))
        pos = less.sum(2)
        vorder = (cols[None, :] << (4 * pos)).sum(1)
    return f_warm, f_sp, flags, emask, vorder, ecol


def place(rank, em, vorder, c, b, policy):
    """A lane's placement from its slot-run rank: (fit, col, vcol, needs an
    eviction), as the scan launch computes it."""
    bits = (em[:, None] >> torch.arange(b)) & 1
    nth = bits.bool() & (torch.cumsum(bits, 1) == rank[:, None] + 1)
    fit = nth.any(1)
    col_e = torch.where(fit, first_true(nth).long(), b)
    n_empty = bits.sum(1)
    vc = torch.zeros_like(rank)
    ne = torch.zeros_like(fit)
    if policy != "none":
        ev = rank - n_empty
        vc = (vorder >> (4 * ev.clamp(0, b - 1))) & 0xF
        ne = c & ~fit & (ev < b - n_empty)
    return fit, torch.where(fit, col_e, vc), vc, ne


def scan_mirror(flags, emask, vorder, krs, srs, max_evict, b, policy, tile):
    """The scan launch tile by tile: each tile's prefix sums from its run
    starts, the carries of the runs open at its start from the earlier
    tiles' words (key runs: an inserting lane; slot runs: the candidates,
    saturated at RANK_SAT), the need-evict count chained over the tiles.
    Returns (placed, exists, dup, need_ev, col, vcol)."""
    k = flags.shape[0]
    kw, sw, ew = [], [], []
    out = [torch.zeros(k, dtype=torch.int64) for _ in range(6)]
    for t in range(-(-k // tile)):
        t0, t1 = t * tile, min((t + 1) * tile, k)
        lane = torch.arange(t0, t1)
        smi = (flags[t0:t1] & 1).long()
        kr, s0 = krs[t0:t1].long(), srs[t0:t1].long()

        def excl(v):
            return torch.cat([torch.zeros(1, dtype=torch.long),
                              torch.cumsum(v, 0)])

        ex = excl(smi)
        last = int(krs[t1 - 1])
        kw.append((last >= t0, int(ex[-1] - ex[max(last - t0, 0)] > 0)))
        carry = _lookback(kw, t, 1) if int(krs[t0]) < t0 else 0
        within = ex[lane - t0] - ex[torch.clamp(kr - t0, min=0)]
        d = (smi > 0) & ((within > 0) | ((kr < t0) & (carry > 0)))
        e = (smi > 0) & ((flags[t0:t1] & 2) > 0) & ~d
        c = (smi > 0) & ~d & ~e

        ex = excl(c.long())
        last = int(srs[t1 - 1])
        sw.append((last >= t0,
                   min(int(ex[-1] - ex[max(last - t0, 0)]), RANK_SAT)))
        carry = _lookback(sw, t, RANK_SAT) if int(srs[t0]) < t0 else 0
        rank = (ex[lane - t0] - ex[torch.clamp(s0 - t0, min=0)]
                + torch.where(s0 < t0, carry, 0))

        fit, col, vc, ne = place(rank, emask[t0:t1].long(), vorder[t0:t1],
                                 c, b, policy)
        ex = excl(ne.long())
        before = 0
        for p in range(t - 1, -1, -1):      # back to an inclusive word
            inc, value = ew[p]
            before += value
            if inc:
                break
        ew.append((True, before + int(ex[-1])))
        fin = ne & (before + ex[lane - t0] < max_evict)
        for o, v in zip(out, ((c & fit) | fin, e, d, fin,
                              col, vc)):
            o[t0:t1] = v.long()
    return out


def tier_apply_mirror(sk, ss, sm, krs, srs, hot_keys, meta, warm, max_evict,
                      spill, policy, tile=ta.TILE):
    """Both launches' formulation: the nine planes of
    `tier_apply_planes_ref`, in its order and dtypes."""
    m, b = hot_keys.shape
    f_warm, f_sp, flags, emask, vorder, ecol = member_mirror(
        sk, ss, sm, hot_keys, meta, warm, spill, policy)
    placed, exists, dup, need_ev, col, vcol = scan_mirror(
        flags, emask, vorder, krs, srs, int(max_evict.reshape(-1)[0]), b,
        policy, tile)
    i8, i32 = torch.int8, torch.int32
    return (f_warm.to(i8), f_sp.to(i8), placed.to(i8), exists.to(i8),
            dup.to(i8), need_ev.to(i8), col.to(i32), vcol.to(i32),
            ecol.to(i32))


_STATE = {}


def _stack():
    """A tiered3/lru stack with all three tiers populated, built by the
    port's backend, and the reference's state with the same leaves."""
    if not _STATE:
        be = t_backend("tiered3/lru")
        ts = be.init(32, hot_bucket=4, device="cpu")
        rng = np.random.default_rng(7)
        ks = np.unique(rng.integers(1, 2**64 - 2, 120, dtype=np.uint64))[:100]
        with t_exec.exec_mode("torch"):
            for chunk in np.array_split(ks, 3):
                ts, _ = be.apply(ts, t_plan(np.full(len(chunk), 1, np.int32),
                                            chunk, chunk + 1, device="cpu"))
        tmpl = j_backend("tiered3/lru").init(32, hot_bucket=4)
        leaves = [jnp.asarray(x) for x in jax.tree.leaves(state_to_numpy(ts))]
        assert [x.dtype for x in leaves] == [x.dtype for x in
                                             jax.tree.leaves(tmpl)]
        js = jax.tree.unflatten(jax.tree.structure(tmpl), leaves)
        _STATE["s"] = (js, ts, ks)
    return _STATE["s"]


WIDTH = 48


def _batch(case, ks, m, rng):
    """WIDTH lanes: `mixed` (stored and fresh keys, in-batch duplicates),
    `one slot` (every lane in one slot: one slot run over every tile,
    key runs of several lanes), `long run` (one key repeated over 20
    lanes, so a key run spans tiles)."""
    fresh = rng.integers(2**62, 2**64 - 2, 4096, dtype=np.uint64)
    if case == "mixed":
        keys = np.where(rng.random(WIDTH) < 0.5, rng.choice(ks, WIDTH),
                        fresh[:WIDTH])
        keys[WIDTH - 3:] = keys[:3]
    else:
        pool = np.concatenate([ks, fresh])
        slot = hash_slot(from_u64(pool, "cpu"), m).numpy()
        same = pool[slot == np.bincount(slot).argmax()]
        if case == "one slot":
            keys = rng.choice(same[:12], WIDTH)
        else:
            keys = rng.choice(pool, WIDTH)
            keys[10:30] = same[0]
    mask = rng.random(WIDTH) > 0.15
    return (keys, rng.integers(1, 2**64 - 1, WIDTH, dtype=np.uint64), mask)


@pytest.mark.parametrize("policy,max_evict", [("none", 8), ("lru", 1),
                                              ("size", WIDTH), ("lru", 0)])
@pytest.mark.parametrize("case", ["mixed", "one slot", "long run"])
def test_tier_apply_scan_mirror(case, policy, max_evict):
    """The mirror at tiles of 4 and 7 lanes (and the kernel's) against the
    plane-level plain version; then, as the fused glue's kernel, against
    the reference's state-level `tier_apply_ref`."""
    js, ts, ks = _stack()
    rng = np.random.default_rng(len(case) * 31 + max_evict)
    keys, vals, mask = _batch(case, ks, ts.hot.num_slots, rng)
    tk, tv = from_u64(keys, "cpu"), from_u64(vals, "cpu")
    tm = torch.from_numpy(mask)
    _, ss, sk, _, sm, krs, srs = ta_ops.sorted_lanes(ts.hot.num_slots, tk,
                                                     tv, tm)
    if case != "mixed":                 # the case is what it says
        assert (krs != torch.arange(WIDTH)).sum() >= 8
    if case == "one slot":
        assert bool((srs == 0).all())
    sp = spill_layout(ts.spill.keys, ts.spill.dead, ts.spill.run_start,
                      ts.spill.n)
    me = torch.tensor([max_evict], dtype=torch.int32)
    args = (sk, ss, sm, krs, srs, ts.hot.keys, ts.hot_meta,
            skiplist_layout(ts.cold), me, sp, policy)
    want = tier_apply_planes_ref(*args)
    for tile in (4, 7, ta.TILE):
        got = tier_apply_mirror(*args, tile=tile)
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.dtype == b.dtype and torch.equal(a, b), (tile, i)
    if case == "mixed" and policy != "none" and max_evict > 0:
        assert bool(want[5].any())       # some lane evicts
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ta_ops, "tier_apply_tiles",
                   lambda *a: tier_apply_mirror(*a, tile=4))
        got = ta_ops.tier_apply_fused(ts.hot, ts.hot_meta, ts.clock, ts.cold,
                                      ts.spill, tk, tv, tm, policy, max_evict,
                                      skiplist_layout(ts.cold))
    assert_same(J_TA_REF(js.hot, js.hot_meta, js.clock, js.cold, js.spill,
                         jnp.asarray(keys), jnp.asarray(vals),
                         jnp.asarray(mask), policy=policy,
                         max_evict=max_evict), got, (case, policy))
    assert_same(J_TA_REF(js.hot, js.hot_meta, js.clock, js.cold, js.spill,
                         jnp.asarray(keys), jnp.asarray(vals),
                         jnp.asarray(mask), policy=policy,
                         max_evict=max_evict),
                tier_apply_ref(ts.hot, ts.hot_meta, ts.clock, ts.cold,
                               ts.spill, tk, tv, tm, policy, max_evict),
                "ref")


J_TA_REF = jax.jit(j_ta_ref.tier_apply_ref, static_argnames=("policy",))


def test_rank_saturation_is_exact():
    """The slot-run carry saturates at RANK_SAT: a lane's placement is the
    same for every rank >= RANK_SAT, at every bucket width up to 16, every
    count of empty cells and either policy."""
    ranks = torch.tensor([RANK_SAT, RANK_SAT + 1, 2 * RANK_SAT, 10**6])
    for b in (1, 4, 16):
        for n_empty in range(b + 1):
            em = torch.full((4,), ((1 << b) - 1) ^ ((1 << (b - n_empty)) - 1))
            vorder = torch.full((4,), sum(j << (4 * (b - 1 - j))
                                          for j in range(b)))
            c = torch.ones(4, dtype=torch.bool)
            for policy in ("lru", "none"):
                out = place(ranks, em, vorder, c, b, policy)
                assert all(bool((o == o[0]).all()) for o in out), (b, n_empty)


# ---------------------------------------------------------------------------
# pq_pop: the early-stopping chunk scan and select
# ---------------------------------------------------------------------------

def select_mirror(ranks, mask, lay, chunk=8, rounds=4, tile=3):
    """pq_pop's two launches with `chunk`-cell chunks of `rounds` rounds and
    tiles of `tile` chunks: want_max, the tiles' counts and inclusive
    prefixes in ticket order up to the stop chunk, then each lane's binary
    search of prefix[0 .. stop], its round and its cell, and the walk.
    Returns ((found int8, idx int32), chunks read)."""
    tk, tm = lay.term_keys, lay.term_mark
    cap = tk.shape[0]
    width = chunk // rounds
    want = ranks.long() + 1
    want = torch.where((mask != 0) & (want >= 1), want, 0)
    wm = int(want.max()) if want.numel() else 0
    live = (tm == 0) & (tk != KEY_INF)
    nchunks = -(-cap // chunk)
    padded = torch.zeros(nchunks * chunk, dtype=torch.long)
    padded[:cap] = live.long()
    stop = nchunks - 1 if wm > 0 else -1
    prefix, round_n, read, before = [], [], 0, 0
    for t in range(-(-nchunks // tile)):
        if t * tile > stop:
            break
        cells = padded[t * tile * chunk:(t + 1) * tile * chunk]
        read += cells.numel() // chunk
        n = cells.reshape(-1, rounds, width).sum(2)
        round_n.extend(n.tolist())
        incl = before + torch.cumsum(n.sum(1), 0)
        prefix.extend(incl.tolist())
        before = int(incl[-1])
        reach = (incl >= wm).nonzero()
        if reach.numel():
            stop = t * tile + int(reach[0])
            break
    top = prefix[stop] if stop >= 0 else 0
    sel = (want >= 1) & (want <= top)
    key = torch.full_like(tk[:1].expand(ranks.shape[0]), KEY_INF).clone()
    for i in sel.nonzero()[:, 0].tolist():
        w = int(want[i])
        c = int(np.searchsorted(np.asarray(prefix[:stop + 1]), w))
        need = w - (prefix[c - 1] if c > 0 else 0)
        r = 0
        while r < rounds - 1 and need > round_n[c][r]:
            need -= round_n[c][r]
            r += 1
        base = c * chunk + r * width
        cell = base + int(((torch.cumsum(padded[base:base + width], 0)
                            == need) & (padded[base:base + width] > 0))
                          .long().argmax())
        key[i] = tk[cell]
    walked, idx = skiplist_search_ref(key, lay)
    found = sel & (walked != 0)
    return (found.to(torch.int8), torch.where(found, idx, 0)), read


def to_jax_skiplist(ts):
    return jdsl.DetSkiplist(*[
        tuple(map(jnp.asarray, v)) if isinstance(v, tuple) else jnp.asarray(v)
        for v in state_to_numpy(ts)])


def _pq_heap(cap, n, dead, rng):
    """A skiplist of `cap` cells holding `n` priority keys, `dead` of them
    (the smallest, or every one when dead >= n) popped."""
    prio = rng.integers(0, 3, n).astype(np.uint64)
    keys = (prio << np.uint64(32)) | rng.permutation(n).astype(np.uint64)
    tk = from_u64(keys, "cpu")
    s = tdsl.skiplist_init(cap, device="cpu")
    s, _, _ = tdsl.insert_batch(s, tk, tk + 3)
    live = ~s.term_mark & (torch.arange(cap) < s.n_term)
    mark = live & (torch.cumsum(live.long(), 0) <= dead)
    return s._replace(term_mark=s.term_mark | mark,
                      n_marked=s.n_marked + mark.sum())


J_PQ_REF = jax.jit(j_pq_ref)

# (case, capacity, keys, popped, how the ranks are drawn)
PQ_CASES = [
    ("no lane", 100, 60, 10, "none"),
    ("all -1", 100, 60, 10, "minus one"),
    ("first chunk", 100, 60, 0, "first"),
    ("last chunk", 100, 97, 0, "last"),
    ("chunk boundary", 100, 90, 2, "boundary"),
    ("past the total", 100, 60, 10, "past"),
    ("all tombstoned", 100, 60, 60, "past"),
    ("long tombstone run", 100, 95, 70, "first"),
]


@pytest.mark.parametrize("case,cap,n,dead,how",
                         PQ_CASES, ids=[c[0] for c in PQ_CASES])
def test_pq_select_mirror(case, cap, n, dead, how):
    rng = np.random.default_rng(len(case))
    ts = _pq_heap(cap, n, dead, rng)
    lay = skiplist_layout(ts)
    total = int(ts.n_term - ts.n_marked)
    t = 24
    ranks = rng.integers(0, max(total, 1), t).astype(np.int32)
    mask = rng.random(t) > 0.2
    if how == "none":
        mask[:] = False
    elif how == "minus one":
        ranks[:] = -1
    elif how == "first":
        ranks = np.minimum(ranks, 3)
    elif how == "last":
        ranks[0] = total - 1
        mask[0] = True
    elif how == "boundary":                  # want_max = a chunk's prefix
        live = ((ts.term_mark == 0) & (ts.term_keys != KEY_INF)).long()
        ranks[0] = int(live[:5 * 8].sum()) - 1
        ranks = np.minimum(ranks, ranks[0])
        mask[0] = True
    else:                                    # ranks at and past the total
        ranks[:4] = [total - 1, total, total + 1, 2**31 - 1]
        mask[:4] = True
    ranks[-1] = -1
    tr = torch.from_numpy(ranks)
    tm = torch.from_numpy(mask.astype(np.int8))
    want = pq_pop_ref(tr, tm, lay)
    for chunk, rounds, tile in ((8, 4, 3), (8, 2, 1), (16, 4, 2)):
        got, read = select_mirror(tr, tm, lay, chunk, rounds, tile)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (chunk,)
        nchunks = -(-cap // chunk)
        if how in ("none", "minus one"):
            assert read == 0                 # nothing is read
        elif how == "first" and total > 4:
            assert read <= -(-(dead + 4) // (chunk * tile)) * tile + tile
        elif how == "past":
            assert read == nchunks           # the whole plane
    js = to_jax_skiplist(ts)
    jl = jlay.skiplist_layout(js)
    th, tl = jlay.split_u64(js.term_keys)
    jf, ji = J_PQ_REF(jnp.asarray(ranks), jnp.asarray(mask), jl.lvl_hi,
                      jl.lvl_lo, jl.lvl_child, js.level_count, th, tl,
                      jl.term_mark)
    assert_same((jf.astype(jnp.int8), ji), want, case)
    if how in ("first", "last", "boundary"):
        assert bool(want[0].any())           # some lane pops
