"""The port's priority queue against the JAX reference, bit for bit
(tolerance 0): `make_priority_key`, `pop_rank_select` and `pop_mark`, the
pq_pop kernel's plain version (against the Pallas kernel in interpret mode
at one size) and its glue, and the `pq` backend's `apply` against the
reference backend's direct `apply` on results and every state leaf: the
POPMIN and POPK result forms, the rank pool in lane order, pops on an
empty queue, insert-then-pop in one plan, pops past tombstones, a plan
with all five kinds of lane, a range delete that compacts, `scan` and
`stats` after pops, `convert` of a reference state, and a seeded stream.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro  # noqa: F401  (enables x64)
from repro.core import bits as jbits
from repro.core import det_skiplist as jdsl
from repro.core import layout as jlay
from repro.kernels.pq_pop.kernel import pq_pop_tiles as j_pq_tiles
from repro.kernels.pq_pop.ops import pq_pop_ranks as j_pq_ranks
from repro.kernels.pq_pop.ref import pq_pop_ref as j_pq_ref
from repro.store import exec as j_exec
from repro.store import get_backend as j_backend
from repro.store import make_plan as j_plan
from repro_torch.convert import state_from_numpy, state_to_numpy, tree_leaves
from repro_torch.core import det_skiplist as tdsl
from repro_torch.core.bits import KEY_INF, from_u64, make_priority_key
from repro_torch.core.layout import skiplist_layout
from repro_torch.kernels.pq_pop.ops import pq_pop_ranks
from repro_torch.kernels.pq_pop.ref import pq_pop_ref
from repro_torch.store import exec as t_exec
from repro_torch.store import get_backend as t_backend
from repro_torch.store import make_plan as t_plan

DEV = "cpu"
CAP = 256
WIDTH = 64
RANKS = 96
OP_NONE, OP_FIND, OP_INSERT, OP_DELETE = -1, 0, 1, 2
OP_POPMIN, OP_POPK, OP_RANGE_DELETE = 4, 5, 6

# the reference runs jitted (one compile per shape)
J_SELECT = jax.jit(jdsl.pop_rank_select)
J_MARK = jax.jit(jdsl.pop_mark)
J_PQ_TILES = jax.jit(j_pq_tiles, static_argnames=("tile", "interpret"))
J_PQ_RANKS = jax.jit(j_pq_ranks, static_argnames=("tile", "interpret"))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_same(ref_tree, port_tree, ctx=""):
    la = [np.asarray(x) for x in jax.tree.leaves(ref_tree)]
    lb = [_np(x) for x in tree_leaves(port_tree)]
    assert len(la) == len(lb), (ctx, len(la), len(lb))
    for i, (a, b) in enumerate(zip(la, lb)):
        if a.dtype == np.uint64 and b.dtype == np.int64:
            b = b.view(np.uint64)
        assert a.dtype == b.dtype, (ctx, i, a.dtype, b.dtype)
        assert a.shape == b.shape, (ctx, i, a.shape, b.shape)
        assert np.array_equal(a, b), (ctx, i)


def to_jax_skiplist(ts):
    """A port skiplist as the reference's `DetSkiplist` (the port's batch
    functions match the reference's leaf for leaf: tests/test_torch_core.py)."""
    return jdsl.DetSkiplist(*[
        tuple(map(jnp.asarray, v)) if isinstance(v, tuple) else jnp.asarray(v)
        for v in state_to_numpy(ts)])


def pkey(prio, ticket):
    """The scheduler's key on the host: priority high, ticket low."""
    return np.uint64((int(prio) << 32) | (int(ticket) & 0xFFFFFFFF))


# ---------------------------------------------------------------------------
# keys, rank select, pop mark, the kernel's plain version
# ---------------------------------------------------------------------------

def test_make_priority_key_matches():
    rng = np.random.default_rng(0)
    prio = np.concatenate([[0, 1, 2, 2**32 - 1],
                           rng.integers(0, 2**32, 60)]).astype(np.uint32)
    ticket = np.concatenate([[0, 2**32 - 1, 2**32, 2**40 + 5],
                             rng.integers(0, 2**62, 60)]).astype(np.uint64)
    ref = jbits.make_priority_key(jnp.asarray(prio), jnp.asarray(ticket))
    got = make_priority_key(torch.from_numpy(prio.astype(np.int64)),
                            from_u64(ticket, DEV))
    assert_same(ref, got)
    assert [int(x) for x in np.asarray(ref)[:4]] == [
        int(pkey(p, t)) for p, t in zip(prio[:4], ticket[:4])]


@functools.lru_cache(maxsize=None)
def _heap(kind: str):
    """A port skiplist of priority keys after deletes, range deletes or a
    compaction, with its reference copy."""
    rng = np.random.default_rng(len(kind))
    prio = rng.integers(0, 3, 200)
    keys = np.array([pkey(p, t) for t, p in enumerate(prio)], np.uint64)
    tk = from_u64(keys, DEV)
    s = tdsl.skiplist_init(CAP, device=DEV)
    s, _, _ = tdsl.insert_batch(s, tk, tk + 11)
    if kind == "deletes":
        s, _ = tdsl.delete_batch(s, tk[rng.permutation(200)[:40]])
    elif kind == "range_deletes":
        lo = from_u64(np.array([pkey(1, 0), pkey(0, 50)], np.uint64), DEV)
        hi = from_u64(np.array([pkey(1, 120), pkey(0, 90)], np.uint64), DEV)
        s, _ = tdsl.range_delete_batch(s, lo, hi)
    else:                                          # compacted
        s, _ = tdsl.delete_batch(s, tk[:60])
        assert int(s.n_marked) == 0 and int(s.n_term) == 140
    return s, to_jax_skiplist(s)


def _ranks(total, rng):
    """Ranks 0.., a masked-off lane, -1, ranks at and past the total."""
    ranks = np.arange(RANKS, dtype=np.int32)
    ranks[RANKS - 8:] = [-1, total - 1, total, total + 1, 2**31 - 1, 0, 3,
                         total - 2]
    mask = rng.random(RANKS) > 0.1
    mask[RANKS - 8:RANKS - 3] = True
    return ranks, mask


@pytest.mark.parametrize("kind", ["deletes", "range_deletes", "compacted"])
def test_pop_rank_select_matches(kind):
    ts, js = _heap(kind)
    total = int(ts.n_term - ts.n_marked)
    ranks, mask = _ranks(total, np.random.default_rng(7))
    tr, tm = torch.from_numpy(ranks), torch.from_numpy(mask)
    got = tdsl.pop_rank_select(ts, tr, tm)
    assert_same(J_SELECT(js, jnp.asarray(ranks), jnp.asarray(mask)), got,
                kind)
    # the kernel's glue (live total from the prefix) gives the same lanes
    for other in (pq_pop_ranks(ts, tr, tm),
                  t_exec.pq_pop(ts, tr, tm, mode="torch")):
        for a, b in zip(got, other):
            assert torch.equal(a, b), kind
    found, keys, idx = got
    miss = ~found
    assert miss[RANKS - 6:RANKS - 3].all()         # total, total + 1, max
    assert (keys[miss] == KEY_INF).all() and (idx[miss] == 0).all()
    live = ts.term_keys[~ts.term_mark & (ts.term_keys != KEY_INF)]
    assert torch.equal(keys[:10][found[:10]],
                       live[:10][found[:10]])      # ascending ranks


def test_pq_pop_ref_matches_pallas():
    ts, js = _heap("deletes")
    total = int(ts.n_term - ts.n_marked)
    ranks, mask = _ranks(total, np.random.default_rng(9))
    lay = jlay.skiplist_layout(js)
    th, tl = jlay.split_u64(js.term_keys)
    planes = (lay.lvl_hi, lay.lvl_lo, lay.lvl_child, th, tl, lay.term_mark)
    got = pq_pop_ref(torch.from_numpy(ranks),
                     torch.from_numpy(mask.astype(np.int8)),
                     skiplist_layout(ts))
    assert_same(J_PQ_TILES(jnp.asarray(ranks), jnp.asarray(mask, jnp.int8),
                           *planes, tile=RANKS, interpret=True), got, "tiles")
    jf, ji = j_pq_ref(jnp.asarray(ranks), jnp.asarray(mask), lay.lvl_hi,
                      lay.lvl_lo, lay.lvl_child, js.level_count, th, tl,
                      lay.term_mark)
    assert_same((jf.astype(jnp.int8), ji), got, "ref")
    assert_same(J_PQ_RANKS(js, jnp.asarray(ranks), jnp.asarray(mask),
                           tile=RANKS, interpret=True),
                pq_pop_ranks(ts, torch.from_numpy(ranks),
                             torch.from_numpy(mask)), "ops")


@pytest.mark.parametrize("n_pop", [5, 80])
def test_pop_mark_matches(n_pop):
    """Tombstones below the threshold, then a batch that compacts."""
    ts, js = _heap("deletes")
    ranks = np.arange(RANKS, dtype=np.int32)
    mask = np.arange(RANKS) < n_pop
    found, _, idx = tdsl.pop_rank_select(ts, torch.from_numpy(ranks),
                                         torch.from_numpy(mask))
    got = tdsl.pop_mark(ts, idx, found)
    jf, _, ji = J_SELECT(js, jnp.asarray(ranks), jnp.asarray(mask))
    assert_same(J_MARK(js, ji, jf), got)
    assert (int(got.n_marked) == 0) == (n_pop == 80)


# ---------------------------------------------------------------------------
# the pq backend against the reference's direct apply
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _j_apply():
    return jax.jit(j_backend("pq").apply)


def _lanes(*lanes):
    """(op, key, val) lanes -> a WIDTH-lane plan, padded with idle lanes."""
    ops = np.full(WIDTH, OP_NONE, np.int32)
    keys = np.zeros(WIDTH, np.uint64)
    vals = np.zeros(WIDTH, np.uint64)
    for i, (op, k, v) in enumerate(lanes):
        ops[i], keys[i], vals[i] = op, k, v
    return ops, keys, vals, np.ones(WIDTH, bool)


def _inserts(tickets, prio=1):
    return [(OP_INSERT, pkey(prio, t), 1000 + t) for t in tickets]


def _run(plans, js=None, ts=None):
    """Each plan through both backends; results and every state leaf
    equal. Returns the port's results per plan and both final states."""
    jb, tb = j_backend("pq"), t_backend("pq")
    js = jb.init(CAP) if js is None else js
    ts = tb.init(CAP, device=DEV) if ts is None else ts
    out = []
    with t_exec.exec_mode("torch"):
        for i, plan in enumerate(plans):
            js, jr = _j_apply()(js, j_plan(*plan))
            ts, tr = tb.apply(ts, t_plan(*plan, device=DEV))
            assert_same(jr, tr, (i, "results"))
            assert_same(js, state_to_numpy(ts), (i, "state"))
            out.append((_np(tr.ok), _np(tr.vals).view(np.uint64)))
    return out, js, ts


def test_popmin_and_popk_result_forms():
    out, _, _ = _run([_lanes(*_inserts(range(10))),
                      _lanes((OP_POPMIN, 0, 0), (OP_POPK, 0, 0))])
    ok, vals = out[1]
    assert ok[:2].all() and not ok[2:].any()
    assert vals[0] == 1000 and vals[1] == pkey(1, 1)   # value, then key


def test_rank_pool_in_lane_order():
    pops = [(OP_POPK if i % 3 else OP_POPMIN, 0, 0) for i in range(12)]
    lanes = []
    for i, p in enumerate(pops):
        lanes += [p, (OP_FIND, pkey(2, i), 0), (OP_NONE, 0, 0)]
    out, _, ts = _run([_lanes(*_inserts(range(20), 2)), _lanes(*lanes)])
    ok, vals = out[1]
    at = np.arange(0, 36, 3)
    assert ok[at].all()
    want = [1000 + i if i % 3 == 0 else pkey(2, i) for i in range(12)]
    assert [int(v) for v in vals[at]] == [int(w) for w in want]
    assert not ok[at + 1].any()                    # the popped keys are gone
    assert int(t_backend("pq").stats(ts)["pops"]) == 12


def test_pop_empty_is_a_clean_miss():
    out, _, ts = _run([_lanes(*[(OP_POPMIN, 0, 0)] * 3),
                       _lanes(*_inserts(range(2)), *[(OP_POPK, 0, 0)] * 4)])
    assert not out[0][0].any() and not out[0][1].any()
    ok, vals = out[1]
    assert ok[2:4].all() and not ok[4:6].any() and not vals[4:6].any()
    st = t_backend("pq").stats(ts)
    assert (int(st["pops"]), int(st["pop_empty"]), int(st["size"])) == \
        (2, 5, 0)


def test_insert_then_pop_in_one_plan():
    out, _, _ = _run([_lanes(*_inserts(range(5, 9))),
                      _lanes((OP_POPK, 0, 0), *_inserts([1], prio=0),
                             (OP_POPK, 0, 0))])
    ok, vals = out[1]
    assert ok[[0, 1, 2]].all()
    assert vals[0] == pkey(0, 1) and vals[2] == pkey(1, 5)


def test_pops_skip_tombstones():
    out, _, ts = _run([_lanes(*_inserts(range(40))),
                       _lanes(*[(OP_DELETE, pkey(1, t), 0) for t in (0, 1, 3)]),
                       _lanes(*[(OP_POPK, 0, 0)] * 3)])
    assert [int(v) for v in out[2][1][:3]] == [int(pkey(1, t))
                                               for t in (2, 4, 5)]
    assert int(ts.heap.n_marked) == 6              # below the compaction


def test_five_lane_kinds_linearize():
    """INSERTS -> DELETES -> RANGE_DELETES -> POPS -> FINDS in one plan."""
    base = _inserts(range(20))
    plan = _lanes((OP_FIND, pkey(1, 2), 0),        # range-deleted: miss
                  (OP_POPK, 0, 0),                 # sees the insert
                  (OP_RANGE_DELETE, pkey(1, 0), pkey(1, 6)),
                  (OP_FIND, pkey(0, 7), 0),        # inserted then popped
                  (OP_DELETE, pkey(1, 6), 0),
                  (OP_POPMIN, 0, 0),               # skips 0..6
                  (OP_INSERT, pkey(0, 7), 77),
                  (OP_FIND, pkey(1, 9), 0))        # pending: hit
    out, _, _ = _run([_lanes(*base), plan])
    ok, vals = out[1]
    assert list(ok[:8]) == [False, True, True, False, True, True, True, True]
    assert vals[1] == pkey(0, 7) and vals[2] == 6 and vals[5] == 1007
    assert vals[7] == 1009


def test_range_delete_triggers_compaction():
    plans = [_lanes(*_inserts(range(30)), *_inserts(range(30, 50), 2)),
             _lanes((OP_RANGE_DELETE, pkey(2, 0), pkey(3, 0)),
                    (OP_POPK, 0, 0))]
    out, js, ts = _run(plans)
    assert out[1][0][0] and out[1][1][0] == 20
    # the cancel compacts (20 of 50 marked); the pop then marks one
    assert int(ts.heap.n_marked) == 1 and int(ts.heap.n_term) == 30


def test_scan_and_stats_after_pops():
    plans = [_lanes(*_inserts(range(25)), *_inserts(range(25, 30), 0)),
             _lanes(*[(OP_POPMIN, 0, 0)] * 7)]
    _, js, ts = _run(plans)
    jb, tb = j_backend("pq"), t_backend("pq")
    lo = np.array([0, pkey(1, 0), pkey(1, 10)], np.uint64)
    hi = np.array([2**64 - 1, pkey(1, 8), pkey(2, 0)], np.uint64)
    t_lo, t_hi = t_plan([0] * 3, lo, hi, device=DEV)[1:3]
    for as_of in (None, 0):
        ref = jax.jit(jb.scan, static_argnames=("max_out", "as_of_batch"))(
            js, jnp.asarray(lo), jnp.asarray(hi), max_out=32,
            as_of_batch=as_of)
        got = tb.scan(ts, t_lo, t_hi, 32, as_of_batch=as_of)
        assert_same(ref, got, as_of)
    assert int(got[0][0]) == 23                    # 30 inserted, 7 popped
    jst, tst = jb.stats(js), tb.stats(ts)
    assert list(jst) == list(tst)
    assert_same([jst[k] for k in jst], [tst[k] for k in tst], "stats")
    assert int(tb.stats(ts)["tombstones"]) == 7


def test_convert_round_trip_of_a_reference_state():
    plans = [_lanes(*_inserts(range(20))), _lanes(*[(OP_POPK, 0, 0)] * 4)]
    jb = j_backend("pq")
    js = jb.init(CAP)
    for plan in plans:
        js, _ = _j_apply()(js, j_plan(*plan))
    tree = jax.tree.map(np.asarray, js)
    ts = state_from_numpy("pq", tree, DEV)
    assert type(ts).__name__ == "PQState"
    assert_same(js, state_to_numpy(ts), "round trip")
    _run([_lanes(*[(OP_POPMIN, 0, 0)] * 3, *_inserts([99], 0))], js, ts)


def _stream(seed, n_plans=8):
    """Seeded scheduler-like plans: priority-key inserts with a monotone
    ticket, pops, finds on pending and popped keys, a band cancel."""
    rng = np.random.default_rng(seed)
    ticket, keys = 0, []
    plans = []
    for p in range(n_plans):
        lanes = []
        for _ in range(20):
            prio = 0 if ticket % 6 == 0 else int(rng.integers(1, 3))
            keys.append(pkey(prio, ticket))
            lanes.append((OP_INSERT, keys[-1], 5000 + ticket))
            ticket += 1
        lanes += [(OP_POPMIN, 0, 0)] * 8 + [(OP_POPK, 0, 0)] * 8
        lanes += [(OP_FIND, keys[int(i)], 0)
                  for i in rng.integers(0, len(keys), 8)]
        if p == 5:
            lanes.append((OP_RANGE_DELETE, pkey(2, 0), pkey(3, 0)))
        order = rng.permutation(len(lanes))
        plans.append(_lanes(*[lanes[i] for i in order]))
    return plans


def test_seeded_stream_matches_reference():
    out, js, ts = _run(_stream(3))
    st = t_backend("pq").stats(ts)
    assert int(st["pops"]) > 0 and int(st["size"]) > 0
    assert sum(int(ok.sum()) for ok, _ in out) > 0


def test_pq_dispatches_match_reference():
    plan = _lanes(*_inserts(range(3)), (OP_POPK, 0, 0), (OP_FIND, 5, 0))
    js = j_backend("pq").init(32)
    ts = t_backend("pq").init(32, device=DEV)
    with j_exec.measure_dispatches() as jm:
        jax.make_jaxpr(j_backend("pq").apply)(js, j_plan(*plan))
    with t_exec.exec_mode("torch"), t_exec.measure_dispatches() as tm:
        t_backend("pq").apply(ts, t_plan(*plan, device=DEV))
    assert (tm.n, tm.probe, tm.update) == (jm.n, jm.probe, jm.update) == \
        (2, 2, 0)
