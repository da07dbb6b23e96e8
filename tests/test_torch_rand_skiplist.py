"""The port's randomized skiplist against the JAX reference, bit for bit
(tolerance 0 on results and on every state leaf): `geometric_height`,
`insert_batch` / `delete_batch` / `find_batch` with in-batch duplicates,
masked and KEY_INF lanes and revival after delete, the level rebuild
(gap-cap promotions, and a level whose members exceed its capacity), and
the `rand_skiplist` backend (apply per plan and `scan`, dispatches, the
engine, a state built in JAX and continued in the port). Capacities
40-1,024, 64 lanes; each reference function is jitted once per shape.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro  # noqa: F401  (enables x64)
from repro.core import bits as jbits
from repro.core import rand_skiplist as jrsl
from repro.store import exec as j_exec
from repro.store import get_backend as j_backend
from repro.store import make_plan as j_plan
from repro_torch.convert import state_from_numpy, state_to_numpy, tree_leaves
from repro_torch.core import bits as tbits
from repro_torch.core import rand_skiplist as trsl
from repro_torch.core.bits import from_u64
from repro_torch.store import exec as t_exec
from repro_torch.store import get_backend as t_backend
from repro_torch.store import make_plan as t_plan
from repro_torch.store.engine import LOCAL_MESH, StoreEngine

DEV = "cpu"
K = 64
NAME = "rand_skiplist"
OP_NONE, OP_FIND, OP_INSERT, OP_DELETE = -1, 0, 1, 2
KEY_INF = np.uint64(2**64 - 1)
BOUNDARY = np.array([0, 1, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**64 - 2,
                     2**64 - 1], np.uint64)

J_INSERT = jax.jit(jrsl.insert_batch)
J_DELETE = jax.jit(jrsl.delete_batch)
J_FIND = jax.jit(jrsl.find_batch)
J_STEP = jax.jit(j_backend(NAME).apply)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_same(ref_tree, port_tree, ctx=""):
    """Leaf-for-leaf equality; a u64 reference leaf matches an int64 port
    leaf with the same bits, every other dtype must match exactly."""
    la = [np.asarray(x) for x in jax.tree.leaves(ref_tree)]
    lb = [_np(x) for x in tree_leaves(port_tree)]
    assert len(la) == len(lb), (ctx, len(la), len(lb))
    for i, (a, b) in enumerate(zip(la, lb)):
        if a.dtype == np.uint64 and b.dtype == np.int64:
            b = b.view(np.uint64)
        assert a.dtype == b.dtype, (ctx, i, a.dtype, b.dtype)
        assert a.shape == b.shape, (ctx, i, a.shape, b.shape)
        assert np.array_equal(a, b), (ctx, i)


def _t(a):
    return from_u64(a, DEV)


def test_geometric_height_matches_reference():
    rng = np.random.default_rng(0)
    x = np.concatenate([BOUNDARY, rng.integers(0, 2**64 - 1, 100_000,
                                               dtype=np.uint64,
                                               endpoint=True)])
    for max_height in (1, 2, 5, 12):
        ref = np.asarray(jbits.geometric_height(jnp.asarray(x), max_height))
        got = _np(tbits.geometric_height(_t(x), max_height))
        assert got.dtype == np.int32 and np.array_equal(ref, got), max_height
    counts = np.bincount(got)
    assert counts[0] > 3 * counts[1] > 0        # P(h >= 1) = 1/4


def _batches(seed, n, pool_size):
    rng = np.random.default_rng(seed)
    pool = np.unique(rng.integers(1, 2**64 - 2, pool_size, dtype=np.uint64))
    out = []
    for _ in range(n):
        keys = rng.choice(pool, K)
        keys[-3:] = keys[:3]                    # in-batch duplicates
        keys[5] = KEY_INF
        vals = rng.integers(0, 2**64 - 1, K, dtype=np.uint64)
        out.append((keys, vals, rng.random(K) > 0.1))
    return out


@pytest.mark.parametrize("cap,pool_size", [(64, 90), (300, 400),
                                           (1024, 1500)])
def test_insert_delete_find_match_reference(cap, pool_size):
    js = jrsl.rand_skiplist_init(cap)
    ts = trsl.rand_skiplist_init(cap, device=DEV)
    assert_same(js, state_to_numpy(ts), "init")
    revived = 0
    for i, (keys, vals, mask) in enumerate(_batches(cap, 6, pool_size)):
        jk, tk = jnp.asarray(keys), _t(keys)
        # revival: the lanes of a key deleted by the previous batch
        was_dead = _np(ts.term_mark)[np.clip(np.searchsorted(
            _np(ts.term_keys).view(np.uint64), keys), 0, cap - 1)]
        js, *jr = J_INSERT(js, jk, jnp.asarray(vals), jnp.asarray(mask))
        ts, *tr = trsl.insert_batch(ts, tk, _t(vals), torch.from_numpy(mask))
        assert_same(jr, tr, (cap, i, "insert"))
        assert_same(js, state_to_numpy(ts), (cap, i, "insert state"))
        revived += int((was_dead & _np(tr[0])).sum())
        dm = mask & (np.arange(K) % 3 == 0)
        js, jd = J_DELETE(js, jk, jnp.asarray(dm))
        ts, td = trsl.delete_batch(ts, tk, torch.from_numpy(dm))
        assert_same(jd, td, (cap, i, "delete"))
        assert_same(js, state_to_numpy(ts), (cap, i, "delete state"))
        q = np.concatenate([keys, BOUNDARY])
        assert_same(J_FIND(js, jnp.asarray(q)), trsl.find_batch(ts, _t(q)),
                    (cap, i, "find"))
    assert revived > 0
    assert int(ts.n_marked) > 0 and int(ts.level_count[0]) > 0


def test_level_over_capacity_and_forced_promotions():
    """40 keys that all want level 1 (hash height >= 1) overflow level 0's
    20 cells: the rebuild keeps the reference's clamped scatter, last
    member in the last cell. Then runs of non-promoted keys force
    gap-cap promotions."""
    rng = np.random.default_rng(5)
    cand = rng.integers(1, 2**64 - 2, 4000, dtype=np.uint64)
    hgt = np.asarray(jbits.geometric_height(jnp.asarray(cand), 1))
    tall, short = cand[hgt >= 1][:40], cand[hgt == 0][:200]
    for cap, keys in ((40, tall), (256, short)):
        js = jrsl.rand_skiplist_init(cap)
        ts = trsl.rand_skiplist_init(cap, device=DEV)
        m = np.ones(len(keys), bool)
        js, *jr = J_INSERT(js, jnp.asarray(keys), jnp.asarray(keys),
                           jnp.asarray(m))
        ts, *tr = trsl.insert_batch(ts, _t(keys), _t(keys),
                                    torch.from_numpy(m))
        assert_same((js, *jr), (state_to_numpy(ts), *tr), cap)
        assert_same(J_FIND(js, jnp.asarray(keys)),
                    trsl.find_batch(ts, _t(keys)), (cap, "find"))
        if cap == 40:
            assert int(ts.level_count[0]) == ts.level_keys[0].shape[0] == 20
    assert int(ts.forced) > 0


def _stream(seed, n_plans=6):
    rng = np.random.default_rng(seed)
    pool = np.unique(rng.integers(1, 2**64 - 2, 300, dtype=np.uint64))
    plans = []
    for p in range(n_plans):
        probs = [0.05, 0.3, 0.5, 0.15] if p < 3 else [0.05, 0.5, 0.25, 0.2]
        ops = rng.choice([OP_NONE, OP_FIND, OP_INSERT, OP_DELETE], K,
                         p=probs).astype(np.int32)
        keys = rng.choice(pool, K)
        keys[K - 2] = keys[3]
        vals = rng.integers(0, 2**64 - 1, K, dtype=np.uint64)
        plans.append((ops, keys, vals, rng.random(K) > 0.05))
    return plans


@pytest.mark.parametrize("cap", [64, 512])
def test_apply_parity_with_reference(cap):
    jb, tb = j_backend(NAME), t_backend(NAME)
    js, ts = jb.init(cap), tb.init(cap, device=DEV)
    with t_exec.exec_mode("torch"):
        for i, (ops, keys, vals, mask) in enumerate(_stream(cap)):
            js, jr = J_STEP(js, j_plan(ops, keys, vals, mask))
            ts, tr = tb.apply(ts, t_plan(ops, keys, vals, mask, device=DEV))
            assert_same(jr, tr, (cap, i, "results"))
            assert_same(js, state_to_numpy(ts), (cap, i, "state"))
    assert {k: int(v) for k, v in jb.stats(js).items()} == \
        {k: int(v) for k, v in tb.stats(ts).items()}
    rng = np.random.default_rng(cap + 100)
    lo = rng.integers(0, 2**64 - 1, 8, dtype=np.uint64)
    hi = lo + rng.integers(0, 2**62, 8, dtype=np.uint64)
    hi[0], lo[1] = np.uint64(2**64 - 1), np.uint64(0)
    ref = jax.jit(jb.scan, static_argnames="max_out")(
        js, jnp.asarray(lo), jnp.asarray(hi), max_out=12)
    t_lo, t_hi = t_plan([0] * 8, lo, hi, device=DEV)[1:3]
    assert_same(ref, tb.scan(ts, t_lo, t_hi, 12), (cap, "scan"))


def test_dispatches_per_apply_match_reference():
    plan = (np.array([OP_INSERT, OP_FIND, OP_DELETE], np.int32),
            np.array([5, 6, 7], np.uint64))
    jb, tb = j_backend(NAME), t_backend(NAME)
    with j_exec.measure_dispatches() as jm:
        jax.make_jaxpr(jb.apply)(jb.init(64), j_plan(*plan))
    with t_exec.exec_mode("torch"), t_exec.measure_dispatches() as tm:
        tb.apply(tb.init(64, device=DEV), t_plan(*plan, device=DEV))
    assert (tm.n, tm.probe, tm.update) == (jm.n, jm.probe, jm.update) \
        == (1, 1, 0)
    assert tb.ordered


def test_engine_matches_direct_apply():
    eng = StoreEngine(LOCAL_MESH, LOCAL_MESH.axis_names, K, NAME,
                      pool_factor=1, device=DEV, exec_mode="gpu")
    be = t_backend(NAME)
    se, sd = eng.init(256), be.init(256, device=DEV)
    for i, (ops, keys, vals, mask) in enumerate(_stream(9)):
        ops = np.where(mask, ops, OP_NONE).astype(np.int32)
        p = t_plan(ops, keys, vals, device=DEV)
        # rand_skiplist runs no kernel: exec mode gpu takes CPU tensors
        se, res_v, res_ok, dropped = eng.step(se, p.ops, p.keys, p.vals)
        with t_exec.exec_mode("torch"):
            sd, rd = be.apply(sd, t_plan(ops, keys, vals, ops >= 0,
                                         device=DEV))
        assert dropped == 0
        assert torch.equal(res_ok, rd.ok) and torch.equal(res_v, rd.vals)
        for a, b in zip(tree_leaves(se), tree_leaves(sd)):
            assert torch.equal(a, b), i
    assert eng.stats(se)["seq"] == 6


def test_state_built_in_jax_continues_in_port():
    jb, tb = j_backend(NAME), t_backend(NAME)
    js = jb.init(128)
    plans = _stream(4)
    for plan in plans[:3]:
        js, _ = J_STEP(js, j_plan(*plan))
    tree = jax.tree.map(np.asarray, js)
    ts = state_from_numpy(NAME, tree, DEV)
    assert_same(tree, state_to_numpy(ts), "round trip")
    assert ts.level_keys[0].data_ptr() == ts.level_keys.flat.data_ptr()
    with t_exec.exec_mode("torch"):
        for i, plan in enumerate(plans[3:]):
            js, jr = J_STEP(js, j_plan(*plan))
            ts, tr = tb.apply(ts, t_plan(*plan, device=DEV))
            assert_same(jr, tr, i)
            assert_same(js, state_to_numpy(ts), i)


def test_walk_misses_the_same_stored_keys_as_reference():
    """At 2^16 the reference's MAX_GAP walk misses some stored keys (a
    level gap of exactly MAX_GAP puts the target one cell past a 16-cell
    scan); the port misses exactly the same ones. The state is built in
    the port and handed to the reference's `find_batch`."""
    cap = 1 << 16
    rng = np.random.default_rng(0)
    keys = np.unique(rng.integers(1, 2**64 - 2, 3 * cap // 4 + 100,
                                  dtype=np.uint64))[:3 * cap // 4]
    ts = trsl.rand_skiplist_init(cap, device=DEV)
    for part in np.split(rng.permutation(keys), 3):
        ts, ins, _ = trsl.insert_batch(ts, _t(part), _t(part))
        assert bool(ins.all())
    js = jax.tree.map(jnp.asarray, state_to_numpy(ts))
    ref = J_FIND(js, jnp.asarray(keys))
    got = trsl.find_batch(ts, _t(keys))
    assert_same(ref, got, "find")
    assert 0 < int((~got[0]).sum()) < len(keys) // 1000
