"""The port's hash structures against the JAX reference, bit for bit
(tolerance 0 on results and on every state leaf): `bitrev64`, the block
pool and its free ring, the two-level hash table, the one- and two-level
split-order tables, the splitorder_probe kernel's plain version (against
the Pallas kernel in interpret mode and the reference's oracle, with an
injected rk collision run), and the `twolevel_hash`, `splitorder` and
`twolevel_splitorder` backends (apply per plan, dispatches, the engine,
a state built in JAX and continued in the port). Small sizes: capacities
64-1,024, 2-8 tables, 32-256 lanes; each reference function is jitted
once per shape.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro  # noqa: F401  (enables x64)
from repro.core import bits as jbits
from repro.core import blockpool as jbp
from repro.core import hashtable as jht
from repro.core import splitorder as jso
from repro.core.layout import split_u64
from repro.kernels.splitorder_probe.kernel import splitorder_probe_tiles as j_so_tiles
from repro.kernels.splitorder_probe.ops import twolevel_splitorder_probe as j_so_probe
from repro.kernels.splitorder_probe.ref import splitorder_probe_ref as j_so_ref
from repro.store import exec as j_exec
from repro.store import get_backend as j_backend
from repro.store import make_plan as j_plan
from repro_torch.convert import state_from_numpy, state_to_numpy, tree_leaves
from repro_torch.core import bits as tbits
from repro_torch.core import blockpool as tbp
from repro_torch.core import hashtable as tht
from repro_torch.core import splitorder as tso
from repro_torch.core.bits import from_u64
from repro_torch.kernels.splitorder_probe.kernel import splitorder_probe_tiles
from repro_torch.kernels.splitorder_probe.ops import twolevel_splitorder_probe
from repro_torch.store import available_backends
from repro_torch.store import exec as t_exec
from repro_torch.store import get_backend as t_backend
from repro_torch.store import make_plan as t_plan
from repro_torch.store.engine import LOCAL_MESH, StoreEngine

DEV = "cpu"
K = 64
BACKENDS = ["twolevel_hash", "splitorder", "twolevel_splitorder"]
OP_NONE, OP_FIND, OP_INSERT, OP_DELETE = -1, 0, 1, 2
KEY_INF = np.uint64(2**64 - 1)
BOUNDARY = np.array([0, 1, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**64 - 2,
                     2**64 - 1], np.uint64)

J = {name: jax.jit(fn) for name, fn in (
    ("tl_insert", jht.twolevel_insert), ("tl_delete", jht.twolevel_delete),
    ("tl_find", jht.twolevel_find), ("so_insert", jso.splitorder_insert),
    ("so_delete", jso.splitorder_delete), ("so_find", jso.splitorder_find),
    ("so_bounds", jso.splitorder_slot_bounds),
    ("tso_insert", jso.twolevel_splitorder_insert),
    ("tso_delete", jso.twolevel_splitorder_delete),
    ("tso_find", jso.twolevel_splitorder_find),
    ("so_ref", j_so_ref))}
J_SO_TILES = jax.jit(j_so_tiles, static_argnames=("tile", "interpret"))
J_SO_PROBE = jax.jit(j_so_probe, static_argnames=("tile", "interpret"))


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


def _batches(seed, n, pool_size, width=K):
    """Seeded (keys, vals, mask) batches over a key pool: in-batch
    duplicates, ~10% masked lanes, KEY_INF lanes."""
    rng = np.random.default_rng(seed)
    pool = np.unique(rng.integers(1, 2**64 - 2, pool_size, dtype=np.uint64))
    out = []
    for _ in range(n):
        keys = rng.choice(pool, width)
        keys[-3:] = keys[:3]
        keys[5] = KEY_INF
        vals = rng.integers(0, 2**64 - 1, width, dtype=np.uint64)
        mask = rng.random(width) > 0.1
        out.append((keys, vals, mask))
    return out


def _drive(js, ts, jfns, tfns, batches, ctx):
    """insert, then delete half the batch, then find, per batch; results
    and every state leaf held against the reference after each op."""
    j_ins, j_del, j_find = jfns
    t_ins, t_del, t_find = tfns
    for i, (keys, vals, mask) in enumerate(batches):
        jk, jv, jm = jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(mask)
        tk, tv, tm = _t(keys), _t(vals), torch.from_numpy(mask)
        js, *jr = j_ins(js, jk, jv, jm)
        ts, *tr = t_ins(ts, tk, tv, tm)
        assert_same(jr, tr, (ctx, i, "insert"))
        assert_same(js, state_to_numpy(ts), (ctx, i, "insert state"))
        dm = mask & (np.arange(len(keys)) % 2 == 0)
        js, *jr = j_del(js, jk, jnp.asarray(dm))
        ts, *tr = t_del(ts, tk, torch.from_numpy(dm))
        assert_same(jr, tr, (ctx, i, "delete"))
        assert_same(js, state_to_numpy(ts), (ctx, i, "delete state"))
        assert_same(j_find(js, jk), t_find(ts, tk), (ctx, i, "find"))
    return js, ts


# ---------------------------------------------------------------------------
# bits
# ---------------------------------------------------------------------------

def test_bitrev64_matches_reference():
    rng = np.random.default_rng(0)
    x = np.concatenate([BOUNDARY, rng.integers(0, 2**64 - 1, 100_000,
                                               dtype=np.uint64,
                                               endpoint=True)])
    ref = np.asarray(jbits.bitrev64(jnp.asarray(x)))
    got = _np(tbits.bitrev64(_t(x))).view(np.uint64)
    assert np.array_equal(ref, got)
    assert got[list(BOUNDARY).index(2**63)] == 1
    assert np.array_equal(_np(tbits.bitrev64(tbits.bitrev64(_t(x)))),
                          _np(_t(x)))


# ---------------------------------------------------------------------------
# the block pool
# ---------------------------------------------------------------------------

def test_freering_push_pop_matches_reference():
    jr = jbp.freering_init(16, fill_ids=5)
    tr = tbp.freering_init(16, fill_ids=5, device=DEV)
    assert_same(jr, tr, "init")
    rng = np.random.default_rng(1)
    for i in range(12):
        want = rng.random(8) > 0.3
        jr, jids, jgot = jbp.freering_pop(jr, jnp.asarray(want))
        tr, tids, tgot = tbp.freering_pop(tr, torch.from_numpy(want))
        assert_same((jr, jids, jgot), (tr, tids, tgot), (i, "pop"))
        ids = rng.integers(-1, 16, 8).astype(np.int32)
        mask = rng.random(8) > 0.4
        jr = jbp.freering_push(jr, jnp.asarray(ids), jnp.asarray(mask))
        tr = tbp.freering_push(tr, torch.from_numpy(ids),
                               torch.from_numpy(mask))
        assert_same(jr, tr, (i, "push"))
    assert int(tr.head) > 16                  # the counters wrapped the ring


def test_blockpool_alloc_free_generations_and_stale_handles():
    jp, tp = jbp.blockpool_init(8), tbp.blockpool_init(8, device=DEV)
    assert_same(jp, state_to_numpy(tp), "init")
    want = np.ones(12, bool)
    jp, jids, jh, jgot = jbp.pool_alloc(jp, jnp.asarray(want))
    tp, tids, th, tgot = tbp.pool_alloc(tp, torch.from_numpy(want))
    assert_same((jp, jids, jh, jgot), (state_to_numpy(tp), tids, th, tgot),
                "exhaust")
    assert int(tgot.sum()) == 8 and int(tp.num_free()) == 0   # exhausted
    free_m = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1, 1, 0, 0], bool)
    jp = jbp.pool_free(jp, jids, jnp.asarray(free_m))
    tp = tbp.pool_free(tp, tids, torch.from_numpy(free_m))
    assert_same(jp, state_to_numpy(tp), "free")
    stale = (jbp.handle_valid(jp, jh), tbp.handle_valid(tp, th))
    assert_same(*stale, "stale")
    assert not bool(stale[1][0]) and bool(stale[1][1])
    want = np.array([1, 1, 0, 1], bool)
    jp, jids, jh2, jgot = jbp.pool_alloc(jp, jnp.asarray(want))
    tp, tids, th2, tgot = tbp.pool_alloc(tp, torch.from_numpy(want))
    assert_same((jp, jids, jh2, jgot), (state_to_numpy(tp), tids, th2, tgot),
                "realloc")
    both = np.concatenate([np.asarray(jh), np.asarray(jh2)])
    assert_same(jbp.handle_valid(jp, jnp.asarray(both)),
                tbp.handle_valid(tp, _t(both)), "handles")
    assert int(_np(tp.gen).max()) == 1       # freed blocks bumped once


def test_blockpool_generation_wraps_as_uint32():
    jp = jbp.blockpool_init(4)
    jp = jp._replace(gen=jnp.asarray([2**32 - 1, 2**31 - 1, 7, 0],
                                     jnp.uint32))
    tp = state_from_numpy("twolevel_hash", _tl_wrap(jp), DEV).pool
    ids = np.arange(4, dtype=np.int32)
    m = np.ones(4, bool)
    jp, jids, jh, _ = jbp.pool_alloc(jp, jnp.asarray(m))
    tp, tids, th, _ = tbp.pool_alloc(tp, torch.from_numpy(m))
    assert_same(jh, th, "handles carry uint32 generations")
    jp = jbp.pool_free(jp, jnp.asarray(ids), jnp.asarray(m))
    tp = tbp.pool_free(tp, torch.from_numpy(ids), torch.from_numpy(m))
    out = state_to_numpy(tp)
    assert out.gen.dtype == np.uint32
    assert np.array_equal(out.gen, np.asarray(jp.gen))
    assert list(out.gen) == [0, 2**31, 8, 1]


def _tl_wrap(pool):
    """A TwoLevelHash shell around a reference pool, for `convert`."""
    h = jht.twolevel_init(2, 2, 2, 2, pool.gen.shape[0])
    return jax.tree.map(np.asarray, h._replace(pool=pool))


# ---------------------------------------------------------------------------
# the two-level hash table
# ---------------------------------------------------------------------------

TL_FNS = ((J["tl_insert"], J["tl_delete"], J["tl_find"]),
          (tht.twolevel_insert, tht.twolevel_delete, tht.twolevel_find))


@pytest.mark.parametrize("m1,b1,m2,b2,pool,pool_size", [
    (16, 4, 4, 2, 16, 150),      # most slots expand once
    (16, 2, 2, 2, 3, 300),       # pool exhaustion: overflow lanes fail
    (16, 8, 16, 8, 16, 600),     # the backend's default bucket shapes
])
def test_twolevel_hash_matches_reference(m1, b1, m2, b2, pool, pool_size):
    js = jht.twolevel_init(m1, b1, m2, b2, pool)
    ts = tht.twolevel_init(m1, b1, m2, b2, pool, device=DEV)
    assert_same(js, state_to_numpy(ts), "init")
    js, ts = _drive(js, ts, *TL_FNS, _batches(m1 + pool, 5, pool_size),
                    ("twolevel", m1, pool))
    assert int((ts.l2_block >= 0).sum()) > 0               # L2 expanded
    if pool == 3:
        assert int(ts.pool.num_free()) == 0                # exhausted


# ---------------------------------------------------------------------------
# split-order tables
# ---------------------------------------------------------------------------

SO_FNS = ((J["so_insert"], J["so_delete"], J["so_find"]),
          (tso.splitorder_insert, tso.splitorder_delete, tso.splitorder_find))


@pytest.mark.parametrize("cap,seed_slots,max_load,pool_size", [
    (256, 2, 4, 200),            # n_slots doubles on every insert plan
    (100, 4, 16, 500),           # full capacity: the highest ranks drop
    (1024, 1, 1, 3000),
])
def test_splitorder_matches_reference(cap, seed_slots, max_load, pool_size):
    js = jso.splitorder_init(cap, seed_slots, max_load)
    ts = tso.splitorder_init(cap, seed_slots, max_load, device=DEV)
    assert_same(js, state_to_numpy(ts), "init")
    js, ts = _drive(js, ts, *SO_FNS, _batches(cap, 5, pool_size),
                    ("splitorder", cap))
    assert int(ts.n_slots) > seed_slots                    # it resized
    if cap == 100:
        assert int(ts.n) >= cap - K // 2                   # it filled up
    keys = np.concatenate([BOUNDARY, _batches(7, 1, 50)[0][0]])
    got = tso.splitorder_slot_bounds(ts, _t(keys))
    assert_same(_slot_bounds_exact(js, jnp.asarray(keys)), got, "bounds")
    if _log2_exact(int(ts.n_slots)):
        assert_same(J["so_bounds"](js, jnp.asarray(keys)), got, "reference")


def _log2_exact(n_slots: int) -> bool:
    """Whether the reference's float `jnp.log2` gives the exact exponent
    of this power of two (XLA on the CPU gives 2.99... for 8, 64, 128)."""
    return int(jnp.log2(jnp.float64(n_slots)).astype(jnp.int32)) == \
        n_slots.bit_length() - 1


def _slot_bounds_exact(h, keys):
    """The reference's `splitorder_slot_bounds` with an exact integer
    log2 of `n_slots`, in the reference's own u64 functions."""
    m = int(h.n_slots).bit_length() - 1
    slot = jbits.hash64(keys) & jnp.uint64(int(h.n_slots) - 1)
    lo_rk = jbits.bitrev64(slot)
    hi_rk = lo_rk + (jbits.KEY_INF >> jnp.uint64(m))
    lo = jnp.searchsorted(h.rk, lo_rk, side="left").astype(jnp.int32)
    hi = jnp.searchsorted(h.rk, hi_rk, side="left").astype(jnp.int32)
    return lo, jnp.where(hi_rk < lo_rk, h.n, hi)


def test_splitorder_full_capacity_drops_inserts():
    js = jso.splitorder_init(32, 2)
    ts = tso.splitorder_init(32, 2, device=DEV)
    keys = np.arange(1, K + 1, dtype=np.uint64) * np.uint64(7919)
    m = np.ones(K, bool)
    js, ji, je = J["so_insert"](js, jnp.asarray(keys), jnp.asarray(keys),
                                jnp.asarray(m))
    ts, ti, te = tso.splitorder_insert(ts, _t(keys), _t(keys),
                                       torch.from_numpy(m))
    assert_same((js, ji, je), (state_to_numpy(ts), ti, te))
    assert int(ts.n) == 32 and int(ti.sum()) == 32


TSO_FNS = ((J["tso_insert"], J["tso_delete"], J["tso_find"]),
           (tso.twolevel_splitorder_insert, tso.twolevel_splitorder_delete,
            tso.twolevel_splitorder_find))


@pytest.mark.parametrize("tables,cap,pool_size", [
    (2, 64, 100), (4, 16, 400), (8, 128, 600)])
def test_twolevel_splitorder_matches_reference(tables, cap, pool_size):
    js = jso.twolevel_splitorder_init(tables, cap, 2, 4)
    ts = tso.twolevel_splitorder_init(tables, cap, 2, 4, device=DEV)
    assert_same(js, state_to_numpy(ts), "init")
    js, ts = _drive(js, ts, *TSO_FNS, _batches(tables, 5, pool_size),
                    ("twolevel_splitorder", tables))
    assert _np(ts.n).min() != _np(ts.n).max()              # uneven routing
    if tables == 4:                                        # fill a table
        keys, vals, mask = _batches(99, 1, 400)[0]
        js, *jr = J["tso_insert"](js, jnp.asarray(keys), jnp.asarray(vals),
                                  jnp.asarray(mask))
        ts, *tr = tso.twolevel_splitorder_insert(ts, _t(keys), _t(vals),
                                                 torch.from_numpy(mask))
        assert_same((js, *jr), (state_to_numpy(ts), *tr), "fill")
        assert _np(ts.n).max() == cap


def test_twolevel_splitorder_routes_uneven_batches():
    """Every lane of a batch routed to one table, then to another."""
    js = jso.twolevel_splitorder_init(4, 64, 1, 2)
    ts = tso.twolevel_splitorder_init(4, 64, 1, 2, device=DEV)
    rng = np.random.default_rng(3)
    cand = rng.integers(1, 2**64 - 2, 4000, dtype=np.uint64)
    tbl = _np(tso._table_of(ts, _t(cand)))
    for t in (2, 0):
        keys = cand[tbl == t][:K]
        m = np.ones(K, bool)
        js, ji, je = J["tso_insert"](js, jnp.asarray(keys), jnp.asarray(keys),
                                     jnp.asarray(m))
        ts, ti, te = tso.twolevel_splitorder_insert(ts, _t(keys), _t(keys),
                                                    torch.from_numpy(m))
        assert_same((js, ji, je), (state_to_numpy(ts), ti, te), t)
    assert list(_np(ts.n)) == [64, 0, 64, 0]


# ---------------------------------------------------------------------------
# the splitorder_probe kernel's plain version
# ---------------------------------------------------------------------------

def _probe_state(tables=4, cap=128):
    """A two-level table with a full table, an empty one, and a run of 5
    cells in table 3 sharing one rk with different keys (an injected
    64-bit hash collision run). Returns (reference state, run start)."""
    js = jso.twolevel_splitorder_init(tables, cap, 2, 16)
    rng = np.random.default_rng(11)
    cand = rng.integers(1, 2**64 - 2, 4000, dtype=np.uint64)
    tbl = np.asarray(jso._table_of(js, jnp.asarray(cand)))
    keys = np.concatenate([cand[tbl == 0][:cap], cand[tbl == 2][:cap // 2],
                           cand[tbl == 3][:cap * 3 // 4]])
    for i in range(0, len(keys), K):
        part = keys[i:i + K]
        js, _, _ = J["tso_insert"](js, jnp.asarray(part), jnp.asarray(part),
                                   jnp.ones(len(part), bool))
    assert list(np.asarray(js.n)) == [cap, 0, cap // 2, cap * 3 // 4]
    a = 20
    rk = np.asarray(js.rk).copy()
    rk[3, a:a + 5] = rk[3, a]
    return js._replace(rk=jnp.asarray(rk)), a


def test_splitorder_probe_plain_matches_pallas_kernel():
    js, a = _probe_state()
    rng = np.random.default_rng(12)
    T = 256
    tables = rng.integers(0, 4, T).astype(np.int32)
    tables[:4] = [-3, 9, 1, 0]                             # clipped ids
    rk, keys = np.asarray(js.rk), np.asarray(js.keys)
    col = rng.integers(0, 128, T)
    q_rk = rk[np.clip(tables, 0, 3), col].copy()
    q_key = keys[np.clip(tables, 0, 3), col].copy()
    miss = rng.random(T) < 0.3
    q_key[miss] = rng.integers(1, 2**64 - 2, miss.sum(), dtype=np.uint64)
    q_rk[miss & (rng.random(T) < 0.5)] ^= np.uint64(1)
    q_rk[8], q_key[8] = KEY_INF, KEY_INF
    for k in range(5):                                     # the collision run
        tables[10 + k], q_rk[10 + k], q_key[10 + k] = 3, rk[3, a], keys[3, a + k]
    planes = [*split_u64(jnp.asarray(q_rk)), *split_u64(jnp.asarray(q_key)),
              jnp.asarray(tables), *split_u64(js.rk), *split_u64(js.keys)]
    jf, jat = J_SO_TILES(*planes, tile=128, interpret=True)
    rf, rat = J["so_ref"](*planes)
    tf, tat = splitorder_probe_tiles(_t(q_rk), _t(q_key),
                                     torch.from_numpy(tables),
                                     _t(rk), _t(keys))
    assert tf.dtype == torch.int8 and tat.dtype == torch.int32
    assert np.array_equal(np.asarray(jf), _np(tf))
    assert np.array_equal(np.asarray(jat), _np(tat))
    assert np.array_equal(np.asarray(rf), _np(tf).astype(bool))
    assert np.array_equal(np.asarray(rat), _np(tat))
    got = _np(tf)[10:15].tolist(), _np(tat)[10:15].tolist()
    assert got == ([1, 1, 1, 1, 0], [a, a + 1, a + 2, a + 3, a])
    assert 0 < int(tf.sum()) < T


def test_splitorder_probe_glue_matches_reference_ops():
    js, _ = _probe_state()
    ts = state_from_numpy("twolevel_splitorder", jax.tree.map(np.asarray, js),
                          DEV)
    keys = np.concatenate([np.asarray(js.keys)[[0, 2, 3], :60].reshape(-1),
                           _batches(5, 1, 100, width=60)[0][0]])
    keys[7] = KEY_INF
    ref = J_SO_PROBE(js, jnp.asarray(keys), tile=128, interpret=True)
    assert_same(ref, twolevel_splitorder_probe(ts, _t(keys)), "ops")
    assert_same(ref, tso.twolevel_splitorder_find(ts, _t(keys)), "core find")
    assert_same(J["tso_find"](js, jnp.asarray(keys)),
                tso.twolevel_splitorder_find(ts, _t(keys)), "reference find")


# ---------------------------------------------------------------------------
# the backends
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _j_step(name):
    return jax.jit(j_backend(name).apply)


def _stream(seed, n_plans=6, width=K):
    rng = np.random.default_rng(seed)
    pool = np.unique(rng.integers(1, 2**64 - 2, 300, dtype=np.uint64))
    plans = []
    for p in range(n_plans):
        probs = [0.05, 0.3, 0.5, 0.15] if p < 3 else [0.05, 0.5, 0.25, 0.2]
        ops = rng.choice([OP_NONE, OP_FIND, OP_INSERT, OP_DELETE], width,
                         p=probs).astype(np.int32)
        keys = rng.choice(pool, width)
        keys[width - 2] = keys[3]
        vals = rng.integers(0, 2**64 - 1, width, dtype=np.uint64)
        plans.append((ops, keys, vals, rng.random(width) > 0.05))
    return plans


def test_registry_lists_every_flat_backend():
    names = available_backends()
    for n in BACKENDS + ["rand_skiplist", "det_skiplist", "fixed_hash"]:
        assert n in names
        assert t_backend(n).name == n
    for n in BACKENDS:
        assert not t_backend(n).ordered
        with pytest.raises(NotImplementedError, match="unordered"):
            t_backend(n).scan(None, None, None, 4)


@pytest.mark.parametrize("name,cap", [(n, c) for n in BACKENDS
                                      for c in (64, 512)])
def test_apply_parity_with_reference(name, cap):
    jb, tb = j_backend(name), t_backend(name)
    js, ts = jb.init(cap), tb.init(cap, device=DEV)
    assert_same(js, state_to_numpy(ts), (name, "init"))
    with t_exec.exec_mode("torch"):
        for i, (ops, keys, vals, mask) in enumerate(_stream(cap)):
            js, jr = _j_step(name)(js, j_plan(ops, keys, vals, mask))
            ts, tr = tb.apply(ts, t_plan(ops, keys, vals, mask, device=DEV))
            assert_same(jr, tr, (name, i, "results"))
            assert_same(js, state_to_numpy(ts), (name, i, "state"))
    j_stats = {k: int(v) for k, v in jb.stats(js).items()}
    t_stats = {k: int(v) for k, v in tb.stats(ts).items()}
    assert j_stats == t_stats
    assert t_stats["size"] > 0
    if name == "twolevel_hash" and cap == 64:
        assert t_stats["l2_tables"] > 0


@pytest.mark.parametrize("name", BACKENDS)
def test_dispatches_per_apply_match_reference(name):
    plan = (np.array([OP_INSERT, OP_FIND, OP_DELETE], np.int32),
            np.array([5, 6, 7], np.uint64))
    jb, tb = j_backend(name), t_backend(name)
    js, ts = jb.init(64), tb.init(64, device=DEV)
    with j_exec.measure_dispatches() as jm:
        jax.make_jaxpr(jb.apply)(js, j_plan(*plan))
    with t_exec.exec_mode("torch"), t_exec.measure_dispatches() as tm:
        tb.apply(ts, t_plan(*plan, device=DEV))
    assert (tm.n, tm.probe, tm.update) == (jm.n, jm.probe, jm.update) \
        == (1, 1, 0)


def _leaves_equal(a, b):
    return all(torch.equal(x, y) if torch.is_tensor(x) else x == y
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.parametrize("name", BACKENDS)
def test_engine_matches_direct_apply(name):
    eng = StoreEngine(LOCAL_MESH, LOCAL_MESH.axis_names, K, name,
                      pool_factor=1, device=DEV, exec_mode="torch")
    be = t_backend(name)
    se, sd = eng.init(256), be.init(256, device=DEV)
    for i, (ops, keys, vals, mask) in enumerate(_stream(9)):
        ops = np.where(mask, ops, OP_NONE).astype(np.int32)
        p = t_plan(ops, keys, vals, device=DEV)
        se, res_v, res_ok, dropped = eng.step(se, p.ops, p.keys, p.vals)
        with t_exec.exec_mode("torch"):
            sd, rd = be.apply(sd, t_plan(ops, keys, vals, ops >= 0,
                                         device=DEV))
        assert dropped == 0
        assert torch.equal(res_ok, rd.ok) and torch.equal(res_v, rd.vals)
        assert _leaves_equal(se, sd), (name, i)
    assert eng.stats(se)["seq"] == 6


@pytest.mark.parametrize("name", BACKENDS)
def test_state_built_in_jax_continues_in_port(name):
    jb, tb = j_backend(name), t_backend(name)
    js = jb.init(128)
    plans = _stream(4)
    for plan in plans[:3]:
        js, _ = _j_step(name)(js, j_plan(*plan))
    tree = jax.tree.map(np.asarray, js)
    ts = state_from_numpy(name, tree, DEV)
    assert_same(tree, state_to_numpy(ts), (name, "round trip"))
    with t_exec.exec_mode("torch"):
        for i, plan in enumerate(plans[3:]):
            js, jr = _j_step(name)(js, j_plan(*plan))
            ts, tr = tb.apply(ts, t_plan(*plan, device=DEV))
            assert_same(jr, tr, (name, i))
            assert_same(js, state_to_numpy(ts), (name, i))


def test_gpu_mode_refuses_cpu_tensors():
    be = t_backend("twolevel_splitorder")
    st = be.init(64, device=DEV)
    plan = t_plan([OP_FIND], np.array([5], np.uint64), device=DEV)
    with t_exec.exec_mode("gpu"), pytest.raises(RuntimeError, match="gpu"):
        be.apply(st, plan)
    for name in ("twolevel_hash", "splitorder"):   # plain in every mode
        be = t_backend(name)
        with t_exec.exec_mode("gpu"):
            _, res = be.apply(be.init(64, device=DEV), plan)
        assert not bool(res.ok[0])
