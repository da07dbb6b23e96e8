"""Parity of the port's core modules with the JAX reference, bit for bit.

The same seeded numpy inputs go through `repro.core.*` and its
`repro_torch.core.*` counterpart; results and every state leaf (after
`repro_torch.convert`) must match in value and dtype (u64 leaves of the
reference are int64 bit patterns in the port). Tolerance: 0.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro  # noqa: F401  (enables x64)
from repro.core import bits as jbits
from repro.core import det_skiplist as jdsl
from repro.core import hashtable as jht
from repro.core import layout as jlay
from repro_torch.convert import state_from_numpy, state_to_numpy, tree_leaves
from repro_torch.core import bits as tbits
from repro_torch.core import det_skiplist as tdsl
from repro_torch.core import hashtable as tht
from repro_torch.core import layout as tlay
from repro_torch.core.bits import from_u64

DEV = "cpu"
# the reference runs jitted: one compile per shape beats op-by-op dispatch
J_INSERT = jax.jit(jdsl.insert_batch)
J_DELETE = jax.jit(jdsl.delete_batch)
J_FIND = jax.jit(jdsl.find_batch)
J_COMPACT = jax.jit(jdsl.compact)
J_RANGE = jax.jit(jdsl.range_query, static_argnames=("max_out", "as_of_batch"))
J_RANGE_DELETE = jax.jit(jdsl.range_delete_batch)
J_LAYOUT = jax.jit(jlay.skiplist_layout)
BOUNDARY = np.array([0, 1, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**64 - 2,
                     2**64 - 1], np.uint64)


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


# ---------------------------------------------------------------------------
# bits and layout
# ---------------------------------------------------------------------------

def test_splitmix64_and_hash_slot_match_on_boundary_keys():
    rng = np.random.default_rng(0)
    k = np.concatenate([BOUNDARY, rng.integers(0, 2**64 - 1, 4096,
                                               dtype=np.uint64)])
    assert_same(jbits.splitmix64(jnp.asarray(k)),
                tbits.splitmix64(from_u64(k, DEV)))
    for m in (1, 64, 1 << 20):
        assert_same(jlay.hash_slot(jnp.asarray(k), m),
                    tlay.hash_slot(from_u64(k, DEV), m))


def test_val_weight_and_key_order_match():
    rng = np.random.default_rng(1)
    k = np.concatenate([BOUNDARY, rng.integers(0, 2**64 - 1, 2048,
                                               dtype=np.uint64),
                        (np.uint64(1) << rng.integers(0, 64, 256).astype(
                            np.uint64))])
    assert_same(jlay.val_weight(jnp.asarray(k)),
                tlay.val_weight(from_u64(k, DEV)))
    order = torch.argsort(tbits.ordered(from_u64(k, DEV)), stable=True)
    assert np.array_equal(order.numpy(), np.argsort(k, kind="stable"))
    a, b = from_u64(k, DEV), from_u64(k[::-1].copy(), DEV)
    assert np.array_equal(tbits.u64_lt(a, b).numpy(), k < k[::-1])
    assert np.array_equal(tbits.u64_le(a, b).numpy(), k <= k[::-1])
    # KEY_INF is -1 as int64 and still sorts last
    assert int(tbits.ordered(torch.tensor([tbits.KEY_INF])).item()) == 2**63 - 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dup_in_run_matches(seed):
    rng = np.random.default_rng(seed)
    n = 257
    same = rng.random(n) < 0.5
    same[0] = False
    masked = rng.random(n) < 0.6
    assert_same(jbits.dup_in_run(jnp.asarray(same), jnp.asarray(masked)),
                tbits.dup_in_run(torch.from_numpy(same),
                                 torch.from_numpy(masked)))


def test_layout_planes_match():
    rng = np.random.default_rng(3)
    s_cap = 512
    run_start = rng.random(s_cap) < 0.05
    run_start[0] = True
    for n in (0, 37, 300, 512):
        assert_same(jlay.run_offsets(jnp.asarray(run_start), jnp.int32(n)),
                    tlay.run_offsets(torch.from_numpy(run_start),
                                     torch.tensor(n, dtype=torch.int32)))
    assert_same(jlay.kv_arrays((8, 4)), tlay.kv_arrays((8, 4), device=DEV))
    assert_same(jlay.policy_arrays((8, 4)),
                tlay.policy_arrays((8, 4), device=DEV))
    assert_same(jlay.spill_arrays(64), tlay.spill_arrays(64, device=DEV))

    # the flat level view reproduces the padded [L, C1] rectangle row by row
    js = jdsl.skiplist_init(1000)
    ks = jnp.asarray(rng.integers(1, 2**64 - 2, 600, dtype=np.uint64))
    js, _, _ = J_INSERT(js, ks, ks)
    ts = state_from_numpy("det_skiplist", jax.tree.map(np.asarray, js), DEV)
    rect = J_LAYOUT(js)
    flat = tlay.skiplist_layout(ts)
    assert flat.c1 == rect.lvl_hi.shape[1]
    assert flat.num_levels == rect.lvl_hi.shape[0]
    for r in range(flat.num_levels):
        lo, hi = flat.offsets[r], flat.offsets[r + 1]
        keys = flat.lvl_keys[lo:hi].numpy().view(np.uint64)
        rk = ((np.asarray(rect.lvl_hi[r]).astype(np.uint64) << np.uint64(32))
              | np.asarray(rect.lvl_lo[r]).astype(np.uint64))
        assert np.array_equal(keys, rk[:hi - lo])
        assert (rk[hi - lo:] == np.uint64(2**64 - 1)).all()
        assert np.array_equal(flat.lvl_child[lo:hi].numpy(),
                              np.asarray(rect.lvl_child[r])[:hi - lo])
    assert np.array_equal(flat.term_mark.numpy(), np.asarray(rect.term_mark))
    # the view copies nothing, also after the port rebuilds the levels
    ts2, _, _ = tdsl.insert_batch(ts, from_u64(np.asarray(ks[:8]) + 1, DEV),
                                  from_u64(np.asarray(ks[:8]), DEV))
    for st in (ts, ts2):
        lay = tlay.skiplist_layout(st)
        for r, (lk, lc) in enumerate(zip(st.level_keys, st.level_child)):
            assert lk.data_ptr() == lay.lvl_keys[lay.offsets[r]:].data_ptr()
            assert lc.data_ptr() == lay.lvl_child[lay.offsets[r]:].data_ptr()
        assert lay.term_mark.data_ptr() == st.term_mark.data_ptr()
    sp = tlay.spill_layout(from_u64(rng.integers(0, 9, 64, dtype=np.uint64),
                                    DEV), torch.zeros(64, dtype=torch.bool),
                           torch.from_numpy(run_start[:64]),
                           torch.tensor(40, dtype=torch.int32))
    assert sp.dead.dtype == torch.int8 and sp.run_off.shape == (17,)


# ---------------------------------------------------------------------------
# det_skiplist: every op against the reference, results and state leaves
# ---------------------------------------------------------------------------

def _skiplist_pair(seed, cap=512, n=300, n_del=60):
    rng = np.random.default_rng(seed)
    js = jdsl.skiplist_init(cap)
    ks = np.unique(rng.integers(1, 2**64 - 2, n, dtype=np.uint64))
    rng.shuffle(ks)
    js, _, _ = J_INSERT(js, jnp.asarray(ks), jnp.asarray(ks + 7))
    js, _ = J_DELETE(js, jnp.asarray(ks[:n_del]))
    ts = state_from_numpy("det_skiplist", jax.tree.map(np.asarray, js), DEV)
    assert_same(js, state_to_numpy(ts), "convert")
    return rng, js, ts, ks


def _batch(rng, ks, k):
    keys = np.where(rng.random(k) < 0.5, rng.choice(ks, k),
                    rng.integers(0, 2**64 - 1, k, dtype=np.uint64))
    keys[: len(BOUNDARY)] = BOUNDARY
    keys[k - 3] = keys[k - 10]                         # in-batch duplicate
    mask = rng.random(k) > 0.1
    return keys, rng.integers(0, 2**64 - 1, k, dtype=np.uint64), mask


def _t(a):
    return from_u64(a, DEV) if a.dtype == np.uint64 else torch.from_numpy(a)


@pytest.mark.parametrize("seed", [0, 1])
def test_det_skiplist_insert_delete_find_compact(seed):
    rng, js, ts, ks = _skiplist_pair(seed)
    keys, vals, mask = _batch(rng, ks, 96)
    jo = J_INSERT(js, jnp.asarray(keys), jnp.asarray(vals),
                           jnp.asarray(mask))
    to = tdsl.insert_batch(ts, _t(keys), _t(vals), _t(mask))
    assert_same(jo, to, "insert")
    js, ts = jo[0], to[0]
    # delete enough to cross the 25% compaction threshold
    dk = np.concatenate([ks[60:200], keys[:20]])
    jo = J_DELETE(js, jnp.asarray(dk))
    to = tdsl.delete_batch(ts, _t(dk))
    assert_same(jo, to, "delete+compact")
    js, ts = jo[0], to[0]
    q = np.concatenate([keys, ks[:64]])
    assert_same(J_FIND(js, jnp.asarray(q)),
                tdsl.find_batch(ts, _t(q)), "find")
    assert_same(J_COMPACT(js), tdsl.compact(ts), "compact")
    inv = tdsl.check_invariants(ts)
    assert inv == {k: 0 for k in inv}, inv


def test_det_skiplist_range_query_and_range_delete():
    rng, js, ts, ks = _skiplist_pair(5)
    los = rng.integers(0, 2**64 - 1, 24, dtype=np.uint64)
    his = los + rng.integers(0, 2**62, 24, dtype=np.uint64)
    his[:4] = np.uint64(2**64 - 1)
    mask = rng.random(24) > 0.3
    for as_of in (None, 0):
        assert_same(J_RANGE(js, jnp.asarray(los), jnp.asarray(his),
                            max_out=16, as_of_batch=as_of),
                    tdsl.range_query(ts, _t(los), _t(his), 16,
                                     as_of_batch=as_of), f"range {as_of}")
    assert_same(J_RANGE_DELETE(js, jnp.asarray(los),
                               jnp.asarray(his), jnp.asarray(mask)),
                tdsl.range_delete_batch(ts, _t(los), _t(his), _t(mask)),
                "range_delete")


# ---------------------------------------------------------------------------
# fixed hash table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slots,bucket", [(64, 4), (128, 8), (32, 16)])
def test_fixed_hash_ops(slots, bucket):
    rng = np.random.default_rng(slots + bucket)
    jh = jht.fixed_init(slots, bucket)
    th = tht.fixed_init(slots, bucket, device=DEV)
    assert_same(jh, th, "init")
    ks = rng.integers(1, 2**64 - 2, slots * bucket, dtype=np.uint64)
    for keys, vals, mask in (_batch(rng, ks, 200), _batch(rng, ks, 300)):
        jo = jax.jit(jht.fixed_insert)(jh, jnp.asarray(keys), jnp.asarray(vals),
                              jnp.asarray(mask))
        to = tht.fixed_insert(th, _t(keys), _t(vals), _t(mask))
        assert_same(jo, to, "insert")
        jh, th = jo[0], to[0]
    q = np.concatenate([keys, ks[:50]])
    assert_same(jax.jit(jht.fixed_find_cols)(jh, jnp.asarray(q)),
                tht.fixed_find_cols(th, _t(q)), "find_cols")
    assert_same(jax.jit(jht.fixed_find)(jh, jnp.asarray(q)),
                tht.fixed_find(th, _t(q)), "find")
    # deletes include in-batch duplicates and misses whose col is 0 next to
    # a genuine column-0 hit (the column-0 aliasing case)
    stored = np.asarray(jh.keys)
    col0 = stored[:, 0][stored[:, 0] != np.uint64(2**64 - 1)][:4]
    dk = np.concatenate([col0, col0[:2], keys[:40],
                         rng.integers(0, 2**64 - 1, 20, dtype=np.uint64)])
    dmask = rng.random(dk.shape[0]) > 0.1
    jo = jax.jit(jht.fixed_delete)(jh, jnp.asarray(dk), jnp.asarray(dmask))
    to = tht.fixed_delete(th, _t(dk), _t(dmask))
    assert_same(jo, to, "delete")
