"""The four kernels' plain PyTorch versions against the JAX Pallas kernels
run in interpret mode, on the same planes, bit for bit (tolerance 0).

For each kernel: the plane-level plain version (`ref.*_ref`, what the
CUDA wrapper runs on CPU tensors) against the reference `*_tiles(...,
interpret=True)`, the state -> layout -> kernel glue (`ops.py`) against
the reference `ops.py`, and the state-level references the `torch` exec
mode runs against the reference's. States are built by the JAX backends
and carried over with `repro_torch.convert`. Spill and no spill, and all
three policies for tier_apply.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro  # noqa: F401  (enables x64)
from repro.core import layout as jlay
from repro.kernels.hash_probe.kernel import hash_probe_tiles as j_hash_tiles
from repro.kernels.hash_probe.ops import fixed_hash_find_cols as j_hash_find
from repro.kernels.skiplist_search.kernel import skiplist_search_tiles as j_sk_tiles
from repro.kernels.skiplist_search.ops import skiplist_find as j_sk_find
from repro.kernels.tier_apply import ref as j_ta_ref
from repro.kernels.tier_apply.kernel import tier_apply_tiles as j_ta_tiles
from repro.kernels.tier_apply.ops import tier_apply_fused as j_ta_fused
from repro.kernels.tier_find import ref as j_tf_ref
from repro.kernels.tier_find.kernel import tier_find_tiles as j_tf_tiles
from repro.kernels.tier_find.ops import tier_find_fused as j_tf_fused
from repro.store import get_backend as j_backend
from repro.store import make_plan as j_plan
from repro_torch.convert import state_from_numpy, tree_leaves
from repro_torch.core.bits import from_u64
from repro_torch.core.layout import hash_slot, skiplist_layout, spill_layout
from repro_torch.kernels.hash_probe.ops import fixed_hash_find_cols
from repro_torch.kernels.hash_probe.ref import hash_probe_ref
from repro_torch.kernels.skiplist_search.ops import skiplist_find
from repro_torch.kernels.skiplist_search.ref import skiplist_search_ref
from repro_torch.kernels.tier_apply import ref as t_ta_ref
from repro_torch.kernels.tier_apply.ops import sorted_lanes, tier_apply_fused
from repro_torch.kernels.tier_find import ref as t_tf_ref
from repro_torch.kernels.tier_find.ops import tier_find_fused

DEV = "cpu"
# (policy, eviction cap): lru runs with a cap of 1 so the cap bites
POLICY_OF = {"hash+skiplist": ("none", 8), "tiered3": ("none", 8),
             "tiered3/lru": ("lru", 1), "tiered3/size": ("size", 8)}

# the reference runs jitted (one compile per shape, not op-by-op dispatch)
J_TA_FUSED = jax.jit(j_ta_fused, static_argnames=("policy", "interpret"))
J_TA_REF = jax.jit(j_ta_ref.tier_apply_ref, static_argnames=("policy",))
J_HOT_EVICT = jax.jit(j_ta_ref.hot_insert_evict, static_argnames=("policy",))
J_TF_FUSED = jax.jit(j_tf_fused, static_argnames=("tile", "interpret"))
J_TF_REF = jax.jit(j_tf_ref.tier_find_ref)
J_SPILL_CELLS = jax.jit(j_tf_ref.spill_run_cells)
J_SK_TILES = jax.jit(j_sk_tiles, static_argnames=("tile", "interpret"))
J_HASH_TILES = jax.jit(j_hash_tiles, static_argnames=("tile", "interpret"))
J_TF_TILES = jax.jit(j_tf_tiles, static_argnames=("tile", "interpret"))
J_TA_TILES = jax.jit(j_ta_tiles, static_argnames=("policy", "spill_chunk",
                                                  "interpret"))


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


def _split(t: torch.Tensor):
    """int64 tensor -> the reference kernels' (hi, lo) u32 planes."""
    u = t.numpy().view(np.uint64)
    return (jnp.asarray((u >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((u & np.uint64(0xFFFFFFFF)).astype(np.uint32)))


@functools.lru_cache(maxsize=None)
def _loaded_lru(seed=7, capacity=32, n=100):
    """A reference tiered3/lru state with all three tiers populated."""
    be = j_backend("tiered3/lru")
    st = be.init(capacity, hot_bucket=4)
    rng = np.random.default_rng(seed)
    ks = np.unique(rng.integers(1, 2**64 - 2, n + 20, dtype=np.uint64))[:n]
    step = jax.jit(be.apply)
    for chunk in np.array_split(ks, 3):
        st, _ = step(st, j_plan(np.full(len(chunk), 1, np.int32), chunk,
                                chunk + 1))
    return st, ks


def _loaded(name):
    """Kernel inputs for a tier stack and their port copy: one loaded state
    serves every policy (the planes are data to the kernels); depth 2
    drops the spill tier."""
    st, ks = _loaded_lru()
    if name == "hash+skiplist":
        st = st._replace(spill=None)
    return st, state_from_numpy(name, jax.tree.map(np.asarray, st), DEV), ks


def _queries(rng, ks, width=64):
    fresh = rng.integers(0, 2**64 - 1, width, dtype=np.uint64)
    q = np.where(rng.random(width) < 0.6, rng.choice(ks, width), fresh)
    q[:3] = [0, 2**63, 2**64 - 1]
    q[width - 3] = q[5]
    return q


# ---------------------------------------------------------------------------
# skiplist_search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap,n,t", [(256, 100, 128), (1024, 700, 256)])
def test_skiplist_search_ref_matches_pallas(cap, n, t):
    rng = np.random.default_rng(cap)
    be = j_backend("det_skiplist")
    js = be.init(cap)
    ks = rng.integers(1, 2**64 - 2, n, dtype=np.uint64)
    js, _ = jax.jit(be.apply)(js, j_plan(np.full(n, 1, np.int32), ks, ks + 3))
    js, _ = jax.jit(be.apply)(js, j_plan(np.full(n // 5, 2, np.int32),
                                         ks[:n // 5]))
    ts = state_from_numpy("det_skiplist", jax.tree.map(np.asarray, js), DEV)
    q = _queries(rng, ks, t)
    tq = from_u64(q, DEV)
    rect = jlay.skiplist_layout(js)
    qh, ql = _split(tq)
    th, tl = jlay.split_u64(js.term_keys)
    ref = J_SK_TILES(qh, ql, rect.lvl_hi, rect.lvl_lo, rect.lvl_child, th, tl,
                     rect.term_mark, tile=t, interpret=True)
    assert_same(ref, skiplist_search_ref(tq, skiplist_layout(ts)), "tiles")
    assert_same(j_sk_find(js, jnp.asarray(q), tile=t, interpret=True),
                skiplist_find(ts, tq), "ops")


# ---------------------------------------------------------------------------
# hash_probe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slots,bucket", [(64, 8), (128, 16)])
def test_hash_probe_ref_matches_pallas(slots, bucket):
    rng = np.random.default_rng(slots)
    be = j_backend("fixed_hash")
    js = be.init(slots * bucket, bucket=bucket)
    ks = rng.integers(1, 2**64 - 2, slots * bucket, dtype=np.uint64)
    js, _ = jax.jit(be.apply)(js, j_plan(np.full(len(ks), 1, np.int32), ks,
                                         ks + 1))
    ts = state_from_numpy("fixed_hash", jax.tree.map(np.asarray, js), DEV)
    q = _queries(rng, ks, 128)
    tq = from_u64(q, DEV)
    slots_t = hash_slot(tq, ts.num_slots)
    kh, kl = jlay.split_u64(js.keys)
    qh, ql = _split(tq)
    ref = J_HASH_TILES(qh, ql, jnp.asarray(slots_t.numpy()), kh, kl,
                       tile=128, interpret=True)
    assert_same(ref, hash_probe_ref(tq, slots_t, ts.keys), "tiles")
    assert_same(j_hash_find(js, jnp.asarray(q), tile=128, interpret=True),
                fixed_hash_find_cols(ts, tq), "ops")


# ---------------------------------------------------------------------------
# tier_find
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["hash+skiplist", "tiered3"])
def test_tier_find_ref_matches_pallas(name):
    js, ts, ks = _loaded(name)
    rng = np.random.default_rng(11)
    q = _queries(rng, ks)
    tq = from_u64(q, DEV)
    slots_t = hash_slot(tq, ts.hot.num_slots)
    qh, ql = _split(tq)
    kh, kl = jlay.split_u64(js.hot.keys)
    rect = jlay.skiplist_layout(js.cold)
    th, tl = jlay.split_u64(js.cold.term_keys)
    args = [qh, ql, jnp.asarray(slots_t.numpy()), kh, kl, rect.lvl_hi,
            rect.lvl_lo, rect.lvl_child, th, tl, rect.term_mark]
    t_sp = None
    if js.spill is not None:
        jsp = jlay.spill_layout(js.spill.keys, js.spill.dead,
                                js.spill.run_start, js.spill.n)
        args += [jsp.key_hi, jsp.key_lo, jsp.dead, jsp.run_off]
        t_sp = spill_layout(ts.spill.keys, ts.spill.dead, ts.spill.run_start,
                            ts.spill.n)
        assert int(js.spill.n) > 0
    ref = J_TF_TILES(*args, tile=len(q), interpret=True)
    got = t_tf_ref.tier_find_planes_ref(tq, slots_t, ts.hot.keys,
                                        skiplist_layout(ts.cold), t_sp)
    assert_same(ref, got, "tiles")
    assert_same(J_TF_FUSED(js.hot, js.cold, js.spill, jnp.asarray(q),
                           tile=len(q), interpret=True),
                tier_find_fused(ts.hot, ts.cold, ts.spill, tq,
                                skiplist_layout(ts.cold)), "ops")
    assert_same(J_TF_REF(js.hot, js.cold, js.spill, jnp.asarray(q)),
                t_tf_ref.tier_find_ref(ts.hot, ts.cold, ts.spill, tq), "ref")
    if js.spill is not None:
        sp = js.spill
        assert_same(J_SPILL_CELLS(sp.keys, sp.dead, sp.run_start, sp.n,
                                  jnp.asarray(q)),
                    t_tf_ref.spill_run_cells(ts.spill.keys, ts.spill.dead,
                                             ts.spill.run_start, ts.spill.n,
                                             tq), "spill_run_cells")


# ---------------------------------------------------------------------------
# tier_apply
# ---------------------------------------------------------------------------

def _apply_batch(rng, ks, width=48):
    fresh = rng.integers(2**62, 2**64 - 2, width, dtype=np.uint64)
    keys = np.where(rng.random(width) < 0.5, rng.choice(ks, width), fresh)
    keys[width - 3] = keys[0]
    keys[width - 4] = keys[1]
    mask = rng.random(width) > 0.1
    vals = rng.integers(1, 2**64 - 1, width, dtype=np.uint64)
    return keys, vals, mask


@pytest.mark.parametrize("name", list(POLICY_OF))
def test_tier_apply_ref_matches_pallas(name):
    policy, max_evict = POLICY_OF[name]
    js, ts, ks = _loaded(name)
    rng = np.random.default_rng(23)
    keys, vals, mask = _apply_batch(rng, ks)
    tk, tv, tm = from_u64(keys, DEV), from_u64(vals, DEV), torch.from_numpy(mask)

    # plane level: the same sorted lanes into both kernels
    inv, ss, sk, sv, sm, krs, srs = sorted_lanes(ts.hot.num_slots, tk, tv, tm)
    skh, skl = _split(sk)
    kh, kl = jlay.split_u64(js.hot.keys)
    rect = jlay.skiplist_layout(js.cold)
    th, tl = jlay.split_u64(js.cold.term_keys)
    kw, t_sp = {}, None
    if js.spill is not None:
        jsp = jlay.spill_layout(js.spill.keys, js.spill.dead,
                                js.spill.run_start, js.spill.n)
        kw = dict(sp_hi=jsp.key_hi, sp_lo=jsp.key_lo, sp_dead=jsp.dead,
                  run_off=jsp.run_off)
        t_sp = spill_layout(ts.spill.keys, ts.spill.dead, ts.spill.run_start,
                            ts.spill.n)
    me = torch.tensor([max_evict], dtype=torch.int32)
    ref = J_TA_TILES(skh, skl, jnp.asarray(ss.numpy()),
                     jnp.asarray(sm.numpy()), jnp.asarray(krs.numpy()),
                     jnp.asarray(srs.numpy()), kh, kl, js.hot_meta,
                     rect.lvl_hi, rect.lvl_lo, rect.lvl_child, th, tl,
                     rect.term_mark, jnp.asarray(me.numpy()), **kw,
                     policy=policy, spill_chunk=32, interpret=True)
    got = t_ta_ref.tier_apply_planes_ref(sk, ss, sm, krs, srs, ts.hot.keys,
                                         ts.hot_meta, skiplist_layout(ts.cold),
                                         me, t_sp, policy)
    assert_same(ref, got, "tiles")
    if policy != "none":
        assert np.asarray(ref[5]).any()             # some lane evicts

    # glue and the state-level references
    args_j = (js.hot, js.hot_meta, js.clock, js.cold, js.spill,
              jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(mask))
    args_t = (ts.hot, ts.hot_meta, ts.clock, ts.cold, ts.spill, tk, tv, tm)
    assert_same(J_TA_FUSED(*args_j, policy=policy, max_evict=max_evict,
                           interpret=True),
                tier_apply_fused(*args_t, policy, max_evict,
                                 skiplist_layout(ts.cold)), "ops")
    assert_same(J_TA_REF(*args_j, policy=policy, max_evict=max_evict),
                t_ta_ref.tier_apply_ref(*args_t, policy, max_evict), "ref")
    if policy != "none":
        assert_same(J_HOT_EVICT(js.hot, js.hot_meta, js.clock,
                                jnp.asarray(keys), jnp.asarray(vals),
                                jnp.asarray(mask), policy=policy,
                                max_evict=max_evict),
                    t_ta_ref.hot_insert_evict(ts.hot, ts.hot_meta, ts.clock,
                                              tk, tv, tm, policy, max_evict),
                    "hot_insert_evict")


def test_tier_apply_empty_batch():
    js, ts, _ = _loaded("tiered3")
    z = torch.zeros(0, dtype=torch.int64)
    out = tier_apply_fused(ts.hot, ts.hot_meta, ts.clock, ts.cold, ts.spill,
                           z, z, torch.zeros(0, dtype=torch.bool), "lru", 8,
                           skiplist_layout(ts.cold))
    assert all(a.shape == (0,) for a in out[2:])
    assert out[0] is ts.hot and out[1] is ts.hot_meta
