"""The port's block-major B-skiplist against the JAX reference, bit for bit
(tolerance 0): the `bskiplist_layout` rows, `find_batch_blocked`, the
bskiplist_walk kernel's plain version (against the Pallas kernel in
interpret mode), the block branch of the fused tier kernels' plain
versions in every policy with and without spill, and the `tiered3/b128`
stack against the reference backend's direct `apply` (results and every
state leaf), against `tiered3` and against its unfused twin in the port.
Capacities 64, 128, 300 (a ragged last block) and 8,192, as the
reference's own tests use. Plus a guard that the ctypes signatures of the
CUDA launchers match their C prototypes.
"""
import functools
import pathlib
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro  # noqa: F401  (enables x64)
from repro.core import det_skiplist as jdsl
from repro.core import layout as jlay
from repro.kernels.bskiplist_walk.kernel import bskiplist_walk_tiles as j_bw_tiles
from repro.kernels.bskiplist_walk.ops import bskiplist_find as j_bw_find
from repro.kernels.bskiplist_walk.ref import bskiplist_walk_ref as j_bw_ref
from repro.kernels.tier_apply import ref as j_ta_ref
from repro.kernels.tier_apply.kernel import tier_apply_tiles as j_ta_tiles
from repro.kernels.tier_find import ref as j_tf_ref
from repro.kernels.tier_find.kernel import tier_find_tiles as j_tf_tiles
from repro.store import exec as j_exec
from repro.store import get_backend as j_backend
from repro.store import make_plan as j_plan
from repro.store.tiers import unfused_twin as j_unfused
from repro_torch.convert import state_from_numpy, state_to_numpy, tree_leaves
from repro_torch.core import det_skiplist as tdsl
from repro_torch.core.bits import KEY_INF, from_u64
from repro_torch.core.layout import (bskip_num_levels, bskiplist_layout,
                                     hash_slot, spill_layout, warm_layout_of)
from repro_torch.kernels import cuda
from repro_torch.kernels.bskiplist_walk.ops import bskiplist_find
from repro_torch.kernels.bskiplist_walk.ref import bskiplist_walk_ref
from repro_torch.kernels.tier_apply import ref as t_ta_ref
from repro_torch.kernels.tier_apply.ops import sorted_lanes, tier_apply_fused
from repro_torch.kernels.tier_find import ref as t_tf_ref
from repro_torch.kernels.tier_find.ops import tier_find_fused
from repro_torch.store import exec as t_exec
from repro_torch.store import get_backend as t_backend
from repro_torch.store import make_plan as t_plan
from repro_torch.store.tiers import unfused_twin as t_unfused

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEV = "cpu"
CAPS = [64, 128, 300, 1 << 13]
# (policy, eviction cap): lru runs with a cap of 1 so the cap bites
POLICY_OF = {"hash+skiplist": ("none", 8), "tiered3": ("none", 8),
             "tiered3/lru": ("lru", 1), "tiered3/size": ("size", 8)}
WIDTH = 64
OP_NONE, OP_FIND, OP_INSERT, OP_DELETE, OP_RANGE_DELETE = -1, 0, 1, 2, 6

# the reference runs jitted (one compile per shape)
J_BLOCKED = jax.jit(jdsl.find_batch_blocked)
J_BW_TILES = jax.jit(j_bw_tiles, static_argnames=("tile", "interpret"))
J_TF_TILES = jax.jit(j_tf_tiles, static_argnames=("tile", "interpret"))
J_TA_TILES = jax.jit(j_ta_tiles, static_argnames=("policy", "spill_chunk",
                                                  "interpret"))
J_TF_REF = jax.jit(j_tf_ref.tier_find_ref, static_argnames="warm_layout")
J_TA_REF = jax.jit(j_ta_ref.tier_apply_ref,
                   static_argnames=("policy", "warm_layout"))


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


def assert_port_same(a, b, ctx=""):
    """Two port results or states, leaf for leaf."""
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb), ctx
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and torch.equal(x, y), (ctx, i)


def _split(t: torch.Tensor):
    """int64 tensor -> the reference kernels' (hi, lo) u32 planes."""
    u = t.numpy().view(np.uint64)
    return (jnp.asarray((u >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((u & np.uint64(0xFFFFFFFF)).astype(np.uint32)))


def to_jax_skiplist(ts):
    """A port skiplist as the reference's `DetSkiplist` (the port's batch
    functions match the reference's leaf for leaf: tests/test_torch_core.py),
    so a state is built once, without a reference compile per shape."""
    return jdsl.DetSkiplist(*[
        tuple(map(jnp.asarray, v)) if isinstance(v, tuple) else jnp.asarray(v)
        for v in state_to_numpy(ts)])


@functools.lru_cache(maxsize=None)
def _skiplist(cap, seed=0):
    """A skiplist 7/8 full with a fifth of its keys tombstoned, in both
    packages."""
    rng = np.random.default_rng(seed)
    n = cap - cap // 8
    ks = np.unique(rng.integers(1, 2**64 - 2, 2 * cap, dtype=np.uint64))
    ks = rng.permutation(ks)[:n]
    tk = from_u64(ks, DEV)
    ts = tdsl.skiplist_init(cap, device=DEV)
    ts, _, _ = tdsl.insert_batch(ts, tk, tk + 3)
    ts, _ = tdsl.delete_batch(ts, tk[: n // 5])
    return to_jax_skiplist(ts), ts, ks


def _queries(rng, ks, width=96):
    """Stored, tombstoned and fresh keys, the boundary keys, a duplicate."""
    fresh = rng.integers(0, 2**64 - 1, width, dtype=np.uint64)
    q = np.where(rng.random(width) < 0.6, rng.choice(ks, width), fresh)
    q[:4] = [0, 2**63, 2**64 - 2, 2**64 - 1]
    q[width - 3] = q[5]
    return q


# ---------------------------------------------------------------------------
# layout, find_batch_blocked, the walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", CAPS)
def test_bskiplist_layout_rows_match(cap):
    js, ts, _ = _skiplist(cap)
    jl = jlay.bskiplist_layout(js)
    tl = bskiplist_layout(ts)
    assert tl.num_levels == jl.num_levels == bskip_num_levels(cap)
    assert tl.n_pad == jl.term_hi.shape[0]
    hi, lo = _split(tl.blk)
    assert np.array_equal(np.asarray(jl.blk_hi), np.asarray(hi))
    assert np.array_equal(np.asarray(jl.blk_lo), np.asarray(lo))
    # the port reads its own [C] planes; past C the reference's padding
    pad = tl.n_pad - cap
    th, tlo = _split(torch.cat([tl.term_keys,
                                torch.full((pad,), KEY_INF)]))
    assert np.array_equal(np.asarray(jl.term_hi), np.asarray(th))
    assert np.array_equal(np.asarray(jl.term_lo), np.asarray(tlo))
    assert np.array_equal(np.asarray(jl.term_mark),
                          np.pad(_np(tl.term_mark), (0, pad)))
    for c in (1, 127, 128, 129, 1 << 14, (1 << 14) + 1, 1 << 23, 1 << 24):
        assert bskip_num_levels(c) == jlay.bskip_num_levels(c), c


@pytest.mark.parametrize("cap", CAPS)
def test_find_batch_blocked_matches(cap):
    js, ts, ks = _skiplist(cap)
    q = _queries(np.random.default_rng(cap), ks)
    tq = from_u64(q, DEV)
    got = tdsl.find_batch_blocked(ts, tq)
    assert_same(J_BLOCKED(js, jnp.asarray(q)), got, cap)
    level = tdsl.find_batch(ts, tq)
    assert torch.equal(got[0], level[0]) and torch.equal(got[1], level[1])
    assert got[0].any() and not got[0].all() and not got[0][3]


def test_bskiplist_walk_ref_matches_pallas():
    cap = 300                                      # a ragged last block
    js, ts, ks = _skiplist(cap, seed=3)
    q = _queries(np.random.default_rng(5), ks, width=128)
    tq = from_u64(q, DEV)
    jl = jlay.bskiplist_layout(js)
    qh, ql = _split(tq)
    planes = (jl.blk_hi, jl.blk_lo, jl.term_hi, jl.term_lo, jl.term_mark)
    got = bskiplist_walk_ref(tq, bskiplist_layout(ts))
    assert_same(J_BW_TILES(qh, ql, *planes, tile=len(q), interpret=True),
                got, "tiles")
    jf, ji = j_bw_ref(qh, ql, *planes)
    assert_same((jf.astype(jnp.int8), ji), got, "ref")
    assert got[0][3] == 1                          # raw: KEY_INF padding
    assert_same(j_bw_find(js, jnp.asarray(q), tile=len(q), interpret=True),
                bskiplist_find(ts, tq), "ops")
    with j_exec.exec_mode("jnp"):
        ref = j_exec.bskiplist_find(js, jnp.asarray(q))
    assert_same(ref, t_exec.bskiplist_find(ts, tq, mode="torch"), "exec")


# ---------------------------------------------------------------------------
# the block branch of the fused tier kernels
# ---------------------------------------------------------------------------

CAP_B128 = 160                                         # 2 warm blocks


@functools.lru_cache(maxsize=None)
def _j_step(name):
    return jax.jit(j_backend(name).apply)


@functools.lru_cache(maxsize=None)
def _loaded_tiers(seed=7, n=384):
    """A reference tiered3/b128 state with all three tiers populated, a
    warm tier longer than one 128-key block, and a random policy plane
    (the planes are data to the kernels, whatever the policy)."""
    st = j_backend("tiered3/b128").init(CAP_B128, hot_bucket=4)
    rng = np.random.default_rng(seed)
    ks = np.unique(rng.integers(1, 2**64 - 2, n + 20, dtype=np.uint64))[:n]
    for chunk in np.split(ks, n // (2 * WIDTH)):
        st, _ = _j_step("tiered3/b128")(st, j_plan(
            np.full(len(chunk), OP_INSERT, np.int32), chunk, chunk + 1))
    meta = rng.integers(0, 8, st.hot_meta.shape, dtype=np.int32)
    return st._replace(hot_meta=jnp.asarray(meta)), ks


def _loaded(name):
    st, ks = _loaded_tiers()
    if name == "hash+skiplist":
        st = st._replace(spill=None)
    return st, state_from_numpy(name, jax.tree.map(np.asarray, st), DEV), ks


def _block_planes(js):
    jl = jlay.bskiplist_layout(js.cold)
    return [jl.blk_hi, jl.blk_lo, None, jl.term_hi, jl.term_lo, jl.term_mark]


@pytest.mark.parametrize("name", ["hash+skiplist", "tiered3"])
def test_tier_find_block_branch_matches(name):
    """The state-level reference and the glue against the reference's
    `tier_find_ref(warm_layout="block")`; the plane-level plain version
    against the Pallas kernel in interpret mode at one size (with spill)."""
    js, ts, ks = _loaded(name)
    assert int(js.cold.n_term) > 128
    q = _queries(np.random.default_rng(11), ks)
    tq = from_u64(q, DEV)
    jref = J_TF_REF(js.hot, js.cold, js.spill, jnp.asarray(q),
                    warm_layout="block")
    ref = t_tf_ref.tier_find_ref(ts.hot, ts.cold, ts.spill, tq, "block")
    assert_same(jref, ref, "ref")
    blocked = tier_find_fused(ts.hot, ts.cold, ts.spill, tq,
                              warm_layout_of(ts.cold, "block"))
    assert_same(jref, blocked, "ops")
    slots = hash_slot(tq, ts.hot.num_slots)
    t_sp = None
    if ts.spill is not None:
        t_sp = spill_layout(ts.spill.keys, ts.spill.dead, ts.spill.run_start,
                            ts.spill.n)
    got = t_tf_ref.tier_find_planes_ref(tq, slots, ts.hot.keys,
                                        warm_layout_of(ts.cold, "block"),
                                        t_sp)
    if js.spill is not None:
        qh, ql = _split(tq)
        kh, kl = jlay.split_u64(js.hot.keys)
        jsp = jlay.spill_layout(js.spill.keys, js.spill.dead,
                                js.spill.run_start, js.spill.n)
        args = ([qh, ql, jnp.asarray(slots.numpy()), kh, kl]
                + _block_planes(js)
                + [jsp.key_hi, jsp.key_lo, jsp.dead, jsp.run_off])
        assert_same(J_TF_TILES(*args, tile=len(q), interpret=True), got,
                    "tiles")
    # the same found / vals as the level-major walk
    assert_port_same(tier_find_fused(ts.hot, ts.cold, ts.spill, tq,
                                     warm_layout_of(ts.cold, "level")),
                     blocked, "block == level")
    assert ref[1][0].any()                         # some warm hits
    assert js.spill is None or ref[2][0].any()


def _apply_batch(rng, ks, width=48):
    fresh = rng.integers(2**62, 2**64 - 2, width, dtype=np.uint64)
    keys = np.where(rng.random(width) < 0.5, rng.choice(ks, width), fresh)
    keys[width - 3] = keys[0]
    keys[width - 4] = keys[1]
    mask = rng.random(width) > 0.1
    vals = rng.integers(1, 2**64 - 1, width, dtype=np.uint64)
    return keys, vals, mask


@pytest.mark.parametrize("name", list(POLICY_OF))
def test_tier_apply_block_branch_matches(name):
    """As tier_find: the state-level reference and the glue in every
    policy, with and without spill; the plane-level plain version against
    the Pallas kernel in interpret mode at one size (lru, spill), and
    against the level-major plain version everywhere."""
    policy, max_evict = POLICY_OF[name]
    js, ts, ks = _loaded(name)
    rng = np.random.default_rng(23)
    keys, vals, mask = _apply_batch(rng, ks)
    tk, tv, tm = from_u64(keys, DEV), from_u64(vals, DEV), torch.from_numpy(mask)

    inv, ss, sk, sv, sm, krs, srs = sorted_lanes(ts.hot.num_slots, tk, tv, tm)
    skh, skl = _split(sk)
    kh, kl = jlay.split_u64(js.hot.keys)
    kw, t_sp = {}, None
    if js.spill is not None:
        jsp = jlay.spill_layout(js.spill.keys, js.spill.dead,
                                js.spill.run_start, js.spill.n)
        kw = dict(sp_hi=jsp.key_hi, sp_lo=jsp.key_lo, sp_dead=jsp.dead,
                  run_off=jsp.run_off)
        t_sp = spill_layout(ts.spill.keys, ts.spill.dead, ts.spill.run_start,
                            ts.spill.n)
    me = torch.tensor([max_evict], dtype=torch.int32)
    planes = [sk, ss, sm, krs, srs, ts.hot.keys, ts.hot_meta]
    got = t_ta_ref.tier_apply_planes_ref(
        *planes, warm_layout_of(ts.cold, "block"), me, t_sp, policy)
    if name == "tiered3/lru":
        ref = J_TA_TILES(skh, skl, jnp.asarray(ss.numpy()),
                         jnp.asarray(sm.numpy()), jnp.asarray(krs.numpy()),
                         jnp.asarray(srs.numpy()), kh, kl, js.hot_meta,
                         *_block_planes(js), jnp.asarray(me.numpy()), **kw,
                         policy=policy, spill_chunk=32, interpret=True)
        assert_same(ref, got, "tiles")
    level = t_ta_ref.tier_apply_planes_ref(
        *planes, warm_layout_of(ts.cold, "level"), me, t_sp, policy)
    assert_port_same(level, got, "block == level")
    assert got[0].any()                            # some lane is warm

    args_j = (js.hot, js.hot_meta, js.clock, js.cold, js.spill,
              jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(mask))
    args_t = (ts.hot, ts.hot_meta, ts.clock, ts.cold, ts.spill, tk, tv, tm)
    jref = J_TA_REF(*args_j, policy=policy, max_evict=max_evict,
                    warm_layout="block")
    assert_same(jref, t_ta_ref.tier_apply_ref(*args_t, policy, max_evict,
                                              "block"), "ref")
    assert_same(jref, tier_apply_fused(*args_t, policy, max_evict,
                                       warm_layout_of(ts.cold, "block")),
                "ops")


# ---------------------------------------------------------------------------
# the tiered3/b128 stack
# ---------------------------------------------------------------------------

def _stream(seed, n_plans=6, pool_size=400):
    """Seeded mixed plans over a key pool larger than the warm tier."""
    rng = np.random.default_rng(seed)
    pool = np.unique(rng.integers(1, 2**64 - 2, pool_size, dtype=np.uint64))
    plans = []
    for p in range(n_plans):
        probs = [0.05, 0.2, 0.6, 0.1, 0.05] if p < 3 else \
            [0.05, 0.5, 0.25, 0.15, 0.05]
        ops = rng.choice([OP_NONE, OP_FIND, OP_INSERT, OP_DELETE,
                          OP_RANGE_DELETE], WIDTH * 2, p=probs).astype(np.int32)
        keys = rng.choice(pool, WIDTH * 2)
        keys[-2] = keys[3]                             # in-batch duplicate
        vals = rng.integers(0, 2**64 - 1, WIDTH * 2, dtype=np.uint64)
        rd = ops == OP_RANGE_DELETE                    # vals = hi
        vals[rd] = keys[rd] + rng.integers(0, 2**58, rd.sum(), dtype=np.uint64)
        mask = rng.random(WIDTH * 2) > 0.05
        plans.append((ops, keys, vals, mask))
    return plans


def test_tiered3_b128_stream_matches_reference():
    jb, tb = j_backend("tiered3/b128"), t_backend("tiered3/b128")
    assert tb.name == jb.name == "tiered3/b128" and tb.warm_layout == "block"
    js = jb.init(CAP_B128, hot_bucket=4)
    ts = tb.init(CAP_B128, device=DEV, hot_bucket=4)
    assert_same(js, state_to_numpy(ts), "init")
    with t_exec.exec_mode("torch"):
        for i, plan in enumerate(_stream(1)):
            js, jr = _j_step("tiered3/b128")(js, j_plan(*plan))
            ts, tr = tb.apply(ts, t_plan(*plan, device=DEV))
            assert_same(jr, tr, (i, "results"))
            assert_same(js, state_to_numpy(ts), (i, "state"))
    assert int(js.cold.n_term) > 128 and int(js.spill.n) > 0
    lo = np.array([0, 2**62, 2**63], np.uint64)
    hi = np.array([2**64 - 1, 2**63, 2**64 - 2], np.uint64)
    ref = jax.jit(jb.scan, static_argnames="max_out")(
        js, jnp.asarray(lo), jnp.asarray(hi), max_out=16)
    t_lo, t_hi = t_plan([0] * 3, lo, hi, device=DEV)[1:3]
    assert_same(ref, tb.scan(ts, t_lo, t_hi, 16), "scan")


def test_tiered3_b128_equals_tiered3_and_its_unfused_twin():
    runs = {n: (be, be.init(CAP_B128, device=DEV, hot_bucket=4))
            for n, be in (("b128", t_backend("tiered3/b128")),
                          ("level", t_backend("tiered3")),
                          ("unfused", t_unfused("tiered3/b128")))}
    assert runs["unfused"][0].warm_layout == "block"
    with t_exec.exec_mode("torch"):
        for i, plan in enumerate(_stream(2)):
            out = {}
            for n, (be, st) in runs.items():
                st, res = be.apply(st, t_plan(*plan, device=DEV))
                runs[n] = (be, st)
                out[n] = (res, tree_leaves(st))
            for n in ("level", "unfused"):
                assert_port_same(out[n], out["b128"], (n, i))


def test_tiered3_b128_dispatches_match_reference():
    plan = (np.array([OP_INSERT, OP_FIND, OP_DELETE], np.int32),
            np.array([5, 6, 7], np.uint64))
    for jb, tb in ((j_backend("tiered3/b128"), t_backend("tiered3/b128")),
                   (j_unfused("tiered3/b128"), t_unfused("tiered3/b128"))):
        js = jb.init(32, hot_bucket=4)
        ts = tb.init(32, device=DEV, hot_bucket=4)
        with j_exec.measure_dispatches() as jm:
            jax.make_jaxpr(jb.apply)(js, j_plan(*plan))
        with t_exec.exec_mode("torch"), t_exec.measure_dispatches() as tm:
            tb.apply(ts, t_plan(*plan, device=DEV))
        assert (tm.n, tm.probe, tm.update) == (jm.n, jm.probe, jm.update)


# ---------------------------------------------------------------------------
# guard: the ctypes argtypes of every launcher against its C prototype
# ---------------------------------------------------------------------------

def test_launcher_signatures_match_sources():
    protos = {}
    for src in (ROOT / "src" / "repro_torch" / "kernels" / "csrc").glob("*.cu"):
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            params = [p.strip() for p in m.group(2).split(",")]
            protos[m.group(1)] = [cuda._I if re.fullmatch(r"int \w+", p)
                                  else cuda._P for p in params]
            assert all(re.fullmatch(r"int \w+", p) or "void*" in p
                       for p in params), (m.group(1), params)
    assert protos == cuda._SIGNATURES
    names = {fn.split("_launch")[0] for fn in protos}
    assert set(cuda.KERNELS) <= names | {"tier_apply"}
    assert all((ROOT / "src" / "repro_torch" / "kernels" / "csrc"
                / f"{k}.cu").exists() for k in cuda.KERNELS)
