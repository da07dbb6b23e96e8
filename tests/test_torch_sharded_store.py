"""The port's sharded store engine (`repro_torch.store.engine`) against the
JAX reference's sharded step, exactly (tolerance 0), on the CPU in exec
mode `torch`.

One subprocess on a (2, 4) ("pod", "data") mesh of 8 fake CPU devices runs
every reference case and saves its results as an `.npz`:

* `StoreEngine.step` over det_skiplist, fixed_hash, twolevel_hash,
  splitorder, hash+skiplist, obs:det_skiplist and pq on four seeded
  steps (fresh inserts, a mix on reused keys with idle lanes, keys skewed
  onto one shard, a second mix), at pool_factor 1 (capacity drops) or 2:
  results, ok, `dropped`, every state leaf of every shard through
  `convert.sharded_state_to_numpy`, the metrics plane per shard;
* `range_step` counts: each lane's range counted over all shards. The
  reference gathers the ranges finest-axis-major, so its shard (p, d)
  takes back the counts of shard (d', p') (ROADMAP.md §3); the port's
  counts equal the reference's under that permutation and a host
  `np.searchsorted` over the live keys;
* `core.ordered_sharded`'s step;
* obs:tiered3/lru: the reference's sharded tier stack fails on the
  installed jax (`store/tiers.py:246-248`, a `lax.cond` inside
  `shard_map`), so each shard of the port's engine state is held against
  the reference's `rebuild_shard` from the genesis snapshot over the
  same journal, on plans of distinct keys.

Port-only: the one-shard mesh equals a direct in-place `apply` (today's
single-shard engine), pq pops and idle lanes included.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import torch

from repro_torch.convert import tree_leaves
from repro_torch.core import ordered_sharded
from repro_torch.core.bits import from_u64
from repro_torch.core.routing import ShardMesh
from repro_torch.store import exec as t_exec
from repro_torch.store import get_backend, make_plan
from repro_torch.store.engine import LOCAL_MESH, StoreEngine
from repro_torch.store.resilience.journal import host_leaves

ROOT = Path(__file__).resolve().parents[1]
DEV = "cpu"
AXES = ("pod", "data")
SIZES = (2, 4)
S, LANES = 8, 16
N = S * LANES
CAP = 128
OP_NONE, OP_FIND, OP_INSERT, OP_DELETE = -1, 0, 1, 2
OP_POPMIN, OP_POPK = 4, 5
# backend -> pool_factor
BACKENDS = {"det_skiplist": 1, "fixed_hash": 2, "twolevel_hash": 2,
            "splitorder": 1, "hash+skiplist": 1, "obs:det_skiplist": 1,
            "pq": 1}
TIER = "obs:tiered3/lru"
TIER_CAP, TIER_PF = 32, 4
RANGE_MAX_OUT = 8


def stream(name, seed=0):
    """Four global plans of N lanes: (ops int32, keys u64, vals u64)."""
    rng = np.random.default_rng([seed, len(name)])
    pool = rng.integers(1, 2**64 - 2, 4 * N, dtype=np.uint64)
    plans = []
    for step in range(4):
        keys = pool[step * N:(step + 1) * N].copy()
        if step in (1, 3):
            reuse = rng.random(N) < 0.6
            keys[reuse] = rng.choice(pool[:step * N], int(reuse.sum()))
        if step == 2:                       # skewed onto shard 5
            hot = rng.random(N) < 0.6
            keys[hot] = (np.uint64(5) << np.uint64(61)) | (
                keys[hot] >> np.uint64(3))
        if name == "pq":
            codes = [OP_INSERT, OP_POPMIN, OP_POPK, OP_FIND]
            p = [1.0, 0, 0, 0] if step == 0 else [0.4, 0.25, 0.15, 0.2]
        else:
            codes = [OP_INSERT, OP_FIND, OP_DELETE]
            p = [1.0, 0, 0] if step == 0 else [0.4, 0.45, 0.15]
        ops = rng.choice(codes, N, p=p).astype(np.int32)
        ops[rng.random(N) < (0.0 if step == 0 else 0.1)] = OP_NONE
        plans.append((ops, keys, rng.integers(0, 2**64 - 1, N,
                                              dtype=np.uint64)))
    return plans


def tier_stream():
    """Four plans of distinct keys (inserts, then finds of them), no
    capacity drops at pool_factor 4."""
    rng = np.random.default_rng(11)
    keys = np.unique(rng.integers(1, 2**64 - 2, 3 * N, dtype=np.uint64))
    keys = rng.permutation(keys)[:3 * N]
    plans = []
    for step in range(4):
        if step < 3:
            k = keys[step * N:(step + 1) * N]
            ops = np.full(N, OP_INSERT, np.int32)
        else:
            k = rng.choice(keys, N, replace=False)
            ops = np.full(N, OP_FIND, np.int32)
        plans.append((ops, k, rng.integers(0, 2**64 - 1, N,
                                           dtype=np.uint64)))
    return plans


def range_inputs():
    rng = np.random.default_rng(9)
    keys = rng.integers(1, 2**64 - 2, N, dtype=np.uint64)
    lo = np.sort(rng.integers(0, 2**64 - 1, N, dtype=np.uint64))
    hi = lo + (rng.integers(1, 2**61, N, dtype=np.uint64))
    hi = np.maximum(hi, lo)                 # no wrap past 2^64
    valid = rng.random(N) < 0.7
    return keys, lo, hi, valid


PROG = textwrap.dedent('''
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax, jax.numpy as jnp
    jax.config.update("jax_disable_most_optimizations", True)  # compile time
    import repro
    from repro.core import ordered_sharded
    from repro.store import get_backend
    from repro.store.engine import StoreEngine, sharded_init
    from repro.store.resilience import Journal, rebuild_shard, take_snapshot
    from repro.store.resilience.restore import _make_replayer

    AXES, SIZES, S, LANES = ("pod", "data"), (2, 4), 8, 16
    ins = np.load(sys.argv[1], allow_pickle=False)
    cfg = {k: int(v) for k, v in np.load(sys.argv[2]).items()}
    mesh = jax.make_mesh(SIZES, AXES)
    out = {}

    def plans(name):
        n = len([k for k in ins if k.startswith(name + "/ops")])
        return [tuple(ins[f"{name}/{f}{i}"] for f in ("ops", "keys", "vals"))
                for i in range(n)]

    def run(name, step, state):
        for i, (ops, keys, vals) in enumerate(plans(name)):
            state, res, ok, dr = step(state, *(jax.device_put(
                jnp.asarray(x), eng.sharding) for x in (ops, keys, vals)))
            out[f"{name}/res{i}"] = np.asarray(res)
            out[f"{name}/ok{i}"] = np.asarray(ok)
            out[f"{name}/dropped{i}"] = np.asarray(dr)
        for j, x in enumerate(jax.tree.leaves(state)):
            out[f"{name}/leaf{j}"] = np.asarray(x)
        return state

    for name in sorted({k.split("/")[0] for k in ins} - {"range", "tier",
                                                          "veneer"}):
        eng = StoreEngine(mesh, AXES, LANES, backend=name,
                          pool_factor=cfg["pf/" + name])
        state = jax.device_put(eng.init(cfg["cap"]), eng.sharding)
        state = run(name, eng.step, state)
        if name.startswith("obs:"):     # host copy: see ROADMAP.md §3
            for k, v in eng.metrics(jax.device_get(state)).items():
                out[f"{name}/metric/{k}"] = np.asarray(v)

    # the ordered_sharded veneer on det_skiplist's stream, pool_factor 2
    eng = StoreEngine(mesh, AXES, LANES, backend="det_skiplist")
    vstep = jax.jit(ordered_sharded.make_store_step(mesh, AXES, LANES, 2))
    state = jax.device_put(ordered_sharded.sharded_store_init(8, cfg["cap"]),
                           eng.sharding)
    run("veneer", vstep, state)

    # range step over det_skiplist
    eng = StoreEngine(mesh, AXES, LANES, backend="det_skiplist")
    put = lambda x: jax.device_put(jnp.asarray(x), eng.sharding)
    state = jax.device_put(eng.init(cfg["cap"]), eng.sharding)
    state, _, ok, dr = eng.step(state, put(np.full(S * LANES, 1, np.int32)),
                                put(ins["range/keys"]), put(ins["range/keys"]))
    rstep = eng.range_step(max_out=cfg["max_out"])
    out["range/cnt"] = np.asarray(rstep(state, put(ins["range/lo"]),
                                        put(ins["range/hi"]),
                                        put(ins["range/valid"])))
    out["range/dropped"] = np.asarray(dr)

    # obs:tiered3/lru: rebuild_shard from genesis over the journal
    be = get_backend("obs:tiered3/lru")
    snap = take_snapshot(sharded_init(be, S, cfg["tier_cap"]), 0)
    jr = Journal(0)
    for i, (ops, keys, vals) in enumerate(plans("tier")):
        jr.append(i, ops, keys, vals)
    replayer = _make_replayer(be, "jnp")       # one compile for 8 shards
    for shard in range(S):
        st, n = rebuild_shard(be, snap, jr.entries, shard, S,
                              LANES * cfg["tier_pf"], "jnp", replayer)
        for j, x in enumerate(jax.tree.leaves(st)):
            out[f"tier/{shard}/leaf{j}"] = np.asarray(x)
        out[f"tier/{shard}/replayed"] = np.asarray(n)
    np.savez(sys.argv[3], **out)
''')


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The one reference subprocess: every case on 8 fake devices."""
    tmp = tmp_path_factory.mktemp("sharded")
    ins = {}
    for name in [*BACKENDS, "veneer", "tier"]:
        plans = (tier_stream() if name == "tier" else
                 stream("det_skiplist" if name == "veneer" else name))
        for i, (ops, keys, vals) in enumerate(plans):
            ins.update({f"{name}/ops{i}": ops, f"{name}/keys{i}": keys,
                        f"{name}/vals{i}": vals})
    keys, lo, hi, valid = range_inputs()
    ins.update({"range/keys": keys, "range/lo": lo, "range/hi": hi,
                "range/valid": valid})
    cfg = {f"pf/{k}": v for k, v in BACKENDS.items()}
    cfg.update(cap=CAP, tier_cap=TIER_CAP, tier_pf=TIER_PF,
               max_out=RANGE_MAX_OUT)
    np.savez(tmp / "in.npz", **ins)
    np.savez(tmp / "cfg.npz", **{k: np.asarray(v) for k, v in cfg.items()})
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", PROG, str(tmp / "in.npz"),
                          str(tmp / "cfg.npz"), str(tmp / "ref.npz")],
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return dict(np.load(tmp / "ref.npz"))


def _dev(ops, keys, vals):
    return (torch.from_numpy(ops), from_u64(keys, DEV), from_u64(vals, DEV))


def _mesh():
    return ShardMesh(AXES, SIZES)


def _check_run(ref, label, step, state, plans):
    for i, plan in enumerate(plans):
        state, res, ok, dr = step(state, *_dev(*plan))
        assert np.array_equal(res.numpy().view(np.uint64),
                              ref[f"{label}/res{i}"]), (label, i)
        assert np.array_equal(ok.numpy(), ref[f"{label}/ok{i}"]), (label, i)
        assert int(dr) == int(ref[f"{label}/dropped{i}"]), (label, i)
    leaves = host_leaves(state)
    want = [ref[f"{label}/leaf{j}"] for j in range(len(leaves))]
    assert f"{label}/leaf{len(leaves)}" not in ref
    for j, (a, b) in enumerate(zip(leaves, want)):
        assert a.dtype == b.dtype and np.array_equal(a, b), (label, j)
    return state


@pytest.mark.parametrize("name", list(BACKENDS))
def test_sharded_step_matches_reference(reference, name):
    eng = StoreEngine(_mesh(), AXES, LANES, name, pool_factor=BACKENDS[name],
                      exec_mode="torch", device=DEV)
    state = _check_run(reference, name, eng.step, eng.init(CAP),
                       stream(name))
    drops = [int(reference[f"{name}/dropped{i}"]) for i in range(4)]
    if BACKENDS[name] == 1:
        assert drops[2] > 0                 # the skewed plan overflowed
    assert len(state) == S and eng.seq == 4
    sizes = eng.stats(state)["size"]
    assert sizes.shape == (S,) and sizes.sum() > 0
    if name.startswith("obs:"):
        got = eng.metrics(state)
        assert sorted(got) == sorted(k.split("/")[2] for k in reference
                                     if k.startswith(f"{name}/metric/"))
        for k, v in got.items():
            assert np.array_equal(v, reference[f"{name}/metric/{k}"]), k
        assert got["routed_ops"].sum() > 0


def test_ordered_sharded_veneer(reference):
    mesh = _mesh()
    step = ordered_sharded.make_store_step(mesh, AXES, LANES, pool_factor=2)
    with t_exec.exec_mode("torch"):
        _check_run(reference, "veneer", step,
                   ordered_sharded.sharded_store_init(S, CAP, device=DEV),
                   stream("det_skiplist"))


def test_range_step_counts(reference):
    keys, lo, hi, valid = range_inputs()
    eng = StoreEngine(_mesh(), AXES, LANES, "det_skiplist",
                      exec_mode="torch", device=DEV)
    state, _, ok, dr = eng.step(eng.init(CAP), *_dev(
        np.full(N, OP_INSERT, np.int32), keys, keys))
    assert int(dr) == int(reference["range/dropped"])
    cnt = eng.range_step(RANGE_MAX_OUT)(state, from_u64(lo, DEV),
                                        from_u64(hi, DEV),
                                        torch.from_numpy(valid)).numpy()
    live = np.sort(np.unique(keys[ok.numpy()]))
    want = np.where(valid, np.searchsorted(live, hi)
                    - np.searchsorted(live, lo), 0)
    assert np.array_equal(cnt, want)
    # the reference's lane j reads the range of gathered position j
    perm = np.arange(N).reshape(*SIZES, LANES).transpose(1, 0, 2).reshape(-1)
    assert np.array_equal(reference["range/cnt"], cnt[perm])
    assert not np.array_equal(reference["range/cnt"], cnt)


def test_tiered3_lru_shards_match_reference_rebuild(reference):
    eng = StoreEngine(_mesh(), AXES, LANES, TIER, pool_factor=TIER_PF,
                      exec_mode="torch", device=DEV)
    state = eng.init(TIER_CAP)
    for plan in tier_stream():
        state, _, _, dr = eng.step(state, *_dev(*plan))
        assert int(dr) == 0
    st = eng.stats(state)
    assert st["spill_size"].sum() > 0 and st["evictions"].sum() > 0
    for shard in range(S):
        leaves = host_leaves(state[shard])
        for j, a in enumerate(leaves):
            b = reference[f"tier/{shard}/leaf{j}"]
            assert a.dtype == b.dtype and np.array_equal(a, b), (shard, j)
        assert f"tier/{shard}/leaf{len(leaves)}" not in reference


@pytest.mark.parametrize("name", ["det_skiplist", "pq", "obs:tiered3/lru"])
def test_one_shard_mesh_equals_in_place_apply(name):
    """The one-shard mesh (pool_factor 1) compacts a plan's valid lanes
    to a prefix; its results and state equal the old single-shard
    engine's in-place apply, idle lanes masked in their slots, pop lanes
    included, plus the routed counters an observed state records."""
    eng = StoreEngine(LOCAL_MESH, LOCAL_MESH.axis_names, N, name,
                      pool_factor=1, exec_mode="torch", device=DEV)
    be = get_backend(name)
    se, sd = eng.init(CAP), be.init(CAP, device=DEV)
    plans = stream(name, seed=3)
    for i, (ops, keys, vals) in enumerate(plans):
        se, rv, rok, dr = eng.step(se, *_dev(ops, keys, vals))
        with t_exec.exec_mode("torch"):
            sd, rd = be.apply(sd, make_plan(ops, keys, vals, ops >= 0,
                                            device=DEV))
        live = torch.from_numpy(ops >= 0)
        assert int(dr) == 0
        assert torch.equal(rok, rd.ok & live), (name, i)
        assert torch.equal(rv, torch.where(live, rd.vals, 0)), (name, i)
    a, b = se[0], sd
    if name.startswith("obs:"):
        routed = sum(int((p[0] >= 0).sum()) for p in plans)
        ma, mb = dict(a.metrics), dict(b.metrics)
        assert int(ma.pop("routed_ops")) == routed + int(mb.pop("routed_ops"))
        assert int(ma.pop("routed_bytes")) == (
            routed * 24 + int(mb.pop("routed_bytes")))
        assert all(torch.equal(ma[k], mb[k]) for k in ma)
        a, b = a.inner, b.inner
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    assert all(torch.equal(x, y) if torch.is_tensor(x) else x == y
               for x, y in zip(la, lb)), name
    assert eng.stats(se)["size"][0] == int(be.stats(sd)["size"])
