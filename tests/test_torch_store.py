"""The port's Store API end to end against the JAX reference.

* `apply` parity per plan against the reference backends' direct
  `jax.jit(be.apply)` over a seeded mixed stream (FIND / INSERT / DELETE /
  RANGE_DELETE / idle lanes, masked lanes, in-batch duplicates, warm-tier
  overflow into the spill runs), results and every state leaf, then the
  ordered `scan`; for det_skiplist, fixed_hash, hash+skiplist, tiered3,
  tiered3/lru and tiered3/size. Tolerance 0.
* fused tier stacks against their `unfused_twin` in the port;
* dispatches per apply equal to the reference's `measure_dispatches`;
* the single-shard `StoreEngine` against direct apply;
* a state built in JAX and continued in the port;
* guards: no jax / repro import in the port, CUDA entry points refuse a
  machine without a card, `gpu` exec mode refuses CPU tensors.

The reference's `StoreEngine` cannot run the depth-3 stacks on the
installed jax (see ROADMAP.md, Faults), so the ground truth is its direct
apply.
"""
import ast
import functools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro  # noqa: F401  (enables x64)
from repro.configs import paper_kvstore as j_cfg
from repro.store import exec as j_exec
from repro.store import obs as j_obs
from repro.store import get_backend as j_backend
from repro.store import make_plan as j_plan
from repro.store.tiers import unfused_twin as j_unfused
from repro_torch.configs import paper_kvstore as t_cfg
from repro_torch.convert import state_from_numpy, state_to_numpy, tree_leaves
from repro_torch.store import exec as t_exec
from repro_torch.store import get_backend as t_backend
from repro_torch.store import make_plan as t_plan
from repro_torch.store import obs as t_obs
from repro_torch.store.engine import (LOCAL_MESH, StoreEngine,
                                      local_store_engine)
from repro_torch.store.tiers import unfused_twin as t_unfused

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEV = "cpu"
BACKENDS = ["det_skiplist", "fixed_hash", "hash+skiplist", "tiered3",
            "tiered3/lru", "tiered3/size"]
TIERED = BACKENDS[2:]
CAP = 64
WIDTH = 64
OP_NONE, OP_FIND, OP_INSERT, OP_DELETE, OP_RANGE_DELETE = -1, 0, 1, 2, 6


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


def _init_kw(name):
    return {} if name in ("det_skiplist", "fixed_hash") else {"hot_bucket": 4}


@functools.lru_cache(maxsize=None)
def _j_step(name):
    return jax.jit(j_backend(name).apply)


def _stream(seed, n_plans=6):
    """Seeded mixed plans over a key pool larger than the warm tier."""
    rng = np.random.default_rng(seed)
    pool = np.unique(rng.integers(1, 2**64 - 2, 260, dtype=np.uint64))
    plans = []
    for p in range(n_plans):
        probs = [0.05, 0.3, 0.5, 0.1, 0.05] if p < 3 else \
            [0.05, 0.5, 0.25, 0.15, 0.05]
        ops = rng.choice([OP_NONE, OP_FIND, OP_INSERT, OP_DELETE,
                          OP_RANGE_DELETE], WIDTH, p=probs).astype(np.int32)
        keys = rng.choice(pool, WIDTH)
        keys[WIDTH - 2] = keys[3]                       # in-batch duplicate
        vals = rng.integers(0, 2**64 - 1, WIDTH, dtype=np.uint64)
        rd = ops == OP_RANGE_DELETE                     # vals = hi
        vals[rd] = keys[rd] + rng.integers(0, 2**58, rd.sum(), dtype=np.uint64)
        mask = rng.random(WIDTH) > 0.05
        plans.append((ops, keys, vals, mask))
    return plans


def _scan_bounds(seed):
    rng = np.random.default_rng(seed + 100)
    lo = rng.integers(0, 2**64 - 1, 8, dtype=np.uint64)
    hi = lo + rng.integers(0, 2**62, 8, dtype=np.uint64)
    hi[0], lo[1] = np.uint64(2**64 - 1), np.uint64(0)
    return lo, hi


@pytest.mark.parametrize("name", BACKENDS)
def test_apply_parity_with_reference(name):
    jb, tb = j_backend(name), t_backend(name)
    js = jb.init(CAP, **_init_kw(name))
    ts = tb.init(CAP, device=DEV, **_init_kw(name))
    assert_same(js, state_to_numpy(ts), (name, "init"))
    with t_exec.exec_mode("torch"):
        for i, (ops, keys, vals, mask) in enumerate(_stream(1)):
            js, jr = _j_step(name)(js, j_plan(ops, keys, vals, mask))
            ts, tr = tb.apply(ts, t_plan(ops, keys, vals, mask, device=DEV))
            assert_same(jr, tr, (name, i, "results"))
            assert_same(js, state_to_numpy(ts), (name, i, "state"))
    if name in TIERED:
        assert int(js.cold.n_term) > 0
        if js.spill is not None:
            assert int(js.spill.n) > 0                 # spill runs are live
    if jb.ordered:
        lo, hi = _scan_bounds(1)
        ref = jax.jit(jb.scan, static_argnames="max_out")(
            js, jnp.asarray(lo), jnp.asarray(hi), max_out=12)
        t_lo, t_hi = t_plan([0] * 8, lo, hi, device=DEV)[1:3]
        assert_same(ref, tb.scan(ts, t_lo, t_hi, 12), (name, "scan"))


@pytest.mark.parametrize("name", TIERED)
def test_fused_matches_unfused_twin(name):
    fused, unfused = t_backend(name), t_unfused(name)
    sf = fused.init(CAP, device=DEV, hot_bucket=4)
    su = unfused.init(CAP, device=DEV, hot_bucket=4)
    with t_exec.exec_mode("torch"):
        for i, plan in enumerate(_stream(2)):
            plan = t_plan(*plan, device=DEV)
            sf, rf = fused.apply(sf, plan)
            su, ru = unfused.apply(su, plan)
            assert torch.equal(rf.ok, ru.ok) and torch.equal(rf.vals, ru.vals)
            for a, b in zip(tree_leaves(sf), tree_leaves(su)):
                assert torch.equal(a, b), (name, i)


@pytest.mark.parametrize("name", BACKENDS)
def test_dispatches_per_apply_match_reference(name):
    plan = (np.array([OP_INSERT, OP_FIND, OP_DELETE], np.int32),
            np.array([5, 6, 7], np.uint64))
    pairs = [(j_backend(name), t_backend(name))]
    if name in TIERED:
        pairs.append((j_unfused(name), t_unfused(name)))
    for jb, tb in pairs:
        js = jb.init(32, **_init_kw(name))
        ts = tb.init(32, device=DEV, **_init_kw(name))
        with j_exec.measure_dispatches() as jm:
            jax.make_jaxpr(jb.apply)(js, j_plan(*plan))
        with t_exec.exec_mode("torch"), t_exec.measure_dispatches() as tm:
            tb.apply(ts, t_plan(*plan, device=DEV))
        assert (tm.n, tm.probe, tm.update) == (jm.n, jm.probe, jm.update), \
            (name, tb.name)
    if name in TIERED:
        assert (tm.n, tm.probe, tm.update)[0] >= 4
        with t_exec.exec_mode("torch"), t_exec.measure_dispatches() as tm:
            t_backend(name).apply(ts, t_plan(*plan, device=DEV))
        assert (tm.n, tm.probe, tm.update) == (2, 1, 1)


@pytest.mark.parametrize("name", ["det_skiplist", "tiered3/lru"])
def test_engine_matches_direct_apply(name):
    eng = StoreEngine(LOCAL_MESH, LOCAL_MESH.axis_names, WIDTH, name,
                      pool_factor=1, device=DEV, exec_mode="torch")
    be = t_backend(name)
    se = eng.init(CAP, **_init_kw(name))
    sd = be.init(CAP, device=DEV, **_init_kw(name))
    for i, (ops, keys, vals, mask) in enumerate(_stream(3)):
        ops = np.where(mask, ops, OP_NONE).astype(np.int32)
        p = t_plan(ops, keys, vals, device=DEV)
        se, res_v, res_ok, dropped = eng.step(se, p.ops, p.keys, p.vals)
        with t_exec.exec_mode("torch"):
            sd, rd = be.apply(sd, t_plan(ops, keys, vals, ops >= 0,
                                         device=DEV))
        assert dropped == 0
        assert torch.equal(res_ok, rd.ok) and torch.equal(res_v, rd.vals)
        assert not res_ok[p.ops < 0].any()
        for a, b in zip(tree_leaves(se), tree_leaves(sd)):
            assert torch.equal(a, b), (name, i)
    st = eng.stats(se)
    assert st["seq"] == 6 and int(st["size"][0]) == int(be.stats(sd)["size"])


@pytest.mark.parametrize("name", ["fixed_hash", "tiered3", "tiered3/lru"])
def test_metrics_records_match_reference(name):
    """The backends `record` the same counters at the same points: one
    collection frame around each apply, compared name by name."""
    jb, tb = j_backend(name), t_backend(name)

    def j_apply(st, plan):
        with j_obs.collect() as frame:
            st, res = jb.apply(st, plan)
        return st, res, dict(frame.acc)

    j_step = jax.jit(j_apply)
    js = jb.init(CAP, **_init_kw(name))
    ts = tb.init(CAP, device=DEV, **_init_kw(name))
    seen = set()
    with t_exec.exec_mode("torch"):
        for i, plan in enumerate(_stream(5)):
            js, _, j_acc = j_step(js, j_plan(*plan))
            with t_obs.collect() as frame:
                ts, _ = tb.apply(ts, t_plan(*plan, device=DEV))
            assert sorted(j_acc) == sorted(frame.acc), (name, i)
            for k, v in j_acc.items():
                assert int(v) == int(frame.acc[k]), (name, i, k)
                if int(v):
                    seen.add(k)
    assert "bucket_collisions" in seen
    if name != "fixed_hash":
        assert {"demotions", "spill_appends", "warm_probe_steps"} <= seen


def test_tracing_spans_and_local_engine():
    eng = local_store_engine("tiered3/lru", WIDTH, "torch", "cpu")
    assert eng is local_store_engine("tiered3/lru", WIDTH, "torch", "cpu")
    st = eng.init(CAP, hot_bucket=4)
    ops, keys, vals, _ = _stream(6)[0]
    p = t_plan(ops, keys, vals, device=DEV)
    with t_obs.tracing() as tr:
        st, _, _, _ = eng.step(st, p.ops, p.keys, p.vals)
    names = [sp.name for sp in tr.spans]
    assert names[-1] == "step" and tr.spans[-1].args["seq"] == 0
    for n in ("insert", "delete", "find", "update", "promote", "compact"):
        assert n in names, n
    assert all(sp.dur_ns >= 0 for sp in tr.spans)
    assert t_obs.absorb_frame(st, None) is st
    st, _, _, _ = eng.step(st, p.ops, p.keys, p.vals)   # no tracer: no-op
    assert len(tr.spans) == len(names)


@pytest.mark.parametrize("name", ["det_skiplist", "tiered3/size"])
def test_state_built_in_jax_continues_in_port(name):
    jb, tb = j_backend(name), t_backend(name)
    js = jb.init(CAP, **_init_kw(name))
    plans = _stream(4)
    for plan in plans[:3]:
        js, _ = _j_step(name)(js, j_plan(*plan))
    ts = state_from_numpy(name, jax.tree.map(np.asarray, js), DEV)
    with t_exec.exec_mode("torch"):
        for i, plan in enumerate(plans[3:]):
            js, jr = _j_step(name)(js, j_plan(*plan))
            ts, tr = tb.apply(ts, t_plan(*plan, device=DEV))
            assert_same(jr, tr, (name, i))
            assert_same(js, state_to_numpy(ts), (name, i))


def test_paper_kvstore_config_matches_reference():
    for fn in ("CONFIG", "reduced", "tiered", "tiered3"):
        j = getattr(j_cfg, fn)
        t = getattr(t_cfg, fn)
        j, t = (j, t) if fn == "CONFIG" else (j(), t())
        for f in ("name", "family", "store_capacity", "store_lanes",
                  "store_backend"):
            assert getattr(j, f) == getattr(t, f), (fn, f)
    assert t_cfg.tiered3("size").store_backend == "tiered3/size"
    assert t_cfg.CONFIG.store_exec == "gpu"


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "tools" / "torch_store_profile.py", ROOT / "chip_smoke.py"]


def test_port_imports_without_jax():
    mods = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
            for p in _port_files() if p.is_relative_to(ROOT / "src")]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith('jax.') for k, v in "
            "sys.modules.items() if v is not None)\n"
            "print('ok', len(" + repr(mods) + "))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_port_sources_never_import_the_reference():
    files = _port_files()
    assert files[-1].exists()
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, n)


def test_cuda_entry_points_refuse_cpu_only_machine():
    if torch.cuda.is_available():
        assert StoreEngine(LOCAL_MESH, LOCAL_MESH.axis_names, 8,
                           "det_skiplist").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            StoreEngine(LOCAL_MESH, LOCAL_MESH.axis_names, 8, "det_skiplist")
        with pytest.raises(RuntimeError, match="cuda"):
            t_backend("tiered3").init(64)
    be = t_backend("det_skiplist")
    st = be.init(64, device=DEV)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            state_from_numpy("det_skiplist", state_to_numpy(st))
    t_exec.set_mode("gpu")                              # the default
    with pytest.raises(ValueError, match="exec mode"):
        t_exec.set_mode("jnp")
    with pytest.raises(RuntimeError, match="gpu"):
        be.apply(st, t_plan([OP_FIND], np.array([5], np.uint64), device=DEV))
