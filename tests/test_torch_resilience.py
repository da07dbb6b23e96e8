"""The port's resilience layer (`repro_torch.store.resilience`) against the
JAX reference, exactly, on the CPU in exec mode `torch`.

Against the reference's functions called directly (they need no mesh):
* a `Journal`'s entry and head digests over the same plans;
* `state_digest` of a converted reference state, flat and sharded (the
  reference's `sharded_init` layout, static ints promoted);
* `make_fault_plan` for several seeds and kind sets, `sanitize_ops`,
  `poison_ops`;
* `rebuild_shard` from a snapshot taken mid-stream.

The reference's `ResilientEngine` fails on the installed jax 0.9.0: its
`inject_shard_drop` (`x.at[shard].set` on the mesh-sharded state) raises
`ShardingTypeError` (ROADMAP.md §3). So the port's `ResilientEngine` is
held to the reference's own contract: in `sync` mode every step's results,
the final `state_digest` and the per-shard metrics equal the fault-free
run's; in `degraded` mode the healthy lanes equal the fault-free run's
at every step and `completions` equal the fault-free answers. Also the
journal's `restore` and the serving fault path on reduced qwen3-1.7b:
faulted tokens equal fault-free tokens.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro  # noqa: F401  (enables x64)
from repro.store import get_backend as j_backend
from repro.store import make_plan as j_plan
from repro.store.engine import sharded_init as j_sharded_init
from repro.store.resilience import faults as JF
from repro.store.resilience import journal as JJ
from repro.store.resilience.restore import _make_replayer as j_replayer
from repro.store.resilience.restore import rebuild_shard as j_rebuild
from repro_torch.configs import get_reduced
from repro_torch.convert import (sharded_state_from_numpy, state_from_numpy,
                                 tree_leaves)
from repro_torch.core.bits import from_u64
from repro_torch.core.routing import ShardMesh
from repro_torch.models.model import init_params
from repro_torch.serving import traffic
from repro_torch.serving.engine import Engine
from repro_torch.store import exec as t_exec
from repro_torch.store import get_backend as t_backend
from repro_torch.store import obs
from repro_torch.store import resilience as R
from repro_torch.store.engine import StoreEngine

DEV = "cpu"
AXES, SIZES = ("pod", "data"), (2, 4)
S, LANES = 8, 16
N = S * LANES
OP_NONE, OP_FIND, OP_INSERT, OP_DELETE = -1, 0, 1, 2


@pytest.fixture(autouse=True)
def _torch_mode():
    with t_exec.exec_mode("torch"):
        yield


def plans(seed, n_plans=6):
    """Global plans of N lanes, no key twice within a plan (so per-shard
    replay in lane order equals the engine's routed order): fresh
    inserts, then finds / deletes / inserts of known and fresh keys."""
    rng = np.random.default_rng(seed)
    known = np.zeros(0, np.uint64)
    out = []
    for p in range(n_plans):
        keys = rng.integers(1, 2**64 - 2, N, dtype=np.uint64)
        if p:
            old = rng.random(N) < 0.5
            keys[old] = rng.choice(known, int(old.sum()), replace=False)
        assert np.unique(keys).size == N
        ops = (np.full(N, OP_INSERT, np.int32) if p == 0 else
               rng.choice([OP_INSERT, OP_FIND, OP_DELETE, OP_NONE], N,
                          p=[0.35, 0.4, 0.15, 0.1]).astype(np.int32))
        known = np.unique(np.concatenate([known, keys[ops == OP_INSERT]]))
        out.append((ops, keys, rng.integers(0, 2**64 - 1, N,
                                            dtype=np.uint64)))
    return out


def _dev(ops, keys, vals):
    return (torch.from_numpy(ops), from_u64(keys, DEV), from_u64(vals, DEV))


# ---------------------------------------------------------------------------
# against the reference's functions
# ---------------------------------------------------------------------------

def test_journal_digests_match_reference():
    jj, tj = JJ.Journal(base_seq=3), R.Journal(base_seq=3)
    assert R.GENESIS == JJ.GENESIS and tj.head_digest == jj.head_digest
    for i, (ops, keys, vals) in enumerate(plans(1, 4)):
        je = jj.append(3 + i, ops, keys, vals)
        te = tj.append(3 + i, *_dev(ops, keys, vals))
        assert te.digest == je.digest and te.n_ops == je.n_ops
        assert te.keys.dtype == np.uint64 and te.ops.dtype == np.int32
    assert tj.head_digest == jj.head_digest and tj.verify()
    with pytest.raises(ValueError, match="gap-free"):
        tj.append(99, *_dev(*plans(1, 1)[0]))
    tj.entries[1] = tj.entries[1]._replace(digest=tj.entries[2].digest)
    with pytest.raises(ValueError, match="entry 1"):
        tj.verify()
    assert [e.seq for e in tj.tail(5)] == [5, 6]


def _ref_state(name, n_plans=3):
    jb = j_backend(name)
    js = jb.init(64)
    step = jax.jit(jb.apply)
    for ops, keys, vals in plans(2, n_plans):
        js, _ = step(js, j_plan(ops[:64], keys[:64], vals[:64],
                                mask=ops[:64] >= 0))
    return jax.tree.map(np.asarray, js)


@pytest.mark.parametrize("name", ["det_skiplist", "splitorder",
                                  "obs:det_skiplist", "tiered3/lru", "pq"])
def test_state_digest_of_converted_state_matches_reference(name):
    tree = _ref_state(name)
    assert R.state_digest(state_from_numpy(name, tree, DEV)) == \
        JJ.state_digest(tree)
    sharded = jax.tree.map(np.asarray, j_sharded_init(name, 4, 64))
    ts = sharded_state_from_numpy(name, sharded, DEV)
    assert len(ts) == 4
    assert R.state_digest(ts) == JJ.state_digest(sharded)
    snap = R.take_snapshot(ts, 7)
    assert snap.digest == JJ.take_snapshot(sharded, 7).digest
    assert R.state_digest(R.snapshot_state(snap, DEV)) == snap.digest


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_make_fault_plan_matches_reference(seed):
    for kinds in (JF.FAULT_KINDS, ("shard_drop",), ("poison", "stall")):
        j = JF.make_fault_plan(seed, 12, 8, 16, n_faults=5, kinds=kinds)
        t = R.make_fault_plan(seed, 12, 8, 16, n_faults=5, kinds=kinds)
        assert [tuple(f) for f in t.faults] == [tuple(f) for f in j.faults]
        assert all(t.at(s) == [R.Fault(*f) for f in j.at(s)]
                   for s in range(12))
    with pytest.raises(ValueError):
        R.make_fault_plan(seed, 1, 8, 16)
    with pytest.raises(ValueError, match="unknown"):
        R.make_fault_plan(seed, 4, 8, 16, kinds=("meteor",))


def test_sanitize_and_poison_match_reference(monkeypatch):
    ops = np.array([-1, 0, 1, 2, 3, 4, 5, 6, 7, -2, 113], np.int32)
    for lane in (0, 4, 10):
        jp = np.asarray(JF.poison_ops(jnp.asarray(ops), lane))
        tp = R.poison_ops(torch.from_numpy(ops), lane)
        assert np.array_equal(tp.numpy(), jp)
        assert np.array_equal(R.poison_ops(ops, lane), jp)
        for a, b in zip(R.sanitize_ops(tp), JF.sanitize_ops(jp)):
            assert np.array_equal(a, b)
    monkeypatch.setenv("REPRO_FAULTS", "41")
    assert R.default_seed() == JF.default_seed() == 41


@pytest.mark.parametrize("shard", [0, 5])
def test_rebuild_shard_matches_reference(shard):
    """Genesis -> two plans replayed per shard (the reference's
    rebuild_shard) -> a snapshot at seq 2 -> the rest replayed for one
    shard, by both packages from the same snapshot and journal."""
    name, pool = "obs:det_skiplist", 2 * LANES
    jb = j_backend(name)
    ps = plans(3, 4)
    jj, tj = JJ.Journal(0), R.Journal(0)
    for i, p in enumerate(ps):
        jj.append(i, *p)
        tj.append(i, *_dev(*p))
    genesis = JJ.take_snapshot(j_sharded_init(jb, S, 64), 0)
    replay = j_replayer(jb, "jnp")
    mid = [j_rebuild(jb, genesis, jj.entries[:2], s, S, pool, "jnp",
                             replay)[0] for s in range(S)]
    mid = jax.tree.map(lambda *x: np.stack([np.asarray(a) for a in x]), *mid)
    jsnap = JJ.take_snapshot(mid, 2)
    tsnap = R.take_snapshot(sharded_state_from_numpy(name, mid, DEV), 2)
    assert tsnap.digest == jsnap.digest
    js, jn = j_rebuild(jb, jsnap, jj.tail(2), shard, S, pool, "jnp",
                               replay)
    ts, tn = R.rebuild_shard(t_backend(name), tsnap, tj.tail(2), shard, S,
                             pool, "torch", device=DEV)
    assert tn == jn > 0
    assert R.state_digest(ts) == JJ.state_digest(jax.device_get(js))


# ---------------------------------------------------------------------------
# the port's ResilientEngine against the fault-free run
# ---------------------------------------------------------------------------

def _engine(name):
    """pool_factor 4: no lane dropped, so per-shard replay in lane order
    meets the engine's routed order."""
    return StoreEngine(ShardMesh(AXES, SIZES), AXES, LANES, name,
                       pool_factor=4, exec_mode="torch", device=DEV)


def _fault_free(name, ps):
    eng = _engine(name)
    state = eng.init(64)
    outs = []
    for p in ps:
        state, res, ok, dr = eng.step(state, *_dev(*p))
        assert int(dr) == 0
        outs.append((res, ok))
    return eng, state, outs


@pytest.mark.parametrize("name", ["obs:det_skiplist", "obs:tiered3/lru"])
def test_resilient_sync_equals_fault_free(name):
    ps = plans(4, 7)
    ref_eng, ref_state, ref_outs = _fault_free(name, ps)
    fp = R.FaultPlan(0, [R.Fault("shard_drop", 2, shard=3),
                         R.Fault("poison", 3, lane=5),
                         R.Fault("stall", 3, ticks=2),
                         R.Fault("shard_drop", 5, shard=6)])
    eng = _engine(name)
    reng = R.ResilientEngine(eng, snapshot_every=4, fault_plan=fp)
    state = eng.init(64)
    for i, p in enumerate(ps):
        state, res, ok, _ = reng.step(state, *_dev(*p))
        assert torch.equal(res, ref_outs[i][0]) and torch.equal(
            ok, ref_outs[i][1]), (name, i)
    assert R.state_digest(state) == R.state_digest(ref_state)
    got, want = eng.metrics(state), ref_eng.metrics(ref_state)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    t = reng.tally
    assert (t["faults_injected"], t["recoveries"], t["retries"]) == (4, 2, 1)
    assert t["replayed_ops"] > 0 and reng.stall_ticks == 2
    assert reng.virtual_ticks == len(ps) + 2
    assert [s.seq for s in reng.snapshots] == [0, 4]
    m = reng.metrics(state)
    assert m["recoveries"] == 2 and m["routed_ops"] == int(
        want["routed_ops"].sum())
    assert reng.journal.verify() and len(reng.journal) == len(ps)
    # the journal's restore: the seq-4 snapshot plus the tail
    rs, n = R.restore(_engine(name), reng.snapshots[-1], reng.journal.tail(4))
    assert R.state_digest(rs) == R.state_digest(state) and n > 0


def test_resilient_degraded_completions_equal_fault_free():
    name = "obs:det_skiplist"
    ps = plans(5, 7)
    _, _, ref_outs = _fault_free(name, ps)
    eng = _engine(name)
    reng = R.ResilientEngine(eng, snapshot_every=2, mode="degraded",
                             replay_per_tick=1,
                             fault_plan=R.FaultPlan(1, [R.Fault(
                                 "shard_drop", 3, shard=2)]))
    state = eng.init(64)
    deferred = 0
    for i, p in enumerate(ps):
        state, res, ok, _ = reng.step(state, *_dev(*p))
        owner = (p[1] >> np.uint64(61)).astype(np.int64)
        held = reng.quarantine is not None or any(
            s == i for s, _ in reng.completions)
        mine = (owner == 2) & (p[0] >= 0) if held else np.zeros(N, bool)
        deferred += int(mine.sum())
        healthy = torch.from_numpy(~mine)
        assert torch.equal(res[healthy], ref_outs[i][0][healthy]), i
        assert torch.equal(ok[healthy], ref_outs[i][1][healthy]), i
        assert not ok[torch.from_numpy(mine)].any(), i
    assert reng.quarantine is None and reng.tally["recoveries"] == 1
    assert len(reng.completions) == deferred > 0
    for (seq, lane), (ok, val) in reng.completions.items():
        assert ok == bool(ref_outs[seq][1][lane])
        assert val == int(ref_outs[seq][0][lane]), (seq, lane)
    with pytest.raises(ValueError, match="recovery mode"):
        R.ResilientEngine(eng, mode="eventually")


def test_state_alive_and_shard_drop():
    eng = _engine("splitorder")
    state = eng.init(64)
    assert R.state_alive(state, S).all()
    dead = R.inject_shard_drop(state, 4)
    assert R.state_alive(dead, S).tolist() == [s != 4 for s in range(S)]
    assert dead[4].max_load == 0 and state[4].max_load == 16
    assert all(not torch.is_tensor(x) or not x.any()
               for x in tree_leaves(dead[4]))
    assert R.splice_shard(dead, state[4], 4)[4] is state[4]
    with pytest.raises(ValueError):
        R.state_alive(state, 4)


# ---------------------------------------------------------------------------
# the serving fault path
# ---------------------------------------------------------------------------

def test_serving_fault_plan_keeps_tokens():
    cfg = get_reduced("qwen3-1.7b").replace(compute_dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    trace = traffic.make_trace(seed=3, n_requests=6, page_size=8,
                               vocab=cfg.vocab_size)
    kw = dict(max_reqs=4, num_pages=32, page_size=8, max_pages_per_req=8,
              device=DEV, exec_mode="torch")
    clean = traffic.replay(Engine(cfg, params, **kw), trace)
    fp = R.FaultPlan(2, [R.Fault("shard_drop", s, shard=0)
                         for s in (1, 2, 5)])
    eng = Engine(cfg, params, fault_plan=fp, **kw)
    faulted = traffic.replay(eng, trace)
    assert faulted == clean and all(len(v) for v in clean.values())
    m = eng.resilience_metrics()
    assert set(m) == set(obs.METRICS_SCHEMA)
    assert m["faults_injected"] == 3 and m["recoveries"] == 3
    assert m["replayed_ops"] > 0 and eng.sched.res.journal.verify()
