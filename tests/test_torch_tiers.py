"""The tier stacks' init arguments against the JAX reference.

`TieredBackend.init` takes the reference's `hot_frac` (hot tier at
~capacity / hot_frac cells) and `spill_cap` (depth-3 spill runs at
`spill_cap` cells, default `capacity`). Each case inits the port and the
reference with them, compares every state leaf (dtype, shape, bits),
then runs a short seeded stream through both (the reference's direct
`jax.jit(be.apply)`, the port in exec mode torch) and compares results
and states after every plan. Tolerance 0. The shapes are those of the
reference's own tests (`tests/test_obs.py`, `tests/test_tier_find.py`)
and `tiered3/b128` at the capacity its two warm blocks need; `obs:`
forwards the arguments to the stack it wraps.
"""
import functools

import numpy as np
import pytest

import jax
import torch

import repro  # noqa: F401  (enables x64)
from repro.store import get_backend as j_backend
from repro.store import make_plan as j_plan
from repro_torch.convert import state_to_numpy, tree_leaves
from repro_torch.store import exec as t_exec
from repro_torch.store import get_backend as t_backend
from repro_torch.store import make_plan as t_plan

DEV = "cpu"
WIDTH = 64
OP_NONE, OP_FIND, OP_INSERT, OP_DELETE, OP_RANGE_DELETE = -1, 0, 1, 2, 6
CAP_B128 = 160                                         # 2 warm blocks

CASES = [
    ("tiered3", 64, dict(hot_bucket=4, hot_frac=2)),
    ("tiered3", 64, dict(hot_bucket=4, spill_cap=16)),
    ("tiered3", 8, dict(hot_bucket=2, hot_frac=4, spill_cap=4096)),
    ("tiered3/lru", 64, dict(hot_bucket=4, hot_frac=2)),
    ("tiered3/lru", 64, dict(hot_bucket=4, spill_cap=16)),
    ("tiered3/lru", 8, dict(hot_bucket=2, hot_frac=4, spill_cap=4096)),
    ("tiered3/b128", CAP_B128, dict(hot_bucket=4, hot_frac=2, spill_cap=64)),
    ("obs:tiered3/lru", 64, dict(hot_bucket=4, hot_frac=2, spill_cap=16)),
]


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


def assert_state_same(name, js, ts, ctx):
    """Every state leaf; behind `obs:` the inner state and the metrics
    plane key by key."""
    if name.startswith("obs:"):
        assert_same(js.inner, state_to_numpy(ts.inner), ctx)
        assert sorted(js.metrics) == sorted(ts.metrics), ctx
        for k, v in js.metrics.items():
            assert int(v) == int(ts.metrics[k]), (ctx, k)
    else:
        assert_same(js, state_to_numpy(ts), ctx)


@functools.lru_cache(maxsize=None)
def _j_step(name):
    return jax.jit(j_backend(name).apply)


def _stream(cap, seed=3):
    """Insert-heavy plans enough to fill the warm tier four times over, then
    two mixed plans, over a key pool four times the warm tier, so the
    warm tier overflows into the spill runs."""
    rng = np.random.default_rng(seed)
    pool = np.unique(rng.integers(1, 2**64 - 2, 4 * cap, dtype=np.uint64))
    n_fill = -(-4 * cap // WIDTH)
    plans = []
    for p in range(n_fill + 2):
        probs = [0.05, 0.05, 0.8, 0.05, 0.05] if p < n_fill else \
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


def _tiers(name, st):
    return st.inner if name.startswith("obs:") else st


def _case_id(name, cap, kw):
    return "-".join([name, str(cap)] + [f"{k}{v}" for k, v in kw.items()])


@pytest.mark.parametrize("name,cap,kw", CASES,
                         ids=[_case_id(*c) for c in CASES])
def test_init_kwargs_match_reference(name, cap, kw):
    jb, tb = j_backend(name), t_backend(name)
    js = jb.init(cap, **kw)
    ts = tb.init(cap, device=DEV, **kw)
    assert_state_same(name, js, ts, "init")
    hot_slots = max(cap // (kw.get("hot_frac", 8) * kw["hot_bucket"]), 1)
    hot_slots = 1 << (hot_slots.bit_length() - 1)
    jt, tt = _tiers(name, js), _tiers(name, ts)
    assert tt.hot.keys.shape[0] == jt.hot.keys.shape[0] == hot_slots
    spill = kw.get("spill_cap", cap)
    assert tt.spill.keys.shape[0] == jt.spill.keys.shape[0] == spill
    with t_exec.exec_mode("torch"):
        for i, plan in enumerate(_stream(cap)):
            js, jr = _j_step(name)(js, j_plan(*plan))
            ts, tr = tb.apply(ts, t_plan(*plan, device=DEV))
            assert_same(jr, tr, (i, "results"))
            assert_state_same(name, js, ts, (i, "state"))
    jt = _tiers(name, js)
    assert int(jt.cold.n_term) > 0 and int(jt.spill.n) > 0
