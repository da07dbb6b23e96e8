"""The store's observability and dispatch names that the port took last
(`ObservedStore.flush` and `kernelized`, `SPAN_TAXONOMY`,
`current_tracer`, the store package's re-exports, `OpPlan.width`,
`runnable_modes`, `DISPATCH_KINDS` / `dispatch_count` /
`reset_dispatch_count`, `core.bits.pack_key_payload` /
`unpack_key_payload`, `DetSkiplist.size` / `contains`,
`configs.paper_kvstore.kernelized` and the `pod_compress` /
`decode_shard` config fields) against the JAX reference's, on the CPU.

`test_flush_records_demotions` is the reference's
`tests/test_obs.py::TestMetricsPlane::test_flush_records_demotions` run on
both packages with the same seeded plans: after a flush the whole
metrics plane (demotions included), the stats and every state leaf are
equal, tolerance 0.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro  # noqa: F401  (enables x64)
from repro import store as j_store
from repro.configs import base as j_base
from repro.configs import paper_kvstore as j_kv
from repro.core import bits as j_bits
from repro.core import det_skiplist as j_dsl
from repro.store import exec as j_exec
from repro.store import obs as j_obs
from repro_torch import store as t_store
from repro_torch.configs import base as t_base
from repro_torch.configs import paper_kvstore as t_kv
from repro_torch.convert import state_to_numpy, tree_leaves
from repro_torch.core import bits as t_bits
from repro_torch.core import det_skiplist as t_dsl
from repro_torch.core.bits import from_u64
from repro_torch.store import exec as t_exec
from repro_torch.store import obs as t_obs

OP_FIND, OP_INSERT, OP_DELETE = 0, 1, 2


def _plans(n=4, width=16, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ops = rng.integers(0, 3, width).astype(np.int32)
        ops[:width // 2] = OP_INSERT
        keys = rng.integers(1, 48, width).astype(np.uint64)
        vals = rng.integers(1, 1 << 20, width).astype(np.uint64)
        out.append((ops, keys, vals))
    return out


def _ints(metrics):
    return {k: int(v) for k, v in metrics.items()}


@pytest.mark.parametrize("name", ["obs:tiered3/lru", "obs:tiered3/size",
                                  "obs:hash+skiplist"])
def test_flush_records_demotions(name):
    jb, tb = j_store.get_backend(name), t_store.get_backend(name)
    js = jb.init(64, hot_bucket=4, hot_frac=8)
    ts = tb.init(64, device="cpu", hot_bucket=4, hot_frac=8)
    with t_exec.exec_mode("torch"):
        for ops, keys, vals in _plans():
            js, _ = jb.apply(js, j_store.make_plan(ops, keys, vals))
            ts, _ = tb.apply(ts, t_store.make_plan(ops, keys, vals,
                                                   device="cpu"))
        before = _ints(tb.metrics(ts))["demotions"]
        js, ts = jb.flush(js), tb.flush(ts)
    after = _ints(tb.metrics(ts))
    assert after["demotions"] > before
    assert after == _ints(jb.metrics(js))
    assert _ints(tb.stats(ts)) == _ints(jb.stats(js))
    assert int(tb.stats(ts)["hot_size"]) == 0
    for a, b in zip(tree_leaves(state_to_numpy(ts.inner)),
                    jax.tree.leaves(js.inner)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("name", ["det_skiplist", "rand_skiplist",
                                  "fixed_hash", "twolevel_hash",
                                  "splitorder", "twolevel_splitorder",
                                  "hash+skiplist", "tiered3/b128", "pq"])
def test_kernelized_matches_reference(name):
    for prefix in ("", "obs:"):
        assert t_store.get_backend(prefix + name).kernelized == \
            j_store.get_backend(prefix + name).kernelized, prefix + name


def test_span_taxonomy_and_current_tracer():
    assert t_obs.SPAN_TAXONOMY == j_obs.SPAN_TAXONOMY
    assert t_obs.current_tracer() is None
    with t_obs.tracing() as tr:
        assert t_obs.current_tracer() is tr
        with t_obs.tracing() as inner:
            assert t_obs.current_tracer() is inner
        assert t_obs.current_tracer() is tr
    assert t_obs.current_tracer() is None


def test_store_package_reexports():
    assert set(t_store.__all__) == set(j_store.__all__)
    for name in t_store.__all__:
        assert hasattr(t_store, name), name
    assert t_store.ObservedStore is t_obs.ObservedStore
    assert t_store.current_tracer is t_obs.current_tracer
    assert t_store.METRICS_SCHEMA == j_store.METRICS_SCHEMA
    assert t_store.SERVING_SCHEMA == j_store.SERVING_SCHEMA


@pytest.mark.parametrize("width", [1, 7, 64])
def test_opplan_width(width):
    ops = np.zeros(width, np.int32)
    keys = np.arange(width, dtype=np.uint64)
    assert t_store.make_plan(ops, keys, device="cpu").width == \
        j_store.make_plan(ops, keys).width == width


def test_runnable_modes_and_dispatch_counts():
    assert t_exec.runnable_modes() == (("torch", "gpu")
                                       if torch.cuda.is_available()
                                       else ("torch",))
    assert t_exec.DISPATCH_KINDS == j_exec.DISPATCH_KINDS
    be = t_store.get_backend("hash+skiplist")
    st = be.init(64, device="cpu", hot_bucket=4, hot_frac=8)
    plans = _plans(3)
    t_exec.reset_dispatch_count()
    assert t_exec.dispatch_count() == 0
    with t_exec.exec_mode("torch"), t_exec.measure_dispatches() as m:
        for ops, keys, vals in plans:
            st, _ = be.apply(st, t_store.make_plan(ops, keys, vals,
                                                   device="cpu"))
            if ops is plans[0][0]:
                t_exec.reset_dispatch_count()    # the meter is unaffected
    assert m.n == 3 * (m.n // 3) and m.n > 0
    assert t_exec.dispatch_count() == 2 * m.n // 3
    assert t_exec.dispatch_count("probe") + \
        t_exec.dispatch_count("update") == t_exec.dispatch_count()
    assert t_exec.dispatch_count("probe") == 2 * m.probe // 3
    with pytest.raises(ValueError, match="unknown dispatch kind"):
        t_exec.dispatch_count("pop")
    # the reference counts the same dispatches an apply
    jb = j_store.get_backend("hash+skiplist")
    js = jb.init(64, hot_bucket=4, hot_frac=8)
    with j_exec.measure_dispatches() as jm:
        for ops, keys, vals in plans:
            js, _ = jb.apply(js, j_store.make_plan(ops, keys, vals))
    assert (m.n, m.probe, m.update) == (jm.n, jm.probe, jm.update)


def test_pack_key_payload_matches():
    rng = np.random.default_rng(3)
    hi = np.concatenate([rng.integers(0, 2**32, 64, dtype=np.uint64),
                         np.array([0, 2**32 - 1, 2**31], np.uint64)])
    lo = np.concatenate([rng.integers(0, 2**32, 64, dtype=np.uint64),
                         np.array([2**32 - 1, 0, 2**31], np.uint64)])
    want = np.asarray(j_bits.pack_key_payload(
        jnp.asarray(hi.astype(np.uint32)), jnp.asarray(lo.astype(np.uint32))))
    got = t_bits.pack_key_payload(torch.as_tensor(hi.astype(np.int64)),
                                  torch.as_tensor(lo.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    jh, jl = j_bits.unpack_key_payload(jnp.asarray(want))
    th, tl = t_bits.unpack_key_payload(from_u64(want, "cpu"))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh).astype(np.int64))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl).astype(np.int64))


def test_det_skiplist_size_and_contains():
    rng = np.random.default_rng(4)
    keys = np.unique(rng.integers(1, 2**64 - 2, 40, dtype=np.uint64))
    vals = np.arange(1, len(keys) + 1, dtype=np.uint64)
    js = j_dsl.skiplist_init(64)
    js, _, _ = j_dsl.insert_batch(js, jnp.asarray(keys), jnp.asarray(vals))
    js, _ = j_dsl.delete_batch(js, jnp.asarray(keys[:5]))
    ts = t_dsl.skiplist_init(64, device="cpu")
    ts, _, _ = t_dsl.insert_batch(ts, from_u64(keys, "cpu"),
                                  from_u64(vals, "cpu"))
    ts, _ = t_dsl.delete_batch(ts, from_u64(keys[:5], "cpu"))
    assert int(ts.size()) == int(js.size()) == len(keys) - 5
    for k in (keys[0], keys[5], keys[-1], np.uint64(2**64 - 2)):
        assert bool(t_dsl.contains(ts, int(k))) == \
            bool(j_dsl.contains(js, k)), int(k)
        assert bool(t_dsl.contains(ts, from_u64([k], "cpu"))) == \
            bool(j_dsl.contains(js, k))


@pytest.mark.parametrize("mode", ["torch", "gpu"])
def test_paper_kvstore_kernelized(mode):
    cfg = t_kv.kernelized(mode)
    ref = j_kv.kernelized()
    assert cfg.store_backend == ref.store_backend == "hash+skiplist"
    assert cfg.store_exec == mode
    assert (cfg.store_capacity, cfg.store_lanes) == (ref.store_capacity,
                                                     ref.store_lanes)
    with pytest.raises(ValueError, match="unknown store exec mode"):
        t_kv.kernelized("pallas")


def test_config_fields_match_reference():
    t, j = t_base.ModelConfig("x", "dense"), j_base.ModelConfig("x", "dense")
    for field in ("pod_compress", "decode_shard"):
        assert getattr(t, field) == getattr(j, field)
    assert not hasattr(t, "scan_layers")
