"""The port's serving state against the JAX reference, on the CPU (exec
mode `torch`), bit for bit:

* the §III ring queue: a stream of batched pushes and pops, every leaf;
* the paged KV cache on the §V block pool: admissions (with shared pages
  and the pool-exhaustion rollback), prefill writes, decode growth and
  writes, releases; every `PagedKV` leaf (integers bit for bit, page
  data exactly);
* the scheduler: priority then FIFO against a host oracle, a cancelled
  band, and the `obs:pq` metrics against the reference backend's direct
  `apply` of the same plans (the reference's own scheduler cannot run on
  the installed jax: ROADMAP.md §4);
* the prefix cache: `block_key` and the host `page_keys` bit for bit,
  lookups and the `obs:tiered3/lru` metrics against the reference
  backend's direct `apply`, and the ABA miss of a recycled page.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro  # noqa: F401  (enables x64)
from repro.configs import get_reduced as j_get_reduced
from repro.core import blockpool as jbp
from repro.core import ringqueue as jrq
from repro.core.bits import make_priority_key as j_priority_key
from repro.serving import kvcache as JKV
from repro.serving import prefix_cache as JPC
from repro.store import get_backend as j_backend
from repro.store import make_plan as j_plan
from repro_torch.configs import get_reduced
from repro_torch.convert import (paged_kv_from_jax, paged_kv_to_numpy,
                                 tree_leaves)
from repro_torch.core import blockpool as tbp
from repro_torch.core import ringqueue as trq
from repro_torch.core.bits import from_u64
from repro_torch.serving import kvcache as TKV
from repro_torch.serving import prefix_cache as TPC
from repro_torch.serving import scheduler as SCH
from repro_torch.store import exec as t_exec
from repro_torch.store import obs
from repro_torch.store.resilience import state_digest

ARCH = "qwen3-1.7b"
DEV = "cpu"
OP_FIND, OP_INSERT, OP_NONE, OP_POPMIN = 0, 1, -1, 4


@pytest.fixture(autouse=True)
def _torch_mode():
    with t_exec.exec_mode("torch"):
        yield


@pytest.fixture(scope="module")
def cfgs():
    j = j_get_reduced(ARCH).replace(compute_dtype="float32")
    t = get_reduced(ARCH).replace(compute_dtype="float32")
    return j, t


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_leaves(ref_tree, port_leaves, ctx=""):
    """Leaf for leaf: integers bit for bit (u64 / u32 as the int64 / int32
    views), floats exactly."""
    la = [np.asarray(x) for x in jax.tree.leaves(ref_tree)]
    lb = [_np(x) for x in port_leaves]
    assert len(la) == len(lb), (ctx, len(la), len(lb))
    for i, (a, b) in enumerate(zip(la, lb)):
        if a.dtype in (np.uint64, np.uint32) and b.dtype.kind == "i":
            b = b.view(a.dtype)
        if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, i, a.dtype,
                                                           b.dtype)
        assert np.array_equal(a, b), (ctx, i)


def assert_kv(jkv, tkv, ctx=""):
    assert_leaves(jkv, tree_leaves(paged_kv_to_numpy(tkv)), ctx)


def _i32(x):
    return torch.as_tensor(np.asarray(x, np.int32))


def _bools(x):
    return torch.as_tensor(np.asarray(x, bool))


# ---------------------------------------------------------------------------
# §III ring queue
# ---------------------------------------------------------------------------

def test_ringqueue_streams_match_reference():
    rng = np.random.default_rng(0)
    jq = jrq.queue_init(4, 8, jnp.uint64)
    tq = trq.queue_init(4, 8, torch.int64, device=DEV)
    assert_leaves(jq, tq, "init")
    push = jax.jit(jrq.push_batch)
    pop = jax.jit(jrq.pop_batch, static_argnums=1)
    for step in range(14):
        if step % 3 != 2:
            vals = rng.integers(0, 2**64 - 1, 12, dtype=np.uint64)
            mask = rng.random(12) < 0.7
            jq, jok = push(jq, jnp.asarray(vals), jnp.asarray(mask))
            tq, tok = trq.push_batch(tq, from_u64(vals, DEV), _bools(mask))
            assert np.array_equal(np.asarray(jok), _np(tok)), step
        else:
            want = rng.random(16) < 0.8
            jq, jv, jgot = pop(jq, 16, jnp.asarray(want))
            tq, tv, tgot = trq.pop_batch(tq, 16, _bools(want))
            assert np.array_equal(np.asarray(jgot), _np(tgot)), step
            assert np.array_equal(np.asarray(jv), _np(tv).view(np.uint64))
        assert_leaves(jq, tq, f"step {step}")
    assert int(trq.queue_size(tq)) == int(jrq.queue_size(jq))
    assert int(tq.recycles.sum()) > 0          # blocks were recycled


# ---------------------------------------------------------------------------
# the paged KV cache
# ---------------------------------------------------------------------------

def _rand_kv(rng, cfg, s):
    shape = (cfg.n_layers, s, cfg.n_kv_heads, cfg.resolved_head_dim)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def test_kvcache_stream_matches_reference(cfgs):
    jcfg, tcfg = cfgs
    rng = np.random.default_rng(1)
    kw = dict(num_pages=16, page_size=4, max_reqs=4, max_pages_per_req=4)
    jkv = JKV.paged_kv_init(jcfg, **kw)
    tkv = TKV.paged_kv_init(tcfg, device=DEV, **kw)
    assert_kv(jkv, tkv, "init")
    # admit two prompts
    jkv, jok = JKV.admit_requests(jkv, jnp.asarray([0, 1], jnp.int32),
                                  jnp.asarray([7, 4], jnp.int32),
                                  jnp.ones((2,), bool))
    tkv, tok = TKV.admit_requests(tkv, _i32([0, 1]), _i32([7, 4]),
                                  _bools([True, True]))
    assert np.array_equal(np.asarray(jok), _np(tok))
    assert_kv(jkv, tkv, "admit")
    k0, v0 = _rand_kv(rng, jcfg, 7)
    jkv = JKV.write_prefill(jkv, 0, jnp.asarray(k0), jnp.asarray(v0))
    tkv = TKV.write_prefill(tkv, 0, torch.from_numpy(k0), torch.from_numpy(v0))
    assert_kv(jkv, tkv, "prefill 0")
    # a third prompt sharing slot 0's first page
    shared = np.full((1, 4), -1, np.int32)
    shared[0, 0] = int(np.asarray(jkv.block_tables)[0, 0])
    jkv, jok = JKV.admit_requests(jkv, jnp.asarray([2], jnp.int32),
                                  jnp.asarray([6], jnp.int32),
                                  jnp.ones((1,), bool),
                                  shared_pages=jnp.asarray(shared),
                                  n_shared=jnp.asarray([1], jnp.int32))
    tkv, tok = TKV.admit_requests(tkv, _i32([2]), _i32([6]), _bools([True]),
                                  shared_pages=_i32(shared),
                                  n_shared=_i32([1]))
    assert bool(tok[0]) and np.array_equal(np.asarray(jok), _np(tok))
    assert_kv(jkv, tkv, "admit shared")
    k2, v2 = _rand_kv(rng, jcfg, 2)
    jkv = JKV.write_prefill(jkv, 2, jnp.asarray(k2), jnp.asarray(v2),
                            start_page=1)
    tkv = TKV.write_prefill(tkv, 2, torch.from_numpy(k2),
                            torch.from_numpy(v2), start_page=1)
    assert_kv(jkv, tkv, "prefill 2")
    # decode growth (slot 1 sits at a page boundary) and decode writes;
    # the last lane is padding aliasing slot 0
    slots, mask = [0, 1, 2, 0], [True, True, True, False]
    for step in range(5):
        jkv, jok = JKV.grow_for_decode(jkv, jnp.asarray(slots, jnp.int32),
                                       jnp.asarray(mask))
        tkv, tok = TKV.grow_for_decode(tkv, _i32(slots), _bools(mask))
        assert np.array_equal(np.asarray(jok), _np(tok))
        kd, vd = _rand_kv(rng, jcfg, 4)
        jkv = JKV.write_decode_token(jkv, jnp.asarray(slots, jnp.int32),
                                     jnp.asarray(kd), jnp.asarray(vd),
                                     jnp.asarray(mask))
        tkv = TKV.write_decode_token(tkv, _i32(slots), torch.from_numpy(kd),
                                     torch.from_numpy(vd), _bools(mask))
        assert_kv(jkv, tkv, f"decode {step}")
    assert int(TKV.live_pages(tkv)) == int(JKV.live_pages(jkv))
    # release the sharing pair: the shared page frees once, at refcount 0
    jkv = JKV.release_requests(jkv, jnp.asarray([0, 2, 3], jnp.int32),
                               jnp.asarray([True, True, False]))
    tkv = TKV.release_requests(tkv, _i32([0, 2, 3]),
                               _bools([True, True, False]))
    assert_kv(jkv, tkv, "release")
    jkv = JKV.release_requests(jkv, jnp.asarray([1], jnp.int32),
                               jnp.ones((1,), bool))
    tkv = TKV.release_requests(tkv, _i32([1]), _bools([True]))
    assert_kv(jkv, tkv, "release all")
    assert int(tkv.pool.num_free()) == 16 and not tkv.refcount.any()
    # the conversion carries a reference state over unchanged
    assert_kv(jkv, paged_kv_from_jax(jax.tree.map(np.asarray, jkv), DEV),
              "convert")


def test_kvcache_exhaustion_rolls_back(cfgs):
    jcfg, tcfg = cfgs
    kw = dict(num_pages=2, page_size=4, max_reqs=2, max_pages_per_req=4)
    jkv = JKV.paged_kv_init(jcfg, **kw)
    tkv = TKV.paged_kv_init(tcfg, device=DEV, **kw)
    jkv, jok = JKV.admit_requests(jkv, jnp.asarray([0], jnp.int32),
                                  jnp.asarray([12], jnp.int32),
                                  jnp.ones((1,), bool))
    tkv, tok = TKV.admit_requests(tkv, _i32([0]), _i32([12]), _bools([True]))
    assert not bool(tok[0]) and not bool(jok[0])
    assert int(tkv.pool.num_free()) == 2          # rollback returned pages
    assert_kv(jkv, tkv, "exhausted")


def test_kvcache_accounting(cfgs):
    """tests/test_serving.py's accounting, on the port."""
    _, tcfg = cfgs
    kv = TKV.paged_kv_init(tcfg, num_pages=16, page_size=4, max_reqs=4,
                           max_pages_per_req=4, device=DEV)
    kv, ok = TKV.admit_requests(kv, _i32([0, 1]), _i32([7, 4]),
                                _bools([True, True]))
    assert ok.all() and int(kv.pool.num_free()) == 16 - 2 - 1
    kv, ok = TKV.grow_for_decode(kv, _i32([1]), _bools([True]))
    assert ok.all() and int(kv.lengths[1]) == 5
    assert int(kv.pool.num_free()) == 12
    kv = TKV.release_requests(kv, _i32([0, 1]), _bools([True, True]))
    assert int(kv.pool.num_free()) == 16 and not kv.active.any()


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------

def test_scheduler_priority_then_fifo():
    s = SCH.scheduler_init(64, device=DEV)
    s, ok = SCH.submit(s, torch.tensor([2, 0, 1, 0]),
                       torch.tensor([10, 11, 12, 13]), _bools([True] * 4))
    assert ok.all()
    s, got, valid = SCH.pop_min(s, 4)
    assert [int(g) for g, v in zip(got, valid) if v] == [11, 13, 12, 10]
    assert int(SCH.pending(s)) == 0
    s, _ = SCH.submit(s, torch.tensor([5, 1]), torch.tensor([1, 2]),
                      _bools([True, True]))
    s, got, valid = SCH.pop_min(s, 1)
    assert int(got[0]) == 2 and bool(valid[0])
    assert int(SCH.pending(s)) == 1


def _sched_stream(seed):
    """Seeded submits (masked lanes included) and pops of k."""
    rng = np.random.default_rng(seed)
    rid = 0
    for step in range(10):
        if step % 3 == 2:
            yield "pop", int(rng.integers(1, 6))
        else:
            n = int(rng.integers(1, 6))
            mask = rng.random(n) < 0.85
            yield "submit", (rng.integers(0, 3, n), np.arange(rid, rid + n),
                             mask)
            rid += n


def test_scheduler_order_and_metrics_match_oracle_and_reference():
    """Admission order against a host oracle of (priority, ticket); the
    `obs:pq` metrics against the reference backend's direct `apply` of the
    same plans (the one-shard engine adds its routing counters: every
    valid lane is routed)."""
    s = SCH.scheduler_init(64, device=DEV)
    jb = j_backend("obs:pq")
    js = jb.init(64)
    japply = jax.jit(jb.apply)
    pending, ticket, routed = [], 0, 0
    for kind, arg in _sched_stream(3):
        if kind == "submit":
            prio, ids, mask = arg
            s, ok = SCH.submit(s, torch.as_tensor(prio), torch.as_tensor(ids),
                               _bools(mask))
            tickets = ticket + np.cumsum(mask) - 1
            keys = np.asarray(j_priority_key(
                jnp.asarray(prio, jnp.uint32),
                jnp.asarray(tickets.astype(np.uint32))))
            ops = np.where(mask, OP_INSERT, OP_NONE).astype(np.int32)
            js, res = japply(js, j_plan(ops, keys, ids.astype(np.uint64),
                                        mask=ops >= 0))
            assert np.array_equal(_np(ok)[mask], np.asarray(res.ok)[mask])
            for p, i, t, m in zip(prio, ids, tickets, mask):
                if m:
                    pending.append((int(p), int(t), int(i)))
            ticket += int(mask.sum())
            routed += int(mask.sum())
        else:
            k = arg
            s, got, valid = SCH.pop_min(s, k)
            js, res = japply(js, j_plan(np.full(k, OP_POPMIN, np.int32),
                                        np.zeros(k, np.uint64)))
            pending.sort()
            want = [i for _, _, i in pending[:k]]
            pending = pending[k:]
            assert [int(g) for g, v in zip(got, valid) if v] == want
            assert np.array_equal(np.asarray(res.ok), _np(valid))
            routed += k
        assert int(SCH.pending(s)) == len(pending)
    got = SCH.metrics(s)
    want = {k: int(v) for k, v in jb.metrics(js).items()}
    assert set(got) == set(obs.METRICS_SCHEMA)
    assert got["routed_ops"] == routed
    assert got["routed_bytes"] == routed * obs.ROUTED_OP_BYTES
    want.update(routed_ops=routed, routed_bytes=routed * obs.ROUTED_OP_BYTES)
    assert got == want
    assert got["pops"] > 0 and got["inserts_new"] > 0


def test_scheduler_cancel_class_drops_one_band():
    s = SCH.scheduler_init(64, device=DEV)
    s, ok = SCH.submit(s, torch.tensor([2, 0, 2, 1, 2]),
                       torch.tensor([10, 11, 12, 13, 14]), _bools([True] * 5))
    assert ok.all()
    s, cancelled = SCH.cancel_class(s, 2)
    assert cancelled == 3 and int(SCH.pending(s)) == 2
    s, cancelled = SCH.cancel_class(s, 2)          # nothing left in band 2
    assert cancelled == 0
    s, got, valid = SCH.pop_min(s, 4)
    assert [int(g) for g, v in zip(got, valid) if v] == [11, 13]


def test_scheduler_resilience_not_ported():
    """Kept under its old name: the journaled scheduler is ported. A
    dropped store is dead by `health` and `recover` rebuilds it bit for
    bit; a scheduler without the journal refuses to recover."""
    s = SCH.scheduler_init(8, resilient=True, device=DEV)
    s, ok = SCH.submit(s, torch.tensor([1, 0]), torch.tensor([5, 6]),
                       _bools([True, True]))
    assert ok.all() and SCH.health(s)
    dead = SCH.inject_fault(s)
    assert not SCH.health(dead) and s.res.tally["faults_injected"] == 1
    assert state_digest(SCH.recover(dead)) == state_digest(s.store)
    assert s.res.tally["recoveries"] == 1
    assert s.res.tally["replayed_ops"] == 2
    dead, got, valid = SCH.pop_min(dead, 2)            # recovers first
    assert [int(g) for g in got] == [6, 5] and valid.all()
    with pytest.raises(ValueError, match="resilient"):
        SCH.recover(SCH.scheduler_init(8, device=DEV))


# ---------------------------------------------------------------------------
# prefix cache
# ---------------------------------------------------------------------------

def test_block_key_and_host_page_keys_match_reference():
    rng = np.random.default_rng(4)
    prompt = rng.integers(1, 151936, 53).astype(np.int32)
    page = 8
    prev = jnp.zeros((1,), jnp.uint64)
    want = []
    for j in range(len(prompt) // page):
        prev = JPC.block_key(jnp.asarray(prompt[j * page:(j + 1) * page])[None],
                             prev)
        want.append(int(prev[0]))
    assert TPC.page_keys(prompt, page) == want
    # the device block_key, batched, chained on the previous keys
    blocks = rng.integers(0, 2**31 - 1, (5, page)).astype(np.int32)
    prev = rng.integers(0, 2**64 - 1, 5, dtype=np.uint64)
    jk = np.asarray(JPC.block_key(jnp.asarray(blocks), jnp.asarray(prev)))
    tk = TPC.block_key(torch.from_numpy(blocks), from_u64(prev, DEV))
    assert np.array_equal(jk, _np(tk).view(np.uint64))


def test_prefix_cache_matches_reference_and_aba():
    """lookup / insert against the reference's `obs:tiered3/lru` direct
    apply of the same plans (found ids through the same pool's ABA check,
    and the metrics plane); a recycled page's entry misses."""
    rng = np.random.default_rng(5)
    jpool = jbp.blockpool_init(32)
    tpool = tbp.blockpool_init(32, device=DEV)
    jpool, jids, jh, _ = jbp.pool_alloc(jpool, jnp.ones(20, bool))
    tpool, tids, th, _ = tbp.pool_alloc(tpool, torch.ones(20, dtype=bool))
    assert np.array_equal(np.asarray(jh), _np(th).view(np.uint64))
    pc = TPC.prefix_cache_init(capacity=64, device=DEV, hot_bucket=4)
    jb = j_backend("obs:tiered3/lru")
    js = jb.init(64, hot_bucket=4)
    japply = jax.jit(jb.apply)
    keys = rng.integers(1, 2**64 - 2, 20, dtype=np.uint64)
    routed = 0
    for lo, hi in ((0, 12), (8, 20)):                 # overlapping publishes
        mask = rng.random(hi - lo) < 0.9
        pc = TPC.insert(pc, from_u64(keys[lo:hi], DEV), th[lo:hi],
                        _bools(mask))
        ops = np.where(mask, OP_INSERT, OP_NONE).astype(np.int32)
        js, _ = japply(js, j_plan(ops, keys[lo:hi], np.asarray(jh)[lo:hi],
                                  mask=ops >= 0))
        routed += int(mask.sum())
    probe = np.concatenate([keys, rng.integers(1, 2**64 - 2, 6,
                                               dtype=np.uint64)])
    pc, ids, fresh = TPC.lookup(pc, tpool, from_u64(probe, DEV))
    js, res = japply(js, j_plan(np.full(probe.size, OP_FIND, np.int32),
                                probe))
    routed += probe.size
    jfresh = np.asarray(res.ok & jbp.handle_valid(jpool, res.vals))
    assert np.array_equal(_np(fresh), jfresh)
    want_ids = np.where(jfresh, (np.asarray(res.vals) & 0xFFFFFFFF), -1)
    assert np.array_equal(_np(ids), want_ids.astype(np.int32))
    assert int(pc.hits) == int(jfresh.sum())
    assert int(pc.misses) == probe.size - int(jfresh.sum())
    got = TPC.metrics(pc)
    want = {k: int(v) for k, v in jb.metrics(js).items()}
    want.update(routed_ops=routed, routed_bytes=routed * obs.ROUTED_OP_BYTES)
    assert got == want and got["find_hits"] > 0
    # recycle the first page: its entry turns stale (the generation moved)
    hit0 = bool(fresh[0])
    tpool = tbp.pool_free(tpool, tids[:1], torch.ones(1, dtype=bool))
    pc, ids, fresh = TPC.lookup(pc, tpool, from_u64(probe[:2], DEV))
    assert hit0 and not bool(fresh[0]) and int(ids[0]) == -1
    assert bool(fresh[1]) == bool(jfresh[1])
