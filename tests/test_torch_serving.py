"""The port's serving engine against the JAX reference, on reduced
qwen3-1.7b (2 layers, d_model 64, 4 heads, 2 KV heads, head_dim 16), all
on the CPU (exec mode `torch`).

* `paged_decode_step` against the reference's with `use_kernel=False`
  (jnp oracle) and `use_kernel=True` (Pallas interpret): logits within
  1e-4 and pools within 1e-5 at f32 compute (the same f32 attention, sums
  in another order), and a masked lane writes nothing; exec mode `gpu`
  refuses CPU tensors;
* the engine end to end at f32 compute: every request's tokens equal the
  reference's contiguous `prefill` + `decode_step` (the reference's own
  engine cannot serve on the installed jax: ROADMAP.md §4), shared
  prefixes, recycled pages, and the degradation paths (deadlines,
  backoff, shedding) on `make_trace` traces, which equal the reference's
  request for request.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro  # noqa: F401  (enables x64)
from repro.configs import get_reduced as j_get_reduced
from repro.models import model as JM
from repro.serving import kvcache as JKV
from repro.serving import traffic as jtraffic
from repro.serving.paged_decode import paged_decode_step as j_decode
from repro_torch.configs import get_reduced
from repro_torch.convert import paged_kv_from_jax, params_from_jax
from repro_torch.serving import traffic
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.paged_decode import paged_decode_step
from repro_torch.store import exec as t_exec
from repro_torch.store import obs
from repro_torch.store.resilience import FaultPlan

ARCH = "qwen3-1.7b"
DEV = "cpu"


@pytest.fixture(autouse=True)
def _torch_mode():
    with t_exec.exec_mode("torch"):
        yield


@pytest.fixture(scope="module")
def cfgs():
    j = j_get_reduced(ARCH).replace(compute_dtype="float32")
    t = get_reduced(ARCH).replace(compute_dtype="float32")
    return j, t


@pytest.fixture(scope="module")
def params(cfgs):
    jcfg, tcfg = cfgs
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, DEV)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# ---------------------------------------------------------------------------
# paged_decode_step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def decode_state(cfgs, params):
    """A reference PagedKV with two prefilled requests (slots 0, 1; slot 2
    free) and the batch of one decode step: lanes [0, 1, 0], the last one
    padding."""
    jcfg, _ = cfgs
    jp, _ = params
    rng = np.random.default_rng(2)
    kv = JKV.paged_kv_init(jcfg, num_pages=12, page_size=4, max_reqs=3,
                           max_pages_per_req=4)
    for slot, plen in ((0, 7), (1, 8)):
        toks = rng.integers(1, jcfg.vocab_size, (1, plen)).astype(np.int32)
        kv, _ = JKV.admit_requests(kv, jnp.asarray([slot], jnp.int32),
                                   jnp.asarray([plen], jnp.int32),
                                   jnp.ones((1,), bool))
        _, caches, _ = JM.prefill(jp, jcfg, jnp.asarray(toks), cache_len=plen)
        kv = JKV.write_prefill(kv, slot, caches[0]["k"][:, 0],
                               caches[0]["v"][:, 0])
    slots = jnp.asarray([0, 1, 0], jnp.int32)
    mask = jnp.asarray([True, True, False])
    kv, _ = JKV.grow_for_decode(kv, slots, mask)
    toks = rng.integers(1, jcfg.vocab_size, (3, 1)).astype(np.int32)
    return kv, np.array(slots), np.array(mask), toks


@pytest.mark.parametrize("use_kernel", [False, True])
def test_paged_decode_step_matches_reference(cfgs, params, decode_state,
                                             use_kernel):
    (jcfg, tcfg), (jp, tp) = cfgs, params
    jkv, slots, mask, toks = decode_state
    tkv = paged_kv_from_jax(jax.tree.map(np.asarray, jkv), DEV)
    jl, jkv2 = jax.jit(lambda p, kv: j_decode(
        p, jcfg, jnp.asarray(toks), jnp.asarray(slots), kv,
        jnp.asarray(mask), use_kernel=use_kernel))(jp, jkv)
    tl, tkv2 = paged_decode_step(tp, tcfg, torch.from_numpy(toks),
                                 torch.from_numpy(slots), tkv,
                                 torch.from_numpy(mask), mode="torch")
    assert tkv2.k is tkv.k                         # updated in place
    n = int(mask.sum())                            # active lanes only
    np.testing.assert_allclose(np.asarray(jl)[:n], _np(tl)[:n], atol=1e-4,
                               rtol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(np.asarray(getattr(jkv2, name)),
                                   _np(getattr(tkv2, name)), atol=1e-5,
                                   rtol=1e-5)
    assert np.argmax(np.asarray(jl)[:n], -1).tolist() == \
        torch.argmax(tl[:n], -1).tolist()


def test_masked_lane_writes_nothing(cfgs, params, decode_state):
    (_, tcfg), (_, tp) = cfgs, params
    jkv, slots, _, toks = decode_state
    tkv = paged_kv_from_jax(jax.tree.map(np.asarray, jkv), DEV)
    before_k, before_v = tkv.k.clone(), tkv.v.clone()
    mask = torch.tensor([True, False, False])      # slot 1 masked out
    paged_decode_step(tp, tcfg, torch.from_numpy(toks),
                      torch.from_numpy(slots), tkv, mask)
    pos = int(tkv.lengths[0]) - 1
    pid0 = int(tkv.block_tables[0, pos // 4])
    changed = (tkv.k != before_k).nonzero()
    assert changed.numel() and set(changed[:, 1].tolist()) == {pid0}
    assert set(changed[:, 2].tolist()) == {pos % 4}
    assert torch.equal((tkv.v != before_v).nonzero()[:, :3].unique(dim=0),
                       changed[:, :3].unique(dim=0))


def test_gpu_mode_refuses_cpu_tensors(cfgs, params, decode_state):
    (_, tcfg), (_, tp) = cfgs, params
    jkv, slots, mask, toks = decode_state
    tkv = paged_kv_from_jax(jax.tree.map(np.asarray, jkv), DEV)
    with pytest.raises(RuntimeError, match="gpu"):
        paged_decode_step(tp, tcfg, torch.from_numpy(toks),
                          torch.from_numpy(slots), tkv,
                          torch.from_numpy(mask), mode="gpu")
    eng = Engine(tcfg, tp, max_reqs=1, num_pages=8, page_size=4,
                 max_pages_per_req=4, device=DEV, exec_mode="gpu")
    with pytest.raises(RuntimeError, match="gpu"):
        eng.submit(Request(req_id=0, prompt=np.arange(1, 6), max_new=2))
        eng.step()


# ---------------------------------------------------------------------------
# the engine end to end
# ---------------------------------------------------------------------------

class JRef:
    """The reference's contiguous greedy decode (`M.prefill` +
    `M.decode_step`), jitted once per prompt length."""

    def __init__(self, jcfg, jp, cache_len=64):
        self.cfg, self.p, self.cache_len = jcfg, jp, cache_len
        self.decode = jax.jit(lambda p, t, pos, c: JM.decode_step(
            p, jcfg, t, pos, c))

    @functools.lru_cache(maxsize=None)
    def _prefill(self, plen):
        return jax.jit(lambda p, t: JM.prefill(p, self.cfg, t,
                                               cache_len=self.cache_len))

    def __call__(self, prompt, n):
        toks = jnp.asarray(prompt, jnp.int32)[None]
        lg, caches, _ = self._prefill(len(prompt))(self.p, toks)
        out = [int(jnp.argmax(lg[0, -1]))]
        for t in range(len(prompt), len(prompt) + n - 1):
            lg, caches = self.decode(self.p, jnp.asarray([[out[-1]]],
                                                         jnp.int32),
                                     jnp.asarray([t], jnp.int32), caches)
            out.append(int(jnp.argmax(lg[0, 0])))
        return out


@pytest.fixture(scope="module")
def jref(cfgs, params):
    return JRef(cfgs[0], params[0])


def test_engine_matches_contiguous_reference(cfgs, params, jref):
    (_, tcfg), (_, tp) = cfgs, params
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, tcfg.vocab_size, n) for n in (8, 12, 8, 16)]
    eng = Engine(tcfg, tp, max_reqs=3, num_pages=48, page_size=8,
                 max_pages_per_req=8, device=DEV)
    for i, pr in enumerate(prompts):
        eng.submit(Request(req_id=i, prompt=pr, max_new=5, priority=0))
    outs = eng.run(max_steps=64)
    for i, pr in enumerate(prompts):
        assert outs[i] == jref(pr, 5), f"request {i} diverged"
    assert int(eng.kv.pool.num_free()) == 48       # every page recycled
    m = eng.metrics()
    assert tuple(m) == obs.SERVING_SCHEMA
    assert m["ring_depth"] == 0
    assert m["decode_steps"] == eng.steps > 0
    assert m["decode_tokens"] == sum(len(o) for o in outs.values()) - 4
    assert 0.0 < m["batch_fill"] <= 1.0
    assert m["prefix_lookups"] >= m["prefix_hits"] >= 0
    assert (m["prefix_hit_rate"] == 0.0 if not m["prefix_lookups"]
            else abs(m["prefix_hit_rate"]
                     - m["prefix_hits"] / m["prefix_lookups"]) < 1e-12)
    rm = eng.resilience_metrics()
    assert set(rm) == set(obs.METRICS_SCHEMA) and rm["pops"] == 4


def test_engine_shared_prefix_pages(cfgs, params, jref):
    (_, tcfg), (_, tp) = cfgs, params
    rng = np.random.default_rng(3)
    base = rng.integers(1, tcfg.vocab_size, 24)
    pA = base.copy()
    pB = np.concatenate([base[:16], rng.integers(1, tcfg.vocab_size, 8)])
    eng = Engine(tcfg, tp, max_reqs=3, num_pages=32, page_size=8,
                 max_pages_per_req=8, device=DEV)
    for i, pr in enumerate([pA, pA, pB]):
        eng.submit(Request(req_id=i, prompt=pr, max_new=5))
    while not all(r.done for r in eng.requests.values()):
        eng.step()
    outs = {r.req_id: r.out for r in eng.requests.values()}
    assert eng.prefix_hits >= 4          # the repeat: 2 pages; pB's prefix: 2
    assert outs[0] == jref(pA, 5) and outs[1] == outs[0]
    assert outs[2] == jref(pB, 5)
    assert int(eng.kv.pool.num_free()) == 32


def test_engine_recycled_pages_miss(cfgs, params, jref):
    (_, tcfg), (_, tp) = cfgs, params
    rng = np.random.default_rng(4)
    p = rng.integers(1, tcfg.vocab_size, 16)
    eng = Engine(tcfg, tp, max_reqs=1, num_pages=16, page_size=8,
                 max_pages_per_req=8, device=DEV)
    for rid in (0, 1):
        eng.submit(Request(req_id=rid, prompt=p, max_new=3))
        while not all(r.done for r in eng.requests.values()):
            eng.step()
    outs = {r.req_id: r.out for r in eng.requests.values()}
    assert eng.prefix_hits == 0          # recycled -> stale -> safe miss
    assert outs[0] == outs[1] == jref(p, 3)


def test_engine_fault_paths_not_ported(cfgs, params):
    """Kept under its old name: the fault paths are ported, and both
    `resilient=True` and a fault plan give the journaled scheduler
    (`tests/test_torch_resilience.py` drives a faulted trace)."""
    (_, tcfg), (_, tp) = cfgs, params
    for kw in (dict(resilient=True), dict(fault_plan=FaultPlan(0, []))):
        eng = Engine(tcfg, tp, device=DEV, **kw)
        assert eng.sched.res is not None and len(eng.sched.res.journal) == 0
    assert Engine(tcfg, tp, device=DEV).sched.res is None


# ---------------------------------------------------------------------------
# degradation paths on traces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(seed=0, n_requests=24, page_size=8),
    dict(seed=6, n_requests=6, page_size=8, overload_at=0, overload_n=6),
    dict(seed=7, n_requests=8, page_size=8, deadline_frac=0.6,
         deadline_slack=(1, 2)),
    dict(seed=0, n_requests=64, page_size=16, vocab=151936, n_prefixes=8,
         prefix_pages=(8, 16, 32), suffix_lens=(16, 128, 512),
         max_new=(32, 64), inversion_every=6),
])
def test_make_trace_matches_reference(kw):
    a, b = jtraffic.make_trace(**kw), traffic.make_trace(**kw)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.req_id, x.arrival, x.max_new, x.priority, x.deadline) == \
            (y.req_id, y.arrival, y.max_new, y.priority, y.deadline)
        assert np.array_equal(x.prompt, y.prompt)


def test_traffic_knobs_off_draw_nothing():
    base = traffic.make_trace(seed=5, n_requests=8, page_size=8)
    again = traffic.make_trace(seed=5, n_requests=8, page_size=8,
                               deadline_frac=0.0, overload_n=0)
    assert len(base) == len(again)
    for a, b in zip(base, again):
        assert (a.req_id, a.arrival, a.max_new, a.priority, a.deadline) == \
            (b.req_id, b.arrival, b.max_new, b.priority, b.deadline)
        assert (a.prompt == b.prompt).all() and a.deadline == -1


def test_deadline_expiry_lazy(params):
    _, tp = params
    cfg = get_reduced(ARCH)                         # bf16 compute
    rng = np.random.default_rng(11)
    eng = Engine(cfg, tp, max_reqs=1, num_pages=16, page_size=8,
                 max_pages_per_req=4, device=DEV)
    # A holds the only slot for 6 steps; B's 1-tick deadline expires while
    # it waits and is dropped when popped; C has none and completes
    eng.submit(Request(req_id=0, prompt=rng.integers(1, cfg.vocab_size, 8),
                       max_new=6))
    eng.submit(Request(req_id=1, prompt=rng.integers(1, cfg.vocab_size, 8),
                       max_new=3, deadline=1))
    eng.submit(Request(req_id=2, prompt=rng.integers(1, cfg.vocab_size, 8),
                       max_new=3))
    eng.run(max_steps=64)
    a, b, c = (eng.requests[i] for i in range(3))
    assert a.done and len(a.out) == 6 and not a.shed
    assert b.done and b.shed and b.out == []
    assert c.done and len(c.out) == 3 and not c.shed
    assert eng.res["deadline_expired"] == 1
    m = eng.resilience_metrics()
    assert set(m) == set(obs.METRICS_SCHEMA) and m["deadline_expired"] == 1
    tp.load_compute_copy("float32")


def test_backoff_retries_on_pool_exhaustion(params):
    _, tp = params
    cfg = get_reduced(ARCH)
    rng = np.random.default_rng(12)
    # two slots, pages for about one request at a time: the second
    # admission fails allocation, parks, and is retried
    eng = Engine(cfg, tp, max_reqs=2, num_pages=3, page_size=8,
                 max_pages_per_req=3, backoff_base=1, backoff_cap=4,
                 device=DEV)
    for i in range(2):
        eng.submit(Request(req_id=i,
                           prompt=rng.integers(1, cfg.vocab_size, 12),
                           max_new=4))
    eng.run(max_steps=64)
    assert all(r.done and len(r.out) == 4 and not r.shed
               for r in eng.requests.values())
    assert eng.res["retries"] >= 1
    assert max(r.attempts for r in eng.requests.values()) >= 1
    assert int(eng.kv.pool.num_free()) == 3
    tp.load_compute_copy("float32")


def test_overload_shedding_deterministic(cfgs, params):
    (_, tcfg), (_, tp) = cfgs, params
    trace = traffic.make_trace(seed=6, n_requests=6, page_size=8,
                               overload_at=0, overload_n=6)
    assert sum(1 for t in trace if t.arrival == 0 and t.priority == 2) >= 6
    outs, mets, engines = [], [], []
    for _ in range(2):
        eng = Engine(tcfg, tp, max_reqs=2, num_pages=32, page_size=8,
                     max_pages_per_req=4, shed_threshold=3, shed_band=2,
                     device=DEV)
        outs.append(traffic.replay(eng, trace, max_steps=200))
        mets.append(eng.resilience_metrics())
        engines.append(eng)
    assert outs[0] == outs[1] and mets[0] == mets[1]
    assert set(mets[0]) == set(obs.METRICS_SCHEMA) and mets[0]["shed"] > 0
    eng = engines[0]
    shed = [r for r in eng.requests.values() if r.shed]
    assert shed and all(r.out == [] and r.priority == 2 for r in shed)
    for t in trace:                   # urgent work is never shed
        if t.priority == 0:
            r = eng.requests[t.req_id]
            assert not r.shed and len(r.out) == t.max_new
    assert all(r.done for r in eng.requests.values())
    assert int(eng.kv.pool.num_free()) == 32


def test_traffic_deadline_knob_e2e(cfgs, params):
    (_, tcfg), (_, tp) = cfgs, params
    trace = traffic.make_trace(seed=7, n_requests=8, page_size=8,
                               deadline_frac=0.6, deadline_slack=(1, 2))
    assert any(t.deadline >= 0 for t in trace)
    outs, mets = [], []
    for _ in range(2):
        eng = Engine(tcfg, tp, max_reqs=1, num_pages=32, page_size=8,
                     max_pages_per_req=4, device=DEV)
        outs.append(traffic.replay(eng, trace, max_steps=200))
        mets.append((dict(eng.res),
                     {r.req_id: r.shed for r in eng.requests.values()}))
    assert outs[0] == outs[1] and mets[0] == mets[1]
    eng_res, shed_map = mets[0]
    assert eng_res["deadline_expired"] > 0        # one slot: some expire
    by_id = {t.req_id: t for t in trace}
    for rid, shed in shed_map.items():
        assert (len(outs[0][rid]) == 0 if shed
                else len(outs[0][rid]) == by_id[rid].max_new)


def test_ticks_is_replays_loop(cfgs, params):
    """`ticks` yields consecutive ticks, has submitted exactly the arrivals
    due by each one, stops once every request is done, and leaves the same
    tokens as `replay`."""
    (_, tcfg), (_, tp) = cfgs, params
    trace = traffic.make_trace(seed=5, n_requests=6, page_size=8)

    def engine():
        return Engine(tcfg, tp, max_reqs=2, num_pages=48, page_size=8,
                      max_pages_per_req=8, device=DEV)
    eng = engine()
    seen = []
    for t in traffic.ticks(eng, trace, max_steps=200):
        seen.append(t)
        assert len(eng.requests) == sum(r.arrival <= t for r in trace)
    assert seen == list(range(len(seen))) and len(seen) < 200
    assert all(r.done for r in eng.requests.values())
    assert ({r.req_id: list(r.out) for r in eng.requests.values()}
            == traffic.replay(engine(), trace, max_steps=200))


def test_seeded_replay_deterministic_and_inversion(cfgs, params, jref):
    """Two engines replaying one seeded trace give the same tokens, every
    request's tokens equal the contiguous reference's, every page comes
    back, and an urgent request admits no later than same-tick bulk."""
    (_, tcfg), (_, tp) = cfgs, params
    trace = traffic.make_trace(seed=5, n_requests=8, page_size=8)
    assert {t.priority for t in trace} >= {0, 2}
    outs, engines = [], []
    for _ in range(2):
        eng = Engine(tcfg, tp, max_reqs=3, num_pages=64, page_size=8,
                     max_pages_per_req=8, device=DEV)
        outs.append(traffic.replay(eng, trace, max_steps=200))
        engines.append(eng)
    assert outs[0] == outs[1]
    for t in trace:
        assert outs[0][t.req_id] == jref(t.prompt, t.max_new)
    assert int(engines[0].kv.pool.num_free()) == 64
    reqs, checked = engines[0].requests, 0
    for t in trace:
        if t.priority != 0:
            continue
        for b in trace:
            if b.arrival == t.arrival and b.priority == 2:
                assert reqs[t.req_id].admit_step <= reqs[b.req_id].admit_step
                checked += 1
    assert checked > 0
