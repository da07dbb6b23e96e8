"""The port's MoE family against the JAX reference, on the reduced configs
of llama4-scout-17b-a16e (4 experts, top-1, a shared expert) and
qwen3-moe-235b-a22b (8 experts, top-2, renormalised), all on the CPU (exec
mode `torch`). The reference's parameters cross over with
`convert.params_from_jax`.

* `router_probs`: the same experts (ties to the lower index) and weights
  within 1e-6;
* `moe_dense_ffn` at f32 compute (y within 2e-5, aux within 1e-6, the
  same dropped lanes) and bf16 (y within 2 bf16 steps of max |y|), and a
  capacity-starved case (capacity factor 0.5, a router that sends every
  token to one expert) that holds the drop order;
* the simulated `moe_replicated_psum` and `moe_routed_a2a` under
  `use_mesh` against the reference's `blocks._moe_sharded` on a (2, 4)
  ("data", "model") mesh of 8 fake CPU devices, in one subprocess that
  saves its results as an `.npz` (the subprocess sets XLA_FLAGS itself;
  `_moe_sharded` is called directly: the reference's `_ffn_apply` fails
  at its reshape under the installed jax for "routed_a2a", ROADMAP.md §3);
* the moe block's forward, prefill (with and without a prefix `past`) and
  decode, and the model's `forward`, at f32 compute within 2e-5;
* `paged_decode_step` against the reference's with `use_kernel=False`,
  the engine's tokens against the reference's contiguous `prefill` +
  `decode_step` (a shared prefix included), one `train_step`, and the
  serving launcher;
* the one deliberate divergence: on one device under `moe_impl=
  "routed_a2a"` the reference's `_ffn_apply` adds the shared expert twice,
  the port once.
"""
import functools
import io
import os
import subprocess
import sys
import textwrap
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro  # noqa: F401  (enables x64)
from repro.configs import base as j_base
from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.core.routing import bucketize as j_bucketize
from repro.data.pipeline import synth_batch as j_synth_batch
from repro.models import blocks as JB
from repro.models import mlp as jmlp
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.optim import adamw as j_adamw
from repro.serving import kvcache as JKV
from repro.serving.paged_decode import paged_decode_step as j_decode
from repro.train import step as j_step
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import paged_kv_from_jax, params_from_jax
from repro_torch.core.routing import ShardMesh
from repro_torch.launch import serve
from repro_torch.models import blocks as TB
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.models.mlp import mlp
from repro_torch.optim import adamw as t_adamw
from repro_torch.parallel.sharding import use_mesh
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.paged_decode import paged_decode_step
from repro_torch.store import exec as t_exec
from repro_torch.train import step as t_step

ROOT = Path(__file__).resolve().parents[1]
DEV = "cpu"
ARCHS = ("llama4-scout-17b-a16e", "qwen3-moe-235b-a22b")
TOL = 2e-5            # f32 compute
AUX_TOL = 1e-6
BF16_STEPS = 2        # bf16 compute: steps of max |y|
T_TOKENS = 64         # the dispatch tests' tokens (8 a shard on 8 shards)
T_STARVED = 256       # 32 a shard: every bucketing overflows
STARVED_EXPERT = 2
MESH_SIZES = (2, 4)
IMPLS = ("replicated_psum", "routed_a2a")
SHARDED_CASES = (("float32", "default"), ("bfloat16", "default"),
                 ("float32", "starved"))


@pytest.fixture(autouse=True)
def _torch_mode():
    with t_exec.exec_mode("torch"):
        yield


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _close(want, got, tol=TOL):
    want, got = _np(want), _np(got)
    assert want.shape == got.shape, (want.shape, got.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _bf16_close(want, got):
    want, got = _np(want), _np(got)
    big = float(np.abs(want).max())
    step = 2.0 ** (np.floor(np.log2(big)) - 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_STEPS * step)


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(jcfg, tcfg, reference params, port params) at f32 compute."""
    jcfg = j_get_reduced(arch).replace(compute_dtype="float32")
    tcfg = get_reduced(arch).replace(compute_dtype="float32")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                           tcfg, DEV)


def _layer0(jp):
    return jax.tree.map(lambda a: a[0], jp["blocks"][0])


def _x(seed, t, d, starved=False):
    x = np.random.default_rng(seed).standard_normal((t, d)).astype(np.float32)
    if starved:
        x[:, 0] = 3.0
    return x


def _starved_router(router):
    """Every token's first choice is STARVED_EXPERT (with `_x(starved=True)`
    its logit is 6 above the others' ~0.1 spread)."""
    r = np.array(router, np.float32, copy=True)
    r[0, :] = 0.0
    r[0, STARVED_EXPERT] = 2.0
    return r


def _ffn_pair(arch, router=None):
    """Layer 0's FFN params, the reference's and the port's."""
    jcfg, tcfg, jp, tp = _models(arch)
    jf = dict(_layer0(jp)["ffn"])
    tf = tp.blocks[0].ffn
    if router is not None:
        jf["router"] = jnp.asarray(router)
        shared = {"shared": tf.shared} if "shared" in jf else {}
        tf = tmoe.MoE(router=torch.from_numpy(router), wi=tf.wi.data,
                      wu=tf.wu.data, wd=tf.wd.data, **shared)
    return jf, tf


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, which):
    j = j_get_config(arch) if which == "full" else j_get_reduced(arch)
    t = get_config(arch) if which == "full" else get_reduced(arch)
    for name in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                 "vocab_size", "head_dim", "rope_theta", "qk_norm",
                 "n_experts", "n_experts_active", "d_expert",
                 "n_shared_experts", "norm_topk_prob", "moe_impl",
                 "moe_capacity_factor", "vocab_pad_to", "family",
                 "tie_embeddings", "compute_dtype", "param_dtype"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.is_moe and TB.block_kinds(t) == ["moe"]


# ---------------------------------------------------------------------------
# router and the one-shard dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_router_probs_matches_reference(arch):
    jcfg, tcfg, _, _ = _models(arch)
    jf, tf = _ffn_pair(arch)
    x = _x(1, T_TOKENS, tcfg.d_model)
    router = jax.jit(lambda p, x: jmoe.router_probs(p, jcfg, x))
    jw, ji, ja = router(jf, jnp.asarray(x))
    tw, ti, ta = tmoe.router_probs(tf, tcfg, torch.from_numpy(x))
    assert np.array_equal(np.asarray(ji), ti.numpy())
    _close(jw, tw, 1e-6)
    _close(ja, ta, AUX_TOL)
    # all logits equal: every token takes the k lowest expert ids
    zero = np.zeros_like(_np(tf.router))
    jf2, tf2 = _ffn_pair(arch, zero)
    _, ji2, _ = router(jf2, jnp.asarray(x))
    _, ti2, _ = tmoe.router_probs(tf2, tcfg, torch.from_numpy(x))
    k = tcfg.n_experts_active
    assert np.array_equal(np.asarray(ji2), ti2.numpy())
    assert (ti2.numpy() == np.arange(k)).all()


def _reference_drops(jf, jcfg, x):
    """The reference's dropped lanes in `moe_dense_ffn`: its own
    `bucketize` on its own routes and capacity."""
    t, k, e = x.shape[0], jcfg.n_experts_active, jcfg.n_experts

    def drops(p, x):
        dest = jmoe.router_probs(p, jcfg, x)[1].reshape(-1)
        return j_bucketize(dest, jnp.ones_like(dest, bool), [dest], e,
                           max(1, int(2 * t * k / e) + 8))[2]
    return int(jax.jit(drops)(jf, x))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dense_ffn_matches_reference(arch, dtype):
    jcfg, tcfg, _, _ = _models(arch)
    jcfg, tcfg = (c.replace(compute_dtype=dtype) for c in (jcfg, tcfg))
    jf, tf = _ffn_pair(arch)
    x = _x(2, T_TOKENS, tcfg.d_model)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jy, ja = jax.jit(lambda p, x: jmoe.moe_dense_ffn(p, jcfg, x))(jf, jx)
    ty, ta, td = tmoe.moe_dense_ffn(tf, tcfg, tx, return_dropped=True)
    assert ty.dtype == tx.dtype
    (_close if dtype == "float32" else _bf16_close)(jy, ty)
    _close(ja, ta, AUX_TOL)
    assert int(td.sum()) == _reference_drops(jf, jcfg, jx)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_starved_matches_reference(arch):
    jcfg, tcfg, _, _ = _models(arch)
    jcfg, tcfg = (c.replace(moe_capacity_factor=0.5) for c in (jcfg, tcfg))
    jf, tf = _ffn_pair(arch, _starved_router(_np(_models(arch)[3]
                                                 .blocks[0].ffn.router)))
    x = _x(3, T_STARVED, tcfg.d_model, starved=True)
    _, ti, _ = tmoe.router_probs(tf, tcfg, torch.from_numpy(x))
    assert (ti[:, 0] == STARVED_EXPERT).all()
    jy, ja = jax.jit(lambda p, x: jmoe.moe_dense_ffn(p, jcfg, x))(
        jf, jnp.asarray(x))
    ty, ta, td = tmoe.moe_dense_ffn(tf, tcfg, torch.from_numpy(x),
                                    return_dropped=True)
    assert int(td.sum()) == _reference_drops(jf, jcfg, jnp.asarray(x)) > 0
    # a token with every lane dropped gets the shared expert only
    gone = td == tcfg.n_experts_active
    tx = torch.from_numpy(x)
    base = (mlp(tf.shared, tx, tcfg.compute_dtype) if tcfg.n_shared_experts
            else torch.zeros_like(tx))
    assert td.shape == (T_STARVED,)
    assert bool(gone.any()) or tcfg.n_experts_active > 1
    assert torch.equal(ty[gone], base[gone])
    _close(jy, ty)
    _close(ja, ta, AUX_TOL)


# ---------------------------------------------------------------------------
# the expert-parallel dispatches against the reference's shard_map
# ---------------------------------------------------------------------------

PROG = textwrap.dedent('''
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax, jax.numpy as jnp
    jax.config.update("jax_disable_most_optimizations", True)  # compile time
    from jax.sharding import Mesh
    import repro
    from repro.configs import get_reduced
    from repro.models.blocks import _moe_sharded
    from repro.parallel.sharding import use_mesh

    ins = dict(np.load(sys.argv[1]))
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
    out = {}
    for case in sorted({k.split("/")[0] for k in ins if "|" in k}):
        arch, impl, dtype, kind = case.split("|")
        cfg = get_reduced(arch).replace(
            compute_dtype=dtype, moe_impl=impl,
            moe_capacity_factor=0.5 if kind == "starved" else 2.0)
        p = {"router": ins[case + "/router"]}
        for name in ("wi", "wu", "wd"):
            p[name] = ins[arch + "/" + name]
        if cfg.n_shared_experts:
            p["shared"] = {n: ins[arch + "/shared/" + n]
                           for n in ("wi", "wu", "wd")}
        p = jax.tree.map(jnp.asarray, p)
        x = jnp.asarray(ins[case + "/x"]).astype(dtype)
        with use_mesh(mesh):
            y, aux = jax.jit(lambda p, x: _moe_sharded(p, cfg, x, impl))(p, x)
        out[case + "/y"] = np.asarray(y.astype(jnp.float32))
        out[case + "/aux"] = np.asarray(aux, np.float32)
    np.savez(sys.argv[2], **out)
''')


def _case_inputs(arch, kind):
    """(router, x) of one sharded case."""
    _, tcfg, _, tp = _models(arch)
    router = _np(tp.blocks[0].ffn.router)
    if kind == "starved":
        return _starved_router(router), _x(5, T_STARVED, tcfg.d_model, True)
    return router, _x(4, T_TOKENS, tcfg.d_model)


@pytest.fixture(scope="module")
def sharded_reference(tmp_path_factory):
    """The one reference subprocess: every sharded case on 8 fake
    devices."""
    tmp = tmp_path_factory.mktemp("moe")
    ins = {}
    for arch in ARCHS:
        ffn = _layer0(_models(arch)[2])["ffn"]
        for name in ("wi", "wu", "wd"):
            ins[f"{arch}/{name}"] = np.asarray(ffn[name])
        for name, v in ffn.get("shared", {}).items():
            ins[f"{arch}/shared/{name}"] = np.asarray(v)
        for impl in IMPLS:
            for dtype, kind in SHARDED_CASES:
                case = f"{arch}|{impl}|{dtype}|{kind}"
                ins[case + "/router"], ins[case + "/x"] = _case_inputs(arch,
                                                                       kind)
    np.savez(tmp / "in.npz", **ins)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", PROG, str(tmp / "in.npz"),
                          str(tmp / "ref.npz")], env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return dict(np.load(tmp / "ref.npz"))


@pytest.mark.parametrize("dtype,kind", SHARDED_CASES)
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_dispatch_matches_reference(sharded_reference, arch, impl,
                                            dtype, kind):
    _, tcfg, _, _ = _models(arch)
    tcfg = tcfg.replace(compute_dtype=dtype, moe_impl=impl,
                        moe_capacity_factor=0.5 if kind == "starved"
                        else 2.0)
    router, x = _case_inputs(arch, kind)
    _, tf = _ffn_pair(arch, router)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    with use_mesh(ShardMesh(("data", "model"), MESH_SIZES)):
        y, aux = TB._moe_sharded(tf, tcfg, tx, impl)
    case = f"{arch}|{impl}|{dtype}|{kind}"
    (_close if dtype == "float32" else _bf16_close)(
        sharded_reference[case + "/y"], y)
    _close(sharded_reference[case + "/aux"], aux, AUX_TOL)
    if kind == "starved":       # the drop order is what the outputs hold
        dp, tp = MESH_SIZES
        xs = tx.reshape(dp, 1, -1, tcfg.d_model).expand(dp, tp, -1, -1)
        fn = tmoe.moe_replicated_psum
        if impl == "routed_a2a":
            xs, fn = tx.reshape(dp, tp, -1, tcfg.d_model), tmoe.moe_routed_a2a
        drops = fn(tf, tcfg, xs, return_dropped=True)[2]
        assert int(drops.sum()) > 0
        # a token with every lane dropped gets nothing from the experts
        gone = (drops == tcfg.n_experts_active).reshape(-1)
        assert bool((y[gone] == 0).all())


@pytest.mark.parametrize("t", [5, 13])
@pytest.mark.parametrize("arch", ARCHS)
def test_routed_a2a_pads_a_token_count_that_does_not_split(arch, t):
    """A token count that does not divide over the 8 shards (the reference
    refuses it): the live tokens' outputs are the one-shard dispatch's
    (the shared expert taken out, nothing dropped on either side), and
    aux is the mean, over the shards holding a live token, of the
    reference's Switch loss over that shard's live tokens."""
    jcfg, tcfg, _, _ = _models(arch)
    tcfg = tcfg.replace(moe_impl="routed_a2a")
    jf, tf = _ffn_pair(arch)
    x = _x(11 + t, t, tcfg.d_model)
    tx = torch.from_numpy(x)
    with use_mesh(ShardMesh(("data", "model"), MESH_SIZES)):
        y, aux = TB._moe_sharded(tf, tcfg, tx, "routed_a2a")
    want, _, drops = tmoe.moe_dense_ffn(tf, tcfg, tx, return_dropped=True)
    if tcfg.n_shared_experts:
        want = want - mlp(tf.shared, tx, tcfg.compute_dtype)
    assert int(drops.sum()) == 0
    _close(want, y)
    dp, tp = MESH_SIZES
    per = -(-t // (dp * tp))
    xp = torch.cat([tx, tx.new_zeros(dp * tp * per - t, tcfg.d_model)])
    _, _, dropped = tmoe.moe_routed_a2a(
        tf, tcfg, xp.reshape(dp, tp, per, -1), return_dropped=True,
        n_valid=t)
    assert int(dropped.reshape(-1)[:t].sum()) == 0
    router = jax.jit(lambda p, x: jmoe.router_probs(p, jcfg, x)[2])
    shards = [x[i:i + per] for i in range(0, t, per)]
    assert len(shards) < dp * tp            # a shard holds padding only
    _close(np.mean([float(router(jf, jnp.asarray(c))) for c in shards]),
           aux, AUX_TOL)


# ---------------------------------------------------------------------------
# blocks and the model
# ---------------------------------------------------------------------------

B, S, S_PAST, CACHE = 2, 8, 8, 24


def _block_inputs(tcfg, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    return x, np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()


def _shift(pos, by):
    return pos + np.int32(by)


@pytest.mark.parametrize("entry", ["forward", "prefill", "prefill_past",
                                   "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_reference(arch, entry):
    jcfg, tcfg, jp, tp = _models(arch)
    jb, tb = _layer0(jp), tp.blocks[0]
    x, pos = _block_inputs(tcfg, 6)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
    prefill = jax.jit(lambda p, x, pos, past: JB.block_prefill(
        p, jcfg, "moe", x, pos, CACHE, 0, past=past))
    if entry == "forward":
        jy, ja = jax.jit(lambda p, x, pos: JB.block_forward(
            p, jcfg, "moe", x, pos, 0))(jb, jx, jpos)
        ty, ta = TB.block_forward(tb, tcfg, "moe", tx, tpos, 0)
        _close(jy, ty)
        _close(ja, ta, AUX_TOL)
        return
    jy, jc, ja = prefill(jb, jx, jpos, None)
    ty, tc, ta = TB.block_prefill(tb, tcfg, "moe", tx, tpos, CACHE, 0)
    if entry == "prefill_past":
        x2, _ = _block_inputs(tcfg, 7)
        pos2 = _shift(pos, S_PAST)
        jpast = {n: jc[n][:, :S_PAST] for n in ("k", "v")}
        tpast = {n: tc[n][:, :S_PAST] for n in ("k", "v")}
        jy, jc, ja = prefill(jb, jnp.asarray(x2), jnp.asarray(pos2), jpast)
        ty, tc, ta = TB.block_prefill(tb, tcfg, "moe", torch.from_numpy(x2),
                                      torch.from_numpy(pos2), CACHE, 0,
                                      past=tpast)
    if entry == "decode":
        x1 = np.random.default_rng(8).standard_normal(
            (B, 1, tcfg.d_model)).astype(np.float32)
        p1 = np.full((B,), S, np.int32)
        jy, jc = jax.jit(lambda p, x, pos, c: JB.block_decode(
            p, jcfg, "moe", x, pos, c, 0))(jb, jnp.asarray(x1),
                                           jnp.asarray(p1), jc)
        ty, tc, ta = TB.block_decode(tb, tcfg, "moe", torch.from_numpy(x1),
                                     torch.from_numpy(p1), tc, 0)
        ja = None                   # the reference's decode drops its aux
        assert float(ta) > 0
    _close(jy, ty)
    for n in ("k", "v"):
        _close(jc[n], tc[n])
    if ja is not None:
        _close(ja, ta, AUX_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    jcfg, tcfg, jp, tp = _models(arch)
    toks = np.random.default_rng(9).integers(1, tcfg.vocab_size, (B, 12))
    jl, ja = jax.jit(lambda p, t: JM.forward(p, jcfg, t))(
        jp, jnp.asarray(toks, jnp.int32))
    tl, ta = TM.forward(tp, tcfg, torch.from_numpy(toks))
    _close(jl, tl)
    _close(ja, ta, AUX_TOL)
    assert float(ta) > 0


# ---------------------------------------------------------------------------
# serving and training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_step_matches_reference(arch):
    """Two prefilled requests and a padding lane, one paged decode step:
    logits within 1e-4 and pools within 1e-5 at f32 compute, as the
    dense family's test holds them."""
    jcfg, tcfg, jp, tp = _models(arch)
    rng = np.random.default_rng(2)
    kv = JKV.paged_kv_init(jcfg, num_pages=12, page_size=4, max_reqs=3,
                           max_pages_per_req=4)
    prefill = jax.jit(lambda p, t: JM.prefill(p, jcfg, t, cache_len=8))
    for slot, plen in ((0, 7), (1, 8)):
        toks = rng.integers(1, jcfg.vocab_size, (1, plen)).astype(np.int32)
        kv, _ = JKV.admit_requests(kv, jnp.asarray([slot], jnp.int32),
                                   jnp.asarray([plen], jnp.int32),
                                   jnp.ones((1,), bool))
        _, caches, _ = prefill(jp, jnp.asarray(np.pad(toks, ((0, 0),
                                                             (0, 8 - plen)))))
        kv = JKV.write_prefill(kv, slot, caches[0]["k"][:, 0, :plen],
                               caches[0]["v"][:, 0, :plen])
    slots = np.array([0, 1, 0], np.int32)
    mask = np.array([True, True, False])
    kv, _ = JKV.grow_for_decode(kv, jnp.asarray(slots), jnp.asarray(mask))
    toks = rng.integers(1, jcfg.vocab_size, (3, 1)).astype(np.int32)
    tkv = paged_kv_from_jax(jax.tree.map(np.asarray, kv), DEV)
    jl, jkv2 = jax.jit(lambda p, kv: j_decode(
        p, jcfg, jnp.asarray(toks), jnp.asarray(slots), kv,
        jnp.asarray(mask), use_kernel=False))(jp, kv)
    tl, tkv2 = paged_decode_step(tp, tcfg, torch.from_numpy(toks),
                                 torch.from_numpy(slots), tkv,
                                 torch.from_numpy(mask))
    _close(np.asarray(jl)[:2], tl[:2], 1e-4)
    for name in ("k", "v"):
        _close(getattr(jkv2, name), getattr(tkv2, name), 1e-5)


class JRef:
    """The reference's contiguous greedy decode (`M.prefill` +
    `M.decode_step`), jitted once per prompt length."""

    def __init__(self, jcfg, jp, cache_len=32):
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


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_contiguous_reference(arch):
    """Every request's tokens equal the reference's contiguous greedy
    decode; the second prompt shares the first's leading page, so its
    prefill runs on the prefix cache's pages (`prefill_with_past`)."""
    jcfg, tcfg, jp, tp = _models(arch)
    rng = np.random.default_rng(1)
    base = rng.integers(1, tcfg.vocab_size, 16)
    prompts = [base, np.concatenate([base[:8], rng.integers(
        1, tcfg.vocab_size, 4)]), rng.integers(1, tcfg.vocab_size, 8)]
    eng = Engine(tcfg, tp, max_reqs=2, num_pages=24, page_size=8,
                 max_pages_per_req=4, device=DEV)
    for i, pr in enumerate(prompts):
        eng.submit(Request(req_id=i, prompt=pr, max_new=4, priority=0))
    outs = eng.run(max_steps=32)
    jref = JRef(jcfg, jp)
    for i, pr in enumerate(prompts):
        assert outs[i] == jref(pr, 4), f"request {i} diverged"
    assert eng.prefix_hits >= 1
    assert int(eng.kv.pool.num_free()) == 24


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One train step: loss and aux within 1e-5 and 1e-6, the grad norm
    within 2^-8 (the attention operands' bf16 rounding, as the dense
    family's train test holds it)."""
    jcfg, tcfg, jp, _ = _models(arch)
    shape = j_base.ShapeConfig("tiny", seq_len=16, global_batch=2,
                               kind="train")
    jb = j_synth_batch(jcfg, shape, 5, 0)
    step = jax.jit(j_step.make_train_step(jcfg, lr_peak=3e-4, warmup=1))
    _, _, jm = step(jp, {"adam": j_adamw.adamw_init(jp)}, jb)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                         DEV).make_trainable()
    tstep = t_step.make_train_step(tcfg, lr_peak=3e-4, warmup=1)
    _, _, tm = tstep(tp, {"adam": t_adamw.adamw_init(tp)},
                     {k: torch.from_numpy(np.array(v)) for k, v in jb.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), rtol=0,
                               atol=AUX_TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=2.0 ** -8)
    assert float(tm["aux"]) > 0


def test_shared_expert_added_once():
    """The port's one deliberate MoE divergence. On one device under
    `moe_impl="routed_a2a"` the reference's `_ffn_apply` falls back to
    `moe_dense_ffn`, which adds the shared expert, and adds it again; the
    port adds it once, equal to the reference's `moe_dense_ffn` (and to
    its paged decode and its mesh path)."""
    arch = "llama4-scout-17b-a16e"
    jcfg, tcfg, _, _ = _models(arch)
    jcfg, tcfg = (c.replace(moe_impl="routed_a2a") for c in (jcfg, tcfg))
    jf, tf = _ffn_pair(arch)
    x = _x(10, 16, tcfg.d_model).reshape(2, 8, -1)
    j_routed, _ = jax.jit(lambda p, x: JB._ffn_apply(p, jcfg, x))(
        jf, jnp.asarray(x))
    j_dense, _ = jax.jit(lambda p, x: jmoe.moe_dense_ffn(p, jcfg, x))(
        jf, jnp.asarray(x.reshape(16, -1)))
    shared = jax.jit(lambda p, x: jmlp.mlp(p, x, jcfg.compute_dtype))(
        jf["shared"], jnp.asarray(x))
    t_y, _ = TB._ffn_apply(tf, tcfg, torch.from_numpy(x))
    assert float(jnp.abs(shared).max()) > 0.5
    _close(np.asarray(j_routed) - _np(t_y), shared)
    _close(np.asarray(j_dense).reshape(x.shape), t_y)
    _close(mlp(tf.shared, torch.from_numpy(x), tcfg.compute_dtype), shared)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher(arch):
    buf = io.StringIO()
    with redirect_stdout(buf):
        serve.main(["--arch", arch, "--device", "cpu", "--requests", "2",
                    "--max-new", "2"])
    assert "served 2 requests / 4 tokens; pool free=64" in buf.getvalue()
