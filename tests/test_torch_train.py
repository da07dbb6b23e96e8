"""The port's training path against the JAX reference, on the CPU.

The same numpy-seeded inputs go through `repro` and `repro_torch`:
the schedule (steps 0-300, within 1e-7), AdamW on a random tree (params,
m and v within 1e-6 of each leaf's largest |x| and 1e-6 relative
elsewhere, over 3 steps, with and without clipping: the global norm is a
sum in another order, so the clip scale can differ by an ulp), the
cross-entropy (with and without a mask), `grads_of` on reduced
qwen3-1.7b at f32 compute (microbatches 1 and 2), two `make_train_step`
steps and one reduced hymba step in exec mode torch. The reference's
gradient tree has the parameters' structure, so `params_from_jax`
carries it across.

Even at f32 compute both packages round the attention einsums' operands
to bf16, and the gradients through them are rounded to bf16 too. The sums
before each rounding run in another order on each side, so an element
at a rounding boundary can round the other way and move by a bf16 step.
So the gradient tests run twice: with the operands as the packages have
them (`bf16`: loss within 1e-5, each gradient leaf and the grad norm
within 2^-8, one bf16 step, of the leaf's largest |g|; measured: 1.6e-3
at most), and with that rounding switched off on both sides
(`f32_attention_operands`: loss within 1e-5, each gradient leaf within
1e-4 of its largest |g| and the grad norm within 1e-4 relative; measured
1.5e-6). Parameters after a step: within 2 lr, since one Adam step moves
a parameter by at most lr a term, so a sign flip of a near-zero gradient
stays inside. Also the guards: in exec mode gpu the forward-only kernels
refuse inputs that autograd tracks, and a load-time compute copy refuses
to stand in for a parameter that requires grad. Each reference run is one
module-scoped fixture, so no jit is repeated.
"""
import contextlib
import functools

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro  # noqa: F401  (enables x64)
from repro.configs import get_reduced as j_get_reduced
from repro.configs import base as j_base
from repro.data.pipeline import synth_batch as j_synth_batch
from repro.models import common as jcommon
from repro.models import model as JM
from repro.optim import adamw as j_adamw
from repro.optim.schedule import cosine_with_warmup as j_cosine
from repro.train import step as j_step
from repro_torch import exec as exec_
from repro_torch.configs import base as t_base
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import common as tcommon
from repro_torch.models import model as TM
from repro_torch.models import ssm as tssm
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim.schedule import cosine_with_warmup as t_cosine
from repro_torch.train import step as t_step

SHAPE = j_base.ShapeConfig("tiny", seq_len=16, global_batch=4, kind="train")
LR = 3e-4
LOSS_TOL = 1e-5
# gradient leaves and the grad norm, by attention operands (module doc)
GRAD_TOL = {"bf16": 2.0 ** -8, "f32": 1e-4}
OPERANDS = ("bf16", "f32")
# microbatching is held at the tight tolerance
GRAD_CASES = (("bf16", 1), ("f32", 1), ("f32", 2))


@contextlib.contextmanager
def attention_operands(kind: str):
    """`f32`: both packages' attention einsums on unrounded f32 operands
    for the block (the reference's `models.common` sees a `jnp` whose
    bfloat16 is float32; the port's `bf16_einsum` skips its rounding).
    A reference function must be traced inside the block. `bf16`: as the
    packages are."""
    if kind == "bf16":
        yield
        return
    shim = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                    if not k.startswith("__")})
    shim.bfloat16 = jnp.float32
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcommon, "jnp", shim)
        mp.setattr(tcommon, "bf16_einsum",
                   lambda eq, a, b: torch.einsum(eq, a.float(), b.float()))
        yield


def _np(t):
    return t.detach().float().cpu().numpy()


def _batch(cfg, seed=5, step=0):
    jb = j_synth_batch(cfg, SHAPE, seed, step)
    return jb, {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


def _cfgs(arch):
    return (j_get_reduced(arch).replace(compute_dtype="float32"),
            get_reduced(arch).replace(compute_dtype="float32"))


def _port_params(jp, tcfg):
    return params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                           "cpu").make_trainable()


def _grads_close(jgrads, tgrads, tcfg, tol):
    ref = dict(params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg,
                               "cpu").named_parameters())
    assert ref.keys() == tgrads.keys()
    for name, g in tgrads.items():
        want = _np(ref[name])
        scale = max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(_np(g), want, rtol=0, atol=tol * scale,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# configs, schedule, optimizer, loss
# ---------------------------------------------------------------------------

def test_shapes_match_reference():
    assert t_base.SHAPES == {k: t_base.ShapeConfig(*vars(v).values())
                             for k, v in j_base.SHAPES.items()}
    assert t_base.LONG_CONTEXT_OK == j_base.LONG_CONTEXT_OK
    for arch in ("qwen3-1.7b", "hymba-1.5b", "xlstm-1.3b", "paper-kvstore"):
        assert t_base.cells_for(arch) == j_base.cells_for(arch)
    assert t_base.SHAPES["train_4k"].is_decode is False
    assert get_reduced("qwen3-1.7b").remat is True


@pytest.mark.parametrize("warmup,total", [(100, 10000), (100, 300), (0, 300),
                                          (300, 300)])
def test_cosine_with_warmup_matches_reference(warmup, total):
    steps = np.arange(301, dtype=np.int32)
    want = np.asarray(j_cosine(jnp.asarray(steps), peak_lr=LR,
                               warmup_steps=warmup, total_steps=total))
    got = t_cosine(torch.from_numpy(steps), peak_lr=LR, warmup_steps=warmup,
                   total_steps=total)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-7)


TREE = {"w": (8, 16), "b": (16,), "e": (33, 8), "s": ()}


@pytest.mark.parametrize("grad_scale", [1e-2, 10.0], ids=["unclipped",
                                                          "clipped"])
def test_adamw_update_matches_reference(grad_scale):
    rng = np.random.default_rng(int(grad_scale * 100))
    p0 = {k: np.asarray(rng.standard_normal(s), np.float32) for k, s in
          TREE.items()}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js = j_adamw.adamw_init(jp)
    ts = t_adamw.adamw_init(tp)
    j_update = jax.jit(j_adamw.adamw_update)
    for step in range(3):
        g = {k: np.asarray(rng.standard_normal(s) * grad_scale, np.float32)
             for k, s in TREE.items()}
        lr = np.float32(1e-2 * (step + 1))
        jp, js, jgn = j_update(
            {k: jnp.asarray(v) for k, v in g.items()}, js, jp,
            jnp.asarray(lr))
        tp, ts, tgn = t_adamw.adamw_update(
            {k: torch.from_numpy(v) for k, v in g.items()}, ts, tp,
            torch.tensor(lr))
        np.testing.assert_allclose(float(tgn), float(jgn), rtol=1e-6)
        for k in TREE:
            for got, want in ((tp[k], jp[k]), (ts["m"][k], js["m"][k]),
                              (ts["v"][k], js["v"][k])):
                want = np.asarray(want)
                np.testing.assert_allclose(
                    _np(got), want, rtol=1e-6,
                    atol=1e-6 * np.abs(want).max(),
                    err_msg=f"{k} at step {step}")
        assert ts["step"].dtype == torch.int32
        assert int(ts["step"]) == int(js["step"]) == step + 1


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(11)
    logits = (rng.standard_normal((3, 7, 37)) * 4).astype(np.float32)
    labels = rng.integers(0, 37, (3, 7)).astype(np.int32)
    mask = None
    if masked:
        mask = (rng.random((3, 7)) < 0.6).astype(np.float32)
        mask[1] = 0.0
    want = JM.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            None if mask is None else jnp.asarray(mask))
    got = TM.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                           None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_cross_entropy_codebooks_not_ported():
    """Kept under its old name: codebook logits [B, S, n_cb, V] against
    labels [B, n_cb, S] are ported, the mean over the codebooks as the
    reference's (tests/test_torch_frontends.py holds them masked too)."""
    rng = np.random.default_rng(13)
    logits = (rng.standard_normal((2, 3, 4, 5)) * 4).astype(np.float32)
    labels = rng.integers(0, 5, (2, 4, 3)).astype(np.int32)
    want = JM.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = TM.cross_entropy(torch.from_numpy(logits),
                           torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# gradients and train steps on reduced qwen3-1.7b
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen():
    jcfg, tcfg = _cfgs("qwen3-1.7b")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp


@pytest.fixture(scope="module")
def ref_grads(qwen):
    jcfg, _, jp = qwen
    jb, _ = _batch(jcfg)
    out = {}
    for kind, mb in GRAD_CASES:
        with attention_operands(kind):
            fn = jax.jit(functools.partial(j_step.grads_of, cfg=jcfg,
                                           microbatches=mb))
            out[kind, mb] = fn(jp, batch=jb)
    return out


@pytest.mark.parametrize("operands,microbatches", GRAD_CASES)
def test_grads_of_matches_reference(qwen, ref_grads, operands, microbatches):
    jcfg, tcfg, jp = qwen
    jgrads, jloss, jaux = ref_grads[operands, microbatches]
    _, tb = _batch(jcfg)
    tp = _port_params(jp, tcfg)
    with attention_operands(operands):
        grads, loss, aux = t_step.grads_of(tp, tcfg, tb, microbatches)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_TOL)
    assert float(aux) == float(jaux) == 0.0
    _grads_close(jgrads, grads, tcfg, GRAD_TOL[operands])


def test_remat_gives_the_same_gradients(qwen):
    jcfg, tcfg, jp = qwen
    _, tb = _batch(jcfg)
    g = {}
    for remat in (True, False):
        cfg = tcfg.replace(remat=remat)
        grads, _, _ = t_step.grads_of(_port_params(jp, cfg), cfg, tb)
        g[remat] = grads
    for name in g[True]:
        torch.testing.assert_close(g[True][name], g[False][name], rtol=0,
                                   atol=0)


def _ref_steps(jcfg, jp, batches, kind):
    with attention_operands(kind):
        step = jax.jit(j_step.make_train_step(jcfg, lr_peak=LR, warmup=1))
        state = {"adam": j_adamw.adamw_init(jp)}
        out = []
        for jb in batches:
            jp, state, m = step(jp, state, jb)
            out.append((jp, {k: float(v) for k, v in m.items()}))
    return out


@pytest.fixture(scope="module")
def ref_train_steps(qwen):
    jcfg, _, jp = qwen
    batches = [_batch(jcfg, 9, s)[0] for s in range(2)]
    return {kind: _ref_steps(jcfg, jp, batches, kind) for kind in OPERANDS}


def _port_steps(tcfg, tp, batches, kind):
    step = t_step.make_train_step(tcfg, lr_peak=LR, warmup=1)
    state = {"adam": t_adamw.adamw_init(tp)}
    out = []
    with attention_operands(kind):
        for tb in batches:
            tp, state, m = step(tp, state, tb)
            out.append(({n: p.detach().clone()
                         for n, p in tp.named_parameters()},
                        {k: float(v) for k, v in m.items()}))
    return out, state


def _step_close(tparams, tm, jp, jm, tcfg, kind):
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=LOSS_TOL)
    np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"],
                               rtol=GRAD_TOL[kind])
    np.testing.assert_allclose(tm["lr"], jm["lr"], rtol=1e-6)
    ref = dict(params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                               "cpu").named_parameters())
    assert ref.keys() == tparams.keys()
    for name, p in tparams.items():
        np.testing.assert_allclose(_np(p), _np(ref[name]), rtol=0,
                                   atol=2 * tm["lr"], err_msg=name)


@pytest.mark.parametrize("operands", OPERANDS)
def test_train_steps_match_reference(qwen, ref_train_steps, operands):
    jcfg, tcfg, jp = qwen
    batches = [_batch(jcfg, 9, s)[1] for s in range(2)]
    tp = _port_params(jp, tcfg)
    runs, state = _port_steps(tcfg, tp, batches, operands)
    for (tparams, tm), (jp2, jm) in zip(runs, ref_train_steps[operands]):
        _step_close(tparams, tm, jp2, jm, tcfg, operands)
    assert int(state["adam"]["step"]) == 2
    assert all(p.grad is None for p in tp.parameters())


def test_pod_compress_is_a_later_slice(qwen):
    """pod_compress was refused until the slice that ported
    `optim/compress.py`; now the step runs on a (2, 2) ("pod", "data")
    mesh and carries each pod's residuals (its parity with the reference
    is `test_torch_compress.py`'s)."""
    from repro_torch.core.routing import ShardMesh
    from repro_torch.optim.compress import compress_state_init
    _, tcfg, jp = qwen
    tp = _port_params(jp, tcfg)
    opt = {"adam": t_adamw.adamw_init(tp),
           "residuals": compress_state_init(tp, 2)}
    step = t_step.make_train_step(tcfg, pod_compress=True,
                                  mesh=ShardMesh(("pod", "data"), (2, 2)))
    tp, opt, m = step(tp, opt, _batch(tcfg)[1])
    assert np.isfinite(float(m["loss"])) and int(opt["adam"]["step"]) == 1
    res = opt["residuals"]
    assert res.keys() == dict(tp.named_parameters()).keys()
    assert all(r.shape[0] == 2 and bool(r.abs().sum() > 0)
               for r in res.values() if r[0].numel() > 1)
    assert all(p.grad is None for p in tp.parameters())


def test_serve_steps_match_forward(qwen):
    _, tcfg, jp = qwen
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        1, tcfg.vocab_size, (2, 9)).astype(np.int32))
    with torch.no_grad():
        full, _ = TM.forward(tp, tcfg, toks)
    last, caches = t_step.make_serve_prefill(tcfg, 16)(tp, {"tokens":
                                                          toks[:, :8]})
    torch.testing.assert_close(last, full[:, 7], rtol=1e-4, atol=1e-4)
    pos = torch.full((2,), 8, dtype=torch.int32)
    nxt, _ = t_step.make_serve_decode(tcfg)(tp, toks[:, 8:], pos, caches)
    torch.testing.assert_close(nxt, full[:, 8], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# hymba: one reduced step in exec mode torch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hymba_ref():
    jcfg, tcfg = _cfgs("hymba-1.5b")
    jp = JM.init_params(jax.random.PRNGKey(1), jcfg)
    return jcfg, tcfg, jp, _ref_steps(jcfg, jp, [_batch(jcfg, 4)[0]],
                                      "f32")[0]


def test_hymba_train_step_matches_reference(hymba_ref):
    jcfg, tcfg, jp, (jp2, jm) = hymba_ref
    with exec_.exec_mode("torch"):
        runs, _ = _port_steps(tcfg, _port_params(jp, tcfg),
                              [_batch(jcfg, 4)[1]], "f32")
    _step_close(*runs[0], jp2, jm, tcfg, "f32")


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def _flash_under_grad():
    q = torch.randn(1, 8, 4, 16, requires_grad=True)
    k = torch.randn(1, 8, 2, 16)
    tcommon.attend_causal(q, k, k.clone(), impl="xla_flash")


def _scan_under_grad():
    cfg = get_reduced("hymba-1.5b")
    p = tssm.init_mamba(torch.Generator("cpu").manual_seed(0), cfg)
    p.make_trainable()
    tssm.mamba_forward(p, cfg, torch.randn(1, 8, cfg.d_model))


@pytest.mark.parametrize("kernel,fn", [("flash_attention", _flash_under_grad),
                                       ("selective_scan", _scan_under_grad)])
def test_gpu_mode_refuses_autograd_through_forward_only_kernels(kernel, fn):
    """flash_attention has no backward kernel and refuses autograd; the
    selective scan has one (`selective_scan_bwd`), so under autograd its
    call reaches the kernel's check for CUDA tensors."""
    with exec_.exec_mode("gpu"):
        if kernel == "selective_scan":
            with pytest.raises(RuntimeError, match="needs CUDA tensors"):
                fn()
        else:
            with pytest.raises(NotImplementedError,
                               match=f"{kernel} CUDA kernel is forward-only"):
                fn()
        # without autograd the same call reaches the kernel, which needs
        # CUDA tensors
        with torch.no_grad(), pytest.raises(RuntimeError,
                                            match="needs CUDA tensors"):
            fn()


def test_stale_compute_copy_guard(qwen):
    jcfg, tcfg, jp = qwen
    _, tb = _batch(jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    tp.load_compute_copy("bfloat16")
    cfg = tcfg.replace(compute_dtype="bfloat16")
    for p in tp.parameters():
        p.requires_grad_(True)
    with pytest.raises(RuntimeError, match="make_trainable"):
        t_step.loss_fn(tp, cfg, tb)
    with torch.no_grad():               # inference still reads the copy
        t_step.loss_fn(tp, cfg, tb)
    tp.make_trainable()
    assert all(not m._compute for m in tp.modules() if hasattr(m, "_compute"))
    grads, _, _ = t_step.grads_of(tp, cfg, tb)
    assert all(torch.isfinite(g).all() for g in grads.values())
