"""The port's int8 error-feedback pod exchange (`repro_torch.optim.compress`)
and `make_train_step(pod_compress=True)` against the JAX reference, on
the CPU.

* `_quant`'s payload and scale, and `pod_allreduce_compressed`'s
  residuals, bit for bit against the reference's run under
  `jax.vmap(..., axis_name="pod")` over the same stacked per-pod
  gradients (no fake devices needed). The exchanged mean is within one
  f32 ulp of the leaf's largest |mean|: the reference sums the P terms
  in `tensordot`'s order, the port in its own.
* Two pod-compressed train steps of reduced qwen3-1.7b (f32 compute) on a
  ("pod",) mesh of 2 against the reference's on 2 fake CPU devices, in
  one subprocess (the device count is fixed when JAX starts), both with
  a warmup of 1 step so that each step moves a parameter by about the
  peak lr: losses within 1e-5; each parameter's change from the shared
  init against the reference's change, every element within 2.5 x the
  lrs summed (an element whose exchanged gradient took the next int8
  level can move by up to about 2 lr a step) and all but 1 in 1,000
  within 1e-2 x the lrs summed; the residuals as the reference
  carries them. A step that applies no exchanged gradient, or applies
  it negated, fails that change check (planted through
  `compress.exchange`). Its `out_specs=P()` returns one array whose shard on
  each device is that device's pod's own error: reading it whole gives
  device 0's, pod 0's. The port keeps each pod's row, so row 0 is held
  against the array read whole and row 1 against device 1's shard.
  Both packages' rounding of the attention operands to bf16 is switched
  off on both sides (as `test_torch_train.py`'s `attention_operands("f32")`
  does), so the gradients agree to ~1e-6 of a leaf's largest |g|; an
  element at a rounding boundary can still take the next int8 level, so
  each residual element is within one quantization step (the port's
  scale s, max |g| / 127) plus 1e-3 s of the reference's, and all but 1
  in 1,000 within 1e-3 s.
"""
import os
import subprocess
import sys
import textwrap
import weakref
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro  # noqa: F401  (enables x64)
from repro.configs import base as j_base
from repro.configs import get_reduced as j_get_reduced
from repro.data.pipeline import synth_batch as j_synth_batch
from repro.models import model as JM
from repro.optim import compress as j_compress
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.routing import ShardMesh
from repro_torch.models import common as tcommon
from repro_torch.optim import compress as t_compress
from repro_torch.optim.adamw import adamw_init
from repro_torch.train import step as t_step

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen3-1.7b"
SHAPE = j_base.ShapeConfig("tiny", seq_len=16, global_batch=4, kind="train")
STEPS = 2
WARMUP = 1            # each step's lr is the peak, 3e-4
CHANGE_TOL = 1e-2     # of the lrs summed, all but 1 in 1,000 elements
CHANGE_MAX = 2.5      # of the lrs summed, every element
N_PODS = 2
SHAPES = {"flat": (1000,), "matrix": (64, 48), "cube": (4, 8, 16)}


def _grads(rng, n_pods):
    """Per-pod gradient trees: a spread of magnitudes, one all-zero leaf
    (scale at its 1e-30 floor) and one constant leaf."""
    out = {n: (rng.standard_normal((n_pods,) + s)
               * 10.0 ** rng.integers(-4, 2)).astype(np.float32)
           for n, s in SHAPES.items()}
    out["zero"] = np.zeros((n_pods, 7), np.float32)
    out["const"] = np.full((n_pods, 5), -0.375, np.float32)
    return out


def _ref_exchange(grads, residuals):
    """The reference's exchange under vmap over the pod axis."""
    fn = jax.vmap(lambda g, r: j_compress.pod_allreduce_compressed(
        g, r, "pod"), axis_name="pod")
    mean, res = fn({k: jnp.asarray(v) for k, v in grads.items()},
                   {k: jnp.asarray(v) for k, v in residuals.items()})
    return ({k: np.asarray(v) for k, v in mean.items()},
            {k: np.asarray(v) for k, v in res.items()})


def _trees(grads, n_pods):
    """The per-pod trees of stacked numpy gradients, as torch tensors."""
    return [{k: torch.from_numpy(v[p]) for k, v in grads.items()}
            for p in range(n_pods)]


@pytest.mark.parametrize("name", list(SHAPES) + ["zero", "const"])
def test_quant_bit_equal(name):
    g = _grads(np.random.default_rng(1), 1)[name][0]
    jq, js = j_compress._quant(jnp.asarray(g))
    tq, ts = t_compress._quant(torch.from_numpy(g))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().tobytes() == np.asarray(js, np.float32).tobytes()


@pytest.mark.parametrize("n_pods", [2, 3])
def test_exchange_matches_reference(n_pods):
    rng = np.random.default_rng(n_pods)
    mesh = ShardMesh(("pod",), (n_pods,))
    res_t = {k: torch.from_numpy(v.copy())
             for k, v in _grads(rng, n_pods).items()}       # nonzero residuals
    res_j = {k: v.numpy().copy() for k, v in res_t.items()}
    for step in range(2):
        grads = _grads(rng, n_pods)
        j_mean, res_j = _ref_exchange(grads, res_j)
        t_mean, res_t = t_compress.pod_allreduce_compressed(
            _trees(grads, n_pods), res_t, mesh)
        for k in grads:
            np.testing.assert_array_equal(res_t[k].numpy(), res_j[k],
                                          err_msg=f"{k} residuals")
            want = j_mean[k][0]           # every pod holds the same mean
            np.testing.assert_array_equal(j_mean[k], np.broadcast_to(
                want, j_mean[k].shape))
            ulp = np.spacing(np.float32(np.abs(want).max()))
            np.testing.assert_allclose(t_mean[k].numpy(), want, rtol=0,
                                       atol=ulp, err_msg=f"{k} step {step}")
            assert t_mean[k].dtype == torch.float32


def test_plain_mean_and_pod_count():
    rng = np.random.default_rng(9)
    mesh = ShardMesh(("pod", "data"), (N_PODS, 4))
    grads = _grads(rng, N_PODS)
    trees = _trees(grads, N_PODS)
    plain = t_compress.pod_allreduce_plain(trees, mesh)
    ref = jax.vmap(lambda g: j_compress.pod_allreduce_plain(g, "pod"),
                   axis_name="pod")({k: jnp.asarray(v)
                                     for k, v in grads.items()})
    for k in grads:
        np.testing.assert_allclose(plain[k].numpy(), np.asarray(ref[k])[0],
                                   rtol=1e-7, atol=0)
    # a generator, as the train step passes its pods' trees, is the list
    r1 = t_compress.compress_state_init(trees[0], N_PODS)
    r2 = {k: v.clone() for k, v in r1.items()}
    a, _ = t_compress.pod_allreduce_compressed(trees, r1, mesh)
    b, _ = t_compress.pod_allreduce_compressed(iter(trees), r2, mesh)
    for k in grads:
        assert torch.equal(a[k], b[k]) and torch.equal(r1[k], r2[k])
    with pytest.raises(ValueError, match="more than 2 gradient trees"):
        t_compress.pod_allreduce_compressed(trees + trees[:1], r1, mesh)
    with pytest.raises(ValueError, match="1 gradient trees for 2 pods"):
        t_compress.pod_allreduce_compressed(trees[:1], r1, mesh)
    with pytest.raises(ValueError, match="3 gradient trees for 2 pods"):
        t_compress.pod_allreduce_plain(trees + trees[:1], mesh)


PROG = textwrap.dedent('''
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import numpy as np
    import types
    import jax, jax.numpy as jnp
    import repro
    from repro.models import common
    shim = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                    if not k.startswith("__")})
    shim.bfloat16 = jnp.float32
    common.jnp = shim
    from repro.configs import base, get_reduced
    from repro.data.pipeline import synth_batch
    from repro.models import model as M
    from repro.optim.adamw import adamw_init
    from repro.optim.compress import compress_state_init
    from repro.train.step import make_train_step

    arch, steps = sys.argv[1], int(sys.argv[3])
    WARMUP = int(sys.argv[4])
    cfg = get_reduced(arch).replace(compute_dtype="float32")
    shape = base.ShapeConfig("tiny", seq_len=16, global_batch=4,
                             kind="train")
    mesh = jax.make_mesh((2,), ("pod",))
    params = M.init_params(jax.random.PRNGKey(0), cfg)
    opt = {"adam": adamw_init(params),
           "residuals": compress_state_init(params)}
    step = jax.jit(make_train_step(cfg, warmup=WARMUP, pod_compress=True,
                                   mesh=mesh))
    out = {}
    for s in range(steps):
        params, opt, m = step(params, opt, synth_batch(cfg, shape, 5, s))
        out[f"loss/{s}"] = np.asarray(m["loss"])
        out[f"lr/{s}"] = np.asarray(m["lr"])
        for i, p in enumerate(jax.tree.leaves(params)):
            out[f"p/{s}/{i}"] = np.asarray(p)
        for i, r in enumerate(jax.tree.leaves(opt["residuals"])):
            out[f"r0/{s}/{i}"] = np.asarray(r)
            dev1 = [sh for sh in r.addressable_shards
                    if sh.device.id == 1][0]
            out[f"r1/{s}/{i}"] = np.asarray(dev1.data)
    np.savez(sys.argv[2], **out)
''')


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's pod-compressed steps on 2 fake devices."""
    tmp = tmp_path_factory.mktemp("compress")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", PROG, ARCH,
                          str(tmp / "ref.npz"), str(STEPS), str(WARMUP)],
                         env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return dict(np.load(tmp / "ref.npz"))


def _tree(flat: dict, prefix: str, treedef):
    n = treedef.num_leaves
    return jax.tree.unflatten(treedef, [flat[f"{prefix}/{i}"]
                                        for i in range(n)])


def _check_changes(tp, p0: dict, want: dict, lr_sum: float):
    """Each parameter's change from p0 against the reference's: every
    element within CHANGE_MAX x lr_sum, all but 1 in 1,000 within
    CHANGE_TOL x lr_sum."""
    off = total = 0
    for name, p in tp.named_parameters():
        got = p.detach().numpy() - p0[name]
        ref = want[name].detach().numpy() - p0[name]
        diff = np.abs(got - ref)
        assert diff.max() <= CHANGE_MAX * lr_sum, (
            f"parameter changes: {name} off by {diff.max():.3e}")
        off += int((diff > CHANGE_TOL * lr_sum).sum())
        total += diff.size
    assert off <= total // 1000, (
        f"parameter changes: {off} of {total} elements beyond "
        f"{CHANGE_TOL} x {lr_sum:.3e}")


FAULTS = {"unapplied": lambda g: torch.zeros_like(g), "negated": torch.neg}


@pytest.mark.parametrize("fault", [None] + list(FAULTS))
def test_pod_compress_steps_match_reference(reference, monkeypatch, fault):
    jcfg = j_get_reduced(ARCH).replace(compute_dtype="float32")
    tcfg = get_reduced(ARCH).replace(compute_dtype="float32")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    treedef = jax.tree.structure(jp)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                         "cpu").make_trainable()
    p0 = {n: p.detach().numpy().copy() for n, p in tp.named_parameters()}
    opt = {"adam": adamw_init(tp),
           "residuals": t_compress.compress_state_init(tp, N_PODS)}
    step = t_step.make_train_step(tcfg, warmup=WARMUP, pod_compress=True,
                                  mesh=ShardMesh(("pod",), (N_PODS,)))
    scales = {}
    quant, exch = t_compress.quantize_pod, t_compress.exchange

    def recording(grads, residuals, pod, leaves):
        out = quant(grads, residuals, pod, leaves)
        scales.update({(pod, n): float(v[1]) for n, v in out.items()})
        return out
    monkeypatch.setattr(t_compress, "quantize_pod", recording)
    if fault:
        monkeypatch.setattr(t_compress, "exchange", lambda pl, dt: {
            k: FAULTS[fault](v) for k, v in exch(pl, dt).items()})
    monkeypatch.setattr(tcommon, "bf16_einsum",
                        lambda eq, a, b: torch.einsum(eq, a.float(), b.float()))
    lr_sum = 0.0
    for s in range(1 if fault else STEPS):
        jb = j_synth_batch(jcfg, SHAPE, 5, s)
        batch = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
        tp, opt, m = step(tp, opt, batch)
        np.testing.assert_allclose(float(m["loss"]),
                                   float(reference[f"loss/{s}"]),
                                   rtol=1e-5, err_msg=f"loss, step {s}")
        assert float(m["lr"]) == float(reference[f"lr/{s}"])
        lr_sum += float(m["lr"])
        want = dict(params_from_jax(_tree(reference, f"p/{s}", treedef),
                                    tcfg, "cpu").named_parameters())
        if fault:
            with pytest.raises(AssertionError, match="parameter changes"):
                _check_changes(tp, p0, want, lr_sum)
            return
        _check_changes(tp, p0, want, lr_sum)
        for row, key in ((0, "r0"), (1, "r1")):
            ref_r = dict(params_from_jax(_tree(reference, f"{key}/{s}",
                                               treedef), tcfg,
                                         "cpu").named_parameters())
            off = total = 0
            for name, r in opt["residuals"].items():
                got = r[row].numpy()
                ref = ref_r[name].detach().numpy()
                diff = np.abs(got - ref)
                tol = 1e-3 * scales[(row, name)]      # ~8e-6 of max |g|
                limit = scales[(row, name)] + tol
                assert diff.max() <= limit, (name, row, diff.max(), limit)
                off += int((diff > tol).sum())
                total += diff.size
            assert off <= total // 1000, (s, row, off, total)
    assert int(opt["adam"]["step"]) == STEPS


def test_pod_compress_frees_each_pods_gradients(monkeypatch):
    """A pod's f32 gradients are gone before the next pod's are made: the
    step holds one gradient tree at a time, not P."""
    tcfg = get_reduced(ARCH)
    tp = t_step.M.init_params(tcfg, torch.Generator().manual_seed(0))
    tp.make_trainable()
    opt = {"adam": adamw_init(tp),
           "residuals": t_compress.compress_state_init(tp, N_PODS)}
    step = t_step.make_train_step(tcfg, pod_compress=True, microbatches=2,
                                  mesh=ShardMesh(("pod",), (N_PODS,)))
    grads_of, seen, alive = t_step.grads_of, [], []

    def watched(params, cfg, batch, microbatches):
        for p in params.parameters():
            p.grad = None
        alive.append(sum(r() is not None for r in seen))
        out = grads_of(params, cfg, batch, microbatches)
        seen[:] = [weakref.ref(g) for g in out[0].values()]
        return out
    monkeypatch.setattr(t_step, "grads_of", watched)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in j_synth_batch(
        j_get_reduced(ARCH), SHAPE, 5, 0).items()}
    step(tp, opt, batch)
    assert alive == [0, 0] and len(seen) == len(opt["residuals"])


def test_pod_compress_needs_a_pod_axis():
    tcfg = get_reduced(ARCH)
    with pytest.raises(ValueError, match="pod_compress needs a mesh"):
        t_step.make_train_step(tcfg, pod_compress=True,
                               mesh=ShardMesh(("data",), (2,)))
    with pytest.raises(ValueError, match="pod_compress needs a mesh"):
        t_step.make_train_step(tcfg, pod_compress=True)
