"""The selective scan and the mamba head of the port against the JAX
reference.

The port's plain scans (`selective_scan_ref`, one step at a time, and
`selective_scan_chunked`, the reference model's chunked associative scan
that exec mode `torch` runs) and the kernel wrapper on CPU tensors (which
runs the chunked scan) against the reference's oracle
`selective_scan_ref`, from a nonzero initial state and with the last
state, at the three shapes of tests/test_kernels.py and its tolerance,
2e-5 (the same f32 recurrence summed in another order); against the
Pallas kernel in interpret mode at the smallest shape (zero state: the
Pallas kernel takes none). Then `mamba_forward` / `mamba_decode` of the
reduced hymba-1.5b config against the reference's, from a nonzero state,
with a sequence that is not a multiple of `scan_chunk`: y and both
states. The CUDA kernel runs only on the card (chip_smoke.py holds it
against the chunked scan at the served shapes); here exec mode `gpu`
must refuse CPU tensors.

The backward: `selective_scan_bwd_ref` (the plain version of the
backward kernel) against the reference oracle's `jax.vjp` and against
torch autograd through both plain scans, from a nonzero h0 and dh_last,
within TOL of each gradient's largest |value| (the same f32 arithmetic,
summed in other orders); and the `SelectiveScan` autograd Function's
wiring on the CPU (its plain forward and backward) against autograd of
`selective_scan_ref`.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro  # noqa: F401  (enables x64)
from repro.configs import get_reduced as j_get_reduced
from repro.kernels.selective_scan.ops import selective_scan as j_pallas
from repro.kernels.selective_scan.ref import selective_scan_ref as j_ref
from repro.models import ssm as jssm
from repro_torch.configs import get_reduced
from repro_torch.kernels import cuda
from repro_torch.kernels.selective_scan.ops import (BF16_BACKWARD_REFUSAL,
                                                    selective_scan)
from repro_torch.kernels.selective_scan.ref import (selective_scan_bwd_ref,
                                                    selective_scan_chunked,
                                                    selective_scan_ref)
from repro_torch.models import ssm
from repro_torch.store import exec as exec_

SHAPES = [(1, 32, 64, 8), (2, 64, 128, 16), (2, 128, 64, 8)]
TOL = 2e-5
J_REF = jax.jit(j_ref)


@functools.lru_cache(maxsize=None)
def _inputs(shape):
    """tests/test_kernels.py's inputs for `shape`, plus a nonzero h0."""
    b, s, d, n = shape
    rng = np.random.default_rng(s)
    x = rng.standard_normal((b, s, d)).astype(np.float32) * 0.5
    dt = (np.abs(rng.standard_normal((b, s))) * 0.1 + 0.01).astype(
        np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32) * 0.5
    cm = rng.standard_normal((b, s, n)).astype(np.float32) * 0.5
    a = -(np.abs(rng.standard_normal((d, n))) + 0.1).astype(np.float32)
    h0 = rng.standard_normal((b, d, n)).astype(np.float32)
    return x, dt, bm, cm, a, h0


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


PLAIN = {
    "sequential": selective_scan_ref,
    "chunked": lambda *a: selective_scan_chunked(*a, chunk=24),
    "wrapper": selective_scan,
}


@pytest.mark.parametrize("form", list(PLAIN))
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_scan_matches_reference(shape, form):
    ins = _inputs(shape)
    yr, hr = J_REF(*(jnp.asarray(a) for a in ins))
    y, h = PLAIN[form](*_t(*ins))
    assert y.dtype == h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), atol=TOL, rtol=TOL)


def test_pallas_kernel_in_interpret_mode():
    x, dt, bm, cm, a, _ = _inputs(SHAPES[0])
    y_pallas = j_pallas(*(jnp.asarray(t) for t in (x, dt, bm, cm, a)),
                        d_block=64, chunk=32)
    y, _ = selective_scan_chunked(*_t(x, dt, bm, cm, a))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_pallas), atol=TOL,
                               rtol=TOL)


def _mamba_pair(scan_dtype):
    jcfg = j_get_reduced("hymba-1.5b").replace(
        compute_dtype="float32", scan_chunk=8, ssm_scan_dtype=scan_dtype)
    tcfg = get_reduced("hymba-1.5b").replace(
        compute_dtype="float32", scan_chunk=8, ssm_scan_dtype=scan_dtype)
    jp = jax.tree.map(np.asarray,
                      jssm.init_mamba(jax.random.PRNGKey(3), jcfg))
    tp = ssm.Mamba(**{k: torch.from_numpy(np.array(v)) for k, v in
                      jp.items()})
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("scan_dtype,tol", [("float32", 1e-5),
                                            ("bfloat16", 2e-2)])
def test_mamba_forward_and_decode_match_reference(scan_dtype, tol):
    """From a nonzero state, S = 20 with scan_chunk 8 (a padded last
    chunk), then two decode steps from the returned state. bfloat16: the
    reference's `ssm_scan_dtype` lever, plain scan only, within a bf16
    step of the values."""
    jcfg, tcfg, jp, tp = _mamba_pair(scan_dtype)
    rng = np.random.default_rng(11)
    b, s, d = 2, 20, tcfg.d_model
    di = tcfg.ssm_expand * d
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    st = {"conv": rng.standard_normal((b, tcfg.ssm_conv - 1, di)).astype(
              np.float32),
          "ssm": rng.standard_normal((b, di, tcfg.ssm_state)).astype(
              np.float32)}
    fwd = jax.jit(lambda p, x, st: jssm.mamba_forward(p, jcfg, x, st))
    jy, jst = fwd(jp, jnp.asarray(x), {k: jnp.asarray(v)
                                       for k, v in st.items()})
    with exec_.exec_mode("torch"):
        ty, tst = ssm.mamba_forward(tp, tcfg, torch.from_numpy(x),
                                    {k: torch.from_numpy(v)
                                     for k, v in st.items()})
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=tol,
                               rtol=tol)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(tst[name].numpy(), np.asarray(jst[name]),
                                   atol=tol, rtol=tol)
    dec = jax.jit(lambda p, x, st: jssm.mamba_decode(p, jcfg, x, st))
    for t in range(2):
        xt = rng.standard_normal((b, 1, d)).astype(np.float32)
        jy, jst = dec(jp, jnp.asarray(xt), jst)
        with exec_.exec_mode("torch"):
            ty, tst = ssm.mamba_decode(tp, tcfg, torch.from_numpy(xt), tst)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=tol,
                                   rtol=tol)
        for name in ("conv", "ssm"):
            np.testing.assert_allclose(tst[name].numpy(),
                                       np.asarray(jst[name]), atol=tol,
                                       rtol=tol)


def test_gpu_mode_refuses_cpu_tensors_and_bf16_scans():
    """Exec mode gpu refuses CPU tensors, the bf16 scan's as the f32
    scan's (both have a kernel); a scan dtype no kernel runs, and the
    bf16 scan under autograd, are refused by `check_scan_kernel`."""
    _, tcfg, _, tp = _mamba_pair("float32")
    x = torch.zeros((1, 4, tcfg.d_model))
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        ssm.mamba_forward(tp, tcfg, x)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        ssm.mamba_forward(tp, tcfg.replace(ssm_scan_dtype="bfloat16"), x)
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        ssm.check_scan_kernel(tcfg.replace(ssm_scan_dtype="float16"))
    with pytest.raises(NotImplementedError, match="no backward"):
        ssm.check_scan_kernel(tcfg.replace(ssm_scan_dtype="bfloat16"),
                              training=True)


def test_launcher_is_registered():
    assert "selective_scan" in cuda.KERNELS
    assert "selective_scan" in cuda.LAUNCHES
    assert "selective_scan_bwd" in cuda.KERNELS
    assert "selective_scan_bwd" in cuda.LAUNCHES
    assert "selective_scan/save" in cuda.LAUNCHES
    assert len(cuda._SIGNATURES["selective_scan_launch"]) == 16
    assert len(cuda._SIGNATURES["selective_scan_bwd_launch"]) == 22


GRADS = ("dx", "ddt", "dB", "dC", "dA", "dh0")


def _cotangents(shape):
    b, s, d, n = shape
    rng = np.random.default_rng(100 + s)
    return (rng.standard_normal((b, s, d)).astype(np.float32),
            rng.standard_normal((b, d, n)).astype(np.float32))


def _within(got, want, names=GRADS):
    for g, w, name in zip(got, want, names):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(np.asarray(g, np.float32), w, rtol=0,
                                   atol=TOL * float(np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_ref_matches_reference_vjp(shape):
    ins = _inputs(shape)
    dy, dh = _cotangents(shape)
    _, vjp = jax.vjp(j_ref, *(jnp.asarray(a) for a in ins))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    got = selective_scan_bwd_ref(*_t(*ins), *_t(dy, dh))
    _within([g.numpy() for g in got], want)


@pytest.mark.parametrize("form", ["sequential", "chunked"])
def test_bwd_ref_matches_autograd_through_plain_scans(form):
    shape = SHAPES[1]
    ins = _t(*_inputs(shape))
    dy, dh = _t(*_cotangents(shape))
    leaves = [t.clone().requires_grad_() for t in ins]
    y, h = PLAIN[form](*leaves)
    torch.autograd.backward([y, h], [dy, dh])
    got = selective_scan_bwd_ref(*ins, dy, dh)
    _within([g.numpy() for g in got], [t.grad.numpy() for t in leaves])


@pytest.mark.parametrize("h0,dh_last", [(True, True), (False, False)])
def test_autograd_function_wiring_on_cpu(h0, dh_last):
    """`SelectiveScan` on CPU tensors (the chunked scan forward, the plain
    backward) against autograd of the step-by-step scan; without h0 or
    without a cotangent for h_last (training's case: the cache is not in
    the loss)."""
    shape = SHAPES[2]
    ins = _t(*_inputs(shape))
    if not h0:
        ins[5] = None
    dy, dh = _t(*_cotangents(shape))
    outs = {}
    for name, fn in (("function", selective_scan), ("ref",
                                                      selective_scan_ref)):
        leaves = [None if t is None else t.clone().requires_grad_()
                  for t in ins]
        y, h = fn(*leaves)
        loss = (y * dy).sum() + ((h * dh).sum() if dh_last else 0.0)
        loss.backward()
        outs[name] = [t.grad.numpy() for t in leaves if t is not None]
    _within(outs["function"], outs["ref"])
    leaves = [t.clone().requires_grad_() for t in ins if t is not None]
    assert selective_scan(*leaves)[0].grad_fn.name().startswith(
        "SelectiveScan")


def test_bf16_scan_refuses_autograd():
    ins = [t.clone().requires_grad_() for t in _t(*_inputs(SHAPES[0]))]
    with pytest.raises(NotImplementedError) as e:
        selective_scan(*ins, scan_dtype=torch.bfloat16)
    assert str(e.value) == BF16_BACKWARD_REFUSAL
    with torch.no_grad():        # inference takes the bf16 scan
        y, _ = selective_scan(*ins, scan_dtype=torch.bfloat16,
                              scan_chunk=24)
    want, _ = selective_scan_chunked(*(t.detach() for t in ins), chunk=24,
                                     scan_dtype=torch.bfloat16)
    assert torch.equal(y, want)


def test_remat_recompute_keeps_the_exec_mode():
    """On CUDA the autograd engine recomputes a remat'd layer in a thread
    of its own, which the caller's exec mode (a ContextVar) does not
    reach. A backward run from another thread stands in for it here: the
    forward ran in mode torch, so the recompute must take the plain scan
    (mode gpu would refuse the CPU tensors), and the gradients equal a
    backward in the caller's thread."""
    import threading
    from repro_torch.models import model as TM
    cfg = get_reduced("hymba-1.5b")
    assert cfg.remat
    toks = torch.from_numpy(np.random.default_rng(3).integers(1, 256,
                                                             (2, 16)))
    grads = []
    for threaded in (False, True):
        p = TM.init_params(cfg, torch.Generator("cpu").manual_seed(0))
        p.make_trainable()
        with exec_.exec_mode("torch"):
            loss = TM.forward(p, cfg, toks)[0].float().logsumexp(-1).mean()
        errors = []

        def backward():
            try:
                loss.backward()
            except Exception as e:          # noqa: BLE001 (reported below)
                errors.append(e)
        if threaded:
            t = threading.Thread(target=backward)
            t.start()
            t.join()
        else:
            backward()
        assert not errors, errors
        grads.append([q.grad.clone() for q in p.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
