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
from repro_torch.kernels.selective_scan.ops import selective_scan
from repro_torch.kernels.selective_scan.ref import (selective_scan_chunked,
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
    _, tcfg, _, tp = _mamba_pair("float32")
    x = torch.zeros((1, 4, tcfg.d_model))
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        ssm.mamba_forward(tp, tcfg, x)
    with pytest.raises(NotImplementedError, match="float32"):
        ssm.mamba_forward(tp, tcfg.replace(ssm_scan_dtype="bfloat16"), x)


def test_launcher_is_registered():
    assert "selective_scan" in cuda.KERNELS
    assert "selective_scan" in cuda.LAUNCHES
    assert len(cuda._SIGNATURES["selective_scan_launch"]) == 13
