"""The reference's `kv_cache_dtype="float8_e4m3fn"` lever in the port,
against the JAX reference on the CPU (exec mode `torch`).

* The cast: `models.common.to_cache` gives the bits ml_dtypes gives, from
  f32 and from bf16, NaN where |x| > 464 or x is infinite (torch alone
  saturates to +-448).
* Prefill then decode of the reduced qwen3-1.7b (GQA), minicpm3-4b (MLA)
  and hymba-1.5b (its k / v) with an fp8 cache, from the same seeded
  weights (`convert.params_from_jax`), f32 compute. The two packages
  compute the cached values in f32 in another order, so a value at an fp8
  rounding tie may round the other way on one side: each cached element
  lies within one fp8 step (2^-3 of its value) of the reference's, and at
  most FP8_FLIPS of them differ (measured: none). The logits read those
  caches and agree within TOL of the largest |reference| logit.
* A row that passes 464 (one batch row's input scaled by 1e5 at the
  attention layer: the GQA value, the MLA rope key) is NaN in both caches
  at the same elements, and so is that row's decode output; the other
  row stays finite and equal.
* `convert.caches_from_jax` takes the reference's fp8 caches bit for bit
  (ml_dtypes through `uint8`), and `caches_to_numpy` gives their values.
"""
import functools

import ml_dtypes
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro  # noqa: F401  (enables x64)
from repro.configs import get_reduced as j_get_reduced
from repro.models import attention as JA
from repro.models import model as JM
from repro_torch.configs import get_reduced
from repro_torch.convert import (caches_from_jax, caches_to_numpy,
                                 params_from_jax)
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models.common import to_cache
from repro_torch.store import exec as exec_

FP8 = "float8_e4m3fn"
ARCHS = {"qwen3-1.7b": ("k", "v"), "minicpm3-4b": ("ckv", "kpe"),
         "hymba-1.5b": ("k", "v")}
B, P, STEPS = 2, 12, 3
TOL = 1e-3
FP8_FLIPS = 1e-3            # share of cached elements that may round apart


@pytest.fixture(autouse=True)
def _torch_mode():
    with exec_.exec_mode("torch"):
        yield


def _cfgs(arch):
    kw = dict(compute_dtype="float32", kv_cache_dtype=FP8)
    return j_get_reduced(arch).replace(**kw), get_reduced(arch).replace(**kw)


@pytest.mark.parametrize("src", ["float32", "bfloat16"])
def test_cast_matches_ml_dtypes(src):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096) * 50).astype(np.float32)
    x[:12] = [448, 455, 464, 464.5, 465, 470, 500, 1e6, np.inf, -np.inf,
              np.nan, -466]
    t = torch.from_numpy(x).to(getattr(torch, src))
    want = jnp.asarray(t.float().numpy()).astype(getattr(jnp, src)).astype(
        jnp.float8_e4m3fn)
    got = to_cache(t, torch.float8_e4m3fn)
    assert got.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(),
                                  np.asarray(want).view(np.uint8))
    over = t.float().abs() > 464
    assert torch.isnan(got.float()[over]).all() and int(over.sum()) >= 6
    assert torch.isfinite(got.float()[~over & ~torch.isnan(t.float())]).all()


@functools.lru_cache(maxsize=None)
def _model(arch):
    jcfg, tcfg = _cfgs(arch)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    toks = np.random.default_rng(1).integers(1, 512, (B, P + STEPS)).astype(
        np.int32)
    prefill = jax.jit(lambda p, t: JM.prefill(p, jcfg, t,
                                              cache_len=P + STEPS)[:2])
    decode = jax.jit(lambda p, t, pos, c: JM.decode_step(p, jcfg, t, pos, c))
    return jcfg, tcfg, jp, tp, toks, prefill, decode


def _close_fp8(got, want, name):
    """Each element within one fp8 step of the reference's, at most
    FP8_FLIPS of them apart."""
    g = got.float().numpy()
    w = np.asarray(want).astype(np.float32)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=name)
    apart = (g != w) & ~np.isnan(w)
    assert apart.mean() <= FP8_FLIPS, (name, apart.mean())
    np.testing.assert_array_less(np.abs(g - w)[apart],
                                 2.0 ** -3 * np.abs(w)[apart] + 1e-6,
                                 err_msg=name)


def _close(got, want):
    w = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), w, rtol=0,
                               atol=TOL * float(np.abs(w).max()))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_fp8_prefill_then_decode_matches_reference(arch):
    jcfg, tcfg, jp, tp, toks, prefill, decode = _model(arch)
    jlg, jc = prefill(jp, jnp.asarray(toks[:, :P]))
    tlg, tc, _ = TM.prefill(tp, tcfg, torch.from_numpy(toks[:, :P]),
                            P + STEPS)
    _close(tlg, jlg)
    for i in range(STEPS):
        for name in ARCHS[arch]:
            assert tc[0][name].dtype == torch.float8_e4m3fn
            assert np.asarray(jc[0][name]).dtype == ml_dtypes.float8_e4m3fn
            _close_fp8(tc[0][name], jc[0][name], f"{name} before step {i}")
        pos = np.full((B,), P + i, np.int32)
        jlg, jc = decode(jp, jnp.asarray(toks[:, P + i:P + i + 1]),
                         jnp.asarray(pos), jc)
        tlg, tc = TM.decode_step(tp, tcfg,
                                 torch.from_numpy(toks[:, P + i:P + i + 1]),
                                 torch.from_numpy(pos), tc)
        _close(tlg, jlg)
    if arch == "hymba-1.5b":            # the scan's state stays f32
        assert tc[0]["ssm"].dtype == torch.float32


def _attention(kind):
    arch = "qwen3-1.7b" if kind == "gqa" else "minicpm3-4b"
    jcfg, tcfg = _cfgs(arch)
    init = JA.init_gqa if kind == "gqa" else JA.init_mla
    jp = jax.tree.map(np.asarray, init(jax.random.PRNGKey(5), jcfg))
    tp = (TA.GQA if kind == "gqa" else TA.MLA)(
        **{k: torch.from_numpy(np.array(v)) for k, v in jp.items()})
    fns = ((JA.gqa_prefill, JA.gqa_decode, TA.gqa_prefill, TA.gqa_decode)
           if kind == "gqa" else
           (JA.mla_prefill, JA.mla_decode, TA.mla_prefill, TA.mla_decode))
    return jcfg, tcfg, jp, tp, fns


@pytest.mark.parametrize("kind,leaf", [("gqa", "v"), ("mla", "kpe")])
def test_fp8_overflow_row_is_nan_in_both(kind, leaf):
    jcfg, tcfg, jp, tp, (jpre, jdec, tpre, tdec) = _attention(kind)
    rng = np.random.default_rng(2)
    s, n = 6, 8
    x = rng.standard_normal((B, s + 1, jcfg.d_model)).astype(np.float32)
    x[1] *= 1e5                          # batch row 1 passes 464
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (B, s))
    jy, jc = jpre(jp, jcfg, jnp.asarray(x[:, :s]), jnp.asarray(pos), n)
    ty, tc = tpre(tp, tcfg, torch.from_numpy(x[:, :s]), torch.from_numpy(
        np.array(pos)), n)
    for name in jc:
        _close_fp8(tc[name], jc[name], name)
    cached = tc[leaf].float()
    assert torch.isnan(cached[1, :s]).any()
    assert torch.isfinite(cached[0]).all()
    p1 = np.full((B,), s, np.int32)
    jy, jc = jdec(jp, jcfg, jnp.asarray(x[:, s:]), jnp.asarray(p1), jc)
    ty, tc = tdec(tp, tcfg, torch.from_numpy(x[:, s:]),
                  torch.from_numpy(p1), tc)
    jy = np.asarray(jy, np.float32)
    np.testing.assert_array_equal(torch.isnan(ty).numpy(), np.isnan(jy))
    assert np.isnan(jy[1]).all() and np.isfinite(jy[0]).all()
    _close(ty[0], jy[0])
    for name in jc:
        _close_fp8(tc[name], jc[name], f"{name} after the decode")


def test_caches_from_jax_takes_fp8_bits():
    jcfg, tcfg, jp, tp, toks, prefill, decode = _model("hymba-1.5b")
    _, jc = prefill(jp, jnp.asarray(toks[:, :P]))
    back = jax.tree.map(np.asarray, jc)
    tc = caches_from_jax(back, "cpu")
    for name in ("k", "v"):
        assert tc[0][name].dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(tc[0][name].view(torch.uint8).numpy(),
                                      back[0][name].view(np.uint8))
    again = caches_to_numpy(tc)
    for name in ("k", "v"):
        np.testing.assert_array_equal(again[0][name],
                                      back[0][name].astype(np.float32))
    np.testing.assert_array_equal(again[0]["ssm"], back[0]["ssm"])
