"""hymba-1.5b in the port against the JAX reference, at the reduced config
(d_model 64, 4 heads, 2 KV heads, head_dim 16, ssm_state 16) with 4
layers instead of 2 and `sliding_window=8`, so that the window binds at
S = 24: layers 0, n/2 and n-1 stay global, which at 2 layers is every
layer, and at 4 leaves layer 1 windowed. At f32 compute, under both
attention impls:
"xla" (the chunked softmax) and "xla_flash" (the flash mirror). The port
runs in exec mode `torch`; the reference's parameters cross over with
`convert.params_from_jax` and its caches with `convert.caches_from_jax`.

Both sides round the attention operands to bf16 at the same points and
sum in f32 in another order, so an operand whose f32 value sits at a bf16
rounding tie can round the other way on one side: one weight moves by a
bf16 step (2^-8 of it), and the layers after it spread that over later
positions. Logits and the f32 states are held within 1e-3 (measured:
3.3e-4 at most, and 2e-6 where no operand rounds the other way), the
bf16 K/V caches within 1e-2 (one bf16 step). Also: the config against the reference's, the parameter names
and the initializer's shapes, and prefill(16) + 8 decode steps against
`forward`'s last logits, as tests/test_arch_smoke.py holds the reference.
"""
import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro  # noqa: F401  (enables x64)
from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.models import model as JM
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import (caches_from_jax, caches_to_numpy,
                                 params_from_jax)
from repro_torch.models import model as TM
from repro_torch.models.blocks import block_kinds, layer_windows
from repro_torch.store import exec as exec_

ARCH = "hymba-1.5b"
IMPLS = ("xla", "xla_flash")
TOL = 1e-3
KV_TOL = 1e-2
B, S, PRE = 2, 24, 16
LAYERS = 4
CACHE_NAMES = ("k", "v", "conv", "ssm")


def _cfgs(impl):
    kw = dict(compute_dtype="float32", sliding_window=8, attn_impl=impl,
              n_layers=LAYERS)
    return j_get_reduced(ARCH).replace(**kw), get_reduced(ARCH).replace(**kw)


@pytest.fixture(scope="module")
def params():
    jcfg, tcfg = _cfgs("xla")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")


@functools.lru_cache(maxsize=None)
def _jitted(impl):
    jcfg, _ = _cfgs(impl)
    return (jax.jit(lambda p, t: JM.forward(p, jcfg, t)[0]),
            jax.jit(lambda p, t: JM.prefill(p, jcfg, t, cache_len=S)[:2]),
            jax.jit(lambda p, t, pos, c: JM.decode_step(p, jcfg, t, pos, c)))


def _tokens(seed=1):
    return np.random.default_rng(seed).integers(1, 512, (B, S)).astype(
        np.int32)


def _close(a, b, tol=TOL):
    a = np.asarray(a, np.float32)
    b = b.detach().float().numpy() if torch.is_tensor(b) else np.asarray(
        b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


def _close_caches(jc, tc):
    assert set(tc[0]) == set(CACHE_NAMES)
    for name in CACHE_NAMES:
        _close(jc[0][name], tc[0][name], KV_TOL if name in "kv" else TOL)


@pytest.mark.parametrize("which", ["full", "reduced"])
def test_config_matches_reference(which):
    j = j_get_config(ARCH) if which == "full" else j_get_reduced(ARCH)
    t = get_config(ARCH) if which == "full" else get_reduced(ARCH)
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert block_kinds(t) == ["hymba"]
    if which == "full":     # arXiv:2411.13676 / nvidia/Hymba-1.5B-Base
        assert (t.n_layers, t.d_model, t.n_heads, t.n_kv_heads,
                t.resolved_head_dim, t.d_ff, t.vocab_size, t.padded_vocab,
                t.ssm_state, t.ssm_expand * t.d_model, t.sliding_window) == (
                    32, 1600, 25, 5, 64, 5504, 32001, 32256, 16, 3200, 2048)
        assert [i for i, w in enumerate(layer_windows(t)) if w == 0] == [
            0, 16, 31]


def test_params_from_jax_and_init_params(params):
    jp, tp = params
    stacked = jp["blocks"][0]
    names = {n.split(".", 2)[-1] for n, _ in tp.named_parameters()
             if n.startswith("blocks.")}
    want = {f"{g}.{k}" if isinstance(d, dict) else g
            for g, d in stacked.items() for k in (d if isinstance(d, dict)
                                                  else [None])}
    assert names == want
    assert {"mamba.a_log", "mamba.conv_w", "attn_ln", "mamba_ln"} <= names
    for i in range(LAYERS):
        np.testing.assert_array_equal(
            tp.blocks[i].mamba.x_proj.numpy(),
            np.asarray(stacked["mamba"]["x_proj"][i]))
    # the port's own initializer: the same names, shapes and scales
    _, tcfg = _cfgs("xla")
    p = TM.init_params(tcfg, torch.Generator().manual_seed(0))
    shapes = {n: tuple(t.shape) for n, t in p.named_parameters()}
    assert shapes == {n: tuple(t.shape) for n, t in tp.named_parameters()}
    m = p.blocks[0].mamba
    np.testing.assert_allclose(m.a_log.numpy(),
                               np.asarray(stacked["mamba"]["a_log"][0]))
    assert torch.equal(m.d_skip, torch.ones(128))
    assert abs(float(m.conv_w.std()) / 0.1 - 1) < 0.1


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches_reference(params, impl):
    jp, tp = params
    _, tcfg = _cfgs(impl)
    toks = _tokens()
    jl = _jitted(impl)[0](jp, jnp.asarray(toks))
    with exec_.exec_mode("torch"):
        tl, aux = TM.forward(tp, tcfg, torch.from_numpy(toks))
    _close(jl, tl)
    assert float(aux) == 0.0


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_and_decode_steps_match_reference(params, impl):
    """prefill(16): logits and the k/v/conv/ssm caches; then each of 8
    decode steps' logits and caches; and the port's caches, crossed over
    to the reference, give the reference's next step."""
    jp, tp = params
    _, tcfg = _cfgs(impl)
    _, jpre, jdec = _jitted(impl)
    toks = _tokens()
    jl, jc = jpre(jp, jnp.asarray(toks[:, :PRE]))
    with exec_.exec_mode("torch"):
        tl, tc, _ = TM.prefill(tp, tcfg, torch.from_numpy(toks[:, :PRE]),
                               cache_len=S)
    _close(jl, tl)
    _close_caches(jc, tc)
    assert tc[0]["k"].shape == (LAYERS, B, S, 2, 16)
    assert tc[0]["ssm"].shape == (LAYERS, B, 128, 16)
    assert layer_windows(tcfg) == [0, 8, 0, 0]
    for t in range(PRE, S):
        tok, pos = toks[:, t:t + 1], np.full((B,), t, np.int32)
        jl, jc = jdec(jp, jnp.asarray(tok), jnp.asarray(pos), jc)
        with exec_.exec_mode("torch"):
            tl, tc = TM.decode_step(tp, tcfg, torch.from_numpy(tok),
                                    torch.from_numpy(pos), tc)
        _close(jl, tl)
        _close_caches(jc, tc)
    back = jax.tree.map(jnp.asarray, caches_to_numpy(tc))
    back = ({k: v.astype(jc[0][k].dtype) for k, v in back[0].items()},)
    pos = np.full((B,), S - 1, np.int32)
    jl2, _ = jdec(jp, jnp.asarray(toks[:, -1:]), jnp.asarray(pos), back)
    with exec_.exec_mode("torch"):
        tl2, _ = TM.decode_step(tp, tcfg, torch.from_numpy(toks[:, -1:]),
                                torch.from_numpy(pos),
                                caches_from_jax(back, "cpu"))
    _close(jl2, tl2)


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_decode_matches_forward(params, impl):
    """"xla": within 1e-4 (the port: 3.0e-7; the reference's own gap on
    these tokens is 2.1e-5). "xla_flash": within two bf16 steps at the
    largest |logit| (2 x 3.9e-3 at |logit| 0.52), since prefill rounds the
    unnormalised p to bf16 and decode the normalised weights: the port's
    gap is 2.53e-3, the reference's 2.54e-3."""
    _, tp = params
    _, tcfg = _cfgs(impl)
    toks = torch.from_numpy(_tokens(2))
    with exec_.exec_mode("torch"):
        full, _ = TM.forward(tp, tcfg, toks)
        _, caches, _ = TM.prefill(tp, tcfg, toks[:, :PRE], cache_len=S)
        for t in range(PRE, S):
            lg, caches = TM.decode_step(tp, tcfg, toks[:, t:t + 1],
                                        torch.full((B,), t), caches)
    if impl == "xla":
        tol = 1e-4
    else:
        big = float(full[:, -1, :tcfg.vocab_size].abs().max())
        tol = 2 * 2.0 ** (np.floor(np.log2(big)) - 7)
    err = float((full[:, -1] - lg[:, 0]).abs().max())
    assert err <= tol, (err, tol)
