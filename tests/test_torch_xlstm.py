"""xlstm-1.3b in the port against the JAX reference, at the reduced config
(d_model 64, 2 heads, d_inner 128) with 8 layers and `slstm_every=4`, so
the period of 3 mlstm + 1 slstm blocks repeats over two groups and a
wrong layer mapping shows. The port runs in exec mode `torch` (no kernel
is on this path); the reference's parameters cross over with
`convert.params_from_jax`, its states with `convert.caches_from_jax`.

At f32 compute both sides run the same arithmetic with the f32 sums in
another order (the sLSTM's x @ wx as one GEMM over the steps, the chunk
einsums as batched matmuls): logits, outputs and states agree within
TOL = 1e-5 of the largest |reference| (measured: 2.1e-6 at most). At
bf16 compute the two libraries round some bf16 elementwise results
differently (the reference's bf16 `silu` differs from torch's by one
bf16 step on ~40% of the elements), and eight layers spread that: the
logits agree within BF16_STEPS = 16 bf16 steps of the largest |logit|
(measured: 4.75 to 7.5 steps over five token seeds).
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
from repro.models import ssm as JS
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import (caches_from_jax, caches_to_numpy,
                                 params_from_jax)
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from repro_torch.models.blocks import block_kinds
from repro_torch.store import exec as exec_

ARCH = "xlstm-1.3b"
TOL = 1e-5
BF16_STEPS = 16
B, S, PRE = 2, 20, 14
CHUNK = 8             # S = 20 is not a multiple: the padded tail runs
LAYERS, EVERY = 8, 4


def _cfgs(**kw):
    kw = {"compute_dtype": "float32", "n_layers": LAYERS,
          "slstm_every": EVERY, "scan_chunk": CHUNK, **kw}
    return j_get_reduced(ARCH).replace(**kw), get_reduced(ARCH).replace(**kw)


@pytest.fixture(scope="module")
def params():
    jcfg, tcfg = _cfgs()
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")


@functools.lru_cache(maxsize=None)
def _jitted(dtype):
    jcfg, _ = _cfgs(compute_dtype=dtype)
    return (jax.jit(lambda p, t: JM.forward(p, jcfg, t)[0]),
            jax.jit(lambda p, t: JM.prefill(p, jcfg, t, cache_len=S)[:2]),
            jax.jit(lambda p, t, pos, c: JM.decode_step(p, jcfg, t, pos, c)))


def _tokens(seed=1):
    return np.random.default_rng(seed).integers(1, 512, (B, S)).astype(
        np.int32)


def _close(a, b, tol=TOL):
    """|a - b| within tol of the largest |a| (a: the reference)."""
    a = np.asarray(a, np.float32)
    b = b.detach().float().numpy() if torch.is_tensor(b) else np.asarray(
        b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max())
    assert err <= tol * max(float(np.abs(a).max()), 1.0), err


def _close_tree(j, t, tol=TOL):
    for jd, td in zip(j, t, strict=True):
        assert set(jd) == set(td)
        for name in jd:
            _close(jd[name], td[name], tol)


@pytest.mark.parametrize("which", ["full", "reduced"])
def test_config_matches_reference(which):
    j = j_get_config(ARCH) if which == "full" else j_get_reduced(ARCH)
    t = get_config(ARCH) if which == "full" else get_reduced(ARCH)
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    if which == "full":     # arXiv:2405.04517, xLSTM[7:1]
        assert (t.n_layers, t.d_model, t.n_heads, t.ssm_expand * t.d_model,
                t.vocab_size, t.padded_vocab) == (48, 2048, 4, 4096, 50304,
                                                  50432)
        assert block_kinds(t) == ["mlstm"] * 7 + ["slstm"]
    else:
        assert block_kinds(t) == ["mlstm"] * 3 + ["slstm"]


def test_params_from_jax_and_init_params(params):
    """Layer g·P + i of the port is row g of the reference's blocks[i];
    the port's own initializer gives the same names and shapes, with the
    reference's scales."""
    jp, tp = params
    assert len(tp.blocks) == LAYERS
    for layer in range(LAYERS):
        i, g = layer % EVERY, layer // EVERY
        cell = tp.blocks[layer].cell
        if i == EVERY - 1:
            assert isinstance(cell, TS.SLSTM)
            np.testing.assert_array_equal(
                cell.wh.numpy(), np.asarray(jp["blocks"][i]["cell"]["wh"][g]))
        else:
            assert isinstance(cell, TS.MLSTM)
            np.testing.assert_array_equal(
                cell.wq.numpy(), np.asarray(jp["blocks"][i]["cell"]["wq"][g]))
    _, tcfg = _cfgs()
    p = TM.init_params(tcfg, torch.Generator().manual_seed(0))
    shapes = {n: tuple(t.shape) for n, t in p.named_parameters()}
    assert shapes == {n: tuple(t.shape) for n, t in tp.named_parameters()}
    assert shapes["blocks.3.ffn.wi"] == (64, 85)       # max(0, 4 d / 3)
    sl = p.blocks[3].cell
    assert abs(float(sl.wh.std()) * 2 * 64 ** 0.5 - 1) < 0.1   # 0.5/sqrt(d)
    assert abs(float(p.blocks[0].cell.conv_w.std()) / 0.1 - 1) < 0.2


def _cell(cls, tree):
    return cls(**_t(tree))


def _state(rng, st):
    """A nonzero state shaped as `st` (numpy leaves)."""
    return {k: (rng.standard_normal(np.shape(v)) * 0.5).astype(np.float32)
            for k, v in st.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("seq", [S, 1])
def test_mlstm_forward_and_decode_match_reference(seq):
    """mlstm_forward from a nonzero state over S = 20 in chunks of 8 (and
    over one step), then mlstm_decode from the state it leaves."""
    jcfg, tcfg = _cfgs()
    jc = JS.init_mlstm(jax.random.PRNGKey(3), jcfg)
    tc = _cell(TS.MLSTM, jc)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, seq + 1, 64)).astype(np.float32)
    st = _state(rng, JS.mlstm_init_state(jcfg, B))
    jy, jst = JS.mlstm_forward(jc, jcfg, jnp.asarray(x[:, :seq]),
                               jax.tree.map(jnp.asarray, st), chunk=CHUNK)
    ty, tst = TS.mlstm_forward(tc, tcfg, torch.from_numpy(x[:, :seq]),
                               _t(st), chunk=CHUNK)
    _close(jy, ty)
    _close_tree((jst,), (tst,))
    jy, jst = JS.mlstm_decode(jc, jcfg, jnp.asarray(x[:, seq:]), jst)
    ty, tst = TS.mlstm_decode(tc, tcfg, torch.from_numpy(x[:, seq:]), tst)
    _close(jy, ty)
    _close_tree((jst,), (tst,))


def test_slstm_forward_and_decode_match_reference():
    jcfg, tcfg = _cfgs()
    jc = JS.init_slstm(jax.random.PRNGKey(5), jcfg)
    tc = _cell(TS.SLSTM, jc)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, S + 1, 64)).astype(np.float32)
    st = _state(rng, JS.slstm_init_state(jcfg, B))
    jy, jst = JS.slstm_forward(jc, jcfg, jnp.asarray(x[:, :S]),
                               jax.tree.map(jnp.asarray, st))
    ty, tst = TS.slstm_forward(tc, tcfg, torch.from_numpy(x[:, :S]), _t(st))
    _close(jy, ty)
    _close_tree((jst,), (tst,))
    jy, jst = JS.slstm_decode(jc, jcfg, jnp.asarray(x[:, S:]), jst)
    ty, tst = TS.slstm_decode(tc, tcfg, torch.from_numpy(x[:, S:]), tst)
    _close(jy, ty)
    _close_tree((jst,), (tst,))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(params, dtype):
    jp, tp = params
    _, tcfg = _cfgs(compute_dtype=dtype)
    toks = _tokens()
    jl = _jitted(dtype)[0](jp, jnp.asarray(toks))
    with exec_.exec_mode("torch"):
        tl, aux = TM.forward(tp, tcfg, torch.from_numpy(toks))
    if dtype == "float32":
        _close(jl, tl)
    else:
        big = float(jnp.abs(jl[..., :tcfg.vocab_size]).max())
        step = 2.0 ** (np.floor(np.log2(big)) - 7)
        err = float(np.abs(np.asarray(jl) - tl.numpy())[
            ..., :tcfg.vocab_size].max())
        assert err <= BF16_STEPS * step, (err / step, BF16_STEPS)
    assert float(aux) == 0.0


def test_init_caches_match_reference(params):
    jp, tp = params
    jcfg, tcfg = _cfgs()
    jc = JM.init_caches(jp, jcfg, B, S)
    tc = TM.init_caches(tp, tcfg, B, S)
    assert len(tc) == EVERY
    for jd, td in zip(jc, tc, strict=True):
        assert set(td) == set(jd)
        for name in jd:
            assert tuple(td[name].shape) == jd[name].shape, name
            assert str(td[name].dtype) == f"torch.{jd[name].dtype}", name
            assert not td[name].any()


def test_prefill_and_decode_steps_match_reference(params):
    """prefill(14): logits and the 3 mlstm + 1 slstm state dicts stacked
    over the 2 groups; then each decode step's logits and states; and the
    port's states, crossed over to the reference, give its next step."""
    jp, tp = params
    _, tcfg = _cfgs()
    _, jpre, jdec = _jitted("float32")
    toks = _tokens()
    jl, jc = jpre(jp, jnp.asarray(toks[:, :PRE]))
    with exec_.exec_mode("torch"):
        tl, tc, _ = TM.prefill(tp, tcfg, torch.from_numpy(toks[:, :PRE]),
                               cache_len=S)
    _close(jl, tl)
    _close_tree(jc, tc)
    assert tc[0]["c"].shape == (LAYERS // EVERY, B, 2, 64, 64)
    assert tc[EVERY - 1]["h"].shape == (LAYERS // EVERY, B, 64)
    for t in range(PRE, S - 1):
        tok, pos = toks[:, t:t + 1], np.full((B,), t, np.int32)
        jl, jc = jdec(jp, jnp.asarray(tok), jnp.asarray(pos), jc)
        with exec_.exec_mode("torch"):
            tl, tc = TM.decode_step(tp, tcfg, torch.from_numpy(tok),
                                    torch.from_numpy(pos), tc)
        _close(jl, tl)
        _close_tree(jc, tc)
    back = jax.tree.map(jnp.asarray, caches_to_numpy(tc))
    tok, pos = toks[:, -1:], np.full((B,), S - 1, np.int32)
    jl2, _ = jdec(jp, jnp.asarray(tok), jnp.asarray(pos), back)
    with exec_.exec_mode("torch"):
        tl2, _ = TM.decode_step(tp, tcfg, torch.from_numpy(tok),
                                torch.from_numpy(pos),
                                caches_from_jax(back, "cpu"))
    _close(jl2, tl2)


def test_prefill_decode_matches_forward(params):
    """The port's prefill + decode against its own `forward` over the
    whole sequence: the chunkwise and the recurrent forms of the same
    cells, within TOL."""
    _, tp = params
    _, tcfg = _cfgs()
    toks = torch.from_numpy(_tokens(2))
    with exec_.exec_mode("torch"):
        full, _ = TM.forward(tp, tcfg, toks)
        _, caches, _ = TM.prefill(tp, tcfg, toks[:, :PRE], cache_len=S)
        for t in range(PRE, S):
            lg, caches = TM.decode_step(tp, tcfg, toks[:, t:t + 1],
                                        torch.full((B,), t), caches)
            _close(full[:, t], lg[:, 0])
