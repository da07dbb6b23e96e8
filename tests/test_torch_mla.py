"""minicpm3-4b's MLA in the port against the JAX reference, at the reduced
config (d_model 64, 4 heads, q / kv LoRA ranks 32 / 16, nope / rope / v
8 / 8 / 8, 2 layers) with `attn_block_q = 8`, so a prompt of 16 or 24
tokens runs the chunk loop. The port runs in exec mode `torch` (no
kernel is on this path); the reference's parameters cross over with
`convert.params_from_jax`, its caches with `convert.caches_from_jax`.

At f32 compute both sides round the score and PV operands to bf16 at the
same points and sum in f32 in another order, so an operand whose f32
value sits at a bf16 rounding tie can round the other way on one side
(as in tests/test_torch_hymba.py): logits and outputs agree within
TOL = 1e-3 of the largest |reference| (measured: 1.9e-4 at most, at one
decode step of the module test); the bf16 latent caches {"ckv", "kpe"}
within one bf16 step (measured: equal). At
bf16 compute the logits agree within BF16_STEPS = 8 bf16 steps of the
largest |logit| (measured: 1.6 to 2.25 steps over five token seeds). The
reference asserts S % 512 == 0 past one chunk; the port's shorter last
chunk is held against one chunk over the whole sequence.
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
from repro.models import attention as JA
from repro.models import model as JM
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import (caches_from_jax, caches_to_numpy,
                                 params_from_jax)
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.store import exec as exec_

ARCH = "minicpm3-4b"
TOL = 1e-3
CACHE_TOL = 2.0 ** -7       # one bf16 step at |x| < 2
BF16_STEPS = 8
B, S, PRE = 2, 24, 16
BLOCK_Q = 8


def _cfgs(**kw):
    kw = {"compute_dtype": "float32", "attn_block_q": BLOCK_Q, **kw}
    return j_get_reduced(ARCH).replace(**kw), get_reduced(ARCH).replace(**kw)


@pytest.fixture(scope="module")
def params():
    jcfg, tcfg = _cfgs()
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")


@pytest.fixture(scope="module")
def attn():
    jcfg, _ = _cfgs()
    jp = JA.init_mla(jax.random.PRNGKey(7), jcfg)
    return jp, TA.MLA(**{k: torch.from_numpy(np.array(v))
                         for k, v in jp.items()})


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


def _close_caches(jc, tc):
    for jd, td in zip(jc, tc, strict=True):
        assert set(jd) == set(td) == {"ckv", "kpe"}
        for name in jd:
            assert str(td[name].dtype) == "torch.bfloat16"
            _close(jd[name], td[name], CACHE_TOL)


@pytest.mark.parametrize("which", ["full", "reduced"])
def test_config_matches_reference(which):
    j = j_get_config(ARCH) if which == "full" else j_get_reduced(ARCH)
    t = get_config(ARCH) if which == "full" else get_reduced(ARCH)
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.attn_type == "mla"
    if which == "full":     # openbmb/MiniCPM3-4B
        assert (t.n_layers, t.d_model, t.n_heads, t.d_ff, t.vocab_size,
                t.q_lora_rank, t.kv_lora_rank, t.qk_nope_dim, t.qk_rope_dim,
                t.v_head_dim) == (62, 2560, 40, 6400, 73448, 768, 256, 64,
                                  32, 64)


def test_params_from_jax_and_init_params(params):
    jp, tp = params
    a = tp.blocks[1].attn
    assert isinstance(a, TA.MLA)
    np.testing.assert_array_equal(
        a.wuk.numpy(), np.asarray(jp["blocks"][0]["attn"]["wuk"][1]))
    _, tcfg = _cfgs()
    p = TM.init_params(tcfg, torch.Generator().manual_seed(0))
    shapes = {n: tuple(t.shape) for n, t in p.named_parameters()}
    assert shapes == {n: tuple(t.shape) for n, t in tp.named_parameters()}
    assert shapes["blocks.0.attn.wuq"] == (32, 4 * 16)
    assert shapes["blocks.0.attn.wkr"] == (64, 8)
    assert torch.equal(p.blocks[0].attn.kv_ln, torch.ones(16))


@pytest.mark.parametrize("window", [0, 6])
def test_mla_forward_prefill_decode_match_reference(attn, window):
    """mla_forward over 24 tokens (three chunks of 8), mla_prefill of 16
    (its caches zero-padded to 24), then decode steps at 16..23."""
    jp, tp = attn
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, S, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jy = JA.mla_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(pos), window)
    ty = TA.mla_forward(tp, tcfg, torch.from_numpy(x),
                        torch.from_numpy(pos.copy()), window)
    _close(jy, ty)
    jy, jc = JA.mla_prefill(jp, jcfg, jnp.asarray(x[:, :PRE]),
                            jnp.asarray(pos[:, :PRE]), S, window)
    ty, tc = TA.mla_prefill(tp, tcfg, torch.from_numpy(x[:, :PRE]),
                            torch.from_numpy(pos[:, :PRE].copy()), S, window)
    _close(jy, ty)
    _close_caches((jc,), (tc,))
    assert not tc["ckv"][:, PRE:].any()
    for t in range(PRE, S):
        p = np.full((B,), t, np.int32)
        jy, jc = JA.mla_decode(jp, jcfg, jnp.asarray(x[:, t:t + 1]),
                               jnp.asarray(p), jc, window)
        ty, tc = TA.mla_decode(tp, tcfg, torch.from_numpy(x[:, t:t + 1]),
                               torch.from_numpy(p), tc, window)
        _close(jy, ty)
        _close_caches((jc,), (tc,))


def test_ragged_last_chunk(attn):
    """S = 20 in chunks of 8 (the reference asserts S % 8 == 0) equals
    the one-chunk attention over the 20 queries."""
    _, tp = attn
    _, tcfg = _cfgs()
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (B, 20, 64)).astype(np.float32))
    pos = torch.arange(20)[None].expand(B, 20)
    whole = TA.mla_forward(tp, tcfg.replace(attn_block_q=512), x, pos)
    torch.testing.assert_close(TA.mla_forward(tp, tcfg, x, pos), whole,
                               atol=1e-6, rtol=1e-6)


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
    for jd, td in zip(jc, tc, strict=True):
        assert set(td) == set(jd) == {"ckv", "kpe"}
        for name in jd:
            assert tuple(td[name].shape) == jd[name].shape, name
            assert str(td[name].dtype) == f"torch.{jd[name].dtype}", name
            assert not td[name].any()
    assert tc[0]["ckv"].shape == (2, B, S, 16)


def test_prefill_and_decode_steps_match_reference(params):
    """prefill(16): logits and the latent caches; then each decode step's
    logits and caches; and the port's caches, crossed over to the
    reference, give its next step. prefill_with_past refuses MLA, whose
    `past` the reference ignores."""
    jp, tp = params
    _, tcfg = _cfgs()
    _, jpre, jdec = _jitted("float32")
    toks = _tokens()
    jl, jc = jpre(jp, jnp.asarray(toks[:, :PRE]))
    with exec_.exec_mode("torch"):
        tl, tc, _ = TM.prefill(tp, tcfg, torch.from_numpy(toks[:, :PRE]),
                               cache_len=S)
    _close(jl, tl)
    _close_caches(jc, tc)
    for t in range(PRE, S - 1):
        tok, pos = toks[:, t:t + 1], np.full((B,), t, np.int32)
        jl, jc = jdec(jp, jnp.asarray(tok), jnp.asarray(pos), jc)
        with exec_.exec_mode("torch"):
            tl, tc = TM.decode_step(tp, tcfg, torch.from_numpy(tok),
                                    torch.from_numpy(pos), tc)
        _close(jl, tl)
        _close_caches(jc, tc)
    back = tuple({k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in d.items()}
                 for d in caches_to_numpy(tc))
    tok, pos = toks[:, -1:], np.full((B,), S - 1, np.int32)
    jl2, _ = jdec(jp, jnp.asarray(tok), jnp.asarray(pos), back)
    with exec_.exec_mode("torch"):
        tl2, _ = TM.decode_step(tp, tcfg, torch.from_numpy(tok),
                                torch.from_numpy(pos),
                                caches_from_jax(back, "cpu"))
    _close(jl2, tl2)
    with pytest.raises(NotImplementedError, match="prefix reuse"):
        TM.prefill_with_past(tp, tcfg, torch.from_numpy(toks[:, PRE:]),
                             tc[0]["ckv"], tc[0]["kpe"], S)


def test_prefill_decode_matches_forward(params):
    """The port's prefill + decode against its own `forward`: the latent
    cache holds bf16, so each step's logits may move by the bf16 rounding
    of ckv and kpe: within 1e-2 of the largest |logit| (measured:
    3.5e-3)."""
    _, tp = params
    _, tcfg = _cfgs()
    toks = torch.from_numpy(_tokens(2))
    with exec_.exec_mode("torch"):
        full, _ = TM.forward(tp, tcfg, toks)
        _, caches, _ = TM.prefill(tp, tcfg, toks[:, :PRE], cache_len=S)
        for t in range(PRE, S):
            lg, caches = TM.decode_step(tp, tcfg, toks[:, t:t + 1],
                                        torch.full((B,), t), caches)
            _close(full[:, t], lg[:, 0], 1e-2)
