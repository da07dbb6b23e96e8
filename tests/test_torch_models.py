"""The port's dense GQA transformer against the JAX reference, on reduced
qwen3-1.7b (2 layers, d_model 64, 4 heads, 2 KV heads, head_dim 16).

The same numpy inputs go through `repro.models` and `repro_torch.models`;
the reference's parameters cross over with `convert.params_from_jax`. At
`compute_dtype="float32"` both sides round the attention operands to bf16
at the same points and sum in f32, so logits and caches agree to 1e-4
(only the order of f32 sums and the f32 `pow`/`cos`/`sin` of the rotary
angles differ). Also: the config against the reference's, the chunked
causal attention (`attn_block_q` below the sequence), the load-time
compute-dtype copy, the initializer's shapes, names and scales, and the
block kinds: xLSTM's, MLA's and the codebook models' against the
reference's leaves. The configs of all ten archs, full and reduced.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro  # noqa: F401  (enables x64)
from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.models import common as jcommon
from repro.models import model as JM
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import common as tcommon
from repro_torch.models import model as TM
from repro_torch.models.blocks import block_kinds, init_block
from repro_torch.store import exec as exec_

ARCH = "qwen3-1.7b"
TOL = 1e-4          # f32 logits / caches: same bf16 rounding points


@pytest.fixture(scope="module")
def cfgs():
    j = j_get_reduced(ARCH).replace(compute_dtype="float32")
    t = get_reduced(ARCH).replace(compute_dtype="float32")
    return j, t


@pytest.fixture(scope="module")
def params(cfgs):
    jcfg, tcfg = cfgs
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(1, vocab, shape).astype(
        np.int32)


def _close(a, b, tol=TOL):
    a = np.asarray(a, np.float32)
    b = b.detach().float().numpy() if torch.is_tensor(b) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", J_ARCHS)
@pytest.mark.parametrize("which", ["full", "reduced"])
def test_config_matches_reference(which, arch):
    """Every arch of the reference, field for field: the port's fields
    equal the reference's, and each reference field the port lacks (the
    XLA-mesh and kvstore knobs) holds its default, so the port loses
    nothing by lacking it."""
    j = j_get_config(arch) if which == "full" else j_get_reduced(arch)
    t = get_config(arch) if which == "full" else get_reduced(arch)
    port = {f.name for f in dataclasses.fields(t)}
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    for f in dataclasses.fields(j):
        if f.name not in port:
            assert getattr(j, f.name) == f.default, f.name
    assert t.resolved_head_dim == j.resolved_head_dim
    assert t.padded_vocab == j.padded_vocab
    if which == "full" and arch == ARCH:    # Qwen/Qwen3-1.7B's config.json
        assert (t.n_layers, t.d_model, t.n_heads, t.n_kv_heads, t.d_ff,
                t.vocab_size, t.head_dim, t.rope_theta) == (
                    28, 2048, 16, 8, 6144, 151936, 128, 1e6)


def test_unported_arch_raises():
    """Every arch of the reference is ported, in its order; an unknown
    name still raises."""
    assert ARCHS == J_ARCHS
    with pytest.raises(KeyError, match="unknown architecture"):
        get_config("llama3-406b")
    with pytest.raises(KeyError, match="unknown architecture"):
        get_reduced("gpt-2")
    assert get_config("paper-kvstore").store_lanes == 4096


# ---------------------------------------------------------------------------
# components
# ---------------------------------------------------------------------------

def test_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    _close(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6),
           tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           1e-6)
    _close(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6),
           tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              1e6), 1e-5)
    for window in (0, 3):
        _close(jcommon.causal_mask(4, 7, q_offset=3, window=window),
               tcommon.causal_mask(4, 7, q_offset=3, window=window), 0)


@pytest.mark.parametrize("sq,block_q,q_offset", [(24, 8, 0), (16, 8, 5),
                                                  (6, 8, 2)])
def test_attend_causal_chunked_matches_reference(sq, block_q, q_offset):
    rng = np.random.default_rng(sq + q_offset)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, sq + q_offset, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, sq + q_offset, 2, 16)).astype(np.float32)
    ref = jcommon.attend_causal(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), 0, "float32",
                                block_q=block_q, q_offset=q_offset)
    got = tcommon.attend_causal(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), 0, "float32",
                                block_q=block_q, q_offset=q_offset)
    _close(ref, got, 1e-5)


def test_attend_causal_ragged_last_chunk():
    """Above block_q the reference needs a multiple of it; the port's
    ragged last chunk gives the rows of the unchunked attention."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 13, 4, 16), (1, 13, 2, 16), (1, 13, 2, 16)))
    whole = tcommon.attend_causal(q, k, v, 0, "float32", block_q=64)
    chunked = tcommon.attend_causal(q, k, v, 0, "float32", block_q=5)
    assert torch.allclose(whole, chunked, atol=1e-6, rtol=1e-6)
    # "xla_flash" with ragged last q and kv tiles: the same rows, up to
    # where the two round the softmax weights to bf16 (p before the
    # division, w after it)
    with exec_.exec_mode("torch"):
        flash = tcommon.attend_causal(q, k, v, 0, "float32", block_q=5,
                                      impl="xla_flash")
    assert torch.allclose(whole, flash, atol=2e-2, rtol=2e-2)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_forward_matches_reference(cfgs, params):
    (jcfg, tcfg), (jp, tp) = cfgs, params
    toks = _tokens(1, (2, 12), jcfg.vocab_size)
    jl, _ = JM.forward(jp, jcfg, jnp.asarray(toks))
    tl, aux = TM.forward(tp, tcfg, torch.from_numpy(toks))
    _close(jl, tl)
    assert float(aux) == 0.0
    # the padded vocabulary is masked in both
    assert (tl[..., tcfg.vocab_size:] == -1e30).all()


def test_forward_chunked_attention_matches_reference(cfgs, params):
    (jcfg, tcfg), (jp, tp) = cfgs, params
    jcfg8, tcfg8 = jcfg.replace(attn_block_q=8), tcfg.replace(attn_block_q=8)
    toks = _tokens(2, (1, 24), jcfg.vocab_size)
    jl, _ = JM.forward(jp, jcfg8, jnp.asarray(toks))
    tl, _ = TM.forward(tp, tcfg8, torch.from_numpy(toks))
    _close(jl, tl)


def test_prefill_decode_and_past_match_reference(cfgs, params):
    (jcfg, tcfg), (jp, tp) = cfgs, params
    toks = _tokens(3, (2, 12), jcfg.vocab_size)
    jl, jc, _ = JM.prefill(jp, jcfg, jnp.asarray(toks), cache_len=16)
    tl, tc, _ = TM.prefill(tp, tcfg, torch.from_numpy(toks), cache_len=16)
    _close(jl, tl)
    for name in ("k", "v"):          # bf16 caches ([L, B, S, Hkv, Dh]):
        assert tc[0][name].dtype == torch.bfloat16      # within one step
        _close(jc[0][name], tc[0][name], 1e-2)
    # three decode steps on the contiguous caches
    rng = np.random.default_rng(4)
    for t in range(12, 15):
        nt = rng.integers(1, jcfg.vocab_size, (2, 1)).astype(np.int32)
        pos = np.full((2,), t, np.int32)
        jl, jc = JM.decode_step(jp, jcfg, jnp.asarray(nt), jnp.asarray(pos),
                                jc)
        tl, tc = TM.decode_step(tp, tcfg, torch.from_numpy(nt),
                                torch.from_numpy(pos), tc)
        _close(jl, tl)
        for name in ("k", "v"):
            _close(jc[0][name], tc[0][name], 1e-2)
    # suffix prefill after 8 cached tokens
    jl, jpc, _ = JM.prefill(jp, jcfg, jnp.asarray(toks), cache_len=12)
    tl, tpc, _ = TM.prefill(tp, tcfg, torch.from_numpy(toks), cache_len=12)
    jl3, jc3, _ = JM.prefill_with_past(jp, jcfg, jnp.asarray(toks[:, 8:]),
                                       jpc[0]["k"][:, :, :8],
                                       jpc[0]["v"][:, :, :8], cache_len=12)
    tl3, tc3, _ = TM.prefill_with_past(tp, tcfg, torch.from_numpy(toks[:, 8:]),
                                       tpc[0]["k"][:, :, :8],
                                       tpc[0]["v"][:, :, :8], cache_len=12)
    _close(jl3, tl3)
    _close(jc3[0]["k"], tc3[0]["k"], 1e-2)
    # the suffix's last logits are the full prefill's
    _close(jl[:, -1], tl3[:, -1])


def test_compute_copy_gives_the_per_use_casts(params):
    """bf16 compute from f32 parameters: the load-time copy holds the
    values the per-use cast gives, and the forward is bit-identical."""
    _, tp = params
    tcfg = get_reduced(ARCH)                       # bfloat16 compute
    toks = torch.from_numpy(_tokens(5, (1, 10), tcfg.vocab_size))
    before, _ = TM.forward(tp, tcfg, toks)
    tp.load_compute_copy(tcfg.compute_dtype)
    attn = tp.blocks[0].attn
    assert attn._compute["wq"].dtype == torch.bfloat16
    assert torch.equal(attn._compute["wq"], attn.wq.to(torch.bfloat16))
    assert "q_norm" not in attn._compute           # norms stay f32
    assert tp.w("embed", "bfloat16") is tp._compute["embed"]
    after, _ = TM.forward(tp, tcfg, toks)
    assert torch.equal(before, after)
    tp.load_compute_copy("float32")                # f32: no copies
    assert not tp._compute and not attn._compute


def test_init_params_shapes_names_and_scales(params):
    jp, tp = params
    cfg = get_reduced(ARCH).replace(d_model=256, d_ff=512, vocab_size=4096)
    gen = torch.Generator().manual_seed(0)
    p = TM.init_params(cfg, gen)
    # the reference's leaf names under blocks.<layer>.
    names = {n.split(".", 2)[-1] for n, _ in tp.named_parameters()
             if n.startswith("blocks.")}
    want = set()
    for grp, d in jp["blocks"][0].items():
        if isinstance(d, dict):
            want |= {f"{grp}.{k}" for k in d}
        else:
            want.add(grp)
    assert names == want
    assert {n for n, _ in tp.named_parameters()
            if not n.startswith("blocks.")} == {"embed", "final_norm"}
    assert len(p.blocks) == cfg.n_layers
    a = p.blocks[0].attn
    assert a.wq.shape == (256, cfg.n_heads * 16)
    assert a.wq.dtype == torch.float32 and not a.wq.requires_grad
    assert abs(float(a.wq.std()) * 256 ** 0.5 - 1) < 0.05     # N(0,1)/sqrt(d)
    assert abs(float(p.blocks[1].ffn.wd.std()) * 512 ** 0.5 - 1) < 0.05
    assert abs(float(p.embed.std()) / 0.02 - 1) < 0.05        # N(0,1)*0.02
    assert p.embed.shape == (cfg.padded_vocab, 256)
    assert torch.equal(a.q_norm, torch.ones(16))
    # seeded: the same generator seed gives the same parameters
    q = TM.init_params(cfg, torch.Generator().manual_seed(0))
    assert torch.equal(q.blocks[1].attn.wo, p.blocks[1].attn.wo)


def test_unported_kinds_raise():
    """The mlstm, slstm and MLA blocks and the codebook models, once
    refused, build with the reference's leaf names and shapes."""
    from repro.models.blocks import init_block as j_init_block
    cfg = get_reduced(ARCH)
    assert block_kinds(cfg) == ["dense"]
    assert block_kinds(cfg.replace(n_experts=4)) == ["moe"]
    assert block_kinds(cfg.replace(block_pattern="xlstm")) == [
        "mlstm"] * 7 + ["slstm"]
    for c, kind in ((get_reduced("xlstm-1.3b"), "mlstm"),
                    (get_reduced("xlstm-1.3b"), "slstm"),
                    (get_reduced("minicpm3-4b"), "dense")):
        want = jax.eval_shape(lambda k: j_init_block(k, c, kind),
                              jax.random.PRNGKey(0))
        want = {"/".join(str(getattr(k, "key", k)) for k in path):
                tuple(leaf.shape)
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                    want)[0]}
        got = {n.replace(".", "/"): tuple(t.shape) for n, t in
               init_block(torch.Generator(), c, kind).named_parameters()}
        assert got == want, kind
    c = get_reduced("musicgen-medium")
    want = jax.eval_shape(lambda k: JM.init_params(
        k, j_get_reduced("musicgen-medium")), jax.random.PRNGKey(0))
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                want)[0] if not path[0].key == "blocks"}
    got = {n: tuple(t.shape) for n, t in
           TM.init_params(c, torch.Generator()).named_parameters()
           if not n.startswith("blocks.")}
    assert got == want == {"embed": (2, c.padded_vocab, c.d_model),
                           "lm_head": (c.d_model, 2 * c.padded_vocab),
                           "final_norm": (c.d_model,)}
