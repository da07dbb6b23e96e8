"""The port's frontend stubs and last dense archs against the JAX
reference, on the CPU at reduced sizes (2 layers, d_model 64).

* llava-next-mistral-7b: `forward` and `prefill` with `prefix_embeds`
  (8 precomputed rows before the tokens), `decode_step` after the
  prefill, `loss_fn` on the reference's `synth_batch`, one `train_step`,
  and `make_serve_prefill` with the prefix;
* musicgen-medium: `forward`, `prefill` and `decode_step` on [B, n_cb, S]
  token grids (2 codebooks), `cross_entropy` with and without a mask,
  `make_serve_decode`'s [B, n_cb, V], one `train_step`, the codebook
  leaves' shapes and draws, their compute copies, and the serving path's
  refusals (the reference's engine cannot serve a codebook model either);
* reduced qwen1.5-110b, llama3-405b and llava (text only, as the
  reference's engine takes no prefix) through the port's `Engine` in exec
  mode torch against the reference's contiguous `prefill` + `decode_step`.

The reference's parameters cross over with `convert.params_from_jax`.
At f32 compute logits agree within TOL = 1e-5 of the largest
|reference| (measured: 5.4e-7 at most; both sides round the attention
operands to bf16 at the same points) and the bf16 k / v caches within one
bf16 step of it, at bf16 compute within BF16_STEPS = 8 bf16 steps
(measured: 1.7 steps). A train step is held as in
tests/test_torch_train.py: the loss within 1e-5, the grad norm within
one bf16 step, the parameters within 2 lr.
"""
import functools

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
from repro.optim import adamw as j_adamw
from repro.train import step as j_step
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import model as TM
from repro_torch.optim import adamw as t_adamw
from repro_torch.serving import kvcache as KV
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.paged_decode import paged_decode_step
from repro_torch.store import exec as t_exec
from repro_torch.train import step as t_step

LLAVA = "llava-next-mistral-7b"
MUSIC = "musicgen-medium"
TOL = 1e-5
BF16_STEPS = 8
B, S = 2, 12                       # batch and text tokens a sequence
SHAPE = j_base.ShapeConfig("tiny", seq_len=24, global_batch=4, kind="train")
LR = 3e-4


def _cfgs(arch, dtype="float32"):
    return (j_get_reduced(arch).replace(compute_dtype=dtype),
            get_reduced(arch).replace(compute_dtype=dtype))


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return JM.init_params(jax.random.PRNGKey(0), _cfgs(arch)[0])


def _port_params(arch, dtype="float32"):
    return params_from_jax(jax.tree.map(np.asarray, _ref_params(arch)),
                           _cfgs(arch, dtype)[1], "cpu")


def _np(x):
    return (x.detach().float().numpy() if torch.is_tensor(x)
            else np.asarray(x, np.float32))


def _close(want, got, dtype="float32", steps=BF16_STEPS):
    """|got - want| within TOL of max |want| (f32), or `steps` bf16 steps
    of it (bf16)."""
    want, got = _np(want), _np(got)
    assert want.shape == got.shape, (want.shape, got.shape)
    big = float(np.abs(want).max())
    tol = (TOL * big if dtype == "float32"
           else steps * 2.0 ** (np.floor(np.log2(big)) - 7))
    err = float(np.abs(want - got).max())
    assert err <= tol, (err, tol)


def _close_caches(jc, tc):
    """The bf16 k / v caches within one bf16 step: a key or value whose
    f32 projection sits at a rounding tie rounds either way."""
    for jd, td in zip(jc, tc, strict=True):
        assert set(jd) == set(td) == {"k", "v"}
        for name in jd:
            assert td[name].dtype == torch.bfloat16
            _close(jd[name], td[name], "bfloat16", steps=1)


def _inputs(arch, seed=1):
    """(tokens, prefix_embeds or None) as numpy: llava's text tokens and
    its frontend's rows, musicgen's [B, n_cb, S] grid."""
    cfg = _cfgs(arch)[0]
    rng = np.random.default_rng(seed)
    if cfg.n_codebooks:
        return rng.integers(0, cfg.vocab_size, (B, cfg.n_codebooks, S)
                            ).astype(np.int32), None
    toks = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    pre = (rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model))
           * 0.02).astype(np.float32)
    return toks, pre


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,dtype", [(LLAVA, "float32"),
                                        (LLAVA, "bfloat16"),
                                        (MUSIC, "float32"),
                                        (MUSIC, "bfloat16")])
def test_forward_matches_reference(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    toks, pre = _inputs(arch)
    jl, jaux = jax.jit(lambda p, t, e: JM.forward(p, jcfg, t,
                                                  prefix_embeds=e))(
        _ref_params(arch), jnp.asarray(toks), _j(pre))
    with torch.no_grad():
        tl, taux = TM.forward(_port_params(arch, dtype), tcfg, _t(toks),
                              prefix_embeds=_t(pre))
    ft = tcfg.frontend_tokens
    want = ((B, ft + S, tcfg.padded_vocab) if not tcfg.n_codebooks
            else (B, S, tcfg.n_codebooks, tcfg.padded_vocab))
    assert tuple(tl.shape) == want and tl.dtype == torch.float32
    _close(jl, tl, dtype)
    assert float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("arch", [LLAVA, MUSIC])
def test_prefill_and_decode_match_reference(arch):
    """Prefill all but the last position (after llava's prefix), then
    decode it: logits and caches against the reference, and the decoded
    logits against the reference's `forward` at that position."""
    jcfg, tcfg = _cfgs(arch)
    toks, pre = _inputs(arch, 2)
    ft = tcfg.frontend_tokens
    cache_len = ft + S + 2
    jp, tp = _ref_params(arch), _port_params(arch)
    jl, jc, _ = jax.jit(lambda p, t, e: JM.prefill(
        p, jcfg, t, cache_len, prefix_embeds=e))(
        jp, jnp.asarray(toks[..., :-1]), _j(pre))
    with torch.no_grad():
        tl, tc, _ = TM.prefill(tp, tcfg, _t(toks[..., :-1]), cache_len,
                               prefix_embeds=_t(pre))
    _close(jl, tl)
    _close_caches(jc, tc)
    assert tc[0]["k"].shape[2] == cache_len
    pos = np.full((B,), ft + S - 1, np.int32)
    last = toks[..., -1:]                   # [B, 1] or [B, n_cb, 1]
    jl2, jc2 = jax.jit(lambda p, t, q, c: JM.decode_step(p, jcfg, t, q, c))(
        jp, jnp.asarray(last), jnp.asarray(pos), jc)
    with torch.no_grad():
        tl2, tc2 = TM.decode_step(tp, tcfg, _t(last), _t(pos), tc)
    _close(jl2, tl2)
    _close_caches(jc2, tc2)
    full, _ = jax.jit(lambda p, t, e: JM.forward(p, jcfg, t,
                                                 prefix_embeds=e))(
        jp, jnp.asarray(toks), _j(pre))
    _close(np.asarray(full)[:, -1], tl2[:, 0])


def test_prefix_positions_run_over_the_whole_sequence():
    """llava's default positions count the prefix: the prefix as explicit
    embeddings equals the same rows gathered from the table as tokens."""
    _, tcfg = _cfgs(LLAVA)
    tp = _port_params(LLAVA)
    toks, _ = _inputs(LLAVA, 3)
    ft = tcfg.frontend_tokens
    with torch.no_grad():
        rows = tp.embed[torch.from_numpy(toks[:, :ft]).long()]
        a, _ = TM.forward(tp, tcfg, _t(toks[:, ft:]), prefix_embeds=rows)
        b, _ = TM.forward(tp, tcfg, _t(toks))
        pos = torch.arange(S - ft, dtype=torch.int32)[None].expand(B, -1)
        c, _ = TM.forward(tp, tcfg, _t(toks[:, ft:]), positions=pos)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a[:, ft:], c, atol=1e-3)


def test_serve_steps_with_prefix_and_codebooks():
    """`make_serve_prefill` passes llava's prefix through; musicgen's
    `make_serve_decode` gives [B, n_cb, V], both as the reference's."""
    jcfg, tcfg = _cfgs(LLAVA)
    toks, pre = _inputs(LLAVA, 4)
    cache_len = tcfg.frontend_tokens + S
    jlast, _ = j_step.make_serve_prefill(jcfg, cache_len)(
        _ref_params(LLAVA), {"tokens": jnp.asarray(toks),
                             "prefix_embeds": jnp.asarray(pre)})
    tlast, _ = t_step.make_serve_prefill(tcfg, cache_len)(
        _port_params(LLAVA), {"tokens": _t(toks), "prefix_embeds": _t(pre)})
    _close(jlast, tlast)

    jcfg, tcfg = _cfgs(MUSIC)
    toks, _ = _inputs(MUSIC, 5)
    jp, tp = _ref_params(MUSIC), _port_params(MUSIC)
    _, jc = j_step.make_serve_prefill(jcfg, S)(
        jp, {"tokens": jnp.asarray(toks[..., :-1])})
    _, tc = t_step.make_serve_prefill(tcfg, S)(
        tp, {"tokens": _t(toks[..., :-1])})
    pos = np.full((B,), S - 1, np.int32)
    jnext, _ = j_step.make_serve_decode(jcfg)(
        jp, jnp.asarray(toks[..., -1:]), jnp.asarray(pos), jc)
    tnext, _ = t_step.make_serve_decode(tcfg)(tp, _t(toks[..., -1:]),
                                              _t(pos), tc)
    assert tuple(tnext.shape) == (B, tcfg.n_codebooks, tcfg.padded_vocab)
    _close(jnext, tnext)


# ---------------------------------------------------------------------------
# the loss and one training step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_codebooks_matches_reference(masked):
    rng = np.random.default_rng(12)
    logits = (rng.standard_normal((3, 7, 4, 37)) * 4).astype(np.float32)
    labels = rng.integers(0, 37, (3, 4, 7)).astype(np.int32)
    mask = None
    if masked:
        mask = (rng.random((3, 7)) < 0.6).astype(np.float32)
        mask[1] = 0.0
    want = JM.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            _j(mask))
    got = TM.cross_entropy(_t(logits), _t(labels), _t(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("arch", [LLAVA, MUSIC])
def test_loss_and_train_step_match_reference(arch):
    """`loss_fn` on the reference's batch (llava's prefix rows and its
    masked prefix positions, musicgen's grids), then one AdamW step."""
    jcfg, tcfg = _cfgs(arch)
    jb = j_synth_batch(jcfg, SHAPE, 9, 0)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    assert ("prefix_embeds" in tb) == (arch == LLAVA)
    jp = _ref_params(arch)
    jtotal, (jloss, _) = jax.jit(lambda p, b: j_step.loss_fn(p, jcfg, b))(
        jp, jb)
    tp = _port_params(arch).make_trainable()
    with torch.no_grad():
        ttotal, (tloss, _) = t_step.loss_fn(tp, tcfg, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(ttotal), float(jtotal), rtol=1e-5)

    jstep = jax.jit(j_step.make_train_step(jcfg, lr_peak=LR, warmup=1))
    jp2, _, jm = jstep(jp, {"adam": j_adamw.adamw_init(jp)}, jb)
    tstep = t_step.make_train_step(tcfg, lr_peak=LR, warmup=1)
    tp, state, tm = tstep(tp, {"adam": t_adamw.adamw_init(tp)}, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=2.0 ** -8)
    ref = dict(params_from_jax(jax.tree.map(np.asarray, jp2), tcfg,
                               "cpu").named_parameters())
    got = dict(tp.named_parameters())
    assert ref.keys() == got.keys()
    for name, p in got.items():
        np.testing.assert_allclose(_np(p), _np(ref[name]), rtol=0,
                                   atol=2 * float(tm["lr"]), err_msg=name)
    assert int(state["adam"]["step"]) == 1


# ---------------------------------------------------------------------------
# the codebook leaves
# ---------------------------------------------------------------------------

def test_codebook_leaves_match_reference():
    """init_params' embed [n_cb, Vp, D] and lm_head [D, n_cb·Vp] have the
    reference's shapes and draws (N(0,1)·0.02); params_from_jax carries
    them bit for bit; their bf16 compute copies are the per-use casts,
    and the forward is unchanged by them (`_embed` sums a grid's f32
    rows before its cast, as the reference does)."""
    kw = dict(d_model=256, vocab_size=1024, vocab_pad_to=256)
    want = jax.eval_shape(lambda k: JM.init_params(
        k, j_get_reduced(MUSIC).replace(**kw)), jax.random.PRNGKey(0))
    p = TM.init_params(get_reduced(MUSIC).replace(**kw),
                       torch.Generator().manual_seed(0))
    assert tuple(p.embed.shape) == want["embed"].shape == (2, 1024, 256)
    assert tuple(p.lm_head.shape) == want["lm_head"].shape == (256, 2048)
    for t in (p.embed, p.lm_head):
        assert abs(float(t.std()) / 0.02 - 1) < 0.05
    assert not torch.equal(p.embed[0], p.embed[1])

    jp, tp = _ref_params(MUSIC), _port_params(MUSIC, "bfloat16")
    np.testing.assert_array_equal(tp.embed.numpy(), np.asarray(jp["embed"]))
    np.testing.assert_array_equal(tp.lm_head.numpy(),
                                  np.asarray(jp["lm_head"]))
    tcfg = _cfgs(MUSIC, "bfloat16")[1]
    toks, _ = _inputs(MUSIC, 6)
    with torch.no_grad():
        before, _ = TM.forward(tp, tcfg, _t(toks))
        tp.load_compute_copy(tcfg.compute_dtype)
        assert tp._compute["lm_head"].dtype == torch.bfloat16
        assert torch.equal(tp.w("lm_head", "bfloat16"),
                           tp.lm_head.to(torch.bfloat16))
        assert torch.equal(tp.w("embed", "bfloat16"),
                           tp.embed.to(torch.bfloat16))
        after, _ = TM.forward(tp, tcfg, _t(toks))
    assert torch.equal(before, after)


def test_codebook_models_refused_by_the_engine():
    _, tcfg = _cfgs(MUSIC)
    tp = _port_params(MUSIC)
    with pytest.raises(NotImplementedError, match="codebook"):
        Engine(tcfg, tp, device="cpu")
    kv = KV.paged_kv_init(tcfg, num_pages=4, page_size=4, max_reqs=1,
                          max_pages_per_req=2, device="cpu")
    with pytest.raises(NotImplementedError, match="codebook"):
        paged_decode_step(tp, tcfg, torch.zeros(1, 2, 1, dtype=torch.int32),
                          torch.zeros(1, dtype=torch.int32), kv,
                          mode="torch")


# ---------------------------------------------------------------------------
# the dense archs through the engine
# ---------------------------------------------------------------------------

def _ref_greedy(jcfg, jp, prompt, n, cache_len=64):
    """The reference's contiguous greedy decode of `prompt`."""
    lg, caches, _ = jax.jit(lambda p, t: JM.prefill(
        p, jcfg, t, cache_len=cache_len))(jp, jnp.asarray(prompt,
                                                          jnp.int32)[None])
    out = [int(jnp.argmax(lg[0, -1]))]
    step = jax.jit(lambda p, t, pos, c: JM.decode_step(p, jcfg, t, pos, c))
    for t in range(len(prompt), len(prompt) + n - 1):
        lg, caches = step(jp, jnp.asarray([[out[-1]]], jnp.int32),
                          jnp.asarray([t], jnp.int32), caches)
        out.append(int(jnp.argmax(lg[0, 0])))
    return out


@pytest.mark.parametrize("arch", ["qwen1.5-110b", "llama3-405b", LLAVA])
def test_engine_matches_contiguous_reference(arch):
    """Three requests, one sharing the first's first page, through
    `Engine` in exec mode torch: every token equals the reference's
    contiguous greedy decode, and every page comes back."""
    jcfg, tcfg = _cfgs(arch)
    jp = JM.init_params(jax.random.PRNGKey(1), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(7)
    a = rng.integers(1, tcfg.vocab_size, 16)
    prompts = [a, np.concatenate([a[:8], rng.integers(1, tcfg.vocab_size,
                                                      8)]),
               rng.integers(1, tcfg.vocab_size, 16)]
    with t_exec.exec_mode("torch"):
        eng = Engine(tcfg, tp, max_reqs=2, num_pages=24, page_size=8,
                     max_pages_per_req=4, device="cpu")
        for i, pr in enumerate(prompts):
            eng.submit(Request(req_id=i, prompt=pr, max_new=5))
        outs = eng.run(max_steps=64)
    for i, pr in enumerate(prompts):
        assert outs[i] == _ref_greedy(jcfg, jp, pr, 5), f"request {i}"
    assert int(eng.kv.pool.num_free()) == 24
    assert eng.prefix_hits >= 1
