"""The launchers' configs and devices against the JAX reference.

* `launch.serve` serves `get_reduced(arch)` as it is, as the reference's
  launcher does (its `launch/serve.py` serves `get_reduced(arch)`): for
  every GQA transformer arch the config equals the reduced one, head_dim
  16 and G 2 included (the paged_attention kernel takes D 16), and its
  shapes equal the reference's reduced config's; recurrent, MLA and
  codebook archs are refused.
* The engine on that config (reduced qwen3-1.7b, D 16, G 2, f32 compute,
  exec mode torch) serves the tokens of the reference's contiguous greedy
  decode (the reference's own `Engine` fails under the installed jax).
* `launch.train` trains the reduced hymba-1.5b on the CPU in exec mode
  torch (on the card it takes mode gpu: the scan's kernels and their
  backward).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import repro  # noqa: F401  (enables x64)
from repro.configs import get_reduced as j_get_reduced
from repro.models import model as JM
from repro_torch.configs import ARCHS, get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.serving.engine import Engine, Request
from repro_torch.store import exec as t_exec

SERVED = [a for a in ARCHS if (lambda c: c.attn_type == "gqa"
                               and c.block_pattern == "transformer"
                               and not c.n_codebooks)(get_reduced(a))]
SHAPE_FIELDS = ("d_model", "n_layers", "n_heads", "n_kv_heads",
                "resolved_head_dim", "vocab_size", "compute_dtype")


@pytest.mark.parametrize("arch", SERVED)
def test_serve_config_is_the_reduced_config(arch):
    cfg = launch_serve.serve_config(arch)
    assert cfg == get_reduced(arch)
    ref = j_get_reduced(arch)
    assert {f: getattr(cfg, f) for f in SHAPE_FIELDS} == {
        f: getattr(ref, f) for f in SHAPE_FIELDS}
    assert (cfg.resolved_head_dim, cfg.n_heads // cfg.n_kv_heads) == (16, 2)


@pytest.mark.parametrize("arch", sorted(set(ARCHS) - set(SERVED)))
def test_serve_config_refuses_what_the_engine_cannot_serve(arch):
    with pytest.raises(SystemExit, match=arch):
        launch_serve.serve_config(arch)


def test_engine_on_the_served_config_matches_reference():
    arch = "qwen3-1.7b"
    tcfg = launch_serve.serve_config(arch).replace(compute_dtype="float32")
    jcfg = j_get_reduced(arch).replace(compute_dtype="float32")
    jp = JM.init_params(jax.random.PRNGKey(4), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, tcfg.vocab_size, n) for n in (5, 9, 7)]
    new = 4
    with t_exec.exec_mode("torch"):
        eng = Engine(tcfg, tp, max_reqs=2, num_pages=16, page_size=8,
                     max_pages_per_req=4, device="cpu", exec_mode="torch")
        for i, pr in enumerate(prompts):
            eng.submit(Request(req_id=i, prompt=pr, max_new=new))
        outs = eng.run(max_steps=64)
    prefill = jax.jit(lambda p, t: JM.prefill(p, jcfg, t, cache_len=32)[:2])
    decode = jax.jit(lambda p, t, pos, c: JM.decode_step(p, jcfg, t, pos, c))
    for i, pr in enumerate(prompts):
        lg, caches = prefill(jp, jnp.asarray(pr, jnp.int32)[None])
        want = [int(jnp.argmax(lg[0, -1]))]
        for t in range(len(pr), len(pr) + new - 1):
            lg, caches = decode(jp, jnp.asarray([[want[-1]]], jnp.int32),
                                jnp.asarray([t], jnp.int32), caches)
            want.append(int(jnp.argmax(lg[0, 0])))
        assert outs[i] == want, f"request {i}"
    assert int(eng.kv.pool.num_free()) == 16


def test_train_launcher_trains_hymba_on_the_cpu(capsys):
    launch_train.main(["--arch", "hymba-1.5b", "--steps", "2", "--seq",
                       "16", "--batch", "2", "--device", "cpu"])
    assert "final loss" in capsys.readouterr().out
    assert t_exec.get_mode() == "gpu"          # the scope ended with it
