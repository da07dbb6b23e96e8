"""The folded fill-drain pipeline (`repro_torch.parallel.pipeline`) against
the JAX reference, on the CPU.

The reference's own check (`tests/multidev/pipeline_prog.py`): S stages
of tanh(x @ w_i) over M microbatches equal their sequential composition
within 1e-5 in f32. Here the sequential composition is computed in JAX
from the same numpy-seeded weights and the port's pipeline is held to it
within 1e-5, over stage and microbatch counts that make the bubble
longer and shorter than the stream; the port's loop over the stages
also equals its own sequential composition, microbatch by microbatch,
bit for bit. A dict tree of stage parameters, the schedule's tick count
and the stage calls are checked too, and a skipped shift (the planted
fault) must break the match.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro_torch.core.routing import ShardMesh
from repro_torch.parallel import pipeline

TOL = 1e-5
CASES = [(4, 6, 2, 16), (4, 1, 3, 8), (2, 5, 2, 16), (1, 3, 2, 8),
         (3, 8, 1, 32)]


def _inputs(s, m, b, d, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((s, d, d)) / np.sqrt(d)).astype(np.float32)
    xs = rng.standard_normal((m, b, d)).astype(np.float32)
    return w, xs


def _jax_sequential(w, xs):
    ref = jnp.asarray(xs)
    for i in range(w.shape[0]):
        ref = jnp.tanh(ref @ jnp.asarray(w[i]))
    return np.asarray(ref)


@pytest.mark.parametrize("s,m,b,d", CASES)
def test_pipeline_matches_sequential(s, m, b, d):
    w, xs = _inputs(s, m, b, d)
    calls = []

    def stage_fn(wi, x):
        calls.append(1)
        return torch.tanh(x @ wi)

    run = pipeline.pipeline_apply(stage_fn, ShardMesh(("stage",), (s,)))
    ys = run(torch.from_numpy(w), torch.from_numpy(xs))
    assert ys.shape == xs.shape and ys.dtype == torch.float32
    assert len(calls) == s * (m + s - 1)       # every stage, every tick
    np.testing.assert_allclose(ys.numpy(), _jax_sequential(w, xs), rtol=0,
                               atol=TOL)
    seq = []                   # each microbatch through the stages
    for x in torch.from_numpy(xs):
        for i in range(s):
            x = torch.tanh(x @ torch.from_numpy(w[i]))
        seq.append(x)
    assert torch.equal(ys, torch.stack(seq))


def test_pipeline_takes_a_tree_of_stage_params():
    s, m, b, d = 3, 4, 2, 8
    w, xs = _inputs(s, m, b, d, seed=1)
    bias = np.random.default_rng(2).standard_normal((s, d)).astype(np.float32)
    params = {"w": torch.from_numpy(w), "b": [torch.from_numpy(bias)]}
    run = pipeline.pipeline_apply(
        lambda p, x: torch.tanh(x @ p["w"] + p["b"][0]),
        ShardMesh(("data", "stage"), (2, s)), axis="stage")
    ys = run(params, torch.from_numpy(xs))
    ref = jnp.asarray(xs)
    for i in range(s):
        ref = jnp.tanh(ref @ jnp.asarray(w[i]) + jnp.asarray(bias[i]))
    np.testing.assert_allclose(ys.numpy(), np.asarray(ref), rtol=0, atol=TOL)
    with pytest.raises(ValueError, match=r"lead with \[3\] stages"):
        pipeline.pipeline_apply(lambda p, x: x,
                                ShardMesh(("stage",), (4,)))(params,
                                                             torch.zeros(2))


def test_skipped_shift_breaks_the_match(monkeypatch):
    s, m, b, d = 4, 6, 2, 16
    w, xs = _inputs(s, m, b, d)
    monkeypatch.setattr(pipeline, "_shift", lambda y, zeros: list(y))
    run = pipeline.pipeline_apply(lambda wi, x: torch.tanh(x @ wi),
                                  ShardMesh(("stage",), (s,)))
    ys = run(torch.from_numpy(w), torch.from_numpy(xs))
    assert np.abs(ys.numpy() - _jax_sequential(w, xs)).max() > 100 * TOL
