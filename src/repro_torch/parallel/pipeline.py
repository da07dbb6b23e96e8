"""Pipeline parallelism: the GPipe fill-drain schedule over a stage axis
(counterpart of `repro.parallel.pipeline`).

The reference gives each device on the `stage` axis one stage's
parameters and moves activations stage to stage with a `ppermute` (i ->
i + 1), one microbatch injected a tick: n_micro + n_stages - 1 ticks,
bubble share (S - 1) / (M + S - 1). Here the S stages of a
`core.routing.ShardMesh` are folded onto one device and the schedule is
kept tick for tick: every stage runs `stage_fn` on every tick, in a loop
over the stages (not batched), and the ppermute is a shift of the
per-stage buffer by one stage with zeros into stage 0. Each stage's
`stage_fn` call sees exactly the input the sequential composition gives
it, so the outputs equal the sequential application of the stages bit
for bit (the fill and drain ticks' extra calls are discarded).
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_leaves, tree_map


def _shift(y: list, zeros: torch.Tensor) -> list:
    """The ppermute i -> i + 1 over the stages' outputs: stage 0 receives
    nothing (zeros)."""
    return [zeros] + y[:-1]


def pipeline_apply(stage_fn, mesh, axis: str = "stage"):
    """A pipelined apply: fn(stage_params, micro_x) -> ys.

    stage_params: a tree (tensor, dict, list or tuple) whose tensors have
    a leading dim of n_stages = `mesh.shape[axis]`. micro_x: [n_micro,
    ...]. stage_fn(params_slice, x) -> y of x's shape. ys [n_micro, ...]
    are the last stage's outputs in microbatch order, which the
    reference hands to every stage.
    """
    n_stages = mesh.shape[axis]

    def fn(stage_params, xs: torch.Tensor) -> torch.Tensor:
        lead = {t.shape[0] for t in tree_leaves(stage_params)}
        if lead != {n_stages}:
            raise ValueError(f"stage_params lead with {sorted(lead)} "
                             f"stages; the {axis!r} axis has {n_stages}")
        params = [tree_map(lambda t, s=s: t[s], stage_params)
                  for s in range(n_stages)]
        n_micro = xs.shape[0]
        buf = [torch.zeros_like(xs[0]) for _ in range(n_stages)]
        ys = torch.zeros_like(xs)
        for t in range(n_micro + n_stages - 1):
            # stage 0 injects microbatch t; stage s works on t - s
            x_in = [xs[min(t, n_micro - 1)]] + buf[1:]
            y = [stage_fn(params[s], x_in[s]) for s in range(n_stages)]
            out_idx = t - (n_stages - 1)
            if out_idx >= 0:
                ys[out_idx] = y[-1]
            buf = _shift(y, torch.zeros_like(xs[0]))
        return ys

    return fn
