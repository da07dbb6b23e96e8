"""Fault-tolerant training loop (counterpart of `repro.train.loop`).

* checkpoint/restart: atomic saves every `ckpt_every` steps (async by
  default), resume from the latest on start; the data stream is a pure
  function of (seed, step), so a restarted run continues the
  uninterrupted one.
* straggler mitigation: prefetch depth + a deadline fallback in the data
  pipeline (a slow producer never stalls the step).
* elastic: `restore` loads onto whatever device the new run uses.
"""
from __future__ import annotations

import time

import torch

from repro_torch.checkpoint.ckpt import AsyncSaver, latest_step, restore, save
from repro_torch.core.layout import resolve_device
from repro_torch.data.pipeline import PrefetchPipeline, synth_batch
from repro_torch.models import model as M
from repro_torch.optim.adamw import adamw_init
from repro_torch.train.step import make_train_step


def train(cfg, shape, *, steps: int, seed: int = 0, ckpt_dir: str | None = None,
          ckpt_every: int = 0, microbatches: int = 1, delay_injector=None,
          log_every: int = 10, async_save: bool = True,
          lr_peak: float = 3e-4, device="cuda", params=None):
    """Returns (params, opt_state, out): `out["history"]` has a row a
    step (step, loss, grad_norm, time, and get_time, the seconds spent
    waiting in the pipeline's `get`), `out["straggler_skips"]` and
    `out["pipeline"]`, the stopped (drained) pipeline. Resumes from `ckpt_dir` if
    it has a checkpoint. `params` (an `LM`; made trainable here) replaces
    the seeded initialization: the port's generator is not the
    reference's, so a comparison carries the reference's parameters
    across."""
    dev = resolve_device(device)
    if params is None:
        params = M.init_params(cfg, torch.Generator(dev).manual_seed(seed))
    params.make_trainable()
    opt_state = {"adam": adamw_init(params)}
    start = 0
    if ckpt_dir is not None:
        last = latest_step(ckpt_dir)
        if last is not None:
            (params, opt_state), meta = restore(ckpt_dir, last,
                                                (params, opt_state), dev)
            start = int(meta["next_step"])

    step_fn = make_train_step(cfg, microbatches=microbatches,
                              lr_peak=lr_peak)
    # the producer starts at the resume step: no already-trained batch is
    # made again
    pipe = PrefetchPipeline(lambda s: synth_batch(cfg, shape, seed, s,
                                                  device=dev),
                            depth=4, deadline=5.0,
                            delay_injector=delay_injector, device=dev,
                            start=start)
    saver = AsyncSaver()
    history = []
    try:
        for step in range(start, steps):
            t0 = time.monotonic()
            batch = pipe.get(step)
            t_get = time.monotonic() - t0
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            gnorm = float(metrics["grad_norm"])
            history.append({"step": step, "loss": loss, "grad_norm": gnorm,
                            "time": time.monotonic() - t0,
                            "get_time": t_get})
            if log_every and step % log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
                      f"dt {history[-1]['time']*1e3:.0f}ms", flush=True)
            if ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0:
                meta = {"next_step": step + 1}
                if async_save:
                    saver.save(ckpt_dir, step + 1, (params, opt_state), meta)
                else:
                    save(ckpt_dir, step + 1, (params, opt_state), meta)
    finally:
        saver.wait()
        pipe.stop()
    return params, opt_state, {"history": history,
                               "straggler_skips": pipe.straggler_skips,
                               "pipeline": pipe}
