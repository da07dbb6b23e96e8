#!/usr/bin/env python3
"""Where a plan's time goes in the PyTorch/CUDA port, per backend, on the
main path's own stream; with --serve, where the serving engine's time
goes; with --hymba, --xlstm or --mla, where hymba-1.5b's,
xlstm-1.3b's or minicpm3-4b's prefill and decode time goes; with
--sharded, where the sharded store engine's time goes; with --train,
where a training step's time goes; with --dense ARCH or --musicgen,
where the last four archs' engine decode and contiguous prefill and
decode time goes.

    python3 tools/torch_store_profile.py [--serve | --hymba | --xlstm |
                                          --mla | --sharded | --train |
                                          --dense ARCH | --musicgen]

Needs a CUDA card. Builds `chip_smoke.py`'s streams at their default seed
and runs them in exec mode `gpu` through `StoreEngine`: the KV stream (a
preload of 0.75 * 2^24 fresh keys in plans of 65,536 lanes, then 16
Workload 1 and 16 Workload 2 plans of 4,096 lanes) for det_skiplist,
hash+skiplist, tiered3/lru, tiered3 and tiered3/b128 (the same stack in
its two warm layouts), fixed_hash, rand_skiplist, splitorder and
twolevel_splitorder (the one-level table's global array beside the
per-table one that runs the splitorder_probe kernel) at chip_smoke's
capacities, and the pq
stream (`make_pq_stream`: a preload of 2^23 priority keys, then 16 P1
and 16 P2 plans) for pq. Three windows per cell are profiled with
`torch.profiler` (CPU + CUDA activities): the last 4 preload plans and
each workload's plans; the preload plans before them run unprofiled.
Prints per backend and window: host ms per plan (synchronized), device-busy ms per plan
(sum of device self time), the device's idle share of the wall time, host
syncs per plan, the port's own kernels' ms per plan (and each one's),
dispatches per plan and the top device ops; the full tables go to
`bench_out/torch_profile_<backend>_<window>.txt`.

--serve profiles chip_smoke.py's serving cell instead: qwen3-1.7b at full
width behind `Engine` (bf16 compute, exec mode gpu) on chip_smoke's trace,
driven tick by tick through `serving.traffic.ticks` (replay's loop); two
windows of engine steps are profiled, one while requests still arrive
(admission, prefill and decode) and one of decode only after the last
admission, with the same columns per engine step (the paged_attention
kernel among the port's kernels).

--hymba profiles chip_smoke.py's hymba cell: hymba-1.5b at full width and
depth (bf16 compute, attn_impl "xla_flash", exec mode gpu), one prefill of
8 prompts x 4,096 tokens and then 8 decode steps, each after an
unprofiled warm-up, with the same columns per prefill and per decode step
(the flash_attention and selective_scan kernels among the port's).
--xlstm and --mla do the same for chip_smoke.py's phases 9 and 10:
xlstm-1.3b and minicpm3-4b at full width and depth (bf16 compute), one
prefill of 8 prompts x 4,096 tokens and 8 decode steps (no port kernel
is on either path).

--dense ARCH profiles one of chip_smoke.py's phase 11 archs
(qwen1.5-110b, llama3-405b or llava-next-mistral-7b at its depth there)
behind `Engine` on phase 11's trace: a window of 10 engine steps once
every request is admitted (decode only, the paged_attention kernel among
the port's); for llava also phase 12's contiguous prefill of 8 x 4,096
positions (1,152 prefix rows each) and 8 decode steps. --musicgen
profiles phase 13: musicgen-medium at full width and depth, one prefill
of 8 x 4,096 frames of 4 codebooks and 8 decode steps.

--sharded profiles chip_smoke.py's phase 6 cells: det_skiplist and
tiered3/lru behind the sharded `StoreEngine` on the production mesh
(16 x 16 shards of 4,096 lanes, pool factor 2, exec mode gpu) on
`make_shard_stream`: every preload step but the last runs unprofiled,
then three windows, the last preload step and each workload's steps,
with the same columns per step (2^20 lanes).

--train profiles chip_smoke.py's train cell: qwen3-1.7b at full width
and depth (f32 parameters and AdamW moments, bf16 compute, remat,
attn_impl "xla"), one step of 8 x 4,096 tokens in 4 microbatches after an
unprofiled one, its batch from `synth_batch` on the card, with the same
columns per step.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "bench_out"
PROFILED_PRELOAD = 4
PORT_KERNELS = ("skiplist_search_kernel", "hash_probe_kernel",
                "tier_find_kernel", "tier_apply_member_kernel",
                "tier_apply_scan_kernel", "bskiplist_walk_kernel",
                "pq_count_kernel", "pq_scan_kernel", "pq_select_kernel",
                "splitorder_probe_kernel", "paged_split_kernel",
                "paged_merge_kernel", "flash_wgmma_kernel",
                "flash_f32_kernel", "selective_scan_kernel")
HYMBA_DECODE_STEPS = 8
# (label, first tick or None = after the last admission, ticks)
SERVE_WINDOWS = (("serve arriving", 20, 30), ("serve decode", None, 10))
SYNC_EVENTS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
               "aten::_local_scalar_dense")


def self_device_us(e) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, attr):
            return float(getattr(e, attr))
    return 0.0


def on_device(e) -> bool:
    """A kernel or memcpy event (device time counted once, not again
    through the CPU op that launched it)."""
    return "CUDA" in str(getattr(e, "device_type", ""))


def profile_window(torch, exec_, engines, st, plans, label: str):
    """Run `plans` under the profiler; print and write the breakdown."""
    def run():
        nonlocal st
        for _, ops, keys, vals in plans:
            st, _, _, _ = engines[ops.shape[0]].step(st, ops, keys, vals)
    report(torch, exec_, run, len(plans), f"{plans[0][1].shape[0]} lanes",
           "plan", label)
    return st


def report(torch, exec_, run, n: int, what: str, unit: str, label: str):
    """Profile `run()` (n units of work); print and write the breakdown."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with exec_.measure_dispatches() as meter:
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    avg = prof.key_averages()
    kernels = [e for e in avg if on_device(e)]
    busy_ms = sum(self_device_us(e) for e in kernels) / 1e3 / n
    port_ms = sum(self_device_us(e) for e in kernels
                  if any(k in e.key for k in PORT_KERNELS)) / 1e3 / n
    syncs = sum(e.count for e in avg if e.key in SYNC_EVENTS) / n
    launches = sum(e.count for e in kernels)
    print(f"{label}: {n} {unit}s of {what}, "
          f"{wall_ms:.3f} ms/{unit} host, {busy_ms:.3f} ms/{unit} device "
          f"busy, idle share {1 - busy_ms / wall_ms:.3f}, {syncs:.1f} "
          f"syncs/{unit}, {launches / n:.1f} device ops/{unit}, port kernels "
          f"{port_ms:.4f} ms/{unit}, dispatches/{unit} {meter.n / n:.1f}",
          flush=True)
    for e in kernels:
        if any(k in e.key for k in PORT_KERNELS):
            print(f"    port   {self_device_us(e) / n / 1e3:9.4f} ms/{unit} "
                  f"x{e.count / n:<5.1f} {e.key[:70]}", flush=True)
    for e in sorted(kernels, key=self_device_us, reverse=True)[:6]:
        print(f"    device {self_device_us(e) / n / 1e3:9.4f} ms/{unit} "
              f"x{e.count // n:<5d} {e.key[:70]}", flush=True)
    for e in sorted((e for e in avg if not on_device(e)),
                    key=lambda e: e.self_cpu_time_total, reverse=True)[:4]:
        print(f"    host   {e.self_cpu_time_total / n / 1e3:9.4f} ms/{unit} "
              f"x{e.count // n:<5d} {e.key[:70]}", flush=True)
    name = label.replace("/", "_").replace("+", "_").replace(" ", "_")
    (OUT / f"torch_profile_{name}.txt").write_text("".join(
        f"{self_device_us(e):14.1f} us device {e.self_cpu_time_total:14.1f}"
        f" us host  x{e.count:<7d} {e.key}\n"
        for e in sorted(avg, key=self_device_us, reverse=True)))


def sharded_profile(torch, cs, exec_) -> None:
    """The sharded store's cells (see the module docstring)."""
    plans = cs.to_device(torch, cs.make_shard_stream(0))
    n_pre = cs.SHARD_PRELOAD_STEPS
    for name, cap, _ in cs.SHARD_CELLS:
        eng = cs.shard_engine(torch, name, "gpu")
        st = eng.init(cap)
        for _, ops, keys, vals in plans[:n_pre - 1]:
            st, _, _, _ = eng.step(st, ops, keys, vals)
        engines = {plans[0][1].shape[0]: eng}
        for label, window in (
                ("preload", plans[n_pre - 1:n_pre]),
                ("wl1", [p for p in plans if p[0] == "wl1"]),
                ("wl2", [p for p in plans if p[0] == "wl2"])):
            st = profile_window(torch, exec_, engines, st, window,
                                f"sharded {name} {label}")
        del st, eng, engines
        torch.cuda.empty_cache()


def serve_profile(torch, cs, exec_) -> None:
    """chip_smoke's serving cell, driven through `traffic.ticks` (replay's
    tick loop) with two profiled windows of engine steps (SERVE_WINDOWS:
    ticks [20, 50) while requests arrive, and 10 steps once every request
    is admitted)."""
    import itertools
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving import traffic
    from repro_torch.serving.engine import Engine
    cfg = get_config(cs.SERVE_ARCH)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0))
    trace = traffic.make_trace(0, **cs.SERVE_TRACE)
    eng = Engine(cfg, params, max_reqs=cs.SERVE_BATCH,
                 num_pages=cs.SERVE_NUM_PAGES, page_size=cs.SERVE_PAGE,
                 max_pages_per_req=cs.SERVE_PAGES_PER_REQ, exec_mode="gpu")
    clock = traffic.ticks(eng, trace, max_steps=cs.SERVE_MAX_TICKS)
    t = -1                                  # the last tick run
    for label, lo, n in SERVE_WINDOWS:
        if lo is None:       # after the last admission
            while (len(eng.requests) < len(trace)
                   or any(r.slot < 0 for r in eng.requests.values())):
                t = next(clock)
        else:
            while t + 1 < lo:
                t = next(clock)

        def run():
            nonlocal t
            for t in itertools.islice(clock, n):
                pass
        report(torch, exec_, run, n, cs.SERVE_ARCH, "step", label)
    print(f"serve: {eng.steps} decode steps, metrics {eng.metrics()}",
          flush=True)


def model_profile(torch, exec_, label, cfg, b, p, new, seed,
                  params=None) -> None:
    """One profiled prefill of b prompts x p positions (cache_len p + new;
    a codebook model's [b, n_cb, p] frames, or `frontend_tokens` prefix
    rows and p - ft tokens) and HYMBA_DECODE_STEPS profiled decode steps,
    each after a warm-up; seeded f32 parameters with a compute copy, as
    chip_smoke draws them, unless `params` are given."""
    import numpy as np
    from repro_torch.models import model as M
    if params is None:
        params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    params.load_compute_copy(cfg.compute_dtype)
    rng = np.random.default_rng(seed)
    ft = cfg.frontend_tokens
    shape = (b, cfg.n_codebooks, p) if cfg.n_codebooks else (b, p - ft)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, shape)).cuda()
    pre = None
    if ft:
        pre = torch.from_numpy(rng.standard_normal(
            (b, ft, cfg.d_model)).astype(np.float32) * 0.02).cuda()
    st = {}

    def prefill():
        lg, st["caches"], _ = M.prefill(params, cfg, toks, p + new,
                                        prefix_embeds=pre)
        st["tok"], st["pos"] = torch.argmax(lg[:, -1], -1), p

    def decode(n):
        for _ in range(n):
            pos = torch.full((b,), st["pos"], device="cuda")
            lg, st["caches"] = M.decode_step(params, cfg,
                                             st["tok"][..., None], pos,
                                             st["caches"])
            st["tok"], st["pos"] = torch.argmax(lg[:, 0], -1), st["pos"] + 1

    prefill()
    report(torch, exec_, prefill, 1, f"{b} x {p} tokens", "prefill",
           f"{label} prefill")
    decode(2)
    report(torch, exec_, lambda: decode(HYMBA_DECODE_STEPS),
           HYMBA_DECODE_STEPS, f"{b} lanes", "step", f"{label} decode")


def dense_profile(torch, cs, exec_, arch: str) -> None:
    """One of chip_smoke's phase 11 archs behind `Engine` (its depth, 16
    slots, 1,024 pages, the trace over its vocabulary): 10 engine steps
    profiled once every request is admitted; for llava then phase 12's
    prefix prefill and decode on the same weights."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving import traffic
    from repro_torch.serving.engine import Engine
    layers = dict(cs.DENSE_ARCHS)[arch]
    cfg = get_config(arch).replace(n_layers=layers)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0))
    trace = traffic.make_trace(0, **dict(cs.MOE_TRACE, vocab=cfg.vocab_size))
    eng = Engine(cfg, params, max_reqs=cs.MOE_BATCH,
                 num_pages=cs.MOE_NUM_PAGES, page_size=cs.SERVE_PAGE,
                 max_pages_per_req=cs.SERVE_PAGES_PER_REQ, exec_mode="gpu")
    clock = traffic.ticks(eng, trace, max_steps=cs.SERVE_MAX_TICKS)
    while (len(eng.requests) < len(trace)
           or any(r.slot < 0 for r in eng.requests.values())):
        next(clock)

    def run():
        for _ in range(10):
            next(clock)
    report(torch, exec_, run, 10, f"{arch}, {layers} layers", "step",
           f"{arch} engine decode")
    for _ in clock:
        pass
    del eng
    torch.cuda.empty_cache()
    if arch == cs.PREFIX_ARCH:
        model_profile(torch, exec_, f"{arch} prefix", cfg, cs.PREFIX_BATCH,
                      cs.PREFIX_SEQ, cs.LM_NEW, 24, params)


def train_profile(torch, cs, exec_) -> None:
    """chip_smoke's train cell: one profiled train step after an
    unprofiled one."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.step import make_train_step
    cfg = get_config(cs.TRAIN_ARCH)
    shape = dataclasses.replace(SHAPES["train_4k"],
                                global_batch=cs.TRAIN_BATCH)
    st = {"params": M.init_params(cfg, torch.Generator("cuda").manual_seed(0)
                                  ).make_trainable(), "step": 0}
    st["opt"] = {"adam": adamw_init(st["params"])}
    step = make_train_step(cfg, microbatches=cs.TRAIN_MICRO)

    def run():
        batch = synth_batch(cfg, shape, 0, st["step"], device="cuda")
        st["params"], st["opt"], m = step(st["params"], st["opt"], batch)
        float(m["loss"])
        st["step"] += 1

    run()
    report(torch, exec_, run, 1, f"{shape.global_batch} x {shape.seq_len} "
           f"tokens, {cs.TRAIN_MICRO} microbatches", "step", "train step")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_store_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.store import exec as exec_
    from repro_torch.store.engine import LOCAL_MESH, StoreEngine

    OUT.mkdir(parents=True, exist_ok=True)
    print(f"device {torch.cuda.get_device_name(0)}", flush=True)
    if "--serve" in sys.argv[1:]:
        serve_profile(torch, cs, exec_)
        return 0
    from repro_torch.configs import get_config
    for flag, arch, label in (("--hymba", cs.HYMBA_ARCH, "hymba"),
                              ("--xlstm", cs.XLSTM_ARCH, "xlstm"),
                              ("--mla", cs.MLA_ARCH, "mla")):
        if flag not in sys.argv[1:]:
            continue
        if label == "hymba":
            model_profile(torch, exec_, label, get_config(arch).replace(
                attn_impl="xla_flash"), cs.HYMBA_BATCH, cs.HYMBA_PROMPT,
                cs.HYMBA_NEW, 15)
        else:
            model_profile(torch, exec_, label, get_config(arch),
                          cs.LM_BATCH, cs.LM_PROMPT, cs.LM_NEW, 24)
        return 0
    if "--dense" in sys.argv[1:]:
        dense_profile(torch, cs, exec_,
                      sys.argv[sys.argv.index("--dense") + 1])
        return 0
    if "--musicgen" in sys.argv[1:]:
        model_profile(torch, exec_, "musicgen", get_config(cs.MUSIC_ARCH),
                      cs.LM_BATCH, cs.LM_PROMPT, cs.LM_NEW, 24)
        return 0
    if "--train" in sys.argv[1:]:
        train_profile(torch, cs, exec_)
        return 0
    if "--sharded" in sys.argv[1:]:
        sharded_profile(torch, cs, exec_)
        return 0
    C = 1 << cs.LOG2_CAPACITY
    kv = cs.to_device(torch, cs.make_stream(0))
    pq = cs.to_device(torch, cs.make_pq_stream(0)[0])
    for name, cap, plans in (("det_skiplist", C, kv), ("hash+skiplist", C, kv),
                             ("tiered3/lru", C // 2, kv),
                             ("tiered3", C // 2, kv),
                             ("tiered3/b128", C // 2, kv),
                             ("fixed_hash", C, kv), ("rand_skiplist", C, kv),
                             ("splitorder", C, kv),
                             ("twolevel_splitorder", C, kv),
                             ("pq", 1 << cs.PQ_LOG2_CAPACITY, pq)):
        n_pre = sum(tag == "preload" for tag, *_ in plans)
        tags = sorted({tag for tag, *_ in plans} - {"preload"})
        windows = [("preload", plans[n_pre - PROFILED_PRELOAD:n_pre])] + [
            (t, [p for p in plans if p[0] == t]) for t in tags]
        engines = {w: StoreEngine(LOCAL_MESH, LOCAL_MESH.axis_names, w, name,
                                  pool_factor=1, exec_mode="gpu")
                   for w in {p[1].shape[0] for p in plans}}
        st = engines[plans[0][1].shape[0]].init(cap)
        for _, ops, keys, vals in plans[:n_pre - PROFILED_PRELOAD]:
            st, _, _, _ = engines[ops.shape[0]].step(st, ops, keys, vals)
        for label, window in windows:
            st = profile_window(torch, exec_, engines, st, window,
                                f"{name} {label}")
        del st, engines
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
