#!/usr/bin/env python3
"""Where a plan's time goes in the PyTorch/CUDA port, per backend, on the
main path's own stream.

    python3 tools/torch_store_profile.py

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
                "splitorder_probe_kernel")
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
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with exec_.measure_dispatches() as meter:
            for _, ops, keys, vals in plans:
                st, _, _, _ = engines[ops.shape[0]].step(st, ops, keys, vals)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / len(plans)
    n = len(plans)
    avg = prof.key_averages()
    kernels = [e for e in avg if on_device(e)]
    busy_ms = sum(self_device_us(e) for e in kernels) / 1e3 / n
    port_ms = sum(self_device_us(e) for e in kernels
                  if any(k in e.key for k in PORT_KERNELS)) / 1e3 / n
    syncs = sum(e.count for e in avg if e.key in SYNC_EVENTS) / n
    print(f"{label}: {n} plans of {plans[0][1].shape[0]} lanes, "
          f"{wall_ms:.3f} ms/plan host, {busy_ms:.3f} ms/plan device busy, "
          f"idle share {1 - busy_ms / wall_ms:.3f}, {syncs:.1f} syncs/plan, "
          f"port kernels {port_ms:.4f} ms/plan, dispatches/plan "
          f"{meter.n / n:.1f}", flush=True)
    for e in kernels:
        if any(k in e.key for k in PORT_KERNELS):
            print(f"    port   {self_device_us(e) / n / 1e3:9.4f} ms/plan "
                  f"x{e.count / n:<5.1f} {e.key[:70]}", flush=True)
    for e in sorted(kernels, key=self_device_us, reverse=True)[:6]:
        print(f"    device {self_device_us(e) / n / 1e3:9.4f} ms/plan "
              f"x{e.count // n:<5d} {e.key[:70]}", flush=True)
    for e in sorted((e for e in avg if not on_device(e)),
                    key=lambda e: e.self_cpu_time_total, reverse=True)[:4]:
        print(f"    host   {e.self_cpu_time_total / n / 1e3:9.4f} ms/plan "
              f"x{e.count // n:<5d} {e.key[:70]}", flush=True)
    name = label.replace("/", "_").replace("+", "_").replace(" ", "_")
    (OUT / f"torch_profile_{name}.txt").write_text("".join(
        f"{self_device_us(e):14.1f} us device {e.self_cpu_time_total:14.1f}"
        f" us host  x{e.count:<7d} {e.key}\n"
        for e in sorted(avg, key=self_device_us, reverse=True)))
    return st


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_store_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.store import exec as exec_
    from repro_torch.store.engine import StoreEngine

    OUT.mkdir(parents=True, exist_ok=True)
    print(f"device {torch.cuda.get_device_name(0)}", flush=True)
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
        engines = {w: StoreEngine(w, name, exec_mode="gpu")
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
