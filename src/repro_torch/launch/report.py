"""Markdown tables from the dry run's and the roofline's JSON reports
(counterpart of `repro.launch.report`).

  PYTHONPATH=src python -m repro_torch.launch.report --kind dryrun
  PYTHONPATH=src python -m repro_torch.launch.report --kind roofline
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load(d: str) -> dict:
    out = {}
    for p in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(p) as f:
            rep = json.load(f)
        out[(rep["arch"], rep["shape"], rep["mesh"])] = rep
    return out


def dryrun_table(d: str = "reports/torch/dryrun") -> None:
    reps = load(d)
    print("| arch | shape | mesh | flops/dev (traced) | bytes/dev | "
          "collective B/dev | arg GiB/dev | temp GiB/dev | collectives |")
    print("|---|---|---|---|---|---|---|---|---|")
    for (arch, shape, mesh), r in sorted(reps.items()):
        mem = r.get("memory", {})
        arg = mem.get("argument_bytes", 0) / 2**30
        tmp = mem.get("temp_bytes", 0) / 2**30
        colls = ",".join(f"{k.split('-')[-1][:4]}:{v['count']}"
                         for k, v in sorted(r.get("collectives", {}).items()))
        print(f"| {arch} | {shape} | {mesh} | {r['flops']:.2e} | "
              f"{r['bytes_accessed']:.2e} | "
              f"{r['collective_bytes_total']:.2e} | "
              f"{arg:.2f} | {tmp:.2f} | {colls} |")


def roofline_table(d: str = "reports/torch/roofline") -> None:
    reps = load(d)
    print("| arch | shape | mesh | compute ms | memory ms | collective ms | "
          "dominant | MODEL_FLOPS | useful | roofline frac |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for (arch, shape, mesh), r in sorted(reps.items()):
        t = r["terms"]
        print(f"| {arch} | {shape} | {mesh} | {t['compute_s'] * 1e3:.2f} | "
              f"{t['memory_s'] * 1e3:.2f} | {t['collective_s'] * 1e3:.2f} | "
              f"{r['dominant'][:-2]} | {r['model_flops']:.2e} | "
              f"{r['useful_ratio']:.2f} | {r['roofline_fraction']:.3f} |")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kind", choices=["dryrun", "roofline"],
                    default="dryrun")
    ap.add_argument("--dir", default=None)
    a = ap.parse_args(argv)
    if a.kind == "dryrun":
        dryrun_table(a.dir or "reports/torch/dryrun")
    else:
        roofline_table(a.dir or "reports/torch/roofline")


if __name__ == "__main__":
    main()
