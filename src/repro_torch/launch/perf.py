"""Variant sweep: a cell's roofline terms under config variants against
its baseline (counterpart of `repro.launch.perf`).

  PYTHONPATH=src python -m repro_torch.launch.perf --arch llama3-405b \
      --shape train_4k --variants flash remat_off mb32

Variants (composable, the reference's names):
  flash      attn_impl=xla_flash (the flash_attention kernel's form)
  kvfp8      kv_cache_dtype=float8_e4m3fn
  moe_psum   moe_impl=replicated_psum
  moe_a2a    moe_impl=routed_a2a (the paper's routing)
  remat_off  remat=False
  mb<k>      microbatches=k
  bq<k>      attn_block_q=k
  chunk<k>   scan_chunk=k
  ssmbf16    ssm_scan_dtype=bfloat16
  cf<k>      moe_capacity_factor=k/100
  seq2d      decode_shard=seq2d
  podcomp    pod_compress=True

A variant the card's path refuses prints `FAIL <variant>: <refusal>` and
the sweep goes on: on a train cell, flash (the flash_attention kernel
has no backward) and, on a model with a mamba block, ssmbf16 (the
selective_scan kernel's bf16 scan has none either; the dry run itself
runs the plain versions, which would take both). kvfp8 caches in
float8_e4m3fn, which the dry run counts at one byte an element.
"""
from __future__ import annotations

import argparse
import json
import os
import re

from repro_torch import exec as exec_
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.launch.dryrun import lower_cell
from repro_torch.launch.roofline import analyze_cell
from repro_torch.models import ssm
from repro_torch.models.blocks import block_kinds
from repro_torch.models.common import dtype_of


def parse_variant(v: str):
    """(config overrides, microbatches or None) of a variant name."""
    if v == "flash":
        return {"attn_impl": "xla_flash"}, None
    if v == "kvfp8":
        return {"kv_cache_dtype": "float8_e4m3fn"}, None
    if v == "moe_psum":
        return {"moe_impl": "replicated_psum"}, None
    if v == "moe_a2a":
        return {"moe_impl": "routed_a2a"}, None
    if v == "remat_off":
        return {"remat": False}, None
    m = re.fullmatch(r"mb(\d+)", v)
    if m:
        return {}, int(m.group(1))
    m = re.fullmatch(r"bq(\d+)", v)
    if m:
        return {"attn_block_q": int(m.group(1))}, None
    m = re.fullmatch(r"chunk(\d+)", v)
    if m:
        return {"scan_chunk": int(m.group(1))}, None
    if v == "ssmbf16":
        return {"ssm_scan_dtype": "bfloat16"}, None
    m = re.fullmatch(r"cf(\d+)", v)          # cf125 -> capacity factor 1.25
    if m:
        return {"moe_capacity_factor": int(m.group(1)) / 100.0}, None
    if v == "seq2d":
        return {"decode_shard": "seq2d"}, None
    if v == "podcomp":
        return {"pod_compress": True}, None
    raise SystemExit(f"unknown variant {v}")


def card_refusal(arch: str, overrides: dict, shape: str) -> None:
    """Raise the refusal the card's path (exec mode gpu) gives the
    variant's config on the cell `shape`, if any."""
    cfg = get_config(arch).replace(**overrides)
    if cfg.family == "kvstore":
        return
    dtype_of(cfg.kv_cache_dtype)
    training = SHAPES[shape].kind == "train"
    if training and cfg.attn_impl == "xla_flash":
        raise exec_.forward_only("flash_attention")
    if "hymba" in block_kinds(cfg):
        ssm.check_scan_kernel(cfg, training)


def run_variant(arch, shape, multi_pod, overrides, microbatches):
    card_refusal(arch, overrides or {}, shape)
    full = lower_cell(arch, shape, multi_pod, microbatches=microbatches,
                      overrides=overrides or None)
    return analyze_cell(arch, shape, multi_pod, full_report=full,
                        overrides=overrides or None)


def fmt(rep) -> str:
    t = rep["terms"]
    mem = rep.get("memory", {})
    return (f"comp={t['compute_s'] * 1e3:9.2f}ms "
            f"mem={t['memory_s'] * 1e3:9.2f}ms "
            f"coll={t['collective_s'] * 1e3:9.2f}ms "
            f"dom={rep['dominant'][:-2]:10s} "
            f"useful={rep['useful_ratio']:.2f} "
            f"roofline={rep['roofline_fraction']:.3f} "
            f"tempGiB={mem.get('temp_bytes', 0) / 2**30:.1f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--variants", nargs="+", default=[])
    ap.add_argument("--combine", nargs="*", default=None,
                    help="also evaluate all listed variants together")
    ap.add_argument("--out", default="reports/torch/perf")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    tag = (f"{args.arch}__{args.shape}__"
           f"{'2x16x16' if args.multi_pod else '16x16'}")

    base = run_variant(args.arch, args.shape, args.multi_pod, {}, None)
    print(f"BASE      {tag}\n          {fmt(base)}", flush=True)
    results = {"baseline": base}
    for v in args.variants:
        ov, mb = parse_variant(v)
        try:
            rep = run_variant(args.arch, args.shape, args.multi_pod, ov, mb)
        except Exception as e:
            print(f"FAIL {v}: {type(e).__name__}: {e}", flush=True)
            continue
        results[v] = rep
        dom = base["dominant"]
        delta = ((1 - rep["terms"][dom] / base["terms"][dom]) * 100
                 if base["terms"][dom] else 0.0)
        print(f"VAR {v:10s} {fmt(rep)}\n          "
              f"baseline-dominant({dom[:-2]}) delta: {delta:+.1f}%",
              flush=True)
    if args.combine:
        ov_all, mb_all = {}, None
        for v in args.combine:
            ov, mb = parse_variant(v)
            ov_all.update(ov)
            mb_all = mb or mb_all
        try:
            rep = run_variant(args.arch, args.shape, args.multi_pod, ov_all,
                              mb_all)
            results["+".join(args.combine)] = rep
            print(f"COMBINED  {fmt(rep)}", flush=True)
        except Exception as e:
            print(f"FAIL {'+'.join(args.combine)}: {type(e).__name__}: {e}",
                  flush=True)
    with open(os.path.join(args.out, tag + ".json"), "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
