"""Roofline analysis of the dry run's reports on the H100's terms
(counterpart of `repro.launch.roofline`).

Terms per (arch x shape x mesh), seconds a step a device:
  compute    = flops / peak FLOP/s
  memory     = bytes_accessed / HBM bytes/s
  collective = collective bytes / link bytes/s

`HW` holds NVIDIA's H100 SXM data-sheet numbers (not measured here): 989
TFLOP/s dense bf16, 3.35 TB/s HBM3, and NVLink at 450 GB/s a direction
(900 GB/s both ways), for the card at its 700 W power limit. A card set
below 700 W runs slower under load.

The reference reads XLA's cost analysis, which counts a scan body once,
so it lowers each cell twice more at one and two periods of layers and
extrapolates, and adds a third of a group's FLOPs for remat's recompute.
The port's dry run traces every layer (its layers are a Python loop)
and runs remat's recompute inside `checkpoint` (which stops once the
saved tensors are back, so a block's last product is not run twice), so
its counts are the step's as they stand: no probes, no remat term. The sLSTM's per-token
loop is counted one step and multiplied in the dry run itself.

MODEL_FLOPS = 6 N D (train, D the tokens incl. a frontend's), 2 N D
(prefill) or 2 N_active B (decode): `model_flops / (ms x peak)` is a
step's share of model FLOPs (MFU).
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.launch.dryrun import all_cells, lower_cell
from repro_torch.models.blocks import block_kinds

# NVIDIA H100 SXM data sheet, at the card's 700 W power limit
HW = {"peak_flops": 989e12, "hbm_bw": 3.35e12, "link_bw": 450e9,
      "power_limit_w": 700.0}


def count_params(cfg, active_only: bool = False) -> float:
    """Analytic parameter count (embedding + blocks + head), the
    reference's arithmetic."""
    if cfg.family == "kvstore":
        return 0.0
    d = cfg.d_model
    vp = cfg.padded_vocab
    emb = vp * d * (cfg.n_codebooks or 1)
    head = 0 if cfg.tie_embeddings else vp * d * (cfg.n_codebooks or 1)
    kinds = block_kinds(cfg)
    per_period = 0.0
    dh = cfg.resolved_head_dim
    for kind in kinds:
        p = 0.0
        if kind in ("dense", "moe", "hymba"):
            if cfg.attn_type == "mla":
                qd = cfg.qk_nope_dim + cfg.qk_rope_dim
                p += (d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.n_heads * qd
                      + d * cfg.kv_lora_rank
                      + cfg.kv_lora_rank * cfg.n_heads
                      * (cfg.qk_nope_dim + cfg.v_head_dim)
                      + d * cfg.qk_rope_dim + cfg.n_heads * cfg.v_head_dim * d)
            else:
                p += d * (cfg.n_heads + 2 * cfg.n_kv_heads) * dh
                p += cfg.n_heads * dh * d
            if kind == "moe":
                e = cfg.n_experts_active if active_only else cfg.n_experts
                p += e * 3 * d * cfg.d_expert + d * cfg.n_experts
                p += cfg.n_shared_experts * 3 * d * cfg.d_expert
            else:
                p += 3 * d * cfg.d_ff
            if kind == "hymba":
                di = cfg.ssm_expand * d
                p += d * 2 * di + di * (1 + 2 * cfg.ssm_state) + di * d
        elif kind == "mlstm":
            di = cfg.ssm_expand * d
            p += d * 2 * di + 3 * di * di + di * 2 * cfg.n_heads + di * d
        elif kind == "slstm":
            p += d * 4 * d + d * 4 * d + d * d
            p += 3 * d * max(cfg.d_ff, 4 * d // 3)
        per_period += p
    n_groups = cfg.n_layers // len(kinds)
    return emb + head + per_period * n_groups


def model_flops(cfg, shape) -> float:
    n_act = count_params(cfg, active_only=True)
    if shape.kind == "train":
        return 6.0 * n_act * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_act * shape.global_batch * shape.seq_len
    return 2.0 * n_act * shape.global_batch        # decode: one token a request


def analyze_cell(arch: str, shape_name: str, multi_pod: bool,
                 full_report: dict | None = None,
                 overrides: dict | None = None) -> dict:
    """The dry run's report (run now unless given) with the roofline
    terms, the dominant one, model FLOPs, the useful share and the step
    time's lower bound. The `*_corrected` keys keep the reference's
    names; here they equal the dry run's counts (module docstring)."""
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = SHAPES[shape_name]
    if full_report is None:
        full_report = lower_cell(arch, shape_name, multi_pod,
                                 overrides=overrides)
    out = dict(full_report)
    flops_t = full_report["flops"]
    bytes_t = full_report["bytes_accessed"]
    coll_t = full_report["collective_bytes_total"]
    terms = {"compute_s": flops_t / HW["peak_flops"],
             "memory_s": bytes_t / HW["hbm_bw"],
             "collective_s": coll_t / HW["link_bw"]}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    total = flops_t * full_report["devices"]
    lb = max(terms.values())
    out.update({
        "hw": dict(HW),
        "flops_per_dev_corrected": flops_t,
        "bytes_per_dev_corrected": bytes_t,
        "collective_bytes_per_dev_corrected": coll_t,
        "terms": terms,
        "dominant": dominant,
        "model_flops": mf,
        "hlo_flops_total": total,
        "useful_ratio": (mf / total) if total else 0.0,
        "step_time_lb_s": lb,
        "roofline_fraction": ((mf / HW["peak_flops"] / full_report["devices"]
                               / lb) if lb else 0.0),
    })
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="reports/torch/roofline")
    ap.add_argument("--dryrun-dir", default="reports/torch/dryrun")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    cells = all_cells() if args.all else [(args.arch, args.shape)]
    for arch, sh in cells:
        tag = f"{arch}__{sh}__{'2x16x16' if args.multi_pod else '16x16'}"
        full = None
        fp = os.path.join(args.dryrun_dir, tag + ".json")
        if os.path.exists(fp):
            with open(fp) as f:
                full = json.load(f)
        try:
            rep = analyze_cell(arch, sh, args.multi_pod, full_report=full)
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(rep, f, indent=1)
            t = rep["terms"]
            print(f"{tag:58s} comp={t['compute_s'] * 1e3:8.2f}ms "
                  f"mem={t['memory_s'] * 1e3:8.2f}ms "
                  f"coll={t['collective_s'] * 1e3:8.2f}ms "
                  f"dom={rep['dominant'][:-2]:10s} "
                  f"useful={rep['useful_ratio']:.2f} "
                  f"roofline={rep['roofline_fraction']:.3f}", flush=True)
        except Exception as e:
            print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)


if __name__ == "__main__":
    main()
