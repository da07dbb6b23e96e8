"""Serving launcher: continuous batching on an architecture's reduced
config as it is, as the reference's launcher serves it, on the card
unless `--device cpu` is given. `--dryrun` runs
the FULL config's prefill_32k and decode_32k cells shapes-only on the
production mesh (`launch.dryrun`).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --requests 12
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-405b --dryrun
"""
from __future__ import annotations

import argparse

from repro_torch.launch.train import MULTI_POD_ALONE, dryrun


def serve_config(arch: str):
    """The config the launcher serves: `get_reduced(arch)` unchanged; the
    paged engine refuses recurrent archs, MLA and codebook models."""
    from repro_torch.configs import get_reduced
    from repro_torch.serving.paged_decode import CODEBOOK_REFUSAL
    cfg = get_reduced(arch)
    if cfg.attn_type != "gqa" or cfg.block_pattern != "transformer":
        raise SystemExit(f"{arch}: paged engine serves GQA transformer "
                         f"families; recurrent archs decode via model state "
                         f"(see launch/dryrun decode cells)")
    if cfg.n_codebooks:
        raise SystemExit(f"{arch}: {CODEBOOK_REFUSAL}")
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dryrun", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --dryrun: the 2 x 16 x 16 mesh")
    args = ap.parse_args(argv)

    if args.multi_pod and not args.dryrun:
        raise SystemExit(MULTI_POD_ALONE)
    if args.dryrun:
        dryrun(args.arch, ("prefill_32k", "decode_32k"), args.multi_pod)

    import numpy as np
    import torch

    from repro_torch.core.layout import resolve_device
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine, Request

    cfg = serve_config(args.arch)
    dev = resolve_device(args.device)
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0))
    # the engine's kernels run on the card; the CPU takes the plain path
    eng = Engine(cfg, params, max_reqs=4, num_pages=64, page_size=8,
                 max_pages_per_req=8, device=dev,
                 exec_mode="gpu" if dev.type == "cuda" else "torch")
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        eng.submit(Request(req_id=i,
                           prompt=rng.integers(1, cfg.vocab_size, 8),
                           max_new=args.max_new, priority=i % 3))
    outs = eng.run(max_steps=512)
    toks = sum(len(v) for v in outs.values())
    print(f"served {len(outs)} requests / {toks} tokens; "
          f"pool free={int(eng.kv.pool.num_free())}")


if __name__ == "__main__":
    main()
