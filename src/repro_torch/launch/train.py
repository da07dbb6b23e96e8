"""Training launcher: the real loop on an architecture's reduced config,
on the card unless `--device cpu` is given.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --steps 100
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --steps 4 --device cpu
"""
from __future__ import annotations

import argparse

DRYRUN_REFUSAL = ("--dryrun/--multi-pod: the reference's launch/dryrun.py "
                  "lowers a config onto a TPU mesh through XLA; the port has "
                  "no torch counterpart of that lowering")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dryrun", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)

    if args.dryrun or args.multi_pod:
        raise SystemExit(DRYRUN_REFUSAL)

    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train.loop import train

    cfg = get_reduced(args.arch)
    shape = ShapeConfig("cli", seq_len=args.seq, global_batch=args.batch,
                        kind="train")
    _, _, out = train(cfg, shape, steps=args.steps, ckpt_dir=args.ckpt,
                      ckpt_every=50 if args.ckpt else 0,
                      microbatches=args.microbatches, device=args.device)
    h = out["history"]
    print(f"final loss {h[-1]['loss']:.4f} over {len(h)} steps")


if __name__ == "__main__":
    main()
