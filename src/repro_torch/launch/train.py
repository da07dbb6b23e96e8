"""Training launcher: the real loop on an architecture's reduced config,
on the card (exec mode gpu: hymba's scan through the selective_scan
kernels and their backward) unless `--device cpu` is given (exec mode
torch, the plain versions); or `--dryrun` to run the FULL
config's train_4k cell shapes-only on the production mesh
(`launch.dryrun`, in-process: nothing is allocated).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --steps 100
  PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --steps 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-405b --dryrun [--multi-pod]
"""
from __future__ import annotations

import argparse

MULTI_POD_ALONE = ("--multi-pod applies only with --dryrun (the dry run's "
                   "2 x 16 x 16 mesh)")


def dryrun(arch: str, shapes, multi_pod: bool) -> None:
    """`launch.dryrun` over `shapes` of `arch`: its OK / FAIL lines, then
    SystemExit with 1 if any cell failed."""
    from repro_torch.launch import dryrun as dr
    rc = 0
    for shape in shapes:
        argv = ["--arch", arch, "--shape", shape]
        if multi_pod:
            argv.append("--multi-pod")
        try:
            dr.main(argv)
        except SystemExit as e:
            rc |= int(e.code or 0)
    raise SystemExit(rc)


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
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --dryrun: the 2 x 16 x 16 mesh")
    args = ap.parse_args(argv)

    if args.multi_pod and not args.dryrun:
        raise SystemExit(MULTI_POD_ALONE)
    if args.dryrun:
        dryrun(args.arch, ("train_4k",), args.multi_pod)

    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.layout import resolve_device
    from repro_torch.exec import exec_mode
    from repro_torch.train.loop import train

    cfg = get_reduced(args.arch)
    shape = ShapeConfig("cli", seq_len=args.seq, global_batch=args.batch,
                        kind="train")
    dev = resolve_device(args.device)
    with exec_mode("gpu" if dev.type == "cuda" else "torch"):
        _, _, out = train(cfg, shape, steps=args.steps, ckpt_dir=args.ckpt,
                          ckpt_every=50 if args.ckpt else 0,
                          microbatches=args.microbatches, device=dev)
    h = out["history"]
    print(f"final loss {h[-1]['loss']:.4f} over {len(h)} steps")


if __name__ == "__main__":
    main()
