"""Time the selective scan kernels on the card at hymba-1.5b's shapes.

    PYTHONPATH=src:. python3 tools/torch_scan_bench.py [tag] [--splits]

Times, by `chip_smoke.median_ms` on `chip_smoke.scan_inputs`, the f32
forward, the saving forward (`save_chunks`, as autograd launches it) and
the backward at one training microbatch (B 2, S 4,096, D 3,200, N 16),
and the forward at the served prefill (B 8, S 4,096) and decode (B 8, S
1) shapes. With `--splits` it also times, through
`chip_smoke.forced_scan_geometry`, the saving forward under every lane
split the forward is built for, the prefill under 8 and 4 states a lane,
and the backward under clusters of 1, 2, 4 and 8 blocks. Prints the
card's name and power limit, then one JSON line `TIMES {...}` (ms)
tagged with `tag`.

To compare two trees on one card, run it in one call on each in turn
(parent, tree, tree, parent), with PYTHONPATH's first entry pointing at
each tree's `src` (unpack the parent with `git archive` into a directory
that .gitignore lists, e.g. build/checkout/parent); `--splits` needs the
tree's `scan_geometry`. Each tree builds its own kernels on first use.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

import chip_smoke
from repro_torch.kernels import cuda
from repro_torch.kernels.selective_scan import kernel as ssk

TRAIN = (2, 4096, 3200, 16)
PREFILL = (8, 4096, 3200, 16)
DECODE = (8, 1, 3200, 16)


def median_ms(fn) -> float:
    return chip_smoke.median_ms(torch, fn, 20)


def main(tag: str, splits: bool) -> None:
    print(chip_smoke.card_line(), flush=True)
    cuda.build_all(("selective_scan", "selective_scan_bwd"))
    rng = np.random.default_rng(1)
    res = {"tag": tag}
    ins = list(chip_smoke.scan_inputs(torch, rng, *TRAIN))
    ins[5] = torch.zeros_like(ins[5])         # as in training
    dy = torch.randn(ins[0].shape, device="cuda")
    _, _, saved = ssk.selective_scan_fused(*ins, save_chunks=True)
    pre = chip_smoke.scan_inputs(torch, rng, *PREFILL)
    dec = chip_smoke.scan_inputs(torch, rng, *DECODE)

    def save():
        return ssk.selective_scan_fused(*ins, save_chunks=True)

    def backward():
        return ssk.selective_scan_bwd(*ins, saved, dy, None)

    def prefill():
        return ssk.selective_scan_fused(*pre)
    res["forward_train"] = median_ms(lambda: ssk.selective_scan_fused(*ins))
    res["save_train"] = median_ms(save)
    res["backward_train"] = median_ms(backward)
    res["forward_prefill"] = median_ms(prefill)
    res["forward_decode"] = median_ms(lambda: ssk.selective_scan_fused(*dec))
    if splits:
        for per in ssk.forward_pers(TRAIN[3]):
            with chip_smoke.forced_scan_geometry(per=per):
                res[f"save_train_per{per}"] = median_ms(save)
        for per in (8, 4):
            with chip_smoke.forced_scan_geometry(per=per):
                res[f"forward_prefill_per{per}"] = median_ms(prefill)
        for cl in (1, 2, 4, 8):
            with chip_smoke.forced_scan_geometry(cluster=cl):
                res[f"backward_train_cluster{cl}"] = median_ms(backward)
    print("TIMES " + json.dumps(res), flush=True)


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--splits"]
    main(args[0] if args else "tree", "--splits" in sys.argv[1:])
