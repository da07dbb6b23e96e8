"""The skiplist walk's launch geometry and the scan wrapper's refusals,
on the CPU.

`skiplist_search.kernel.walk_geometry` sizes the walk's blocks so that a
plan of a few thousand queries still covers every SM; the scan wrapper
checks its contract for every tensor before it dispatches. The kernels
themselves run only on the card (chip_smoke.py).
"""
import pytest
import torch

from repro_torch.kernels.selective_scan import kernel as ss
from repro_torch.kernels.selective_scan.ref import selective_scan_ref
from repro_torch.kernels.skiplist_search import kernel as sk

H100_SMS = 132


@pytest.mark.parametrize("t,threads", [
    (4096, 32),          # the workload plans: 128 blocks of one warp
    (16384, 64),         # 256 blocks
    (65536, 256),        # the preload plans: full blocks already cover
    (1, 32),
    (0, 32),
])
def test_walk_geometry_covers_the_sms(t, threads):
    got = sk.walk_geometry(t, H100_SMS)
    assert got == threads
    assert got == sk.BLOCK_SIZES[-1] or -(-t // got) >= H100_SMS


def _scan_inputs(b=2, s=5, d=6, n=8, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((b, s, d), generator=g, dtype=dtype)
    dt = torch.rand((b, s), generator=g, dtype=dtype)
    bm = torch.randn((b, s, n), generator=g, dtype=dtype)
    cm = torch.randn((b, s, n), generator=g, dtype=dtype)
    a = -torch.rand((d, n), generator=g, dtype=dtype)
    h0 = torch.randn((b, d, n), generator=g, dtype=dtype)
    return [x, dt, bm, cm, a, h0]


@pytest.mark.parametrize("case,match", [
    ("n12", "must be one of"),
    ("n2", "must be one of"),
    ("bf16", "float32"),
    ("f64_h0", "float32"),
    ("dt_shape", r"x \[B,S,D\]"),
    ("a_shape", r"x \[B,S,D\]"),
    ("h0_shape", r"x \[B,S,D\]"),
])
def test_selective_scan_refusals(case, match):
    if case in ("n12", "n2"):
        ins = _scan_inputs(n=int(case[1:]))
    elif case == "bf16":
        ins = _scan_inputs(dtype=torch.bfloat16)
    else:
        ins = _scan_inputs()
    if case == "f64_h0":
        ins[5] = ins[5].double()
    elif case == "dt_shape":
        ins[1] = ins[1][:, :-1]
    elif case == "a_shape":
        ins[4] = ins[4][:-1]
    elif case == "h0_shape":
        ins[5] = ins[5][:1]
    with pytest.raises(ValueError, match=match):
        ss.selective_scan_fused(*ins)


def test_selective_scan_wrapper_runs_the_plain_scan_on_cpu():
    ins = _scan_inputs()
    y, h = ss.selective_scan_fused(*ins)
    yp, hp = ss.selective_scan_chunked(*ins)
    assert torch.equal(y, yp) and torch.equal(h, hp)


@pytest.mark.parametrize("n", ss.STATE_SIZES)
def test_selective_scan_cpu_path_matches_the_step_scan(n):
    ins = _scan_inputs(n=n)
    for h0 in (ins[5], None):
        got = ss.selective_scan_fused(*ins[:5], h0)
        want = selective_scan_ref(*ins[:5], h0)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=2e-5, rtol=2e-5)
