"""The skiplist walk's and the selective scan's launch geometry and the
scan wrapper's refusals, on the CPU.

`skiplist_search.kernel.walk_geometry` sizes the walk's blocks so that a
plan of a few thousand queries still covers every SM;
`selective_scan.kernel.scan_geometry` picks the scan's lane split so that
a training microbatch of two sequences fills the card; the scan wrapper
checks its contract for every tensor before it dispatches. The kernels
themselves run only on the card (chip_smoke.py).
"""
import re
from pathlib import Path

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


CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc")
# hymba-1.5b's scan (D 3,200) at a training microbatch, its served prefill
# and decode, and the edge shapes of chip_smoke.py's sweeps
SCAN_SHAPES = {"train": (2, 4096, 3200), "prefill": (8, 4096, 3200),
               "decode": (8, 1, 3200), "D 77": (2, 45, 77),
               "D 36": (2, 100, 36)}


@pytest.mark.parametrize("n", ss.STATE_SIZES)
@pytest.mark.parametrize("shape", list(SCAN_SHAPES))
def test_scan_geometry(shape, n):
    b, s, d = SCAN_SHAPES[shape]
    fwd = ss.scan_geometry(b, s, d, n, H100_SMS)
    bwd = ss.scan_geometry(b, s, d, n, H100_SMS, "backward")
    for geo in (fwd, bwd):                  # a split the kernels are built for
        assert geo.per * geo.lanes == n and geo.lanes <= 32
        assert geo.channels * geo.lanes == ss.SS_THREADS
        assert geo.blocks == -(-d // geo.channels)
        assert geo.channels % 4 == 0        # x staged in float4s
    assert fwd.per in ss.forward_pers(n) and fwd.cluster == 1
    assert bwd.per == ss.BACKWARD_PER
    assert bwd.cluster == min(bwd.blocks, ss.MAX_CLUSTER)
    # the forward (saving or not: one split) takes the most states a lane
    # whose lanes still give every SM MIN_WARPS_PER_SM warps
    want = H100_SMS * ss.MIN_WARPS_PER_SM * 32
    pers = ss.forward_pers(n)
    assert b * d * n // fwd.per >= want or fwd.per == pers[-1]
    assert all(b * d * n // p < want for p in pers if p > fwd.per)
    if n == 16 and shape == "train":        # the card full at B 2
        assert (fwd.per, fwd.channels, bwd.per) == (4, 32, 2)
        assert b * d * n // fwd.per >= want and b * fwd.blocks >= H100_SMS
        assert b * bwd.blocks // H100_SMS >= 3     # several blocks an SM
    if n == 16 and shape in ("prefill", "decode"):   # 8 states a lane
        assert (fwd.per, fwd.channels, fwd.blocks) == (8, 64, 50)


def test_scan_geometry_matches_the_sources():
    cuh = (CSRC / "selective_scan.cuh").read_text()
    fwd = (CSRC / "selective_scan.cu").read_text()
    bwd = (CSRC / "selective_scan_bwd.cu").read_text()

    def define(text, name):
        return int(re.search(rf"#define {name} (\d+)", text).group(1))
    assert define(cuh, "SS_THREADS") == ss.SS_THREADS
    assert define(cuh, "SS_CHUNK") == ss.SS_CHUNK
    assert define(cuh, "SS_SAVE") == ss.SS_SAVE
    assert define(bwd, "SS_BWD_PER") == ss.BACKWARD_PER
    assert define(bwd, "SS_BWD_MAX_CLUSTER") == ss.MAX_CLUSTER
    cases = {int(p) for p in re.findall(r"SS_PER_CASE\((\d+)\)", fwd)}
    assert cases == set(ss.FORWARD_PERS)
    with pytest.raises(ValueError, match="kind"):
        ss.scan_geometry(2, 8, 8, 16, H100_SMS, "bwd")


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
