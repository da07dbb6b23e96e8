"""The port's sharding rules, dry run, roofline, variant sweep and report
(`repro_torch.parallel.sharding`, `repro_torch.launch.*`) against the
JAX reference, on the CPU.

* Every parameter's spec equals the reference's `param_spec` on both
  production meshes, for every arch at full size (the reference's tree
  from `jax.eval_shape`, the port's on the `meta` device; a duck-typed
  mesh whose `.shape` is the axis dict stands in for the devices). The
  reference's layer leaves are stacked, so its spec has a leading None.
* `count_params` and `model_flops` equal the reference's for every arch
  x `cells_for` cell.
* `lower_cell` on reduced configs: `argument_bytes` equals the reckoning
  from the reference's own spec functions (`param_specs_fn`,
  `batch_specs_fn`, `cache_specs_fn`) over the reference's trees; the
  `meta` count equals a real CPU run's (FLOPs and bytes), the sLSTM's
  one-step reckoning and the microbatch extension included; the count is
  affine in depth (count(4) - count(2) = 2 (count(3) - count(2))), and
  remat's recompute is inside it (with remat minus without = the
  blocks' forward FLOPs less each block's last product, which
  `checkpoint`'s early stop does not run again), which is why the
  roofline takes no probes and no remat term.
* `perf.parse_variant` agrees with the reference's; the sweep prints the
  card's refusals as FAIL lines and goes on; `report` renders the port's
  JSONs.

Importing the reference's `launch.dryrun` (directly or through
`roofline` or `perf`) sets XLA_FLAGS to 512 devices, so JAX is started
first and the variable restored around the import.
"""
import dataclasses
import json
import os
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.utils.flop_counter import FlopCounterMode

import repro  # noqa: F401  (enables x64)
from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.configs.base import SHAPES as J_SHAPES
from repro.models import model as JM
from repro.parallel import sharding as j_sharding
from repro_torch.configs import ALL, ARCHS, get_config, get_reduced
from repro_torch.configs.base import SHAPES, cells_for
from repro_torch.exec import exec_mode
from repro_torch.launch import dryrun, perf, report, roofline
from repro_torch.launch.mesh import (dp_axes_of, make_production_mesh,
                                     n_devices)
from repro_torch.models import model as TM
from repro_torch.optim.adamw import adamw_init
from repro_torch.parallel import sharding as t_sharding
from repro_torch.train.step import make_train_step


@pytest.fixture(scope="module")
def ref_launch():
    """The reference's dryrun, roofline and perf modules, imported after
    JAX has started, XLA_FLAGS restored."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jd
        from repro.launch import perf as jperf
        from repro.launch import roofline as jroof
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return jd, jroof, jperf


def _norm(spec):
    """A spec as a plain tuple, one-name tuples as the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in tuple(spec))


def _pathstr(path):
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _reduced(arch):
    red = dataclasses.asdict(get_reduced(arch))
    red.pop("name")
    return red


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    dp = dp_axes_of(mesh)
    jcfg = j_get_config(arch)
    jp = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), jcfg))
    ref = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        ps = _pathstr(path)
        ref[ps] = (leaf.shape, j_sharding.param_spec(
            ps, leaf.shape[1:] if ps.startswith("blocks") else leaf.shape,
            mesh, dp, "model"))
    tcfg = get_config(arch)
    period = len(jp["blocks"]) if isinstance(jp["blocks"], (list, tuple)) \
        else 1
    params = TM.init_params(tcfg, dryrun.MetaGenerator())
    specs = t_sharding.params_shardings(params, mesh, dp, "model")
    named = dict(params.named_parameters())
    seen = set()
    for name, spec in specs.items():
        m = re.fullmatch(r"blocks\.(\d+)\.(.+)", name)
        if m:
            key = f"blocks/{int(m.group(1)) % period}/" \
                  f"{m.group(2).replace('.', '/')}"
            shape, want = ref[key]
            assert tuple(named[name].shape) == tuple(shape[1:]), name
        else:
            key = name.replace(".", "/")
            shape, want = ref[key]
            assert tuple(named[name].shape) == tuple(shape), name
        seen.add(key)
        assert _norm(spec) == _norm(want), (name, spec, want)
    assert seen == set(ref)


@pytest.mark.parametrize("arch", ALL)
def test_count_params_and_model_flops_match(arch, ref_launch):
    _, jroof, _ = ref_launch
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    for active in (False, True):
        assert roofline.count_params(tcfg, active) == \
            jroof.count_params(jcfg, active)
    names = ["train_4k"] if arch == "paper-kvstore" else cells_for(arch)
    for sh in names:
        assert roofline.model_flops(tcfg, SHAPES[sh]) == \
            jroof.model_flops(jcfg, J_SHAPES[sh]), sh


def _ref_argument_bytes(jd, arch, shape_name, multi_pod):
    """argument bytes a device from the reference's spec functions."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    dp = dp_axes_of(mesh)
    cfg = j_get_reduced(arch)
    shape = J_SHAPES[shape_name]

    def dev_bytes(tree, fn):
        total = 0
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            spec = fn(path, leaf)
            n = int(np.prod([mesh.shape[a] for a in
                             t_sharding.P(*spec).axes()]))
            total += leaf.size * leaf.dtype.itemsize // n
        return total

    params = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                   cfg))
    total = dev_bytes(params, jd.param_specs_fn(mesh, dp))
    bfn = jd.batch_specs_fn(mesh, dp)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        total += 2 * dev_bytes(params, jd.param_specs_fn(mesh, dp)) + 4
        batch = jax.eval_shape(lambda: {
            "tokens": jnp.zeros((b, s - cfg.frontend_tokens), jnp.int32),
            "labels": jnp.zeros((b, s), jnp.int32),
            "loss_mask": jnp.zeros((b, s), jnp.float32)})
        total += dev_bytes(batch, lambda p, l: bfn((), l))
    elif shape.kind == "decode":
        caches = jax.eval_shape(lambda: JM.init_caches(None, cfg, b, s))
        total += dev_bytes(caches, jd.cache_specs_fn(cfg, mesh, dp, b))
        tok = jax.eval_shape(lambda: {"t": jnp.zeros((b, 1), jnp.int32),
                                      "p": jnp.zeros((b,), jnp.int32)})
        total += dev_bytes(tok, lambda p, l: bfn((), l))
    return total


@pytest.mark.parametrize("arch,shape_name,multi_pod", [
    ("qwen3-1.7b", "train_4k", False), ("qwen3-1.7b", "train_4k", True),
    ("qwen3-1.7b", "decode_32k", False), ("minicpm3-4b", "decode_32k", True),
    ("xlstm-1.3b", "decode_32k", False), ("hymba-1.5b", "long_500k", False),
    ("llama4-scout-17b-a16e", "decode_32k", True)])
def test_argument_bytes_match_reference_specs(arch, shape_name, multi_pod,
                                              ref_launch):
    jd, _, _ = ref_launch
    rep = dryrun.lower_cell(arch, shape_name, multi_pod,
                            overrides=_reduced(arch))
    assert rep["memory"]["argument_bytes"] == _ref_argument_bytes(
        jd, arch, shape_name, multi_pod)
    assert rep["devices"] == (512 if multi_pod else 256)
    assert rep["collective_bytes_total"] == sum(
        v["bytes"] for v in rep["collectives"].values())


def _batch(cfg, b, s, device):
    rng = np.random.default_rng(0)
    return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                   (b, s)), dtype=torch.int32,
                                      device=device),
            "labels": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                   (b, s)), dtype=torch.int32,
                                      device=device),
            "loss_mask": torch.ones((b, s), device=device)}


def _cpu_count(fn, *args):
    with exec_mode("torch"), FlopCounterMode(display=False) as fc, \
            dryrun.StepCounter() as c:
        fn(*args)
    return fc.get_total_flops(), c.bytes


@pytest.mark.parametrize("arch,kind,mb", [("qwen3-1.7b", "train", 2),
                                          ("xlstm-1.3b", "train", 1),
                                          ("xlstm-1.3b", "prefill", 1),
                                          ("hymba-1.5b", "prefill", 1)])
def test_meta_count_equals_cpu_run(arch, kind, mb):
    cfg = get_reduced(arch)
    b, s = 2 * mb, 24
    out = {}
    for dev in ("meta", "cpu"):
        params = (TM.init_params(cfg, dryrun.MetaGenerator()) if dev == "meta"
                  else TM.init_params(cfg, torch.Generator().manual_seed(0)))
        batch = _batch(cfg, b, s, dev)
        if kind == "train":
            params.make_trainable()
            fn = make_train_step(cfg, microbatches=mb)
            args = (params, {"adam": adamw_init(params)}, batch)
        else:
            fn = dryrun.make_serve_prefill(cfg, cache_len=s)
            args = (params, {"tokens": batch["tokens"]})
        if dev == "meta":
            c = dryrun._count(fn, *args)
            mult = dryrun._slstm_mult(cfg, SHAPES[f"{kind}_4k"
                                                  if kind == "train"
                                                  else "prefill_32k"])
            out[dev] = (c["flops"] + mult * c["slstm_flops"],
                        c["bytes"] + mult * c["slstm_bytes"])
        else:
            out[dev] = _cpu_count(fn, *args)
    assert out["meta"][0] == out["cpu"][0] > 0
    if "xlstm" not in arch:        # the sLSTM's elementwise bytes reckoned
        assert out["meta"][1] == out["cpu"][1] > 0


def test_count_is_affine_in_depth_and_holds_remat():
    red = _reduced("qwen3-1.7b")
    raw = {}
    for n in (2, 3, 4):
        rep = dryrun.lower_cell("qwen3-1.7b", "train_4k", False,
                                overrides={**red, "n_layers": n})
        raw[n] = (rep["flops"] * rep["devices"],
                  rep["bytes_accessed"] * rep["devices"])
    for i in range(2):
        assert raw[4][i] - raw[2][i] == 2 * (raw[3][i] - raw[2][i])
    # remat's recompute is one more forward of the blocks, traced
    off = dryrun.lower_cell("qwen3-1.7b", "train_4k", False,
                            overrides={**red, "remat": False})
    on = dryrun.lower_cell("qwen3-1.7b", "train_4k", False, overrides=red)
    cfg = get_reduced("qwen3-1.7b")
    shape = SHAPES["train_4k"]
    params = TM.init_params(cfg, dryrun.MetaGenerator())
    tokens = torch.empty((shape.global_batch, shape.seq_len),
                         dtype=torch.int32, device="meta")
    with torch.no_grad():
        fwd = dryrun._count(lambda: TM.forward(params, cfg, tokens))["flops"]
    tokens = shape.global_batch * shape.seq_len
    head = 2 * tokens * cfg.d_model * cfg.padded_vocab
    # checkpoint's recompute stops once the saved tensors are back, so a
    # block's last product (the FFN's down projection) is not run again
    down = 2 * tokens * cfg.d_ff * cfg.d_model * cfg.n_layers
    assert (on["flops"] - off["flops"]) * on["devices"] == fwd - head - down


def test_microbatches_extend_exactly():
    cfg = get_reduced("qwen3-1.7b")
    rep = dryrun.lower_cell("qwen3-1.7b", "train_4k", False, microbatches=5,
                            overrides=_reduced("qwen3-1.7b"))
    assert rep["microbatches"] == 5
    shape = SHAPES["train_4k"]
    params = TM.init_params(cfg, dryrun.MetaGenerator()).make_trainable()
    c = dryrun._count(make_train_step(cfg, microbatches=5), params,
                      {"adam": adamw_init(params)},
                      dryrun._batch(cfg, shape.global_batch, shape.seq_len,
                                    True))
    assert rep["flops"] * rep["devices"] == c["flops"]
    assert rep["bytes_accessed"] * rep["devices"] == c["bytes"]


def test_pod_compress_cell_reckons_int8_payloads():
    red = _reduced("qwen3-1.7b")
    plain = dryrun.lower_cell("qwen3-1.7b", "train_4k", True, overrides=red)
    comp = dryrun.lower_cell("qwen3-1.7b", "train_4k", True,
                             overrides={**red, "pod_compress": True})
    cfg = get_reduced("qwen3-1.7b")
    n = roofline.count_params(cfg)
    gathered = comp["collectives"]["all-gather"]["bytes"] \
        - plain["collectives"]["all-gather"]["bytes"]
    assert gathered > 2 * n / 16 / 16          # P x a shard of the payloads
    assert comp["memory"]["argument_bytes"] > plain["memory"][
        "argument_bytes"]                      # + the residuals
    # the pod hop leaves the gradient reduce-scatter: it covers data only
    assert comp["collectives"]["reduce-scatter"]["bytes"] > plain[
        "collectives"]["reduce-scatter"]["bytes"]


def test_kvstore_cell():
    for mp, n_axes in ((False, 2), (True, 3)):
        rep = dryrun.lower_cell("paper-kvstore", "train_4k", mp,
                                overrides={"store_capacity": 512,
                                           "store_lanes": 32})
        assert rep["flops"] == 0.0 and rep["bytes_accessed"] > 0
        assert rep["collectives"]["all-to-all"]["count"] == 10 * n_axes
        assert rep["store_backend"] == "det_skiplist"


def test_roofline_terms():
    rep = roofline.analyze_cell("qwen3-1.7b", "decode_32k", False,
                                overrides=_reduced("qwen3-1.7b"))
    hw = roofline.HW
    assert hw["peak_flops"] == 989e12 and hw["hbm_bw"] == 3.35e12
    t = rep["terms"]
    assert t["compute_s"] == rep["flops"] / hw["peak_flops"]
    assert t["memory_s"] == rep["bytes_accessed"] / hw["hbm_bw"]
    assert t["collective_s"] == rep["collective_bytes_total"] / hw["link_bw"]
    assert rep["dominant"] == max(t, key=t.get)
    assert rep["step_time_lb_s"] == max(t.values())
    for key in ("model_flops", "useful_ratio", "roofline_fraction",
                "flops_per_dev_corrected", "bytes_per_dev_corrected",
                "collective_bytes_per_dev_corrected", "hlo_flops_total"):
        assert key in rep


VARIANTS = ["flash", "kvfp8", "moe_psum", "moe_a2a", "remat_off", "mb32",
            "bq128", "chunk64", "ssmbf16", "cf125", "seq2d", "podcomp"]


def test_parse_variant_matches_reference(ref_launch):
    _, _, jperf = ref_launch
    for v in VARIANTS:
        assert perf.parse_variant(v) == jperf.parse_variant(v), v
    with pytest.raises(SystemExit, match="unknown variant"):
        perf.parse_variant("nope")


def test_sweep_prints_refusals_and_goes_on(tmp_path, capsys, monkeypatch):
    """kvfp8 and ssmbf16 run on a serving cell (the card takes both) and
    the fp8 cache counts one byte an element; on a train cell the card
    refuses the bf16 scan (no backward), printed as FAIL while the sweep
    goes on (the cell itself is not lowered: a stub stands in)."""
    perf.main(["--arch", "hymba-1.5b", "--shape", "decode_32k",
               "--variants", "kvfp8", "ssmbf16", "seq2d",
               "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "BASE      hymba-1.5b__decode_32k__16x16" in out
    assert "FAIL" not in out
    for v in ("kvfp8", "ssmbf16", "seq2d"):
        assert f"VAR {v}" in out
    with open(tmp_path / "hymba-1.5b__decode_32k__16x16.json") as f:
        rep = json.load(f)
    cfg = get_config("hymba-1.5b")
    cache = (2 * cfg.n_layers * SHAPES["decode_32k"].global_batch
             * SHAPES["decode_32k"].seq_len * cfg.n_kv_heads
             * cfg.resolved_head_dim)           # k and v elements
    saved = (rep["baseline"]["memory"]["argument_bytes"]
             - rep["kvfp8"]["memory"]["argument_bytes"])
    # 2 bytes an element, then 1: a device of the 16 x 16 mesh holds
    # 1/256 of the cache
    assert saved * 256 == cache
    base = {"terms": {"compute_s": 1.0, "memory_s": 1.0,
                      "collective_s": 1.0}, "dominant": "compute_s",
            "useful_ratio": 1.0, "roofline_fraction": 1.0}
    monkeypatch.setattr(perf, "lower_cell", lambda *a, **k: {})
    monkeypatch.setattr(perf, "analyze_cell", lambda *a, **k: base)
    perf.main(["--arch", "hymba-1.5b", "--shape", "train_4k", "--variants",
               "ssmbf16", "flash", "mb4", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "FAIL ssmbf16: NotImplementedError: the selective_scan kernel's " \
           "bfloat16 scan has no backward" in out
    assert "FAIL flash: NotImplementedError: the flash_attention CUDA " \
           "kernel is forward-only" in out
    assert "VAR mb4" in out


def test_report_renders_port_jsons(tmp_path, capsys):
    d, r = tmp_path / "dryrun", tmp_path / "roofline"
    for arch in ("qwen3-1.7b", "paper-kvstore"):
        sh = "train_4k" if arch == "paper-kvstore" else "decode_32k"
        ov = ({"store_capacity": 512, "store_lanes": 32}
              if arch == "paper-kvstore" else _reduced(arch))
        rep = roofline.analyze_cell(arch, sh, False, overrides=ov)
        for path, obj in ((d, {k: v for k, v in rep.items()
                               if k not in ("terms",)}), (r, rep)):
            path.mkdir(exist_ok=True)
            (path / f"{arch}.json").write_text(json.dumps(obj))
    report.main(["--kind", "dryrun", "--dir", str(d)])
    report.main(["--kind", "roofline", "--dir", str(r)])
    out = capsys.readouterr().out
    assert "| arch | shape | mesh | flops/dev (traced) |" in out
    assert "| qwen3-1.7b | decode_32k | 16x16 |" in out
    assert "| paper-kvstore | train_4k | 16x16 |" in out
    assert "| arch | shape | mesh | compute ms |" in out


def test_mesh_and_sharding_helpers():
    m = make_production_mesh(multi_pod=True)
    assert m.axis_names == ("pod", "data", "model")
    assert dp_axes_of(m) == ("pod", "data") and n_devices(m) == 512
    assert n_devices(make_production_mesh()) == 256
    x = torch.zeros(32, 16)
    assert t_sharding.constrain(x, t_sharding.P("data", None)) is x
    with t_sharding.use_mesh(make_production_mesh()):
        assert t_sharding.constrain(x, t_sharding.P("data", "model")) is x
        with pytest.raises(ValueError, match="3 entries"):
            t_sharding.constrain(x, t_sharding.P("data", None, None))
        with pytest.raises(ValueError, match="'pod'"):
            t_sharding.constrain(x, t_sharding.P(("pod", "data"), None))
