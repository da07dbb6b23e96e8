"""Multi-pod dry run: every (architecture x input shape) cell on the
production meshes from shapes alone (counterpart of
`repro.launch.dryrun`).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

The reference lowers and compiles each cell through XLA onto 256 or 512
fake devices and reads the compiled program's cost and memory analyses.
Here the cell's parameters, optimizer state, batch and caches are built
on the `meta` device (nothing is allocated) and its step from
`train/step.py` runs once, in exec mode "torch" (kernels cannot run on
`meta`), under two dispatch modes:

  flops           `torch.utils.flop_counter.FlopCounterMode`'s total
  bytes_accessed  the sum of every aten op's input and output bytes,
                  computed from shapes (view ops move nothing and are
                  left out)
  temp_bytes      the peak bytes of the storages the step itself made
                  and still held (arguments excluded)

The step is the whole folded mesh's work, so these three are divided by
`devices`: an even split, which the sharding rules only approximate.

  argument_bytes  each argument's bytes over the product of its spec's
                  axis sizes (`parallel.sharding.params_shardings` for
                  parameters and moments, `batch_spec`, `cache_spec`)
  output_bytes    the step's outputs reckoned the same way; alias_bytes
                  the donated ones among them (train: parameters and
                  optimizer state; decode: the caches)

`collectives` are reckoned per device from those specs, not compiled,
under the reference's kind names (the bytes are each collective's result
buffer, as the reference's HLO parser counts them):

  all-gather      a weight sharded over the data axes (FSDP): once in
                  each forward of a microbatch, again in the remat
                  forward of training; pod_compress: the int8 payloads
                  (P x the leaf's intra-pod shard) and the f32 scales
  reduce-scatter  an FSDP weight's f32 gradient, once a microbatch
  all-reduce      a weight replicated over the data axes: its gradient,
                  once a step; a row-parallel weight sharded over the
                  model axis: its [tokens, D] output in each forward and
                  its input gradient in the backward; the vocab-parallel
                  embedding's output; the sharded logits' max and sum
                  ([tokens] f32 each); MoE "replicated_psum": the FFN
                  output in f32; decode with the cache's seq dim
                  sharded: each attention layer's partial output and its
                  two softmax stats, f32
  all-to-all      MoE "routed_a2a": the dispatched rows and their
                  return, [tp, cap, D] each way a forward and a backward

Two counts are reckoned rather than traced, each exactly:
  * microbatches past the third: microbatches 2..n repeat the same ops on
    the same shapes, so a step of n is the step of 3 plus (n - 3) x (the
    step of 3 minus the step of 2);
  * the sLSTM's per-token loop: in every forward pass its first step runs
    and is counted, and the other S - 1 return the first's carry (on
    `meta` values do not exist) and add the first's FLOPs and bytes to a
    tally. A forward-only cell adds the tally; training adds it and the
    skipped steps' backward, two forwards' worth (as the reference's
    sLSTM term takes it): 3 x the tally, or 2 x with remat, whose tally
    holds two forward passes.

The `paper-kvstore` cell runs one shard's store step (the per-device
program) on the CPU at the cell's per-shard size, on real seeded data;
its all_to_all bytes are reckoned from `core.routing`'s bucket shapes
(the five route payloads a mesh axis going out, five coming back).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
import weakref
from contextlib import ExitStack, contextmanager

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ALL, get_config
from repro_torch.configs.base import SHAPES, cells_for
from repro_torch.exec import exec_mode
from repro_torch.launch.mesh import dp_axes_of, make_production_mesh, n_devices
from repro_torch.models import model as M
from repro_torch.models import ssm
from repro_torch.models.blocks import block_kinds
from repro_torch.optim.adamw import adamw_init
from repro_torch.parallel.sharding import P, params_shardings, use_mesh
from repro_torch.train.step import (make_serve_decode, make_serve_prefill,
                                    make_train_step)

# per-cell microbatches (the reference's baseline settings)
MICROBATCHES = {
    "llama3-405b": 16, "qwen1.5-110b": 8, "qwen3-moe-235b-a22b": 8,
    "llama4-scout-17b-a16e": 4, "llava-next-mistral-7b": 2,
}

META = torch.device("meta")
_ROW_PARALLEL = ("wo", "wd", "down", "out_proj", "out")


class MetaGenerator(torch.Generator):
    """A CPU generator whose draws land on the `meta` device: the
    model's initializers draw on their generator's device, and PyTorch
    has no `meta` generator."""

    @property
    def device(self) -> torch.device:
        return META


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class StepCounter(TorchDispatchMode):
    """aten ops, their input + output bytes, and the live / peak bytes of
    the storages made under the mode."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._held = set()

    def _free(self, key, n) -> None:
        self._held.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        rets = func._schema.returns
        is_view = any(r.alias_info is not None and not r.alias_info.is_write
                      for r in rets)
        if is_view:
            return out
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t)
                                                          for t in outs)
        known = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in known or key in self._held:
                continue
            n = st.nbytes()
            self._held.add(key)
            self.live += n
            weakref.finalize(st, self._free, key, n)
        self.peak = max(self.peak, self.live)
        return out


@contextmanager
def _slstm_first_step(tally: dict):
    """Run the sLSTM loop's first step of every call and hand its carry
    back for the other steps; `tally` gathers the first steps' FLOPs and
    bytes times the steps skipped."""
    step = ssm._slstm_step
    calls = {}

    def once(p, carry, xw):
        # one call's steps read slices of one x @ wx; the entry holds that
        # tensor, so no later call's can take its id
        base = xw._base if xw._base is not None else xw
        first = calls.get(id(base))
        if first is not None and first[1] is p:
            tally["flops"] += first[3]
            tally["bytes"] += first[4]
            return first[2]
        with FlopCounterMode(display=False) as fc, StepCounter() as c:
            out = step(p, carry, xw)
        calls.clear()
        calls[id(base)] = (base, p, out, fc.get_total_flops(), c.bytes)
        return out

    ssm._slstm_step = once
    try:
        yield
    finally:
        ssm._slstm_step = step


def _count(fn, *args) -> dict:
    """Run fn(*args) on `meta` in exec mode torch under the counters."""
    tally = {"flops": 0, "bytes": 0}
    with ExitStack() as es:
        es.enter_context(exec_mode("torch"))
        es.enter_context(_slstm_first_step(tally))
        fc = es.enter_context(FlopCounterMode(display=False))
        c = es.enter_context(StepCounter())
        fn(*args)
    return {"flops": fc.get_total_flops(), "bytes": c.bytes,
            "temp": c.peak, "ops": c.ops, "slstm_flops": tally["flops"],
            "slstm_bytes": tally["bytes"]}


# ---------------------------------------------------------------------------
# specs and argument bytes
# ---------------------------------------------------------------------------

def _maybe_axes(dim: int, axes, mesh):
    if not axes:
        return None
    n = math.prod(mesh.shape[a] for a in axes)
    return axes if (n and dim % n == 0) else None


def spec_size(spec, mesh) -> int:
    """Shards a spec splits a tensor into: the product of its axes'
    sizes."""
    return math.prod(mesh.shape[a] for a in P(*spec).axes())


def sharded_bytes(t: torch.Tensor, spec, mesh) -> int:
    return _nbytes(t) // spec_size(spec, mesh)


def batch_spec(t: torch.Tensor, mesh, dp_axes) -> P:
    """A batch leaf: dim 0 over the data axes where they divide it."""
    return P(_maybe_axes(t.shape[0], dp_axes, mesh), *([None] * (t.ndim - 1)))


def cache_spec(cfg, name: str, t: torch.Tensor, mesh, dp_axes,
               batch: int) -> P:
    """The reference's contiguous decode-cache rule (leaves stacked
    [n_groups, B, ...]): batch over the data axes where they divide it,
    the big context dim (seq / di / dv) over the model axis; with
    `decode_shard="seq2d"` the batch is replicated and the seq dim goes
    over (data axes..., model)."""
    seq2d = cfg.decode_shard == "seq2d"
    seq_axes = (*dp_axes, "model") if seq2d else ("model",)
    dpax = None if seq2d else _maybe_axes(batch, dp_axes, mesh)
    shape = t.shape
    if name in ("k", "v") and t.ndim == 5:              # [ng,B,S,Hkv,Dh]
        return P(None, dpax, _maybe_axes(shape[2], seq_axes, mesh), None,
                 None)
    if name in ("ckv", "kpe") and t.ndim == 4:          # [ng,B,S,r]
        return P(None, dpax, _maybe_axes(shape[2], seq_axes, mesh), None)
    if name == "c" and t.ndim == 5:                     # mlstm [ng,B,H,dk,dv]
        return P(None, dpax, None, None,
                 _maybe_axes(shape[4], ("model",), mesh))
    if name == "ssm" and t.ndim == 4:                   # [ng,B,di,n]
        return P(None, dpax, _maybe_axes(shape[2], ("model",), mesh), None)
    if name == "conv" and t.ndim == 4:                  # [ng,B,K-1,di]
        return P(None, dpax, None, _maybe_axes(shape[3], ("model",), mesh))
    if t.ndim >= 3:                                     # slstm [ng,B,d] etc.
        return P(None, dpax, *([None] * (t.ndim - 3)),
                 _maybe_axes(shape[-1], ("model",), mesh))
    return P(*([None] * t.ndim))


def _cache_items(caches) -> list:
    return [(name, t) for group in caches for name, t in group.items()]


# ---------------------------------------------------------------------------
# collectives, reckoned
# ---------------------------------------------------------------------------

def _add(coll: dict, kind: str, nbytes: float, count: int = 1) -> None:
    if count <= 0 or nbytes <= 0:
        return
    e = coll.setdefault(kind, {"count": 0, "bytes": 0})
    e["count"] += count
    e["bytes"] += int(nbytes) * count


def _tp_size(spec, mesh, dp_axes) -> int:
    return math.prod(mesh.shape[a] for a in P(*spec).axes()
                     if a not in dp_axes)


def _dp_size(spec, mesh, dp_axes) -> int:
    return math.prod(mesh.shape[a] for a in P(*spec).axes()
                     if a in dp_axes)


def reckon_collectives(cfg, shape, mesh, dp_axes, params, pspecs,
                       microbatches: int, pod_compress: bool,
                       caches=None) -> dict:
    """Per-device collectives of one step under the rules of the module
    docstring."""
    coll = {}
    train = shape.kind == "train"
    fwd = (2 if cfg.remat else 1) if train else 1
    mb = microbatches if train else 1
    dp = math.prod(mesh.shape[a] for a in dp_axes)
    tp = mesh.shape["model"]
    b = shape.global_batch
    seq = 1 if shape.kind == "decode" else shape.seq_len
    b_local = b // dp if b % dp == 0 else b
    if shape.kind == "decode" and cfg.decode_shard == "seq2d":
        b_local = b
    tokens = b_local * seq // mb                    # a microbatch's, a device
    act = 2 if cfg.compute_dtype == "bfloat16" else 4
    d = cfg.d_model
    grad_axes = tuple(a for a in dp_axes if not (pod_compress
                                                  and a == "pod"))
    named = dict(params.named_parameters())
    for name, spec in pspecs.items():
        t = named[name]
        full = _nbytes(t)
        tp_n = _tp_size(spec, mesh, dp_axes)
        if _dp_size(spec, mesh, dp_axes) > 1:
            _add(coll, "all-gather", full / tp_n, fwd * mb)
            if train:
                kept = [a for a in P(*spec).axes() if a in grad_axes
                        or a not in dp_axes]
                _add(coll, "reduce-scatter",
                     full / math.prod(mesh.shape[a] for a in kept), mb)
        elif train and math.prod(mesh.shape[a] for a in grad_axes) > 1:
            _add(coll, "all-reduce", full / tp_n)
        leaf = name.split(".")[-1]
        if (leaf in _ROW_PARALLEL and spec and spec[0] is not None
                and t.ndim == 2):
            _add(coll, "all-reduce", tokens * t.shape[1] * act,
                 (fwd + (1 if train else 0)) * mb)
        if pod_compress and train:
            intra = t.numel() / math.prod(mesh.shape[a] for a in
                                          P(*spec).axes() if a != "pod")
            n_pods = mesh.shape["pod"]
            _add(coll, "all-gather", n_pods * intra)
            _add(coll, "all-gather", n_pods * 4)
    if pspecs.get("embed") and pspecs["embed"][0] is not None:
        _add(coll, "all-reduce", tokens * d * act, mb)
    head = pspecs.get("lm_head") or pspecs.get("embed")
    if head is not None and any(x is not None for x in head):
        _add(coll, "all-reduce", tokens * 4, 2 * mb)
        if train:
            _add(coll, "all-reduce", tokens * d * act, mb)
    kinds = block_kinds(cfg) * (cfg.n_layers // len(block_kinds(cfg)))
    n_moe = kinds.count("moe")
    passes = fwd + (1 if train else 0)
    if n_moe and cfg.moe_impl == "replicated_psum":
        _add(coll, "all-reduce", tokens * d * 4, n_moe * passes * mb)
    if n_moe and cfg.moe_impl == "routed_a2a":
        t_shard = max(1, -(-tokens // tp))
        cap = max(1, int(cfg.moe_capacity_factor * t_shard
                         * cfg.n_experts_active / tp) + 8)
        _add(coll, "all-to-all", tp * cap * d * act, 2 * n_moe * passes * mb)
    if caches is not None:
        n_attn = sum(1 for k in kinds if k in ("dense", "moe", "hymba"))
        k_spec = None
        for name, t in _cache_items(caches):
            if name in ("k", "ckv"):
                k_spec = cache_spec(cfg, name, t, mesh, dp_axes, b)
                break
        if k_spec is not None and k_spec[2] is not None:
            dh = (cfg.v_head_dim if cfg.attn_type == "mla"
                  else cfg.resolved_head_dim)
            _add(coll, "all-reduce",
                 b_local * cfg.n_heads * (dh + 2) * 4, n_attn)
    return coll


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def _batch(cfg, b: int, s: int, with_labels: bool) -> dict:
    i32 = dict(dtype=torch.int32, device=META)
    if cfg.n_codebooks:
        batch = {"tokens": torch.empty((b, cfg.n_codebooks, s), **i32)}
        if with_labels:
            batch["labels"] = torch.empty((b, cfg.n_codebooks, s), **i32)
    else:
        ft = cfg.frontend_tokens
        batch = {"tokens": torch.empty((b, s - ft), **i32)}
        if with_labels:
            batch["labels"] = torch.empty((b, s), **i32)
        if ft:
            batch["prefix_embeds"] = torch.empty((b, ft, cfg.d_model),
                                                 device=META)
    if with_labels:
        batch["loss_mask"] = torch.empty((b, s), device=META)
    return batch


def _params(cfg):
    return M.init_params(cfg, MetaGenerator())


def _train_inputs(cfg, rows: int, seq: int, n_pods: int = 0) -> tuple:
    """(params, optimizer state, batch) of a train step on `meta`."""
    params = _params(cfg).make_trainable()
    opt = {"adam": adamw_init(params)}
    if n_pods:
        from repro_torch.optim.compress import compress_state_init
        opt["residuals"] = compress_state_init(params, n_pods)
    return params, opt, _batch(cfg, rows, seq, True)


def _train_counts(cfg, shape, mb: int, pod_compress: bool, mesh) -> dict:
    """The counts of a step of `mb` microbatches: the step of min(mb, 3)
    counted and extended (module docstring)."""
    b_mb = shape.global_batch // mb
    n_pods = mesh.shape["pod"] if pod_compress else 0

    def run(n):
        step = make_train_step(cfg, microbatches=n,
                               pod_compress=pod_compress, mesh=mesh)
        return _count(step, *_train_inputs(cfg, b_mb * n, shape.seq_len,
                                           n_pods))

    if pod_compress or mb <= 3:
        # a pod's slice holds global / P rows: count whole steps
        return run(mb)
    c2, c3 = run(2), run(3)
    c = {k: c3[k] + (mb - 3) * (c3[k] - c2[k]) for k in c3}
    c["temp"] = max(c2["temp"], c3["temp"])
    return c


def _slstm_mult(cfg, shape) -> int:
    if shape.kind != "train":
        return 1
    return 2 if cfg.remat else 3


def _lm_cell(cfg, shape, mesh, dp_axes, mb: int, donate: bool,
             report: dict, memo: dict | None) -> None:
    pod_compress = (shape.kind == "train" and cfg.pod_compress
                    and "pod" in mesh.axis_names)
    caches = opt = None
    report["microbatches"] = mb if shape.kind == "train" else 1
    if shape.kind == "train":
        params, opt, batch = _train_inputs(
            cfg, shape.global_batch, shape.seq_len,
            mesh.shape["pod"] if pod_compress else 0)

        def run():
            return _train_counts(cfg, shape, mb, pod_compress, mesh)
    elif shape.kind == "prefill":
        params = _params(cfg)
        batch = _batch(cfg, shape.global_batch, shape.seq_len, False)

        def run():
            return _count(make_serve_prefill(cfg, cache_len=shape.seq_len),
                          params, batch)
    else:
        b, s = shape.global_batch, shape.seq_len
        params = _params(cfg)
        caches = M.init_caches(params, cfg, b, s)
        tok = (b, cfg.n_codebooks, 1) if cfg.n_codebooks else (b, 1)
        batch = {"token": torch.empty(tok, dtype=torch.int32, device=META),
                 "pos": torch.empty((b,), dtype=torch.int32, device=META)}

        def run():
            return _count(make_serve_decode(cfg), params, batch["token"],
                          batch["pos"], caches)
    # the folded step is the same program on every mesh, but for the MoE
    # dispatch (tokens split over the mesh's shards) and the pod exchange
    key = (cfg, shape, mb, mesh if (cfg.is_moe or pod_compress) else None)
    if memo is None:
        c = run()
    else:
        if key not in memo:
            memo[key] = run()
        c = memo[key]
    mult = _slstm_mult(cfg, shape)
    flops = c["flops"] + mult * c["slstm_flops"]
    nbytes = c["bytes"] + mult * c["slstm_bytes"]
    dev = report["devices"]
    report["flops"] = float(flops) / dev
    report["bytes_accessed"] = float(nbytes) / dev
    report["bytes_accessed_source"] = ("aten op input + output bytes, "
                                       "computed from shapes")
    report["aten_ops"] = int(c["ops"])

    pspecs = params_shardings(params, mesh, dp_axes, "model")
    named = dict(params.named_parameters())
    param_b = sum(sharded_bytes(named[n], s, mesh) for n, s in pspecs.items())
    batch_b = sum(sharded_bytes(t, batch_spec(t, mesh, dp_axes), mesh)
                  for t in batch.values())
    arg = param_b + batch_b
    out = 0
    alias = 0
    if opt is not None:
        opt_b = 2 * sum(named[n].numel() * 4 // spec_size(s, mesh)
                        for n, s in pspecs.items())
        opt_b += opt["adam"]["step"].element_size()
        if "residuals" in opt:
            opt_b += sum(sharded_bytes(opt["residuals"][n], P(None, *s), mesh)
                         for n, s in pspecs.items())
        arg += opt_b
        out = param_b + opt_b + 4 * 4            # + the 4 scalar metrics
        alias = (param_b + opt_b) if donate else 0
    if caches is not None:
        cache_b = sum(sharded_bytes(t, cache_spec(cfg, n, t, mesh, dp_axes,
                                                  shape.global_batch), mesh)
                      for n, t in _cache_items(caches))
        arg += cache_b
        logits = shape.global_batch * (cfg.n_codebooks or 1) \
            * cfg.padded_vocab * 4
        out = cache_b + logits // dev
        alias = cache_b if donate else 0
    if shape.kind == "prefill":
        pc = M.init_caches(params, cfg, shape.global_batch, shape.seq_len)
        out = sum(sharded_bytes(t, cache_spec(cfg, n, t, mesh, dp_axes,
                                              shape.global_batch), mesh)
                  for n, t in _cache_items(pc))
        out += shape.global_batch * (cfg.n_codebooks or 1) \
            * cfg.padded_vocab * 4 // dev
    report["memory"] = {"argument_bytes": int(arg), "output_bytes": int(out),
                        "temp_bytes": int(c["temp"] // dev),
                        "alias_bytes": int(alias)}
    report["collectives"] = reckon_collectives(
        cfg, shape, mesh, dp_axes, params, pspecs, mb, pod_compress, caches)


def _kvstore_cell(cfg, mesh, report: dict) -> None:
    import numpy as np

    from repro_torch.core.bits import from_u64
    from repro_torch.store.api import OP_FIND, OP_INSERT
    from repro_torch.store.engine import (LOCAL_MESH, make_store_step,
                                          sharded_init)
    lanes = cfg.store_lanes
    pool_factor = 2
    report["store_backend"] = cfg.store_backend
    report["store_exec"] = "torch"
    rng = np.random.default_rng(0)
    state = sharded_init(cfg.store_backend, 1, cfg.store_capacity,
                         device="cpu")
    ops = torch.as_tensor(rng.choice([OP_INSERT, OP_FIND], lanes),
                          dtype=torch.int32)
    keys = from_u64(rng.integers(1, 2**63, lanes, dtype=np.uint64), "cpu")
    vals = from_u64(rng.integers(1, 2**32, lanes, dtype=np.uint64), "cpu")
    step = make_store_step(LOCAL_MESH, ("local",), lanes,
                           backend=cfg.store_backend,
                           pool_factor=pool_factor, exec_mode="torch")
    with FlopCounterMode(display=False) as fc, StepCounter() as c:
        state2, *_ = step(state, ops, keys, vals)
    report["flops"] = float(fc.get_total_flops())
    report["bytes_accessed"] = float(c.bytes)
    report["bytes_accessed_source"] = ("aten op input + output bytes of one "
                                       "shard's step, computed from shapes")
    report["aten_ops"] = int(c.ops)
    state_b = sum(_nbytes(t) for t in _tensors(state[0]))
    streams = lanes * (4 + 8 + 8)
    report["memory"] = {"argument_bytes": int(state_b + streams),
                        "output_bytes": int(state_b + lanes * (8 + 1) + 4),
                        "temp_bytes": int(c.peak), "alias_bytes": 0}
    coll = {}
    pool = lanes * pool_factor
    out_b = 8 + 8 + 4 + 8 + 1         # keys, vals, ops, origin, valid
    back_b = 8 + 4 + 4 + 4 + 1        # results, found, src, lane, valid
    for size in mesh.axis_sizes:
        cap = max(1, -(-pool // size))
        _add(coll, "all-to-all", size * cap * out_b)
        _add(coll, "all-to-all", size * cap * back_b)
    for e in coll.values():           # one all_to_all a payload array
        e["count"] *= 5
    report["collectives"] = coll


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               microbatches: int | None = None, donate: bool = True,
               overrides: dict | None = None,
               memo: dict | None = None) -> dict:
    """The dry run of one cell: the reference's report keys (module
    docstring says how each is made). `memo`, a dict the caller keeps,
    shares a cell's counts between the two meshes where the traced
    program is the same."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    dp_axes = dp_axes_of(mesh)
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = SHAPES[shape_name]
    report = {"arch": arch, "shape": shape_name,
              "mesh": "2x16x16" if multi_pod else "16x16",
              "devices": n_devices(mesh)}
    if cfg.family == "kvstore":
        _kvstore_cell(cfg, mesh, report)
    else:
        mb = microbatches or MICROBATCHES.get(arch, 1)
        with use_mesh(mesh, dp_axes=dp_axes, tp_axis="model"):
            _lm_cell(cfg, shape, mesh, dp_axes, mb, donate, report, memo)
    report["collective_bytes_total"] = sum(
        v["bytes"] for v in report["collectives"].values())
    return report


def all_cells() -> list:
    cells = []
    for arch in ALL:
        names = ["train_4k"] if arch == "paper-kvstore" else cells_for(arch)
        cells.extend((arch, sh) for sh in names)
    return cells


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--out", default="reports/torch/dryrun")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    cells = all_cells() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = 0
    for arch, sh in cells:
        memo = {}
        for mp in meshes:
            tag = f"{arch}__{sh}__{'2x16x16' if mp else '16x16'}"
            t0 = time.perf_counter()
            try:
                rep = lower_cell(arch, sh, mp, microbatches=args.microbatches,
                                 memo=memo)
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rep, f, indent=1)
                mem = rep["memory"]
                per_dev = mem["argument_bytes"] + mem["temp_bytes"]
                print(f"OK   {tag:60s} flops={rep['flops']:.3e} "
                      f"coll={rep['collective_bytes_total']:.3e}B "
                      f"mem/dev~{per_dev / 2**30:.2f}GiB "
                      f"({time.perf_counter() - t0:.1f} s)", flush=True)
            except Exception as e:
                failures += 1
                print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
                traceback.print_exc(limit=3)
    print(f"done: {len(cells) * len(meshes) - failures} ok, "
          f"{failures} failed")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
