"""The port's data pipeline, checkpointing, training loop and launchers
against the JAX reference, on the CPU.

`synth_batch` is integer-equal to the reference's; `push_one` /
`pop_one` equal the reference's on a scripted sequence that fills the
queue's block pool, empties it and wraps around (u64 values above 2^63
travel as their int64 bit patterns); the pipeline hands steps over in
order, drops a stale one after a restart, and ends drained (pushed ==
popped, every block free); a producer stalled for 1 s against a 0.2 s
deadline costs a straggler skip and no loss; a checkpoint round trip is
exact and a stale `.tmp` stays invisible; a restarted run continues the
uninterrupted one within 1e-6 relative (as
tests/test_fault_tolerance.py holds the reference); `train()` for 3
steps from the reference's initial parameters agrees with the
reference's `train()`; both launchers' `main()` run in-process on the
CPU.
"""
import os
import sys
import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro  # noqa: F401  (enables x64)
from repro.configs import get_reduced as j_get_reduced
from repro.core import blockpool as j_blockpool
from repro.core import ringqueue as j_rq
from repro.data.pipeline import synth_batch as j_synth_batch
from repro.models import model as JM
from repro.train.loop import train as j_train
from repro_torch.checkpoint.ckpt import latest_step, restore, save
from repro_torch.configs import get_reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import blockpool as t_blockpool
from repro_torch.core import ringqueue as t_rq
from repro_torch.data import pipeline as P
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import model as TM
from repro_torch.optim.adamw import adamw_init
from repro_torch.train.loop import train

ARCH = "qwen3-1.7b"
SHAPE = ShapeConfig("tiny", seq_len=16, global_batch=4, kind="train")


def _u64_bits(x) -> np.ndarray:
    return np.asarray(x).astype(np.uint64).view(np.int64)


# ---------------------------------------------------------------------------
# synth_batch, the queue's one-value ops, the block pool's eq. (5)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,seed,step,shard,n_shards", [
    ("qwen3-1.7b", 0, 0, 0, 1), ("qwen3-1.7b", 3, 17, 1, 2),
    ("hymba-1.5b", 7, 2, 3, 4), ("llava-next-mistral-7b", 0, 0, 0, 1),
    ("llava-next-mistral-7b", 5, 3, 1, 2), ("musicgen-medium", 2, 1, 0, 1)])
def test_synth_batch_matches_reference(arch, seed, step, shard, n_shards):
    shape = ShapeConfig("t", seq_len=24, global_batch=8, kind="train")
    want = j_synth_batch(j_get_reduced(arch), shape, seed, step, shard,
                         n_shards)
    got = P.synth_batch(get_reduced(arch), shape, seed, step, shard,
                        n_shards, device="cpu")
    assert got.keys() == want.keys()
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].dtype == {np.dtype(np.int32): torch.int32,
                                np.dtype(np.float32): torch.float32}[v.dtype]
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


# (op, value): a 2-block queue of 2-slot blocks holds 4 values; the 5th
# push finds no free block; pops drain it, one pop finds it empty, and
# later pushes run on the recycled blocks
QUEUE_SCRIPT = ([("pop", None)]
                + [("push", v) for v in (5, 2 ** 63 + 9, 2 ** 64 - 1, 7, 11)]
                + [("pop", None)] * 5
                + [("push", v) for v in (13, 2 ** 63, 17)]
                + [("pop", None)] * 2 + [("push", 19)] + [("pop", None)] * 3)
QUEUE_FIELDS = ("fe", "front", "rear", "wclosed", "rclosed", "nxt", "use",
                "head_blk", "tail_blk", "pushed", "popped")


def test_push_one_pop_one_match_reference():
    j_push, j_pop = jax.jit(j_rq.push_one), jax.jit(j_rq.pop_one)
    jq = j_rq.queue_init(2, 2, jnp.uint64)
    tq = t_rq.queue_init(2, 2, device="cpu")
    saw = set()
    for op, val in QUEUE_SCRIPT:
        if op == "push":
            jq, jok = j_push(jq, np.uint64(val))
            tq, tok = t_rq.push_one(tq, int(_u64_bits(val)))
            assert bool(tok) == bool(jok), (op, val)
            saw.add(("push", bool(jok)))
        else:
            jq, jv, jgot = j_pop(jq)
            tq, tv, tgot = t_rq.pop_one(tq)
            assert bool(tgot) == bool(jgot)
            assert int(tv) == int(_u64_bits(jv))
            saw.add(("pop", bool(jgot)))
        for f in QUEUE_FIELDS:
            np.testing.assert_array_equal(getattr(tq, f).numpy(),
                                          np.asarray(getattr(jq, f)),
                                          err_msg=f"{f} after {op} {val}")
        np.testing.assert_array_equal(tq.data.numpy(), _u64_bits(jq.data))
        np.testing.assert_array_equal(
            tq.recycles.numpy(), np.asarray(jq.recycles).view(np.int32))
    # a full queue refused a push, an empty one a pop
    assert saw == {("push", True), ("push", False), ("pop", True),
                   ("pop", False)}
    assert int(tq.recycles.sum()) > 0


@pytest.mark.parametrize("n_ops,block", [(1, 1), (8, 1), (8, 8), (4, 100),
                                         (37, 5)])
def test_expected_blocks_in_use_matches_reference(n_ops, block):
    assert (t_blockpool.expected_blocks_in_use(n_ops, block)
            == j_blockpool.expected_blocks_in_use(n_ops, block))


# ---------------------------------------------------------------------------
# the prefetch pipeline
# ---------------------------------------------------------------------------

def _steps_pipeline(start=0, depth=4, deadline=30.0, delay=None):
    return P.PrefetchPipeline(lambda s: {"step": torch.tensor([s])},
                              depth=depth, deadline=deadline,
                              delay_injector=delay, device="cpu",
                              start=start)


def _drained(pipe):
    pipe.stop()
    assert not pipe._t.is_alive()
    assert int(pipe.queue.pushed) == int(pipe.queue.popped) > 0
    assert int(pipe.pool.num_free()) == pipe.depth
    assert not bool(pipe.pool.in_use.any())


@pytest.mark.parametrize("start", [0, 5])
def test_pipeline_delivers_steps_in_order(start):
    pipe = _steps_pipeline(start=start)
    got = [int(pipe.get(s)["step"]) for s in range(start, start + 10)]
    assert got == list(range(start, start + 10))
    assert pipe.straggler_skips == 0
    _drained(pipe)


def test_pipeline_under_fast_thread_switching():
    """The producer and the consumer share the queue, the pool and the
    staged buffers under one lock: with the interpreter switching threads
    every microsecond, every step still arrives once, in order, and the
    pool's accounting balances."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pipe = _steps_pipeline(depth=2)
        got = [int(pipe.get(s)["step"]) for s in range(150)]
        _drained(pipe)
    finally:
        sys.setswitchinterval(old)
    assert got == list(range(150))
    assert pipe.straggler_skips == 0


def test_pipeline_drops_stale_steps_after_a_restart():
    """A consumer that resumes at step 3 from a producer that starts at 0
    drops steps 0-2 and takes step 3 from the prefetch."""
    pipe = _steps_pipeline(start=0)
    assert int(pipe.get(3)["step"]) == 3
    assert int(pipe.get(4)["step"]) == 4
    assert pipe.straggler_skips == 0
    assert int(pipe.queue.popped) >= 5
    _drained(pipe)


class Stall:
    """A producer stall at `step`: 1 s from the moment the consumer asks
    for that step (so the 0.2 s deadline passes whatever the machine's
    load), through `wrap`ped `get`s."""

    def __init__(self, step=2):
        self.step = step
        self.asked = threading.Event()

    def __call__(self, step):
        if step == self.step:
            assert self.asked.wait(timeout=60)
            time.sleep(1.0)

    def wrap(self, get):
        def wrapped(pipe, step):
            if step == self.step:
                self.asked.set()
            return get(pipe, step)
        return wrapped


def test_pipeline_straggler_step_made_inline(monkeypatch):
    stall = Stall()
    monkeypatch.setattr(P.PrefetchPipeline, "get",
                        stall.wrap(P.PrefetchPipeline.get))
    pipe = _steps_pipeline(depth=1, deadline=0.2, delay=stall)
    got = [int(pipe.get(s)["step"]) for s in range(5)]
    assert got == list(range(5))
    assert pipe.straggler_skips >= 1
    _drained(pipe)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_round_trip_exact(tmp_path):
    cfg = get_reduced(ARCH)
    params = TM.init_params(cfg, torch.Generator("cpu").manual_seed(0))
    opt = {"adam": adamw_init(params)}
    for v in opt["adam"]["m"].values():
        v.normal_(generator=torch.Generator("cpu").manual_seed(1))
    opt["adam"]["step"] += 7
    extra = {"half": torch.randn(3, 5).to(torch.bfloat16),
             "ids": torch.arange(6, dtype=torch.int32)}
    tree = (params, opt, extra)
    d = str(tmp_path / "c")
    save(d, 5, tree, {"next_step": 5})
    os.makedirs(os.path.join(d, "step_00000009.tmp"))   # a crashed save
    assert latest_step(d) == 5
    assert latest_step(str(tmp_path / "none")) is None

    like_p = TM.init_params(cfg, torch.Generator("cpu").manual_seed(9))
    like_p.load_compute_copy("bfloat16")
    like = (like_p.make_trainable(),
            {"adam": adamw_init(like_p)},
            {"half": torch.zeros(3, 5, dtype=torch.bfloat16),
             "ids": torch.zeros(6, dtype=torch.int32)})
    got, meta = restore(d, 5, like, device="cpu")
    assert meta == {"next_step": 5}
    assert got[0] is like_p and all(p.requires_grad
                                    for p in like_p.parameters())
    assert not any(m._compute for m in like_p.modules()
                   if hasattr(m, "_compute"))

    def flat(t):
        p, o, e = t
        return ([(n, v) for n, v in p.named_parameters()]
                + [(k, v) for k, v in o["adam"]["m"].items()]
                + [(k, v) for k, v in o["adam"]["v"].items()]
                + [("step", o["adam"]["step"])] + list(e.items()))
    for (n, a), (_, b) in zip(flat(tree), flat(got), strict=True):
        assert a.dtype == b.dtype, n
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=n)


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------

def test_restart_continues_exactly(tmp_path):
    cfg = get_reduced(ARCH)
    _, _, ref = train(cfg, SHAPE, steps=6, seed=3, log_every=0,
                      device="cpu")
    d = str(tmp_path / "ckpt")
    train(cfg, SHAPE, steps=3, seed=3, ckpt_dir=d, ckpt_every=3,
          log_every=0, async_save=False, device="cpu")
    assert latest_step(d) == 3
    _, opt, cont = train(cfg, SHAPE, steps=6, seed=3, ckpt_dir=d,
                         ckpt_every=100, log_every=0, device="cpu")
    assert [h["step"] for h in cont["history"]] == [3, 4, 5]
    np.testing.assert_allclose([h["loss"] for h in cont["history"]],
                               [h["loss"] for h in ref["history"][3:]],
                               rtol=1e-6)
    assert int(opt["adam"]["step"]) == 6


def test_async_checkpoints_during_training(tmp_path):
    cfg = get_reduced(ARCH)
    d = str(tmp_path / "a")
    params, opt, _ = train(cfg, SHAPE, steps=4, seed=1, ckpt_dir=d,
                           ckpt_every=2, log_every=0, device="cpu")
    assert latest_step(d) == 4
    like = (TM.init_params(cfg, torch.Generator("cpu").manual_seed(5)),
            {"adam": adamw_init(params)})
    (p2, o2), meta = restore(d, 4, like)
    assert meta == {"next_step": 4}
    for (n, a), (_, b) in zip(params.named_parameters(),
                              p2.named_parameters()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=n)
    torch.testing.assert_close(o2["adam"]["v"], opt["adam"]["v"], rtol=0,
                               atol=0)


def test_straggler_keeps_the_loss_stream(monkeypatch):
    cfg = get_reduced(ARCH)
    _, _, ref = train(cfg, SHAPE, steps=4, seed=7, log_every=0,
                      device="cpu")
    orig = P.PrefetchPipeline.__init__

    def tight(self, make_batch, depth=4, deadline=30.0, delay_injector=None,
              **kw):
        # depth 1 (no lookahead hides the stall) and a tight deadline
        orig(self, make_batch, depth=1, deadline=0.2,
             delay_injector=delay_injector, **kw)

    stall = Stall()
    monkeypatch.setattr(P.PrefetchPipeline, "__init__", tight)
    monkeypatch.setattr(P.PrefetchPipeline, "get",
                        stall.wrap(P.PrefetchPipeline.get))
    _, _, out = train(cfg, SHAPE, steps=4, seed=7, log_every=0, device="cpu",
                      delay_injector=stall)
    assert out["straggler_skips"] >= 1
    np.testing.assert_allclose([h["loss"] for h in out["history"]],
                               [h["loss"] for h in ref["history"]],
                               rtol=1e-6)


def test_train_matches_reference_train():
    """3 steps from the reference's initial parameters (f32 compute):
    the losses within 1e-5 relative (the gradients agree to a bf16 step of
    the attention operands, see tests/test_torch_train.py, and one Adam
    step moves a parameter by at most 2 lr)."""
    jcfg = j_get_reduced(ARCH).replace(compute_dtype="float32")
    tcfg = get_reduced(ARCH).replace(compute_dtype="float32")
    _, _, ref = j_train(jcfg, SHAPE, steps=3, seed=2, log_every=0)
    jp = JM.init_params(jax.random.PRNGKey(2), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    _, _, out = train(tcfg, SHAPE, steps=3, seed=2, log_every=0,
                      device="cpu", params=tp)
    assert [h["step"] for h in out["history"]] == [0, 1, 2]
    for key, tol in (("loss", 1e-5), ("grad_norm", 2.0 ** -8)):
        np.testing.assert_allclose([h[key] for h in out["history"]],
                                   [h[key] for h in ref["history"]],
                                   rtol=tol, err_msg=key)


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("launcher,argv,expect", [
    (launch_train, ["--arch", ARCH, "--steps", "2", "--seq", "16",
                    "--batch", "4", "--device", "cpu"], "final loss"),
    (launch_serve, ["--arch", ARCH, "--requests", "3", "--max-new", "4",
                    "--device", "cpu"], "served 3 requests / 12 tokens; "
                                        "pool free=64"),
    (launch_train, ["--arch", "llava-next-mistral-7b", "--steps", "1",
                    "--seq", "16", "--batch", "2", "--device", "cpu"],
     "final loss"),
    (launch_train, ["--arch", "musicgen-medium", "--steps", "1", "--seq",
                    "16", "--batch", "2", "--device", "cpu"], "final loss"),
    (launch_serve, ["--arch", "qwen1.5-110b", "--requests", "2",
                    "--max-new", "3", "--device", "cpu"],
     "served 2 requests / 6 tokens; pool free=64"),
    (launch_serve, ["--arch", "llama3-405b", "--requests", "2",
                    "--max-new", "3", "--device", "cpu"],
     "served 2 requests / 6 tokens; pool free=64"),
    (launch_serve, ["--arch", "llava-next-mistral-7b", "--requests", "2",
                    "--max-new", "3", "--device", "cpu"],
     "served 2 requests / 6 tokens; pool free=64")])
def test_launcher_runs_on_the_cpu(launcher, argv, expect, capsys):
    launcher.main(argv)
    assert expect in capsys.readouterr().out


@pytest.mark.parametrize("launcher,argv,cells", [
    (launch_train, ["--arch", ARCH, "--dryrun"], ["train_4k__16x16"]),
    (launch_serve, ["--arch", ARCH, "--dryrun", "--multi-pod"],
     ["prefill_32k__2x16x16", "decode_32k__2x16x16"])])
def test_launcher_dryrun(launcher, argv, cells, capsys, tmp_path,
                         monkeypatch):
    """`--dryrun` runs the full config's cells shapes-only in-process
    (`launch.dryrun`; the reports land in the working directory)."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        launcher.main(argv)
    assert e.value.code == 0
    out = capsys.readouterr().out
    for cell in cells:
        assert f"OK   {argv[1]}__{cell}" in out
        assert (tmp_path / "reports" / "torch" / "dryrun"
                / f"{argv[1]}__{cell}.json").exists()
    assert "done: 1 ok, 0 failed" in out


@pytest.mark.parametrize("launcher,argv,match", [
    (launch_train, ["--arch", ARCH, "--multi-pod"], "only with --dryrun"),
    (launch_serve, ["--arch", ARCH, "--multi-pod"], "only with --dryrun"),
    (launch_serve, ["--arch", "hymba-1.5b", "--device", "cpu"],
     "paged engine serves GQA transformer families"),
    (launch_serve, ["--arch", "musicgen-medium", "--device", "cpu"],
     "a codebook model")])
def test_launcher_refusals(launcher, argv, match):
    with pytest.raises(SystemExit, match=match):
        launcher.main(argv)
