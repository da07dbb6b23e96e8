"""Data pipeline: a deterministic synthetic token stream and a prefetch
through the paper's structures (counterpart of `repro.data.pipeline`).

Staging buffers come from a §V block pool; the producer thread allocates
a buffer, fills it and pushes its id onto a §III ring queue; the consumer
pops ids and recycles the buffers. The pool and the queue live on the
trainer's device.

Determinism and fault tolerance: batch(step, shard) is a pure function
of (seed, step, shard), so a restart from any checkpoint replays the
exact stream, and no pipeline state needs checkpointing beyond the step
counter. Straggler mitigation: the consumer takes whichever prefetched
batch is ready; past `deadline` it counts a straggler skip and makes the
batch inline (the same function) instead of blocking the step. A batch
the producer delivers for a step already taken is dropped.

On the card the producer thread works on two streams of its own: the
queue and pool operations run on a control stream that the consumer's
operations on them share (each side under the lock, so their order on
that stream is the lock's order), and a batch is built on a copy stream
and handed over with an event that the consumer's stream waits on; each
tensor of it is then marked used on the consumer's stream, so the
caching allocator does not give its memory back to the copy stream
early. The exec mode is a `ContextVar` that a new thread does not
inherit, so the producer takes its device as an argument.
"""
from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from repro_torch.core.blockpool import blockpool_init, pool_alloc, pool_free
from repro_torch.core.layout import resolve_device
from repro_torch.core.ringqueue import pop_one, push_one, queue_init


def synth_batch(cfg, shape, seed: int, step: int, shard: int = 0,
                n_shards: int = 1, *, device="cuda"):
    """Pure function of (seed, step, shard): the replayable batch, on
    `device`. A frontend's `frontend_tokens` ft take the first ft of the
    seq_len positions: tokens [B, S - ft], labels [B, S] with ft zeros in
    front, the loss mask zero over them, and `prefix_embeds` [B, ft, D]
    f32, drawn after the tokens, as the reference draws them."""
    dev = resolve_device(device)
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, step, shard, n_shards]))
    b = shape.global_batch // n_shards
    s = shape.seq_len

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    if cfg.n_codebooks:
        toks = rng.integers(0, cfg.vocab_size, (b, cfg.n_codebooks, s + 1))
        return {"tokens": put(toks[..., :-1], torch.int32),
                "labels": put(toks[..., 1:], torch.int32),
                "loss_mask": torch.ones((b, s), dtype=torch.float32,
                                        device=dev)}
    ft = cfg.frontend_tokens
    toks = rng.integers(0, cfg.vocab_size, (b, s - ft + 1))
    mask = torch.ones((b, s), dtype=torch.float32, device=dev)
    mask[:, :ft] = 0.0
    batch = {"tokens": put(toks[:, :-1], torch.int32),
             "labels": put(np.pad(toks[:, 1:], ((0, 0), (ft, 0))),
                           torch.int32),
             "loss_mask": mask}
    if ft:
        emb = rng.standard_normal((b, ft, cfg.d_model)).astype(
            np.float32) * 0.02
        batch["prefix_embeds"] = put(emb, torch.float32)
    return batch


class PrefetchPipeline:
    """Producer thread + block-pool staging + ring-queue handoff.

    `start` is the first step the producer makes (a resumed run's next
    step); `device` is where the pool, the queue and the batches live."""

    def __init__(self, make_batch, depth: int = 4, deadline: float = 30.0,
                 delay_injector=None, *, device="cuda", start: int = 0):
        self.make_batch = make_batch
        self.depth = depth
        self.deadline = deadline
        self.delay_injector = delay_injector          # test hook (straggler)
        self.device = resolve_device(device)
        cuda = self.device.type == "cuda"
        self._ctl = torch.cuda.Stream(self.device) if cuda else None
        self._copy = torch.cuda.Stream(self.device) if cuda else None
        with self._on(self._ctl):
            self.pool = blockpool_init(depth, device=self.device)
            self.queue = queue_init(max_blocks=4, block_size=max(depth, 4),
                                    device=self.device)
        self.buffers = [None] * depth
        self.straggler_skips = 0
        self._next_produce = start
        self._next_consume = start
        self._lock = threading.Lock()
        self._stop = False
        self._error = None
        self._t = threading.Thread(target=self._producer, daemon=True)
        self._t.start()

    @staticmethod
    def _on(stream):
        return (torch.cuda.stream(stream) if stream is not None
                else contextlib.nullcontext())

    def _producer(self):
        try:
            self._produce()
        except BaseException as e:            # surfaced by the next get()
            self._error = e
            raise

    def _produce(self):
        with self._on(self._ctl):
            want = torch.ones(1, dtype=torch.bool, device=self.device)
        while not self._stop:
            with self._lock:
                step = self._next_produce
            if step - self._next_consume >= self.depth:
                time.sleep(0.001)
                continue
            if self.delay_injector:
                self.delay_injector(step)
            with self._on(self._copy):
                batch = self.make_batch(step)
                ready = (torch.cuda.Event() if self._copy is not None
                         else None)
                if ready is not None:
                    ready.record(self._copy)
            with self._lock, self._on(self._ctl):
                # guards the (queue, pool, buffers) triple: each state
                # update is linearizable, swapping the Python references
                # between threads is not
                self.pool, ids, _, got = pool_alloc(self.pool, want)
                if bool(got[0]):
                    bid = int(ids[0])
                    self.buffers[bid] = (step, batch, ready)
                    self.queue, _ = push_one(self.queue, bid)
                    self._next_produce = step + 1
                    continue
            time.sleep(0.001)

    def _take(self, batch, ready):
        """Hand a producer-built batch to the caller's stream."""
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for t in batch.values():
                t.record_stream(stream)
        return batch

    def _pop(self):
        """Pop one staged batch and free its block: (step, batch, ready)
        or None when the queue is empty."""
        with self._lock, self._on(self._ctl):
            self.queue, val, got = pop_one(self.queue)
            if not bool(got):
                return None
            bid = int(val)
            staged, self.buffers[bid] = self.buffers[bid], None
            self.pool = pool_free(
                self.pool, val.to(torch.int32)[None],
                torch.ones(1, dtype=torch.bool, device=self.device))
            self._next_consume = max(self._next_consume, staged[0] + 1)
            return staged

    def get(self, step: int):
        """Batch for `step`: from the prefetch if it is there, else made
        inline (counted as a straggler skip)."""
        t0 = time.monotonic()
        while True:
            if self._error is not None:
                raise RuntimeError("the prefetch producer failed") \
                    from self._error
            staged = self._pop()
            if staged is not None:
                got_step, batch, ready = staged
                if got_step == step:
                    return self._take(batch, ready)
                continue      # stale prefetch (a skipped step): drop it
            if time.monotonic() - t0 > self.deadline:
                self.straggler_skips += 1
                self._next_consume = max(self._next_consume, step + 1)
                return self.make_batch(step)
            time.sleep(0.0005)

    def stop(self):
        """Stop the producer, then drop the batches it staged (their
        blocks freed), so pushed == popped and the whole pool is free."""
        self._stop = True
        self._t.join(timeout=5)
        while self._pop() is not None:
            pass
