"""Continuous-batching serving engine (counterpart of
`repro.serving.engine`): a host loop around device steps,

  arrivals -> §III ring queue -> the `obs:pq` priority store -> admit into
  free slots -> prefill writes §V pool pages (+ §VII prefix-cache sharing)
  -> decode batch through paged attention -> finished requests recycle
  their pages.

Admission is capacity-aware: a request admits only if the pool covers its
pages; an allocation failure parks it for min(backoff_base * 2^(n-1),
backoff_cap) engine ticks (never wall clock), then resubmits it (counted
in `retries`). A request with `deadline >= 0` must be admitted within that
many ticks of its first submit: expiry is checked lazily when the
scheduler pops it (`deadline_expired`). With `shed_threshold` set, a
pending backlog above it sheds the lowest priority band in one
`scheduler.cancel_class` plan (`shed`).

A `fault_plan` (`store.resilience.FaultPlan`) injects scheduler store
drops at step boundaries; the journaled scheduler (`resilient=True`, on
whenever a fault plan is given) detects each and rebuilds the store before
its next plan, so the outputs equal the fault-free run's.

The exec mode (`exec_mode`, None = the `store.exec` default "gpu") runs
every step: in "gpu" the decode attention is the `paged_attention` CUDA
kernel and the scheduler's and prefix cache's stores run their kernels;
"torch" runs the plain versions (the reference's `use_kernel=False`).

Parameters come from `models.model.init_params` or
`convert.params_from_jax`; the engine makes their compute-dtype copy once
(`Weights.load_compute_copy`), which gives the values of the reference's
per-use casts.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.blockpool import _gen_u64
from repro_torch.core.layout import resolve_device
from repro_torch.models import model as M
from repro_torch.serving import kvcache as KV
from repro_torch.serving import prefix_cache as PC
from repro_torch.serving import scheduler as SCH
from repro_torch.serving.paged_decode import (CODEBOOK_REFUSAL,
                                              paged_decode_step)
from repro_torch.store import exec as exec_
from repro_torch.store import obs


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: np.ndarray
    max_new: int
    priority: int = 0
    deadline: int = -1      # max ticks from first submit to admission (<0: none)
    out: list = dataclasses.field(default_factory=list)
    slot: int = -1
    done: bool = False
    shed: bool = False      # dropped by overload shedding / deadline expiry
    attempts: int = 0       # admission attempts (drives the capped backoff)
    submit_step: int = -1   # engine step of first submit (admit latency t0)
    admit_step: int = -1    # engine step the request won a slot


class Engine:
    def __init__(self, cfg, params, *, max_reqs: int = 8, num_pages: int = 64,
                 page_size: int = 16, max_pages_per_req: int = 16,
                 use_prefix_cache: bool = True,
                 shed_threshold: int | None = None, shed_band: int = 2,
                 backoff_base: int = 1, backoff_cap: int = 8,
                 fault_plan=None, resilient: bool = False, device="cuda",
                 exec_mode: str | None = None):
        if cfg.attn_type != "gqa" or cfg.block_pattern != "transformer":
            raise NotImplementedError("the engine serves GQA transformers")
        if cfg.n_codebooks:
            raise NotImplementedError(CODEBOOK_REFUSAL)
        self.cfg = cfg
        self.params = params
        params.load_compute_copy(cfg.compute_dtype)
        self.device = resolve_device(device)
        self.exec_mode = exec_mode
        self.kv = KV.paged_kv_init(cfg, num_pages=num_pages,
                                   page_size=page_size, max_reqs=max_reqs,
                                   max_pages_per_req=max_pages_per_req,
                                   device=self.device)
        with exec_.exec_mode(exec_mode):
            # a fault plan needs the journaled scheduler to recover from
            self.sched = SCH.scheduler_init(
                max_pending=1024, device=self.device,
                resilient=resilient or fault_plan is not None)
            self.pc = (PC.prefix_cache_init(device=self.device)
                       if use_prefix_cache else None)
        self.shed_threshold = shed_threshold
        self.shed_band = shed_band
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.fault_plan = fault_plan
        self.res = obs.resilience_zero()   # engine-level host tally
        self._parked: list[tuple[int, int]] = []   # (retry_at_step, req_id)
        self.max_reqs = max_reqs
        self.requests: dict[int, Request] = {}
        self.slot_to_req = [-1] * max_reqs
        self.steps = 0
        self.prefix_hits = 0       # full pages served from the prefix cache
        self.prefix_lookups = 0    # full pages probed against it
        self.decode_tokens = 0     # tokens emitted by decode steps
        self._batch_fill_sum = 0.0  # sum over steps of active/max_reqs

    def _i32(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.int32),
                               device=self.device)

    def _bools(self, n: int, value: bool = True) -> torch.Tensor:
        return torch.full((n,), value, dtype=torch.bool, device=self.device)

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        self.requests[req.req_id] = req
        if req.submit_step < 0:   # resubmits keep the original arrival step
            req.submit_step = self.steps
        with exec_.exec_mode(self.exec_mode):
            self.sched, ok = SCH.submit(
                self.sched, torch.tensor([req.priority], device=self.device),
                torch.tensor([req.req_id], device=self.device),
                self._bools(1))
        assert bool(ok[0])

    def _free_slots(self):
        return [i for i, r in enumerate(self.slot_to_req) if r < 0]

    def _park(self, req: Request):
        """Deterministic capped exponential backoff in engine ticks: the
        n-th failed admission parks the request for
        min(backoff_base * 2^(n-1), backoff_cap) steps."""
        req.attempts += 1
        delay = min(self.backoff_base * (2 ** (req.attempts - 1)),
                    self.backoff_cap)
        self._parked.append((self.steps + delay, req.req_id))

    def _release_parked(self):
        due = [rid for t, rid in self._parked if t <= self.steps]
        self._parked = [(t, rid) for t, rid in self._parked
                        if t > self.steps]
        for rid in due:
            if self.requests[rid].done:           # shed/expired while parked
                continue
            self.res["retries"] += 1
            self.submit(self.requests[rid])

    def _shed_overload(self):
        """Above `shed_threshold` pending, drop the lowest priority band in
        ONE RANGE_DELETE plan and mark the shed requests done with empty
        output; parked requests are not in the store and stay."""
        if self.shed_threshold is None:
            return
        if int(SCH.pending(self.sched)) <= self.shed_threshold:
            return
        self.sched, n = SCH.cancel_class(self.sched, self.shed_band)
        parked_ids = {rid for _, rid in self._parked}
        for req in self.requests.values():
            if (not req.done and req.slot < 0
                    and req.priority == self.shed_band
                    and req.submit_step >= 0
                    and req.req_id not in parked_ids):
                req.done = True
                req.shed = True
        self.res["shed"] += n

    def _admit(self):
        free = self._free_slots()
        if not free:
            return
        k = min(len(free), 4)
        self.sched, rids, valid = SCH.pop_min(self.sched, k)
        rids = rids.cpu().numpy()
        valid = valid.cpu().numpy()
        for j in range(k):
            if not valid[j]:
                continue
            req = self.requests[int(rids[j])]
            if req.done:                          # shed while queued
                continue
            # lazy deadline expiry: checked when the scheduler pops it
            if (req.deadline >= 0
                    and self.steps > req.submit_step + req.deadline):
                req.done = True
                req.shed = True
                self.res["deadline_expired"] += 1
                continue
            slot = free.pop(0) if free else -1
            if slot < 0:
                self._park(req)                   # back off, then requeue
                continue
            self._admit_one(req, slot)

    def _admit_one(self, req: Request, slot: int):
        plen = len(req.prompt)
        page = self.kv.page_size
        mp = self.kv.max_pages_per_req

        # prefix-cache probe: leading full pages already resident? (the
        # chained hashes of the prompt's full pages, on the host)
        pkeys = (PC.page_keys(req.prompt, page) if self.pc is not None
                 else [])
        hit_ids = []
        if pkeys:
            self.prefix_lookups += len(pkeys)
            self.pc, pids, fresh = PC.lookup(
                self.pc, self.kv.pool, PC.keys_tensor(pkeys, self.device))
            for pid, f in zip(pids.tolist(), fresh.tolist()):
                if not f:
                    break
                hit_ids.append(pid)
            # keep >= 1 suffix token to prefill (the model needs a query
            # to produce the next-token logits)
            while hit_ids and len(hit_ids) * page >= plen:
                hit_ids.pop()
        n_hit = len(hit_ids)

        shared = np.full((1, mp), -1, np.int32)
        shared[0, :n_hit] = hit_ids
        kv2, ok = KV.admit_requests(
            self.kv, self._i32([slot]), self._i32([plen]), self._bools(1),
            shared_pages=self._i32(shared), n_shared=self._i32([n_hit]))
        if not bool(ok[0]):                       # pool exhausted: back off
            self._park(req)
            return
        self.kv = kv2
        cfg, params = self.cfg, self.params
        if n_hit:
            # gather the past KV from the shared pages; prefill the suffix
            ids = torch.as_tensor(hit_ids, device=self.device)
            shape = (self.kv.k.shape[0], 1, n_hit * page, *self.kv.k.shape[3:])
            past_k = self.kv.k[:, ids].reshape(shape)
            past_v = self.kv.v[:, ids].reshape(shape)
            suf = self._i32(req.prompt[n_hit * page:])[None]
            with obs.span("prefill", req_id=req.req_id, plen=plen,
                          shared_pages=n_hit):
                logits, caches, _ = M.prefill_with_past(
                    params, cfg, suf, past_k, past_v, cache_len=plen)
                nxt = int(torch.argmax(logits[0, -1]))
            # caches cover past+suffix; write only the suffix pages
            self.kv = KV.write_prefill(self.kv, slot,
                                       caches[0]["k"][:, 0, n_hit * page:],
                                       caches[0]["v"][:, 0, n_hit * page:],
                                       start_page=n_hit)
            self.prefix_hits += n_hit
        else:
            toks = self._i32(req.prompt)[None]
            with obs.span("prefill", req_id=req.req_id, plen=plen,
                          shared_pages=0):
                logits, caches, _ = M.prefill(params, cfg, toks,
                                              cache_len=plen)
                nxt = int(torch.argmax(logits[0, -1]))
            self.kv = KV.write_prefill(self.kv, slot, caches[0]["k"][:, 0],
                                       caches[0]["v"][:, 0])
        # publish this prompt's full pages for future prefix reuse
        if self.pc is not None and pkeys:
            n_pub = min(len(pkeys), mp)
            ids = self.kv.block_tables[slot, :n_pub]
            gens = _gen_u64(self.kv.pool.gen[torch.clamp(ids, min=0).long()])
            handles = (gens << 32) | ids.long()
            self.pc = PC.insert(self.pc,
                                PC.keys_tensor(pkeys[:n_pub], self.device),
                                handles, ids >= 0)
        req.out.append(nxt)
        req.slot = slot
        req.admit_step = self.steps
        self.slot_to_req[slot] = req.req_id

    def _active_slots(self):
        return [i for i, r in enumerate(self.slot_to_req) if r >= 0]

    def step(self):
        """One engine iteration: inject any scheduled fault, release parked
        retries, shed under overload, admit, decode one token for every
        active request, retire finished ones. Returns the decode batch
        size."""
        with exec_.exec_mode(self.exec_mode):
            return self._step()

    def _step(self):
        if self.fault_plan is not None:
            for f in self.fault_plan.at(self.steps):
                if f.kind == "shard_drop":
                    self.sched = SCH.inject_fault(self.sched)
        self._release_parked()
        self._shed_overload()
        with obs.span("admit"):
            self._admit()
        active = self._active_slots()
        if not active:
            return 0
        pad = self.max_reqs - len(active)
        slots = self._i32(active + [0] * pad)
        mask = torch.as_tensor([True] * len(active) + [False] * pad,
                               device=self.device)
        with obs.span("decode", batch=len(active)):
            self.kv, _ = KV.grow_for_decode(self.kv, slots, mask)
            toks = [self.requests[self.slot_to_req[s]].out[-1]
                    for s in active]
            toks = self._i32(toks + [0] * pad)[:, None]
            logits, self.kv = self._decode(toks, slots, mask)
            nxt = torch.argmax(logits, dim=-1).tolist()
        self._batch_fill_sum += len(active) / self.max_reqs
        self.decode_tokens += len(active)
        done_slots = []
        for i, s in enumerate(active):
            req = self.requests[self.slot_to_req[s]]
            req.out.append(int(nxt[i]))
            if len(req.out) >= req.max_new:
                req.done = True
                done_slots.append(s)
        if done_slots:
            self.kv = KV.release_requests(self.kv, self._i32(done_slots),
                                          self._bools(len(done_slots)))
            for s in done_slots:
                self.slot_to_req[s] = -1
        self.steps += 1
        return len(active)

    def _decode(self, toks, slots, mask):
        """One paged decode step over the batch (logits [B, V], kv)."""
        return paged_decode_step(self.params, self.cfg, toks, slots, self.kv,
                                 mask)

    def run(self, max_steps: int = 256):
        while (any(not r.done for r in self.requests.values())
               and self.steps < max_steps):
            self.step()
        return {r.req_id: r.out for r in self.requests.values()}

    def metrics(self) -> dict:
        """Host-side engine counters over the closed `obs.SERVING_SCHEMA`:
        ring depth, the prefix cache's page hit rate, mean batch fill and
        the decode totals."""
        return obs.uniform_serving_metrics(
            ring_depth=int(SCH.pending(self.sched)),
            prefix_hits=self.prefix_hits,
            prefix_lookups=self.prefix_lookups,
            prefix_hit_rate=(self.prefix_hits / self.prefix_lookups
                             if self.prefix_lookups else 0.0),
            batch_fill=(self._batch_fill_sum / self.steps
                        if self.steps else 0.0),
            decode_steps=self.steps,
            decode_tokens=self.decode_tokens)

    def resilience_metrics(self) -> dict:
        """The `obs.METRICS_SCHEMA` view of the scheduler store with every
        host tally folded in by `obs.merge_resilience`: the engine's own
        (deadline_expired / shed / retries) plus the journaled
        scheduler's (faults_injected / recoveries / replayed_ops)."""
        tally = dict(self.res)
        if self.sched.res is not None:
            for k, v in self.sched.res.tally.items():
                tally[k] += v
        return obs.merge_resilience(SCH.metrics(self.sched), tally)
