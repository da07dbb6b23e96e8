"""Seeded heavy-traffic generator (the port's own copy of
`repro.serving.traffic`; numpy only): the "millions of users" workload
shape at test scale.

`make_trace(seed, ...)` builds a deterministic request trace with the four
properties production serving traffic is hard for (the ROADMAP's
heavy-traffic story, scaled down):

* **Zipf-skewed prompt keys** — prompts share page-aligned prefixes drawn
  from a small pool with Zipf(`zipf_a`) popularity, so a few hot prefixes
  dominate (what makes the prefix cache earn its keep).
* **Bursty Poisson arrivals** — requests arrive in bursts of
  1 + Poisson(`burst_mean`) separated by geometric gaps of mean
  `1/burst_rate` ticks, not a smooth trickle (what makes bulk-pop-k
  admission earn its keep).
* **Mixed prompt lengths** — per request, prefix pages from
  `prefix_pages` plus a fresh suffix from `suffix_lens` (uneven prefill
  cost, uneven page demand).
* **Priority inversion** — every `inversion_every`-th request is an
  urgent (priority 0) short request arriving in the SAME burst as
  long low-priority (priority 2) bulk work; correct schedulers admit it
  first anyway (priority before FIFO), and the trace makes regressions
  here visible.

Every number comes from one `numpy` generator seeded with `seed`: the same
seed is the same trace, bit for bit — the determinism contract the serve
benchmark and the e2e replay test build on. `replay(...)` drives a
`repro_torch.serving.engine.Engine` through a trace tick by tick.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One arrival of the trace (prompt tokens are a host numpy array)."""
    req_id: int
    arrival: int          # replay tick the request becomes visible
    prompt: np.ndarray    # int32 tokens; leading pages come from the pool
    max_new: int
    priority: int         # 0 = most urgent (scheduler key high bits)
    deadline: int = -1    # admission deadline in ticks from submit (<0: none)


def make_trace(seed: int = 0, n_requests: int = 24, *, page_size: int = 8,
               vocab: int = 256, n_prefixes: int = 4, zipf_a: float = 1.3,
               burst_rate: float = 0.6, burst_mean: float = 2.0,
               prefix_pages=(1, 2), suffix_lens=(3, 6, 11),
               max_new=(3, 5), inversion_every: int = 6,
               deadline_frac: float = 0.0, deadline_slack=(4, 8),
               overload_at: int | None = None,
               overload_n: int = 0) -> list[TraceRequest]:
    """Deterministic heavy-traffic trace: list of `TraceRequest`, sorted by
    (arrival, req_id). See the module docstring for what each knob shapes.

    Degradation scenario knobs (docs/resilience.md; off by default, and
    when off they draw NOTHING from the generator, so pre-existing traces
    stay bit-identical):

    * `deadline_frac` — that fraction of requests (seeded draw) carries an
      admission deadline of `rng.choice(deadline_slack)` ticks; the engine
      drops expired requests (`deadline_expired`).
    * `overload_at` / `overload_n` — a seeded burst of `overload_n`
      LOW-priority (band 2) requests all arriving at tick `overload_at`,
      sized to push the backlog past a shedding engine's threshold (the
      `shed` counter's workload).
    """
    rng = np.random.default_rng(seed)
    # page-aligned shared-prefix pool (token blocks the prefix cache keys)
    longest = max(prefix_pages)
    pool = rng.integers(1, vocab, (n_prefixes, longest * page_size),
                        dtype=np.int64).astype(np.int32)
    # bounded Zipf popularity over pool ranks
    p = 1.0 / np.arange(1, n_prefixes + 1, dtype=np.float64) ** zipf_a
    p /= p.sum()

    out: list[TraceRequest] = []
    tick = 0
    rid = 0
    while rid < n_requests:
        # burst of arrivals at this tick
        burst = 1 + int(rng.poisson(burst_mean))
        inversion = any((rid + j + 1) % inversion_every == 0
                        for j in range(min(burst, n_requests - rid)))
        for j in range(burst):
            if rid >= n_requests:
                break
            urgent = (rid + 1) % inversion_every == 0
            pref = int(rng.choice(n_prefixes, p=p))
            npages = int(rng.choice(prefix_pages))
            suffix = int(rng.choice(suffix_lens))
            if inversion and urgent:
                prio, npages, suffix = 0, min(prefix_pages), min(suffix_lens)
            elif inversion:
                prio, npages, suffix = 2, max(prefix_pages), max(suffix_lens)
            else:
                prio = int(rng.choice((1, 2)))
            prompt = np.concatenate([
                pool[pref, :npages * page_size],
                rng.integers(1, vocab, suffix, dtype=np.int64).astype(np.int32),
            ])
            dl = -1
            if deadline_frac > 0.0 and rng.random() < deadline_frac:
                dl = int(rng.choice(deadline_slack))
            out.append(TraceRequest(req_id=rid, arrival=tick, prompt=prompt,
                                    max_new=int(rng.choice(max_new)),
                                    priority=prio, deadline=dl))
            rid += 1
        tick += 1 + int(rng.geometric(burst_rate))
    if overload_n > 0:
        # seeded low-priority flood at one tick: enough simultaneous band-2
        # arrivals to trip a shedding engine's backlog threshold
        at = overload_at if overload_at is not None else 0
        for j in range(overload_n):
            suffix = int(rng.choice(suffix_lens))
            prompt = rng.integers(1, vocab, suffix,
                                  dtype=np.int64).astype(np.int32)
            out.append(TraceRequest(req_id=rid, arrival=at, prompt=prompt,
                                    max_new=int(rng.choice(max_new)),
                                    priority=2))
            rid += 1
    return sorted(out, key=lambda r: (r.arrival, r.req_id))


def ticks(engine, trace: list[TraceRequest], max_steps: int = 256):
    """`replay`'s tick loop as a generator: each tick submits the arrivals
    due by that tick, runs one engine step and yields the tick's number;
    it stops once every request finished (or after `max_steps` ticks). A
    caller may run code between ticks (a profiler window, say)."""
    from repro_torch.serving.engine import Request

    i, t = 0, 0
    while t < max_steps:
        while i < len(trace) and trace[i].arrival <= t:
            r = trace[i]
            engine.submit(Request(req_id=r.req_id, prompt=r.prompt,
                                  max_new=r.max_new, priority=r.priority,
                                  deadline=r.deadline))
            i += 1
        engine.step()
        yield t
        t += 1
        if i >= len(trace) and all(r.done for r in engine.requests.values()):
            break


def replay(engine, trace: list[TraceRequest], max_steps: int = 256) -> dict:
    """Drive a `repro_torch.serving.engine.Engine` through a trace: each tick submits
    the arrivals due by that tick, then runs one engine step. Returns
    {req_id: output tokens} once every request finished (or `max_steps`
    ticks elapsed). Deterministic: the same (engine config, trace) pair
    produces the same outputs — the seeded-replay e2e contract."""
    for _ in ticks(engine, trace, max_steps):
        pass
    return {r.req_id: list(r.out) for r in engine.requests.values()}
