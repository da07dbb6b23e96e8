#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (the KV store, the LLM serving engine,
hymba-1.5b's prefill and decode, the sharded store, training, the MoE
family's serving, xlstm-1.3b's and minicpm3-4b's prefill and decode, the
dense archs' serving, llava's frontend prefix and musicgen's codebooks,
pod-compressed training and the pipeline, hymba-1.5b's training through
the selective scan's backward kernel, and the launchers) on one GPU and
check it.

    python3 chip_smoke.py [--seed 0]

Phases (each prints its seconds; any failed check raises, so the exit code
is non-zero and no result line is printed):

1. Device and build: require CUDA, print the card's name and power limit
   (`nvidia-smi`), build the eleven CUDA kernels from
   `src/repro_torch/kernels/csrc/` (one `nvcc` per source, in parallel).
   TF32 is off.
2. Kernels: first the edge sweep of the shared level walk: skiplist_search,
   pq_pop, tier_find and tier_apply in the level layout (tier_find also
   in the block layout, at every team width of each), bit for bit
   against their plain versions on skiplists of
   16, 100 and 4,096 cells (empty, 3/4 full, every key tombstoned) at 1,
   33 and 4,097 lanes (queries 0, 2^64 - 2, KEY_INF and past the last
   key). Then the edge sweeps of the four kernels a team runs, bit for
   bit: tier_find in both layouts at 1, 777 and 4,096 lanes and at the
   widest plan of every team width its rule picks, with no spill tier,
   a spill tier of empty runs, one run and 64 runs (a run of one cell, a
   run of tombstones), on a warm tier with a ragged last node;
   bskiplist_walk on the walk's edge states at 1, 33 and 4,097 lanes and
   at the widest plan of every team width its rule picks; hash_probe
   (rows of 16 and 5 columns: hits at the first and last columns, a key
   held twice, full and empty rows, slots below 0 and past M - 1, KEY_INF
   queries) and splitorder_probe (rows of 512 and 300 cells: queries
   below and above every rk, the full and the empty table, tables -1 and
   T, the 5-cell collision run, KEY_INF rk, windows that clip at C2 - 1)
   at 1, 33 and 4,097 lanes and the widest plan of every width their
   rules pick, each under its rule and forced to every width;
   tier_apply in both layouts under none / lru / size at 1, 777 and
   65,536 lanes (mixed keys, every lane in one slot, key and slot runs
   across the scan's tiles), eviction caps 0, 1 and K, with no spill
   tier, a spill tier of empty runs, one run and 64 runs (a run of one
   cell, a run of tombstones); pq_pop on heaps of 1,000 and 70,000 cells
   (nearly full, a head tombstone run over many chunks, all tombstoned)
   with no lane masked in, ranks -1, want_max in the first or the last
   chunk or at a chunk's end, and ranks past the live total, its
   published stop index held against the expected one; each sweep
   counts the cases that reach each boundary and requires them all.
   Then each kernel's wrapper on CUDA tensors at the main path's
   shapes, held bit for bit against its plain PyTorch version on the same
   inputs: skiplist_search and bskiplist_walk on the flat 2^24 skiplist;
   hash_probe; tier_find with and without spill and tier_apply under
   none / lru / size, with and without spill, at eviction caps 4,096 and
   64, each in both warm layouts (level-major and block-major), the block
   layout also held against the level layout; pq_pop on a 2^24 heap with
   a tombstone run at its head, on a plan's pop ranks and on ranks past
   the live total; splitorder_probe on a two-level split-order table of
   8 x 2^21 cells (one table full, one empty, an injected rk collision
   run); paged_attention at the served decode shapes (qwen3-1.7b's heads,
   32 requests, pages of 16, 128 pages a request, lengths 1..2,048, edge
   rows) in f32 (within 2e-5) and bf16 (within 3e-2, and elementwise
   within half a bf16 step of |plain| + 2e-5), beside planted faults of
   the plain version that must break that elementwise limit (the last
   token below each length dropped, a -1 page read as page 0, a token at
   a split boundary counted twice), edge rows for the split-KV merge (a
   split that owns no live page, a length-0 request that must give
   zeros) and every G and D the kernel is built for at a small shape, timed
   beside SDPA on gathered K/V. Median time per call from CUDA events,
   the plain version's time, a library call's time where one computes
   the same function
   (`torch.searchsorted`; grouped by table for splitorder_probe, where it
   gives the position only; SDPA for the two attentions), the whole
   `gpu` dispatch's time (kernel plus glue) and the
   bound: the distinct 32-byte sectors the kernel's work needs, found by
   replaying each probe on this run's data, plus each per-lane input and
   output once, over the HBM rate (a block walk is replayed as a binary
   search of each sorted 128-key node, and a block-layout row's bound is
   at most the level layout's on the same state and queries; the two
   float kernels: flops or exps over the card's peak, or bytes).
   flash_attention in f32 mode at (2, 256, 8, 64), G = 1/2/4/8 causal
   and full, within 5e-6 of the oracle's twin; in `xla_flash` mode at
   ragged tiles after 129 cached keys with a window of 37 (f32 at D 64,
   bf16 at D 128) against the plain mirror at its tiles, and in bf16
   `xla_flash` mode at hymba's served prefill (B 8, S 4,096, H 25, Hkv 5,
   D 64), window 0 and 2,048, against the mirror at the kernel's 64-key
   tiles and at the reference's 512: at most FLASH_OFF_SHARE of the
   outputs beyond a per-element bound (`flash_off`), beside planted
   faults of the mirror (a key too many or too few at the window or
   causal edge, the last ragged key dropped) that must exceed it; SDPA
   timed beside. selective_scan at
   tests/test_kernels.py's shapes within 2e-5 of the step-by-step plain
   scan, and so at every N it is built for and every lane split
   `scan_geometry` can give it, at ragged D and S, S 1, from h0 = None
   and a nonzero h0 and with unaligned operands, beside a planted fault
   (h0 ignored) that must break that limit; at hymba's
   prefill (8, 4,096, 3,200, 16) and decode (8, 1, 3,200, 16) shapes from
   a nonzero h0 within 1e-4 of max |y| and |h| of the chunked plain scan,
   timed at both shapes, the decode time beside its own bound; its bf16
   scan (`ssm_scan_dtype`) at both shapes within 2e-2 + 2e-2 |plain| of
   the plain bf16 scan. The scan's backward against the step-by-step
   plain backward within 1e-4 of each gradient's largest |value| at every
   N, S 1 / 45 / 100, ragged D (one to three clusters, blocks past D), a
   nonzero h0 and dh_last, exp(dt A) underflowing (every 7th step, and
   at the 16-step window boundaries on and off the 32-step chunk grid),
   every cluster size at D 300, then at one training microbatch (2 x
   4,096 x 3,200 x 16); every case bit for bit on a second run, beside a
   planted fault (the carry dropped at a chunk boundary, and at a window
   boundary off the chunk grid); timed beside its plain
   version and its bound; the saving forward (its chunk states too)
   against the plain chunked scan window by window at that microbatch,
   timed. paged_attention at the reduced configs' heads (D 16, G 2) over
   the served batch's tables, f32 and bf16, timed.
   tier_apply and tier_find are also timed at every plan width of the
   main path (4,096-lane workload and 65,536-lane preload plans, both
   layouts, tier_apply with and without spill; the serving prefix
   cache's 9- and 64-lane plans on a 1,024-cell stack with spill), pq_pop
   at its three shapes (a pq workload plan, a preload plan with no pop
   lane, a served pop plan on the scheduler's 1,024-entry heap), and
   skiplist_search, bskiplist_walk, hash_probe and splitorder_probe at
   4,096 and 65,536 lanes beside their library calls, each launch apart
   (`split_ms`), beside each shape's bound, skiplist_search at the
   served pq plans' 1 and 4 lanes on that heap, and skiplist_search,
   tier_find and tier_apply at phase 6's shape, a pool of 8,192 lanes on
   one shard (a 65,536-key skiplist, a 32,768-key tiered3 stack with
   spill runs; `shard_shapes`) (`shapes_only` runs these
   timings alone, on whichever port `repro_torch` imports; `widths_only`
   times hash_probe and splitorder_probe at every team width).
3. Main path: `paper_kvstore`'s per-chip store (capacity 65,536, 4,096
   lanes) across the 256 chips of its 16x16 mesh folded onto one card,
   i.e. capacity 2^24. A seeded stream — a preload of 0.75 * 2^24 fresh
   keys in plans of 65,536 lanes, then 16 plans of Workload 1 (10% insert /
   90% find) and 16 of Workload 2 (plus 2% erase), 4,096 lanes each —
   runs through `StoreEngine` for det_skiplist (2^24), hash+skiplist
   (2^24), tiered3/lru and tiered3/b128 (2^23: hot + 2^23 warm + 2^23
   spill, so the spill runs, the lru victims and the block walk's three
   index rows are live), the unfused twin of tiered3/b128 (gpu only; its
   warm probe is the bskiplist_walk kernel) and fixed_hash (2^24), in
   exec modes `gpu` and `torch`. gpu == torch per plan and on the final
   state; every ordered cell == det_skiplist == a host dict oracle per
   plan; the unfused twin's final state == tiered3/b128's (fixed_hash
   drops inserts on full buckets: gpu vs torch only). Then rand_skiplist,
   twolevel_hash and splitorder (2^24, exec mode `gpu` only: the
   reference runs no kernel for them, and they must launch none) and
   twolevel_splitorder (2^24, both modes, the splitorder_probe kernel),
   each == the dict oracle == det_skiplist per plan; rand_skiplist's FIND
   may miss a stored key as the reference's walk does (ROADMAP.md §4):
   each such lane is counted and checked to be a stored, live key. Then
   the `pq` cell, the serving scheduler's admission queue at capacity
   2^24 on its own stream (`make_pq_stream`) against a host oracle of per-band FIFOs.
   Each cell's kernel launch counts are set to 0 just before it and read
   just after; every cell must launch its kernels (tiered3/b128 the
   block layout of tier_find and tier_apply and never the level layout;
   the three kernel-less cells none), and tier_apply and pq_pop make one
   call of 2 launches on every plan, counted by plan width.
4. Serving: qwen3-1.7b at full width and depth (seeded f32 parameters,
   bf16 compute) behind `serving.engine.Engine` (32 slots, 4,096 pages of
   16 tokens) on `serving.traffic.make_trace` (64 requests, seed 0),
   driven by `replay` in exec mode gpu. Every request finishes with its
   `max_new` tokens, the pool ends free, prefix hits > 0, the scheduler
   pops 64, the metrics keys are `SERVING_SCHEMA`, paged_attention
   launches == decode steps x 28 (counts set to 0 just before the run);
   check (b): the first 8 decode steps' logits against the plain
   attention's on the same state, within 4 bf16 steps of the largest
   |logit|, beside planted faults of the plain attention (a page skipped
   and the new token left out must exceed that bound); check (a): f32 compute, 4 trace prompts
   x 16 tokens, each engine token the contiguous `prefill` +
   `decode_step`'s argmax unless its top-2 margin is below 1e-3. Then the
   fault path: the same trace on a new engine with a `FaultPlan` that
   drops the scheduler's store at engine steps 2, 40 and 120; the
   journaled scheduler recovers each, and every request's tokens equal
   the fault-free run's. Prints decode tokens/s, ms per decode step,
   prefill tokens/s, batch fill and the prefix hit rate.
5. hymba: hymba-1.5b at full width and depth (32 layers, seeded f32
   parameters and a bf16 copy, attn_impl "xla_flash", exec mode gpu):
   8 prompts of 4,096 tokens prefilled, then 32 greedy decode steps;
   flash_attention launches == 32 and selective_scan == 32 x 33 (counts
   set to 0 just before); prints prefill and decode tokens/s, ms per
   decode step and the peak memory. Check (b): bf16, the prefill's last
   logits and the first 8 decode steps against exec mode torch on the
   same state, per lane in bf16 steps (every lane within 16, the median
   decode lane within 2), beside planted faults of the plain path (the
   window ignored, the SSM or conv state reset) that must exceed the
   bounds at every step; check (a): f32, 2 prompts, the caches after
   prefill against the torch-mode prefill's (a limit per cache, which
   the torch-mode prefill one token short must exceed) and every gpu
   token the argmax of a torch-mode teacher-forced `forward` unless its top-2
   margin is below 1e-3. Then 8 prompts of 1,024 tokens and 8 decode
   steps with `kv_cache_dtype` float8_e4m3fn beside bfloat16, teacher-
   forced alike: the k / v bytes (half), ms a step and the logits' max
   distance from the bf16 cache's (within 0.11 of the largest |logit|)
   and from a bf16 cache holding the values rounded to fp8 (within
   1e-3), both of which a planted fault (each decode step's fp8 entry
   left unwritten) must exceed.
6. The sharded store (paper §VI): the production single-pod mesh (16, 16)
   ("data", "model") folded onto the card, `paper_kvstore`'s 65,536 keys
   and 4,096 lanes a shard (2^20 lanes a step), pool factor 2, through
   `store.engine.StoreEngine`: 3 preload steps of fresh inserts in exec
   mode gpu, then one Workload 1 and one Workload 2 step in modes gpu
   and torch (the torch engine from the gpu state after the preload:
   the per-shard loop is host-bound, so this keeps the script inside its
   limit), keys uniform over u64. det_skiplist (2^24 keys in all) and
   obs:tiered3/lru (8,192 a shard, so the preload spills): no lane
   dropped at any step, gpu == torch on the workload steps and the final
   states, every lane == a dict oracle (run in a worker process), the
   summed sizes == the oracle's live count; shards
   0, 17 and 255 rebuilt from the init snapshot over the whole journal
   (`resilience.rebuild_shard`) equal the engine's. The route and route
   back timed apart; the range step over det_skiplist (64 valid ranges a
   shard) == `np.searchsorted` over the oracle's live keys. Then
   `ResilientEngine` over obs:tiered3/lru on the workload steps from the
   post-preload state, a snapshot every 4 steps: in sync mode with two
   shard drops, a poisoned lane and a stall the results, the final
   `state_digest` and the per-shard metrics equal the tier cell's own
   (fault-free) run's; in degraded mode with a shard drop the healthy
   lanes and the deferred lanes' completions equal it. Prints ms a step by backend and mode,
   launches a step, the syncs of a workload step (torch's sync debug
   mode), the snapshot's ms and bytes and the recoveries' ms.
7. Training: qwen3-1.7b at full width and depth (28 layers, seeded f32
   parameters and AdamW moments, bf16 compute, remat, attn_impl "xla":
   the reference's train configuration) through `train.loop.train` with
   its `PrefetchPipeline` on the card: `SHAPES["train_4k"]` with the
   global batch cut from 256 to 8 (8 x 4,096 tokens a step, 4
   microbatches of two sequences), 4 steps. Launch counts are set to 0
   just before and must stay 0 (the reference trains through its plain
   attention, so the path reaches no kernel). Checks: finite losses and
   grad norms, step 0's loss within 0.5 of ln(vocab), the parameters
   moved, AdamW's step is 4, the pipeline delivered steps 0-3 from its
   prefetch (no straggler skip), the ring queue's pushed == popped and
   every block-pool block free. Then the restart check at full width and
   2 layers: 4 uninterrupted steps against 2 steps with a synchronous
   checkpoint and a resumed run to step 4, the resumed losses bit-equal
   under deterministic algorithms (set inside the check only; an op with
   no deterministic form is recorded and the losses held within
   TRAIN_NONDET_RTOL), in a temporary directory it removes; then one
   f32 train step at 2 layers on a 512-token sequence on the card and on
   the CPU: loss within 1e-5 and grad norm within 1e-4 relative. Prints
   ms a step (steps 1 on), tokens/s, peak GiB beside the memory
   reckoning, `pipe.get` ms a step, checkpoint save and restore s and
   MB/s.
8. MoE serving: llama4-scout-17b-a16e and then qwen3-moe-235b-a22b at
   full width (d_model, heads, experts, d_expert and vocab as published)
   and depth cut to 3 layers (seeded f32 parameters and a bf16 copy,
   ~52 GB each), one after the other with the card freed between them,
   behind `Engine` (16 slots, 1,024 pages of 16 tokens) on phase 4's
   trace cut to 16 requests, in exec mode gpu with the config's own
   `moe_impl` (no mesh open: the dense dispatch). The checks of phase 4
   (every request, the pool, pops, paged_attention launches == decode
   steps x 3, the kernels of the scheduler and the prefix cache); check
   (b) on the first 4 decode steps with its planted faults, a lane whose
   experts differ between the plain and the gpu attention left out only
   at a near tie of the router (margin below MOE_ROUTE_MARGIN) and
   counted; check (a) in f32 on 2 prompts x 8 tokens. The paper's routing
   at full width: layer 0's FFN input of the first prefill folded onto a
   (1, 16) ("data", "model") mesh; replicated_psum drops the dense
   dispatch's lanes and gives its output, routed_a2a gives it on every
   token neither dropped a lane of, within 2 bf16 steps of max |y|; a
   planted fault (the most chosen expert's bucket on the wrong shard)
   must break that bound. Prints decode tokens/s, ms per decode step,
   prefill tokens/s, each dispatch's dropped lanes and FFN ms a layer,
   and the peak GiB beside the weights; then paged_attention at each
   arch's decode shape (G 5 with 8 KV heads, G 16 with 4, D 128) in
   bf16 against its plain version, timed beside SDPA and its bound.
9. xLSTM: xlstm-1.3b at full width and depth (48 layers, 42 mLSTM + 6
   sLSTM blocks, 3.707 B seeded f32 parameters and a bf16 copy, counted
   against a reckoning from the reference's shapes), exec mode gpu: 8
   prompts of 4,096 tokens (`prefill_32k` cut to 8 sequences) prefilled
   at cache_len 4,128, then 32 greedy decode steps; launch counts set to
   0 just before and required to stay 0 (no kernel is on the path);
   finite logits, tokens inside the vocabulary, every cache leaf's shape
   and dtype as `init_caches` gives them, the decode state's bytes a
   sequence equal to their reckoning. Check (a): f32 at full width and
   one period of 8 layers, the same weights on the card and on the CPU,
   2 prompts x 512 tokens then 4 teacher-forced decode steps: logits and
   every cache leaf within a limit each (XLSTM_A_TOL) of max |CPU|;
   the planted fault (the mLSTM (C, n, m) zeroed before decode) must break
   the logits limit at every step. Check (b): f32 on the card at full
   depth, 2 prompts x 1,024 tokens and 8 greedy decode steps, each step's
   logits within XLSTM_B_TOL of a teacher-forced `forward` over prompt +
   generated tokens; the planted fault (the sLSTM state reset before
   decode) must exceed it at every step. Prints prefill and decode
   tokens/s, ms a step, peak GiB beside the weights and the state bytes.
10. MLA: minicpm3-4b the same way at full width and depth (62 layers,
   4.262 B parameters); check (a) at 2 layers on 2 prompts x 1,024 tokens
   (so MLA's 512-query chunk loop runs), its planted fault the cached
   rope keys roped one position late; check (b)'s bound allows for the
   bf16 latent cache, its planted fault the latent cache one position
   late; then the latent cache {ckv, kpe} in fp8 beside bf16, as phase 5.
11. Dense serving: qwen1.5-110b (4 of 80 layers, ~47.5 GB of f32
   weights and their bf16 copy), llama3-405b (2 of 126, ~63.5 GB) and
   llava-next-mistral-7b (all 32, ~43.5 GB, text only: the engine takes
   no prefix, as the reference's) at full width, one after the other,
   as phase 8 serves (16 slots, 1,024 pages, phase 4's trace cut to 16
   requests and drawn over the arch's own vocabulary; paged_attention
   launches == decode steps x layers; checks (b) and (a)); the
   parameters and the pool's K / V bytes held against a reckoning from
   the reference's shapes; then paged_attention at each decode shape,
   G 8, 16 and 4 over 8 KV heads, against its plain version, timed
   beside SDPA and its bound.
12. llava's frontend prefix, on phase 11's llava weights: `synth_batch`
   on `prefill_32k` cut to 8 sequences of 4,096 positions (1,152
   `prefix_embeds` rows + 2,944 tokens) through `make_serve_prefill`,
   then 32 `make_serve_decode` steps in exec mode gpu, no kernel launch
   allowed; caches and state bytes as in phases 9-10. Check (a): f32 at
   2 layers, 2 prompts of the prefix + 128 tokens, card vs CPU; check
   (b): f32 at full depth, 2 prompts of the prefix + 512 tokens and 8
   decode steps against a teacher-forced `forward` with the prefix, the
   prefix dropped and the prefix's positions one late as planted
   faults.
13. musicgen-medium at full width and depth (48 layers, 4 codebooks,
   1.837 B parameters) as phases 9-10: 8 x 4,096 frames, 32 decode
   steps, no launch; check (a) at 4 layers, its planted fault codebook
   0's embedding left out; check (b), the head's codebook slices rolled
   by one.
14. Pods and pipeline. (a) qwen3-1.7b at full width cut to 4 layers,
   phase 7's 8 x 4,096 tokens a step, on a (2, 4) ("pod", "data") mesh
   folded onto the card: 3 plain steps and 3 pod-compressed steps
   (`make_train_step(pod_compress=True)`, the int8 error-feedback
   exchange of `optim/compress.py`) from one seeded init. Each
   compressed step: the residuals equal g32 - q * scale bit for bit, the
   payloads are int8 and P x parameters + P scales a leaf in bytes,
   every leaf's exchanged mean within sum_p scale_p / (2P) (plus 4 f32
   ulps) of mean_p(g_p + r_p), and the planted fault (the sum over pods
   in place of the mean) must break that; losses within 5% of the plain
   ones; a 4th compressed step runs unrecorded for the peak without the
   checks' clones. Prints ms a step plain and compressed, the exchange's
   ms, the bytes exchanged against a bf16 psum's, peak GiB and each
   step's share of model FLOPs at the data sheet's 989 TFLOP/s. (b) The fill-drain
   `parallel/pipeline.py` over 4 stages of one full-width qwen3-1.7b
   dense block each (bf16, forward only), 8 microbatches of 1 x 4,096
   tokens: bit for bit the blocks applied in sequence; the planted fault
   (the stage shift skipped) must differ. Prints ms, ticks and the
   bubble share. No kernel of the port is on either path.
15. hymba-1.5b trained at full width and depth (32 layers, f32
   parameters and AdamW moments, bf16 compute, remat, attn_impl "xla")
   through `train()` in exec mode gpu: 4 x 4,096 tokens a step in 2
   microbatches, 3 steps; launches exactly selective_scan 2 x 32, all
   of them the saving forward (`selective_scan/save`), and
   selective_scan_bwd 32 a microbatch (remat runs the forward twice) and
   no other kernel; finite losses; prints ms a step, tokens/s and peak
   GiB. Step 1 at 4 layers on one 4,096-token sequence in exec modes gpu
   and torch from the same weights: loss within 1e-3 and gradient norm
   within 1e-2 (relative). Then `launch.serve` on the reduced
   qwen3-1.7b as it is (head_dim 16: paged_attention at D 16) and
   `launch.train` on the reduced hymba-1.5b, both on the card.
16. The calls by shape of the store kernels over phases 3-6, 8 and 11,
   a `kernels` JSON line (with phases 8 and 11's paged_attention rows and
   the reduced configs' D 16 row from the serve launcher, and the
   scan's saving forward from phase 15 (its launches taken out of the
   scan's row), each with its `shape`; the selective scan's backward
   beside the ten), then the last
   line `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import dataclasses
import functools
import gc
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OP_NONE, OP_FIND, OP_INSERT, OP_DELETE = -1, 0, 1, 2
OP_POPMIN, OP_POPK, OP_RANGE_DELETE = 4, 5, 6
DEV = "cuda"
LOG2_CAPACITY = 24          # the flat store's capacity, 2^24 (see above)
PRELOAD_LANES = 65536
WL_LANES = 4096
WL_PLANS = 16
# the pq cell (make_pq_stream): capacity 2^24, preloaded half full, band 0
# (urgent) 32,768 keys of the preload; workload plans of 2,048 inserts,
# 1,024 POPMIN and 1,024 POPK, plus 64 finds in the second workload
PQ_LOG2_CAPACITY = 24
PQ_URGENT = 32768
PQ_INSERTS = 2048
PQ_POPS = 1024
PQ_FINDS = 64
PQ_CANCEL_PLANS = (7, 15)   # the second workload's plans 8 and 16
INVERSION_EVERY = 6         # serving/traffic.py: every 6th request urgent
RID_BASE = 1 << 40          # request ids: RID_BASE + ticket
# (name, path of the CUDA source, file:line of the TPU kernel it replaces)
KERNELS = [
    ("skiplist_search", "src/repro_torch/kernels/csrc/skiplist_search.cu",
     "src/repro/kernels/skiplist_search/kernel.py:72"),
    ("hash_probe", "src/repro_torch/kernels/csrc/hash_probe.cu",
     "src/repro/kernels/hash_probe/kernel.py:47"),
    ("tier_find", "src/repro_torch/kernels/csrc/tier_find.cu",
     "src/repro/kernels/tier_find/kernel.py:136"),
    ("tier_apply", "src/repro_torch/kernels/csrc/tier_apply.cu",
     "src/repro/kernels/tier_apply/kernel.py:253"),
    ("bskiplist_walk", "src/repro_torch/kernels/csrc/bskiplist_walk.cu",
     "src/repro/kernels/bskiplist_walk/kernel.py:75"),
    ("pq_pop", "src/repro_torch/kernels/csrc/pq_pop.cu",
     "src/repro/kernels/pq_pop/kernel.py:63"),
    ("splitorder_probe", "src/repro_torch/kernels/csrc/splitorder_probe.cu",
     "src/repro/kernels/splitorder_probe/kernel.py:86"),
    ("paged_attention", "src/repro_torch/kernels/csrc/paged_attention.cu",
     "src/repro/kernels/paged_attention/kernel.py:67"),
    ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention/kernel.py:67"),
    ("selective_scan", "src/repro_torch/kernels/csrc/selective_scan.cu",
     "src/repro/kernels/selective_scan/kernel.py:55"),
    # the scan's backward: the reference differentiates its plain chunked
    # scan (src/repro/models/ssm.py:100-117); the TPU kernel it sits beside
    ("selective_scan_bwd",
     "src/repro_torch/kernels/csrc/selective_scan_bwd.cu",
     "src/repro/kernels/selective_scan/kernel.py:55"),
]
BOTH = ("gpu", "torch")
# the main path's cells on make_stream: (label, backend, capacity shift,
# exec modes, launch counts that must be > 0 in the cell); the unfused
# twin of tiered3/b128 is built by `tiers.unfused_twin`
MAIN_CELLS = [
    ("det_skiplist", "det_skiplist", 0, BOTH, ("skiplist_search",)),
    ("hash+skiplist", "hash+skiplist", 0, BOTH,
     ("tier_find/level", "tier_apply/level")),
    ("tiered3/lru", "tiered3/lru", 1, BOTH,
     ("tier_find/level", "tier_apply/level")),
    ("tiered3/b128", "tiered3/b128", 1, BOTH,
     ("tier_find/block", "tier_apply/block")),
    ("tiered3/b128 unfused", "tiered3/b128", 1, ("gpu",),
     ("bskiplist_walk", "hash_probe")),
    ("fixed_hash", "fixed_hash", 0, BOTH, ("hash_probe",)),
    # the reference runs no kernel for these three: gpu mode only, and
    # they must launch none
    ("rand_skiplist", "rand_skiplist", 0, ("gpu",), ()),
    ("twolevel_hash", "twolevel_hash", 0, ("gpu",), ()),
    ("splitorder", "splitorder", 0, ("gpu",), ()),
    ("twolevel_splitorder", "twolevel_splitorder", 0, BOTH,
     ("splitorder_probe",)),
]
PQ_KERNELS = ("pq_pop", "skiplist_search")
# the serving phase: qwen3-1.7b at full width and depth behind `Engine`
# (32 request slots, 4,096 pool pages of 16 tokens, 128 pages a request),
# driven by `serving.traffic.make_trace` (64 requests, prompts of 144 to
# 1,024 tokens over Zipf-shared 128- to 512-token prefixes, bursty
# arrivals, every 6th request urgent)
SERVE_ARCH = "qwen3-1.7b"
SERVE_BATCH = 32
SERVE_NUM_PAGES = 4096
SERVE_PAGE = 16
SERVE_PAGES_PER_REQ = 128
SERVE_TRACE = dict(n_requests=64, page_size=SERVE_PAGE, vocab=151936,
                   n_prefixes=8, prefix_pages=(8, 16, 32),
                   suffix_lens=(16, 128, 512), max_new=(32, 64),
                   inversion_every=6)
SERVE_MAX_TICKS = 2000
# the fault path: the same trace again with the scheduler's store dropped
# at these engine steps (`Engine(fault_plan=...)`), tokens == fault-free
SERVE_FAULT_STEPS = (2, 40, 120)
# kernels the served run must launch: the decode attention, the
# scheduler's pq pop and the prefix cache's fused tier probes
SERVE_KERNELS = ("paged_attention", "pq_pop", "tier_find/level",
                 "tier_apply/level")
# check (b): the first 8 bf16 decode steps, gpu vs plain attention. The
# logits come out of a bf16 matmul, so they are bf16 values: the bound is
# 4 bf16 steps at the step's largest |logit| (2^-5 = 3.1e-2 a step for
# logits of 4 to 8). The two attentions differ only in the order of their
# f32 sums; 28 bf16 layers turn that into a few steps at the head (2.6
# at most on the H100, PERF.md). The same steps also run planted faults
# of the plain attention (SERVE_B_FAULTS) at the same state, to show
# what the bound lets through: the two structural ones must exceed it at
# every step
SERVE_B_STEPS = 8
SERVE_B_ULPS = 4
SERVE_B_FAULTS = ("page skipped", "own token left out", "bf16 attention")
SERVE_B_MUST_FAIL = ("page skipped", "own token left out")
# check (a): f32 compute, 4 trace prompts x 16 new tokens vs the
# contiguous prefill + decode_step; steps with a top-2 margin below 1e-3
# are counted, not compared
SERVE_A_PROMPTS = 4
SERVE_A_NEW = 16
SERVE_A_MARGIN = 1e-3
SERVE_A_PAGES = 320
# phase 5: hymba-1.5b at full width and depth (32 layers, d_model 1,600)
# with attn_impl "xla_flash": 8 prompts of 4,096 tokens prefilled at once,
# then 32 greedy decode steps on the contiguous caches (cache_len 4,128);
# the repo's prefill_32k shape (32 x 32,768) cut to 8 x 4,096 so the plain
# path and the f32 check fit one run, while the 2,048 window still binds
# on the 29 windowed layers
HYMBA_ARCH = "hymba-1.5b"
HYMBA_BATCH = 8
HYMBA_PROMPT = 4096
HYMBA_NEW = 32
# check (b): bf16, gpu vs torch mode on the same state, the prefill's last
# logits and the first 8 decode steps' logits, per lane in bf16 steps at
# the lane's largest plain |logit| (the logits come out of a bf16 matmul).
# Every lane within HYMBA_B_MAX_ULPS at every step, and at decode steps
# the median lane within HYMBA_B_MEDIAN_ULPS: decode runs the same
# arithmetic in both modes but for the scan's f32 summation order, so a
# lane agrees exactly unless an f32 difference tips a bf16 rounding tie,
# which then spreads through the bf16 layers of that lane alone (4.5
# steps at most on the H100, one lane at a time); the prefill's flash
# tiles (64 keys against the plain path's 512) round p at other points in
# every lane (5.75-7 steps). Planted faults of the plain path on the same
# state must exceed the bounds at every step they apply to: the window
# ignored (prefill and decode), the SSM or the conv state reset to zero
# (decode). The bounds were set from those readings (PERF.md)
HYMBA_B_STEPS = 8
HYMBA_B_MAX_ULPS = 16
HYMBA_B_MEDIAN_ULPS = 2
HYMBA_FAULTS = ("window ignored", "ssm state reset", "conv state reset")
# check (a): f32 compute, 2 prompts, the gpu-mode tokens against the
# torch-mode teacher-forced forward; steps with a top-2 margin below 1e-3
# are counted, not compared. The caches after prefill: gpu vs torch within
# HYMBA_A_CACHE_TOL[name] of the largest |plain| of each cache, about 4x
# the readings on the H100 (k 5.3e-3, v 5.5e-3: bf16 p rounded at other
# tiles upstream; conv 1.2e-3, ssm 1.1e-3). A planted fault, the plain
# prefill one token short (every cache one step early), must exceed each
HYMBA_A_PROMPTS = 2
HYMBA_A_MARGIN = 1e-3
HYMBA_A_CACHE_TOL = {"k": 2e-2, "v": 2e-2, "conv": 5e-3, "ssm": 5e-3}
# phase 6, the sharded store: the production single-pod mesh
# (`launch/mesh.py`: (16, 16) ("data", "model")) folded onto one card, a
# `paper_kvstore` store of 65,536 keys and 4,096 lanes a shard, pool
# factor 2; 3 preload steps of 2^20 fresh inserts (0.1875 * 2^24 keys,
# 12,288 a shard: the tier cell's 8,192 a shard spill ~4,096 a shard, as
# 32,768 did after 9 steps), then SHARD_WL_STEPS steps of Workload 1 and
# of Workload 2 at 2^20 lanes. The per-shard loop is host-bound: 2.2-4.5
# s a step over det_skiplist and 10-20 s over tiered3/lru in mode gpu,
# 2.6-4.7 and 12-23 s in mode torch, on the H100 machines' hosts (PERF.md
# §6); this phase took 350-547 s with 12 preload steps and 440 s with 9
# on a slow host, where the whole script took 1,195 s of its 1,200. So
# the preload runs in mode gpu only, its depth is cut from 12 steps to 3
# with the tier cell's capacity cut from 32,768 to 8,192 a shard, the
# torch engine starts from its end state, and one step of each workload
# runs (not 4): the script stays inside its time limit on the slower
# hosts
SHARD_AXES = ("data", "model")
SHARD_SIZES = (16, 16)
SHARD_CAP = 65536
SHARD_LANES = 4096
SHARD_POOL_FACTOR = 2
SHARD_PRELOAD_STEPS = 3
SHARD_WL_STEPS = 1
SHARD_TIER_CAP = 8192       # tiered3/lru a shard: the preload spills
# the tier cell runs observed: its workload steps are the fault-free run
# the resilience checks compare with
SHARD_CELLS = (("det_skiplist", SHARD_CAP, ("skiplist_search",)),
               ("obs:tiered3/lru", SHARD_TIER_CAP,
                ("tier_find/level", "tier_apply/level")))
SHARD_RESIDENCY = (0, 17, 255)
SHARD_RANGES = 64           # valid range lanes a shard
SHARD_RANGE_MAX_OUT = 8
SHARD_SNAPSHOT_EVERY = 4
SHARD_SYNC_DROPS = ((1, 17), (1, 200))   # (workload step, shard)
SHARD_DEGRADED_DROP = (1, 99)
SIGN = -(1 << 63)           # u64 order = signed order of x ^ SIGN
INF_ORDERED = (1 << 63) - 1  # KEY_INF in that order
SECTOR = 32                 # bytes: the smallest HBM transfer
# NVIDIA H100 SXM5 80 GB data sheet: HBM3 rate, and the float32 rate
# outside the tensor cores (the rate a key compare runs at, at most)
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
# the same data sheet's dense bf16 tensor-core rate; and the SFU's rate of
# f32 exps: 16 a clock per SM (CUDA C++ Programming Guide, throughput of
# 32-bit transcendentals at compute capability 9.0) x 132 SMs x the
# 1,980 MHz boost clock
BF16_TENSOR_OPS_PER_S = 989e12
# flash_attention in xla_flash mode against its plain version (the mirror
# at the kernel's 64-key tiles or the reference's 512): per output,
# |kernel - plain| <= 2^-7 * (o_abs + |plain|) + 1e-6, o_abs the mirror's
# output on |v|. f32 noise that tips a p across a bf16 rounding tie moves
# the output by one ulp of p, at most 2^-7 p |v| / l (all tipped keys of a
# row together at most 2^-7 o_abs); two bf16 outputs round apart by at
# most 2^-7 |o|. At most FLASH_OFF_SHARE of the outputs may exceed it,
# and planted faults of the mirror on the same inputs (a key too many or
# too few at the window or causal edge, the last ragged key dropped) must
# exceed that share (PERF.md)
FLASH_OFF_SHARE = 1e-6
EXP_PER_S = 16 * 132 * 1.98e9


@functools.lru_cache(maxsize=None)
def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader` gives them (first card)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, "nvidia-smi")
    return smi.stdout.strip().splitlines()[0]


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def phase(name: str):
    t0 = time.perf_counter()
    print(f"== phase {name}", flush=True)
    return lambda: print(f"== phase {name}: {time.perf_counter() - t0:.3f} s",
                         flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def median_ms(torch, fn, reps: int = 15) -> float:
    """Median device time of one call of `fn`, from CUDA events. A sleep
    kernel ahead of each call keeps the device busy while the host
    enqueues, so the events bracket the call's own device work."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


class Reads:
    """The cells a probe reads, per buffer, gathered by the replays below
    for the bound. HBM moves whole 32-byte sectors, so a buffer's bytes
    are its DISTINCT sectors read: a cell that many queries share (the
    upper index levels, the first midpoints of a run's binary search)
    counts once. `n` counts cell reads, one key compare each."""

    def __init__(self):
        self.cells = {}
        self.n = 0

    def add(self, buf: str, size: int, idx, mask=None) -> None:
        idx = idx.reshape(-1) if mask is None else idx[mask]
        self.cells.setdefault(buf, (size, []))[1].append(idx.long())
        self.n += idx.numel()

    def sector_bytes(self, torch) -> int:
        return sum(SECTOR * torch.unique(torch.cat(parts) * size // SECTOR)
                   .numel() for size, parts in self.cells.values())


def bound(torch, reads: Reads, stream_bytes: int):
    """(bound_ms, bound_by): the larger of the bytes time (the distinct
    sectors the probes read, plus each per-lane input read once and each
    output written once) over the HBM rate, and the operations time (one
    compare per cell read) over the non-tensor-core rate."""
    t_bytes = (reads.sector_bytes(torch) + stream_bytes) / HBM_BYTES_PER_S
    t_ops = reads.n / OPS_PER_S
    return ((t_bytes * 1e3, "bytes") if t_bytes >= t_ops
            else (t_ops * 1e3, "operations"))


def walk_reads(torch, reads: Reads, q, lay):
    """Replay of `level_walk` (csrc/probe.cuh) on the flat level view,
    recording each cell it reads: per step the child start and the keys
    up to the first with q <= key (all four when none is; a read past a
    level's capacity is padding and reads nothing), then the terminal key
    and, on a key match, its mark. Returns (found int8, idx int32) so the
    replay is held against the kernel."""
    off, c1, L = lay.offsets, lay.c1, lay.num_levels
    cap = lay.term_keys.numel()
    fan = torch.arange(4, device=q.device)
    qo = (q ^ SIGN)[:, None]

    def first_le(keys):
        le = qo <= keys
        sel = le.to(torch.uint8).argmax(1)
        n = torch.where(le.any(1), sel + 1, 4)
        return sel, fan[None, :] < n[:, None]

    top = (off[L - 1] + fan).expand(q.numel(), 4)
    i, rd = first_le(lay.lvl_keys[top] ^ SIGN)
    reads.add("lvl_keys", 8, top, rd)
    for r in range(L - 1, -1, -1):
        ic = i.clamp(0, c1 - 1)
        cap_r = off[r + 1] - off[r]
        has = ic < cap_r
        at = off[r] + ic.clamp(max=cap_r - 1)
        reads.add("lvl_child", 4, at, has)
        start = torch.where(has, lay.lvl_child[at].long(), 0)
        if r == 0:
            pos = (start[:, None] + fan).clamp(0, cap - 1)
            sel, rd = first_le(lay.term_keys[pos] ^ SIGN)
            reads.add("term_keys", 8, pos, rd)
        else:
            pos = (start[:, None] + fan).clamp(0, c1 - 1)
            cap_b = off[r] - off[r - 1]
            inb = pos < cap_b
            at = off[r - 1] + pos.clamp(max=cap_b - 1)
            sel, rd = first_le(torch.where(inb, lay.lvl_keys[at] ^ SIGN,
                                           INF_ORDERED))
            reads.add("lvl_keys", 8, at, rd & inb)
        i = start + sel
    i = i.clamp(0, cap - 1)
    reads.add("term_keys", 8, i)
    hit = lay.term_keys[i] == q
    reads.add("term_mark", 1, i, hit)
    return ((hit & (lay.term_mark[i] == 0)).to(torch.int8),
            i.to(torch.int32))


def bucket_reads(torch, reads: Reads, q, slots, keys, whole_row: bool):
    """Replay of `bucket_probe`: the row's keys up to the first hit, the
    whole row on a miss or when `whole_row` (tier_apply reads the row
    again for its empty cells). Returns (found int8, col int32)."""
    m, b = keys.shape
    row = slots.long().clamp(0, m - 1)
    cols = torch.arange(b, device=q.device)
    eq = keys[row] == q[:, None]
    hit = eq.any(1)
    col = torch.where(hit, eq.to(torch.uint8).argmax(1), 0)
    rd = None if whole_row else cols[None, :] <= torch.where(hit, col,
                                                             b)[:, None]
    reads.add("hot_keys", 8, row[:, None] * b + cols, rd)
    return hit.to(torch.int8), col.to(torch.int32)


def spill_reads(torch, reads: Reads, q, sp):
    """Replay of `spill_probe`: each run's binary search, in run order
    until the first live match, then the searched cell's key and, on a
    key match, its tombstone. Returns (found int8, cell int32)."""
    keys, dead = sp.keys, sp.dead
    s = keys.numel()
    off = sp.run_off.tolist()
    ko, qo = keys ^ SIGN, q ^ SIGN
    active = torch.ones(q.numel(), dtype=torch.bool, device=q.device)
    found = torch.zeros_like(active)
    cell = None
    for r in range(len(off) - 1):
        end = off[r + 1]
        lo = torch.full(q.shape, off[r], dtype=torch.long, device=q.device)
        hi = torch.full_like(lo, end)
        for _ in range(max(end - off[r], 1).bit_length()):
            cont = active & (lo < hi)
            mid = (lo + hi) >> 1
            reads.add("sp_keys", 8, mid, cont)
            less = ko[mid.clamp(max=s - 1)] < qo
            lo = torch.where(cont & less, mid + 1, lo)
            hi = torch.where(cont & ~less, mid, hi)
        pos = lo.clamp(0, s - 1)
        if cell is None:
            cell = pos
        chk = active & (lo < end)
        reads.add("sp_keys", 8, pos, chk)
        eq = chk & (keys[pos] == q)
        reads.add("sp_dead", 1, pos, eq)
        live = eq & (dead[pos] == 0)
        cell = torch.where(live, pos, cell)
        found |= live
        active &= ~live
    return found.to(torch.int8), cell.to(torch.int32)


def block_reads(torch, reads: Reads, q, lay):
    """Replay of the block walk (csrc/probe.cuh, `TeamBlockWalk`'s node
    step) on the block-major view. Its outputs, held against the kernel,
    come from a whole count of each 128-key node's entries below q, as a
    warp's node step makes it. The cells it records for the
    bound are the ones a binary search of each node reads: every node row
    is sorted (the terminal keys are, tombstones staying in place and the
    `KEY_INF` padding at the end, and each index row takes every B-th
    entry of the row below), so the count is the node's searchsorted-left
    position, which the replay checks. Terminal cells at or past C are
    padding and read nothing; then the selected terminal key and, on a key
    match, its mark. Returns (found int8, idx int32)."""
    B = 128
    L, W = lay.blk.shape
    cap = lay.term_keys.numel()
    lanes = torch.arange(B, device=q.device)
    qo = (q ^ SIGN)[:, None]

    def node_count(buf, at, cells, node, limit):
        count = (node < qo).sum(1)
        lo, hi = torch.zeros_like(count), torch.full_like(count, B)
        for _ in range(B.bit_length()):
            cont = lo < hi
            mid = ((lo + hi) >> 1).clamp(max=B - 1)
            cell = cells[:, 0] + mid
            reads.add(buf, 8, at + cell, cont & (cell < limit))
            less = node.gather(1, mid[:, None])[:, 0] < qo[:, 0]
            lo = torch.where(cont & less, mid + 1, lo)
            hi = torch.where(cont & ~less, mid, hi)
        check(torch.equal(lo, count), f"block_reads: a {buf} node is not "
              f"sorted")
        return cells[:, 0] + count

    i = torch.zeros(q.numel(), dtype=torch.long, device=q.device)
    for r in range(L - 1, -1, -1):
        cells = (i.clamp(0, W // B - 1) * B)[:, None] + lanes
        i = node_count("blk", r * W, cells, lay.blk[r][cells] ^ SIGN, W)
    cells = (i.clamp(0, lay.n_pad // B - 1) * B)[:, None] + lanes
    tk = torch.where(cells < cap, lay.term_keys[cells.clamp(max=cap - 1)]
                     ^ SIGN, INF_ORDERED)
    i = node_count("term_keys", 0, cells, tk, cap).clamp(0, lay.n_pad - 1)
    has = i < cap
    ic = i.clamp(max=cap - 1)
    reads.add("term_keys", 8, ic, has)
    hit = has & (lay.term_keys[ic] == q)
    reads.add("term_mark", 1, ic, hit)
    found = torch.where(has, hit & (lay.term_mark[ic] == 0), q == -1)
    return found.to(torch.int8), i.to(torch.int32)


def pq_reads(torch, reads: Reads, ranks, mask, lay, found, idx):
    """The cells a rank select needs: the terminal keys and marks from the
    first cell to the furthest selected one (all of them when a masked-in
    rank exceeds the live total), then the level walk of each selected
    key, replayed and held against the kernel's idx."""
    tk, tm = lay.term_keys, lay.term_mark
    total = int(((tm == 0) & (tk != -1)).sum())
    want = ranks.long() + 1
    f = found.bool()
    if bool(((mask != 0) & (want > total)).any()):
        far = tk.numel()
    else:
        far = int(idx[f].max()) + 1 if bool(f.any()) else 0
    cells = torch.arange(far, device=tk.device)
    reads.add("term_keys", 8, cells)
    reads.add("term_mark", 1, cells)
    wf, wi = walk_reads(torch, reads, tk[idx[f].long()], lay)
    check(bool(wf.all()) and torch.equal(wi, idx[f]),
          "pq_pop: the bound's replay differs from the kernel")


def so_reads(torch, reads: Reads, q_rk, q_key, tables, rk, keys):
    """Replay of the splitorder_probe kernel: each query's binary search
    over its table's row (the midpoint cells it reads), then the window
    cells up to the first hit, a key read only where the rk matches.
    Returns (found int8, at int32) so the replay is held against the
    kernel."""
    n_tables, c2 = rk.shape
    frk, fkey = rk.reshape(-1), keys.reshape(-1)
    base = tables.long().clamp(0, n_tables - 1) * c2
    qo = q_rk ^ SIGN
    lo = torch.zeros_like(base)
    hi = torch.full_like(base, c2)
    for _ in range(c2.bit_length()):
        cont = lo < hi
        mid = (lo + hi) >> 1
        reads.add("rk", 8, base + mid, cont)
        less = (frk[base + mid.clamp(max=c2 - 1)] ^ SIGN) < qo
        lo = torch.where(cont & less, mid + 1, lo)
        hi = torch.where(cont & ~less, mid, hi)
    found = torch.zeros_like(cont)
    off = torch.zeros_like(lo)
    for w in range(4):
        cell = base + (lo + w).clamp(0, c2 - 1)
        reads.add("rk", 8, cell, ~found)
        rk_eq = ~found & (frk[cell] == q_rk)
        reads.add("keys", 8, cell, rk_eq)
        hit = rk_eq & (fkey[cell] == q_key)
        off = torch.where(hit, w, off)
        found |= hit
    return found.to(torch.int8), (lo + off).clamp(0, c2 - 1).to(torch.int32)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def max_abs_err(torch, got, ref) -> int:
    check(len(got) == len(ref), "output count")
    err = 0
    for g, r in zip(got, ref):
        check(g.dtype == r.dtype and g.shape == r.shape, "output dtype/shape")
        if g.numel():
            err = max(err, int((g.long() - r.long()).abs().max()))
    return err


def build_kernel_inputs(torch, rng):
    """States at the main path's sizes, built with the port's own batch
    functions on the card: the flat skiplist (C = 2^LOG2_CAPACITY, 75%
    full, 0.5% tombstones), the fixed hash table, and a tiered3 stack at
    C / 2 whose spill tier holds several sorted runs with tombstones."""
    from repro_torch.core import det_skiplist as dsl
    from repro_torch.core import hashtable as ht
    from repro_torch.core.bits import from_u64
    from repro_torch.store import tiers
    C = 1 << LOG2_CAPACITY
    n = 3 * C // 4
    keys = np.unique(rng.integers(1, 2**64 - 2, n + n // 64, dtype=np.uint64))
    keys = rng.permutation(keys)[:n]
    tk = from_u64(keys, DEV)
    flat = dsl.skiplist_init(C, device=DEV)
    flat, _, _ = dsl.insert_batch(flat, tk, tk ^ 0x5A5A)
    flat, _ = dsl.delete_batch(flat, tk[: n // 200])
    table = ht.fixed_init(C // 16, 16, device=DEV)
    table, _, _ = ht.fixed_insert(table, tk, tk + 1)

    t3 = build_tier_stack(torch, rng, tk, C // 2)
    hot_n = t3.hot.keys.numel() * 9 // 10
    t2 = tiers.HASH_SKIPLIST.init(C, device=DEV)
    hot2, _, _ = ht.fixed_insert(t2.hot, tk[:hot_n], tk[:hot_n] + 2)
    t2 = t2._replace(hot=hot2, hot_meta=t3.hot_meta.repeat(2, 1), cold=flat)
    return keys, flat, table, t3, t2


def build_tier_stack(torch, rng, tk, cap):
    """A tiered3 stack of capacity `cap` filled from the keys `tk` (at
    least 1.3 cap of them): the hot tier 9/10 full, the warm tier 7/8 full,
    six spill runs of cap / 16 cells with a tenth of the first run
    tombstoned, seeded lru stamps."""
    from repro_torch.core import det_skiplist as dsl
    from repro_torch.core import hashtable as ht
    from repro_torch.store import tiers
    t3 = tiers.TIERED3.init(cap, device=DEV)
    hot_n = t3.hot.keys.numel() * 9 // 10
    hot, _, _ = ht.fixed_insert(t3.hot, tk[:hot_n], tk[:hot_n] + 2)
    warm = dsl.skiplist_init(cap, device=DEV)
    warm, _, _ = dsl.insert_batch(warm, tk[hot_n:hot_n + cap * 7 // 8],
                                  tk[hot_n:hot_n + cap * 7 // 8] + 3)
    sp = t3.spill
    run = cap // 16
    base = hot_n + cap * 7 // 8
    for r in range(6):
        part = tk[base + r * run: base + (r + 1) * run]
        sp, _ = tiers.spill_append(sp, part, part + 4,
                                   torch.ones_like(part, dtype=torch.bool))
    sp, _ = tiers.spill_discard(sp, tk[base: base + run // 10],
                                torch.ones(run // 10, dtype=torch.bool,
                                           device=DEV))
    meta = torch.from_numpy(rng.integers(0, 64, tuple(hot.keys.shape),
                                         dtype=np.int32)).to(DEV)
    return t3._replace(hot=hot, hot_meta=meta, cold=warm, spill=sp)


def mixed_keys(rng, keys, width):
    """Lanes: 3/4 stored keys, the rest fresh; two in-batch duplicates."""
    fresh = rng.integers(1, 2**64 - 2, width, dtype=np.uint64)
    out = np.where(rng.random(width) < 0.75, rng.choice(keys, width), fresh)
    out[-2:] = out[:2]
    return out


def pq_preload(rng):
    """The pq cell's preload: tickets 0.. of capacity / 2 requests, band 0
    (urgent) holding PQ_URGENT of them and the rest split evenly over
    bands 1 and 2, in a seeded order. Returns (priority, ticket) uint64."""
    n = (1 << PQ_LOG2_CAPACITY) // 2
    rest = n - PQ_URGENT
    prio = np.repeat(np.arange(3, dtype=np.uint64),
                     [PQ_URGENT, rest // 2, rest - rest // 2])
    return rng.permutation(prio), np.arange(n, dtype=np.uint64)


def build_pq_heap(torch, rng):
    """The pq heap at the main path's size: the preload's priority keys in
    a 2^PQ_LOG2_CAPACITY skiplist, the smallest fifth of them popped, so
    a run of tombstones sits at the head, below the compaction
    threshold."""
    from repro_torch.core import det_skiplist as dsl
    from repro_torch.core.bits import from_u64
    prio, ticket = pq_preload(rng)
    tk = from_u64((prio << np.uint64(32)) | ticket, DEV)
    s = dsl.skiplist_init(1 << PQ_LOG2_CAPACITY, device=DEV)
    s, _, _ = dsl.insert_batch(s, tk, from_u64(RID_BASE + ticket, DEV))
    n_dead = ticket.size // 5
    ranks = torch.arange(n_dead, dtype=torch.int32, device=DEV)
    found, _, idx = dsl.pop_rank_select(s, ranks, torch.ones_like(
        ranks, dtype=torch.bool))
    s = dsl.pop_mark(s, idx, found)
    check(int(s.n_marked) == n_dead, "pq heap: the head tombstone run")
    return s


def print_shape(name, shape, r):
    print(f"kernel {name} at {shape}: {r['ms']:.6f} ms/call (launches "
          f"{', '.join(f'{x:.6f}' for x in r['launch_ms'])} ms), bound "
          f"{r['bound_ms']:.7f} ms by {r['bound_by']}, "
          f"{r['ms'] / r['bound_ms']:.1f}x the bound"
          + (f", plain {r['plain_ms']:.6f} ms"
             if r.get("plain_ms") is not None else "")
          + (f", library {r['library_ms']:.6f} ms"
             if r.get("library_ms") is not None else ""), flush=True)


def print_row(name, r, lanes):
    print(f"kernel {name}: {r['ms']:.6f} ms/call (plain "
          f"{r['plain_ms']:.6f} ms, library {r['library_ms']}, bound "
          f"{r['bound_ms']:.7f} ms by {r['bound_by']}, "
          f"{r['ms'] / r['bound_ms']:.1f}x the bound) at {lanes} lanes; "
          f"whole gpu dispatch {r['dispatch_ms']:.6f} ms, glue "
          f"{r['dispatch_ms'] - r['ms']:.6f} ms", flush=True)


# ---------------------------------------------------------------------------
# phase 2: tier_apply, tier_find and pq_pop at every shape the main path
# calls them with, each launch timed apart
# ---------------------------------------------------------------------------

# the pq cell's heap is 2^PQ_LOG2_CAPACITY; the serving scheduler's
# (`Engine`'s max_pending) holds 1,024 entries, and a served pop plan pops
# at most 4 (`Engine._admit`)
SERVE_PQ_CAPACITY = 1024
SERVE_PQ_LIVE = 512
SERVE_PQ_LANES = 4


def split_ms(torch, fn, reps: int = 15) -> list:
    """Median device time of each kernel launch that one call of `fn`
    makes, in launch order: CUDA events around every `cuda.launch` (a
    sleep kernel ahead of each call, as in `median_ms`)."""
    from repro_torch.kernels import cuda
    orig = cuda.launch
    marks, per = [], []

    def timed(*a, **k):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        orig(*a, **k)
        e1.record()
        marks.append((e0, e1))

    cuda.launch = timed
    try:
        for _ in range(reps):
            marks.clear()
            torch.cuda.synchronize()
            torch.cuda._sleep(20_000_000)
            fn()
            torch.cuda.synchronize()
            per.append([a.elapsed_time(b) for a, b in marks])
    finally:
        cuda.launch = orig
    return [statistics.median(x) for x in zip(*per)]


def tier_find_bound(torch, q, slots, hot_keys, wl, sp, layout):
    """The bound of a tier_find call (`bound`): the replays of its three
    probes plus its lanes' inputs and outputs and the offset tables.
    Returns ((bound_ms, bound_by), the replayed outputs)."""
    reads = Reads()
    walk = walk_reads if layout == "level" else block_reads
    out = bucket_reads(torch, reads, q, slots, hot_keys, False)
    out += walk(torch, reads, q, wl)
    tables = 4 * (len(wl.offsets) if layout == "level" else 0)
    if sp is not None:
        out += spill_reads(torch, reads, q, sp)
        tables += 4 * sp.run_off.numel()
    t = q.numel()
    return bound(torch, reads, t * (8 + 4 + 3 * (1 + 4)) + tables), out


def tier_apply_bound(torch, sk, ss, sm, hot_keys, meta, wl, sp, layout):
    """The bound of a tier_apply call: the membership replays on the
    masked queries (the whole bucket row, which the kernel reads for its
    empty cells, and the row's metadata), plus the lanes' inputs and the
    nine output planes. Returns ((bound_ms, bound_by), in_warm replayed)."""
    mq = torch.where(sm != 0, sk, -1)
    reads = Reads()
    f_hot, _ = bucket_reads(torch, reads, mq, ss, hot_keys, True)
    walk = walk_reads if layout == "level" else block_reads
    f_warm, _ = walk(torch, reads, mq, wl)
    tables = 4 * (len(wl.offsets) if layout == "level" else 0)
    if sp is not None:
        spill_reads(torch, reads, mq, sp)
        tables += 4 * sp.run_off.numel()
    m, b = hot_keys.shape
    reads.add("meta", 4, ss.long().clamp(0, m - 1)[:, None] * b
              + torch.arange(b, device=sk.device))
    k = sk.numel()
    in_warm = f_warm.bool() & (f_hot == 0) & (sm != 0)
    return bound(torch, reads, k * (8 + 4 + 1 + 4 + 4) + k * (6 + 3 * 4)
                 + 4 + tables), in_warm


def shape_row(torch, fn, bnd, plain=None):
    """Time `fn` as one call and launch by launch, beside its bound and,
    where `plain` is given, its plain version's time."""
    return dict(ms=median_ms(torch, fn), launch_ms=split_ms(torch, fn),
                bound_ms=bnd[0], bound_by=bnd[1],
                plain_ms=None if plain is None else median_ms(torch, plain))


def print_shapes(tier_rows, pq_rows, probe_rows):
    """The `kernel` lines of every shape the main path calls tier_apply,
    tier_find and pq_pop with (skiplist_search's served shape among the
    pq rows), and of the single probes at both plan widths
    (`probe_rows`)."""
    for (kern, layout, label, lanes), r in tier_rows.items():
        print_shape(f"{kern}/{layout}", f"{label}, {lanes} lanes", r)
    for (name, label), r in list(pq_rows.items()) + list(probe_rows.items()):
        print_shape(name, label, r)


def tier_rows(torch, rows, st, label, q, vals, mask, layouts):
    """tier_apply (policy lru, eviction cap = the lanes) and, where the
    stack has a spill tier, tier_find on the lanes `q` of stack `st` in
    each of `layouts` (the level layout first), each checked against its
    plain version and its bound's replay, then timed (`shape_row`) into
    `rows` under (kernel, layout, label, lanes). A block row's bound is at
    most the level row's (`kernel_phase`)."""
    from repro_torch.core.layout import (bskiplist_layout, hash_slot,
                                         skiplist_layout, spill_layout)
    from repro_torch.kernels.tier_apply.kernel import tier_apply_tiles
    from repro_torch.kernels.tier_apply.ops import sorted_lanes
    from repro_torch.kernels.tier_apply.ref import tier_apply_planes_ref
    from repro_torch.kernels.tier_find.kernel import tier_find_tiles
    from repro_torch.kernels.tier_find.ref import tier_find_planes_ref
    lanes = q.numel()
    sp = (None if st.spill is None else
          spill_layout(st.spill.keys, st.spill.dead, st.spill.run_start,
                       st.spill.n))
    _, ss, sk, _, sm, krs, srs = sorted_lanes(st.hot.num_slots, q, vals,
                                              mask)
    me = torch.tensor([lanes], dtype=torch.int32, device=DEV)
    slots = hash_slot(q, st.hot.num_slots)
    views = {"level": skiplist_layout, "block": bskiplist_layout}
    bounds = {}
    for layout in layouts:
        wl = views[layout](st.cold)
        args = (sk, ss, sm, krs, srs, st.hot.keys, st.hot_meta, wl, me, sp,
                "lru")
        got = tier_apply_tiles(*args)
        check(max_abs_err(torch, got, tier_apply_planes_ref(*args)) == 0,
              f"tier_apply ({label}, {layout}, {lanes} lanes) differs from "
              f"its plain version")
        bnd, in_warm = tier_apply_bound(torch, sk, ss, sm, st.hot.keys,
                                        st.hot_meta, wl, sp, layout)
        check(torch.equal(got[0].bool(), in_warm),
              "tier_apply: the bound's replay differs")
        bounds[("tier_apply", layout)] = bnd
        fargs = (q, slots, st.hot.keys, wl, sp)
        if sp is not None:
            got = tier_find_tiles(*fargs)
            check(max_abs_err(torch, got, tier_find_planes_ref(*fargs)) == 0,
                  f"tier_find ({label}, {layout}, {lanes} lanes) differs "
                  f"from its plain version")
            fb, replayed = tier_find_bound(torch, q, slots, st.hot.keys, wl,
                                           sp, layout)
            check(max_abs_err(torch, got, replayed) == 0,
                  "tier_find: the bound's replay differs")
            bounds[("tier_find", layout)] = fb
        for kern in ("tier_apply", "tier_find"):
            if (kern, layout) not in bounds:
                continue
            bnd = bounds[(kern, layout)]
            if layout == "block":
                bnd = min(bnd, bounds[(kern, "level")])
            fn, plain = (((lambda a=args: tier_apply_tiles(*a)),
                          (lambda a=args: tier_apply_planes_ref(*a)))
                         if kern == "tier_apply" else
                         ((lambda a=fargs: tier_find_tiles(*a)),
                          (lambda a=fargs: tier_find_planes_ref(*a))))
            rows[(kern, layout, label, lanes)] = shape_row(torch, fn, bnd,
                                                           plain)


# the serving engine's prefix cache: an `obs:tiered3/lru` store of 1,024
# cells (`serving.prefix_cache.prefix_cache_init`), probed and filled with
# a prompt's full pages, 9 to 64 lanes a call
SERVE_PC_CAPACITY = 1024
SERVE_PC_LANES = (9, 64)


def tier_shapes(torch, rng, keys, t3, t2):
    """tier_apply and tier_find (`tier_rows`) at the main path's two plan
    widths: a workload plan of WL_LANES lanes (3/4 stored keys, 95% of the
    lanes inserting) and a preload plan of PRELOAD_LANES fresh keys, every
    lane inserting; both warm layouts; tier_apply with spill (tiered3) and
    without (hash+skiplist), tier_find with spill. Then the serving
    shapes: the level layout on a stack of the prefix cache's capacity
    with spill runs, at SERVE_PC_LANES lanes (3/4 stored keys, every lane
    inserting). Returns the rows keyed (kernel, layout, label, lanes)."""
    from repro_torch.core.bits import from_u64
    rows = {}
    fresh = rng.integers(1, 2**64 - 2, PRELOAD_LANES, dtype=np.uint64)
    for lanes, qn, share in ((WL_LANES, mixed_keys(rng, keys, WL_LANES),
                              0.95), (PRELOAD_LANES, fresh, 1.0)):
        q = from_u64(qn, DEV)
        vals = from_u64(rng.integers(0, 2**64 - 1, lanes, dtype=np.uint64),
                        DEV)
        mask = torch.from_numpy(rng.random(lanes) < share).to(DEV)
        for st, label in ((t3, "spill"), (t2, "no spill")):
            tier_rows(torch, rows, st, label, q, vals, mask,
                      ("level", "block"))
    pc_keys = np.unique(rng.integers(1, 2**64 - 2, 2 * SERVE_PC_CAPACITY,
                                     dtype=np.uint64))
    pc_keys = rng.permutation(pc_keys)
    pc = build_tier_stack(torch, rng, from_u64(pc_keys, DEV),
                          SERVE_PC_CAPACITY)
    for lanes in SERVE_PC_LANES:
        q = from_u64(mixed_keys(rng, pc_keys[:SERVE_PC_CAPACITY], lanes), DEV)
        vals = from_u64(rng.integers(0, 2**64 - 1, lanes, dtype=np.uint64),
                        DEV)
        tier_rows(torch, rows, pc, "serving, spill", q, vals,
                  torch.ones(lanes, dtype=torch.bool, device=DEV),
                  ("level",))
    return rows


def probe_rows(torch, rng, keys, flat, table, forced: bool = False):
    """skiplist_search, bskiplist_walk, hash_probe and splitorder_probe at
    the main path's two plan widths: a workload plan of WL_LANES lanes
    (3/4 stored keys) and a preload plan of PRELOAD_LANES fresh keys, on
    the main path's states, each checked against its plain version and
    its bound's replay, timed beside its bound and its library call
    (`torch.searchsorted` of the ordered terminal keys for the two walks,
    grouped by table for splitorder_probe; none for hash_probe). With
    `forced`, hash_probe and splitorder_probe also run forced to each of
    their team widths (`forced_team`), each checked and timed again, in
    rows labelled with the width. Returns the rows keyed by (name, shape
    label)."""
    from repro_torch.core.bits import bitrev64, from_u64, hash64, ordered
    from repro_torch.core.layout import (bskiplist_layout, hash_slot,
                                         skiplist_layout)
    from repro_torch.core.splitorder import _table_of
    from repro_torch.kernels.bskiplist_walk.kernel import bskiplist_walk_tiles
    from repro_torch.kernels.bskiplist_walk.ref import bskiplist_walk_ref
    from repro_torch.kernels.hash_probe import kernel as hpk
    from repro_torch.kernels.hash_probe.kernel import hash_probe_tiles
    from repro_torch.kernels.hash_probe.ref import hash_probe_ref
    from repro_torch.kernels.skiplist_search.kernel import skiplist_search_tiles
    from repro_torch.kernels.skiplist_search.ref import skiplist_search_ref
    from repro_torch.kernels.splitorder_probe import kernel as sok
    from repro_torch.kernels.splitorder_probe.kernel import \
        splitorder_probe_tiles
    from repro_torch.kernels.splitorder_probe.ref import splitorder_probe_ref
    plans = {f"workload, {WL_LANES} lanes":
             from_u64(mixed_keys(rng, keys, WL_LANES), DEV),
             f"preload, {PRELOAD_LANES} lanes":
             from_u64(rng.integers(1, 2**64 - 2, PRELOAD_LANES,
                                   dtype=np.uint64), DEV)}
    rows = {}

    def row(name, shape, fn, ref, replay, stream, library=None, cap=None,
            module=None):
        got = fn()
        want = ref()
        check(max_abs_err(torch, got, want) == 0,
              f"{name} ({shape}) differs from its plain version")
        reads = Reads()
        check(max_abs_err(torch, got, replay(reads)) == 0,
              f"{name} ({shape}): the bound's replay differs")
        bnd = bound(torch, reads, stream)
        if cap is not None:
            bnd = min(bnd, cap)
        r = shape_row(torch, fn, bnd, ref)
        r["library_ms"] = None if library is None else median_ms(torch,
                                                                 library)
        rows[(name, shape)] = r
        for team in module.TEAMS if forced and module is not None else ():
            with forced_team(module, "probe_team", team):
                check(max_abs_err(torch, fn(), want) == 0,
                      f"{name} ({shape}, team {team}) differs from its "
                      f"plain version")
                rows[(name, f"{shape}, team {team}")] = shape_row(torch, fn,
                                                                  bnd)
        return r

    lay, blay = skiplist_layout(flat), bskiplist_layout(flat)
    oterm = ordered(flat.term_keys)
    for shape, q in plans.items():
        T = q.numel()
        oq = ordered(q)
        level = row("skiplist_search", shape,
                    lambda: skiplist_search_tiles(q, lay),
                    lambda: skiplist_search_ref(q, lay),
                    lambda reads: walk_reads(torch, reads, q, lay),
                    T * (8 + 1 + 4) + 4 * len(lay.offsets),
                    lambda: torch.searchsorted(oterm, oq))
        row("bskiplist_walk", shape, lambda: bskiplist_walk_tiles(q, blay),
            lambda: bskiplist_walk_ref(q, blay),
            lambda reads: block_reads(torch, reads, q, blay),
            T * (8 + 1 + 4), lambda: torch.searchsorted(oterm, oq),
            (level["bound_ms"], level["bound_by"]))
        slots = hash_slot(q, table.num_slots)
        row("hash_probe", shape, lambda: hash_probe_tiles(q, slots,
                                                          table.keys),
            lambda: hash_probe_ref(q, slots, table.keys),
            lambda reads: bucket_reads(torch, reads, q, slots, table.keys,
                                       False),
            T * (8 + 4 + 1 + 4), module=hpk)
    del lay, blay, oterm
    h, _, _ = build_splitorder(torch, rng)
    orf = ordered(h.rk)
    for shape, q in plans.items():
        q_rk, tables = bitrev64(hash64(q)), _table_of(h, q)
        args = (q_rk, q, tables, h.rk, h.keys)
        grouped = grouped_queries(torch, q_rk, tables, h.rk.shape[0])
        row("splitorder_probe", shape, lambda: splitorder_probe_tiles(*args),
            lambda: splitorder_probe_ref(*args),
            lambda reads: so_reads(torch, reads, *args),
            q.numel() * (8 + 8 + 4 + 1 + 4),
            lambda: torch.searchsorted(orf, grouped), module=sok)
    del h, orf
    torch.cuda.empty_cache()
    return rows


def grouped_queries(torch, q_rk, tables, n_tables):
    """The ordered rk of the queries grouped by table, one row a table
    padded with the largest ordered key: the input of the grouped
    `torch.searchsorted` that finds every query's position in its table's
    row (splitorder_probe's library yardstick)."""
    from repro_torch.core.bits import ordered
    t = q_rk.numel()
    o = torch.argsort(tables, stable=True)
    counts = torch.bincount(tables.long(), minlength=n_tables)
    row = torch.repeat_interleave(torch.arange(n_tables, device=DEV), counts)
    col = torch.arange(t, device=DEV) - torch.cumsum(counts, 0)[row] \
        + counts[row]
    grouped = torch.full((n_tables, int(counts.max())), (1 << 63) - 1,
                         dtype=torch.int64, device=DEV)
    grouped[row, col] = ordered(q_rk[o])
    return grouped


def build_small_heap(torch, rng, capacity, live, popped):
    """A pq heap of `capacity` cells holding `live` priority keys (three
    bands, tickets in a seeded order), the smallest `popped` of them
    popped, so a run of tombstones sits at its head."""
    from repro_torch.core import det_skiplist as dsl
    from repro_torch.core.bits import from_u64
    prio = rng.integers(0, 3, live).astype(np.uint64)
    ticket = rng.permutation(live).astype(np.uint64)
    tk = from_u64((prio << np.uint64(32)) | ticket, DEV)
    s = dsl.skiplist_init(capacity, device=DEV)
    s, _, _ = dsl.insert_batch(s, tk, from_u64(RID_BASE + ticket, DEV))
    ranks = torch.arange(popped, dtype=torch.int32, device=DEV)
    found, _, idx = dsl.pop_rank_select(s, ranks, torch.ones_like(
        ranks, dtype=torch.bool))
    return dsl.pop_mark(s, idx, found)


def pq_shapes(torch, rng, heap, ranks, m8):
    """pq_pop at the main path's three shapes: a pq workload plan (the
    given ranks on the 2^PQ_LOG2_CAPACITY heap with its head tombstone
    run), a preload plan (PRELOAD_LANES lanes, no pop lane) on the same
    heap, and a served pop plan (SERVE_PQ_LANES lanes, ranks 0..) on a
    heap of the serving scheduler's capacity; then skiplist_search at the
    served plans' find shape on that heap (`serve_search_rows`). Each is
    checked against its plain version first. Returns the rows keyed by
    (kernel, shape)."""
    from repro_torch.core.layout import skiplist_layout
    from repro_torch.kernels.pq_pop.kernel import pq_pop_tiles
    from repro_torch.kernels.pq_pop.ref import pq_pop_ref
    small = build_small_heap(torch, rng, SERVE_PQ_CAPACITY, SERVE_PQ_LIVE,
                             SERVE_PQ_LIVE // 8)
    serve_r = torch.arange(SERVE_PQ_LANES, dtype=torch.int32, device=DEV)
    none_r = torch.full((PRELOAD_LANES,), -1, dtype=torch.int32, device=DEV)
    rows = {}
    for label, st, r, m in (
            ("plan", heap, ranks, m8),
            ("no pop", heap, none_r, torch.zeros_like(none_r,
                                                       dtype=torch.int8)),
            ("serving", small, serve_r, torch.ones_like(serve_r,
                                                        dtype=torch.int8))):
        lay = skiplist_layout(st)
        got = pq_pop_tiles(r, m, lay)
        check(max_abs_err(torch, got, pq_pop_ref(r, m, lay)) == 0,
              f"pq_pop ({label}) differs from its plain version")
        reads = Reads()
        pq_reads(torch, reads, r, m, lay, got[0], got[1])
        bnd = bound(torch, reads, r.numel() * (4 + 1 + 1 + 4)
                    + 4 * len(lay.offsets))
        rows[("pq_pop", f"{label}, {r.numel()} lanes, "
               f"{st.term_keys.numel()} cells")] = \
            shape_row(torch, lambda a=(r, m, lay): pq_pop_tiles(*a), bnd,
                      lambda a=(r, m, lay): pq_pop_ref(*a))
    rows.update(serve_search_rows(torch, rng, small))
    return rows


def serve_search_rows(torch, rng, small):
    """skiplist_search as the served pq plans call it: 1 and
    SERVE_PQ_LANES lanes (the 1-4 lanes of a pop plan's find) on the
    scheduler's heap `small`, half of them stored keys and half fresh,
    held against its plain version and its bound's replay (`walk_reads`),
    timed beside `torch.searchsorted` of the ordered terminal keys."""
    from repro_torch.core.bits import from_u64, ordered
    from repro_torch.core.layout import skiplist_layout
    from repro_torch.kernels.skiplist_search.kernel import skiplist_search_tiles
    from repro_torch.kernels.skiplist_search.ref import skiplist_search_ref
    lay = skiplist_layout(small)
    oterm = ordered(small.term_keys)
    live = small.term_keys[:int(small.n_term)].cpu().numpy().view(np.uint64)
    rows = {}
    for lanes in (1, SERVE_PQ_LANES):
        qn = np.where(np.arange(lanes) % 2 == 0, rng.choice(live, lanes),
                      rng.integers(1, 2**64 - 2, lanes, dtype=np.uint64))
        q = from_u64(qn, DEV)
        got = skiplist_search_tiles(q, lay)
        check(max_abs_err(torch, got, skiplist_search_ref(q, lay)) == 0,
              f"skiplist_search (serving, {lanes} lanes) differs from its "
              f"plain version")
        reads = Reads()
        check(max_abs_err(torch, got, walk_reads(torch, reads, q, lay)) == 0,
              "skiplist_search (serving): the bound's replay differs")
        r = shape_row(torch, lambda a=(q, lay): skiplist_search_tiles(*a),
                      bound(torch, reads, lanes * (8 + 1 + 4)
                            + 4 * len(lay.offsets)),
                      lambda a=(q, lay): skiplist_search_ref(*a))
        r["library_ms"] = median_ms(torch, lambda a=(oterm, ordered(q)):
                                    torch.searchsorted(*a))
        rows[("skiplist_search", f"serving, {lanes} lanes, "
              f"{small.term_keys.numel()} cells")] = r
    return rows


def shard_shapes(torch, rng):
    """skiplist_search, tier_find and tier_apply at the sharded store's
    shape (phase 6): a pool of SHARD_LANES * SHARD_POOL_FACTOR lanes
    (3/4 stored keys) on one shard, a 3/4-full skiplist of SHARD_CAP keys
    and a tiered3 stack of SHARD_CAP / 2 with spill runs (the level
    layout, as the shard's `tiered3/lru` runs it). Each is checked
    against its plain version and its bound's replay, timed beside its
    bound (and skiplist_search beside `torch.searchsorted`). Returns
    (tier rows keyed as `tier_shapes`'s, probe rows keyed as
    `probe_rows`')."""
    from repro_torch.core import det_skiplist as dsl
    from repro_torch.core.bits import from_u64, ordered
    from repro_torch.core.layout import skiplist_layout
    from repro_torch.kernels.skiplist_search.kernel import skiplist_search_tiles
    from repro_torch.kernels.skiplist_search.ref import skiplist_search_ref
    pool = SHARD_LANES * SHARD_POOL_FACTOR
    n = 3 * SHARD_CAP // 4
    keys = rng.permutation(np.unique(rng.integers(
        1, 2**64 - 2, 2 * SHARD_CAP, dtype=np.uint64)))
    tk = from_u64(keys[:n], DEV)
    shard = dsl.skiplist_init(SHARD_CAP, device=DEV)
    shard, _, _ = dsl.insert_batch(shard, tk, tk ^ 0x5A5A)
    lay = skiplist_layout(shard)
    q = from_u64(mixed_keys(rng, keys[:n], pool), DEV)
    got = skiplist_search_tiles(q, lay)
    check(max_abs_err(torch, got, skiplist_search_ref(q, lay)) == 0,
          "skiplist_search (sharded pool) differs from its plain version")
    reads = Reads()
    check(max_abs_err(torch, got, walk_reads(torch, reads, q, lay)) == 0,
          "skiplist_search (sharded pool): the bound's replay differs")
    r = shape_row(torch, lambda: skiplist_search_tiles(q, lay),
                  bound(torch, reads, pool * (8 + 1 + 4)
                        + 4 * len(lay.offsets)),
                  lambda: skiplist_search_ref(q, lay))
    oq, oterm = ordered(q), ordered(shard.term_keys)
    r["library_ms"] = median_ms(torch, lambda: torch.searchsorted(oterm, oq))
    probes = {("skiplist_search", f"sharded pool, {pool} lanes, "
               f"{SHARD_CAP}-key shard"): r}
    del shard, lay
    tier_cap = SHARD_CAP // 2
    t3 = build_tier_stack(torch, rng, from_u64(keys, DEV), tier_cap)
    tq = from_u64(mixed_keys(rng, keys[:tier_cap], pool), DEV)
    vals = from_u64(rng.integers(0, 2**64 - 1, pool, dtype=np.uint64), DEV)
    tiers_ = {}
    tier_rows(torch, tiers_, t3, f"sharded pool, {tier_cap}-key "
              f"tiered3 shard, spill", tq, vals,
              torch.ones(pool, dtype=torch.bool, device=DEV), ("level",))
    del t3
    torch.cuda.empty_cache()
    return tiers_, probes


def shapes_only(torch, seed: int) -> None:
    """The per-shape timing alone, on the port that `repro_torch` imports
    (e.g. `PYTHONPATH=<tree>/src python3 -c 'import chip_smoke, torch;
    chip_smoke.shapes_only(torch, 1)'` from a tree's root, after
    `repro_torch.kernels.cuda.build_all()`): the tier rows on the inputs
    `kernel_phase` builds from the same seed, the pq rows on a heap and
    plan drawn alike."""
    rng = np.random.default_rng(seed)
    keys, flat, table, t3, t2 = build_kernel_inputs(torch, rng)
    tier_rows = tier_shapes(torch, np.random.default_rng([seed, 5]), keys,
                            t3, t2)
    del t3, t2
    probes = probe_rows(torch, np.random.default_rng([seed, 7]), keys, flat,
                        table)
    del flat, table
    torch.cuda.empty_cache()
    more_tiers, more_probes = shard_shapes(torch,
                                           np.random.default_rng([seed, 12]))
    tier_rows.update(more_tiers)
    probes.update(more_probes)
    heap = build_pq_heap(torch, rng)
    T = WL_LANES
    pop = torch.from_numpy(rng.permutation(T) < T // 2).to(DEV)
    ranks = torch.cumsum(pop.to(torch.int32), 0, dtype=torch.int32) - 1
    print_shapes(tier_rows, pq_shapes(torch, np.random.default_rng([seed, 6]),
                                      heap, ranks, pop.to(torch.int8)),
                 probes)


def widths_only(torch, seed: int) -> None:
    """hash_probe and splitorder_probe alone (`probe_rows` with `forced`):
    at both plan widths under their rules and forced to each team width,
    on the inputs `shapes_only` builds from the same seed (run it as
    `shapes_only` is run)."""
    rng = np.random.default_rng(seed)
    keys, flat, table, t3, t2 = build_kernel_inputs(torch, rng)
    del t3, t2
    rows = probe_rows(torch, np.random.default_rng([seed, 7]), keys, flat,
                      table, True)
    for (name, label), r in rows.items():
        if name in ("hash_probe", "splitorder_probe"):
            print_shape(name, label, r)


def build_splitorder(torch, rng):
    """The twolevel_splitorder state at the main path's size (8 tables of
    2^(LOG2_CAPACITY - 3) cells), built directly from seeded keys: table
    0 full, table 1 empty, the rest 3/4 full (rows sorted by rk, as the
    insert path keeps them), and in table 2 a run of 5 cells sharing one
    rk with different keys (an injected 64-bit hash collision run).
    Returns (state, stored keys by table, the run's start in table 2)."""
    from repro_torch.core.bits import bitrev64, from_u64, hash64, ordered
    from repro_torch.core.splitorder import _table_of
    from repro_torch.store import get_backend
    h = get_backend("twolevel_splitorder").init(1 << LOG2_CAPACITY,
                                                device=DEV)
    T, c2 = h.rk.shape
    cand = torch.unique(from_u64(rng.integers(1, 2**64 - 2, int(T * c2 * 1.2),
                                              dtype=np.uint64), DEV))
    gen = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
    cand = cand[torch.randperm(cand.numel(), generator=gen).to(DEV)]
    tbl = _table_of(h, cand)
    fill = [c2, 0] + [3 * c2 // 4] * (T - 2)
    rk, keys, vals = h.rk.clone(), h.keys.clone(), h.vals.clone()
    stored = []
    for t, n in enumerate(fill):
        k = cand[tbl == t][:n]
        check(k.numel() == n, "splitorder: enough keys per table")
        r = bitrev64(hash64(k))
        o = torch.argsort(ordered(r))
        rk[t, :n], keys[t, :n], vals[t, :n] = r[o], k[o], k[o] ^ 0x5A5A
        stored.append(k)
    a = c2 // 4
    rk[2, a:a + 5] = rk[2, a]
    n = torch.tensor(fill, dtype=torch.int32, device=DEV)
    return h._replace(rk=rk, keys=keys, vals=vals, n=n), stored, a


def splitorder_kernel_row(torch, rng):
    """splitorder_probe at WL_LANES lanes on the main path's table size:
    3/4 stored keys (the full table's among them), the rest fresh; lanes
    routed to the empty table; KEY_INF lanes; the 5 lanes of the collision
    run (the first 4 in the window, the 5th past it). Held bit for bit
    against its plain version and the bound's replay; gpu == torch
    through the dispatch; timed beside `torch.searchsorted` of the same
    queries grouped by table (the position only)."""
    from repro_torch.core.bits import (KEY_INF, bitrev64, from_u64, hash64,
                                       ordered)
    from repro_torch.core.splitorder import _table_of
    from repro_torch.kernels.splitorder_probe.kernel import \
        splitorder_probe_tiles
    from repro_torch.kernels.splitorder_probe.ref import splitorder_probe_ref
    from repro_torch.store import exec as exec_
    h, stored, a = build_splitorder(torch, rng)
    T = WL_LANES
    allk = torch.cat(stored)
    pick = torch.from_numpy(rng.integers(0, allk.numel(), T)).to(DEV)
    fresh = from_u64(rng.integers(1, 2**64 - 2, T, dtype=np.uint64), DEV)
    is_fresh = torch.from_numpy(rng.random(T) < 0.25).to(DEV)
    qk = torch.where(is_fresh, fresh, allk[pick])
    empty = (_table_of(h, fresh) == 1).nonzero()[:16, 0]
    qk[16:16 + empty.numel()] = fresh[empty]         # the empty table's
    q_rk = bitrev64(hash64(qk))
    tables = _table_of(h, qk)
    q_rk[:4], qk[:4] = KEY_INF, KEY_INF              # KEY_INF lanes
    for k in range(5):                               # the collision run
        q_rk[8 + k], qk[8 + k], tables[8 + k] = h.rk[2, a], h.keys[2, a + k], 2
    args = (q_rk, qk, tables, h.rk, h.keys)
    got = splitorder_probe_tiles(*args)
    err = max_abs_err(torch, got, splitorder_probe_ref(*args))
    check(err == 0, "splitorder_probe differs from its plain version")
    reads = Reads()
    replayed = so_reads(torch, reads, *args)
    check(max_abs_err(torch, got, replayed) == 0,
          "splitorder_probe: the bound's replay differs from the kernel")
    f, at = got[0].tolist(), got[1].tolist()
    check(f[8:13] == [1, 1, 1, 1, 0]
          and at[8:13] == [a, a + 1, a + 2, a + 3, a],
          "splitorder_probe: the collision window")
    hit = got[0].bool()
    check(bool(hit[tables == 0].any()) and not bool(hit[16:16 + empty.numel()]
                                                    .any()),
          "splitorder_probe: hits in the full table, none in the empty one")
    check(int(hit[~is_fresh].sum()) > T // 2, "splitorder_probe finds "
          "stored keys")
    keys = qk.clone()
    g = exec_.twolevel_splitorder_find(h, keys, mode="gpu")
    t = exec_.twolevel_splitorder_find(h, keys, mode="torch")
    check(all(torch.equal(x, y) for x, y in zip(g, t)),
          "twolevel_splitorder_find: gpu dispatch != torch dispatch")
    print(f"splitorder_probe: bit-identical ({int(hit.sum())} of {T} "
          f"found; collision window {f[8:13]} at {at[8:13]})", flush=True)
    # the library yardstick: the same searches, grouped by table
    grouped = grouped_queries(torch, q_rk, tables, h.rk.shape[0])
    orf = ordered(h.rk)
    r = dict(max_abs_err=err,
             ms=median_ms(torch, lambda: splitorder_probe_tiles(*args)),
             plain_ms=median_ms(torch, lambda: splitorder_probe_ref(*args),
                                5),
             library_ms=median_ms(torch, lambda: torch.searchsorted(
                 orf, grouped)),
             dispatch_ms=median_ms(torch, lambda: exec_.
                                   twolevel_splitorder_find(h, keys,
                                                            mode="gpu")),
             bound=bound(torch, reads, T * (8 + 8 + 4 + 1 + 4)))
    del h, stored, allk, orf
    torch.cuda.empty_cache()
    return r


WALK_EDGE_CAPS = (16, 100, 4096)
WALK_EDGE_LANES = (1, 33, 4097)


def walk_edge_states(torch, rng):
    """Small skiplists for the shared level walk's edges: at each of
    WALK_EDGE_CAPS an empty one, one 3/4 full and the same with every key
    tombstoned. Yields (label, state, stored keys as uint64)."""
    from repro_torch.core import det_skiplist as dsl
    from repro_torch.core.bits import from_u64
    for cap in WALK_EDGE_CAPS:
        empty = dsl.skiplist_init(cap, device=DEV)
        yield f"C {cap} empty", empty, np.zeros(0, np.uint64)
        keys = np.unique(rng.integers(1, 2**64 - 3, cap, dtype=np.uint64))
        keys = rng.permutation(keys)[:3 * cap // 4]
        tk = from_u64(keys, DEV)
        full, _, _ = dsl.insert_batch(empty, tk, tk ^ 0x5A5A)
        check(int(full.n_term) == keys.size, "walk edges: the fill")
        yield f"C {cap} 3/4 full", full, keys
        live = torch.arange(cap, device=DEV) < full.n_term
        yield (f"C {cap} all tombstoned",
               full._replace(term_mark=full.term_mark | live,
                             n_marked=full.n_term), keys)


def walk_edge_queries(rng, keys, t):
    """t lanes: 0, 2^64 - 2, KEY_INF and one past the last stored key
    first (as many as fit), then stored keys and fresh ones."""
    special = np.array([0, 2**64 - 2, 2**64 - 1,
                        int(keys.max()) + 1 if keys.size else 1], np.uint64)
    pool = (np.concatenate([keys, rng.integers(1, 2**64 - 2, keys.size + 8,
                                               dtype=np.uint64)])
            if keys.size else rng.integers(1, 2**64 - 2, 8, dtype=np.uint64))
    return np.concatenate([special, rng.choice(pool, max(t - 4, 0))])[:t]


@contextlib.contextmanager
def forced_team(module, rule: str, team: int):
    """Make the team-width rule `module.rule` return `team`, so that an
    edge case runs that kernel instance whatever its plan width."""
    orig = getattr(module, rule)
    setattr(module, rule, lambda *a, **k: team)
    try:
        yield
    finally:
        setattr(module, rule, orig)


def rule_plans(rule, sms: int, slots, widths) -> dict:
    """{plan width: team} for the widest plan at which the team-width rule
    `rule(k)` picks each width it can pick: a width w's teams are all
    resident up to k = sms * slots(w) / w lanes, and the rule picks w there
    unless a wider team is still resident; past every such k it picks the
    narrowest."""
    plans = {}
    for w in widths:
        k = sms * slots(w) // w
        if k >= 1 and rule(k) == w:
            plans[k] = w
    if widths[-1] not in plans.values():
        k = max(sms * slots(w) // w for w in widths) + 1
        plans[k] = rule(k)
    return plans


def walk_edge_sweep(torch, rng):
    """The kernels that share `level_walk` (skiplist_search, pq_pop,
    tier_find and tier_apply in the level layout) held bit for bit
    against their plain versions on `walk_edge_states`, at WALK_EDGE_LANES
    lanes (`walk_edge_queries`; for pq_pop, ranks from -1
    up past the live total with a tenth of the lanes masked off);
    tier_find in both layouts at every team width it has (`forced_team`)."""
    from repro_torch.core import hashtable as ht
    from repro_torch.core.bits import from_u64
    from repro_torch.core.layout import (bskiplist_layout, hash_slot,
                                         skiplist_layout)
    from repro_torch.kernels.pq_pop.kernel import pq_pop_tiles
    from repro_torch.kernels.pq_pop.ref import pq_pop_ref
    from repro_torch.kernels.skiplist_search.kernel import skiplist_search_tiles
    from repro_torch.kernels.skiplist_search.ref import skiplist_search_ref
    from repro_torch.kernels.tier_apply.kernel import tier_apply_tiles
    from repro_torch.kernels.tier_apply.ops import sorted_lanes
    from repro_torch.kernels.tier_apply.ref import tier_apply_planes_ref
    from repro_torch.kernels.tier_find import kernel as tfk
    from repro_torch.kernels.tier_find.kernel import tier_find_tiles
    from repro_torch.kernels.tier_find.ref import tier_find_planes_ref
    n, hits = 0, 0
    widths = collections.Counter()
    for label, st, keys in walk_edge_states(torch, rng):
        lay = skiplist_layout(st)
        blay = bskiplist_layout(st)
        hot = ht.fixed_init(1 << max(st.capacity.bit_length() - 5, 0), 4,
                            device=DEV)
        meta = torch.zeros(tuple(hot.keys.shape), dtype=torch.int32,
                           device=DEV)
        total = int(st.n_term - st.n_marked)
        for t in WALK_EDGE_LANES:
            q = from_u64(walk_edge_queries(rng, keys, t), DEV)
            ref = skiplist_search_ref(q, lay)
            check(max_abs_err(torch, skiplist_search_tiles(q, lay), ref)
                  == 0, f"walk edges: skiplist_search differs from its "
                  f"plain version ({label}, T {t})")
            hits += int(ref[0].sum())
            ranks = (torch.arange(t, device=DEV) - 1
                     + (total - t // 2 if total > t else 0)).to(torch.int32)
            ranks[0] = -1
            mask = torch.from_numpy(rng.random(t) > 0.1).to(DEV).to(
                torch.int8)
            check(max_abs_err(torch, pq_pop_tiles(ranks, mask, lay),
                              pq_pop_ref(ranks, mask, lay)) == 0,
                  f"walk edges: pq_pop differs ({label}, T {t})")
            slots = hash_slot(q, hot.num_slots)
            for layout, wl in (("level", lay), ("block", blay)):
                args = (q, slots, hot.keys, wl, None)
                want = tier_find_planes_ref(*args)
                for team in tfk.TEAMS[layout]:
                    with forced_team(tfk, "find_team", team):
                        got = tier_find_tiles(*args)
                    check(max_abs_err(torch, got, want) == 0,
                          f"walk edges: tier_find differs ({label}, T {t}, "
                          f"{layout} team {team})")
                    widths[(layout, team)] += 1
            vals = q ^ 0x77
            lanes = torch.from_numpy(rng.random(t) > 0.1).to(DEV)
            _, ss, sk, _, sm, krs, srs = sorted_lanes(hot.num_slots, q, vals,
                                                      lanes)
            me = torch.tensor([t], dtype=torch.int32, device=DEV)
            args = (sk, ss, sm, krs, srs, hot.keys, meta, lay, me, None,
                    "lru")
            check(max_abs_err(torch, tier_apply_tiles(*args),
                              tier_apply_planes_ref(*args)) == 0,
                  f"walk edges: tier_apply differs ({label}, T {t})")
            n += 1
    check(hits > 0, "walk edges: some queries are found")
    print(f"walk edges: skiplist_search, pq_pop, tier_find and tier_apply "
          f"(level layout; tier_find also in the block layout, at every "
          f"team width of each) bit-identical on {n} (state, T) "
          f"cases, capacities {WALK_EDGE_CAPS}, T {WALK_EDGE_LANES}; "
          f"{hits} skiplist hits; tier_find cases by (layout, team) "
          f"{dict(sorted(widths.items()))}", flush=True)


# the redesigned kernels' edge sweep: tier_apply at 1 lane, at a width
# that is not a multiple of the scan tile (3 tiles and 9 lanes) and at a
# preload plan's; pq_pop on heaps whose capacities are not multiples of
# its chunk
TA_EDGE_LANES = (1, 3 * 256 + 9, 65536)
TA_EDGE_SLOTS = 64
TA_EDGE_BUCKET = 16
PQ_EDGE_CAPS = (1000, 70000)
PQ_EDGE_LANES = (1, 300, 4097)


def sorted_runs(torch, rng, sizes, dead_runs, pad):
    """Spill planes of sorted runs of fresh keys, one a size (0 = an empty
    run), a tenth of each longer run tombstoned and every cell of the runs
    in `dead_runs`; `pad` KEY_INF cells after them. Returns (SpillLayout,
    stored keys as uint64)."""
    from repro_torch.core.bits import from_u64, ordered
    from repro_torch.core.layout import SpillLayout
    parts, dead, off = [], [], [0]
    for r, n in enumerate(sizes):
        k = from_u64(rng.integers(1, 2**64 - 2, n, dtype=np.uint64), DEV)
        parts.append(k[torch.argsort(ordered(k))])
        d = torch.from_numpy((rng.random(n) < 0.1) & (n > 1)).to(DEV)
        dead.append(torch.ones_like(d) if r in dead_runs else d)
        off.append(off[-1] + n)
    keys = torch.cat(parts + [torch.full((pad,), -1, dtype=torch.int64,
                                         device=DEV)])
    dead = torch.cat(dead + [torch.zeros(pad, dtype=torch.bool, device=DEV)])
    lay = SpillLayout(keys=keys, dead=dead.to(torch.int8),
                      run_off=torch.tensor(off, dtype=torch.int32,
                                           device=DEV))
    return lay, keys[:off[-1]].cpu().numpy().view(np.uint64)


def tier_apply_edge_lanes(torch, rng, label, k, pool, same_slot):
    """k lanes of one edge case: "mixed" (stored keys and fresh ones),
    "one slot" (every lane in one hot slot, 3/4 of them distinct keys),
    "runs" (keys repeated 1 to 40 times, so key runs and slot runs cross
    the scan's tile boundaries). Returns (keys uint64, insert mask)."""
    if label == "mixed":
        keys = np.where(rng.random(k) < 0.75, rng.choice(pool, k),
                        rng.integers(1, 2**64 - 2, k, dtype=np.uint64))
    elif label == "one slot":
        keys = rng.choice(same_slot[:max(3 * k // 4, 1)], k)
    else:
        reps = rng.integers(1, 41, k)
        keys = np.repeat(rng.choice(pool, k), reps)[:k]
    return keys, rng.random(k) > 0.1


def tier_apply_edge_sweep(torch, rng):
    """tier_apply held bit for bit against its plain version in both warm
    layouts under none / lru / size at TA_EDGE_LANES lanes, on
    `tier_apply_edge_lanes`, with eviction caps 0, 1 and K (one cap under
    none), and with no spill tier, a spill tier whose runs are all empty,
    one run, and 64 runs (empty ones, a run of one cell, a run that is all
    tombstones). Then, in the level layout, at the widest plan of every
    membership team width that those lanes leave out (`member_team`; on
    an H100, 8, 4 and 1), mixed and one-slot lanes under lru and size,
    with no spill and 64 runs. Counts the cases that reach each boundary
    of the scan launch and of the team probes (each team width of each
    layout that some plan width takes), and requires each count > 0."""
    from repro_torch.core import det_skiplist as dsl
    from repro_torch.core import hashtable as ht
    from repro_torch.core.bits import from_u64
    from repro_torch.core.layout import (bskiplist_layout, hash_slot,
                                         skiplist_layout)
    from repro_torch.kernels import cuda
    from repro_torch.kernels.tier_apply.kernel import (LEVEL_TEAMS, TILE,
                                                       member_slots,
                                                       member_team,
                                                       tier_apply_tiles)
    from repro_torch.kernels.tier_apply.ops import sorted_lanes
    from repro_torch.kernels.tier_apply.ref import tier_apply_planes_ref
    sms = cuda.sm_count(torch.device(DEV))
    slots = functools.partial(member_slots, torch.device(DEV).index or 0)
    # warm: 3/4 of 4,096; hot: 64 slots of 16, most buckets full
    wkeys = np.unique(rng.integers(1, 2**64 - 2, 3200, dtype=np.uint64))
    wk = from_u64(wkeys[:3072], DEV)
    warm, _, _ = dsl.insert_batch(dsl.skiplist_init(4096, device=DEV), wk,
                                  wk ^ 0x5A5A)
    hot = ht.fixed_init(TA_EDGE_SLOTS, TA_EDGE_BUCKET, device=DEV)
    hk = from_u64(rng.integers(1, 2**64 - 2, 1500, dtype=np.uint64), DEV)
    hot, _, _ = ht.fixed_insert(hot, hk, hk + 1)
    meta = torch.from_numpy(rng.integers(0, 50, (TA_EDGE_SLOTS,
                                                 TA_EDGE_BUCKET),
                                         dtype=np.int32)).to(DEV)
    sizes64 = [int(x) for x in rng.integers(0, 400, 64)]
    sizes64[3], sizes64[5], sizes64[9] = 1, 0, 300
    spills = {"no spill": (None, np.zeros(0, np.uint64)),
              "empty runs": sorted_runs(torch, rng, [0] * 16, (), 64),
              "1 run": sorted_runs(torch, rng, [2000], (), 100),
              "64 runs": sorted_runs(torch, rng, sizes64, (9,), 100)}
    cand = rng.integers(1, 2**64 - 2, 1 << 22, dtype=np.uint64)
    slot0 = int(hash_slot(from_u64(cand[:1], DEV), TA_EDGE_SLOTS)[0])
    same_slot = cand[(hash_slot(from_u64(cand, DEV), TA_EDGE_SLOTS)
                      == slot0).cpu().numpy()]
    hot_np = hot.keys.reshape(-1).cpu().numpy().view(np.uint64)
    counts = dict(cases=0, key_run_straddles=0, slot_run_straddles=0,
                  all_one_slot=0, cap_binds=0, spill_hits=0,
                  hit_in_one_cell_run=0, preload_width=0)
    one_cell = int(np.cumsum([0] + sizes64)[3])
    # the widest plan of each level team width that some plan width takes
    # and the sweep's widths miss
    teams = {k: member_team(k, "level", sms, slots) for k in TA_EDGE_LANES}
    wide = {k: w for k, w in rule_plans(
        lambda k: member_team(k, "level", sms, slots), sms, slots,
        LEVEL_TEAMS).items() if w not in teams.values()}
    teams.update(wide)
    counts.update({f"level_team_{w}": 0 for w in set(teams.values())})
    counts["block_team_32"] = 0
    plan = [(sp_label, k, lanes, (("none", (k,)), ("lru", (k, 1, 0)),
                                  ("size", (k, 1, 0))), ("level", "block"))
            for sp_label in spills for k in TA_EDGE_LANES
            for lanes in ("mixed", "one slot", "runs")]
    plan += [(sp_label, k, lanes, (("lru", (1,)), ("size", (k,))),
              ("level",))
             for sp_label in ("no spill", "64 runs") for k in wide
             for lanes in ("mixed", "one slot")]
    lays = {"level": skiplist_layout(warm), "block": bskiplist_layout(warm)}
    for sp_label, k, lanes, policies, layouts in plan:
        sp, sp_keys = spills[sp_label]
        pool = np.concatenate([wkeys[:3072], hot_np[hot_np != 2**64 - 1],
                               sp_keys])
        keys, mask = tier_apply_edge_lanes(torch, rng, lanes, k, pool,
                                           same_slot)
        if sp_label == "64 runs" and lanes == "mixed":
            keys[0], mask[0] = sp_keys[one_cell], True
        q, m = from_u64(keys, DEV), torch.from_numpy(mask).to(DEV)
        _, ss, sk, _, sm, krs, srs = sorted_lanes(TA_EDGE_SLOTS, q, q ^ 0x77,
                                                  m)
        starts = torch.arange(TILE, max(k, TILE), TILE, device=DEV)
        counts["key_run_straddles"] += int((krs[starts] < starts).any())
        counts["slot_run_straddles"] += int((srs[starts] < starts).any())
        counts["all_one_slot"] += int(k > TILE and bool((srs == 0).all()))
        for policy, caps in policies:
            evicted = {}
            for cap_ev in caps:
                me = torch.tensor([cap_ev], dtype=torch.int32, device=DEV)
                for layout in layouts:
                    args = (sk, ss, sm, krs, srs, hot.keys, meta,
                            lays[layout], me, sp, policy)
                    got = tier_apply_tiles(*args)
                    want = tier_apply_planes_ref(*args)
                    check(max_abs_err(torch, got, want) == 0,
                          f"tier_apply edges: {layout}, {policy}, "
                          f"{sp_label}, {k} {lanes} lanes, cap {cap_ev} "
                          f"differs from its plain version")
                    counts["cases"] += 1
                    team = teams[k] if layout == "level" else 32
                    counts[f"{layout}_team_{team}"] += 1
                    counts["preload_width"] += int(k == TA_EDGE_LANES[-1])
                    counts["spill_hits"] += int(want[1].sum())
                    if sp_label == "64 runs":
                        cell = sk == from_u64(sp_keys[one_cell:one_cell + 1],
                                              DEV)
                        counts["hit_in_one_cell_run"] += int(
                            (want[1].bool() & cell).sum())
                    evicted[cap_ev] = int(want[5].sum())
            if len(caps) == 3 and evicted[k] > 1:
                counts["cap_binds"] += int(evicted[1] == 1
                                           and evicted[0] == 0)
    print("tier_apply edges: bit-identical in " + json.dumps(counts),
          flush=True)
    for name, n in counts.items():
        check(n > 0, f"tier_apply edges: no case reaches {name}")


TF_EDGE_LANES = (1, 777, 4096)


def tier_find_edge_sweep(torch, rng):
    """tier_find held bit for bit against its plain version in both warm
    layouts at TF_EDGE_LANES lanes and at the widest plan of every team
    width its rule picks (`rule_plans`), with no spill tier, a spill tier
    whose runs are all empty, one run, and 64 runs (empty ones, a run of
    one cell, a run that is all tombstones). The warm tier has a ragged
    last node (C = 4,000); the lanes mix stored keys of every tier and
    fresh ones, with 0, 2^64 - 2, KEY_INF, the one-cell run's key and a
    key of the tombstoned run first. Counts the cases of each team width
    and those that reach each tier's hits and the spill's edges, and
    requires each count > 0."""
    from repro_torch.core import det_skiplist as dsl
    from repro_torch.core import hashtable as ht
    from repro_torch.core.bits import from_u64
    from repro_torch.core.layout import (bskiplist_layout, hash_slot,
                                         skiplist_layout)
    from repro_torch.kernels import cuda
    from repro_torch.kernels.tier_find import kernel as tfk
    from repro_torch.kernels.tier_find.ref import tier_find_planes_ref
    dev = torch.device(DEV)
    sms = cuda.sm_count(dev)
    wkeys = np.unique(rng.integers(1, 2**64 - 2, 3100, dtype=np.uint64))[:3000]
    wk = from_u64(wkeys, DEV)
    warm, _, _ = dsl.insert_batch(dsl.skiplist_init(4000, device=DEV), wk,
                                  wk ^ 0x5A5A)
    hot = ht.fixed_init(TA_EDGE_SLOTS, TA_EDGE_BUCKET, device=DEV)
    hk = from_u64(rng.integers(1, 2**64 - 2, 1500, dtype=np.uint64), DEV)
    hot, _, _ = ht.fixed_insert(hot, hk, hk + 1)
    hot_np = hot.keys.reshape(-1).cpu().numpy().view(np.uint64)
    hot_np = hot_np[hot_np != 2**64 - 1]
    sizes64 = [int(x) for x in rng.integers(0, 400, 64)]
    sizes64[0], sizes64[3], sizes64[5], sizes64[9] = 0, 1, 0, 300
    spills = {"no spill": (None, np.zeros(0, np.uint64)),
              "empty runs": sorted_runs(torch, rng, [0] * 16, (), 64),
              "1 run": sorted_runs(torch, rng, [2000], (), 100),
              "64 runs": sorted_runs(torch, rng, sizes64, (9,), 100)}
    starts = np.cumsum([0] + sizes64)
    one_cell = spills["64 runs"][1][starts[3]]
    dead_run = spills["64 runs"][1][starts[9]:starts[10]]
    lays = {"level": skiplist_layout(warm), "block": bskiplist_layout(warm)}
    plan = []
    for layout in lays:
        slots = functools.partial(tfk.find_slots, dev.index or 0, layout)
        print(f"tier_find {layout}: resident threads an SM by team "
              + json.dumps({w: slots(w) for w in tfk.TEAMS[layout]}))
        teams = {k: tfk.find_team(k, layout, sms, slots)
                 for k in TF_EDGE_LANES}
        teams.update(rule_plans(lambda k: tfk.find_team(k, layout, sms,
                                                        slots),
                                sms, slots, tfk.TEAMS[layout]))
        plan += [(layout, k, team) for k, team in sorted(teams.items())]
    counts = collections.Counter({f"{layout}_team_{team}": 0
                                  for layout, _, team in plan})
    counts.update(dict.fromkeys(("cases", "hot_hits", "warm_hits",
                                 "spill_hits", "one_cell_run_hits",
                                 "tombstoned_run_misses", "key_inf_lanes",
                                 "empty_run_0", "preload_width"), 0))
    for layout, k, team in plan:
        for sp_label, (sp, sp_keys) in spills.items():
            pool = np.concatenate([wkeys, hot_np, sp_keys])
            keys = np.where(rng.random(k) < 0.75, rng.choice(pool, k),
                            rng.integers(1, 2**64 - 2, k, dtype=np.uint64))
            special = np.array([0, 2**64 - 2, 2**64 - 1, one_cell,
                                dead_run[0]], np.uint64)
            keys[:min(k, 5)] = special[:min(k, 5)]
            q = from_u64(keys, DEV)
            args = (q, hash_slot(q, TA_EDGE_SLOTS), hot.keys, lays[layout],
                    sp)
            want = tier_find_planes_ref(*args)
            check(tfk.find_team(k, layout, sms, functools.partial(
                tfk.find_slots, dev.index or 0, layout)) == team,
                  "tier_find edges: the plan's team width")
            got = tfk.tier_find_tiles(*args)
            check(max_abs_err(torch, got, want) == 0,
                  f"tier_find edges: {layout} team {team}, {sp_label}, {k} "
                  f"lanes differs from its plain version")
            counts["cases"] += 1
            counts[f"{layout}_team_{team}"] += 1
            counts["hot_hits"] += int(want[0].sum())
            counts["warm_hits"] += int(want[2].sum())
            counts["key_inf_lanes"] += int((q == -1).sum())
            counts["preload_width"] += int(k >= PRELOAD_LANES)
            if sp is not None:
                counts["spill_hits"] += int(want[4].sum())
                counts["empty_run_0"] += int(sp_label == "64 runs")
            if sp_label == "64 runs":
                hit = want[4].bool()
                counts["one_cell_run_hits"] += int(
                    (hit & (q == int(one_cell.view(np.int64)))).sum())
                counts["tombstoned_run_misses"] += int(
                    (~hit & (q == int(dead_run[:1].view(np.int64)[0])))
                    .sum())
    print("tier_find edges: bit-identical in " + json.dumps(counts),
          flush=True)
    for name, n in counts.items():
        check(n > 0, f"tier_find edges: no case reaches {name}")


def bskiplist_edge_sweep(torch, rng):
    """bskiplist_walk held bit for bit against its plain version on
    `walk_edge_states` (empty, 3/4 full and all tombstoned at 16, 100 and
    4,096 cells: ragged last nodes, one node, several), at WALK_EDGE_LANES
    lanes and at the widest plan of every team width its rule picks
    (`rule_plans`), on `walk_edge_queries`. Counts the cases of each team
    width, the hits and the KEY_INF lanes, and requires each count > 0."""
    from repro_torch.core.bits import from_u64
    from repro_torch.core.layout import bskiplist_layout
    from repro_torch.kernels import cuda
    from repro_torch.kernels.bskiplist_walk import kernel as bwk
    from repro_torch.kernels.bskiplist_walk.ref import bskiplist_walk_ref
    dev = torch.device(DEV)
    sms = cuda.sm_count(dev)
    slots = functools.partial(bwk.walk_slots, dev.index or 0)
    print("bskiplist_walk: resident threads an SM by team "
          + json.dumps({w: slots(w) for w in bwk.TEAMS}))
    teams = {k: bwk.walk_team(k, sms, slots) for k in WALK_EDGE_LANES}
    teams.update(rule_plans(lambda k: bwk.walk_team(k, sms, slots), sms,
                            slots, bwk.TEAMS))
    counts = collections.Counter({f"team_{w}": 0 for w in teams.values()})
    counts.update(cases=0, hits=0, key_inf_lanes=0)
    for label, st, keys in walk_edge_states(torch, rng):
        lay = bskiplist_layout(st)
        for k, team in sorted(teams.items()):
            q = from_u64(walk_edge_queries(rng, keys, k), DEV)
            want = bskiplist_walk_ref(q, lay)
            check(max_abs_err(torch, bwk.bskiplist_walk_tiles(q, lay), want)
                  == 0, f"bskiplist edges: {label}, {k} lanes (team "
                  f"{team}) differs from its plain version")
            counts["cases"] += 1
            counts[f"team_{team}"] += 1
            counts["hits"] += int(want[0].sum())
            counts["key_inf_lanes"] += int((q == -1).sum())
    print("bskiplist_walk edges: bit-identical in " + json.dumps(counts),
          flush=True)
    for name, n in counts.items():
        check(n > 0, f"bskiplist edges: no case reaches {name}")


# the redesigned single probes' edge sweeps: a bucket plane of a slot count
# that is no power of two at the main path's width and at a ragged one;
# split-order planes at the main path's row shape and at a ragged one
HP_EDGE_SLOTS = 100
HP_EDGE_BUCKETS = (16, 5)
SO_EDGE_SHAPES = ((8, 512), (5, 300))   # (tables, C2)
PROBE_EDGE_LANES = (1, 33, 4097)


def probe_edge_plans(name, module, sms: int, slots) -> list:
    """(lanes, team) of a single probe's edge sweep: PROBE_EDGE_LANES and
    the widest plan of every width its rule picks (`rule_plans`), each at
    the rule's team; printed with each instance's resident threads."""
    rule = functools.partial(module.probe_team, sms=sms, slots=slots)
    print(f"{name}: resident threads an SM by team "
          + json.dumps({w: slots(w) for w in module.TEAMS}) + "; the rule "
          f"picks {rule(WL_LANES)} at {WL_LANES} lanes, "
          f"{rule(PRELOAD_LANES)} at {PRELOAD_LANES}", flush=True)
    plans = {k: rule(k) for k in PROBE_EDGE_LANES}
    plans.update(rule_plans(rule, sms, slots, module.TEAMS))
    return sorted(plans.items())


def probe_edge_run(torch, module, counts, label, k, team, fn, want):
    """Run a single probe at k lanes under its rule (which must pick
    `team`) and forced to each of its widths, each bit for bit against
    `want`; counts the cases, each width's and the warps with a tail."""
    from repro_torch.kernels import cuda
    dev = torch.device(DEV)
    check(module.probe_team(k, cuda.sm_count(dev), functools.partial(
        module.probe_slots, dev.index or 0)) == team,
          f"{label}: the plan's team width")
    for forced in (None,) + module.TEAMS:
        if forced is None:
            got, w = fn(), team
        else:
            with forced_team(module, "probe_team", forced):
                got, w = fn(), forced
        check(max_abs_err(torch, got, want) == 0, f"{label}, {k} lanes, "
              f"team {w}{'' if forced else ' (rule)'} differs from its plain "
              f"version")
        counts["cases"] += 1
        counts[f"team_{w}"] += 1
        counts["warp_tail"] += int(k * w % 32 != 0)
        counts["lanes_not_multiple_of_32"] += int(k % 32 != 0)


def special_lanes(torch, counts, specials, want, k):
    """Check the first min(k, len(specials)) lanes' plain results against
    what each special lane must give, (tag, (found, col or at)), and count
    each tag reached."""
    n = min(k, len(specials))
    got = [(int(f), int(c)) for f, c in zip(want[0][:n].tolist(),
                                            want[1][:n].tolist())]
    for (tag, expect), g in zip(specials[:n], got):
        check(g == expect, f"edge lane {tag}: {g}, expected {expect}")
        counts[tag] += 1


def hash_probe_edge_table(rng, b):
    """A [HP_EDGE_SLOTS, b] key plane (uint64), rows filled from column 0
    with 0 to b fresh keys, KEY_INF after: row 0 full, row 1 all KEY_INF,
    row 2 with a key at column 0, row 3 full, row 4 with one key at
    columns 1 and b - 2, the last row full."""
    m = HP_EDGE_SLOTS
    plane = rng.integers(1, 2**64 - 2, (m, b), dtype=np.uint64)
    fill = rng.integers(0, b + 1, m)
    fill[[0, 3, m - 1]], fill[1], fill[4] = b, 0, b
    fill[2] = max(fill[2], 1)
    plane[np.arange(b)[None, :] >= fill[:, None]] = np.uint64(2**64 - 1)
    plane[4, b - 2] = plane[4, 1]
    return plane


def hash_probe_edge_sweep(torch, rng):
    """hash_probe held bit for bit against its plain version on
    `hash_probe_edge_table` at each of HP_EDGE_BUCKETS, at every
    `probe_edge_plans` width, forced to each team width too. The first
    lanes are the edges, each checked for the result it must give: a hit
    at column 0 and at the last column, a key held twice in a row (the
    lowest column wins), a full row's hit and miss, an all-KEY_INF row's
    miss, slots below 0 and past M - 1 (clipped), KEY_INF queries on an
    all-KEY_INF and on a full row; then stored keys at their slots and
    fresh keys. Counts the cases that reach each edge and requires every
    count > 0."""
    from repro_torch.core.bits import from_u64
    from repro_torch.kernels import cuda
    from repro_torch.kernels.hash_probe import kernel as hpk
    from repro_torch.kernels.hash_probe.ref import hash_probe_ref
    dev = torch.device(DEV)
    m = HP_EDGE_SLOTS
    plans = probe_edge_plans("hash_probe", hpk, cuda.sm_count(dev),
                             functools.partial(hpk.probe_slots,
                                               dev.index or 0))
    counts = collections.Counter({f"team_{w}": 0 for w in hpk.TEAMS})
    inf = np.uint64(2**64 - 1)
    for b in HP_EDGE_BUCKETS:
        plane = hash_probe_edge_table(rng, b)
        keys = from_u64(plane.reshape(-1), DEV).reshape(m, b)
        fresh = rng.integers(1, 2**64 - 2, 2, dtype=np.uint64)
        specials = [  # (query, slot, tag, (found, col))
            (plane[2, 0], 2, "hit_col_0", (1, 0)),
            (plane[3, b - 1], 3, "hit_last_col", (1, b - 1)),
            (plane[4, 1], 4, "lowest_of_two", (1, 1)),
            (plane[0, b // 2], 0, "full_row_hit", (1, b // 2)),
            (fresh[0], 0, "full_row_miss", (0, 0)),
            (fresh[1], 1, "empty_row_miss", (0, 0)),
            (plane[0, 1], -5, "slot_below_0", (1, 1)),
            (plane[0, 2], -2**31, "slot_below_0", (1, 2)),
            (plane[m - 1, b - 1], m + 7, "slot_past_m", (1, b - 1)),
            (inf, 1, "key_inf_on_empty_row", (1, 0)),
            (inf, 0, "key_inf_on_full_row", (0, 0))]
        stored = np.argwhere(plane != inf)
        for k, team in plans:
            pick = stored[rng.integers(0, len(stored), k)]
            qn = np.where(rng.random(k) < 0.75, plane[pick[:, 0], pick[:, 1]],
                          rng.integers(1, 2**64 - 2, k, dtype=np.uint64))
            sn = np.where(rng.random(k) < 0.75, pick[:, 0],
                          rng.integers(0, m, k)).astype(np.int32)
            n = min(k, len(specials))
            qn[:n] = [x[0] for x in specials[:n]]
            sn[:n] = [x[1] for x in specials[:n]]
            q = from_u64(qn, DEV)
            slots = torch.from_numpy(sn).to(DEV)
            want = hash_probe_ref(q, slots, keys)
            special_lanes(torch, counts, [(x[2], x[3]) for x in specials],
                          want, k)
            probe_edge_run(torch, hpk, counts, f"hash_probe edges: B {b}",
                           k, team,
                           lambda a=(q, slots, keys): hpk.hash_probe_tiles(
                               *a), want)
            counts["hits"] += int(want[0].sum())
            counts["ragged_bucket"] += int(b != 16)
    print("hash_probe edges: bit-identical in " + json.dumps(counts),
          flush=True)
    for name, n in counts.items():
        check(n > 0, f"hash_probe edges: no case reaches {name}")


def splitorder_edge_planes(torch, rng, n_tables, c2):
    """rk and key planes [n_tables, c2] (int64 on the card, and the rk and
    keys as uint64): table 0 full, table 1 empty (KEY_INF), the rest 3/4
    full, each row sorted by rk with KEY_INF padding last; in table 2 a run
    of 5 cells sharing one rk at c2 // 4, and table 0's last 3 cells
    sharing one rk, their keys all different."""
    from repro_torch.core.bits import from_u64
    inf = np.uint64(2**64 - 1)
    rk = np.sort(rng.integers(1, 2**64 - 2, (n_tables, c2), dtype=np.uint64),
                 axis=1)
    keys = rng.integers(1, 2**64 - 2, (n_tables, c2), dtype=np.uint64)
    fill = np.full(n_tables, 3 * c2 // 4)
    fill[0], fill[1] = c2, 0
    pad = np.arange(c2)[None, :] >= fill[:, None]
    rk[pad], keys[pad] = inf, inf
    a = c2 // 4
    rk[2, a:a + 5] = rk[2, a]
    rk[0, c2 - 3:] = rk[0, c2 - 3]
    dev = lambda x: from_u64(x.reshape(-1), DEV).reshape(n_tables, c2)
    return dev(rk), dev(keys), rk, keys, fill


def splitorder_edge_sweep(torch, rng):
    """splitorder_probe held bit for bit against its plain version on
    `splitorder_edge_planes` at each of SO_EDGE_SHAPES, at every
    `probe_edge_plans` width, forced to each team width too. The first
    lanes are the edges, each checked for the result it must give: a query
    below every rk of a table and above every rk of it, a hit in the full
    table and a query of the empty table, table indices -1 and T
    (clipped), the 5 lanes of the collision run (the first 4 found in the
    window, the 5th not), KEY_INF rk queries (the empty table's padding
    cell matches a KEY_INF key), and positions within 3 cells of C2 - 1,
    where the window clips (a hit behind a clipped cell, and a query past
    the full table's last rk); then stored (rk, key, table) triples and
    fresh ones. Counts the cases that reach each edge and requires every
    count > 0."""
    from repro_torch.core.bits import from_u64
    from repro_torch.kernels import cuda
    from repro_torch.kernels.splitorder_probe import kernel as sok
    from repro_torch.kernels.splitorder_probe.ref import splitorder_probe_ref
    dev = torch.device(DEV)
    plans = probe_edge_plans("splitorder_probe", sok, cuda.sm_count(dev),
                             functools.partial(sok.probe_slots,
                                               dev.index or 0))
    counts = collections.Counter({f"team_{w}": 0 for w in sok.TEAMS})
    inf, top = np.uint64(2**64 - 1), np.uint64(2**64 - 2)
    for n_tables, c2 in SO_EDGE_SHAPES:
        rk_t, keys_t, rk, keys, fill = splitorder_edge_planes(
            torch, rng, n_tables, c2)
        a, e, last = c2 // 4, c2 - 3, n_tables - 1
        fresh = rng.integers(1, 2**64 - 2, 4, dtype=np.uint64)
        specials = [  # (rk, key, table, tag, (found, at))
            (np.uint64(0), fresh[0], 3, "below_every_rk", (0, 0)),
            (top, fresh[1], 3, "above_every_rk", (0, int(fill[3]))),
            (rk[0, c2 // 2], keys[0, c2 // 2], 0, "full_table_hit",
             (1, c2 // 2)),
            (fresh[2], fresh[3], 1, "empty_table_miss", (0, 0)),
            (rk[0, 5], keys[0, 5], -1, "table_minus_1", (1, 5)),
            (rk[last, 7], keys[last, 7], n_tables, "table_T", (1, 7))]
        specials += [(rk[2, a], keys[2, a + j], 2, f"collision_{j}",
                      (1, a + j) if j < 4 else (0, a)) for j in range(5)]
        specials += [
            (inf, inf, 1, "key_inf_rk_padding_match", (1, 0)),
            (inf, fresh[0], 3, "key_inf_rk_miss", (0, int(fill[3]))),
            (rk[0, e], keys[0, c2 - 1], 0, "window_clips_hit", (1, c2 - 1)),
            (rk[0, e], fresh[1], 0, "window_clips_miss", (0, e)),
            (top, fresh[2], 0, "past_last_rk_of_full_table", (0, c2 - 1))]
        stored = np.argwhere(rk != inf)
        for k, team in plans:
            pick = stored[rng.integers(0, len(stored), k)]
            hit = rng.random(k) < 0.75
            qr = np.where(hit, rk[pick[:, 0], pick[:, 1]],
                          rng.integers(1, 2**64 - 2, k, dtype=np.uint64))
            qk = np.where(hit, keys[pick[:, 0], pick[:, 1]],
                          rng.integers(1, 2**64 - 2, k, dtype=np.uint64))
            tb = np.where(hit, pick[:, 0],
                          rng.integers(0, n_tables, k)).astype(np.int32)
            n = min(k, len(specials))
            qr[:n] = [x[0] for x in specials[:n]]
            qk[:n] = [x[1] for x in specials[:n]]
            tb[:n] = [x[2] for x in specials[:n]]
            args = (from_u64(qr, DEV), from_u64(qk, DEV),
                    torch.from_numpy(tb).to(DEV), rk_t, keys_t)
            want = splitorder_probe_ref(*args)
            special_lanes(torch, counts, [(x[3], x[4]) for x in specials],
                          want, k)
            probe_edge_run(torch, sok, counts, f"splitorder_probe edges: "
                           f"{n_tables} x {c2}", k, team,
                           lambda a=args: sok.splitorder_probe_tiles(*a),
                           want)
            counts["hits"] += int(want[0].sum())
            counts["ragged_row"] += int(c2 & (c2 - 1) != 0)
    print("splitorder_probe edges: bit-identical in " + json.dumps(counts),
          flush=True)
    for name, n in counts.items():
        check(n > 0, f"splitorder_probe edges: no case reaches {name}")


def pq_edge_heaps(torch, rng):
    """Heaps for pq_pop's edges, each (label, state): at each of
    PQ_EDGE_CAPS cells, one nearly full (its last live cell in the last
    chunk), one with a tombstone run of 3/5 of it at its head (over many
    chunks and scan tiles), and one with every cell tombstoned."""
    from repro_torch.core import det_skiplist as dsl
    from repro_torch.core.bits import from_u64
    for cap in PQ_EDGE_CAPS:
        n = cap - 7
        keys = from_u64(np.unique(rng.integers(1, 2**63, n + 64,
                                               dtype=np.uint64))[:n], DEV)
        s, _, _ = dsl.insert_batch(dsl.skiplist_init(cap, device=DEV), keys,
                                   keys + 5)
        yield f"C {cap} full", s
        live = torch.arange(cap, device=DEV) < s.n_term
        head = live & (torch.arange(cap, device=DEV) < 3 * cap // 5)
        yield (f"C {cap} head run", s._replace(
            term_mark=s.term_mark | head, n_marked=head.sum()))
        yield (f"C {cap} all tombstoned", s._replace(
            term_mark=s.term_mark | live, n_marked=s.n_term))


def pq_stop_expected(torch, ranks, mask, lay, chunk):
    """The stop index the scan must publish: the first chunk whose
    inclusive live count reaches want_max, every chunk's last one when
    want_max exceeds the live total, -1 when it is 0."""
    want = ranks.long() + 1
    want = torch.where((mask != 0) & (want >= 1), want, 0)
    wm = int(want.max()) if want.numel() else 0
    tk, tm = lay.term_keys, lay.term_mark
    live = ((tm == 0) & (tk != -1)).long()
    chunks = -(-tk.numel() // chunk)
    per = torch.zeros(chunks * chunk, dtype=torch.long, device=tk.device)
    per[:tk.numel()] = live
    incl = torch.cumsum(per.reshape(chunks, chunk).sum(1), 0)
    if wm == 0:
        return -1, wm, incl
    reach = (incl >= wm).nonzero()
    return (int(reach[0]) if reach.numel() else chunks - 1), wm, incl


def pq_edge_sweep(torch, rng):
    """pq_pop held bit for bit against its plain version on
    `pq_edge_heaps` at PQ_EDGE_LANES lanes, rank sets: no lane masked in,
    every masked-in rank -1, want_max in the first chunk, in the last
    chunk, exactly at a chunk's end, and ranks past the live total; the
    stop index the scan published (read from the wrapper's scratch) equals
    `pq_stop_expected`. Counts the cases that reach each boundary and
    requires each count > 0."""
    from repro_torch.core.layout import skiplist_layout
    from repro_torch.kernels.pq_pop import kernel as pq
    counts = dict(cases=0, nothing_needed=0, stop_first_chunk=0,
                  stop_last_chunk=0, stop_on_chunk_end=0, past_total=0,
                  all_tombstoned=0, head_run_over_tiles=0)
    for label, st in pq_edge_heaps(torch, rng):
        lay = skiplist_layout(st)
        total = int(st.n_term - st.n_marked)
        for t in PQ_EDGE_LANES:
            _, _, incl = pq_stop_expected(
                torch, torch.zeros(1, dtype=torch.int32, device=DEV),
                torch.ones(1, dtype=torch.int8, device=DEV), lay,
                pq.PQ_CHUNK)
            ends = incl[(incl > 0) & (incl < total)]
            end = int(ends[len(ends) // 2]) if ends.numel() else 1
            base = torch.from_numpy(rng.integers(0, max(total, 1), t)
                                    .astype(np.int32)).to(DEV)
            sets = {"no lane": (base, 0.0), "all -1": (base * 0 - 1, 1.0),
                    "first chunk": (base.clamp(max=3), 0.9),
                    "last chunk": (base.clamp(min=max(total - 1, 0)), 0.9),
                    "chunk end": (base.clamp(max=end - 1), 0.9),
                    "past total": (base + total // 2 + 1, 0.9)}
            for name, (ranks, share) in sets.items():
                ranks = ranks.to(torch.int32).contiguous()
                mask = torch.from_numpy(rng.random(t) < share).to(DEV).to(
                    torch.int8)
                if share > 0:
                    mask[0] = 1
                    if name == "chunk end":
                        ranks[0] = end - 1
                got = pq.pq_pop_tiles(ranks, mask, lay)
                check(max_abs_err(torch, got, pq.pq_pop_ref(ranks, mask, lay))
                      == 0, f"pq_pop edges: {label}, T {t}, {name} differs "
                      f"from its plain version")
                want_stop, wm, _ = pq_stop_expected(torch, ranks, mask, lay,
                                                    pq.PQ_CHUNK)
                if ranks.is_cuda:
                    entry = pq._SCRATCH[(ranks.device.index, torch.cuda
                                         .current_stream().cuda_stream)]
                    w = int(entry[0][pq.STOP_WORD]) & ((1 << 64) - 1)
                    stop = ((w & 0xFFFFFFFF) - 1 if (w >> 34) == entry[1]
                            else None)
                    check(stop == want_stop, f"pq_pop edges: {label}, T "
                          f"{t}, {name}: stop {stop}, expected {want_stop}")
                chunks = incl.numel()
                counts["cases"] += 1
                counts["nothing_needed"] += int(want_stop == -1)
                counts["stop_first_chunk"] += int(want_stop == 0)
                counts["stop_last_chunk"] += int(want_stop == chunks - 1)
                counts["stop_on_chunk_end"] += int(
                    want_stop >= 0 and int(incl[want_stop]) == wm)
                counts["past_total"] += int(wm > total)
                counts["all_tombstoned"] += int(total == 0 and wm > 0)
                counts["head_run_over_tiles"] += int(
                    "head run" in label and want_stop
                    >= 2 * pq.PQ_TILE)
    print("pq_pop edges: bit-identical in " + json.dumps(counts), flush=True)
    for name, n in counts.items():
        check(n > 0, f"pq_pop edges: no case reaches {name}")


def kernel_phase(torch, seed: int):
    """Returns the rows of the eleven kernels (the tier kernels in the level
    layout); the block-layout rows of tier_find and tier_apply are
    printed. The bound of a block walk (bskiplist_walk, the block rows) is
    the smaller of its own and the level walk's on the same state and
    queries: both walks give the same answers, so the cheaper one is what
    the work needs."""
    from repro_torch.core.bits import from_u64, ordered
    from repro_torch.core.layout import (bskiplist_layout, hash_slot,
                                         skiplist_layout, spill_layout)
    from repro_torch.kernels.bskiplist_walk.kernel import bskiplist_walk_tiles
    from repro_torch.kernels.bskiplist_walk.ref import bskiplist_walk_ref
    from repro_torch.kernels.hash_probe.kernel import hash_probe_tiles
    from repro_torch.kernels.hash_probe.ref import hash_probe_ref
    from repro_torch.kernels.pq_pop.kernel import pq_pop_tiles
    from repro_torch.kernels.pq_pop.ref import pq_pop_ref
    from repro_torch.kernels.skiplist_search.kernel import skiplist_search_tiles
    from repro_torch.kernels.skiplist_search.ref import skiplist_search_ref
    from repro_torch.kernels.tier_apply.kernel import tier_apply_tiles
    from repro_torch.kernels.tier_apply.ops import sorted_lanes
    from repro_torch.kernels.tier_apply.ref import tier_apply_planes_ref
    from repro_torch.kernels.tier_find.kernel import tier_find_tiles
    from repro_torch.kernels.tier_find.ref import tier_find_planes_ref
    from repro_torch.store import exec as exec_
    # the edge sweeps draw from their own generators, so every row's
    # inputs stay those of the seed alone
    walk_edge_sweep(torch, np.random.default_rng([seed, 1]))
    tier_apply_edge_sweep(torch, np.random.default_rng([seed, 3]))
    tier_find_edge_sweep(torch, np.random.default_rng([seed, 8]))
    bskiplist_edge_sweep(torch, np.random.default_rng([seed, 9]))
    hash_probe_edge_sweep(torch, np.random.default_rng([seed, 10]))
    splitorder_edge_sweep(torch, np.random.default_rng([seed, 11]))
    pq_edge_sweep(torch, np.random.default_rng([seed, 4]))
    rng = np.random.default_rng(seed)
    keys, flat, table, t3, t2 = build_kernel_inputs(torch, rng)
    torch.cuda.synchronize()
    T = WL_LANES
    q = from_u64(mixed_keys(rng, keys, T), DEV)
    q[5] = -1                                       # KEY_INF query
    rows, block_rows = {}, {}

    def replay_matches(got, replayed, name):
        check(max_abs_err(torch, got, replayed) == 0,
              f"{name}: the bound's replay differs from the kernel")

    # skiplist_search
    lay = skiplist_layout(flat)
    got = skiplist_search_tiles(q, lay)
    ref = skiplist_search_ref(q, lay)
    err = max_abs_err(torch, got, ref)
    check(err == 0, "skiplist_search differs from its plain version")
    check(int(got[0].sum()) > T // 2, "skiplist_search finds stored keys")
    level_found = got[0]
    reads = Reads()
    replay_matches(got, walk_reads(torch, reads, q, lay), "skiplist_search")
    oterm, oq = ordered(flat.term_keys), ordered(q)
    rows["skiplist_search"] = dict(
        max_abs_err=err,
        ms=median_ms(torch, lambda: skiplist_search_tiles(q, lay)),
        plain_ms=median_ms(torch, lambda: skiplist_search_ref(q, lay), 5),
        library_ms=median_ms(torch, lambda: torch.searchsorted(oterm, oq)),
        dispatch_ms=median_ms(torch, lambda: exec_.skiplist_find(
            flat, q, mode="gpu")),
        bound=bound(torch, reads, T * (8 + 1 + 4)
                    + 4 * len(lay.offsets)))

    # bskiplist_walk, on the same skiplist and queries
    blay = bskiplist_layout(flat)
    got = bskiplist_walk_tiles(q, blay)
    err = max_abs_err(torch, got, bskiplist_walk_ref(q, blay))
    check(err == 0, "bskiplist_walk differs from its plain version")
    check(torch.equal((got[0] != 0) & (q != -1), (level_found != 0)
                      & (q != -1)), "bskiplist_walk finds what "
          "skiplist_search finds")
    reads = Reads()
    replay_matches(got, block_reads(torch, reads, q, blay), "bskiplist_walk")
    rows["bskiplist_walk"] = dict(
        max_abs_err=err,
        ms=median_ms(torch, lambda: bskiplist_walk_tiles(q, blay)),
        plain_ms=median_ms(torch, lambda: bskiplist_walk_ref(q, blay), 5),
        library_ms=median_ms(torch, lambda: torch.searchsorted(oterm, oq)),
        dispatch_ms=median_ms(torch, lambda: exec_.bskiplist_find(
            flat, q, mode="gpu")),
        bound=bound(torch, reads, T * (8 + 1 + 4)))
    print(f"bskiplist_walk: {blay.num_levels} index rows of "
          f"{blay.blk.shape[1]} cells", flush=True)

    # hash_probe
    slots = hash_slot(q, table.num_slots)
    got = hash_probe_tiles(q, slots, table.keys)
    err = max_abs_err(torch, got, hash_probe_ref(q, slots, table.keys))
    check(err == 0, "hash_probe differs from its plain version")
    reads = Reads()
    replay_matches(got, bucket_reads(torch, reads, q, slots, table.keys,
                                     False), "hash_probe")
    rows["hash_probe"] = dict(
        max_abs_err=err,
        ms=median_ms(torch, lambda: hash_probe_tiles(q, slots, table.keys)),
        plain_ms=median_ms(torch, lambda: hash_probe_ref(q, slots,
                                                         table.keys), 5),
        library_ms=None,
        dispatch_ms=median_ms(torch, lambda: exec_.hash_find_cols(
            table, q, mode="gpu")),
        bound=bound(torch, reads, T * (8 + 4 + 1 + 4)))

    # tier_find, with and without spill, in both warm layouts
    for st, label in ((t3, "spill"), (t2, "no spill")):
        slots = hash_slot(q, st.hot.num_slots)
        sp = (None if st.spill is None else
              spill_layout(st.spill.keys, st.spill.dead, st.spill.run_start,
                           st.spill.n))
        outs = {}
        for warm_layout, wl in (("level", skiplist_layout(st.cold)),
                                ("block", bskiplist_layout(st.cold))):
            got = tier_find_tiles(q, slots, st.hot.keys, wl, sp)
            err = max_abs_err(torch, got, tier_find_planes_ref(
                q, slots, st.hot.keys, wl, sp))
            check(err == 0, f"tier_find ({label}, {warm_layout}) differs "
                  f"from its plain version")
            outs[warm_layout] = got
            if sp is None:
                continue
            check(all(int(got[i].sum()) > 0 for i in (0, 2, 4)),
                  "tier_find hits every tier")
            bnd, replayed = tier_find_bound(torch, q, slots, st.hot.keys,
                                            wl, sp, warm_layout)
            replay_matches(got, replayed, "tier_find")
            (rows if warm_layout == "level" else block_rows)["tier_find"] = \
                dict(max_abs_err=err,
                     ms=median_ms(torch, lambda: tier_find_tiles(
                         q, slots, st.hot.keys, wl, sp)),
                     plain_ms=median_ms(torch, lambda: tier_find_planes_ref(
                         q, slots, st.hot.keys, wl, sp), 5),
                     library_ms=None,
                     dispatch_ms=median_ms(torch, lambda: exec_.tier_find(
                         st.hot, st.cold, st.spill, q, mode="gpu",
                         warm_layout=warm_layout)),
                     bound=bnd)
        # raw outputs: the two walks agree on every hit; a KEY_INF query's
        # raw warm bit is the layout's own (the glue masks it)
        lv, bk = outs["level"], outs["block"]
        lf, bf = (lv[2] != 0) & (q != -1), (bk[2] != 0) & (q != -1)
        check(all(torch.equal(lv[i], bk[i]) for i in range(len(lv))
                  if i not in (2, 3))
              and torch.equal(lf, bf)
              and torch.equal(torch.where(lf, lv[3], 0),
                              torch.where(bf, bk[3], 0)),
              f"tier_find ({label}): the block layout differs from the "
              f"level layout")
        print(f"tier_find {label}: bit-identical, both layouts", flush=True)

    # tier_apply: none / lru / size, with and without spill, both layouts
    vals = from_u64(rng.integers(0, 2**64 - 1, T, dtype=np.uint64), DEV)
    mask = torch.from_numpy(rng.random(T) > 0.05).to(DEV)
    for st, label in ((t3, "spill"), (t2, "no spill")):
        inv, ss, sk, sv, sm, krs, srs = sorted_lanes(st.hot.num_slots, q,
                                                     vals, mask)
        sp = (None if st.spill is None else
              spill_layout(st.spill.keys, st.spill.dead, st.spill.run_start,
                           st.spill.n))
        warms = {"level": skiplist_layout(st.cold),
                 "block": bskiplist_layout(st.cold)}
        for policy in ("none", "lru", "size"):
            for cap_ev in (T, 64):
                me = torch.tensor([cap_ev], dtype=torch.int32, device=DEV)
                outs = {}
                for warm_layout, wl in warms.items():
                    args = (sk, ss, sm, krs, srs, st.hot.keys, st.hot_meta,
                            wl, me, sp, policy)
                    got = tier_apply_tiles(*args)
                    err = max_abs_err(torch, got,
                                      tier_apply_planes_ref(*args))
                    check(err == 0, f"tier_apply ({policy}, {label}, cap "
                          f"{cap_ev}, {warm_layout}) differs from its "
                          f"plain version")
                    outs[warm_layout] = got
                    if policy != "lru" or sp is None or cap_ev != T:
                        continue
                    bnd, in_warm = tier_apply_bound(
                        torch, sk, ss, sm, st.hot.keys, st.hot_meta, wl, sp,
                        warm_layout)
                    check(torch.equal(got[0].bool(), in_warm),
                          "tier_apply: the bound's replay differs")
                    (rows if warm_layout == "level"
                     else block_rows)["tier_apply"] = dict(
                        max_abs_err=err,
                        ms=median_ms(torch, lambda: tier_apply_tiles(*args)),
                        plain_ms=median_ms(
                            torch, lambda: tier_apply_planes_ref(*args), 5),
                        library_ms=None,
                        dispatch_ms=median_ms(torch, lambda: exec_.tier_apply(
                            st.hot, st.hot_meta, st.clock, st.cold, st.spill,
                            q, vals, mask, policy, me, mode="gpu",
                            warm_layout=warm_layout)),
                        bound=bnd)
                check(max_abs_err(torch, outs["block"], outs["level"]) == 0,
                      f"tier_apply ({policy}, {label}, cap {cap_ev}): the "
                      f"block layout differs from the level layout")
                got = outs["block"]
                if policy != "none" and cap_ev == T:
                    check(int(got[5].sum()) > 0, "some lanes evict")
                print(f"tier_apply {policy} {label} cap={cap_ev}: "
                      f"bit-identical, both layouts (placed "
                      f"{int(got[2].sum())}, evict {int(got[5].sum())})",
                      flush=True)
    shapes = tier_shapes(torch, np.random.default_rng([seed, 5]), keys, t3,
                         t2)
    del t3, t2
    probes = probe_rows(torch, np.random.default_rng([seed, 7]), keys, flat,
                        table)
    del flat, table
    torch.cuda.empty_cache()
    more_tiers, more_probes = shard_shapes(torch,
                                           np.random.default_rng([seed, 12]))
    shapes.update(more_tiers)
    probes.update(more_probes)

    # pq_pop: a heap with a tombstone run at its head; a plan's pop lanes
    # (ranks 0..T/2-1 in a seeded lane order, the rest masked off), then
    # ranks straddling the live total, -1 ranks and masked-off lanes
    heap = build_pq_heap(torch, rng)
    lay = skiplist_layout(heap)
    total = int(heap.n_term - heap.n_marked)
    pop = torch.from_numpy(rng.permutation(T) < T // 2).to(DEV)
    ranks = torch.cumsum(pop.to(torch.int32), 0, dtype=torch.int32) - 1
    m8 = pop.to(torch.int8)
    ranks_x = (total - T // 2 + torch.arange(T, device=DEV)).to(torch.int32)
    ranks_x[:8] = -1
    mask_x = torch.from_numpy(rng.random(T) > 0.1).to(DEV).to(torch.int8)
    errs = []
    for r, m, label in ((ranks, m8, "plan"), (ranks_x, mask_x, "misses")):
        got = pq_pop_tiles(r, m, lay)
        errs.append(max_abs_err(torch, got, pq_pop_ref(r, m, lay)))
        check(errs[-1] == 0, f"pq_pop ({label}) differs from its plain "
              f"version")
        g = exec_.pq_pop(heap, r, m != 0, mode="gpu")
        t = exec_.pq_pop(heap, r, m != 0, mode="torch")
        check(all(torch.equal(a, b) for a, b in zip(g, t)),
              f"pq_pop ({label}): gpu dispatch != torch dispatch")
        n_found = int(got[0].sum())
        if label == "plan":
            check(n_found == int(m.sum()), "pq_pop: every pop lane of the "
                  "plan is found")
        print(f"pq_pop {label}: bit-identical ({n_found} found of "
              f"{int(m.sum())} masked-in lanes, live total {total})",
              flush=True)
    check(0 < n_found < int(mask_x.sum()), "pq_pop: misses and hits")
    got = pq_pop_tiles(ranks, m8, lay)
    reads = Reads()
    pq_reads(torch, reads, ranks, m8, lay, got[0], got[1])
    rows["pq_pop"] = dict(
        max_abs_err=max(errs),
        ms=median_ms(torch, lambda: pq_pop_tiles(ranks, m8, lay)),
        plain_ms=median_ms(torch, lambda: pq_pop_ref(ranks, m8, lay), 5),
        library_ms=None,
        dispatch_ms=median_ms(torch, lambda: exec_.pq_pop(
            heap, ranks, pop, mode="gpu")),
        bound=bound(torch, reads, T * (4 + 1 + 1 + 4)
                    + 4 * len(lay.offsets)))
    pq_rows = pq_shapes(torch, np.random.default_rng([seed, 6]), heap, ranks,
                        m8)
    del heap, lay
    torch.cuda.empty_cache()

    rows["splitorder_probe"] = splitorder_kernel_row(torch, rng)
    rows["paged_attention"] = paged_attention_row(torch, rng)
    rows["flash_attention"] = flash_attention_row(torch, rng)
    rows["selective_scan"] = selective_scan_row(
        torch, rng, np.random.default_rng([seed, 2]))
    rows["selective_scan"]["bf16"] = selective_scan_bf16(
        torch, np.random.default_rng([seed, 13]))
    rows["selective_scan_bwd"] = selective_scan_bwd_row(
        torch, np.random.default_rng([seed, 14]))

    for name, r, lv in ([("bskiplist_walk", rows["bskiplist_walk"],
                          rows["skiplist_search"])]
                        + [(f"{k}/block", r, rows[k])
                           for k, r in block_rows.items()]):
        print(f"{name}: bound {r['bound'][0]:.7f} ms by the block walk's "
              f"reads, {lv['bound'][0]:.7f} ms by the level walk's",
              flush=True)
        r["bound"] = min(r["bound"], lv["bound"])
    for name, r in list(rows.items()) + [(f"{k}/block", v)
                                         for k, v in block_rows.items()]:
        r["bound_ms"], r["bound_by"] = r.pop("bound")
        print_row(name, r, r.pop("lanes", T))
    print_shapes(shapes, pq_rows, probes)
    return rows


# ---------------------------------------------------------------------------
# phase 2, row 8: paged attention at the served decode shapes
# ---------------------------------------------------------------------------

def paged_attention_inputs(torch, rng, dtype, arch=SERVE_ARCH,
                           batch=SERVE_BATCH, num_pages=SERVE_NUM_PAGES,
                           reduced=False):
    """The served decode batch of one layer of `arch` (its reduced config
    with `reduced`): q [B, H, D], pools
    of `num_pages` pages, tables [B, P] with seeded lengths 1..P * page
    (at most num_pages / B pages a request) and the edge rows: row 0 a -1
    page in the middle, row 1 length 1, row 2 a length ending mid-page,
    row 3 a -1 tail (its last two pages are -1 while its length covers
    them)."""
    from repro_torch.configs import get_config, get_reduced
    cfg = (get_reduced if reduced else get_config)(arch)
    B, H, HKV, D = (batch, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    page, P, N = SERVE_PAGE, SERVE_PAGES_PER_REQ, num_pages
    lengths = rng.integers(1, min(P, N // B) * page + 1, B).astype(np.int32)
    lengths[1], lengths[2], lengths[3] = 1, page * 5 + 7, page * 10
    tables = np.full((B, P), -1, np.int32)
    ids = rng.permutation(N)
    c = 0
    for b in range(B):
        need = -(-int(lengths[b]) // page)
        tables[b, :need] = ids[c:c + need]
        c += need
    check(c <= N, "paged_attention inputs: the pool holds the batch")
    tables[0, 1] = -1
    tables[3, 8:10] = -1

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(DEV).to(dtype)
    return (normal(B, H, D), normal(N, page, HKV, D), normal(N, page, HKV, D),
            torch.from_numpy(tables).to(DEV), torch.from_numpy(lengths).to(DEV))


def paged_attention_check(torch, rng, reduced=False):
    """The paged_attention kernel against its plain version on the served
    decode batch (`paged_attention_inputs`, the reduced config's heads
    with `reduced`) in f32 (within 2e-5: the same f32 products summed in
    another order, and the online softmax's rescaling) and bf16 (within
    3e-2, tests/test_kernels.py's tolerance, and elementwise within half
    a bf16 step of |plain| plus the f32 tolerance, `paged_limit`: the
    same bf16 inputs summed in f32, the kernel's output rounded to bf16
    once, and half a step is at most 2^-8 of the value). Returns the bf16
    inputs, their plain output and the largest |kernel - plain|."""
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    label = "paged_attention" + (" (reduced heads)" if reduced else "")
    errs = []
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 3e-2)):
        q, kp, vp, tables, lengths = paged_attention_inputs(
            torch, rng, dtype, reduced=reduced)
        out = paged_attention(q, kp, vp, tables, lengths)
        torch.cuda.synchronize()
        ref = paged_attention_ref(q, kp, vp, tables, lengths)
        check(bool(torch.isfinite(out.float()).all()), f"{label}: finite "
              f"output")
        err = (out.float() - ref).abs()
        errs.append(float(err.max()))
        check(errs[-1] <= tol, f"{label} ({dtype}) differs from its plain "
              f"version by {errs[-1]} > {tol}")
        rel = ""
        if dtype == torch.bfloat16:
            worst = float((err / paged_limit(ref)).max())
            check(worst <= 1.0, f"{label} (bf16): an element is "
                  f"{worst:.3f} times half a bf16 step of |plain| + 2e-5 "
                  f"from its plain version")
            rel = (f"; at most {worst:.3f} of half a bf16 step of |plain| "
                   f"+ 2e-5")
        b, h, d = q.shape
        print(f"{label} {dtype} (B {b}, H {h}, Hkv {kp.shape[2]}, D {d}): "
              f"max |kernel - plain| {errs[-1]:.3e} (tolerance {tol}){rel}",
              flush=True)
    return (q, kp, vp, tables, lengths), ref, max(errs)


def paged_attention_row(torch, rng):
    """`paged_attention_check` at the served qwen3-1.7b decode batch; then
    the planted faults, the split-KV edge rows and every G and D
    (`paged_attention_faults`, `_edges`, `_groups`); timed in bf16 (the
    served type) beside `scaled_dot_product_attention` with enable_gqa
    on K/V already gathered into contiguous [B, Hkv, P * page, D] tensors
    with a length mask (the gather is not timed). The bound: the K/V rows
    of the tokens below each length on the live pages (id >= 0), q, out,
    the table entries below each length and the lengths, over the HBM
    rate. The same check and timing at the reduced configs' heads
    (`paged_reduced_heads`) go under "reduced"."""
    ins, ref, err = paged_attention_check(torch, rng)
    paged_attention_faults(torch, *ins, ref)
    paged_attention_edges(torch, rng, ins[1], ins[2])
    paged_attention_groups(torch, rng)
    r = paged_attention_timing(torch, *ins, ref, err)
    del ins, ref
    r["reduced"] = paged_reduced_heads(torch, rng)
    return r


def paged_reduced_heads(torch, rng):
    """`paged_attention_check` and the timing at the reduced configs'
    heads (qwen3-1.7b's: H 4, Hkv 2, G 2, D 16, what `launch.serve`
    serves) over the served batch's tables and edge rows. Returns that
    reading, its `shape` named."""
    ins, ref, err = paged_attention_check(torch, rng, reduced=True)
    b, h, d = ins[0].shape
    hkv = ins[1].shape[2]
    r = paged_attention_timing(torch, *ins, ref, err)
    r["shape"] = (f"{SERVE_ARCH} reduced decode: B {b}, H {h}, Hkv {hkv}, "
                  f"G {h // hkv}, D {d}, page {SERVE_PAGE}, "
                  f"{SERVE_NUM_PAGES} pages")
    print(f"kernel paged_attention at {r['shape']}: {r['ms']:.6f} ms (plain "
          f"{r['plain_ms']:.6f}, SDPA {r['library_ms']:.6f}, dispatch "
          f"{r['dispatch_ms']:.6f}, bound {r['bound'][0]:.7f} by "
          f"{r['bound'][1]})", flush=True)
    return r


def paged_attention_timing(torch, q, kp, vp, tables, lengths, ref, err):
    """The kernel's, the plain version's and SDPA's times on one bf16
    decode batch, beside the bound (`paged_attention_row`)."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_grouped
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    b, h, d = q.shape
    page, hkv = kp.shape[1], kp.shape[2]
    qg = q.reshape(b, hkv, h // hkv, d)
    # what the function must read: the table entries below each length
    # (a -1 among them too), and on each live page the tokens below the
    # length, a token's K and V rows of one KV head being whole sectors
    j = torch.arange(tables.shape[1], device=DEV)
    below = j[None, :] * page < lengths[:, None]
    live = (tables >= 0) & below
    n_live = int(live.sum())
    n_tokens = int(((lengths[:, None] - j[None, :] * page).clamp(0, page)
                    * live).sum())
    esz = q.element_size()
    t_bytes = (2 * n_tokens * hkv * d * esz + 2 * q.numel() * esz
               + int(below.sum()) * 4 + lengths.numel() * 4)
    # the library yardstick: K/V gathered as [B, Hkv, S, D] (not timed)
    safe = tables.clamp(min=0).long()
    s = tables.shape[1] * page
    kc = kp[safe].reshape(b, s, hkv, d).transpose(1, 2).contiguous()
    vc = vp[safe].reshape(b, s, hkv, d).transpose(1, 2).contiguous()
    pos = torch.arange(s, device=DEV)
    mask = ((pos[None, :] < lengths[:, None])
            & (tables >= 0).repeat_interleave(page, dim=1))[:, None, None, :]
    q4 = q[:, :, None, :]

    def library():
        return F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask,
                                              enable_gqa=True)
    lib = library()
    check(float((lib[:, :, 0].float() - ref).abs().max()) <= 3e-2,
          "scaled_dot_product_attention agrees with the plain version")
    r = dict(max_abs_err=err, lanes=b,
             ms=median_ms(torch, lambda: paged_attention_grouped(
                 qg, kp, vp, tables, lengths)),
             plain_ms=median_ms(torch, lambda: paged_attention_ref(
                 q, kp, vp, tables, lengths), 5),
             library_ms=median_ms(torch, library),
             dispatch_ms=median_ms(torch, lambda: paged_attention(
                 q, kp, vp, tables, lengths)),
             bound=(t_bytes / HBM_BYTES_PER_S * 1e3, "bytes"))
    print(f"paged_attention: {n_live} live pages of {tables.numel()} table "
          f"entries, {n_tokens} tokens read, {t_bytes} bytes", flush=True)
    del q, kp, vp, kc, vc, ref, lib
    torch.cuda.empty_cache()
    return r


def paged_limit(ref):
    """The bf16 elementwise limit: half a bf16 step of |plain| plus the
    f32 tolerance."""
    return 2.0 ** -8 * (ref.abs() + 2e-5) + 2e-5


def paged_plain_twice(torch, q, kp, vp, tables, lengths, twice):
    """The plain paged attention (`paged_attention_ref`'s arithmetic)
    with the token at position `twice` of every request that holds it on
    a live page counted twice (log 2 added to its score doubles its
    softmax weight)."""
    b, h, d = q.shape
    _, page, hkv, _ = kp.shape
    p = tables.shape[1]
    safe = tables.clamp(min=0).long()
    k = kp[safe].reshape(b, p * page, hkv, d)
    v = vp[safe].reshape(b, p * page, hkv, d)
    pos = torch.arange(p * page, device=q.device)[None, :]
    valid = ((pos < lengths[:, None])
             & (tables >= 0).repeat_interleave(page, dim=1))
    scores = torch.einsum("bkgd,bskd->bkgs",
                          q.reshape(b, hkv, h // hkv, d).float(),
                          k.float()) / math.sqrt(d)
    scores = scores + (math.log(2.0) * ((pos == twice) & valid)
                       )[:, None, None, :]
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgs,bskd->bkgd", w, v.float()).reshape(b, h, d)


def paged_attention_faults(torch, q, kp, vp, tables, lengths, ref):
    """Planted faults of the plain version at the served bf16 state, each
    output rounded to bf16 as the kernel's is: the last token below each
    length dropped, a -1 page read as page 0, and the first token of each
    request's second split (where the kernel's merge joins two splits)
    counted twice. Each must put an element beyond the bf16 elementwise
    limit that the kernel keeps; the worst element of each in units of
    the limit is printed."""
    from repro_torch.kernels.paged_attention.kernel import split_pages
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    b, _, _ = q.shape
    page, hkv = kp.shape[1], kp.shape[2]
    boundary = split_pages(b, hkv, tables.shape[1]) * page
    check(bool((lengths > boundary).any()), "paged_attention faults: a "
          "request crosses a split boundary")
    faults = {
        "last token dropped": paged_attention_ref(
            q, kp, vp, tables, (lengths - 1).clamp(min=1)),
        "-1 page read as page 0": paged_attention_ref(
            q, kp, vp, tables.clamp(min=0), lengths),
        "a split-boundary token counted twice": paged_plain_twice(
            torch, q, kp, vp, tables, lengths, boundary)}
    limit = paged_limit(ref)
    worst = {n: float(((f.to(torch.bfloat16).float() - ref).abs()
                       / limit).max()) for n, f in faults.items()}
    print("paged_attention planted faults, the worst element in units of "
          "the bf16 limit: " + ", ".join(f"{n} {x:.3f}"
                                         for n, x in worst.items()),
          flush=True)
    check(min(worst.values()) > 1.0, f"paged_attention: a planted fault "
          f"stays within the bf16 limit: {worst}")


def paged_attention_edges(torch, rng, kp, vp):
    """Three bf16 requests on the served pools and table width: row 0 spans
    three splits with its second split's pages all -1 (a split that owns
    no live page while the length runs past it), row 1 has length 0 (the
    kernel gives zeros; the plain version NaN), row 2 ends mid-page in its
    second split. Rows 0 and 2 within the bf16 limit of the plain version,
    row 1 exactly zero."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention.kernel import split_pages
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    cfg = get_config(SERVE_ARCH)
    n, page, hkv, d = kp.shape
    P = SERVE_PAGES_PER_REQ
    pps = split_pages(3, hkv, P)
    lengths = np.array([3 * pps * page, 0, pps * page + 5], np.int32)
    tables = np.full((3, P), -1, np.int32)
    ids = rng.permutation(n)
    tables[0, :3 * pps] = ids[:3 * pps]
    tables[0, pps:2 * pps] = -1
    tables[1, :2] = ids[3 * pps:3 * pps + 2]
    tables[2, :pps + 1] = ids[3 * pps + 2:4 * pps + 3]
    q = torch.from_numpy(rng.standard_normal((3, cfg.n_heads, d),
                                             dtype=np.float32)
                         ).to(DEV).to(torch.bfloat16)
    tt, ll = (torch.from_numpy(x).to(DEV) for x in (tables, lengths))
    out = paged_attention(q, kp, vp, tt, ll).float()
    torch.cuda.synchronize()
    ref = paged_attention_ref(q, kp, vp, tt, ll)
    worst = float(((out - ref).abs() / paged_limit(ref))[[0, 2]].max())
    print(f"paged_attention edge rows ({pps} pages a split): a split with "
          f"no live page and a mid-page end at most {worst:.3f} of the bf16 "
          f"limit; the length-0 row max |out| "
          f"{float(out[1].abs().max()):.3e}", flush=True)
    check(worst <= 1.0, f"paged_attention edge rows: {worst:.3f} of the "
          f"bf16 limit")
    check(bool((out[1] == 0).all()), "paged_attention: a length-0 request "
          "gives zeros")


def paged_attention_groups(torch, rng):
    """Every (G, D) the kernel is built for (`GROUPS` x `HEAD_DIMS`) at a
    small shape: 4 requests, 2 KV heads, pages of 16, lengths 1, 37, 100
    and 128 over 8-entry tables with a -1 page mid-table, in f32 (within
    2e-5) and bf16 (within the bf16 elementwise limit)."""
    from repro_torch.kernels.paged_attention.kernel import GROUPS, HEAD_DIMS
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    b, hkv, page, P, n = 4, 2, 16, 8, 64
    lengths = np.array([1, 37, 100, 128], np.int32)
    tables = np.full((b, P), -1, np.int32)
    ids = rng.permutation(n)
    c = 0
    for r in range(b):
        need = -(-int(lengths[r]) // page)
        tables[r, :need] = ids[c:c + need]
        c += need
    tables[2, 1] = -1
    tt, ll = (torch.from_numpy(x).to(DEV) for x in (tables, lengths))
    worst = {}
    for d in HEAD_DIMS:
        for g in GROUPS:
            for dtype in (torch.float32, torch.bfloat16):
                q, kp, vp = (torch.from_numpy(rng.standard_normal(
                    s, dtype=np.float32)).to(DEV).to(dtype)
                    for s in ((b, hkv * g, d), (n, page, hkv, d),
                              (n, page, hkv, d)))
                out = paged_attention(q, kp, vp, tt, ll).float()
                torch.cuda.synchronize()
                ref = paged_attention_ref(q, kp, vp, tt, ll)
                err = (out - ref).abs()
                if dtype == torch.float32:
                    x = float(err.max())
                    check(x <= 2e-5, f"paged_attention G={g} D={d} (f32): "
                          f"{x}")
                else:
                    x = float((err / paged_limit(ref)).max())
                    check(x <= 1.0, f"paged_attention G={g} D={d} (bf16): "
                          f"{x:.3f} of the bf16 limit")
                key = (d, str(dtype)[6:])
                worst[key] = max(worst.get(key, 0.0), x)
    print(f"paged_attention at every G {GROUPS} and D {HEAD_DIMS}, the "
          f"worst over G (f32: max |kernel - plain|; bf16: the worst "
          f"element in units of the bf16 limit): " + ", ".join(
              f"D {d} {t} {x:.3g}" for (d, t), x in worst.items()),
          flush=True)


# ---------------------------------------------------------------------------
# phase 2, rows 9-10: flash attention and the selective scan at hymba's
# served prefill and decode shapes
# ---------------------------------------------------------------------------

def normal(torch, rng, shape, dtype, scale=1.0):
    return (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                             * np.float32(scale)).to(DEV).to(dtype))


def allowed_pairs(sq, sk, q_offset, window):
    """The (query, key) pairs a causal (windowed) row set attends to, per
    (batch, head)."""
    pos = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(pos, sk - 1)
    lo = np.maximum(0, pos - window + 1) if window > 0 else 0
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_off(torch, got, plain, oabs):
    """The share of the outputs beyond FLASH_OFF_SHARE's per-element bound,
    and the largest |got - plain| in units of that bound."""
    r = ((got.float() - plain).abs()
         / (2.0 ** -7 * (oabs + plain.abs()) + 1e-6))
    return float((r > 1).float().mean()), float(r.max())


def flash_attention_row(torch, rng):
    """Mode f32 (the op's contract) at (2, 256, 8, 64) with G = 1, 2, 4, 8
    and non-causal, against the oracle's twin `flash_attention_ref`
    within 5e-6 (tests/test_kernels.py's tolerance: the same f32 products
    summed in another order). Mode xla_flash at Sq 100 after 129 cached
    keys (ragged q and kv tiles) with a window of 37, f32 at D 64 and bf16
    at D 128, against the plain mirror at the kernel's tiles; planted
    faults there: window 38, the last key dropped. Mode xla_flash at
    hymba's served prefill (B 8, S 4,096, H 25, Hkv 5, D 64, bf16 in and
    out), window 0 and 2,048, against the mirror at the kernel's 64-key
    tiles (p rounded after the same running max) and at the reference's
    512-key tiles (what exec mode torch runs); planted faults there: one
    key too many or too few at the window edge (window 2,048) or at the
    causal edge (window 0). Each comparison: at most FLASH_OFF_SHARE of
    the outputs beyond `flash_off`'s per-element bound, and each planted
    fault beyond that share. Timed at window 0 beside
    `scaled_dot_product_attention(is_causal=True, enable_gqa=True)` on
    [B, H, S, D] views; the bound: 4 * D flops per allowed pair over the
    bf16 tensor-core rate, or q, k, v and out once over the HBM rate,
    whichever is larger."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import (
        TILE, flash_attention_fused)
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (attend_flash_ref,
                                                         flash_attention_ref)
    from repro_torch.models.common import attend_causal
    f32, bf = torch.float32, torch.bfloat16
    errs = []
    for hkv, causal in ((8, True), (4, True), (2, True), (1, True),
                        (8, False)):
        q, k, v = (normal(torch, rng, (2, 256, n, 64), f32)
                   for n in (8, hkv, hkv))
        out = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        errs.append(float((out - flash_attention_ref(
            q, k, v, causal=causal)).abs().max()))
        check(errs[-1] <= 5e-6, f"flash_attention (f32, G={8 // hkv}, "
              f"causal={causal}) differs from its plain version by "
              f"{errs[-1]}")
    print(f"flash_attention f32 mode, (2, 256, 8, 64), G = 1/2/4/8 causal "
          f"and G = 1 full: max |kernel - plain| {errs}", flush=True)
    # xla_flash mode off the served shape: ragged q and kv tiles, a
    # q_offset (a suffix after cached past), a window, f32 in and out at
    # D 64 and bf16 at D 128, against the mirror at the kernel's tiles
    for dtype, d_ in ((f32, 64), (bf, 128)):
        q = normal(torch, rng, (2, 100, 10, d_), dtype)
        k, v = (normal(torch, rng, (2, 229, 2, d_), dtype) for _ in range(2))
        out = flash_attention_fused(q, k, v, q_offset=129, window=37)
        torch.cuda.synchronize()

        def mirror(k_=k, v_=v, window=37):
            return attend_flash_ref(q, k_, v_, window, dtype, TILE,
                                    129).float()
        plain, oabs = mirror(), mirror(v_=v.abs())
        errs.append(float((out.float() - plain).abs().max()))
        off, worst = flash_off(torch, out, plain, oabs)
        faults = {"window 38": mirror(window=38),
                  "last key dropped": mirror(k[:, :-1], v[:, :-1])}
        faults = {n: flash_off(torch, f, plain, oabs)[0]
                  for n, f in faults.items()}
        print(f"flash_attention xla_flash mode, Sq 100 after 129 cached "
              f"keys, window 37, {dtype} at D {d_}: max |kernel - plain| "
              f"{errs[-1]:.3e}, {off:.3e} of the outputs beyond the bound "
              f"(the worst {worst:.3f} of it); planted faults beyond it: "
              + ", ".join(f"{n} {x:.3e}" for n, x in faults.items()),
              flush=True)
        check(off <= FLASH_OFF_SHARE, f"flash_attention (xla_flash, "
              f"ragged, {dtype}, D {d_}): {off:.3e} of the outputs beyond "
              f"the bound")
        check(min(faults.values()) > FLASH_OFF_SHARE, f"flash_attention "
              f"(ragged, {dtype}): a planted fault stays within the "
              f"share: {faults}")

    cfg = get_config(HYMBA_ARCH)
    b, s, h, hkv, d = (HYMBA_BATCH, HYMBA_PROMPT, cfg.n_heads,
                       cfg.n_kv_heads, cfg.resolved_head_dim)
    q = normal(torch, rng, (b, s, h, d), bf)
    k, v = (normal(torch, rng, (b, s, hkv, d), bf) for _ in range(2))
    res = {}
    for window in (0, cfg.sliding_window):
        out = flash_attention_fused(q, k, v, window=window)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out.float()).all()), "flash_attention: "
              "finite output")

        def mirror(v_=v, window=window, q_offset=0, block=TILE):
            return attend_flash_ref(q, k, v_, window, bf, block,
                                    q_offset).float()
        tile, oabs = mirror(), mirror(v_=v.abs())
        err_tile = float((out.float() - tile).abs().max())
        off, worst = flash_off(torch, out, tile, oabs)
        faults = ({"window +1": mirror(window=window + 1),
                   "window -1": mirror(window=window - 1)} if window else
                  {"causal +1": mirror(q_offset=1),
                   "causal -1": mirror(q_offset=-1)})
        faults = {n: flash_off(torch, f, tile, oabs)[0]
                  for n, f in faults.items()}
        del tile
        plain = mirror(block=cfg.attn_block_q)
        err = float((out.float() - plain).abs().max())
        off_p, worst_p = flash_off(torch, out, plain, oabs)
        del plain, oabs
        print(f"flash_attention window {window}: beyond the bound "
              f"{off:.3e} of the outputs vs the plain version at the "
              f"kernel's tiles (the worst {worst:.3f} of it, max |diff| "
              f"{err_tile:.3e}), {off_p:.3e} at 512-key tiles (the worst "
              f"{worst_p:.3f}); planted faults beyond it: "
              + ", ".join(f"{n} {x:.3e}" for n, x in faults.items()),
              flush=True)
        check(off <= FLASH_OFF_SHARE and off_p <= FLASH_OFF_SHARE,
              f"flash_attention (window {window}): {off:.3e} / {off_p:.3e} "
              f"of the outputs beyond the bound at 64- / 512-key tiles")
        check(min(faults.values()) > FLASH_OFF_SHARE, f"flash_attention "
              f"(window {window}): a planted fault stays within the share: "
              f"{faults}")
        worst = max(worst, worst_p)
        pairs = b * h * allowed_pairs(s, s, 0, window)
        res[window] = dict(
            err=err, worst=worst, pairs=pairs,
            ms=median_ms(torch, lambda: flash_attention_fused(
                q, k, v, window=window)),
            plain_ms=median_ms(torch, lambda: attend_flash_ref(
                q, k, v, window, bf, cfg.attn_block_q), 3),
            dispatch_ms=median_ms(torch, lambda: attend_causal(
                q, k, v, window, "bfloat16", impl="xla_flash")))
        print(f"flash_attention bf16 xla_flash, B {b} S {s} H {h} Hkv {hkv} "
              f"D {d}, window {window}: {pairs} allowed pairs; "
              f"{res[window]['ms']:.6f} ms (plain at 512-key tiles "
              f"{res[window]['plain_ms']:.6f} ms); max |kernel - plain| "
              f"{err:.3e} at 512-key tiles, at most {worst:.3f} of the "
              f"per-element bound", flush=True)
        del out
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    lib = library().transpose(1, 2).float()
    plain = attend_flash_ref(q, k, v, 0, bf, cfg.attn_block_q).float()
    lib_err = float((lib - plain).abs().max())
    check(lib_err <= 2e-2, f"scaled_dot_product_attention agrees with the "
          f"plain version ({lib_err})")
    r0 = res[0]
    t_ops = 4 * d * r0["pairs"] / BF16_TENSOR_OPS_PER_S
    t_bytes = 2 * (2 * q.numel() + 2 * k.numel()) / HBM_BYTES_PER_S
    r = dict(max_abs_err=max(errs + [x["err"] for x in res.values()]),
             lanes=b * s, ms=r0["ms"], plain_ms=r0["plain_ms"],
             library_ms=median_ms(torch, library),
             dispatch_ms=r0["dispatch_ms"],
             bound=((t_ops * 1e3, "operations") if t_ops >= t_bytes
                    else (t_bytes * 1e3, "bytes")))
    w = cfg.sliding_window
    t_w = max(4 * d * res[w]["pairs"] / BF16_TENSOR_OPS_PER_S, t_bytes)
    print(f"flash_attention: SDPA {r['library_ms']:.6f} ms (max |SDPA - "
          f"plain| {lib_err:.3e}); window {w}: {res[w]['ms']:.6f} ms "
          f"against a bound of {t_w * 1e3:.7f} ms by operations",
          flush=True)
    del q, k, v, qt, kt, vt, lib, plain
    torch.cuda.empty_cache()
    return r


def scan_inputs(torch, rng, b, s, d, n):
    """tests/test_kernels.py's distributions, plus a nonzero h0."""
    f32 = torch.float32
    x = normal(torch, rng, (b, s, d), f32, 0.5)
    dt = (torch.from_numpy(np.abs(rng.standard_normal((b, s), np.float32))
                           * np.float32(0.1) + np.float32(0.01)).to(DEV))
    bm = normal(torch, rng, (b, s, n), f32, 0.5)
    cm = normal(torch, rng, (b, s, n), f32, 0.5)
    a = -(normal(torch, rng, (d, n), f32).abs() + 0.1)
    h0 = normal(torch, rng, (b, d, n), f32)
    return x, dt, bm, cm, a, h0


SCAN_EDGE_SHAPES = ((2, 45, 77, "ragged"), (2, 100, 36, "D 36"),
                    (2, 1, 77, "S 1"))


def scan_within(torch, got, want, tol=2e-5):
    """The worst of |got - want| / (tol + tol |want|) over y and h_last:
    at most 1 is within tests/test_kernels.py's limit."""
    return max(float(((g - w).abs() / (tol + tol * w.abs())).max())
               for g, w in zip(got, want))


@contextlib.contextmanager
def forced_scan_geometry(**fields):
    """Make `scan_geometry` give `per` states a lane to the forward and the
    saving forward and a `cluster` of blocks to the backward (at most its
    blocks), so that an edge case runs that split whatever its shape."""
    from repro_torch.kernels.selective_scan import kernel as ssk
    orig = ssk.scan_geometry

    def forced(b, s, d, n, sms, kind="forward"):
        geo = orig(b, s, d, n, sms, kind)
        if kind != "backward" and "per" in fields:
            geo = ssk.split(d, n, fields["per"])
        if kind == "backward" and "cluster" in fields:
            geo = ssk.split(d, n, geo.per, fields["cluster"])
        return geo
    ssk.scan_geometry = forced
    try:
        yield
    finally:
        ssk.scan_geometry = orig


def scan_edge_sweep(torch, rng):
    """selective_scan against the step-by-step plain scan within 2e-5 at
    every N of STATE_SIZES and every lane split `scan_geometry` can give
    it (`forward_pers`: 8, 4, 2 or 1 states a lane, forced), at
    SCAN_EDGE_SHAPES (D 77: no block's channel count divides it, and the
    scalar x path; D 36: the vector one, with a block reaching past D; S
    45 and 100: not a multiple of the 32-step staging chunk or the
    16-step window, 100 wrapping the 3-slot ring; S 1), from h0 = None
    and from a nonzero h0; at N 16 also with every operand one float off
    16-byte alignment (the kernel's scalar paths). A planted fault, the
    kernel run from h0 = None held against the plain scan from the
    nonzero h0 (h0 ignored), must break that limit at every case. Returns
    the largest |kernel - plain|."""
    from repro_torch.kernels.selective_scan.kernel import (
        STATE_SIZES, forward_pers, selective_scan_fused)
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref
    worst, fault, err, n_cases = 0.0, math.inf, 0.0, 0

    def off_by_one(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        v = buf[1:].view(t.shape)
        v.copy_(t)
        return v

    for n in STATE_SIZES:
        for b, s, d, label in SCAN_EDGE_SHAPES:
            ins = scan_inputs(torch, rng, b, s, d, n)
            want = selective_scan_ref(*ins)
            want0 = selective_scan_ref(*ins[:5])
            runs = [("", ins)]
            if n == 16 and s > 1:
                runs.append((", unaligned", tuple(off_by_one(t)
                                                  for t in ins)))
            for (how, args), per in itertools.product(runs,
                                                      forward_pers(n)):
                with forced_scan_geometry(per=per):
                    got = selective_scan_fused(*args)
                    got0 = selective_scan_fused(*args[:5])
                case = f"N {n}, {per} states a lane, {label}{how}"
                w = max(scan_within(torch, got, want),
                        scan_within(torch, got0, want0))
                check(w <= 1.0, f"selective_scan edge ({case}) differs from "
                      f"the plain scan: {w:.3f} of 2e-5 + 2e-5 |plain|")
                f = scan_within(torch, got0, want)
                check(f > 1.0, f"selective_scan edge ({case}): the planted "
                      f"fault (h0 ignored) stays within the limit ({f:.3f})")
                worst, fault = max(worst, w), min(fault, f)
                err = max(err, max(float((g - w_).abs().max())
                                    for g, w_ in zip(got, want)))
                n_cases += 1
    print(f"selective_scan edges: {n_cases} cases (N {STATE_SIZES}, every "
          f"lane split, ragged D and S, S 1, h0 None and nonzero, "
          f"unaligned) within {worst:.3f} of 2e-5 + 2e-5 |plain|; the "
          f"planted fault (h0 ignored) at least {fault:.1f} of it",
          flush=True)
    return err


def selective_scan_row(torch, rng, edge_rng):
    """The kernel against the plain step-by-step scan at
    tests/test_kernels.py's three shapes within its 2e-5 (atol and rtol)
    and at `scan_edge_sweep`'s edges, and against the chunked associative
    scan that exec mode torch runs at hymba's served prefill (8, 4,096,
    3,200, 16) and decode (8, 1, 3,200, 16) shapes, from a nonzero h0,
    within 1e-4 of the largest |y| and |h| (f32 throughout; the two sum in
    other orders). Timed at the prefill shape, and at the decode shape
    beside its own bound; no PyTorch call computes the scan.
    The bound: the larger of the bytes (x, y, dt, B, C, A, h0, h_last
    once) over the HBM rate, the exps (one per (b, t, d, n)) over the
    SFU's rate and the six flops per (b, t, d, n) (dt*A, *h, the B FMA,
    the C FMA) over the f32 rate."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.selective_scan.kernel import selective_scan_fused
    from repro_torch.kernels.selective_scan.ops import selective_scan
    from repro_torch.kernels.selective_scan.ref import (
        selective_scan_chunked, selective_scan_ref)
    errs = [scan_edge_sweep(torch, edge_rng)]
    for shape in ((1, 32, 64, 8), (2, 64, 128, 16), (2, 128, 64, 8)):
        ins = scan_inputs(torch, rng, *shape)
        got = selective_scan_fused(*ins)
        torch.cuda.synchronize()
        want = selective_scan_ref(*ins)
        worst = scan_within(torch, got, want)
        errs += [float((g - w).abs().max()) for g, w in zip(got, want)]
        check(worst <= 1.0, f"selective_scan {shape} differs from its "
              f"plain version (at {worst:.3f} of 2e-5 + 2e-5 |plain|)")
    cfg = get_config(HYMBA_ARCH)
    d, n = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    out = {}
    for s in (HYMBA_PROMPT, 1):
        ins = scan_inputs(torch, rng, HYMBA_BATCH, s, d, n)
        y, h = selective_scan_fused(*ins)
        torch.cuda.synchronize()
        yp, hp = selective_scan_chunked(*ins, chunk=cfg.scan_chunk)
        ey, eh = (float((a - b_).abs().max()) for a, b_ in ((y, yp), (h, hp)))
        ry, rh = ey / float(yp.abs().max()), eh / float(hp.abs().max())
        check(ry <= 1e-4 and rh <= 1e-4, f"selective_scan (S {s}) differs "
              f"from its plain version: {ry:.3e} of max |y|, {rh:.3e} of "
              f"max |h|")
        errs += [ey, eh]
        print(f"selective_scan B {HYMBA_BATCH} S {s} D {d} N {n} from a "
              f"nonzero h0: max |kernel - plain| y {ey:.3e} ({ry:.3e} of max "
              f"|y|), h_last {eh:.3e} ({rh:.3e} of max |h|)", flush=True)
        out[s] = ins

    def scan_bound(ins):
        x, dt, bm, cm, a, h0 = ins
        elems = x.shape[0] * x.shape[1] * d * n
        t_bytes = 4 * (2 * x.numel() + dt.numel() + bm.numel() + cm.numel()
                       + a.numel() + 2 * h0.numel()) / HBM_BYTES_PER_S
        t_ops = max(elems / EXP_PER_S, 6 * elems / OPS_PER_S)
        return ((t_ops * 1e3, "operations") if t_ops >= t_bytes
                else (t_bytes * 1e3, "bytes"))

    ins = out[HYMBA_PROMPT]
    r = dict(max_abs_err=max(errs), lanes=HYMBA_BATCH * d,
             ms=median_ms(torch, lambda: selective_scan_fused(*ins)),
             plain_ms=median_ms(torch, lambda: selective_scan_chunked(
                 *ins, chunk=cfg.scan_chunk), 3),
             library_ms=None,
             dispatch_ms=median_ms(torch, lambda: selective_scan(*ins)),
             bound=scan_bound(ins))
    dec = out[1]
    dec_bound, dec_by = scan_bound(dec)
    dec_ms = median_ms(torch, lambda: selective_scan_fused(*dec))
    print(f"selective_scan decode shape (B {HYMBA_BATCH}, S 1): "
          f"{dec_ms:.6f} ms per call, bound {dec_bound:.7f} ms by {dec_by} "
          f"({dec_ms / dec_bound:.1f}x the bound); prefill shape: "
          f"{HYMBA_BATCH * HYMBA_PROMPT * d * n} (b, t, d, n) elements",
          flush=True)
    del out, ins, dec
    torch.cuda.empty_cache()
    return r


SCAN_BF16_TOL = 2e-2


def selective_scan_bf16(torch, rng):
    """The kernel's bf16 scan (`ssm_scan_dtype` "bfloat16") against the
    plain chunked bf16 scan at hymba's prefill (8, 4,096, 3,200, 16) and
    decode (8, 1, 3,200, 16) shapes from a nonzero h0, within 2e-2 + 2e-2
    |plain| (tests/test_torch_selective_scan.py's bound for the plain bf16
    scan against the reference; the kernel runs the same associative
    scan tree with the same bf16 roundings, so only its exps and the f32
    y sums may differ), beside the f32 scan's distance from the plain
    bf16 scan; timed at the prefill shape beside the f32 kernel. Returns
    the reading."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.selective_scan.kernel import selective_scan_fused
    from repro_torch.kernels.selective_scan.ref import selective_scan_chunked
    cfg = get_config(HYMBA_ARCH)
    d, n = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    bf = torch.bfloat16
    worst = {}
    for s in (HYMBA_PROMPT, 1):
        ins = scan_inputs(torch, rng, HYMBA_BATCH, s, d, n)
        got = selective_scan_fused(*ins, scan_dtype=bf,
                                   scan_chunk=cfg.scan_chunk)
        torch.cuda.synchronize()
        want = selective_scan_chunked(*ins, chunk=cfg.scan_chunk,
                                      scan_dtype=bf)
        f32 = selective_scan_chunked(*ins, chunk=cfg.scan_chunk)
        worst[s] = scan_within(torch, got, want, SCAN_BF16_TOL)
        apart = scan_within(torch, f32, want, SCAN_BF16_TOL)
        check(worst[s] <= 1.0, f"selective_scan bf16 (S {s}) differs from "
              f"the plain bf16 scan: {worst[s]:.3f} of 2e-2 + 2e-2 |plain|")
        print(f"selective_scan bf16 B {HYMBA_BATCH} S {s} D {d} N {n}: at "
              f"most {worst[s]:.4f} of 2e-2 + 2e-2 |plain bf16|; the f32 "
              f"scan {apart:.4f} of it (max |kernel - plain| y "
              f"{float((got[0] - want[0]).abs().max()):.3e}, h "
              f"{float((got[1] - want[1]).abs().max()):.3e})", flush=True)
        if s == HYMBA_PROMPT:
            pre = ins
    ms = median_ms(torch, lambda: selective_scan_fused(
        *pre, scan_dtype=bf, scan_chunk=cfg.scan_chunk))
    f32_ms = median_ms(torch, lambda: selective_scan_fused(*pre))
    plain_ms = median_ms(torch, lambda: selective_scan_chunked(
        *pre, chunk=cfg.scan_chunk, scan_dtype=bf), 3)
    print(f"kernel selective_scan/bf16 at the prefill shape: {ms:.6f} ms "
          f"(f32 kernel {f32_ms:.6f}, plain bf16 scan {plain_ms:.6f})",
          flush=True)
    del pre, ins
    torch.cuda.empty_cache()
    return {"ms": ms, "f32_ms": f32_ms, "plain_ms": plain_ms,
            "worst": max(worst.values())}


# phase 2, row 11: the selective scan's backward. Held against the
# step-by-step plain backward within SCAN_BWD_TOL of each gradient's
# largest |plain|: the same f32 arithmetic but for ex2.approx against expf
# and the order of the sums (dB, dC and dt over D's channels in shuffle,
# warp and block order, dA over B and S), which moves a gradient by a
# few ulps of its largest terms, summed over up to 4,096 steps or 3,200
# channels
SCAN_BWD_TOL = 1e-4
SCAN_BWD_EDGES = ((2, 1, 77, "S 1"), (2, 45, 77, "S 45, D 77"),
                  (2, 100, 36, "S 100, D 36"),
                  (2, 100, 300, "S 100, D 300"))
# exp(dt A) underflowing: dt of 1,000 on every 7th step, and on the steps
# either side of the 16-step window boundaries 16 and 48 (off the 32-step
# chunk grid) and 32 (on it)
SCAN_BWD_UNDERFLOWS = (("every 7th step", slice(None, None, 7)),
                       ("at window boundaries", [15, 16, 31, 32, 47, 48]))
SCAN_BWD_NAMES = ("dx", "ddt", "dB", "dC", "dA", "dh0")


def scan_bwd_kernel(torch, ins, dy, dh):
    """The saving forward, then the backward kernel: ((y, h_last),
    grads)."""
    from repro_torch.kernels.selective_scan.kernel import (
        selective_scan_bwd, selective_scan_fused)
    y, h, chunks = selective_scan_fused(*ins, save_chunks=True)
    return (y, h), selective_scan_bwd(*ins, chunks, dy, dh)


def scan_bwd_off(got, want) -> list:
    """max |got - want| / max |want| of each gradient."""
    return [float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            for g, w in zip(got, want)]


def scan_bwd_dropped_carry(torch, ins, dy, dh, tc: int):
    """The planted fault: the plain backward with the carry dL/dh across
    step tc dropped (the steps before tc see none of the later steps'
    gradient)."""
    from repro_torch.kernels.selective_scan.ref import (
        selective_scan_bwd_ref, selective_scan_ref)
    x, dt, bm, cm, a, h0 = ins
    lo = [t[:, :tc] for t in (x, dt, bm, cm)]
    hi = [t[:, tc:] for t in (x, dt, bm, cm)]
    _, h_mid = selective_scan_ref(*lo, a, h0)
    g_hi = selective_scan_bwd_ref(*hi, a, h_mid, dy[:, tc:], dh)
    g_lo = selective_scan_bwd_ref(*lo, a, h0, dy[:, :tc], None)
    return ([torch.cat([p, q], 1) for p, q in zip(g_lo[:4], g_hi[:4])]
            + [g_lo[4] + g_hi[4], g_lo[5]])


def scan_bwd_check(torch, label, ins, dy, dh, faults=()):
    """One case: the kernel's gradients against the plain backward, the
    saving forward's y and h_last equal to the plain forward kernel's, a
    second backward bit for bit, and each planted fault (`faults`: the
    carry dropped at that step) beyond the tolerance. Returns (worst of
    the gradients in units of SCAN_BWD_TOL, the faults' least, largest
    |kernel - plain|, each gradient's distance)."""
    from repro_torch.kernels.selective_scan.kernel import selective_scan_fused
    from repro_torch.kernels.selective_scan.ref import selective_scan_bwd_ref
    (y, h), got = scan_bwd_kernel(torch, ins, dy, dh)
    _, again = scan_bwd_kernel(torch, ins, dy, dh)
    y0, h0 = selective_scan_fused(*ins)
    torch.cuda.synchronize()
    check(torch.equal(y, y0) and torch.equal(h, h0),
          f"selective_scan ({label}): the saving forward's outputs differ "
          f"from the forward's")
    same = [torch.equal(a, b) for a, b in zip(got, again)]
    check(all(same), f"selective_scan_bwd ({label}): two runs differ in "
          f"{[n for n, ok in zip(SCAN_BWD_NAMES, same) if not ok]}")
    want = selective_scan_bwd_ref(*ins, dy, dh)
    off = scan_bwd_off(got, want)
    w = max(off) / SCAN_BWD_TOL
    check(w <= 1.0, f"selective_scan_bwd ({label}) differs from its plain "
          f"version: " + ", ".join(f"{n} {o:.3e}" for n, o in
                                   zip(SCAN_BWD_NAMES, off))
          + f" of max |plain| (tolerance {SCAN_BWD_TOL})")
    f = math.inf
    for fault_at in faults:
        fa = max(scan_bwd_off(got, scan_bwd_dropped_carry(
            torch, ins, dy, dh, fault_at))) / SCAN_BWD_TOL
        check(fa > 1.0, f"selective_scan_bwd ({label}): the planted fault "
              f"(the carry dropped at step {fault_at}) stays within the "
              f"tolerance ({fa:.3f})")
        f = min(f, fa)
    err = max(float((g - w_).abs().max()) for g, w_ in zip(got, want))
    return w, f, err, off


def selective_scan_bwd_row(torch, rng):
    """The backward kernel against `selective_scan_bwd_ref` at every N of
    STATE_SIZES at SCAN_BWD_EDGES from a nonzero h0 and dh_last (S 1; S
    45 and 100, not multiples of the 32-step chunk or the 16-step window;
    D 77, 36 and 300, a block reaching past D, one to three clusters of
    blocks and blocks wholly past D padding the last), with
    SCAN_BWD_UNDERFLOWS at N 16 (exp(dt A) underflows to 0: the carry
    stops there), and at N 16, S 100, D 300 under every cluster size
    `scan_geometry` can give (1 to 8, forced); then at one training
    microbatch (2 x 4,096 x 3,200 x 16, zero h0 and dh_last as in
    training); each within SCAN_BWD_TOL, bit for bit on a second run,
    and the planted faults (the carry dropped at the chunk boundary 32,
    and at the window boundary 48 off the chunk grid) beyond it. Timed at
    the training shape beside the plain backward and the
    bound: the larger of the bytes the function must move (x, dt, B, C, A
    and dy in, dx, dt, dB, dC, dA out, once; the forward's saved states
    are the kernel's own intermediate, left out) over the HBM rate, and
    one exp and 12 flops per (b, t, d, n) over the SFU's and the f32
    rate. No PyTorch call computes it. Returns the row."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.selective_scan.kernel import (
        MAX_CLUSTER, SS_CHUNK, SS_SAVE, STATE_SIZES, scan_geometry,
        selective_scan_bwd, selective_scan_fused)
    from repro_torch.kernels.selective_scan.ops import SelectiveScan
    from repro_torch.kernels.selective_scan.ref import selective_scan_bwd_ref
    worst, fault, errs, n_cases = 0.0, math.inf, [], 0
    off_grid = 3 * SS_SAVE                    # a window boundary, no chunk's

    def case(label, b, s, d, n, under=None, **forced):
        nonlocal worst, fault, n_cases
        ins = list(scan_inputs(torch, rng, b, s, d, n))
        cut = set()                           # steps whose exp underflows
        if under is not None:
            cut = set(range(s)[under[1]] if isinstance(under[1], slice)
                      else (i for i in under[1] if i < s))
            ins[1][:, sorted(cut)] = 1000.0
            label += f", underflow {under[0]}"
        dy = normal(torch, rng, (b, s, d), torch.float32)
        dh = normal(torch, rng, (b, d, n), torch.float32)
        # a carry dropped where exp(dt A) is 0 drops nothing: no fault there
        with forced_scan_geometry(**forced):
            w, f, e, _ = scan_bwd_check(
                torch, label, ins, dy, dh,
                [t for t in (SS_CHUNK, off_grid) if t < s and t not in cut])
        worst, fault = max(worst, w), min(fault, f)
        errs.append(e)
        n_cases += 1

    for n in STATE_SIZES:
        for b, s, d, label in SCAN_BWD_EDGES:
            unders = SCAN_BWD_UNDERFLOWS if n == 16 and s > 1 else ()
            for under in (None, *unders):
                case(f"N {n}, {label}", b, s, d, n, under)
    for cl in range(1, MAX_CLUSTER + 1):
        case(f"N 16, S 100, D 300, clusters of {cl}", 2, 100, 300, 16,
             cluster=cl)
    print(f"selective_scan_bwd edges: {n_cases} cases (N {STATE_SIZES}, "
          f"S 1 / 45 / 100, D 77 / 36 / 300, clusters of 1 to "
          f"{MAX_CLUSTER}, nonzero h0 and dh_last, exp(dt A) underflowing "
          f"at N 16 every 7th step and at window boundaries) within "
          f"{worst:.3f} of {SCAN_BWD_TOL} x max |plain|, bit for bit "
          f"twice; the planted faults (the carry dropped at steps "
          f"{SS_CHUNK} and {off_grid}) at least {fault:.1f} of it",
          flush=True)
    cfg = get_config(HYMBA_ARCH)
    b, s = HTRAIN_SEQS // HTRAIN_MICRO, HYMBA_PROMPT
    d, n = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    ins = list(scan_inputs(torch, rng, b, s, d, n))
    ins[5] = torch.zeros_like(ins[5])
    dy = normal(torch, rng, (b, s, d), torch.float32)
    w, f, e, off = scan_bwd_check(torch, "training shape", ins, dy, None,
                                  (s // 2,))
    errs.append(e)
    print(f"selective_scan_bwd B {b} S {s} D {d} N {n}: max |kernel - "
          f"plain| / max |plain| " + ", ".join(
              f"{nm} {o:.3e}" for nm, o in zip(SCAN_BWD_NAMES, off))
          + f" ({w:.3f} of the tolerance); bit for bit twice; the planted "
          f"fault (carry dropped at step {s // 2}) {f:.1f} of it",
          flush=True)
    save = saving_forward_row(torch, ins)
    _, _, chunks = selective_scan_fused(*ins, save_chunks=True)
    ms = median_ms(torch, lambda: selective_scan_bwd(*ins, chunks, dy, None))
    plain_ms = median_ms(torch, lambda: selective_scan_bwd_ref(
        *ins, dy, None), 1)
    leaves = [t.clone().requires_grad_() for t in ins[:5]]
    y, _ = SelectiveScan.apply(*leaves, ins[5])

    def dispatch():
        torch.autograd.backward([y], [dy], retain_graph=True)
    dispatch_ms = median_ms(torch, dispatch)
    elems = b * s * d * n
    t_bytes = 4 * (3 * ins[0].numel() + 2 * ins[1].numel()
                   + 4 * ins[2].numel()
                   + 2 * ins[4].numel()) / HBM_BYTES_PER_S
    t_ops = max(elems / EXP_PER_S, 12 * elems / OPS_PER_S)
    bnd = ((t_ops * 1e3, "operations") if t_ops >= t_bytes
           else (t_bytes * 1e3, "bytes"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    geos = {k: scan_geometry(b, s, d, n, sms, k)
            for k in ("forward", "backward")}
    print(f"selective_scan_bwd at the training shape: {ms:.6f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bnd[0]:.7f} ms by {bnd[1]} (bytes "
          f"{t_bytes * 1e3:.7f}, operations {t_ops * 1e3:.7f}); lane "
          f"splits on {sms} SMs: " + ", ".join(
              f"{k} {g.per} states a lane, {g.channels} channels a block, "
              f"{b * g.blocks} blocks, clusters of {g.cluster}"
              for k, g in geos.items()), flush=True)
    del ins, dy, chunks, leaves, y
    torch.cuda.empty_cache()
    return dict(max_abs_err=max(errs), lanes=b * d, ms=ms, plain_ms=plain_ms,
                library_ms=None, dispatch_ms=dispatch_ms, bound=bnd,
                save=save)


def plain_saving_forward(torch, ins):
    """The saving forward's plain version: the chunked scan one SS_SAVE
    window at a time, each from the state the last one left, keeping the
    state entering each window. Returns (y, h_last, chunk states)."""
    from repro_torch.kernels.selective_scan.kernel import SS_SAVE
    from repro_torch.kernels.selective_scan.ref import selective_scan_chunked
    x, dt, bm, cm, a, h = ins
    ys, states = [], []
    for lo in range(0, x.shape[1], SS_SAVE):
        states.append(h)
        y, h = selective_scan_chunked(
            *(t[:, lo:lo + SS_SAVE] for t in (x, dt, bm, cm)), a, h,
            chunk=SS_SAVE)
        ys.append(y)
    return torch.cat(ys, 1), h, torch.stack(states, 1)


def saving_forward_row(torch, ins):
    """The forward kernel as autograd launches it (`save_chunks`: it also
    writes the state entering every 16 steps) at the training microbatch
    `ins`: y, h_last and the chunk states within 1e-4 of the largest |y|,
    |h| and |state| of `plain_saving_forward` (f32; other orders of
    sums), timed beside it. The bound: the larger of the bytes (x, y, dt,
    B, C, A, h0, h_last and the chunk states once) over the HBM rate and
    one exp and six flops per (b, t, d, n) over the SFU's and the f32
    rate. Returns the row, its `shape` named."""
    from repro_torch.kernels.selective_scan.kernel import selective_scan_fused
    got = selective_scan_fused(*ins, save_chunks=True)
    torch.cuda.synchronize()
    want = plain_saving_forward(torch, ins)
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    off = [e / float(w.abs().max()) for e, w in zip(errs, want)]
    check(max(off) <= 1e-4, "selective_scan (saving forward) differs from "
          "its plain version: y, h_last, chunk states " + ", ".join(
              f"{o:.3e}" for o in off) + " of max |plain|")
    x, dt, bm, _, a, h0 = ins
    b, s, d = x.shape
    n = bm.shape[-1]
    chunks = got[2]
    elems = b * s * d * n
    t_bytes = 4 * (2 * x.numel() + dt.numel() + 2 * bm.numel() + a.numel()
                   + 2 * h0.numel() + chunks.numel()) / HBM_BYTES_PER_S
    t_ops = max(elems / EXP_PER_S, 6 * elems / OPS_PER_S)
    bnd = ((t_ops * 1e3, "operations") if t_ops >= t_bytes
           else (t_bytes * 1e3, "bytes"))
    r = dict(max_abs_err=max(errs), lanes=b * d,
             ms=median_ms(torch, lambda: selective_scan_fused(
                 *ins, save_chunks=True)),
             plain_ms=median_ms(torch, lambda: plain_saving_forward(
                 torch, ins), 3),
             library_ms=None, bound=bnd,
             shape=(f"the saving forward (save_chunks, under autograd) at "
                    f"{HYMBA_ARCH}'s training microbatch: B {b}, S {s}, D "
                    f"{d}, N {n}"))
    print(f"kernel selective_scan at {r['shape']}: {r['ms']:.6f} ms (plain "
          f"{r['plain_ms']:.6f}, bound {bnd[0]:.7f} ms by {bnd[1]}); max "
          f"|kernel - plain| / max |plain| y, h_last, chunk states "
          + ", ".join(f"{o:.3e}" for o in off), flush=True)
    del got, want
    return r


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def make_stream(seed: int):
    """The seeded plan stream: preload, Workload 1, Workload 2, as
    (tag, ops int32, keys uint64, vals uint64) per plan."""
    rng = np.random.default_rng(seed)
    n_pre = 3 * (1 << LOG2_CAPACITY) // 4
    n_fresh = WL_PLANS * 2 * (WL_LANES // 10)
    keys = np.unique(rng.integers(1, 2**64 - 2, n_pre + n_fresh + 4096,
                                  dtype=np.uint64))
    keys = rng.permutation(keys)
    pre, fresh = keys[:n_pre], keys[n_pre:n_pre + n_fresh]
    plans = []
    for i in range(0, n_pre, PRELOAD_LANES):
        k = pre[i:i + PRELOAD_LANES]
        plans.append(("preload", np.full(len(k), OP_INSERT, np.int32), k,
                      rng.integers(0, 2**64 - 1, len(k), dtype=np.uint64)))
    n_ins = WL_LANES // 10
    n_del = WL_LANES // 50
    f = 0
    for wl, erase in (("wl1", False), ("wl2", True)):
        for _ in range(WL_PLANS):
            nd = n_del if erase else 0
            ops = np.concatenate([np.full(n_ins, OP_INSERT, np.int32),
                                  np.full(nd, OP_DELETE, np.int32),
                                  np.full(WL_LANES - n_ins - nd, OP_FIND,
                                          np.int32)])
            k = np.concatenate([fresh[f:f + n_ins],
                                rng.choice(pre, WL_LANES - n_ins)])
            f += n_ins
            perm = rng.permutation(WL_LANES)
            plans.append((wl, ops[perm], k[perm],
                          rng.integers(0, 2**64 - 1, WL_LANES,
                                       dtype=np.uint64)))
    return plans


def dict_oracle(plans):
    """Host-side reference semantics, sharing no code with the port:
    inserts (insert-if-absent, first lane wins), then deletes, then finds.
    Returns (per plan (ok bool[K], vals uint64[K]), the live dict)."""
    d = {}
    out = []
    for _, ops, keys, vals in plans:
        ok = np.zeros(len(ops), bool)
        res = np.zeros(len(ops), np.uint64)
        ins = np.flatnonzero(ops == OP_INSERT)
        ik, iv = keys[ins], vals[ins]
        # a key's first insert lane inserts it unless the dict holds it;
        # every later lane of that key finds it present
        first = np.zeros(ins.size, bool)
        first[np.unique(ik, return_index=True)[1]] = True
        new = first.copy()
        new[first] = [k not in d for k in ik[first].tolist()]
        d.update(zip(ik[new].tolist(), iv[new].tolist()))
        ok[ins] = True
        res[ins[~new]] = 1
        dels = np.flatnonzero(ops == OP_DELETE)
        ok[dels] = [d.pop(k, None) is not None
                    for k in keys[dels].tolist()]
        finds = np.flatnonzero(ops == OP_FIND)
        got = [d.get(k) for k in keys[finds].tolist()]
        hit = np.asarray([v is not None for v in got], bool)
        ok[finds[hit]] = True
        res[finds[hit]] = np.asarray([v for v in got if v is not None],
                                     np.uint64)
        out.append((ok, res))
    return out, d


def make_pq_stream(seed: int):
    """The pq cell: the serving scheduler's admission queue (keys
    (priority << 32) | ticket with one monotone ticket counter, values the
    request ids RID_BASE + ticket), with its expected results from a host
    oracle of per-band FIFOs that shares no code with the port.

    Preload: capacity / 2 requests in plans of PRELOAD_LANES inserts
    (`pq_preload`). Workload P1: WL_PLANS plans of PQ_INSERTS fresh
    requests (priority 0 for every INVERSION_EVERY-th ticket, else 1 or
    2), PQ_POPS POPMIN and PQ_POPS POPK lanes in a seeded order. Workload
    P2: the same plus PQ_FINDS finds, half on pending and half on popped
    keys, and one more lane: idle, or in plans PQ_CANCEL_PLANS the band-2
    cancel (`serving/scheduler.py: cancel_class`), a RANGE_DELETE over
    [2 << 32, 3 << 32). Linearization per plan: inserts, the cancel, the
    pops in lane order (the j-th pop lane takes the j-th smallest live
    key), then the finds. Returns (plans, expected (ok, vals) per plan,
    final {size, pops, pop_empty})."""
    rng = np.random.default_rng(seed)
    prio, ticket = pq_preload(rng)
    n_all = ticket.size + 2 * WL_PLANS * PQ_INSERTS
    prio_of = np.zeros(n_all, np.uint64)
    prio_of[:ticket.size] = prio
    live = np.zeros(n_all, bool)
    bands = [ticket[prio == b] for b in range(3)]   # FIFO = ticket order
    heads = [0, 0, 0]
    popped_log = []
    counters = {"pops": 0, "pop_empty": 0}
    key_of = lambda t: (prio_of[t] << np.uint64(32)) | t.astype(np.uint64)
    plans, expect = [], []
    for i in range(0, ticket.size, PRELOAD_LANES):
        t = ticket[i:i + PRELOAD_LANES]
        plans.append(("preload", np.full(t.size, OP_INSERT, np.int32),
                      key_of(t), RID_BASE + t))
        expect.append((np.ones(t.size, bool), np.zeros(t.size, np.uint64)))
    live[:ticket.size] = True
    nxt = ticket.size
    for wl in ("pq1", "pq2"):
        for p in range(WL_PLANS):
            new = np.arange(nxt, nxt + PQ_INSERTS, dtype=np.uint64)
            nxt += PQ_INSERTS
            urgent = (new + 1) % INVERSION_EVERY == 0
            prio_of[new] = np.where(urgent, 0, rng.integers(
                1, 3, new.size)).astype(np.uint64)
            ops = [np.full(new.size, OP_INSERT, np.int32),
                   np.full(PQ_POPS, OP_POPMIN, np.int32),
                   np.full(PQ_POPS, OP_POPK, np.int32)]
            keys = [key_of(new), np.zeros(2 * PQ_POPS, np.uint64)]
            vals = [RID_BASE + new, np.zeros(2 * PQ_POPS, np.uint64)]
            if wl == "pq2":
                probe = rng.integers(0, nxt - new.size, 8 * PQ_FINDS)
                pend = probe[live[probe]][:PQ_FINDS // 2]
                gone = (rng.choice(np.concatenate(popped_log), PQ_FINDS
                                   - pend.size) if popped_log else
                        probe[:PQ_FINDS - pend.size])
                f = np.concatenate([pend, gone]).astype(np.uint64)
                cancel = p in PQ_CANCEL_PLANS
                ops += [np.full(PQ_FINDS, OP_FIND, np.int32),
                        np.array([OP_RANGE_DELETE if cancel else OP_NONE],
                                 np.int32)]
                keys += [key_of(f), np.array([2 << 32], np.uint64)]
                vals += [np.zeros(PQ_FINDS, np.uint64),
                         np.array([3 << 32], np.uint64)]
            perm = rng.permutation(sum(o.size for o in ops))
            ops = np.concatenate(ops)[perm]
            keys = np.concatenate(keys)[perm]
            vals = np.concatenate(vals)[perm]
            plans.append((wl, ops, keys, vals))

            # the oracle, in linearization order
            ok = np.zeros(ops.size, bool)
            res = np.zeros(ops.size, np.uint64)
            ins = ops == OP_INSERT
            ok[ins] = True
            live[new] = True
            for b in range(3):
                bands[b] = np.concatenate([bands[b], new[prio_of[new] == b]])
            rd = np.flatnonzero(ops == OP_RANGE_DELETE)
            if rd.size:
                gone_t = bands[2][heads[2]:]
                live[gone_t] = False
                heads[2] = bands[2].size
                ok[rd], res[rd] = gone_t.size > 0, gone_t.size
            pops = np.flatnonzero((ops == OP_POPMIN) | (ops == OP_POPK))
            take = []
            for b in range(3):
                n = min(pops.size - sum(x.size for x in take),
                        bands[b].size - heads[b])
                take.append(bands[b][heads[b]:heads[b] + n])
                heads[b] += n
            took = np.concatenate(take)
            live[took] = False
            popped_log.append(took)
            hit = pops[:took.size]
            ok[hit] = True
            res[hit] = np.where(ops[hit] == OP_POPMIN, RID_BASE + took,
                                key_of(took))
            counters["pops"] += took.size
            counters["pop_empty"] += pops.size - took.size
            fi = np.flatnonzero(ops == OP_FIND)
            ft = keys[fi] & np.uint64(0xFFFFFFFF)
            ok[fi] = live[ft]
            res[fi] = np.where(live[ft], RID_BASE + ft, 0)
            expect.append((ok, res))
    counters["size"] = int(live.sum())
    return plans, expect, counters


def to_device(torch, plans):
    from repro_torch.core.bits import from_u64
    return [(tag, torch.from_numpy(ops).to(DEV), from_u64(k, DEV),
             from_u64(v, DEV)) for tag, ops, k, v in plans]


def leaves_equal(torch, a, b) -> bool:
    """Two states' leaves equal (tensors, and static ints like max_load)."""
    from repro_torch.convert import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if torch.is_tensor(x) else x == y
        for x, y in zip(la, lb))


# launches a wrapper call makes, and the launches by (kernel, call shape)
# harvested from every cell of the main path and the serving and hymba
# phases (`harvest_shapes`)
LAUNCHES_A_CALL = {"tier_apply": 2, "tier_find": 1, "pq_pop": 2,
                   "skiplist_search": 1, "hash_probe": 1,
                   "bskiplist_walk": 1, "splitorder_probe": 1}
SHAPE_LAUNCHES = collections.Counter()


def harvest_shapes(cuda) -> dict:
    """The launches by call shape since the counts were last set to 0,
    added to SHAPE_LAUNCHES; each kernel's must be whole calls."""
    got = dict(cuda.SHAPE_LAUNCHES)
    for (name, shape), n in got.items():
        per = LAUNCHES_A_CALL[name.split("/")[0]]
        check(n % per == 0, f"{name} at {shape}: {n} launches, not whole "
              f"calls of {per}")
    SHAPE_LAUNCHES.update(got)
    return got


def calls_by_shape(shapes) -> dict:
    return {f"{name}@{shape}": n // LAUNCHES_A_CALL[name.split("/")[0]]
            for (name, shape), n in sorted(shapes.items())}


def run_cell(torch, label, backend, cap, modes, dev_plans, on_plan):
    """Drive one cell: every plan through a one-shard `StoreEngine` per
    exec mode, gpu == torch per plan and on the final state, `on_plan(p,
    ok, vals, state)` on the gpu results (numpy) and the shard's state. The launch counts are
    set to 0 just before the cell and read just after. Returns (report
    row, final states by mode, stats, launches)."""
    from repro_torch.kernels import cuda
    from repro_torch.store import exec as exec_
    from repro_torch.store.engine import LOCAL_MESH, StoreEngine
    t_be = time.perf_counter()
    widths = sorted({ops.shape[0] for _, ops, _, _ in dev_plans})
    engines = {(m, w): StoreEngine(LOCAL_MESH, LOCAL_MESH.axis_names, w,
                                   backend, pool_factor=1, exec_mode=m,
                                   device=DEV)
               for m in modes for w in widths}
    states = {m: engines[(m, widths[0])].init(cap) for m in modes}
    secs = {(m, t): 0.0 for m in modes for t in ("preload", "wl")}
    lanes = {"preload": 0, "wl": 0}
    disp = {}
    torch.cuda.synchronize()
    cuda.reset_launches()
    for p, (tag, ops, keys, vals) in enumerate(dev_plans):
        t = "preload" if tag == "preload" else "wl"
        lanes[t] += ops.shape[0]
        res = {}
        for m in modes:
            eng = engines[(m, ops.shape[0])]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with exec_.measure_dispatches() as meter:
                states[m], rv, rok, _ = eng.step(states[m], ops, keys, vals)
            torch.cuda.synchronize()
            secs[(m, t)] += time.perf_counter() - t0
            res[m] = (rok, rv)
            if m == "gpu":
                disp[t] = (meter.n, meter.probe, meter.update)
        if "torch" in modes:
            check(torch.equal(res["gpu"][0], res["torch"][0])
                  and torch.equal(res["gpu"][1], res["torch"][1]),
                  f"{label} plan {p}: gpu != torch")
        on_plan(p, res["gpu"][0].cpu().numpy(),
                res["gpu"][1].cpu().numpy().view(np.uint64), states["gpu"][0])
    torch.cuda.synchronize()
    launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    # tier_apply and pq_pop: one call on every plan, in launches a call
    shapes = harvest_shapes(cuda)
    plans_of = collections.Counter(ops.shape[0] for _, ops, _, _ in dev_plans)
    for (name, shape), n in shapes.items():
        if name.startswith("tier_apply") or name == "pq_pop":
            width = shape if isinstance(shape, int) else shape[0]
            check(n == LAUNCHES_A_CALL[name.split("/")[0]] * plans_of[width],
                  f"{label}: {n} {name} launches at {shape} on "
                  f"{plans_of[width]} plans of {width} lanes")
    if "torch" in modes:
        check(leaves_equal(torch, states["gpu"], states["torch"]),
              f"{label}: final state gpu != torch")
    stats = {k: int(v[0]) for k, v in
             engines[("gpu", widths[0])].stats(states["gpu"]).items()
             if k != "seq"}
    row = {"capacity": cap, "stats": {k: v for k, v in stats.items() if v}}
    for m in modes:
        for t in ("preload", "wl"):
            row[f"{m}_{t}_ops_per_s"] = lanes[t] / secs[(m, t)]
    row["dispatches_per_plan"] = {t: dict(zip(("n", "probe", "update"), v))
                                  for t, v in disp.items()}
    row["launches"] = launches
    row["calls_by_shape"] = calls_by_shape(shapes)
    print(f"backend {label}: " + json.dumps(row), flush=True)
    print(f"backend {label}: {time.perf_counter() - t_be:.3f} s", flush=True)
    return row, states, stats, launches


def walk_misses(torch, st, keys, want):
    """The FIND lanes whose keys a rand_skiplist walk missed, checked to be
    stored: each key is live in the terminal array (a binary search of
    it) with the oracle's value. Returns how many there are."""
    from repro_torch.core.bits import from_u64, ordered
    if keys.size == 0:
        return 0
    k = from_u64(keys, DEV)
    pos = torch.searchsorted(ordered(st.term_keys), ordered(k)).clamp(
        max=st.capacity - 1)
    check(bool(((st.term_keys[pos] == k) & ~st.term_mark[pos]).all())
          and np.array_equal(st.term_vals[pos].cpu().numpy().view(np.uint64),
                             want),
          "rand_skiplist: a missed FIND lane's key is not stored")
    return keys.size


def main_path(torch, plans, oracle, n_live, pq_plans, pq_expect, pq_final):
    """Every cell of the main path, each checked; returns the launches per
    kernel summed over the cells."""
    from repro_torch.kernels import cuda
    from repro_torch.store import tiers
    C = 1 << LOG2_CAPACITY
    dev_plans = to_device(torch, plans)
    torch.cuda.synchronize()
    flat_results = []
    totals = {k: 0 for k in cuda.LAUNCHES}
    b128_final = None
    misses = {}

    def check_oracle(label):
        """Every plan == the dict oracle == det_skiplist, lane for lane.
        rand_skiplist may miss a stored key in a FIND lane (the
        reference's MAX_GAP walk, ROADMAP.md §4): such lanes are counted
        and each must be a stored key; every other lane must agree."""
        def on_plan(p, ok, rv, st):
            miss = np.zeros(ok.shape, bool)
            if label == "rand_skiplist":
                ops, keys = plans[p][1], plans[p][2]
                miss = (ops == OP_FIND) & oracle[p][0] & ~ok
                misses[p] = walk_misses(torch, st, keys[miss],
                                        oracle[p][1][miss])

            def agree(ref):
                return bool((((ok == ref[0]) & (rv == ref[1])) | miss).all())
            check(agree(oracle[p]), f"{label} plan {p}: results differ "
                  f"from the dict oracle")
            if label == "det_skiplist":
                flat_results.append((ok, rv))
            else:
                check(agree(flat_results[p]), f"{label} plan {p}: results "
                      f"differ from det_skiplist")
        return on_plan

    def expect_launches(label, launches, names):
        for name in names:
            check(launches.get(name, 0) > 0, f"kernel {name} never "
                  f"launched in the {label} cell")
        if not names:
            check(not launches, f"the {label} cell launched {launches}")
        for k, v in launches.items():
            totals[k] += v

    for label, name, shift, modes, need in MAIN_CELLS:
        backend = (tiers.unfused_twin(name) if label.endswith("unfused")
                   else name)
        on_plan = ((lambda p, ok, rv, st: None) if name == "fixed_hash"
                   else check_oracle(label))
        _, states, stats, launches = run_cell(
            torch, label, backend, C >> shift, modes, dev_plans, on_plan)
        expect_launches(label, launches, need)
        if name != "fixed_hash":
            check(stats["size"] == n_live, f"{label}: size {stats['size']} "
                  f"!= oracle {n_live}")
        if label == "tiered3/b128":
            check(not launches.get("tier_find/level")
                  and not launches.get("tier_apply/level"),
                  "tiered3/b128 ran the level-major walk")
            b128_final = states["gpu"]
        elif label == "tiered3/b128 unfused":
            check(leaves_equal(torch, states["gpu"], b128_final),
                  "tiered3/b128: unfused final state != fused")
            b128_final = None
        elif label == "rand_skiplist":
            wl = [misses[p] for p, pl in enumerate(plans) if pl[0] != "preload"]
            print(f"rand_skiplist: the walk missed {sum(wl)} stored keys in "
                  f"{sum(int((pl[1] == OP_FIND).sum()) for pl in plans)} "
                  f"FIND lanes (per workload plan: {wl}); forced promotions "
                  f"{int(states['gpu'][0].forced)}, level counts "
                  f"{states['gpu'][0].level_count.tolist()}", flush=True)
        del states
        torch.cuda.empty_cache()
    del dev_plans

    def check_pq(p, ok, rv, st):
        check(np.array_equal(ok, pq_expect[p][0])
              and np.array_equal(rv, pq_expect[p][1]),
              f"pq plan {p}: results differ from the per-band FIFO oracle")

    _, states, stats, launches = run_cell(
        torch, "pq", "pq", 1 << PQ_LOG2_CAPACITY, BOTH,
        to_device(torch, pq_plans), check_pq)
    expect_launches("pq", launches, PQ_KERNELS)
    for k, v in pq_final.items():
        check(stats[k] == v, f"pq: {k} {stats[k]} != oracle {v}")
    del states
    torch.cuda.empty_cache()
    print("main-path launches: " + json.dumps(totals), flush=True)
    return totals


# ---------------------------------------------------------------------------
# phase 4: the LLM serving engine at qwen3-1.7b full width
# ---------------------------------------------------------------------------

def planted_fault(torch, name):
    """The plain attention with a planted fault, for check (b)'s control:
    "page skipped" drops each request's middle live page, "own token left
    out" attends over one token less (the new token itself), "bf16
    attention" computes the scores, the softmax and the weighted sum in
    bf16 instead of f32."""
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    def fault(q, k_pool, v_pool, tables, lengths):
        if name == "page skipped":
            mid = ((lengths.long() - 1) // k_pool.shape[1]) // 2
            tables = tables.clone()
            tables[torch.arange(tables.shape[0], device=tables.device),
                   mid] = -1
        elif name == "own token left out":
            lengths = lengths - 1
        else:
            b, h, d = q.shape
            _, page, hkv, _ = k_pool.shape
            p = tables.shape[1]
            safe = tables.clamp(min=0).long()
            k = k_pool[safe].reshape(b, p * page, hkv, d)
            v = v_pool[safe].reshape(b, p * page, hkv, d)
            pos = torch.arange(p * page, device=q.device)[None, :]
            valid = ((pos < lengths[:, None])
                     & (tables >= 0).repeat_interleave(page, dim=1))
            qg = q.reshape(b, hkv, h // hkv, d).to(torch.bfloat16)
            sc = torch.einsum("bkgd,bskd->bkgs", qg, k.to(torch.bfloat16))
            sc = (sc / math.sqrt(d)).masked_fill(~valid[:, None, None, :],
                                                 float("-inf"))
            w = torch.softmax(sc, dim=-1)
            return torch.einsum("bkgs,bskd->bkgd", w,
                                v.to(torch.bfloat16)).reshape(b, h, d)
        return paged_attention_ref(q, k_pool, v_pool, tables, lengths)
    return fault


def recorded_routes(torch, sink: list):
    """A context in which every `moe.router_probs` call appends (the
    sorted expert ids [T, k], the router logit margin between the k-th
    and the (k+1)-th expert [T]) to `sink`."""
    from repro_torch.models import moe
    route = moe.router_probs

    def recording(p, cfg, x):
        w, idx, aux = route(p, cfg, x)
        top = torch.topk(x.float() @ p.router.float(),
                         cfg.n_experts_active + 1, dim=-1).values
        sink.append((torch.sort(idx, dim=-1).values, top[..., -2]
                     - top[..., -1]))
        return w, idx, aux

    @contextlib.contextmanager
    def ctx():
        moe.router_probs = recording
        try:
            yield
        finally:
            moe.router_probs = route
    return ctx()


def route_flips(torch, plain, gpu, n, report):
    """Lanes (of the first n) whose experts differ between the plain and
    the gpu run at any layer. At the first layer where a lane's experts
    differ, the plain router's margin at the top-k edge must be below
    MOE_ROUTE_MARGIN (a near tie that the attention's order of sums
    decides; the later layers then see another FFN output); the flipped
    lanes are counted and returned, to be left out of the logit bound."""
    flipped = torch.zeros(n, dtype=torch.bool, device=DEV)
    for (pi, pm), (gi, _) in zip(plain, gpu):
        diff = (pi[:n] != gi[:n]).any(-1)
        first = diff & ~flipped
        if bool(first.any()):
            worst = float(pm[:n][first].max())
            report["flip_margins"].append(worst)
            check(worst < MOE_ROUTE_MARGIN, f"check (b): a lane's experts "
                  f"changed between the plain and the gpu attention at a "
                  f"router margin of {worst:.4f} >= {MOE_ROUTE_MARGIN}")
        flipped |= diff
    report["route_flips"] += int(flipped.sum())
    return flipped


def serve_decode_checked(torch, engine, n_steps, report):
    """Wrap `engine._decode` so its first `n_steps` decode steps also run
    the plain attention (exec mode torch) on the same state first: on the
    active lanes the gpu-mode logits must be within SERVE_B_ULPS bf16 steps
    (at the step's largest plain |logit|) of the plain ones, with the same
    argmax wherever the plain top-2 margin exceeds that bound. Each
    SERVE_B_FAULTS fault of the plain attention runs at the same state
    too, and its distance from the plain logits is recorded beside the
    bound. The plain and faulted runs write the same token slots that the
    gpu run then overwrites, so the state goes on as the gpu run leaves
    it. In an MoE model a lane whose experts differ between the plain and
    the gpu run (`route_flips`) is left out of the bound and counted."""
    from repro_torch.serving import paged_decode
    from repro_torch.store import exec as exec_
    decode = engine._decode
    plain_attend = paged_decode.paged_attention_ref
    report.setdefault("route_flips", 0)
    report.setdefault("flip_margins", [])

    def checked(toks, slots, mask):
        if report["steps"] >= n_steps:
            return decode(toks, slots, mask)
        n = int(mask.sum())
        routes = {"plain": [], "gpu": []}
        with exec_.exec_mode("torch"):
            with recorded_routes(torch, routes["plain"]):
                plain, _ = decode(toks, slots, mask)
            p = plain[:n]
            faulted = {}
            for name in SERVE_B_FAULTS:
                paged_decode.paged_attention_ref = planted_fault(torch, name)
                try:
                    f, _ = decode(toks, slots, mask)
                finally:
                    paged_decode.paged_attention_ref = plain_attend
                faulted[name] = float((f[:n] - p).abs().max())
        with recorded_routes(torch, routes["gpu"]):
            logits, kv = decode(toks, slots, mask)
        keep = ~route_flips(torch, routes["plain"], routes["gpu"], n, report)
        check(bool(keep.any()), "check (b): every lane's experts changed")
        g, p = logits[:n][keep], p[keep]
        big = float(p[:, :engine.cfg.vocab_size].abs().max())
        step = 2.0 ** (math.floor(math.log2(big)) - 7)
        tol = SERVE_B_ULPS * step
        diff = float((g - p).abs().max())
        report["diff"].append(diff)
        report["tol"].append(tol)
        report["bad"] += int(diff > tol)
        for name, fd in faulted.items():
            report["faults"].setdefault(name, []).append(fd / step)
        report["steps_of_diff"].append(diff / step)
        top = torch.topk(p, 2, dim=-1).values
        wide = (top[:, 0] - top[:, 1]) > tol
        same = torch.argmax(g, -1) == torch.argmax(p, -1)
        report["argmax_checked"] += int(wide.sum())
        report["argmax_flips"] += int((wide & ~same).sum())
        report["steps"] += 1
        return logits, kv
    engine._decode = checked


@contextlib.contextmanager
def f32_decode_attention(torch):
    """The contiguous decode attention (`models.attention.gqa_decode`)
    with its operands left in f32, as the paged attention keeps them."""
    from repro_torch.models import attention
    rounded = attention.bf16_einsum
    attention.bf16_einsum = lambda eq, a, b: torch.einsum(eq, a.float(),
                                                          b.float())
    try:
        yield
    finally:
        attention.bf16_einsum = rounded


def serve_reference_check(torch, cfg, params, trace,
                          n_prompts=SERVE_A_PROMPTS, n_new=SERVE_A_NEW,
                          n_pages=SERVE_A_PAGES):
    """Check (a): f32 compute at full width. The first `n_prompts` trace
    prompts, `n_new` tokens each, through the Engine in exec mode gpu;
    the engine's own tokens are then fed to the port's contiguous
    `prefill` + `decode_step`, and each engine token must be the
    reference's argmax unless the reference's top-2 margin at that step
    is below SERVE_A_MARGIN (those steps are counted). The contiguous
    decode attention rounds q and the softmax weights to bf16 where the
    paged one (kernel and plain version alike) keeps them in f32, so the
    reference's decode steps run with that rounding off
    (`f32_decode_attention`): the two then differ only in the order of
    their f32 sums. In an MoE model the engine's and the reference's
    experts are recorded at every decode token; a token whose experts
    differ at some layer is left out (and counted) only where the
    reference's router margin at the first such layer is below
    MOE_ROUTE_MARGIN, and from
    that token on the two caches hold different K/V for it, so the
    request's later tokens are left out too (and counted). Returns
    (steps checked, low-margin steps, steps left out at and after a
    route tie)."""
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine, Request
    cfg32 = cfg.replace(compute_dtype="float32")
    reqs = trace[:n_prompts]
    eng = Engine(cfg32, params, max_reqs=n_prompts, num_pages=n_pages,
                 page_size=SERVE_PAGE, max_pages_per_req=SERVE_PAGES_PER_REQ,
                 device=DEV)
    for r in reqs:
        eng.submit(Request(req_id=r.req_id, prompt=r.prompt,
                           max_new=n_new, priority=r.priority))
    eng_routes = {}
    decode = eng._decode

    def recorded(toks, slots, mask):
        sink = []
        with recorded_routes(torch, sink):
            out = decode(toks, slots, mask)
        for i, slot in enumerate(slots[:int(mask.sum())].tolist()):
            req = eng.requests[eng.slot_to_req[slot]]
            eng_routes[req.req_id, len(req.out)] = [idx[i] for idx, _ in sink]
        return out
    eng._decode = recorded
    outs = eng.run(max_steps=4 * n_new)
    checked, low, ties = 0, 0, 0
    for r in reqs:
        out = outs[r.req_id]
        check(len(out) == n_new, f"check (a): request {r.req_id} "
              f"gave {len(out)} tokens")
        plen = len(r.prompt)
        toks = torch.from_numpy(r.prompt.astype(np.int64)).to(DEV)[None]
        logits, caches, _ = M.prefill(params, cfg32, toks,
                                      cache_len=plen + n_new)
        lg, ref_routes, tied = logits[0, -1], [], False
        for t in range(n_new):
            top = torch.topk(lg, 2)
            margin = float(top.values[0] - top.values[1])
            # the reference's margin at the first layer whose experts differ
            flips = [float(m[0]) for (i, m), e in zip(
                ref_routes, eng_routes.get((r.req_id, t), []))
                if not torch.equal(i[0], e)]
            if flips and not tied:
                check(flips[0] < MOE_ROUTE_MARGIN, f"check (a): request "
                      f"{r.req_id} token {t}: the experts differ at a "
                      f"router margin of {flips[0]:.4f}")
                tied = True
            if tied:
                ties += 1
            elif margin < SERVE_A_MARGIN:
                low += 1
            else:
                check(out[t] == int(top.indices[0]), f"check (a): request "
                      f"{r.req_id} token {t}: engine {out[t]} != reference "
                      f"{int(top.indices[0])} (margin {margin:.3e})")
            checked += 1
            if t + 1 < n_new:
                tok = torch.tensor([[out[t]]], device=DEV)
                pos = torch.tensor([plen + t], device=DEV)
                ref_routes = []
                with recorded_routes(torch, ref_routes), \
                        f32_decode_attention(torch):
                    lgs, caches = M.decode_step(params, cfg32, tok, pos,
                                                caches)
                lg = lgs[0, 0]
    check(int(eng.kv.pool.num_free()) == n_pages,
          "check (a): pages leaked")
    del eng, caches
    torch.cuda.empty_cache()
    return checked, low, ties


def check_served(torch, label, engine, trace, outs, launches, n_pages):
    """What a served replay must give: every request its `max_new`
    tokens, every page free, prefix hits, the scheduler's pops, and
    paged_attention launched once a layer a decode step with the other
    SERVE_KERNELS launched. Returns the engine's metrics."""
    from repro_torch.serving import scheduler as SCH
    from repro_torch.store import obs
    for r in trace:
        req = engine.requests[r.req_id]
        check(req.done and not req.shed and len(outs[r.req_id]) == r.max_new,
              f"{label}: request {r.req_id} gave {len(outs[r.req_id])} of "
              f"{r.max_new} tokens")
    kv = engine.kv
    check(int(kv.pool.num_free()) == n_pages
          and not bool(kv.refcount.any()) and not bool(kv.pool.in_use.any())
          and not bool(kv.active.any()), f"{label}: pages leaked")
    m = engine.metrics()
    check(tuple(m) == obs.SERVING_SCHEMA, f"{label}: metrics keys")
    check(m["prefix_hits"] > 0, f"{label}: no prefix hits")
    check(m["decode_steps"] == engine.steps and m["ring_depth"] == 0,
          f"{label}: decode steps and ring depth")
    pops = SCH.metrics(engine.sched)["pops"]
    check(pops == len(trace), f"{label}: the scheduler popped {pops}")
    n_layers = engine.cfg.n_layers
    check(launches.get("paged_attention", 0) == engine.steps * n_layers,
          f"{label}: paged_attention launched "
          f"{launches.get('paged_attention', 0)} times for "
          f"{engine.steps} decode steps of {n_layers} layers")
    for name in SERVE_KERNELS:
        check(launches.get(name, 0) > 0, f"kernel {name} never launched in "
              f"the {label} path")
    return m


def report_check_b(label, b_report, n_steps):
    """Print check (b)'s readings and its planted faults' and require
    them (`serve_decode_checked`)."""
    flips = ""
    if b_report["flip_margins"]:
        flips = (f"; {b_report['route_flips']} lane-steps left out where "
                 f"the experts changed, at router margins "
                 f"{b_report['flip_margins']}")
    print(f"{label} check (b): {n_steps} bf16 decode steps, gpu vs "
          f"plain attention: max |dlogits| per step {b_report['diff']}, "
          f"bounds {b_report['tol']}; argmax equal on "
          f"{b_report['argmax_checked'] - b_report['argmax_flips']} of "
          f"{b_report['argmax_checked']} lanes with a margin above the "
          f"bound{flips}", flush=True)
    check(b_report["steps"] == n_steps and b_report["bad"] == 0
          and b_report["argmax_flips"] == 0, f"{label} check (b)")

    def fmt(xs):
        return "[" + ", ".join(f"{x:.2f}" for x in xs) + "]"
    print(f"{label} check (b) in bf16 steps at the largest |logit|: gpu vs "
          f"plain {fmt(b_report['steps_of_diff'])}, bound {SERVE_B_ULPS}",
          flush=True)
    for name in SERVE_B_FAULTS:
        fs = b_report["faults"][name]
        print(f"{label} check (b) control, plain vs {name}: {fmt(fs)} "
              f"(min {min(fs):.2f}, max {max(fs):.2f})", flush=True)
    for name in SERVE_B_MUST_FAIL:
        check(min(b_report["faults"][name]) > SERVE_B_ULPS, f"{label} check "
              f"(b): the planted fault '{name}' stays within the bound")


def served_times(tr, m, engine, b_steps):
    """Decode and prefill rates from the engine's spans (decode spans end
    on the argmax copy, prefill spans on the first token's: both wait for
    the card), past the first `b_steps` checked decode steps."""
    dec = [s for s in tr.spans if s.name == "decode"][b_steps:]
    pre = [s for s in tr.spans if s.name == "prefill"]
    dec_s = sum(s.dur_ns for s in dec) / 1e9
    pre_tokens = sum(s.args["plen"] - s.args["shared_pages"] * SERVE_PAGE
                     for s in pre)
    pre_s = sum(s.dur_ns for s in pre) / 1e9
    return dict(
        decode_tokens_per_s=sum(s.args["batch"] for s in dec) / dec_s,
        decode_ms_per_step=1e3 * dec_s / len(dec),
        prefill_tokens_per_s=pre_tokens / pre_s,
        batch_fill=m["batch_fill"], prefix_hit_rate=m["prefix_hit_rate"],
        prefix_hits=m["prefix_hits"], decode_steps=engine.steps,
        prefill_tokens=pre_tokens, prefills=len(pre))


def serving_phase(torch, seed: int):
    """qwen3-1.7b at full width and depth (28 layers), seeded f32
    parameters, bf16 compute, served by `Engine` (max_reqs 32, 4,096 pages
    of 16 tokens, 128 pages a request) on the `make_trace` trace of 64
    requests, driven by `replay`. Launch counts are set to 0 just before
    the served run and read just after. Then the trace again with the
    scheduler's store dropped at SERVE_FAULT_STEPS: the tokens must equal
    the fault-free run's. Returns (launches, report)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda
    from repro_torch.models.model import init_params
    from repro_torch.serving import traffic
    from repro_torch.serving.engine import Engine
    from repro_torch.store import obs
    from repro_torch.store.resilience import Fault, FaultPlan
    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(DEV).manual_seed(seed))
    n_params = sum(p.numel() for p in params.parameters())
    trace = traffic.make_trace(seed, **SERVE_TRACE)
    engine = Engine(cfg, params, max_reqs=SERVE_BATCH,
                    num_pages=SERVE_NUM_PAGES, page_size=SERVE_PAGE,
                    max_pages_per_req=SERVE_PAGES_PER_REQ, device=DEV)
    torch.cuda.synchronize()
    plens = [len(r.prompt) for r in trace]
    print(f"serving: {cfg.name} {cfg.n_layers} layers, {n_params} "
          f"parameters ({cfg.param_dtype}, compute {cfg.compute_dtype}); "
          f"trace of {len(trace)} requests, prompts {min(plens)}.."
          f"{max(plens)} tokens, arrivals over ticks 0.."
          f"{trace[-1].arrival}; set-up {time.perf_counter() - t0:.3f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
          flush=True)
    b_report = dict(steps=0, diff=[], tol=[], bad=0, argmax_checked=0,
                    argmax_flips=0, faults={}, steps_of_diff=[])
    serve_decode_checked(torch, engine, SERVE_B_STEPS, b_report)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    cuda.reset_launches()
    t0 = time.perf_counter()
    with obs.tracing() as tr:
        outs = traffic.replay(engine, trace, max_steps=SERVE_MAX_TICKS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    harvest_shapes(cuda)
    print(f"serving: replay {wall:.3f} s, {engine.steps} decode steps, "
          f"launches {json.dumps(launches)}", flush=True)

    m = check_served(torch, "serving", engine, trace, outs, launches,
                     SERVE_NUM_PAGES)
    report_check_b("serving", b_report, SERVE_B_STEPS)
    report = served_times(tr, m, engine, SERVE_B_STEPS)
    report.update(replay_s=wall,
                  peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"serving decode: {report['decode_tokens_per_s']:.1f} tokens/s, "
          f"{report['decode_ms_per_step']:.3f} ms/step over decode steps "
          f"{SERVE_B_STEPS + 1}..{engine.steps}", flush=True)
    print(f"serving prefill: {report['prefill_tokens_per_s']:.1f} tokens/s "
          f"({report['prefill_tokens']} tokens in {report['prefills']} "
          f"prefills)", flush=True)
    print(f"serving batch fill: {report['batch_fill']:.4f}", flush=True)
    print(f"serving prefix hit rate: {report['prefix_hit_rate']:.4f} "
          f"({m['prefix_hits']} of {m['prefix_lookups']} pages)", flush=True)
    print(f"serving: peak {report['peak_gib']:.2f} GiB allocated", flush=True)
    n_steps = engine.steps
    del engine
    torch.cuda.empty_cache()

    # the fault path: scheduler store drops, recovered from the journal
    check(max(SERVE_FAULT_STEPS) < n_steps, "serving: fault steps past the "
          "run")
    fp = FaultPlan(seed, [Fault("shard_drop", st, shard=0)
                          for st in SERVE_FAULT_STEPS])
    faulted = Engine(cfg, params, max_reqs=SERVE_BATCH,
                     num_pages=SERVE_NUM_PAGES, page_size=SERVE_PAGE,
                     max_pages_per_req=SERVE_PAGES_PER_REQ, device=DEV,
                     fault_plan=fp)
    t0 = time.perf_counter()
    f_outs = traffic.replay(faulted, trace, max_steps=SERVE_MAX_TICKS)
    torch.cuda.synchronize()
    f_wall = time.perf_counter() - t0
    fm = faulted.resilience_metrics()
    check(f_outs == outs, "serving fault path: tokens differ from the "
          "fault-free run")
    check(fm["faults_injected"] >= len(SERVE_FAULT_STEPS)
          and fm["recoveries"] >= len(SERVE_FAULT_STEPS)
          and faulted.sched.res.journal.verify(), "serving fault path: "
          "faults not all injected and recovered")
    print(f"serving fault path: store drops at steps {SERVE_FAULT_STEPS}, "
          f"{len(trace)} requests equal the fault-free tokens; replay "
          f"{f_wall:.3f} s; faults_injected {fm['faults_injected']}, "
          f"recoveries {fm['recoveries']}, replayed_ops "
          f"{fm['replayed_ops']}, journal "
          f"{len(faulted.sched.res.journal)} plans", flush=True)
    del faulted
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    checked, low, _ = serve_reference_check(torch, cfg, params, trace)
    print(f"serving check (a): f32, {checked} engine tokens equal the "
          f"contiguous reference's argmax; {low} steps had a top-2 margin "
          f"below {SERVE_A_MARGIN} and were not compared "
          f"({time.perf_counter() - t0:.3f} s)", flush=True)
    del params
    torch.cuda.empty_cache()
    return launches, report


# ---------------------------------------------------------------------------
# phase 5: hymba-1.5b prefill and decode at full width and depth
# ---------------------------------------------------------------------------

def lane_steps(torch, got, plain, vocab):
    """Per lane: max |got - plain| over the real vocabulary in bf16 steps
    at the lane's largest plain |logit|; and those steps."""
    p = plain[..., :vocab].float()
    step = 2.0 ** (torch.floor(torch.log2(p.abs().amax(-1))) - 7)
    d = (got[..., :vocab].float() - p).abs().amax(-1)
    return [float(x) for x in d / step], step


def hymba_check_b(torch, cfg, params, toks, first, caches, gen, report):
    """Check (b), bf16: the gpu prefill's last logits (`first`) and the
    first HYMBA_B_STEPS decode steps from the gpu run's own states
    (`caches` after prefill, the gpu run's tokens `gen`) against exec mode
    torch on the same state, per lane in bf16 steps (`lane_steps`), beside
    the planted faults of the plain path on that state. The plain and
    faulted decodes return new caches and leave the state as it is.
    `report[label]` gets {"sound": per-lane steps, fault name: ...}."""
    from repro_torch.models import model as M
    from repro_torch.store import exec as exec_
    vocab = cfg.vocab_size
    nowin = cfg.replace(sliding_window=0)
    cache_len = caches[0]["k"].shape[2]

    def record(label, got, plain, faults):
        steps, step = lane_steps(torch, got, plain, vocab)
        top = torch.topk(plain[..., :vocab].float(), 2, dim=-1).values
        wide = (top[:, 0] - top[:, 1]) > HYMBA_B_MAX_ULPS * step
        same = torch.argmax(got, -1) == torch.argmax(plain, -1)
        report["argmax_checked"] += int(wide.sum())
        report["argmax_flips"] += int((wide & ~same).sum())
        report["steps"][label] = {"sound": steps, **{
            name: lane_steps(torch, f, plain, vocab)[0]
            for name, f in faults.items()}}

    with exec_.exec_mode("torch"):
        plain = M.prefill(params, cfg, toks, cache_len)[0][:, -1]
        faulted = M.prefill(params, nowin, toks, cache_len)[0][:, -1]
    record("prefill", first, plain, {"window ignored": faulted})
    del plain, faulted
    for t in range(HYMBA_B_STEPS):
        tok = gen[:, t:t + 1]
        pos = torch.full((toks.shape[0],), toks.shape[1] + t, device=DEV)
        c = caches[0]
        with exec_.exec_mode("torch"):
            plain = M.decode_step(params, cfg, tok, pos, caches)[0][:, 0]
            faults = {
                "window ignored":
                    M.decode_step(params, nowin, tok, pos, caches)[0][:, 0],
                "ssm state reset": M.decode_step(
                    params, cfg, tok, pos,
                    ({**c, "ssm": torch.zeros_like(c["ssm"])},))[0][:, 0],
                "conv state reset": M.decode_step(
                    params, cfg, tok, pos,
                    ({**c, "conv": torch.zeros_like(c["conv"])},))[0][:, 0]}
        got, caches = M.decode_step(params, cfg, tok, pos, caches)
        record(f"decode {t}", got[:, 0], plain, faults)
        del plain, faults, got


def within_b(label, lanes) -> bool:
    """Check (b)'s bounds on one step's per-lane bf16 steps."""
    ok = max(lanes) <= HYMBA_B_MAX_ULPS
    if label != "prefill":
        ok = ok and statistics.median(lanes) <= HYMBA_B_MEDIAN_ULPS
    return ok


def hymba_check_a(torch, cfg, params, toks):
    """Check (a), f32 compute on HYMBA_A_PROMPTS prompts: the caches after
    the gpu-mode prefill against the torch-mode prefill's (each within
    HYMBA_A_CACHE_TOL of its largest |plain|, and the torch-mode prefill
    one token short beyond it), then HYMBA_NEW greedy gpu decode steps,
    each token (and the prefill's) the argmax of a torch-mode
    teacher-forced `forward` over prompt + generated tokens unless that
    argmax's top-2 margin is below HYMBA_A_MARGIN. Returns (tokens
    checked, low-margin steps, cache errors, the fault's)."""
    from repro_torch.models import model as M
    from repro_torch.store import exec as exec_
    cfg32 = cfg.replace(compute_dtype="float32")
    t2 = toks[:HYMBA_A_PROMPTS]
    plen = t2.shape[1]
    cache_len = plen + HYMBA_NEW
    logits, caches, _ = M.prefill(params, cfg32, t2, cache_len)
    tok = torch.argmax(logits[:, -1], -1)
    del logits
    with exec_.exec_mode("torch"):
        _, plain, _ = M.prefill(params, cfg32, t2, cache_len)
        _, early, _ = M.prefill(params, cfg32, t2[:, :-1], cache_len)

    def dist(got, ref):
        return float((got.float() - ref.float()).abs().max()
                     / ref.float().abs().max())
    cache_err, fault_err = {}, {}
    for name, ref in plain[0].items():
        got = caches[0][name]
        check(got.shape == ref.shape and got.dtype == ref.dtype,
              f"check (a): cache {name} shape/dtype")
        cache_err[name] = dist(got, ref)
        fault_err[name] = dist(early[0][name], ref)
        tol = HYMBA_A_CACHE_TOL[name]
        check(cache_err[name] <= tol, f"check (a): cache {name} differs by "
              f"{cache_err[name]:.3e} of its largest |plain| > {tol}")
        check(fault_err[name] > tol, f"check (a): cache {name} one step "
              f"early differs by only {fault_err[name]:.3e} <= {tol}")
    del plain, early
    gen = [tok]
    for i in range(HYMBA_NEW):
        pos = torch.full((t2.shape[0],), plen + i, device=DEV)
        lg, caches = M.decode_step(params, cfg32, tok[:, None], pos, caches)
        tok = torch.argmax(lg[:, 0], -1)
        gen.append(tok)
    gen = torch.stack(gen, 1)                        # [2, NEW + 1]
    del caches
    with exec_.exec_mode("torch"):
        full, _ = M.forward(params, cfg32,
                            torch.cat([t2, gen[:, :HYMBA_NEW]], 1))
    ref = full[:, plen - 1:, :cfg.vocab_size]        # predicts gen[:, 0..]
    del full
    top = torch.topk(ref, 2, dim=-1)
    margin = top.values[..., 0] - top.values[..., 1]
    wide = margin >= HYMBA_A_MARGIN
    bad = wide & (gen != top.indices[..., 0])
    check(not bool(bad.any()), f"check (a): {int(bad.sum())} gpu tokens "
          f"differ from the teacher-forced argmax")
    return int(gen.numel()), int((~wide).sum()), cache_err, fault_err


# phases 5 and 10: a few decode steps with kv_cache_dtype float8_e4m3fn
# beside bfloat16 from the same prompts (the phase's first FP8_PROMPT
# tokens), teacher-forced on the bf16 run's greedy tokens. The fp8 cache
# holds half the bytes. Two limits, each on a step's max |logit
# difference| over the bf16 run's max |logit|: against a bf16 cache
# holding the values rounded to fp8 (`cache_writes("grid")`: the same
# values, so only the storage differs) within FP8_GRID_LIMIT, and against
# the bf16 cache within FP8_LOGIT_LIMIT, between the sound readings on
# the H100 (0.0855 hymba, 0.0460 minicpm3-4b) and those of the planted
# fault, each decode step's fp8 entry left unwritten
# (`cache_writes("unwritten")`: 0.1536 and 0.1280), which must exceed
# both
FP8_PROMPT = 1024
FP8_STEPS = 8
FP8_GRID_LIMIT = 1e-3
FP8_LOGIT_LIMIT = 0.11


@contextlib.contextmanager
def cache_writes(torch, how: str, at: list):
    """Every cache write (`models.attention.to_cache`) changed: "grid"
    rounds the values to float8_e4m3fn and back first (torch's cast; the
    model's values lie far inside its range), "unwritten" (the planted
    fault) leaves the position `at[0]`, while a decode step sets it, as
    the prefill left it, zero, so the step's new k/v (or latent and rope
    key) never enter the cache."""
    from repro_torch.models import attention
    real = attention.to_cache

    def write(x, dtype):
        if how == "grid":
            x = x.to(torch.float8_e4m3fn).to(x.dtype)
        elif at[0] is not None:
            x = x.clone()
            x[:, at[0]] = 0
        return real(x, dtype)
    attention.to_cache = write
    try:
        yield
    finally:
        attention.to_cache = real


def fp8_cache_decode(torch, label, cfg, params, toks, names):
    """Prefill toks[:, :FP8_PROMPT] and decode FP8_STEPS steps with the
    `names` cache leaves in bf16, in fp8 (the reference's
    `kv_cache_dtype` lever), in bf16 holding fp8-rounded values and in
    fp8 with the planted fault (`cache_writes`): their bytes, ms a decode
    step, and each step's max |logit difference| over the bf16 run's max
    |logit|, fp8 within FP8_GRID_LIMIT of the rounded run and
    FP8_LOGIT_LIMIT of bf16, the fault beyond both. Returns the reading."""
    from repro_torch.models import model as M
    b = toks.shape[0]
    prompt = toks[..., :FP8_PROMPT]
    cache_len = FP8_PROMPT + FP8_STEPS
    feed, runs = None, {}
    for run, kt in (("bf16", "bfloat16"), ("fp8", "float8_e4m3fn"),
                    ("grid", "bfloat16"), ("unwritten", "float8_e4m3fn")):
        c = cfg.replace(kv_cache_dtype=kt)
        at = [None]
        with torch.no_grad(), (cache_writes(torch, run, at) if run in (
                "grid", "unwritten") else contextlib.nullcontext()):
            lg, caches, _ = M.prefill(params, c, prompt, cache_len)
            logits = [lg[:, -1, :cfg.vocab_size].float()]
            nbytes = sum(leaf.numel() * leaf.element_size()
                         for per in caches for n, leaf in per.items()
                         if n in names)
            dtypes = {str(leaf.dtype) for per in caches
                      for n, leaf in per.items() if n in names}
            toks_fed = [torch.argmax(logits[0], -1)] if feed is None \
                else feed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(FP8_STEPS):
                at[0] = FP8_PROMPT + i
                pos = torch.full((b,), FP8_PROMPT + i, device=DEV)
                lg, caches = M.decode_step(params, c, toks_fed[i][:, None],
                                           pos, caches)
                logits.append(lg[:, 0, :cfg.vocab_size].float())
                if feed is None:
                    toks_fed.append(torch.argmax(logits[-1], -1))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / FP8_STEPS
        feed = toks_fed
        runs[run] = dict(bytes=nbytes, ms=ms, logits=logits, dtypes=dtypes)
        del caches
    scale = [float(r.abs().max()) for r in runs["bf16"]["logits"]]

    def off(run, ref):
        return [float((g - r).abs().max()) / m for g, r, m in zip(
            runs[run]["logits"], runs[ref]["logits"], scale)]
    fp8, fp8_grid = off("fp8", "bf16"), off("fp8", "grid")
    fault, fault_grid = off("unwritten", "bf16"), off("unwritten", "grid")
    agree = sum(int((torch.argmax(g, -1) == torch.argmax(r, -1)).sum())
                for g, r in zip(runs["fp8"]["logits"],
                                runs["bf16"]["logits"]))
    bf_b, f8_b = runs["bf16"]["bytes"], runs["fp8"]["bytes"]

    def steps(o):
        return json.dumps([float(f"{x:.3e}") for x in o])
    print(f"{label} fp8 cache ({'/'.join(names)}): {f8_b} bytes against "
          f"bf16's {bf_b} ({f8_b / bf_b:.3f}x), {b} x {FP8_PROMPT} tokens "
          f"+ {FP8_STEPS} decode steps: {runs['fp8']['ms']:.3f} ms a step "
          f"against {runs['bf16']['ms']:.3f}; logits max |difference| / "
          f"max |bf16| by step: fp8 - bf16 {steps(fp8)} (limit "
          f"{FP8_LOGIT_LIMIT}), fp8 - fp8-rounded bf16 {steps(fp8_grid)} "
          f"(limit {FP8_GRID_LIMIT}); argmax equal on {agree} of "
          f"{b * (FP8_STEPS + 1)}; the planted fault (each decode step's "
          f"entry unwritten) - bf16 {steps(fault)}, - fp8-rounded bf16 "
          f"{steps(fault_grid)}", flush=True)
    check(runs["fp8"]["dtypes"] == {"torch.float8_e4m3fn"},
          f"{label} fp8 cache dtypes {runs['fp8']['dtypes']}")
    check(2 * f8_b == bf_b, f"{label}: fp8 cache {f8_b} bytes, bf16 {bf_b}")
    check(all(math.isfinite(o) for o in fp8), f"{label}: fp8 logits finite")
    for name, o, lim in (("bf16", fp8, FP8_LOGIT_LIMIT),
                         ("fp8-rounded bf16", fp8_grid, FP8_GRID_LIMIT)):
        check(max(o) <= lim, f"{label}: fp8-cache logits {max(o):.3e} of "
              f"max |logit| from the {name} cache's (limit {lim})")
    check(max(fault) > FP8_LOGIT_LIMIT and max(fault_grid) > FP8_GRID_LIMIT,
          f"{label}: the planted fault (each decode step's fp8 entry "
          f"unwritten) stays within a limit ({max(fault):.3e}, "
          f"{max(fault_grid):.3e})")
    return {"fp8_bytes": f8_b, "bf16_bytes": bf_b,
            "fp8_ms": runs["fp8"]["ms"], "bf16_ms": runs["bf16"]["ms"],
            "logit_off": max(fp8), "grid_off": max(fp8_grid),
            "fault_off": max(fault), "fault_grid_off": max(fault_grid)}


def hymba_phase(torch, seed: int):
    """hymba-1.5b at full width and depth (32 layers), seeded f32
    parameters with a bf16 compute copy drawn on the card, attn_impl
    "xla_flash", exec mode gpu: prefill HYMBA_BATCH prompts of
    HYMBA_PROMPT seeded tokens, then HYMBA_NEW greedy decode steps. Launch
    counts are set to 0 just before that run and read just after. Then
    checks (b) and (a). Returns (launches, report)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda
    from repro_torch.models import model as M
    cfg = get_config(HYMBA_ARCH).replace(attn_impl="xla_flash")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(DEV).manual_seed(seed))
    params.load_compute_copy(cfg.compute_dtype)
    n_params = sum(p.numel() for p in params.parameters())
    rng = np.random.default_rng(seed + 15)
    B, P = HYMBA_BATCH, HYMBA_PROMPT
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, P))).to(DEV)
    cache_len = P + HYMBA_NEW
    # warm-up: cuBLAS's and the kernels' first calls, outside the timing
    M.decode_step(params, cfg, toks[:, :1], torch.full((B,), 64, device=DEV),
                  M.prefill(params, cfg, toks[:, :64], 64 + 1)[1])
    torch.cuda.synchronize()
    print(f"hymba: {cfg.name} {cfg.n_layers} layers, {n_params} parameters "
          f"({cfg.param_dtype} + {cfg.compute_dtype} copy), attn_impl "
          f"{cfg.attn_impl}; {B} prompts x {P} tokens, {HYMBA_NEW} decode "
          f"steps; set-up {time.perf_counter() - t0:.3f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
          flush=True)

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    cuda.reset_launches()
    t0 = time.perf_counter()
    logits, caches, _ = M.prefill(params, cfg, toks, cache_len)
    first = logits[:, -1].clone()
    tok = torch.argmax(first, -1)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    del logits
    caches0 = caches
    gen = [tok]
    t0 = time.perf_counter()
    for i in range(HYMBA_NEW):
        pos = torch.full((B,), P + i, device=DEV)
        lg, caches = M.decode_step(params, cfg, tok[:, None], pos, caches)
        tok = torch.argmax(lg[:, 0], -1)
        gen.append(tok)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    harvest_shapes(cuda)
    peak = torch.cuda.max_memory_allocated() / 2**30
    gen = torch.stack(gen, 1)
    print(f"hymba: prefill {t_pre:.3f} s, {HYMBA_NEW} decode steps "
          f"{t_dec:.3f} s, launches {json.dumps(launches)}", flush=True)
    check(bool(torch.isfinite(first[:, :cfg.vocab_size]).all())
          and bool(torch.isfinite(lg[:, 0, :cfg.vocab_size]).all()),
          "hymba: finite logits")
    di = cfg.ssm_expand * cfg.d_model
    want = {"k": (cfg.n_layers, B, cache_len, cfg.n_kv_heads,
                  cfg.resolved_head_dim),
            "conv": (cfg.n_layers, B, cfg.ssm_conv - 1, di),
            "ssm": (cfg.n_layers, B, di, cfg.ssm_state)}
    for name, shape in want.items():
        check(tuple(caches[0][name].shape) == shape, f"hymba: cache {name} "
              f"shape {tuple(caches[0][name].shape)}")
    check(int(gen.max()) < cfg.vocab_size, "hymba: tokens in the vocabulary")
    check(launches.get("flash_attention", 0) == cfg.n_layers,
          f"hymba: flash_attention launched "
          f"{launches.get('flash_attention', 0)} times, not one per layer")
    n_scan = cfg.n_layers * (1 + HYMBA_NEW)
    check(launches.get("selective_scan", 0) == n_scan,
          f"hymba: selective_scan launched "
          f"{launches.get('selective_scan', 0)} times, not {n_scan}")
    report = dict(prefill_tokens_per_s=B * P / t_pre, prefill_s=t_pre,
                  decode_tokens_per_s=B * HYMBA_NEW / t_dec,
                  decode_ms_per_step=1e3 * t_dec / HYMBA_NEW,
                  peak_gib=peak)
    print(f"hymba prefill: {report['prefill_tokens_per_s']:.1f} tokens/s "
          f"({B * P} tokens in {t_pre:.3f} s)", flush=True)
    print(f"hymba decode: {report['decode_tokens_per_s']:.1f} tokens/s, "
          f"{report['decode_ms_per_step']:.3f} ms/step", flush=True)
    print(f"hymba: peak {peak:.2f} GiB allocated", flush=True)
    del caches, lg

    t0 = time.perf_counter()
    b_rep = dict(steps={}, argmax_checked=0, argmax_flips=0)
    hymba_check_b(torch, cfg, params, toks, first, caches0, gen, b_rep)
    del caches0
    print(f"hymba check (b), bf16, per lane in bf16 steps at its largest "
          f"|logit| (max, median over the {B} lanes); bounds: max "
          f"{HYMBA_B_MAX_ULPS}, decode median {HYMBA_B_MEDIAN_ULPS} "
          f"({time.perf_counter() - t0:.3f} s)", flush=True)
    for label, row in b_rep["steps"].items():
        print(f"hymba check (b) {label}: " + "; ".join(
            f"{name} {max(v):.2f}, {statistics.median(v):.2f}"
            for name, v in row.items()), flush=True)
    print(f"hymba check (b): argmax equal on "
          f"{b_rep['argmax_checked'] - b_rep['argmax_flips']} of "
          f"{b_rep['argmax_checked']} lanes with a margin above "
          f"{HYMBA_B_MAX_ULPS} steps", flush=True)
    check(all(within_b(label, row["sound"])
              for label, row in b_rep["steps"].items())
          and b_rep["argmax_flips"] == 0, "hymba check (b)")
    for name in HYMBA_FAULTS:
        caught = [within_b(label, row[name]) is False
                  for label, row in b_rep["steps"].items() if name in row]
        check(caught and all(caught), f"hymba check (b): the planted fault "
              f"'{name}' stays within the bounds at some step")
    report["check_b"] = b_rep

    t0 = time.perf_counter()
    n_tok, low, cache_err, fault_err = hymba_check_a(torch, cfg, params, toks)

    def fmt(errs):
        return json.dumps({k: float(f"{v:.3e}") for k, v in errs.items()})
    print(f"hymba check (a): f32, {n_tok} gpu tokens equal the torch-mode "
          f"teacher-forced argmax; {low} steps had a top-2 margin below "
          f"{HYMBA_A_MARGIN} and were not compared; caches after prefill, "
          f"max |gpu - plain| / max |plain|: {fmt(cache_err)} (bounds "
          f"{json.dumps(HYMBA_A_CACHE_TOL)}; the prefill one token short: "
          f"{fmt(fault_err)}) ({time.perf_counter() - t0:.3f} s)",
          flush=True)
    report["fp8"] = fp8_cache_decode(torch, "hymba", cfg, params, toks,
                                     ("k", "v"))
    del params
    torch.cuda.empty_cache()
    return launches, report


# ---------------------------------------------------------------------------
# phase 6: the sharded store engine (paper §VI) on the production mesh
# ---------------------------------------------------------------------------

def make_shard_stream(seed: int):
    """The sharded store's seeded stream of global plans of S * SHARD_LANES
    lanes, as (tag, ops int32, keys uint64, vals uint64), keys uniform over
    u64: SHARD_PRELOAD_STEPS plans of fresh inserts, then SHARD_WL_STEPS
    plans of Workload 1 (10% fresh inserts, 90% finds) and of Workload 2
    (10% inserts, 2% erases, 88% finds). Keys are distinct: splitmix64's
    finalizer, a bijection of u64, over a seeded run of counters. The
    finds and erases take disjoint slices of a permutation of the
    preloaded keys, so no key repeats within a plan."""
    rng = np.random.default_rng([seed, 6])
    n = int(np.prod(SHARD_SIZES)) * SHARD_LANES
    n_pre = SHARD_PRELOAD_STEPS * n
    n_ins, n_del = n // 10, n // 50
    n_fresh = 2 * SHARD_WL_STEPS * n_ins
    x = (np.arange(n_pre + n_fresh, dtype=np.uint64)
         + rng.integers(0, 2**64 - 1, dtype=np.uint64))
    with np.errstate(over="ignore"):
        for shift, mul in ((30, 0xBF58476D1CE4E5B9), (27, 0x94D049BB133111EB),
                           (31, None)):
            x ^= x >> np.uint64(shift)
            if mul is not None:
                x *= np.uint64(mul)
    keys = np.where(x == np.uint64(2**64 - 1), np.uint64(1), x)  # KEY_INF
    pre, fresh = keys[:n_pre], keys[n_pre:]
    plans = [("preload", np.full(n, OP_INSERT, np.int32),
              pre[i * n:(i + 1) * n],
              rng.integers(0, 2**64 - 1, n, dtype=np.uint64))
             for i in range(SHARD_PRELOAD_STEPS)]
    old = pre[rng.permutation(n_pre)]
    at = f = 0
    for wl, nd in (("wl1", 0), ("wl2", n_del)):
        for _ in range(SHARD_WL_STEPS):
            nf = n - n_ins - nd
            ops = np.concatenate([np.full(n_ins, OP_INSERT, np.int32),
                                  np.full(nd, OP_DELETE, np.int32),
                                  np.full(nf, OP_FIND, np.int32)])
            k = np.concatenate([fresh[f:f + n_ins], old[at:at + nd + nf]])
            f, at = f + n_ins, at + nd + nf
            perm = rng.permutation(n)
            plans.append((wl, ops[perm], k[perm],
                          rng.integers(0, 2**64 - 1, n, dtype=np.uint64)))
    return plans


@contextlib.contextmanager
def counted_syncs(torch, sink: list):
    """Count the host-device syncs of a block: torch's sync debug mode
    warns at each synchronizing call, and the warnings are counted."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sink.append(sum("synchroniz" in str(w.message) for w in caught))


def shard_engine(torch, backend, mode):
    from repro_torch.core.routing import ShardMesh
    from repro_torch.store.engine import StoreEngine
    return StoreEngine(ShardMesh(SHARD_AXES, SHARD_SIZES), SHARD_AXES,
                       SHARD_LANES, backend, SHARD_POOL_FACTOR,
                       exec_mode=mode, device=DEV)


def shard_cell(torch, label, cap, need, plans, dev_plans, oracle):
    """One backend through the sharded engine: the preload steps in exec
    mode gpu, then the workload steps in modes gpu and torch, the torch
    engine starting from a copy of the gpu state after the preload. Every
    step dropped == 0; on the workload steps gpu == torch; every lane of
    every step == the dict oracle (`oracle()`: (per step (ok, vals), the
    sorted live keys), read once the steps are done); the final states
    equal between the modes, the summed sizes the oracle's live count;
    the kernels `need` launched; shards SHARD_RESIDENCY rebuilt from the
    init snapshot over the whole journal (`resilience.rebuild_shard`)
    equal the engine's. Returns (gpu engine, gpu final state, the gpu
    state after the preload, launches, the gpu results (vals, ok) of the
    workload steps)."""
    from repro_torch.kernels import cuda
    from repro_torch.store import resilience as R
    from repro_torch.store.resilience.journal import copy_to
    t_be = time.perf_counter()
    engines = {m: shard_engine(torch, label, m) for m in BOTH}
    init = R.take_snapshot(engines["gpu"].init(cap), 0)
    states = {"gpu": R.snapshot_state(init, DEV)}
    journal = R.Journal(0)
    secs = collections.defaultdict(list)
    launches_step, syncs, host, wl_outs = [], [], [], []
    after_preload = None

    def launched():                     # per kernel, not again by layout
        return sum(v for k, v in cuda.LAUNCHES.items() if "/" not in k)
    torch.cuda.synchronize()
    cuda.reset_launches()
    for p, (tag, ops, keys, vals) in enumerate(dev_plans):
        journal.append(p, *plans[p][1:])
        if p == SHARD_PRELOAD_STEPS:
            after_preload = copy_to(states["gpu"], DEV)
            states["torch"] = copy_to(states["gpu"], DEV)
        res = {}
        for m in states:
            sync_here = m == "gpu" and p == SHARD_PRELOAD_STEPS
            before = launched()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with (counted_syncs(torch, syncs) if sync_here
                  else contextlib.nullcontext()):
                states[m], rv, rok, dr = engines[m].step(states[m], ops,
                                                         keys, vals)
            torch.cuda.synchronize()
            if not sync_here:
                secs[(m, tag == "preload")].append(time.perf_counter() - t0)
            if m == "gpu":
                launches_step.append(launched() - before)
            check(int(dr) == 0, f"sharded {label} step {p}: {int(dr)} lanes "
                  f"dropped")
            res[m] = (rok, rv)
        if "torch" in res:
            check(torch.equal(res["gpu"][0], res["torch"][0])
                  and torch.equal(res["gpu"][1], res["torch"][1]),
                  f"sharded {label} step {p}: gpu != torch")
            wl_outs.append((res["gpu"][1], res["gpu"][0]))
        host.append((res["gpu"][0].cpu().numpy(),
                     res["gpu"][1].cpu().numpy().view(np.uint64)))
    torch.cuda.synchronize()
    launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    for name in need:
        check(launches.get(name, 0) > 0, f"kernel {name} never launched in "
              f"the sharded {label} cell")
    shapes = harvest_shapes(cuda)
    check(leaves_equal(torch, states["gpu"], states["torch"]),
          f"sharded {label}: final state gpu != torch")
    del states["torch"]
    want, live = oracle()
    for p, (ok, rv) in enumerate(host):
        check(np.array_equal(ok, want[p][0]) and np.array_equal(rv, want[p][1]),
              f"sharded {label} step {p}: results differ from the dict "
              f"oracle")
    del host
    eng = engines["gpu"]
    stats = eng.stats(states["gpu"])
    check(int(stats["size"].sum()) == live.size, f"sharded {label}: summed "
          f"size {int(stats['size'].sum())} != oracle {live.size}")
    t0 = time.perf_counter()
    pool = SHARD_LANES * SHARD_POOL_FACTOR
    for shard in SHARD_RESIDENCY:
        st, n = R.rebuild_shard(eng.backend, init, journal.entries, shard,
                                eng.n_shards, pool, "gpu", device=DEV)
        check(n > 0 and leaves_equal(torch, st, states["gpu"][shard]),
              f"sharded {label}: shard {shard} rebuilt from the journal "
              f"differs from the engine's")
    rebuild_s = time.perf_counter() - t0
    n_shards = eng.n_shards

    def ms(mode, pre):
        xs = secs[(mode, pre)]
        return 1e3 * sum(xs) / len(xs) if xs else None
    row = {"shards": n_shards, "capacity_per_shard": cap,
           "lanes_per_step": n_shards * SHARD_LANES,
           "spill_size": int(stats["spill_size"].sum()),
           "evictions": int(stats["evictions"].sum()),
           "ms_per_step": {m: {"preload": ms(m, True), "workload": ms(m, False)}
                           for m in BOTH},
           "launches_per_step": {"preload": launches_step[0],
                                 "workload": launches_step[-1]},
           "syncs_first_workload_step_gpu": syncs[0],
           "launches": launches, "calls_by_shape": calls_by_shape(shapes),
           "residency_rebuild_s": rebuild_s}
    print(f"sharded {label}: " + json.dumps(row), flush=True)
    print(f"sharded {label}: {time.perf_counter() - t_be:.3f} s", flush=True)
    return eng, states["gpu"], after_preload, launches, wl_outs


def shard_oracle(plans):
    """The dict oracle of the sharded stream: (per step (ok, vals), the
    sorted live keys). `sharded_phase` runs it in a worker process while
    the card works."""
    out, live = dict_oracle(plans)
    return out, np.sort(np.fromiter(live.keys(), np.uint64, len(live)))


def route_times(torch, dev_plans):
    """Device ms of the route and of the route back of one workload step
    on the production mesh, timed apart (CUDA events)."""
    from repro_torch.core.routing import route_back, route_to_owners
    S = int(np.prod(SHARD_SIZES))
    _, ops, keys, vals = dev_plans[SHARD_PRELOAD_STEPS]
    ops, keys, vals = (x.reshape(S, SHARD_LANES) for x in (ops, keys, vals))
    pool = SHARD_LANES * SHARD_POOL_FACTOR

    def route():
        return route_to_owners(keys, vals, ops, ops >= 0, SHARD_AXES,
                               SHARD_SIZES, pool)
    rr = route()
    live = rr.valid & (rr.aux >= 0)
    found = live & (rr.aux == OP_FIND)
    back = route_back(rr.vals, found, rr.origin, live, SHARD_AXES,
                      SHARD_SIZES, SHARD_LANES)
    check(torch.equal(back[0], torch.where(ops >= 0, vals, 0))
          and torch.equal(back[1], ops == OP_FIND),
          "sharded: the route back does not return each lane's own value")
    return (median_ms(torch, route, 5),
            median_ms(torch, lambda: route_back(
                rr.vals, found, rr.origin, live, SHARD_AXES, SHARD_SIZES,
                SHARD_LANES), 5))


def range_check(torch, eng, state, keys, rng):
    """The range step over det_skiplist: SHARD_RANGES valid lanes a shard,
    each lane's count == `np.searchsorted` over the oracle's sorted live
    `keys`; prints the step's ms (host clock, synchronized)."""
    from repro_torch.core.bits import from_u64
    n = eng.n_shards * SHARD_LANES
    lo = rng.integers(0, 2**64 - 1, n, dtype=np.uint64)
    hi = lo + rng.integers(1, 2**58, n, dtype=np.uint64)
    hi = np.where(hi < lo, np.uint64(2**64 - 1), hi)
    valid = np.zeros((eng.n_shards, SHARD_LANES), bool)
    for s in range(eng.n_shards):
        valid[s, rng.choice(SHARD_LANES, SHARD_RANGES, replace=False)] = True
    valid = valid.reshape(-1)
    want = np.where(valid, np.searchsorted(keys, hi)
                    - np.searchsorted(keys, lo), 0)
    rstep = eng.range_step(SHARD_RANGE_MAX_OUT)
    args = (from_u64(lo, DEV), from_u64(hi, DEV),
            torch.from_numpy(valid).to(DEV))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cnt = rstep(state, *args)
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    check(np.array_equal(cnt.cpu().numpy(), want), "sharded: range counts "
          "differ from np.searchsorted over the live keys")
    print(f"sharded range step: {int(valid.sum())} valid ranges, counts "
          f"{int(want[valid].min())}..{int(want[valid].max())} keys, "
          f"{1e3 * t:.3f} ms", flush=True)


def resilience_check(torch, eng0, base, final, wl_plans, ref, seed):
    """`ResilientEngine` over obs:tiered3/lru (the default of the
    reference's RECOVER check) on the workload steps from the
    post-preload state `base`, snapshot every SHARD_SNAPSHOT_EVERY steps,
    held to the fault-free run: the tier cell's own gpu run (`ref`, its
    results a step; `final`, its end state through the engine `eng0`).
    sync mode, with two shard drops, a poison and a stall: every step's
    results, the final `state_digest` and the per-shard metrics == the
    fault-free run's. degraded mode, one shard drop, one journal entry
    replayed a step: the healthy lanes == the fault-free run's at every
    step, and `completions` == the fault-free answers. Prints the
    snapshot's ms and bytes and the recoveries' ms."""
    from repro_torch.store import resilience as R
    from repro_torch.store.resilience.journal import copy_to
    backend = "obs:tiered3/lru"
    S = int(np.prod(SHARD_SIZES))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = R.take_snapshot(base, 0)
    snap_s = time.perf_counter() - t0
    snap_bytes = sum(a.nbytes for a in snap.leaves)
    del snap
    ref_digest, ref_metrics = R.state_digest(final), eng0.metrics(final)
    rng = np.random.default_rng([seed, 13])
    plan = R.FaultPlan(seed, [
        R.Fault("poison", 1, lane=int(rng.integers(0, S * SHARD_LANES))),
        R.Fault("stall", 1, ticks=3)] + [
        R.Fault("shard_drop", st, shard=sh) for st, sh in SHARD_SYNC_DROPS])
    step, dead = SHARD_DEGRADED_DROP
    bits = S.bit_length() - 1
    report = {}
    for mode, fp in (("sync", plan), ("degraded", R.FaultPlan(
            seed, [R.Fault("shard_drop", step, shard=dead)]))):
        eng = shard_engine(torch, backend, "gpu")
        reng = R.ResilientEngine(eng, snapshot_every=SHARD_SNAPSHOT_EVERY,
                                 fault_plan=fp, mode=mode, replay_per_tick=1)
        rec_s = []
        recover = reng._recover_sync

        def timed(st, shard, recover=recover, rec_s=rec_s):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = recover(st, shard)
            torch.cuda.synchronize()
            rec_s.append(time.perf_counter() - t1)
            return out
        reng._recover_sync = timed
        state = copy_to(base, DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        deferred = 0
        for i, (_, ops, keys, vals) in enumerate(wl_plans):
            state, rv, rok, _ = reng.step(state, ops, keys, vals)
            if mode == "sync":
                check(torch.equal(rv, ref[i][0]) and torch.equal(
                    rok, ref[i][1]), f"resilient sync step {i}: results "
                      f"differ from the fault-free run")
                continue
            held = (reng.quarantine is not None
                    or any(s == i for s, _ in reng.completions))
            mine = torch.zeros_like(rok)
            if held:                        # the top log2(S) key bits
                owner = (keys >> (64 - bits)) & (S - 1)
                mine = (owner == dead) & (ops >= 0)
            deferred += int(mine.sum())
            check(torch.equal(rv[~mine], ref[i][0][~mine])
                  and torch.equal(rok[~mine], ref[i][1][~mine])
                  and not bool(rok[mine].any()), f"resilient degraded "
                  f"step {i}: healthy lanes differ from the fault-free run")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if mode == "sync":
            check(R.state_digest(state) == ref_digest, "resilient sync: the "
                  "final state digest differs from the fault-free run's")
            got = eng.metrics(state)
            check(all(np.array_equal(got[k], ref_metrics[k])
                      for k in ref_metrics), "resilient sync: per-shard "
                  "metrics differ from the fault-free run's")
        else:
            check(reng.quarantine is None and len(reng.completions)
                  == deferred > 0, "resilient degraded: deferred lanes not "
                  "all completed")
            for (seq, lane), (ok, val) in reng.completions.items():
                check(ok == bool(ref[seq][1][lane])
                      and val == int(ref[seq][0][lane]), f"resilient "
                      f"degraded: completion ({seq}, {lane}) differs from "
                      f"the fault-free answer")
        check(reng.tally["recoveries"] == sum(
            f.kind == "shard_drop" for f in fp.faults), f"resilient {mode}: "
              f"recoveries {reng.tally['recoveries']}")
        report[mode] = dict(tally=dict(reng.tally), steps_s=wall,
                            recover_ms=[1e3 * x for x in rec_s],
                            completions=len(reng.completions))
        del state, reng
    print(f"sharded resilience over {backend}: snapshot of {S} shards "
          f"{1e3 * snap_s:.3f} ms, {snap_bytes} bytes; "
          + json.dumps(report), flush=True)


def sharded_phase(torch, seed: int):
    """The sharded store (paper §VI) on the production mesh folded onto
    the card: det_skiplist and obs:tiered3/lru through `shard_cell`, the
    route and route-back times, the range step over det_skiplist, and the
    resilience checks against the tier cell's workload steps. The dict
    oracle runs in a spawned worker process, so a script that calls this
    must guard its top level with `if __name__ == "__main__":`. Launch counts are set to 0 just before each cell and read just
    after. Returns the launches summed over the cells."""
    import multiprocessing
    t0 = time.perf_counter()
    plans = make_shard_stream(seed)
    t1 = time.perf_counter()
    dev_plans = to_device(torch, plans)
    print(f"sharded: mesh {dict(zip(SHARD_AXES, SHARD_SIZES))}, "
          f"{len(plans)} steps of {plans[0][1].size} lanes; stream "
          f"{t1 - t0:.3f} s, on the card {time.perf_counter() - t1:.3f} s",
          flush=True)
    route_ms, back_ms = route_times(torch, dev_plans)
    print(f"sharded route: {route_ms:.6f} ms a step, route back "
          f"{back_ms:.6f} ms a step", flush=True)
    totals = collections.Counter()
    tier = None
    with multiprocessing.get_context("spawn").Pool(1) as workers:
        job = workers.apply_async(shard_oracle, (plans,))
        oracle = functools.lru_cache(maxsize=1)(job.get)
        for label, cap, need in SHARD_CELLS:
            eng, state, after_preload, launches, wl_outs = shard_cell(
                torch, label, cap, need, plans, dev_plans, oracle)
            totals.update(launches)
            if label == "det_skiplist":
                range_check(torch, eng, state, oracle()[1],
                            np.random.default_rng([seed, 14]))
            else:
                tier = (eng, after_preload, state, wl_outs)
            del eng, state, after_preload, wl_outs
            torch.cuda.empty_cache()
        print(f"sharded: {oracle()[1].size} live keys at the end (the dict "
              f"oracle, in a worker process)", flush=True)
        del oracle, job
        workers.close()
        workers.join()
    from repro_torch.kernels import cuda
    cuda.reset_launches()
    eng, after_preload, state, wl_outs = tier
    del tier
    resilience_check(torch, eng, after_preload, state,
                     dev_plans[SHARD_PRELOAD_STEPS:], wl_outs, seed)
    more = {k: v for k, v in cuda.LAUNCHES.items() if v}
    for name in ("tier_find/level", "tier_apply/level"):
        check(more.get(name, 0) > 0, f"kernel {name} never launched in the "
              f"resilient runs")
    harvest_shapes(cuda)
    totals.update(more)
    del eng, state, after_preload, wl_outs, dev_plans
    torch.cuda.empty_cache()
    print("sharded launches: " + json.dumps(dict(totals)), flush=True)
    return dict(totals), None


# ---------------------------------------------------------------------------
# phase 7: training
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen3-1.7b"
TRAIN_BATCH = 8             # SHAPES["train_4k"]'s global batch of 256, cut
TRAIN_MICRO = 4             # two 4,096-token sequences a microbatch
TRAIN_STEPS = 4
TRAIN_LOSS0_MARGIN = 0.5    # step 0's loss within this of ln(vocab)
TRAIN_RESTART_LAYERS = 2
TRAIN_RESTART_AT = 2        # the synchronous checkpoint's step
TRAIN_PARITY_SEQ = 512      # the card-vs-CPU step: one sequence
TRAIN_PARITY_LOSS_RTOL = 1e-5
TRAIN_PARITY_GNORM_RTOL = 1e-4
TRAIN_NONDET_RTOL = 1e-6    # resumed losses, if an op had no deterministic form


def timed_calls(module, name: str, sink: list):
    """Wrap `module.name` so each call appends its seconds to `sink`;
    returns the undo."""
    orig = getattr(module, name)

    def wrapped(*a, **kw):
        t0 = time.perf_counter()
        try:
            return orig(*a, **kw)
        finally:
            sink.append(time.perf_counter() - t0)
    setattr(module, name, wrapped)
    return lambda: setattr(module, name, orig)


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def train_main_run(torch, cfg, shape, seed: int):
    """qwen3-1.7b at full width and depth through `train()` on the card:
    the checks of the main run, and its readings."""
    from repro_torch.kernels import cuda
    from repro_torch.models import model as M
    from repro_torch.train.loop import train
    params = M.init_params(cfg, torch.Generator(DEV).manual_seed(seed))
    n_params = sum(p.numel() for p in params.parameters())
    watch = {n: p.detach()[:4].clone() for n, p in params.named_parameters()
             if n in ("embed", "final_norm", "blocks.0.attn.wq",
                      f"blocks.{cfg.n_layers - 1}.ffn.wd")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launches()
    t0 = time.perf_counter()
    params, opt, out = train(cfg, shape, steps=TRAIN_STEPS, seed=seed,
                             microbatches=TRAIN_MICRO, log_every=1,
                             device=DEV, params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    hist = out["history"]
    pipe = out["pipeline"]
    check(not launches, f"the train path launched kernels: {launches}")
    check([h["step"] for h in hist] == list(range(TRAIN_STEPS)),
          f"steps delivered {[h['step'] for h in hist]}")
    check(out["straggler_skips"] == 0,
          f"straggler skips {out['straggler_skips']}")
    check(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
              for h in hist), f"non-finite loss or grad norm: {hist}")
    ln_v = math.log(cfg.vocab_size)
    check(abs(hist[0]["loss"] - ln_v) <= TRAIN_LOSS0_MARGIN,
          f"step 0 loss {hist[0]['loss']} vs ln(vocab) {ln_v}")
    moved = {n: bool((p.detach()[:4] != watch[n]).any())
             for n, p in params.named_parameters() if n in watch}
    check(all(moved.values()), f"parameters did not move: {moved}")
    check(int(opt["adam"]["step"]) == TRAIN_STEPS,
          f"adam step {int(opt['adam']['step'])}")
    check(int(pipe.queue.pushed) == int(pipe.queue.popped),
          f"ring queue pushed {int(pipe.queue.pushed)} popped "
          f"{int(pipe.queue.popped)}")
    check(int(pipe.pool.num_free()) == pipe.depth,
          f"block pool: {int(pipe.pool.num_free())} of {pipe.depth} free")
    tokens = shape.global_batch * shape.seq_len
    step_s = statistics.fmean(h["time"] for h in hist[1:])
    get_ms = statistics.fmean(h["get_time"] for h in hist[1:]) * 1e3
    state_gb = n_params * 16 / 1e9
    logits_gb = (tokens // TRAIN_MICRO) * cfg.padded_vocab * 4 / 1e9
    print(f"train: {cfg.name} {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params} parameters ({cfg.param_dtype}, {cfg.compute_dtype} "
          f"compute, remat {cfg.remat}, attn_impl {cfg.attn_impl}); "
          f"{shape.name} cut to global batch {shape.global_batch} x "
          f"{shape.seq_len} tokens, {TRAIN_MICRO} microbatches; "
          f"{TRAIN_STEPS} steps in {wall:.3f} s", flush=True)
    print(f"train: losses {[h['loss'] for h in hist]}, grad norms "
          f"{[h['grad_norm'] for h in hist]}; ln(vocab) {ln_v:.6f}",
          flush=True)
    print(f"train: {step_s * 1e3:.3f} ms a step (steps 1-{TRAIN_STEPS - 1}), "
          f"{tokens / step_s:.1f} tokens/s, step 0 {hist[0]['time']:.3f} s; "
          f"pipe.get {get_ms:.3f} ms a step (steps 1 on; "
          f"{[round(h['get_time'] * 1e3, 3) for h in hist]} ms by step); "
          f"peak {peak:.3f} GiB "
          f"(reckoning: params + grads + m + v {state_gb:.1f} GB, one "
          f"microbatch's f32 logits {logits_gb:.2f} GB); ring queue "
          f"pushed {int(pipe.queue.pushed)} == popped, "
          f"{int(pipe.pool.num_free())}/{pipe.depth} blocks free",
          flush=True)
    return {"ms_per_step": step_s * 1e3, "tokens_per_s": tokens / step_s,
            "peak_gib": peak, "get_ms": get_ms}


def train_restart_check(torch, cfg, shape, seed: int):
    """Full width, depth cut: an uninterrupted run of TRAIN_STEPS against
    TRAIN_RESTART_AT steps with a synchronous checkpoint, then a resumed
    run to TRAIN_STEPS. Deterministic algorithms inside this check only;
    an op without a deterministic form is recorded, and the losses are
    then held within TRAIN_NONDET_RTOL."""
    import os
    import shutil
    import tempfile
    import warnings
    from repro_torch.train import loop
    cfg = cfg.replace(n_layers=TRAIN_RESTART_LAYERS)
    kw = dict(seed=seed, microbatches=TRAIN_MICRO, log_every=0, device=DEV)
    saves, restores = [], []
    undo = [timed_calls(loop, "save", saves),
            timed_calls(loop, "restore", restores)]
    was_det = torch.are_deterministic_algorithms_enabled()
    was_cfg = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _, _, ref = loop.train(cfg, shape, steps=TRAIN_STEPS, **kw)
            loop.train(cfg, shape, steps=TRAIN_RESTART_AT, ckpt_dir=tmp,
                       ckpt_every=TRAIN_RESTART_AT, async_save=False, **kw)
            ckpt_bytes = dir_bytes(tmp)
            _, _, cont = loop.train(cfg, shape, steps=TRAIN_STEPS,
                                    ckpt_dir=tmp, ckpt_every=100, **kw)
            torch.cuda.synchronize()
        nondet = sorted({str(w.message).split("\n")[0] for w in caught
                         if "deterministic" in str(w.message)})
    finally:
        torch.use_deterministic_algorithms(was_det)
        if was_cfg is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = was_cfg
        for u in undo:
            u()
        shutil.rmtree(tmp, ignore_errors=True)
    check(len(saves) == 1 and len(restores) == 1,
          f"{len(saves)} saves, {len(restores)} restores")
    check([h["step"] for h in cont["history"]]
          == list(range(TRAIN_RESTART_AT, TRAIN_STEPS)),
          f"resumed steps {[h['step'] for h in cont['history']]}")
    want = [h["loss"] for h in ref["history"][TRAIN_RESTART_AT:]]
    got = [h["loss"] for h in cont["history"]]
    if nondet:
        check(all(abs(g - w) <= TRAIN_NONDET_RTOL * abs(w)
                  for g, w in zip(got, want)),
              f"resumed losses {got} vs {want} (rtol {TRAIN_NONDET_RTOL}; "
              f"ops without a deterministic form: {nondet})")
    else:
        check(got == want, f"resumed losses {got} != uninterrupted {want}")
    mb = ckpt_bytes / 1e6
    print(f"train restart: {cfg.n_layers} layers, uninterrupted losses "
          f"{[h['loss'] for h in ref['history']]}, resumed at step "
          f"{TRAIN_RESTART_AT}: {got} "
          f"({'bit-equal' if got == want else 'within the tolerance'}); "
          f"ops without a deterministic form: {nondet or 'none'}",
          flush=True)
    print(f"train checkpoint: {mb:.1f} MB (params + m + v + step); save "
          f"{saves[0]:.3f} s ({mb / saves[0]:.1f} MB/s), restore "
          f"{restores[0]:.3f} s ({mb / restores[0]:.1f} MB/s); disk writes "
          f"and reads through the page cache (warm)", flush=True)
    return {"save_s": saves[0], "restore_s": restores[0], "ckpt_mb": mb}


def train_parity_check(torch, cfg, seed: int):
    """One train step at full width, TRAIN_RESTART_LAYERS layers, one
    TRAIN_PARITY_SEQ-token sequence, f32 compute, on the card and on the
    CPU from the same parameters: loss and grad norm."""
    import copy
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.step import make_train_step
    cfg = cfg.replace(n_layers=TRAIN_RESTART_LAYERS, compute_dtype="float32")
    shape = ShapeConfig("parity", TRAIN_PARITY_SEQ, 1, "train")
    cpu_p = M.init_params(cfg, torch.Generator("cpu").manual_seed(seed))
    out = {}
    for dev, p in ((DEV, copy.deepcopy(cpu_p).to(DEV)), ("cpu", cpu_p)):
        p.make_trainable()
        t0 = time.perf_counter()
        step = make_train_step(cfg)
        _, _, m = step(p, {"adam": adamw_init(p)},
                       synth_batch(cfg, shape, seed, 0, device=dev))
        out[dev] = (float(m["loss"]), float(m["grad_norm"]),
                    time.perf_counter() - t0)
        del p
    (gl, gg, gt), (cl, cg, ct) = out[DEV], out["cpu"]
    lerr, gerr = abs(gl - cl) / abs(cl), abs(gg - cg) / abs(cg)
    print(f"train card vs cpu: {cfg.n_layers} layers, 1 x "
          f"{TRAIN_PARITY_SEQ} tokens, f32 compute, TF32 "
          f"{torch.backends.cuda.matmul.allow_tf32}: loss {gl} vs {cl} "
          f"(rel {lerr:.3e}), grad norm {gg} vs {cg} (rel {gerr:.3e}); "
          f"step {gt:.3f} s on the card, {ct:.3f} s on the CPU", flush=True)
    check(lerr <= TRAIN_PARITY_LOSS_RTOL, f"card vs cpu loss rel {lerr}")
    check(gerr <= TRAIN_PARITY_GNORM_RTOL,
          f"card vs cpu grad norm rel {gerr}")


def train_phase(torch, seed: int):
    """Training: qwen3-1.7b at full width and depth through `train()` (the
    prefetch pipeline on the card, AdamW), then the restart check and the
    card-vs-CPU step. The train path launches no kernel of the port (the
    reference trains through its plain attention): the launch counts are
    set to 0 before the main run and must stay 0. Returns ({}, report)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    cfg = get_config(TRAIN_ARCH)
    check((cfg.param_dtype, cfg.compute_dtype, cfg.remat, cfg.attn_impl)
          == ("float32", "bfloat16", True, "xla"),
          f"not the reference's train configuration: {cfg}")
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=TRAIN_BATCH)
    report = train_main_run(torch, cfg, shape, seed)
    gc.collect()
    torch.cuda.empty_cache()
    report.update(train_restart_check(torch, cfg, shape, seed))
    gc.collect()
    torch.cuda.empty_cache()
    train_parity_check(torch, get_config(TRAIN_ARCH), seed)
    return {}, report


# ---------------------------------------------------------------------------
# phase 8: the MoE family served at full width
# ---------------------------------------------------------------------------

# Each MoE arch at full width (d_model, heads, experts, d_expert and vocab
# as published) and 3 layers (of 48 and 94): seeded f32 parameters and
# their bf16 copy, 6 B a parameter, ~52 GB each (~8.7 B parameters); 4
# layers (~65-67 GB) leave too little of the 80 GB for pages and dispatch
# buffers. Served by `Engine` (16 slots, 1,024 pages of 16 tokens) on
# phase 4's trace cut to 16 requests, with the config's own `moe_impl`
# (no mesh is open, so the dense dispatch)
MOE_ARCHS = ("llama4-scout-17b-a16e", "qwen3-moe-235b-a22b")
MOE_LAYERS = 3
MOE_BATCH = 16
MOE_NUM_PAGES = 1024
MOE_TRACE = dict(SERVE_TRACE, n_requests=16)
MOE_B_STEPS = 4
MOE_A_PROMPTS = 2
MOE_A_NEW = 8
MOE_A_PAGES = 160
# check (b): a lane whose experts differ between the gpu and the plain
# attention is left out of the bound only where the plain router's logit
# margin at the top-k edge is below this (the two attentions' orders of
# sums move the bf16 router input by a step or so)
MOE_ROUTE_MARGIN = 0.05
# the paper's routing at full width: layer 0's FFN input of the first
# prefill folded onto a (1, 16) ("data", "model") mesh; the expert-
# parallel dispatches within 2 bf16 steps of max |y| of the dense one
MOE_MESH = (("data", "model"), (1, 16))
MOE_EP_STEPS = 2


def bf16_bound(torch, y, steps):
    """`steps` bf16 steps at the largest |y|."""
    big = float(y.float().abs().max())
    return steps * 2.0 ** (math.floor(math.log2(big)) - 7)


def ffn_input(torch, cfg, params, prompt):
    """Layer 0's FFN input [T, D] (in the compute dtype) of the prefill
    of `prompt`, T cut to a multiple of the mesh's shards."""
    from repro_torch.models import blocks
    from repro_torch.models import model as M
    seen = []
    ffn_apply = blocks._ffn_apply

    def capture(p, c, x):
        if not seen:
            seen.append(x.reshape(-1, x.shape[-1]).clone())
        return ffn_apply(p, c, x)
    blocks._ffn_apply = capture
    try:
        toks = torch.from_numpy(prompt.astype(np.int64)).to(DEV)[None]
        M.prefill(params, cfg, toks, cache_len=len(prompt))
    finally:
        blocks._ffn_apply = ffn_apply
    n = math.prod(MOE_MESH[1])
    return seen[0][:seen[0].shape[0] // n * n]


def moe_dispatches(torch, cfg, ffn, x):
    """(y with the shared expert, dropped lanes per token [T]) of the
    dense, replicated_psum and routed_a2a dispatches on x [T, D], the
    latter two simulated on the MOE_MESH shards."""
    from repro_torch.models import moe
    from repro_torch.models.mlp import mlp
    t, d = x.shape
    dp, tp = MOE_MESH[1]
    shared = (mlp(ffn.shared, x, cfg.compute_dtype) if cfg.n_shared_experts
              else 0)
    y, _, drops = moe.moe_dense_ffn(ffn, cfg, x, return_dropped=True)
    out = {"dense": (y, drops)}
    y, _, drops = moe.moe_replicated_psum(
        ffn, cfg, x.reshape(dp, 1, t // dp, d).expand(dp, tp, t // dp, d),
        return_dropped=True)
    out["replicated_psum"] = (y[:, 0].reshape(t, d) + shared,
                              drops.reshape(t))
    y, _, drops = moe.moe_routed_a2a(ffn, cfg,
                                     x.reshape(dp, tp, t // (dp * tp), d),
                                     return_dropped=True)
    out["routed_a2a"] = ((y.reshape(t, d) + shared).to(x.dtype),
                         drops.reshape(t))
    return out


def moe_ep_check(torch, label, cfg, params, prompt):
    """The paper's routing at full width on layer 0's FFN input of the
    first prefill (`ffn_input`). Each dispatch's dropped lanes are
    counted. replicated_psum buckets each expert's lanes in the dense
    dispatch's order at its capacity, so it must drop the same lanes and
    give the dense output on every token; routed_a2a buckets by owner and
    then by expert at its own capacities, so it is held to the dense
    output on the tokens neither dispatch dropped a lane of. The bound is
    MOE_EP_STEPS bf16 steps of the largest |y|. The planted fault routes
    the most chosen expert's bucket to the next shard, whose own expert
    then computes it: both dispatches must exceed the bound. The three
    dispatches' whole FFN (the shared expert included) is timed, ms a
    layer. Returns the report."""
    from repro_torch.core.routing import ShardMesh
    from repro_torch.models import blocks, moe
    from repro_torch.parallel.sharding import use_mesh
    x = ffn_input(torch, cfg, params, prompt)
    ffn = params.blocks[0].ffn
    out = moe_dispatches(torch, cfg, ffn, x)
    dense, dense_drop = out["dense"]
    bound = bf16_bound(torch, dense, MOE_EP_STEPS)
    report = {"tokens": x.shape[0], "bound": bound,
              "drops": {k: int(v[1].sum()) for k, v in out.items()}}
    psum, psum_drop = out["replicated_psum"]
    check(torch.equal(psum_drop, dense_drop), f"{label}: replicated_psum "
          f"dropped other lanes than the dense dispatch")
    a2a, a2a_drop = out["routed_a2a"]
    kept = (dense_drop == 0) & (a2a_drop == 0)
    check(bool(kept.any()), f"{label}: every token lost a lane")
    diff = {"replicated_psum": float((psum - dense).float().abs().max()),
            "routed_a2a": float((a2a - dense)[kept].float().abs().max())}
    report.update(diff=diff, kept=int(kept.sum()))
    for name, v in diff.items():
        check(v <= bound, f"{label}: {name} differs from the dense dispatch "
              f"by {v} > {bound}")
    # the planted fault
    _, idx, _ = moe.router_probs(ffn, cfg, x)
    hot = int(torch.bincount(idx.reshape(-1).long()).argmax())
    owner = moe._owner_of
    tp = MOE_MESH[1][1]

    def misrouted(dest, el):
        o = owner(dest, el)
        return torch.where(dest == hot, (o + 1) % tp, o)
    moe._owner_of = misrouted
    try:
        bad = moe_dispatches(torch, cfg, ffn, x)
    finally:
        moe._owner_of = owner
    report["fault"] = {
        "replicated_psum": float((bad["replicated_psum"][0] - dense)
                                 .float().abs().max()),
        "routed_a2a": float((bad["routed_a2a"][0] - dense)[kept]
                            .float().abs().max())}
    for name, v in report["fault"].items():
        check(v > bound, f"{label}: the planted fault (expert {hot}'s bucket "
              f"on the wrong shard) stays within the bound in {name}")
    # ms a layer of each dispatch's whole FFN, and of the dense one at
    # the decode batch (the paged decode's FFN: B tokens of one step)
    mesh = ShardMesh(*MOE_MESH)
    x3 = x[None]
    dense_cfg = cfg.replace(moe_impl="dense")
    report["ms"] = {"dense": median_ms(torch, lambda: blocks._ffn_apply(
        ffn, dense_cfg, x3), 5)}
    report["decode_ms"] = median_ms(torch, lambda: blocks._ffn_apply(
        ffn, dense_cfg, x[:MOE_BATCH, None]), 5)
    with use_mesh(mesh):
        for impl in ("replicated_psum", "routed_a2a"):
            c = cfg.replace(moe_impl=impl)
            report["ms"][impl] = median_ms(
                torch, lambda: blocks._ffn_apply(ffn, c, x3), 5)
    return report


def paged_kernel_row(torch, arch, seed, launches):
    """paged_attention at the arch's served decode shape (16 requests,
    its heads, D 128, pages of 16, a 1,024-page pool) in bf16, within the
    bf16 elementwise limit of the plain version, timed beside SDPA and the
    bound (`paged_attention_timing`). Returns the kernel line's row."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    cfg = get_config(arch)
    rng = np.random.default_rng(seed + 8)
    q, kp, vp, tables, lengths = paged_attention_inputs(
        torch, rng, torch.bfloat16, arch, MOE_BATCH, MOE_NUM_PAGES)
    out = paged_attention(q, kp, vp, tables, lengths).float()
    torch.cuda.synchronize()
    ref = paged_attention_ref(q, kp, vp, tables, lengths)
    err = (out - ref).abs()
    worst = float((err / paged_limit(ref)).max())
    check(worst <= 1.0, f"paged_attention at {arch}'s decode shape: "
          f"{worst:.3f} of the bf16 limit")
    r = paged_attention_timing(torch, q, kp, vp, tables, lengths, ref,
                               float(err.max()))
    g = cfg.n_heads // cfg.n_kv_heads
    shape = (f"{arch} decode: B {MOE_BATCH}, H {cfg.n_heads}, Hkv "
             f"{cfg.n_kv_heads}, G {g}, D {cfg.resolved_head_dim}, page "
             f"{SERVE_PAGE}, {MOE_NUM_PAGES} pages")
    print(f"kernel paged_attention at {shape}: {r['ms']:.4f} ms (plain "
          f"{r['plain_ms']:.4f}, SDPA {r['library_ms']:.4f}, dispatch "
          f"{r['dispatch_ms']:.4f}, bound {r['bound'][0]:.4f} by "
          f"{r['bound'][1]}); at most {worst:.3f} of the bf16 limit",
          flush=True)
    del q, kp, vp, ref, out
    torch.cuda.empty_cache()
    source, replaces = next((s, r) for n, s, r in KERNELS
                            if n == "paged_attention")
    return {"name": "paged_attention", "shape": shape, "route": "cuda",
            "source": source, "replaces": replaces, "launches": launches, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"]}


def engine_serve(torch, arch, cfg, seed: int, trace, extra=None):
    """One arch (`cfg`, depth cut or not) behind `Engine` (MOE_BATCH
    slots, MOE_NUM_PAGES pages of SERVE_PAGE tokens) in exec mode gpu:
    the served run of `trace` (launch counts set to 0 just before and
    read just after), check (b) on its first MOE_B_STEPS decode steps,
    `extra(cfg, params, trace)` (a report of its own, kept under "extra"),
    then check (a) in f32 on MOE_A_PROMPTS prompts x MOE_A_NEW tokens. A
    dense arch's parameters are counted against `reckon_params` and the
    pool's K / V bytes against `reckon_state_bytes`. Returns (launches,
    report, params)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda
    from repro_torch.models.model import init_params
    from repro_torch.serving import traffic
    from repro_torch.serving.engine import Engine
    from repro_torch.store import obs
    label = f"{'moe ' if cfg.is_moe else ''}{arch}"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(DEV).manual_seed(seed))
    n_params = sum(p.numel() for p in params.parameters())
    engine = Engine(cfg, params, max_reqs=MOE_BATCH,
                    num_pages=MOE_NUM_PAGES, page_size=SERVE_PAGE,
                    max_pages_per_req=SERVE_PAGES_PER_REQ, device=DEV)
    torch.cuda.synchronize()
    plens = [len(r.prompt) for r in trace]
    if cfg.is_moe:
        what = (f"{cfg.n_experts} experts top-{cfg.n_experts_active}, "
                f"moe_impl {cfg.moe_impl}")
    else:
        reckoned = reckon_params(cfg)
        pool = 2 * engine.kv.k.numel() * engine.kv.k.element_size()
        what = (f"reckoned from the reference's shapes {reckoned}; a pool "
                f"of {pool} K / V bytes (reckoned "
                f"{reckon_state_bytes(cfg, MOE_NUM_PAGES * SERVE_PAGE)})")
        check(n_params == reckoned, f"{label}: {n_params} parameters, "
              f"reckoned {reckoned}")
        check(pool == reckon_state_bytes(cfg, MOE_NUM_PAGES * SERVE_PAGE),
              f"{label}: the pool's K / V bytes differ from the reckoning")
    print(f"{label} on {card_line()}: {cfg.n_layers} of "
          f"{get_config(arch).n_layers} layers at full width, {n_params} "
          f"parameters (f32 + a bf16 copy: {6 * n_params / 1e9:.2f} GB), "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads, {what}; "
          f"trace of {len(trace)} requests, prompts {min(plens)}.."
          f"{max(plens)} tokens; set-up {time.perf_counter() - t0:.3f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
          flush=True)
    b_report = dict(steps=0, diff=[], tol=[], bad=0, argmax_checked=0,
                    argmax_flips=0, faults={}, steps_of_diff=[])
    serve_decode_checked(torch, engine, MOE_B_STEPS, b_report)
    torch.cuda.synchronize()
    cuda.reset_launches()
    t0 = time.perf_counter()
    with obs.tracing() as tr:
        outs = traffic.replay(engine, trace, max_steps=SERVE_MAX_TICKS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    harvest_shapes(cuda)
    print(f"{label}: replay {wall:.3f} s, {engine.steps} decode steps, "
          f"launches {json.dumps(launches)}", flush=True)
    m = check_served(torch, label, engine, trace, outs, launches,
                     MOE_NUM_PAGES)
    report_check_b(label, b_report, MOE_B_STEPS)
    report = served_times(tr, m, engine, MOE_B_STEPS)
    report.update(replay_s=wall,
                  peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                  weights_gb=6 * n_params / 1e9, params=n_params)
    del engine
    torch.cuda.empty_cache()
    print(f"{label} decode: {report['decode_tokens_per_s']:.1f} tokens/s, "
          f"{report['decode_ms_per_step']:.3f} ms/step over decode steps "
          f"{MOE_B_STEPS + 1}..{report['decode_steps']}; prefill: "
          f"{report['prefill_tokens_per_s']:.1f} tokens/s "
          f"({report['prefill_tokens']} tokens in {report['prefills']} "
          f"prefills); batch fill {report['batch_fill']:.4f}; prefix hit "
          f"rate {report['prefix_hit_rate']:.4f}; peak "
          f"{report['peak_gib']:.2f} GiB allocated beside "
          f"{report['weights_gb']:.2f} GB of weights", flush=True)
    if extra is not None:
        report["extra"] = extra(cfg, params, trace)

    t0 = time.perf_counter()
    checked, low, ties = serve_reference_check(
        torch, cfg, params, trace, MOE_A_PROMPTS, MOE_A_NEW, MOE_A_PAGES)
    print(f"{label} check (a): f32, {checked} engine tokens equal the "
          f"contiguous reference's argmax; {low} steps had a top-2 margin "
          f"below {SERVE_A_MARGIN} and {ties} steps were at or after a "
          f"router near tie, and were not compared "
          f"({time.perf_counter() - t0:.3f} s)", flush=True)
    check(checked - low - ties >= checked // 2, f"{label} check (a): "
          f"fewer than half the tokens compared")
    report.update(a_checked=checked, a_low=low, a_ties=ties)
    return launches, report, params


def moe_serve(torch, arch, seed: int):
    """One MoE arch at full width and MOE_LAYERS layers behind `Engine`
    (`engine_serve`), with the paper's routing checked at full width
    (`moe_ep_check`) between checks (b) and (a), then the paged_attention
    row at the arch's decode shape. Returns (launches, report, row)."""
    from repro_torch.configs import get_config
    from repro_torch.serving import traffic
    label = f"moe {arch}"
    cfg = get_config(arch).replace(n_layers=MOE_LAYERS)

    def ep(cfg, params, trace):
        ep = moe_ep_check(torch, label, cfg, params, trace[0].prompt)
        print(f"{label} routing at full width: layer 0's FFN input of the "
              f"first prefill ({ep['tokens']} tokens) on a {MOE_MESH[1]} "
              f"{MOE_MESH[0]} mesh; dropped lanes {json.dumps(ep['drops'])} "
              f"(capacity factor {cfg.moe_capacity_factor}); max |y - "
              f"dense| {json.dumps(ep['diff'])} (routed_a2a over the "
              f"{ep['kept']} tokens neither dropped a lane of), bound "
              f"{ep['bound']:.4g}; planted fault {json.dumps(ep['fault'])}; "
              f"FFN ms a layer {json.dumps(ep['ms'])}, and "
              f"{ep['decode_ms']:.4f} for the dense dispatch at the decode "
              f"batch of {MOE_BATCH} tokens", flush=True)
        return ep
    launches, report, params = engine_serve(
        torch, arch, cfg, seed, traffic.make_trace(seed, **MOE_TRACE), ep)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    row = paged_kernel_row(torch, arch, seed,
                           launches.get("paged_attention", 0))
    return launches, report, row


def moe_phase(torch, seed: int):
    """Phase 8: each of MOE_ARCHS in turn (`moe_serve`), the card freed
    between them. Returns (launches summed, the paged_attention rows)."""
    launches, rows = collections.Counter(), []
    for arch in MOE_ARCHS:
        more, _, row = moe_serve(torch, arch, seed)
        launches.update(more)
        rows.append(row)
        gc.collect()
        torch.cuda.empty_cache()
    return dict(launches), rows


# ---------------------------------------------------------------------------
# phases 9-10: xlstm-1.3b's and minicpm3-4b's prefill and decode at full
# width and depth
# ---------------------------------------------------------------------------

# The served run: `prefill_32k` cut to 8 sequences of 4,096 seeded tokens
# (as phase 5's), cache_len 4,128, then 32 greedy decode steps, exec mode
# gpu. Neither arch reaches a kernel of the port (the reference runs the
# mLSTM / sLSTM scans and MLA's attention as plain ops), so the launch
# counts must stay 0
LM_BATCH = 8
LM_PROMPT = 4096
LM_NEW = 32
# check (a): f32 at full width and cut depth (xlstm one period of 8
# layers, minicpm3 2), the card against the CPU on 2 prompts (512 tokens
# for xlstm; 1,024 for minicpm3, so MLA's 512-query chunk loop runs), then
# 4 teacher-forced decode steps; logits and every cache leaf within a
# limit of max |CPU| each (the first readings with margin)
LM_A_PROMPTS = 2
LM_A_DECODE = 4
# check (b): f32 on the card at full depth, 2 prompts x 1,024 tokens and 8
# greedy decode steps, each step's logits against a teacher-forced
# `forward` over prompt + generated tokens, within a bound of max
# |forward| (MLA's allows for its bf16 latent cache)
LM_B_PROMPTS = 2
LM_B_PROMPT = 1024
LM_B_STEPS = 8
# The limits of checks (a) and (b) are the first readings on an NVIDIA
# H100 80GB HBM3 at its 700 W limit, with margin: xlstm's
# readings 6.1e-6..1.5e-5 in (a) and 8.5e-6..1.5e-5 in (b) (f32 sums in
# another order); minicpm3's (a) 1.3e-3 (logits) and 2.9e-3 / 3.5e-3
# (the bf16 ckv / kpe: a bf16 step is 2^-8 of an element, so two steps
# of max |CPU|), its (b) 3.6e-3..4.2e-3 (the bf16 latent cache); the
# planted faults read 0.47..0.69 and 0.17..1.3 (xlstm), 0.19..0.21 and
# 0.031..0.14 (minicpm3)
XLSTM_ARCH = "xlstm-1.3b"
XLSTM_A_LAYERS = 8
XLSTM_A_PROMPT = 512
XLSTM_A_TOL = {"logits": 1e-4, "mlstm.conv": 1e-4, "mlstm.c": 1e-4,
               "mlstm.n": 1e-4, "mlstm.m": 1e-4, "slstm.c": 1e-4,
               "slstm.n": 1e-4, "slstm.h": 1e-4, "slstm.m": 1e-4}
XLSTM_B_TOL = 1e-4
MLA_ARCH = "minicpm3-4b"
MLA_A_LAYERS = 2
MLA_A_PROMPT = 1024
MLA_A_TOL = {"logits": 5e-3, "dense.ckv": 2 ** -7, "dense.kpe": 2 ** -7}
MLA_B_TOL = 1e-2


def reckon_params(cfg) -> int:
    """The parameter count the reference's shapes give (`init_params`),
    from the config alone: the dense kind's GQA (its q / k / v biases and
    q / k norms where the config has them) or MLA, and a codebook model's
    n_cb embedding tables and its head of n_cb·Vp columns."""
    from repro_torch.models.blocks import block_kinds
    d, h, di = cfg.d_model, cfg.n_heads, cfg.ssm_expand * cfg.d_model
    dh, hkv = cfg.resolved_head_dim, cfg.n_kv_heads

    def mlp(f):
        return 3 * d * f

    def gqa():
        return (2 * d * h * dh + 2 * d * hkv * dh
                + cfg.qkv_bias * (h + 2 * hkv) * dh + cfg.qk_norm * 2 * dh)

    def layer(kind):
        if kind == "mlstm":
            return (d + 2 * d * di + cfg.ssm_conv * di + 3 * di * di
                    + di * 2 * h + di + di * d)
        if kind == "slstm":
            return (2 * d + 2 * d * 4 * d + 4 * d + d * d
                    + mlp(max(cfg.d_ff, 4 * d // 3)))
        if cfg.attn_type == "gqa":
            return 2 * d + gqa() + mlp(cfg.d_ff)
        qd = cfg.qk_nope_dim + cfg.qk_rope_dim
        attn = (d * cfg.q_lora_rank + cfg.q_lora_rank
                + cfg.q_lora_rank * h * qd + d * cfg.kv_lora_rank
                + cfg.kv_lora_rank + cfg.kv_lora_rank * h * cfg.qk_nope_dim
                + cfg.kv_lora_rank * h * cfg.v_head_dim
                + d * cfg.qk_rope_dim + h * cfg.v_head_dim * d)
        return 2 * d + attn + mlp(cfg.d_ff)
    kinds = block_kinds(cfg)
    blocks = sum(layer(k) for k in kinds) * (cfg.n_layers // len(kinds))
    heads = 1 if cfg.tie_embeddings else 2
    return blocks + heads * max(cfg.n_codebooks, 1) * cfg.padded_vocab * d + d


def reckon_state_bytes(cfg, cache_len: int) -> int:
    """Decode state bytes a sequence: xLSTM's per-layer (conv, C, n, m) and
    (c, n, h, m); MLA's (kv_lora_rank + qk_rope_dim) values a token a
    layer in `kv_cache_dtype`, GQA's K and V (2 · Hkv · Dh values)."""
    from repro_torch.models.blocks import block_kinds
    from repro_torch.models.common import dtype_of
    kinds = block_kinds(cfg)
    ng = cfg.n_layers // len(kinds)
    di = cfg.ssm_expand * cfg.d_model
    dh = di // cfg.n_heads
    ct = dtype_of(cfg.compute_dtype).itemsize
    kt = dtype_of(cfg.kv_cache_dtype).itemsize
    per = {"mlstm": (cfg.ssm_conv - 1) * di * ct
           + 4 * cfg.n_heads * (dh * dh + dh + 1),
           "slstm": 4 * 4 * cfg.d_model,
           "dense": cache_len * kt * (
               cfg.kv_lora_rank + cfg.qk_rope_dim if cfg.attn_type == "mla"
               else 2 * cfg.n_kv_heads * cfg.resolved_head_dim)}
    return ng * sum(per[k] for k in kinds)


def weights_to(torch, mod, device):
    """A copy of a `Weights` tree on `device`: its parameters, no
    load-time compute copies."""
    from torch import nn
    if isinstance(mod, nn.ModuleList):
        return nn.ModuleList(weights_to(torch, m, device) for m in mod)
    kw = {n: t.detach().to(device) for n, t in mod._parameters.items()}
    kw.update({n: weights_to(torch, m, device)
               for n, m in mod._modules.items()})
    return type(mod)(**kw)


def cut_depth(torch, params, n_layers: int):
    """The first `n_layers` layers of `params` with its embeddings, head
    and final norm, sharing their storage."""
    from torch import nn
    from repro_torch.models.model import LM
    kw = {n: t for n, t in params._parameters.items()}
    return LM(blocks=nn.ModuleList(list(params.blocks)[:n_layers]), **kw)


def cache_leaves(cfg, caches):
    """{"<kind>.<name>": [leaves over the period's dicts of that kind]}."""
    from repro_torch.models.blocks import block_kinds
    out = collections.defaultdict(list)
    for kind, d in zip(block_kinds(cfg), caches):
        for name, t in d.items():
            out[f"{kind}.{name}"].append(t)
    return out


def rel_dist(torch, got, ref) -> float:
    """max |got - ref| / max |ref| (ref's device)."""
    got = got.to(ref.device).float()
    ref = ref.float()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def lm_served(torch, label, cfg, params, toks):
    """The served run in exec mode gpu: prefill `toks` ([B, S], or a
    codebook model's [B, n_cb, S]) at cache_len prompt + LM_NEW, then
    LM_NEW greedy decode steps; the launch counts set to 0 just before
    and read just after. Checks finite logits, tokens inside the
    vocabulary and every cache leaf's shape and dtype against
    `init_caches`'. Returns (report, launches)."""
    from repro_torch.kernels import cuda
    from repro_torch.models import model as M
    b, plen = toks.shape[0], toks.shape[-1]
    cache_len = plen + LM_NEW
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    cuda.reset_launches()
    t0 = time.perf_counter()
    logits, caches, _ = M.prefill(params, cfg, toks, cache_len)
    first = logits[:, -1][..., :cfg.vocab_size].clone()
    del logits
    tok = torch.argmax(first, -1)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    gen = [tok]
    finite = bool(torch.isfinite(first).all())
    t0 = time.perf_counter()
    for i in range(LM_NEW):
        pos = torch.full((b,), plen + i, device=DEV)
        lg, caches = M.decode_step(params, cfg, tok[..., None], pos, caches)
        finite = finite and bool(torch.isfinite(
            lg[:, 0][..., :cfg.vocab_size]).all())
        tok = torch.argmax(lg[:, 0][..., :cfg.vocab_size], -1)
        gen.append(tok)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    gen = torch.stack(gen, -1)
    print(f"{label}: prefill {b} x {plen} tokens {t_pre:.3f} s, {LM_NEW} "
          f"decode steps {t_dec:.3f} s, launches {json.dumps(launches)}",
          flush=True)
    check(not launches, f"{label}: kernels launched on a path that "
          f"reaches none: {launches}")
    check(finite, f"{label}: finite logits")
    check(int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab_size,
          f"{label}: tokens in the vocabulary")
    want = M.init_caches(params, cfg, b, cache_len)
    check(len(want) == len(caches), f"{label}: caches a period")
    for w, c in zip(want, caches):
        check(list(w) == list(c), f"{label}: cache names {list(c)}")
        for name in w:
            check(c[name].shape == w[name].shape
                  and c[name].dtype == w[name].dtype,
                  f"{label}: cache {name} {tuple(c[name].shape)} "
                  f"{c[name].dtype}, init_caches gives "
                  f"{tuple(w[name].shape)} {w[name].dtype}")
    state = sum(t.numel() * t.element_size() for d in caches
                for t in d.values())
    del want, caches, lg
    return dict(prefill_tokens_per_s=b * plen / t_pre, prefill_s=t_pre,
                decode_tokens_per_s=b * LM_NEW / t_dec,
                decode_ms_per_step=1e3 * t_dec / LM_NEW, peak_gib=peak,
                state_bytes_per_seq=state / b,
                reckoned_state_bytes=reckon_state_bytes(cfg, cache_len)), \
        launches


def lm_tokens(torch, cfg, rng, b: int, s: int):
    """b seeded prompts of s positions on the CPU: [b, s] tokens, or a
    codebook model's [b, n_cb, s] grid."""
    shape = (b, cfg.n_codebooks, s) if cfg.n_codebooks else (b, s)
    return torch.from_numpy(rng.integers(1, cfg.vocab_size, shape))


def prefix_rows(torch, cfg, rng, b: int):
    """b seeded frontend prefixes [b, frontend_tokens, D] f32 on the CPU,
    N(0, 1)·0.02 as `synth_batch` draws them."""
    return torch.from_numpy(rng.standard_normal(
        (b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32) * 0.02)


def lm_check_a(torch, label, cfg, params, n_layers, plen, tol, fault,
               fault_ctx=contextlib.nullcontext, prefix=False):
    """Check (a), f32 at full width and `n_layers` layers, the card
    against the CPU on the same weights and LM_A_PROMPTS seeded prompts of
    `plen` tokens (after the config's `frontend_tokens` prefix rows with
    `prefix`): prefill, then LM_A_DECODE teacher-forced decode steps.
    The prefill's logits, each decode step's and every cache leaf (after
    prefill and after the last step) within `tol` of max |CPU| each; the
    planted `fault(caches)` (applied to the card's caches before decode,
    the decode steps run inside `fault_ctx()`) must break the logits
    limit at every decode step (no fault with `fault` None). Returns
    (errors, the fault's per step)."""
    from repro_torch.models import model as M
    cfg32 = cfg.replace(compute_dtype="float32", n_layers=n_layers)
    card = cut_depth(torch, params, n_layers)
    cpu = weights_to(torch, card, "cpu")
    rng = np.random.default_rng(cfg.n_layers)
    toks = lm_tokens(torch, cfg, rng, LM_A_PROMPTS, plen + LM_A_DECODE)
    pre = prefix_rows(torch, cfg, rng, LM_A_PROMPTS) if prefix else None
    ft = pre.shape[1] if prefix else 0
    cache_len = ft + plen + LM_A_DECODE
    errs = collections.defaultdict(float)

    def run(p, dev, planted=None):
        t = toks.to(dev)
        lg, caches, _ = M.prefill(p, cfg32, t[..., :plen], cache_len,
                                  prefix_embeds=None if pre is None
                                  else pre.to(dev))
        out = {"prefill": lg[..., :cfg.vocab_size],
               "caches prefill": cache_leaves(cfg32, caches)}
        ctx = contextlib.nullcontext()
        if planted is not None:
            caches = planted(caches)
            ctx = fault_ctx()
        with ctx:
            for i in range(LM_A_DECODE):
                pos = torch.full((LM_A_PROMPTS,), ft + plen + i, device=dev)
                lg, caches = M.decode_step(
                    p, cfg32, t[..., plen + i:plen + i + 1], pos, caches)
                out[f"decode {i}"] = lg[:, 0][..., :cfg.vocab_size]
        out["caches decode"] = cache_leaves(cfg32, caches)
        return out

    ref = run(cpu, "cpu")
    got = run(card, DEV)
    for key in ref:
        if key.startswith("caches"):
            for name, leaves in ref[key].items():
                for r, g in zip(leaves, got[key][name]):
                    check(g.shape == r.shape and g.dtype == r.dtype,
                          f"{label} check (a): {key} {name} shape/dtype")
                    errs[name] = max(errs[name], rel_dist(torch, g, r))
        else:
            errs["logits"] = max(errs["logits"],
                                 rel_dist(torch, got[key], ref[key]))
    del got
    fault_errs = []
    if fault is not None:
        bad = run(card, DEV, fault)
        fault_errs = [rel_dist(torch, bad[f"decode {i}"],
                               ref[f"decode {i}"])
                      for i in range(LM_A_DECODE)]
        del bad
    del ref, cpu, card
    for name, e in errs.items():
        check(e <= tol[name], f"{label} check (a): {name} differs by "
              f"{e:.3e} of max |CPU| > {tol[name]}")
    check(fault is None or min(fault_errs) > tol["logits"], f"{label} "
          f"check (a): the planted fault stays within the logits limit "
          f"{tol['logits']} at a decode step: {fault_errs}")
    return dict(errs), fault_errs


def lm_check_b(torch, label, cfg, params, bound, fault,
               fault_ctx=contextlib.nullcontext):
    """Check (b), f32 on the card at full depth: prefill LM_B_PROMPTS
    seeded prompts of LM_B_PROMPT tokens, LM_B_STEPS greedy decode steps,
    then a teacher-forced `forward` over prompt + generated tokens; every
    step's logits within `bound` of max |forward| at that position. The
    decode steps again from `fault(caches after prefill)`, inside
    `fault_ctx()`, on the same tokens must exceed the bound at every
    step. Returns (per-step errors, the fault's)."""
    from repro_torch.models import model as M
    cfg32 = cfg.replace(compute_dtype="float32")
    rng = np.random.default_rng(cfg.n_layers + 1)
    b, plen = LM_B_PROMPTS, LM_B_PROMPT
    toks = lm_tokens(torch, cfg, rng, b, plen).to(DEV)
    cache_len = plen + LM_B_STEPS
    lg, caches, _ = M.prefill(params, cfg32, toks, cache_len)
    tok = torch.argmax(lg[:, -1][..., :cfg.vocab_size], -1)
    del lg
    start = caches
    gen, steps = [], []
    for i in range(LM_B_STEPS):
        gen.append(tok)
        pos = torch.full((b,), plen + i, device=DEV)
        lg, caches = M.decode_step(params, cfg32, tok[..., None], pos,
                                   caches)
        steps.append(lg[:, 0][..., :cfg.vocab_size])
        tok = torch.argmax(steps[-1], -1)
    gen = torch.stack(gen, -1)
    del caches
    full, _ = M.forward(params, cfg32, torch.cat([toks, gen], -1))
    ref = full[:, plen:][..., :cfg.vocab_size]
    del full
    errs = [rel_dist(torch, s, ref[:, i]) for i, s in enumerate(steps)]
    caches = fault(start)
    del start
    fault_errs = []
    with fault_ctx():
        for i in range(LM_B_STEPS):
            pos = torch.full((b,), plen + i, device=DEV)
            lg, caches = M.decode_step(params, cfg32, gen[..., i:i + 1],
                                       pos, caches)
            fault_errs.append(rel_dist(torch, lg[:, 0][..., :cfg.vocab_size],
                                       ref[:, i]))
    del caches, ref
    check(max(errs) <= bound, f"{label} check (b): decode differs from "
          f"the teacher-forced forward by {max(errs):.3e} of max "
          f"|forward| > {bound}")
    check(min(fault_errs) > bound, f"{label} check (b): the planted fault "
          f"stays within {bound} at a step: {fault_errs}")
    return errs, fault_errs


def lm_phase(torch, seed, arch, a_layers, a_prompt, a_tol, a_fault,
             b_bound, b_fault, a_ctx=contextlib.nullcontext,
             b_ctx=contextlib.nullcontext, fp8_names=()):
    """One arch at full width and depth: seeded f32 parameters with a
    bf16 copy drawn on the card, the served run (`lm_served`), then
    checks (a) and (b) with their planted faults (a cache transform run
    before the faulted decode steps, and a context they run in), and with
    `fp8_names` a few decode steps with those cache leaves in fp8
    (`fp8_cache_decode`). Returns (launches, report)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    label = arch
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(DEV).manual_seed(seed))
    params.load_compute_copy(cfg.compute_dtype)
    n_params = sum(p.numel() for p in params.parameters())
    reckoned = reckon_params(cfg)
    rng = np.random.default_rng(seed + 24)
    toks = lm_tokens(torch, cfg, rng, LM_BATCH, LM_PROMPT).to(DEV)
    # warm-up: cuBLAS's first calls, outside the timing
    M.decode_step(params, cfg, toks[..., :1],
                  torch.full((LM_BATCH,), 64, device=DEV),
                  M.prefill(params, cfg, toks[..., :64], 64 + 1)[1])
    torch.cuda.synchronize()
    weights_gb = sum(t.numel() * t.element_size() for t in
                     params.parameters()) / 1e9 + sum(
        c.numel() * c.element_size() for m in params.modules()
        for c in getattr(m, "_compute", {}).values()) / 1e9
    print(f"{label} on {card_line()}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {n_params} parameters (reckoned from the "
          f"reference's shapes: {reckoned}, {reckoned / 1e9:.3f} B; f32 + "
          f"a bf16 copy: {weights_gb:.2f} GB); set-up "
          f"{time.perf_counter() - t0:.3f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
          flush=True)
    check(n_params == reckoned, f"{label}: {n_params} parameters, "
          f"reckoned {reckoned}")

    report, launches = lm_served(torch, label, cfg, params, toks)
    if fp8_names:
        fp8_toks = toks[:, :FP8_PROMPT].clone()
    del toks
    report.update(weights_gb=weights_gb, params=n_params)
    cache_len = LM_PROMPT + LM_NEW
    state = report["state_bytes_per_seq"]
    if reckon_state_bytes(cfg, 2 * cache_len) == reckon_state_bytes(
            cfg, cache_len):
        growth = "constant in the context"
    else:
        growth = (f"{state / cache_len:.0f} B a token, "
                  f"{state / cache_len / cfg.n_layers:.0f} B a token a layer")
    print(f"{label} prefill: {report['prefill_tokens_per_s']:.1f} tokens/s "
          f"({LM_BATCH * LM_PROMPT} tokens in {report['prefill_s']:.3f} s); "
          f"decode: {report['decode_tokens_per_s']:.1f} tokens/s, "
          f"{report['decode_ms_per_step']:.3f} ms/step; peak "
          f"{report['peak_gib']:.2f} GiB allocated beside {weights_gb:.2f} "
          f"GB of weights; decode state {state:.0f} B ({state / 2**20:.1f} "
          f"MiB) a sequence at cache_len {cache_len}, {growth} (reckoned "
          f"{report['reckoned_state_bytes']})", flush=True)
    check(report["state_bytes_per_seq"] == report["reckoned_state_bytes"],
          f"{label}: decode state bytes differ from the reckoning")
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    a_errs, a_fault_errs = lm_check_a(torch, label, cfg, params, a_layers,
                                      a_prompt, a_tol, a_fault, a_ctx)
    print(f"{label} check (a): f32, {a_layers} layers, {LM_A_PROMPTS} x "
          f"{a_prompt} tokens + {LM_A_DECODE} decode steps, card vs CPU, "
          f"max |card - CPU| / max |CPU|: "
          + json.dumps({k: float(f"{v:.3e}") for k, v in a_errs.items()})
          + f" (limits {json.dumps(a_tol)}); planted fault per decode step: "
          + json.dumps([float(f"{v:.3e}") for v in a_fault_errs])
          + f" ({time.perf_counter() - t0:.3f} s)", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    b_errs, b_fault_errs = lm_check_b(torch, label, cfg, params, b_bound,
                                      b_fault, b_ctx)
    print(f"{label} check (b): f32, full depth, {LM_B_PROMPTS} x "
          f"{LM_B_PROMPT} tokens + {LM_B_STEPS} decode steps against the "
          f"teacher-forced forward, max |decode - forward| / max |forward| "
          f"per step: " + json.dumps([float(f"{v:.3e}") for v in b_errs])
          + f" (bound {b_bound}); planted fault: "
          + json.dumps([float(f"{v:.3e}") for v in b_fault_errs])
          + f" ({time.perf_counter() - t0:.3f} s)", flush=True)
    report.update(a=a_errs, a_fault=a_fault_errs, b=b_errs,
                  b_fault=b_fault_errs)
    if fp8_names:
        gc.collect()
        torch.cuda.empty_cache()
        report["fp8"] = fp8_cache_decode(torch, label, cfg, params, fp8_toks,
                                         fp8_names)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, report


def zero_mlstm_memory(torch, cfg, caches):
    """Planted fault: every mLSTM (C, n, m) state zeroed."""
    from repro_torch.models.blocks import block_kinds
    return tuple({k: torch.zeros_like(v) if kind == "mlstm" and k != "conv"
                  else v for k, v in d.items()}
                 for kind, d in zip(block_kinds(cfg), caches))


def reset_slstm(torch, cfg, caches):
    """Planted fault: every sLSTM state reset to zero."""
    from repro_torch.models.blocks import block_kinds
    return tuple({k: torch.zeros_like(v) for k, v in d.items()}
                 if kind == "slstm" else d
                 for kind, d in zip(block_kinds(cfg), caches))


def kpe_one_late(torch, cfg, caches):
    """Planted fault: the cached rope keys roped one position further."""
    from repro_torch.models.common import apply_rope
    (d,) = caches
    kpe = d["kpe"]
    one = torch.ones(kpe.shape[:-1], device=kpe.device)
    late = apply_rope(kpe.float()[..., None, :], one, cfg.rope_theta)
    return ({**d, "kpe": late[..., 0, :].to(kpe.dtype)},)


def latent_one_late(torch, cfg, caches):
    """Planted fault: the latent cache (ckv and kpe) one position late."""
    (d,) = caches

    def late(t):
        out = torch.zeros_like(t)
        out[:, :, 1:] = t[:, :, :-1]
        return out
    return ({k: late(v) for k, v in d.items()},)


def xlstm_phase(torch, seed: int):
    """Phase 9: xlstm-1.3b at full width and depth (48 layers, 42 mLSTM +
    6 sLSTM blocks). Returns (launches, report)."""
    from repro_torch.configs import get_config
    cfg = get_config(XLSTM_ARCH)
    return lm_phase(torch, seed, XLSTM_ARCH, XLSTM_A_LAYERS, XLSTM_A_PROMPT,
                    XLSTM_A_TOL,
                    functools.partial(zero_mlstm_memory, torch,
                                      cfg.replace(n_layers=XLSTM_A_LAYERS)),
                    XLSTM_B_TOL, functools.partial(reset_slstm, torch, cfg))


def mla_phase(torch, seed: int):
    """Phase 10: minicpm3-4b at full width and depth (62 MLA layers).
    Returns (launches, report)."""
    from repro_torch.configs import get_config
    cfg = get_config(MLA_ARCH)
    return lm_phase(torch, seed, MLA_ARCH, MLA_A_LAYERS, MLA_A_PROMPT,
                    MLA_A_TOL, functools.partial(kpe_one_late, torch, cfg),
                    MLA_B_TOL, functools.partial(latent_one_late, torch, cfg),
                    fp8_names=("ckv", "kpe"))


# ---------------------------------------------------------------------------
# phases 11-13: the last four archs
# ---------------------------------------------------------------------------

# Phase 11: the dense GQA archs behind the paged engine at full width, as
# phase 8 serves the MoE archs (`engine_serve`: 16 slots, 1,024 pages of
# 16 tokens, phase 4's trace cut to 16 requests, checks (a) and (b)), the
# trace drawn over each arch's own vocabulary: qwen1.5-110b at 4 of 80
# layers (~47.5 GB at 6 B a parameter: 14.9 GB of embedding and head,
# 8.15 GB a layer), llama3-405b at 2 of 126 (~63.5 GB: 25.2 + 19.1 a
# layer) and llava-next-mistral-7b at full depth (32 layers, ~43.5 GB),
# text only (the reference's engine takes no prefix). Then paged_attention
# at each decode shape: G 8, 16 and 4 over 8 KV heads. llava goes last:
# phase 12 reuses its weights
DENSE_ARCHS = (("qwen1.5-110b", 4), ("llama3-405b", 2),
               ("llava-next-mistral-7b", 32))
# Phase 12: llava's frontend prefix. `prefill_32k` cut to 8 sequences of
# 4,096 positions (`synth_batch`: 1,152 prefix rows + 2,944 text tokens)
# through `make_serve_prefill`, then 32 steps of `make_serve_decode`, exec
# mode gpu, no kernel on the path (the reference's plain attention).
# Check (a) at 2 layers on 2 prompts of 1,152 rows + 128 tokens (the CPU
# runs them); check (b) at full depth on 2 prompts of 1,152 rows + 512
# tokens and 8 steps, against a teacher-forced `forward` with the prefix;
# its planted faults: the prefix dropped, and the prefix's positions one
# later
PREFIX_ARCH = "llava-next-mistral-7b"
PREFIX_BATCH = 8
PREFIX_SEQ = 4096
PREFIX_A_LAYERS = 2
PREFIX_A_TEXT = 128
PREFIX_B_TEXT = 512
PREFIX_FAULTS = ("prefix dropped", "prefix positions one late")
# Phase 13: musicgen-medium at full width and depth (48 layers, 1.837 B
# parameters) through `lm_phase`: 8 x 4,096 frames of 4 codebooks, 32
# decode steps, no kernel on the path. Check (a) at 4 layers on 2 x
# 1,024 frames; the planted faults: codebook 0's embedding left out of
# the sum (a), the head's codebook slices rolled by one (b)
MUSIC_ARCH = "musicgen-medium"
MUSIC_A_LAYERS = 4
MUSIC_A_PROMPT = 1024
# The limits of checks (a) and (b) are the first readings on an NVIDIA
# H100 80GB HBM3 at its 700 W limit, with margin, as phases 9-10's:
# llava's / musicgen's (a) 1.2e-3 / 1.8e-3 of max |CPU| on the logits
# (the attention operands are rounded to bf16, and an f32 projection
# summed in another order can land on the other side of a rounding
# point, as MLA's 1.3e-3) and 5.7e-3..6.1e-3 on the bf16 k / v caches
# (one bf16 step at an element near the largest: two steps are allowed);
# (b) 8.2e-4..1.2e-3 / 5.3e-4..6.4e-4 (the contiguous decode rounds q and
# the softmax weights to bf16 where `forward` does not). The planted
# faults read 1.3..1.6 (prefix dropped), 0.19..0.23 (prefix positions
# one late), 0.59..0.81 (a codebook left out) and 1.2..1.6 (head rolled)
PREFIX_A_TOL = {"logits": 5e-3, "dense.k": 2 ** -6, "dense.v": 2 ** -6}
PREFIX_B_TOL = 5e-3
MUSIC_A_TOL = {"logits": 5e-3, "dense.k": 2 ** -6, "dense.v": 2 ** -6}
MUSIC_B_TOL = 5e-3


def dense_phase(torch, seed: int):
    """Phase 11: each of DENSE_ARCHS through `engine_serve`, the card
    freed between them, each arch's paged_attention row at its decode
    shape. Returns (launches summed, (the rows, llava's parameters))."""
    from repro_torch.configs import get_config
    from repro_torch.serving import traffic
    launches, rows, params = collections.Counter(), [], None
    for arch, n_layers in DENSE_ARCHS:
        cfg = get_config(arch).replace(n_layers=n_layers)
        trace = traffic.make_trace(seed, **dict(MOE_TRACE,
                                                vocab=cfg.vocab_size))
        more, _, params = engine_serve(torch, arch, cfg, seed, trace)
        launches.update(more)
        if arch != PREFIX_ARCH:
            params = None
            gc.collect()
            torch.cuda.empty_cache()
        rows.append(paged_kernel_row(torch, arch, seed,
                                     more.get("paged_attention", 0)))
    return dict(launches), (rows, params)


def prefix_served(torch, cfg, params, seed: int):
    """The served prefix run (PREFIX_*): the batch from `synth_batch`,
    `make_serve_prefill` at cache_len PREFIX_SEQ + LM_NEW, then LM_NEW
    greedy `make_serve_decode` steps; the launch counts set to 0 just
    before and read just after, and required to stay 0. Checks the
    batch's shapes, finite logits, tokens in the vocabulary, the caches
    against `init_caches` and their bytes against the reckoning. Returns
    the report."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.kernels import cuda
    from repro_torch.models import model as M
    from repro_torch.train.step import make_serve_decode, make_serve_prefill
    label = f"{PREFIX_ARCH} prefix"
    ft = cfg.frontend_tokens
    shape = dataclasses.replace(SHAPES["prefill_32k"], seq_len=PREFIX_SEQ,
                                global_batch=PREFIX_BATCH)
    batch = synth_batch(cfg, shape, seed, 0, device=DEV)
    b = PREFIX_BATCH
    check(tuple(batch["tokens"].shape) == (b, PREFIX_SEQ - ft)
          and tuple(batch["prefix_embeds"].shape) == (b, ft, cfg.d_model)
          and batch["prefix_embeds"].dtype == torch.float32,
          f"{label}: synth_batch's shapes")
    cache_len = PREFIX_SEQ + LM_NEW
    prefill = make_serve_prefill(cfg, cache_len)
    decode = make_serve_decode(cfg)
    # warm-up: cuBLAS's first calls at these shapes, outside the timing
    warm = {"tokens": batch["tokens"][:, :64],
            "prefix_embeds": batch["prefix_embeds"][:, :64]}
    decode(params, batch["tokens"][:, :1], torch.full((b,), 128, device=DEV),
           make_serve_prefill(cfg, 129)(params, warm)[1])
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    cuda.reset_launches()
    t0 = time.perf_counter()
    last, caches = prefill(params, batch)
    tok = torch.argmax(last[:, :cfg.vocab_size], -1)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    finite = bool(torch.isfinite(last[:, :cfg.vocab_size]).all())
    gen = [tok]
    t0 = time.perf_counter()
    for i in range(LM_NEW):
        pos = torch.full((b,), PREFIX_SEQ + i, device=DEV)
        lg, caches = decode(params, tok[:, None], pos, caches)
        finite = finite and bool(torch.isfinite(lg[:, :cfg.vocab_size]).all())
        tok = torch.argmax(lg[:, :cfg.vocab_size], -1)
        gen.append(tok)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    gen = torch.stack(gen, -1)
    print(f"{label}: prefill {b} x ({ft} prefix rows + {PREFIX_SEQ - ft} "
          f"tokens) {t_pre:.3f} s, {LM_NEW} decode steps {t_dec:.3f} s, "
          f"launches {json.dumps(launches)}", flush=True)
    check(not launches, f"{label}: kernels launched on a path that reaches "
          f"none: {launches}")
    check(finite, f"{label}: finite logits")
    check(int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab_size,
          f"{label}: tokens in the vocabulary")
    (want,) = M.init_caches(params, cfg, b, cache_len)
    (got,) = caches
    check(list(got) == list(want) and all(
        got[n].shape == want[n].shape and got[n].dtype == want[n].dtype
        for n in want), f"{label}: caches against init_caches")
    state = sum(t.numel() * t.element_size() for t in got.values()) / b
    check(state == reckon_state_bytes(cfg, cache_len),
          f"{label}: decode state bytes differ from the reckoning")
    del caches, want, got, batch
    return dict(prefill_tokens_per_s=b * PREFIX_SEQ / t_pre, prefill_s=t_pre,
                decode_tokens_per_s=b * LM_NEW / t_dec,
                decode_ms_per_step=1e3 * t_dec / LM_NEW, peak_gib=peak,
                state_bytes_per_seq=state)


def prefix_check_b(torch, cfg, params, bound):
    """Check (b), f32 on the card at full depth: prefill LM_B_PROMPTS
    seeded prompts of PREFIX_B_TEXT tokens after their frontend prefix,
    LM_B_STEPS greedy decode steps, then a teacher-forced `forward` with
    the prefix over prompt + generated tokens; every step's logits within
    `bound` of max |forward|. The decode steps again after each of
    PREFIX_FAULTS' prefills must exceed the bound at every step. Returns
    (per-step errors, {fault: per-step errors})."""
    from repro_torch.models import model as M
    cfg32 = cfg.replace(compute_dtype="float32")
    rng = np.random.default_rng(cfg.n_layers + 1)
    b, plen = LM_B_PROMPTS, PREFIX_B_TEXT
    toks = lm_tokens(torch, cfg, rng, b, plen).to(DEV)
    pre = prefix_rows(torch, cfg, rng, b).to(DEV)
    ft = cfg.frontend_tokens
    cache_len = ft + plen + LM_B_STEPS

    def fed(caches, first):
        """The logits of LM_B_STEPS decode steps fed `gen` from position
        `first`."""
        out = []
        for i in range(LM_B_STEPS):
            pos = torch.full((b,), first + i, device=DEV)
            lg, caches = M.decode_step(params, cfg32, gen[:, i:i + 1], pos,
                                       caches)
            out.append(lg[:, 0, :cfg.vocab_size])
        return out

    lg, caches, _ = M.prefill(params, cfg32, toks, cache_len,
                              prefix_embeds=pre)
    first_tok = torch.argmax(lg[:, -1, :cfg.vocab_size], -1)
    del lg
    # the greedy tokens: the prefill's argmax, then each step's
    steps, gen = [], [first_tok]
    for i in range(LM_B_STEPS):
        pos = torch.full((b,), ft + plen + i, device=DEV)
        lg, caches = M.decode_step(params, cfg32, gen[-1][:, None], pos,
                                   caches)
        steps.append(lg[:, 0, :cfg.vocab_size])
        gen.append(torch.argmax(steps[-1], -1))
    gen = torch.stack(gen[:-1], -1)
    del caches
    full, _ = M.forward(params, cfg32, torch.cat([toks, gen], -1),
                        prefix_embeds=pre)
    ref = full[:, ft + plen:, :cfg.vocab_size]
    del full
    errs = [rel_dist(torch, s, ref[:, i]) for i, s in enumerate(steps)]
    faults = {}
    for name in PREFIX_FAULTS:
        if name == "prefix dropped":
            _, caches, _ = M.prefill(params, cfg32, toks, plen + LM_B_STEPS)
            first = plen
        else:
            pos = torch.arange(ft + plen, device=DEV)
            pos = torch.where(pos < ft, pos + 1, pos)[None].expand(b, -1)
            _, caches, _ = M.prefill(params, cfg32, toks, cache_len,
                                     positions=pos, prefix_embeds=pre)
            first = ft + plen
        faults[name] = [rel_dist(torch, s, ref[:, i])
                        for i, s in enumerate(fed(caches, first))]
        del caches
    del ref
    check(max(errs) <= bound, f"{PREFIX_ARCH} prefix check (b): decode "
          f"differs from the teacher-forced forward by {max(errs):.3e} of "
          f"max |forward| > {bound}")
    for name, fe in faults.items():
        check(min(fe) > bound, f"{PREFIX_ARCH} prefix check (b): the "
              f"planted fault '{name}' stays within {bound} at a step: {fe}")
    return errs, faults


def prefix_phase(torch, seed: int, params):
    """Phase 12: llava's frontend prefix on phase 11's llava weights: the
    served run (`prefix_served`), check (a) at PREFIX_A_LAYERS layers
    (`lm_check_a` with the prefix) and check (b) at full depth
    (`prefix_check_b`). Returns (launches, report)."""
    from repro_torch.configs import get_config
    cfg = get_config(PREFIX_ARCH)
    label = f"{PREFIX_ARCH} prefix"
    params.load_compute_copy(cfg.compute_dtype)
    report = prefix_served(torch, cfg, params, seed)
    print(f"{label} prefill: {report['prefill_tokens_per_s']:.1f} "
          f"positions/s ({PREFIX_BATCH * PREFIX_SEQ} in "
          f"{report['prefill_s']:.3f} s); decode: "
          f"{report['decode_tokens_per_s']:.1f} tokens/s, "
          f"{report['decode_ms_per_step']:.3f} ms/step; peak "
          f"{report['peak_gib']:.2f} GiB allocated; decode state "
          f"{report['state_bytes_per_seq']:.0f} B a sequence at cache_len "
          f"{PREFIX_SEQ + LM_NEW} (the reckoning's)", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    a_errs, _ = lm_check_a(torch, label, cfg, params, PREFIX_A_LAYERS,
                           PREFIX_A_TEXT, PREFIX_A_TOL, None, prefix=True)
    print(f"{label} check (a): f32, {PREFIX_A_LAYERS} layers, "
          f"{LM_A_PROMPTS} x ({cfg.frontend_tokens} prefix rows + "
          f"{PREFIX_A_TEXT} tokens) + {LM_A_DECODE} decode steps, card vs "
          f"CPU, max |card - CPU| / max |CPU|: "
          + json.dumps({k: float(f"{v:.3e}") for k, v in a_errs.items()})
          + f" (limits {json.dumps(PREFIX_A_TOL)}) "
          f"({time.perf_counter() - t0:.3f} s)", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    b_errs, faults = prefix_check_b(torch, cfg, params, PREFIX_B_TOL)
    print(f"{label} check (b): f32, full depth, {LM_B_PROMPTS} x "
          f"({cfg.frontend_tokens} prefix rows + {PREFIX_B_TEXT} tokens) + "
          f"{LM_B_STEPS} decode steps against the teacher-forced forward "
          f"with the prefix, max |decode - forward| / max |forward| per "
          f"step: " + json.dumps([float(f"{v:.3e}") for v in b_errs])
          + f" (bound {PREFIX_B_TOL}); planted faults: "
          + json.dumps({k: [float(f"{v:.3e}") for v in fe]
                        for k, fe in faults.items()})
          + f" ({time.perf_counter() - t0:.3f} s)", flush=True)
    report.update(a=a_errs, b=b_errs, b_faults=faults)
    return {}, report


def keep_caches(caches):
    """No cache fault (musicgen's planted faults are in the model)."""
    return caches


@contextlib.contextmanager
def codebook_left_out(torch, cfg):
    """Planted fault: codebook 0's embedding left out of the sum."""
    from repro_torch.models import model as M
    from repro_torch.models.common import dtype_of
    embed = M._embed

    def faulty(p, c, tokens, prefix_embeds=None):
        t = tokens.long()
        return sum(p.embed[i][t[:, i]] for i in range(1, c.n_codebooks)).to(
            dtype_of(c.compute_dtype))
    M._embed = faulty
    try:
        yield
    finally:
        M._embed = embed


@contextlib.contextmanager
def head_rolled(torch):
    """Planted fault: the head's codebook slices rolled by one (codebook
    c's logits from codebook c - 1's columns)."""
    from repro_torch.models import model as M
    head = M._head
    M._head = lambda p, c, x: head(p, c, x).roll(1, dims=-2)
    try:
        yield
    finally:
        M._head = head


def music_phase(torch, seed: int):
    """Phase 13: musicgen-medium at full width and depth (48 layers, 4
    codebooks). Returns (launches, report)."""
    from repro_torch.configs import get_config
    cfg = get_config(MUSIC_ARCH)
    return lm_phase(torch, seed, MUSIC_ARCH, MUSIC_A_LAYERS, MUSIC_A_PROMPT,
                    MUSIC_A_TOL, keep_caches, MUSIC_B_TOL, keep_caches,
                    functools.partial(codebook_left_out, torch, cfg),
                    functools.partial(head_rolled, torch))


# ---------------------------------------------------------------------------
# phase 14: pod-compressed training and the pipeline primitive
# ---------------------------------------------------------------------------

# qwen3-1.7b at full width cut to 4 of its 28 layers (phase 7's depth would
# double the phase's time, and the exchange's work is a leaf's, not a
# layer's); phase 7's 8 x 4,096 tokens a step, on a (2, 4) ("pod", "data")
# mesh folded onto the card: each pod's 4 sequences in 2 microbatches (2
# sequences each, phase 7's microbatch)
POD_ARCH = "qwen3-1.7b"
POD_LAYERS = 4
POD_MESH = (("pod", "data"), (2, 4))
POD_STEPS = 3
POD_PLAIN_MICRO = 4
POD_MICRO = 2
POD_LOSS_RTOL = 0.05        # the reference's compress_prog.py rule
POD_MEAN_ULPS = 4           # f32 rounding beyond sum_p scale_p / (2P)
PEAK_BF16 = 989e12          # H100 SXM data sheet, dense bf16 (launch/roofline)
# 4 stages of one qwen3-1.7b dense block each (full width, bf16 compute,
# forward only), 8 microbatches of 1 x 4,096 tokens
PIPE_STAGES = 4
PIPE_MICRO = 8
PIPE_SEQ = 4096


def pod_recorder(torch, compress, sink: list):
    """Wrap `compress.quantize_pod` / `compress.exchange` so each call's
    inputs and outputs land in `sink` (clones, the clone time apart) and
    the exchange is timed apart; returns the undo."""
    quant, exch = compress.quantize_pod, compress.exchange

    def quantize_pod(grads, residuals, pod, leaves):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seen = {n: (g.detach().clone(), residuals[n][pod].clone())
                for n, g in grads.items()}
        torch.cuda.synchronize()
        clone_s = time.perf_counter() - t0
        out = quant(grads, residuals, pod, leaves)
        sink.append(("pod", pod, seen, out,
                     {n: residuals[n][pod].clone() for n in grads}, clone_s))
        return out

    def exchange(payloads, dtypes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = exch(payloads, dtypes)
        torch.cuda.synchronize()
        sink.append(("exchange", out, time.perf_counter() - t0))
        return out

    compress.quantize_pod, compress.exchange = quantize_pod, exchange

    def undo():
        compress.quantize_pod, compress.exchange = quant, exch
    return undo


def pod_mean_check(torch, pods, g_new, n_pods: int, fault: bool = False):
    """Per leaf, |g' - mean_p(g_p + r_p)| <= sum_p scale_p / (2P) plus f32
    rounding; with `fault`, g' is the sum over pods in place of the mean.
    Returns (leaves over the limit, worst excess over the limit)."""
    over, worst = 0, 0.0
    for n, got in g_new.items():
        want = sum(g.float() + r for (g, r) in (p[2][n] for p in pods))
        want = want / n_pods
        if fault:
            got = got * n_pods
        limit = sum(float(p[3][n][1]) for p in pods) / (2 * n_pods)
        limit += POD_MEAN_ULPS * float(torch.finfo(torch.float32).eps
                                       * want.abs().max())
        err = float((got.float() - want).abs().max())
        if err > limit:
            over += 1
            worst = max(worst, err - limit)
    return over, worst


def pod_step_checks(torch, rec, n_params: int, n_pods: int) -> dict:
    """One compressed step's checks on its recording."""
    pods = [r for r in rec if r[0] == "pod"]
    (_, g_new, exch_s), = [r for r in rec if r[0] == "exchange"]
    check([p[1] for p in pods] == list(range(n_pods)),
          f"pods quantized {[p[1] for p in pods]}")
    exact = all(torch.equal(p[4][n], (p[2][n][0].float() + p[2][n][1])
                            - p[3][n][0].float() * p[3][n][1])
                for p in pods for n in p[4])
    check(exact, "residuals differ from g32 - q * scale")
    dtypes = {p[3][n][0].dtype for p in pods for n in p[3]}
    check(dtypes == {torch.int8}, f"payload dtypes {dtypes}")
    # one f32 scale a leaf of the reference's tree (its layers stacked)
    n_leaves = len({id(v[1]) for v in pods[0][3].values()})
    sent = sum(p[3][n][0].numel() * p[3][n][0].element_size()
               for p in pods for n in p[3]) + n_pods * n_leaves * 4
    check(sent == n_pods * n_params + n_pods * n_leaves * 4,
          f"exchanged {sent} bytes, not {n_pods} x {n_params} + scales")
    over, worst = pod_mean_check(torch, pods, g_new, n_pods)
    check(over == 0, f"{over} leaves' mean beyond sum scale / 2P "
                     f"(worst by {worst:.3e})")
    f_over, _ = pod_mean_check(torch, pods, g_new, n_pods, fault=True)
    check(f_over > 0, "the planted fault (the sum over pods in place of "
                      "the mean) passed the mean check")
    clones = sum(t.numel() * t.element_size() for p in pods
                 for n in p[4] for t in (p[2][n][0], p[2][n][1], p[4][n]))
    return {"exchange_s": exch_s, "bytes": sent, "clone_bytes": clones,
            "clone_s": sum(p[5] for p in pods), "fault_leaves": f_over,
            "names": len(pods[0][3]), "scales": n_leaves}


def pod_train(torch, cfg, params, shape, seed: int, pod_compress: bool):
    """POD_STEPS steps of the train step from `params` on `synth_batch`'s
    seeded batches; (losses, step seconds, each compressed step's checks,
    peak GiB, the optimizer state). A step's recording is checked and
    dropped before the next step. Compressed, one more step runs without
    the recording, and the peak is (over the recorded steps, over that
    step)."""
    from repro_torch.core.routing import ShardMesh
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.optim import compress
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.step import make_train_step
    mesh = ShardMesh(*POD_MESH)
    params.make_trainable()
    opt = {"adam": adamw_init(params)}
    if pod_compress:
        opt["residuals"] = compress.compress_state_init(params,
                                                        mesh.shape["pod"])
    step = make_train_step(cfg, microbatches=(POD_MICRO if pod_compress
                                              else POD_PLAIN_MICRO),
                           pod_compress=pod_compress, mesh=mesh)
    n_params = sum(p.numel() for p in params.parameters())
    losses, secs, checks = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for s in range(POD_STEPS):
        batch = synth_batch(cfg, shape, seed, s, device=DEV)
        rec = []
        undo = pod_recorder(torch, compress, rec) if pod_compress else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
        finally:
            if undo:
                undo()
        secs.append(time.perf_counter() - t0
                    - sum(r[5] for r in rec if r[0] == "pod"))
        losses.append(float(m["loss"]))
        if pod_compress:
            checks.append(pod_step_checks(torch, rec, n_params,
                                          mesh.shape["pod"]))
        del rec
    peak = torch.cuda.max_memory_allocated() / 2**30
    if pod_compress:
        # one more step without the recorder: the peak without its clones
        batch = synth_batch(cfg, shape, seed, POD_STEPS, device=DEV)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        params, opt, _ = step(params, opt, batch)
        torch.cuda.synchronize()
        peak = (peak, torch.cuda.max_memory_allocated() / 2**30)
    return losses, secs, checks, peak, opt


def pod_training(torch, seed: int) -> dict:
    """(a) pod-compressed training against plain steps from one init."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.kernels import cuda
    from repro_torch.launch.roofline import model_flops
    from repro_torch.models import model as M
    cfg = get_config(POD_ARCH).replace(n_layers=POD_LAYERS)
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=TRAIN_BATCH)
    n_pods = POD_MESH[1][0]
    init = M.init_params(cfg, torch.Generator(DEV).manual_seed(seed))
    n_params = sum(p.numel() for p in init.parameters())
    plain = copy.deepcopy(init)
    cuda.reset_launches()
    p_losses, p_secs, _, p_peak, _ = pod_train(torch, cfg, plain, shape,
                                               seed, False)
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    c_losses, c_secs, checks, (c_peak, c_bare), opt = pod_train(
        torch, cfg, init, shape, seed, True)
    launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    check(not launches, f"the pod train path launched kernels: {launches}")
    check(all(math.isfinite(x) for x in p_losses + c_losses),
          f"losses {p_losses} {c_losses}")
    for a, b in zip(p_losses, c_losses):
        check(abs(a - b) <= POD_LOSS_RTOL * max(abs(a), 1.0),
              f"compressed loss {b} vs plain {a}")
    res = sum(float(r.abs().sum()) for r in opt["residuals"].values())
    check(res > 0, "error-feedback residuals never populated")
    del init, opt
    gc.collect()
    torch.cuda.empty_cache()
    mf = model_flops(cfg, shape)
    p_ms = statistics.fmean(p_secs[1:]) * 1e3
    c_ms = statistics.fmean(c_secs[1:]) * 1e3
    x_ms = statistics.fmean(c["exchange_s"] for c in checks[1:]) * 1e3
    # bytes a pod sends: its payload and scales to the P - 1 others,
    # against a ring all-reduce of the bf16 gradients (2 (P - 1) / P x 2N)
    sent = (n_pods - 1) * checks[0]["bytes"] // n_pods
    bf16_psum = 2 * (n_pods - 1) * 2 * n_params // n_pods
    print(f"pods: {cfg.name} full width, {POD_LAYERS} of 28 layers "
          f"({n_params} parameters, f32, bf16 compute, remat), "
          f"{shape.global_batch} x {shape.seq_len} tokens a step on "
          f"{POD_MESH[1]} {POD_MESH[0]} folded; plain {POD_PLAIN_MICRO} "
          f"microbatches, compressed {POD_MICRO} a pod; {POD_STEPS} steps "
          f"each", flush=True)
    print(f"pods: losses plain {p_losses} compressed {c_losses} (within "
          f"{POD_LOSS_RTOL:.0%}); residual |r| sum {res:.6e}; the planted "
          f"fault (sum over pods, not the mean) broke the mean check on "
          f"{[c['fault_leaves'] for c in checks]} of {checks[0]['names']} "
          f"parameters by step; {checks[0]['scales']} scales a pod (one a "
          f"leaf of the reference's stacked tree)", flush=True)
    print(f"pods: {p_ms:.3f} ms a step plain, {c_ms:.3f} compressed "
          f"(steps 1-{POD_STEPS - 1}; by step {[round(s * 1e3, 3) for s in p_secs]}"
          f" / {[round(s * 1e3, 3) for s in c_secs]}); exchange "
          f"{x_ms:.3f} ms a step apart; int8 payloads + scales "
          f"gathered {checks[0]['bytes']} bytes a step, {sent} sent a pod "
          f"against a bf16 ring psum's {bf16_psum} "
          f"({sent / bf16_psum:.4f}x); peak "
          f"{p_peak:.3f} GiB plain, {c_bare:.3f} GiB compressed (step "
          f"{POD_STEPS}, unrecorded; {c_peak:.3f} over the recorded steps "
          f"with the checks' clones, {checks[0]['clone_bytes'] / 2**30:.3f}"
          f" GiB a step)", flush=True)
    print(f"pods: model FLOPs {mf:.6e} a step: share of {PEAK_BF16:.3e} "
          f"FLOP/s {mf / (p_ms * 1e-3 * PEAK_BF16):.4f} plain, "
          f"{mf / (c_ms * 1e-3 * PEAK_BF16):.4f} compressed; card "
          f"{card_line()}", flush=True)
    return {"plain_ms": p_ms, "comp_ms": c_ms, "exchange_ms": x_ms,
            "peak_gib": c_bare}


def pipeline_check(torch, seed: int) -> dict:
    """(b) the fill-drain pipeline of PIPE_STAGES full-width qwen3-1.7b
    blocks against their sequential application."""
    from torch.func import functional_call, stack_module_state
    from repro_torch.configs import get_config
    from repro_torch.core.routing import ShardMesh
    from repro_torch.models.blocks import block_forward, init_block
    from repro_torch.parallel import pipeline
    cfg = get_config(POD_ARCH)
    gen = torch.Generator(DEV).manual_seed(seed + 14)
    blocks = [init_block(gen, cfg, "dense") for _ in range(PIPE_STAGES)]
    stacked, _ = stack_module_state(blocks)
    template = blocks[0]
    positions = torch.arange(PIPE_SEQ, device=DEV, dtype=torch.int32)[None]

    class Stage(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.block = template

        def forward(self, x):
            return block_forward(self.block, cfg, "dense", x, positions,
                                 0)[0]

    stage = Stage()

    def stage_fn(p, x):
        return functional_call(stage, {f"block.{k}": v for k, v in p.items()},
                               (x,))

    xs = (torch.randn((PIPE_MICRO, 1, PIPE_SEQ, cfg.d_model), generator=gen,
                      device=DEV) * 0.5).to(torch.bfloat16)
    mesh = ShardMesh(("stage",), (PIPE_STAGES,))
    run = pipeline.pipeline_apply(stage_fn, mesh)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ys = run(stacked, xs)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        want = []
        for m in range(PIPE_MICRO):
            y = xs[m]
            for s in range(PIPE_STAGES):
                y = stage_fn({k: v[s] for k, v in stacked.items()}, y)
            want.append(y)
        want = torch.stack(want)
        err = float((ys.float() - want.float()).abs().max())
        check(bool(torch.isfinite(ys.float()).all()), "pipeline outputs")
        check(torch.equal(ys, want),
              f"pipeline vs sequential blocks: max |diff| {err}")
        shift = pipeline._shift
        pipeline._shift = lambda y, zeros: list(y)
        try:
            bad = run(stacked, xs)
        finally:
            pipeline._shift = shift
        f_err = float((bad.float() - want.float()).abs().max())
        check(not torch.equal(bad, want) and f_err > 0,
              "the planted fault (the shift skipped) matched the "
              "sequential blocks")
    ticks = PIPE_MICRO + PIPE_STAGES - 1
    print(f"pipeline: {PIPE_STAGES} stages of one {cfg.name} dense block "
          f"(full width, {cfg.compute_dtype}), {PIPE_MICRO} microbatches of "
          f"1 x {PIPE_SEQ} tokens: {ms:.3f} ms, {ticks} ticks, "
          f"{PIPE_STAGES * ticks} stage calls, bubble "
          f"{(PIPE_STAGES - 1) / ticks:.4f}; bit for bit the sequential "
          f"blocks; the planted fault (shift skipped) off by {f_err:.3e}",
          flush=True)
    return {"pipe_ms": ms}


def pods_phase(torch, seed: int) -> dict:
    """Phase 14: pod-compressed training, then the pipeline primitive. No
    CUDA kernel of the port is on either path."""
    report = pod_training(torch, seed)
    gc.collect()
    torch.cuda.empty_cache()
    report.update(pipeline_check(torch, seed))
    return report


# ---------------------------------------------------------------------------
# phase 15: hymba-1.5b trained on the card, and the launchers
# ---------------------------------------------------------------------------

# hymba-1.5b at full width and depth (32 layers, d_model 1,600, d_inner
# 3,200, N 16; f32 parameters and AdamW moments, bf16 compute, remat,
# attn_impl "xla" as the reference trains) through `train()` in exec mode
# gpu: `SHAPES["train_4k"]` cut to 4 sequences of 4,096 tokens a step (the
# global batch of 256 cut to what leaves the phase ~1 minute; the
# remat'd "xla" attention's f32 score chain of one 2-sequence microbatch
# and the f32 logits fit beside the 26 GB of parameters, gradients and
# moments), 2 microbatches, 3 steps. Each microbatch runs the scan's
# forward kernel twice a layer (the forward, and remat's recompute before
# the backward) and its backward kernel once
HTRAIN_SEQS = 4
HTRAIN_MICRO = 2
HTRAIN_STEPS = 3
# step 1 in exec mode gpu against exec mode torch (the plain chunked scan
# under autograd) from the same weights at full width and
# HTRAIN_PARITY_LAYERS layers on one 4,096-token sequence: loss and
# gradient norm within these relative limits. The two scans differ in f32
# summation order and in ex2.approx against expf, and every layer rounds
# its output to bf16, where a tiny difference tips a rounding now and
# then
HTRAIN_PARITY_LAYERS = 4
HTRAIN_PARITY_LOSS_RTOL = 1e-3
HTRAIN_PARITY_GNORM_RTOL = 1e-2


def hymba_train_run(torch, cfg, seed: int) -> tuple:
    """The main run; returns (launches, report)."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.kernels import cuda
    from repro_torch.models import model as M
    from repro_torch.train.loop import train
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=HTRAIN_SEQS)
    params = M.init_params(cfg, torch.Generator(DEV).manual_seed(seed))
    n_params = sum(p.numel() for p in params.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launches()
    t0 = time.perf_counter()
    params, opt, out = train(cfg, shape, steps=HTRAIN_STEPS, seed=seed,
                             microbatches=HTRAIN_MICRO, log_every=1,
                             device=DEV, params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    hist = out["history"]
    check([h["step"] for h in hist] == list(range(HTRAIN_STEPS)),
          f"hymba train: steps {[h['step'] for h in hist]}")
    check(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
              for h in hist), f"hymba train: non-finite loss or grad norm "
          f"{hist}")
    check(int(opt["adam"]["step"]) == HTRAIN_STEPS,
          f"hymba train: adam step {int(opt['adam']['step'])}")
    micro = HTRAIN_STEPS * HTRAIN_MICRO
    want = {"selective_scan": 2 * cfg.n_layers * micro,
            "selective_scan/save": 2 * cfg.n_layers * micro,
            "selective_scan_bwd": cfg.n_layers * micro}
    check(launches == want, f"hymba train: launches {launches}, want "
          f"{want} (the scan's saving forward twice a layer and "
          f"microbatch, with remat, and its backward once; no other "
          f"kernel)")
    tokens = shape.global_batch * shape.seq_len
    step_s = statistics.fmean(h["time"] for h in hist[1:])
    print(f"hymba train: {cfg.name} {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, d_inner {cfg.ssm_expand * cfg.d_model}, N "
          f"{cfg.ssm_state}, {n_params} parameters ({cfg.param_dtype}, "
          f"{cfg.compute_dtype} compute, remat {cfg.remat}, attn_impl "
          f"{cfg.attn_impl}, exec mode gpu); {shape.name} cut to "
          f"{shape.global_batch} x {shape.seq_len} = {tokens} tokens a "
          f"step, {HTRAIN_MICRO} microbatches; {HTRAIN_STEPS} steps in "
          f"{wall:.3f} s", flush=True)
    print(f"hymba train: losses {[h['loss'] for h in hist]}, grad norms "
          f"{[h['grad_norm'] for h in hist]}; launches {json.dumps(launches)}"
          f" ({cfg.n_layers} layers x {micro} microbatches)", flush=True)
    print(f"hymba train: {step_s * 1e3:.3f} ms a step (steps "
          f"1-{HTRAIN_STEPS - 1}; by step "
          f"{[round(h['time'] * 1e3, 3) for h in hist]}), "
          f"{tokens / step_s:.1f} tokens/s; peak {peak:.3f} GiB; card "
          f"{card_line()}", flush=True)
    del params, opt, out
    return launches, {"ms_per_step": step_s * 1e3,
                      "tokens_per_s": tokens / step_s, "peak_gib": peak}


def hymba_train_parity(torch, cfg, seed: int) -> dict:
    """Step 1 in exec modes gpu and torch from the same weights and batch
    (full width, HTRAIN_PARITY_LAYERS layers, one 4,096-token sequence):
    loss and gradient norm."""
    from repro_torch import exec as exec_
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.kernels import cuda
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.step import make_train_step
    cfg = cfg.replace(n_layers=HTRAIN_PARITY_LAYERS)
    shape = ShapeConfig("parity", HYMBA_PROMPT, 1, "train")
    init = M.init_params(cfg, torch.Generator(DEV).manual_seed(seed + 1))
    batch = synth_batch(cfg, shape, seed, 0, device=DEV)
    out = {}
    for mode in ("gpu", "torch"):
        p = copy.deepcopy(init)
        p.make_trainable()
        cuda.reset_launches()
        t0 = time.perf_counter()
        with exec_.exec_mode(mode):
            _, _, m = make_train_step(cfg)(p, {"adam": adamw_init(p)},
                                           batch)
            out[mode] = (float(m["loss"]), float(m["grad_norm"]))
        torch.cuda.synchronize()
        out[mode] += (time.perf_counter() - t0,
                      {k: v for k, v in cuda.LAUNCHES.items() if v})
        del p
        gc.collect()
        torch.cuda.empty_cache()
    (gl, gg, gt, g_l), (tl, tg, tt, t_l) = out["gpu"], out["torch"]
    check(g_l == {"selective_scan": 2 * cfg.n_layers,
                  "selective_scan/save": 2 * cfg.n_layers,
                  "selective_scan_bwd": cfg.n_layers} and not t_l,
          f"hymba train parity: launches gpu {g_l}, torch {t_l}")
    lerr, gerr = abs(gl - tl) / abs(tl), abs(gg - tg) / abs(tg)
    print(f"hymba train step 1, gpu vs torch mode: {cfg.n_layers} layers, 1 "
          f"x {HYMBA_PROMPT} tokens, {cfg.compute_dtype} compute: loss {gl} "
          f"vs {tl} (rel {lerr:.3e}, limit {HTRAIN_PARITY_LOSS_RTOL}), "
          f"grad norm {gg} vs {tg} (rel {gerr:.3e}, limit "
          f"{HTRAIN_PARITY_GNORM_RTOL}); step {gt:.3f} s vs {tt:.3f} s",
          flush=True)
    check(math.isfinite(gl) and math.isfinite(gg), "hymba parity: finite")
    check(lerr <= HTRAIN_PARITY_LOSS_RTOL, f"hymba parity: loss rel {lerr}")
    check(gerr <= HTRAIN_PARITY_GNORM_RTOL,
          f"hymba parity: grad norm rel {gerr}")
    return {"loss_rel": lerr, "gnorm_rel": gerr}


def launchers_on_card(torch) -> dict:
    """`launch.serve` on the reduced qwen3-1.7b as it is (head_dim 16, G
    2: the paged kernel at D 16) and `launch.train` on the reduced
    hymba-1.5b (the scan's backward kernel), both on the card. Returns
    each one's launches."""
    import io
    from repro_torch.kernels import cuda
    from repro_torch.launch import serve as lserve
    from repro_torch.launch import train as ltrain
    out = {}
    for name, mod, argv, want in (
            ("serve", lserve, ["--arch", "qwen3-1.7b", "--requests", "3",
                               "--max-new", "4"], "served 3 requests"),
            ("train", ltrain, ["--arch", "hymba-1.5b", "--steps", "2",
                               "--seq", "64", "--batch", "2"],
             "final loss")):
        buf = io.StringIO()
        cuda.reset_launches()
        with contextlib.redirect_stdout(buf):
            mod.main(argv)
        torch.cuda.synchronize()
        out[name] = {k: v for k, v in cuda.LAUNCHES.items() if v}
        text = buf.getvalue().strip().splitlines()[-1]
        check(want in text, f"launch.{name}: {text}")
        print(f"launch.{name} {' '.join(argv)}: {text}; launches "
              f"{json.dumps(out[name])}", flush=True)
    check(out["serve"].get("paged_attention", 0) > 0,
          "launch.serve launched no paged_attention")
    check(out["train"].get("selective_scan_bwd", 0) == 2 * 2,
          f"launch.train hymba: launches {out['train']}")
    return out


def hymba_train_phase(torch, seed: int):
    """Phase 15: hymba-1.5b's main training run, step 1 against exec mode
    torch, then the two launchers. Returns (launches, report), the
    launches those of the main run and of the serve launcher's paged
    decode (`paged_attention/reduced`)."""
    from repro_torch.configs import get_config
    cfg = get_config(HYMBA_ARCH)
    check((cfg.param_dtype, cfg.compute_dtype, cfg.remat, cfg.attn_impl,
           cfg.ssm_scan_dtype) == ("float32", "bfloat16", True, "xla",
                                   "float32"),
          f"not the reference's train configuration: {cfg}")
    launches, report = hymba_train_run(torch, cfg, seed)
    gc.collect()
    torch.cuda.empty_cache()
    report.update(hymba_train_parity(torch, cfg, seed))
    gc.collect()
    torch.cuda.empty_cache()
    more = launchers_on_card(torch)
    launches = dict(launches)
    launches["paged_attention/reduced"] = more["serve"]["paged_attention"]
    return launches, report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import cuda as rt
    # full f32 matmuls (the model's f32 check and the bf16-operand
    # einsums of `models.common` rely on them), and no TF32 convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    done = phase("1 device and build")
    print(card_line(), flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}",
          flush=True)
    t0 = time.perf_counter()
    rt.build_all()
    for name, _, _ in KERNELS:
        rt.library(name)
    print(f"build: {time.perf_counter() - t0:.3f} s", flush=True)
    done()

    done = phase("2 kernels")
    rows = kernel_phase(torch, args.seed + 1)
    done()

    done = phase("3 main path")
    plans = make_stream(args.seed)
    t0 = time.perf_counter()
    oracle, live = dict_oracle(plans)
    n_live = len(live)
    del live
    pq_plans, pq_expect, pq_final = make_pq_stream(args.seed)
    print(f"stream: {len(plans)} plans, "
          f"{sum(len(p[1]) for p in plans)} lanes; pq stream: "
          f"{len(pq_plans)} plans, {sum(len(p[1]) for p in pq_plans)} "
          f"lanes, final {pq_final}; oracles "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    launches = main_path(torch, plans, oracle, n_live, pq_plans, pq_expect,
                         pq_final)
    done()

    moe_rows = []
    for name, run in (("4 serving", serving_phase), ("5 hymba", hymba_phase),
                      ("6 sharded store", sharded_phase),
                      ("7 train", train_phase),
                      ("8 moe serving", moe_phase),
                      ("9 xlstm", xlstm_phase), ("10 mla", mla_phase)):
        done = phase(name)
        more, extra = run(torch, args.seed)
        if run is moe_phase:
            moe_rows = extra
        for k, v in more.items():
            launches[k] = launches.get(k, 0) + v
        # the serving engine's checked decode closes a reference cycle
        # over the engine: free its parameters and pools before the next
        # phase measures its own memory
        gc.collect()
        torch.cuda.empty_cache()
        done()

    done = phase("11 dense serving")
    more, (dense_rows, llava) = dense_phase(torch, args.seed)
    for k, v in more.items():
        launches[k] = launches.get(k, 0) + v
    done()
    done = phase("12 llava prefix")
    prefix_phase(torch, args.seed, llava)
    del llava
    gc.collect()
    torch.cuda.empty_cache()
    done()
    done = phase("13 musicgen")
    music_phase(torch, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    done()
    done = phase("14 pods and pipeline")
    pods_phase(torch, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    done()
    done = phase("15 hymba training and the launchers")
    more, _ = hymba_train_phase(torch, args.seed)
    reduced_launches = more.pop("paged_attention/reduced")
    for k, v in more.items():
        launches[k] = launches.get(k, 0) + v
    gc.collect()
    torch.cuda.empty_cache()
    done()

    # the scan's saving forward has a row of its own
    launches["selective_scan"] -= launches.get("selective_scan/save", 0)
    out = []
    for name, source, replaces in KERNELS:
        r = rows[name]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches.get(name, 0),
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"]})
    for name, r, n in (
            ("paged_attention", rows["paged_attention"]["reduced"],
             reduced_launches),
            ("selective_scan", rows["selective_scan_bwd"]["save"],
             launches.get("selective_scan/save", 0))):
        source, replaces = next((s, rp) for k, s, rp in KERNELS
                                if k == name)
        out.append({"name": name, "shape": r["shape"], "route": "cuda",
                    "source": source, "replaces": replaces, "launches": n,
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                    "bound_by": r["bound"][1],
                    "library_ms": r["library_ms"]})
    out.extend(moe_rows + dense_rows)
    print(card_line(), flush=True)
    print("calls by shape over the main path, serving, hymba, the "
          "sharded store and the MoE and dense serving: "
          + json.dumps(calls_by_shape(SHAPE_LAUNCHES)), flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
