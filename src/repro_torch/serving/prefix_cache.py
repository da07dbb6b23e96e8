"""Prefix cache on the Store API (counterpart of
`repro.serving.prefix_cache`): a `tiered3/lru` store (§IX hot hash -> warm
skiplist -> spill runs) mapping hash(token block) -> KV page handle,
driven as OP_FIND / OP_INSERT plans through the cached single-shard
`store.engine.local_store_engine` over `obs:tiered3/lru`.

Values are (gen << 32 | page_id) pool handles; a hit is only usable if
the generation still matches (the ABA check), so a recycled page
invalidates its cache entries without an eviction sweep.

`block_key` chains `hash64` over a block's tokens on device, as the
reference does; `page_keys` computes the same chain for a whole prompt on
the host in Python integers (the engine's admission path), which
`tests/test_torch_serving.py` holds bit for bit against the reference.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.bits import from_u64, hash64
from repro_torch.core.blockpool import BlockPool, handle_valid
from repro_torch.core.layout import resolve_device
from repro_torch.store import engine as engine_mod
from repro_torch import exec as exec_
from repro_torch.store.api import OP_FIND, OP_INSERT, OP_NONE

BACKEND = "obs:tiered3/lru"
_M64 = (1 << 64) - 1


class PrefixCache(NamedTuple):
    store: Any               # `obs:tiered3/lru` state
    hits: torch.Tensor       # () int64
    misses: torch.Tensor     # () int64


def _engine(lanes: int, device) -> engine_mod.StoreEngine:
    return engine_mod.local_store_engine(BACKEND, lanes, exec_.get_mode(),
                                         str(device))


def prefix_cache_init(capacity: int = 1024, device="cuda",
                      **kw) -> PrefixCache:
    dev = resolve_device(device)
    z = torch.tensor(0, dtype=torch.int64, device=dev)
    return PrefixCache(store=_engine(1, dev).init(capacity, **kw), hits=z,
                       misses=z.clone())


def block_key(tokens_block: torch.Tensor,
              prev_key: torch.Tensor) -> torch.Tensor:
    """Rolling hash of a token block chained on the previous block's key
    (prefix identity = chain of block hashes); int64 bit patterns."""
    h = prev_key
    for i in range(tokens_block.shape[-1]):
        h = hash64(h ^ tokens_block[..., i].to(torch.int64))
    return h


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def page_keys(prompt, page: int) -> list[int]:
    """The chained `block_key` of each FULL page of `prompt`, from a zero
    key, as u64 Python ints (host arithmetic, no device work)."""
    toks = [int(t) & _M64 for t in np.asarray(prompt).tolist()]
    keys, h = [], 0
    for j in range(len(toks) // page):
        for t in toks[j * page:(j + 1) * page]:
            h = _splitmix64(h ^ t)
        keys.append(h)
    return keys


def lookup(pc: PrefixCache, pool: BlockPool, keys: torch.Tensor):
    """Returns (pc', page_ids [-1 on a miss], fresh). One OP_FIND plan;
    stale (recycled-page) entries miss through the generation check."""
    k = keys.shape[0]
    ops = torch.full((k,), OP_FIND, dtype=torch.int32, device=keys.device)
    store, handles, found, _ = _engine(k, keys.device).step(
        pc.store, ops, keys, torch.zeros_like(keys))
    fresh = found & handle_valid(pool, handles)
    ids = torch.where(fresh, handles & 0xFFFFFFFF, -1).to(torch.int32)
    n_fresh = fresh.sum()
    return pc._replace(store=store, hits=pc.hits + n_fresh,
                       misses=pc.misses + (k - n_fresh)), ids, fresh


def insert(pc: PrefixCache, keys: torch.Tensor, handles: torch.Tensor,
           mask: torch.Tensor) -> PrefixCache:
    """Publish page handles under their prefix hashes (one OP_INSERT plan;
    insert-if-absent)."""
    ops = torch.where(mask, OP_INSERT, OP_NONE).to(torch.int32)
    store, _, _, _ = _engine(keys.shape[0], keys.device).step(
        pc.store, ops, keys, handles)
    return pc._replace(store=store)


def metrics(pc: PrefixCache) -> dict:
    """The cache store's metrics plane (find_hits/find_misses, hot/warm/
    spill hits, evictions, ... over `obs.METRICS_SCHEMA`) as host ints."""
    per = engine_mod.sharded_metrics(BACKEND, pc.store)
    return {k: int(v[0]) for k, v in per.items()}


def keys_tensor(keys: list[int], device) -> torch.Tensor:
    """u64 Python ints -> their int64 bit patterns on `device`."""
    return from_u64(np.asarray(keys, dtype=np.uint64), device)
