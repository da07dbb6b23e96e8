"""Paged KV cache on the paper's §V block pool (counterpart of
`repro.serving.kvcache`).

KV pages ARE pool blocks: allocation is a free-ring pop, request completion
a push back (recycling), and generation counters catch stale block-table
references (the ABA guard). Per-layer K/V page data lives beside the id
pool; block tables map (request, page index) -> page id.

The reference updates every leaf functionally. Here the small integer
leaves (tables, lengths, flags, refcounts, the pool) are rebuilt the same
way, but the K/V pools ([layers, pages, page, Hkv, Dh], gigabytes at full
width) are written in place (`write_prefill`, `write_decode_token`,
`serving.paged_decode`): the functions return the same pool tensors.
Lanes the reference drops (`mode="drop"`) are filtered out before the
write, never pointed at an out-of-range page.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.bits import dup_in_run
from repro_torch.core.blockpool import (BlockPool, blockpool_init,
                                        pool_alloc, pool_free)
from repro_torch.core.layout import add_drop, resolve_device, scatter_drop
from repro_torch.models.common import dtype_of


class PagedKV(NamedTuple):
    pool: BlockPool
    k: torch.Tensor             # [layers, N_pages, page, Hkv, Dh]
    v: torch.Tensor
    block_tables: torch.Tensor  # [max_reqs, max_pages] int32, -1 empty
    lengths: torch.Tensor       # [max_reqs] int32 tokens written
    active: torch.Tensor        # [max_reqs] bool
    refcount: torch.Tensor      # [N_pages] int32; shared pages hold > 1

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def max_pages_per_req(self) -> int:
        return self.block_tables.shape[1]


def paged_kv_init(cfg, *, num_pages: int, page_size: int, max_reqs: int,
                  max_pages_per_req: int, device="cuda") -> PagedKV:
    dev = resolve_device(device)
    shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    ct = dtype_of(cfg.compute_dtype)
    i32 = dict(dtype=torch.int32, device=dev)
    return PagedKV(
        pool=blockpool_init(num_pages, device=dev),
        k=torch.zeros(shape, dtype=ct, device=dev),
        v=torch.zeros(shape, dtype=ct, device=dev),
        block_tables=torch.full((max_reqs, max_pages_per_req), -1, **i32),
        lengths=torch.zeros(max_reqs, **i32),
        active=torch.zeros(max_reqs, dtype=torch.bool, device=dev),
        refcount=torch.zeros(num_pages, **i32),
    )


def admit_requests(kv: PagedKV, slots: torch.Tensor,
                   prompt_lens: torch.Tensor, mask: torch.Tensor,
                   shared_pages: torch.Tensor | None = None,
                   n_shared: torch.Tensor | None = None):
    """Allocate pages for admitted prompts. slots: [K] request slots;
    prompt_lens: [K]. Returns (kv', ok[K]); ok is False when the pool is
    exhausted (the lane's partial allocation is given back).

    Prefix sharing: `shared_pages` [K, mp] (-1 pad) + `n_shared` [K] give
    already-resident pages covering each prompt's leading full pages; their
    refcount bumps (+1) and only the remainder is allocated."""
    page = kv.page_size
    mp = kv.max_pages_per_req
    k_lanes = slots.shape[0]
    dev = slots.device
    n_rows, n_pages = kv.block_tables.shape[0], kv.refcount.shape[0]
    if shared_pages is None:
        shared_pages = torch.full((k_lanes, mp), -1, dtype=torch.int32,
                                  device=dev)
        n_shared = torch.zeros(k_lanes, dtype=torch.int32, device=dev)
    total_need = torch.where(mask, -(-prompt_lens // page), 0)
    need = torch.clamp(total_need - n_shared, min=0)
    # (request, page index) wants: new pages sit at n_shared..total_need
    pos = torch.arange(mp, device=dev)[None, :]
    want_new = ((pos >= n_shared[:, None]) & (pos < total_need[:, None])
                & mask[:, None])
    pool, ids, _handles, got = pool_alloc(kv.pool, want_new.reshape(-1))
    ids = ids.reshape(k_lanes, mp)
    got = got.reshape(k_lanes, mp)
    ok = mask & (got.sum(1) == need)
    # roll back lanes that got only part of their pages
    give_back = got & ~ok[:, None]
    pool = pool_free(pool, ids.reshape(-1), give_back.reshape(-1))
    # table rows: the shared prefix, then the new pages
    is_shared = pos < n_shared[:, None]
    table_row = torch.where(is_shared, shared_pages,
                            torch.where(got, ids, -1))
    table_row = torch.where((pos < total_need[:, None]) & ok[:, None],
                            table_row, -1).to(torch.int32)
    rows = torch.where(ok, slots, n_rows)
    bt = scatter_drop(kv.block_tables, rows, table_row)
    lengths = scatter_drop(kv.lengths, rows,
                           torch.where(ok, prompt_lens, 0).to(torch.int32))
    active = scatter_drop(kv.active, rows, ok)
    # refcounts: new pages -> 1; shared pages -> +1
    new_idx = torch.where(got & ok[:, None], ids, n_pages)
    refcount = scatter_drop(kv.refcount, new_idx.reshape(-1), 1)
    sh_idx = torch.where(is_shared & ok[:, None] & (shared_pages >= 0),
                         shared_pages, n_pages)
    refcount = add_drop(refcount, sh_idx.reshape(-1), 1)
    return kv._replace(pool=pool, block_tables=bt, lengths=lengths,
                       active=active, refcount=refcount), ok


def grow_for_decode(kv: PagedKV, slots: torch.Tensor, mask: torch.Tensor):
    """One more token per request: a fresh page at page boundaries.
    Returns (kv', ok[K])."""
    page = kv.page_size
    n_rows, mp = kv.block_tables.shape
    n_pages = kv.refcount.shape[0]
    cur = kv.lengths[slots.long()]
    needs_page = mask & (cur % page == 0) & (cur // page < mp)
    pool, ids, _h, got = pool_alloc(kv.pool, needs_page)
    ok = mask & (~needs_page | got)
    take = needs_page & got
    cell = torch.where(take, slots * mp + cur // page, n_rows * mp)
    bt = scatter_drop(kv.block_tables.reshape(-1), cell,
                      ids).reshape(n_rows, mp)
    lengths = add_drop(kv.lengths, torch.where(ok, slots, n_rows), 1)
    refcount = scatter_drop(kv.refcount, torch.where(take, ids, n_pages), 1)
    return kv._replace(pool=pool, block_tables=bt, lengths=lengths,
                       refcount=refcount), ok


def release_requests(kv: PagedKV, slots: torch.Tensor, mask: torch.Tensor):
    """Finish requests: decrement page refcounts; only pages reaching zero
    return to the free ring (recycling + generation bump: a recycled page
    invalidates its prefix-cache entries through the ABA check)."""
    n_rows = kv.block_tables.shape[0]
    npg = kv.refcount.shape[0]
    rows = kv.block_tables[slots.long()]                     # [K, mp]
    held = mask[:, None] & (rows >= 0)
    refcount = add_drop(kv.refcount,
                        torch.where(held, rows, npg).reshape(-1), -1)
    # free each page ONCE even if several finishing requests shared it:
    # sort the flat page list, keep the first held occurrence
    flat = torch.where(held, rows, npg).reshape(-1)
    heldf = held.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sf = flat[order]
    same = torch.cat([torch.zeros(1, dtype=torch.bool, device=sf.device),
                      sf[1:] == sf[:-1]])
    dup = dup_in_run(same, heldf[order])
    first = heldf[order] & ~dup & (sf < npg)
    give = first & (refcount[torch.clamp(sf, 0, npg - 1).long()] <= 0)
    pool = pool_free(kv.pool, sf, give)
    r = torch.where(mask, slots, n_rows)
    bt = scatter_drop(kv.block_tables, r, -1)
    lengths = scatter_drop(kv.lengths, r, 0)
    active = scatter_drop(kv.active, r, False)
    return kv._replace(pool=pool, block_tables=bt, lengths=lengths,
                       active=active, refcount=refcount)


def write_prefill(kv: PagedKV, slot: int, layer_k: torch.Tensor,
                  layer_v: torch.Tensor, start_page: int = 0) -> PagedKV:
    """Write a prefilled request's KV ([L, S, Hkv, Dh]) into its pages from
    `start_page` on (prefix-shared pages before it are read-only), in
    place, cast to the pools' dtype."""
    page = kv.page_size
    n_layers, s = layer_k.shape[:2]
    npages = -(-s // page)
    pad = npages * page - s
    kpag = F.pad(layer_k, (0, 0, 0, 0, 0, pad)).reshape(
        n_layers, npages, page, *layer_k.shape[2:])
    vpag = F.pad(layer_v, (0, 0, 0, 0, 0, pad)).reshape(
        n_layers, npages, page, *layer_v.shape[2:])
    # the reference's dynamic_slice clamps the start so the slice fits
    start = min(max(start_page, 0), kv.max_pages_per_req - npages)
    ids = kv.block_tables[slot, start:start + npages]
    keep = ids >= 0
    kv.k[:, ids[keep].long()] = kpag[:, keep].to(kv.k.dtype)
    kv.v[:, ids[keep].long()] = vpag[:, keep].to(kv.v.dtype)
    return kv


def decode_write_lanes(kv: PagedKV, slots: torch.Tensor, mask: torch.Tensor):
    """Where each lane's newest token goes, after `grow_for_decode`: (lanes
    that write [W] int64, their page ids [W], their offsets [W]). Masked
    lanes and lanes without a page are left out."""
    page = kv.page_size
    pos = torch.clamp(kv.lengths[slots.long()] - 1, min=0)
    pid = kv.block_tables[slots.long(), pos // page]
    lane = torch.nonzero(mask & (pid >= 0)).squeeze(1)
    return lane, pid[lane].long(), (pos % page)[lane].long()


def write_decode_token(kv: PagedKV, slots: torch.Tensor,
                       layer_k: torch.Tensor, layer_v: torch.Tensor,
                       mask: torch.Tensor) -> PagedKV:
    """Append one token's K/V per request, in place. layer_k: [L, K, Hkv,
    Dh]; call AFTER grow_for_decode (lengths include the new token)."""
    lane, pid, off = decode_write_lanes(kv, slots, mask)
    kv.k[:, pid, off] = layer_k[:, lane].to(kv.k.dtype)
    kv.v[:, pid, off] = layer_v[:, lane].to(kv.v.dtype)
    return kv


def live_pages(kv: PagedKV) -> torch.Tensor:
    return (kv.block_tables >= 0).sum()
