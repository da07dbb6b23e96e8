"""Mixture-of-Experts FFN with the paper's routing as the dispatch layer
(counterpart of `repro.models.moe`).

Token -> expert dispatch is the paper's key -> NUMA-owner routing (§I,
§VI): the expert id plays the key's top bits, and experts are the NUMA
domains, sharded over the model axis. Three dispatches:

  * `moe_dense_ffn`: one shard. `core.routing.bucketize` groups the
    (token, choice) lanes by expert into [E, C] buckets, overflow dropped
    in the reference's order; the experts run as one batched matmul; the
    weighted outputs come back to their tokens.
  * `moe_replicated_psum`: tokens replicated over the model axis, each
    shard runs its own experts on every token it sees, the partial outputs
    are summed over the axis (the psum).
  * `moe_routed_a2a`: tokens split over every axis, bucketed by owner
    shard, moved by an all_to_all over the model axis, bucketed again by
    local expert, computed, moved back and combined at the source.

The reference runs the last two inside `shard_map`. Here every shard of a
mesh lives on one device (`core.routing.ShardMesh`): per-shard tensors are
`[dp, tp, ...]` (the data-parallel shards, then the model axis), expert
shard m owns experts [m * E/tp, (m + 1) * E/tp), the all_to_all is the
swap of the model axis with the bucket axis (`_all_to_all`), and the psum
is an f32 sum over the model axis. The experts of every shard run as one
batched matmul over all E experts.

A token's k expert outputs are summed in the compute dtype in the order
the reference's scatter-add meets them (by expert for the one-shard
dispatch, by owner shard for the routed one), so the sum is
deterministic on the card too.

Router: f32 softmax, top-k with ties to the lower expert index (as
`jax.lax.top_k`), optional renormalisation (qwen3), and the Switch
load-balance loss E * sum_e f_e * P_e.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.routing import bucketize
from repro_torch.models.common import dense_init, dtype_of
from repro_torch.models.mlp import init_mlp, mlp
from repro_torch.models.params import Weights


class MoE(Weights):
    """router [D, E], experts wi / wu [E, D, F] and wd [E, F, D], and
    `shared`, an MLP of width d_expert * n_shared_experts, where the config
    has a shared expert. The router stays in f32 at every use."""
    MATMUL = ("wi", "wu", "wd")


def _experts(gen: torch.Generator, shape, fan_in: int, dtype) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return w.mul_(1.0 / math.sqrt(fan_in)).to(dtype_of(dtype))


def init_moe(gen: torch.Generator, cfg) -> MoE:
    """Router N(0,1) * 0.02, experts N(0,1)/sqrt(d_in), drawn in f32 from
    `gen` on its device, as the reference draws them."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_expert
    pd = cfg.param_dtype
    p = dict(router=dense_init(gen, d, e, pd, scale=0.02),
             wi=_experts(gen, (e, d, f), d, pd),
             wu=_experts(gen, (e, d, f), d, pd),
             wd=_experts(gen, (e, f, d), f, pd))
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, d, cfg.d_expert * cfg.n_shared_experts,
                               pd)
    return MoE(**p)


def router_probs(p: MoE, cfg, x: torch.Tensor,
                 live: torch.Tensor | None = None):
    """x: [..., T, D] -> (weights [..., T, k] f32, experts [..., T, k]
    int32, aux [...] f32: the Switch loss over the T axis, or with `live`
    ([..., T] bool) over the live tokens only, 0 where there are none)."""
    logits = x.float() @ p.router.float()
    probs = torch.softmax(logits, dim=-1)
    k = cfg.n_experts_active
    # a stable descending sort keeps equal probabilities in expert order
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[..., :k], idx[..., :k]
    if cfg.norm_topk_prob:
        w = w / torch.sum(w, dim=-1, keepdim=True)
    e = cfg.n_experts
    top1 = F.one_hot(idx[..., 0], e).float()
    if live is None:
        f_e = torch.mean(top1, dim=-2)
        p_e = torch.mean(probs, dim=-2)
    else:
        m = live[..., None].float()
        n = torch.clamp(m.sum(-2), min=1.0)
        f_e = (top1 * m).sum(-2) / n
        p_e = (probs * m).sum(-2) / n
    aux = e * torch.sum(f_e * p_e, dim=-1)
    return w, idx.to(torch.int32), aux


def _expert_ffn(wi, wu, wd, xe: torch.Tensor) -> torch.Tensor:
    """xe: [E, C, D] bucketed tokens -> [E, C, D], weights already in the
    compute dtype."""
    g = torch.bmm(xe, wi)
    u = torch.bmm(xe, wu)
    return torch.bmm(F.silu(g) * u, wd)


def _sharded_experts(p: MoE, cfg, xe: torch.Tensor) -> torch.Tensor:
    """xe: [dp, tp, E/tp, C, D], expert shard m's buckets at [:, m] ->
    the same shape: every shard's experts as one batched FFN over the E
    experts, expert m * E/tp + j taking the C rows of every data shard."""
    dp, tp, el, c, d = xe.shape
    ct = cfg.compute_dtype
    rows = xe.permute(1, 2, 0, 3, 4).reshape(tp * el, dp * c, d)
    ye = _expert_ffn(p.w("wi", ct), p.w("wu", ct), p.w("wd", ct), rows)
    return ye.reshape(tp, el, dp, c, d).permute(2, 0, 1, 3, 4)


def _row_of_lane(lane_b: torch.Tensor, valid: torch.Tensor,
                 n: int) -> torch.Tensor:
    """The inverse of a bucketing: lane_b / valid [..., n_dest, cap] ->
    [..., n], each lane's flat bucket row, or -1 where it holds none
    (dropped, or routed elsewhere)."""
    lead = lane_b.shape[:-2]
    r = lane_b.shape[-2] * lane_b.shape[-1]
    src = torch.arange(r, device=lane_b.device).expand(lead + (r,))
    dst = torch.where(valid, lane_b, n).reshape(lead + (r,)).long()
    inv = torch.full(lead + (n + 1,), -1, dtype=torch.long,
                     device=lane_b.device)
    return inv.scatter_(-1, dst, src)[..., :n]


def _gather_rows(rows: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """rows [..., R, D] at row [..., n] (-1: a zero row) -> [..., n, D]."""
    r, d = rows.shape[-2:]
    flat = torch.cat([rows, rows.new_zeros(rows.shape[:-2] + (1, d))], -2)
    row = torch.where(row < 0, r, row)
    return torch.gather(flat, -2, row[..., None].expand(row.shape + (d,)))


def _sum_lanes(rows: torch.Tensor, row: torch.Tensor, key: torch.Tensor,
               k: int, dtype) -> torch.Tensor:
    """rows: [..., R, D] weighted expert outputs; row: [..., T * k] the row
    of each (token, choice) lane (-1: none); key: [..., T * k]. Each
    token's k rows summed in `dtype`, one at a time, in ascending key
    (ties in choice order) -> [..., T, D]."""
    lead = rows.shape[:-2]
    t = row.shape[-1] // k
    order = torch.argsort(key.reshape(lead + (t, k)), dim=-1, stable=True)
    row = torch.gather(row.reshape(lead + (t, k)), -1, order)
    g = _gather_rows(rows, row.reshape(lead + (t * k,))).reshape(
        lead + (t, k, rows.shape[-1]))
    y = torch.zeros(lead + (t, rows.shape[-1]), dtype=dtype,
                    device=rows.device)
    for j in range(k):
        y = y + g[..., j, :].to(dtype)
    return y


def _owner_of(dest: torch.Tensor, e_local: int) -> torch.Tensor:
    """The expert shard that owns each expert id."""
    return torch.div(dest, e_local, rounding_mode="floor")


def _all_to_all(v: torch.Tensor) -> torch.Tensor:
    """The queue hop over the model axis: [dp, tp, tp, ...] buffers,
    bucket o of shard (d, m) lands as chunk m of shard (d, o)."""
    return v.transpose(1, 2)


def _lanes(idx: torch.Tensor, k: int) -> torch.Tensor:
    return torch.arange(idx.shape[-2] * k, dtype=torch.int32,
                        device=idx.device)


def _dropped(row: torch.Tensor, kept: torch.Tensor, k: int) -> torch.Tensor:
    """Dropped lanes per token: row [..., T * k] each lane's bucket row,
    kept [..., T * k] whether that lane was to be computed here."""
    return (kept & (row == -1)).reshape(row.shape[:-1] + (-1, k)).sum(
        -1, dtype=torch.int32)


def moe_dense_ffn(p: MoE, cfg, x2d: torch.Tensor,
                  return_dropped: bool = False):
    """One-shard dispatch: bucket the (token, choice) lanes by expert into
    [E, C, D], no collectives, the shared expert added. Returns (y2d, aux),
    and with `return_dropped` the dropped lanes of each token ([T] int32)."""
    t, d = x2d.shape
    k, e = cfg.n_experts_active, cfg.n_experts
    w, idx, aux = router_probs(p, cfg, x2d)
    dest = idx.reshape(-1)
    cap = max(1, int(2 * t * k / e) + 8)
    (lane_b, w_b), valid, _ = bucketize(
        dest, torch.ones_like(dest, dtype=torch.bool),
        [_lanes(idx, k), w.reshape(-1)], e, cap)
    xe = torch.where(valid[..., None], x2d[(lane_b // k).long()], 0)
    ye = _sharded_experts(p, cfg, xe[None, None])[0, 0]       # [E, C, D]
    ye = ye * w_b[..., None].to(ye.dtype)
    row = _row_of_lane(lane_b, valid, t * k)
    y = _sum_lanes(ye.reshape(e * cap, d), row, dest, k, x2d.dtype)
    if cfg.n_shared_experts:
        y = y + mlp(p.shared, x2d, cfg.compute_dtype)
    if return_dropped:
        return y, aux, _dropped(row, torch.ones_like(dest, dtype=torch.bool), k)
    return y, aux


def moe_replicated_psum(p: MoE, cfg, x: torch.Tensor,
                        return_dropped: bool = False):
    """Expert parallelism over the model axis with replicated tokens.
    x: [dp, tp, t, D], shard (d, m) holding data shard d's tokens (the same
    for every m). Each shard buckets the lanes routed to its own experts,
    computes them, and the partial outputs are summed in f32 over the
    model axis. Returns (y [dp, tp, t, D] in x's dtype, aux [dp, tp] per
    shard), and with `return_dropped` the dropped lanes of each token
    ([dp, t] int32, over the shards that own its experts). The shared
    expert is not added."""
    dp, tp, t, d = x.shape
    k, e = cfg.n_experts_active, cfg.n_experts
    el = e // tp
    # the router is replicated: every shard of a data shard routes alike
    w, idx, aux = (v.expand((dp, tp) + v.shape[2:])
                   for v in router_probs(p, cfg, x[:, :1]))
    dest = idx.reshape(dp, tp, t * k)
    me = torch.arange(tp, device=x.device)[None, :, None]
    mine = _owner_of(dest, el) == me
    cap = max(1, int(2 * t * k / e) + 8)
    (lane_b, w_b), valid, _ = bucketize(
        dest % el, mine, [_lanes(idx, k).expand(dp, tp, t * k),
                          w.reshape(dp, tp, t * k)], el, cap)
    data = torch.arange(dp, device=x.device).reshape(dp, 1, 1, 1)
    xe = torch.where(valid[..., None], x[:, 0][data, (lane_b // k).long()],
                     0)
    ye = _sharded_experts(p, cfg, xe)                  # [dp, tp, el, C, D]
    ye = ye * w_b[..., None].to(ye.dtype)
    row = _row_of_lane(lane_b, valid, t * k)
    y = _sum_lanes(ye.reshape(dp, tp, el * cap, d), row, dest, k, x.dtype)
    # the psum, in f32 (the reference's combine dtype)
    y = torch.sum(y.float(), dim=1, keepdim=True).to(x.dtype)
    y = y.expand(dp, tp, t, d)
    if return_dropped:
        return y, aux, _dropped(row, mine, k).sum(1, dtype=torch.int32)
    return y, aux


def moe_routed_a2a(p: MoE, cfg, x: torch.Tensor,
                   return_dropped: bool = False, n_valid: int | None = None):
    """The paper's routing. x: [dp, tp, t, D], shard (d, m) holding chunk
    d * tp + m of the tokens. Each shard buckets its lanes by owner shard
    (capacity-bounded, `bucketize`'s order), the all_to_all moves the
    buckets to their owners, which bucket the arrivals by local expert,
    compute them, and send the outputs back; the source sums each token's
    weighted outputs. Both bucketings' capacities scale with
    `cfg.moe_capacity_factor`. Returns (y [dp, tp, t, D] in the compute dtype, aux
    [dp, tp]), and with `return_dropped` the lanes of each token dropped
    at either bucketing ([dp, tp, t] int32). The shared expert is not
    added. With `n_valid`, only the first n_valid tokens of the
    shard-major order are live: the rest are padding, route nowhere and
    leave aux out (a shard's aux is over its live tokens, 0 where it has
    none); the capacities follow the shards' padded row count t."""
    dp, tp, t, d = x.shape
    capacity_factor = cfg.moe_capacity_factor
    k, e = cfg.n_experts_active, cfg.n_experts
    el = e // tp
    ct = dtype_of(cfg.compute_dtype)
    tok_live = None
    if n_valid is not None:
        tok_live = (torch.arange(dp * tp, device=x.device).reshape(dp, tp, 1)
                    * t + torch.arange(t, device=x.device)) < n_valid
    w, idx, aux = router_probs(p, cfg, x, tok_live)
    dest = idx.reshape(dp, tp, t * k)                  # global expert id
    owner = _owner_of(dest, el)
    cap = max(1, int(capacity_factor * t * k / tp) + 8)
    live = (torch.ones_like(owner, dtype=torch.bool) if tok_live is None
            else tok_live.repeat_interleave(k, dim=-1))
    (lane_b, w_b, e_b), valid, _ = bucketize(
        owner, live,
        [_lanes(idx, k).expand(dp, tp, t * k), w.reshape(dp, tp, t * k),
         dest], tp, cap)                               # [dp, tp, tp, cap]
    xs = x.reshape(dp * tp, t, d)
    shard = torch.arange(dp * tp, device=x.device).reshape(dp, tp, 1, 1)
    x_b = torch.where(valid[..., None], xs[shard, (lane_b // k).long()],
                      0).to(ct)
    # out to the owners: [dp, owner, source, cap, ...]
    x_r, e_r, val_r = (_all_to_all(v) for v in (x_b, e_b, valid))
    n_r = tp * cap
    xf = x_r.reshape(dp, tp, n_r, d)
    cap2 = max(1, int(capacity_factor * n_r / max(el, 1)) + 8)
    pos = torch.arange(n_r, dtype=torch.int32, device=x.device)
    (pos_b,), valid2, _ = bucketize(
        (e_r % el).reshape(dp, tp, n_r), val_r.reshape(dp, tp, n_r),
        [pos.expand(dp, tp, n_r)], el, cap2)           # [dp, tp, el, cap2]
    xe = torch.where(valid2[..., None],
                     xf.reshape(dp * tp, n_r, d)[shard, pos_b.long()], 0)
    ye = _sharded_experts(p, cfg, xe).reshape(dp, tp, el * cap2, d)
    at = _row_of_lane(pos_b, valid2, n_r)              # [dp, tp, n_r]
    yf = _gather_rows(ye, at)
    # back to the sources: [dp, source, owner, cap, D]
    y_r = _all_to_all(yf.reshape(dp, tp, tp, cap, d)).reshape(dp, tp, n_r, d)
    y_r = y_r * w_b.reshape(dp, tp, n_r)[..., None].to(y_r.dtype)
    row = _row_of_lane(lane_b, valid, t * k)
    y = _sum_lanes(y_r, row, owner, k, ct)
    if not return_dropped:
        return y, aux
    # a lane sent out is dropped again where its owner's bucket overflowed
    kept2 = _all_to_all((at >= 0).reshape(dp, tp, tp, cap)).reshape(
        dp, tp, n_r)
    kept = (row >= 0) & torch.gather(kept2, 2, row.clamp(min=0))
    return y, aux, _dropped(torch.where(kept, row, -1),
                            torch.ones_like(kept), k)
