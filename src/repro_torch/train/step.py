"""Train and serve step builders (counterpart of `repro.train.step`).

train_step:
  * microbatch gradient accumulation in f32, in order, then x 1/n
  * remat per layer (the model's `cfg.remat`)
  * AdamW with global-norm clipping on the warmup + cosine schedule
  * optionally (`pod_compress`) the int8 error-feedback gradient exchange
    over the pod axis of a `core.routing.ShardMesh` (`optim.compress`)

Parameters are the model's `nn.Module`, trainable (`make_trainable`);
a step updates them and the optimizer state in place and returns them.
"""
from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.models.blocks import block_kinds
from repro_torch.optim import compress
from repro_torch.optim.adamw import adamw_update
from repro_torch.optim.schedule import cosine_with_warmup

AUX_WEIGHT = 0.01


def loss_fn(params, cfg, batch):
    """(loss + AUX_WEIGHT * aux, (loss, aux)) of one batch; a frontend's
    `prefix_embeds` go before the tokens."""
    logits, aux = M.forward(params, cfg, batch["tokens"],
                            prefix_embeds=batch.get("prefix_embeds"))
    loss = M.cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
    return loss + AUX_WEIGHT * aux, (loss, aux)


def _split_micro(batch, n: int) -> list[dict]:
    return [{k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
             for k, v in batch.items()} for i in range(n)]


def grads_of(params, cfg, batch, microbatches: int = 1):
    """(grads, loss, aux) over `microbatches` equal slices of the batch,
    in order: each slice's gradients summed into the parameters' `.grad`
    (f32, the dtype of every ported config's parameters), then scaled by
    1/n. `grads` maps each parameter's name to its `.grad`."""
    named = dict(params.named_parameters())
    for p in named.values():
        p.grad = None
    loss_acc = aux_acc = 0.0
    for mb in (_split_micro(batch, microbatches) if microbatches > 1
               else [batch]):
        total, (loss, aux) = loss_fn(params, cfg, mb)
        total.backward()            # .grad accumulates: acc + g, in order
        loss_acc = loss_acc + loss.detach()
        aux_acc = aux_acc + aux.detach()
    grads = {name: p.grad for name, p in named.items()}
    if microbatches > 1:
        inv = 1.0 / microbatches
        torch._foreach_mul_(list(grads.values()), inv)
        return grads, loss_acc * inv, aux_acc * inv
    return grads, loss_acc, aux_acc


def make_train_step(cfg, *, lr_peak=3e-4, warmup=100, total_steps=10000,
                    microbatches: int = 1, pod_compress: bool = False,
                    mesh=None, pod_axis: str = "pod"):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), the first two updated in place.

    With `pod_compress`, `mesh` is a `ShardMesh` with the axis `pod_axis`
    of P pods. The batch splits along dim 0 into P pod-local slices in
    pod order (the reference's `P(pod_axis)` batch spec); each pod's
    gradients come from `grads_of` on its slice, one pod at a time, and
    leave it only as the int8 payload of `compress.pod_allreduce_compressed`
    (one scale a leaf of the reference's tree, `compress.stacked_leaves`);
    the exchanged mean over pods feeds AdamW, loss and aux are the pods'
    mean, and `opt_state["residuals"]` (`compress.compress_state_init(
    params, P)`) carries each pod's error."""
    if pod_compress:
        if mesh is None or pod_axis not in mesh.axis_names:
            raise ValueError(f"pod_compress needs a mesh with the axis "
                             f"{pod_axis!r}; got {mesh}")
        n_pods = mesh.shape[pod_axis]

    def pod_grads(params, residuals, batch):
        losses, auxes = [], []

        def trees():
            for part in _split_micro(batch, n_pods):
                g, pl, pa = grads_of(params, cfg, part, microbatches)
                losses.append(pl)
                auxes.append(pa)
                yield g
                del g               # before the next pod's backward

        leaves = compress.stacked_leaves(residuals, len(block_kinds(cfg)))
        grads, _ = compress.pod_allreduce_compressed(trees(), residuals, mesh,
                                                     pod_axis, leaves)
        return grads, sum(losses) / n_pods, sum(auxes) / n_pods

    def train_step(params, opt_state, batch):
        if pod_compress:
            grads, loss, aux = pod_grads(params, opt_state["residuals"],
                                         batch)
        else:
            grads, loss, aux = grads_of(params, cfg, batch, microbatches)
        lr = cosine_with_warmup(opt_state["adam"]["step"] + 1,
                                peak_lr=lr_peak, warmup_steps=warmup,
                                total_steps=total_steps)
        params, adam, gn = adamw_update(grads, opt_state["adam"], params, lr)
        for p in params.parameters():
            p.grad = None
        metrics = {"loss": loss, "aux": aux, "grad_norm": gn, "lr": lr}
        return params, {**opt_state, "adam": adam}, metrics

    return train_step


def make_serve_prefill(cfg, cache_len: int):
    def serve_prefill(params, batch):
        with torch.no_grad():
            logits, caches, _ = M.prefill(
                params, cfg, batch["tokens"], cache_len,
                prefix_embeds=batch.get("prefix_embeds"))
        return logits[:, -1], caches
    return serve_prefill


def make_serve_decode(cfg):
    """serve_decode(params, token, pos, caches) -> (logits [B, V], or a
    codebook model's [B, n_cb, V], caches')."""
    def serve_decode(params, token, pos, caches):
        with torch.no_grad():
            logits, caches = M.decode_step(params, cfg, token, pos, caches)
        return logits[:, 0], caches
    return serve_decode
