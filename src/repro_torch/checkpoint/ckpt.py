"""Checkpointing: atomic, elastic, dependency-free (counterpart of
`repro.checkpoint.ckpt`).

Layout: <dir>/step_<N>/ with one .npy per leaf, keyed by its path in the
tree, and manifest.json (step, the leaves' paths, files, shapes and
dtypes, user metadata). A tree is nested dicts, tuples and lists with
tensor (or numpy, or Python number) leaves; an `nn.Module` in it
contributes its parameters under their names, the dots of a name as path
separators. bfloat16 leaves are written as float32 (exact) with their
dtype in the manifest. Writes go to a `.tmp` directory and commit with
`os.replace`, so a crash mid-save never corrupts the latest checkpoint.

`restore` loads onto a target `device` (the reference's load-time
`device_put` onto new shardings): a checkpoint written on one device
restores onto any other. An async variant overlaps the host write with
the next steps.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
from torch import nn


def _items(tree, prefix=""):
    """(path, leaf) pairs in the tree's order."""
    if isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield prefix + name.replace(".", "/"), p
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, f"{prefix}{k}/")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _items(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _host(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu", copy=True)    # never a view of it
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def _dtype_name(leaf) -> str:
    if torch.is_tensor(leaf):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


class Snapshot(dict):
    """path -> (host array, dtype name) of a tree: a copy that later
    updates of the tree do not change."""


def snapshot(tree) -> Snapshot:
    return Snapshot((k, (_host(v), _dtype_name(v))) for k, v in _items(tree))


def save(ckpt_dir: str, step: int, tree, meta: dict | None = None):
    """Atomic synchronous save of a tree (or of a `snapshot`). Returns
    the committed directory."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    flat = tree if isinstance(tree, Snapshot) else snapshot(tree)
    manifest = {"step": step, "leaves": {}, "meta": meta or {}}
    for key, (arr, dtype) in flat.items():
        fn = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"][key] = {"file": fn, "shape": list(arr.shape),
                                   "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                      # the atomic commit point
    return final


class AsyncSaver:
    """Overlap the host-side write with compute (one save in flight)."""

    def __init__(self):
        self._t = None

    def save(self, ckpt_dir, step, tree, meta=None):
        self.wait()
        host = snapshot(tree)        # on the host before the next update
        self._t = threading.Thread(target=save,
                                   args=(ckpt_dir, step, host, meta))
        self._t.start()

    def wait(self):
        if self._t is not None:
            self._t.join()
            self._t = None


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like_tree, device=None):
    """Restore into the structure of `like_tree`, each leaf in its
    `like_tree` dtype on `device` (None: where the `like_tree` leaf
    lives). An `nn.Module` is filled in place (its parameters keep their
    identity and `requires_grad`; `Weights` compute copies are dropped).
    Returns (tree, meta)."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)

    def load(key, like):
        info = manifest["leaves"][key]
        arr = np.load(os.path.join(d, info["file"]))
        dev = device if device is not None else (
            like.device if torch.is_tensor(like) else "cpu")
        dtype = like.dtype if torch.is_tensor(like) else None
        return torch.as_tensor(arr).to(device=dev, dtype=dtype)

    def rebuild(like, prefix):
        if isinstance(like, nn.Module):
            with torch.no_grad():
                for name, p in like.named_parameters():
                    p.data = load(prefix + name.replace(".", "/"), p)
            for mod in like.modules():     # stale `Weights` copies
                if hasattr(mod, "_compute"):
                    mod._compute = {}
            return like
        if isinstance(like, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in like.items()}
        if isinstance(like, (tuple, list)):
            return type(like)(rebuild(v, f"{prefix}{i}/")
                              for i, v in enumerate(like))
        return load(prefix[:-1], like)

    return rebuild(like_tree, ""), manifest["meta"]
