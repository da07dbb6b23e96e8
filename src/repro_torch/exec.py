"""The exec-mode switch of the whole port: which form a kernelized
operation takes.

  torch  the plain PyTorch versions (CPU or CUDA tensors)
  gpu    the hand-written CUDA kernels, the default; CPU tensors raise

The mode is a `ContextVar`: `exec_mode(...)` scopes it to a block and it
does not cross into a new thread (code run in another thread takes what
it needs, such as its device, as an argument). `store.exec` keeps the
store's dispatch layer and re-exports this switch; the models and the
serving layer read it here.
"""
from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar

import torch

MODES = ("torch", "gpu")


def _check(mode: str) -> str:
    if mode not in MODES:
        raise ValueError(f"unknown store exec mode {mode!r}; one of {MODES}")
    return mode


_MODE: ContextVar[str] = ContextVar("repro_torch_exec_mode", default="gpu")


def set_mode(mode: str) -> None:
    _MODE.set(_check(mode))


def get_mode() -> str:
    """The current mode (the `exec_mode` override, else "gpu")."""
    return _MODE.get()


@contextmanager
def exec_mode(mode: str | None):
    """Scoped mode override (None keeps the current mode)."""
    token = _MODE.set(_check(mode)) if mode is not None else None
    try:
        yield
    finally:
        if token is not None:
            _MODE.reset(token)


def resolve(mode: str | None) -> str:
    """`mode` checked, or the current mode when it is None."""
    return _check(mode) if mode is not None else _MODE.get()


def gpu_tensors(name: str, *tensors) -> None:
    """gpu mode runs CUDA kernels: refuse CPU tensors."""
    for t in tensors:
        if torch.is_tensor(t) and not t.is_cuda:
            raise RuntimeError(f"exec mode 'gpu' ({name}) needs CUDA tensors; "
                               f"use exec mode 'torch' on the CPU")


def no_autograd(kernel: str, *tensors) -> None:
    """A forward-only kernel (flash_attention) refuses inputs that
    autograd tracks: it has no backward, and the reference has none
    either (it trains through its plain path), so nothing may switch to
    the plain version quietly."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in tensors):
        raise forward_only(kernel)


def forward_only(kernel: str) -> NotImplementedError:
    """The refusal of a forward-only kernel under autograd."""
    return NotImplementedError(
        f"the {kernel} CUDA kernel is forward-only: exec mode 'gpu' does "
        f"not differentiate through it. Train through the reference's "
        f"plain path instead: attn_impl='xla', or exec mode 'torch'")
