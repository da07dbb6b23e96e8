"""Parameter containers of the port's models.

A `Weights` module holds one group of the reference's parameter dict
(`params["blocks"][...]["attn"]`, `["ffn"]`, ...) as frozen
`nn.Parameter`s under the same names (`p.wq` is the reference's
`p["wq"]`). The reference casts a matmul weight to the compute
dtype at every use (`cast(p["wq"], ct)`); `Weights.w(name, ct)` gives the
same values, and `load_compute_copy(ct)` makes those casts once, at load,
for the names in `MATMUL`: serving a bf16 model from f32 parameters then
reads 2 bytes a weight per decode step instead of casting 1.7 B
parameters on every step.

A load-time copy is detached and goes stale after an update, so it is
for inference only: `make_trainable()` drops every copy and makes every
parameter require grad, and `w` refuses a copy while grad is enabled for
a parameter that requires it.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.common import cast, dtype_of


class Weights(nn.Module):
    MATMUL: tuple = ()

    def __init__(self, **params):
        super().__init__()
        self._compute: dict[str, torch.Tensor] = {}
        for name, value in params.items():
            if isinstance(value, nn.Module):
                setattr(self, name, value)
            else:
                setattr(self, name, nn.Parameter(value, requires_grad=False))

    def w(self, name: str, compute_dtype: str) -> torch.Tensor:
        """Parameter `name` in the compute dtype (its load-time copy when
        one was made)."""
        c = self._compute.get(name)
        if c is None:
            return cast(getattr(self, name), compute_dtype)
        if torch.is_grad_enabled() and getattr(self, name).requires_grad:
            raise RuntimeError(
                f"{type(self).__name__}.{name}: a load-time compute copy "
                f"is detached from its parameter, so gradients through it "
                f"would be wrong; train after make_trainable(), which drops "
                f"the copies")
        if c.dtype == dtype_of(compute_dtype):
            return c
        return cast(getattr(self, name), compute_dtype)

    def make_trainable(self) -> "Weights":
        """Drop the load-time compute copies of this module and every
        submodule, and make every parameter require grad."""
        for mod in self.modules():
            if isinstance(mod, Weights):
                mod._compute = {}
        for t in self.parameters():
            t.requires_grad_(True)
        return self

    def load_compute_copy(self, compute_dtype: str) -> None:
        """Cast the `MATMUL` parameters of this module and every submodule
        to `compute_dtype` once (a no-op where the dtypes already agree)."""
        for mod in self.modules():
            if not isinstance(mod, Weights):
                continue
            mod._compute = {}
            for name in mod.MATMUL:
                t = getattr(mod, name, None)
                if t is not None and t.dtype != dtype_of(compute_dtype):
                    mod._compute[name] = cast(t.detach(), compute_dtype)
