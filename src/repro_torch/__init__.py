"""repro_torch — the PyTorch/CUDA port of `repro`: the KV store and the
LLM serving engine on it.

The port mirrors the JAX package's layout (`core/`, `store/`, `kernels/`,
`models/`, `serving/`, `configs/`) so each module's counterpart is found
at the same path. It imports torch, numpy and the standard library only:
never jax, and nothing of `repro`.

Keys: every u64 of the reference travels as its int64 bit pattern; the
rules for ordered compares, shifts and the hash live in `core.bits`.

Devices: entry points (`store.engine.StoreEngine`, every backend's
`init`, `serving.engine.Engine`, the serving state's `*_init`) default to
`device="cuda"` and raise when CUDA is missing unless the caller passes
`device="cpu"` explicitly; `models.model.init_params` draws on its
generator's device.
"""

__version__ = "0.1.0"
