"""The flash attention of the port against the JAX reference.

1. The op's contract (f32 arithmetic): the port's plain version
   `flash_attention_ref` and the op `ops.flash_attention` on CPU tensors
   (which runs it) against the reference's oracle, at the MHA sweep, the
   GQA groups and the non-causal case of tests/test_kernels.py with that
   file's tolerances (5e-6 f32, 2e-2 bf16); and against the Pallas kernel
   in interpret mode at one small shape.
2. The model path: `attend_causal(impl="xla_flash")` in exec mode `torch`
   (the plain mirror of `_attend_flash_xla`) against the reference's
   within 1e-5: the same bf16 rounding points and f32 sums, only their
   order differs. Cases: a binding window, q_offset > 0, G = 5 with
   D = 64 (hymba's heads), several q and kv tiles. The kernel wrapper on
   CPU tensors (the mirror at the kernel's `TILE`-key tiles) against the
   reference at `TILE`-row tiles, within 1e-5 too; and the mirror on f32
   inputs equal bit for bit to the mirror on their bf16 casts (the
   wrapper's rounding of f32 inputs before the kernel).
3. A ragged S (the reference asserts a multiple of the tile) against the
   unchunked `softmax_attend`, within 2e-2: the two round the softmax
   weights to bf16 at other points (p before normalising, w after).

The CUDA kernel runs only on the card (chip_smoke.py); here exec mode
`gpu` must refuse CPU tensors.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro  # noqa: F401  (enables x64)
from repro.kernels.flash_attention.ops import flash_attention as j_pallas
from repro.kernels.flash_attention.ref import flash_attention_ref as j_ref
from repro.models import common as jcommon
from repro_torch.kernels import cuda
from repro_torch.kernels.flash_attention.kernel import (TILE,
                                                        flash_attention_fused)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (attend_flash_ref,
                                                     flash_attention_ref)
from repro_torch.models import common as tcommon
from repro_torch.store import exec as exec_

DTYPES = {"float32": (jnp.float32, torch.float32, 5e-6),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
PLAIN = {"ref": flash_attention_ref, "op": flash_attention}


def _qkv(seed, b, sq, sk, h, hkv, d, jt=jnp.float32, tt=torch.float32):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d))]
    return ([jnp.asarray(a, jt) for a in arrs],
            [torch.from_numpy(a).to(tt) for a in arrs])


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@functools.lru_cache(maxsize=None)
def _j_ref(causal):
    return jax.jit(functools.partial(j_ref, causal=causal))


@pytest.mark.parametrize("form", list(PLAIN))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(1, 128, 4, 64), (2, 256, 8, 64),
                                   (1, 256, 4, 128), (2, 128, 2, 32)])
def test_op_mha_sweep(shape, dtype, form):
    b, s, h, d = shape
    jt, tt, tol = DTYPES[dtype]
    jin, tin = _qkv(0, b, s, s, h, h, d, jt, tt)
    out = PLAIN[form](*tin)
    if form == "op":
        assert out.dtype == tt
    _close(out, _j_ref(True)(*jin), tol)


@pytest.mark.parametrize("form", list(PLAIN))
@pytest.mark.parametrize("hkv", [1, 2, 4])
def test_op_gqa_groups(hkv, form):
    jin, tin = _qkv(1, 2, 128, 128, 8, hkv, 64)
    _close(PLAIN[form](*tin), _j_ref(True)(*jin), 5e-6)


@pytest.mark.parametrize("form", list(PLAIN))
def test_op_noncausal(form):
    jin, tin = _qkv(2, 1, 128, 128, 2, 2, 64)
    _close(PLAIN[form](*tin, causal=False), _j_ref(False)(*jin), 5e-6)


def test_op_against_pallas_interpret():
    jin, tin = _qkv(3, 1, 128, 128, 4, 2, 64)
    _close(flash_attention(*tin), j_pallas(*jin, block_q=64, block_k=64),
           5e-6)


# (batch, sq, sk, heads, kv heads, D, window, q_offset, tile)
FLASH_CASES = {
    "window": (2, 32, 32, 4, 2, 16, 5, 0, 8),
    "q_offset": (2, 16, 24, 4, 2, 16, 0, 8, 8),
    "g5_d64": (1, 32, 32, 10, 2, 64, 0, 0, 16),
    "multi_tile": (1, 48, 48, 4, 1, 16, 12, 0, 16),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_attend_xla_flash_matches_reference(case):
    b, sq, sk, h, hkv, d, window, off, tile = FLASH_CASES[case]
    jin, tin = _qkv(4, b, sq, sk, h, hkv, d)
    want = jcommon.attend_causal(*jin, window, "float32", block_q=tile,
                                 impl="xla_flash", q_offset=off)
    with exec_.exec_mode("torch"):
        got = tcommon.attend_causal(*tin, window, "float32", block_q=tile,
                                    impl="xla_flash", q_offset=off)
    assert got.dtype == torch.float32
    _close(got, want, 1e-5)


def test_kernel_wrapper_on_cpu_mirrors_the_kernel_tiles():
    """The wrapper's CPU form is the mirror at the kernel's `TILE`-key
    tiles: the reference at `TILE`-row tiles, windowed, with an offset."""
    jin, tin = _qkv(5, 1, 128, 192, 4, 2, 64)
    want = jcommon.attend_causal(*jin, 40, "float32", block_q=TILE,
                                 impl="xla_flash", q_offset=64)
    got = flash_attention_fused(*tin, q_offset=64, window=40,
                                out_dtype=torch.float32)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_f32_inputs_rounded_to_bf16_first_change_nothing(out_dtype):
    """The wrapper rounds f32 q, k, v to bf16 before the xla_flash kernel:
    the mirror at `TILE` gives the same bits on the f32 tensors, on their
    bf16 casts and on those casts back in f32 (it rounds them to bf16
    with the same round to nearest even first), windowed, with an offset
    and ragged tiles."""
    _, (q, k, v) = _qkv(8, 2, 100, 229, 10, 2, 64)
    want = attend_flash_ref(q, k, v, 37, out_dtype, TILE, 129)
    bf = torch.bfloat16
    for cast in (lambda t: t.to(bf), lambda t: t.to(bf).float()):
        got = attend_flash_ref(cast(q), cast(k), cast(v), 37, out_dtype,
                               TILE, 129)
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_ragged_xla_flash_matches_softmax_attend():
    _, (q, k, v) = _qkv(6, 1, 13, 13, 4, 2, 16)
    with exec_.exec_mode("torch"):
        flash = tcommon.attend_causal(q, k, v, 3, "float32", block_q=5,
                                      impl="xla_flash")
    mask = tcommon.causal_mask(13, 13, window=3)
    _close(flash, tcommon.softmax_attend(q, k, v, mask, "float32").numpy(),
           2e-2)


def test_gpu_mode_refuses_cpu_tensors():
    _, (q, k, v) = _qkv(7, 1, 8, 8, 2, 2, 16)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        tcommon.attend_causal(q, k, v, impl="xla_flash")
    with pytest.raises(ValueError, match="impl"):
        tcommon.attend_causal(q, k, v, impl="pallas")


def test_launcher_is_registered():
    assert "flash_attention" in cuda.KERNELS
    assert "flash_attention" in cuda.LAUNCHES
    assert cuda._SIGNATURES["flash_attention_launch"][-2] is cuda._F
