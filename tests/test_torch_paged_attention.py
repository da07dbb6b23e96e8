"""The paged decode attention of the port against the JAX reference.

The port's plain version (`kernels.paged_attention.ref`) and its kernel
wrapper on CPU tensors (which runs the plain version) against the
reference's jnp oracle `paged_attention_ref` and its Pallas kernel
`paged_attention` in interpret mode, on the three shapes x {f32, bf16} of
tests/test_kernels.py and at the reduced configs' heads (D 16, G 2), each with a -1 page in the middle of a table and a
length that ends mid-page. Tolerances are tests/test_kernels.py's: 5e-6
for f32 (the same f32 products summed in another order), 3e-2 for bf16
(outputs in bf16, one step is 2^-8 of the value). The CUDA kernel itself
runs only on the card (chip_smoke.py holds it against the plain version
at the served shapes and at every G it is built for); here the `gpu` exec
mode must refuse CPU tensors, and the launch checks, which run without a
card, must refuse a G the kernel is not built for.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro  # noqa: F401  (enables x64)
from repro.kernels.paged_attention.ops import paged_attention as j_pa
from repro.kernels.paged_attention.ref import paged_attention_ref as j_ref
from repro_torch.kernels import cuda
from repro_torch.kernels.paged_attention.kernel import (
    GROUPS, check_launch, paged_attention_grouped, split_pages)
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

SHAPES = [dict(B=2, H=4, HKV=2, D=64, PAGE=16, NP=16, P=4),
          dict(B=4, H=8, HKV=8, D=64, PAGE=32, NP=32, P=4),
          dict(B=1, H=8, HKV=1, D=128, PAGE=16, NP=8, P=3),
          dict(B=3, H=4, HKV=2, D=16, PAGE=8, NP=16, P=4)]
DTYPES = {"float32": (jnp.float32, torch.float32, 5e-6),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}

J_REF = jax.jit(j_ref)


@functools.lru_cache(maxsize=None)
def _inputs(idx: int, dtype: str):
    """Seeded inputs in both frameworks: a -1 page in the middle of the
    longest table (its later pages stay), one length ending mid-page."""
    c = SHAPES[idx]
    b, h, hkv, d = c["B"], c["H"], c["HKV"], c["D"]
    page, n_pages, p = c["PAGE"], c["NP"], c["P"]
    rng = np.random.default_rng(3 + idx)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((n_pages, page, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, hkv, d)).astype(np.float32)
    lengths = rng.integers(1, page * p, b).astype(np.int32)
    lengths[0] = page * (p - 1) + 3          # ends mid-page, >= 3 pages
    tables = np.full((b, p), -1, np.int32)
    ids = rng.permutation(n_pages)
    used = 0
    for r in range(b):
        need = -(-int(lengths[r]) // page)
        tables[r, :need] = ids[used:used + need] if used + need <= n_pages \
            else ids[:need]
        used += need
    tables[0, 1] = -1                        # a hole in the middle
    jt, tt = DTYPES[dtype][:2]
    jin = (jnp.asarray(q, jt), jnp.asarray(kp, jt), jnp.asarray(vp, jt),
           jnp.asarray(tables), jnp.asarray(lengths))
    tin = (torch.from_numpy(q).to(tt), torch.from_numpy(kp).to(tt),
           torch.from_numpy(vp).to(tt), torch.from_numpy(tables),
           torch.from_numpy(lengths))
    return jin, tin


def _f32(x):
    return (x.detach().float().numpy() if torch.is_tensor(x)
            else np.asarray(x, np.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("idx", range(len(SHAPES)))
def test_plain_version_matches_reference_oracle(idx, dtype):
    jin, tin = _inputs(idx, dtype)
    tol = DTYPES[dtype][2]
    got = paged_attention_ref(*tin)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), _f32(J_REF(*jin)), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("idx", range(len(SHAPES)))
def test_plain_version_matches_reference_kernel(idx, dtype):
    """Against the Pallas kernel (interpret mode, D padded to 128)."""
    jin, tin = _inputs(idx, dtype)
    tol = DTYPES[dtype][2]
    ref = _f32(j_pa(*jin, interpret=True))
    np.testing.assert_allclose(_f32(paged_attention_ref(*tin)), ref,
                               atol=tol, rtol=tol)
    # the wrapper on CPU tensors: the plain version, in q's dtype
    out = paged_attention(*tin)
    assert out.dtype == tin[0].dtype and out.shape == tin[0].shape
    np.testing.assert_allclose(_f32(out), ref, atol=tol, rtol=tol)


def test_grouped_wrapper_and_scale():
    (_, _, _, _, _), (q, kp, vp, tables, lengths) = _inputs(0, "float32")
    b, h, d = q.shape
    hkv = kp.shape[2]
    qg = q.reshape(b, hkv, h // hkv, d)
    out = paged_attention_grouped(qg, kp, vp, tables, lengths)
    assert out.shape == qg.shape
    assert torch.allclose(out.reshape(b, h, d),
                          paged_attention_ref(q, kp, vp, tables, lengths),
                          atol=1e-6)
    # an explicit scale multiplies the scores (the reference passes the
    # true D's rsqrt when it pads D)
    half = paged_attention_grouped(qg, kp, vp, tables, lengths,
                                   scale=0.5 / d ** 0.5)
    assert torch.allclose(half, paged_attention_grouped(
        qg * 0.5, kp, vp, tables, lengths), atol=1e-6)


def test_length_zero_row_is_nan_in_the_plain_version():
    """The reference's oracle gives NaN for a request with no token (the
    kernel gives zeros): serving compares active lanes only."""
    (_, _, _, _, _), (q, kp, vp, tables, lengths) = _inputs(0, "float32")
    lengths = lengths.clone()
    lengths[1] = 0
    out = paged_attention_ref(q, kp, vp, tables, lengths)
    assert torch.isnan(out[1]).all() and torch.isfinite(out[0]).all()


def test_launcher_is_registered():
    assert "paged_attention" in cuda.KERNELS
    assert "paged_attention" in cuda.LAUNCHES
    assert cuda._SIGNATURES["paged_attention_launch"][-2] is cuda._F


def test_kernel_groups_and_launch_checks():
    """The kernel is built for the GQA groups of the reference's configs;
    the launch checks (the path a CUDA call takes before the launch, here
    on CPU tensors) pass those and refuse any other G, and a D or a page
    the kernel does not take."""
    assert GROUPS == (1, 2, 4, 5, 8, 16)
    (_, _, _, _, _), (q, kp, vp, tables, lengths) = _inputs(0, "float32")
    b, h, d = q.shape
    hkv = kp.shape[2]
    for g in GROUPS:
        qg = torch.zeros((b, hkv, g, d))
        check_launch(qg, kp, vp, tables, lengths)
    for g in (3, 6, 32):
        with pytest.raises(ValueError, match=f"G={g} query heads"):
            check_launch(torch.zeros((b, hkv, g, d)), kp, vp, tables,
                         lengths)
    for dd in (16, 32):                 # the reduced configs' heads, too
        check_launch(torch.zeros((b, hkv, 2, dd)), kp[..., :dd],
                     vp[..., :dd], tables, lengths)
    for dd in (8, 48):
        with pytest.raises(ValueError, match=f"D={dd}"):
            check_launch(torch.zeros((b, hkv, 2, dd)), kp[..., :dd],
                         vp[..., :dd], tables, lengths)
    big = torch.zeros((2, 64, hkv, d))
    with pytest.raises(ValueError, match="page 1..32"):
        check_launch(q.reshape(b, hkv, h // hkv, d), big, big, tables,
                     lengths)


@pytest.mark.parametrize("b,hkv,p,want", [(32, 8, 128, 16), (1, 8, 128, 4),
                                          (4, 2, 8, 4), (2, 2, 3, 3)])
def test_split_pages(b, hkv, p, want):
    """Table entries a split owns: the served batch (32 requests x 8 KV
    heads, 128-entry tables) runs 8 splits of 16, a lone request splits
    into 32 of 4; never more entries than the table holds."""
    assert split_pages(b, hkv, p) == want
    assert -(-p // want) * want >= p
