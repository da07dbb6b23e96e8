"""The port's hierarchical routing (`repro_torch.core.routing`) against the
JAX reference, exactly (tolerance 0), on the CPU.

* `owner_of`, `bucketize` and `_compact` in-process against the
  reference's functions (they need no mesh): ties, invalid lanes,
  capacity overflow, the top-bit boundaries of `owner_of`;
* `route_to_owners` and `route_back` against the reference inside
  `shard_map` on a (2, 4) ("pod", "data") mesh of 8 fake CPU devices, run
  in one subprocess (the device count is fixed when JAX starts) whose
  results come back as an `.npz`: every shard's pool (keys, vals, aux,
  origin, valid), its `dropped`, and the routed-back results, for skewed
  keys at pool_factor 1 (drops), uniform keys with idle lanes at 2, and
  one lone shard's plan at 1. The port's pools follow the reference's
  stage order, not global lane order.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import repro  # noqa: F401  (enables x64)
from repro.core import routing as JR
from repro_torch.core import routing as TR
from repro_torch.core.bits import from_u64

ROOT = Path(__file__).resolve().parents[1]
AXES = ("pod", "data")
SIZES = (2, 4)
S = 8
LANES = 16

# name -> (pool_factor, seed, skew, idle): skew = share of lanes whose key
# lands on shard 5, the rest uniform over u64; idle = share of idle lanes
CASES = {
    "skewed_pf1": (1, 3, 0.6, 0.0),
    "uniform_pf2": (2, 4, 0.0, 0.25),
    "one_sender_pf1": (1, 5, 0.0, 0.0),
}


def case_inputs(name):
    """[S, LANES] keys (uint64), vals (uint64), aux (int32), valid (bool)."""
    pf, seed, skew, idle = CASES[name]
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**64, (S, LANES), dtype=np.uint64)
    hot = rng.random((S, LANES)) < skew
    keys[hot] = (np.uint64(5) << np.uint64(61)) | (
        keys[hot] >> np.uint64(3))
    vals = rng.integers(0, 2**64, (S, LANES), dtype=np.uint64)
    aux = rng.integers(-1, 3, (S, LANES)).astype(np.int32)
    valid = rng.random((S, LANES)) >= idle
    if name == "one_sender_pf1":
        valid[1:] = False                   # only shard 0 sends
    return keys, vals, aux, valid


PROG = textwrap.dedent('''
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    import repro
    from repro.core.routing import mesh_shard_map, route_back, route_to_owners

    AXES, SIZES, S, LANES = ("pod", "data"), (2, 4), 8, 16
    ins = np.load(sys.argv[1])
    names = sorted({k.split("/")[0] for k in ins})
    mesh = jax.make_mesh(SIZES, AXES)
    spec = P(AXES)
    out = {}
    for name in names:
        pool = int(ins[name + "/pool"])

        def body(k, v, a, val):
            rr = route_to_owners(k, v, a, val, AXES, SIZES, pool)
            found = rr.valid & (rr.aux % 2 == 0)
            r, f = route_back(rr.vals ^ rr.keys, found, rr.origin,
                              rr.valid & (rr.aux >= 0), AXES, SIZES, LANES)
            return (rr.keys, rr.vals, rr.aux, rr.origin, rr.valid,
                    rr.dropped[None], r, f)

        step = jax.jit(mesh_shard_map(body, mesh, in_specs=(spec,) * 4,
                                      out_specs=(spec,) * 8))
        res = step(*[jnp.asarray(ins[f"{name}/{f}"].reshape(-1))
                     for f in ("keys", "vals", "aux", "valid")])
        for f, x in zip(("keys", "vals", "aux", "origin", "valid",
                         "dropped", "back_vals", "back_found"), res):
            out[f"{name}/{f}"] = np.asarray(x).reshape(S, -1)
    np.savez(sys.argv[2], **out)
''')


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """One subprocess on 8 fake devices runs every case."""
    tmp = tmp_path_factory.mktemp("routing")
    ins = {}
    for name, (pf, *_) in CASES.items():
        for f, x in zip(("keys", "vals", "aux", "valid"), case_inputs(name)):
            ins[f"{name}/{f}"] = x
        ins[f"{name}/pool"] = np.asarray(LANES * pf)
    np.savez(tmp / "in.npz", **ins)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", PROG, str(tmp / "in.npz"),
                          str(tmp / "ref.npz")], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return dict(np.load(tmp / "ref.npz"))


def _u64(t):
    return t.cpu().numpy().view(np.uint64)


@pytest.mark.parametrize("name", list(CASES))
def test_route_matches_reference_per_shard(reference, name):
    pf = CASES[name][0]
    keys, vals, aux, valid = case_inputs(name)
    rr = TR.route_to_owners(from_u64(keys, "cpu"), from_u64(vals, "cpu"),
                            torch.from_numpy(aux), torch.from_numpy(valid),
                            AXES, SIZES, LANES * pf)
    ref = {f: reference[f"{name}/{f}"] for f in
           ("keys", "vals", "aux", "origin", "valid", "dropped")}
    assert np.array_equal(_u64(rr.keys), ref["keys"])
    assert np.array_equal(_u64(rr.vals), ref["vals"])
    assert np.array_equal(rr.aux.numpy(), ref["aux"])
    assert np.array_equal(_u64(rr.origin), ref["origin"])
    assert np.array_equal(rr.valid.numpy(), ref["valid"])
    assert np.array_equal(rr.dropped.numpy(), ref["dropped"][:, 0])
    if name == "skewed_pf1":
        assert rr.dropped.sum() > 0
    if name == "uniform_pf2":
        assert rr.dropped.sum() == 0
    # every kept lane reached its owner
    own = TR.owner_of(rr.keys, S).numpy()
    rows = np.arange(S)[:, None].repeat(rr.keys.shape[1], 1)
    assert (own[rr.valid.numpy()] == rows[rr.valid.numpy()]).all()


@pytest.mark.parametrize("name", list(CASES))
def test_route_back_matches_reference(reference, name):
    pf = CASES[name][0]
    keys, vals, aux, valid = case_inputs(name)
    rr = TR.route_to_owners(from_u64(keys, "cpu"), from_u64(vals, "cpu"),
                            torch.from_numpy(aux), torch.from_numpy(valid),
                            AXES, SIZES, LANES * pf)
    found = rr.valid & (rr.aux % 2 == 0)
    r, f = TR.route_back(rr.vals ^ rr.keys, found, rr.origin,
                         rr.valid & (rr.aux >= 0), AXES, SIZES, LANES)
    assert np.array_equal(_u64(r), reference[f"{name}/back_vals"])
    assert np.array_equal(f.numpy(), reference[f"{name}/back_found"])
    # a lane that was routed and answered comes back in place
    sent = valid & (aux >= 0)
    back = f.numpy()
    assert not back[~sent].any()
    want = (vals ^ keys)[back]
    assert np.array_equal(_u64(r)[back], want)


def test_owner_of_top_bits():
    edge = np.array([0, 1, 2**61 - 1, 2**61, 2**63 - 1, 2**63,
                     2**64 - 2**61, 2**64 - 1], np.uint64)
    keys = np.concatenate([edge, np.random.default_rng(0).integers(
        0, 2**64, 500, dtype=np.uint64)])
    for n in (1, 2, 8, 256):
        want = np.asarray(JR.owner_of(jnp.asarray(keys), n))
        got = TR.owner_of(from_u64(keys, "cpu"), n).numpy()
        assert got.dtype == np.int32 and np.array_equal(got, want), n


@pytest.mark.parametrize("n_dest,cap,seed", [(4, 3, 0), (4, 16, 1),
                                             (16, 1, 2), (1, 40, 3)])
def test_bucketize_matches_reference(n_dest, cap, seed):
    """Ties (few destinations, many lanes each), invalid lanes, overflow
    (capacity below a destination's lanes), and a batch of rows."""
    rng = np.random.default_rng(seed)
    rows = [(rng.integers(0, n_dest, 40).astype(np.int32),
             rng.random(40) < 0.8,
             rng.integers(0, 2**64, 40, dtype=np.uint64),
             rng.integers(-5, 5, 40).astype(np.int32)) for _ in range(3)]
    tb, tv, td = TR.bucketize(
        torch.from_numpy(np.stack([r[0] for r in rows])),
        torch.from_numpy(np.stack([r[1] for r in rows])),
        [from_u64(np.stack([r[2] for r in rows]), "cpu"),
         torch.from_numpy(np.stack([r[3] for r in rows]))], n_dest, cap)
    for i, (dest, valid, k, a) in enumerate(rows):
        (jk, ja), jv, jd = JR.bucketize(jnp.asarray(dest), jnp.asarray(valid),
                                        [jnp.asarray(k), jnp.asarray(a)],
                                        n_dest, cap)
        assert np.array_equal(_u64(tb[0][i]), np.asarray(jk))
        assert np.array_equal(tb[1][i].numpy(), np.asarray(ja))
        assert np.array_equal(tv[i].numpy(), np.asarray(jv))
        assert int(td[i]) == int(jd)
    if cap == 1:
        assert td.sum() > 0


@pytest.mark.parametrize("out_size", [1, 7, 40, 64])
def test_compact_matches_reference(out_size):
    rng = np.random.default_rng(out_size)
    valid = rng.random((2, 40)) < 0.6
    k = rng.integers(0, 2**64, (2, 40), dtype=np.uint64)
    a = rng.integers(-3, 3, (2, 40)).astype(np.int32)
    tk, ta, tv, td = TR._compact([from_u64(k, "cpu"), torch.from_numpy(a)],
                                 torch.from_numpy(valid), out_size)
    for i in range(2):
        jk, ja, jv, jd = JR._compact([jnp.asarray(k[i]), jnp.asarray(a[i])],
                                     jnp.asarray(valid[i]), out_size)
        assert np.array_equal(_u64(tk[i]), np.asarray(jk))
        assert np.array_equal(ta[i].numpy(), np.asarray(ja))
        assert np.array_equal(tv[i].numpy(), np.asarray(jv))
        assert int(td[i]) == int(jd)


def test_shard_mesh():
    m = TR.ShardMesh(("data", "model"), (16, 16))
    assert m.n_shards == 256 and m.shape == {"data": 16, "model": 16}
