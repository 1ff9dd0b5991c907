"""grace_tpu_torch core types and ops against grace_tpu, on the CPU.

Inputs are made with numpy from a seed and fed to both packages. JAX
functions run under jit, the form grace_tpu's pipelines run them in
(XLA contracts a*b + c into a fused multiply-add there, and the port
mirrors that), so results must match bit for bit.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import grace_tpu.core.types as jt
import grace_tpu.ops.morton as jm
import grace_tpu.ops.primitives as jp
import grace_tpu.ops.vecmath as jv
import grace_tpu_torch.core.errors as terr
import grace_tpu_torch.core.tree as ttree
import grace_tpu_torch.core.types as tt
import grace_tpu_torch.ops.morton as tm
import grace_tpu_torch.ops.primitives as tp
import grace_tpu_torch.ops.vecmath as tv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _eq(j, t):
    j, t = np.asarray(j), t.numpy()
    assert j.shape == t.shape and np.array_equal(j, t)


def test_types_and_spheres():
    rng = np.random.default_rng(0)
    xyz = rng.random((50, 3)).astype(np.float32)
    h = rng.random(50).astype(np.float32)
    _eq(jt.make_spheres(xyz, h), tt.make_spheres(xyz, h, device="cpu"))
    for o in range(8):
        assert np.array_equal(jt.octant_signs(o), tt.octant_signs(o))
    assert [int(x) for x in jt.Octants] == [int(x) for x in tt.Octants]
    assert [x.name for x in jt.RaySortType] == [x.name for x in tt.RaySortType]
    r = tt.Rays.from_arrays(xyz, xyz, h, device="cpu")
    assert r.n_rays == 50 and r[3:7].n_rays == 4 and r.to("cpu").device.type == "cpu"


@pytest.mark.parametrize("name", ["dot3", "cross", "norm3"])
def test_vecmath(name):
    rng = np.random.default_rng(1)
    a = rng.standard_normal((1000, 3)).astype(np.float32)
    b = rng.standard_normal((1000, 3)).astype(np.float32)
    jf, tf = getattr(jv, name), getattr(tv, name)
    if name in ("dot3", "cross"):
        _eq(jax.jit(jf)(a, b), tf(torch.from_numpy(a), torch.from_numpy(b)))
    else:
        _eq(jax.jit(jf)(a), tf(torch.from_numpy(a)))


def test_normalize3_within_two_ulp():
    """Compiled, XLA rewrites 1/sqrt(x) as an approximate rsqrt; the port
    divides by the correctly rounded root (exactly as the reference's eager
    ops do), so the two differ by <= 2 ulp after the final multiply."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((1000, 3)).astype(np.float32)
    j = np.asarray(jax.jit(jv.normalize3)(a))
    t = tv.normalize3(torch.from_numpy(a)).numpy()
    assert np.all(np.abs(j - t) <= 2 * np.spacing(np.abs(j)))
    want = (a * (np.float32(1) / np.sqrt(tv.dot3(a, a).numpy()))[:, None])
    assert np.array_equal(t, want)


def test_sgn_and_primitives():
    rng = np.random.default_rng(2)
    x = rng.integers(-2, 3, 100).astype(np.float32)
    _eq(jv.sgn(x), tv.sgn(torch.from_numpy(x)))
    s = rng.random((64, 4)).astype(np.float32)
    for jf, tf in ((jp.sphere_aabb, tp.sphere_aabb),):
        for j, t in zip(jf(s), tf(torch.from_numpy(s))):
            _eq(j, t)
    _eq(jp.sphere_centroid(s), tp.sphere_centroid(torch.from_numpy(s)))


def test_fma_rounds_once():
    a = torch.tensor([1.0 + 2.0 ** -12], dtype=torch.float32)
    # a*a = 1 + 2^-11 + 2^-24: an f32 multiply drops the 2^-24 term
    assert float(tv.fma(a, a, torch.tensor([-1.0]))) == 2.0 ** -11 + 2.0 ** -24
    assert float(a * a - 1.0) == 2.0 ** -11


@pytest.mark.parametrize("bits", [30, 63])
@pytest.mark.parametrize("given_aabb", [False, True])
def test_morton_keys_bit_exact(bits, given_aabb):
    rng = np.random.default_rng(3 + bits)
    c = rng.random((5000, 3)).astype(np.float32)
    c[:7] = c[7]                      # duplicates
    lo = np.zeros(3, np.float32) if given_aabb else c.min(0)
    hi = np.ones(3, np.float32) if given_aabb else c.max(0)
    j = jax.jit(jm.morton_keys_from_centroids, static_argnames="bits")(c, lo, hi, bits=bits)
    t = tm.morton_keys_from_centroids(torch.from_numpy(c), lo, hi, bits=bits)
    if bits == 63:
        j = (np.asarray(j[0]).astype(np.int64) << 32) | np.asarray(j[1]).astype(np.int64)
    assert np.array_equal(np.asarray(j).astype(np.int64), t.numpy())


def test_morton_spreads_and_unit_keys():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 1 << 21, 4000).astype(np.uint32)
    assert np.array_equal(np.asarray(jm.space_by_two_10bit(x)).astype(np.int64),
                          tm.space_by_two_10bit(torch.from_numpy(x.astype(np.int64))).numpy())
    hi, lo = jm.space_by_two_21bit(x)
    want = (np.asarray(hi).astype(np.int64) << 32) | np.asarray(lo).astype(np.int64)
    assert np.array_equal(want, tm.space_by_two_21bit(torch.from_numpy(x.astype(np.int64))).numpy())
    u = rng.random((3, 4000)).astype(np.float32)
    tu = [torch.from_numpy(v) for v in u]
    assert np.array_equal(np.asarray(jm.morton_key_30bit_from_unit(*u)).astype(np.int64),
                          tm.morton_key_30bit_from_unit(*tu).numpy())
    hi, lo = jm.morton_key_63bit_from_unit(*u)
    want = (np.asarray(hi).astype(np.int64) << 32) | np.asarray(lo).astype(np.int64)
    assert np.array_equal(want, tm.morton_key_63bit_from_unit(*tu).numpy())


def test_tree_leaf_encoding():
    idx = torch.arange(10, dtype=torch.int32)
    enc = ttree.encode_leaf_child(idx)
    assert bool(ttree.is_leaf_child(enc).all())
    assert torch.equal(ttree.leaf_index(enc), idx)


def test_errors(monkeypatch):
    with pytest.raises(terr.GraceError):
        terr.require(False, "bad")
    terr.check_overflow(torch.zeros(3, dtype=torch.bool))
    with pytest.raises(terr.GraceError):
        terr.check_overflow(torch.tensor([False, True]))
    monkeypatch.setenv("GRACE_TPU_DEBUG", "0")
    terr.debug_assert(torch.tensor(False))
    monkeypatch.setenv("GRACE_TPU_DEBUG", "1")
    with pytest.raises(terr.GraceError):
        terr.debug_assert(torch.tensor([True, False]))


def test_import_hygiene():
    """Importing every module of the port leaves neither jax nor grace_tpu
    in sys.modules (a subprocess: this test process has imported jax)."""
    code = (
        "import pkgutil, sys, grace_tpu_torch\n"
        "for m in pkgutil.walk_packages(grace_tpu_torch.__path__, 'grace_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'grace_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean', len([m for m in sys.modules if m.startswith('grace_tpu_torch')]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("clean")
