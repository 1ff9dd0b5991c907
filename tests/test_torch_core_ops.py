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


# ---- E2's keys kernel (csrc/build.cu) as a numpy model --------------------

from chip_smoke import KEY_CASES, key_outputs, key_scene  # noqa: E402
from tests.helper.morton_model import HELD, ROUTES, THREADS, model_launch  # noqa: E402,F401

POINT_CASES = [t for t, c in KEY_CASES.items() if c[0] != "rays"]


def _grace_tpu_keys(tag):
    """grace_tpu's keys of case ``tag``: morton_keys_sph (its box by
    jnp.min / jnp.max) or, at a given box, morton_keys_from_centroids;
    63-bit keys as one int64."""
    import grace_tpu.build.sph as jb

    _, _, bits, box, _, _ = KEY_CASES[tag]
    a = key_scene(tag)
    pts = a["points"]
    if box is None:
        spheres = np.concatenate([pts, np.full((pts.shape[0], 1), 0.02, np.float32)], axis=1)
        k = jax.jit(jb.morton_keys_sph, static_argnames="bits")(spheres, bits=bits)
    else:
        k = jax.jit(jm.morton_keys_from_centroids, static_argnames="bits")(pts, *a["box"],
                                                                           bits=bits)
    if bits == 63:
        return (np.asarray(k[0]).astype(np.int64) << 32) | np.asarray(k[1]).astype(np.int64)
    return np.asarray(k).astype(np.int64)


@pytest.mark.parametrize("tag", POINT_CASES)
def test_key_cases_model_match_grace_tpu(tag, model_launch):
    """The keys' one launch (the numpy model of grace_morton_keys, run
    through the port's public functions and wrappers with the device test
    made to say "not the CPU") at chip_smoke's KEY_CASES: 16-byte sphere
    rows, centroids and strided rows; the box folded in the launch (also
    with the grid capped at 1-3 blocks, where items are read again after
    the barrier), given as f32[3] or a scalar; NaN in one axis (that axis 0),
    -0 and +0 at the box's edges and an axis of zeros, +-inf, identical
    points, the conversion's edges (NaN, +-inf, negatives, -0, subnormals,
    values past 2^32, 2^21, 2^10) at scale 1; 1, 257 and no points. Keys
    bit-equal to the port's plain version and to grace_tpu's, one launch a
    call with points, on the route the case is for."""
    src, n, bits, box, blocks, _ = KEY_CASES[tag]
    got = key_outputs(tag, torch.device("cpu"), plain=False)["keys"]
    want = key_outputs(tag, torch.device("cpu"), plain=True)["keys"]
    assert model_launch == (["grace_morton_keys"] if n else [])
    assert np.array_equal(got.numpy(), want.numpy())
    if n:
        assert np.array_equal(got.numpy(), _grace_tpu_keys(tag))
        route = ROUTES[-1]
        assert route[:2] == ("spheres" if src == "spheres" else "centroids",
                             "fold" if box is None else "given")
        assert ("reread" in route) == bool(blocks and n > HELD * THREADS * blocks)


def test_key_cases_reach_their_edges():
    """The cases hold what they are for: the conversion's edges at scale 1
    give the saturating bits (a NaN, -0, a negative or a subnormal 0, 2^32
    and past it all ones, 1023.9999 -> 1023); the NaN case zeroes only its
    axis; a case reads items again after the barrier; the zeros case has
    both signs at the box's lower x edge and an axis of zeros alone."""
    a = key_scene("conversion edges at scale 1, 63-bit")
    assert a["box"][0].tolist() == [0, 0, 0] and a["box"][1][0] == 2097151
    keys = key_outputs("conversion edges at scale 1, 63-bit", torch.device("cpu"),
                       plain=True)["keys"].numpy()
    from tests.helper.morton_model import spread
    x = keys & spread(np.full(keys.shape, (1 << 21) - 1, np.int64), 63)
    v = a["points"][:, 0]
    for value, want in ((np.nan, 0), (-1.0, 0), (1e-40, 0), (-0.0, 0), (2.0 ** 32, (1 << 21) - 1),
                        (3e38, (1 << 21) - 1), (2097152.0, 0), (1023.9999, 1023)):
        hit = np.isnan(v) if np.isnan(value) else (v == value) & (np.signbit(v) == np.signbit(value))
        assert hit.any() and (x[hit] == spread(np.int64(want), 63)).all(), value
    k = key_outputs("NaN in one axis", torch.device("cpu"), plain=True)["keys"].numpy()
    assert (k & spread(np.int64(1023), 30)).sum() == 0 and (k >> 1).any()
    assert any(c[4] and c[1] > HELD * THREADS * c[4] for c in KEY_CASES.values())
    z = key_scene("-0 and +0 at the box edges, an axis of zeros")["points"]
    assert np.signbit(z[:, 0][z[:, 0] == 0]).any() and (~np.signbit(z[:, 0][z[:, 0] == 0])).any()
    assert (z[:, 1] == 0).all() and np.signbit(z[:, 1]).any() and (~np.signbit(z[:, 1])).any()


def test_keys_launch_arguments(model_launch, monkeypatch):
    """morton_keys_sph without a box is one launch on the sphere rows (no
    amin / amax, no copy), with a scratch of six floats a block; a box
    given on one side takes the centroids' other edge; the wrappers refuse
    other widths, types and bits."""
    import grace_tpu_torch.build.sph as tb

    s = torch.from_numpy(key_scene("clustered 5000 spheres, 30-bit")["spheres"])
    seen = []
    launch = tm._launch_keys
    monkeypatch.setattr(tm, "_launch_keys", lambda rows, *a, **k: (
        seen.append((rows.data_ptr(), rows.stride(0))), launch(rows, *a, **k))[1])
    keys = tb.morton_keys_sph(s)
    lo = s[:, :3].amin(dim=0) + 0.01
    half = tm.morton_keys_cuda(s[:, :3], lo, None, 30)
    assert seen[0] == (s.data_ptr(), 4) and model_launch == ["grace_morton_keys"] * 2
    assert torch.equal(keys, tb.morton_keys_sph(s, plain=True))
    assert torch.equal(half, tm._morton_keys_plain(s[:, :3], lo, s[:, :3].amax(dim=0), 30))
    for bad in (lambda: tm.morton_keys_cuda(s, None, None, 30),
                lambda: tm.morton_keys_cuda(s[:, :3].double(), None, None, 30),
                lambda: tm.morton_keys_cuda(s[:, :3], None, None, 31),
                lambda: tm.morton_keys_cuda(s[:, :3], torch.zeros(2), torch.ones(2), 30),
                lambda: tm.ray_keys_cuda(s[:, :3], s[:, :3], s[:7, 0])):
        with pytest.raises((ValueError, TypeError)):
            bad()
