"""grace_tpu_torch splat bucketing and splat image against grace_tpu.

Every SplatBuckets field is bit-exact. The image is compared with
grace_tpu's Pallas kernel in interpret mode, both fed grace_tpu's buckets
(through convert.py), within 1e-5 x max: the two sum the same f32 terms in
different orders. The CUDA kernel itself is held against the plain version
on a card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import numpy as np
import pytest
import torch

import grace_tpu.trace.splat as js
from grace_tpu.build.sph import build_sph_tree as j_build
import grace_tpu_torch.trace.splat as ts
from grace_tpu_torch import convert

CAM = (0.5, 0.5, -2.0)
LOOK = (0.5, 0.5, 0.5)
UP = (0.0, 1.0, 0.0)
W = H = 64
TILE = dict(tile_w=32, tile_h=64)


@pytest.fixture(scope="module")
def scene():
    from bench import make_clustered_particles

    sp = make_clustered_particles(np.random.default_rng(21), 1200)
    sp[:5, 2] = -3.0                     # behind the camera: culled by depth
    ss, _, _ = jax.jit(j_build, static_argnums=1)(sp, 16)
    w = (0.5 + np.random.default_rng(22).random(1200)).astype(np.float32)
    return np.array(ss), w


def _buckets(pkg, ss, weights, band, vext=1.2):
    return pkg.bucket_prims_ortho(ss, CAM, LOOK, UP, vext, 6.0, W, H, chunk=128,
                                  weights=weights, band=band, **TILE)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("band", [32, None])
def test_bucket_prims_ortho_exact(scene, weighted, band):
    ss, w = scene
    jb = _buckets(js, ss, w if weighted else None, band)
    tb = _buckets(ts, torch.from_numpy(ss), torch.from_numpy(w) if weighted else None, band)
    for f in js.SplatBuckets._fields:
        a, b = np.asarray(getattr(jb, f)), getattr(tb, f).numpy()
        assert a.shape == b.shape and np.array_equal(a, b), f


def test_bucket_overflow_and_empty_bands(scene):
    ss, _ = scene
    tb = ts.bucket_prims_ortho(torch.from_numpy(ss), CAM, LOOK, UP, 4.0, 6.0, 128, 128,
                               chunk=128, band=32, **TILE)
    assert bool((tb.first == tb.last).any())               # bands with no instance
    assert not bool(tb.overflow)
    big = np.array([[0.5, 0.5, 0.5, 0.9]], np.float32)
    assert bool(_buckets(ts, torch.from_numpy(big), None, 32).overflow)
    assert bool(_buckets(js, big, None, 32).overflow)


@pytest.mark.parametrize("basis", ["deg8", "deg10"])
@pytest.mark.parametrize("band", [32, None])
def test_splat_image_matches(scene, basis, band):
    ss, _ = scene
    jb = _buckets(js, ss, None, band, vext=1.6)
    want = np.asarray(js.splat_image(jb, interpret=True, basis=basis, **TILE))
    got = ts.splat_image(convert.splat_buckets_from_numpy(*(np.asarray(x) for x in jb), device="cpu"),
                         basis=basis, **TILE).numpy()
    assert want.max() > 0
    assert np.abs(got - want).max() <= 1e-5 * want.max()


def test_render_ortho_splat_matches(scene):
    ss, w = scene
    jimg, jovf = js.render_ortho_splat(ss, CAM, LOOK, UP, 1.2, 6.0, W, H, weights=w,
                                       chunk=128, interpret=True, **TILE)
    timg, tovf = ts.render_ortho_splat(torch.from_numpy(ss), CAM, LOOK, UP, 1.2, 6.0, W, H,
                                       weights=torch.from_numpy(w), chunk=128, **TILE)
    jimg = np.asarray(jimg)
    assert bool(jovf) == bool(tovf)
    assert np.abs(timg.numpy() - jimg).max() <= 1e-5 * jimg.max()


def test_sorted_first_counts():
    rng = np.random.default_rng(23)
    for n, n_keys in ((100_000, 512), (7, 5), (2048, 1), (0, 3)):
        keys = np.sort(rng.integers(0, n_keys + 1, n))
        got = ts._sorted_first_counts(torch.from_numpy(keys), n_keys).numpy()
        want = np.searchsorted(keys, np.arange(n_keys + 1), side="left")
        assert np.array_equal(got, want)


def test_splat_image_rejects_bad_input(scene):
    ss, _ = scene
    tb = _buckets(ts, torch.from_numpy(ss), None, 32)
    with pytest.raises(ValueError):
        ts.splat_image(tb, basis="deg9", **TILE)
    with pytest.raises(ValueError):
        ts.splat_image(tb, tile_w=32, tile_h=48)
    with pytest.raises(ValueError, match="several devices"):
        ts.splat_image(tb._replace(slabs=tb.slabs.to("meta")), **TILE)

