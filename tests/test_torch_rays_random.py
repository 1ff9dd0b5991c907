"""grace_tpu_torch random and HEALPix rays and extrema against grace_tpu.

Each random generator of the port splits into a draw from a
``torch.Generator`` and a deterministic map from the drawn numbers to
rays. Fed ``jax.random``'s draws for the same key, each map gives
``grace_tpu``'s rays bit for bit, sort order included (``grace_tpu``
called eagerly, as its examples call it). HEALPix: the integer stage is
exact; the vectors agree within atol 2e-6 (XLA's and torch's f32 cos and
sin differ by an ulp on some inputs). The reference's own acceptance tests
(``tests/unit/test_rays.py``, ``tests/integration/test_isotropy.py``) run
again on the port's torch-drawn rays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grace_tpu.ops.extrema as jx
import grace_tpu.rays.gen as jg
import grace_tpu.rays.healpix as jh
from grace_tpu.core.types import Octants as JOctants
from grace_tpu.core.types import RaySortType as JSort
import grace_tpu_torch.ops.extrema as tx
import grace_tpu_torch.rays.gen as tg
import grace_tpu_torch.rays.healpix as th
from grace_tpu_torch.core.types import Octants, RaySortType
from grace_tpu_torch.rays.statistics import (
    BERAN_AN_CRIT,
    GINE_FN_CRIT,
    GINE_GN_CRIT,
    RAYLEIGH_Z_CRIT,
    beran_gine_statistics,
    rayleigh_z,
    ripley_k_sphere,
    ripley_k_uniform,
)
from tests.helper.torch_parity import one_torch_thread  # noqa: F401

ORIGIN = (0.5, 0.25, 1.0)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_rays_bits(j, t):
    for name in ("origins", "directions", "lengths"):
        a, b = np.asarray(getattr(j, name)), getattr(t, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(_bits(a), _bits(b)), name


def gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("seed,n", [(0, 4096), (7, 999)])
def test_uniform_map_bit_equal(seed, n, sort):
    key = jax.random.key(seed)
    normals = np.array(jax.random.normal(key, (n, 3), jnp.float32))
    want = jg.uniform_random_rays(key, n, ORIGIN, 2.0, sort=sort)
    assert_rays_bits(want, tg._uniform_rays(torch.from_numpy(normals), ORIGIN, 2.0, sort))


@pytest.mark.parametrize("octant", [Octants.PMP, Octants.MMM, Octants.PPP])
def test_single_octant_map_bit_equal(octant):
    key = jax.random.key(int(octant) + 3)
    normals = np.array(jax.random.normal(key, (2048, 3), jnp.float32))
    for sort in (True, False):
        want = jg.uniform_random_rays_single_octant(key, 2048, ORIGIN, 1.5,
                                                    JOctants(int(octant)), sort=sort)
        got = tg._single_octant_rays(torch.from_numpy(normals), ORIGIN, 1.5, octant, sort)
        assert_rays_bits(want, got)


@pytest.mark.parametrize("sort_type", list(RaySortType))
def test_one_to_many_bit_equal(sort_type, rng):
    pts = (rng.random((3000, 4)) * 4 - 1).astype(np.float32)
    pts[100] = pts[7]                  # equal keys: the stable sort keeps ties
    origin = (-1.0, 0.5, 2.0)
    want = jg.one_to_many_rays(origin, pts, JSort(int(sort_type)))
    assert_rays_bits(want, tg.one_to_many_rays(origin, pts, sort_type, device="cpu"))
    if sort_type == RaySortType.EndPointSort:
        lo, hi = np.full(3, -2.0, np.float32), np.full(3, 4.0, np.float32)
        want = jg.one_to_many_rays(origin, pts, JSort.EndPointSort, lo, hi)
        got = tg.one_to_many_rays(origin, torch.from_numpy(pts), sort_type, lo, hi)
        assert_rays_bits(want, got)


@pytest.mark.parametrize("plane", [((-1.0, -1.5, 0.7), (2.0, 0, 0), (0, 3.0, 0)),
                                   ((0.1, 0.2, -3.3), (1.3, 0.4, 0.2), (-0.3, 0.9, 0.7))])
def test_plane_parallel_map_bit_equal(plane):
    key = jax.random.key(2)
    w, h = 48, 40
    rw, rh = np.array(jax.random.uniform(key, (2, w * h), jnp.float32))
    want = jg.plane_parallel_random_rays(key, w, h, *plane, 9.0)
    got = tg._plane_parallel_rays(torch.from_numpy(rw), torch.from_numpy(rh), w, h, *plane, 9.0)
    assert_rays_bits(want, got)


def test_generators_draw_on_the_given_device():
    for make in (lambda g, d: tg.uniform_random_rays(g, 64, ORIGIN, 1.0, device=d),
                 lambda g, d: tg.uniform_random_rays_single_octant(g, 64, ORIGIN, 1.0,
                                                                   Octants.PPM, device=d),
                 lambda g, d: tg.plane_parallel_random_rays(g, 8, 8, (0, 0, 0), (1, 0, 0),
                                                            (0, 1, 0), 2.0, device=d),
                 lambda g, d: th.healpix_rays(g, 2, ORIGIN, 1.0, device=d)):
        rays = lambda seed: make(gen(seed), "cpu")
        both = lambda r: torch.cat([r.origins, r.directions])
        assert rays(5).origins.device.type == "cpu"
        assert torch.equal(both(rays(5)), both(rays(5)))      # same seed, same rays
        assert not torch.equal(both(rays(5)), both(rays(6)))
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make(gen(5), None)                             # the card by default


def _j_nest_rings(nside, ipix):
    """grace_tpu's integer stage of pix2vec_nest, from its own helpers."""
    ipix = jnp.asarray(ipix, jnp.uint32)
    npface = jnp.uint32(nside * nside)
    face = (ipix // npface).astype(jnp.int32)
    pf = ipix % npface
    x = jh._compact_bits(pf).astype(jnp.int32)
    y = jh._compact_bits(pf >> 1).astype(jnp.int32)
    jr = jh._JRLL[face] * nside - x - y - 1
    north, south = jr < nside, jr > 3 * nside
    nr = jnp.where(north, jr, jnp.where(south, 4 * nside - jr, nside))
    kshift = jnp.where(north | south, 0, (jr - nside) & 1)
    jp = (jh._JPLL[face] * nr + x - y + 1 + kshift) // 2
    jp = jnp.where(jp > 4 * nr, jp - 4 * nr, jp)
    jp = jnp.where(jp < 1, jp + 4 * nr, jp)
    return face, x, y, jr, nr, kshift, jp


@pytest.mark.parametrize("nside", [1, 2, 4, 16, 64])
def test_pix2vec_nest_integer_stage_exact_vectors_close(nside):
    n = 12 * nside * nside
    want = _j_nest_rings(nside, jnp.arange(n, dtype=jnp.uint32))
    got = th._nest_rings(nside, torch.arange(n))
    for name, a, b in zip(("face", "x", "y", "jr", "nr", "kshift", "jp"), want, got):
        assert np.array_equal(np.asarray(a).astype(np.int64), b.numpy()), name
    jv = np.asarray(jh.pix2vec_nest(nside, jnp.arange(n, dtype=jnp.uint32)))
    tv = th.pix2vec_nest(nside, torch.arange(n))
    assert tv.dtype == torch.float32
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0, atol=2e-6)
    with pytest.raises(ValueError):
        th.pix2vec_nest(3, torch.arange(4))


def test_compact_bits_exact_on_the_full_uint32_range(rng):
    v = rng.integers(0, 2 ** 32, 100_000, dtype=np.uint64).astype(np.uint32)
    v[:4] = [0, 1, 0xFFFFFFFF, 0xAAAAAAAA]
    want = np.asarray(jh._compact_bits(jnp.asarray(v))).astype(np.int64)
    assert np.array_equal(want, th._compact_bits(torch.from_numpy(v.astype(np.int64))).numpy())


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_rotation_and_healpix_rays_close(seed):
    key = jax.random.key(seed)
    q = np.array(jax.random.normal(key, (4,), jnp.float32))
    rot = th._rotation_from_quaternion(torch.from_numpy(q))
    np.testing.assert_allclose(rot.numpy(), np.asarray(jh.random_rotation_matrix(key)),
                               rtol=0, atol=1e-6)
    want = jh.healpix_rays(key, 8, ORIGIN, 3.0)
    vec = th.pix2vec_nest(8, torch.arange(768)) @ rot.T
    np.testing.assert_allclose(vec.numpy(), np.asarray(want.directions), rtol=0, atol=2e-6)
    rays = th.healpix_rays(gen(seed), 8, ORIGIN, 3.0, rotate=False, device="cpu")
    assert torch.equal(rays.directions, th.pix2vec_nest(8, torch.arange(768)))
    assert np.array_equal(rays.origins.numpy(), np.asarray(want.origins))
    assert np.array_equal(rays.lengths.numpy(), np.asarray(want.lengths))


@pytest.mark.parametrize("c", [2, 3, 4])
def test_extrema_exact(c, rng):
    pts = (rng.standard_normal((1000, c)) * 10).astype(np.float32)
    t = torch.from_numpy(pts)
    for jf, tf in ((jx.min_vec, tx.min_vec), (jx.max_vec, tx.max_vec)):
        assert np.array_equal(np.asarray(jf(pts)), tf(t).numpy())
    for a, b in zip(jx.min_max(pts), tx.min_max(t)):
        assert np.array_equal(np.asarray(a), b.numpy())
    for k in range(c):
        for a, b in zip(jx.min_max_component(pts, k), tx.min_max_component(t, k)):
            assert np.asarray(a) == b.item()


# --- the reference's acceptance tests on the port's torch-drawn rays ---

def test_uniform_rays_normalized_and_sorted():
    rays = tg.uniform_random_rays(gen(0), 4096, (1, 2, 3), 5.0, device="cpu")
    d = rays.directions.numpy()
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(rays.origins.numpy()[0], [1, 2, 3])
    assert np.all(rays.lengths.numpy() == 5.0)
    keys = tg.ray_dir_morton_keys(rays.directions)
    assert bool((keys[1:] >= keys[:-1]).all())


def test_single_octant_signs():
    rays = tg.uniform_random_rays_single_octant(gen(1), 512, (0, 0, 0), 1.0, Octants.PMP,
                                                device="cpu")
    d = rays.directions.numpy()
    assert np.all(d[:, 0] > 0) and np.all(d[:, 1] < 0) and np.all(d[:, 2] > 0)


def test_one_to_many_lengths_terminate_at_points(rng):
    pts = rng.random((256, 3)).astype(np.float32) * 4
    origin = np.array([-1.0, 0.5, 2.0], np.float32)
    rays = tg.one_to_many_rays(origin, pts, RaySortType.NoSort, device="cpu")
    ends = rays.origins + rays.directions * rays.lengths[:, None]
    np.testing.assert_allclose(ends.numpy(), pts, atol=1e-4)
    for st in (RaySortType.DirectionSort, RaySortType.EndPointSort):
        rs = tg.one_to_many_rays(origin, pts, st, device="cpu")
        ends = (rs.origins + rs.directions * rs.lengths[:, None]).numpy()
        rec = [("x", np.float32), ("y", np.float32), ("z", np.float32)]
        a = np.sort(ends.round(4).view(rec), axis=0)
        b = np.sort(pts.round(4).view(rec), axis=0)
        np.testing.assert_array_equal(a, b)


def test_plane_parallel_on_plane_and_jittered():
    w = np.array([2.0, 0, 0], np.float32)
    h = np.array([0, 3.0, 0], np.float32)
    base = np.array([-1.0, -1.5, 0.7], np.float32)
    rays = tg.plane_parallel_random_rays(gen(2), 16, 24, base, w, h, 9.0, device="cpu")
    o = rays.origins.numpy()
    assert o.shape == (16 * 24, 3)
    np.testing.assert_allclose(o[:, 2], 0.7, atol=1e-6)
    assert o[:, 0].min() >= -1.0 and o[:, 0].max() <= 1.0
    assert o[:, 1].min() >= -1.5 and o[:, 1].max() <= 1.5
    ix = np.floor((o[:, 0] + 1.0) / (2.0 / 16)).astype(int)
    iy = np.floor((o[:, 1] + 1.5) / (3.0 / 24)).astype(int)
    assert len({(a, b) for a, b in zip(ix, iy)}) == 16 * 24
    np.testing.assert_allclose(rays.directions.numpy(), [[0, 0, 1.0]] * (16 * 24), atol=1e-6)


def test_healpix_pixels_unit_and_balanced():
    nside = 16
    n = 12 * nside * nside
    vec = th.pix2vec_nest(nside, torch.arange(n)).numpy()
    np.testing.assert_allclose(np.linalg.norm(vec, axis=1), 1.0, atol=1e-5)
    assert len({tuple(v.round(5)) for v in vec}) == n
    np.testing.assert_allclose(np.sort(vec[:, 2]), -np.sort(-vec[:, 2])[::-1] * 1.0, atol=1e-5)
    np.testing.assert_allclose(vec.mean(axis=0), 0.0, atol=1e-6)
    zs = np.sort(vec[:, 2])
    uniform = np.linspace(-1, 1, n + 1)[:-1] + 1.0 / n
    np.testing.assert_allclose(zs, uniform, atol=2.0 / nside)


def test_healpix_rays_rotation_preserves_isotropy():
    d = th.healpix_rays(gen(3), 8, (0, 0, 0), 1.0, rotate=True, device="cpu").directions.numpy()
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(d.mean(axis=0), 0.0, atol=1e-5)


N_ISO = 4096


def test_uniform_rays_pass_uniformity():
    d = tg.uniform_random_rays(gen(0), N_ISO, (0, 0, 0), 1.0, device="cpu").directions
    z = float(rayleigh_z(d))
    assert z < RAYLEIGH_Z_CRIT[0.01], z
    bg = {k: float(v) for k, v in beran_gine_statistics(d).items()}
    assert bg["An"] < BERAN_AN_CRIT[0.01], bg
    assert bg["Gn"] < GINE_GN_CRIT[0.01], bg
    assert bg["Fn"] < GINE_FN_CRIT[0.01], bg


def test_healpix_directions_pass_uniformity():
    d = th.healpix_rays(gen(1), 16, (0, 0, 0), 1.0, device="cpu").directions
    assert float(rayleigh_z(d)) < RAYLEIGH_Z_CRIT[0.01]
    assert float(beran_gine_statistics(d)["Fn"]) < GINE_FN_CRIT[0.01]


def test_single_octant_rays_fail_uniformity():
    d = tg.uniform_random_rays_single_octant(gen(2), N_ISO, (0, 0, 0), 1.0, Octants.PPP,
                                             device="cpu").directions
    assert float(rayleigh_z(d)) > RAYLEIGH_Z_CRIT[0.01] * 10
    assert float(beran_gine_statistics(d)["An"]) > BERAN_AN_CRIT[0.01]


def test_antipodal_bimodal_detected_by_gn_not_z():
    rng = np.random.default_rng(0)
    d = rng.standard_normal((N_ISO, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:, 2] = np.abs(d[:, 2]) * np.where(np.arange(N_ISO) % 2 == 0, 1, -1)
    d[:, 0] *= 0.2
    d[:, 1] *= 0.2
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = torch.from_numpy(d)
    assert float(rayleigh_z(t)) < RAYLEIGH_Z_CRIT[0.05] * 3
    assert float(beran_gine_statistics(t)["Gn"]) > GINE_GN_CRIT[0.01]


def test_ripley_k_matches_uniform_expectation():
    d = tg.uniform_random_rays(gen(5), 3000, (0, 0, 0), 1.0, device="cpu").directions
    angles = np.array([0.3, 0.8, 1.5708, 2.4], np.float32)
    k = ripley_k_sphere(d, angles).numpy()
    k0 = ripley_k_uniform(angles, device="cpu").numpy()
    assert np.max(np.abs(k - k0) / k0) < 0.05
    dc = d.clone()
    dc[:, :2] *= 0.1
    dc /= torch.linalg.norm(dc, dim=1, keepdim=True)
    assert float(ripley_k_sphere(dc, angles)[0]) > 3 * k0[0]
