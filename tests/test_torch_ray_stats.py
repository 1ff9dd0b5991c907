"""grace_tpu_torch ray statistics and hypothesis tests against grace_tpu.

On the same directions: Rayleigh z within rtol 1e-5; the pair sums of
Beran's An and Gine's Gn within rtol 1e-5; Ripley's K bit-equal (so its
pair counts are exact). An and Gn are differences of terms of order n
(An = n - 2 / (n pi) sum psi_ij), so they agree with grace_tpu within
1e-5 x n, the pair sums' tolerance carried through; the port sums in f64
and is held to a float64 numpy evaluation within rtol 1e-5 (grace_tpu's
f32 sums are about 1e-4 relative from it). The host-side hypothesis
functions are copies and agree exactly; the Monte-Carlo band behaves as
``tests/integration/test_hypothesis.py`` requires, on torch draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grace_tpu.rays.hypothesis as jhy
import grace_tpu.rays.statistics as jst
import grace_tpu_torch.rays.hypothesis as thy
import grace_tpu_torch.rays.statistics as tst
from chip_smoke import f64_statistics
from tests.helper.torch_parity import one_torch_thread  # noqa: F401

SCALES = np.array([0.1, 0.5, 1.0, np.pi / 2], np.float32)


def iso(seed, n):
    v = np.array(jax.random.normal(jax.random.key(seed), (n, 3), jnp.float32))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def bundles():
    """(name, f32[n, 3]): isotropic, clustered, one-sided, antipodal."""
    d = iso(1, 1500)
    clustered = d.copy()
    clustered[:, :2] *= 0.1
    clustered /= np.linalg.norm(clustered, axis=1, keepdims=True)
    antipodal = d.copy()
    antipodal[:, 2] = np.abs(antipodal[:, 2]) * np.where(np.arange(1500) % 2 == 0, 1, -1)
    return [("isotropic 512", iso(0, 512)), ("isotropic 1500", d),
            ("clustered", clustered.astype(np.float32)), ("one-sided", np.abs(d)),
            ("antipodal", antipodal)]


@pytest.mark.parametrize("case", range(5))
def test_statistics_match_grace_tpu(case):
    name, d = bundles()[case]
    n = d.shape[0]
    t = torch.from_numpy(d)
    np.testing.assert_allclose(float(tst.rayleigh_z(t)), float(jst.rayleigh_z(d)), rtol=1e-5)
    for a, b in zip(tst._pair_sums(t), jst._pair_sums(d)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5, err_msg=name)
    got = tst.beran_gine_statistics(t)
    want = jst.beran_gine_statistics(d)
    an, gn, _, _ = f64_statistics(d, [])
    exact = {"An": an, "Gn": gn, "Fn": an + gn}
    for k in ("An", "Gn", "Fn"):
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=0, atol=1e-5 * n,
                                   err_msg=f"{name} {k}")
        np.testing.assert_allclose(float(got[k]), exact[k], rtol=1e-5, err_msg=f"{name} {k}")
    report = tst.uniformity_report(t)
    assert set(report) == set(jst.uniformity_report(d)) == {"z", "An", "Gn", "Fn"}
    assert report["An"] == float(got["An"])


@pytest.mark.parametrize("case", range(5))
def test_ripley_k_bit_equal(case):
    _, d = bundles()[case]
    for angles in (thy.DEFAULT_SCALES, np.array([0.3, 0.8, 1.5708, 2.4, np.pi], np.float32)):
        got = tst.ripley_k_sphere(torch.from_numpy(d), angles).numpy()
        assert np.array_equal(got.view(np.uint32),
                              np.asarray(jst.ripley_k_sphere(d, angles)).view(np.uint32))
        want_u = np.asarray(jst.ripley_k_uniform(angles))
        assert np.array_equal(tst.ripley_k_uniform(angles, device="cpu").numpy(), want_u)


def test_row_blocks_do_not_change_the_sums(monkeypatch):
    d = torch.from_numpy(iso(4, 700))
    whole = tst._pair_sums(d), tst.ripley_k_sphere(d, SCALES)
    monkeypatch.setattr(tst, "BLOCK_ELEMENTS", 700 * 96)    # blocks of 96 rows, one ragged
    sums = tst._pair_sums(d)
    for a, b in zip(sums, whole[0]):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-12)
    assert torch.equal(tst.ripley_k_sphere(d, SCALES), whole[1])


def test_isotropic_directions_map_bit_equal():
    key = jax.random.key(123)
    normals = np.array(jax.random.normal(key, (3000, 3), jnp.float32))
    want = np.asarray(jhy.isotropic_directions(key, 3000))
    got = thy._isotropic(torch.from_numpy(normals)).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_band_samples_count_the_same_pairs():
    """grace_tpu's band samples from its keys' draws; the port's batched
    count of the same draws gives the same pair counts."""
    n_dirs, n_samples = 256, 60
    band = jhy.ripley_csr_band(jax.random.key(0), n_dirs, SCALES, n_samples=n_samples)
    keys = jax.random.split(jax.random.key(0), n_samples)
    normals = np.stack([np.asarray(jax.random.normal(k, (n_dirs, 3), jnp.float32))
                        for k in keys])
    d = thy._isotropic(torch.from_numpy(normals))
    counts = tst._ripley_counts(d, tst._cos_f32(torch.from_numpy(SCALES))).numpy()
    scale = np.float32(n_dirs * (n_dirs / (4.0 * np.pi)))
    csr = np.asarray(jst.ripley_k_uniform(SCALES))
    want = np.rint((band.samples + csr).astype(np.float64) * scale).astype(np.int64) + n_dirs
    assert np.array_equal(counts, want)


def test_hypothesis_functions_agree_exactly(rng):
    s = rng.normal(0.0, 1.0, 301)
    for x in (-4.0, -0.3, 0.0, 1.2, 9.0):
        for tail in ("upper", "lower"):
            assert thy.mc_p_value(s, x, tail) == jhy.mc_p_value(s, x, tail)
    for conf in (0.9, 0.95, 0.999):
        assert thy.mc_limits(s, conf) == jhy.mc_limits(s, conf)
    st = np.repeat([0.0, 1.0, 2.0], 33)
    assert thy.mc_limits(st) == jhy.mc_limits(st)
    x, y = rng.normal(10.0, 2.0, 40), rng.normal(10.1, 2.5, 35)
    assert thy.equivalence_test(x, y, 2.0, 2.0) == jhy.equivalence_test(x, y, 2.0, 2.0)
    for inferior in ("larger", "smaller"):
        assert (thy.noninferiority_test(x, y, 1.0, inferior=inferior)
                == jhy.noninferiority_test(x, y, 1.0, inferior=inferior))
        assert (thy.nonnormal_noninferiority_test(x, y, 0.1, inferior=inferior)
                == jhy.nonnormal_noninferiority_test(x, y, 0.1, inferior=inferior))
    assert (thy.nonnormal_equivalence_test(x, y, 0.3, 0.3)
            == jhy.nonnormal_equivalence_test(x, y, 0.3, 0.3))
    assert thy._mann_whitney_moments(x, y) == jhy._mann_whitney_moments(x, y)
    for bad in (lambda m: m.mc_p_value(s, 0.0, "sideways"),
                lambda m: m.noninferiority_test(x, y, -1.0),
                lambda m: m.equivalence_test(x, y, 1.0, 1.0, cl=1.5)):
        for m in (thy, jhy):
            with pytest.raises(ValueError):
                bad(m)
    assert np.array_equal(thy.DEFAULT_SCALES, jhy.DEFAULT_SCALES)
    for k in ("RAYLEIGH_Z_CRIT", "BERAN_AN_CRIT", "GINE_GN_CRIT", "GINE_FN_CRIT"):
        assert getattr(tst, k) == getattr(jst, k)


def test_isotropy_test_agrees_on_grace_tpu_band():
    band = jhy.ripley_csr_band(jax.random.key(3), 256, SCALES, n_samples=100)
    tband = thy.RipleyBand(*band)
    for d in (iso(5, 256), np.abs(iso(6, 256))):
        want = jhy.ripley_isotropy_test(d, band)
        got = thy.ripley_isotropy_test(torch.from_numpy(d), tband)
        assert got[0] == want[0]
        assert np.array_equal(got[1], np.asarray(want[1]))
        assert np.array_equal(got[2], want[2])


def test_ripley_band_accepts_isotropic_rejects_biased():
    """test_hypothesis.py's band workflow on torch draws: an isotropic
    bundle falls inside the 95% band, one biased toward +z is rejected."""
    n_dirs = 256
    g = torch.Generator().manual_seed(0)
    band = thy.ripley_csr_band(g, n_dirs, SCALES, n_samples=200, device="cpu")
    assert band.samples.shape == (200, 4) and np.all(band.lower <= band.upper)

    iso_t = thy.isotropic_directions(torch.Generator().manual_seed(123), n_dirs, device="cpu")
    rej_iso, resid, p = thy.ripley_isotropy_test(iso_t, band)
    outside = (resid < band.lower) | (resid > band.upper)
    assert outside.sum() <= 1 and p.min() > 1 / 201

    d = thy.isotropic_directions(torch.Generator().manual_seed(7), n_dirs, device="cpu")
    d[:, 2] = 0.4 + d[:, 2].abs()
    d /= torch.linalg.norm(d, dim=1, keepdim=True)
    rej_bias, _, p_b = thy.ripley_isotropy_test(d, band)
    assert rej_bias and p_b.min() <= 0.05

    with pytest.raises(ValueError):
        thy.ripley_isotropy_test(iso_t[:100], band)


def test_band_chunks_do_not_change_the_samples(monkeypatch):
    """The samples depend on the generator and the chunk size only through
    the draws: a band drawn in chunks of 7 equals the counts of the same
    draws made at once."""
    monkeypatch.setattr(thy, "BAND_CHUNK_ELEMENTS", 64 * 64 * 7)
    band = thy.ripley_csr_band(torch.Generator().manual_seed(1), 64, SCALES, n_samples=20,
                               device="cpu")
    g = torch.Generator().manual_seed(1)
    draws = torch.cat([torch.randn((m, 64, 3), generator=g) for m in (7, 7, 6)])
    want = (tst._ripley_k(thy._isotropic(draws), SCALES)
            - tst.ripley_k_uniform(SCALES, device="cpu")).numpy()
    assert np.array_equal(band.samples, want)


def test_ripley_counts_past_f32_precision():
    """At n = 4,500 the 20.25 M ordered pairs pass 2^24, where grace_tpu's
    f32 conversion of its int32 counts starts to round (and from n = 46,341
    its int32 sum wraps); the port counts in int64 and divides in f64, so
    its K equals a float64 count but for pairs on a threshold."""
    d = iso(9, 4500)
    angles = np.array([0.05, 0.5, 1.0, 2.0, 3.0], np.float32)
    got = tst.ripley_k_sphere(torch.from_numpy(d), angles).numpy().astype(np.float64)
    _, _, want, near = f64_statistics(d, angles)
    assert np.all(np.abs(got - want) <= near + 1e-7 * want)


def _f64_an_gn(d):
    """An and Gn of the directions normalized, in float64 row blocks."""
    u = d.astype(np.float64)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    n = u.shape[0]
    psi_s = sin_s = 0.0
    for b0 in range(0, n, 1024):
        x = np.clip(u[b0:b0 + 1024] @ u.T, -1.0, 1.0)
        k = np.arange(x.shape[0])
        x[k, b0 + k] = 1.0
        psi = np.arccos(x)
        psi_s += psi.sum()
        sin_s += np.sin(psi).sum()
    coeff = 4.0 / (n * np.pi)
    return n - coeff * psi_s * 0.5, n / 2.0 - coeff * sin_s * 0.5


@pytest.mark.parametrize("nside", [16, 32])
def test_healpix_an_gn_match_float64(nside):
    """On rotated HEALPix directions (3,072 and 12,288; every antipode in
    the set, nearest neighbours 0.06 and 0.03 rad apart), An and Gn are
    within 1e-4 of a float64 evaluation of the normalized directions. The
    f32 rotation scales the set by about 1 - 2e-7, which moves Gn of the
    raw directions by about n (|d|^2 - 1) / 2 (-0.0025 at 12,288), and
    acos of an f32 dot product at an antipode is off by up to 3.5e-4."""
    import grace_tpu_torch.rays.healpix as th

    d = th.healpix_rays(torch.Generator().manual_seed(nside), nside, (0.5, 0.5, 0.5), 2.0,
                        device="cpu").directions
    norms2 = (d.double() ** 2).sum(dim=1)
    assert float((norms2 - 1).abs().max()) > 1e-7      # the set is not of unit vectors
    got = tst.beran_gine_statistics(d)
    an, gn = _f64_an_gn(d.numpy())
    assert abs(float(got["An"]) - an) <= 1e-4, (float(got["An"]), an)
    assert abs(float(got["Gn"]) - gn) <= 1e-4, (float(got["Gn"]), gn)
    assert gn > 0 and float(got["Gn"]) > 0


def test_near_parallel_and_antipodal_pairs():
    """On a set holding exact antipodes and pairs 1e-4 rad apart, where
    acos of an f32 dot product is off by up to 3.5e-4 a pair, the pair
    sums are within rtol 1e-9 (psi) and 1e-8 (sin psi) of float64's chord
    form, psi = 2 atan2(|a - b|, |a + b|); acos of the f32 dot products
    misses both (3.7e-8 and 6.0e-8)."""
    base = torch.from_numpy(iso(9, 256)).double()
    turn = torch.tensor([[1.0, 0.0, 0.0], [0.0, np.cos(1e-4), -np.sin(1e-4)],
                         [0.0, np.sin(1e-4), np.cos(1e-4)]], dtype=torch.float64)
    d = torch.cat([base, -base, base @ turn.T]).float()
    psi, sin = tst._pair_sums(d)
    u = d.double() / torch.linalg.vector_norm(d.double(), dim=1, keepdim=True)
    m = torch.cdist(u, u, compute_mode="donot_use_mm_for_euclid_dist")
    p = torch.cdist(u, -u, compute_mode="donot_use_mm_for_euclid_dist")
    assert torch.allclose(psi, (2 * torch.atan2(m, p)).sum(), rtol=1e-9, atol=0)
    assert torch.allclose(sin, (m * p / 2).sum(), rtol=1e-8, atol=0)


def test_matmul_f32_restores_the_callers_setting():
    """``matmul_f32`` turns TF32 off for its product only and restores the
    caller's switch after it, also when the product raises."""
    from grace_tpu_torch.ops.vecmath import matmul_f32

    m = torch.backends.cuda.matmul
    name, on, off = (("fp32_precision", "tf32", "ieee") if hasattr(m, "fp32_precision")
                     else ("allow_tf32", True, False))
    seen = []

    class Probe:
        def __init__(self, fail):
            self.fail = fail

        def __matmul__(self, other):
            seen.append(getattr(m, name))
            if self.fail:
                raise RuntimeError("product failed")
            return other

    saved = getattr(m, name)
    try:
        for setting in (on, off):
            setattr(m, name, setting)
            assert matmul_f32(Probe(False), 7) == 7
            with pytest.raises(RuntimeError, match="product failed"):
                matmul_f32(Probe(True), 7)
            assert getattr(m, name) == setting
        assert seen == [off] * 4
        a = torch.randn(5, 3, dtype=torch.float32)
        assert torch.equal(matmul_f32(a, a.T), a @ a.T)
    finally:
        setattr(m, name, saved)
