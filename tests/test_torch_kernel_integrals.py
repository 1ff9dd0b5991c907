"""grace_tpu_torch kernel integrals against grace_tpu: the shipped
coefficient cache is a byte-for-byte copy, every fit equals grace_tpu's,
and the torch evaluators agree with grace_tpu's compiled ones to rtol 1e-6.
"""

import filecmp
import os

import jax
import numpy as np
import pytest
import torch

import grace_tpu.sph.kernel_integrals as jk
import grace_tpu_torch.sph.kernel_integrals as tk


def test_cache_file_is_a_copy():
    assert filecmp.cmp(jk._COEFF_CACHE_PATH, tk._COEFF_CACHE_PATH, shallow=False)
    with np.load(jk._COEFF_CACHE_PATH) as zj, np.load(tk._COEFF_CACHE_PATH) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert np.array_equal(zj[k], zt[k]), k


def test_cache_is_opened_read_only(monkeypatch):
    """A fit missing from the cache is derived in memory, never written."""
    before = os.stat(tk._COEFF_CACHE_PATH).st_mtime_ns
    monkeypatch.setattr(tk, "_CACHE", dict(tk._CACHE))
    tk._CACHE.pop("d8")
    assert np.allclose(tk.direct_coeffs(8), jk.direct_coeffs(8), rtol=1e-9, atol=1e-12)
    assert os.stat(tk._COEFF_CACHE_PATH).st_mtime_ns == before


def test_fits_and_tables_equal():
    assert np.array_equal(jk.KERNEL_INTEGRAL_TABLE, tk.KERNEL_INTEGRAL_TABLE)
    assert np.array_equal(jk.DENSE_KERNEL_INTEGRAL_TABLE, tk.DENSE_KERNEL_INTEGRAL_TABLE)
    for a, b in ((jk.SPLAT_A_COEFFS, tk.SPLAT_A_COEFFS), (jk.SPLAT_B_COEFFS, tk.SPLAT_B_COEFFS),
                 (jk.SPLAT_A8_COEFFS, tk.SPLAT_A8_COEFFS), (jk.SPLAT_B8_COEFFS, tk.SPLAT_B8_COEFFS)):
        assert np.array_equal(a, b)
    for deg in (14, 8):
        assert np.array_equal(jk.horner1_coeffs(deg), tk.horner1_coeffs(deg))
    for deg in (12, 10):
        assert np.array_equal(jk.direct_coeffs(deg), tk.direct_coeffs(deg))


def _u_grid():
    u = np.concatenate([np.linspace(0.0, 1.2, 20001), 1.0 - np.geomspace(1e-7, 1e-2, 500),
                        [1.0, 1.5, 10.0, 1e5]])
    return u.astype(np.float32)


@pytest.mark.parametrize("deg", [14, 8, -10, -12])
def test_horner1_matches(deg):
    u = _u_grid()
    j = np.asarray(jax.jit(jk.cubic_spline_line_integral_horner1, static_argnums=1)(u, deg))
    t = tk.cubic_spline_line_integral_horner1(torch.from_numpy(u), deg).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)
    assert np.all(t[u >= 1.0] == 0.0)


@pytest.mark.parametrize("deg", [12, 10])
def test_direct_raw_matches(deg):
    u = _u_grid()
    j = np.asarray(jax.jit(jk.cubic_spline_line_integral_direct_raw, static_argnums=1)(u, deg))
    t = tk.cubic_spline_line_integral_direct_raw(torch.from_numpy(u), deg).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)


@pytest.mark.parametrize("deg", [14, -10])
def test_integral_coeffs_are_the_f32_fit(deg):
    c = jk.horner1_coeffs(deg) if deg > 0 else jk.direct_coeffs(-deg)
    assert np.array_equal(tk.integral_coeffs(deg), np.asarray(c, np.float32))
