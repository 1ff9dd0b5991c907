"""grace_tpu_torch kernel integrals against grace_tpu: the shipped
coefficient cache is a byte-for-byte copy, every fit equals grace_tpu's,
and the torch evaluators agree with grace_tpu's compiled ones to rtol 1e-6.
"""

import filecmp
import os

import jax
import jax.numpy as jnp
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


def _b2_grid():
    b2 = np.concatenate([np.linspace(0.0, 1.2, 24001), [0.25, 1.0],
                         1.0 - np.geomspace(1e-7, 1e-2, 300)])
    return b2.astype(np.float32)


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("fast", [False, True])
def test_poly_and_grad_match(fast, grad):
    """The Clenshaw form of F and of dF/db2 (the fused renderer's integral
    with fast=True) within 2e-7 x max|F| (resp. max|dF/db2|) of grace_tpu's
    compiled form: the same fused multiply-adds, up to a few rare ulps."""
    b2 = _b2_grid()
    assert 0.25 in b2 and 1.0 in b2
    jf = jk.cubic_spline_line_integral_poly_grad if grad else jk.cubic_spline_line_integral_poly
    tf = tk.cubic_spline_line_integral_poly_grad if grad else tk.cubic_spline_line_integral_poly
    j = np.asarray(jax.jit(jf, static_argnums=1)(b2, fast))
    t = tf(torch.from_numpy(b2), fast).numpy()
    assert t.dtype == np.float32 and np.abs(j).max() > 0
    np.testing.assert_allclose(t, j, rtol=0, atol=2e-7 * np.abs(j).max())
    assert np.all(t[b2 >= 1.0] == 0.0)


def test_chebyshev_fits_equal():
    for a, b in ((jk._CHEB1, tk._CHEB1), (jk._CHEB2, tk._CHEB2), (jk._CHEB1_DOM, tk._CHEB1_DOM),
                 (jk._CHEB2_DOM, tk._CHEB2_DOM), (jk._CHEB1_SHORT, tk._CHEB1_SHORT),
                 (jk._CHEB2_SHORT, tk._CHEB2_SHORT)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_closed_form_matches(dtype):
    """The closed-form F (the gradient path's smooth option): f64 to 1e-12
    x max; f32 within 1e-5 x max of grace_tpu's f32. In f32 both lose up to
    ~1e-3 to cancellation, so the two libraries' log and sqrt roundings
    show through at a few ulps of F(0)."""
    beta = np.concatenate([np.linspace(0.0, 1.1, 2001), [0.5, 1.0]]).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        j = np.asarray(jk.cubic_spline_line_integral(jnp.asarray(beta)))
    t = tk.cubic_spline_line_integral(torch.from_numpy(beta)).numpy()
    assert t.dtype == dtype and np.all(t[beta >= 1.0] == 0.0)
    tol = 1e-12 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(t, j, rtol=0, atol=tol * np.abs(j).max())
    if dtype == np.float64:
        np.testing.assert_allclose(t[::100], [jk._line_integral_quadrature(b) for b in beta[::100]],
                                   atol=1e-9)


def test_unified_horner_coefficients_equal():
    assert tk.HORNER_DEG == jk.HORNER_DEG == 10
    assert np.array_equal(jk._HORNER_C1, tk._HORNER_C1)
    assert np.array_equal(jk._HORNER_C2, tk._HORNER_C2)


def test_unified_horner_bit_equal_to_eager_grace_tpu():
    """``grace_tpu``'s eager call rounds each multiply and add apart, as the
    port does: bit-equal on the grid, at the piece boundary u = 1/4 and its
    neighbours, and past the support. (Under jit XLA contracts the Horner
    steps into FMAs, ROADMAP C7; that form is not held here.)"""
    quarter = np.float32(0.25)
    u = np.concatenate([_u_grid(), [np.nextafter(quarter, np.float32(0)), quarter,
                                    np.nextafter(quarter, np.float32(1)), 0.0, np.inf]])
    u = u.astype(np.float32)
    j = np.asarray(jk.cubic_spline_line_integral_horner(u))
    t = tk.cubic_spline_line_integral_horner(torch.from_numpy(u)).numpy()
    assert t.dtype == np.float32 and np.array_equal(t, j)


def test_unified_horner_matches_quadrature():
    """The port of grace_tpu's own bound for the select-Horner form: <= 6e-5
    abs error over the support, exactly 0 outside, no NaN/inf for huge u."""
    b = np.linspace(0.0, 1.0, 4001)
    quad = tk.make_kernel_integral_table(4001)
    got = tk.cubic_spline_line_integral_horner(torch.from_numpy((b * b).astype(np.float32)))
    np.testing.assert_allclose(got.numpy(), quad, atol=6e-5)
    far = tk.cubic_spline_line_integral_horner(torch.tensor([1.0, 2.0, 1e6, np.inf]))
    assert torch.equal(far, torch.zeros(4)), far


def test_splat_basis_reference_equals_grace_tpu():
    x = np.linspace(-1.3, 1.3, 201)
    j = jk.splat_basis_reference(x[:, None], x[None, :])
    t = tk.splat_basis_reference(x[:, None], x[None, :])
    assert isinstance(t, np.ndarray) and t.dtype == np.float64 and np.array_equal(t, j)


def test_basis_fit_error_bound():
    """The port of grace_tpu's bound for the separable model: within 1.5e-4
    relative of F everywhere, and exactly 0 at and beyond the per-axis
    clamp."""
    x = np.linspace(-1.3, 1.3, 401)
    model = tk.splat_basis_reference(x[:, None], x[None, :])
    beta = np.sqrt(np.minimum(x[:, None] ** 2 + x[None, :] ** 2, 4.0))
    xi = np.clip(beta, 0, 1) * (tk.N_DENSE - 1)
    i0 = np.minimum(xi.astype(int), tk.N_DENSE - 2)
    fr = xi - i0
    table = tk.DENSE_KERNEL_INTEGRAL_TABLE
    truth = np.where(beta >= 1.0, 0.0, table[i0] * (1 - fr) + table[i0 + 1] * fr)
    assert np.abs(model - truth).max() < 1.5e-4 * truth.max()
    assert np.all(model[np.abs(x) >= 1.0, :] == 0.0)
