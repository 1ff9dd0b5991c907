"""SPH cubic-spline (M4) kernel line integrals.

PyTorch counterpart of ``grace_tpu.sph.kernel_integrals``. The 3D cubic
spline with support radius 1 is

    w(q) = (8/pi) * (1 - 6 q^2 + 6 q^3)   for 0   <= q <= 1/2
    w(q) = (8/pi) * 2 (1 - q)^3           for 1/2 <  q <= 1

and the dimensionless line integral at normalized impact parameter beta is
F(beta) = Integral_{-z1}^{z1} w(sqrt(beta^2 + z^2)) dz, z1 = sqrt(1-beta^2);
a particle of smoothing length h contributes F(b/h) / h^2.

The derivations (f64 numpy quadrature and polynomial fits) are the same as
``grace_tpu``'s. Their results are read from ``_horner_cache.npz`` beside
this module, a byte-for-byte copy of ``grace_tpu``'s cache; the file is
opened read-only, and a fit missing from it is derived in memory.
The torch evaluators reproduce ``grace_tpu``'s f32 operation order.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from grace_tpu_torch.ops.vecmath import fma, sqrt

N_TABLE = 51
_SIGMA = 8.0 / np.pi

_COEFF_CACHE_PATH = os.path.join(os.path.dirname(__file__), "_horner_cache.npz")

# The Gauss-Legendre nodes are the same for every quadrature of one order;
# computing them once makes a fit that is not in the cache ~10x cheaper.
_leggauss = functools.lru_cache(maxsize=None)(np.polynomial.legendre.leggauss)


def _load_cache() -> dict:
    if not os.path.exists(_COEFF_CACHE_PATH):
        return {}
    with np.load(_COEFF_CACHE_PATH) as z:
        return {k: z[k] for k in z.files}


_CACHE = _load_cache()


def _cached_fit_multi(keys, fit_fn):
    """Arrays ``keys`` from the cache, or from ``fit_fn`` (kept in memory)."""
    if not all(k in _CACHE for k in keys):
        for k, v in zip(keys, fit_fn()):
            _CACHE[k] = np.asarray(v)
    return tuple(_CACHE[k] for k in keys)


def _cached_fit(key, fit_fn):
    return _cached_fit_multi([key], lambda: (fit_fn(),))[0]


def _w_dimensionless(q):
    """Cubic spline w(q) with support radius 1 (numpy, f64)."""
    q = np.asarray(q, np.float64)
    inner = 1.0 - 6.0 * q * q + 6.0 * q * q * q
    outer = 2.0 * (1.0 - q) ** 3
    return _SIGMA * np.where(q <= 0.5, inner, np.where(q <= 1.0, outer, 0.0))


def _line_integral_quadrature(beta: float, order: int = 96) -> float:
    """F(beta) by piecewise Gauss-Legendre quadrature (f64)."""
    beta = float(beta)
    if beta >= 1.0:
        return 0.0
    z1 = np.sqrt(1.0 - beta * beta)
    zs = np.sqrt(max(0.25 - beta * beta, 0.0))
    x, w = _leggauss(order)

    def seg(a, b):
        if b <= a:
            return 0.0
        z = 0.5 * (b - a) * x + 0.5 * (b + a)
        q = np.sqrt(beta * beta + z * z)
        return 0.5 * (b - a) * np.sum(w * _w_dimensionless(q))

    return 2.0 * (seg(0.0, zs) + seg(zs, z1))


def make_kernel_integral_table(n: int = N_TABLE) -> np.ndarray:
    """Table of F(i / (n-1)) for i in [0, n) (f64 numpy)."""
    return np.array([_line_integral_quadrature(b) for b in np.linspace(0.0, 1.0, n)])


KERNEL_INTEGRAL_TABLE = make_kernel_integral_table()
N_DENSE = 2048
DENSE_KERNEL_INTEGRAL_TABLE = make_kernel_integral_table(N_DENSE)


def _fit_single_horner(deg: int = 14):
    """Monomial coefficients of the weighted single-piece fit of
    g(u) = F / v^{7/2} (v = 1 - u, u = beta^2) in t = 2u - 1."""
    u = np.concatenate(
        [np.linspace(0.0, 1.0, 6001)[:-1], 1.0 - np.geomspace(1e-7, 0.05, 500)])
    u = np.unique(u)
    f = np.array([_line_integral_quadrature(np.sqrt(x)) for x in u])
    v = 1.0 - u
    t = 2.0 * u - 1.0
    c = np.polynomial.chebyshev.Chebyshev.fit(t, f / v**3.5, deg,
                                              domain=[-1, 1], w=v**3.5)
    return np.asarray(c.convert(kind=np.polynomial.Polynomial).coef, np.float64)


def _fit_direct(deg: int):
    """Monomial coefficients of a direct fit of F over u in [0, 1] in
    t = 2u - 1 (no v^3 sqrt(v) prefactor)."""
    u = np.concatenate([np.linspace(0.0, 1.0, 6001),
                        1.0 - np.geomspace(1e-7, 0.05, 500)])
    u = np.unique(u)
    f = np.array([_line_integral_quadrature(np.sqrt(x)) for x in u])
    c = np.polynomial.chebyshev.Chebyshev.fit(2.0 * u - 1.0, f, deg, domain=[-1, 1])
    return np.asarray(c.convert(kind=np.polynomial.Polynomial).coef, np.float64)


def _fit_chebyshev_pieces():
    """Piecewise Chebyshev fits of F: piece 1 in u = beta^2 on [0, 1/4]
    (degree 14, and 8 for ``fast``), piece 2 as F / v^{7/2} in v = 1 - u
    on [1/4, 1) (degree 10, and 6)."""
    b1 = np.linspace(0.0, 0.5, 2001)
    f1 = np.array([_line_integral_quadrature(b) for b in b1])
    b2g = np.linspace(0.5, 1.0, 2001)[:-1]
    f2 = np.array([_line_integral_quadrature(b) for b in b2g])
    v = 1.0 - b2g * b2g
    fit = np.polynomial.chebyshev.Chebyshev.fit
    c1, c2 = fit(b1 * b1, f1, 14), fit(v, f2 / v**3.5, 10)
    return (c1.coef, c1.domain, c2.coef, c2.domain,
            fit(b1 * b1, f1, 8).coef, fit(v, f2 / v**3.5, 6).coef)


_CHEB1, _CHEB1_DOM, _CHEB2, _CHEB2_DOM, _CHEB1_SHORT, _CHEB2_SHORT = _cached_fit_multi(
    ["cheb1", "cheb1_dom", "cheb2", "cheb2_dom", "cheb1s", "cheb2s"], _fit_chebyshev_pieces)


def _fit_unified_horner(deg: int = 10):
    """Monomial coefficients of the unified select-Horner form: piece 1
    (u <= 1/4) fits F in t = u / 0.125 - 1, piece 2 (u > 1/4) fits
    F / v^{7/2} in t = v / 0.375 - 1 (v = 1 - u), both of degree ``deg``."""
    u1 = np.linspace(0.0, 0.25, 3001)
    f1 = np.array([_line_integral_quadrature(np.sqrt(x)) for x in u1])
    c1 = np.polynomial.chebyshev.Chebyshev.fit(u1 / 0.125 - 1.0, f1, deg, domain=[-1, 1])
    u2 = np.unique(np.concatenate(
        [np.linspace(0.25, 1.0, 4001)[:-1], 1.0 - np.geomspace(1e-7, 0.05, 400)]))
    f2 = np.array([_line_integral_quadrature(np.sqrt(x)) for x in u2])
    v2 = 1.0 - u2
    c2 = np.polynomial.chebyshev.Chebyshev.fit(v2 / 0.375 - 1.0, f2 / v2**3.5, deg,
                                               domain=[-1, 1])
    return tuple(np.asarray(c.convert(kind=np.polynomial.Polynomial).coef, np.float64)
                 for c in (c1, c2))


HORNER_DEG = 10
_HORNER_C1, _HORNER_C2 = _cached_fit_multi(
    [f"uh{HORNER_DEG}_1", f"uh{HORNER_DEG}_2"], lambda: _fit_unified_horner(HORNER_DEG))


@functools.lru_cache(maxsize=None)
def poly_constants(fast: bool) -> dict:
    """The f32 constants of ``cubic_spline_line_integral_poly`` and its
    gradient: the domain maps of both pieces (t = (2x - sum) * inv_width),
    the two Chebyshev series, their ``chebder`` derivative series and the
    derivative scales 2 / width. The CUDA kernels read the same values."""
    c1 = _CHEB1_SHORT if fast else _CHEB1
    c2 = _CHEB2_SHORT if fast else _CHEB2
    f32 = lambda a: np.asarray(a, np.float32)
    (lo1, hi1), (lo2, hi2) = _CHEB1_DOM, _CHEB2_DOM
    return dict(
        sum1=f32(lo1 + hi1), inv1=f32(1.0 / f32(hi1 - lo1)), scale1=f32(2.0 / (hi1 - lo1)),
        sum2=f32(lo2 + hi2), inv2=f32(1.0 / f32(hi2 - lo2)), scale2=f32(2.0 / (hi2 - lo2)),
        c1=f32(c1), c2=f32(c2), d1=f32(np.polynomial.chebyshev.chebder(c1)),
        d2=f32(np.polynomial.chebyshev.chebder(c2)))


def _clenshaw(coefs: np.ndarray, t: torch.Tensor) -> torch.Tensor:
    """Chebyshev series sum_k c_k T_k(t) by Clenshaw's recurrence, each
    step one fused multiply-add and an add, as compiled XLA rounds it."""
    b1 = torch.zeros_like(t)
    b2 = torch.zeros_like(t)
    for c in coefs[:0:-1]:
        b1, b2 = fma(2.0 * t, b1, -b2) + float(c), b1
    return fma(t, b1, -b2) + float(coefs[0])


def _poly_pieces(b2, fast: bool):
    k = poly_constants(fast)
    b2 = torch.as_tensor(b2, dtype=torch.float32)
    t1 = torch.clamp((2.0 * b2 - float(k["sum1"])) * float(k["inv1"]), -1.0, 1.0)
    v = torch.clamp(1.0 - b2, min=0.0)
    t2 = torch.clamp((2.0 * v - float(k["sum2"])) * float(k["inv2"]), -1.0, 1.0)
    return k, b2, t1, v, t2


def cubic_spline_line_integral_poly(b2, fast: bool = False) -> torch.Tensor:
    """F(beta) from beta^2 as f32 polynomial math: Clenshaw of the piece-1
    series in b2 for b2 <= 1/4, v^{7/2} times the piece-2 series in
    v = 1 - b2 for b2 < 1, else 0. ``fast`` takes the short fits (9 and 7
    terms), the form of the fused differentiable renderer."""
    k, b2, t1, v, t2 = _poly_pieces(b2, fast)
    f_in = _clenshaw(k["c1"], t1)
    f_out = _clenshaw(k["c2"], t2) * (v * v * v * sqrt(v))
    return torch.where(b2 <= 0.25, f_in, torch.where(b2 < 1.0, f_out, 0.0))


def cubic_spline_line_integral_poly_grad(b2, fast: bool = False) -> torch.Tensor:
    """dF/d(beta^2) of ``cubic_spline_line_integral_poly``, the exact
    derivative of the fit: the derivative series for piece 1, and
    -(3.5 v^{5/2} P(v) + v^{7/2} P'(v)) for piece 2."""
    k, b2, t1, v, t2 = _poly_pieces(b2, fast)
    g_in = _clenshaw(k["d1"], t1) * float(k["scale1"])
    p_v = _clenshaw(k["c2"], t2)
    dp_v = _clenshaw(k["d2"], t2) * float(k["scale2"])
    v2 = v * v
    sq = sqrt(v)
    g_out = -fma(v2 * v * sq, dp_v, 3.5 * v2 * sq * p_v)
    return torch.where(b2 <= 0.25, g_in, torch.where(b2 < 1.0, g_out, 0.0))


def cubic_spline_line_integral(beta) -> torch.Tensor:
    """Closed-form F(beta) for beta >= 0, smooth and differentiable, in
    the dtype of ``beta`` (exact in f64; f32 loses ~1e-3 to cancellation).

    With s = sqrt(z^2 + beta^2): I1 = (z s + beta^2 log(z + s)) / 2,
    I2 = beta^2 z + z^3 / 3, I3 = z s^3 / 4 + (3 beta^2 / 8)(z s + beta^2
    log(z + s)); the inner piece integrates I0 - 6 I2 + 6 I3, the outer
    2 (I0 - 3 I1 + 3 I2 - I3)."""
    beta = torch.as_tensor(beta)
    b2 = beta * beta
    # The eps floors keep sqrt and log away from 0 where the clamps bind, so
    # autograd sees a zero gradient there rather than 0 * inf.
    eps = 1e-20
    z1 = torch.sqrt(torch.clamp(1.0 - b2, min=eps))
    zs = torch.sqrt(torch.clamp(0.25 - b2, min=eps))

    def log_zps(z):
        return torch.log(torch.clamp(z + torch.sqrt(z * z + b2), min=eps))

    def i1(z):
        return 0.5 * (z * torch.sqrt(z * z + b2) + b2 * log_zps(z))

    def i2(z):
        return b2 * z + z * z * z / 3.0

    def i3(z):
        s = torch.sqrt(z * z + b2)
        return 0.25 * z * s * s * s + 0.375 * b2 * (z * s + b2 * log_zps(z))

    def g_inner(z):
        return z - 6.0 * i2(z) + 6.0 * i3(z)

    def g_outer(z):
        return 2.0 * (z - 3.0 * i1(z) + 3.0 * i2(z) - i3(z))

    val = 2.0 * _SIGMA * ((g_inner(zs) - g_inner(torch.zeros_like(zs)))
                          + (g_outer(z1) - g_outer(zs)))
    return torch.where(beta < 1.0, val, torch.zeros_like(val))


HORNER1_DEG = 14


def horner1_coeffs(deg: int) -> np.ndarray:
    """Weighted-fit coefficients (f64[deg + 1]) for a Horner degree."""
    return _cached_fit(f"h{deg}", lambda: _fit_single_horner(deg))


def direct_coeffs(deg: int) -> np.ndarray:
    """Direct-fit coefficients (f64[deg + 1]) for a Horner degree."""
    return _cached_fit(f"d{deg}", lambda: _fit_direct(deg))


def integral_coeffs(integral_deg: int) -> np.ndarray:
    """f32 coefficients of the ``cubic_spline_line_integral_horner1``
    flavor ``integral_deg`` selects, lowest order first (the array the
    trace kernel takes)."""
    c = direct_coeffs(-integral_deg) if integral_deg < 0 else horner1_coeffs(integral_deg)
    return np.asarray(c, np.float32)


def _horner(t: torch.Tensor, coeffs: np.ndarray, deg: int) -> torch.Tensor:
    """f32 Horner steps as fused multiply-adds (see ops.vecmath.fma)."""
    acc = torch.full_like(t, float(np.float32(coeffs[deg])))
    for k in range(deg - 1, -1, -1):
        acc = fma(acc, t, float(np.float32(coeffs[k])))
    return acc


def cubic_spline_line_integral_direct_raw(u, deg: int):
    """Unmasked direct-fit Horner poly(min(u, 1)) of degree ``deg``, with no
    out-of-support zeroing (callers fuse the u < 1 test into their mask)."""
    u = torch.as_tensor(u, dtype=torch.float32)
    t = 2.0 * torch.clamp(u, max=1.0) - 1.0
    return _horner(t, direct_coeffs(deg), deg)


def cubic_spline_line_integral_horner1(u, deg: int = HORNER1_DEG):
    """F(beta) from u = beta^2 via a single-piece Horner form.

      deg > 0   weighted fit of F / v^3.5 times the v^3 sqrt(v) prefactor
                (vanishes for u >= 1; u is clamped at 1).
      deg < 0   direct fit of F of degree |deg|, zeroed for u >= 1.
    """
    u = torch.as_tensor(u, dtype=torch.float32)
    if deg < 0:
        d = -deg
        t = 2.0 * torch.clamp(u, max=1.0) - 1.0
        acc = _horner(t, direct_coeffs(d), d)
        return torch.where(u < 1.0, acc, 0.0)
    u = torch.clamp(u, max=1.0)
    t = 2.0 * u - 1.0
    acc = _horner(t, horner1_coeffs(deg), deg)
    v = torch.clamp(1.0 - u, min=0.0)
    return acc * ((v * v) * (v * sqrt(v)))


def cubic_spline_line_integral_horner(u) -> torch.Tensor:
    """F(beta) from u = beta^2 via the unified select-Horner form of degree
    ``HORNER_DEG``: per element the coefficients of its piece, one Horner
    recurrence, and the v^3 sqrt(v) prefactor on piece 2, which vanishes
    for u >= 1 (u is clamped at 1, so a far primitive's u cannot overflow
    the powers). Each step is a multiply and then an add, as in
    ``grace_tpu``'s eager call; the square root is correctly rounded."""
    u = torch.clamp(torch.as_tensor(u, dtype=torch.float32), max=1.0)
    piece1 = u <= 0.25
    f32 = lambda c: float(np.float32(c))
    pick = lambda c1, c2: torch.where(piece1, f32(c1), f32(c2))
    a = pick(1.0 / 0.125, -1.0 / 0.375)
    b = pick(-1.0, 0.625 / 0.375)
    t = a * u + b
    acc = pick(_HORNER_C1[HORNER_DEG], _HORNER_C2[HORNER_DEG])
    for k in range(HORNER_DEG - 1, -1, -1):
        acc = acc * t + pick(_HORNER_C1[k], _HORNER_C2[k])
    v = torch.clamp(1.0 - u, min=0.0)
    return torch.where(piece1, acc, acc * ((v * v) * (v * sqrt(v))))


# Separable rank-K bases of the splat renderer: F(sqrt(x^2 + y^2)) ~=
# sum_k a_k(t_x) b_k(t_y), with a_k(t) = (1 - t) q_k(t), t = min(x^2, 1).
# Coefficients are f64 [rank, deg + 1], monomial in t.
SPLAT_RANK = 5
SPLAT_DEG = 10
SPLAT_DEG8 = 8


def _splat_footprint(n: int):
    x = np.linspace(-1.0, 1.0, n + 1)[:-1] + 1.0 / (n + 1)
    t = x * x
    beta2 = t[:, None] + t[None, :]
    beta = np.sqrt(beta2)
    xi = np.clip(beta, 0.0, 1.0) * (N_DENSE - 1)
    i0 = np.minimum(xi.astype(int), N_DENSE - 2)
    fr = xi - i0
    G = np.where(beta2 >= 1.0, 0.0,
                 DENSE_KERNEL_INTEGRAL_TABLE[i0] * (1.0 - fr)
                 + DENSE_KERNEL_INTEGRAL_TABLE[i0 + 1] * fr)
    return t, G


def fit_splat_basis(rank: int = SPLAT_RANK, deg: int = SPLAT_DEG, n: int = 1024):
    """Per-eigenvector polynomial fit of the separable footprint (deg10)."""
    t, G = _splat_footprint(n)
    m = 1.0 - t
    Q = G / (m[:, None] * m[None, :])
    lam, V = np.linalg.eigh(Q)
    order = np.argsort(-np.abs(lam))
    lam, V = lam[order[:rank]], V[:, order[:rank]]
    a = np.zeros((rank, deg + 1))
    b = np.zeros((rank, deg + 1))
    for k in range(rank):
        c = np.polynomial.chebyshev.Chebyshev.fit(t, V[:, k], deg, w=m)
        q = c.convert(kind=np.polynomial.Polynomial).coef
        q = np.pad(q, (0, deg + 1 - q.size))
        root = np.sqrt(np.abs(lam[k]))
        a[k] = q * root * np.sign(lam[k])
        b[k] = q * root
    return a, b


def fit_splat_basis_joint(rank: int = SPLAT_RANK, deg: int = 8,
                          n: int = 1024, n_irls: int = 8):
    """Jointly optimal rank-r polynomial-separable fit (deg8), with IRLS
    reweighting toward minimax."""
    t, G = _splat_footprint(n)
    P = np.vander(t, deg + 1, increasing=True)
    U0 = (1.0 - t)[:, None] * P
    w = np.ones(n)
    best = None
    for _ in range(n_irls):
        Uw = w[:, None] * U0
        Gw = w[:, None] * G * w[None, :]
        Q, R = np.linalg.qr(Uw)
        Y = Q.T @ Gw @ Q
        Y = 0.5 * (Y + Y.T)
        lam, V = np.linalg.eigh(Y)
        order = np.argsort(-np.abs(lam))[:rank]
        lam, V = lam[order], V[:, order]
        Rinv = np.linalg.inv(R)
        Ca = Rinv @ V * (np.sign(lam) * np.sqrt(np.abs(lam)))[None, :]
        Cb = Rinv @ V * np.sqrt(np.abs(lam))[None, :]
        err = np.abs((U0 @ Ca) @ (U0 @ Cb).T - G)
        e = err.max()
        if best is None or e < best[0]:
            best = (e, Ca.T.copy(), Cb.T.copy())
        rowerr = err.max(axis=1)
        w = w * (0.25 + rowerr / (rowerr.mean() + 1e-30)) ** 0.5
        w /= w.mean()
    return best[1], best[2]


SPLAT_A_COEFFS, SPLAT_B_COEFFS = _cached_fit_multi(
    ["splat_a", "splat_b"], fit_splat_basis)
SPLAT_A8_COEFFS, SPLAT_B8_COEFFS = _cached_fit_multi(
    ["splat_a8", "splat_b8"], lambda: fit_splat_basis_joint(SPLAT_RANK, SPLAT_DEG8))

# basis name -> (deg, a f64[rank, deg + 1], b f64[rank, deg + 1])
SPLAT_BASES = {
    "deg10": (SPLAT_DEG, SPLAT_A_COEFFS, SPLAT_B_COEFFS),
    "deg8": (SPLAT_DEG8, SPLAT_A8_COEFFS, SPLAT_B8_COEFFS),
}


def splat_basis_reference(x, y) -> np.ndarray:
    """The fitted separable model (the deg10 basis) at pixel offsets (x, y),
    evaluated in numpy f64: the reference that bounds |model - F|."""
    def side(coeffs, t):
        t = np.clip(np.asarray(t, np.float64) ** 2, 0.0, 1.0)
        return np.stack([np.polynomial.polynomial.polyval(t, c) * (1.0 - t) for c in coeffs],
                        axis=-1)

    return np.sum(side(SPLAT_A_COEFFS, x) * side(SPLAT_B_COEFFS, y), axis=-1)
