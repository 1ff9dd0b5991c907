"""Spherical-uniformity statistics for ray directions (PyTorch counterpart
of ``grace_tpu.rays.statistics``): Rayleigh z, Beran An, Gine Gn and
Fn = An + Gn, Ripley's K on the sphere, and their critical values
(Keilson et al. 1983 / chi-squared(3)).

The O(n^2) pair sums run on the directions' device in blocks of rows: each
block a [B, n] product ``rows @ d.T``, clipped, then ``acos`` and ``sin``
(An, Gn, in f64) or compares against the thresholds (K, in full f32 by
``matmul_f32``: never TF32), each block reduced on the device.
``grace_tpu`` sums in f32 and is about 1e-4 relative from the f64 values
at n = 4096.

An and Gn are statistics of points on the unit sphere, and three things
move them by more than f32 terms can afford (An and Gn are n minus sums of
n^2 terms, so a relative error e of a sum moves them by e n / 2 to e n):

  * the directions' norms. An f32 direction's |d|^2 is off 1 by up to a
    few 1e-7 (a rotation in f32 scales the HEALPix set by about 1 - 2e-7),
    and Gn moves by about n (|d|^2 - 1) / 2: a few hundredths at
    n = 196,608, more than the statistic. So the pair terms are taken
    between the directions normalized in f64;
  * pairs near parallel or antipodal, where acos is ill-conditioned: an
    error e of an f32 dot product moves psi by e / sin psi, and by
    sqrt(2 e) at |x| = 1 (a HEALPix set holds every antipode);
  * the f32 acos and sin themselves: a bias of a fraction of an ulp a
    term, invisible in one term, is a bias of the sum, and the sum is
    what An and Gn keep.

So the pair terms are formed in f64 throughout: dot products of the
normalized directions, acos, sin, and the sums. The blocks are bound by
memory, not by the f64 arithmetic, so this costs about what f32 did on
the card. The pair (i, i) adds exactly 0, as the definition over i != j
has it (``grace_tpu`` adds acos(|d|^2), up to 3.5e-4 a pair in f32).

Ripley's K counts the raw directions' dot products, as ``grace_tpu`` does
(bit-equal below 2^24 pairs).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from grace_tpu_torch.core.types import creation_device
from grace_tpu_torch.ops.vecmath import matmul_f32

# Critical values: reject uniformity when exceeded.
RAYLEIGH_Z_CRIT = {0.05: 7.815, 0.01: 11.35}          # chi^2, 3 dof
BERAN_AN_CRIT = {0.2: 1.414, 0.05: 2.207, 0.01: 3.090}
GINE_GN_CRIT = {0.2: 0.646, 0.05: 0.884, 0.01: 1.135}
GINE_FN_CRIT = {0.2: 1.948, 0.05: 2.748, 0.01: 3.633}

# Elements of one block's [..., B, n] product (256 MB in f64).
BLOCK_ELEMENTS = 1 << 25


def _directions(directions) -> torch.Tensor:
    """f32[n, 3] on the directions' device if a tensor, else on the card."""
    return torch.as_tensor(directions, dtype=torch.float32,
                           device=creation_device(like=directions))


def _cos_f32(angles: torch.Tensor) -> torch.Tensor:
    """f32 cosine rounded from f64 (XLA's f32 cos agrees with it on the
    default scales; torch's f32 cos differs by an ulp on one of them)."""
    return torch.cos(angles.double()).float()


def rayleigh_z(directions) -> torch.Tensor:
    """z = 3 R^2 / n with R the resultant length."""
    d = _directions(directions)
    s = d.sum(dim=0, dtype=torch.float64)
    return (3.0 * (s * s).sum() / d.shape[0]).float()


def _row_blocks(n: int, batch: int = 1):
    rows = max(1, min(n, BLOCK_ELEMENTS // max(1, batch * n)))
    return range(0, n, rows), rows


def _pair_sums(directions):
    """(sum of psi_ij, sum of sin psi_ij) over ordered pairs i != j of the
    directions normalized, all in f64."""
    d = _directions(directions).double()
    u = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    n = u.shape[0]
    psi_s = torch.zeros((), dtype=torch.float64, device=u.device)
    sin_s = torch.zeros((), dtype=torch.float64, device=u.device)
    starts, rows = _row_blocks(n)
    for b0 in starts:
        dots = (u[b0:b0 + rows] @ u.T).clamp_(-1.0, 1.0)     # [B, n]
        k = torch.arange(dots.shape[0], device=u.device)
        dots[k, b0 + k] = 1.0
        psi = dots.acos_()
        psi_s += psi.sum()
        sin_s += psi.sin_().sum()
    return psi_s, sin_s


def beran_gine_statistics(directions) -> Dict[str, torch.Tensor]:
    """An (asymmetric alternatives), Gn (symmetric), Fn = An + Gn, f32."""
    n = _directions(directions).shape[0]
    psi_sum, sin_sum = _pair_sums(directions)
    # The statistics are defined over unordered pairs i < j.
    coeff = 4.0 / (n * math.pi)
    an = n - coeff * (psi_sum * 0.5)
    gn = n / 2.0 - coeff * (sin_sum * 0.5)
    return {"An": an.float(), "Gn": gn.float(), "Fn": (an + gn).float()}


def _ripley_counts(d: torch.Tensor, cos_th: torch.Tensor) -> torch.Tensor:
    """int64[C, S]: ordered pairs (i, j), i == j included, of each of the C
    bundles d[c] (f32[C, n, 3]) with clip(d_i . d_j) >= cos_th[s]."""
    c, n, _ = d.shape
    counts = torch.zeros((c, cos_th.shape[0]), dtype=torch.int64, device=d.device)
    dt = d.transpose(1, 2)
    starts, rows = _row_blocks(n, c)
    for b0 in starts:
        block = d[:, b0:b0 + rows]
        dots = torch.clamp(matmul_f32(block, dt), -1.0, 1.0).reshape(c, -1)
        for s in range(cos_th.shape[0]):
            counts[:, s] += (dots >= cos_th[s]).sum(dim=1)
    return counts


def _ripley_k(d: torch.Tensor, angles) -> torch.Tensor:
    """f32[C, S]: Ripley's K of each bundle d[c] (f32[C, n, 3])."""
    n = d.shape[1]
    angles = torch.as_tensor(angles, dtype=torch.float32, device=d.device)
    counts = _ripley_counts(d, _cos_f32(angles))
    # Each point counts itself at every angle; K divides by n x density.
    scale = float(np.float32(n * (n / (4.0 * math.pi))))
    return ((counts - n).double() / scale).float()


def ripley_k_sphere(directions, angles) -> torch.Tensor:
    """Ripley's K on the sphere: the mean number of other points within
    angular distance psi of a point, over the point density n / (4 pi).
    Under uniformity K(psi) = 2 pi (1 - cos psi). f32[S], one per angle."""
    return _ripley_k(_directions(directions)[None], angles)[0]


def ripley_k_uniform(angles, device=None) -> torch.Tensor:
    """Expected K under uniformity: 2 pi (1 - cos psi), f32[S] (on angles'
    device if a tensor, else on ``device``, default the CUDA card)."""
    a = torch.as_tensor(angles, dtype=torch.float32,
                        device=creation_device(device, like=angles))
    return (1.0 - _cos_f32(a)) * (2.0 * math.pi)


def uniformity_report(directions) -> Dict[str, float]:
    stats = {"z": float(rayleigh_z(directions))}
    stats.update({k: float(v) for k, v in beran_gine_statistics(directions).items()})
    return stats
