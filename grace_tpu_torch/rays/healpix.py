"""HEALPix NESTED pixel-center ray vectors (PyTorch counterpart of
``grace_tpu.rays.healpix``).

The nested scheme is bit de-interleaving onto the 12 base faces followed by
the standard ring geometry, valid for nside a power of two up to 8192. The
integer stage runs in int64 (torch lacks most uint32 operators), so face,
x, y, ring and ring position are exact. The float stage follows
``grace_tpu``'s operations; its f32 cos and sin may differ from XLA's by an
ulp, so the vectors agree to about 1e-6, not bit for bit.

``healpix_rays`` gives 12 * nside^2 isotropically distributed unit vectors,
optionally rotated by a uniformly random rotation (a uniform quaternion
drawn from a ``torch.Generator``).
"""

from __future__ import annotations

import math

import torch

from grace_tpu_torch.core.types import Rays, creation_device
from grace_tpu_torch.ops.vecmath import matmul_f32
from grace_tpu_torch.rays.gen import _draw

_JRLL = (2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4)
_JPLL = (1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7)


def _compact_bits(v: torch.Tensor) -> torch.Tensor:
    """Inverse of bit spreading by one: keep the even bits of the low 32,
    moved to the low half (int64 in, int64 out)."""
    v = v & 0x55555555
    v = (v | (v >> 1)) & 0x33333333
    v = (v | (v >> 2)) & 0x0F0F0F0F
    v = (v | (v >> 4)) & 0x00FF00FF
    v = (v | (v >> 8)) & 0x0000FFFF
    return v


def _nest_rings(nside: int, ipix: torch.Tensor):
    """The integer stage of ``pix2vec_nest``, int64[N] each: (face, x, y,
    ring jr, ring size nr, kshift, ring position jp)."""
    dev = ipix.device
    npface = nside * nside
    face = torch.div(ipix, npface, rounding_mode="floor")
    pf = ipix % npface
    x = _compact_bits(pf)
    y = _compact_bits(pf >> 1)
    jr = torch.tensor(_JRLL, dtype=torch.int64, device=dev)[face] * nside - x - y - 1
    north = jr < nside
    south = jr > 3 * nside
    nr = torch.where(north, jr, torch.where(south, 4 * nside - jr,
                                            torch.full_like(jr, nside)))
    kshift = torch.where(north | south, torch.zeros_like(jr), (jr - nside) & 1)
    jpll = torch.tensor(_JPLL, dtype=torch.int64, device=dev)[face]
    jp = torch.div(jpll * nr + x - y + 1 + kshift, 2, rounding_mode="floor")
    jp = torch.where(jp > 4 * nr, jp - 4 * nr, jp)
    jp = torch.where(jp < 1, jp + 4 * nr, jp)
    return face, x, y, jr, nr, kshift, jp


def pix2vec_nest(nside: int, ipix, device=None) -> torch.Tensor:
    """Unit vectors of NESTED-scheme pixel centers; ipix: int[N] -> f32[N, 3]
    (on ipix's device if it is a tensor, else on ``device``, default the
    CUDA card)."""
    if nside & (nside - 1) or nside <= 0 or nside > 8192:
        raise ValueError("nside must be a power of two in [1, 8192]")
    dev = creation_device(device, like=ipix)
    ipix = torch.as_tensor(ipix, device=dev).to(torch.int64)
    _, _, _, jr, nr, kshift, jp = _nest_rings(nside, ipix)
    north = jr < nside
    south = jr > 3 * nside
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    fnr = nr.to(torch.float32)
    z_pole = 1.0 - fnr * fnr / f32(3.0 * nside * nside)
    z_eq = (2.0 * nside - jr.to(torch.float32)) * f32(2.0 / (3.0 * nside))
    z = torch.where(north, z_pole, torch.where(south, -z_pole, z_eq))
    phi = ((jp.to(torch.float32) - (kshift.to(torch.float32) + 1.0) * 0.5)
           * (f32(math.pi / 2) / fnr))
    st = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), z], dim=-1)


def _rotation_from_quaternion(q: torch.Tensor) -> torch.Tensor:
    """f32[3, 3] rotation of the normalized quaternion (w, x, y, z) = q."""
    q = q / torch.sqrt(torch.sum(q * q))
    w, xq, yq, zq = q
    return torch.stack([
        torch.stack([1 - 2 * (yq * yq + zq * zq), 2 * (xq * yq - zq * w),
                     2 * (xq * zq + yq * w)]),
        torch.stack([2 * (xq * yq + zq * w), 1 - 2 * (xq * xq + zq * zq),
                     2 * (yq * zq - xq * w)]),
        torch.stack([2 * (xq * zq - yq * w), 2 * (yq * zq + xq * w),
                     1 - 2 * (xq * xq + yq * yq)]),
    ])


def random_rotation_matrix(generator, device=None) -> torch.Tensor:
    """Uniform random rotation from a uniform quaternion (4 standard
    normals, normalized), drawn from ``generator``."""
    return _rotation_from_quaternion(_draw(generator, torch.randn, (4,),
                                           creation_device(device)))


def healpix_rays(generator, nside: int, origin, length, rotate: bool = True,
                 device=None) -> Rays:
    """12 * nside^2 rays along NESTED pixel-center directions from one
    origin, rotated by ``random_rotation_matrix(generator)`` unless
    ``rotate=False``."""
    device = creation_device(device)
    n = 12 * nside * nside
    vec = pix2vec_nest(nside, torch.arange(n, dtype=torch.int64, device=device))
    if rotate:
        vec = matmul_f32(vec, random_rotation_matrix(generator, device).T)
    origins = torch.as_tensor(origin, dtype=torch.float32, device=device).expand(n, 3)
    return Rays(origins.contiguous(), vec,
                torch.full((n,), float(length), dtype=torch.float32, device=device))
