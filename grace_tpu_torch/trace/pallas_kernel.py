"""Fused SPH trace: quarter-culled ray tiles through a hand-written CUDA kernel.

PyTorch counterpart of ``grace_tpu.trace.pallas_kernel``. The name
``pallas_trace_sph`` is kept so the two packages line up; in this package
it denotes the CUDA-backed fused trace (``csrc/trace_quarter.cu``), not a
Pallas kernel. Two stages:

  broadphase  ``dense_tile_masks_quarter``: per ray tile, one bit for each
              32-primitive quarter of the Morton-sorted particles whose AABB
              overlaps the tile's ray hull, plus a summary bit per nonzero
              word (pallas_broadphase.py).
  kernel      one CUDA block per ray tile walks the summary bits, the word
              bits and the quarter bits in ascending order and accumulates
              each ray's column density (or hit count) over the listed
              quarters' primitives.

On a CPU tensor the wrapper runs ``_trace_quarter_plain`` instead, the
PyTorch version the tests hold against ``grace_tpu`` and the kernel.

Layouts (as ``grace_tpu``'s):
  rays  f32[R_pad, 16]   one row per ray (o, d, 1/d, len, pad).
  prims f32[8, N_pad]    component-major (x, y, z, h, 1/h^2, h^2, 0, 0);
                         h = 0 padding can never hit.
  out   f32[R_pad]       per-ray value; hit counts convert to int32.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from grace_tpu_torch import _kernels
from grace_tpu_torch.core.tree import Tree
from grace_tpu_torch.core.types import Rays
from grace_tpu_torch.ops.vecmath import fma
from grace_tpu_torch.sph.kernel_integrals import (
    HORNER1_DEG, cubic_spline_line_integral_direct_raw,
    cubic_spline_line_integral_horner1, integral_coeffs)
from grace_tpu_torch.trace.pallas_broadphase import dense_tile_masks_quarter

DEFAULT_TILE = 512
SEG = 128  # primitive padding granularity
MAX_TILE = 1024  # rays per CUDA block (threads)
MODES = ("cumulative", "hitcount")


def _pad_rays(rays: Rays, tile: int) -> Rays:
    """Pad to whole tiles with never-hit rays (length -1) that share the
    last ray's origin and direction, so the last tile's AABB stays tight."""
    pad = (-rays.n_rays) % tile
    if not pad:
        return rays
    return Rays(torch.cat([rays.origins, rays.origins[-1:].expand(pad, 3)]),
                torch.cat([rays.directions, rays.directions[-1:].expand(pad, 3)]),
                torch.cat([rays.lengths, rays.lengths.new_full((pad,), -1.0)]))


def _pack_rays(rays: Rays, tile: int):
    """f32[R_pad, 16] rows (ox, oy, oz, dx, dy, dz, 1/dx, 1/dy, 1/dz, len,
    0...); padding rays have length -1 (never hit)."""
    n = rays.n_rays
    pad = (-n) % tile
    o = torch.nn.functional.pad(rays.origins, (0, 0, 0, pad))
    d = torch.nn.functional.pad(rays.directions, (0, 0, 0, pad), value=1.0)
    ln = torch.nn.functional.pad(rays.lengths, (0, pad), value=-1.0)
    inv = 1.0 / d
    cols = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
            inv[:, 0], inv[:, 1], inv[:, 2], ln]
    packed = torch.stack(cols + [torch.zeros_like(ln)] * (16 - len(cols)), dim=1)
    return packed, n + pad


def _pack_prims(spheres: torch.Tensor):
    """Component-major f32[8, N_pad]: x, y, z, h, 1/h^2 (0 where h = 0),
    h^2, 0, 0, padded with h = 0 to a SEG multiple."""
    n = spheres.shape[0]
    n_pad = ((n + SEG - 1) // SEG) * SEG
    pt = torch.nn.functional.pad(spheres, (0, 0, 0, n_pad - n)).t()
    h = pt[3:4, :]
    h2 = h * h
    inv_h2 = torch.where(h2 > 0.0, 1.0 / torch.clamp(h2, min=1e-30), 0.0)
    zeros = torch.zeros_like(h)
    return torch.cat([pt, inv_h2, h2, zeros, zeros], dim=0).contiguous(), n_pad


def _seg_compute(ox, oy, oz, dx, dy, dz, ln, px, py, pz, inv_h2, h2, mode,
                 integral_deg=HORNER1_DEG):
    """Per-pair contributions of rays (column tensors) against primitives
    (row tensors): the plain version of ``csrc/seg_compute.cuh``, with the
    fused multiply-adds at the same places."""
    rx = px - ox
    ry = py - oy
    rz = pz - oz
    dot = fma(rz, dz, fma(rx, dx, ry * dy))
    bx = fma(-dot, dx, rx)
    by = fma(-dot, dy, ry)
    bz = fma(-dot, dz, rz)
    b2 = fma(bz, bz, fma(bx, bx, by * by))
    along = (dot >= 0.0) & (dot < ln)
    if mode == "hitcount":
        return ((b2 < h2) & along).to(torch.float32)
    u = b2 * inv_h2
    if integral_deg < 0:
        f = cubic_spline_line_integral_direct_raw(u, -integral_deg)
        return torch.where(along & (u < 1.0), f * inv_h2, 0.0)
    f = cubic_spline_line_integral_horner1(u, deg=integral_deg)
    return torch.where(along, f * inv_h2, 0.0)


def _listed_quarters(summary_row, words_row):
    """Ascending quarter ids a tile's summary and words list."""
    bits = torch.arange(32, device=words_row.device)
    n_words = words_row.shape[0]
    sbit = ((summary_row[:, None] >> bits) & 1).reshape(-1)[:n_words].bool()
    w_ids = torch.nonzero(sbit).flatten()
    qbit = ((words_row[w_ids][:, None] >> bits) & 1).bool()
    return (w_ids[:, None] * 32 + bits)[qbit]


def _trace_quarter_plain(summary, words, rays_packed, prims, integral_deg, mode):
    """Plain PyTorch version of the quarter kernel (one tile at a time)."""
    n_tiles = words.shape[0]
    tile = rays_packed.shape[0] // n_tiles
    out = torch.zeros(rays_packed.shape[0], dtype=torch.float32,
                      device=rays_packed.device)
    lanes = torch.arange(32, device=prims.device)
    for t in range(n_tiles):
        q = _listed_quarters(summary[t], words[t])
        if q.numel() == 0:
            continue
        p = (q[:, None] * 32 + lanes).flatten()
        slab = prims[:, p]
        r = rays_packed[t * tile:(t + 1) * tile]
        col = lambda k: r[:, k:k + 1]
        contrib = _seg_compute(col(0), col(1), col(2), col(3), col(4), col(5),
                               col(9), slab[0], slab[1], slab[2], slab[4],
                               slab[5], mode, integral_deg)
        out[t * tile:(t + 1) * tile] = contrib.sum(dim=1)
    return out


@functools.lru_cache(maxsize=None)
def _coeff_tensor(integral_deg: int, device: str) -> torch.Tensor:
    return torch.from_numpy(integral_coeffs(integral_deg)).to(device)


def trace_quarter(summary, words, rays_packed, prims, integral_deg, mode):
    """Per-ray column density / hit count over the quarters each tile's
    masks list: launches ``csrc/trace_quarter.cu`` on CUDA tensors, runs
    ``_trace_quarter_plain`` on CPU tensors.

    Args:
      summary: i32[n_tiles, ceil(n_words / 32)].
      words: i32[n_tiles, n_words], bit q of word w = quarter w*32+q.
      rays_packed: f32[n_tiles * tile, 16] (``_pack_rays``).
      prims: f32[8, N_pad] (``_pack_prims``); n_words = ceil(N_pad / 1024).
      integral_deg, mode: as ``pallas_trace_sph``.

    Returns f32[n_tiles * tile].
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    devs = {x.device for x in (summary, words, rays_packed, prims)}
    if len(devs) != 1:
        raise ValueError(f"trace_quarter: tensors on several devices {devs}")
    n_tiles, n_words = words.shape
    if (summary.dtype != torch.int32 or words.dtype != torch.int32
            or rays_packed.dtype != torch.float32 or prims.dtype != torch.float32):
        raise TypeError("trace_quarter: expected i32 masks and f32 rays/prims")
    if (summary.shape != (n_tiles, (n_words + 31) // 32) or n_tiles == 0
            or rays_packed.shape[0] % n_tiles or rays_packed.shape[1] != 16
            or prims.shape[0] != 8 or prims.shape[1] % SEG
            or n_words != (prims.shape[1] // 32 + 31) // 32):
        raise ValueError("trace_quarter: inconsistent shapes "
                         f"{summary.shape} {words.shape} {rays_packed.shape} {prims.shape}")
    tile = rays_packed.shape[0] // n_tiles
    device = devs.pop()
    if device.type == "cpu":
        return _trace_quarter_plain(summary, words, rays_packed, prims,
                                    integral_deg, mode)
    if device.type != "cuda":
        raise ValueError(f"trace_quarter: unsupported device {device}")
    if tile > MAX_TILE:
        raise ValueError(f"tile {tile} > {MAX_TILE} rays per block")
    args = [t.contiguous() for t in (summary, words, rays_packed, prims)]
    coeffs = _coeff_tensor(integral_deg, str(device))
    out = torch.empty(rays_packed.shape[0], dtype=torch.float32, device=device)
    _kernels.launch(
        "trace_quarter", "grace_trace_quarter", device,
        *[a.data_ptr() for a in args], coeffs.data_ptr(), out.data_ptr(),
        n_tiles, tile, summary.shape[1], n_words, prims.shape[1],
        integral_deg, MODES.index(mode))
    trace_quarter.launches += 1
    return out


trace_quarter.launches = 0


def pallas_trace_sph(
    rays: Rays,
    spheres: torch.Tensor,
    tree: Tree | None = None,
    tile: int = DEFAULT_TILE,
    max_chunks: int = 2048,
    mode: str = "cumulative",
    stack_size: int = 128,
    broadphase: str = "dense",
    vmem_resident_limit: int = 48 * 1024 * 1024,
    subtiles: int = 1,
    unroll: int = 16,
    masks: torch.Tensor | None = None,
    integral_deg: int = HORNER1_DEG,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Column density (mode='cumulative') or hit counts (mode='hitcount')
    per ray: broadphase + fused CUDA trace kernel.

    Same signature as ``grace_tpu``'s, minus ``interpret``. Returns
    (per_ray_values f32/i32[R], overflow bool[n_tiles]); the quarter route
    never overflows. Only ``broadphase="quarter"`` is ported so far; every
    other route raises NotImplementedError. ``vmem_resident_limit``
    selected TPU residency: here the particle slabs stay in device memory
    either way and one kernel serves both regimes, so it only has to be
    non-negative. ``tree``, ``max_chunks``, ``stack_size``, ``subtiles``,
    ``unroll`` and ``masks`` are not read by the quarter route (as in
    ``grace_tpu``). ``integral_deg`` selects the line-integral flavor
    (see ``kernel_integrals.cubic_spline_line_integral_horner1``).
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if broadphase != "quarter":
        raise NotImplementedError(
            f"broadphase={broadphase!r} is not ported yet (ROADMAP queue A "
            "items 8-9, kernels B5-B10); use broadphase='quarter'")
    if vmem_resident_limit < 0:
        raise ValueError("vmem_resident_limit must be >= 0")
    n_rays = rays.n_rays
    rays = _pad_rays(rays, tile)
    packed, r_pad = _pack_rays(rays, tile)
    prims, _ = _pack_prims(spheres)
    words, summary = dense_tile_masks_quarter(rays, spheres, tile)
    values = trace_quarter(summary, words, packed, prims, integral_deg, mode)[:n_rays]
    if mode == "hitcount":
        values = values.to(torch.int32)
    return values, torch.zeros(r_pad // tile, dtype=torch.bool, device=values.device)
