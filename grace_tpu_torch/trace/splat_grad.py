"""Differentiable splatting: sort-free forward and segment-major backward.

PyTorch counterpart of ``grace_tpu.trace.splat_grad``, the training-grade
splat pipeline: neither direction sorts or scatters.

  forward   particles stay in Morton order; the broadphase is the projected
            bbox of each 128-particle segment against each pixel tile,
            packed into i32 words. Out-of-tile particles of an overlapped
            segment add exactly zero (the separable basis carries a
            (1 - t) factor that vanishes for |dx| >= h), so no instance
            masks are needed. Kernel: ``csrc/splat_sortfree.cu``
            (``splat_sortfree_fwd``): tiles with the most listed segments
            first, each particle's terms only inside its footprint.
  backward  the gradient of I = sum_k A_k diag(s) B_k^T with respect to the
            per-particle projections is itself a rank-K contraction of the
            cotangent tile G with the factors and their analytic
            t-derivatives (M_k = G^T A_k, N_k = G B_k). Segment-major: one
            CUDA block owns one segment's gradient and walks the tiles of
            its transposed bitmask row, so every (tile, segment) pair is
            visited once, with no atomics and no list capacity
            (``splat_sortfree_bwd``): each particle's terms only inside
            its footprint.

The chain from (g_pu, g_pv, g_t2, g_scale) back to spheres and weights is
elementwise PyTorch outside the kernels. On CPU tensors each kernel wrapper
runs its plain PyTorch version.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from grace_tpu_torch import _kernels
from grace_tpu_torch.ops.vecmath import dot3, fma, matmul_f32
from grace_tpu_torch.sph.kernel_integrals import SPLAT_BASES
from grace_tpu_torch.trace.pallas_broadphase import pack_overlap_bits
from grace_tpu_torch.trace.pallas_kernel import _set_bits
from grace_tpu_torch.trace.splat import _camera_frame, _factor, _frozen, _memo, batch_size

SEG = 128  # particles per Morton segment = slab lane width


def _basis_coeffs(basis: str):
    """(deg, a f32[rank, deg + 1], b f32[rank, deg + 1]) of a named
    separable basis: "deg10" (~1e-4 max rel err) or "deg8" (~3.1e-4)."""
    if basis not in SPLAT_BASES:
        raise ValueError(f"unknown basis {basis!r} (expected 'deg10' or 'deg8')")
    deg, a_c, b_c = SPLAT_BASES[basis]
    return deg, np.asarray(a_c, np.float32), np.asarray(b_c, np.float32)


class OrthoCamera(NamedTuple):
    """Static orthographic camera (the same fields as ``grace_tpu``'s, so
    ``OrthoCamera(*cam)`` carries one across)."""

    camera_position: tuple
    look_at: tuple
    view_up: tuple
    vertical_extent: float
    length: float
    resolution_x: int
    resolution_y: int


def _camera_numerics(cam: OrthoCamera, device):
    """(view_dir, v, u, camera position, x0, dx, y0, dy): the camera frame
    and the pixel-center affine maps, pixel (j, i) at (x0 + i dx, y0 + j dy)
    (ray j * W + i of ``orthographic_projection_rays``). x0 and y0 are f32
    tensors; dx and dy Python floats (f64, rounded to f32 where they meet
    a tensor, as in grace_tpu)."""
    view_dir, v, u = _camera_frame(cam.camera_position, cam.look_at, cam.view_up, device)
    c = torch.tensor(cam.camera_position, dtype=torch.float32, device=device)
    w_res, h_res = cam.resolution_x, cam.resolution_y
    half_w = 0.5 * cam.vertical_extent * (w_res / h_res)
    half_h = 0.5 * cam.vertical_extent
    x0 = dot3(c, v) + float(np.float32((2.0 * 0.5 / w_res - 1.0) * half_w))
    y0 = dot3(c, u) + float(np.float32((1.0 - 2.0 * 0.5 / h_res) * half_h))
    dx = 2.0 * half_w / w_res
    dy = -2.0 * half_h / h_res
    return view_dir, v, u, c, x0, dx, y0, dy


def _coords(cam: OrthoCamera, device) -> torch.Tensor:
    """f32[4] (x0, dx, y0, dy), the kernels' pixel-center maps."""
    *_, x0, dx, y0, dy = _camera_numerics(cam, device)
    return torch.stack([x0, x0.new_tensor(dx), y0, y0.new_tensor(dy)])


def project_ortho(spheres, weights, cam: OrthoCamera):
    """Morton-order projections (pu, pv, invh, scale), each f32[n]. scale
    folds the weight, the 1/h^2 normalization and the depth acceptance
    (for a parallel bundle the closest approach is at the particle depth
    for every ray); it is 0 for a dead particle."""
    view_dir, v, u, c, *_ = _camera_numerics(cam, spheres.device)
    pos = spheres[:, :3]
    h = spheres[:, 3]
    pu = dot3(pos, v)
    pv = dot3(pos, u)
    depth = dot3(pos - c, view_dir)
    # Divide by the selected branch, so autograd through the dead branch
    # stays finite (splat_reference_torch differentiates through this).
    inv_h = torch.where(h > 0, 1.0 / torch.where(h > 0, h, 1.0), 0.0)
    live = (h > 0) & (depth >= 0.0) & (depth < cam.length)
    w = torch.ones_like(h) if weights is None else weights
    scale = torch.where(live, w * inv_h * inv_h, 0.0)
    return pu, pv, inv_h, scale


def pack_proj_slabs(pu, pv, invh, scale) -> torch.Tensor:
    """(n_segs, 8, SEG) slabs: rows pu, pv, invh, scale, 4 zero."""
    n = pu.shape[0]
    n_pad = ((n + SEG - 1) // SEG) * SEG
    comp = [torch.nn.functional.pad(a, (0, n_pad - n)) for a in (pu, pv, invh, scale)]
    pt = torch.stack(comp + [torch.zeros_like(comp[0])] * 4)         # (8, n_pad)
    return pt.reshape(8, n_pad // SEG, SEG).permute(1, 0, 2).contiguous()


def _tile_spans(cam: OrthoCamera, tile_w: int, tile_h: int, device):
    """(tx_lo, tx_hi f32[ntx], ty_lo, ty_hi f32[nty]): each pixel tile's
    pixel-center span (tile (r, c) = r * ntx + c)."""
    *_, x0, dx, y0, dy = _camera_numerics(cam, device)
    ntx = cam.resolution_x // tile_h
    nty = cam.resolution_y // tile_w
    cols = torch.arange(ntx, dtype=torch.float32, device=device)
    rows = torch.arange(nty, dtype=torch.float32, device=device)
    f32 = lambda a: float(np.float32(a))
    tx_lo = fma(cols, f32(tile_h * dx), x0)
    tx_hi = fma(cols * tile_h + (tile_h - 1), dx, x0)
    ty_hi = fma(rows, f32(tile_w * dy), y0)                 # dy < 0: top edge
    ty_lo = fma(rows * tile_w + (tile_w - 1), dy, y0)
    return tx_lo, tx_hi, ty_lo, ty_hi


def projected_overlap(pu, pv, invh, scale, cam: OrthoCamera, tile_w: int, tile_h: int):
    """bool[n_tiles, n_segs]: segment projected bbox vs pixel tile, tiles
    row-major (tile (r, c) = r * ntx + c), against the tile's pixel-center
    span (the bbox holds the footprint radius, beyond which the basis is
    exactly zero)."""
    n = pu.shape[0]
    pad = ((n + SEG - 1) // SEG) * SEG - n
    live = scale > 0
    big = 3.4e38
    h_eff = torch.where(live, 1.0 / torch.clamp(invh, min=1e-30), 0.0)
    bound = lambda a, v: torch.nn.functional.pad(torch.where(live, a, v), (0, pad), value=v)
    seg_lo_u = bound(pu - h_eff, big).reshape(-1, SEG).amin(dim=1)
    seg_hi_u = bound(pu + h_eff, -big).reshape(-1, SEG).amax(dim=1)
    seg_lo_v = bound(pv - h_eff, big).reshape(-1, SEG).amin(dim=1)
    seg_hi_v = bound(pv + h_eff, -big).reshape(-1, SEG).amax(dim=1)

    tx_lo, tx_hi, ty_lo, ty_hi = _tile_spans(cam, tile_w, tile_h, pu.device)
    ov_u = (seg_lo_u[None, :] <= tx_hi[:, None]) & (seg_hi_u[None, :] >= tx_lo[:, None])
    ov_v = (seg_lo_v[None, :] <= ty_hi[:, None]) & (seg_hi_v[None, :] >= ty_lo[:, None])
    return (ov_v[:, None, :] & ov_u[None, :, :]).reshape(tx_lo.shape[0] * ty_lo.shape[0], -1)


SETUP_CONSTS = 13  # f32 constants of grace_sortfree_setup (csrc/splat_prep.cu)


_SETUP_CACHE: collections.OrderedDict = collections.OrderedDict()


def _setup_constants_uncached(cam: OrthoCamera, tile_w: int, tile_h: int, device):
    view_dir, v, u, c, *_ = _camera_numerics(cam, device)
    # project_ortho compares depth with cam.length, which torch takes as an
    # f32
    length = torch.tensor([cam.length], dtype=torch.float32, device=device)
    return (torch.cat([view_dir, v, u, c, length]),
            torch.cat(_tile_spans(cam, tile_w, tile_h, device)), _coords(cam, device))


def _setup_constants(cam: OrthoCamera, tile_w: int, tile_h: int, device):
    """(consts f32[13]: view_dir, v, u, camera position, length; spans
    f32[2 ntx + 2 nty]: ``_tile_spans``; coords f32[4]) on ``device``,
    computed by the plain path's torch ops from the caller's camera, once
    per camera, tile shape and device, and cached. The key holds each
    camera value with its type: ``_camera_numerics`` computes in the type
    of ``vertical_extent`` (f32 for an np.float32), so a float and an
    np.float32 of one value are two cameras. A camera given as tensors is
    not cached."""
    device = torch.device(device)
    key = (*(_frozen(a) for a in cam), tile_w, tile_h, device)
    return _memo(_SETUP_CACHE, key,
                 lambda: _setup_constants_uncached(cam, tile_w, tile_h, device))


def _sortfree_setup_plain(spheres, weights, cam: OrthoCamera, tile_w: int, tile_h: int):
    """Plain PyTorch version of ``sortfree_setup``: project_ortho, then
    pack_proj_slabs and the packed projected_overlap and its transpose."""
    proj = project_ortho(spheres, weights, cam)
    overlap = projected_overlap(*proj, cam, tile_w, tile_h)
    return (pack_overlap_bits(overlap), pack_overlap_bits(overlap.t()),
            _coords(cam, spheres.device), pack_proj_slabs(*proj))


def sortfree_setup(spheres, weights, cam: OrthoCamera, tile_w: int = 32, tile_h: int = 128):
    """The sort-free splat's inputs: (masks i32[n_tiles, ceil(n_segs / 32)],
    masks_t i32[n_segs, ceil(n_tiles / 32)], coords f32[4], slabs
    f32[n_segs, 8, 128]), as ``splat_sortfree_fwd`` and
    ``splat_sortfree_bwd`` take them (slab rows 0-3 are ``project_ortho``'s
    pu, pv, invh, scale). One launch of ``csrc/splat_prep.cu``'s
    ``grace_sortfree_setup`` on CUDA tensors (the camera's constants cached
    per camera, tile shape and device); CPU tensors run
    ``_sortfree_setup_plain``."""
    if cam.resolution_x % tile_h or cam.resolution_y % tile_w:
        raise ValueError("resolution must be a multiple of the tile shape")
    device = spheres.device
    if device.type == "cpu":
        return _sortfree_setup_plain(spheres, weights, cam, tile_w, tile_h)
    if device.type != "cuda":
        raise ValueError(f"sortfree_setup: unsupported device {device}")
    _kernels.check_tensors("sortfree_setup", [],
                           [spheres] + ([] if weights is None else [weights]))
    n = spheres.shape[0]
    if spheres.dim() != 2 or spheres.shape[1] != 4 or (
            weights is not None and weights.shape != (n,)):
        raise ValueError(f"sortfree_setup: spheres {tuple(spheres.shape)}, weights "
                         f"{None if weights is None else tuple(weights.shape)}")
    consts, spans, coords = _setup_constants(cam, tile_w, tile_h, device)
    return sortfree_setup_cuda(spheres, weights, consts, spans, coords,
                               cam.resolution_x // tile_h, cam.resolution_y // tile_w)


def sortfree_setup_cuda(spheres, weights, consts, spans, coords, ntx: int, nty: int):
    """``csrc/splat_prep.cu``'s ``grace_sortfree_setup`` on checked CUDA
    tensors: ``sortfree_setup``'s four outputs (``coords`` passed through)."""
    device = spheres.device
    n = spheres.shape[0]
    n_segs = (n + SEG - 1) // SEG
    spheres = _kernels.aligned(spheres)
    slabs = torch.empty((n_segs, 8, SEG), dtype=torch.float32, device=device)
    masks = torch.empty((ntx * nty, (n_segs + 31) // 32), dtype=torch.int32, device=device)
    masks_t = torch.empty((n_segs, (ntx * nty + 31) // 32), dtype=torch.int32, device=device)
    _kernels.launch("splat_prep", "grace_sortfree_setup", device, spheres.data_ptr(),
                    None if weights is None else weights.contiguous().data_ptr(),
                    consts.data_ptr(), spans.data_ptr(), slabs.data_ptr(), masks.data_ptr(),
                    masks_t.data_ptr(), n, ntx, nty)
    sortfree_setup_cuda.launches += 1
    return masks, masks_t, coords, slabs


sortfree_setup_cuda.launches = 0


def sortfree_setup_resources(device) -> dict:
    """What one launch of ``grace_sortfree_setup``'s kernel holds on
    ``device``: ``_kernels.RESOURCE_FIELDS`` and ``local_bytes`` a thread."""
    fields = _kernels.RESOURCE_FIELDS + ("local_bytes",)
    out = (ctypes.c_int * len(fields))()
    _kernels.launch("splat_prep", "grace_sortfree_setup_resources", torch.device(device),
                    ctypes.addressof(out))
    return dict(zip(fields, out))


def _poly_and_deriv(t, coeffs):
    """(values, t-derivatives), each [rank, ...t]: alpha_k(t) = (1 - t) q_k(t)
    for f32 coefficients [rank, deg + 1], the Horner steps as fused
    multiply-adds."""
    m = 1.0 - t
    deg = coeffs.shape[1] - 1
    vals, ders = [], []
    for k in range(coeffs.shape[0]):
        q = torch.full_like(t, float(coeffs[k, deg]))
        dq = torch.zeros_like(t)
        for d in range(deg - 1, -1, -1):
            dq = fma(dq, t, q)
            q = fma(q, t, float(coeffs[k, d]))
        vals.append(q * m)
        ders.append(fma(dq, m, -q))
    return torch.stack(vals), torch.stack(ders)


def _tile_coords(coords, tile, ntx, tile_w, tile_h):
    """(ys f32[tile_w], xs f32[tile_h]) pixel centers of one tile."""
    x0, dx, y0, dy = coords[0], coords[1], coords[2], coords[3]
    dev = coords.device
    row0 = (tile // ntx) * tile_w
    col0 = (tile % ntx) * tile_h
    ys = fma(torch.arange(row0, row0 + tile_w, dtype=torch.float32, device=dev), dy, y0)
    xs = fma(torch.arange(col0, col0 + tile_h, dtype=torch.float32, device=dev), dx, x0)
    return ys, xs


def _sortfree_fwd_plain(masks, coords, slabs, a_c, b_c, ntx, tile_w, tile_h, height, width):
    """Plain PyTorch version of the forward kernel: per pixel tile, the
    particles of its set segments, contracted as one f32 matmul."""
    n_segs = slabs.shape[0]
    img = torch.zeros((height, width), dtype=torch.float32, device=slabs.device)
    rank = a_c.shape[0]
    for t in range(masks.shape[0]):
        segs = _set_bits(masks[t])
        segs = segs[segs < n_segs]
        if segs.numel() == 0:
            continue
        pu, pv, invh, scl = slabs[segs, :4].permute(1, 0, 2).reshape(4, -1)
        ys, xs = _tile_coords(coords, t, ntx, tile_w, tile_h)
        ya = (ys[:, None] - pv) * invh                                 # (TW, n)
        xb = (xs[:, None] - pu) * invh                                 # (TH, n)
        fa = _factor(torch.clamp(ya * ya, max=1.0), a_c)              # (K, TW, n)
        fb = _factor(torch.clamp(xb * xb, max=1.0), b_c) * scl         # (K, TH, n)
        patch = matmul_f32(fa.permute(1, 0, 2).reshape(tile_w, -1),
                            fb.permute(0, 2, 1).reshape(rank * pu.shape[0], tile_h))
        r0, c0 = (t // ntx) * tile_w, (t % ntx) * tile_h
        img[r0:r0 + tile_w, c0:c0 + tile_h] = patch
    return img


def _sortfree_bwd_plain(masks_t, coords, slabs, g_image, a_c, b_c, ntx, tile_w, tile_h):
    """Plain PyTorch version of the backward kernel, one pixel tile at a
    time over the segments whose transposed row lists it: M_k = G^T A_k
    and N_k = G B_k as f32 matmuls, each particle's sums added in
    ascending tile order. Particles with scale 0 get zero rows."""
    n_segs = slabs.shape[0]
    n_tiles = (g_image.shape[0] // tile_w) * ntx
    dev = slabs.device
    acc = torch.zeros((4, n_segs * SEG), dtype=torch.float32, device=dev)
    flat = slabs[:, :4].permute(1, 0, 2).reshape(4, -1)
    lanes = torch.arange(SEG, device=dev)
    for t in range(n_tiles):
        listed = ((masks_t[:, t // 32] >> (t % 32)) & 1).bool()
        segs = torch.nonzero(listed).flatten()
        if segs.numel() == 0:
            continue
        pid = (segs[:, None] * SEG + lanes).flatten()
        pu, pv, invh, _ = flat[:, pid]
        ys, xs = _tile_coords(coords, t, ntx, tile_w, tile_h)
        r0, c0 = (t // ntx) * tile_w, (t % ntx) * tile_h
        g = g_image[r0:r0 + tile_w, c0:c0 + tile_h]
        ya = (ys[:, None] - pv) * invh                                 # (TW, P)
        ya2 = ya * ya
        in_y = (ya2 < 1.0).to(torch.float32)
        a_v, a_d = _poly_and_deriv(torch.clamp(ya2, max=1.0), a_c)     # (K, TW, P)
        xb = (xs[:, None] - pu) * invh                                 # (TH, P)
        xb2 = xb * xb
        in_x = (xb2 < 1.0).to(torch.float32)
        b_v, b_d = _poly_and_deriv(torch.clamp(xb2, max=1.0), b_c)     # (K, TH, P)
        m = matmul_f32(g.t(), a_v)                                    # (K, TH, P)
        n = matmul_f32(g, b_v)                                        # (K, TW, P)
        na = n * a_d
        mb = m * b_d
        g_s = (m * b_v).sum(dim=(0, 1))
        g_pv = (na * (-2.0 * ya * invh * in_y)).sum(dim=(0, 1))
        g_pu = (mb * (-2.0 * xb * invh * in_x)).sum(dim=(0, 1))
        g_t2 = (na * (2.0 * ya2 * in_y)).sum(dim=(0, 1)) + (mb * (2.0 * xb2 * in_x)).sum(dim=(0, 1))
        acc.index_add_(1, pid, torch.stack([g_pu, g_pv, g_t2, g_s]))
    scl = flat[3]
    out = torch.where(scl != 0, torch.cat([acc[:3] * scl, acc[3:]]), 0.0)
    out = torch.cat([out, torch.zeros_like(out)])
    return out.reshape(8, n_segs, SEG).permute(1, 0, 2).contiguous()


@functools.lru_cache(maxsize=None)
def _basis_tensor(basis: str, side: str, device: str) -> torch.Tensor:
    _, a_c, b_c = _basis_coeffs(basis)
    return torch.from_numpy(a_c if side == "a" else b_c).to(device)


def _fwd_band(tile_h: int) -> int:
    """Columns a forward block owns: the largest divisor of tile_h up to 32."""
    return max(b for b in range(1, min(32, tile_h) + 1) if tile_h % b == 0)


FWD_BATCH = 64  # particles a batch of the forward kernel (its C entry's sub)
FWD_EXTRA = 64  # the forward's own shared bytes: kept lanes of 8 warps, two rounds


@functools.lru_cache(maxsize=None)
def _byte_popcounts(device: str) -> torch.Tensor:
    return torch.tensor([bin(b).count("1") for b in range(256)], dtype=torch.int32,
                        device=device)


def sortfree_tile_order(masks: torch.Tensor) -> torch.Tensor:
    """Launch order of the forward kernel's pixel tiles: most listed
    segments (set bits of the tile's mask row) first, ties in tile order;
    i32[n_tiles]. A byte table, a sum and a sort: a few small launches."""
    rows = masks.contiguous().view(torch.uint8).long()
    counts = _byte_popcounts(str(masks.device))[rows].sum(dim=1)
    return _kernels.longest_first(counts).to(torch.int32)


def splat_sortfree_fwd(masks, coords, slabs, basis, tile_w, tile_h, height, width):
    """Sort-free splat image f32[height, width] from the tile masks:
    launches ``csrc/splat_sortfree.cu`` on CUDA tensors, runs
    ``_sortfree_fwd_plain`` on CPU tensors.

    Args:
      masks: i32[n_tiles, ceil(n_segs / 32)], bit s of word w of row t =
        segment w*32+s overlaps pixel tile t (row-major tiles).
      coords: f32[4] (x0, dx, y0, dy).
      slabs: f32[n_segs, 8, 128] (``pack_proj_slabs``).
      basis, tile_w (rows per tile), tile_h (columns per tile): as
        ``splat_forward_sortfree``.
    """
    deg, a_c, b_c = _basis_coeffs(basis)
    device = _kernels.check_tensors("splat_sortfree_fwd", [masks], [coords, slabs])
    if height % tile_w or width % tile_h:
        raise ValueError("image size must be a multiple of the tile shape")
    ntx = width // tile_h
    n_tiles = ntx * (height // tile_w)
    n_segs = slabs.shape[0]
    if (slabs.dim() != 3 or tuple(slabs.shape[1:]) != (8, SEG) or coords.shape != (4,)
            or tuple(masks.shape) != (n_tiles, (n_segs + 31) // 32)):
        raise ValueError("splat_sortfree_fwd: inconsistent shapes "
                         f"{[tuple(t.shape) for t in (masks, coords, slabs)]}")
    if device.type == "cpu":
        return _sortfree_fwd_plain(masks, coords, slabs, a_c, b_c, ntx, tile_w, tile_h,
                                   height, width)
    return _sortfree_fwd_launch(masks, coords, slabs, basis, tile_w, tile_h, height, width,
                                sortfree_tile_order(masks))


def _sortfree_fwd_launch(masks, coords, slabs, basis, tile_w, tile_h, height, width, order):
    """``csrc/splat_sortfree.cu``'s forward on ``splat_sortfree_fwd``'s
    checked CUDA inputs, its tiles' blocks launched in ``order`` (i32
    tile indices; None: as listed)."""
    deg, a_c, _ = _basis_coeffs(basis)
    device = masks.device
    band = _fwd_band(tile_h)
    rank = a_c.shape[0]
    sub = batch_size(tile_w, band, rank, deg, FWD_BATCH, extra=FWD_EXTRA)
    if sub < 1:
        raise ValueError(f"splat_sortfree_fwd: tile {tile_w}x{tile_h} too large for a block")
    n_tiles = masks.shape[0]
    if order is not None:
        order = order.to(device=device, dtype=torch.int32).contiguous()
        if order.shape != (n_tiles,):
            raise ValueError(f"splat_sortfree_fwd: order {tuple(order.shape)} for "
                             f"{n_tiles} tiles")
    out = torch.empty((height, width), dtype=torch.float32, device=device)
    masks, coords, slabs = (t.contiguous() for t in (masks, coords, slabs))
    _kernels.launch(
        "splat_sortfree", "grace_splat_sortfree_fwd", device,
        masks.data_ptr(), None if order is None else order.data_ptr(), coords.data_ptr(),
        slabs.data_ptr(), _basis_tensor(basis, "a", str(device)).data_ptr(),
        _basis_tensor(basis, "b", str(device)).data_ptr(), out.data_ptr(),
        n_tiles, masks.shape[1], slabs.shape[0], width // tile_h, tile_w, tile_h, band,
        width, rank, deg, sub)
    splat_sortfree_fwd.launches += 1
    return out


splat_sortfree_fwd.launches = 0


def splat_sortfree_bwd(masks_t, coords, slabs, g_image, basis, tile_w, tile_h):
    """Per-particle projected-space gradients f32[n_segs, 8, 128] (rows
    g_pu * scale, g_pv * scale, g_t2 * scale, g_scale, 4 zero; zero rows
    for particles with scale 0): launches ``csrc/splat_sortfree.cu`` on
    CUDA tensors, runs ``_sortfree_bwd_plain`` on CPU tensors.

    Args:
      masks_t: i32[n_segs, ceil(n_tiles / 32)], the transposed masks (bit t
        of word w of row s = segment s overlaps tile w*32+t).
      coords, slabs, basis, tile_w, tile_h: as ``splat_sortfree_fwd``.
      g_image: f32[height, width], the image cotangent.
    """
    deg, a_c, b_c = _basis_coeffs(basis)
    device = _kernels.check_tensors("splat_sortfree_bwd", [masks_t], [coords, slabs, g_image])
    height, width = g_image.shape if g_image.dim() == 2 else (0, 0)
    if height % tile_w or width % tile_h or height == 0:
        raise ValueError("image size must be a multiple of the tile shape")
    ntx = width // tile_h
    n_tiles = ntx * (height // tile_w)
    n_segs = slabs.shape[0]
    if (slabs.dim() != 3 or tuple(slabs.shape[1:]) != (8, SEG) or coords.shape != (4,)
            or tuple(masks_t.shape) != (n_segs, (n_tiles + 31) // 32)):
        raise ValueError("splat_sortfree_bwd: inconsistent shapes "
                         f"{[tuple(t.shape) for t in (masks_t, coords, slabs, g_image)]}")
    if device.type == "cpu":
        return _sortfree_bwd_plain(masks_t, coords, slabs, g_image, a_c, b_c, ntx,
                                   tile_w, tile_h)
    rank = a_c.shape[0]
    out = torch.empty((n_segs, 8, SEG), dtype=torch.float32, device=device)
    args = [t.contiguous() for t in (masks_t, coords, slabs, g_image)]
    # the C entry refuses a tile whose staged cotangents pass a block's shared memory
    _kernels.launch(
        "splat_sortfree", "grace_splat_sortfree_bwd", device,
        *[t.data_ptr() for t in args], _basis_tensor(basis, "a", str(device)).data_ptr(),
        _basis_tensor(basis, "b", str(device)).data_ptr(), out.data_ptr(),
        n_segs, masks_t.shape[1], n_tiles, ntx, tile_w, tile_h, width, rank, deg)
    splat_sortfree_bwd.launches += 1
    return out


splat_sortfree_bwd.launches = 0


def splat_forward_sortfree(spheres, weights, cam: OrthoCamera, tile_w: int = 32,
                           tile_h: int = 128, basis: str = "deg8"):
    """Sort-free orthographic splat render: f32 image [H, W].

    Prep is projection and the bitmask cull only, no instance sort: the
    forward for moving scenes and training steps. Particles should be
    Morton-sorted (``build_sph_tree`` order); unsorted, the segment cull
    degrades towards every tile times every segment."""
    _basis_coeffs(basis)
    masks, _, coords, slabs = sortfree_setup(spheres, weights, cam, tile_w, tile_h)
    return splat_sortfree_fwd(masks, coords, slabs, basis, tile_w, tile_h, cam.resolution_y,
                              cam.resolution_x)


def splat_backward_sortfree(spheres, weights, g_image, cam: OrthoCamera,
                            tile_w: int = 32, tile_h: int = 128, basis: str = "deg8"):
    """Segment-major splat backward: (g_spheres f32[n, 4], g_weights f32[n]).

    The per-segment tile lists are the transposed bitmask, walked inside
    the kernel, so the backward has no list capacity and cannot truncate."""
    _, masks_t, coords, slabs = sortfree_setup(spheres, weights, cam, tile_w, tile_h)
    grad = splat_sortfree_bwd(masks_t, coords, slabs, g_image.to(torch.float32), basis,
                              tile_w, tile_h)
    n = spheres.shape[0]
    g_pu, g_pv, g_t2, g_s = grad.permute(1, 0, 2).reshape(8, -1)[:4, :n]
    # project_ortho's invh and scale, from the slabs
    invh, scale = slabs[:, 2:4].permute(1, 0, 2).reshape(2, -1)[:, :n]
    # Chain back through the projection, elementwise:
    #   pu = pos . v, pv = pos . u  -> g_pos = g_pu v + g_pv u
    #   t = ((x - p) invh)^2        -> d/dlog(invh) = 2t (= g_t2)
    #   invh = 1/h                  -> g_h += -g_t2 / h
    #   scale = w invh^2 [live]     -> g_w = g_s invh^2, g_h += -2 g_s w invh^3
    # "live" is scale > 0, as in grace_tpu.
    consts = _setup_constants(cam, tile_w, tile_h, spheres.device)[0]
    v, u = consts[3:6], consts[6:9]
    h = spheres[:, 3]
    live = scale > 0
    w = torch.ones_like(h) if weights is None else weights
    g_pos = g_pu[:, None] * v[None, :] + g_pv[:, None] * u[None, :]
    safe_h = torch.clamp(h, min=1e-30)
    g_h = torch.where(live, -g_t2 / safe_h - 2.0 * g_s * w * invh * invh * invh, 0.0)
    g_spheres = torch.cat([g_pos, g_h[:, None]], dim=1)
    g_weights = torch.where(live, g_s * invh * invh, 0.0)
    return g_spheres, g_weights


class _SplatRender(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spheres, weights, cam, tile_w, tile_h, basis):
        ctx.save_for_backward(spheres, weights)
        ctx.config = (cam, tile_w, tile_h, basis)
        return splat_forward_sortfree(spheres, weights, cam, tile_w, tile_h, basis)

    @staticmethod
    def backward(ctx, g):
        spheres, weights = ctx.saved_tensors
        cam, tile_w, tile_h, basis = ctx.config
        gs, gw = splat_backward_sortfree(spheres, weights, g, cam, tile_w, tile_h, basis)
        return (gs if ctx.needs_input_grad[0] else None,
                gw if ctx.needs_input_grad[1] else None, None, None, None, None)


def make_splat_trainer(cam: OrthoCamera, tile_w: int = 32, tile_h: int = 128,
                       basis: str = "deg8"):
    """render(spheres, weights) -> image f32[H, W], differentiable (a
    ``torch.autograd.Function``): gradients flow to particle positions,
    smoothing lengths and weights (``weights`` may be None: all ones).
    Neither direction has a list capacity, so nothing can overflow."""
    _basis_coeffs(basis)

    def render(spheres, weights):
        return _SplatRender.apply(spheres, weights, cam, tile_w, tile_h, basis)

    return render


def splat_reference_torch(spheres, weights, cam: OrthoCamera, basis: str = "deg8"):
    """Dense PyTorch evaluation of the same separable model (same fitted
    coefficients and clamps), differentiable by autograd: the oracle the
    kernels are held against. O(pixels x particles); small scenes only."""
    _, a_c, b_c = _basis_coeffs(basis)
    pu, pv, invh, scale = project_ortho(spheres, weights, cam)
    *_, x0, dx, y0, dy = _camera_numerics(cam, spheres.device)
    dev = spheres.device
    xs = fma(torch.arange(cam.resolution_x, dtype=torch.float32, device=dev), dx, x0)
    ys = fma(torch.arange(cam.resolution_y, dtype=torch.float32, device=dev), dy, y0)
    ya = (ys[:, None] - pv[None, :]) * invh[None, :]                   # (H, n)
    xb = (xs[:, None] - pu[None, :]) * invh[None, :]                   # (W, n)
    a_f = _factor(torch.clamp(ya * ya, max=1.0), a_c)
    b_f = _factor(torch.clamp(xb * xb, max=1.0), b_c)
    img = torch.zeros((cam.resolution_y, cam.resolution_x), dtype=torch.float32, device=dev)
    for k in range(a_c.shape[0]):
        img = img + matmul_f32(a_f[k], (b_f[k] * scale[None, :]).t())
    return img
