"""Splatting renderer: SPH column density of a parallel ray grid.

PyTorch counterpart of ``grace_tpu.trace.splat``. For a parallel ray grid
the image is a sum of separable per-particle footprints,

    I[j, i] = sum_p  w_p/h_p^2 * F(sqrt(xhat^2 + yhat^2)),
    xhat = (X_i - pu_p)/h_p,   yhat = (Y_j - pv_p)/h_p

and with the rank-K basis F(sqrt(x^2+y^2)) ~= sum_k a_k(x) b_k(y) each
pixel patch is sum_k A_k @ B_k^T over the instances bucketed to it.

  1. ``bucket_prims_ortho`` (per scene + camera): project particles to the
     image plane, expand each to the (up to) 2x2 (row tile x column band)
     keys its footprint touches, stable-sort the instances by key, and lay
     them out as component-major (n_slabs, 8, chunk) slabs.
  2. ``splat_image``: one CUDA block per key (``csrc/splat.cu``), keys with
     the most instances first, builds the A/B factors of its instances
     inside their footprints and accumulates its patch over the
     footprints only; on CPU tensors, ``_splat_plain``.

Camera conventions match ``rays.gen.orthographic_projection_rays``: pixel
(j, i) is ray j*W + i, row 0 at the top.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from grace_tpu_torch import _kernels
from grace_tpu_torch.ops.vecmath import cross, dot3, fma, matmul_f32, normalize3
from grace_tpu_torch.sph.kernel_integrals import SPLAT_BASES


class SplatBuckets(NamedTuple):
    """Bucketed instance layout; ranges are per KEY = (row tile, column
    band), keys row-major over bands: key = rt * nbx + cb."""

    slabs: torch.Tensor      # f32[n_slabs_cap, 8, P]: rows 0-3 (4-7) = pu, pv,
    #                          invh, scale of instance chunk 2s (2s+1)
    slab_lo: torch.Tensor    # i32[n_keys] first slab overlapping each key's range
    n_slabs: torch.Tensor    # i32[n_keys]
    first: torch.Tensor      # i32[n_keys] global instance range [first, last)
    last: torch.Tensor       # i32[n_keys]
    xcols: torch.Tensor      # f32[W, 1] pixel-center coordinate along the right axis
    yrows: torch.Tensor      # f32[H, 1] pixel-center coordinate along the up axis
    overflow: torch.Tensor   # bool[] — some footprint exceeded a band span

    def to(self, device) -> "SplatBuckets":
        return SplatBuckets(*(t.to(device) for t in self))


def _sorted_first_counts(key_s: torch.Tensor, n_keys: int) -> torch.Tensor:
    """first[k] = #elements of SORTED ``key_s`` strictly below k, for
    k = 0..n_keys (inclusive), i32[n_keys + 1]."""
    thresholds = torch.arange(n_keys + 1, dtype=key_s.dtype, device=key_s.device)
    return torch.searchsorted(key_s, thresholds, side="left").to(torch.int32)


def _camera_frame(camera_position, look_at, view_up, device=None):
    # grace_tpu jits bucket_prims_ortho, so this frame takes the fused
    # normalize3; rays.gen mirrors the eager generators instead.
    f32 =lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    view_dir = normalize3(f32(look_at) - f32(camera_position))
    v = normalize3(cross(view_dir, f32(view_up)))
    u = normalize3(cross(v, view_dir))
    return view_dir, v, u


class _OrthoFrame(NamedTuple):
    """The camera's tensors that ``bucket_prims_ortho`` takes, f32 on one
    device: the frame, the depth limit and the pixel-center maps."""

    view_dir: torch.Tensor   # [3]
    v: torch.Tensor          # [3] image x (columns)
    u: torch.Tensor          # [3] image y (rows)
    cam: torch.Tensor        # [3]
    length: torch.Tensor     # []
    xcols: torch.Tensor      # [W] pixel-center coordinates, ascending
    yrows: torch.Tensor      # [H] descending
    x0: torch.Tensor         # [] left edge of column 0
    y0: torch.Tensor         # [] top edge of row 0
    band_step: torch.Tensor  # [] dx * band
    tile_step: torch.Tensor  # [] dyr * tile_w (negative: rows descend)


def _ortho_frame(camera_position, look_at, view_up, vertical_extent, length, w_res, h_res,
                 tile_w, band, device) -> _OrthoFrame:
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    view_dir, v, u = _camera_frame(camera_position, look_at, view_up, device)
    cam = f32(camera_position)
    vext = f32(vertical_extent)
    half_w = 0.5 * vext * (w_res / h_res)
    half_h = 0.5 * vext
    # Pixel-center coordinates in the image plane (top-left pixel first).
    cu = dot3(cam, v)
    cv = dot3(cam, u)
    i = torch.arange(w_res, dtype=torch.float32, device=device)
    j = torch.arange(h_res, dtype=torch.float32, device=device)
    xcols = fma(2.0 * (i + 0.5) / w_res - 1.0, half_w, cu)        # ascending
    yrows = fma(1.0 - 2.0 * (j + 0.5) / h_res, half_h, cv)        # descending
    dx = 2.0 * half_w / w_res
    dyr = -2.0 * half_h / h_res
    return _OrthoFrame(view_dir, v, u, cam, f32(length), xcols, yrows, xcols[0] - 0.5 * dx,
                       yrows[0] - 0.5 * dyr, dx * band, dyr * tile_w)


def _frozen(a):
    """A hashable key of a camera argument, or None for a tensor: each value
    with its type and bytes. ``np.float32(x) == x`` and the two hash alike,
    yet arithmetic on them rounds apart (NumPy 2 keeps an np.float32 in
    f32), so the type is part of the key; the bytes keep -0 apart from +0."""
    if isinstance(a, torch.Tensor):
        return None
    if isinstance(a, (tuple, list)):
        parts = tuple(_frozen(x) for x in a)
        return None if any(p is None for p in parts) else (type(a), parts)
    arr = np.asarray(a)
    if arr.dtype == object:
        return None
    return type(a), arr.dtype.str, arr.shape, arr.tobytes()


def _f32_key(a):
    """A hashable key of a camera argument that ``_ortho_frame`` takes as an
    f32 tensor: the bytes of its f32 values (None for a tensor)."""
    if isinstance(a, torch.Tensor):
        return None
    return np.asarray(a, dtype=np.float32).tobytes()


def _memo(cache: collections.OrderedDict, key, compute, size: int = 64):
    """``compute()``, kept in ``cache`` under ``key`` (the ``size`` latest
    keys); a key holding None is not cached."""
    if key is None or any(k is None for k in key):
        return compute()
    if key in cache:
        cache.move_to_end(key)
        return cache[key]
    value = cache[key] = compute()
    if len(cache) > size:
        cache.popitem(last=False)
    return value


def _frame_constants(*args):
    frame = _ortho_frame(*args)
    consts = torch.cat([frame.view_dir, frame.v, frame.u, frame.cam,
                        torch.stack([frame.length, frame.x0, frame.y0, frame.band_step,
                                     frame.tile_step])])
    return consts, frame.xcols[:, None], frame.yrows[:, None]


BUCKET_CONSTS = 17  # f32 constants of grace_splat_bucket_keys (csrc/splat_prep.cu)
_FRAME_CACHE: collections.OrderedDict = collections.OrderedDict()


def _bucket_constants(camera_position, look_at, view_up, vertical_extent, length, w_res,
                      h_res, tile_w, band, device):
    """(consts f32[17], xcols f32[W, 1], yrows f32[H, 1]) on ``device``:
    ``_ortho_frame``'s tensors, computed by its torch ops from the caller's
    camera once per camera and device and cached (a camera given as tensors
    is not cached). ``_ortho_frame`` takes every camera value as an f32
    tensor first, so the key is those f32 values."""
    args = (camera_position, look_at, view_up, vertical_extent, length)
    key = (*(_f32_key(a) for a in args), w_res, h_res, tile_w, band, torch.device(device))
    return _memo(_FRAME_CACHE, key,
                 lambda: _frame_constants(*args, w_res, h_res, tile_w, band, device))


def bucket_prims_ortho(spheres, camera_position, look_at, view_up,
                       vertical_extent: float, length: float, resolution_x: int,
                       resolution_y: int, tile_w: int = 64, tile_h: int = 128,
                       chunk: int = 512, weights=None, band: int | None = None
                       ) -> SplatBuckets:
    """Per-(scene, camera) prep: project, cull by depth, bucket by key.

    tile_w: image ROWS per tile, tile_h: image COLUMNS per tile; ``band``
    (default tile_h) splits each tile into tile_h/band column bands.
    Footprints are expanded to at most a 2x2 (row tile x band)
    neighbourhood; a particle needing more sets the overflow flag.

    On CUDA tensors the keys and slabs come from ``csrc/splat_prep.cu``
    (``grace_splat_bucket_keys``: keys and counts, then
    ``grace_splat_bucket_pack``: the counts' scan and a stable scatter of
    the instances into the slabs); the camera's tensors are cached per
    camera and device, so ``xcols`` and ``yrows`` are shared between calls
    (do not write into them). CPU tensors run ``_bucket_prims_ortho_plain``.
    """
    w_res, h_res = resolution_x, resolution_y
    if band is None:
        band = tile_h
    if w_res % tile_h or h_res % tile_w or tile_h % band:
        raise ValueError("resolution must be a multiple of the tile shape "
                         "and band must divide tile_h")
    dev = spheres.device
    if dev.type == "cpu":
        return _bucket_prims_ortho_plain(spheres, camera_position, look_at, view_up,
                                         vertical_extent, length, w_res, h_res, tile_w, tile_h,
                                         chunk, weights, band)
    if dev.type != "cuda":
        raise ValueError(f"bucket_prims_ortho: unsupported device {dev}")
    return _bucket_prims_ortho_kernels(spheres, camera_position, look_at, view_up,
                                       vertical_extent, length, w_res, h_res, tile_w, tile_h,
                                       chunk, weights, band)


BUCKET_TILE = 4096        # particles a block of E4's two passes (csrc/splat_prep.cu)
BUCKET_COUNTS = 1 << 24   # (bin, block tile) counters, at most
BUCKET_SHARED_BINS = 1000  # bins a block holds in shared memory, at most (kSharedBins)


def bucket_blocks(n: int, n_keys: int, tile: int = BUCKET_TILE) -> tuple[int, int]:
    """(tile, blocks) of E4's passes over n particles and n_keys keys:
    blocks of ``tile`` particles, grown so that the 4 (n_keys + 2)
    counters a block stay within BUCKET_COUNTS; one block for no
    particle."""
    most = max(1, BUCKET_COUNTS // (4 * (n_keys + 2)))
    tile = max(tile, -(-n // most))
    return tile, max(1, -(-n // tile))


def bucket_scratch(n_keys: int, blocks: int) -> int:
    """The i32 scratch of E4's passes: the counters, 4 (n_keys + 2) a
    block; pass 2's scan state, 2 (n_keys + 3); past BUCKET_SHARED_BINS
    bins its words of warp counts, 8 bytes a (q, bin) a block."""
    n_bins = n_keys + 1
    words = 0 if n_bins <= BUCKET_SHARED_BINS else 8 * n_bins * blocks
    return 4 * (n_bins + 1) * blocks + 2 * (n_bins + 2) + words


def _bucket_prims_ortho_kernels(spheres, camera_position, look_at, view_up, vertical_extent,
                                length, w_res, h_res, tile_w, tile_h, chunk, weights, band,
                                _tile: int = BUCKET_TILE) -> SplatBuckets:
    """``bucket_prims_ortho``'s CUDA route (checked arguments, ``band``
    resolved): pass 1 (keys and counts), pass 2 (the counts' scan, the
    slabs, the ranges and the overflow flag), with no host sync. ``_tile``
    (particles a block) is for the tests and the ablations."""
    dev = spheres.device
    w = None if weights is None else torch.as_tensor(weights, dtype=torch.float32, device=dev)
    _kernels.check_tensors("bucket_prims_ortho", [], [spheres] + ([] if w is None else [w]))
    n = spheres.shape[0]
    if spheres.dim() != 2 or spheres.shape[1] != 4 or (w is not None and w.shape != (n,)):
        raise ValueError(f"bucket_prims_ortho: spheres {tuple(spheres.shape)}, weights "
                         f"{None if w is None else tuple(w.shape)}")
    if 4 * n + 2 * chunk >= 2 ** 31:
        raise ValueError(f"bucket_prims_ortho: {n} particles pass the kernels' i32 indices")
    consts, xcols, yrows = _bucket_constants(camera_position, look_at, view_up,
                                             vertical_extent, length, w_res, h_res, tile_w,
                                             band, dev)
    nbx = (w_res // tile_h) * (tile_h // band)
    nty = h_res // tile_w
    spheres = _kernels.aligned(spheres)
    w = None if w is None else w.contiguous()
    tile, blocks = bucket_blocks(n, nbx * nty, _tile)
    counts = torch.empty(bucket_scratch(nbx * nty, blocks), dtype=torch.int32, device=dev)
    bucket_keys_cuda(spheres, w, consts, counts, nbx, nty, tile)
    # Stable: each (bin, block tile) pair's slots follow the pairs before it
    # in key-major order, tile q * blocks + b holding instances q * n + p.
    slabs, ranges, overflow = bucket_pack_cuda(spheres, w, consts, counts, chunk, nbx, nty, tile)
    first, last, slab_lo, n_slabs = ranges
    return SplatBuckets(slabs, slab_lo, n_slabs, first, last, xcols, yrows, overflow)


def bucket_keys_cuda(spheres, weights, consts, counts, nbx: int, nty: int, tile: int):
    """``csrc/splat_prep.cu``'s ``grace_splat_bucket_keys`` (pass 1) on
    checked CUDA tensors (spheres 16-byte aligned, weights contiguous or
    None) into counts i32[bucket_scratch(nbx nty, blocks)]: the counters of
    ``bucket_blocks``' blocks of ``tile`` particles, key-major, the last row
    the blocks' overflow flags, then pass 2's scan state, zeroed."""
    _kernels.launch("splat_prep", "grace_splat_bucket_keys", spheres.device, spheres.data_ptr(),
                    None if weights is None else weights.data_ptr(), consts.data_ptr(),
                    counts.data_ptr(), spheres.shape[0], tile, nbx, nty, nbx * nty)
    bucket_keys_cuda.launches += 1


bucket_keys_cuda.launches = 0


def bucket_pack_cuda(spheres, weights, consts, counts, chunk: int, nbx: int, nty: int,
                     tile: int):
    """``csrc/splat_prep.cu``'s ``grace_splat_bucket_pack`` (pass 2): (slabs
    f32[cap / (2 chunk), 8, chunk], ranges i32[4, n_keys] (first, last,
    slab_lo, n_slabs), overflow bool[]) from pass 1's inputs and its
    counts, which it scans in place (scratch)."""
    device = spheres.device
    n = spheres.shape[0]
    n_keys = nbx * nty
    per_slab = 2 * chunk
    cap = ((4 * n + per_slab - 1) // per_slab) * per_slab
    slabs = torch.empty((cap // per_slab, 8, chunk), dtype=torch.float32, device=device)
    ranges = torch.empty((4, n_keys), dtype=torch.int32, device=device)
    overflow = torch.empty((), dtype=torch.bool, device=device)
    _kernels.launch("splat_prep", "grace_splat_bucket_pack", device, spheres.data_ptr(),
                    None if weights is None else weights.data_ptr(), consts.data_ptr(),
                    counts.data_ptr(), slabs.data_ptr(), ranges.data_ptr(), overflow.data_ptr(),
                    n, cap, chunk, tile, nbx, nty, n_keys)
    bucket_pack_cuda.launches += 1
    return slabs, ranges, overflow


bucket_pack_cuda.launches = 0


def bucket_resources(device, n_keys: int) -> dict:
    """What one launch of each of E4's passes holds on ``device`` at n_keys
    keys: {"splat_bucket_keys": ..., "splat_bucket_pack": ...}, each
    ``_kernels.RESOURCE_FIELDS`` and ``local_bytes`` a thread."""
    fields = _kernels.RESOURCE_FIELDS + ("local_bytes",)
    out = (ctypes.c_int * (2 * len(fields)))()
    _kernels.launch("splat_prep", "grace_splat_bucket_resources", torch.device(device),
                    ctypes.addressof(out), n_keys + 1)
    return {name: dict(zip(fields, out[i * len(fields):(i + 1) * len(fields)]))
            for i, name in enumerate(("splat_bucket_keys", "splat_bucket_pack"))}


def _bucket_prims_ortho_plain(spheres, camera_position, look_at, view_up, vertical_extent,
                              length, w_res, h_res, tile_w, tile_h, chunk, weights, band
                              ) -> SplatBuckets:
    """Plain PyTorch version of ``bucket_prims_ortho`` (checked arguments,
    ``band`` resolved): grace_tpu's ops, one torch call each."""
    n = spheres.shape[0]
    frame = _ortho_frame(camera_position, look_at, view_up, vertical_extent, length, w_res,
                         h_res, tile_w, band, spheres.device)
    tile_ids, n_keys, pu, pv, invh, live, scale, overflow = _bucket_keys_plain(
        spheres, frame, weights, w_res, h_res, tile_w, tile_h, band)

    # Stable sort: instances of one key keep the torch.cat order above.
    key_s, order = torch.sort(tile_ids, stable=True)
    tiled = lambda a: a.repeat(4)[order]
    pu_s, pv_s = tiled(pu), tiled(pv)
    if weights is None:
        # scale = invh^2 is derivable from the sorted invh once dead
        # particles carry invh = 0.
        invh_s = tiled(torch.where(live, invh, 0.0))
        scale_s = invh_s * invh_s
    else:
        invh_s, scale_s = tiled(invh), tiled(scale)

    first = _sorted_first_counts(key_s, n_keys)
    last = first[1:]
    first = first[:-1]

    # Two `chunk`-sized pieces per (8, chunk) slab: rows 0-3 = chunk 2s
    # (pu, pv, invh, scale), rows 4-7 = chunk 2s+1.
    per_slab = 2 * chunk
    cap = ((4 * n + per_slab - 1) // per_slab) * per_slab
    comp = [torch.nn.functional.pad(a, (0, cap - 4 * n)).reshape(-1, chunk)
            for a in (pu_s, pv_s, invh_s, scale_s)]
    slabs = torch.stack(comp, dim=1).reshape(-1, 8, chunk)
    slab_lo = torch.div(first, per_slab, rounding_mode="floor")
    n_slabs = torch.clamp(torch.div(last + per_slab - 1, per_slab,
                                    rounding_mode="floor") - slab_lo, min=0)
    return SplatBuckets(slabs, slab_lo.to(torch.int32), n_slabs.to(torch.int32),
                        first, last, frame.xcols[:, None], frame.yrows[:, None], overflow)


def _bucket_keys_plain(spheres, frame: _OrthoFrame, weights, w_res, h_res, tile_w, tile_h,
                       band):
    """The plain version's instance keys: (keys i64[4 n], instance q * n +
    p, the sentinel n_keys where it draws nothing; n_keys; each particle's
    pu, pv, invh, live and scale; overflow bool[])."""
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=spheres.device)
    pos = spheres[:, :3]
    h = spheres[:, 3]
    pu = dot3(pos, frame.v)                 # image x (columns)
    pv = dot3(pos, frame.u)                 # image y (rows)
    depth = dot3(pos - frame.cam, frame.view_dir)

    inv_h2 = torch.where(h > 0, 1.0 / torch.clamp(h * h, min=1e-30), 0.0)
    w_p = inv_h2 if weights is None else f32(weights) * inv_h2
    # Along-ray acceptance for a parallel bundle: the foot of the
    # perpendicular is at the particle depth, the same for every ray.
    live = (h > 0) & (depth >= 0.0) & (depth < frame.length)
    scale = torch.where(live, w_p, 0.0)

    ntx = w_res // tile_h
    nty = h_res // tile_w
    n_bands = tile_h // band
    nbx = ntx * n_bands
    floor_i = lambda a: torch.floor(a).to(torch.int64)
    x0, y0 = frame.x0, frame.y0
    cb_lo = floor_i((pu - h - x0) / frame.band_step)
    cb_hi = floor_i((pu + h - x0) / frame.band_step)
    rt_lo = floor_i(((pv + h) - y0) / frame.tile_step)   # rows descend
    rt_hi = floor_i(((pv - h) - y0) / frame.tile_step)
    overflow = (live & ((cb_hi - cb_lo > 1) | (rt_hi - rt_lo > 1))).any()
    cb_hi = torch.minimum(cb_hi, cb_lo + 1)
    rt_hi = torch.minimum(rt_hi, rt_lo + 1)

    # 4 instances per particle: the (up to) 2x2 touched keys; duplicates,
    # out-of-image and dead particles get the sentinel key n_keys.
    n_keys = nbx * nty
    insts = []
    for rr in range(2):
        for cc in range(2):
            cb = cb_lo + cc
            rt = rt_lo + rr
            ok = ((cb <= cb_hi) & (rt <= rt_hi) & (cb >= 0) & (cb < nbx)
                  & (rt >= 0) & (rt < nty) & (scale > 0))
            insts.append(torch.where(ok, rt * nbx + cb, n_keys))
    tile_ids = torch.cat(insts)                               # [4n]
    invh = torch.where(h > 0, 1.0 / torch.clamp(h, min=1e-30), 0.0)
    return tile_ids, n_keys, pu, pv, invh, live, scale, overflow


def _factor(t, coeffs):
    """[rank] tensors (1 - t) * q_k(t) for f32 coefficients [rank, deg + 1]."""
    m = 1.0 - t
    deg = coeffs.shape[1] - 1
    out = []
    for k in range(coeffs.shape[0]):
        acc = torch.full_like(t, float(coeffs[k, deg]))
        for d in range(deg - 1, -1, -1):
            acc = fma(acc, t, float(coeffs[k, d]))
        out.append(acc * m)
    return torch.stack(out)


def _splat_plain(buckets: SplatBuckets, tile_w: int, band: int,
                 a_coeffs: np.ndarray, b_coeffs: np.ndarray) -> torch.Tensor:
    """Plain PyTorch version of the splat kernel: one key at a time, the
    patch as a full-f32 matmul over (instance, rank)."""
    w_res = buckets.xcols.shape[0]
    h_res = buckets.yrows.shape[0]
    nbx = w_res // band
    chunk = buckets.slabs.shape[2]
    # flat[c][g] = component c of global instance g
    flat = buckets.slabs.reshape(-1, 2, 4, chunk).permute(2, 0, 1, 3).reshape(4, -1)
    xs = buckets.xcols[:, 0]
    ys = buckets.yrows[:, 0]
    img = torch.zeros((h_res, w_res), dtype=torch.float32, device=xs.device)
    first = buckets.first.tolist()
    last = buckets.last.tolist()
    for key, (g0, g1) in enumerate(zip(first, last)):
        if g1 <= g0:
            continue
        pu, pv, invh, scl = flat[:, g0:g1]
        r0 = (key // nbx) * tile_w
        c0 = (key % nbx) * band
        ya = (ys[r0:r0 + tile_w, None] - pv) * invh            # (TW, n)
        xb = (xs[c0:c0 + band, None] - pu) * invh              # (BW, n)
        fa = _factor(torch.clamp(ya * ya, max=1.0), a_coeffs)  # (K, TW, n)
        fb = _factor(torch.clamp(xb * xb, max=1.0), b_coeffs) * scl
        img[r0:r0 + tile_w, c0:c0 + band] = matmul_f32(
            fa.permute(1, 0, 2).reshape(tile_w, -1), fb.permute(0, 2, 1).reshape(-1, band))
    return img


def support_interval(centres, q, invh):
    """The pixel centres inside each particle's footprint along one axis,
    as the splat kernels find them (``csrc/splat_common.cuh``
    ``support_range``, operation for operation): the factor of centre c is
    not +-0 where d = (c - q) * invh has d * d < 1.

    Args:
      centres: f32[n], monotone (one axis of a patch).
      q, invh: f32[P], each particle's coordinate on that axis and 1 / h.

    Returns ((lo, hi), (lo_t, hi_t)), each i64[P]: the closed-form interval
    |centres[0] + p / inv_step - q| < h widened by the kernels' margin
    (2 centres and 8 ulp of the operands' magnitude) and clipped to
    [0, n), and the same trimmed with the exact test ([0, 0) if empty).
    With fewer than two distinct centres the widened interval is [0, n).
    """
    n = centres.shape[0]
    f32 = torch.float32
    span = (centres[-1] - centres[0]) if n > 1 else centres.new_zeros(())
    advance = bool(span != 0) and bool(torch.isfinite(span))
    inv_step = (torch.tensor(float(n - 1), dtype=f32) / span.cpu()).to(centres.device) \
        if advance else centres.new_zeros(())
    lo = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    hi = torch.full_like(lo, n)
    if advance:
        h = (1.0 / invh).abs()
        c0 = centres[0]
        a = (q - h - c0) * inv_step
        b = (q + h - c0) * inv_step
        margin = 2.0 + (q.abs() + c0.abs() + h) * inv_step.abs() * 2.0 ** -20
        f_lo = torch.floor(torch.fmin(a, b) - margin)
        f_hi = torch.ceil(torch.fmax(a, b) + margin) + 1.0
        top = torch.tensor(float(n), dtype=f32, device=q.device)
        lo = torch.fmin(torch.fmax(f_lo, torch.zeros_like(f_lo)), top).to(torch.int64)
        hi = torch.fmin(torch.fmax(f_hi, torch.zeros_like(f_hi)), top).to(torch.int64)
    d = (centres[None, :] - q[:, None]) * invh[:, None]
    idx = torch.arange(n, device=q.device)
    keep = (d * d < 1.0) & (idx >= lo[:, None]) & (idx < hi[:, None])
    found = keep.any(dim=1)
    lo_t = torch.where(found, torch.argmax(keep.to(torch.int8), dim=1), 0)
    hi_t = torch.where(found, n - torch.argmax(keep.flip(1).to(torch.int8), dim=1), 0)
    return (lo, hi), (lo_t, hi_t)


def splat_key_order(first: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """Launch order of ``splat_image``'s keys: most instances (last -
    first) first, ties in key order; i32[n_keys]."""
    return _kernels.longest_first(last - first).to(torch.int32)


SPLAT_BATCH = 64   # instances a batch of csrc/splat.cu (its C entry's sub)
MAX_BATCH = 128    # instances a batch of csrc/splat_common.cuh holds at most
MAX_TASKS = 128    # (4-row strip, 32-column group) tasks of a kernel's patch
ROWS = 4           # rows a thread of csrc/splat_common.cuh accumulates


def batch_size(tile_w: int, band: int, rank: int, deg: int, want: int,
               extra: int = 0) -> int:
    """Instances a batch of ``csrc/splat_common.cuh`` holds for a tile_w x
    band patch: ``want``, or fewer if more than MAX_BATCH or if their
    factors would not fit 227 KB of shared memory (its ``layout_bytes``);
    0 if the patch has more than MAX_TASKS tasks or not one instance fits."""
    tw4 = -(-tile_w // ROWS) * ROWS
    if (tw4 // ROWS) * -(-band // 32) > MAX_TASKS:
        return 0
    fixed = 4 * (tw4 + band + 2 * rank * (deg + 1) + 4) + extra
    per = 4 * rank * (tw4 + band) + 32
    return max(0, min(want, MAX_BATCH, (227 * 1024 - fixed) // per))


@functools.lru_cache(maxsize=None)
def _basis_tensors(basis: str, device: str):
    _, a, b = SPLAT_BASES[basis]
    f = lambda c: torch.from_numpy(np.ascontiguousarray(c, np.float32)).to(device)
    return f(a), f(b)


def splat_image(buckets: SplatBuckets, tile_w: int = 64, tile_h: int = 128,
                basis: str = "deg10") -> torch.Tensor:
    """Render the bucketed scene: f32 image [H, W] (row 0 = top).

    Launches ``csrc/splat.cu`` on CUDA tensors and runs ``_splat_plain`` on
    CPU tensors. ``basis``: "deg10" (per-eigenvector fit, ~1.0e-4 max rel
    err) or "deg8" (jointly optimal fit, ~3.1e-4, less factor work)."""
    if basis not in SPLAT_BASES:
        raise ValueError(f"unknown basis {basis!r}")
    deg, a_c, b_c = SPLAT_BASES[basis]
    w_res = buckets.xcols.shape[0]
    h_res = buckets.yrows.shape[0]
    n_keys = buckets.first.shape[0]
    if w_res % tile_h or h_res % tile_w:
        raise ValueError("image size must be a multiple of the tile shape")
    n_bands, rem = divmod(n_keys, (w_res // tile_h) * (h_res // tile_w))
    if rem or n_bands < 1 or tile_h % n_bands:
        raise ValueError("bucket key count does not match the tile shape")
    band = tile_h // n_bands
    tensors = [buckets.slab_lo, buckets.n_slabs, buckets.first, buckets.last,
               buckets.xcols, buckets.yrows, buckets.slabs]
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"splat_image: tensors on several devices {devs}")
    if any(t.dtype != torch.int32 for t in tensors[:4]) or any(
            t.dtype != torch.float32 for t in tensors[4:]):
        raise TypeError("splat_image: expected i32 ranges and f32 coordinates/slabs")
    if buckets.slabs.dim() != 3 or buckets.slabs.shape[1] != 8:
        raise ValueError(f"splat_image: slabs shape {tuple(buckets.slabs.shape)}")
    device = devs.pop()
    a32 = np.asarray(a_c, np.float32)
    b32 = np.asarray(b_c, np.float32)
    if device.type == "cpu":
        return _splat_plain(buckets, tile_w, band, a32, b32)
    if device.type != "cuda":
        raise ValueError(f"splat_image: unsupported device {device}")
    return _splat_launch(buckets, tile_w, band, basis,
                         splat_key_order(buckets.first, buckets.last))


def _splat_launch(buckets: SplatBuckets, tile_w: int, band: int, basis: str,
                  order: torch.Tensor | None) -> torch.Tensor:
    """``csrc/splat.cu`` on ``splat_image``'s checked CUDA inputs, its
    keys' blocks launched in ``order`` (i32 key indices; None: as
    listed)."""
    deg, a_c, _ = SPLAT_BASES[basis]
    rank = len(a_c)
    sub = batch_size(tile_w, band, rank, deg, SPLAT_BATCH)
    if sub < 1:
        raise ValueError(f"splat patch {tile_w}x{band} too large for a block")
    device = buckets.slabs.device
    w_res = buckets.xcols.shape[0]
    h_res = buckets.yrows.shape[0]
    n_keys = buckets.first.shape[0]
    a_t, b_t = _basis_tensors(basis, str(device))
    ranges = [t.contiguous() for t in (buckets.slab_lo, buckets.n_slabs, buckets.first,
                                       buckets.last)]
    coords = [t.contiguous() for t in (buckets.xcols, buckets.yrows, buckets.slabs)]
    if order is not None:
        order = order.to(device=device, dtype=torch.int32).contiguous()
        if order.shape != (n_keys,):
            raise ValueError(f"splat_image: order {tuple(order.shape)} for {n_keys} keys")
    out = torch.zeros((h_res, w_res), dtype=torch.float32, device=device)
    _kernels.launch(
        "splat", "grace_splat", device,
        *[t.data_ptr() for t in ranges], None if order is None else order.data_ptr(),
        *[t.data_ptr() for t in coords], a_t.data_ptr(), b_t.data_ptr(), out.data_ptr(),
        n_keys, w_res // band, tile_w, band, buckets.slabs.shape[2], w_res,
        buckets.slabs.shape[0], rank, deg, sub)
    splat_image.launches += 1
    return out


splat_image.launches = 0


def render_ortho_splat(spheres, camera_position, look_at, view_up,
                       vertical_extent: float, length: float, resolution_x: int,
                       resolution_y: int, weights=None, tile_w: int = 32,
                       tile_h: int = 128, chunk: int = 512, band: int | None = 32,
                       basis: str = "deg8"):
    """One-call orthographic column-density render. Returns (image f32[H, W],
    overflow bool[]). image[j, i] matches the cumulative trace of
    ``orthographic_projection_rays`` ray j * W + i to the basis-fit
    tolerance."""
    buckets = bucket_prims_ortho(
        spheres, camera_position, look_at, view_up, vertical_extent, length,
        resolution_x, resolution_y, tile_w=tile_w, tile_h=tile_h, chunk=chunk,
        weights=weights, band=band)
    img = splat_image(buckets, tile_w=tile_w, tile_h=tile_h, basis=basis)
    return img, buckets.overflow
