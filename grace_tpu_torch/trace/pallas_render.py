"""Fused differentiable SPH rendering: CUDA forward and CUDA backward.

PyTorch counterpart of ``grace_tpu.trace.pallas_render``: a
``torch.autograd.Function`` whose forward is the weighted column density
over dense-culled segment lists (``csrc/render.cu``, ``render_fwd``) and
whose backward is itself a kernel (``render_bwd``). Per hit pair, with
q2 = b^2 / h^2 and contrib = w F(q2) / h^2:

    d/dw     = F(q2) / h^2
    d/dh     = -(2 w / h^3) [F'(q2) q2 + F(q2)]
    d/dpos   = w F'(q2) / h^4 * 2 b_vec

where b_vec = (p - o) - (p - o).d d is the impact vector and F' the exact
derivative of the fitted polynomial (``cubic_spline_line_integral_poly_grad``,
fast form), so the backward is consistent with the forward to f32 rounding.

The backward is segment-major: each CUDA block owns one segment's gradient
and walks the ray tiles of its list (the transpose of the forward's cull),
so every (ray, particle) pair is visited once with no atomics. On CPU
tensors each kernel wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from grace_tpu_torch import _kernels
from grace_tpu_torch.core.types import Rays
from grace_tpu_torch.ops.vecmath import fma
from grace_tpu_torch.sph.kernel_integrals import (
    cubic_spline_line_integral_poly, cubic_spline_line_integral_poly_grad, poly_constants)
from grace_tpu_torch.trace.broadphase import _on_cpu, _tile_aabbs_plain
from grace_tpu_torch.trace.pallas_broadphase import (
    _compact_mask_words_plain, _segment_aabbs_plain, broadphase_boxes_cuda, compact_words_cuda,
    dense_tile_segments, overlap_words_cuda, pack_overlap_bits)
from grace_tpu_torch.trace.pallas_kernel import (MAX_TILE, _impact, _pack_rays,
                                                 list_tile_order)

SEG = 128
BWD_TILE = 128  # rays per backward tile (one slab lane each)
BWD_BATCH = 4   # ray tiles the backward kernel stages per barrier pair (csrc/render.cu)


def _weights(weights, n_pad, n, like):
    """f32[n_pad] weights, zero-padded; None means ones, padding included
    (as in grace_tpu; padding has h = 0 and never hits)."""
    if weights is None:
        return torch.ones(n_pad, dtype=torch.float32, device=like.device)
    w = torch.as_tensor(weights, dtype=torch.float32, device=like.device)
    return torch.nn.functional.pad(w, (0, n_pad - n))


def _pack_prims_3d(spheres: torch.Tensor, weights):
    """(n_segs, 8, SEG) slabs: rows x, y, z, h, w, 1/h^2, h^2, pad (h = 0
    padding has 1/h^2 = 0 and never hits). Returns (slabs, n_pad)."""
    n = spheres.shape[0]
    n_pad = ((n + SEG - 1) // SEG) * SEG
    pt = torch.nn.functional.pad(spheres, (0, 0, 0, n_pad - n)).t()
    h2 = pt[3:4] * pt[3:4]
    inv_h2 = torch.where(h2 > 0.0, 1.0 / torch.clamp(h2, min=1e-30), 0.0)
    pt = torch.cat([pt, _weights(weights, n_pad, n, spheres)[None], inv_h2, h2,
                    torch.zeros_like(h2)])
    return pt.reshape(8, n_pad // SEG, SEG).permute(1, 0, 2).contiguous(), n_pad


def _pack_rays_bwd(rays: Rays, g):
    """f32[8, R_pad] rows ox oy oz dx dy dz len g; padding rays (length -1)
    never hit. Returns (slab, R_pad)."""
    pad = (-rays.n_rays) % BWD_TILE
    o = torch.nn.functional.pad(rays.origins, (0, 0, 0, pad))
    d = torch.nn.functional.pad(rays.directions, (0, 0, 0, pad), value=1.0)
    ln = torch.nn.functional.pad(rays.lengths, (0, pad), value=-1.0)
    gp = torch.nn.functional.pad(g.to(torch.float32), (0, pad))
    return torch.stack([o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], ln, gp]), \
        rays.n_rays + pad


def _pack_prims_sub(spheres: torch.Tensor, weights):
    """(n_segs, SEG, 8) particle-major slabs: columns x y z h w, 3 zero.
    Returns (slabs, n_pad)."""
    n = spheres.shape[0]
    n_pad = ((n + SEG - 1) // SEG) * SEG
    p = torch.nn.functional.pad(spheres, (0, 0, 0, n_pad - n))
    full = torch.cat([p, _weights(weights, n_pad, n, spheres)[:, None],
                      p.new_zeros((n_pad, 3))], dim=1)
    return full.reshape(n_pad // SEG, SEG, 8), n_pad


def _dense_segment_tiles_plain(rays: Rays, spheres, tile: int, max_tiles: int,
                               seg_block: int = 8192):
    """Plain PyTorch version of ``dense_segment_tiles``: the overlaps
    packed into words along tiles and compacted, ``seg_block`` segments at
    a time."""
    tmin, tmax = _tile_aabbs_plain(rays, tile)
    seg_min, seg_max = _segment_aabbs_plain(spheres)
    if seg_min.shape[0] == 0:
        return _compact_mask_words_plain(
            torch.zeros((0, 0), dtype=torch.int32, device=spheres.device), max_tiles)
    parts = []
    for s in range(0, seg_min.shape[0], seg_block):
        s_min, s_max = seg_min[s:s + seg_block], seg_max[s:s + seg_block]
        overlap = ((tmin[None] <= s_max[:, None]) & (s_min[:, None] <= tmax[None])).all(dim=-1)
        parts.append(_compact_mask_words_plain(pack_overlap_bits(overlap), max_tiles))
    return tuple(torch.cat(p) for p in zip(*parts))


def dense_segment_tiles(rays: Rays, spheres, tile: int, max_tiles: int,
                        seg_block: int = 8192):
    """Transpose of the dense cull: per segment, the ascending ids of the
    ray tiles whose AABB overlaps it. Returns (tile_ids i32[n_segs,
    max_tiles], n_tiles i32[n_segs] = min(count, max_tiles), overflow
    bool[n_segs]). On CUDA tensors both box sets (one launch), the words
    along tiles (one overlap-words launch, segments as rows) and their
    compaction are ``csrc/broadphase.cu``'s kernels; CPU tensors run
    ``_dense_segment_tiles_plain``."""
    if _on_cpu(spheres):
        return _dense_segment_tiles_plain(rays, spheres, tile, max_tiles, seg_block)
    tiles, segs = broadphase_boxes_cuda(rays, tile, spheres, SEG)
    return compact_words_cuda(overlap_words_cuda(*segs, *tiles), max_tiles)


@functools.lru_cache(maxsize=None)
def _poly_tensor(device: str) -> torch.Tensor:
    """The fast fit's constants in the layout csrc/poly_fast.cuh reads."""
    k = poly_constants(True)
    assert (k["c1"].size, k["c2"].size) == (9, 7), "poly_fast.cuh takes 9 and 7 terms"
    head = [k[n] for n in ("sum1", "inv1", "scale1", "sum2", "inv2", "scale2")]
    pack = np.concatenate([np.asarray(head, np.float32), k["c1"], k["c2"], k["d1"], k["d2"]])
    return torch.from_numpy(pack).to(device)


def _render_fwd_plain(counts, ids, rays_packed, prims3d):
    """Plain PyTorch version of the forward kernel, one ray tile at a time
    over the first min(count, max_len) segments of its list."""
    n_tiles = counts.shape[0]
    tile = rays_packed.shape[0] // n_tiles
    flat = prims3d.permute(1, 0, 2).reshape(8, -1)
    lanes = torch.arange(SEG, device=prims3d.device)
    out = torch.zeros(rays_packed.shape[0], dtype=torch.float32, device=prims3d.device)
    lens = torch.clamp(counts, 0, ids.shape[1]).tolist()
    for t in range(n_tiles):
        if lens[t] == 0:
            continue
        px, py, pz, _, pw, inv_h2, h2, _ = flat[:, (ids[t, :lens[t]].long()[:, None] * SEG
                                                    + lanes).flatten()]
        r = rays_packed[t * tile:(t + 1) * tile]
        col = lambda k: r[:, k:k + 1]
        b2, dot, *_ = _impact(px, py, pz, col(0), col(1), col(2), col(3), col(4), col(5))
        hit = (b2 < h2) & (dot >= 0.0) & (dot < col(9))
        contrib = pw * cubic_spline_line_integral_poly(b2 * inv_h2, fast=True) * inv_h2
        out[t * tile:(t + 1) * tile] = torch.where(hit, contrib, 0.0).sum(dim=1)
    return out


def _render_bwd_plain(n_tiles, tile_ids, prims_sub, rays_bwd):
    """Plain PyTorch version of the backward kernel, one ray tile at a time
    over the segments whose list holds it; each particle's sums are added
    in ascending tile order, as the kernel adds them."""
    n_segs, max_tiles = tile_ids.shape
    dev = prims_sub.device
    slot_ok = torch.arange(max_tiles, device=dev) < torch.clamp(n_tiles, 0, max_tiles)[:, None]
    seg_of = torch.arange(n_segs, device=dev)[:, None].expand(-1, max_tiles)[slot_ok]
    tile_of = tile_ids[slot_ok].long()
    order = torch.argsort(tile_of, stable=True)
    seg_of, tile_of = seg_of[order], tile_of[order]
    tiles, runs = torch.unique_consecutive(tile_of, return_counts=True)
    out = torch.zeros((n_segs * SEG, 8), dtype=torch.float32, device=dev)
    p = prims_sub.reshape(-1, 8)
    lanes = torch.arange(SEG, device=dev)
    start = 0
    for t, run in zip(tiles.tolist(), runs.tolist()):
        pid = (seg_of[start:start + run, None] * SEG + lanes).flatten()
        start += run
        px, py, pz, ph, pw = (p[pid, c:c + 1] for c in range(5))
        r = rays_bwd[:, t * BWD_TILE:(t + 1) * BWD_TILE]
        b2, dot, bx, by, bz = _impact(px, py, pz, r[0], r[1], r[2], r[3], r[4], r[5])
        h2 = ph * ph
        inv_h2 = torch.where(h2 > 0.0, 1.0 / torch.clamp(h2, min=1e-30), 0.0)
        inv_h = torch.where(ph > 0.0, 1.0 / torch.clamp(ph, min=1e-30), 0.0)
        hit = (b2 < h2) & (dot >= 0.0) & (dot < r[6])
        q2 = b2 * inv_h2
        f = cubic_spline_line_integral_poly(q2, fast=True)
        fp = cubic_spline_line_integral_poly_grad(q2, fast=True)
        gh = torch.where(hit, r[7], 0.0)
        c_pos = gh * (2.0 * pw * fp * inv_h2 * inv_h2)
        c_h = gh * (-2.0 * pw * inv_h2 * inv_h) * fma(fp, q2, f)
        sums = torch.stack([(c_pos * bx).sum(1), (c_pos * by).sum(1), (c_pos * bz).sum(1),
                            c_h.sum(1), (gh * (f * inv_h2)).sum(1)], dim=1)
        out[pid, :5] += sums
    return out.reshape(n_segs, SEG, 8)


def _check_fwd(counts, ids, rays_packed, prims3d):
    """The forward's device, types and shapes; returns the device."""
    n_tiles = counts.shape[0] if counts.dim() == 1 else 0
    device = _kernels.check_tensors("render_fwd", [counts, ids], [rays_packed, prims3d])
    if (n_tiles == 0 or ids.dim() != 2 or ids.shape[0] != n_tiles
            or rays_packed.dim() != 2 or rays_packed.shape[1] != 16
            or rays_packed.shape[0] % n_tiles or prims3d.dim() != 3
            or tuple(prims3d.shape[1:]) != (8, SEG)):
        raise ValueError("render_fwd: inconsistent shapes "
                         f"{[tuple(t.shape) for t in (counts, ids, rays_packed, prims3d)]}")
    return device


def render_fwd(counts, ids, rays_packed, prims3d):
    """Per-ray weighted column density f32[R_pad] over each tile's segment
    list: launches ``csrc/render.cu`` on CUDA tensors (the tiles with the
    longest lists first, ``list_tile_order``), runs ``_render_fwd_plain``
    on CPU tensors.

    Args:
      counts: i32[n_tiles], listed segments per tile (only the first
        min(count, max_len) ids of a row are read).
      ids: i32[n_tiles, max_len] segment ids.
      rays_packed: f32[n_tiles * tile, 16] (``pallas_kernel._pack_rays``).
      prims3d: f32[n_segs, 8, 128] (``_pack_prims_3d``).
    """
    device = _check_fwd(counts, ids, rays_packed, prims3d)
    if device.type == "cpu":
        return _render_fwd_plain(counts, ids, rays_packed, prims3d)
    return _render_fwd_cuda(counts, ids, rays_packed, prims3d,
                            list_tile_order(counts, ids.shape[1]))


def _render_fwd_cuda(counts, ids, rays_packed, prims3d, order, out=None):
    """``csrc/render.cu``'s forward on ``render_fwd``'s checked CUDA
    inputs, block b on tile order[b] (``order`` i32[n_tiles]; None: tile
    b); each block writes its tile's rays in place, into ``out`` (None: a
    new f32[R_pad])."""
    n_tiles = counts.shape[0]
    tile = rays_packed.shape[0] // n_tiles
    if tile > MAX_TILE:
        raise ValueError(f"tile {tile} > {MAX_TILE} rays per block")
    counts, ids, rays_packed = (t.contiguous() for t in (counts, ids, rays_packed))
    prims3d = _kernels.aligned(prims3d)
    if out is None:
        out = torch.empty(rays_packed.shape[0], dtype=torch.float32, device=counts.device)
    _kernels.launch("render", "grace_render_fwd", counts.device, counts.data_ptr(),
                    ids.data_ptr(), None if order is None else order.data_ptr(),
                    rays_packed.data_ptr(), prims3d.data_ptr(),
                    _poly_tensor(str(counts.device)).data_ptr(), out.data_ptr(), n_tiles, tile,
                    ids.shape[1], prims3d.shape[0])
    render_fwd.launches += 1
    return out


def _render_fwd_launch(counts, ids, rays_packed, prims3d, order, out):
    """``render_fwd``'s kernel with its tiles launched in ``order`` in
    place of the wrapper's longest list first, into ``out``: for checks
    that the launch order changes no bit. ``order``: None (as listed) or
    i32[n_tiles] on the inputs' CUDA device, a permutation of the tiles
    (checked, with a host sync); ``out``: f32[R_pad] on that device,
    contiguous. Returns ``out``."""
    device = _check_fwd(counts, ids, rays_packed, prims3d)
    if device.type != "cuda":
        raise ValueError(f"render_fwd: the kernel runs on CUDA tensors, not {device}")
    if (not isinstance(out, torch.Tensor) or out.dtype != torch.float32
            or out.shape != (rays_packed.shape[0],) or out.device != device
            or not out.is_contiguous()):
        raise ValueError(f"render_fwd: out must be a contiguous f32[{rays_packed.shape[0]}] "
                         f"on {device}")
    n_tiles = counts.shape[0]
    if order is not None and (
            not isinstance(order, torch.Tensor) or order.dtype != torch.int32
            or order.shape != (n_tiles,) or order.device != device
            or not torch.equal(torch.sort(order).values,
                               torch.arange(n_tiles, dtype=torch.int32, device=device))):
        raise ValueError(f"render_fwd: order must be a permutation of the {n_tiles} tiles, "
                         f"i32 on {device}")
    return _render_fwd_cuda(counts, ids, rays_packed, prims3d, order, out)


render_fwd.launches = 0


def render_bwd(n_tiles, tile_ids, prims_sub, rays_bwd):
    """Per-particle gradients f32[n_segs, 128, 8] (columns d/dx, d/dy,
    d/dz, d/dh, d/dw, 3 zero) over each segment's list of 128-ray tiles:
    launches ``csrc/render.cu`` on CUDA tensors (the segments with the
    longest lists first), runs ``_render_bwd_plain`` on CPU tensors.

    Args:
      n_tiles: i32[n_segs], listed tiles per segment (the first
        min(count, max_tiles) ids of a row are read).
      tile_ids: i32[n_segs, max_tiles] ray-tile ids.
      prims_sub: f32[n_segs, 128, 8] (``_pack_prims_sub``).
      rays_bwd: f32[8, R_pad] (``_pack_rays_bwd``), R_pad a multiple of 128.
    """
    device = _kernels.check_tensors("render_bwd", [n_tiles, tile_ids], [prims_sub, rays_bwd])
    n_segs = prims_sub.shape[0]
    if (n_tiles.shape != (n_segs,) or tile_ids.dim() != 2 or tile_ids.shape[0] != n_segs
            or tuple(prims_sub.shape[1:]) != (SEG, 8) or rays_bwd.dim() != 2
            or rays_bwd.shape[0] != 8 or rays_bwd.shape[1] % BWD_TILE):
        raise ValueError("render_bwd: inconsistent shapes "
                         f"{[tuple(t.shape) for t in (n_tiles, tile_ids, prims_sub, rays_bwd)]}")
    if device.type == "cpu":
        return _render_bwd_plain(n_tiles, tile_ids, prims_sub, rays_bwd)
    # the segments with the longest lists first (results go back to segment order)
    order = _kernels.longest_first(n_tiles)
    args = [n_tiles[order], tile_ids[order], prims_sub[order], _kernels.aligned(rays_bwd)]
    out_o = torch.empty((n_segs, SEG, 8), dtype=torch.float32, device=device)
    _kernels.launch("render", "grace_render_bwd", device, *[t.data_ptr() for t in args],
                    _poly_tensor(str(device)).data_ptr(), out_o.data_ptr(), n_segs,
                    tile_ids.shape[1], rays_bwd.shape[1])
    render_bwd.launches += 1
    return torch.empty_like(out_o).index_copy_(0, order, out_o)


render_bwd.launches = 0


def _fused_forward(rays: Rays, spheres, weights, tile: int, max_chunks: int):
    """(values f32[R], (seg_ids, n_segs), overflow bool[n_tiles]); the ray
    count must be a multiple of ``tile`` (``tile_aabbs``)."""
    seg_ids, n_segs, overflow = dense_tile_segments(rays, spheres, tile, max_chunks)
    packed, _ = _pack_rays(rays, tile)
    prims3d, _ = _pack_prims_3d(spheres, weights)
    out = render_fwd(n_segs, seg_ids, packed, prims3d)
    return out[:rays.n_rays], (seg_ids, n_segs), overflow


def _fused_backward(rays: Rays, spheres, weights, g, max_tiles: int):
    """(g_spheres f32[n, 4], g_weights f32[n], any list overflow bool[]);
    the ray count must be a multiple of 128."""
    rays_packed, _ = _pack_rays_bwd(rays, g)
    prims_sub, _ = _pack_prims_sub(spheres, weights)
    tile_ids, n_tiles, overflow = dense_segment_tiles(rays, spheres, BWD_TILE, max_tiles)
    grad = render_bwd(n_tiles, tile_ids, prims_sub, rays_packed)
    flat = grad.reshape(-1, 8)[:spheres.shape[0]]
    return flat[:, :4], flat[:, 4], overflow.any()


class _FusedRender(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rays, spheres, weights, config):
        tile, max_chunks, max_tiles, return_overflow = config
        values, _, overflow = _fused_forward(rays, spheres, weights, tile, max_chunks)
        ctx.save_for_backward(spheres, weights)
        ctx.rays = rays
        ctx.max_tiles = max_tiles
        if return_overflow:
            flag = overflow.any()
            ctx.mark_non_differentiable(flag)
            return values, flag
        return values

    @staticmethod
    def backward(ctx, g, *_):
        spheres, weights = ctx.saved_tensors
        gs, gw, overflow = _fused_backward(ctx.rays, spheres, weights, g, ctx.max_tiles)
        # A segment whose tile list overflowed would lose contributions:
        # poison every gradient with NaN instead.
        poison = torch.where(overflow, float("nan"), 0.0)
        return (None, gs + poison if ctx.needs_input_grad[1] else None,
                gw + poison if ctx.needs_input_grad[2] else None, None)


def make_fused_renderer(tile: int = 128, max_chunks: int = 2048,
                        max_tiles_per_seg: int = 1024, return_overflow: bool = False):
    """A differentiable column-density renderer, CUDA forward and backward
    (a ``torch.autograd.Function``): render(rays, spheres, weights) ->
    f32[R]; gradients flow to spheres (positions and h) and weights
    (``weights`` may be None: all ones); rays get none.

    Overflow: with ``return_overflow=True`` render returns (values,
    overflow bool[]), the flag non-differentiable; a backward whose
    per-segment tile list exceeds ``max_tiles_per_seg`` poisons the
    gradients with NaN. The forward needs a ray count that is a multiple
    of ``tile``, the backward one that is a multiple of 128."""
    config = (tile, max_chunks, max_tiles_per_seg, return_overflow)

    def render(rays: Rays, spheres, weights):
        return _FusedRender.apply(rays, spheres, weights, config)

    return render
