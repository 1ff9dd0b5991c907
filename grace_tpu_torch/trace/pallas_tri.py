"""Triangle-mesh closest-hit and any-hit trace through a hand-written CUDA
kernel.

PyTorch counterpart of ``grace_tpu.trace.pallas_tri``; ``pallas_trace_tri``
launches ``csrc/tri.cu``. Two stages, as there:

  broadphase  every ray is clipped to the mesh AABB (``clip_rays_to_aabb``);
              per ray tile, the 128-triangle segments whose AABB meets one
              of ``n_intervals`` boxes along the tile's rays are listed
              front to back by a conservative entry distance
              (``_dense_tile_segments_tri``).
  kernel      one CUDA warp (or warp group) per ray tile, one thread per
              ray, walks its list in order: Moller-Trumbore with back-face
              culling against each listed segment's triangles, keeping the closest
              t and its triangle (or only t, for any-hit), and stops once
              no ray of the tile can find a closer hit past the next chunk
              of segments.

On a CUDA tensor the lists are one launch of ``csrc/tri_lists.cu`` (a warp
a tile against segment boxes staged once a block: the hulls, a lane a
segment, the listed segments sorted in the warp, the row written once) and
the trace one of ``csrc/tri.cu``; on a CPU tensor each
wrapper runs its plain PyTorch version (``_dense_tile_segments_tri_plain``,
``_tri_plain``).

Layouts: triangles as f32[n_segs, 16, 128] slabs, rows v0.xyz, e1.xyz,
e2.xyz and 7 zero rows (zero padding triangles are degenerate and never
hit); rays as ``pallas_kernel._pack_rays`` rows.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from grace_tpu_torch import _kernels
from grace_tpu_torch.core.types import Rays
from grace_tpu_torch.ops.vecmath import fma, sqrt
from grace_tpu_torch.trace.broadphase import _on_cpu
from grace_tpu_torch.trace.pallas_kernel import MAX_TILE, SEG, _pack_rays, _pad_rays

EPS = 1e-7
BIG = 1e30
N_CULL_INTERVALS = 16
CHUNK = 8  # segments between two front-to-back termination tests
MODES = ("closest", "any")
# Bounds on the working sets of the broadphase's [tiles, intervals, segments]
# overlap tensor (elements) and of the plain kernel's lockstep tiles.
CULL_BLOCK_ELEMENTS = 1 << 26
PLAIN_BLOCK_TILES = 256
# The list kernel (csrc/tri_lists.cu): the most intervals it takes; the
# most segment boxes a block stages in shared memory (past them it reads
# them from device memory); the most entries a warp sorts in registers
# (a tile that lists more sorts in its warp's row of a device scratch);
# and that scratch's rows (the most warps that take tiles where it is in
# use: 132 SMs x 32 resident warps of an H100 at the torus's 2,048
# segments) and entries.
MAX_INTERVALS = 64
STAGE_SEGS = 4096
WARP_BUF = 256
SORT_SLOTS = 4224
SORT_SCRATCH = 1 << 24


def _pack_tris(tris: torch.Tensor):
    """(n_segs, 16, SEG) slabs: rows v0(3), e1(3), e2(3), 7 zero rows."""
    n = tris.shape[0]
    n_pad = ((n + SEG - 1) // SEG) * SEG
    t = torch.nn.functional.pad(tris, (0, 0, 0, 0, 0, n_pad - n))
    v0 = t[:, 0, :]
    rows = torch.cat([v0.t(), (t[:, 1, :] - v0).t(), (t[:, 2, :] - v0).t(),
                      torch.zeros((7, n_pad), dtype=torch.float32, device=tris.device)])
    return rows.reshape(16, n_pad // SEG, SEG).permute(1, 0, 2).contiguous(), n_pad


def tri_segment_aabbs(tris: torch.Tensor):
    """(mins f32[n_segs, 3], maxs f32[n_segs, 3]) of each 128-triangle
    segment; padding slots are empty (+max / -max)."""
    n = tris.shape[0]
    pad = ((n + SEG - 1) // SEG) * SEG - n
    big = torch.finfo(torch.float32).max
    mins = torch.nn.functional.pad(tris.amin(dim=1), (0, 0, 0, pad), value=big)
    maxs = torch.nn.functional.pad(tris.amax(dim=1), (0, 0, 0, pad), value=-big)
    return mins.reshape(-1, SEG, 3).amin(dim=1), maxs.reshape(-1, SEG, 3).amax(dim=1)


def clip_rays_to_aabb(rays: Rays, bmin, bmax) -> Rays:
    """Clip ray lengths to the exit of an AABB (the mesh's bounds), and to 0
    for rays that miss it: no hit lies outside the box, and short rays let
    the kernel's front-to-back test close miss rays early."""
    d = rays.directions
    inv = 1.0 / torch.where(d.abs() < 1e-30, 1e-30, d)
    t0 = (bmin[None, :] - rays.origins) * inv
    t1 = (bmax[None, :] - rays.origins) * inv
    tn = torch.minimum(t0, t1).amax(dim=1)
    tf = torch.maximum(t0, t1).amin(dim=1)
    hit_box = tf >= torch.clamp(tn, min=0.0)
    ln = torch.where(hit_box, torch.minimum(rays.lengths, tf), 0.0)
    return Rays(rays.origins, rays.directions, torch.clamp(ln, min=0.0))


def _dense_tile_segments_tri(rays: Rays, tris, tile: int, max_chunks: int,
                             n_intervals: int = N_CULL_INTERVALS):
    """Per-tile triangle-segment lists, front to back (the description is
    ``_dense_tile_segments_tri_plain``'s). On CUDA tensors the segment boxes
    are two torch reductions (``tri_segment_aabbs``) and the lists one launch
    of ``csrc/tri_lists.cu`` (``tri_tile_lists_cuda``); CPU tensors run
    ``_dense_tile_segments_tri_plain``."""
    if _on_cpu(rays.origins):
        return _dense_tile_segments_tri_plain(rays, tris, tile, max_chunks, n_intervals)
    seg_min, seg_max = tri_segment_aabbs(tris)
    return tri_tile_lists_cuda(rays, seg_min, seg_max, tile, max_chunks, n_intervals)


def tri_tile_lists_cuda(rays: Rays, seg_min, seg_max, tile: int, max_chunks: int,
                        n_intervals: int = N_CULL_INTERVALS, _warp_buf=None, _stage=None):
    """``csrc/tri_lists.cu``'s ``grace_tri_tile_lists``: the outputs of
    ``_dense_tile_segments_tri`` from the segment boxes. Persistent blocks
    stage the boxes in shared memory up to ``STAGE_SEGS`` segments (else
    read them from device memory); a warp a tile (the tiles by a ticket
    counter the C entry zeroes: a memset, then the launch) sorts up to
    ``WARP_BUF`` listed segments in registers, more in its row of a device
    scratch (the same bits). ``_warp_buf`` and ``_stage`` force smaller
    limits (the tests' routes past them)."""
    warp_buf = WARP_BUF if _warp_buf is None else _warp_buf
    stage = STAGE_SEGS if _stage is None else _stage
    device = _kernels.check_tensors("tri_tile_lists", [],
                                    [rays.origins, rays.directions, rays.lengths, seg_min,
                                     seg_max])
    n_rays, n_segs, K = rays.origins.shape[0], seg_min.shape[0], n_intervals
    if tile < 1 or n_rays % tile:
        raise ValueError("ray count must be a multiple of the tile size")
    if not 1 <= K <= MAX_INTERVALS:
        raise ValueError(f"n_intervals {K}: the kernel takes 1 to {MAX_INTERVALS}")
    if max_chunks < 0 or seg_max.shape != seg_min.shape or seg_min.shape[1:] != (3,):
        raise ValueError(f"tri_tile_lists: max_chunks {max_chunks}, boxes "
                         f"{tuple(seg_min.shape)} and {tuple(seg_max.shape)}")
    n_tiles = n_rays // tile
    # frac as the plain version computes it, on the same device
    frac = torch.arange(K + 1, dtype=torch.float32, device=device) / K
    cap = 1 << max(0, n_segs - 1).bit_length()
    slots = min(n_tiles, SORT_SLOTS, max(1, SORT_SCRATCH // cap)) if n_segs > warp_buf else 0
    scratch = torch.empty(max(1, slots * cap), dtype=torch.int64, device=device)
    tickets = torch.empty(1, dtype=torch.int64, device=device)   # zeroed by the C entry
    ins = [_kernels.aligned(seg_min), _kernels.aligned(seg_max)] + [
        t.contiguous() for t in (rays.origins, rays.directions, rays.lengths)]
    seg_ids = torch.empty((n_tiles, max_chunks), dtype=torch.int32, device=device)
    seg_dist = torch.empty((n_tiles, max_chunks), dtype=torch.float32, device=device)
    n = torch.empty(n_tiles, dtype=torch.int32, device=device)
    overflow = torch.empty(n_tiles, dtype=torch.bool, device=device)
    _kernels.launch("tri_lists", "grace_tri_tile_lists", device,
                    *[t.data_ptr() for t in ins], frac.data_ptr(), seg_ids.data_ptr(),
                    seg_dist.data_ptr(), n.data_ptr(), overflow.data_ptr(),
                    scratch.data_ptr(), tickets.data_ptr(), n_tiles, tile, n_segs, K,
                    max_chunks, slots, warp_buf, stage)
    tri_tile_lists_cuda.launches += 1
    return seg_ids, seg_dist, n, overflow


tri_tile_lists_cuda.launches = 0


def tri_tile_lists_resources(device, n_segs: int, max_chunks: int,
                             n_intervals: int = N_CULL_INTERVALS, _stage=None):
    """What one launch of the list kernel at these shapes holds on
    ``device`` (``_kernels.RESOURCE_FIELDS`` and ``local_bytes``), for the
    instance the call takes: 16-byte rows where ``max_chunks`` is a
    multiple of 4, boxes staged up to ``STAGE_SEGS`` (or ``_stage``)
    segments."""
    fields = _kernels.RESOURCE_FIELDS + ("local_bytes",)
    out = (ctypes.c_int * len(fields))()
    _kernels.launch("tri_lists", "grace_tri_tile_lists_resources", torch.device(device),
                    ctypes.addressof(out), n_segs, n_intervals, max_chunks, WARP_BUF,
                    STAGE_SEGS if _stage is None else _stage)
    return dict(zip(fields, out))


def _dense_tile_segments_tri_plain(rays: Rays, tris, tile: int, max_chunks: int,
                                   n_intervals: int = N_CULL_INTERVALS):
    """Plain PyTorch version of ``_dense_tile_segments_tri``: per-tile
    triangle-segment lists, front to back.

    Each ray's [0, len] is cut into ``n_intervals`` equal parameter
    intervals; a segment is listed for a tile when its AABB meets the box
    of one interval of the tile's rays, and its entry distance is the
    larger of its AABB's gap from the origins' box and the first such
    interval's start (times the tile's shortest length): a lower bound on
    the parameter of any hit in it for unit-direction rays. Lists are
    sorted by that key (stable, ties by segment id).

    Returns (seg_ids i32[T, max_chunks], seg_dist f32[T, max_chunks]
    (BIG past the sorted segments), n_segs i32[T] (clamped to max_chunks),
    overflow bool[T]). Tiles go in blocks whose [tiles, n_intervals,
    n_segs] overlap tensor holds at most ``CULL_BLOCK_ELEMENTS``.
    """
    seg_min, seg_max = tri_segment_aabbs(tris)
    n_segs_total = seg_min.shape[0]
    n_tiles = rays.origins.shape[0] // tile
    K = n_intervals
    dev = rays.origins.device
    o = rays.origins.reshape(n_tiles, tile, 3)
    d = rays.directions.reshape(n_tiles, tile, 3)
    ln = torch.clamp(rays.lengths, min=0.0).reshape(n_tiles, tile)
    frac = torch.arange(K + 1, dtype=torch.float32, device=dev) / K
    keep = min(max_chunks, n_segs_total)
    block = max(1, CULL_BLOCK_ELEMENTS // max(1, K * n_segs_total))
    ids_out, dist_out, n_out = [], [], []
    k_ids = torch.arange(K, dtype=torch.int32, device=dev)[None, :, None]
    s_ids = torch.arange(n_segs_total, dtype=torch.int32, device=dev)
    for a0 in range(0, n_tiles, block):
        sl = slice(a0, min(a0 + block, n_tiles))
        ob, db, lb = o[sl], d[sl], ln[sl]
        # endpoint hulls B_k of the tile's rays at t = ln * k/K, k = 0..K
        pts = fma(db[:, :, None, :], (lb[:, :, None] * frac)[..., None], ob[:, :, None, :])
        bmin, bmax = pts.amin(dim=1), pts.amax(dim=1)           # [t, K+1, 3]
        imin = torch.minimum(bmin[:, :-1], bmin[:, 1:])          # [t, K, 3]
        imax = torch.maximum(bmax[:, :-1], bmax[:, 1:])
        ov = torch.ones((imin.shape[0], K, n_segs_total), dtype=torch.bool, device=dev)
        for a in range(3):
            ov &= (imin[:, :, a:a + 1] <= seg_max[None, None, :, a]) \
                & (seg_min[None, None, :, a] <= imax[:, :, a:a + 1])
        kfirst = torch.where(ov, k_ids, K).amin(dim=1)          # [t, S]; K = not listed
        del ov
        listed = kfirst < K
        omin, omax = ob.amin(dim=1), ob.amax(dim=1)
        gx, gy, gz = (torch.clamp(torch.maximum(seg_min[None, :, a] - omax[:, a:a + 1],
                                                omin[:, a:a + 1] - seg_max[None, :, a]),
                                  min=0.0) for a in range(3))
        g2 = fma(gz, gz, fma(gx, gx, gy * gy))
        t_lo = kfirst.to(torch.float32) / K * lb.amin(dim=1)[:, None]
        dist = torch.maximum(sqrt(g2), t_lo)
        key = torch.where(listed, dist, torch.tensor(BIG, dtype=torch.float32, device=dev))
        key_s, order = torch.sort(key, dim=1, stable=True)
        ids_out.append(s_ids[order[:, :keep]])
        dist_out.append(key_s[:, :keep])
        n_out.append(listed.sum(dim=1, dtype=torch.int32))
    n_segs = torch.cat(n_out)
    pad = max_chunks - keep
    seg_ids = torch.nn.functional.pad(torch.cat(ids_out), (0, pad))
    seg_dist = torch.nn.functional.pad(torch.cat(dist_out), (0, pad), value=BIG)
    return (seg_ids.contiguous(), seg_dist.contiguous(),
            torch.clamp(n_segs, max=max_chunks), n_segs > max_chunks)


def _mt_candidates(slab, ox, oy, oz, dx, dy, dz, ln):
    """Moller-Trumbore t of rays (column tensors) against a slab's
    triangles (rows v0, e1, e2 of ``slab[..., 0:9, :]``), BIG where missed,
    with the fused multiply-adds where ``csrc/tri.cu`` has them."""
    v0x, v0y, v0z = slab[..., 0, :], slab[..., 1, :], slab[..., 2, :]
    e1x, e1y, e1z = slab[..., 3, :], slab[..., 4, :], slab[..., 5, :]
    e2x, e2y, e2z = slab[..., 6, :], slab[..., 7, :], slab[..., 8, :]
    # p = d x e2
    px = fma(dy, e2z, -(dz * e2y))
    py = fma(dz, e2x, -(dx * e2z))
    pz = fma(dx, e2y, -(dy * e2x))
    det = fma(e1z, pz, fma(e1y, py, e1x * px))
    inv_det = 1.0 / torch.where(det.abs() > EPS, det, EPS)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = fma(sz, pz, fma(sx, px, sy * py)) * inv_det
    # q = s x e1
    qx = fma(sy, e1z, -(sz * e1y))
    qy = fma(sz, e1x, -(sx * e1z))
    qz = fma(sx, e1y, -(sy * e1x))
    v = fma(dz, qz, fma(dx, qx, dy * qy)) * inv_det
    t = fma(e2z, qz, fma(e2x, qx, e2y * qy)) * inv_det
    hit = ((det > EPS) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > EPS) & (t < ln))
    return torch.where(hit, t, BIG)


def _tri_plain(n_segs, seg_ids, seg_dist, rays_packed, tris3d, mode):
    """Plain PyTorch version of the triangle kernel: every tile walks its
    list in chunks of ``CHUNK`` segments (entries past the list's end
    included, as the kernel reads them) and stops before a chunk whose
    first entry distance no open ray reaches. Tiles go in lockstep,
    ``PLAIN_BLOCK_TILES`` at a time. Returns (t f32[R_pad] (BIG: no hit),
    id i32[R_pad] (-1: none), chunks visited per tile i32[T])."""
    n_tiles, cap = seg_ids.shape
    tile = rays_packed.shape[0] // n_tiles
    dev = rays_packed.device
    r = rays_packed.reshape(n_tiles, tile, 16)
    t_out = torch.full((n_tiles, tile), BIG, dtype=torch.float32, device=dev)
    id_out = torch.full((n_tiles, tile), -1, dtype=torch.int32, device=dev)
    visited = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    lanes = torch.arange(SEG, dtype=torch.int32, device=dev)
    n_chunks = (int(n_segs.max()) + CHUNK - 1) // CHUNK if n_tiles else 0
    for a0 in range(0, n_tiles, PLAIN_BLOCK_TILES):
        tl = torch.arange(a0, min(a0 + PLAIN_BLOCK_TILES, n_tiles), device=dev)
        rb = r[tl]
        col = lambda k: rb[:, :, k:k + 1]
        ln = rb[:, :, 9]
        t_min, tri_id = t_out[tl], id_out[tl]
        alive = torch.ones(tl.shape[0], dtype=torch.bool, device=dev)
        for kb in range(n_chunks):
            d = seg_dist[tl, min(kb * CHUNK, cap - 1)]
            if mode == "any":
                metric = torch.where(t_min >= BIG, ln, -1.0).amax(dim=1)
                go = (kb * CHUNK < n_segs[tl]) & (metric > d)
            else:
                go = (kb * CHUNK < n_segs[tl]) & (torch.minimum(t_min, ln).amax(dim=1) >= d)
            alive &= go
            if not bool(alive.any()):
                break
            go = alive
            visited[tl] += go.to(torch.int32)
            for u in range(CHUNK):
                seg = seg_ids[tl, min(kb * CHUNK + u, cap - 1)].long()
                tc = _mt_candidates(tris3d[seg][:, None], col(0), col(1), col(2), col(3),
                                    col(4), col(5), col(9))        # [t, tile, SEG]
                seg_min = tc.amin(dim=2)
                closer = (seg_min < t_min) & go[:, None]
                first = torch.where(tc <= seg_min[..., None], lanes, SEG).amin(dim=2)
                t_min = torch.where(closer, seg_min, t_min)
                tri_id = torch.where(closer, (seg[:, None] * SEG + first).to(torch.int32),
                                     tri_id)
        t_out[tl], id_out[tl] = t_min, tri_id
    if mode == "any":
        id_out.fill_(-1)
    return t_out.flatten(), id_out.flatten(), visited


def trace_tri(n_segs, seg_ids, seg_dist, rays_packed, tris3d, mode):
    """Closest hit (t, triangle id) or, for mode 'any', the closest t only,
    over each tile's front-to-back segment list: launches ``csrc/tri.cu``
    on CUDA tensors (the tiles with the longest lists first), runs
    ``_tri_plain`` on CPU tensors.

    Args:
      n_segs: i32[T], listed segments per tile (<= max_chunks).
      seg_ids: i32[T, max_chunks], segment ids in list order.
      seg_dist: f32[T, max_chunks], entry lower bounds (non-decreasing).
      rays_packed: f32[T * tile, 16] (``_pack_rays``).
      tris3d: f32[n_tri_segs, 16, 128] (``_pack_tris``).
      mode: 'closest' or 'any'.

    Returns (t f32[T * tile], BIG where no hit; id i32[T * tile], -1 where
    no hit and everywhere for 'any').
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    n_tiles = n_segs.shape[0] if n_segs.dim() == 1 else 0
    device = _kernels.check_tensors("trace_tri", (n_segs, seg_ids),
                                    (seg_dist, rays_packed, tris3d))
    if (n_tiles == 0 or seg_ids.dim() != 2 or seg_ids.shape[0] != n_tiles
            or seg_dist.shape != seg_ids.shape or rays_packed.dim() != 2
            or rays_packed.shape[0] % n_tiles or rays_packed.shape[1] != 16
            or tris3d.dim() != 3 or tris3d.shape[1:] != (16, SEG)):
        raise ValueError("trace_tri: inconsistent shapes "
                         f"{[tuple(x.shape) for x in (n_segs, seg_ids, seg_dist, rays_packed, tris3d)]}")
    tile = rays_packed.shape[0] // n_tiles
    if device.type == "cpu":
        return _tri_plain(n_segs, seg_ids, seg_dist, rays_packed, tris3d, mode)[:2]
    if tile > MAX_TILE:
        raise ValueError(f"tile {tile} > {MAX_TILE} rays per block")
    # the tiles with the longest lists first (results go back to tile order)
    order = _kernels.longest_first(n_segs)
    args = [n_segs[order], seg_ids[order], seg_dist[order],
            rays_packed.reshape(n_tiles, tile, 16)[order].reshape(-1, 16),
            _kernels.aligned(tris3d)]
    t_o = torch.empty((n_tiles, tile), dtype=torch.float32, device=device)
    ids_o = torch.empty((n_tiles, tile), dtype=torch.int32, device=device)
    _kernels.launch("tri", "grace_tri", device, *[a.data_ptr() for a in args],
                    t_o.data_ptr(), ids_o.data_ptr(), n_tiles, tile, seg_ids.shape[1],
                    tris3d.shape[0], MODES.index(mode), CHUNK)
    trace_tri.launches += 1
    trace_tri.launches_any += mode == "any"
    t = torch.empty_like(t_o).index_copy_(0, order, t_o)
    ids = torch.empty_like(ids_o).index_copy_(0, order, ids_o)
    return t.flatten(), ids.flatten()


trace_tri.launches = 0      # every launch
trace_tri.launches_any = 0  # the any-hit launches among them


def pallas_trace_tri(rays: Rays, tris: torch.Tensor, tile: int = 32, max_chunks: int = 2048,
                     mode: str = "closest", n_cull_intervals: int = N_CULL_INTERVALS
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closest-hit (mode='closest': t f32[R], inf where missed, and triangle
    i32[R], -1 where missed) or occlusion (mode='any': occluded bool[R]
    and -1s) trace of a triangle mesh f32[N, 3, 3], plus the per-tile
    overflow flags (a tile that lists more than ``max_chunks`` segments
    traces only the first ``max_chunks``). Same signature as
    ``grace_tpu``'s, minus ``interpret``."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    n_rays = rays.n_rays
    rays = _pad_rays(rays, tile)
    flat = tris.reshape(-1, 3)
    rays = clip_rays_to_aabb(rays, flat.amin(dim=0), flat.amax(dim=0))
    seg_ids, seg_dist, n_segs, overflow = _dense_tile_segments_tri(
        rays, tris, tile, max_chunks, n_intervals=n_cull_intervals)
    packed, _ = _pack_rays(rays, tile)
    tris3d, _ = _pack_tris(tris)
    t, ids = trace_tri(n_segs, seg_ids, seg_dist, packed, tris3d, mode)
    t = t[:n_rays]
    miss = t >= BIG
    if mode == "any":
        return ~miss, torch.full((n_rays,), -1, dtype=torch.int32, device=t.device), overflow
    return (torch.where(miss, torch.inf, t), torch.where(miss, -1, ids[:n_rays]),
            overflow)
