"""Fused SPH trace: culled ray tiles through hand-written CUDA kernels.

PyTorch counterpart of ``grace_tpu.trace.pallas_kernel``. The name
``pallas_trace_sph`` is kept so the two packages line up; in this package
it denotes the CUDA-backed fused trace, not a Pallas kernel. Two stages:

  broadphase  per ray tile, which primitives its rays may hit
              (pallas_broadphase.py, broadphase.py): bitmask words over
              128-primitive segments (``dense_tile_masks``, the default
              route) or 32-primitive quarters (``dense_tile_masks_quarter``),
              or compacted lists of quarters (``quarter_lists``) or segments
              (``dense_tile_segments``, or the BVH walk ``tile_segments``).
  kernel      one CUDA block per ray tile walks its words or list in
              ascending order and accumulates each ray's column density (or
              hit count) over the listed primitives; the segment kernels
              launch their tiles longest walk first:
                csrc/trace_bitmask.cu  segment words     (``trace_bitmask``)
                csrc/trace_quarter.cu  quarter words     (``trace_quarter``)
                csrc/trace_list.cu     quarter/segment lists (``trace_list``)

On a CPU tensor each wrapper runs its plain PyTorch version instead, the
one the tests hold against ``grace_tpu`` and the kernel.

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
from grace_tpu_torch.trace.broadphase import collect_tile_chunks
from grace_tpu_torch.trace.pallas_broadphase import (
    dense_tile_masks, dense_tile_masks_quarter, dense_tile_segments,
    quarter_lists)

DEFAULT_TILE = 512
SEG = 128  # primitives per segment; the padding granularity
QUARTER = 32  # primitives per quarter
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


def _impact(px, py, pz, ox, oy, oz, dx, dy, dz):
    """(b2, dot, bx, by, bz) of rays against primitives, broadcasting: the
    squared impact parameter, the distance along the ray to the closest
    approach and the impact vector, with the fused multiply-adds where
    ``csrc/seg_compute.cuh`` (``impact``) has them."""
    rx = px - ox
    ry = py - oy
    rz = pz - oz
    dot = fma(rz, dz, fma(rx, dx, ry * dy))
    bx = fma(-dot, dx, rx)
    by = fma(-dot, dy, ry)
    bz = fma(-dot, dz, rz)
    return fma(bz, bz, fma(bx, bx, by * by)), dot, bx, by, bz


def _seg_compute(ox, oy, oz, dx, dy, dz, ln, px, py, pz, inv_h2, h2, mode,
                 integral_deg=HORNER1_DEG):
    """Per-pair contributions of rays (column tensors) against primitives
    (row tensors): the plain version of ``csrc/seg_compute.cuh``, with the
    fused multiply-adds at the same places."""
    b2, dot, *_ = _impact(px, py, pz, ox, oy, oz, dx, dy, dz)
    along = (dot >= 0.0) & (dot < ln)
    if mode == "hitcount":
        return ((b2 < h2) & along).to(torch.float32)
    u = b2 * inv_h2
    if integral_deg < 0:
        f = cubic_spline_line_integral_direct_raw(u, -integral_deg)
        return torch.where(along & (u < 1.0), f * inv_h2, 0.0)
    f = cubic_spline_line_integral_horner1(u, deg=integral_deg)
    return torch.where(along, f * inv_h2, 0.0)


def tile_segments(rays: Rays, tree: Tree, tile: int, max_chunks: int,
                  n_prims: int, stack_size: int = 128):
    """Per-tile ascending, unique segment ids from the BVH tile walk.

    Each leaf chunk of ``collect_tile_chunks`` spans one or two segments;
    the ids are sorted, deduplicated and compacted to the front. Returns
    (seg_ids i32[n_tiles, max_chunks], n_segs i32[n_tiles], overflow
    bool[n_tiles]): overflow when the walk dropped chunks or the tile
    needs more than max_chunks segments (the first max_chunks are kept).
    """
    chunks = collect_tile_chunks(rays, tree, tile, max_chunks, stack_size)
    big = (n_prims + SEG - 1) // SEG  # sorts after every real segment id
    valid = (torch.arange(max_chunks, device=chunks.first.device)
             < chunks.n_chunks[:, None])
    lo = chunks.first >> 7
    hi = (chunks.first + torch.clamp(chunks.count - 1, min=0)) >> 7
    segs = torch.cat([torch.where(valid, lo, big),
                      torch.where(valid & (hi != lo), hi, big)], dim=1)
    segs = torch.sort(segs, dim=1).values
    fresh = torch.cat([torch.ones_like(segs[:, :1], dtype=torch.bool),
                       segs[:, 1:] != segs[:, :-1]], dim=1) & (segs < big)
    order = torch.argsort((~fresh).to(torch.int8), dim=1, stable=True)
    segs_u = torch.gather(segs, 1, order)
    n_segs = fresh.sum(dim=1, dtype=torch.int32)
    seg_ids = torch.where(torch.arange(segs.shape[1], device=segs.device) < n_segs[:, None],
                          segs_u, 0)[:, :max_chunks].contiguous()
    return (seg_ids, torch.clamp(n_segs, max=max_chunks),
            chunks.overflow | (n_segs > max_chunks))


def _set_bits(row: torch.Tensor) -> torch.Tensor:
    """Ascending ids of the set bits of an i32 row (bit b of word w is
    id w*32+b)."""
    bits = torch.arange(32, device=row.device)
    return torch.nonzero(((row[:, None] >> bits) & 1).reshape(-1)).flatten()


def _listed_quarters(summary_row, words_row):
    """Ascending quarter ids a tile's summary and words list."""
    w_ids = _set_bits(summary_row)
    w_ids = w_ids[w_ids < words_row.shape[0]]
    bits = torch.arange(32, device=words_row.device)
    qbit = ((words_row[w_ids][:, None] >> bits) & 1).bool()
    return (w_ids[:, None] * 32 + bits)[qbit]


def _trace_plain(rays_packed, prims, n_tiles, group_ids, group, integral_deg, mode):
    """Plain PyTorch trace, one tile at a time: ``group_ids(t)`` lists tile
    t's primitive groups (primitives [group g, group g + group))."""
    tile = rays_packed.shape[0] // n_tiles
    out = torch.zeros(rays_packed.shape[0], dtype=torch.float32,
                      device=rays_packed.device)
    lanes = torch.arange(group, device=prims.device)
    for t in range(n_tiles):
        g = group_ids(t)
        if g.numel() == 0:
            continue
        slab = prims[:, (g.long()[:, None] * group + lanes).flatten()]
        r = rays_packed[t * tile:(t + 1) * tile]
        col = lambda k: r[:, k:k + 1]
        contrib = _seg_compute(col(0), col(1), col(2), col(3), col(4), col(5),
                               col(9), slab[0], slab[1], slab[2], slab[4],
                               slab[5], mode, integral_deg)
        out[t * tile:(t + 1) * tile] = contrib.sum(dim=1)
    return out


def _trace_quarter_plain(summary, words, rays_packed, prims, integral_deg, mode):
    """Plain PyTorch version of the quarter kernel."""
    return _trace_plain(rays_packed, prims, words.shape[0],
                        lambda t: _listed_quarters(summary[t], words[t]), QUARTER,
                        integral_deg, mode)


def _trace_bitmask_plain(words, rays_packed, prims, integral_deg, mode):
    """Plain PyTorch version of the segment-bitmask kernel; bits past the
    last segment are ignored."""
    n_segs = prims.shape[1] // SEG

    def segs(t):
        ids = _set_bits(words[t])
        return ids[ids < n_segs]

    return _trace_plain(rays_packed, prims, words.shape[0], segs, SEG,
                        integral_deg, mode)


def _trace_list_plain(counts, ids, rays_packed, prims, group, integral_deg, mode):
    """Plain PyTorch version of the list kernel: the first
    min(count, max_len) ids of each row."""
    max_len = ids.shape[1]
    lens = torch.clamp(counts, 0, max_len).tolist()
    return _trace_plain(rays_packed, prims, ids.shape[0], lambda t: ids[t, :lens[t]],
                        group, integral_deg, mode)


@functools.lru_cache(maxsize=None)
def _coeff_tensor(integral_deg: int, device: str) -> torch.Tensor:
    return torch.from_numpy(integral_coeffs(integral_deg)).to(device)


def _check_args(name, lists, rays_packed, prims, n_tiles, mode):
    """Device, dtype and shared shape checks of a trace wrapper. Returns
    (device, rays per tile)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    device = _kernels.check_tensors(name, lists, (rays_packed, prims))
    if (n_tiles == 0 or rays_packed.dim() != 2 or rays_packed.shape[0] % n_tiles
            or rays_packed.shape[1] != 16 or prims.dim() != 2
            or prims.shape[0] != 8 or prims.shape[1] % SEG):
        raise ValueError(f"{name}: inconsistent shapes "
                         f"{[tuple(x.shape) for x in (*lists, rays_packed, prims)]}")
    tile = rays_packed.shape[0] // n_tiles
    if device.type == "cuda" and tile > MAX_TILE:
        raise ValueError(f"tile {tile} > {MAX_TILE} rays per block")
    return device, tile


def _launch(name, entry, device, tensors, ints, rays_packed, integral_deg, mode):
    """Launch a trace kernel on ``device`` (a None tensor passes a null
    pointer); returns f32[R_pad]."""
    args = [None if t is None else t.contiguous() for t in tensors]
    coeffs = _coeff_tensor(integral_deg, str(device))
    out = torch.empty(rays_packed.shape[0], dtype=torch.float32, device=device)
    _kernels.launch(name, entry, device, *[None if a is None else a.data_ptr() for a in args],
                    coeffs.data_ptr(), out.data_ptr(), *ints, integral_deg,
                    MODES.index(mode))
    return out


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
    n_tiles, n_words = words.shape
    device, tile = _check_args("trace_quarter", (summary, words), rays_packed,
                               prims, n_tiles, mode)
    if (summary.shape != (n_tiles, (n_words + 31) // 32)
            or n_words != (prims.shape[1] // QUARTER + 31) // 32):
        raise ValueError("trace_quarter: inconsistent shapes "
                         f"{summary.shape} {words.shape} {prims.shape}")
    if device.type == "cpu":
        return _trace_quarter_plain(summary, words, rays_packed, prims,
                                    integral_deg, mode)
    out = _launch("trace_quarter", "grace_trace_quarter", device,
                  (summary, words, rays_packed, prims),
                  (n_tiles, tile, summary.shape[1], n_words, prims.shape[1]),
                  rays_packed, integral_deg, mode)
    trace_quarter.launches += 1
    return out


trace_quarter.launches = 0


@functools.lru_cache(maxsize=None)
def _byte_bits(device: str) -> torch.Tensor:
    """u8[256]: the set bits of each byte value."""
    return torch.tensor([bin(b).count("1") for b in range(256)], dtype=torch.uint8,
                        device=device)


def _row_set_bits(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each row of i32 words, i32[n_rows]: each word's four
    bytes looked up in a 256-entry table and summed along the row (three
    tensor operations; a SWAR popcount takes fifteen, and on the card each
    costs a launch)."""
    row_bytes = words.contiguous().view(torch.uint8)
    return _byte_bits(str(words.device))[row_bytes.int()].sum(dim=1, dtype=torch.int32)


def bitmask_tile_order(words: torch.Tensor) -> torch.Tensor:
    """Launch order of ``trace_bitmask``'s tiles: by the number of set bits
    in each tile's words (the segments its block walks), longest first,
    ties in tile order; i32[n_tiles]."""
    return _kernels.longest_first(_row_set_bits(words)).to(torch.int32)


def quarter_tile_order(words: torch.Tensor) -> torch.Tensor:
    """Launch order of ``records_quarter``'s tiles: by the quarters each
    tile's quarter words list (their set bits), longest first, ties in tile
    order; i32[n_tiles]. The same count as ``bitmask_tile_order``'s, on
    words of 32-primitive quarters."""
    return bitmask_tile_order(words)


def list_tile_order(counts: torch.Tensor, max_len: int) -> torch.Tensor:
    """Launch order of ``trace_list``'s tiles on segment lists: by the
    entries each block reads, min(count, max_len), longest first, ties in
    tile order; i32[n_tiles]."""
    return _kernels.longest_first(torch.clamp(counts, 0, max_len)).to(torch.int32)


def trace_bitmask(words, rays_packed, prims, integral_deg, mode):
    """Per-ray column density / hit count over the 128-primitive segments
    each tile's words list: launches ``csrc/trace_bitmask.cu`` on CUDA
    tensors, its tiles in ``bitmask_tile_order``, runs
    ``_trace_bitmask_plain`` on CPU tensors.

    Args:
      words: i32[n_tiles, ceil(n_segs / 32)], bit s of word w = segment
        w*32+s (``dense_tile_masks``); bits past n_segs are ignored.
      rays_packed: f32[n_tiles * tile, 16] (``_pack_rays``).
      prims: f32[8, N_pad] (``_pack_prims``), n_segs = N_pad / 128.
      integral_deg, mode: as ``pallas_trace_sph``.

    Returns f32[n_tiles * tile].
    """
    n_tiles, n_words = words.shape if words.dim() == 2 else (0, 0)
    device, tile = _check_args("trace_bitmask", (words,), rays_packed, prims,
                               n_tiles, mode)
    n_segs = prims.shape[1] // SEG
    if n_words != (n_segs + 31) // 32:
        raise ValueError(f"trace_bitmask: {n_words} words per tile, "
                         f"{n_segs} segments need {(n_segs + 31) // 32}")
    if device.type == "cpu":
        return _trace_bitmask_plain(words, rays_packed, prims, integral_deg, mode)
    out = _launch("trace_bitmask", "grace_trace_bitmask", device,
                  (words, bitmask_tile_order(words), rays_packed, _kernels.aligned(prims)),
                  (n_tiles, tile, n_words, n_segs),
                  rays_packed, integral_deg, mode)
    trace_bitmask.launches += 1
    return out


trace_bitmask.launches = 0


def trace_list(counts, ids, rays_packed, prims, group, integral_deg, mode):
    """Per-ray column density / hit count over each tile's list of
    ``group``-primitive groups: launches ``csrc/trace_list.cu`` on CUDA
    tensors (segment lists longest first, quarter lists as listed), runs
    ``_trace_list_plain`` on CPU tensors.

    Args:
      counts: i32[n_tiles], listed groups per tile (only the first
        min(count, max_len) ids of a row are read).
      ids: i32[n_tiles, max_len], group g = primitives
        [group g, group g + group), each in [0, N_pad / group).
      rays_packed: f32[n_tiles * tile, 16] (``_pack_rays``).
      prims: f32[8, N_pad] (``_pack_prims``).
      group: 32 (quarter lists) or 128 (segment lists).
      integral_deg, mode: as ``pallas_trace_sph``.

    Returns f32[n_tiles * tile].
    """
    n_tiles = counts.shape[0] if counts.dim() == 1 else 0
    device, tile = _check_args("trace_list", (counts, ids), rays_packed, prims,
                               n_tiles, mode)
    if group not in (QUARTER, SEG):
        raise ValueError(f"trace_list: group {group} is not {QUARTER} or {SEG}")
    if ids.dim() != 2 or ids.shape[0] != n_tiles:
        raise ValueError(f"trace_list: ids {tuple(ids.shape)} for {n_tiles} tiles")
    if device.type == "cpu":
        return _trace_list_plain(counts, ids, rays_packed, prims, group,
                                 integral_deg, mode)
    max_len = ids.shape[1]
    order = list_tile_order(counts, max_len) if group == SEG else None
    out = _launch("trace_list", "grace_trace_list", device,
                  (counts, ids, order, rays_packed, _kernels.aligned(prims)),
                  (n_tiles, tile, max_len, group, prims.shape[1]),
                  rays_packed, integral_deg, mode)
    trace_list.launches += 1
    trace_list.launches_seg += group == SEG
    return out


trace_list.launches = 0  # every launch
trace_list.launches_seg = 0  # of them, on segment lists (group 128)


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

    Same signature and routes as ``grace_tpu``'s, minus ``interpret``.
    Returns (per_ray_values f32/i32[R], overflow bool[n_tiles]); an
    overflowed tile has an incomplete sum (re-run with a larger
    ``max_chunks``). ``broadphase``:

      'dense' (default; with subtiles == 1) or 'bitmask'
               segment bitmask words -> ``trace_bitmask``; ``masks`` may
               supply the words (``masks_for_tile_aabbs`` over the same
               tile-padded rays); never overflows.
      'quarter' quarter words + summary -> ``trace_quarter``; never
               overflows.
      'qlist'  compacted quarter lists of at most ``max_chunks`` (a
               multiple of 4) -> ``trace_list``; real overflow flags.
      'list', 'pallas' (and 'dense' with subtiles > 1)
               compacted segment lists of at most ``max_chunks`` ->
               ``trace_list``; real overflow flags.
      'xla'    segment lists from the BVH tile walk (needs ``tree``;
               ``stack_size`` bounds its stack) -> ``trace_list``.

    ``subtiles > 1`` (the list routes) gives the same values as
    ``subtiles=1``: ``grace_tpu`` grouped fine tiles per TPU program, one
    CUDA block per fine tile does the same work. ``vmem_resident_limit``
    chose the TPU kernels' residency; the slabs stay in device memory here
    either way, but it still decides, as in ``grace_tpu``, which calls are
    accepted: 'qlist' and ``subtiles > 1`` raise ValueError unless the
    slabs (N_pad * 32 bytes) fit it. ``unroll`` is not read.
    ``integral_deg`` selects the line-integral flavor (see
    ``kernel_integrals.cubic_spline_line_integral_horner1``) on every
    route; ``grace_tpu``'s streaming bitmask and list kernels ignore it
    and use degree 14.
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if tree is None and broadphase == "xla":
        raise ValueError("broadphase='xla' requires a tree")
    n_rays = rays.n_rays
    rays = _pad_rays(rays, tile)
    packed, r_pad = _pack_rays(rays, tile)
    prims, n_pad = _pack_prims(spheres)
    n_tiles = r_pad // tile
    resident = (n_pad // SEG) * 8 * SEG * 4 <= vmem_resident_limit
    no_overflow = torch.zeros(n_tiles, dtype=torch.bool, device=packed.device)
    if broadphase == "qlist":
        if not resident:
            raise ValueError("broadphase='qlist' requires the particle slabs to fit "
                             "vmem_resident_limit; use broadphase='quarter'")
        if max_chunks % 4:
            raise ValueError("qlist max_chunks must be a multiple of 4")
        ids, n, overflow = quarter_lists(rays, spheres, tile, max_q=max_chunks)
        values = trace_list(n, ids, packed, prims, QUARTER, integral_deg, mode)
    elif broadphase == "quarter":
        words, summary = dense_tile_masks_quarter(rays, spheres, tile)
        values = trace_quarter(summary, words, packed, prims, integral_deg, mode)
        overflow = no_overflow
    elif broadphase == "bitmask" or (broadphase == "dense" and subtiles == 1):
        if masks is None:
            masks = dense_tile_masks(rays, spheres, tile)
        if masks.shape[0] != n_tiles:
            raise ValueError(f"precomputed masks cover {masks.shape[0]} tiles, kernel "
                             f"needs {n_tiles} (tile-padded rays)")
        values = trace_bitmask(masks, packed, prims, integral_deg, mode)
        overflow = no_overflow
    else:
        if broadphase in ("dense", "pallas", "list"):
            ids, n, overflow = dense_tile_segments(rays, spheres, tile, max_chunks)
        else:
            ids, n, overflow = tile_segments(rays, tree, tile, max_chunks,
                                             spheres.shape[0], stack_size)
        if subtiles > 1:
            if not resident:
                raise ValueError("subtiles > 1 requires the particle slabs to fit "
                                 "vmem_resident_limit")
            if n_tiles % subtiles:
                raise ValueError("ray count must fill whole subtile groups")
        values = trace_list(n, ids, packed, prims, SEG, integral_deg, mode)
    values = values[:n_rays]
    if mode == "hitcount":
        values = values.to(torch.int32)
    return values, overflow
