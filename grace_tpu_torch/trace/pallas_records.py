"""Per-hit records in one pass through a hand-written CUDA kernel.

PyTorch counterpart of ``grace_tpu.trace.pallas_records``. The name
``pallas_trace_sph_records`` is kept so the two packages line up; here it
launches ``csrc/records.cu``. Each ray gets a fixed-capacity row of
(primitive index, line integral, distance) records in ascending primitive
order, and an exact hit count even when it overflows its row (the excess
records are dropped).

``grace_tpu``'s TPU kernels drained each slab's hits by within-slab rank
(one-hot picks or a shift network) because a TPU lane has no scatter
cursor. On the card one thread is one ray with a cursor in a register: it
tests the staged primitives in order and appends each hit at its cursor.
So ``rank_method``, ``group`` and ``drain`` are checked as ``grace_tpu``
checks them and select nothing; every value gives the same records. The
kernels launch the tiles longest mask row first (``quarter_tile_order``,
``bitmask_tile_order``) and write each tile's rows in place, so the launch
order changes no bit either.

Broadphase as ``grace_tpu``'s: 32-primitive quarter words
(``dense_tile_masks_quarter``, the default while the slabs fit
``vmem_resident_limit``) or 128-primitive segment words
(``dense_tile_masks``). The slabs live in device memory for any scene, so
one kernel per broadphase serves the TPU's resident and streaming kernels.

The records' post-processing is ``csrc/segsort.cu`` on CUDA tensors:
``sort_records_by_distance`` (``sort_rows_cuda``: a warp a row, a
bitonic network in registers over the prefix that holds records; rows
wider than ``segops.SEG_CHUNK`` take the segmented sort's chunks and
merges) and ``records_to_flat``
(``records_to_flat_cuda``: a warp a row, no boolean indexing, no host
sync).

On a CPU tensor each kernel wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

import numpy as np

from grace_tpu_torch import _kernels
from grace_tpu_torch.core.types import Rays
from grace_tpu_torch.ops import segops
from grace_tpu_torch.sph.kernel_integrals import HORNER1_DEG, cubic_spline_line_integral_horner1
from grace_tpu_torch.trace.pallas_broadphase import dense_tile_masks, dense_tile_masks_quarter
from grace_tpu_torch.trace.pallas_kernel import (
    MAX_TILE, QUARTER, SEG, _coeff_tensor, _impact, _listed_quarters, _pack_prims,
    _pack_rays, _pad_rays, _set_bits, bitmask_tile_order, quarter_tile_order)

INDEX_SENTINEL = -1
VALUE_SENTINEL = 0.0
DISTANCE_SENTINEL = -1.0


class RecordTraceResult(NamedTuple):
    """Per-ray-capacity record layout (row r holds ray r's hits).

    Entries with column >= min(counts[r], capacity) hold the sentinels
    (index -1, integral 0, distance -1). counts are exact hit counts even
    when a ray overflows its capacity (the excess records are dropped)."""

    counts: torch.Tensor      # i32[R]
    indices: torch.Tensor     # i32[R, C] hit sphere indices (sorted order)
    integrals: torch.Tensor   # f32[R, C]
    distances: torch.Tensor   # f32[R, C]

    @property
    def capacity(self) -> int:
        return self.indices.shape[1]

    @property
    def overflowed(self) -> torch.Tensor:
        return self.counts > self.indices.shape[1]


def _records_plain(rays_packed, prims, n_tiles, prim_ids, cap):
    """Plain PyTorch record kernel, one tile at a time: ``prim_ids(t)``
    lists tile t's primitives in ascending order. Returns (counts i32[R],
    idx i32[R, C], integral f32[R, C], distance f32[R, C])."""
    r_pad = rays_packed.shape[0]
    tile = r_pad // n_tiles
    dev = rays_packed.device
    counts = torch.zeros(r_pad, dtype=torch.int32, device=dev)
    idx = torch.full((r_pad, cap), INDEX_SENTINEL, dtype=torch.int32, device=dev)
    intg = torch.full((r_pad, cap), VALUE_SENTINEL, dtype=torch.float32, device=dev)
    dist = torch.full((r_pad, cap), DISTANCE_SENTINEL, dtype=torch.float32, device=dev)
    for t in range(n_tiles):
        p = prim_ids(t).long()
        if p.numel() == 0:
            continue
        slab = prims[:, p]
        r = rays_packed[t * tile:(t + 1) * tile]
        col = lambda k: r[:, k:k + 1]
        b2, dot, *_ = _impact(slab[0], slab[1], slab[2], col(0), col(1), col(2),
                              col(3), col(4), col(5))
        hit = (b2 < slab[5]) & (dot >= 0.0) & (dot < col(9))
        hit_i = hit.to(torch.int32)
        rank = torch.cumsum(hit_i, dim=1, dtype=torch.int32) - hit_i
        counts[t * tile:(t + 1) * tile] = hit_i.sum(dim=1, dtype=torch.int32)
        keep = hit & (rank < cap)
        if not bool(keep.any()):
            continue
        ray, j = torch.nonzero(keep, as_tuple=True)
        row, c = ray + t * tile, rank[ray, j].long()
        u = b2[ray, j] * slab[4, j]
        idx[row, c] = p[j].to(torch.int32)
        intg[row, c] = cubic_spline_line_integral_horner1(u) * slab[4, j]
        dist[row, c] = dot[ray, j]
    return counts, idx, intg, dist


def _records_quarter_plain(summary, words, rays_packed, prims, cap):
    """Plain PyTorch version of the quarter record kernel."""
    lanes = torch.arange(QUARTER, device=prims.device)

    def prim_ids(t):
        return (_listed_quarters(summary[t], words[t])[:, None] * QUARTER + lanes).flatten()

    return _records_plain(rays_packed, prims, words.shape[0], prim_ids, cap)


def _records_bitmask_plain(words, rays_packed, prims, cap):
    """Plain PyTorch version of the segment-bitmask record kernel; bits past
    the last segment are ignored."""
    n_segs = prims.shape[1] // SEG
    lanes = torch.arange(SEG, device=prims.device)

    def prim_ids(t):
        segs = _set_bits(words[t])
        return (segs[segs < n_segs][:, None] * SEG + lanes).flatten()

    return _records_plain(rays_packed, prims, words.shape[0], prim_ids, cap)


def _check_args(name, lists, rays_packed, prims, n_tiles, cap):
    """Device, dtype and shared shape checks of a record wrapper. Returns
    (device, rays per tile)."""
    device = _kernels.check_tensors(name, lists, (rays_packed, prims))
    if (n_tiles == 0 or rays_packed.dim() != 2 or rays_packed.shape[0] % n_tiles
            or rays_packed.shape[1] != 16 or prims.dim() != 2
            or prims.shape[0] != 8 or prims.shape[1] % SEG):
        raise ValueError(f"{name}: inconsistent shapes "
                         f"{[tuple(x.shape) for x in (*lists, rays_packed, prims)]}")
    if cap < 1:
        raise ValueError(f"{name}: capacity {cap} < 1")
    tile = rays_packed.shape[0] // n_tiles
    if device.type == "cuda" and tile > MAX_TILE:
        raise ValueError(f"tile {tile} > {MAX_TILE} rays per block")
    return device, tile


def _check_quarter(summary, words, rays_packed, prims, cap):
    """``records_quarter``'s checks; returns (device, rays per tile)."""
    n_tiles, n_words = words.shape
    device, tile = _check_args("records_quarter", (summary, words), rays_packed, prims,
                               n_tiles, cap)
    if (summary.shape != (n_tiles, (n_words + 31) // 32)
            or n_words != (prims.shape[1] // QUARTER + 31) // 32):
        raise ValueError("records_quarter: inconsistent shapes "
                         f"{summary.shape} {words.shape} {prims.shape}")
    return device, tile


def _check_bitmask(words, rays_packed, prims, cap):
    """``records_bitmask``'s checks; returns (device, rays per tile)."""
    n_tiles, n_words = words.shape if words.dim() == 2 else (0, 0)
    device, tile = _check_args("records_bitmask", (words,), rays_packed, prims, n_tiles,
                               cap)
    n_segs = prims.shape[1] // SEG
    if n_words != (n_segs + 31) // 32:
        raise ValueError(f"records_bitmask: {n_words} words per tile, "
                         f"{n_segs} segments need {(n_segs + 31) // 32}")
    return device, tile


def _outputs(rays_packed, cap):
    """Uninitialised (counts, idx, integral, distance) for a record kernel,
    which writes every entry."""
    r_pad, dev = rays_packed.shape[0], rays_packed.device
    return (torch.empty(r_pad, dtype=torch.int32, device=dev),
            torch.empty((r_pad, cap), dtype=torch.int32, device=dev),
            torch.empty((r_pad, cap), dtype=torch.float32, device=dev),
            torch.empty((r_pad, cap), dtype=torch.float32, device=dev))


def _launch(entry, tensors, ints, outs):
    """Launch a record kernel on the device of ``outs`` (counts, idx,
    integral, distance), which it fills; returns ``outs``."""
    args = [t.contiguous() for t in tensors]
    device = outs[0].device
    coeffs = _coeff_tensor(HORNER1_DEG, str(device))
    _kernels.launch("records", entry, device, *[a.data_ptr() for a in args],
                    coeffs.data_ptr(), *[o.data_ptr() for o in outs], *ints, outs[1].shape[1],
                    HORNER1_DEG)
    return outs


def _quarter_launch(summary, words, rays_packed, prims, order, outs):
    n_tiles, n_words = words.shape
    out = _launch("grace_records_quarter",
                  (summary, words, order, rays_packed, _kernels.aligned(prims)),
                  (n_tiles, rays_packed.shape[0] // n_tiles, summary.shape[1], n_words,
                   prims.shape[1]), outs)
    records_quarter.launches += 1
    return out


def _bitmask_launch(words, rays_packed, prims, order, outs):
    n_tiles, n_words = words.shape
    out = _launch("grace_records_bitmask", (words, order, rays_packed, _kernels.aligned(prims)),
                  (n_tiles, rays_packed.shape[0] // n_tiles, n_words, prims.shape[1] // SEG),
                  outs)
    records_bitmask.launches += 1
    return out


def records_quarter(summary, words, rays_packed, prims, cap):
    """Per-ray record rows over the quarters each tile's masks list:
    launches ``csrc/records.cu`` (``grace_records_quarter``) on CUDA
    tensors, its tiles in ``quarter_tile_order``, runs
    ``_records_quarter_plain`` on CPU tensors.

    Args:
      summary: i32[n_tiles, ceil(n_words / 32)].
      words: i32[n_tiles, n_words], bit q of word w = quarter w*32+q.
      rays_packed: f32[n_tiles * tile, 16] (``_pack_rays``).
      prims: f32[8, N_pad] (``_pack_prims``); n_words = ceil(N_pad / 1024).
      cap: records per ray row.

    Returns (counts i32[R_pad], indices i32[R_pad, cap], integrals
    f32[R_pad, cap], distances f32[R_pad, cap]).
    """
    device, _ = _check_quarter(summary, words, rays_packed, prims, cap)
    if device.type == "cpu":
        return _records_quarter_plain(summary, words, rays_packed, prims, cap)
    return _quarter_launch(summary, words, rays_packed, prims, quarter_tile_order(words),
                           _outputs(rays_packed, cap))


records_quarter.launches = 0


def records_bitmask(words, rays_packed, prims, cap):
    """Per-ray record rows over the 128-primitive segments each tile's
    words list: launches ``csrc/records.cu`` (``grace_records_bitmask``) on
    CUDA tensors, its tiles in ``bitmask_tile_order``, runs
    ``_records_bitmask_plain`` on CPU tensors.

    Args:
      words: i32[n_tiles, ceil(n_segs / 32)], bit s of word w = segment
        w*32+s (``dense_tile_masks``); bits past n_segs are ignored.
      rays_packed: f32[n_tiles * tile, 16] (``_pack_rays``).
      prims: f32[8, N_pad] (``_pack_prims``), n_segs = N_pad / 128.
      cap: as ``records_quarter``.

    Returns as ``records_quarter``.
    """
    device, _ = _check_bitmask(words, rays_packed, prims, cap)
    if device.type == "cpu":
        return _records_bitmask_plain(words, rays_packed, prims, cap)
    return _bitmask_launch(words, rays_packed, prims, bitmask_tile_order(words),
                           _outputs(rays_packed, cap))


records_bitmask.launches = 0


def _records_launch(route, args, order, outs):
    """The record kernel of ``route`` ('quarter' or 'bitmask') on the CUDA
    arguments its wrapper takes (``args``, the capacity left out), its
    tiles launched in ``order`` in place of the wrapper's longest row
    first, into ``outs`` (as ``_outputs`` gives them; every entry is
    written): for checks that neither the launch order nor what the
    outputs held before changes a bit.

    ``order``: i32[n_tiles] on the arguments' device, a permutation of the
    tiles (block b works on tile order[b]); checked, with a host sync.
    """
    check, launch = {"quarter": (_check_quarter, _quarter_launch),
                     "bitmask": (_check_bitmask, _bitmask_launch)}[route]
    device, _ = check(*args, outs[1].shape[1])
    n_tiles = args[-3].shape[0]
    if (not isinstance(order, torch.Tensor) or order.dtype != torch.int32
            or order.shape != (n_tiles,) or order.device != device):
        raise ValueError(f"records_{route}: order must be i32[{n_tiles}] on {device}")
    if not torch.equal(torch.sort(order).values,
                       torch.arange(n_tiles, dtype=torch.int32, device=device)):
        raise ValueError(f"records_{route}: order is not a permutation of the {n_tiles} tiles")
    want = [(t.shape, t.dtype, t.device) for t in _outputs(args[-2], outs[1].shape[1])]
    if ([(t.shape, t.dtype, t.device) for t in outs] != want
            or not all(t.is_contiguous() for t in outs)):
        raise ValueError(f"records_{route}: outputs must be contiguous {want}")
    if device.type != "cuda":
        raise ValueError(f"records_{route}: the kernel runs on CUDA tensors, not {device}")
    return launch(*args, order, outs)


def pallas_trace_sph_records(
    rays: Rays,
    spheres: torch.Tensor,
    per_ray_capacity: int,
    tile: int = 64,
    vmem_resident_limit: int = 40 * 1024 * 1024,
    rank_method: str = "mxu",
    group: int = 8,
    drain: str = "pick",
    broadphase: str = "auto",
) -> RecordTraceResult:
    """Single-pass per-hit trace. ``per_ray_capacity`` must be a multiple of
    128. Same signature as ``grace_tpu``'s, minus ``interpret``.

    Hit records of ray r land in row r in ascending primitive index order,
    with the degree-14 ``horner1`` integral F(b/h) / h^2 and the distance
    along the ray to the closest approach. ``broadphase``: 'quarter'
    (quarter words; only while the slabs, N_pad * 32 bytes, fit
    ``vmem_resident_limit``, as in ``grace_tpu``), 'bitmask' (segment
    words), or 'auto' (quarter when they fit, else bitmask).
    ``rank_method``, ``group`` and ``drain`` chose the TPU drain; they are
    checked and do not change the records.
    """
    if per_ray_capacity % 128:
        raise ValueError("per_ray_capacity must be a multiple of 128 lanes")
    if drain not in ("pick", "network"):
        raise ValueError(f"unknown drain {drain!r} (expected 'pick' or 'network')")
    if rank_method not in ("prefix", "mxu"):
        raise ValueError(f"unknown rank_method {rank_method!r} (expected "
                         "'prefix' or 'mxu')")
    if broadphase not in ("auto", "bitmask", "quarter"):
        raise ValueError(f"unknown broadphase {broadphase!r} (expected "
                         "'auto', 'bitmask' or 'quarter')")
    n_rays = rays.n_rays
    rays = _pad_rays(rays, tile)
    packed, _ = _pack_rays(rays, tile)
    prims, n_pad = _pack_prims(spheres)
    resident = (n_pad // SEG) * 8 * SEG * 4 <= vmem_resident_limit
    if broadphase == "auto":
        broadphase = "quarter" if resident else "bitmask"
    if broadphase == "quarter":
        if not resident:
            raise ValueError(
                "broadphase='quarter' requires the VMEM-resident regime; "
                "use the default bitmask broadphase for larger scenes")
        words, summary = dense_tile_masks_quarter(rays, spheres, tile)
        out = records_quarter(summary, words, packed, prims, per_ray_capacity)
    else:
        out = records_bitmask(dense_tile_masks(rays, spheres, tile), packed, prims,
                              per_ray_capacity)
    counts, idx, intg, dist = out
    return RecordTraceResult(counts[:n_rays], idx[:n_rays], intg[:n_rays], dist[:n_rays])


def sort_records_by_distance(rec: RecordTraceResult) -> RecordTraceResult:
    """Per-ray distance sort of the record rows: one stable sort along the
    row, with the sentinel slots keyed to +inf so they stay at the tail and
    equal distances keep their column order. CUDA tensors launch
    ``sort_rows_cuda``, CPU tensors run ``_sort_records_by_distance_plain``."""
    if segops._on_cpu(rec.distances):
        return _sort_records_by_distance_plain(rec)
    return sort_rows_cuda(rec)


def _sort_records_by_distance_plain(rec: RecordTraceResult) -> RecordTraceResult:
    """Plain PyTorch version of ``sort_records_by_distance``."""
    key = torch.where(rec.indices == INDEX_SENTINEL, torch.inf, rec.distances)
    order = torch.sort(segops._compare_form(key), dim=1, stable=True).indices
    take = lambda x: torch.gather(x, 1, order)
    return RecordTraceResult(rec.counts, take(rec.indices), take(rec.integrals),
                             take(rec.distances))


def _check_rows(name, rec: RecordTraceResult):
    """The record rows' checks of the segsort wrappers; returns (device,
    rows, width)."""
    device = _kernels.check_tensors(name, [rec.counts, rec.indices],
                                    [rec.integrals, rec.distances])
    n, c = rec.indices.shape if rec.indices.dim() == 2 else (-1, -1)
    if (c < 0 or rec.counts.shape != (n,) or rec.integrals.shape != (n, c)
            or rec.distances.shape != (n, c)):
        raise ValueError(f"{name}: inconsistent record shapes "
                         f"{[tuple(t.shape) for t in rec]}")
    if n * (c + 1) >= 1 << 31:
        raise ValueError(f"{name}: {n} rows of {c}; the kernels take fewer than 2^31 slots")
    return device, n, c


def sort_rows_cuda(rec: RecordTraceResult) -> RecordTraceResult:
    """``csrc/segsort.cu``'s row sort (E8, ``grace_sort_rows``):
    ``sort_records_by_distance`` on CUDA tensors, persistent warps each
    sorting a row of up to ``segops.SEG_CHUNK`` slots while the next row
    loads, only over the prefix that ends with the row's last record (a
    stable merge sort of u32 keys, skipped where the prefix is in order;
    the sentinel tail keeps its place: the bits of a whole-row sort);
    wider rows go through the segmented sort's launches with one segment
    a row (its order check, chunks and merges)."""
    device, n, c = _check_rows("sort_records_by_distance", rec)
    idx, intg, dist = (t.contiguous() for t in rec[1:])
    if n == 0 or c == 0:
        return RecordTraceResult(rec.counts, idx.clone(), intg.clone(), dist.clone())
    if c <= segops.SEG_CHUNK:
        outs = [torch.empty_like(t) for t in (idx, intg, dist)]
        _kernels.launch("segsort", "grace_sort_rows", device, dist.data_ptr(), idx.data_ptr(),
                        intg.data_ptr(), *[t.data_ptr() for t in outs], n, c)
    else:
        offsets = torch.arange(0, n * c, c, dtype=torch.int32, device=device)
        outs = segops._segsort_launch(dist.reshape(-1), idx.reshape(-1), offsets, None,
                                      [t.reshape(-1) for t in (idx, intg, dist)],
                                      segops.SEG_CHUNK)
        outs = [t.reshape(n, c) for t in outs]
    sort_rows_cuda.launches += 1
    return RecordTraceResult(rec.counts, *outs)


sort_rows_cuda.launches = 0


def records_to_flat(
    rec: RecordTraceResult,
    capacity: int,
    index_sentinel: int = INDEX_SENTINEL,
    value_sentinel: float = VALUE_SENTINEL,
    distance_sentinel: float = DISTANCE_SENTINEL,
    sentinel_slots: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The rectangular records in the flat offset-segmented layout of
    ``trace_sph``: (offsets i32[R], counts i32[R] (clamped to the row
    capacity), indices i32[capacity], integrals f32[capacity],
    distances f32[capacity]); records past ``capacity`` are dropped.

    ``sentinel_slots=True`` reserves one pre-filled slot after each ray's
    records, the ``trace_with_sentinels_sph`` layout. CUDA tensors launch
    ``records_to_flat_cuda``, CPU tensors run ``_records_to_flat_plain``."""
    args = (rec, capacity, index_sentinel, value_sentinel, distance_sentinel, sentinel_slots)
    if segops._on_cpu(rec.distances):
        return _records_to_flat_plain(*args)
    return records_to_flat_cuda(*args)


def _records_to_flat_plain(
    rec: RecordTraceResult,
    capacity: int,
    index_sentinel: int = INDEX_SENTINEL,
    value_sentinel: float = VALUE_SENTINEL,
    distance_sentinel: float = DISTANCE_SENTINEL,
    sentinel_slots: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``records_to_flat``."""
    c = rec.capacity
    counts = torch.clamp(rec.counts, max=c)
    stride = counts + (1 if sentinel_slots else 0)
    offsets = (torch.cumsum(stride, dim=0) - stride).to(torch.int32)
    col = torch.arange(c, dtype=torch.int64, device=counts.device)[None, :]
    valid = col < counts[:, None]
    dest = offsets[:, None].long() + col
    valid &= dest < capacity
    out = []
    for vals, fill, dtype in ((rec.indices, index_sentinel, torch.int32),
                              (rec.integrals, value_sentinel, torch.float32),
                              (rec.distances, distance_sentinel, torch.float32)):
        buf = torch.full((capacity,), fill, dtype=dtype, device=counts.device)
        buf[dest[valid]] = vals[valid]
        out.append(buf)
    return (offsets, counts, *out)


# The rows an E10 block scans and copies, and the most it takes
# (csrc/segsort.cu's kFlatThreads).
FLAT_ROWS = 128
_FLAT_MAX_ROWS = 512


def _f32_bits(v: float) -> int:
    """The i32 bit pattern of ``v`` rounded to f32, as ``torch.full`` fills."""
    with np.errstate(over="ignore"):
        return int(np.float32(v).view(np.int32))


def records_to_flat_cuda(rec: RecordTraceResult, capacity: int,
                         index_sentinel: int = INDEX_SENTINEL,
                         value_sentinel: float = VALUE_SENTINEL,
                         distance_sentinel: float = DISTANCE_SENTINEL,
                         sentinel_slots: bool = False, _rows: int = FLAT_ROWS):
    """``csrc/segsort.cu``'s flat layout (E10, ``grace_records_to_flat``):
    ``records_to_flat`` on CUDA tensors, bit-equal to
    ``_records_to_flat_plain``, in one launch after a memset of its
    look-back state. The kernel clamps the counts and scans them with the
    sentinel slots (the low 32 bits of the plain version's int64 cumsum,
    which its cast keeps; rows of fewer than 2^31 slots in all, so they do
    not wrap), a block ``_rows`` rows (``FLAT_ROWS``; others only to test
    the look-back over many blocks and to time other ranges) taking its
    prefix from the blocks before. A warp copies a row: 16-byte loads of
    the whole row where the width is a multiple of 4, stores realigned in
    registers to 16 bytes (the destination starts at any word, which also
    rules out TMA's bulk copies: both their ends must be 16-byte aligned),
    else 4 bytes a column. Later blocks fill the tail: every position of
    the three buffers is written once."""
    device, n, c = _check_rows("records_to_flat", rec)
    capacity = int(capacity)
    if not 0 <= capacity < 1 << 31:
        raise ValueError(f"records_to_flat: capacity {capacity} outside [0, 2^31)")
    if not -(1 << 31) <= int(index_sentinel) < 1 << 31:
        raise ValueError(f"records_to_flat: index_sentinel {index_sentinel} is no i32")
    if not 1 <= _rows <= _FLAT_MAX_ROWS:
        raise ValueError(f"records_to_flat: {_rows} rows a block outside [1, {_FLAT_MAX_ROWS}]")
    rows = [_kernels.aligned(t) if c % 4 == 0 else t.contiguous() for t in rec[1:]]
    offsets, counts = (torch.empty(n, dtype=torch.int32, device=device) for _ in range(2))
    bufs = [torch.empty(capacity, dtype=d, device=device)
            for d in (torch.int32, torch.float32, torch.float32)]
    state = torch.empty(1 + -(-n // _rows), dtype=torch.int64, device=device)
    _kernels.launch("segsort", "grace_records_to_flat", device, rec.counts.contiguous().data_ptr(),
                    *[t.data_ptr() for t in rows], offsets.data_ptr(), counts.data_ptr(),
                    *[t.data_ptr() for t in bufs], state.data_ptr(), n, c, capacity,
                    1 if sentinel_slots else 0, int(index_sentinel), _f32_bits(value_sentinel),
                    _f32_bits(distance_sentinel), _rows)
    records_to_flat_cuda.launches += 1
    return (offsets, counts, *bufs)


records_to_flat_cuda.launches = 0
