"""Segmented sort / scan post-processing (PyTorch counterpart of
``grace_tpu.ops.segops``).

Segments are given by CSR start offsets (``offsets[0] == 0``, repeated
offsets for empty segments). Sorts are stable, so ties keep their input
order as ``jax.lax.sort`` (stable by default) keeps them; a sort on
(segment, key) is two stable passes, key first, then segment. f32 keys
compare as XLA compares them: -0 with +0 and subnormals with zero, every
NaN after +inf.

``sort_by_distance`` on CUDA tensors is ``csrc/segsort.cu``'s segmented
sort (``segmented_sort_cuda``): head flags and segment starts, persistent
warps each sorting a segment (a stable merge sort of u32 keys, skipped
where the segment is in order) while the next one's arrays load, longer
segments checked for order and the others sorted in chunks merged in
device memory, every payload written in the same launches. CPU tensors
take ``_sort_by_distance_plain``. The other sorts and scans here stay
plain.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from grace_tpu_torch import _kernels

SEG_CHUNK = 1024      # csrc/segsort.cu kMaxChunk: the longest segment a warp sorts
HEAD_TILE = 1024      # kTile: positions (head bits) a warp counts
MAX_PAYLOADS = 8      # kMaxPayloads: arrays one launch gathers
MERGE_TILE = 256      # kMergeTile: outputs a merge block takes at a time
WARP_RUN = 512        # kWarpRun: the longest segment sorted by one warp alone; longer
                      # ones take the long route (chunks of up to SEG_CHUNK, merged)


def _on_cpu(t: torch.Tensor) -> bool:
    """The segmented sorts' route: CPU tensors take the plain versions,
    every other tensor the kernels (which refuse a device but CUDA)."""
    return t.device.type == "cpu"


def offsets_to_segments(offsets, n_elements: int) -> torch.Tensor:
    """Per-element segment ids i32[n] from CSR segment-start offsets i32[S].
    Empty segments (repeated offsets) are skipped. A negative offset counts
    from the end, as ``grace_tpu``'s scatter indexes (ROADMAP C23); offsets
    outside [0, n) after that are dropped."""
    offsets = torch.as_tensor(offsets).to(torch.int64)
    starts = offsets[1:]
    starts = torch.where(starts < 0, starts + n_elements, starts)
    starts = starts[(starts >= 0) & (starts < n_elements)]
    marks = torch.zeros(n_elements, dtype=torch.int32, device=offsets.device)
    marks.index_add_(0, starts, torch.ones_like(starts, dtype=torch.int32))
    return torch.cumsum(marks, dim=0, dtype=torch.int32)


def _compare_form(keys: torch.Tensor) -> torch.Tensor:
    """The keys as ``grace_tpu``'s sorts compare them: XLA compares f32 with
    subnormals flushed to zero, so a subnormal key ties with +-0 (ROADMAP
    C24). Other dtypes as they are."""
    if keys.dtype != torch.float32:
        return keys
    return torch.where(keys.abs() < torch.finfo(torch.float32).tiny, 0.0, keys)


def order_by_index(order, values) -> torch.Tensor:
    """Gather ``values`` by an index map."""
    return torch.as_tensor(values)[torch.as_tensor(order).long()]


def sort_and_map(keys) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable argsort: (sorted keys, map i32)."""
    keys = torch.as_tensor(keys)
    order = torch.argsort(_compare_form(keys), stable=True)
    return keys[order], order.to(torch.int32)


def sort_by_key(keys, *values):
    """Stable sort of ``keys``, carrying one or more value arrays."""
    keys = torch.as_tensor(keys)
    order = torch.argsort(_compare_form(keys), stable=True)
    return (keys[order],) + tuple(torch.as_tensor(v)[order] for v in values)


def segmented_sort(segment_ids, keys, *payloads):
    """Stable sort of ``keys`` within segments, carrying payload arrays:
    lexicographic on (segment, key), so elements never cross segments.
    Returns the sorted keys, or (keys, *payloads) when payloads are given."""
    seg = torch.as_tensor(segment_ids).to(torch.int32)
    keys = torch.as_tensor(keys)
    by_key = torch.argsort(_compare_form(keys), stable=True)
    order = by_key[torch.argsort(seg[by_key], stable=True)]
    out = (keys[order],) + tuple(torch.as_tensor(p)[order] for p in payloads)
    return out if payloads else out[0]


def sort_by_distance(distances, offsets, indices, *data, total_hits=None):
    """Per-ray segmented sort of hit distances, carrying hit indices and
    any further per-hit arrays.

    Args:
      distances: f32[H] per-hit distances (keys); H may be a capacity
        larger than the true hit count.
      offsets: i32[R] CSR segment starts per ray.
      indices: i32[H] per-hit primitive indices.
      *data: further per-hit arrays to reorder (f32 or i32 on CUDA).
      total_hits: number of valid entries (an int or a 0-d tensor, read on
        the device); entries past it form a trailing pseudo-segment, so
        capacity padding never enters the last ray's segment. Defaults to H.

    Returns (sorted_distances, sorted_indices, *sorted_data). CUDA tensors
    launch ``segmented_sort_cuda``; anything else runs
    ``_sort_by_distance_plain``.
    """
    if not isinstance(distances, torch.Tensor) or _on_cpu(distances):
        return _sort_by_distance_plain(distances, offsets, indices, *data,
                                       total_hits=total_hits)
    return segmented_sort_cuda(distances, offsets, indices, *data, total_hits=total_hits)


def _sort_by_distance_plain(distances, offsets, indices, *data, total_hits=None):
    """Plain PyTorch version of ``sort_by_distance``: segment ids from
    ``offsets_to_segments``, then ``segmented_sort``."""
    h = distances.shape[0]
    seg = offsets_to_segments(offsets, h)
    if total_hits is not None:
        n_seg = torch.as_tensor(offsets).shape[0]
        pos = torch.arange(h, device=seg.device)
        seg = torch.where(pos < torch.as_tensor(total_hits, device=seg.device), seg,
                          n_seg).to(torch.int32)
    return segmented_sort(seg, distances, indices, *data)


def _pointer_table(srcs, dsts):
    """The host array of source then destination addresses that the
    segmented sort's entries take (kept alive by the caller)."""
    ptrs = [t.data_ptr() for t in srcs] + [t.data_ptr() for t in dsts]
    return (ctypes.c_uint64 * len(ptrs))(*ptrs)


def _merge_rounds(n: int, chunk: int) -> int:
    """Merge rounds that make any segment of at most n entries one run
    from sorted chunks of ``chunk``."""
    rounds = 0
    while chunk << rounds < n:
        rounds += 1
    return rounds


def _segsort_launch(keys, mask, offsets, total, payloads, chunk):
    """csrc/segsort.cu's segmented sort: ``payloads`` (4-byte arrays of
    ``keys``' length H, on its CUDA device) reordered by a stable sort of
    ``keys`` (f32[H]; where ``mask`` i32[H] is -1 the key is +inf) within
    the segments that ``offsets`` (i32, ``offsets[0]`` ignored) and
    ``total`` (None, or i32[1] in [0, H]) open. Segments longer than
    min(``chunk``, WARP_RUN) take the long route: checked for order (a
    segment in order is copied), the others sorted in chunks of ``chunk``
    (a power of two, MERGE_TILE / 2 to SEG_CHUNK) and merged.
    Returns the sorted payloads, new tensors."""
    device, n = keys.device, keys.shape[0]
    outs = [torch.empty_like(p) for p in payloads]
    launch = lambda entry, *args: _kernels.launch("segsort", entry, device, *args)
    ptr = lambda t: None if t is None else t.data_ptr()
    head = torch.zeros(-(-n // 32), dtype=torch.int32, device=device)   # head bits
    launch("grace_seg_heads", ptr(offsets), ptr(total), head.data_ptr(), offsets.shape[0], n)
    counts = torch.empty(-(-n // HEAD_TILE), dtype=torch.int32, device=device)
    launch("grace_seg_count", head.data_ptr(), counts.data_ptr(), n)
    incl = torch.cumsum(counts, dim=0, dtype=torch.int32)
    starts = torch.empty(n + 1, dtype=torch.int32, device=device)
    launch("grace_seg_starts", head.data_ptr(), incl.data_ptr(), starts.data_ptr(), n)
    n_seg = incl[-1:]
    max_segs = min(n, offsets.shape[0] + 1)
    run = min(chunk, WARP_RUN)
    n_max = n // (run + 1) + 1
    rounds = _merge_rounds(n, chunk)
    for g in range(0, len(payloads), MAX_PAYLOADS):
        srcs, dsts = payloads[g:g + MAX_PAYLOADS], outs[g:g + MAX_PAYLOADS]
        table = _pointer_table(srcs, dsts)
        # the long list, zeroed at once: its count, starts, lengths and order flags
        zeroed = torch.zeros(4 + 3 * n_max, dtype=torch.int32, device=device)
        n_long = zeroed[:1]
        long_start, long_len, unsorted = (zeroed[4 + j * n_max:4 + (j + 1) * n_max]
                                          for j in range(3))
        launch("grace_segmented_sort", keys.data_ptr(), ptr(mask), starts.data_ptr(),
               n_seg.data_ptr(), ctypes.addressof(table), long_start.data_ptr(),
               long_len.data_ptr(), n_long.data_ptr(), len(srcs), max_segs, chunk)
        if n <= run:
            continue   # no segment is longer than a warp's run
        elem_end, chunk_end, tile_end = torch.empty(3, n_max, dtype=torch.int32, device=device)
        launch("grace_seg_long_scan", long_len.data_ptr(), n_long.data_ptr(),
               elem_end.data_ptr(), chunk_end.data_ptr(), tile_end.data_ptr(), n_max, chunk)
        launch("grace_seg_check", keys.data_ptr(), ptr(mask), long_start.data_ptr(),
               long_len.data_ptr(), elem_end.data_ptr(), n_long.data_ptr(),
               unsorted.data_ptr(), n_max, n)
        # u32 order keys (held in i32 tensors) and i32 positions, two of each
        bufs = torch.empty(4, n, dtype=torch.int32, device=device)
        launch("grace_seg_chunks", keys.data_ptr(), ptr(mask), long_start.data_ptr(),
               long_len.data_ptr(), chunk_end.data_ptr(), n_long.data_ptr(),
               unsorted.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(), n_max, chunk, n)
        for r in range(rounds):
            i, o = 2 * (r % 2), 2 * ((r + 1) % 2)
            launch("grace_seg_merge", long_start.data_ptr(), long_len.data_ptr(),
                   tile_end.data_ptr(), n_long.data_ptr(), unsorted.data_ptr(),
                   bufs[i].data_ptr(), bufs[i + 1].data_ptr(), bufs[o].data_ptr(),
                   bufs[o + 1].data_ptr(), n_max, chunk << r, n)
        launch("grace_seg_gather", long_start.data_ptr(), long_len.data_ptr(),
               elem_end.data_ptr(), n_long.data_ptr(), unsorted.data_ptr(),
               bufs[1].data_ptr(), bufs[3].data_ptr(), ctypes.addressof(table), n_max,
               len(srcs), chunk, n)
    return outs


def segmented_sort_cuda(distances, offsets, indices, *data, total_hits=None):
    """``csrc/segsort.cu``'s segmented sort (E9): ``sort_by_distance`` on
    CUDA tensors, bit-equal to ``_sort_by_distance_plain``. ``offsets``
    (i32 or i64, any values, as ``offsets_to_segments`` reads them) and
    ``total_hits`` (an int or a tensor) are moved to the device and read
    there, without a host sync."""
    payloads = [distances, indices, *data]
    device = _kernels.check_tensors("sort_by_distance", [indices], [distances])
    n = distances.shape[0]
    for name, t in zip(("distances", "indices", *(f"data[{i}]" for i in range(len(data)))),
                       payloads):
        if t.device != device or t.shape != (n,):
            raise ValueError(f"sort_by_distance: {name} {tuple(t.shape)} on {t.device}, "
                             f"expected [{n}] on {device}")
        if t.dtype not in (torch.float32, torch.int32):
            raise TypeError(f"sort_by_distance: {name} is {t.dtype}; the kernel takes f32 "
                            "or i32 arrays")
    offsets = torch.as_tensor(offsets, device=device)
    if total_hits is not None and offsets.shape[0] == 0:
        total_hits = None   # no offsets: the pseudo-segment's id 0 is the only segment's
    if offsets.dim() != 1 or offsets.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"sort_by_distance: offsets must be i32 or i64 [R], got "
                        f"{offsets.dtype} {tuple(offsets.shape)}")
    if n >= 1 << 31:
        raise ValueError(f"sort_by_distance: {n} entries; the kernel takes fewer than 2^31")
    if n == 0:
        return tuple(t.clone() for t in payloads)
    if offsets.dtype == torch.int64:   # every value outside [-n, n) opens no segment
        offsets = offsets.clamp(-n - 1, n)
    offsets = offsets.to(torch.int32).contiguous()
    total = None
    if total_hits is not None:
        total = torch.as_tensor(total_hits, device=device).reshape(1)
        if total.is_floating_point():
            total = torch.ceil(total)   # pos < t where t is not whole
        total = total.to(torch.int64).clamp(0, n).to(torch.int32)
    out = _segsort_launch(distances.contiguous(), None, offsets, total,
                          [t.contiguous() for t in payloads], SEG_CHUNK)
    segmented_sort_cuda.launches += 1
    return tuple(out)


segmented_sort_cuda.launches = 0

# csrc/segsort.cu's kernels in grace_segsort_resources' numbering: the sort
# kernel for record rows of up to 512 and of up to 1,024 (E8) and for
# segments (E9), E9's head bits, counts, starts, the long route's scans,
# check, chunks, merge and gather, and E10 on rows read 16 bytes at a time
# (a width that is a multiple of 4) and on the others.
RESOURCE_KERNELS = ("sort_rows (512)", "sort_rows (1,024)", "sort_segments", "seg_heads",
                    "seg_count", "seg_starts", "seg_long_scan", "seg_check", "seg_chunks",
                    "seg_merge", "seg_gather", "records_to_flat", "records_to_flat (scalar rows)")


def segsort_resources(device, kernel: str, n_stage: int = 3) -> dict:
    """What one launch of segsort kernel ``kernel`` (``RESOURCE_KERNELS``)
    holds on ``device``: ``_kernels.RESOURCE_FIELDS`` (a sort kernel's
    shared bytes with its dynamic stage for ``n_stage`` staged arrays,
    three on main path 4) and ``local_bytes`` a thread."""
    fields = _kernels.RESOURCE_FIELDS + ("local_bytes",)
    out = (ctypes.c_int * len(fields))()
    _kernels.launch("segsort", "grace_segsort_resources", torch.device(device),
                    ctypes.addressof(out), RESOURCE_KERNELS.index(kernel), n_stage)
    return dict(zip(fields, out))


def exclusive_segmented_scan(offsets, values) -> torch.Tensor:
    """Per-segment exclusive prefix sum: out[i] = sum of values[j] for j in
    [segment start of i, i). The inclusive sums accumulate within each
    segment (in f64 for f32 values, so no sum crosses a segment boundary
    and no cancellation enters); the exclusive sum is inclusive - value."""
    values = torch.as_tensor(values)
    n = values.shape[0]
    if n == 0:
        return values.clone()
    seg = offsets_to_segments(offsets, n).long()
    acc_dtype = torch.float64 if values.is_floating_point() else torch.int64
    total = torch.cumsum(values.to(acc_dtype), dim=0)
    heads = torch.ones(n, dtype=torch.bool, device=values.device)
    heads[1:] = seg[1:] != seg[:-1]
    base_at_head = torch.where(heads, total - values.to(acc_dtype), 0)
    # base of each element's run: the last head at or before it
    head_pos = torch.cummax(torch.where(heads, torch.arange(n, device=values.device), 0),
                            dim=0).values
    incl = (total - base_at_head[head_pos]).to(values.dtype)
    return incl - values


def weighted_exclusive_segmented_scan(offsets, values, weight_map, weights) -> torch.Tensor:
    """Scale each element i by weights[weight_map[i]], then scan as
    ``exclusive_segmented_scan``."""
    w = torch.as_tensor(weights)[torch.as_tensor(weight_map).long()]
    return exclusive_segmented_scan(offsets, torch.as_tensor(values) * w)


def segment_sums(segment_ids, values, num_segments: int) -> torch.Tensor:
    """Per-segment totals; ids outside [0, num_segments) are dropped."""
    ids = torch.as_tensor(segment_ids).long()
    values = torch.as_tensor(values)
    keep = (ids >= 0) & (ids < num_segments)
    out = torch.zeros((num_segments,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, ids[keep], values[keep])
