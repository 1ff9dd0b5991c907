"""Segmented sort / scan post-processing (PyTorch counterpart of
``grace_tpu.ops.segops``).

Segments are given by CSR start offsets (``offsets[0] == 0``, repeated
offsets for empty segments). Sorts are stable, so ties keep their input
order as ``jax.lax.sort`` (stable by default) keeps them; a sort on
(segment, key) is two stable passes, key first, then segment.
"""

from __future__ import annotations

from typing import Tuple

import torch


def offsets_to_segments(offsets, n_elements: int) -> torch.Tensor:
    """Per-element segment ids i32[n] from CSR segment-start offsets i32[S].
    Empty segments (repeated offsets) are skipped; offsets outside
    [0, n) are dropped."""
    offsets = torch.as_tensor(offsets).to(torch.int64)
    starts = offsets[1:]
    starts = starts[(starts >= 0) & (starts < n_elements)]
    marks = torch.zeros(n_elements, dtype=torch.int32, device=offsets.device)
    marks.index_add_(0, starts, torch.ones_like(starts, dtype=torch.int32))
    return torch.cumsum(marks, dim=0, dtype=torch.int32)


def order_by_index(order, values) -> torch.Tensor:
    """Gather ``values`` by an index map."""
    return torch.as_tensor(values)[torch.as_tensor(order).long()]


def sort_and_map(keys) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable argsort: (sorted keys, map i32)."""
    keys = torch.as_tensor(keys)
    order = torch.argsort(keys, stable=True)
    return keys[order], order.to(torch.int32)


def sort_by_key(keys, *values):
    """Stable sort of ``keys``, carrying one or more value arrays."""
    keys = torch.as_tensor(keys)
    order = torch.argsort(keys, stable=True)
    return (keys[order],) + tuple(torch.as_tensor(v)[order] for v in values)


def segmented_sort(segment_ids, keys, *payloads):
    """Stable sort of ``keys`` within segments, carrying payload arrays:
    lexicographic on (segment, key), so elements never cross segments.
    Returns the sorted keys, or (keys, *payloads) when payloads are given."""
    seg = torch.as_tensor(segment_ids).to(torch.int32)
    keys = torch.as_tensor(keys)
    by_key = torch.argsort(keys, stable=True)
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
      *data: further per-hit arrays to reorder.
      total_hits: number of valid entries; entries past it form a trailing
        pseudo-segment, so capacity padding never enters the last ray's
        segment. Defaults to H.

    Returns (sorted_distances, sorted_indices, *sorted_data).
    """
    h = distances.shape[0]
    seg = offsets_to_segments(offsets, h)
    if total_hits is not None:
        n_seg = torch.as_tensor(offsets).shape[0]
        pos = torch.arange(h, device=seg.device)
        seg = torch.where(pos < torch.as_tensor(total_hits, device=seg.device), seg,
                          n_seg).to(torch.int32)
    return segmented_sort(seg, distances, indices, *data)


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
