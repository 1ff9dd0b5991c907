"""SPH trace facades on the generic engine's walk (PyTorch counterpart of
``grace_tpu.trace.sph``). They call ``trace.walk.walk_sph``: the CUDA walk
(``csrc/bvh_walk.cu``) on the card, ``engine.trace`` with the stock
functors on the CPU.

  trace_hitcounts_sph       per-ray hit counts
  trace_cumulative_sph      per-ray column density
  trace_sph                 per-hit records (index, integral, distance)
  trace_with_sentinels_sph  per-hit records + one sentinel slot per ray

The per-hit facades take a fixed ``capacity`` for the flat hit buffers and
return (offsets, counts, buffers, total_hits); ``total_hits > capacity``
signals overflow (re-run with a larger capacity). engine='xla' is the
engine's two passes (hit counts, exclusive scan, re-walk scattering at
each ray's cursor); engine='pallas' is the one-pass record kernel
(``pallas_records``) with its Horner integral in place of the table lerp.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from grace_tpu_torch.core.tree import Tree
from grace_tpu_torch.core.types import Rays
from grace_tpu_torch.trace.walk import walk_sph


def trace_hitcounts_sph(rays: Rays, spheres, tree: Tree, stack_size: int = 64):
    """Per-ray intersection counts, i32[R]."""
    return walk_sph(rays, spheres, tree, "count", stack_size)


def trace_cumulative_sph(rays: Rays, spheres, tree: Tree, table=None,
                         weights=None, stack_size: int = 64):
    """Per-ray accumulated kernel line integrals (column density), f32[R]."""
    return walk_sph(rays, spheres, tree, "cumulative", stack_size, table=table,
                    weights=weights)


class SphTraceResult(NamedTuple):
    offsets: torch.Tensor     # i32[R] exclusive-scan start of each ray's segment
    counts: torch.Tensor      # i32[R] per-ray hit counts
    indices: torch.Tensor     # i32[capacity] intersected sphere indices
    integrals: torch.Tensor   # f32[capacity] per-hit kernel integrals
    distances: torch.Tensor   # f32[capacity] per-hit along-ray distances
    total_hits: torch.Tensor  # i32[] (> capacity indicates overflow)


def _records_result(rays, spheres, per_ray_capacity, drain, capacity, sentinels):
    from grace_tpu_torch.trace.pallas_records import pallas_trace_sph_records, records_to_flat

    rec = pallas_trace_sph_records(rays, spheres, per_ray_capacity, drain=drain)
    offsets, _, indices, integrals, distances = records_to_flat(
        rec, capacity, *sentinels, sentinel_slots=bool(sentinels))
    total = (rec.counts + (1 if sentinels else 0)).sum(dtype=torch.int32)
    return SphTraceResult(offsets, rec.counts, indices, integrals, distances, total)


def _engine_records(rays, spheres, tree, capacity, table, stack_size, sentinels):
    """The engine's two passes: counts, exclusive offsets (with one slot
    per ray for a sentinel when ``sentinels`` holds the fill values), then
    a re-walk writing each hit at its ray's cursor."""
    counts = trace_hitcounts_sph(rays, spheres, tree, stack_size)
    stride = counts + (1 if sentinels else 0)
    offsets = (torch.cumsum(stride, dim=0, dtype=torch.int32) - stride).to(torch.int32)
    total = stride.sum(dtype=torch.int32)
    indices, integrals, distances = walk_sph(
        rays, spheres, tree, "records", stack_size, table=table, cursors=offsets,
        capacity=capacity, fill=sentinels or None)
    return SphTraceResult(offsets, counts, indices, integrals, distances, total)


def trace_sph(rays: Rays, spheres, tree: Tree, capacity: int, table=None,
              stack_size: int = 64, engine: str = "xla", per_ray_capacity: int = 256,
              drain: str = "pick") -> SphTraceResult:
    """Per-hit trace into flat buffers of ``capacity`` entries: ray r's
    hits occupy [offsets[r], offsets[r] + counts[r]); entries past the hits
    are unspecified.

    engine='xla' walks the tree twice (``stack_size`` bounds its stack) and
    integrates with the table lerp; records come in traversal order.
    engine='pallas' runs ``pallas_trace_sph_records`` with rows of
    ``per_ray_capacity`` (a multiple of 128; ``drain`` is passed on) and
    the ``horner1`` integral (within ~2e-5 of the table); records come in
    ascending primitive order. Neither order is a contract:
    ``segops.sort_by_distance`` fixes it.
    """
    if engine == "pallas":
        return _records_result(rays, spheres, per_ray_capacity, drain, capacity, ())
    if engine != "xla":
        raise ValueError(f"unknown engine {engine!r}")
    return _engine_records(rays, spheres, tree, capacity, table, stack_size, ())


def trace_with_sentinels_sph(rays: Rays, spheres, tree: Tree, capacity: int,
                             index_sentinel: int = -1, value_sentinel: float = 0.0,
                             distance_sentinel: float = -1.0, table=None,
                             stack_size: int = 64, engine: str = "xla",
                             per_ray_capacity: int = 256,
                             drain: str = "pick") -> SphTraceResult:
    """Per-hit trace with one sentinel entry after each ray's hits: ray r
    occupies [offsets[r], offsets[r] + counts[r]], its last slot the
    sentinels; capacity must cover total_hits = sum(counts + 1). Engines as
    ``trace_sph``."""
    sentinels = (index_sentinel, value_sentinel, distance_sentinel)
    if engine == "pallas":
        return _records_result(rays, spheres, per_ray_capacity, drain, capacity, sentinels)
    if engine != "xla":
        raise ValueError(f"unknown engine {engine!r}")
    return _engine_records(rays, spheres, tree, capacity, table, stack_size, sentinels)
