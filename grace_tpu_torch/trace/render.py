"""Differentiable SPH column-density rendering from hit records.

PyTorch counterpart of ``grace_tpu.trace.render``: pixel gradients with
respect to particle positions, smoothing lengths and weights, in two steps.

  1. ``find_hits``: the generic engine's walk (``trace.walk.walk_sph``: the
     CUDA walk on the card) records the (ray, particle) id pair of every
     intersection. Discrete and not differentiable: the hit set is
     a constant of the backward pass (its boundary has measure zero).
  2. ``integrate_hits``: gathers, the kernel line integral per record and
     a per-ray sum by ``index_add``. All of it is differentiable, so
     autograd carries gradients through the gathers into per-particle sums.

It is the correctness anchor of the fused renderer (trace/pallas_render.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from grace_tpu_torch.core.tree import Tree
from grace_tpu_torch.core.types import Rays
from grace_tpu_torch.ops.interpolate import lerp
from grace_tpu_torch.ops.intersect import sphere_hit
from grace_tpu_torch.ops.vecmath import sqrt
from grace_tpu_torch.sph.kernel_integrals import (
    DENSE_KERNEL_INTEGRAL_TABLE, cubic_spline_line_integral)
from grace_tpu_torch.trace.sph import trace_hitcounts_sph
from grace_tpu_torch.trace.walk import walk_sph

_DEFAULT_TABLE = np.asarray(DENSE_KERNEL_INTEGRAL_TABLE, np.float32)


class HitRecords(NamedTuple):
    ray: torch.Tensor         # i32[capacity] ray id per hit (-1 past the hits)
    prim: torch.Tensor        # i32[capacity] particle id per hit
    valid: torch.Tensor       # bool[capacity]
    total_hits: torch.Tensor  # i32[] true hit count (> capacity: overflow)


def find_hits(rays: Rays, spheres, tree: Tree, capacity: int,
              stack_size: int = 64) -> HitRecords:
    """Traverse and record the (ray, particle) ids of every intersection:
    ray r's hits fill positions [offset_r, offset_r + count_r) in traversal
    order, offset_r the exclusive cumulative hit count; records past
    ``capacity`` are dropped (``total_hits`` still counts them)."""
    counts = trace_hitcounts_sph(rays, spheres, tree, stack_size)
    offsets = (torch.cumsum(counts, dim=0, dtype=torch.int32) - counts).to(torch.int32)
    total = counts.sum(dtype=torch.int32)
    ray, prim = walk_sph(rays, spheres, tree, "ids", stack_size, cursors=offsets,
                         capacity=capacity)
    pos = torch.arange(capacity, dtype=torch.int32, device=ray.device)
    valid = (ray >= 0) & (pos < total)
    return HitRecords(ray=ray, prim=prim, valid=valid, total_hits=total)


def integrate_hits(records: HitRecords, rays: Rays, spheres, n_rays: int,
                   weights=None, table=None, use_closed_form: bool = False
                   ) -> torch.Tensor:
    """Differentiable per-ray column density from hit records:
    sum over records (r, p) of w_p F(b_rp / h_p) / h_p^2, F the table lerp
    (or the closed form). Gradients flow to ``spheres`` and ``weights``."""
    table = _DEFAULT_TABLE if table is None else table
    rid = torch.clamp(records.ray, 0, n_rays - 1).long()
    pid = records.prim.long()
    s = spheres[pid]
    # The impact parameter is recomputed differentiably; the hit predicate
    # is not re-applied (the record set is the hit set).
    _, b2, _ = sphere_hit(rays.origins[rid], rays.directions[rid], rays.lengths[rid], s)
    h = s[:, 3]
    ir = 1.0 / h
    # Double where: padding records are sanitized before the kernel is
    # evaluated, so no NaN cotangent (d sqrt at b >= 1) reaches the masked
    # gradient path.
    b2 = torch.where(records.valid, b2, 0.25 * h * h)
    b = sqrt(torch.clamp(b2, min=1e-30)) * ir
    if use_closed_form:
        contrib = cubic_spline_line_integral(b) * (ir * ir)
    else:
        n = len(table)
        contrib = lerp((n - 1) * b, table) * (ir * ir)
    if weights is not None:
        contrib = contrib * weights[pid]
    contrib = torch.where(records.valid, contrib, 0.0)
    return contrib.new_zeros(n_rays).index_add(0, rid, contrib)


def render_column_density(rays: Rays, spheres, tree: Tree, capacity: int,
                          weights=None, table=None, stack_size: int = 64
                          ) -> torch.Tensor:
    """End-to-end differentiable column-density render: the forward of
    ``trace_cumulative_sph``, with gradients for ``spheres`` and
    ``weights``. The traversal sees detached spheres."""
    records = find_hits(rays, spheres.detach(), tree, capacity, stack_size)
    return integrate_hits(records, rays, spheres, rays.n_rays, weights, table)
