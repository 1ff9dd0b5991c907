"""SPH trace facades on the generic engine (PyTorch counterpart of
``grace_tpu.trace.sph``).

  trace_hitcounts_sph     per-ray hit counts
  trace_cumulative_sph    per-ray column density

The per-hit record facades (``trace_sph``, ``trace_with_sentinels_sph``)
come with the record pipeline.
"""

from __future__ import annotations

import numpy as np
import torch

from grace_tpu_torch.core.tree import Tree
from grace_tpu_torch.core.types import Rays
from grace_tpu_torch.sph.kernel_integrals import DENSE_KERNEL_INTEGRAL_TABLE
from grace_tpu_torch.trace import functors as F
from grace_tpu_torch.trace.engine import TraceFunctors, trace

_DEFAULT_TABLE = np.asarray(DENSE_KERNEL_INTEGRAL_TABLE, np.float32)


def trace_hitcounts_sph(rays: Rays, spheres, tree: Tree, stack_size: int = 64):
    """Per-ray intersection counts, i32[R]."""
    fx = TraceFunctors(intersect=F.intersect_sphere, on_hit=F.on_hit_count)
    counts, _ = trace(rays, tree, spheres, fx,
                      ray_data_init=torch.zeros(rays.n_rays, dtype=torch.int32,
                                                device=rays.origins.device),
                      stack_size=stack_size)
    return counts


def trace_cumulative_sph(rays: Rays, spheres, tree: Tree, table=None,
                         weights=None, stack_size: int = 64):
    """Per-ray accumulated kernel line integrals (column density), f32[R]."""
    table = _DEFAULT_TABLE if table is None else table
    fx = TraceFunctors(intersect=F.intersect_sphere,
                       on_hit=F.make_on_hit_sphere_cumulate(spheres, table, weights))
    sums, _ = trace(rays, tree, spheres, fx,
                    ray_data_init=torch.zeros(rays.n_rays, dtype=torch.float32,
                                              device=rays.origins.device),
                    stack_size=stack_size)
    return sums
