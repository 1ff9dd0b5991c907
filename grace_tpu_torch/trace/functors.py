"""Stock trace functors for the generic engine (PyTorch counterpart of
``grace_tpu.trace.functors``).

  intersect_sphere             ray vs sphere: hit mask + (b2, dist)
  on_hit_count                 per-ray hit count
  make_on_hit_sphere_cumulate  per-ray sum of SPH line integrals
                               lerp(table, (N-1) sqrt(b2)/h) / h^2

The record functors (per-hit buffers) come with the record pipeline.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from grace_tpu_torch.ops.interpolate import lerp
from grace_tpu_torch.ops.intersect import sphere_hit
from grace_tpu_torch.ops.vecmath import sqrt


class SphereHitInfo(NamedTuple):
    b2: torch.Tensor
    dist: torch.Tensor


def intersect_sphere(ray_o, ray_d, ray_len, spheres, ray_data):
    """Hit mask and (b2, distance of closest approach) per candidate."""
    hit, b2, dist = sphere_hit(ray_o, ray_d, ray_len, spheres)
    return hit, SphereHitInfo(b2=b2, dist=dist)


def on_hit_count(carry, ray_ids, prim_ids, info, hit):
    """Add each ray's hits to its count."""
    ray_data, global_state = carry
    return ray_data + hit.sum(dim=-1).to(ray_data.dtype), global_state


def sph_integral(b2, h, table):
    """Per-hit SPH line integral lerp(table, (N-1) sqrt(b2)/h) / h^2."""
    n = table.shape[0]
    ir = 1.0 / h
    b_norm = (n - 1) * (sqrt(b2) * ir)
    return lerp(b_norm, table) * (ir * ir)


def make_on_hit_sphere_cumulate(spheres, table, weights=None):
    """On-hit functor summing each intersected particle's kernel line
    integral into the per-ray value; optional per-particle ``weights``
    (masses or densities) scale each term."""
    h_arr = spheres[:, 3]
    table = torch.as_tensor(table, dtype=torch.float32, device=spheres.device)

    def on_hit(carry, ray_ids, prim_ids, info, hit):
        ray_data, global_state = carry
        contrib = sph_integral(info.b2, h_arr[prim_ids], table)
        if weights is not None:
            contrib = contrib * weights[prim_ids]
        contrib = torch.where(hit, contrib, 0.0)
        return ray_data + contrib.sum(dim=-1), global_state

    return on_hit
