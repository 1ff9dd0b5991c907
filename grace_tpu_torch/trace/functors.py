"""Stock trace functors for the generic engine (PyTorch counterpart of
``grace_tpu.trace.functors``).

  intersect_sphere             ray vs sphere: hit mask + (b2, dist)
  on_hit_count                 per-ray hit count
  make_on_hit_sphere_cumulate  per-ray sum of SPH line integrals
                               lerp(table, (N-1) sqrt(b2)/h) / h^2
  make_on_hit_sphere_record    (prim index, integral, distance) of every
                               hit, for the per-hit trace (trace/sph.py)
  make_on_hit_record_ids       (ray, prim) id pair of every hit, for the
                               differentiable render (trace/render.py)
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


def _scatter_hits(cursor, hit, capacity, global_state, payloads):
    """Write each hit's payloads at cursor + its rank among the ray's hits
    of this leaf; positions at or past ``capacity`` are dropped (a spare
    slot past the end takes them). Returns (new cursor, new state)."""
    hit_i = hit.to(torch.int32)
    rank = torch.cumsum(hit_i, dim=-1, dtype=torch.int32) - hit_i
    pos = cursor[:, None] + rank
    pos = torch.where(hit & (pos < capacity), pos, capacity).long().flatten()
    state = {}
    for key, vals in payloads.items():
        buf = torch.cat([global_state[key], global_state[key].new_zeros(1)])
        state[key] = buf.scatter(0, pos, vals.flatten().to(buf.dtype))[:capacity]
    return cursor + hit.sum(dim=-1, dtype=cursor.dtype), state


def make_on_hit_sphere_record(spheres, table, capacity: int):
    """On-hit functor writing (prim index, integral, distance) of every hit
    into the global buffers ``indices`` (i32), ``integrals`` and
    ``distances`` (f32[capacity]). ray_data is each ray's write cursor,
    seeded with its offset; a hit goes to cursor + its rank among the ray's
    hits of this leaf, and writes at or past ``capacity`` are dropped."""
    h_arr = spheres[:, 3]
    table = torch.as_tensor(table, dtype=torch.float32, device=spheres.device)

    def on_hit(carry, ray_ids, prim_ids, info, hit):
        cursor, global_state = carry
        contrib = sph_integral(info.b2, h_arr[prim_ids], table)
        return _scatter_hits(cursor, hit, capacity, global_state,
                             {"indices": prim_ids, "integrals": contrib,
                              "distances": info.dist})

    return on_hit


def make_on_hit_record_ids(capacity: int):
    """On-hit functor writing each hit's (ray, prim) ids into the global
    buffers ``ray`` and ``prim`` (i32[capacity]). ray_data is each ray's
    write cursor, seeded with its offset (the exclusive cumulative hit
    count); a hit goes to cursor + its rank among the ray's hits of this
    leaf, and writes at or past ``capacity`` are dropped."""

    def on_hit(carry, ray_ids, prim_ids, info, hit):
        cursor, global_state = carry
        return _scatter_hits(cursor, hit, capacity, global_state,
                             {"ray": ray_ids[:, None].expand(prim_ids.shape),
                              "prim": prim_ids})

    return on_hit
