"""Triangle-mesh ray tracing: the generic-primitive path (PyTorch
counterpart of ``grace_tpu.models.triangle``).

Moller-Trumbore intersection with back-face culling, closest-hit and
any-hit (shadow) traces on the generic engine's walk
(``trace.walk.walk_tri``: the CUDA walk on the card, ``engine.trace`` on
the CPU), camera auto-framing, and a Lambert + hard-shadow render
(``render_triangles``) on either the engine's walk or the CUDA triangle
kernel (``trace.pallas_tri``). Triangles are f32[T, 3, 3] vertex
triplets; the LBVH build is ``build_primitive_tree`` with the
``TRIANGLE`` kind and XOR deltas.

The engine's intersection uses ``grace_tpu``'s compiled rounding (the
fused multiply-adds of ``ops.vecmath``); the shading in ``render_triangles``
uses its eager, op-by-op rounding (``normalize3_unfused``), as
``grace_tpu`` runs it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from grace_tpu_torch.build.sph import build_primitive_tree
from grace_tpu_torch.core.types import Rays, creation_device
from grace_tpu_torch.ops.primitives import TRIANGLE
from grace_tpu_torch.ops.vecmath import cross, dot3, normalize3_unfused, tan_f32
from grace_tpu_torch.rays.gen import pinhole_camera_rays
from grace_tpu_torch.trace.walk import walk_tri

EPS = 1e-7


def intersect_triangle(ray_o, ray_d, ray_len, tris, ray_data=None):
    """Batched Moller-Trumbore with back-face culling (only det > EPS
    counts). tris: [..., 3, 3] broadcasting against the rays; returns
    (hit, t) with t the ray parameter."""
    v0 = tris[..., 0, :]
    e1 = tris[..., 1, :] - v0
    e2 = tris[..., 2, :] - v0
    p = cross(ray_d, e2)
    det = dot3(e1, p)
    inv_det = 1.0 / torch.where(det.abs() > EPS, det, EPS)
    s = ray_o - v0
    u = dot3(s, p) * inv_det
    q = cross(s, e1)
    v = dot3(ray_d, q) * inv_det
    t = dot3(e2, q) * inv_det
    hit = ((det > EPS) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > EPS) & (t < ray_len))
    return hit, t


def build_triangle_tree(tris, max_per_leaf: int = 8):
    """LBVH over triangles: (sorted_tris, tree, permutation)."""
    return build_primitive_tree(tris, TRIANGLE, max_per_leaf, delta_kind="xor")


class ClosestHit(NamedTuple):
    t: torch.Tensor      # f32[R] closest hit distance (inf if none)
    tri: torch.Tensor    # i32[R] triangle index (-1 if none)


def trace_closest_hit(rays: Rays, tris, tree, stack_size: int = 64) -> ClosestHit:
    """Closest-hit trace: each ray keeps its least t (ties: the first
    triangle of a leaf in order, then the earlier leaf)."""
    t, tri = walk_tri(rays, tris, tree, "closest", stack_size)
    return ClosestHit(t=t, tri=tri)


def trace_any_hit(rays: Rays, tris, tree, stack_size: int = 64) -> torch.Tensor:
    """Occlusion (shadow) trace: bool[R], any hit along each ray."""
    return walk_tri(rays, tris, tree, "any", stack_size)


def auto_camera(tris, resolution: int, fov_y: float = math.pi / 3):
    """Frame the mesh AABB: the camera backs off along +z from its center
    by the distance that fits the bounds in the vertical field of view.
    Returns (camera f32[3], look_at f32[3], ray length f32[])."""
    flat = tris.reshape(-1, 3)
    mins, maxs = flat.amin(dim=0), flat.amax(dim=0)
    center = 0.5 * (mins + maxs)
    size = maxs - mins
    tan = torch.tensor(tan_f32(fov_y / 2.0), dtype=torch.float32, device=flat.device)
    dist = 0.6 * size.amax() / tan + 0.5 * size[2]
    cam = center + torch.stack([torch.zeros_like(dist), torch.zeros_like(dist), dist])
    return cam, center, 4.0 * dist


def shadow_inputs(rays: Rays, sorted_tris, hitrec: ClosestHit, light_dir, length):
    """What ``render_triangles`` shades a closest-hit pass with: the hit
    mask, |n . l| of each hit face, and the shadow rays toward the light
    from each hit point (offset 1e-3 along the normal)."""
    dev = sorted_tris.device
    hit_mask = torch.isfinite(hitrec.t)
    tri = sorted_tris[torch.clamp(hitrec.tri, 0, sorted_tris.shape[0] - 1).long()]
    n = normalize3_unfused(cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]))
    # Back-face culling makes every primary hit a front face; |n . l| shades.
    light = normalize3_unfused(torch.tensor(light_dir, dtype=torch.float32, device=dev))
    p = n * light
    lambert = ((p[:, 0] + p[:, 1]) + p[:, 2]).abs()
    hit_p = rays.origins + rays.directions * torch.where(hit_mask, hitrec.t, 0.0)[:, None]
    shadow_o = hit_p + n * 1e-3
    shadow = Rays(shadow_o, light.expand(shadow_o.shape).contiguous(),
                  torch.full((rays.n_rays,), float(length), dtype=torch.float32, device=dev))
    return hit_mask, lambert, shadow


def render_triangles(tris, resolution: int = 256, light_dir=(0.3, 1.0, 0.6),
                     ambient: float = 0.15, max_per_leaf: int = 8, engine: str = "xla",
                     device=None) -> torch.Tensor:
    """Lambert + hard-shadow render of a triangle mesh, f32[res, res]: a
    primary closest-hit pass from ``auto_camera``'s pinhole, then a shadow
    any-hit pass toward the light. engine='xla' traces on the generic
    engine's walk (``trace.walk.walk_tri``: ``csrc/bvh_walk.cu`` on the
    card), 'pallas' through ``pallas_trace_tri`` (``csrc/tri.cu`` on the
    card). ``tris`` (f32[T, 3, 3], a tensor or array) goes to ``device``
    (default: its own device if a tensor, else the CUDA card)."""
    if engine not in ("xla", "pallas"):
        raise ValueError(f"unknown engine {engine!r}")
    dev = creation_device(device, like=tris)
    tris = torch.as_tensor(tris, dtype=torch.float32, device=dev)
    sorted_tris, tree, _ = build_triangle_tree(tris, max_per_leaf)
    cam, look_at, length = auto_camera(sorted_tris, resolution)
    rays = pinhole_camera_rays(resolution, resolution, cam.tolist(), look_at.tolist(),
                               (0.0, 1.0, 0.0), math.pi / 3, float(length), device=dev)
    if engine == "pallas":
        from grace_tpu_torch.trace.pallas_tri import pallas_trace_tri

        t, tri_id, _ = pallas_trace_tri(rays, sorted_tris)
        hitrec = ClosestHit(t=t, tri=tri_id)
    else:
        hitrec = trace_closest_hit(rays, sorted_tris, tree)
    hit_mask, lambert, shadow = shadow_inputs(rays, sorted_tris, hitrec, light_dir, length)
    if engine == "pallas":
        occluded, _, _ = pallas_trace_tri(shadow, sorted_tris, mode="any")
    else:
        occluded = trace_any_hit(shadow, sorted_tris, tree)
    shade = ambient + torch.where(occluded, 0.0, lambert) * (1.0 - ambient)
    return torch.where(hit_mask, shade, 0.0).reshape(resolution, resolution)
