"""Deterministic ray generation (PyTorch counterpart of ``grace_tpu.rays.gen``).

Conventions:
  * image ray index 0 is the top-left pixel and rays are row-major;
  * pixel centers: x = (2 (i+.5)/res_x - 1) * aspect, y = 1 - 2 (j+.5)/res_y;
  * sorts are stable, so ties keep ``grace_tpu``'s order;
  * vectors are normalized as ``grace_tpu``'s generators do when called
    eagerly, as ``bench.py`` calls them (``normalize3_unfused``).

Every generator takes the ``device`` its rays are created on; the default
is the CUDA card (``core.types.creation_device``), never a quiet CPU.
"""

from __future__ import annotations

import torch

from grace_tpu_torch.core.types import Rays, creation_device
from grace_tpu_torch.ops.morton import morton_key_30bit_from_unit, morton_keys_from_centroids
from grace_tpu_torch.ops.vecmath import cross, fma, normalize3_unfused, tan_f32


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def ray_dir_morton_keys(directions) -> torch.Tensor:
    """30-bit Morton key of a normalized direction."""
    d01 = (directions + 1.0) * 0.5
    return morton_key_30bit_from_unit(d01[:, 0], d01[:, 1], d01[:, 2])


def spatial_sort_rays(rays: Rays, aabb_min=None, aabb_max=None):
    """Sort rays by the 30-bit Morton key of their segment midpoint.

    Returns (sorted_rays, order, inverse_order): original_values =
    traced_values[inverse_order]."""
    mid = fma(0.5 * rays.lengths[:, None], rays.directions, rays.origins)
    if aabb_min is None:
        aabb_min = mid.amin(dim=0)
    if aabb_max is None:
        aabb_max = mid.amax(dim=0)
    keys = morton_keys_from_centroids(mid, aabb_min, aabb_max, bits=30)
    order = torch.argsort(keys, stable=True)
    inv = torch.argsort(order, stable=True)
    return rays[order], order.to(torch.int32), inv.to(torch.int32)


def _camera_basis(camera_position, look_at, view_up, device=None):
    view_dir = normalize3_unfused(_f32(look_at, device) - _f32(camera_position, device))
    v = normalize3_unfused(cross(view_dir, _f32(view_up, device)))  # right
    u = normalize3_unfused(cross(v, view_dir))  # up
    return view_dir, v, u


def _pixel_coords(resolution_x: int, resolution_y: int, aspect, device=None):
    n = resolution_x * resolution_y
    idx = torch.arange(n, dtype=torch.int32, device=device)
    i = (idx % resolution_x).to(torch.float32)
    j = (idx // resolution_x).to(torch.float32)
    x = (2.0 * ((i + 0.5) / resolution_x) - 1.0) * aspect
    y = 1.0 - 2.0 * ((j + 0.5) / resolution_y)
    return x, y


def orthographic_projection_rays(resolution_x: int, resolution_y: int,
                                 camera_position, look_at, view_up,
                                 vertical_extent, length, device=None) -> Rays:
    """Orthographic camera: pixel-center origins in the image plane through
    camera_position, common direction toward look_at."""
    device = creation_device(device)
    view_dir, v, u = _camera_basis(camera_position, look_at, view_up, device)
    aspect = resolution_x / resolution_y
    horizontal_extent = vertical_extent * aspect
    x, y = _pixel_coords(resolution_x, resolution_y, 1.0, device)
    origins = (_f32(camera_position, device)
               + x[:, None] * (v * _f32(horizontal_extent / 2.0, device))
               + y[:, None] * (u * _f32(vertical_extent / 2.0, device)))
    n = resolution_x * resolution_y
    directions = view_dir.expand(n, 3).contiguous()
    lengths = torch.full((n,), float(length), dtype=torch.float32, device=device)
    return Rays(origins, directions, lengths)


def pinhole_camera_rays(resolution_x: int, resolution_y: int, camera_position,
                        look_at, view_up, fov_y, length, device=None) -> Rays:
    """Perspective pinhole camera: directions through pixel centers of an
    image plane at 1/tan(FOVy/2)."""
    device = creation_device(device)
    view_dir, v, u = _camera_basis(camera_position, look_at, view_up, device)
    aspect = resolution_x / resolution_y
    half = float(torch.tensor(float(fov_y), dtype=torch.float32)) / 2.0
    n_pref = 1.0 / _f32(tan_f32(half), device)
    x, y = _pixel_coords(resolution_x, resolution_y, aspect, device)
    dirs = normalize3_unfused(x[:, None] * v + y[:, None] * u + n_pref * view_dir)
    n = resolution_x * resolution_y
    origins = _f32(camera_position, device).expand(n, 3).contiguous()
    lengths = torch.full((n,), float(length), dtype=torch.float32, device=device)
    return Rays(origins, dirs, lengths)
