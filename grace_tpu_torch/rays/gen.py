"""Ray generation (PyTorch counterpart of ``grace_tpu.rays.gen``).

Conventions:
  * image ray index 0 is the top-left pixel and rays are row-major;
  * pixel centers: x = (2 (i+.5)/res_x - 1) * aspect, y = 1 - 2 (j+.5)/res_y;
  * sorts are stable, so ties keep ``grace_tpu``'s order;
  * vectors are normalized as ``grace_tpu``'s generators do when called
    eagerly, as ``bench.py`` calls them (``normalize3_unfused``).

Every generator takes the ``device`` its rays are created on; the default
is the CUDA card (``core.types.creation_device``), never a quiet CPU.

The random generators take a ``torch.Generator`` where ``grace_tpu`` takes
a JAX key, and draw on the generator's device (the default generator of
``device`` when it is None). Each splits into the draw and a private
deterministic map from the drawn numbers to ``Rays`` (``_uniform_rays``,
``_single_octant_rays``, ``_plane_parallel_rays``): fed ``jax.random``'s
draws, a map gives ``grace_tpu``'s rays bit for bit, although torch's
Philox and JAX's threefry draw different numbers.
"""

from __future__ import annotations

import torch

from grace_tpu_torch.core.types import Octants, Rays, RaySortType, creation_device, octant_signs
from grace_tpu_torch.ops import morton
from grace_tpu_torch.ops.morton import morton_key_30bit_from_unit, morton_keys_from_centroids
from grace_tpu_torch.ops.vecmath import cross, fma, normalize3_unfused, sqrt, tan_f32


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def ray_dir_morton_keys(directions) -> torch.Tensor:
    """30-bit Morton key of a normalized direction."""
    d01 = (directions + 1.0) * 0.5
    return morton_key_30bit_from_unit(d01[:, 0], d01[:, 1], d01[:, 2])


def _sort_rays_by_keys(rays: Rays, keys) -> Rays:
    return rays[torch.argsort(keys, stable=True)]


def _draw(generator, sampler, shape, device) -> torch.Tensor:
    """f32 draws of ``sampler`` (``torch.randn`` or ``torch.rand``) from
    ``generator`` on its own device, moved to ``device``."""
    src = device if generator is None else generator.device
    return sampler(shape, generator=generator, dtype=torch.float32, device=src).to(device)


def _div(x: torch.Tensor, s) -> torch.Tensor:
    """``x / s`` rounded once: a tensor divisor, since CUDA multiplies by
    the reciprocal of a Python scalar divisor."""
    return x / _f32(s, x.device)


def _midpoint_keys(rays: Rays, aabb_min, aabb_max, plain: bool = False) -> torch.Tensor:
    """30-bit Morton keys of the rays' midpoints ``o + 0.5 l d`` (as
    ``vecmath.fma`` forms them) in the box, default the midpoints' own: on
    CUDA tensors one launch (``morton.ray_keys_cuda``) that reads the rays
    and, without a box, folds it; on CPU tensors, and where ``plain``
    (which only the checks pass), the plain chain."""
    if not (plain or morton._on_cpu(rays.origins)):
        if (aabb_min is None) != (aabb_max is None):   # one edge given: torch's other
            mid = fma(0.5 * rays.lengths[:, None], rays.directions, rays.origins)
            aabb_min = mid.amin(dim=0) if aabb_min is None else aabb_min
            aabb_max = mid.amax(dim=0) if aabb_max is None else aabb_max
        return morton.ray_keys_cuda(rays.origins, rays.directions, rays.lengths, aabb_min,
                                    aabb_max)
    mid = fma(0.5 * rays.lengths[:, None], rays.directions, rays.origins)
    return morton_keys_from_centroids(mid, aabb_min, aabb_max, bits=30, plain=True)


def spatial_sort_rays(rays: Rays, aabb_min=None, aabb_max=None):
    """Sort rays by the 30-bit Morton key of their segment midpoint.

    Returns (sorted_rays, order, inverse_order): original_values =
    traced_values[inverse_order]. The inverse is the scatter
    ``inv[order] = arange(R)``, the same bits as a stable argsort of
    ``order`` with one launch instead of a sort."""
    order = torch.argsort(_midpoint_keys(rays, aabb_min, aabb_max), stable=True)
    n = order.shape[0]
    inv = torch.empty(n, dtype=torch.int32, device=order.device).scatter_(
        0, order, torch.arange(n, dtype=torch.int32, device=order.device))
    return rays[order], order.to(torch.int32), inv


def _uniform_rays(normals, origin, length, sort: bool) -> Rays:
    """The map of ``uniform_random_rays``: normalized standard normals."""
    d = normalize3_unfused(normals)
    n, dev = d.shape[0], d.device
    rays = Rays(_f32(origin, dev).expand(n, 3).contiguous(), d,
                torch.full((n,), float(length), dtype=torch.float32, device=dev))
    return _sort_rays_by_keys(rays, ray_dir_morton_keys(d)) if sort else rays


def uniform_random_rays(generator, n_rays: int, origin, length, sort: bool = True,
                        device=None) -> Rays:
    """Isotropic random rays from a common origin: normalized 3D standard
    normals (uniform on the sphere), direction-Morton sorted unless
    ``sort=False``."""
    device = creation_device(device)
    normals = _draw(generator, torch.randn, (n_rays, 3), device)
    return _uniform_rays(normals, origin, length, sort)


def _single_octant_rays(normals, origin, length, octant: Octants, sort: bool) -> Rays:
    """The map of ``uniform_random_rays_single_octant``: the uniform map of
    the normals folded into the octant."""
    signs = _f32(octant_signs(octant), normals.device)
    return _uniform_rays(normals.abs() * signs, origin, length, sort)


def uniform_random_rays_single_octant(generator, n_rays: int, origin, length,
                                      octant: Octants, sort: bool = True,
                                      device=None) -> Rays:
    """Isotropic rays restricted to one octant by sign-folding the normals."""
    device = creation_device(device)
    normals = _draw(generator, torch.randn, (n_rays, 3), device)
    return _single_octant_rays(normals, origin, length, octant, sort)


def one_to_many_rays(origin, points, sort_type: RaySortType = RaySortType.NoSort,
                     aabb_min=None, aabb_max=None, device=None) -> Rays:
    """Rays from one origin to each point, terminating at the point.

    DirectionSort sorts by the direction's 30-bit Morton key, EndPointSort
    by the endpoint's within the points' AABB (``aabb_min``/``aabb_max``,
    default the points' own). ``points`` go to ``device`` (default: their
    own device if a tensor, else the CUDA card)."""
    dev = creation_device(device, like=points)
    points = torch.as_tensor(points, dtype=torch.float32, device=dev)[:, :3]
    delta = points - _f32(origin, dev)
    p = delta * delta
    lengths = sqrt((p[:, 0] + p[:, 1]) + p[:, 2])
    d = delta / lengths[:, None]
    rays = Rays(_f32(origin, dev).expand(d.shape[0], 3).contiguous(), d, lengths)
    if sort_type == RaySortType.NoSort:
        return rays
    if sort_type == RaySortType.DirectionSort:
        return _sort_rays_by_keys(rays, ray_dir_morton_keys(d))
    if sort_type == RaySortType.EndPointSort:
        if aabb_min is None or aabb_max is None:   # the points' own box
            aabb_min = aabb_max = None
        return _sort_rays_by_keys(rays, morton_keys_from_centroids(points, aabb_min,
                                                                   aabb_max, bits=30))
    raise ValueError(f"unknown sort_type {sort_type}")


def _plane_parallel_rays(rw, rh, width: int, height: int, base, w, h, length) -> Rays:
    """The map of ``plane_parallel_random_rays``: cell (i, j) emits its ray
    from base + (i + rw) / width * w + (j + rh) / height * h."""
    dev = rw.device
    base, w, h = (_f32(a, dev) for a in (base, w, h))
    idx = torch.arange(width * height, dtype=torch.int32, device=dev)
    fw = _div((idx % width).to(torch.float32) + rw, width)
    fh = _div((idx // width).to(torch.float32) + rh, height)
    origins = (base + fw[:, None] * w) + fh[:, None] * h
    n = width * height
    directions = normalize3_unfused(cross(w, h)).expand(n, 3).contiguous()
    return Rays(origins, directions,
                torch.full((n,), float(length), dtype=torch.float32, device=dev))


def plane_parallel_random_rays(generator, width: int, height: int, base, w, h, length,
                               device=None) -> Rays:
    """Parallel rays from jittered cells of a planar grid.

    The plane is spanned by w (width direction) and h; each of the width x
    height cells emits one ray from a uniform-random point inside the cell,
    along normalize(cross(w, h)); the per-ray area is |w| |h| / (width
    height)."""
    device = creation_device(device)
    rw, rh = _draw(generator, torch.rand, (2, width * height), device)
    return _plane_parallel_rays(rw, rh, width, height, base, w, h, length)


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
