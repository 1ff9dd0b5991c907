"""Geometry callables: per-primitive centroid and AABB.

A primitive kind is a pair of callables over a batch of primitives:
  centroid(prims) -> f32[N, 3]
  aabb(prims)     -> (f32[N, 3] mins, f32[N, 3] maxs)
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

AabbFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]
CentroidFn = Callable[[torch.Tensor], torch.Tensor]


class PrimitiveKind(NamedTuple):
    """Bundle of geometry callables describing a primitive type."""

    centroid: CentroidFn
    aabb: AabbFn


def sphere_aabb(spheres) -> Tuple[torch.Tensor, torch.Tensor]:
    """AABB of spheres f32[N, 4] = center +- radius."""
    c = spheres[..., :3]
    r = spheres[..., 3:4]
    return c - r, c + r


def sphere_centroid(spheres) -> torch.Tensor:
    """Sphere centers."""
    return spheres[..., :3]


SPHERE = PrimitiveKind(centroid=sphere_centroid, aabb=sphere_aabb)


def centroid_from_aabb(aabb_fn: AabbFn) -> CentroidFn:
    """Generic centroid: the AABB midpoint."""

    def centroid(prims):
        mins, maxs = aabb_fn(prims)
        return 0.5 * (mins + maxs)

    return centroid


def triangle_aabb(tris) -> Tuple[torch.Tensor, torch.Tensor]:
    """AABB of triangles stored as f32[N, 3, 3] (three vertices)."""
    return tris.amin(dim=-2), tris.amax(dim=-2)


TRIANGLE = PrimitiveKind(centroid=centroid_from_aabb(triangle_aabb), aabb=triangle_aabb)
