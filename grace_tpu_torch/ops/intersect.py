"""Ray-primitive and ray-AABB intersection tests.

PyTorch counterpart of ``grace_tpu.ops.intersect``:

  * ``sphere_hit``: ray vs sphere, returning the squared impact parameter
    and the along-ray distance of closest approach; a closest approach
    behind the origin or at/after the terminus is a miss.
  * ``aabbs_hit``: the slab test of rays against boxes, clamped to
    [0, length].

Branch-free over batched tensors. The sums of products are written as the
fused multiply-adds compiled XLA forms (``ops.vecmath.fma``), so the hit
masks equal ``grace_tpu``'s under ``jit`` bit for bit. ``torch.minimum``
and ``torch.maximum`` propagate NaN as XLA's min/max do.
"""

from __future__ import annotations

from typing import Tuple

import torch

from grace_tpu_torch.ops.vecmath import dot3, fma


def sphere_hit(origins, directions, lengths, spheres
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched ray-sphere impact-parameter test.

    Args:
      origins:    f32[..., 3] ray origins.
      directions: f32[..., 3] normalized directions.
      lengths:    f32[...] ray lengths.
      spheres:    f32[..., 4] (x, y, z, radius), broadcast against the rays.

    Returns (hit bool[...], b2 f32[...], dot_p f32[...]): hit where the ray
    passes within the radius with 0 <= dot_p < length; b2 the squared
    impact parameter (valid regardless of hit); dot_p the distance along
    the ray to the closest approach.
    """
    p = spheres[..., :3] - origins
    dot_p = dot3(p, directions)
    b = fma(-dot_p[..., None], directions, p)
    b2 = dot3(b, b)
    r = spheres[..., 3]
    hit = (b2 < r * r) & (dot_p >= 0.0) & (dot_p < lengths)
    return hit, b2, dot_p


def aabbs_hit(origins, inv_directions, lengths, aabb_mins, aabb_maxs) -> torch.Tensor:
    """Batched slab-method ray-AABB test clamped to [0, length].

    Args:
      origins:        f32[..., 3]
      inv_directions: f32[..., 3], 1 / direction (+-inf on zero components).
      lengths:        f32[...]
      aabb_mins, aabb_maxs: f32[..., 3], broadcast against the rays (a
        leading axis of 2 tests a node's two children at once).

    Returns bool[...]: tmax >= tmin with t clamped to [0, length].
    """
    t0 = (aabb_mins - origins) * inv_directions
    t1 = (aabb_maxs - origins) * inv_directions
    tnear = torch.minimum(t0, t1)
    tfar = torch.maximum(t0, t1)
    tmin = torch.maximum(torch.maximum(tnear[..., 0], tnear[..., 1]),
                         torch.maximum(tnear[..., 2], torch.zeros_like(lengths)))
    tmax = torch.minimum(torch.minimum(tfar[..., 0], tfar[..., 1]),
                         torch.minimum(tfar[..., 2], lengths))
    return tmax >= tmin


def safe_inverse_direction(directions) -> torch.Tensor:
    """1 / d, with signed infinities for zero components (IEEE division);
    the slab test relies on them."""
    return 1.0 / directions
