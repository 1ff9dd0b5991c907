"""Tile broadphase helpers (PyTorch counterpart of
``grace_tpu.trace.broadphase``; the lockstep tree walk comes later)."""

from __future__ import annotations

import torch

from grace_tpu_torch.core.types import Rays
from grace_tpu_torch.ops.vecmath import fma


def tile_aabbs(rays: Rays, tile: int):
    """Per-tile AABB of all ray segments (hull of origin/terminus points)."""
    if rays.n_rays % tile:
        raise ValueError("ray count must be a multiple of the tile size")
    o = rays.origins.reshape(-1, tile, 3)
    e = fma(rays.directions, rays.lengths[:, None], rays.origins).reshape(-1, tile, 3)
    mins = torch.minimum(o.amin(dim=1), e.amin(dim=1))
    maxs = torch.maximum(o.amax(dim=1), e.amax(dim=1))
    return mins, maxs
