"""Carry ``grace_tpu`` state into this package.

The system has no weights; its state is particle arrays, triangle meshes,
trees, rays, splat buckets and fitted coefficients (the coefficients ship as a copy of
``grace_tpu``'s cache). Each converter takes the numpy arrays of a
``grace_tpu`` object (``np.asarray`` of each field) and returns the port's
object on ``device`` (default: the CUDA card; pass ``device="cpu"`` for
CPU tensors), so the two packages can be fed the same inputs stage by
stage. An ``OrthoCamera`` carries across as its plain tuple:
``splat_grad.OrthoCamera(*cam)``. Nothing here imports ``grace_tpu`` or
JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from grace_tpu_torch.core.tree import Tree
from grace_tpu_torch.core.types import Rays, creation_device
from grace_tpu_torch.trace.splat import SplatBuckets


def _t(a, dtype, device):
    return torch.tensor(np.asarray(a), dtype=dtype, device=creation_device(device))


def spheres_from_numpy(spheres, device=None) -> torch.Tensor:
    """f32[N, 4] (x, y, z, h)."""
    return _t(spheres, torch.float32, device)


def triangles_from_numpy(tris, device=None) -> torch.Tensor:
    """f32[N, 3, 3] vertex triplets."""
    return _t(tris, torch.float32, device)


def rays_from_numpy(origins, directions, lengths, device=None) -> Rays:
    return Rays(_t(origins, torch.float32, device),
                _t(directions, torch.float32, device),
                _t(lengths, torch.float32, device))


def tree_from_numpy(children, child_aabbs, leaves, root, n_nodes, n_leaves,
                    max_per_leaf: int, device=None) -> Tree:
    i32 = lambda a: _t(a, torch.int32, device)
    return Tree(i32(children), _t(child_aabbs, torch.float32, device),
                i32(leaves), i32(root), i32(n_nodes), i32(n_leaves),
                int(max_per_leaf))


def splat_buckets_from_numpy(slabs, slab_lo, n_slabs, first, last, xcols, yrows,
                             overflow, device=None) -> SplatBuckets:
    i32 = lambda a: _t(a, torch.int32, device)
    f32 = lambda a: _t(a, torch.float32, device)
    return SplatBuckets(f32(slabs), i32(slab_lo), i32(n_slabs), i32(first),
                        i32(last), f32(xcols), f32(yrows),
                        _t(overflow, torch.bool, device))


def trainer_params_from_numpy(spheres, weights=None, device=None):
    """The trainers' parameters: (spheres f32[N, 4], weights f32[N] or
    None), as leaf tensors a caller can mark ``requires_grad``."""
    return (_t(spheres, torch.float32, device),
            None if weights is None else _t(weights, torch.float32, device))
