"""SPH sphere build pipeline (PyTorch counterpart of ``grace_tpu.build.sph``).

    keys = morton_keys_sph(spheres)
    spheres_sorted = stable sort by key
    d = *_deltas_sph(spheres_sorted)
    tree = albvh_sph(spheres_sorted, d, mpl)

or the one-call ``build_sph_tree``. Keys are int64 (63-bit keys as one
value), sorted with a stable sort so ties keep ``grace_tpu``'s order.
"""

from __future__ import annotations

from typing import Tuple

import torch

from grace_tpu_torch.build import deltas as deltas_mod
from grace_tpu_torch.build.lbvh import build_lbvh
from grace_tpu_torch.core.tree import Tree
from grace_tpu_torch.ops import morton
from grace_tpu_torch.ops.primitives import SPHERE


def morton_keys_sph(spheres, aabb_min=None, aabb_max=None, bits: int = 30):
    """30/63-bit Morton keys of sphere centers (int64). The scene AABB
    defaults to the centroids' bounds."""
    centroids = SPHERE.centroid(spheres)
    if aabb_min is None:
        aabb_min = centroids.amin(dim=0)
    if aabb_max is None:
        aabb_max = centroids.amax(dim=0)
    return morton.morton_keys_from_centroids(centroids, aabb_min, aabb_max, bits=bits)


def sort_by_morton(spheres, aabb_min=None, aabb_max=None, bits: int = 30
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Key generation + stable sort. Returns (sorted_keys, sorted_spheres,
    permutation i32[N])."""
    keys = morton_keys_sph(spheres, aabb_min, aabb_max, bits=bits)
    keys_sorted, perm = torch.sort(keys, stable=True)
    return keys_sorted, spheres[perm], perm.to(torch.int32)


def euclidean_deltas_sph(sorted_spheres) -> torch.Tensor:
    return deltas_mod.euclidean_deltas(sorted_spheres, SPHERE.centroid)


def surface_area_deltas_sph(sorted_spheres) -> torch.Tensor:
    return deltas_mod.surface_area_deltas(sorted_spheres, SPHERE.aabb)


def xor_deltas_sph(sorted_keys, bits: int = 30) -> torch.Tensor:
    if bits == 63:
        return deltas_mod.xor_deltas_63bit(sorted_keys)
    return deltas_mod.xor_deltas(sorted_keys)


def albvh_sph(sorted_spheres, d, max_per_leaf: int) -> Tree:
    """Build the tree over Morton-sorted spheres."""
    mins, maxs = SPHERE.aabb(sorted_spheres)
    return build_lbvh(mins, maxs, d, max_per_leaf)


def build_sph_tree(spheres, max_per_leaf: int, delta_kind: str = "euclidean",
                   bits: int = 30, aabb_min=None, aabb_max=None
                   ) -> Tuple[torch.Tensor, Tree, torch.Tensor]:
    """One-call SPH build. Returns (sorted_spheres, tree, permutation)."""
    keys, sorted_spheres, perm = sort_by_morton(spheres, aabb_min, aabb_max, bits)
    if delta_kind == "euclidean":
        d = euclidean_deltas_sph(sorted_spheres)
    elif delta_kind == "surface_area":
        d = surface_area_deltas_sph(sorted_spheres)
    elif delta_kind == "xor":
        d = xor_deltas_sph(keys, bits)
    else:
        raise ValueError(f"unknown delta_kind {delta_kind!r}")
    tree = albvh_sph(sorted_spheres, d, max_per_leaf)
    return sorted_spheres, tree, perm
