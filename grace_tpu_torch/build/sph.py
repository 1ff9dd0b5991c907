"""SPH sphere build pipeline (PyTorch counterpart of ``grace_tpu.build.sph``).

    keys = morton_keys_sph(spheres)
    spheres_sorted = stable sort by key
    d = *_deltas_sph(spheres_sorted)
    tree = albvh_sph(spheres_sorted, d, mpl)

or the one-call ``build_sph_tree``; ``build_primitive_tree`` is the same
pipeline for any primitive kind (e.g. ``ops.primitives.TRIANGLE``). Keys
are int64 (63-bit keys as one value), sorted with a stable sort so ties
keep ``grace_tpu``'s order.

On CUDA tensors the keys, the deltas and the tree come from the kernels of
``csrc/build.cu`` (``ops.morton``, ``build.deltas``, ``build.lbvh``); the
scene box (``amin`` / ``amax``), the stable key sort and the gather of the
sorted primitives stay torch calls. CPU tensors, and ``plain=True`` (which
only the checks pass), take every step's plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from grace_tpu_torch.build import deltas as deltas_mod
from grace_tpu_torch.build.lbvh import build_lbvh
from grace_tpu_torch.core.tree import Tree
from grace_tpu_torch.ops import morton
from grace_tpu_torch.ops.primitives import SPHERE, PrimitiveKind


def morton_keys_sph(spheres, aabb_min=None, aabb_max=None, bits: int = 30,
                    plain: bool = False):
    """30/63-bit Morton keys of sphere centers (int64). The scene AABB
    defaults to the centroids' bounds."""
    centroids = SPHERE.centroid(spheres)
    if aabb_min is None:
        aabb_min = centroids.amin(dim=0)
    if aabb_max is None:
        aabb_max = centroids.amax(dim=0)
    return morton.morton_keys_from_centroids(centroids, aabb_min, aabb_max, bits=bits,
                                             plain=plain)


def sort_by_morton(spheres, aabb_min=None, aabb_max=None, bits: int = 30, plain: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Key generation + stable sort. Returns (sorted_keys, sorted_spheres,
    permutation i32[N])."""
    keys = morton_keys_sph(spheres, aabb_min, aabb_max, bits=bits, plain=plain)
    keys_sorted, perm = torch.sort(keys, stable=True)
    return keys_sorted, spheres[perm], perm.to(torch.int32)


def euclidean_deltas_sph(sorted_spheres, plain: bool = False) -> torch.Tensor:
    return deltas_mod.euclidean_deltas(sorted_spheres, SPHERE.centroid, plain=plain)


def surface_area_deltas_sph(sorted_spheres, plain: bool = False) -> torch.Tensor:
    return deltas_mod.surface_area_deltas(sorted_spheres, SPHERE.aabb, plain=plain)


def xor_deltas_sph(sorted_keys, bits: int = 30, plain: bool = False) -> torch.Tensor:
    if bits == 63:
        return deltas_mod.xor_deltas_63bit(sorted_keys, plain=plain)
    return deltas_mod.xor_deltas(sorted_keys, plain=plain)


def albvh_sph(sorted_spheres, d, max_per_leaf: int, plain: bool = False) -> Tree:
    """Build the tree over Morton-sorted spheres."""
    mins, maxs = SPHERE.aabb(sorted_spheres)
    return build_lbvh(mins, maxs, d, max_per_leaf, plain=plain)


def build_sph_tree(spheres, max_per_leaf: int, delta_kind: str = "euclidean",
                   bits: int = 30, aabb_min=None, aabb_max=None, plain: bool = False
                   ) -> Tuple[torch.Tensor, Tree, torch.Tensor]:
    """One-call SPH build. Returns (sorted_spheres, tree, permutation)."""
    keys, sorted_spheres, perm = sort_by_morton(spheres, aabb_min, aabb_max, bits, plain)
    if delta_kind == "euclidean":
        d = euclidean_deltas_sph(sorted_spheres, plain)
    elif delta_kind == "surface_area":
        d = surface_area_deltas_sph(sorted_spheres, plain)
    elif delta_kind == "xor":
        d = xor_deltas_sph(keys, bits, plain)
    else:
        raise ValueError(f"unknown delta_kind {delta_kind!r}")
    tree = albvh_sph(sorted_spheres, d, max_per_leaf, plain)
    return sorted_spheres, tree, perm


def build_primitive_tree(prims, kind: PrimitiveKind, max_per_leaf: int,
                         delta_kind: str = "xor", bits: int = 30, plain: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Generic-primitive build: Morton keys of ``kind.centroid`` within the
    centroids' bounds -> stable sort -> deltas -> LBVH over ``kind.aabb``.
    Returns (sorted_prims, tree, permutation i32[N])."""
    centroids = kind.centroid(prims)
    keys = morton.morton_keys_from_centroids(centroids, centroids.amin(dim=0),
                                             centroids.amax(dim=0), bits=bits, plain=plain)
    keys_sorted, perm = torch.sort(keys, stable=True)
    sorted_prims = prims[perm]
    if delta_kind == "xor":
        d = xor_deltas_sph(keys_sorted, bits, plain)
    elif delta_kind == "euclidean":
        d = deltas_mod.euclidean_deltas(sorted_prims, kind.centroid, plain=plain)
    elif delta_kind == "surface_area":
        d = deltas_mod.surface_area_deltas(sorted_prims, kind.aabb, plain=plain)
    else:
        raise ValueError(f"unknown delta_kind {delta_kind!r}")
    mins, maxs = kind.aabb(sorted_prims)
    return (sorted_prims, build_lbvh(mins, maxs, d, max_per_leaf, plain=plain),
            perm.to(torch.int32))
