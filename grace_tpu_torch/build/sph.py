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
keys' launch folds the scene box when none is given; the stable key sort
stays a torch call.
After the sort one launch (``deltas.gather_deltas_cuda``) writes the
sorted spheres or triangles, the int32 permutation, their boxes and the
deltas, which go straight to ``build_lbvh``; other primitive kinds
(``deltas.gather_for``) keep the torch gather, ``kind.aabb`` and
``build.deltas``. CPU tensors, and
``plain=True`` (which only the checks pass), take every step's plain
version.
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
    defaults to the centroids' bounds: on CUDA tensors one launch reads the
    spheres' rows, folds that box and writes the keys."""
    return morton.morton_keys_from_centroids(SPHERE.centroid(spheres), aabb_min, aabb_max,
                                             bits=bits, plain=plain)


def sort_by_morton(spheres, aabb_min=None, aabb_max=None, bits: int = 30, plain: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Key generation + stable sort. Returns (sorted_keys, sorted_spheres,
    permutation i32[N])."""
    keys = morton_keys_sph(spheres, aabb_min, aabb_max, bits=bits, plain=plain)
    keys_sorted, perm = torch.sort(keys, stable=True)
    if deltas_mod._on_card(spheres, plain):
        sorted_spheres, perm32, *_ = deltas_mod.gather_deltas_cuda(spheres, "sphere", perm,
                                                                   boxes=False)
        return keys_sorted, sorted_spheres, perm32
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
    """One-call SPH build: ``build_primitive_tree`` over spheres. Returns
    (sorted_spheres, tree, permutation)."""
    return build_primitive_tree(spheres, SPHERE, max_per_leaf, delta_kind, bits, aabb_min,
                                aabb_max, plain)


def build_primitive_tree(prims, kind: PrimitiveKind, max_per_leaf: int,
                         delta_kind: str = "xor", bits: int = 30, aabb_min=None,
                         aabb_max=None, plain: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Generic-primitive build: Morton keys of ``kind.centroid`` within the
    scene box (default: the centroids' bounds) -> stable sort -> deltas ->
    LBVH over ``kind.aabb``. Returns (sorted_prims, tree, permutation
    i32[N])."""
    keys = morton.morton_keys_from_centroids(kind.centroid(prims), aabb_min, aabb_max,
                                             bits=bits, plain=plain)
    keys_sorted, perm = torch.sort(keys, stable=True)
    gather = deltas_mod.gather_for(kind, delta_kind, bits)
    if gather is not None and deltas_mod._on_card(prims, plain):
        sorted_prims, perm32, mins, maxs, d = deltas_mod.gather_deltas_cuda(
            prims, gather[0], perm, keys_sorted, gather[1])
        return sorted_prims, build_lbvh(mins, maxs, d, max_per_leaf), perm32
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
