"""Tile broadphase: per-ray-tile BVH culling into primitive chunk lists
(PyTorch counterpart of ``grace_tpu.trace.broadphase``).

Each tile of rays is bounded by the hull of its ray segments; that box
walks the tree once, and the leaves it overlaps become the tile's list of
(first primitive, count) chunks. Conservative: the per-ray test in the
trace kernel filters. ``max_chunks`` bounds a list; a tile that finds more
leaves keeps the first ``max_chunks`` in walk order and reports overflow.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from grace_tpu_torch.core.tree import Tree
from grace_tpu_torch.core.types import Rays
from grace_tpu_torch.ops.vecmath import fma


class TileChunks(NamedTuple):
    first: torch.Tensor     # i32[n_tiles, max_chunks] first primitive of each chunk
    count: torch.Tensor     # i32[n_tiles, max_chunks] primitives in the chunk
    n_chunks: torch.Tensor  # i32[n_tiles]
    overflow: torch.Tensor  # bool[n_tiles]: list truncated (results incomplete)


def _on_cpu(t: torch.Tensor) -> bool:
    """The broadphase wrappers' route: CPU tensors take the plain versions,
    every other tensor the kernels (which refuse a device but CUDA)."""
    return t.device.type == "cpu"


def _check_tile(rays: Rays, tile: int) -> None:
    if tile < 1 or rays.n_rays % tile:
        raise ValueError("ray count must be a multiple of the tile size")


def _tile_aabbs_plain(rays: Rays, tile: int):
    """Plain PyTorch version of ``tile_aabbs``."""
    _check_tile(rays, tile)
    o = rays.origins.reshape(-1, tile, 3)
    e = fma(rays.directions, rays.lengths[:, None], rays.origins).reshape(-1, tile, 3)
    mins = torch.minimum(o.amin(dim=1), e.amin(dim=1))
    maxs = torch.maximum(o.amax(dim=1), e.amax(dim=1))
    return mins, maxs


def tile_aabbs(rays: Rays, tile: int):
    """Per-tile AABB of all ray segments (hull of origin/terminus points):
    (mins, maxs) f32[n_rays / tile, 3]. On CUDA tensors one launch of
    ``csrc/broadphase.cu``'s ``grace_broadphase_boxes`` with no spheres
    (``pallas_broadphase.broadphase_boxes_cuda``); CPU tensors run
    ``_tile_aabbs_plain``."""
    if _on_cpu(rays.origins):
        return _tile_aabbs_plain(rays, tile)
    from grace_tpu_torch.trace.pallas_broadphase import broadphase_boxes_cuda

    return broadphase_boxes_cuda(rays, tile, None)[0]


def collect_tile_chunks(rays: Rays, tree: Tree, tile: int, max_chunks: int,
                        stack_size: int = 128) -> TileChunks:
    """Walk the tree once per tile, all tiles in lockstep, collecting the
    overlapped leaves as (first primitive, count) chunks.

    The walk is ``grace_tpu``'s step for step: a node's hit children
    replace it on the stack (the right child on top), pushes past
    ``stack_size`` and chunks past ``max_chunks`` are dropped, and stack
    reads past the end clamp to the last column.
    """
    tmin, tmax = tile_aabbs(rays, tile)
    n_tiles = tmin.shape[0]
    dev = tmin.device
    tids = torch.arange(n_tiles, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)

    # One spare column each: the target of dropped writes.
    stack = torch.zeros((n_tiles, stack_size + 1), **i32)
    stack[:, 0] = tree.root.to(torch.int32)
    sp = torch.ones(n_tiles, **i32)
    first = torch.zeros((n_tiles, max_chunks + 1), **i32)
    count = torch.zeros((n_tiles, max_chunks + 1), **i32)
    cursor = torch.zeros(n_tiles, **i32)

    while bool((sp > 0).any()):
        active = sp > 0
        top_col = torch.clamp(sp - 1, min=0)
        top = stack[tids, torch.clamp(top_col, max=stack_size - 1)]
        at_leaf = active & (top < 0)
        at_node = active & (top >= 0)

        node = torch.clamp(top, 0, tree.capacity - 1).long()
        kids = tree.children[node]
        boxes = tree.child_aabbs[node]             # [T, 2, 2, 3]
        overlap = ((tmin[:, None, :] <= boxes[:, :, 1, :])
                   & (boxes[:, :, 0, :] <= tmax[:, None, :])).all(dim=-1)
        overlap &= at_node[:, None]
        hit_l, hit_r = overlap[:, 0], overlap[:, 1]
        n_push = hit_l.to(torch.int32) + hit_r.to(torch.int32)
        fst = torch.where(hit_l, kids[:, 0], kids[:, 1])
        col0 = torch.where(at_node & (n_push >= 1), top_col, stack_size)
        col1 = torch.where(at_node & (n_push == 2), top_col + 1, stack_size)
        stack[tids, torch.clamp(col0, max=stack_size).long()] = fst
        stack[tids, torch.clamp(col1, max=stack_size).long()] = kids[:, 1]

        leaf = torch.clamp(torch.bitwise_not(top), 0, tree.leaf_capacity - 1).long()
        slot = torch.where(at_leaf & (cursor < max_chunks), cursor, max_chunks).long()
        first[tids, slot] = tree.leaves[leaf, 0]
        count[tids, slot] = tree.leaves[leaf, 1]
        cursor = cursor + at_leaf.to(torch.int32)

        sp = torch.where(at_leaf | at_node, sp - 1, sp) + torch.where(at_node, n_push, 0)
    return TileChunks(first=first[:, :max_chunks].contiguous(),
                      count=count[:, :max_chunks].contiguous(),
                      n_chunks=torch.clamp(cursor, max=max_chunks),
                      overflow=cursor > max_chunks)
