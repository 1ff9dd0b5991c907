"""Generic BVH traversal engine (PyTorch counterpart of
``grace_tpu.trace.engine``).

Every ray walks the tree in lockstep with the others, each with its own
stack row in an [R, S] tensor: per step a ray at an internal node tests
the node's two child boxes and pushes the hit children (the right child
on top when both hit), and a ray at a leaf gathers the leaf's <=
max_per_leaf primitives and hands them to the functors. A host loop runs
until every stack is empty (one device-to-host read of ``any(sp > 0)`` per
step). The user extension points are the ``TraceFunctors`` callables; see
``grace_tpu_torch.trace.functors`` for the stock set.

This loop is the plain version of ``trace.walk``'s CUDA walk
(``csrc/bvh_walk.cu``, one thread a ray), which runs the stock functor
sets of the SPH facades and the triangle traces on the card; it stays the
route for user-defined functors, as ``grace_tpu``'s engine is the fallback
for exotic functors. ``trace.calls`` counts its calls.

Out-of-range stack reads clamp to the last column and pushes past
``stack_size`` are dropped, as ``grace_tpu``'s gathers and ``mode="drop"``
scatters do, so a too-small stack truncates the walk in the same way.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from grace_tpu_torch.core.config import VECTOR_STACK_SIZE
from grace_tpu_torch.core.errors import debug_assert
from grace_tpu_torch.core.tree import Tree
from grace_tpu_torch.core.types import Rays
from grace_tpu_torch.ops.intersect import aabbs_hit, safe_inverse_direction


@dataclass(frozen=True)
class TraceFunctors:
    """User extension points.

    intersect(rays_o, rays_d, rays_len, prims, ray_data) -> (hit, info)
      rays_*: [R, 1, ...] views broadcasting against prims [R, mpl, ...],
      the gathered leaf primitives. Returns bool[R, mpl] and any per-
      candidate info (e.g. b2, dist).

    on_hit(carry, ray_ids, prim_ids, info, hit) -> carry
      carry = (ray_data, global_state); prim_ids: i64[R, mpl] indices into
      the sorted primitive array; must honour the hit mask.

    ray_entry(ray_data) / ray_exit(ray_data) are optional pre/post maps.
    """

    intersect: Callable[..., Tuple[torch.Tensor, Any]]
    on_hit: Callable[..., Any]
    ray_entry: Optional[Callable[[Any], Any]] = None
    ray_exit: Optional[Callable[[Any], Any]] = None


def trace(
    rays: Rays,
    tree: Tree,
    prims: torch.Tensor,
    functors: TraceFunctors,
    ray_data_init: Any,
    global_init: Any = None,
    stack_size: int = VECTOR_STACK_SIZE,
) -> Tuple[Any, Any]:
    """Traverse the BVH for every ray, invoking the functors at leaves.

    Returns (ray_data, global_state) after every ray's traversal ends.
    """
    trace.calls += 1
    n_rays = rays.n_rays
    dev = rays.origins.device
    mpl = tree.max_per_leaf
    inv_d = safe_inverse_direction(rays.directions)
    ray_ids = torch.arange(n_rays, device=dev)
    o1 = rays.origins[:, None, :]
    d1 = rays.directions[:, None, :]
    len1 = rays.lengths[:, None]

    ray_data = ray_data_init
    if functors.ray_entry is not None:
        ray_data = functors.ray_entry(ray_data)
    global_state = global_init

    # Stack rows hold child entries (>= 0 internal node, < 0 leaf ~idx);
    # column stack_size is where dropped pushes land.
    stack = torch.zeros((n_rays, stack_size + 1), dtype=torch.int32, device=dev)
    stack[:, 0] = tree.root.to(torch.int32)
    sp = torch.ones(n_rays, dtype=torch.int32, device=dev)
    leaf_offsets = torch.arange(mpl, dtype=torch.int32, device=dev)
    last_prim = prims.shape[0] - 1

    while bool((sp > 0).any()):
        active = sp > 0
        top_col = torch.clamp(sp - 1, min=0)
        top = stack[ray_ids, torch.clamp(top_col, max=stack_size - 1)]
        at_leaf = active & (top < 0)
        at_node = active & (top >= 0)

        # internal node: test the two child boxes
        node = torch.clamp(top, 0, tree.capacity - 1).long()
        kids = tree.children[node]                    # [R, 2]
        boxes = tree.child_aabbs[node]                # [R, 2, 2, 3]
        hits = aabbs_hit(o1, inv_d[:, None, :], len1, boxes[:, :, 0, :],
                         boxes[:, :, 1, :]) & at_node[:, None]
        hit_l, hit_r = hits[:, 0], hits[:, 1]
        n_push = hit_l.to(torch.int32) + hit_r.to(torch.int32)
        # The popped entry is replaced; with both children hit, the right
        # one lands on top and pops first.
        first = torch.where(hit_l, kids[:, 0], kids[:, 1])
        col0 = torch.where(at_node & (n_push >= 1), top_col, stack_size)
        col1 = torch.where(at_node & (n_push == 2), top_col + 1, stack_size)
        stack[ray_ids, torch.clamp(col0, max=stack_size).long()] = first
        stack[ray_ids, torch.clamp(col1, max=stack_size).long()] = kids[:, 1]
        sp_node = sp - 1 + n_push
        debug_assert(~at_node | (sp_node <= stack_size),
                     "traversal stack overflow: raise stack_size")

        # leaf: gather its <= mpl primitives and intersect
        leaf = torch.clamp(torch.bitwise_not(top), 0, tree.leaf_capacity - 1).long()
        first_prim = tree.leaves[leaf, 0]
        count = tree.leaves[leaf, 1]
        prim_ids = first_prim[:, None] + leaf_offsets[None, :]
        in_leaf = (leaf_offsets[None, :] < count[:, None]) & at_leaf[:, None]
        prim_ids_c = torch.clamp(prim_ids, 0, last_prim).long()
        hit, info = functors.intersect(o1, d1, len1, prims[prim_ids_c], ray_data)
        ray_data, global_state = functors.on_hit(
            (ray_data, global_state), ray_ids, prim_ids_c, info, hit & in_leaf)

        sp = torch.where(at_leaf, sp - 1, torch.where(at_node, sp_node, sp))

    if functors.ray_exit is not None:
        ray_data = functors.ray_exit(ray_data)
    return ray_data, global_state


trace.calls = 0


def trace_bruteforce(rays: Rays, prims: torch.Tensor, intersect_fn, reduce_fn,
                     init, chunk: int = 256):
    """O(R * N) oracle: every ray against every primitive, no BVH.

    ``reduce_fn(init, hit, info, prim_ids)`` folds one chunk of rays'
    candidates into per-ray values (a tensor or a tuple of tensors); rays
    go ``chunk`` at a time to bound memory.
    """
    n = rays.n_rays
    prim_ids = torch.arange(prims.shape[0], device=prims.device)[None, :]
    outs = []
    for s in range(0, n, chunk):
        sl = slice(s, s + chunk)
        hit, info = intersect_fn(rays.origins[sl, None, :], rays.directions[sl, None, :],
                                 rays.lengths[sl, None], prims[None, :, :], None)
        outs.append(reduce_fn(init, hit, info, prim_ids))
    if isinstance(outs[0], (tuple, list)):
        return type(outs[0])(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)
