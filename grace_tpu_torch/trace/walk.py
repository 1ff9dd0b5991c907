"""The generic engine's BVH walk for the stock functor sets, through a
hand-written CUDA kernel.

``walk_sph`` and ``walk_tri`` launch ``csrc/bvh_walk.cu`` on CUDA tensors:
a warp walks its 32 rays as one packet, one stack of (node, lane mask)
entries in shared memory, in the lockstep walk's order for every ray
(``trace/engine.py``), so every ray visits the same leaves in the same
sequence; a warp in which a ray's stack would overflow walks its rays
again one thread a ray, as the plain walk does. On CPU tensors they run the plain
version, ``engine.trace`` with the stock functors. The SPH facades
(``trace/sph.py``, ``trace/render.find_hits``) and the triangle traces
(``models/triangle.py``) call them; user-defined ``TraceFunctors`` keep
``engine.trace``.

Modes of ``walk_sph``:

  count       i32[R] hit counts
  cumulative  f32[R] sums of lerp(table, (N-1) sqrt(b2)/h) / h^2, times
              ``weights[p]`` when given
  records     (indices i32, integrals f32, distances f32) of every hit
  ids         (ray i32, prim i32) of every hit

The two record modes write each hit at its ray's cursor (``cursors``: the
exclusive scan of the count pass), advancing it by one a hit, into flat
buffers of ``capacity`` entries filled with ``fill`` first; writes at or
past ``capacity`` are dropped. Modes of ``walk_tri``: closest (t f32[R],
inf where missed; triangle i32[R], -1 where missed; ties keep the first
in walk order) and any (occluded bool[R]).

Counts, records, triangle ids, t and occlusion are bit-equal to the plain
walk's; cumulative sums within rtol 1e-5 (the kernel adds a leaf's terms
in leaf order, torch's ``sum`` in its own). A stack of ``stack_size``
entries (at most ``MAX_STACK``) truncates the walk as the plain walk's
does; under ``GRACE_TPU_DEBUG`` an overflow raises with its message. Two
departures. The any-hit walk stops a ray at its first hit, so an
occluded ray's overflow flag and visit counts may differ from the plain
walk's (its occlusion does not). The closest walk, at ``stack_size`` of
``PRUNE_STACK`` and above, skips boxes that lie past a ray's best t,
which shortens its stack: a ray whose plain walk would overflow there
may end unoverflowed, with its true closest hit where the plain walk's
truncated walk need not find it.
"""

from __future__ import annotations

import ctypes

import torch

from grace_tpu_torch import _kernels
from grace_tpu_torch.core.config import VECTOR_STACK_SIZE
from grace_tpu_torch.core.errors import debug_assert
from grace_tpu_torch.core.tree import Tree
from grace_tpu_torch.core.types import Rays
from grace_tpu_torch.sph.kernel_integrals import DENSE_KERNEL_INTEGRAL_TABLE
from grace_tpu_torch.trace import engine
from grace_tpu_torch.trace import functors as F

MAX_STACK = 128   # bvh_walk.cu's kMaxStack: the largest stack_size, and a packet's entries
PRUNE_STACK = 64  # bvh_walk.cu's kPruneStack: closest-hit pruning at stacks of this and above
SPH_MODES = ("count", "cumulative", "records", "ids")
TRI_MODES = ("closest", "any")
# bvh_walk.cu's routes: the packet walk (restarting warps on the per-ray
# walk), and the per-ray walk alone, which the card checks hold it to
ROUTES = ("packet", "per_ray")
WARP = 32
# a warp's stats on route "packet": restarted (0 or 1), its packet steps and
# its active lanes summed over the steps
STATS_FIELDS = ("restarted", "steps", "lane_steps")
OVERFLOW_MESSAGE = "traversal stack overflow: raise stack_size"
_FILLS = {"records": (0, 0.0, 0.0), "ids": (-1, 0)}


def _check(name, rays: Rays, prims, prim_shape, tree: Tree, stack_size, mode, modes,
           ints=(), floats=()):
    """The mode, the stack size, the shapes the kernel indexes by (rays,
    primitives of ``prim_shape`` each) and ``_kernels.check_tensors`` over
    every tensor a launch reads (``ints``, ``floats``: the optional ones
    given). Returns the device."""
    if mode not in modes:
        raise ValueError(f"{name}: unknown mode {mode!r}")
    if not 1 <= stack_size <= MAX_STACK:
        raise ValueError(f"{name}: stack_size {stack_size} outside [1, {MAX_STACK}]")
    n = rays.n_rays
    if (rays.origins.shape != (n, 3) or rays.directions.shape != (n, 3)
            or rays.lengths.shape != (n,) or tuple(prims.shape[1:]) != prim_shape
            or prims.shape[0] < 1):
        raise ValueError(f"{name}: bad ray or primitive shapes")
    return _kernels.check_tensors(
        name, (tree.children, tree.leaves, tree.root, *ints),
        (rays.origins, rays.directions, rays.lengths, prims, tree.child_aabbs, *floats))


def _launch_args(rays: Rays, prims, tree: Tree):
    """The tensors every walk launch reads, contiguous (held by the caller
    until the launch is enqueued): the rays, the primitives and the tree's
    arrays 16-byte aligned (a sphere and a node's boxes load as float4, a
    node's children and a leaf as int2), its ``root`` left on the card."""
    return [t.contiguous() for t in (rays.origins, rays.directions, rays.lengths)] + [
        _kernels.aligned(t) for t in (prims, tree.children, tree.child_aabbs, tree.leaves)] + [
        tree.root.contiguous()]


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _stats_check(stats, route, n):
    if stats is not None and (route != "packet" or stats.shape != (-(-n // WARP),
                                                                   len(STATS_FIELDS))):
        raise ValueError("walk stats: route 'packet' and i32[ceil(R / 32), 3] only")
    return ROUTES.index(route)


def _launch_sph(rays, spheres, tree, mode, stack_size, table, weights, cursors, capacity,
                outs, visits=None, stats=None, route="packet"):
    """One launch of ``grace_walk_sph`` into ``outs`` (the mode's one to
    three output tensors); ``visits`` (i32[R, 2] or None) takes each ray's
    internal nodes and spheres tested, ``stats`` (i32[ceil(R / 32), 3] or
    None) each warp's ``STATS_FIELDS``. ``route`` "per_ray" walks every ray
    one thread a ray (the card checks' reference). Returns the per-ray
    overflow flags."""
    n = rays.n_rays
    overflow = torch.empty(n, dtype=torch.int32, device=spheres.device)
    args = _launch_args(rays, spheres, tree)
    opt = [None if t is None else t.contiguous() for t in (table, weights, cursors)]
    outs = list(outs) + [None] * (3 - len(outs))
    r = _stats_check(stats, route, n)
    _kernels.launch("bvh_walk", "grace_walk_sph", spheres.device,
                    *[_ptr(t) for t in args + opt + outs + [visits, overflow, stats]],
                    n, spheres.shape[0], tree.capacity, tree.leaf_capacity, tree.max_per_leaf,
                    stack_size, 0 if table is None else table.shape[0], SPH_MODES.index(mode),
                    capacity, r)
    return overflow


def _launch_tri(rays, tris, tree, mode, stack_size, outs, visits=None, stats=None,
                route="packet"):
    """One launch of ``grace_walk_tri`` into ``outs`` ((t, ids) or
    (occluded,)); ``visits``, ``stats`` and ``route`` as ``_launch_sph``'s.
    Returns the overflow flags."""
    overflow = torch.empty(rays.n_rays, dtype=torch.int32, device=tris.device)
    args = _launch_args(rays, tris, tree)
    outs = list(outs) + [None] * (2 - len(outs))
    r = _stats_check(stats, route, rays.n_rays)
    _kernels.launch("bvh_walk", "grace_walk_tri", tris.device,
                    *[_ptr(t) for t in args + outs + [visits, overflow, stats]],
                    rays.n_rays, tris.shape[0], tree.capacity, tree.leaf_capacity,
                    tree.max_per_leaf, stack_size, TRI_MODES.index(mode), r)
    return overflow


def walk_resources(device, kind: str, mode: str, route: str = "packet") -> dict:
    """What one launch of the walk kernel holds on ``device`` (kind "sph"
    or "tri", ``mode``, ``route``): ``_kernels.RESOURCE_FIELDS`` and
    ``local_bytes`` a thread (the per-ray walk's stack)."""
    fields = _kernels.RESOURCE_FIELDS + ("local_bytes",)
    out = (ctypes.c_int * len(fields))()
    modes = SPH_MODES if kind == "sph" else TRI_MODES
    _kernels.launch("bvh_walk", "grace_walk_resources", torch.device(device),
                    ctypes.addressof(out), ("sph", "tri").index(kind), modes.index(mode),
                    ROUTES.index(route))
    return dict(zip(fields, out))


def _sph_args(rays, spheres, tree, mode, stack_size, table, weights, cursors, capacity, fill):
    """walk_sph's arguments checked and completed: (device, table tensor or
    None, weights or None, cursors or None, capacity, fill)."""
    table = (torch.as_tensor(DENSE_KERNEL_INTEGRAL_TABLE if table is None else table,
                             dtype=torch.float32, device=spheres.device)
             if mode in ("cumulative", "records") else None)
    weights = weights if mode == "cumulative" else None
    if weights is not None and weights.shape != spheres.shape[:1]:
        raise ValueError(f"walk_sph: weights must be f32[{spheres.shape[0]}]")
    if mode not in ("records", "ids"):
        cursors, capacity = None, 0
    elif cursors is None or cursors.shape != (rays.n_rays,):
        raise ValueError(f"walk_sph: mode {mode!r} needs cursors i32[{rays.n_rays}]")
    device = _check("walk_sph", rays, spheres, (4,), tree, stack_size, mode, SPH_MODES,
                    ints=[t for t in (cursors,) if t is not None],
                    floats=[t for t in (table, weights) if t is not None])
    return device, table, weights, cursors, capacity, _FILLS.get(mode) if fill is None else fill


def _record_buffers(mode, capacity, fill, dev):
    """The flat record buffers of a record mode, filled with ``fill``."""
    if mode == "records":
        dtypes = {"indices": torch.int32, "integrals": torch.float32,
                  "distances": torch.float32}
    elif mode == "ids":
        dtypes = {"ray": torch.int32, "prim": torch.int32}
    else:
        return None
    return {k: torch.full((capacity,), v, dtype=dt, device=dev)
            for (k, dt), v in zip(dtypes.items(), fill)}


def _walk_sph_plain(rays, spheres, tree, mode, stack_size=VECTOR_STACK_SIZE, table=None,
                    weights=None, cursors=None, capacity=0, fill=None):
    """walk_sph's plain version on any device: ``engine.trace`` with the
    stock functors, as the facades called it."""
    dev, table, weights, cursors, capacity, fill = _sph_args(
        rays, spheres, tree, mode, stack_size, table, weights, cursors, capacity, fill)
    if mode == "count":
        fx, init = F.on_hit_count, torch.zeros(rays.n_rays, dtype=torch.int32, device=dev)
    elif mode == "cumulative":
        fx = F.make_on_hit_sphere_cumulate(spheres, table, weights)
        init = torch.zeros(rays.n_rays, dtype=torch.float32, device=dev)
    else:
        fx, init = (F.make_on_hit_sphere_record(spheres, table, capacity) if mode == "records"
                    else F.make_on_hit_record_ids(capacity)), cursors
    buffers = _record_buffers(mode, capacity, fill, dev)
    out, buffers = engine.trace(rays, tree, spheres,
                                engine.TraceFunctors(intersect=F.intersect_sphere, on_hit=fx),
                                ray_data_init=init, global_init=buffers, stack_size=stack_size)
    return out if buffers is None else tuple(buffers.values())


def walk_sph(rays: Rays, spheres: torch.Tensor, tree: Tree, mode: str,
             stack_size: int = VECTOR_STACK_SIZE, table=None, weights=None, cursors=None,
             capacity: int = 0, fill=None):
    """The SPH walk of every ray over ``tree`` and ``spheres`` f32[N, 4]:
    launches ``csrc/bvh_walk.cu`` on CUDA tensors, runs ``engine.trace``
    with the stock functors (``_walk_sph_plain``) on CPU tensors.

    mode 'count' returns i32[R]; 'cumulative' f32[R] (``table`` f32[N_t],
    default ``DENSE_KERNEL_INTEGRAL_TABLE``; ``weights`` f32[N] or None);
    'records' (indices, integrals, distances) with the ``table`` integral;
    'ids' (ray, prim). The record modes take ``cursors`` i32[R],
    ``capacity`` and ``fill`` (the buffers' initial values; default (0,
    0.0, 0.0) and (-1, 0)).
    """
    device, table, weights, cursors, capacity, fill = _sph_args(
        rays, spheres, tree, mode, stack_size, table, weights, cursors, capacity, fill)
    if device.type == "cpu":
        return _walk_sph_plain(rays, spheres, tree, mode, stack_size, table, weights, cursors,
                               capacity, fill)
    buffers = _record_buffers(mode, capacity, fill, device)
    if buffers is None:
        outs = (torch.empty(rays.n_rays, device=device,
                            dtype=torch.int32 if mode == "count" else torch.float32),)
    else:
        outs = tuple(buffers.values())
    overflow = _launch_sph(rays, spheres, tree, mode, stack_size, table, weights, cursors,
                           capacity, outs)
    walk_sph.launches += 1
    debug_assert(overflow == 0, OVERFLOW_MESSAGE)
    return outs[0] if buffers is None else outs


walk_sph.launches = 0


def _walk_tri_plain(rays, tris, tree, mode, stack_size=VECTOR_STACK_SIZE):
    """walk_tri's plain version on any device: ``engine.trace`` with the
    triangle functors, as the triangle traces called it."""
    # models.triangle imports this module
    from grace_tpu_torch.models.triangle import intersect_triangle

    n, dev = rays.n_rays, tris.device
    if mode == "closest":
        def on_hit(carry, ray_ids, prim_ids, info, hit):
            (t_min, tri_min), g = carry
            t = torch.where(hit, info, torch.inf)
            best = torch.argmin(t, dim=1, keepdim=True)
            bt = torch.gather(t, 1, best)[:, 0]
            btri = torch.gather(prim_ids, 1, best)[:, 0].to(torch.int32)
            closer = bt < t_min
            return (torch.where(closer, bt, t_min), torch.where(closer, btri, tri_min)), g

        init = (torch.full((n,), torch.inf, dtype=torch.float32, device=dev),
                torch.full((n,), -1, dtype=torch.int32, device=dev))
    else:
        def on_hit(carry, ray_ids, prim_ids, info, hit):
            occluded, g = carry
            return occluded | hit.any(dim=1), g

        init = torch.zeros(n, dtype=torch.bool, device=dev)
    out, _ = engine.trace(rays, tree, tris,
                          engine.TraceFunctors(intersect=intersect_triangle, on_hit=on_hit),
                          ray_data_init=init, stack_size=stack_size)
    return out


def walk_tri(rays: Rays, tris: torch.Tensor, tree: Tree, mode: str,
             stack_size: int = VECTOR_STACK_SIZE):
    """The triangle walk of every ray over ``tree`` and ``tris`` f32[T, 3,
    3]: launches ``csrc/bvh_walk.cu`` on CUDA tensors, runs ``engine.trace``
    with the triangle functors (``_walk_tri_plain``) on CPU tensors. mode 'closest' returns (t
    f32[R], inf where missed; triangle i32[R], -1 where missed); 'any'
    occluded bool[R]."""
    device = _check("walk_tri", rays, tris, (3, 3), tree, stack_size, mode, TRI_MODES)
    if device.type == "cpu":
        return _walk_tri_plain(rays, tris, tree, mode, stack_size)
    n = rays.n_rays
    if mode == "closest":
        outs = (torch.empty(n, dtype=torch.float32, device=device),
                torch.empty(n, dtype=torch.int32, device=device))
    else:
        outs = (torch.empty(n, dtype=torch.bool, device=device),)
    overflow = _launch_tri(rays, tris, tree, mode, stack_size, outs)
    walk_tri.launches += 1
    debug_assert(overflow == 0, OVERFLOW_MESSAGE)
    return outs if mode == "closest" else outs[0]


walk_tri.launches = 0
