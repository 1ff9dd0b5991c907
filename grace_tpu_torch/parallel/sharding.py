"""Multi-card distribution on ``torch.distributed`` (PyTorch counterpart of
``grace_tpu.parallel.sharding``).

A ("rays", "space") mesh of ranks, one card (or one CPU process) each:

  * axis "rays": rays and image tiles are independent, so they are split
    over the ranks and the particles and tree replicated. The forward
    needs no communication; particle gradients are summed over this axis.
  * axis "space": when the particles exceed one card, each rank holds one
    spatial shard and builds its own BVH, and ray blocks with their
    accumulators go round the ring of "space" ranks, taking each shard's
    column density in turn (the structure of ring attention).

**The contract.** ``grace_tpu`` runs one controller over global arrays
under ``shard_map``; the port is SPMD: every rank of the mesh calls the
same function, with

  * this rank's block of every input that ``grace_tpu`` shards: rays and
    targets over ("rays", "space") in rays-major order (the rank at mesh
    coordinate (r, s) holds block r * n_space + s of the global order, as
    JAX's ``P(("rays", "space"))``), particles over "space" (block s);
  * the whole of every input that ``grace_tpu`` replicates;

and gets back this rank's block of every sharded output and the whole of
every replicated one (the overflow flag, the loss).
``multihost.host_local_to_global`` and ``multihost.global_to_host_local``
convert between a global tensor and a rank's block in that order.

Collectives: the mesh-wide overflow flag is one int32 ``all_reduce`` MAX
(NCCL reduces no bool) over the group of the whole mesh; the ring moves
tensors one step with ``batch_isend_irecv`` on the "space" group
(``RingShift``, whose backward moves the cotangent one step back); the
total loss is ``allreduce_sum``, whose backward is the identity. A ring
of one rank sends nothing (the other collectives run on groups of one
too). Nothing is caught: a failed collective raises.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from grace_tpu_torch.build.sph import build_sph_tree
from grace_tpu_torch.core.types import Rays
from grace_tpu_torch.trace.broadphase import _on_cpu, tile_aabbs
from grace_tpu_torch.trace.pallas_broadphase import (broadphase_boxes_cuda, masks_for_tile_aabbs,
                                                     overlap_words_cuda)
from grace_tpu_torch.trace.pallas_kernel import pallas_trace_sph
from grace_tpu_torch.trace.render import find_hits, integrate_hits
from grace_tpu_torch.trace.splat import SplatBuckets, splat_image

AXES = ("rays", "space")


def make_mesh(n_rays_axis: int, n_space_axis: int = 1, device_type: str = "cuda"
              ) -> DeviceMesh:
    """The ("rays", "space") mesh over the first n_rays_axis x n_space_axis
    ranks of the process group, rank r at coordinate (r // n_space_axis,
    r % n_space_axis). ``device_type`` is "cuda" (NCCL) or "cpu" (gloo).
    Raises ValueError when the mesh needs more ranks than the world has.
    The group of the whole mesh (``_mesh_group``) is made here too, while
    every rank of the world takes part."""
    n = n_rays_axis * n_space_axis
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"mesh {n_rays_axis}x{n_space_axis} needs {n} ranks, "
                         f"have {world} in the process group")
    mesh = init_device_mesh(device_type, (n_rays_axis, n_space_axis), mesh_dim_names=AXES)
    _mesh_group(mesh)
    return mesh


def _mesh_group(mesh: DeviceMesh):
    """The process group of every rank of the mesh: the mesh flattened to
    one axis, which ``DeviceMesh`` makes once and keeps."""
    return mesh._flatten().get_group()


def mesh_index(mesh: DeviceMesh) -> int:
    """This rank's block in rays-major order: r * n_space + s."""
    r, s = mesh.get_coordinate()
    return r * mesh.size(1) + s


def mesh_any(mesh: DeviceMesh, flag) -> torch.Tensor:
    """bool[]: ``flag`` set on any rank of the mesh (one int32 MAX)."""
    x = torch.as_tensor(flag).any().to(torch.int32).reshape(1)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=_mesh_group(mesh))
    return x[0] > 0


def ring_shift(tensors, group, step: int = 1):
    """Each tensor sent ``step`` ranks on round ``group``'s ring and the
    previous ranks' received, all in one ``batch_isend_irecv``; a group of
    one rank returns the tensors as they are."""
    ranks = dist.get_process_group_ranks(group)
    n = len(ranks)
    if n == 1:
        return list(tensors)
    i = ranks.index(dist.get_rank())
    dst, src = ranks[(i + step) % n], ranks[(i - step) % n]
    sends = [t.contiguous() for t in tensors]
    outs = [torch.empty_like(t) for t in sends]
    ops = ([dist.P2POp(dist.isend, t, dst, group) for t in sends]
           + [dist.P2POp(dist.irecv, t, src, group) for t in outs])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class RingShift(torch.autograd.Function):
    """``x`` moved one step round the ring of ``group`` (sent to the next
    rank, received from the previous one), differentiably: the backward
    moves the cotangent one step the other way. ``torch.distributed.nn``
    has no differentiable send or receive."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out, = ring_shift([x], group, 1)
        return out.clone() if out is x else out

    @staticmethod
    def backward(ctx, g):
        out, = ring_shift([g], ctx.group, -1)
        return out, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        y = x.clone()
        dist.all_reduce(y, group=_mesh_group(mesh))
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def allreduce_sum(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Sum of ``x`` over every rank of the mesh, on every rank, whose
    backward is the identity: the sum is replicated, so is its cotangent,
    and each rank's term takes it once. (The library's differentiable
    ``all_reduce`` sums the cotangent again and overcounts by the number
    of ranks.) ``x`` is cloned before the in-place collective, so tensors
    that autograd saved are left alone."""
    return _AllReduceSum.apply(x, mesh)


def replicated_sharded_render(mesh: DeviceMesh, rays: Rays, spheres, tree,
                              capacity_per_shard: int):
    """Rays split over the whole mesh, particles and tree replicated: this
    rank's column densities (``find_hits`` + ``integrate_hits``) and the
    mesh-wide overflow flag (some rank's hits exceeded
    ``capacity_per_shard``)."""
    recs = find_hits(rays, spheres, tree, capacity_per_shard)
    img = integrate_hits(recs, rays, spheres, rays.n_rays)
    return img, mesh_any(mesh, recs.total_hits > capacity_per_shard)


def sharded_pallas_render(mesh: DeviceMesh, rays: Rays, spheres, tile: int = 64,
                          mode: str = "cumulative", broadphase: str = "bitmask"):
    """The fused trace (``pallas_trace_sph``, CUDA kernels on the card) on
    this rank's rays, particles replicated; ``broadphase`` as
    ``pallas_trace_sph``'s ("bitmask" by default, or "quarter"). Returns (values f32/i32[R_local], overflow bool[]) with the
    flag reduced over the mesh (never set on these routes; kept for the
    uniform contract)."""
    v, ovf = pallas_trace_sph(rays, spheres, tile=tile, mode=mode, broadphase=broadphase)
    return v, mesh_any(mesh, ovf)


def ring_pallas_render(mesh: DeviceMesh, rays: Rays, spheres, tile: int = 64):
    """Particles split over "space" (``spheres`` is this rank's shard), the
    ray blocks and their accumulators going round the "space" ring, the
    fused bitmask trace at each step against the resident shard. The
    broadphase is hoisted out of the ring: the tile AABBs of every block
    are gathered over "space" and this shard's masks built for all of
    them first (rays in whole tiles only; otherwise each step culls). On
    CUDA tensors this shard's segment boxes come once, with the tile boxes
    in one launch, and each block's masks are one overlap-words launch.
    Returns (values f32[R_local], overflow bool[])."""
    group = mesh.get_group("space")
    n_space = mesh.size(1)
    idx = mesh.get_local_rank("space")
    masks_all = None
    if rays.n_rays % tile == 0:
        if _on_cpu(spheres):
            (tmin, tmax), segs = tile_aabbs(rays, tile), None
        else:
            (tmin, tmax), segs = broadphase_boxes_cuda(rays, tile, spheres)
        tmin_all = [torch.empty_like(tmin) for _ in range(n_space)]
        tmax_all = [torch.empty_like(tmax) for _ in range(n_space)]
        dist.all_gather(tmin_all, tmin.contiguous(), group=group)
        dist.all_gather(tmax_all, tmax.contiguous(), group=group)
        masks_all = [masks_for_tile_aabbs(a, b, spheres) if segs is None
                     else overlap_words_cuda(a, b, *segs) for a, b in zip(tmin_all, tmax_all)]
    block = rays
    acc = torch.zeros(rays.n_rays, dtype=torch.float32, device=rays.device)
    ovf = torch.zeros((), dtype=torch.bool, device=rays.device)
    for t in range(n_space):
        # after t shifts this rank holds the block that started at idx - t
        masks = None if masks_all is None else masks_all[(idx - t) % n_space]
        v, o = pallas_trace_sph(block, spheres, tile=tile, mode="cumulative",
                                broadphase="bitmask", masks=masks)
        acc = acc + v
        ovf = ovf | o.any()
        *moved, acc = ring_shift([block.origins, block.directions, block.lengths, acc], group)
        block = Rays(*moved)
    return acc, mesh_any(mesh, ovf)


def sharded_splat_render(mesh: DeviceMesh, buckets, tile_w: int = 64, tile_h: int = 128,
                         basis: str = "deg10"):
    """The splat image with its tile rows split over every rank of the
    mesh (rays-major, as the rays): ``buckets`` is replicated, and this
    rank renders its rows with ``splat_image`` (the CUDA kernel on the
    card). The keys are row-major over (row, column tile, band), so
    reshaped to [tile rows, keys a row] their leading axis is the tile
    rows. Returns this rank's rows of the image, f32[H / ranks, W].
    Raises ValueError when the tile rows do not divide over the ranks."""
    n_dev = mesh.size()
    h_res = buckets.yrows.shape[0]
    nty = h_res // tile_w
    if nty % n_dev:
        raise ValueError(f"tile rows {nty} must divide over {n_dev} devices")
    per = nty // n_dev
    lo = mesh_index(mesh) * per
    rows = lambda a: a.reshape(nty, -1)[lo:lo + per].reshape(-1)
    local = SplatBuckets(
        slabs=buckets.slabs, slab_lo=rows(buckets.slab_lo), n_slabs=rows(buckets.n_slabs),
        first=rows(buckets.first), last=rows(buckets.last), xcols=buckets.xcols,
        yrows=buckets.yrows[lo * tile_w:(lo + per) * tile_w], overflow=buckets.overflow)
    return splat_image(local, tile_w=tile_w, tile_h=tile_h, basis=basis)


def ring_render_and_loss(mesh: DeviceMesh, local_rays: Rays, local_spheres, target,
                         capacity: int, max_per_leaf: int, space_axis: str = "space"):
    """Ring column-density render and this rank's loss: the BVH of the
    resident shard is built once, then the ray blocks with their
    accumulators make a full circuit of the ``space_axis`` ring, each step
    adding this shard's contribution (``find_hits`` on the detached sorted
    spheres, ``integrate_hits`` on the differentiable ones) before the
    shift to the next rank. After ``n_space`` shifts every block is home
    with its full integral. Gradients reach ``local_spheres`` through the
    sort's gather and, round the ring, from every rank whose rays this
    shard touched. Returns (image f32[R_local], local loss, overflow
    bool[] reduced over the mesh)."""
    group = mesh.get_group(space_axis)
    n_space = mesh.size(AXES.index(space_axis))
    sorted_plain, tree, perm = build_sph_tree(local_spheres.detach(), max_per_leaf)
    sorted_spheres = local_spheres[perm.long()]
    block = local_rays
    acc = torch.zeros(local_rays.n_rays, dtype=torch.float32, device=local_rays.device)
    ovf = torch.zeros((), dtype=torch.bool, device=local_rays.device)
    for _ in range(n_space):
        recs = find_hits(block, sorted_plain, tree, capacity)
        acc = acc + integrate_hits(recs, block, sorted_spheres, block.n_rays)
        ovf = ovf | (recs.total_hits > capacity)
        block = Rays(*ring_shift([block.origins, block.directions, block.lengths], group))
        acc = RingShift.apply(acc, group)
    local_loss = ((acc - target) ** 2).sum()
    return acc, local_loss, mesh_any(mesh, ovf)


def sharded_train_step(mesh: DeviceMesh, rays: Rays, spheres, targets, capacity: int,
                       max_per_leaf: int, lr: float = 1e-3):
    """One differentiable training step over the mesh: ``rays`` and
    ``targets`` are this rank's blocks over ("rays", "space"), ``spheres``
    its "space" shard (replicated over "rays"). The total loss is
    ``allreduce_sum`` of the ranks' losses; its gradient on the shard is
    summed over "rays" (the psum JAX's shard_map transpose inserts), then
    SGD. Returns (new shard f32[n_local, 4], loss, overflow). overflow
    True means some rank's hit buffer overflowed ``capacity`` and the loss
    and gradient are truncated: callers must check it
    (``errors.check_overflow`` raises)."""
    local = spheres.detach().clone().requires_grad_(True)
    _, local_loss, overflow = ring_render_and_loss(mesh, rays, local, targets, capacity,
                                                   max_per_leaf)
    loss = allreduce_sum(local_loss, mesh)
    loss.backward()
    dist.all_reduce(local.grad, group=mesh.get_group("rays"))
    return spheres.detach() - lr * local.grad, loss.detach(), overflow
