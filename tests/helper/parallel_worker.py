"""One rank of the multi-process parity run of ``grace_tpu_torch.parallel``
on the CPU (gloo), for tests/test_torch_parallel.py:

    python tests/helper/parallel_worker.py RANK WORLD STORE OUT_DIR

WORLD ranks (2 or 4) meet at the file store STORE through
``multihost.initialize`` and form the ("rays", "space") mesh
``parallel_cases.mesh_shape(WORLD)`` with ``global_mesh``. Every rank runs
every case on its own block of the inputs (``parallel_cases``); the
results are gathered with ``host_local_to_global`` and rank 0 writes them
to OUT_DIR/world<WORLD>.npz. Imports no JAX: asserts that at exit.
"""

import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)    # several ranks share the cores (tests/helper/torch_parity.py)

import torch.distributed as dist  # noqa: E402

from grace_tpu_torch.build.sph import build_sph_tree  # noqa: E402
from grace_tpu_torch.core.errors import GraceError, check_overflow  # noqa: E402
from grace_tpu_torch.core.types import Rays  # noqa: E402
from grace_tpu_torch.io.gadget import write_gadget_gas  # noqa: E402
from grace_tpu_torch.parallel import multihost as mh  # noqa: E402
from grace_tpu_torch.parallel import sharding as sh  # noqa: E402
from grace_tpu_torch.trace.pallas_kernel import pallas_trace_sph  # noqa: E402
from grace_tpu_torch.trace.render import find_hits, integrate_hits  # noqa: E402
from grace_tpu_torch.trace.splat import bucket_prims_ortho, splat_image  # noqa: E402
from grace_tpu_torch.trace.splat_grad import OrthoCamera, make_splat_trainer  # noqa: E402
from tests.helper import parallel_cases as cases  # noqa: E402

R = mh.P(("rays", "space"))
S = mh.P("space")


def rays_of(o, d, lengths):
    return Rays(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (o, d, lengths)))


class Run:
    def __init__(self, mesh, rank):
        self.mesh, self.rank, self.res = mesh, rank, {}

    def keep(self, name, value, spec=None):
        """Gather ``value`` (this rank's block under ``spec``, or a
        replicated value) and keep it on rank 0."""
        value = torch.as_tensor(value)
        if spec is not None:
            value = mh.host_local_to_global(self.mesh, spec, value)
        self.res[name] = value.detach().cpu().numpy()

    def local_rays(self, o, d, lengths):
        return mh.global_to_host_local(self.mesh, R, rays_of(o, d, lengths))

    def raises(self, name, exc, fn):
        try:
            fn()
        except exc:
            self.res[name] = np.array(True)
        else:
            self.res[name] = np.array(False)


def layout_cases(run, world):
    """The rays-major order: each rank's block of arange, and the global
    tensor rebuilt from the blocks by hand, by host_local_to_global and by
    DTensor with [Shard(0), Shard(0)]."""
    from torch.distributed.tensor import DTensor, Shard

    g = torch.arange(8 * world, dtype=torch.float32)
    local = mh.global_to_host_local(run.mesh, R, g)
    run.keep("layout_blocks", mh.process_allgather(local))
    run.keep("layout_roundtrip", mh.host_local_to_global(run.mesh, R, local))
    run.keep("layout_dtensor", DTensor.from_local(local, run.mesh, [Shard(0), Shard(0)])
             .full_tensor())
    run.keep("layout_space", mh.global_to_host_local(run.mesh, S, g), S)


def sharding_cases(run):
    mesh = run.mesh
    # test_sharding.py:38, replicated render
    spheres, o, d, lengths = cases.replicated()
    ss, tree, _ = build_sph_tree(torch.from_numpy(spheres), 8)
    img, ovf = sh.replicated_sharded_render(mesh, run.local_rays(o, d, lengths), ss, tree, 1 << 12)
    run.keep("replicated_img", img, R)
    run.keep("replicated_ovf", ovf)
    rays = rays_of(o, d, lengths)
    recs = find_hits(rays, ss, tree, 1 << 14)
    run.keep("replicated_single", integrate_hits(recs, rays, ss, rays.n_rays))

    # :51 two steps at lr 1e-6; :64 the ring loss at lr 0
    spheres, o, d, lengths = cases.train()
    local_rays = run.local_rays(o, d, lengths)
    shard = mh.global_to_host_local(mesh, S, torch.from_numpy(spheres))
    targets = torch.zeros(local_rays.n_rays)
    s1, loss1, ovf1 = sh.sharded_train_step(mesh, local_rays, shard, targets, 4096, 4, 1e-6)
    _, loss2, ovf2 = sh.sharded_train_step(mesh, local_rays, s1, targets, 4096, 4, 1e-6)
    _, loss0, ovf0 = sh.sharded_train_step(mesh, local_rays, shard, targets, 4096, 4, 0.0)
    for name, v in (("train_loss1", loss1), ("train_loss2", loss2), ("train_loss0", loss0),
                    ("train_ovf", ovf0 | ovf1 | ovf2)):
        run.keep(name, v)

    # :81 an undersized capacity sets the flag mesh-wide and raises
    spheres, o, d, lengths = cases.undersized()
    local_rays = run.local_rays(o, d, lengths)
    shard = mh.global_to_host_local(mesh, S, torch.from_numpy(spheres))
    _, _, ovf = sh.sharded_train_step(mesh, local_rays, shard, torch.zeros(local_rays.n_rays),
                                      4, 4, 1e-6)
    run.keep("undersized_ovf", ovf)
    run.raises("undersized_raises", GraceError,
               lambda: check_overflow(ovf, "sharded train step hit-capacity overflow"))

    # :105 the fused trace: rays sharded (bitmask, quarter, hit counts), ring
    spheres, o, d, lengths = cases.fast_paths()
    sp = torch.from_numpy(spheres)
    local_rays = run.local_rays(o, d, lengths)
    single, _ = pallas_trace_sph(rays_of(o, d, lengths), sp, tile=8, broadphase="bitmask")
    run.keep("fast_single", single)
    for name, kw in (("fast_v1", {}), ("fast_quarter", dict(broadphase="quarter")),
                     ("fast_hitcount", dict(mode="hitcount"))):
        v, ovf = sh.sharded_pallas_render(mesh, local_rays, sp, tile=8, **kw)
        run.keep(name, v, R)
        run.keep(name + "_ovf", ovf)
    v, ovf = sh.ring_pallas_render(mesh, local_rays, mh.global_to_host_local(mesh, S, sp), tile=8)
    run.keep("fast_ring", v, R)
    run.keep("fast_ring_ovf", ovf)
    # ragged blocks: the ring culls inside each step (masks=None)
    v, _ = sh.ring_pallas_render(mesh, local_rays, mh.global_to_host_local(mesh, S, sp), tile=24)
    run.keep("fast_ring_ragged", v, R)

    # :133 and :148 the row-sharded splat, deg10 unbanded and deg8 banded
    eye, look, up, ext, length = cases.SPLAT_CAMERA
    for name, band, basis in (("splat", None, "deg10"), ("splat_banded", 32, "deg8")):
        buckets = bucket_prims_ortho(sp, eye, look, up, ext, length, 128, 32, tile_w=4,
                                     tile_h=128, chunk=128, band=band)
        run.keep(name + "_single", splat_image(buckets, tile_w=4, tile_h=128, basis=basis))
        run.keep(name, sh.sharded_splat_render(mesh, buckets, tile_w=4, tile_h=128,
                                               basis=basis), R)
    # tile rows that do not divide over the ranks
    buckets = bucket_prims_ortho(sp, eye, look, up, ext, length, 128, 12, tile_w=4, tile_h=128,
                                 chunk=128)
    run.raises("splat_rows_raise", ValueError,
               lambda: sh.sharded_splat_render(mesh, buckets, tile_w=4, tile_h=128))


def dryrun_cases(run, world):
    """``__graft_entry__.dryrun_multichip``'s step and checks."""
    mesh = run.mesh
    c = cases.dryrun(world)
    spheres = torch.from_numpy(c["spheres"])
    rays = rays_of(c["origins"], c["directions"], c["lengths"])
    local_rays = run.local_rays(c["origins"], c["directions"], c["lengths"])
    shard = mh.global_to_host_local(mesh, S, spheres)
    targets = mh.global_to_host_local(mesh, R, torch.from_numpy(c["targets"]))
    new, loss, ovf = sh.sharded_train_step(mesh, local_rays, shard, targets, 4096, 8, 1e-3)
    check_overflow(ovf, "sharded train step hit-capacity overflow")
    run.keep("dry_new", new, S)
    run.keep("dry_loss", loss)

    ss, tree, _ = build_sph_tree(spheres, 8)
    img, r_ovf = sh.replicated_sharded_render(mesh, local_rays, ss, tree, 4096)
    check_overflow(r_ovf, "replicated render hit-capacity overflow")
    run.keep("dry_replicated", img, R)

    single, _ = pallas_trace_sph(rays, ss, tile=8, broadphase="bitmask")
    v1, o1 = sh.sharded_pallas_render(mesh, local_rays, ss, tile=8)
    v2, o2 = sh.ring_pallas_render(mesh, local_rays, mh.global_to_host_local(mesh, S, ss), tile=8)
    check_overflow(o1 | o2, "pallas render overflow")
    run.keep("dry_single", single)
    run.keep("dry_v1", v1, R)
    run.keep("dry_ring", v2, R)

    res_y = 8 * world
    eye, look, up, ext, length = cases.SPLAT_CAMERA
    buckets = bucket_prims_ortho(ss, eye, look, up, ext, length, 128, res_y, tile_w=4,
                                 tile_h=128, chunk=128)
    run.keep("dry_splat_single", splat_image(buckets, tile_w=4, tile_h=128))
    run.keep("dry_splat", sh.sharded_splat_render(mesh, buckets, tile_w=4, tile_h=128), R)

    # the data-parallel splat training step: particles over the whole mesh,
    # images summed by allreduce_sum (identity backward)
    cam = OrthoCamera((0.0, 0.0, -2.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 2.6, 6.0, 128, 16)
    render = make_splat_trainer(cam, tile_w=16, tile_h=128)
    tgt = torch.from_numpy(c["splat_target"])
    ls = mh.global_to_host_local(mesh, R, spheres).clone().requires_grad_(True)
    lw = mh.global_to_host_local(mesh, R, torch.from_numpy(c["weights"])).clone()
    lw.requires_grad_(True)
    loss_sp = ((sh.allreduce_sum(render(ls, lw), mesh) - tgt) ** 2).sum()
    loss_sp.backward()
    run.keep("dry_splat_loss", loss_sp)
    run.keep("dry_splat_gs", ls.grad, R)
    run.keep("dry_splat_gw", lw.grad, R)
    s1 = spheres.clone().requires_grad_(True)
    w1 = torch.from_numpy(c["weights"]).clone().requires_grad_(True)
    ((render(s1, w1) - tgt) ** 2).sum().backward()
    run.keep("dry_splat_gs_single", s1.grad)
    run.keep("dry_splat_gw_single", w1.grad)


def ring_of_four_cases(run):
    """A ring of 4 ranks (mesh (1, 4)): the fused ring trace, and the ring
    training step's loss and update at lr 1e-3 (gradients back round four
    shifts)."""
    mesh = run.mesh
    spheres, o, d, lengths = cases.fast_paths()
    sp = torch.from_numpy(spheres)
    v, ovf = sh.ring_pallas_render(mesh, run.local_rays(o, d, lengths),
                                   mh.global_to_host_local(mesh, S, sp), tile=8)
    run.keep("ring4_fast", v, R)
    run.keep("ring4_fast_ovf", ovf)
    spheres, o, d, lengths = cases.train()
    local_rays = run.local_rays(o, d, lengths)
    new, loss, ovf = sh.sharded_train_step(
        mesh, local_rays, mh.global_to_host_local(mesh, S, torch.from_numpy(spheres)),
        torch.zeros(local_rays.n_rays), 4096, 4, 1e-3)
    run.keep("ring4_new", new, S)
    run.keep("ring4_loss", loss)
    run.keep("ring4_ovf", ovf)


def multihost_cases(run, out_dir):
    """test_multihost.py:94 through the multihost entry points: rank 0
    writes the snapshot, each rank reads its particle shard, the ring step
    runs on the rays' blocks, and every rank's loss is gathered."""
    mesh = run.mesh
    spheres, o, d, lengths = cases.multihost()
    path = os.path.join(out_dir, "snapshot.gdt")
    if run.rank == 0:
        write_gadget_gas(path, spheres)
    dist.barrier()
    shard = torch.from_numpy(mh.load_gadget_shard_for_process(path))
    run.keep("mh_spheres", shard, S)
    local_rays = run.local_rays(o, d, lengths)
    _, loss, ovf = sh.sharded_train_step(mesh, local_rays, shard, torch.zeros(local_rays.n_rays),
                                         4096, 4, 1e-6)
    loss_l, ovf_l = mh.global_to_host_local(mesh, (mh.P(), mh.P()), (loss, ovf))
    run.keep("mh_losses", mh.process_allgather(loss_l))
    run.keep("mh_ovf", ovf_l)


def main():
    rank, world, store, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    mh.initialize("file://" + store, world, rank, backend="gloo")
    mesh = mh.global_mesh(*cases.mesh_shape(world), device_type="cpu")
    run = Run(mesh, rank)
    run.raises("mesh_too_big_raises", ValueError, lambda: mh.global_mesh(world, 2, "cpu"))
    layout_cases(run, world)
    sharding_cases(run)
    dryrun_cases(run, world)
    if world == 2:
        multihost_cases(run, out_dir)
    else:
        ring4 = Run(mh.global_mesh(1, 4, device_type="cpu"), rank)
        ring4.res = run.res
        ring_of_four_cases(ring4)
    if rank == 0:
        np.savez(os.path.join(out_dir, f"world{world}.npz"), **run.res)
    dist.barrier()
    dist.destroy_process_group()
    assert "jax" not in sys.modules, "the worker imported JAX"


if __name__ == "__main__":
    main()
