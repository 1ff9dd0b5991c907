"""grace_tpu_torch.parallel against grace_tpu.parallel, in 2 and 4 processes
on the CPU (gloo).

One module fixture per world size starts that many ranks of
tests/helper/parallel_worker.py (no JAX) once; they meet at a file store
under tmp_path, run every case on their own blocks and rank 0 saves the
gathered results. The tests compare them with ``grace_tpu`` on the same
inputs (tests/helper/parallel_cases.py) and the same mesh shape, (1, 2)
and (2, 2), and a ring of 4, (1, 4), on the first 2 or 4 of the 8
virtual JAX devices: the cases of tests/integration/test_sharding.py,
test_multihost.py's two-process ring step and ``dryrun_multichip``'s
checks, with their tolerances. Hit counts and overflow flags must be
exact.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as JP

from grace_tpu.build.sph import build_sph_tree
from grace_tpu.core.types import Rays
from grace_tpu.parallel import sharding as js
from grace_tpu.trace.pallas_kernel import pallas_trace_sph
from grace_tpu.trace.render import find_hits, integrate_hits
from grace_tpu.trace.splat import bucket_prims_ortho
from grace_tpu.trace.splat_grad import OrthoCamera, make_splat_trainer
from tests.helper import parallel_cases as cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "helper", "parallel_worker.py")
WORLDS = (2, 4)


def _launch(world, tmp):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    store = os.path.join(tmp, "store")
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(world), store, tmp],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=REPO)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {world} failed:\n{out[-4000:]}"
    with np.load(os.path.join(tmp, f"world{world}.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _launch(2, str(tmp_path_factory.mktemp("world2")))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _launch(4, str(tmp_path_factory.mktemp("world4")))


@pytest.fixture(params=WORLDS)
def world(request):
    """(world size, the ranks' gathered results)."""
    return request.param, request.getfixturevalue(f"world{request.param}")


@functools.lru_cache(maxsize=None)
def jmesh(world):
    return js.make_mesh(*cases.mesh_shape(world))


def jrays(o, d, lengths):
    return Rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(lengths))


@functools.lru_cache(maxsize=None)
def jtree(name, max_per_leaf):
    spheres = getattr(cases, name)()[0]
    return jax.jit(build_sph_tree, static_argnums=1)(jnp.asarray(spheres), max_per_leaf)


@functools.lru_cache(maxsize=None)
def j_train(world):
    spheres, o, d, lengths = cases.train()
    mesh = jmesh(world)
    targets = jnp.zeros((64,), jnp.float32)
    _, loss1, ovf1 = js.sharded_train_step(mesh, jrays(o, d, lengths), jnp.asarray(spheres),
                                           targets, capacity=4096, max_per_leaf=4, lr=1e-6)
    return float(loss1), bool(ovf1)


def test_layout_is_rays_major(world):
    """host_local_to_global / global_to_host_local (and DTensor with
    [Shard(0), Shard(0)]) put blocks in the order of JAX's
    P(("rays", "space")): device (r, s) holds block r * n_space + s."""
    w, res = world
    g = np.arange(8 * w, dtype=np.float32)
    mesh = jmesh(w)
    arr = jax.device_put(g, NamedSharding(mesh, JP(("rays", "space"))))
    by_device = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    want = np.stack([by_device[dev] for dev in mesh.devices.reshape(-1)])
    assert np.array_equal(res["layout_blocks"], want)
    for k in ("layout_roundtrip", "layout_dtensor", "layout_space"):
        assert np.array_equal(res[k], g), k


def test_replicated_sharded_render(world):
    """test_sharding.py:38 at the same mesh shape."""
    w, res = world
    spheres, o, d, lengths = cases.replicated()
    ss, tree, _ = jtree("replicated", 8)
    img, ovf = js.replicated_sharded_render(jmesh(w), jrays(o, d, lengths), ss, tree, 1 << 12)
    assert bool(ovf) is False and not res["replicated_ovf"]
    np.testing.assert_allclose(res["replicated_img"], np.asarray(img), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(res["replicated_img"], res["replicated_single"], rtol=1e-5,
                               atol=1e-7)


def test_ring_train_step_decreases_loss(world):
    """test_sharding.py:51: two steps at lr 1e-6, the loss within rtol 1e-5
    of grace_tpu's at the same mesh, and it drops."""
    w, res = world
    loss1, ovf1 = j_train(w)
    assert not ovf1 and not res["train_ovf"]
    np.testing.assert_allclose(float(res["train_loss1"]), loss1, rtol=1e-5)
    assert np.isfinite(res["train_loss2"])
    assert float(res["train_loss2"]) <= float(res["train_loss1"])


def test_ring_render_matches_unsharded(world):
    """test_sharding.py:64: the ring loss at lr 0 against the unsharded
    render of grace_tpu (the test's 1e-2), and against grace_tpu's ring
    within rtol 1e-5."""
    w, res = world
    spheres, o, d, lengths = cases.train()
    ss, tree, _ = jtree("train", 4)
    rays = jrays(o, d, lengths)
    img = integrate_hits(find_hits(rays, ss, tree, 1 << 14), rays, ss, rays.n_rays)
    loss_ref = float(jnp.sum(img ** 2))
    loss0 = float(res["train_loss0"])
    assert abs(loss0 - loss_ref) < 1e-2 * max(1.0, abs(loss_ref))
    np.testing.assert_allclose(loss0, j_train(w)[0], rtol=1e-5)


def test_undersized_capacity_raises(world):
    """test_sharding.py:81: the flag is set mesh-wide in both packages and
    the port's check_overflow raises GraceError."""
    w, res = world
    spheres, o, d, lengths = cases.undersized()
    _, _, ovf = js.sharded_train_step(jmesh(w), jrays(o, d, lengths), jnp.asarray(spheres),
                                      jnp.zeros((64,), jnp.float32), capacity=4, max_per_leaf=4,
                                      lr=1e-6)
    assert bool(ovf) and bool(res["undersized_ovf"])
    assert bool(res["undersized_raises"])


@functools.lru_cache(maxsize=None)
def j_fast(world):
    spheres, o, d, lengths = cases.fast_paths()
    mesh, rays, sp = jmesh(world), jrays(o, d, lengths), jnp.asarray(spheres)
    out = {}
    for name, kw in (("fast_v1", {}), ("fast_quarter", dict(broadphase="quarter")),
                     ("fast_hitcount", dict(mode="hitcount"))):
        v, ovf = js.sharded_pallas_render(mesh, rays, sp, tile=8, interpret=True, **kw)
        out[name], out[name + "_ovf"] = np.asarray(v), bool(ovf)
    v, ovf = js.ring_pallas_render(mesh, rays, sp, tile=8, interpret=True)
    out["fast_ring"], out["fast_ring_ovf"] = np.asarray(v), bool(ovf)
    single, _ = pallas_trace_sph(rays, sp, tile=8, broadphase="bitmask", interpret=True)
    out["single"] = np.asarray(single)
    return out


@pytest.mark.parametrize("route", ["fast_v1", "fast_quarter", "fast_hitcount", "fast_ring"])
def test_sharded_pallas_fast_path(world, route):
    """test_sharding.py:105 at the same mesh: the rays-sharded fused trace
    (bitmask, quarter: rtol 1e-5; hit counts exact) and the ring (rtol
    1e-4, atol 1e-6), no overflow."""
    w, res = world
    want = j_fast(w)
    assert not res[route + "_ovf"] and not want[route + "_ovf"]
    got = res[route]
    if route == "fast_hitcount":
        assert got.dtype == np.int32 and got.sum() > 0
        assert np.array_equal(got, want[route])
        return
    tol = dict(rtol=1e-4, atol=1e-6) if route == "fast_ring" else dict(rtol=1e-5)
    np.testing.assert_allclose(got, want[route], **tol)
    np.testing.assert_allclose(got, want["single"], **tol)
    np.testing.assert_allclose(got, res["fast_single"], **tol)
    if route == "fast_ring":
        # ragged blocks (tile 24 over 32 or 16 rays): the ring culls each step
        np.testing.assert_allclose(res["fast_ring_ragged"], res["fast_single"], **tol)


@pytest.mark.parametrize("name", ["splat", "splat_banded"])
def test_sharded_splat(world, name):
    """test_sharding.py:133 (deg10) and :148 (banded, deg8): the row-sharded
    splat within rtol 1e-5, atol 1e-7 of grace_tpu's at the same mesh, and
    equal to the port's single-device image."""
    w, res = world
    spheres, *_ = cases.fast_paths()
    band, basis = (None, "deg10") if name == "splat" else (32, "deg8")
    eye, look, up, ext, length = cases.SPLAT_CAMERA
    buckets = bucket_prims_ortho(jnp.asarray(spheres), eye, look, up, ext, length, 128, 32,
                                 tile_w=4, tile_h=128, chunk=128, band=band)
    img = js.sharded_splat_render(jmesh(w), buckets, tile_w=4, tile_h=128, interpret=True,
                                  basis=basis)
    np.testing.assert_allclose(res[name], np.asarray(img), rtol=1e-5, atol=1e-7)
    assert np.array_equal(res[name], res[name + "_single"])


def test_sharded_splat_rows_must_divide(world):
    assert bool(world[1]["splat_rows_raise"])


def test_global_mesh_larger_than_the_world_raises(world):
    assert bool(world[1]["mesh_too_big_raises"])


@functools.lru_cache(maxsize=None)
def j_dryrun(world):
    c = cases.dryrun(world)
    mesh = jmesh(world)
    spheres = jnp.asarray(c["spheres"])
    rays = jrays(c["origins"], c["directions"], c["lengths"])
    new, loss, ovf = js.sharded_train_step(mesh, rays, spheres, jnp.asarray(c["targets"]),
                                           capacity=4096, max_per_leaf=8, lr=1e-3)
    ss, tree, _ = jax.jit(lambda s: build_sph_tree(s, 8))(spheres)
    img, r_ovf = js.replicated_sharded_render(mesh, rays, ss, tree, capacity_per_shard=4096)
    single, _ = pallas_trace_sph(rays, ss, tile=8, broadphase="bitmask", interpret=True)
    cam = OrthoCamera((0.0, 0.0, -2.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 2.6, 6.0, 128, 16)
    render = make_splat_trainer(cam, tile_w=16, tile_h=128, interpret=True)
    tgt = jnp.asarray(c["splat_target"])
    loss_sp, (gs, gw) = jax.value_and_grad(
        lambda s, w: jnp.sum((render(s, w) - tgt) ** 2), argnums=(0, 1))(
            spheres, jnp.asarray(c["weights"]))
    return dict(new=np.asarray(new), loss=float(loss), ovf=bool(ovf) or bool(r_ovf),
                replicated=np.asarray(img), single=np.asarray(single), splat_loss=float(loss_sp),
                gs=np.asarray(gs), gw=np.asarray(gw), spheres=c["spheres"])


def test_dryrun_multichip_checks(world):
    """dryrun_multichip's step and checks with its tolerances, against
    grace_tpu at the same mesh: the train step's loss (rtol 1e-5) and
    sphere update at lr 1e-3 (1e-4 x max); the replicated render (rtol
    1e-5); the rays-sharded trace (v1, rtol 1e-5) and the ring (rtol 1e-4,
    atol 1e-6) against the single-device trace; the row-sharded splat
    (rtol 1e-5, atol 1e-7); the data-parallel splat step's gradients
    through allreduce_sum (atol 1e-5 x max), against the port's single
    call and grace_tpu's."""
    w, res = world
    want = j_dryrun(w)
    assert not want["ovf"]
    np.testing.assert_allclose(float(res["dry_loss"]), want["loss"], rtol=1e-5)
    upd, upd_want = res["dry_new"] - want["spheres"], want["new"] - want["spheres"]
    assert np.abs(upd_want).max() > 0
    np.testing.assert_allclose(upd, upd_want, rtol=0, atol=1e-4 * np.abs(upd_want).max())
    np.testing.assert_allclose(res["dry_replicated"], want["replicated"], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(res["dry_single"], want["single"], rtol=1e-5)
    np.testing.assert_allclose(res["dry_v1"], res["dry_single"], rtol=1e-5)
    np.testing.assert_allclose(res["dry_ring"], res["dry_single"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(res["dry_splat"], res["dry_splat_single"], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(res["dry_splat_loss"]), want["splat_loss"], rtol=1e-5)
    for k in ("gs", "gw"):
        got = res["dry_splat_" + k]
        for ref in (res[f"dry_splat_{k}_single"], want[k]):
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_ring_of_four(world4):
    """A ring of 4 ranks (mesh (1, 4)) against grace_tpu's at the same
    mesh: the fused ring trace (rtol 1e-4, atol 1e-6) and the ring
    training step's loss (rtol 1e-5) and sphere update at lr 1e-3 (1e-4 x
    max), the gradient carried back round four shifts."""
    mesh = js.make_mesh(1, 4)
    spheres, o, d, lengths = cases.fast_paths()
    v, ovf = js.ring_pallas_render(mesh, jrays(o, d, lengths), jnp.asarray(spheres), tile=8,
                                   interpret=True)
    assert not bool(ovf) and not world4["ring4_fast_ovf"]
    np.testing.assert_allclose(world4["ring4_fast"], np.asarray(v), rtol=1e-4, atol=1e-6)
    spheres, o, d, lengths = cases.train()
    new, loss, ovf = js.sharded_train_step(mesh, jrays(o, d, lengths), jnp.asarray(spheres),
                                           jnp.zeros((64,), jnp.float32), capacity=4096,
                                           max_per_leaf=4, lr=1e-3)
    assert not bool(ovf) and not world4["ring4_ovf"]
    np.testing.assert_allclose(float(world4["ring4_loss"]), float(loss), rtol=1e-5)
    upd, upd_want = world4["ring4_new"] - spheres, np.asarray(new) - spheres
    assert np.abs(upd_want).max() > 0
    np.testing.assert_allclose(upd, upd_want, rtol=0, atol=1e-4 * np.abs(upd_want).max())


def test_two_process_ring_train_step(world2):
    """test_multihost.py:94 through initialize, global_mesh,
    load_gadget_shard_for_process, global_to_host_local,
    host_local_to_global and process_allgather: the shards rebuild the
    written snapshot bit for bit, both ranks' losses are equal and within
    rtol 1e-5 of grace_tpu's ring step at mesh (1, 2)."""
    spheres, o, d, lengths = cases.multihost()
    assert np.array_equal(world2["mh_spheres"], spheres)
    losses = world2["mh_losses"]
    assert losses.shape == (2,) and losses[0] == losses[1] and not world2["mh_ovf"]
    _, loss_ref, ovf = js.sharded_train_step(jmesh(2), jrays(o, d, lengths),
                                             jnp.asarray(spheres), jnp.zeros((64,), jnp.float32),
                                             capacity=4096, max_per_leaf=4, lr=1e-6)
    assert not bool(ovf)
    np.testing.assert_allclose(float(losses[0]), float(loss_ref), rtol=1e-5)


def test_initialize_raises_without_a_card(monkeypatch):
    """No card and no request for the CPU: initialize raises before any
    rendezvous, and does not fall back to gloo."""
    import torch
    import torch.distributed as dist

    from grace_tpu_torch.parallel import multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        multihost.initialize("localhost:1", 1, 0)
    assert not dist.is_initialized()


def test_every_public_function_is_ported():
    """grace_tpu.parallel's 13 public functions, by name, in the port's
    modules and package, plus the two autograd pieces."""
    import importlib
    import inspect

    import grace_tpu.parallel.multihost as jmh
    import grace_tpu_torch.parallel as tp

    names = []
    for mod in (js, jmh):
        port = importlib.import_module(mod.__name__.replace("grace_tpu", "grace_tpu_torch", 1))
        for name, fn in inspect.getmembers(mod, inspect.isfunction):
            if not name.startswith("_") and fn.__module__ == mod.__name__:
                names.append(name)
                assert callable(getattr(port, name)) and getattr(tp, name) is getattr(port, name)
    assert len(names) == 13, names
    assert issubclass(tp.RingShift, __import__("torch").autograd.Function)
    assert callable(tp.allreduce_sum)
