"""grace_tpu_torch's sort-free splat trainer against grace_tpu.

The scene of grace_tpu's own tests (600 particles in a 128x64 image, a few
dead: h = 0 or out of depth), made from the same numpy seed for both
packages; grace_tpu's Pallas kernels run in interpret mode. Projections,
overlap matrices and packed masks are bit-exact (the camera is
axis-aligned). The forward is within 2e-5 x max of grace_tpu's and within
1e-5 x max of the port's bucketed splat; trainer gradients within 3e-5 x max
of ``jax.grad`` of grace_tpu's trainer and of autograd of the port's dense
oracle, with dead particles at exactly zero. On the bench scene's smaller
particles the sort-free and bucketed images differ by more, in grace_tpu
too (the last test pins it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grace_tpu.trace.splat_grad as js
from grace_tpu.core.types import make_spheres
from grace_tpu.trace.pallas_broadphase import pack_overlap_bits as j_pack
import grace_tpu_torch.trace.splat_grad as ts
from grace_tpu_torch.trace.pallas_broadphase import pack_overlap_bits as t_pack
from grace_tpu_torch.trace.splat import render_ortho_splat
from tests.helper.torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

CAM_J = js.OrthoCamera(camera_position=(0.5, 0.5, -2.0), look_at=(0.5, 0.5, 0.5),
                       view_up=(0.0, 1.0, 0.0), vertical_extent=1.4, length=6.0,
                       resolution_x=128, resolution_y=64)
CAM = ts.OrthoCamera(*CAM_J)


def scene(n=600, seed=1234):
    rng = np.random.default_rng(seed)
    pos = (0.15 + 0.7 * rng.random((n, 3))).astype(np.float32)
    h = (0.03 + 0.08 * rng.random(n)).astype(np.float32)
    h[:5] = 0.0                       # dead: h = 0
    pos[5:8, 2] = 50.0                # dead: out of depth
    w = (0.5 + rng.random(n)).astype(np.float32)
    return np.concatenate([pos, h[:, None]], axis=1), w


def _both(spheres, w):
    return (make_spheres(spheres[:, :3], spheres[:, 3]), jnp.asarray(w)), (
        torch.tensor(spheres), torch.tensor(w))


@pytest.mark.parametrize("tile_w", [16, 32])
def test_projection_and_masks_exact(tile_w):
    (sj, wj), (st, wt) = _both(*scene())
    pj = js.project_ortho(sj, wj, CAM_J)
    pt = ts.project_ortho(st, wt, CAM)
    for a, b in zip(pj, pt):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert np.array_equal(np.asarray(js.pack_proj_slabs(*pj)), ts.pack_proj_slabs(*pt).numpy())
    oj = js.projected_overlap(*pj, CAM_J, tile_w, 128)
    ot = ts.projected_overlap(*pt, CAM, tile_w, 128)
    assert np.array_equal(np.asarray(oj), ot.numpy()) and bool(ot.any())
    assert np.array_equal(np.asarray(j_pack(oj)), t_pack(ot).numpy())
    assert np.array_equal(np.asarray(j_pack(oj.T)), t_pack(ot.t()).numpy())


@pytest.mark.parametrize("basis", ["deg8", "deg10"])
@pytest.mark.parametrize("tile_w", [16, 32])
def test_sortfree_forward_matches_grace_tpu(tile_w, basis):
    (sj, wj), (st, wt) = _both(*scene())
    want = np.asarray(js.splat_forward_sortfree(sj, wj, CAM_J, tile_w=tile_w, tile_h=128,
                                                interpret=True, basis=basis))
    got = ts.splat_forward_sortfree(st, wt, CAM, tile_w=tile_w, tile_h=128, basis=basis)
    assert want.max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5 * np.abs(want).max())


def test_sortfree_forward_matches_bucketed_splat():
    _, (st, wt) = _both(*scene())
    got = ts.splat_forward_sortfree(st, wt, CAM, tile_w=16, tile_h=128)
    want, ovf = render_ortho_splat(st, CAM.camera_position, CAM.look_at, CAM.view_up,
                                   CAM.vertical_extent, CAM.length, CAM.resolution_x,
                                   CAM.resolution_y, weights=wt, tile_w=16, tile_h=128,
                                   chunk=128, band=None)
    assert not bool(ovf)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def _torch_loss_grads(loss, st, wt):
    s = st.clone().requires_grad_(True)
    w = wt.clone().requires_grad_(True)
    loss(s, w).backward()
    return s.grad.numpy(), w.grad.numpy()


def _assert_grads(got, want, rel):
    for g, r in zip(got, want):
        r = np.asarray(r)
        assert np.abs(g).sum() > 0
        np.testing.assert_allclose(g, r, rtol=0, atol=rel * np.abs(r).max())


@pytest.fixture(scope="module")
def trainer_grads():
    """(scene, target, the port trainer's gradients) of the L2 loss."""
    (sj, wj), (st, wt) = _both(*scene(n=300))
    tgt = np.asarray(jax.random.normal(jax.random.key(3), (CAM.resolution_y, CAM.resolution_x)))
    render = ts.make_splat_trainer(CAM, tile_w=16, tile_h=128)
    got = _torch_loss_grads(lambda s, w: ((render(s, w) - torch.tensor(tgt)) ** 2).sum(), st, wt)
    return (sj, wj), (st, wt), tgt, got


def test_trainer_gradients_match_grace_tpu(trainer_grads):
    (sj, wj), _, tgt, got = trainer_grads
    render = js.make_splat_trainer(CAM_J, tile_w=16, tile_h=128, interpret=True)
    want = jax.grad(lambda s, w: jnp.sum((render(s, w) - tgt) ** 2), argnums=(0, 1))(sj, wj)
    _assert_grads(got, want, 3e-5)
    assert np.all(got[0][:8] == 0) and np.all(got[1][:8] == 0)   # dead particles


def test_trainer_gradients_match_reference_torch(trainer_grads):
    _, (st, wt), tgt, got = trainer_grads
    want = _torch_loss_grads(
        lambda s, w: ((ts.splat_reference_torch(s, w, CAM) - torch.tensor(tgt)) ** 2).sum(),
        st, wt)
    _assert_grads(got, want, 3e-5)
    assert np.all(want[0][:8] == 0) and np.all(want[1][:8] == 0)


def test_reference_torch_matches_jnp():
    (sj, wj), (st, wt) = _both(*scene())
    want = np.asarray(js.splat_reference_jnp(sj, wj, CAM_J))
    got = ts.splat_reference_torch(st, wt, CAM).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_trainer_finite_difference():
    """Directional central differences of the autograd.Function, as
    grace_tpu's test takes them: an O(1) loss (small weights, mean square)
    keeps the f32 noise floor below the directional derivative."""
    spheres, w = scene(n=64)
    wt = torch.tensor(w) * 1e-3
    render = ts.make_splat_trainer(CAM, tile_w=16, tile_h=128)
    loss = lambda s: (render(s, wt) ** 2).mean()
    s = torch.tensor(spheres, requires_grad=True)
    loss(s).backward()
    g = s.grad.numpy().astype(np.float64)
    s0 = spheres.astype(np.float64)
    rng = np.random.default_rng(7)
    checked = 0
    for _ in range(4):
        d = rng.standard_normal(s0.shape)
        d[:8] = 0.0                        # keep dead particles dead
        d /= np.linalg.norm(d)
        eps = 2e-4
        with torch.no_grad():
            fp = float(loss(torch.tensor(s0 + eps * d, dtype=torch.float32)))
            fm = float(loss(torch.tensor(s0 - eps * d, dtype=torch.float32)))
        fd = (fp - fm) / (2 * eps)
        gd = float((g * d).sum())
        if abs(gd) < 1e-4:
            continue
        np.testing.assert_allclose(gd, fd, rtol=2e-2)
        checked += 1
    assert checked >= 2


def test_backward_no_capacity():
    """A segment overlapping every tile (one particle with h = 5) still
    gets its full gradient: the transposed mask has no capacity. The
    whole-image footprint sums thousands of terms per entry, so the bound
    is grace_tpu's, 5e-4 x max."""
    spheres, w = scene(n=256)
    spheres[100, :3] = (0.5, 0.5, 0.5)
    spheres[100, 3] = 5.0
    (sj, wj), (st, wt) = _both(spheres, w)
    want = js.splat_backward_sortfree(sj, wj, jnp.ones((64, 128)), CAM_J, tile_w=16,
                                      tile_h=128, interpret=True)
    got = ts.splat_backward_sortfree(st, wt, torch.ones(64, 128), CAM, tile_w=16, tile_h=128)
    _assert_grads([g.numpy() for g in got], want, 5e-4)
    ref = _torch_loss_grads(lambda s, ww: ts.splat_reference_torch(s, ww, CAM).sum(), st, wt)
    _assert_grads([g.numpy() for g in got], ref, 5e-4)


@pytest.mark.parametrize("tile_w", [8, 64])
def test_backward_matches_grace_tpu_at_tile_shapes(tile_w):
    """The sort-free backward at the smallest tile and at one of 64 rows,
    past the 32 rows the backward kernel once held in registers, on a
    seeded normal cotangent: within 3e-5 x max of grace_tpu's."""
    (sj, wj), (st, wt) = _both(*scene(n=300))
    g = np.random.default_rng(tile_w).standard_normal((64, 128)).astype(np.float32)
    want = js.splat_backward_sortfree(sj, wj, jnp.asarray(g), CAM_J, tile_w=tile_w,
                                      tile_h=128, interpret=True)
    got = ts.splat_backward_sortfree(st, wt, torch.tensor(g), CAM, tile_w=tile_w, tile_h=128)
    _assert_grads([x.numpy() for x in got], want, 3e-5)
    assert np.all(got[0][:8].numpy() == 0) and np.all(got[1][:8].numpy() == 0)


def test_rejects_bad_arguments():
    _, (st, wt) = _both(*scene(n=32))
    with pytest.raises(ValueError, match="basis"):
        ts.make_splat_trainer(CAM, basis="deg9")
    with pytest.raises(ValueError, match="multiple of the tile"):
        ts.splat_forward_sortfree(st, wt, CAM, tile_w=24, tile_h=128)


def test_sortfree_vs_bucketed_on_bench_particles():
    """grace_tpu's two splat paths place pixel centers by different
    formulas (x0 + i dx for the sort-free path, the bucketing's affine map),
    up to an ulp apart. On the bench scene's particles (h >= 0.005) that
    moves the image by more than 1e-5 x max in grace_tpu itself, and by the
    same amount in the port: 2000 particles at 128x128, both within
    1e-4 x max and neither within 1e-5 x max."""
    from grace_tpu.build.sph import build_sph_tree as j_build
    import grace_tpu.trace.splat as js_bucket
    from grace_tpu_torch.build.sph import build_sph_tree as t_build
    from chip_smoke import make_clustered_particles

    sp = make_clustered_particles(np.random.default_rng(2026), 2000)
    cam_j = js.OrthoCamera((0.5, 0.5, -2.0), (0.5, 0.5, 0.5), (0.0, 1.0, 0.0), 1.2, 6.0,
                           128, 128)
    kw = dict(tile_w=32, tile_h=128)
    ss, _, _ = jax.jit(j_build, static_argnums=1)(sp, 32)
    b = js_bucket.bucket_prims_ortho(ss, *cam_j[:5], 128, 128, chunk=512, band=32, **kw)
    rel_j = np.abs(np.asarray(js.splat_forward_sortfree(ss, None, cam_j, interpret=True, **kw))
                   - np.asarray(js_bucket.splat_image(b, basis="deg8", interpret=True, **kw)))
    rel_j = rel_j.max() / np.abs(np.asarray(js_bucket.splat_image(b, basis="deg8",
                                                                 interpret=True, **kw))).max()
    ss_t, _, _ = t_build(torch.from_numpy(sp), 32)
    img_b, _ = render_ortho_splat(ss_t, *cam_j[:5], 128, 128, chunk=512, band=32, **kw)
    img_s = ts.splat_forward_sortfree(ss_t, None, ts.OrthoCamera(*cam_j), **kw)
    rel_t = float((img_s - img_b).abs().max() / img_b.abs().max())
    assert 1e-5 < rel_j < 1e-4 and 1e-5 < rel_t < 1e-4, (rel_j, rel_t)
