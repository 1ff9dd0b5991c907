"""grace_tpu_torch's fused differentiable renderer against grace_tpu.

The scene of grace_tpu's own tests (800 particles Morton-sorted by
grace_tpu, 32x32 plane-parallel rays carried across as arrays);
grace_tpu's Pallas kernels run in interpret mode. The packed slabs and the
transposed cull lists (ids, counts, overflow) are bit-exact. The forward
is within rtol 1e-5, atol 1e-6 x max of grace_tpu's and its gradients
within 1e-5 x max; against the record-based path the bounds are
grace_tpu's own (the fit against the table). Overflow is loud: a flag in
the forward, NaN gradients in the backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grace_tpu.trace.pallas_render as jp
import grace_tpu.trace.render as jr
from grace_tpu.build.sph import build_sph_tree as j_build
from grace_tpu.core.types import make_spheres
from grace_tpu.rays.gen import plane_parallel_random_rays
import grace_tpu_torch.trace.pallas_render as tp
import grace_tpu_torch.trace.render as tr
from grace_tpu_torch import convert
from tests.helper.torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

N = 800


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(1234)
    spheres = make_spheres((0.2 + 0.6 * rng.random((N, 3))).astype(np.float32),
                           (0.04 + 0.05 * rng.random(N)).astype(np.float32))
    ss, tree, _ = jax.jit(j_build, static_argnums=1)(spheres, 16)
    rays = plane_parallel_random_rays(jax.random.key(0), 32, 32, (0, 0, -2.0), (1, 0, 0),
                                      (0, 1, 0), 5.0)
    rays_t = convert.rays_from_numpy(
        *(np.asarray(x) for x in (rays.origins, rays.directions, rays.lengths)), device="cpu")
    w = (0.5 + rng.random(N)).astype(np.float32)
    tgt = np.asarray(jax.random.normal(jax.random.key(1), (rays.n_rays,)))
    return (ss, tree, rays), (convert.spheres_from_numpy(ss, device="cpu"), rays_t), w, tgt


@pytest.mark.parametrize("weighted", [False, True])
def test_pack_helpers_exact(scene, weighted):
    (ss, _, rays), (ss_t, rays_t), w, tgt = scene
    wj, wt = (jnp.asarray(w), torch.tensor(w)) if weighted else (None, None)
    for jf, tf in ((jp._pack_prims_3d, tp._pack_prims_3d),
                   (jp._pack_prims_sub, tp._pack_prims_sub)):
        (a, na), (b, nb) = jf(ss[:700], wj if wj is None else wj[:700]), tf(
            ss_t[:700], wt if wt is None else wt[:700])
        assert na == nb and np.array_equal(np.asarray(a), b.numpy())
    r = rays_t[:1000]
    a, na = jp._pack_rays_bwd(rays[:1000], tgt[:1000])
    b, nb = tp._pack_rays_bwd(r, torch.tensor(tgt[:1000]))
    assert na == nb == 1024 and np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("max_tiles", [3, 64])
def test_dense_segment_tiles_exact(scene, max_tiles):
    (ss, _, rays), (ss_t, rays_t), _, _ = scene
    want = jp.dense_segment_tiles(rays, ss, 128, max_tiles)
    got = tp.dense_segment_tiles(rays_t, ss_t, 128, max_tiles, seg_block=4)
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert bool(got[2].any()) == (max_tiles == 3)


def _grads(render, rays, ss_t, w, tgt):
    s = ss_t.clone().requires_grad_(True)
    ww = torch.tensor(w, requires_grad=True)
    (render(rays, s, ww) * torch.tensor(tgt)).sum().backward()
    return s.grad.numpy(), ww.grad.numpy()


def _assert_grads(got, want, rels):
    for g, r, rel in zip(got, want, rels):
        r = np.asarray(r)
        assert np.isfinite(g).all() and np.abs(g).sum() > 0
        np.testing.assert_allclose(g, r, rtol=0, atol=rel * np.abs(r).max())


def test_fused_forward_matches_grace_tpu(scene):
    (ss, _, rays), (ss_t, rays_t), w, _ = scene
    want = np.asarray(jp.make_fused_renderer(tile=64, max_chunks=64, interpret=True)(
        rays, ss, jnp.asarray(w)))
    got = tp.make_fused_renderer(tile=64, max_chunks=64)(rays_t, ss_t, torch.tensor(w))
    assert (want > 0).sum() > 100
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_fused_gradients_match_grace_tpu(scene):
    (ss, _, rays), (ss_t, rays_t), w, tgt = scene
    render = jp.make_fused_renderer(tile=64, max_chunks=64, interpret=True)
    want = jax.grad(lambda s, ww: jnp.sum(render(rays, s, ww) * tgt), argnums=(0, 1))(
        ss, jnp.asarray(w))
    got = _grads(tp.make_fused_renderer(tile=64, max_chunks=64), rays_t, ss_t, w, tgt)
    _assert_grads(got, want, (1e-5, 1e-5))


def test_fused_matches_record_path(scene):
    """grace_tpu's bounds against the record path: rtol 5e-4 / atol 1e-2
    forward; weights 1e-4 x max (the same math), spheres 1e-2 x max (the
    table interpolant's derivative against the fit's)."""
    (ss, tree, rays), (ss_t, rays_t), w, tgt = scene
    tree_t = convert.tree_from_numpy(
        *(np.asarray(x) for x in (tree.children, tree.child_aabbs, tree.leaves, tree.root,
                                  tree.n_nodes, tree.n_leaves)),
        tree.max_per_leaf, device="cpu")
    recs = tr.find_hits(rays_t, ss_t, tree_t, 1 << 15)
    render = tp.make_fused_renderer(tile=64, max_chunks=64)
    ones = np.ones(N, np.float32)
    img = render(rays_t, ss_t, torch.tensor(ones)).numpy()
    ref = tr.integrate_hits(recs, rays_t, ss_t, rays_t.n_rays, weights=torch.tensor(ones))
    np.testing.assert_allclose(img, ref.numpy(), rtol=5e-4, atol=1e-2)
    assert (img > 0).sum() > 100
    want = _grads(lambda r, s, ww: tr.integrate_hits(recs, r, s, r.n_rays, weights=ww),
                  rays_t, ss_t, ones, tgt)
    got = _grads(render, rays_t, ss_t, ones, tgt)
    _assert_grads(got, want, (1e-2, 1e-4))


def test_fused_renderer_overflow_is_reported(scene):
    _, (ss_t, rays_t), w, _ = scene
    wt = torch.tensor(w)
    _, ovf = tp.make_fused_renderer(tile=64, max_chunks=1, return_overflow=True)(
        rays_t, ss_t, wt)
    assert bool(ovf) and not ovf.requires_grad
    roomy = tp.make_fused_renderer(tile=64, max_chunks=64, return_overflow=True)
    _, ovf_ok = roomy(rays_t, ss_t, wt)
    assert not bool(ovf_ok)

    def grads(render, pick):
        s = ss_t.clone().requires_grad_(True)
        ww = wt.clone().requires_grad_(True)
        pick(render(rays_t, s, ww)).sum().backward()
        return s.grad, ww.grad

    gs, gw = grads(tp.make_fused_renderer(tile=64, max_chunks=64, max_tiles_per_seg=1),
                   lambda v: v)
    assert not bool(torch.isfinite(gs).all()) and not bool(torch.isfinite(gw).all())
    gs, gw = grads(roomy, lambda v: v[0])
    assert bool(torch.isfinite(gs).all()) and bool(torch.isfinite(gw).all())


def test_fused_renderer_finite_difference(scene):
    """Directional central differences of the autograd.Function, for the
    spheres and for the weights. The loss is O(1) and summed in f64, so the
    f32 rounding of the image (about 3e-4 in these differences) sits far
    below the checked derivatives; the loss is quadratic in the weights,
    so their difference takes a 10x larger step."""
    _, (ss_t, rays_t), w, tgt = scene
    render = tp.make_fused_renderer(tile=64, max_chunks=64)
    tgt64 = torch.tensor(tgt, dtype=torch.float64)
    loss = lambda s, ww: ((render(rays_t, s, ww).double() * 1e-3 - tgt64) ** 2).mean()
    s = ss_t.clone().requires_grad_(True)
    ww = torch.tensor(w, requires_grad=True)
    loss(s, ww).backward()
    rng = np.random.default_rng(7)
    checks = (("spheres", ss_t, s.grad, 1e-3, 1e-2, lambda x: loss(x, torch.tensor(w))),
              ("weights", torch.tensor(w), ww.grad, 1e-2, 1e-3, lambda x: loss(ss_t, x)))
    for which, x0, g, eps, floor, at in checks:
        checked = 0
        for _ in range(4):
            d = torch.tensor(rng.standard_normal(tuple(x0.shape)))
            d /= d.norm()
            with torch.no_grad():
                fd = (float(at((x0.double() + eps * d).float()))
                      - float(at((x0.double() - eps * d).float()))) / (2 * eps)
            gd = float((g.double() * d).sum())
            if abs(gd) < floor:
                continue
            np.testing.assert_allclose(gd, fd, rtol=2e-2, err_msg=which)
            checked += 1
        assert checked >= 2, which


def test_weights_none_and_ray_rules(scene):
    """weights=None renders with unit weights and returns no weight
    gradient; the forward needs whole ray tiles and the backward whole
    128-ray tiles (ValueError otherwise), as grace_tpu asserts."""
    _, (ss_t, rays_t), _, tgt = scene
    render = tp.make_fused_renderer(tile=64, max_chunks=64)
    s1 = ss_t.clone().requires_grad_(True)
    (render(rays_t, s1, None) * torch.tensor(tgt)).sum().backward()
    s2 = ss_t.clone().requires_grad_(True)
    ones = torch.ones(N, requires_grad=True)
    (render(rays_t, s2, ones) * torch.tensor(tgt)).sum().backward()
    assert torch.equal(s1.grad, s2.grad)
    with pytest.raises(ValueError, match="multiple of the tile"):
        render(rays_t[:1000], ss_t, None)
    short = rays_t[:960]                     # whole 64-ray tiles, not 128
    values = render(short, ss_t.clone().requires_grad_(True), None)
    with pytest.raises(ValueError, match="multiple of the tile"):
        values.sum().backward()


def test_poly_constants_layout():
    """The kernels read the fast fit's constants at fixed offsets
    (csrc/poly_fast.cuh): 6 domain constants, then c1 (9), c2 (7), d1 (8),
    d2 (6), equal to grace_tpu's fit as f32."""
    import grace_tpu.sph.kernel_integrals as jk

    pack = tp._poly_tensor("cpu").numpy()
    c1, c2 = jk._CHEB1_SHORT, jk._CHEB2_SHORT
    cheb = np.polynomial.chebyshev
    parts = [c1, c2, cheb.chebder(c1), cheb.chebder(c2)]
    assert pack.shape == (6 + sum(len(p) for p in parts),) == (36,)
    assert np.array_equal(pack[6:], np.concatenate(parts).astype(np.float32))
    (lo1, hi1), (lo2, hi2) = jk._CHEB1_DOM, jk._CHEB2_DOM
    assert np.array_equal(pack[:6], np.float32([lo1 + hi1, 1 / np.float32(hi1 - lo1),
                                                2 / (hi1 - lo1), lo2 + hi2,
                                                1 / np.float32(hi2 - lo2), 2 / (hi2 - lo2)]))
