"""grace_tpu_torch's record-based differentiable render against grace_tpu.

Both packages get the same scene (800 particles Morton-sorted by
grace_tpu, 32x32 plane-parallel rays made by grace_tpu's generator and
carried across as arrays). The hit records are bit-exact, overflowed
capacity included. ``integrate_hits`` matches grace_tpu's compiled form
to rtol 1e-6 (the same fused multiply-adds); its gradients, taken by
autograd through ``index_add``, match ``jax.grad`` within 1e-5 x max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grace_tpu.trace.render as jr
from grace_tpu.build.sph import build_sph_tree as j_build
from grace_tpu.core.types import make_spheres
from grace_tpu.rays.gen import plane_parallel_random_rays
import grace_tpu_torch as gtt
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
    tree_t = convert.tree_from_numpy(
        *(np.asarray(x) for x in (tree.children, tree.child_aabbs, tree.leaves, tree.root,
                                  tree.n_nodes, tree.n_leaves)),
        tree.max_per_leaf, device="cpu")
    rays_t = convert.rays_from_numpy(
        *(np.asarray(x) for x in (rays.origins, rays.directions, rays.lengths)), device="cpu")
    w = (0.5 + rng.random(N)).astype(np.float32)
    tgt = np.asarray(jax.random.normal(jax.random.key(1), (rays.n_rays,)))
    return ((ss, tree, rays), (convert.spheres_from_numpy(ss, device="cpu"), tree_t, rays_t),
            w, tgt)


@pytest.fixture(scope="module")
def records(scene):
    (ss, tree, rays), (ss_t, tree_t, rays_t), _, _ = scene
    return jr.find_hits(rays, ss, tree, 1 << 15), tr.find_hits(rays_t, ss_t, tree_t, 1 << 15)


def _assert_records_equal(j, t):
    for f, a, b in zip(jr.HitRecords._fields, j, t):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape) and np.array_equal(a, b.numpy()), f


def test_find_hits_records_exact(records):
    j, t = records
    assert int(t.total_hits) > 5000 and bool(t.valid.sum() == t.total_hits)
    _assert_records_equal(j, t)


def test_find_hits_overflow_exact(scene):
    """Records past the capacity are dropped the same way; total_hits
    still counts every hit."""
    (ss, tree, rays), (ss_t, tree_t, rays_t), _, _ = scene
    j = jr.find_hits(rays, ss, tree, 1000, stack_size=32)
    t = tr.find_hits(rays_t, ss_t, tree_t, 1000, stack_size=32)
    assert int(t.total_hits) > 1000 and bool(t.valid.all())
    _assert_records_equal(j, t)


@pytest.mark.parametrize("weighted", [False, True])
def test_integrate_hits_forward(scene, records, weighted):
    (ss, _, rays), (ss_t, _, rays_t), w, _ = scene
    rec_j, rec_t = records
    want = np.asarray(jax.jit(jr.integrate_hits, static_argnums=3)(
        rec_j, rays, ss, rays.n_rays, jnp.asarray(w) if weighted else None))
    got = tr.integrate_hits(rec_t, rays_t, ss_t, rays_t.n_rays,
                            torch.from_numpy(w) if weighted else None).numpy()
    assert (want > 0).sum() > 100
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _torch_grads(fn, ss_t, w, tgt):
    s = ss_t.clone().requires_grad_(True)
    ww = torch.tensor(w, requires_grad=True)
    (fn(s, ww) * torch.tensor(tgt)).sum().backward()
    return s.grad.numpy(), ww.grad.numpy()


def _assert_grads(got, want, rel=1e-5):
    for g, r in zip(got, want):
        r = np.asarray(r)
        assert np.isfinite(g).all() and np.abs(r).max() > 0
        np.testing.assert_allclose(g, r, rtol=0, atol=rel * np.abs(r).max())


def test_integrate_hits_gradients(scene, records):
    """Gradients for spheres and weights vs jax.grad of the same
    integration (the table lerp)."""
    (ss, _, rays), (ss_t, _, rays_t), w, tgt = scene
    rec_j, rec_t = records

    def loss_j(s, ww):
        return jnp.sum(jr.integrate_hits(rec_j, rays, s, rays.n_rays, ww) * tgt)

    want = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(ss, jnp.asarray(w))
    got = _torch_grads(lambda s, ww: tr.integrate_hits(rec_t, rays_t, s, rays_t.n_rays, ww),
                       ss_t, w, tgt)
    _assert_grads(got, want)


def test_closed_form_gradients_f64(scene, records):
    """The closed-form integral, the smooth option for gradient checks, in
    f64 as grace_tpu's own finite-difference test runs it: forward and
    gradients within 1e-10 x max (in f32 the form loses ~1e-3 to
    cancellation)."""
    (ss, _, rays), (ss_t, _, rays_t), w, tgt = scene
    rec_j, rec_t = records
    f64 = lambda a: np.asarray(a, np.float64)
    with jax.enable_x64(True):
        rays64 = type(rays)(*(jnp.asarray(f64(x)) for x in (rays.origins, rays.directions,
                                                            rays.lengths)))

        def loss_j(s, ww):
            img = jr.integrate_hits(rec_j, rays64, s, rays.n_rays, ww, use_closed_form=True)
            return jnp.sum(img * tgt), img

        (_, img_j), g_j = jax.value_and_grad(loss_j, argnums=(0, 1), has_aux=True)(
            jnp.asarray(f64(ss)), jnp.asarray(f64(w)))
        img_j, g_j = np.asarray(img_j), [np.asarray(g) for g in g_j]
    rays_t64 = type(rays_t)(*(x.double() for x in (rays_t.origins, rays_t.directions,
                                                   rays_t.lengths)))
    s = ss_t.double().requires_grad_(True)
    ww = torch.tensor(f64(w), requires_grad=True)
    img_t = tr.integrate_hits(rec_t, rays_t64, s, rays_t.n_rays, ww, use_closed_form=True)
    (img_t * torch.from_numpy(f64(tgt))).sum().backward()
    assert img_t.dtype == torch.float64
    np.testing.assert_allclose(img_t.detach().numpy(), img_j, rtol=0,
                               atol=1e-10 * np.abs(img_j).max())
    _assert_grads((s.grad.numpy(), ww.grad.numpy()), g_j, rel=1e-10)


def test_render_column_density(scene, records):
    """The end-to-end render (traversal, then integration): forward at
    rtol 1e-6 and gradients within 1e-5 x max of grace_tpu's."""
    (ss, tree, rays), (ss_t, tree_t, rays_t), w, tgt = scene
    want = np.asarray(jax.jit(jr.render_column_density, static_argnums=3)(
        rays, ss, tree, 1 << 15, jnp.asarray(w)))
    got = gtt.render_column_density(rays_t, ss_t, tree_t, 1 << 15, torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)

    def loss_j(s, ww):
        return jnp.sum(jr.integrate_hits(records[0], rays, s, rays.n_rays, ww) * tgt)

    want_g = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(ss, jnp.asarray(w))
    got_g = _torch_grads(lambda s, ww: gtt.render_column_density(
        rays_t, s, tree_t, 1 << 15, ww), ss_t, w, tgt)
    _assert_grads(got_g, want_g)
