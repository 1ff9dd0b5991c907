"""grace_tpu_torch's generic BVH engine and its pieces against grace_tpu.

Intersection tests and table interpolation are bit-exact against
``jax.jit`` of grace_tpu's (the port writes compiled XLA's fused
multiply-adds out). The engine's hit counts are exact and its column
densities within rtol 1e-5 (sums of the same f32 terms in another order),
on random scenes and on the driver entry's forward at its own shapes
(2048 spheres, 1024 rays): the port's build_sph_tree + trace_cumulative_sph
against ``jax.jit(entry()[0])``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grace_tpu.ops.interpolate as jinterp
import grace_tpu.ops.intersect as jix
import grace_tpu.trace.engine as jeng
import grace_tpu.trace.functors as jfun
import grace_tpu.trace.sph as jsph
from grace_tpu.build.sph import build_sph_tree as j_build
from grace_tpu.core.types import Rays as JRays
from grace_tpu.sph.kernel_integrals import DENSE_KERNEL_INTEGRAL_TABLE
import grace_tpu_torch.ops.interpolate as tinterp
import grace_tpu_torch.ops.intersect as tix
import grace_tpu_torch.trace.engine as teng
import grace_tpu_torch.trace.functors as tfun
import grace_tpu_torch.trace.sph as tsph
from grace_tpu_torch import convert
from grace_tpu_torch.build.sph import build_sph_tree as t_build
from grace_tpu_torch.core.types import Rays
from tests.helper.torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

T = torch.from_numpy


def _random_rays(rng, n, spread, origin, length):
    o = (origin + spread * (rng.random((n, 3)) - 0.5)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d, np.full(n, length, np.float32)


def test_sphere_hit_bit_exact():
    rng = np.random.default_rng(5)
    o, d, _ = _random_rays(rng, 50000, 1.0, 0.5, 1.0)
    ln = (3 * rng.random(50000)).astype(np.float32)
    s = np.concatenate([rng.random((50000, 3)), 0.3 * rng.random((50000, 1))], 1
                       ).astype(np.float32)
    want = jax.jit(jix.sphere_hit)(o, d, ln, s)
    got = tix.sphere_hit(T(o), T(d), T(ln), T(s))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
    assert 0 < int(got[0].sum()) < 50000


def test_aabbs_hit_and_inverse_direction_bit_exact():
    """Includes axis-aligned directions (+-0 components, infinite inverses)
    and origins on a slab plane (0 * inf = NaN in the slab test)."""
    rng = np.random.default_rng(6)
    n = 20000
    o, d, _ = _random_rays(rng, n, 1.0, 0.5, 1.0)
    d[:2000, 0] = 0.0
    d[2000:4000, 1] = -0.0
    d[4000:5000] = [0.0, 0.0, 1.0]
    mn = rng.random((n, 2, 3)).astype(np.float32)
    mx = mn + 0.3 * rng.random((n, 2, 3)).astype(np.float32)
    o[:500, 0] = mn[:500, 0, 0]
    ln = (2 * rng.random(n)).astype(np.float32)
    inv_j = np.asarray(jax.jit(jix.safe_inverse_direction)(d))
    inv_t = tix.safe_inverse_direction(T(d))
    assert np.array_equal(inv_j, inv_t.numpy()) and np.isinf(inv_j).any()
    want = jax.jit(jix.aabbs_hit)(o[:, None], inv_j[:, None], ln[:, None], mn, mx)
    got = tix.aabbs_hit(T(o)[:, None], inv_t[:, None], T(ln)[:, None], T(mn), T(mx))
    assert np.array_equal(np.asarray(want), got.numpy())
    assert 0 < int(got.sum()) < 2 * n


def test_lerp_and_sph_integral_bit_exact():
    rng = np.random.default_rng(7)
    table = np.asarray(DENSE_KERNEL_INTEGRAL_TABLE, np.float32)
    x = (rng.random(20000) * (table.shape[0] + 50)).astype(np.float32)
    x[:3] = [0.0, table.shape[0] - 1, table.shape[0] + 7.5]
    assert np.array_equal(np.asarray(jax.jit(jinterp.lerp)(x, table)),
                          tinterp.lerp(T(x), T(table)).numpy())
    b2 = (0.01 * rng.random(20000)).astype(np.float32)
    h = (0.02 + 0.1 * rng.random(20000)).astype(np.float32)
    want = np.asarray(jax.jit(jfun.sph_integral)(b2, h, table))
    assert np.array_equal(want, tfun.sph_integral(T(b2), T(h), T(table)).numpy())


@pytest.fixture(scope="module")
def scene():
    """3000 random spheres (the reference trace tests' sizes), 16 per
    leaf, and 600 rays from a box inside the cloud."""
    rng = np.random.default_rng(8)
    n = 3000
    s = np.concatenate([rng.random((n, 3)), 0.02 + 0.05 * rng.random((n, 1))], 1
                       ).astype(np.float32)
    ss, tree, _ = jax.jit(j_build, static_argnums=1)(s, 16)
    o, d, ln = _random_rays(rng, 600, 0.4, 0.5, 1.5)
    tree_t = convert.tree_from_numpy(
        *(np.asarray(x) for x in (tree.children, tree.child_aabbs, tree.leaves,
                                  tree.root, tree.n_nodes, tree.n_leaves)),
        tree.max_per_leaf, device="cpu")
    return (ss, tree, JRays.from_arrays(o, d, ln)), (
        convert.spheres_from_numpy(ss, device="cpu"), tree_t,
        Rays.from_arrays(o, d, ln, device="cpu"))


def test_hitcounts_exact(scene):
    (ss, tree, rays), (ss_t, tree_t, rays_t) = scene
    want = np.asarray(jsph.trace_hitcounts_sph(rays, ss, tree))
    got = tsph.trace_hitcounts_sph(rays_t, ss_t, tree_t)
    assert got.dtype == torch.int32 and want.sum() > 0
    assert np.array_equal(want, got.numpy())


@pytest.mark.parametrize("weighted", [False, True])
def test_cumulative_within_rtol(scene, weighted):
    (ss, tree, rays), (ss_t, tree_t, rays_t) = scene
    w = (0.5 + np.random.default_rng(9).random(ss.shape[0])).astype(np.float32)
    want = np.asarray(jsph.trace_cumulative_sph(
        rays, ss, tree, weights=jnp.asarray(w) if weighted else None))
    got = tsph.trace_cumulative_sph(rays_t, ss_t, tree_t,
                                    weights=T(w) if weighted else None)
    assert want.max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6 * want.max())


def test_engine_entry_exit_functors_and_bruteforce(scene):
    """ray_entry / ray_exit run around the walk; the brute-force oracle
    agrees with grace_tpu's and with the BVH walk."""
    (ss, tree, rays), (ss_t, tree_t, rays_t) = scene
    kw = lambda F: dict(intersect=F.intersect_sphere, on_hit=F.on_hit_count,
                        ray_entry=lambda c: c + 3, ray_exit=lambda c: c * 2)
    want, _ = jeng.trace(rays, tree, ss, jeng.TraceFunctors(**kw(jfun)),
                         jnp.zeros(rays.n_rays, jnp.int32))
    got, g = teng.trace(rays_t, tree_t, ss_t, teng.TraceFunctors(**kw(tfun)),
                        torch.zeros(rays_t.n_rays, dtype=torch.int32), global_init="g")
    assert g == "g" and np.array_equal(np.asarray(want), got.numpy())
    reduce = lambda init, hit, info, ids: init + hit.sum(-1)
    bj = jeng.trace_bruteforce(rays, ss, jfun.intersect_sphere,
                               lambda i, h, f, p: i + jnp.sum(h, -1), 0, chunk=256)
    bt = teng.trace_bruteforce(rays_t, ss_t, tfun.intersect_sphere, reduce, 0, chunk=256)
    assert np.array_equal(np.asarray(bj), bt.numpy())
    assert np.array_equal(bt.numpy() + 3, got.numpy() // 2)


def test_driver_entry_forward():
    """__graft_entry__.entry's forward (2048 spheres, 1024 rays) through
    the port, against jax.jit of grace_tpu's."""
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    want = np.asarray(jax.jit(fn)(*args))
    sp, o, d, ln = (torch.tensor(np.asarray(a)) for a in args)
    ss, tree, _ = t_build(sp, max_per_leaf=16)
    got = tsph.trace_cumulative_sph(Rays(o, d, ln), ss, tree)
    assert got.shape == want.shape and want.max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)
