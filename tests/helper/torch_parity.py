"""Shared inputs and checks of the grace_tpu_torch trace parity tests.

``clustered_scene`` builds one scene for both packages from a numpy seed:
clustered particles Morton-sorted by grace_tpu, its tree, and sorted
orthographic rays, each also converted to the port's types.
``one_torch_thread`` is an autouse fixture for the modules that import it.
"""

import jax
import numpy as np
import pytest
import torch

from grace_tpu.build.sph import build_sph_tree as j_build
from grace_tpu.rays.gen import orthographic_projection_rays, spatial_sort_rays
from grace_tpu_torch import convert

CAM = (0.5, 0.5, -2.0)
LOOK = (0.5, 0.5, 0.5)
UP = (0.0, 1.0, 0.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the module's PyTorch ops on one thread. The suite runs several
    pytest workers on shared cores; with an intra-op pool in each, every
    parallel op waits for descheduled threads (~20 ms an op, measured),
    while these tensors are small enough for one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def clustered_scene(n, seed, nx, ny, extent, max_per_leaf=16):
    """((spheres, tree, rays) of grace_tpu, (spheres, tree, rays) of the
    port): ``n`` clustered particles from ``seed``, ``nx`` x ``ny`` ortho
    rays over ``extent``, sorted."""
    from bench import make_clustered_particles

    sp = make_clustered_particles(np.random.default_rng(seed), n)
    ss, tree, _ = jax.jit(j_build, static_argnums=1)(sp, max_per_leaf)
    rays = orthographic_projection_rays(nx, ny, CAM, LOOK, UP, extent, 6.0)
    rays_s, _, _ = jax.jit(spatial_sort_rays)(rays)
    arrs = [np.asarray(x) for x in (rays_s.origins, rays_s.directions, rays_s.lengths)]
    tree_t = convert.tree_from_numpy(
        *(np.asarray(x) for x in (tree.children, tree.child_aabbs, tree.leaves,
                                  tree.root, tree.n_nodes, tree.n_leaves)),
        tree.max_per_leaf, device="cpu")
    return (ss, tree, rays_s), (convert.spheres_from_numpy(ss, device="cpu"), tree_t,
                                convert.rays_from_numpy(*arrs, device="cpu"))


def assert_trace_match(want, got, mode):
    """Hit counts exact; column densities within rtol 1e-5, atol 1e-6 x
    max (the same f32 terms summed in another order)."""
    want = np.asarray(want)
    assert got.shape == want.shape
    if mode == "hitcount":
        assert got.dtype == torch.int32 and want.sum() > 0
        assert np.array_equal(want, got.numpy())
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
