"""The column-density render slice end to end, on the CPU.

The bench pipeline (build_sph_tree -> orthographic rays + spatial sort ->
bucket_prims_ortho -> splat_image, gated against the quarter trace) at a
small size: 2000 clustered particles and a 128x128 image with 32x128 splat
tiles. Each package runs its own pipeline from the same particles. The
port's image is within 1e-4 x max of grace_tpu's, and inside the port the
splat image meets the bench's 1e-3 gate against the fused trace.
"""

import jax
import numpy as np
import pytest
import torch

import grace_tpu.build.sph as jb
import grace_tpu.trace.splat as js
import grace_tpu_torch.build.sph as tb
import grace_tpu_torch.rays.gen as tg
import grace_tpu_torch.trace.pallas_kernel as tk
import grace_tpu_torch.trace.splat as ts

CAM = (0.5, 0.5, -2.0)
LOOK = (0.5, 0.5, 0.5)
UP = (0.0, 1.0, 0.0)
VEXT = 1.2
LENGTH = 6.0
SIDE = 128
SPLAT = dict(tile_w=32, tile_h=128)


@pytest.fixture(scope="module")
def particles():
    from bench import make_clustered_particles

    return make_clustered_particles(np.random.default_rng(2026), 2000)


@pytest.fixture(scope="module")
def port_render(particles):
    ss, tree, _ = tb.build_sph_tree(torch.from_numpy(particles), 32)
    rays = tg.orthographic_projection_rays(SIDE, SIDE, CAM, LOOK, UP, VEXT, LENGTH,
                                      device="cpu")
    rays_s, _, inv = tg.spatial_sort_rays(rays)
    buckets = ts.bucket_prims_ortho(ss, CAM, LOOK, UP, VEXT, LENGTH, SIDE, SIDE,
                                    chunk=512, band=32, **SPLAT)
    assert not bool(buckets.overflow)
    img = ts.splat_image(buckets, basis="deg8", **SPLAT)
    trace, ovf = tk.pallas_trace_sph(rays_s, ss, tree, tile=128, broadphase="quarter")
    assert not bool(ovf.any())
    return img.numpy(), trace[inv.long()].reshape(SIDE, SIDE).numpy()


def test_port_image_matches_grace_tpu(particles, port_render):
    ss, _, _ = jax.jit(jb.build_sph_tree, static_argnums=1)(particles, 32)
    buckets = js.bucket_prims_ortho(ss, CAM, LOOK, UP, VEXT, LENGTH, SIDE, SIDE,
                                    chunk=512, band=32, **SPLAT)
    want = np.asarray(js.splat_image(buckets, interpret=True, basis="deg8", **SPLAT))
    img, _ = port_render
    assert np.isfinite(img).all() and want.max() > 0
    assert np.abs(img - want).max() <= 1e-4 * want.max()


def test_splat_vs_trace_gate(port_render):
    img, img_trace = port_render
    assert np.isfinite(img_trace).all() and img_trace.max() > 0
    rel = np.abs(img - img_trace).max() / img_trace.max()
    assert rel < 1e-3, rel


@pytest.mark.parametrize("seed,n", [(2026, 5000), (7, 3001)])
def test_chip_smoke_particles_equal_bench(seed, n):
    """chip_smoke.py keeps its own copy of bench.py's particle maker (the
    port imports nothing of the JAX package): the same draws, bit for bit."""
    import bench
    import chip_smoke

    want = bench.make_clustered_particles(np.random.default_rng(seed), n)
    got = chip_smoke.make_clustered_particles(np.random.default_rng(seed), n)
    assert got.dtype == want.dtype and np.array_equal(got, want)
