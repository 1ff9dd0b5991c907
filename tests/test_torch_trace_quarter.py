"""grace_tpu_torch quarter broadphase and fused trace against grace_tpu.

On the CPU the port's wrapper runs the kernel's plain PyTorch version;
grace_tpu's Pallas kernels run in interpret mode. Mask words and summaries
are bit-exact, hit counts exact, column densities within rtol 1e-5 (the
two sum the same f32 terms in different orders). The CUDA kernel itself is
held against the plain version on a card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import jax
import numpy as np
import pytest
import torch

import grace_tpu.trace.pallas_broadphase as jpb
import grace_tpu.trace.pallas_kernel as jpk
from grace_tpu.build.sph import build_sph_tree as j_build
from grace_tpu.core.types import Rays as JRays
from grace_tpu.rays.gen import orthographic_projection_rays, spatial_sort_rays
import grace_tpu_torch.trace.pallas_broadphase as tpb
import grace_tpu_torch.trace.pallas_kernel as tpk
from grace_tpu_torch import convert
from tests.helper.torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

CAM = (0.5, 0.5, -2.0)
LOOK = (0.5, 0.5, 0.5)
UP = (0.0, 1.0, 0.0)


@pytest.fixture(scope="module")
def scene():
    """1500 clustered particles (Morton-sorted by grace_tpu) and 41x39
    sorted ortho rays (1599: not a multiple of any tile used here); the
    wide view leaves some tiles without any overlapping quarter."""
    from bench import make_clustered_particles

    sp = make_clustered_particles(np.random.default_rng(11), 1500)
    ss, tree, _ = jax.jit(j_build, static_argnums=1)(sp, 16)
    rays = orthographic_projection_rays(41, 39, CAM, LOOK, UP, 2.4, 6.0)
    rays_s, _, _ = jax.jit(spatial_sort_rays)(rays)
    arrs = [np.asarray(x) for x in (rays_s.origins, rays_s.directions, rays_s.lengths)]
    return ss, tree, rays_s, convert.spheres_from_numpy(ss, device="cpu"), convert.rays_from_numpy(*arrs, device="cpu")


def _pad(rays, tile):
    pad = (-rays.n_rays) % tile
    o, d, ln = (np.asarray(x) for x in (rays.origins, rays.directions, rays.lengths))
    return JRays.from_arrays(np.concatenate([o, np.repeat(o[-1:], pad, 0)]),
                             np.concatenate([d, np.repeat(d[-1:], pad, 0)]),
                             np.concatenate([ln, np.full(pad, -1.0, np.float32)]))


@pytest.mark.parametrize("tile", [32, 64])
@pytest.mark.parametrize("seg_block", [32, 8192])
def test_quarter_masks_bit_exact(scene, tile, seg_block):
    ss, _, rays_s, ss_t, _ = scene
    jr = _pad(rays_s, tile)
    tr = convert.rays_from_numpy(*(np.asarray(x) for x in (jr.origins, jr.directions, jr.lengths)),
                                 device="cpu")
    wj, sj = jpb.dense_tile_masks_quarter(jr, ss, tile, seg_block=seg_block)
    wt, st = tpb.dense_tile_masks_quarter(tr, ss_t, tile, seg_block=seg_block)
    assert np.array_equal(np.asarray(wj), wt.numpy())
    assert np.array_equal(np.asarray(sj), st.numpy())
    if seg_block == 32:
        assert ss.shape[0] // 32 > seg_block            # several segment blocks
    assert bool((wt == 0).all(dim=1).any())             # an empty tile
    mj = jpb.dense_tile_masks(jr, ss, tile, seg_block=seg_block)
    assert np.array_equal(np.asarray(mj), tpb.dense_tile_masks(tr, ss_t, tile, seg_block).numpy())


def test_broadphase_pieces_exact():
    rng = np.random.default_rng(12)
    s = np.concatenate([rng.random((1000, 3)), 0.02 * rng.random((1000, 1))], 1).astype(np.float32)
    for block in (32, 128):
        for j, t in zip(jpb.segment_aabbs(s, block), tpb.segment_aabbs(torch.from_numpy(s), block)):
            assert np.array_equal(np.asarray(j), t.numpy())
    ov = rng.random((7, 77)) < 0.3
    assert np.array_equal(np.asarray(jpb.pack_overlap_bits(ov)),
                          tpb.pack_overlap_bits(torch.from_numpy(ov)).numpy())


def test_pack_rays_and_prims_exact(scene):
    ss, _, rays_s, ss_t, rays_t = scene
    pj, nj = jpk._pack_prims(ss)
    pt, nt = tpk._pack_prims(ss_t)
    assert nj == nt and np.array_equal(np.asarray(pj), pt.numpy())
    rj, n1 = jpk._pack_rays(rays_s, 64)
    rt, n2 = tpk._pack_rays(rays_t, 64)
    assert n1 == n2 and np.array_equal(np.asarray(rj), rt.numpy())


CASES = [  # (mode, integral_deg, tile, vmem_resident_limit)
    ("hitcount", 14, 64, 48 << 20),
    ("cumulative", 14, 64, 48 << 20),
    ("cumulative", -10, 32, 48 << 20),
    ("hitcount", 14, 64, 0),          # grace_tpu: the HBM-streaming kernel
    ("cumulative", 14, 64, 0),
]


@pytest.mark.parametrize("mode,deg,tile,vmem", CASES)
def test_pallas_trace_sph_quarter(scene, mode, deg, tile, vmem):
    ss, tree, rays_s, ss_t, rays_t = scene
    vj, oj = jpk.pallas_trace_sph(rays_s, ss, tree, tile=tile, mode=mode, interpret=True,
                                  broadphase="quarter", integral_deg=deg,
                                  vmem_resident_limit=vmem)
    vt, ot = tpk.pallas_trace_sph(rays_t, ss_t, None, tile=tile, mode=mode,
                                  broadphase="quarter", integral_deg=deg,
                                  vmem_resident_limit=vmem)
    vj = np.asarray(vj)
    assert vt.shape == (rays_t.n_rays,) and np.array_equal(np.asarray(oj), ot.numpy())
    if mode == "hitcount":
        assert vt.dtype == torch.int32 and vj.sum() > 0
        assert np.array_equal(vj, vt.numpy())
    else:
        np.testing.assert_allclose(vt.numpy(), vj, rtol=1e-5, atol=1e-6 * np.abs(vj).max())


def test_other_broadphases_not_ported(scene):
    """Every route is ported now: none raises NotImplementedError (each is
    held against grace_tpu by test_torch_trace_routes.py and
    test_torch_trace_lists.py); an unknown mode still raises ValueError."""
    _, tree, _, ss_t, rays_t = scene
    tree_t = convert.tree_from_numpy(
        *(np.asarray(x) for x in (tree.children, tree.child_aabbs, tree.leaves,
                                  tree.root, tree.n_nodes, tree.n_leaves)),
        tree.max_per_leaf, device="cpu")
    for bp in ("dense", "bitmask", "qlist", "xla", "list", "pallas"):
        values, overflow = tpk.pallas_trace_sph(rays_t, ss_t, tree_t, tile=128,
                                                broadphase=bp, max_chunks=64)
        assert values.shape == (rays_t.n_rays,) and overflow.shape == (13,)
    with pytest.raises(ValueError):
        tpk.pallas_trace_sph(rays_t, ss_t, broadphase="quarter", mode="closest")


def test_negative_vmem_limit_streams(scene):
    """A negative vmem_resident_limit is grace_tpu's streaming regime: the
    quarter route returns what grace_tpu's streaming kernel returns, and
    qlist raises grace_tpu's ValueError."""
    ss, tree, rays_s, ss_t, rays_t = scene
    vj, _ = jpk.pallas_trace_sph(rays_s, ss, tree, tile=64, mode="hitcount",
                                 interpret=True, broadphase="quarter",
                                 vmem_resident_limit=-1)
    vt, _ = tpk.pallas_trace_sph(rays_t, ss_t, tile=64, mode="hitcount",
                                 broadphase="quarter", vmem_resident_limit=-1)
    assert np.asarray(vj).sum() > 0 and np.array_equal(np.asarray(vj), vt.numpy())
    for pallas_trace_sph, s, r in ((jpk.pallas_trace_sph, ss, rays_s),
                                   (tpk.pallas_trace_sph, ss_t, rays_t)):
        with pytest.raises(ValueError, match="qlist"):
            pallas_trace_sph(r, s, tile=64, broadphase="qlist", vmem_resident_limit=-1)


def test_trace_quarter_rejects_mixed_devices(scene):
    _, _, _, ss_t, rays_t = scene
    words = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="several devices"):
        tpk.trace_quarter(words, words, torch.zeros((64, 16)),
                          torch.zeros((8, 128), device="meta"), 14, "cumulative")
    with pytest.raises(ValueError, match="unsupported device"):
        meta = lambda t: t.to("meta")
        tpk.trace_quarter(meta(words), meta(words), torch.zeros((64, 16), device="meta"),
                          torch.zeros((8, 128), device="meta"), 14, "cumulative")
    with pytest.raises(TypeError):
        tpk.trace_quarter(words, words, torch.zeros((64, 16), dtype=torch.float64),
                          torch.zeros((8, 128)), 14, "cumulative")

