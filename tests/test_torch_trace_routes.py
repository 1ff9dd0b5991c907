"""grace_tpu_torch's broadphase lists and bitmask trace route against
grace_tpu's.

Rows 1-4 of the port: set-bit compaction, quarter and segment lists, the
BVH tile walk and its segment lists, all bit-exact. Then the default
bitmask route (dense/bitmask, resident and ``vmem_resident_limit=0``,
precomputed ``masks``) in both modes, and every ValueError contract of
``pallas_trace_sph``, on a 2500-particle clustered scene with 25x25
sorted ortho rays (625: no tile multiple; some tiles overlap nothing). On
the CPU the port's wrappers run the kernels' plain PyTorch versions;
grace_tpu's Pallas kernels run in interpret mode. Hit counts are exact;
column densities agree within rtol 1e-5, atol 1e-6 x max (the same f32
terms summed in another order). The list routes are in
test_torch_trace_lists.py; the CUDA kernels are held against the plain
versions on a card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grace_tpu.trace.broadphase as jbp
import grace_tpu.trace.pallas_broadphase as jpb
import grace_tpu.trace.pallas_kernel as jpk
from grace_tpu.core.types import Rays as JRays
import grace_tpu_torch.trace.broadphase as tbp
import grace_tpu_torch.trace.pallas_broadphase as tpb
import grace_tpu_torch.trace.pallas_kernel as tpk
from tests.helper.torch_parity import (  # noqa: F401 (autouse fixture)
    assert_trace_match, clustered_scene, one_torch_thread)


@pytest.fixture(scope="module")
def scene():
    return clustered_scene(2500, 11, 25, 25, 1.6)


def _padded(scene, tile):
    """Both packages' rays padded to whole tiles (the port's padding)."""
    rt = tpk._pad_rays(scene[1][2], tile)
    return JRays.from_arrays(*(x.numpy() for x in (rt.origins, rt.directions, rt.lengths))), rt


def test_popcount32_exact():
    rng = np.random.default_rng(3)
    w = rng.integers(-2**31, 2**31, size=4096, dtype=np.int64).astype(np.int32)
    w[:4] = [0, -1, -2**31, 2**31 - 1]
    assert np.array_equal(np.asarray(jax.jit(jpb._popcount32)(w)),
                          tpb._popcount32(torch.from_numpy(w)).numpy())


@pytest.mark.parametrize("max_q", [64, 1, 2240])
def test_compact_mask_words_exhaustive(rng, max_q):
    """The words of grace_tpu's own exhaustive test (random sparse and
    sign-bit words, an empty tile, a row of exactly 64 bits)."""
    T, W = 9, 70
    words = np.zeros((T, W), np.int32)
    for t in range(1, T):
        nset = int(rng.integers(0, 80)) if t < T - 1 else 64
        for q in rng.choice(W * 32, size=nset, replace=False):
            words[t, q // 32] |= np.int32(np.uint32(1 << (q % 32)))
    want = [np.asarray(x) for x in
            jax.jit(lambda w: jpb.compact_mask_words(w, max_q))(jnp.asarray(words))]
    got = [x.numpy() for x in tpb.compact_mask_words(torch.from_numpy(words), max_q, rows=4)]
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and np.array_equal(w, g)
    ids, n_q, ovf = got
    for t in range(T):
        bits = np.unpackbits(words[t].astype(np.uint32).view(np.uint8), bitorder="little")
        exp = np.nonzero(bits)[0]
        assert ovf[t] == (len(exp) > max_q) and n_q[t] == min(len(exp), max_q)
        assert np.array_equal(ids[t, :n_q[t]], exp[:max_q]) and not ids[t, n_q[t]:].any()


@pytest.mark.parametrize("tile", [32, 64])
@pytest.mark.parametrize("cap", [8, 256])
def test_quarter_lists_and_dense_tile_segments_exact(scene, tile, cap):
    jr, tr = _padded(scene, tile)
    ss, ss_t = scene[0][0], scene[1][0]
    for j, t in ((jpb.quarter_lists(jr, ss, tile, max_q=cap),
                  tpb.quarter_lists(tr, ss_t, tile, max_q=cap)),
                 (jpb.dense_tile_segments(jr, ss, tile, cap),
                  tpb.dense_tile_segments(tr, ss_t, tile, cap))):
        for a, b in zip(j, t):
            assert np.array_equal(np.asarray(a), b.numpy())
        assert bool(t[2].any()) == (cap == 8)


@pytest.mark.parametrize("tile,max_chunks,stack_size", [
    (64, 256, 128), (32, 16, 128), (64, 64, 10), (32, 8, 10)])
def test_tile_walk_exact(scene, tile, max_chunks, stack_size):
    """collect_tile_chunks (all four fields) and tile_segments, with and
    without a truncating chunk capacity and with a small stack."""
    jr, tr = _padded(scene, tile)
    (ss, tree, _), (ss_t, tree_t, _) = scene
    cj = jbp.collect_tile_chunks(jr, tree, tile, max_chunks, stack_size)
    ct = tbp.collect_tile_chunks(tr, tree_t, tile, max_chunks, stack_size)
    assert ct._fields == cj._fields
    for a, b in zip(cj, ct):
        assert np.array_equal(np.asarray(a), b.numpy())
    sj = jpk.tile_segments(jr, tree, tile, max_chunks, ss.shape[0], stack_size)
    st = tpk.tile_segments(tr, tree_t, tile, max_chunks, ss.shape[0], stack_size)
    for a, b in zip(sj, st):
        assert np.array_equal(np.asarray(a), b.numpy())
    if max_chunks <= 16:
        assert bool(st[2].any())


def _both(scene, **kw):
    (ss, tree, rays), (ss_t, tree_t, rays_t) = scene
    vj, oj = jpk.pallas_trace_sph(rays, ss, tree, interpret=True, **kw)
    vt, ot = tpk.pallas_trace_sph(rays_t, ss_t, tree_t, **kw)
    return np.asarray(vj), np.asarray(oj), vt, ot


# (broadphase, mode, integral_deg, tile, extra kwargs). grace_tpu's
# streaming kernel (vmem_resident_limit=0) ignores integral_deg (ROADMAP
# C1), so those cases use the default degree.
CASES = [
    ("dense", "hitcount", 14, 64, {}),
    ("dense", "cumulative", 14, 32, {}),
    ("bitmask", "cumulative", -10, 64, {}),
    ("bitmask", "cumulative", 8, 32, dict(subtiles=2)),   # still the bitmask route
    ("dense", "hitcount", 14, 64, dict(vmem_resident_limit=0)),
    ("bitmask", "cumulative", 14, 32, dict(vmem_resident_limit=0)),
]


@pytest.mark.parametrize("bp,mode,deg,tile,kw", CASES)
def test_route_matches_grace_tpu(scene, bp, mode, deg, tile, kw):
    vj, oj, vt, ot = _both(scene, broadphase=bp, mode=mode, integral_deg=deg,
                           tile=tile, **kw)
    assert ot.dtype == torch.bool and np.array_equal(oj, ot.numpy())
    if kw.get("max_chunks", 2048) <= 12:
        assert oj.any(), "the small list capacity must overflow on this scene"
    assert_trace_match(vj, vt, mode)


@pytest.mark.parametrize("mode", ["hitcount", "cumulative"])
def test_precomputed_masks(scene, mode):
    """Supplied words are the ones traced: tile 0's row is cleared, so its
    rays come out 0 in both packages."""
    (ss, tree, rays), (ss_t, tree_t, rays_t) = scene
    tile = 64
    mt = tpb.dense_tile_masks(tpk._pad_rays(rays_t, tile), ss_t, tile)
    mt[0] = 0
    mj = jnp.asarray(mt.numpy())
    vj, oj = jpk.pallas_trace_sph(rays, ss, tree, tile=tile, mode=mode, masks=mj,
                                  interpret=True)
    vt, ot = tpk.pallas_trace_sph(rays_t, ss_t, tile=tile, mode=mode, masks=mt)
    assert_trace_match(np.asarray(vj), vt, mode)
    assert not ot.any() and not vt[:tile].any()
    with pytest.raises(ValueError, match="tiles"):
        tpk.pallas_trace_sph(rays_t, ss_t, tile=tile, masks=mt[1:])
    with pytest.raises(ValueError, match="tiles"):
        jpk.pallas_trace_sph(rays, ss, tile=tile, masks=mj[1:], interpret=True)
    with pytest.raises(ValueError, match="words per tile"):
        tpk.pallas_trace_sph(rays_t, ss_t, tile=tile, masks=mt[:, 1:])


@pytest.mark.parametrize("bp", ["dense", "list"])
def test_streaming_route_honours_integral_deg(scene, bp):
    """ROADMAP C1: grace_tpu's streaming kernels drop integral_deg; the
    port honours it, so its vmem_resident_limit=0 result equals its
    resident one and grace_tpu's streaming result differs."""
    (ss, tree, rays), (ss_t, tree_t, rays_t) = scene
    kw = dict(broadphase=bp, tile=64, integral_deg=-12)
    stream_t, _ = tpk.pallas_trace_sph(rays_t, ss_t, vmem_resident_limit=0, **kw)
    res_t, _ = tpk.pallas_trace_sph(rays_t, ss_t, **kw)
    assert torch.equal(stream_t, res_t)
    stream_j, _ = jpk.pallas_trace_sph(rays, ss, vmem_resident_limit=0, interpret=True, **kw)
    stream_j = np.asarray(stream_j)
    assert np.abs(stream_t.numpy() - stream_j).max() > 1e-6 * np.abs(stream_j).max()


@pytest.mark.parametrize("case", ["qlist_not_resident", "qlist_max_chunks",
                                  "subtiles_not_resident", "subtiles_partial_group",
                                  "xla_without_tree"])
def test_value_errors_match_grace_tpu(scene, case):
    (ss, tree, rays), (ss_t, tree_t, rays_t) = scene
    kw, match = {
        "qlist_not_resident": (dict(broadphase="qlist", vmem_resident_limit=-1), "qlist"),
        "qlist_max_chunks": (dict(broadphase="qlist", max_chunks=6), "multiple of 4"),
        "subtiles_not_resident": (dict(subtiles=2, vmem_resident_limit=0), "subtiles"),
        "subtiles_partial_group": (dict(subtiles=3), "subtile groups"),
        "xla_without_tree": (dict(broadphase="xla"), "requires a tree"),
    }[case]
    kw = dict(tile=64, max_chunks=64) | kw
    with pytest.raises(ValueError, match=match):
        tpk.pallas_trace_sph(rays_t, ss_t, None if case == "xla_without_tree" else tree_t,
                             **kw)
    with pytest.raises(ValueError, match=match):
        jpk.pallas_trace_sph(rays, ss, None if case == "xla_without_tree" else tree,
                             interpret=True, **kw)
