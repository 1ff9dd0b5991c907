"""The pair cull of the trace kernels against grace_tpu's ``_seg_compute``.

The CUDA trace kernels (csrc/stage.cuh, csrc/seg_compute.cuh) evaluate a
pair's integral only where the ray runs along the particle and
u = b^2 / h^2 < 1 (hit counts: where b^2 < h^2), and skip every other
pair. That is right only if every term outside that support is exactly 0
in the reference. Here grace_tpu's ``_seg_compute`` (jitted) and the
port's plain ``_seg_compute`` see the same rays and particles, from a
numpy seed: clustered particles, orthographic rays, and particles placed
so that u lands within a few ulp of 1 on some rays, on both sides of it.
The terms agree within the route tests' tolerance, hit indicators exactly,
and outside the support every term is exactly 0 in both packages.

Also the kernels' launch orders: a permutation of the tiles, longest walk
first, ties in tile order, empty tiles last; the record wrappers take any
permutation and refuse anything else.
"""

import jax
import numpy as np
import pytest
import torch

import grace_tpu.trace.pallas_kernel as jpk
import grace_tpu_torch.trace.pallas_kernel as tpk
from chip_smoke import support_edge_scene
from tests.helper.torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def pairs():
    """(ray columns f32[R, 1] x 7, particle slab f32[8, N], bool[R, N]
    pairs at the edge of the support) of ``support_edge_scene``: 32x32
    ortho rays, 384 clustered particles, the last 128 each at b = h (1 + k
    ulp), k in [-4, 4], from one ray."""
    spheres, rays, near = support_edge_scene("cpu")
    packed, _ = tpk._pack_rays(rays, 1)
    prims, _ = tpk._pack_prims(spheres)
    return [packed[:, k:k + 1] for k in (0, 1, 2, 3, 4, 5, 9)], prims, near


def _support(cols, prims, mode):
    """Where a pair may contribute: along the ray and u < 1 (cumulative)
    or b^2 < h^2 (hitcount)."""
    b2, dot, *_ = tpk._impact(prims[0], prims[1], prims[2], *cols[:6])
    along = (dot >= 0.0) & (dot < cols[6])
    return along & ((b2 < prims[5]) if mode == "hitcount" else (b2 * prims[4] < 1.0)), b2


@pytest.mark.parametrize("mode,deg", [("hitcount", 14), ("cumulative", 14), ("cumulative", 8),
                                      ("cumulative", -10), ("cumulative", -12)])
def test_terms_vanish_outside_the_support(pairs, mode, deg):
    cols, prims, near = pairs
    want = np.asarray(jax.jit(lambda slab, *c: jpk._seg_compute(
        slab, *c, jax.numpy.zeros((c[0].shape[0], slab.shape[1]), jax.numpy.float32), mode,
        deg))(prims.numpy(), *(c.numpy() for c in cols)))
    got = tpk._seg_compute(*cols, prims[0], prims[1], prims[2], prims[4], prims[5], mode, deg)
    support, b2 = _support(cols, prims, mode)
    # the edge particles straddle u = 1 on their rays, within a few ulp
    u = (b2 * prims[4])[near]
    assert float((u - 1.0).abs().max()) < 1e-5
    assert bool((u < 1.0).any()) and bool((u >= 1.0).any())
    assert int(support.sum()) > 1000 and bool((~support).any())
    if mode == "hitcount":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    outside = ~support.numpy()
    assert not want[outside].any() and not got.numpy()[outside].any()
    # and inside, the edge pairs on the near side of u = 1 still add something
    if mode == "cumulative" and deg > 0:
        assert bool((got[near & support] != 0).all())


def _expected_order(lengths):
    return sorted(range(len(lengths)), key=lambda t: -lengths[t])  # stable


def test_bitmask_tile_order():
    """Rows of random words with random popcounts (ties, empty rows, sign
    bits): the order is the tiles by descending set bits, stable."""
    rng = np.random.default_rng(8)
    n_tiles, n_words = 40, 5
    words = np.zeros((n_tiles, n_words), np.int64)
    for t in range(n_tiles):
        for b in rng.choice(32 * n_words, rng.integers(0, 6), replace=False):
            words[t, b // 32] |= 1 << (b % 32)
    words[3, 4] |= 1 << 31
    words = (((words + 2**31) % 2**32) - 2**31).astype(np.int32)
    lengths = [sum(bin(int(w) & 0xFFFFFFFF).count("1") for w in row) for row in words]
    assert lengths.count(0) > 1 and len(set(lengths)) < n_tiles
    order = tpk.bitmask_tile_order(torch.from_numpy(words))
    assert order.dtype == torch.int32
    assert order.tolist() == _expected_order(lengths)
    assert sorted(order.tolist()) == list(range(n_tiles))
    assert all(lengths[t] == 0 for t in order.tolist()[-lengths.count(0):])


def test_row_set_bits_exact():
    """The order helpers' i32 popcount equals the i64 one (``_popcount32``,
    held against grace_tpu's) on random words and the edge words."""
    from grace_tpu_torch.trace.pallas_broadphase import _popcount32

    rng = np.random.default_rng(10)
    words = rng.integers(-2**31, 2**31, (300, 41), dtype=np.int64).astype(np.int32)
    words[0, :6] = [-2**31, -1, 0, 2**31 - 1, 1, -2]
    words[1] = -1
    w = torch.from_numpy(words)
    got = tpk._row_set_bits(w)
    assert got.dtype == torch.int32 and int(got[1]) == 41 * 32
    assert torch.equal(got, _popcount32(w).sum(dim=1))


def test_quarter_tile_order():
    """Rows of random quarter words (ties, empty rows, the sign bit set): a
    permutation of the tiles, by descending listed quarters, ties in tile
    order, empty tiles last."""
    rng = np.random.default_rng(9)
    n_tiles, n_words = 33, 3
    words = rng.integers(-2**31, 2**31, (n_tiles, n_words), dtype=np.int64)
    words &= rng.integers(-2**31, 2**31, (n_tiles, n_words), dtype=np.int64)  # sparser
    words[rng.choice(n_tiles, 6, replace=False)] = 0
    words[5] = words[9]                                                     # a tie
    words[7, 2] = -2**31
    words = words.astype(np.int32)
    lengths = [sum(bin(int(w) & 0xFFFFFFFF).count("1") for w in row) for row in words]
    assert lengths.count(0) >= 6 and len(set(lengths)) < n_tiles
    order = tpk.quarter_tile_order(torch.from_numpy(words))
    assert order.dtype == torch.int32
    assert order.tolist() == _expected_order(lengths)
    assert sorted(order.tolist()) == list(range(n_tiles))
    assert all(lengths[t] == 0 for t in order.tolist()[-lengths.count(0):])
    assert order.tolist().index(5) < order.tolist().index(9)


def test_record_wrappers_check_the_launch_order():
    """A record launch in another order than the wrappers' (longest row
    first) takes a permutation of the tiles and refuses anything else, and
    outputs of other shapes; on CPU tensors it is refused (the wrappers run
    the plain versions there, whose records no order changes)."""
    from grace_tpu_torch.trace import pallas_broadphase as tpb
    from grace_tpu_torch.trace import pallas_records as tpr

    spheres, rays, _ = support_edge_scene("cpu")
    rays = tpk._pad_rays(rays, 64)
    packed, _ = tpk._pack_rays(rays, 64)
    prims, _ = tpk._pack_prims(spheres)
    words, summary = tpb.dense_tile_masks_quarter(rays, spheres, 64)
    masks = tpb.dense_tile_masks(rays, spheres, 64)
    n_tiles = words.shape[0]
    for route, args in (("quarter", (summary, words, packed, prims)),
                        ("bitmask", (masks, packed, prims))):
        outs = tpr._outputs(packed, 128)
        assert [tuple(o.shape) for o in outs] == [(packed.shape[0],)] + [
            (packed.shape[0], 128)] * 3
        good = torch.arange(n_tiles, dtype=torch.int32).flip(0).contiguous()
        for bad in (good[:-1], good.long(), torch.zeros_like(good), good + 1):
            with pytest.raises(ValueError, match="order"):
                tpr._records_launch(route, args, bad, outs)
        with pytest.raises(ValueError, match="outputs"):
            tpr._records_launch(route, args, good, outs[::-1])
        wide = tpr._outputs(packed, 129)
        with pytest.raises(ValueError, match="outputs"):
            tpr._records_launch(route, args, good, outs[:1] + wide[1:2] + outs[2:])
        with pytest.raises(ValueError, match="CUDA tensors"):
            tpr._records_launch(route, args, good, outs)


def test_list_tile_order():
    """The segment-list order reads min(count, max_len) entries a tile:
    counts past max_len tie with max_len; negative counts are empty."""
    counts = torch.tensor([3, 0, 9, 12, 3, -2, 7, 8, 0, 1], dtype=torch.int32)
    order = tpk.list_tile_order(counts, 8)
    assert order.dtype == torch.int32
    assert order.tolist() == _expected_order([min(max(c, 0), 8) for c in counts.tolist()])
    assert order.tolist()[:3] == [2, 3, 7] and order.tolist()[-3:] == [1, 5, 8]
