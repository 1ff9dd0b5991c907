"""grace_tpu_torch.ops.segops against grace_tpu.ops.segops on the CPU.

Same inputs from a numpy seed through both packages. Segment ids, sort
orders and every integer result must match exactly, ties included (both
sorts are stable; -0.0 and +0.0 tie). The segmented scans sum f32 values in
another order than ``jax.lax.associative_scan``: within rtol 1e-6 of it
(measured: 2.4e-7 at most).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grace_tpu.ops.segops as js
import grace_tpu_torch.ops.segops as ts

# 7 segments over 40 elements, three of them empty (repeated offsets)
OFFSETS = np.array([0, 3, 3, 10, 17, 17, 17, 25], np.int32)[:7]
N = 40


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _eq(got, want):
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype, (got.dtype, want.dtype)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("offsets", [OFFSETS, np.array([0], np.int32),
                                     np.array([0, 0, 40, 40], np.int32)])
def test_offsets_to_segments(offsets):
    _eq(ts.offsets_to_segments(_t(offsets), N), js.offsets_to_segments(offsets, N))


def test_sorts_with_ties():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 6, N).astype(np.float32)
    keys[[1, 5, 9]] = -0.0          # tie with +0.0 keys
    vals = rng.random(N).astype(np.float32)
    idx = np.arange(N, dtype=np.int32)
    got, want = ts.sort_and_map(_t(keys)), js.sort_and_map(jnp.asarray(keys))
    for g, w in zip(got, want):
        _eq(g, w)
    got = ts.sort_by_key(_t(keys), _t(vals), _t(idx))
    want = js.sort_by_key(jnp.asarray(keys), vals, idx)
    for g, w in zip(got, want):
        _eq(g, w)
    order = rng.permutation(N).astype(np.int32)
    _eq(ts.order_by_index(_t(order), _t(vals)), js.order_by_index(order, vals))


def test_segmented_sort_keeps_segments_and_ties():
    rng = np.random.default_rng(1)
    seg = np.sort(rng.integers(0, 5, N)).astype(np.int32)
    seg = seg[rng.permutation(N)]                     # segments interleaved
    keys = rng.integers(0, 4, N).astype(np.float32)   # many tied keys
    p1 = np.arange(N, dtype=np.int32)
    p2 = rng.random(N).astype(np.float32)
    got = ts.segmented_sort(_t(seg), _t(keys), _t(p1), _t(p2))
    want = js.segmented_sort(seg, keys, p1, p2)
    for g, w in zip(got, want):
        _eq(g, w)
    _eq(ts.segmented_sort(_t(seg), _t(keys)), js.segmented_sort(seg, keys))


@pytest.mark.parametrize("total_hits", [None, 31, 0])
def test_sort_by_distance_with_capacity_padding(total_hits):
    """Entries past total_hits form their own trailing segment: they never
    mix into the last ray's segment."""
    rng = np.random.default_rng(2)
    dist = rng.integers(0, 8, N).astype(np.float32)   # tied distances
    idx = np.arange(N, dtype=np.int32)
    data = rng.random(N).astype(np.float32)
    got = ts.sort_by_distance(_t(dist), _t(OFFSETS), _t(idx), _t(data),
                              total_hits=total_hits)
    want = js.sort_by_distance(jnp.asarray(dist), OFFSETS, jnp.asarray(idx),
                               jnp.asarray(data), total_hits=total_hits)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("offsets", [OFFSETS, np.array([0, 0, 40, 40], np.int32)])
def test_exclusive_segmented_scans(offsets):
    rng = np.random.default_rng(3)
    vals = (rng.random(N) * 10).astype(np.float32)
    want = np.asarray(js.exclusive_segmented_scan(offsets, vals))
    got = ts.exclusive_segmented_scan(_t(offsets), _t(vals)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    heads = np.zeros(N, bool)
    heads[offsets[offsets < N]] = True
    assert np.all(got[heads] == 0.0)
    wmap = rng.integers(0, 6, N).astype(np.int32)
    w = rng.random(6).astype(np.float32)
    want = np.asarray(js.weighted_exclusive_segmented_scan(offsets, vals, wmap, w))
    got = ts.weighted_exclusive_segmented_scan(_t(offsets), _t(vals), _t(wmap), _t(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_segment_sums_drop_out_of_range_ids():
    rng = np.random.default_rng(4)
    ids = rng.integers(-1, 9, N).astype(np.int32)    # -1 and 7, 8 fall outside 7 segments
    vals = rng.random(N).astype(np.float32)
    want = np.asarray(jax.jit(js.segment_sums, static_argnums=2)(ids, vals, 7))
    got = ts.segment_sums(_t(ids), _t(vals), 7).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
