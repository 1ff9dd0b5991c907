"""The footprint cull of the splat kernels against grace_tpu's factors.

The CUDA splat kernels (csrc/splat_common.cuh, used by csrc/splat.cu and
the forward of csrc/splat_sortfree.cu, and the backward of
csrc/splat_sortfree.cu) build a particle's factors only for the pixel
centres inside its footprint, d = (c - q) * invh with d * d < 1, and add
only those terms. They find that interval in closed form, widened
by a margin, then trimmed with the exact test; the port's
``support_interval`` does the same arithmetic on the CPU. That is right
only if (a) the widened interval contains every centre inside the
footprint, and (b) every term outside the footprint is exactly 0 in the
reference. Here (a) is checked on the splat edge scene, whose placed
particles put a pixel centre at d^2 within a few ulp of 1 on both sides
(for both splat paths' pixel centres) and whose largest footprints cover
whole patches, at the forward's patches and the backward's tiles, and (b)
on grace_tpu's factor (``grace_tpu.trace.splat`` ``_factor``, jitted), on
the sort-free plain path's factor expression, and on every factor of the
sort-free backward (``grace_tpu.trace.splat_grad._poly_and_deriv`` with
its kernel's in_x / in_y products, jitted), for the same particles and
centres.

Also the kernels' launch orders: a permutation of the keys (tiles), most
instances (listed segments, list entries read) first, ties in key order,
empty ones last.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grace_tpu.trace.splat as jsp
import grace_tpu.trace.splat_grad as jsg
import grace_tpu_torch.trace.pallas_kernel as tpk
import grace_tpu_torch.trace.pallas_render as tpr
import grace_tpu_torch.trace.splat as tsp
import grace_tpu_torch.trace.splat_grad as tsg
from chip_smoke import (CAM, LENGTH, LOOK, SORTFREE_BWD_EDGE_ROWS, UP, render_inputs,
                        splat_edge_scene, training_scene)
from grace_tpu_torch.rays.gen import orthographic_projection_rays, spatial_sort_rays
from grace_tpu_torch.ops.vecmath import fma
from grace_tpu_torch.sph.kernel_integrals import SPLAT_BASES
from tests.helper.torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

SIDE = 128
PATCH = 32


@pytest.fixture(scope="module")
def scene():
    """(pu, pv, invh f32[n], {path: {axis: centres f32[SIDE]}}): the edge
    scene's particles as both splat paths project them (the bench camera:
    pu = -x, pv = y, invh = 1 / h), and each path's pixel centres."""
    spheres = splat_edge_scene("cpu")
    b = tsp.bucket_prims_ortho(spheres, CAM, LOOK, UP, 4.0, LENGTH, SIDE, SIDE, tile_w=PATCH,
                               tile_h=128)
    cam = tsg.OrthoCamera(CAM, LOOK, UP, 4.0, LENGTH, SIDE, SIDE)
    pu, pv, invh, _ = tsg.project_ortho(spheres, None, cam)
    *_, x0, dx, y0, dy = tsg._camera_numerics(cam, "cpu")
    idx = torch.arange(SIDE, dtype=torch.float32)
    centres = {"bucketed": {"row": b.yrows[:, 0], "col": b.xcols[:, 0]},
               "sortfree": {"row": fma(idx, dy, y0), "col": fma(idx, dx, x0)}}
    return pu, pv, invh, centres


def _d2(centres, q, invh):
    d = (centres[None, :] - q[:, None]) * invh[:, None]
    return d * d


@pytest.mark.parametrize("axis", ["row", "col"])
@pytest.mark.parametrize("path", ["bucketed", "sortfree"])
def test_interval_holds_every_centre_in_the_footprint(scene, path, axis):
    pu, pv, invh, centres = scene
    q = pv if axis == "row" else pu
    c_all = centres[path][axis]
    d2_all = _d2(c_all, q, invh)
    # the placed particles straddle d^2 = 1 at a centre of this path
    near = (d2_all - 1.0).abs() < 1e-5
    assert bool((d2_all[near] < 1.0).any()) and bool((d2_all[near] >= 1.0).any())
    whole = 0
    for p0 in range(0, SIDE, PATCH):
        c = c_all[p0:p0 + PATCH]
        inside = _d2(c, q, invh) < 1.0                                    # [n, PATCH]
        (lo, hi), (lo_t, hi_t) = tsp.support_interval(c, q, invh)
        idx = torch.arange(PATCH)
        widened = (idx >= lo[:, None]) & (idx < hi[:, None])
        assert not bool((inside & ~widened).any()), "a centre in a footprint is cut off"
        # the trimmed interval is the footprint exactly ([0, 0) if empty)
        trimmed = (idx >= lo_t[:, None]) & (idx < hi_t[:, None])
        assert torch.equal(trimmed, inside)
        assert bool(((lo_t == 0) & (hi_t == 0))[~inside.any(dim=1)].all())
        # the widened interval stays near the footprint: 2 centres and the
        # magnitude margin past it on each side, and the rounding to whole
        # centres, at most
        span = inside.any(dim=1)
        assert bool((lo_t[span] - lo[span] <= 4).all()) and bool((hi[span] - hi_t[span] <= 4).all())
        whole += int(inside.all(dim=1).sum())
    assert whole > 0, "no footprint covers a whole patch"


@pytest.mark.parametrize("tile_w", SORTFREE_BWD_EDGE_ROWS)
def test_interval_holds_every_centre_at_the_backward_tiles(scene, tile_w):
    """The sort-free backward's tiles: tile_w rows by 128 columns of the
    sort-free centres; the interval holds every centre of each footprint
    and, trimmed, is the footprint exactly."""
    pu, pv, invh, centres = scene
    n_edge = 0
    for axis, q, size in (("row", pv, tile_w), ("col", pu, 128)):
        c_all = centres["sortfree"][axis]
        for p0 in range(0, SIDE, size):
            c = c_all[p0:p0 + size]
            inside = _d2(c, q, invh) < 1.0
            (lo, hi), (lo_t, hi_t) = tsp.support_interval(c, q, invh)
            idx = torch.arange(size)
            assert not bool((inside & ~((idx >= lo[:, None]) & (idx < hi[:, None]))).any())
            assert torch.equal((idx >= lo_t[:, None]) & (idx < hi_t[:, None]), inside)
            n_edge += int(((_d2(c, q, invh) - 1.0).abs() < 1e-5).sum())
    assert n_edge > 0, "no centre at d^2 within a few ulp of 1"


def test_interval_degenerate_centres():
    """One centre, or centres that do not advance: the interval starts
    from all of them and the exact test trims it."""
    q = torch.tensor([0.0, 0.5, 3.0], dtype=torch.float32)
    invh = torch.tensor([1.0, 1.0, 1.0], dtype=torch.float32)
    for c in (torch.tensor([0.25]), torch.full((4,), 0.25)):
        (lo, hi), (lo_t, hi_t) = tsp.support_interval(c, q, invh)
        assert lo.tolist() == [0] * 3 and hi.tolist() == [c.shape[0]] * 3
        assert lo_t.tolist() == [0, 0, 0] and hi_t.tolist() == [c.shape[0]] * 2 + [0]


@pytest.mark.parametrize("basis", ["deg8", "deg10"])
@pytest.mark.parametrize("path", ["bucketed", "sortfree"])
def test_terms_vanish_outside_the_footprint(scene, path, basis):
    """grace_tpu's factor, (1 - t) q(t) at t = min(d^2, 1), jitted, is
    exactly 0 at every centre outside a footprint and not 0 inside, for
    the bucketed path's factor and the sort-free path's expression; the
    port's factor agrees."""
    pu, pv, invh, centres = scene
    deg, a_c, b_c = SPLAT_BASES[basis]
    for axis, q, coeffs in (("row", pv, a_c), ("col", pu, b_c)):
        c = centres[path][axis]
        coeffs = np.asarray(coeffs, np.float32)
        args = (c.numpy()[None, :], q.numpy()[:, None], invh.numpy()[:, None])
        if path == "bucketed":
            d = (c[None, :] - q[:, None]) * invh[:, None]
            t = torch.clamp(d * d, max=1.0)
            want = jax.jit(lambda tt: jnp.stack(jsp._factor(tt, coeffs, deg)))(t.numpy())
        else:
            def sortfree_factor(cc, qq, ih):   # splat_grad._sortfree_fwd_kernel's terms
                ya = (cc - qq) * ih
                return jnp.stack(jsp._factor(jnp.minimum(ya * ya, 1.0), coeffs, deg))
            want = jax.jit(sortfree_factor)(*args)
        want = np.asarray(want)
        inside = (_d2(c, q, invh) < 1.0).numpy()
        assert int(inside.sum()) > 1000 and bool((~inside).any())
        assert not want[:, ~inside].any()
        assert want[:, inside].any(axis=0).all()
        got = tsp._factor(torch.clamp(_d2(c, q, invh), max=1.0), coeffs).numpy()
        assert not got[:, ~inside].any()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("basis", ["deg8", "deg10"])
def test_backward_terms_vanish_outside_the_footprint(scene, basis):
    """grace_tpu's sort-free backward factors, jitted: b_v, b_d dtx/dpu and
    b_d dtx/dlog(invh) of the columns, a_v, a_d dty/dpv and a_d
    dty/dlog(invh) of the rows (the derivative factors with the kernel's
    in_x / in_y), are exactly 0 at every centre outside a footprint, and
    the values are not 0 inside; so are the port's plain factors."""
    pu, pv, invh, centres = scene
    deg, a_c, b_c = SPLAT_BASES[basis]
    for axis, q, coeffs in (("row", pv, a_c), ("col", pu, b_c)):
        c = centres["sortfree"][axis]
        coeffs = np.asarray(coeffs, np.float32)

        def factors(cc, qq, ih):   # _sortfree_bwd_kernel's per-axis factors
            d = (cc - qq) * ih
            d2 = d * d
            inside = (d2 < 1.0).astype(jnp.float32)
            v, der = jsg._poly_and_deriv(jnp.minimum(d2, 1.0), coeffs, deg)
            dpos, dlog = (-2.0) * d * ih * inside, 2.0 * d2 * inside
            return (jnp.stack(v), jnp.stack([x * dpos for x in der]),
                    jnp.stack([x * dlog for x in der]))

        want = [np.asarray(f) for f in jax.jit(factors)(c.numpy()[None, :], q.numpy()[:, None],
                                                        invh.numpy()[:, None])]
        inside = (_d2(c, q, invh) < 1.0).numpy()
        assert int(inside.sum()) > 1000 and bool((~inside).any())
        for f in want:
            assert not f[:, ~inside].any()
        assert want[0][:, inside].any(axis=0).all()
        d = (c[None, :] - q[:, None]) * invh[:, None]
        v, der = tsg._poly_and_deriv(torch.clamp(d * d, max=1.0), coeffs)
        in_d = torch.from_numpy(inside).float()
        got = [v, der * (-2.0 * d * invh[:, None] * in_d), der * (2.0 * d * d * in_d)]
        for g, w in zip(got, want):
            assert not g.numpy()[:, ~inside].any()
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6 * np.abs(w).max())


def _expected_order(lengths):
    return sorted(range(len(lengths)), key=lambda k: -lengths[k])  # stable


def test_splat_key_order():
    """Ragged keys, empty keys and ties: most instances first, ties in key
    order, the empty keys last."""
    counts = [5, 0, 17, 3, 17, 0, 1, 9, 3, 0]
    first = torch.tensor(np.cumsum([0] + counts[:-1]), dtype=torch.int32)
    last = first + torch.tensor(counts, dtype=torch.int32)
    order = tsp.splat_key_order(first, last)
    assert order.dtype == torch.int32
    assert order.tolist() == _expected_order(counts)
    assert order.tolist()[:2] == [2, 4] and order.tolist()[-3:] == [1, 5, 9]


def test_sortfree_tile_order():
    """Rows of random words with random popcounts (ties, empty rows, sign
    bits): the order is the tiles by descending set bits, stable."""
    rng = np.random.default_rng(9)
    n_tiles, n_words = 40, 5
    words = np.zeros((n_tiles, n_words), np.int64)
    for t in range(n_tiles):
        for bit in rng.choice(32 * n_words, rng.integers(0, 7), replace=False):
            words[t, bit // 32] |= 1 << (bit % 32)
    words[3, 4] |= 1 << 31
    words[7, 0] = 0xFFFFFFFF
    words = (((words + 2**31) % 2**32) - 2**31).astype(np.int32)
    lengths = [sum(bin(int(w) & 0xFFFFFFFF).count("1") for w in row) for row in words]
    assert lengths.count(0) > 1 and len(set(lengths)) < n_tiles
    order = tsg.sortfree_tile_order(torch.from_numpy(words))
    assert order.dtype == torch.int32
    assert order.tolist() == _expected_order(lengths)
    assert order.tolist()[0] == 7
    assert all(lengths[t] == 0 for t in order.tolist()[-lengths.count(0):])


def test_render_fwd_tile_order():
    """The fused forward's tiles on the training scene's lists (tile 64,
    tiles with no segment, lists cut at max_len): a permutation of the
    tiles by descending entries read, min(count, max_len), ties in tile
    order; a launch in another order takes CUDA tensors only."""
    ss, w = training_scene("cpu", False)
    rays, _, _ = spatial_sort_rays(orthographic_projection_rays(64, 64, CAM, LOOK, UP, 4.0,
                                                                LENGTH, device="cpu"))
    for max_chunks in (2048, 3):
        fwd_args = render_inputs(rays, ss, w, torch.zeros(rays.n_rays), 64, max_chunks, 8)[0]
        counts, ids = fwd_args[0], fwd_args[1]
        read = torch.clamp(counts, 0, ids.shape[1]).tolist()
        assert 0 in read and len(set(read)) < len(read)
        order = tpk.list_tile_order(counts, ids.shape[1])
        assert order.dtype == torch.int32 and order.tolist() == _expected_order(read)
        with pytest.raises(ValueError, match="CUDA"):
            tpr._render_fwd_launch(*fwd_args, order, torch.empty(fwd_args[2].shape[0]))
