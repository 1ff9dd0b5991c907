"""Per-hit records of grace_tpu_torch against grace_tpu on the CPU.

``pallas_trace_sph_records`` (quarter, bitmask and streaming routes, a tile
that does not divide the rays, rows that overflow), its errors and the
drain options that select nothing, ``sort_records_by_distance``,
``records_to_flat``, and ``trace_sph`` / ``trace_with_sentinels_sph`` on
both engines. grace_tpu's record kernels run in interpret mode; the port's
wrappers run their plain versions on CPU tensors.

Tolerances: records of the pallas engine are bit-exact (counts, indices,
sentinels, integrals and distances: the port mirrors the compiled
arithmetic). On the xla engine counts, offsets, indices and distances are
exact and the table-lerp integrals within rtol 1e-6 (measured: equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grace_tpu.build.sph import build_sph_tree as j_build
from grace_tpu.core.types import Rays as JRays
from grace_tpu.core.types import make_spheres as j_make_spheres
from grace_tpu.trace import pallas_records as jr
from grace_tpu.trace import sph as jsph
from grace_tpu_torch import convert
from grace_tpu_torch.trace import pallas_records as tr
from grace_tpu_torch.trace import sph as tsph

from tests.helper.torch_parity import one_torch_thread  # noqa: F401  (autouse)


def _scene(seed, n, r):
    """grace_tpu's record test scene: n spheres (h 0.05-0.13) in the unit
    box, r rays from near the origin toward points inside it, length 3;
    both packages' types."""
    rng = np.random.default_rng(seed)
    spheres = j_make_spheres(rng.random((n, 3)).astype(np.float32),
                             (0.05 + 0.08 * rng.random(n)).astype(np.float32))
    ss, tree, _ = jax.jit(j_build, static_argnums=1)(spheres, 8)
    o = (rng.random((r, 3)) * 0.2 - 0.2).astype(np.float32)
    d = (0.2 + 0.6 * rng.random((r, 3))).astype(np.float32) - o   # into the box
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    ln = np.full(r, 3.0, np.float32)
    jrays = JRays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(ln))
    tree_t = convert.tree_from_numpy(
        *(np.asarray(x) for x in (tree.children, tree.child_aabbs, tree.leaves, tree.root,
                                  tree.n_nodes, tree.n_leaves)), tree.max_per_leaf, device="cpu")
    return ((ss, tree, jrays),
            (convert.spheres_from_numpy(ss, device="cpu"), tree_t,
             convert.rays_from_numpy(o, d, ln, device="cpu")))


@pytest.fixture(scope="module")
def scene():
    return _scene(1234, 600, 192)


def _assert_records_equal(got, want):
    assert isinstance(got, tr.RecordTraceResult)
    for name, g, w in zip(tr.RecordTraceResult._fields, got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        assert np.array_equal(g.numpy(), w), name


@pytest.mark.parametrize("kw", [
    dict(tile=64),                                        # auto -> quarter
    dict(tile=40, broadphase="quarter"),                  # 192 rays: no multiple of 40
    dict(tile=64, broadphase="bitmask"),
    dict(tile=32, vmem_resident_limit=1024),              # streaming: auto -> bitmask
], ids=["auto", "quarter-t40", "bitmask", "streaming"])
def test_records_match_grace_tpu(scene, kw):
    (ss, _, jrays), (ts, _, trays) = scene
    want = jr.pallas_trace_sph_records(jrays, ss, 128, interpret=True, **kw)
    got = tr.pallas_trace_sph_records(trays, ts, 128, **kw)
    assert int(got.counts.sum()) > 2000 and got.capacity == 128
    _assert_records_equal(got, want)


def test_overflow_counts_exact():
    """512 co-located spheres and 64 rays through their center, rows of
    128: every count is exactly 512, every row full, as in grace_tpu."""
    spheres = j_make_spheres(np.full((512, 3), 0.5, np.float32),
                             np.full((512,), 0.4, np.float32))
    ss, _, _ = jax.jit(j_build, static_argnums=1)(spheres, 8)
    o = np.tile([[0.5, 0.5, -2.0]], (64, 1)).astype(np.float32)
    d = np.tile([[0.0, 0.0, 1.0]], (64, 1)).astype(np.float32)
    ln = np.full(64, 6.0, np.float32)
    want = jr.pallas_trace_sph_records(JRays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(ln)),
                                       ss, 128, tile=64, interpret=True)
    got = tr.pallas_trace_sph_records(convert.rays_from_numpy(o, d, ln, device="cpu"),
                                      convert.spheres_from_numpy(ss, device="cpu"), 128)
    assert bool((got.counts == 512).all()) and bool(got.overflowed.all())
    assert bool((got.indices >= 0).all())
    _assert_records_equal(got, want)


def test_errors_as_grace_tpu(scene):
    _, (ts, _, trays) = scene
    with pytest.raises(ValueError, match="multiple of 128"):
        tr.pallas_trace_sph_records(trays, ts, 100)
    with pytest.raises(ValueError, match="drain"):
        tr.pallas_trace_sph_records(trays, ts, 128, drain="netwrok")
    with pytest.raises(ValueError, match="rank_method"):
        tr.pallas_trace_sph_records(trays, ts, 128, rank_method="mxuu")
    with pytest.raises(ValueError, match="broadphase"):
        tr.pallas_trace_sph_records(trays, ts, 128, broadphase="dense")
    with pytest.raises(ValueError, match="resident"):
        tr.pallas_trace_sph_records(trays, ts, 128, broadphase="quarter",
                                    vmem_resident_limit=1024)


def test_drain_options_select_nothing(scene):
    """Every rank_method, group and drain gives the default's records (as
    grace_tpu's test_rank_method_group_parity and
    test_network_drain_matches_pick assert for its drains)."""
    _, (ts, _, trays) = scene
    base = tr.pallas_trace_sph_records(trays, ts, 128, tile=32)
    for kw in (dict(rank_method="prefix", group=1), dict(rank_method="mxu", group=1),
               dict(rank_method="prefix", group=8), dict(drain="network"),
               dict(drain="network", vmem_resident_limit=1024)):
        got = tr.pallas_trace_sph_records(trays, ts, 128, tile=32, **kw)
        for g, b in zip(got, base):
            assert torch.equal(g, b), kw


def test_sort_and_flat_match_grace_tpu(scene):
    (ss, _, jrays), (ts, _, trays) = scene
    want = jr.pallas_trace_sph_records(jrays, ss, 128, tile=64, interpret=True)
    got = tr.pallas_trace_sph_records(trays, ts, 128)
    _assert_records_equal(tr.sort_records_by_distance(got), jr.sort_records_by_distance(want))
    for kw in (dict(capacity=8192), dict(capacity=500),        # 500 drops records
               dict(capacity=8192, sentinel_slots=True, index_sentinel=-7,
                    value_sentinel=2.5, distance_sentinel=-3.0)):
        g = tr.records_to_flat(got, **kw)
        w = jr.records_to_flat(want, **kw)
        for a, b in zip(g, w):
            b = np.asarray(b)
            assert a.numpy().dtype == b.dtype and np.array_equal(a.numpy(), b), kw


def test_sort_ties_keep_column_order():
    """Equal distances keep their column order in both packages; sentinel
    slots go last."""
    idx = np.array([[5, 6, 7, 8, -1, -1], [1, 2, 3, -1, -1, -1]], np.int32)
    dist = np.array([[0.5, 0.25, 0.5, 0.25, -1, -1], [0.0, -0.0, 0.0, -1, -1, -1]], np.float32)
    intg = np.arange(12, dtype=np.float32).reshape(2, 6)
    counts = np.array([4, 3], np.int32)
    want = jr.sort_records_by_distance(jr.RecordTraceResult(counts, idx, intg, dist))
    got = tr.sort_records_by_distance(tr.RecordTraceResult(*map(torch.from_numpy,
                                                                (counts, idx, intg, dist))))
    assert got.indices[0].tolist() == [6, 8, 5, 7, -1, -1]
    assert got.indices[1].tolist() == [1, 2, 3, -1, -1, -1]
    _assert_records_equal(got, want)


def _flat_equal_by_ray(got, want, sentinel):
    """Counts, offsets and total exact; each ray's hits equal as a set of
    (index, distance) with integrals within rtol 1e-6, after sorting by
    index (the xla engine emits traversal order)."""
    off, cnt = np.asarray(want.offsets), np.asarray(want.counts)
    assert np.array_equal(got.offsets.numpy(), off)
    assert np.array_equal(got.counts.numpy(), cnt)
    assert int(got.total_hits) == int(want.total_hits)
    assert got.total_hits.dtype == torch.int32
    gi, gg, gd = (x.numpy() for x in (got.indices, got.integrals, got.distances))
    wi, wg, wd = (np.asarray(x) for x in (want.indices, want.integrals, want.distances))
    for k in range(cnt.shape[0]):
        s = slice(off[k], off[k] + cnt[k])
        o1, o2 = np.argsort(gi[s]), np.argsort(wi[s])
        assert np.array_equal(gi[s][o1], wi[s][o2])
        assert np.array_equal(gd[s][o1], wd[s][o2])
        np.testing.assert_allclose(gg[s][o1], wg[s][o2], rtol=1e-6)
        if sentinel:
            e = off[k] + cnt[k]
            assert (gi[e], gg[e], gd[e]) == (wi[e], wg[e], wd[e])


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_trace_sph_facades_match_grace_tpu(scene, engine):
    (ss, tree, jrays), (ts, tree_t, trays) = scene
    kw = dict(engine=engine, per_ray_capacity=128)
    if engine == "pallas":
        kw["interpret"] = True
    want = jsph.trace_sph(jrays, ss, tree, capacity=8192, **kw)
    kw.pop("interpret", None)
    got = tsph.trace_sph(trays, ts, tree_t, capacity=8192, **kw)
    assert isinstance(got, tsph.SphTraceResult) and int(got.total_hits) > 2000
    _flat_equal_by_ray(got, want, sentinel=False)
    kw2 = dict(kw, index_sentinel=-3, distance_sentinel=-2.0)
    if engine == "pallas":
        kw2["interpret"] = True
    want = jsph.trace_with_sentinels_sph(jrays, ss, tree, capacity=8192, **kw2)
    kw2.pop("interpret", None)
    got = tsph.trace_with_sentinels_sph(trays, ts, tree_t, capacity=8192, **kw2)
    _flat_equal_by_ray(got, want, sentinel=True)
    with pytest.raises(ValueError, match="engine"):
        tsph.trace_sph(trays, ts, tree_t, capacity=8, engine="cuda")
