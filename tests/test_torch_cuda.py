"""The CUDA kernels of grace_tpu_torch against their plain PyTorch versions.

Needs a CUDA card: every test here carries the ``cuda`` marker and skips
without one (a hand-written kernel has no CPU mode). The file imports
neither JAX nor grace_tpu, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest imports JAX for the parity tests.)
Hit counts must be exact; column densities within rtol 1e-5 (the kernels
sum the same f32 terms as the plain versions, in another order); splat
images within 1e-5 x max. Kernels: trace_quarter, trace_bitmask,
trace_list (quarter and segment lists, with overflow; the segment kernels
on rows of 0, 1, 8, 9 and all segments around their staging batch, in
their longest-first launch order, and every trace kernel on particles at
the edge of a ray's support), splat, and the
training kernels splat_sortfree_fwd / _bwd and render_fwd / _bwd (a
particle count that is not a multiple of 128, dead particles, empty tiles,
a particle that covers every tile, both bases, tile_w 8 to 32, list
overflow, backward lists cut to lengths around the kernel's staging batch,
the sort-free backward on the splat edge scene at tile_w 8 to 64, the sort-free backward and
the fused forward in three launch orders each bit-equal; gradients within
grace_tpu's bounds; their resources, an unaligned slab and bad orders
refused), the fused renderer's overflow contracts and
both trainers against finite differences; the record kernels (quarter and
segment words, tiles of 48 to 1024 rays, empty tiles, rows that overflow,
row capacities that are no multiple of 4, three launch orders bit-equal,
their resources, unaligned slabs and bad orders refused; counts and
indices exact, integrals and distances within rtol 1e-6) and the triangle kernel (random
meshes with faces culled, rays that miss the mesh box, tiles 8 to 96,
both modes, lists cut by max_chunks; ids, misses and t bit-equal), and
the engine's walk (bvh_walk.cu) against the plain walk at its edge shapes
(a stack of 4, rays on box planes and rays that miss, a leaf of one
primitive, record buffers that overflow, weights on and off, triangles
in both modes), the packet walk bit-equal to the per-ray walk in every
mode (a ragged ray count, stacks of 64 and 4), every facade of the walk
on the card without entering engine.trace, and the walk's resources and
refusals; and the LBVH build (build.cu: keys, deltas, the gather with
boxes and deltas, and the two climbs, also at blocks of 2 to 1024 items)
bit-equal to the plain build at every case of chip_smoke's check_build
(the full-size scenes, 63-bit keys with XOR and surface-area deltas, all
points identical, runs of equal keys, max_per_leaf 1 and 32, N = 2 and 3,
signed zeros at the box edge), two entry builds bit-equal with no host
sync, the valid tree where a delta is the sentinel, one launch of each
kernel a build and the refusals; and the splat's two setups
(splat_prep.cu: bucket_prims_ortho's two passes, the sort-free setup)
bit-equal to their plain versions at every case of chip_smoke's
SPLAT_PREP_CASES (n not a multiple of chunk or 128, n < 32, 128 tiles,
band None to 64, weights None and given, dead particles, overflow, a
2^16-particle clustered scene, Morton-sorted particles at path 1's 256
keys, 4,096 keys with the counters in device memory), the bucketed
setup's resources, their launches on a frame and a training
step and the refusals; and the dense broadphase and the triangle lists
(broadphase.cu, tri_lists.cu) against their plain versions at every case
of chip_smoke's BROADPHASE_CASES, OVERLAP_BOX_CASES and TRI_LIST_CASES
(boxes equal in value, everything else bit-equal), the overlap and
sort-free setup kernels' resources, the lists' device-memory sort forced on the
torus, their launches on a quarter, a qlist and a triangle trace and the
refusals; and the records' post-processing (segsort.cu: the row sort, the
CSR sort by distance, the flat layout) at every case of chip_smoke's
SEGSORT_ROW_CASES, SEGSORT_FLAT_CASES and SEGSORT_CSR_CASES, bit-equal to
grace_tpu's order (the plain version on the CPU), the long route forced
with chunks of 128 (also on capacity padding), their launches without a
host sync, the refusals, and each kernel's resources (no local bytes).
The edge scenes and checks are chip_smoke.py's.
"""

import numpy as np
import pytest
import torch

from grace_tpu_torch.build.sph import build_sph_tree
from grace_tpu_torch.rays.gen import orthographic_projection_rays, spatial_sort_rays
from grace_tpu_torch.trace import pallas_kernel as pk
from grace_tpu_torch.trace import splat as sp
from grace_tpu_torch.trace.pallas_broadphase import (
    dense_tile_masks, dense_tile_masks_quarter, dense_tile_segments, quarter_lists)
from grace_tpu_torch.trace import pallas_render as pr
from grace_tpu_torch.trace import splat_grad as sg
from grace_tpu_torch.trace import pallas_records as prc
from grace_tpu_torch.trace import pallas_tri as pt
from chip_smoke import (
    BUILD_CASES, EDGE_ORDERS, build_case, build_counters, build_stages, check_build_case,
    KEY_CASES, check_keys, key_outputs, COMPACT_CASES, check_compaction,
    check_climbs, check_gather, check_sentinel_build, zero_build_counters,
    SORTFREE_BWD_EDGE_ROWS, SORTFREE_EDGE_CASES, SPLAT_EDGE_CASES,
    SPLAT_PREP_CASES, check_splat_prep_case, prep_counters, splat_prep_scene, zero_prep_counters,
    BOX_SET_CASES, BROADPHASE_CASES, TRI_LIST_CASES, broadphase_counters, broadphase_scene,
    check_box_set_case, check_broadphase_case, check_overlap_boxes, check_tri_lists_case, tri_list_inputs,
    zero_broadphase_counters,
    check_record_orders, check_records, check_walk_routes,
    SEGSORT_CSR_CASES, SEGSORT_FLAT_CASES, SEGSORT_ROW_CASES, check_segsort_case,
    segsort_case_args, segsort_counters, segsort_gate, zero_segsort_counters,
    check_render,
    check_render_bwd, check_sortfree, check_splat, check_tri, colocated_scene, fd_checks,
    make_clustered_particles, random_mesh, records_inputs, records_scene,
    records_small_checks, render_inputs, route_inputs, sortfree_bwd_edge_check,
    sortfree_edge_check, sortfree_inputs,
    splat_edge_check, support_edge_scene, training_scene, tri_inputs, walk_edge_rays,
    walk_small_checks)
from grace_tpu_torch import _kernels

CAM = (0.5, 0.5, -2.0)
LOOK = (0.5, 0.5, 0.5)
UP = (0.0, 1.0, 0.0)
SPLAT_TILE = dict(tile_w=32, tile_h=128)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def scene(dev):
    """3000 clustered particles, Morton-sorted, and 50x39 sorted ortho rays
    over a wide view (1950 rays: no tile multiple; some tiles and bands
    see no particle)."""
    spheres = torch.from_numpy(make_clustered_particles(np.random.default_rng(7), 3000))
    ss, _, _ = build_sph_tree(spheres.to(dev), 16)
    rays = orthographic_projection_rays(50, 39, CAM, LOOK, UP, 4.0, 6.0, device=dev)
    rays_s, _, _ = spatial_sort_rays(rays)
    return ss, rays_s


def _trace_inputs(rays, spheres, tile):
    rays = pk._pad_rays(rays, tile)
    packed, _ = pk._pack_rays(rays, tile)
    prims, _ = pk._pack_prims(spheres)
    words, summary = dense_tile_masks_quarter(rays, spheres, tile)
    return summary, words, packed, prims


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [128, 96])
@pytest.mark.parametrize("mode,deg", [("hitcount", 14), ("cumulative", 14),
                                      ("cumulative", 8), ("cumulative", -10),
                                      ("cumulative", -12)])
def test_trace_quarter_kernel_matches_plain(scene, tile, mode, deg):
    ss, rays_s = scene
    summary, words, packed, prims = _trace_inputs(rays_s, ss, tile)
    assert rays_s.n_rays % tile and bool((words == 0).all(dim=1).any())
    before = pk.trace_quarter.launches
    got = pk.trace_quarter(summary, words, packed, prims, deg, mode)
    assert pk.trace_quarter.launches == before + 1
    want = pk._trace_quarter_plain(summary, words, packed, prims, deg, mode)
    torch.cuda.synchronize()
    if mode == "hitcount":
        assert want.sum() > 0 and torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-6 * float(want.abs().max()))


MODE_DEGS = [("hitcount", 14), ("cumulative", 14), ("cumulative", 8),
             ("cumulative", -10), ("cumulative", -12)]


def _assert_kernel_matches(got, want, mode):
    torch.cuda.synchronize()
    if mode == "hitcount":
        assert want.sum() > 0 and torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-6 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [128, 96, 8])
@pytest.mark.parametrize("mode,deg", MODE_DEGS)
def test_trace_bitmask_kernel_matches_plain(scene, tile, mode, deg):
    ss, rays_s = scene
    rays = pk._pad_rays(rays_s, tile)
    packed, _ = pk._pack_rays(rays, tile)
    prims, _ = pk._pack_prims(ss)
    words = dense_tile_masks(rays, ss, tile)
    assert rays_s.n_rays % tile and bool((words == 0).all(dim=1).any())
    before = pk.trace_bitmask.launches
    got = pk.trace_bitmask(words, packed, prims, deg, mode)
    assert pk.trace_bitmask.launches == before + 1
    _assert_kernel_matches(got, pk._trace_bitmask_plain(words, packed, prims, deg, mode),
                           mode)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [128, 96])
@pytest.mark.parametrize("route", ["qlist", "list"])
@pytest.mark.parametrize("mode,deg", MODE_DEGS)
def test_trace_list_kernel_matches_plain(scene, tile, route, mode, deg):
    """Quarter lists (group 32) and segment lists (group 128), each with a
    capacity small enough that some tiles overflow."""
    ss, rays_s = scene
    rays = pk._pad_rays(rays_s, tile)
    packed, _ = pk._pack_rays(rays, tile)
    prims, _ = pk._pack_prims(ss)
    if route == "qlist":
        ids, n, ovf = quarter_lists(rays, ss, tile, max_q=16)
        group = 32
    else:
        ids, n, ovf = dense_tile_segments(rays, ss, tile, 4)
        group = 128
    assert bool(ovf.any()) and bool((n == 0).any())
    before = pk.trace_list.launches
    got = pk.trace_list(n, ids, packed, prims, group, deg, mode)
    assert pk.trace_list.launches == before + 1
    _assert_kernel_matches(
        got, pk._trace_list_plain(n, ids, packed, prims, group, deg, mode), mode)


# Segments a tile lists: none, one, one staging batch of the kernels (8
# segments, 1024 primitives), one more, all 24, and between.
BATCH_EDGE_LENGTHS = [0, 1, 8, 9, 24, 16, 17, 3, 7, 2]


@pytest.fixture(scope="module")
def batch_edges(dev):
    """(words, counts, ids i32[10, 24], packed rays, prims): 3000 clustered
    particles (24 segments, the last one part padding), 32x40 ortho rays
    over the box in 10 tiles of 128; tile t lists BATCH_EDGE_LENGTHS[t]
    random segments, ascending, as words and as a segment list."""
    sp = torch.from_numpy(make_clustered_particles(np.random.default_rng(9), 3000)).to(dev)
    rays = orthographic_projection_rays(32, 40, CAM, LOOK, UP, 1.2, 6.0, device=dev)
    packed, _ = pk._pack_rays(rays, 128)
    prims, n_pad = pk._pack_prims(sp)
    n_segs = n_pad // 128
    rng = np.random.default_rng(10)
    words = np.zeros((len(BATCH_EDGE_LENGTHS), 1), np.int64)
    ids = np.zeros((len(BATCH_EDGE_LENGTHS), n_segs), np.int32)
    for t, n in enumerate(BATCH_EDGE_LENGTHS):
        segs = np.sort(rng.choice(n_segs, n, replace=False))
        ids[t, :n] = segs
        words[t, 0] = sum(1 << int(g) for g in segs)
    t32 = lambda a: torch.from_numpy(a.astype(np.int32)).to(dev)
    return (t32(words), t32(np.asarray(BATCH_EDGE_LENGTHS)), t32(ids), packed, prims)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,deg", MODE_DEGS)
def test_trace_bitmask_batch_edges(batch_edges, mode, deg):
    """Rows of 0, 1, 8, 9 and all segments, launched longest row first."""
    words, _, _, packed, prims = batch_edges
    order = pk.bitmask_tile_order(words)
    assert order.tolist() != sorted(order.tolist())
    before = pk.trace_bitmask.launches
    got = pk.trace_bitmask(words, packed, prims, deg, mode)
    assert pk.trace_bitmask.launches == before + 1
    _assert_kernel_matches(got, pk._trace_bitmask_plain(words, packed, prims, deg, mode), mode)


@pytest.mark.cuda
@pytest.mark.parametrize("max_len", [24, 12], ids=["roomy", "counts past max_len"])
@pytest.mark.parametrize("mode,deg", MODE_DEGS)
def test_trace_list_batch_edges(batch_edges, mode, deg, max_len):
    """Segment lists of 0, 1, 8, 9 and all segments, launched longest list
    first; with max_len 12, counts of 16, 17 and 24 read 12 entries."""
    _, counts, ids, packed, prims = batch_edges
    ids = ids[:, :max_len].contiguous()
    order = pk.list_tile_order(counts, max_len)
    assert order.tolist() != sorted(order.tolist())
    assert (max_len < 24) == bool((counts > max_len).any())
    before = (pk.trace_list.launches, pk.trace_list.launches_seg)
    got = pk.trace_list(counts, ids, packed, prims, 128, deg, mode)
    assert (pk.trace_list.launches, pk.trace_list.launches_seg) == (before[0] + 1, before[1] + 1)
    _assert_kernel_matches(
        got, pk._trace_list_plain(counts, ids, packed, prims, 128, deg, mode), mode)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["quarter", "bitmask", "qlist", "list"])
@pytest.mark.parametrize("mode,deg", MODE_DEGS)
def test_trace_kernels_at_the_support_edge(dev, route, mode, deg):
    """Particles placed at b = h (1 + k ulp) beside a ray, so u = b^2 / h^2
    lands within a few ulp of 1 on both sides: the kernels take a pair's
    integral only where u < 1, the plain versions everywhere."""
    spheres, rays, near = support_edge_scene(dev)
    kernel, plain, args, ovf = route_inputs(route, rays, spheres, None, 128)
    assert int(near.sum()) == 128 and not bool(ovf.any())
    _assert_kernel_matches(kernel(*args, deg, mode), plain(*args, deg, mode), mode)


@pytest.mark.cuda
@pytest.mark.parametrize("basis", ["deg8", "deg10"])
@pytest.mark.parametrize("band", [32, None])
def test_splat_kernel_matches_plain(scene, basis, band):
    ss, _ = scene
    b = sp.bucket_prims_ortho(ss, CAM, LOOK, UP, 4.0, 6.0, 128, 128, chunk=256,
                              band=band, **SPLAT_TILE)
    assert bool((b.first == b.last).any())              # a band with no instance
    before = sp.splat_image.launches
    _, top = check_splat("card test", b, basis, **SPLAT_TILE)   # bit-equal to the dense loop
    assert sp.splat_image.launches == before + 1 and top > 0


@pytest.mark.cuda
@pytest.mark.parametrize("order", EDGE_ORDERS)
@pytest.mark.parametrize("case", SPLAT_EDGE_CASES, ids=str)
def test_splat_kernel_edge_cases(dev, case, order):
    """The splat edge scene (an empty key, a key of one instance, keys over
    many slabs, instances on key corners and at the edge of their support,
    footprints covering whole patches) at band 16, 32, 64 and 128 and
    tile_w 8 to 64, launched heaviest first, as listed and heaviest last:
    bit-equal to the dense contraction, within 1e-5 x max of the plain
    version."""
    splat_edge_check(dev, case, order)


@pytest.mark.cuda
@pytest.mark.parametrize("basis,zero_scale", [("deg10", False), ("deg8", True)])
def test_splat_kernel_other_basis_and_zero_scale(dev, basis, zero_scale):
    splat_edge_check(dev, SPLAT_EDGE_CASES[0], "heaviest", basis, zero_scale)


@pytest.mark.cuda
@pytest.mark.parametrize("order", EDGE_ORDERS)
@pytest.mark.parametrize("case", SORTFREE_EDGE_CASES, ids=str)
def test_splat_sortfree_fwd_edge_cases(dev, case, order):
    """The sort-free forward on the splat edge scene (dead particles, tiles
    with no segment, particles at the edge of their support, footprints
    covering whole patches) at tile_w 8 to 64 and bands 16 and 32, in the
    three launch orders: bit-equal to the dense contraction, within 1e-5 x
    max of the plain version."""
    before = sg.splat_sortfree_fwd.launches
    sortfree_edge_check(dev, case, order)
    assert sg.splat_sortfree_fwd.launches == before + 1


@pytest.mark.cuda
def test_splat_resources_and_rejections(scene):
    """The resource queries at the bench patch; the wrappers and C entries
    refuse what the kernels do not take."""
    ss, _ = scene
    for lib, entry, batch in (("splat", "grace_splat_resources", sp.SPLAT_BATCH),
                              ("splat_sortfree", "grace_splat_sortfree_fwd_resources",
                               sg.FWD_BATCH)):
        res = _kernels.resources(lib, entry, ss.device, 32, 32, 5, 8, batch)
        assert res["threads"] == 256 and res["blocks_per_sm"] >= 1
        # at least the batch's column factors (the rows are cut over blocks)
        assert res["shared_bytes"] >= batch * 5 * 32 * 4 and 0 < res["registers"] <= 255
        with pytest.raises(RuntimeError, match="CUDA error"):   # 129 instances a batch
            _kernels.resources(lib, entry, ss.device, 32, 32, 5, 8, sp.MAX_BATCH + 1)
        with pytest.raises(RuntimeError, match="CUDA error"):   # 2048 (strip, group) tasks
            _kernels.resources(lib, entry, ss.device, 8192, 1, 5, 8, 1)
    b = sp.bucket_prims_ortho(ss, CAM, LOOK, UP, 4.0, 6.0, 128, 128, chunk=256, band=32,
                              **SPLAT_TILE)
    with pytest.raises(ValueError, match="order"):
        sp._splat_launch(b, 32, 32, "deg8", torch.zeros(3, dtype=torch.int32, device=ss.device))


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(scene):
    ss, rays_s = scene
    summary, words, packed, prims = _trace_inputs(rays_s, ss, 2048)
    with pytest.raises(ValueError, match="rays per block"):
        pk.trace_quarter(summary, words, packed, prims, 14, "cumulative")
    with pytest.raises(ValueError, match="several devices"):
        pk.trace_quarter(summary.cpu(), words, packed, prims, 14, "cumulative")
    masks = dense_tile_masks(pk._pad_rays(rays_s, 2048), ss, 2048)
    with pytest.raises(ValueError, match="rays per block"):
        pk.trace_bitmask(masks, packed, prims, 14, "cumulative")
    with pytest.raises(ValueError, match="words per tile"):
        pk.trace_bitmask(masks[:, 1:], packed[:1024], prims, 14, "cumulative")
    with pytest.raises(TypeError):
        pk.trace_bitmask(masks.long(), packed, prims, 14, "cumulative")
    n = torch.ones(1, dtype=torch.int32, device=ss.device)
    ids = torch.zeros((1, 4), dtype=torch.int32, device=ss.device)
    with pytest.raises(ValueError, match="rays per block"):
        pk.trace_list(n, ids, packed, prims, 128, 14, "cumulative")
    with pytest.raises(ValueError, match="group"):
        pk.trace_list(n, ids, packed[:1024], prims, 64, 14, "cumulative")
    with pytest.raises(ValueError, match="several devices"):
        pk.trace_list(n.cpu(), ids, packed[:1024], prims, 128, 14, "cumulative")
    with pytest.raises(ValueError, match="unknown mode"):
        pk.trace_list(n, ids, packed[:1024], prims, 128, 14, "closest")
    # the C entries stage with 16-byte copies: an unaligned slab is refused
    out = torch.empty(1024, device=ss.device)
    coeffs = pk._coeff_tensor(14, str(ss.device))
    shifted = torch.empty(prims.numel() + 1, device=ss.device)[1:].view_as(prims)
    for entry, ptrs, ints in (
            ("grace_trace_bitmask", (masks[:1], None, packed[:1024], shifted),
             (1, 1024, masks.shape[1], prims.shape[1] // 128)),
            ("grace_trace_list", (n, ids, None, packed[:1024], shifted),
             (1, 1024, 4, 128, prims.shape[1]))):
        with pytest.raises(RuntimeError, match="CUDA error"):
            _kernels.launch(entry.split("_", 1)[1], entry, ss.device,
                            *[None if p is None else p.data_ptr() for p in ptrs],
                            coeffs.data_ptr(), out.data_ptr(), *ints, 14, 0)


WIDE = sg.OrthoCamera(CAM, LOOK, UP, 4.0, 6.0, 256, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("basis", ["deg8", "deg10"])
@pytest.mark.parametrize("tile_w", [16, 32, 8])
@pytest.mark.parametrize("whole", [False, True])
def test_splat_sortfree_kernels_match_plain(dev, whole, tile_w, basis):
    """3000 particles (not a multiple of 128), dead ones, a wide view with
    empty tiles; with ``whole``, one particle covering every tile."""
    ss, w = training_scene(dev, whole)
    inputs = sortfree_inputs(ss, w, WIDE, tile_w)
    masks, _, _, slabs = inputs
    assert ss.shape[0] % 128 and bool((slabs[:, 3] == 0).any())
    assert whole or bool((masks == 0).all(dim=1).any())          # a tile with no segment
    g = torch.randn(128, 256, generator=torch.Generator().manual_seed(5)).to(dev)
    before = (sg.splat_sortfree_fwd.launches, sg.splat_sortfree_bwd.launches)
    check_sortfree("card test", inputs, g, basis, tile_w, 5e-4 if whole else 3e-5)
    assert (sg.splat_sortfree_fwd.launches, sg.splat_sortfree_bwd.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("basis", ["deg8", "deg10"])
@pytest.mark.parametrize("tile_w", SORTFREE_BWD_EDGE_ROWS)
def test_splat_sortfree_bwd_edge_scene(dev, tile_w, basis):
    """The backward on the splat edge scene (footprint edges at d^2 within
    a few ulp of 1 from a pixel centre, footprints covering whole 32 x 32
    patches, dead particles), within 3e-5 x max of the plain version."""
    before = sg.splat_sortfree_bwd.launches
    sortfree_bwd_edge_check(dev, tile_w, basis)
    assert sg.splat_sortfree_bwd.launches == before + 1


@pytest.mark.cuda
def test_training_kernel_resources_and_rejections(dev):
    """The training kernels' resource queries; the backward's C entry
    refuses a tile whose cotangents pass a block's shared memory, and the
    wrapper raises on that; the forward's C entry refuses an unaligned
    slab, and a launch in another order one that is not a permutation of
    the tiles or an output that is not its own f32[R_pad]."""
    res = _kernels.resources("splat_sortfree", "grace_splat_sortfree_bwd_resources", dev,
                             32, 128, 5, 8)
    assert res["threads"] == 128 and res["blocks_per_sm"] >= 1
    assert res["shared_bytes"] >= 4 * 32 * 128      # the staged cotangent tile at least
    assert 0 < res["registers"] <= 255
    with pytest.raises(RuntimeError, match="CUDA error"):   # past 227 KB of shared memory
        _kernels.resources("splat_sortfree", "grace_splat_sortfree_bwd_resources", dev,
                           32, 2048, 5, 8)
    coords = torch.tensor([0.0, 0.0, 1e-3, 1e-3], device=dev)
    with pytest.raises(RuntimeError, match="CUDA error"):
        sg.splat_sortfree_bwd(torch.zeros((1, 1), dtype=torch.int32, device=dev), coords,
                              torch.zeros((1, 8, 128), device=dev),
                              torch.zeros((32, 2048), device=dev), "deg8", 32, 2048)
    res = _kernels.resources("render", "grace_render_fwd_resources", dev, 128)
    assert res["threads"] == 128 and res["blocks_per_sm"] >= 1 and res["registers"] <= 64
    ss, w = training_scene(dev, False)
    rays, _, _ = spatial_sort_rays(orthographic_projection_rays(64, 64, CAM, LOOK, UP, 4.0,
                                                                6.0, device=dev))
    fwd_args = render_inputs(rays, ss, w, torch.zeros(rays.n_rays, device=dev), 128, 2048,
                             64)[0]
    counts, ids, packed, prims = fwd_args
    shifted = torch.empty(prims.numel() + 1, device=dev)[1:].view_as(prims)
    shifted.copy_(prims)
    out = torch.empty(packed.shape[0], device=dev)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _kernels.launch("render", "grace_render_fwd", dev, counts.data_ptr(), ids.data_ptr(),
                        None, packed.data_ptr(), shifted.data_ptr(),
                        pr._poly_tensor(str(dev)).data_ptr(), out.data_ptr(), counts.shape[0],
                        128, ids.shape[1], prims.shape[0])
    # the wrapper passes an aligned copy of an unaligned slab
    assert torch.equal(pr.render_fwd(counts, ids, packed, shifted),
                       pr.render_fwd(counts, ids, packed, prims))
    good = torch.arange(counts.shape[0], dtype=torch.int32, device=dev)
    out = torch.empty(packed.shape[0], device=dev)
    for bad in (good[:-1], good.long(), good.cpu(), torch.zeros_like(good), good.flip(0) + 1):
        with pytest.raises(ValueError, match="order"):
            pr._render_fwd_launch(*fwd_args, bad, out)
    for bad in (out[:-1], out.double(), out.cpu(), torch.empty(2 * out.shape[0], device=dev)[::2],
                None):
        with pytest.raises(ValueError, match="out"):
            pr._render_fwd_launch(*fwd_args, good, bad)


@pytest.mark.cuda
@pytest.mark.parametrize("lists", [(128, 2048, 64), (64, 3, 1)], ids=["roomy", "overflow"])
@pytest.mark.parametrize("whole", [False, True])
def test_render_kernels_match_plain(dev, whole, lists):
    """Both fused-render kernels on roomy lists and on lists truncated by
    max_chunks 3 and max_tiles 1 (both overflow flags set)."""
    tile, max_chunks, max_tiles = lists
    ss, w = training_scene(dev, whole)
    rays, _, _ = spatial_sort_rays(orthographic_projection_rays(64, 64, CAM, LOOK, UP, 4.0,
                                                                6.0, device=dev))
    g = torch.randn(rays.n_rays, generator=torch.Generator().manual_seed(6)).to(dev)
    fwd_args, ovf, bwd_args, ovf_t = render_inputs(rays, ss, w, g, tile, max_chunks,
                                                   max_tiles)
    assert bool(ovf.any()) == bool(ovf_t.any()) == (max_tiles == 1)
    before = (pr.render_fwd.launches, pr.render_bwd.launches)
    check_render("card test", fwd_args, bwd_args)   # the forward in three launch orders
    assert (pr.render_fwd.launches, pr.render_bwd.launches) == (before[0] + 3, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("length", [0, 1, pr.BWD_BATCH - 1, pr.BWD_BATCH, pr.BWD_BATCH + 1])
def test_render_bwd_list_lengths(dev, length):
    """The backward kernel with every segment's tile list cut to ``length``
    entries: empty, one tile, and one batch of the kernel's staging less,
    exactly and more. The scene has dead particles and particle 100, whose
    footprint covers every ray of each tile it lists (all 128 bits of its
    hit mask set)."""
    ss, w = training_scene(dev, True)
    rays, _, _ = spatial_sort_rays(orthographic_projection_rays(64, 64, CAM, LOOK, UP, 4.0,
                                                                6.0, device=dev))
    g = torch.randn(rays.n_rays, generator=torch.Generator().manual_seed(6)).to(dev)
    n_t, t_ids, prims, rays_bwd = render_inputs(rays, ss, w, g, 128, 2048, 64)[2]
    assert bool((prims[..., 3] == 0).any()) and int(n_t.max()) > length
    seg, lane = divmod(100, 128)
    b2, dot, *_ = pk._impact(*prims[seg, lane, :3], *rays_bwd[:6])
    assert bool(((b2 < prims[seg, lane, 3] ** 2) & (dot >= 0) & (dot < rays_bwd[6])).all())
    before = pr.render_bwd.launches
    check_render_bwd(f"card test list length {length}",
                     (torch.clamp(n_t, max=length), t_ids, prims, rays_bwd))
    assert pr.render_bwd.launches == before + 1


@pytest.mark.cuda
def test_fused_renderer_overflow_contracts(dev):
    """max_chunks overflow sets the forward flag; max_tiles_per_seg
    overflow poisons every gradient with NaN; roomy lists do neither."""
    ss, w = training_scene(dev, False)
    rays, _, _ = spatial_sort_rays(orthographic_projection_rays(64, 64, CAM, LOOK, UP, 4.0,
                                                                6.0, device=dev))
    _, flag = pr.make_fused_renderer(tile=64, max_chunks=1, return_overflow=True)(rays, ss, w)
    assert bool(flag)
    for max_tiles, finite in ((1, False), (64, True)):
        s = ss.clone().requires_grad_(True)
        ww = w.clone().requires_grad_(True)
        render = pr.make_fused_renderer(tile=64, max_chunks=64, max_tiles_per_seg=max_tiles,
                                        return_overflow=True)
        values, flag = render(rays, s, ww)
        assert not bool(flag)
        values.sum().backward()
        assert bool(torch.isfinite(s.grad).all()) == finite
        assert bool(torch.isfinite(ww.grad).all()) == finite


@pytest.mark.cuda
def test_trainers_finite_differences(dev):
    fd_checks(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [64, 96, 48, 1024])
@pytest.mark.parametrize("route", ["quarter", "bitmask"])
def test_record_kernels_match_plain(dev, route, tile):
    """Tiles of 2 and 3 warps, 48 (a warp cut in half) and 1024 (the
    largest block: 32 warps' pending slots, 209 KB of shared memory);
    tiles that list nothing (but at 1024, whose two tiles both list some);
    counts and indices exact."""
    ss, rays_s = records_scene(dev)
    kernel, plain, args = records_inputs(route, rays_s, ss, tile)
    assert rays_s.n_rays % tile
    assert bool((args[-3] == 0).all(dim=1).any()) == (tile < 1024)
    before = kernel.launches
    got = check_records(f"card test {route}", kernel, plain, args, 128)[2]
    assert kernel.launches == before + 1 and int(got[0].sum()) > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [5, 37, 130])
@pytest.mark.parametrize("route", ["quarter", "bitmask"])
def test_record_kernels_row_capacities(dev, route, cap):
    """Row capacities that are no multiple of 4 (rows of 5 overflow on many
    rays): counts exact past the capacity, only the first cap records
    written."""
    ss, rays_s = records_scene(dev)
    kernel, plain, args = records_inputs(route, rays_s, ss, 64)
    got = check_records(f"card test {route} cap {cap}", kernel, plain, args, cap)[2]
    assert got[1].shape[1] == cap and (cap > 5 or bool((got[0] > cap).any()))


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [64, 48])
@pytest.mark.parametrize("route", ["quarter", "bitmask"])
def test_record_kernels_launch_orders(dev, route, tile):
    """As listed, longest mask row first and shortest first, each into
    outputs filled with -7: the plain version's records, and the same bits
    in every order (each tile's rows are written in place)."""
    ss, rays_s = records_scene(dev)
    _, _, args = records_inputs(route, rays_s, ss, tile)
    check_record_orders(f"card test {route} t{tile}", route, args, 128)
    sp, rays = colocated_scene(dev)
    _, _, args = records_inputs(route, rays, sp, 64)
    check_record_orders(f"card test overflow {route}", route, args, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["quarter", "bitmask"])
def test_record_kernels_overflow(dev, route):
    sp, rays = colocated_scene(dev)
    kernel, plain, args = records_inputs(route, rays, sp, 64)
    got = check_records(f"card test overflow {route}", kernel, plain, args, 128)[2]
    assert bool((got[0] == 512).all()) and bool((got[1] >= 0).all())


@pytest.mark.cuda
def test_record_routes_and_drains_bit_equal(dev):
    records_small_checks(dev)


def _tri_rays(dev, rng, r=1000):
    from grace_tpu_torch.core.types import Rays

    d = rng.standard_normal((r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = (rng.random((r, 3)) * 0.4 + 0.3).astype(np.float32)
    o[:50] = [3.0, 3.0, 3.0]
    return Rays.from_arrays(o, d, np.full(r, 5.0, np.float32), device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("max_chunks", [2048, 4])
@pytest.mark.parametrize("mode", ["closest", "any"])
@pytest.mark.parametrize("tile", [8, 32, 64, 96])
def test_tri_kernel_matches_plain(dev, tile, mode, max_chunks):
    """Tiles of 8 rays (spare lanes), 32 and 64, and 96 (a group of three
    warps that votes through a named barrier); t bit-equal where both hit."""
    rng = np.random.default_rng(3)
    tris = torch.from_numpy(random_mesh(rng, 1000)).to(dev)
    args, ovf = tri_inputs(_tri_rays(dev, rng), tris, tile, max_chunks)
    assert bool(ovf.any()) == (max_chunks == 4)
    before = pt.trace_tri.launches
    _, hits, _, _ = check_tri(f"card test tri t{tile} {mode}", args, mode)
    assert pt.trace_tri.launches == before + 1 and hits > 100


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [64, 48, 1024])
def test_record_resources(dev, tile):
    """Both record kernels fit the card at the tile: registers, shared
    memory (the staged batch and the pending slots) and resident warps."""
    for entry in ("grace_records_quarter_resources", "grace_records_bitmask_resources"):
        res = _kernels.resources("records", entry, dev, tile)
        assert res["threads"] == tile and res["blocks_per_sm"] >= 1
        assert 0 < res["registers"] <= 255 and res["registers"] * tile <= 65536
        assert 0 < res["shared_bytes"] <= 227 * 1024 and res["warps_per_sm"] <= 64
    with pytest.raises(RuntimeError, match="CUDA error"):
        _kernels.resources("records", "grace_records_quarter_resources", dev, 1025)


@pytest.mark.cuda
def test_record_kernels_refuse_unaligned_slabs_and_bad_orders(dev):
    ss, rays_s = records_scene(dev)
    for route in ("quarter", "bitmask"):
        _, _, args = records_inputs(route, rays_s, ss, 64)
        n_tiles = args[-3].shape[0]
        # the C entries stage with 16-byte copies: an unaligned slab is refused
        prims = args[-1]
        shifted = torch.empty(prims.numel() + 1, device=dev)[1:].view_as(prims)
        shifted.copy_(prims)
        outs = prc._outputs(args[-2], 128)
        coeffs = pk._coeff_tensor(14, str(dev))
        if route == "quarter":
            ptrs = (args[0], args[1], None, args[2], shifted)
            ints = (n_tiles, 64, args[0].shape[1], args[1].shape[1], prims.shape[1])
        else:
            ptrs = (args[0], None, args[1], shifted)
            ints = (n_tiles, 64, args[0].shape[1], prims.shape[1] // 128)
        with pytest.raises(RuntimeError, match="CUDA error"):
            _kernels.launch("records", f"grace_records_{route}", dev,
                            *[None if p is None else p.data_ptr() for p in ptrs],
                            coeffs.data_ptr(), *[o.data_ptr() for o in outs], *ints, 128, 14)
        # a launch in another order refuses one that is not a permutation
        # of the tiles
        good = torch.arange(n_tiles, dtype=torch.int32, device=dev)
        for bad in (good[:-1], good.long(), good.cpu(), torch.zeros_like(good),
                    good.flip(0) + 1):
            with pytest.raises(ValueError, match="order"):
                prc._records_launch(route, args, bad, prc._outputs(args[-2], 128))
        with pytest.raises(ValueError, match="outputs"):
            prc._records_launch(route, args, good, prc._outputs(args[-2], 128)[::-1])


@pytest.mark.cuda
def test_record_and_tri_wrappers_reject_what_the_kernels_do_not_take(dev):
    ss, rays_s = records_scene(dev)
    _, _, (summary, words, packed, prims) = records_inputs("quarter", rays_s, ss, 2048)
    with pytest.raises(ValueError, match="rays per block"):
        prc.records_quarter(summary, words, packed, prims, 128)
    with pytest.raises(ValueError, match="several devices"):
        prc.records_quarter(summary.cpu(), words, packed, prims, 128)
    _, _, (masks, packed64, prims) = records_inputs("bitmask", rays_s, ss, 64)
    with pytest.raises(TypeError):
        prc.records_bitmask(masks.long(), packed64, prims, 128)
    with pytest.raises(TypeError):
        prc.records_bitmask(masks, packed64.double(), prims, 128)
    with pytest.raises(ValueError, match="words per tile"):
        prc.records_bitmask(masks[:, 1:], packed64, prims, 128)
    rng = np.random.default_rng(3)
    args, _ = tri_inputs(_tri_rays(dev, rng), torch.from_numpy(random_mesh(rng, 300)).to(dev),
                         32, 64)
    n, ids, dist, rays, tris = args
    with pytest.raises(ValueError, match="several devices"):
        pt.trace_tri(n.cpu(), ids, dist, rays, tris, "closest")
    with pytest.raises(TypeError):
        pt.trace_tri(n, ids.long(), dist, rays, tris, "closest")
    with pytest.raises(ValueError, match="unknown mode"):
        pt.trace_tri(n, ids, dist, rays, tris, "nearest")
    with pytest.raises(ValueError, match="rays per block"):
        pt.trace_tri(n[:1], ids[:1], dist[:1], torch.cat([rays, rays]), tris, "closest")


@pytest.mark.cuda
def test_f32_products_ignore_tf32(dev, scene):
    """With TensorFloat-32 on (``set_float32_matmul_precision("high")``),
    the f32 products that go through ``vecmath.matmul_f32`` give the bits
    they give with it off: the HEALPix rotation, the Ripley counts (one
    bundle and a batch, the ``bmm`` form), An and Gn, and the splat's and
    the sort-free splat's plain contractions and dense oracle. A plain
    ``@`` under the same setting does change (TF32 is in effect)."""
    from grace_tpu_torch.rays import hypothesis as hy
    from grace_tpu_torch.rays import statistics as st
    from grace_tpu_torch.rays.healpix import healpix_rays

    ss, _ = scene
    buckets = sp.bucket_prims_ortho(ss, CAM, LOOK, UP, 1.2, 6.0, 128, 64, chunk=128, band=32,
                                    **SPLAT_TILE)
    a8, b8 = (np.asarray(c, np.float32) for c in sp.SPLAT_BASES["deg8"][1:])
    cam = sg.OrthoCamera(CAM, LOOK, UP, 1.2, 6.0, 128, 64)
    weights = torch.ones(ss.shape[0], device=dev)
    inputs = sortfree_inputs(ss, weights, cam, 32)

    def products():
        d = healpix_rays(torch.Generator(dev).manual_seed(3), 64, (0.5, 0.5, 0.5), 2.0,
                         device=dev).directions
        bg = st.beran_gine_statistics(d[:8192])
        cos = st._cos_f32(torch.as_tensor(hy.DEFAULT_SCALES, device=dev))
        return [d, bg["An"], bg["Gn"], st.ripley_k_sphere(d[:4096], hy.DEFAULT_SCALES),
                st._ripley_counts(d[:3000].reshape(3, 1000, 3), cos),
                sp._splat_plain(buckets, 32, 32, a8, b8),
                sg._sortfree_fwd_plain(inputs[0], inputs[2], inputs[3], a8, b8, 1, 32, 128, 64,
                                       128),
                sg.splat_reference_torch(ss, weights, cam)]

    prev = torch.get_float32_matmul_precision()
    off = products()
    x = torch.randn(4096, 3, device=dev)
    rot = torch.randn(3, 3, device=dev)
    plain_off = x @ rot
    torch.set_float32_matmul_precision("high")
    try:
        on = products()
        plain_on = x @ rot
    finally:
        torch.set_float32_matmul_precision(prev)
    assert not torch.equal(plain_on, plain_off)
    for i, (a, b) in enumerate(zip(on, off)):
        assert torch.equal(a, b), i


@pytest.mark.cuda
def test_walk_kernel_matches_plain_walk_at_edge_shapes(dev):
    """csrc/bvh_walk.cu against the plain walk (engine.trace) on the card,
    chip_smoke's edge shapes: clustered particles at 16 and at 1 a leaf,
    rays on box planes with zero direction components and rays that miss,
    weights on and off, record buffers of the hits and of half of them, a
    stack of 4, a random mesh and a torus in both modes, and the overflow
    message under GRACE_TPU_DEBUG. Counts, records, ids, t and occlusion
    bit-equal; sums within rtol 1e-5. Then the packet walk against the
    per-ray walk on the same shapes (every mode bit-equal)."""
    lines = walk_small_checks(dev)
    assert len(lines) == 19 and "raise" in lines[-1]


@pytest.mark.cuda
def test_walk_facades_run_the_kernel_on_the_card(dev):
    """Every facade of the engine's walk runs csrc/bvh_walk.cu on CUDA
    tensors and never enters engine.trace, and gives the CPU's results:
    counts, records, ids, triangle ids, t and occlusion equal; sums within
    rtol 1e-5."""
    from grace_tpu_torch.core.types import Rays
    from grace_tpu_torch.models import triangle as mt
    from grace_tpu_torch.trace import engine, walk as wk
    from grace_tpu_torch.trace import render as tr
    from grace_tpu_torch.trace import sph as tsph

    rng = np.random.default_rng(21)
    particles = torch.from_numpy(make_clustered_particles(rng, 3000))
    ss, tree, _ = build_sph_tree(particles, 16)
    rays = orthographic_projection_rays(40, 30, CAM, LOOK, UP, 1.2, 6.0, device="cpu")
    tris = torch.from_numpy(random_mesh(rng, 1500))
    st, ttree, _ = mt.build_triangle_tree(tris)
    o = (rng.random((900, 3)) * 0.4 + 0.3).astype(np.float32)
    d = rng.standard_normal((900, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    trays = Rays.from_arrays(o, d, np.full(900, 3.0, np.float32), device="cpu")
    w = torch.from_numpy((0.5 + rng.random(3000)).astype(np.float32))
    calls = {
        "trace_hitcounts_sph": lambda r, s, t, *_: tsph.trace_hitcounts_sph(r, s, t),
        "trace_cumulative_sph": lambda r, s, t, w_: tsph.trace_cumulative_sph(r, s, t,
                                                                               weights=w_),
        "trace_sph": lambda r, s, t, *_: tsph.trace_sph(r, s, t, capacity=40000),
        "trace_with_sentinels_sph": lambda r, s, t, *_: tsph.trace_with_sentinels_sph(
            r, s, t, capacity=42000),
        "find_hits": lambda r, s, t, *_: tr.find_hits(r, s, t, 40000),
        "render_column_density": lambda r, s, t, w_: tr.render_column_density(r, s, t, 40000,
                                                                              weights=w_),
    }
    tri_calls = {"trace_closest_hit": mt.trace_closest_hit, "trace_any_hit": mt.trace_any_hit}
    cpu = {k: fn(rays, ss, tree, w) for k, fn in calls.items()}
    cpu.update({k: fn(trays, st, ttree) for k, fn in tri_calls.items()})
    g = lambda x: x.to(dev)
    wk.walk_sph.launches = wk.walk_tri.launches = engine.trace.calls = 0
    card = {k: fn(rays.to(dev), g(ss), tree.to(dev), g(w)) for k, fn in calls.items()}
    card.update({k: fn(trays.to(dev), g(st), ttree.to(dev)) for k, fn in tri_calls.items()})
    torch.cuda.synchronize()
    assert engine.trace.calls == 0
    assert wk.walk_sph.launches == 10 and wk.walk_tri.launches == 2
    for k in cpu:
        a = cpu[k] if isinstance(cpu[k], tuple) else (cpu[k],)
        b = card[k] if isinstance(card[k], tuple) else (card[k],)
        for x, y in zip(a, b):
            y = y.cpu()
            if x.dtype == torch.float32 and k in ("trace_cumulative_sph",
                                                  "render_column_density"):
                torch.testing.assert_close(y, x, rtol=1e-5, atol=1e-6 * float(x.abs().max()))
            elif x.dtype == torch.float32 and k.startswith("trace_") and x.dim() == 1 and \
                    k != "trace_closest_hit":
                torch.testing.assert_close(y, x, rtol=1e-6, atol=1e-6)   # integrals, distances
            else:
                assert torch.equal(y, x), k


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sph", "tri"])
@pytest.mark.parametrize("stack_size", [64, 4])
def test_packet_walk_matches_per_ray_walk(dev, kind, stack_size):
    """The packet walk (route "packet") bit-equal to the per-ray walk (PR
    12's kernel, its restart route) in every mode of ``kind``, on 1,250
    rays (a ragged last warp of 2 lanes) around clustered particles or a
    random mesh, with box-plane rays and rays that miss: no warp restarts
    at a stack of 64, warps restart at 4."""
    from grace_tpu_torch.models import triangle as mt

    rng = np.random.default_rng(23)
    if kind == "sph":
        particles = torch.from_numpy(make_clustered_particles(rng, 3000)).to(dev)
        prims, tree, _ = build_sph_tree(particles, 16)
        centre, spread, length = (0.5, 0.5, 0.5), 0.8, 1.2
        weights = torch.from_numpy((0.5 + rng.random(3000)).astype(np.float32)).to(dev)
    else:
        prims, tree, _ = mt.build_triangle_tree(torch.from_numpy(random_mesh(rng, 2000)).to(dev))
        centre, spread, length, weights = (0.5, 0.5, 0.5), 2.0, 4.0, None
    rays = walk_edge_rays(rng, tree, centre, spread, 1000, length, dev)
    assert rays.n_rays == 1250
    _, restarts = check_walk_routes(kind, rays, prims, tree, kind, stack_size, weights=weights)
    assert (restarts > 0) == (stack_size == 4)


@pytest.mark.cuda
def test_walk_resources_and_rejections(dev):
    """The walk's resource query (the packet kernels hold their stacks in
    shared memory and no local stack; the per-ray walk's 128-entry stack
    is local), and the C entries refusing a stack past 128 entries and an
    unknown mode (the wrappers raise ValueError first)."""
    from grace_tpu_torch.trace import walk as wk

    for kind, modes in (("sph", wk.SPH_MODES), ("tri", wk.TRI_MODES)):
        for mode in modes:
            res = wk.walk_resources(dev, kind, mode, "packet")
            assert res["threads"] == 128 and res["blocks_per_sm"] >= 1
            assert res["shared_bytes"] >= 4 * 1024 and res["local_bytes"] < 512
            res = wk.walk_resources(dev, kind, mode, "per_ray")
            assert res["shared_bytes"] == 0 and res["local_bytes"] >= 512
    particles = torch.from_numpy(make_clustered_particles(np.random.default_rng(2), 500))
    ss, tree, _ = build_sph_tree(particles.to(dev), 8)
    rays = orthographic_projection_rays(8, 8, CAM, LOOK, UP, 1.2, 6.0, device=dev)
    out = (torch.empty(64, dtype=torch.int32, device=dev),)
    with pytest.raises(RuntimeError, match="grace_walk_sph failed"):
        wk._launch_sph(rays, ss, tree, "count", wk.MAX_STACK + 1, None, None, None, 0, out)
    with pytest.raises(ValueError):
        wk.walk_sph(rays, ss, tree, "count", stack_size=wk.MAX_STACK + 1)
    with pytest.raises(ValueError):
        wk.walk_tri(rays, ss, tree, "nearest")
    flags = wk._launch_sph(rays, ss, tree, "count", wk.MAX_STACK, None, None, None, 0, out)
    torch.cuda.synchronize()
    assert int(flags.max()) == 0 and torch.equal(out[0], wk.walk_sph(rays, ss, tree, "count"))


@pytest.mark.cuda
@pytest.mark.parametrize("tag", list(BUILD_CASES))
def test_build_kernels_match_plain_build(dev, tag):
    """build.cu against the plain build on the card, bit for bit: keys,
    permutation, sorted primitives, deltas, phase A's ranges, every Tree
    field; the entry twice (bit-equal) under sync debug mode "error"."""
    check_build_case(tag, *build_case(tag, dev))


@pytest.mark.cuda
def test_build_sentinel_delta_gives_a_valid_tree(dev):
    """A 63-bit XOR delta equal to the sentinel (ROADMAP C19): the climb's
    tree is the valid one, and the plain build's the same, bit for bit."""
    check_sentinel_build(dev)


@pytest.mark.cuda
def test_build_launches_and_refusals(dev):
    """Each entry launches each build kernel once; deltas of another dtype,
    boxes of another shape and a leaf capacity the C entry refuses raise."""
    from grace_tpu_torch.build import lbvh
    from grace_tpu_torch.build.sph import build_primitive_tree, build_sph_tree
    from grace_tpu_torch.ops.primitives import TRIANGLE

    spheres, *_ = build_case("mpl 32 (3000 spheres)", dev)
    tris = torch.rand((500, 3, 3), generator=torch.Generator().manual_seed(5)).to(dev)
    for build, args in ((build_sph_tree, (spheres, 16)),
                        (build_primitive_tree, (tris, TRIANGLE, 8, "xor"))):
        zero_build_counters()
        build(*args)
        assert build_counters() == {"build_morton_keys": 1, "build_deltas": 0,
                                    "build_gather_deltas": 1, "build_lbvh_ranges": 1,
                                    "build_lbvh_nodes": 1}
    mins, maxs = spheres[:, :3], spheres[:, :3] + 0.1
    d = torch.zeros(spheres.shape[0] - 1, device=dev)
    with pytest.raises(TypeError):
        lbvh.build_lbvh(mins, maxs, d.double(), 16)
    with pytest.raises(ValueError):
        lbvh.build_lbvh(mins, maxs[:, :2], d, 16)
    with pytest.raises(RuntimeError, match="grace_lbvh_ranges failed"):
        lbvh.lbvh_ranges(d, spheres.shape[0])
    with pytest.raises(RuntimeError, match="grace_lbvh_ranges failed"):
        lbvh.lbvh_ranges(d, 16, _block=2048)
    _, _, first, count, mark = lbvh.lbvh_ranges(d, 16)
    with pytest.raises(RuntimeError, match="grace_lbvh_nodes failed"):
        lbvh.lbvh_nodes(d, first, count, mark, mark.cumsum(0, dtype=torch.int32), mins,
                        maxs, 16, _block=1)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [2, 32, 64, 100, 256, 1024])
@pytest.mark.parametrize("tag", ["mpl 1 (3000 spheres)", "runs of equal keys, xor (3000)",
                                 "63-bit keys, surface area (3000 spheres)"])
def test_build_climbs_at_every_block(dev, tag, block):
    """Both climbs with `block` items a block (2: nearly every split at
    device scope; 1024: the default) bit-equal to the plain build: split
    ranges and every Tree field."""
    prims, kind, mpl, delta_kind, bits = build_case(tag, dev)
    want = build_stages(prims, kind, mpl, delta_kind, bits, plain=True)
    check_climbs(f"{tag} block {block}", want, kind, mpl, block)


@pytest.mark.cuda
@pytest.mark.parametrize("delta_kind,bits", [("euclidean", 30), ("surface_area", 30),
                                             ("xor", 30), ("xor", 63)])
@pytest.mark.parametrize("prim", ["sphere", "triangle"])
def test_build_gather_deltas_match_torch(dev, prim, delta_kind, bits):
    """grace_gather_deltas bit-equal to prims[perm], perm.to(int32),
    kind.aabb and the plain deltas, for spheres and triangles (with signed
    zeros and tied vertices) and every delta kind; rows past a warp's end
    (n = 1,000,003 spheres, 997 triangles); unaligned spheres refused by
    the C entry."""
    from grace_tpu_torch import _kernels
    from grace_tpu_torch.ops.primitives import SPHERE, TRIANGLE

    rng = np.random.default_rng(7)
    if prim == "sphere":
        kind = SPHERE
        prims = np.concatenate([rng.random((1_000_003, 3)), 0.01 * rng.random((1_000_003, 1))],
                               1).astype(np.float32)
    else:
        kind = TRIANGLE
        prims = rng.random((997, 3, 3)).astype(np.float32)
        zero = rng.random(prims.shape) < 0.3
        prims[zero] = np.where(rng.random(int(zero.sum())) < 0.5, -0.0, 0.0)
    prims = torch.from_numpy(prims).to(dev)
    want = build_stages(prims, kind, 8, delta_kind, bits, plain=True)
    assert check_gather(f"{prim} {delta_kind} {bits}", prims, kind, delta_kind, bits,
                        want) == 0.0
    if prim == "sphere":
        rows = torch.zeros(17 * 4 + 1, device=dev)[1:].view(17, 4)
        out = [torch.empty(17 * k, device=dev) for k in (4, 1, 3, 3)]
        perm = torch.arange(17, device=dev)
        with pytest.raises(RuntimeError, match="grace_gather_deltas failed"):
            _kernels.launch("build", "grace_gather_deltas", dev, rows.data_ptr(),
                            perm.data_ptr(), 0, out[0].data_ptr(), out[1].data_ptr(),
                            out[2].data_ptr(), out[3].data_ptr(), 0, 17, 0, -1)


@pytest.mark.cuda
@pytest.mark.parametrize("tag", list(SPLAT_PREP_CASES))
def test_splat_prep_kernels_match_plain(dev, tag):
    """splat_prep.cu against the plain versions on the card, bit for bit:
    every SplatBuckets field and the sort-free masks, transposed masks,
    coords and slabs."""
    _, side, tiles, band, chunk, _, whole, _ = SPLAT_PREP_CASES[tag]
    s, w = splat_prep_scene(tag)
    spheres = torch.from_numpy(s).to(dev)
    weights = None if w is None else torch.from_numpy(w).to(dev)
    _, overflow = check_splat_prep_case(tag, spheres, weights, side, tiles, band, chunk)
    assert overflow == whole


@pytest.mark.cuda
def test_splat_prep_launches_and_refusals(dev):
    """A bucketed frame launches the keys pass and the pack pass once each,
    a training step the sort-free setup twice (forward and backward), no
    plain version on the card; spheres of another dtype or width and
    weights of another length raise."""
    tag = list(SPLAT_PREP_CASES)[0]
    _, side, (tile_w, tile_h), band, chunk, *_ = SPLAT_PREP_CASES[tag]
    s, _ = splat_prep_scene(tag)
    spheres = torch.from_numpy(s).to(dev)
    cam = sg.OrthoCamera(CAM, LOOK, UP, 1.2, 6.0, side, side)
    zero_prep_counters()
    sp.render_ortho_splat(spheres, CAM, LOOK, UP, 1.2, 6.0, side, side, tile_w=tile_w,
                          tile_h=tile_h, chunk=chunk, band=band)
    x = spheres.clone().requires_grad_(True)
    sg.make_splat_trainer(cam, tile_w, tile_h)(x, None).sum().backward()
    torch.cuda.synchronize()
    assert prep_counters() == {"splat_bucket_keys": 1, "splat_bucket_pack": 1,
                               "sortfree_setup": 2}
    args = (CAM, LOOK, UP, 1.2, 6.0, side, side)
    with pytest.raises(TypeError):
        sp.bucket_prims_ortho(spheres.double(), *args, tile_w=tile_w, tile_h=tile_h)
    with pytest.raises(ValueError):
        sp.bucket_prims_ortho(spheres[:, :3], *args, tile_w=tile_w, tile_h=tile_h)
    with pytest.raises(ValueError):
        sp.bucket_prims_ortho(spheres, *args, tile_w=tile_w, tile_h=tile_h,
                              weights=torch.ones(3, device=dev))
    with pytest.raises(TypeError):
        sg.sortfree_setup(spheres.double(), None, cam, tile_w, tile_h)
    with pytest.raises(ValueError):
        sg.sortfree_setup(spheres, torch.ones(3, device=dev), cam, tile_w, tile_h)
    for n_keys in (256, 4096):   # counters in shared memory, and in device memory
        for name, res in sp.bucket_resources(dev, n_keys).items():
            assert res["local_bytes"] == 0 and res["threads"] == 256, (name, res)
            assert res["blocks_per_sm"] >= 1, (name, res)


@pytest.mark.cuda
@pytest.mark.parametrize("tag", list(BROADPHASE_CASES))
def test_broadphase_kernels_match_plain(dev, tag):
    """broadphase.cu against the plain versions on the card: boxes equal
    (zero signs free), every word, summary word, list, count and flag bit
    for bit."""
    from grace_tpu_torch.core.types import Rays

    s, o, d, ln = broadphase_scene(tag)
    rays = Rays.from_arrays(o, d, ln, device=dev)
    check_broadphase_case(tag, torch.from_numpy(s).to(dev), rays, BROADPHASE_CASES[tag][2])


@pytest.mark.cuda
@pytest.mark.parametrize("tag", list(KEY_CASES))
def test_build_keys_match_plain(dev, tag):
    """E2's keys in one launch on the card at every key case (the box
    folded in the launch, also at grids capped at 1-3 blocks; given as
    f32[3] or a scalar; NaN, +-0 and +-inf points; the conversion's edges
    at scale 1, which hold cvt.rzi's saturation to the plain f64 clamp;
    rays by their midpoints, with order, inverse and sorted rays): bit for
    bit against the plain versions on the card."""
    got, want = key_outputs(tag, dev, False), key_outputs(tag, dev, True)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and torch.equal(
            g.view(torch.int32) if g.dtype == torch.float32 else g,
            w.view(torch.int32) if w.dtype == torch.float32 else w), (tag, name)


@pytest.mark.cuda
def test_build_keys_one_launch_and_resources(dev):
    """morton_keys_sph and spatial_sort_rays' keys are one launch each
    (no amin / amax); path 1's 512^2 rays sort bit-equal to the plain
    chain; the folding kernels hold no local memory."""
    from grace_tpu_torch.build import lbvh
    from grace_tpu_torch.build.sph import morton_keys_sph
    from grace_tpu_torch.ops import morton

    spheres = torch.from_numpy(make_clustered_particles(np.random.default_rng(3), 100_000)).to(dev)
    rays = orthographic_projection_rays(512, 512, CAM, LOOK, UP, 1.2, 6.0, device=dev)
    before = morton.morton_keys_cuda.launches
    morton_keys_sph(spheres)
    spatial_sort_rays(rays)
    assert morton.morton_keys_cuda.launches - before == 2
    assert len(check_keys(dev, rays)) == len(KEY_CASES) + 1
    for kernel in ("morton_keys", "morton_keys_rays"):
        res = lbvh.build_resources(dev, kernel)
        assert res["local_bytes"] == 0 and res["blocks_per_sm"] >= 1, (kernel, res)


@pytest.mark.cuda
@pytest.mark.parametrize("tag", list(COMPACT_CASES))
def test_compaction_matches_plain(dev, tag):
    """E6's compaction on the card at every compaction case (rows of every
    bit at max_q equal to, under and over their count; counts at max_q -
    1, max_q, max_q + 1; unaligned rows of ids; 4-byte word loads; no
    words, no rows, max_q 0): ids, n and overflow bit for bit."""
    check_compaction(dev, tags=(tag,))


@pytest.mark.cuda
def test_compaction_resources(dev):
    """Both load routes of the compaction hold no local memory; four warps
    a block."""
    from grace_tpu_torch.trace import pallas_broadphase as pb

    for vec in (True, False):
        res = pb.compact_words_resources(dev, vec)
        assert res["local_bytes"] == 0 and res["threads"] == 128, res


@pytest.mark.cuda
@pytest.mark.parametrize("tag", list(BOX_SET_CASES))
def test_broadphase_boxes_match_plain(dev, tag):
    """The boxes' one launch on the card at both blocks: both parts and each
    alone equal to the plain versions, NaN at the same places (zero signs
    free); the kernel holds no local memory on either ray route."""
    from grace_tpu_torch.trace import pallas_broadphase as pb

    check_box_set_case(tag, dev)
    for vec in (True, False):
        res = pb.broadphase_boxes_resources(dev, vec)
        assert res["local_bytes"] == 0 and res["threads"] == 256, res


@pytest.mark.cuda
@pytest.mark.parametrize("tag", list(TRI_LIST_CASES))
def test_tri_lists_kernel_matches_plain(dev, tag):
    """tri_lists.cu against _dense_tile_segments_tri_plain on the card: ids,
    counts and flags bit for bit, distances too (NaN where the plain
    version's are)."""
    _, _, tile, max_chunks, k = TRI_LIST_CASES[tag]
    rays, tris = tri_list_inputs(tag, dev)
    check_tri_lists_case(tag, rays, tris, tile, max_chunks, k)


@pytest.mark.cuda
def test_tri_lists_device_memory_route(dev, monkeypatch):
    """The device scratch's sort and the boxes from device memory forced on
    the torus through the module's limits (a warp's buffer of 4 entries,
    boxes staged up to 8 segments, fewer scratch rows than tiles): the same
    bits as the plain version."""
    monkeypatch.setattr(pt, "WARP_BUF", 4)
    monkeypatch.setattr(pt, "STAGE_SEGS", 8)
    monkeypatch.setattr(pt, "SORT_SLOTS", 5)
    tag = list(TRI_LIST_CASES)[0]
    _, _, tile, max_chunks, k = TRI_LIST_CASES[tag]
    rays, tris = tri_list_inputs(tag, dev)
    check_tri_lists_case(tag, rays, tris, tile, max_chunks, k)


@pytest.mark.cuda
def test_broadphase_launches_and_refusals(dev, scene):
    """A quarter trace launches the boxes (both sets in one launch) and the
    overlap kernel once each, a qlist trace adds the compaction, a triangle
    trace the list kernel, and no plain version runs on the card; the
    wrappers refuse what the kernels do not take."""
    ss, rays = scene
    zero_broadphase_counters()
    pk.pallas_trace_sph(rays, ss, tile=64, broadphase="quarter")
    assert broadphase_counters() == {"broadphase_boxes": 1, "overlap_words": 1,
                                     "compact_words": 0, "tri_tile_lists": 0}
    pk.pallas_trace_sph(rays, ss, tile=64, broadphase="qlist", max_chunks=512)
    tris = torch.from_numpy(random_mesh(np.random.default_rng(4), 500)).to(dev)
    pt.pallas_trace_tri(rays, tris)
    torch.cuda.synchronize()
    assert broadphase_counters() == {"broadphase_boxes": 2, "overlap_words": 2,
                                     "compact_words": 1, "tri_tile_lists": 1}
    from grace_tpu_torch.trace import broadphase as bp
    from grace_tpu_torch.trace import pallas_broadphase as pb

    with pytest.raises(ValueError, match="block"):
        pb.segment_aabbs(ss, 64)
    with pytest.raises(TypeError):
        pb.segment_aabbs(ss.double(), 32)
    with pytest.raises(TypeError):
        pb.compact_mask_words(torch.zeros((4, 2), dtype=torch.int64, device=dev), 8)
    with pytest.raises(ValueError, match="multiple"):
        bp.tile_aabbs(pk._pad_rays(rays, 64)[:100], 64)
    with pytest.raises(ValueError, match="intervals"):
        pt.pallas_trace_tri(rays, tris, n_cull_intervals=pt.MAX_INTERVALS + 1)
    # an unaligned sphere view is copied to an aligned one, not refused
    odd = torch.empty(ss.numel() + 1, device=dev)[1:].view(-1, 4)
    odd.copy_(ss)
    assert odd.data_ptr() % 16
    assert torch.equal(pb.segment_aabbs(odd, 32)[0], pb.segment_aabbs(ss, 32)[0])


@pytest.mark.cuda
def test_overlap_words_box_cases_and_resources(dev):
    """The overlap kernel on given boxes (NaN columns and rows, a word of
    NaN columns, boxes touching at -0 and +0, ragged words and strips, no
    rows, no columns), summary on and off, bit-equal to
    overlap_words_reference; the overlap and sort-free setup kernels hold
    no local memory (8 warps a block with the strip staged; 32 warps, a warp
    a segment)."""
    from grace_tpu_torch.trace import pallas_broadphase as pb

    check_overlap_boxes(dev)
    res = pb.overlap_words_resources(dev)
    assert res["local_bytes"] == 0 and res["threads"] == 256 and res["blocks_per_sm"] >= 2, res
    res = sg.sortfree_setup_resources(dev)
    assert res["local_bytes"] == 0 and res["threads"] == 1024 and res["blocks_per_sm"] >= 1, res


SEGSORT_ALL = ([("rows", t) for t in SEGSORT_ROW_CASES] + [("flat", t) for t in SEGSORT_FLAT_CASES]
               + [("csr", t) for t in SEGSORT_CSR_CASES])


@pytest.mark.cuda
@pytest.mark.parametrize("kind,tag", SEGSORT_ALL)
def test_segsort_kernels_match_grace_tpu_order(dev, kind, tag):
    """segsort.cu's entries bit-equal to the plain version run on the CPU
    (grace_tpu's order, which the CPU tests hold it to); the card's plain
    version is only compared: where its torch.sort departs (NaNs),
    that is the card's library, not the kernel (ROADMAP C25)."""
    check_segsort_case(kind, tag, segsort_case_args(kind, tag, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,tag", [("rows", list(SEGSORT_ROW_CASES)[1]),
                                      ("rows", list(SEGSORT_ROW_CASES)[2]),
                                      ("csr", list(SEGSORT_CSR_CASES)[0]),
                                      ("csr", list(SEGSORT_CSR_CASES)[3]),
                                      ("csr", list(SEGSORT_CSR_CASES)[5]),
                                      ("csr", list(SEGSORT_CSR_CASES)[8]),
                                      ("csr", list(SEGSORT_CSR_CASES)[9])])
def test_segsort_long_route_small_chunks(dev, kind, tag, monkeypatch):
    """The long route forced with chunks of 128 (several merge rounds; the
    capacity padding in the last ray's segment merged, as a segment of its
    own copied): the same bits."""
    from grace_tpu_torch.ops import segops

    monkeypatch.setattr(segops, "SEG_CHUNK", 128)
    check_segsort_case(kind, tag, segsort_case_args(kind, tag, dev))


@pytest.mark.cuda
def test_segsort_launches_without_a_host_sync(dev, scene):
    """sort_records_by_distance, records_to_flat, trace_sph(engine="pallas")
    and sort_by_distance with a device total_hits launch one wrapper each,
    under torch.cuda.set_sync_debug_mode("error"); the wrappers refuse
    what the kernels do not take."""
    from grace_tpu_torch.ops import segops
    from grace_tpu_torch.trace.sph import trace_sph

    ss, rays = scene
    rec = prc.pallas_trace_sph_records(rays, ss, 128)
    total = rec.counts.sum(dtype=torch.int32)
    capacity = int(total)
    torch.cuda.synchronize()
    zero_segsort_counters()
    torch.cuda.set_sync_debug_mode("error")
    try:
        srt = prc.sort_records_by_distance(rec)
        flat = prc.records_to_flat(rec, capacity)
        got = segops.sort_by_distance(flat[4], flat[0], flat[2], flat[3], total_hits=total)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    tr = trace_sph(rays, ss, None, capacity=capacity, engine="pallas", per_ray_capacity=128)
    torch.cuda.synchronize()
    assert segsort_counters() == {"sort_rows": 1, "segmented_sort": 1, "records_to_flat": 2}
    assert "bit-equal" in segsort_gate(rec, srt, tr, got)
    assert torch.equal(tr.indices, flat[2]) and torch.equal(tr.offsets, flat[0])
    with pytest.raises(TypeError):
        prc.sort_records_by_distance(rec._replace(distances=rec.distances.double()))
    with pytest.raises(ValueError, match="capacity"):
        prc.records_to_flat(rec, -1)
    with pytest.raises(TypeError):
        segops.sort_by_distance(flat[4], flat[0].double(), flat[2])
    with pytest.raises(TypeError):
        segops.sort_by_distance(flat[4], flat[0], flat[2], flat[3].double())


@pytest.mark.cuda
def test_records_to_flat_is_a_memset_and_one_launch(dev, scene):
    """records_to_flat on CUDA tensors makes two device operations, the
    look-back state's memset and E10's kernel (no torch scan before it),
    and gives the same bits with the look-back forced over many blocks."""
    from chip_smoke import device_ops

    ss, rays = scene
    rec = prc.pallas_trace_sph_records(rays, ss, 128)
    capacity = int(rec.counts.sum()) + 3
    ops = device_ops(lambda: prc.records_to_flat(rec, capacity))
    assert len(ops) == 2 and sum("records_flat_kernel" in n for n in ops) == 1, ops
    want = prc._records_to_flat_plain(rec, capacity, sentinel_slots=True)
    for rows in (1, 5, prc.FLAT_ROWS, 512):
        got = prc.records_to_flat_cuda(rec, capacity, sentinel_slots=True, _rows=rows)
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int32) if g.dtype == torch.float32 else g,
                               w.view(torch.int32) if w.dtype == torch.float32 else w), rows


@pytest.mark.cuda
@pytest.mark.parametrize("n_stage", [3, 10])
@pytest.mark.parametrize("kernel", ["sort_rows (512)", "sort_rows (1,024)", "sort_segments",
                                    "seg_heads", "seg_count", "seg_starts", "seg_long_scan",
                                    "seg_check", "seg_chunks", "seg_merge", "seg_gather",
                                    "records_to_flat", "records_to_flat (scalar rows)"])
def test_segsort_resources(dev, kernel, n_stage):
    """Every segsort.cu kernel keeps its state in registers and shared
    memory (no local bytes) and fits on an SM; the sort kernels with
    path 4's three staged arrays and with the most (keys, mask and eight
    payloads) hold at least a block an SM."""
    from grace_tpu_torch.ops import segops

    res = segops.segsort_resources(dev, kernel, n_stage)
    assert res["local_bytes"] == 0, res
    assert res["blocks_per_sm"] >= 1 and res["threads"] % 32 == 0, res
    if kernel.startswith("sort"):
        assert res["shared_bytes"] <= 227 * 1024, res
