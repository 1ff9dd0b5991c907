"""The ctypes bindings of grace_tpu_torch's CUDA kernels against their
sources, on the CPU (no nvcc needed): every declared C entry point exists
in its source with the declared arguments, the constants Python shares
with a kernel agree, and the wrappers' alignment helper gives the 16-byte
addresses that the kernels' cp.async copies need."""

import os
import re

import pytest
import torch

from grace_tpu_torch import _kernels
from grace_tpu_torch.trace import pallas_kernel as pk
from grace_tpu_torch.trace import pallas_render as pr
from grace_tpu_torch.trace import pallas_tri as pt
from grace_tpu_torch.trace import splat as sp
from grace_tpu_torch.trace import splat_grad as sg

ENTRIES = [(name, entry, kinds) for name, (_, _, entries) in _kernels.KERNELS.items()
           for entry, kinds in entries.items()]


def _source(name):
    with open(os.path.join(_kernels.CSRC, _kernels.KERNELS[name][0])) as f:
        return f.read()


@pytest.mark.parametrize("name,entry,kinds", ENTRIES, ids=[e for _, e, _ in ENTRIES])
def test_entry_point_matches_its_source(name, entry, kinds):
    """The C signature takes the declared pointers and ints, then the
    device index and the stream, and returns int."""
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", _source(name))
    assert m, f"{entry} not defined in {_kernels.KERNELS[name][0]}"
    params = [p.strip() for p in m.group(1).split(",")]
    assert len(params) == len(kinds) + 2
    for p, k in zip(params, kinds):
        assert ("*" in p) == (k == "p"), (p, k)
    assert params[-2] == "int device" and params[-1] == "void* stream"


def test_shared_constants_agree():
    render = _source("render")
    assert re.search(rf"kBwdBatch = {pr.BWD_BATCH};", render)
    assert re.search(rf"kRayTile = {pr.BWD_TILE};", render)
    stage = open(os.path.join(_kernels.CSRC, "stage.cuh")).read()
    assert re.search(rf"kMaxTile = {pk.MAX_TILE};", stage)
    assert re.search(rf"kSegShift = {pk.SEG.bit_length() - 1};", _source("trace_bitmask"))
    tri = _source("tri")
    assert re.search(rf"kMaxChunk = {pt.CHUNK};", tri)
    for name, value in (("kEps", pt.EPS), ("kBig", pt.BIG)):
        assert float(re.search(name + r" = ([0-9.e+-]+)f;", tri).group(1)) == value


def test_splat_constants_agree():
    """The wrappers size the splat kernels' batches and check their patches
    with splat_common.cuh's constants and shared-memory layout."""
    common = open(os.path.join(_kernels.CSRC, "splat_common.cuh")).read()
    consts = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", common):
        consts[name] = eval(expr, {}, dict(consts))   # e.g. "kThreads / 32", "227 * 1024"
    assert consts["kRows"] == sp.ROWS
    assert consts["kWarps"] * consts["kMaxNT"] == sp.MAX_TASKS
    assert consts["kMaxShared"] == 227 * 1024
    assert consts["kMaxBatch"] == sp.MAX_BATCH
    assert 1 <= sp.SPLAT_BATCH <= sp.MAX_BATCH and 1 <= sg.FWD_BATCH <= sp.MAX_BATCH
    # the sort-free forward's own shared memory (batch_size's extra)
    fwd = _source("splat_sortfree")
    fwd = fwd[fwd.index("size_t fwd_smem_bytes"):]
    assert "2 * splat::kWarps * sizeof(int));" in fwd[:fwd.index("}")]
    assert sg.FWD_EXTRA == 2 * consts["kWarps"] * 4
    # at the bench patch (32 x 32, rank 5, deg 8) a batch of 64 fits, and
    # the largest batch; at 64 x 64, 89 instances' factors fill 227 KB
    assert sp.batch_size(32, 32, 5, 8, 64) == 64 and sp.batch_size(32, 32, 5, 8, 10**6) == 128
    assert sp.batch_size(64, 64, 5, 8, 10**6) == 89
    assert sp.batch_size(8192, 1, 5, 8, 64) == 0      # too many (strip, group) tasks


@pytest.mark.parametrize("entry,position", [("grace_splat", 4), ("grace_splat_sortfree_fwd", 1)])
def test_splat_entries_take_the_launch_order(entry, position):
    """The splat kernels take an i32 launch order (null: as listed) at the
    argument the wrappers pass it."""
    name = "splat" if entry == "grace_splat" else "splat_sortfree"
    params = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", _source(name)).group(1)
    assert params.split(",")[position].split() == ["const", "int32_t*", "order"]


@pytest.mark.parametrize("entry,position", [("grace_splat_sortfree_bwd", None),
                                            ("grace_render_fwd", 2)])
def test_training_entries_take_the_launch_order(entry, position):
    """The fused forward takes an i32 launch order (null: as listed) at the
    argument its wrapper passes it, and refuses an unaligned slab (it
    stages with 16-byte copies); the sort-free backward takes none (block
    b runs segment b) and refuses a tile past a block's shared memory."""
    name = "splat_sortfree" if entry == "grace_splat_sortfree_bwd" else "render"
    src = _source(name)
    params = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src).group(1)
    params = [p.split() for p in params.split(",")]
    body = src[src.index(f'extern "C" int {entry}('):]
    body = body[:body.index("cudaSetDevice")]
    if position is None:
        assert ["const", "int32_t*", "order"] not in params
        assert params[:2] == [["const", "int32_t*", "masks_t"], ["const", "float*", "coords"]]
        assert "!bwd_valid(tile_w, tile_h, rank, deg)" in body
        assert "bwd_smem_bytes(tile_w, tile_h, rank, deg) <= splat::kMaxShared" in src
    else:
        assert params[position] == ["const", "int32_t*", "order"]
        assert params[position + 2] == ["const", "float*", "prims"]
        assert "!aligned16(prims)" in body


@pytest.mark.parametrize("entry,position", [("grace_records_quarter", 2),
                                            ("grace_records_bitmask", 1)])
def test_record_entries_take_the_launch_order(entry, position):
    """The record kernels take an i32 launch order (null: as listed) at the
    argument the wrappers pass it, and a 16-byte aligned slab after the
    rays."""
    params = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", _source("records")).group(1)
    params = [p.split() for p in params.split(",")]
    assert params[position] == ["const", "int32_t*", "order"]
    assert params[position + 1] == ["const", "float*", "rays"]
    assert params[position + 2] == ["const", "float*", "prims"]


def test_record_constants_agree():
    """records.cu's group sizes are the wrappers' segment and quarter, and
    its batch holds whole segments (its ids array: up to 8 segments or 32
    quarters a batch)."""
    src = _source("records")
    consts = {name: int(v) for name, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert 1 << consts["kSegShift"] == pk.SEG and 1 << consts["kQuarterShift"] == pk.QUARTER
    assert consts["kBatch"] % pk.SEG == 0 and consts["kBatch"] <= 1024
    assert consts["kStageBuffers"] in (1, 2)
    # pending slots a ray, at an odd stride
    assert consts["kPending"] > 0 and consts["kPending"] % 2 == 0
    assert "constexpr int kStride = kPending + 1;" in src
    assert "records_launch_ok(tile, cap, deg, prims)" in src and "aligned16(prims)" in src


@pytest.mark.parametrize("offset", [0, 1, 4])
def test_aligned_gives_16_byte_addresses(offset):
    base = torch.arange(64, dtype=torch.float32)
    view = base[offset:offset + 32]
    out = _kernels.aligned(view)
    assert out.data_ptr() % 16 == 0 and torch.equal(out, view)
    assert (out.data_ptr() == view.data_ptr()) == (view.data_ptr() % 16 == 0)
    t = _kernels.aligned(base.reshape(8, 8).t())
    assert t.is_contiguous() and t.data_ptr() % 16 == 0


def test_walk_constants_agree():
    """bvh_walk.cu's stack cap, mode numbers and triangle epsilon are the
    wrapper's (trace/walk.py) and the engine's intersection's; its pruning
    threshold, routes, stats fields and warp size are the wrapper's, and
    its C entries take the arguments the binding declares."""
    from grace_tpu_torch.models import triangle as mt
    from grace_tpu_torch.trace import walk

    src = _source("bvh_walk")
    assert re.search(rf"constexpr int kMaxStack = {walk.MAX_STACK};", src)
    names = {"count": "kCount", "cumulative": "kCumulative", "records": "kRecords",
             "ids": "kIds", "closest": "kClosest", "any": "kAny"}
    for modes in (walk.SPH_MODES, walk.TRI_MODES):
        for i, mode in enumerate(modes):
            assert re.search(rf"constexpr int {names[mode]} = {i};", src), mode
    assert float(re.search(r"kEps = ([0-9.e+-]+)f;", src).group(1)) == mt.EPS
    # the walk runs the engine's rounding: no nvcc contraction, NaN-propagating min/max
    assert _kernels.KERNELS["bvh_walk"][1] == ["--fmad=false"]
    assert "fminf(a, b)" in src and "a != a || b != b" in src
    # the packet walk: pruning threshold, routes, stats, warps of 32 a block
    assert re.search(rf"constexpr int kPruneStack = {walk.PRUNE_STACK};", src)
    for i, route in enumerate(walk.ROUTES):
        name = {"packet": "kPacket", "per_ray": "kPerRay"}[route]
        assert re.search(rf"constexpr int {name} = {i};", src), route
    assert re.search(rf"constexpr int kStats = {len(walk.STATS_FIELDS)};", src)
    consts = {n: int(v) for n, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert consts["kThreads"] % walk.WARP == 0 and 0 <= consts["kPairLanes"] <= walk.WARP
    assert consts["kChunk"] == walk.WARP and "constexpr int kRedo = -1;" in src
    # each C entry's parameters: pointers and ints in the binding's order,
    # then the device and the stream
    for entry, kinds in _kernels.KERNELS["bvh_walk"][2].items():
        params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src).group(1).split(",")
        got = "".join("p" if "*" in p else "i" for p in params[:-2])
        assert got == kinds, entry
        assert params[-2].split() == ["int", "device"] and "stream" in params[-1]


def test_build_constants_agree():
    """build.cu's delta kinds and mantissa width are the wrapper's
    (build/deltas.py), it keeps the plain build's f32 rounding
    (--fmad=false) and torch.minimum's NaN rule, and its C entries take
    the arguments the binding declares."""
    from grace_tpu_torch.build import deltas as bd

    src = _source("build")
    names = {"euclidean": "kEuclidean", "surface_area": "kSurfaceArea", "xor30": "kXor30",
             "xor63": "kXor63"}
    for i, kind in enumerate(bd.KINDS):
        assert re.search(rf"constexpr int {names[kind]} = {i};", src), kind
    assert "constexpr int kMantissaBits = 26;" in src
    assert _kernels.KERNELS["build"][1] == ["--fmad=false"]
    assert "a != a ? a : (b != b ? b : fminf(a, b))" in src
    assert set(_kernels.KERNELS["build"][2]) == {"grace_morton_keys", "grace_deltas",
                                                 "grace_gather_deltas", "grace_lbvh_ranges",
                                                 "grace_lbvh_nodes", "grace_build_resources"}
    for entry, kinds in _kernels.KERNELS["build"][2].items():
        params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src).group(1).split(",")
        assert "".join("p" if "*" in p else "i" for p in params[:-2]) == kinds, entry
        assert params[-2].split() == ["int", "device"] and "stream" in params[-1]


def test_build_entries_take_the_wrappers_arguments(monkeypatch):
    """The gather, the two climbs and the resource query get the arguments
    their C entries declare: the primitive and delta kinds at build.cu's
    values (no deltas: -1, no boxes and no keys: null pointers), the
    climb's 64-bit flags and mark in one buffer of 3N - 2 ints, phase B's
    own flags and max_per_leaf, the default block 0 (build.cu's
    default_block, at most kBlock = 1024) unless a test asks for another."""
    import ctypes

    from grace_tpu_torch.build import deltas as bd
    from grace_tpu_torch.build import lbvh

    src = _source("build")
    assert "constexpr int kSphere = 0;" in src and "constexpr int kTriangle = 1;" in src
    assert list(bd.GATHER_PRIMS) == ["sphere", "triangle"]
    assert "constexpr int kBlock = 1024;" in src
    assert src.count("if (block == 0) block = default_block(n);") == 2
    fns = src[src.index("const void* fns[6]"):]
    fns = re.findall(r"(\w+)_kernel\b", fns[:fns.index("};")])
    assert list(dict.fromkeys(fns)) == ["morton_keys", "deltas", "gather_deltas", "ranges",
                                        "nodes"]
    assert lbvh.RESOURCE_KERNELS == ("morton_keys", "deltas", "gather_deltas", "lbvh_ranges",
                                     "lbvh_nodes", "morton_keys_rays")
    # the keys: the wrappers' block and grid cap are build.cu's; a folding
    # grid of 132 SMs' resident blocks fits the cap; their launch is
    # cooperative, with one grid barrier
    from grace_tpu_torch.ops import morton

    consts = {name: int(v) for name, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert consts["kThreads"] == morton.KEY_THREADS
    assert 132 * consts["kFoldBlocksPerSm"] <= morton.KEY_BLOCKS and consts["kHeld"] >= 0
    assert src.count("cooperative_groups::this_grid().sync()") == 1
    assert "cudaLaunchCooperativeKernel" in src
    calls = []
    monkeypatch.setattr(_kernels, "launch", lambda name, entry, dev, *args: calls.append(
        (entry, args)))

    def check(entry, args):
        kinds = _kernels.KERNELS["build"][2][entry]
        assert len(args) == len(kinds), entry
        for a, k in zip(args, kinds):
            assert isinstance(a, int), (entry, a)
        return args

    n = 37
    spheres = torch.rand((n, 4))
    tris = torch.rand((n, 3, 3))
    perm = torch.randperm(n)
    keys = torch.arange(n, dtype=torch.int64)
    for prim, rows, kind, boxes in (("sphere", spheres, "euclidean", True),
                                    ("triangle", tris, "xor63", True),
                                    ("sphere", spheres, None, False)):
        out = bd.gather_deltas_cuda(rows, prim, perm, keys, kind, boxes)
        args = check(*calls.pop())
        assert args[-3:] == (n, list(bd.GATHER_PRIMS).index(prim),
                             -1 if kind is None else bd.KINDS.index(kind))
        assert (args[2] == 0) == (kind is None or not kind.startswith("xor"))
        assert (args[5] == 0) == (args[6] == 0) == (not boxes)
        assert (args[7] == 0) == (kind is None)
        assert out[0].shape == rows.shape and out[1].dtype == torch.int32
        assert out[4] is None if kind is None else out[4].shape == (n - 1,)
    with pytest.raises(ValueError):
        bd.gather_deltas_cuda(tris, "sphere", perm)
    with pytest.raises(ValueError):
        bd.gather_deltas_cuda(spheres, "sphere", perm.int())
    with pytest.raises(ValueError):
        bd.gather_deltas_cuda(spheres, "sphere", perm, None, "xor30")
    d = torch.rand(n - 1)
    l, r, first, count, mark = lbvh.lbvh_ranges(d, 4)
    args = check(*calls.pop())
    assert args[-4:] == (n, 4, 1, 0)
    assert args[5] == mark.data_ptr() - 8 * (n - 1) and mark.shape == (n,)
    assert mark.untyped_storage().nbytes() == 4 * (3 * n - 2)
    lbvh.lbvh_ranges(d, 4, _block=32)
    assert check(*calls.pop())[-4:] == (n, 4, 1, 32)
    mins = torch.rand((n, 3))
    lbvh.lbvh_nodes(d.long(), first, count, mark, mark, mins, mins, 4, _block=64)
    args = check(*calls.pop())
    assert args[-4:] == (n, 4, 0, 64)
    lbvh.lbvh_nodes(d, first, count, mark, mark, mins, mins, 4)
    args = check(*calls.pop())
    assert args[-4:] == (n, 4, 1, 0)
    monkeypatch.setattr(ctypes, "addressof", lambda out: 1)
    with pytest.raises(ValueError):
        lbvh.build_resources("cpu", "lbvh_climb")
    lbvh.build_resources("cpu", "lbvh_nodes", False)
    assert check(*calls.pop())[1:] == (4, 0)


@pytest.mark.parametrize("delta_kind,bits", [("euclidean", 30), ("surface_area", 63),
                                             ("xor", 30), ("xor", 63)])
def test_gather_for_maps_the_build_kinds(delta_kind, bits):
    """Spheres and triangles take the one-launch gather with grace_deltas'
    kind of ``delta_kind`` (XOR by the key bits); other primitive kinds take
    none; an unknown delta kind is refused."""
    from grace_tpu_torch.build import deltas as bd
    from grace_tpu_torch.ops.primitives import SPHERE, TRIANGLE

    for kind, prim in ((SPHERE, "sphere"), (TRIANGLE, "triangle")):
        got = bd.gather_for(kind, delta_kind, bits)
        assert got[0] == prim and got[0] in bd.GATHER_PRIMS and got[1] in bd.KINDS
        assert got[1] == (f"xor{bits}" if delta_kind == "xor" else delta_kind)
        with pytest.raises(ValueError):
            bd.gather_for(kind, "morton", bits)
    other = SPHERE._replace(centroid=lambda p: p[:, :3])
    assert bd.gather_for(other, delta_kind, bits) is None


@pytest.mark.parametrize("delta_kind,bits", [("euclidean", 30), ("surface_area", 63),
                                             ("xor", 30), ("xor", 63)])
def test_build_on_cpu_tensors_takes_the_plain_version(monkeypatch, delta_kind, bits):
    """CPU tensors take every step's plain version: no kernel is launched
    or counted, and the build equals the one that ``plain=True`` asks for."""
    import numpy as np

    from grace_tpu_torch.build import deltas as bd
    from grace_tpu_torch.build import lbvh
    from grace_tpu_torch.build.sph import build_primitive_tree, build_sph_tree
    from grace_tpu_torch.ops import morton
    from grace_tpu_torch.ops.primitives import TRIANGLE

    def refuse(*args):
        raise AssertionError("a CPU build launched a kernel")

    monkeypatch.setattr(_kernels, "launch", refuse)
    counters = (morton.morton_keys_cuda, bd.deltas_cuda, bd.gather_deltas_cuda, lbvh.lbvh_ranges,
                lbvh.lbvh_nodes)
    for fn in counters:
        monkeypatch.setattr(fn, "launches", 0)
    rng = np.random.default_rng(3)
    s = torch.from_numpy(np.concatenate([rng.random((500, 3)), 0.02 + 0.03 * rng.random(
        (500, 1))], axis=1).astype(np.float32))
    tris = torch.from_numpy(rng.random((300, 3, 3)).astype(np.float32))
    for build, args in ((build_sph_tree, (s, 8, delta_kind, bits)),
                        (build_primitive_tree, (tris, TRIANGLE, 4, delta_kind, bits))):
        (sp, tree, perm), (sp_p, tree_p, perm_p) = build(*args), build(*args, plain=True)
        assert torch.equal(sp, sp_p) and torch.equal(perm, perm_p)
        for f in ("children", "child_aabbs", "leaves", "root", "n_nodes", "n_leaves"):
            assert torch.equal(getattr(tree, f), getattr(tree_p, f)), f
    assert all(fn.launches == 0 for fn in counters)


def test_splat_prep_constants_agree():
    """splat_prep.cu's segment width and constant layouts are the
    wrappers': SEG particles a segment, the bucketed setup's 17 and the
    sort-free setup's 13 f32 constants; its entries build with
    --fmad=false, as the plain path rounds every operation alone, and each
    refuses what it does not take before it touches the device; E4's two
    passes take whole warps (at most 8, a byte each in a key's word of
    warp counts), their cursors and words fit the 48 KB a block gets
    without asking up to BUCKET_SHARED_BINS bins, bucket_blocks keeps
    the counters within BUCKET_COUNTS and the resources query gives both
    passes; the sort-free setup's block is 32 warps, a warp a segment, with
    a query of its resources."""
    src = _source("splat_prep")
    consts = {name: int(v) for name, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert consts["kSeg"] == sg.SEG and consts["kSegsPerBlock"] == 32
    assert "kSetupWarps = kSegsPerBlock;" in src
    assert consts["kTileStep"] + 1 == sp.BUCKET_CONSTS and consts["kLength"] + 1 == sg.SETUP_CONSTS
    _, flags, entries = _kernels.KERNELS["splat_prep"]
    assert flags == ["--fmad=false"]
    assert set(entries) == {"grace_splat_bucket_keys", "grace_splat_bucket_pack",
                            "grace_splat_bucket_resources", "grace_sortfree_setup",
                            "grace_sortfree_setup_resources"}
    for entry in entries:
        body = src[src.index(f'extern "C" int {entry}('):]
        body = body[:body.index("cudaSetDevice")]
        assert "cudaErrorInvalidValue" in body
    threads = consts["kPrepThreads"]
    assert threads % 32 == 0 and threads // 32 <= 8 and consts["kLoads"] >= 1
    # pass 2's 4 cursors (i32) and 4 words of warp counts (u64) a bin
    assert consts["kSharedBins"] == sp.BUCKET_SHARED_BINS
    assert 48 * consts["kSharedBins"] <= 48 * 1024
    assert sp.bucket_blocks(1 << 20, 256) == (sp.BUCKET_TILE, (1 << 20) // sp.BUCKET_TILE)
    assert sp.bucket_blocks(0, 256) == (sp.BUCKET_TILE, 1)
    tile, blocks = sp.bucket_blocks(1 << 20, 1 << 20)
    assert tile * blocks >= 1 << 20 and 4 * ((1 << 20) + 2) * blocks <= 2 * sp.BUCKET_COUNTS
    assert entries["grace_splat_bucket_resources"] == "pi"
    assert "out + 6" in src[src.index('extern "C" int grace_splat_bucket_resources('):]


def test_broadphase_constants_agree():
    """broadphase.cu's segment width and tri_lists.cu's interval limit,
    staged boxes, warp buffer and BIG are the wrappers'; both libraries
    build with --fmad=false (the endpoints' and distances' rounding is the
    plain versions'), every entry (the list kernel's resources query too)
    refuses what it does not take before it touches the device, and the
    list kernel's staged boxes and warp areas at the limits fit a block's
    227 KB of shared memory."""
    from grace_tpu_torch.trace import pallas_broadphase as pb

    bp_src, tri_src = _source("broadphase"), _source("tri_lists")
    consts = {name: int(v) for name, v in re.findall(r"constexpr int (\w+) = (\d+);",
                                                     bp_src + tri_src)}
    assert consts["kSeg"] == pb.SEG
    # the compaction: a warp a row, 0 or 1 group of 128 words loaded ahead
    assert consts["kCompactWarps"] >= 1 and consts["kAhead"] in (0, 1)
    assert _kernels.KERNELS["broadphase"][2]["grace_compact_words_resources"] == "pi"
    assert consts["kMaxIntervals"] == pt.MAX_INTERVALS
    assert consts["kStageSegs"] == pt.STAGE_SEGS and consts["kWarpBuf"] == pt.WARP_BUF
    assert float(re.search(r"kBig = ([0-9.e+-]+)f;", tri_src).group(1)) == pt.BIG
    assert pt.N_CULL_INTERVALS <= pt.MAX_INTERVALS and pt.SORT_SLOTS >= 1
    assert pt.SORT_SCRATCH >= 1 << max(0, pt.STAGE_SEGS - 1).bit_length()
    for name, entries in (("broadphase", {"grace_broadphase_boxes", "grace_overlap_words",
                                          "grace_compact_words",
                                          "grace_broadphase_boxes_resources",
                                          "grace_overlap_words_resources",
                                          "grace_compact_words_resources"}),
                          ("tri_lists", {"grace_tri_tile_lists",
                                         "grace_tri_tile_lists_resources"})):
        _, flags, declared = _kernels.KERNELS[name]
        assert flags == ["--fmad=false"] and set(declared) == entries
        src = _source(name)
        for entry in entries:
            body = src[src.index(f'extern "C" int {entry}('):]
            assert "cudaErrorInvalidValue" in body[:body.index("cudaSetDevice")]
            params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src).group(1).split(",")
            assert "".join("p" if "*" in p else "i" for p in params[:-2]) == declared[entry], entry
    # a block's boxes (two f32 arrays of 3 S) and word hulls (6 f32 a 32
    # segments) and one warp's area (its u64 buffer, a pushed word and a
    # prefix a 32 segments, a queue of 64 ids, or the hulls' rows where
    # larger; 8 f32 an interval, 6 a hull) at STAGE_SEGS, WARP_BUF and
    # MAX_INTERVALS: at least one warp fits
    n_words = pt.STAGE_SEGS // 32
    area = (max(8 * pt.WARP_BUF + 8 * n_words + 4 * 64,
                4 * consts["kHullRow"] * 3 * consts["kHullGroups"])
            + 32 * pt.MAX_INTERVALS + 24 * (pt.MAX_INTERVALS + 2))
    assert 2 * 4 * 3 * pt.STAGE_SEGS + 24 * n_words + area <= 232448
    assert consts["kWarps"] * 32 <= 1024


def test_segsort_constants_agree():
    """segsort.cu's longest warp run, head tile and payload count are the
    wrappers' (segops.SEG_CHUNK, HEAD_TILE, MAX_PAYLOADS); its eleven launch
    entries and its resources query take no float arithmetic (no flags)
    and refuse what they do not take before they touch the device; the
    query numbers the kernels as segops.RESOURCE_KERNELS; the row sort's
    wrapper routes rows wider than a warp's run to the segmented sort's
    launches."""
    from grace_tpu_torch.ops import segops as so

    src = _source("segsort")
    consts = {name: int(v) for name, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert consts["kMaxChunk"] == so.SEG_CHUNK and consts["kTile"] == so.HEAD_TILE
    assert consts["kMaxPayloads"] == so.MAX_PAYLOADS and consts["kMergeTile"] == so.MERGE_TILE
    assert consts["kMinChunk"] * 2 == so.MERGE_TILE and consts["kWarpRun"] == so.WARP_RUN
    _, flags, entries = _kernels.KERNELS["segsort"]
    assert flags == []
    assert set(entries) == {"grace_sort_rows", "grace_seg_heads", "grace_seg_count",
                            "grace_seg_starts", "grace_segmented_sort", "grace_seg_long_scan",
                            "grace_seg_check",
                            "grace_seg_chunks", "grace_seg_merge", "grace_seg_gather",
                            "grace_records_to_flat", "grace_segsort_resources"}
    query = src[src.index('extern "C" int grace_segsort_resources('):]
    assert f"kernel > {len(so.RESOURCE_KERNELS) - 1}" in query
    assert len(re.findall(r"reinterpret_cast<const void\*>\((\w+)", query)) == len(
        so.RESOURCE_KERNELS)
    for entry in entries:
        body = src[src.index(f'extern "C" int {entry}('):]
        assert "cudaErrorInvalidValue" in body[:body.index("cudaSetDevice")]
    assert so._merge_rounds(so.SEG_CHUNK, so.SEG_CHUNK) == 0
    assert so._merge_rounds(so.SEG_CHUNK + 1, so.SEG_CHUNK) == 1
    assert so.SEG_CHUNK << so._merge_rounds(1_300_000, so.SEG_CHUNK) >= 1_300_000
