"""The dense broadphase and the triangle trace's segment lists against
grace_tpu, and the design of their CUDA kernels (``csrc/broadphase.cu``,
``csrc/tri_lists.cu``) as numpy models; and the repair of ROADMAP C22.

- The plain versions (``_<name>_plain``) against ``grace_tpu`` (jitted on
  the CPU) at every case of chip_smoke's ``BROADPHASE_CASES`` (particle
  counts that are no multiple of 32 or 128, one and no segment, tile counts
  that are no multiple of 32, NaN particles, particles at -0 and +0, zero-
  length rays, a tile of them, a NaN ray, a ragged summary word, every
  segment in some list, compaction at max_q equal to and one under the
  longest row, 1 and 0) and ``TRI_LIST_CASES`` (the tests' torus, a small
  max_chunks, a ragged last segment, K 8, tiles of clipped and zero-length
  rays listing 0, 1 and every segment, keys at and past BIG and a NaN key,
  11,719 segments, 1.5M triangles, rows of 4-byte stores, a BIG group
  across three words cut by keep inside a vector, 37 tiles of 32, and the
  routes past the warp's buffer and the staged boxes forced small):
  words, summaries, lists, counts and flags bit-equal,
  boxes equal in value (zero signs are the reductions' order's, C20),
  distances bit-equal with NaN where grace_tpu's are.
- numpy models of the four C entries, written as the kernels index their
  threads (both box sets in one launch: a warp a segment of 128 spheres
  and a warp a tile, folds on order-keeping ints by redux.sync with a NaN
  bit a value, the four outputs views of one allocation; a block a
  strip of 32 words, each row tested against the words' hulls, a ballot
  a candidate word, the summary a ballot of the words;
  a warp a row of words, popcounts and a warp prefix sum; for the lists,
  persistent blocks staging the boxes and the words' hulls once, a warp a
  tile taken by a grid stride, the hulls by redux on order-preserving
  ints, the union against the word hulls (held exact) and then the
  boxes, the near segments queued and run 32 at a time with ballot
  appends, the warp's register network or the scratch's chunked one, the
  row written output-stationary as 16- or 4-byte stores, every tile
  taken and every column written once), run through the port's own
  wrappers with the ctypes launch replaced by the model (which reads and
  writes the tensors' host memory), bit-equal to the plain versions
  (boxes and the zero signs as above), on the cases above, on clustered
  particles (2^14), on the tests' torus and, for the boxes, at
  ``BOX_SET_CASES`` (both ray routes, rays off a 16-byte boundary, NaN,
  +-0, +-inf and F32_MAX, no spheres, no rays; the plain segment boxes
  there also against grace_tpu's); the triangle lists also with
  the module's limits forced small (a warp's buffer of 4 entries, boxes
  staged up to 8 segments, fewer scratch rows than tiles).
- ROADMAP C22: the sort-free setup's cached camera constants equal
  ``_camera_numerics`` / ``_tile_spans`` of the caller's camera and
  ``grace_tpu``'s, for np.float32 extents and lengths, after a float
  camera of the same values has filled the cache.
"""

import ctypes
import warnings

import jax
import numpy as np
import pytest
import torch

import grace_tpu.trace.pallas_broadphase as jpb
import grace_tpu.trace.pallas_render as jpr
import grace_tpu.trace.pallas_tri as jpt
import grace_tpu.trace.splat_grad as jsg
from grace_tpu.core.types import Rays as JRays
from chip_smoke import (BOX_SET_CASES, BROADPHASE_CASES, CAM, COMPACT_CASES, LOOK,
                        OVERLAP_BOX_CASES, TRI_LIST_CASES, TRI_LIST_FORCED, UP, box_set_inputs,
                        box_set_outputs, compact_inputs,
                        broadphase_scene, compaction_limits, overlap_box_scene,
                        overlap_words_reference, tri_list_scene)
from grace_tpu_torch import _kernels
from grace_tpu_torch.core.types import Rays
import grace_tpu_torch.trace.broadphase as tbp
import grace_tpu_torch.trace.pallas_broadphase as tpb
import grace_tpu_torch.trace.pallas_render as tpr
import grace_tpu_torch.trace.pallas_tri as tpt
import grace_tpu_torch.trace.splat_grad as tsg
from tests.helper.torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

F32 = np.float32
F32_MAX = np.finfo(np.float32).max
BP_CASES = list(BROADPHASE_CASES)
TRI_CASES = list(TRI_LIST_CASES)
BOX_CASES = list(OVERLAP_BOX_CASES)


def _bp_inputs(tag):
    s, o, d, ln = broadphase_scene(tag)
    tile = BROADPHASE_CASES[tag][2]
    return torch.from_numpy(s), Rays.from_arrays(o, d, ln, device="cpu"), tile


def _tri_inputs(tag):
    """(rays, triangles, tile, max_chunks, K) of case ``tag`` on the CPU,
    the rays clipped where the case says."""
    tris, o, d, ln, clip = tri_list_scene(tag)
    _, _, tile, max_chunks, k = TRI_LIST_CASES[tag]
    rays, t = Rays.from_arrays(o, d, ln, device="cpu"), torch.from_numpy(tris)
    if clip:
        flat = t.reshape(-1, 3)
        rays = tpt.clip_rays_to_aabb(rays, flat.amin(dim=0), flat.amax(dim=0))
    return rays, t, tile, max_chunks, k


def _np(t):
    return np.asarray(t)


def _boxes_equal(a, b, what):
    """Equal values, NaN at the same places (zero signs free: C20)."""
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and a.dtype == b.dtype, what
    nan = np.isnan(b)
    assert np.array_equal(np.isnan(a), nan) and np.array_equal(a[~nan], b[~nan]), what


def _bits_equal(a, b, what):
    """Bit-equal; f32 NaN wherever the other's is NaN."""
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and a.dtype == b.dtype, what
    if a.dtype == np.float32:
        nan = np.isnan(b)
        assert np.array_equal(np.isnan(a), nan), what
        a, b = np.where(nan, F32(0), a).view(np.int32), np.where(nan, F32(0), b).view(np.int32)
    assert np.array_equal(a, b), what


# ---- the plain versions against grace_tpu ----------------------------------


@pytest.mark.parametrize("tag", BP_CASES)
def test_broadphase_plain_matches_grace_tpu(tag):
    spheres, rays, tile = _bp_inputs(tag)
    jrays = JRays(*(jax.numpy.asarray(t.numpy()) for t in (rays.origins, rays.directions,
                                                            rays.lengths)))
    js = jax.numpy.asarray(spheres.numpy())
    # (the tile boxes are held through the words: a standalone jit of
    # grace_tpu's tile_aabbs contracts another product than the masks'
    # compiled form, C7)
    for block in (32, 128):
        for a, b in zip(tpb._segment_aabbs_plain(spheres, block),
                        jax.jit(jpb.segment_aabbs, static_argnums=1)(js, block)):
            _boxes_equal(a, b, f"segment boxes {block}")
    words, summary = tpb._dense_tile_masks_quarter_plain(rays, spheres, tile)
    j_words, j_summary = jpb.dense_tile_masks_quarter(jrays, js, tile)
    _bits_equal(words, j_words, "quarter words")
    _bits_equal(summary, j_summary, "quarter summary")
    _bits_equal(tpb._dense_tile_masks_plain(rays, spheres, tile),
                jpb.dense_tile_masks(jrays, js, tile), "segment words")
    if spheres.shape[0] == 0:
        return   # grace_tpu's compaction takes no row of no words
    for q in compaction_limits(words):
        got = tpb._compact_mask_words_plain(words, q)
        if q:
            want = jax.jit(jpb.compact_mask_words, static_argnums=1)(j_words, q)
            for a, b, name in zip(got, want, ("ids", "n", "overflow")):
                _bits_equal(a, b, f"compact {q} {name}")
        else:
            assert got[0].shape == (words.shape[0], 0) and not got[1].any()
    max_q = compaction_limits(words)[1]
    for got, want in ((tpb._quarter_lists_plain(rays, spheres, tile, max(max_q, 1)),
                       jpb.quarter_lists(jrays, js, tile, max(max_q, 1))),
                      (tpb._dense_tile_segments_plain(rays, spheres, tile, 64),
                       jpb.dense_tile_segments(jrays, js, tile, 64)),
                      (tpr._dense_segment_tiles_plain(rays, spheres, tile, 64),
                       jax.jit(jpr.dense_segment_tiles, static_argnums=(2, 3))(jrays, js, tile,
                                                                               64))):
        for a, b, name in zip(got, want, ("ids", "n", "overflow")):
            _bits_equal(a, b, name)


@pytest.mark.parametrize("tag", TRI_CASES)
def test_tri_lists_plain_matches_grace_tpu(tag):
    rays, tris, tile, max_chunks, k = _tri_inputs(tag)
    jrays = JRays(*(jax.numpy.asarray(t.numpy()) for t in (rays.origins, rays.directions,
                                                            rays.lengths)))
    want = jax.jit(jpt._dense_tile_segments_tri, static_argnums=(2, 3, 4))(
        jrays, jax.numpy.asarray(tris.numpy()), tile, max_chunks, k)
    got = tpt._dense_tile_segments_tri_plain(rays, tris, tile, max_chunks, k)
    for a, b, name in zip(got, want, ("seg_ids", "seg_dist", "n_segs", "overflow")):
        _bits_equal(a, b, name)


def test_tri_cases_reach_their_edges():
    """The cases hold what they are for: rows of 0, 1 and every segment,
    overflow, a key exactly BIG, keys past it and a NaN key."""
    n_all = {}
    for tag in TRI_CASES:
        rays, tris, tile, max_chunks, k = _tri_inputs(tag)
        ids, dist, n, ovf = tpt._dense_tile_segments_tri_plain(rays, tris, tile, 8192, k)
        n_all[TRI_LIST_CASES[tag][0]] = (n, dist, -(-tris.shape[0] // 128), ids)
    n, _, segs, _ = n_all["misses"]
    assert {0, 1, segs} <= set(n.tolist())
    _, dist, _, ids = n_all["extreme"]
    # tile 0: near (listed), at BIG (listed), past BIG (listed), infinite
    # (not listed): the listed key at BIG sorts by id among the unlisted
    assert ids[0, :4].tolist() == [0, 1, 3, 2]
    assert dist[0, 1] == dist[0, 2] == F32(tpt.BIG) and dist[0, 3] > F32(tpt.BIG)
    assert ids[1, :4].tolist() == [0, 1, 2, 3] and torch.isnan(dist[1, 3])
    n, _, segs, _ = n_all["big"]
    assert segs == 11719 and int(n.max()) > 4096
    # rows that list segments of all three words, their BIG group on both
    # sides of them, holding columns 92 and 93: keep = 94 cuts it inside
    # the vector of columns 92-95
    n, dist, segs, ids = n_all["ragged"]
    assert segs == 94 and int(n.max()) > 64
    big_ids = torch.where(dist == F32(tpt.BIG), ids, -1)
    assert bool(((big_ids[:, :94] >= 0) & (big_ids[:, :94] < 32)).any(dim=1).logical_and(
        (big_ids[:, :94] >= 64).any(dim=1)).any())
    assert bool(((dist[:, 92] == F32(tpt.BIG)) & (dist[:, 93] == F32(tpt.BIG))).any())


# ---- numpy models of the C entries -------------------------------------------


def _view(ptr, ctype, count):
    """The ``count`` values of C type ``ctype`` at host address ``ptr``,
    as a writable numpy array."""
    if count == 0:
        return np.zeros(0, np.ctypeslib.as_array((ctype * 1)()).dtype)
    return np.ctypeslib.as_array((ctype * count).from_address(ptr))


def _fmin(a, b):
    """fminf on the card: the smaller; of -0 and +0, -0 (ROADMAP C20)."""
    return np.where(a < b, a, np.where(b < a, b, np.where(np.signbit(a), a, b)))


def _fmax(a, b):
    return np.where(a > b, a, np.where(b > a, b, np.where(np.signbit(a), b, a)))


def _nan_min(a, b):
    """torch.minimum on the card: a NaN operand wins, else fminf."""
    return np.where(np.isnan(a), a, np.where(np.isnan(b), b, _fmin(a, b))).astype(F32)


def _nan_max(a, b):
    return np.where(np.isnan(a), a, np.where(np.isnan(b), b, _fmax(a, b))).astype(F32)


def _warp_reduce(op, lanes):
    """A lane-strided loop then a shuffle butterfly: ``lanes`` [..., m, 32]
    (m values a lane, the lane's loop order) -> [...]."""
    acc = lanes[..., 0, :]
    for i in range(1, lanes.shape[-2]):
        acc = op(acc, lanes[..., i, :])
    o = 16
    while o:
        acc = op(acc, acc[..., np.arange(32) ^ o])
        o >>= 1
    return acc[..., 0]


def _lanes(x, init, width):
    """[..., n, ...] values along axis -2 spread over 32 lanes the way a
    lane loop i = lane, lane + 32, ... takes them, padded with ``init``:
    [..., ceil(n / 32), 32, last]."""
    n = x.shape[-2]
    m = max(1, -(-n // 32))
    pad = np.full(x.shape[:-2] + (m * 32 - n, x.shape[-1]), init, F32)
    return np.concatenate([x, pad], axis=-2).reshape(x.shape[:-2] + (m, 32, width))


def _fma_f64(a, b, c):
    f64 = lambda x: np.asarray(x, np.float64)
    return (f64(a) * f64(b) + f64(c)).astype(F32)


# boxes_kernel's plan (csrc/broadphase.cu): blocks of 8 warps; a warp a
# segment of 128 spheres (a lane 4 of them) or a tile; 16-byte rays from
# tile 128 on
BOX_WARPS, SEG_LOADS, VEC_TILE = 8, 4, 128
I32_MAX, I32_MIN = np.int32(2 ** 31 - 1), np.int32(-2 ** 31)


def _ordered(x):
    """The kernel's order-keeping ints of f32 values: the bits with the
    lower 31 flipped where the sign is set."""
    b = np.asarray(x, F32).view(np.int32)
    return b ^ ((b >> 31) & np.int32(0x7FFFFFFF))


def _unordered(k):
    k = np.asarray(k, np.int32)
    return (k ^ ((k >> 31) & np.int32(0x7FFFFFFF))).view(F32)


def _fold(lo, hi, nan, axis):
    """Fold (ordered mins, ordered maxes, NaN bits) over ``axis``: integer
    min and max (redux.sync's), NaN bits or'ed."""
    return lo.min(axis=axis), hi.max(axis=axis), np.bitwise_or.reduce(nan, axis=axis)


def _nan_bits(lo_v, hi_v):
    """A fold's NaN bits of values [..., 3]: bit a the min of axis a, bit 3 +
    a the max."""
    ax = np.arange(3, dtype=np.uint32)
    return ((np.isnan(lo_v).astype(np.uint32) << ax).sum(-1)
            | (np.isnan(hi_v).astype(np.uint32) << (ax + 3)).sum(-1)).astype(np.uint32)


def _store_fold(lo, hi, nan):
    """store_fold: the box as floats, NaN where a value's bit is set."""
    bit = lambda v: ((nan[..., None] >> np.arange(v, v + 3, dtype=np.uint32)) & 1) == 1
    return (np.where(bit(0), F32(np.nan), _unordered(lo)),
            np.where(bit(3), F32(np.nan), _unordered(hi)))


def _write_run(ptr, values):
    """write_run: a block's staged floats to device address ``ptr`` as one
    run, a thread a float at a time."""
    _view(ptr, ctypes.c_float, values.size)[:] = values


def _model_broadphase_boxes(spheres, origins, dirs, lengths, seg_min, seg_max, tmin, tmax, n,
                            block, n_tiles, tile):
    """grace_broadphase_boxes: the grid's first ceil(segments / 8) blocks
    the segment part, the rest the tile part; the four outputs views of
    one allocation in order, each 16-byte aligned.

    Segments: warp g of block b takes segment 8 b + g, lane l its spheres
    128 s + 32 k + l (k < 4; past n the padding's +F32_MAX, -F32_MAX);
    quarter k's box (block 32) is the warp's fold of the lanes' k-th
    values, the segment's (block 128) the warp's fold of each lane's fold
    of its four; a fold is redux.sync's integer min and max on ordered ints
    and an or of the NaN bits. Tiles: warp g of block b takes tile 8 b + g
    (after the segment part's blocks), lane l units l, l + 32, ... (4 rays
    from 16-byte loads where tile % 4 == 0, tile >= 128 and the three bases
    are 16-byte aligned, else a ray), each origin and endpoint (fma_f64)
    folded in; then the warp's fold. Each block writes its staged boxes as
    two runs."""
    n_segs = -(-n // 128)
    n_boxes = n_segs * (128 // block)
    ptrs = (seg_min, seg_max, tmin, tmax)
    rows = (n_boxes + (-n_boxes % 4), n_boxes + (-n_boxes % 4), n_tiles + (-n_tiles % 4))
    live = (n_boxes > 0,) * 2 + (n_tiles > 0,) * 2
    assert all(p % 16 == 0 for p, on in zip(ptrs, live) if on), "16-byte aligned outputs"
    assert all(ptrs[i + 1] - ptrs[i] == 12 * rows[i] for i in range(3)
               if live[i] and live[i + 1]), "views of one allocation, in order"
    assert block in (32, 128) and tile >= 1
    # the segment part
    if n:
        assert spheres % 16 == 0
        s = np.full((n_segs * 128, 4), F32(0), F32)
        s[:n] = _view(spheres, ctypes.c_float, 4 * n).reshape(n, 4)
        live = (np.arange(n_segs * 128) < n)[:, None]
        with np.errstate(invalid="ignore", over="ignore"):
            lo_v = np.where(live, s[:, :3] - s[:, 3:], F32_MAX).astype(F32)
            hi_v = np.where(live, s[:, :3] + s[:, 3:], -F32_MAX).astype(F32)
        shape = (n_segs, SEG_LOADS, 32)                     # [segment, load k, lane]
        lo, hi = _ordered(lo_v).reshape(shape + (3,)), _ordered(hi_v).reshape(shape + (3,))
        nan = _nan_bits(lo_v, hi_v).reshape(shape)
        if block == 128:                                    # the lane's four first
            lo, hi, nan = (x[:, None] for x in _fold(lo, hi, nan, 1))
        lo, hi, nan = _fold(lo, hi, nan, 2)                 # the warp's redux.sync
        box_min, box_max = (x.reshape(n_boxes, 3) for x in _store_fold(lo, hi, nan))
        per_block = BOX_WARPS * (n_boxes // n_segs)
        for first in range(0, n_boxes, per_block):          # a block's two runs
            for ptr, v in ((seg_min, box_min), (seg_max, box_max)):
                _write_run(ptr + 12 * first, v[first:first + per_block].reshape(-1))
    # the tile part
    if n_tiles:
        r = n_tiles * tile
        vec = tile % 4 == 0 and tile >= VEC_TILE and all(
            p % 16 == 0 for p in (origins, dirs, lengths))
        per_unit = 4 if vec else 1
        units = tile // per_unit
        o = _view(origins, ctypes.c_float, 3 * r).reshape(n_tiles, tile, 3)
        d = _view(dirs, ctypes.c_float, 3 * r).reshape(n_tiles, tile, 3)
        ln = _view(lengths, ctypes.c_float, r).reshape(n_tiles, tile, 1)
        with np.errstate(invalid="ignore", over="ignore"):
            e = _fma_f64(d, ln, o)
        pts = np.stack([o, e], axis=2)                      # [tile, ray, point, axis]
        keys = _ordered(pts)
        nan = np.bitwise_or.reduce(_nan_bits(pts, pts), axis=2)
        lo, hi, nan = keys.min(axis=2), keys.max(axis=2), nan
        # a unit's rays, then a lane's units (l, l + 32, ...; idle lanes
        # hold the empty fold)
        unit = lambda x: x.reshape(n_tiles, units, per_unit, *x.shape[2:])
        lo, hi, nan = _fold(unit(lo), unit(hi), unit(nan), 2)
        m = -(-units // 32)
        pad = lambda x, v: np.concatenate(
            [x, np.full((n_tiles, m * 32 - units) + x.shape[2:], v, x.dtype)], axis=1)
        lo, hi, nan = (pad(x, v).reshape(n_tiles, m, 32, *x.shape[2:])
                       for x, v in ((lo, I32_MAX), (hi, I32_MIN), (nan, np.uint32(0))))
        lo, hi, nan = _fold(lo, hi, nan, 1)                 # [tile, lane, ...]
        lo, hi, nan = _fold(lo, hi, nan, 1)                 # the warp's redux.sync
        box_min, box_max = _store_fold(lo, hi, nan)
        for first in range(0, n_tiles, BOX_WARPS):
            for ptr, v in ((tmin, box_min), (tmax, box_max)):
                _write_run(ptr + 12 * first, v[first:first + BOX_WARPS].reshape(-1))
    BOX_ROUTES.add(("16-byte rays" if n_tiles and vec else "4-byte rays" if n_tiles else "no rays",
                    f"block {block}" if n else "no spheres"))


BOX_ROUTES = set()


def _ballot(bits):
    """[..., 32] bools -> the ballot's i32 word."""
    return (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(axis=-1).astype(
        np.uint32).view(np.int32)


# overlap_words_kernel's blocks: a strip of 32 words (1,024 columns) and
# up to 256 rows, halved down to 32 while fewer than four blocks an SM of
# the H100's 132 (overlap_block_rows in csrc/broadphase.cu)
STRIP_WORDS, MAX_ROWS, MIN_ROWS, MIN_BLOCKS = 32, 256, 32, 4 * 132


def _block_rows(n_rows, n_strips):
    rows = MAX_ROWS
    while rows > MIN_ROWS and n_strips * -(-n_rows // rows) < MIN_BLOCKS:
        rows //= 2
    return rows


def _model_overlap_words(row_min, row_max, col_min, col_max, words, summary, n_rows, n_cols,
                         stats=None):
    """grace_overlap_words: block (s, g) = strip s (words 32 s .. 32 s + 31,
    its 1,024 columns staged from 16-byte aligned boxes as they lie, NaN
    past the last) and rows g, g + G, ... of the G = ceil(rows / R) groups
    (R = _block_rows); warp j reduces word j's hull by a butterfly of
    fminf (mins) and fmaxf (maxes), which drops NaNs; each row is tested
    against the 32 hulls (lane l: word l; the ballot gives the candidates),
    then only candidate words get the fine test (lane c: column 32 j + c,
    one ballot), the other words are 0, and the summary word is the ballot
    of the final words being nonzero. The model also holds the cull exact:
    no word it skips has a set bit. ``stats`` (a dict) takes the
    candidate and nonzero word counts."""
    assert col_min % 16 == 0 and col_max % 16 == 0
    n_words = -(-n_cols // 32)
    n_strips = -(-n_words // STRIP_WORDS)
    rows = np.concatenate([_view(p, ctypes.c_float, 3 * n_rows).reshape(n_rows, 3)
                           for p in (row_min, row_max)], axis=1)
    cols = np.concatenate([_view(p, ctypes.c_float, 3 * n_cols).reshape(n_cols, 3)
                           for p in (col_min, col_max)], axis=1)
    out = _view(words, ctypes.c_int32, n_rows * n_words).reshape(n_rows, n_words)
    summ = (_view(summary, ctypes.c_int32, n_rows * n_strips).reshape(n_rows, n_strips)
            if summary else None)
    if n_rows == 0 or n_words == 0:
        return                                 # the entry launches nothing
    n_groups = -(-n_rows // _block_rows(n_rows, n_strips))
    for s in range(n_strips):
        strip = np.full((STRIP_WORDS * 32, 6), np.nan, F32)
        take = cols[s * STRIP_WORDS * 32:(s + 1) * STRIP_WORDS * 32]
        strip[:take.shape[0]] = take
        by_word = strip.reshape(STRIP_WORDS, 32, 6)                 # [word, lane, axis]
        lanes = np.moveaxis(by_word, -1, 0)[:, :, None, :]           # [axis, word, 1, 32]
        hull = np.concatenate([_warp_reduce(np.fmin, lanes[:3]),
                               _warp_reduce(np.fmax, lanes[3:])]).T  # [word, axis]
        strip_words = min(STRIP_WORDS, n_words - s * STRIP_WORDS)
        word_here = np.arange(STRIP_WORDS) < strip_words
        for g in range(n_groups):
            at = np.arange(g, n_rows, n_groups)                      # the block's rows
            assert at.shape[0] <= MAX_ROWS
            blk = rows[at]                                           # [m, 6]
            with np.errstate(invalid="ignore"):
                near = word_here[None] & np.all(
                    (blk[:, None, :3] <= hull[None, :, 3:])
                    & (hull[None, :, :3] <= blk[:, None, 3:]), axis=-1)  # [m, word]
                fine = np.all((blk[:, None, None, :3] <= by_word[None, :, :, 3:])
                              & (by_word[None, :, :, :3] <= blk[:, None, None, 3:]), axis=-1)
            fine_words = _ballot(fine)                               # [m, word]
            assert not (fine_words[~near] != 0).any(), "the cull dropped a set bit"
            mine = np.where(near, fine_words, 0).astype(np.int32)
            out[at, s * STRIP_WORDS:s * STRIP_WORDS + strip_words] = mine[:, :strip_words]
            if summ is not None:
                summ[at, s] = _ballot(mine != 0)
            if stats is not None:
                stats["candidates"] = stats.get("candidates", 0) + int(near.sum())
                stats["nonzero"] = stats.get("nonzero", 0) + int((mine != 0).sum())


COMPACT_ROUTES = set()   # the compaction's routes the models took


def _popc(x):
    return np.bitwise_count(np.asarray(x, np.uint32)).astype(np.int64)


def _model_nth_bit(word, r):
    """nth_bit: the largest p with at most r set bits below it (lanes at once)."""
    p = np.zeros_like(r)
    for step in (16, 8, 4, 2, 1):
        mask = ((np.uint64(1) << (p + step).astype(np.uint64)) - np.uint64(1)).astype(np.uint32)
        p = np.where(_popc(word & mask) <= r, p + step, p)
    return p


def _model_compact_words(words, ids, n, overflow, n_rows, n_words, max_q):
    """grace_compact_words: a warp a row; 128 words a group, lane l's
    words 4 l .. 4 l + 3 (one 16-byte load where the rows are 16-byte
    aligned); the four words' popcounts' inclusive warp sum; the group's
    slots 32 at a time, slot total + s by lane s % 32, which finds the lane
    holding the s-th set bit by a binary search over the inclusive counts
    and its bit by rank; the warp stops once its count passes max_q; the
    padding past n = min(count, max_q): 4-byte stores up to the first
    16-byte boundary, 16-byte stores (their addresses asserted aligned),
    the last 0-3 slots. Each slot of a row is asserted written exactly
    once."""
    w_all = _view(words, ctypes.c_int32, n_rows * n_words).reshape(n_rows, n_words)
    out = _view(ids, ctypes.c_int32, n_rows * max_q).reshape(n_rows, max_q)
    n_out = _view(n, ctypes.c_int32, n_rows)
    ovf = _view(overflow, ctypes.c_uint8, n_rows)
    COMPACT_ROUTES.add("16-byte loads" if n_words % 4 == 0 and words % 16 == 0
                       else "4-byte loads")
    lane = np.arange(32)
    for row in range(n_rows):
        written = np.zeros(max_q, np.int64)
        total, base = 0, 0
        while base < n_words and total <= max_q:
            w4 = np.pad(w_all[row, base:base + 128].view(np.uint32),
                        (0, max(0, base + 128 - n_words))).reshape(32, 4)
            count = _popc(w4).sum(axis=1)
            incl = np.cumsum(count)
            excl = incl - count
            take = min(int(incl[31]), max_q - total)
            for s0 in range(0, take, 32):
                s = s0 + lane
                at = np.zeros(32, np.int64)
                for step in (16, 8, 4, 2, 1):
                    at = np.where(incl[at + step - 1] <= s, at + step, at)
                r = s - excl[at]
                word, j = w4[at, 0], np.zeros(32, np.int64)
                for q in (1, 2, 3):
                    c = _popc(word)
                    move = r >= c
                    r, word, j = np.where(move, r - c, r), np.where(move, w4[at, q], word), \
                        np.where(move, q, j)
                live = s < take
                bit = _model_nth_bit(word, r)
                out[row, total + s[live]] = (32 * (base + 4 * at + j) + bit)[live]
                written[total + s[live]] += 1
            total += int(incl[31])
            base += 128
        if base < n_words:
            COMPACT_ROUTES.add("stopped past max_q")
        k = min(total, max_q)
        addr = ids + 4 * (row * max_q + k)
        head = min(k + (4 - (addr >> 2) % 4) % 4, max_q)
        body = (max_q - head) // 4
        assert body == 0 or (ids + 4 * (row * max_q + head)) % 16 == 0
        if head > k:
            COMPACT_ROUTES.add("4-byte head")
        if body:
            COMPACT_ROUTES.add("16-byte padding")
        if head + 4 * body < max_q:
            COMPACT_ROUTES.add("4-byte tail")
        out[row, k:] = 0
        written[k:] += 1
        assert (written == 1).all(), "a slot written other than once"
        n_out[row], ovf[row] = k, total > max_q


def _order_bits(key):
    """The kernel's sort bits of f32 keys (+-0, positive or NaN)."""
    b = np.where(key == 0, F32(0), key).view(np.uint32)
    return np.where(np.isnan(key), np.uint32(0xFFFFFFFF), b)


def _scratch_sort(row, w):
    """scratch_sort: row[:w] (w a power of 2 past 256) in place, a chunk of
    256 through the warp's network (descending where bit 8 of its start is
    set: ascending on the complemented values), then each phase k >= 512:
    its steps j >= 256 over the row, its steps j < 256 in each chunk in the
    direction bit k of the chunk's start gives."""
    chunk, ones = 256, np.uint64(0xFFFFFFFFFFFFFFFF)

    def steps(x, k, js):
        for j in js:
            i = np.arange(x.shape[0])
            p = i ^ j
            sel = p > i
            i, p = i[sel], p[sel]
            a, b = x[i].copy(), x[p].copy()
            swap = (a > b) == ((i & k) == 0)
            x[i[swap]], x[p[swap]] = b[swap], a[swap]

    for c in range(0, w, chunk):
        flip = ones if c & chunk else np.uint64(0)
        x = (row[c:c + chunk] ^ flip).reshape(32, 8)
        row[c:c + chunk] = _warp_bitonic(x).reshape(-1) ^ flip
    k = 2 * chunk
    while k <= w:
        steps(row[:w], k, [j for j in (k >> np.arange(1, 32)) if j >= chunk])
        for c in range(0, w, chunk):
            flip = ones if c & k else np.uint64(0)
            x = row[c:c + chunk] ^ flip
            steps(x, 2 * chunk, [128, 64, 32, 16, 8, 4, 2, 1])   # every step ascending
            row[c:c + chunk] = x ^ flip
        k *= 2


def _warp_bitonic(v):
    """warp_bitonic on v u64[32, E] (lane, register): element i = lane E +
    e; phase K = 2, 4, ..., 32 E compares i with its mirror i ^ (K - 1)
    (inside the lane where K <= E, else lane ^ (K / E - 1), register E - 1
    - e), then J = K / 4, ..., 1 (inside the lane where J < E, else lane ^
    (J / E)); the lane holding the lower index keeps the smaller value."""
    e_n, lane = v.shape[1], np.arange(32)

    def cross(v, w, low):
        return np.where(low[:, None], np.minimum(v, w), np.maximum(v, w))

    def inside(v, j, partner):
        v = v.copy()
        lo = np.flatnonzero((np.arange(e_n) & j) == 0)
        a, b = v[:, lo], v[:, partner(lo)]
        v[:, lo], v[:, partner(lo)] = np.minimum(a, b), np.maximum(a, b)
        return v

    k = 2
    while k <= 32 * e_n:
        if k <= e_n:
            v = inside(v, k // 2, lambda e: e ^ (k - 1))
        else:
            v = cross(v, v[lane ^ (k // e_n - 1), ::-1], (lane & (k // e_n // 2)) == 0)
        j = k // 4
        while j >= 1:
            if j >= e_n:
                v = cross(v, v[lane ^ (j // e_n), :], (lane & (j // e_n)) == 0)
            else:
                v = inside(v, j, lambda e: e | j)
            j //= 2
        k *= 2
    return v


# The list kernel's launch as the C entry plans it (plan_for): warps a
# block (16, fewer where a warp's area does not fit beside the staged
# boxes and the word hulls in the card's 227 KB a block), each warp's area
# (its buffer, pushed words, prefixes and queue, or the hulls' rows where
# larger; the intervals; the hulls' table); the model's card holds 3 such
# blocks.
TRI_WARPS, TRI_SMEM, MODEL_RESIDENT_BLOCKS = 16, 232448, 3
PAD64 = np.uint64(0xFFFFFFFFFFFFFFFF)
TRI_ROUTES = set()   # the routes the model's launches took


def _tri_plan(n_segs, K, max_chunks, warp_buf, stage):
    """(vec, staged, warps a block, floats of each staged array)."""
    n_words = -(-n_segs // 32)
    staged = n_segs <= stage
    stage_floats = -(-3 * n_segs // 4) * 4 if staged else 0
    lists = max(8 * warp_buf + 8 * n_words + 4 * 64, 4 * 34 * 3 * 7)   # or the hulls' rows
    area = -(-(-(-lists // 16) * 16 + 32 * K + 24 * (K + 2)) // 16) * 16
    block = -(-(8 * stage_floats + 24 * n_words) // 16) * 16   # the boxes, the word hulls
    warps = min(TRI_WARPS, (TRI_SMEM - block) // area)
    assert warps >= 1
    return max_chunks % 4 == 0, staged, warps, stage_floats


def _order_int(x):
    """order_int: a float's order-preserving int32 (-0 below +0)."""
    b = np.asarray(x, F32).view(np.int32)
    return b ^ ((b >> 31) & np.int32(0x7FFFFFFF))


def _from_order_int(k):
    k = np.asarray(k, np.int32)
    return (k ^ ((k >> 31) & np.int32(0x7FFFFFFF))).view(F32)


def _redux(v, is_min):
    """warp_min / warp_max of the lanes' values v f32[32]: one reduction of
    the order-preserving ints, NaN mapped to the reduction's extreme."""
    ext = np.iinfo(np.int32).min if is_min else np.iinfo(np.int32).max
    k = np.where(np.isnan(v), np.int32(ext), _order_int(v))
    return _from_order_int(k.min() if is_min else k.max())


def _fminf(a, b):
    """fminf: a NaN operand dropped, -0 below +0."""
    return F32(np.where(np.isnan(a), b, np.where(np.isnan(b), a, _fmin(a, b))))


def _fmaxf(a, b):
    return F32(np.where(np.isnan(a), b, np.where(np.isnan(b), a, _fmax(a, b))))


def _big_id(mask, pre, n_words, r, w):
    """big_id: the r-th id of the BIG group, from the lane's word cursor w;
    returns (id, cursor)."""
    w = max(w, r >> 5)
    while w + 1 < n_words and 32 * (w + 1) - int(pre[w + 1]) <= r:
        w += 1
    n = r - (32 * w - int(pre[w]))
    if mask[w] == 0:
        return 32 * w + n, w
    clear = ~int(mask[w]) & 0xFFFFFFFF
    for _ in range(n):
        clear &= clear - 1
    return 32 * w + (clear & -clear).bit_length() - 1, w


def _model_tri_tile(t, rays, boxes, hulls, fr, K, S, max_chunks, warp_buf, srow, outs,
                    written):
    """list_tile: one warp's tile t."""
    o, d, ln = rays
    smin, smax = boxes
    ids_o, dist_o, n_o, ovf_o = outs
    big = F32(tpt.BIG)
    clamp0 = lambda v: np.where(np.isnan(v), v, _fmax(v, F32(0))).astype(F32)
    tile = ln.shape[1]

    def hull(values, is_min):
        """values f32[tile]: each lane's nan_min / nan_max over its rays
        (lane, lane + 32, ...; the identity where it has none), then the
        warp's redux."""
        op, ident = (_nan_min, F32(np.inf)) if is_min else (_nan_max, F32(-np.inf))
        v = np.full(-(-tile // 32) * 32, ident, F32)
        v[:tile] = values
        acc = np.full(32, ident, F32)
        for row in v.reshape(-1, 32):
            acc = op(acc, row)
        return _redux(acc, is_min)

    # 1. the hulls; the intervals written by lane 0, their union in every lane
    lt_ = clamp0(ln[t])
    iv = np.zeros((K, 6), F32)
    u_lo, u_hi = np.full(3, np.inf, F32), np.full(3, -np.inf, F32)
    prev = None
    for k in range(K + 1):
        pts = _fma_f64(d[t], (lt_ * fr[k]).astype(F32)[:, None], o[t])       # [tile, 3]
        cur = [(hull(pts[:, x], True), hull(pts[:, x], False)) for x in range(3)]
        if k:
            for x in range(3):
                il, ih = _nan_min(prev[x][0], cur[x][0]), _nan_max(prev[x][1], cur[x][1])
                iv[k - 1, x], iv[k - 1, 3 + x] = il, ih
                u_lo[x], u_hi[x] = _fminf(u_lo[x], il), _fmaxf(u_hi[x], ih)
        prev = cur
    omin = np.array([hull(o[t][:, x], True) for x in range(3)], F32)
    omax = np.array([hull(o[t][:, x], False) for x in range(3)], F32)
    ln_min = hull(lt_, True)

    # 2. the union against each word's hull (NaN bounds dropped), then the
    # boxes of the words whose hull it meets; the near segments queue in
    # word order and go 32 at a time (a lane each): kfirst, the key, ballot
    # appends, each word's pushed bits or'ed in; then the words' prefixes
    n_words = -(-S // 32)
    hl, hh = hulls
    cand = np.all((u_lo <= hh) & (hl <= u_hi), axis=1)
    near_all = np.all((u_lo <= smax) & (smin <= u_hi), axis=1)
    assert not (near_all & ~np.repeat(cand, 32)[:S]).any(), "the word hulls cull a near box"
    queue = [s for w in np.flatnonzero(cand) for s in range(32 * w, min(32 * w + 32, S))
             if near_all[s]]
    buf = np.zeros(warp_buf, np.uint64)
    mask = np.zeros(n_words, np.uint64)
    m = n_listed = n_lt = 0
    for b0 in range(0, len(queue), 32):
        sv = np.array(queue[b0:b0 + 32])
        lo, hi = smin[sv], smax[sv]
        kfirst = np.full(sv.shape[0], K)
        for k in range(K - 1, -1, -1):
            hit = np.all((iv[k, :3] <= hi) & (lo <= iv[k, 3:]), axis=1)
            kfirst = np.where(hit, k, kfirst)
        listed = kfirst < K
        g = clamp0(_nan_max(lo - omax, omin - hi))
        g2 = _fma_f64(g[:, 2], g[:, 2], _fma_f64(g[:, 0], g[:, 0], g[:, 1] * g[:, 1]))
        root = np.sqrt(g2.astype(np.float64)).astype(F32)
        key = _nan_max(root, (fr[kfirst] * ln_min).astype(F32))
        push = listed & (key != big)
        n_listed += int(listed.sum())
        n_lt += int((listed & (key < big)).sum())
        for rank, lane in enumerate(np.flatnonzero(push)):
            p = m + rank
            e = (np.uint64(_order_bits(key[lane:lane + 1])[0]) << np.uint64(32)) | np.uint64(
                sv[lane])
            if p < warp_buf:
                buf[p] = e
            else:
                srow[p] = e
            mask[sv[lane] >> 5] |= np.uint64(1 << (int(sv[lane]) & 31))
        m += int(push.sum())
    counts = np.array([bin(int(x)).count("1") for x in mask], np.int64)
    pre = np.cumsum(counts) - counts
    assert counts.sum() == m

    # 3. the sort: in registers (E = 1, 2, 4, 8) up to warp_buf, else in
    # the scratch row over next_pow2(m) (in registers up to 256)

    def register_sort(x, m, e_n):
        v = np.full(32 * e_n, PAD64, np.uint64)
        v[:m] = x[:m]
        x[:m] = _warp_bitonic(v.reshape(32, e_n)).reshape(-1)[:m]

    TRI_ROUTES.add("scratch sort" if m > warp_buf else "register sort")
    if m > warp_buf:
        srow[:warp_buf] = buf
        w = 1 << max(0, m - 1).bit_length()
        srow[m:w] = PAD64
        if w <= 256:
            register_sort(srow, m, 8)
        else:
            TRI_ROUTES.add("scratch chunks")
            _scratch_sort(srow, w)
        sorted_ = srow
    else:
        sorted_ = buf
        if m > 1:
            register_sort(buf, m, next(e for e in (1, 2, 4, 8) if m <= 32 * e))
    assert m < 2 or np.all(sorted_[:m - 1] < sorted_[1:m]), "the network did not sort"

    # 4. the row, output-stationary: a lane's vectors (or columns) in order,
    # each column a sorted entry, a BIG-group id, or a pad
    keep, n_big = min(max_chunks, S), S - m
    vec = max_chunks % 4 == 0
    width = 4 if vec else 1
    units = -(-max_chunks // width)
    for lane in range(32):
        w = 0
        for u in range(lane, units, 32):
            cols = np.arange(u * width, u * width + width)
            written[t, cols] += 1
            r = u * width - n_lt
            if vec and r >= 0 and r + 3 < n_big and u * width + 3 < keep:
                # clear_run: four ids of one word without pushed bits
                first, w = _big_id(mask, pre, n_words, r, w)
                n = r - (32 * w - int(pre[w]))
                if mask[w] == 0 and n + 3 < 32:
                    TRI_ROUTES.add("clear runs")
                    ids_o[t, cols], dist_o[t, cols] = first + np.arange(4), big
                    continue
            for c in cols:
                if c >= keep:
                    ids_o[t, c], dist_o[t, c] = 0, big
                elif n_lt <= c < n_lt + n_big:
                    ids_o[t, c], w = _big_id(mask, pre, n_words, c - n_lt, w)
                    dist_o[t, c] = big
                else:
                    e = int(sorted_[c if c < n_lt else c - n_big])
                    ids_o[t, c] = e & 0xFFFFFFFF
                    hi = np.uint32(e >> 32)
                    dist_o[t, c] = (np.uint32(0x7FFFFFFF).view(F32) if hi == 0xFFFFFFFF
                                    else hi.view(F32))
    n_o[t], ovf_o[t] = min(n_listed, max_chunks), n_listed > max_chunks


def _model_tri_tile_lists(seg_min, seg_max, origins, dirs, lengths, frac, seg_ids, seg_dist, n,
                          overflow, scratch, tickets, n_tiles, tile, n_segs, K, max_chunks,
                          slots, warp_buf, stage):
    """grace_tri_tile_lists: persistent blocks (the model's card holds
    MODEL_RESIDENT_BLOCKS; no more warps than tiles, nor than scratch rows
    where a tile may spill), each staging the boxes once (16-byte loads,
    then the tail) where n_segs <= stage; warp g takes tile g, then tile G
    + its ticket (here the warps finish in a random order; the ticket
    counter starts at 0: the C entry zeroes it), list_tile in its own
    scratch row; every tile taken once, every column below max_chunks
    written once."""
    assert 1 <= warp_buf <= tpt.WARP_BUF and 0 <= stage <= tpt.STAGE_SEGS
    vec, staged, warps, stage_floats = _tri_plan(n_segs, K, max_chunks, warp_buf, stage)
    TRI_ROUTES.update({"16-byte rows" if vec else "4-byte rows",
                       "staged boxes" if staged else "boxes from device memory"})
    spills = n_segs > warp_buf
    assert not spills or slots >= 1
    total = min(MODEL_RESIDENT_BLOCKS * warps, n_tiles)
    if spills:
        total = min(total, slots)
    grid = -(-total // warps)
    cap = 1 << max(0, n_segs - 1).bit_length()
    rows = _view(scratch, ctypes.c_uint64, slots * cap).reshape(slots, cap) if spills else None
    r = n_tiles * tile
    flat_min = _view(seg_min, ctypes.c_float, 3 * n_segs)
    flat_max = _view(seg_max, ctypes.c_float, 3 * n_segs)
    if staged:   # the block's copy: float4 loads, then the tail
        assert seg_min % 16 == 0 and seg_max % 16 == 0
        sh = np.full((2, stage_floats), np.nan, F32)
        body = 3 * n_segs // 4 * 4
        for i, src in enumerate((flat_min, flat_max)):
            sh[i, :body] = src[:body].reshape(-1, 4).reshape(-1)
            sh[i, body:3 * n_segs] = src[body:]
        flat_min, flat_max = sh[0, :3 * n_segs], sh[1, :3 * n_segs]
    boxes = flat_min.reshape(n_segs, 3), flat_max.reshape(n_segs, 3)
    # each word's hull, once a block: min and max of its boxes, NaNs dropped
    n_words = -(-n_segs // 32)
    pad = np.full((32 * n_words - n_segs, 3), np.nan, F32)
    with np.errstate(all="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        hulls = (np.nanmin(np.concatenate([boxes[0], pad]).reshape(n_words, 32, 3), axis=1),
                 np.nanmax(np.concatenate([boxes[1], pad]).reshape(n_words, 32, 3), axis=1))
    rays = (_view(origins, ctypes.c_float, 3 * r).reshape(n_tiles, tile, 3),
            _view(dirs, ctypes.c_float, 3 * r).reshape(n_tiles, tile, 3),
            _view(lengths, ctypes.c_float, r).reshape(n_tiles, tile))
    fr = _view(frac, ctypes.c_float, K + 1)
    if vec and n_tiles and max_chunks:
        assert seg_ids % 16 == 0 and seg_dist % 16 == 0
    outs = (_view(seg_ids, ctypes.c_int32, n_tiles * max_chunks).reshape(n_tiles, max_chunks),
            _view(seg_dist, ctypes.c_float, n_tiles * max_chunks).reshape(n_tiles, max_chunks),
            _view(n, ctypes.c_int32, n_tiles), _view(overflow, ctypes.c_uint8, n_tiles))
    written = np.zeros((n_tiles, max_chunks), np.int64)
    taken = np.zeros(n_tiles, np.int64)
    assert tickets and grid * warps >= total
    rng = np.random.default_rng(n_tiles + 7 * n_segs)
    ticket = 0
    with np.errstate(all="ignore"):
        current = {g: g for g in range(total)}   # the warps still taking tiles
        while current:
            for g in rng.permutation(sorted(current)):
                t = current[g]
                if t >= n_tiles:
                    del current[g]
                    continue
                taken[t] += 1
                _model_tri_tile(t, rays, boxes, hulls, fr, K, n_segs, max_chunks, warp_buf,
                                rows[g] if spills else None, outs, written)
                current[g] = total + ticket
                ticket += 1
    assert (taken == 1).all(), "a tile taken other than once"
    assert (written == 1).all(), "a column written other than once"


MODELS = {"grace_broadphase_boxes": _model_broadphase_boxes,
          "grace_overlap_words": _model_overlap_words,
          "grace_compact_words": _model_compact_words,
          "grace_tri_tile_lists": _model_tri_tile_lists}


@pytest.fixture
def model_launch(monkeypatch):
    """Replace the ctypes launch with the numpy models; check each call's
    arguments against the entry's kinds in ``_kernels.KERNELS``."""
    calls = []

    def launch(name, entry, device, *args):
        kinds = _kernels.KERNELS[name][2][entry]
        assert name in ("broadphase", "tri_lists") and len(args) == len(kinds)
        for a, k in zip(args, kinds):
            assert (isinstance(a, int) and not isinstance(a, bool)) or (k == "p" and a is None)
        calls.append(entry)
        MODELS[entry](*args)

    monkeypatch.setattr(_kernels, "launch", launch)
    return calls


def _kernel_outputs(spheres, rays, tile, max_qs):
    """broadphase_outputs' names through the kernels' wrappers: both box
    sets from one launch at each block."""
    out = {}
    for b in (32, 128):
        (tmin, tmax), (out[f"segment box min ({b})"], out[f"segment box max ({b})"]) = \
            tpb.broadphase_boxes_cuda(rays, tile, spheres, b)
        out["tile box min"], out["tile box max"] = tmin, tmax
    seg = (out["segment box min (128)"], out["segment box max (128)"])
    quarter = (out["segment box min (32)"], out["segment box max (32)"])
    out["segment words"] = tpb.overlap_words_cuda(tmin, tmax, *seg)
    out["quarter words"], out["quarter summary"] = tpb.overlap_words_cuda(
        tmin, tmax, *quarter, summary=True)
    out["segment-tile words"], out["segment-tile summary"] = tpb.overlap_words_cuda(
        *seg, tmin, tmax, summary=True)
    lists = {"quarter_lists": tpb.compact_words_cuda(out["quarter words"], max_qs[0]),
             "dense_tile_segments": tpb.compact_words_cuda(out["segment words"], 2048),
             "dense_segment_tiles": tpb.compact_words_cuda(
                 tpb.overlap_words_cuda(*seg, tmin, tmax), 2048)}
    for q in max_qs:
        lists[f"compact (max_q {q})"] = tpb.compact_words_cuda(out["quarter words"], q)
    for what, xs in lists.items():
        for name, x in zip(("ids", "n", "overflow"), xs):
            out[f"{what} {name}"] = x
    return out


@pytest.mark.parametrize("tag", BP_CASES)
def test_broadphase_kernels_model_matches_plain(tag, model_launch):
    from chip_smoke import broadphase_outputs

    spheres, rays, tile = _bp_inputs(tag)
    q_words, _ = tpb._dense_tile_masks_quarter_plain(rays, spheres, tile)
    max_qs = compaction_limits(q_words)
    want = broadphase_outputs(spheres, rays, tile, max_qs, plain=True)
    counters = (tpb.broadphase_boxes_cuda, tpb.overlap_words_cuda, tpb.compact_words_cuda)
    before = [fn.launches for fn in counters]
    got = _kernel_outputs(spheres, rays, tile, max_qs)
    assert [fn.launches - b for fn, b in zip(counters, before)] == [2, 4, 3 + len(max_qs)]
    assert set(model_launch) == {"grace_broadphase_boxes", "grace_overlap_words",
                                 "grace_compact_words"}
    assert set(got) == set(want)
    for name, w in want.items():
        (_boxes_equal if "box" in name else _bits_equal)(got[name], w, name)


@pytest.mark.parametrize("tag", BP_CASES)
def test_broadphase_wrappers_launch_the_kernels(tag, model_launch, monkeypatch):
    """The public functions on a tensor that is not on the CPU take the
    kernel route, each step one launch and both box sets one launch where
    a caller needs both: run here on CPU tensors by making the wrappers'
    device test say "not the CPU"."""
    from chip_smoke import broadphase_outputs

    spheres, rays, tile = _bp_inputs(tag)
    q_words, _ = tpb._dense_tile_masks_quarter_plain(rays, spheres, tile)
    max_qs = compaction_limits(q_words)
    want = broadphase_outputs(spheres, rays, tile, max_qs, plain=True)
    for mod in (tbp, tpb, tpr):
        monkeypatch.setattr(mod, "_on_cpu", lambda t: False)
    plain_route = lambda *a, **k: pytest.fail("the plain route was taken")
    for mod, name in ((tbp, "_tile_aabbs_plain"), (tpb, "_segment_aabbs_plain"),
                      (tpb, "_masks_for_tile_aabbs_plain"), (tpb, "_compact_mask_words_plain"),
                      (tpr, "_dense_segment_tiles_plain")):
        monkeypatch.setattr(mod, name, plain_route)
    got, calls = {}, {}

    def run(name, fn):
        k = len(model_launch)
        out = fn()
        calls[name] = model_launch[k:]
        return out

    tmin, tmax = run("tile_aabbs", lambda: tpb.tile_aabbs(rays, tile))
    got["segment words"] = run("masks_for_tile_aabbs",
                               lambda: tpb.masks_for_tile_aabbs(tmin, tmax, spheres))
    assert torch.equal(run("dense_tile_masks", lambda: tpb.dense_tile_masks(rays, spheres, tile)),
                       got["segment words"])
    got["quarter words"], got["quarter summary"] = run(
        "dense_tile_masks_quarter", lambda: tpb.dense_tile_masks_quarter(rays, spheres, tile))
    for what, fn in (("quarter_lists", lambda: tpb.quarter_lists(rays, spheres, tile, max_qs[0])),
                     ("dense_tile_segments",
                      lambda: tpb.dense_tile_segments(rays, spheres, tile, 2048)),
                     ("dense_segment_tiles",
                      lambda: tpr.dense_segment_tiles(rays, spheres, tile, 2048)),
                     (f"compact (max_q {max_qs[-1]})",
                      lambda: tpb.compact_mask_words(got["quarter words"], max_qs[-1]))):
        for name, x in zip(("ids", "n", "overflow"), run(what.split(" ")[0], fn)):
            got[f"{what} {name}"] = x
    for name, x in got.items():
        _bits_equal(x, want[name], name)
    # one launch of the boxes a call (none for no spheres alone), then the
    # words and the compaction
    boxes, words, compact = "grace_broadphase_boxes", "grace_overlap_words", "grace_compact_words"
    assert calls == {"tile_aabbs": [boxes],
                     "masks_for_tile_aabbs": ([boxes] if spheres.shape[0] else []) + [words],
                     "dense_tile_masks": [boxes, words], "dense_tile_masks_quarter": [boxes, words],
                     "quarter_lists": [boxes, words, compact],
                     "dense_tile_segments": [boxes, words, compact],
                     "dense_segment_tiles": [boxes, words, compact], "compact": [compact]}


@pytest.mark.parametrize("block", [32, 128])
@pytest.mark.parametrize("tag", list(BOX_SET_CASES))
def test_broadphase_boxes_model_cases(tag, block, model_launch, monkeypatch):
    """The boxes' one launch at chip_smoke's BOX_SET_CASES (tiles 4 to 1,024 on
    both ray routes, rays that start off a 16-byte boundary, NaN in
    spheres and rays, +-0, +-inf and F32_MAX, no spheres, no rays), both
    parts and each alone through the public functions (the device test
    made to say "not the CPU"), equal to the plain versions with NaN at the
    same places; one launch a call with work, on the route the case is for."""
    spheres, rays, tile = box_set_inputs(tag, "cpu")
    want = box_set_outputs(spheres, rays, tile, block, plain=True)
    for mod in (tbp, tpb):
        monkeypatch.setattr(mod, "_on_cpu", lambda t: False)
    BOX_ROUTES.clear()
    got = box_set_outputs(spheres, rays, tile, block, plain=False)
    for name, w in want.items():
        _boxes_equal(got[name], w, name)
    n, n_tiles, _, _, offset = BOX_SET_CASES[tag]
    assert model_launch == ["grace_broadphase_boxes"] * (1 + (n_tiles > 0) + (n > 0))
    vec = tile % 4 == 0 and tile >= VEC_TILE and offset == 0
    assert ("16-byte rays" if vec else "4-byte rays", f"block {block}") in BOX_ROUTES or not (
        n and n_tiles)


@pytest.mark.parametrize("tag", list(COMPACT_CASES))
def test_compaction_cases_model_match_grace_tpu(tag, model_launch):
    """The compaction's one launch (the numpy model of grace_compact_words
    through compact_words_cuda) at chip_smoke's COMPACT_CASES: rows of
    every bit at max_q equal to, one under and one over their count, rows
    counting max_q - 1, max_q and max_q + 1, max_q 0, 3, 7, 101, 361, 514
    and 4,099 (rows of ids off 16-byte lines: unaligned heads and tails),
    no words, no rows, widths of 1, 5 and 37 words and words off a 16-byte
    boundary (4-byte loads), rows past 128 words. Ids, n and overflow
    bit-equal to the plain version and to grace_tpu's compact_mask_words."""
    words, max_q = compact_inputs(tag, "cpu")
    want = tpb._compact_mask_words_plain(words, max_q)
    got = tpb.compact_words_cuda(words, max_q)
    assert model_launch == ["grace_compact_words"]
    for name, g, w in zip(("ids", "n", "overflow"), got, want):
        _bits_equal(g, w, f"{tag} {name}")
    if words.shape[1] and words.shape[0]:   # grace_tpu's compaction takes no row of no words
        j = jax.jit(jpb.compact_mask_words, static_argnums=1)(_np(words.contiguous()), max_q)
        for name, g, w in zip(("ids", "n", "overflow"), got, j):
            _bits_equal(g, w, f"{tag} {name} against grace_tpu")


def test_compaction_cases_reach_their_routes(model_launch):
    """Across COMPACT_CASES the model takes both load widths, stops a row
    past max_q, and writes 4-byte heads, 16-byte padding and 4-byte tails."""
    COMPACT_ROUTES.clear()
    for tag in COMPACT_CASES:
        tpb.compact_words_cuda(*compact_inputs(tag, "cpu"))
    assert COMPACT_ROUTES == {"16-byte loads", "4-byte loads", "stopped past max_q",
                              "4-byte head", "16-byte padding", "4-byte tail"}


@pytest.mark.parametrize("tag", list(BOX_SET_CASES))
def test_box_cases_plain_match_grace_tpu(tag):
    """The plain segment boxes at the box cases (NaN, +-inf and overflowing
    spheres among them) against grace_tpu's, jitted, at both blocks: equal
    values, NaN at the same places."""
    spheres, _, _ = box_set_inputs(tag, "cpu")
    js = jax.numpy.asarray(spheres.numpy())
    for block in (32, 128):
        for a, b in zip(tpb._segment_aabbs_plain(spheres, block),
                        jax.jit(jpb.segment_aabbs, static_argnums=1)(js, block)):
            _boxes_equal(a, b, f"segment boxes {block}")


@pytest.mark.parametrize("tag", TRI_CASES)
def test_tri_lists_model_matches_plain(tag, model_launch):
    rays, tris, tile, max_chunks, k = _tri_inputs(tag)
    want = tpt._dense_tile_segments_tri_plain(rays, tris, tile, max_chunks, k)
    before = tpt.tri_tile_lists_cuda.launches
    forced = TRI_LIST_FORCED.get(tag, {})
    TRI_ROUTES.clear()
    got = tpt.tri_tile_lists_cuda(rays, *tpt.tri_segment_aabbs(tris), tile, max_chunks, k,
                                  **forced)
    assert model_launch == ["grace_tri_tile_lists"]
    assert tpt.tri_tile_lists_cuda.launches == before + 1
    # the routes the case is for
    assert ("16-byte rows" if max_chunks % 4 == 0 else "4-byte rows") in TRI_ROUTES
    if "_warp_buf" in forced or tris.shape[0] > 128 * tpt.STAGE_SEGS:
        assert "scratch sort" in TRI_ROUTES
    if "_stage" in forced or tris.shape[0] > 128 * tpt.STAGE_SEGS:
        assert "boxes from device memory" in TRI_ROUTES
    if tris.shape[0] > 128 * tpt.STAGE_SEGS:
        assert "scratch chunks" in TRI_ROUTES
    if max_chunks == 2048:
        assert "clear runs" in TRI_ROUTES
    for a, b, name in zip(got, want, ("seg_ids", "seg_dist", "n_segs", "overflow")):
        _bits_equal(a, b, name)


@pytest.mark.parametrize("tag", [TRI_CASES[0], TRI_CASES[2], TRI_CASES[4]])
def test_tri_lists_model_device_memory_route(tag, model_launch, monkeypatch):
    """The routes past the warp's buffer and past the staged boxes, forced
    at a small size through the module's limits: a warp's buffer of 4
    entries, boxes staged up to 8 segments, a scratch of 3 rows for more
    tiles (3 warps take every tile); the same bits."""
    monkeypatch.setattr(tpt, "WARP_BUF", 4)
    monkeypatch.setattr(tpt, "STAGE_SEGS", 8)
    monkeypatch.setattr(tpt, "SORT_SLOTS", 3)
    rays, tris, tile, max_chunks, k = _tri_inputs(tag)
    want = tpt._dense_tile_segments_tri_plain(rays, tris, tile, max_chunks, k)
    TRI_ROUTES.clear()
    got = tpt.tri_tile_lists_cuda(rays, *tpt.tri_segment_aabbs(tris), tile, max_chunks, k)
    assert {"scratch sort", "boxes from device memory"} <= TRI_ROUTES or tris.shape[0] <= 8 * 128
    for a, b, name in zip(got, want, ("seg_ids", "seg_dist", "n_segs", "overflow")):
        _bits_equal(a, b, name)


def test_tri_lists_wrapper_launches_the_kernel(model_launch, monkeypatch):
    """``_dense_tile_segments_tri`` takes the kernel on a tensor that is
    not on the CPU (the route test made to say so here), and the kernel's
    wrapper refuses what the kernel does not take."""
    rays, tris, tile, max_chunks, k = _tri_inputs(TRI_CASES[0])
    want = tpt._dense_tile_segments_tri_plain(rays, tris, tile, max_chunks, k)
    monkeypatch.setattr(tpt, "_on_cpu", lambda t: False)
    monkeypatch.setattr(tpt, "_dense_tile_segments_tri_plain",
                        lambda *a, **kw: pytest.fail("the plain route was taken"))
    got = tpt._dense_tile_segments_tri(rays, tris, tile, max_chunks, k)
    assert model_launch == ["grace_tri_tile_lists"]
    for a, b, name in zip(got, want, ("seg_ids", "seg_dist", "n_segs", "overflow")):
        _bits_equal(a, b, name)
    boxes = tpt.tri_segment_aabbs(tris)
    with pytest.raises(ValueError, match="intervals"):
        tpt.tri_tile_lists_cuda(rays, *boxes, tile, max_chunks, tpt.MAX_INTERVALS + 1)
    with pytest.raises(ValueError, match="multiple"):
        tpt.tri_tile_lists_cuda(rays, *boxes, tile + 1, max_chunks, k)


def test_broadphase_wrappers_refuse_what_the_kernels_do_not_take():
    spheres, rays, tile = _bp_inputs(BP_CASES[0])
    with pytest.raises(ValueError, match="block"):
        tpb.broadphase_boxes_cuda(rays, tile, spheres, 64)
    with pytest.raises(ValueError, match="spheres"):
        tpb.broadphase_boxes_cuda(None, 1, spheres[:, :3], 32)
    with pytest.raises(ValueError, match="multiple"):
        tpb.broadphase_boxes_cuda(rays, tile + 1, spheres)
    with pytest.raises(ValueError, match="several devices"):
        tpb.broadphase_boxes_cuda(rays, tile, torch.empty((8, 4), device="meta"))
    with pytest.raises(TypeError):
        tpb.compact_words_cuda(torch.zeros((4, 2), dtype=torch.int64), 8)
    meta = torch.empty((8, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tpb.segment_aabbs(meta, 32)


@pytest.mark.parametrize("tag", BOX_CASES)
def test_overlap_box_reference_matches_grace_tpu(tag):
    """chip_smoke's overlap_words_reference, which the card's checks hold the
    overlap kernel to on given boxes, is grace_tpu's test and packing."""
    boxes = overlap_box_scene(tag)
    words, summary = overlap_words_reference(*(torch.from_numpy(b) for b in boxes))
    rmin, rmax, cmin, cmax = (jax.numpy.asarray(b) for b in boxes)
    if rmin.shape[0] == 0 or cmin.shape[0] == 0:
        assert words.shape == (rmin.shape[0], -(-cmin.shape[0] // 32))
        assert summary.shape == (rmin.shape[0], -(-words.shape[1] // 32))
        return
    overlap = ((rmin[:, None] <= cmax[None]) & (cmin[None] <= rmax[:, None])).all(-1)
    j_words = jpb.pack_overlap_bits(overlap)
    _bits_equal(words, j_words, "words")
    _bits_equal(summary, jpb.pack_overlap_bits(j_words != 0), "summary")


@pytest.mark.parametrize("summary", [False, True])
@pytest.mark.parametrize("tag", BOX_CASES)
def test_overlap_words_model_box_cases(tag, summary, model_launch):
    """The overlap kernel's design on given boxes: NaN columns beside
    overlapping ones, a word of NaN columns, NaN rows, boxes touching at -0
    and +0, a ragged last word and strip, rows past a block's rows, fewer
    than 32 columns, no rows, no columns; words and summary bit-equal to
    overlap_words_reference. The NaN case culls most words, and the
    overlapping columns beside NaN ones keep theirs."""
    boxes = [torch.from_numpy(b) for b in overlap_box_scene(tag)]
    want = overlap_words_reference(*boxes)
    stats = {}
    real = MODELS["grace_overlap_words"]
    MODELS["grace_overlap_words"] = lambda *a: real(*a, stats=stats)
    try:
        got = tpb.overlap_words_cuda(*boxes, summary=summary)
    finally:
        MODELS["grace_overlap_words"] = real
    assert model_launch == ["grace_overlap_words"]
    if summary:
        _bits_equal(got[0], want[0], "words")
        _bits_equal(got[1], want[1], "summary")
    else:
        _bits_equal(got, want[0], "words")
    if OVERLAP_BOX_CASES[tag][2] == "nan":
        w = want[0].numpy()
        assert (w[:, 3] == 0).all() and (w[7] == 0).all() and (w[40] == 0).all()
        live = np.setdiff1d(np.arange(w.shape[0]), [7, 40])
        assert ((w[live][:, np.arange(w.shape[1]) != 3] >> 1) & 1 == 1).all()
        assert stats["nonzero"] <= stats["candidates"] < w.size


def test_overlap_block_rows_cover_ragged_groups():
    """The row groups of the model's blocks are the kernel's (its
    constants), with groups of unequal size, and every size of the halving
    (256 down to 32) is reached."""
    import re

    src = open(_kernels.CSRC + "/broadphase.cu").read()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (consts["kStripWords"], consts["kMaxRows"], consts["kMinRows"],
            consts["kMinBlocks"]) == (STRIP_WORDS, MAX_ROWS, MIN_ROWS, MIN_BLOCKS)
    assert _block_rows(300, 2) == 32 and 300 % 32
    assert _block_rows(8192, 32) == 256 and _block_rows(4096, 32) == 128
    assert _block_rows(2048, 32) == 64 and _block_rows(2048, 8) == 32
    assert _block_rows(8192, 2) == 32 and _block_rows(10, 1) == 32


# ---- ROADMAP C22: the sort-free setup's cached camera constants --------------


@pytest.mark.parametrize("side", [64, 96, 128, 512])
def test_setup_constants_match_camera_numerics(side):
    """np.float32 extents and lengths: the cached constants are those of
    the caller's camera (``_camera_numerics`` and ``_tile_spans`` compute in
    the extent's type), bit for bit, and so grace_tpu's coords; a float
    camera of the same values, cached first, is another camera."""
    rng = np.random.default_rng(side)
    tiles = (32, 32)
    for ext, length in zip(F32(rng.uniform(0.3, 3.0, 25)), F32(rng.uniform(1.0, 9.0, 25))):
        for cam in (tsg.OrthoCamera(CAM, LOOK, UP, float(ext), float(length), side, side),
                    tsg.OrthoCamera(CAM, LOOK, UP, ext, length, side, side)):
            consts, spans, coords = tsg._setup_constants(cam, *tiles, "cpu")
            *_, x0, dx, y0, dy = tsg._camera_numerics(cam, "cpu")
            want = torch.stack([x0, x0.new_tensor(dx), y0, y0.new_tensor(dy)])
            assert torch.equal(coords.view(torch.int32), want.view(torch.int32))
            assert torch.equal(spans.view(torch.int32),
                               torch.cat(tsg._tile_spans(cam, *tiles, "cpu")).view(torch.int32))
            assert float(consts[12]) == float(F32(length))
            *_, jx0, jdx, jy0, jdy = jsg._camera_numerics(jsg.OrthoCamera(*cam))
            jc = np.array([jx0, jdx, jy0, jdy], F32)
            assert np.array_equal(coords.numpy().view(np.int32), jc.view(np.int32))
