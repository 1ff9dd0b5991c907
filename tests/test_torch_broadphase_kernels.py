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
  11,719 segments, 1.5M triangles): words, summaries, lists, counts and flags bit-equal,
  boxes equal in value (zero signs are the reductions' order's, C20),
  distances bit-equal with NaN where grace_tpu's are.
- numpy models of the five C entries, written as the kernels index their
  threads (a warp a box and a tile, lanes over its members; a block a
  strip of 32 words, each row tested against the words' hulls, a ballot
  a candidate word, the summary a ballot of the words;
  a warp a row of words, popcounts and a warp prefix sum; a block a tile,
  a warp a hull, a thread a segment, the listed segments pushed in any
  order and sorted by a bitonic network, the segments whose key is BIG
  placed by word counts and ballots), run through the port's own wrappers
  with the ctypes launch replaced by the model (which reads and writes the
  tensors' host memory), bit-equal to the plain versions (boxes and the
  zero signs as above), on the cases above, on clustered particles
  (2^14) and on the tests' torus; the triangle lists also on the
  device-memory route, forced at a small size with fewer scratch rows
  than tiles.
- ROADMAP C22: the sort-free setup's cached camera constants equal
  ``_camera_numerics`` / ``_tile_spans`` of the caller's camera and
  ``grace_tpu``'s, for np.float32 extents and lengths, after a float
  camera of the same values has filled the cache.
"""

import ctypes

import jax
import numpy as np
import pytest
import torch

import grace_tpu.trace.pallas_broadphase as jpb
import grace_tpu.trace.pallas_render as jpr
import grace_tpu.trace.pallas_tri as jpt
import grace_tpu.trace.splat_grad as jsg
from grace_tpu.core.types import Rays as JRays
from chip_smoke import (BROADPHASE_CASES, CAM, LOOK, OVERLAP_BOX_CASES, TRI_LIST_CASES, UP,
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


def _model_segment_boxes(spheres, seg_min, seg_max, n, block):
    """grace_segment_boxes: warp b = box b, lane l = spheres b * block + l,
    l + 32, ...; past n the padding's (+F32_MAX, -F32_MAX)."""
    assert spheres % 16 == 0 and block in (32, 128)
    n_boxes = -(-n // 128) * (128 // block)
    s = _view(spheres, ctypes.c_float, 4 * n).reshape(n, 4)
    lo = np.concatenate([s[:, :3] - s[:, 3:], np.full((n_boxes * block - n, 3), F32_MAX, F32)])
    hi = np.concatenate([s[:, :3] + s[:, 3:], np.full((n_boxes * block - n, 3), -F32_MAX, F32)])
    for ptr, v, op, init in ((seg_min, lo, _nan_min, np.inf), (seg_max, hi, _nan_max, -np.inf)):
        lanes = np.moveaxis(_lanes(v.reshape(n_boxes, block, 3), init, 3), -1, 0)
        _view(ptr, ctypes.c_float, 3 * n_boxes).reshape(n_boxes, 3)[:] = \
            np.moveaxis(_warp_reduce(op, lanes), 0, -1)


def _model_tile_boxes(origins, dirs, lengths, tmin, tmax, n_tiles, tile):
    """grace_tile_boxes: warp t = tile t, lanes over its rays; each ray's
    origin and endpoint (fma_f64) folded in, then the butterfly."""
    r = n_tiles * tile
    o = _view(origins, ctypes.c_float, 3 * r).reshape(n_tiles, tile, 3)
    d = _view(dirs, ctypes.c_float, 3 * r).reshape(n_tiles, tile, 3)
    ln = _view(lengths, ctypes.c_float, r).reshape(n_tiles, tile, 1)
    e = _fma_f64(d, ln, o)
    for ptr, op, init in ((tmin, _nan_min, np.inf), (tmax, _nan_max, -np.inf)):
        per_ray = op(o, e)
        lanes = np.moveaxis(_lanes(per_ray, init, 3), -1, 0)
        _view(ptr, ctypes.c_float, 3 * n_tiles).reshape(n_tiles, 3)[:] = \
            np.moveaxis(_warp_reduce(op, lanes), 0, -1)


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


def _model_compact_words(words, ids, n, overflow, n_rows, n_words, max_q):
    """grace_compact_words: warp r = row r; 32 words a round, the words'
    popcounts' warp prefix sum places each lane's bits, written lowest
    first while below max_q; the warp stops once its count passes max_q;
    the row's tail is zeroed."""
    w_all = _view(words, ctypes.c_int32, n_rows * n_words).reshape(n_rows, n_words)
    out = _view(ids, ctypes.c_int32, n_rows * max_q).reshape(n_rows, max_q)
    n_out = _view(n, ctypes.c_int32, n_rows)
    ovf = _view(overflow, ctypes.c_uint8, n_rows)
    for r in range(n_rows):
        total, base = 0, 0
        while base < n_words and total <= max_q:
            chunk = np.zeros(32, np.uint32)
            m = min(32, n_words - base)
            chunk[:m] = w_all[r, base:base + m].view(np.uint32)
            bits = (chunk[:, None] >> np.arange(32, dtype=np.uint32)) & 1
            count = bits.sum(axis=1).astype(np.int64)
            at = total + np.cumsum(count) - count
            for lane in range(32):
                for b in np.flatnonzero(bits[lane]):
                    if at[lane] < max_q:
                        out[r, at[lane]] = 32 * (base + lane) + b
                        at[lane] += 1
            total += int(count.sum())
            base += 32
        k = min(total, max_q)
        out[r, k:] = 0
        n_out[r], ovf[r] = k, total > max_q


def _order_bits(key):
    """The kernel's sort bits of f32 keys (+-0, positive or NaN)."""
    b = np.where(key == 0, F32(0), key).view(np.uint32)
    return np.where(np.isnan(key), np.uint32(0xFFFFFFFF), b)


def _bitonic(buf, width):
    """The kernel's network over buf[:width] (a power of 2), in place."""
    k = 2
    while k <= width:
        j = k >> 1
        while j:
            i = np.arange(width)
            p = i ^ j
            sel = p > i
            i, p = i[sel], p[sel]
            a, b = buf[i].copy(), buf[p].copy()
            swap = (a > b) == ((i & k) == 0)
            buf[i[swap]], buf[p[swap]] = b[swap], a[swap]
            j >>= 1
        k <<= 1


def _model_tri_tile_lists(seg_min, seg_max, origins, dirs, lengths, frac, seg_ids, seg_dist, n,
                          overflow, scratch, n_tiles, tile, n_segs, K, max_chunks, slots):
    """grace_tri_tile_lists: block b takes tiles b, b + grid, ...; a warp a
    hull task, lanes over the tile's rays; a thread a segment, its buffer
    entry pushed at an atomic counter (here in a random order); the
    bitonic network; the sorted entries around the BIG group, which a warp
    places 32 ids a step by the word counts' prefix sum and a ballot; the
    pads. slots > 0: the buffer is block b's row of the scratch."""
    rng = np.random.default_rng(n_tiles + n_segs)
    cap = 1 << max(0, n_segs - 1).bit_length()
    if slots == 0:
        assert cap <= tpt.SHARED_SORT
        grid, buf_all = n_tiles, np.zeros((n_tiles, cap), np.uint64)
    else:
        grid = min(n_tiles, slots)
        buf_all = _view(scratch, ctypes.c_uint64, slots * cap).reshape(slots, cap)
    r = n_tiles * tile
    smin = _view(seg_min, ctypes.c_float, 3 * n_segs).reshape(n_segs, 3)
    smax = _view(seg_max, ctypes.c_float, 3 * n_segs).reshape(n_segs, 3)
    o = _view(origins, ctypes.c_float, 3 * r).reshape(n_tiles, tile, 3)
    d = _view(dirs, ctypes.c_float, 3 * r).reshape(n_tiles, tile, 3)
    ln = _view(lengths, ctypes.c_float, r).reshape(n_tiles, tile)
    fr = _view(frac, ctypes.c_float, K + 1)
    ids_o = _view(seg_ids, ctypes.c_int32, n_tiles * max_chunks).reshape(n_tiles, max_chunks)
    dist_o = _view(seg_dist, ctypes.c_float, n_tiles * max_chunks).reshape(n_tiles, max_chunks)
    n_o, ovf_o = _view(n, ctypes.c_int32, n_tiles), _view(overflow, ctypes.c_uint8, n_tiles)
    keep = min(max_chunks, n_segs)
    big = F32(tpt.BIG)
    clamp0 = lambda v: np.where(np.isnan(v), v, _fmax(v, F32(0))).astype(F32)
    n_words = -(-n_segs // 32)
    with np.errstate(all="ignore"):
        for t in range(n_tiles):
            buf = buf_all[t % grid]
            lt = clamp0(ln[t])                                       # [tile]
            pts = _fma_f64(d[t][None], (lt[None, :] * fr[:, None])[..., None], o[t][None])
            hull = lambda v, op, init: np.moveaxis(
                _warp_reduce(op, np.moveaxis(_lanes(v, init, v.shape[-1]), -1, 0)), 0, -1)
            bmin, bmax = hull(pts, _nan_min, np.inf), hull(pts, _nan_max, -np.inf)  # [K+1, 3]
            omin, omax = hull(o[t], _nan_min, np.inf), hull(o[t], _nan_max, -np.inf)
            ln_min = hull(lt[:, None], _nan_min, np.inf)[0]
            imin, imax = _nan_min(bmin[:-1], bmin[1:]), _nan_max(bmax[:-1], bmax[1:])
            # the intervals' union without NaN bounds, then the intervals
            umin = np.where(np.isnan(imin), np.inf, imin).min(axis=0)
            umax = np.where(np.isnan(imax), -np.inf, imax).max(axis=0)
            near = np.all((umin <= smax) & (smin <= umax), axis=1)
            kfirst = np.full(n_segs, K)
            for k in range(K - 1, -1, -1):
                hit = near & np.all((imin[k] <= smax) & (smin <= imax[k]), axis=1)
                kfirst = np.where(hit, k, kfirst)
            listed = np.flatnonzero(kfirst < K)
            g = clamp0(_nan_max(smin[listed] - omax, omin - smax[listed]))
            g2 = _fma_f64(g[:, 2], g[:, 2], _fma_f64(g[:, 0], g[:, 0], g[:, 1] * g[:, 1]))
            root = np.sqrt(g2.astype(np.float64)).astype(F32)
            key = _nan_max(root, (fr[kfirst[listed]] * ln_min).astype(F32))
            push = key != big
            n_lt = int((key < big).sum())
            entries = (_order_bits(key[push]).astype(np.uint64) << np.uint64(32)) | \
                listed[push].astype(np.uint64)
            m = entries.shape[0]
            buf[:m] = entries[rng.permutation(m)]
            width = 1 << max(0, m - 1).bit_length()
            buf[m:width] = np.uint64(~np.uint64(0))
            _bitonic(buf, width)
            mask = np.zeros(n_words * 32, bool)
            mask[listed[push]] = True
            valid = np.arange(n_words * 32) < n_segs
            in_big = (~mask & valid).reshape(n_words, 32)
            prefix = np.cumsum(in_big.sum(axis=1)) - in_big.sum(axis=1)
            n_big = n_segs - m
            for i in range(m):
                c = i if i < n_lt else i + n_big
                if c < keep:
                    e = int(buf[i])
                    ids_o[t, c] = e & 0xFFFFFFFF
                    hi = np.uint32(e >> 32)
                    dist_o[t, c] = (np.uint32(0x7FFFFFFF).view(F32) if hi == 0xFFFFFFFF
                                    else hi.view(F32))
            for w in range(n_words):
                if n_lt + prefix[w] >= keep:
                    break
                lanes = np.flatnonzero(in_big[w])
                c = n_lt + prefix[w] + np.arange(lanes.shape[0])
                ok = c < keep
                ids_o[t, c[ok]], dist_o[t, c[ok]] = 32 * w + lanes[ok], big
            ids_o[t, keep:], dist_o[t, keep:] = 0, big
            n_o[t], ovf_o[t] = min(listed.shape[0], max_chunks), listed.shape[0] > max_chunks


MODELS = {"grace_segment_boxes": _model_segment_boxes,
          "grace_tile_boxes": _model_tile_boxes,
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
    """broadphase_outputs' names through the kernels' wrappers."""
    tmin, tmax = tbp.tile_boxes_cuda(rays, tile)
    out = {"tile box min": tmin, "tile box max": tmax}
    for b in (32, 128):
        out[f"segment box min ({b})"], out[f"segment box max ({b})"] = \
            tpb.segment_boxes_cuda(spheres, b)
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
    counters = (tbp.tile_boxes_cuda, tpb.segment_boxes_cuda, tpb.overlap_words_cuda,
                tpb.compact_words_cuda)
    before = [fn.launches for fn in counters]
    got = _kernel_outputs(spheres, rays, tile, max_qs)
    assert [fn.launches - b for fn, b in zip(counters, before)] == [1, 2, 4, 3 + len(max_qs)]
    assert set(model_launch) == {"grace_tile_boxes", "grace_segment_boxes",
                                 "grace_overlap_words", "grace_compact_words"}
    assert set(got) == set(want)
    for name, w in want.items():
        (_boxes_equal if "box" in name else _bits_equal)(got[name], w, name)


@pytest.mark.parametrize("tag", BP_CASES)
def test_broadphase_wrappers_launch_the_kernels(tag, model_launch, monkeypatch):
    """The public functions on a tensor that is not on the CPU take the
    kernel route, each step one launch: run here on CPU tensors by making
    the wrappers' device test say "not the CPU"."""
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
    got = {}
    tmin, tmax = tpb.tile_aabbs(rays, tile)
    got["segment words"] = tpb.masks_for_tile_aabbs(tmin, tmax, spheres)
    assert torch.equal(tpb.dense_tile_masks(rays, spheres, tile), got["segment words"])
    got["quarter words"], got["quarter summary"] = tpb.dense_tile_masks_quarter(rays, spheres,
                                                                               tile)
    for what, xs in (("quarter_lists", tpb.quarter_lists(rays, spheres, tile, max_qs[0])),
                     ("dense_tile_segments", tpb.dense_tile_segments(rays, spheres, tile, 2048)),
                     ("dense_segment_tiles", tpr.dense_segment_tiles(rays, spheres, tile, 2048)),
                     (f"compact (max_q {max_qs[-1]})",
                      tpb.compact_mask_words(got["quarter words"], max_qs[-1]))):
        for name, x in zip(("ids", "n", "overflow"), xs):
            got[f"{what} {name}"] = x
    for name, x in got.items():
        _bits_equal(x, want[name], name)


@pytest.mark.parametrize("tag", TRI_CASES)
def test_tri_lists_model_matches_plain(tag, model_launch):
    rays, tris, tile, max_chunks, k = _tri_inputs(tag)
    want = tpt._dense_tile_segments_tri_plain(rays, tris, tile, max_chunks, k)
    before = tpt.tri_tile_lists_cuda.launches
    got = tpt.tri_tile_lists_cuda(rays, *tpt.tri_segment_aabbs(tris), tile, max_chunks, k)
    assert model_launch == ["grace_tri_tile_lists"]
    assert tpt.tri_tile_lists_cuda.launches == before + 1
    for a, b, name in zip(got, want, ("seg_ids", "seg_dist", "n_segs", "overflow")):
        _bits_equal(a, b, name)


@pytest.mark.parametrize("tag", [TRI_CASES[0], TRI_CASES[2], TRI_CASES[4]])
def test_tri_lists_model_device_memory_route(tag, model_launch, monkeypatch):
    """The route past the shared-memory sort, forced at a small size: a
    scratch of 3 rows for more tiles, the blocks striding over them; the
    same bits."""
    monkeypatch.setattr(tpt, "SHARED_SORT", 4)
    monkeypatch.setattr(tpt, "SORT_SLOTS", 3)
    rays, tris, tile, max_chunks, k = _tri_inputs(tag)
    want = tpt._dense_tile_segments_tri_plain(rays, tris, tile, max_chunks, k)
    got = tpt.tri_tile_lists_cuda(rays, *tpt.tri_segment_aabbs(tris), tile, max_chunks, k)
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
        tpb.segment_boxes_cuda(spheres, 64)
    with pytest.raises(ValueError, match="spheres"):
        tpb.segment_boxes_cuda(spheres[:, :3], 32)
    with pytest.raises(ValueError, match="multiple"):
        tbp.tile_boxes_cuda(rays, tile + 1)
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
