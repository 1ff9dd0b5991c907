"""The splat's two setups (bucketed and sort-free) against grace_tpu, and
the design of their CUDA kernels (``csrc/splat_prep.cu``) as numpy models.

- ``_bucket_prims_ortho_plain`` and ``_sortfree_setup_plain`` against
  ``grace_tpu`` (jitted on the CPU) at every case of chip_smoke's
  ``SPLAT_PREP_CASES`` (n not a multiple of chunk, 2 chunk or 128; n < 32;
  segment counts that are and are not multiples of 32; 128 tiles; band
  None, 16, 32 and 64; weights None and given; dead particles; overflow),
  every output bit-equal.
- numpy models of the three launch entries, written as the kernels index
  their threads (E4: a block a tile of particles in rounds of its
  threads, each warp's 32 keys grouped as __match_any_sync groups them;
  pass 1 counting each group into the block's counters, pass 2 ranking
  each instance by its group's lower lanes and its key's groups in the
  round's lower warps, writing its row at its slot, the ranges and the
  overflow byte from the scan, every slab column written once; E5: a warp
  a segment, the box reduced over its lanes, four particles and one float4
  of each slab row a lane, one ballot word per tile row and per transposed
  row), run through the port's own wrappers with the ctypes launch
  replaced by the model (which reads and writes the tensors' host memory),
  bit-equal to the plain versions; E4 also at block tiles forced small
  (ragged blocks, fewer than 32 particles, none, one key over many
  blocks, the counters in device memory).
- ROADMAP C21: grace_tpu converts the band quotients to int32 (saturating),
  the port to int64, so a live particle beyond 2^31 band widths whose
  footprint spans bands is flagged by the port and not by grace_tpu.
"""

import ctypes
import os
import re

import jax
import numpy as np
import pytest
import torch

import grace_tpu.trace.splat as js
import grace_tpu.trace.splat_grad as jsg
from grace_tpu.core.types import make_spheres
from grace_tpu.trace.pallas_broadphase import pack_overlap_bits as j_pack
from chip_smoke import (CAM, LENGTH, LOOK, SPLAT_PREP_CASES, UP, VEXT,
                        make_clustered_particles, splat_prep_scene)
from grace_tpu_torch import _kernels
import grace_tpu_torch.trace.splat as ts
import grace_tpu_torch.trace.splat_grad as tsg
from tests.helper.torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

CASES = list(SPLAT_PREP_CASES)
F32 = np.float32


def _case(tag):
    n, side, (tile_w, tile_h), band, chunk, *_ = SPLAT_PREP_CASES[tag]
    s, w = splat_prep_scene(tag)
    return s, w, side, tile_w, tile_h, band, chunk


def _torch(s, w):
    return torch.from_numpy(s), None if w is None else torch.from_numpy(w)


def _plain_buckets(s, w, side, tile_w, tile_h, band, chunk):
    st, wt = _torch(s, w)
    return ts._bucket_prims_ortho_plain(st, CAM, LOOK, UP, VEXT, LENGTH, side, side, tile_w,
                                        tile_h, chunk, wt, tile_h if band is None else band)


def _plain_setup(s, w, side, tile_w, tile_h):
    st, wt = _torch(s, w)
    cam = tsg.OrthoCamera(CAM, LOOK, UP, VEXT, LENGTH, side, side)
    return tsg._sortfree_setup_plain(st, wt, cam, tile_w, tile_h)


@pytest.mark.parametrize("tag", CASES)
def test_bucket_plain_matches_grace_tpu(tag):
    s, w, side, tile_w, tile_h, band, chunk = _case(tag)
    jb = js.bucket_prims_ortho(s, CAM, LOOK, UP, VEXT, LENGTH, side, side, tile_w=tile_w,
                               tile_h=tile_h, chunk=chunk, weights=w, band=band)
    tb = _plain_buckets(s, w, side, tile_w, tile_h, band, chunk)
    for f in js.SplatBuckets._fields:
        a, b = np.asarray(getattr(jb, f)), getattr(tb, f).numpy()
        assert a.shape == b.shape and np.array_equal(a, b), f
    assert int((tb.last - tb.first).sum()) > 0


def _j_setup(s, w, side, tile_w, tile_h):
    cam = jsg.OrthoCamera(CAM, LOOK, UP, VEXT, LENGTH, side, side)

    @jax.jit
    def setup(spheres, weights):
        proj = jsg.project_ortho(spheres, weights, cam)
        overlap = jsg.projected_overlap(*proj, cam, tile_w, tile_h)
        *_, x0, dx, y0, dy = jsg._camera_numerics(cam)
        return (j_pack(overlap), j_pack(overlap.T), jax.numpy.stack([x0, dx, y0, dy]),
                jsg.pack_proj_slabs(*proj))

    w = np.ones(s.shape[0], F32) if w is None else w
    return setup(make_spheres(s[:, :3], s[:, 3]), w)


@pytest.mark.parametrize("tag", CASES)
def test_sortfree_setup_plain_matches_grace_tpu(tag):
    s, w, side, tile_w, tile_h, _, _ = _case(tag)
    want = _j_setup(s, w, side, tile_w, tile_h)
    got = _plain_setup(s, w, side, tile_w, tile_h)
    for name, a, b in zip(("masks", "masks_t", "coords", "slabs"), want, got):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape and np.array_equal(a, b), name
    assert got[0].any() and got[1].any()


# ---- numpy models of csrc/splat_prep.cu's C entries -------------------------


def _view(ptr, ctype, count):
    """The ``count`` values of C type ``ctype`` at host address ``ptr``,
    as a writable numpy array."""
    if count == 0:
        return np.zeros(0, np.ctypeslib.as_array((ctype * 1)()).dtype)
    return np.ctypeslib.as_array((ctype * count).from_address(ptr))


def _fma_f64(a, b, c):
    """vecmath.fma / the kernels' fma_f64: the exact f64 product plus c,
    rounded to f64, then to f32."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(F32)


def _dot3(x, y, z, c):
    return _fma_f64(z, c[2], _fma_f64(y, c[1], x * c[0]))


def _project(s, consts):
    x, y, z, h = (s[:, k] for k in range(4))
    pu = _dot3(x, y, z, consts[3:6])
    pv = _dot3(x, y, z, consts[6:9])
    depth = _dot3(x - consts[9], y - consts[10], z - consts[11], consts[0:3])
    return pu, pv, depth, h


def _prep_constants():
    """csrc/splat_prep.cu's E4 block shape: (threads a block, particles a
    thread loads at once, bins counted in shared memory at most)."""
    with open(os.path.join(_kernels.CSRC, "splat_prep.cu")) as f:
        src = f.read()
    consts = {name: int(v) for name, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    return consts["kPrepThreads"], consts["kLoads"], consts["kSharedBins"]


THREADS, LOADS, SHARED_BINS = _prep_constants()
WARPS = THREADS // 32


def _particles(spheres, weights, consts, n, nbx, nty, n_keys):
    """particle_keys (vectorized over p): (keys [4, n], instance q = 2 rr
    + cc, sentinel n_keys; rows f32[n, 4], (pu, pv, invh, scale) as the
    slabs take them; over bool[n], a live footprint past 2 x 2 keys)."""
    s = _view(spheres, ctypes.c_float, 4 * n).reshape(n, 4)
    c = _view(consts, ctypes.c_float, ts.BUCKET_CONSTS)
    keys = np.full((4, n), n_keys, np.int64)
    if n == 0:
        return keys, np.zeros((0, 4), F32), np.zeros(0, bool)
    with np.errstate(all="ignore"):
        pu, pv, depth, h = _project(s, c)
        positive = h > 0
        inv_h2 = np.where(positive, F32(1) / np.fmax(h * h, F32(1e-30)), F32(0))
        w_p = inv_h2 if weights is None else _view(weights, ctypes.c_float, n) * inv_h2
        live = positive & (depth >= 0) & (depth < c[12])
        scale = np.where(live, w_p, F32(0))
        q = lambda a, step: np.floor(a / step).astype(np.int64)
        cb_lo, cb_hi = q((pu - h) - c[13], c[15]), q((pu + h) - c[13], c[15])
        rt_lo, rt_hi = q((pv + h) - c[14], c[16]), q((pv - h) - c[14], c[16])
        over = live & ((cb_hi - cb_lo > 1) | (rt_hi - rt_lo > 1))
        cb_hi = np.minimum(cb_hi, cb_lo + 1)
        rt_hi = np.minimum(rt_hi, rt_lo + 1)
        for rr in range(2):
            for cc in range(2):
                cb, rt = cb_lo + cc, rt_lo + rr
                ok = ((cb <= cb_hi) & (rt <= rt_hi) & (cb >= 0) & (cb < nbx) & (rt >= 0)
                      & (rt < nty) & (scale > 0))
                keys[rr * 2 + cc] = np.where(ok, rt * nbx + cb, n_keys)
        invh = np.where(positive, F32(1) / np.fmax(h, F32(1e-30)), F32(0))
        if weights is None:
            invh_s = np.where(live, invh, F32(0))
            scale_s = invh_s * invh_s
        else:
            invh_s, scale_s = invh, scale
    return keys, np.stack([pu, pv, invh_s, scale_s], axis=1), over


def _block_rounds(n, tile, blocks):
    """Block b's particles as its rounds: (p [blocks, rounds, WARPS, 32],
    particle b tile + r THREADS + 32 w + l of round r, warp w, lane l;
    valid, p inside the block's tile and below n). The kernels run a
    block's rounds LOADS at a time (each thread's particles loaded first);
    a round past the block's particles is a no-op in both passes."""
    rounds = max(1, -(-min(tile, n) // THREADS))
    p = (np.arange(blocks)[:, None, None, None] * tile
         + np.arange(rounds)[None, :, None, None] * THREADS
         + np.arange(WARPS)[None, None, :, None] * 32 + np.arange(32))
    end = np.minimum((np.arange(blocks) + 1) * tile, n)[:, None, None, None]
    return p, p < end


def _round_keys(keys, q, p, valid):
    """Instance q's keys of a round's lanes [blocks, WARPS, 32] (-1 for
    the lanes past the block's particles)."""
    if keys.shape[1] == 0:
        return np.full(p.shape, -1, np.int64)
    return np.where(valid, keys[q][np.minimum(p, keys.shape[1] - 1)], -1)


def _match(k):
    """__match_any_sync over each row of k [rows, 32]: (group size, the
    lane's rank among its group's lower lanes, is the group's first lane)."""
    eq = k[:, :, None] == k[:, None, :]
    lower = np.tril(np.ones((32, 32), bool), -1)          # lane j < lane l
    return eq.sum(-1), (eq & lower[None]).sum(-1), ~(eq & lower[None]).any(-1)


def _groups(k):
    """__match_any_sync over each warp of k [blocks, WARPS, 32]: (group
    size, the lane's rank among its group's lower lanes, the lane leads a
    group of a key >= 0)."""
    size, rank, first = (a.reshape(k.shape) for a in _match(k.reshape(-1, 32)))
    return size, rank, first & (k >= 0)


def _model_bucket_keys(spheres, weights, consts, counts, n, tile, nbx, nty, n_keys):
    """grace_splat_bucket_keys (pass 1): block b takes particles b tile ..
    (b + 1) tile a round of THREADS at a time; for each q a warp's lanes
    grouped by key, each group's first lane adds its size to the block's
    (q, bin) counter (in shared memory up to SHARED_BINS bins, else the
    block's own column of the device counters: the same sums); then the
    block's column, key-major: counts[bin * tiles + q * blocks + b], and
    its overflow flag in row n_keys + 1; the blocks zero pass 2's scan
    state after the counters."""
    blocks = max(1, -(-n // tile))
    n_bins = n_keys + 1
    flat = _view(counts, ctypes.c_int32, (n_bins + 1) * 4 * blocks + 2 * (n_bins + 2))
    flat[(n_bins + 1) * 4 * blocks:] = 0
    out = flat[:(n_bins + 1) * 4 * blocks].reshape(n_bins + 1, 4, blocks)
    keys, _, over = _particles(spheres, weights, consts, n, nbx, nty, n_keys)
    p, valid = _block_rounds(n, tile, blocks)
    column = np.zeros((blocks, 4, n_bins), np.int64)
    for r in range(p.shape[1]):
        for q in range(4):
            k = _round_keys(keys, q, p[:, r], valid[:, r])
            size, _, lead = _groups(k)
            b, w, lane = np.nonzero(lead)
            np.add.at(column, (b, q, k[b, w, lane]), size[b, w, lane])
    out[:n_bins] = column.transpose(2, 1, 0)
    flags = np.zeros(blocks, bool)
    np.logical_or.at(flags, np.arange(n) // tile, over)
    out[n_bins] = 0
    out[n_bins, 0] = flags


def _model_bucket_pack(spheres, weights, consts, counts, slabs, ranges, overflow, n, cap, chunk,
                       tile, nbx, nty, n_keys):
    """grace_splat_bucket_pack (pass 2): the counters' exclusive scan in
    place, key-major (the rows by ticket, chained by their look-back
    words: the same sums in row order), each key's range and, from the
    flag row's total, the overflow byte; block b's cursors start at its
    pairs' first slots, the scanned counts[c] (c = bin * tiles + q *
    blocks + b); a
    round's instance of key k takes the cursor plus the sizes of k's groups
    in the round's lower warps (the bytes below its warp's in k's word of
    warp counts) plus its rank among its group's lower lanes, and writes
    its row at that slot's slab position; then each group's first lane
    moves the cursor on by the group's size and clears its byte. The grid
    zeroes the columns [4 n, cap). Every slab column below cap is written
    exactly once. Past SHARED_BINS bins the cursors end in the block's
    column of the counters and the words (all clear) in the scratch after
    the scan state."""
    blocks = max(1, -(-n // tile))
    tiles, n_bins = 4 * blocks, n_keys + 1
    rows_n = n_bins + 1                                          # the flag row last
    words = 0 if n_bins <= SHARED_BINS else 8 * n_bins * blocks
    flat = _view(counts, ctypes.c_int32, rows_n * tiles + 2 * (n_bins + 2) + words)
    cnt = flat[:rows_n * tiles]
    totals = cnt.reshape(rows_n, tiles).astype(np.int64).sum(1)
    inclusive = np.cumsum(totals)
    sc = (np.cumsum(cnt.astype(np.int64)) - cnt).astype(np.int64)   # exclusive, in place
    cnt[:] = sc
    state = flat[rows_n * tiles:rows_n * tiles + 2 * (n_bins + 2)].view(np.uint64)
    state[0] = (rows_n + blocks) | rows_n << 32                 # tickets taken, rows done
    state[1:] = (2 << 32) | inclusive.astype(np.uint64)           # each row's inclusive word
    out = _view(slabs, ctypes.c_float, 4 * cap)
    keys, rows, _ = _particles(spheres, weights, consts, n, nbx, nty, n_keys)
    pair = (np.arange(n_bins)[None, :, None] * tiles + np.arange(4)[:, None, None] * blocks
            + np.arange(blocks))                                     # [q, bin, b]
    cursor = sc[pair].transpose(2, 0, 1).copy()
    p, valid = _block_rounds(n, tile, blocks)
    lower = np.arange(WARPS)[None, :] < np.arange(WARPS)[:, None]   # [w, v]: v below w
    at = np.broadcast_to(np.arange(blocks)[:, None, None], p.shape[:1] + p.shape[2:])
    written = np.zeros(cap, np.int64)
    for r in range(p.shape[1]):
        for q in range(4):
            k = _round_keys(keys, q, p[:, r], valid[:, r])
            size, rank, lead = _groups(k)
            # the lower warps' counts: the sizes of the lane's key's groups
            listed = ((k[:, :, :, None, None] == k[:, None, None, :, :])
                      & lead[:, None, None, :, :] & lower[None, :, None, :, None])
            g = (cursor[at, q, np.maximum(k, 0)] + (listed * size[:, None, None]).sum((3, 4))
                 + rank)
            on = k >= 0
            g, src = g[on], p[:, r][on]
            base = (g // chunk) * 4 * chunk + g % chunk
            for comp in range(4):
                out[base + comp * chunk] = rows[src, comp]
            np.add.at(written, g, 1)
            b, w, lane = np.nonzero(lead)
            np.add.at(cursor, (b, q, k[b, w, lane]), size[b, w, lane])
    g = np.arange(4 * n, cap)
    base = (g // chunk) * 4 * chunk + g % chunk
    for comp in range(4):
        out[base + comp * chunk] = 0
    written[g] += 1
    assert (written == 1).all(), "a slab column below cap written other than once"
    if n_bins > SHARED_BINS:   # the cursors and words lived in device memory
        cnt[pair.transpose(2, 0, 1).reshape(-1)] = cursor.reshape(-1)
        flat[rows_n * tiles + 2 * (n_bins + 2):] = 0
    k = np.arange(n_keys)
    f, last = inclusive[k] - totals[k], inclusive[k]
    per_slab = 2 * chunk
    lo = f // per_slab
    out_ranges = _view(ranges, ctypes.c_int32, 4 * n_keys).reshape(4, n_keys)
    out_ranges[:] = (f, last, lo, np.maximum((last + per_slab - 1) // per_slab - lo, 0))
    _view(overflow, ctypes.c_uint8, 1)[0] = totals[-1] != 0


def _model_sortfree_setup(spheres, weights, consts, spans, slabs, masks, masks_t, n, ntx,
                          nty):
    """grace_sortfree_setup: block b = segments 32 b .. 32 b + 31 (word b),
    warp j = segment 32 b + j; lane l projects particles 4 l .. 4 l + 3 of
    it (all four loaded first) and writes each slab row's float4 l (slab
    row r of the segment is float4s 32 r .. 32 r + 31: rows 4-7 zeros); the
    warp reduces the live-masked box over its lanes (each lane's four, then
    the butterfly); then one ballot over the block's 32 segments per tile,
    and warp j one ballot over 32 tiles per word of its segment's
    transposed row."""
    seg = tsg.SEG
    n_segs = -(-n // seg)
    blocks = -(-n_segs // 32)
    n_tiles = ntx * nty
    words_t = -(-n_tiles // 32)
    s = _view(spheres, ctypes.c_float, 4 * n).reshape(n, 4)
    c = _view(consts, ctypes.c_float, tsg.SETUP_CONSTS)
    sp_ = _view(spans, ctypes.c_float, 2 * ntx + 2 * nty)
    tx_lo, tx_hi = sp_[:ntx], sp_[ntx:2 * ntx]
    ty_lo, ty_hi = sp_[2 * ntx:2 * ntx + nty], sp_[2 * ntx + nty:]
    assert slabs % 16 == 0
    float4s = _view(slabs, ctypes.c_float, n_segs * 8 * seg).reshape(n_segs, 8, 32, 4)
    words = _view(masks, ctypes.c_int32, n_tiles * blocks).reshape(n_tiles, blocks)
    words_tr = _view(masks_t, ctypes.c_int32, n_segs * words_t).reshape(n_segs, words_t)
    big = F32(3.4e38)
    # lane l of warp j holds particles 4 l + k of segment j: [segment, lane, k]
    held = np.zeros((n_segs * seg, 4), F32)
    held[:n] = s
    held = held.reshape(n_segs, 32, 4, 4)
    have = (np.arange(n_segs * seg) < n).reshape(n_segs, 32, 4)
    w = np.ones(n_segs * seg, F32)
    if weights is not None:
        w[:n] = _view(weights, ctypes.c_float, n)
    w = w.reshape(n_segs, 32, 4)
    with np.errstate(all="ignore"):
        pu, pv, depth, h = _project(held.reshape(-1, 4), c)
        pu, pv, depth, h = (a.reshape(n_segs, 32, 4) for a in (pu, pv, depth, h))
        inv_h = np.where(h > 0, F32(1) / h, F32(0))
        live = (h > 0) & (depth >= 0) & (depth < c[12])
        scale = np.where(live, (w * inv_h) * inv_h, F32(0))
        h_eff = F32(1) / np.fmax(inv_h, F32(1e-30))
    rows = [np.where(have, a, F32(0)) for a in (pu, pv, inv_h, scale)]
    for r in range(8):
        float4s[:, r] = rows[r] if r < 4 else F32(0)
    on = have & (rows[3] > 0)
    # the reduction is exact (fminf / fmaxf, no NaN): a lane's four, then
    # the butterfly over the lanes
    box = np.full((blocks * 32, 4), (big, -big, big, -big), F32)
    for k, (a, v, red) in enumerate(((pu - h_eff, big, np.fmin), (pu + h_eff, -big, np.fmax),
                                     (pv - h_eff, big, np.fmin), (pv + h_eff, -big, np.fmax))):
        per_lane = red.reduce(np.where(on, a, v), axis=2)          # [segment, lane]
        box[:n_segs, k] = _warp_butterfly(red, per_lane)
    t = np.arange(n_tiles)
    r, col = t // ntx, t % ntx
    over = ((box[None, :, 0] <= tx_hi[col][:, None]) & (box[None, :, 1] >= tx_lo[col][:, None])
            & (box[None, :, 2] <= ty_hi[r][:, None]) & (box[None, :, 3] >= ty_lo[r][:, None]))
    over &= (np.arange(blocks * 32) < n_segs)[None, :]            # [n_tiles, 32 blocks]
    ballot = lambda bits: (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(
        axis=-1).astype(np.uint32).view(np.int32)
    words[:] = ballot(over.reshape(n_tiles, blocks, 32))
    tiles = np.zeros((blocks * 32, words_t * 32), bool)
    tiles[:, :n_tiles] = over.T
    words_tr[:] = ballot(tiles.reshape(blocks * 32, words_t, 32))[:n_segs]


def _warp_butterfly(op, lanes):
    """A shuffle butterfly over the last axis (32 lanes) -> [...]."""
    o = 16
    while o:
        lanes = op(lanes, lanes[..., np.arange(32) ^ o])
        o >>= 1
    return lanes[..., 0]


MODELS = {"grace_splat_bucket_keys": _model_bucket_keys,
          "grace_splat_bucket_pack": _model_bucket_pack,
          "grace_sortfree_setup": _model_sortfree_setup}


@pytest.fixture
def model_launch(monkeypatch):
    """Replace the ctypes launch with the numpy models; check each call's
    arguments against the entry's kinds in ``_kernels.KERNELS``."""
    calls = []

    def launch(name, entry, device, *args):
        kinds = _kernels.KERNELS[name][2][entry]
        assert name == "splat_prep" and len(args) == len(kinds)
        for a, k in zip(args, kinds):
            assert (isinstance(a, int) and not isinstance(a, bool)) or (k == "p" and a is None)
        calls.append(entry)
        MODELS[entry](*args)

    monkeypatch.setattr(_kernels, "launch", launch)
    return calls


def _check_bucket_model(st, wt, side, tile_w, tile_h, band, chunk, calls, **private):
    """The kernels' route, models in the launch's place, against the plain
    version: two launches, each counted once, every field bit-equal."""
    want = ts._bucket_prims_ortho_plain(st, CAM, LOOK, UP, VEXT, LENGTH, side, side, tile_w,
                                        tile_h, chunk, wt, band)
    counters = (ts.bucket_keys_cuda, ts.bucket_pack_cuda)
    before = [fn.launches for fn in counters]
    got = ts._bucket_prims_ortho_kernels(st, CAM, LOOK, UP, VEXT, LENGTH, side, side, tile_w,
                                         tile_h, chunk, wt, band, **private)
    assert calls == ["grace_splat_bucket_keys", "grace_splat_bucket_pack"]
    assert [fn.launches for fn in counters] == [b + 1 for b in before]
    for f in ts.SplatBuckets._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        a, b = (t.view(torch.int32) if t.dtype == torch.float32 else t for t in (a, b))
        assert torch.equal(a, b), f
    return want


@pytest.mark.parametrize("tag", CASES)
def test_bucket_kernels_model_matches_plain(tag, model_launch):
    s, w, side, tile_w, tile_h, band, chunk = _case(tag)
    st, wt = _torch(s, w)
    _check_bucket_model(st, wt, side, tile_w, tile_h, tile_h if band is None else band, chunk,
                        model_launch)


@pytest.mark.parametrize("tag", CASES)
def test_sortfree_setup_model_matches_plain(tag, model_launch):
    s, w, side, tile_w, tile_h, _, _ = _case(tag)
    st, wt = _torch(s, w)
    cam = tsg.OrthoCamera(CAM, LOOK, UP, VEXT, LENGTH, side, side)
    want = tsg._sortfree_setup_plain(st, wt, cam, tile_w, tile_h)
    consts, spans, coords = tsg._setup_constants(cam, tile_w, tile_h, "cpu")
    got = tsg.sortfree_setup_cuda(st, wt, consts, spans, coords, side // tile_h, side // tile_w)
    assert model_launch == ["grace_sortfree_setup"]
    for name, a, b in zip(("masks", "masks_t", "coords", "slabs"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        a, b = (t.view(torch.int32) if t.dtype == torch.float32 else t for t in (a, b))
        assert torch.equal(a, b), name


def test_camera_constants_cached_and_bit_equal():
    """The kernels' constants are the plain path's tensors, computed once
    per camera: a tuple camera hits the cache, a tensor camera does not."""
    args = (CAM, LOOK, UP, VEXT, LENGTH, 128, 128, 32, 32, "cpu")
    consts, xcols, yrows = ts._bucket_constants(*args)
    assert ts._bucket_constants(*args)[0] is consts
    assert ts._bucket_constants(list(CAM), np.asarray(LOOK), UP, VEXT, LENGTH,
                                *args[5:])[0] is consts
    frame = ts._ortho_frame(*args)
    want = torch.cat([frame.view_dir, frame.v, frame.u, frame.cam,
                      torch.stack([frame.length, frame.x0, frame.y0, frame.band_step,
                                   frame.tile_step])])
    assert consts.shape == (ts.BUCKET_CONSTS,)
    assert torch.equal(consts.view(torch.int32), want.view(torch.int32))
    assert torch.equal(xcols[:, 0], frame.xcols) and torch.equal(yrows[:, 0], frame.yrows)
    tensor_cam = ts._bucket_constants(torch.tensor(CAM), *args[1:])
    assert tensor_cam[0] is not consts and torch.equal(tensor_cam[0], consts)
    cam = tsg.OrthoCamera(CAM, LOOK, UP, VEXT, LENGTH, 128, 128)
    sc, spans, coords = tsg._setup_constants(cam, 32, 128, "cpu")
    assert tsg._setup_constants(cam, 32, 128, "cpu")[0] is sc
    assert sc.shape == (tsg.SETUP_CONSTS,) and torch.equal(sc[:12], consts[:12])
    assert torch.equal(coords, tsg._coords(cam, "cpu"))
    assert torch.equal(spans, torch.cat(tsg._tile_spans(cam, 32, 128, "cpu")))


def test_far_particle_overflow_differs_from_grace_tpu():
    """ROADMAP C21: a live particle beyond 2^31 band and row-tile widths
    with a footprint wider than a band. grace_tpu's int32 conversion
    saturates both ends of its span to one value: no overflow; the port's
    int64 span is thousands of bands: overflow. Every key is the sentinel
    in both, so the image is the same."""
    s = np.array([[0.5, 0.5, 0.5, 0.05], [3e9, 3e9, 0.5, 1e3]], F32)
    kw = dict(tile_w=32, tile_h=64, chunk=128, band=32)
    jb = js.bucket_prims_ortho(s, CAM, LOOK, UP, VEXT, LENGTH, 64, 64, **kw)
    tb = ts.bucket_prims_ortho(torch.from_numpy(s), CAM, LOOK, UP, VEXT, LENGTH, 64, 64, **kw)
    assert not bool(jb.overflow) and bool(tb.overflow)
    for f in js.SplatBuckets._fields[:-1]:
        assert np.array_equal(np.asarray(getattr(jb, f)), getattr(tb, f).numpy()), f
    near = ts.bucket_prims_ortho(torch.from_numpy(s[:1]), CAM, LOOK, UP, VEXT, LENGTH, 64, 64,
                                 **kw)
    assert not bool(near.overflow) and torch.equal(near.first, tb.first)


def test_setups_refuse_other_devices_and_shapes():
    """Neither setup has another route than the kernels and the plain
    version: a meta tensor raises, as do spheres of another width on the
    kernel route's checks."""
    meta = torch.empty((8, 4), device="meta")
    cam = tsg.OrthoCamera(CAM, LOOK, UP, VEXT, LENGTH, 64, 64)
    with pytest.raises(ValueError, match="unsupported device"):
        ts.bucket_prims_ortho(meta, CAM, LOOK, UP, VEXT, LENGTH, 64, 64, tile_w=32, tile_h=64)
    with pytest.raises(ValueError, match="unsupported device"):
        tsg.sortfree_setup(meta, None, cam, 32, 64)
    with pytest.raises(ValueError, match="spheres"):
        ts._bucket_prims_ortho_kernels(torch.zeros((8, 3)), CAM, LOOK, UP, VEXT, LENGTH, 64, 64,
                                       32, 64, 128, None, 32)
    with pytest.raises(TypeError):
        ts._bucket_prims_ortho_kernels(torch.zeros((8, 4), dtype=torch.float64), CAM, LOOK, UP,
                                       VEXT, LENGTH, 64, 64, 32, 64, 128, None, 32)


def _one_key_scene(n):
    """n small live particles inside one (row tile, band) key of the
    64 x 64 bench camera at tile 16 x 64, band 16."""
    rng = np.random.default_rng(n)
    pos = 0.5 + 0.004 * rng.random((n, 3), dtype=np.float32)
    return np.concatenate([pos, np.full((n, 1), 0.002, F32)], axis=1)


SMALL_BLOCKS = {
    # tag: (particles, block tile, image side, (tile_w, tile_h), band, chunk)
    "ragged last block: 1,000 particles in blocks of 96": (1000, 96, 128, (32, 128), 32, 64),
    "fewer than 32 particles: 17 in blocks of 5": (17, 5, 64, (16, 64), 16, 8),
    "no particle": (0, 32, 64, (16, 64), 16, 8),
    "one key's run over 47 blocks: 3,000 particles in one key, blocks of 64":
        (3000, 64, 64, (16, 64), 16, 64),
    "4,096 keys (counters in device memory), 2,000 particles in blocks of 160":
        (2000, 160, 512, (8, 16), 8, 64),
}


@pytest.mark.parametrize("tag", list(SMALL_BLOCKS))
def test_bucket_model_small_blocks(tag, model_launch):
    """The two passes at block tiles far below BUCKET_TILE: ragged last
    blocks, a block of fewer than 32 particles, no particle, a key whose
    instances run over many blocks, and the counters in device memory;
    bit-equal to the plain version in every field."""
    n, tile, side, (tile_w, tile_h), band, chunk = SMALL_BLOCKS[tag]
    if tag.startswith("one key"):
        s = _one_key_scene(n)
    else:
        s = make_clustered_particles(np.random.default_rng(n + tile), n)
    assert ts.bucket_blocks(n, (side // band) * (side // tile_w), tile)[0] == tile
    want = _check_bucket_model(torch.from_numpy(s), None, side, tile_w, tile_h, band, chunk,
                               model_launch, _tile=tile)
    if tag.startswith("one key"):
        assert int((want.last - want.first).max()) == n
