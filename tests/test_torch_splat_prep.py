"""The splat's two setups (bucketed and sort-free) against grace_tpu, and
the design of their CUDA kernels (``csrc/splat_prep.cu``) as numpy models.

- ``_bucket_prims_ortho_plain`` and ``_sortfree_setup_plain`` against
  ``grace_tpu`` (jitted on the CPU) at every case of chip_smoke's
  ``SPLAT_PREP_CASES`` (n not a multiple of chunk, 2 chunk or 128; n < 32;
  segment counts that are and are not multiples of 32; 128 tiles; band
  None, 16, 32 and 64; weights None and given; dead particles; overflow),
  every output bit-equal.
- numpy models of the five C entries, written as the kernels index their
  threads (a particle a thread; the counting sort's warp tiles, 32 keys a
  round grouped as __match_any_sync groups them, counted forwards and
  scattered backwards from the scanned counts; a slab instance a thread,
  the key ranges from the cursors; a warp a segment, the box reduced over
  its lanes, four particles and one float4 of each slab row a lane, one
  ballot word per tile row and per transposed row), run through
  the port's own wrappers with the ctypes launch replaced by the model
  (which reads and writes the tensors' host memory), bit-equal to the plain
  versions.
- ROADMAP C21: grace_tpu converts the band quotients to int32 (saturating),
  the port to int64, so a live particle beyond 2^31 band widths whose
  footprint spans bands is flagged by the port and not by grace_tpu.
"""

import ctypes

import jax
import numpy as np
import pytest
import torch

import grace_tpu.trace.splat as js
import grace_tpu.trace.splat_grad as jsg
from grace_tpu.core.types import make_spheres
from grace_tpu.trace.pallas_broadphase import pack_overlap_bits as j_pack
from chip_smoke import CAM, LENGTH, LOOK, SPLAT_PREP_CASES, UP, VEXT, splat_prep_scene
from grace_tpu_torch import _kernels
import grace_tpu_torch.trace.splat as ts
import grace_tpu_torch.trace.splat_grad as tsg
from tests.helper.torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

CASES = list(SPLAT_PREP_CASES)
F32 = np.float32


def _case(tag):
    n, side, (tile_w, tile_h), band, chunk, _, _ = SPLAT_PREP_CASES[tag]
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


def _model_bucket_keys(spheres, weights, consts, keys, rows, overflow, n, nbx, nty, n_keys):
    """grace_splat_bucket_keys: thread p = particle p (vectorized over p)."""
    s = _view(spheres, ctypes.c_float, 4 * n).reshape(n, 4)
    c = _view(consts, ctypes.c_float, ts.BUCKET_CONSTS)
    out_keys = _view(keys, ctypes.c_int32, 4 * n)
    out_rows = _view(rows, ctypes.c_float, 4 * n).reshape(n, 4)
    flag = _view(overflow, ctypes.c_uint8, 1)
    flag[0] = 0                                              # the entry's memset
    if n == 0:
        return
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
        if (live & ((cb_hi - cb_lo > 1) | (rt_hi - rt_lo > 1))).any():
            flag[0] = 1
        cb_hi = np.minimum(cb_hi, cb_lo + 1)
        rt_hi = np.minimum(rt_hi, rt_lo + 1)
        for rr in range(2):
            for cc in range(2):
                cb, rt = cb_lo + cc, rt_lo + rr
                ok = ((cb <= cb_hi) & (rt <= rt_hi) & (cb >= 0) & (cb < nbx) & (rt >= 0)
                      & (rt < nty) & (scale > 0))
                out_keys[(rr * 2 + cc) * n:(rr * 2 + cc + 1) * n] = np.where(
                    ok, rt * nbx + cb, n_keys)
        invh = np.where(positive, F32(1) / np.fmax(h, F32(1e-30)), F32(0))
        if weights is None:
            invh_s = np.where(live, invh, F32(0))
            scale_s = invh_s * invh_s
        else:
            invh_s, scale_s = invh, scale
    out_rows[:] = np.stack([pu, pv, invh_s, scale_s], axis=1)


def _tile_rounds(keys, m, tile, tiles):
    """keys i32[m] as [tiles, tile / 32, 32]: warp tile w's round r, lane l
    (-1 past m, as the kernels' idle lanes)."""
    padded = np.full(tiles * tile, -1, np.int64)
    padded[:m] = keys
    return padded.reshape(tiles, tile // 32, 32)


def _match(k):
    """__match_any_sync over each row of k [tiles, 32]: (group size, the
    lane's rank among its group's lower lanes, is the group's first lane)."""
    eq = k[:, :, None] == k[:, None, :]
    lower = np.tril(np.ones((32, 32), bool), -1)          # lane j < lane l
    return eq.sum(-1), (eq & lower[None]).sum(-1), ~(eq & lower[None]).any(-1)


def _model_bucket_count(keys, counts, m, tile, tiles, n_bins):
    """grace_splat_bucket_count: warp w takes its tile 32 at a time, the
    first lane of each key's group adds the group's size to counts[key *
    tiles + w]."""
    out = _view(counts, ctypes.c_int32, n_bins * tiles)
    out[:] = 0                                               # the entry's memset
    k = _tile_rounds(_view(keys, ctypes.c_int32, m), m, tile, tiles)
    acc = np.zeros((n_bins, tiles), np.int64)
    for r in range(tile // 32):
        size, _, first = _match(k[:, r])
        w, lane = np.nonzero(first & (k[:, r] >= 0))
        np.add.at(acc, (k[w, r, lane], w), size[w, lane])
    out[:] = acc.reshape(-1)


def _model_bucket_scatter(keys, cursor, order, m, tile, tiles):
    """grace_splat_bucket_scatter: warp w walks its tile backwards, 32 at a
    time; each key's first lane reads the (key, w) cursor and moves it down
    by the group's size, and every lane writes at the new cursor plus its
    rank among the group's lower lanes."""
    k = _tile_rounds(_view(keys, ctypes.c_int32, m), m, tile, tiles)
    # the rows of the keys present (the model knows no n_bins)
    cur = _view(cursor, ctypes.c_int32, (int(k.max(initial=0)) + 1) * tiles).reshape(-1, tiles)
    out = _view(order, ctypes.c_int32, m)
    index = np.arange(tiles * tile).reshape(k.shape)
    for r in range(tile // 32 - 1, -1, -1):
        size, rank, first = _match(k[:, r])
        valid = k[:, r] >= 0
        w = np.broadcast_to(np.arange(tiles)[:, None], valid.shape)
        top = cur[np.where(valid, k[:, r], 0), w]            # every lane reads before the move
        out[(top - size + rank)[valid]] = index[:, r][valid]
        lw, lane = np.nonzero(first & valid)
        cur[k[lw, r, lane], lw] -= size[lw, lane]


def _model_bucket_pack(order, cursor, rows, slabs, first, last, slab_lo, n_slabs, n, cap,
                       chunk, n_keys, tiles):
    """grace_splat_bucket_pack: thread g = slab instance g (its 4 slab
    positions); threads g < n_keys also write key g's range from the
    cursors (cursor[k * tiles] is key k's first instance)."""
    src = _view(order, ctypes.c_int32, 4 * n)
    cur = _view(cursor, ctypes.c_int32, (n_keys + 1) * tiles)
    r = _view(rows, ctypes.c_float, 4 * n).reshape(n, 4)
    out = _view(slabs, ctypes.c_float, 4 * cap)
    g = np.arange(cap)
    v = np.zeros((cap, 4), F32)
    if n:
        v[:4 * n] = r[src % n]
    base = (g // chunk) * 4 * chunk + g % chunk
    for comp in range(4):
        out[base + comp * chunk] = v[:, comp]
    f, l = cur[np.arange(n_keys) * tiles], cur[np.arange(1, n_keys + 1) * tiles]
    per_slab = 2 * chunk
    lo = f // per_slab
    for ptr, vals in ((first, f), (last, l), (slab_lo, lo),
                      (n_slabs, np.maximum((l + per_slab - 1) // per_slab - lo, 0))):
        _view(ptr, ctypes.c_int32, n_keys)[:] = vals


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
          "grace_splat_bucket_count": _model_bucket_count,
          "grace_splat_bucket_scatter": _model_bucket_scatter,
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


@pytest.mark.parametrize("tag", CASES)
def test_bucket_kernels_model_matches_plain(tag, model_launch):
    s, w, side, tile_w, tile_h, band, chunk = _case(tag)
    st, wt = _torch(s, w)
    want = _plain_buckets(s, w, side, tile_w, tile_h, band, chunk)
    counters = (ts.bucket_keys_cuda, ts.bucket_sort_cuda, ts.bucket_pack_cuda)
    before = [fn.launches for fn in counters]
    got = ts._bucket_prims_ortho_kernels(st, CAM, LOOK, UP, VEXT, LENGTH, side, side, tile_w,
                                         tile_h, chunk, wt, tile_h if band is None else band)
    assert model_launch == ["grace_splat_bucket_keys", "grace_splat_bucket_count",
                            "grace_splat_bucket_scatter", "grace_splat_bucket_pack"]
    assert [fn.launches for fn in counters] == [b + 1 for b in before]
    for f in ts.SplatBuckets._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        a, b = (t.view(torch.int32) if t.dtype == torch.float32 else t for t in (a, b))
        assert torch.equal(a, b), f


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


@pytest.mark.parametrize("tile,m,n_bins", [(32, 1000, 7), (64, 4099, 257), (1024, 31, 3),
                                           (96, 0, 5)])
def test_counting_sort_model_is_stable(tile, m, n_bins, model_launch, monkeypatch):
    """The counting sort's design, at warp tiles of other sizes (ragged last
    tiles, a tile of fewer than 32 keys, no keys): the order of
    torch.sort(stable=True), and cursor[k * tiles] is the first instance
    of key k."""
    monkeypatch.setattr(ts, "SORT_TILE", tile)
    rng = np.random.default_rng(m + n_bins)
    keys = torch.from_numpy(np.minimum(rng.geometric(0.3, m) - 1, n_bins - 1).astype(np.int32))
    order, cursor, tiles = ts.bucket_sort_cuda(keys, n_bins)
    assert model_launch == ["grace_splat_bucket_count", "grace_splat_bucket_scatter"]
    assert tiles == max(1, -(-m // tile)) and cursor.shape == (n_bins * tiles,)
    want_keys, want = torch.sort(keys, stable=True)
    assert torch.equal(order, want.to(torch.int32))
    firsts = torch.searchsorted(want_keys, torch.arange(n_bins, dtype=torch.int32))
    assert torch.equal(cursor[::tiles].long(), firsts)
