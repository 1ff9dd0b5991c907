"""The records' post-processing against grace_tpu, and the design of its
CUDA kernels (``csrc/segsort.cu``) as numpy models.

- The plain versions (``_sort_records_by_distance_plain``,
  ``_records_to_flat_plain``, ``segops._sort_by_distance_plain``) against
  ``grace_tpu`` (jitted on the CPU), bit for bit, at every case of
  chip_smoke's ``SEGSORT_ROW_CASES`` (keys of every special value of the
  order, exact ties, sentinel slots mid-row and at the tail, real +inf
  distances, rows that overflowed, rows already in order, distances in
  one octave as the bench's rows span, widths 128 to 2,048),
  ``SEGSORT_FLAT_CASES`` (capacity equal to, below and past the kept total,
  sentinel slots with other sentinels, no rows, an overflowed row at
  capacity 0) and ``SEGSORT_CSR_CASES`` (empty, repeated, unordered,
  negative, past-H and near-2^31 offsets; total_hits 0, inside and past
  H; segments past a warp's 1,024; a trailing pseudo-segment of 1.2M
  entries; nine data arrays; one segment; no offsets; capacity padding of
  equal keys in the last ray's segment and as a segment of its own; long
  segments in order but for a pair across a chunk boundary or for their
  last element; keys that tie only in the order; descending segments;
  lengths around 1, 32, 512 and 1,024). The order key as a stable numpy
  sort equals ``lax.sort``'s order of the special values; chip_smoke's E9
  library keys give the plain version's order.
- numpy models of the C entries, written as the kernels index their
  threads (a run checked for order, then its keys packed into distinct
  u32 or u64 values and sorted by a warp's bitonic network of ascending
  comparators, lane l holding elements l E ... l E + E - 1: strides below
  E inside a lane, the others by shuffles, each phase's mirror step
  across lanes from register E - 1 - e; a record row sorted only over the
  prefix that ends with its last record, its NaNs moved past the tail of
  sentinel slots; head bits, a warp a tile of 1,024 positions and a word
  a lane; a warp a segment, long segments appended in any order, the long
  list scanned, each checked for order, the unsorted ones' chunks sorted,
  merged pairwise a tile of 256 outputs at a time with the left run first
  on ties, and gathered, the others copied; a warp a row copying its
  records, its sentinel slot and the tail), run through the port's own
  wrappers with the ctypes launch replaced by the model (which reads and
  writes the tensors' host memory), bit-equal to the plain versions at
  every case above; the long route forced at a small size (chunks of 128,
  so rows of 384 and 512 and the CSR cases take several merge rounds, the
  merge in tiles of 256 outputs with their co-ranks found by a warp's
  32-way search); the warp sort's model against numpy's stable argsort at
  every network size and on both packings; the order check's flags on
  the long segments.
- The public functions take the kernels where the tensors are not on the
  CPU (the route test made to say so), ``trace_sph`` and
  ``trace_with_sentinels_sph`` included, and main path 4's gate (the CSR
  sort of ``trace_sph``'s flat layout against the flat layout of the
  sorted rows) holds on a small record trace.
"""

import ctypes
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grace_tpu.ops.segops as jso
import grace_tpu.trace.pallas_records as jpr
from chip_smoke import (SEGSORT_CSR_CASES, SEGSORT_FLAT_CASES, SEGSORT_ROW_CASES,
                        SPECIAL_BITS, csr_sort_keys, order_key_torch, records_scene, segsort_csr,
                        segsort_flat, segsort_gate, segsort_outputs, segsort_rows)
from grace_tpu_torch import _kernels
from grace_tpu_torch.ops import segops as tso
from grace_tpu_torch.trace import pallas_records as tpr
from grace_tpu_torch.trace import sph as tsph
from tests.helper.torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

ROWS = list(SEGSORT_ROW_CASES)
FLAT = list(SEGSORT_FLAT_CASES)
CSR = list(SEGSORT_CSR_CASES)
U64 = np.uint64


def _bits_equal(a, b, what):
    """Bit-equal (f32 by their bits, so every NaN's payload and sign and
    every zero's sign count)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, what
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    assert np.array_equal(a, b), f"{what}: {int((a != b).sum())} differ"


def _rows_args(tag):
    return tpr.RecordTraceResult(*(torch.from_numpy(a) for a in segsort_rows(tag)))


def _flat_args(tag):
    rows, capacity, kw = segsort_flat(tag)
    return tpr.RecordTraceResult(*(torch.from_numpy(a) for a in rows)), capacity, kw


def _csr_args(tag):
    dist, offsets, idx, data, total = segsort_csr(tag)
    t = torch.from_numpy
    return t(dist), t(offsets), t(idx), [t(a) for a in data], total


ARGS = {"rows": _rows_args, "flat": _flat_args, "csr": _csr_args}


# ---- the plain versions against grace_tpu ----------------------------------


def _jax_outputs(kind, tag):
    if kind == "rows":
        rec = jpr.RecordTraceResult(*(jnp.asarray(a) for a in segsort_rows(tag)))
        return list(jax.jit(jpr.sort_records_by_distance)(rec))
    if kind == "flat":
        rows, capacity, kw = segsort_flat(tag)
        kw.pop("_rows", None)   # the kernel's rows a block
        rec = jpr.RecordTraceResult(*(jnp.asarray(a) for a in rows))
        fn = jax.jit(lambda r: jpr.records_to_flat(r, capacity, **kw))
        return list(fn(rec))
    dist, offsets, idx, data, total = segsort_csr(tag)
    fn = jax.jit(lambda d, o, i, *x: jso.sort_by_distance(d, o, i, *x, total_hits=total))
    return list(fn(jnp.asarray(dist), jnp.asarray(offsets), jnp.asarray(idx),
                   *(jnp.asarray(a) for a in data)))


@pytest.mark.parametrize("kind,tag", [("rows", t) for t in ROWS] + [("flat", t) for t in FLAT]
                         + [("csr", t) for t in CSR])
def test_plain_matches_grace_tpu(kind, tag):
    got = segsort_outputs(kind, ARGS[kind](tag), plain=True)
    want = _jax_outputs(kind, tag)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _bits_equal(g.numpy(), np.asarray(w), f"{kind} {tag}: output {i}")


def test_cases_reach_their_edges():
    """The cases hold what their names say."""
    counts, idx, _, dist = segsort_rows(ROWS[0])
    valid = np.arange(128)[None, :] < np.minimum(counts, 128)[:, None]
    assert (idx[valid] == -1).any() and np.isposinf(dist[idx != -1]).any()
    bits = set(dist.view(np.uint32).ravel().tolist())
    assert set(SPECIAL_BITS.view(np.uint32).tolist()) <= bits
    rec = idx != -1   # rows with a NaN record before a tail of sentinel slots
    last = np.where(rec.any(1), 127 - np.argmax(rec[:, ::-1], axis=1), -1)
    assert ((np.isnan(dist) & rec).any(1) & (last < 127)).any()
    counts, _, _, _ = segsort_rows(ROWS[1])
    assert (counts > 512).any() and (counts == 0).any()
    dist, offsets, _, _, _ = segsort_csr(CSR[0])
    assert (offsets < 0).any() and (offsets >= 3000).any() and (offsets == 2**31 - 1).any()
    assert (np.diff(offsets[1:]) < 0).any() and (np.diff(offsets) == 0).any()
    dist, offsets, _, _, total = segsort_csr(CSR[4])
    assert dist.shape[0] - total > 1_000_000 and offsets.max() < total
    dist, offsets, _, _, total = segsort_csr(CSR[3])
    assert np.diff(np.append(offsets, total)).max() > 1024


def _order_bits(x):
    """The kernels' order key of f32 keys: NaN -> 0x7FC00000, -0 and
    subnormals -> +0, then the order-preserving u32."""
    u = x.view(np.uint32).copy()
    u[np.isnan(x)] = 0x7FC00000
    u[(u & 0x7F800000) == 0] = 0
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def test_order_key_matches_lax_sort():
    """A stable sort of the order keys gives lax.sort's order of f32 keys,
    every special value among exact ties; the keys with their positions
    are distinct u64, so any sorting network gives that order."""
    rng = np.random.default_rng(0)
    keys = np.concatenate([SPECIAL_BITS, SPECIAL_BITS, np.float32([1.0, 1.0, -2.0, 3.0])])
    keys = keys[rng.permutation(keys.shape[0])]
    pos = np.arange(keys.shape[0])
    _, want = jax.lax.sort((jnp.asarray(keys), jnp.asarray(pos)), num_keys=1)
    got = np.argsort(_order_bits(keys), kind="stable")
    assert np.array_equal(got, np.asarray(want))
    u64 = (_order_bits(keys).astype(U64) << U64(32)) | pos.astype(U64)
    assert np.array_equal(np.argsort(u64), got) and np.unique(u64).shape == u64.shape


@pytest.mark.parametrize("fn", ["sort_by_key", "sort_and_map"])
def test_plain_key_sorts_tie_subnormals_with_zero(fn):
    """ROADMAP C24 in the other plain sorts of segops: f32 keys of every
    special value, subnormals among them, in grace_tpu's order."""
    rng = np.random.default_rng(2)
    keys = np.concatenate([SPECIAL_BITS, SPECIAL_BITS, np.float32([1.0, -1.0, 0.5])])
    keys = keys[rng.permutation(keys.shape[0])]
    vals = np.arange(keys.shape[0], dtype=np.int32)
    args = (keys, vals) if fn == "sort_by_key" else (keys,)
    got = getattr(tso, fn)(*(torch.from_numpy(a) for a in args))
    want = getattr(jso, fn)(*(jnp.asarray(a) for a in args))
    for g, w in zip(got, want):
        _bits_equal(g.numpy(), np.asarray(w), fn)


# ---- numpy models of the C entries -------------------------------------------


def _view(ptr, ctype, count):
    """The ``count`` values of C type ``ctype`` at host address ``ptr``,
    as a writable numpy array."""
    if count == 0:
        return np.zeros(0, np.ctypeslib.as_array((ctype * 1)()).dtype)
    return np.ctypeslib.as_array((ctype * count).from_address(ptr))


PAD_KEY = np.uint32(0xFFFFFFFF)


def _order_keys(keys, mask, pos):
    """key_at: the order keys of elements ``pos`` (a mask of -1 keys +inf)."""
    k = keys[pos]
    if mask is not None:
        k = np.where(mask[pos] == -1, np.float32(np.inf), k)
    return _order_bits(k)


def _take(x, i):
    return np.take_along_axis(x, i, axis=1)


def _warp_bitonic(v):
    """warp_bitonic on runs v u32[R, 32, E] (lane, register), every
    comparator ascending: phase K = 2, 4, ..., 32 E compares element i with
    its mirror i ^ (K - 1) (inside the lane where K <= E; else lane ^ (K / E
    - 1), register E - 1 - e, the lane keeping the min where it holds the
    lower index), then half_clean J = K / 4, ..., 1 (inside the lane where J
    < E, else lane ^ (J / E))."""
    e_n = v.shape[2]
    lane = np.arange(32)

    def cross(v, w, low):
        return np.where(low[None, :, None], np.minimum(v, w), np.maximum(v, w))

    def inside(v, j, partner):
        v = v.copy()
        lo = np.flatnonzero((np.arange(e_n) & j) == 0)
        a, b = v[:, :, lo], v[:, :, partner(lo)]
        v[:, :, lo], v[:, :, partner(lo)] = np.minimum(a, b), np.maximum(a, b)
        return v

    k = 2
    while k <= 32 * e_n:
        if k <= e_n:
            v = inside(v, k // 2, lambda e: e ^ (k - 1))
        else:
            v = cross(v, v[:, lane ^ (k // e_n - 1), ::-1], (lane & (k // e_n // 2)) == 0)
        j = k // 4
        while j >= 1:
            if j >= e_n:
                v = cross(v, v[:, lane ^ (j // e_n), :], (lane & (j // e_n)) == 0)
            else:
                v = inside(v, j, lambda e: e | j)
            j //= 2
        k *= 2
    return v


def _keys_in_order(runs):
    """keys_in_order on each run: every key, read striped, not above the
    next one; and the run's min and max."""
    return [(bool((x[1:] >= x[:-1]).all()), int(x.min()), int(x.max())) if x.shape[0]
            else (True, 0, 0) for x in runs]


def _network_sort(keys, lens, e_n, wide, lo, bits):
    """network_sort on runs of order keys u32[R, 32 E] (run r's first
    lens[r] are its keys), E = e_n a lane: each key packed into a distinct
    value in the stable order, the u32 (key - lo) << bits | position, or
    with ``wide`` the u64 key << 32 | position (pads ~0), sorted by
    warp_bitonic and unpacked. Returns (keys, run indices) [R, 32 E]."""
    r, w = keys.shape
    valid = np.arange(w)[None, :] < lens[:, None]
    pos = np.arange(w, dtype=np.uint64)[None, :]
    k = keys.astype(np.uint64)
    if wide:
        packed = np.where(valid, k << U64(32) | pos, ~U64(0))
    else:
        packed = np.where(valid, (k - lo[:, None]) << bits[:, None] | pos, U64(0xFFFFFFFF))
    out = _warp_bitonic(packed.reshape(r, 32, e_n)).reshape(r, w)
    if wide:
        return (out >> U64(32)).astype(np.uint32), (out & U64(0xFFFFFFFF)).astype(np.int64)
    return ((lo[:, None] + (out >> bits[:, None])).astype(np.uint32),
            (out & ((U64(1) << bits[:, None]) - U64(1))).astype(np.int64))


def _sort_runs(runs):
    """sort_keys_for on each run of order keys (a list of u32 arrays): a
    run in order keeps its order; else the u32 network, E = 16 (32 past
    512 keys: only the kernels whose runs reach 1,024 see those), where
    the span and the positions fit in 32 bits, else the u64 network (E = 4
    for runs of up to 128). Each run's (sorted keys, run indices)."""
    lens = np.array([x.shape[0] for x in runs], int)
    out = [(x.copy(), np.arange(x.shape[0])) for x in runs]
    shape = _keys_in_order(runs)
    groups = {}
    for j, ((in_order, lo, hi), m) in enumerate(zip(shape, lens)):
        if in_order:
            continue
        bits = int(m - 1).bit_length()
        narrow = m <= 512
        if hi - lo <= 0xFFFFFFFF >> bits:
            key = (16 if narrow else 32, False)
        else:
            key = (4 if m <= 128 else 16 if narrow else 32, True)
        groups.setdefault(key, []).append(j)
    for (e_n, wide), idx in groups.items():
        keys = np.full((len(idx), 32 * e_n), 0xFFFFFFFF, np.uint32)
        for row, j in enumerate(idx):
            keys[row, :lens[j]] = runs[j]
        lo = np.array([shape[j][1] for j in idx], np.uint64)
        bits = np.array([int(lens[j] - 1).bit_length() for j in idx], np.uint64)
        k, v = _network_sort(keys, lens[idx], e_n, wide, lo, bits)
        for row, j in enumerate(idx):
            out[j] = (k[row, :lens[j]], v[row, :lens[j]])
    return out


def _payloads(host_ptrs, n_payloads, n):
    table = _view(host_ptrs, ctypes.c_uint64, 2 * n_payloads)
    return ([_view(int(p), ctypes.c_uint32, n) for p in table[:n_payloads]],
            [_view(int(p), ctypes.c_uint32, n) for p in table[n_payloads:]])


def _model_sort_rows(dist, idx, intg, o_idx, o_intg, o_dist, n_rows, width):
    """grace_sort_rows: a warp a row (staged, which moves no bit), keyed by
    the distances with the sentinel slots at +inf; sort_keys only over the
    prefix that ends with the row's last record, its NaNs placed past the
    tail of sentinel slots; the three arrays written in that order."""
    n = n_rows * width
    keys, mask = _view(dist, ctypes.c_float, n), _view(idx, ctypes.c_int32, n)
    rows = mask.reshape(n_rows, width) != -1
    last = np.where(rows.any(axis=1), width - 1 - np.argmax(rows[:, ::-1], axis=1), -1)
    m = last + 1
    nans = (np.isnan(keys.reshape(n_rows, width)) & rows).sum(axis=1)
    order = _order_keys(keys, mask, np.arange(n)).reshape(n_rows, width)
    runs = _sort_runs([order[r, :m[r]] for r in range(n_rows)])
    src = np.empty((n_rows, width), np.int64)
    for r, (_, pos) in enumerate(runs):
        keep = m[r] - nans[r]
        place = np.where(np.arange(m[r]) < keep, np.arange(m[r]), np.arange(m[r]) + width - m[r])
        src[r, place] = pos
        src[r, keep:width - nans[r]] = np.arange(m[r], width)
    src = (src + np.arange(n_rows)[:, None] * width).ravel()
    for s_ptr, d_ptr in ((idx, o_idx), (intg, o_intg), (dist, o_dist)):
        _view(d_ptr, ctypes.c_uint32, n)[:] = _view(s_ptr, ctypes.c_uint32, n)[src]


def _model_seg_heads(offsets, total, head, n_off, n):
    """Head bits (bit p % 32 of u32 word p / 32): position 0, total where
    inside, every offsets[1:] inside (0, total) (a negative one counted
    from the end)."""
    off = _view(offsets, ctypes.c_int32, n_off).astype(np.int64)
    th = int(_view(total, ctypes.c_int32, 1)[0]) if total else n
    words = _view(head, ctypes.c_uint32, -(-n // 32))
    o = off[1:]
    o = np.where(o < 0, o + n, o)
    pos = np.concatenate([[0], [th] if 0 < th < n else [], o[(o > 0) & (o < th)]]).astype(np.int64)
    np.bitwise_or.at(words, pos >> 5, (np.uint32(1) << (pos & 31).astype(np.uint32)))


def _model_seg_count(head, counts, n):
    """A warp a tile of 1,024 positions, a word a lane: the lanes' popcounts
    summed."""
    tiles = -(-n // tso.HEAD_TILE)
    words = np.zeros(tiles * 32, np.uint32)
    words[:-(-n // 32)] = _view(head, ctypes.c_uint32, -(-n // 32))
    pop = np.unpackbits(words.view(np.uint8)).reshape(tiles, -1).sum(axis=1)
    _view(counts, ctypes.c_int32, tiles)[:] = pop


def _model_seg_starts(head, incl, starts, n):
    """A warp a tile, a word a lane: each lane's heads, lowest bit first,
    after the scan's base and the heads of the lanes below; the last
    tile's warp writes starts[n_seg] = n."""
    tiles = -(-n // tso.HEAD_TILE)
    inc = _view(incl, ctypes.c_int32, tiles)
    st = _view(starts, ctypes.c_int32, int(inc[-1]) + 1)
    words = _view(head, ctypes.c_uint32, -(-n // 32))
    for w in range(tiles):
        base = int(inc[w - 1]) if w else 0
        for lane in range(32):
            word = w * 32 + lane
            bits = int(words[word]) if word * 32 < n else 0
            while bits:
                st[base] = word * 32 + (bits & -bits).bit_length() - 1
                base += 1
                bits &= bits - 1
    st[int(inc[-1])] = n


_ARRIVALS = np.random.default_rng(1)


def _model_segmented_sort(keys, mask, starts, n_seg, host_ptrs, long_start, long_len, n_long,
                          n_payloads, max_segs, chunk):
    """Persistent warps over the segments (each staged, which moves no
    bit): one of more than min(chunk, WARP_RUN) is appended at the
    counter, in an arbitrary (here random) order; the others go through
    sort_keys and every payload is written in that order."""
    ns = int(_view(n_seg, ctypes.c_int32, 1)[0])
    assert ns <= max_segs
    st = _view(starts, ctypes.c_int32, ns + 1).astype(np.int64)
    n = int(st[-1])
    k = _view(keys, ctypes.c_float, n)
    m = _view(mask, ctypes.c_int32, n) if mask else None
    srcs, dsts = _payloads(host_ptrs, n_payloads, n)
    lens = np.diff(st)
    run = min(chunk, tso.WARP_RUN)   # a sort_kernel<16>'s longest run
    long = np.flatnonzero(lens > run)
    n_l = _view(n_long, ctypes.c_int32, 1)
    l_s = _view(long_start, ctypes.c_int32, n // (run + 1) + 1)
    l_n = _view(long_len, ctypes.c_int32, n // (run + 1) + 1)
    for i in long[_ARRIVALS.permutation(long.shape[0])]:
        l_s[n_l[0]], l_n[n_l[0]] = st[i], lens[i]
        n_l[0] += 1
    short = np.flatnonzero(lens <= run)
    runs = _sort_runs([_order_keys(k, m, np.arange(st[i], st[i + 1])) for i in short])
    for i, (_, pos) in zip(short, runs):
        for s_arr, d_arr in zip(srcs, dsts):
            d_arr[st[i]:st[i] + lens[i]] = s_arr[st[i] + pos]


def _long_list(n_long, n_max):
    """The long list's length *n_long, checked against its room."""
    n_l = int(_view(n_long, ctypes.c_int32, 1)[0])
    assert 0 <= n_l <= n_max
    return n_l


def _long_items(ends_ptr, n_long, n_max):
    """Items g < ends[n_long - 1] of the long list and their entries (the
    kernels' binary search over the first n_long entries)."""
    ends = _view(ends_ptr, ctypes.c_int32, _long_list(n_long, n_max)).astype(np.int64)
    g = np.arange(int(ends[-1]) if ends.shape[0] else 0)
    return g, np.searchsorted(ends, g, side="right"), ends


def _model_seg_long_scan(long_len, n_long, elem_end, chunk_end, tile_end, n_max, chunk):
    """One block over the first n_long entries: the inclusive scans of
    long_len, ceil(long_len / chunk) and ceil(long_len / MERGE_TILE)."""
    n_l = _long_list(n_long, n_max)
    ln = _view(long_len, ctypes.c_int32, n_max)[:n_l].astype(np.int64)
    for ptr, per in ((elem_end, 1), (chunk_end, chunk), (tile_end, tso.MERGE_TILE)):
        _view(ptr, ctypes.c_int32, n_max)[:n_l] = np.cumsum(-(-ln // per))


def _model_seg_check(keys, mask, long_start, long_len, elem_end, n_long, unsorted, n_max, n):
    """A thread an element of the long segments: its entry flagged where
    the element and the next one of its segment are out of order."""
    l_s, l_n = _view(long_start, ctypes.c_int32, n_max), _view(long_len, ctypes.c_int32, n_max)
    k, i, ends = _long_items(elem_end, n_long, n_max)
    local = k - (ends[i] - l_n[i])
    nxt = local + 1 < l_n[i]
    p = l_s[i][nxt].astype(np.int64) + local[nxt]
    kk = _view(keys, ctypes.c_float, n)
    mm = _view(mask, ctypes.c_int32, n) if mask else None
    bad = _order_keys(kk, mm, p) > _order_keys(kk, mm, p + 1)
    _view(unsorted, ctypes.c_int32, n_max)[i[nxt][bad]] = 1


def _model_seg_chunks(keys, mask, long_start, long_len, chunk_end, n_long, unsorted, okey, opos,
                      n_max, chunk, n):
    """A warp a chunk g < chunk_end[n_long - 1] of an unsorted entry: its
    order keys through sort_keys, sorted keys to okey and positions to
    opos at the chunk's place; the chunks of an entry in order are left."""
    l_s, l_n = _view(long_start, ctypes.c_int32, n_max), _view(long_len, ctypes.c_int32, n_max)
    g, i, ends = _long_items(chunk_end, n_long, n_max)
    keep = _view(unsorted, ctypes.c_int32, n_max)[i] != 0
    g, i = g[keep], i[keep]
    c = g - (ends[i] - (l_n[i] + chunk - 1) // chunk)
    s = l_s[i].astype(np.int64) + c * chunk
    ln = np.minimum(chunk, l_n[i] - c * chunk)
    k = _view(keys, ctypes.c_float, n)
    m = _view(mask, ctypes.c_int32, n) if mask else None
    out_k, out_p = _view(okey, ctypes.c_uint32, n), _view(opos, ctypes.c_int32, n)
    runs = _sort_runs([_order_keys(k, m, np.arange(a, a + b)) for a, b in zip(s, ln)])
    for start, length, (rk, pos) in zip(s, ln, runs):
        out_k[start:start + length] = rk
        out_p[start:start + length] = start + pos


def _warp_co_rank(A, B, na, nb, k):
    """warp_co_rank for arrays of tiles: the smallest i with
    !(A[i] <= B[k - i - 1]), by 32 probes a step, then one ballot. A and B
    are functions of (tile, index) -> u32."""
    lo, hi = np.maximum(k - nb, 0), np.minimum(k, na)
    lane = np.arange(32)[None, :]

    def ballot(i):
        ok = i < hi[:, None]
        safe_i = np.where(ok, i, 0)
        safe_j = np.where(ok, k[:, None] - i - 1, 0)
        return (ok & (A(safe_i) <= B(safe_j))).sum(axis=1)

    while (hi - lo > 32).any():
        wide = hi - lo > 32
        step = np.where(wide, (hi - lo + 31) // 32, 1)
        c = ballot(lo[:, None] + (lane + 1) * step[:, None] - 1)
        top = lo + (c + 1) * step - 1
        lo, hi = np.where(wide, lo + c * step, lo), np.where(wide, np.minimum(top, hi), hi)
    return lo + ballot(lo[:, None] + lane)


def _model_seg_merge(long_start, long_len, tile_end, n_long, unsorted, ikey, ipos, okey, opos,
                     n_max, width, n):
    """A block a tile of MERGE_TILE outputs of one pair of runs of an
    unsorted entry: its two co-ranks by warp_co_rank, the tile's keys and
    positions of both runs staged, an A key placed after the B keys below
    it and a B key after the A keys up to it (the left run first on
    ties)."""
    T = tso.MERGE_TILE
    l_s, l_n = _view(long_start, ctypes.c_int32, n_max), _view(long_len, ctypes.c_int32, n_max)
    g, i, ends = _long_items(tile_end, n_long, n_max)
    ln, s = l_n[i].astype(np.int64), l_s[i].astype(np.int64)
    k0 = (g - (ends[i] - (ln + T - 1) // T)) * T
    live = (ln > width) & (_view(unsorted, ctypes.c_int32, n_max)[i] != 0)
    g, ln, s, k0 = g[live], ln[live], s[live], k0[live]
    x_in, p_in = _view(ikey, ctypes.c_uint32, n), _view(ipos, ctypes.c_int32, n)
    x_out, p_out = _view(okey, ctypes.c_uint32, n), _view(opos, ctypes.c_int32, n)
    p0 = k0 // (2 * width) * (2 * width)
    na = np.minimum(ln - p0, width)
    nb = np.minimum(ln - p0 - na, width)
    base_a, base_b = s + p0, s + p0 + na
    A = lambda idx: x_in[(base_a[:, None] + idx).clip(0, n - 1)]
    B = lambda idx: x_in[(base_b[:, None] + idx).clip(0, n - 1)]
    kk0 = k0 - p0
    kk1 = np.minimum(kk0 + T, na + nb)
    i0, i1 = _warp_co_rank(A, B, na, nb, kk0), _warp_co_rank(A, B, na, nb, kk1)
    for t in range(g.shape[0]):
        sa = slice(base_a[t] + i0[t], base_a[t] + i1[t])
        sb = slice(base_b[t] + kk0[t] - i0[t], base_b[t] + kk1[t] - i1[t])
        out0 = s[t] + p0[t] + kk0[t]
        at_a = out0 + np.arange(i1[t] - i0[t]) + np.searchsorted(x_in[sb], x_in[sa], "left")
        at_b = (out0 + np.arange(sb.stop - sb.start)
                + np.searchsorted(x_in[sa], x_in[sb], "right"))
        x_out[at_a], p_out[at_a] = x_in[sa], p_in[sa]
        x_out[at_b], p_out[at_b] = x_in[sb], p_in[sb]


def _model_seg_gather(long_start, long_len, elem_end, n_long, unsorted, pos0, pos1, host_ptrs,
                      n_max, n_payloads, chunk, n):
    """Each unsorted long segment's positions from the buffer its last
    merge round wrote (rounds % 2), each segment in order copied; the
    payloads gathered by them."""
    l_s, l_n = _view(long_start, ctypes.c_int32, n_max), _view(long_len, ctypes.c_int32, n_max)
    k, i, ends = _long_items(elem_end, n_long, n_max)
    p = l_s[i] + (k - (ends[i] - l_n[i]))
    rounds = np.array([tso._merge_rounds(int(x), chunk) for x in l_n[i]], int)
    merged = np.where(rounds % 2 == 1, _view(pos1, ctypes.c_int32, n)[p],
                      _view(pos0, ctypes.c_int32, n)[p])
    src = np.where(_view(unsorted, ctypes.c_int32, n_max)[i] != 0, merged, p)
    for s_arr, d_arr in zip(*_payloads(host_ptrs, n_payloads, n)):
        d_arr[p] = s_arr[src]


POISON = np.uint32(0x7FBADBAD)


FLAT_THREADS, FLAT_VECS, TAIL_CHUNK = 512, 4, 8192   # segsort.cu's kFlat*, kTailChunk
AGGREGATE, INCLUSIVE = 1 << 32, 2 << 32
M32 = 0xFFFFFFFF
LOOK_BACK_WAVE = 40   # ranges that publish their sums before any of them looks back


def _model_look_back(words, t):
    """look_back's warp over the published words of the ranges before t:
    32 at a time (lane l range k - l, a range before 0 an inclusive 0),
    sums up to the nearest inclusive word. Returns (the sum of the ranges
    before t mod 2^32, windows read)."""
    base, k, windows = 0, t - 1, 0
    while True:
        js = k - np.arange(32)
        w = [INCLUSIVE if j < 0 else int(words[j]) for j in js]
        flags = [x >> 32 for x in w]
        assert 0 not in flags, "a predecessor had published nothing"
        windows += 1
        stop = flags.index(2) if 2 in flags else 31
        base = (base + sum(x & M32 for x in w[:stop + 1])) & M32
        if 2 in flags:
            return base, windows
        k -= 32


def _model_copy_row(srcs, dsts, writes, row, off, kept, width, capacity, slots, fills):
    """copy_row: a warp copies a row's records (16-byte vectors where the
    width is a multiple of 4, realigned to the destination's 16 bytes by
    a shuffle from the next lane; 4-byte stores for the ragged ends; else
    4 bytes a column), then lane 0 its sentinel slot."""
    n = 0 if kept <= 0 or (off & M32) >= capacity else min(kept, capacity - off)
    lanes = np.arange(32)
    if width % 4 == 0:
        h = (4 - off % 4) % 4
        nb = (n - h) >> 2 if n > h else 0
        tail = h + 4 * nb
        for cb in range(0, n, 32 * 4 * FLAT_VECS):
            q = lanes[None, :] + 32 * np.arange(FLAT_VECS + 1)[:, None]
            q[FLAT_VECS] = 32 * FLAT_VECS   # lane 0's vector of the next chunk
            load = cb + 4 * q < n
            load[FLAT_VECS, 1:] = False
            cols = cb + 4 * q[..., None] + np.arange(4)
            assert (cols[load] < width).all() and ((row + cb + 4 * q[load]) % 4 == 0).all()
            for src, dst, wr in zip(srcs, dsts, writes):
                v = np.zeros((FLAT_VECS + 1, 32, 4), np.uint32)
                v[load] = src[row + cols[load]]
                for t in range(FLAT_VECS):
                    give = v[t].copy()
                    give[0] = v[t + 1][0]
                    b = give[(lanes + 1) % 32]           # the shuffle from lane l + 1
                    out = np.concatenate([v[t][:, h:], b[:, :h]], axis=1)
                    m = cb // 4 + lanes + 32 * t
                    pos = off + h + 4 * m[m < nb]
                    assert (pos % 4 == 0).all(), "a vector store off 16 bytes"
                    dst[pos[:, None] + np.arange(4)] = out[m < nb]
                    np.add.at(wr, (pos[:, None] + np.arange(4)).ravel(), 1)
                    c = 4 * m[:, None] + np.arange(4)
                    ends = (c < n) & ((c < h) | (c >= tail))   # the ragged head and tail
                    dst[off + c[ends]] = v[t][ends]
                    np.add.at(wr, off + c[ends], 1)
    else:
        c = np.arange(n)
        for src, dst, wr in zip(srcs, dsts, writes):
            dst[off + c] = src[row + c]
            np.add.at(wr, off + c, 1)
    slot = off + kept
    if slots and 0 <= slot < capacity:
        for dst, f in zip(dsts, fills):
            dst[slot] = f
        writes[:, slot] += 1


def _model_fill_tail(dsts, writes, fills, total, c, capacity):
    """fill_tail: ticket c's chunk of TAIL_CHUNK positions, its part in
    [total, capacity), 16 bytes a store between the ragged ends; False
    where the chunk starts past the capacity."""
    chunk = total // TAIL_CHUNK + c
    lo, hi = max(total, chunk * TAIL_CHUNK), min(chunk * TAIL_CHUNK + TAIL_CHUNK, capacity)
    if lo >= hi:
        return False
    p = chunk * TAIL_CHUNK + 4 * np.arange(TAIL_CHUNK // 4)
    whole = (p >= lo) & (p + 4 <= hi)
    ends = (p[~whole][:, None] + np.arange(4)).ravel()
    pos = np.concatenate([(p[whole][:, None] + np.arange(4)).ravel(),
                          ends[(ends >= lo) & (ends < hi)]])
    assert (p[whole] % 4 == 0).all()
    for dst, f in zip(dsts, fills):
        dst[pos.astype(np.int64)] = f
    np.add.at(writes, (slice(None), pos.astype(np.int64)), 1)
    return True


def _model_records_to_flat(counts, idx, intg, dist, offsets, kept, o_idx, o_intg, o_dist, state,
                           n_rows, width, capacity, slots, idx_fill, val_bits, dist_bits,
                           range_rows, stats=None):
    """grace_records_to_flat: the state zeroed; tickets in order, ticket t
    below the ranges' count range t of range_rows rows (a thread a row:
    clamp, u32 scan, the look-back; the offsets and counts; a warp a row's
    copy), the later ones the tail's chunks. The ranges run in waves of
    LOOK_BACK_WAVE that publish their sums first and look back last one
    first, so a look-back reads windows of aggregates before it meets an
    inclusive sum. The outputs are poisoned first and every position must
    be written once (a 16-byte store counts its four)."""
    assert 1 <= range_rows <= FLAT_THREADS
    n_ranges = -(-n_rows // range_rows)
    words = _view(state, ctypes.c_uint64, 1 + n_ranges)
    words[:] = 0                                            # the memset
    cnt = _view(counts, ctypes.c_int32, n_rows).astype(np.int64)
    o_off, o_kept = _view(offsets, ctypes.c_int32, n_rows), _view(kept, ctypes.c_int32, n_rows)
    srcs = [_view(p, ctypes.c_uint32, n_rows * width) for p in (idx, intg, dist)]
    dsts = [_view(p, ctypes.c_uint32, capacity) for p in (o_idx, o_intg, o_dist)]
    fills = [np.int32(idx_fill).view(np.uint32), np.int32(val_bits).view(np.uint32),
             np.int32(dist_bits).view(np.uint32)]
    writes = np.zeros((3, capacity), int)   # stores into each position of each buffer
    rows_written = np.zeros(n_rows, int)
    for d in dsts + [o_off.view(np.uint32), o_kept.view(np.uint32)]:
        d[:] = POISON
    ranges = words[1:]
    for w0 in range(0, n_ranges, LOOK_BACK_WAVE):
        wave = range(w0, min(w0 + LOOK_BACK_WAVE, n_ranges))
        scans = {}
        for t in wave:   # each range's scan, its sum published
            r0 = t * range_rows
            k = np.minimum(cnt[r0:r0 + range_rows], width)
            stride = (k + slots) & M32
            incl = np.cumsum(stride) & M32
            scans[t] = (k, stride, incl)
            agg = int(incl[-1])
            ranges[t] = (INCLUSIVE if t == 0 else AGGREGATE) | agg
        for t in reversed(wave):   # then the look-backs, the last range first
            k, stride, incl = scans[t]
            base, windows = (0, 0) if t == 0 else _model_look_back(ranges, t)
            if stats is not None:
                stats.append(windows)
            ranges[t] = INCLUSIVE | ((base + int(incl[-1])) & M32)
            r0 = t * range_rows
            off = ((base + incl - stride) & M32).astype(np.uint32).view(np.int32)
            o_off[r0:r0 + len(k)] = off
            o_kept[r0:r0 + len(k)] = k
            rows_written[r0:r0 + len(k)] += 1
            for i in range(len(k)):
                _model_copy_row(srcs, dsts, writes, (r0 + i) * width, int(off[i]), int(k[i]),
                                width, capacity, slots, fills)
    total = max(int(np.uint32(ranges[-1] & M32).view(np.int32)), 0) if n_ranges else 0
    c = 0
    while _model_fill_tail(dsts, writes, fills, total, c, capacity):
        c += 1
    assert (writes == 1).all(), "a position written other than once"
    assert (rows_written == 1).all(), "a row's offset and count written other than once"


MODELS = {"grace_sort_rows": _model_sort_rows, "grace_seg_heads": _model_seg_heads,
          "grace_seg_count": _model_seg_count, "grace_seg_starts": _model_seg_starts,
          "grace_segmented_sort": _model_segmented_sort,
          "grace_seg_long_scan": _model_seg_long_scan, "grace_seg_check": _model_seg_check,
          "grace_seg_chunks": _model_seg_chunks,
          "grace_seg_merge": _model_seg_merge, "grace_seg_gather": _model_seg_gather,
          "grace_records_to_flat": _model_records_to_flat}


@pytest.fixture
def model_launch(monkeypatch):
    """Replace the ctypes launch with the numpy models; check each call's
    arguments against the entry's kinds in ``_kernels.KERNELS``."""
    calls = []

    def launch(name, entry, device, *args):
        kinds = _kernels.KERNELS[name][2][entry]
        assert name == "segsort" and len(args) == len(kinds)
        for a, k in zip(args, kinds):
            assert (isinstance(a, int) and not isinstance(a, bool)) or (k == "p" and a is None)
        calls.append(entry)
        MODELS[entry](*args)

    monkeypatch.setattr(_kernels, "launch", launch)
    return calls


def _kernel_vs_plain(kind, tag):
    args = ARGS[kind](tag)
    got = segsort_outputs(kind, args, plain=False)
    want = segsort_outputs(kind, args, plain=True)
    for i, (g, w) in enumerate(zip(got, want)):
        _bits_equal(g.numpy(), w.numpy(), f"{kind} {tag}: output {i}")


@pytest.mark.parametrize("tag", ROWS)
def test_sort_rows_model_matches_plain(tag, model_launch):
    before = tpr.sort_rows_cuda.launches
    _kernel_vs_plain("rows", tag)
    assert tpr.sort_rows_cuda.launches == before + 1
    width = SEGSORT_ROW_CASES[tag][2]
    if width <= tso.SEG_CHUNK:
        assert model_launch == ["grace_sort_rows"]
    else:   # the long route: one segment a row, chunks, merges
        assert model_launch[:4] == ["grace_seg_heads", "grace_seg_count", "grace_seg_starts",
                                    "grace_segmented_sort"]
        assert {"grace_seg_chunks", "grace_seg_merge", "grace_seg_gather"} <= set(model_launch)


@pytest.mark.parametrize("tag", [ROWS[1], ROWS[2]])
def test_sort_rows_model_long_route_small_chunks(tag, model_launch, monkeypatch):
    """Rows of 512 and 384 on the long route, forced with chunks of 128 (the
    smallest the merge tiles take): every row is sorted in chunks and
    merged over several rounds."""
    monkeypatch.setattr(tso, "SEG_CHUNK", 128)
    _kernel_vs_plain("rows", tag)
    assert model_launch.count("grace_seg_merge") == tso._merge_rounds(
        np.prod(segsort_rows(tag)[1].shape), 128) > 2


@pytest.mark.parametrize("tag", FLAT)
def test_records_to_flat_model_matches_plain(tag, model_launch):
    before = tpr.records_to_flat_cuda.launches
    _kernel_vs_plain("flat", tag)
    assert tpr.records_to_flat_cuda.launches == before + 1
    assert model_launch == ["grace_records_to_flat"]


def _flat_layout_of(tag):
    """(kept a row, offsets as the plain version scans them, width,
    capacity, rows a block) of SEGSORT_FLAT_CASES' case ``tag``."""
    rows, capacity, kw = segsort_flat(tag)
    width = rows[1].shape[1]
    kept = np.minimum(rows[0].astype(np.int64), width)
    stride = kept + int(kw["sentinel_slots"])
    return kept, np.cumsum(stride) - stride, width, capacity, kw.get("_rows", tpr.FLAT_ROWS)


def test_flat_cases_reach_their_edges():
    """The flat cases hold what the E10 kernel's edges need: rows of 0, 1,
    2, 3 and width records starting at each of the four destination words
    mod 4 (on 16-byte rows, and on rows of a width no multiple of 4);
    rows past a 512-column chunk; a capacity ending inside a row's body
    vector, below the total, past it and 0; row counts no multiple of the
    rows a block; more than 32 blocks behind a look-back."""
    seen_vec, seen_scalar = set(), set()
    cut = past = below = zero = ragged_ranges = 0
    for tag in FLAT:
        kept, off, width, capacity, block = _flat_layout_of(tag)
        if SEGSORT_FLAT_CASES[tag][5] != "ragged":
            continue
        kind = np.select([kept <= 3, kept == width], [kept, np.full_like(kept, -1)], 99)
        pairs = {(int(k), int(o) % 4) for k, o in zip(kind, off) if k != 99}
        (seen_vec if width % 4 == 0 else seen_scalar).update(pairs)
        total = int(kept.sum() + SEGSORT_FLAT_CASES[tag][4] * kept.shape[0])
        zero += capacity == 0
        below += 0 < capacity < total
        past += capacity > total
        ragged_ranges = max(ragged_ranges, -(-kept.shape[0] // block))
        assert kept.shape[0] % block, tag     # the last block holds fewer rows
        r = np.searchsorted(off, capacity, side="right") - 1
        if 0 < capacity < total and off[r] < capacity < off[r] + kept[r]:
            h = (4 - off[r] % 4) % 4
            inside = capacity - off[r] - h
            cut += inside > 0 and inside % 4 and inside < 4 * ((kept[r] - h) // 4)
    every = {(k, a) for k in (0, 1, 2, 3, -1) for a in range(4)}
    assert every <= seen_vec and every <= seen_scalar
    assert any(_flat_layout_of(t)[2] > 512 and _flat_layout_of(t)[2] % 4 == 0 for t in FLAT)
    assert cut and past and below and zero and ragged_ranges > 32


def test_flat_model_constants_are_the_kernels():
    """The model's block, vector and tail-chunk sizes are segsort.cu's, and
    the wrapper's rows a block fit a block."""
    src = open(_kernels.CSRC + "/segsort.cu").read()
    consts = {name: v for name, v in re.findall(r"constexpr int (\w+) = ([^;]+);", src)}
    assert int(consts["kFlatThreads"]) == FLAT_THREADS == tpr._FLAT_MAX_ROWS
    assert int(consts["kFlatVecs"]) == FLAT_VECS
    assert consts["kTailChunk"] == "4 * 4 * kFlatThreads" and TAIL_CHUNK == 16 * FLAT_THREADS
    assert 1 <= tpr.FLAT_ROWS <= FLAT_THREADS


def test_flat_look_back_reads_past_a_window(model_launch, monkeypatch):
    """Forced to 7 rows a block, the flat layout's look-backs (the model
    publishes a wave of 40 ranges' sums before any looks back) read more
    than one window of 32 predecessors and meet the inclusive sum behind
    it: the same bits."""
    stats = []
    monkeypatch.setitem(MODELS, "grace_records_to_flat",
                        functools.partial(_model_records_to_flat, stats=stats))
    tag = next(t for t in FLAT if SEGSORT_FLAT_CASES[t][6] == 7)
    _kernel_vs_plain("flat", tag)
    assert len(stats) == -(-SEGSORT_FLAT_CASES[tag][0] // 7) and max(stats) >= 2


@pytest.mark.parametrize("tag", CSR)
def test_segmented_sort_model_matches_plain(tag, model_launch):
    before = tso.segmented_sort_cuda.launches
    _kernel_vs_plain("csr", tag)
    assert tso.segmented_sort_cuda.launches == before + 1
    n_arrays = 2 + sum(SEGSORT_CSR_CASES[tag][3])
    assert model_launch.count("grace_segmented_sort") == -(-n_arrays // tso.MAX_PAYLOADS)


@pytest.mark.parametrize("tag", [CSR[0], CSR[1], CSR[3], CSR[5], CSR[8], CSR[9]])
def test_segmented_sort_model_small_chunks(tag, model_launch, monkeypatch):
    """Chunks of 128: more segments take the long route and several merge
    rounds (the capacity padding in the last ray's segment merged, as a
    segment of its own copied); the same bits."""
    monkeypatch.setattr(tso, "SEG_CHUNK", 128)
    _kernel_vs_plain("csr", tag)
    assert model_launch.count("grace_seg_merge") >= 5


@pytest.mark.parametrize("e_n", [1, 2, 4, 8, 16, 32])
def test_warp_sort_model_is_a_stable_sort(e_n):
    """sort_keys' design (the in-order check; the bitonic network on the
    u32 (key - min) << bits | position where span and positions fit in 32
    bits, else on the u64 key << 32 | position) is a stable sort of u32
    keys on runs of 32 e_n keys (E = 16 a lane, 32 past 512: the shorter
    runs with pads): runs of heavy ties, keys over the whole u32 range
    (the u64 network), a span just fitting and one bit too wide, runs
    shorter than 32 E (pads ~0 last), runs in order, descending and all
    equal, each equal to numpy's stable argsort."""
    rng = np.random.default_rng(e_n)
    w = 32 * e_n
    runs = [rng.integers(0, 4, w), rng.integers(0, 1 << 32, w), np.sort(rng.integers(0, 9, w)),
            np.sort(rng.integers(0, 9, w))[::-1], np.full(w, 7), rng.integers(0, 3, w // 2 + 1),
            np.append(np.sort(rng.integers(1, 9, w - 1)), 0),
            7 + rng.integers(0, 2, w) * (0xFFFFFFFF >> (w - 1).bit_length()),
            7 + rng.integers(0, 2, w) * ((0xFFFFFFFF >> (w - 1).bit_length()) + 1)]
    for keys in runs:
        keys = keys.astype(np.uint32)
        got_k, got_v = _sort_runs([keys])[0]
        want = np.argsort(keys, kind="stable")
        assert np.array_equal(got_v, want) and np.array_equal(got_k, keys[want])


def _flags_of(model_launch, monkeypatch, kind, tag):
    """The long list and grace_seg_check's flags of case ``tag``, the
    kernel route against the plain version as _kernel_vs_plain runs it."""
    seen = []

    def check(*args):
        _model_seg_check(*args)
        n_max = args[7]
        n_l = _long_list(args[5], n_max)
        seen.append((_view(args[2], ctypes.c_int32, n_l).copy(),
                     _view(args[3], ctypes.c_int32, n_l).copy(),
                     _view(args[6], ctypes.c_int32, n_l).copy()))

    monkeypatch.setitem(MODELS, "grace_seg_check", check)
    _kernel_vs_plain(kind, tag)
    (starts, lens, flags), = seen
    order = np.argsort(starts)
    return starts[order], lens[order], flags[order]


@pytest.mark.parametrize("tag,want", [(CSR[8], [1]), (CSR[9], [0]), (CSR[10], [1, 0]),
                                      (CSR[11], [1, 1]), (CSR[12], None)])
def test_long_route_checks_each_segment_for_order(tag, want, model_launch, monkeypatch):
    """grace_seg_check flags exactly the long segments whose order keys
    are not non-decreasing: the padding after the last ray's records is
    out of order, the last ray's padding alone is in order (its chunks
    are neither sorted nor merged, and it is copied), one pair swapped
    across a chunk boundary or a smaller last element is out of order;
    keys that tie only in the order are in order."""
    dist, *_ = segsort_csr(tag)
    starts, lens, flags = _flags_of(model_launch, monkeypatch, "csr", tag)
    keys = _order_bits(dist)
    direct = [int((np.diff(keys[a:a + b].astype(np.int64)) < 0).any())
              for a, b in zip(starts, lens)]
    assert flags.tolist() == direct
    if want is not None:
        assert flags.tolist() == want
    else:   # the ties case has long segments in order and out of it
        assert set(flags.tolist()) == {0, 1}


@pytest.mark.parametrize("tag", [CSR[0], CSR[3], CSR[8], CSR[12]])
def test_library_keys_give_the_plain_order(tag):
    """chip_smoke's E9 library call, torch.sort of the int64 keys segment
    << 32 | order key (csr_sort_keys, order_key_torch), orders the flat
    layout as the plain version does: the same function, bit for bit."""
    dist, offsets, idx, _, total = _csr_args(tag)
    flat = tsph.SphTraceResult(offsets, None, idx, None, dist,
                               dist.shape[0] if total is None else total)
    order = torch.sort(csr_sort_keys(flat), stable=True).indices
    got = (dist[order], idx[order])
    want = tso._sort_by_distance_plain(dist, offsets, idx, total_hits=total)
    for g, w in zip(got, want):
        _bits_equal(g.numpy(), w.numpy(), f"csr {tag}")
    assert np.array_equal(order_key_torch(dist).numpy(), _order_bits(dist.numpy()))


def test_wrappers_launch_the_kernels(model_launch, monkeypatch):
    """The public functions take the kernels where the tensors are not on
    the CPU (the route test made to say so): sort_records_by_distance,
    records_to_flat, sort_by_distance, and trace_sph(engine="pallas") and
    trace_with_sentinels_sph through records_to_flat; never the plain
    versions."""
    dev = "cpu"
    ss, rays = records_scene(dev)
    rec = tpr.pallas_trace_sph_records(rays, ss, 128)
    want_sorted = tpr._sort_records_by_distance_plain(rec)
    total = int(rec.counts.sum())
    want_flat = tpr._records_to_flat_plain(rec, total)
    want_sent = tpr._records_to_flat_plain(rec, total + rays.n_rays, -3, 1.5, 9.0, True)
    want_csr = tso._sort_by_distance_plain(want_flat[4], want_flat[0], want_flat[2],
                                           want_flat[3], total_hits=total)
    monkeypatch.setattr(tso, "_on_cpu", lambda t: False)
    for mod, name in ((tpr, "_sort_records_by_distance_plain"), (tpr, "_records_to_flat_plain"),
                      (tso, "_sort_by_distance_plain")):
        monkeypatch.setattr(mod, name, lambda *a, **k: pytest.fail("the plain route was taken"))
    for a, b in zip(tpr.sort_records_by_distance(rec), want_sorted):
        _bits_equal(a.numpy(), b.numpy(), "sort_records_by_distance")
    for a, b in zip(tpr.records_to_flat(rec, total), want_flat):
        _bits_equal(a.numpy(), b.numpy(), "records_to_flat")
    flat = tsph.trace_sph(rays, ss, None, capacity=total, engine="pallas", per_ray_capacity=128)
    for a, b in zip(flat[:5], want_flat):
        _bits_equal(a.numpy(), b.numpy(), "trace_sph(engine='pallas')")
    sent = tsph.trace_with_sentinels_sph(rays, ss, None, total + rays.n_rays, -3, 1.5, 9.0,
                                         engine="pallas", per_ray_capacity=128)
    for a, b in zip(sent[:5], want_sent):
        _bits_equal(a.numpy(), b.numpy(), "trace_with_sentinels_sph(engine='pallas')")
    got = tso.sort_by_distance(flat.distances, flat.offsets, flat.indices, flat.integrals,
                               total_hits=flat.total_hits)
    for a, b in zip(got, want_csr):
        _bits_equal(a.numpy(), b.numpy(), "sort_by_distance")
    assert set(model_launch) == set(MODELS)   # the long route too: more hits than a chunk


def test_path4_gate_on_a_small_record_trace(model_launch, monkeypatch):
    """Main path 4's gate at a small size, on the kernels' models: the CSR
    sort of trace_sph's flat layout equals the flat layout of the sorted
    rows, on rows of 128 and on the same rows cut to 16 (rows that
    overflow; the fill entries past the kept records join the last ray's
    segment)."""
    ss, rays = records_scene("cpu")
    full = tpr.pallas_trace_sph_records(rays, ss, 128)
    monkeypatch.setattr(tso, "_on_cpu", lambda t: False)
    for cap in (128, 16):
        rec = tpr.RecordTraceResult(full.counts, *(t[:, :cap].contiguous() for t in full[1:]))
        total = rec.counts.sum(dtype=torch.int32)
        offsets, _, ind, intg, dist = tpr.records_to_flat(rec, int(total))
        flat = tsph.SphTraceResult(offsets, rec.counts, ind, intg, dist, total)
        flat_sorted = tso.sort_by_distance(dist, offsets, ind, intg, total_hits=total)
        line = segsort_gate(rec, tpr.sort_records_by_distance(rec), flat, flat_sorted)
        assert "bit-equal" in line
    assert bool(rec.overflowed.any())


def test_wrappers_refuse_what_the_kernels_do_not_take():
    rec = _rows_args(ROWS[0])
    with pytest.raises(TypeError):
        tpr.sort_rows_cuda(rec._replace(distances=rec.distances.double()))
    with pytest.raises(ValueError, match="inconsistent"):
        tpr.sort_rows_cuda(rec._replace(counts=rec.counts[:-1]))
    with pytest.raises(ValueError, match="capacity"):
        tpr.records_to_flat_cuda(rec, -1)
    with pytest.raises(ValueError, match="index_sentinel"):
        tpr.records_to_flat_cuda(rec, 10, index_sentinel=1 << 40)
    dist, offsets, idx, data, _ = _csr_args(CSR[0])
    with pytest.raises(TypeError):
        tso.segmented_sort_cuda(dist, offsets.double(), idx)
    with pytest.raises(TypeError):
        tso.segmented_sort_cuda(dist, offsets, idx, data[0].double())
    with pytest.raises(ValueError):
        tso.segmented_sort_cuda(dist, offsets, idx[:-1])
