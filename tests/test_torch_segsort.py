"""The records' post-processing against grace_tpu, and the design of its
CUDA kernels (``csrc/segsort.cu``) as numpy models.

- The plain versions (``_sort_records_by_distance_plain``,
  ``_records_to_flat_plain``, ``segops._sort_by_distance_plain``) against
  ``grace_tpu`` (jitted on the CPU), bit for bit, at every case of
  chip_smoke's ``SEGSORT_ROW_CASES`` (keys of every special value of the
  order, exact ties, sentinel slots mid-row and at the tail, real +inf
  distances, rows that overflowed, widths 128 to 2,048),
  ``SEGSORT_FLAT_CASES`` (capacity equal to, below and past the kept total,
  sentinel slots with other sentinels, no rows, an overflowed row at
  capacity 0) and ``SEGSORT_CSR_CASES`` (empty, repeated, unordered,
  negative, past-H and near-2^31 offsets; total_hits 0, inside and past
  H; segments past a warp's 1,024; a trailing pseudo-segment of 1.2M
  entries; nine data arrays; one segment; no offsets). The order key as
  a stable numpy sort equals ``lax.sort``'s order of the special values.
- numpy models of the C entries, written as the kernels index their
  threads (a warp's 32 E keys in registers: strides below E inside a
  lane, the others by shuffles; a record row sorted only over the prefix
  that ends with its last record, its NaNs moved past the tail of
  sentinel slots; head flags, a warp a tile of 1,024 flags
  counted and placed by ballots; a warp a segment, long segments appended
  in any order, their chunks sorted, merged pairwise a tile of 256
  outputs at a time and gathered; a warp a row copying its records, its sentinel slot and the
  tail), run through the port's own wrappers with the ctypes launch
  replaced by the model (which reads and writes the tensors' host
  memory), bit-equal to the plain versions at every case above; the long
  route forced at a small size (chunks of 128, so rows of 384 and 512 and
  the CSR cases take several merge rounds, the merge in tiles of 256
  outputs with their co-ranks found by a warp's 32-way search).
- The public functions take the kernels where the tensors are not on the
  CPU (the route test made to say so), ``trace_sph`` and
  ``trace_with_sentinels_sph`` included, and main path 4's gate (the CSR
  sort of ``trace_sph``'s flat layout against the flat layout of the
  sorted rows) holds on a small record trace.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grace_tpu.ops.segops as jso
import grace_tpu.trace.pallas_records as jpr
from chip_smoke import (SEGSORT_CSR_CASES, SEGSORT_FLAT_CASES, SEGSORT_ROW_CASES,
                        SPECIAL_BITS, records_scene, segsort_csr, segsort_flat, segsort_gate,
                        segsort_outputs, segsort_rows)
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


def _keys(keys, mask, pos):
    """sort_key: (order bits << 32) | position; a sentinel index keys +inf."""
    k = keys[pos]
    if mask is not None:
        k = np.where(mask[pos] == -1, np.float32(np.inf), k)
    return (_order_bits(k).astype(U64) << U64(32)) | pos.astype(U64)


def _warp_bitonic(v):
    """warp_bitonic on runs v u64[m, 32, E] (lane, register): the steps with
    J >= E exchange with lane ^ (J / E) (keep_min where the lane's bit and
    the direction agree), the others swap registers e and e | J."""
    m, lanes, e_n = v.shape
    lane = np.arange(32)[:, None]
    e = np.arange(e_n)[None, :]
    k = 2
    while k <= 32 * e_n:
        j = k // 2
        while j >= 1:
            if j >= e_n:
                w = v[:, lane[:, 0] ^ (j // e_n), :]
                keep_min = ((lane & (j // e_n)) == 0) == (((lane * e_n) & k) == 0)
                v = np.where(keep_min, np.minimum(v, w), np.maximum(v, w))
            else:
                lo = np.flatnonzero((np.arange(e_n) & j) == 0)
                a, b = v[:, :, lo], v[:, :, lo | j]
                ascending = ((lane * e_n + e[:, lo]) & k) == 0
                swap = (a > b) == ascending
                v[:, :, lo], v[:, :, lo | j] = np.where(swap, b, a), np.where(swap, a, b)
            j //= 2
        k *= 2
    return v


def _sort_runs(keys, mask, starts, lens):
    """network_for on every run [starts[r], starts[r] + lens[r]): the
    sorted keys of each run (a list of u64 arrays), E = the next power of
    two of ceil(len / 32) a lane, the pads ~0. (The kernels stage the keys
    and payloads through shared memory so that global accesses are
    coalesced; that moves no bit.)"""
    out = [np.zeros(0, U64)] * len(starts)
    per_lane = np.maximum(1, -(-np.asarray(lens) // 32))
    e_of = 1 << np.ceil(np.log2(per_lane)).astype(int)
    for e_n in np.unique(e_of):
        runs = np.flatnonzero(e_of == e_n)
        i = np.arange(32 * e_n)
        s, ln = np.asarray(starts)[runs][:, None], np.asarray(lens)[runs][:, None]
        pos = np.where(i < ln, s + i, 0)
        v = np.where(i < ln, _keys(keys, mask, pos.ravel()).reshape(pos.shape), ~U64(0))
        v = _warp_bitonic(v.reshape(-1, 32, e_n)).reshape(-1, 32 * e_n)
        for row, r in enumerate(runs):
            out[r] = v[row, :lens[r]]
    return out


def _payloads(host_ptrs, n_payloads, n):
    table = _view(host_ptrs, ctypes.c_uint64, 2 * n_payloads)
    return ([_view(int(p), ctypes.c_uint32, n) for p in table[:n_payloads]],
            [_view(int(p), ctypes.c_uint32, n) for p in table[n_payloads:]])


def _model_sort_rows(dist, idx, intg, o_idx, o_intg, o_dist, n_rows, width):
    """grace_sort_rows: a warp a row, keyed by the distances with the
    sentinel slots at +inf; the network only over the prefix that ends with
    the row's last record, its NaNs moved past the tail of sentinel slots;
    the three arrays gathered by the positions."""
    n = n_rows * width
    keys, mask = _view(dist, ctypes.c_float, n), _view(idx, ctypes.c_int32, n)
    rows = mask.reshape(n_rows, width) != -1
    last = np.where(rows.any(axis=1), width - 1 - np.argmax(rows[:, ::-1], axis=1), -1)
    m = last + 1
    nans = (np.isnan(keys.reshape(n_rows, width)) & rows).sum(axis=1)
    src = np.empty((n_rows, width), np.int64)
    runs = _sort_runs(keys, mask, np.arange(n_rows) * width, m)
    for r in range(n_rows):
        order = (runs[r].astype(np.int64) & 0xFFFFFFFF) - r * width
        keep = m[r] - nans[r]
        src[r, :keep] = order[:keep]
        src[r, keep:width - nans[r]] = np.arange(m[r], width)
        src[r, width - nans[r]:] = order[keep:]
    src = (src + np.arange(n_rows)[:, None] * width).ravel()
    for s_ptr, d_ptr in ((idx, o_idx), (intg, o_intg), (dist, o_dist)):
        _view(d_ptr, ctypes.c_uint32, n)[:] = _view(s_ptr, ctypes.c_uint32, n)[src]


def _model_seg_heads(offsets, total, head, n_off, n):
    off = _view(offsets, ctypes.c_int32, n_off).astype(np.int64)
    th = int(_view(total, ctypes.c_int32, 1)[0]) if total else n
    h = _view(head, ctypes.c_uint8, n)
    h[0] = 1
    if 0 < th < n:
        h[th] = 1
    o = off[1:]
    o = np.where(o < 0, o + n, o)
    h[o[(o > 0) & (o < th)]] = 1


def _model_seg_count(head, counts, n):
    """A warp a tile of 1,024 flags: 32 ballots."""
    tiles = -(-n // tso.HEAD_TILE)
    flags = np.zeros(tiles * tso.HEAD_TILE, bool)
    flags[:n] = _view(head, ctypes.c_uint8, n) != 0
    _view(counts, ctypes.c_int32, tiles)[:] = flags.reshape(tiles, -1).sum(axis=1)


def _model_seg_starts(head, incl, starts, n):
    """A warp a tile: the heads placed by their ballot rank after the
    scan's base; the last tile's warp writes starts[n_seg] = n."""
    tiles = -(-n // tso.HEAD_TILE)
    inc = _view(incl, ctypes.c_int32, tiles)
    st = _view(starts, ctypes.c_int32, int(inc[-1]) + 1)
    flags = _view(head, ctypes.c_uint8, n) != 0
    for w in range(tiles):
        base = int(inc[w - 1]) if w else 0
        for it in range(tso.HEAD_TILE // 32):
            p = w * tso.HEAD_TILE + it * 32 + np.arange(32)
            vote = np.zeros(32, bool)
            vote[p < n] = flags[p[p < n]]
            st[base:base + int(vote.sum())] = p[vote]
            base += int(vote.sum())
    st[int(inc[-1])] = n


_ARRIVALS = np.random.default_rng(1)


def _model_segmented_sort(keys, mask, starts, n_seg, host_ptrs, long_start, long_len, n_long,
                          n_payloads, max_segs, chunk):
    """A warp a segment of up to min(chunk, WARP_RUN): longer ones appended
    at the counter, in an arbitrary (here random) order, the others sorted
    and gathered."""
    ns = int(_view(n_seg, ctypes.c_int32, 1)[0])
    assert ns <= max_segs
    st = _view(starts, ctypes.c_int32, ns + 1).astype(np.int64)
    n = int(st[-1])
    k = _view(keys, ctypes.c_float, n)
    m = _view(mask, ctypes.c_int32, n) if mask else None
    srcs, dsts = _payloads(host_ptrs, n_payloads, n)
    lens = np.diff(st)
    run = min(chunk, tso.WARP_RUN)   # a kMaxE = 16 kernel's longest run
    long = np.flatnonzero(lens > run)
    n_l = _view(n_long, ctypes.c_int32, 1)
    l_s = _view(long_start, ctypes.c_int32, n // (run + 1) + 1)
    l_n = _view(long_len, ctypes.c_int32, n // (run + 1) + 1)
    for i in long[_ARRIVALS.permutation(long.shape[0])]:
        l_s[n_l[0]], l_n[n_l[0]] = st[i], lens[i]
        n_l[0] += 1
    short = np.flatnonzero(lens <= run)
    runs = _sort_runs(k, m, st[short], lens[short])
    for i, run in zip(short, runs):
        src = run.astype(np.int64) & 0xFFFFFFFF
        for s_arr, d_arr in zip(srcs, dsts):
            d_arr[st[i]:st[i] + lens[i]] = s_arr[src]


def _long_list(n_long, n_max):
    """The long list's length *n_long, checked against its room."""
    n_l = int(_view(n_long, ctypes.c_int32, 1)[0])
    assert 0 <= n_l <= n_max
    return n_l


def _model_seg_chunks(keys, mask, long_start, long_len, chunk_end, n_long, buf, n_max, chunk,
                      n):
    """A warp a chunk g < chunk_end[n_long - 1]: its entry by binary search
    over the first n_long entries, its keys sorted into buf at their
    positions."""
    ends = _view(chunk_end, ctypes.c_int32, _long_list(n_long, n_max))
    l_s, l_n = _view(long_start, ctypes.c_int32, n_max), _view(long_len, ctypes.c_int32, n_max)
    g = np.arange(int(ends[-1]) if ends.shape[0] else 0)
    i = np.searchsorted(ends, g, side="right")
    c = g - (ends[i] - (l_n[i] + chunk - 1) // chunk)
    s = l_s[i].astype(np.int64) + c * chunk
    ln = np.minimum(chunk, l_n[i] - c * chunk)
    k = _view(keys, ctypes.c_float, n)
    m = _view(mask, ctypes.c_int32, n) if mask else None
    out = _view(buf, ctypes.c_uint64, n)
    for start, length, run in zip(s, ln, _sort_runs(k, m, s, ln)):
        out[start:start + length] = run


def _warp_co_rank(A, B, na, nb, k):
    """warp_co_rank for arrays of tiles: the smallest i with
    !(A[i] < B[k - i - 1]), by 32 probes a step, then one ballot. A and B
    are functions of (tile, index) -> u64."""
    lo, hi = np.maximum(k - nb, 0), np.minimum(k, na)
    lane = np.arange(32)[None, :]

    def ballot(i):
        ok = i < hi[:, None]
        safe_i = np.where(ok, i, 0)
        safe_j = np.where(ok, k[:, None] - i - 1, 0)
        return (ok & (A(safe_i) < B(safe_j))).sum(axis=1)

    while (hi - lo > 32).any():
        wide = hi - lo > 32
        step = np.where(wide, (hi - lo + 31) // 32, 1)
        c = ballot(lo[:, None] + (lane + 1) * step[:, None] - 1)
        top = lo + (c + 1) * step - 1
        lo, hi = np.where(wide, lo + c * step, lo), np.where(wide, np.minimum(top, hi), hi)
    return lo + ballot(lo[:, None] + lane)


def _model_seg_merge(long_start, long_len, tile_end, n_long, src, dst, n_max, width, n):
    """A block a tile of MERGE_TILE outputs of one pair of runs: its two
    co-ranks by warp_co_rank, the tile's elements of both runs staged, each
    placed at its index in its part + the other part's elements below it."""
    T = tso.MERGE_TILE
    ends = _view(tile_end, ctypes.c_int32, _long_list(n_long, n_max)).astype(np.int64)
    l_s, l_n = _view(long_start, ctypes.c_int32, n_max), _view(long_len, ctypes.c_int32, n_max)
    x_in, x_out = _view(src, ctypes.c_uint64, n), _view(dst, ctypes.c_uint64, n)
    g = np.arange(int(ends[-1]) if ends.shape[0] else 0)
    i = np.searchsorted(ends, g, side="right")
    ln, s = l_n[i].astype(np.int64), l_s[i].astype(np.int64)
    k0 = (g - (ends[i] - (ln + T - 1) // T)) * T
    live = ln > width   # a segment that is one run already stays where it is
    g, i, ln, s, k0 = g[live], i[live], ln[live], s[live], k0[live]
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
        part_a = x_in[base_a[t] + i0[t]:base_a[t] + i1[t]]
        part_b = x_in[base_b[t] + kk0[t] - i0[t]:base_b[t] + kk1[t] - i1[t]]
        out0 = s[t] + p0[t] + kk0[t]
        x_out[out0 + np.arange(part_a.shape[0]) + np.searchsorted(part_b, part_a)] = part_a
        x_out[out0 + np.arange(part_b.shape[0]) + np.searchsorted(part_a, part_b)] = part_b


def _model_seg_gather(long_start, long_len, elem_end, n_long, src0, src1, host_ptrs, n_max,
                      n_payloads, chunk, n):
    """Each long segment's keys from the buffer its last merge round wrote
    (rounds % 2), the payloads gathered by their positions."""
    ends = _view(elem_end, ctypes.c_int32, _long_list(n_long, n_max)).astype(np.int64)
    l_s, l_n = _view(long_start, ctypes.c_int32, n_max), _view(long_len, ctypes.c_int32, n_max)
    k = np.arange(int(ends[-1]) if ends.shape[0] else 0)
    i = np.searchsorted(ends, k, side="right")
    p = l_s[i] + (k - (ends[i] - l_n[i]))
    rounds = np.array([tso._merge_rounds(int(x), chunk) for x in l_n[i]], int)
    keys = np.where(rounds % 2 == 1, _view(src1, ctypes.c_uint64, n)[p],
                    _view(src0, ctypes.c_uint64, n)[p])
    pos = keys.astype(np.int64) & 0xFFFFFFFF
    for s_arr, d_arr in zip(*_payloads(host_ptrs, n_payloads, n)):
        d_arr[p] = s_arr[pos]


POISON = np.uint32(0x7FBADBAD)


def _model_records_to_flat(counts, offsets, idx, intg, dist, o_idx, o_intg, o_dist, n_rows,
                           width, capacity, slots, idx_fill, val_bits, dist_bits):
    """A warp a row: columns below the kept count to offsets + col below the
    capacity, the sentinel slot; then the tail from the last row's end. The
    outputs are poisoned first and every position must be written once."""
    cnt = _view(counts, ctypes.c_int32, n_rows).astype(np.int64)
    off = _view(offsets, ctypes.c_int32, n_rows).astype(np.int64)
    srcs = [_view(p, ctypes.c_uint32, n_rows * width) for p in (idx, intg, dist)]
    dsts = [_view(p, ctypes.c_uint32, capacity) for p in (o_idx, o_intg, o_dist)]
    fills = [np.int32(idx_fill).view(np.uint32), np.int32(val_bits).view(np.uint32),
             np.int32(dist_bits).view(np.uint32)]
    writes = np.zeros(capacity, int)
    for d in dsts:
        d[:] = POISON
    for r in range(n_rows):
        c = np.arange(cnt[r])
        c = c[off[r] + c < capacity]
        for s_arr, d_arr in zip(srcs, dsts):
            d_arr[off[r] + c] = s_arr[r * width + c]
        writes[off[r] + c] += 1
        q = off[r] + cnt[r]
        if slots and q < capacity:
            for d_arr, f in zip(dsts, fills):
                d_arr[q] = f
            writes[q] += 1
    total = off[-1] + cnt[-1] + slots if n_rows else 0
    for d_arr, f in zip(dsts, fills):
        d_arr[total:] = f
    writes[total:] += 1
    assert (writes == 1).all(), "a position written other than once"


MODELS = {"grace_sort_rows": _model_sort_rows, "grace_seg_heads": _model_seg_heads,
          "grace_seg_count": _model_seg_count, "grace_seg_starts": _model_seg_starts,
          "grace_segmented_sort": _model_segmented_sort, "grace_seg_chunks": _model_seg_chunks,
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


@pytest.mark.parametrize("tag", CSR)
def test_segmented_sort_model_matches_plain(tag, model_launch):
    before = tso.segmented_sort_cuda.launches
    _kernel_vs_plain("csr", tag)
    assert tso.segmented_sort_cuda.launches == before + 1
    n_arrays = 2 + sum(SEGSORT_CSR_CASES[tag][3])
    assert model_launch.count("grace_segmented_sort") == -(-n_arrays // tso.MAX_PAYLOADS)


@pytest.mark.parametrize("tag", [CSR[0], CSR[1], CSR[3], CSR[5]])
def test_segmented_sort_model_small_chunks(tag, model_launch, monkeypatch):
    """Chunks of 128: more segments take the long route and several merge
    rounds; the same bits."""
    monkeypatch.setattr(tso, "SEG_CHUNK", 128)
    _kernel_vs_plain("csr", tag)
    assert model_launch.count("grace_seg_merge") >= 5


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
