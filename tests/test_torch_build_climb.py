"""The CUDA build's design (``csrc/build.cu``) as a numpy model, on the CPU.

The card's kernels cannot run here, so this file runs their design: the
two bottom-up climbs thread by thread, each step one arrival at a parent
(write the child's data, take the parent's flag: the first arrival exits,
the second climbs on), with the next thread to step drawn from a seeded
generator, three orders a case. The model's tree must be bit-equal, field
for field, to ``jax.jit(grace_tpu.build.lbvh.build_lbvh)`` and to the
port's plain build on the same boxes and deltas, and its phase A ranges
to ``cartesian_tree_ranges``. A numpy model of the key and delta kernels'
arithmetic is held to ``grace_tpu``'s keys and XOR deltas bit for bit and
to the port's plain float deltas bit for bit (``grace_tpu``'s own float
deltas round as XLA compiles them, within 2 ulp: ROADMAP C7).

The kernels' current form is modelled too: both climbs in blocks (stage 1
through the splits that lie inside a block, routed from the deltas alone;
stage 2 for the queued tops at device scope, blocks interleaved freely),
phase B over each block's compacted leaves with a group of lanes' ordered
box union, and the gather kernel's rows, boxes and deltas, each held to
``grace_tpu`` and the plain build bit for bit at several block sizes.
"""

import jax
import numpy as np
import pytest
import torch

import grace_tpu.build.deltas as jd
import grace_tpu.build.lbvh as jl
import grace_tpu.build.sph as jb
import grace_tpu_torch.build.deltas as td
import grace_tpu_torch.build.lbvh as tl
import grace_tpu_torch.build.sph as tb
from grace_tpu.core.errors import GraceError as JGraceError
from grace_tpu_torch.core.errors import GraceError as TGraceError

TREE_FIELDS = ("children", "child_aabbs", "leaves", "root", "n_nodes", "n_leaves")
ORDERS = (0, 1, 2)
MANTISSA_BITS = 26


# ---------------------------------------------------------------- the climbs


def parent_of(d, lo, hi, last, left_at, right_at):
    """The parent split of the node over leaves [lo, hi] of a sequence
    whose last leaf is ``last``, and whether the node is its right child:
    the ends count as larger than any delta, ties go right."""
    if lo == 0:
        return hi, False
    if hi == last:
        return lo - 1, True
    right = bool(d[left_at] < d[right_at])
    return (lo - 1 if right else hi), right


def run_threads(states, step, rng):
    """Step the live threads one arrival at a time, the next one drawn by
    ``rng``, until every thread has exited (``step`` returns False)."""
    live = list(range(len(states)))
    while live:
        j = int(rng.integers(len(live)))
        if not step(live[j]):
            live[j] = live[-1]
            live.pop()


def climb_ranges(d, max_per_leaf, rng):
    """Phase A (ranges_kernel): one thread a primitive. Returns (l, r,
    first, count, mark) as the kernel writes them."""
    n = d.shape[0] + 1
    l = np.full(n - 1, -1, np.int32)
    r = np.full(n - 1, -1, np.int32)
    flags = np.zeros(n - 1, np.int32)
    first = np.full(n, -7, np.int32)   # unwritten slots hold garbage on the card
    count = np.full(n, -7, np.int32)
    mark = np.zeros(n, np.int32)
    states = [[i, i] for i in range(n)]

    def step(t):
        lo, hi = states[t]
        p, right = parent_of(d, lo, hi, n - 1, lo - 1, hi)
        if right:
            r[p] = hi
        else:
            l[p] = lo
        flags[p] += 1
        if flags[p] == 1:
            return False
        lo, hi = int(l[p]), int(r[p])
        s_left, s_right = p - lo + 1, hi - p
        left_small, right_small = s_left <= max_per_leaf, s_right <= max_per_leaf
        write = left_small != right_small or s_left + s_right > max_per_leaf
        if left_small and write:
            first[lo], count[lo], mark[lo] = lo, s_left, 1
        if right_small and write:
            first[hi], count[hi], mark[hi] = p + 1, s_right, 1
        states[t] = [lo, hi]
        return not (lo == 0 and hi == n - 1)

    run_threads(states, step, rng)
    assert (flags == 2).all()
    return l, r, first, count, mark


def climb_nodes(d, first, count, mark, mins, maxs, rng):
    """Phase B (nodes_kernel): one thread a marked slot climbs from its big
    leaf. Returns the tree's fields as the kernel writes them."""
    n = mark.shape[0]
    scan = np.cumsum(mark).astype(np.int32)
    nl = int(scan[-1])
    children = np.full((n - 1, 2), -7, np.int32)
    boxes = np.full((n - 1, 2, 2, 3), np.nan, np.float32)
    leaves = np.full((n, 2), -7, np.int32)
    ends = np.zeros((n - 1, 4), np.int32)
    flags = np.zeros(n - 1, np.int32)
    root = []
    # the padding each thread past the valid rows writes
    leaves[nl:] = 0
    children[nl - 1:] = 0
    boxes[nl - 1:, :, 0] = np.inf
    boxes[nl - 1:, :, 1] = -np.inf
    states = []
    for s in np.flatnonzero(mark):
        k, a, c = int(scan[s]) - 1, int(first[s]), int(count[s])
        leaves[k] = (a, c)
        bmin, bmax = mins[a].copy(), maxs[a].copy()
        for q in range(a + 1, a + c):     # the leaf's primitives in order
            bmin, bmax = np.minimum(bmin, mins[q]), np.maximum(bmax, maxs[q])
        states.append(dict(lo=k, hi=k, a=a, b=a + c - 1, entry=~k, bmin=bmin, bmax=bmax))

    def step(t):
        st = states[t]
        p, right = parent_of(d, st["lo"], st["hi"], nl - 1, st["a"] - 1, st["b"])
        side = int(right)
        children[p, side] = st["entry"]
        boxes[p, side, 0], boxes[p, side, 1] = st["bmin"], st["bmax"]
        if right:
            ends[p, 2:] = st["hi"], st["b"]
        else:
            ends[p, :2] = st["lo"], st["a"]
        flags[p] += 1
        if flags[p] == 1:
            return False
        st["bmin"] = np.minimum(st["bmin"], boxes[p, 1 - side, 0])
        st["bmax"] = np.maximum(st["bmax"], boxes[p, 1 - side, 1])
        if right:
            st["lo"], st["a"] = int(ends[p, 0]), int(ends[p, 1])
        else:
            st["hi"], st["b"] = int(ends[p, 2]), int(ends[p, 3])
        st["entry"] = p
        if st["lo"] == 0 and st["hi"] == nl - 1:
            root.append(p)
            return False
        return True

    run_threads(states, step, rng)
    assert len(root) == 1 and (flags[: nl - 1] == 2).all() and (flags[nl - 1:] == 0).all()
    return dict(children=children, child_aabbs=boxes, leaves=leaves,
                root=np.int32(root[0]), n_nodes=np.int32(nl - 1), n_leaves=np.int32(nl))


def climb_build(mins, maxs, d, max_per_leaf, seed):
    """The CUDA build_lbvh's design: phase A, a prefix sum, phase B."""
    rng = np.random.default_rng(seed)
    ranges = climb_ranges(d, max_per_leaf, rng)
    return ranges, climb_nodes(d, *ranges[2:], mins, maxs, rng)


def jax_build(mins, maxs, d, max_per_leaf):
    jd_ = d.astype(np.uint32) if d.dtype == np.int64 else d
    t = jax.jit(jl.build_lbvh, static_argnums=3)(mins, maxs, jd_, max_per_leaf)
    return {f: np.asarray(getattr(t, f)) for f in TREE_FIELDS}


def plain_build(mins, maxs, d, max_per_leaf):
    t = tl.build_lbvh(*(torch.from_numpy(a) for a in (mins, maxs, d)), max_per_leaf)
    return {f: getattr(t, f).numpy() for f in TREE_FIELDS}


def assert_trees_bit_equal(got, want, what):
    for f in TREE_FIELDS:
        a, b = np.asarray(got[f]), np.asarray(want[f])
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
        assert np.array_equal(a.view(np.int32) if a.dtype == np.float32 else a,
                              b.view(np.int32) if b.dtype == np.float32 else b), (what, f)


def assert_climbs_match(mins, maxs, d, max_per_leaf):
    """Three arrival orders, each bit-equal to grace_tpu's jitted build and
    the port's plain build; phase A's ranges equal cartesian_tree_ranges'."""
    want_j = jax_build(mins, maxs, d, max_per_leaf)
    want_p = plain_build(mins, maxs, d, max_per_leaf)
    cl, cr = (t.numpy() for t in tl.cartesian_tree_ranges(torch.from_numpy(d)))
    for seed in ORDERS:
        (l, r, first, count, mark), tree = climb_build(mins, maxs, d, max_per_leaf, seed)
        assert np.array_equal(l, cl) and np.array_equal(r, cr), seed
        assert_trees_bit_equal(tree, want_j, f"order {seed} vs grace_tpu")
        assert_trees_bit_equal(tree, want_p, f"order {seed} vs the plain build")
    return want_j


# ------------------------------------------------------ keys and deltas model


def spread_bits(u, bits):
    """space_by_two_10bit / _21bit on int64 values."""
    if bits == 30:
        x = u & ((1 << 10) - 1)
        for shift, mask in ((16, 0x030000FF), (8, 0x0300F00F), (4, 0x030C30C3),
                            (2, 0x09249249)):
            x = (x | (x << shift)) & mask
        return x
    x = u & ((1 << 21) - 1)
    for shift, mask in ((32, 0x001F00000000FFFF), (16, 0x001F0000FF0000FF),
                        (8, 0x100F00F00F00F00F), (4, 0x10C30C30C30C30C3),
                        (2, 0x1249249249249249)):
        x = (x | (x << shift)) & mask
    return x


def model_keys(c, lo, hi, bits):
    """morton_keys_kernel: f32 scale and product, the saturating
    conversion (NaN -> 0), the spread bits interleaved z, y, x."""
    span = np.float32((1 << 10) - 1 if bits == 30 else (1 << 21) - 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        v = (span / (hi - lo)) * (c - lo)
    u = np.where(np.isnan(v), 0.0, np.clip(v.astype(np.float64), 0.0, 2.0 ** 32 - 1))
    u = u.astype(np.int64)
    s = [spread_bits(u[:, k], bits) for k in range(3)]
    return (s[2] << 2) | (s[1] << 1) | s[0]


def fma_f64(a, b, c):
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def model_deltas(kind, sorted_spheres, keys):
    """deltas_kernel's four forms."""
    if kind == "xor30":
        return keys[:-1] ^ keys[1:]
    if kind == "xor63":
        x = keys[:-1] ^ keys[1:]
        bitlen = np.array([int(v).bit_length() for v in x], np.int64)  # 64 - __clzll
        mant = (x >> np.maximum(bitlen - (MANTISSA_BITS + 1), 0)) & ((1 << MANTISSA_BITS) - 1)
        return (bitlen << MANTISSA_BITS) | mant
    if kind == "euclidean":
        c = sorted_spheres[:, :3]
        e = c[:-1] - c[1:]
        return fma_f64(e[:, 2], e[:, 2], fma_f64(e[:, 1], e[:, 1], e[:, 0] * e[:, 0]))
    mins = sorted_spheres[:, :3] - sorted_spheres[:, 3:]
    maxs = sorted_spheres[:, :3] + sorted_spheres[:, 3:]
    e = np.maximum(maxs[:-1], maxs[1:]) - np.minimum(mins[:-1], mins[1:])
    return fma_f64(e[:, 1], e[:, 2], fma_f64(e[:, 0], e[:, 1], e[:, 0] * e[:, 2]))


# ---------------------------------------------------------------- scenes


def spheres(rng, n):
    return np.concatenate([rng.random((n, 3)), 0.01 + 0.05 * rng.random((n, 1))],
                          axis=1).astype(np.float32)


def sorted_scene(s, kind):
    """Sorted spheres, their boxes and deltas of ``kind`` from the port's
    plain pipeline (int64 deltas for the XOR kinds)."""
    bits = 63 if kind == "xor63" else 30
    keys, ss, _ = tb.sort_by_morton(torch.from_numpy(s), bits=bits)
    if kind == "euclidean":
        d = tb.euclidean_deltas_sph(ss)
    elif kind == "surface_area":
        d = tb.surface_area_deltas_sph(ss)
    else:
        d = tb.xor_deltas_sph(keys, bits)
    ss = ss.numpy()
    return ss[:, :3] - ss[:, 3:], ss[:, :3] + ss[:, 3:], d.numpy()


# ---------------------------------------------------------------- the tests


@pytest.mark.parametrize("n", [2, 3, 17, 3000])
@pytest.mark.parametrize("mpl", [1, 16, 32])
def test_climb_matches_grace_tpu(n, mpl):
    """N x max_per_leaf on euclidean deltas (N = 2 and 3 with mpl 1: the
    leaves' parent is the root); where mpl >= N both builds refuse."""
    s = spheres(np.random.default_rng(100 * n + mpl), n)
    mins, maxs, d = sorted_scene(s, "euclidean")
    if mpl >= n:
        with pytest.raises(JGraceError):
            jl.build_lbvh(mins, maxs, d, mpl)
        with pytest.raises(TGraceError):
            tl.build_lbvh(*(torch.from_numpy(a) for a in (mins, maxs, d)), mpl)
        return
    tree = assert_climbs_match(mins, maxs, d, mpl)
    assert tree["n_leaves"] >= 2


@pytest.mark.parametrize("kind", ["euclidean", "surface_area", "xor30", "xor63"])
def test_climb_delta_kinds(kind):
    s = spheres(np.random.default_rng(7), 3000)
    s[100:140] = s[99]                        # equal keys and zero deltas
    mins, maxs, d = sorted_scene(s, kind)
    assert d.dtype == (np.float32 if kind in ("euclidean", "surface_area") else np.int64)
    assert_climbs_match(mins, maxs, d, 16)


def lattice_spheres(rng):
    """3,000 points on a regular lattice: long runs of equal euclidean deltas."""
    g = np.stack(np.meshgrid(np.arange(10), np.arange(15), np.arange(20), indexing="ij"),
                 -1).reshape(-1, 3)
    s = np.concatenate([g / 19.0, np.full((g.shape[0], 1), 0.04)], 1).astype(np.float32)
    return s[rng.permutation(s.shape[0])]


@pytest.mark.parametrize("case", ["identical_points", "equal_deltas", "lattice_runs",
                                  "duplicate_key_runs"])
def test_climb_ties(case):
    """Ties, at 3,000 primitives: every delta 0 (all points identical),
    every delta equal (a given constant), runs of equal euclidean deltas (a
    lattice), and long runs of equal keys (XOR deltas 0 between others)."""
    rng = np.random.default_rng(11)
    n = 3000
    if case == "identical_points":
        mins, maxs, d = sorted_scene(np.tile(np.array([[0.3, 0.6, 0.2, 0.05]], np.float32),
                                             (n, 1)), "euclidean")
        assert (d == 0).all()
    elif case == "equal_deltas":
        mins, maxs, _ = sorted_scene(spheres(rng, n), "euclidean")
        d = np.full(n - 1, 0.25, np.float32)
    elif case == "lattice_runs":
        mins, maxs, d = sorted_scene(lattice_spheres(rng), "euclidean")
        assert np.unique(d).size < d.size // 20
    else:
        centres = rng.random((30, 3)).astype(np.float32)
        runs = np.full(30, n // 30) + np.repeat([-40, 40], 15)   # runs of 60 and 140
        s = np.repeat(centres, runs, axis=0)
        s = np.concatenate([s, np.full((n, 1), 0.02, np.float32)], 1)
        mins, maxs, d = sorted_scene(s[rng.permutation(n)], "xor30")
        assert (d == 0).mean() > 0.9
    assert_climbs_match(mins, maxs, d, 16)


def test_sentinel_delta_gives_a_valid_tree():
    """A 63-bit XOR delta can equal the sentinel 0xFFFFFFFF (two points at
    opposite corners). grace_tpu's build then loses the second leaf and
    leaves node 0's right child pointing at node 0 (ROADMAP C19). The
    climb, whose ends are larger than any delta, gives the valid tree, and
    the port's plain build (the CPU route, build_lbvh_plain) takes the
    climb's rule and gives the same tree, field for field; float deltas
    at +inf (the float sentinel) likewise."""
    s = np.array([[0, 0, 0, 0.1], [1, 1, 1, 0.1]], np.float32)
    mins, maxs, d = sorted_scene(s, "xor63")
    assert d.tolist() == [td.U32_SENTINEL]
    want_j = jax_build(mins, maxs, d, 1)
    assert want_j["children"].tolist() == [[~0, 0]]
    plain = plain_build(mins, maxs, d, 1)
    for seed in ORDERS:
        _, tree = climb_build(mins, maxs, d, 1, seed)
        assert tree["children"].tolist() == [[~0, ~1]] and tree["root"] == 0
        assert tree["leaves"].tolist() == [[0, 1], [1, 1]] and tree["n_leaves"] == 2
        assert np.array_equal(tree["child_aabbs"][0, :, 0], mins)
        assert np.array_equal(tree["child_aabbs"][0, :, 1], maxs)
        assert_trees_bit_equal(plain, tree, "plain vs climb")
    # every field but the broken child is grace_tpu's
    for f in TREE_FIELDS[1:]:
        assert np.array_equal(plain[f], want_j[f]), f
    # deltas equal to the sentinel inside a longer sequence: leaves of 2
    # primitives whose boundary deltas tie with the ends
    rng = np.random.default_rng(19)
    for d_kind, sent in (("xor63", td.U32_SENTINEL), ("euclidean", np.inf)):
        mins, maxs, d = sorted_scene(spheres(rng, 40), d_kind)
        d = d.copy()
        d[[5, 17, 30]] = sent
        plain = plain_build(mins, maxs, d, 2)
        for seed in ORDERS:
            assert_trees_bit_equal(plain, climb_build(mins, maxs, d, 2, seed)[1],
                                   f"plain vs climb, {d_kind} sentinels")


@pytest.mark.parametrize("bits", [30, 63])
@pytest.mark.parametrize("degenerate", [False, True])
def test_key_and_delta_arithmetic(bits, degenerate):
    """The key and delta kernels' arithmetic: keys bit-equal to grace_tpu's
    and the port's plain keys (a degenerate axis, max == min, gives NaN
    and so 0 on that axis), XOR deltas bit-equal to grace_tpu's, float
    deltas bit-equal to the port's plain ones and within 2 ulp of
    grace_tpu's (C7)."""
    s = spheres(np.random.default_rng(bits + degenerate), 2000)
    if degenerate:
        s[:, 2] = 0.5
    c = s[:, :3]
    lo, hi = c.min(0), c.max(0)
    keys = model_keys(c, lo, hi, bits)
    jk = jax.jit(jb.morton_keys_sph, static_argnames="bits")(s, bits=bits)
    if bits == 63:
        jk = (np.asarray(jk[0]).astype(np.int64) << 32) | np.asarray(jk[1]).astype(np.int64)
    assert np.array_equal(keys, np.asarray(jk).astype(np.int64))
    assert np.array_equal(keys, tb.morton_keys_sph(torch.from_numpy(s), bits=bits).numpy())
    if degenerate:
        assert ((keys >> 2) & 1).sum() == 0   # the z bits are 0
    # sort as the pipeline does, then every delta form on the sorted scene
    perm = np.argsort(keys, kind="stable")
    ks, ss = keys[perm], s[perm]
    tss = torch.from_numpy(ss)
    xor = model_deltas(f"xor{bits}", ss, ks)
    if bits == 63:
        jx = jd.xor_deltas_63bit(*(np.asarray(a) for a in jax.jit(
            jb.sort_by_morton, static_argnames="bits")(s, bits=bits)[0]))
    else:
        jx = jd.xor_deltas(ks.astype(np.uint32))
    assert np.array_equal(xor, np.asarray(jx).astype(np.int64))
    assert np.array_equal(xor, tb.xor_deltas_sph(torch.from_numpy(ks), bits).numpy())
    for kind, plain, ref in (("euclidean", tb.euclidean_deltas_sph, jb.euclidean_deltas_sph),
                             ("surface_area", tb.surface_area_deltas_sph,
                              jb.surface_area_deltas_sph)):
        got = model_deltas(kind, ss, ks)
        assert np.array_equal(got.view(np.int32), plain(tss).numpy().view(np.int32)), kind
        want = np.asarray(jax.jit(ref)(ss))
        assert np.all(np.abs(got - want) <= 2 * np.spacing(np.abs(want))), kind


def test_debug_contracts(monkeypatch):
    """Under GRACE_TPU_DEBUG build_lbvh checks its output contracts (the
    leaves tile [0, N) with counts in [1, max_per_leaf], valid nodes have
    non-empty boxes) on either route's tree, and a broken tree raises."""
    monkeypatch.setenv("GRACE_TPU_DEBUG", "1")
    mins, maxs, d = sorted_scene(spheres(np.random.default_rng(4), 300), "euclidean")
    tree = tl.build_lbvh(*(torch.from_numpy(a) for a in (mins, maxs, d)), 8)
    tl._check_tree(tree)
    bad = tree.replace(leaves=tree.leaves.clone())
    bad.leaves[0, 1] = 9                       # a leaf over max_per_leaf
    with pytest.raises(TGraceError, match="leaf partition"):
        tl._check_tree(bad)
    bad = tree.replace(child_aabbs=tree.child_aabbs.flip(2))   # min and max swapped
    with pytest.raises(TGraceError, match="child AABBs"):
        tl._check_tree(bad)


# ------------------------------------------------ the block climbs (stage 1 in
# shared memory, stage 2 at device scope) and the gather kernel


def card_min(a, b):
    """torch_min on the card, elementwise on float32 arrays: the first NaN,
    else fminf (-0 on a tie of zeros, ROADMAP C20)."""
    zeros = (a == 0) & (b == 0)
    tie = np.where(np.signbit(a) | np.signbit(b), np.float32(-0.0), np.float32(0.0))
    m = np.where(zeros, tie, np.minimum(a, b))
    return np.where(np.isnan(a), a, np.where(np.isnan(b), b, m))


def card_max(a, b):
    """torch_max on the card: the first NaN, else fmaxf (+0 on a tie of zeros)."""
    zeros = (a == 0) & (b == 0)
    tie = np.where(np.signbit(a) & np.signbit(b), np.float32(-0.0), np.float32(0.0))
    m = np.where(zeros, tie, np.maximum(a, b))
    return np.where(np.isnan(a), a, np.where(np.isnan(b), b, m))


def box_union(a, b):
    """(min, max) rows of two boxes, a before b."""
    return card_min(a[0], b[0]), card_max(a[1], b[1])


def route_splits(D, kb, k, m):
    """route_splits: for the k - 1 splits between items [kb, kb + k) of a
    sequence of m items with deltas D[m - 1], True where the kernel takes
    the split inside the block (prefix and suffix max of the block's
    deltas; the ends of the sequence count as larger)."""
    v = D[kb:kb + k - 1]
    has_left, has_right = kb > 0, kb + k < m
    pre, suf = np.maximum.accumulate(v), np.maximum.accumulate(v[::-1])[::-1]
    inside = np.zeros(k - 1, bool)
    for i in range(k - 1):
        left_in = not has_left or (i > 0 and pre[i - 1] >= v[i]) or D[kb - 1] >= v[i]
        right_in = not has_right or (i + 1 < k - 1 and suf[i + 1] > v[i]) or D[kb + k - 1] > v[i]
        inside[i] = left_in and right_in
    return inside


def run_blocks(blocks, rng):
    """Step the live threads of every block one arrival at a time, the next
    one drawn by ``rng``. A block's stage 1 threads are live from the start;
    its stage 2 threads (one a queued top) once all of its stage 1 threads
    have exited (the block's barrier). Blocks interleave freely."""
    live = [(b, t) for b, blk in enumerate(blocks) for t in range(len(blk["stage1"]))]
    left = [len(blk["stage1"]) for blk in blocks]
    while live:
        j = int(rng.integers(len(live)))
        b, t = live[j]
        blk = blocks[b]
        stage = "stage1" if t >= 0 else "stage2"
        if blk["step"](blk[stage][t if t >= 0 else ~t], stage):
            continue
        live[j] = live[-1]
        live.pop()
        if stage == "stage1":
            left[b] -= 1
            if left[b] == 0:
                blk["stage2"] = [dict(lo=lo, hi=hi) for lo, hi in blk["tops"]]
                live += [(b, ~q) for q in range(len(blk["stage2"]))]


def block_ranges(d, max_per_leaf, block, rng):
    """Phase A (ranges_kernel): blocks of ``block`` primitives, each primitive
    climbing in its block's stage 1 through the splits that lie inside it
    (a shared word a split: the first arrival leaves its end there, the
    second takes it), the queued tops in stage 2 through the rest: one
    exchange of a word that carries the child's end and boundary delta
    (None: no arrival yet). Returns (l, r, first, count, mark, device
    steps)."""
    n = d.shape[0] + 1
    l = np.full(n - 1, -1, np.int32)
    r = np.full(n - 1, -1, np.int32)
    words = [None] * (n - 1)
    first = np.full(n, -7, np.int32)
    count = np.full(n, -7, np.int32)
    mark = np.zeros(n, np.int32)
    device_steps = [0]

    def make_block(kb):
        k = min(block, n - kb)
        blk = dict(kb=kb, k=k, inside=route_splits(d, kb, k, n), flag=np.zeros(k, np.int32),
                   lsh=np.full(k, -1), rsh=np.full(k, -1), tops=[],
                   stage1=[dict(lo=i, hi=i) for i in range(kb, kb + k)], stage2=[])

        def step(st, stage):
            lo, hi = st["lo"], st["hi"]
            p, right = parent_of(d, lo, hi, n - 1, lo - 1, hi)
            i = p - kb
            if stage == "stage1":
                if i < 0 or i >= k - 1 or not blk["inside"][i]:
                    blk["tops"].append((lo, hi))
                    return False
                ends, fl = (blk["rsh"], blk["lsh"]) if right else (blk["lsh"], blk["rsh"])
                (r if right else l)[p] = hi if right else lo
                ends[i] = hi if right else lo
                blk["flag"][i] += 1
                if blk["flag"][i] == 1:
                    return False
                other = fl[i]
            else:
                device_steps[0] += 1
                (r if right else l)[p] = hi if right else lo
                mine = (hi, d[hi] if hi < n - 1 else None) if right else (
                    lo, d[lo - 1] if lo > 0 else None)
                old, words[p] = words[p], mine
                if old is None:
                    return False
                other, delta = old
                # the sibling's boundary delta is the node's new one
                assert delta is None or delta == d[other - 1 if right else other]
            lo, hi = (int(other), hi) if right else (lo, int(other))
            s_left, s_right = p - lo + 1, hi - p
            left_small, right_small = s_left <= max_per_leaf, s_right <= max_per_leaf
            write = left_small != right_small or s_left + s_right > max_per_leaf
            if left_small and write:
                first[lo], count[lo], mark[lo] = lo, s_left, 1
            if right_small and write:
                first[hi], count[hi], mark[hi] = p + 1, s_right, 1
            st["lo"], st["hi"] = lo, hi
            return not (lo == 0 and hi == n - 1)

        blk["step"] = step
        return blk

    run_blocks([make_block(kb) for kb in range(0, n, block)], rng)
    return l, r, first, count, mark, device_steps[0]


def group_size(max_per_leaf):
    """The lanes a leaf's box takes: a quarter of max_per_leaf rounded up to
    a power of two, at most 8."""
    g = 1
    while g < 8 and 4 * g < max_per_leaf:
        g <<= 1
    return g


def warp_box(mins, maxs, a, c, group=32):
    """A group of ``group`` lanes' union of primitives [a, a + c): lane L
    takes a contiguous run, then a shuffle tree over lane offsets 1, 2, ...,
    group / 2, the lower lane's value always the left operand; identities
    +inf / -inf."""
    run = (c + group - 1) // group
    lane = np.arange(group)
    lo = np.full((group, 3), np.inf, np.float32)
    hi = np.full((group, 3), -np.inf, np.float32)
    for q in range(run):                      # each lane's run, in order
        idx = lane * run + q
        ok = (idx < c)[:, None]
        rows = a + np.minimum(idx, c - 1)
        lo = card_min(lo, np.where(ok, mins[rows], np.float32(np.inf)))
        hi = card_max(hi, np.where(ok, maxs[rows], np.float32(-np.inf)))
    for off in (1, 2, 4, 8, 16)[:group.bit_length() - 1]:
        upper = ((lane & off) != 0)[:, None]
        plo, phi = lo[lane ^ off], hi[lane ^ off]
        lo = card_min(np.where(upper, plo, lo), np.where(upper, lo, plo))
        hi = card_max(np.where(upper, phi, hi), np.where(upper, hi, phi))
    assert (lo.view(np.int32) == lo[0].view(np.int32)).all()
    return lo[0], hi[0]


def serial_box(mins, maxs, a, c):
    """The earlier kernel's serial union of primitives [a, a + c)."""
    box = (mins[a].copy(), maxs[a].copy())
    for q in range(a + 1, a + c):
        box = box_union(box, (mins[q], maxs[q]))
    return box


def block_nodes(d, first, count, mark, mins, maxs, block, rng, max_per_leaf=32):
    """Phase B (nodes_kernel): blocks of ``block`` primitive slots, each
    compacting its marked slots into its consecutive leaves, a group of
    lanes a leaf's box into its parent's slot, then stage 1 (the splits
    inside the block) and stage 2 (the queued tops at device scope, each
    ends row carrying the children's ends and boundary deltas), a thread a
    leaf."""
    n = mark.shape[0]
    scan = np.cumsum(mark).astype(np.int32)
    nl = int(scan[-1])
    last = nl - 1
    children = np.full((n - 1, 2), -7, np.int32)
    boxes = np.full((n - 1, 2, 2, 3), np.nan, np.float32)
    leaves = np.full((n, 2), -7, np.int32)
    ends = [[None, None] for _ in range(n - 1)]
    flags = np.zeros(n - 1, np.int32)
    root = []
    ld = np.array([d[first[s] + count[s] - 1] for s in np.flatnonzero(mark)[:last]], d.dtype)

    def write_child(p, side, entry, box):
        children[p, side] = entry
        boxes[p, side, 0], boxes[p, side, 1] = box

    def make_block(base):
        end = min(base + block, n)
        kb = int(scan[base - 1]) if base else 0
        k = int(scan[end - 1]) - kb
        for s in range(base, end):                       # padding
            if s >= nl:
                leaves[s] = 0
            if nl - 1 <= s < n - 1:
                children[s] = 0
                boxes[s, :, 0], boxes[s, :, 1] = np.inf, -np.inf
        slots = [s for s in range(base, end) if mark[s]]
        fsh = [int(first[s]) for s in slots]
        csh = [int(count[s]) for s in slots]
        assert [int(scan[s]) - 1 - kb for s in slots] == list(range(k))
        blk = dict(kb=kb, k=k, flag=np.zeros(max(k, 1), np.int32), lsh=np.full(max(k, 1), -1),
                   rsh=np.full(max(k, 1), -1), tops=[], stage2=[], stage1=[])
        if k == 0:
            return blk
        blk["inside"] = route_splits(ld, kb, k, nl)
        for i in range(k):                               # rows and the leaves' boxes
            leaves[kb + i] = fsh[i], csh[i]
            p, right = parent_of(ld, kb + i, kb + i, last, kb + i - 1, kb + i)
            write_child(p, int(right), ~(kb + i),
                        warp_box(mins, maxs, fsh[i], csh[i], group_size(max_per_leaf)))
        blk["stage1"] = [dict(lo=kb + i, hi=kb + i) for i in range(k)]

        def step(st, stage):
            lo, hi = st["lo"], st["hi"]
            p, right = parent_of(ld, lo, hi, last, lo - 1, hi)
            i = p - kb
            if stage == "stage1":
                if i < 0 or i >= k - 1 or not blk["inside"][i]:
                    blk["tops"].append((lo, hi))
                    return False
                (blk["rsh"] if right else blk["lsh"])[i] = hi if right else lo
                blk["flag"][i] += 1
                if blk["flag"][i] == 1:
                    return False
                lo, hi = (int(blk["lsh"][i]), hi) if right else (lo, int(blk["rsh"][i]))
            else:
                ends[p][int(right)] = (hi, ld[hi] if hi < last else None) if right else (
                    lo, ld[lo - 1] if lo > 0 else None)
                flags[p] += 1
                if flags[p] == 1:
                    return False
                other, delta = ends[p][1 - int(right)]
                assert delta is None or delta == ld[other - 1 if right else other]
                lo, hi = (other, hi) if right else (lo, other)
            box = box_union((boxes[p, 0, 0], boxes[p, 0, 1]), (boxes[p, 1, 0], boxes[p, 1, 1]))
            if lo == 0 and hi == last:
                root.append(p)
                return False
            p2, right2 = parent_of(ld, lo, hi, last, lo - 1, hi)
            write_child(p2, int(right2), p, box)
            st["lo"], st["hi"] = lo, hi
            return True

        blk["step"] = step
        return blk

    run_blocks([make_block(base) for base in range(0, n, block)], rng)
    assert len(root) == 1 and (flags[: nl - 1] <= 2).all()
    return dict(children=children, child_aabbs=boxes, leaves=leaves,
                root=np.int32(root[0]), n_nodes=np.int32(nl - 1), n_leaves=np.int32(nl))


BLOCKS = (32, 64, 256, 100)   # 100 divides none of the sizes below


def assert_block_climbs_match(mins, maxs, d, max_per_leaf, blocks=BLOCKS):
    """At each block size, three arrival orders: phase A's ranges equal
    cartesian_tree_ranges', the route of every split equals whether its
    range lies in its block, and the tree is bit-equal to the port's plain
    build and grace_tpu's jitted build."""
    want_j = jax_build(mins, maxs, d, max_per_leaf)
    want_p = plain_build(mins, maxs, d, max_per_leaf)
    cl, cr = (t.numpy() for t in tl.cartesian_tree_ranges(torch.from_numpy(d)))
    n = d.shape[0] + 1
    for block in blocks:
        inside = np.concatenate([route_splits(d, kb, min(block, n - kb), n).tolist() + [False]
                                 for kb in range(0, n, block)])[: n - 1]
        assert np.array_equal(inside, (cl // block == cr // block)), block
        for seed in ORDERS:
            rng = np.random.default_rng(seed)
            l, r, first, count, mark, _ = block_ranges(d, max_per_leaf, block, rng)
            assert np.array_equal(l, cl) and np.array_equal(r, cr), (block, seed)
            tree = block_nodes(d, first, count, mark, mins, maxs, block, rng, max_per_leaf)
            assert_trees_bit_equal(tree, want_p, f"block {block} order {seed} vs the plain build")
            assert_trees_bit_equal(tree, want_j, f"block {block} order {seed} vs grace_tpu")


@pytest.mark.parametrize("case", ["random euclidean", "mpl 1", "xor30 runs of equal keys",
                                  "surface area, 63-bit keys", "lattice ties", "N = 2"])
def test_block_climbs_match_grace_tpu(case):
    """The two-stage climbs at block sizes 32, 64, 256 and 100 (no divisor
    of N): random spheres (mpl 8), max_per_leaf 1, long runs of zero XOR
    deltas, surface-area deltas of 63-bit keys, a lattice's tied deltas and
    N = 2."""
    rng = np.random.default_rng(23)
    if case == "random euclidean":
        args = (*sorted_scene(spheres(rng, 1500), "euclidean"), 8)
    elif case == "mpl 1":
        args = (*sorted_scene(spheres(rng, 700), "euclidean"), 1)
    elif case == "xor30 runs of equal keys":
        s = np.concatenate([np.repeat(rng.random((12, 3)), 60, axis=0),
                            np.full((720, 1), 0.02)], 1).astype(np.float32)
        args = (*sorted_scene(s[rng.permutation(720)], "xor30"), 16)
    elif case == "surface area, 63-bit keys":
        keys, ss, _ = tb.sort_by_morton(torch.from_numpy(spheres(rng, 1100)), bits=63)
        d, ss = tb.surface_area_deltas_sph(ss).numpy(), ss.numpy()
        args = (ss[:, :3] - ss[:, 3:], ss[:, :3] + ss[:, 3:], d, 4)
    elif case == "lattice ties":
        args = (*sorted_scene(lattice_spheres(rng)[:1200], "euclidean"), 16)
    else:
        args = (*sorted_scene(spheres(rng, 2), "euclidean"), 1)
    assert_block_climbs_match(*args)


def test_block_routes_reach_device_scope():
    """Every route is taken: at block 32 on 3,000 random spheres most
    splits complete inside their block, some only at device scope, and the
    device steps shrink as the block grows (1024: the kernel's default)."""
    mins, maxs, d = sorted_scene(spheres(np.random.default_rng(5), 3000), "euclidean")
    cl, cr = (t.numpy() for t in tl.cartesian_tree_ranges(torch.from_numpy(d)))
    steps = {}
    for block in (32, 256, 1024):
        l, r, *_, steps[block] = block_ranges(d, 16, block, np.random.default_rng(0))
        assert np.array_equal(l, cl) and np.array_equal(r, cr)
    assert 0 < steps[1024] < steps[256] < steps[32] < d.shape[0]


def test_warp_box_keeps_the_serial_bits():
    """The lane group's ordered union of a leaf's boxes is the serial loop's,
    bit for bit, on rows holding NaNs of several payloads and signs and
    signed zeros, for leaves of 1 to 70 primitives in groups of 1 to 32
    lanes (past the group's size, a lane a run)."""
    rng = np.random.default_rng(31)
    n = 400
    mins = np.abs(rng.standard_normal((n, 3))).astype(np.float32)
    maxs = -mins
    pick = rng.random((n, 3))
    mins[pick < 0.15], maxs[pick < 0.15] = np.float32(0.0), np.float32(0.0)
    mins[(pick >= 0.15) & (pick < 0.3)] = np.float32(-0.0)
    maxs[(pick >= 0.15) & (pick < 0.3)] = np.float32(-0.0)
    payloads = np.array([0x7FC00001, 0xFFC00002, 0x7F800003, 0xFFA00004], np.uint32)
    nan_at = rng.random((n, 3)) < 0.02
    mins[nan_at] = payloads[rng.integers(4, size=int(nan_at.sum()))].view(np.float32)
    nan_at = rng.random((n, 3)) < 0.02
    maxs[nan_at] = payloads[rng.integers(4, size=int(nan_at.sum()))].view(np.float32)
    nans = zero_ties = 0
    for c in list(range(1, 40)) + [63, 64, 65, 70]:
        for a in rng.integers(0, n - c, size=4):
            want = serial_box(mins, maxs, a, c)
            for group in (1, 4, 8, 32):
                for g, w in zip(warp_box(mins, maxs, a, c, group), want):
                    assert np.array_equal(g.view(np.int32), w.view(np.int32)), (a, c, group)
            nans += int(np.isnan(want[0]).sum() + np.isnan(want[1]).sum())
            zero_ties += int((want[0] == 0).sum())
    assert nans > 20 and zero_ties > 20


def test_block_nodes_keep_nan_and_zero_bits():
    """Phase B's boxes with NaN payloads and signed zeros in the rows: the
    two-stage climb's child boxes are the earlier serial design's (climb_nodes
    with the card's min and max), bit for bit, at blocks 32 and 100."""
    rng = np.random.default_rng(37)
    mins, maxs, d = sorted_scene(spheres(rng, 900), "euclidean")
    mins, maxs = mins.copy(), maxs.copy()
    mins[rng.random(mins.shape) < 0.1] = np.float32(-0.0)
    maxs[rng.random(maxs.shape) < 0.1] = np.float32(0.0)
    mins[rng.random(mins.shape) < 0.01] = np.uint32(0x7FC0BEEF).view(np.float32)
    maxs[rng.random(maxs.shape) < 0.01] = np.uint32(0xFFC0F00D).view(np.float32)
    l, r, first, count, mark, _ = block_ranges(d, 8, 100, np.random.default_rng(1))
    scan = np.cumsum(mark)
    want = {}
    for s in np.flatnonzero(mark):
        want[int(scan[s]) - 1] = serial_box(mins, maxs, int(first[s]), int(count[s]))
    for block in (32, 100):
        tree = block_nodes(d, first, count, mark, mins, maxs, block, np.random.default_rng(2), 8)
        # the box of each node: the serial union over its leaves, left to right
        children, boxes = tree["children"], tree["child_aabbs"]

        def node_box(e):
            if e < 0:
                return want[~e]
            return box_union((boxes[e, 0, 0], boxes[e, 0, 1]), (boxes[e, 1, 0], boxes[e, 1, 1]))

        def serial_of(e):
            return want[~e] if e < 0 else serial_box(*serial_leaves(e))

        def leaves_under(e):
            return [~e] if e < 0 else leaves_under(children[e, 0]) + leaves_under(children[e, 1])

        def serial_leaves(e):
            ks = leaves_under(e)
            rows = [want[k] for k in ks]
            return (np.stack([b[0] for b in rows]), np.stack([b[1] for b in rows]), 0, len(rows))

        for p in range(int(tree["n_nodes"])):
            for side in (0, 1):
                e = int(children[p, side])
                got = (boxes[p, side, 0], boxes[p, side, 1])
                for g, w in zip(got, serial_of(e)):
                    assert np.array_equal(g.view(np.int32), w.view(np.int32)), (block, p, side)
                assert all(np.array_equal(g.view(np.int32), w.view(np.int32))
                           for g, w in zip(got, node_box(e)))


def model_gather(prims, perm, prim):
    """gather_deltas_kernel's rows, permutation and boxes: a sphere's c - r
    and c + r, a triangle's vertex min and max in torch.amin / amax's order
    on the card (a NaN sticks, else the strictly smaller / larger, else the
    later operand)."""
    rows = prims[perm]
    if prim == "sphere":
        c, rad = rows[:, :3], rows[:, 3:]
        return rows, perm.astype(np.int32), c - rad, c + rad

    def fold(op, v):
        acc = v[:, 0]
        for j in (1, 2):
            acc = np.where(np.isnan(acc) | op(acc, v[:, j]), acc, v[:, j])
        return acc

    return (rows, perm.astype(np.int32), fold(np.less, rows), fold(np.greater, rows))


@pytest.mark.parametrize("kind", ["euclidean", "surface_area", "xor30", "xor63"])
def test_gather_deltas_arithmetic(kind):
    """E2 in one pass: the sorted rows, permutation and boxes bit-equal to
    grace_tpu's sort_by_morton and sphere_aabb, the XOR deltas bit-equal to
    grace_tpu's, the float deltas (from the gathered centroids or boxes, the
    next row's taken from the next lane) bit-equal to the port's plain
    deltas and within 2 ulp of grace_tpu's (C7); triangles' rows and boxes
    bit-equal to grace_tpu's triangle_aabb."""
    import grace_tpu.ops.primitives as jp

    bits = 63 if kind == "xor63" else 30
    s = spheres(np.random.default_rng(41), 1537)   # a ragged last warp
    s[200:260] = s[199]                            # tied keys: the stable order
    jk, js, jperm = jax.jit(jb.sort_by_morton, static_argnames="bits")(s, bits=bits)
    perm = np.asarray(jperm).astype(np.int64)
    keys = model_keys(s[:, :3], s[:, :3].min(0), s[:, :3].max(0), bits)
    assert np.array_equal(perm, np.argsort(keys, kind="stable"))
    rows, perm32, lo, hi = model_gather(s, perm, "sphere")
    assert np.array_equal(rows.view(np.int32), np.asarray(js).view(np.int32))
    assert np.array_equal(perm32, np.asarray(jperm))
    jlo, jhi = jax.jit(jp.sphere_aabb)(np.asarray(js))
    assert np.array_equal(lo.view(np.int32), np.asarray(jlo).view(np.int32))
    assert np.array_equal(hi.view(np.int32), np.asarray(jhi).view(np.int32))
    ks = keys[perm]
    got = model_deltas(kind, rows, ks)
    if kind.startswith("xor"):
        jx = (jd.xor_deltas_63bit(*(np.asarray(a) for a in jk)) if bits == 63
              else jd.xor_deltas(ks.astype(np.uint32)))
        assert np.array_equal(got, np.asarray(jx).astype(np.int64))
    else:
        tss = torch.from_numpy(rows)
        plain = (tb.euclidean_deltas_sph if kind == "euclidean" else tb.surface_area_deltas_sph)
        assert np.array_equal(got.view(np.int32), plain(tss).numpy().view(np.int32))
        ref = jb.euclidean_deltas_sph if kind == "euclidean" else jb.surface_area_deltas_sph
        want = np.asarray(jax.jit(ref)(rows))
        assert np.all(np.abs(got - want) <= 2 * np.spacing(np.abs(want)))
    tris = np.random.default_rng(43).random((600, 3, 3)).astype(np.float32)
    tperm = np.random.default_rng(44).permutation(600)
    trows, _, tlo, thi = model_gather(tris, tperm, "triangle")
    jlo, jhi = jax.jit(jp.triangle_aabb)(trows)
    assert np.array_equal(tlo.view(np.int32), np.asarray(jlo).view(np.int32))
    assert np.array_equal(thi.view(np.int32), np.asarray(jhi).view(np.int32))
