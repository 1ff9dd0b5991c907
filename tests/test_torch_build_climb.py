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
