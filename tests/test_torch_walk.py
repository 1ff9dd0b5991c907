"""The generic engine's walk for the stock functors (``trace.walk``) on the
CPU.

``csrc/bvh_walk.cu`` walks a warp's 32 rays as one packet (one stack of
node and lane-mask entries), and walks a ray to its end in one thread
where a warp restarts; the plain walk (``engine.trace``) steps every ray
together. Two walks written here in numpy model the kernel: the per-ray
walk, in the kernel's order and with its stack clamped and dropping as
the kernel's, and the packet walk (ballots of the lanes' box hits, a
warp that would overflow a lane's stack restarting on the per-ray walk,
closest-hit pruning and the any-hit exit). Both are held to the lockstep
walk's hit counts, record positions, sums and triangle ids and t, per
lane, at stacks of 64 and 4, on a ragged last warp, on warps of
diverging rays and on rays that lie on box planes with zero direction
components. That pins the claims the kernel rests on: each ray's stack
evolves from its own data alone, and the entries that carry a lane's bit
are that lane's own stack, so the order of leaves is the same. The
facades reach the plain walk on CPU tensors (``engine.trace.calls``
moves, the kernels' launch counts do not) and still match ``grace_tpu``
at the existing tolerances.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grace_tpu.models.triangle as jt
import grace_tpu.trace.render as jr
import grace_tpu.trace.sph as jsph
from grace_tpu.build.sph import build_sph_tree as j_build
from grace_tpu.core.types import Rays as JRays
from grace_tpu.sph.kernel_integrals import DENSE_KERNEL_INTEGRAL_TABLE
import grace_tpu_torch.models.triangle as tt
import grace_tpu_torch.trace.render as tr
import grace_tpu_torch.trace.sph as tsph
from grace_tpu_torch import convert
from grace_tpu_torch.core.types import Rays
from grace_tpu_torch.trace import engine, walk
from grace_tpu_torch.trace import functors as TF
from tests.helper.torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

F32, F64 = np.float32, np.float64


def _fma(a, b, c):
    """vecmath.fma: the f64 product plus sum, rounded once to f32."""
    return (np.asarray(a, F64) * np.asarray(b, F64) + np.asarray(c, F64)).astype(F32)


def _dot3(a, b):
    return _fma(a[..., 2], b[..., 2], _fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def _boxes_hit(o, inv, ln, boxes):
    """The slab test of one ray against boxes f32[k, 2, 3] (NaN propagates
    through np.minimum / np.maximum, as through torch's)."""
    t0 = (boxes[:, 0] - o) * inv
    t1 = (boxes[:, 1] - o) * inv
    tn, tf = np.minimum(t0, t1), np.maximum(t0, t1)
    tmin = np.maximum(np.maximum(tn[:, 0], tn[:, 1]), np.maximum(tn[:, 2], F32(0)))
    tmax = np.minimum(np.minimum(tf[:, 0], tf[:, 1]), np.minimum(tf[:, 2], ln))
    return tmax >= tmin


def _spheres_hit(o, d, ln, s):
    p = s[:, :3] - o
    dot = _dot3(p, d[None])
    b = _fma(-dot[:, None], d[None], p)
    b2 = _dot3(b, b)
    return (b2 < s[:, 3] * s[:, 3]) & (dot >= 0) & (dot < ln), dot


def _cross(a, b):
    return np.stack([_fma(a[..., 1], b[..., 2], -(a[..., 2] * b[..., 1])),
                     _fma(a[..., 2], b[..., 0], -(a[..., 0] * b[..., 2])),
                     _fma(a[..., 0], b[..., 1], -(a[..., 1] * b[..., 0]))], axis=-1)


def _triangles_hit(o, d, ln, tri):
    eps = F32(1e-7)
    v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    p = _cross(np.broadcast_to(d, e2.shape), e2)
    det = _dot3(e1, p)
    inv_det = F32(1) / np.where(np.abs(det) > eps, det, eps)
    s = o - v0
    u = _dot3(s, p) * inv_det
    q = _cross(s, e1)
    v = _dot3(np.broadcast_to(d, q.shape), q) * inv_det
    t = _dot3(e2, q) * inv_det
    hit = ((det > eps) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > eps)
           & (t < ln))
    return hit, t


def per_ray_walk(o, d, ln, tree, n_prims, stack_size, leaf_fn):
    """One ray's walk in bvh_walk.cu's order: pop the top entry (read at
    the column clamped to stack_size - 1); at a node overwrite it with the
    left child if hit, else the right, and push the right on top if both
    are (pushes past the stack dropped); at a leaf call ``leaf_fn`` with
    its clamped primitive ids in order. Returns the kernel's flag: 0, 1
    where the stack overflowed, 2 where the walk was cut at the kernel's
    step bound (an overflowed walk can repeat one entry forever)."""
    children, aabbs, leaves, root, mpl = tree
    with np.errstate(divide="ignore"):
        inv = F32(1) / d
    stack = [0] * stack_size
    stack[0], sp, overflow = root, 1, 0
    for _ in range(4 * (len(children) + len(leaves)) + 64):
        if sp == 0:
            return overflow
        top_col = sp - 1
        top = stack[min(top_col, stack_size - 1)]
        if top >= 0:
            node = min(top, len(children) - 1)
            with np.errstate(invalid="ignore"):
                hit_l, hit_r = _boxes_hit(o, inv, ln, aabbs[node])
            n_push = int(hit_l) + int(hit_r)
            if n_push >= 1 and top_col < stack_size:
                stack[top_col] = children[node, 0] if hit_l else children[node, 1]
            if n_push == 2 and top_col + 1 < stack_size:
                stack[top_col + 1] = children[node, 1]
            sp += n_push - 1
            overflow |= int(sp > stack_size)
        else:
            leaf = min(max(~top, 0), len(leaves) - 1)
            first, count = leaves[leaf]
            leaf_fn(np.clip(first + np.arange(min(max(count, 0), mpl)), 0, n_prims - 1))
            sp -= 1
    return 2


def _tree_np(tree_t):
    return (tree_t.children.numpy(), tree_t.child_aabbs.numpy(), tree_t.leaves.numpy(),
            int(tree_t.root), tree_t.max_per_leaf)


def _to_torch_tree(tree):
    return convert.tree_from_numpy(
        *(np.asarray(x) for x in (tree.children, tree.child_aabbs, tree.leaves, tree.root,
                                  tree.n_nodes, tree.n_leaves)),
        tree.max_per_leaf, device="cpu")


def _plane_rays(rng, aabbs, n):
    """``n`` axis-aligned rays (two zero direction components, signed)
    whose origins lie on a box plane on one of the zero axes."""
    o = np.empty((n, 3), F32)
    d = np.zeros((n, 3), F32)
    for i in range(n):
        axis = i % 3
        d[i, axis] = 1.0 if i % 2 else -1.0
        box = aabbs[rng.integers(len(aabbs)), rng.integers(2)]
        o[i] = box[0] - 0.2 * d[i]
        plane = (axis + 1 + i % 2) % 3
        o[i, plane] = box[rng.integers(2), plane]
        d[i, (axis + 1) % 3] = -0.0 if i % 4 == 0 else 0.0
    return o, d, np.full(n, 1.5, F32)


@pytest.fixture(scope="module")
def sph_scene():
    """1,500 random spheres at 8 a leaf, 240 random rays and 60 rays on box
    planes with zero direction components."""
    rng = np.random.default_rng(31)
    n = 1500
    s = np.concatenate([rng.random((n, 3)), 0.01 + 0.04 * rng.random((n, 1))], 1).astype(F32)
    ss, tree, _ = jax.jit(j_build, static_argnums=1)(s, 8)
    tree_t = _to_torch_tree(tree)
    o = (0.5 + 0.6 * (rng.random((240, 3)) - 0.5)).astype(F32)
    d = rng.standard_normal((240, 3)).astype(F32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    po, pd, pl = _plane_rays(rng, tree_t.child_aabbs.numpy()[:int(tree.n_nodes)], 60)
    o, d = np.concatenate([o, po]), np.concatenate([d, pd])
    ln = np.concatenate([np.full(240, 0.8, F32), pl])
    return (ss, tree, JRays.from_arrays(o, d, ln)), (
        convert.spheres_from_numpy(np.asarray(ss), device="cpu"), tree_t,
        Rays.from_arrays(o, d, ln, device="cpu"))


def _per_ray_sph(rays, ss, tree_t, stack_size, cursors=None):
    """Counts, flags and (prim, ray, distance) records at the cursors, by
    the per-ray walk."""
    o, d, ln = (t.numpy() for t in (rays.origins, rays.directions, rays.lengths))
    s = ss.numpy()
    counts, overflow, records = np.zeros(len(o), np.int32), [], {}
    for r in range(len(o)):
        cursor = [0 if cursors is None else int(cursors[r])]

        def leaf(ids):
            hit, dist = _spheres_hit(o[r], d[r], ln[r], s[ids])
            for p, dp in zip(ids[hit], dist[hit]):
                records[cursor[0]] = (p, r, dp)
                cursor[0] += 1
            counts[r] += int(hit.sum())

        overflow.append(per_ray_walk(o[r], d[r], ln[r], _tree_np(tree_t), len(s), stack_size,
                                     leaf))
    return counts, np.array(overflow), records


@pytest.mark.parametrize("stack_size", [64, 4])
def test_per_ray_order_equals_lockstep_sph(sph_scene, stack_size):
    """Hit counts and every record's position (prim, ray, distance) of the
    per-ray walk equal the lockstep walk's, bit for bit; at a stack of 4
    the walk overflows and both truncate alike (on the rays whose walk
    ends: the others would hold the lockstep loop forever)."""
    _, (ss, tree_t, rays) = sph_scene
    counts, flags, _ = _per_ray_sph(rays, ss, tree_t, stack_size)
    assert (flags == 1).any() == (stack_size == 4) and (flags != 2).sum() > 200
    rays, counts = rays[torch.from_numpy(flags != 2)], counts[flags != 2]
    got = tsph.trace_hitcounts_sph(rays, ss, tree_t, stack_size=stack_size)
    assert np.array_equal(got.numpy(), counts) and counts.sum() > 0
    offsets = torch.from_numpy((np.cumsum(counts) - counts).astype(np.int32))
    _, _, records = _per_ray_sph(rays, ss, tree_t, stack_size, offsets)
    cap = int(counts.sum())
    res = tsph.trace_sph(rays, ss, tree_t, capacity=cap, stack_size=stack_size)
    hits = tr.find_hits(rays, ss, tree_t, cap, stack_size=stack_size)
    want = np.array([records[i] for i in range(cap)], dtype=object)
    assert np.array_equal(res.indices.numpy(), want[:, 0].astype(np.int32))
    assert np.array_equal(hits.prim.numpy(), want[:, 0].astype(np.int32))
    assert np.array_equal(hits.ray.numpy(), want[:, 1].astype(np.int32))
    assert np.array_equal(res.distances.numpy(), want[:, 2].astype(F32))


def test_plane_rays_meet_nan_slabs(sph_scene):
    """The box-plane rays make (min - o) * inf NaN in the slab test, and
    some still hit spheres, so the NaN rule is exercised both ways."""
    _, (ss, tree_t, rays) = sph_scene
    plane = rays[240:]
    o, d = plane.origins.numpy(), plane.directions.numpy()
    aabbs = tree_t.child_aabbs.numpy()
    with np.errstate(divide="ignore", invalid="ignore"):
        nan = [np.isnan((aabbs[..., k] - o[r, k]) * (F32(1) / d[r, k])).any()
               for r in range(len(o)) for k in range(3)]
    assert any(nan)
    assert int(tsph.trace_hitcounts_sph(plane, ss, tree_t).sum()) > 0


@pytest.fixture(scope="module")
def tri_scene():
    """300 random triangles at 4 a leaf and 200 rays (40 on box planes)."""
    rng = np.random.default_rng(32)
    c = rng.random((300, 1, 3)).astype(F32)
    tris = (c + 0.15 * (rng.random((300, 3, 3)) - 0.5)).astype(F32)
    st, tree, _ = jt.build_triangle_tree(jnp.asarray(tris), 4)
    tree_t = _to_torch_tree(tree)
    o = (np.array([0.5, 0.5, -1.0]) + 0.3 * (rng.random((160, 3)) - 0.5)).astype(F32)
    d = (np.array([0.0, 0.0, 1.0]) + 0.4 * (rng.random((160, 3)) - 0.5)).astype(F32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    po, pd, pl = _plane_rays(rng, tree_t.child_aabbs.numpy()[:int(tree.n_nodes)], 40)
    o, d = np.concatenate([o, po]), np.concatenate([d, pd])
    ln = np.concatenate([np.full(160, 3.0, F32), pl])
    return (st, tree, JRays.from_arrays(o, d, ln)), (
        torch.tensor(np.asarray(st)), tree_t, Rays.from_arrays(o, d, ln, device="cpu"))


@pytest.mark.parametrize("stack_size", [64, 4])
def test_per_ray_order_equals_lockstep_triangles(tri_scene, stack_size):
    """Closest ids and t (a strict < in walk order) and occlusion of the
    per-ray walk equal the lockstep walk's, bit for bit."""
    _, (st, tree_t, rays) = tri_scene
    o, d, ln = (t.numpy() for t in (rays.origins, rays.directions, rays.lengths))
    tris = st.numpy()
    t_want = np.full(len(o), np.inf, F32)
    id_want = np.full(len(o), -1, np.int32)
    flags = np.zeros(len(o), np.int32)
    for r in range(len(o)):
        def leaf(ids):
            hit, t = _triangles_hit(o[r], d[r], ln[r], tris[ids])
            for p, tp in zip(ids[hit], t[hit]):
                if tp < t_want[r]:
                    t_want[r], id_want[r] = tp, p

        flags[r] = per_ray_walk(o[r], d[r], ln[r], _tree_np(tree_t), len(tris), stack_size,
                                leaf)
    assert (flags == 1).any() == (stack_size == 4) and (flags != 2).sum() > 150
    keep = flags != 2
    rays, t_want, id_want = rays[torch.from_numpy(keep)], t_want[keep], id_want[keep]
    got = tt.trace_closest_hit(rays, st, tree_t, stack_size=stack_size)
    assert np.array_equal(got.tri.numpy(), id_want) and (id_want >= 0).sum() > 20
    assert np.array_equal(got.t.numpy(), t_want)
    occ = tt.trace_any_hit(rays, st, tree_t, stack_size=stack_size)
    assert np.array_equal(occ.numpy(), id_want >= 0)


_SRC = open(os.path.join(os.path.dirname(walk.__file__), os.pardir, "csrc",
                         "bvh_walk.cu")).read()


def _kernel_float(name):
    return F32(float.fromhex(re.search(rf"constexpr float {name} = (0x[0-9a-fp+-]+)f;",
                                       _SRC).group(1)))


PRUNE_SCALE, PRUNE_SLACK = _kernel_float("kPruneScale"), _kernel_float("kPruneSlack")


def _beyond(o, inv, box, t_best):
    """bvh_walk.cu's pruning test in f32: box f32[2, 3] widened by delta on
    every side lies past t_best along the ray."""
    lo, hi = box[0], box[1]
    ext = max(max(hi[0] - lo[0], hi[1] - lo[1]), hi[2] - lo[2])
    delta = PRUNE_SCALE * ((t_best + ext) + np.abs(o).max())
    entry = F32(-np.inf)
    with np.errstate(invalid="ignore", over="ignore"):
        for k in range(3):
            plane = lo[k] - delta if inv[k] >= 0 else hi[k] + delta
            x = (plane - o[k]) * inv[k]
            entry = F32(np.nan) if np.isnan(entry) or np.isnan(x) else max(entry, x)
    return bool(entry > t_best * (F32(1) + PRUNE_SLACK))


def packet_walk(o, d, ln, tree, stack_size, leaf_fn, prune=None):
    """bvh_walk.cu's packet walk of one warp's k <= 32 rays (o, d f32[k, 3],
    ln f32[k]): one stack of (node, lane mask) entries with the top in
    hand; at a node the lanes of the mask test both child boxes (a lane
    leaves a hit child where ``prune(lane, box)``), L and R the masks of
    their hits: both non-zero, (left, L) goes below (right, R) on top; one,
    that child takes the slot; none, the entry is popped. At a leaf
    ``leaf_fn(lane, ids)`` runs for each lane of the mask and returns
    whether the lane leaves the walk (the any-hit exit). Each lane counts
    its own depth. Returns None where the warp restarts (a lane's depth
    past ``stack_size``, the packet's entries past MAX_STACK, the step
    bound), else the packet's steps."""
    children, aabbs, leaves, root, mpl = tree
    k = len(o)
    with np.errstate(divide="ignore"):
        inv = F32(1) / d
    live = m = (1 << k) - 1
    top, stack, depth, steps = root, [], [1] * k, 0
    bound = 4 * (len(children) + len(leaves)) + 64
    while True:
        if m:
            if steps == bound:
                return None
            steps += 1
            lanes = [i for i in range(k) if m >> i & 1]
            if top >= 0:
                node = min(top, len(children) - 1)
                L = R = 0
                for i in lanes:
                    with np.errstate(invalid="ignore"):
                        hits = _boxes_hit(o[i], inv[i], ln[i], aabbs[node])
                    hits = [bool(h) and not (prune and prune(i, aabbs[node, c]))
                            for c, h in enumerate(hits)]
                    L, R = L | hits[0] << i, R | hits[1] << i
                    depth[i] += hits[0] + hits[1] - 1
                if max(depth) > stack_size:
                    return None
                if L and R:
                    if len(stack) + 2 > walk.MAX_STACK:
                        return None
                    stack.append((children[node, 0], L))
                    top, m = children[node, 1], R
                    continue
                if L | R:
                    top, m = children[node, 0 if L else 1], L | R
                    continue
            else:
                first, count = leaves[min(max(~top, 0), len(leaves) - 1)]
                ids = np.clip(first + np.arange(max(min(count, mpl), 0)), 0, None)
                for i in lanes:
                    if leaf_fn(i, ids):
                        live &= ~(1 << i)
                    depth[i] -= 1
        if not stack or not live:
            return steps
        top, mask = stack.pop()
        m = mask & live


def walk_warps(rays, tree, n_prims, stack_size, leaf_fn, reset, prune=None):
    """The kernel's route over every ray: warps of 32 consecutive rays (the
    last ragged) in the packet walk; a warp that restarts has its lanes'
    state reset (``reset(ray)``) and walks each ray per ray. ``leaf_fn``
    and ``prune`` take the ray's index. Returns the flags (0, or the
    per-ray walk's) and the restarted warps."""
    o, d, ln = (t.numpy() for t in (rays.origins, rays.directions, rays.lengths))
    ids_clip = lambda ids: np.clip(ids, 0, n_prims - 1)
    flags, restarted = np.zeros(len(o), np.int32), []
    for w0 in range(0, len(o), 32):
        sl = slice(w0, min(len(o), w0 + 32))
        steps = packet_walk(o[sl], d[sl], ln[sl], tree, stack_size,
                            lambda i, ids: leaf_fn(w0 + i, ids_clip(ids)),
                            prune and (lambda i, box: prune(w0 + i, box)))
        if steps is None:
            restarted.append(w0 // 32)
            for r in range(sl.start, sl.stop):
                reset(r)
                flags[r] = per_ray_walk(o[r], d[r], ln[r], tree, n_prims, stack_size,
                                        lambda ids, r=r: leaf_fn(r, ids))
    return flags, restarted


class SphLanes:
    """Each ray's state in bvh_walk.cu's SPH modes: the leaves in walk
    order, the hit count, the records (prim, distance), and the weighted
    cumulative sum (a leaf's terms in leaf order, then the leaf's sum)."""

    def __init__(self, rays, spheres, table, weights):
        self.o, self.d, self.ln = (t.numpy() for t in (rays.origins, rays.directions,
                                                       rays.lengths))
        self.s, self.table, self.w = spheres.numpy(), torch.from_numpy(table), weights
        self.leaves, self.records = {}, {}
        self.counts = np.zeros(len(self.o), np.int32)
        self.sums = np.zeros(len(self.o), F32)
        for r in range(len(self.o)):
            self.reset(r)

    def reset(self, r):
        self.leaves[r], self.records[r] = [], []
        self.counts[r], self.sums[r] = 0, 0

    def leaf(self, r, ids):
        s = self.s[ids]
        p = s[:, :3] - self.o[r]
        dist = _dot3(p, self.d[r][None])
        b = _fma(-dist[:, None], self.d[r][None], p)
        b2 = _dot3(b, b)
        hit = (b2 < s[:, 3] * s[:, 3]) & (dist >= 0) & (dist < self.ln[r])
        terms = TF.sph_integral(torch.from_numpy(b2[hit]), torch.from_numpy(s[hit, 3]),
                                self.table).numpy() * self.w[ids[hit]]
        leaf_sum = F32(0)
        for x in terms:
            leaf_sum = F32(leaf_sum + x)
        self.sums[r] = F32(self.sums[r] + leaf_sum)
        self.leaves[r].append(tuple(ids))
        self.records[r] += list(zip(ids[hit], dist[hit]))
        self.counts[r] += int(hit.sum())
        return False


@pytest.mark.parametrize("stack_size", [64, 4])
def test_packet_walk_equals_lockstep_sph(sph_scene, stack_size):
    """The packet walk, per lane, equals the per-ray walk's leaf sequence,
    counts, records and weighted sums (bit for bit) and the lockstep walk's
    counts, record positions (prim, ray, distance) and sums (rtol 1e-5: it
    sums a leaf in torch's order) on the rays whose walk ends, over 10
    warps of diverging rays, the last one ragged (12 lanes) and the last
    two holding the box-plane rays; at a stack of 4 warps restart."""
    _, (ss, tree_t, rays) = sph_scene
    table = np.asarray(DENSE_KERNEL_INTEGRAL_TABLE, F32)
    w = (0.5 + np.random.default_rng(34).random(ss.shape[0])).astype(F32)
    tree = _tree_np(tree_t)
    per_ray = SphLanes(rays, ss, table, w)
    o, d, ln = per_ray.o, per_ray.d, per_ray.ln
    want_flags = np.array([per_ray_walk(o[r], d[r], ln[r], tree, ss.shape[0], stack_size,
                                        lambda ids, r=r: per_ray.leaf(r, ids))
                           for r in range(len(o))])
    packet = SphLanes(rays, ss, table, w)
    flags, restarted = walk_warps(rays, tree, ss.shape[0], stack_size, packet.leaf,
                                  packet.reset)
    assert rays.n_rays % 32 == 12 and bool(restarted) == (stack_size == 4)
    assert np.array_equal(flags, want_flags)
    assert packet.leaves == per_ray.leaves and packet.records == per_ray.records
    assert np.array_equal(packet.counts, per_ray.counts)
    assert np.array_equal(packet.sums.view(np.int32), per_ray.sums.view(np.int32))
    keep = flags != 2
    rk = rays[torch.from_numpy(keep)]
    counts = packet.counts[keep]
    assert counts.sum() > 0
    assert np.array_equal(tsph.trace_hitcounts_sph(rk, ss, tree_t, stack_size=stack_size)
                          .numpy(), counts)
    cap = int(counts.sum())
    res = tsph.trace_sph(rk, ss, tree_t, capacity=cap, stack_size=stack_size)
    want = [(p, r, dist) for r in np.flatnonzero(keep) for p, dist in packet.records[r]]
    assert np.array_equal(res.indices.numpy(), np.array([x[0] for x in want], np.int32))
    assert np.array_equal(res.distances.numpy(), np.array([x[2] for x in want], F32))
    sums = tsph.trace_cumulative_sph(rk, ss, tree_t, table, torch.from_numpy(w),
                                     stack_size=stack_size).numpy()
    np.testing.assert_allclose(packet.sums[keep], sums, rtol=1e-5,
                               atol=1e-6 * np.abs(sums).max())


class TriLanes:
    """Each ray's state in bvh_walk.cu's triangle modes: the closest t and
    triangle (a strict < in walk order), with pruning past the best t, or
    occlusion with the any-hit exit."""

    def __init__(self, rays, tris, mode, stack_size):
        self.o, self.d, self.ln = (t.numpy() for t in (rays.origins, rays.directions,
                                                       rays.lengths))
        with np.errstate(divide="ignore"):
            self.inv = F32(1) / self.d
        self.tris, self.mode = tris.numpy(), mode
        self.pruning = mode == "closest" and stack_size >= walk.PRUNE_STACK
        self.pruned = self.exits = 0
        n = len(self.o)
        self.t, self.ids = np.full(n, np.inf, F32), np.full(n, -1, np.int32)
        self.occluded = np.zeros(n, bool)

    def reset(self, r):
        self.t[r], self.ids[r], self.occluded[r] = np.inf, -1, False

    def leaf(self, r, ids):
        hit, t = _triangles_hit(self.o[r], self.d[r], self.ln[r], self.tris[ids])
        for p, tp, h in zip(ids, t, hit):
            if self.mode == "any" and h:
                self.occluded[r] = True
                self.exits += 1
                return True
            if h and tp < self.t[r]:
                self.t[r], self.ids[r] = tp, p
        return False

    def prune(self, r, box):
        out = (self.pruning and self.t[r] < np.inf
               and _beyond(self.o[r], self.inv[r], box, self.t[r]))
        self.pruned += out
        return out


@pytest.mark.parametrize("stack_size", [64, 4])
def test_packet_walk_equals_lockstep_triangles(tri_scene, stack_size):
    """The packet walk with closest-hit pruning (at stacks of PRUNE_STACK
    and above) and the any-hit exit, per lane, equals the lockstep walk's
    closest ids and t and occlusion bit for bit on the rays whose walk ends
    (200 rays: a ragged last warp of 8 lanes, box-plane rays in the last
    two); pruning and the exit both fire."""
    _, (st, tree_t, rays) = tri_scene
    tree = _tree_np(tree_t)
    res = {}
    for mode in walk.TRI_MODES:
        lanes = TriLanes(rays, st, mode, stack_size)
        flags, restarted = walk_warps(rays, tree, st.shape[0], stack_size, lanes.leaf,
                                      lanes.reset, lanes.prune)
        res[mode] = lanes, flags
        assert bool(restarted) == (stack_size == 4)
    assert rays.n_rays % 32 == 8
    closest, flags = res["closest"]
    assert (closest.pruned > 0) == (stack_size >= walk.PRUNE_STACK)
    assert res["any"][0].exits > 20
    keep = flags != 2
    rk = rays[torch.from_numpy(keep)]
    got = tt.trace_closest_hit(rk, st, tree_t, stack_size=stack_size)
    assert np.array_equal(closest.ids[keep], got.tri.numpy()) and (got.tri >= 0).sum() > 20
    assert np.array_equal(closest.t[keep].view(np.int32), got.t.numpy().view(np.int32))
    occ = tt.trace_any_hit(rk, st, tree_t, stack_size=stack_size).numpy()
    assert np.array_equal(res["any"][0].occluded[keep], occ)


def _facade_cases():
    table = np.asarray(DENSE_KERNEL_INTEGRAL_TABLE, F32)
    w = (0.5 + np.random.default_rng(33).random(1500)).astype(F32)
    exact = lambda g, w_: np.array_equal(g, w_)
    close = lambda g, w_: np.allclose(g, w_, rtol=1e-5, atol=1e-6 * np.abs(w_).max())
    return {
        "trace_hitcounts_sph": (lambda j, t: (jsph.trace_hitcounts_sph(*j),
                                              tsph.trace_hitcounts_sph(*t)), [exact]),
        "trace_cumulative_sph weighted": (
            lambda j, t: (jsph.trace_cumulative_sph(*j, table, jnp.asarray(w)),
                          tsph.trace_cumulative_sph(*t, table, torch.from_numpy(w))), [close]),
        "trace_sph": (lambda j, t: (jsph.trace_sph(*j, capacity=6000)[1:],
                                    tsph.trace_sph(*t, capacity=6000)[1:]),
                      [exact, exact, close, exact, exact]),
        "trace_with_sentinels_sph": (
            lambda j, t: (jsph.trace_with_sentinels_sph(*j, capacity=6400),
                          tsph.trace_with_sentinels_sph(*t, capacity=6400)),
            [exact, exact, exact, close, exact, exact]),
        "find_hits": (lambda j, t: (jr.find_hits(*j, 6000), tr.find_hits(*t, 6000)),
                      [exact] * 4),
    }


@pytest.mark.parametrize("name", list(_facade_cases()))
def test_sph_facades_reach_the_plain_walk_and_match_grace_tpu(sph_scene, name):
    """Each SPH facade on CPU tensors runs engine.trace (its call count
    moves, walk_sph launches nothing) and matches grace_tpu: counts, ids,
    positions and distances exact, integrals and sums within rtol 1e-5."""
    (ss, tree, rays), (ss_t, tree_t, rays_t) = sph_scene
    fn, checks = _facade_cases()[name]
    calls, launches = engine.trace.calls, walk.walk_sph.launches
    want, got = fn((JRays.from_arrays(rays.origins[:240], rays.directions[:240],
                                      rays.lengths[:240]), ss, tree),
                   (rays_t[:240], ss_t, tree_t))
    assert engine.trace.calls > calls and walk.walk_sph.launches == launches
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(want) == len(got) == len(checks)
    for w_, g, check in zip(want, got, checks):
        w_, g = np.asarray(w_), g.numpy()
        if w_.ndim == 1 and w_.shape[0] in (6000, 6400):   # past the hits: unspecified
            n = int(np.asarray(want[-1]))
            w_, g = w_[:n], g[:n]
        assert g.shape == w_.shape and check(g, w_), name


def test_triangle_facades_reach_the_plain_walk_and_match_grace_tpu(tri_scene):
    (st, tree, rays), (st_t, tree_t, rays_t) = tri_scene
    calls, launches = engine.trace.calls, walk.walk_tri.launches
    want = jt.trace_closest_hit(rays, st, tree)
    got = tt.trace_closest_hit(rays_t, st_t, tree_t)
    assert np.array_equal(got.tri.numpy(), np.asarray(want.tri))
    assert np.array_equal(got.t.numpy(), np.asarray(want.t))
    assert np.array_equal(tt.trace_any_hit(rays_t, st_t, tree_t).numpy(),
                          np.asarray(jt.trace_any_hit(rays, st, tree)))
    assert engine.trace.calls == calls + 2 and walk.walk_tri.launches == launches


def test_wrappers_reject_what_the_kernel_does_not_take(sph_scene, tri_scene):
    _, (ss, tree_t, rays) = sph_scene
    with pytest.raises(ValueError, match="stack_size"):
        walk.walk_sph(rays, ss, tree_t, "count", stack_size=walk.MAX_STACK + 1)
    with pytest.raises(ValueError, match="stack_size"):
        walk.walk_tri(rays, tri_scene[1][0], tri_scene[1][1], "any", stack_size=0)
    with pytest.raises(ValueError, match="mode"):
        walk.walk_sph(rays, ss, tree_t, "closest")
    with pytest.raises(ValueError, match="cursors"):
        walk.walk_sph(rays, ss, tree_t, "ids", capacity=8)
    with pytest.raises(TypeError):
        walk.walk_sph(rays, ss, tree_t, "cumulative", weights=torch.ones(ss.shape[0],
                                                                         dtype=torch.float64))
    # shapes the kernel indexes by: spheres f32[N, 4], weights f32[N], rays
    with pytest.raises(ValueError, match="shapes"):
        walk.walk_sph(rays, ss[:, :3].contiguous(), tree_t, "count")
    with pytest.raises(ValueError, match="weights"):
        walk.walk_sph(rays, ss, tree_t, "cumulative", weights=torch.ones(ss.shape[0] - 1))
    with pytest.raises(ValueError, match="shapes"):
        walk.walk_tri(Rays(rays.origins, rays.directions, rays.lengths[:-1]),
                      tri_scene[1][0], tri_scene[1][1], "closest")
    # the packet route's stats: one row of STATS_FIELDS a warp, on that route only
    out = (torch.empty(rays.n_rays, dtype=torch.int32),)
    rows = torch.zeros((-(-rays.n_rays // walk.WARP), len(walk.STATS_FIELDS)), dtype=torch.int32)
    with pytest.raises(ValueError, match="stats"):
        walk._launch_sph(rays, ss, tree_t, "count", 64, None, None, None, 0, out, stats=rows,
                         route="per_ray")
    with pytest.raises(ValueError, match="stats"):
        walk._launch_tri(rays, tri_scene[1][0], tri_scene[1][1], "any", 64,
                         (torch.empty(rays.n_rays, dtype=torch.bool),), stats=rows[:1])
    # the plain walk still takes the largest stack the kernel holds
    full = walk.walk_sph(rays, ss, tree_t, "count", stack_size=walk.MAX_STACK)
    assert torch.equal(full, tsph.trace_hitcounts_sph(rays, ss, tree_t))
