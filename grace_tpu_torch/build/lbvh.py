"""Deterministic LBVH construction (PyTorch counterpart of
``grace_tpu.build.lbvh``).

The tree is the Cartesian tree (max at root) of the adjacent-pair delta
sequence, ties broken toward the leftmost position. Each internal node i
(children [l_i, i] and [i+1, r_i]) has

    l_i = 1 + max{ j < i : d[j] >= d[i] }        (or 0)
    r_i =     min{ j > i : d[j] >  d[i] }        (or n-1)

found for all i at once with a sparse max-table and a binary skip search.
Big leaves are the maximal subtrees of size <= max_per_leaf; the top tree
over them is built the same way from the leaf-boundary deltas; child AABBs
are range reductions over the Morton-sorted primitives. The output is the
same tree, field for field, as ``grace_tpu``'s.

That is the plain version, ``build_lbvh_plain``, which CPU tensors take.
On CUDA tensors ``build_lbvh`` builds the same tree as the CUDA original
does, with two bottom-up climbs coordinated by atomics
(``csrc/build.cu``): ``lbvh_ranges`` (the ranges of every split and the
big leaves at their slots), one prefix sum, and ``lbvh_nodes`` (the top
tree, its boxes and padding), two memsets, three launches and no host
sync. Each climb runs a block over consecutive items (up to 1024 primitives
in phase A, the leaves of as many primitive slots in phase B): the splits
whose range lies inside the block complete in shared memory, the others at
device scope; phase B's threads hold only leaves, and a warp unions each
leaf's box in order. Both builds count the ends of a delta sequence as
larger than any delta, so their trees are bit-equal, also where a delta
equals the sentinel, where grace_tpu's build breaks (ROADMAP C19).
"""

from __future__ import annotations

import ctypes
import math
from typing import List

import torch

from grace_tpu_torch import _kernels
from grace_tpu_torch.build.deltas import delta_max_sentinel
from grace_tpu_torch.core.errors import debug_assert, debug_enabled, require
from grace_tpu_torch.core.tree import Tree, encode_leaf_child


def _build_max_table(d: torch.Tensor) -> List[torch.Tensor]:
    """Sparse table M[k][i] = max(d[i : i + 2**k]) (windows clipped)."""
    n = d.shape[0]
    levels = [d]
    k = 1
    while (1 << k) <= n:
        prev = levels[-1]
        half = 1 << (k - 1)
        shifted = torch.cat([prev[half:], prev[-half:]])
        levels.append(torch.maximum(prev, shifted))
        k += 1
    return levels


def _next_greater(levels, start, t):
    """First j >= start with d[j] > t, else n."""
    n = levels[0].shape[0]
    pos = start
    for k in reversed(range(len(levels))):
        w = 1 << k
        valid = pos + w <= n
        m = levels[k][torch.clamp(pos, 0, n - 1)]
        pos = torch.where(valid & (m <= t), pos + w, pos)
    return pos


def _prev_greater_equal(levels, start, t):
    """Last j <= start with d[j] >= t, else -1."""
    n = levels[0].shape[0]
    pos = start
    for k in reversed(range(len(levels))):
        w = 1 << k
        lo = pos - w + 1
        m = levels[k][torch.clamp(lo, 0, n - 1)]
        pos = torch.where((lo >= 0) & (m < t), pos - w, pos)
    return pos


def cartesian_tree_ranges(d: torch.Tensor, n_valid=None):
    """Ranges [l_i, r_i] (leaf-index space) of every split position i."""
    m = d.shape[0]
    levels = _build_max_table(d)
    i = torch.arange(m, dtype=torch.int64, device=d.device)
    l = _prev_greater_equal(levels, i - 1, d) + 1
    r = _next_greater(levels, i + 1, d)
    if n_valid is not None:
        r = torch.minimum(r, n_valid - 1)
    return l, r


def _scatter_drop(dst: torch.Tensor, slots: torch.Tensor, vals: torch.Tensor):
    """dst[slots] = vals, dropping out-of-range slots (``mode="drop"``).
    Callers guarantee the kept slots are distinct."""
    keep = (slots >= 0) & (slots < dst.shape[0])
    dst[slots[keep]] = vals[keep]


def coalesce_leaves(l, r, max_per_leaf: int, n_prims: int):
    """Big leaves = the maximal subtrees of size <= max_per_leaf.

    Returns (leaf_first i64[n], leaf_count i64[n], n_leaves i64[])."""
    n = n_prims
    dev = l.device
    i = torch.arange(n - 1, dtype=torch.int64, device=dev)
    s_left = i - l + 1
    s_right = r - i
    size = s_left + s_right
    left_small = s_left <= max_per_leaf
    right_small = s_right <= max_per_leaf
    write = torch.where(left_small != right_small,
                        torch.ones_like(left_small), size > max_per_leaf)
    emit_left = left_small & write
    emit_right = right_small & write

    first = torch.zeros(n, dtype=torch.int64, device=dev)
    count = torch.zeros(n, dtype=torch.int64, device=dev)
    slot_l = torch.where(emit_left, l, n)
    _scatter_drop(first, slot_l, l)
    _scatter_drop(count, slot_l, s_left)
    slot_r = torch.where(emit_right, r, n)
    _scatter_drop(first, slot_r, i + 1)
    _scatter_drop(count, slot_r, s_right)

    valid = count > 0
    n_leaves = valid.sum()
    order = torch.argsort((~valid).to(torch.int8), stable=True)
    k = torch.arange(n, device=dev)
    leaf_first = torch.where(k < n_leaves, first[order], 0)
    leaf_count = torch.where(k < n_leaves, count[order], 0)
    return leaf_first, leaf_count, n_leaves


def _segment_reduce_tree(values: torch.Tensor, op, ident: float):
    n = values.shape[0]
    m = 1 << max(1, math.ceil(math.log2(max(n, 2))))
    pad = torch.full((m - n,) + tuple(values.shape[1:]), ident,
                     dtype=values.dtype, device=values.device)
    levels = [torch.cat([values, pad], dim=0)]
    while levels[-1].shape[0] > 1:
        prev = levels[-1]
        levels.append(op(prev[0::2], prev[1::2]))
    return levels


def _range_reduce(levels, a, b, op, ident: float):
    """Reduce values[a..b] inclusive for batched (a, b)."""
    acc = torch.full((a.shape[0],) + tuple(levels[0].shape[1:]), ident,
                     dtype=levels[0].dtype, device=a.device)
    lpos = a
    rpos = b + 1
    for level in levels[:-1]:
        sz = level.shape[0]
        take_l = ((lpos & 1) == 1) & (lpos < rpos)
        vl = level[torch.clamp(lpos, 0, sz - 1)]
        acc = torch.where(take_l[:, None], op(acc, vl), acc)
        lpos = lpos + take_l.to(lpos.dtype)
        take_r = ((rpos & 1) == 1) & (lpos < rpos)
        vr = level[torch.clamp(rpos - 1, 0, sz - 1)]
        acc = torch.where(take_r[:, None], op(acc, vr), acc)
        rpos = rpos - take_r.to(rpos.dtype)
        lpos = lpos >> 1
        rpos = rpos >> 1
    return acc


def _check_tree(tree: Tree) -> None:
    """The GRACE_TPU_DEBUG output contracts the trace kernels rely on:
    leaves tile [0, N) with counts in [1, max_per_leaf]; valid nodes have
    non-empty child boxes."""
    n = tree.leaf_capacity
    leaf_first, leaf_count = tree.leaves[:, 0].long(), tree.leaves[:, 1].long()
    n_leaves = tree.n_leaves.long()
    kk = torch.arange(n, device=leaf_first.device)
    leaf_valid = kk < n_leaves
    debug_assert(
        (leaf_first[0] == 0)
        & torch.where(leaf_valid, (leaf_count >= 1) & (leaf_count <= tree.max_per_leaf),
                      True).all(),
        "leaf partition: counts out of [1, max_per_leaf] or nonzero start")
    ends = leaf_first + leaf_count
    nxt = torch.where(kk + 1 < n_leaves, leaf_first[torch.clamp(kk + 1, max=n - 1)], ends)
    debug_assert(
        torch.where(leaf_valid, nxt == ends, True).all()
        & (ends[torch.clamp(n_leaves - 1, min=0)] == n),
        "leaf partition: gaps or wrong terminal primitive")
    node_valid = torch.arange(tree.capacity, device=kk.device) < n_leaves - 1
    debug_assert(
        torch.where(node_valid[:, None, None],
                    tree.child_aabbs[:, :, 0, :] <= tree.child_aabbs[:, :, 1, :], True).all(),
        "node child AABBs empty/inverted")


def build_lbvh_plain(prim_aabb_mins, prim_aabb_maxs, deltas, max_per_leaf: int) -> Tree:
    """build_lbvh's plain version, on any device: build the BVH over
    Morton-sorted primitives.

    Args:
      prim_aabb_mins/maxs: f32[N, 3] AABBs of Morton-sorted primitives.
      deltas: [N-1] adjacent-pair deltas (int64 or f32); see build.deltas.
      max_per_leaf: leaf capacity, 1 <= max_per_leaf < N.

    Returns:
      Tree with capacity N-1 internal nodes / N leaves.
    """
    n = prim_aabb_mins.shape[0]
    require(n >= 2, "build_lbvh requires at least 2 primitives")
    require(1 <= max_per_leaf < n,
            f"max_per_leaf {max_per_leaf} out of range for N={n}")
    dev = prim_aabb_mins.device

    # Phase A: primitive-level Cartesian ranges + leaf coalescing.
    l, r = cartesian_tree_ranges(deltas)
    leaf_first, leaf_count, n_leaves = coalesce_leaves(l, r, max_per_leaf, n)

    # Leaf boundary deltas, MAX at k >= n_leaves - 1.
    sent = delta_max_sentinel(deltas.dtype)
    last = torch.clamp(leaf_first + leaf_count - 1, 0, n - 2)
    k_idx = torch.arange(n, dtype=torch.int64, device=dev)
    ld_full = torch.where(k_idx < n_leaves - 1, deltas[last],
                          torch.full_like(deltas[last], sent))
    ld = ld_full[: n - 1]

    # Phase B: top tree over big leaves.
    cap = n - 1
    p = torch.arange(cap, dtype=torch.int64, device=dev)
    node_valid = p < (n_leaves - 1)
    L, R = cartesian_tree_ranges(ld, n_valid=n_leaves)
    L = torch.where(node_valid, L, 0)
    R = torch.where(node_valid, R, 0)

    def ld_below(i, j):
        """ld[i] < ld[j], where the ends (i or j outside [0, n_leaves - 1))
        count as larger than any delta, as csrc/build.cu's climb takes
        them. grace_tpu compares the sentinel by value here, which breaks
        the tree where a delta equals it (ROADMAP C19); on every other
        input the two rules agree."""
        inside = lambda idx: (idx >= 0) & (idx < n_leaves - 1)
        below = ld[torch.clamp(i, 0, cap - 1)] < ld[torch.clamp(j, 0, cap - 1)]
        return inside(i) & (~inside(j) | below)

    # Parent rule: the boundary with the smaller delta becomes the parent;
    # ties go right.
    is_right_child = ld_below(L - 1, R)
    parent = torch.where(is_right_child, L - 1, R)
    is_root = node_valid & (L == 0) & (R == n_leaves - 1)
    root = torch.argmax(is_root.to(torch.int32))

    children = torch.zeros((cap, 2), dtype=torch.int64, device=dev)
    can_link = node_valid & ~is_root
    _scatter_drop(children[:, 0], torch.where(can_link & ~is_right_child, parent, cap), p)
    _scatter_drop(children[:, 1], torch.where(can_link & is_right_child, parent, cap), p)

    # Leaf children: leaf k (range [k, k]) uses the same parent rule.
    kk = torch.arange(n, dtype=torch.int64, device=dev)
    leaf_valid = kk < n_leaves
    leaf_is_right = ld_below(kk - 1, kk)
    leaf_parent = torch.where(leaf_is_right, kk - 1, kk)
    enc = encode_leaf_child(kk)
    _scatter_drop(children[:, 0],
                  torch.where(leaf_valid & ~leaf_is_right, leaf_parent, cap), enc)
    _scatter_drop(children[:, 1],
                  torch.where(leaf_valid & leaf_is_right, leaf_parent, cap), enc)

    # Child AABBs: range reductions over sorted primitive intervals.
    inf = float("inf")
    min_levels = _segment_reduce_tree(prim_aabb_mins, torch.minimum, inf)
    max_levels = _segment_reduce_tree(prim_aabb_maxs, torch.maximum, -inf)

    def leaf_prim_span(leaf_idx):
        f = leaf_first[torch.clamp(leaf_idx, 0, n - 1)]
        c = leaf_count[torch.clamp(leaf_idx, 0, n - 1)]
        return f, f + c - 1

    # Left child covers leaves [L, p]; right child covers [p+1, R].
    la, _ = leaf_prim_span(L)
    _, lb = leaf_prim_span(p)
    ra, _ = leaf_prim_span(torch.clamp(p + 1, max=n - 1))
    _, rb = leaf_prim_span(R)

    def child_aabb(a, b, valid):
        mins = _range_reduce(min_levels, a, b, torch.minimum, inf)
        maxs = _range_reduce(max_levels, a, b, torch.maximum, -inf)
        return (torch.where(valid[:, None], mins, inf),
                torch.where(valid[:, None], maxs, -inf))

    lmin, lmax = child_aabb(la, lb, node_valid)
    rmin, rmax = child_aabb(ra, rb, node_valid)
    child_aabbs = torch.stack(
        [torch.stack([lmin, lmax], dim=1), torch.stack([rmin, rmax], dim=1)], dim=1)

    leaves = torch.stack([leaf_first, leaf_count], dim=1)
    i32 = lambda t: t.to(torch.int32)
    return Tree(
        children=i32(children),
        child_aabbs=child_aabbs,
        leaves=i32(leaves),
        root=i32(root),
        n_nodes=i32(n_leaves - 1),
        n_leaves=i32(n_leaves),
        max_per_leaf=max_per_leaf,
    )


def _is_float_deltas(deltas: torch.Tensor) -> int:
    """1 for f32 deltas, 0 for int64 ones (the climbs' ``is_float``)."""
    if deltas.dtype not in (torch.float32, torch.int64) or deltas.dim() != 1:
        raise TypeError(f"build_lbvh on the card takes f32 or int64 deltas [N-1], got "
                        f"{deltas.dtype} {tuple(deltas.shape)}")
    return int(deltas.dtype == torch.float32)


def lbvh_ranges(deltas: torch.Tensor, max_per_leaf: int, _block: int = 0):
    """One launch of ``grace_lbvh_ranges`` (phase A): the primitive-level
    climb over ``deltas`` [N-1]. Returns i32 (l [N-1], r [N-1], first [N],
    count [N], mark [N]): every split's range, equal to
    ``cartesian_tree_ranges``; the big leaves' first primitive and count at
    their slots (the first primitive of a left child, the last of a right
    child), where ``mark`` is 1. ``_block`` (primitives a block; 0: the
    kernel's default) exists for the tests, whose small blocks send most
    splits to the device-scope stage."""
    is_float = _is_float_deltas(deltas)
    d = deltas.contiguous()
    n, dev = d.shape[0] + 1, d.device
    l, r = (torch.empty(n - 1, dtype=torch.int32, device=dev) for _ in range(2))
    first, count = (torch.empty(n, dtype=torch.int32, device=dev) for _ in range(2))
    scratch = torch.empty(3 * n - 2, dtype=torch.int32, device=dev)   # u64 flags, then mark
    _kernels.launch("build", "grace_lbvh_ranges", dev,
                    *[t.data_ptr() for t in (d, l, r, first, count, scratch)],
                    n, max_per_leaf, is_float, _block)
    lbvh_ranges.launches += 1
    return l, r, first, count, scratch[2 * (n - 1):]


lbvh_ranges.launches = 0


def lbvh_nodes(deltas, first, count, mark, scan, mins, maxs, max_per_leaf: int,
               _block: int = 0) -> Tree:
    """One launch of ``grace_lbvh_nodes`` (phase B): the climb over the big
    leaves that ``lbvh_ranges`` marked (``scan``: the inclusive prefix sum
    of ``mark``), with the boxes of ``mins``, ``maxs`` f32[N, 3]. Returns
    the Tree, padded as the plain build pads it. ``_block`` (primitive slots
    a block; 0: the kernel's default) exists for the tests."""
    is_float = _is_float_deltas(deltas)
    d = deltas.contiguous()
    n, dev = d.shape[0] + 1, d.device
    if any(t.shape != (n, 3) or t.dtype != torch.float32 for t in (mins, maxs)):
        raise ValueError(f"build_lbvh: the primitives' boxes must be f32[{n}, 3]")
    mins, maxs = (t.contiguous() for t in (mins, maxs))
    i32 = dict(dtype=torch.int32, device=dev)
    children = torch.empty((n - 1, 2), **i32)
    child_aabbs = torch.empty((n - 1, 2, 2, 3), dtype=torch.float32, device=dev)
    leaves = torch.empty((n, 2), **i32)
    root, n_nodes, n_leaves = (torch.empty((), **i32) for _ in range(3))
    flags = torch.empty(n - 1, **i32)
    ends = torch.empty((n - 1, 6), **i32)
    _kernels.launch("build", "grace_lbvh_nodes", dev,
                    *[t.data_ptr() for t in (d, first, count, mark, scan, mins, maxs, children,
                                             child_aabbs, leaves, root, n_nodes, n_leaves,
                                             flags, ends)], n, max_per_leaf, is_float, _block)
    lbvh_nodes.launches += 1
    return Tree(children=children, child_aabbs=child_aabbs, leaves=leaves, root=root,
                n_nodes=n_nodes, n_leaves=n_leaves, max_per_leaf=max_per_leaf)


lbvh_nodes.launches = 0

# grace_build_resources' kernels
RESOURCE_KERNELS = ("morton_keys", "deltas", "gather_deltas", "lbvh_ranges", "lbvh_nodes",
                    "morton_keys_rays")


def build_resources(device, kernel: str, is_float: bool = True) -> dict:
    """What one launch of build kernel ``kernel`` (``RESOURCE_KERNELS``)
    holds on ``device`` (the climbs with f32 deltas where ``is_float``):
    ``_kernels.RESOURCE_FIELDS`` and ``local_bytes`` a thread."""
    fields = _kernels.RESOURCE_FIELDS + ("local_bytes",)
    out = (ctypes.c_int * len(fields))()
    _kernels.launch("build", "grace_build_resources", torch.device(device),
                    ctypes.addressof(out), RESOURCE_KERNELS.index(kernel), int(is_float))
    return dict(zip(fields, out))


def build_lbvh(prim_aabb_mins, prim_aabb_maxs, deltas, max_per_leaf: int,
               plain: bool = False) -> Tree:
    """Build the BVH over Morton-sorted primitives.

    Args:
      prim_aabb_mins/maxs: f32[N, 3] AABBs of Morton-sorted primitives.
      deltas: [N-1] adjacent-pair deltas (int64 or f32); see build.deltas.
      max_per_leaf: leaf capacity, 1 <= max_per_leaf < N.
      plain: run ``build_lbvh_plain`` on any device (only the checks pass it).

    Returns:
      Tree with capacity N-1 internal nodes / N leaves: on CUDA tensors
      from the two climbs of ``csrc/build.cu`` (``lbvh_ranges``, a prefix
      sum, ``lbvh_nodes``), on CPU tensors from ``build_lbvh_plain``.
    """
    n = prim_aabb_mins.shape[0]
    require(n >= 2, "build_lbvh requires at least 2 primitives")
    require(1 <= max_per_leaf < n,
            f"max_per_leaf {max_per_leaf} out of range for N={n}")
    if plain or prim_aabb_mins.device.type == "cpu":
        tree = build_lbvh_plain(prim_aabb_mins, prim_aabb_maxs, deltas, max_per_leaf)
    else:
        _, _, first, count, mark = lbvh_ranges(deltas, max_per_leaf)
        scan = torch.cumsum(mark, dim=0, dtype=torch.int32)
        tree = lbvh_nodes(deltas, first, count, mark, scan, prim_aabb_mins, prim_aabb_maxs,
                          max_per_leaf)
    if debug_enabled():
        _check_tree(tree)
    return tree
