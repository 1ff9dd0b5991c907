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
"""

from __future__ import annotations

import math
from typing import List

import torch

from grace_tpu_torch.build.deltas import delta_max_sentinel
from grace_tpu_torch.core.errors import debug_assert, require
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


def build_lbvh(prim_aabb_mins, prim_aabb_maxs, deltas, max_per_leaf: int) -> Tree:
    """Build the BVH over Morton-sorted primitives.

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

    def ld_at(idx):
        inside = (idx >= 0) & (idx < n_leaves - 1)
        return torch.where(inside, ld[torch.clamp(idx, 0, cap - 1)],
                           torch.full_like(ld[:1], sent))

    # Parent rule: the boundary with the smaller delta becomes the parent;
    # ties go right.
    is_right_child = ld_at(L - 1) < ld_at(R)
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
    leaf_is_right = ld_at(kk - 1) < ld_at(kk)
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

    # GRACE_TPU_DEBUG output contracts: leaves tile [0, N) with counts in
    # [1, max_per_leaf]; valid nodes have non-empty child boxes.
    debug_assert(
        (leaf_first[0] == 0)
        & torch.where(leaf_valid, (leaf_count >= 1) & (leaf_count <= max_per_leaf),
                      True).all(),
        "leaf partition: counts out of [1, max_per_leaf] or nonzero start")
    ends = leaf_first + leaf_count
    nxt = torch.where(kk + 1 < n_leaves, leaf_first[torch.clamp(kk + 1, max=n - 1)], ends)
    debug_assert(
        torch.where(leaf_valid, nxt == ends, True).all()
        & (ends[torch.clamp(n_leaves - 1, min=0)] == n),
        "leaf partition: gaps or wrong terminal primitive")
    debug_assert(
        torch.where(node_valid[:, None, None],
                    child_aabbs[:, :, 0, :] <= child_aabbs[:, :, 1, :], True).all(),
        "node child AABBs empty/inverted")
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
