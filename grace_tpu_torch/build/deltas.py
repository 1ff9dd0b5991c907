"""Adjacent-pair "delta" computation for LBVH construction.

PyTorch counterpart of ``grace_tpu.build.deltas``. ``d[j]`` measures the
dissimilarity of Morton-sorted primitives j and j+1, for j in [0, N-1);
larger delta == weaker affinity. The boundary values d[-1] = d[N-1] = MAX
are not stored.

Integer (XOR) deltas are uint32 values held in int64; their MAX sentinel
is 0xFFFFFFFF, as in ``grace_tpu`` (a 63-bit XOR delta can reach it:
ROADMAP C19).

Each delta function launches ``csrc/build.cu``'s ``grace_deltas``
(``deltas_cuda``) on CUDA tensors and runs its plain version on CPU
tensors, or where ``plain`` (which only the checks pass); both give the
same bits. The build's own path takes ``gather_deltas_cuda``
(``grace_gather_deltas``): the sort's gather of spheres or triangles, the
int32 permutation, the sorted rows' boxes and their deltas in one launch,
bit-equal to ``prims[perm]``, ``perm.to(int32)``, ``kind.aabb`` and the
delta functions here.
"""

from __future__ import annotations

import torch

from grace_tpu_torch import _kernels
from grace_tpu_torch.ops.primitives import SPHERE, TRIANGLE, AabbFn, CentroidFn, PrimitiveKind
from grace_tpu_torch.ops.vecmath import dot3, fma

U32_SENTINEL = 0xFFFFFFFF
# grace_deltas' kinds
KINDS = ("euclidean", "surface_area", "xor30", "xor63")


def _rows(t: torch.Tensor, name: str) -> torch.Tensor:
    """``t`` as f32[N, 3] rows whose elements are adjacent (any row stride)."""
    if t.dim() != 2 or t.shape[1] != 3 or t.dtype != torch.float32:
        raise ValueError(f"deltas: {name} must be f32[N, 3]")
    return t if t.stride(1) == 1 and t.stride(0) >= 3 else t.contiguous()


def deltas_cuda(kind: str, a=None, b=None, keys=None) -> torch.Tensor:
    """One launch of ``grace_deltas``: the N-1 adjacent deltas of ``kind``
    (``KINDS``) from centroids ``a`` (euclidean), box minima ``a`` and
    maxima ``b`` (surface_area) or int64 keys (xor30, xor63)."""
    k = KINDS.index(kind)
    if kind.startswith("xor"):
        if keys.dim() != 1 or keys.dtype != torch.int64:
            raise ValueError("deltas: keys must be int64[N]")
        keys = keys.contiguous()
        n, dev, out_dtype = keys.shape[0], keys.device, torch.int64
        a = b = None
    else:
        a = _rows(a, "centroids" if b is None else "box minima")
        b = None if b is None else _rows(b, "box maxima")
        n, dev, out_dtype = a.shape[0], a.device, torch.float32
    out = torch.empty(max(n - 1, 0), dtype=out_dtype, device=dev)
    if n < 2:
        return out
    ptr = lambda t: 0 if t is None else t.data_ptr()
    _kernels.launch("build", "grace_deltas", dev, ptr(a), ptr(b), ptr(keys), out.data_ptr(), n,
                    0 if a is None else a.stride(0), 0 if b is None else b.stride(0), k)
    deltas_cuda.launches += 1
    return out


deltas_cuda.launches = 0


# grace_gather_deltas' primitive kinds: spheres f32[N, 4], triangles f32[N, 3, 3]
GATHER_PRIMS = {"sphere": (4,), "triangle": (3, 3)}


def gather_deltas_cuda(prims: torch.Tensor, prim: str, perm: torch.Tensor, keys=None,
                       kind=None, boxes: bool = True):
    """One launch of ``grace_gather_deltas``: ``prims`` (``prim``, a key of
    ``GATHER_PRIMS``) taken in the order of the stable sort's int64
    ``perm``. Returns (sorted prims, perm i32[N], box minima, box maxima
    f32[N, 3] or None where not ``boxes``, deltas [N-1] of ``kind``
    (``KINDS``; the XOR kinds from the sorted int64 ``keys``) or None)."""
    shape = GATHER_PRIMS[prim]
    if prims.dtype != torch.float32 or tuple(prims.shape[1:]) != shape:
        raise ValueError(f"gather_deltas: {prim} rows must be f32[N, {', '.join(map(str, shape))}]")
    n, dev = prims.shape[0], prims.device
    if perm.shape != (n,) or perm.dtype != torch.int64 or perm.device != dev:
        raise ValueError(f"gather_deltas: perm must be int64[{n}] on {dev}")
    k = -1 if kind is None else KINDS.index(kind)
    if kind is not None and kind.startswith("xor"):
        if keys is None or keys.shape != (n,) or keys.dtype != torch.int64:
            raise ValueError(f"gather_deltas: {kind} deltas need the sorted keys int64[{n}]")
        keys = keys.contiguous()
    else:
        keys = None
    prims = _kernels.aligned(prims) if prim == "sphere" else prims.contiguous()
    perm = perm.contiguous()
    sorted_prims = torch.empty_like(prims)
    perm32 = torch.empty(n, dtype=torch.int32, device=dev)
    mins, maxs = ((torch.empty((n, 3), dtype=torch.float32, device=dev) for _ in range(2))
                  if boxes else (None, None))
    out = (None if kind is None else
           torch.empty(max(n - 1, 0), dtype=torch.int64 if keys is not None else torch.float32,
                       device=dev))
    if n == 0:
        return sorted_prims, perm32, mins, maxs, out
    ptr = lambda t: 0 if t is None else t.data_ptr()
    _kernels.launch("build", "grace_gather_deltas", dev,
                    *[ptr(t) for t in (prims, perm, keys, sorted_prims, perm32, mins, maxs, out)],
                    n, list(GATHER_PRIMS).index(prim), k)
    gather_deltas_cuda.launches += 1
    return sorted_prims, perm32, mins, maxs, out


gather_deltas_cuda.launches = 0


def gather_for(kind: PrimitiveKind, delta_kind: str, bits: int):
    """``gather_deltas_cuda``'s (prim, kind) for a build over primitives of
    ``kind`` with ``delta_kind`` deltas ("euclidean", "surface_area" or
    "xor" of ``bits``-bit keys), or None where it takes no such rows."""
    prim = {SPHERE: "sphere", TRIANGLE: "triangle"}.get(kind)
    if prim is None:
        return None
    if delta_kind not in ("euclidean", "surface_area", "xor"):
        raise ValueError(f"unknown delta_kind {delta_kind!r}")
    return prim, f"xor{bits}" if delta_kind == "xor" else delta_kind


def _on_card(t: torch.Tensor, plain: bool) -> bool:
    return not plain and t.device.type != "cpu"


def xor_deltas(keys, plain: bool = False) -> torch.Tensor:
    """XOR (Karras-style) deltas of 30-bit Morton keys (int64[N-1])."""
    if _on_card(keys, plain):
        return deltas_cuda("xor30", keys=keys)
    return keys[:-1] ^ keys[1:]


def _bit_length(v: torch.Tensor) -> torch.Tensor:
    """Bit length of non-negative int64 values."""
    n = torch.zeros_like(v)
    for s in (32, 16, 8, 4, 2, 1):
        big = (v >> (n + s)) != 0
        n = n + big.to(v.dtype) * s
    return torch.where(v != 0, n + 1, torch.zeros_like(v))


def xor_deltas_63bit(keys, plain: bool = False) -> torch.Tensor:
    """Order-compressed XOR deltas of 63-bit keys (int64, one value per key).

    The 64-bit XOR is compressed to 32 bits as
    (bit_length << 26) | (the 26 bits below the leading bit), exactly as
    ``grace_tpu``'s (hi, lo) form computes it.
    """
    if _on_card(keys, plain):
        return deltas_cuda("xor63", keys=keys)
    d = keys[:-1] ^ keys[1:]
    bitlen = _bit_length(d)
    shift = torch.clamp(bitlen - 27, min=0)
    mant = (d >> shift) & ((1 << 26) - 1)
    return (bitlen << 26) | mant


def euclidean_deltas(prims, centroid: CentroidFn, plain: bool = False) -> torch.Tensor:
    """Squared centroid distance between adjacent primitives."""
    c = centroid(prims)
    if _on_card(c, plain):
        return deltas_cuda("euclidean", a=c)
    diff = c[:-1] - c[1:]
    return dot3(diff, diff)


def surface_area_deltas(prims, aabb: AabbFn, plain: bool = False) -> torch.Tensor:
    """Half-surface-area of the union AABB of adjacent primitives."""
    mins, maxs = aabb(prims)
    if _on_card(mins, plain):
        return deltas_cuda("surface_area", a=mins, b=maxs)
    u_min = torch.minimum(mins[:-1], mins[1:])
    u_max = torch.maximum(maxs[:-1], maxs[1:])
    ext = u_max - u_min
    e0, e1, e2 = ext[:, 0], ext[:, 1], ext[:, 2]
    return fma(e1, e2, fma(e0, e1, e0 * e2))


def delta_max_sentinel(dtype) -> float | int:
    """The out-of-range boundary value for a delta dtype."""
    if dtype == torch.int64:
        return U32_SENTINEL
    if dtype in (torch.float32, torch.float64):
        return float("inf")
    raise TypeError(f"unsupported delta dtype {dtype}")
