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
same bits.
"""

from __future__ import annotations

import torch

from grace_tpu_torch import _kernels
from grace_tpu_torch.ops.primitives import AabbFn, CentroidFn
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
