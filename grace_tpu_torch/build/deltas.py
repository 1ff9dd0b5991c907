"""Adjacent-pair "delta" computation for LBVH construction.

PyTorch counterpart of ``grace_tpu.build.deltas``. ``d[j]`` measures the
dissimilarity of Morton-sorted primitives j and j+1, for j in [0, N-1);
larger delta == weaker affinity. The boundary values d[-1] = d[N-1] = MAX
are not stored.

Integer (XOR) deltas are uint32 values held in int64; their MAX sentinel
is 0xFFFFFFFF, unreachable by any delta, as in ``grace_tpu``.
"""

from __future__ import annotations

import torch

from grace_tpu_torch.ops.primitives import AabbFn, CentroidFn
from grace_tpu_torch.ops.vecmath import dot3, fma

U32_SENTINEL = 0xFFFFFFFF


def xor_deltas(keys) -> torch.Tensor:
    """XOR (Karras-style) deltas of 30-bit Morton keys (int64[N-1])."""
    return keys[:-1] ^ keys[1:]


def _bit_length(v: torch.Tensor) -> torch.Tensor:
    """Bit length of non-negative int64 values."""
    n = torch.zeros_like(v)
    for s in (32, 16, 8, 4, 2, 1):
        big = (v >> (n + s)) != 0
        n = n + big.to(v.dtype) * s
    return torch.where(v != 0, n + 1, torch.zeros_like(v))


def xor_deltas_63bit(keys) -> torch.Tensor:
    """Order-compressed XOR deltas of 63-bit keys (int64, one value per key).

    The 64-bit XOR is compressed to 32 bits as
    (bit_length << 26) | (the 26 bits below the leading bit), exactly as
    ``grace_tpu``'s (hi, lo) form computes it.
    """
    d = keys[:-1] ^ keys[1:]
    bitlen = _bit_length(d)
    shift = torch.clamp(bitlen - 27, min=0)
    mant = (d >> shift) & ((1 << 26) - 1)
    return (bitlen << 26) | mant


def euclidean_deltas(prims, centroid: CentroidFn) -> torch.Tensor:
    """Squared centroid distance between adjacent primitives."""
    c = centroid(prims)
    diff = c[:-1] - c[1:]
    return dot3(diff, diff)


def surface_area_deltas(prims, aabb: AabbFn) -> torch.Tensor:
    """Half-surface-area of the union AABB of adjacent primitives."""
    mins, maxs = aabb(prims)
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
