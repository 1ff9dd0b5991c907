"""Morton (Z-order) keys in int64.

PyTorch counterpart of ``grace_tpu.ops.morton``. PyTorch has little uint32
support, so every key lives in an int64: a 30-bit key as is, and a 63-bit
key as the single value ``(hi << 32) | lo`` of ``grace_tpu``'s (hi, lo)
uint32 pair, which sorts in the same order. Quantization keeps the
reference's f32 operation order, so keys are bit-exact.

``morton_keys_from_centroids`` launches ``csrc/build.cu``'s
``grace_morton_keys`` on CUDA tensors and runs the plain version on CPU
tensors; both give the same bits.
"""

from __future__ import annotations

import torch

from grace_tpu_torch import _kernels

MORTON30_SPAN = (1 << 10) - 1  # 10 bits per axis
MORTON63_SPAN = (1 << 21) - 1  # 21 bits per axis
_U32_MAX = (1 << 32) - 1


def f32_to_u32(v: torch.Tensor) -> torch.Tensor:
    """Float to uint32 as XLA converts it (truncate toward zero, saturate
    at [0, 2^32 - 1], NaN -> 0), held in int64."""
    v = torch.nan_to_num(v.to(torch.float64), nan=0.0)
    return torch.clamp(v, 0.0, float(_U32_MAX)).to(torch.int64)


def space_by_two_10bit(x) -> torch.Tensor:
    """Spread the low 10 bits of x so bit k moves to bit 3k."""
    x = torch.as_tensor(x).to(torch.int64) & ((1 << 10) - 1)
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def space_by_two_21bit(x) -> torch.Tensor:
    """Spread the low 21 bits of x so bit k moves to bit 3k (63-bit result)."""
    x = torch.as_tensor(x).to(torch.int64) & ((1 << 21) - 1)
    x = (x | (x << 32)) & 0x001F00000000FFFF
    x = (x | (x << 16)) & 0x001F0000FF0000FF
    x = (x | (x << 8)) & 0x100F00F00F00F00F
    x = (x | (x << 4)) & 0x10C30C30C30C30C3
    x = (x | (x << 2)) & 0x1249249249249249
    return x


def morton_key_30bit(ux, uy, uz) -> torch.Tensor:
    """30-bit key: interleaved (z, y, x) with x least significant."""
    return ((space_by_two_10bit(uz) << 2) | (space_by_two_10bit(uy) << 1)
            | space_by_two_10bit(ux))


def morton_key_63bit(ux, uy, uz) -> torch.Tensor:
    """63-bit key, equal to ``(hi << 32) | lo`` of grace_tpu's pair."""
    return ((space_by_two_21bit(uz) << 2) | (space_by_two_21bit(uy) << 1)
            | space_by_two_21bit(ux))


def _quantize_unit(v, span: int) -> torch.Tensor:
    v = torch.as_tensor(v, dtype=torch.float32)
    return f32_to_u32(torch.tensor(float(span), dtype=torch.float32,
                                   device=v.device) * v)


def morton_key_30bit_from_unit(x, y, z) -> torch.Tensor:
    """30-bit key from floats in (0, 1)."""
    q = lambda v: _quantize_unit(v, MORTON30_SPAN)
    return morton_key_30bit(q(x), q(y), q(z))


def morton_key_63bit_from_unit(x, y, z) -> torch.Tensor:
    """63-bit key from floats in (0, 1)."""
    q = lambda v: _quantize_unit(v, MORTON63_SPAN)
    return morton_key_63bit(q(x), q(y), q(z))


def _morton_keys_plain(centroids, aabb_min, aabb_max, bits: int) -> torch.Tensor:
    """morton_keys_from_centroids' plain version, on any device."""
    span = torch.tensor(float(MORTON30_SPAN if bits == 30 else MORTON63_SPAN),
                        dtype=torch.float32, device=centroids.device)
    scale = span / (aabb_max - aabb_min)
    u = f32_to_u32(scale * (centroids - aabb_min))
    if bits == 30:
        return morton_key_30bit(u[:, 0], u[:, 1], u[:, 2])
    return morton_key_63bit(u[:, 0], u[:, 1], u[:, 2])


def morton_keys_cuda(centroids, aabb_min, aabb_max, bits: int) -> torch.Tensor:
    """One launch of ``grace_morton_keys`` on the card: the keys of
    ``centroids`` f32[N, 3] (rows at any stride) in the box f32[3] (or a
    scalar) ``aabb_min``, ``aabb_max``."""
    n = centroids.shape[0]
    if centroids.dim() != 2 or centroids.shape[1] != 3:
        raise ValueError(f"morton keys: centroids must be f32[N, 3], got {tuple(centroids.shape)}")
    if centroids.stride(1) != 1 or centroids.stride(0) < 3:
        centroids = centroids.contiguous()
    box = []
    for t in (aabb_min, aabb_max):
        if t.numel() not in (1, 3):
            raise ValueError("morton keys: the scene box must be f32[3] or a scalar")
        box.append(t.reshape(-1).expand(3).contiguous())
    keys = torch.empty(n, dtype=torch.int64, device=centroids.device)
    if n == 0:
        return keys
    _kernels.launch("build", "grace_morton_keys", centroids.device, centroids.data_ptr(),
                    box[0].data_ptr(), box[1].data_ptr(), keys.data_ptr(), n,
                    centroids.stride(0), bits)
    morton_keys_cuda.launches += 1
    return keys


morton_keys_cuda.launches = 0


def morton_keys_from_centroids(centroids, aabb_min, aabb_max, bits: int = 30,
                               plain: bool = False):
    """Quantize centroids into the scene AABB and compose Morton keys:
    per axis ``u = uint32(span / (top - bot) * (c - bot))`` in f32.

    Returns int64[N] (30-bit keys, or 63-bit keys as one value each):
    through ``morton_keys_cuda`` on CUDA tensors, the plain version on CPU
    tensors or where ``plain`` (which only the checks pass).
    """
    centroids = torch.as_tensor(centroids, dtype=torch.float32)
    dev = centroids.device
    aabb_min = torch.as_tensor(aabb_min, dtype=torch.float32, device=dev)
    aabb_max = torch.as_tensor(aabb_max, dtype=torch.float32, device=dev)
    if bits not in (30, 63):
        raise ValueError(f"bits must be 30 or 63, got {bits}")
    if plain or dev.type == "cpu":
        return _morton_keys_plain(centroids, aabb_min, aabb_max, bits)
    return morton_keys_cuda(centroids, aabb_min, aabb_max, bits)
