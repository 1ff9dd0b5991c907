"""Morton (Z-order) keys in int64.

PyTorch counterpart of ``grace_tpu.ops.morton``. PyTorch has little uint32
support, so every key lives in an int64: a 30-bit key as is, and a 63-bit
key as the single value ``(hi << 32) | lo`` of ``grace_tpu``'s (hi, lo)
uint32 pair, which sorts in the same order. Quantization keeps the
reference's f32 operation order, so keys are bit-exact.

``morton_keys_from_centroids`` launches ``csrc/build.cu``'s
``grace_morton_keys`` on CUDA tensors and runs the plain version on CPU
tensors; both give the same bits. On the card a box that is not given is
folded in the keys' own launch, and ``ray_keys_cuda`` keys rays by their
midpoints from the rays themselves (``rays.gen.spatial_sort_rays``).
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


KEY_THREADS = 256    # build.cu's kThreads: items a block of the keys' launch
KEY_BLOCKS = 2048    # blocks a launch that folds its box, at most (132 SMs x 2 fit)


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def _box_arg(t, device):
    if t is None:
        return None
    t = torch.as_tensor(t, dtype=torch.float32, device=device)
    if t.numel() not in (1, 3):
        raise ValueError("morton keys: the scene box must be f32[3] or a scalar")
    return t.reshape(-1).contiguous()


def _launch_keys(rows, dirs, lengths, aabb_min, aabb_max, bits: int, blocks=None):
    """One launch of ``grace_morton_keys``: int64 keys of ``rows`` (centroids,
    or ray origins where ``dirs`` is given), in the box ``aabb_min``,
    ``aabb_max`` (each f32[3] or a scalar; both None: the box computed in
    the launch)."""
    device, n = rows.device, rows.shape[0]
    if (aabb_min is None) != (aabb_max is None):
        raise ValueError("morton keys: give both edges of the box or neither")
    bmin, bmax = _box_arg(aabb_min, device), _box_arg(aabb_max, device)
    if bmin is not None and bmin.numel() != bmax.numel():
        bmin, bmax = bmin.expand(3).contiguous(), bmax.expand(3).contiguous()
    keys = torch.empty(n, dtype=torch.int64, device=device)
    if n == 0:
        return keys
    fold = bmin is None
    if blocks is None:
        blocks = min(-(-n // KEY_THREADS), KEY_BLOCKS)
    parts = torch.empty(6 * blocks, dtype=torch.float32, device=device) if fold else None
    ptr = lambda t: None if t is None else t.data_ptr()
    _kernels.launch("build", "grace_morton_keys", device, rows.data_ptr(), ptr(dirs),
                    ptr(lengths), ptr(bmin), ptr(bmax), ptr(parts), keys.data_ptr(), n,
                    rows.stride(0), 0 if fold or bmin.numel() == 1 else 1, bits, blocks)
    morton_keys_cuda.launches += 1
    return keys


def _rows(t: torch.Tensor, name: str) -> torch.Tensor:
    if t.dim() != 2 or t.shape[1] != 3:
        raise ValueError(f"morton keys: {name} must be f32[N, 3], got {tuple(t.shape)}")
    if t.dtype != torch.float32:
        raise ValueError(f"morton keys: {name} must be f32, got {t.dtype}")
    return t if t.stride(1) == 1 and t.stride(0) >= 3 else t.contiguous()


def morton_keys_cuda(centroids, aabb_min, aabb_max, bits: int, _blocks=None) -> torch.Tensor:
    """One launch of ``grace_morton_keys`` on the card: the keys of
    ``centroids`` f32[N, 3] (rows at any stride; a sphere tensor's first
    three columns are read as 16-byte rows) in the box f32[3] (or a scalar)
    ``aabb_min``, ``aabb_max``; a box given as None is the centroids' own,
    folded in the same launch. ``_blocks`` caps the folding grid (the
    tests' route past the items held in registers)."""
    if bits not in (30, 63):
        raise ValueError(f"bits must be 30 or 63, got {bits}")
    rows = _rows(centroids, "centroids")
    _kernels.check_tensors("morton_keys", [], [rows])
    if (aabb_min is None) != (aabb_max is None):   # one edge given: torch's other
        aabb_min = rows.amin(dim=0) if aabb_min is None else aabb_min
        aabb_max = rows.amax(dim=0) if aabb_max is None else aabb_max
    return _launch_keys(rows, None, None, aabb_min, aabb_max, bits, _blocks)


morton_keys_cuda.launches = 0


def ray_keys_cuda(origins, directions, lengths, aabb_min=None, aabb_max=None, bits: int = 30,
                  _blocks=None) -> torch.Tensor:
    """One launch of ``grace_morton_keys`` on the card: the keys of the
    rays' midpoints ``fma(0.5 l, d, o)`` (``spatial_sort_rays``'), formed in
    the launch from ``origins``, ``directions`` f32[R, 3] and ``lengths``
    f32[R], in the given box or, where both edges are None, in the
    midpoints' own box folded in the same launch. Counted in
    ``morton_keys_cuda.launches``."""
    if bits not in (30, 63):
        raise ValueError(f"bits must be 30 or 63, got {bits}")
    o, d = _rows(origins, "origins"), _rows(directions, "directions")
    if o.stride(0) != d.stride(0):
        o, d = o.contiguous(), d.contiguous()
    if lengths.dim() != 1 or lengths.shape[0] != o.shape[0] or d.shape[0] != o.shape[0]:
        raise ValueError("morton keys: origins, directions and lengths must have one row a ray")
    _kernels.check_tensors("ray_keys", [], [o, d, lengths])
    return _launch_keys(o, d, lengths.contiguous(), aabb_min, aabb_max, bits, _blocks)


def morton_keys_from_centroids(centroids, aabb_min=None, aabb_max=None, bits: int = 30,
                               plain: bool = False):
    """Quantize centroids into the scene AABB and compose Morton keys:
    per axis ``u = uint32(span / (top - bot) * (c - bot))`` in f32.

    Returns int64[N] (30-bit keys, or 63-bit keys as one value each):
    through ``morton_keys_cuda`` on CUDA tensors, the plain version on CPU
    tensors or where ``plain`` (which only the checks pass). A box edge
    given as None is the centroids' ``amin`` / ``amax`` (on the card folded
    in the keys' launch).
    """
    centroids = torch.as_tensor(centroids, dtype=torch.float32)
    if bits not in (30, 63):
        raise ValueError(f"bits must be 30 or 63, got {bits}")
    if not (plain or _on_cpu(centroids)):
        return morton_keys_cuda(centroids, aabb_min, aabb_max, bits)
    dev = centroids.device
    aabb_min = centroids.amin(dim=0) if aabb_min is None else aabb_min
    aabb_max = centroids.amax(dim=0) if aabb_max is None else aabb_max
    aabb_min = torch.as_tensor(aabb_min, dtype=torch.float32, device=dev)
    aabb_max = torch.as_tensor(aabb_max, dtype=torch.float32, device=dev)
    return _morton_keys_plain(centroids, aabb_min, aabb_max, bits)
