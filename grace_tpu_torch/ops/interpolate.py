"""Table interpolation (PyTorch counterpart of ``grace_tpu.ops.interpolate``).

``lerp`` linearly interpolates a lookup table at fractional index x in
[0, N); x >= N - 1 clamps to the last entry. ``t * (y1 - y0) + y0`` is one
fused multiply-add, as compiled XLA forms it.
"""

from __future__ import annotations

import torch

from grace_tpu_torch.ops.vecmath import fma


def lerp(x, table) -> torch.Tensor:
    """Interpolate ``table`` (f32[N]) at fractional indices ``x`` (f32[...]).

    Requires x >= 0; x >= N - 1 clamps to table[N - 1].
    """
    x = torch.as_tensor(x)
    table = torch.as_tensor(table, dtype=x.dtype, device=x.device)
    n = table.shape[0]
    idx = torch.clamp(x.to(torch.int32), 0, n - 2).long()
    xc = torch.clamp(x, max=float(n - 1))
    y0 = table[idx]
    y1 = table[idx + 1]
    t = xc - idx.to(x.dtype)
    return fma(t, y1 - y0, y0)
