"""Component-wise extrema reductions (PyTorch counterpart of
``grace_tpu.ops.extrema``): min and max over axis 0 of f32[N, C] points,
C = 2, 3 or 4. The results are exact (a min or max rounds nothing)."""

from __future__ import annotations

from typing import Tuple

import torch


def min_vec(points) -> torch.Tensor:
    """Component-wise minimum over axis 0 of f32[N, C]."""
    return torch.as_tensor(points).amin(dim=0)


def max_vec(points) -> torch.Tensor:
    """Component-wise maximum over axis 0 of f32[N, C]."""
    return torch.as_tensor(points).amax(dim=0)


def min_max(points) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min, max) pair over axis 0."""
    points = torch.as_tensor(points)
    return points.amin(dim=0), points.amax(dim=0)


def min_max_component(points, component: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min, max) of one component."""
    col = torch.as_tensor(points)[:, component]
    return col.amin(), col.amax()
