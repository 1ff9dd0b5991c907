"""Core types: SoA ray batches, sphere packing, octant and ray-sort enums.

PyTorch counterpart of ``grace_tpu.core.types``. A logical ray r is
(origin[r], direction[r], length[r]); direction is always normalized.

Functions that make tensors from Python or numpy values put them on the
card unless the caller passes ``device`` (``creation_device``); functions
that take tensors follow their inputs' device.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch


def creation_device(device=None, like=None) -> torch.device:
    """The device a creator puts new tensors on: ``device`` if given, else
    the device of ``like`` if that is a tensor, else the CUDA card. Raises
    when that is CUDA and no card is present: a creator never falls back
    to the CPU (pass ``device="cpu"`` for CPU tensors)."""
    if device is None:
        device = like.device if isinstance(like, torch.Tensor) else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("grace_tpu_torch creates tensors on the CUDA card by "
                           "default and none is available; pass device='cpu'")
    return device


class Octants(enum.IntEnum):
    """Octant encoding; bit 2 = +x, bit 1 = +y, bit 0 = +z."""

    MMM = 0
    MMP = 1
    MPM = 2
    MPP = 3
    PMM = 4
    PMP = 5
    PPM = 6
    PPP = 7


class RaySortType(enum.IntEnum):
    """Ray-coherence sorting strategies."""

    NoSort = 0
    DirectionSort = 1
    EndPointSort = 2


@dataclass
class Rays:
    """Batch of rays in SoA layout.

    Attributes:
      origins:    f32[R, 3] ray origins.
      directions: f32[R, 3] normalized ray directions.
      lengths:    f32[R]    maximum parametric distance along each ray.
    """

    origins: torch.Tensor
    directions: torch.Tensor
    lengths: torch.Tensor

    @property
    def n_rays(self) -> int:
        return self.origins.shape[0]

    @property
    def device(self) -> torch.device:
        return self.origins.device

    @classmethod
    def from_arrays(cls, origins, directions, lengths, device=None) -> "Rays":
        """Rays on ``device`` (default: the origins' device if they are a
        tensor, else the CUDA card)."""
        device = creation_device(device, like=origins)
        f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
        return cls(f(origins), f(directions), f(lengths))

    def to(self, device) -> "Rays":
        return Rays(self.origins.to(device), self.directions.to(device),
                    self.lengths.to(device))

    def __getitem__(self, idx) -> "Rays":
        return Rays(self.origins[idx], self.directions[idx], self.lengths[idx])


def make_spheres(xyz, h, device=None) -> torch.Tensor:
    """Pack sphere/SPH-particle data as f32[N, 4] = (x, y, z, h), on
    ``device`` (default: xyz's device if it is a tensor, else the CUDA
    card)."""
    xyz = torch.as_tensor(xyz, dtype=torch.float32, device=creation_device(device, like=xyz))
    h = torch.as_tensor(h, dtype=torch.float32, device=xyz.device)
    return torch.cat([xyz, h[:, None]], dim=1)


def octant_signs(octant: int) -> np.ndarray:
    """(sx, sy, sz) in {-1, +1} for an Octants value."""
    o = int(octant)
    return np.array(
        [1.0 if (o & 4) else -1.0, 1.0 if (o & 2) else -1.0, 1.0 if (o & 1) else -1.0],
        dtype=np.float32,
    )
