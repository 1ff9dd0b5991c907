"""Wall-clock stage timer (PyTorch counterpart of ``grace_tpu.utils.timers``).

Work on the card runs asynchronously: ``split`` and ``elapsed`` first
synchronize every CUDA device that holds a tensor of ``sync_on`` (a tensor
or a tuple, list, dict or dataclass of them). Given nothing, or CPU
tensors only, they do not synchronize.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch


def _cuda_devices(x, found: set) -> set:
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            found.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, found)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _cuda_devices(v, found)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _cuda_devices(getattr(x, f.name), found)
    return found


def _sync(x=None):
    for device in _cuda_devices(x, set()):
        torch.cuda.synchronize(device)


class Timer:
    """start() ... split(x) ... elapsed(x): millisecond stage timings."""

    def __init__(self):
        self._t0: Optional[float] = None
        self._last: Optional[float] = None

    def start(self) -> "Timer":
        self._t0 = self._last = time.perf_counter()
        return self

    def split(self, sync_on=None) -> float:
        """ms since the last split (synchronizing on ``sync_on`` first)."""
        _sync(sync_on)
        now = time.perf_counter()
        dt = (now - self._last) * 1e3
        self._last = now
        return dt

    def elapsed(self, sync_on=None) -> float:
        """ms since start()."""
        _sync(sync_on)
        return (time.perf_counter() - self._t0) * 1e3
