"""Error handling and debug assertions.

PyTorch counterpart of ``grace_tpu.core.errors``:

  * host-side API validation (``GraceError``, ``require``);
  * ``check_overflow``, the host fetch-and-raise every consumer of a
    capacity-bounded result funnels its overflow flag through;
  * ``debug_assert``, an invariant check enabled by ``GRACE_TPU_DEBUG=1``.
    PyTorch runs eagerly, so it raises instead of printing from a trace.
"""

from __future__ import annotations

import os

import torch


class GraceError(ValueError):
    """Raised on invalid API usage."""


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise GraceError(msg)


def debug_enabled() -> bool:
    return os.environ.get("GRACE_TPU_DEBUG", "0") not in ("", "0", "false")


def check_overflow(flag, msg: str = "capacity overflow") -> None:
    """Raise if an overflow flag (bool or bool tensor) is set anywhere.

    Forces a device-to-host copy: call it outside hot loops."""
    if bool(torch.as_tensor(flag).any()):
        raise GraceError(msg + " — re-run with a larger capacity")


def debug_assert(pred, msg: str = "grace_tpu_torch debug assertion failed"):
    """Invariant check, active only when GRACE_TPU_DEBUG is set."""
    if not debug_enabled():
        return
    if not bool(torch.as_tensor(pred).all()):
        raise GraceError("GRACE_TPU_ASSERT FAILED: " + msg)
