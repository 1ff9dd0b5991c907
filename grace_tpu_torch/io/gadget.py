"""Gadget-2 (format 1) snapshot IO (PyTorch package's copy of
``grace_tpu.io.gadget``; host file IO, numpy arrays).

``read_gadget_gas(path)`` returns f32[N_gas, 4] = (x, y, z, h): gas positions
with smoothing lengths in the .w slot (header, gas positions, skip
velocities/IDs/masses/u/rho, read hsml).

The fast path is the native C++ reader (``io.native``); a numpy version
covers machines without a compiler. ``write_gadget_gas`` fabricates
gas-only snapshots for tests and fixtures.
"""

from __future__ import annotations

import numpy as np
import torch

from grace_tpu_torch.io import native


def _np_read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        raw = f.read()
    off = 0

    def marker():
        nonlocal off
        off += 4

    marker()
    npart = np.frombuffer(raw, np.int32, 6, off); off += 24
    mass = np.frombuffer(raw, np.float64, 6, off); off += 48
    off += 256 - 24 - 48
    marker()
    n_gas = int(npart[0])
    if n_gas == 0:
        raise ValueError(f"Gadget file {path} has no gas particles")
    n_total = int(npart.sum())
    n_withmass = int(npart[mass == 0].sum())

    marker()
    pos = np.frombuffer(raw, np.float32, 3 * n_gas, off).reshape(n_gas, 3)
    off += 12 * n_total
    marker()
    marker(); off += 12 * n_total; marker()   # velocities
    marker(); off += 4 * n_total; marker()    # ids
    if n_withmass > 0:
        marker(); off += 4 * n_withmass; marker()
    marker(); off += 4 * n_gas; marker()      # u
    marker(); off += 4 * n_gas; marker()      # rho
    marker()
    hsml = np.frombuffer(raw, np.float32, n_gas, off)
    out = np.empty((n_gas, 4), np.float32)
    out[:, :3] = pos
    out[:, 3] = hsml
    return out


def read_gadget_gas(path: str) -> np.ndarray:
    """f32[N_gas, 4] (x, y, z, h) from a Gadget-2 format-1 snapshot."""
    lib = native.load()
    if lib is None:
        return _np_read(path)
    import ctypes

    npart = (ctypes.c_int32 * 6)()
    mass = (ctypes.c_double * 6)()
    rc = lib.grace_gadget_header(path.encode(), npart, mass)
    if rc != 0:
        raise IOError(f"failed to read Gadget header from {path} (rc={rc})")
    n_gas = int(npart[0])
    if n_gas == 0:
        raise ValueError(f"Gadget file {path} has no gas particles")
    out = np.empty((n_gas, 4), np.float32)
    rc = lib.grace_gadget_read_gas(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_gas)
    if rc < 0:
        raise IOError(f"failed to read Gadget gas block from {path} (rc={rc})")
    return out


def read_gadget_gas_shard(path: str, shard: int, n_shards: int) -> np.ndarray:
    """Read one contiguous shard of the gas particles.

    The multi-host loading path: hosts load disjoint particle slices, then
    move them to their local cards. Shards partition [0, N_gas) as evenly
    as possible; every host touches only its slice of the positions and
    hsml blocks.
    """
    with open(path, "rb") as f:
        raw_header = f.read(4 + 256 + 4)
        npart = np.frombuffer(raw_header, np.int32, 6, 4)
        mass = np.frombuffer(raw_header, np.float64, 6, 4 + 24)
        n_gas = int(npart[0])
        if n_gas == 0:
            raise ValueError(f"Gadget file {path} has no gas particles")
        n_total = int(npart.sum())
        n_withmass = int(npart[mass == 0].sum())

        lo = (n_gas * shard) // n_shards
        hi = (n_gas * (shard + 1)) // n_shards
        cnt = hi - lo

        pos_block = 4 + 256 + 4 + 4
        f.seek(pos_block + 12 * lo)
        pos = np.frombuffer(f.read(12 * cnt), np.float32).reshape(cnt, 3)

        hsml_block = (
            pos_block + 12 * n_total + 4        # positions + end marker
            + 8 + 12 * n_total                  # velocities
            + 8 + 4 * n_total                   # ids
            + (8 + 4 * n_withmass if n_withmass else 0)
            + 8 + 4 * n_gas                     # u
            + 8 + 4 * n_gas                     # rho
            + 4                                  # hsml start marker
        )
        f.seek(hsml_block + 4 * lo)
        hsml = np.frombuffer(f.read(4 * cnt), np.float32)

    out = np.empty((cnt, 4), np.float32)
    out[:, :3] = pos
    out[:, 3] = hsml
    return out


def write_gadget_gas(path: str, xyzh: np.ndarray) -> None:
    """Write a gas-only format-1 snapshot (test fixture generator); xyzh is
    f32[N, 4], an array or a tensor on any device."""
    if isinstance(xyzh, torch.Tensor):
        xyzh = xyzh.detach().cpu().numpy()
    xyzh = np.ascontiguousarray(xyzh, np.float32)
    lib = native.load()
    if lib is not None:
        import ctypes

        rc = lib.grace_gadget_write_gas(
            path.encode(), xyzh.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            xyzh.shape[0])
        if rc != 0:
            raise IOError(f"failed to write Gadget file {path} (rc={rc})")
        return
    # numpy fallback
    n = xyzh.shape[0]
    with open(path, "wb") as f:
        def block(data: bytes):
            sz = np.uint32(len(data)).tobytes()
            f.write(sz); f.write(data); f.write(sz)

        header = np.zeros(256, np.uint8)
        header[:4] = np.frombuffer(np.int32(n).tobytes(), np.uint8)
        block(header.tobytes())
        block(np.ascontiguousarray(xyzh[:, :3]).tobytes())
        block(np.zeros((n, 3), np.float32).tobytes())
        block(np.arange(n, dtype=np.uint32).tobytes())
        block(np.ones(n, np.float32).tobytes())   # masses (mass[0] == 0)
        block(np.zeros(n, np.float32).tobytes())  # u
        block(np.zeros(n, np.float32).tobytes())  # rho
        block(np.ascontiguousarray(xyzh[:, 3]).tobytes())
