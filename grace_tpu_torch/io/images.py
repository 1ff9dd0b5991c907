"""Image output helpers (PyTorch package's copy of ``grace_tpu.io.images``):
a linear gray colormap and a 24-bit BMP writer. Both take numpy arrays or
tensors on any device."""

from __future__ import annotations

import numpy as np
import torch

from grace_tpu_torch.io import native


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a


def to_colormap(values: np.ndarray, log_scale: bool = False) -> np.ndarray:
    """Map scalar image [H, W] to u8 RGB [H, W, 3] by a linear gray map;
    optional log scaling (column densities are log-scaled before writing)."""
    img = np.asarray(_host(values), np.float64)
    if log_scale:
        pos = img[img > 0]
        floor = pos.min() if pos.size else 1.0
        img = np.log10(np.maximum(img, floor))
    lo, hi = float(img.min()), float(img.max())
    scale = 255.0 / (hi - lo) if hi > lo else 0.0
    gray = ((img - lo) * scale).astype(np.uint8)
    return np.repeat(gray[:, :, None], 3, axis=2)


def write_bmp(path: str, rgb: np.ndarray) -> None:
    """Write u8 RGB [H, W, 3] as a 24-bit BMP."""
    rgb = np.ascontiguousarray(_host(rgb), np.uint8)
    h, w, _ = rgb.shape
    lib = native.load()
    if lib is not None:
        import ctypes

        rc = lib.grace_write_bmp(
            path.encode(), rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), w, h)
        if rc != 0:
            raise IOError(f"failed to write BMP {path} (rc={rc})")
        return
    # numpy fallback
    row_bytes = (3 * w + 3) & ~3
    data = np.zeros((h, row_bytes), np.uint8)
    bgr = rgb[::-1, :, ::-1].reshape(h, w * 3)
    data[:, : w * 3] = bgr
    header = bytearray(54)
    header[0:2] = b"BM"
    file_size = 54 + data.size
    header[2:6] = int(file_size).to_bytes(4, "little")
    header[10:14] = (54).to_bytes(4, "little")
    header[14:18] = (40).to_bytes(4, "little")
    header[18:22] = int(w).to_bytes(4, "little")
    header[22:26] = int(h).to_bytes(4, "little")
    header[26:28] = (1).to_bytes(2, "little")
    header[28:30] = (24).to_bytes(2, "little")
    header[34:38] = int(data.size).to_bytes(4, "little")
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(data.tobytes())
