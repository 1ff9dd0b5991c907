"""A numpy model of ``csrc/build.cu``'s ``grace_morton_keys`` (E2's keys),
written as the kernel indexes its threads, for the CPU tests.

``model_morton_keys`` takes the C entry's arguments (host addresses of CPU
tensors in place of device pointers) and writes the keys, and without a
given box the blocks' partial boxes, the way the launch does: the rows read
as spheres (stride 4 at a 16-byte aligned base), centroids or rays (the
midpoint formed as vecmath.fma forms it); without a box a grid of at most
``RESIDENT`` blocks of ``THREADS`` threads, item i taken by thread i % (blocks
x threads) in ascending order, each thread's box folded in torch.amin /
amax's rule, then over the warp by a shuffle butterfly and over the block's
warps in order, the partial boxes folded the same way by every block; the
span over the box once a block, f32 products, the saturating conversion
(NaN to 0), the bits spread and interleaved. ``ROUTES`` records each
launch's (source, "given" or "fold", and "reread" where items pass the
``HELD`` a thread keeps in registers).

``model_launch`` (a fixture) sends ``_kernels.launch`` of that entry to the
model and makes ``ops.morton._on_cpu`` say "not the CPU", so that the
port's public functions take the kernel route on CPU tensors.
"""

import ctypes
import os
import re

import numpy as np
import pytest

from grace_tpu_torch import _kernels
from grace_tpu_torch.ops import morton

_SRC = open(os.path.join(_kernels.CSRC, "build.cu")).read()
THREADS = int(re.search(r"constexpr int kThreads = (\d+);", _SRC).group(1))
HELD = int(re.search(r"constexpr int kHeld = (\d+);", _SRC).group(1))
RESIDENT = int(re.search(r"constexpr int kFoldBlocksPerSm = (\d+);", _SRC).group(1)) * 132
ROUTES = []


def _view(ptr, ctype, count):
    if count == 0:
        return np.zeros(0, np.ctypeslib.as_array((ctype * 1)()).dtype)
    return np.ctypeslib.as_array((ctype * count).from_address(ptr))


def amin_step(a, b):
    """torch.amin's step on the card: a NaN accumulator sticks, else the
    strictly smaller, else the later operand (a NaN operand then wins)."""
    return np.where(np.isnan(a) | (a < b), a, b)


def amax_step(a, b):
    return np.where(np.isnan(a) | (a > b), a, b)


def _fold(box, other):
    return np.concatenate([amin_step(box[..., :3], other[..., :3]),
                           amax_step(box[..., 3:], other[..., 3:])], axis=-1)


def _block_fold(per_thread):
    """[..., threads, 6] thread boxes -> [..., 6]: the warp's butterfly
    (lane l folds lane l ^ o in), lane 0 of each warp, the warps in order."""
    lanes = per_thread.reshape(per_thread.shape[:-2] + (THREADS // 32, 32, 6))
    for o in (16, 8, 4, 2, 1):
        lanes = _fold(lanes, lanes[..., np.arange(32) ^ o, :])
    acc = lanes[..., 0, 0, :]
    for w in range(1, THREADS // 32):
        acc = _fold(acc, lanes[..., w, 0, :])
    return acc


def _thread_boxes(boxes, n_threads):
    """Each of ``n_threads`` threads' fold of the boxes [n, 6] i = t, t +
    n_threads, ... in that order: [n_threads, 6] (the empty box where a
    thread has none)."""
    trips = max(1, -(-boxes.shape[0] // n_threads))
    ident = np.array([np.inf] * 3 + [-np.inf] * 3, np.float32)
    items = np.tile(ident, (trips * n_threads, 1))
    items[:boxes.shape[0]] = boxes
    items = items.reshape(trips, n_threads, 6)
    acc = items[0]
    for k in range(1, trips):
        acc = _fold(acc, items[k])
    return acc


def spread(u, bits):
    """space_by_two_10bit / _21bit on int64 values."""
    if bits == 30:
        x = u & ((1 << 10) - 1)
        for shift, mask in ((16, 0x030000FF), (8, 0x0300F00F), (4, 0x030C30C3),
                            (2, 0x09249249)):
            x = (x | (x << shift)) & mask
        return x
    x = u & ((1 << 21) - 1)
    for shift, mask in ((32, 0x001F00000000FFFF), (16, 0x001F0000FF0000FF),
                        (8, 0x100F00F00F00F00F), (4, 0x10C30C30C30C30C3),
                        (2, 0x1249249249249249)):
        x = (x | (x << shift)) & mask
    return x


def model_morton_keys(rows, dirs, lengths, box_min, box_max, parts, keys, n, stride,
                      box_stride, bits, max_blocks):
    assert n > 0 and stride >= 3 and bits in (30, 63) and (not box_min) == (not box_max)
    fold = not box_min
    src = "rays" if dirs else ("spheres" if stride == 4 and rows % 16 == 0 else "centroids")
    idx = np.arange(n)[:, None] * stride + np.arange(3)
    count = (n - 1) * stride + (4 if src == "spheres" else 3)
    r = _view(rows, ctypes.c_float, count)
    if src == "rays":
        d = _view(dirs, ctypes.c_float, count)[idx]
        h = np.float32(0.5) * _view(lengths, ctypes.c_float, n)
        pts = (h[:, None].astype(np.float64) * d.astype(np.float64)
               + r[idx].astype(np.float64)).astype(np.float32)
    else:
        pts = r[idx]
    route = [src, "fold" if fold else "given"]
    if fold:
        assert max_blocks >= 1
        blocks = min(RESIDENT, -(-n // THREADS), max_blocks)
        points = np.concatenate([pts, pts], axis=1)
        part = _block_fold(_thread_boxes(points, blocks * THREADS).reshape(blocks, THREADS, 6))
        _view(parts, ctypes.c_float, 6 * max_blocks)[:6 * blocks] = part.reshape(-1)
        # after the grid's barrier every block folds the partial boxes, thread
        # t those of blocks t, t + THREADS, ...
        box = _block_fold(_thread_boxes(part, THREADS))
        lo, hi = box[:3], box[3:]
        if n > HELD * blocks * THREADS:
            route.append("reread")
    else:
        assert box_stride in (0, 1)
        bmin = _view(box_min, ctypes.c_float, 1 + 2 * box_stride)
        bmax = _view(box_max, ctypes.c_float, 1 + 2 * box_stride)
        lo = np.array([bmin[k * box_stride] for k in range(3)], np.float32)
        hi = np.array([bmax[k * box_stride] for k in range(3)], np.float32)
    ROUTES.append(tuple(route))
    span = np.float32((1 << 10) - 1 if bits == 30 else (1 << 21) - 1)
    with np.errstate(all="ignore"):
        scale = span / (hi - lo)
        v = scale * (pts - lo)
    # cvt.rzi.u32.f32: toward zero, saturating, NaN -> 0
    u = np.where(np.isnan(v), 0.0, np.clip(v.astype(np.float64), 0.0, 2.0 ** 32 - 1))
    u = u.astype(np.int64)
    s = [spread(u[:, k], bits) for k in range(3)]
    _view(keys, ctypes.c_int64, n)[:] = (s[2] << 2) | (s[1] << 1) | s[0]


@pytest.fixture
def model_launch(monkeypatch):
    """The keys' launches sent to the model (their argument kinds checked
    against ``_kernels.KERNELS``), ``morton._on_cpu`` made to say "not the
    CPU"; returns the list of entries launched."""
    calls = []

    def launch(name, entry, device, *args):
        kinds = _kernels.KERNELS[name][2][entry]
        assert (name, entry) == ("build", "grace_morton_keys") and len(args) == len(kinds)
        for a, k in zip(args, kinds):
            assert (isinstance(a, int) and not isinstance(a, bool)) or (k == "p" and a is None)
        calls.append(entry)
        model_morton_keys(*args)

    monkeypatch.setattr(_kernels, "launch", launch)
    monkeypatch.setattr(morton, "_on_cpu", lambda t: False)
    ROUTES.clear()
    return calls
