"""Vector math over the last axis of [..., 3] tensors.

``grace_tpu``'s compiled (XLA) code contracts ``a * b + c`` into a fused
multiply-add, rounding once; the port does the same, through ``fma``, at
every such place that feeds an exact result (keys, masks, hit counts), so
its values match ``grace_tpu``'s bit for bit. XLA fuses the left product
of a sum (``a*b + c*d`` -> ``fma(a, b, c*d)``) and chains a reduction's
products (``sum(x*x)`` -> ``fma(x2, x2, fma(x1, x1, x0*x0))``).
``normalize3_unfused`` is the form ``grace_tpu``'s eager (op-by-op) calls
compute instead, as its ray generators run.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools

import torch


def _t(a) -> torch.Tensor:
    return torch.as_tensor(a)


def _f64(*xs) -> bool:
    """True if an operand is an f64 tensor (not a scalar): the f64 path
    then stays in f64, where no rounding is mirrored."""
    return any(x.dtype == torch.float64 and x.dim() > 0 for x in xs)


def fma(a, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once. The f32 product is exact in f64, so
    only the sum rounds twice (f64, then f32); that differs from a true
    fused multiply-add in about one case in 2^28. f64 operands give the
    f64 ``a * b + c``."""
    a, b, c = _t(a), _t(b), _t(c)
    r = a.double() * b.double() + c.double()
    return r if _f64(a, b, c) else r.float()


def matmul_f32(a, b) -> torch.Tensor:
    """``a @ b`` with every f32 product kept in full f32: TensorFloat-32,
    which keeps a 10-bit mantissa, is switched off for the call and the
    caller's setting is restored after it, also when the product raises.
    The switch is ``torch.backends.cuda.matmul.fp32_precision`` ("ieee")
    where torch has it (2.9 and later; there, reading the legacy
    ``allow_tf32`` raises once a caller has set the new switch), else
    ``torch.backends.cuda.matmul.allow_tf32``. Both are what
    ``torch.set_float32_matmul_precision`` sets for cuBLAS."""
    m = torch.backends.cuda.matmul
    name, off = (("fp32_precision", "ieee") if hasattr(m, "fp32_precision")
                 else ("allow_tf32", False))
    saved = getattr(m, name)
    setattr(m, name, off)
    try:
        return a @ b
    finally:
        setattr(m, name, saved)


def sqrt(x) -> torch.Tensor:
    """Correctly rounded f32 square root. (PyTorch's vectorized CPU sqrt
    is not always; the f64 root rounded to f32 is.) f64 stays f64."""
    x = _t(x)
    r = torch.sqrt(x.double())
    return r if _f64(x) else r.float()


def dot3(a, b):
    """Dot product over the last axis."""
    a, b = _t(a), _t(b)
    return fma(a[..., 2], b[..., 2], fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def cross(a, b):
    """3D cross product over the last axis."""
    a, b = _t(a), _t(b)
    return torch.stack([
        fma(a[..., 1], b[..., 2], -(a[..., 2] * b[..., 1])),
        fma(a[..., 2], b[..., 0], -(a[..., 0] * b[..., 2])),
        fma(a[..., 0], b[..., 1], -(a[..., 1] * b[..., 0])),
    ], dim=-1)


def norm3(a):
    return sqrt(dot3(a, a))


def normalize3(a):
    """Normalize over the last axis."""
    a = _t(a)
    inv = 1.0 / norm3(a)
    return a * inv[..., None]


def normalize3_unfused(a):
    """Normalize over the last axis as eager ops do: each product rounded,
    summed left to right, then a correctly rounded root."""
    a = _t(a)
    p = a * a
    inv = 1.0 / sqrt((p[..., 0] + p[..., 1]) + p[..., 2])
    return a * inv[..., None]


def sgn(x):
    """Sign in {-1, 0, 1} as int32."""
    x = _t(x)
    return (x > 0).to(torch.int32) - (x < 0).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _tanf():
    fn = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6").tanf
    fn.argtypes, fn.restype = [ctypes.c_float], ctypes.c_float
    return fn


def tan_f32(x: float) -> float:
    """The f32 tangent of the f32 nearest ``x``, as the C library's
    ``tanf`` computes it. That is the value compiled XLA gives on the CPU
    (``jnp.tan``); it is not always the correctly rounded one (at pi/6 it
    is the other neighbour), and PyTorch's CPU ``tan`` differs from it."""
    return float(_tanf()(float(x)))
