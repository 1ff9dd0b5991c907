"""Build and load the native IO library (``src/native/grace_io.cpp``).

The library reads Gadget-2 snapshots and PLY meshes and writes BMP images.
It compiles with ``g++ -O3 -shared -fPIC`` at first use into
``grace_tpu_torch/_kernels_build/``, under a file name that carries a hash
of the source and the flags, so an edited source builds anew, and binds
through ctypes. Without a compiler ``load`` returns None and the sibling
modules use their numpy versions; ``build_error`` then says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Optional

_PKG = pathlib.Path(__file__).resolve().parents[1]
SRC = _PKG.parent / "src" / "native" / "grace_io.cpp"
BUILD_DIR = _PKG / "_kernels_build"
_FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
build_error: Optional[str] = None


def library_path() -> pathlib.Path:
    h = hashlib.sha256(SRC.read_bytes() + " ".join(_FLAGS).encode())
    return BUILD_DIR / f"libgrace_io-{h.hexdigest()[:16]}.so"


def _compile(lib: pathlib.Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    res = subprocess.run(["g++", *_FLAGS, "-o", tmp, str(SRC)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise OSError(f"g++ failed for {SRC}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib)


def load() -> Optional[ctypes.CDLL]:
    """The native library, or None if it cannot be built or loaded."""
    global _lib, _tried, build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib_path = library_path()
            if not lib_path.exists():
                _compile(lib_path)
            lib = ctypes.CDLL(str(lib_path))
        except OSError as e:
            build_error = str(e)
            return None
        lib.grace_gadget_header.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double)]
        lib.grace_gadget_header.restype = ctypes.c_int
        lib.grace_gadget_read_gas.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        lib.grace_gadget_read_gas.restype = ctypes.c_int
        lib.grace_gadget_write_gas.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        lib.grace_gadget_write_gas.restype = ctypes.c_int
        lib.grace_ply_counts.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long)]
        lib.grace_ply_counts.restype = ctypes.c_int
        lib.grace_ply_read.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
        lib.grace_ply_read.restype = ctypes.c_int
        lib.grace_write_bmp.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int]
        lib.grace_write_bmp.restype = ctypes.c_int
        _lib = lib
        return _lib
