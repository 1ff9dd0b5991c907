"""Build and bind the hand-written CUDA kernels in ``csrc/``.

Each kernel source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, at first use, into ``_kernels_build/``
beside this file; the file name carries a hash of every ``csrc/`` source and
of the flags, so an edited source builds anew. The library is loaded with
``ctypes``. Each C entry point takes the CUDA device index and stream last,
launches on that stream without synchronizing, and returns
``cudaGetLastError()``; ``launch`` raises if that is not 0.

Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_kernels_build")

_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> (source, extra nvcc flags, {entry point: argument kinds}); kinds
# are "p" (pointer: to device memory, or for a ``*_resources`` query to a
# host int[5]) and "i" (int); the device index and the stream follow them.
KERNELS = {
    # --fmad=false (the trace kernels): the hit test must round b^2 exactly
    # as the plain version does; the fused multiply-adds it wants are
    # written as fmaf.
    "trace_quarter": ("trace_quarter.cu", ["--fmad=false"],
                      {"grace_trace_quarter": "pppppp" + "iiiiiii"}),
    "trace_bitmask": ("trace_bitmask.cu", ["--fmad=false"],
                      {"grace_trace_bitmask": "pppppp" + "iiiiii",
                       "grace_trace_bitmask_resources": "pi"}),
    "trace_list": ("trace_list.cu", ["--fmad=false"],
                   {"grace_trace_list": "ppppppp" + "iiiiiii",
                    "grace_trace_list_resources": "pi"}),
    "splat": ("splat.cu", [],
              {"grace_splat": "ppppppppppp" + "iiiiiiiiii",
               "grace_splat_resources": "p" + "iiiii"}),
    "splat_sortfree": ("splat_sortfree.cu", ["--fmad=false"],
                       {"grace_splat_sortfree_fwd": "ppppppp" + "iiiiiiiiiii",
                        "grace_splat_sortfree_fwd_resources": "p" + "iiiii",
                        "grace_splat_sortfree_bwd": "ppppppp" + "iiiiiiiii",
                        "grace_splat_sortfree_bwd_resources": "p" + "iiii"}),
    "render": ("render.cu", ["--fmad=false"],
               {"grace_render_fwd": "ppppppp" + "iiii",
                "grace_render_fwd_resources": "pi",
                "grace_render_bwd": "pppppp" + "iii",
                "grace_render_bwd_resources": "p"}),
    "records": ("records.cu", ["--fmad=false"],
                {"grace_records_quarter": "pppppppppp" + "iiiiiii",
                 "grace_records_bitmask": "ppppppppp" + "iiiiii",
                 "grace_records_quarter_resources": "pi",
                 "grace_records_bitmask_resources": "pi"}),
    "tri": ("tri.cu", ["--fmad=false"],
            {"grace_tri": "ppppppp" + "iiiiii",
             "grace_tri_resources": "pi"}),
    "bvh_walk": ("bvh_walk.cu", ["--fmad=false"],
                 {"grace_walk_sph": "p" * 17 + "i" * 10,
                  "grace_walk_tri": "p" * 13 + "i" * 8,
                  "grace_walk_resources": "piii"}),
    # the LBVH build: --fmad=false keeps the keys', boxes' and deltas' f32
    # rounding the plain build's
    "build": ("build.cu", ["--fmad=false"],
              {"grace_morton_keys": "ppppppp" + "iiiii",
               "grace_deltas": "pppp" + "iiii",
               "grace_gather_deltas": "pppppppp" + "iii",
               "grace_lbvh_ranges": "pppppp" + "iiii",
               "grace_lbvh_nodes": "p" * 15 + "iiii",
               "grace_build_resources": "pii"}),
    # the splat's two setups (bucketed: keys and counts, then the counts'
    # scan and the slabs;
    # the sort-free projection, slabs and masks): --fmad=false keeps the
    # projections' and quotients' f32 rounding the plain path's
    "splat_prep": ("splat_prep.cu", ["--fmad=false"],
                   {"grace_splat_bucket_keys": "pppp" + "iiiii",
                    "grace_splat_bucket_pack": "ppppppp" + "iiiiiii",
                    "grace_splat_bucket_resources": "pi",
                    "grace_sortfree_setup": "ppppppp" + "iii",
                    "grace_sortfree_setup_resources": "p"}),
    # the dense broadphase (both box sets in one launch, overlap words,
    # their compaction) and the triangle trace's segment lists: --fmad=false keeps
    # the endpoints' and distances' rounding the plain versions'
    "broadphase": ("broadphase.cu", ["--fmad=false"],
                   {"grace_broadphase_boxes": "pppppppp" + "iiii",
                    "grace_broadphase_boxes_resources": "pi",
                    "grace_overlap_words": "pppppp" + "ii",
                    "grace_overlap_words_resources": "p",
                    "grace_compact_words": "pppp" + "iii",
                    "grace_compact_words_resources": "pi"}),
    "tri_lists": ("tri_lists.cu", ["--fmad=false"],
                  {"grace_tri_tile_lists": "p" * 12 + "i" * 8,
                   "grace_tri_tile_lists_resources": "p" + "i" * 5}),
    # the per-hit records' post-processing: the record rows' sort, the CSR
    # sort by distance (heads, starts, a warp a segment; long segments
    # checked for order, the others in chunks, merged, gathered) and the
    # flat layout; no float arithmetic
    "segsort": ("segsort.cu", [],
                {"grace_sort_rows": "pppppp" + "ii",
                 "grace_seg_heads": "ppp" + "ii",
                 "grace_seg_count": "pp" + "i",
                 "grace_seg_starts": "ppp" + "i",
                 "grace_segmented_sort": "pppppppp" + "iii",
                 "grace_seg_long_scan": "ppppp" + "ii",
                 "grace_seg_check": "ppppppp" + "ii",
                 "grace_seg_chunks": "p" * 9 + "iii",
                 "grace_seg_merge": "p" * 9 + "iii",
                 "grace_seg_gather": "p" * 8 + "iiii",
                 "grace_records_to_flat": "p" * 10 + "i" * 8,
                 "grace_segsort_resources": "pii"}),
    # The dense contractions that splat.cu and splat_sortfree.cu's forward
    # replaced, each with its file's flags: the references those kernels
    # are held bit-equal to on the card. No wrapper launches them.
    "splat_dense": ("splat_dense.cu", [],
                    {"grace_splat_dense": "pppppppppp" + "iiiiiiiiii"}),
    "splat_sortfree_dense": ("splat_sortfree_fwd_dense.cu", ["--fmad=false"],
                             {"grace_splat_sortfree_fwd_dense": "pppppp" + "iiiiiiiiiii"}),
}

_LIBS: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    found = path if os.path.exists(path) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "build only on a machine with the CUDA toolkit")
    return found


def _library_path(name: str) -> str:
    source, flags, _ = KERNELS[name]
    h = hashlib.sha256()
    for f in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read())
    h.update(" ".join(_NVCC_FLAGS + flags).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(name: str) -> tuple[str, float, str]:
    """Compile kernel ``name`` if its library is missing. Returns (library
    path, seconds spent compiling, nvcc's output)."""
    source, flags, _ = KERNELS[name]
    lib = _library_path(name)
    if os.path.exists(lib):
        return lib, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *_NVCC_FLAGS, *flags, "-o", tmp, os.path.join(CSRC, source)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, lib)
    return lib, seconds, log


def build_all() -> dict:
    """Build every kernel library at once, one nvcc process each. Returns
    {name: (library path, seconds, nvcc's output)}."""
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        return dict(zip(KERNELS, pool.map(build, KERNELS)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    if name not in _LIBS:
        path, _, _ = build(name)
        lib = ctypes.CDLL(path)
        for entry, kinds in KERNELS[name][2].items():
            fn = getattr(lib, entry)
            fn.argtypes = ([ctypes.c_void_p if k == "p" else ctypes.c_int for k in kinds]
                           + [ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.grace_error_string.argtypes = [ctypes.c_int]
        lib.grace_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def check_tensors(name: str, ints, floats) -> torch.device:
    """The checks every kernel wrapper makes: one device (CPU or CUDA) for
    all tensors, i32 ``ints`` and f32 ``floats``. Returns the device."""
    devs = {t.device for t in (*ints, *floats)}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {devs}")
    if any(t.dtype != torch.int32 for t in ints) or any(
            t.dtype != torch.float32 for t in floats):
        raise TypeError(f"{name}: expected i32 masks/lists and f32 values")
    device = devs.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
    return device


def launch(name: str, entry: str, device: torch.device, *args) -> None:
    """Call C entry point ``entry`` of kernel ``name`` with ``args`` on
    ``device``'s current stream; raise on a CUDA error."""
    lib = load(name)
    kinds = KERNELS[name][2][entry]
    if len(args) != len(kinds):
        raise TypeError(f"{entry} takes {len(kinds)} arguments, got {len(args)}")
    index = device.index if device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(index).cuda_stream
    rc = getattr(lib, entry)(*args, index, stream)
    if rc != 0:
        msg = lib.grace_error_string(rc).decode()
        raise RuntimeError(f"{entry} failed: CUDA error {rc} ({msg})")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address, as the kernels that
    stage it with 16-byte ``cp.async`` copies need (a fresh copy if not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def longest_first(counts: torch.Tensor) -> torch.Tensor:
    """Launch order of a kernel's work units (ray tiles, segments) whose
    walks over their lists are serial: longest list first. The longest
    walks set the kernel's end; started first, they run while the short
    ones fill the card around them."""
    return torch.argsort(counts, descending=True, stable=True)


RESOURCE_FIELDS = ("registers", "shared_bytes", "threads", "blocks_per_sm", "warps_per_sm")


def resources(name: str, entry: str, device: torch.device, *ints) -> dict:
    """What one launch of a kernel holds on ``device``, from its C query
    ``entry``: registers a thread, shared bytes a block, threads a block,
    and resident blocks and warps an SM (the CUDA occupancy calculator)."""
    out = (ctypes.c_int * len(RESOURCE_FIELDS))()
    launch(name, entry, device, ctypes.addressof(out), *ints)
    return dict(zip(RESOURCE_FIELDS, out))
