"""Smoke run of grace_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``grace_tpu_torch/csrc`` (nvcc, first use),
checks each kernel against its plain PyTorch version on the card at small
and edge shapes, then drives the column-density render end to end at the
bench scene's size (2^20 clustered particles, 512x512 rays):

    build_sph_tree -> orthographic rays + spatial sort -> bucket_prims_ortho
    -> splat_image (CUDA) and pallas_trace_sph(broadphase="quarter") (CUDA)

and holds the splat image against the trace (max rel err < 1e-3), the
same gate ``bench.py`` applies. Prints stage and kernel times (CUDA
events, warm, median) with the card's name and power limit, a JSON line
describing each kernel, and last a JSON line with ``"ok": true``. Any
failure raises, so the exit code is non-zero and no result line prints.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

CAM = (0.5, 0.5, -2.0)
LOOK = (0.5, 0.5, 0.5)
UP = (0.0, 1.0, 0.0)
VEXT = 1.2
LENGTH = 6.0
N_PARTICLES = 1 << 20
SIDE = 512
MAX_PER_LEAF = 32
TRACE_TILE = 128
SPLAT_TILE = dict(tile_w=32, tile_h=128)
GATE = 1e-3

_GPU = None


def log(msg):
    print(f"[{_GPU}] {msg}", flush=True)


def cuda_ms(fn, reps=5, warm=1):
    """Median device time of fn() in ms, from CUDA events, after warm runs."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_close(name, got, want, rtol, atol):
    """Raise unless |got - want| <= atol + rtol |want| everywhere; returns
    (max abs err, max |want|)."""
    got, want = got.double(), want.double()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    bad = (got - want).abs() > atol + rtol * want.abs()
    err = float((got - want).abs().max())
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} values outside rtol {rtol} "
                             f"atol {atol:.3g}; max abs err {err:.3g}")
    return err, float(want.abs().max())


def check_trace(tag, summary, words, packed, prims, mode, deg):
    """Quarter kernel vs its plain version on the same card tensors."""
    from grace_tpu_torch.trace import pallas_kernel as pk

    got = pk.trace_quarter(summary, words, packed, prims, deg, mode)
    want = pk._trace_quarter_plain(summary, words, packed, prims, deg, mode)
    torch.cuda.synchronize()
    if mode == "hitcount":
        if not torch.equal(got, want):
            raise AssertionError(f"trace {tag} hitcount: {int((got != want).sum())} "
                                 "rays differ")
        return 0.0, float(want.max())
    scale = float(want.abs().max())
    return check_close(f"trace {tag} deg {deg}", got, want, 1e-5, 1e-6 * scale)


def check_splat(tag, buckets, basis, tile_w, tile_h):
    from grace_tpu_torch.trace import splat as sp

    got = sp.splat_image(buckets, tile_w=tile_w, tile_h=tile_h, basis=basis)
    n_bands = buckets.first.shape[0] // ((got.shape[1] // tile_h) * (got.shape[0] // tile_w))
    _, a, b = sp.SPLAT_BASES[basis]
    want = sp._splat_plain(buckets, tile_w, tile_h // n_bands,
                           np.asarray(a, np.float32), np.asarray(b, np.float32))
    torch.cuda.synchronize()
    return check_close(f"splat {tag} {basis}", got, want, 0.0,
                       1e-5 * float(want.abs().max()))


def trace_inputs(rays, spheres, tile):
    """The quarter kernel's inputs, prepared as pallas_trace_sph does."""
    from grace_tpu_torch.trace import pallas_kernel as pk
    from grace_tpu_torch.trace.pallas_broadphase import dense_tile_masks_quarter

    rays = pk._pad_rays(rays, tile)
    packed, _ = pk._pack_rays(rays, tile)
    prims, _ = pk._pack_prims(spheres)
    words, summary = dense_tile_masks_quarter(rays, spheres, tile)
    return summary, words, packed, prims


def small_checks(dev):
    """Kernels vs plain versions at small and edge shapes."""
    from bench import make_clustered_particles
    from grace_tpu_torch.build.sph import build_sph_tree
    from grace_tpu_torch.rays.gen import orthographic_projection_rays, spatial_sort_rays
    from grace_tpu_torch.trace.splat import bucket_prims_ortho

    spheres = torch.from_numpy(make_clustered_particles(np.random.default_rng(7), 3000)).to(dev)
    ss, _, _ = build_sph_tree(spheres, 16)
    # A wide view (extent 4 around a unit box) leaves tiles and bands empty;
    # 50 x 39 = 1950 rays is not a multiple of any tile below.
    rays = orthographic_projection_rays(50, 39, CAM, LOOK, UP, 4.0, LENGTH, device=dev)
    rays_s, _, _ = spatial_sort_rays(rays)
    for tile in (128, 96):
        summary, words, packed, prims = trace_inputs(rays_s, ss, tile)
        if rays_s.n_rays % tile == 0:
            raise AssertionError("edge case lost: ray count is a tile multiple")
        if bool((words != 0).any(dim=1).all()):
            raise AssertionError("edge case lost: every tile overlaps a quarter")
        for mode, deg in (("hitcount", 14), ("cumulative", 14), ("cumulative", -10),
                          ("cumulative", 8), ("cumulative", -12)):
            err, top = check_trace(f"small t{tile} {mode}", summary, words, packed,
                                   prims, mode, deg)
            log(f"check trace kernel vs plain: tile {tile} {mode} deg {deg} "
                f"max abs err {err:.3g} (max value {top:.3g}) OK")
    for band in (32, None):
        b = bucket_prims_ortho(ss, CAM, LOOK, UP, 4.0, LENGTH, 128, 128, chunk=256,
                               band=band, **SPLAT_TILE)
        if not bool((b.first == b.last).any()):
            raise AssertionError("edge case lost: no band without instances")
        for basis in ("deg8", "deg10"):
            err, top = check_splat(f"small band {band}", b, basis, **SPLAT_TILE)
            log(f"check splat kernel vs plain: 128x128 band {band} {basis} "
                f"max abs err {err:.3g} (max value {top:.3g}) OK")


def main():
    global _GPU
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    _GPU = smi
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    run(dev, N_PARTICLES, SIDE)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


def run(dev, n_particles, side):
    """Build, check and time everything on ``dev``; prints the kernels line."""
    from grace_tpu_torch import _kernels
    from grace_tpu_torch.build.sph import build_sph_tree
    from grace_tpu_torch.rays.gen import orthographic_projection_rays, spatial_sort_rays
    from grace_tpu_torch.trace import pallas_kernel as pk
    from grace_tpu_torch.trace import splat as sp

    # 1. build every kernel
    for name in _kernels.KERNELS:
        path, seconds, out = _kernels.build(name)
        ptxas = [l.strip() for l in out.splitlines() if "registers" in l or "spill" in l]
        log(f"build {name}: {seconds:.1f} s -> {path}")
        for line in ptxas:
            log(f"  ptxas {name}: {line}")

    # 2. kernels vs plain versions at small and edge shapes
    small_checks(dev)

    # 3. full-scale main path, the bench scene
    from bench import make_clustered_particles

    spheres = torch.from_numpy(
        make_clustered_particles(np.random.default_rng(2026), n_particles)).to(dev)
    torch.cuda.synchronize()
    pk.trace_quarter.launches = 0
    sp.splat_image.launches = 0
    t0 = time.perf_counter()
    sorted_spheres, tree, _ = build_sph_tree(spheres, MAX_PER_LEAF)
    rays = orthographic_projection_rays(side, side, CAM, LOOK, UP, VEXT, LENGTH, device=dev)
    rays_s, _, inv = spatial_sort_rays(rays)
    buckets = sp.bucket_prims_ortho(sorted_spheres, CAM, LOOK, UP, VEXT, LENGTH,
                                    side, side, chunk=512, band=32, **SPLAT_TILE)
    if bool(buckets.overflow):
        raise AssertionError("splat tile overflow at the bench scene")
    img = sp.splat_image(buckets, basis="deg8", **SPLAT_TILE)
    trace_v, ovf = pk.pallas_trace_sph(rays_s, sorted_spheres, tree, tile=TRACE_TILE,
                                       broadphase="quarter")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"trace_quarter": pk.trace_quarter.launches,
                "splat": sp.splat_image.launches}
    img_trace = trace_v[inv.long()].reshape(side, side)
    for name, a in (("splat image", img), ("trace image", img_trace)):
        if not bool(torch.isfinite(a).all()) or not bool((a != 0).any()):
            raise AssertionError(f"{name}: non-finite or all zero")
    if bool(ovf.any()):
        raise AssertionError("trace overflow flag set")
    rel = float((img - img_trace).abs().max() / img_trace.abs().max())
    if not rel < GATE:
        raise AssertionError(f"splat vs trace rel err {rel:.3g} >= {GATE}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    log(f"main path ({n_particles} particles, {side}x{side} rays): "
        f"{wall:.2f} s wall (kernels already built); splat vs trace rel err {rel:.3e} "
        f"(gate {GATE}); launches {launches}")

    # 4. kernels vs plain versions at the main path's shapes
    summary, words, packed, prims = trace_inputs(rays_s, sorted_spheres, TRACE_TILE)
    trace_err, top = check_trace("full", summary, words, packed, prims, "cumulative", 14)
    check_trace("full", summary, words, packed, prims, "hitcount", 14)
    log(f"check trace kernel vs plain on all {words.shape[0]} tiles (cumulative deg 14, "
        f"hitcount): max abs err {trace_err:.3g} (max value {top:.3g}) OK")
    splat_err, top = check_splat("full", buckets, "deg8", **SPLAT_TILE)
    log(f"check splat kernel vs plain at {side}x{side}: max abs err {splat_err:.3g} "
        f"(max value {top:.3g}) OK")

    # 5. times (CUDA events, warm, median)
    t = {}
    t["build_sph_tree"] = cuda_ms(lambda: build_sph_tree(spheres, MAX_PER_LEAF), reps=3)
    t["rays+sort"] = cuda_ms(lambda: spatial_sort_rays(orthographic_projection_rays(
        side, side, CAM, LOOK, UP, VEXT, LENGTH, device=dev)))
    t["bucket_prep"] = cuda_ms(lambda: sp.bucket_prims_ortho(
        sorted_spheres, CAM, LOOK, UP, VEXT, LENGTH, side, side, chunk=512, band=32,
        **SPLAT_TILE))
    a8, b8 = (np.asarray(c, np.float32) for c in sp.SPLAT_BASES["deg8"][1:])
    t["splat kernel"] = cuda_ms(lambda: sp.splat_image(buckets, basis="deg8", **SPLAT_TILE))
    t["splat plain"] = cuda_ms(lambda: sp._splat_plain(buckets, 32, 32, a8, b8), reps=3)
    t["masks_quarter"] = cuda_ms(lambda: trace_inputs(rays_s, sorted_spheres, TRACE_TILE))
    t["trace kernel"] = cuda_ms(lambda: pk.trace_quarter(summary, words, packed, prims,
                                                         14, "cumulative"))
    t["trace plain"] = cuda_ms(lambda: pk._trace_quarter_plain(summary, words, packed,
                                                               prims, 14, "cumulative"),
                               reps=3)
    t["pallas_trace_sph"] = cuda_ms(lambda: pk.pallas_trace_sph(
        rays_s, sorted_spheres, tree, tile=TRACE_TILE, broadphase="quarter"))
    for k, v in t.items():
        log(f"time {k}: {v:.3f} ms")

    print(json.dumps({"kernels": [
        {"name": "trace_quarter", "route": "cuda",
         "source": "grace_tpu_torch/csrc/trace_quarter.cu",
         "replaces": "grace_tpu/trace/pallas_kernel.py:348",
         "launches": launches["trace_quarter"], "max_abs_err": trace_err,
         "ms": t["trace kernel"], "plain_ms": t["trace plain"]},
        {"name": "splat", "route": "cuda", "source": "grace_tpu_torch/csrc/splat.cu",
         "replaces": "grace_tpu/trace/splat.py:282",
         "launches": launches["splat"], "max_abs_err": splat_err,
         "ms": t["splat kernel"], "plain_ms": t["splat plain"]},
    ]}), flush=True)


if __name__ == "__main__":
    main()
