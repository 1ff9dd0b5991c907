"""Smoke run of grace_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``grace_tpu_torch/csrc`` (nvcc, first use, one
process per source, all at once), checks each kernel against its plain
PyTorch version on the card at small and edge shapes, holds every
``pallas_trace_sph`` route against the generic BVH engine, runs the driver
entry's forward (build_sph_tree -> trace_cumulative_sph), then drives two
main paths at the bench scene's size (2^20 clustered particles, 512x512
rays), each with the kernels' launch counters set to 0 just before it:

  1. the column-density render: build_sph_tree -> orthographic rays +
     spatial sort -> bucket_prims_ortho -> splat_image (CUDA) and
     pallas_trace_sph(broadphase="quarter") (CUDA); the splat image is held
     against the trace (max rel err < 1e-3), the gate ``bench.py`` applies;
  2. the general trace: pallas_trace_sph with the default bitmask route
     (CUDA), the qlist route and the list route (CUDA), in both modes, with
     list capacities sized from the measured maximum per tile; every
     route's hit counts must equal the quarter kernel's and its column
     densities agree within rtol 1e-5, atol 1e-6 x max.

Prints stage and kernel times (CUDA events, warm, median) with the card's
name and power limit, a JSON line describing each kernel, and last a JSON
line with ``"ok": true``. Any failure raises, so the exit code is non-zero
and no result line prints.
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
MODE_DEGS = (("hitcount", 14), ("cumulative", 14), ("cumulative", -10),
             ("cumulative", 8), ("cumulative", -12))
PK = "grace_tpu/trace/pallas_kernel.py"

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
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} values outside rtol {rtol} "
                             f"atol {atol:.3g}; max abs err {err:.3g}")
    return err, float(want.abs().max()) if want.numel() else 0.0


def check_equal(name, got, want):
    if got.shape != want.shape or not torch.equal(got, want):
        n = int((got != want).sum()) if got.shape == want.shape else "all"
        raise AssertionError(f"{name}: {n} values differ")


def check_kernel(tag, kernel, plain, args, mode, deg):
    """A trace kernel vs its plain version on the same card tensors:
    hit counts exact, column densities within rtol 1e-5, atol 1e-6 x max."""
    got = kernel(*args, deg, mode)
    want = plain(*args, deg, mode)
    torch.cuda.synchronize()
    if mode == "hitcount":
        check_equal(f"{tag} hitcount", got, want)
        return 0.0, float(want.max())
    scale = float(want.abs().max())
    return check_close(f"{tag} deg {deg}", got, want, 1e-5, 1e-6 * scale)


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


def route_inputs(route, rays, spheres, tree, tile, max_chunks=2048, stack_size=128):
    """(kernel, plain version, leading arguments, overflow) of one
    pallas_trace_sph route, its inputs prepared as pallas_trace_sph does."""
    from grace_tpu_torch.trace import pallas_kernel as pk
    from grace_tpu_torch.trace import pallas_broadphase as pb

    rays = pk._pad_rays(rays, tile)
    packed, _ = pk._pack_rays(rays, tile)
    prims, _ = pk._pack_prims(spheres)
    no_ovf = torch.zeros(packed.shape[0] // tile, dtype=torch.bool, device=packed.device)
    if route == "quarter":
        words, summary = pb.dense_tile_masks_quarter(rays, spheres, tile)
        return (pk.trace_quarter, pk._trace_quarter_plain, (summary, words, packed, prims),
                no_ovf)
    if route == "bitmask":
        words = pb.dense_tile_masks(rays, spheres, tile)
        return pk.trace_bitmask, pk._trace_bitmask_plain, (words, packed, prims), no_ovf
    if route == "qlist":
        ids, n, ovf = pb.quarter_lists(rays, spheres, tile, max_q=max_chunks)
        group = pk.QUARTER
    elif route == "list":
        ids, n, ovf = pb.dense_tile_segments(rays, spheres, tile, max_chunks)
        group = pk.SEG
    else:  # xla
        ids, n, ovf = pk.tile_segments(rays, tree, tile, max_chunks, spheres.shape[0],
                                       stack_size)
        group = pk.SEG
    return pk.trace_list, pk._trace_list_plain, (n, ids, packed, prims, group), ovf


def small_checks(dev):
    """Kernels vs plain versions at small and edge shapes; every route vs
    the generic engine."""
    from bench import make_clustered_particles
    from grace_tpu_torch.build.sph import build_sph_tree
    from grace_tpu_torch.rays.gen import orthographic_projection_rays, spatial_sort_rays
    from grace_tpu_torch.trace.splat import bucket_prims_ortho

    spheres = torch.from_numpy(make_clustered_particles(np.random.default_rng(7), 3000)).to(dev)
    ss, tree, _ = build_sph_tree(spheres, 16)
    # A wide view (extent 4 around a unit box) leaves tiles and bands empty;
    # 50 x 39 = 1950 rays is not a multiple of any tile below.
    rays = orthographic_projection_rays(50, 39, CAM, LOOK, UP, 4.0, LENGTH, device=dev)
    rays_s, _, _ = spatial_sort_rays(rays)
    # (route, tile, list capacity, rays): qlist and list overflow at these
    # capacities; bitmask at tile 8 strides its staging loop by 8 threads.
    cases = [(r, t, cap, rays_s) for t in (128, 96)
             for r, cap in (("quarter", 2048), ("bitmask", 2048), ("qlist", 16),
                            ("list", 4))]
    cases.append(("bitmask", 8, 2048, rays_s))
    for route, tile, cap, r in cases:
        kernel, plain, args, ovf = route_inputs(route, r, ss, tree, tile, cap)
        if r.n_rays % tile == 0:
            raise AssertionError("edge case lost: ray count is a tile multiple")
        if route in ("qlist", "list") and not (bool(ovf.any()) and bool((args[0] == 0).any())):
            raise AssertionError(f"edge case lost: {route} lists overflow nowhere "
                                 "or no tile is empty")
        for mode, deg in MODE_DEGS:
            err, top = check_kernel(f"small {route} t{tile} {mode}", kernel, plain, args,
                                    mode, deg)
            log(f"check {kernel.__name__} kernel vs plain: {route} tile {tile} "
                f"cap {cap} {mode} deg {deg} max abs err {err:.3g} "
                f"(max value {top:.3g}) OK")
    # the xla route with a small stack, and 4 subtiles of 32 rays (1920
    # rays: whole groups of 4 tiles)
    for route, tile, kw, r in (("xla", 96, dict(max_chunks=64, stack_size=10), rays_s),
                               ("list", 32, dict(max_chunks=64), rays_s[:1920])):
        kernel, plain, args, _ = route_inputs(route, r, ss, tree, tile, **kw)
        for mode, deg in (("hitcount", 14), ("cumulative", 14)):
            err, _ = check_kernel(f"small {route} t{tile}", kernel, plain, args, mode, deg)
            log(f"check trace_list kernel vs plain: {route} tile {tile} {kw} {mode} "
                f"max abs err {err:.3g} OK")
    engine_checks(ss, tree, rays_s)
    for band in (32, None):
        b = bucket_prims_ortho(ss, CAM, LOOK, UP, 4.0, LENGTH, 128, 128, chunk=256,
                               band=band, **SPLAT_TILE)
        if not bool((b.first == b.last).any()):
            raise AssertionError("edge case lost: no band without instances")
        for basis in ("deg8", "deg10"):
            err, top = check_splat(f"small band {band}", b, basis, **SPLAT_TILE)
            log(f"check splat kernel vs plain: 128x128 band {band} {basis} "
                f"max abs err {err:.3g} (max value {top:.3g}) OK")


def engine_checks(ss, tree, rays_s):
    """Every pallas_trace_sph route against the generic engine on the card:
    hit counts exact on tiles that did not overflow; column densities
    within rtol 5e-4 (grace_tpu's route-vs-engine tolerance: the routes'
    Horner fit against the engine's table) and atol 1e-4 x max. grace_tpu's
    atol, 1e-2, is absolute, set for particles with h >= 0.02; these have
    h >= 0.005, so the fit's absolute error (about 2e-5 of F(0) / h^2) is
    up to 16x larger, and the bound scales with the values instead."""
    from grace_tpu_torch.trace import pallas_kernel as pk
    from grace_tpu_torch.trace.sph import trace_cumulative_sph, trace_hitcounts_sph

    counts = trace_hitcounts_sph(rays_s, ss, tree)
    sums = trace_cumulative_sph(rays_s, ss, tree)
    if int(counts.sum()) == 0:
        raise AssertionError("engine: no ray hits the small scene")
    routes = [("dense", 128, {}), ("bitmask", 8, {}), ("quarter", 96, {}),
              ("qlist", 128, dict(max_chunks=16)), ("list", 96, dict(max_chunks=4)),
              ("xla", 96, dict(max_chunks=64, stack_size=10)),
              ("dense", 32, dict(subtiles=4, max_chunks=64))]
    for bp, tile, kw in routes:
        n = 1920 if "subtiles" in kw else rays_s.n_rays
        r = rays_s[:n]
        hc, ovf = pk.pallas_trace_sph(r, ss, tree, tile=tile, mode="hitcount",
                                      broadphase=bp, **kw)
        cd, ovf2 = pk.pallas_trace_sph(r, ss, tree, tile=tile, broadphase=bp, **kw)
        check_equal(f"route {bp} overflow flags of both modes", ovf2, ovf)
        ok = ~ovf[torch.arange(n, device=ovf.device) // tile]
        check_equal(f"route {bp} tile {tile} {kw} hit counts vs engine", hc[ok], counts[:n][ok])
        err, _ = check_close(f"route {bp} tile {tile} {kw} cumulative vs engine",
                             cd[ok], sums[:n][ok], 5e-4, 1e-4 * float(sums.abs().max()))
        log(f"check route {bp} tile {tile} {kw} vs engine: hit counts equal on "
            f"{int(ok.sum())} of {n} rays ({int(ovf.sum())} tiles overflowed), "
            f"cumulative max abs err {err:.3g} OK")
    sub = pk.pallas_trace_sph(rays_s[:1920], ss, tree, tile=32, subtiles=4, max_chunks=64)
    lst = pk.pallas_trace_sph(rays_s[:1920], ss, tree, tile=32, broadphase="list",
                              max_chunks=64)
    check_equal("subtiles=4 vs list values", sub[0], lst[0])
    check_equal("subtiles=4 vs list overflow", sub[1], lst[1])


def entry_inputs(dev):
    """The driver entry's example arguments (__graft_entry__.entry), made
    from the same numpy seed: 2048 spheres, 1024 rays."""
    rng = np.random.default_rng(0)
    n, r = 2048, 1024
    spheres = np.concatenate([rng.random((n, 3)), 0.02 + 0.03 * rng.random((n, 1))],
                             axis=1).astype(np.float32)
    d = rng.standard_normal((r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = rng.random((r, 3)).astype(np.float32) * 0.2
    t = lambda a: torch.from_numpy(a).to(dev)
    return t(spheres), t(o), t(d), torch.full((r,), 3.0, device=dev)


def entry_forward(spheres, origins, directions, lengths):
    """The driver entry's forward: build_sph_tree -> trace_cumulative_sph."""
    from grace_tpu_torch.build.sph import build_sph_tree
    from grace_tpu_torch.core.types import Rays
    from grace_tpu_torch.trace.sph import trace_cumulative_sph

    sorted_spheres, tree, _ = build_sph_tree(spheres, max_per_leaf=16)
    return trace_cumulative_sph(Rays(origins, directions, lengths), sorted_spheres, tree)


def entry_check(dev):
    """The entry forward on the card, held against the default fused route
    on the same inputs (grace_tpu's route-vs-engine tolerance)."""
    from grace_tpu_torch.build.sph import build_sph_tree
    from grace_tpu_torch.core.types import Rays
    from grace_tpu_torch.trace import pallas_kernel as pk
    from grace_tpu_torch.trace.sph import trace_hitcounts_sph

    args = entry_inputs(dev)
    out = entry_forward(*args)
    torch.cuda.synchronize()
    ss, tree, _ = build_sph_tree(args[0], max_per_leaf=16)
    rays = Rays(*args[1:])
    fused, ovf = pk.pallas_trace_sph(rays, ss, tree, tile=128)
    counts = trace_hitcounts_sph(rays, ss, tree)
    fused_c, _ = pk.pallas_trace_sph(rays, ss, tree, tile=128, mode="hitcount")
    if out.shape != (1024,) or not bool(torch.isfinite(out).all()) or bool(ovf.any()):
        raise AssertionError("entry forward: bad shape, non-finite values or overflow")
    check_equal("entry hit counts: engine vs bitmask route", fused_c, counts)
    err, top = check_close("entry forward vs bitmask route", out, fused, 5e-4, 1e-2)
    log(f"entry forward (2048 spheres, 1024 rays): sum {float(out.sum()):.6g}, "
        f"{int(counts.sum())} hits; vs bitmask route max abs err {err:.3g} "
        f"(max value {top:.3g}) OK")
    return args


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


def _popcount_rows(words):
    from grace_tpu_torch.trace.pallas_broadphase import _popcount32

    return _popcount32(words).sum(dim=1)


def run(dev, n_particles, side):
    """Build, check and time everything on ``dev``; prints the kernels line."""
    from grace_tpu_torch import _kernels
    from grace_tpu_torch.build.sph import build_sph_tree
    from grace_tpu_torch.rays.gen import orthographic_projection_rays, spatial_sort_rays
    from grace_tpu_torch.trace import pallas_broadphase as pb
    from grace_tpu_torch.trace import pallas_kernel as pk
    from grace_tpu_torch.trace import splat as sp

    t_start = time.perf_counter()
    # 1. build every kernel, one nvcc each, all at once
    for name, (path, seconds, out) in _kernels.build_all().items():
        ptxas = [l.strip() for l in out.splitlines() if "registers" in l or "spill" in l]
        log(f"build {name}: {seconds:.1f} s -> {path}")
        for line in ptxas:
            log(f"  ptxas {name}: {line}")

    # 2. kernels vs plain versions at small and edge shapes; routes vs the
    # engine; the driver entry's forward
    small_checks(dev)
    entry_args = entry_check(dev)

    # 3. main path 1, the column-density render on the bench scene
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
    log(f"main path 1 ({n_particles} particles, {side}x{side} rays): "
        f"{wall:.2f} s wall (kernels already built); splat vs trace rel err {rel:.3e} "
        f"(gate {GATE}); launches {launches}")

    # 4. main path 2, the general trace on the same scene and rays
    rays_p = pk._pad_rays(rays_s, TRACE_TILE)
    torch.cuda.synchronize()
    pk.trace_bitmask.launches = 0
    pk.trace_list.launches = 0
    t0 = time.perf_counter()
    general = {"default": [pk.pallas_trace_sph(rays_s, sorted_spheres, tree,
                                               tile=TRACE_TILE, mode=m)
                           for m in ("cumulative", "hitcount")]}
    max_q = int(_popcount_rows(pb.dense_tile_masks_quarter(rays_p, sorted_spheres,
                                                           TRACE_TILE)[0]).max())
    max_s = int(_popcount_rows(pb.dense_tile_masks(rays_p, sorted_spheres,
                                                   TRACE_TILE)).max())
    caps = {"qlist": (max_q + 3) // 4 * 4, "list": max_s}
    for bp, cap in caps.items():
        general[bp] = [pk.pallas_trace_sph(rays_s, sorted_spheres, tree, tile=TRACE_TILE,
                                           mode=m, broadphase=bp, max_chunks=cap)
                       for m in ("cumulative", "hitcount")]
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    launches2 = {"trace_bitmask": pk.trace_bitmask.launches,
                 "trace_list": pk.trace_list.launches}
    if min(launches2.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches2}")
    quarter_hc, _ = pk.pallas_trace_sph(rays_s, sorted_spheres, tree, tile=TRACE_TILE,
                                        broadphase="quarter", mode="hitcount")
    if int(quarter_hc.sum()) == 0:
        raise AssertionError("quarter route: no hits on the bench scene")
    for bp, ((cd, ovf_c), (hc, ovf_h)) in general.items():
        if bool(ovf_c.any()) or bool(ovf_h.any()):
            raise AssertionError(f"route {bp}: overflow at the bench scene")
        check_equal(f"route {bp} hit counts vs quarter kernel", hc, quarter_hc)
        err, top = check_close(f"route {bp} column density vs quarter kernel", cd, trace_v,
                               1e-5, 1e-6 * float(trace_v.abs().max()))
        log(f"check route {bp} vs quarter kernel on the bench scene: hit counts "
            f"equal ({int(hc.sum())} hits), column density max abs err {err:.3g} "
            f"(max value {top:.3g}), no overflow OK")
    log(f"main path 2 (general trace, {n_particles} particles, {side}x{side} rays, "
        f"tile {TRACE_TILE}): {wall2:.2f} s wall for 6 traces; most listed quarters "
        f"per tile {max_q} (qlist max_chunks {caps['qlist']}), most listed segments "
        f"per tile {max_s} (list max_chunks {caps['list']}); launches {launches2}")

    # 5. kernels vs plain versions at the main paths' shapes
    summary, words, packed, prims = route_inputs("quarter", rays_s, sorted_spheres,
                                                 tree, TRACE_TILE)[2]
    trace_err, top = check_kernel("full quarter", pk.trace_quarter,
                                  pk._trace_quarter_plain,
                                  (summary, words, packed, prims), "cumulative", 14)
    check_kernel("full quarter", pk.trace_quarter, pk._trace_quarter_plain,
                 (summary, words, packed, prims), "hitcount", 14)
    log(f"check trace_quarter kernel vs plain on all {words.shape[0]} tiles (cumulative "
        f"deg 14, hitcount): max abs err {trace_err:.3g} (max value {top:.3g}) OK")
    bm_args = route_inputs("bitmask", rays_s, sorted_spheres, tree, TRACE_TILE)[2]
    ql_args = route_inputs("qlist", rays_s, sorted_spheres, tree, TRACE_TILE,
                           caps["qlist"])[2]
    errs = {}
    for name, kernel, plain, args in (
            ("trace_bitmask", pk.trace_bitmask, pk._trace_bitmask_plain, bm_args),
            ("trace_list", pk.trace_list, pk._trace_list_plain, ql_args)):
        errs[name], top = check_kernel(f"full {name}", kernel, plain, args, "cumulative", 14)
        check_kernel(f"full {name}", kernel, plain, args, "hitcount", 14)
        log(f"check {name} kernel vs plain on all {packed.shape[0] // TRACE_TILE} tiles "
            f"(cumulative deg 14, hitcount): max abs err {errs[name]:.3g} "
            f"(max value {top:.3g}) OK")
    splat_err, top = check_splat("full", buckets, "deg8", **SPLAT_TILE)
    log(f"check splat kernel vs plain at {side}x{side}: max abs err {splat_err:.3g} "
        f"(max value {top:.3g}) OK")

    # 6. times (CUDA events, warm, median; the plain versions ran warm in 5)
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
    t["masks_quarter"] = cuda_ms(lambda: route_inputs("quarter", rays_s, sorted_spheres,
                                                      tree, TRACE_TILE))
    t["trace kernel"] = cuda_ms(lambda: pk.trace_quarter(summary, words, packed, prims,
                                                         14, "cumulative"))
    t["trace plain"] = cuda_ms(lambda: pk._trace_quarter_plain(summary, words, packed,
                                                               prims, 14, "cumulative"),
                               reps=2, warm=0)
    t["pallas_trace_sph quarter"] = cuda_ms(lambda: pk.pallas_trace_sph(
        rays_s, sorted_spheres, tree, tile=TRACE_TILE, broadphase="quarter"))
    t["dense_tile_masks"] = cuda_ms(lambda: pb.dense_tile_masks(rays_p, sorted_spheres,
                                                                TRACE_TILE))
    t["quarter_lists"] = cuda_ms(lambda: pb.quarter_lists(rays_p, sorted_spheres,
                                                          TRACE_TILE, max_q=caps["qlist"]))
    t["dense_tile_segments"] = cuda_ms(lambda: pb.dense_tile_segments(
        rays_p, sorted_spheres, TRACE_TILE, caps["list"]))
    t["trace_bitmask kernel"] = cuda_ms(lambda: pk.trace_bitmask(*bm_args, 14, "cumulative"))
    t["trace_bitmask plain"] = cuda_ms(
        lambda: pk._trace_bitmask_plain(*bm_args, 14, "cumulative"), reps=2, warm=0)
    t["trace_list kernel (qlist lists)"] = cuda_ms(
        lambda: pk.trace_list(*ql_args, 14, "cumulative"))
    t["trace_list plain (qlist lists)"] = cuda_ms(
        lambda: pk._trace_list_plain(*ql_args, 14, "cumulative"), reps=2, warm=0)
    sl_args = route_inputs("list", rays_s, sorted_spheres, tree, TRACE_TILE, caps["list"])[2]
    t["trace_list kernel (segment lists)"] = cuda_ms(
        lambda: pk.trace_list(*sl_args, 14, "cumulative"))
    t["pallas_trace_sph default"] = cuda_ms(lambda: pk.pallas_trace_sph(
        rays_s, sorted_spheres, tree, tile=TRACE_TILE))
    t["pallas_trace_sph qlist"] = cuda_ms(lambda: pk.pallas_trace_sph(
        rays_s, sorted_spheres, tree, tile=TRACE_TILE, broadphase="qlist",
        max_chunks=caps["qlist"]))
    t["entry forward (2048 spheres, 1024 rays)"] = cuda_ms(lambda: entry_forward(*entry_args),
                                                           reps=3)
    for k, v in t.items():
        log(f"time {k}: {v:.3f} ms")
    log(f"whole run {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [
        {"name": "trace_quarter", "route": "cuda",
         "source": "grace_tpu_torch/csrc/trace_quarter.cu",
         "replaces": f"{PK}:348, {PK}:519, {PK}:121",
         "launches": launches["trace_quarter"], "max_abs_err": trace_err,
         "ms": t["trace kernel"], "plain_ms": t["trace plain"]},
        {"name": "splat", "route": "cuda", "source": "grace_tpu_torch/csrc/splat.cu",
         "replaces": "grace_tpu/trace/splat.py:282",
         "launches": launches["splat"], "max_abs_err": splat_err,
         "ms": t["splat kernel"], "plain_ms": t["splat plain"]},
        {"name": "trace_bitmask", "route": "cuda",
         "source": "grace_tpu_torch/csrc/trace_bitmask.cu",
         "replaces": f"{PK}:283, {PK}:626",
         "launches": launches2["trace_bitmask"], "max_abs_err": errs["trace_bitmask"],
         "ms": t["trace_bitmask kernel"], "plain_ms": t["trace_bitmask plain"]},
        {"name": "trace_list", "route": "cuda",
         "source": "grace_tpu_torch/csrc/trace_list.cu",
         "replaces": f"{PK}:459, {PK}:221, {PK}:174, {PK}:688",
         "launches": launches2["trace_list"], "max_abs_err": errs["trace_list"],
         "ms": t["trace_list kernel (qlist lists)"],
         "plain_ms": t["trace_list plain (qlist lists)"]},
    ]}), flush=True)


if __name__ == "__main__":
    main()
