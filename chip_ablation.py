"""Ablations of the two kernels redesigned for the card, on one CUDA card.

    python3 chip_ablation.py

Each variant is a copy of the kernel's source with one constant or one
wait replaced, built as the package builds its libraries (into
``_kernels_build/``); every variant must give the shipped kernel's bits,
and the variants are timed in turns (CUDA events, median of 10), on the
work units in the order the wrapper launches them (longest list first).

  render_bwd (csrc/render.cu) on main path 3's backward inputs
  (``chip_smoke.py``'s bench scene: 2^20 clustered particles, 512x512
  sorted orthographic rays, weights 1, max_tiles 2048; the cotangents are
  seeded normal numbers, which move no hit): kBwdBatch = 1, 2 and 4 ray
  tiles per barrier pair, and batch 4 waiting for its own copies and the
  next batch's before it tests (no load runs ahead). It also counts the
  warp passes through the hit branch: the earlier design ran one for every
  ray of a tile on which any of a warp's 32 particles hits, this design as
  many as the warp's busiest particle has hits.

  trace_tri (csrc/tri.cu) on main path 5's closest-hit and any-hit inputs
  (the 262,144-triangle torus, 512x512 pinhole rays, tile 32):
  kBlockWarps = 1, 2, 4 and 8 warps a block, and the shipped block waiting
  for each segment's copy before it tests the previous one.

Then each shipped kernel on the same inputs launched in other orders of
its work units (ray tiles, segments), through the C entry point without
the wrappers' own longest-first order: as listed, longest list first, and
the longest units alone, with the spread of the work a unit does.

Prints the card's name and power limit first and a JSON summary last.
Exits non-zero without a card.
"""

import ctypes
import json
import math
import os
import shutil
import statistics
import subprocess

import numpy as np
import torch

from chip_smoke import (CAM, LENGTH, LOOK, MAX_PER_LEAF, N_PARTICLES, SIDE, TORUS, UP, VEXT,
                        make_clustered_particles, render_inputs, torus_mesh, tri_inputs)

# kernel -> (library name, source, entry, variants {label: (text, replacement)})
ABLATIONS = {
    "render_bwd": ("render", "render.cu", "grace_render_bwd", {
        "batch 1": ("kBwdBatch = 4;", "kBwdBatch = 1;"),
        "batch 2": ("kBwdBatch = 4;", "kBwdBatch = 2;"),
        "batch 4 (shipped)": None,
        "batch 4, no load ahead": ("cp_async_wait<1>();  // batch b's",
                                   "cp_async_wait<0>();  // batch b's"),
    }),
    "trace_tri": ("tri", "tri.cu", "grace_tri", {
        "1 warp a block": ("kBlockWarps = 4;", "kBlockWarps = 1;"),
        "2 warps a block": ("kBlockWarps = 4;", "kBlockWarps = 2;"),
        "4 warps a block (shipped)": None,
        "8 warps a block": ("kBlockWarps = 4;", "kBlockWarps = 8;"),
        "4 warps, no copy ahead": ("cp_async_wait<1>();  // entry j's",
                                   "cp_async_wait<0>();  // entry j's"),
    }),
}


def build_variant(lib_name, source, entry, tag, swap):
    """The C entry point ``entry`` of ``source`` with ``swap`` = (text,
    replacement) applied (None: as shipped), built with the package's nvcc
    flags."""
    from grace_tpu_torch import _kernels

    src_dir = os.path.join(_kernels.BUILD_DIR, "ablation", tag)
    shutil.rmtree(src_dir, ignore_errors=True)
    shutil.copytree(_kernels.CSRC, src_dir)
    path = os.path.join(src_dir, source)
    if swap is not None:
        with open(path) as f:
            text = f.read()
        if text.count(swap[0]) != 1:
            raise AssertionError(f"{source}: {swap[0]!r} is not in the source once")
        with open(path, "w") as f:
            f.write(text.replace(*swap))
    lib = os.path.join(src_dir, lib_name + ".so")
    cmd = [_kernels._nvcc(), *_kernels._NVCC_FLAGS, *_kernels.KERNELS[lib_name][1], "-o", lib,
           path]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag}:\n{res.stdout}{res.stderr}")
    kinds = _kernels.KERNELS[lib_name][2][entry]
    fn = getattr(ctypes.CDLL(lib), entry)
    fn.argtypes = ([ctypes.c_void_p if k == "p" else ctypes.c_int for k in kinds]
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def call(fn, args):
    rc = fn(*args, 0, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")


def render_bwd_call(bwd_args):
    """(kernel arguments, output) of grace_render_bwd, as render_bwd passes them."""
    from grace_tpu_torch.trace import pallas_render as pr

    n_tiles, tile_ids, prims_sub, rays_bwd = bwd_args
    out = torch.empty((prims_sub.shape[0], 128, 8), dtype=torch.float32, device=rays_bwd.device)
    args = [t.data_ptr() for t in bwd_args] + [
        pr._poly_tensor(str(rays_bwd.device)).data_ptr(), out.data_ptr(), prims_sub.shape[0],
        tile_ids.shape[1], rays_bwd.shape[1]]
    return args, (out,)


def tri_call(tri_args, mode):
    """(kernel arguments, outputs) of grace_tri, as trace_tri passes them."""
    from grace_tpu_torch.trace import pallas_tri as pt

    n_segs, seg_ids, _, rays_packed, tris3d = tri_args
    t = torch.empty(rays_packed.shape[0], dtype=torch.float32, device=rays_packed.device)
    ids = torch.empty_like(t, dtype=torch.int32)
    args = [x.data_ptr() for x in tri_args] + [
        t.data_ptr(), ids.data_ptr(), n_segs.shape[0], rays_packed.shape[0] // n_segs.shape[0],
        seg_ids.shape[1], tris3d.shape[0], pt.MODES.index(mode), pt.CHUNK]
    return args, (t, ids)


def ablate(kernel, calls):
    """Build every variant of ``kernel``, check its outputs equal the
    shipped variant's on each of ``calls`` (label -> (args, outputs)), and
    time them in turns. Returns {call label: {variant: ms}}."""
    lib_name, source, entry, variants = ABLATIONS[kernel]
    fns = {v: build_variant(lib_name, source, entry, f"{kernel}-{i}", swap)
           for i, (v, swap) in enumerate(variants.items())}
    shipped = next(v for v, swap in variants.items() if swap is None)
    result = {}
    for label, (args, outs) in calls.items():
        call(fns[shipped], args)
        want = [o.clone() for o in outs]
        for v, fn in fns.items():
            for o in outs:
                o.fill_(-7)
            call(fn, args)
            torch.cuda.synchronize()
            if not all(torch.equal(o, w) for o, w in zip(outs, want)):
                raise AssertionError(f"{kernel} {label}: variant {v!r} differs from {shipped!r}")
        times = {v: [] for v in fns}
        order = list(fns) + list(fns)[::-1]
        for _ in range(5):
            for v in order:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                call(fns[v], args)
                end.record()
                torch.cuda.synchronize()
                times[v].append(start.elapsed_time(end))
        result[label] = {v: statistics.median(x) for v, x in times.items()}
        for v, x in times.items():
            print(f"{kernel} {label} {v}: {statistics.median(x):.3f} ms (median of {len(x)}; "
                  f"min {min(x):.3f}, max {max(x):.3f}); bits equal to {shipped}", flush=True)
    return result


def launch_orders(label, fn, make_call, want, orders):
    """The shipped kernel ``fn`` on the same work units (ray tiles or
    segments) launched in other orders; ``make_call(order)`` gives the
    kernel's arguments and outputs (one row a unit) for the units in that
    order (and the input tensors, held while the kernel reads them), whose
    rows must equal ``want``'s rows in that order. Returns
    {order: ms} (CUDA events, median of 10)."""
    out = {}
    for name, order in orders.items():
        args, outs, inputs = make_call(order)
        call(fn, args)
        torch.cuda.synchronize()
        if not all(torch.equal(o, w[order]) for o, w in zip(outs, want)):
            raise AssertionError(f"{label} {name}: results differ")
        times = []
        for _ in range(10):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call(fn, args)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        out[name] = statistics.median(times)
        print(f"{label} {name}: {out[name]:.3f} ms (median of 10; min {min(times):.3f}, "
              f"max {max(times):.3f})", flush=True)
    return out


def spread(label, x):
    q = torch.quantile(x.double(), torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64,
                                                device=x.device)).tolist()
    print(f"{label}: mean {float(x.double().mean()):.3f}, median {q[0]:.0f}, p90 {q[1]:.0f}, "
          f"p99 {q[2]:.0f}, max {int(x.max())}; {int((x == 0).sum())} of {x.numel()} are 0",
          flush=True)


def resident_warps(lib_name, entry, device, *ints):
    from grace_tpu_torch import _kernels

    res = _kernels.resources(lib_name, entry, device, *ints)
    return res["warps_per_sm"] * torch.cuda.get_device_properties(device).multi_processor_count


def tri_orders(tri_args, mode):
    """grace_tri on main path 5's tiles in list order, by descending list
    length, by descending chunks visited (the plain version's count), and
    the longest tiles alone (one a resident warp of the card)."""
    from grace_tpu_torch import _kernels
    from grace_tpu_torch.trace import pallas_tri as pt

    n, ids, dist, rays, tris = tri_args
    n_tiles = n.shape[0]
    tile = rays.shape[0] // n_tiles
    args, outs = tri_call(tri_args, mode)
    fn = _kernels.load("tri").grace_tri
    call(fn, args)
    want = [o.view(n_tiles, tile).clone() for o in outs]
    visited = pt._tri_plain(*tri_args, mode)[2]
    spread(f"trace_tri {mode}: chunks visited per tile", visited)
    spread(f"trace_tri {mode}: segments listed per tile", n)
    by_visit = torch.argsort(visited, descending=True, stable=True)
    resident = resident_warps("tri", "grace_tri_resources", n.device, tile)

    def make_call(order):
        inputs = (n[order].contiguous(), ids[order].contiguous(), dist[order].contiguous(),
                  rays.view(n_tiles, tile, 16)[order].reshape(-1, 16), tris)
        a, o = tri_call(inputs, mode)
        return a, [x.view(-1, tile) for x in o], inputs

    return launch_orders(f"trace_tri {mode} tiles", fn, make_call, want, {
        "as listed": torch.arange(n_tiles, device=n.device),
        "by list length": torch.argsort(n, descending=True, stable=True),
        "by chunks visited": by_visit, f"longest {resident} alone": by_visit[:resident]})


def render_bwd_orders(bwd_args):
    """grace_render_bwd on main path 3's segments in order, by descending
    list length, and the longest segments alone (one a resident block)."""
    from grace_tpu_torch import _kernels

    n_t, t_ids, prims, rays_bwd = bwd_args
    n_segs = n_t.shape[0]
    args, outs = render_bwd_call(bwd_args)
    fn = _kernels.load("render").grace_render_bwd
    call(fn, args)
    want = [outs[0].clone()]
    spread("render_bwd: ray tiles listed per segment", n_t)
    by_len = torch.argsort(n_t, descending=True, stable=True)
    resident = resident_warps("render", "grace_render_bwd_resources", n_t.device) // 4

    def make_call(order):
        inputs = (n_t[order].contiguous(), t_ids[order].contiguous(), prims[order].contiguous(),
                  rays_bwd)
        return (*render_bwd_call(inputs), inputs)

    return launch_orders("render_bwd segments", fn, make_call, want, {
        "as listed": torch.arange(n_segs, device=n_t.device), "by list length": by_len,
        f"longest {resident} alone": by_len[:resident]})


def branch_passes(bwd_args):
    """(passes of the earlier design, passes of this design, hits): warp
    passes through the hit branch over every (segment, listed tile)."""
    from grace_tpu_torch.trace.pallas_kernel import _impact

    n_tiles, tile_ids, prims_sub, rays_bwd = bwd_args
    n_segs, max_tiles = tile_ids.shape
    dev = prims_sub.device
    ok = torch.arange(max_tiles, device=dev) < torch.clamp(n_tiles, 0, max_tiles)[:, None]
    seg_of = torch.arange(n_segs, device=dev)[:, None].expand(-1, max_tiles)[ok]
    tile_of = tile_ids[ok].long()
    order = torch.argsort(tile_of, stable=True)
    seg_of, tile_of = seg_of[order], tile_of[order]
    tiles, runs = torch.unique_consecutive(tile_of, return_counts=True)
    old = new = hits = 0
    start = 0
    for t, run in zip(tiles.tolist(), runs.tolist()):
        p = prims_sub[seg_of[start:start + run]]                    # [run, 128, 8]
        start += run
        r = rays_bwd[:, t * 128:(t + 1) * 128]
        b2, dot, *_ = _impact(p[..., 0:1], p[..., 1:2], p[..., 2:3], r[0], r[1], r[2], r[3],
                              r[4], r[5])
        hit = (b2 < p[..., 3:4] ** 2) & (dot >= 0.0) & (dot < r[6])  # [run, 128, 128]
        warps = hit.reshape(run, 4, 32, 128)
        old += int(warps.any(dim=2).sum())
        new += int(warps.sum(dim=3).amax(dim=2).sum())
        hits += int(hit.sum())
    return old, new, hits


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_ablation: torch.cuda.is_available() is false")
    from grace_tpu_torch import _kernels
    from grace_tpu_torch.build.sph import build_sph_tree
    from grace_tpu_torch.models import triangle as mt
    from grace_tpu_torch.rays.gen import (orthographic_projection_rays, pinhole_camera_rays,
                                          spatial_sort_rays)

    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    spheres = torch.from_numpy(
        make_clustered_particles(np.random.default_rng(2026), N_PARTICLES)).to(dev)
    sorted_spheres, _, _ = build_sph_tree(spheres, MAX_PER_LEAF)
    rays_s, _, _ = spatial_sort_rays(orthographic_projection_rays(
        SIDE, SIDE, CAM, LOOK, UP, VEXT, LENGTH, device=dev))
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(rays_s.n_rays)
                         .astype(np.float32)).to(dev)
    weights = torch.ones(N_PARTICLES, device=dev)
    _, _, bwd_args, ovf = render_inputs(rays_s, sorted_spheres, weights, g, 128, 2048, 2048)
    if bool(ovf.any()):
        raise AssertionError("backward tile lists overflow")
    # the variants on the segments in the wrapper's order, longest list first
    order = _kernels.longest_first(bwd_args[0])
    by_len = tuple(a[order] for a in bwd_args[:3]) + (bwd_args[3],)
    summary = {"render_bwd": ablate("render_bwd", {"bench scene": render_bwd_call(by_len)})}
    del by_len
    old, new, hits = branch_passes(bwd_args)
    print(f"hit-branch warp passes: earlier design {old}, this design {new} "
          f"({new / old:.4f} of them); {hits} hits", flush=True)
    summary["render_bwd branch passes"] = {"earlier_design": old, "this_design": new, "hits": hits}
    summary["render_bwd segment orders"] = render_bwd_orders(bwd_args)
    del bwd_args

    tris = torch.from_numpy(torus_mesh(**TORUS)).to(dev)
    sorted_tris, _, _ = mt.build_triangle_tree(tris)
    cam, look, length = mt.auto_camera(sorted_tris, SIDE)
    rays = pinhole_camera_rays(SIDE, SIDE, cam.tolist(), look.tolist(), (0.0, 1.0, 0.0),
                               math.pi / 3, float(length), device=dev)
    tri_args, _ = tri_inputs(rays, sorted_tris, 32, 2048)
    n_tiles = tri_args[0].shape[0]
    order = _kernels.longest_first(tri_args[0])
    by_len = (*(a[order] for a in tri_args[:3]),
              tri_args[3].view(n_tiles, -1, 16)[order].reshape(-1, 16), tri_args[4])
    summary["trace_tri"] = ablate("trace_tri", {m: tri_call(by_len, m)
                                                for m in ("closest", "any")})
    del by_len
    summary["trace_tri tile orders"] = {m: tri_orders(tri_args, m) for m in ("closest", "any")}
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
