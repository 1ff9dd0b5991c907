"""Smoke run of grace_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``grace_tpu_torch/csrc`` (nvcc, first use, one
process per source, all at once), checks each kernel against its plain
PyTorch version on the card at small and edge shapes, holds every
``pallas_trace_sph`` route against the generic BVH engine, runs the driver
entry's forward (build_sph_tree -> trace_cumulative_sph), then drives eight
main paths at full size (the bench scene: 2^20 clustered particles, 512x512
rays; the triangle workload: a 262,144-triangle torus), each with the
kernels' launch counters set to 0 just before it:

  1. the column-density render: build_sph_tree -> orthographic rays +
     spatial sort -> bucket_prims_ortho -> splat_image (CUDA) and
     pallas_trace_sph(broadphase="quarter") (CUDA); the splat image is held
     against the trace (max rel err < 1e-3), the gate ``bench.py`` applies;
  2. the general trace: pallas_trace_sph with the default bitmask route
     (CUDA), the qlist route and the list route (CUDA), in both modes, with
     list capacities sized from the measured maximum per tile; every
     route's hit counts must equal the quarter kernel's and its column
     densities agree within rtol 1e-5, atol 1e-6 x max;
  3. training: one step of the sort-free splat trainer (forward and
     backward on CUDA, L2 loss against 1.01 x the trace image, SGD 1e-6)
     and one of the fused differentiable renderer on the sorted rays
     (forward and backward on CUDA); losses and updates finite, the
     sort-free image within 1e-4 x max of the bucketed splat and within the
     1e-3 gate of the trace, the fused forward within 5e-4 x max of the
     trace, no overflow and no NaN poison;
  4. per-hit records: pallas_trace_sph_records with 512 records a ray on
     the default (quarter) route (CUDA) and the bitmask route (CUDA),
     sort_records_by_distance (CUDA, csrc/segsort.cu's row sort),
     trace_sph(engine="pallas") (its flat layout by segsort.cu's
     records_to_flat) and segops.sort_by_distance of that layout with its
     total_hits (segsort.cu's segmented sort), the original's
     trace-then-sort flow; counts equal the quarter trace's hit counts on
     every ray, rows that did not overflow sum to its column density
     (rtol 1e-5, atol 1e-6 x max), the routes are bit-equal, sorted rows
     non-decreasing, flat offsets the exclusive cumsum, and the CSR sort
     of the flat layout bit-equal to the flat layout of the sorted rows
     (``segsort_gate``); then each of the three against its plain version
     on the card, bit for bit, on these records;
  5. triangles: render_triangles(engine="pallas") at 512x512 (build,
     auto_camera, pinhole rays, the closest-hit and the shadow any-hit pass
     on CUDA); every phase finite, the image in [0, 1], no list overflow,
     any hit equal to a finite closest t, and on 4,096 rays the generic
     engine's ids and t (rtol 1e-6) but on rays through shared edges,
     where grace_tpu's two paths round the triangle test differently; then
     the triangle kernel against its plain version on every tile in both
     modes (ids, misses and t bit-equal).
  6. a Gadget snapshot through random and HEALPix rays, on the bench
     particles (``snapshot_path``): write_gadget_gas, then read_gadget_gas
     (native library), _np_read and 4 shards, each bit-equal; build_sph_tree,
     save_scene and load_scene(device=...), bit-equal; project_gadget's
     512x512 plane-parallel field through the default route (CUDA) and the
     quarter route (CUDA), hit counts equal and column densities within
     rtol 1e-5, atol 1e-6 x max, then to_colormap and write_bmp (786,486
     bytes, a valid header); the integral normalization on a padded
     1024x1024 field (|sum x area / N - 1| < 5e-4); 262,144 sorted
     isotropic rays from the box centre on both routes, 1,024 of them
     against the generic engine (hit counts equal); 196,608 HEALPix rays
     (nside 128, rotated) on both routes; Rayleigh z, An, Gn and Fn of
     65,536 of the isotropic and of the HEALPix directions below their 0.01
     critical values, the HEALPix An and Gn within 1e-4 of a float64
     evaluation of the normalized directions, one-octant directions
     rejected, An, Gn and Ripley's K of 4,096 against float64, and the
     Ripley band (1,000 samples of 256) accepting an isotropic bundle and
     rejecting a biased one; then each stage's time and B3's and B6's on
     each ray set, and their share of the path's wall time.
  7. the sharded routes of grace_tpu_torch.parallel on one NCCL rank
     (``sharded_path``: multihost.initialize at a file store, make_mesh(1,
     1)): on main path 1's scene sharded_pallas_render on the bitmask (B6)
     and the quarter route (B3), ring_pallas_render with its hoisted masks
     (B6) and sharded_splat_render on path 1's banded deg8 buckets (B1),
     each bit-equal to the call without the mesh, and the data-parallel
     splat step of dryrun_multichip through allreduce_sum (B11, B12), loss
     and gradients bit-equal to make_splat_trainer's; at dryrun_multichip's
     sizes replicated_sharded_render and sharded_train_step within rtol
     1e-5 of the engine's render, loss and update, and an undersized
     capacity setting the flag that check_overflow raises on; then each
     route and its single-device call timed, with the collectives each
     route runs timed alone, in one line. One card takes one NCCL rank:
     rings of 2 and 4 and meshes of 2 x 2 run in
     tests/test_torch_parallel.py on the CPU (gloo). The process group is
     torn down at the end.
  8. the generic engine's walk on the card (``engine_path``;
     csrc/bvh_walk.cu, a warp's 32 rays as one packet, with engine.trace's
     call counter held at 0): the driver entry's forward, trace_hitcounts_sph,
     trace_cumulative_sph and trace_sph(engine="xla") on path 1's scene and
     rays, and render_triangles(engine="xla") on the torus; the entry's
     walk bit-equal to the plain walk (sums within rtol 1e-5); on the bench
     scene hit counts equal the default route's (B6) but on rays where the
     two packages' pair tests round apart, each explained, sums within 5e-4
     x max of it, the records the particles of the record route's sorted
     rows (B16) with distances within 1e-6 and integrals within 5e-4 x
     max, and every 64th ray's counts and sums against the plain walk; the
     torus image bit-equal to engine="pallas" wherever the two renders'
     closest ids and occlusion agree, their differences explained edge
     rays; the packet walk bit-equal to the per-ray walk (PR 12's kernel,
     the packet's restart route) in every mode on the entry, the bench
     scene and the torus's primary and shadow rays, no warp restarting;
     then the packet walk, the per-ray walk and the plain walk timed at
     each size (the plain walk once at full size, its counts, sums and
     triangle outputs held to the kernel's); path 6's timing also gives
     the walk's cumulative and count times on the isotropic and HEALPix
     rays beside B6's.

Before any other check, ``check_build`` holds the LBVH build's kernels
(csrc/build.cu: Morton keys, deltas, the gather with boxes and deltas,
the two climbs) to the plain build bit for bit (keys, permutation, sorted
primitives, deltas, split ranges, every Tree field, the climbs also at
blocks of 32 and 100 items; the gather's rows, permutation, boxes and
deltas against prims[perm], perm.to(int32), kind.aabb and the plain
deltas) on the bench scene, the entry's spheres, the torus, 63-bit keys
with XOR and with surface-area deltas, all points identical, runs of
equal keys, max_per_leaf 1 and 32, N = 2 and 3, signed zeros at the box
edge, triangles with signed zeros and tied vertices and triangles with
surface-area deltas, and runs each entry build twice (bit-equal) under
torch.cuda.set_sync_debug_mode("error"); where a delta equals the
sentinel (two spheres at opposite corners, 63-bit keys) both give the
valid tree, where the reference's build breaks (ROADMAP C19). Every
main path builds through those kernels; their launches are counted on
each path. ``check_keys`` then holds the keys' one launch (its box folded
in the launch, or given) to the plain versions bit for bit at the cases
of KEY_CASES (16-byte sphere rows, centroids, strided rows and rays by
their midpoints; grids capped at 1-3 blocks, whose items pass the ones
held in registers; given and scalar boxes; NaN in one axis, -0 and +0 at
the box's edges and an axis of zeros, +-inf, identical points; the
conversion's edges at scale 1: NaN, +-inf, negatives, -0, subnormals,
values past 2^32, which hold cvt.rzi's saturation to the plain f64
clamp; 0, 1 and 257 points; the rays' order, inverse and sorted rays too)
and spatial_sort_rays on main path 1's 512^2 rays.

Then ``check_splat_prep`` holds the splat's two setups (csrc/splat_prep.cu:
bucket_prims_ortho's two passes, keys with counts and then the stable
scatter into the slabs, and the sort-free setup's projection, slabs and
both overlap masks) to their plain versions bit for bit (every
SplatBuckets field; masks, transposed masks, coords, slabs) at the cases
of SPLAT_PREP_CASES: particle counts that are no multiple of chunk, 2
chunk, 128 or the block tile, fewer than 32 particles, 64 segments, 40
segments (two mask words, the last ragged), 128 tiles, band None to 64,
weights None and given, dead particles, a whole-image particle and a far
one that overflow, a 2^16 clustered scene, Morton-sorted particles at
path 1's 256 keys, 4,096 keys (E4's counters in device memory); and on
the bench scene with weights None and 1. Main path
1's bucket_prims_ortho and main path 3's trainer (forward and backward)
launch them, counted there.

Then ``check_broadphase`` holds the dense broadphase (csrc/broadphase.cu:
both box sets in one launch, the overlap words with their summary, the
compaction into lists) to its plain versions at the cases of
BROADPHASE_CASES (particle counts no multiple of 32 or 128, one and no
segment, tile counts no multiple of 32, NaN particles, particles at -0
and +0, zero-length rays, a tile of them, a NaN ray, a ragged summary
word, every segment listed, a word of 32 NaN quarters and a NaN quarter
beside overlapping ones, 1,100 tiles (segments x tiles words over two
strips of the overlap kernel), the compaction at max_q equal to and one
under the longest row, 1 and 0): boxes equal in value (their zero signs
are torch's reduction order's, ROADMAP C20), words (tiles x quarters,
tiles x segments, segments x tiles), summaries, lists, counts and flags
bit-equal; the overlap words on given boxes at the cases of
OVERLAP_BOX_CASES (NaN columns beside overlapping ones, a word of NaN
columns, NaN rows, boxes touching at -0 and +0, a ragged last word and
strip, fewer than 32 columns, no rows, no columns), summary on and off,
bit-equal to overlap_words_reference; the boxes alone at the cases of
BOX_SET_CASES (tiles 4 to 1,024 on the 16- and 4-byte ray routes, rays off
a 16-byte boundary, NaN in spheres and rays, +-0, +-inf and F32_MAX, no
spheres, no rays) at blocks 32 and 128, both parts in one launch and each
through tile_aabbs and segment_aabbs; again on the bench scene at tiles
128 and 64, where it also prints how sparse the overlap words are (pairs,
set bits, nonzero words and the words the overlap kernel's hull cull
keeps, at tiles 64 and 128 against quarters and segments and segments
against tiles) and fails if a nonzero word is not among those kept; the
compaction alone at the cases of COMPACT_CASES (rows of every bit at
max_q equal to, one under and one over their count, counts at max_q - 1,
max_q and max_q + 1, rows of ids off 16-byte lines, 4-byte word loads,
no words, no rows, max_q 0) and at the main paths' shapes (path 2's qlist
and list rows, path 3's dense_tile_segments and dense_segment_tiles, the
quarter words at tile 64), ids, n and flags bit-equal.
``check_tri_lists`` holds the triangle lists (csrc/tri_lists.cu) to
theirs at the cases of TRI_LIST_CASES (the tests' torus, a small
max_chunks, a ragged last segment, K 8, tiles of clipped and zero-length
rays listing 0, 1 and every segment, a listed key exactly BIG, keys past
it and a NaN key, 11,719 segments on the device-memory sort) and on main
path 5's primary and shadow rays at max_chunks 2048 and 16: ids,
distances, counts and flags bit-equal. Every main path but 8 launches
some of these kernels; each path's are counted and gated.

Then ``check_segsort`` holds the records' post-processing
(csrc/segsort.cu: the row sort, the CSR sort by distance, the flat
layout) at the cases of SEGSORT_ROW_CASES, SEGSORT_FLAT_CASES and
SEGSORT_CSR_CASES (keys of every special value of the order, ties,
sentinel slots mid-row, real +inf, rows that overflowed, rows whose
records are in order already, widths 128 to 2,048 (past a warp: chunks
merged); capacities equal to, below and past the total, sentinel slots
with other sentinels; empty, repeated, unordered, negative, past-H and
near-2^31 offsets, total_hits 0, inside and past H, segments of 3,000, a
1.2M-entry pseudo-segment, nine arrays; capacity padding of equal
sentinel keys in the last ray's segment and as a segment of its own,
long segments in order but for a pair across a chunk boundary or for
their last element, keys that tie only in the order, descending
segments, lengths around 1, 32, 512 and 1,024) to grace_tpu's order, bit
for bit: to the plain versions run on the CPU,
which the CPU tests hold to grace_tpu; where the card's plain versions
(torch.sort on the card) depart, the departures are counted and logged
(ROADMAP C25), not failed. Main path 4 runs all three, counted there.

The engine's walk is held bit-equal to the plain walk (engine.trace) at
edge shapes first: a stack of 4 (on the rays whose overflowed walk ends),
rays on box planes with zero direction components, rays that miss
everything, a leaf of one primitive, record buffers that overflow,
weights on and off, triangles in both modes, and the overflow message
under GRACE_TPU_DEBUG; and the packet walk bit-equal to the per-ray walk
there in every mode, at a ragged ray count and at stacks of 64 (no warp
restarts) and 4 (warps restart). Path 6 also holds the walk's hit counts
on all 262,144 isotropic rays against B6.

The trace kernels are also held against their plain versions on particles
at the edge of a ray's support (u = b^2 / h^2 within a few ulp of 1, on
both sides), where the kernels start or stop taking the integral. Both
splat kernels are held bit-equal to the dense contractions they replaced
(``csrc/splat_dense.cu``, ``csrc/splat_sortfree_fwd_dense.cu``) and within
1e-5 x max of their plain versions: on the bench inputs, and on an edge
scene (an empty key, a key of one instance, footprints whose edge lies at
d^2 within a few ulp of 1 from a pixel centre, footprints covering whole
patches, scale 0, bands 16 to 128, tile_w 8 to 64) launched heaviest
first, as listed and heaviest last. Before
the main paths, the training kernels are held against their plain
versions at edge shapes (a particle count that is not a multiple of 128,
dead particles, tiles with no segment, a particle that covers every tile,
tile_w 16 and 32, both bases, list overflow) and both trainers against
directional finite differences; the record kernels at edge shapes (empty
tiles, rows that overflow, every route and drain option bit-equal) and the
triangle kernel (random meshes with faces culled, rays that miss the mesh
box, tiles 8, 32, 64 and 96, both modes, lists cut by max_chunks). The
record kernels are also launched as listed, longest mask row first and
shortest first, and the fused forward's tiles as listed and shortest first
besides the wrapper's longest list first, at every check of those
kernels: each launch into outputs of its own filled with a poison value,
held against the plain version and bit-equal to the wrapper's launch. The
sort-free backward is checked at tile_w 8, 16 and 32, and 8 to 64 on the
splat edge scene.

Prints a ``resources`` line for each kernel redesigned for the card
(registers a thread, shared bytes and threads a block, resident blocks and
warps an SM; the build's, the walk's, segsort.cu's, the overlap words',
the boxes' (both ray routes), the compaction's (both load routes) and
the sort-free setup's kernels also local bytes a thread, which must be 0
for the keys' and the last five's), stage and kernel times (CUDA events,
warm, median; the dense splat contractions and the launch-order helpers
too; the overlap words', the boxes' (both parts and each alone), the
keys' (the build's call, a given box, path 1's rays), the compaction's
(at each main-path shape) and the sort-free setup's kernels also by
device time, torch.profiler, "not measured" where no profiler window held
a launch; the device operations of morton_keys_sph and
spatial_sort_rays) with the card's name
and power limit, the work each kernel's bound is computed from (the
overlap words both as all pairs and as the hull cull's tests),
a JSON line describing each kernel (the list kernel on quarter and on
segment lists apart, the triangle kernel's two passes apart, the engine's
walk for spheres and for triangles apart, the build's five kernels (the
keys' with their device time, a given box's and path 1's rays'), the
splat setups' four, the broadphase's three (the boxes' one with its
parts, the compaction's with each main-path shape), the triangle lists
and the
records' three post-processing entries with their launches on each main
path), and last a
JSON line with ``"ok": true``. Any failure raises, so
the exit code is non-zero and no result line prints.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
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
PR = "grace_tpu/trace/pallas_records.py"
# The card's peaks for the bounds: 67 TFLOP/s FP32 outside the tensor cores
# and 3.35 TB/s of HBM (NVIDIA's H100 SXM data sheet, 700 W).
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# Flops a kernel needs, by the operations of its source: a (ray, particle)
# test (3 subtractions, 6 fmas, 2 products, 3 compares: 22); per hit the
# degree-14 Horner integral with its prefactor (38), the fast Clenshaw F
# with the weight (42), or F, dF/db2 and the five gradient sums (122).
FLOPS_PAIR = 22
FLOPS_HIT_H14 = 38
FLOPS_HIT_FAST = 42
FLOPS_HIT_FAST_BWD = 122
# A Moller-Trumbore test (pallas_tri._mt_candidates): the cross products p
# and q (6 fmas, 6 products: 18), det and the three dots (8 fmas, 4
# products: 20), 3 subtractions, |det| > eps with its select and the
# division (3), 3 products by 1/det, u + v and 7 compares (8): 55.
FLOPS_MT = 55
RECORD_CAP = 512          # grace_tpu's record workload capacity
TORUS = dict(n_u=512, n_v=256)   # grace_tpu's triangle workload: 262,144 triangles
TORUS_SEGMENTS = 2 * TORUS["n_u"] * TORUS["n_v"] // 128   # its 128-triangle segments
ENGINE_SUBSET = 4096      # rays of the triangle image held against the engine
WALK_SUBSET = 64          # path 8: every 64th bench ray against the plain walk
# Flops of the engine's walk (csrc/bvh_walk.cu): the slab test of one child
# box (6 subtractions, 6 products, 6 min/max, the 3 max and 3 min of the
# clamp, a compare: 25; a node tests two), and per hit the table integral
# (1/h, the f64 square root, 2 products, the truncation and 2 clamps, 2
# subtractions, the fma (2), (1/h)^2 and its product, the weight and the
# sum: 15).
FLOPS_SLAB = 25
FLOPS_HIT_LERP = 15
# Main path 6: a Gadget snapshot through random and HEALPix rays, on the
# bench particles. SNAPSHOT_SIZES are its widths (a CPU rehearsal passes
# smaller ones): the projection's and the integral field's rays a side, the
# isotropic rays and the engine's subset of them, the HEALPix nside, the
# directions of the statistics and of their float64 subset, and the Ripley
# band's bundle size and samples.
SNAPSHOT_SIZES = dict(proj_side=512, integral_side=1024, iso_rays=262_144, engine_rays=1024,
                      nside=128, stats_dirs=65_536, stats_subset=4_096, band_dirs=256,
                      band_samples=1000)
SNAPSHOT_SEED = 2026        # torch.Generator seeds of path 6's draws start here
INTEGRAL_TOL = 5e-4         # the reference's integral normalization gate
BAND_SCALES = np.array([0.1, 0.5, 1.0, np.pi / 2], np.float32)   # test_hypothesis.py's
PATH6_FULL = "isotropic"    # path 6's set whose every tile is held to the plain versions
# Main path 7: the sharded routes on one rank. DRYRUN is
# __graft_entry__.dryrun_multichip's size on a mesh of one: particles a
# shard, rays a rank, hit capacity, leaf size and learning rate.
DRYRUN = dict(n_per_shard=64, rays_per_rank=16, capacity=4096, max_per_leaf=8, lr=1e-3)
BUILD_SEED = 2026           # check_build's small scenes

_GPU = None


def make_clustered_particles(rng, n):
    """Gadget-like clustered distribution: Plummer-ish clumps in a unit box
    (the bench scene's particles; the same draws as ``bench.py``'s copy)."""
    n_clumps = 256
    centers = rng.random((n_clumps, 3)).astype(np.float32)
    assign = rng.integers(0, n_clumps, n)
    scale = 0.02 + 0.05 * rng.random((n_clumps, 1)).astype(np.float32)
    pos = centers[assign] + rng.standard_normal((n, 3)).astype(np.float32) * scale[assign]
    pos = np.clip(pos, 0.0, 1.0)
    # smoothing length ~ local density proxy
    h = (0.005 + 0.01 * rng.random(n)).astype(np.float32)
    return np.concatenate([pos, h[:, None]], axis=1).astype(np.float32)


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


def kernel_device_ms(fn, kernel, reps=10, tries=3):
    """Device time of the one launch a call of fn() makes of the CUDA
    kernel whose name holds ``kernel``, from torch.profiler over ``reps``
    warm calls (ms); None where no window of ``tries`` held all ``reps``
    launches (the profiler sometimes returns a window without some or all
    of its device events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and kernel in e.name]
        if len(us) == reps:
            return sum(us) / 1e3 / reps
    return None


def kernel_device_ms_seen(fn, kernel, reps=20, tries=10):
    """The mean device time of the launches of ``kernel`` that the
    profiler's windows hold (ms; each window ``reps`` warm calls of fn(),
    one launch each), the windows taken until one holds all ``reps`` or
    ``tries`` have run; (ms, launches seen), ms None where none was seen.
    kernel_device_ms wants a whole window, which in the smoke's timing
    phase some kernels' windows never were."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and kernel in e.name]
        seen += us
        if len(us) == reps:
            break
    return (sum(seen) / 1e3 / len(seen) if seen else None), len(seen)


def device_ops(fn, reps=10, tries=8):
    """The device operations (kernels, copies, memsets) of one warm fn(),
    by name, from torch.profiler over ``reps`` calls; a window whose count
    is no multiple of ``reps`` is taken again, up to ``tries`` times. (In
    the smoke's timing phase the profiler's first windows came back
    without device events, and windows of one short call always did.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    names = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if names and len(names) % reps == 0:
            break
    return names[:len(names) // reps]


def device_op_ms(fn, reps=20, tries=8):
    """The device operations of one warm fn() with their device times:
    [(name, ms)] in launch order, each the mean over ``reps`` calls from
    torch.profiler; a window whose count is no multiple of ``reps`` is
    taken again, up to ``tries`` times ([] where none was)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        if events and len(events) % reps == 0:
            per = len(events) // reps
            return [(events[i].name,
                     sum(events[r * per + i].time_range.elapsed_us() for r in range(reps))
                     / 1e3 / reps) for i in range(per)]
    return []


def log_device_ms(t, label, fn, kernel):
    """kernel_device_ms into t[label], or a line saying it was not measured
    (fn makes one launch of ``kernel``)."""
    ms = kernel_device_ms(fn, kernel)
    if ms is None:
        log(f"time {label}: not measured (the profiler saw no device time of {kernel})")
    else:
        t[label] = ms


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


def check_kernel(tag, kernel, plain, args, mode, deg, want=None):
    """A trace kernel vs its plain version on the same card tensors:
    hit counts exact, column densities within rtol 1e-5, atol 1e-6 x max.
    ``want`` is the plain version's output where the caller has it."""
    got = kernel(*args, deg, mode)
    if want is None:
        want = plain(*args, deg, mode)
    torch.cuda.synchronize()
    if mode == "hitcount":
        check_equal(f"{tag} hitcount", got, want)
        return 0.0, float(want.max())
    scale = float(want.abs().max())
    return check_close(f"{tag} deg {deg}", got, want, 1e-5, 1e-6 * scale)


def splat_dense(buckets, tile_w, band, basis):
    """csrc/splat_dense.cu, the dense contraction splat.cu replaced, on the
    same buckets (keys as listed): the bits splat_image must give."""
    from grace_tpu_torch import _kernels
    from grace_tpu_torch.trace import splat as sp

    deg, a, _ = sp.SPLAT_BASES[basis]
    rank = len(a)
    w_res, h_res = buckets.xcols.shape[0], buckets.yrows.shape[0]
    sub = min(64, (48 * 1024 // 4 - tile_w - band - 2 * rank * (deg + 1))
              // (rank * (tile_w + band)))
    a_t, b_t = sp._basis_tensors(basis, str(buckets.slabs.device))
    out = torch.zeros((h_res, w_res), dtype=torch.float32, device=buckets.slabs.device)
    _kernels.launch("splat_dense", "grace_splat_dense", buckets.slabs.device,
                    *[t.contiguous().data_ptr() for t in (
                        buckets.slab_lo, buckets.n_slabs, buckets.first, buckets.last,
                        buckets.xcols, buckets.yrows, buckets.slabs)], a_t.data_ptr(),
                    b_t.data_ptr(), out.data_ptr(), buckets.first.shape[0], w_res // band,
                    tile_w, band, buckets.slabs.shape[2], w_res, buckets.slabs.shape[0], rank,
                    deg, sub)
    return out


def sortfree_fwd_dense(masks, coords, slabs, basis, tile_w, tile_h, height, width):
    """csrc/splat_sortfree_fwd_dense.cu, the dense contraction the sort-free
    forward replaced, on the same inputs (tiles as listed): the bits
    splat_sortfree_fwd must give."""
    from grace_tpu_torch import _kernels
    from grace_tpu_torch.trace import splat_grad as sg

    deg, a, _ = sg._basis_coeffs(basis)
    rank = a.shape[0]
    band = sg._fwd_band(tile_h)
    sub = min(32, (48 * 1024 // 4 - (tile_w + band + 2 * rank * (deg + 1) + 5 * 128 + 8))
              // (rank * (tile_w + band)))
    dev = slabs.device
    out = torch.empty((height, width), dtype=torch.float32, device=dev)
    _kernels.launch("splat_sortfree_dense", "grace_splat_sortfree_fwd_dense", dev,
                    masks.data_ptr(), coords.data_ptr(), slabs.data_ptr(),
                    sg._basis_tensor(basis, "a", str(dev)).data_ptr(),
                    sg._basis_tensor(basis, "b", str(dev)).data_ptr(), out.data_ptr(),
                    masks.shape[0], masks.shape[1], slabs.shape[0], width // tile_h, tile_w,
                    tile_h, band, width, rank, deg, sub)
    return out


def check_splat(tag, buckets, basis, tile_w, tile_h, order="heaviest"):
    """splat.cu against the dense contraction (bit-equal) and the plain
    version (within 1e-5 x max), keys in ``order``: "heaviest" (the
    wrapper's), None (as listed) or an i32 permutation. Returns (max abs
    error against the plain version, max value)."""
    from grace_tpu_torch.trace import splat as sp

    n_bands = buckets.first.shape[0] // ((buckets.xcols.shape[0] // tile_h)
                                         * (buckets.yrows.shape[0] // tile_w))
    band = tile_h // n_bands
    if isinstance(order, str):
        got = sp.splat_image(buckets, tile_w=tile_w, tile_h=tile_h, basis=basis)
    else:
        got = sp._splat_launch(buckets, tile_w, band, basis, order)
    _, a, b = sp.SPLAT_BASES[basis]
    want = sp._splat_plain(buckets, tile_w, band, np.asarray(a, np.float32),
                           np.asarray(b, np.float32))
    dense = splat_dense(buckets, tile_w, band, basis)
    torch.cuda.synchronize()
    check_equal(f"splat {tag} {basis} vs the dense contraction", got, dense)
    return check_close(f"splat {tag} {basis}", got, want, 0.0,
                       1e-5 * float(want.abs().max()))


def _edge_particles(centres, axis, other, k):
    """(x, y, h) of a particle whose footprint edge along ``axis`` ("row":
    pv = y, "col": pu = -x, the bench camera's exact frame) lies at d^2
    within a few ulp of 1 from ``centres[len // 2]``: q 2.5 spacings past
    the centre, invh = 1 / |c - q| moved by k ulp."""
    f32 = np.float32
    c = f32(centres[len(centres) // 2])
    q = f32(c + f32(2.5) * f32(centres[1] - centres[0]))
    invh = f32(f32(1.0) / abs(f32(c - q))) * f32(1.0 + k * np.finfo(f32).eps)
    h = f32(f32(1.0) / invh)
    return (other, q, h) if axis == "row" else (-q, other, h)


def splat_edge_scene(device, seed=3):
    """Particles f32[n, 4], Morton-sorted, for the splat kernels' edge
    checks on a 4.0-wide view of the unit box (the bench camera: pu = -x
    and pv = y exactly) at 128 x 128, where a 32-pixel key is 1.0 wide:
    1500 clustered particles with 4x the bench smoothing lengths (keys off
    the box stay empty), one alone in an empty key, one centred on the
    corner of four keys, one whose footprint covers whole 32 x 32 patches,
    and for each axis and each splat path's pixel centres (the bucketing's
    and the sort-free map) 9 whose footprint edge lies at d^2 within a few
    ulp of 1 from a centre (k ulp, k in [-4, 4])."""
    from grace_tpu_torch.build.sph import build_sph_tree
    from grace_tpu_torch.ops.vecmath import fma
    from grace_tpu_torch.trace import splat as sp
    from grace_tpu_torch.trace import splat_grad as sg

    sph = make_clustered_particles(np.random.default_rng(seed), 1500)
    sph[:, 3] *= 4.0
    placed = [(2.0, 2.0, 0.1), (0.5, 0.5, 0.05), (1.0, 1.0, 0.55)]
    probe = torch.tensor([[0.5, 0.5, 0.5, 0.05]])
    b = sp.bucket_prims_ortho(probe, CAM, LOOK, UP, 4.0, LENGTH, 128, 128, tile_w=32,
                              tile_h=128)
    *_, x0, dx, y0, dy = sg._camera_numerics(sg.OrthoCamera(CAM, LOOK, UP, 4.0, LENGTH, 128,
                                                            128), "cpu")
    idx = torch.arange(48, 80, dtype=torch.float32)
    maps = {"row": (b.yrows[48:80, 0], fma(idx, dy, y0)),
            "col": (b.xcols[48:80, 0], fma(idx, dx, x0))}
    for axis, pair in maps.items():
        for centres in pair:
            placed += [_edge_particles(centres.numpy(), axis, 0.5, k) for k in range(-4, 5)]
    extra = np.array([[x, y, 0.5, h] for x, y, h in placed], np.float32)
    spheres = torch.from_numpy(np.concatenate([sph, extra]))
    return build_sph_tree(spheres.to(device), 16)[0]


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


def support_edge_scene(device, n=384, n_near=128, seed=5):
    """(spheres f32[n, 4], 32x32 ortho rays, near bool[n_rays, n]): n
    clustered particles with 4x the bench smoothing lengths, the last
    n_near of them each placed beside one ray at b = h (1 + k ulp), k in
    [-4, 4], so that u = b^2 / h^2 lands within a few ulp of 1, on both
    sides (``near`` marks those pairs). The trace kernels take a pair's
    integral only where u < 1."""
    from grace_tpu_torch.rays.gen import orthographic_projection_rays

    rays = orthographic_projection_rays(32, 32, CAM, LOOK, UP, VEXT, LENGTH, device=device)
    o, d = rays.origins.cpu().numpy(), rays.directions.cpu().numpy()
    sp = make_clustered_particles(np.random.default_rng(seed), n)
    sp[:, 3] *= 4.0
    rng = np.random.default_rng(seed + 1)
    near = np.zeros((rays.n_rays, n), bool)
    for j, i in enumerate(rng.choice(rays.n_rays, n_near, replace=False)):
        p = n - n_near + j
        side = np.cross(d[i], [0.0, 1.0, 0.0]).astype(np.float32)
        side /= np.linalg.norm(side)
        f = np.float32(1.0) + np.float32(j % 9 - 4) * np.finfo(np.float32).eps
        sp[p, :3] = o[i] + d[i] * np.float32(2.5) + side * (sp[p, 3] * f)
        near[i, p] = True
    return torch.from_numpy(sp).to(device), rays, torch.from_numpy(near).to(device)


def small_checks(dev):
    """Kernels vs plain versions at small and edge shapes; every route vs
    the generic engine."""
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
    # particles at the edge of a ray's support (u within a few ulp of 1)
    sp_e, rays_e, _ = support_edge_scene(dev)
    for route in ("quarter", "bitmask", "qlist", "list"):
        kernel, plain, args, ovf = route_inputs(route, rays_e, sp_e, None, 128)
        if bool(ovf.any()):
            raise AssertionError(f"edge scene: {route} lists overflow")
        errs = [check_kernel(f"support edge {route} {mode} deg {deg}", kernel, plain, args,
                             mode, deg)[0] for mode, deg in MODE_DEGS]
        log(f"check {kernel.__name__} kernel vs plain: {route} on particles at the edge of "
            f"the support, every mode and degree, max abs err {max(errs):.3g} OK")
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


def plane_rays(rng, aabbs, n, device):
    """``n`` axis-aligned rays (two zero direction components, some -0)
    whose origins lie on a plane of one of the boxes ``aabbs`` f32[k, 2, 3]
    (numpy) on a zero axis: the slab test meets (min - o) * inf = NaN."""
    from grace_tpu_torch.core.types import Rays

    o = np.empty((n, 3), np.float32)
    d = np.zeros((n, 3), np.float32)
    for i in range(n):
        axis = i % 3
        d[i, axis] = 1.0 if i % 2 else -1.0
        box = aabbs[rng.integers(len(aabbs))]
        o[i] = box[0] - 0.2 * d[i]
        plane = (axis + 1 + i % 2) % 3
        o[i, plane] = box[rng.integers(2), plane]
        d[i, (axis + 1) % 3] = -0.0 if i % 4 == 0 else 0.0
    return Rays.from_arrays(o, d, np.full(n, 1.5, np.float32), device=device)


def walk_edge_rays(rng, tree, centre, spread, n, length, device):
    """The rays the walk is held to its plain version on: ``n`` random rays
    from around ``centre``, n // 4 on box planes with zero direction
    components, and n // 8 that start outside the scene and point away
    from it (they miss every box)."""
    from grace_tpu_torch.core.types import Rays

    o = (np.asarray(centre) + spread * (rng.random((n, 3)) - 0.5)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    miss = n // 8
    o[:miss] = np.asarray(centre) + 10.0 * d[:miss]
    rays = Rays.from_arrays(o, d, np.full(n, length, np.float32), device=device)
    aabbs = tree.child_aabbs.reshape(-1, 2, 3).cpu().numpy()
    planes = plane_rays(rng, aabbs[np.isfinite(aabbs).all(axis=(1, 2))], n // 4, device)
    return Rays(*(torch.cat([a, b]) for a, b in zip(
        (rays.origins, rays.directions, rays.lengths),
        (planes.origins, planes.directions, planes.lengths))))


def walk_flags(rays, prims, tree, kind, stack_size):
    """The walk kernel's per-ray flags at ``stack_size`` (0; 1 where the
    stack overflowed; 2 where an overflowed walk repeats an entry forever
    and was cut: the plain walk would never end there)."""
    mode = "count" if kind == "sph" else "closest"
    return walk_outputs(rays, prims, tree, kind, mode, stack_size, "packet", visits=False)[1]


def walk_visits(rays, prims, tree, kind):
    """(internal nodes tested, primitives tested, most nodes on one ray) of
    the walk over ``rays``, from the kernel's visit counters (a count or
    closest launch of the per-ray walk with them on: the plain walk's work,
    unpruned, whatever walks it)."""
    mode = "count" if kind == "sph" else "closest"
    visits = walk_outputs(rays, prims, tree, kind, mode, 64, "per_ray")[2]
    tot = visits.long().sum(dim=0)
    return int(tot[0]), int(tot[1]), int(visits[:, 0].max())


def walk_outputs(rays, prims, tree, kind, mode, stack_size, route, weights=None, cursors=None,
                 capacity=0, stats=False, visits=True):
    """One launch of the walk kernel on ``route`` ("packet" or "per_ray")
    in ``mode``, through ``_launch_sph`` / ``_launch_tri``: (outputs,
    overflow flags, visits i32[R, 2] or None, stats i32[warps, 3] or None).
    The record modes write into buffers poisoned with -7 first."""
    from grace_tpu_torch.sph.kernel_integrals import DENSE_KERNEL_INTEGRAL_TABLE
    from grace_tpu_torch.trace import walk as wk

    n, dev = rays.n_rays, prims.device
    visits = torch.full((n, 2), -7, dtype=torch.int32, device=dev) if visits else None
    st = (torch.full((-(-n // wk.WARP), len(wk.STATS_FIELDS)), -7, dtype=torch.int32,
                     device=dev) if stats else None)
    if kind == "tri":
        outs = ((torch.empty(n, device=dev), torch.empty(n, dtype=torch.int32, device=dev))
                if mode == "closest" else (torch.empty(n, dtype=torch.bool, device=dev),))
        flags = wk._launch_tri(rays, prims, tree, mode, stack_size, outs, visits, st, route)
        return outs, flags, visits, st
    table = (torch.as_tensor(DENSE_KERNEL_INTEGRAL_TABLE, dtype=torch.float32, device=dev)
             if mode in ("cumulative", "records") else None)
    if mode in ("count", "cumulative"):
        outs = (torch.empty(n, device=dev, dtype=torch.int32 if mode == "count"
                            else torch.float32),)
        cursors, capacity = None, 0
    else:
        outs = tuple(torch.full((capacity,), -7, dtype=dt, device=dev) for dt in (
            (torch.int32, torch.float32, torch.float32) if mode == "records"
            else (torch.int32, torch.int32)))
    flags = wk._launch_sph(rays, prims, tree, mode, stack_size, table,
                           weights if mode == "cumulative" else None, cursors, capacity, outs,
                           visits, st, route)
    return outs, flags, visits, st


def packet_summary(stats):
    """(warps restarted, mean packet steps a warp, mean active lanes a step)
    from the packet walk's stats."""
    st = stats.long()
    return (int(st[:, 0].sum()), float(st[:, 1].double().mean()),
            float(st[:, 2].sum()) / max(1, int(st[:, 1].sum())))


def check_walk_routes(tag, rays, prims, tree, kind, stack_size=64, weights=None,
                      capacity=None):
    """The packet walk against the per-ray walk (PR 12's kernel, the
    restart route) on the same card tensors, in every mode of ``kind``:
    counts, cumulative sums (weights off and on), record buffers (every
    slot), ids, t and occlusion bit-equal; flags and visit counts equal but
    where the walk may differ by design (an occluded ray's any-hit walk;
    the closest walk pruned at stacks of PRUNE_STACK and above, on rays
    whose per-ray walk overflows). Returns (summary, restarted warps)."""
    from grace_tpu_torch.trace import walk as wk

    modes = wk.SPH_MODES if kind == "sph" else wk.TRI_MODES
    restarts, lines = 0, []
    cursors, cap = None, 0
    for mode in modes:
        for w in ((None, weights) if mode == "cumulative" and weights is not None else (None,)):
            if mode in ("records", "ids"):
                counts = walk_outputs(rays, prims, tree, kind, "count", stack_size,
                                      "per_ray")[0][0]
                cursors = (torch.cumsum(counts, dim=0, dtype=torch.int32) - counts).to(
                    torch.int32)
                cap = int(counts.sum()) if capacity is None else capacity
            got, flags, visits, st = walk_outputs(rays, prims, tree, kind, mode, stack_size,
                                                  "packet", w, cursors, cap, stats=True)
            want, flags_w, visits_w, _ = walk_outputs(rays, prims, tree, kind, mode,
                                                      stack_size, "per_ray", w, cursors, cap)
            label = f"{tag} packet vs per-ray walk, {mode}" + (", weights" if w is not None
                                                               else "")
            for i, (g, x) in enumerate(zip(got, want)):
                check_tensor_bits(f"{label} output {i}", g, x)
            same = torch.ones_like(flags, dtype=torch.bool)
            if mode == "any":
                same = ~want[0]
            elif mode == "closest" and stack_size >= wk.PRUNE_STACK:
                same = flags_w == 0
            check_equal(f"{label} flags", flags[same], flags_w[same])
            if mode not in ("closest", "any"):
                check_equal(f"{label} visits", visits, visits_w)
            r, steps, lanes = packet_summary(st)
            restarts += r
            lines.append(f"{mode}{' weighted' if w is not None else ''} {r} restarts, "
                         f"{steps:.1f} steps a warp, {lanes:.2f} lanes a step")
    return (f"{tag}: {rays.n_rays} rays, stack {stack_size}; the packet walk bit-equal to the "
            f"per-ray walk in every mode ({'; '.join(lines)})"), restarts


def check_walk_sph(tag, rays, spheres, tree, stack_size=64, weights=None, capacity=None):
    """walk_sph (the kernel on the card) against its plain version
    (engine.trace) on the same tensors: hit counts, record buffers (the
    (index, integral, distance) and (ray, prim) passes, every slot, fill
    and dropped writes included) bit-equal; cumulative sums, unweighted and
    with ``weights``, within rtol 1e-5, atol 1e-6 x max (a leaf's terms
    summed in another order). ``capacity`` (default: the hits) bounds the
    record buffers. Returns a summary."""
    from grace_tpu_torch.trace import walk as wk

    kw = dict(stack_size=stack_size)
    counts = wk.walk_sph(rays, spheres, tree, "count", **kw)
    check_equal(f"{tag} walk counts", counts, wk._walk_sph_plain(rays, spheres, tree, "count",
                                                                 **kw))
    errs = []
    for w in (None, weights):
        got = wk.walk_sph(rays, spheres, tree, "cumulative", weights=w, **kw)
        want = wk._walk_sph_plain(rays, spheres, tree, "cumulative", weights=w, **kw)
        errs.append(check_close(f"{tag} walk cumulative (weights {w is not None})", got, want,
                                1e-5, 1e-6 * float(want.abs().max()))[0])
    total = int(counts.sum())
    cap = total if capacity is None else capacity
    offsets = (torch.cumsum(counts, dim=0, dtype=torch.int32) - counts).to(torch.int32)
    for mode, fill in (("records", (-1, 0.5, -1.0)), ("ids", None)):
        rkw = dict(cursors=offsets, capacity=cap, fill=fill, **kw)
        got = wk.walk_sph(rays, spheres, tree, mode, **rkw)
        want = wk._walk_sph_plain(rays, spheres, tree, mode, **rkw)
        for i, (g, w) in enumerate(zip(got, want)):
            check_tensor_bits(f"{tag} walk {mode} buffer {i}", g, w)
    return (f"{tag}: {rays.n_rays} rays, {total} hits (capacity {cap}), stack {stack_size}; "
            f"counts and records bit-equal, cumulative max abs err {max(errs):.3g}")


def check_walk_tri(tag, rays, tris, tree, stack_size=64):
    """walk_tri against its plain version on the same tensors: closest ids
    and t, and occlusion, bit-equal. Returns a summary."""
    from grace_tpu_torch.trace import walk as wk

    t, ids = wk.walk_tri(rays, tris, tree, "closest", stack_size)
    t_p, ids_p = wk._walk_tri_plain(rays, tris, tree, "closest", stack_size)
    check_equal(f"{tag} walk closest ids", ids, ids_p)
    check_tensor_bits(f"{tag} walk closest t", t, t_p)
    occ = wk.walk_tri(rays, tris, tree, "any", stack_size)
    check_equal(f"{tag} walk any", occ, wk._walk_tri_plain(rays, tris, tree, "any", stack_size))
    return (f"{tag}: {rays.n_rays} rays, stack {stack_size}; {int((ids >= 0).sum())} closest "
            f"hits and {int(occ.sum())} occluded, ids, t and occlusion bit-equal")


def walk_small_checks(dev):
    """The walk kernel against its plain version at edge shapes: clustered
    particles at 16 a leaf and at 1 a leaf (every leaf one primitive),
    rays on box planes with zero direction components and rays that miss
    everything, weights on and off, record buffers of the hits and of half
    of them (writes past the end dropped), a stack of 4 (on the rays whose
    walk ends; it overflows on others too); triangles of a random mesh and
    a small torus, closest and any, stacks of 64 and 4; the packet walk
    against the per-ray walk (``check_walk_routes``) on the same shapes at
    a ragged ray count (1,250), no warp restarting at a stack of 64 and
    some at 4; and the overflow flag raising with the plain walk's message
    under GRACE_TPU_DEBUG. Returns the summaries."""
    from grace_tpu_torch.build.sph import build_sph_tree
    from grace_tpu_torch.core.errors import GraceError
    from grace_tpu_torch.models import triangle as mt
    from grace_tpu_torch.trace import walk as wk

    rng = np.random.default_rng(17)
    lines = []
    particles = torch.from_numpy(make_clustered_particles(rng, 3000)).to(dev)
    weights = torch.from_numpy((0.5 + rng.random(3000)).astype(np.float32)).to(dev)
    for mpl in (16, 1):
        ss, tree, _ = build_sph_tree(particles, mpl)
        if mpl == 1 and int(tree.leaves[:, 1].max()) != 1:
            raise AssertionError("edge case lost: a leaf holds more than one primitive")
        rays = walk_edge_rays(rng, tree, (0.5, 0.5, 0.5), 0.8, 1024, 1.2, dev)
        lines.append(check_walk_sph(f"clustered, {mpl} a leaf", rays, ss, tree,
                                    weights=weights))
        hits = int(wk.walk_sph(rays, ss, tree, "count").sum())
        lines.append(check_walk_sph(f"clustered, {mpl} a leaf, half capacity", rays, ss, tree,
                                    capacity=hits // 2))
        flags = walk_flags(rays, ss, tree, "sph", 4)
        if not (bool((flags == 1).any()) and int((flags == 0).sum()) > 0):
            raise AssertionError("edge case lost: a stack of 4 overflows nowhere")
        keep = flags != 2
        lines.append(check_walk_sph(f"clustered, {mpl} a leaf, {int(keep.sum())} rays whose "
                                    f"walk ends", rays[keep], ss, tree, stack_size=4,
                                    weights=weights) + f" ({int((flags == 1).sum())} overflow)")
    for name, tris in (("random mesh", random_mesh(rng, 2000)), ("torus", torus_mesh(48, 24))):
        st, tree, _ = mt.build_triangle_tree(torch.from_numpy(tris).to(dev))
        rays = walk_edge_rays(rng, tree, (0.5, 0.5, 0.5) if name != "torus" else (0, 0, 0),
                              2.0, 1024, 4.0, dev)
        lines.append(check_walk_tri(name, rays, st, tree))
        flags = walk_flags(rays, st, tree, "tri", 4)
        keep = flags != 2
        lines.append(check_walk_tri(f"{name}, {int(keep.sum())} rays whose walk ends",
                                    rays[keep], st, tree, stack_size=4)
                     + f" ({int((flags == 1).sum())} overflow)")
    # the packet walk against the per-ray walk (PR 12's kernel, its restart
    # route) on the same edge shapes: a ragged ray count, stacks of 64
    # (no warp restarts) and 4 (warps restart)
    for mpl in (16, 1):
        ss, tree, _ = build_sph_tree(particles, mpl)
        rays = walk_edge_rays(rng, tree, (0.5, 0.5, 0.5), 0.8, 1000, 1.2, dev)
        for stack in (64, 4):
            line, restarts = check_walk_routes(f"clustered, {mpl} a leaf", rays, ss, tree,
                                               "sph", stack, weights=weights)
            if (restarts > 0) != (stack == 4):
                raise AssertionError(f"{line}: restarts {restarts} at stack {stack}")
            lines.append(line)
    for name, tris in (("random mesh", random_mesh(rng, 2000)), ("torus", torus_mesh(48, 24))):
        st, tree, _ = mt.build_triangle_tree(torch.from_numpy(tris).to(dev))
        rays = walk_edge_rays(rng, tree, (0.5, 0.5, 0.5) if name != "torus" else (0, 0, 0),
                              2.0, 1000, 4.0, dev)
        for stack in (64, 4):
            line, restarts = check_walk_routes(name, rays, st, tree, "tri", stack)
            if (restarts > 0) != (stack == 4):
                raise AssertionError(f"{line}: restarts {restarts} at stack {stack}")
            lines.append(line)
    # the overflow flag: both walks raise with the same message under debug
    ss, tree, _ = build_sph_tree(particles, 16)
    rays = walk_edge_rays(np.random.default_rng(5), tree, (0.5, 0.5, 0.5), 0.8, 256, 1.2, dev)
    rays = rays[walk_flags(rays, ss, tree, "sph", 4) != 2]
    saved = os.environ.get("GRACE_TPU_DEBUG")
    os.environ["GRACE_TPU_DEBUG"] = "1"
    messages = []
    try:
        for fn in (wk.walk_sph, wk._walk_sph_plain):
            try:
                fn(rays, ss, tree, "count", stack_size=4)
            except GraceError as e:
                messages.append(str(e))
    finally:
        if saved is None:
            del os.environ["GRACE_TPU_DEBUG"]
        else:
            os.environ["GRACE_TPU_DEBUG"] = saved
    if len(messages) != 2 or messages[0] != messages[1] or wk.OVERFLOW_MESSAGE not in messages[0]:
        raise AssertionError(f"overflow under GRACE_TPU_DEBUG: {messages}")
    lines.append(f"stack of 4 under GRACE_TPU_DEBUG: the kernel and the plain walk raise "
                 f"'{messages[0]}'")
    return lines


def count_gate(tag, rays, spheres, got, want):
    """The walk's hit counts ``got`` against a fused route's ``want`` on the
    same rays: equal on every ray but those where the two pair tests round
    apart. The engine's test sums the dot product x, y, z
    (``ops.intersect.sphere_hit``), the routes' y, x, z
    (``pallas_kernel._impact``, ``seg_compute.cuh``), so a particle within
    an ulp of a ray's boundary can be hit in one and not the other. At most
    1 ray in 10,000 may differ, and on each the walk's count must equal the
    engine test's over every particle and the route's the route test's.
    Returns the number of such rays."""
    from grace_tpu_torch.ops.intersect import sphere_hit
    from grace_tpu_torch.trace import pallas_kernel as pk

    diff = torch.nonzero(got != want).flatten().tolist()
    if len(diff) > max(1, rays.n_rays // 10_000):
        raise AssertionError(f"{tag}: hit counts differ on {len(diff)} rays")
    x, y, z, h = spheres.unbind(dim=1)
    for r in diff:
        o, d, ln = rays.origins[r], rays.directions[r], rays.lengths[r]
        engine = sphere_hit(o, d, ln, spheres)[0]
        b2, dot, *_ = pk._impact(x, y, z, *o.unbind(), *d.unbind())
        route = (b2 < h * h) & (dot >= 0.0) & (dot < ln)
        if int(engine.sum()) != int(got[r]) or int(route.sum()) != int(want[r]):
            raise AssertionError(f"{tag}: ray {r}'s counts differ off the rounding boundary")
    return len(diff)


def records_by_ray_and_index(ray, index, integral, distance):
    """Flat records sorted by (ray, index): an order that does not depend
    on the distances, which two paths may round apart."""
    order = torch.argsort(index, stable=True)
    order = order[torch.argsort(ray[order], stable=True)]
    return ray[order], index[order], integral[order], distance[order]


def records_gate(flat, rec_sorted, keep):
    """trace_sph(engine="xla")'s flat records against the record route's
    sorted rows (B16, ``sort_records_by_distance``) on the rays ``keep``
    (rows that did not overflow, counts equal): the same particles on every
    ray; distances within rtol 1e-6, atol 1e-6 (each path sums the dot
    product in its own order, ``count_gate``); integrals within 5e-4 x max
    (the table lerp against the Horner fit, grace_tpu's route-vs-engine
    tolerance). Both sides are compared in (ray, index) order. Returns
    (records compared, distances that differ, their max abs err, the
    integrals' max abs err)."""
    n_rays, cap = rec_sorted.indices.shape
    dev = flat.counts.device
    ray_flat = torch.repeat_interleave(torch.arange(n_rays, device=dev), flat.counts.long(),
                                       output_size=int(flat.total_hits))
    sel = keep[ray_flat]
    xla = records_by_ray_and_index(ray_flat[sel], flat.indices[:ray_flat.numel()][sel],
                                   flat.integrals[:ray_flat.numel()][sel],
                                   flat.distances[:ray_flat.numel()][sel])
    valid = (torch.arange(cap, device=dev)[None, :] < rec_sorted.counts[:, None]) & keep[:, None]
    rows = torch.arange(n_rays, device=dev)[:, None].expand(n_rays, cap)
    b16 = records_by_ray_and_index(rows[valid], rec_sorted.indices[valid],
                                   rec_sorted.integrals[valid], rec_sorted.distances[valid])
    check_equal("records: rays", xla[0], b16[0])
    check_equal("records: particle indices", xla[1], b16[1])
    dist_err, _ = check_close("records: distances", xla[3], b16[3], 1e-6, 1e-6)
    int_err, _ = check_close("records: integrals", xla[2], b16[2], 0.0,
                             5e-4 * float(b16[2].abs().max()))
    return xla[0].numel(), int((xla[3] != b16[3]).sum()), dist_err, int_err


def torus_engine_gate(tris, img_x, side):
    """render_triangles(engine="xla") (the walk) against engine="pallas"
    (tri.cu) on the torus. The two round the triangle test differently
    (ROADMAP C12), so: the closest ids equal on every ray but explained
    edge rays (``explain_edge_rays``); each path's t bit-equal to its own
    test's (``intersect_triangle``, ``pallas_tri._mt_candidates``) on its
    triangle, so that where the ids agree t differs only by the tests'
    roundings (the relative difference is reported);
    on the pallas pass's shadow rays the walk's occlusion equals tri.cu's
    but on at most 1 ray in 100, each with a triangle the two tests
    disagree on; and the images equal bit for bit on every pixel whose
    closest id and occlusion agree between the two renders. Returns (a
    summary, the primary and shadow rays, sorted triangles, tree and the
    walk's closest hits)."""
    import math

    from grace_tpu_torch.models import triangle as mt
    from grace_tpu_torch.rays.gen import pinhole_camera_rays
    from grace_tpu_torch.trace import pallas_tri as pt

    img_p = mt.render_triangles(tris, resolution=side, engine="pallas")
    sorted_tris, tree, _ = mt.build_triangle_tree(tris)
    cam, look, length = mt.auto_camera(sorted_tris, side)
    rays = pinhole_camera_rays(side, side, cam.tolist(), look.tolist(), (0.0, 1.0, 0.0),
                               math.pi / 3, float(length), device=tris.device)
    t_p, id_p, _ = pt.pallas_trace_tri(rays, sorted_tris)
    closest_x = mt.trace_closest_hit(rays, sorted_tris, tree)
    n_edge = explain_edge_rays("torus ids, walk vs pallas", rays, sorted_tris, id_p,
                               closest_x.tri)
    # t: each path's exactly its own test's on its triangle, so where the
    # ids agree the two differ only by the tests' roundings
    packed = pt._pack_tris(sorted_tris)[0]
    cols = [c[:, None] for c in (*rays.origins.unbind(1), *rays.directions.unbind(1),
                                 rays.lengths)]
    for name, t, ids in (("walk", closest_x.t, closest_x.tri), ("pallas", t_p, id_p)):
        hit = ids >= 0
        tri = torch.clamp(ids, min=0).long()
        if name == "walk":
            own = mt.intersect_triangle(rays.origins, rays.directions, rays.lengths,
                                        sorted_tris[tri])[1]
        else:
            lanes = packed.permute(0, 2, 1).reshape(-1, 16)[tri]
            own = pt._mt_candidates(lanes[:, :, None], *cols)[:, 0]
        check_tensor_bits(f"torus {name} t vs its own test", t[hit], own[hit])
    agree = (closest_x.tri == id_p) & (id_p >= 0)
    t_rel = ((closest_x.t - t_p).abs() / t_p.abs())[agree]
    t_err, n_t = float(t_rel.max()), int((t_rel > 1e-6).sum())
    light = (0.3, 1.0, 0.6)
    _, _, shadow_p = mt.shadow_inputs(rays, sorted_tris, mt.ClosestHit(t_p, id_p), light, length)
    _, _, shadow_x = mt.shadow_inputs(rays, sorted_tris, closest_x, light, length)
    occ_pp = pt.pallas_trace_tri(shadow_p, sorted_tris, mode="any")[0]
    occ_xp = mt.trace_any_hit(shadow_p, sorted_tris, tree)
    occ_xx = mt.trace_any_hit(shadow_x, sorted_tris, tree)
    hit = torch.isfinite(t_p)
    any_diff = torch.nonzero((occ_xp != occ_pp) & hit).flatten().tolist()
    if len(any_diff) > rays.n_rays // 100:
        raise AssertionError(f"torus shadow rays: occlusion differs on {len(any_diff)} rays")
    for b in any_diff:
        r = shadow_p[b:b + 1]
        hit_e, _ = mt.intersect_triangle(r.origins[:, None], r.directions[:, None],
                                         r.lengths[:, None], sorted_tris[None])
        cols = [r.origins[:, 0], r.origins[:, 1], r.origins[:, 2], r.directions[:, 0],
                r.directions[:, 1], r.directions[:, 2], r.lengths]
        t_k = pt._mt_candidates(packed, *[c[:, None] for c in cols]).flatten()
        t_k = t_k[:sorted_tris.shape[0]]
        if not bool((hit_e[0] != (t_k < pt.BIG)).any()):
            raise AssertionError(f"torus shadow ray {b}: occlusion differs off an edge")
    same = (closest_x.tri == id_p) & (occ_xx == occ_pp)
    check_tensor_bits("torus image where ids and occlusion agree", img_x.flatten()[same],
                      img_p.flatten()[same])
    return (f"closest ids equal but on {n_edge} explained edge rays; each path's t "
            f"bit-equal to its own test's, where the ids agree within rel {t_err:.3g} ({n_t} "
            f"past 1e-6: the tests' roundings); on the pallas shadow rays occlusion equal but on {len(any_diff)} "
            f"explained rays; image bit-equal on {int(same.sum())} of {rays.n_rays} pixels "
            f"({int((~same).sum())} where the renders' ids or occlusion differ)"), dict(
                rays=rays, shadow=shadow_x, sorted_tris=sorted_tris, tree=tree,
                closest=closest_x)


def engine_path(dev, scene, tris, entry_args, side):
    """Main path 8, the generic engine's walk, through the facades a user
    calls, with the walk's launch counters and engine.trace's call counter
    set to 0 first: the driver entry's forward (``entry_forward``), on
    ``scene`` (path 1's) trace_hitcounts_sph, trace_cumulative_sph and
    trace_sph(engine="xla") over every ray, and render_triangles(engine=
    "xla") of ``tris`` at ``side`` x ``side``. Gates: the entry's walk
    against the plain walk (``check_walk_sph``); on the scene, hit counts
    against the default route (B6, ``count_gate``), sums within 5e-4 x max
    of it (table against Horner), the records against the record route's
    sorted rows (B16, ``records_gate``), and every WALK_SUBSET-th ray's
    count and sum against the plain walk; the torus image against
    engine="pallas" (``torus_engine_gate``); the packet walk bit-equal to
    the per-ray walk (PR 12's kernel) in every mode on the entry, the bench
    scene and the torus's primary and shadow rays, with no warp restarting
    at the default stack (``check_walk_routes``). Returns launches, the
    plain walk's calls, wall time, lines and what the timing needs."""
    from grace_tpu_torch.build.sph import build_sph_tree
    from grace_tpu_torch.core.types import Rays
    from grace_tpu_torch.models import triangle as mt
    from grace_tpu_torch.trace import engine
    from grace_tpu_torch.trace import pallas_kernel as pk
    from grace_tpu_torch.trace import pallas_records as prc
    from grace_tpu_torch.trace import walk as wk
    from grace_tpu_torch.trace.sph import trace_cumulative_sph, trace_hitcounts_sph, trace_sph

    ss, tree, rays = scene["spheres"], scene["tree"], scene["rays"]
    route_cd, ovf = pk.pallas_trace_sph(rays, ss, tree, tile=TRACE_TILE)
    route_hc, ovf_h = pk.pallas_trace_sph(rays, ss, tree, tile=TRACE_TILE, mode="hitcount")
    if bool(ovf.any()) or bool(ovf_h.any()):
        raise AssertionError("path 8: the default route overflows")
    capacity = int(route_hc.sum()) + 1024   # room for rays the two pair tests round apart
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    wk.walk_sph.launches = wk.walk_tri.launches = engine.trace.calls = 0
    t0 = time.perf_counter()
    entry = entry_forward(*entry_args)
    hc = trace_hitcounts_sph(rays, ss, tree)
    cd = trace_cumulative_sph(rays, ss, tree)
    flat = trace_sph(rays, ss, tree, capacity=capacity)
    img = mt.render_triangles(tris, resolution=side, engine="xla")
    sync()
    wall = time.perf_counter() - t0
    launches = {"bvh_walk_sph": wk.walk_sph.launches, "bvh_walk_tri": wk.walk_tri.launches}
    plain_calls = engine.trace.calls
    lines = []

    # the driver entry: the walk against the plain walk on the same card
    ss_e, tree_e, _ = build_sph_tree(entry_args[0], max_per_leaf=16)
    rays_e = Rays(*entry_args[1:])
    if entry.shape != (rays_e.n_rays,) or not bool(torch.isfinite(entry).all()):
        raise AssertionError("path 8 entry forward: bad shape or non-finite values")
    check_tensor_bits("path 8 entry forward vs its walk", entry,
                      wk.walk_sph(rays_e, ss_e, tree_e, "cumulative"))
    lines.append("driver entry " + check_walk_sph("vs the plain walk", rays_e, ss_e, tree_e))
    packet = {}   # the kernel's routes: on the card only
    for tag, args in (("driver entry", (rays_e, ss_e, tree_e, "sph")),
                      ("bench scene", (rays, ss, tree, "sph"))) if dev.type == "cuda" else ():
        line, packet[tag] = check_walk_routes(tag, *args)
        lines.append(line)

    # the bench scene: the routes, the records, the plain walk on a subset
    n_diff = count_gate("path 8 walk vs default route", rays, ss, hc, route_hc)
    err, top = check_close("path 8 walk sums vs default route", cd, route_cd, 0.0,
                           5e-4 * float(route_cd.abs().max()))
    lines.append(f"bench scene: {rays.n_rays} rays, {int(hc.sum())} hits; hit counts equal the "
                 f"default route's but on {n_diff} rays where the pair tests round apart (each "
                 f"explained); sums max abs err {err:.3g} (max {top:.3g}, gate 5e-4 x max)")
    check_equal("path 8 trace_sph counts", flat.counts, hc)
    check_equal("path 8 trace_sph offsets", flat.offsets,
                (torch.cumsum(hc, dim=0) - hc).to(torch.int32))
    if int(flat.total_hits) != int(hc.sum()) or int(flat.total_hits) > capacity:
        raise AssertionError("path 8 trace_sph: total_hits != sum of counts, or overflow")
    rec = prc.sort_records_by_distance(prc.pallas_trace_sph_records(rays, ss, RECORD_CAP))
    keep = (rec.counts <= RECORD_CAP) & (rec.counts == hc)
    n_rec, n_dist, dist_err, int_err = records_gate(flat, rec, keep)
    del rec
    lines.append(f"trace_sph(engine=\"xla\"), capacity {capacity}: {int(flat.total_hits)} "
                 f"records; on {int(keep.sum())} rays (rows of B16 that did not overflow) "
                 f"{n_rec} records, the same particles as B16's sorted rows, distances within "
                 f"{dist_err:.3g} ({n_dist} differ), integrals within {int_err:.3g} (table "
                 "against Horner)")
    del flat
    sub = torch.arange(0, rays.n_rays, WALK_SUBSET, device=dev)
    check_equal("path 8 subset counts vs the plain walk", hc[sub],
                wk._walk_sph_plain(rays[sub], ss, tree, "count"))
    want = wk._walk_sph_plain(rays[sub], ss, tree, "cumulative")
    sub_err, _ = check_close("path 8 subset sums vs the plain walk", cd[sub], want, 1e-5,
                             1e-6 * float(want.abs().max()))
    lines.append(f"{sub.numel()} rays (every {WALK_SUBSET}th) vs the plain walk: counts "
                 f"bit-equal, sums max abs err {sub_err:.3g}")
    summary, torus = torus_engine_gate(tris, img, side)
    lines.append(f"torus ({tris.shape[0]} triangles, {side}x{side}): {summary}")
    for tag, r in ((("torus primary rays", torus["rays"]), ("torus shadow rays", torus["shadow"]))
                   if dev.type == "cuda" else ()):
        line, packet[tag] = check_walk_routes(tag, r, torus["sorted_tris"], torus["tree"], "tri")
        lines.append(line)
    if any(packet.values()):
        raise AssertionError(f"path 8: packet warps restarted at the default stack: {packet}")
    return dict(launches=launches, plain_calls=plain_calls, wall=wall, lines=lines, hc=hc,
                cd=cd, sub=sub, sub_err=sub_err, capacity=capacity, entry=(ss_e, tree_e, rays_e),
                torus=torus)


def training_scene(dev, whole_image, n=3000, seed=11):
    """Edge scene of the training kernels: n clustered particles (not a
    multiple of 128), Morton-sorted; 5 with h = 0 and 3 beyond the far
    plane (dead); with ``whole_image``, particle 100 at the center with
    h = 5, whose segment covers every tile. Returns (spheres, weights)."""
    from grace_tpu_torch.build.sph import build_sph_tree

    sp = make_clustered_particles(np.random.default_rng(seed), n)
    ss, _, _ = build_sph_tree(torch.from_numpy(sp).to(dev), 16)
    ss = ss.clone()
    ss[:5, 3] = 0.0
    ss[5:8, 2] = 50.0
    if whole_image:
        ss[100] = torch.tensor([0.5, 0.5, 0.5, 5.0], device=dev)
    w = np.random.default_rng(seed + 1).random(n).astype(np.float32) + 0.5
    return ss, torch.from_numpy(w).to(dev)


def sortfree_inputs(spheres, weights, cam, tile_w, tile_h=128):
    """(masks, transposed masks, coords, slabs) of the sort-free splat, as
    splat_forward_sortfree and splat_backward_sortfree prepare them
    (sortfree_setup: csrc/splat_prep.cu on CUDA tensors)."""
    from grace_tpu_torch.trace import splat_grad as sg

    return sg.sortfree_setup(spheres, weights, cam, tile_w, tile_h)


def check_sortfree(tag, inputs, g_image, basis, tile_w, bwd_rel, tile_h=128):
    """Both sort-free kernels against their plain versions: the image
    within 1e-5 x max (f32 sums in another order); each gradient row
    within ``bwd_rel`` x its max (grace_tpu's gradient bounds: 3e-5, and
    5e-4 where a footprint covers the whole image). Returns the max abs
    errors (image, gradients)."""
    height, width = g_image.shape
    err_f, top = check_sortfree_fwd(tag, inputs, basis, tile_w, tile_h, height, width)
    err_b = check_sortfree_bwd(tag, inputs, g_image, basis, tile_w, bwd_rel, tile_h)
    log(f"check splat_sortfree kernels vs plain: {tag} tile_w {tile_w} {basis}: image "
        f"max abs err {err_f:.3g} (max value {top:.3g}), gradients max abs err {err_b:.3g} OK")
    return err_f, err_b


def check_sortfree_bwd(tag, inputs, g_image, basis, tile_w, bwd_rel, tile_h=128):
    """The sort-free backward against its plain version: each gradient row
    within ``bwd_rel`` x its max, the padding rows zero. Returns the max
    abs error."""
    from grace_tpu_torch.trace import splat_grad as sg

    _, masks_t, coords, slabs = inputs
    deg, a_c, b_c = sg._basis_coeffs(basis)
    ntx = g_image.shape[1] // tile_h
    got = sg.splat_sortfree_bwd(masks_t, coords, slabs, g_image, basis, tile_w, tile_h)
    want = sg._sortfree_bwd_plain(masks_t, coords, slabs, g_image, a_c, b_c, ntx, tile_w,
                                  tile_h)
    torch.cuda.synchronize()
    err_b = 0.0
    for r in range(4):
        scale = float(want[:, r].abs().max())
        err_b = max(err_b, check_close(f"{tag} splat_sortfree_bwd {basis} row {r}",
                                       got[:, r], want[:, r], 0.0, bwd_rel * scale)[0])
    if not torch.equal(got[:, 4:], torch.zeros_like(got[:, 4:])):
        raise AssertionError(f"{tag} splat_sortfree_bwd: padding rows not zero")
    return err_b


def check_sortfree_fwd(tag, inputs, basis, tile_w, tile_h, height, width, order="heaviest"):
    """The sort-free forward against the dense contraction (bit-equal) and
    its plain version (within 1e-5 x max), tiles in ``order``: "heaviest"
    (the wrapper's), None (as listed) or an i32 permutation. Returns (max
    abs error against the plain version, max value)."""
    from grace_tpu_torch.trace import splat_grad as sg

    masks, _, coords, slabs = inputs
    deg, a_c, b_c = sg._basis_coeffs(basis)
    if isinstance(order, str):
        got = sg.splat_sortfree_fwd(masks, coords, slabs, basis, tile_w, tile_h, height, width)
    else:
        got = sg._sortfree_fwd_launch(masks, coords, slabs, basis, tile_w, tile_h, height, width,
                                      order)
    want = sg._sortfree_fwd_plain(masks, coords, slabs, a_c, b_c, width // tile_h, tile_w,
                                  tile_h, height, width)
    dense = sortfree_fwd_dense(masks, coords, slabs, basis, tile_w, tile_h, height, width)
    torch.cuda.synchronize()
    check_equal(f"{tag} splat_sortfree_fwd {basis} vs the dense contraction", got, dense)
    return check_close(f"{tag} splat_sortfree_fwd {basis}", got, want, 0.0,
                       1e-5 * float(want.abs().max()))


# Edge shapes of the splat kernels on splat_edge_scene: (tile_w, tile_h,
# band, chunk) of the bucketed splat, (tile_w, tile_h) of the sort-free
# forward (band: the largest divisor of tile_h up to 32); launch orders.
SPLAT_EDGE_CASES = ((32, 128, 32, 64), (32, 128, None, 64), (16, 64, 16, 64),
                    (8, 64, 64, 64), (64, 128, 64, 64))
SORTFREE_EDGE_CASES = ((8, 128), (64, 128), (32, 16), (16, 64))
EDGE_ORDERS = ("heaviest", "listed", "reversed")
SORTFREE_BWD_EDGE_ROWS = (8, 16, 32, 64)   # tile_w of the backward's edge checks (tile_h 128)


def _edge_order(name, counts):
    """The launch order ``name`` of work units with ``counts``: the
    wrappers' (a string), None (as listed) or heaviest last."""
    from grace_tpu_torch import _kernels

    if name == "heaviest":
        return name
    if name == "listed":
        return None
    return _kernels.longest_first(counts).flip(0).to(torch.int32)


def splat_edge_check(dev, case, order, basis="deg8", zero_scale=False):
    """splat.cu on splat_edge_scene at one of SPLAT_EDGE_CASES (with
    ``zero_scale``, every third instance's scale set to 0) in one of
    EDGE_ORDERS, against the dense contraction and the plain version."""
    from grace_tpu_torch.trace import splat as sp

    tile_w, tile_h, band, chunk = case
    b = sp.bucket_prims_ortho(splat_edge_scene(dev), CAM, LOOK, UP, 4.0, LENGTH, 128, 128,
                              tile_w=tile_w, tile_h=tile_h, chunk=chunk, band=band)
    counts = b.last - b.first
    if int(counts.max()) <= 4 * chunk or (case == SPLAT_EDGE_CASES[0] and not (
            bool((counts == 0).any()) and bool((counts == 1).any()))):
        raise AssertionError("edge case lost: no key over several slabs, or no empty key or "
                             "none of one instance")
    if zero_scale:
        slabs = b.slabs.clone()
        slabs[:, 3, ::3] = 0.0
        slabs[:, 7, 1::3] = 0.0
        b = b._replace(slabs=slabs)
    return check_splat(f"edge {case} {order}{' scale 0' if zero_scale else ''}", b, basis,
                       tile_w, tile_h, _edge_order(order, counts))


def sortfree_edge_check(dev, case, order, basis="deg8"):
    """The sort-free forward on splat_edge_scene (weights 1, 5 particles
    dead) at one of SORTFREE_EDGE_CASES in one of EDGE_ORDERS, against the
    dense contraction and the plain version."""
    from grace_tpu_torch.trace import splat_grad as sg

    tile_w, tile_h = case
    spheres = splat_edge_scene(dev).clone()
    spheres[::300, 3] = 0.0
    cam = sg.OrthoCamera(CAM, LOOK, UP, 4.0, LENGTH, 128, 128)
    inputs = sortfree_inputs(spheres, torch.ones(spheres.shape[0], device=dev), cam, tile_w,
                             tile_h)
    counts = _popcount_rows(inputs[0])
    if case == SORTFREE_EDGE_CASES[0] and not bool((counts == 0).any()):
        raise AssertionError("edge case lost: no tile without a segment")
    return check_sortfree_fwd(f"edge {case} {order}", inputs, basis, tile_w, tile_h, 128, 128,
                              _edge_order(order, counts))


def sortfree_bwd_edge_check(dev, tile_w, basis):
    """The sort-free backward on splat_edge_scene (weights 1, 5 particles
    dead; footprint edges at d^2 within a few ulp of 1 from a pixel centre,
    footprints covering whole 32 x 32 patches) at tile_w x 128, a seeded
    normal cotangent, against its plain version."""
    from grace_tpu_torch.trace import splat_grad as sg

    spheres = splat_edge_scene(dev).clone()
    spheres[::300, 3] = 0.0
    cam = sg.OrthoCamera(CAM, LOOK, UP, 4.0, LENGTH, 128, 128)
    inputs = sortfree_inputs(spheres, torch.ones(spheres.shape[0], device=dev), cam, tile_w)
    g = torch.randn(128, 128, generator=torch.Generator().manual_seed(tile_w)).to(dev)
    return check_sortfree_bwd(f"edge tile_w {tile_w}", inputs, g, basis, tile_w, 3e-5)


def splat_edge_checks(dev):
    """Both splat kernels at every edge shape and launch order."""
    for case in SPLAT_EDGE_CASES:
        for order in EDGE_ORDERS:
            err, top = splat_edge_check(dev, case, order)
            log(f"check splat kernel vs dense (bit-equal) and plain: edge scene {case} {order}: "
                f"max abs err {err:.3g} (max value {top:.3g}) OK")
    for basis, zero in (("deg10", False), ("deg8", True)):
        err, top = splat_edge_check(dev, SPLAT_EDGE_CASES[0], "heaviest", basis, zero)
        log(f"check splat kernel vs dense and plain: edge scene {basis}, scale 0 {zero}: max abs "
            f"err {err:.3g} OK")
    for case in SORTFREE_EDGE_CASES:
        for order in EDGE_ORDERS:
            err, top = sortfree_edge_check(dev, case, order)
            log(f"check splat_sortfree_fwd kernel vs dense (bit-equal) and plain: edge scene "
                f"{case} {order}: max abs err {err:.3g} (max value {top:.3g}) OK")
    for tile_w in SORTFREE_BWD_EDGE_ROWS:
        for basis in ("deg8", "deg10"):
            err = sortfree_bwd_edge_check(dev, tile_w, basis)
            log(f"check splat_sortfree_bwd kernel vs plain: edge scene tile_w {tile_w} {basis}: "
                f"gradients max abs err {err:.3g} OK")


def render_inputs(rays, spheres, weights, g, tile, max_chunks, max_tiles):
    """((fwd args), fwd overflow, (bwd args), bwd overflow) of the fused
    renderer's kernels, as _fused_forward and _fused_backward prepare them."""
    from grace_tpu_torch.trace import pallas_kernel as pk
    from grace_tpu_torch.trace import pallas_render as pr
    from grace_tpu_torch.trace.pallas_broadphase import dense_tile_segments

    ids, n, ovf = dense_tile_segments(rays, spheres, tile, max_chunks)
    t_ids, n_t, ovf_t = pr.dense_segment_tiles(rays, spheres, pr.BWD_TILE, max_tiles)
    return ((n, ids, pk._pack_rays(rays, tile)[0], pr._pack_prims_3d(spheres, weights)[0]),
            ovf, (n_t, t_ids, pr._pack_prims_sub(spheres, weights)[0],
                  pr._pack_rays_bwd(rays, g)[0]), ovf_t)


def check_render_bwd(tag, bwd_args):
    """The fused renderer's backward kernel against its plain version: each
    gradient column within 1e-5 x its max (the fused gradients' bound
    against grace_tpu). Returns the max abs error."""
    from grace_tpu_torch.trace import pallas_render as pr

    got = pr.render_bwd(*bwd_args)
    want = pr._render_bwd_plain(*bwd_args)
    torch.cuda.synchronize()
    err_b = 0.0
    for c in range(8):
        scale = float(want[..., c].abs().max())
        err_b = max(err_b, check_close(f"{tag} render_bwd column {c}", got[..., c],
                                       want[..., c], 0.0, 1e-5 * scale)[0])
    return err_b


def check_render_fwd(tag, fwd_args):
    """The fused renderer's forward against its plain version: column
    densities within rtol 1e-5, atol 1e-6 x max; its tiles launched as the
    wrapper does (longest list first), then as listed and shortest first,
    each of these into an output of its own filled with a poison value
    (kept alive, so that a ray no block wrote shows), held against the
    plain version as the wrapper's launch and bit-equal to it. Returns
    (max abs err, max value)."""
    from grace_tpu_torch.trace import pallas_kernel as pk
    from grace_tpu_torch.trace import pallas_render as pr

    got = pr.render_fwd(*fwd_args)
    want = pr._render_fwd_plain(*fwd_args)
    atol = 1e-6 * float(want.abs().max())
    shortest = pk.list_tile_order(fwd_args[0], fwd_args[1].shape[1]).flip(0).contiguous()
    kept = []
    for name, order in (("as listed", None), ("shortest list first", shortest)):
        out = torch.empty_like(got)
        out.view(torch.int32).fill_(-7)
        kept.append(pr._render_fwd_launch(*fwd_args, order, out))
        check_close(f"{tag} render_fwd {name}", out, want, 1e-5, atol)
        check_equal(f"{tag} render_fwd {name} vs the wrapper's order", out, got)
    torch.cuda.synchronize()
    return check_close(f"{tag} render_fwd", got, want, 1e-5, atol)


def check_render(tag, fwd_args, bwd_args):
    """Both fused-render kernels against their plain versions: the
    forward as ``check_render_fwd``, the gradients as
    ``check_render_bwd``. Returns the max abs errors (values, gradients)."""
    err_f, top = check_render_fwd(tag, fwd_args)
    err_b = check_render_bwd(tag, bwd_args)
    log(f"check render kernels vs plain: {tag}: values max abs err {err_f:.3g} (max value "
        f"{top:.3g}; three launch orders bit-equal), gradients max abs err {err_b:.3g} OK")
    return err_f, err_b


def directional_fd(name, loss, x0, grad, eps, floor, seed=7, n_dirs=4):
    """Central differences of ``loss`` along random unit directions against
    the autograd gradient, rtol 2e-2; directions whose derivative is below
    ``floor`` (the f32 noise of the difference) are skipped. Raises unless
    at least two are checked."""
    rng = np.random.default_rng(seed)
    checked = []
    for _ in range(n_dirs):
        d = torch.from_numpy(rng.standard_normal(tuple(x0.shape))).to(x0.device)
        d /= d.norm()
        with torch.no_grad():
            fd = (float(loss((x0.double() + eps * d).float()))
                  - float(loss((x0.double() - eps * d).float()))) / (2 * eps)
        gd = float((grad.double() * d).sum())
        if abs(gd) < floor:
            continue
        if abs(gd - fd) > 2e-2 * abs(fd):
            raise AssertionError(f"finite differences {name}: autograd {gd:.6g} vs {fd:.6g}")
        checked.append(f"{gd:.4g}/{fd:.4g}")
    if len(checked) < 2:
        raise AssertionError(f"finite differences {name}: {len(checked)} directions checked")
    log(f"check finite differences {name}: autograd/central {', '.join(checked)} OK")


def fd_checks(dev):
    """Both trainers against directional finite differences on the card,
    on grace_tpu's test scenes: 64 particles in a 128x64 image (weights
    1e-3, mean-square loss), and 800 particles with 32x32 rays (a mean
    square against a random target, summed in f64)."""
    from grace_tpu_torch.build.sph import build_sph_tree
    from grace_tpu_torch.rays.gen import orthographic_projection_rays, spatial_sort_rays
    from grace_tpu_torch.trace import pallas_render as pr
    from grace_tpu_torch.trace import splat_grad as sg

    rng = np.random.default_rng(1234)
    pos = (0.15 + 0.7 * rng.random((64, 3))).astype(np.float32)
    h = (0.03 + 0.08 * rng.random(64)).astype(np.float32)
    h[:5] = 0.0
    pos[5:8, 2] = 50.0
    s0 = torch.from_numpy(np.concatenate([pos, h[:, None]], axis=1)).to(dev)
    w0 = torch.from_numpy((0.5 + rng.random(64)).astype(np.float32) * 1e-3).to(dev)
    cam = sg.OrthoCamera(CAM, LOOK, UP, 1.4, LENGTH, 128, 64)
    render = sg.make_splat_trainer(cam, tile_w=16, tile_h=128)
    loss = lambda s: (render(s, w0).double() ** 2).mean()
    s = s0.clone().requires_grad_(True)
    loss(s).backward()
    directional_fd("splat trainer (spheres)", loss, s0, s.grad, 2e-4, 1e-4)

    sp = np.concatenate([0.2 + 0.6 * rng.random((800, 3)), 0.04 + 0.05 * rng.random((800, 1))],
                        axis=1).astype(np.float32)
    ss, _, _ = build_sph_tree(torch.from_numpy(sp).to(dev), 16)
    w = torch.from_numpy((0.5 + rng.random(800)).astype(np.float32)).to(dev)
    rays, _, _ = spatial_sort_rays(orthographic_projection_rays(32, 32, CAM, LOOK, UP, 1.2,
                                                                LENGTH, device=dev))
    tgt = torch.from_numpy(rng.standard_normal(1024)).to(dev)
    fused = pr.make_fused_renderer(tile=64, max_chunks=64)
    loss2 = lambda s, ww: ((fused(rays, s, ww).double() * 1e-3 - tgt) ** 2).mean()
    s = ss.clone().requires_grad_(True)
    ww = w.clone().requires_grad_(True)
    loss2(s, ww).backward()
    directional_fd("fused renderer (spheres)", lambda x: loss2(x, w), ss, s.grad, 1e-3, 1e-2)
    directional_fd("fused renderer (weights)", lambda x: loss2(ss, x), w, ww.grad, 1e-2, 1e-3)


def training_small_checks(dev):
    """The four training kernels against their plain versions at edge
    shapes, the fused renderer's overflow contracts, and both trainers
    against finite differences."""
    from grace_tpu_torch.rays.gen import orthographic_projection_rays, spatial_sort_rays
    from grace_tpu_torch.trace import pallas_render as pr
    from grace_tpu_torch.trace import splat_grad as sg

    gen = torch.Generator().manual_seed(5)
    # A wide view (extent 4 around the unit box) leaves tiles with no segment.
    cam = sg.OrthoCamera(CAM, LOOK, UP, 4.0, LENGTH, 256, 128)
    g_image = torch.randn(128, 256, generator=gen).to(dev)
    rays, _, _ = spatial_sort_rays(orthographic_projection_rays(64, 64, CAM, LOOK, UP, 4.0,
                                                                LENGTH, device=dev))
    g_rays = torch.randn(rays.n_rays, generator=gen).to(dev)
    for whole in (False, True):
        ss, w = training_scene(dev, whole)
        tag = "whole-image particle" if whole else "dead particles, empty tiles"
        for tile_w in (8, 16, 32):
            inputs = sortfree_inputs(ss, w, cam, tile_w)
            masks, masks_t, _, slabs = inputs
            seg_tiles = _popcount_rows(masks_t)
            if ss.shape[0] % 128 == 0 or not bool((slabs[:, 3] == 0).any()):
                raise AssertionError("edge case lost: whole segments or no dead particle")
            if whole != bool((seg_tiles == masks.shape[0]).any()):
                raise AssertionError("edge case lost: whole-image segment")
            if not whole and not bool((masks == 0).all(dim=1).any()):
                raise AssertionError("edge case lost: no tile without a segment")
            for basis in ("deg8", "deg10"):
                check_sortfree(f"small {tag}", inputs, g_image, basis, tile_w,
                               5e-4 if whole else 3e-5)
        # roomy lists, then lists that overflow (max_chunks 3, max_tiles 1)
        for tile, max_chunks, max_tiles in ((128, 2048, 64), (64, 3, 1)):
            fwd_args, ovf, bwd_args, ovf_t = render_inputs(rays, ss, w, g_rays, tile,
                                                           max_chunks, max_tiles)
            tight = max_tiles == 1
            if tight != bool(ovf.any()) or tight != bool(ovf_t.any()):
                raise AssertionError(f"edge case lost: list overflow {tight} expected")
            if not whole and not bool((fwd_args[0] == 0).any()):
                raise AssertionError("edge case lost: no ray tile without a segment")
            check_render(f"small {tag} tile {tile} max_chunks {max_chunks} max_tiles "
                         f"{max_tiles}", fwd_args, bwd_args)
    # The renderer's overflow contracts: the forward flag, the NaN poison.
    ss, w = training_scene(dev, False)
    _, flag = pr.make_fused_renderer(tile=64, max_chunks=1, return_overflow=True)(rays, ss, w)
    roomy = pr.make_fused_renderer(tile=64, max_chunks=64, max_tiles_per_seg=64,
                                   return_overflow=True)
    _, flag_ok = roomy(rays, ss, w)
    grads = []
    for render in (pr.make_fused_renderer(tile=64, max_chunks=64, max_tiles_per_seg=1,
                                          return_overflow=True), roomy):
        s = ss.clone().requires_grad_(True)
        ww = w.clone().requires_grad_(True)
        render(rays, s, ww)[0].sum().backward()
        grads.append(bool(torch.isfinite(s.grad).all()) and bool(torch.isfinite(ww.grad).all()))
    if not bool(flag) or bool(flag_ok) or grads != [False, True]:
        raise AssertionError(f"fused renderer overflow contracts: flags {bool(flag)} "
                             f"{bool(flag_ok)}, finite gradients {grads}")
    log("check fused renderer overflow: max_chunks=1 flags, max_tiles_per_seg=1 poisons "
        "with NaN, roomy lists neither OK")
    fd_checks(dev)


def records_inputs(route, rays, spheres, tile):
    """(kernel, plain version, arguments) of a record route, its inputs
    prepared as pallas_trace_sph_records prepares them (capacity last)."""
    from grace_tpu_torch.trace import pallas_broadphase as pb
    from grace_tpu_torch.trace import pallas_kernel as pk
    from grace_tpu_torch.trace import pallas_records as prc

    rays = pk._pad_rays(rays, tile)
    packed, _ = pk._pack_rays(rays, tile)
    prims, _ = pk._pack_prims(spheres)
    if route == "quarter":
        words, summary = pb.dense_tile_masks_quarter(rays, spheres, tile)
        return prc.records_quarter, prc._records_quarter_plain, (summary, words, packed, prims)
    return (prc.records_bitmask, prc._records_bitmask_plain,
            (pb.dense_tile_masks(rays, spheres, tile), packed, prims))


def check_records(tag, kernel, plain, args, cap):
    """A record kernel against its plain version on the same card tensors:
    counts and indices exact (sentinels included), integrals and distances
    within rtol 1e-6 (the same f32 operations; the plain version's fused
    multiply-adds round through f64, one in ~2^28 of them a second time).
    Returns (max abs err of integrals, of distances, the kernel's result,
    the plain version's ms)."""
    got = kernel(*args, cap)
    want, plain_ms = timed(lambda: plain(*args, cap), args[0].device)
    check_equal(f"{tag} counts", got[0], want[0])
    check_equal(f"{tag} indices", got[1], want[1])
    err_i = check_close(f"{tag} integrals", got[2], want[2], 1e-6, 0.0)[0]
    err_d = check_close(f"{tag} distances", got[3], want[3], 1e-6, 0.0)[0]
    return err_i, err_d, got, plain_ms


def check_record_orders(tag, route, args, cap):
    """The record kernel of ``route`` with its tiles launched as listed,
    longest mask row first and shortest first (each tile's rows written in
    place), each into its own outputs filled with -7 first (a NaN as f32),
    so that an entry no launch wrote shows: counts and indices equal to
    the plain version's, integrals and distances within rtol 1e-6 of it,
    and all four outputs equal, bit for bit, to the wrapper's launch."""
    from grace_tpu_torch.trace import pallas_kernel as pk
    from grace_tpu_torch.trace import pallas_records as prc

    kernel, plain = {"quarter": (prc.records_quarter, prc._records_quarter_plain),
                     "bitmask": (prc.records_bitmask, prc._records_bitmask_plain)}[route]
    words = args[-3]
    longest = pk.quarter_tile_order(words) if route == "quarter" else pk.bitmask_tile_order(words)
    want = plain(*args, cap)
    wrapper = kernel(*args, cap)
    kept = []   # every launch's outputs stay allocated, so none reuses another's memory
    for name, order in (
            ("as listed", torch.arange(words.shape[0], dtype=torch.int32, device=words.device)),
            ("longest first", longest), ("shortest first", longest.flip(0).contiguous())):
        outs = prc._outputs(args[-2], cap)
        for o in outs:
            o.view(torch.int32).fill_(-7)
        got = prc._records_launch(route, args, order, outs)
        kept.append(got)
        check_equal(f"{tag} launched {name}: counts", got[0], want[0])
        check_equal(f"{tag} launched {name}: indices", got[1], want[1])
        check_close(f"{tag} launched {name}: integrals", got[2], want[2], 1e-6, 0.0)
        check_close(f"{tag} launched {name}: distances", got[3], want[3], 1e-6, 0.0)
        for field, a, b in zip(("counts", "indices", "integrals", "distances"), got, wrapper):
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                raise AssertionError(f"{tag} launched {name}: {field} differ from the "
                                     "wrapper's launch")


def timed(fn, device):
    """(fn(), its device time in ms from CUDA events), or (fn(), None)
    off the card."""
    if torch.device(device).type != "cuda":
        return fn(), None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def colocated_scene(dev):
    """grace_tpu's overflow scene: 512 spheres of radius 0.4 at (0.5, 0.5,
    0.5) and 64 rays through their center; every ray hits all 512."""
    from grace_tpu_torch.core.types import Rays, make_spheres

    spheres = make_spheres(np.full((512, 3), 0.5, np.float32),
                           np.full((512,), 0.4, np.float32), device=dev)
    rays = Rays.from_arrays(np.tile([[0.5, 0.5, -2.0]], (64, 1)).astype(np.float32),
                            np.tile([[0.0, 0.0, 1.0]], (64, 1)).astype(np.float32),
                            np.full((64,), 6.0, np.float32), device=dev)
    return spheres, rays


def records_scene(dev):
    """3000 clustered particles with 4x the bench scene's smoothing lengths
    (about ten hits a ray), Morton-sorted, and 50x39 sorted ortho rays over
    a wide view (1950 rays; some tiles see no particle)."""
    from grace_tpu_torch.build.sph import build_sph_tree
    from grace_tpu_torch.rays.gen import orthographic_projection_rays, spatial_sort_rays

    sp = make_clustered_particles(np.random.default_rng(7), 3000)
    sp[:, 3] *= 4.0
    ss, _, _ = build_sph_tree(torch.from_numpy(sp).to(dev), 16)
    rays_s, _, _ = spatial_sort_rays(orthographic_projection_rays(50, 39, CAM, LOOK, UP, 4.0,
                                                                  LENGTH, device=dev))
    return ss, rays_s


def records_small_checks(dev):
    """The record kernels against their plain versions at edge shapes: 3000
    particles (not a multiple of 128), 1950 rays (no tile multiple), tiles
    that list nothing, rows that overflow (capacity 128 on the co-located
    scene: counts exactly 512), three launch orders bit-equal; and the
    quarter, bitmask and streaming (vmem_resident_limit=0) routes of
    pallas_trace_sph_records bit-equal."""
    from grace_tpu_torch.trace import pallas_records as prc

    ss, rays_s = records_scene(dev)
    for route in ("quarter", "bitmask"):
        for tile in (64, 96):
            kernel, plain, args = records_inputs(route, rays_s, ss, tile)
            if not bool((args[-3] == 0).all(dim=1).any()):
                raise AssertionError("edge case lost: no tile without a listed primitive")
            err_i, err_d, got, _ = check_records(f"small records {route} t{tile}", kernel,
                                                 plain, args, 128)
            check_record_orders(f"small records {route} t{tile}", route, args, 128)
            log(f"check {kernel.__name__} kernel vs plain: tile {tile}, {int(got[0].sum())} "
                f"hits, integrals max abs err {err_i:.3g}, distances {err_d:.3g}; launched "
                "as listed, longest first and shortest first into outputs filled with -7: "
                "equal to plain and bit-equal OK")
    sp_o, rays_o = colocated_scene(dev)
    for route in ("quarter", "bitmask"):
        kernel, plain, args = records_inputs(route, rays_o, sp_o, 64)
        got = check_records(f"overflow records {route}", kernel, plain, args, 128)[2]
        if not bool((got[0] == 512).all()) or not bool((got[1] >= 0).all()):
            raise AssertionError(f"overflow records {route}: counts not 512 or rows not full")
        check_record_orders(f"overflow records {route}", route, args, 128)
    log("check record kernels vs plain on the co-located scene: counts 512, rows of 128 "
        "full, in three launch orders, OK")
    for r, s in ((rays_s, ss), (rays_o, sp_o)):
        base = prc.pallas_trace_sph_records(r, s, 128)
        for kw in (dict(broadphase="bitmask"), dict(vmem_resident_limit=0),
                   dict(broadphase="quarter", rank_method="prefix", group=1, drain="network")):
            for a, b in zip(prc.pallas_trace_sph_records(r, s, 128, **kw), base):
                check_equal(f"records route {kw} vs default", a, b)
    log("check pallas_trace_sph_records: quarter, bitmask, streaming and every drain "
        "option bit-equal OK")


def random_mesh(rng, n):
    """grace_tpu's test meshes: n triangles of random winding (about half
    face away from any ray) around random points of the unit box."""
    c = rng.random((n, 1, 3)).astype(np.float32)
    return c + 0.08 * rng.standard_normal((n, 3, 3)).astype(np.float32)


def torus_mesh(n_u=64, n_v=32, R=1.0, r=0.4):
    """A procedural torus, 2 n_u n_v triangles (the same vertices and
    winding as ``examples/render_triangle.py``'s)."""
    u = np.linspace(0, 2 * np.pi, n_u, endpoint=False)
    v = np.linspace(0, 2 * np.pi, n_v, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    x = (R + r * np.cos(vv)) * np.cos(uu)
    y = (R + r * np.cos(vv)) * np.sin(uu)
    z = r * np.sin(vv)
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)

    def vid(i, j):
        return (i % n_u) * n_v + (j % n_v)

    tris = []
    for i in range(n_u):
        for j in range(n_v):
            a, b, c, d = vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)
            tris.append((a, b, c))
            tris.append((a, c, d))
    return verts[np.asarray(tris, np.int32)]


def tri_inputs(rays, tris, tile, max_chunks):
    """(trace_tri arguments, overflow) as pallas_trace_tri prepares them."""
    from grace_tpu_torch.trace import pallas_kernel as pk
    from grace_tpu_torch.trace import pallas_tri as pt

    rays = pk._pad_rays(rays, tile)
    flat = tris.reshape(-1, 3)
    rays = pt.clip_rays_to_aabb(rays, flat.amin(dim=0), flat.amax(dim=0))
    seg_ids, seg_dist, n_segs, ovf = pt._dense_tile_segments_tri(rays, tris, tile, max_chunks)
    return (n_segs, seg_ids, seg_dist, pk._pack_rays(rays, tile)[0], pt._pack_tris(tris)[0]), ovf


def check_tri(tag, args, mode):
    """The triangle kernel against its plain version: ids, misses and t
    where both hit equal bit for bit (the same f32 operations in the same
    order). Returns (max abs err of t over the hits, so 0, hits, chunks
    visited per tile by the plain version, the plain version's ms)."""
    from grace_tpu_torch.trace import pallas_tri as pt

    t, ids = pt.trace_tri(*args, mode)
    (t_p, ids_p, visited), plain_ms = timed(lambda: pt._tri_plain(*args, mode), args[0].device)
    check_equal(f"{tag} ids", ids, ids_p)
    check_equal(f"{tag} misses", t >= pt.BIG, t_p >= pt.BIG)
    hit = t_p < pt.BIG
    check_equal(f"{tag} t", t[hit], t_p[hit])
    return 0.0, int(hit.sum()), visited, plain_ms


def tri_small_checks(dev):
    """The triangle kernel against its plain version: random meshes (about
    half the faces culled), rays that miss the mesh box, tiles 8 (spare
    lanes), 32, 64 and 96 (warp groups), both modes, and lists truncated by
    max_chunks."""
    from grace_tpu_torch.core.types import Rays

    rng = np.random.default_rng(3)
    tris = torch.from_numpy(random_mesh(rng, 3000)).to(dev)
    r = 2000
    d = rng.standard_normal((r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = (rng.random((r, 3)) * 0.4 + 0.3).astype(np.float32)
    o[:100] = [3.0, 3.0, 3.0]   # outside the box, pointing anywhere: most miss it
    rays = Rays.from_arrays(o, d, np.full(r, 5.0, np.float32), device=dev)
    for tile in (8, 32, 64, 96):
        for max_chunks in (2048, 4):
            args, ovf = tri_inputs(rays, tris, tile, max_chunks)
            if (max_chunks == 4) != bool(ovf.any()) or not bool((args[3][:, 9] == 0).any()):
                raise AssertionError("edge case lost: overflow or a ray clipped to nothing")
            for mode in ("closest", "any"):
                err, hits, visited, _ = check_tri(f"small tri t{tile} c{max_chunks} {mode}",
                                                  args, mode)
                log(f"check trace_tri kernel vs plain: tile {tile} max_chunks {max_chunks} "
                    f"{mode}: {hits} hits, {int(visited.sum())} chunks visited, t max abs err "
                    f"{err:.3g} OK")


def records_gates(rec, rec_b, rec_sorted, flat, counts_want, column_density):
    """Main path 4's gates: counts equal the quarter trace's hit counts on
    every ray; the bitmask route's records equal the quarter route's bit
    for bit; each row that did not overflow sums to the quarter trace's
    column density within rtol 1e-5, atol 1e-6 x max (both the horner1
    deg-14 integral); sorted rows are non-decreasing; the flat layout's
    offsets are the exclusive cumsum of the kept counts. Returns a summary."""
    check_equal("record counts vs quarter trace hit counts", rec.counts, counts_want)
    for name, a, b in zip(rec._fields, rec_b, rec):
        check_equal(f"records bitmask route vs quarter route ({name})", a, b)
    cap = rec.capacity
    kept = torch.clamp(rec.counts, max=cap)
    full = rec.counts <= cap
    scale = float(column_density.abs().max())
    err, _ = check_close("record row sums vs quarter trace column density",
                         rec.integrals.double().sum(dim=1)[full],
                         column_density[full].double(), 1e-5, 1e-6 * scale)
    col = torch.arange(1, cap, device=kept.device)
    d = rec_sorted.distances
    if bool(((d[:, 1:] < d[:, :-1]) & (col < kept[:, None])).any()):
        raise AssertionError("sorted records: a row's distances decrease")
    check_equal("sorted record counts", rec_sorted.counts, rec.counts)
    check_equal("flat offsets vs exclusive cumsum", flat.offsets,
                (torch.cumsum(kept, dim=0) - kept).to(torch.int32))
    check_equal("flat counts", flat.counts, rec.counts)
    if int(flat.total_hits) != int(rec.counts.sum()):
        raise AssertionError("flat total_hits != sum of counts")
    return (f"{int(rec.overflowed.sum())} rays overflowed (largest count "
            f"{int(rec.counts.max())}); row sums of {int(full.sum())} rays vs quarter trace "
            f"max abs err {err:.3g} (max value {scale:.3g}); sorted rows non-decreasing; "
            "flat offsets the exclusive cumsum; bitmask route bit-equal")


def engine_subset_gate(rays, sorted_tris, tree, t, ids):
    """The kernel's closest hits (t, ids) on ``rays`` against the generic
    engine's. grace_tpu's engine and its Pallas kernel round the triangle
    test differently (the determinant's fused multiply-add falls on another
    product), and the port keeps each path's rounding, so a ray through a
    shared edge may hit a neighbour, or neither, in one path and not the
    other (grace_tpu itself: 6 of the 4096 torus rays). Ids must be equal
    on every ray except such edge rays, at most 1 in 100, each one where
    the two roundings of the test disagree on one of the two triangles; t
    within rtol 1e-6 wherever both hit. Returns
    (edge rays, max abs err of t)."""
    from grace_tpu_torch.models import triangle as mt
    from grace_tpu_torch.trace import pallas_tri as pt

    ref = mt.trace_closest_hit(rays, sorted_tris, tree)
    both = torch.isfinite(ref.t) & torch.isfinite(t)
    err, _ = check_close("subset t vs engine", t[both], ref.t[both], 1e-6, 0.0)
    return explain_edge_rays("subset ids vs engine", rays, sorted_tris, ids, ref.tri), err


def explain_edge_rays(tag, rays, sorted_tris, ids, ref_ids):
    """Rays whose closest triangle differs between the triangle kernel
    (``ids``, pallas_tri's test) and the engine (``ref_ids``): at most 1 in
    100, each where the two roundings of the test disagree on one of the
    two triangles, or where both hit both at one t (a tie on the shared
    edge). Returns their number."""
    from grace_tpu_torch.models import triangle as mt
    from grace_tpu_torch.trace import pallas_tri as pt

    edge = torch.nonzero(ids != ref_ids).flatten().tolist()
    if len(edge) > rays.n_rays // 100:
        raise AssertionError(f"{tag}: {len(edge)} rays differ")
    for b in edge:
        r = rays[b:b + 1]
        cols = [r.origins[:, 0], r.origins[:, 1], r.origins[:, 2], r.directions[:, 0],
                r.directions[:, 1], r.directions[:, 2], r.lengths]
        explained, ts = False, []
        for i in {int(ids[b]), int(ref_ids[b])} - {-1}:
            hit_e, t_e = mt.intersect_triangle(r.origins, r.directions, r.lengths,
                                               sorted_tris[i:i + 1])
            t_k = pt._mt_candidates(pt._pack_tris(sorted_tris[i:i + 1])[0][0],
                                    *[c[:, None] for c in cols])
            explained |= bool(hit_e[0]) != bool(t_k[0, 0] < pt.BIG)
            ts.append(float(t_k[0, 0]) if bool(hit_e[0]) else float("inf"))
        # or both hit both triangles at one t (a tie on the shared edge)
        explained |= len(ts) == 2 and abs(ts[0] - ts[1]) <= 1e-6 * min(ts)
        if not explained:
            raise AssertionError(f"{tag}: ray {b} differs off an edge")
    return len(edge)


def triangle_gates(tris, img, side):
    """Main path 5's gates, on render_triangles' steps run again one by one:
    every phase finite, the image in [0, 1] and lit exactly where the
    closest-hit pass hits, no list overflow, any hit equal to a finite
    closest t, and on a subset of ENGINE_SUBSET rays the kernel's ids equal
    the generic engine's and t within rtol 1e-6. Returns the summary, the
    primary pass's trace_tri arguments and its padded and clipped rays."""
    import math

    from grace_tpu_torch.models import triangle as mt
    from grace_tpu_torch.rays.gen import pinhole_camera_rays
    from grace_tpu_torch.trace import pallas_kernel as pk
    from grace_tpu_torch.trace import pallas_tri as pt

    if img.shape != (side, side) or not bool(torch.isfinite(img).all()):
        raise AssertionError("triangle image: bad shape or non-finite values")
    if float(img.min()) < 0.0 or float(img.max()) > 1.0:
        raise AssertionError("triangle image outside [0, 1]")
    sorted_tris, tree, _ = mt.build_triangle_tree(tris)
    cam, look, length = mt.auto_camera(sorted_tris, side)
    rays = pinhole_camera_rays(side, side, cam.tolist(), look.tolist(), (0.0, 1.0, 0.0),
                               math.pi / 3, float(length), device=tris.device)
    t, ids, ovf = pt.pallas_trace_tri(rays, sorted_tris)
    occ, _, ovf_any = pt.pallas_trace_tri(rays, sorted_tris, mode="any")
    for name, x in (("sorted triangles", sorted_tris), ("camera", cam),
                    ("ray origins", rays.origins),
                    ("ray directions", rays.directions)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"triangle path: non-finite {name}")
    hit = torch.isfinite(t)
    if bool(torch.isnan(t).any()) or not bool(((ids >= 0) == hit).all()):
        raise AssertionError("closest hits: NaN t, or ids and t disagree")
    if bool(ovf.any()) or bool(ovf_any.any()):
        raise AssertionError("triangle lists overflow")
    check_equal("any hit vs finite closest t on the primary rays", occ, hit)
    check_equal("image lit vs closest hits", img.flatten() > 0, hit)
    sub = torch.arange(0, rays.n_rays, rays.n_rays // ENGINE_SUBSET, device=t.device)
    n_edge, err = engine_subset_gate(rays[sub], sorted_tris, tree, t[sub], ids[sub])
    args, _ = tri_inputs(rays, sorted_tris, 32, 2048)
    rays_p = pk._pad_rays(rays, 32)
    summary = (f"{int(hit.sum())} of {rays.n_rays} rays hit, {int(occ.sum())} any-hits equal "
               f"them; image in [{float(img.min()):.4g}, {float(img.max()):.4g}]; no overflow; "
               f"{ENGINE_SUBSET} rays vs engine: ids equal but on {n_edge} edge rays, t max "
               f"abs err {err:.3g}")
    return {"summary": summary, "args": args, "sorted_tris": sorted_tris, "rays_padded": rays_p,
            **torus_list_rays(rays, sorted_tris, t, ids, length)}


def torus_list_rays(rays, sorted_tris, t, ids, length):
    """render_triangles' two ray sets as pallas_trace_tri lists them, padded
    to tiles of 32 and clipped to the mesh box: {"rays_clipped": the
    primary rays, "shadow_clipped": the shadow rays from its hits (t, ids:
    the closest-hit pass) toward the light}."""
    from grace_tpu_torch.models import triangle as mt
    from grace_tpu_torch.trace import pallas_kernel as pk
    from grace_tpu_torch.trace import pallas_tri as pt

    flat = sorted_tris.reshape(-1, 3)
    clip = lambda r: pt.clip_rays_to_aabb(pk._pad_rays(r, 32), flat.amin(dim=0),
                                          flat.amax(dim=0))
    _, _, shadow = mt.shadow_inputs(rays, sorted_tris, mt.ClosestHit(t=t, tri=ids),
                                    (0.3, 1.0, 0.6), length)
    return {"rays_clipped": clip(rays), "shadow_clipped": clip(shadow)}


def footprint_counts(spheres, weights, cam):
    """(rows, columns) f64[n] of the pixel centers inside each particle's
    footprint |d| < h (0 for a dead particle)."""
    from grace_tpu_torch.trace import splat_grad as sg

    pu, pv, invh, scale = sg.project_ortho(spheres, weights, cam)
    *_, x0, dx, y0, dy = sg._camera_numerics(cam, spheres.device)
    live = scale != 0
    h = torch.where(live, 1.0 / invh.clamp(min=1e-30), 0.0).double()

    def count(lo_edge, hi_edge, size):  # integers i in (lo_edge, hi_edge), 0 <= i < size
        lo = torch.clamp(torch.floor(lo_edge) + 1, min=0)
        hi = torch.clamp(torch.ceil(hi_edge) - 1, max=size - 1)
        return torch.where(live, torch.clamp(hi - lo + 1, min=0), 0.0)

    cols = count((pu.double() - h - float(x0)) / dx, (pu.double() + h - float(x0)) / dx,
                 cam.resolution_x)
    rows = count((float(y0) - pv.double() - h) / -dy, (float(y0) - pv.double() + h) / -dy,
                 cam.resolution_y)
    return rows, cols


def footprint_work(spheres, weights, cam):
    """(sum over live particles of rows x columns, and of rows + columns)
    of the pixel centers inside each particle's footprint |d| < h: the
    products and factor entries the separable image needs."""
    rows, cols = footprint_counts(spheres, weights, cam)
    return float((rows * cols).sum()), float((rows + cols).sum())




def check_tensor_bits(name, got, want):
    """Two tensors of one dtype equal bit for bit (floats by their bits)."""
    if got.dtype != want.dtype or got.device != want.device:
        raise AssertionError(f"{name}: dtype or device differ")
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    check_equal(name, bits(got), bits(want))


BUILD_FIELDS = ("children", "child_aabbs", "leaves", "root", "n_nodes", "n_leaves")


def build_stages(prims, kind, max_per_leaf, delta_kind, bits, plain):
    """Every stage of the build, through the public functions (the kernels
    of csrc/build.cu, or with ``plain`` every step's plain version): keys
    (their box the centroids' own: folded in the keys' launch, or
    torch.amin / amax),
    the stable sort, the sorted primitives, the deltas, phase A's split
    ranges (``lbvh_ranges``, or ``cartesian_tree_ranges``) and the tree."""
    from grace_tpu_torch.build import deltas as bd
    from grace_tpu_torch.build import lbvh
    from grace_tpu_torch.build.sph import xor_deltas_sph
    from grace_tpu_torch.ops import morton

    keys = morton.morton_keys_from_centroids(kind.centroid(prims), bits=bits, plain=plain)
    keys_sorted, perm = torch.sort(keys, stable=True)
    sp = prims[perm]
    if delta_kind == "xor":
        d = xor_deltas_sph(keys_sorted, bits, plain)
    elif delta_kind == "euclidean":
        d = bd.euclidean_deltas(sp, kind.centroid, plain=plain)
    else:
        d = bd.surface_area_deltas(sp, kind.aabb, plain=plain)
    mins, maxs = kind.aabb(sp)
    l, r = (lbvh.cartesian_tree_ranges(d) if plain else lbvh.lbvh_ranges(d, max_per_leaf)[:2])
    tree = lbvh.build_lbvh(mins, maxs, d, max_per_leaf, plain=plain)
    out = {"keys": keys, "permutation": perm.to(torch.int32), "sorted primitives": sp,
           "deltas": d, "split ranges l": l.to(torch.int32), "split ranges r": r.to(torch.int32)}
    out.update({f: getattr(tree, f) for f in BUILD_FIELDS})
    return out


def entry_build(prims, kind, max_per_leaf, delta_kind, bits):
    """The user's entry: build_sph_tree for spheres, build_primitive_tree
    for another kind. Returns (sorted primitives, tree, permutation)."""
    from grace_tpu_torch.build.sph import build_primitive_tree, build_sph_tree
    from grace_tpu_torch.ops.primitives import SPHERE

    if kind is SPHERE:
        return build_sph_tree(prims, max_per_leaf, delta_kind, bits)
    return build_primitive_tree(prims, kind, max_per_leaf, delta_kind, bits)


def check_build_case(tag, prims, kind, max_per_leaf, delta_kind="euclidean", bits=30):
    """The CUDA build against the plain build on the same card tensors, bit
    for bit: keys, permutation, sorted primitives, deltas, phase A's ranges
    and every Tree field; then the entry point twice under
    torch.cuda.set_sync_debug_mode("error") (a host sync raises), each run
    bit-equal to the staged one. Returns (n_leaves, root, {stage: max abs
    err}), the errors of the keys, deltas, ranges and boxes (0: bit-equal)."""
    want = build_stages(prims, kind, max_per_leaf, delta_kind, bits, plain=True)
    got = build_stages(prims, kind, max_per_leaf, delta_kind, bits, plain=False)
    torch.cuda.synchronize()
    errs = {}
    for name, w in want.items():
        check_tensor_bits(f"{tag} {name}", got[name], w)
        if w.numel():
            g, w64 = got[name].double(), w.double()
            errs[name] = float(torch.where(g == w64, 0.0, (g - w64).abs()).max())
    errs["gather"] = check_gather(tag, prims, kind, delta_kind, bits, want)
    for block in CLIMB_BLOCKS:
        check_climbs(f"{tag} block {block}", want, kind, max_per_leaf, block)
    torch.cuda.set_sync_debug_mode("error")
    try:
        runs = [entry_build(prims, kind, max_per_leaf, delta_kind, bits) for _ in range(2)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for i, (sp, tree, perm) in enumerate(runs):
        check_tensor_bits(f"{tag} entry run {i} sorted primitives", sp, got["sorted primitives"])
        check_tensor_bits(f"{tag} entry run {i} permutation", perm, got["permutation"])
        for f in BUILD_FIELDS:
            check_tensor_bits(f"{tag} entry run {i} {f}", getattr(tree, f), got[f])
    return int(got["n_leaves"]), int(got["root"]), errs


# the climbs' blocks check_build also runs (the kernel's default is 1024, less
# for small N):
# small blocks send most splits to the device-scope stage, 100 divides no size
CLIMB_BLOCKS = (32, 100)


def check_gather(tag, prims, kind, delta_kind, bits, want):
    """grace_gather_deltas (E2 in one launch) against the torch steps it
    replaces on the same card tensors, bit for bit: prims[perm],
    perm.to(int32), kind.aabb of the sorted rows and the plain deltas
    (``want``: the plain stages). Returns its max abs err (0: bit-equal)."""
    from grace_tpu_torch.build import deltas as bd

    gather, kernel_kind = bd.gather_for(kind, delta_kind, bits)
    keys_sorted, perm = torch.sort(want["keys"], stable=True)
    sp, perm32, mins, maxs, d = bd.gather_deltas_cuda(prims, gather, perm, keys_sorted,
                                                      kernel_kind)
    sp2, perm2, none_min, none_max, none_d = bd.gather_deltas_cuda(prims, gather, perm,
                                                                   boxes=False)
    if none_min is not None or none_d is not None:
        raise AssertionError(f"{tag} gather: boxes or deltas where none were asked for")
    want_min, want_max = kind.aabb(want["sorted primitives"])
    for name, g, w in (("sorted rows", sp, want["sorted primitives"]),
                       ("permutation", perm32, want["permutation"]),
                       ("rows without boxes", sp2, sp), ("permutation without boxes", perm2,
                                                         perm32),
                       ("box minima", mins, want_min), ("box maxima", maxs, want_max),
                       ("deltas", d, want["deltas"])):
        check_tensor_bits(f"{tag} gather {name}", g, w)
    return 0.0


def check_climbs(tag, want, kind, max_per_leaf, block):
    """Both climbs at ``block`` items a block against the plain stages
    ``want``, bit for bit: phase A's split ranges and every Tree field."""
    from grace_tpu_torch.build import lbvh

    d = want["deltas"]
    mins, maxs = kind.aabb(want["sorted primitives"])
    l, r, first, count, mark = lbvh.lbvh_ranges(d, max_per_leaf, _block=block)
    check_tensor_bits(f"{tag} split ranges l", l, want["split ranges l"])
    check_tensor_bits(f"{tag} split ranges r", r, want["split ranges r"])
    scan = torch.cumsum(mark, dim=0, dtype=torch.int32)
    tree = lbvh.lbvh_nodes(d, first, count, mark, scan, mins, maxs, max_per_leaf, _block=block)
    for f in BUILD_FIELDS:
        check_tensor_bits(f"{tag} {f}", getattr(tree, f), want[f])


def signed_zero_spheres(rng, n):
    """Spheres of radius +0 or -0 whose x is +0 or -0 (their boxes' x ends
    are +-0, at the scene box's edge), the rest random."""
    s = np.concatenate([rng.random((n, 3)), np.zeros((n, 1))], axis=1).astype(np.float32)
    s[:, 0] = np.where(rng.random(n) < 0.5, -0.0, 0.0)
    s[:, 3] = np.where(rng.random(n) < 0.5, -0.0, 0.0)
    return s


# check_build's cases: tag -> (scene, primitives, max_per_leaf, delta kind,
# key bits): the full-size scenes (the bench's 2^20 clustered particles, the
# driver entry's 2,048 spheres, the torus) and the edge cases.
BUILD_CASES = {
    "bench scene (2^20 clustered particles, mpl 16, euclidean)":
        ("bench", N_PARTICLES, 16, "euclidean", 30),
    "entry (2048 spheres, mpl 16)": ("entry", 2048, 16, "euclidean", 30),
    "torus (262,144 triangles, mpl 8, xor)": ("torus", 262_144, 8, "xor", 30),
    "63-bit keys, xor (3000 spheres)": ("random", 3000, 16, "xor", 63),
    "63-bit keys, surface area (3000 spheres)": ("random", 3000, 16, "surface_area", 63),
    "all points identical (3000)": ("identical", 3000, 16, "euclidean", 30),
    "runs of equal keys, xor (3000)": ("equal_keys", 3000, 16, "xor", 30),
    "mpl 1 (3000 spheres)": ("random", 3000, 1, "euclidean", 30),
    "mpl 32 (3000 spheres)": ("random", 3000, 32, "euclidean", 30),
    "N = 2, mpl 1": ("random", 2, 1, "euclidean", 30),
    "N = 3, mpl 1": ("random", 3, 1, "euclidean", 30),
    "signed zeros at the box edge (1000 spheres)": ("signed_zeros", 1000, 4, "euclidean", 30),
    "triangles with signed zeros and tied vertices (3000, mpl 4, euclidean)":
        ("tri_zeros", 3000, 4, "euclidean", 30),
    "triangles, surface area (3000, mpl 8)": ("triangles", 3000, 8, "surface_area", 30),
}


def build_case(tag, dev):
    """The inputs of check_build's case ``tag`` on ``dev``: (primitives,
    kind, max_per_leaf, delta kind, bits)."""
    from grace_tpu_torch.ops.primitives import SPHERE, TRIANGLE

    scene, n, mpl, delta_kind, bits = BUILD_CASES[tag]
    rng = np.random.default_rng(BUILD_SEED + list(BUILD_CASES).index(tag))
    kind = SPHERE
    if scene == "bench":
        prims = make_clustered_particles(np.random.default_rng(2026), n)
    elif scene == "entry":
        return entry_inputs(dev)[0], kind, mpl, delta_kind, bits
    elif scene == "torus":
        prims, kind = torus_mesh(**TORUS), TRIANGLE
    elif scene == "random":
        prims = np.concatenate([rng.random((n, 3)), 0.01 + 0.05 * rng.random((n, 1))], axis=1)
    elif scene == "identical":
        prims = np.tile([[0.3, 0.6, 0.2, 0.05]], (n, 1))
    elif scene in ("triangles", "tri_zeros"):
        prims, kind = random_mesh(rng, n), TRIANGLE
        if scene == "tri_zeros":     # +0 / -0 coordinates, some tied within a triangle
            zero = rng.random(prims.shape) < 0.3
            prims[zero] = np.where(rng.random(int(zero.sum())) < 0.5, -0.0, 0.0)
    elif scene == "equal_keys":       # 30 points, 100 copies each: runs of zero deltas
        prims = np.concatenate([np.repeat(rng.random((30, 3)), n // 30, axis=0),
                                np.full((n, 1), 0.02)], axis=1)[rng.permutation(n)]
    else:
        prims = signed_zero_spheres(rng, n)
    prims = torch.from_numpy(np.ascontiguousarray(prims, np.float32)).to(dev)
    return prims, kind, mpl, delta_kind, bits


def check_sentinel_build(dev):
    """Two spheres at opposite corners with 63-bit keys: their XOR delta is
    the sentinel 0xFFFFFFFF (ROADMAP C19). The climb gives the valid tree,
    both leaves under the root, and the plain build, which takes the
    climb's rule for the ends, the same tree bit for bit (grace_tpu's rule
    would leave node 0's right child at node 0)."""
    from grace_tpu_torch.build.sph import build_sph_tree

    s = torch.tensor([[0, 0, 0, 0.1], [1, 1, 1, 0.1]], dtype=torch.float32, device=dev)
    _, plain, _ = build_sph_tree(s, 1, "xor", 63, plain=True)
    _, tree, _ = build_sph_tree(s, 1, "xor", 63)
    if tree.children.tolist() != [[~0, ~1]]:
        raise AssertionError(f"sentinel delta: children {tree.children.tolist()}")
    for f in BUILD_FIELDS:
        check_tensor_bits(f"sentinel delta {f}", getattr(tree, f), getattr(plain, f))
    return "sentinel delta (two spheres at opposite corners, 63-bit xor): children [[~0, ~1]], " \
           "every field bit-equal to the plain build (C19)"


def check_build(dev):
    """The check_build phase: every case of ``BUILD_CASES`` and the
    sentinel case. Returns (its lines, the bench scene's max abs errors by
    stage)."""
    lines, bench_errs = [], None
    for tag in BUILD_CASES:
        n_leaves, root, errs = check_build_case(tag, *build_case(tag, dev))
        bench_errs = bench_errs or errs
        lines.append(f"{tag}: keys, permutation, sorted primitives, deltas, split ranges and "
                     f"every tree field bit-equal to the plain build ({n_leaves} leaves, root "
                     f"{root}), also with the climbs at blocks {CLIMB_BLOCKS} besides the "
                     f"default; grace_gather_deltas' rows, permutation, boxes and deltas bit-equal "
                     f"to prims[perm], perm.to(int32), kind.aabb and the plain deltas; the entry "
                     f"twice, bit-equal, no host sync")
    lines.append(check_sentinel_build(dev))
    p, m = torch.zeros(1, device=dev), -torch.zeros(1, device=dev)
    signs = [f"{float(f(a, b)):+}" for f in (torch.minimum, torch.maximum)
             for a, b in ((p, m), (m, p))]
    lines.append(f"signed zeros on the card (ROADMAP C20): torch.minimum(+0, -0), (-0, +0) = "
                 f"{signs[0]}, {signs[1]}; torch.maximum = {signs[2]}, {signs[3]}")
    return lines, bench_errs


# check_keys' cases (grace_morton_keys, E2's keys): tag -> (source, n,
# bits, box, blocks, kind). source: "spheres" f32[n, 4] (a 16-byte load a
# row), "centroids" f32[n, 3], "strided" (rows 1, 3, 5, ... of f32[2n + 1,
# 5]: 10 floats a row, off a 16-byte boundary), "rays" (their midpoints);
# box: None (folded in the launch), "given" (f32[3]), "scalar" (f32[]),
# "unit" (lo 0 and hi the span: scale 1, so the key's bits show the
# conversion of each value); blocks: the folding grid's cap (None: the
# wrapper's; at 1 or 2 blocks some items are read again after the grid
# barrier);
# kind: "nan" (a NaN in one axis: that axis 0), "zeros" (-0 and +0 at the
# box's edges, an axis of +-0 alone: hi = lo = +-0, every value NaN, so
# 0), "identical", "inf" (+-inf in the points: the span inf or -inf),
# "edges" (NaN, +-inf, negatives, -0, subnormals, values at and past 2^32,
# 2^21, 2^10), "ties" (runs of equal rays).
KEY_SEED = 2033
KEY_CASES = {
    "clustered 5000 spheres, 30-bit": ("spheres", 5000, 30, None, None, ""),
    "clustered 5000 spheres, 63-bit": ("spheres", 5000, 63, None, None, ""),
    "5000 spheres, 1 block (items past the registers read again)":
        ("spheres", 5000, 30, None, 1, ""),
    "9001 centroids, 63-bit, 2 blocks": ("centroids", 9001, 63, None, 2, ""),
    "777 strided centroids, given box": ("strided", 777, 30, "given", None, ""),
    "777 strided centroids, box in the launch": ("strided", 777, 63, None, None, ""),
    "1 sphere": ("spheres", 1, 30, None, None, ""),
    "257 spheres (a ragged block)": ("spheres", 257, 63, None, None, ""),
    "no sphere": ("spheres", 0, 30, None, None, ""),
    "NaN in one axis": ("spheres", 1000, 30, None, None, "nan"),
    "-0 and +0 at the box edges, an axis of zeros": ("spheres", 1000, 63, None, 3, "zeros"),
    "identical points": ("spheres", 600, 30, None, None, "identical"),
    "+-inf in the points": ("centroids", 500, 30, None, None, "inf"),
    "conversion edges at scale 1, 30-bit": ("centroids", 57, 30, "unit", None, "edges"),
    "conversion edges at scale 1, 63-bit": ("centroids", 57, 63, "unit", None, "edges"),
    "conversion edges, box in the launch": ("spheres", 57, 63, None, None, "edges"),
    "scalar box": ("spheres", 900, 30, "scalar", None, ""),
    "4000 rays with ties": ("rays", 4000, 30, None, None, "ties"),
    "4000 rays with ties, 3 blocks": ("rays", 4000, 30, None, 3, "ties"),
    "3000 rays, given box": ("rays", 3000, 30, "given", None, ""),
    "rays, a NaN origin": ("rays", 700, 30, None, None, "nan"),
    "rays of zero length, -0 and +0 directions": ("rays", 513, 30, None, None, "zeros"),
    "1 ray": ("rays", 1, 30, None, None, ""),
}
# the values whose conversion to uint32 is at an edge
KEY_EDGES = np.array([np.nan, np.inf, -np.inf, -1.0, -0.0, 0.0, 1e-45, 1e-40, -1e-40,
                      0.99999994, 1.0, 1023.0, 1023.9999, 1024.0, 2097151.0, 2097152.0,
                      2.0 ** 31, 4294967040.0, 2.0 ** 32, 3e38], np.float32)


def key_scene(tag):
    """Case ``tag``'s numpy inputs: {"points" f32[n, 3], "spheres" f32[n,
    4] | "strided" f32[2n + 1, 5] | "origins", "directions", "lengths",
    "box" (lo, hi) or None}."""
    src, n, bits, box, _, kind = KEY_CASES[tag]
    rng = np.random.default_rng(KEY_SEED + list(KEY_CASES).index(tag))
    out = {}
    if src == "rays":
        o = rng.random((n, 3)).astype(np.float32)
        d = rng.standard_normal((n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        ln = (0.2 + rng.random(n)).astype(np.float32)
        if kind == "ties":            # runs of equal rays keep their input order
            for a in range(0, n - 60, 400):
                o[a:a + 50], d[a:a + 50], ln[a:a + 50] = o[a + 50], d[a + 50], ln[a + 50]
        elif kind == "nan":
            o[7, 1] = np.nan
        elif kind == "zeros":
            ln[::3] = 0.0
            d[::5, 0] = -0.0
            d[1::5, 2] = 0.0
            o[::7, 0] = -0.0
        out.update(origins=o, directions=d, lengths=ln)
        pts = (o.astype(np.float64) + (np.float32(0.5) * ln)[:, None].astype(np.float64)
               * d.astype(np.float64)).astype(np.float32)
    else:
        pts = make_clustered_particles(rng, n)[:, :3] if n else np.zeros((0, 3), np.float32)
        if kind == "nan":
            pts[::111, 0] = np.nan
        elif kind == "zeros":
            pts[:, 0] = np.where(rng.random(n) < 0.3, -0.0, pts[:, 0]).astype(np.float32)
            pts[::2, 0] = np.where(rng.random((n + 1) // 2) < 0.5, -0.0, 0.0)
            pts[:, 1] = np.where(rng.random(n) < 0.5, -0.0, 0.0)
        elif kind == "identical":
            pts[:] = (0.3, 0.6, 0.2)
        elif kind == "inf":
            pts[3, 1], pts[9, 2] = np.inf, -np.inf
        elif kind == "edges":
            e = np.resize(KEY_EDGES, n)
            pts = np.stack([e, np.roll(e, 5), np.roll(e, 11)], axis=1).astype(np.float32)
        pts = np.ascontiguousarray(pts, np.float32)
        if src == "strided":
            big = rng.random((2 * n + 1, 5)).astype(np.float32)
            big[1::2, :3] = pts
            out["strided"] = big
        else:
            out["spheres"] = np.concatenate([pts, 0.01 + 0.05 * rng.random((n, 1))],
                                            axis=1).astype(np.float32)
    out["points"] = pts
    span = np.float32((1 << 10) - 1 if bits == 30 else (1 << 21) - 1)
    if box == "given":
        lo = (np.nanmin(pts, axis=0) - 0.1).astype(np.float32)
        out["box"] = (lo, (np.nanmax(pts, axis=0) + 0.25).astype(np.float32))
    elif box == "scalar":
        out["box"] = (np.float32(-0.5), np.float32(1.5))
    elif box == "unit":
        out["box"] = (np.zeros(3, np.float32), np.full(3, span, np.float32))
    else:
        out["box"] = None
    return out


def key_outputs(tag, dev, plain):
    """Case ``tag`` through the port on ``dev``: {"keys"} (the rays' also
    "order", "inverse" and the sorted rays' arrays): with ``plain`` each
    step's plain version (the box by torch.amin / amax, the midpoints by
    vecmath.fma, the order's inverse by a second stable argsort), else the
    kernel route: the public calls (morton_keys_sph, morton_keys_cuda,
    spatial_sort_rays), or at a capped grid the wrappers with ``_blocks``."""
    from grace_tpu_torch.build.sph import morton_keys_sph
    from grace_tpu_torch.core.types import Rays
    from grace_tpu_torch.ops import morton
    from grace_tpu_torch.rays import gen

    src, n, bits, box, blocks, _ = KEY_CASES[tag]
    a = key_scene(tag)
    lo, hi = (None, None) if a["box"] is None else (
        torch.tensor(np.asarray(x), device=dev) for x in a["box"])
    if src == "rays":
        rays = Rays.from_arrays(a["origins"], a["directions"], a["lengths"], device=dev)
        if plain:
            keys = gen._midpoint_keys(rays, lo, hi, plain=True)
            order = torch.argsort(keys, stable=True)
            inv = torch.argsort(order, stable=True).to(torch.int32)
            srt, order = rays[order], order.to(torch.int32)
        else:
            keys = (morton.ray_keys_cuda(rays.origins, rays.directions, rays.lengths, lo, hi,
                                         _blocks=blocks) if blocks
                    else gen._midpoint_keys(rays, lo, hi))
            srt, order, inv = gen.spatial_sort_rays(rays, lo, hi)
        return {"keys": keys, "order": order, "inverse": inv, "sorted origins": srt.origins,
                "sorted directions": srt.directions, "sorted lengths": srt.lengths}
    if src == "strided":
        points = torch.from_numpy(a["strided"]).to(dev)[1::2, :3]
    elif src == "spheres":
        spheres = torch.from_numpy(a["spheres"]).to(dev)
        points = spheres[:, :3]
    else:
        points = torch.from_numpy(a["points"]).to(dev)
    if plain and n == 0:
        return {"keys": torch.zeros(0, dtype=torch.int64, device=dev)}
    if src == "spheres" and box is None and not blocks:
        return {"keys": morton_keys_sph(spheres, bits=bits, plain=plain)}
    if plain:
        return {"keys": morton.morton_keys_from_centroids(points, lo, hi, bits, plain=True)}
    return {"keys": morton.morton_keys_cuda(points, lo, hi, bits, _blocks=blocks)}


def check_keys(dev, rays=None):
    """The keys' kernel against the plain versions on the card at every
    case of KEY_CASES, bit for bit (the sorts' order, inverse and sorted
    rays too), and with ``rays`` (main path 1's) spatial_sort_rays'
    outputs likewise. Returns its lines."""
    from grace_tpu_torch.rays import gen

    lines = []
    for tag in KEY_CASES:
        got, want = key_outputs(tag, dev, False), key_outputs(tag, dev, True)
        for name, w in want.items():
            check_tensor_bits(f"keys {tag} {name}", got[name], w)
        lines.append(f"{tag}: {', '.join(want)} bit-equal to the plain versions")
    if rays is not None:
        keys = gen._midpoint_keys(rays, None, None, plain=True)
        order = torch.argsort(keys, stable=True)
        srt, o32, inv = gen.spatial_sort_rays(rays)
        for name, g, w in (("keys", gen._midpoint_keys(rays, None, None), keys),
                           ("order", o32, order.to(torch.int32)),
                           ("inverse", inv, torch.argsort(order, stable=True).to(torch.int32)),
                           ("sorted origins", srt.origins, rays.origins[order])):
            check_tensor_bits(f"keys path 1's rays {name}", g, w)
        lines.append(f"main path 1's {rays.n_rays} rays: spatial_sort_rays' keys, order, "
                     f"inverse and sorted rays bit-equal to the plain chain")
    return lines


def build_counters():
    """The build kernels' launch counts (csrc/build.cu)."""
    from grace_tpu_torch.build import deltas as bd
    from grace_tpu_torch.build import lbvh
    from grace_tpu_torch.ops import morton

    return {"build_morton_keys": morton.morton_keys_cuda.launches,
            "build_deltas": bd.deltas_cuda.launches,
            "build_gather_deltas": bd.gather_deltas_cuda.launches,
            "build_lbvh_ranges": lbvh.lbvh_ranges.launches,
            "build_lbvh_nodes": lbvh.lbvh_nodes.launches}


def zero_build_counters():
    from grace_tpu_torch.build import deltas as bd
    from grace_tpu_torch.build import lbvh
    from grace_tpu_torch.ops import morton

    for fn in (morton.morton_keys_cuda, bd.deltas_cuda, bd.gather_deltas_cuda, lbvh.lbvh_ranges,
               lbvh.lbvh_nodes):
        fn.launches = 0


def path_build_counters(counts):
    """The build kernels a main path runs, out of ``build_counters()``: all
    but grace_deltas, the public delta functions' kernel, since the build
    takes its deltas from grace_gather_deltas."""
    return {k: v for k, v in counts.items() if k != "build_deltas"}


def build_times(spheres, entry_spheres, tris):
    """The build's times (CUDA events, warm median, ms): each step of
    build_sph_tree alone on the bench scene at the main path's
    max_per_leaf, kernels and the torch calls between them, each kernel's
    plain version, and the plain build at each full size (the bench, the
    entry's 2,048 spheres, the torus). Returns
    (times, {kernel and "build": (operations, bytes)}): each kernel's inputs
    read once and outputs written once; the whole build's adds the torch
    calls' (the sort as one read of the keys and one write of the sorted
    keys and permutation: CUB's radix passes are not counted)."""
    from grace_tpu_torch.build import deltas as bd
    from grace_tpu_torch.build import lbvh
    from grace_tpu_torch.build.sph import build_primitive_tree, build_sph_tree, morton_keys_sph
    from grace_tpu_torch.ops import morton
    from grace_tpu_torch.ops.primitives import SPHERE, TRIANGLE
    from grace_tpu_torch.rays.gen import (_midpoint_keys, orthographic_projection_rays,
                                          spatial_sort_rays)

    n, mpl = spheres.shape[0], MAX_PER_LEAF
    c = SPHERE.centroid(spheres)
    lo, hi = c.amin(dim=0), c.amax(dim=0)
    keys = morton_keys_sph(spheres)
    rays = orthographic_projection_rays(SIDE, SIDE, CAM, LOOK, UP, VEXT, LENGTH,
                                        device=spheres.device)
    ray_keys = lambda: morton.ray_keys_cuda(rays.origins, rays.directions, rays.lengths)
    keys_sorted, perm = torch.sort(keys, stable=True)
    ss, perm32, mins, maxs, d = bd.gather_deltas_cuda(spheres, "sphere", perm, keys_sorted,
                                                      "euclidean")
    l, r, first, count, mark = lbvh.lbvh_ranges(d, mpl)
    scan = torch.cumsum(mark, dim=0, dtype=torch.int32)
    tree = lbvh.lbvh_nodes(d, first, count, mark, scan, mins, maxs, mpl)
    nl = int(tree.n_leaves)

    def torch_gather():
        sp = spheres[perm]
        return sp, perm.to(torch.int32), SPHERE.aabb(sp), bd.deltas_cuda(
            "euclidean", a=SPHERE.centroid(sp))

    t = {}
    # the keys: the build's call (the box folded in the one launch), at a
    # given box, and main path 1's rays by their midpoints; each kernel's
    # device time by the profiler (the mean of the launches its windows saw)
    for label, fn, plain in (
            ("", lambda: morton_keys_sph(spheres), lambda: morton_keys_sph(spheres, plain=True)),
            (" (given box)", lambda: morton.morton_keys_cuda(c, lo, hi, 30),
             lambda: morton._morton_keys_plain(c, lo, hi, 30)),
            (" (path 1's rays)", ray_keys,
             lambda: _midpoint_keys(rays, None, None, plain=True))):
        t[f"build_morton_keys kernel{label}"] = cuda_ms(fn)
        t[f"build_morton_keys plain{label}"] = cuda_ms(plain)
        ms, seen = kernel_device_ms_seen(fn, "morton_keys_kernel")
        device = f"build_morton_keys device (profiler; the kernel alone{label})"
        if ms is None:
            log(f"time {device}: not measured (the profiler saw no device time of the kernel)")
        else:
            t[device] = ms
            log(f"{device}: the mean of {seen} launches the profiler saw")
    for label, fn in (("morton_keys_sph (bench scene, no box)", lambda: morton_keys_sph(spheres)),
                      ("spatial_sort_rays (path 1's 512^2 rays)",
                       lambda: spatial_sort_rays(rays))):
        names = device_ops(fn)
        kinds = {}
        for name in names:
            short = name.split("(")[0].split("<")[0].split("::")[-1].strip() or name[:40]
            kinds[short] = kinds.get(short, 0) + 1
        log(f"{label}: {len(names)} device operations: {json.dumps(kinds)}")
    t["build key sort (torch.sort, stable)"] = cuda_ms(lambda: torch.sort(keys, stable=True))
    t["build_gather_deltas kernel (euclidean)"] = cuda_ms(
        lambda: bd.gather_deltas_cuda(spheres, "sphere", perm, keys_sorted, "euclidean"))
    t["build_gather_deltas plain (spheres[perm], i32, sphere_aabb, plain deltas)"] = cuda_ms(
        lambda: (spheres[perm], perm.to(torch.int32), SPHERE.aabb(ss),
                 bd.euclidean_deltas(ss, SPHERE.centroid, plain=True)))
    t["build gather, cast, boxes and grace_deltas (the steps the gather kernel replaced)"] = \
        cuda_ms(torch_gather)
    t["build_deltas kernel (euclidean)"] = cuda_ms(
        lambda: bd.deltas_cuda("euclidean", a=SPHERE.centroid(ss)))
    t["build_deltas plain (euclidean)"] = cuda_ms(
        lambda: bd.euclidean_deltas(ss, SPHERE.centroid, plain=True))
    t["build_lbvh_ranges kernel"] = cuda_ms(lambda: lbvh.lbvh_ranges(d, mpl))
    t["build_lbvh_ranges plain (cartesian_tree_ranges, coalesce_leaves)"] = cuda_ms(
        lambda: lbvh.coalesce_leaves(*lbvh.cartesian_tree_ranges(d), mpl, n), reps=3)
    t["build prefix sum (torch.cumsum)"] = cuda_ms(
        lambda: torch.cumsum(mark, dim=0, dtype=torch.int32))
    t["build_lbvh_nodes kernel"] = cuda_ms(
        lambda: lbvh.lbvh_nodes(d, first, count, mark, scan, mins, maxs, mpl))
    t["build_lbvh plain (both phases)"] = cuda_ms(
        lambda: lbvh.build_lbvh_plain(mins, maxs, d, mpl), reps=3)
    t["build_sph_tree plain"] = cuda_ms(
        lambda: build_sph_tree(spheres, mpl, plain=True), reps=3)
    t["build_sph_tree plain (entry, 2048 spheres)"] = cuda_ms(
        lambda: build_sph_tree(entry_spheres, 16, plain=True), reps=3)
    t["build_primitive_tree plain (torus)"] = cuda_ms(
        lambda: build_primitive_tree(tris, TRIANGLE, 8, "xor", plain=True), reps=3)
    # operations: a key's 3 subtractions, products and conversions, its 30
    # bit operations and 6 box folds (a ray's midpoint 10 more); a delta's 8 (3 subtractions,
    # 3 products, 2 sums) and a sphere's box 6; a climb's arrival about 12
    # integer operations (2 N - 1 a phase A, 2 n_leaves - 1 a phase B) and a
    # box union 6 (a leaf's primitives, then a node's two children)
    work = {
        "build_morton_keys": (45 * n, nbytes(spheres, keys)),
        "build_morton_keys (path 1's rays)": (
            55 * rays.n_rays, nbytes(rays.origins, rays.directions, rays.lengths, ray_keys())),
        "build_deltas": (8 * (n - 1), nbytes(SPHERE.centroid(ss), d)),
        "build_gather_deltas": (14 * n, nbytes(perm, spheres, ss, perm32, mins, maxs, d)),
        "build_lbvh_ranges": (12 * (2 * n - 1), nbytes(d, l, r, mark) + 8 * nl),
        "build_lbvh_nodes": (12 * (2 * nl - 1) + 6 * (n + nl - 1),
                             nbytes(mark, scan, mins, maxs, tree.children, tree.child_aabbs,
                                    tree.leaves) + 8 * nl + 4 * (nl - 1) + 12),
    }
    # the torch calls between the kernels: the key sort and the marks' scan
    torch_bytes = nbytes(keys, keys_sorted, perm) + nbytes(mark, scan)
    on_path = ("build_morton_keys", "build_gather_deltas", "build_lbvh_ranges", "build_lbvh_nodes")
    work["build"] = (sum(work[k][0] for k in on_path),
                     sum(work[k][1] for k in on_path) + torch_bytes)
    return t, work


# check_splat_prep's cases: tag -> (particles, image side, (tile_w, tile_h),
# band, chunk, weighted, whole, morton). The bucketed setup runs at (tile_w,
# tile_h, band, chunk), the sort-free one at (tile_w, tile_h), both at the
# bench camera. Every scene has dead particles (h = 0, behind the camera,
# past the far plane; weights 0 and -1 where weighted); ``whole`` adds a
# particle that covers the whole image and one beyond 2^31 band widths
# (ROADMAP C21), each a footprint that overflows; ``morton`` sorts the
# clustered particles by their Morton keys first, as path 1's build does.
SPLAT_PREP_SEED = 2027
SPLAT_PREP_CASES = {
    "n 3001 (no multiple of chunk, 2 chunk or 128; 24 segments), band 32":
        (3001, 128, (32, 128), 32, 64, False, False, False),
    "n 3001, band None, weights, a whole-image and a far particle (overflow)":
        (3001, 128, (32, 128), None, 64, True, True, False),
    "n 17 (< 32: one segment), 64 x 64, tile 16 x 64, band 16, chunk 8":
        (17, 64, (16, 64), 16, 8, True, False, False),
    "n 8192 (64 segments), tile 8 x 16 (128 tiles), band 16, overflow":
        (8192, 128, (8, 16), 16, 64, False, True, False),
    "n 3001, tile 8 x 64, band 64, weights": (3001, 128, (8, 64), 64, 64, True, False, False),
    "clustered 2^16, 512 x 512, tile 16 x 128 (128 tiles), band 32, chunk 512":
        (65536, 512, (16, 128), 32, 512, False, False, False),
    "n 5000 (40 segments: two mask words, the last ragged), tile 32 x 64, band 32, weights":
        (5000, 128, (32, 64), 32, 64, True, False, False),
    "Morton-sorted clustered 20,000 (no multiple of the block tile), 512 x 512, tile 32 x 128, "
    "band 32 (256 keys, path 1's), chunk 512": (20000, 512, (32, 128), 32, 512, False, False, True),
    "n 3001, 512 x 512, tile 8 x 16, band 8 (4,096 keys: the counters in device memory), "
    "weights, overflow": (3001, 512, (8, 16), 8, 64, True, True, False),
}
SPLAT_PREP_OUTPUTS = ("slabs", "slab_lo", "n_slabs", "first", "last", "xcols", "yrows",
                      "overflow", "masks", "masks_t", "coords", "sortfree slabs")


def splat_prep_scene(tag):
    """(spheres f32[n, 4], weights f32[n] or None) of check_splat_prep's
    case ``tag`` as numpy arrays, drawn from SPLAT_PREP_SEED."""
    n, _, _, _, _, weighted, whole, morton = SPLAT_PREP_CASES[tag]
    rng = np.random.default_rng(SPLAT_PREP_SEED + list(SPLAT_PREP_CASES).index(tag))
    s = make_clustered_particles(rng, n)
    if morton:
        from grace_tpu_torch.build.sph import sort_by_morton

        s = sort_by_morton(torch.from_numpy(s))[1].numpy().copy()
    s[0::97, 3] = 0.0           # h = 0
    s[1::101, 2] = -3.0         # behind the camera
    s[2::103, 2] = 50.0         # past the far plane
    if whole:
        s[n // 2] = (0.5, 0.5, 0.5, 5.0)
        s[n // 3] = (3e9, 3e9, 0.5, 1e3)
    w = None
    if weighted:
        w = (0.5 + rng.random(n)).astype(np.float32)
        w[3::50] = 0.0
        w[4::50] = -1.0
    return s, w


def splat_prep_both(spheres, weights, side, tiles, band, chunk, plain):
    """E4's and E5's outputs (``SPLAT_PREP_OUTPUTS``, in order) at the bench
    camera: bucket_prims_ortho and sortfree_setup (the kernels of
    csrc/splat_prep.cu on CUDA tensors), or with ``plain`` their plain
    versions on the same tensors."""
    from grace_tpu_torch.trace import splat as sp
    from grace_tpu_torch.trace import splat_grad as sg

    tile_w, tile_h = tiles
    args = (CAM, LOOK, UP, VEXT, LENGTH, side, side)
    cam = sg.OrthoCamera(*args)
    if plain:
        b = sp._bucket_prims_ortho_plain(spheres, *args, tile_w, tile_h, chunk, weights,
                                         tile_h if band is None else band)
        return (*b, *sg._sortfree_setup_plain(spheres, weights, cam, tile_w, tile_h))
    b = sp.bucket_prims_ortho(spheres, *args, tile_w=tile_w, tile_h=tile_h, chunk=chunk,
                              weights=weights, band=band)
    return (*b, *sg.sortfree_setup(spheres, weights, cam, tile_w, tile_h))


def check_splat_prep_case(tag, spheres, weights, side, tiles, band, chunk):
    """csrc/splat_prep.cu against the plain versions on the same card
    tensors, bit for bit: every SplatBuckets field of bucket_prims_ortho,
    and sortfree_setup's masks, transposed masks, coords and slabs. Returns
    ({output: max abs err}, overflow)."""
    got = splat_prep_both(spheres, weights, side, tiles, band, chunk, plain=False)
    want = splat_prep_both(spheres, weights, side, tiles, band, chunk, plain=True)
    torch.cuda.synchronize()
    errs = {}
    for name, g, w in zip(SPLAT_PREP_OUTPUTS, got, want):
        check_tensor_bits(f"{tag} {name}", g, w)
        g, w = g.double(), w.double()
        errs[name] = float(torch.where(g == w, 0.0, (g - w).abs()).max()) if w.numel() else 0.0
    return errs, bool(got[7])


def check_splat_prep(dev):
    """The check_splat_prep phase: E4 and E5 bit-equal to their plain
    versions at every case of SPLAT_PREP_CASES. Returns its lines."""
    lines = []
    for tag, (n, side, tiles, band, chunk, *_) in SPLAT_PREP_CASES.items():
        s, w = splat_prep_scene(tag)
        spheres = torch.from_numpy(s).to(dev)
        weights = None if w is None else torch.from_numpy(w).to(dev)
        _, overflow = check_splat_prep_case(tag, spheres, weights, side, tiles, band, chunk)
        lines.append(f"{tag}: every SplatBuckets field and the sort-free masks, transposed "
                     f"masks, coords and slabs bit-equal to the plain versions (overflow "
                     f"{overflow})")
    return lines


def prep_counters():
    """The splat setups' launch counts (csrc/splat_prep.cu)."""
    from grace_tpu_torch.trace import splat as sp
    from grace_tpu_torch.trace import splat_grad as sg

    return {"splat_bucket_keys": sp.bucket_keys_cuda.launches,
            "splat_bucket_pack": sp.bucket_pack_cuda.launches,
            "sortfree_setup": sg.sortfree_setup_cuda.launches}


def zero_prep_counters():
    from grace_tpu_torch.trace import splat as sp
    from grace_tpu_torch.trace import splat_grad as sg

    for fn in (sp.bucket_keys_cuda, sp.bucket_pack_cuda, sg.sortfree_setup_cuda):
        fn.launches = 0


def distinct_per_run(keys, run):
    """(mean, max) distinct values among each ``run`` consecutive entries
    of keys (the last run ragged)."""
    m = keys.shape[0]
    pad = -m % run
    rows = torch.cat([keys, keys[-1:].expand(pad)]).view(-1, run) if pad else keys.view(-1, run)
    rows = torch.sort(rows, dim=1).values
    distinct = 1 + (rows[:, 1:] != rows[:, :-1]).sum(1)
    return float(distinct.double().mean()), int(distinct.max())


def splat_prep_times(spheres, weights, cam, side):
    """The setups' times (CUDA events, warm median, ms) on main paths 1 and
    3's inputs: the bucketed setup whole, each of its passes alone (with
    its kernel's device time, torch.profiler) and the call's device
    operations, torch's stable sort of the same keys (the one PyTorch call
    that computes the sort), the sort-free setup, and each setup's plain
    version; the instances' figures. Returns (times, {name: (operations,
    bytes)}): each kernel's inputs read once and its outputs written once;
    ``bucket_prep`` the function's own (spheres read; slabs, ranges and
    overflow written)."""
    from grace_tpu_torch.trace import splat as sp
    from grace_tpu_torch.trace import splat_grad as sg

    tile_w, tile_h = SPLAT_TILE["tile_w"], SPLAT_TILE["tile_h"]
    args = (CAM, LOOK, UP, VEXT, LENGTH, side, side)
    n = spheres.shape[0]
    dev = spheres.device
    consts, _, _ = sp._bucket_constants(*args, tile_w, 32, dev)
    nbx, nty = side // 32, side // tile_w
    n_keys = nbx * nty
    tile, blocks = sp.bucket_blocks(n, n_keys)
    counts = torch.empty(sp.bucket_scratch(n_keys, blocks), dtype=torch.int32, device=dev)
    sp.bucket_keys_cuda(spheres, None, consts, counts, nbx, nty, tile)
    slabs, ranges, overflow = sp.bucket_pack_cuda(spheres, None, consts, counts, 512, nbx, nty,
                                                  tile)
    frame = sp._ortho_frame(*args, tile_w, 32, dev)
    keys = sp._bucket_keys_plain(spheres, frame, None, side, side, tile_w, tile_h, 32)[0]
    real = int((keys < n_keys).sum())
    warp_mean, warp_max = distinct_per_run(keys, 32)
    block_mean, block_max = distinct_per_run(keys, tile)
    log(f"bucket prep instances on the bench ({n} particles, {n_keys} keys): {real} real, "
        f"{4 * n - real} sentinel; distinct keys a warp (32 consecutive instances) {warp_mean:.2f} "
        f"(at most {warp_max}), a block tile ({tile}) {block_mean:.2f} (at most {block_max}); "
        f"the largest key {int((ranges[1] - ranges[0]).max())} instances; {blocks} blocks")
    for name, res in sp.bucket_resources(dev, n_keys).items():
        log(f"resources {name} (bench, {n_keys} keys; csrc/splat_prep.cu): {json.dumps(res)}")
        if res["local_bytes"]:
            raise AssertionError(f"the {name} kernel uses local memory: {res}")
    sf_consts, spans, coords = sg._setup_constants(cam, tile_w, tile_h, dev)
    masks, masks_t, _, sf_slabs = sg.sortfree_setup_cuda(spheres, weights, sf_consts, spans,
                                                         coords, side // tile_h, side // tile_w)
    bucket = lambda: sp.bucket_prims_ortho(spheres, *args, chunk=512, band=32, **SPLAT_TILE)
    keys_pass = lambda: sp.bucket_keys_cuda(spheres, None, consts, counts, nbx, nty, tile)

    def passes():   # pass 2 scans pass 1's counts in place, so it runs after pass 1
        keys_pass()
        return sp.bucket_pack_cuda(spheres, None, consts, counts, 512, nbx, nty, tile)

    t = {}
    t["bucket_prep kernel"] = cuda_ms(bucket)
    t["bucket_prep plain"] = cuda_ms(lambda: sp._bucket_prims_ortho_plain(
        spheres, *args, tile_w, tile_h, 512, None, 32), reps=3)
    t["splat_bucket_keys kernel"] = cuda_ms(keys_pass)
    t["splat_bucket passes (keys, then pack)"] = cuda_ms(passes)
    t["bucket key sort (torch.sort, stable)"] = cuda_ms(lambda: torch.sort(keys, stable=True))
    for label, fn, kernel in (("splat_bucket_keys", keys_pass, "bucket_keys_kernel"),
                              ("splat_bucket_pack", passes, "bucket_pack_kernel")):
        log_device_ms(t, f"{label} device (profiler; the kernel alone)", fn, kernel)
    # pass 2 alone: its kernel's device time, else both passes (a bound from above)
    t["splat_bucket_pack kernel"] = t.get("splat_bucket_pack device (profiler; the kernel "
                                          "alone)", t["splat_bucket passes (keys, then pack)"])
    ops = device_op_ms(bucket)
    log(f"bucket_prims_ortho: {len(ops)} device operations a call, "
        + "; ".join(f"{name[:60]} {ms:.4f} ms" for name, ms in ops)
        + (f"; busy {sum(ms for _, ms in ops):.4f} ms (profiler, 20 calls)" if ops
           else " (not measured: the profiler saw none)"))
    t["sortfree setup kernel"] = cuda_ms(
        lambda: sg.sortfree_setup(spheres, weights, cam, tile_w, tile_h))
    t["sortfree setup plain"] = cuda_ms(
        lambda: sg._sortfree_setup_plain(spheres, weights, cam, tile_w, tile_h), reps=3)
    log_device_ms(t, "sortfree setup device (profiler; the kernel alone)",
                  lambda: sg.sortfree_setup(spheres, weights, cam, tile_w, tile_h),
                  "sortfree_setup_kernel")
    # operations: a particle's 3 dot products (5 each), depth's 3
    # subtractions, 2 products, 2 divisions and 4 comparisons of its scale,
    # 4 quotients (3 each) and 4 floors, 4 keys (8 each), counted in each
    # pass that computes them; a few integer operations an instance to
    # count it (4) and to rank it (8); the counters' scan (read and written
    # in place) and the ranges; the sort-free setup's
    # projection (24) and box (8), and 4 comparisons a (tile, segment) pair
    n_tiles = masks.shape[0]
    work = {
        "splat_bucket_keys": (83 * n + 16 * n, nbytes(spheres, consts, counts)),
        "splat_bucket_pack": (83 * n + 32 * n + 8 * n_keys + 2 * counts.numel(),
                              nbytes(spheres, consts, counts, counts, slabs, ranges, overflow)),
        "sortfree_setup": (32 * n + 4 * n_tiles * sf_slabs.shape[0],
                           nbytes(spheres, weights, sf_consts, spans, sf_slabs, masks, masks_t)),
        "bucket_prep": (83 * n, nbytes(spheres, slabs, ranges, overflow)),
    }
    return t, work


# check_broadphase's edge cases: tag -> (particles, tiles, tile, kind). The
# rays come in coherent tiles (a shared origin and direction, jittered) over
# the clustered particles; "edges" adds NaN particles, particles at -0 and
# +0 with radius 0, zero-length rays, a tile of only them and a NaN ray;
# "wide" tiles span the whole box, so every segment is in some list;
# "nanwords" adds to wide tiles a word of 32 NaN quarters, a NaN quarter in
# a word whose other quarters overlap every tile, and a NaN ray. With
# 1,100 tiles the segments x tiles words (dense_segment_tiles) span two
# strips of the overlap kernel, the last ragged.
BROADPHASE_SEED = 2028
BROADPHASE_CASES = {
    "n 1000 (no multiple of 32 or 128), 40 tiles of 32 (no multiple of 32)": (1000, 40, 32, ""),
    "n 1 (one segment), 8 tiles of 8": (1, 8, 8, ""),
    "n 0 (no segment), 4 tiles of 32": (0, 4, 32, ""),
    "n 3000, NaN particles, signed zeros, zero-length rays, a tile of them, a NaN ray":
        (3000, 48, 32, "edges"),
    "clustered 2^14, 64 tiles of 64": (16384, 64, 64, ""),
    "n 40000 (1,250 quarters: a ragged summary word), 33 wide tiles of 16":
        (40000, 33, 16, "wide"),
    "n 4000, a word of 32 NaN quarters, a NaN quarter beside overlapping ones, a NaN ray, "
    "40 wide tiles of 16": (4000, 40, 16, "nanwords"),
    "n 5000, 1,100 tiles of 8 (segments x tiles: 35 words, two strips)": (5000, 1100, 8, ""),
}


def broadphase_scene(tag):
    """(spheres f32[n, 4], origins f32[R, 3], directions f32[R, 3], lengths
    f32[R]) of check_broadphase's case ``tag`` as numpy arrays."""
    n, n_tiles, tile, kind = BROADPHASE_CASES[tag]
    rng = np.random.default_rng(BROADPHASE_SEED + list(BROADPHASE_CASES).index(tag))
    s = make_clustered_particles(rng, n) if n else np.zeros((0, 4), np.float32)
    r = n_tiles * tile
    centre = np.repeat(rng.random((n_tiles, 3)), tile, axis=0)
    aim = np.repeat(rng.standard_normal((n_tiles, 3)), tile, axis=0)
    o = centre + 0.02 * rng.standard_normal((r, 3))
    d = aim + 0.05 * rng.standard_normal((r, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ln = rng.uniform(0.05, 0.6, r)
    if kind in ("wide", "nanwords"):
        o = 0.5 + 0.01 * rng.standard_normal((r, 3))
        d = rng.standard_normal((r, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        ln = np.full(r, 3.0)
    o, d, ln = o.astype(np.float32), d.astype(np.float32), ln.astype(np.float32)
    if kind == "edges":
        s[::97, :3] = np.nan
        s[1::89] = (-0.0, 0.5, 0.5, 0.0)
        s[2::89] = (0.0, 0.5, -0.0, 0.0)
        ln[5 * tile:6 * tile] = 0.0           # a tile of zero-length rays
        ln[::7] = 0.0
        ln[9 * tile:10 * tile:3] = -0.0
        o[7 * tile + 3, 1] = np.nan           # a NaN ray: its tile's box overlaps nothing
        o[11 * tile:12 * tile] = 0.0          # origins at the box edge
        o[11 * tile:12 * tile:2, 0] = -0.0
    if kind == "nanwords":
        s[1024:2048, 0] = np.nan              # quarters 32-63: a word of NaN boxes
        s[5, 1] = np.nan                      # quarter 0 NaN, quarters 1-31 overlap
        o[3 * tile + 2, 2] = np.nan           # a NaN ray: its tile's box overlaps nothing
    return s, o, d, ln


# check_broadphase's box cases (grace_broadphase_boxes, both parts in one
# launch, at blocks 32 and 128): tag -> (particles, tiles, tile, kind,
# offset). Tiles 128 (NaN among them) and 512 (four units a lane) take
# the 16-byte ray route; tiles 4, 6, 32, 48 and 64, and rays that start `offset` rays into
# a larger tensor (bases not 16-byte aligned; tile 1,024: 32 rays a lane),
# the 4-byte route. "nan": NaN in spheres'
# centres and radii and in rays' origins, directions and lengths; "extreme":
# centres and radii at +-0, +-inf and F32_MAX (c - r and c + r overflow or
# are inf - inf), origins at +-0 and +-inf, directions of +-inf against
# lengths of 0 (an endpoint inf * 0) and F32_MAX lengths (an endpoint past
# f32). No spheres, and no rays.
BOX_SET_SEED = 2032
BOX_SET_CASES = {
    "n 1000, 50 tiles of 4": (1000, 50, 4, "", 0),
    "n 300, 9 tiles of 32": (300, 9, 32, "", 0),
    "n 2049, 35 tiles of 128, NaN in spheres and rays": (2049, 35, 128, "nan", 0),
    "n 128, 30 tiles of 128": (128, 30, 128, "", 0),
    "n 900, 5 tiles of 512": (900, 5, 512, "", 0),
    "n 777, 21 tiles of 6 (4-byte rays)": (777, 21, 6, "", 0),
    "n 1500, 20 tiles of 64 one ray into a larger tensor (4-byte rays)": (1500, 20, 64, "", 1),
    "n 4100, 3 tiles of 1,024 two rays in (4-byte rays)": (4100, 3, 1024, "", 2),
    "n 640, 11 tiles of 48, +-0, +-inf and F32_MAX": (640, 11, 48, "extreme", 0),
    "no spheres, 16 tiles of 8": (0, 16, 8, "", 0),
    "n 500, no rays": (500, 0, 32, "", 0),
}


def box_set_scene(tag):
    """(spheres f32[n, 4], origins f32[R + offset, 3], directions, lengths
    f32[R + offset]) of box case ``tag`` as numpy arrays; the case's rays
    are the last R."""
    n, n_tiles, tile, kind, offset = BOX_SET_CASES[tag]
    rng = np.random.default_rng(BOX_SET_SEED + list(BOX_SET_CASES).index(tag))
    s = make_clustered_particles(rng, n) if n else np.zeros((0, 4), np.float32)
    r = n_tiles * tile + offset
    o = rng.random((r, 3)).astype(np.float32)
    d = rng.standard_normal((r, 3)).astype(np.float32)
    ln = rng.uniform(0.0, 0.5, r).astype(np.float32)
    f32_max = np.finfo(np.float32).max
    if kind == "nan":
        s[3::101, 1], s[50::211, 3] = np.nan, np.nan
        o[offset + 5, 0] = d[offset + 3 * tile + 7, 2] = ln[offset + 9 * tile + 1] = np.nan
    if kind == "extreme":
        s[0, :3], s[1, :3], s[2, 3] = -0.0, 0.0, 0.0
        s[5] = (np.inf, 0.5, -np.inf, 0.1)
        s[40] = (np.inf, 0.5, 0.5, np.inf)           # c - r = inf - inf
        s[200] = (0.5, -f32_max, 0.5, f32_max)       # c - r past -F32_MAX
        s[300] = (f32_max, 0.5, -0.0, 1.0)
        o[:tile, 0] = -0.0                           # a tile of -0 and +0
        o[tile:2 * tile:2, 0] = 0.0
        o[2 * tile + 3] = (np.inf, -np.inf, 0.5)
        d[3 * tile + 1] = (np.inf, -np.inf, 0.0)
        ln[3 * tile + 1] = 0.0                       # inf * 0: a NaN endpoint
        d[4 * tile + 2] = (-np.inf, 0.5, 0.5)
        ln[5 * tile:6 * tile] = f32_max              # endpoints past f32
        ln[6 * tile + 4] = -0.0
    return s, o, d, ln


def box_set_inputs(tag, dev):
    """(spheres, rays, tile) of box case ``tag`` on ``dev``: the rays the
    last R of a larger tensor where the case has an offset."""
    from grace_tpu_torch.core.types import Rays

    s, o, d, ln = box_set_scene(tag)
    offset = BOX_SET_CASES[tag][4]
    rays = Rays.from_arrays(o, d, ln, device=dev)[offset:]
    return torch.from_numpy(s).to(dev), rays, BOX_SET_CASES[tag][2]


def box_set_outputs(spheres, rays, tile, block, plain):
    """{name: tensor} of a box case: both parts through broadphase_boxes_cuda
    (or the plain versions), and each part alone through the public
    tile_aabbs and segment_aabbs (the kernels on CUDA tensors)."""
    from grace_tpu_torch.trace import broadphase as bp
    from grace_tpu_torch.trace import pallas_broadphase as pb

    if plain:
        tiles, segs = bp._tile_aabbs_plain(rays, tile), pb._segment_aabbs_plain(spheres, block)
        alone = tiles + segs
    else:
        tiles, segs = pb.broadphase_boxes_cuda(rays, tile, spheres, block)
        alone = bp.tile_aabbs(rays, tile) + pb.segment_aabbs(spheres, block)
    names = ("tile box min", "tile box max", "segment box min", "segment box max")
    out = dict(zip(names, tiles + segs))
    out.update(zip((f"{k} (alone)" for k in names), alone))
    return out


def check_box_set_case(tag, dev):
    """grace_broadphase_boxes against the plain versions at box case ``tag``
    and blocks 32 and 128: boxes equal in value, NaN at the same places
    (zero signs free, counted). Returns its lines."""
    spheres, rays, tile = box_set_inputs(tag, dev)
    lines = []
    for block in (32, 128):
        got = box_set_outputs(spheres, rays, tile, block, plain=False)
        want = box_set_outputs(spheres, rays, tile, block, plain=True)
        signs = sum(_box_like(f"{tag} block {block} {k}", got[k], w) for k, w in want.items())
        lines.append(f"boxes {tag}, block {block}: both parts in one launch and each alone "
                     f"equal to the plain versions ({signs} zero signs apart)")
    return lines


def check_box_sets(dev):
    """check_box_set_case at every case of BOX_SET_CASES. Returns its lines."""
    return [line for tag in BOX_SET_CASES for line in check_box_set_case(tag, dev)]


# check_broadphase's overlap-word cases on given boxes: tag -> (rows,
# columns, kind), each with the summary on and off, held to
# overlap_words_reference. Boxes are random in the unit cube; "nan" sets
# NaN coordinates in single columns of words whose other columns overlap
# every row (a wide column beside each), NaN in every column of a word (in
# min, max or both), and NaN rows; "zeros" puts rows and columns that
# touch only at -0 and +0 (a row's min +0 or -0 against a column's max -0
# or +0, and the other way round). 1,100 columns are 35 words: a ragged
# last word and a ragged last strip of the kernel's 32 words.
OVERLAP_BOX_SEED = 2031
OVERLAP_BOX_CASES = {
    "300 rows x 1,100 columns: NaN columns beside overlapping ones, a word of NaN columns, "
    "NaN rows": (300, 1100, "nan"),
    "70 x 96: boxes that touch at -0 and +0": (70, 96, "zeros"),
    "45 rows x 7 columns (< 32)": (45, 7, ""),
    "no rows (0 x 50)": (0, 50, ""),
    "no columns (10 x 0)": (10, 0, ""),
}


def overlap_box_scene(tag):
    """(row_min, row_max, col_min, col_max) f32[., 3] of the overlap-word
    case ``tag`` as numpy arrays."""
    n_rows, n_cols, kind = OVERLAP_BOX_CASES[tag]
    rng = np.random.default_rng(OVERLAP_BOX_SEED + list(OVERLAP_BOX_CASES).index(tag))

    def boxes(n):
        c = rng.random((n, 3))
        h = 0.01 + 0.09 * rng.random((n, 3))
        return (c - h).astype(np.float32), (c + h).astype(np.float32)

    rmin, rmax = boxes(n_rows)
    cmin, cmax = boxes(n_cols)
    if kind == "nan":
        cmin[0::32, 0] = np.nan               # column 32 w of each word: NaN
        cmax[2::32, 1] = np.nan               # column 32 w + 2: NaN
        cmin[1::32], cmax[1::32] = -1.0, 2.0  # column 32 w + 1 overlaps every row
        word = slice(3 * 32, 4 * 32)          # word 3: NaN in every column
        cmin[word, 2] = np.nan
        cmax[word][::2, 0] = np.nan
        rmin[7, 0] = np.nan                   # NaN rows
        rmax[40] = np.nan
    if kind == "zeros":
        rmin[::2, 0], rmin[1::2, 0] = 0.0, -0.0
        cmax[::3, 0], cmax[1::3, 0], cmax[2::3, 0] = -0.0, 0.0, -0.0
        cmin[:, 0] = -0.5
        rmax[:, 0] = 0.5
        rmax[::5, 1], cmin[::7, 1] = -0.0, 0.0
        rmin[::5, 1], cmax[::7, 1] = -0.5, 0.5
    return rmin, rmax, cmin, cmax


def overlap_words_reference(row_min, row_max, col_min, col_max):
    """The overlap words of row boxes against column boxes (both min, max
    f32[., 3] tensors) and their summary words by the plain versions' means:
    the dense bool matrix of the broadphase's test (min <= max' and min' <=
    max on every axis), packed by pack_overlap_bits, and the summary the
    packing of the words being nonzero."""
    from grace_tpu_torch.trace.pallas_broadphase import pack_overlap_bits

    n_rows, n_words = row_min.shape[0], -(-col_min.shape[0] // 32)
    if n_rows == 0:
        empty = lambda w: torch.zeros((0, w), dtype=torch.int32, device=row_min.device)
        return empty(n_words), empty(-(-n_words // 32))
    overlap = ((row_min[:, None] <= col_max[None]) & (col_min[None] <= row_max[:, None])).all(-1)
    words = pack_overlap_bits(overlap)
    return words, pack_overlap_bits(words != 0)


def overlap_word_counts(row_min, row_max, col_min, col_max, words):
    """How sparse overlap words are: (pairs, set bits, nonzero words,
    candidate words), the candidates being the words whose column hull
    (each axis' min and max over the word's columns, NaNs dropped, NaN
    where all are) overlaps the row, as overlap_words_kernel culls them.
    Raises if a nonzero word is no candidate (the cull would drop its
    bits)."""
    from grace_tpu_torch.trace.pallas_broadphase import _popcount32

    n_rows, n_cols = row_min.shape[0], col_min.shape[0]
    n_words = words.shape[1]
    nan = torch.full((n_words * 32 - n_cols, 3), float("nan"), device=col_min.device)
    hulls = []
    for cols, fill, reduce in ((col_min, float("inf"), torch.amin),
                               (col_max, float("-inf"), torch.amax)):
        c = torch.cat([cols, nan]).reshape(n_words, 32, 3)
        hull = reduce(torch.where(torch.isnan(c), fill, c), dim=1)
        hulls.append(torch.where(torch.isnan(c).all(dim=1), float("nan"), hull))
    near = ((row_min[:, None] <= hulls[1][None]) & (hulls[0][None] <= row_max[:, None])).all(-1)
    nonzero = words != 0
    if bool((nonzero & ~near).any()):
        raise AssertionError(f"{int((nonzero & ~near).sum())} nonzero words outside the cull")
    return (n_rows * n_cols, int(_popcount32(words).sum()), int(nonzero.sum()),
            int(near.sum()))


def _box_like(name, got, want):
    """Boxes of the kernels against the plain version's: equal values, NaN
    at the same places; -0 and +0 may differ, as torch's reductions' order
    picks them (ROADMAP C20), and only comparisons read them. Returns the
    number of zero-sign differences."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: shape or dtype differ")
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    if not torch.equal(nan_g, nan_w) or not bool(((got == want) | nan_w).all()):
        raise AssertionError(f"{name}: {int(((got != want) & ~nan_w).sum())} values differ")
    return int((got.view(torch.int32) != want.view(torch.int32))[~nan_w].sum())


def broadphase_outputs(spheres, rays, tile, max_qs, plain):
    """E6's outputs at one tile size: {name: tensor}. The boxes at both
    granularities, the segment words, the quarter words with their summary,
    the segments x tiles words with their summary (overlap_words_reference
    for the plain versions),
    quarter_lists and the compaction of the quarter words at each of
    ``max_qs`` (the first, 512, also quarter_lists' max_q), dense_tile_segments
    (2,048) and dense_segment_tiles (2,048), through the wrappers (the
    kernels of csrc/broadphase.cu on CUDA tensors) or with ``plain`` the
    plain versions on the same tensors."""
    from grace_tpu_torch.trace import broadphase as bp
    from grace_tpu_torch.trace import pallas_broadphase as pb
    from grace_tpu_torch.trace import pallas_render as pr

    if plain:
        tmin, tmax = bp._tile_aabbs_plain(rays, tile)
        seg = {b: pb._segment_aabbs_plain(spheres, b) for b in (32, 128)}
        words = pb._masks_for_tile_aabbs_plain(tmin, tmax, spheres)
        q_words, q_summary = pb._dense_tile_masks_quarter_plain(rays, spheres, tile)
        compact = pb._compact_mask_words_plain
        q_lists = pb._quarter_lists_plain(rays, spheres, tile, max_qs[0])
        s_lists = pb._dense_tile_segments_plain(rays, spheres, tile, 2048)
        t_lists = pr._dense_segment_tiles_plain(rays, spheres, tile, 2048)
        st_words = overlap_words_reference(*seg[128], tmin, tmax)
    else:
        tmin, tmax = bp.tile_aabbs(rays, tile)
        seg = {b: pb.segment_aabbs(spheres, b) for b in (32, 128)}
        words = pb.masks_for_tile_aabbs(tmin, tmax, spheres)
        q_words, q_summary = pb.dense_tile_masks_quarter(rays, spheres, tile)
        compact = pb.compact_mask_words
        q_lists = pb.quarter_lists(rays, spheres, tile, max_qs[0])
        s_lists = pb.dense_tile_segments(rays, spheres, tile, 2048)
        t_lists = pr.dense_segment_tiles(rays, spheres, tile, 2048)
        st_words = pb.overlap_words_cuda(*seg[128], tmin, tmax, summary=True)
    out = {"tile box min": tmin, "tile box max": tmax,
           "segment words": words, "quarter words": q_words, "quarter summary": q_summary,
           "segment-tile words": st_words[0], "segment-tile summary": st_words[1]}
    for b, (lo, hi) in seg.items():
        out[f"segment box min ({b})"], out[f"segment box max ({b})"] = lo, hi
    for what, lists in (("quarter_lists", q_lists), ("dense_tile_segments", s_lists),
                        ("dense_segment_tiles", t_lists)):
        for name, x in zip(("ids", "n", "overflow"), lists):
            out[f"{what} {name}"] = x
    for q in max_qs:
        for name, x in zip(("ids", "n", "overflow"), compact(q_words, q)):
            out[f"compact (max_q {q}) {name}"] = x
    return out


def compaction_limits(q_words):
    """Row capacities for these quarter words: quarter_lists' default 512,
    then the compaction's limits: the longest row's count (max_q equal to
    it), one less (that row overflows), 1 and 0."""
    from grace_tpu_torch.trace.pallas_broadphase import _popcount32

    most = int(_popcount32(q_words).sum(dim=1).max()) if q_words.numel() else 0
    return tuple(dict.fromkeys((512, most, max(most - 1, 0), 1, 0)))


# check_compaction's cases (grace_compact_words): tag -> (rows, words a
# row, max_q, density, offset). density: the share of set bits, "full"
# (every bit), "at" (rows whose counts are max_q - 1, max_q and max_q + 1,
# the others random); offset: the words start that many ints into a larger
# tensor (off a 16-byte boundary: the 4-byte loads), as do rows of a width
# that is no multiple of 4. A max_q that is no multiple of 4 starts the
# rows of ids anywhere in a 16-byte line (unaligned heads and tails).
COMPACT_SEED = 2034
COMPACT_CASES = {
    "41 rows x 256 words, max_q 2048": (41, 256, 2048, 0.02, 0),
    "every bit, 9 rows x 20 words, max_q 640 (each row exactly full)": (9, 20, 640, "full", 0),
    "every bit, max_q 639 (each row overflows by one)": (9, 20, 639, "full", 0),
    "every bit, max_q 641": (9, 20, 641, "full", 0),
    "counts at max_q - 1, max_q, max_q + 1, max_q 101": (12, 64, 101, "at", 0),
    "counts at max_q +- 1, max_q 128 (aligned rows)": (12, 64, 128, "at", 0),
    "max_q 0": (10, 64, 0, 0.1, 0),
    "no words": (10, 0, 13, 0.0, 0),
    "no rows": (0, 64, 512, 0.1, 0),
    "37 words a row (4-byte loads), max_q 361": (21, 37, 361, 0.3, 0),
    "words off a 16-byte boundary, max_q 514": (17, 128, 514, 0.05, 1),
    "half the bits, 6 x 1,024 words, max_q 4,099 (overflows)": (6, 1024, 4099, 0.5, 0),
    "one word a row, max_q 3": (33, 1, 3, 0.5, 0),
    "2,050 rows x 5 words, max_q 7 (a ragged last block)": (2050, 5, 7, 0.03, 0),
    "300 rows x 1,024 words, max_q 512 (sparse)": (300, 1024, 512, 0.003, 0),
}


def compact_scene(tag):
    """Case ``tag``'s words: (flat i32[offset + rows * words], offset)."""
    rows, n_words, max_q, density, offset = COMPACT_CASES[tag]
    rng = np.random.default_rng(COMPACT_SEED + list(COMPACT_CASES).index(tag))
    if density == "full":
        bits = np.ones((rows, n_words * 32), bool)
    elif density == "at":
        bits = rng.random((rows, n_words * 32)) < 0.3
        for r, count in enumerate((max_q - 1, max_q, max_q + 1) * (rows // 3)):
            bits[r] = False
            bits[r, rng.choice(n_words * 32, count, replace=False)] = True
    else:
        bits = rng.random((rows, n_words * 32)) < density
    words = (bits.reshape(rows, n_words, 32).astype(np.uint64)
             << np.arange(32, dtype=np.uint64)).sum(axis=2).astype(np.uint32).view(np.int32)
    flat = np.concatenate([rng.integers(-9, 9, offset).astype(np.int32), words.reshape(-1)])
    return flat, offset


def compact_inputs(tag, dev):
    """Case ``tag``'s words i32[rows, words] on ``dev`` (a view ``offset``
    ints into its storage) and max_q."""
    rows, n_words, max_q, _, _ = COMPACT_CASES[tag]
    flat, offset = compact_scene(tag)
    return torch.from_numpy(flat).to(dev)[offset:].view(rows, n_words), max_q


def check_compaction(dev, shapes=None, tags=tuple(COMPACT_CASES)):
    """grace_compact_words against the plain version on the card, ids, n
    and flags bit for bit, at the cases ``tags`` of COMPACT_CASES and at
    ``shapes`` ({label: (words, max_q)}: the main paths'). Returns its
    lines."""
    from grace_tpu_torch.trace import pallas_broadphase as pb

    cases = {tag: compact_inputs(tag, dev) for tag in tags}
    cases.update(shapes or {})
    lines = []
    for tag, (words, max_q) in cases.items():
        got = pb.compact_words_cuda(words, max_q)
        want = pb._compact_mask_words_plain(words, max_q)
        for name, g, w in zip(("ids", "n", "overflow"), got, want):
            check_tensor_bits(f"compaction {tag} {name}", g, w)
        lines.append(f"{tag}: words {tuple(words.shape)}, max_q {max_q}: ids, n and overflow "
                     f"bit-equal to the plain version ({int(want[1].sum())} ids, "
                     f"{int(want[2].sum())} rows overflowed)")
    return lines


def compaction_shapes(spheres, rays):
    """The compaction's main-path inputs on the bench scene (sorted 2^20
    spheres, sorted 512^2 rays): {label: (words, max_q)}: path 2's qlist
    (quarter words at tile 128, max_q 2048), path 2's list rows and path
    3's dense_tile_segments (segment words at tile 128, 2048), path 3's
    dense_segment_tiles (8,192 segment rows of tile words, 2048) and the
    timing phase's case (quarter words at tile 64, max_q 512)."""
    from grace_tpu_torch.trace import pallas_broadphase as pb
    from grace_tpu_torch.trace import pallas_render as pr

    tiles = pb.tile_aabbs(rays, pr.BWD_TILE)
    segs = pb.segment_aabbs(spheres, 128)
    return {
        "path 2 qlist (quarter words, tile 128, max_q 2048)":
            (pb.dense_tile_masks_quarter(rays, spheres, TRACE_TILE)[0], 2048),
        "path 2 list, path 3 dense_tile_segments (segment words, tile 128, max_chunks 2048)":
            (pb.dense_tile_masks(rays, spheres, TRACE_TILE), 2048),
        "path 3 dense_segment_tiles (segment rows of tile words, max_tiles 2048)":
            (pb.overlap_words_cuda(*segs, *tiles), 2048),
        "quarter words, tile 64, max_q 512": (pb.dense_tile_masks_quarter(rays, spheres, 64)[0],
                                               512)}


def check_broadphase_case(tag, spheres, rays, tile):
    """csrc/broadphase.cu against the plain versions on the same tensors:
    boxes equal in value (zero signs free), every word, summary word, list,
    count and flag bit-equal. Returns ({output: max abs err}, the zero-sign
    differences in the boxes, the capacities and the most listed quarters
    and segments a row)."""
    from grace_tpu_torch.trace import pallas_broadphase as pb

    q_words, _ = pb._dense_tile_masks_quarter_plain(rays, spheres, tile)
    max_qs = compaction_limits(q_words)
    got = broadphase_outputs(spheres, rays, tile, max_qs, plain=False)
    want = broadphase_outputs(spheres, rays, tile, max_qs, plain=True)
    errs, signs = {}, 0
    for name, w in want.items():
        g = got[name]
        if "box" in name:
            signs += _box_like(f"{tag} {name}", g, w)
        else:
            check_tensor_bits(f"{tag} {name}", g, w)
        errs[name] = 0.0
    most_s = int(want["dense_tile_segments n"].max()) if want["dense_tile_segments n"].numel() else 0
    return errs, signs, max_qs, most_s


def check_broadphase(dev, bench=None):
    """The check_broadphase phase: every case of BROADPHASE_CASES and, with
    ``bench`` = (sorted spheres, sorted rays), the bench scene at tiles 128
    and 64. Returns its lines."""
    from grace_tpu_torch.core.types import Rays

    cases = []
    for tag, (_, _, tile, _) in BROADPHASE_CASES.items():
        s, o, d, ln = broadphase_scene(tag)
        rays = Rays.from_arrays(o, d, ln, device=dev)
        cases.append((tag, torch.from_numpy(s).to(dev), rays, tile))
    if bench is not None:
        for tile in (TRACE_TILE, 64):
            cases.append((f"bench scene, tile {tile}", bench[0], bench[1], tile))
    lines = []
    for tag, spheres, rays, tile in cases:
        _, signs, max_qs, most_s = check_broadphase_case(tag, spheres, rays, tile)
        lines.append(f"{tag}: boxes equal ({signs} zero signs apart), segment, quarter and "
                     f"segments x tiles words and summaries, quarter_lists, "
                     f"dense_tile_segments, dense_segment_tiles and the compaction at max_q "
                     f"{list(max_qs)} bit-equal to the plain versions (most listed segments a "
                     f"tile {most_s})")
    lines += check_box_sets(dev)
    lines += check_overlap_boxes(dev)
    lines += check_compaction(dev)
    return lines


def check_overlap_boxes(dev):
    """overlap_words_cuda against overlap_words_reference at every case of
    OVERLAP_BOX_CASES, with the summary on and off: words and summary
    words bit-equal. Returns its lines."""
    from grace_tpu_torch.trace import pallas_broadphase as pb

    lines = []
    for tag in OVERLAP_BOX_CASES:
        boxes = [torch.from_numpy(b).to(dev) for b in overlap_box_scene(tag)]
        want = overlap_words_reference(*boxes)
        check_tensor_bits(f"{tag} words", pb.overlap_words_cuda(*boxes), want[0])
        got = pb.overlap_words_cuda(*boxes, summary=True)
        for name, g, w in zip(("words", "summary"), got, want):
            check_tensor_bits(f"{tag} {name} (summary on)", g, w)
        lines.append(f"overlap boxes {tag}: words (summary off and on) and summary words "
                     f"bit-equal to overlap_words_reference")
    return lines


def bench_word_counts(spheres, rays):
    """overlap_word_counts on the bench scene: tiles 64 and 128 against
    quarters and segments, and segments against tiles (dense_segment_tiles'
    orientation). Returns its lines."""
    from grace_tpu_torch.trace import broadphase as bp
    from grace_tpu_torch.trace import pallas_broadphase as pb

    lines = []
    seg = {b: pb.segment_aabbs(spheres, b) for b in (32, 128)}
    for tile in (64, TRACE_TILE):
        tiles = bp.tile_aabbs(rays, tile)
        for rows, cols, what in ((tiles, seg[32], f"tile {tile} x quarters"),
                                 (tiles, seg[128], f"tile {tile} x segments of 128"),
                                 (seg[128], tiles, f"segments of 128 x tile {tile}")):
            words = pb.overlap_words_cuda(*rows, *cols)
            pairs, bits, nonzero, near = overlap_word_counts(*rows, *cols, words)
            lines.append(f"overlap words on the bench scene, {what} ({rows[0].shape[0]} x "
                         f"{cols[0].shape[0]}, {words.shape[1]} words a row): {pairs} pairs, "
                         f"{bits} set bits ({bits / max(pairs, 1):.2%}), {nonzero} nonzero words "
                         f"({nonzero / max(words.numel(), 1):.2%}), {near} candidate words "
                         f"({near / max(words.numel(), 1):.2%}; every nonzero word a candidate)")
    return lines


def broadphase_counters():
    """The broadphase kernels' launch counts (csrc/broadphase.cu) and the
    triangle lists' (csrc/tri_lists.cu)."""
    from grace_tpu_torch.trace import pallas_broadphase as pb
    from grace_tpu_torch.trace import pallas_tri as pt

    return {"broadphase_boxes": pb.broadphase_boxes_cuda.launches,
            "overlap_words": pb.overlap_words_cuda.launches,
            "compact_words": pb.compact_words_cuda.launches,
            "tri_tile_lists": pt.tri_tile_lists_cuda.launches}


# The broadphase kernels each main path runs: path 1's quarter trace, path
# 2's default, qlist and list routes, path 3's fused trainer (its lists both
# ways), path 4's record routes, path 5's triangle lists, path 6's two
# routes, path 7's sharded routes; path 8's walk runs none of them. The
# boxes are one launch for both sets.
BROADPHASE_BY_PATH = {1: ("broadphase_boxes", "overlap_words"),
                      2: ("broadphase_boxes", "overlap_words", "compact_words"),
                      3: ("broadphase_boxes", "overlap_words", "compact_words"),
                      4: ("broadphase_boxes", "overlap_words"),
                      5: ("tri_tile_lists",),
                      6: ("broadphase_boxes", "overlap_words"),
                      7: ("broadphase_boxes", "overlap_words"),
                      8: ()}


def gate_broadphase(path):
    """The broadphase counters after main path ``path``; raises if a kernel
    the path runs was launched no time."""
    counts = broadphase_counters()
    idle = [k for k in BROADPHASE_BY_PATH[path] if counts[k] < 1]
    if idle:
        raise AssertionError(f"main path {path}: broadphase kernels {idle} never launched: "
                             f"{counts}")
    return counts


def zero_broadphase_counters():
    from grace_tpu_torch.trace import pallas_broadphase as pb
    from grace_tpu_torch.trace import pallas_tri as pt

    for fn in (pb.broadphase_boxes_cuda, pb.overlap_words_cuda, pb.compact_words_cuda,
               pt.tri_tile_lists_cuda):
        fn.launches = 0


# check_tri_lists' cases: tag -> (mesh, tiles, tile, max_chunks, intervals).
# "torus": the tests' 4,096-triangle torus under 64 x 48 pinhole rays;
# "random": 3,000 random triangles (a ragged last segment) and rays from
# inside the box; "ragged": 12,000 (94 segments, slabs along x) and short
# rays from inside (rows whose BIG group spans three words around the
# listed segments and passes keep = 94, inside a 16-byte vector; 37 tiles,
# no multiple of a block's warps); "misses": a
# tile of rays that miss the box (clipped to 0 length), one of zero-length
# rays by an isolated segment, one of rays that reach every segment;
# "extreme": directions of 1e-12 and lengths of 2 BIG, so that one
# segment's key is exactly BIG and another's past it, and a tile with an
# origin at +inf whose infinite segment's key is NaN (not clipped); "big":
# 11,719 segments (1.5M triangles), past the staged boxes and the warp's
# buffer. TRI_LIST_FORCED: the kernel's private limits a case sets
# (tri_tile_lists_cuda's _warp_buf and _stage), the routes past the warp's
# buffer (the device scratch's sort) and past the staged boxes (boxes read
# from device memory) at a small size.
TRI_LIST_SEED = 2029
TRI_LIST_CASES = {
    "torus 64 x 32 (4,096 triangles), 96 tiles of 32 pinhole rays, max_chunks 2048":
        ("torus", 96, 32, 2048, 16),
    "torus, max_chunks 4 (overflow)": ("torus", 96, 32, 4, 16),
    "random mesh of 3,000 (a ragged last segment), 64 tiles of 8, K 8, max_chunks 12":
        ("random", 64, 8, 12, 8),
    "misses: tiles of clipped and zero-length rays, n_segs 0, 1 and all, max_chunks 64":
        ("misses", 24, 8, 64, 16),
    "keys at and past BIG and a NaN key (far and infinite segments), max_chunks 4":
        ("extreme", 2, 8, 4, 16),
    "random mesh of 1,500,032 (11,719 segments: the device-memory sort), 16 wide tiles of 8":
        ("big", 16, 8, 4224, 16),
    "torus, max_chunks 50 (rows of 4-byte stores: 32 segments, then pads)":
        ("torus", 96, 32, 50, 16),
    "random mesh of 12,000 (94 segments, slabs along x), 37 tiles of 32, max_chunks 96":
        ("ragged", 37, 32, 96, 16),
    "torus, max_chunks 2048, a warp's buffer of 4 entries (the device scratch's sort)":
        ("torus", 96, 32, 2048, 16),
    "torus, max_chunks 2048, boxes staged up to 16 segments (its 32 from device memory)":
        ("torus", 96, 32, 2048, 16),
}
TRI_LIST_FORCED = {
    "torus, max_chunks 2048, a warp's buffer of 4 entries (the device scratch's sort)":
        {"_warp_buf": 4},
    "torus, max_chunks 2048, boxes staged up to 16 segments (its 32 from device memory)":
        {"_stage": 16},
}


def tri_list_scene(tag):
    """(triangles f32[T, 3, 3], origins f32[R, 3], directions f32[R, 3],
    lengths f32[R], clip) of check_tri_lists' case ``tag`` as numpy arrays;
    ``clip``: clip the rays to the mesh box first, as pallas_trace_tri
    does."""
    mesh, n_tiles, tile, _, _ = TRI_LIST_CASES[tag]
    rng = np.random.default_rng(TRI_LIST_SEED + list(TRI_LIST_CASES).index(tag))
    r = n_tiles * tile
    f32 = lambda a: np.asarray(a, np.float32)
    if mesh == "torus":
        tris = torus_mesh()
        h, w = r // 64, 64
        yy, xx = np.meshgrid((np.arange(h) + 0.5) / h - 0.5, (np.arange(w) + 0.5) / w - 0.5,
                             indexing="ij")
        d = np.stack([1.6 * xx, 1.2 * yy, -np.ones_like(xx)], -1).reshape(-1, 3)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o = np.tile([0.1, 0.2, 3.0], (r, 1))
        return tris, f32(o), f32(d), f32(np.full(r, 6.0)), True
    if mesh in ("random", "ragged", "big"):
        count, length = {"random": (3000, 0.6), "ragged": (12000, 0.1),
                         "big": (11719 * 128, 5.0)}[mesh]
        tris = random_mesh(rng, count)
        if mesh == "ragged":   # segments as slabs along x: short rays list a few
            tris = tris[np.argsort(tris[:, :, 0].mean(axis=1), kind="stable")]
        o = rng.random((r, 3)) * 0.4 + 0.3
        d = rng.standard_normal((r, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return tris, f32(o), f32(d), f32(np.full(r, length)), True
    if mesh == "misses":
        # 23 full segments in the unit box, then a last segment by (5, 5, 5)
        tris = np.concatenate([random_mesh(rng, 2944),
                               f32(5.0 + 0.05 * rng.standard_normal((56, 3, 3)))])
        o = rng.random((r, 3)) * 0.4 + 0.3
        d = rng.standard_normal((r, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        ln = np.full(r, 0.3)
        o[:tile], d[:tile] = (-3.0, -3.0, -3.0), (-1.0, 0.0, 0.0)   # misses: length 0
        o[tile:2 * tile], ln[tile:2 * tile] = 5.0, 0.0               # only the last segment
        o[2 * tile:3 * tile], ln[2 * tile:3 * tile] = 0.5, 20.0     # every segment
        d[2 * tile:3 * tile:2] = np.sqrt(1 / 3)
        o[3 * tile:4 * tile:2] = (-3.0, -3.0, -3.0)                  # half the tile misses
        d[3 * tile:4 * tile:2] = (-1.0, 0.0, 0.0)
        return f32(tris), f32(o), f32(d), f32(ln), True
    # extreme: a near segment, one whose key is BIG, one past BIG, an infinite one
    near = random_mesh(rng, 128) * 0.5 + 0.25
    far = lambda x: np.concatenate([x + 1e16 * rng.random((128, 3, 1)),
                                    rng.random((128, 3, 2))], axis=-1)
    inf = np.concatenate([np.full((128, 3, 1), np.inf), rng.random((128, 3, 2))], axis=-1)
    tris = f32(np.concatenate([near, far(1.01e18), far(1.51e18), inf]))
    o = np.concatenate([np.c_[np.zeros(tile), rng.uniform(0.2, 0.8, (tile, 2))],
                        np.c_[np.full(tile, np.inf), rng.uniform(0.2, 0.8, (tile, 2))]])
    d = np.tile([1e-12, 0.0, 0.0], (r, 1))
    ln = np.concatenate([np.full(tile, f32(1e30) * f32(2)), np.ones(tile)])
    return tris, f32(o), f32(d), f32(ln), False


def tri_list_inputs(tag, dev):
    """(rays, triangles) of case ``tag`` on ``dev``, clipped where the case
    says."""
    from grace_tpu_torch.core.types import Rays
    from grace_tpu_torch.trace import pallas_tri as pt

    tris, o, d, ln, clip = tri_list_scene(tag)
    rays = Rays.from_arrays(o, d, ln, device=dev)
    tris = torch.from_numpy(tris).to(dev)
    if clip:
        flat = tris.reshape(-1, 3)
        rays = pt.clip_rays_to_aabb(rays, flat.amin(dim=0), flat.amax(dim=0))
    return rays, tris


def check_tri_lists_case(tag, rays, tris, tile, max_chunks, n_intervals=16):
    """csrc/tri_lists.cu against _dense_tile_segments_tri_plain on the same
    tensors (with the case's TRI_LIST_FORCED limits, through
    tri_tile_lists_cuda): ids, counts and flags bit-equal, distances
    bit-equal (NaN where the plain version's are). Returns (n_segs a tile,
    overflow)."""
    from grace_tpu_torch.trace import pallas_tri as pt

    forced = TRI_LIST_FORCED.get(tag)
    if forced:
        got = pt.tri_tile_lists_cuda(rays, *pt.tri_segment_aabbs(tris), tile, max_chunks,
                                     n_intervals, **forced)
    else:
        got = pt._dense_tile_segments_tri(rays, tris, tile, max_chunks, n_intervals)
    want = pt._dense_tile_segments_tri_plain(rays, tris, tile, max_chunks, n_intervals)
    for name, g, w in zip(("seg_ids", "seg_dist", "n_segs", "overflow"), got, want):
        if name == "seg_dist":
            nan = torch.isnan(w)
            check_equal(f"{tag} {name} NaN", torch.isnan(g), nan)
            g, w = torch.where(nan, 0.0, g), torch.where(nan, 0.0, w)
        check_tensor_bits(f"{tag} {name}", g, w)
    return want[2], want[3]


def check_tri_lists(dev, torus_sets=None, edge_cases=True):
    """The check_tri_lists phase: every case of TRI_LIST_CASES (with
    ``edge_cases``) and, with ``torus_sets`` = (sorted triangles, {name:
    clipped rays}), main path 5's primary and shadow rays at max_chunks
    2048 and 16. Returns its lines."""
    cases = [(tag, *tri_list_inputs(tag, dev), tile, max_chunks, k)
             for tag, (_, _, tile, max_chunks, k) in TRI_LIST_CASES.items() if edge_cases]
    if torus_sets is not None:
        tris, sets = torus_sets
        cases += [(f"path 5 torus {name} rays, max_chunks {mc}", rays, tris, 32, mc, 16)
                  for name, rays in sets.items() for mc in (2048, 16)]
    lines = []
    for tag, rays, tris, tile, max_chunks, k in cases:
        n, ovf = check_tri_lists_case(tag, rays, tris, tile, max_chunks, k)
        lines.append(f"{tag}: seg_ids, seg_dist, n_segs and overflow bit-equal to the plain "
                     f"version (n_segs {int(n.min())} to {int(n.max())}, {int(ovf.sum())} "
                     f"tiles overflow)")
    return lines


def tri_list_tests(rays, tris, tile, n_intervals=16, block=512):
    """(box tests, listed segments, listed segments a tile i64[tiles], the
    union test's passes) of the triangle lists on these rays: a segment
    that passes the intervals' union is tested against intervals
    0..kfirst (all K where it is not listed), the plain version's overlap
    in blocks of ``block`` tiles."""
    from grace_tpu_torch.ops.vecmath import fma
    from grace_tpu_torch.trace import pallas_tri as pt

    seg_min, seg_max = pt.tri_segment_aabbs(tris)
    K = n_intervals
    n_tiles = rays.n_rays // tile
    o = rays.origins.reshape(n_tiles, tile, 3)
    d = rays.directions.reshape(n_tiles, tile, 3)
    ln = torch.clamp(rays.lengths, min=0.0).reshape(n_tiles, tile)
    frac = torch.arange(K + 1, dtype=torch.float32, device=o.device) / K
    tests = listed = near = 0
    per_tile = []
    for a0 in range(0, n_tiles, block):
        sl = slice(a0, a0 + block)
        pts = fma(d[sl][:, :, None, :], (ln[sl][:, :, None] * frac)[..., None],
                  o[sl][:, :, None, :])
        bmin, bmax = pts.amin(dim=1), pts.amax(dim=1)
        imin = torch.minimum(bmin[:, :-1], bmin[:, 1:])
        imax = torch.maximum(bmax[:, :-1], bmax[:, 1:])
        ov = ((imin[:, :, None, :] <= seg_max[None, None]) &
              (seg_min[None, None] <= imax[:, :, None, :])).all(dim=-1)
        k_ids = torch.arange(K, device=o.device)[None, :, None]
        kfirst = torch.where(ov, k_ids, K).amin(dim=1)
        # the union without NaN bounds (fminf / fmaxf over the intervals)
        umin = torch.where(torch.isnan(imin), float("inf"), imin).amin(dim=1)
        umax = torch.where(torch.isnan(imax), float("-inf"), imax).amax(dim=1)
        union = ((umin[:, None, :] <= seg_max[None]) & (seg_min[None] <= umax[:, None, :])).all(-1)
        tests += int(torch.where(kfirst < K, kfirst + 1, K)[union].sum()) + union.numel()
        near += int(union.sum())
        per_tile.append((kfirst < K).sum(dim=1))
        listed += int(per_tile[-1].sum())
    return tests, listed, torch.cat(per_tile), near


def broadphase_times(spheres, rays, tris, tri_sets):
    """E6's and E7's times (CUDA events, warm median, ms) on the main paths'
    inputs: the boxes at path 1's quarter trace (quarters and tile 128;
    both parts in one launch and each alone, with their device times by
    the profiler), each other broadphase kernel alone and its plain version
    at the records' quarter granularity (tile 64), the public calls of both routes
    at tile 64 and 128, and the triangle lists of path 5's primary and
    shadow rays (the wrapper's call, its kernel's device time, the call
    with its two box reductions, the plain version, and torch's stable sort
    of the same keys: the one PyTorch call that does the list's sort).
    Returns (times, {kernel: (operations, bytes)}: each input read once,
    each output written once, lines: the lists' device operations a call
    and what they list a tile)."""
    from grace_tpu_torch.trace import broadphase as bp
    from grace_tpu_torch.trace import pallas_broadphase as pb
    from grace_tpu_torch.trace import pallas_render as pr
    from grace_tpu_torch.trace import pallas_tri as pt

    tile = 64
    tmin, tmax = bp.tile_aabbs(rays, tile)
    seg_q = pb.segment_aabbs(spheres, 32)
    words, summ = pb.overlap_words_cuda(tmin, tmax, *seg_q, summary=True)
    ids, n, ovf = pb.compact_words_cuda(words, 512)
    t = {}
    tiles_128 = bp.tile_aabbs(rays, TRACE_TILE)
    for label, fn, plain in (
            ("quarters and tile 128", lambda: pb.broadphase_boxes_cuda(rays, TRACE_TILE, spheres, 32),
             lambda: (bp._tile_aabbs_plain(rays, TRACE_TILE), pb._segment_aabbs_plain(spheres, 32))),
            ("segment part, quarters", lambda: pb.segment_aabbs(spheres, 32),
             lambda: pb._segment_aabbs_plain(spheres, 32)),
            ("tile part, tile 128", lambda: bp.tile_aabbs(rays, TRACE_TILE),
             lambda: bp._tile_aabbs_plain(rays, TRACE_TILE))):
        t[f"broadphase_boxes kernel ({label})"] = cuda_ms(fn)
        # (the profiler drops some windows' device events in this phase: the
        # mean of the launches it saw)
        ms, seen = kernel_device_ms_seen(fn, "boxes_kernel")
        device = f"broadphase_boxes device (profiler; the kernel alone, {label})"
        if ms is None:
            log(f"time {device}: not measured (the profiler saw no device time of the kernel)")
        else:
            t[device] = ms
            log(f"{device}: the mean of {seen} launches the profiler saw")
        t[f"broadphase_boxes plain ({label})"] = cuda_ms(plain)
    t["overlap_words kernel (quarter words and summary, tile 64)"] = cuda_ms(
        lambda: pb.overlap_words_cuda(tmin, tmax, *seg_q, summary=True))
    log_device_ms(t, "overlap_words device (profiler; the kernel alone, quarter words and "
                  "summary, tile 64)",
                  lambda: pb.overlap_words_cuda(tmin, tmax, *seg_q, summary=True),
                  "overlap_words_kernel")
    t["overlap_words plain (quarter words and summary, tile 64; with its segment boxes)"] = \
        cuda_ms(lambda: pb.pack_overlap_bits(
            pb._masks_for_tile_aabbs_plain(tmin, tmax, spheres, block=32) != 0), reps=3)
    t["compact_words kernel (quarter words, max_q 512, tile 64)"] = cuda_ms(
        lambda: pb.compact_words_cuda(words, 512))
    t["compact_words plain (quarter words, max_q 512, tile 64)"] = cuda_ms(
        lambda: pb._compact_mask_words_plain(words, 512), reps=3)
    # the compaction at each main-path shape: the call and the kernel's
    # device time (the mean of the launches the profiler's windows saw)
    shape_work = {}
    for label, (w, q) in compaction_shapes(spheres, rays).items():
        fn = lambda w=w, q=q: pb.compact_words_cuda(w, q)
        t[f"compact_words kernel ({label})"] = cuda_ms(fn)
        ms, seen = kernel_device_ms_seen(fn, "compact_words_kernel")
        device = f"compact_words device (profiler; the kernel alone, {label})"
        if ms is None:
            log(f"time {device}: not measured (the profiler saw no device time of the kernel)")
        else:
            t[device] = ms
            log(f"{device}: the mean of {seen} launches the profiler saw")
        out = fn()
        shape_work[f"compact_words ({label})"] = (3 * w.numel() + 2 * int(out[1].sum()),
                                                  nbytes(w, *out))
    for tl in (64, TRACE_TILE):
        t[f"dense_tile_masks_quarter kernels (tile {tl})"] = cuda_ms(
            lambda: pb.dense_tile_masks_quarter(rays, spheres, tl))
        t[f"dense_tile_masks_quarter plain (tile {tl})"] = cuda_ms(
            lambda: pb._dense_tile_masks_quarter_plain(rays, spheres, tl), reps=3)
        t[f"dense_tile_masks kernels (tile {tl})"] = cuda_ms(
            lambda: pb.dense_tile_masks(rays, spheres, tl))
        t[f"dense_tile_masks plain (tile {tl})"] = cuda_ms(
            lambda: pb._dense_tile_masks_plain(rays, spheres, tl), reps=3)
        t[f"quarter_lists kernels (tile {tl}, max_q 512)"] = cuda_ms(
            lambda: pb.quarter_lists(rays, spheres, tl, 512))
        t[f"quarter_lists plain (tile {tl}, max_q 512)"] = cuda_ms(
            lambda: pb._quarter_lists_plain(rays, spheres, tl, 512), reps=3)
    t["dense_tile_segments kernels (tile 128, max_chunks 2048)"] = cuda_ms(
        lambda: pb.dense_tile_segments(rays, spheres, TRACE_TILE, 2048))
    t["dense_tile_segments plain (tile 128, max_chunks 2048)"] = cuda_ms(
        lambda: pb._dense_tile_segments_plain(rays, spheres, TRACE_TILE, 2048), reps=3)
    t["dense_segment_tiles kernels (tile 128, max_tiles 2048)"] = cuda_ms(
        lambda: pr.dense_segment_tiles(rays, spheres, pr.BWD_TILE, 2048))
    t["dense_segment_tiles plain (tile 128, max_tiles 2048)"] = cuda_ms(
        lambda: pr._dense_segment_tiles_plain(rays, spheres, pr.BWD_TILE, 2048), reps=3)
    r = rays.n_rays
    n_rows, n_cols = tmin.shape[0], seg_q[0].shape[0]
    set_bits = int(n.sum())
    # the overlap words' work: a hull test a (row, word) and the fine test
    # on the candidate words' columns (6 compares each); the earlier design
    # tested every (row, column) pair
    candidates = overlap_word_counts(tmin, tmax, *seg_q, words)[3]
    # the boxes' work: c - r and c + r and 6 folds a sphere; 3 f64
    # products and sums and 12 folds a ray
    seg_work = (12 * spheres.shape[0], nbytes(spheres, *seg_q))
    tile_work = (18 * r, nbytes(rays.origins, rays.directions, rays.lengths, *tiles_128))
    work = {
        "broadphase_boxes": (seg_work[0] + tile_work[0], seg_work[1] + tile_work[1]),
        "broadphase_boxes (segment part)": seg_work,
        "broadphase_boxes (tile part)": tile_work,
        "overlap_words": (6 * n_rows * words.shape[1] + 6 * 32 * candidates,
                          nbytes(tmin, tmax, *seg_q, words, summ)),
        "overlap_words (all pairs)": (6 * n_rows * n_cols, nbytes(tmin, tmax, *seg_q, words, summ)),
        "compact_words": (3 * words.numel() + 2 * set_bits, nbytes(words, ids, n, ovf)),
        **shape_work,
    }
    seg_min, seg_max = pt.tri_segment_aabbs(tris)
    lines = []
    for name, tri_rays in tri_sets.items():
        out = pt.tri_tile_lists_cuda(tri_rays, seg_min, seg_max, 32, 2048)
        lists = lambda: pt.tri_tile_lists_cuda(tri_rays, seg_min, seg_max, 32, 2048)
        t[f"tri_tile_lists kernel (torus {name})"] = cuda_ms(lists)
        # (the profiler drops some windows' device events in this phase: the
        # launches it saw, and the longest operation list of three)
        ms, seen = kernel_device_ms_seen(lists, "tri_lists_kernel")
        label = f"tri_tile_lists device (profiler; the kernel alone, torus {name})"
        if ms is None:
            log(f"time {label}: not measured (the profiler saw no device time of the kernel)")
        else:
            t[label] = ms
            lines.append(f"{label}: the mean of {seen} launches the profiler saw")
        ops = max((device_ops(lists) for _ in range(3)), key=len)
        lines.append(f"tri_tile_lists (torus {name}): {len(ops)} device operations a call "
                     f"({', '.join(n[:48] for n in ops)})")
        t[f"_dense_tile_segments_tri (torus {name})"] = cuda_ms(
            lambda: pt._dense_tile_segments_tri(tri_rays, tris, 32, 2048))
        t[f"_dense_tile_segments_tri plain (torus {name})"] = cuda_ms(
            lambda: pt._dense_tile_segments_tri_plain(tri_rays, tris, 32, 2048), reps=3)
        if out[0].shape[1] == seg_min.shape[0]:
            # every column written: the keys are the rows' distances put
            # back at their ids
            keys = torch.empty_like(out[1]).scatter_(1, out[0].long(), out[1])
            t[f"tri lists' key sort (torch.sort, stable; torus {name})"] = cuda_ms(
                lambda: torch.sort(keys, dim=1, stable=True))
        tests, listed, per_tile, near = tri_list_tests(tri_rays, tris, 32)
        lines.append(f"tri_tile_lists (torus {name}): {per_tile.shape[0]} tiles of 32, "
                     f"{seg_min.shape[0]} segments; listed a tile mean "
                     f"{float(per_tile.double().mean()):.2f}, max {int(per_tile.max())}, "
                     f"{int((per_tile == 0).sum())} tiles list none; {near} pass the union "
                     f"test ({near / per_tile.shape[0]:.1f} a tile), {tests} box tests")
        # the bytes: the rays, the boxes and frac read once, the four
        # outputs written once (the kernel reads the boxes once a block)
        work[f"tri_tile_lists {name}"] = (
            6 * tests + 30 * listed,
            nbytes(tri_rays.origins, tri_rays.directions, tri_rays.lengths, seg_min, seg_max,
                   *out) + 4 * (pt.N_CULL_INTERVALS + 1))
    return t, work, lines


# check_segsort's cases (csrc/segsort.cu). Keys with every special value
# of the order (SPECIAL_BITS: +0, -0, +inf, -inf, NaN of both signs and a
# payload NaN, subnormals, which tie with zero (ROADMAP C24), and the
# smallest normals, which do not) and many exact ties; record rows
# with sentinel slots in the middle and at the tail, real +inf distances,
# rows that overflowed, rows whose record prefix is in order already; CSR
# offsets repeated, unordered, negative, past H and near 2^31, total_hits
# 0, inside and past H; runs that are in order already or all but (the
# kernels copy a run in order), keys that tie only in the order, the
# lengths around each power of two a warp sorts.
SEGSORT_SEED = 2030
SPECIAL_BITS = np.array([0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000,
                         0xFFC00000, 0x7F800001, 0x00000001, 0x80000001, 0x007FFFFF,
                         0x00800000, 0x80800000],
                         np.uint32).view(np.float32)
# keys that tie only in the order: +0, -0 and subnormals of both signs
# (all +0 there), then NaNs of other signs and payloads (all one NaN)
TIE_BITS = np.array([0x00000000, 0x80000000, 0x00000001, 0x80000001, 0x007FFFFF, 0x807FFFFF,
                     0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFFFFFFF, 0x7FFFFFFF], np.uint32)
# rows: tag -> (kind, rows, width). "edges": special keys, ties, sentinel
# slots anywhere; "records": rows as the record kernels write them (the
# first min(count, width) slots hold records, the rest the sentinels),
# counts up to 1.5 width (rows that overflowed); "sorted": "records" rows
# whose records are in order (in a quarter of the rows the last record a
# NaN, in a quarter ties to 0 at the start, in a quarter the last pair
# swapped).
SEGSORT_ROW_CASES = {
    "edges: ties, sentinel slots mid-row, +-inf, NaNs of both signs, -0 and +0; 256 rows of 128":
        ("edges", 256, 128),
    "records as the kernels write them, 512 wide, counts to 768 (overflowed rows)":
        ("records", 300, 512),
    "edges, 384 wide (no power of two)": ("edges", 96, 384),
    "edges, 1,024 wide (32 a lane)": ("edges", 40, 1024),
    "edges, 2,048 wide (past a warp: chunks of 1,024 merged)": ("edges", 24, 2048),
    "records whose prefix is in order already (some ending in NaNs, some with ties, some "
    "with one pair swapped), 512 wide": ("sorted", 200, 512),
    "records of distances in [1, 2) with ties, as the bench's rows span (the packed network; "
    "spans at its limit and one past it), 512 wide": ("octave", 200, 512),
}
# flat layouts: tag -> (rows, width, capacity past the kept total (None:
# capacity 0; "mid-vector": the capacity ends inside a row's 16-byte body
# vector), sentinels or None, sentinel slots, rows, rows an E10 block
# scans (None: the wrapper's FLAT_ROWS)). Rows "records" as the record kernels
# write them; "ragged": counts of 0-5, width - 3 to width + 2 and random
# ones, so that rows of 0, 1-3 and all width records start at every
# destination word mod 4, every column of them random.
SEGSORT_FLAT_CASES = {
    "capacity the kept total": (300, 128, 0, None, False, "records", None),
    "capacity below the total (records dropped)": (300, 128, -5000, None, False, "records", None),
    "capacity past the total (a tail of sentinels)": (300, 128, 777, None, False, "records", None),
    "sentinel slots, sentinels (-7, 2.5, NaN), capacity below the total":
        (300, 128, -123, (-7, 2.5, float("nan")), True, "records", None),
    "sentinel slots, sentinels (3, -0.0, inf), capacity past the total":
        (257, 256, 1000, (3, -0.0, float("inf")), True, "records", None),
    "no rows, capacity 100": (0, 128, 100, None, False, "records", None),
    "one row of 512 that overflowed, capacity 0": (1, 512, None, None, False, "records", None),
    "ragged rows at every destination alignment, 512 wide, 7 rows a block (86 blocks' "
    "look-back)": (600, 512, 0, None, False, "ragged", 7),
    "ragged rows, 512 wide, sentinel slots, capacity past the total, 5 rows a block":
        (333, 512, 4099, (-2, 0.5, 7.0), True, "ragged", 5),
    "ragged rows, 130 wide (no multiple of 4: 4-byte copies), sentinel slots, 3 rows a block":
        (301, 130, 321, None, True, "ragged", 3),
    "ragged rows, 3 wide, capacity the total": (77, 3, 0, None, False, "ragged", None),
    "ragged rows, 1,100 wide (three chunks of a row)": (90, 1100, 9, None, False, "ragged", 32),
    "ragged rows, 512 wide, capacity ending inside a row's body vector":
        (500, 512, "mid-vector", None, False, "ragged", 19),
    "ragged rows, 512 wide, capacity 0 (offsets and counts only), 64 rows a block":
        (400, 512, None, None, True, "ragged", 64),
    "ragged rows, 4 wide, capacity below the total, sentinel slots":
        (1000, 4, -777, None, True, "ragged", None),
}
# CSR: tag -> (H, kind, total_hits, f32 and i32 data arrays). "edges":
# special keys; "rays": segments of ray-like lengths; "padded": rays'
# records then capacity padding (distance -1, index -1) past the kept
# total, as trace_sph writes it (its last ray's segment takes the padding;
# "padded_gap": the last ray has no records, so the padding is a segment
# of equal keys of its own); "swap", "last": segments in order but for one
# pair across a chunk boundary or for their last element; "ties": keys
# that tie only in the order (+-0, subnormals; NaNs of other bits);
# "descending"; "lengths": 1, 2, 31-33, 511-513 and 1,023-1,025. total_hits:
# None, an int, or "half" (H // 2), "past" (H + 100), "all" (H).
SEGSORT_CSR_CASES = {
    "edges; empty, repeated, unordered, negative, past-H and near-2^31 offsets; no total":
        (3000, "edges", None, (1, 1)),
    "edges, total_hits 0 (every entry in the pseudo-segment)": (3000, "edges", 0, (1, 0)),
    "edges, total_hits past H": (3000, "edges", "past", (0, 1)),
    "segments of up to 3,000 (past a warp's 1,024), total_hits inside":
        (20000, "long", "half", (1, 1)),
    "a trailing pseudo-segment of 1,200,000 entries, three data arrays":
        (1_300_000, "rays", 100_000, (2, 1)),
    "nine arrays (two launches of eight)": (5000, "rays", "half", (4, 3)),
    "one segment (offsets [0]), no total": (4000, "one", None, (0, 0)),
    "no offsets, total_hits inside (one segment: the pseudo-segment's id is 0)":
        (1000, "none", 400, (0, 0)),
    "about 60,000 padding entries of equal sentinel keys after the last ray's records, "
    "total_hits H (as trace_sph writes them)": (90_000, "padded", "all", (1, 0)),
    "the last ray without records: its segment about 60,000 sentinel keys, in order":
        (90_000, "padded_gap", "all", (1, 0)),
    "long segments in order but for one pair across a chunk boundary (1,023 and 1,024)":
        (6000, "swap", None, (1, 0)),
    "long segments in order but for their last element": (4000, "last", None, (0, 1)),
    "segments of keys that tie only in the order (+-0, subnormals; NaNs of other bits)":
        (8000, "ties", None, (1, 0)),
    "descending segments, short and long, with ties": (6000, "descending", "half", (0, 1)),
    "segment lengths 1, 2, 31-33, 511-513 and 1,023-1,025": (8000, "lengths", None, (1, 1)),
    "segments of distances in [1, 2) with ties, up to 1,024 long (the packed network; spans "
    "at its limit and one past it)": (30_000, "octave", "half", (1, 0)),
}


def _segsort_rng(cases, tag):
    salt = (SEGSORT_ROW_CASES, SEGSORT_FLAT_CASES, SEGSORT_CSR_CASES).index(cases)
    return np.random.default_rng([SEGSORT_SEED, salt, list(cases).index(tag)])


def _special_keys(rng, n):
    """f32[n] keys: a quarter from SPECIAL_BITS, a quarter exact ties, the
    rest uniform in [0, 4)."""
    d = (4 * rng.random(n)).astype(np.float32)
    kind = rng.integers(0, 4, n)
    d[kind == 0] = rng.choice(SPECIAL_BITS, int((kind == 0).sum()))
    d[kind == 1] = rng.choice(np.array([0.5, 1.0, 2.0], np.float32), int((kind == 1).sum()))
    return d


def _octave_keys(rng, shape, lens, first=0):
    """f32 keys in [1, 2), the spans of the bench's records: a quarter of
    them repeat the key before (ties); of runs first + r (lens[r] keys,
    along the last axis) every three the second holds 1 and
    nextafter(2, 0) (a span of 2^23 - 1, the packed network's limit for
    512 positions), the third also 2 (one past it)."""
    d = (1.0 + rng.random(shape)).astype(np.float32)
    d = d.reshape(-1, shape[-1])
    tie = rng.random(d.shape) < 0.25
    tie[:, 0] = False
    for _ in range(3):
        d[:, 1:] = np.where(tie[:, 1:], d[:, :-1], d[:, 1:])
    for r, ln in enumerate(np.broadcast_to(lens, d.shape[:1])):
        if ln >= 3 and (first + r) % 3:
            d[r, int(rng.integers(0, ln))] = 1.0
            d[r, int(rng.integers(0, ln))] = np.nextafter(np.float32(2), np.float32(0))
            if (first + r) % 3 == 2:
                d[r, int(rng.integers(0, ln))] = 2.0
    return d.reshape(shape)


def segsort_rows(tag):
    """(counts i32[R], indices i32[R, C], integrals f32[R, C], distances
    f32[R, C]) of SEGSORT_ROW_CASES' case ``tag`` as numpy arrays."""
    kind, n_rows, width = SEGSORT_ROW_CASES[tag]
    return _record_rows(_segsort_rng(SEGSORT_ROW_CASES, tag), kind, n_rows, width)


def _record_rows(rng, kind, n_rows, width):
    counts = rng.integers(0, width + width // 2 + 1, n_rows).astype(np.int32)
    counts[:3] = (0, width, width + 1)[:n_rows]
    valid = np.arange(width)[None, :] < np.minimum(counts, width)[:, None]
    idx = np.where(valid, rng.integers(0, 1 << 20, (n_rows, width)), -1).astype(np.int32)
    intg = np.where(valid, rng.random((n_rows, width)), 0.0).astype(np.float32)
    dist = np.where(valid, 4 * rng.random((n_rows, width)), -1.0).astype(np.float32)
    if kind == "edges":
        dist = _special_keys(rng, n_rows * width).reshape(n_rows, width)
        idx[rng.random((n_rows, width)) < 0.1] = -1     # sentinel slots anywhere
        idx[valid & (rng.random((n_rows, width)) < 0.05)] = -1
        dist[rng.random((n_rows, width)) < 0.03] = np.inf   # real +inf: ties with sentinels
        if n_rows > 5:
            idx[3] = -1                                  # a row of sentinels only
            dist[4] = 1.5                                # a row of one distance
            idx[5, ::2] = -1
    if kind == "octave":
        dist = np.where(valid, _octave_keys(rng, dist.shape, np.minimum(counts, width)), -1.0)
        dist = dist.astype(np.float32)
    if kind == "sorted":   # each row's records in order (the sentinels' -1 stays at the tail)
        dist = np.where(valid, np.sort(np.where(valid, dist, np.inf), axis=1), -1.0)
        dist = dist.astype(np.float32)
        last = np.minimum(counts, width) - 1
        rows = np.arange(n_rows)
        nan_rows = (rows % 4 == 1) & (last >= 0)         # a NaN last record, as a sort leaves it
        dist[rows[nan_rows], last[nan_rows]] = np.float32(np.nan)
        tie_rows = (rows % 4 == 2) & (last >= 8)         # ties at the row's start
        dist[rows[tie_rows], :8] = np.minimum(dist[rows[tie_rows], :8], 0.0)
        swap = (rows % 4 == 3) & (last >= 1)             # one pair out of order
        a, b = dist[rows[swap], last[swap] - 1], dist[rows[swap], last[swap]]
        dist[rows[swap], last[swap] - 1], dist[rows[swap], last[swap]] = b, a
    return counts, idx, intg, dist


def segsort_flat(tag):
    """(rows as segsort_rows gives them, capacity, keyword arguments: the
    sentinels, and ``_rows`` where the case forces the rows an E10 block
    scans, which only the kernel's wrapper takes) of SEGSORT_FLAT_CASES'
    case ``tag``."""
    n_rows, width, extra, sentinels, slots, kind, block = SEGSORT_FLAT_CASES[tag]
    rng = _segsort_rng(SEGSORT_FLAT_CASES, tag)
    rows = _record_rows(rng, "records", n_rows, width)
    if kind == "ragged":
        counts = np.concatenate([np.arange(6), np.arange(width - 3, width + 3)])
        counts = counts[counts >= 0]
        pick = rng.random(n_rows) < 0.8
        rows = (np.where(pick, rng.choice(counts, n_rows),
                         rng.integers(0, width + 1, n_rows)).astype(np.int32),
                rng.integers(-(1 << 31), 1 << 31, (n_rows, width)).astype(np.int32),
                rng.random((n_rows, width)).astype(np.float32),
                (4 * rng.random((n_rows, width))).astype(np.float32))
    kept = np.minimum(rows[0], width).astype(np.int64) + (1 if slots else 0)
    if extra is None:
        capacity = 0
    elif extra == "mid-vector":   # inside the body of the middle row with the most records
        offsets = np.cumsum(kept) - kept
        r = n_rows // 2 + int(np.argmax(kept[n_rows // 2:]))
        head = (4 - int(offsets[r]) % 4) % 4
        capacity = int(offsets[r]) + head + 4 * (int(kept[r]) // 8) + 2
    else:
        capacity = max(int(kept.sum()) + extra, 0)
    kw = dict(sentinel_slots=slots)
    if sentinels is not None:
        kw.update(index_sentinel=sentinels[0], value_sentinel=sentinels[1],
                  distance_sentinel=sentinels[2])
    if block is not None:
        kw["_rows"] = block
    return rows, capacity, kw


def segsort_csr(tag):
    """(distances f32[H], offsets i32[R], indices i32[H], data arrays,
    total_hits) of SEGSORT_CSR_CASES' case ``tag`` as numpy arrays (and an
    int or None)."""
    n, kind, total, (n_f, n_i) = SEGSORT_CSR_CASES[tag]
    rng = _segsort_rng(SEGSORT_CSR_CASES, tag)
    ordered = {"swap": 1, "last": 1, "descending": -1}.get(kind, 0)
    octave = kind == "octave"
    if octave:   # distances in [1, 2), as the bench's, in segments of up to 1,024
        kind = "lengths"
    if kind in ("edges", "long", "rays"):
        most = {"edges": 40, "long": 3000, "rays": 600}[kind]
        lengths = rng.integers(0, most + 1, n)
        lengths[rng.random(n) < 0.2] = 0                 # empty segments
        starts = np.cumsum(np.concatenate([[0], lengths]))
        limit = total if kind == "rays" and isinstance(total, int) else n
        offsets = starts[starts < limit].astype(np.int64)   # rays' starts inside the hits
    elif kind in ("padded", "padded_gap"):   # rays' records, then the capacity padding
        lengths = rng.integers(1, 513, 120)
        if kind == "padded_gap":
            lengths[-1] = 0
        offsets = np.cumsum(np.concatenate([[0], lengths[:-1]])).astype(np.int64)
        kept = int(lengths.sum())
    elif kind in ("swap", "last", "ties", "descending", "lengths"):
        lengths = {"swap": [100, 200, 5000, 700], "last": [2500, 1500],
                   "lengths": rng.permutation([1, 2, 31, 32, 33, 511, 512, 513, 1023, 1024,
                                               1025]).tolist()}.get(kind, [])
        lengths = [] if octave else lengths
        while sum(lengths) < n:
            lengths.append(int(rng.integers(1, 1025 if octave else 41 if kind == "lengths"
                                            else 1201)))
        lengths[-1] -= sum(lengths) - n
        offsets = np.cumsum(np.concatenate([[0], lengths[:-1]])).astype(np.int64)
    elif kind == "one":
        offsets = np.zeros(1, np.int64)
    else:
        offsets = np.zeros(0, np.int64)
    if kind == "edges":
        k = offsets.shape[0]
        shuffle = rng.random(k) < 0.2                    # unordered starts
        offsets[shuffle] = rng.permutation(offsets[shuffle])
        offsets[0] = 0
        extra = np.array([-5, -1, n, n + 7, 2**31 - 1, 2**31 - 2, offsets[k // 2],
                          offsets[k // 3]])
        offsets = np.concatenate([offsets, extra[rng.permutation(extra.shape[0])]])
    dist = _special_keys(rng, n) if kind in ("edges", "lengths") else (
        (4 * rng.random(n)).astype(np.float32))
    if kind not in ("edges", "lengths"):
        dist[rng.random(n) < 0.05] = 1.0                 # ties
    idx = rng.integers(0, 1 << 20, n).astype(np.int32)
    bounds = list(zip(offsets.tolist(), offsets[1:].tolist() + [n]))
    if ordered:   # each segment in order (descending: reversed), then the case's fault
        for a, b in bounds:
            dist[a:b] = np.sort(dist[a:b])[::ordered]
            if kind == "swap" and b - a > 1024:
                dist[a + 1023], dist[a + 1024] = dist[a + 1024], dist[a + 1023]
            if kind == "last" and b - a > 1:
                dist[b - 1] = dist[a] - 1.0
    if kind == "ties":   # zeros that tie, NaNs that tie, both in order, and mixes
        zeros, nans = TIE_BITS[:6].view(np.float32), TIE_BITS[6:].view(np.float32)
        mixed = np.concatenate([zeros, nans, np.float32([1.0, -1.0])])
        for j, (a, b) in enumerate(bounds):
            half = a + (b - a) // 2
            if j % 4 == 0:
                dist[a:b] = rng.choice(zeros, b - a)
            elif j % 4 == 1:
                dist[a:b] = rng.choice(nans, b - a)
            elif j % 4 == 2:   # zeros then NaNs: in order
                dist[a:half], dist[half:b] = rng.choice(zeros, half - a), rng.choice(nans, b - half)
            else:              # NaNs before 1.0 and the like: out of order
                dist[a:b] = rng.choice(mixed, b - a)
    if octave:
        for j, (a, b) in enumerate(bounds):
            dist[a:b] = _octave_keys(rng, (b - a,), b - a, j)
    if kind in ("padded", "padded_gap"):
        dist[kept:], idx[kept:] = -1.0, -1               # records_to_flat's fill
    data = [rng.random(n).astype(np.float32) for _ in range(n_f)] + [
        rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32) for _ in range(n_i)]
    total = {"half": n // 2, "past": n + 100, "all": n}.get(total, total)
    return dist, offsets.astype(np.int32), idx, data, total


def record_result(rows, dev):
    """A RecordTraceResult of numpy rows on ``dev``."""
    from grace_tpu_torch.trace.pallas_records import RecordTraceResult

    return RecordTraceResult(*(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in rows))


def segsort_outputs(kind, args, plain):
    """One entry of csrc/segsort.cu on ``args`` (tensors on one device),
    or with ``plain`` its plain version: "rows" (a RecordTraceResult) ->
    the sorted result's fields, "flat" ((rec, capacity, kwargs)) -> the five
    outputs, "csr" ((dist, offsets, idx, data, total)) -> the sorted
    arrays."""
    from grace_tpu_torch.ops import segops
    from grace_tpu_torch.trace import pallas_records as prc

    if kind == "rows":
        fn = prc._sort_records_by_distance_plain if plain else prc.sort_rows_cuda
        return list(fn(args))
    if kind == "flat":
        rec, capacity, kw = args
        if plain:
            kw = {k: v for k, v in kw.items() if k != "_rows"}
        fn = prc._records_to_flat_plain if plain else prc.records_to_flat_cuda
        return list(fn(rec, capacity, **kw))
    dist, offsets, idx, data, total = args
    fn = segops._sort_by_distance_plain if plain else segops.segmented_sort_cuda
    return list(fn(dist, offsets, idx, *data, total_hits=total))


def segsort_case_args(kind, tag, dev):
    """The arguments of ``segsort_outputs`` for case ``tag`` on ``dev``."""
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    if kind == "rows":
        return record_result(segsort_rows(tag), dev)
    if kind == "flat":
        rows, capacity, kw = segsort_flat(tag)
        return record_result(rows, dev), capacity, kw
    dist, offsets, idx, data, total = segsort_csr(tag)
    return to(dist), to(offsets), to(idx), [to(a) for a in data], total


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _on_host(a):
    """``a`` with every tensor in it (in tuples, lists and named tuples)
    copied to the CPU."""
    if isinstance(a, torch.Tensor):
        return a.cpu()
    if isinstance(a, (tuple, list)):
        items = [_on_host(x) for x in a]
        return type(a)(*items) if hasattr(a, "_fields") else type(a)(items)
    return a


def check_segsort_case(kind, tag, args, reference=True):
    """csrc/segsort.cu's entry ``kind`` against grace_tpu's order, bit for
    bit: the kernel's outputs equal the plain version's run on the CPU
    (which the CPU tests hold to grace_tpu) where ``reference``, and are
    compared with the plain version on the card: returns the number of
    outputs' slots where the card's plain version departs from them (its
    torch.sort's order of NaNs, ROADMAP C25) and the kernel's
    outputs. Without ``reference`` the card's plain version must agree."""
    got = segsort_outputs(kind, args, plain=False)
    want = segsort_outputs(kind, args, plain=True)
    if reference:
        ref = segsort_outputs(kind, _on_host(args), plain=True)
        for i, (g, r) in enumerate(zip(got, ref)):
            check_tensor_bits(f"{kind} {tag}: output {i} vs grace_tpu's order", g.cpu(), r)
    apart = 0
    for i, (g, w) in enumerate(zip(got, want)):
        if reference:
            apart += int((_bits(g) != _bits(w)).sum())
        else:
            check_tensor_bits(f"{kind} {tag}: output {i} vs the plain version", g, w)
    return apart, got


def check_segsort(dev):
    """The check_segsort phase: every case of SEGSORT_ROW_CASES,
    SEGSORT_FLAT_CASES and SEGSORT_CSR_CASES through the three entries,
    held to grace_tpu's order (the plain version on the CPU) and compared
    with the plain version on the card. Returns (lines, {case: slots where
    the card's plain version departs})."""
    lines, departures = [], {}
    for kind, cases in (("rows", SEGSORT_ROW_CASES), ("flat", SEGSORT_FLAT_CASES),
                        ("csr", SEGSORT_CSR_CASES)):
        for tag in cases:
            apart, _ = check_segsort_case(kind, tag, segsort_case_args(kind, tag, dev))
            if apart and kind == "flat":   # no sort in it: the card's plain version agrees
                raise AssertionError(f"flat {tag}: the card's plain version departs at {apart}")
            if apart:
                departures[f"{kind} {tag}"] = apart
            lines.append(f"{kind} {tag}: bit-equal to grace_tpu's order (the plain version on "
                         f"the CPU); the card's plain version "
                         + (f"departs at {apart} slots (ROADMAP C25)" if apart else "agrees"))
    return lines, departures


def torch_sort_orders(dev):
    """The order in which torch.sort(stable=True) puts SPECIAL_BITS (each
    twice, shuffled, with 1 and -1) on ``dev`` and on the CPU, as the keys'
    bits: where the card's departs, so do the plain versions on the card
    (ROADMAP C25)."""
    keys = np.concatenate([SPECIAL_BITS, SPECIAL_BITS, np.float32([1.0, -1.0])])
    keys = torch.from_numpy(keys[np.random.default_rng(SEGSORT_SEED).permutation(keys.shape[0])])
    bits = lambda t: [f"{int(b) & 0xFFFFFFFF:08x}" for b in keys.view(torch.int32)[t.cpu()]]
    return (bits(torch.sort(keys.to(dev), stable=True).indices),
            bits(torch.sort(keys, stable=True).indices))


def segsort_gate(rec, rec_sorted, flat, flat_sorted):
    """Main path 4's gate of the three entries: the CSR sort (E9) of
    trace_sph's flat layout equals the flat layout (E10) of the sorted rows
    (E8), bit for bit, on every ray but the last where records were dropped
    (there total_hits, the sum of the unclamped counts, puts the fill
    entries past the kept records in the last ray's segment); both are
    stable sorts of the same keys from the same ascending-index order.
    Returns a summary."""
    from grace_tpu_torch.trace import pallas_records as prc

    n = flat.indices.shape[0]
    ref = prc.records_to_flat(rec_sorted, n)
    check_equal("E9 vs E10(E8): offsets", flat.offsets, ref[0])
    kept = torch.clamp(rec.counts, max=rec.capacity)
    n_kept = int(kept.sum())
    stop = n_kept
    if n_kept < n and rec.counts.shape[0]:
        stop = int(flat.offsets[-1])   # the last ray's segment holds the fill entries
    for name, a, b in zip(("distances", "indices", "integrals"), flat_sorted,
                          (ref[4], ref[2], ref[3])):
        check_tensor_bits(f"E9 vs E10(E8): {name}", a[:stop], b[:stop])
    return (f"the CSR sort of trace_sph's flat layout bit-equal to the flat layout of the "
            f"sorted rows on {stop} of {n_kept} kept records"
            + (f" (the last ray's {n_kept - stop} left out: {n - n_kept} fill entries join "
               "its segment)" if stop < n_kept else ""))


def segsort_counters():
    """csrc/segsort.cu's launch counts."""
    from grace_tpu_torch.ops import segops
    from grace_tpu_torch.trace import pallas_records as prc

    return {"sort_rows": prc.sort_rows_cuda.launches,
            "segmented_sort": segops.segmented_sort_cuda.launches,
            "records_to_flat": prc.records_to_flat_cuda.launches}


def zero_segsort_counters():
    from grace_tpu_torch.ops import segops
    from grace_tpu_torch.trace import pallas_records as prc

    for fn in (prc.sort_rows_cuda, segops.segmented_sort_cuda, prc.records_to_flat_cuda):
        fn.launches = 0


# The segsort entries each main path runs: path 4 all three (the sorted
# rows, trace_sph(engine="pallas")'s flat layout, its CSR sort); path 8's
# row sort is its records gate's reference, after its window.
SEGSORT_BY_PATH = {4: ("sort_rows", "segmented_sort", "records_to_flat")}


def gate_segsort(path):
    """The segsort counters after main path ``path``; raises if an entry
    the path runs was launched no time."""
    counts = segsort_counters()
    idle = [k for k in SEGSORT_BY_PATH.get(path, ()) if counts[k] < 1]
    if idle:
        raise AssertionError(f"main path {path}: segsort kernels {idle} never launched: "
                             f"{counts}")
    return counts


def order_key_torch(d):
    """The kernels' order key of f32 ``d`` as int64 in [0, 2^32)
    (segsort.cu's order_bits): NaN -> 0x7FC00000, -0 and subnormals -> +0,
    then all bits flipped for a negative and the sign bit set for the
    rest."""
    b = d.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = torch.where(torch.isnan(d), 0x7FC00000, torch.where((b & 0x7F800000) == 0, 0, b))
    return torch.where((b & 0x80000000) != 0, b ^ 0xFFFFFFFF, b | 0x80000000)


def csr_sort_keys(flat):
    """E9's library call's keys on a flat layout, built outside its timed
    window: int64 segment << 32 | the order key, the segments
    offsets_to_segments's with the entries past total_hits in a last
    pseudo-segment, as the plain version numbers them."""
    from grace_tpu_torch.ops import segops

    n = flat.distances.shape[0]
    seg = segops.offsets_to_segments(flat.offsets, n).to(torch.int64)
    pos = torch.arange(n, device=seg.device)
    seg = torch.where(pos < torch.as_tensor(flat.total_hits, device=seg.device), seg,
                      flat.offsets.shape[0])
    return seg << 32 | order_key_torch(flat.distances)


def segsort_times(rec, flat):
    """E8-E10's times (CUDA events, warm median, ms) on main path 4's
    records: each entry and its plain version, torch.sort of the row keys
    alone (E8's library call) and of the flat layout's int64 keys segment
    << 32 | order key (E9's; both keys built outside the timed window).
    Returns (times, {kernel: (operations, bytes)}): each input read once,
    each output written once; the operations are the n log2 n compares a
    comparison sort needs a segment."""
    from grace_tpu_torch.ops import segops
    from grace_tpu_torch.trace import pallas_records as prc

    n_rows, width = rec.indices.shape
    key = torch.where(rec.indices == prc.INDEX_SENTINEL, torch.inf, rec.distances)
    args = (flat.distances, flat.offsets, flat.indices, flat.integrals)
    t = {"sort_rows kernel": cuda_ms(lambda: prc.sort_rows_cuda(rec)),
         "sort_rows plain": cuda_ms(lambda: prc._sort_records_by_distance_plain(rec), reps=3),
         "sort_rows library (torch.sort of the keys, stable)": cuda_ms(
             lambda: torch.sort(key, dim=1, stable=True)),
         "records_to_flat kernel": cuda_ms(
             lambda: prc.records_to_flat_cuda(rec, flat.indices.shape[0])),
         "records_to_flat plain": cuda_ms(
             lambda: prc._records_to_flat_plain(rec, flat.indices.shape[0]), reps=3),
         "segmented_sort kernel (path 4's flat layout)": cuda_ms(
             lambda: segops.segmented_sort_cuda(*args, total_hits=flat.total_hits)),
         "segmented_sort plain (path 4's flat layout)": cuda_ms(
             lambda: segops._sort_by_distance_plain(*args, total_hits=flat.total_hits), reps=3)}
    del key
    key = csr_sort_keys(flat)
    t["segmented_sort library (torch.sort of the int64 keys segment << 32 | order key, "
      "stable)"] = cuda_ms(lambda: torch.sort(key, stable=True))
    del key
    # E10's call: its kernel's device time, its device operations (the
    # state's memset and the kernel), and the launch's resources
    flat_call = lambda: prc.records_to_flat_cuda(rec, flat.indices.shape[0])
    ops = device_ops(flat_call)   # first: its windows wait out the empty ones
    log_device_ms(t, "records_to_flat device (profiler; the kernel alone)", flat_call,
                  "records_flat_kernel")
    log(f"records_to_flat: {len(ops)} device operations a call: "
        + "; ".join(name[:60] for name in ops))
    kernel = "records_to_flat" if width % 4 == 0 else "records_to_flat (scalar rows)"
    log(f"resources segsort {kernel} (path 4's launch, {prc.FLAT_ROWS} rows a block): "
        f"{json.dumps(segops.segsort_resources(rec.indices.device, kernel))}")
    h = flat.indices.shape[0]
    kept = torch.clamp(rec.counts, max=width).double()
    seg_len = torch.clamp(kept, min=1)
    compares = int((kept * torch.log2(seg_len)).sum())
    rows = nbytes(rec.indices, rec.integrals, rec.distances)
    work = {"sort_rows": (n_rows * width * int(np.log2(max(width, 2))), 2 * rows),
            "segmented_sort": (compares, 2 * 12 * h + nbytes(flat.offsets, flat.total_hits)),
            "records_to_flat": (0, 12 * int(kept.sum()) + nbytes(rec.counts)
                                + 12 * h + 2 * nbytes(flat.offsets))}
    return t, work


def both_routes(tag, rays, spheres, tree):
    """pallas_trace_sph on the default route (B6) and on
    broadphase="quarter" (B3), in both modes. Gates (path 2's): no
    overflow, hit counts equal, the default route's column densities within
    rtol 1e-5, atol 1e-6 x max of the quarter route's. Returns (column
    density, hit counts, summary)."""
    from grace_tpu_torch.trace.pallas_kernel import pallas_trace_sph

    out = {}
    for bp in ("dense", "quarter"):
        for mode in ("cumulative", "hitcount"):
            out[bp, mode], ovf = pallas_trace_sph(rays, spheres, tree, tile=TRACE_TILE,
                                                  broadphase=bp, mode=mode)
            if bool(ovf.any()):
                raise AssertionError(f"{tag}: overflow on route {bp}")
    hc, cd = out["dense", "hitcount"], out["dense", "cumulative"]
    if int(hc.sum()) == 0:
        raise AssertionError(f"{tag}: no hits")
    check_equal(f"{tag}: default route hit counts vs quarter route", hc,
                out["quarter", "hitcount"])
    want = out["quarter", "cumulative"]
    err, top = check_close(f"{tag}: default route column density vs quarter route", cd, want,
                           1e-5, 1e-6 * float(want.abs().max()))
    return cd, hc, (f"{tag}: {rays.n_rays} rays, {int(hc.sum())} hits, hit counts equal on "
                    f"both routes, column density max abs err {err:.3g} (max {top:.3g})")


def f64_statistics(d, angles):
    """(An, Gn) over the pairs i != j of the directions normalized, and
    Ripley's K at ``angles`` of the directions as given, in float64 on the
    host; and for each angle the K that the pairs whose dot product lies
    within 2^-22 of its cosine carry: f32 dot products and cosines may
    count those either way."""
    d = d.astype(np.float64)
    n = d.shape[0]
    dots = np.clip(d @ d.T, -1.0, 1.0)
    cos = np.cos(np.asarray(angles, np.float64))
    counts = np.array([np.count_nonzero(dots >= c) for c in cos])
    near = np.array([np.count_nonzero(np.abs(dots - c) <= 2.0 ** -22) for c in cos])
    u = d / np.linalg.norm(d, axis=1, keepdims=True)
    dots = np.clip(u @ u.T, -1.0, 1.0)
    np.fill_diagonal(dots, 1.0)
    psi = np.arccos(dots)
    coeff = 4.0 / (n * np.pi)
    scale = n * (n / (4.0 * np.pi))
    return (n - coeff * psi.sum() * 0.5, n / 2.0 - coeff * np.sin(psi).sum() * 0.5,
            (counts - n) / scale, near / scale)


def f64_an_gn(d):
    """(An, Gn) of the directions ``d`` normalized, in float64 on their
    device, by another route than the port's: the chord form over every
    ordered pair, psi = 2 atan2(|a - b|, |a + b|) and sin psi =
    |a - b| |a + b| / 2, from the difference and sum vectors themselves
    (no dot product, no acos or sin, and the pairs (i, i) add 0 of
    themselves), in row blocks of 2^22 pairs."""
    u = d.double()
    u = u / torch.linalg.vector_norm(u, dim=1, keepdim=True)
    n = u.shape[0]
    rows = max(1, (1 << 22) // n)
    psi_s = sin_s = 0.0
    for b0 in range(0, n, rows):
        a = u[b0:b0 + rows, None]
        m = torch.linalg.vector_norm(a - u, dim=2)
        p = torch.linalg.vector_norm(a + u, dim=2)
        psi_s += float((2.0 * torch.atan2(m, p)).sum())
        sin_s += float((m * p).sum()) / 2.0
    coeff = 4.0 / (n * np.pi)
    return n - coeff * psi_s * 0.5, n / 2.0 - coeff * sin_s * 0.5


def statistics_gates(dev, iso_dirs, hp_dirs, sizes):
    """Main path 6's statistics on the card: the isotropic and the HEALPix
    directions pass Rayleigh z, An, Gn and Fn at 0.01; one-octant
    directions are rejected by z and An; the HEALPix An and Gn within 1e-4
    of float64's chord form on the normalized directions (``f64_an_gn``);
    on a subset, An and Gn within 1e-4 relative and K within 1e-3 relative
    (plus the pairs on a threshold) of a float64 evaluation; the Ripley
    band accepts an isotropic bundle and rejects one biased toward +z
    (test_hypothesis.py's criteria). Returns summary lines."""
    from grace_tpu_torch.core.types import Octants
    from grace_tpu_torch.rays import hypothesis as hy
    from grace_tpu_torch.rays import statistics as st
    from grace_tpu_torch.rays.gen import uniform_random_rays_single_octant

    lines = []
    for name, d in (("isotropic", iso_dirs), ("HEALPix", hp_dirs)):
        z = float(st.rayleigh_z(d))
        bg = {k: float(v) for k, v in st.beran_gine_statistics(d).items()}
        if not (z < st.RAYLEIGH_Z_CRIT[0.01] and bg["An"] < st.BERAN_AN_CRIT[0.01]
                and bg["Gn"] < st.GINE_GN_CRIT[0.01] and bg["Fn"] < st.GINE_FN_CRIT[0.01]):
            raise AssertionError(f"{name} directions: uniformity rejected at 0.01: z {z}, {bg}")
        lines.append(f"{name} ({d.shape[0]} directions): z {z:.4g}, An {bg['An']:.4g}, "
                     f"Gn {bg['Gn']:.4g}, Fn {bg['Fn']:.4g}, below their 0.01 critical values")
    an64, gn64 = f64_an_gn(hp_dirs)
    norm_err = float(((hp_dirs.double() ** 2).sum(dim=1) - 1.0).mean())
    if not (abs(bg["An"] - an64) <= 1e-4 and abs(bg["Gn"] - gn64) <= 1e-4):
        raise AssertionError(f"HEALPix An {bg['An']!r}, Gn {bg['Gn']!r} vs float64 {an64!r}, "
                             f"{gn64!r}: beyond 1e-4")
    lines.append(f"HEALPix ({hp_dirs.shape[0]}) vs float64's chord form on the normalized directions: An "
                 f"{bg['An']!r} / {an64!r}, Gn {bg['Gn']!r} / {gn64!r} (within 1e-4); mean "
                 f"|d|^2 - 1 of the f32 directions {norm_err:.3g}")
    octant = uniform_random_rays_single_octant(
        torch.Generator(dev).manual_seed(SNAPSHOT_SEED + 3), sizes["stats_dirs"], (0, 0, 0),
        1.0, Octants.PPP, device=dev).directions
    z_o, an_o = float(st.rayleigh_z(octant)), float(st.beran_gine_statistics(octant)["An"])
    if not (z_o > st.RAYLEIGH_Z_CRIT[0.01] and an_o > st.BERAN_AN_CRIT[0.01]):
        raise AssertionError(f"one-octant directions not rejected: z {z_o}, An {an_o}")
    lines.append(f"one octant ({octant.shape[0]}): z {z_o:.4g}, An {an_o:.4g}, rejected")

    sub = iso_dirs[:sizes["stats_subset"]]
    bg = st.beran_gine_statistics(sub)
    k = st.ripley_k_sphere(sub, hy.DEFAULT_SCALES).cpu().numpy().astype(np.float64)
    an64, gn64, k64, k_near = f64_statistics(sub.cpu().numpy(), hy.DEFAULT_SCALES)
    for name, got, want in (("An", float(bg["An"]), an64), ("Gn", float(bg["Gn"]), gn64)):
        if not abs(got - want) <= 1e-4 * abs(want):
            raise AssertionError(f"{name} {got} vs float64 {want}: beyond 1e-4 relative")
    k_err = np.abs(k - k64)
    if (k_err > 1e-3 * np.abs(k64) + k_near).any():
        raise AssertionError(f"Ripley K vs float64 beyond 1e-3 relative: {k} vs {k64}")
    pairs = sub.shape[0] * (sub.shape[0] / (4.0 * np.pi))      # K's unit in pairs
    lines.append(f"subset ({sub.shape[0]}) vs float64: An {float(bg['An']):.6g} / {an64:.6g}, "
                 f"Gn {float(bg['Gn']):.6g} / {gn64:.6g}; K max rel err "
                 f"{float((k_err / np.abs(k64)).max()):.3g}, pairs counted otherwise by scale "
                 f"{np.rint(k_err * pairs).astype(int).tolist()}, pairs within 2^-22 of the "
                 f"threshold {np.rint(k_near * pairs).astype(int).tolist()}")

    n_dirs, n_samples = sizes["band_dirs"], sizes["band_samples"]
    band = hy.ripley_csr_band(torch.Generator(dev).manual_seed(SNAPSHOT_SEED + 4), n_dirs,
                              BAND_SCALES, n_samples=n_samples, device=dev)
    iso = hy.isotropic_directions(torch.Generator(dev).manual_seed(SNAPSHOT_SEED + 5), n_dirs,
                                  device=dev)
    _, resid, p = hy.ripley_isotropy_test(iso, band)
    outside = (resid < band.lower) | (resid > band.upper)
    if not (outside.sum() <= 1 and p.min() > 1 / (n_samples + 1)):
        raise AssertionError(f"Ripley band rejects an isotropic bundle: {resid}, p {p}")
    biased = hy.isotropic_directions(torch.Generator(dev).manual_seed(SNAPSHOT_SEED + 6),
                                     n_dirs, device=dev)
    biased[:, 2] = 0.4 + biased[:, 2].abs()
    biased /= torch.linalg.norm(biased, dim=1, keepdim=True)
    rejected, _, p_b = hy.ripley_isotropy_test(biased, band)
    if not (rejected and p_b.min() <= 0.05):
        raise AssertionError(f"Ripley band accepts a +z-biased bundle: p {p_b}")
    lines.append(f"Ripley band ({n_samples} samples of {n_dirs}): isotropic bundle inside "
                 f"(min p {p.min():.3g}), +z-biased rejected (min p {p_b.min():.3g})")
    return lines


def wall_ms(fn):
    """(fn(), its host wall time in ms)."""
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def snapshot_path(dev, particles, sizes=SNAPSHOT_SIZES):
    """Main path 6 on ``particles`` (f32[N, 4]), through the entry points a
    user calls, with the trace kernels' launch counters set to 0 first:

      1. the native IO library must load; write_gadget_gas, then
         read_gadget_gas, _np_read and four read_gadget_gas_shard: each
         bit-equal to the written array;
      2. build_sph_tree, save_scene, load_scene(device=...): every tree
         field and the spheres bit-equal;
      3. plane_parallel_random_rays over the particles' extent
         (project_gadget's field), both routes (``both_routes``), the
         log-scaled image through to_colormap and write_bmp (a valid
         header, 54 + 3 side^2 bytes);
      4. the integral normalization: plane-parallel rays over the extent
         padded by the largest h, |sum of column density x cell area / N
         - 1| < 5e-4 on the default route;
      5. isotropic rays from the box centre (hitcount_stats's rays),
         direction-sorted: the sort is a permutation of the unsorted
         draw's rays; both routes; a strided subset's hit counts equal the
         generic engine's;
      6. HEALPix rays from the centre, rotated: both routes;
      7. ``statistics_gates`` on the unsorted draw's first directions.

    Returns a dict: the trace kernels' ``launches``, summary ``lines``,
    host ``wall`` times of the file stages {name: ms}, the ``ray_sets``
    {name: rays}, the sorted ``spheres`` and ``tree``, the path's wall
    ``ms`` and the unsorted draw's ``iso_dirs``."""
    from grace_tpu_torch.build.sph import build_sph_tree
    from grace_tpu_torch.io import checkpoint, gadget, images, native
    from grace_tpu_torch.ops.extrema import min_max
    from grace_tpu_torch.rays import gen
    from grace_tpu_torch.rays.healpix import healpix_rays
    from grace_tpu_torch.trace import pallas_kernel as pk
    from grace_tpu_torch.trace.sph import trace_hitcounts_sph

    wall, lines, ray_sets = {}, [], {}
    n = particles.shape[0]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    pk.trace_bitmask.launches = 0
    pk.trace_quarter.launches = 0
    t_path = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        snap = os.path.join(tmp, "snapshot.gdt")
        lib, wall["native IO library (g++ at first use, load)"] = wall_ms(native.load)
        if lib is None:
            raise AssertionError(f"the native IO library did not load: {native.build_error}")
        _, wall["write_gadget_gas"] = wall_ms(lambda: gadget.write_gadget_gas(snap, particles))
        written = torch.from_numpy(particles)
        back, wall["read_gadget_gas"] = wall_ms(lambda: gadget.read_gadget_gas(snap))
        check_tensor_bits("read_gadget_gas", torch.from_numpy(back), written)
        np_back, wall["_np_read"] = wall_ms(lambda: gadget._np_read(snap))
        check_tensor_bits("_np_read", torch.from_numpy(np_back), written)
        shards, wall["read_gadget_gas_shard x 4"] = wall_ms(lambda: np.concatenate(
            [gadget.read_gadget_gas_shard(snap, s, 4) for s in range(4)]))
        check_tensor_bits("read_gadget_gas_shard x 4", torch.from_numpy(shards), written)
        lines.append(f"snapshot: {n} particles, {os.path.getsize(snap)} bytes; native reader, "
                     "numpy reader and 4 shards bit-equal to the written array")

        spheres = torch.from_numpy(back).to(dev)
        ss, tree, _ = build_sph_tree(spheres, MAX_PER_LEAF)
        ckpt = os.path.join(tmp, "scene.npz")
        _, wall["save_scene"] = wall_ms(lambda: checkpoint.save_scene(ckpt, ss, tree))
        (ss2, tree2, w2), wall["load_scene"] = wall_ms(
            lambda: checkpoint.load_scene(ckpt, device=dev))
        check_tensor_bits("checkpoint spheres", ss2, ss)
        for f in ("children", "child_aabbs", "leaves", "root", "n_nodes", "n_leaves"):
            check_tensor_bits(f"checkpoint tree.{f}", getattr(tree2, f), getattr(tree, f))
        if tree2.max_per_leaf != tree.max_per_leaf or w2 is not None:
            raise AssertionError("checkpoint: max_per_leaf or weights differ")
        lines.append(f"checkpoint: {os.path.getsize(ckpt)} bytes, spheres and every tree "
                     "field bit-equal after the round trip")

        mins, maxs = (v.cpu().numpy() for v in min_max(ss[:, :3]))
        ext = float((maxs - mins).max())
        side = sizes["proj_side"]
        ray_sets["projection"] = gen.plane_parallel_random_rays(
            torch.Generator(dev).manual_seed(SNAPSHOT_SEED), side, side,
            (mins[0], mins[1], mins[2] - ext), (ext, 0, 0), (0, ext, 0), 3 * ext, device=dev)
        cd, _, line = both_routes("projection", ray_sets["projection"], ss, tree)
        lines.append(line)
        bmp = os.path.join(tmp, "density.bmp")
        _, wall["to_colormap + write_bmp"] = wall_ms(lambda: images.write_bmp(
            bmp, images.to_colormap(cd.reshape(side, side), log_scale=True)))
        raw = open(bmp, "rb").read()
        field = lambda lo, hi: int.from_bytes(raw[lo:hi], "little")
        if (len(raw) != 54 + 3 * side * side or raw[:2] != b"BM" or field(2, 6) != len(raw)
                or field(10, 14) != 54 or field(14, 18) != 40
                or (field(18, 22), field(22, 26), field(26, 28), field(28, 30))
                != (side, side, 1, 24)):
            raise AssertionError(f"density.bmp: {len(raw)} bytes or its header is wrong")
        lines.append(f"density.bmp: {len(raw)} bytes, 24-bit {side}x{side} header")

        hmax = float(ss[:, 3].max())
        span = ext + 2.0 * hmax
        res = sizes["integral_side"]
        ray_sets["integral"] = gen.plane_parallel_random_rays(
            torch.Generator(dev).manual_seed(SNAPSHOT_SEED + 1), res, res,
            (mins[0] - hmax, mins[1] - hmax, mins[2] - hmax - span), (span, 0, 0), (0, span, 0),
            3 * span, device=dev)
        cd_i, ovf = pk.pallas_trace_sph(ray_sets["integral"], ss, tree, tile=TRACE_TILE)
        norm = float(cd_i.double().sum()) * (span / res) ** 2 / n
        if bool(ovf.any()) or not abs(norm - 1.0) < INTEGRAL_TOL:
            raise AssertionError(f"integral normalization {norm!r}: |x - 1| >= {INTEGRAL_TOL}")
        lines.append(f"integral normalization ({res}x{res} rays over {span:.6g}^2): sum x "
                     f"area / N = {norm!r} (|x - 1| = {abs(norm - 1):.3g} < {INTEGRAL_TOL})")

        centre = (0.5, 0.5, 0.5)
        iso_gen = lambda: torch.Generator(dev).manual_seed(SNAPSHOT_SEED + 2)
        ray_sets["isotropic"] = iso = gen.uniform_random_rays(iso_gen(), sizes["iso_rays"],
                                                              centre, 2.0, device=dev)
        unsorted = gen.uniform_random_rays(iso_gen(), sizes["iso_rays"], centre, 2.0,
                                           sort=False, device=dev)
        order = torch.argsort(gen.ray_dir_morton_keys(unsorted.directions), stable=True)
        check_tensor_bits("sorted isotropic rays vs the unsorted draw, sorted",
                          iso.directions, unsorted.directions[order])
        _, hc, line = both_routes("isotropic", iso, ss, tree)
        lines.append(line)
        sub = torch.arange(0, sizes["iso_rays"], sizes["iso_rays"] // sizes["engine_rays"],
                           device=dev)
        hc_engine, wall["trace_hitcounts_sph (engine subset)"] = wall_ms(
            lambda: trace_hitcounts_sph(iso[sub], ss, tree).cpu())
        check_equal("isotropic subset: default route vs engine hit counts", hc[sub].cpu(),
                    hc_engine)
        lines.append(f"engine subset: {sub.numel()} rays, hit counts equal the default "
                     f"route's ({int(hc_engine.sum())} hits)")
        hc_walk, wall["trace_hitcounts_sph (all isotropic rays)"] = wall_ms(
            lambda: trace_hitcounts_sph(iso, ss, tree).cpu())
        n_diff = count_gate("isotropic: walk vs default route", iso, ss, hc_walk, hc.cpu())
        lines.append(f"the walk on all {iso.n_rays} isotropic rays: hit counts equal the "
                     f"default route's but on {n_diff} rays where the two pair tests round "
                     "apart (each explained)")

        ray_sets["HEALPix"] = healpix_rays(torch.Generator(dev).manual_seed(SNAPSHOT_SEED + 7),
                                           sizes["nside"], centre, 2.0, device=dev)
        lines.append(both_routes("HEALPix", ray_sets["HEALPix"], ss, tree)[2])
        lines += statistics_gates(dev, unsorted.directions[:sizes["stats_dirs"]],
                                  ray_sets["HEALPix"].directions, sizes)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    path_ms = (time.perf_counter() - t_path) * 1e3
    launches = {"trace_bitmask": pk.trace_bitmask.launches,
                "trace_quarter": pk.trace_quarter.launches}
    return dict(launches=launches, lines=lines, wall=wall, ray_sets=ray_sets, spheres=ss,
                tree=tree, ms=path_ms, iso_dirs=unsorted.directions[:sizes["stats_dirs"]])


def snapshot_inputs(ray_sets, ss, tree):
    """{set: {kernel: leading arguments}} of B6 (``trace_bitmask``) and B3
    (``trace_quarter``) on each of path 6's ray sets, prepared as
    pallas_trace_sph prepares them."""
    return {name: {"trace_bitmask": route_inputs("bitmask", rays, ss, tree, TRACE_TILE)[2],
                   "trace_quarter": route_inputs("quarter", rays, ss, tree, TRACE_TILE)[2]}
            for name, rays in ray_sets.items()}


def heavy_tiles(words, n_heavy=32, n_spread=32):
    """Ascending tile ids of a check subset: the ``n_heavy`` tiles whose
    words list the most segments or quarters (their set bits) and
    ``n_spread`` tiles spread evenly over the rest."""
    n_tiles = words.shape[0]
    heavy = torch.argsort(_popcount_rows(words), descending=True, stable=True)[:n_heavy]
    spread = torch.linspace(0, n_tiles - 1, min(n_spread, n_tiles),
                            device=words.device).round().long()
    return torch.unique(torch.cat([heavy, spread]))


def tile_subset(args, tiles):
    """A trace kernel's leading arguments (``route_inputs``) restricted to
    ``tiles``: the rows of every per-tile tensor and those tiles' packed
    rays; the primitives as they are."""
    *lists, packed, prims = args
    tile = packed.shape[0] // lists[0].shape[0]
    rows = (tiles[:, None] * tile + torch.arange(tile, device=tiles.device)).flatten()
    return (*[t[tiles] for t in lists], packed[rows], prims)


def snapshot_kernel_checks(inputs, full="isotropic"):
    """B6 and B3 against their plain versions (``check_kernel``'s gates,
    deg 14) on path 6's inputs: on every ray set, the ``heavy_tiles`` of
    each kernel's own lists in both modes; on all tiles of the ``full``
    set in cumulative mode, the plain version timed once (CUDA events).
    Returns ({kernel: max abs err of the full set}, {kernel: plain ms on
    the full set}, summary lines)."""
    from grace_tpu_torch.trace import pallas_kernel as pk

    plain = {"trace_bitmask": pk._trace_bitmask_plain, "trace_quarter": pk._trace_quarter_plain}
    errs, plain_ms, lines = {}, {}, []
    for name, by_kernel in inputs.items():
        for kname, args in by_kernel.items():
            kernel = getattr(pk, kname)
            words = args[0] if kname == "trace_bitmask" else args[1]
            tiles = heavy_tiles(words)
            sub = tile_subset(args, tiles)
            err, top = check_kernel(f"path 6 {name} {kname} subset", kernel, plain[kname], sub,
                                    "cumulative", 14)
            check_kernel(f"path 6 {name} {kname} subset", kernel, plain[kname], sub,
                         "hitcount", 14)
            listed = _popcount_rows(words[tiles])
            lines.append(f"{kname} vs plain on {name}'s {tiles.numel()} tiles with the longest "
                         f"lists and spread (up to {int(listed.max())} listed, mean "
                         f"{float(listed.float().mean()):.1f}; all tiles' mean "
                         f"{float(_popcount_rows(words).float().mean()):.1f}), cumulative deg "
                         f"14 and hitcount: max abs err {err:.3g} (max value {top:.3g})")
    for kname, args in inputs[full].items():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain[kname](*args, 14, "cumulative")
        end.record()
        torch.cuda.synchronize()
        plain_ms[kname] = start.elapsed_time(end)
        errs[kname], top = check_kernel(f"path 6 {full} {kname}", getattr(pk, kname),
                                        plain[kname], args, "cumulative", 14, want)
        lines.append(f"{kname} vs plain on all {args[0].shape[0]} tiles of {full} "
                     f"(cumulative deg 14): max abs err {errs[kname]:.3g} (max value "
                     f"{top:.3g}); plain {plain_ms[kname]:.3f} ms")
    return errs, plain_ms, lines


def snapshot_times(dev, ray_sets, inputs, ss, tree, iso_dirs, sizes=SNAPSHOT_SIZES):
    """Path 6's device stages (CUDA events, warm median) and, for each ray
    set, B6 and B3 in both modes on that set's ``inputs`` with the work
    behind them, and the engine's walk (E1, the packet walk and the per-ray
    walk) in cumulative and count mode on the isotropic and HEALPix sets.
    Returns (stage ms, {(set, kernel, mode): ms}, {set: {kernel: (flops,
    bytes)}} of one cumulative launch, work lines)."""
    from grace_tpu_torch.build.sph import build_sph_tree
    from grace_tpu_torch.rays import gen
    from grace_tpu_torch.rays import hypothesis as hy
    from grace_tpu_torch.rays import statistics as st
    from grace_tpu_torch.rays.healpix import healpix_rays
    from grace_tpu_torch.trace import pallas_kernel as pk
    from grace_tpu_torch.trace import walk as wk

    g = torch.Generator(dev)
    side, res = sizes["proj_side"], sizes["integral_side"]
    t = {
        "build_sph_tree": cuda_ms(lambda: build_sph_tree(ss, MAX_PER_LEAF), reps=3),
        f"plane_parallel_random_rays {side}x{side}": cuda_ms(
            lambda: gen.plane_parallel_random_rays(g, side, side, (0, 0, 0), (1, 0, 0),
                                                   (0, 1, 0), 3.0, device=dev)),
        f"plane_parallel_random_rays {res}x{res}": cuda_ms(
            lambda: gen.plane_parallel_random_rays(g, res, res, (0, 0, 0), (1, 0, 0),
                                                   (0, 1, 0), 3.0, device=dev)),
        f"uniform_random_rays {sizes['iso_rays']} (sorted)": cuda_ms(
            lambda: gen.uniform_random_rays(g, sizes["iso_rays"], (0.5,) * 3, 2.0, device=dev)),
        f"healpix_rays nside {sizes['nside']}": cuda_ms(
            lambda: healpix_rays(g, sizes["nside"], (0.5,) * 3, 2.0, device=dev)),
        f"rayleigh_z ({sizes['stats_dirs']})": cuda_ms(lambda: st.rayleigh_z(iso_dirs)),
        f"beran_gine_statistics ({sizes['stats_dirs']})": cuda_ms(
            lambda: st.beran_gine_statistics(iso_dirs), reps=3),
        f"beran_gine_statistics (HEALPix, {ray_sets['HEALPix'].n_rays})": cuda_ms(
            lambda: st.beran_gine_statistics(ray_sets["HEALPix"].directions), reps=3),
        f"ripley_k_sphere ({sizes['stats_subset']}, 12 scales)": cuda_ms(
            lambda: st.ripley_k_sphere(iso_dirs[:sizes["stats_subset"]], hy.DEFAULT_SCALES)),
        f"ripley_csr_band ({sizes['band_samples']} x {sizes['band_dirs']})": cuda_ms(
            lambda: hy.ripley_csr_band(g, sizes["band_dirs"], BAND_SCALES,
                                       n_samples=sizes["band_samples"], device=dev),
            reps=1, warm=0),
    }
    for name, rays in ray_sets.items():
        t[f"pallas_trace_sph default ({name})"] = cuda_ms(
            lambda: pk.pallas_trace_sph(rays, ss, tree, tile=TRACE_TILE))
    kernels, work, lines = {}, {}, []
    for name, rays in ray_sets.items():
        bm, qa = inputs[name]["trace_bitmask"], inputs[name]["trace_quarter"]
        for mode in ("cumulative", "hitcount"):
            kernels[name, "trace_bitmask", mode] = cuda_ms(
                lambda: pk.trace_bitmask(*bm, 14, mode))
            kernels[name, "trace_quarter", mode] = cuda_ms(
                lambda: pk.trace_quarter(*qa, 14, mode))
        hits = int(pk.trace_bitmask(*bm, 14, "hitcount").to(torch.int64).sum())
        segments, quarters = int(_popcount_rows(bm[0]).sum()), int(_popcount_rows(qa[1]).sum())
        # the bounds of the main paths' trace kernels (operations), on this set
        flops = lambda tests: tests * FLOPS_PAIR + hits * FLOPS_HIT_H14
        out_bytes = bm[1].shape[0] * 4
        work[name] = {"trace_bitmask": (flops(segments * 128 * TRACE_TILE),
                                        nbytes(*bm) + out_bytes),
                      "trace_quarter": (flops(quarters * 32 * TRACE_TILE),
                                        nbytes(*qa) + out_bytes)}
        bound = {k: max(f / PEAK_FLOPS, b / PEAK_BYTES) * 1e3
                 for k, (f, b) in work[name].items()}
        b6, b3 = (kernels[name, k, "cumulative"] for k in ("trace_bitmask", "trace_quarter"))
        lines.append(f"{name}: {rays.n_rays} rays in {bm[0].shape[0]} tiles, {hits} hits, "
                     f"{segments} (tile, segment) pairs (B6), {quarters} (tile, quarter) pairs "
                     f"(B3), {100 * hits / (segments * 128 * TRACE_TILE):.3f}% of B6's pair "
                     f"tests hit; cumulative B6 {b6:.3f} ms (bound "
                     f"{bound['trace_bitmask']:.3f}), B3 {b3:.3f} ms (bound "
                     f"{bound['trace_quarter']:.3f}); B6 {b6 * 1e6 / rays.n_rays:.1f} ns a ray")
    # the engine's walk (E1) on the fan-out sets, beside B6
    for name in ("isotropic", "HEALPix"):
        rays = ray_sets[name]
        for mode, b6_mode in (("cumulative", "cumulative"), ("count", "hitcount")):
            kernels[name, "bvh_walk_sph", mode] = cuda_ms(
                lambda: wk.walk_sph(rays, ss, tree, mode))
            kernels[name, "bvh_walk_sph per-ray", mode] = cuda_ms(
                lambda: walk_outputs(rays, ss, tree, "sph", mode, 64, "per_ray", visits=False))
        restarts, steps, lanes = packet_summary(
            walk_outputs(rays, ss, tree, "sph", "count", 64, "packet", stats=True)[3])
        lines.append(
            f"{name}: the walk (E1) cumulative {kernels[name, 'bvh_walk_sph', 'cumulative']:.3f} "
            f"ms, count {kernels[name, 'bvh_walk_sph', 'count']:.3f} ms (per-ray walk "
            f"{kernels[name, 'bvh_walk_sph per-ray', 'cumulative']:.3f} and "
            f"{kernels[name, 'bvh_walk_sph per-ray', 'count']:.3f}), beside B6's "
            f"{kernels[name, 'trace_bitmask', 'cumulative']:.3f} and "
            f"{kernels[name, 'trace_bitmask', 'hitcount']:.3f} ms; packet {restarts} restarts, "
            f"{steps:.1f} steps a warp, {lanes:.2f} active lanes a step")
    return t, kernels, work, lines


def bench_scene(spheres, side):
    """Main path 1's scene from the particles ``spheres`` (a tensor on the
    device the path runs on): the Morton-sorted particles and their tree,
    the sorted orthographic rays with the inverse of their sort, and the
    banded splat buckets. Paths 1 and 7 run on it."""
    from grace_tpu_torch.build.sph import build_sph_tree
    from grace_tpu_torch.rays.gen import orthographic_projection_rays, spatial_sort_rays
    from grace_tpu_torch.trace import splat as sp

    ss, tree, _ = build_sph_tree(spheres, MAX_PER_LEAF)
    rays_s, _, inv = spatial_sort_rays(orthographic_projection_rays(
        side, side, CAM, LOOK, UP, VEXT, LENGTH, device=spheres.device))
    buckets = sp.bucket_prims_ortho(ss, CAM, LOOK, UP, VEXT, LENGTH, side, side, chunk=512,
                                    band=32, **SPLAT_TILE)
    return dict(spheres=ss, tree=tree, rays=rays_s, inv=inv, buckets=buckets, side=side)


def dryrun_scene(dev):
    """``dryrun_multichip``'s draws on a mesh of one rank: (spheres, rays,
    targets), and an undersized scene whose rays all cross a clump of
    large particles."""
    from grace_tpu_torch.core.types import Rays

    rng = np.random.default_rng(1)
    n, r = DRYRUN["n_per_shard"], DRYRUN["rays_per_rank"]
    spheres = np.concatenate([rng.random((n, 3)), 0.1 + 0.1 * rng.random((n, 1))],
                             axis=1).astype(np.float32)
    d = rng.standard_normal((r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = rng.random((r, 3)).astype(np.float32) * 0.2 - 0.6
    rays = Rays.from_arrays(o, d, np.full((r,), 4.0, np.float32), device=dev)
    targets = torch.from_numpy(rng.random(r).astype(np.float32)).to(dev)
    clump = np.concatenate([rng.random((n, 3)) * 0.2 - 0.1, np.full((n, 1), 0.3)],
                           axis=1).astype(np.float32)
    through = Rays.from_arrays(np.tile([[0.0, 0.0, -2.0]], (r, 1)),
                               np.tile([[0.0, 0.0, 1.0]], (r, 1)), np.full((r,), 6.0), device=dev)
    return (torch.from_numpy(spheres).to(dev), rays, targets,
            torch.from_numpy(clump).to(dev), through)


def _path7_counters():
    from grace_tpu_torch.trace import pallas_kernel as pk
    from grace_tpu_torch.trace import splat as sp
    from grace_tpu_torch.trace import splat_grad as sg

    return {"splat": sp.splat_image, "trace_quarter": pk.trace_quarter,
            "trace_bitmask": pk.trace_bitmask, "splat_sortfree_fwd": sg.splat_sortfree_fwd,
            "splat_sortfree_bwd": sg.splat_sortfree_bwd}


def engine_train_step(spheres, rays, targets, capacity, max_per_leaf, lr):
    """The single-device twin of ``sharded_train_step``: the engine render
    of the sorted particles (gradients through the sort's gather), L2 loss,
    SGD. Returns (new spheres, loss)."""
    from grace_tpu_torch.build.sph import build_sph_tree
    from grace_tpu_torch.trace.render import find_hits, integrate_hits

    s = spheres.detach().clone().requires_grad_(True)
    sorted_plain, tree, perm = build_sph_tree(spheres.detach(), max_per_leaf)
    img = integrate_hits(find_hits(rays, sorted_plain, tree, capacity), rays, s[perm.long()],
                         rays.n_rays)
    loss = ((img - targets) ** 2).sum()
    loss.backward()
    return spheres.detach() - lr * s.grad, loss.detach()


def sharded_times(mesh, scene, splat_step, dry):
    """Path 7's routes and their single-device twins (CUDA events, warm
    median of 5, in turns: twin, route, route, twin; the mean of each
    side's two medians), and the collectives each route runs, timed alone
    on the same tensors. Returns {route: (ms, single-device ms,
    collectives ms)}."""
    import torch.distributed as dist

    from grace_tpu_torch.parallel import multihost as mh
    from grace_tpu_torch.parallel import sharding as sh
    from grace_tpu_torch.trace import pallas_kernel as pk
    from grace_tpu_torch.trace import splat as sp
    from grace_tpu_torch.trace.broadphase import tile_aabbs
    from grace_tpu_torch.trace.render import find_hits, integrate_hits

    ss, rays, buckets = scene["spheres"], scene["rays"], scene["buckets"]
    sd, rays_d, targets_d, ssd, treed = dry
    cap, leaf, lr = DRYRUN["capacity"], DRYRUN["max_per_leaf"], DRYRUN["lr"]
    local = mh.global_to_host_local(mesh, mh.P(("rays", "space")), rays)
    dev = ss.device
    tmin, tmax = tile_aabbs(local, TRACE_TILE)
    space, rays_group = mesh.get_group("space"), mesh.get_group("rays")

    def gather_aabbs():
        for x in (tmin, tmax):
            dist.all_gather([torch.empty_like(x)], x, group=space)

    image = torch.zeros(scene["side"], scene["side"], device=dev)
    scalar = torch.zeros((), device=dev)
    grad = torch.zeros_like(sd)
    flag = torch.ones((), dtype=torch.bool, device=dev)
    c = {"flag": cuda_ms(lambda: sh.mesh_any(mesh, flag)),
         "aabbs": cuda_ms(gather_aabbs),
         "image": cuda_ms(lambda: sh.allreduce_sum(image, mesh)),
         "loss": cuda_ms(lambda: sh.allreduce_sum(scalar, mesh)),
         "grad": cuda_ms(lambda: dist.all_reduce(grad.clone(), group=rays_group))}
    trace = lambda bp: (lambda: pk.pallas_trace_sph(rays, ss, tile=TRACE_TILE, broadphase=bp))
    routes = {
        "sharded_pallas_render bitmask": (
            lambda: sh.sharded_pallas_render(mesh, local, ss, tile=TRACE_TILE),
            trace("bitmask"), c["flag"]),
        "sharded_pallas_render quarter": (
            lambda: sh.sharded_pallas_render(mesh, local, ss, tile=TRACE_TILE,
                                             broadphase="quarter"),
            trace("quarter"), c["flag"]),
        "ring_pallas_render": (
            lambda: sh.ring_pallas_render(mesh, local, ss, tile=TRACE_TILE),
            trace("bitmask"), c["aabbs"] + c["flag"]),
        "sharded_splat_render": (
            lambda: sh.sharded_splat_render(mesh, buckets, basis="deg8", **SPLAT_TILE),
            lambda: sp.splat_image(buckets, basis="deg8", **SPLAT_TILE), 0.0),
        "splat step (allreduce_sum)": (lambda: splat_step(mesh), lambda: splat_step(None),
                                       c["image"]),
        "replicated_sharded_render (dryrun size)": (
            lambda: sh.replicated_sharded_render(mesh, rays_d, ssd, treed, cap),
            lambda: integrate_hits(find_hits(rays_d, ssd, treed, cap), rays_d, ssd,
                                   rays_d.n_rays), c["flag"]),
        "sharded_train_step (dryrun size)": (
            lambda: sh.sharded_train_step(mesh, rays_d, sd, targets_d, cap, leaf, lr),
            lambda: engine_train_step(sd, rays_d, targets_d, cap, leaf, lr),
            c["flag"] + c["loss"] + c["grad"]),
    }
    out = {}
    for name, (f, f1, coll) in routes.items():
        one = [cuda_ms(f1)]
        sharded = [cuda_ms(f), cuda_ms(f)]
        one.append(cuda_ms(f1))
        out[name] = (statistics.mean(sharded), statistics.mean(one), coll)
    return out


def sharded_path(dev, scene, time_routes=False):
    """Main path 7, the sharded routes of ``grace_tpu_torch.parallel`` on
    one rank: ``multihost.initialize`` (NCCL on the card, gloo on the
    CPU, meeting at a file store), ``make_mesh(1, 1)``, and with the
    launch counters of B1, B3, B6, B11 and B12 set to 0 just before:

      1. on ``scene`` (``bench_scene``): ``sharded_pallas_render`` on the
         bitmask and the quarter route, ``ring_pallas_render`` with its
         hoisted masks and ``sharded_splat_render`` (banded, deg8), each
         bit-equal to the same call without the mesh; one data-parallel
         splat training step through ``allreduce_sum`` (dryrun_multichip's
         step), loss and gradients bit-equal to ``make_splat_trainer``'s;
      2. at dryrun_multichip's sizes, ``replicated_sharded_render`` and
         ``sharded_train_step`` within rtol 1e-5 of the single-device
         engine render, loss and update; an undersized capacity sets the
         flag and ``check_overflow`` raises.

    The counters are read after the sharded calls and before their
    single-device twins. With ``time_routes`` (the card), each route and
    its twin are timed (CUDA events, warm median) with the collectives
    each route runs. The process group is torn down at the end, also on
    failure. Returns a dict: ``launches``, check ``lines`` and, when
    timed, ``times`` {route: (ms, single-device ms, collectives ms)}."""
    import torch.distributed as dist

    from grace_tpu_torch.build.sph import build_sph_tree
    from grace_tpu_torch.core.errors import GraceError, check_overflow
    from grace_tpu_torch.parallel import multihost as mh
    from grace_tpu_torch.parallel import sharding as sh
    from grace_tpu_torch.trace import pallas_kernel as pk
    from grace_tpu_torch.trace import splat as sp
    from grace_tpu_torch.trace.render import find_hits, integrate_hits
    from grace_tpu_torch.trace.splat_grad import OrthoCamera, make_splat_trainer

    ss, rays, buckets, side = scene["spheres"], scene["rays"], scene["buckets"], scene["side"]
    cam = OrthoCamera(CAM, LOOK, UP, VEXT, LENGTH, side, side)
    render = make_splat_trainer(cam, basis="deg8", **SPLAT_TILE)
    lines, out = [], {}
    R, S = mh.P(("rays", "space")), mh.P("space")
    with tempfile.TemporaryDirectory() as tmp:
        mh.initialize("file://" + os.path.join(tmp, "store"), 1, 0,
                      backend=None if dev.type == "cuda" else "gloo")
        try:
            mesh = sh.make_mesh(1, 1, dev.type)
            local_rays = mh.global_to_host_local(mesh, R, rays)
            img_single = sp.splat_image(buckets, basis="deg8", **SPLAT_TILE)
            target = 1.01 * img_single

            def splat_step(mesh):
                """dryrun_multichip's data-parallel step: the rank's
                particles rendered, images summed (``allreduce_sum``), L2
                loss; without a mesh, the single-device step."""
                blk = ss if mesh is None else mh.global_to_host_local(mesh, R, ss)
                s = blk.detach().clone().requires_grad_(True)
                w = torch.ones(s.shape[0], device=dev, requires_grad=True)
                img = render(s, w)
                if mesh is not None:
                    img = sh.allreduce_sum(img, mesh)
                loss = ((img - target) ** 2).sum()
                loss.backward()
                return loss.detach(), s.grad, w.grad

            sd, rays_d, targets_d, clump, through = dryrun_scene(dev)
            cap, leaf, lr = DRYRUN["capacity"], DRYRUN["max_per_leaf"], DRYRUN["lr"]
            ssd, treed, _ = build_sph_tree(sd, leaf)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            counters = _path7_counters()
            for fn in counters.values():
                fn.launches = 0
            got = {
                "bitmask": sh.sharded_pallas_render(mesh, local_rays, ss, tile=TRACE_TILE),
                "quarter": sh.sharded_pallas_render(mesh, local_rays, ss, tile=TRACE_TILE,
                                                    broadphase="quarter"),
                "ring": sh.ring_pallas_render(mesh, local_rays,
                                              mh.global_to_host_local(mesh, S, ss),
                                              tile=TRACE_TILE),
                "splat": sh.sharded_splat_render(mesh, buckets, basis="deg8", **SPLAT_TILE),
                "splat step": splat_step(mesh),
                "replicated": sh.replicated_sharded_render(
                    mesh, mh.global_to_host_local(mesh, R, rays_d), ssd, treed, cap),
                "train": sh.sharded_train_step(mesh, mh.global_to_host_local(mesh, R, rays_d),
                                               mh.global_to_host_local(mesh, S, sd),
                                               mh.global_to_host_local(mesh, R, targets_d),
                                               cap, leaf, lr),
                "undersized": sh.sharded_train_step(mesh, through, clump,
                                                    torch.zeros_like(targets_d), 4, leaf, lr),
            }
            if dev.type == "cuda":
                torch.cuda.synchronize()
            out["launches"] = {k: fn.launches for k, fn in counters.items()}

            want = {"bitmask": pk.pallas_trace_sph(rays, ss, tile=TRACE_TILE,
                                                   broadphase="bitmask"),
                    "quarter": pk.pallas_trace_sph(rays, ss, tile=TRACE_TILE,
                                                   broadphase="quarter")}
            want["ring"] = want["bitmask"]
            for route in ("bitmask", "quarter", "ring"):
                (v, ovf), (v1, _) = got[route], want[route]
                check_equal(f"path 7 {route} vs the single-device trace", v, v1)
                if bool(ovf):
                    raise AssertionError(f"path 7 {route}: overflow flag set")
            check_equal("path 7 sharded_splat_render vs splat_image", got["splat"], img_single)
            lines.append(f"sharded_pallas_render (bitmask, quarter), ring_pallas_render "
                         f"(hoisted masks) and sharded_splat_render (banded, deg8) on "
                         f"{rays.n_rays} rays and {ss.shape[0]} particles: bit-equal to "
                         "the calls without the mesh, no overflow")
            single = splat_step(None)
            for name, a, b in zip(("loss", "particle gradients", "weight gradients"),
                                  got["splat step"], single):
                if not bool(torch.isfinite(a).all()):
                    raise AssertionError(f"path 7 splat step: non-finite {name}")
                check_equal(f"path 7 splat step {name} vs make_splat_trainer's", a, b)
            lines.append(f"data-parallel splat step through allreduce_sum: loss "
                         f"{float(got['splat step'][0]):.6g}, loss and gradients bit-equal "
                         "to make_splat_trainer's")

            img1 = integrate_hits(find_hits(rays_d, ssd, treed, cap), rays_d, ssd, rays_d.n_rays)
            img_r, ovf_r = got["replicated"]
            check_close("path 7 replicated_sharded_render vs the engine", img_r, img1, 1e-5, 0.0)
            new1, loss1 = engine_train_step(sd, rays_d, targets_d, cap, leaf, lr)
            new, loss, ovf_t = got["train"]
            check_close("path 7 sharded_train_step loss vs the engine", loss, loss1, 1e-5, 0.0)
            upd1 = new1 - sd
            check_close("path 7 sharded_train_step update", new - sd, upd1, 1e-5,
                        1e-5 * float(upd1.abs().max()))
            if bool(ovf_r) or bool(ovf_t) or not bool(torch.isfinite(new).all()):
                raise AssertionError("path 7 dryrun size: overflow or a non-finite update")
            flag = got["undersized"][2]
            if not bool(flag):
                raise AssertionError("path 7: an undersized capacity did not set the flag")
            try:
                check_overflow(flag, "sharded train step hit-capacity overflow")
            except GraceError:
                pass
            else:
                raise AssertionError("path 7: check_overflow did not raise on the flag")
            lines.append(f"dryrun size ({sd.shape[0]} particles, {rays_d.n_rays} rays): "
                         f"replicated_sharded_render and sharded_train_step (loss "
                         f"{float(loss):.6g}) within rtol 1e-5 of the engine's render, loss "
                         "and update; capacity 4 sets the flag and check_overflow raises")
            if time_routes:
                out["times"] = sharded_times(mesh, scene, splat_step,
                                             (sd, rays_d, targets_d, ssd, treed))
        finally:
            dist.destroy_process_group()
    out["lines"] = lines
    return out


def path7_line(times, launches, wall_s):
    """The one line of path 7's times: each route beside its single-device
    call, and the share of the route that the collectives it runs take
    when timed alone."""
    parts = [f"{name} {ms:.3f} ms (single-device {one:.3f} ms; collectives {coll:.3f} ms, "
             f"{100 * coll / ms:.1f}%)" for name, (ms, one, coll) in times.items()]
    return (f"main path 7 (sharded routes on one NCCL rank, mesh (1, 1); the bench scene and "
            f"dryrun_multichip's sizes): {wall_s:.2f} s wall with the timing; "
            + "; ".join(parts) + f"; launches {launches}; rings of 2 and 4 and meshes of "
            "2 x 2 run in tests/test_torch_parallel.py on the CPU (gloo), not on this one card")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms, flops, n_bytes,
                 by_path=None, library_ms=None):
    """One kernel of the JSON line, with its bound: the larger of its flops
    over the FP32 peak and its bytes over the memory rate. ``by_path``:
    its launches on each main path (``launches`` is then their sum);
    ``library_ms``: one PyTorch call's time for the same function."""
    t_ops = flops / PEAK_FLOPS * 1e3
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    log(f"bound {name}: {flops:.6g} flops -> {t_ops:.4f} ms, {n_bytes} bytes -> "
        f"{t_bytes:.4f} ms; kernel {ms:.3f} ms")
    entry = {"name": name, "route": "cuda", "source": f"grace_tpu_torch/csrc/{source}",
             "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
             "bound_by": "operations" if t_ops >= t_bytes else "bytes",
             "library_ms": library_ms}
    if by_path is not None:
        entry["launches_by_path"] = by_path
    return entry


def with_extra(entry, extra):
    """``entry`` with the keys of ``extra`` (if any) added."""
    entry.update(extra or {})
    return entry


def _bound(work):
    flops, n_bytes = work
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def keys_extra(t, work):
    """E2's keys beyond the build's call: the kernel's device time in it
    (the box folded in the launch), the given-box launch, and main path 1's
    rays (their midpoints' keys, the box in the launch); None where the
    profiler saw no launch (not measured)."""
    device = lambda label: t.get(f"build_morton_keys device (profiler; the kernel alone{label})")
    return {"device_ms": device(""),
            "given_box": {"ms": t["build_morton_keys kernel (given box)"],
                          "device_ms": device(" (given box)"),
                          "plain_ms": t["build_morton_keys plain (given box)"]},
            "rays": {"ms": t["build_morton_keys kernel (path 1's rays)"],
                     "device_ms": device(" (path 1's rays)"),
                     "plain_ms": t["build_morton_keys plain (path 1's rays)"],
                     **_bound(work["build_morton_keys (path 1's rays)"])}}


def compact_extra(t, work):
    """E6's compaction at each main-path shape: the call, the kernel's
    device time (None: not measured) and the bound; "device_ms" that of
    the entry's own case."""
    shapes = [k[len("compact_words ("):-1] for k in work if k.startswith("compact_words (")]
    device = lambda label: t.get(f"compact_words device (profiler; the kernel alone, {label})")
    return {"device_ms": device("quarter words, tile 64, max_q 512"),
            "shapes": {label: {"ms": t[f"compact_words kernel ({label})"],
                               "device_ms": device(label),
                               **_bound(work[f"compact_words ({label})"])}
                       for label in shapes}}


def boxes_entry(t, work, by_path):
    """E6's boxes in the kernels line: one entry for the one launch (both
    parts at path 1's quarters and tile 128), with "device_ms" by the
    profiler and "parts": each part alone, its call, device and plain
    times and its bound (the checks held both parts equal to the plain
    versions: max_abs_err 0)."""
    def bound(name):
        flops, n_bytes = work[name]
        t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
        return {"bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes"}

    label = "quarters and tile 128"
    entry = kernel_entry("broadphase_boxes", "broadphase.cu",
                         "grace_tpu/trace/pallas_broadphase.py:43, "
                         "grace_tpu/trace/broadphase.py:38",
                         sum(p["broadphase_boxes"] for p in by_path.values()), 0.0,
                         t[f"broadphase_boxes kernel ({label})"],
                         t[f"broadphase_boxes plain ({label})"], *work["broadphase_boxes"],
                         by_path={f"path {k}": v["broadphase_boxes"] for k, v in by_path.items()})
    device = lambda label: t.get(f"broadphase_boxes device (profiler; the kernel alone, {label})")
    entry["device_ms"] = device(label)
    entry["parts"] = {
        part: {"max_abs_err": 0.0, "ms": t[f"broadphase_boxes kernel ({label})"],
               "device_ms": device(label), "plain_ms": t[f"broadphase_boxes plain ({label})"],
               **bound(f"broadphase_boxes ({part})")}
        for part, label in (("segment part", "segment part, quarters"),
                            ("tile part", "tile part, tile 128"))}
    return entry


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
    from grace_tpu_torch.trace import splat_grad as sg
    from grace_tpu_torch.sph.kernel_integrals import DENSE_KERNEL_INTEGRAL_TABLE

    t_start = time.perf_counter()
    # 1. build every kernel, one nvcc each, all at once
    for name, (path, seconds, out) in _kernels.build_all().items():
        ptxas = [l.strip() for l in out.splitlines() if "registers" in l or "spill" in l]
        log(f"build {name}: {seconds:.1f} s -> {path}")
        for line in ptxas:
            log(f"  ptxas {name}: {line}")
    # what one launch of each kernel redesigned for the card holds
    for label, name, entry, ints in (
            ("trace_bitmask (tile 128)", "trace_bitmask", "grace_trace_bitmask_resources",
             (TRACE_TILE,)),
            ("trace_list (tile 128)", "trace_list", "grace_trace_list_resources", (TRACE_TILE,)),
            ("trace_tri (tile 32)", "tri", "grace_tri_resources", (32,)),
            ("render_bwd", "render", "grace_render_bwd_resources", ()),
            ("records_quarter (tile 64)", "records", "grace_records_quarter_resources", (64,)),
            ("records_bitmask (tile 64)", "records", "grace_records_bitmask_resources", (64,)),
            (f"splat (32 x 32 patch, deg8, batch {sp.SPLAT_BATCH})", "splat",
             "grace_splat_resources", (32, 32, 5, 8, sp.SPLAT_BATCH)),
            (f"splat_sortfree_fwd (32 x 32 patch, deg8, batch {sg.FWD_BATCH})", "splat_sortfree",
             "grace_splat_sortfree_fwd_resources", (32, 32, 5, 8, sg.FWD_BATCH)),
            ("splat_sortfree_bwd (32 x 128 tile, deg8)", "splat_sortfree",
             "grace_splat_sortfree_bwd_resources", (32, 128, 5, 8)),
            ("render_fwd (tile 128)", "render", "grace_render_fwd_resources", (TRACE_TILE,))):
        log(f"resources {label}: {json.dumps(_kernels.resources(name, entry, dev, *ints))}")
    from grace_tpu_torch.trace import walk as wk

    from grace_tpu_torch.build import lbvh

    for kernel in lbvh.RESOURCE_KERNELS:
        for is_float in ((True, False) if kernel.startswith("lbvh") else (True,)):
            label = f"build_{kernel}" + ("" if is_float else " (int64 deltas)")
            res = lbvh.build_resources(dev, kernel, is_float)
            log(f"resources {label}: {json.dumps(res)}")
            if kernel.startswith("morton") and res["local_bytes"]:
                raise AssertionError(f"the {label} kernel uses local memory: {res}")
    for kind, mode in (("sph", "cumulative"), ("tri", "closest"), ("tri", "any")):
        for route in wk.ROUTES:
            log(f"resources bvh_walk_{kind} ({mode}, {route}): "
                f"{json.dumps(wk.walk_resources(dev, kind, mode, route))}")
    from grace_tpu_torch.ops import segops

    for label, res in (("overlap_words (csrc/broadphase.cu)", pb.overlap_words_resources(dev)),
                       ("broadphase_boxes (16-byte rays; csrc/broadphase.cu)",
                        pb.broadphase_boxes_resources(dev)),
                       ("broadphase_boxes (4-byte rays; csrc/broadphase.cu)",
                        pb.broadphase_boxes_resources(dev, vec=False)),
                       ("compact_words (16-byte word loads; csrc/broadphase.cu)",
                        pb.compact_words_resources(dev)),
                       ("compact_words (4-byte word loads; csrc/broadphase.cu)",
                        pb.compact_words_resources(dev, vec=False)),
                       ("sortfree_setup (csrc/splat_prep.cu)", sg.sortfree_setup_resources(dev))):
        log(f"resources {label}: {json.dumps(res)}")
        if res["local_bytes"]:
            raise AssertionError(f"the {label} kernel uses local memory: {res}")
    # the triangle lists' four instances at path 5's shapes (2,048 segments,
    # 16 intervals): 16-byte and 4-byte rows, boxes staged and from device
    # memory
    from grace_tpu_torch.trace import pallas_tri as pt

    for label, max_chunks, stage in (("16-byte rows, staged boxes", 2048, None),
                                     ("4-byte rows, staged boxes", 2046, None),
                                     ("16-byte rows, boxes from device memory", 2048, 0),
                                     ("4-byte rows, boxes from device memory", 2046, 0)):
        res = pt.tri_tile_lists_resources(dev, TORUS_SEGMENTS, max_chunks, _stage=stage)
        log(f"resources tri_tile_lists ({label}; csrc/tri_lists.cu): {json.dumps(res)}")
    for kernel in segops.RESOURCE_KERNELS:   # the sort kernels with path 4's three arrays
        res = segops.segsort_resources(dev, kernel)
        log(f"resources segsort {kernel}: {json.dumps(res)}")
        if res["local_bytes"]:
            raise AssertionError(f"segsort.cu's {kernel} kernel uses local memory: {res}")

    # 2. the build's kernels vs the plain build (check_build); kernels vs
    # plain versions at small and edge shapes; routes vs the engine; the
    # driver entry's forward
    t_check = time.perf_counter()
    build_lines, build_errs = check_build(dev)
    for line in build_lines:
        log(f"check_build {line} OK")
    log(f"check_build: {len(build_lines)} cases in {time.perf_counter() - t_check:.1f} s")
    t_check = time.perf_counter()
    key_lines = check_keys(dev, orthographic_projection_rays(side, side, CAM, LOOK, UP, VEXT,
                                                             LENGTH, device=dev))
    for line in key_lines:
        log(f"check_keys {line} OK")
    log(f"check_keys: {len(key_lines)} cases in {time.perf_counter() - t_check:.1f} s")
    t_check = time.perf_counter()
    for line in check_splat_prep(dev):
        log(f"check_splat_prep {line} OK")
    log(f"check_splat_prep: {len(SPLAT_PREP_CASES)} cases in "
        f"{time.perf_counter() - t_check:.1f} s")
    t_check = time.perf_counter()
    for line in check_broadphase(dev):
        log(f"check_broadphase {line} OK")
    for line in check_tri_lists(dev):
        log(f"check_tri_lists {line} OK")
    log(f"check_broadphase, check_tri_lists: {len(BROADPHASE_CASES)} and {len(TRI_LIST_CASES)} "
        f"cases in {time.perf_counter() - t_check:.1f} s")
    t_check = time.perf_counter()
    seg_lines, seg_departures = check_segsort(dev)
    for line in seg_lines:
        log(f"check_segsort {line} OK")
    log(f"check_segsort: {len(seg_lines)} cases in {time.perf_counter() - t_check:.1f} s; the "
        f"card's plain versions depart from grace_tpu's order on {len(seg_departures)} of them "
        f"{json.dumps(seg_departures)}")
    card_order, cpu_order = torch_sort_orders(dev)
    log(f"torch.sort(stable=True) of the special keys, by their bits: on the card "
        f"{' '.join(card_order)}; on the CPU {' '.join(cpu_order)}")
    small_checks(dev)
    splat_edge_checks(dev)
    training_small_checks(dev)
    records_small_checks(dev)
    tri_small_checks(dev)
    for line in walk_small_checks(dev):
        log(f"check bvh_walk kernel vs plain walk: {line} OK")
    entry_args = entry_check(dev)

    # 3. main path 1, the column-density render on the bench scene
    particles = make_clustered_particles(np.random.default_rng(2026), n_particles)
    spheres = torch.from_numpy(particles).to(dev)
    torch.cuda.synchronize()
    pk.trace_quarter.launches = 0
    sp.splat_image.launches = 0
    zero_build_counters()
    zero_prep_counters()
    zero_broadphase_counters()
    zero_segsort_counters()
    t0 = time.perf_counter()
    scene = bench_scene(spheres, side)
    sorted_spheres, tree, rays_s, inv, buckets = (
        scene[k] for k in ("spheres", "tree", "rays", "inv", "buckets"))
    if bool(buckets.overflow):
        raise AssertionError("splat tile overflow at the bench scene")
    img = sp.splat_image(buckets, basis="deg8", **SPLAT_TILE)
    trace_v, ovf = pk.pallas_trace_sph(rays_s, sorted_spheres, tree, tile=TRACE_TILE,
                                       broadphase="quarter")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    build_by_path = {1: build_counters()}
    prep_by_path = {1: prep_counters()}
    bp_by_path = {1: gate_broadphase(1)}
    seg_by_path = {1: gate_segsort(1)}
    launches = {"trace_quarter": pk.trace_quarter.launches,
                "splat": sp.splat_image.launches, **path_build_counters(build_by_path[1]),
                "splat_bucket_keys": prep_by_path[1]["splat_bucket_keys"],
                "splat_bucket_pack": prep_by_path[1]["splat_bucket_pack"]}
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
    pk.trace_list.launches_seg = 0
    zero_build_counters()
    zero_prep_counters()
    zero_broadphase_counters()
    zero_segsort_counters()
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
    build_by_path[2] = build_counters()
    prep_by_path[2] = prep_counters()
    bp_by_path[2] = gate_broadphase(2)
    seg_by_path[2] = gate_segsort(2)
    launches2 = {"trace_bitmask": pk.trace_bitmask.launches,
                 "trace_list": pk.trace_list.launches - pk.trace_list.launches_seg,
                 "trace_list_seg": pk.trace_list.launches_seg}
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
    sl_args = route_inputs("list", rays_s, sorted_spheres, tree, TRACE_TILE, caps["list"])[2]
    errs = {}
    for name, kernel, plain, args in (
            ("trace_bitmask", pk.trace_bitmask, pk._trace_bitmask_plain, bm_args),
            ("trace_list", pk.trace_list, pk._trace_list_plain, ql_args),
            ("trace_list_seg", pk.trace_list, pk._trace_list_plain, sl_args)):
        errs[name], top = check_kernel(f"full {name}", kernel, plain, args, "cumulative", 14)
        check_kernel(f"full {name}", kernel, plain, args, "hitcount", 14)
        log(f"check {name} kernel vs plain on all {packed.shape[0] // TRACE_TILE} tiles "
            f"(cumulative deg 14, hitcount): max abs err {errs[name]:.3g} "
            f"(max value {top:.3g}) OK")
    splat_err, top = check_splat("full", buckets, "deg8", **SPLAT_TILE)
    prep_errs = {}
    for label, w in (("weights None", None),
                     ("weights 1", torch.ones(n_particles, device=dev))):
        errs_w, _ = check_splat_prep_case(f"bench scene, {label}", sorted_spheres, w, side,
                                          (SPLAT_TILE["tile_w"], SPLAT_TILE["tile_h"]), 32, 512)
        prep_errs = {k: max(v, prep_errs.get(k, 0.0)) for k, v in errs_w.items()}
        log(f"check_splat_prep bench scene ({n_particles} sorted particles, {side}x{side}, "
            f"{label}): every SplatBuckets field and the sort-free masks, transposed masks, "
            f"coords and slabs bit-equal to the plain versions OK")
    log(f"check splat kernel vs plain at {side}x{side}: max abs err {splat_err:.3g} "
        f"(max value {top:.3g}) OK")
    for tile in (TRACE_TILE, 64):
        _, signs, max_qs, most_s = check_broadphase_case(
            f"bench scene, tile {tile}", sorted_spheres, rays_s, tile)
        log(f"check_broadphase bench scene ({n_particles} sorted particles, {side}x{side} sorted "
            f"rays, tile {tile}): boxes equal ({signs} zero signs apart), segment and quarter "
            f"words, summary, quarter_lists, dense_tile_segments, dense_segment_tiles and the "
            f"compaction at max_q {list(max_qs)} bit-equal to the plain versions (most listed "
            f"segments a tile {most_s}) OK")
    for line in check_compaction(dev, compaction_shapes(sorted_spheres, rays_s), tags=()):
        log(f"check_compaction bench scene, {line} OK")
    for line in bench_word_counts(sorted_spheres, rays_s):
        log(line)

    # 6. main path 3, training on the same scene: one step of each trainer
    from grace_tpu_torch.trace import pallas_render as pr

    n_rays = side * side
    cam = sg.OrthoCamera(CAM, LOOK, UP, VEXT, LENGTH, side, side)
    weights = torch.ones(n_particles, device=dev)
    target2d = img_trace * 1.01
    target = trace_v * 1.01
    splat_render = sg.make_splat_trainer(cam, basis="deg8", **SPLAT_TILE)
    fused_render = pr.make_fused_renderer(tile=TRACE_TILE, max_chunks=2048,
                                          max_tiles_per_seg=2048, return_overflow=True)

    def train_step(render, target):
        """One step: forward, L2 loss, backward, SGD 1e-6. Returns (new
        spheres, new weights, loss, forward output, overflow, gradients
        finite)."""
        s = sorted_spheres.detach().clone().requires_grad_(True)
        w = weights.detach().clone().requires_grad_(True)
        out = render(s, w)
        values, ovf = out if isinstance(out, tuple) else (out, None)
        loss = ((values - target) ** 2).sum() / n_rays
        loss.backward()
        finite = torch.isfinite(s.grad).all() & torch.isfinite(w.grad).all()
        return (s.detach() - 1e-6 * s.grad, w.detach() - 1e-6 * w.grad, loss.detach(),
                values.detach(), ovf, finite)

    splat_step = lambda: train_step(splat_render, target2d)
    general_step = lambda: train_step(lambda s, w: fused_render(rays_s, s, w), target)
    torch.cuda.synchronize()
    for fn in (sg.splat_sortfree_fwd, sg.splat_sortfree_bwd, pr.render_fwd, pr.render_bwd):
        fn.launches = 0
    zero_build_counters()
    zero_prep_counters()
    zero_broadphase_counters()
    zero_segsort_counters()
    t0 = time.perf_counter()
    steps = {"splat": splat_step(), "general": general_step()}
    torch.cuda.synchronize()
    wall3 = time.perf_counter() - t0
    build_by_path[3] = build_counters()
    prep_by_path[3] = prep_counters()
    bp_by_path[3] = gate_broadphase(3)
    seg_by_path[3] = gate_segsort(3)
    launches3 = {"splat_sortfree_fwd": sg.splat_sortfree_fwd.launches,
                 "splat_sortfree_bwd": sg.splat_sortfree_bwd.launches,
                 "render_fwd": pr.render_fwd.launches, "render_bwd": pr.render_bwd.launches,
                 "sortfree_setup": prep_by_path[3]["sortfree_setup"]}
    if min(launches3.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches3}")
    for name, (s1, w1, loss, _, ovf, finite) in steps.items():
        if not (bool(torch.isfinite(loss)) and bool(torch.isfinite(s1).all())
                and bool(torch.isfinite(w1).all())):
            raise AssertionError(f"{name} step: non-finite loss or update")
        if not bool(finite):
            raise AssertionError(f"{name} step: NaN-poisoned or non-finite gradients")
        if ovf is not None and bool(ovf):
            raise AssertionError(f"{name} step: forward list overflow")
    img_sf = steps["splat"][3]
    # grace_tpu's two splat paths place pixel centers by different formulas
    # (x0 + i dx here, the bucketing's affine map there), up to 1.3e-7 apart;
    # at the bench scene's h >= 0.005 that moves the image by up to 2.9e-5 x
    # max in grace_tpu itself, so the bound is 1e-4 x max, not 1e-5.
    sf_err, sf_top = check_close("sort-free image vs bucketed splat", img_sf, img, 0.0,
                                 1e-4 * float(img.abs().max()))
    sf_rel = float((img_sf - img_trace).abs().max() / img_trace.abs().max())
    if not sf_rel < GATE:
        raise AssertionError(f"sort-free image vs trace rel err {sf_rel:.3g} >= {GATE}")
    fused_v = steps["general"][3]
    fused_err, _ = check_close("fused forward vs quarter trace", fused_v, trace_v, 0.0,
                               5e-4 * float(trace_v.abs().max()))
    log(f"main path 3 (training, {n_particles} particles, {side}x{side} rays): "
        f"{wall3:.2f} s wall for both steps; splat loss {float(steps['splat'][2]):.6g}, "
        f"general loss {float(steps['general'][2]):.6g}; sort-free image vs bucketed "
        f"splat max abs err {sf_err:.3g} (max value {sf_top:.3g}), vs trace rel err "
        f"{sf_rel:.3e} (gate {GATE}); fused forward vs trace max abs err {fused_err:.3g} "
        f"(gate {5e-4 * float(trace_v.abs().max()):.3g}); no overflow, no poison; "
        f"launches {launches3}")

    # 7. the training kernels vs their plain versions at main path 3's shapes
    sf_inputs = sortfree_inputs(sorted_spheres, weights, cam, SPLAT_TILE["tile_w"])
    g_image = 2.0 * (img_sf - target2d) / n_rays
    errs["sortfree_fwd"], errs["sortfree_bwd"] = check_sortfree(
        "full", sf_inputs, g_image, "deg8", SPLAT_TILE["tile_w"], 3e-5)
    g_rays = 2.0 * (fused_v - target) / n_rays
    fwd_args, ovf, bwd_args, ovf_t = render_inputs(rays_s, sorted_spheres, weights, g_rays,
                                                   TRACE_TILE, 2048, 2048)
    if bool(ovf.any()) or bool(ovf_t.any()):
        raise AssertionError("fused renderer lists overflow at the bench scene")
    errs["render_fwd"], errs["render_bwd"] = check_render("full", fwd_args, bwd_args)

    # 8. main path 4, per-hit records on main path 1's scene and sorted rays
    from grace_tpu_torch.ops.segops import sort_by_distance
    from grace_tpu_torch.trace import pallas_records as prc
    from grace_tpu_torch.trace.sph import trace_sph

    torch.cuda.synchronize()
    prc.records_quarter.launches = 0
    prc.records_bitmask.launches = 0
    zero_build_counters()
    zero_prep_counters()
    zero_broadphase_counters()
    zero_segsort_counters()
    t0 = time.perf_counter()
    rec = prc.pallas_trace_sph_records(rays_s, sorted_spheres, RECORD_CAP)
    rec_b = prc.pallas_trace_sph_records(rays_s, sorted_spheres, RECORD_CAP,
                                         broadphase="bitmask")
    rec_sorted = prc.sort_records_by_distance(rec)
    total_hits = int(rec.counts.sum())
    flat = trace_sph(rays_s, sorted_spheres, tree, capacity=total_hits, engine="pallas",
                     per_ray_capacity=RECORD_CAP)
    flat_sorted = sort_by_distance(flat.distances, flat.offsets, flat.indices, flat.integrals,
                                   total_hits=flat.total_hits)
    torch.cuda.synchronize()
    wall4 = time.perf_counter() - t0
    build_by_path[4] = build_counters()
    prep_by_path[4] = prep_counters()
    bp_by_path[4] = gate_broadphase(4)
    seg_by_path[4] = gate_segsort(4)
    launches4 = {"records_quarter": prc.records_quarter.launches,
                 "records_bitmask": prc.records_bitmask.launches, **seg_by_path[4]}
    if min(launches4.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches4}")
    rec_stats = records_gates(rec, rec_b, rec_sorted, flat, quarter_hc, trace_v)
    seg_stats = segsort_gate(rec, rec_sorted, flat, flat_sorted)
    del rec_b, rec_sorted, flat_sorted
    log(f"main path 4 (per-hit records, {n_particles} particles, {side}x{side} rays, "
        f"capacity {RECORD_CAP}): {wall4:.2f} s wall; {total_hits} hits, counts equal the "
        f"quarter trace's on every ray; {rec_stats}; {seg_stats}; launches {launches4}")
    # the three segsort entries against their plain versions on the card, on
    # path 4's records, bit for bit; E10 also against its plain version run
    # on the CPU (no sort in it: the card's plain version must agree too)
    for kind, args in (("rows", rec), ("flat", (rec, total_hits, {})),
                       ("csr", (flat.distances, flat.offsets, flat.indices, [flat.integrals],
                                flat.total_hits))):
        apart, _ = check_segsort_case(kind, "path 4", args, reference=kind == "flat")
        if apart:
            raise AssertionError(f"path 4 {kind}: the card's plain version departs at {apart}")
    log(f"check_segsort path 4: sort_rows on {rec.indices.shape[0]} rows of {RECORD_CAP}, "
        f"records_to_flat into {total_hits} entries (also against its plain version on the "
        f"CPU), segmented_sort of the flat layout "
        f"({flat.offsets.shape[0]} rays' segments, the longest {int(rec.counts.max())} "
        f"clamped to {RECORD_CAP}) bit-equal to their plain versions OK")

    # 9. main path 5, triangles: render_triangles on the CUDA kernel
    from grace_tpu_torch.models import triangle as mt
    from grace_tpu_torch.trace import pallas_tri as pt

    tris = torch.from_numpy(torus_mesh(**TORUS)).to(dev)
    torch.cuda.synchronize()
    pt.trace_tri.launches = 0
    pt.trace_tri.launches_any = 0
    zero_build_counters()
    zero_prep_counters()
    zero_broadphase_counters()
    zero_segsort_counters()
    t0 = time.perf_counter()
    tri_img = mt.render_triangles(tris, resolution=side, engine="pallas")
    torch.cuda.synchronize()
    wall5 = time.perf_counter() - t0
    build_by_path[5] = build_counters()
    prep_by_path[5] = prep_counters()
    bp_by_path[5] = gate_broadphase(5)
    seg_by_path[5] = gate_segsort(5)
    launches5 = {"trace_tri closest": pt.trace_tri.launches - pt.trace_tri.launches_any,
                 "trace_tri any": pt.trace_tri.launches_any,
                 **path_build_counters(build_by_path[5])}
    if min(launches5.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches5}")
    tri_state = triangle_gates(tris, tri_img, side)
    log(f"main path 5 (triangles, {tris.shape[0]} triangle torus, {side}x{side} pinhole "
        f"rays): {wall5:.2f} s wall; {tri_state['summary']}; launches {launches5}")

    # 10. the record and triangle kernels vs their plain versions at the main
    # paths' shapes, every tile
    rq_args = records_inputs("quarter", rays_s, sorted_spheres, 64)[2]
    rb_args = records_inputs("bitmask", rays_s, sorted_spheres, 64)[2]
    plain_ms = {}
    for name, kernel, plain, args in (
            ("records_quarter", prc.records_quarter, prc._records_quarter_plain, rq_args),
            ("records_bitmask", prc.records_bitmask, prc._records_bitmask_plain, rb_args)):
        errs[name + " integral"], errs[name + " distance"], _, plain_ms[name] = check_records(
            f"full {name}", kernel, plain, args, RECORD_CAP)
        log(f"check {name} kernel vs plain on all {args[-2].shape[0] // 64} tiles, capacity "
            f"{RECORD_CAP}: counts and indices equal, integrals max abs err "
            f"{errs[name + ' integral']:.3g}, distances {errs[name + ' distance']:.3g} OK")
    tri_args = tri_state["args"]
    for mode in ("closest", "any"):
        errs["tri " + mode], hits, visited, plain_ms["tri " + mode] = check_tri(
            f"full tri {mode}", tri_args, mode)
        tri_state["visited " + mode] = int(visited.sum())
        log(f"check trace_tri kernel vs plain on all {visited.shape[0]} tiles ({mode}): ids "
            f"equal, {hits} hits, t max abs err {errs['tri ' + mode]:.3g}, "
            f"{int(visited.sum())} chunks visited OK")
    torus_sets = (tri_state["sorted_tris"], {"primary": tri_state["rays_clipped"],
                                             "shadow": tri_state["shadow_clipped"]})
    for line in check_tri_lists(dev, torus_sets, edge_cases=False):
        log(f"check_tri_lists {line} OK")

    # 11. main path 6, a Gadget snapshot through random and HEALPix rays
    zero_build_counters()
    zero_prep_counters()
    zero_broadphase_counters()
    zero_segsort_counters()
    path6 = snapshot_path(dev, particles)
    build_by_path[6] = build_counters()
    prep_by_path[6] = prep_counters()
    bp_by_path[6] = gate_broadphase(6)
    seg_by_path[6] = gate_segsort(6)
    launches6 = {**path6["launches"], **path_build_counters(build_by_path[6])}
    if min(launches6.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches6}")
    for line in path6["lines"]:
        log(f"check path 6 {line} OK")
    log(f"main path 6 (Gadget snapshot, {n_particles} particles, random and HEALPix rays): "
        f"{path6['ms'] / 1e3:.2f} s wall; launches {launches6}")
    inputs6 = snapshot_inputs(path6["ray_sets"], path6["spheres"], path6["tree"])
    errs6, plain6, check6 = snapshot_kernel_checks(inputs6, PATH6_FULL)
    for line in check6:
        log(f"check path 6 {line} OK")
    t6, k6, work6, lines6 = snapshot_times(dev, path6["ray_sets"], inputs6, path6["spheres"],
                                           path6["tree"], path6["iso_dirs"])
    del inputs6
    for k, v in {**path6["wall"], **t6}.items():
        log(f"time path 6 {k}: {v:.3f} ms" + (" (wall clock)" if k in path6["wall"] else ""))
    for (name, kernel, mode), v in k6.items():
        log(f"time path 6 {kernel} kernel ({name}, {mode}): {v:.3f} ms")
    for line in lines6:
        log(f"work path 6 {line}")
    # the path's trace calls: both routes in both modes on every ray set but
    # the integral field's, which takes one default cumulative trace. The
    # sum is of warm medians timed after the path, so the share is an
    # estimate: the path's own first launches ran cold.
    in_kernels = sum(v for (name, kernel, mode), v in k6.items()
                     if name != "integral" or (kernel, mode) == ("trace_bitmask", "cumulative"))
    log(f"path 6 share of its wall time in B3 and B6, estimated from warm medians: "
        f"{in_kernels:.3f} ms of {path6['ms']:.3f} ms ({100 * in_kernels / path6['ms']:.2f}%)")

    # 11b. main path 7, the sharded routes on one NCCL rank
    t7 = time.perf_counter()
    zero_build_counters()
    zero_prep_counters()
    zero_broadphase_counters()
    zero_segsort_counters()
    path7 = sharded_path(dev, scene, time_routes=True)
    wall7 = time.perf_counter() - t7
    build_by_path[7] = build_counters()
    prep_by_path[7] = prep_counters()
    bp_by_path[7] = gate_broadphase(7)
    seg_by_path[7] = gate_segsort(7)
    launches7 = {**path7["launches"], **path_build_counters(build_by_path[7])}
    if min(launches7.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches7}")
    for line in path7["lines"]:
        log(f"check path 7 {line} OK")
    log(path7_line(path7["times"], launches7, wall7))

    # 11c. main path 8, the generic engine's walk on the card
    zero_build_counters()
    zero_prep_counters()
    zero_broadphase_counters()
    zero_segsort_counters()
    path8 = engine_path(dev, scene, tris, entry_args, side)
    build_by_path[8] = build_counters()
    prep_by_path[8] = prep_counters()
    bp_by_path[8] = gate_broadphase(8)
    seg_by_path[8] = gate_segsort(8)
    launches8 = {**path8["launches"], **path_build_counters(build_by_path[8])}
    if min(launches8.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches8}")
    if path8["plain_calls"] != 0:
        raise AssertionError(f"path 8 entered the plain walk {path8['plain_calls']} times")
    for line in path8["lines"]:
        log(f"check path 8 {line} OK")
    log(f"main path 8 (the engine's walk: entry forward, bench scene counts, sums and records, "
        f"torus render): {path8['wall']:.2f} s wall; the plain walk entered 0 times; "
        f"launches {launches8}")

    # 12. times (CUDA events, warm, median; the plain versions ran warm in 5, 7 and 10)
    t = {}
    t["build_sph_tree"] = cuda_ms(lambda: build_sph_tree(spheres, MAX_PER_LEAF), reps=3)
    t["rays+sort"] = cuda_ms(lambda: spatial_sort_rays(orthographic_projection_rays(
        side, side, CAM, LOOK, UP, VEXT, LENGTH, device=dev)))
    prep_t, prep_work = splat_prep_times(sorted_spheres, weights, cam, side)
    t.update(prep_t)
    a8, b8 = (np.asarray(c, np.float32) for c in sp.SPLAT_BASES["deg8"][1:])
    t["splat kernel"] = cuda_ms(lambda: sp.splat_image(buckets, basis="deg8", **SPLAT_TILE))
    t["splat_key_order"] = cuda_ms(lambda: sp.splat_key_order(buckets.first, buckets.last))
    t["splat dense contraction (csrc/splat_dense.cu)"] = cuda_ms(
        lambda: splat_dense(buckets, 32, 32, "deg8"))
    t["splat plain"] = cuda_ms(lambda: sp._splat_plain(buckets, 32, 32, a8, b8), reps=3)

    def splat_frame():
        s, _, _ = build_sph_tree(spheres, MAX_PER_LEAF)
        spatial_sort_rays(orthographic_projection_rays(side, side, CAM, LOOK, UP, VEXT, LENGTH,
                                                       device=dev))
        return sp.splat_image(sp.bucket_prims_ortho(s, CAM, LOOK, UP, VEXT, LENGTH, side, side,
                                                    chunk=512, band=32, **SPLAT_TILE),
                              basis="deg8", **SPLAT_TILE)

    t["splat frame (build, rays + sort, bucket, splat)"] = cuda_ms(splat_frame, reps=3)
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
    t["bitmask_tile_order"] = cuda_ms(lambda: pk.bitmask_tile_order(bm_args[0]))
    t["list_tile_order (segment lists)"] = cuda_ms(
        lambda: pk.list_tile_order(sl_args[0], sl_args[1].shape[1]))
    t["trace_bitmask kernel"] = cuda_ms(lambda: pk.trace_bitmask(*bm_args, 14, "cumulative"))
    t["trace_bitmask plain"] = cuda_ms(
        lambda: pk._trace_bitmask_plain(*bm_args, 14, "cumulative"), reps=2, warm=0)
    t["trace_list kernel (qlist lists)"] = cuda_ms(
        lambda: pk.trace_list(*ql_args, 14, "cumulative"))
    t["trace_list plain (qlist lists)"] = cuda_ms(
        lambda: pk._trace_list_plain(*ql_args, 14, "cumulative"), reps=2, warm=0)
    t["trace_list kernel (segment lists)"] = cuda_ms(
        lambda: pk.trace_list(*sl_args, 14, "cumulative"))
    t["trace_list plain (segment lists)"] = cuda_ms(
        lambda: pk._trace_list_plain(*sl_args, 14, "cumulative"), reps=2, warm=0)
    t["pallas_trace_sph default"] = cuda_ms(lambda: pk.pallas_trace_sph(
        rays_s, sorted_spheres, tree, tile=TRACE_TILE))
    t["pallas_trace_sph qlist"] = cuda_ms(lambda: pk.pallas_trace_sph(
        rays_s, sorted_spheres, tree, tile=TRACE_TILE, broadphase="qlist",
        max_chunks=caps["qlist"]))
    t["entry forward (2048 spheres, 1024 rays)"] = cuda_ms(lambda: entry_forward(*entry_args),
                                                           reps=3)
    t["build_sph_tree (entry, 2048 spheres)"] = cuda_ms(
        lambda: build_sph_tree(entry_args[0], max_per_leaf=16), reps=3)
    masks, masks_t, coords, slabs = sf_inputs
    deg8, a8c, b8c = sg._basis_coeffs("deg8")
    t["splat_sortfree_fwd kernel"] = cuda_ms(lambda: sg.splat_sortfree_fwd(
        masks, coords, slabs, "deg8", 32, 128, side, side))
    t["sortfree_tile_order"] = cuda_ms(lambda: sg.sortfree_tile_order(masks))
    t["splat_sortfree_fwd dense contraction (csrc/splat_sortfree_fwd_dense.cu)"] = cuda_ms(
        lambda: sortfree_fwd_dense(masks, coords, slabs, "deg8", 32, 128, side, side))
    t["splat_sortfree_fwd plain"] = cuda_ms(lambda: sg._sortfree_fwd_plain(
        masks, coords, slabs, a8c, b8c, side // 128, 32, 128, side, side), reps=2, warm=0)
    t["splat_sortfree_bwd kernel"] = cuda_ms(lambda: sg.splat_sortfree_bwd(
        masks_t, coords, slabs, g_image, "deg8", 32, 128))
    t["splat_sortfree_bwd plain"] = cuda_ms(lambda: sg._sortfree_bwd_plain(
        masks_t, coords, slabs, g_image, a8c, b8c, side // 128, 32, 128), reps=2, warm=0)
    t["dense_tile_segments (fused forward, max_chunks 2048)"] = cuda_ms(
        lambda: pb.dense_tile_segments(rays_s, sorted_spheres, TRACE_TILE, 2048))
    t["dense_segment_tiles (fused backward, max_tiles 2048)"] = cuda_ms(
        lambda: pr.dense_segment_tiles(rays_s, sorted_spheres, pr.BWD_TILE, 2048))
    t["render_fwd kernel"] = cuda_ms(lambda: pr.render_fwd(*fwd_args))
    t["list_tile_order (fused forward)"] = cuda_ms(
        lambda: pk.list_tile_order(fwd_args[0], fwd_args[1].shape[1]))
    listed_out = torch.empty(fwd_args[2].shape[0], dtype=torch.float32, device=dev)
    t["render_fwd kernel, as listed"] = cuda_ms(
        lambda: pr._render_fwd_launch(*fwd_args, None, listed_out))
    t["render_fwd plain"] = cuda_ms(lambda: pr._render_fwd_plain(*fwd_args), reps=2, warm=0)
    t["render_bwd kernel"] = cuda_ms(lambda: pr.render_bwd(*bwd_args))
    t["render_bwd plain"] = cuda_ms(lambda: pr._render_bwd_plain(*bwd_args), reps=2, warm=0)
    t["splat train step"] = cuda_ms(splat_step, reps=3)
    t["general train step"] = cuda_ms(general_step, reps=3)
    t["dense_tile_masks_quarter (records, tile 64)"] = cuda_ms(
        lambda: records_inputs("quarter", rays_s, sorted_spheres, 64))
    t["records_quarter kernel"] = cuda_ms(lambda: prc.records_quarter(*rq_args, RECORD_CAP))
    t["records_quarter plain"] = plain_ms["records_quarter"]
    t["records_bitmask kernel"] = cuda_ms(lambda: prc.records_bitmask(*rb_args, RECORD_CAP))
    t["records_bitmask plain"] = plain_ms["records_bitmask"]
    t["quarter_tile_order (records, tile 64)"] = cuda_ms(
        lambda: pk.quarter_tile_order(rq_args[1]))
    t["bitmask_tile_order (records, tile 64)"] = cuda_ms(
        lambda: pk.bitmask_tile_order(rb_args[0]))
    t["sort_records_by_distance"] = cuda_ms(lambda: prc.sort_records_by_distance(rec), reps=3)
    t["pallas_trace_sph_records (default route)"] = cuda_ms(
        lambda: prc.pallas_trace_sph_records(rays_s, sorted_spheres, RECORD_CAP), reps=3)
    t["pallas_trace_sph_records (default route) + sort_records_by_distance"] = cuda_ms(
        lambda: prc.sort_records_by_distance(prc.pallas_trace_sph_records(
            rays_s, sorted_spheres, RECORD_CAP)), reps=3)
    t["trace_sph (engine pallas) + sort_by_distance"] = cuda_ms(
        lambda: sort_by_distance(*(lambda f: (f.distances, f.offsets, f.indices, f.integrals))(
            trace_sph(rays_s, sorted_spheres, tree, capacity=total_hits, engine="pallas",
                      per_ray_capacity=RECORD_CAP)), total_hits=total_hits), reps=3)
    seg_t, seg_work = segsort_times(rec, flat)
    t.update(seg_t)
    del flat
    t["build_primitive_tree (torus)"] = cuda_ms(lambda: mt.build_triangle_tree(tris), reps=3)
    prim_rays = tri_state["rays_padded"]
    flat_tris = tri_state["sorted_tris"].reshape(-1, 3)
    t["clip_rays_to_aabb"] = cuda_ms(lambda: pt.clip_rays_to_aabb(
        prim_rays, flat_tris.amin(dim=0), flat_tris.amax(dim=0)))
    t["_dense_tile_segments_tri"] = cuda_ms(lambda: pt._dense_tile_segments_tri(
        tri_state["rays_clipped"], tri_state["sorted_tris"], 32, 2048), reps=3)
    t["trace_tri kernel (closest)"] = cuda_ms(lambda: pt.trace_tri(*tri_args, "closest"))
    t["trace_tri plain (closest)"] = plain_ms["tri closest"]
    t["trace_tri kernel (any)"] = cuda_ms(lambda: pt.trace_tri(*tri_args, "any"))
    t["trace_tri plain (any)"] = plain_ms["tri any"]
    t["render_triangles (pallas, whole)"] = cuda_ms(
        lambda: mt.render_triangles(tris, resolution=side, engine="pallas"), reps=3)
    # the engine's walk (path 8): the kernel (the packet walk), the per-ray
    # walk (PR 12's kernel) and the plain walk at each size; the plain walk
    # runs once at the full sizes (its counts, sums and triangle outputs
    # held to the kernel's there too), warm on the subset and the entry
    hc8, cd8 = path8["hc"], path8["cd"]
    offsets8 = (torch.cumsum(hc8, dim=0, dtype=torch.int32) - hc8).to(torch.int32)
    per_ray = lambda *a: walk_outputs(*a, 64, "per_ray", visits=False)
    t["bvh_walk_sph kernel (cumulative, bench)"] = cuda_ms(
        lambda: wk.walk_sph(rays_s, sorted_spheres, tree, "cumulative"))
    t["bvh_walk_sph per-ray walk (cumulative, bench)"] = cuda_ms(
        lambda: per_ray(rays_s, sorted_spheres, tree, "sph", "cumulative"))
    t["bvh_walk_sph kernel (count, bench)"] = cuda_ms(
        lambda: wk.walk_sph(rays_s, sorted_spheres, tree, "count"))
    t["bvh_walk_sph per-ray walk (count, bench)"] = cuda_ms(
        lambda: per_ray(rays_s, sorted_spheres, tree, "sph", "count"))
    t["bvh_walk_sph kernel (records pass, bench)"] = cuda_ms(
        lambda: wk.walk_sph(rays_s, sorted_spheres, tree, "records", cursors=offsets8,
                            capacity=path8["capacity"]), reps=3)
    t["trace_sph (engine xla, bench: count, scan, records)"] = cuda_ms(
        lambda: trace_sph(rays_s, sorted_spheres, tree, capacity=path8["capacity"]), reps=3)
    rays8 = rays_s[path8["sub"]]
    t["bvh_walk_sph kernel (cumulative, bench subset)"] = cuda_ms(
        lambda: wk.walk_sph(rays8, sorted_spheres, tree, "cumulative"))
    t["bvh_walk_sph per-ray walk (cumulative, bench subset)"] = cuda_ms(
        lambda: per_ray(rays8, sorted_spheres, tree, "sph", "cumulative"))
    t["plain walk (cumulative, bench subset)"] = cuda_ms(
        lambda: wk._walk_sph_plain(rays8, sorted_spheres, tree, "cumulative"), reps=2, warm=0)
    cd_plain, t["plain walk (cumulative, bench)"] = timed(
        lambda: wk._walk_sph_plain(rays_s, sorted_spheres, tree, "cumulative"), dev)
    walk_err, _ = check_close("bench walk sums vs the plain walk", cd8, cd_plain, 1e-5,
                              1e-6 * float(cd_plain.abs().max()))
    del cd_plain
    hc_plain, t["plain walk (count, bench)"] = timed(
        lambda: wk._walk_sph_plain(rays_s, sorted_spheres, tree, "count"), dev)
    check_equal("bench walk counts vs the plain walk", hc8, hc_plain)
    del hc_plain
    ss_e, tree_e, rays_e = path8["entry"]
    t["bvh_walk_sph kernel (cumulative, entry)"] = cuda_ms(
        lambda: wk.walk_sph(rays_e, ss_e, tree_e, "cumulative"))
    t["bvh_walk_sph per-ray walk (cumulative, entry)"] = cuda_ms(
        lambda: per_ray(rays_e, ss_e, tree_e, "sph", "cumulative"))
    t["plain walk (cumulative, entry)"] = cuda_ms(
        lambda: wk._walk_sph_plain(rays_e, ss_e, tree_e, "cumulative"), reps=3)
    torus = path8["torus"]
    tri8 = (torus["sorted_tris"], torus["tree"])
    t["bvh_walk_tri kernel (closest, torus)"] = cuda_ms(
        lambda: wk.walk_tri(torus["rays"], *tri8, "closest"))
    t["bvh_walk_tri kernel (any, torus shadow rays)"] = cuda_ms(
        lambda: wk.walk_tri(torus["shadow"], *tri8, "any"))
    t["bvh_walk_tri per-ray walk (closest, torus)"] = cuda_ms(
        lambda: per_ray(torus["rays"], *tri8, "tri", "closest"))
    t["bvh_walk_tri per-ray walk (any, torus shadow rays)"] = cuda_ms(
        lambda: per_ray(torus["shadow"], *tri8, "tri", "any"))
    (t_pl, id_pl), t["plain walk (closest, torus)"] = timed(
        lambda: wk._walk_tri_plain(torus["rays"], *tri8, "closest"), dev)
    check_equal("torus walk ids vs the plain walk", torus["closest"].tri, id_pl)
    check_tensor_bits("torus walk t vs the plain walk", torus["closest"].t, t_pl)
    occ_pl, t["plain walk (any, torus shadow rays)"] = timed(
        lambda: wk._walk_tri_plain(torus["shadow"], *tri8, "any"), dev)
    check_equal("torus walk occlusion vs the plain walk", occ_pl,
                wk.walk_tri(torus["shadow"], *tri8, "any"))
    log(f"check path 8 the plain walk once at the full sizes: bench counts bit-equal, sums max "
        f"abs err {walk_err:.3g}; torus ids, t and occlusion bit-equal OK")
    t["render_triangles (xla, whole)"] = cuda_ms(
        lambda: mt.render_triangles(tris, resolution=side, engine="xla"), reps=3)
    # the build (csrc/build.cu): its steps alone and the plain build
    bt, build_work = build_times(spheres, entry_args[0], tris)
    t.update(bt)
    # the broadphase (csrc/broadphase.cu) and the triangle lists
    # (csrc/tri_lists.cu): each kernel alone, its plain version, the calls
    bpt, bp_work, bp_lines = broadphase_times(sorted_spheres, rays_s, tri_state["sorted_tris"],
                                              torus_sets[1])
    t.update(bpt)
    for line in bp_lines:
        log(line)
    for k, v in t.items():
        log(f"time {k}: {v:.3f} ms")

    # 13. the work each kernel's bound is computed from
    hits = int(quarter_hc.sum())
    r_pad = packed.shape[0]
    quarters = int(_popcount_rows(words).sum())
    segments = int(_popcount_rows(bm_args[0]).sum())
    q_listed = int(ql_args[0].sum())
    s_listed = int(sl_args[0].sum())
    sf_pairs = int(_popcount_rows(masks).sum())
    fused_pairs = int(fwd_args[0].sum())
    bwd_pairs = int(bwd_args[0].sum())
    rows_x_cols, rows_plus_cols = footprint_work(sorted_spheres, weights, cam)
    rank = a8c.shape[0]
    log(f"work: {hits} ray-particle hits; trace_quarter {quarters} (tile, quarter) pairs; "
        f"trace_bitmask {segments} (tile, segment) pairs; trace_list {q_listed} (tile, "
        f"quarter) pairs on the qlist lists and {s_listed} (tile, segment) pairs on the "
        f"segment lists; splat and splat_sortfree "
        f"{rows_x_cols:.0f} footprint (pixel, particle) products and {rows_plus_cols:.0f} "
        f"factor entries, splat_sortfree {sf_pairs} (pixel tile, segment) pairs; "
        f"render_fwd {fused_pairs} (ray tile, segment) pairs; render_bwd {bwd_pairs} "
        f"(segment, ray tile) pairs")
    rec_quarters = int(_popcount_rows(rq_args[1]).sum())
    rec_segments = int(_popcount_rows(rb_args[0]).sum())
    rec_pad = rq_args[2].shape[0]
    rec_bytes = rec_pad * RECORD_CAP * 12 + rec_pad * 4
    tri_pairs = {m: tri_state["visited " + m] * pt.CHUNK for m in ("closest", "any")}
    tri_tile = tri_args[3].shape[0] // tri_args[0].shape[0]
    log(f"work: records {rec_quarters} (tile, quarter) pairs (records_quarter) and "
        f"{rec_segments} (tile, segment) pairs (records_bitmask) at tile 64, {hits} hits, "
        f"{rec_bytes} record bytes written ({rec_pad} rows x {RECORD_CAP} x 12 + counts); "
        f"trace_tri (tile, segment) pairs visited {tri_pairs['closest']} (closest) and "
        f"{tri_pairs['any']} (any) of {int(tri_args[0].sum())} listed, at tile {tri_tile}, "
        f"{FLOPS_MT} flops a (ray, triangle) test")
    trace_flops = lambda pairs: pairs * FLOPS_PAIR + hits * FLOPS_HIT_H14
    splat_flops = rows_x_cols * rank * 2 + rows_plus_cols * rank * (2 * deg8 + 2)
    nodes_s, tested_s, most_s = walk_visits(rays_s, sorted_spheres, tree, "sph")
    nodes_t, tested_t, most_t = walk_visits(torus["rays"], *tri8, "tri")
    walk_hits = int(hc8.sum())
    log(f"work: bvh_walk_sph on the bench scene {nodes_s} node tests (two boxes each, "
        f"{FLOPS_SLAB} flops a box), {tested_s} sphere tests ({FLOPS_PAIR} flops), {walk_hits} "
        f"hits ({FLOPS_HIT_LERP} flops), most node tests on one ray {most_s}; bvh_walk_tri on "
        f"the torus's primary rays {nodes_t} node tests, {tested_t} triangle tests "
        f"({FLOPS_MT} flops), most node tests on one ray {most_t}")
    ops_b, bytes_b = build_work["build"]
    log(f"bound build: build_sph_tree on the bench scene moves {bytes_b} bytes (the spheres, "
        f"keys, sorted keys and permutation, sorted spheres, boxes, deltas, split ranges, marks "
        f"and their scan, the tree: each read once and written once; CUB's radix passes are "
        f"not counted) -> {bytes_b / PEAK_BYTES * 1e3:.4f} ms; {ops_b} operations -> "
        f"{ops_b / PEAK_FLOPS * 1e3:.4f} ms; the build {t['build_sph_tree']:.3f} ms, plain "
        f"{t['build_sph_tree plain']:.3f} ms")
    log(f"build kernels' launches by main path: {json.dumps(build_by_path)}")
    for name, label, kernel_ms, plain_ms in (
            ("bucket_prep", "bucket_prims_ortho (the function's own bytes: spheres read; "
             "slabs, ranges and overflow written)", "bucket_prep kernel", "bucket_prep plain"),
            ("sortfree_setup", "sortfree_setup (spheres and weights read, slabs and both "
             "masks written)", "sortfree setup kernel", "sortfree setup plain")):
        ops_p, bytes_p = prep_work[name]
        log(f"bound {name.replace('_', ' ')}: {label} on the bench scene moves {bytes_p} bytes "
            f"-> {bytes_p / PEAK_BYTES * 1e3:.4f} ms; {ops_p} operations -> "
            f"{ops_p / PEAK_FLOPS * 1e3:.4f} ms; the call {t[kernel_ms]:.3f} ms, plain "
            f"{t[plain_ms]:.3f} ms")
    log(f"splat setup kernels' launches by main path: {json.dumps(prep_by_path)}")
    for name, (ops_b, bytes_b) in bp_work.items():
        log(f"work {name}: {ops_b} operations -> {ops_b / PEAK_FLOPS * 1e3:.4f} ms, {bytes_b} "
            f"bytes -> {bytes_b / PEAK_BYTES * 1e3:.4f} ms")
    ops_all, bytes_w = bp_work["overlap_words (all pairs)"]
    ops_cull = bp_work["overlap_words"][0]
    log(f"bound overlap_words (quarter words and summary, tile 64): all pairs {ops_all} "
        f"operations -> {ops_all / PEAK_FLOPS * 1e3:.4f} ms; the hull cull's {ops_cull} "
        f"operations -> {ops_cull / PEAK_FLOPS * 1e3:.4f} ms; bytes (words, summary, boxes) "
        f"{bytes_w} -> {bytes_w / PEAK_BYTES * 1e3:.4f} ms; the call "
        f"{t['overlap_words kernel (quarter words and summary, tile 64)']:.3f} ms")
    log(f"broadphase kernels' launches by main path: {json.dumps(bp_by_path)}")
    for name, (ops_s, bytes_s) in seg_work.items():
        log(f"work {name}: {ops_s} compares -> {ops_s / PEAK_FLOPS * 1e3:.4f} ms, {bytes_s} "
            f"bytes -> {bytes_s / PEAK_BYTES * 1e3:.4f} ms")
    log(f"segsort kernels' launches by main path: {json.dumps(seg_by_path)}")
    log(f"whole run {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [
        kernel_entry("trace_quarter", "trace_quarter.cu", f"{PK}:348, {PK}:519, {PK}:121",
                     launches["trace_quarter"], trace_err, t["trace kernel"],
                     t["trace plain"], trace_flops(quarters * 32 * TRACE_TILE),
                     nbytes(summary, words, packed, prims) + r_pad * 4),
        kernel_entry("splat", "splat.cu", "grace_tpu/trace/splat.py:282", launches["splat"],
                     splat_err, t["splat kernel"], t["splat plain"], splat_flops,
                     nbytes(*buckets[:7]) + n_rays * 4),
        kernel_entry("trace_bitmask", "trace_bitmask.cu", f"{PK}:283, {PK}:626",
                     launches2["trace_bitmask"], errs["trace_bitmask"],
                     t["trace_bitmask kernel"], t["trace_bitmask plain"],
                     trace_flops(segments * 128 * TRACE_TILE), nbytes(*bm_args) + r_pad * 4),
        kernel_entry("trace_list", "trace_list.cu", f"{PK}:459",
                     launches2["trace_list"], errs["trace_list"],
                     t["trace_list kernel (qlist lists)"], t["trace_list plain (qlist lists)"],
                     trace_flops(q_listed * 32 * TRACE_TILE),
                     nbytes(*ql_args[:4]) + r_pad * 4),
        kernel_entry("trace_list_seg", "trace_list.cu", f"{PK}:221, {PK}:174, {PK}:688",
                     launches2["trace_list_seg"], errs["trace_list_seg"],
                     t["trace_list kernel (segment lists)"], t["trace_list plain (segment lists)"],
                     trace_flops(segments * 128 * TRACE_TILE),
                     nbytes(*sl_args[:4]) + r_pad * 4),
        kernel_entry("splat_sortfree_fwd", "splat_sortfree.cu",
                     "grace_tpu/trace/splat_grad.py:181", launches3["splat_sortfree_fwd"],
                     errs["sortfree_fwd"], t["splat_sortfree_fwd kernel"],
                     t["splat_sortfree_fwd plain"], splat_flops,
                     nbytes(masks, coords, slabs) + n_rays * 4),
        kernel_entry("splat_sortfree_bwd", "splat_sortfree.cu",
                     "grace_tpu/trace/splat_grad.py:262", launches3["splat_sortfree_bwd"],
                     errs["sortfree_bwd"], t["splat_sortfree_bwd kernel"],
                     t["splat_sortfree_bwd plain"],
                     rows_x_cols * rank * 6 + rows_plus_cols * rank * (4 * deg8 + 6),
                     nbytes(masks_t, coords, slabs, g_image, slabs)),
        kernel_entry("render_fwd", "render.cu", "grace_tpu/trace/pallas_render.py:70",
                     launches3["render_fwd"], errs["render_fwd"], t["render_fwd kernel"],
                     t["render_fwd plain"],
                     fused_pairs * 128 * TRACE_TILE * FLOPS_PAIR + hits * FLOPS_HIT_FAST,
                     nbytes(*fwd_args) + r_pad * 4),
        kernel_entry("render_bwd", "render.cu", "grace_tpu/trace/pallas_render.py:110",
                     launches3["render_bwd"], errs["render_bwd"], t["render_bwd kernel"],
                     t["render_bwd plain"],
                     bwd_pairs * 128 * pr.BWD_TILE * FLOPS_PAIR + hits * FLOPS_HIT_FAST_BWD,
                     nbytes(*bwd_args, bwd_args[2])),
        kernel_entry("records_quarter", "records.cu", f"{PR}:377", launches4["records_quarter"],
                     errs["records_quarter integral"], t["records_quarter kernel"],
                     t["records_quarter plain"], trace_flops(rec_quarters * 32 * 64),
                     nbytes(*rq_args) + rec_bytes),
        kernel_entry("records_bitmask", "records.cu", f"{PR}:333, {PR}:485",
                     launches4["records_bitmask"], errs["records_bitmask integral"],
                     t["records_bitmask kernel"], t["records_bitmask plain"],
                     trace_flops(rec_segments * 128 * 64), nbytes(*rb_args) + rec_bytes),
        kernel_entry("trace_tri", "tri.cu", "grace_tpu/trace/pallas_tri.py:192",
                     launches5["trace_tri closest"], errs["tri closest"],
                     t["trace_tri kernel (closest)"], t["trace_tri plain (closest)"],
                     tri_pairs["closest"] * 128 * tri_tile * FLOPS_MT,
                     nbytes(*tri_args) + tri_args[3].shape[0] * 8),
        kernel_entry("trace_tri_any", "tri.cu", "grace_tpu/trace/pallas_tri.py:192",
                     launches5["trace_tri any"], errs["tri any"],
                     t["trace_tri kernel (any)"], t["trace_tri plain (any)"],
                     tri_pairs["any"] * 128 * tri_tile * FLOPS_MT,
                     nbytes(*tri_args) + tri_args[3].shape[0] * 8),
        # the engine's walk (not a TPU kernel): main path 8
        kernel_entry("bvh_walk_sph", "bvh_walk.cu", "grace_tpu/trace/engine.py:100",
                     launches8["bvh_walk_sph"], walk_err,
                     t["bvh_walk_sph kernel (cumulative, bench)"],
                     t["plain walk (cumulative, bench)"],
                     nodes_s * 2 * FLOPS_SLAB + tested_s * FLOPS_PAIR + walk_hits * FLOPS_HIT_LERP,
                     nbytes(rays_s.origins, rays_s.directions, rays_s.lengths, sorted_spheres,
                            tree.children, tree.child_aabbs, tree.leaves)
                     + 4 * len(DENSE_KERNEL_INTEGRAL_TABLE) + rays_s.n_rays * 4),
        kernel_entry("bvh_walk_tri", "bvh_walk.cu", "grace_tpu/trace/engine.py:100",
                     launches8["bvh_walk_tri"], 0.0, t["bvh_walk_tri kernel (closest, torus)"],
                     t["plain walk (closest, torus)"],
                     nodes_t * 2 * FLOPS_SLAB + tested_t * FLOPS_MT,
                     nbytes(torus["rays"].origins, torus["rays"].directions,
                            torus["rays"].lengths, tri8[0], tri8[1].children,
                            tri8[1].child_aabbs, tri8[1].leaves) + torus["rays"].n_rays * 8),
        # the build (not TPU kernels: grace_tpu's plain XLA build), bench scene
        *[with_extra(kernel_entry(name, "build.cu", replaces,
                                  sum(p[name] for p in build_by_path.values()),
                                  err, t[kernel_ms], t[plain_ms], *build_work[name],
                                  by_path={f"path {k}": v[name] for k, v in build_by_path.items()}),
                     keys_extra(t, build_work) if name == "build_morton_keys" else None)
          for name, replaces, err, kernel_ms, plain_ms in (
              ("build_morton_keys", "grace_tpu/ops/morton.py:99", build_errs["keys"],
               "build_morton_keys kernel", "build_morton_keys plain"),
              ("build_deltas", "grace_tpu/build/deltas.py:26, grace_tpu/build/deltas.py:76",
               build_errs["deltas"], "build_deltas kernel (euclidean)",
               "build_deltas plain (euclidean)"),
              ("build_gather_deltas", "grace_tpu/build/sph.py:60, grace_tpu/build/sph.py:134, "
               "grace_tpu/ops/primitives.py:32, grace_tpu/ops/primitives.py:57, "
               "grace_tpu/build/deltas.py:76, grace_tpu/build/deltas.py:89",
               max(build_errs["gather"], build_errs["deltas"]),
               "build_gather_deltas kernel (euclidean)",
               "build_gather_deltas plain (spheres[perm], i32, sphere_aabb, plain deltas)"),
              ("build_lbvh_ranges", "grace_tpu/build/lbvh.py:105, grace_tpu/build/lbvh.py:130",
               max(build_errs["split ranges l"], build_errs["split ranges r"]),
               "build_lbvh_ranges kernel",
               "build_lbvh_ranges plain (cartesian_tree_ranges, coalesce_leaves)"),
              ("build_lbvh_nodes", "grace_tpu/build/lbvh.py:217",
               max(build_errs[f] for f in BUILD_FIELDS), "build_lbvh_nodes kernel",
               "build_lbvh plain (both phases)"))],
        # the splat's two setups (not TPU kernels: grace_tpu's plain XLA), bench scene
        # (the plain times are the whole plain setup's: it has no steps of
        # the kernels' cut)
        *[kernel_entry(name, "splat_prep.cu", replaces,
                       sum(p[name] for p in prep_by_path.values()), err, t[kernel_ms],
                       t[plain_ms], *prep_work[name],
                       by_path={f"path {k}": v[name] for k, v in prep_by_path.items()},
                       library_ms=library)
          for name, replaces, err, kernel_ms, plain_ms, library in (
              ("splat_bucket_keys", "grace_tpu/trace/splat.py:122, grace_tpu/trace/splat.py:235, "
               "grace_tpu/trace/splat.py:239", max(prep_errs[f] for f in SPLAT_PREP_OUTPUTS[:8]),
               "splat_bucket_keys kernel", "bucket_prep plain", None),
              ("splat_bucket_pack", "grace_tpu/trace/splat.py:235, grace_tpu/trace/splat.py:239, "
               "grace_tpu/trace/splat.py:74, grace_tpu/trace/splat.py:122",
               max(prep_errs[f] for f in SPLAT_PREP_OUTPUTS[:8]), "splat_bucket_pack kernel",
               "bucket_prep plain", t["bucket key sort (torch.sort, stable)"]),
              ("sortfree_setup", "grace_tpu/trace/splat_grad.py:108, "
               "grace_tpu/trace/splat_grad.py:131, grace_tpu/trace/splat_grad.py:141, "
               "grace_tpu/trace/pallas_broadphase.py:59",
               max(prep_errs[f] for f in SPLAT_PREP_OUTPUTS[8:]), "sortfree setup kernel",
               "sortfree setup plain", None))],
        # the dense broadphase and the triangle lists (not TPU kernels:
        # grace_tpu's plain XLA), on the bench scene at the records' tile 64
        # and on path 5's primary rays
        boxes_entry(t, bp_work, bp_by_path),
        *[with_extra(kernel_entry(name, "broadphase.cu", replaces,
                                  sum(p[name] for p in bp_by_path.values()), 0.0, t[kernel_ms],
                                  t[plain_ms], *bp_work[name],
                                  by_path={f"path {k}": v[name] for k, v in bp_by_path.items()}),
                     compact_extra(t, bp_work) if name == "compact_words" else None)
          for name, replaces, kernel_ms, plain_ms in (
              ("overlap_words", "grace_tpu/trace/pallas_broadphase.py:249, "
               "grace_tpu/trace/pallas_broadphase.py:59, grace_tpu/trace/pallas_render.py:218",
               "overlap_words kernel (quarter words and summary, tile 64)",
               "overlap_words plain (quarter words and summary, tile 64; with its segment "
               "boxes)"),
              ("compact_words", "grace_tpu/trace/pallas_broadphase.py:138",
               "compact_words kernel (quarter words, max_q 512, tile 64)",
               "compact_words plain (quarter words, max_q 512, tile 64)"))],
        kernel_entry("tri_tile_lists", "tri_lists.cu", "grace_tpu/trace/pallas_tri.py:89",
                     sum(p["tri_tile_lists"] for p in bp_by_path.values()), 0.0,
                     t["tri_tile_lists kernel (torus primary)"],
                     t["_dense_tile_segments_tri plain (torus primary)"],
                     *bp_work["tri_tile_lists primary"],
                     by_path={f"path {k}": v["tri_tile_lists"] for k, v in bp_by_path.items()},
                     library_ms=t.get("tri lists' key sort (torch.sort, stable; torus primary)")),
        # the records' post-processing (not TPU kernels: grace_tpu's plain
        # XLA), on main path 4's records
        *[kernel_entry(name, "segsort.cu", replaces, sum(p[name] for p in seg_by_path.values()),
                       0.0, t[f"{name} kernel" + extra], t[f"{name} plain" + extra],
                       *seg_work[name],
                       by_path={f"path {k}": v[name] for k, v in seg_by_path.items()},
                       library_ms=library)
          for name, replaces, extra, library in (
              ("sort_rows", "grace_tpu/trace/pallas_records.py:729", "",
               t["sort_rows library (torch.sort of the keys, stable)"]),
              ("segmented_sort", "grace_tpu/ops/segops.py:70, grace_tpu/ops/segops.py:24, "
               "grace_tpu/ops/segops.py:57", " (path 4's flat layout)",
               t["segmented_sort library (torch.sort of the int64 keys segment << 32 | order "
                 "key, stable)"]),
              ("records_to_flat", "grace_tpu/trace/pallas_records.py:741", "", None))],
        # path 6's launches of B3 and B6, held and timed on its fan-out set
        *[kernel_entry(f"{k} (path 6)", f"{k}.cu", replaces, launches6[k], errs6[k],
                       k6[PATH6_FULL, k, "cumulative"], plain6[k], *work6[PATH6_FULL][k])
          for k, replaces in (("trace_quarter", f"{PK}:348, {PK}:519, {PK}:121"),
                              ("trace_bitmask", f"{PK}:283, {PK}:626"))],
    ]}), flush=True)


if __name__ == "__main__":
    main()
