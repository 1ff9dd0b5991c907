"""Ablations of the kernels redesigned for the card, on one CUDA card.

    python3 chip_ablation.py [trace] [render_bwd] [trace_tri] [splat] [records]
                             [sortfree_bwd] [render_fwd] [paths] [statistics] [walk]
                             [build] [climbs] [splat_prep] [broadphase] [record_sort]
                             [segsort] [feeds] [records_flat] [tri_lists] [morton]
                             [compaction]
                             [--parent DIR [--rounds K]]
                             (default: all parts)
    python3 chip_ablation.py paths --package DIR   (DIR/grace_tpu_torch, e.g. another checkout)
    python3 chip_ablation.py build --package DIR
    python3 chip_ablation.py build --parent DIR
    python3 chip_ablation.py feeds --parent DIR --rounds 5   (10 runs a side)
    python3 chip_ablation.py splat_prep --parent DIR
    python3 chip_ablation.py broadphase --parent DIR
    python3 chip_ablation.py records --parent DIR   (record_sort alone: no kernel variants)
    python3 chip_ablation.py segsort   (variants of csrc/segsort.cu on path 4's records)
    python3 chip_ablation.py records_flat --parent DIR --rounds 2   (E10 in turns, variants)
    python3 chip_ablation.py tri_lists --parent DIR   (E7 in turns, variants)
    python3 chip_ablation.py morton compaction --parent DIR --rounds 2   (E2's keys, E6's
                             compaction in turns, variants)

Each variant is a copy of the kernel's sources with one constant, one wait
or one device function replaced, built as the package builds its libraries
(into ``_kernels_build/``); a variant must give the shipped kernel's bits
where it sums the same terms in the same order, and the variants are timed
in turns (CUDA events, median of 10), on the work units in the order the
wrapper launches them (longest list first).

  trace: trace_bitmask (B6, csrc/trace_bitmask.cu) on main path 2's
  segment words and trace_list (B8, csrc/trace_list.cu) on its segment
  lists (``chip_smoke.py``'s bench scene: 2^20 clustered particles, 512x512
  sorted orthographic rays, tile 128), cumulative (degree 14) and hit
  counts: stage.cuh's accumulate_staged as shipped before the cull (the
  integral and the Kahan update for every pair; held within rtol 1e-5 of
  the shipped sums, hit counts exact), the cull inline in one loop, the two
  phases as shipped, the two phases with the other number of staging
  buffers (two: the next batch's copies in flight while this one is
  tested), and the integral phase over 64- and 128-slot masks instead of
  32. Each variant's registers, shared bytes and resident warps come from
  its resources query.

  render_bwd (csrc/render.cu) on main path 3's backward inputs (the same
  scene, weights 1, max_tiles 2048; the cotangents are seeded normal
  numbers, which move no hit): kBwdBatch = 1, 2 and 4 ray tiles per barrier
  pair, and batch 4 waiting for its own copies and the next batch's before
  it tests (no load runs ahead). It also counts the warp passes through the
  hit branch: the earlier design ran one for every ray of a tile on which
  any of a warp's 32 particles hits, this design as many as the warp's
  busiest particle has hits.

  trace_tri (csrc/tri.cu) on main path 5's closest-hit and any-hit inputs
  (the 262,144-triangle torus, 512x512 pinhole rays, tile 32):
  kBlockWarps = 1, 2, 4 and 8 warps a block, and the shipped block waiting
  for each segment's copy before it tests the previous one.

  splat: splat.cu (B1) on main path 1's buckets and the sort-free forward
  (B11) on main path 3's masks (the bench scene, 32 x 32 patches, deg8):
  the support-only factors contracted densely, the culled contraction
  with one row a thread, four rows a thread (shipped), the Horner degree
  at run time, each patch cut into 2 or 4 blocks along its rows, and for
  B11 a batch a segment; then the dense loops they replaced
  (csrc/splat_dense.cu, csrc/splat_sortfree_fwd_dense.cu), listed against
  heaviest-first order and batches of 32, 64 and 128 through the C
  entries; for B1 the keys above one SM's mean share (and half of it)
  split over several blocks with an ordered second pass (held within 1e-5
  x max of the plain version).

  records: grace_records_quarter (B16) and grace_records_bitmask (B15,
  csrc/records.cu) on main path 4's inputs (the bench scene's sorted rays,
  tile 64, 512 records a ray, quarter and segment words): with --parent
  DIR (e.g. a git archive of the parent checkout), the parent's kernel
  built from DIR/grace_tpu_torch/csrc as it was and with its per-slot test
  and append replaced by the mask of 32 tests first; then the redesign's
  steps (cp.async staging across word boundaries with direct hit stores and
  the parent's sentinel fill, the fill a warp a row without division, the
  hit stores staged in shared memory and written by the warp, the shipped
  batch size), and the shipped kernel with other pending slots a ray, the
  parent's sentinel fill, the flush a row at a time, the other number of staging buffers, launch
  bounds of 256 threads, batches of half and twice the size; the shipped
  kernel launched as listed, longest row first and shortest first. Every
  variant's four outputs (counts, indices, integrals, distances) are held
  bit-equal to the parent's (without --parent: to the first variant's),
  but those of three variants that leave work out to show its cost (no
  integral, no sentinel fill, counts only); each variant's resources; then
  the whole record trace on both routes with the device's busy share, and
  the two launch-order helpers at tile 64 beside the same order on the i64
  popcount. Then the record_sort part.

  record_sort: the records' post-processing (csrc/segsort.cu) through the
  package's user functions only, on main path 4's records (the bench
  scene's sorted rays, 512 a ray): sort_records_by_distance,
  records_to_flat, sort_by_distance of trace_sph(engine="pallas")'s flat
  layout with its total_hits, and the record trace alone, with the row
  sort and as trace_sph with the CSR sort; each timed (CUDA events, median
  of 10 after a warm run) with the device's busy ms and device operations
  over one call (the segsort calls' kernels all listed by name); with
  --parent DIR, DIR's grace_tpu_torch and this one in turns (parent, this,
  this, parent), each a process of its own.

  records_flat: E10 (records_to_flat, csrc/segsort.cu) through the
  package's user functions only, on main path 4's records:
  records_to_flat (with its kernel's device time, torch.profiler over 20
  calls, and the host's time a call, 50 calls enqueued),
  trace_sph(engine="pallas") and it with sort_by_distance, each timed
  (CUDA events, median of 10 after a warm run) with the device's busy ms
  and device operations over one call; with --parent DIR, DIR's
  grace_tpu_torch and this one in turns (parent, this, this, parent;
  --rounds K times), each a process of its own. In this package's first
  process, first E10's variants (flat_variants: 4-byte stores, the
  wrapper's torch scan, a one-block scan launch, rows a block, threads a
  block, registers, chunk width; leave-outs of the copies and of the
  tail) bound in the package's place, bit-equal to the shipped kernel's
  five outputs and timed in turns: the call, E10's kernel and the call's
  device time and operations (torch.profiler).

  segsort: E8 (sort_rows_cuda) and E9 (segmented_sort_cuda) on main path
  4's records with variants of csrc/segsort.cu bound in the package's
  place (segsort_variants: no staging ahead, 4-byte payload stores, the
  long route's smaller grids, other network sizes, every run on the u64
  network, the network run twice; leave-outs of the sort, the payload
  writes and the network's steps across and inside lanes), each compared
  variant bit-equal to the shipped kernels' outputs, all timed in turns,
  with each variant's sort kernel resources and how path 4's runs spread
  over E and how many are in order already.

  sortfree_bwd: grace_splat_sortfree_bwd (B12, csrc/splat_sortfree.cu) on
  main path 3's backward inputs (the bench scene, tiles of 32 x 128, deg8,
  a seeded normal cotangent image, which moves no footprint), with the
  spread of listed tiles and footprint products over the segments: with
  --parent DIR the parent's kernel built from DIR/grace_tpu_torch/csrc;
  then the redesign's steps as listed (the footprint cull alone: a row a
  pass, the Horner degree at run time, the tile staged by plain loads; +
  factors once a pass; + cp.async staging), the shipped kernel as listed
  (it takes no order), with other rows a pass, the other number of
  staging buffers, the degree at run time, the column stride not rounded
  up, the tile staged a row at a time, built with a launch order and
  launched as listed, most listed tiles first and fewest first (and the
  time of that order), and a leave-out variant (footprints found, nothing
  added).
  Every output but the leave-out's bit-equal to the parent's.

  render_fwd: grace_render_fwd (B13, csrc/render.cu) on main path 3's
  forward inputs (the bench scene's sorted rays, tile 128, max_chunks
  2048): with --parent DIR the parent's kernel and the parent with its
  per-slot hit branch replaced by a mask of 32 tests first, both as
  listed; the redesign's steps as listed (the mask on float4 rows, staged
  by plain loads; + cp.async), the shipped kernel launched longest list
  first, as listed and shortest first, with the other number of staging
  buffers, and a leave-out variant (the weight in place of the term).
  Every output but the leave-out's bit-equal to the parent's.

  paths: the splat frame (build, rays + sort, bucket, splat), one sort-free
  training step, one fused-renderer step and the record trace on both
  routes (512 a ray) on the
  bench scene through the package's user functions only, timed, with the
  device's busy share over each (torch.profiler), and the two record
  wrappers at tile 64; with --package DIR, DIR's grace_tpu_torch runs them,
  so that two checkouts compare in one call.

  statistics: Beran's An and Gine's Gn of main path 6's HEALPix set
  (196,608 directions) and of 65,536 of its isotropic draws, with the pair
  terms in f32 on the directions as drawn, in f32 on the directions
  normalized in f64, and in f64 as shipped, each timed; against float64
  evaluations of the directions normalized and as drawn.

  walk: the engine's walk (csrc/bvh_walk.cu, E1) on the driver entry's
  1,024 random rays, the bench scene's sorted rays and every 64th of them,
  path 6's isotropic and HEALPix fan-out rays on the bench particles, and
  the torus's primary (closest) and shadow (any, closest) rays: the packet
  walk as shipped, with leaf tests by pairs at no step, at steps of up to
  8 or 24 lanes and at every step (shipped: up to 16), without closest
  pruning and without the any-hit exit, the per-ray walk (route 1), and
  with --parent DIR PR 12's kernel built from DIR/grace_tpu_torch/csrc;
  every output bit-equal to the per-ray walk's, timed in turns, with the
  packet's restarts, steps a warp and active lanes a step, and the
  device's busy share during the shipped packet and per-ray walks; first
  the f32 <-> f64 conversions and f64 operations in each compiled walk
  kernel (cuobjdump -sass).

  build: the LBVH build and what it feeds, through the package's user
  functions and its build wrappers (so --package DIR times another
  checkout's, e.g. the parent's): the steps after the key sort on the
  bench scene (max_per_leaf 32: the gather with the permutation's cast,
  the boxes and the deltas, one launch where the package has
  gather_deltas_cuda; phase A; phase B), build_sph_tree on the bench
  scene and on its Morton-sorted particles (path 6's form), on
  `__graft_entry__`'s 2,048 spheres (16) with its forward, build_primitive_tree
  on the torus (XOR deltas, 8) and render_triangles on both engines at
  512 x 512; each timed, with the device's busy share and its device
  operations (kernels, copies, memsets) over one call; with --parent DIR,
  DIR's grace_tpu_torch and this one in turns (parent, this, this,
  parent), each a process of its own.

  feeds: what the build feeds, through the package's user functions only:
  the entry's forward (`__graft_entry__`: 2,048 spheres, 1,024 rays), the
  torus build and render_triangles on both engines at 512 x 512, each timed (CUDA
  events, median of 10 after a warm run) with the device's busy ms and
  device operations over one call; and render_triangles(engine="xla")
  cut into its steps (the torus build, auto_camera with its host read,
  the rays, the closest-hit walk, the shadow rays, the any-hit walk and
  the shading), each step's host wall time with a synchronize after it
  (median of 10). With --parent DIR, DIR's grace_tpu_torch and this one
  in turns (parent, this, this, parent) --rounds times (default 1), each
  run a process of its own.

  climbs: csrc/build.cu's two climbs on the bench scene's inputs as
  shipped and in variants (phase B without its device stage, without the
  leaves' boxes, with relaxed device arrivals, with 32 lanes a leaf, with
  lanes up to max_per_leaf, with plain box loads in both stages;
  phase A without its device stage), each built
  apart and timed in turns at the
  default block and at 256 and 512; the leave-outs are timed only.

  splat_prep: the splat's two setups and what they feed, through the
  package's user functions only: bucket_prims_ortho (csrc/splat_prep.cu's
  E4: in this package its two passes; in a package whose E4 is a
  counting sort, its keys kernel, the sort and its pack kernel) and the
  sort-free setup (grace_sortfree_setup; in a package without
  sortfree_setup, the projection, slabs and packed overlaps it replaced)
  on the bench scene's sorted particles, weights 1, the splat frame
  (build, rays + sort, bucket, splat) and one sort-free training step
  (forward, L2 loss against 1.01 x its image, backward, SGD 1e-6); each
  timed (CUDA events, median of 10 after a warm run) with the device's
  busy ms and device operations over one call (torch.profiler), and
  bucket_prims_ortho's operations each with its device time (the mean of
  20 calls) and the call's host share (the call less its busy time). First
  (not with --no-variants) E4's variants bound in the package's place
  through _bucket_prims_ortho_kernels, each compared one bit-equal to the
  package's first and all timed in turns by the call's device time, its
  operations summed (prep_ablations): in this package (prep_variants)
  blocks of 1,024, 2,048 and 8,192 particles, 128 threads a block, 1, 2
  and 8 particles a thread loaded at once, per-warp counters
  summed in warp order, the keys and rows kept in device memory between
  the passes, pass 2 at four blocks an SM, streaming slab stores, and the
  leave-outs no slab writes, no counting, no warp offsets, no scatter; in
  a package whose E4 is a counting sort (PARENT_PREP_VARIANTS) its counts
  and cursors in shared memory and the leave-outs no pack gather, no slab
  writes. In a
  package whose constants' caches are
  ``_FRAME_CACHE`` and ``_SETUP_CACHE`` (this one) also both setups with
  the camera's constants computed anew each call instead of taken from
  their cache. In a package with the sort-free setup's resources query
  (this one) first the setup's kernel as shipped and with each lane's slab
  values written as four 4-byte stores instead of one float4 a row, on
  the bench, bit-equal and timed in turns, and the sort-free setup's
  kernel's device time (torch.profiler over 20 calls). With --parent DIR,
  DIR's grace_tpu_torch and this one run in turns (parent, this, this,
  parent; --rounds K times), each in a process of its own.

  broadphase: what the dense broadphase and the triangle lists feed,
  through the package's user functions only: E6's boxes (the segment
  boxes at blocks 32 and 128, the tile boxes at tiles 128 and 64, both
  sets as the dense callers take them: one launch where the package has
  broadphase_boxes_cuda, else two), the dense calls
  (dense_tile_masks_quarter at tiles 128 and 64, dense_tile_masks,
  quarter_lists, dense_tile_segments, dense_segment_tiles; tile 128),
  each with its call (CUDA events, median of 10), its host time
  (time.perf_counter around the call, no synchronisation, median of 50)
  and its device operations with their times (torch.profiler, 20 calls);
  E6's overlap words alone (tile 64 against quarters, with the summary;
  also its kernel's device time), the quarter trace (pallas_trace_sph,
  broadphase="quarter", tile 128), the default record trace (512 a ray),
  the quarter masks and quarter_lists alone (tile 64 and 128),
  render_triangles(engine="pallas") on the torus at 512 x 512 and one
  fused-renderer training step (tile 128, max_chunks and max_tiles_per_seg
  2048) on the bench scene, each timed (CUDA events, median of 10 after a
  warm run) with the device's busy ms and device operations over one call.
  First, in a package with the overlap kernel's resources query (this one
  and its parent), the overlap words as shipped and in variants (the hull
  cull left out: every word fine-tested; at most 128, 64 and 32 rows a
  block; 4 and 16 warps a block; two and eight blocks an SM; rows in
  contiguous groups; candidates two at a time; the hulls by integer
  reductions; and, timed only, the strip's staging and hulls alone, the
  staging alone, no word stores, no fine test) on the bench at tile 64
  and 128 against quarters with the summary and segments against tiles,
  bit-equal and timed in turns; then, in a package with the
  one-launch boxes (this one), the box kernel as shipped and in variants
  (BOX_VARIANTS: reductions by shuffles, 4-byte rays at every tile,
  16-byte rays from tile 4, a tile over up to 8 warps, 16-byte stores;
  timed only, no reductions) on the bench at quarters and tile 128 and at
  segments and tile 64, bit-equal and timed in turns by the kernel's
  device time. With --parent DIR, DIR's grace_tpu_torch and this one in
  turns (parent, this, this, parent; --rounds K times), each a process of
  its own; the variants run in the first of each side's processes only
  (--no-variants in the others).

  tri_lists: E7 (tri_tile_lists_cuda, csrc/tri_lists.cu) through the
  package's user functions only, on render_triangles' primary and shadow
  rays of the torus (512 x 512, tiles of 32, max_chunks 2048, as
  pallas_trace_tri lists them): the wrapper's call (CUDA events, median
  of 10 after a warm run) with its kernel's device time (torch.profiler,
  20 calls) and the call's device operations and busy ms, and
  render_triangles(engine="pallas"); with --parent DIR, DIR's
  grace_tpu_torch and this one in turns (parent, this, this, parent;
  --rounds K times), each a process of its own. First, in each side's
  first process, the kernel's variants bound in the package's place,
  each compared one bit-equal to its package's shipped kernel and all
  timed in turns by the kernel's device time: in this package
  (tri_variants) boxes from device memory, 4-byte row stores, warp
  buffers of 128, 64 and 32 entries, one block an SM at 128 registers, 8
  warps a block at three and four blocks an SM, 32 warps a block, a grid
  of one block an SM, blocks that are not persistent (a warp a tile,
  every block staging the boxes), row stores not streaming, the hulls by two
  redux.sync a (k, axis) (the first form), tiles by a grid stride,
  without the word hulls, without the union tests, and the leave-outs no
  sort, no row writes, nothing listed, the hulls alone (also without
  their folds, and with f32 fmas) and no tiles; in the
  parent's (a block a tile: PARENT_TRI_VARIANTS) its boxes staged once a
  block in 396 persistent blocks, and the leave-outs no sort and no row
  writes.

  morton: E2's keys (csrc/build.cu) on the bench scene and main path 1's
  rays: morton_keys_sph (its box folded in the launch), spatial_sort_rays,
  the keys at a given box, the 63-bit keys, rays + sort and build_sph_tree,
  each call's ms, host ms, device operations with their times and the keys
  kernel's device time; with --parent DIR, DIR's grace_tpu_torch and this
  one in turns; in this package's first process the kernel's variants
  (KEYS_VARIANTS: every item read again after the grid barrier, 16 held,
  6 blocks an SM, the f64 clamp conversion, the 30-bit spread in 64-bit
  ints, the partial boxes folded by block 0 behind a second barrier; the
  leave-outs without the barrier and with each block's own box) bit-
  equal to the shipped kernel and timed in turns by device time, and the
  folding grid capped at 132 blocks.

  compaction: E6's compaction (csrc/broadphase.cu) at the main paths'
  shapes (path 2's qlist and list rows, path 3's dense_tile_segments and
  dense_segment_tiles, the quarter words at tile 64 and max_q 512): each
  call and the kernel's device time, set bits and the byte bound; with
  --parent DIR in turns; the kernel's variants (COMPACT_VARIANTS: 4-byte
  padding stores, 16-byte padding stores not streaming, 4-byte word
  loads, no group's loads ahead; the leave-out without padding). The
  broadphase part runs it too.

Then each shipped kernel on the same inputs launched in other orders of
its work units (ray tiles, segments), through the C entry point: as
listed, longest list first, and the longest units alone, with the spread
of the work a unit does; for the trace kernels also trace_list on the
quarter lists (B5, launched as listed by its wrapper).

Prints the card's name and power limit first and a JSON summary last.
Exits non-zero without a card.
"""

import concurrent.futures
import ctypes
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from chip_smoke import (CAM, LENGTH, LOOK, MAX_PER_LEAF, N_PARTICLES, SIDE, SNAPSHOT_SEED,
                        SNAPSHOT_SIZES, TORUS, TRACE_TILE, UP, VEXT, _popcount_rows, check_close,
                        cuda_ms, device_op_ms, entry_inputs, kernel_device_ms,
                        make_clustered_particles,
                        order_key_torch, packet_summary, records_inputs, render_inputs,
                        route_inputs,
                        sortfree_fwd_dense, sortfree_inputs, splat_dense, torus_mesh, tri_inputs,
                        walk_outputs)

def swap(file, old, new):
    """An edit of ``file`` that replaces its one occurrence of ``old``."""
    def edit(text):
        if text.count(old) != 1:
            raise AssertionError(f"{file}: {old!r} is not in the source once")
        return text.replace(old, new)
    return file, edit


def swap_function(file, name, replacement):
    """An edit of ``file`` that replaces the definition of device function
    ``name`` (from its signature to the first closing brace at column 0)."""
    def edit(text):
        start = text.index(f"__device__ __forceinline__ void {name}(")
        return text[:start] + replacement + text[text.index("\n}\n", start) + 3:]
    return file, edit


# The two earlier forms of stage.cuh's accumulate_staged. The loop as
# shipped before the cull: the integral and the Kahan update for every
# staged pair, zero or not; it sums other terms (the +-0 ones too), so it
# is held to the kernel-vs-plain tolerance, not to the shipped bits.
EVERY_PAIR_LOOP = """__device__ __forceinline__ float seg_pair(const RaySeg& r, float px, float py,
                                          float pz, float inv_h2, float h2,
                                          int mode, const float* coeffs,
                                          int deg) {
    float dot, bx, by, bz;
    const float b2 = impact(px, py, pz, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, dot, bx, by, bz);
    const bool along = (dot >= 0.0f) && (dot < r.len);
    if (mode == kModeHitcount) {
        return (along && b2 < h2) ? 1.0f : 0.0f;
    }
    const float u = b2 * inv_h2;
    if (deg >= 0) {
        return along ? horner1_integral(u, coeffs, deg) * inv_h2 : 0.0f;
    }
    const float t = 2.0f * fminf(u, 1.0f) - 1.0f;
    float acc = coeffs[-deg];
    for (int k = -deg - 1; k >= 0; --k) {
        acc = fmaf(acc, t, coeffs[k]);
    }
    return (along && u < 1.0f) ? acc * inv_h2 : 0.0f;
}

__device__ __forceinline__ void accumulate_staged(const StagedPrims& s, int n,
                                                  const RaySeg& r, int mode,
                                                  const float* s_coeffs,
                                                  int deg, float& acc,
                                                  float& comp) {
    for (int i = 0; i < n; ++i) {
        const float v = seg_pair(r, s.x[i], s.y[i], s.z[i], s.inv_h2[i],
                                 s.h2[i], mode, s_coeffs, deg);
        const float y = v - comp;
        const float t = acc + y;
        comp = (t - acc) - y;
        acc = t;
    }
}
"""
# The cull inline: one loop, the integral and the update only for the pairs
# that pass (the same terms in the same order as the two phases).
CULL_INLINE = """__device__ __forceinline__ void accumulate_staged(const StagedPrims& s, int n,
                                                  const RaySeg& r, int mode,
                                                  const float* s_coeffs,
                                                  int deg, float& acc,
                                                  float& comp) {
    for (int i = 0; i < n; ++i) {
        float dot, bx, by, bz;
        const float b2 = impact(s.x[i], s.y[i], s.z[i], r.ox, r.oy, r.oz, r.dx, r.dy,
                                r.dz, dot, bx, by, bz);
        const bool along = dot >= 0.0f && dot < r.len;
        if (mode == kModeHitcount) {
            if (along && b2 < s.h2[i]) acc += 1.0f;
            continue;
        }
        const float u = b2 * s.inv_h2[i];
        if (along && u < 1.0f) {
            const float v = seg_term(u, s.inv_h2[i], s_coeffs, deg);
            const float y = v - comp;
            const float t = acc + y;
            comp = (t - acc) - y;
            acc = t;
        }
    }
}
"""
# Phase 2 over wider masks: the warp runs the integral as often as its
# busiest lane has passes among 64 (128) staged slots, instead of summing
# each 32-slot word's busiest lane. The same terms in the same order.
ADD_TERM = """__device__ __forceinline__ void add_term(const StagedPrims& s, int i, const RaySeg& r,
                                         const float* s_coeffs, int deg, float& acc,
                                         float& comp) {
    float dot, bx, by, bz;
    const float b2 = impact(s.x[i], s.y[i], s.z[i], r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, dot,
                            bx, by, bz);
    const float v = seg_term(b2 * s.inv_h2[i], s.inv_h2[i], s_coeffs, deg);
    const float y = v - comp;
    const float t = acc + y;
    comp = (t - acc) - y;
    acc = t;
}

__device__ __forceinline__ void accumulate_staged(const StagedPrims& s, int n,
                                                  const RaySeg& r, int mode,
                                                  const float* s_coeffs,
                                                  int deg, float& acc,
                                                  float& comp) {
    if (mode == kModeHitcount) {
        for (int base = 0; base < n; base += 32) {
            acc += static_cast<float>(__popc(pass_bits32<true>(s, base, r)));
        }
        return;
    }
"""
MASK64 = ADD_TERM + """    for (int base = 0; base < n; base += 64) {
        uint64_t bits = pass_bits32<false>(s, base, r);
        if (base + 32 < n) {
            bits |= static_cast<uint64_t>(pass_bits32<false>(s, base + 32, r)) << 32;
        }
        while (bits) {
            const int i = base + __ffsll(static_cast<long long>(bits)) - 1;
            bits &= bits - 1;
            add_term(s, i, r, s_coeffs, deg, acc, comp);
        }
    }
}
"""
MASK128 = ADD_TERM + """    for (int base = 0; base < n; base += 128) {
        uint64_t lo = pass_bits32<false>(s, base, r), hi = 0;
        if (base + 32 < n) lo |= static_cast<uint64_t>(pass_bits32<false>(s, base + 32, r)) << 32;
        if (base + 64 < n) hi = pass_bits32<false>(s, base + 64, r);
        if (base + 96 < n) hi |= static_cast<uint64_t>(pass_bits32<false>(s, base + 96, r)) << 32;
        while (lo | hi) {
            int i;
            if (lo) {
                i = base + __ffsll(static_cast<long long>(lo)) - 1;
                lo &= lo - 1;
            } else {
                i = base + 63 + __ffsll(static_cast<long long>(hi));
                hi &= hi - 1;
            }
            add_term(s, i, r, s_coeffs, deg, acc, comp);
        }
    }
}
"""


def trace_variants(source, shipped_buffers):
    """The variants of a trace kernel whose source sets kStageBuffers to
    ``shipped_buffers``: the two earlier loops, the two phases on 32-slot
    masks (shipped) with the other buffer count, and wider masks."""
    other = 3 - shipped_buffers
    label = lambda k: f"two phases, {k} buffer{'s' if k > 1 else ''}"
    return {
        "integral every pair": [swap_function("stage.cuh", "accumulate_staged",
                                              EVERY_PAIR_LOOP)],
        "cull inline": [swap_function("stage.cuh", "accumulate_staged", CULL_INLINE)],
        f"{label(shipped_buffers)} (shipped)": None,
        label(other): [swap(source, f"kStageBuffers = {shipped_buffers};",
                            f"kStageBuffers = {other};")],
        "64-slot masks": [swap_function("stage.cuh", "accumulate_staged", MASK64)],
        "128-slot masks": [swap_function("stage.cuh", "accumulate_staged", MASK128)],
    }


# Variants that sum other terms than the shipped kernel.
NOT_BIT_EQUAL = {"integral every pair"}

# kernel -> (library name, entry, variants {label: edits of a copy of csrc/,
# None for the shipped source})
ABLATIONS = {
    "render_bwd": ("render", "grace_render_bwd", {
        "batch 1": [swap("render.cu", "kBwdBatch = 4;", "kBwdBatch = 1;")],
        "batch 2": [swap("render.cu", "kBwdBatch = 4;", "kBwdBatch = 2;")],
        "batch 4 (shipped)": None,
        "batch 4, no load ahead": [swap("render.cu", "cp_async_wait<1>();  // batch b's",
                                        "cp_async_wait<0>();  // batch b's")],
    }),
    "trace_tri": ("tri", "grace_tri", {
        "1 warp a block": [swap("tri.cu", "kBlockWarps = 4;", "kBlockWarps = 1;")],
        "2 warps a block": [swap("tri.cu", "kBlockWarps = 4;", "kBlockWarps = 2;")],
        "4 warps a block (shipped)": None,
        "8 warps a block": [swap("tri.cu", "kBlockWarps = 4;", "kBlockWarps = 8;")],
        "4 warps, no copy ahead": [swap("tri.cu", "cp_async_wait<1>();  // entry j's",
                                        "cp_async_wait<0>();  // entry j's")],
    }),
    "trace_bitmask": ("trace_bitmask", "grace_trace_bitmask",
                      trace_variants("trace_bitmask.cu", 2)),
    "trace_list_seg": ("trace_list", "grace_trace_list", trace_variants("trace_list.cu", 1)),
}


def build_variant(lib_name, tag, edits, csrc=None, entries=None):
    """Library ``lib_name`` built from a copy of ``csrc`` (default: the
    package's csrc/) with ``edits`` applied (None: as shipped), with the
    package's nvcc flags; its entry points (default: the package's, else
    ``entries``, {name: argument kinds}) bound as ``_kernels.load`` binds
    them."""
    from grace_tpu_torch import _kernels

    src_dir = os.path.join(_kernels.BUILD_DIR, "ablation", tag)
    shutil.rmtree(src_dir, ignore_errors=True)
    shutil.copytree(csrc or _kernels.CSRC, src_dir)
    for file, edit in edits or ():
        path = os.path.join(src_dir, file)
        with open(path) as f:
            text = edit(f.read())
        with open(path, "w") as f:
            f.write(text)
    source = _kernels.KERNELS[lib_name][0]
    lib = os.path.join(src_dir, lib_name + ".so")
    cmd = [_kernels._nvcc(), *_kernels._NVCC_FLAGS, *_kernels.KERNELS[lib_name][1], "-o", lib,
           os.path.join(src_dir, source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag}:\n{res.stdout}{res.stderr}")
    for line in (res.stdout + res.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas {tag}: {line.strip()}", flush=True)
    dll = ctypes.CDLL(lib)
    for name, kinds in (entries or _kernels.KERNELS[lib_name][2]).items():
        getattr(dll, name).argtypes = ([ctypes.c_void_p if k == "p" else ctypes.c_int
                                        for k in kinds] + [ctypes.c_int, ctypes.c_void_p])
        getattr(dll, name).restype = ctypes.c_int
    return dll


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


def ablate(kernel, calls, resource_ints=None):
    """Build every variant of ``kernel``, check its outputs on each of
    ``calls`` (label -> (args, outputs)) against the shipped variant's, and
    time them in turns. Outputs must be bit-equal, but for a variant in
    NOT_BIT_EQUAL on a call not labelled hitcount: within rtol 1e-5, atol
    1e-6 x max (the kernel-vs-plain tolerance). With ``resource_ints``,
    prints each variant's resources from its ``*_resources`` query.
    Returns {call label: {variant: ms}}."""
    from grace_tpu_torch import _kernels

    lib_name, entry, variants = ABLATIONS[kernel]
    fns = {}
    for i, (v, edits) in enumerate(variants.items()):
        dll = build_variant(lib_name, f"{kernel}-{i}", edits)
        fns[v] = getattr(dll, entry)
        if resource_ints is not None:
            out = (ctypes.c_int * len(_kernels.RESOURCE_FIELDS))()
            call(getattr(dll, entry + "_resources"), [ctypes.addressof(out), *resource_ints])
            print(f"resources {kernel} {v}: "
                  f"{json.dumps(dict(zip(_kernels.RESOURCE_FIELDS, out)))}", flush=True)
    shipped = next(v for v, edits in variants.items() if edits is None)
    result = {}
    for label, (args, outs) in calls.items():
        call(fns[shipped], args)
        want = [o.clone() for o in outs]
        for v, fn in fns.items():
            for o in outs:
                o.fill_(-7)
            call(fn, args)
            torch.cuda.synchronize()
            if v in NOT_BIT_EQUAL and "hitcount" not in label:
                for o, w in zip(outs, want):
                    check_close(f"{kernel} {label} {v}", o, w, 1e-5, 1e-6 * float(w.abs().max()))
            elif not all(torch.equal(o, w) for o, w in zip(outs, want)):
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
            same = ("within rtol 1e-5 of" if v in NOT_BIT_EQUAL and "hitcount" not in label
                    else "bits equal to")
            print(f"{kernel} {label} {v}: {statistics.median(x):.3f} ms (median of {len(x)}; "
                  f"min {min(x):.3f}, max {max(x):.3f}); {same} {shipped}", flush=True)
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


def trace_call(kind, args, order, mode, deg=14):
    """(kernel arguments, outputs) of grace_trace_bitmask (``kind``
    "bitmask", ``args`` = (words, packed rays, prims)) or grace_trace_list
    ("list", (counts, ids, packed rays, prims, group)) as the wrappers pass
    them, tiles launched in ``order`` (None: as listed)."""
    from grace_tpu_torch.trace import pallas_kernel as pk

    if kind == "bitmask":
        words, packed, prims = args
        tensors = (words, order, packed, prims)
        n_tiles = words.shape[0]
        ints = (n_tiles, packed.shape[0] // n_tiles, words.shape[1], prims.shape[1] // 128)
    else:
        counts, ids, packed, prims, group = args
        tensors = (counts, ids, order, packed, prims)
        n_tiles = counts.shape[0]
        ints = (n_tiles, packed.shape[0] // n_tiles, ids.shape[1], group, prims.shape[1])
    if prims.data_ptr() % 16:
        raise AssertionError("the trace kernels stage from 16-byte aligned slabs")
    out = torch.empty(packed.shape[0], dtype=torch.float32, device=packed.device)
    coeffs = pk._coeff_tensor(deg, str(packed.device))
    return ([None if t is None else t.data_ptr() for t in tensors]
            + [coeffs.data_ptr(), out.data_ptr(), *ints, deg, pk.MODES.index(mode)], (out,))


def trace_orders(label, kind, args, longest, lengths):
    """The shipped kernel on the bench inputs with its tiles launched as
    listed, longest walk first (``longest``, the wrapper's order), and the
    longest tiles alone (one a resident block of the card: their inputs
    gathered, launched as listed); outputs bit-equal. Returns {order: ms}
    (CUDA events, median of 10)."""
    from grace_tpu_torch import _kernels

    lib = "trace_bitmask" if kind == "bitmask" else "trace_list"
    fn = getattr(_kernels.load(lib), f"grace_{lib}")
    packed = args[1] if kind == "bitmask" else args[2]
    n_tiles = lengths.shape[0]
    tile = packed.shape[0] // n_tiles
    spread(f"{label}: groups listed per tile", lengths)
    resident = resident_warps(lib, f"grace_{lib}_resources", packed.device, tile) * 32 // tile
    top = longest[:resident].long()
    rows = packed.view(n_tiles, tile, 16)[top].reshape(-1, 16)
    alone = ((args[0][top], rows, args[2]) if kind == "bitmask"
             else (args[0][top], args[1][top], rows, args[3], args[4]))
    base, (out,) = trace_call(kind, args, None, "cumulative")
    call(fn, base)
    want = out.clone()
    result = {}
    for name, (a, expect) in {
            "as listed": (args, want), "longest first": (args, want),
            f"longest {resident} alone": (alone, want.view(n_tiles, tile)[top].flatten())}.items():
        c_args, (o,) = trace_call(kind, a, longest if name == "longest first" else None,
                                  "cumulative")
        call(fn, c_args)
        torch.cuda.synchronize()
        if not torch.equal(o, expect):
            raise AssertionError(f"{label} {name}: results differ")
        times = []
        for _ in range(10):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call(fn, c_args)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        result[name] = statistics.median(times)
        print(f"{label} {name}: {result[name]:.3f} ms (median of 10; min {min(times):.3f}, "
              f"max {max(times):.3f})", flush=True)
    return result


def trace_ablations(sorted_spheres, rays_s):
    """B6 and B8 (and B5's launch order) on main path 2's inputs: the bench
    scene's sorted rays at tile 128, segment words, segment lists and quarter
    lists sized to the longest row."""
    from grace_tpu_torch.trace import pallas_kernel as pk

    bm = route_inputs("bitmask", rays_s, sorted_spheres, None, TRACE_TILE)[2]
    sl = route_inputs("list", rays_s, sorted_spheres, None, TRACE_TILE,
                      int(_popcount_rows(bm[0]).max()))[2]
    q = route_inputs("quarter", rays_s, sorted_spheres, None, TRACE_TILE)[2][1]
    ql = route_inputs("qlist", rays_s, sorted_spheres, None, TRACE_TILE,
                      (int(_popcount_rows(q).max()) + 3) // 4 * 4)[2]
    summary = {}
    for kernel, kind, args, order in (
            ("trace_bitmask", "bitmask", bm, pk.bitmask_tile_order(bm[0])),
            ("trace_list_seg", "list", sl, pk.list_tile_order(sl[0], sl[1].shape[1]))):
        summary[kernel] = ablate(kernel, {f"bench scene {m}": trace_call(kind, args, order, m)
                                          for m in ("cumulative", "hitcount")}, (TRACE_TILE,))
    summary["trace tile orders"] = {
        "trace_bitmask": trace_orders("trace_bitmask tiles", "bitmask", bm,
                                      pk.bitmask_tile_order(bm[0]), _popcount_rows(bm[0])),
        "trace_list_seg": trace_orders("trace_list segment-list tiles", "list", sl,
                                       pk.list_tile_order(sl[0], sl[1].shape[1]), sl[0]),
        "trace_list_quarter": trace_orders("trace_list quarter-list tiles", "list", ql,
                                           pk.list_tile_order(ql[0], ql[1].shape[1]), ql[0]),
    }
    return summary


# The splat kernels' variants (csrc/splat_common.cuh, splat.cu,
# splat_sortfree.cu), each step of the redesign taken back in turn; every
# variant sums the same terms in the same order, so all are bit-equal.
# The factors built only inside the footprints (into zeroed arrays), then
# contracted densely: every batch instance against every pixel.
ZERO_FILL_BUILD = """\
template <int DEG>
__device__ __forceinline__ void build_factors(const Layout& l, int n, int tile_w, int band,
                                              int rank, int deg) {
    const int tw4 = padded_rows(tile_w);
    for (int e = threadIdx.x; e < n * rank * tw4; e += kThreads) l.fa[e] = 0.0f;
    for (int e = threadIdx.x; e < n * rank * band; e += kThreads) l.fb[e] = 0.0f;
    __syncthreads();
    build_support<DEG>(l, n, tile_w, band, rank, deg);
}

"""
DENSE_CONTRACT = """\
__device__ __forceinline__ void contract(const Layout& l, int n, int tile_w, int band, int rank,
                                         float (&acc)[NT][kRows]) {
    const int tw4 = padded_rows(tile_w);
    const int n_groups = (band + 31) / 32;
    const int tasks = n_tasks(tile_w, band);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
        const int task = warp + j * kWarps;
        if (task >= tasks) continue;
        const int r0 = task / n_groups * kRows;
        const int c = min(task % n_groups * 32 + lane, band - 1);
        for (int i = 0; i < n; ++i) {
            const float* a = l.fa + i * rank * tw4 + r0;
            const float* b = l.fb + i * rank * band + c;
            for (int k = 0; k < rank; ++k) {
                float av[kRows];
                load_rows(a + k * tw4, av);
                const float bv = b[k * band];
#pragma unroll
                for (int rr = 0; rr < kRows; ++rr) acc[j][rr] = fmaf(av[rr], bv, acc[j][rr]);
            }
        }
    }
}
"""
DENSE_STEP = [swap("splat_common.cuh", "__device__ __forceinline__ void build_factors(",
                   "__device__ __forceinline__ void build_support("),
              swap("splat_common.cuh", "// kRows consecutive A entries",
                   ZERO_FILL_BUILD + "// kRows consecutive A entries"),
              swap_function("splat_common.cuh", "contract", DENSE_CONTRACT)]
ONE_ROW = [swap("splat_common.cuh", "constexpr int kRows = 4;", "constexpr int kRows = 1;")]


def runtime_degree(file, prefix):
    """The Horner loop with its degree at run time (no unrolled build)."""
    return [swap(file, f"""return deg == 8 ? {prefix}kernel_for_nt<8>(nt)
                    : deg == 10 ? {prefix}kernel_for_nt<10>(nt) : {prefix}kernel_for_nt<0>(nt);""",
                 f"return {prefix}kernel_for_nt<0>(nt);")]


def row_parts(file, shipped, parts):
    """Each patch cut into ``parts`` blocks along its rows (``shipped``
    as shipped)."""
    return [swap(file, f"constexpr int kRowParts = {shipped};",
                 f"constexpr int kRowParts = {parts};")]


def splat_steps(file, prefix, shipped_parts):
    """The redesign's steps up to the shipped row parts, each adding one to
    the one before (its edits of the shipped source)."""
    whole = row_parts(file, shipped_parts, 1)
    deg = runtime_degree(file, prefix)
    return {"support-only factors, dense contraction": DENSE_STEP + deg + whole,
            "+ culled contraction, 1 row a thread": ONE_ROW + deg + whole,
            "+ 4 rows a thread (register blocking)": deg + whole,
            "+ Horner degree at compile time": whole}
# B11 with a run_batch after every cull round (two listed segments)
# instead of a batch that gathers several rounds.
PER_SEGMENT = [swap("splat_sortfree.cu", "        parity ^= 1;\n",
                    "        parity ^= 1;\n        if (n > 0) {\n"
                    "            splat::run_batch<NT, DEG>(l, n, tile_w, band, rank, deg, acc);\n"
                    "            n = 0;\n        }\n")]
ABLATIONS.update({
    "splat": ("splat", "grace_splat", {
        **splat_steps("splat.cu", "", 4),
        "+ rows over 4 blocks (shipped)": None,
        "shipped, rows over 2 blocks": row_parts("splat.cu", 4, 2),
        "shipped, rows over 8 blocks": row_parts("splat.cu", 4, 8),
    }),
    "splat_sortfree_fwd": ("splat_sortfree", "grace_splat_sortfree_fwd", {
        **{f"{step}, a batch a round": edits + PER_SEGMENT
           for step, edits in splat_steps("splat_sortfree.cu", "fwd_", 2).items()},
        "+ rows over 2 blocks, a batch a round": PER_SEGMENT,
        "+ batches across rounds (shipped)": None,
        "shipped, rows over 1 block": row_parts("splat_sortfree.cu", 2, 1),
        "shipped, rows over 4 blocks": row_parts("splat_sortfree.cu", 2, 4),
    }),
})


def splat_call(buckets, order, sub, basis="deg8", tile_w=32, band=32):
    """(kernel arguments, outputs) of grace_splat as splat_image passes
    them, keys in ``order`` (None: as listed), ``sub`` instances a batch."""
    from grace_tpu_torch.trace import splat as sp

    deg, a, _ = sp.SPLAT_BASES[basis]
    a_t, b_t = sp._basis_tensors(basis, str(buckets.slabs.device))
    w_res, h_res = buckets.xcols.shape[0], buckets.yrows.shape[0]
    out = torch.empty((h_res, w_res), dtype=torch.float32, device=buckets.slabs.device)
    ptrs = [t.data_ptr() for t in (buckets.slab_lo, buckets.n_slabs, buckets.first,
                                   buckets.last)]
    ptrs += [None if order is None else order.data_ptr()]
    ptrs += [t.data_ptr() for t in (buckets.xcols, buckets.yrows, buckets.slabs, a_t, b_t, out)]
    return ptrs + [buckets.first.shape[0], w_res // band, tile_w, band, buckets.slabs.shape[2],
                   w_res, buckets.slabs.shape[0], len(a), deg, sub], (out,)


def sortfree_call(inputs, order, sub, basis="deg8", tile_w=32, tile_h=128):
    """(kernel arguments, outputs) of grace_splat_sortfree_fwd as
    splat_sortfree_fwd passes them for a SIDE x SIDE image, tiles in
    ``order`` (None: as listed)."""
    from grace_tpu_torch.trace import splat_grad as sg

    side = SIDE
    masks, _, coords, slabs = inputs
    deg, a, _ = sg._basis_coeffs(basis)
    dev = slabs.device
    out = torch.empty((side, side), dtype=torch.float32, device=dev)
    ptrs = [masks.data_ptr(), None if order is None else order.data_ptr(), coords.data_ptr(),
            slabs.data_ptr(), sg._basis_tensor(basis, "a", str(dev)).data_ptr(),
            sg._basis_tensor(basis, "b", str(dev)).data_ptr(), out.data_ptr()]
    return ptrs + [masks.shape[0], masks.shape[1], slabs.shape[0], side // tile_h, tile_w,
                   tile_h, sg._fwd_band(tile_h), side, a.shape[0], deg, sub], (out,)


def in_turns(label, runs, want, rtol=None):
    """Time ``runs`` ({name: (function, its output or None)}) in turns, 5
    times forward and back (CUDA events, median of 10), each output first
    held bit-equal to ``want`` (with ``rtol``: within rtol x max). Returns
    {name: ms}."""
    for name, (fn, out) in runs.items():
        if out is None:
            continue
        out.fill_(-7)
        fn()
        torch.cuda.synchronize()
        if rtol is None:
            if not torch.equal(out, want):
                raise AssertionError(f"{label} {name}: {int((out != want).sum())} values differ")
        else:
            check_close(f"{label} {name}", out, want, 0.0, rtol * float(want.abs().max()))
    times = {name: [] for name in runs}
    for _ in range(5):
        for name in list(runs) + list(runs)[::-1]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            runs[name][0]()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end))
    result = {name: statistics.median(x) for name, x in times.items()}
    for name, x in times.items():
        same = ("not compared with" if runs[name][1] is None else
                f"within {rtol} x max of" if rtol is not None else "bits equal to")
        print(f"{label} {name}: {result[name]:.3f} ms (median of {len(x)}; min {min(x):.3f}, "
              f"max {max(x):.3f}); {same} the reference", flush=True)
    return result


def split_keys(buckets, threshold, tile_w=32, band=32):
    """The bucketed image with every key of more than ``threshold``
    instances cut into pieces of equal count: the first piece stays at the
    key, piece p goes to a key of an extra row tile below the image (at
    the key's column band; its rows repeat the key's rows). Returns (the
    split buckets, [(key, piece key)] in piece order)."""
    first, last = buckets.first.tolist(), buckets.last.tolist()
    h_res, w_res = buckets.yrows.shape[0], buckets.xcols.shape[0]
    nbx, nty = w_res // band, h_res // tile_w
    pieces = []
    for k, (lo, hi) in enumerate(zip(first, last)):
        n_p = -(-(hi - lo) // threshold)
        step = -(-(hi - lo) // max(n_p, 1))
        for p in range(1, n_p):
            pieces.append((k, lo + p * step, min(hi, lo + (p + 1) * step)))
        if n_p > 1:
            last[k] = lo + step
    keys = list(zip(first, last)) + [(0, 0)] * (len(pieces) * nbx)
    rows = [buckets.yrows]
    moved = []
    for m, (k, lo, hi) in enumerate(pieces):
        v = (nty + m) * nbx + k % nbx
        keys[v] = (lo, hi)
        rows.append(buckets.yrows[k // nbx * tile_w:(k // nbx + 1) * tile_w])
        moved.append((k, v))
    dev = buckets.slabs.device
    f, la = (torch.tensor(c, dtype=torch.int32, device=dev) for c in zip(*keys))
    per_slab = 2 * buckets.slabs.shape[2]
    slab_lo = torch.div(f, per_slab, rounding_mode="floor")
    n_slabs = torch.clamp(torch.div(la + per_slab - 1, per_slab, rounding_mode="floor")
                          - slab_lo, min=0)
    return buckets._replace(first=f, last=la, slab_lo=slab_lo.to(torch.int32),
                            n_slabs=n_slabs.to(torch.int32),
                            yrows=torch.cat(rows).contiguous()), moved


def splat_ablations(sorted_spheres, weights):
    """B1 and B11 on main paths 1 and 3's inputs (the bench scene, 512x512,
    32 x 32 patches, deg8): the dense loop replaced, the redesign's steps
    taken back in turn, batch sizes, launch orders and, for B1, the
    heaviest keys split over several blocks."""
    from grace_tpu_torch import _kernels
    from grace_tpu_torch.trace import splat as sp
    from grace_tpu_torch.trace import splat_grad as sg

    buckets = sp.bucket_prims_ortho(sorted_spheres, CAM, LOOK, UP, VEXT, LENGTH, SIDE, SIDE,
                                    tile_w=32, tile_h=128, chunk=512, band=32)
    counts = buckets.last - buckets.first
    spread("splat: instances per key", counts)
    order = sp.splat_key_order(buckets.first, buckets.last)
    summary = {"splat": ablate("splat", {"bench scene": splat_call(buckets, order,
                                                                    sp.SPLAT_BATCH)},
                               (32, 32, 5, 8, sp.SPLAT_BATCH))}
    want = splat_dense(buckets, 32, 32, "deg8")
    fn = _kernels.load("splat").grace_splat
    dense = torch.empty_like(want)
    runs = {"the dense loop (csrc/splat_dense.cu), as listed": (
        lambda: dense.copy_(splat_dense(buckets, 32, 32, "deg8")), dense)}
    for name, o, sub in (("as listed, batch 64", None, 64), ("heaviest first, batch 32", order, 32),
                         ("heaviest first, batch 64 (shipped)", order, 64),
                         ("heaviest first, batch 128", order, 128)):
        args, (out,) = splat_call(buckets, o, sub)
        runs[name] = (lambda a=args: call(fn, a), out)
    summary["splat orders and batches"] = in_turns("splat", runs, want)
    a8, b8 = (np.asarray(c, np.float32) for c in sp.SPLAT_BASES["deg8"][1:])
    plain = sp._splat_plain(buckets, 32, 32, a8, b8)
    per_sm = int(counts.sum()) // torch.cuda.get_device_properties(0).multi_processor_count
    split_runs = {}
    for threshold in (per_sm, per_sm // 2):
        split, moved = split_keys(buckets, threshold)
        s_order = sp.splat_key_order(split.first, split.last)
        args, (out,) = splat_call(split, s_order, sp.SPLAT_BATCH)
        img = torch.empty_like(plain)

        def run(a=args, out=out, moved=moved, img=img, held=(split, s_order)):
            call(fn, a)  # (held: the tensors behind a's pointers)
            img.copy_(out[:SIDE])
            nbx = SIDE // 32
            for k, v in moved:  # the second pass, pieces in order
                r, c, rv = k // nbx * 32, k % nbx * 32, v // nbx * 32
                img[r:r + 32, c:c + 32] += out[rv:rv + 32, c:c + 32]

        label = f"keys over {threshold} instances split ({len(moved)} extra pieces)"
        split_runs[label] = (run, img)
        split_runs[label + ", kernel alone"] = (lambda a=args, held=(split, s_order): call(fn, a),
                                                None)
    summary["splat split keys"] = in_turns("splat split", split_runs, plain, rtol=1e-5)

    inputs = sortfree_inputs(sorted_spheres, weights, sg.OrthoCamera(
        CAM, LOOK, UP, VEXT, LENGTH, SIDE, SIDE), 32)
    spread("splat_sortfree_fwd: segments listed per tile", _popcount_rows(inputs[0]))
    t_order = sg.sortfree_tile_order(inputs[0])
    summary["splat_sortfree_fwd"] = ablate(
        "splat_sortfree_fwd", {"bench scene": sortfree_call(inputs, t_order, sg.FWD_BATCH)},
        (32, 32, 5, 8, sg.FWD_BATCH))
    masks, _, coords, slabs = inputs
    want = sortfree_fwd_dense(masks, coords, slabs, "deg8", 32, 128, SIDE, SIDE)
    fn = _kernels.load("splat_sortfree").grace_splat_sortfree_fwd
    dense = torch.empty_like(want)
    runs = {"the dense loop (csrc/splat_sortfree_fwd_dense.cu), as listed": (
        lambda: dense.copy_(sortfree_fwd_dense(masks, coords, slabs, "deg8", 32, 128, SIDE,
                                               SIDE)), dense)}
    for name, o, sub in (("as listed, batch 64", None, 64),
                         ("heaviest first, batch 32", t_order, 32),
                         ("heaviest first, batch 64 (shipped)", t_order, 64),
                         ("heaviest first, batch 128", t_order, 128)):
        args, (out,) = sortfree_call(inputs, o, sub)
        runs[name] = (lambda a=args: call(fn, a), out)
    summary["splat_sortfree_fwd orders and batches"] = in_turns("splat_sortfree_fwd", runs, want)
    return summary


# The record kernels' variants (csrc/records.cu). The parent's kernel, as
# it was before the redesign (from --parent DIR), with its entry points:
PARENT_RECORD_ENTRIES = {"grace_records_quarter": "ppppppppp" + "iiiiiii",
                         "grace_records_bitmask": "pppppppp" + "iiiiii"}
# ... and with its per-slot test and append replaced by the mask of 32
# tests first, then the integral and the append for the set bits only.
MASK_THEN_APPEND = """__device__ __forceinline__ void append_staged(
        const StagedPrims& s, const int* s_idx, int n, const RaySeg& r, const float* s_coeffs,
        int deg, const RecordRows& out, int64_t row, int& cursor) {
    for (int base = 0; base < n; base += 32) {
        uint32_t bits = pass_bits32<true>(s, base, r);
        while (bits) {
            const int i = base + __ffs(bits) - 1;
            bits &= bits - 1;
            if (cursor < out.cap) {
                float dot, bx, by, bz;
                const float b2 = impact(s.x[i], s.y[i], s.z[i], r.ox, r.oy, r.oz, r.dx, r.dy,
                                        r.dz, dot, bx, by, bz);
                const float inv_h2 = s.inv_h2[i];
                const int64_t at = row * out.cap + cursor;
                out.idx[at] = s_idx[i];
                out.intg[at] = horner1_integral(b2 * inv_h2, s_coeffs, deg) * inv_h2;
                out.dist[at] = dot;
            }
            ++cursor;
        }
    }
}
"""
# The shipped kernel's sentinel fill and counts taken back to the parent's:
# the block over all tile x cap entries of its rows, a 64-bit division per
# entry, the counts from shared memory.
DIVISION_FILL = """    __device__ __forceinline__ void finish(int32_t* counts) {
        if (__any_sync(members_, n_ > 0)) flush();
        __shared__ int s_counts[kMaxTile];
        counts[row0_ + lane_] = cursor_;
        s_counts[threadIdx.x] = cursor_;
        __syncthreads();
        const int64_t first = row0_ + lane_ - threadIdx.x;
        const int64_t n = static_cast<int64_t>(blockDim.x) * out_.cap;
        for (int64_t e = threadIdx.x; e < n; e += blockDim.x) {
            const int64_t rr = e / out_.cap;
            const int64_t c = e - rr * out_.cap;
            if (c >= s_counts[rr]) {
                const int64_t at = (first + rr) * out_.cap + c;
                out_.idx[at] = -1;
                out_.intg[at] = 0.0f;
                out_.dist[at] = -1.0f;
            }
        }
    }

"""


def swap_between(file, start, end, replacement):
    """An edit of ``file`` that replaces the text from ``start`` up to (not
    including) ``end``."""
    def edit(text):
        i = text.index(start)
        return text[:i] + replacement + text[text.index(end, i):]
    return file, edit


def records_const(name, shipped, value):
    return swap("records.cu", f"constexpr int {name} = {shipped};",
                f"constexpr int {name} = {value};")


# The shipped warp flush taken back to a row at a time, the warp's lanes
# along each row.
ROW_FLUSH = """    __device__ __forceinline__ void flush() {
        __syncwarp(members_);
        for (int j = 0; j < lanes_; ++j) {
            const int n = __shfl_sync(members_, n_, j);
            const int c0 = __shfl_sync(members_, col_, j);
            const int64_t at = (row0_ + j) * out_.cap + c0;
            for (int c = lane_; c < n; c += lanes_) {
                out_.idx[at + c] = p_idx_[j * kStride + c];
                out_.intg[at + c] = p_intg_[j * kStride + c];
                out_.dist[at + c] = p_dist_[j * kStride + c];
            }
        }
        __syncwarp(members_);
        col_ += n_;
        n_ = 0;
    }

"""


# The shipped append taken back to a store by each thread down its own
# row, C entries from its neighbours' (no pending slots, so no dynamic
# shared memory).
DIRECT_STORES = """    template <typename Hit>
    __device__ __forceinline__ void append(uint32_t bits, Hit hit) {
        while (bits && cursor_ < out_.cap) {
            const int q = __ffs(bits) - 1;
            bits &= bits - 1;
            const int64_t at = (row0_ + lane_) * out_.cap + cursor_;
            int32_t id;
            float v, d;
            hit(q, id, v, d);
            out_.idx[at] = id;
            out_.intg[at] = v;
            out_.dist[at] = d;
            ++cursor_;
        }
        cursor_ += __popc(bits);  // past the capacity: counted only
    }

"""
APPEND = "    template <typename Hit>\n    __device__ __forceinline__ void append("


def record_variants(shipped):
    """The redesign's steps, each adding one to the one before, then the
    shipped kernel with one thing changed. ``shipped``: the shipped
    constants {kPending, kStageBuffers, kBatch}."""
    const = lambda name, value: records_const(name, shipped[name], value)
    other_batch = 1024
    batch = [const("kBatch", other_batch)]
    direct = [swap_between("records.cu", APPEND, "    // The warp's pending records",
                           DIRECT_STORES),
              swap("records.cu", "*bytes = static_cast<size_t>((tile + 31) / 32) * 32 * 12 "
                   "* kStride;", "*bytes = 0;")]
    fill = [swap_between("records.cu", "    // The rest of the pending records", "  private:",
                         DIVISION_FILL)]
    steps = {
        f"cp.async staging across words (batches of {other_batch}), direct stores, the "
        "division fill": batch + direct + fill,
        "+ the fill a warp a row, no division": batch + direct,
        f"+ stores staged {shipped['kPending']} a ray, written by the warp": batch,
        f"+ batches of {shipped['kBatch']} (shipped)": None,
    }
    for pending in (8, 12, 16, 32):
        if pending != shipped["kPending"]:
            steps[f"shipped, {pending} pending a ray"] = [const("kPending", pending)]
    steps["shipped, the parent's fill (a 64-bit division an entry)"] = fill
    steps["shipped, the flush a row at a time"] = [
        swap_between("records.cu", "    // The warp's pending records, its rays' in turn",
                     "    // The rest of the pending records", ROW_FLUSH)]
    other = 3 - shipped["kStageBuffers"]
    steps[f"shipped, {other} staging buffer{'s' if other > 1 else ''}"] = [
        const("kStageBuffers", other)]

    def bounds_256(text):   # registers up to 255 a thread (tiles of at most 256)
        if text.count("__launch_bounds__(kMaxTile)") != 2:
            raise AssertionError("records.cu: the two kernels' launch bounds moved")
        return text.replace("__launch_bounds__(kMaxTile)", "__launch_bounds__(256)")

    steps["shipped, launch bounds 256 (more registers)"] = [("records.cu", bounds_256)]
    for b in (shipped["kBatch"] // 2, shipped["kBatch"] * 2):
        steps[f"shipped, batches of {b} primitives"] = [const("kBatch", b)]
    steps[NO_INTEGRAL] = [swap(
        "records.cu", "v = horner1_integral(b2 * inv_h2, s_coeffs, deg) * inv_h2;", "v = inv_h2;")]
    steps[NO_FILL] = [swap("records.cu", "for (int c = c0 + lane_; c < out_.cap; c += lanes_) {",
                           "for (int c = out_.cap; c < out_.cap; c += lanes_) {")]
    steps[COUNTS_ONLY] = [
        swap_between("records.cu", APPEND, "    // The warp's pending records",
                     APPEND + "uint32_t bits, Hit hit) {\n        cursor_ += __popc(bits);\n"
                     "    }\n\n"),
        swap_between("records.cu", "    // The rest of the pending records", "  private:",
                     "    __device__ __forceinline__ void finish(int32_t* counts) {\n"
                     "        counts[row0_ + lane_] = cursor_;\n    }\n\n")]
    return steps


# Variants that leave out part of the work, to see what it costs; their
# rows are not compared. Counts only: the walk, the staging and the hit
# test alone.
NO_INTEGRAL = "shipped, no integral (1/h^2 in its place; rows not compared)"
NO_FILL = "shipped, no sentinel fill (rows not compared)"
COUNTS_ONLY = "shipped, counts only (no records written; rows not compared)"
NOT_COMPARED = (NO_INTEGRAL, NO_FILL, COUNTS_ONLY)


def shipped_record_constants():
    from grace_tpu_torch import _kernels

    with open(os.path.join(_kernels.CSRC, "records.cu")) as f:
        text = f.read()
    return {name: int(text.split(f"constexpr int {name} = ", 1)[1].split(";", 1)[0])
            for name in ("kPending", "kStageBuffers", "kBatch")}


def record_call(route, args, order, out, cap, parent=False):
    """The C entry's arguments for the record kernel of ``route`` on
    ``args`` (as ``chip_smoke.records_inputs`` gives them), its tiles in
    ``order`` (None: as listed; the parent's entry takes none), its four
    outputs written back to back into the i32 buffer ``out`` (counts, then
    the index, integral and distance rows: the buffer compares their bits
    at once)."""
    from grace_tpu_torch.trace import pallas_kernel as pk

    packed, prims = args[-2], args[-1]
    if prims.data_ptr() % 16:
        raise AssertionError("the record kernels stage from 16-byte aligned slabs")
    r_pad = packed.shape[0]
    n_tiles = args[-3].shape[0]
    ptr = out.data_ptr()
    outs = [ptr, ptr + 4 * r_pad, ptr + 4 * (r_pad + r_pad * cap),
            ptr + 4 * (r_pad + 2 * r_pad * cap)]
    coeffs = pk._coeff_tensor(14, str(packed.device)).data_ptr()
    order_ptr = [] if parent else [None if order is None else order.data_ptr()]
    if route == "quarter":
        summary, words = args[0], args[1]
        return ([summary.data_ptr(), words.data_ptr(), *order_ptr, packed.data_ptr(),
                 prims.data_ptr(), coeffs, *outs, n_tiles, r_pad // n_tiles, summary.shape[1],
                 words.shape[1], prims.shape[1], cap, 14])
    return ([args[0].data_ptr(), *order_ptr, packed.data_ptr(), prims.data_ptr(), coeffs,
             *outs, n_tiles, r_pad // n_tiles, args[0].shape[1], prims.shape[1] // 128, cap, 14])


def _read(path):
    with open(path) as f:
        return f.read()


def record_ablations(sorted_spheres, rays_s, parent_dir):
    """B16 and B15 on main path 4's inputs (the bench scene's sorted rays,
    tile 64, 512 records a ray): the parent's kernel (from ``parent_dir``'s
    grace_tpu_torch/csrc, as it was and with the mask before the append),
    the redesign's steps and the shipped kernel's constants, each held
    bit-equal to the parent's four outputs and timed in turns with the
    shipped kernel launched as listed, longest row first and shortest
    first; each variant's resources; then the whole record trace on both
    routes with the device's busy share."""
    from grace_tpu_torch import _kernels
    from grace_tpu_torch.trace import pallas_kernel as pk
    from grace_tpu_torch.trace import pallas_records as prc

    cap, tile = 512, 64
    shipped = shipped_record_constants()
    variants = record_variants(shipped)
    entry = {"quarter": "grace_records_quarter", "bitmask": "grace_records_bitmask"}
    builds = {}   # variant -> build_variant's arguments; built at once, one nvcc each
    parent_csrc = parent_dir and os.path.join(parent_dir, "grace_tpu_torch", "csrc")
    if parent_dir is not None and _read(os.path.join(parent_csrc, "records.cu")) == _read(
            os.path.join(_kernels.CSRC, "records.cu")):
        # a parent whose records.cu is this one: no parent rows (PARENT_RECORD_ENTRIES
        # are the entries of records.cu before its order argument)
        print("records: the parent's records.cu is this one; variants held to the first "
              "variant", flush=True)
    elif parent_dir is not None:
        builds["parent"] = ("records", "records-parent", None, parent_csrc,
                            PARENT_RECORD_ENTRIES)
        builds["parent, mask then append"] = (
            "records", "records-parent-mask",
            [swap_function("records.cu", "append_staged", MASK_THEN_APPEND)], parent_csrc,
            PARENT_RECORD_ENTRIES)
    else:
        print("records: no --parent DIR, so no parent rows; variants held to the first "
              "variant", flush=True)
    for i, (v, edits) in enumerate(variants.items()):
        builds[v] = ("records", f"records-{i}", edits)
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        dlls = dict(zip(builds, pool.map(lambda a: build_variant(*a), builds.values())))
    shipped_name = next(v for v, edits in variants.items() if edits is None)
    dev = rays_s.origins.device
    summary = {}
    for route in ("quarter", "bitmask"):
        args = records_inputs(route, rays_s, sorted_spheres, tile)[2]
        words = args[-3]
        lengths = _popcount_rows(words)
        spread(f"records {route}: groups listed per tile (tile {tile})", lengths)
        longest = (pk.quarter_tile_order if route == "quarter" else pk.bitmask_tile_order)(words)
        for v, dll in dlls.items():
            if v.startswith("parent"):
                continue
            out = (ctypes.c_int * 5)()
            call(getattr(dll, entry[route] + "_resources"), [ctypes.addressof(out), tile])
            print(f"resources records_{route} {v}: "
                  f"{json.dumps(dict(zip(_kernels.RESOURCE_FIELDS, out)))}", flush=True)
        r_pad = args[-2].shape[0]
        out = torch.empty(r_pad * (1 + 3 * cap), dtype=torch.int32, device=dev)
        ref = next(iter(dlls))   # the parent where there is one
        call(getattr(dlls[ref], entry[route]),
             record_call(route, args, None, out, cap, ref.startswith("parent")))
        torch.cuda.synchronize()
        want = out.clone()
        runs = {}
        for v, dll in dlls.items():
            fn = getattr(dll, entry[route])
            if v.startswith("parent"):
                runs[v] = (lambda f=fn, a=record_call(route, args, None, out, cap, True):
                           call(f, a), out)
                continue
            orders = {"longest first": longest}
            if v == shipped_name:
                orders = {"as listed": None, "longest first": longest,
                          "shortest first": longest.flip(0).contiguous()}
            for name, o in orders.items():
                runs[f"{v}, {name}"] = (lambda f=fn, a=record_call(route, args, o, out, cap),
                                        held=o: call(f, a), None if v in NOT_COMPARED else out)
        summary[f"records_{route}"] = in_turns(f"records_{route} (tile {tile}, cap {cap})",
                                               runs, want)
        del out, want
    for name, kw in (("default (quarter) route", {}), ("bitmask route",
                                                        {"broadphase": "bitmask"})):
        fn = lambda kw=kw: prc.pallas_trace_sph_records(rays_s, sorted_spheres, cap, **kw)
        ms = cuda_ms(fn, reps=5)
        print(f"pallas_trace_sph_records {name}: {ms:.3f} ms (CUDA events, median of 5)",
              flush=True)
        summary[f"record trace, {name}"] = {"ms": ms, **device_busy(f"record trace {name}", fn)}
    from grace_tpu_torch.trace.pallas_broadphase import _popcount32

    for name in ("quarter_tile_order", "bitmask_tile_order"):
        words = records_inputs(name.split("_")[0], rays_s, sorted_spheres, tile)[2][-3]
        runs = {name: lambda: getattr(pk, name)(words),
                "the same on the i64 popcount": lambda: _kernels.longest_first(
                    _popcount32(words).sum(dim=1)).to(torch.int32)}
        for label, fn in runs.items():
            ms = cuda_ms(fn, reps=10)
            print(f"{name} (tile {tile}), {label}: {ms:.3f} ms", flush=True)
            summary[f"{name}, {label}"] = ms
    return summary


# The training kernels' variants: B12 (csrc/splat_sortfree.cu's backward)
# and B13 (csrc/render.cu's forward). The parents' entry points (B13's
# before its order argument), for --parent DIR:
PARENT_TRAIN_ENTRIES = {"splat_sortfree": {"grace_splat_sortfree_bwd": "ppppppp" + "iiiiiiiii"},
                        "render": {"grace_render_fwd": "pppppp" + "iiii"}}


def shipped_const(file, name):
    """The value of ``constexpr int name`` in the package's csrc/file."""
    from grace_tpu_torch import _kernels

    with open(os.path.join(_kernels.CSRC, file)) as f:
        return int(f.read().split(f"constexpr int {name} = ", 1)[1].split(";", 1)[0])


def csrc_const(file, name, value):
    """An edit of csrc/file that sets ``constexpr int name`` to ``value``."""
    return swap(file, f"constexpr int {name} = {shipped_const(file, name)};",
                f"constexpr int {name} = {value};")


BWD = "splat_sortfree.cu"
# The cotangent tile copied by each thread's loads and stores, not cp.async.
BWD_PLAIN_LOADS = swap(
    BWD, "cp_async4(g + j * gs + i, g_image + static_cast<int64_t>(row0 + i) * width + col0 + j);",
    "g[j * gs + i] = g_image[static_cast<int64_t>(row0 + i) * width + col0 + j];")
BWD_RUNTIME_DEGREE = swap(BWD, """return deg == 8 ? sortfree_bwd_kernel<8>
                    : deg == 10 ? sortfree_bwd_kernel<10> : sortfree_bwd_kernel<0>;""",
                          "return sortfree_bwd_kernel<0>;")
# B12's cotangent tile staged a row at a time, without a division an element.
BWD_ROW_STAGING = swap(BWD, """        for (int e = tid; e < tile_w * tile_h; e += kSeg) {
            const int i = e / tile_h;
            const int j = e - i * tile_h;
            cp_async4(g + j * gs + i, g_image + static_cast<int64_t>(row0 + i) * width + col0 + j);
        }
""", """        for (int i = 0; i < tile_w; ++i) {
            const float* src = g_image + static_cast<int64_t>(row0 + i) * width + col0;
            for (int j = tid; j < tile_h; j += kSeg) cp_async4(g + j * gs + i, src + j);
        }
""")
# B12 with a launch order, which the shipped kernel does not take: block b
# on segment order[b], the entry's second argument.
BWD_ORDERED = "shipped + a launch order (block b on segment order[b])"
BWD_ORDER_EDITS = [
    swap(BWD, "sortfree_bwd_kernel(const int32_t* __restrict__ masks_t, const float* __restrict__ "
         "coords,", "sortfree_bwd_kernel(const int32_t* __restrict__ masks_t, const int32_t* "
         "__restrict__ order,\n                    const float* __restrict__ coords,"),
    swap(BWD, "const int seg = static_cast<int>(blockIdx.x);",
         "const int seg = order[blockIdx.x];"),
    swap(BWD, "using BwdKernel = void (*)(const int32_t*, const float*,",
         "using BwdKernel = void (*)(const int32_t*, const int32_t*, const float*,"),
    swap(BWD, 'extern "C" int grace_splat_sortfree_bwd(const int32_t* masks_t, '
         "const float* coords,", 'extern "C" int grace_splat_sortfree_bwd(const int32_t* '
         "masks_t, const int32_t* order, const float* coords,"),
    swap(BWD, "        masks_t, coords, slabs, g_image,",
         "        masks_t, order, coords, slabs, g_image,"),
]
# Leave-out variants (their outputs are not compared): B12 finding each
# footprint and adding nothing (the walk, the staging and support_range
# alone); B13 with the weight in place of the term (no poly_f).
BWD_NOTHING_ADDED = "shipped, footprints found, nothing added (not compared)"
FWD_NO_TERM = "shipped, the weight in place of the term (no poly_f; not compared)"


def sortfree_bwd_variants():
    """B12's redesign in steps, each adding one to the one before (as
    listed), then the shipped kernel with one thing changed."""
    rows, bufs = shipped_const(BWD, "kBwdRows"), shipped_const(BWD, "kBwdBuffers")
    steps = {
        "footprint cull alone (a row a pass, Horner degree at run time, plain loads)": [
            csrc_const(BWD, "kBwdRows", 1), BWD_RUNTIME_DEGREE, BWD_PLAIN_LOADS],
        f"+ factors once a pass ({rows} rows a pass, Horner degree at compile time)": [
            BWD_PLAIN_LOADS],
        f"+ cp.async staging, {bufs} buffer{'s' if bufs > 1 else ''} (shipped)": None,
    }
    for r in (4, 8, 12, 16):
        if r != rows:
            steps[f"shipped, {r} rows a pass"] = [csrc_const(BWD, "kBwdRows", r)]
    steps["shipped, at most 64 registers (8 blocks an SM)"] = [swap(
        BWD, "__global__ void __launch_bounds__(kSeg)\nsortfree_bwd_kernel",
        "__global__ void __launch_bounds__(kSeg, 8)\nsortfree_bwd_kernel")]
    steps["shipped, the column stride tile_w + 7, not rounded up to a multiple of 8"] = [swap(
        BWD, "return (tile_w + kBwdRows + 6) / 8 * 8;", "return tile_w + kBwdRows - 1;")]
    steps[f"shipped, {3 - bufs} buffer{'s' if bufs == 1 else ''}"] = [
        csrc_const(BWD, "kBwdBuffers", 3 - bufs)]
    steps["shipped, Horner degree at run time"] = [BWD_RUNTIME_DEGREE]
    steps["shipped, the tile staged a row at a time (no division)"] = [BWD_ROW_STAGING]
    steps[BWD_ORDERED] = BWD_ORDER_EDITS
    steps[BWD_NOTHING_ADDED] = [swap(
        BWD, "        bwd_footprint<DEG>(g, gs, xs, ys, ca, cb, rank, deg, r, c, pu, pv, invh, "
        "g_pu, g_pv, g_t2,\n                           g_s);",
        "        g_s += static_cast<float>(r.y - r.x + c.y - c.x);")]
    return steps


# B13's parent with its per-slot hit branch replaced by the mask of 32
# tests first, then the terms of the set bits in ascending order.
PARENT_MASK_THEN_TERM = """        for (int q0 = 0; q0 < n_prims; q0 += 32) {
            uint32_t bits = 0;
#pragma unroll
            for (int q = 0; q < 32; ++q) {
                bits |= pair_passes<true>(r, s.x[q0 + q], s.y[q0 + q], s.z[q0 + q],
                                          s.h2[q0 + q]) << q;
            }
            while (bits) {
                const int i = q0 + __ffs(bits) - 1;
                bits &= bits - 1;
                float dot, bx, by, bz;
                const float b2 = impact(s.x[i], s.y[i], s.z[i], r.ox, r.oy, r.oz, r.dx, r.dy,
                                        r.dz, dot, bx, by, bz);
                const float v = (s.w[i] * poly_f(s_poly, b2 * s.inv_h2[i])) * s.inv_h2[i];
                const float y = v - comp;
                const float t = acc + y;
                comp = (t - acc) - y;
                acc = t;
            }
        }
    }
    out[ray] = acc;
"""


def render_fwd_variants():
    """B13's redesign in steps (as listed), then the shipped kernel with
    one thing changed."""
    bufs = shipped_const("render.cu", "kFwdBuffers")
    return {
        "mask then term, float4 rows, staged by plain loads": [swap(
            "stage.cuh", "            cp_async16(dst, src(row, g) + (col & ((1 << shift) - 1)));",
            "            *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(\n"
            "                src(row, g) + (col & ((1 << shift) - 1)));")],
        f"+ cp.async, {bufs} buffer{'s' if bufs > 1 else ''} (shipped)": None,
        f"shipped, {3 - bufs} buffer{'s' if bufs == 1 else ''} of {1024 // (3 - bufs)}": [
            csrc_const("render.cu", "kFwdBuffers", 3 - bufs)],
        FWD_NO_TERM: [swap(
            "render.cu", "const float v = (sb.w[i] * poly_f(s_poly, b2 * sb.p.inv_h2[i])) * "
            "sb.p.inv_h2[i];", "const float v = sb.w[i];")],
    }


def build_all(builds):
    """{name: build_variant(*arguments)} for {name: arguments}, one nvcc each, at once."""
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        return dict(zip(builds, pool.map(lambda a: build_variant(*a), builds.values())))


def train_ablation(label, lib, entry, variants, parent_dir, parent_edits, make_args, orders,
                   not_compared, resource_ints, ordered=None):
    """Build ``variants`` of kernel ``entry`` of library ``lib`` (and with
    ``parent_dir``, the parent's kernel as it was and with
    ``parent_edits``), print each one's resources, then time them in turns
    on ``make_args(order)`` (the C entry's arguments and its output; the
    parent's entry takes no order): the steps before the shipped one as
    listed, the shipped one in each of ``orders`` ({name: i32 order or
    None}; the first is the wrapper's), the variants in ``ordered``
    ({variant: ({name: i32 order}, the entry table it is bound with)}) in
    each of theirs, the rest in the wrapper's order. Every output is held
    bit-equal to the parent's (without it, to the first variant's), but
    those in ``not_compared``."""
    from grace_tpu_torch import _kernels

    builds = {}
    if parent_dir is not None:
        csrc = os.path.join(parent_dir, "grace_tpu_torch", "csrc")
        for name, edits in (("parent", None), *parent_edits.items()):
            builds[name] = (lib, f"{label}-{name}".replace(" ", "_").replace(",", ""), edits,
                            csrc, PARENT_TRAIN_ENTRIES[lib])
    else:
        print(f"{label}: no --parent DIR, so no parent rows; variants held to the first one",
              flush=True)
    ordered = ordered or {}
    for i, (v, edits) in enumerate(variants.items()):
        builds[v] = (lib, f"{label}-{i}", edits) + ((None, ordered[v][1]) if v in ordered else ())
    dlls = build_all(builds)
    shipped = next(v for v, edits in variants.items() if edits is None)
    before = list(variants)[:list(variants).index(shipped)]
    for v, dll in dlls.items():
        if v in variants:
            out = (ctypes.c_int * 5)()
            call(getattr(dll, entry + "_resources"), [ctypes.addressof(out), *resource_ints])
            print(f"resources {label} {v}: "
                  f"{json.dumps(dict(zip(_kernels.RESOURCE_FIELDS, out)))}", flush=True)
    runs = {}
    want = None
    for v, dll in dlls.items():
        fn = getattr(dll, entry)
        if v not in variants:   # the parent's: no order argument
            args, out = make_args(None, parent=True)
            runs[f"{v}, as listed"] = (lambda f=fn, a=args: call(f, a), out)
        else:
            named = orders if v == shipped else ordered[v][0] if v in ordered else (
                {"as listed": None} if v in before else dict([next(iter(orders.items()))]))
            for name, order in named.items():
                args, out = make_args(order)
                runs[f"{v}, {name}"] = (lambda f=fn, a=args, held=order: call(f, a),
                                        None if v in not_compared else out)
        if want is None:   # the parent's output, else the first variant's
            first, out = next(iter(runs.values()))
            first()
            torch.cuda.synchronize()
            want = out.clone()
    return in_turns(label, runs, want)


def sortfree_bwd_ablations(sorted_spheres, weights, parent_dir):
    """B12 on main path 3's backward inputs (the bench scene, 512x512,
    tiles of 32 x 128, deg8; the cotangent a seeded normal image, which
    moves no footprint): the spread of the work over segments, then the
    parent, the redesign's steps, the shipped kernel (as listed) with
    other constants, and with a launch order (most listed tiles first,
    fewest first) and the order's own time."""
    from grace_tpu_torch import _kernels
    from chip_smoke import footprint_counts
    from grace_tpu_torch.trace import splat_grad as sg

    cam = sg.OrthoCamera(CAM, LOOK, UP, VEXT, LENGTH, SIDE, SIDE)
    masks, masks_t, coords, slabs = sortfree_inputs(sorted_spheres, weights, cam, 32)
    tiles = _popcount_rows(masks_t)
    spread("splat_sortfree_bwd: tiles listed per segment", tiles)
    rows, cols = footprint_counts(sorted_spheres, weights, cam)
    n_segs = slabs.shape[0]
    products = torch.nn.functional.pad(rows * cols, (0, n_segs * 128 - rows.shape[0]))
    spread("splat_sortfree_bwd: footprint products per segment", products.view(-1, 128).sum(1))
    g = torch.from_numpy(np.random.default_rng(5).standard_normal((SIDE, SIDE))
                         .astype(np.float32)).to(slabs.device)
    deg, a_c, _ = sg._basis_coeffs("deg8")
    dev = slabs.device
    a_t, b_t = (sg._basis_tensor("deg8", side, str(dev)) for side in ("a", "b"))
    most = sg.sortfree_tile_order(masks_t)   # the segments by listed tiles, most first

    def make_args(order, parent=False):
        out = torch.empty((n_segs, 8, 128), dtype=torch.float32, device=dev)
        head = [masks_t.data_ptr()] + ([] if order is None else [order.data_ptr()])
        return head + [t.data_ptr() for t in (coords, slabs, g, a_t, b_t, out)] + [
            n_segs, masks_t.shape[1], masks.shape[0], SIDE // 128, 32, 128, SIDE,
            a_c.shape[0], deg], out

    ms = cuda_ms(lambda: sg.sortfree_tile_order(masks_t), reps=10)
    print(f"splat_sortfree_bwd: the order most listed tiles first (sortfree_tile_order on the "
          f"transposed masks) {ms:.3f} ms", flush=True)
    entries = {**_kernels.KERNELS["splat_sortfree"][2],
               "grace_splat_sortfree_bwd": "pppppppp" + "iiiiiiiii"}
    return train_ablation("splat_sortfree_bwd", "splat_sortfree", "grace_splat_sortfree_bwd",
                          sortfree_bwd_variants(), parent_dir, {}, make_args,
                          {"as listed": None}, (BWD_NOTHING_ADDED,),
                          (32, 128, a_c.shape[0], deg), {BWD_ORDERED: (
                              {"as listed (order 0, 1, ...)": torch.arange(
                                  n_segs, dtype=torch.int32, device=dev),
                               "most listed tiles first": most,
                               "fewest first": most.flip(0).contiguous()}, entries)})


def render_fwd_ablations(sorted_spheres, weights, rays_s, parent_dir):
    """B13 on main path 3's forward inputs (the bench scene's sorted rays,
    tile 128, max_chunks 2048): the spread of the lists, then the parent
    (and with its 32 tests into a mask first), the redesign's steps, the
    shipped kernel's buffers and its launch orders (longest list first, as
    listed, shortest first)."""
    from grace_tpu_torch import _kernels
    from grace_tpu_torch.trace import pallas_kernel as pk
    from grace_tpu_torch.trace import pallas_render as pr

    fwd_args, ovf, _, _ = render_inputs(rays_s, sorted_spheres, weights,
                                        torch.zeros(rays_s.n_rays, device=weights.device),
                                        128, 2048, 2048)
    if bool(ovf.any()):
        raise AssertionError("forward segment lists overflow")
    counts, ids, rays_packed, prims = fwd_args
    prims = _kernels.aligned(prims)
    spread("render_fwd: segments listed per tile", counts)
    dev = counts.device
    n_tiles = counts.shape[0]
    poly = pr._poly_tensor(str(dev))
    longest = pk.list_tile_order(counts, ids.shape[1])

    def make_args(order, parent=False):
        out = torch.empty(rays_packed.shape[0], dtype=torch.float32, device=dev)
        head = [counts.data_ptr(), ids.data_ptr()] + (
            [] if parent else [None if order is None else order.data_ptr()])
        return head + [t.data_ptr() for t in (rays_packed, prims, poly, out)] + [
            n_tiles, rays_packed.shape[0] // n_tiles, ids.shape[1], prims.shape[0]], out

    parent_edits = {"parent, 32 tests into a mask, then the terms": [swap_between(
        "render.cu", "        for (int i = 0; i < n_prims; ++i) {",
        "struct Particle {", PARENT_MASK_THEN_TERM + "}\n\n")]}
    return train_ablation("render_fwd", "render", "grace_render_fwd", render_fwd_variants(),
                          parent_dir, parent_edits, make_args, {
                              "longest list first": longest, "as listed": None,
                              "shortest first": longest.flip(0).contiguous()},
                          (FWD_NO_TERM,), (128,))


def user_paths(sorted_spheres, weights, rays_s):
    """The splat frame (build, rays + sort, bucket, splat), one sort-free
    training step (forward, L2 loss against 1.01 x its image, backward, SGD
    1e-6), one fused-renderer step (the same on the sorted rays, tile 128)
    and the per-hit record trace (512 a ray, tile 64, both routes) on
    the bench scene, through the package's user functions only, so that
    another checkout's package can run them (``--package``): each timed
    (CUDA events, median of 10 after a warm run) and its device busy
    share; and the two record wrappers on main path 4's inputs, timed."""
    from grace_tpu_torch.build.sph import build_sph_tree
    from grace_tpu_torch.rays.gen import orthographic_projection_rays, spatial_sort_rays
    from grace_tpu_torch.trace import pallas_records as prc
    from grace_tpu_torch.trace import pallas_render as pr
    from grace_tpu_torch.trace import splat as sp
    from grace_tpu_torch.trace import splat_grad as sg

    cam = sg.OrthoCamera(CAM, LOOK, UP, VEXT, LENGTH, SIDE, SIDE)
    render = sg.make_splat_trainer(cam, basis="deg8", tile_w=32, tile_h=128)
    target = 1.01 * sg.splat_forward_sortfree(sorted_spheres, weights, cam, 32, 128, "deg8")

    def train_step():
        s = sorted_spheres.detach().clone().requires_grad_(True)
        w = weights.detach().clone().requires_grad_(True)
        ((render(s, w) - target) ** 2).sum().div(SIDE * SIDE).backward()
        return s.detach() - 1e-6 * s.grad, w.detach() - 1e-6 * w.grad

    def frame():
        s, _, _ = build_sph_tree(sorted_spheres, MAX_PER_LEAF)
        spatial_sort_rays(orthographic_projection_rays(SIDE, SIDE, CAM, LOOK, UP, VEXT, LENGTH,
                                                       device=s.device))
        return sp.splat_image(sp.bucket_prims_ortho(s, CAM, LOOK, UP, VEXT, LENGTH, SIDE, SIDE,
                                                    tile_w=32, tile_h=128, chunk=512, band=32),
                              basis="deg8", tile_w=32, tile_h=128)

    fused = pr.make_fused_renderer(tile=128, max_chunks=2048, max_tiles_per_seg=2048)
    fused_target = 1.01 * fused(rays_s, sorted_spheres, weights).detach()

    def fused_step():
        s = sorted_spheres.detach().clone().requires_grad_(True)
        w = weights.detach().clone().requires_grad_(True)
        ((fused(rays_s, s, w) - fused_target) ** 2).sum().div(SIDE * SIDE).backward()
        return s.detach() - 1e-6 * s.grad, w.detach() - 1e-6 * w.grad

    result = {}
    for label, fn in (
            ("splat frame", frame), ("sort-free train step", train_step),
            ("fused train step", fused_step),
            ("record trace, default (quarter) route",
             lambda: prc.pallas_trace_sph_records(rays_s, sorted_spheres, 512)),
            ("record trace, bitmask route", lambda: prc.pallas_trace_sph_records(
                rays_s, sorted_spheres, 512, broadphase="bitmask"))):
        ms = cuda_ms(fn, reps=10)
        print(f"{label}: {ms:.3f} ms (CUDA events, median of 10)", flush=True)
        result[label] = {"ms": ms, **device_busy(label, fn)}
    for route, wrapper in (("quarter", prc.records_quarter), ("bitmask", prc.records_bitmask)):
        args = records_inputs(route, rays_s, sorted_spheres, 64)[2]
        ms = cuda_ms(lambda: wrapper(*args, 512), reps=10)
        print(f"records_{route} wrapper (tile 64, 512 a ray): {ms:.3f} ms (CUDA events, "
              "median of 10)", flush=True)
        result[f"records_{route} wrapper"] = ms
    return result


def device_busy(label, fn, longest=6):
    """The device's busy share over one warm fn() (torch.profiler: the sum
    of its kernels' times over the wall time, both with the profiler on),
    and its ``longest`` longest kernels by name (None: all, with their
    counts). Returns {busy_ms, wall_ms, device_ops}: device_ops counts its
    kernels, copies and memsets."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - start) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name, count = {}, {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        count[e.name] = count.get(e.name, 0) + 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:longest]
    print(f"{label}: device busy {busy:.3f} ms of {wall:.3f} ms wall ({busy / wall:.1%}, "
          f"profiler on), {len(kernels)} kernels; longest: "
          + "; ".join(f"{n[:60]} {ms:.3f} ms" + ("" if longest else f" x{count[n]}")
                      for n, ms in top), flush=True)
    return {"busy_ms": busy, "wall_ms": wall, "device_ops": len(kernels)}


def build_paths():
    """The build and what it feeds (the ``build`` part), through the
    package's user functions only: each timed (CUDA events, median of 10
    after a warm run) with ``device_busy``'s share and device operations."""
    from grace_tpu_torch.build.sph import build_primitive_tree, build_sph_tree
    from grace_tpu_torch.models import triangle as mt
    from grace_tpu_torch.ops.primitives import TRIANGLE
    from chip_smoke import entry_forward

    from grace_tpu_torch.build import deltas as bd
    from grace_tpu_torch.build import lbvh
    from grace_tpu_torch.ops import morton
    from grace_tpu_torch.ops.primitives import SPHERE

    dev = torch.device("cuda", 0)
    spheres = torch.from_numpy(
        make_clustered_particles(np.random.default_rng(2026), N_PARTICLES)).to(dev)
    sorted_spheres, _, _ = build_sph_tree(spheres, MAX_PER_LEAF)
    entry = entry_inputs(dev)
    tris = torch.from_numpy(torus_mesh(**TORUS)).to(dev)
    # the build's steps after the key sort, on the bench scene
    c = spheres[:, :3]
    keys = morton.morton_keys_from_centroids(c, c.amin(dim=0), c.amax(dim=0))
    keys_sorted, perm = torch.sort(keys, stable=True)
    if hasattr(bd, "gather_deltas_cuda"):
        def gather():
            return bd.gather_deltas_cuda(spheres, "sphere", perm, keys_sorted, "euclidean")
    else:   # a package from before the one-launch gather
        def gather():
            sp = spheres[perm]
            return (sp, perm.to(torch.int32), *SPHERE.aabb(sp),
                    bd.euclidean_deltas(sp, SPHERE.centroid))
    _, _, mins, maxs, d = gather()
    first, count, mark = lbvh.lbvh_ranges(d, MAX_PER_LEAF)[2:5]
    scan = torch.cumsum(mark, dim=0, dtype=torch.int32)
    result = {}
    for label, fn in (
            ("step gather, cast, boxes and deltas, bench scene", gather),
            ("step build_lbvh_ranges, bench scene", lambda: lbvh.lbvh_ranges(d, MAX_PER_LEAF)),
            ("step build_lbvh_nodes, bench scene", lambda: lbvh.lbvh_nodes(
                d, first, count, mark, scan, mins, maxs, MAX_PER_LEAF)),
            ("build_sph_tree, bench scene", lambda: build_sph_tree(spheres, MAX_PER_LEAF)),
            ("build_sph_tree, sorted bench particles (path 6)",
             lambda: build_sph_tree(sorted_spheres, MAX_PER_LEAF)),
            ("build_sph_tree, entry (2048 spheres)", lambda: build_sph_tree(entry[0], 16)),
            ("entry forward", lambda: entry_forward(*entry)),
            ("build_primitive_tree, torus", lambda: build_primitive_tree(tris, TRIANGLE, 8,
                                                                         "xor")),
            ("render_triangles xla", lambda: mt.render_triangles(tris, resolution=SIDE,
                                                                 engine="xla")),
            ("render_triangles pallas", lambda: mt.render_triangles(tris, resolution=SIDE,
                                                                    engine="pallas"))):
        ms = cuda_ms(fn, reps=10)
        print(f"build part {label}: {ms:.3f} ms (CUDA events, median of 10)", flush=True)
        result[label] = {"ms": ms, **device_busy(f"build part {label}", fn)}
    return result


def feed_paths():
    """The ``feeds`` part in this process, on whichever grace_tpu_torch it
    imports: {call: {ms, busy_ms, wall_ms, device_ops}} and, for
    render_triangles(engine="xla")'s steps, {step: {ms}} (host wall time
    with a synchronize after each step, median of 10 after a warm run)."""
    from grace_tpu_torch.build.sph import build_primitive_tree
    from grace_tpu_torch.models import triangle as mt
    from grace_tpu_torch.ops.primitives import TRIANGLE
    from grace_tpu_torch.rays.gen import pinhole_camera_rays
    from chip_smoke import entry_forward

    dev = torch.device("cuda", 0)
    entry = entry_inputs(dev)
    tris = torch.from_numpy(torus_mesh(**TORUS)).to(dev)
    result = {}
    for label, fn in (
            ("entry forward", lambda: entry_forward(*entry)),
            ("build_primitive_tree, torus", lambda: build_primitive_tree(tris, TRIANGLE, 8,
                                                                         "xor")),
            ("render_triangles xla", lambda: mt.render_triangles(tris, resolution=SIDE,
                                                                 engine="xla")),
            ("render_triangles pallas", lambda: mt.render_triangles(tris, resolution=SIDE,
                                                                    engine="pallas"))):
        ms = cuda_ms(fn, reps=10)
        print(f"feeds part {label}: {ms:.3f} ms (CUDA events, median of 10)", flush=True)
        result[label] = {"ms": ms, **device_busy(f"feeds part {label}", fn)}

    def xla_steps():
        """render_triangles(engine="xla") step by step, as the model runs it:
        {step: host ms with a synchronize after it}."""
        out, state = {}, {}

        def step(name, fn):
            start = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out[name] = (time.perf_counter() - start) * 1e3

        step("build_triangle_tree", lambda: state.update(
            zip(("st", "tree"), mt.build_triangle_tree(tris, 8)[:2])))

        def camera():
            cam, look, length = mt.auto_camera(state["st"], SIDE)
            state.update(cam=cam.tolist(), look=look.tolist(), length=length)

        step("auto_camera and its host read", camera)
        step("pinhole rays", lambda: state.update(rays=pinhole_camera_rays(
            SIDE, SIDE, state["cam"], state["look"], (0.0, 1.0, 0.0), math.pi / 3,
            float(state["length"]), device=dev)))
        step("closest-hit walk", lambda: state.update(
            hit=mt.trace_closest_hit(state["rays"], state["st"], state["tree"])))
        step("shadow rays", lambda: state.update(shadow=mt.shadow_inputs(
            state["rays"], state["st"], state["hit"], (0.3, 1.0, 0.6), state["length"])))
        step("any-hit walk", lambda: state.update(
            occluded=mt.trace_any_hit(state["shadow"][2], state["st"], state["tree"])))
        step("shading", lambda: torch.where(state["shadow"][0], 0.15 + torch.where(
            state["occluded"], 0.0, state["shadow"][1]) * 0.85, 0.0))
        return out

    xla_steps()
    runs = [xla_steps() for _ in range(10)]
    for name in runs[0]:
        ms = statistics.median(r[name] for r in runs)
        print(f"feeds part render_triangles xla step {name}: {ms:.3f} ms (host wall with a "
              "synchronize after it, median of 10)", flush=True)
        result[f"render_triangles xla step {name}"] = {"ms": ms}
    return result


# Leave-out and variant builds of csrc/build.cu's climbs, timed on the bench
# scene's phase A and B inputs. The leave-outs give wrong trees and are
# timed only: what each part of a climb costs.
NODES_STAGE2 = """    for (int q = t; q < sh.n_tops; q += nt) {
        int lo = top_lo[q], hi = top_hi[q];
        const int a = fsh[lo - kb]"""
RANGES_STAGE2 = """    for (int q = t; q < sh.n_tops; q += nt) {
        int lo = top_lo[q], hi = top_hi[q];
        D dl = lo > 0"""
BOX_LOADS = """        bmin[k] = torch_min(load_volatile(box + k), load_volatile(box + 6 + k));
        bmax[k] = torch_max(load_volatile(box + 3 + k), load_volatile(box + 9 + k));"""
CLIMB_VARIANTS = {
    "as shipped": None,
    "phase B without its device stage (leave-out)": [
        swap("build.cu", NODES_STAGE2, NODES_STAGE2.replace("q < sh.n_tops", "q < 0"))],
    "phase B without the leaves' boxes (leave-out)": [
        swap("build.cu", "for (int i0 = warp * per_warp; i0 < k;",
             "for (int i0 = warp * per_warp; i0 < 0;")],
    "phase B with relaxed device arrivals, no fences (racy)": [
        swap("build.cu", "if (arrive_device(&flags[p]) == 0u) break;",
             "if (atomicAdd(&flags[p], 1u) == 0u) break;")],
    "phase B, 32 lanes a leaf whatever max_per_leaf": [
        swap("build.cu", "while (group < 8 && 4 * group < max_per_leaf) group <<= 1;",
             "group = 32;")],
    "phase B, lanes a leaf up to max_per_leaf (a row a lane)": [
        swap("build.cu", "while (group < 8 && 4 * group < max_per_leaf) group <<= 1;",
             "while (group < 32 && group < max_per_leaf) group <<= 1;")],
    "phase B's block stage reading the boxes with plain loads": [
        swap("build.cu", BOX_LOADS, BOX_LOADS.replace("load_volatile(", "*("))],
    "phase A without its device stage (leave-out)": [
        swap("build.cu", RANGES_STAGE2, RANGES_STAGE2.replace("q < sh.n_tops", "q < 0"))],
}


def climb_ablations():
    """The ``climbs`` part: CLIMB_VARIANTS of csrc/build.cu, each built apart
    and its two climbs launched on the bench scene's inputs (max_per_leaf
    32, the default block, and blocks of 256 and 512), timed in turns
    (every variant in order, then in reverse; CUDA events, median of 10);
    the trees of the lane-group and load variants held bit-equal to the
    shipped one."""
    from grace_tpu_torch.build import deltas as bd
    from grace_tpu_torch.build import lbvh
    from grace_tpu_torch.ops import morton

    dev = torch.device("cuda", 0)
    spheres = torch.from_numpy(
        make_clustered_particles(np.random.default_rng(2026), N_PARTICLES)).to(dev)
    c = spheres[:, :3]
    keys = morton.morton_keys_from_centroids(c, c.amin(dim=0), c.amax(dim=0))
    keys_sorted, perm = torch.sort(keys, stable=True)
    _, _, mins, maxs, d = bd.gather_deltas_cuda(spheres, "sphere", perm, keys_sorted,
                                                "euclidean")
    n, mpl = N_PARTICLES, MAX_PER_LEAF
    _, _, first, count, mark = lbvh.lbvh_ranges(d, mpl)
    scan = torch.cumsum(mark, dim=0, dtype=torch.int32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    i32 = dict(dtype=torch.int32, device=dev)

    def checked(rc):
        if rc != 0:
            raise RuntimeError(f"climbs: a variant's launch failed with CUDA error {rc}")

    def ranges_call(dll, block):
        outs = [torch.empty(m, **i32) for m in (n - 1, n - 1, n, n, 3 * n - 2)]
        return lambda: checked(dll.grace_lbvh_ranges(
            d.data_ptr(), *[t.data_ptr() for t in outs], n, mpl, 1, block, 0, stream))

    def nodes_call(dll, block, out, flags, ends):
        return lambda: checked(dll.grace_lbvh_nodes(
            *[t.data_ptr() for t in (d, first, count, mark, scan, mins, maxs, *out, flags,
                                     ends)], n, mpl, 1, block, 0, stream))

    def tree_out():
        return [torch.empty((n - 1, 2), **i32),
                torch.empty((n - 1, 2, 2, 3), dtype=torch.float32, device=dev),
                torch.empty((n, 2), **i32), *(torch.empty((), **i32) for _ in range(3))]

    dlls = {v: build_variant("build", f"climbs-{i}", edits)
            for i, (v, edits) in enumerate(CLIMB_VARIANTS.items())}
    flags, ends = torch.empty(n - 1, **i32), torch.empty((n - 1, 6), **i32)
    result = {}
    for block in (0, 256, 512):
        outs = {v: tree_out() for v in dlls}
        calls = {}
        for v, dll in dlls.items():
            calls[v, "ranges"] = ranges_call(dll, block)
            calls[v, "nodes"] = nodes_call(dll, block, outs[v], flags, ends)
        times = {}
        for v in list(dlls) + list(dlls)[::-1]:
            for phase in ("ranges", "nodes"):
                times.setdefault((v, phase), []).append(cuda_ms(calls[v, phase], reps=10))
        torch.cuda.synchronize()
        for v in ("phase B, 32 lanes a leaf whatever max_per_leaf",
                  "phase B, lanes a leaf up to max_per_leaf (a row a lane)",
                  "phase B's block stage reading the boxes with plain loads"):
            for f, (a, b) in enumerate(zip(outs[v], outs["as shipped"])):
                bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
                if not torch.equal(bits(a), bits(b)):
                    raise AssertionError(f"climbs: {v} output {f} differs from the shipped one")
        for (v, phase), ms in times.items():
            label = f"climbs block {block or 'default'} {phase} {v}"
            print(f"{label}: {', '.join(f'{x:.3f}' for x in ms)} ms (CUDA events, median of "
                  "10, in turns)", flush=True)
            result[label] = ms
    return result


NO_VARIANTS = False


def routed(dll, fn):
    """fn() with the package's kernel launches sent to library ``dll``."""
    from grace_tpu_torch import _kernels

    real = _kernels.launch
    _kernels.launch = lambda lib, entry, device, *a: call(getattr(dll, entry), a)
    try:
        return fn()
    finally:
        _kernels.launch = real


def kernel_variants(part, lib_name, variants, calls, kernel, rounds=2, not_compared=()):
    """Library ``lib_name`` built as shipped and in ``variants`` ({name:
    edits}), each of ``calls`` ({call: fn}) run through the package's
    wrapper with its launch sent to each build: outputs bit-equal to the
    shipped build's (but for the leave-outs in ``not_compared``, which
    give other outputs); then timed in turns (shipped, the variants, the
    variants backwards, shipped; ``rounds`` times): the call (CUDA events,
    median of 10) and the device time of the CUDA kernel whose name holds
    ``kernel`` (torch.profiler, 20 calls). Returns {f"{variant}, {call}":
    {"variant_ms": [..], "device_ms": [..]}}; a package whose sources lack
    a variant's text (the parent's) gets {}, as does a run with
    --no-variants."""
    if NO_VARIANTS:
        return {}
    builds = {"shipped": (lib_name, f"{part} shipped", None)}
    builds.update({name: (lib_name, f"{part} variant {i}", edits)
                   for i, (name, edits) in enumerate(variants.items())})
    try:
        dlls = build_all(builds)
    except (AssertionError, ValueError) as e:   # a variant's text is not in the sources
        print(f"{part} part: no variants in this package ({e})", flush=True)
        return {}
    as_bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    result = {}
    for label, fn in calls.items():
        want = [as_bits(x).clone() for x in routed(dlls["shipped"], fn)]
        for name, dll in dlls.items():
            got = routed(dll, fn)
            if name in not_compared:
                continue
            if not all(torch.equal(as_bits(g), w) for g, w in zip(got, want)):
                raise AssertionError(f"{part} {label}: variant {name!r} differs from shipped")
        times = {name: [] for name in dlls}
        device = {name: [] for name in dlls}
        names = list(dlls)
        for _ in range(rounds):
            for name in names + names[::-1]:
                times[name].append(cuda_ms(lambda: routed(dlls[name], fn), reps=10))
                device[name].append(kernel_device_ms(lambda: routed(dlls[name], fn), kernel,
                                                     reps=20))
        for name, ms in times.items():
            dev_ms = ", ".join("not measured" if m is None else f"{m:.4f}"
                               for m in device[name])
            print(f"{part} part {name}, {label}: device {dev_ms} ms (profiler, 20 calls each); "
                  f"call " + ", ".join(f"{m:.3f}" for m in ms)
                  + " ms (CUDA events, median of 10 each); in turns, "
                  + ("a leave-out, not compared" if name in not_compared
                     else "bit-equal to shipped"), flush=True)
            result[f"{name}, {label}"] = {"variant_ms": ms, "device_ms": device[name]}
    return result


# E6's overlap words (csrc/broadphase.cu): the hull cull left out (every
# word of a row fine-tested, its ballot taken; the cull's share), at most
# 128, 64 and 32 rows a block (more blocks, more staging of each strip), 4
# and 16 warps a block (16 also with at most 512 rows), at least two and eight blocks an SM instead of four, rows
# in contiguous groups instead of interleaved, one candidate word at a
# time instead of two, the hulls by integer reductions; and four leave-outs
# (OVERLAP_LEAVE_OUTS, wrong words, timed only): the strip's staging and
# hulls alone (no row loop), no word stores, no fine test (the words all
# 0), the staging alone
OVERLAP_LEAVE_OUTS = ("leave-out: staging and hulls only", "leave-out: no word stores",
                      "leave-out: no fine test", "leave-out: staging only")
# the hulls by the integer min / max reductions of sm_80 on order-keeping
# keys (a float's bits with the lower 31 flipped where negative; a NaN the
# reduction's identity, so NaNs drop and a word of them gives a NaN)
HULL_BY_REDUX = """        float h[6];
        for (int a = 0; a < 6; ++a) {
            const float x = cols[a / 3][3 * (32 * j + lane) + a % 3];
            const int bits = __float_as_int(x);
            const int key = bits ^ ((bits >> 31) & 0x7fffffff);
            const int r = a < 3 ? __reduce_min_sync(kFull, isnan(x) ? 0x7fffffff : key)
                                : __reduce_max_sync(kFull, isnan(x) ? int(0x80000000) : key);
            h[a] = __int_as_float(r ^ ((r >> 31) & 0x7fffffff));
        }
"""
OVERLAP_VARIANTS = {
    OVERLAP_LEAVE_OUTS[0]: [swap("broadphase.cu",
                                 "    const bool word_here = lane < strip_words;\n",
                                 "    if (n_here > 0) return;\n"
                                 "    const bool word_here = lane < strip_words;\n")],
    OVERLAP_LEAVE_OUTS[1]: [swap(
        "broadphase.cu",
        "        if (word_here) words[row * n_words + w0 + lane] = static_cast<int>(mine);\n", "")],
    OVERLAP_LEAVE_OUTS[2]: [swap("broadphase.cu", "        while (cand) {",
                                 "        while (false && cand) {")],
    OVERLAP_LEAVE_OUTS[3]: [swap("broadphase.cu",
                                 "    __syncthreads();\n    for (int j = warp; j < kStripWords;",
                                 "    __syncthreads();\n    if (n_here > 0) return;\n"
                                 "    for (int j = warp; j < kStripWords;")],
    "hulls by integer reductions": [swap("broadphase.cu", """        float h[6];
        for (int a = 0; a < 6; ++a) h[a] = cols[a / 3][3 * (32 * j + lane) + a % 3];
        for (int o = 16; o > 0; o >>= 1) {
            for (int a = 0; a < 3; ++a) h[a] = fminf(h[a], __shfl_xor_sync(kFull, h[a], o));
            for (int a = 3; a < 6; ++a) h[a] = fmaxf(h[a], __shfl_xor_sync(kFull, h[a], o));
        }
""", HULL_BY_REDUX)],
    "no cull (every word fine-tested)": [swap(
        "broadphase.cu", "        unsigned mine = 0u;\n        while (cand) {",
        "        cand = __ballot_sync(kFull, word_here);\n"
        "        unsigned mine = 0u;\n        while (cand) {")],
    "at most 128 rows a block": [swap("broadphase.cu", "constexpr int kMaxRows = 256;",
                                      "constexpr int kMaxRows = 128;")],
    "at most 64 rows a block": [swap("broadphase.cu", "constexpr int kMaxRows = 256;",
                                     "constexpr int kMaxRows = 64;")],
    "at most 32 rows a block": [swap("broadphase.cu", "constexpr int kMaxRows = 256;",
                                     "constexpr int kMaxRows = 32;")],
    "4 warps a block": [swap("broadphase.cu", "constexpr int kWordWarps = 8;",
                             "constexpr int kWordWarps = 4;")],
    "16 warps a block": [swap("broadphase.cu", "constexpr int kWordWarps = 8;",
                              "constexpr int kWordWarps = 16;")],
    "16 warps a block, at most 512 rows": [
        swap("broadphase.cu", "constexpr int kWordWarps = 8;", "constexpr int kWordWarps = 16;"),
        swap("broadphase.cu", "constexpr int kMaxRows = 256;", "constexpr int kMaxRows = 512;")],
    "two blocks an SM (at least 264 blocks)": [swap(
        "broadphase.cu", "constexpr int kMinBlocks = 528;", "constexpr int kMinBlocks = 264;")],
    "eight blocks an SM (at least 1,056 blocks)": [swap(
        "broadphase.cu", "constexpr int kMinBlocks = 528;", "constexpr int kMinBlocks = 1056;")],
    "rows in contiguous groups": [
        swap("broadphase.cu", "    const int n_here = (n_rows - g + n_groups - 1) / n_groups;",
             "    const int n_here = min(n_rows - g * ((n_rows + n_groups - 1) / n_groups),\n"
             "                           (n_rows + n_groups - 1) / n_groups);"),
        swap("broadphase.cu", "3LL * (g + (i / 2) * n_groups);",
             "3LL * (g * ((n_rows + n_groups - 1) / n_groups) + i / 2);"),
        swap("broadphase.cu", "const long long row = g + static_cast<long long>(i) * n_groups;",
             "const long long row = g * ((n_rows + n_groups - 1) / n_groups) + i;")],
    "candidates two at a time": [swap(
        "broadphase.cu", """            const int j = __ffs(cand) - 1;
            cand &= cand - 1u;
            const unsigned word = __ballot_sync(kFull, column_overlaps(cols, j, lane, lo, hi));
            if (lane == j) mine = word;
""", """            const int j0 = __ffs(cand) - 1;
            cand &= cand - 1u;
            const int j1 = cand ? __ffs(cand) - 1 : j0;
            cand &= cand - 1u;
            const unsigned word0 = __ballot_sync(kFull, column_overlaps(cols, j0, lane, lo, hi));
            const unsigned word1 = __ballot_sync(kFull, column_overlaps(cols, j1, lane, lo, hi));
            if (lane == j0) mine = word0;
            if (lane == j1) mine = word1;
""")],
}

# E6's boxes (csrc/broadphase.cu, boxes_kernel): the reductions by a
# five-round shuffle butterfly a value (the earlier kernels' form, on the
# same ints) instead of redux.sync; the tile part from 4-byte loads at
# every tile (tile 128: a lane four rays, one at a time), and from 16-byte
# loads from tile 4 on (tile 64: half the lanes four rays each); a tile
# over up to 8 warps (a thread a ray from 4-byte loads, the tile's warps
# combined in shared memory: TILE_WARPS, 4 warps at tile 128, 2 at 64); the
# runs written as 16-byte stores from the first aligned float; and a leave-out (BOX_LEAVE_OUTS,
# wrong boxes, timed only): no reductions (each lane's own fold stored)
BOX_LEAVE_OUTS = ("leave-out: no reductions",)
BOX_REDUX = """    for (int a = 0; a < 3; ++a) {
        f.lo[a] = __reduce_min_sync(kFull, f.lo[a]);
        f.hi[a] = __reduce_max_sync(kFull, f.hi[a]);
    }
    f.nan = __reduce_or_sync(kFull, f.nan);
"""
BOX_SCALAR = [swap("broadphase.cu", "const bool vec = tile % 4 == 0 && tile >= kVecTile &&",
                   "const bool vec = false && tile % 4 == 0 &&")]
TILE_WARPS_PART = """constexpr int kMaxTileWarps = 8;

__device__ __forceinline__ void fold_fold(Fold& f, const Fold& g) {
    for (int a = 0; a < 3; ++a) {
        f.lo[a] = min(f.lo[a], g.lo[a]);
        f.hi[a] = max(f.hi[a], g.hi[a]);
    }
    f.nan |= g.nan;
}

template <bool kVec>
__device__ __forceinline__ void tile_part(const BoxArgs& a, int blk,
                                          float (*stage)[kStageFloats], Fold* part) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int threads = 32 * a.tile_warps, tiles_here = kBoxWarps / a.tile_warps;
    const long long t = static_cast<long long>(blk) * tiles_here + threadIdx.x / threads;
    Fold f = empty_fold();
    if (t < a.n_tiles) {
        const int units = kVec ? a.tile / 4 : a.tile;
        for (int j = threadIdx.x % threads; j < units; j += threads) {
            if constexpr (kVec) {
                const long long r = t * a.tile + 4LL * j;
                const float4* o4 = reinterpret_cast<const float4*>(a.origins) + 3 * r / 4;
                const float4* d4 = reinterpret_cast<const float4*>(a.dirs) + 3 * r / 4;
                const float4 ov[3] = {o4[0], o4[1], o4[2]}, dv[3] = {d4[0], d4[1], d4[2]};
                const float4 lv = reinterpret_cast<const float4*>(a.lengths)[r / 4];
                float o[12], d[12];
#pragma unroll
                for (int k = 0; k < 3; ++k) {
                    o[4 * k] = ov[k].x, o[4 * k + 1] = ov[k].y, o[4 * k + 2] = ov[k].z;
                    o[4 * k + 3] = ov[k].w;
                    d[4 * k] = dv[k].x, d[4 * k + 1] = dv[k].y, d[4 * k + 2] = dv[k].z;
                    d[4 * k + 3] = dv[k].w;
                }
                const float len[4] = {lv.x, lv.y, lv.z, lv.w};
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    for (int x = 0; x < 3; ++x) {
                        fold_point(f, x, o[3 * q + x]);
                        fold_point(f, x, fma_f64(d[3 * q + x], len[q], o[3 * q + x]));
                    }
                }
            } else {
                const long long r = t * a.tile + j;
                const float len = a.lengths[r];
                for (int x = 0; x < 3; ++x) {
                    const float o = a.origins[3 * r + x];
                    fold_point(f, x, o);
                    fold_point(f, x, fma_f64(a.dirs[3 * r + x], len, o));
                }
            }
        }
    }
    warp_fold(f);
    if (lane == 0) part[warp] = f;
    __syncthreads();
    if (threadIdx.x < tiles_here && blk * static_cast<long long>(tiles_here) + threadIdx.x <
                                        a.n_tiles) {
        Fold g = part[threadIdx.x * a.tile_warps];
        for (int w = 1; w < a.tile_warps; ++w) fold_fold(g, part[threadIdx.x * a.tile_warps + w]);
        store_fold(g, stage[0] + 3 * threadIdx.x, stage[1] + 3 * threadIdx.x);
    }
    __syncthreads();
    const long long first = static_cast<long long>(blk) * tiles_here;
    const int count = static_cast<int>(min(static_cast<long long>(tiles_here), a.n_tiles - first));
    write_run(a.tmin + 3 * first, stage[0], 3 * count);
    write_run(a.tmax + 3 * first, stage[1], 3 * count);
}

int tile_warps(int units) {
    int w = 1;
    while (2 * w <= kMaxTileWarps && 64 * w <= units) w *= 2;
    return w;
}


"""
TILE_WARPS = BOX_SCALAR + [
    swap_between("broadphase.cu", "// A warp a tile: a lane folds its units",
                 "// Both box sets in one launch", TILE_WARPS_PART),
    swap("broadphase.cu", "    int tile;\n", "    int tile, tile_warps;\n"),
    swap("broadphase.cu", """    __shared__ float stage[2][kStageFloats];
    if""", """    __shared__ float stage[2][kStageFloats];
    __shared__ Fold part[kBoxWarps];
    if"""),
    swap("broadphase.cu", "tile_part<kVec>(a, blockIdx.x - a.seg_blocks, stage);",
         "tile_part<kVec>(a, blockIdx.x - a.seg_blocks, stage, part);"),
    swap("broadphase.cu",
         "    const long long blocks = a.seg_blocks + (a.n_tiles + kBoxWarps - 1) / kBoxWarps;",
         """    a.tile_warps = tile_warps(vec ? tile / 4 : tile);
    const int tiles_a_block = kBoxWarps / a.tile_warps;
    const long long blocks = a.seg_blocks + (a.n_tiles + tiles_a_block - 1) / tiles_a_block;""")]
BOX_VARIANTS = {
    "reductions by shuffles": [swap("broadphase.cu", BOX_REDUX, """    for (int o = 16; o > 0; o >>= 1) {
        for (int a = 0; a < 3; ++a) {
            f.lo[a] = min(f.lo[a], __shfl_xor_sync(kFull, f.lo[a], o));
            f.hi[a] = max(f.hi[a], __shfl_xor_sync(kFull, f.hi[a], o));
        }
        f.nan |= __shfl_xor_sync(kFull, f.nan, o);
    }
""")],
    "4-byte rays at every tile": BOX_SCALAR,
    "16-byte rays from tile 4": [swap("broadphase.cu", "constexpr int kVecTile = 128;",
                                      "constexpr int kVecTile = 4;")],
    "a thread a ray, up to 8 warps a tile": TILE_WARPS,
    "16-byte stores": [swap("broadphase.cu", """    for (int k = threadIdx.x; k < m; k += kThreads) dst[k] = src[k];
""", """    const int head = min(m, static_cast<int>((16 - reinterpret_cast<uintptr_t>(dst) % 16) % 16 / 4));
    const int quads = (m - head) / 4;
    for (int q = threadIdx.x; q < quads; q += kThreads) {
        const float* s = src + head + 4 * q;
        reinterpret_cast<float4*>(dst + head)[q] = make_float4(s[0], s[1], s[2], s[3]);
    }
    for (int k = threadIdx.x; k < m - 4 * quads; k += kThreads) {
        const int e = k < head ? k : 4 * quads + k;   // the head, then the tail
        dst[e] = src[e];
    }
""")],
    BOX_LEAVE_OUTS[0]: [swap("broadphase.cu", BOX_REDUX, "")],
}

# E5's setup (csrc/splat_prep.cu): each lane's four slab values a row
# written as four 4-byte stores instead of one float4
SETUP_SCALAR_STORES = [swap("splat_prep.cu", """        slab[0] = make_float4(pu[0], pu[1], pu[2], pu[3]);
        slab[32] = make_float4(pv[0], pv[1], pv[2], pv[3]);
        slab[64] = make_float4(inv_h[0], inv_h[1], inv_h[2], inv_h[3]);
        slab[96] = make_float4(scale[0], scale[1], scale[2], scale[3]);
        for (int r = 4; r < 8; ++r) slab[32 * r] = zero;
""", """        volatile float* f = reinterpret_cast<float*>(slab);
        for (int k = 0; k < kLanePrims; ++k) {
            f[k] = pu[k];
            f[128 + k] = pv[k];
            f[256 + k] = inv_h[k];
            f[384 + k] = scale[k];
            for (int r = 4; r < 8; ++r) f[128 * r + k] = zero.x;
        }
""")]


# E4 as a counting sort (keys, count, cumsum, scatter, pack; from --parent):
# the counting sort's counters and cursors kept in shared memory, a warp's
# column read once and written once (the bench's 257 bins only: bit-equal
# there); and two leave-outs, timed only: the pack's rows read in order
# (no order read, no gather), and no slab writes
PARENT_SHARED_SORT = """constexpr int kBins = 257;   // the bench's 256 keys and the sentinel

__global__ void __launch_bounds__(kThreads)
    bucket_count_kernel(const int* __restrict__ keys, int* __restrict__ counts, int m, int tile,
                        int tiles) {
    __shared__ int s_counts[kThreads / 32][kBins];
    const int w = (blockIdx.x * kThreads + threadIdx.x) / 32, lane = threadIdx.x % 32;
    int* mine = s_counts[threadIdx.x / 32];
    for (int k = lane; k < kBins; k += 32) mine[k] = 0;
    __syncwarp();
    if (w >= tiles) return;
    const int start = w * tile;
    const int end = m - start < tile ? m : start + tile;
    for (int base = start; base < end; base += 32) {
        const int i = base + lane;
        const int key = i < end ? keys[i] : -1;
        const unsigned peers = __match_any_sync(kFull, key);
        if (key >= 0 && lane == __ffs(peers) - 1) mine[key] += __popc(peers);
        __syncwarp();
    }
    for (int k = lane; k < kBins; k += 32) counts[static_cast<long long>(k) * tiles + w] = mine[k];
}

__global__ void __launch_bounds__(kThreads)
    bucket_scatter_kernel(const int* __restrict__ keys, int* __restrict__ cursor,
                          int* __restrict__ order, int m, int tile, int tiles) {
    __shared__ int s_cursor[kThreads / 32][kBins];
    const int w = (blockIdx.x * kThreads + threadIdx.x) / 32, lane = threadIdx.x % 32;
    if (w >= tiles) return;
    int* mine = s_cursor[threadIdx.x / 32];
    for (int k = lane; k < kBins; k += 32) mine[k] = cursor[static_cast<long long>(k) * tiles + w];
    __syncwarp();
    const int start = w * tile;
    const int end = m - start < tile ? m : start + tile;
    for (int base = start + ((end - start - 1) & ~31); base >= start; base -= 32) {
        const int i = base + lane;
        const int key = i < end ? keys[i] : -1;
        const unsigned peers = __match_any_sync(kFull, key);
        const int leader = __ffs(peers) - 1;
        const int size = __popc(peers);
        int top = 0;
        if (key >= 0 && lane == leader) {
            top = mine[key];
            mine[key] = top - size;
        }
        top = __shfl_sync(kFull, top, leader);
        if (key >= 0) order[top - size + __popc(peers & ((1u << lane) - 1u))] = i;
        __syncwarp();
    }
    for (int k = lane; k < kBins; k += 32) cursor[static_cast<long long>(k) * tiles + w] = mine[k];
}

"""
PARENT_PREP_VARIANTS = {
    "parent": ([], True),
    "parent, counts and cursors in shared memory": ([swap_between(
        "splat_prep.cu", "__global__ void __launch_bounds__(kThreads)\n    bucket_count_kernel(",
        "__global__ void __launch_bounds__(kThreads)\n    bucket_pack_kernel(",
        PARENT_SHARED_SORT)], True),
    "parent, leave-out: no pack gather (rows read in order)": ([swap(
        "splat_prep.cu", "        if (g < 4 * n) v = rows[order[g] % n];\n",
        "        if (g < 4 * n) v = rows[g % n];\n")], False),
    "parent, leave-out: no slab writes": ([swap("splat_prep.cu", """        slabs[base] = v.x;
        slabs[base + chunk] = v.y;
        slabs[base + 2 * chunk] = v.z;
        slabs[base + 3 * chunk] = v.w;
""", "        if (v.x == 1.0e-37f && v.y == 3.0e-37f) slabs[base] = v.z;\n")], False),
}


PREP = "splat_prep.cu"


def prep_const(name, shipped, value):
    return swap(PREP, f"constexpr int {name} = {shipped};", f"constexpr int {name} = {value};")


# E4's pass 1 counting into a warp's own counters in shared memory (no
# atomics: one round's group leaders hold distinct keys), summed in warp
# order as the block writes its column (the bench's 257 bins: 4 x 257 x 8
# warps fit 48 KB)
PER_WARP_COUNTS = [
    swap(PREP, "        bucket_keys_kernel<true><<<blocks, kPrepThreads, shared, s>>>(",
         "        bucket_keys_kernel<true><<<blocks, kPrepThreads, shared * kPrepWarps, s>>>("),
    swap(PREP, "            s_counts[i] = 0;\n",
         "            for (int v = 0; v < kPrepWarps; ++v) s_counts[v * 4 * n_bins + i] = 0;\n"),
    swap(PREP, "                        atomicAdd(&s_counts[q * n_bins + key], __popc(peers));\n",
         "                        s_counts[(threadIdx.x / 32 * 4 + q) * n_bins + key] +=\n"
         "                            __popc(peers);\n"),
    swap(PREP, "            over |= valid && a.over;\n",
         "            over |= valid && a.over;\n            __syncwarp();\n"),
    swap(PREP, "            counts[counter(i % n_bins, i / n_bins, tiles)] = s_counts[i];\n",
         "            int sum = 0;\n"
         "            for (int v = 0; v < kPrepWarps; ++v) sum += s_counts[v * 4 * n_bins + i];\n"
         "            counts[counter(i % n_bins, i / n_bins, tiles)] = sum;\n")]
# E4 with pass 1's keys and rows kept in device memory (a static scratch
# of 2^21 particles: the bench's 2^20 fit) and read back by pass 2 instead
# of recomputed from the spheres
KEYS_KEPT = [
    swap(PREP, "// Block b's counter of (bin, q)",
         "__device__ int4 g_kept_keys[1 << 21];\n__device__ float4 g_kept_rows[1 << 21];\n\n"
         "// Block b's counter of (bin, q)"),
    swap(PREP, "            over |= valid && a.over;\n",
         "            over |= valid && a.over;\n"
         "            if (valid) {\n"
         "                const int p = base + k * kPrepThreads + threadIdx.x;\n"
         "                g_kept_keys[p] = make_int4(a.key[0], a.key[1], a.key[2], a.key[3]);\n"
         "                g_kept_rows[p] = a.row;\n"
         "            }\n"),
    swap(PREP, """            const Particle a = particle_keys(s[k], w[k], weights != nullptr, consts, nbx, nty,
                                             n_keys);
            int key[4], rank[4], size[4];
""", """            Particle a;
            if (valid) {
                const int p = base + k * kPrepThreads + threadIdx.x;
                const int4 kept = g_kept_keys[p];
                a.key[0] = kept.x;
                a.key[1] = kept.y;
                a.key[2] = kept.z;
                a.key[3] = kept.w;
                a.row = g_kept_rows[p];
            }
            int key[4], rank[4], size[4];
""")]
# E4's pass 2 with its slab writes staged (the bench's shared-memory route,
# chunk a multiple of 4): a batch's rounds keep each instance's slot and
# row in registers; then a block scan of the batch's (q, bin) counts gives
# each run its place in a 64 KB stage (a component's 4,096 floats each),
# the rows go there, and a warp a run writes the run's aligned quads of
# each slab row as float4s, its edge slots as 4-byte stores
STAGED_PACK = """template <bool kShared>
__global__ void __launch_bounds__(kPrepThreads)
    bucket_pack_kernel(const float4* __restrict__ spheres, const float* __restrict__ weights,
                       const float* __restrict__ consts, int* counts, float* __restrict__ slabs,
                       int* __restrict__ ranges, unsigned char* __restrict__ overflow, int n,
                       int cap, int chunk, int tile, int nbx, int nty, int n_keys) {
    constexpr int kBatch = 4 * kLoads * kPrepThreads;   // a batch's instances
    extern __shared__ unsigned long long s_prep[];
    __shared__ unsigned s_sums[kPrepWarps];
    const int n_bins = n_keys + 1, tiles = 4 * gridDim.x, pairs = 4 * n_bins;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const unsigned below = (1u << lane) - 1u;
    const unsigned long long lower_warps = (1ull << (8 * warp)) - 1ull;
    unsigned long long* state =
        reinterpret_cast<unsigned long long*>(counts + static_cast<long long>(n_bins + 1) * tiles);
    unsigned long long* words = s_prep;
    int* s_cursor = reinterpret_cast<int*>(s_prep + pairs);
    int* s_count = s_cursor + pairs;     // the batch's instances a pair
    int* s_delta = s_count + pairs;      // slot - stage position of the pair's run
    float* stage = reinterpret_cast<float*>(s_delta + pairs);   // [4][kBatch]
    const Tile t(n, tile);
    const int gt = blockIdx.x * kPrepThreads + threadIdx.x, stride = gridDim.x * kPrepThreads;
    for (int g = 4 * n + gt; g < cap; g += stride) {
        write_row(slabs, g, chunk, make_float4(0.0f, 0.0f, 0.0f, 0.0f));
    }
    scan_counters(counts, state, ranges, overflow, n_keys, tiles, chunk);
    for (int i = threadIdx.x; i < pairs; i += kPrepThreads) {
        s_cursor[i] = __ldcg(&counts[counter(i % n_bins, i / n_bins, tiles)]);
        words[i] = 0ull;
    }
    block_sync();
    const int per = (pairs + kPrepThreads - 1) / kPrepThreads;
    for (int base = t.p0; base < t.p1; base += kLoads * kPrepThreads) {
        for (int i = threadIdx.x; i < pairs; i += kPrepThreads) s_count[i] = 0;
        float4 s[kLoads];
        float w[kLoads];
        load_particles(spheres, weights, base, t.p1, s, w);
        float4 row[kLoads];
        int slot[kLoads][4], pair[kLoads][4];
#pragma unroll
        for (int k = 0; k < kLoads; ++k) {
            const bool valid = base + k * kPrepThreads + static_cast<int>(threadIdx.x) < t.p1;
            const Particle a = particle_keys(s[k], w[k], weights != nullptr, consts, nbx, nty,
                                             n_keys);
            row[k] = a.row;
            int key[4], rank[4], size[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                key[q] = valid ? a.key[q] : -1;
                const unsigned peers = __match_any_sync(kFull, key[q]);
                rank[q] = __popc(peers & below);
                size[q] = __popc(peers);
                if (key[q] >= 0 && rank[q] == 0) {
                    reinterpret_cast<unsigned char*>(words + q * n_bins + key[q])[warp] =
                        static_cast<unsigned char>(size[q]);
                }
            }
            block_sync();
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                pair[k][q] = key[q] < 0 ? -1 : q * n_bins + key[q];
                slot[k][q] = 0;
                if (key[q] < 0) continue;
                const unsigned long long word = words[pair[k][q]];
                slot[k][q] = s_cursor[pair[k][q]] + rank[q] +
                             static_cast<int>(((word & lower_warps) * 0x0101010101010101ull) >> 56);
            }
            block_sync();
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                if (key[q] < 0 || rank[q] != 0) continue;
                reinterpret_cast<unsigned char*>(words + pair[k][q])[warp] = 0;
                atomicAdd(&s_cursor[pair[k][q]], size[q]);
                atomicAdd(&s_count[pair[k][q]], size[q]);
            }
        }
        block_sync();
        // each pair's run in the stage: an exclusive scan of the batch's counts
        const int i0 = min(static_cast<int>(threadIdx.x) * per, pairs), i1 = min(i0 + per, pairs);
        unsigned mine = 0;
        for (int i = i0; i < i1; ++i) mine += static_cast<unsigned>(s_count[i]);
        unsigned incl = mine;
#pragma unroll
        for (int d = 1; d < 32; d *= 2) {
            const unsigned x = __shfl_up_sync(kFull, incl, d);
            if (lane >= d) incl += x;
        }
        if (lane == 31) s_sums[warp] = incl;
        block_sync();
        unsigned run = incl - mine;
        for (int v = 0; v < warp; ++v) run += s_sums[v];
        for (int i = i0; i < i1; ++i) {
            run += static_cast<unsigned>(s_count[i]);
            s_delta[i] = s_cursor[i] - static_cast<int>(run);   // slot - position, after the run
        }
        block_sync();
#pragma unroll
        for (int k = 0; k < kLoads; ++k) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                if (pair[k][q] < 0) continue;
                const int at = slot[k][q] - s_delta[pair[k][q]];
                stage[at] = row[k].x;
                stage[kBatch + at] = row[k].y;
                stage[2 * kBatch + at] = row[k].z;
                stage[3 * kBatch + at] = row[k].w;
            }
        }
        block_sync();
        // a warp a run: its aligned quads as float4s, its edges as 4-byte stores
        for (int i = warp; i < pairs; i += kPrepWarps) {
            const int count = s_count[i];
            if (count == 0) continue;
            const int s1 = s_cursor[i], s0 = s1 - count, delta = s_delta[i];
            const int a0 = (s0 + 3) & ~3, a1 = s1 & ~3;
            const bool quads = a0 < a1;
            const int e0 = quads ? a0 : s1;   // scalar slots: [s0, e0) and [e1, s1)
            const int e1 = quads ? a1 : s1;
            for (int g = s0 + lane; g < e0; g += 32) {
                write_row(slabs, g, chunk, make_float4(stage[g - delta], stage[kBatch + g - delta],
                                                       stage[2 * kBatch + g - delta],
                                                       stage[3 * kBatch + g - delta]));
            }
            for (int g = e1 + lane; g < s1; g += 32) {
                write_row(slabs, g, chunk, make_float4(stage[g - delta], stage[kBatch + g - delta],
                                                       stage[2 * kBatch + g - delta],
                                                       stage[3 * kBatch + g - delta]));
            }
            for (int g = a0 + 4 * lane; quads && g < a1; g += 128) {
                float* at = slabs + static_cast<long long>(g / chunk) * 4 * chunk + g % chunk;
                const float* src = stage + g - delta;
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    *reinterpret_cast<float4*>(at + c * chunk) =
                        make_float4(src[c * kBatch], src[c * kBatch + 1], src[c * kBatch + 2],
                                    src[c * kBatch + 3]);
                }
            }
        }
        block_sync();
    }
}

"""
STAGED_STORES = [
    swap_between(PREP, "template <bool kShared>\n__global__ void __launch_bounds__(kPrepThreads)\n"
                 "    bucket_pack_kernel(", "__device__ __forceinline__ float warp_min(float v) {",
                 STAGED_PACK),
    swap(PREP, """        bucket_pack_kernel<true><<<blocks, kPrepThreads, shared, s>>>(""",
         """        const int staged = 80 * (n_keys + 1) + 16 * 4 * kLoads * kPrepThreads;
        cudaFuncSetAttribute(bucket_pack_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, staged);
        bucket_pack_kernel<true><<<blocks, kPrepThreads, staged, s>>>(""")]
PREP_LEAVE_OUTS = ("leave-out: no slab writes", "leave-out: no counting (pass 1 without its "
                   "groups and adds)", "leave-out: no warp offsets (pass 2 without its words' "
                   "byte sums)", "leave-out: no scatter (each row written at its instance's "
                   "own position, q n + p)")


def prep_variants():
    """E4's variants on the bench, {name: (edits, private arguments,
    compared)}: blocks of 1,024, 2,048 and 8,192 particles (shipped 4,096);
    128 threads a block (shipped 256); 1, 2 and 8 particles a thread
    loaded at once (shipped 4); pass 1's counts in per-warp counters summed
    in warp order (shipped: shared atomics); the keys and rows kept in
    device memory between the passes (shipped: recomputed); pass 2 held to
    64 registers for four blocks an SM; streaming slab stores; and four
    leave-outs, timed only."""
    return {
        "shipped": ([], {}, True),
        **{f"blocks of {t} particles": ([], {"_tile": t}, True) for t in (1024, 2048, 8192)},
        "128 threads a block": ([prep_const("kPrepThreads", 256, 128)], {}, True),
        **{f"{v} particles a thread loaded at once": ([prep_const("kLoads", 4, v)], {}, True)
           for v in (1, 2, 8)},
        "per-warp counters summed in warp order": (PER_WARP_COUNTS, {}, True),
        "keys and rows kept in device memory": (KEYS_KEPT, {}, True),
        "pass 2 at four blocks an SM (at most 64 registers)": ([swap(
            PREP, "template <bool kShared>\n__global__ void __launch_bounds__(kPrepThreads)\n"
            "    bucket_pack_kernel(", "template <bool kShared>\n__global__ void "
            "__launch_bounds__(kPrepThreads, 4)\n    bucket_pack_kernel(")], {}, True),
        "staged slab stores (a batch's runs staged in shared memory, float4 quads)": (
            STAGED_STORES, {}, True),
        "streaming slab stores (st.global.cs)": ([swap(PREP, """    at[0] = v.x;
    at[chunk] = v.y;
    at[2 * chunk] = v.z;
    at[3 * chunk] = v.w;
""", """    __stcs(at, v.x);
    __stcs(at + chunk, v.y);
    __stcs(at + 2 * chunk, v.z);
    __stcs(at + 3 * chunk, v.w);
""")], {}, True),
        PREP_LEAVE_OUTS[0]: ([swap(PREP, """    at[0] = v.x;
    at[chunk] = v.y;
    at[2 * chunk] = v.z;
    at[3 * chunk] = v.w;
""", "    if (v.x == 1.0e-37f && v.y == 3.0e-37f) at[0] = v.z;\n")], {}, False),
        PREP_LEAVE_OUTS[1]: ([swap(PREP, """                const unsigned peers = __match_any_sync(kFull, key);
                if (key >= 0 && lane == __ffs(peers) - 1) {""", """                const unsigned peers = 1u;
                if (key == -7 && lane == __ffs(peers) - 1) {""")], {}, False),
        PREP_LEAVE_OUTS[2]: ([swap(PREP, "((word & lower_warps) * 0x0101010101010101ull) >> 56",
                                   "0")], {}, False),
        PREP_LEAVE_OUTS[3]: ([swap(PREP, "write_row(slabs, cursor + offset + rank[q], chunk, a.row);",
                                   "write_row(slabs, q * n + base + k * kPrepThreads + "
                                   "threadIdx.x + 0 * (cursor + offset), chunk, a.row);")], {},
                             False),
    }


def call_device_ms(fn, reps=20):
    """The device time of one warm fn(), all its operations summed (ms;
    torch.profiler over ``reps`` calls), and those operations [(name,
    ms)]; (None, []) where no window held them."""
    ops = device_op_ms(fn, reps=reps)
    return (sum(ms for _, ms in ops) if ops else None), ops


def host_ms(fn, reps=50):
    """The host's time of one warm fn() (ms, median of ``reps``):
    time.perf_counter around the call, no synchronisation inside it (the
    device drained between calls)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = time.perf_counter()
        fn()
        times.append((time.perf_counter() - start) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


def timed_call(label, fn):
    """fn()'s call (CUDA events, median of 10), its host time (host_ms)
    and its device operations with their times (call_device_ms), printed
    under ``label``. Returns {ms, host_ms, busy_ms, device_ops, ops_ms}."""
    ms, host = cuda_ms(fn, reps=10), host_ms(fn)
    busy, ops = call_device_ms(fn)
    print(f"{label}: call {ms:.4f} ms (CUDA events, median of 10), host {host:.4f} ms "
          f"(perf_counter, median of 50); {len(ops)} device operations, "
          + "; ".join(f"{n[:56]} {m:.4f}" for n, m in ops)
          + (f"; busy {busy:.4f} ms" if busy is not None else "; not measured")
          + " (profiler, 20 calls)", flush=True)
    return {"ms": ms, "host_ms": host, "busy_ms": busy if busy is not None else float("nan"),
            "device_ops": len(ops), "ops_ms": ops}


def prep_ablations(spheres, variants, rounds=2):
    """E4 in each of ``variants`` ({name: (edits, compared)}, or {name:
    (edits, private arguments, compared)}) bound in the package's place
    through ``_bucket_prims_ortho_kernels`` on the bench's sorted particles
    (512 x 512, tile 32 x 128, band 32, chunk 512): each compared variant's
    SplatBuckets bit-equal to the first's; then timed in turns (the
    variants, the variants backwards; ``rounds`` times): the call's device
    time, its operations summed (torch.profiler, 20 calls), and the call
    (CUDA events, median of 10); each variant's operations with their
    device times printed once. Returns {variant: {"device_ms": [..], "ms":
    [..], "ops": [(name, ms)]}}."""
    from grace_tpu_torch.trace import splat as sp

    variants = {name: v if len(v) == 3 else (v[0], {}, v[1]) for name, v in variants.items()}

    def build_or_none(i, name):
        try:
            return build_variant("splat_prep", f"splat_prep_e4_{i}", variants[name][0])
        except (RuntimeError, AssertionError, ValueError) as e:   # reported, not timed
            print(f"splat_prep part {name}: did not build: {str(e)[-2000:]}", flush=True)
            return None

    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(build_or_none, range(len(variants)), variants))
    dlls = {name: dll for name, dll in zip(variants, built) if dll is not None}
    names = list(dlls)

    def call(name):
        return routed(dlls[name], lambda: sp._bucket_prims_ortho_kernels(
            spheres, CAM, LOOK, UP, VEXT, LENGTH, SIDE, SIDE, 32, 128, 512, None, 32,
            **variants[name][1]))

    as_bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x
    want = [as_bits(x).clone() for x in call(names[0])]
    for name in names[1:]:
        got = call(name)
        torch.cuda.synchronize()
        if variants[name][2] and not all(torch.equal(as_bits(g), w) for g, w in zip(got, want)):
            raise AssertionError(f"splat_prep variant {name!r} differs from {names[0]!r}")
    result = {name: {"device_ms": [], "ms": [], "ops": []} for name in names}
    for _ in range(rounds):
        for name in names + names[::-1]:
            fn = lambda: call(name)
            ms, ops = call_device_ms(fn)
            result[name]["device_ms"].append(ms)
            result[name]["ops"] = result[name]["ops"] or ops
            result[name]["ms"].append(cuda_ms(fn, reps=10))
    for name, r in result.items():
        dev_ms = ", ".join("not measured" if m is None else f"{m:.4f}" for m in r["device_ms"])
        print(f"splat_prep part E4 {name}: device {dev_ms} ms (its operations summed, profiler, "
              f"20 calls each); call " + ", ".join(f"{m:.3f}" for m in r["ms"])
              + " ms (CUDA events, median of 10 each); in turns, "
              + (f"bit-equal to {names[0]}" if variants[name][2] else "a leave-out, not compared")
              + "; operations: " + "; ".join(f"{n[:48]} {ms:.4f}" for n, ms in r["ops"]),
              flush=True)
    return result


def splat_prep_paths():
    """The ``splat_prep`` part in this process, on whichever grace_tpu_torch
    it imports: {call: {ms, busy_ms, wall_ms, device_ops}}."""
    from grace_tpu_torch.build.sph import build_sph_tree
    from grace_tpu_torch.rays.gen import orthographic_projection_rays, spatial_sort_rays
    from grace_tpu_torch.trace import splat as sp
    from grace_tpu_torch.trace import splat_grad as sg
    from grace_tpu_torch.trace.pallas_broadphase import pack_overlap_bits

    dev = torch.device("cuda", 0)
    spheres = torch.from_numpy(
        make_clustered_particles(np.random.default_rng(2026), N_PARTICLES)).to(dev)
    sorted_spheres, _, _ = build_sph_tree(spheres, MAX_PER_LEAF)
    weights = torch.ones(N_PARTICLES, device=dev)
    cam = sg.OrthoCamera(CAM, LOOK, UP, VEXT, LENGTH, SIDE, SIDE)

    def setup():
        if hasattr(sg, "sortfree_setup"):
            return sg.sortfree_setup(sorted_spheres, weights, cam, 32, 128)
        proj = sg.project_ortho(sorted_spheres, weights, cam)
        overlap = sg.projected_overlap(*proj, cam, 32, 128)
        return (pack_overlap_bits(overlap), pack_overlap_bits(overlap.t()),
                sg._coords(cam, dev), sg.pack_proj_slabs(*proj))

    bucket = lambda s: sp.bucket_prims_ortho(s, CAM, LOOK, UP, VEXT, LENGTH, SIDE, SIDE,
                                             tile_w=32, tile_h=128, chunk=512, band=32)

    def frame():
        s, _, _ = build_sph_tree(spheres, MAX_PER_LEAF)
        spatial_sort_rays(orthographic_projection_rays(SIDE, SIDE, CAM, LOOK, UP, VEXT, LENGTH,
                                                       device=dev))
        return sp.splat_image(bucket(s), basis="deg8", tile_w=32, tile_h=128)

    render = sg.make_splat_trainer(cam, basis="deg8", tile_w=32, tile_h=128)
    target = 1.01 * sg.splat_forward_sortfree(sorted_spheres, weights, cam, 32, 128, "deg8")

    def train_step():
        s = sorted_spheres.detach().clone().requires_grad_(True)
        w = weights.detach().clone().requires_grad_(True)
        ((render(s, w) - target) ** 2).sum().div(SIDE * SIDE).backward()
        return s.detach() - 1e-6 * s.grad, w.detach() - 1e-6 * w.grad

    calls = [("bucket_prims_ortho", lambda: bucket(sorted_spheres)),
             ("sort-free setup", setup), ("splat frame", frame),
             ("sort-free train step", train_step)]
    if hasattr(sg, "_SETUP_CACHE"):
        # the kernels with the camera's constants computed anew each call
        # (their torch ops), not taken from the cache
        def bucket_uncached():
            sp._FRAME_CACHE.clear()
            return bucket(sorted_spheres)

        def setup_uncached():
            consts, spans, coords = sg._setup_constants_uncached(cam, 32, 128, dev)
            return sg.sortfree_setup_cuda(sorted_spheres, weights, consts, spans, coords,
                                          SIDE // 128, SIDE // 32)

        calls += [("bucket_prims_ortho, constants uncached", bucket_uncached),
                  ("sort-free setup, constants uncached", setup_uncached)]
    result = {}
    if not NO_VARIANTS:
        result["E4 variants"] = prep_ablations(
            sorted_spheres, PARENT_PREP_VARIANTS if hasattr(sp, "bucket_sort_cuda")
            else prep_variants())
    if hasattr(sg, "sortfree_setup_resources"):
        consts, spans, coords = sg._setup_constants(cam, 32, 128, dev)
        result.update(kernel_variants(
            "splat_prep", "splat_prep", {"4-byte slab stores": SETUP_SCALAR_STORES},
            {"sort-free setup (bench, weights 1)": lambda: sg.sortfree_setup_cuda(
                sorted_spheres, weights, consts, spans, coords, SIDE // 128, SIDE // 32)},
            "sortfree_setup_kernel"))
    for label, fn in calls:
        ms = cuda_ms(fn, reps=10)
        print(f"splat_prep part {label}: {ms:.3f} ms (CUDA events, median of 10)", flush=True)
        result[label] = {"ms": ms, **device_busy(f"splat_prep part {label}", fn)}
        if label == "sort-free setup":
            result[label]["kernel_ms"] = kernel_device_ms(fn, "sortfree_setup_kernel", reps=20)
            print(f"splat_prep part {label}: kernel {result[label]['kernel_ms']} ms "
                  f"(profiler, 20 calls)", flush=True)
        if label == "bucket_prims_ortho":
            busy, ops = call_device_ms(fn)
            result[label]["ops_ms"] = ops
            print(f"splat_prep part {label}: {len(ops)} device operations, "
                  + "; ".join(f"{n[:48]} {ms:.4f}" for n, ms in ops)
                  + (f"; busy {busy:.4f} ms, host share {result[label]['ms'] - busy:.4f} ms "
                     f"of the call" if busy is not None else "; not measured")
                  + " (profiler, 20 calls)", flush=True)
    return result


def part_turns(part, parent_dir, rounds=1):
    """Part ``part`` on DIR's package and on this one in turns (parent,
    this, this, parent; ``rounds`` times), each a process of its own.
    Returns {"parent": [run, ...], "this": [run, ...]}."""
    runs = {"parent": [], "this": []}
    for who in ("parent", "this", "this", "parent") * rounds:
        cmd = [sys.executable, os.path.abspath(__file__), part]
        if who == "parent":
            cmd += ["--package", parent_dir]
        if runs[who]:
            cmd += ["--no-variants"]   # the kernel variants run in each side's first only
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            print(f"{who}: {' '.join(cmd)} failed ({res.returncode}):\n{res.stdout[-4000:]}"
                  f"\n{res.stderr[-8000:]}", flush=True)
            res.check_returncode()
        out = res.stdout
        for line in out.splitlines()[:-1]:
            print(f"{who}: {line}", flush=True)
        runs[who].append(json.loads(out.splitlines()[-1])[part])
    def cell(x):
        return (f"{x['ms']:.3f} ms"
                + (f" (host {x['host_ms']:.3f})" if "host_ms" in x else "")
                + (f" ({x['device_ops']} ops, busy {x['busy_ms']:.4f} ms)"
                   if "device_ops" in x else "")
                + (f" [kernel {x['kernel_ms']:.4f} ms]" if x.get("kernel_ms") else ""))

    for label in runs["this"][0]:
        if "ms" not in runs["this"][0][label]:
            continue   # a variant's own turns, printed by its run
        cells = [f"{who} " + ", ".join(cell(r[label]) for r in runs[who])
                 for who in ("parent", "this") if label in runs[who][0]]
        print(f"{part} in turns, {label}: " + "; ".join(cells), flush=True)
        if rounds > 1:
            med = {who: statistics.median(r[label]["ms"] for r in runs[who])
                   for who in ("parent", "this") if label in runs[who][0]}
            pairs = [b[label]["ms"] - a[label]["ms"] for a, b in zip(runs["parent"], runs["this"])
                     if label in a]
            print(f"{part} in turns, {label}: median of the runs: "
                  + ", ".join(f"{who} {m:.3f} ms" for who, m in med.items())
                  + f"; this minus parent, run by run: "
                  + ", ".join(f"{x:+.3f}" for x in pairs)
                  + f" ({sum(x > 0 for x in pairs)} of {len(pairs)} slower)", flush=True)
    return runs


def broadphase_paths():
    """The ``broadphase`` part in this process, on whichever grace_tpu_torch
    it imports: {call: {ms, busy_ms, wall_ms, device_ops}}."""
    from grace_tpu_torch.build.sph import build_sph_tree
    from grace_tpu_torch.models import triangle as mt
    from grace_tpu_torch.rays.gen import orthographic_projection_rays, spatial_sort_rays
    from grace_tpu_torch.trace import pallas_broadphase as pb
    from grace_tpu_torch.trace import pallas_kernel as pk
    from grace_tpu_torch.trace import pallas_records as prc
    from grace_tpu_torch.trace import pallas_render as pr
    from grace_tpu_torch.trace import pallas_tri as pt

    dev = torch.device("cuda", 0)
    spheres = torch.from_numpy(
        make_clustered_particles(np.random.default_rng(2026), N_PARTICLES)).to(dev)
    ss, tree, _ = build_sph_tree(spheres, MAX_PER_LEAF)
    rays_s, _, _ = spatial_sort_rays(orthographic_projection_rays(
        SIDE, SIDE, CAM, LOOK, UP, VEXT, LENGTH, device=dev))
    weights = torch.ones(N_PARTICLES, device=dev)
    tris = torch.from_numpy(torus_mesh(**TORUS)).to(dev)
    fused = pr.make_fused_renderer(tile=TRACE_TILE, max_chunks=2048, max_tiles_per_seg=2048)
    target = 1.01 * fused(rays_s, ss, weights).detach()

    def fused_step():
        s = ss.detach().clone().requires_grad_(True)
        w = weights.detach().clone().requires_grad_(True)
        ((fused(rays_s, s, w) - target) ** 2).sum().div(SIDE * SIDE).backward()
        return s.detach() - 1e-6 * s.grad, w.detach() - 1e-6 * w.grad

    result = {}
    from grace_tpu_torch.trace import broadphase as bp

    if hasattr(pb, "overlap_words_resources"):
        seg = {b: pb.segment_aabbs(ss, b) for b in (32, 128)}
        tiles = {t: bp.tile_aabbs(rays_s, t) for t in (64, TRACE_TILE)}
        calls = {
            "overlap words, tile 64 x quarters, summary": lambda: pb.overlap_words_cuda(
                *tiles[64], *seg[32], summary=True),
            "overlap words, tile 128 x quarters, summary": lambda: pb.overlap_words_cuda(
                *tiles[TRACE_TILE], *seg[32], summary=True),
            "overlap words, segments x tile 128": lambda: (pb.overlap_words_cuda(
                *seg[128], *tiles[TRACE_TILE]),)}
        result.update(kernel_variants("broadphase", "broadphase", OVERLAP_VARIANTS, calls,
                                      "overlap_words_kernel", not_compared=OVERLAP_LEAVE_OUTS))
    if hasattr(pb, "broadphase_boxes_cuda"):
        flat = lambda boxes: (*boxes[0], *boxes[1])
        calls = {
            "boxes, quarters and tile 128": lambda: flat(pb.broadphase_boxes_cuda(
                rays_s, TRACE_TILE, ss, 32)),
            "boxes, segments and tile 64": lambda: flat(pb.broadphase_boxes_cuda(
                rays_s, 64, ss, 128))}
        result.update(kernel_variants("boxes", "broadphase", BOX_VARIANTS, calls, "boxes_kernel",
                                      not_compared=BOX_LEAVE_OUTS))
    # E6's boxes through the public functions (one part each) and both
    # sets as the dense callers take them: a package with the one-launch
    # wrapper makes one call, the earlier one the two
    both = getattr(pb, "broadphase_boxes_cuda", None)
    for label, fn in (
            ("segment boxes, quarters (block 32)", lambda: pb.segment_aabbs(ss, 32)),
            ("segment boxes, segments (block 128)", lambda: pb.segment_aabbs(ss, 128)),
            ("tile boxes, tile 128", lambda: bp.tile_aabbs(rays_s, TRACE_TILE)),
            ("tile boxes, tile 64", lambda: bp.tile_aabbs(rays_s, 64)),
            ("both box sets, quarters and tile 128",
             (lambda: both(rays_s, TRACE_TILE, ss, 32)) if both else
             (lambda: (bp.tile_aabbs(rays_s, TRACE_TILE), pb.segment_aabbs(ss, 32)))),
            ("both box sets, segments and tile 128",
             (lambda: both(rays_s, TRACE_TILE, ss, 128)) if both else
             (lambda: (bp.tile_aabbs(rays_s, TRACE_TILE), pb.segment_aabbs(ss, 128))))):
        result[label] = timed_call(f"broadphase part {label}", fn)
    tmin64, tmax64 = pb.tile_aabbs(rays_s, 64)
    seg_q = pb.segment_aabbs(ss, 32)
    for label, fn in (
            ("dense_tile_masks_quarter, tile 128",
             lambda: pb.dense_tile_masks_quarter(rays_s, ss, TRACE_TILE)),
            ("dense_tile_masks_quarter, tile 64", lambda: pb.dense_tile_masks_quarter(rays_s, ss, 64)),
            ("dense_tile_masks, tile 128", lambda: pb.dense_tile_masks(rays_s, ss, TRACE_TILE)),
            ("quarter_lists, tile 128, max_q 512 (ops)",
             lambda: pb.quarter_lists(rays_s, ss, TRACE_TILE, 512)),
            ("dense_tile_segments, tile 128, max_chunks 2048",
             lambda: pb.dense_tile_segments(rays_s, ss, TRACE_TILE, 2048)),
            ("dense_segment_tiles, tile 128, max_tiles 2048",
             lambda: pr.dense_segment_tiles(rays_s, ss, pr.BWD_TILE, 2048))):
        result[label] = timed_call(f"broadphase part {label}", fn)
    for label, fn in (
            ("overlap words, tile 64 x quarters, summary (E6's call)",
             lambda: pb.overlap_words_cuda(tmin64, tmax64, *seg_q, summary=True)),
            ("quarter trace", lambda: pk.pallas_trace_sph(rays_s, ss, tree, tile=TRACE_TILE,
                                                          broadphase="quarter")),
            ("record trace, default (quarter) route",
             lambda: prc.pallas_trace_sph_records(rays_s, ss, 512)),
            ("quarter masks, tile 64", lambda: pb.dense_tile_masks_quarter(rays_s, ss, 64)),
            ("quarter masks, tile 128",
             lambda: pb.dense_tile_masks_quarter(rays_s, ss, TRACE_TILE)),
            ("quarter_lists, tile 128, max_q 512",
             lambda: pb.quarter_lists(rays_s, ss, TRACE_TILE, 512)),
            ("render_triangles pallas", lambda: mt.render_triangles(tris, resolution=SIDE,
                                                                    engine="pallas")),
            ("fused train step", fused_step)):
        ms = cuda_ms(fn, reps=10)
        print(f"broadphase part {label}: {ms:.3f} ms (CUDA events, median of 10)", flush=True)
        result[label] = {"ms": ms, **device_busy(f"broadphase part {label}", fn)}
        if "E6's call" in label:
            result[label]["kernel_ms"] = kernel_device_ms(fn, "overlap_words_kernel", reps=20)
            print(f"broadphase part {label}: kernel {result[label]['kernel_ms']} ms "
                  f"(profiler, 20 calls)", flush=True)
    # E6's compaction at the main paths' shapes, with its variants
    result.update({f"compaction: {k}": v for k, v in compaction_paths().items()})
    return result


# E2's keys (csrc/build.cu): every held item reread after the grid's
# barrier instead of kept in registers, or 16 held; 6 blocks an SM (the
# first form, whose 792 blocks each fold 792 partial boxes); the f64 clamp
# conversion in place of the saturating cvt.rzi (the same bits:
# chip_smoke's keys checks); the 30-bit spread in 64-bit ints; the partial
# boxes folded by block 0 alone behind a second grid barrier; and two
# leave-outs (KEYS_LEAVE_OUTS, wrong keys, timed only): no grid barrier,
# and each block's own box (no barrier, no partial boxes)
KEY_FOLD = "        cooperative_groups::this_grid().sync();\n"
KEY_FOLD_END = "        if (threadIdx.x < 3) box[3 + threadIdx.x] = span"
KEYS_LEAVE_OUTS = ("leave-out: no grid barrier", "leave-out: each block's own box")
KEYS_VARIANTS = {
    "reread (no item held across the barrier)": [
        swap("build.cu", "constexpr int kHeld = 4;", "constexpr int kHeld = 0;")],
    "16 items held": [swap("build.cu", "constexpr int kHeld = 4;", "constexpr int kHeld = 16;")],
    "6 blocks an SM (the first form)": [
        swap("build.cu", "constexpr int kFoldBlocksPerSm = 2;", "constexpr int kFoldBlocksPerSm = 6;")],
    "f64 clamp conversion": [
        swap("build.cu", "    return __float2uint_rz(v);\n",
             "    return v != v ? 0u : static_cast<unsigned>(fmin(fmax(static_cast<double>(v), "
             "0.0), 4294967295.0));\n")],
    "30-bit spread in 64-bit ints": [
        swap("build.cu", "        return (spread10(u[2]) << 2) | (spread10(u[1]) << 1) | "
             "spread10(u[0]);",
             "        return static_cast<unsigned long long>((spread21(u[2] & 1023u) << 2) | "
             "(spread21(u[1] & 1023u) << 1) | spread21(u[0] & 1023u));")],
    "block 0 folds the partial boxes, two barriers": [
        swap_between("build.cu", KEY_FOLD, KEY_FOLD_END, KEY_FOLD + """\
        if (blockIdx.x == 0) {
            float all[6] = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY, -INFINITY};
            for (int b = threadIdx.x; b < gridDim.x; b += kThreads) {
                float part[6];
                for (int k = 0; k < 6; ++k) part[k] = __ldcg(a.parts + 6 * b + k);
                fold_box(all, part);
            }
            block_box(all, warps, box);
            if (threadIdx.x < 6) a.parts[threadIdx.x] = box[threadIdx.x];
        }
""" + KEY_FOLD + """\
        if (threadIdx.x < 6) box[threadIdx.x] = __ldcg(a.parts + threadIdx.x);
        __syncthreads();
""")],
    "leave-out: no grid barrier": [swap("build.cu", KEY_FOLD, "")],
    "leave-out: each block's own box": [swap_between("build.cu", KEY_FOLD, KEY_FOLD_END, "")],
}


def keys_paths():
    """The ``morton`` part in this process, on whichever grace_tpu_torch it
    imports (E2's keys): ``morton_keys_sph`` on the bench's 2^20 clustered
    particles (the box folded in the call), ``spatial_sort_rays`` on main
    path 1's 512^2 orthographic rays, the keys alone at a given box, and
    ``build_sph_tree``; each call's CUDA-event and host ms, device
    operations with their times, and the keys kernel's device time
    (torch.profiler); in this package's first process the keys kernel's
    variants (KEYS_VARIANTS) in turns by device time."""
    from grace_tpu_torch.build.sph import build_sph_tree, morton_keys_sph
    from grace_tpu_torch.ops import morton
    from grace_tpu_torch.rays.gen import orthographic_projection_rays, spatial_sort_rays

    dev = torch.device("cuda", 0)
    spheres = torch.from_numpy(
        make_clustered_particles(np.random.default_rng(2026), N_PARTICLES)).to(dev)
    rays = orthographic_projection_rays(SIDE, SIDE, CAM, LOOK, UP, VEXT, LENGTH, device=dev)
    c = spheres[:, :3]
    lo, hi = c.amin(dim=0), c.amax(dim=0)
    result = {}
    calls = {
        "morton_keys_sph, bench scene (box in the call)": lambda: (morton_keys_sph(spheres),),
        "spatial_sort_rays, 512^2 rays": lambda: spatial_sort_rays(rays)[1:],
        "keys at a given box, bench scene": lambda: (morton.morton_keys_cuda(c, lo, hi, 30),),
        "63-bit keys, bench scene (box in the call)": lambda: (
            morton_keys_sph(spheres, bits=63),)}
    if hasattr(morton, "ray_keys_cuda"):
        calls["ray keys alone, 512^2 rays (box in the call)"] = lambda: (morton.ray_keys_cuda(
            rays.origins, rays.directions, rays.lengths),)
    result.update(kernel_variants("morton", "build", KEYS_VARIANTS, calls, "morton_keys",
                                  not_compared=KEYS_LEAVE_OUTS))
    if hasattr(morton, "ray_keys_cuda"):   # the folding grid capped at other sizes
        for blocks in (132,):
            calls[f"morton_keys_sph, bench scene, the grid capped at {blocks} blocks"] = (
                lambda b=blocks: (morton.morton_keys_cuda(c, None, None, 30, _blocks=b),))
    for label, fn in list(calls.items()) + [
            ("rays + sort, 512^2 (orthographic_projection_rays, spatial_sort_rays)",
             lambda: spatial_sort_rays(orthographic_projection_rays(
                 SIDE, SIDE, CAM, LOOK, UP, VEXT, LENGTH, device=dev))),
            ("build_sph_tree, bench scene", lambda: build_sph_tree(spheres, MAX_PER_LEAF))]:
        result[label] = timed_call(f"morton part {label}", fn)
        kernel = kernel_device_ms(fn, "morton_keys", reps=20)
        result[label]["kernel_ms"] = kernel
        print(f"morton part {label}: keys kernel "
              + ("not measured" if kernel is None else f"{kernel:.4f} ms")
              + " (profiler, 20 calls)", flush=True)
    return result


# E6's compaction (csrc/broadphase.cu): the padding as 4-byte stores (a
# lane a slot), the padding's 16-byte stores not streaming, the words as
# 4-byte loads (the route of rows that are no multiple of 4 words), no
# group's loads ahead; and a leave-out, no padding (wrong ids past n)
COMPACT_LEAVE_OUTS = ("leave-out: no padding",)
PAD_4_BYTES = """__device__ __forceinline__ void pad_row(int* dst, int n, int max_q, int lane) {
    for (int k = n + lane; k < max_q; k += 32) dst[k] = 0;
}
"""
COMPACT_VARIANTS = {
    "4-byte padding stores": [swap_function("broadphase.cu", "pad_row", PAD_4_BYTES)],
    "16-byte padding stores, not streaming": [
        swap("broadphase.cu", "        __stcs(reinterpret_cast<int4*>(dst + head) + k, make_int4(0, 0, 0, 0));",
             "        reinterpret_cast<int4*>(dst + head)[k] = make_int4(0, 0, 0, 0);")],
    "4-byte word loads": [
        swap("broadphase.cu", "    const bool vec = n_words % 4 == 0 &&",
             "    const bool vec = false && n_words % 4 == 0 &&")],
    "no loads ahead": [
        swap("broadphase.cu", "constexpr int kAhead = 1;", "constexpr int kAhead = 0;")],
    "leave-out: no padding": [swap_function(
        "broadphase.cu", "pad_row",
        "__device__ __forceinline__ void pad_row(int* dst, int n, int max_q, int lane) {}\n")],
}


def compaction_paths():
    """The ``compaction`` part in this process, on whichever
    grace_tpu_torch it imports (E6's compaction): ``compact_words_cuda``
    at each main-path shape (the bench's sorted 2^20 spheres, 512^2 sorted
    rays): path 2's qlist (quarter words at tile 128, max_q 2048) and list
    rows (segment words at tile 128, 2048), path 3's ``dense_tile_segments``
    (the same words) and ``dense_segment_tiles`` (8,192 segment rows of tile
    words, max_tiles 2048), and chip_smoke's case (quarter words at tile
    64, max_q 512); each call's CUDA-event and host ms, its device
    operations and the kernel's device time (torch.profiler), the set bits
    and bytes; in this package's first process the kernel's variants
    (COMPACT_VARIANTS) in turns by device time."""
    from grace_tpu_torch.build.sph import build_sph_tree
    from grace_tpu_torch.rays.gen import orthographic_projection_rays, spatial_sort_rays
    from grace_tpu_torch.trace import pallas_broadphase as pb
    from grace_tpu_torch.trace import pallas_render as pr

    dev = torch.device("cuda", 0)
    spheres = torch.from_numpy(
        make_clustered_particles(np.random.default_rng(2026), N_PARTICLES)).to(dev)
    ss, _, _ = build_sph_tree(spheres, MAX_PER_LEAF)
    rays_s, _, _ = spatial_sort_rays(orthographic_projection_rays(
        SIDE, SIDE, CAM, LOOK, UP, VEXT, LENGTH, device=dev))
    q128 = pb.dense_tile_masks_quarter(rays_s, ss, TRACE_TILE)[0]
    q64 = pb.dense_tile_masks_quarter(rays_s, ss, 64)[0]
    seg = pb.dense_tile_masks(rays_s, ss, TRACE_TILE)
    tmin, tmax = pb.tile_aabbs(rays_s, pr.BWD_TILE)
    smin, smax = pb.segment_aabbs(ss, 128)
    seg_tiles = pb.overlap_words_cuda(smin, smax, tmin, tmax)
    shapes = {"path 2 qlist (quarter words, tile 128, max_q 2048)": (q128, 2048),
              "path 2 list and path 3 dense_tile_segments (segment words, tile 128, 2048)":
                  (seg, 2048),
              "path 3 dense_segment_tiles (8,192 segment rows, max_tiles 2048)": (seg_tiles, 2048),
              "chip_smoke case (quarter words, tile 64, max_q 512)": (q64, 512)}
    calls = {label: (lambda w=w, q=q: pb.compact_words_cuda(w, q))
             for label, (w, q) in shapes.items()}
    result = {}
    result.update(kernel_variants("compaction", "broadphase", COMPACT_VARIANTS, calls,
                                  "compact_words", not_compared=COMPACT_LEAVE_OUTS))
    for label, fn in calls.items():
        w, q = shapes[label]
        ids, n, ovf = fn()
        bits = int(_popcount_rows(w).sum())
        n_bytes = 4 * w.numel() + 4 * ids.numel() + 4 * n.numel() + ovf.numel()
        result[label] = timed_call(f"compaction part {label}", fn)
        kernel = kernel_device_ms(fn, "compact_words", reps=20)
        result[label].update(kernel_ms=kernel, set_bits=bits, bytes=n_bytes,
                             bound_ms=n_bytes / 3.35e9, listed=int(n.sum()),
                             overflowed=int(ovf.sum()))
        print(f"compaction part {label}: words {tuple(w.shape)}, {bits} set bits, "
              f"{int(n.sum())} listed, {int(ovf.sum())} rows overflowed; {n_bytes} bytes, "
              f"bound {n_bytes / 3.35e9:.4f} ms; kernel "
              + ("not measured" if kernel is None else f"{kernel:.4f} ms")
              + " (profiler, 20 calls)", flush=True)
    return result


# E7's variants (csrc/tri_lists.cu): (edits, the wrapper's private limits,
# the scratch rows it allocates, compared with the shipped kernel's bits)
TRI = "tri_lists.cu"
TRI_LEAVE_OUTS = ("leave-out: no sort", "leave-out: no row writes",
                  "leave-out: nothing listed (hulls, union tests, a row of ids)",
                  "leave-out: the hulls alone", "leave-out: the hulls alone without folds",
                  "leave-out: the hulls alone with f32 fmas",
                  "leave-out: no tiles (the launch, staging, word hulls)")
# E7's hulls as the first form of this design: two redux.sync a (k, axis)
# on order-preserving ints, lanes over the rays (in place of the rows
# folded in shared memory)
TRI_HULLS_BY_REDUX = """    const long long r0 = t * a.tile;
    const bool one = a.tile <= 32, have = lane < a.tile;
    float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f}, ln = 0.0f;
    if (one && have) {
        const long long r = r0 + lane;
        for (int x = 0; x < 3; ++x) {
            o[x] = a.origins[3 * r + x];
            d[x] = a.dirs[3 * r + x];
        }
        ln = clamp0(a.lengths[r]);
    }
    float prev_lo[3], prev_hi[3];
    float u_lo[3] = {INFINITY, INFINITY, INFINITY}, u_hi[3] = {-INFINITY, -INFINITY, -INFINITY};
    for (int k = 0; k <= K; ++k) {
        const float fk = a.frac[k];
#pragma unroll
        for (int x = 0; x < 3; ++x) {
            float lo = INFINITY, hi = -INFINITY;
            if (one) {
                if (have) lo = hi = fma_f64(d[x], ln * fk, o[x]);
            } else {
                for (int i = lane; i < a.tile; i += 32) {
                    const long long r = r0 + i;
                    const float v = fma_f64(a.dirs[3 * r + x], clamp0(a.lengths[r]) * fk,
                                            a.origins[3 * r + x]);
                    lo = nan_min(lo, v);
                    hi = nan_max(hi, v);
                }
            }
            lo = warp_min(lo);
            hi = from_order_int(__reduce_max_sync(kFull, isnan(hi) ? INT_MAX : order_int(hi)));
            if (k > 0) {
                const float il = nan_min(prev_lo[x], lo), ih = nan_max(prev_hi[x], hi);
                if (lane == 0) {
                    iv[8 * (k - 1) + x] = il;
                    iv[8 * (k - 1) + 4 + x] = ih;
                }
                u_lo[x] = fminf(u_lo[x], il);
                u_hi[x] = fmaxf(u_hi[x], ih);
            }
            prev_lo[x] = lo;
            prev_hi[x] = hi;
        }
    }
    float omin[3], omax[3];
#pragma unroll
    for (int x = 0; x < 3; ++x) {
        float lo = INFINITY, hi = -INFINITY;
        for (int i = lane; i < a.tile; i += 32) {
            const float v = a.origins[3 * (r0 + i) + x];
            lo = nan_min(lo, v);
            hi = nan_max(hi, v);
        }
        omin[x] = warp_min(lo);
        omax[x] = from_order_int(__reduce_max_sync(kFull, isnan(hi) ? INT_MAX : order_int(hi)));
    }
    float ln_min = INFINITY;
    for (int i = lane; i < a.tile; i += 32) ln_min = nan_min(ln_min, clamp0(a.lengths[r0 + i]));
    ln_min = warp_min(ln_min);
    __syncwarp();

"""


def tri_variants():
    """This package's list kernel as shipped and in its variants."""
    warps = lambda n: swap(TRI, "constexpr int kWarps = 16;", f"constexpr int kWarps = {n};")
    blocks = lambda n: swap(TRI, "constexpr int kMinBlocks = 2;",
                            f"constexpr int kMinBlocks = {n};")
    grid_line = ("    long long warps = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms * "
                 "p.warps;")
    no_hulls = swap(TRI, "        unsigned c = __ballot_sync(kFull, cand);",
                    "        unsigned c = __ballot_sync(kFull, w < n_words);")
    hulls_alone = swap(TRI, "    // 2. the segments. The union against each word's hull",
                       "    if (K > 0) return;\n    // 2. the segments. The union against each "
                       "word's hull")
    return {
        "shipped": (None, {}, None, True),
        "boxes from device memory": (None, {"_stage": 0}, None, True),
        "4-byte row stores": ([swap(TRI, "    p.vec = max_chunks % 4 == 0;",
                                    "    p.vec = false;")], {}, None, True),
        "warp buffer 128": (None, {"_warp_buf": 128}, None, True),
        "warp buffer 64": (None, {"_warp_buf": 64}, None, True),
        "warp buffer 32": (None, {"_warp_buf": 32}, None, True),
        "one block an SM (128 registers)": ([blocks(1)], {}, None, True),
        "8 warps a block, three blocks an SM": ([warps(8), blocks(3)], {}, None, True),
        "8 warps a block, four blocks an SM": ([warps(8), blocks(4)], {}, None, True),
        "32 warps a block": ([warps(32), blocks(1)], {}, None, True),
        "a grid of one block an SM": ([swap(TRI, grid_line, grid_line.replace(
            "(per_sm > 0 ? per_sm : 1)", "(1)"))], {}, None, True),
        "not persistent (a warp a tile, every block staging)": ([swap(
            TRI, grid_line, "    long long warps = n_tiles;")], {}, 1 << 14, True),
        "row stores not streaming (st.global)": ([swap(
            TRI, "            __stcs(reinterpret_cast<int4*>(ids) + v, vi);   // streaming: "
            "read by the next kernel\n"
            "            __stcs(reinterpret_cast<float4*>(dist) + v, vd);",
            "            reinterpret_cast<int4*>(ids)[v] = vi;\n"
            "            reinterpret_cast<float4*>(dist)[v] = vd;")], {}, None, True),
        "hulls by redux.sync (the first form)": ([swap_between(
            TRI, "    const long long r0 = t * a.tile;\n    for (int g0 = 0;",
            "    // 2. the segments. The union against", TRI_HULLS_BY_REDUX)], {}, None, True),
        "tiles by a grid stride (no tickets)": ([swap(
            TRI, "        unsigned long long next = 0;\n"
            "        if (lane == 0) next = atomicAdd(a.tickets, 1ull);\n"
            "        t = a.n_warps + static_cast<long long>(__shfl_sync(kFull, next, 0));",
            "        t += a.n_warps;")], {}, None, True),
        "without the word hulls": ([no_hulls], {}, None, True),
        "without the union tests (hulls and boxes)": ([no_hulls, swap(
            TRI, "            const bool near = s < S && u_lo[0] <= bmax[3 * s] &&",
            "            const bool near = s < S;\n            const bool unused = "
            "u_lo[0] <= bmax[3 * s] &&")], {}, None, True),
        TRI_LEAVE_OUTS[0]: ([swap(TRI, "    warp_bitonic<E>(v, lane);\n    __syncwarp();",
                                  "    __syncwarp();"),
                             swap(TRI, "        warp_bitonic<8>(v, lane);\n        chunk_store",
                                  "        chunk_store"),
                             swap(TRI, "            half_clean<8, kChunk / 2>(v, lane);\n", ""),
                             swap(TRI, "            for (int q = lane; q < w / 2; q += 32) {",
                                  "            for (int q = lane; false; q += 32) {")],
                            {}, None, False),
        TRI_LEAVE_OUTS[1]: ([swap(TRI, "for (int v = lane; 4 * v < a.max_chunks; v += 32) {",
                                  "for (int v = lane; false; v += 32) {")], {}, None, False),
        TRI_LEAVE_OUTS[2]: ([swap(TRI, "const unsigned word = __ballot_sync(kFull, near);",
                                  "const unsigned word = __ballot_sync(kFull, near && K < 0);")],
                            {}, None, False),
        TRI_LEAVE_OUTS[3]: ([hulls_alone], {}, None, False),
        TRI_LEAVE_OUTS[4]: ([hulls_alone, swap(
            TRI, "if (lane < 3 * (g1 - g0)) {   // two folds side by side",
            "if (lane < 3 * (g1 - g0) && K < 0) {   // two folds side by side")],
            {}, None, False),
        TRI_LEAVE_OUTS[5]: ([hulls_alone, swap(
            TRI, "g <= K ? fma_f64(d[x], tk, o[x]) : o[x];",
            "g <= K ? fmaf(d[x], tk, o[x]) : o[x];")],
            {}, None, False),
        TRI_LEAVE_OUTS[6]: ([swap(
            TRI, "    for (long long t = g; t < a.n_tiles;) {",
            "    for (long long t = g; t < a.n_tiles && a.K < 0;) {")],
            {}, None, False),
    }


# The parent's list kernel (a block a tile): its boxes staged once a block
# in dynamic shared memory, in 396 persistent blocks (3 an SM; the same
# bits); and the leave-outs no sort and no row writes.
PARENT_TRI_STAGE = [
    swap(TRI, "    const int keep = max_chunks < n_segs ? max_chunks : n_segs;\n",
         "    const int keep = max_chunks < n_segs ? max_chunks : n_segs;\n"
         "    float* sbox = reinterpret_cast<float*>(prefix + n_words);\n"
         "    for (int i = tid; i < 3 * n_segs; i += kThreads) {\n"
         "        sbox[i] = seg_min[i];\n"
         "        sbox[3 * n_segs + i] = seg_max[i];\n"
         "    }\n"
         "    __syncthreads();\n"),
    swap(TRI, "lo[a] = seg_min[3LL * s + a];\n                hi[a] = seg_max[3LL * s + a];",
         "lo[a] = sbox[3 * s + a];\n                hi[a] = sbox[3 * n_segs + 3 * s + a];"),
    swap(TRI, "                        sizeof(int) * 2 * static_cast<size_t>(n_words);",
         "                        sizeof(int) * 2 * static_cast<size_t>(n_words) +\n"
         "                        sizeof(float) * 6 * static_cast<size_t>(n_segs);"),
    swap(TRI, "        smem > 48 * 1024 || !frac ||", "        smem > 200 * 1024 || !frac ||"),
    swap(TRI, "    const int blocks = shared_sort ? n_tiles :",
         "    const int blocks = shared_sort ? (n_tiles < 396 ? n_tiles : 396) :"),
    swap(TRI, "    tri_lists_kernel<<<blocks, kThreads, smem,",
         "    cudaFuncSetAttribute(tri_lists_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,\n"
         "                         static_cast<int>(smem));\n"
         "    tri_lists_kernel<<<blocks, kThreads, smem,"),
]
PARENT_TRI_VARIANTS = {
    "parent as shipped": (None, {}, None, True),
    "parent, boxes staged once a block (396 persistent blocks)": (PARENT_TRI_STAGE, {}, None,
                                                                   True),
    "parent, " + TRI_LEAVE_OUTS[0]: ([swap(TRI, "        for (int k = 2; k <= width; k <<= 1) {",
                                           "        for (int k = 2; false && k <= width; "
                                           "k <<= 1) {")], {}, None, False),
    "parent, " + TRI_LEAVE_OUTS[1]: ([
        swap(TRI, "for (int i = tid; i < m; i += kThreads) {\n            const int c = i < lt",
             "for (int i = tid; i < m && max_chunks < 0; i += kThreads) {\n"
             "            const int c = i < lt"),
        swap(TRI, "for (int w = warp; w < n_words && lt + prefix[w] < keep; w += kWarps) {",
             "for (int w = warp; w < n_words && max_chunks < 0; w += kWarps) {"),
        swap(TRI, "        for (int c = keep + tid; c < max_chunks; c += kThreads) {",
             "        for (int c = keep + tid; c < 0; c += kThreads) {")], {}, None, False),
}


def tri_list_ablations(sets, seg_boxes, variants):
    """E7 in each of ``variants`` ({name: (edits, private limits, scratch
    rows or None, compared)}) bound in the package's place through its
    wrapper, on each ray set ({name: clipped rays}): each compared
    variant's four outputs bit-equal to the first's; then timed in turns
    (the variants, the variants backwards; twice): the kernel's device time
    (torch.profiler, 20 calls) and the call (CUDA events, median of 10).
    Returns {f"{variant}, {set}": {"device_ms": [..], "ms": [..]}}."""
    from grace_tpu_torch.trace import pallas_tri as pt

    def build_or_none(i, name):
        try:
            return build_variant("tri_lists", f"tri_lists_{i}", variants[name][0])
        except RuntimeError as e:   # a variant that does not build is reported, not timed
            print(f"tri_lists part {name}: did not build: {str(e)[-2000:]}", flush=True)
            return None

    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(build_or_none, range(len(variants)), variants))
    dlls = {name: dll for name, dll in zip(variants, built) if dll is not None}
    names = list(dlls)
    shipped_slots = pt.SORT_SLOTS

    def call(name, rays):
        _, limits, slots, _ = variants[name]
        pt.SORT_SLOTS = slots or shipped_slots
        try:
            return routed(dlls[name], lambda: pt.tri_tile_lists_cuda(
                rays, *seg_boxes, 32, 2048, **limits))
        finally:
            pt.SORT_SLOTS = shipped_slots

    as_bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x
    result = {}
    for set_name, rays in sets.items():
        want = [as_bits(x).clone() for x in call(names[0], rays)]
        for name in names[1:]:
            got = call(name, rays)
            torch.cuda.synchronize()
            if variants[name][3] and not all(torch.equal(as_bits(g), w)
                                             for g, w in zip(got, want)):
                raise AssertionError(f"tri_lists variant {name!r} differs on the {set_name} rays")
        times = {name: {"device_ms": [], "ms": []} for name in names}
        for _ in range(2):
            for name in names + names[::-1]:
                fn = lambda: call(name, rays)
                times[name]["device_ms"].append(kernel_device_ms(fn, "tri_lists_kernel",
                                                                 reps=20))
                times[name]["ms"].append(cuda_ms(fn, reps=10))
        for name, r in times.items():
            dev_ms = ", ".join("not measured" if m is None else f"{m:.4f}"
                               for m in r["device_ms"])
            print(f"tri_lists part {name}, torus {set_name}: kernel {dev_ms} ms (profiler, 20 "
                  f"calls each); call " + ", ".join(f"{m:.3f}" for m in r["ms"])
                  + " ms (CUDA events, median of 10 each); in turns, "
                  + ("bit-equal to " + names[0] if variants[name][3] else
                     "a leave-out, not compared"), flush=True)
            result[f"{name}, {set_name}"] = r
    return result


def tri_lists_paths():
    """The ``tri_lists`` part in this process, on whichever grace_tpu_torch
    it imports: E7's call on path 5's primary and shadow rays with its
    kernel's device time and the call's device operations, and
    render_triangles(engine="pallas"); first (not with --no-variants) the
    kernel's variants: this package's (tri_variants) where its wrapper
    takes the private limits, else the parent's (PARENT_TRI_VARIANTS)."""
    import inspect

    from grace_tpu_torch.models import triangle as mt
    from grace_tpu_torch.rays.gen import pinhole_camera_rays
    from grace_tpu_torch.trace import pallas_tri as pt
    from chip_smoke import torus_list_rays

    dev = torch.device("cuda", 0)
    tris = torch.from_numpy(torus_mesh(**TORUS)).to(dev)
    sorted_tris, _, _ = mt.build_triangle_tree(tris)
    cam, look, length = mt.auto_camera(sorted_tris, SIDE)
    rays = pinhole_camera_rays(SIDE, SIDE, cam.tolist(), look.tolist(), (0.0, 1.0, 0.0),
                               math.pi / 3, float(length), device=dev)
    t, ids, _ = pt.pallas_trace_tri(rays, sorted_tris)
    clipped = torus_list_rays(rays, sorted_tris, t, ids, length)
    sets = {"primary": clipped["rays_clipped"], "shadow": clipped["shadow_clipped"]}
    seg_boxes = pt.tri_segment_aabbs(sorted_tris)
    result = {}
    if not NO_VARIANTS:
        ours = "_warp_buf" in inspect.signature(pt.tri_tile_lists_cuda).parameters
        result["variants"] = tri_list_ablations(sets, seg_boxes,
                                                tri_variants() if ours else PARENT_TRI_VARIANTS)
    calls = [(f"tri_tile_lists_cuda (torus {name})",
              lambda r=r: pt.tri_tile_lists_cuda(r, *seg_boxes, 32, 2048))
             for name, r in sets.items()]
    calls.append(("render_triangles pallas",
                  lambda: mt.render_triangles(tris, resolution=SIDE, engine="pallas")))
    for label, fn in calls:
        ms = cuda_ms(fn, reps=10)
        print(f"tri_lists part {label}: {ms:.3f} ms (CUDA events, median of 10)", flush=True)
        result[label] = {"ms": ms, **device_busy(f"tri_lists part {label}", fn)}
        if label.startswith("tri_tile_lists"):
            result[label]["kernel_ms"] = kernel_device_ms(fn, "tri_lists_kernel", reps=20)
            print(f"tri_lists part {label}: kernel {result[label]['kernel_ms']} ms "
                  f"(profiler, 20 calls)", flush=True)
    return result



SEGSORT = "segsort.cu"


SORT_TWICE = [swap(SEGSORT, "    warp_bitonic<E>(p, lane);\n",
                   "    warp_bitonic<E>(p, lane);\n    warp_bitonic<E>(p, lane);\n")]


# write_payloads' body between the ragged ends as 4-byte stores
SCALAR_WRITES = """    for (int q = head + lane; q < body; q += 32) {
        const int src = vs[pad(q)];
#pragma unroll
        for (int k = 0; k < kMaxPayloads; ++k) {
            if (k >= a.n_payloads) break;
            const int off = (a.palign[k] + static_cast<int>(s & 3)) & 3;
            a.dst[k][s + q] = buf[a.slot[k] * stage_words(W) + off + src];
        }
    }
"""


def segsort_variants():
    """segsort.cu's variants, (name, edits, compared with the shipped
    kernels' outputs on path 4): the shipped kernels; the next run not
    staged ahead; the payloads written 4 bytes a lane (not 16); the long
    route's grids of two blocks an SM (not eight); the u32 network at E =
    8 for runs of up to 256, and at E = 4, 8 or 16 by length (not 16 for
    every run); every run through the u64 network (the u32 network's
    fallback); the network run twice (its own cost); and leave-outs, timed only: no sort, no payload writes, the
    network's steps across lanes, its steps inside lanes."""
    return [
        ("shipped", None, True),
        ("no staging ahead (each run's copies waited for before its sort)",
         [swap(SEGSORT, "        cp_async_commit();\n        if (len_i > cap) {",
               "        cp_async_commit();\n        cp_async_wait<0>();\n        __syncwarp();\n"
               "        if (len_i > cap) {")], True),
        ("payloads written 4 bytes a lane",
         [swap_between(SEGSORT, "    for (int q = head + 4 * lane; q < body; q += 128) {",
                       "}\n\n// Persistent warps over the runs", SCALAR_WRITES)], True),
        ("the long route's grids of two blocks an SM (not eight)",
         [swap(SEGSORT, "constexpr int kLongBlocksPerSm = 8;", "constexpr int kLongBlocksPerSm = 2;")],
         True),
        ("E = 8 for the runs of up to 256 (two u32 network sizes)",
         [swap(SEGSORT, "        if (narrow) {\n            network_sort<16, unsigned, kKeys>",
               "        if (m <= 256) {\n            network_sort<8, unsigned, kKeys>(m, keep, "
               "shift, lane, ks, vs, lo, bits);\n        } else if (narrow) {\n"
               "            network_sort<16, unsigned, kKeys>")], True),
        ("E = 4, 8 or 16 by the run's length (three u32 network sizes)",
         [swap(SEGSORT, "        if (narrow) {\n            network_sort<16, unsigned, kKeys>",
               "        if (m <= 128) {\n            network_sort<4, unsigned, kKeys>(m, keep, "
               "shift, lane, ks, vs, lo, bits);\n        } else if (m <= 256) {\n"
               "            network_sort<8, unsigned, kKeys>(m, keep, shift, lane, ks, vs, lo, "
               "bits);\n        } else if (narrow) {\n"
               "            network_sort<16, unsigned, kKeys>")], True),
        ("the u64 network for every run (key << 32 | position)",
         [swap(SEGSORT, "    if (hi - lo <= (kPadKey >> bits)) {",
               "    if (false && hi - lo <= (kPadKey >> bits)) {")], True),
        ("the network run twice", SORT_TWICE, True),
        ("leave-out: no sort (every run taken as in order)",
         [swap(SEGSORT, "    if (keys_in_order(m, lane, ks, lo, hi)) {",
               "    if (true || keys_in_order(m, lane, ks, lo, hi)) {")], False),
        ("leave-out: no payload writes",
         [swap(SEGSORT, "            a.dst[k][s + q] = buf[a.slot[k] * stage_words(W) + off + src];",
               "            if (src > 0xffff) a.dst[k][s + q] = buf[a.slot[k] * stage_words(W) + "
               "off + src];"),
          swap(SEGSORT, "            *reinterpret_cast<uint4*>(a.dst[k] + s + q) =\n",
               "            if (s0 > 0xffff) *reinterpret_cast<uint4*>(a.dst[k] + s + q) =\n")],
         False),
        ("leave-out: the network's steps across lanes",
         [swap(SEGSORT, "            v[e] = keep_side(v[e], __shfl_xor_sync(kFull, v[e], J / E), low);\n",
               ""),
          swap(SEGSORT, "            v[e] = keep_side(v[e], a, low);\n"
               "            if (E - 1 - e != e) v[E - 1 - e] = keep_side(v[E - 1 - e], b, low);\n",
               "            (void)a;\n            (void)b;\n")], False),
        ("leave-out: the network's steps inside lanes",
         [swap(SEGSORT, "            if ((e & J) == 0) order_pair(v[e], v[e | J]);\n", ""),
          swap(SEGSORT, "            if ((e & (K / 2)) == 0) order_pair(v[e], v[e ^ (K - 1)]);\n",
               "")], False),
    ]


def path4_records(dev):
    """Main path 4's records on ``dev``: the bench scene's sorted rays
    through the default record trace (512 a ray) and trace_sph's flat
    layout. Returns (rec, flat, total hits, (rays, sorted spheres,
    tree))."""
    from grace_tpu_torch.build.sph import build_sph_tree
    from grace_tpu_torch.rays.gen import orthographic_projection_rays, spatial_sort_rays
    from grace_tpu_torch.trace import pallas_records as prc
    from grace_tpu_torch.trace.sph import trace_sph

    spheres = torch.from_numpy(
        make_clustered_particles(np.random.default_rng(2026), N_PARTICLES)).to(dev)
    ss, tree, _ = build_sph_tree(spheres, MAX_PER_LEAF)
    rays_s, _, _ = spatial_sort_rays(orthographic_projection_rays(
        SIDE, SIDE, CAM, LOOK, UP, VEXT, LENGTH, device=dev))
    rec = prc.pallas_trace_sph_records(rays_s, ss, 512)
    total = int(rec.counts.sum())
    flat = trace_sph(rays_s, ss, tree, capacity=total, engine="pallas", per_ray_capacity=512)
    return rec, flat, total, (rays_s, ss, tree)


def segsort_ablations():
    """E8 (sort_rows_cuda) and E9 (segmented_sort_cuda) on main path 4's
    records with each variant of segsort.cu (segsort_variants) bound in
    the package's place: each compared variant's outputs bit-equal to the
    shipped kernels', all timed in turns (CUDA events, median of 10), with
    each variant's sort kernel resources; and how path 4's runs spread
    over lengths (32, 64, ..., 512 keys), how many are in order already,
    how wide the unsorted rows' keys span (the packed network's premise)
    and how many keys tie."""
    from grace_tpu_torch import _kernels
    from grace_tpu_torch.ops import segops
    from grace_tpu_torch.trace import pallas_records as prc

    dev = torch.device("cuda", 0)
    rec, flat, total, _ = path4_records(dev)
    order = segops.RESOURCE_KERNELS
    fields = _kernels.RESOURCE_FIELDS + ("local_bytes",)
    variants = segsort_variants()
    dlls = build_all({name: ("segsort", f"segsort_{i}", edits)
                      for i, (name, edits, _) in enumerate(variants)})
    # the runs: each row's record prefix, each segment of the flat layout
    valid = rec.indices != prc.INDEX_SENTINEL
    cols = torch.arange(rec.indices.shape[1], device=dev)
    m = torch.where(valid, cols + 1, 0).amax(dim=1)
    seg_len = torch.diff(torch.cat([flat.offsets.long(), torch.tensor([total], device=dev)]))
    for label, lens in (("E8 row prefixes", m), ("E9 segments", seg_len)):
        e = torch.clamp(torch.ceil(torch.log2(torch.clamp((lens + 31) // 32, min=1).double())),
                        min=0).long()
        hist = {f"m <= {32 << k}": int((e == k).sum()) for k in range(6) if int((e == k).sum())}
        print(f"segsort part: {label}: {lens.shape[0]} runs, by length {json.dumps(hist)}, "
              f"longer than 512: {int((lens > 512).sum())}", flush=True)
    key = torch.where(valid, rec.distances, torch.inf)
    in_order = ((torch.diff(key, dim=1) >= 0) | ~valid[:, 1:]).all(dim=1)
    print(f"segsort part: E8 rows whose record prefix is in order: {int(in_order.sum())} of "
          f"{rec.indices.shape[0]}", flush=True)
    # the packed network's premise: each unsorted row's span of order keys
    okey = order_key_torch(key.contiguous())
    lo = torch.where(valid, okey, 1 << 33).amin(dim=1)
    hi = torch.where(valid, okey, -1).amax(dim=1)
    span = torch.where(~in_order & (m > 1), hi - lo, -1)
    bits = torch.where(span >= 0, torch.ceil(torch.log2(span.double() + 1)), -1).long()
    spans = {b: int((bits == b).sum()) for b in torch.unique(bits[bits >= 0]).tolist()}
    ties = ((okey[:, 1:] == okey[:, :-1]) & valid[:, 1:]).sum()
    repeated = torch.sort(torch.where(valid, okey, (1 << 40) + cols), dim=1).values
    repeated = ((repeated[:, 1:] == repeated[:, :-1]) & (repeated[:, 1:] < 1 << 33)).any(dim=1)
    print(f"segsort part: E8's unsorted rows by the bits of their order keys' span "
          f"{json.dumps(spans)}; adjacent records with equal keys {int(ties)}, rows with a "
          f"repeated key {int(repeated.sum())}", flush=True)
    args = (flat.distances, flat.offsets, flat.indices, flat.integrals)
    calls = {"E8 sort_rows (path 4's rows)": lambda: prc.sort_rows_cuda(rec),
             "E9 segmented_sort (path 4's flat layout)": lambda: segops.segmented_sort_cuda(
                 *args, total_hits=flat.total_hits)}
    shipped_lib = _kernels.load("segsort")
    result = {}
    try:
        want = {}
        for name, _, compared in variants:
            _kernels._LIBS["segsort"] = dlls[name]
            out = (ctypes.c_int * len(fields))()
            call(dlls[name].grace_segsort_resources,
                 [ctypes.addressof(out), order.index("sort_rows (512)"), 3])
            print(f"segsort part {name}: sort kernel {json.dumps(dict(zip(fields, out)))}",
                  flush=True)
            for label, fn in calls.items():
                got = fn()
                torch.cuda.synchronize()
                if name == "shipped":
                    want[label] = got
                elif compared:
                    for g, w in zip(got, want[label]):
                        if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                            raise AssertionError(f"segsort part {name} {label}: bits differ")
        times = {(name, label): [] for name, _, _ in variants for label in calls}
        names = [name for name, _, _ in variants]
        for _ in range(5):
            for name in names + names[::-1]:
                _kernels._LIBS["segsort"] = dlls[name]
                for label, fn in calls.items():
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    fn()
                    end.record()
                    torch.cuda.synchronize()
                    times[name, label].append(start.elapsed_time(end))
        for (name, label), x in times.items():
            compared = dict((n, c) for n, _, c in variants)[name]
            ms = statistics.median(x)
            result[f"{label}: {name}"] = ms
            print(f"segsort part {label}: {name}: {ms:.3f} ms (median of {len(x)}; min "
                  f"{min(x):.3f}, max {max(x):.3f}); "
                  + ("bits equal to the shipped" if compared else "not compared"), flush=True)
    finally:
        _kernels._LIBS["segsort"] = shipped_lib
    return result


def record_sort_paths():
    """The ``record_sort`` part in this process, on whichever
    grace_tpu_torch it imports: main path 4's records (the bench scene's
    sorted rays, 512 a ray, the default route) through the package's user
    functions: sort_records_by_distance, records_to_flat, sort_by_distance
    of trace_sph(engine="pallas")'s flat layout with its total_hits, and
    the record trace alone, with the row sort, and trace_sph with the CSR
    sort. {call: {ms, busy_ms, wall_ms, device_ops}}."""
    from grace_tpu_torch.ops.segops import sort_by_distance
    from grace_tpu_torch.trace import pallas_records as prc
    from grace_tpu_torch.trace.sph import trace_sph

    rec, flat, total, (rays_s, ss, tree) = path4_records(torch.device("cuda", 0))
    kept = int(torch.clamp(rec.counts, max=512).sum())
    print(f"record_sort part: {total} entries, {kept} kept records, the last ray's segment "
          f"from {int(flat.offsets[-1])} ({int(rec.counts[-1])} hits)", flush=True)
    csr = lambda f: sort_by_distance(f.distances, f.offsets, f.indices, f.integrals,
                                     total_hits=f.total_hits)
    trace = lambda: prc.pallas_trace_sph_records(rays_s, ss, 512)
    flat_trace = lambda: trace_sph(rays_s, ss, tree, capacity=total, engine="pallas",
                                   per_ray_capacity=512)
    result = {}
    for label, fn in (
            ("sort_records_by_distance (path 4's rows)", lambda: prc.sort_records_by_distance(rec)),
            ("records_to_flat (path 4's rows)", lambda: prc.records_to_flat(rec, total)),
            ("sort_by_distance (trace_sph's flat layout)", lambda: csr(flat)),
            ("record trace", trace),
            ("record trace + sort_records_by_distance",
             lambda: prc.sort_records_by_distance(trace())),
            ("trace_sph(engine=pallas) + sort_by_distance", lambda: csr(flat_trace()))):
        ms = cuda_ms(fn, reps=10)
        print(f"record_sort part {label}: {ms:.3f} ms (CUDA events, median of 10)", flush=True)
        longest = None if label.startswith(("sort_", "records_")) else 6
        result[label] = {"ms": ms, **device_busy(f"record_sort part {label}", fn, longest)}
    return result


# E10's variants (csrc/segsort.cu's records_flat_kernel). Each record a
# 4-byte store by the lane that loaded it, in place of the body's
# realigned 16-byte vectors (the loads stay 16 bytes, all before any store):
FLAT_SCALAR_STORES = """#pragma unroll
            for (int t = 0; t < kFlatVecs; ++t) {
                const int c0 = 4 * (cb / 4 + lane + 32 * t);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    if (c0 + e < n) {
#pragma unroll
                        for (int k = 0; k < 3; ++k) a.dst[k][off + c0 + e] = lane_of(v[k][t], e);
                    }
                }
            }
        }
"""

# The copy taking its offsets from the offsets array (filled before the
# launch) instead of the fused scan and look-back; the tail's total from
# the last row's offset.
FLAT_READS_OFFSETS = [
    swap(SEGSORT, "                const unsigned base = look_back(a.state + 1, t, agg, lane);",
         "                const unsigned base = 0;"),
    swap(SEGSORT, "                const int off = static_cast<int>(s_base + below + incl - stride);",
         "                const int off = a.offsets[r0 + tid];"),
    swap(SEGSORT, """        unsigned long long w = kInclusive;   // no rows: total 0
        if (n_ranges > 0) {
            do {
                w = load_state(a.state + n_ranges);
            } while ((w >> 32) != 2);
        }""", """        unsigned long long w = 0;
        if (n_ranges > 0) {
            w = static_cast<unsigned>(a.offsets[a.n_rows - 1]) +
                static_cast<unsigned>(min(a.counts[a.n_rows - 1], a.width)) + a.slots;
        }"""),
]

# A one-block scan launched before the copy (PR 19's grace_seg_long_scan's
# form, 16 rows a thread a round): the offsets and clamped counts.
FLAT_SCAN_KERNEL = """__global__ void __launch_bounds__(1024) flat_scan_kernel(const __grid_constant__ FlatArgs a) {
    constexpr int kItems = 16;
    __shared__ unsigned s_w[32];
    __shared__ unsigned s_carry;
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    if (tid == 0) s_carry = 0;
    __syncwarp();
    __syncthreads();
    for (long long b = 0; b < a.n_rows; b += 1024LL * kItems) {
        unsigned v[kItems];
        unsigned sum = 0;
#pragma unroll
        for (int i = 0; i < kItems; ++i) {
            const long long r = b + static_cast<long long>(tid) * kItems + i;
            v[i] = r < a.n_rows ? static_cast<unsigned>(min(a.counts[r], a.width)) + a.slots : 0u;
            sum += v[i];
        }
        unsigned incl = sum;
#pragma unroll
        for (int d = 1; d < 32; d *= 2) {
            const unsigned x = __shfl_up_sync(kFull, incl, d);
            if (lane >= d) incl += x;
        }
        if (lane == 31) s_w[warp] = incl;
        __syncwarp();
        __syncthreads();
        unsigned below = 0, all = 0;
        for (int w = 0; w < 32; ++w) {
            all += s_w[w];
            below += w < warp ? s_w[w] : 0u;
        }
        unsigned run = s_carry + below + incl - sum;
#pragma unroll
        for (int i = 0; i < kItems; ++i) {
            const long long r = b + static_cast<long long>(tid) * kItems + i;
            if (r < a.n_rows) {
                a.offsets[r] = static_cast<int>(run);
                a.kept[r] = min(a.counts[r], a.width);
            }
            run += v[i];
        }
        __syncwarp();
        __syncthreads();
        if (tid == 0) s_carry += all;
        __syncwarp();
        __syncthreads();
    }
}

"""
FLAT_TWO_LAUNCHES = FLAT_READS_OFFSETS + [
    swap(SEGSORT, "// E10: rows (idx i32, intg, dist f32 [n_rows, width]) into the flat",
         FLAT_SCAN_KERNEL + "// E10: rows (idx i32, intg, dist f32 [n_rows, width]) into the flat"),
    swap(SEGSORT, "    fn<<<grid, kFlatThreads, 0, s>>>(a);",
         "    if (n_rows > 0) flat_scan_kernel<<<1, 1024, 0, s>>>(a);\n"
         "    fn<<<grid, kFlatThreads, 0, s>>>(a);")]


def flat_const(name, value):
    """An edit of segsort.cu that sets ``constexpr int name`` (E10's) to ``value``."""
    return csrc_const(SEGSORT, name, value)


def flat_variants():
    """E10's variants, (name, edits, rows a block, the wrapper's torch scan
    before the launch, compared with the shipped kernel's outputs): as
    shipped (blocks of 512 threads, 128 rows a block); 4-byte stores in
    place of the realigned vectors; the wrapper's torch scan (clamp, add,
    cumsum, subtract, cast) in place of the fused one; a one-block scan
    launch in front of the copy in place of the look-back; 256 and 64 rows
    a block; blocks of 256 threads (128 and 256 rows: the first form) and
    of 128; two blocks an SM (64 registers at most); chunks of 256 columns
    (two vectors an array a lane); and the leave-outs, timed only: no row
    copies (the scan, the look-back and the tail), no tail."""
    rows = 128
    return [
        ("shipped", None, rows, False, True),
        ("4-byte stores (no realignment)",
         [swap_between(SEGSORT, "#pragma unroll\n            for (int t = 0; t < kFlatVecs; ++t) {\n"
                       "                const int m = cb / 4 + lane + 32 * t;",
                       "    } else {\n        for (int c = lane; c < n; c += 32) {",
                       FLAT_SCALAR_STORES)], rows, False, True),
        ("the wrapper's torch scan (5 operations) before the copy", FLAT_READS_OFFSETS, rows,
         True, True),
        ("a one-block scan launch before the copy (two launches)", FLAT_TWO_LAUNCHES, rows,
         False, True),
        ("256 rows a block", None, 256, False, True),
        ("64 rows a block", None, 64, False, True),
        ("blocks of 256 threads", [flat_const("kFlatThreads", 256)], rows, False, True),
        ("blocks of 256 threads, 256 rows (the first form)", [flat_const("kFlatThreads", 256)],
         256, False, True),
        ("blocks of 128 threads", [flat_const("kFlatThreads", 128)], rows, False, True),
        ("two blocks an SM (64 registers at most)",
         [swap(SEGSORT, "__launch_bounds__(kFlatThreads)\n    records_flat_kernel",
               "__launch_bounds__(kFlatThreads, 2)\n    records_flat_kernel")], rows, False, True),
        ("chunks of 256 columns", [flat_const("kFlatVecs", 2)], rows, False, True),
        ("leave-out: no row copies",
         [swap(SEGSORT, "                copy_row<kVec>(a, r0 + i, s_off[i], s_kept[i], lane);",
               "                (void)i;")], rows, False, False),
        ("leave-out: no tail",
         [swap(SEGSORT, "    if (lo >= hi) return false;", "    return false;")], rows, False,
         False),
    ]


def flat_torch_scan(rec, capacity, rows):
    """records_to_flat_cuda's launch with the offsets computed before it by
    the parent's five torch operations (clamp, add, cumsum, subtract,
    cast), for the variant whose kernel reads them."""
    from grace_tpu_torch import _kernels
    from grace_tpu_torch.trace import pallas_records as prc

    dev = rec.indices.device
    n, c = rec.indices.shape
    counts = torch.clamp(rec.counts, max=c)
    stride = counts + 0
    offsets = (torch.cumsum(stride, dim=0) - stride).to(torch.int32)
    kept = torch.empty_like(offsets)
    bufs = [torch.empty(capacity, dtype=d, device=dev)
            for d in (torch.int32, torch.float32, torch.float32)]
    state = torch.empty(1 + -(-n // rows), dtype=torch.int64, device=dev)
    _kernels.launch("segsort", "grace_records_to_flat", dev, rec.counts.data_ptr(),
                    *[t.data_ptr() for t in rec[1:]], offsets.data_ptr(), kept.data_ptr(),
                    *[t.data_ptr() for t in bufs], state.data_ptr(), n, c, capacity, 0,
                    prc.INDEX_SENTINEL, prc._f32_bits(prc.VALUE_SENTINEL),
                    prc._f32_bits(prc.DISTANCE_SENTINEL), rows)
    return (offsets, kept, *bufs)


def records_flat_ablations():
    """E10 (records_to_flat_cuda) on main path 4's records with each
    variant of segsort.cu (flat_variants) bound in the package's place:
    each compared variant's five outputs bit-equal to the shipped
    kernel's; all timed in turns (shipped, the variants, the variants
    backwards, shipped; 3 times): the call (CUDA events), the E10 kernel's
    device time and the call's device time and operations (torch.profiler,
    over 10 calls); each variant's resources. Returns {variant: {..}}."""
    from grace_tpu_torch import _kernels
    from grace_tpu_torch.ops import segops
    from grace_tpu_torch.trace import pallas_records as prc
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    rec, _, total, _ = path4_records(dev)
    variants = flat_variants()
    dlls = build_all({name: ("segsort", f"records_flat_{i}", edits)
                      for i, (name, edits, _, _, _) in enumerate(variants)})
    fields = _kernels.RESOURCE_FIELDS + ("local_bytes",)
    calls = {name: ((lambda r=rows: flat_torch_scan(rec, total, r)) if torch_scan else
                    (lambda r=rows: prc.records_to_flat_cuda(rec, total, _rows=r)))
             for name, _, rows, torch_scan, _ in variants}

    def profiled(fn, reps=10):
        """(E10 kernel ms, all device ms, device operations) a call."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        kern = sum(e.time_range.elapsed_us() for e in ev if "records_flat_kernel" in e.name)
        return kern / 1e3 / reps, sum(e.time_range.elapsed_us() for e in ev) / 1e3 / reps, (
            len(ev) / reps)

    shipped_lib = _kernels.load("segsort")
    result = {name: {"ms": [], "kernel_ms": [], "device_ms": []} for name in calls}
    try:
        want = None
        for name, _, _, _, compared in variants:
            _kernels._LIBS["segsort"] = dlls[name]
            out = (ctypes.c_int * len(fields))()
            call(dlls[name].grace_segsort_resources,
                 [ctypes.addressof(out), segops.RESOURCE_KERNELS.index("records_to_flat"), 3])
            result[name]["resources"] = dict(zip(fields, out))
            got = calls[name]()
            torch.cuda.synchronize()
            if name == "shipped":
                want = [t.view(torch.int32) if t.dtype == torch.float32 else t for t in got]
            elif compared:
                for g, w in zip(got, want):
                    g = g.view(torch.int32) if g.dtype == torch.float32 else g
                    if not torch.equal(g, w):
                        raise AssertionError(f"records_flat part {name}: bits differ")
            del got
            print(f"records_flat part {name}: resources {json.dumps(result[name]['resources'])}; "
                  + ("bits equal to the shipped" if compared else "not compared"), flush=True)
        names = list(calls)
        for _ in range(3):
            for name in names + names[::-1]:
                _kernels._LIBS["segsort"] = dlls[name]
                result[name]["ms"].append(cuda_ms(calls[name], reps=10))
                kern, busy, ops = profiled(calls[name])
                result[name]["kernel_ms"].append(kern)
                result[name]["device_ms"].append(busy)
                result[name]["device_ops"] = ops
        for name, r in result.items():
            print(f"records_flat part {name}: call " + ", ".join(f"{x:.4f}" for x in r["ms"])
                  + " ms (CUDA events, median of 10 each); E10 kernel "
                  + ", ".join(f"{x:.4f}" for x in r["kernel_ms"]) + " ms; the call's device "
                  + ", ".join(f"{x:.4f}" for x in r["device_ms"])
                  + f" ms over {r['device_ops']:g} operations (profiler, 10 calls each)",
                  flush=True)
    finally:
        _kernels._LIBS["segsort"] = shipped_lib
    return result


def records_flat_paths():
    """The ``records_flat`` part in this process, on whichever
    grace_tpu_torch it imports: main path 4's records through
    records_to_flat and trace_sph(engine="pallas") (+ sort_by_distance),
    each timed (CUDA events, median of 10 after a warm run) with the
    device's busy ms and device operations over one call, and E10's
    kernel device time (torch.profiler over 20 calls); in a package with
    E10's private rows a block (this one), first its variants
    (records_flat_ablations; not with --no-variants)."""
    import inspect

    from grace_tpu_torch.ops.segops import sort_by_distance
    from grace_tpu_torch.trace import pallas_records as prc
    from grace_tpu_torch.trace.sph import trace_sph

    result = {}
    if "_rows" in inspect.signature(prc.records_to_flat_cuda).parameters and not NO_VARIANTS:
        result["variants"] = records_flat_ablations()
    rec, _, total, (rays_s, ss, tree) = path4_records(torch.device("cuda", 0))
    flat_trace = lambda: trace_sph(rays_s, ss, tree, capacity=total, engine="pallas",
                                   per_ray_capacity=512)
    csr = lambda f: sort_by_distance(f.distances, f.offsets, f.indices, f.integrals,
                                     total_hits=f.total_hits)
    for label, fn in (("records_to_flat (path 4's rows)", lambda: prc.records_to_flat(rec, total)),
                      ("trace_sph(engine=pallas)", flat_trace),
                      ("trace_sph(engine=pallas) + sort_by_distance", lambda: csr(flat_trace()))):
        ms = cuda_ms(fn, reps=10)
        print(f"records_flat part {label}: {ms:.3f} ms (CUDA events, median of 10)", flush=True)
        result[label] = {"ms": ms, **device_busy(f"records_flat part {label}", fn,
                                                 None if label.startswith("records_") else 6)}
        if label.startswith("records_"):
            result[label]["kernel_ms"] = kernel_device_ms(fn, "records_flat_kernel", reps=20)
            torch.cuda.synchronize()
            start = time.perf_counter()
            for _ in range(50):
                fn()
            host = (time.perf_counter() - start) / 50 * 1e3
            torch.cuda.synchronize()
            result[label]["host_ms"] = host
            print(f"records_flat part {label}: kernel {result[label]['kernel_ms']} ms "
                  f"(profiler, 20 calls); host {host:.4f} ms a call (50 calls enqueued, "
                  f"perf_counter)", flush=True)
    return result


def f32_pair_sums(d):
    """An and Gn with the pair terms in f32 (dot products by ``matmul_f32``,
    acos, sin) and the sums in f64, the pair (i, i) dropped: the form the
    statistics had before they took the terms in f64."""
    from grace_tpu_torch.ops.vecmath import matmul_f32

    n = d.shape[0]
    rows = max(1, (1 << 26) // n)
    psi_s = sin_s = 0.0
    for b0 in range(0, n, rows):
        dots = torch.clamp(matmul_f32(d[b0:b0 + rows], d.T), -1.0, 1.0)
        k = torch.arange(dots.shape[0], device=d.device)
        dots[k, b0 + k] = 1.0
        psi = dots.acos_()
        psi_s += float(psi.sum(dtype=torch.float64))
        sin_s += float(psi.sin_().sum(dtype=torch.float64))
    coeff = 4.0 / (n * math.pi)
    return n - coeff * psi_s * 0.5, n / 2.0 - coeff * sin_s * 0.5


def f64_as_drawn(d):
    """An and Gn in float64 of the directions as drawn, as ``grace_tpu``
    defines them (acos of the raw dot products), the pair (i, i) dropped."""
    u = d.double()
    n = u.shape[0]
    rows = max(1, (1 << 24) // n)
    psi_s = sin_s = 0.0
    for b0 in range(0, n, rows):
        x = torch.clamp(u[b0:b0 + rows] @ u.T, -1.0, 1.0)
        k = torch.arange(x.shape[0], device=x.device)
        x[k, b0 + k] = 1.0
        psi = torch.acos(x)
        psi_s += float(psi.sum())
        sin_s += float(torch.sin(psi).sum())
    coeff = 4.0 / (n * math.pi)
    return n - coeff * psi_s * 0.5, n / 2.0 - coeff * sin_s * 0.5


def statistics_forms():
    """An and Gn of main path 6's directions (the HEALPix set, nside 128,
    and the first 65,536 isotropic draws) by three forms, timed: the pair
    terms in f32 on the directions as drawn, in f32 on the directions
    normalized in f64, and the shipped ``beran_gine_statistics`` (f64
    terms of the normalized directions); against float64 evaluations of
    the directions normalized (``chip_smoke.f64_an_gn``, the chord form)
    and as drawn (``f64_as_drawn``)."""
    from chip_smoke import SNAPSHOT_SEED, f64_an_gn
    from grace_tpu_torch.rays import gen
    from grace_tpu_torch.rays import statistics as st
    from grace_tpu_torch.rays.healpix import healpix_rays

    dev = torch.device("cuda", 0)
    sets = {
        "HEALPix nside 128": healpix_rays(torch.Generator(dev).manual_seed(SNAPSHOT_SEED + 7),
                                          128, (0.5, 0.5, 0.5), 2.0, device=dev).directions,
        "isotropic 65536": gen.uniform_random_rays(
            torch.Generator(dev).manual_seed(SNAPSHOT_SEED + 2), 262_144, (0.5, 0.5, 0.5), 2.0,
            sort=False, device=dev).directions[:65_536]}
    out = {}
    for name, d in sets.items():
        u = d.double()
        unit32 = (u / torch.linalg.vector_norm(u, dim=1, keepdim=True)).float()

        def shipped():
            bg = st.beran_gine_statistics(d)
            return float(bg["An"]), float(bg["Gn"])

        forms = {"f32 terms": lambda: f32_pair_sums(d),
                 "f32 terms, normalized": lambda: f32_pair_sums(unit32),
                 "f64 terms (shipped)": shipped}
        res = {"n": d.shape[0], "mean |d|^2 - 1": float(((u * u).sum(dim=1) - 1).mean()),
               "float64, normalized": f64_an_gn(d),
               "float64, as drawn": f64_as_drawn(d)}
        for form, fn in forms.items():
            an, gn = fn()
            res[form] = {"An": an, "Gn": gn, "ms": cuda_ms(fn, reps=3)}
        print(f"statistics {name}: {json.dumps(res)}", flush=True)
        out[name] = res
    return out


# The engine's walk (csrc/bvh_walk.cu, E1): the packet walk as shipped and
# with one of its parts taken out, each held bit-equal to the per-ray walk.
# PR 12's kernel (--parent DIR) has the entries without stats and route.
_PAIR_LANES = lambda n: swap("bvh_walk.cu", "constexpr int kPairLanes = 16;",
                             f"constexpr int kPairLanes = {n};")
WALK_VARIANTS = {
    "packet (shipped)": None,
    "no pair tests": [_PAIR_LANES(0)],
    "pair tests up to 8 lanes": [_PAIR_LANES(8)],
    "pair tests up to 24 lanes": [_PAIR_LANES(24)],
    "pair tests at every step": [_PAIR_LANES(32)],
    "no closest pruning": [swap("bvh_walk.cu", "constexpr bool kPrune = true;",
                                "constexpr bool kPrune = false;")],
    "no any-hit exit": [swap("bvh_walk.cu", "constexpr bool kAnyExit = true;",
                             "constexpr bool kAnyExit = false;")],
}
WALK_PARENT_ENTRIES = {"grace_walk_sph": "p" * 16 + "i" * 9, "grace_walk_tri": "p" * 12 + "i" * 7}


def walk_call(dll, kind, mode, rays, prims, tree, route, parent=False):
    """(C entry, arguments, outputs, tensors to keep) of one walk launch
    through ``dll``, as ``trace.walk._launch_sph`` / ``_launch_tri`` pass
    them (the parent's entries take no stats and no route)."""
    from grace_tpu_torch.sph.kernel_integrals import DENSE_KERNEL_INTEGRAL_TABLE
    from grace_tpu_torch.trace import walk as wk

    n, dev = rays.n_rays, prims.device
    base = wk._launch_args(rays, prims, tree)
    flags = torch.empty(n, dtype=torch.int32, device=dev)
    tail = [] if parent else [wk.ROUTES.index(route)]
    if kind == "sph":
        table = torch.as_tensor(DENSE_KERNEL_INTEGRAL_TABLE, dtype=torch.float32, device=dev)
        outs = (torch.empty(n, device=dev, dtype=torch.int32 if mode == "count"
                            else torch.float32),)
        ptrs = [t.data_ptr() for t in base] + [table.data_ptr(), 0, 0, outs[0].data_ptr(), 0, 0,
                                               0, flags.data_ptr()] + ([] if parent else [0])
        ints = [n, prims.shape[0], tree.capacity, tree.leaf_capacity, tree.max_per_leaf, 64,
                table.shape[0], wk.SPH_MODES.index(mode), 0]
        return dll.grace_walk_sph, ptrs + ints + tail, outs, (base, table, flags)
    outs = ((torch.empty(n, device=dev), torch.empty(n, dtype=torch.int32, device=dev))
            if mode == "closest" else (torch.empty(n, dtype=torch.bool, device=dev),))
    ptrs = [t.data_ptr() for t in base] + [o.data_ptr() for o in outs] + [0] * (2 - len(outs)) \
        + [0, flags.data_ptr()] + ([] if parent else [0])
    ints = [n, prims.shape[0], tree.capacity, tree.leaf_capacity, tree.max_per_leaf, 64,
            wk.TRI_MODES.index(mode)]
    return dll.grace_walk_tri, ptrs + ints + tail, outs, (base, flags)


def walk_ray_sets(dev):
    """The walk's ray sets: {name: (kind, modes, rays, prims, tree)}: the
    driver entry's 1,024 random rays (2,048 spheres, 16 a leaf), the bench
    scene's 262,144 sorted orthographic rays and every 64th of them (2^20
    particles, 32 a leaf), path 6's fan-out sets (262,144 isotropic rays,
    direction-sorted, and 196,608 HEALPix rays from the box centre), and
    the torus (262,144 triangles, 8 a leaf): its primary rays (closest) and
    their shadow rays (any), as render_triangles makes them."""
    from grace_tpu_torch.build.sph import build_sph_tree
    from grace_tpu_torch.core.types import Rays
    from grace_tpu_torch.models import triangle as mt
    from grace_tpu_torch.rays import gen
    from grace_tpu_torch.rays.healpix import healpix_rays

    spheres_e, o, d, ln = entry_inputs(dev)
    ss_e, tree_e, _ = build_sph_tree(spheres_e, max_per_leaf=16)
    spheres = torch.from_numpy(
        make_clustered_particles(np.random.default_rng(2026), N_PARTICLES)).to(dev)
    ss, tree, _ = build_sph_tree(spheres, MAX_PER_LEAF)
    rays_s, _, _ = gen.spatial_sort_rays(gen.orthographic_projection_rays(
        SIDE, SIDE, CAM, LOOK, UP, VEXT, LENGTH, device=dev))
    centre = (0.5, 0.5, 0.5)
    iso = gen.uniform_random_rays(torch.Generator(dev).manual_seed(SNAPSHOT_SEED + 2),
                                  SNAPSHOT_SIZES["iso_rays"], centre, 2.0, device=dev)
    hp = healpix_rays(torch.Generator(dev).manual_seed(SNAPSHOT_SEED + 7),
                      SNAPSHOT_SIZES["nside"], centre, 2.0, device=dev)
    tris = torch.from_numpy(torus_mesh(**TORUS)).to(dev)
    sorted_tris, ttree, _ = mt.build_triangle_tree(tris)
    cam, look, length = mt.auto_camera(sorted_tris, SIDE)
    primary = gen.pinhole_camera_rays(SIDE, SIDE, cam.tolist(), look.tolist(), (0.0, 1.0, 0.0),
                                      math.pi / 3, float(length), device=dev)
    closest = mt.trace_closest_hit(primary, sorted_tris, ttree)
    _, _, shadow = mt.shadow_inputs(primary, sorted_tris, closest, (0.3, 1.0, 0.6), length)
    sph = ("cumulative", "count")
    return {
        "entry": ("sph", sph, Rays(o, d, ln), ss_e, tree_e),
        "bench": ("sph", sph, rays_s, ss, tree),
        "bench, every 64th ray": ("sph", sph, rays_s[torch.arange(0, rays_s.n_rays, 64,
                                                                   device=dev)], ss, tree),
        "isotropic (fan-out)": ("sph", sph, iso, ss, tree),
        "HEALPix (fan-out)": ("sph", sph, hp, ss, tree),
        "torus primary": ("tri", ("closest",), primary, sorted_tris, ttree),
        "torus shadow": ("tri", ("any", "closest"), shadow, sorted_tris, ttree),
    }


def walk_conversions(lib):
    """Static counts of the f32 <-> f64 conversions and the f64 operations
    in each kernel of the walk library ``lib`` (cuobjdump -sass): the exact
    fma_f64's cost, which the card runs at 16 conversions an SM a clock."""
    from grace_tpu_torch import _kernels

    cuobjdump = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    for f in sass.split("Function : ")[1:]:
        head = f.splitlines()[0]
        ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", f)
        count = lambda prefix: sum(op.startswith(prefix) for op in ops)
        name = next(k for k in ("packet_sph_kernel", "packet_tri_kernel", "walk_sph_kernel",
                                "walk_tri_kernel") if k in head)
        print(f"walk sass {name}<{head.split('ILi')[1][0]}>: {count('F2F.F64.F32')} "
              f"F2F.F64.F32, {count('F2F.F32.F64')} F2F.F32.F64, {count('DMUL')} DMUL, "
              f"{count('DADD')} DADD, {len(ops)} instructions", flush=True)


def walk_ablations(parent_dir):
    """The packet walk (as shipped and without leaf batches, closest
    pruning or the any-hit exit), the per-ray walk and, with
    ``parent_dir``, PR 12's kernel, on each of ``walk_ray_sets``' sets and
    modes: outputs bit-equal to the per-ray walk's, then timed in turns
    (CUDA events, median of 10); the packet's restarts, steps a warp and
    active lanes a step; and the device's busy share during the shipped
    walk and the per-ray walk. Returns {set mode: {variant: ms}}."""
    from grace_tpu_torch import _kernels
    from grace_tpu_torch.trace import walk as wk

    dev = torch.device("cuda", 0)
    dlls = {v: build_variant("bvh_walk", f"walk-{i}", edits)
            for i, (v, edits) in enumerate(WALK_VARIANTS.items())}
    walk_conversions(os.path.join(_kernels.BUILD_DIR, "ablation", "walk-0", "bvh_walk.so"))
    if parent_dir is not None:
        dlls["parent (PR 12, per-ray)"] = build_variant(
            "bvh_walk", "walk-parent", None, os.path.join(parent_dir, "grace_tpu_torch", "csrc"),
            WALK_PARENT_ENTRIES)
    else:
        print("walk: no --parent DIR, so no parent rows", flush=True)
    result = {}
    for name, (kind, modes, rays, prims, tree) in walk_ray_sets(dev).items():
        for mode in modes:
            label = f"{name} {mode}"
            runs = {}
            for v, dll in dlls.items():
                if (v == "no closest pruning" and mode != "closest") or (
                        v == "no any-hit exit" and mode != "any"):
                    continue
                runs[v] = walk_call(dll, kind, mode, rays, prims, tree, "packet",
                                    parent=v.startswith("parent"))
            runs["per-ray (shipped route 1)"] = walk_call(dlls["packet (shipped)"], kind, mode,
                                                          rays, prims, tree, "per_ray")
            fn, args, want, _ = runs["per-ray (shipped route 1)"]
            call(fn, args)
            torch.cuda.synchronize()
            bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
            for v, (fn, args, outs, _) in runs.items():
                call(fn, args)
                torch.cuda.synchronize()
                if not all(torch.equal(bits(o), bits(w)) for o, w in zip(outs, want)):
                    raise AssertionError(f"walk {label}: {v} differs from the per-ray walk")
            times = {v: [] for v in runs}
            order = list(runs) + list(runs)[::-1]
            for _ in range(5):
                for v in order:
                    fn, args, _, _ = runs[v]
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    call(fn, args)
                    end.record()
                    torch.cuda.synchronize()
                    times[v].append(start.elapsed_time(end))
            result[label] = {v: statistics.median(x) for v, x in times.items()}
            _, _, _, st = walk_outputs(rays, prims, tree, kind, mode, 64, "packet", stats=True)
            restarts, steps, lanes = packet_summary(st)
            print(f"walk {label}: {rays.n_rays} rays; packet {restarts} restarts, {steps:.1f} "
                  f"steps a warp, {lanes:.2f} active lanes a step", flush=True)
            for v, x in times.items():
                print(f"walk {label} {v}: {statistics.median(x):.3f} ms (median of {len(x)}; "
                      f"min {min(x):.3f}, max {max(x):.3f}); bits equal to the per-ray walk",
                      flush=True)
            if name in ("bench", "torus primary", "torus shadow", "isotropic (fan-out)"):
                for v in ("packet (shipped)", "per-ray (shipped route 1)"):
                    fn, args, _, _ = runs[v]
                    result[f"{label} {v} busy"] = device_busy(f"walk {label} {v}",
                                                              lambda: call(fn, args))
    return result


PARTS = ("trace", "render_bwd", "trace_tri", "splat", "records", "sortfree_bwd", "render_fwd",
         "paths", "statistics", "walk", "build", "climbs", "splat_prep", "broadphase",
         "record_sort", "segsort", "feeds", "records_flat", "tri_lists", "morton", "compaction")


def main():
    args = sys.argv[1:]
    if "--package" in args:  # time another checkout's package (the paths and build parts)
        i = args.index("--package")
        sys.path.insert(0, os.path.abspath(args[i + 1]))
        del args[i:i + 2]
    parent = None
    if "--parent" in args:  # the parent's kernels or package (records, ..., walk, splat_prep)
        i = args.index("--parent")
        parent = os.path.abspath(args[i + 1])
        del args[i:i + 2]
    rounds = 1
    if "--rounds" in args:  # rounds of turns (parent, this, this, parent) with --parent
        i = args.index("--rounds")
        rounds = int(args[i + 1])
        del args[i:i + 2]
    global NO_VARIANTS
    if "--no-variants" in args:  # the kernel variants of the splat_prep and broadphase parts
        args.remove("--no-variants")
        NO_VARIANTS = True
    parts = args or list(PARTS)
    if not set(parts) <= set(PARTS):
        raise SystemExit(f"usage: chip_ablation.py [{' | '.join(PARTS)} ...]")
    if not torch.cuda.is_available():
        raise SystemExit("chip_ablation: torch.cuda.is_available() is false")
    from grace_tpu_torch import _kernels
    from grace_tpu_torch.build.sph import build_sph_tree
    from grace_tpu_torch.models import triangle as mt
    from grace_tpu_torch.rays.gen import (orthographic_projection_rays, pinhole_camera_rays,
                                          spatial_sort_rays)

    import grace_tpu_torch

    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    print(f"package {os.path.dirname(grace_tpu_torch.__file__)}", flush=True)
    summary = {}
    if {"trace", "render_bwd", "splat", "records", "sortfree_bwd", "render_fwd",
            "paths"} & set(parts):
        spheres = torch.from_numpy(
            make_clustered_particles(np.random.default_rng(2026), N_PARTICLES)).to(dev)
        sorted_spheres, _, _ = build_sph_tree(spheres, MAX_PER_LEAF)
        rays_s, _, _ = spatial_sort_rays(orthographic_projection_rays(
            SIDE, SIDE, CAM, LOOK, UP, VEXT, LENGTH, device=dev))
    if "trace" in parts:
        summary.update(trace_ablations(sorted_spheres, rays_s))
    if "splat" in parts:
        summary.update(splat_ablations(sorted_spheres, torch.ones(N_PARTICLES, device=dev)))
    if "records" in parts:
        summary.update(record_ablations(sorted_spheres, rays_s, parent))
    if "records" in parts or "record_sort" in parts:
        summary["record_sort"] = (part_turns("record_sort", parent) if parent
                                  else record_sort_paths())
    if "segsort" in parts:
        summary["segsort"] = segsort_ablations()
    if "records_flat" in parts:
        summary["records_flat"] = (part_turns("records_flat", parent, rounds) if parent
                                   else records_flat_paths())
    if "tri_lists" in parts:
        summary["tri_lists"] = (part_turns("tri_lists", parent, rounds) if parent
                                else tri_lists_paths())
    if "sortfree_bwd" in parts:
        summary["splat_sortfree_bwd"] = sortfree_bwd_ablations(
            sorted_spheres, torch.ones(N_PARTICLES, device=dev), parent)
    if "render_fwd" in parts:
        summary["render_fwd"] = render_fwd_ablations(
            sorted_spheres, torch.ones(N_PARTICLES, device=dev), rays_s, parent)
    if "paths" in parts:
        summary["paths"] = user_paths(sorted_spheres, torch.ones(N_PARTICLES, device=dev), rays_s)
    if "render_bwd" in parts:
        g = torch.from_numpy(np.random.default_rng(5).standard_normal(rays_s.n_rays)
                             .astype(np.float32)).to(dev)
        weights = torch.ones(N_PARTICLES, device=dev)
        _, _, bwd_args, ovf = render_inputs(rays_s, sorted_spheres, weights, g, 128, 2048, 2048)
        if bool(ovf.any()):
            raise AssertionError("backward tile lists overflow")
        # the variants on the segments in the wrapper's order, longest list first
        order = _kernels.longest_first(bwd_args[0])
        by_len = tuple(a[order] for a in bwd_args[:3]) + (bwd_args[3],)
        summary["render_bwd"] = ablate("render_bwd", {"bench scene": render_bwd_call(by_len)})
        del by_len
        old, new, hits = branch_passes(bwd_args)
        print(f"hit-branch warp passes: earlier design {old}, this design {new} "
              f"({new / old:.4f} of them); {hits} hits", flush=True)
        summary["render_bwd branch passes"] = {"earlier_design": old, "this_design": new,
                                               "hits": hits}
        summary["render_bwd segment orders"] = render_bwd_orders(bwd_args)
        del bwd_args

    if "statistics" in parts:
        summary["statistics"] = statistics_forms()
    if "build" in parts:
        summary["build"] = part_turns("build", parent) if parent else build_paths()
    if "feeds" in parts:
        summary["feeds"] = part_turns("feeds", parent, rounds) if parent else feed_paths()
    if "climbs" in parts:
        summary["climbs"] = climb_ablations()
    if "splat_prep" in parts:
        summary["splat_prep"] = (part_turns("splat_prep", parent, rounds) if parent
                                 else splat_prep_paths())
    if "broadphase" in parts:
        summary["broadphase"] = (part_turns("broadphase", parent, rounds) if parent
                                 else broadphase_paths())
    if "morton" in parts:
        summary["morton"] = (part_turns("morton", parent, rounds) if parent
                             else keys_paths())
    if "compaction" in parts:
        summary["compaction"] = (part_turns("compaction", parent, rounds) if parent
                                 else compaction_paths())
    if "walk" in parts:
        summary["walk"] = walk_ablations(parent)
    if "trace_tri" in parts:
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
        summary["trace_tri tile orders"] = {m: tri_orders(tri_args, m)
                                            for m in ("closest", "any")}
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
