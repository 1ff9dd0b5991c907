// Fused differentiable SPH render: the weighted column density (forward)
// and its gradient with respect to particle position, h and weight
// (backward).
//
// Forward: replaces grace_tpu/trace/pallas_render.py::_fwd_kernel. Ray r
// gets sum over the particles p of its tile's segment list of
//     w_p F(b_rp^2 / h_p^2) / h_p^2   where b^2 < h^2 and 0 <= r.d < len,
// F the Clenshaw fit of poly_fast.cuh. Layout: as trace_list.cu with
// 128-particle groups: one block per ray tile, one thread per ray, the
// tile's first min(count, max_len) segments staged 8 at a time (1,024
// particles' x, y, z, 1/h^2, h^2 and w, 24 KB) with 16-byte cp.async
// copies, through stage.cuh's walk (staged_batches), a Kahan sum per ray.
// The per-tile overflow flag against max_chunks comes from the list
// builder.
//
// The forward's design (the trace kernels' loop, stage.cuh): a thread
// tests 32 staged particles against its ray into a mask (pass_bits32, the
// same hit test b^2 < h^2 along the ray, rows read as float4), then adds
// w F(b^2 / h^2) / h^2 and the Kahan update for the set bits only, in
// ascending slot order: every ray keeps its hits, their order and its
// Kahan sum, so the output is bit-equal to the integral taken inside the
// pair loop (chip_ablation.py render_fwd holds it so). A tile's walk over
// its list is serial and lists are long-tailed, so the
// wrapper launches the tiles longest list first (``order``): block b
// renders tile order[b] and writes that tile's rays in place.
//
// Backward: replaces grace_tpu/trace/pallas_render.py::_bwd_kernel (:110).
// Segment-major: one block per 128-particle segment, one thread per
// particle. The block walks its list of ray tiles (128 rays each; each
// tile an (8 x 128) slab of origins, directions, lengths and cotangents,
// 4 KB), and every thread keeps five register sums for its particle:
//     d/dpos += g w F'(q2) / h^4 * 2 b_vec,
//     d/dh   += -g (2 w / h^3) (F'(q2) q2 + F(q2)),
//     d/dw   += g F(q2) / h^2,           q2 = b^2 / h^2,
// F' the exact derivative of the fit. Every (ray, particle) pair is
// visited once, with no atomics, and a particle adds its hits in list
// order, then ray order; the NaN poison for a list that overflowed
// max_tiles stays in Python.
//
// What bounds both: the pair tests (about 22 flops each); the integral
// (and its derivative) runs only for hits. Built with --fmad=false: the
// fused multiply-adds of the hit test are written as fmaf where compiled
// XLA forms them, so the hit set equals the plain version's.
//
// The backward's design: the block stages kBwdBatch ray tiles at a time
// into one of two 16 KB buffers with cp.async, the next batch while it
// tests this one, so a barrier pair covers kBwdBatch tiles and the loads
// run ahead. A thread tests a staged tile in two phases: the pair test
// against its 128 rays with no integral in the loop, collecting its hits
// in a 128-bit mask (two 64-bit registers); then the gradient terms for
// the set bits only, in ascending order, with F and F' from one Clenshaw
// evaluation (poly_f_df). A warp thus runs the heavy branch as often as
// its busiest lane hits, not once for every ray that any lane hits. A
// segment's walk over its list is serial, and lists run from 1 to 1,512
// tiles on the bench scene, so the wrapper (pallas_render.render_bwd)
// launches the segments longest list first. Measured on the bench scene
// (chip_ablation.py): one tile per barrier pair instead of four costs 2.5%,
// waiting for each batch's copies instead of loading ahead under 1%, and
// the warp passes through the hit branch fall to 76% of the earlier design's.
// Replaced (the earlier design): one 4 KB tile per barrier pair, staged with
// plain loads, and the hit branch (poly_f, then poly_df) inside the pair
// loop.

#include <cstdint>

#include "async_copy.cuh"
#include "common.cuh"
#include "poly_fast.cuh"
#include "stage.cuh"

namespace {

constexpr int kSeg = 128;
constexpr int kRayTile = 128;  // rays per backward tile
constexpr int kRayRows = 8;    // ox oy oz dx dy dz len g
constexpr int kBwdBatch = 4;   // ray tiles per barrier pair (pallas_render.BWD_BATCH)
// Two 16 KB buffers and the constants a block: six blocks (24 warps) an SM.
constexpr int kBwdMinBlocks = 6;

constexpr int kSegShift = 7;  // log2(kSeg)
// One staging buffer: two of 512 particles (the next batch in flight, in
// the same shared memory) took 5% longer on the bench scene
// (chip_ablation.py render_fwd).
constexpr int kFwdBuffers = 1;
constexpr int kFwdSlots = kStage / kFwdBuffers;  // particles a batch

// kFwdSlots staged particles' rows: the hit test's (x, y, z, 1/h^2, h^2)
// and the weights, back to back.
struct __align__(16) StagedWeighted {
    StagedRows<kFwdSlots> p;
    float w[kFwdSlots];
};
static_assert(sizeof(StagedWeighted) == 6 * kFwdSlots * sizeof(float), "rows are back to back");

// Row r of StagedWeighted <- row fwd_slab_row(r) of a (8, 128) segment slab
// (rows x y z h w 1/h^2 h^2 pad).
__device__ __forceinline__ int fwd_slab_row(int r) { return r < 3 ? r : r < 5 ? r + 2 : 4; }

__global__ void __launch_bounds__(kMaxTile)
render_fwd_kernel(const int32_t* __restrict__ counts, const int32_t* __restrict__ ids,
                  const int32_t* __restrict__ order, const float* __restrict__ rays,
                  const float* __restrict__ prims, const float* __restrict__ poly,
                  float* __restrict__ out, int n_tiles, int max_len, int n_segs) {
    __shared__ StagedWeighted s[kFwdBuffers];
    __shared__ float s_poly[kPolySize];

    const int t = order != nullptr ? order[blockIdx.x] : static_cast<int>(blockIdx.x);
    if (t < 0 || t >= n_tiles) return;
    const int64_t ray = static_cast<int64_t>(t) * blockDim.x + threadIdx.x;
    load_poly(s_poly, poly);
    const RaySeg r = load_ray(rays, ray);
    const int32_t* row = ids + static_cast<int64_t>(t) * max_len;
    const int n = min(max(counts[t], 0), max_len);

    int base = 0;  // list entries staged so far
    // The next (up to kFwdSlots / kSeg) listed segments into buffer b; a
    // segment outside [0, n_segs) stages h^2 = 0, which never hits.
    auto stage_next = [&](int b) {
        const int k = min(kFwdSlots / kSeg, n - base);
        if (k <= 0) return 0;
        const int32_t* batch = row + base;
        stage_rows<kFwdSlots>(
            reinterpret_cast<float*>(&s[b]), 6, k, kSegShift, n_segs,
            [&](int j) { return static_cast<int64_t>(__ldg(batch + j)); },
            [&](int rr, int64_t g) { return prims + (g * 8 + fwd_slab_row(rr)) * kSeg; });
        base += k;
        return k * kSeg;
    };
    float acc = 0.0f;
    float comp = 0.0f;  // Kahan compensation
    auto consume = [&](int b, int m) {
        const StagedWeighted& sb = s[b];
        for (int q = 0; q < m; q += 32) {
            uint32_t bits = pass_bits32<true>(sb.p, q, r);
            while (bits) {
                const int i = q + __ffs(bits) - 1;
                bits &= bits - 1;
                float dot, bx, by, bz;
                const float b2 = impact(sb.p.x[i], sb.p.y[i], sb.p.z[i], r.ox, r.oy, r.oz, r.dx,
                                        r.dy, r.dz, dot, bx, by, bz);
                const float v = (sb.w[i] * poly_f(s_poly, b2 * sb.p.inv_h2[i])) * sb.p.inv_h2[i];
                const float y = v - comp;
                const float tt = acc + y;
                comp = (tt - acc) - y;
                acc = tt;
            }
        }
    };
    staged_batches<kFwdBuffers>(stage_next, consume);
    out[ray] = acc;
}

struct Particle {
    float px, py, pz, pw, h2, inv_h2, inv_h;
};

struct GradSums {
    float x = 0.0f, y = 0.0f, z = 0.0f, h = 0.0f, w = 0.0f;
};

// 1 where the particle meets the ray (o, d, len): b^2 < h^2, 0 <= r.d < len.
__device__ __forceinline__ uint32_t pair_hit(const Particle& p, float ox, float oy, float oz,
                                             float dx, float dy, float dz, float len) {
    float dot, bx, by, bz;
    const float b2 = impact(p.px, p.py, p.pz, ox, oy, oz, dx, dy, dz, dot, bx, by, bz);
    return (b2 < p.h2 && dot >= 0.0f && dot < len) ? 1u : 0u;
}

// Bit q: the particle meets staged ray base + q, q < 32 (rows read four
// rays at a time, one float4 each).
__device__ __forceinline__ uint32_t hit_bits32(const float (*s)[kRayTile], int base,
                                               const Particle& p) {
    uint32_t bits = 0;
#pragma unroll
    for (int q = 0; q < 32; q += 4) {
        float4 r[7];
#pragma unroll
        for (int row = 0; row < 7; ++row) {
            r[row] = *reinterpret_cast<const float4*>(s[row] + base + q);
        }
        bits |= pair_hit(p, r[0].x, r[1].x, r[2].x, r[3].x, r[4].x, r[5].x, r[6].x) << q;
        bits |= pair_hit(p, r[0].y, r[1].y, r[2].y, r[3].y, r[4].y, r[5].y, r[6].y) << (q + 1);
        bits |= pair_hit(p, r[0].z, r[1].z, r[2].z, r[3].z, r[4].z, r[5].z, r[6].z) << (q + 2);
        bits |= pair_hit(p, r[0].w, r[1].w, r[2].w, r[3].w, r[4].w, r[5].w, r[6].w) << (q + 3);
    }
    return bits;
}

// The particle's gradient terms over one staged tile: the pair test of
// all 128 rays into a mask, then the terms of the hits in ascending ray
// order (the order of the earlier kernel's sums).
__device__ __forceinline__ void accumulate_tile(const float (*s)[kRayTile], const Particle& p,
                                                const float* s_poly, GradSums& a) {
    uint64_t lo = 0, hi = 0;  // bit i of hi:lo: ray i hits
#pragma unroll 1
    for (int w = 0; w < kRayTile / 32; ++w) {  // shift each 32-ray word in from the top
        const uint32_t bits = hit_bits32(s, 32 * w, p);
        lo = (lo >> 32) | (hi << 32);
        hi = (hi >> 32) | (static_cast<uint64_t>(bits) << 32);
    }
    while (lo | hi) {
        int i;
        if (lo) {
            i = __ffsll(static_cast<long long>(lo)) - 1;
            lo &= lo - 1;
        } else {
            i = 63 + __ffsll(static_cast<long long>(hi));
            hi &= hi - 1;
        }
        float dot, bx, by, bz;
        const float b2 = impact(p.px, p.py, p.pz, s[0][i], s[1][i], s[2][i], s[3][i], s[4][i],
                                s[5][i], dot, bx, by, bz);
        const float g = s[7][i];
        const float q2 = b2 * p.inv_h2;
        float f, fp;
        poly_f_df(s_poly, q2, f, fp);
        const float c_pos = g * ((((2.0f * p.pw) * fp) * p.inv_h2) * p.inv_h2);
        a.x += c_pos * bx;
        a.y += c_pos * by;
        a.z += c_pos * bz;
        a.h += (g * (((-2.0f * p.pw) * p.inv_h2) * p.inv_h)) * fmaf(fp, q2, f);
        a.w += g * (f * p.inv_h2);
    }
}

__global__ void __launch_bounds__(kSeg, kBwdMinBlocks)
render_bwd_kernel(const int32_t* __restrict__ n_tiles, const int32_t* __restrict__ tile_ids,
                  const float* __restrict__ prims, const float* __restrict__ rays,
                  const float* __restrict__ poly, float* __restrict__ out, int max_tiles,
                  int64_t r_pad) {
    __shared__ __align__(16) float s_r[2][kBwdBatch][kRayRows][kRayTile];
    __shared__ float s_poly[kPolySize];

    const int seg = blockIdx.x;
    const int tid = threadIdx.x;
    load_poly(s_poly, poly);
    const float* pp = prims + (static_cast<int64_t>(seg) * kSeg + tid) * 8;
    const float ph = pp[3];
    const float h2 = ph * ph;
    const Particle p{pp[0], pp[1], pp[2], pp[4], h2,
                     h2 > 0.0f ? 1.0f / fmaxf(h2, 1e-30f) : 0.0f,
                     ph > 0.0f ? 1.0f / fmaxf(ph, 1e-30f) : 0.0f};
    const int n = min(max(n_tiles[seg], 0), max_tiles);
    const int64_t n_ray_tiles = r_pad / kRayTile;
    const int32_t* list = tile_ids + static_cast<int64_t>(seg) * max_tiles;

    // Batch b's tiles into buffer b % 2: 16-byte copies, two a thread a
    // tile; an out-of-range tile stages length -1 (no ray hits).
    auto stage = [&](int b) {
        for (int u = 0; u < kBwdBatch && b * kBwdBatch + u < n; ++u) {
            const int64_t t = __ldg(list + b * kBwdBatch + u);
            float(*dst)[kRayTile] = s_r[b % 2][u];
            if (t >= 0 && t < n_ray_tiles) {
                for (int c = tid; c < kRayRows * kRayTile / 4; c += kSeg) {
                    const int row = c / (kRayTile / 4);
                    const int col = 4 * (c % (kRayTile / 4));
                    cp_async16(&dst[row][col], rays + row * r_pad + t * kRayTile + col);
                }
            } else {
                for (int row = 0; row < kRayRows; ++row) dst[row][tid] = row == 6 ? -1.0f : 0.0f;
            }
        }
    };

    GradSums a;
    const int n_batches = (n + kBwdBatch - 1) / kBwdBatch;
    if (n_batches > 0) stage(0);
    cp_async_commit();
    for (int b = 0; b < n_batches; ++b) {
        if (b + 1 < n_batches) stage(b + 1);  // buffer (b + 1) % 2 was released below
        cp_async_commit();
        cp_async_wait<1>();  // batch b's copies have landed
        __syncthreads();
        const int m = min(kBwdBatch, n - b * kBwdBatch);
        for (int u = 0; u < m; ++u) accumulate_tile(s_r[b % 2][u], p, s_poly, a);
        __syncthreads();  // buffer b % 2 is free for batch b + 2
    }
    float* o = out + (static_cast<int64_t>(seg) * kSeg + tid) * 8;
    o[0] = a.x;
    o[1] = a.y;
    o[2] = a.z;
    o[3] = a.h;
    o[4] = a.w;
    o[5] = o[6] = o[7] = 0.0f;
}

}  // namespace

// order: i32[n_tiles], block b renders tile order[b] (a permutation of
// [0, n_tiles)); null: block b renders tile b. prims 16-byte aligned.
extern "C" int grace_render_fwd(const int32_t* counts, const int32_t* ids, const int32_t* order,
                                const float* rays, const float* prims, const float* poly,
                                float* out, int n_tiles, int tile, int max_len, int n_segs,
                                int device, void* stream) {
    if (tile < 1 || tile > kMaxTile || max_len < 0 || !aligned16(prims)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err == cudaSuccess) err = trace_kernel_setup(render_fwd_kernel, tile, nullptr);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_tiles > 0) {
        render_fwd_kernel<<<n_tiles, tile, 0, static_cast<cudaStream_t>(stream)>>>(
            counts, ids, order, rays, prims, poly, out, n_tiles, max_len, n_segs);
    }
    return static_cast<int>(cudaGetLastError());
}

// What a forward launch of tile threads a block holds (trace_kernel_setup's out).
extern "C" int grace_render_fwd_resources(int* out, int tile, int device, void* stream) {
    (void)stream;
    if (tile < 1 || tile > kMaxTile) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err == cudaSuccess) err = trace_kernel_setup(render_fwd_kernel, tile, out);
    return static_cast<int>(err);
}

extern "C" int grace_render_bwd(const int32_t* n_tiles, const int32_t* tile_ids,
                                const float* prims, const float* rays, const float* poly,
                                float* out, int n_segs, int max_tiles, int r_pad, int device,
                                void* stream) {
    if (max_tiles < 0 || r_pad < 0 || r_pad % kRayTile || !aligned16(rays)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_segs > 0) {
        render_bwd_kernel<<<n_segs, kSeg, 0, static_cast<cudaStream_t>(stream)>>>(
            n_tiles, tile_ids, prims, rays, poly, out, max_tiles, r_pad);
    }
    return static_cast<int>(cudaGetLastError());
}

// What a backward launch holds: out = registers a thread, shared bytes a
// block, threads a block, resident blocks and warps an SM.
extern "C" int grace_render_bwd_resources(int* out, int device, void* stream) {
    (void)stream;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaFuncAttributes attr;
    int blocks;
    err = cudaFuncGetAttributes(&attr, render_bwd_kernel);
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, render_bwd_kernel, kSeg, 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.sharedSizeBytes);
    out[2] = kSeg;
    out[3] = blocks;
    out[4] = blocks * kSeg / 32;
    return 0;
}
