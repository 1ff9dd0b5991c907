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
// particles, 24 KB) in shared memory, a Kahan sum per ray. The per-tile
// overflow flag against max_chunks comes from the list builder.
//
// Backward: replaces grace_tpu/trace/pallas_render.py::_bwd_kernel.
// Segment-major: one block per 128-particle segment, one thread per
// particle. The block walks its list of ray tiles (128 rays each), stages
// each tile's (8 x 128) slab of origins, directions, lengths and
// cotangents (4 KB) in shared memory, and every thread keeps five register
// sums for its particle:
//     d/dpos += g w F'(q2) / h^4 * 2 b_vec,
//     d/dh   += -g (2 w / h^3) (F'(q2) q2 + F(q2)),
//     d/dw   += g F(q2) / h^2,           q2 = b^2 / h^2,
// F' the exact derivative of the fit. Every (ray, particle) pair is
// visited once, with no atomics; the NaN poison for a list that
// overflowed max_tiles stays in Python.
//
// What bounds both: the pair tests (about 22 flops each); the integral
// (and its derivative) runs only for hits. Built with --fmad=false: the
// fused multiply-adds of the hit test are written as fmaf where compiled
// XLA forms them, so the hit set equals the plain version's.

#include <cstdint>

#include "common.cuh"
#include "poly_fast.cuh"
#include "stage.cuh"

namespace {

constexpr int kSeg = 128;
constexpr int kRayTile = 128;  // rays per backward tile

struct StagedWeighted {
    float x[kStage], y[kStage], z[kStage], w[kStage], inv_h2[kStage], h2[kStage];
};

// Slot i <- particle lane of segment seg of the (n_segs, 8, 128) slabs
// (rows x y z h w 1/h^2 h^2 pad); a segment outside [0, n_segs) stages
// h^2 = 0, which never hits.
__device__ __forceinline__ void stage_weighted(StagedWeighted& s, int i,
                                               const float* __restrict__ prims,
                                               int64_t seg, int lane, int n_segs) {
    const bool ok = seg >= 0 && seg < n_segs;
    const float* p = prims + (ok ? seg : 0) * 8 * kSeg + lane;
    s.x[i] = ok ? __ldg(p) : 0.0f;
    s.y[i] = ok ? __ldg(p + kSeg) : 0.0f;
    s.z[i] = ok ? __ldg(p + 2 * kSeg) : 0.0f;
    s.w[i] = ok ? __ldg(p + 4 * kSeg) : 0.0f;
    s.inv_h2[i] = ok ? __ldg(p + 5 * kSeg) : 0.0f;
    s.h2[i] = ok ? __ldg(p + 6 * kSeg) : 0.0f;
}

__global__ void render_fwd_kernel(const int32_t* __restrict__ counts,
                                  const int32_t* __restrict__ ids,
                                  const float* __restrict__ rays,
                                  const float* __restrict__ prims,
                                  const float* __restrict__ poly,
                                  float* __restrict__ out, int max_len, int n_segs) {
    __shared__ StagedWeighted s;
    __shared__ float s_poly[kPolySize];
    constexpr int kBatch = kStage / kSeg;

    const int tile = blockDim.x;
    const int tid = threadIdx.x;
    const int64_t ray = static_cast<int64_t>(blockIdx.x) * tile + tid;
    load_poly(s_poly, poly);
    const RaySeg r = load_ray(rays, ray);
    const int32_t* row = ids + static_cast<int64_t>(blockIdx.x) * max_len;
    const int n = min(max(counts[blockIdx.x], 0), max_len);

    float acc = 0.0f;
    float comp = 0.0f;  // Kahan compensation
    for (int base = 0; base < n; base += kBatch) {
        const int n_prims = min(kBatch, n - base) * kSeg;
        __syncthreads();  // the previous batch is consumed
        for (int i = tid; i < n_prims; i += tile) {
            stage_weighted(s, i, prims, __ldg(row + base + i / kSeg), i % kSeg, n_segs);
        }
        __syncthreads();
        for (int i = 0; i < n_prims; ++i) {
            float dot, bx, by, bz;
            const float b2 = impact(s.x[i], s.y[i], s.z[i], r.ox, r.oy, r.oz, r.dx, r.dy,
                                    r.dz, dot, bx, by, bz);
            if (b2 < s.h2[i] && dot >= 0.0f && dot < r.len) {
                const float v = (s.w[i] * poly_f(s_poly, b2 * s.inv_h2[i])) * s.inv_h2[i];
                const float y = v - comp;
                const float t = acc + y;
                comp = (t - acc) - y;
                acc = t;
            }
        }
    }
    out[ray] = acc;
}

__global__ void __launch_bounds__(kSeg)
render_bwd_kernel(const int32_t* __restrict__ n_tiles, const int32_t* __restrict__ tile_ids,
                  const float* __restrict__ prims, const float* __restrict__ rays,
                  const float* __restrict__ poly, float* __restrict__ out, int max_tiles,
                  int64_t r_pad) {
    __shared__ float s_r[8][kRayTile];  // ox oy oz dx dy dz len g
    __shared__ float s_poly[kPolySize];

    const int seg = blockIdx.x;
    const int tid = threadIdx.x;
    load_poly(s_poly, poly);
    const float* p = prims + (static_cast<int64_t>(seg) * kSeg + tid) * 8;
    const float px = p[0], py = p[1], pz = p[2], ph = p[3], pw = p[4];
    const float h2 = ph * ph;
    const float inv_h2 = h2 > 0.0f ? 1.0f / fmaxf(h2, 1e-30f) : 0.0f;
    const float inv_h = ph > 0.0f ? 1.0f / fmaxf(ph, 1e-30f) : 0.0f;
    const int n = min(max(n_tiles[seg], 0), max_tiles);
    const int64_t n_ray_tiles = r_pad / kRayTile;

    float ax = 0.0f, ay = 0.0f, az = 0.0f, ah = 0.0f, aw = 0.0f;
    for (int k = 0; k < n; ++k) {
        const int64_t t = tile_ids[static_cast<int64_t>(seg) * max_tiles + k];
        __syncthreads();  // the previous slab is consumed
        const bool ok = t >= 0 && t < n_ray_tiles;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            // an out-of-range tile stages length -1: no ray hits
            s_r[c][tid] = ok ? rays[c * r_pad + t * kRayTile + tid] : (c == 6 ? -1.0f : 0.0f);
        }
        __syncthreads();
        for (int i = 0; i < kRayTile; ++i) {
            float dot, bx, by, bz;
            const float b2 = impact(px, py, pz, s_r[0][i], s_r[1][i], s_r[2][i], s_r[3][i],
                                    s_r[4][i], s_r[5][i], dot, bx, by, bz);
            if (b2 < h2 && dot >= 0.0f && dot < s_r[6][i]) {
                const float g = s_r[7][i];
                const float q2 = b2 * inv_h2;
                const float f = poly_f(s_poly, q2);
                const float fp = poly_df(s_poly, q2);
                const float c_pos = g * ((((2.0f * pw) * fp) * inv_h2) * inv_h2);
                ax += c_pos * bx;
                ay += c_pos * by;
                az += c_pos * bz;
                ah += (g * (((-2.0f * pw) * inv_h2) * inv_h)) * fmaf(fp, q2, f);
                aw += g * (f * inv_h2);
            }
        }
    }
    float* o = out + (static_cast<int64_t>(seg) * kSeg + tid) * 8;
    o[0] = ax;
    o[1] = ay;
    o[2] = az;
    o[3] = ah;
    o[4] = aw;
    o[5] = o[6] = o[7] = 0.0f;
}

}  // namespace

extern "C" int grace_render_fwd(const int32_t* counts, const int32_t* ids, const float* rays,
                                const float* prims, const float* poly, float* out,
                                int n_tiles, int tile, int max_len, int n_segs, int device,
                                void* stream) {
    if (tile < 1 || tile > 1024 || max_len < 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_tiles > 0) {
        render_fwd_kernel<<<n_tiles, tile, 0, static_cast<cudaStream_t>(stream)>>>(
            counts, ids, rays, prims, poly, out, max_len, n_segs);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int grace_render_bwd(const int32_t* n_tiles, const int32_t* tile_ids,
                                const float* prims, const float* rays, const float* poly,
                                float* out, int n_segs, int max_tiles, int r_pad, int device,
                                void* stream) {
    if (max_tiles < 0 || r_pad < 0 || r_pad % kRayTile) {
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
