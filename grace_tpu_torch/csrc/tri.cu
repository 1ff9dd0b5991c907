// Triangle-mesh closest hit / any hit over front-to-back segment lists.
//
// Replaces grace_tpu/trace/pallas_tri.py::_tri_kernel. One block per ray
// tile, one thread per ray (tile <= 1024). The block walks its tile's list
// of 128-triangle segments in list order, CHUNK (<= 8) segments at a time:
// before a chunk, a block-wide vote (__syncthreads_or) asks whether any ray
// is still open, i.e. whether its closest hit so far (closest mode) or, if
// it has none, its length (any mode) reaches the chunk's first entry
// distance; the list is sorted by that conservative lower bound, so a
// closed tile can find no closer hit. The chunk's segments (rows v0, e1,
// e2 of each (16 x 128) slab: 36 KB) are staged in shared memory, and every
// thread runs Moller-Trumbore with back-face culling against them in list
// and lane order, keeping the least t and its triangle in registers; a
// strict t < t_min keeps the first triangle at a tie, as grace_tpu's
// smallest-lane, earlier-segment rule does. Entries past the list's end
// inside the last chunk are read as the TPU kernel reads them.
//
// The arithmetic is pallas_tri._mt_candidates' operation for operation,
// with fused multiply-adds written as fmaf where grace_tpu's compiled form
// contracts them (built with --fmad=false, so nvcc adds no others).
//
// What bounds it: the triangle tests, about 40 flops each, over the
// (ray, triangle) pairs of the chunks a tile visits.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kSeg = 128;
constexpr int kRows = 9;       // v0, e1, e2
constexpr int kMaxChunk = 8;
constexpr float kEps = 1e-7f;
constexpr float kBig = 1e30f;
constexpr int kModeClosest = 0;

// Moller-Trumbore t of ray (o, d, len) against triangle (v0, e1, e2); kBig
// where it misses or the triangle faces away.
__device__ __forceinline__ float mt_candidate(float ox, float oy, float oz, float dx,
                                              float dy, float dz, float len, float v0x,
                                              float v0y, float v0z, float e1x, float e1y,
                                              float e1z, float e2x, float e2y, float e2z) {
    const float px = fmaf(dy, e2z, -(dz * e2y));
    const float py = fmaf(dz, e2x, -(dx * e2z));
    const float pz = fmaf(dx, e2y, -(dy * e2x));
    const float det = fmaf(e1z, pz, fmaf(e1y, py, e1x * px));
    const float inv_det = 1.0f / (fabsf(det) > kEps ? det : kEps);
    const float sx = ox - v0x;
    const float sy = oy - v0y;
    const float sz = oz - v0z;
    const float u = fmaf(sz, pz, fmaf(sx, px, sy * py)) * inv_det;
    const float qx = fmaf(sy, e1z, -(sz * e1y));
    const float qy = fmaf(sz, e1x, -(sx * e1z));
    const float qz = fmaf(sx, e1y, -(sy * e1x));
    const float v = fmaf(dz, qz, fmaf(dx, qx, dy * qy)) * inv_det;
    const float t = fmaf(e2z, qz, fmaf(e2x, qx, e2y * qy)) * inv_det;
    const bool hit = det > kEps && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
                     t > kEps && t < len;
    return hit ? t : kBig;
}

__global__ void tri_kernel(const int32_t* __restrict__ n_segs,
                           const int32_t* __restrict__ seg_ids,
                           const float* __restrict__ seg_dist,
                           const float* __restrict__ rays, const float* __restrict__ tris,
                           float* __restrict__ t_out, int32_t* __restrict__ id_out, int cap,
                           int mode, int chunk) {
    __shared__ float s[kMaxChunk][kRows][kSeg];
    __shared__ int s_seg[kMaxChunk];

    const int tile = blockDim.x;
    const int tid = threadIdx.x;
    const int64_t ray = static_cast<int64_t>(blockIdx.x) * tile + tid;
    const float* rr = rays + ray * 16;
    const float ox = rr[0], oy = rr[1], oz = rr[2];
    const float dx = rr[3], dy = rr[4], dz = rr[5];
    const float len = rr[9];
    const int n = n_segs[blockIdx.x];
    const int32_t* ids = seg_ids + static_cast<int64_t>(blockIdx.x) * cap;
    const float* dist = seg_dist + static_cast<int64_t>(blockIdx.x) * cap;

    float t_min = kBig;
    int best = -1;
    for (int k0 = 0; k0 < n; k0 += chunk) {
        const float d = dist[min(k0, cap - 1)];
        const bool open = mode == kModeClosest ? fminf(t_min, len) >= d
                                               : (t_min >= kBig ? len : -1.0f) > d;
        // A barrier too: the previous chunk's slabs are consumed.
        if (!__syncthreads_or(open)) break;
        for (int u = tid; u < chunk; u += tile) s_seg[u] = ids[min(k0 + u, cap - 1)];
        __syncthreads();
        for (int i = tid; i < chunk * kRows * kSeg; i += tile) {
            const int u = i / (kRows * kSeg);
            const int row_lane = i - u * (kRows * kSeg);
            s[u][row_lane / kSeg][row_lane % kSeg] =
                __ldg(tris + static_cast<int64_t>(s_seg[u]) * 16 * kSeg + row_lane);
        }
        __syncthreads();
        for (int u = 0; u < chunk; ++u) {
            const float(*sl)[kSeg] = s[u];
            for (int l = 0; l < kSeg; ++l) {
                const float t = mt_candidate(ox, oy, oz, dx, dy, dz, len, sl[0][l], sl[1][l],
                                             sl[2][l], sl[3][l], sl[4][l], sl[5][l],
                                             sl[6][l], sl[7][l], sl[8][l]);
                if (t < t_min) {
                    t_min = t;
                    best = s_seg[u] * kSeg + l;
                }
            }
        }
    }
    t_out[ray] = t_min;
    id_out[ray] = mode == kModeClosest ? best : -1;
}

}  // namespace

extern "C" int grace_tri(const int32_t* n_segs, const int32_t* seg_ids, const float* seg_dist,
                         const float* rays, const float* tris, float* t_out, int32_t* id_out,
                         int n_tiles, int tile, int cap, int n_tri_segs, int mode, int chunk,
                         int device, void* stream) {
    if (tile < 1 || tile > 1024 || chunk < 1 || chunk > kMaxChunk ||
        cap < 1 || n_tri_segs < 1 || (mode != 0 && mode != 1)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_tiles > 0) {
        tri_kernel<<<n_tiles, tile, 0, static_cast<cudaStream_t>(stream)>>>(
            n_segs, seg_ids, seg_dist, rays, tris, t_out, id_out, cap, mode, chunk);
    }
    return static_cast<int>(cudaGetLastError());
}
