// Triangle-mesh closest hit / any hit over front-to-back segment lists.
//
// Replaces grace_tpu/trace/pallas_tri.py::_tri_kernel (:192). Each ray tile
// walks its list of 128-triangle segments in list order, CHUNK (<= 8)
// segments at a time: before a chunk, a vote over the tile asks whether any
// ray is still open, i.e. whether its closest hit so far (closest mode) or,
// if it has none, its length (any mode) reaches the chunk's first entry
// distance; the list is sorted by that conservative lower bound, so a
// closed tile can find no closer hit. Every thread runs Moller-Trumbore
// with back-face culling against each segment's triangles in list and lane
// order, keeping the least t and its triangle in registers; a strict
// t < t_min keeps the first triangle at a tie, as grace_tpu's
// smallest-lane, earlier-segment rule does. Entries past the list's end
// inside the last chunk are read as the TPU kernel reads them.
//
// The arithmetic is pallas_tri._mt_candidates' operation for operation,
// with fused multiply-adds written as fmaf where grace_tpu's compiled form
// contracts them (built with --fmad=false, so nvcc adds no others).
//
// What bounds it on this card: the triangle tests, about 55 flops each,
// over the (ray, triangle) pairs of the chunks a tile visits; to reach the
// FP32 rate the SM needs enough warps in flight to hide the latency of the
// test's dependent chain (a true division among it) and of the staging.
// And the serial walk of the longest lists: on the torus a tile visits 4
// chunks on average but up to 38, one after another in one warp, and those
// tiles alone take 4.4 ms (chip_ablation.py); launched last, they ran on
// after the rest had finished. The wrapper (pallas_tri.trace_tri) launches
// the tiles longest list first.
//
// Design: one warp walks one 32-ray tile on its own (a tile of up to 1,024
// rays is a group of warps; a narrower tile leaves lanes idle), several
// tiles a block. A group stages each segment's rows v0, e1, e2 (the first
// 9 rows of its (16 x 128) slab, 4.5 KB contiguous) into a ring of two
// slots with 16-byte cp.async copies, one segment ahead of the one under
// test, so the copy overlaps the 128 tests a lane runs on the other slot.
// It votes with __any_sync (a group: a named barrier's or-reduction) and
// syncs with __syncwarp (a named barrier); no block barrier, so a tile that
// stops early frees its warp's instruction slots at once. At 9 KB a warp,
// four-warp blocks of 36 KB fit six to an SM (with the largest shared
// memory carveout): 24 resident warps. With the longest tiles first, one-
// to four-warp blocks time within 1.5% of each other, eight-warp blocks 9%
// slower, and waiting for each copy instead of running it ahead costs under
// 1% (chip_ablation.py). A lane reads each staged row four triangles at a
// time (one 16-byte broadcast load).
//
// Replaced (the earlier design): one block a tile, one thread a ray, the chunk's
// slabs (36 KB, static) staged by the tile's threads between two
// __syncthreads; six one-warp blocks an SM.

#include <cstdint>

#include "async_copy.cuh"
#include "common.cuh"

namespace {

constexpr int kSeg = 128;
constexpr int kRows = 9;                      // v0, e1, e2
constexpr int kSlotFloats = kRows * kSeg;     // 4.5 KB: rows 0-8 of a slab
constexpr int kSlotCopies = kSlotFloats / 4;  // 16-byte copies a slot
constexpr int kSlots = 2;
constexpr int kBlockWarps = 4;  // warps a block, for tiles of up to 128 rays
constexpr int kMaxChunk = 8;
constexpr float kEps = 1e-7f;
constexpr float kBig = 1e30f;
constexpr int kModeClosest = 0;

// Warps of one tile's group, and tiles a block.
__host__ __device__ inline int group_warps(int tile) { return (tile + 31) / 32; }
__host__ __device__ inline int tiles_per_block(int tile) {
    const int g = group_warps(tile);
    return g >= kBlockWarps ? 1 : kBlockWarps / g;
}

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

struct Ray {
    float ox, oy, oz, dx, dy, dz, len;
};

// This lane's ray against the 128 triangles of one staged slot, in lane
// order, four a step (each row read as one float4).
__device__ __forceinline__ void test_slot(const float* __restrict__ sl, int seg, const Ray& r,
                                          float& t_min, int& best) {
#pragma unroll 2
    for (int l = 0; l < kSeg; l += 4) {
        float4 v[kRows];
#pragma unroll
        for (int row = 0; row < kRows; ++row) {
            v[row] = *reinterpret_cast<const float4*>(sl + row * kSeg + l);
        }
#define GRACE_TRI_TEST(c, k)                                                                   \
    {                                                                                          \
        const float t = mt_candidate(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, r.len, v[0].c,        \
                                     v[1].c, v[2].c, v[3].c, v[4].c, v[5].c, v[6].c, v[7].c,   \
                                     v[8].c);                                                  \
        if (t < t_min) {                                                                       \
            t_min = t;                                                                         \
            best = seg * kSeg + l + k;                                                         \
        }                                                                                      \
    }
        GRACE_TRI_TEST(x, 0)
        GRACE_TRI_TEST(y, 1)
        GRACE_TRI_TEST(z, 2)
        GRACE_TRI_TEST(w, 3)
#undef GRACE_TRI_TEST
    }
}

// kGroups: tiles of more than 32 rays, each a group of warps that syncs and
// votes through named barrier 1 + its index in the block (at most 4 groups
// a block); otherwise a warp a tile, and no named barrier.
template <int kMaxThreads, int kMinBlocks, bool kGroups>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
tri_kernel(const int32_t* __restrict__ n_segs, const int32_t* __restrict__ seg_ids,
           const float* __restrict__ seg_dist, const float* __restrict__ rays,
           const float* __restrict__ tris, float* __restrict__ t_out,
           int32_t* __restrict__ id_out, int n_tiles, int tile, int cap, int mode, int chunk) {
    extern __shared__ float4 s_ring4[];  // [groups][kSlots][kSlotFloats]
    const int group_threads = group_warps(tile) * 32;
    const int group = threadIdx.x / group_threads;
    const int gtid = threadIdx.x - group * group_threads;
    const int tile_id = blockIdx.x * tiles_per_block(tile) + group;
    if (tile_id >= n_tiles) return;  // the whole group, before any barrier
    float* ring = reinterpret_cast<float*>(s_ring4) + group * kSlots * kSlotFloats;

    const bool active = gtid < tile;
    const int64_t ray = static_cast<int64_t>(tile_id) * tile + gtid;
    Ray r{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (active) {
        const float* rr = rays + ray * 16;
        r = Ray{rr[0], rr[1], rr[2], rr[3], rr[4], rr[5], rr[9]};
    }
    const int n = n_segs[tile_id];
    const int32_t* ids = seg_ids + static_cast<int64_t>(tile_id) * cap;
    const float* dist = seg_dist + static_cast<int64_t>(tile_id) * cap;
    // the entries of every chunk that n reaches, the last one whole
    const int total = n > 0 ? (n + chunk - 1) / chunk * chunk : 0;

    // Entry j's rows into slot j % kSlots; every thread of the group copies.
    auto stage = [&](int j) {
        const float* src = tris + static_cast<int64_t>(__ldg(ids + min(j, cap - 1))) * 16 * kSeg;
        float* dst = ring + (j % kSlots) * kSlotFloats;
        for (int c = gtid; c < kSlotCopies; c += group_threads) cp_async16(dst + 4 * c, src + 4 * c);
    };
    auto sync = [&] {
        if (kGroups) {
            named_sync(group, group_threads);
        } else {
            __syncwarp();
        }
    };

    float t_min = kBig;
    int best = -1;
    if (total > 0) stage(0);
    cp_async_commit();
    for (int j = 0; j < total; ++j) {
        if (j % chunk == 0) {
            const float d = __ldg(dist + min(j, cap - 1));
            const bool open = active && (mode == kModeClosest
                                             ? fminf(t_min, r.len) >= d
                                             : (t_min >= kBig ? r.len : -1.0f) > d);
            if (!(kGroups ? named_any(group, group_threads, open)
                          : __any_sync(0xffffffffu, open))) {
                break;
            }
        }
        if (j + 1 < total) stage(j + 1);  // slot (j + 1) % 2 was released below
        cp_async_commit();
        cp_async_wait<1>();  // entry j's copies have landed
        sync();
        if (active) {
            test_slot(ring + (j % kSlots) * kSlotFloats, __ldg(ids + min(j, cap - 1)), r, t_min,
                      best);
        }
        sync();  // slot j % 2 is free for entry j + 2
    }
    cp_async_wait<0>();
    if (active) {
        t_out[ray] = t_min;
        id_out[ray] = mode == kModeClosest ? best : -1;
    }
}

using TriKernel = void (*)(const int32_t*, const int32_t*, const float*, const float*,
                           const float*, float*, int32_t*, int, int, int, int, int);

// The launch shape of a tile width: (kernel, threads a block, dynamic
// shared bytes a block); the kernel's attribute allows those bytes.
cudaError_t launch_shape(int tile, TriKernel& kernel, int& threads, int& shared) {
    threads = tiles_per_block(tile) * group_warps(tile) * 32;
    shared = tiles_per_block(tile) * kSlots * kSlotFloats * static_cast<int>(sizeof(float));
    // 24 warps an SM: four one-warp tiles a block, six blocks; groups of up
    // to eight warps, 256 threads a block, three; a wider tile is one block
    if (group_warps(tile) == 1) {
        kernel = tri_kernel<kBlockWarps * 32, 24 / kBlockWarps, false>;
    } else {
        kernel = threads <= 256 ? tri_kernel<256, 3, true> : tri_kernel<1024, 1, true>;
    }
    // Without the largest carveout the runtime gives four such blocks an SM.
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                           cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
}

}  // namespace

extern "C" int grace_tri(const int32_t* n_segs, const int32_t* seg_ids, const float* seg_dist,
                         const float* rays, const float* tris, float* t_out, int32_t* id_out,
                         int n_tiles, int tile, int cap, int n_tri_segs, int mode, int chunk,
                         int device, void* stream) {
    if (tile < 1 || tile > 1024 || chunk < 1 || chunk > kMaxChunk || cap < 1 ||
        n_tri_segs < 1 || (mode != 0 && mode != 1) || !aligned16(tris)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    TriKernel kernel;
    int threads, shared;
    err = launch_shape(tile, kernel, threads, shared);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_tiles > 0) {
        const int per_block = tiles_per_block(tile);
        kernel<<<(n_tiles + per_block - 1) / per_block, threads, shared,
                 static_cast<cudaStream_t>(stream)>>>(n_segs, seg_ids, seg_dist, rays, tris,
                                                      t_out, id_out, n_tiles, tile, cap, mode,
                                                      chunk);
    }
    return static_cast<int>(cudaGetLastError());
}

// What a launch at this tile width holds: out = registers a thread, shared
// bytes a block (static and dynamic), threads a block, resident blocks and
// warps an SM.
extern "C" int grace_tri_resources(int* out, int tile, int device, void* stream) {
    (void)stream;
    if (tile < 1 || tile > 1024) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    TriKernel kernel;
    int threads, shared, blocks;
    err = launch_shape(tile, kernel, threads, shared);
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, shared);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.sharedSizeBytes) + shared;
    out[2] = threads;
    out[3] = blocks;
    out[4] = blocks * threads / 32;
    return 0;
}
