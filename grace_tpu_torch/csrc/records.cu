// Per-hit SPH records in one pass: each ray's (primitive index, line
// integral, distance) rows, over bitmask-culled ray tiles.
//
// Replaces grace_tpu/trace/pallas_records.py::_records_tile_kernel
// (segment words, VMEM-resident slabs, with its drains _records_slab_drain
// and _records_slab_drain_network), ::_records_tile_kernel_stream (the same
// with slabs streamed from HBM) and ::_records_tile_kernel_quarter (quarter
// words). The slabs live in device memory for any scene, so the resident
// and streaming TPU kernels share grace_records_bitmask.
//
// The TPU kernels ranked each slab's hits across lanes and drained them
// rank by rank, because a TPU lane cannot keep a scatter cursor. Here one
// thread is one ray: it tests the staged primitives in ascending order and
// appends each hit at its cursor, while the cursor counts on past the row's
// capacity, so counts stay exact on overflow. Records therefore come out in
// ascending primitive order, as grace_tpu's do.
//
// Layout: one block per ray tile, one thread per ray (tile <= 1024). The
// block walks its mask row in place with block-uniform control flow, as
// trace_quarter.cu and trace_bitmask.cu do, and stages the listed
// primitives and their indices in shared memory (stage.cuh) between pairs
// of barriers. After the walk the block fills the sentinels (-1, 0, -1)
// past each row's count, coalesced along the rows.
//
// What bounds it: on the bench scene the bytes of the rows it writes
// (R x C x 12, 1.6 GB at 512 records a ray) against the pair tests. A
// thread's hit writes go down its own row, so a warp's stores are strided
// by C; the sentinel fill is coalesced.

#include <cstdint>

#include "common.cuh"
#include "stage.cuh"

namespace {

constexpr int kSeg = 128;                 // primitives per segment
constexpr int kBatch = kStage / kSeg;     // segments staged per batch
constexpr int kQuarterPrims = 32;         // primitives per quarter

struct RecordRows {
    int32_t* idx;
    float* intg;
    float* dist;
    int64_t cap;
};

// Append this thread's hits among staged slots [0, n) to its row.
__device__ __forceinline__ void append_staged(const StagedPrims& s, const int* s_idx,
                                              int n, const RaySeg& r,
                                              const float* s_coeffs, int deg,
                                              const RecordRows& out, int64_t row,
                                              int& cursor) {
    for (int i = 0; i < n; ++i) {
        float dot, bx, by, bz;
        const float b2 = impact(s.x[i], s.y[i], s.z[i], r.ox, r.oy, r.oz, r.dx, r.dy,
                                r.dz, dot, bx, by, bz);
        if (b2 < s.h2[i] && dot >= 0.0f && dot < r.len) {
            if (cursor < out.cap) {
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

// Sentinels past each row's count; s_counts holds the tile's counts.
__device__ __forceinline__ void fill_sentinels(const int* s_counts, int64_t first_row,
                                               const RecordRows& out) {
    const int tile = blockDim.x;
    const int64_t n = static_cast<int64_t>(tile) * out.cap;
    for (int64_t e = threadIdx.x; e < n; e += tile) {
        const int64_t rr = e / out.cap;
        const int64_t c = e - rr * out.cap;
        if (c >= s_counts[rr]) {
            const int64_t at = (first_row + rr) * out.cap + c;
            out.idx[at] = -1;
            out.intg[at] = 0.0f;
            out.dist[at] = -1.0f;
        }
    }
}

__device__ __forceinline__ void finish(int* s_counts, int cursor, int32_t* counts,
                                       int64_t ray, const RecordRows& out) {
    counts[ray] = cursor;
    s_counts[threadIdx.x] = cursor;
    __syncthreads();
    fill_sentinels(s_counts, ray - threadIdx.x, out);
}

__global__ void records_quarter_kernel(const int32_t* __restrict__ summary,
                                       const int32_t* __restrict__ words,
                                       const float* __restrict__ rays,
                                       const float* __restrict__ prims,
                                       const float* __restrict__ coeffs,
                                       int32_t* __restrict__ counts, RecordRows out,
                                       int n_swords, int n_words, int n_pad, int deg) {
    __shared__ StagedPrims s;
    __shared__ int s_idx[kStage];
    __shared__ int s_counts[1024];
    __shared__ float s_coeffs[kMaxCoeffs];

    const int tile = blockDim.x;
    const int tid = threadIdx.x;
    const int64_t ray = static_cast<int64_t>(blockIdx.x) * tile + tid;
    load_coeffs(s_coeffs, coeffs, deg);
    const RaySeg r = load_ray(rays, ray);
    const int32_t* srow = summary + static_cast<int64_t>(blockIdx.x) * n_swords;
    const int32_t* wrow = words + static_cast<int64_t>(blockIdx.x) * n_words;

    int cursor = 0;
    for (int sw = 0; sw < n_swords; ++sw) {
        unsigned sbits = static_cast<unsigned>(srow[sw]);
        while (sbits) {
            const int w = sw * 32 + __ffs(sbits) - 1;
            sbits &= sbits - 1;
            if (w >= n_words) break;
            const unsigned word = static_cast<unsigned>(wrow[w]);
            if (word == 0) continue;
            const int n_prims = __popc(word) * kQuarterPrims;
            __syncthreads();  // the previous word's primitives are consumed
            for (int i = tid; i < n_prims; i += tile) {
                unsigned m = word;  // the (i / 32)-th set bit of word
                for (int k = i / kQuarterPrims; k > 0; --k) m &= m - 1;
                const int q = w * 32 + __ffs(m) - 1;
                const int64_t p = static_cast<int64_t>(q) * kQuarterPrims + (i % kQuarterPrims);
                stage_prim(s, i, prims, n_pad, p);
                s_idx[i] = static_cast<int>(p);
            }
            __syncthreads();
            append_staged(s, s_idx, n_prims, r, s_coeffs, deg, out, ray, cursor);
        }
    }
    finish(s_counts, cursor, counts, ray, out);
}

// Word w of a row, with the bits past the last segment cleared.
__device__ __forceinline__ unsigned row_word(const int32_t* __restrict__ row, int w,
                                             int n_words, unsigned last_mask) {
    const unsigned v = static_cast<unsigned>(row[w]);
    return w == n_words - 1 ? v & last_mask : v;
}

__global__ void records_bitmask_kernel(const int32_t* __restrict__ words,
                                       const float* __restrict__ rays,
                                       const float* __restrict__ prims,
                                       const float* __restrict__ coeffs,
                                       int32_t* __restrict__ counts, RecordRows out,
                                       int n_words, int n_segs, int deg) {
    __shared__ StagedPrims s;
    __shared__ int s_idx[kStage];
    __shared__ int s_counts[1024];
    __shared__ float s_coeffs[kMaxCoeffs];

    const int tile = blockDim.x;
    const int tid = threadIdx.x;
    const int64_t ray = static_cast<int64_t>(blockIdx.x) * tile + tid;
    load_coeffs(s_coeffs, coeffs, deg);
    const RaySeg r = load_ray(rays, ray);
    const int32_t* row = words + static_cast<int64_t>(blockIdx.x) * n_words;
    const int64_t n_pad = static_cast<int64_t>(n_segs) * kSeg;
    const unsigned last_mask = (n_segs % 32) ? (1u << (n_segs % 32)) - 1u : ~0u;

    int cursor = 0;
    int w = 0;
    unsigned bits = n_words > 0 ? row_word(row, 0, n_words, last_mask) : 0u;
    while (true) {
        // The next (up to) kBatch set segments, ascending.
        int segs[kBatch];
        int k = 0;
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
            while (bits == 0 && w + 1 < n_words) {
                ++w;
                bits = row_word(row, w, n_words, last_mask);
            }
            segs[j] = 0;
            if (bits != 0) {
                segs[j] = w * 32 + __ffs(bits) - 1;
                bits &= bits - 1;
                k = j + 1;
            }
        }
        if (k == 0) break;
        const int n_prims = k * kSeg;
        __syncthreads();  // the previous batch is consumed
        for (int i = tid; i < n_prims; i += tile) {
            const int j = i / kSeg;
            int seg = segs[0];
#pragma unroll
            for (int jj = 1; jj < kBatch; ++jj) {
                if (j == jj) seg = segs[jj];
            }
            const int64_t p = static_cast<int64_t>(seg) * kSeg + (i % kSeg);
            stage_prim(s, i, prims, n_pad, p);
            s_idx[i] = static_cast<int>(p);
        }
        __syncthreads();
        append_staged(s, s_idx, n_prims, r, s_coeffs, deg, out, ray, cursor);
    }
    finish(s_counts, cursor, counts, ray, out);
}

bool records_launch_ok(int tile, int cap, int deg) {
    return trace_launch_ok(tile, deg) && deg > 0 && cap >= 1;
}

}  // namespace

extern "C" int grace_records_quarter(const int32_t* summary, const int32_t* words,
                                     const float* rays, const float* prims,
                                     const float* coeffs, int32_t* counts, int32_t* idx,
                                     float* intg, float* dist, int n_tiles, int tile,
                                     int n_swords, int n_words, int n_pad, int cap,
                                     int deg, int device, void* stream) {
    if (!records_launch_ok(tile, cap, deg)) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_tiles > 0) {
        records_quarter_kernel<<<n_tiles, tile, 0, static_cast<cudaStream_t>(stream)>>>(
            summary, words, rays, prims, coeffs, counts, RecordRows{idx, intg, dist, cap},
            n_swords, n_words, n_pad, deg);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int grace_records_bitmask(const int32_t* words, const float* rays,
                                     const float* prims, const float* coeffs,
                                     int32_t* counts, int32_t* idx, float* intg,
                                     float* dist, int n_tiles, int tile, int n_words,
                                     int n_segs, int cap, int deg, int device,
                                     void* stream) {
    if (!records_launch_ok(tile, cap, deg) || n_words != (n_segs + 31) / 32) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_tiles > 0) {
        records_bitmask_kernel<<<n_tiles, tile, 0, static_cast<cudaStream_t>(stream)>>>(
            words, rays, prims, coeffs, counts, RecordRows{idx, intg, dist, cap}, n_words,
            n_segs, deg);
    }
    return static_cast<int>(cudaGetLastError());
}
