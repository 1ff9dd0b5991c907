// The dense broadphase on the card: segment and tile boxes, overlap words
// and their compaction into id lists (E6).
//
// Not TPU kernels: grace_tpu runs the dense broadphase as plain XLA in
// front of its Pallas trace kernels. These replace
// grace_tpu/trace/pallas_broadphase.py:43 (segment_aabbs), :59
// (pack_overlap_bits) with :249 (masks_for_tile_aabbs), :138
// (compact_mask_words), grace_tpu/trace/broadphase.py:38 (tile_aabbs) and
// grace_tpu/trace/pallas_render.py:218 (dense_segment_tiles).
// The port ran them as chains of torch ops over dense intermediates: a
// [tiles, seg_block] bool matrix a block of 8,192 segments, packed through a
// [tiles, words, 32] int64 tensor, and a compaction that unpacks every bit.
//
// segment_boxes_kernel: one warp a box of `block` (32 or 128) consecutive
// spheres, a sphere a lane (four for 128): c - r and c + r, padded past n
// to a multiple of 128 with (+F32_MAX, -F32_MAX), reduced over the warp.
//
// tile_boxes_kernel: one warp a tile of `tile` rays: the hull of the
// origins and the endpoints, each endpoint as vecmath.fma computes it (the
// exact f64 product of direction and length plus the origin, rounded to f64
// and then to f32: fma_f64).
//
// The reductions keep torch.amin / amax's and torch.minimum / maximum's
// NaN rule: a NaN operand wins (fminf / fmaxf would drop it, and a NaN box
// must overlap nothing). Which zero of -0 and +0 a tie gives is torch's
// reduction order's (ROADMAP C20); the boxes feed only comparisons, where
// -0 == +0.
//
// overlap_words_kernel: rows x columns of boxes, both (min, max) f32[., 3]:
// bit s of word w of row r is 1 where box r overlaps column box w*32+s
// (min <= max' and min' <= max on every axis, a symmetric test, so one
// kernel serves tiles x segments and segments x tiles). A block of 32
// warps owns 32 consecutive words (one summary word) and kRows rows; lane l
// of warp w holds column (32 (32 b + w) + l)'s box in registers, the rows'
// boxes are staged in shared memory, and each (row, word) is one
// __ballot_sync. Columns past the last give 0 bits. The optional summary
// sets bit w of summary word s where word 32 s + w is nonzero, a shared
// atomicOr a warp and row.
//
// compact_words_kernel: one warp a row of words: 32 words at a time, their
// popcounts' warp prefix sum places each word's set bits, written in
// ascending id (bit b of word w is id 32 w + b) up to max_q; the row is
// zero-padded to max_q, n = min(count, max_q), overflow = count > max_q.
// A warp stops reading once its count passes max_q.
//
// What bounds them: memory. Each sphere, ray, box and word is read once
// and each output written once (the column boxes once for every kRows rows,
// from L2); the overlap tests are a few operations a (row, column) pair.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSeg = 128;              // pallas_broadphase.SEG: boxes pad to it
constexpr float kF32Max = 3.402823466e+38f;
constexpr int kWordWarps = 32;         // words (warps) an overlap block: one summary word
constexpr int kRows = 64;              // rows an overlap block
constexpr unsigned kFull = 0xffffffffu;

int grid(long long n) { return static_cast<int>((n + kThreads - 1) / kThreads); }

// torch.minimum / maximum on the card: a NaN operand wins, else fminf /
// fmaxf.
__device__ __forceinline__ float nan_min(float a, float b) {
    return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

__device__ __forceinline__ float nan_max(float a, float b) {
    return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float warp_nan_min(float v) {
    for (int o = 16; o > 0; o >>= 1) v = nan_min(v, __shfl_xor_sync(kFull, v, o));
    return v;
}

__device__ __forceinline__ float warp_nan_max(float v) {
    for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(kFull, v, o));
    return v;
}

// vecmath.fma: the exact f64 product plus c, rounded to f64, then to f32.
__device__ __forceinline__ float fma_f64(float a, float b, float c) {
    return __double2float_rn(static_cast<double>(a) * static_cast<double>(b) +
                             static_cast<double>(c));
}

__global__ void __launch_bounds__(kThreads)
    segment_boxes_kernel(const float4* __restrict__ spheres, float* __restrict__ seg_min,
                         float* __restrict__ seg_max, int n, int block, int n_boxes) {
    const int box = (blockIdx.x * kThreads + threadIdx.x) / 32, lane = threadIdx.x % 32;
    if (box >= n_boxes) return;
    float lo[3] = {INFINITY, INFINITY, INFINITY}, hi[3] = {-INFINITY, -INFINITY, -INFINITY};
    for (int i = lane; i < block; i += 32) {
        const long long p = static_cast<long long>(box) * block + i;
        // the padding's boxes, (+F32_MAX, -F32_MAX), past n
        float4 s = make_float4(kF32Max, kF32Max, kF32Max, 0.0f);
        if (p < n) s = spheres[p];
        const float c[3] = {s.x, s.y, s.z};
        for (int a = 0; a < 3; ++a) {
            lo[a] = nan_min(lo[a], p < n ? c[a] - s.w : kF32Max);
            hi[a] = nan_max(hi[a], p < n ? c[a] + s.w : -kF32Max);
        }
    }
    for (int a = 0; a < 3; ++a) {
        lo[a] = warp_nan_min(lo[a]);
        hi[a] = warp_nan_max(hi[a]);
    }
    if (lane < 3) {
        seg_min[3LL * box + lane] = lane == 0 ? lo[0] : (lane == 1 ? lo[1] : lo[2]);
        seg_max[3LL * box + lane] = lane == 0 ? hi[0] : (lane == 1 ? hi[1] : hi[2]);
    }
}

__global__ void __launch_bounds__(kThreads)
    tile_boxes_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                      const float* __restrict__ lengths, float* __restrict__ tmin,
                      float* __restrict__ tmax, int n_tiles, int tile) {
    const int t = (blockIdx.x * kThreads + threadIdx.x) / 32, lane = threadIdx.x % 32;
    if (t >= n_tiles) return;
    float lo[3] = {INFINITY, INFINITY, INFINITY}, hi[3] = {-INFINITY, -INFINITY, -INFINITY};
    for (int i = lane; i < tile; i += 32) {
        const long long r = static_cast<long long>(t) * tile + i;
        const float len = lengths[r];
        for (int a = 0; a < 3; ++a) {
            const float o = origins[3 * r + a];
            const float e = fma_f64(dirs[3 * r + a], len, o);
            lo[a] = nan_min(lo[a], nan_min(o, e));
            hi[a] = nan_max(hi[a], nan_max(o, e));
        }
    }
    for (int a = 0; a < 3; ++a) {
        lo[a] = warp_nan_min(lo[a]);
        hi[a] = warp_nan_max(hi[a]);
    }
    if (lane < 3) {
        tmin[3LL * t + lane] = lane == 0 ? lo[0] : (lane == 1 ? lo[1] : lo[2]);
        tmax[3LL * t + lane] = lane == 0 ? hi[0] : (lane == 1 ? hi[1] : hi[2]);
    }
}

__global__ void __launch_bounds__(kWordWarps * 32)
    overlap_words_kernel(const float* __restrict__ row_min, const float* __restrict__ row_max,
                         const float* __restrict__ col_min, const float* __restrict__ col_max,
                         int* __restrict__ words, int* __restrict__ summary, int n_rows,
                         int n_cols) {
    __shared__ float rows[kRows][6];
    __shared__ unsigned sums[kRows];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int n_words = (n_cols + 31) / 32;
    const int w = blockIdx.x * kWordWarps + warp;
    const int r0 = blockIdx.y * kRows;
    const int c = 32 * w + lane;
    float cmin[3], cmax[3];
    const bool have = c < n_cols;
    for (int a = 0; a < 3; ++a) {
        cmin[a] = have ? col_min[3LL * c + a] : 0.0f;
        cmax[a] = have ? col_max[3LL * c + a] : 0.0f;
    }
    for (int i = threadIdx.x; i < kRows * 6; i += kWordWarps * 32) {
        const int r = r0 + i / 6, k = i % 6;
        if (r < n_rows) rows[i / 6][k] = k < 3 ? row_min[3LL * r + k] : row_max[3LL * r + k - 3];
    }
    if (threadIdx.x < kRows) sums[threadIdx.x] = 0u;
    __syncthreads();
    const int n_here = n_rows - r0 < kRows ? n_rows - r0 : kRows;
    if (w < n_words) {
        for (int i = 0; i < n_here; ++i) {
            const float* rb = rows[i];
            const bool bit = have && rb[0] <= cmax[0] && cmin[0] <= rb[3] && rb[1] <= cmax[1] &&
                             cmin[1] <= rb[4] && rb[2] <= cmax[2] && cmin[2] <= rb[5];
            const unsigned word = __ballot_sync(kFull, bit);
            if (lane == 0) {
                words[static_cast<long long>(r0 + i) * n_words + w] = static_cast<int>(word);
                if (summary && word) atomicOr(&sums[i], 1u << warp);
            }
        }
    }
    if (!summary) return;
    __syncthreads();
    const int n_sum = (n_words + 31) / 32;
    if (threadIdx.x < n_here) {
        summary[static_cast<long long>(r0 + threadIdx.x) * n_sum + blockIdx.x] =
            static_cast<int>(sums[threadIdx.x]);
    }
}

__global__ void __launch_bounds__(kThreads)
    compact_words_kernel(const int* __restrict__ words, int* __restrict__ ids,
                         int* __restrict__ n_out, unsigned char* __restrict__ overflow,
                         int n_rows, int n_words, int max_q) {
    const int row = (blockIdx.x * kThreads + threadIdx.x) / 32, lane = threadIdx.x % 32;
    if (row >= n_rows) return;
    const int* src = words + static_cast<long long>(row) * n_words;
    int* dst = ids + static_cast<long long>(row) * max_q;
    int total = 0;
    for (int base = 0; base < n_words && total <= max_q; base += 32) {
        const int w = base + lane;
        unsigned word = w < n_words ? static_cast<unsigned>(src[w]) : 0u;
        const int count = __popc(word);
        int incl = count;
        for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(kFull, incl, o);
            if (lane >= o) incl += v;
        }
        int at = total + incl - count;
        while (word && at < max_q) {
            dst[at++] = 32 * w + __ffs(word) - 1;
            word &= word - 1u;
        }
        total += __shfl_sync(kFull, incl, 31);
    }
    const int n = total < max_q ? total : max_q;
    for (int k = n + lane; k < max_q; k += 32) dst[k] = 0;
    if (lane == 0) {
        n_out[row] = n;
        overflow[row] = total > max_q;
    }
}

}  // namespace

// Boxes (seg_min, seg_max f32[ceil(n / 128) * 128 / block, 3]) of each
// `block` (32 or 128) consecutive spheres f32[n, 4] (16-byte aligned), the
// padding past n empty (+F32_MAX, -F32_MAX).
extern "C" int grace_segment_boxes(const float* spheres, float* seg_min, float* seg_max, int n,
                                   int block, int device, void* stream) {
    if (n < 0 || (block != 32 && block != kSeg) || (n > 0 && !spheres) ||
        reinterpret_cast<uintptr_t>(spheres) % 16) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int n_boxes = (n + kSeg - 1) / kSeg * (kSeg / block);
    if (n_boxes > 0 && (!seg_min || !seg_max)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_boxes == 0) return static_cast<int>(cudaGetLastError());
    segment_boxes_kernel<<<grid(32LL * n_boxes), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(spheres), seg_min, seg_max, n, block, n_boxes);
    return static_cast<int>(cudaGetLastError());
}

// Tile boxes (tmin, tmax f32[n_tiles, 3]) of rays (origins, directions
// f32[n_tiles * tile, 3], lengths f32[n_tiles * tile]): the hull of each
// tile's origins and endpoints.
extern "C" int grace_tile_boxes(const float* origins, const float* dirs, const float* lengths,
                                float* tmin, float* tmax, int n_tiles, int tile, int device,
                                void* stream) {
    if (n_tiles < 0 || tile < 1 ||
        (n_tiles > 0 && (!origins || !dirs || !lengths ||
                         !tmin || !tmax))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_tiles == 0) return static_cast<int>(cudaGetLastError());
    tile_boxes_kernel<<<grid(32LL * n_tiles), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        origins, dirs, lengths, tmin, tmax, n_tiles, tile);
    return static_cast<int>(cudaGetLastError());
}

// Overlap words i32[n_rows, ceil(n_cols / 32)] of row boxes (row_min,
// row_max f32[n_rows, 3]) against column boxes (col_min, col_max f32[n_cols,
// 3]), and where summary is not null its summary words i32[n_rows,
// ceil(ceil(n_cols / 32) / 32)].
extern "C" int grace_overlap_words(const float* row_min, const float* row_max,
                                   const float* col_min, const float* col_max, int* words,
                                   int* summary, int n_rows, int n_cols, int device,
                                   void* stream) {
    if (n_rows < 0 || n_cols < 0 ||
        (n_rows > 0 && (!row_min || !row_max)) ||
        (n_cols > 0 && (!col_min || !col_max)) ||
        (n_rows > 0 && n_cols > 0 && !words)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_words = (n_cols + 31) / 32;
    if (n_rows == 0 || n_words == 0) return static_cast<int>(cudaGetLastError());
    const dim3 blocks((n_words + kWordWarps - 1) / kWordWarps, (n_rows + kRows - 1) / kRows);
    overlap_words_kernel<<<blocks, kWordWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        row_min, row_max, col_min, col_max, words, summary, n_rows, n_cols);
    return static_cast<int>(cudaGetLastError());
}

// Set-bit compaction of words i32[n_rows, n_words]: ids i32[n_rows, max_q]
// (ascending, zero-padded), n i32[n_rows] = min(count, max_q) and the
// overflow bytes (count > max_q).
extern "C" int grace_compact_words(const int* words, int* ids, int* n, unsigned char* overflow,
                                   int n_rows, int n_words, int max_q, int device,
                                   void* stream) {
    if (n_rows < 0 || n_words < 0 || max_q < 0 ||
        (n_rows > 0 && (!n || !overflow || (n_words > 0 && !words) ||
                        (max_q > 0 && !ids)))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_rows == 0) return static_cast<int>(cudaGetLastError());
    compact_words_kernel<<<grid(32LL * n_rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        words, ids, n, overflow, n_rows, n_words, max_q);
    return static_cast<int>(cudaGetLastError());
}
