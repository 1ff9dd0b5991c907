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
// boxes_kernel: both box sets in one launch, the grid's first blocks the
// segment boxes, the rest the tile boxes (either part may be empty; the
// dense callers need both, so one launch replaces the two kernels of
// grace_segment_boxes and grace_tile_boxes, which read the spheres a warp a
// box with loads one loop trip at a time and the rays a warp a tile in
// 4-byte loads, 2,048 warps at tile 128, and reduced each value by a
// five-round NaN-testing shuffle butterfly). Bound by bytes: 2^20 spheres
// are 16.8 MB, 512^2 rays 7.3 MB. So every load is in flight before any
// arithmetic, and a value costs one instruction to reduce:
// - segments: a warp takes a segment of 128 spheres, a lane four 16-byte
//   loads; c - r and c + r (past n the padding's +F32_MAX and -F32_MAX to a
//   multiple of 128); each quarter's box (block 32) or the segment's
//   (block 128, folded in the lane first) reduced over the warp by
//   redux.sync on order-keeping ints (a float's bits with the lower 31
//   flipped where negative), one a value;
// - tiles: a warp a tile; a lane four rays from three float4s of origins
//   and of directions and one of lengths where the tile gives every lane
//   four (tile % 4 == 0, tile >= 128) and the bases are 16-byte aligned,
//   else a ray at a time from 4-byte loads (tile 64: two a lane); each
//   origin and endpoint folded in, the endpoint as vecmath.fma computes it
//   (the exact f64 product of direction and length plus the origin,
//   rounded to f64 and then to f32: fma_f64); redux.sync over the warp.
//   A tile spread over up to 8 warps (a thread a ray, the warps combined
//   in shared memory) measured slower (chip_ablation.py's box variants);
// - a block stages its boxes in shared memory and writes each array as one
//   coalesced run.
// The NaN rule is torch.amin / amax's and torch.minimum / maximum's: a NaN
// operand wins (a NaN box must overlap nothing), by a NaN bit a value that
// one redux.sync of or gathers. Which zero of -0 and +0 a tie gives is free
// (ROADMAP C20: the ints order -0 below +0); the boxes feed only
// comparisons, where -0 == +0.
//
// overlap_words_kernel: rows x columns of boxes, both (min, max) f32[., 3]:
// bit s of word w of row r is 1 where box r overlaps column box w*32+s (min
// <= max' and min' <= max on every axis, a symmetric test, so one kernel
// serves tiles x segments and segments x tiles). On the bench scene 3-7% of
// the words have a column hull that overlaps the row, and a ballot for every
// (row, word) is bound by issuing the ballots. So a block owns one strip of
// 32 aligned words (1,024 columns, one summary word) and up to kMaxRows
// rows: it stages the strip's column boxes in shared memory as they lie in
// device memory (16-byte loads, all in flight at once; NaN past the last
// column; a lane a column reads floats 3 c + a, an odd stride, without bank
// conflicts) and its rows' boxes as two float4 each, and reduces each of the
// 32 words' hulls (a warp a word, a lane a column; lane l of every warp then
// holds word l's hull). The hulls drop NaNs (fminf / fmaxf): a NaN column
// box overlaps nothing, and its neighbours in the word still may; with NaNs
// dropped a hull holds every non-NaN box on each axis, so a row that misses
// the hull misses every column of the word (a word of NaN boxes has a NaN
// hull: no candidate). Rows go round-robin to the warps; for each row a warp
// tests the row once against the 32 hulls (one ballot: the candidate words),
// runs the fine test only on the candidates (lane c tests column 32 j + c,
// one ballot a word, lane j keeps word j), stores the 32 words as one
// coalesced 128-byte row, and writes the summary word as a ballot of the
// final words being nonzero. Candidates bunch in the rows and strips of
// dense regions, and the slowest blocks set the kernel's end, so the blocks
// are small and many: the rows a block are the most (256, 128, 64 or 32)
// that still give four blocks an SM of the H100's 132, and a block takes
// every G-th row of the G groups (rows g, g + G, ...), which spreads the
// rows of one dense region over the strip's blocks.
//
// compact_words_kernel: a warp a row of words, four rows a block (2,048
// rows of the main paths give 512 blocks, about four an SM; 8,192 rows
// 2,048). The ids of the main paths are mostly padding: max_q is 2,048
// where a row holds tens to hundreds of ids, so dense_segment_tiles writes
// 64 MB of zeros beside 0.75 MB of ids, and the earlier kernel (a lane's
// word's ids into its own run of slots) touched up to 32 sectors a store.
// Here a row goes 128 words at a time, a lane four words from one 16-byte
// load (4-byte loads where the rows are no multiple of 4 words), the next
// group's loads issued before this one is compacted; the four words'
// popcounts' warp prefix sum places the group's ids, and slot total + s
// goes to lane s % 32, which finds the lane holding the group's s-th set
// bit by a binary search over the lanes' inclusive counts (five shuffles)
// and its bit by rank, so consecutive lanes store consecutive slots (bit b
// of word w is id 32 w + b, ascending, up to max_q). The padding past n =
// min(count, max_q) is 4-byte stores up to the first 16-byte boundary,
// then streaming 16-byte stores, then the last slots (rows of a max_q that
// is no multiple of 4 start anywhere in a 16-byte line); overflow = count
// > max_q. A warp stops reading once its count passes max_q. Counting a
// row first and writing its padding before its ids, and several rows a
// warp by a grid stride, measured slower (chip_ablation.py).
//
// What bounds them: memory. Each sphere, ray, box and word is read once
// and each output written once (the column boxes once for every block of
// rows, from L2); the overlap tests are a few operations a (row, word) and
// a (row, column) pair of the candidate words.

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSeg = 128;              // pallas_broadphase.SEG: boxes pad to it
constexpr float kF32Max = 3.402823466e+38f;
constexpr int kStripWords = 32;        // words an overlap block: one summary word
constexpr int kStripCols = 32 * kStripWords;
constexpr int kWordWarps = 8;          // warps an overlap block
constexpr int kMaxRows = 256;          // rows an overlap block, at most
constexpr int kMinRows = 32;           // ... and at least
constexpr int kMinBlocks = 528;        // four blocks an SM of the H100's 132
constexpr int kStageVecs = 3 * kStripCols / 4;   // float4s of each of the strip's arrays
constexpr int kStageLoads = (kStageVecs + kWordWarps * 32 - 1) / (kWordWarps * 32);
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBoxWarps = kThreads / 32;   // warps a box block
constexpr int kSegLoads = kSeg / 32;   // 16-byte sphere loads a lane: a warp a segment
constexpr int kStageFloats = 3 * kBoxWarps * kSegLoads;   // a block's boxes, 32 quarters
constexpr int kVecTile = 128;         // tiles from here on: 16-byte ray loads

// vecmath.fma: the exact f64 product plus c, rounded to f64, then to f32.
__device__ __forceinline__ float fma_f64(float a, float b, float c) {
    return __double2float_rn(static_cast<double>(a) * static_cast<double>(b) +
                             static_cast<double>(c));
}

// A float's order as an int: its bits with the lower 31 flipped where the
// sign is set (an involution). -0 orders below +0.
__device__ __forceinline__ int ordered(float x) {
    const int b = __float_as_int(x);
    return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float unordered(int k) {
    return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// A box being folded: the ordered ints of its mins and maxes, and a NaN
// bit a value (bit a: the min of axis a, bit 3 + a: the max).
struct Fold {
    int lo[3], hi[3];
    unsigned nan;
};

__device__ __forceinline__ Fold empty_fold() {
    return {{INT_MAX, INT_MAX, INT_MAX}, {INT_MIN, INT_MIN, INT_MIN}, 0u};
}

// min lo_v and max hi_v into axis a
__device__ __forceinline__ void fold_in(Fold& f, int a, float lo_v, float hi_v) {
    f.lo[a] = min(f.lo[a], ordered(lo_v));
    f.hi[a] = max(f.hi[a], ordered(hi_v));
    f.nan |= (isnan(lo_v) ? 1u << a : 0u) | (isnan(hi_v) ? 8u << a : 0u);
}

// a point (min and max alike) into axis a
__device__ __forceinline__ void fold_point(Fold& f, int a, float v) {
    const int k = ordered(v);
    f.lo[a] = min(f.lo[a], k);
    f.hi[a] = max(f.hi[a], k);
    f.nan |= isnan(v) ? 9u << a : 0u;
}

// The warp's fold: one redux.sync a value, every lane gets it.
__device__ __forceinline__ void warp_fold(Fold& f) {
    for (int a = 0; a < 3; ++a) {
        f.lo[a] = __reduce_min_sync(kFull, f.lo[a]);
        f.hi[a] = __reduce_max_sync(kFull, f.hi[a]);
    }
    f.nan = __reduce_or_sync(kFull, f.nan);
}

// The box as floats: NaN where an input of the value was NaN (torch's
// rule: a NaN operand wins).
__device__ __forceinline__ void store_fold(const Fold& f, float* mins, float* maxs) {
    const float kNaN = __int_as_float(0x7fc00000);
    for (int a = 0; a < 3; ++a) {
        mins[a] = (f.nan >> a) & 1u ? kNaN : unordered(f.lo[a]);
        maxs[a] = (f.nan >> (3 + a)) & 1u ? kNaN : unordered(f.hi[a]);
    }
}

// The block writes m floats of shared `src` to `dst` as one coalesced run
// of 4-byte stores (16-byte stores from the first aligned float on
// measured slower).
__device__ __forceinline__ void write_run(float* dst, const float* src, int m) {
    for (int k = threadIdx.x; k < m; k += kThreads) dst[k] = src[k];
}

struct BoxArgs {
    const float4* spheres;
    const float *origins, *dirs, *lengths;
    float *seg_min, *seg_max, *tmin, *tmax;
    long long n, n_segs, n_boxes, n_tiles;
    int quarters;      // block 32: four boxes a segment
    int seg_blocks;    // the grid's first blocks: the segment part
    int tile;
};

// A warp a segment of kSeg spheres: a lane's kSegLoads 16-byte loads, all
// in flight before any arithmetic; c - r and c + r (past n the padding's
// +F32_MAX and -F32_MAX); each quarter's box (block 32) or the segment's
// folded and reduced over the warp; the block's boxes staged in shared
// memory and written as two runs.
__device__ __forceinline__ void segment_part(const BoxArgs& a, int blk,
                                             float (*stage)[kStageFloats]) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const long long seg = static_cast<long long>(blk) * kBoxWarps + warp;
    if (seg < a.n_segs) {
        float4 s[kSegLoads];
#pragma unroll
        for (int k = 0; k < kSegLoads; ++k) {
            const long long p = kSeg * seg + 32 * k + lane;
            s[k] = p < a.n ? a.spheres[p] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        Fold f = empty_fold();
#pragma unroll
        for (int k = 0; k < kSegLoads; ++k) {
            const bool live = kSeg * seg + 32 * k + lane < a.n;
            const float c[3] = {s[k].x, s[k].y, s[k].z};
            if (a.quarters) f = empty_fold();
            for (int x = 0; x < 3; ++x) {
                fold_in(f, x, live ? c[x] - s[k].w : kF32Max, live ? c[x] + s[k].w : -kF32Max);
            }
            if (a.quarters) {
                warp_fold(f);
                const int box = kSegLoads * warp + k;
                if (lane == 0) store_fold(f, stage[0] + 3 * box, stage[1] + 3 * box);
            }
        }
        if (!a.quarters) {
            warp_fold(f);
            if (lane == 0) store_fold(f, stage[0] + 3 * warp, stage[1] + 3 * warp);
        }
    }
    __syncthreads();
    const long long per_block = a.quarters ? kBoxWarps * kSegLoads : kBoxWarps;
    const long long first = blk * per_block;
    const int count = static_cast<int>(min(per_block, a.n_boxes - first));
    write_run(a.seg_min + 3 * first, stage[0], 3 * count);
    write_run(a.seg_max + 3 * first, stage[1], 3 * count);
}

// A warp a tile: a lane folds its units (kVec: 4 rays from three float4s
// of origins and of directions and one of lengths; else a ray from 4-byte
// loads), each ray's origin and endpoint; the warp's fold by redux.sync;
// the block's tiles staged and written as two runs.
template <bool kVec>
__device__ __forceinline__ void tile_part(const BoxArgs& a, int blk,
                                          float (*stage)[kStageFloats]) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const long long t = static_cast<long long>(blk) * kBoxWarps + warp;
    if (t < a.n_tiles) {
        Fold f = empty_fold();
        const int units = kVec ? a.tile / 4 : a.tile;
        for (int j = lane; j < units; j += 32) {
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
        warp_fold(f);
        if (lane == 0) store_fold(f, stage[0] + 3 * warp, stage[1] + 3 * warp);
    }
    __syncthreads();
    const long long first = static_cast<long long>(blk) * kBoxWarps;
    const int count = static_cast<int>(min(static_cast<long long>(kBoxWarps), a.n_tiles - first));
    write_run(a.tmin + 3 * first, stage[0], 3 * count);
    write_run(a.tmax + 3 * first, stage[1], 3 * count);
}

// Both box sets in one launch: the grid's first seg_blocks blocks the
// segment part, the rest the tile part.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) boxes_kernel(const BoxArgs a) {
    __shared__ float stage[2][kStageFloats];
    if (static_cast<int>(blockIdx.x) < a.seg_blocks) {
        segment_part(a, blockIdx.x, stage);
    } else {
        tile_part<kVec>(a, blockIdx.x - a.seg_blocks, stage);
    }
}

// Row box (lo, hi) against column 32 j + lane of the strip staged in cols.
__device__ __forceinline__ bool column_overlaps(const float (*cols)[3 * kStripCols], int j,
                                                int lane, float4 lo, float4 hi) {
    const float* cmin = cols[0] + 3 * (32 * j + lane);
    const float* cmax = cols[1] + 3 * (32 * j + lane);
    return (lo.x <= cmax[0]) & (cmin[0] <= hi.x) & (lo.y <= cmax[1]) & (cmin[1] <= hi.y) &
           (lo.z <= cmax[2]) & (cmin[2] <= hi.z);
}

__global__ void __launch_bounds__(kWordWarps * 32)
    overlap_words_kernel(const float* __restrict__ row_min, const float* __restrict__ row_max,
                         const float* __restrict__ col_min, const float* __restrict__ col_max,
                         int* __restrict__ words, int* __restrict__ summary, int n_rows,
                         int n_cols) {
    // the strip's column boxes as they lie in device memory, [column][axis]
    // (min, then max): lane c reads floats 3 c + a, an odd stride, so a warp
    // reads 32 columns without bank conflicts
    __shared__ __align__(16) float cols[2][3 * kStripCols];
    __shared__ float4 rows[kMaxRows][2];    // (min, max) of the block's rows
    __shared__ float hull[6][kStripWords];
    const float kNaN = __int_as_float(0x7fc00000);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int n_words = (n_cols + 31) / 32, n_sum = (n_words + 31) / 32;
    const int strip = blockIdx.x;
    const int c0 = strip * kStripCols, w0 = strip * kStripWords;
    // rows g, g + G, g + 2 G, ... of G row groups: the spatially sorted rows
    // whose words have the most candidates lie together, and interleaved
    // they spread over the strip's blocks
    const int g = blockIdx.y, n_groups = gridDim.y;
    const int n_here = (n_rows - g + n_groups - 1) / n_groups;
    const int strip_cols = n_cols - c0 < kStripCols ? n_cols - c0 : kStripCols;
    const int strip_words = n_words - w0 < kStripWords ? n_words - w0 : kStripWords;
    // every load of the strip in flight at once: kStageLoads float4s of
    // each array a thread, NaN past the last column
    const int n_floats = 3 * strip_cols;
    float4 v[2][kStageLoads];
    for (int b = 0; b < 2; ++b) {
        const float* src = (b ? col_max : col_min) + 3LL * c0;
        for (int k = 0; k < kStageLoads; ++k) {
            const int e = 4 * (threadIdx.x + k * kWordWarps * 32);
            if (e >= 4 * kStageVecs) break;
            if (e + 3 < n_floats) {
                v[b][k] = reinterpret_cast<const float4*>(src)[e / 4];
            } else {
                v[b][k] = make_float4(e < n_floats ? src[e] : kNaN,
                                      e + 1 < n_floats ? src[e + 1] : kNaN,
                                      e + 2 < n_floats ? src[e + 2] : kNaN, kNaN);
            }
        }
    }
    for (int b = 0; b < 2; ++b) {
        for (int k = 0; k < kStageLoads; ++k) {
            const int q = threadIdx.x + k * kWordWarps * 32;
            if (q < kStageVecs) reinterpret_cast<float4*>(cols[b])[q] = v[b][k];
        }
    }
    for (int i = threadIdx.x; i < 2 * n_here; i += kWordWarps * 32) {
        const float* b = (i % 2 ? row_max : row_min) + 3LL * (g + (i / 2) * n_groups);
        rows[i / 2][i % 2] = make_float4(b[0], b[1], b[2], 0.0f);
    }
    __syncthreads();
    for (int j = warp; j < kStripWords; j += kWordWarps) {
        float h[6];
        for (int a = 0; a < 6; ++a) h[a] = cols[a / 3][3 * (32 * j + lane) + a % 3];
        for (int o = 16; o > 0; o >>= 1) {
            for (int a = 0; a < 3; ++a) h[a] = fminf(h[a], __shfl_xor_sync(kFull, h[a], o));
            for (int a = 3; a < 6; ++a) h[a] = fmaxf(h[a], __shfl_xor_sync(kFull, h[a], o));
        }
        if (lane == 0) {
            for (int a = 0; a < 6; ++a) hull[a][j] = h[a];
        }
    }
    __syncthreads();
    float h[6];
    for (int a = 0; a < 6; ++a) h[a] = hull[a][lane];
    const bool word_here = lane < strip_words;
    for (int i = warp; i < n_here; i += kWordWarps) {
        const float4 lo = rows[i][0], hi = rows[i][1];
        unsigned cand = __ballot_sync(kFull, word_here & (lo.x <= h[3]) & (h[0] <= hi.x) &
                                                 (lo.y <= h[4]) & (h[1] <= hi.y) &
                                                 (lo.z <= h[5]) & (h[2] <= hi.z));
        unsigned mine = 0u;
        while (cand) {
            const int j = __ffs(cand) - 1;
            cand &= cand - 1u;
            const unsigned word = __ballot_sync(kFull, column_overlaps(cols, j, lane, lo, hi));
            if (lane == j) mine = word;
        }
        const long long row = g + static_cast<long long>(i) * n_groups;
        if (word_here) words[row * n_words + w0 + lane] = static_cast<int>(mine);
        if (summary) {
            const unsigned nonzero = __ballot_sync(kFull, mine != 0u);
            if (lane == 0) summary[row * n_sum + strip] = static_cast<int>(nonzero);
        }
    }
}

// Rows an overlap block: the most of kMaxRows, halved down to kMinRows,
// that still give kMinBlocks blocks.
int overlap_block_rows(int n_rows, int n_strips) {
    int rows = kMaxRows;
    while (rows > kMinRows &&
           static_cast<long long>(n_strips) * ((n_rows + rows - 1) / rows) < kMinBlocks) {
        rows /= 2;
    }
    return rows;
}

// A group of 128 words of a row, lane l's words 4 l .. 4 l + 3 (0 past
// n_words): one 16-byte load a lane where the row's words are 16-byte
// aligned, else four 4-byte loads.
template <bool kVec>
__device__ __forceinline__ uint4 load_group(const int* src, int base, int n_words, int lane) {
    const int w = base + 4 * lane;
    if constexpr (kVec) {
        if (w >= n_words) return make_uint4(0u, 0u, 0u, 0u);
        const int4 v = __ldg(reinterpret_cast<const int4*>(src + w));
        return make_uint4(v.x, v.y, v.z, v.w);
    } else {
        uint4 v;
        v.x = w < n_words ? __ldg(src + w) : 0u;
        v.y = w + 1 < n_words ? __ldg(src + w + 1) : 0u;
        v.z = w + 2 < n_words ? __ldg(src + w + 2) : 0u;
        v.w = w + 3 < n_words ? __ldg(src + w + 3) : 0u;
        return v;
    }
}

// The position of the r-th set bit (r from 0) of a word with more than r:
// the largest p with fewer than r + 1 set bits below it.
__device__ __forceinline__ int nth_bit(unsigned word, int r) {
    int p = 0;
    for (int step = 16; step; step >>= 1) {
        if (__popc(word & ((1u << (p + step)) - 1u)) <= r) p += step;
    }
    return p;
}

// Slots n .. max_q - 1 of a row set to 0: 4-byte stores up to the first
// 16-byte boundary, 16-byte stores, then the last 0-3 slots. The lists'
// readers stop at n, so the 16-byte stores are streaming (evict first).
__device__ __forceinline__ void pad_row(int* dst, int n, int max_q, int lane) {
    const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(dst + n) >> 2) & 3);
    const int head = min(n + ((4 - mis) & 3), max_q);
    if (lane < head - n) dst[n + lane] = 0;
    const int body = (max_q - head) / 4;
    for (int k = lane; k < body; k += 32)
        __stcs(reinterpret_cast<int4*>(dst + head) + k, make_int4(0, 0, 0, 0));
    const int tail = head + 4 * body;
    if (lane < max_q - tail) dst[tail + lane] = 0;
}

// groups of 128 words loaded ahead of the one being compacted (0 or 1)
constexpr int kAhead = 1;
constexpr int kCompactWarps = 4;   // rows a block: a warp a row
// One row: its ids into dst (ascending, the first max_q), the padding past
// n = min(count, max_q), n and the overflow byte (count > max_q).
template <bool kVec>
__device__ __forceinline__ void compact_row(const int* src, int* dst, int* n_out,
                                            unsigned char* overflow, int n_words, int max_q,
                                            int lane) {
    int total = 0;
    uint4 cur = load_group<kVec>(src, 0, n_words, lane);
    for (int base = 0; base < n_words && total <= max_q; base += 128) {
        uint4 next = make_uint4(0u, 0u, 0u, 0u);
        if (kAhead) next = load_group<kVec>(src, base + 128, n_words, lane);
        const int count = __popc(cur.x) + __popc(cur.y) + __popc(cur.z) + __popc(cur.w);
        int incl = count;
        for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(kFull, incl, o);
            if (lane >= o) incl += v;
        }
        const int group = __shfl_sync(kFull, incl, 31);
        const int excl = incl - count;
        const int take = min(group, max_q - total);
        // slot total + s goes to lane s % 32: the lane L that holds the
        // group's s-th set bit is the number of lanes whose inclusive count
        // is at most s; its bit is the (s - excl[L])-th of its four words
        for (int s0 = 0; s0 < take; s0 += 32) {
            const int s = s0 + lane;
            int at = 0;
            for (int step = 16; step; step >>= 1) {
                if (__shfl_sync(kFull, incl, at + step - 1) <= s) at += step;
            }
            int r = s - __shfl_sync(kFull, excl, at);
            const unsigned w4[4] = {__shfl_sync(kFull, cur.x, at), __shfl_sync(kFull, cur.y, at),
                                    __shfl_sync(kFull, cur.z, at), __shfl_sync(kFull, cur.w, at)};
            if (s < take) {
                unsigned w = w4[0];
                int j = 0;
#pragma unroll
                for (int q = 1; q < 4; ++q) {
                    const int c = __popc(w);
                    if (r >= c) {
                        r -= c;
                        w = w4[q];
                        j = q;
                    }
                }
                dst[total + s] = 32 * (base + 4 * at + j) + nth_bit(w, r);
            }
        }
        total += group;
        cur = kAhead ? next : load_group<kVec>(src, base + 128, n_words, lane);
    }
    const int n = min(total, max_q);
    pad_row(dst, n, max_q, lane);
    if (lane == 0) {
        *n_out = n;
        *overflow = total > max_q;
    }
}

template <bool kVec>
__global__ void __launch_bounds__(kCompactWarps * 32)
    compact_words_kernel(const int* __restrict__ words, int* __restrict__ ids,
                         int* __restrict__ n_out, unsigned char* __restrict__ overflow,
                         int n_rows, int n_words, int max_q) {
    const int row = blockIdx.x * kCompactWarps + threadIdx.x / 32;
    if (row >= n_rows) return;
    compact_row<kVec>(words + static_cast<long long>(row) * n_words,
                      ids + static_cast<long long>(row) * max_q, n_out + row, overflow + row,
                      n_words, max_q, threadIdx.x % 32);
}

}  // namespace

// Both box sets in one launch. The segment boxes (seg_min, seg_max
// f32[ceil(n / 128) * 128 / block, 3]) of each `block` (32 or 128)
// consecutive spheres f32[n, 4] (16-byte aligned), the padding past n empty
// (+F32_MAX, -F32_MAX); the tile boxes (tmin, tmax f32[n_tiles, 3]) of rays
// (origins, directions f32[n_tiles * tile, 3], lengths f32[n_tiles *
// tile]): the hull of each tile's origins and endpoints, read as 16-byte
// vectors where tile % 4 == 0 and the three bases are 16-byte aligned.
// Either part may be empty (n = 0, n_tiles = 0).
extern "C" int grace_broadphase_boxes(const float* spheres, const float* origins,
                                      const float* dirs, const float* lengths, float* seg_min,
                                      float* seg_max, float* tmin, float* tmax, int n, int block,
                                      int n_tiles, int tile, int device, void* stream) {
    if (n < 0 || n_tiles < 0 || tile < 1 || (block != 32 && block != kSeg) ||
        (n > 0 && (!spheres || reinterpret_cast<uintptr_t>(spheres) % 16 || !seg_min ||
                   !seg_max)) ||
        (n_tiles > 0 && (!origins || !dirs || !lengths || !tmin || !tmax))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    BoxArgs a = {reinterpret_cast<const float4*>(spheres), origins, dirs, lengths, seg_min,
                 seg_max, tmin, tmax};
    a.n = n;
    a.n_segs = (n + kSeg - 1) / kSeg;
    a.n_boxes = a.n_segs * (kSeg / block);
    a.n_tiles = n_tiles;
    a.quarters = block == 32;
    a.seg_blocks = static_cast<int>((a.n_segs + kBoxWarps - 1) / kBoxWarps);
    a.tile = tile;
    // 16-byte rays where every lane gets four rays: a tile of 64 gives
    // half the lanes four each, and a lane two rays from 4-byte loads
    // takes less time
    const bool vec = tile % 4 == 0 && tile >= kVecTile &&
                     reinterpret_cast<uintptr_t>(origins) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(dirs) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(lengths) % 16 == 0;
    const long long blocks = a.seg_blocks + (a.n_tiles + kBoxWarps - 1) / kBoxWarps;
    if (blocks == 0) return static_cast<int>(cudaGetLastError());
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    void (*kernel)(const BoxArgs) = vec ? boxes_kernel<true> : boxes_kernel<false>;
    kernel<<<static_cast<int>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}

// What one launch of boxes_kernel holds (out i32[6], as
// grace_overlap_words_resources), on the 16-byte route where vec != 0.
extern "C" int grace_broadphase_boxes_resources(int* out, int vec, int device, void* stream) {
    (void)stream;
    if (!out) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    void (*kernel)(const BoxArgs) = vec ? boxes_kernel<true> : boxes_kernel<false>;
    cudaFuncAttributes attr;
    int blocks = 0;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.sharedSizeBytes);
    out[2] = kThreads;
    out[3] = blocks;
    out[4] = blocks * kBoxWarps;
    out[5] = static_cast<int>(attr.localSizeBytes);
    return 0;
}

// Overlap words i32[n_rows, ceil(n_cols / 32)] of row boxes (row_min,
// row_max f32[n_rows, 3]) against column boxes (col_min, col_max f32[n_cols,
// 3], 16-byte aligned), and where summary is not null its summary words
// i32[n_rows, ceil(ceil(n_cols / 32) / 32)].
extern "C" int grace_overlap_words(const float* row_min, const float* row_max,
                                   const float* col_min, const float* col_max, int* words,
                                   int* summary, int n_rows, int n_cols, int device,
                                   void* stream) {
    if (n_rows < 0 || n_cols < 0 ||
        (n_rows > 0 && (!row_min || !row_max)) ||
        (n_cols > 0 && (!col_min || !col_max)) ||
        (n_rows > 0 && n_cols > 0 && !words) ||
        reinterpret_cast<uintptr_t>(col_min) % 16 || reinterpret_cast<uintptr_t>(col_max) % 16) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_words = (n_cols + 31) / 32;
    if (n_rows == 0 || n_words == 0) return static_cast<int>(cudaGetLastError());
    const int n_strips = (n_words + kStripWords - 1) / kStripWords;
    const int rows = overlap_block_rows(n_rows, n_strips);
    const dim3 blocks(n_strips, (n_rows + rows - 1) / rows);
    if (blocks.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
    overlap_words_kernel<<<blocks, kWordWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        row_min, row_max, col_min, col_max, words, summary, n_rows, n_cols);
    return static_cast<int>(cudaGetLastError());
}

// What one launch of overlap_words_kernel holds (out i32[6]: registers a
// thread, shared bytes a block, threads a block, resident blocks and warps
// an SM, local bytes a thread).
extern "C" int grace_overlap_words_resources(int* out, int device, void* stream) {
    (void)stream;
    if (!out) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaFuncAttributes attr;
    int blocks = 0;
    err = cudaFuncGetAttributes(&attr, overlap_words_kernel);
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, overlap_words_kernel,
                                                            kWordWarps * 32, 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.sharedSizeBytes);
    out[2] = kWordWarps * 32;
    out[3] = blocks;
    out[4] = blocks * kWordWarps;
    out[5] = static_cast<int>(attr.localSizeBytes);
    return 0;
}

// Set-bit compaction of words i32[n_rows, n_words]: ids i32[n_rows, max_q]
// (ascending, zero-padded), n i32[n_rows] = min(count, max_q) and the
// overflow bytes (count > max_q).
extern "C" int grace_compact_words(const int* words, int* ids, int* n, unsigned char* overflow,
                                   int n_rows, int n_words, int max_q, int device,
                                   void* stream) {
    if (n_rows < 0 || n_words < 0 || max_q < 0 ||
        (n_rows > 0 && (!n || !overflow || (n_words > 0 && !words) ||
                        (max_q > 0 && !ids))) ||
        reinterpret_cast<uintptr_t>(ids) % 4) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_rows == 0) return static_cast<int>(cudaGetLastError());
    const bool vec = n_words % 4 == 0 && reinterpret_cast<uintptr_t>(words) % 16 == 0;
    const int blocks = (n_rows + kCompactWarps - 1) / kCompactWarps;
    (vec ? compact_words_kernel<true> : compact_words_kernel<false>)
        <<<blocks, kCompactWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
            words, ids, n, overflow, n_rows, n_words, max_q);
    return static_cast<int>(cudaGetLastError());
}

// What one launch of compact_words_kernel holds (out i32[6], as
// grace_overlap_words_resources), on the 16-byte route where vec != 0.
extern "C" int grace_compact_words_resources(int* out, int vec, int device, void* stream) {
    (void)stream;
    if (!out) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    void (*kernel)(const int*, int*, int*, unsigned char*, int, int, int) =
        vec ? compact_words_kernel<true> : compact_words_kernel<false>;
    cudaFuncAttributes attr;
    int blocks = 0;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kCompactWarps * 32,
                                                            0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.sharedSizeBytes);
    out[2] = kCompactWarps * 32;
    out[3] = blocks;
    out[4] = blocks * kCompactWarps;
    out[5] = static_cast<int>(attr.localSizeBytes);
    return 0;
}
