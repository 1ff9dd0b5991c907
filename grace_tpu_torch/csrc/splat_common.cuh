// The separable splat contraction over footprints, shared by splat.cu (the
// bucketed image, B1) and splat_sortfree.cu's forward (the sort-free image,
// B11).
//
// A block owns a tile_w x band patch of the image. Its kernel fills a batch
// of instances in shared memory (pu, pv, invh, scale, and the rows and
// columns of the patch inside each footprint, from support_range), then
// run_batch adds the batch into the patch:
//
//   pixel (r, c) += sum_i sum_k A_k(t_r) B_k(t_c) scale_i,
//   A_k(t) = (1 - t) q_k(t),  t = min(((y_r - pv) * invh)^2, 1)
//
// (B likewise in x). Outside the footprint t is 1, so A or B is exactly
// +-0 and fmaf(+-0, b, acc) = acc: a term outside the support changes no
// sum. So run_batch builds factors only inside each footprint and adds only
// the terms inside it, and the image keeps the bits of the dense
// contraction (every instance against every pixel), which adds each
// pixel's terms in ascending (instance, k) order into one accumulator that
// starts at +0; so does this.
//
// What bounds it: the contraction, rank fmas per (instance, pixel) of the
// footprint, and the shared loads that feed them. What the design does
// about it: a thread holds kRows rows of one column (register blocking: one
// float4 of A and one B per (instance, k) feed kRows fmas); a warp owns
// (strip of kRows rows, 32-column group) tasks and walks, as a ballot
// mask, only the batch instances whose footprint meets its task, in
// ascending order; the factors are built only for a footprint's columns
// and the rows of the strips it meets (rows of such a strip outside the
// footprint come out +-0 and add nothing), a warp an instance, rows and
// columns in one pass without a branch, the Horner loop unrolled for the
// bases' degrees (8 and 10). All of it is FP32 FMA: TF32 keeps about three
// decimal digits, too few for the basis fit. The kernels launch their
// heaviest patches first (the wrappers pass the order).
#pragma once

#include <cstdint>

namespace splat {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;        // rows a thread accumulates (register blocking)
constexpr int kMaxNT = 16;      // tasks a warp holds: at most kWarps * kMaxNT tasks
constexpr int kMaxBatch = kThreads / 2;  // instances a batch holds (two threads each)
constexpr int kMaxShared = 227 * 1024;

// Shared memory of a block: the batch's factors, its instances, the
// patch's pixel centres and the basis coefficients.
struct Layout {
    float4* prm;  // [sub] pu, pv, invh, scale
    int4* rng;    // [sub] columns [x, y), rows [z, w) inside the footprint
    float* fa;    // [sub][rank][tw4] A_k of the rows (16-byte aligned rows)
    float* fb;    // [sub][rank][band] B_k * scale of the columns
    float* ys;    // [tw4] row centres (rows past tile_w repeat the last)
    float* xs;    // [band] column centres
    float* ca;    // [rank][deg + 1]
    float* cb;    // [rank][deg + 1]
    float* step;  // [2] 1 / (centre spacing) of rows and columns, or 0
    void* extra;  // the kernel's own
};

__host__ __device__ inline int padded_rows(int tile_w) {
    return (tile_w + kRows - 1) / kRows * kRows;
}

__host__ __device__ inline int n_tasks(int tile_w, int band) {
    return (padded_rows(tile_w) / kRows) * ((band + 31) / 32);
}

__host__ __device__ inline size_t layout_bytes(int tile_w, int band, int rank, int deg, int sub,
                                               size_t extra) {
    const size_t tw4 = padded_rows(tile_w);
    return sizeof(float) * (static_cast<size_t>(sub) * rank * (tw4 + band)) +
           (sizeof(float4) + sizeof(int4)) * sub +
           sizeof(float) * (tw4 + band + 2 * rank * (deg + 1) + 4) + extra;
}

__device__ __forceinline__ Layout carve(float4* smem, int tile_w, int band, int rank, int deg,
                                        int sub) {
    const int tw4 = padded_rows(tile_w);
    Layout l;
    l.prm = static_cast<float4*>(smem);
    l.rng = reinterpret_cast<int4*>(l.prm + sub);
    l.fa = reinterpret_cast<float*>(l.rng + sub);
    l.fb = l.fa + sub * rank * tw4;
    l.ys = l.fb + sub * rank * band;
    l.xs = l.ys + tw4;
    l.ca = l.xs + band;
    l.cb = l.ca + rank * (deg + 1);
    l.step = l.cb + rank * (deg + 1);
    l.extra = l.step + 4;
    return l;
}

// True where the factor of centre c is not +-0: the test the factor build
// rounds, d = (c - q) * invh, t = min(d^2, 1) < 1.
__device__ __forceinline__ bool in_support(float c, float q, float invh) {
    const float d = (c - q) * invh;
    return d * d < 1.0f;
}

// [lo, hi): the centres c[0..n) inside the footprint of a particle at q
// with 1 / h = invh. The centres are monotone, so that set is an interval.
// The closed form |c[0] + p / inv_step - q| < h, widened by 2 centres and by
// 8 ulp of the operands' magnitude (which covers the rounding of the
// closed form and of the centres themselves), then trimmed with the exact
// test. inv_step 0 (one centre, or centres that do not advance) starts
// from all n. An empty range comes back as [0, 0).
__device__ __forceinline__ int2 support_range(const float* c, int n, float inv_step, float q,
                                              float invh) {
    int lo = 0, hi = n;
    if (inv_step != 0.0f) {
        const float h = fabsf(1.0f / invh);
        const float a = (q - h - c[0]) * inv_step;
        const float b = (q + h - c[0]) * inv_step;
        const float margin = 2.0f + (fabsf(q) + fabsf(c[0]) + h) * fabsf(inv_step) * 0x1p-20f;
        const float f_lo = floorf(fminf(a, b) - margin);
        const float f_hi = ceilf(fmaxf(a, b) + margin) + 1.0f;
        const float top = static_cast<float>(n);
        lo = static_cast<int>(fminf(fmaxf(f_lo, 0.0f), top));  // NaN -> 0
        hi = static_cast<int>(fminf(fmaxf(f_hi, 0.0f), top));
    }
    while (lo < hi && !in_support(c[lo], q, invh)) ++lo;
    while (hi > lo && !in_support(c[hi - 1], q, invh)) --hi;
    return lo < hi ? make_int2(lo, hi) : make_int2(0, 0);
}

// The rows and columns of the patch inside an instance's footprint; [0, 0)
// in both when either is empty (such an instance adds nothing).
__device__ __forceinline__ int4 footprint(const Layout& l, int tile_w, int band, float4 p) {
    const int2 rows = support_range(l.ys, tile_w, l.step[0], p.y, p.z);
    if (rows.x == rows.y) return make_int4(0, 0, 0, 0);
    const int2 cols = support_range(l.xs, band, l.step[1], p.x, p.z);
    if (cols.x == cols.y) return make_int4(0, 0, 0, 0);
    return make_int4(cols.x, cols.y, rows.x, rows.y);
}

// Batch instance i's rows (axis 0: rng[i].z, .w) or columns (axis 1:
// rng[i].x, .y) inside its footprint, p its parameters: one thread an axis,
// so that a batch's ranges take two threads an instance. An instance with
// either range [0, 0) adds nothing.
__device__ __forceinline__ void footprint_axis(const Layout& l, int tile_w, int band, int i,
                                               int axis, float4 p) {
    int* r = reinterpret_cast<int*>(l.rng + i);
    const int2 v = axis == 0 ? support_range(l.ys, tile_w, l.step[0], p.y, p.z)
                             : support_range(l.xs, band, l.step[1], p.x, p.z);
    r[2 - 2 * axis] = v.x;
    r[3 - 2 * axis] = v.y;
}

// 1 / spacing of n monotone centres, 0 if they do not advance.
__device__ __forceinline__ float inverse_step(const float* c, int n) {
    const float span = n > 1 ? c[n - 1] - c[0] : 0.0f;
    return span != 0.0f && isfinite(span) ? static_cast<float>(n - 1) / span : 0.0f;
}

// After the kernel wrote ys[0..tile_w), xs[0..band) and the coefficients
// and synchronized: the pad rows and the steps (one thread).
__device__ __forceinline__ void finish_patch(const Layout& l, int tile_w, int band) {
    for (int i = tile_w; i < padded_rows(tile_w); ++i) l.ys[i] = l.ys[tile_w - 1];
    l.step[0] = inverse_step(l.ys, tile_w);
    l.step[1] = inverse_step(l.xs, band);
}

// Horner value q(t) of coefficients c[0..deg]; DEG > 0 fixes the degree
// at compile time (the loop unrolled, the coefficient loads ahead of the
// fmas), DEG = 0 takes deg at run time.
template <int DEG>
__device__ __forceinline__ float horner(const float* c, int deg, float t) {
    if constexpr (DEG > 0) {
        float q = c[DEG];
#pragma unroll
        for (int d = DEG - 1; d >= 0; --d) q = fmaf(q, t, c[d]);
        return q;
    } else {
        float q = c[deg];
        for (int d = deg - 1; d >= 0; --d) q = fmaf(q, t, c[d]);
        return q;
    }
}

// Factors of the batch's n instances: A_k for the rows of the kRows-strips
// the footprint meets, B_k * scale for its columns. A warp an instance,
// its lanes over those rows and columns, rows and columns alike (the
// coefficients, centre and destination chosen per lane, no branch).
template <int DEG>
__device__ __forceinline__ void build_factors(const Layout& l, int n, int tile_w, int band,
                                              int rank, int deg) {
    const int tw4 = padded_rows(tile_w);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int n_c = (DEG > 0 ? DEG : deg) + 1;
    for (int i = warp; i < n; i += kWarps) {
        const int4 r = l.rng[i];
        if (r.x == r.y || r.z == r.w) continue;
        const float4 p = l.prm[i];
        const int ra = r.z / kRows * kRows;
        const int n_a = (r.w + kRows - 1) / kRows * kRows - ra;
        for (int e = lane; e < n_a + (r.y - r.x); e += 32) {
            const bool is_row = e < n_a;
            const int px = is_row ? ra + e : r.x + e - n_a;
            const float d = is_row ? (l.ys[px] - p.y) * p.z : (l.xs[px] - p.x) * p.z;
            const float t = fminf(d * d, 1.0f);
            const float m = 1.0f - t;
            const float* c = is_row ? l.ca : l.cb;
            float* dst = is_row ? l.fa + i * rank * tw4 + px : l.fb + i * rank * band + px;
            const int stride = is_row ? tw4 : band;
            for (int k = 0; k < rank; ++k) {
                const float v = horner<DEG>(c + k * n_c, deg, t) * m;
                dst[k * stride] = is_row ? v : v * p.w;
            }
        }
    }
}

// kRows consecutive A entries (16-byte aligned for kRows = 4).
__device__ __forceinline__ void load_rows(const float* a, float (&v)[kRows]) {
    if constexpr (kRows == 4) {
        const float4 q = *reinterpret_cast<const float4*>(a);
        v[0] = q.x;
        v[1] = q.y;
        v[2] = q.z;
        v[3] = q.w;
    } else {
#pragma unroll
        for (int r = 0; r < kRows; ++r) v[r] = a[r];
    }
}

// The batch's terms into acc: task warp + j * kWarps is the strip of kRows
// rows (task / n_groups) and the 32-column group (task % n_groups); its
// lanes are the group's columns. The warp walks, in ascending order, the
// instances whose footprint meets the task, and each lane inside the
// footprint's columns adds their rank terms to its kRows pixels.
template <int NT>
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
        const int g0 = task % n_groups * 32;
        const int c = g0 + lane;
        for (int base = 0; base < n; base += 32) {
            bool meets = false;
            if (base + lane < n) {
                const int4 r = l.rng[base + lane];
                meets = r.z < r0 + kRows && r.w > r0 && r.x < g0 + 32 && r.y > g0;
            }
            unsigned bits = __ballot_sync(0xffffffffu, meets);
            while (bits != 0) {
                const int i = base + __ffs(bits) - 1;
                bits &= bits - 1;
                const int4 r = l.rng[i];
                if (c < r.x || c >= r.y) continue;
                const float* a = l.fa + i * rank * tw4 + r0;
                const float* b = l.fb + i * rank * band + c;
#pragma unroll 5
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
}

// The batch's n instances (prm and rng written by the kernel) into acc.
// Starts and ends with a barrier: after it the batch may be refilled.
template <int NT, int DEG>
__device__ __forceinline__ void run_batch(const Layout& l, int n, int tile_w, int band, int rank,
                                          int deg, float (&acc)[NT][kRows]) {
    __syncthreads();
    build_factors<DEG>(l, n, tile_w, band, rank, deg);
    __syncthreads();
    contract<NT>(l, n, tile_w, band, rank, acc);
    __syncthreads();
}

// The patch's pixels from acc, into out at (row0, col0) of a width-wide image.
template <int NT>
__device__ __forceinline__ void store_patch(const float (&acc)[NT][kRows], float* out, int row0,
                                            int col0, int width, int tile_w, int band) {
    const int n_groups = (band + 31) / 32;
    const int tasks = n_tasks(tile_w, band);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
        const int task = warp + j * kWarps;
        const int r0 = task / n_groups * kRows;
        const int c = task % n_groups * 32 + lane;
        if (task >= tasks || c >= band) continue;
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {
            if (r0 + rr < tile_w) {
                out[static_cast<int64_t>(row0 + r0 + rr) * width + col0 + c] = acc[j][rr];
            }
        }
    }
}

// Tasks a warp holds for a patch (1, 2, 4, 8 or 16), or 0 if too many.
inline int tasks_per_warp(int tile_w, int band) {
    const int need = (n_tasks(tile_w, band) + kWarps - 1) / kWarps;
    for (int nt = 1; nt <= kMaxNT; nt *= 2) {
        if (need <= nt) return nt;
    }
    return 0;
}

// Let kernel take smem bytes of dynamic shared memory; with out, also fill
// registers, shared bytes, threads, resident blocks and warps an SM (for
// blocks of `threads`).
template <typename Kernel>
cudaError_t kernel_setup(Kernel kernel, size_t smem, int* out, int threads = kThreads) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                           cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
    }
    if (err != cudaSuccess || out == nullptr) return err;
    cudaFuncAttributes attr;
    int blocks;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
    }
    if (err != cudaSuccess) return err;
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.sharedSizeBytes + smem);
    out[2] = threads;
    out[3] = blocks;
    out[4] = blocks * threads / 32;
    return cudaSuccess;
}

}  // namespace splat
