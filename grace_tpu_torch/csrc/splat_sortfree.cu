// Sort-free separable splat of Morton-ordered SPH particles: the image
// (forward) and its per-particle gradient (backward).
//
// Forward: replaces grace_tpu/trace/splat_grad.py::_sortfree_fwd_kernel.
// Pixel (y, x) of a tile gets, over the particles of the 128-particle
// segments its mask row lists,
//     sum_p sum_k A_k(t_y) * B_k(t_x) * scale_p,
//     A_k(t) = (1 - t) q_k(t),  t = min(((y - pv) * invh)^2, 1)
// (B likewise in x with its own coefficients). The basis is exactly zero
// for |dx| >= h, so a particle adds nothing outside its footprint.
//
// Layout: a pixel tile has tile_w rows and tile_h columns; each tile gets
// tile_h / band blocks, each owning a tile_w x band patch (no atomics, no
// second pass), so that the bench grid's 64 tiles fill the card. Every
// thread walks the tile's mask words in place, in ascending order, so the
// control flow is block-uniform. Per listed segment the block first keeps
// the particles with scale != 0 whose footprint reaches the patch (a
// ballot compaction of the 128 lanes, in lane order: the others add exact
// zeros), then, as splat.cu does, builds their factors in sub-chunks that
// fit 48 KB of shared memory and adds the rank-K contraction into the
// pixels each thread owns, in registers.
//
// What bounds it: the contraction, tile_w * band * rank fmas per kept
// particle, and the factor build, (tile_w + band) * rank * deg fmas. The
// culling makes both scale with the footprints, not with the segments'
// bounding boxes. All of it is FP32 FMA: TF32 keeps about three decimal
// digits, too few for the basis fit.
//
// Backward: replaces grace_tpu/trace/splat_grad.py::_sortfree_bwd_kernel.
// One block per segment, one thread per particle; the block walks the
// tiles of its transposed mask row (no list, so no capacity). For each
// tile it stages the cotangent tile G in shared memory, and each thread
// accumulates, for k = 1..rank,
//     P_k(i) = sum_j G_ij b_k(j),  Q_k(i) = sum_j G_ij b'_k(j) dtx/dpu(j),
//     R_k(i) = sum_j G_ij b'_k(j) dtx/dlog(invh)(j)
// over the tile's rows i in registers, then contracts them with its own
// a_k(i) and a'_k(i): g_scale += a P, g_pu += a Q, g_pv += a' dty/dpv P,
// g_t2 += a' dty/dlog(invh) P + a R. That is M_k = G^T A_k and
// N_k = G B_k without storing either. Columns outside every particle's
// footprint add exact zeros, so the block runs only the columns some
// particle of the segment reaches (a shared min/max). Particles with
// scale 0 write zero rows.
//
// What bounds it: 3 fmas per (row, column, rank, particle) of the P/Q/R
// sums. G reads are warp broadcasts; each thread keeps 3 * 32 sums in
// registers.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kFwdThreads = 256;
constexpr int kSeg = 128;
constexpr int kMaxRows = 32;  // backward: rows of a tile (P/Q/R in registers)

struct Coords {
    float x0, dx, y0, dy;
};

__device__ __forceinline__ Coords load_coords(const float* __restrict__ c) {
    return Coords{c[0], c[1], c[2], c[3]};
}

// Word w of a mask row, with the bits past n_bits cleared.
__device__ __forceinline__ unsigned mask_word(const int32_t* __restrict__ row, int w,
                                              int n_words, int n_bits) {
    unsigned v = static_cast<unsigned>(row[w]);
    if (w == n_words - 1 && (n_bits & 31)) v &= (1u << (n_bits & 31)) - 1u;
    return v;
}

// Horner value q(t) of coefficients c[0..deg].
__device__ __forceinline__ float horner(const float* c, int deg, float t) {
    float q = c[deg];
    for (int d = deg - 1; d >= 0; --d) q = fmaf(q, t, c[d]);
    return q;
}

template <int NPT>  // output pixels per thread
__global__ void __launch_bounds__(kFwdThreads)
sortfree_fwd_kernel(const int32_t* __restrict__ masks, const float* __restrict__ coords,
                    const float* __restrict__ slabs, const float* __restrict__ a_coeffs,
                    const float* __restrict__ b_coeffs, float* __restrict__ out,
                    int n_words, int n_segs, int ntx, int tile_w, int tile_h, int band,
                    int width, int rank, int deg, int sub) {
    extern __shared__ float smem[];
    const int n_c = rank * (deg + 1);
    float* ys = smem;                          // [tile_w]
    float* xs = ys + tile_w;                   // [band]
    float* ca = xs + band;                     // [rank][deg + 1]
    float* cb = ca + n_c;                      // [rank][deg + 1]
    float* prm = cb + n_c;                     // [4][kSeg] pu, pv, invh, scale
    int* keep = reinterpret_cast<int*>(prm + 4 * kSeg);  // [kSeg] kept lanes
    int* warp_n = keep + kSeg;                 // [4] kept lanes per warp
    float* fa = reinterpret_cast<float*>(warp_n + 8);    // [sub][rank][tile_w]
    float* fb = fa + sub * rank * tile_w;      // [sub][rank][band], times scale

    const int n_bands = tile_h / band;
    const int tile = blockIdx.x / n_bands;
    const int row0 = (tile / ntx) * tile_w;
    const int col0 = (tile % ntx) * tile_h + (blockIdx.x % n_bands) * band;
    const int tid = threadIdx.x;
    const Coords cc = load_coords(coords);
    for (int i = tid; i < tile_w; i += kFwdThreads) ys[i] = fmaf(static_cast<float>(row0 + i), cc.dy, cc.y0);
    for (int i = tid; i < band; i += kFwdThreads) xs[i] = fmaf(static_cast<float>(col0 + i), cc.dx, cc.x0);
    for (int i = tid; i < n_c; i += kFwdThreads) {
        ca[i] = a_coeffs[i];
        cb[i] = b_coeffs[i];
    }
    const int n_pix = tile_w * band;
    const int span = tile_w + band;
    float acc[NPT];
#pragma unroll
    for (int j = 0; j < NPT; ++j) acc[j] = 0.0f;
    __syncthreads();

    const int32_t* row = masks + static_cast<int64_t>(tile) * n_words;
    for (int w = 0; w < n_words; ++w) {
        unsigned bits = mask_word(row, w, n_words, n_segs);
        while (bits != 0) {
            const int seg = w * 32 + __ffs(bits) - 1;
            bits &= bits - 1;
            // 1. keep the lanes with scale != 0 whose footprint reaches the
            // patch, in lane order
            __syncthreads();  // the previous segment is consumed
            bool kept = false;
            unsigned ballot = 0;
            if (tid < kSeg) {  // warps 0-3, whole
                const float* s = slabs + static_cast<int64_t>(seg) * 8 * kSeg;
                const float pu = s[tid], pv = s[kSeg + tid];
                const float invh = s[2 * kSeg + tid], scl = s[3 * kSeg + tid];
                bool in_y = false;
                if (scl != 0.0f) {
                    for (int i = 0; i < tile_w && !in_y; ++i) {
                        const float d = (ys[i] - pv) * invh;
                        in_y = d * d < 1.0f;
                    }
                    for (int i = 0; i < band && in_y && !kept; ++i) {
                        const float d = (xs[i] - pu) * invh;
                        kept = d * d < 1.0f;
                    }
                }
                ballot = __ballot_sync(0xffffffffu, kept);
                if ((tid & 31) == 0) warp_n[tid >> 5] = __popc(ballot);
                prm[tid] = pu;
                prm[kSeg + tid] = pv;
                prm[2 * kSeg + tid] = invh;
                prm[3 * kSeg + tid] = scl;
            }
            __syncthreads();
            if (kept) {
                int pos = __popc(ballot & ((1u << (tid & 31)) - 1u));
                for (int v = 0; v < (tid >> 5); ++v) pos += warp_n[v];
                keep[pos] = tid;
            }
            __syncthreads();
            const int n_keep = warp_n[0] + warp_n[1] + warp_n[2] + warp_n[3];
            // 2. factors and contraction, sub particles at a time
            for (int base = 0; base < n_keep; base += sub) {
                const int cnt = min(sub, n_keep - base);
                for (int e = tid; e < cnt * span; e += kFwdThreads) {
                    const int i = e / span;
                    const int p = e - i * span;
                    const int lane = keep[base + i];
                    const float invh = prm[2 * kSeg + lane];
                    const bool is_row = p < tile_w;
                    const float d = is_row ? (ys[p] - prm[kSeg + lane]) * invh
                                           : (xs[p - tile_w] - prm[lane]) * invh;
                    const float t = fminf(d * d, 1.0f);
                    const float m = 1.0f - t;
                    for (int k = 0; k < rank; ++k) {
                        if (is_row) {
                            fa[(i * rank + k) * tile_w + p] = horner(ca + k * (deg + 1), deg, t) * m;
                        } else {
                            fb[(i * rank + k) * band + (p - tile_w)] =
                                (horner(cb + k * (deg + 1), deg, t) * m) * prm[3 * kSeg + lane];
                        }
                    }
                }
                __syncthreads();
#pragma unroll
                for (int j = 0; j < NPT; ++j) {
                    const int pix = tid + j * kFwdThreads;
                    if (pix < n_pix) {
                        const float* ar = fa + pix / band;
                        const float* br = fb + pix % band;
                        float a = acc[j];
                        for (int ik = 0; ik < cnt * rank; ++ik) a = fmaf(ar[ik * tile_w], br[ik * band], a);
                        acc[j] = a;
                    }
                }
                __syncthreads();
            }
        }
    }
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
        const int pix = tid + j * kFwdThreads;
        if (pix < n_pix) out[static_cast<int64_t>(row0 + pix / band) * width + col0 + pix % band] = acc[j];
    }
}

// alpha(t) = (1 - t) q(t) and its t-derivative q'(t) (1 - t) - q(t).
__device__ __forceinline__ void poly_and_deriv(const float* c, int deg, float t,
                                               float& val, float& der) {
    const float m = 1.0f - t;
    float q = c[deg];
    float dq = 0.0f;
    for (int d = deg - 1; d >= 0; --d) {
        dq = fmaf(dq, t, q);
        q = fmaf(q, t, c[d]);
    }
    val = q * m;
    der = fmaf(dq, m, -q);
}

template <int TW>  // rows held in registers, >= tile_w
__global__ void __launch_bounds__(kSeg)
sortfree_bwd_kernel(const int32_t* __restrict__ masks_t, const float* __restrict__ coords,
                    const float* __restrict__ slabs, const float* __restrict__ g_image,
                    const float* __restrict__ a_coeffs, const float* __restrict__ b_coeffs,
                    float* __restrict__ out, int n_twords, int n_tiles, int ntx, int tile_w,
                    int tile_h, int width, int rank, int deg) {
    extern __shared__ float smem[];
    const int n_c = rank * (deg + 1);
    float* g = smem;                    // [TW][tile_h] cotangent tile, rows >= tile_w zero
    float* xs = g + TW * tile_h;        // [tile_h]
    float* ys = xs + tile_h;            // [TW]
    float* ca = ys + TW;                // [rank][deg + 1]
    float* cb = ca + n_c;
    int* range = reinterpret_cast<int*>(cb + n_c);  // [2] columns [lo, hi) any particle reaches

    const int seg = blockIdx.x;
    const int tid = threadIdx.x;
    const Coords cc = load_coords(coords);
    const float* s = slabs + static_cast<int64_t>(seg) * 8 * kSeg;
    const float pu = s[tid], pv = s[kSeg + tid], invh = s[2 * kSeg + tid];
    const float scl = s[3 * kSeg + tid];
    for (int i = tid; i < n_c; i += kSeg) {
        ca[i] = a_coeffs[i];
        cb[i] = b_coeffs[i];
    }
    for (int e = tile_w * tile_h + tid; e < TW * tile_h; e += kSeg) g[e] = 0.0f;

    float g_pu = 0.0f, g_pv = 0.0f, g_t2 = 0.0f, g_s = 0.0f;
    const int32_t* row = masks_t + static_cast<int64_t>(seg) * n_twords;
    for (int w = 0; w < n_twords; ++w) {
        unsigned bits = mask_word(row, w, n_twords, n_tiles);
        while (bits != 0) {
            const int t = w * 32 + __ffs(bits) - 1;
            bits &= bits - 1;
            const int row0 = (t / ntx) * tile_w;
            const int col0 = (t % ntx) * tile_h;
            __syncthreads();  // the previous tile is consumed
            for (int e = tid; e < tile_w * tile_h; e += kSeg) {
                const int i = e / tile_h;
                g[e] = g_image[static_cast<int64_t>(row0 + i) * width + col0 + (e - i * tile_h)];
            }
            for (int j = tid; j < tile_h; j += kSeg) xs[j] = fmaf(static_cast<float>(col0 + j), cc.dx, cc.x0);
            for (int i = tid; i < tile_w; i += kSeg) ys[i] = fmaf(static_cast<float>(row0 + i), cc.dy, cc.y0);
            if (tid == 0) {
                range[0] = tile_h;
                range[1] = 0;
            }
            __syncthreads();
            if (scl != 0.0f) {
                bool any_row = false;
                for (int i = 0; i < tile_w && !any_row; ++i) {
                    const float d = (ys[i] - pv) * invh;
                    any_row = d * d < 1.0f;
                }
                int lo = tile_h, hi = 0;
                for (int j = 0; j < tile_h && any_row; ++j) {
                    const float d = (xs[j] - pu) * invh;
                    if (d * d < 1.0f) {
                        lo = min(lo, j);
                        hi = j + 1;
                    }
                }
                if (lo < hi) {
                    atomicMin(range, lo);
                    atomicMax(range + 1, hi);
                }
            }
            __syncthreads();
            const int j_lo = range[0], j_hi = range[1];
            for (int k = 0; k < rank && j_lo < j_hi; ++k) {
                const float* ck_a = ca + k * (deg + 1);
                const float* ck_b = cb + k * (deg + 1);
                float p_s[TW], q_s[TW], r_s[TW];
#pragma unroll
                for (int i = 0; i < TW; ++i) p_s[i] = q_s[i] = r_s[i] = 0.0f;
                for (int j = j_lo; j < j_hi; ++j) {
                    const float xb = (xs[j] - pu) * invh;
                    const float xb2 = xb * xb;
                    const float in_x = xb2 < 1.0f ? 1.0f : 0.0f;
                    float b_v, b_d;
                    poly_and_deriv(ck_b, deg, fminf(xb2, 1.0f), b_v, b_d);
                    const float bq = b_d * (((-2.0f * xb) * invh) * in_x);
                    const float br = b_d * ((2.0f * xb2) * in_x);
                    const float* gj = g + j;
#pragma unroll
                    for (int i = 0; i < TW; ++i) {
                        const float gv = gj[i * tile_h];
                        p_s[i] = fmaf(gv, b_v, p_s[i]);
                        q_s[i] = fmaf(gv, bq, q_s[i]);
                        r_s[i] = fmaf(gv, br, r_s[i]);
                    }
                }
#pragma unroll
                for (int i = 0; i < TW; ++i) {
                    if (i < tile_w) {
                        const float ya = (ys[i] - pv) * invh;
                        const float ya2 = ya * ya;
                        const float in_y = ya2 < 1.0f ? 1.0f : 0.0f;
                        float a_v, a_d;
                        poly_and_deriv(ck_a, deg, fminf(ya2, 1.0f), a_v, a_d);
                        const float ap = a_d * p_s[i];
                        g_s = fmaf(a_v, p_s[i], g_s);
                        g_pu = fmaf(a_v, q_s[i], g_pu);
                        g_pv = fmaf(ap, ((-2.0f * ya) * invh) * in_y, g_pv);
                        g_t2 = fmaf(ap, (2.0f * ya2) * in_y, fmaf(a_v, r_s[i], g_t2));
                    }
                }
            }
        }
    }
    float* o = out + static_cast<int64_t>(seg) * 8 * kSeg;
    const bool live = scl != 0.0f;
    o[tid] = live ? g_pu * scl : 0.0f;
    o[kSeg + tid] = live ? g_pv * scl : 0.0f;
    o[2 * kSeg + tid] = live ? g_t2 * scl : 0.0f;
    o[3 * kSeg + tid] = live ? g_s : 0.0f;
    for (int r = 4; r < 8; ++r) o[r * kSeg + tid] = 0.0f;
}

}  // namespace

// Forward: one block per (pixel tile, column band). The wrapper picks band
// (a divisor of tile_h, tile_w * band <= 2048) and sub (the particles whose
// factors fit 48 KB of shared memory).
extern "C" int grace_splat_sortfree_fwd(const int32_t* masks, const float* coords,
                                        const float* slabs, const float* a_coeffs,
                                        const float* b_coeffs, float* out, int n_tiles,
                                        int n_words, int n_segs, int ntx, int tile_w,
                                        int tile_h, int band, int width, int rank,
                                        int deg, int sub, int device, void* stream) {
    const int n_pix = tile_w * band;
    const size_t smem = sizeof(float) *
        (static_cast<size_t>(tile_w) + band + 2 * rank * (deg + 1) + 5 * kSeg + 8 +
         static_cast<size_t>(sub) * rank * (tile_w + band));
    if (n_pix < 1 || n_pix > 8 * kFwdThreads || band < 1 || tile_h % band != 0 || sub < 1 ||
        smem > 48 * 1024 || n_words != (n_segs + 31) / 32) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_blocks = n_tiles * (tile_h / band);
    if (n_blocks == 0) return static_cast<int>(cudaGetLastError());
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GRACE_SORTFREE_FWD(N)                                                          \
    sortfree_fwd_kernel<N><<<n_blocks, kFwdThreads, smem, st>>>(                       \
        masks, coords, slabs, a_coeffs, b_coeffs, out, n_words, n_segs, ntx, tile_w,   \
        tile_h, band, width, rank, deg, sub);                                          \
    return static_cast<int>(cudaGetLastError())
    if (n_pix <= kFwdThreads) { GRACE_SORTFREE_FWD(1); }
    if (n_pix <= 2 * kFwdThreads) { GRACE_SORTFREE_FWD(2); }
    if (n_pix <= 4 * kFwdThreads) { GRACE_SORTFREE_FWD(4); }
    GRACE_SORTFREE_FWD(8);
#undef GRACE_SORTFREE_FWD
}

// Backward: one block of 128 threads per segment; tile_w <= 32 rows.
extern "C" int grace_splat_sortfree_bwd(const int32_t* masks_t, const float* coords,
                                        const float* slabs, const float* g_image,
                                        const float* a_coeffs, const float* b_coeffs,
                                        float* out, int n_segs, int n_twords, int n_tiles,
                                        int ntx, int tile_w, int tile_h, int width,
                                        int rank, int deg, int device, void* stream) {
    const int tw = tile_w <= 8 ? 8 : tile_w <= 16 ? 16 : kMaxRows;
    const size_t smem = sizeof(float) *
        (static_cast<size_t>(tw + 1) * tile_h + tw + 2 * rank * (deg + 1) + 2);
    if (tile_w < 1 || tile_w > kMaxRows || tile_h < 1 || smem > 48 * 1024 ||
        n_twords != (n_tiles + 31) / 32) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_segs == 0) return static_cast<int>(cudaGetLastError());
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GRACE_SORTFREE_BWD(T)                                                          \
    sortfree_bwd_kernel<T><<<n_segs, kSeg, smem, st>>>(                                \
        masks_t, coords, slabs, g_image, a_coeffs, b_coeffs, out, n_twords, n_tiles,   \
        ntx, tile_w, tile_h, width, rank, deg);                                        \
    return static_cast<int>(cudaGetLastError())
    if (tw == 8) { GRACE_SORTFREE_BWD(8); }
    if (tw == 16) { GRACE_SORTFREE_BWD(16); }
    GRACE_SORTFREE_BWD(32);
#undef GRACE_SORTFREE_BWD
}
