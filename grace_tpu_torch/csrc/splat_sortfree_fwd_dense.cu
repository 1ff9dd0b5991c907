// The dense form of splat_sortfree.cu's forward, kept as the reference
// that the forward is held bit-equal to (chip_smoke.py,
// tests/test_torch_cuda.py, chip_ablation.py); no wrapper launches it.
//
// One block per (pixel tile, column band), as the forward. Per listed
// segment the block keeps the particles with scale != 0 whose footprint
// reaches the patch (each lane tests every row, then every column; a
// ballot compaction in lane order), then builds their factors for every
// row and column of the patch in sub-chunks that fit 48 KB of shared
// memory and adds the rank-K contraction into the pixels each thread owns:
// every kept particle against every pixel, each pixel's terms in ascending
// (segment, lane, k) order into one accumulator that starts at +0. Terms
// outside a footprint are exactly +-0.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kFwdThreads = 256;
constexpr int kSeg = 128;

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

}  // namespace

// One block per (pixel tile, column band), block b tile b / n_bands; band a
// divisor of tile_h, tile_w * band <= 2048, sub particles a sub-chunk, their
// factors within 48 KB.
extern "C" int grace_splat_sortfree_fwd_dense(const int32_t* masks, const float* coords,
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
