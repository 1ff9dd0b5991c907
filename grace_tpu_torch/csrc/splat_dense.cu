// The dense form of splat.cu's contraction, kept as the reference that
// splat.cu is held bit-equal to (chip_smoke.py, tests/test_torch_cuda.py,
// chip_ablation.py); no wrapper launches it.
//
// One block per key, as splat.cu, taking the key's instances in sub-chunks
// that fit 48 KB of shared memory: each thread builds factor entries of
// every row and column of the patch for every instance, then adds the
// sub-chunk's rank-K contraction into the pixels it owns, held in
// registers: every instance against every pixel, each pixel's terms in
// ascending (instance, k) order into one accumulator that starts at +0.
// Terms outside a footprint are exactly +-0.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int NPT>  // output pixels per thread
__global__ void __launch_bounds__(kThreads)
splat_kernel(const int32_t* __restrict__ slab_lo, const int32_t* __restrict__ n_slabs,
             const int32_t* __restrict__ first, const int32_t* __restrict__ last,
             const float* __restrict__ xcols, const float* __restrict__ yrows,
             const float* __restrict__ slabs, const float* __restrict__ a_coeffs,
             const float* __restrict__ b_coeffs, float* __restrict__ out,
             int nbx, int tile_w, int band, int chunk, int width, int n_slab_total,
             int rank, int deg, int sub) {
    extern __shared__ float smem[];
    const int n_c = rank * (deg + 1);
    float* ys = smem;                       // [tile_w]
    float* xs = ys + tile_w;                // [band]
    float* ca = xs + band;                  // [rank][deg + 1]
    float* cb = ca + n_c;                   // [rank][deg + 1]
    float* fa = cb + n_c;                   // [sub][rank][tile_w]
    float* fb = fa + sub * rank * tile_w;   // [sub][rank][band], times scale

    const int key = blockIdx.x;
    const int row0 = (key / nbx) * tile_w;
    const int col0 = (key % nbx) * band;
    const int tid = threadIdx.x;
    for (int i = tid; i < tile_w; i += kThreads) ys[i] = yrows[row0 + i];
    for (int i = tid; i < band; i += kThreads) xs[i] = xcols[col0 + i];
    for (int i = tid; i < n_c; i += kThreads) {
        ca[i] = a_coeffs[i];
        cb[i] = b_coeffs[i];
    }

    const int s_lo = slab_lo[key];
    const int n_s = n_slabs[key];
    const int g_first = first[key];
    const int g_last = last[key];
    const int n_pix = tile_w * band;
    const int span = tile_w + band;

    float acc[NPT];
#pragma unroll
    for (int j = 0; j < NPT; ++j) acc[j] = 0.0f;
    __syncthreads();

    for (int s = 0; s < n_s && s_lo + s < n_slab_total; ++s) {
        for (int half = 0; half < 2; ++half) {
            const int g0 = ((s_lo + s) * 2 + half) * chunk;
            const int lo = max(g0, g_first);
            const int hi = min(g0 + chunk, g_last);
            // rows pu, pv, invh, scale of this half's chunk
            const float* blk = slabs + (static_cast<int64_t>(s_lo + s) * 8 + 4 * half) * chunk;
            for (int base = lo; base < hi; base += sub) {
                const int cnt = min(sub, hi - base);
                for (int e = tid; e < cnt * span; e += kThreads) {
                    const int i = e / span;
                    const int p = e - i * span;
                    const int lane = base + i - g0;
                    const float invh = blk[2 * chunk + lane];
                    const bool is_row = p < tile_w;
                    const float d = is_row ? (ys[p] - blk[chunk + lane]) * invh
                                           : (xs[p - tile_w] - blk[lane]) * invh;
                    const float t = fminf(d * d, 1.0f);
                    const float m = 1.0f - t;
                    const float* c = is_row ? ca : cb;
                    const float scl = is_row ? 1.0f : blk[3 * chunk + lane];
                    for (int k = 0; k < rank; ++k) {
                        const float* ck = c + k * (deg + 1);
                        float q = ck[deg];
                        for (int dd = deg - 1; dd >= 0; --dd) q = fmaf(q, t, ck[dd]);
                        if (is_row) {
                            fa[(i * rank + k) * tile_w + p] = q * m;
                        } else {
                            fb[(i * rank + k) * band + (p - tile_w)] = (q * m) * scl;
                        }
                    }
                }
                __syncthreads();
#pragma unroll
                for (int j = 0; j < NPT; ++j) {
                    const int pix = tid + j * kThreads;
                    if (pix < n_pix) {
                        const float* ar = fa + pix / band;
                        const float* br = fb + pix % band;
                        float a = acc[j];
                        for (int ik = 0; ik < cnt * rank; ++ik) {
                            a = fmaf(ar[ik * tile_w], br[ik * band], a);
                        }
                        acc[j] = a;
                    }
                }
                __syncthreads();
            }
        }
    }
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
        const int pix = tid + j * kThreads;
        if (pix < n_pix) {
            out[static_cast<int64_t>(row0 + pix / band) * width + col0 + pix % band] = acc[j];
        }
    }
}

template <int NPT>
cudaError_t launch(int n_keys, size_t smem, cudaStream_t stream,
                   const int32_t* slab_lo, const int32_t* n_slabs,
                   const int32_t* first, const int32_t* last, const float* xcols,
                   const float* yrows, const float* slabs, const float* a_coeffs,
                   const float* b_coeffs, float* out, int nbx, int tile_w,
                   int band, int chunk, int width, int n_slab_total, int rank,
                   int deg, int sub) {
    splat_kernel<NPT><<<n_keys, kThreads, smem, stream>>>(
        slab_lo, n_slabs, first, last, xcols, yrows, slabs, a_coeffs, b_coeffs,
        out, nbx, tile_w, band, chunk, width, n_slab_total, rank, deg, sub);
    return cudaGetLastError();
}

}  // namespace

// Launches one block per key, block b key b; sub instances a sub-chunk,
// their factors within 48 KB.
extern "C" int grace_splat_dense(const int32_t* slab_lo, const int32_t* n_slabs,
                           const int32_t* first, const int32_t* last,
                           const float* xcols, const float* yrows,
                           const float* slabs, const float* a_coeffs,
                           const float* b_coeffs, float* out, int n_keys,
                           int nbx, int tile_w, int band, int chunk, int width,
                           int n_slab_total, int rank, int deg, int sub,
                           int device, void* stream) {
    const int n_pix = tile_w * band;
    const size_t smem = sizeof(float) *
        (static_cast<size_t>(tile_w) + band + 2 * rank * (deg + 1) +
         static_cast<size_t>(sub) * rank * (tile_w + band));
    if (n_pix < 1 || n_pix > 32 * kThreads || sub < 1 || smem > 48 * 1024) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_keys == 0) return static_cast<int>(cudaGetLastError());
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GRACE_SPLAT_LAUNCH(N)                                                  \
    return static_cast<int>(launch<N>(n_keys, smem, st, slab_lo, n_slabs,      \
                                      first, last, xcols, yrows, slabs,        \
                                      a_coeffs, b_coeffs, out, nbx, tile_w,    \
                                      band, chunk, width, n_slab_total, rank,  \
                                      deg, sub))
    if (n_pix <= 1 * kThreads) GRACE_SPLAT_LAUNCH(1);
    if (n_pix <= 2 * kThreads) GRACE_SPLAT_LAUNCH(2);
    if (n_pix <= 4 * kThreads) GRACE_SPLAT_LAUNCH(4);
    if (n_pix <= 8 * kThreads) GRACE_SPLAT_LAUNCH(8);
    if (n_pix <= 16 * kThreads) GRACE_SPLAT_LAUNCH(16);
    GRACE_SPLAT_LAUNCH(32);
#undef GRACE_SPLAT_LAUNCH
}
