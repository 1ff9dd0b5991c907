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
// tile_h / band x kRowParts blocks, each owning a (tile_w / kRowParts) x
// band patch (no atomics, no second pass), so that the bench grid's 64
// tiles fill the card. Blocks take tiles in the wrapper's order (most
// listed segments first). Every thread walks the tile's mask words in
// place, in ascending order, so the control flow is block-uniform. The
// block takes the listed segments two a round (threads 0-127 the first's
// lanes, 128-255 the second's, loaded one round ahead) and keeps the
// particles with scale != 0 whose footprint meets the patch (an O(1)
// closed-form interval test, then the exact one: splat_common.cuh's
// support_range; a ballot compaction in segment-then-lane order: the
// others add exact zeros), appending them to a batch that gathers several
// rounds; splat_common.cuh's run_batch adds a full batch into the patch,
// over each footprint only.
//
// What bounds it: the contraction over the footprints and the factor
// build (splat_common.cuh), and per round one barrier and the cull of 256
// lanes. The image is bit-equal to the dense contraction over the whole
// patch (splat_sortfree_fwd_dense.cu).
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
#include "splat_common.cuh"

namespace {

using splat::kRows;
constexpr int kFwdThreads = splat::kThreads;
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

// Blocks a tile's patch is cut into along its rows, besides its bands.
constexpr int kRowParts = 2;

template <int NT, int DEG>  // tasks a warp holds; the basis degree (0: at run time)
__global__ void __launch_bounds__(kFwdThreads)
sortfree_fwd_kernel(const int32_t* __restrict__ masks, const int32_t* __restrict__ order,
                    const float* __restrict__ coords, const float* __restrict__ slabs,
                    const float* __restrict__ a_coeffs, const float* __restrict__ b_coeffs,
                    float* __restrict__ out, int n_words, int n_segs, int ntx, int rows,
                    int parts, int tile_h, int band, int width, int rank, int deg, int sub) {
    extern __shared__ float4 fwd_smem[];  // (the backward's is float smem[])
    const int tile_w = rows;  // the rows this block owns
    const splat::Layout l = splat::carve(fwd_smem, tile_w, band, rank, deg, sub);
    int* warp_n = static_cast<int*>(l.extra);  // [2][kWarps] kept lanes per warp, by parity
    const int n_c = rank * (deg + 1);
    const int per_tile = tile_h / band * parts;
    const int tile = order != nullptr ? order[blockIdx.x / per_tile] : blockIdx.x / per_tile;
    const int within = blockIdx.x % per_tile;
    const int row0 = (tile / ntx) * rows * parts + within % parts * rows;
    const int col0 = (tile % ntx) * tile_h + within / parts * band;
    const int tid = threadIdx.x;
    const Coords cc = load_coords(coords);
    for (int i = tid; i < tile_w; i += kFwdThreads) l.ys[i] = fmaf(static_cast<float>(row0 + i), cc.dy, cc.y0);
    for (int i = tid; i < band; i += kFwdThreads) l.xs[i] = fmaf(static_cast<float>(col0 + i), cc.dx, cc.x0);
    for (int i = tid; i < n_c; i += kFwdThreads) {
        l.ca[i] = a_coeffs[i];
        l.cb[i] = b_coeffs[i];
    }
    __syncthreads();
    if (tid == 0) splat::finish_patch(l, tile_w, band);
    float acc[NT][kRows];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[j][r] = 0.0f;
    }

    // The tile's listed segments in ascending order, two a round: threads
    // 0-127 take the first's lanes, 128-255 the second's, each particle
    // loaded one round ahead.
    const int32_t* row = masks + static_cast<int64_t>(tile) * n_words;
    int w = 0;
    unsigned bits = n_words > 0 ? mask_word(row, 0, n_words, n_segs) : 0u;
    auto next_seg = [&]() {
        while (bits == 0) {
            if (++w >= n_words) return -1;
            bits = mask_word(row, w, n_words, n_segs);
        }
        const int seg = w * 32 + __ffs(bits) - 1;
        bits &= bits - 1;
        return seg;
    };
    const int second = tid / kSeg;  // this thread's segment of a round
    auto load = [&](int seg) {
        const float* s = slabs + static_cast<int64_t>(seg) * 8 * kSeg + (tid - second * kSeg);
        return make_float4(s[0], s[kSeg], s[2 * kSeg], s[3 * kSeg]);
    };
    int first = next_seg();
    int mine = second == 0 ? first : next_seg();
    if (second == 0) next_seg();  // every thread walks the same bits
    float4 next = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (mine >= 0) next = load(mine);
    __syncthreads();  // the patch's centres and steps

    // Per round, keep the lanes with scale != 0 whose footprint meets the
    // patch (the others add exact zeros), in segment-then-lane order, and
    // append them to the batch, which run_batch adds in once it is full:
    // the order of the dense contraction.
    const int warp = tid >> 5;
    int n = 0, parity = 0;
    while (first >= 0) {
        const float4 p = next;
        const bool listed = mine >= 0;
        first = next_seg();
        const int other = next_seg();
        mine = second == 0 ? first : other;
        if (mine >= 0) next = load(mine);
        bool kept = false;
        int4 rng = make_int4(0, 0, 0, 0);
        if (listed && p.w != 0.0f) {
            rng = splat::footprint(l, tile_w, band, p);
            kept = rng.x < rng.y;
        }
        const unsigned ballot = __ballot_sync(0xffffffffu, kept);
        if ((tid & 31) == 0) warp_n[parity * splat::kWarps + warp] = __popc(ballot);
        int pos = __popc(ballot & ((1u << (tid & 31)) - 1u));
        __syncthreads();
        const int* wn = warp_n + parity * splat::kWarps;
        int n_round = 0;
        for (int v = 0; v < splat::kWarps; ++v) {
            pos += v < warp ? wn[v] : 0;
            n_round += wn[v];
        }
        for (int done = 0; done < n_round;) {
            const int take = min(n_round - done, sub - n);
            if (kept && pos >= done && pos < done + take) {
                l.prm[n + pos - done] = p;
                l.rng[n + pos - done] = rng;
            }
            n += take;
            done += take;
            if (n == sub) {
                splat::run_batch<NT, DEG>(l, n, tile_w, band, rank, deg, acc);
                n = 0;
            }
        }
        parity ^= 1;
    }
    if (n > 0) splat::run_batch<NT, DEG>(l, n, tile_w, band, rank, deg, acc);
    splat::store_patch<NT>(acc, out, row0, col0, width, tile_w, band);
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

// Blocks a tile's rows are cut into: kRowParts where tile_w allows it.
int row_parts(int tile_w) { return tile_w % kRowParts == 0 ? kRowParts : 1; }

size_t fwd_smem_bytes(int tile_w, int band, int rank, int deg, int sub) {
    return splat::layout_bytes(tile_w / row_parts(tile_w), band, rank, deg, sub,
                               2 * splat::kWarps * sizeof(int));
}

using FwdKernel = void (*)(const int32_t*, const int32_t*, const float*, const float*,
                           const float*, const float*, float*, int, int, int, int, int, int,
                           int, int, int, int, int);

template <int DEG>
FwdKernel fwd_kernel_for_nt(int nt) {
    switch (nt) {
        case 1: return sortfree_fwd_kernel<1, DEG>;
        case 2: return sortfree_fwd_kernel<2, DEG>;
        case 4: return sortfree_fwd_kernel<4, DEG>;
        case 8: return sortfree_fwd_kernel<8, DEG>;
        case 16: return sortfree_fwd_kernel<16, DEG>;
        default: return nullptr;
    }
}

FwdKernel fwd_kernel_for(int tile_w, int band, int deg) {
    const int nt = splat::tasks_per_warp(tile_w / row_parts(tile_w), band);
    return deg == 8 ? fwd_kernel_for_nt<8>(nt)
                    : deg == 10 ? fwd_kernel_for_nt<10>(nt) : fwd_kernel_for_nt<0>(nt);
}

bool fwd_valid(int tile_w, int band, int rank, int deg, int sub) {
    return tile_w >= 1 && band >= 1 && rank >= 1 && deg >= 0 && sub >= 1 &&
           sub <= splat::kMaxBatch && fwd_kernel_for(tile_w, band, deg) != nullptr &&
           fwd_smem_bytes(tile_w, band, rank, deg, sub) <= splat::kMaxShared;
}

}  // namespace

// Forward: one block per (pixel tile, column band, row part), tile
// order[b / (n_bands * parts)] for block b (order null: tile b / (n_bands *
// parts)); parts is kRowParts where it divides tile_w. The wrapper
// picks band (a divisor of tile_h) and sub, the particles a batch (at most
// 128, their factors within 227 KB of shared memory).
extern "C" int grace_splat_sortfree_fwd(const int32_t* masks, const int32_t* order,
                                        const float* coords, const float* slabs,
                                        const float* a_coeffs, const float* b_coeffs,
                                        float* out, int n_tiles, int n_words, int n_segs,
                                        int ntx, int tile_w, int tile_h, int band, int width,
                                        int rank, int deg, int sub, int device, void* stream) {
    if (!fwd_valid(tile_w, band, rank, deg, sub) || tile_h % band != 0 ||
        n_words != (n_segs + 31) / 32) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int parts = row_parts(tile_w);
    const int n_blocks = n_tiles * (tile_h / band) * parts;
    if (n_blocks == 0) return static_cast<int>(cudaGetLastError());
    const FwdKernel kernel = fwd_kernel_for(tile_w, band, deg);
    const size_t smem = fwd_smem_bytes(tile_w, band, rank, deg, sub);
    err = splat::kernel_setup(kernel, smem, nullptr);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<n_blocks, kFwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        masks, order, coords, slabs, a_coeffs, b_coeffs, out, n_words, n_segs, ntx,
        tile_w / parts, parts, tile_h, band, width, rank, deg, sub);
    return static_cast<int>(cudaGetLastError());
}

// What a forward launch for this patch and batch holds (splat::kernel_setup's out).
extern "C" int grace_splat_sortfree_fwd_resources(int* out, int tile_w, int band, int rank,
                                                  int deg, int sub, int device, void* stream) {
    (void)stream;
    if (!fwd_valid(tile_w, band, rank, deg, sub)) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err == cudaSuccess) {
        err = splat::kernel_setup(fwd_kernel_for(tile_w, band, deg),
                                  fwd_smem_bytes(tile_w, band, rank, deg, sub), out);
    }
    return static_cast<int>(err);
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
