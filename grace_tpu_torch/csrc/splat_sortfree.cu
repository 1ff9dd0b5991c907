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
// tiles of its transposed mask row (no list, so no capacity), in ascending
// order. For each tile every thread accumulates, for k = 1..rank,
//     P_k(i) = sum_j G_ij b_k(j),  Q_k(i) = sum_j G_ij b'_k(j) dtx/dpu(j),
//     R_k(i) = sum_j G_ij b'_k(j) dtx/dlog(invh)(j)
// over the tile's rows i, then contracts them with its own a_k(i) and
// a'_k(i): g_scale += a P, g_pu += a Q, g_pv += a' dty/dpv P,
// g_t2 += a' dty/dlog(invh) P + a R. That is M_k = G^T A_k and
// N_k = G B_k without storing either. Particles with scale 0 write zero
// rows.
//
// What bounds it: 3 fmas per (row, column, rank) of a particle's
// footprint in the tile, the factor build (a Horner value and derivative
// per rank and footprint row or column), and the shared loads of the
// cotangent tile G. The design: outside a particle's footprint every term
// is exactly +-0 (b = (1 - 1) q(1), and the derivative terms carry
// in_x / in_y = 0), and fmaf(x, +-0, acc) leaves acc as it is, so a
// thread runs only the rows and columns of its own footprint
// (splat_common.cuh's support_range: O(1), the closed form trimmed by the
// exact test) and a particle outside the tile does nothing. Per rank it
// takes the footprint's rows kBwdRows at a time (P, Q, R in registers:
// no runtime index), builds each column's factors once a pass and each
// row's once, with the Horner loop unrolled for the bases' degrees (8,
// 10); each particle keeps the order of additions of the earlier design
// (per k: columns ascending into each row's P, Q, R, then rows ascending
// into the four sums), so the gradients keep its bits up to the sign of
// an all-zero sum. G is staged column-major (the rows of a column back to
// back: the rows of a pass are one immediate offset apart) with 4-byte
// cp.async copies through stage.cuh's walk (staged_batches). The segments
// launch as listed, block b on segment b: their work is even on the
// bench scene (10,096 footprint products a segment on average, 11,970 at
// most), and most listed tiles first took 4-5% off the kernel, 0.04-0.05
// ms, for an order that costs 0.13-0.21 ms (chip_ablation.py
// sortfree_bwd builds that variant).

#include <cstdint>

#include "async_copy.cuh"
#include "common.cuh"
#include "splat_common.cuh"
#include "stage.cuh"

namespace {

using splat::kRows;
constexpr int kFwdThreads = splat::kThreads;
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

// alpha(t) = (1 - t) q(t) and its t-derivative q'(t) (1 - t) - q(t), one
// Horner loop for both; DEG > 0 fixes the degree at compile time (the
// loop unrolled), DEG = 0 takes deg at run time. The same operations
// either way.
template <int DEG>
__device__ __forceinline__ void poly_and_deriv(const float* c, int deg, float t, float& val,
                                               float& der) {
    const int d0 = DEG > 0 ? DEG : deg;
    const float m = 1.0f - t;
    float q = c[d0];
    float dq = 0.0f;
#pragma unroll
    for (int d = d0 - 1; d >= 0; --d) {
        dq = fmaf(dq, t, q);
        q = fmaf(q, t, c[d]);
    }
    val = q * m;
    der = fmaf(dq, m, -q);
}

// Footprint rows a pass (P, Q, R in registers) and cotangent tiles staged
// at a time. On the bench scene (chip_ablation.py sortfree_bwd), 4 rows a
// pass took 18-22% longer (more passes, each rebuilding the column
// factors), 12 rows 11-12% and 16 rows 2-3% longer (96 registers: 20 warps
// an SM, not 28); a second buffer, the next tile in flight, 10-27% longer
// (20 warps).
constexpr int kBwdRows = 8;
constexpr int kBwdBuffers = 1;

// Floats between two columns of a staged cotangent tile: tile_w rows and
// at least kBwdRows - 1 zero rows (a pass may run past the tile's last
// row), rounded up to a multiple of 8. On the bench scene the rounded
// stride (40 at tile_w 32) ran 11-13% faster than tile_w + kBwdRows - 1
// (chip_ablation.py sortfree_bwd); the inner loop's code is the same, and
// the cause was not found.
__host__ __device__ inline int bwd_col_stride(int tile_w) {
    return (tile_w + kBwdRows + 6) / 8 * 8;
}

// Floats of a staging buffer: the tile, its column and row centres.
__host__ __device__ inline int bwd_buffer_floats(int tile_w, int tile_h) {
    return tile_h * bwd_col_stride(tile_w) + tile_h + tile_w;
}

size_t bwd_smem_bytes(int tile_w, int tile_h, int rank, int deg) {
    return sizeof(float) * (static_cast<size_t>(kBwdBuffers) * bwd_buffer_floats(tile_w, tile_h) +
                            2 * rank * (deg + 1));
}

// One particle's terms over a staged tile: its footprint rows [r.x, r.y)
// and columns [c.x, c.y); g the column-major tile (column stride gs), xs
// and ys its centres, ca and cb the basis coefficients.
template <int DEG>
__device__ __forceinline__ void bwd_footprint(const float* g, int gs, const float* xs,
                                              const float* ys, const float* ca, const float* cb,
                                              int rank, int deg, int2 r, int2 c, float pu, float pv,
                                              float invh, float& g_pu, float& g_pv, float& g_t2,
                                              float& g_s) {
    const int n_c = (DEG > 0 ? DEG : deg) + 1;
    for (int k = 0; k < rank; ++k) {
        const float* ck_a = ca + k * n_c;
        const float* ck_b = cb + k * n_c;
        for (int rb = r.x; rb < r.y; rb += kBwdRows) {
            float p_s[kBwdRows], q_s[kBwdRows], r_s[kBwdRows];
#pragma unroll
            for (int u = 0; u < kBwdRows; ++u) p_s[u] = q_s[u] = r_s[u] = 0.0f;
            for (int j = c.x; j < c.y; ++j) {
                const float xb = (xs[j] - pu) * invh;
                const float xb2 = xb * xb;  // < 1: in_x = 1
                float b_v, b_d;
                poly_and_deriv<DEG>(ck_b, deg, xb2, b_v, b_d);
                const float bq = b_d * ((-2.0f * xb) * invh);
                const float br = b_d * (2.0f * xb2);
                const float* gj = g + j * gs + rb;
#pragma unroll
                for (int u = 0; u < kBwdRows; ++u) {
                    const float gv = gj[u];
                    p_s[u] = fmaf(gv, b_v, p_s[u]);
                    q_s[u] = fmaf(gv, bq, q_s[u]);
                    r_s[u] = fmaf(gv, br, r_s[u]);
                }
            }
#pragma unroll
            for (int u = 0; u < kBwdRows; ++u) {
                if (rb + u < r.y) {
                    const float ya = (ys[rb + u] - pv) * invh;
                    const float ya2 = ya * ya;  // < 1: in_y = 1
                    float a_v, a_d;
                    poly_and_deriv<DEG>(ck_a, deg, ya2, a_v, a_d);
                    const float ap = a_d * p_s[u];
                    g_s = fmaf(a_v, p_s[u], g_s);
                    g_pu = fmaf(a_v, q_s[u], g_pu);
                    g_pv = fmaf(ap, (-2.0f * ya) * invh, g_pv);
                    g_t2 = fmaf(ap, 2.0f * ya2, fmaf(a_v, r_s[u], g_t2));
                }
            }
        }
    }
}

template <int DEG>
__global__ void __launch_bounds__(kSeg)
sortfree_bwd_kernel(const int32_t* __restrict__ masks_t, const float* __restrict__ coords,
                    const float* __restrict__ slabs, const float* __restrict__ g_image,
                    const float* __restrict__ a_coeffs, const float* __restrict__ b_coeffs,
                    float* __restrict__ out, int n_twords, int n_tiles, int ntx, int tile_w,
                    int tile_h, int width, int rank, int deg) {
    extern __shared__ float smem[];
    const int n_c = rank * (deg + 1);
    const int gs = bwd_col_stride(tile_w);
    const int per_buffer = bwd_buffer_floats(tile_w, tile_h);
    float* ca = smem + kBwdBuffers * per_buffer;  // [rank][deg + 1]
    float* cb = ca + n_c;
    // buffer b: the tile [tile_h][gs], then xs [tile_h], ys [tile_w]
    auto tile_of = [&](int b) { return smem + b * per_buffer; };

    const int seg = static_cast<int>(blockIdx.x);
    const int tid = threadIdx.x;
    const Coords cc = load_coords(coords);
    const float* s = slabs + static_cast<int64_t>(seg) * 8 * kSeg;
    const float pu = s[tid], pv = s[kSeg + tid], invh = s[2 * kSeg + tid];
    const float scl = s[3 * kSeg + tid];
    for (int i = tid; i < n_c; i += kSeg) {
        ca[i] = a_coeffs[i];
        cb[i] = b_coeffs[i];
    }
    const int pad = gs - tile_w;  // zero rows under each column, never staged
    for (int b = 0; b < kBwdBuffers; ++b) {
        for (int e = tid; e < tile_h * pad; e += kSeg) {
            tile_of(b)[e / pad * gs + tile_w + e % pad] = 0.0f;
        }
    }

    // The listed tiles in ascending order, the same on every thread.
    const int32_t* row = masks_t + static_cast<int64_t>(seg) * n_twords;
    int w = 0;
    unsigned bits = n_twords > 0 ? mask_word(row, 0, n_twords, n_tiles) : 0u;
    // The next listed tile's cotangents (column-major) and centres into
    // buffer b; returns the tile + 1, 0 past the last.
    auto stage_next = [&](int b) {
        while (bits == 0) {
            if (++w >= n_twords) return 0;
            bits = mask_word(row, w, n_twords, n_tiles);
        }
        const int t = w * 32 + __ffs(bits) - 1;
        bits &= bits - 1;
        const int row0 = (t / ntx) * tile_w;
        const int col0 = (t % ntx) * tile_h;
        float* g = tile_of(b);
        for (int e = tid; e < tile_w * tile_h; e += kSeg) {
            const int i = e / tile_h;
            const int j = e - i * tile_h;
            cp_async4(g + j * gs + i, g_image + static_cast<int64_t>(row0 + i) * width + col0 + j);
        }
        float* xs = g + tile_h * gs;
        float* ys = xs + tile_h;
        for (int j = tid; j < tile_h; j += kSeg) {
            xs[j] = fmaf(static_cast<float>(col0 + j), cc.dx, cc.x0);
        }
        for (int i = tid; i < tile_w; i += kSeg) {
            ys[i] = fmaf(static_cast<float>(row0 + i), cc.dy, cc.y0);
        }
        return t + 1;
    };

    float g_pu = 0.0f, g_pv = 0.0f, g_t2 = 0.0f, g_s = 0.0f;
    const bool live = scl != 0.0f;
    auto consume = [&](int b, int) {
        if (!live) return;
        const float* g = tile_of(b);
        const float* xs = g + tile_h * gs;
        const float* ys = xs + tile_h;
        const int2 r = splat::support_range(ys, tile_w, splat::inverse_step(ys, tile_w), pv, invh);
        if (r.x == r.y) return;
        const int2 c = splat::support_range(xs, tile_h, splat::inverse_step(xs, tile_h), pu, invh);
        if (c.x == c.y) return;
        bwd_footprint<DEG>(g, gs, xs, ys, ca, cb, rank, deg, r, c, pu, pv, invh, g_pu, g_pv, g_t2,
                           g_s);
    };
    staged_batches<kBwdBuffers>(stage_next, consume);

    float* o = out + static_cast<int64_t>(seg) * 8 * kSeg;
    o[tid] = live ? g_pu * scl : 0.0f;
    o[kSeg + tid] = live ? g_pv * scl : 0.0f;
    o[2 * kSeg + tid] = live ? g_t2 * scl : 0.0f;
    o[3 * kSeg + tid] = live ? g_s : 0.0f;
    for (int r = 4; r < 8; ++r) o[r * kSeg + tid] = 0.0f;
}

using BwdKernel = void (*)(const int32_t*, const float*, const float*, const float*,
                           const float*, const float*, float*, int, int, int, int, int, int, int,
                           int);

BwdKernel bwd_kernel_for(int deg) {
    return deg == 8 ? sortfree_bwd_kernel<8>
                    : deg == 10 ? sortfree_bwd_kernel<10> : sortfree_bwd_kernel<0>;
}

bool bwd_valid(int tile_w, int tile_h, int rank, int deg) {
    return tile_w >= 1 && tile_h >= 1 && rank >= 1 && deg >= 0 &&
           bwd_smem_bytes(tile_w, tile_h, rank, deg) <= splat::kMaxShared;
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

// Backward: one block of 128 threads per segment; a tile whose staged
// cotangents do not fit in a block's shared memory is refused.
extern "C" int grace_splat_sortfree_bwd(const int32_t* masks_t, const float* coords,
                                        const float* slabs, const float* g_image,
                                        const float* a_coeffs, const float* b_coeffs, float* out,
                                        int n_segs, int n_twords, int n_tiles, int ntx,
                                        int tile_w, int tile_h, int width, int rank, int deg,
                                        int device, void* stream) {
    if (!bwd_valid(tile_w, tile_h, rank, deg) || n_twords != (n_tiles + 31) / 32) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_segs == 0) return static_cast<int>(cudaGetLastError());
    const BwdKernel kernel = bwd_kernel_for(deg);
    const size_t smem = bwd_smem_bytes(tile_w, tile_h, rank, deg);
    err = splat::kernel_setup(kernel, smem, nullptr, kSeg);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<n_segs, kSeg, smem, static_cast<cudaStream_t>(stream)>>>(
        masks_t, coords, slabs, g_image, a_coeffs, b_coeffs, out, n_twords, n_tiles, ntx, tile_w,
        tile_h, width, rank, deg);
    return static_cast<int>(cudaGetLastError());
}

// What a backward launch for this tile holds (splat::kernel_setup's out).
extern "C" int grace_splat_sortfree_bwd_resources(int* out, int tile_w, int tile_h, int rank,
                                                  int deg, int device, void* stream) {
    (void)stream;
    if (!bwd_valid(tile_w, tile_h, rank, deg)) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err == cudaSuccess) {
        err = splat::kernel_setup(bwd_kernel_for(deg), bwd_smem_bytes(tile_w, tile_h, rank, deg),
                                  out, kSeg);
    }
    return static_cast<int>(err);
}
