// Shared-memory staging of primitives for the fused SPH trace kernels
// (trace_quarter.cu, trace_bitmask.cu, trace_list.cu), the record kernels
// (records.cu) and the fused renderer's forward (render.cu); its walk
// (staged_batches) also stages the sort-free backward's cotangent tiles
// (splat_sortfree.cu).
//
// One block per ray tile, one thread per ray. Between a pair of barriers
// the block copies up to kStage primitives' five rows (x, y, z, 1/h^2, h^2:
// 20 KB) from the component-major f32[8, n_pad] slabs into shared memory;
// then every thread tests its ray against the staged primitives in order
// (accumulate_staged). The threads of a warp read the same staged
// primitives at once (a broadcast, no bank conflicts). Sums are
// Kahan-compensated, so a result depends on the visit order only through
// the f32 rounding of each term.
//
// accumulate_staged runs in two phases per 32 staged primitives: the pair
// test of all 32 into a mask, rows read as float4 (one shared load serves
// four primitives), with no integral in the loop; then the term and the
// Kahan update for the set bits only, in ascending order. On the bench
// scene 2% of the tested pairs pass, so the integral, which the TPU form
// evaluated for every pair, leaves the inner loop.
#pragma once

#include <cstdint>

#include "async_copy.cuh"
#include "seg_compute.cuh"

constexpr int kStage = 1024;   // primitives staged per pair of barriers
constexpr int kMaxCoeffs = 32;
constexpr int kMaxTile = 1024;  // rays (threads) a block

// N staged primitives' rows; the trace kernels stage kStage at a time.
template <int N>
struct __align__(16) StagedRows {
    float x[N], y[N], z[N], inv_h2[N], h2[N];
};
using StagedPrims = StagedRows<kStage>;
static_assert(sizeof(StagedPrims) == 5 * kStage * sizeof(float), "rows are back to back");

// Slot i <- primitive p. A p outside [0, n_pad) stages h = 0, which can
// never hit and adds exactly nothing in either mode.
__device__ __forceinline__ void stage_prim(StagedPrims& s, int i,
                                           const float* __restrict__ prims,
                                           int64_t n_pad, int64_t p) {
    const bool ok = p >= 0 && p < n_pad;
    s.x[i] = ok ? __ldg(prims + p) : 0.0f;
    s.y[i] = ok ? __ldg(prims + n_pad + p) : 0.0f;
    s.z[i] = ok ? __ldg(prims + 2 * n_pad + p) : 0.0f;
    s.inv_h2[i] = ok ? __ldg(prims + 4 * n_pad + p) : 0.0f;
    s.h2[i] = ok ? __ldg(prims + 5 * n_pad + p) : 0.0f;
}

// Rows [0, n_rows) of a staging buffer of N slots a row (the rows back to
// back from `rows`), slots [0, k << shift) <- the groups ids(0), ...,
// ids(k - 1) of 1 << shift primitives each: row r of group g is read from
// src(r, g) on, in 16-byte cp.async copies that the caller commits and
// waits for. A group outside [0, n_groups) stages zeros (h = 0, as
// stage_prim). Needs every src(r, g) 16-byte aligned and shift >= 2.
template <int N, typename Ids, typename Src>
__device__ __forceinline__ void stage_rows(float* rows, int n_rows, int k, int shift,
                                           int64_t n_groups, Ids ids, Src src) {
    const int chunks = (k << shift) >> 2;  // 16-byte chunks a row
    for (int c = threadIdx.x; c < n_rows * chunks; c += blockDim.x) {
        const int row = c / chunks;
        const int col = 4 * (c - row * chunks);
        const int64_t g = ids(col >> shift);
        float* dst = rows + row * N + col;
        if (g >= 0 && g < n_groups) {
            cp_async16(dst, src(row, g) + (col & ((1 << shift) - 1)));
        } else {
            *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
    }
}

// The five rows of s <- the groups ids(0), ..., ids(k - 1) of the
// component-major f32[8, n_pad] slabs (x, y, z, 1/h^2, h^2: slab rows
// 0-2, 4, 5), as stage_rows. Needs prims 16-byte aligned and n_pad a
// multiple of 4.
template <int N, typename Ids>
__device__ __forceinline__ void stage_groups(StagedRows<N>& s, int k, int shift,
                                             const float* __restrict__ prims, int64_t n_pad,
                                             Ids ids) {
    stage_rows<N>(reinterpret_cast<float*>(&s), 5, k, shift, n_pad >> shift, ids,
                  [&](int row, int64_t g) {
                      return prims + (row < 3 ? row : row + 1) * n_pad + (g << shift);
                  });
}

// This thread's ray from its f32[16] row (o, d, 1/d, len, ...).
__device__ __forceinline__ RaySeg load_ray(const float* __restrict__ rays,
                                           int64_t ray) {
    const float* rr = rays + ray * 16;
    return RaySeg{rr[0], rr[1], rr[2], rr[3], rr[4], rr[5], rr[9]};
}

// The |deg| + 1 integral coefficients into shared memory; they are read
// only after the block's next barrier.
__device__ __forceinline__ void load_coeffs(float* s_coeffs,
                                            const float* __restrict__ coeffs,
                                            int deg) {
    const int n = (deg < 0 ? -deg : deg) + 1;
    for (int i = threadIdx.x; i < n; i += blockDim.x) s_coeffs[i] = coeffs[i];
}

// Bit q: staged slot base + q passes pair_passes against r; four slots a
// shared load.
template <bool kHitcount, int N>
__device__ __forceinline__ uint32_t pass_bits32(const StagedRows<N>& s, int base,
                                                const RaySeg& r) {
    const float* w = kHitcount ? s.h2 : s.inv_h2;
    uint32_t bits = 0;
#pragma unroll
    for (int q = 0; q < 32; q += 4) {
        const float4 px = *reinterpret_cast<const float4*>(s.x + base + q);
        const float4 py = *reinterpret_cast<const float4*>(s.y + base + q);
        const float4 pz = *reinterpret_cast<const float4*>(s.z + base + q);
        const float4 pw = *reinterpret_cast<const float4*>(w + base + q);
        bits |= pair_passes<kHitcount>(r, px.x, py.x, pz.x, pw.x) << q;
        bits |= pair_passes<kHitcount>(r, px.y, py.y, pz.y, pw.y) << (q + 1);
        bits |= pair_passes<kHitcount>(r, px.z, py.z, pz.z, pw.z) << (q + 2);
        bits |= pair_passes<kHitcount>(r, px.w, py.w, pz.w, pw.w) << (q + 3);
    }
    return bits;
}

// Add this thread's ray against staged slots [0, n) into (acc, comp); n is
// a multiple of 32 (whole quarters or segments). Hitcount mode adds each
// mask's popcount (exact integers). Cumulative mode adds the term of each
// set bit in ascending slot order, b^2 recomputed by the same operations
// as in the test, so the same bits.
__device__ __forceinline__ void accumulate_staged(const StagedPrims& s, int n,
                                                  const RaySeg& r, int mode,
                                                  const float* s_coeffs,
                                                  int deg, float& acc,
                                                  float& comp) {
    if (mode == kModeHitcount) {
        for (int base = 0; base < n; base += 32) {
            acc += static_cast<float>(__popc(pass_bits32<true>(s, base, r)));
        }
        return;
    }
    for (int base = 0; base < n; base += 32) {
        uint32_t bits = pass_bits32<false>(s, base, r);
        while (bits) {
            const int i = base + __ffs(bits) - 1;
            bits &= bits - 1;
            float dot, bx, by, bz;
            const float b2 = impact(s.x[i], s.y[i], s.z[i], r.ox, r.oy, r.oz, r.dx, r.dy,
                                    r.dz, dot, bx, by, bz);
            const float v = seg_term(b2 * s.inv_h2[i], s.inv_h2[i], s_coeffs, deg);
            const float y = v - comp;
            const float t = acc + y;
            comp = (t - acc) - y;
            acc = t;
        }
    }
}

// A block's whole walk through a ring of kBuffers staging buffers:
// stage_next(b) stages the next batch into buffer b with cp.async copies
// and returns a positive tag of it, the same on every thread (the trace
// and record kernels: its primitive count, a multiple of 32), 0 when no
// batch is left; consume(b, n) then reads buffer b's batch of tag n. With
// one buffer: stage, wait, consume, and a barrier before the next copy;
// with two (twice the shared memory), batch b + 1 is copied while batch b
// is consumed.
template <int kBuffers, typename StageNext, typename Consume>
__device__ __forceinline__ void staged_batches(StageNext stage_next, Consume consume) {
    static_assert(kBuffers == 1 || kBuffers == 2, "one or two buffers");
    int n = 0;
    if (kBuffers == 2) {
        n = stage_next(0);
        cp_async_commit();
    }
    for (int b = 0;; ++b) {
        int n_ahead = 0;
        if (kBuffers == 2) {
            if (n > 0) n_ahead = stage_next((b + 1) & 1);  // freed at the end of b - 1
        } else {
            n = stage_next(0);
        }
        cp_async_commit();
        cp_async_wait<kBuffers - 1>();  // batch b has landed
        if (n == 0) break;
        __syncthreads();
        consume(b & (kBuffers - 1), n);
        __syncthreads();  // this buffer is free
        if (kBuffers == 2) n = n_ahead;
    }
}

// The trace kernels' walk: staged_batches over the buffers s[0, kBuffers),
// stage_next(buffer) as above, each batch added by accumulate_staged.
template <int kBuffers, typename StageNext>
__device__ __forceinline__ void trace_staged(StagedPrims* s, StageNext stage_next,
                                             const RaySeg& r, int mode, const float* s_coeffs,
                                             int deg, float& acc, float& comp) {
    staged_batches<kBuffers>([&](int b) { return stage_next(s[b]); },
                             [&](int b, int n) {
                                 accumulate_staged(s[b], n, r, mode, s_coeffs, deg, acc, comp);
                             });
}

// Launch checks shared by the trace entry points.
inline bool trace_launch_ok(int tile, int deg) {
    return tile >= 1 && tile <= kMaxTile && (deg < 0 ? -deg : deg) + 1 <= kMaxCoeffs;
}

// Gives a trace kernel the largest shared-memory carveout (without it the
// runtime may hold fewer 20 KB blocks an SM) and, where out is not null,
// fills out with what one launch of tile threads and dynamic bytes of
// shared memory holds: registers a thread, shared bytes a block (static
// and dynamic), threads a block, resident blocks and warps an SM.
template <typename Kernel>
cudaError_t trace_kernel_setup(Kernel kernel, int tile, int* out, size_t dynamic = 0) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                           cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess || out == nullptr) return err;
    cudaFuncAttributes attr;
    int blocks;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, tile, dynamic);
    }
    if (err != cudaSuccess) return err;
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.sharedSizeBytes + dynamic);
    out[2] = tile;
    out[3] = blocks;
    out[4] = blocks * ((tile + 31) / 32);
    return cudaSuccess;
}
