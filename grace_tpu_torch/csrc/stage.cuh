// Shared-memory staging of primitives for the fused SPH trace kernels
// (trace_quarter.cu, trace_bitmask.cu, trace_list.cu).
//
// One block per ray tile, one thread per ray. Between a pair of barriers
// the block copies up to kStage primitives' five rows (x, y, z, 1/h^2, h^2:
// 20 KB) from the component-major f32[8, n_pad] slabs into shared memory;
// then every thread runs seg_pair against each staged primitive in order.
// The threads of a warp read the same staged primitive at once (a
// broadcast, no bank conflicts). Sums are Kahan-compensated, so a result
// depends on the visit order only through the f32 rounding of each term.
#pragma once

#include <cstdint>

#include "seg_compute.cuh"

constexpr int kStage = 1024;   // primitives staged per pair of barriers
constexpr int kMaxCoeffs = 32;

struct StagedPrims {
    float x[kStage], y[kStage], z[kStage], inv_h2[kStage], h2[kStage];
};

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

// Add this thread's ray against staged slots [0, n) into (acc, comp).
__device__ __forceinline__ void accumulate_staged(const StagedPrims& s, int n,
                                                  const RaySeg& r, int mode,
                                                  const float* s_coeffs,
                                                  int deg, float& acc,
                                                  float& comp) {
    for (int i = 0; i < n; ++i) {
        const float v = seg_pair(r, s.x[i], s.y[i], s.z[i], s.inv_h2[i],
                                 s.h2[i], mode, s_coeffs, deg);
        const float y = v - comp;
        const float t = acc + y;
        comp = (t - acc) - y;
        acc = t;
    }
}

// Launch checks shared by the trace entry points.
inline bool trace_launch_ok(int tile, int deg) {
    return tile >= 1 && tile <= 1024 && (deg < 0 ? -deg : deg) + 1 <= kMaxCoeffs;
}
