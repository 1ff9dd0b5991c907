// One (ray, primitive) pair of the fused SPH trace.
//
// Replaces grace_tpu/trace/pallas_kernel.py::_seg_compute, the TPU inner
// block over (tile rays x 128 primitives). On this card a pair is one
// thread's scalar work, so the block structure goes; what stays is the
// arithmetic, operation for operation: the fused multiply-adds are written
// as fmaf at exactly the places grace_tpu's compiled form contracts them
// (the file is built with --fmad=false so nvcc adds no others), and the
// plain PyTorch version (pallas_kernel._seg_compute) rounds the same way.
// That keeps hit counts (b^2 < h^2) exact against it.
//
// The TPU form evaluates the integral for every pair and lets it vanish
// outside the support (its vector unit has no use for a branch). Here the
// pair test (pair_passes, about 18 operations) decides first, and only the
// pairs that pass take the integral (seg_term: |deg| + 1 fmas, and a sqrt
// for deg > 0); every pair it skips has a term of exactly +-0.
#pragma once

#include <cstdint>

constexpr int kModeCumulative = 0;
constexpr int kModeHitcount = 1;

struct RaySeg {
    float ox, oy, oz, dx, dy, dz, len;
};

// b^2 of a particle at p against the ray (o, d): the distance along the
// ray to the closest approach goes to dot, the impact vector to (bx, by, bz).
__device__ __forceinline__ float impact(float px, float py, float pz, float ox, float oy,
                                        float oz, float dx, float dy, float dz, float& dot,
                                        float& bx, float& by, float& bz) {
    const float rx = px - ox;
    const float ry = py - oy;
    const float rz = pz - oz;
    dot = fmaf(rz, dz, fmaf(rx, dx, ry * dy));
    bx = fmaf(-dot, dx, rx);
    by = fmaf(-dot, dy, ry);
    bz = fmaf(-dot, dz, rz);
    return fmaf(bz, bz, fmaf(bx, bx, by * by));
}

// The weighted-fit line integral F(b/h) of u = b^2/h^2 (deg >= 0): Horner in
// t = 2 min(u, 1) - 1, times v^3 sqrt(v) with v = max(1 - min(u, 1), 0), so
// it vanishes for u >= 1. seg_term's weighted branch and the record kernels
// (records.cu) share it.
__device__ __forceinline__ float horner1_integral(float u, const float* coeffs,
                                                  int deg) {
    const float uc = fminf(u, 1.0f);
    const float t = 2.0f * uc - 1.0f;
    float acc = coeffs[deg];
    for (int k = deg - 1; k >= 0; --k) {
        acc = fmaf(acc, t, coeffs[k]);
    }
    const float v = fmaxf(1.0f - uc, 0.0f);
    return acc * ((v * v) * (v * sqrtf(v)));
}

// Whether a primitive at p passes the test of one ray: it lies along the
// ray (0 <= r.d < len) and, in hitcount mode (w = h^2), b^2 < h^2; in
// cumulative mode (w = 1/h^2), u = b^2 / h^2 < 1, the support of its term.
template <bool kHitcount>
__device__ __forceinline__ uint32_t pair_passes(const RaySeg& r, float px, float py, float pz,
                                                float w) {
    float dot, bx, by, bz;
    const float b2 = impact(px, py, pz, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, dot, bx, by, bz);
    const bool in = kHitcount ? b2 < w : b2 * w < 1.0f;
    return (in && dot >= 0.0f && dot < r.len) ? 1u : 0u;
}

// Column-density term F(b/h) / h^2 of a primitive with 1/h^2 = inv_h2 at
// u = b^2 / h^2. coeffs holds |deg| + 1 f32 Horner coefficients, lowest
// order first: deg >= 0 is the weighted fit (horner1_integral), exactly
// +-0 for u >= 1; deg < 0 the direct fit of F, which is taken only where
// u < 1. So a pair outside along && u < 1 adds nothing, and is skipped.
__device__ __forceinline__ float seg_term(float u, float inv_h2, const float* coeffs, int deg) {
    if (deg >= 0) return horner1_integral(u, coeffs, deg) * inv_h2;
    const float t = 2.0f * fminf(u, 1.0f) - 1.0f;
    float acc = coeffs[-deg];
    for (int k = -deg - 1; k >= 0; --k) {
        acc = fmaf(acc, t, coeffs[k]);
    }
    return acc * inv_h2;
}
