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
// Cost: about 25 flops a pair for the hit test, plus |deg| + 1 fmas (and a
// sqrt for deg > 0) for the integral.
#pragma once

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
// it vanishes for u >= 1. seg_pair's weighted branch and the record kernels
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

// Column-density contribution F(b/h) / h^2 (cumulative) or the hit
// indicator (hitcount) of one primitive (x, y, z, 1/h^2, h^2) on one ray.
// coeffs holds |deg| + 1 f32 Horner coefficients, lowest order first:
// deg > 0 is the weighted fit of F / v^3.5 times v^3 sqrt(v) (v = 1 - u),
// deg < 0 the direct fit of F with the u < 1 support test fused in.
__device__ __forceinline__ float seg_pair(const RaySeg& r, float px, float py,
                                          float pz, float inv_h2, float h2,
                                          int mode, const float* coeffs,
                                          int deg) {
    float dot, bx, by, bz;
    const float b2 = impact(px, py, pz, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, dot, bx, by, bz);
    const bool along = (dot >= 0.0f) && (dot < r.len);
    if (mode == kModeHitcount) {
        return (along && b2 < h2) ? 1.0f : 0.0f;
    }
    const float u = b2 * inv_h2;
    if (deg >= 0) {
        return along ? horner1_integral(u, coeffs, deg) * inv_h2 : 0.0f;
    }
    const float t = 2.0f * fminf(u, 1.0f) - 1.0f;
    float acc = coeffs[-deg];
    for (int k = -deg - 1; k >= 0; --k) {
        acc = fmaf(acc, t, coeffs[k]);
    }
    return (along && u < 1.0f) ? acc * inv_h2 : 0.0f;
}
