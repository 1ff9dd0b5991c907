// F(beta) and dF/d(beta^2) of the cubic-spline line integral in the
// Clenshaw form grace_tpu's fused differentiable renderer uses,
// kernel_integrals.cubic_spline_line_integral_poly(b2, fast=True) and its
// _grad: piece 1 is a Chebyshev series in b2 on [0, 1/4], piece 2 is
// v^{7/2} times a series in v = 1 - b2 on [1/4, 1).
//
// The constants come from the wrapper (kernel_integrals.poly_constants),
// packed as f32[kPolySize]: sum1, inv1, scale1, sum2, inv2, scale2 (the
// domain maps t = (2x - sum) * inv and the derivative scales), then the
// series c1 (9 terms), c2 (7), and their derivative series d1 (8), d2 (6).
// Each Clenshaw step is one fused multiply-add and an add, as compiled XLA
// rounds it; the plain PyTorch version (kernel_integrals._clenshaw) does
// the same.
#pragma once

constexpr int kPolyN1 = 9;
constexpr int kPolyN2 = 7;
constexpr int kPolyC1 = 6;
constexpr int kPolyC2 = kPolyC1 + kPolyN1;
constexpr int kPolyD1 = kPolyC2 + kPolyN2;
constexpr int kPolyD2 = kPolyD1 + kPolyN1 - 1;
constexpr int kPolySize = kPolyD2 + kPolyN2 - 1;

__device__ __forceinline__ float clenshaw(const float* c, int n, float t) {
    float b1 = 0.0f, b2 = 0.0f;
    for (int k = n - 1; k >= 1; --k) {
        const float nb = fmaf(2.0f * t, b1, -b2) + c[k];
        b2 = b1;
        b1 = nb;
    }
    return fmaf(t, b1, -b2) + c[0];
}

__device__ __forceinline__ float clamp1(float x) { return fminf(fmaxf(x, -1.0f), 1.0f); }

// F from b2 = (b / h)^2; 0 for b2 >= 1 (render_fwd_kernel).
__device__ __forceinline__ float poly_f(const float* k, float b2) {
    if (b2 <= 0.25f) return clenshaw(k + kPolyC1, kPolyN1, clamp1((2.0f * b2 - k[0]) * k[1]));
    if (!(b2 < 1.0f)) return 0.0f;
    const float v = fmaxf(1.0f - b2, 0.0f);
    const float t2 = clamp1((2.0f * v - k[3]) * k[4]);
    return clenshaw(k + kPolyC2, kPolyN2, t2) * (((v * v) * v) * sqrtf(v));
}

// dF/db2 of the same fit.
__device__ __forceinline__ float poly_df(const float* k, float b2) {
    if (b2 <= 0.25f) {
        return clenshaw(k + kPolyD1, kPolyN1 - 1, clamp1((2.0f * b2 - k[0]) * k[1])) * k[2];
    }
    if (!(b2 < 1.0f)) return 0.0f;
    const float v = fmaxf(1.0f - b2, 0.0f);
    const float t2 = clamp1((2.0f * v - k[3]) * k[4]);
    const float p_v = clenshaw(k + kPolyC2, kPolyN2, t2);
    const float dp_v = clenshaw(k + kPolyD2, kPolyN2 - 1, t2) * k[5];
    const float v2 = v * v;
    const float sq = sqrtf(v);
    return -fmaf((v2 * v) * sq, dp_v, ((3.5f * v2) * sq) * p_v);
}

// F and dF/db2 from one evaluation: the domain map, piece 2's series p_v,
// v, v * v and sqrtf(v) are computed once; each value takes the same
// operations as poly_f and poly_df, so both round to the same bits.
__device__ __forceinline__ void poly_f_df(const float* k, float b2, float& f, float& df) {
    if (b2 <= 0.25f) {
        const float t1 = clamp1((2.0f * b2 - k[0]) * k[1]);
        f = clenshaw(k + kPolyC1, kPolyN1, t1);
        df = clenshaw(k + kPolyD1, kPolyN1 - 1, t1) * k[2];
        return;
    }
    if (!(b2 < 1.0f)) {
        f = df = 0.0f;
        return;
    }
    const float v = fmaxf(1.0f - b2, 0.0f);
    const float t2 = clamp1((2.0f * v - k[3]) * k[4]);
    const float p_v = clenshaw(k + kPolyC2, kPolyN2, t2);
    const float dp_v = clenshaw(k + kPolyD2, kPolyN2 - 1, t2) * k[5];
    const float v2 = v * v;
    const float sq = sqrtf(v);
    f = p_v * ((v2 * v) * sq);
    df = -fmaf((v2 * v) * sq, dp_v, ((3.5f * v2) * sq) * p_v);
}

// The constants into shared memory; read only after the block's next barrier.
__device__ __forceinline__ void load_poly(float* s_poly, const float* __restrict__ poly) {
    for (int i = threadIdx.x; i < kPolySize; i += blockDim.x) s_poly[i] = poly[i];
}
