// The generic engine's BVH walk for the stock functor sets, one thread a ray.
//
// Not a TPU kernel: it replaces grace_tpu/trace/engine.py:100-175, the body
// of the XLA engine's jax.lax.while_loop, which the port ran as a host loop
// of lockstep steps (trace/engine.py: about 25 small launches and one read
// back to the host a step). grace_tpu's engine maps the CUDA original's
// "1 thread = 1 ray" walk (bintree_trace.cuh:52-197) onto all rays stepping
// together because a TPU has no threads; here each thread walks its ray to
// the end with its own stack in local memory.
//
// Order. A ray's stack evolves only from its own data, so the per-ray walk
// visits the same sequence of nodes and leaves as the lockstep walk; the
// lockstep walk only interleaves the rays. Step for step, as engine.trace:
// pop the top entry (read at the column clamped to stack_size - 1); at an
// internal node test both child boxes, overwrite the popped entry with the
// left child if it was hit, else the right, and push the right child on top
// if both were; at a leaf test its <= max_per_leaf primitives in leaf order
// (ids clamped to the primitive array). Pushes past stack_size are dropped
// and the ray's overflow flag is set, so an undersized stack truncates the
// walk exactly as the plain walk does. A walk in that state can repeat one
// entry forever (the plain walk's host loop then never ends); a ray stops
// after 4 (nodes + leaves) + 64 steps, more than any walk that ends takes
// (each node and leaf is taken once, an entry at the stack's top at most
// twice), and its flag says so (2).
//
// Rounding: the plain walk's, operation for operation (built with
// --fmad=false, so nvcc contracts nothing). vecmath.fma is the f64 product
// plus sum rounded once to f32 (fma_f64), dot3 sums z over y over the f32
// x product, square roots are taken in f64, 1 / x is IEEE division, and
// torch.minimum / maximum propagate NaN (min_nan / max_nan; fminf would drop
// it, and (min - o) * inf is NaN for an origin on a box plane with a zero
// direction component). The triangle test is the engine's
// models/triangle.intersect_triangle, not tri.cu's (whose determinant
// rounds another way).
//
// Outputs. Counts, triangle ids, t, occlusion and records are bit-equal to
// the plain walk's; a cumulative sum adds each leaf's terms in leaf order
// and then the leaf's sum, where torch sums a leaf's row in its own order
// (within rtol 1e-5). The record pass writes each hit at its ray's cursor
// (the exclusive scan of the count pass) and drops writes at or past the
// capacity, as functors._scatter_hits does.
//
// What bounds it on this card: the node and primitive tests, a chain of
// dependent loads and compares per step in one thread, with warps diverging
// as their rays take other paths; the loads of a warp's nodes are scattered.
// The design does nothing about that yet: it is the simple walk. The CUDA
// original's warp-cooperative packet walk (bintree_trace.cuh:148-160) and
// closest-hit pruning are the later redesign.

#include <cstdint>

#include "async_copy.cuh"
#include "common.cuh"

namespace {

constexpr int kMaxStack = 128;
constexpr int kThreads = 128;
constexpr float kEps = 1e-7f;   // models/triangle.EPS

constexpr int kCount = 0;       // i32 hit counts
constexpr int kCumulative = 1;  // f32 sums of lerp(table, (N-1) sqrt(b2)/h) / h^2
constexpr int kRecords = 2;     // (index, integral, distance) at each hit's cursor
constexpr int kIds = 3;         // (ray, prim) at each hit's cursor
constexpr int kClosest = 0;
constexpr int kAny = 1;

// vecmath.fma: the f32 product is exact in f64; the sum rounds there, then
// to f32.
__device__ __forceinline__ float fma_f64(float a, float b, float c) {
    return __double2float_rn(static_cast<double>(a) * static_cast<double>(b) +
                             static_cast<double>(c));
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by,
                                      float bz) {
    return fma_f64(az, bz, fma_f64(ay, by, ax * bx));
}

__device__ __forceinline__ float sqrt_f64(float x) {
    return __double2float_rn(sqrt(static_cast<double>(x)));
}

__device__ __forceinline__ float min_nan(float a, float b) {
    return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float max_nan(float a, float b) {
    return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

struct Ray {
    float o[3], d[3], inv[3], len;
};

// ops/intersect.aabbs_hit on one box (min xyz, then max xyz).
__device__ __forceinline__ bool box_hit(const Ray& r, const float* __restrict__ box) {
    float tnear[3], tfar[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float t0 = (__ldg(box + k) - r.o[k]) * r.inv[k];
        const float t1 = (__ldg(box + 3 + k) - r.o[k]) * r.inv[k];
        tnear[k] = min_nan(t0, t1);
        tfar[k] = max_nan(t0, t1);
    }
    const float tmin = max_nan(max_nan(tnear[0], tnear[1]), max_nan(tnear[2], 0.0f));
    const float tmax = min_nan(min_nan(tfar[0], tfar[1]), min_nan(tfar[2], r.len));
    return tmax >= tmin;
}

struct TreeView {
    const int32_t* __restrict__ children;   // [cap, 2]
    const float* __restrict__ child_aabbs;  // [cap, 2, 2, 3]
    const int32_t* __restrict__ leaves;     // [leaf_cap, 2]
    const int32_t* __restrict__ root;       // [] on the device
    int cap, leaf_cap, max_per_leaf, n_prims, stack_size;
};

// The walk of one ray. leaf(p) runs for each primitive id p of a leaf, in
// leaf order, and leaf_end() after the leaf. Returns the per-ray flag: 0,
// 1 where the stack overflowed, 2 where the walk was cut at the step bound
// (an overflowed walk that repeats an entry forever); adds the internal
// nodes and the primitives tested to nodes, tested.
template <class Leaf, class LeafEnd>
__device__ __forceinline__ int walk(const TreeView& t, const Ray& r, Leaf leaf,
                                    LeafEnd leaf_end, int& nodes, int& tested) {
    int stack[kMaxStack];
    const int s = t.stack_size;
    stack[0] = __ldg(t.root);
    int sp = 1;
    int overflow = 0;
    const long long max_steps = 4LL * (t.cap + t.leaf_cap) + 64;
    for (long long step = 0; sp > 0; ++step) {
        if (step == max_steps) return 2;
        const int top_col = sp - 1;
        const int top = stack[min(top_col, s - 1)];
        if (top >= 0) {
            const int node = min(top, t.cap - 1);
            const bool hit_l = box_hit(r, t.child_aabbs + node * 12);
            const bool hit_r = box_hit(r, t.child_aabbs + node * 12 + 6);
            const int left = __ldg(t.children + 2 * node);
            const int right = __ldg(t.children + 2 * node + 1);
            const int n_push = static_cast<int>(hit_l) + static_cast<int>(hit_r);
            if (n_push >= 1 && top_col < s) stack[top_col] = hit_l ? left : right;
            if (n_push == 2 && top_col + 1 < s) stack[top_col + 1] = right;
            sp += n_push - 1;
            overflow |= sp > s;
            ++nodes;
        } else {
            const int lf = min(max(~top, 0), t.leaf_cap - 1);
            const int first = __ldg(t.leaves + 2 * lf);
            const int count = min(__ldg(t.leaves + 2 * lf + 1), t.max_per_leaf);
            for (int j = 0; j < count; ++j) {
                leaf(min(max(first + j, 0), t.n_prims - 1));
            }
            leaf_end();
            tested += max(count, 0);
            sp -= 1;
        }
    }
    return overflow;
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ origins,
                                        const float* __restrict__ directions,
                                        const float* __restrict__ lengths, int i) {
    Ray r;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        r.o[k] = origins[3 * i + k];
        r.d[k] = directions[3 * i + k];
        r.inv[k] = 1.0f / r.d[k];   // ops/intersect.safe_inverse_direction
    }
    r.len = lengths[i];
    return r;
}

// ops/intersect.sphere_hit: hit, b^2 and the distance of closest approach.
__device__ __forceinline__ bool sphere_hit(const Ray& r, float4 s, float& b2, float& dist) {
    const float px = s.x - r.o[0];
    const float py = s.y - r.o[1];
    const float pz = s.z - r.o[2];
    dist = dot3(px, py, pz, r.d[0], r.d[1], r.d[2]);
    const float bx = fma_f64(-dist, r.d[0], px);
    const float by = fma_f64(-dist, r.d[1], py);
    const float bz = fma_f64(-dist, r.d[2], pz);
    b2 = dot3(bx, by, bz, bx, by, bz);
    return b2 < s.w * s.w && dist >= 0.0f && dist < r.len;
}

// functors.sph_integral: lerp(table, (N-1) (sqrt(b2) (1/h))) (1/h)^2, with
// ops/interpolate.lerp's truncation, clamps and fma.
__device__ __forceinline__ float sph_integral(float b2, float h, const float* __restrict__ table,
                                              int n) {
    const float ir = 1.0f / h;
    const float x = static_cast<float>(n - 1) * (sqrt_f64(b2) * ir);
    const int idx = min(max(static_cast<int>(x), 0), n - 2);
    const float top = static_cast<float>(n - 1);
    const float xc = x > top ? top : x;
    const float y0 = __ldg(table + idx);
    const float y1 = __ldg(table + idx + 1);
    return fma_f64(xc - static_cast<float>(idx), y1 - y0, y0) * (ir * ir);
}

struct SphArgs {
    const float* origins;
    const float* directions;
    const float* lengths;
    const float4* spheres;
    const float* table;
    const float* weights;
    const int32_t* cursors;
    void* out0;
    void* out1;
    void* out2;
    int32_t* visits;
    int32_t* overflow;
    int n_rays, table_n, capacity;
};

template <int kMode>
__global__ void __launch_bounds__(kThreads) walk_sph_kernel(TreeView t, SphArgs a) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= a.n_rays) return;
    const Ray r = load_ray(a.origins, a.directions, a.lengths, i);
    int hits = 0;
    int cursor = kMode == kRecords || kMode == kIds ? a.cursors[i] : 0;
    float sum = 0.0f, leaf_sum = 0.0f;
    int nodes = 0, tested = 0;
    auto leaf = [&](int p) {
        const float4 s = __ldg(a.spheres + p);
        float b2, dist;
        if (!sphere_hit(r, s, b2, dist)) return;
        if (kMode == kCount) {
            ++hits;
        } else if (kMode == kCumulative) {
            float term = sph_integral(b2, s.w, a.table, a.table_n);
            if (a.weights != nullptr) term = term * __ldg(a.weights + p);
            leaf_sum += term;
        } else {
            if (cursor < a.capacity) {
                if (kMode == kRecords) {
                    static_cast<int32_t*>(a.out0)[cursor] = p;
                    static_cast<float*>(a.out1)[cursor] = sph_integral(b2, s.w, a.table,
                                                                       a.table_n);
                    static_cast<float*>(a.out2)[cursor] = dist;
                } else {
                    static_cast<int32_t*>(a.out0)[cursor] = i;
                    static_cast<int32_t*>(a.out1)[cursor] = p;
                }
            }
            ++cursor;
        }
    };
    auto leaf_end = [&]() {
        if (kMode == kCumulative) {
            sum += leaf_sum;
            leaf_sum = 0.0f;
        }
    };
    a.overflow[i] = walk(t, r, leaf, leaf_end, nodes, tested);
    if (kMode == kCount) static_cast<int32_t*>(a.out0)[i] = hits;
    if (kMode == kCumulative) static_cast<float*>(a.out0)[i] = sum;
    if (a.visits != nullptr) {
        a.visits[2 * i] = nodes;
        a.visits[2 * i + 1] = tested;
    }
}

// models/triangle.intersect_triangle (Moller-Trumbore with back-face
// culling; only det > eps counts): hit and t.
__device__ __forceinline__ bool triangle_hit(const Ray& r, const float* __restrict__ tri,
                                             float& t) {
    float v0[3], e1[3], e2[3], s[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        v0[k] = __ldg(tri + k);
        e1[k] = __ldg(tri + 3 + k) - v0[k];
        e2[k] = __ldg(tri + 6 + k) - v0[k];
        s[k] = r.o[k] - v0[k];
    }
    const float* d = r.d;
    const float px = fma_f64(d[1], e2[2], -(d[2] * e2[1]));
    const float py = fma_f64(d[2], e2[0], -(d[0] * e2[2]));
    const float pz = fma_f64(d[0], e2[1], -(d[1] * e2[0]));
    const float det = dot3(e1[0], e1[1], e1[2], px, py, pz);
    const float inv_det = 1.0f / (fabsf(det) > kEps ? det : kEps);
    const float u = dot3(s[0], s[1], s[2], px, py, pz) * inv_det;
    const float qx = fma_f64(s[1], e1[2], -(s[2] * e1[1]));
    const float qy = fma_f64(s[2], e1[0], -(s[0] * e1[2]));
    const float qz = fma_f64(s[0], e1[1], -(s[1] * e1[0]));
    const float v = dot3(d[0], d[1], d[2], qx, qy, qz) * inv_det;
    t = dot3(e2[0], e2[1], e2[2], qx, qy, qz) * inv_det;
    return det > kEps && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f && t > kEps &&
           t < r.len;
}

struct TriArgs {
    const float* origins;
    const float* directions;
    const float* lengths;
    const float* tris;   // [n, 3, 3]
    void* out0;          // closest: f32 t (inf: no hit); any: bool occluded
    int32_t* out1;       // closest: i32 triangle (-1: no hit)
    int32_t* visits;
    int32_t* overflow;
    int n_rays;
};

// Closest: the least t by a strict < in walk order, so a tie keeps the first
// triangle (trace_closest_hit's argmin a leaf, then a strict < across
// leaves). Any: whether any triangle is hit; the walk still runs to its end,
// as the plain walk's does (the overflow flag covers all of it).
template <int kMode>
__global__ void __launch_bounds__(kThreads) walk_tri_kernel(TreeView t, TriArgs a) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= a.n_rays) return;
    const Ray r = load_ray(a.origins, a.directions, a.lengths, i);
    float t_min = __int_as_float(0x7f800000);
    int best = -1;
    bool occluded = false;
    int nodes = 0, tested = 0;
    auto leaf = [&](int p) {
        float tp;
        if (!triangle_hit(r, a.tris + 9 * p, tp)) return;
        if (kMode == kAny) {
            occluded = true;
        } else if (tp < t_min) {
            t_min = tp;
            best = p;
        }
    };
    a.overflow[i] = walk(t, r, leaf, [] {}, nodes, tested);
    if (kMode == kAny) {
        static_cast<bool*>(a.out0)[i] = occluded;
    } else {
        static_cast<float*>(a.out0)[i] = t_min;
        a.out1[i] = best;
    }
    if (a.visits != nullptr) {
        a.visits[2 * i] = nodes;
        a.visits[2 * i + 1] = tested;
    }
}

bool tree_ok(const TreeView& t) {
    return t.children && t.child_aabbs && t.leaves && t.root && t.cap >= 1 &&
           t.leaf_cap >= 1 && t.max_per_leaf >= 1 && t.n_prims >= 1 && t.stack_size >= 1 &&
           t.stack_size <= kMaxStack;
}

int blocks(int n_rays) { return (n_rays + kThreads - 1) / kThreads; }

}  // namespace

// One launch of the SPH walk. mode 0 (count): out0 i32[R] hit counts.
// mode 1 (cumulative): out0 f32[R] sums over table f32[table_n], times
// weights[p] where weights is not null. mode 2 (records): each hit's
// (index i32, integral f32, distance f32) into out0, out1, out2 at the
// ray's cursor (cursors i32[R], advancing by one a hit), writes at or past
// capacity dropped. mode 3 (ids): (ray i32, prim i32) into out0, out1 the
// same way. overflow i32[R]: 1 where the stack overflowed, 2 where the
// walk was cut at the step bound (walk's flag). visits (i32[R,
// 2], or null): internal nodes tested, primitives tested.
extern "C" int grace_walk_sph(const float* origins, const float* directions,
                              const float* lengths, const float* spheres,
                              const int32_t* children, const float* child_aabbs,
                              const int32_t* leaves, const int32_t* root, const float* table,
                              const float* weights, const int32_t* cursors, void* out0,
                              void* out1, void* out2, int32_t* visits, int32_t* overflow,
                              int n_rays, int n_prims, int cap, int leaf_cap, int max_per_leaf,
                              int stack_size, int table_n, int mode, int capacity, int device,
                              void* stream) {
    const TreeView t{children, child_aabbs, leaves, root, cap, leaf_cap, max_per_leaf, n_prims,
                     stack_size};
    const SphArgs a{origins, directions, lengths, reinterpret_cast<const float4*>(spheres),
                    table, weights, cursors, out0, out1, out2, visits, overflow, n_rays,
                    table_n, capacity};
    const bool uses_table = mode == kCumulative || mode == kRecords;
    const bool writes = mode == kRecords || mode == kIds;
    if (mode < kCount || mode > kIds || n_rays < 0 || !tree_ok(t) || !origins ||
        !directions || !lengths || !spheres || !aligned16(spheres) || !overflow || !out0 ||
        (uses_table && (!table || table_n < 2)) ||
        (writes && (!cursors || !out1 || capacity < 0)) || (mode == kRecords && !out2)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_rays > 0) {
        const auto s = static_cast<cudaStream_t>(stream);
        switch (mode) {
            case kCount: walk_sph_kernel<kCount><<<blocks(n_rays), kThreads, 0, s>>>(t, a); break;
            case kCumulative:
                walk_sph_kernel<kCumulative><<<blocks(n_rays), kThreads, 0, s>>>(t, a);
                break;
            case kRecords:
                walk_sph_kernel<kRecords><<<blocks(n_rays), kThreads, 0, s>>>(t, a);
                break;
            default: walk_sph_kernel<kIds><<<blocks(n_rays), kThreads, 0, s>>>(t, a); break;
        }
    }
    return static_cast<int>(cudaGetLastError());
}

// One launch of the triangle walk over tris f32[n_prims, 3, 3]. mode 0
// (closest): out0 f32[R] least t (inf: no hit), out1 i32[R] its triangle
// (-1: no hit). mode 1 (any): out0 bool[R] occluded. overflow and visits as
// grace_walk_sph's.
extern "C" int grace_walk_tri(const float* origins, const float* directions,
                              const float* lengths, const float* tris, const int32_t* children,
                              const float* child_aabbs, const int32_t* leaves,
                              const int32_t* root, void* out0, int32_t* out1, int32_t* visits,
                              int32_t* overflow, int n_rays, int n_prims, int cap, int leaf_cap,
                              int max_per_leaf, int stack_size, int mode, int device,
                              void* stream) {
    const TreeView t{children, child_aabbs, leaves, root, cap, leaf_cap, max_per_leaf, n_prims,
                     stack_size};
    const TriArgs a{origins, directions, lengths, tris, out0, out1, visits, overflow, n_rays};
    if ((mode != kClosest && mode != kAny) || n_rays < 0 || !tree_ok(t) || !origins ||
        !directions || !lengths || !tris || !overflow || !out0 ||
        (mode == kClosest && !out1)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_rays > 0) {
        const auto s = static_cast<cudaStream_t>(stream);
        if (mode == kClosest) {
            walk_tri_kernel<kClosest><<<blocks(n_rays), kThreads, 0, s>>>(t, a);
        } else {
            walk_tri_kernel<kAny><<<blocks(n_rays), kThreads, 0, s>>>(t, a);
        }
    }
    return static_cast<int>(cudaGetLastError());
}

// What one launch holds: out = registers a thread, shared bytes a block,
// threads a block, resident blocks and warps an SM; local bytes (the
// stack) are in ptxas's output. kind 0: the SPH walk in mode `mode`; 1:
// the triangle walk in mode `mode`.
extern "C" int grace_walk_resources(int* out, int kind, int mode, int device, void* stream) {
    (void)stream;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const void* kernels[2][4] = {
        {reinterpret_cast<const void*>(walk_sph_kernel<kCount>),
         reinterpret_cast<const void*>(walk_sph_kernel<kCumulative>),
         reinterpret_cast<const void*>(walk_sph_kernel<kRecords>),
         reinterpret_cast<const void*>(walk_sph_kernel<kIds>)},
        {reinterpret_cast<const void*>(walk_tri_kernel<kClosest>),
         reinterpret_cast<const void*>(walk_tri_kernel<kAny>), nullptr, nullptr}};
    if (kind < 0 || kind > 1 || mode < 0 || mode > 3 || !kernels[kind][mode]) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const void* kernel = kernels[kind][mode];
    cudaFuncAttributes attr;
    int n_blocks;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n_blocks, kernel, kThreads, 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.sharedSizeBytes);
    out[2] = kThreads;
    out[3] = n_blocks;
    out[4] = n_blocks * kThreads / 32;
    return 0;
}
