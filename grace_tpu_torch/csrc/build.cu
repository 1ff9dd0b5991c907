// The LBVH build on the card: Morton keys, adjacent deltas and the two
// bottom-up climbs that make the tree.
//
// Not a TPU kernel: it replaces grace_tpu/build/sph.py:30-149 (keys, the
// pipeline), grace_tpu/build/deltas.py:26-111 and grace_tpu/ops/morton.py:99,
// plain XLA, and grace_tpu/build/lbvh.py:217-370 (build_lbvh), whose
// Cartesian-tree ranges (sparse max table and binary skip searches,
// cartesian_tree_ranges, :105), leaf coalescing (:130) and child boxes
// (range reductions over a power-of-two tree) exist because atomics and
// data-dependent loops are hostile to XLA. The port ran that form eagerly:
// about 2,000-3,300 small torch launches a build, whatever N. Here the tree
// is built as the CUDA original builds it (albvh.cuh:76-234 and :303-670):
// two Apetrei climbs coordinated by atomicAdd.
//
// morton_keys_kernel: one thread a centroid. Per axis scale = span / (max -
// min) and u = uint32(scale * (c - min)), each operation rounded in f32
// (--fmad=false: no contraction); the conversion truncates toward zero,
// saturates at [0, 2^32 - 1] and maps NaN to 0 (a degenerate axis gives inf
// * 0 = NaN, so 0); then the bits are spread (10 or 21 a axis) and
// interleaved z, y, x. 63-bit keys are one int64 value, (hi << 32) | lo.
//
// deltas_kernel: one thread a pair (j, j + 1) of sorted primitives.
// Euclidean: the port's vecmath.dot3 of the centroid difference (x * x in
// f32, then two multiply-adds that each take the exact f64 product plus
// the sum, rounded once to f32). Surface area: the union box's e0 e2, e0 e1,
// e1 e2 in deltas.surface_area_deltas' order, with torch.minimum /
// maximum's NaN rule. XOR of 30-bit keys; of 63-bit keys compressed to
// (bit_length << 26) | the 26 bits below the leading bit (__clzll).
//
// ranges_kernel (phase A): one thread a primitive climbs from its leaf. A
// node over leaves [L, R] is the left child of split R when L == 0 or d[L -
// 1] >= d[R] (ties go right: the parent is the split at R), else the right
// child of split L - 1; the ends of the sequence count as larger than any
// delta. A child writes its end of the parent's range (l[p] = L as a left
// child, r[p] = R as a right child), fences and takes the parent's flag
// with atomicAdd: the first arrival exits, the second reads the sibling's
// end through a volatile load and climbs on with [l[p], r[p]]. The atomic
// decides only who climbs, never what is written: every value has a fixed
// slot, so every arrival order gives the same bits. That tree is the
// Cartesian tree of the deltas, max at the root, ties leftmost
// (grace_tpu/build/lbvh.py:1-33): l and r equal cartesian_tree_ranges'.
// The thread that completes split p applies coalesce_leaves' rule: a child
// of at most max_per_leaf primitives is a big leaf where its sibling is
// not small, or both are but p is not; it writes the leaf's first primitive
// and count at the slot of the leaf's first (left child) or last (right
// child) primitive and marks the slot. The k-th marked slot in ascending
// position is leaf k: a prefix sum of the marks (torch.cumsum) compacts
// them, as grace_tpu's stable argsort does.
//
// nodes_kernel (phase B): one thread a slot; a marked slot's thread holds
// leaf k = scan - 1, unions the boxes of its <= max_per_leaf primitives
// in order and climbs the same rule over the leaves, reading the leaf
// boundary deltas in place (the delta left of leaf L is d[first(L) - 1],
// right of leaf R d[last(R)]). Each arrival writes its entry (~k for a
// leaf, the split for a node) into children[p][side], its box into
// child_aabbs[p][side] and its range ends into a scratch row; the second
// arrival unions both boxes and climbs on; the node over [0, n_leaves - 1]
// writes root. n_leaves is read from the scan on the card: the grid is
// sized by N. Threads past the valid rows write the plain build's padding
// (children 0, boxes (+inf, -inf), leaves 0). Min and max are exact, so
// the union's order changes no bit but a signed zero's or a NaN's.
//
// What bounds it: memory, and the climbs' latency. Each primitive's data is
// read once or twice and the tree written once (a few tens of bytes a
// primitive, 30-40 MB at 2^20); a climb's steps are dependent loads and an
// atomic in L2, and the longest climb is as deep as the tree. The design
// keeps every phase one launch over all N, with no host round trip.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kEuclidean = 0;
constexpr int kSurfaceArea = 1;
constexpr int kXor30 = 2;
constexpr int kXor63 = 3;
constexpr int kMantissaBits = 26;

int grid(int n) { return (n + kThreads - 1) / kThreads; }

// torch.minimum / maximum on the card: a NaN operand propagates (the first
// one), else fminf / fmaxf.
__device__ __forceinline__ float torch_min(float a, float b) {
    return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float torch_max(float a, float b) {
    return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// vecmath.fma: the exact f64 product plus c, rounded to f64, then to f32.
__device__ __forceinline__ float fma_f64(float a, float b, float c) {
    return __double2float_rn(static_cast<double>(a) * static_cast<double>(b) +
                             static_cast<double>(c));
}

// morton.f32_to_u32: truncate toward zero, saturate at [0, 2^32 - 1], NaN -> 0.
__device__ __forceinline__ unsigned long long f32_to_u32(float v) {
    if (v != v) return 0ull;
    const double x = fmin(fmax(static_cast<double>(v), 0.0), 4294967295.0);
    return static_cast<unsigned long long>(x);
}

__device__ __forceinline__ unsigned long long spread10(unsigned long long x) {
    x &= (1ull << 10) - 1;
    x = (x | (x << 16)) & 0x030000FFull;
    x = (x | (x << 8)) & 0x0300F00Full;
    x = (x | (x << 4)) & 0x030C30C3ull;
    x = (x | (x << 2)) & 0x09249249ull;
    return x;
}

__device__ __forceinline__ unsigned long long spread21(unsigned long long x) {
    x &= (1ull << 21) - 1;
    x = (x | (x << 32)) & 0x001F00000000FFFFull;
    x = (x | (x << 16)) & 0x001F0000FF0000FFull;
    x = (x | (x << 8)) & 0x100F00F00F00F00Full;
    x = (x | (x << 4)) & 0x10C30C30C30C30C3ull;
    x = (x | (x << 2)) & 0x1249249249249249ull;
    return x;
}

__global__ void __launch_bounds__(kThreads)
    morton_keys_kernel(const float* __restrict__ centroids, const float* __restrict__ box_min,
                       const float* __restrict__ box_max, long long* __restrict__ keys, int n,
                       int stride, int bits) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    const float span = bits == 30 ? 1023.0f : 2097151.0f;
    unsigned long long u[3];
    for (int k = 0; k < 3; ++k) {
        const float lo = box_min[k];
        const float scale = span / (box_max[k] - lo);
        u[k] = f32_to_u32(scale * (centroids[static_cast<long long>(i) * stride + k] - lo));
    }
    unsigned long long key;
    if (bits == 30) {
        key = (spread10(u[2]) << 2) | (spread10(u[1]) << 1) | spread10(u[0]);
    } else {
        key = (spread21(u[2]) << 2) | (spread21(u[1]) << 1) | spread21(u[0]);
    }
    keys[i] = static_cast<long long>(key);
}

// d[j] for the n - 1 adjacent pairs; a (stride_a floats a row) holds the
// centroids (euclidean) or the box minima (surface area), b the box maxima.
__global__ void __launch_bounds__(kThreads)
    deltas_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const long long* __restrict__ keys, void* __restrict__ out, int n,
                  int stride_a, int stride_b, int kind) {
    const int j = blockIdx.x * kThreads + threadIdx.x;
    if (j >= n - 1) return;
    if (kind == kXor30 || kind == kXor63) {
        const unsigned long long x =
            static_cast<unsigned long long>(keys[j]) ^ static_cast<unsigned long long>(keys[j + 1]);
        long long d = static_cast<long long>(x);
        if (kind == kXor63) {
            const int bitlen = 64 - __clzll(static_cast<long long>(x));
            const int shift = max(bitlen - (kMantissaBits + 1), 0);
            const long long mant = static_cast<long long>((x >> shift) &
                                                          ((1ull << kMantissaBits) - 1));
            d = (static_cast<long long>(bitlen) << kMantissaBits) | mant;
        }
        static_cast<long long*>(out)[j] = d;
        return;
    }
    const float* p = a + static_cast<long long>(j) * stride_a;
    const float* q = p + stride_a;
    float r;
    if (kind == kEuclidean) {
        const float dx = p[0] - q[0], dy = p[1] - q[1], dz = p[2] - q[2];
        r = fma_f64(dz, dz, fma_f64(dy, dy, dx * dx));
    } else {
        const float* pb = b + static_cast<long long>(j) * stride_b;
        const float* qb = pb + stride_b;
        float e[3];
        for (int k = 0; k < 3; ++k) e[k] = torch_max(pb[k], qb[k]) - torch_min(p[k], q[k]);
        r = fma_f64(e[1], e[2], fma_f64(e[0], e[1], e[0] * e[2]));
    }
    static_cast<float*>(out)[j] = r;
}

__device__ __forceinline__ int load_volatile(const int32_t* p) {
    return *reinterpret_cast<const volatile int32_t*>(p);
}

// The parent split of the node over leaves [lo, hi] of a sequence whose
// last leaf is `last`: returns it, and sets `right` where the node is its
// right child. `left_delta` and `right_delta` are the deltas at the
// node's two boundaries (read only inside the sequence).
template <typename D>
__device__ __forceinline__ int parent_of(int lo, int hi, int last, const D* d, int left_at,
                                         int right_at, bool& right) {
    if (lo == 0) {
        right = false;
    } else if (hi == last) {
        right = true;
    } else {
        right = d[left_at] < d[right_at];
    }
    return right ? lo - 1 : hi;
}

template <typename D>
__global__ void __launch_bounds__(kThreads)
    ranges_kernel(const D* __restrict__ d, int32_t* l, int32_t* r, int32_t* __restrict__ first,
                  int32_t* __restrict__ count, int32_t* __restrict__ mark, uint32_t* flags, int n,
                  int max_per_leaf) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    int lo = i, hi = i;
    while (true) {
        bool right;
        const int p = parent_of(lo, hi, n - 1, d, lo - 1, hi, right);
        if (right) {
            r[p] = hi;
        } else {
            l[p] = lo;
        }
        __threadfence();
        if (atomicAdd(&flags[p], 1u) == 0u) return;
        __threadfence();
        lo = right ? load_volatile(&l[p]) : lo;
        hi = right ? hi : load_volatile(&r[p]);
        // coalesce_leaves' rule at split p over [lo, hi]
        const int s_left = p - lo + 1, s_right = hi - p;
        const bool left_small = s_left <= max_per_leaf, right_small = s_right <= max_per_leaf;
        const bool write = left_small != right_small || s_left + s_right > max_per_leaf;
        if (left_small && write) {
            first[lo] = lo;
            count[lo] = s_left;
            mark[lo] = 1;
        }
        if (right_small && write) {
            first[hi] = p + 1;
            count[hi] = s_right;
            mark[hi] = 1;
        }
        if (lo == 0 && hi == n - 1) return;
    }
}

template <typename D>
__global__ void __launch_bounds__(kThreads)
    nodes_kernel(const D* __restrict__ d, const int32_t* __restrict__ first,
                 const int32_t* __restrict__ count, const int32_t* __restrict__ mark,
                 const int32_t* __restrict__ scan, const float* __restrict__ mins,
                 const float* __restrict__ maxs, int32_t* children, float* child_aabbs,
                 int32_t* __restrict__ leaves, int32_t* __restrict__ root,
                 int32_t* __restrict__ n_nodes, int32_t* __restrict__ n_leaves,
                 uint32_t* flags, int32_t* ends, int n) {
    const int s = blockIdx.x * kThreads + threadIdx.x;
    if (s >= n) return;
    const int nl = scan[n - 1];
    if (s == 0) {
        *n_leaves = nl;
        *n_nodes = nl - 1;
    }
    if (s >= nl) {
        leaves[2 * s] = 0;
        leaves[2 * s + 1] = 0;
    }
    if (s < n - 1 && s >= nl - 1) {
        children[2 * s] = 0;
        children[2 * s + 1] = 0;
        const float inf = __int_as_float(0x7f800000);
        float* box = child_aabbs + 12 * static_cast<long long>(s);
        for (int c = 0; c < 2; ++c) {
            for (int k = 0; k < 3; ++k) {
                box[6 * c + k] = inf;
                box[6 * c + 3 + k] = -inf;
            }
        }
    }
    if (!mark[s]) return;
    const int leaf = scan[s] - 1;
    int a = first[s];
    int b = a + count[s] - 1;
    leaves[2 * leaf] = a;
    leaves[2 * leaf + 1] = count[s];
    float bmin[3], bmax[3];
    for (int k = 0; k < 3; ++k) {
        bmin[k] = mins[3 * static_cast<long long>(a) + k];
        bmax[k] = maxs[3 * static_cast<long long>(a) + k];
    }
    for (int q = a + 1; q <= b; ++q) {
        for (int k = 0; k < 3; ++k) {
            bmin[k] = torch_min(bmin[k], mins[3 * static_cast<long long>(q) + k]);
            bmax[k] = torch_max(bmax[k], maxs[3 * static_cast<long long>(q) + k]);
        }
    }
    int lo = leaf, hi = leaf, entry = ~leaf;
    while (true) {
        bool right;
        const int p = parent_of(lo, hi, nl - 1, d, a - 1, b, right);
        const int side = right ? 1 : 0;
        children[2 * p + side] = entry;
        float* mine = child_aabbs + 12 * static_cast<long long>(p) + 6 * side;
        for (int k = 0; k < 3; ++k) {
            mine[k] = bmin[k];
            mine[3 + k] = bmax[k];
        }
        // ends row p: (lo, first primitive) from the left child, (hi, last
        // primitive) from the right child
        int32_t* row = ends + 4 * static_cast<long long>(p);
        if (right) {
            row[2] = hi;
            row[3] = b;
        } else {
            row[0] = lo;
            row[1] = a;
        }
        __threadfence();
        if (atomicAdd(&flags[p], 1u) == 0u) return;
        __threadfence();
        const volatile float* other =
            child_aabbs + 12 * static_cast<long long>(p) + 6 * (1 - side);
        for (int k = 0; k < 3; ++k) {
            bmin[k] = torch_min(bmin[k], other[k]);
            bmax[k] = torch_max(bmax[k], other[3 + k]);
        }
        if (right) {
            lo = load_volatile(&row[0]);
            a = load_volatile(&row[1]);
        } else {
            hi = load_volatile(&row[2]);
            b = load_volatile(&row[3]);
        }
        entry = p;
        if (lo == 0 && hi == nl - 1) {
            *root = p;
            return;
        }
    }
}

}  // namespace

// Morton keys i64[n] of centroids f32[n, 3] (`stride` floats a row) in the
// box box_min f32[3], box_max f32[3]; bits 30 or 63.
extern "C" int grace_morton_keys(const float* centroids, const float* box_min,
                                 const float* box_max, long long* keys, int n, int stride,
                                 int bits, int device, void* stream) {
    if (n < 0 || stride < 3 || (bits != 30 && bits != 63) || !centroids || !box_min ||
        !box_max || !keys) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n == 0) return static_cast<int>(cudaGetLastError());
    morton_keys_kernel<<<grid(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        centroids, box_min, box_max, keys, n, stride, bits);
    return static_cast<int>(cudaGetLastError());
}

// The n - 1 adjacent deltas of n sorted primitives into out (f32 for kind
// 0, euclidean: a = centroids; 1, surface area: a = box minima, b = maxima;
// i64 for kind 2, XOR of 30-bit keys, and 3, compressed XOR of 63-bit keys).
extern "C" int grace_deltas(const float* a, const float* b, const long long* keys, void* out,
                            int n, int stride_a, int stride_b, int kind, int device,
                            void* stream) {
    const bool xor_kind = kind == kXor30 || kind == kXor63;
    if (n < 1 || kind < kEuclidean || kind > kXor63 || !out || (xor_kind && !keys) ||
        (!xor_kind && (!a || stride_a < 3)) ||
        (kind == kSurfaceArea && (!b || stride_b < 3))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n == 1) return static_cast<int>(cudaGetLastError());
    deltas_kernel<<<grid(n - 1), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        a, b, keys, out, n, stride_a, stride_b, kind);
    return static_cast<int>(cudaGetLastError());
}

// Phase A over deltas d[n - 1] (f32 where is_float, else i64): l, r i32[n -
// 1] of every split; first, count i32[n] at the big leaves' slots, mark
// i32[n] 1 there and 0 elsewhere. flags u32[n - 1] is scratch; mark and
// flags are zeroed here, in the stream.
extern "C" int grace_lbvh_ranges(const void* d, int32_t* l, int32_t* r, int32_t* first,
                                 int32_t* count, int32_t* mark, uint32_t* flags, int n,
                                 int max_per_leaf, int is_float, int device, void* stream) {
    if (n < 2 || max_per_leaf < 1 || max_per_leaf >= n || !d || !l || !r || !first || !count ||
        !mark || !flags) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const auto s = static_cast<cudaStream_t>(stream);
    err = cudaMemsetAsync(mark, 0, sizeof(int32_t) * n, s);
    if (err == cudaSuccess) err = cudaMemsetAsync(flags, 0, sizeof(uint32_t) * (n - 1), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (is_float) {
        ranges_kernel<float><<<grid(n), kThreads, 0, s>>>(static_cast<const float*>(d), l, r,
                                                          first, count, mark, flags, n,
                                                          max_per_leaf);
    } else {
        ranges_kernel<long long><<<grid(n), kThreads, 0, s>>>(
            static_cast<const long long*>(d), l, r, first, count, mark, flags, n, max_per_leaf);
    }
    return static_cast<int>(cudaGetLastError());
}

// Phase B: the tree over the big leaves that phase A marked (scan i32[n]:
// the inclusive prefix sum of mark), boxes from mins, maxs f32[n, 3] of the
// sorted primitives: children i32[n - 1, 2], child_aabbs f32[n - 1, 2, 2,
// 3], leaves i32[n, 2], root, n_nodes, n_leaves i32[]. flags u32[n - 1]
// (zeroed here) and ends i32[n - 1, 4] are scratch.
extern "C" int grace_lbvh_nodes(const void* d, const int32_t* first, const int32_t* count,
                                const int32_t* mark, const int32_t* scan, const float* mins,
                                const float* maxs, int32_t* children, float* child_aabbs,
                                int32_t* leaves, int32_t* root, int32_t* n_nodes,
                                int32_t* n_leaves, uint32_t* flags, int32_t* ends, int n,
                                int is_float, int device, void* stream) {
    if (n < 2 || !d || !first || !count || !mark || !scan || !mins || !maxs || !children ||
        !child_aabbs || !leaves || !root || !n_nodes || !n_leaves || !flags || !ends) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const auto s = static_cast<cudaStream_t>(stream);
    err = cudaMemsetAsync(flags, 0, sizeof(uint32_t) * (n - 1), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (is_float) {
        nodes_kernel<float><<<grid(n), kThreads, 0, s>>>(
            static_cast<const float*>(d), first, count, mark, scan, mins, maxs, children,
            child_aabbs, leaves, root, n_nodes, n_leaves, flags, ends, n);
    } else {
        nodes_kernel<long long><<<grid(n), kThreads, 0, s>>>(
            static_cast<const long long*>(d), first, count, mark, scan, mins, maxs, children,
            child_aabbs, leaves, root, n_nodes, n_leaves, flags, ends, n);
    }
    return static_cast<int>(cudaGetLastError());
}
