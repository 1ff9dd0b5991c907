// The LBVH build on the card: Morton keys, the sorted primitives with their
// boxes and adjacent deltas, and the two bottom-up climbs that make the tree.
//
// Not a TPU kernel: it replaces grace_tpu/build/sph.py:30-149 (keys, the
// pipeline, the gather prims[perm]), grace_tpu/build/deltas.py:26-111,
// grace_tpu/ops/primitives.py:32-60 (the boxes) and
// grace_tpu/ops/morton.py:99, plain XLA, and grace_tpu/build/lbvh.py:217-370
// (build_lbvh), whose Cartesian-tree ranges (sparse max table and binary skip
// searches, cartesian_tree_ranges, :105), leaf coalescing (:130) and child
// boxes (range reductions over a power-of-two tree) exist because atomics and
// data-dependent loops are hostile to XLA. Here the tree is built as the CUDA
// original builds it (albvh.cuh:76-234 and :303-670): two Apetrei climbs
// coordinated by atomics, their lower levels inside a block.
//
// morton_keys_kernel (E2's keys): per axis scale = span / (max - min) and u =
// uint32(scale * (c - min)), each operation rounded in f32 (--fmad=false: no
// contraction); the conversion truncates toward zero, saturates at [0, 2^32
// - 1] and maps NaN to 0 (a degenerate axis gives inf * 0 = NaN, so 0); then
// the bits are spread (10 a axis in 32-bit ints, 21 in 64-bit) and
// interleaved z, y, x. 63-bit keys are one int64 value, (hi << 32) | lo. It
// reads the caller's own rows: spheres as one 16-byte load a row, rays as
// origins, directions and lengths with the midpoint o + 0.5 l d formed in
// registers as vecmath.fma forms it. Without a given box the box is folded
// in the same launch: a cooperative grid of resident blocks (two an SM,
// fewer where cudaOccupancyMaxActiveBlocksPerMultiprocessor allows fewer),
// each block's partial box, one grid barrier, then every block folds the
// partial boxes and keys its items, the first four a thread still in
// registers. Before it the build
// made three device operations of the keys (torch.amin, torch.amax and a
// kernel that read the box and divided in every thread) and
// spatial_sort_rays about ten (the midpoints' f64 chain, the box, the
// keys). Bound by bytes: 2^20 spheres' 16 MB read and 8 MB of keys written.
//
// gather_deltas_kernel (E2 on the build's path): one thread a sorted row j. It
// reads the stable sort's int64 permutation and the unsorted row perm[j] (a
// sphere as one 16-byte load, a triangle as nine floats) and writes in one
// pass the sorted row, the int32 permutation, the row's box (a sphere's c - r
// and c + r; a triangle's vertex min and max, in torch.amin / amax's order on
// the card: a NaN operand sticks, else the strictly smaller / larger, else the
// later operand) and delta j of the requested kind, taking row j + 1's
// centroid or box from the next lane by a shuffle (lane 31 reads its own).
// Without it, the gather, the cast, the two box operations and the deltas were
// five launches over the same rows.
//
// deltas_kernel: one thread a pair (j, j + 1) of sorted primitives. Euclidean:
// the port's vecmath.dot3 of the centroid difference (x * x in f32, then two
// multiply-adds that each take the exact f64 product plus the sum, rounded
// once to f32). Surface area: the union box's e0 e2, e0 e1, e1 e2 in
// deltas.surface_area_deltas' order, with torch.minimum / maximum's NaN rule.
// XOR of 30-bit keys; of 63-bit keys compressed to (bit_length << 26) | the 26
// bits below the leading bit (__clzll). The gather kernel computes each kind
// with the same device functions.
//
// The climbs. A node over items [L, R] of a sequence (primitives in phase A,
// big leaves in phase B) is the left child of split R when L == 0 or D[L - 1]
// >= D[R] (ties go right: the parent is the split at R), else the right child
// of split L - 1; the ends of the sequence count as larger than any delta.
// Each child writes its data into fixed slots of the parent and arrives at the
// parent's flag: the first arrival exits, the second reads the sibling's data
// and climbs on. The flag decides only who climbs, never what is written, so
// every arrival order gives the same bits. That tree is the Cartesian tree of
// the deltas, max at the root, ties leftmost (grace_tpu/build/lbvh.py:1-33).
//
// Both kernels run a block over `block` consecutive items (default 1024, less
// where N is small: default_block) in two stages. The block stages its deltas
// in shared memory and routes every split between two of its items: the
// split's range lies inside the block when a delta >= its own stands left of
// it before the block's left edge (or the block starts the sequence) and one >
// its own right of it before the right edge (or the block ends it), found by a
// prefix and a suffix max over the staged deltas (route_splits). The route
// follows from the deltas alone, so both arrivals at a split take the same
// one. Stage 1 climbs every item of the block through the splits that lie
// inside it, with the arrivals in shared memory; a node whose parent lies
// outside the block is a top and is queued. Stage 2 climbs the queued tops
// through the remaining splits at device scope, each step carrying the node's
// boundary deltas so that it reads no delta of its own.
//
// ranges_kernel (phase A): the items are the primitives. Each arrival writes
// its end of the parent's range (l[p] = L as a left child, r[p] = R as a right
// child). The thread that completes split p applies coalesce_leaves' rule: a
// child of at most max_per_leaf primitives is a big leaf where its sibling is
// not small, or both are but p is not; it writes the leaf's first primitive
// and count at the slot of the leaf's first (left child) or last (right child)
// primitive and marks the slot. The k-th marked slot in ascending position is
// leaf k: a prefix sum of the marks (torch.cumsum) compacts them, as
// grace_tpu's stable argsort does. An arrival is one relaxed 64-bit atomicExch
// of a word of the split (in shared memory inside the block, in device memory
// at device scope) that holds the child's end and, at device scope for f32
// deltas, its boundary delta: the first arrival reads 0 and exits, the second
// reads its sibling's word, so no fence is needed.
//
// nodes_kernel (phase B): a block over `block` primitive slots compacts its
// marked slots into its consecutive leaves [kb, kb + K) (leaf k = scan - 1),
// writes their rows and stages their boundary deltas (the delta right of leaf
// k is d[last primitive of k]; left of the block's first leaf d[its first
// primitive - 1]). A group of lanes a leaf (a quarter of max_per_leaf rounded
// up to a power of two, at most 8; 32 / group leaves a warp at once) unions
// its primitives' boxes: a lane a contiguous run of up to 4 rows (more past
// max_per_leaf 32), the group's runs adjacent, then a shuffle tree over lane
// offsets 1, 2, ..., group / 2, the lower lanes always the left operand, so
// the union keeps the serial loop's operand order. Under torch.minimum /
// maximum's rule (the first NaN, else fminf / fmaxf, which on the card give -0
// / +0 on any tie of zeros: ROADMAP C20) an ordered tree gives the serial
// loop's bits, NaN payloads included. The leaf's box and entry (~k) go
// straight into its parent's slots; then the two climb stages, a thread a
// leaf. A completed split unions its two children's boxes (left before right),
// writes its entry and box into its parent's slots and climbs on; the split
// over [0, n_leaves - 1] writes root. Inside the block an arrival writes its
// end into shared memory and takes the split's shared flag with a block-scope
// acquire-release fetch_add (the boxes stay in device memory, written once). A
// device-scope arrival writes its end and boundary delta into the split's ends
// row, then one acquire-release fetch_add at device scope on the split's flag
// (no separate fences) publishes them with the box; the second arrival reads
// the sibling's row and both boxes with volatile loads. Each block writes the
// plain build's padding for its slots (children 0, boxes (+inf, -inf) past
// n_leaves - 2; leaves 0 past n_leaves - 1).
//
// What bounds it: memory, and the climbs' latency. Each primitive's data is
// read once or twice and the tree written once (a few tens of bytes a
// primitive, 30-40 MB at 2^20); a climb's steps are dependent. Inside a block
// a step costs a shared-memory atomic (phase B adds the boxes' reads and
// writes in device memory); only the splits whose range crosses a block edge
// pay device-scope round trips, about 25 levels on the deepest path of the
// bench scene's tree, a small share of either kernel's time. What is left is
// each block's own work: its loads, barriers and box reads, and phase B's
// occupancy (37.9 KB of shared memory a block).

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda/atomic>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kEuclidean = 0;
constexpr int kSurfaceArea = 1;
constexpr int kXor30 = 2;
constexpr int kXor63 = 3;
constexpr int kMantissaBits = 26;
constexpr int kSphere = 0;
constexpr int kTriangle = 1;
// the climbs: items a block (the default and the most), threads a block
constexpr int kBlock = 1024;
constexpr int kRangeThreads = 256;
constexpr int kNodeThreads = 128;
constexpr unsigned char kDevice = 1;

int grid(int n) { return (n + kThreads - 1) / kThreads; }

// The climbs' default block: the least power of two from 64 to kBlock that
// gives at most 264 blocks (two an SM), so that a small build still spreads
// over the card.
int default_block(int n) {
    int block = 64;
    while (block < kBlock && static_cast<long long>(block) * 264 < n) block <<= 1;
    return block;
}

// torch.minimum / maximum on the card: a NaN operand propagates (the first
// one), else fminf / fmaxf.
__device__ __forceinline__ float torch_min(float a, float b) {
    return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float torch_max(float a, float b) {
    return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// One step of torch.amin / amax's reduction on the card: a NaN accumulator
// sticks, else the strictly smaller / larger operand, else the later one.
__device__ __forceinline__ float amin_step(float a, float b) { return (a != a || a < b) ? a : b; }

__device__ __forceinline__ float amax_step(float a, float b) { return (a != a || a > b) ? a : b; }

// vecmath.fma: the exact f64 product plus c, rounded to f64, then to f32.
__device__ __forceinline__ float fma_f64(float a, float b, float c) {
    return __double2float_rn(static_cast<double>(a) * static_cast<double>(b) +
                             static_cast<double>(c));
}

// morton.f32_to_u32: truncate toward zero, saturate at [0, 2^32 - 1], NaN -> 0.
// cvt.rzi.u32.f32 saturates and takes NaN to 0 (chip_smoke.py's key checks
// hold it to the f64 clamp on NaN, +-inf, negatives, -0, subnormals and
// values past 2^32).
__device__ __forceinline__ unsigned to_u32(float v) {
    return __float2uint_rz(v);
}

__device__ __forceinline__ unsigned spread10(unsigned x) {
    x &= (1u << 10) - 1;
    x = (x | (x << 16)) & 0x030000FFu;
    x = (x | (x << 8)) & 0x0300F00Fu;
    x = (x | (x << 4)) & 0x030C30C3u;
    x = (x | (x << 2)) & 0x09249249u;
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

// What the keys read: centroids at `stride` floats a row (scalar loads),
// spheres f32[n, 4] at a 16-byte aligned base (one 16-byte load a row), or
// rays (origins and directions at `stride` floats a row, lengths f32[n]).
constexpr int kCentroids = 0;
constexpr int kSpheres = 1;
constexpr int kRays = 2;

struct KeyArgs {
    const float* rows;      // centroids, spheres or ray origins
    const float* dirs;      // ray directions (kRays)
    const float* lengths;   // ray lengths (kRays)
    const float* box_min;   // the given box, f32[3] or a scalar (box_stride 0)
    const float* box_max;
    float* parts;           // without a box: 6 floats a block, its partial box
    long long* keys;
    int n, stride, box_stride;
};

// Item i's point: the centroid, or the ray's midpoint as vecmath.fma takes
// it (0.5 l in f32, then the exact f64 product with d plus o, rounded to
// f64 and then to f32).
template <int kSrc>
__device__ __forceinline__ void key_point(const KeyArgs& a, long long i, float* c) {
    if constexpr (kSrc == kSpheres) {
        const float4 s = __ldg(reinterpret_cast<const float4*>(a.rows) + i);
        c[0] = s.x;
        c[1] = s.y;
        c[2] = s.z;
    } else if constexpr (kSrc == kCentroids) {
        const float* p = a.rows + i * a.stride;
        for (int k = 0; k < 3; ++k) c[k] = __ldg(p + k);
    } else {
        const long long r = i * a.stride;
        const float h = 0.5f * __ldg(a.lengths + i);
        for (int k = 0; k < 3; ++k) c[k] = fma_f64(h, __ldg(a.dirs + r + k), __ldg(a.rows + r + k));
    }
}

// box = (min xyz, max xyz) in torch.amin / amax's rule: a NaN sticks.
__device__ __forceinline__ void fold_point(float* box, const float* c) {
    for (int k = 0; k < 3; ++k) {
        box[k] = amin_step(box[k], c[k]);
        box[3 + k] = amax_step(box[3 + k], c[k]);
    }
}

__device__ __forceinline__ void fold_box(float* box, const float* other) {
    for (int k = 0; k < 3; ++k) {
        box[k] = amin_step(box[k], other[k]);
        box[3 + k] = amax_step(box[3 + k], other[3 + k]);
    }
}

constexpr int kKeyWarps = kThreads / 32;

// The block's box into out[6] (every thread's box folded over the warp by
// shuffles, then the warps in shared memory). Ends with a barrier.
__device__ __forceinline__ void block_box(float* box, float (*warps)[6], float* out) {
    for (int o = 16; o; o >>= 1) {
        float other[6];
        for (int k = 0; k < 6; ++k) other[k] = __shfl_xor_sync(0xffffffffu, box[k], o);
        fold_box(box, other);
    }
    if (threadIdx.x % 32 == 0) {
        for (int k = 0; k < 6; ++k) warps[threadIdx.x / 32][k] = box[k];
    }
    __syncthreads();
    if (threadIdx.x < 6) {
        float v = warps[0][threadIdx.x];
        for (int w = 1; w < kKeyWarps; ++w) {
            v = threadIdx.x < 3 ? amin_step(v, warps[w][threadIdx.x])
                                : amax_step(v, warps[w][threadIdx.x]);
        }
        out[threadIdx.x] = v;
    }
    __syncthreads();
}

template <int kBits>
__device__ __forceinline__ long long key_of(const float* c, const float* lo, const float* scale) {
    unsigned u[3];
    for (int k = 0; k < 3; ++k) u[k] = to_u32(scale[k] * (c[k] - lo[k]));
    if constexpr (kBits == 30) {
        return (spread10(u[2]) << 2) | (spread10(u[1]) << 1) | spread10(u[0]);
    } else {
        return static_cast<long long>((spread21(u[2]) << 2) | (spread21(u[1]) << 1) |
                                      spread21(u[0]));
    }
}

// Blocks an SM of a launch that folds its box, and the items a thread
// keeps in registers across the grid's barrier (the rest are read again
// after it, from L2: 2^20 spheres are 16 MB). Every block folds all
// blocks' partial boxes after the barrier, G^2 reads for G blocks: at the
// 6 blocks an SM that 40 registers allow, 792 blocks read 15 MB and took
// 0.014 ms of the launch's 0.025; 264 blocks read 1.7 MB. Holding 16 items
// a thread took the same time on 2^20 spheres and more on 512^2 rays (0.0103
// ms against 0.0080; chip_ablation.py's keys variants).
constexpr int kFoldBlocksPerSm = 2;
constexpr int kHeld = 4;

// The keys of a.n items. With a given box (kFold false) a thread a key,
// the block's lo and span / (hi - lo) computed once. Without one (kFold) a
// cooperative grid of resident blocks: item i goes to thread i % (blocks x
// threads); each thread folds its items' points into its box (the first
// kHeld kept in registers), each block writes its partial box, the grid
// waits at one barrier, then every block folds all partial boxes (so every
// block has the same box: min and max are exact, and the zero sign of an
// edge, which the order may change, moves no key) and writes its keys.
template <int kSrc, bool kFold, int kBits>
__global__ void __launch_bounds__(kThreads, kFoldBlocksPerSm) morton_keys_kernel(const KeyArgs a) {
    __shared__ float warps[kKeyWarps][6];
    __shared__ float box[6];
    const float span = kBits == 30 ? 1023.0f : 2097151.0f;
    const long long step = static_cast<long long>(gridDim.x) * kThreads;
    const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    float held[kHeld > 0 ? kHeld : 1][3];
    if constexpr (kFold) {
        float mine[6] = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
        for (int k = 0; k < kHeld; ++k) {
            if (first + k * step < a.n) key_point<kSrc>(a, first + k * step, held[k]);
        }
#pragma unroll
        for (int k = 0; k < kHeld; ++k) {
            if (first + k * step < a.n) fold_point(mine, held[k]);
        }
        for (long long i = first + kHeld * step; i < a.n; i += step) {
            float c[3];
            key_point<kSrc>(a, i, c);
            fold_point(mine, c);
        }
        block_box(mine, warps, box);
        if (threadIdx.x < 6) a.parts[6 * blockIdx.x + threadIdx.x] = box[threadIdx.x];
        cooperative_groups::this_grid().sync();
        float all[6] = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY, -INFINITY};
        for (int b = threadIdx.x; b < gridDim.x; b += kThreads) {
            float part[6];
            for (int k = 0; k < 6; ++k) part[k] = __ldcg(a.parts + 6 * b + k);
            fold_box(all, part);
        }
        block_box(all, warps, box);
        if (threadIdx.x < 3) box[3 + threadIdx.x] = span / (box[3 + threadIdx.x] - box[threadIdx.x]);
    } else if (threadIdx.x < 3) {
        const float lo = a.box_min[threadIdx.x * a.box_stride];
        box[threadIdx.x] = lo;
        box[3 + threadIdx.x] = span / (a.box_max[threadIdx.x * a.box_stride] - lo);
    }
    __syncthreads();   // box: lo, then span / (hi - lo), once a block
    float lo[3], scale[3];
    for (int k = 0; k < 3; ++k) {
        lo[k] = box[k];
        scale[k] = box[3 + k];
    }
    long long i = first;
    if constexpr (kFold) {
#pragma unroll
        for (int k = 0; k < kHeld; ++k) {
            if (first + k * step < a.n) a.keys[first + k * step] = key_of<kBits>(held[k], lo, scale);
        }
        i += kHeld * step;
    }
    for (; i < a.n; i += step) {
        float c[3];
        key_point<kSrc>(a, i, c);
        a.keys[i] = key_of<kBits>(c, lo, scale);
    }
}

using KeyKernel = void (*)(const KeyArgs);

template <int kSrc, bool kFold>
KeyKernel key_kernel_bits(int bits) {
    return bits == 30 ? morton_keys_kernel<kSrc, kFold, 30> : morton_keys_kernel<kSrc, kFold, 63>;
}

template <bool kFold>
KeyKernel key_kernel_src(int src, int bits) {
    return src == kSpheres ? key_kernel_bits<kSpheres, kFold>(bits)
           : src == kRays  ? key_kernel_bits<kRays, kFold>(bits)
                           : key_kernel_bits<kCentroids, kFold>(bits);
}

KeyKernel key_kernel(int src, bool fold, int bits) {
    return fold ? key_kernel_src<true>(src, bits) : key_kernel_src<false>(src, bits);
}

// The delta of two adjacent keys: XOR of 30-bit keys, compressed XOR of
// 63-bit keys.
__device__ __forceinline__ long long xor_delta(long long a, long long b, int kind) {
    const unsigned long long x = static_cast<unsigned long long>(a) ^
                                 static_cast<unsigned long long>(b);
    if (kind != kXor63) return static_cast<long long>(x);
    const int bitlen = 64 - __clzll(static_cast<long long>(x));
    const int shift = max(bitlen - (kMantissaBits + 1), 0);
    const long long mant = static_cast<long long>((x >> shift) & ((1ull << kMantissaBits) - 1));
    return (static_cast<long long>(bitlen) << kMantissaBits) | mant;
}

// vecmath.dot3 of the centroid difference p - q.
__device__ __forceinline__ float euclidean_delta(const float* p, const float* q) {
    const float dx = p[0] - q[0], dy = p[1] - q[1], dz = p[2] - q[2];
    return fma_f64(dz, dz, fma_f64(dy, dy, dx * dx));
}

// The half surface area of the union of boxes (pa, pb) and (qa, qb).
__device__ __forceinline__ float surface_area_delta(const float* pa, const float* pb,
                                                    const float* qa, const float* qb) {
    float e[3];
    for (int k = 0; k < 3; ++k) e[k] = torch_max(pb[k], qb[k]) - torch_min(pa[k], qa[k]);
    return fma_f64(e[1], e[2], fma_f64(e[0], e[1], e[0] * e[2]));
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
        static_cast<long long*>(out)[j] = xor_delta(keys[j], keys[j + 1], kind);
        return;
    }
    const float* p = a + static_cast<long long>(j) * stride_a;
    float r;
    if (kind == kEuclidean) {
        r = euclidean_delta(p, p + stride_a);
    } else {
        const float* pb = b + static_cast<long long>(j) * stride_b;
        r = surface_area_delta(p, pb, p + stride_a, pb + stride_b);
    }
    static_cast<float*>(out)[j] = r;
}

// Row `src` of prims (a sphere or a triangle): copied to sorted row j when
// `sorted` is given; its centroid and box.
__device__ __forceinline__ void load_prim(const float* __restrict__ prims, long long src,
                                          int prim, float* __restrict__ sorted, long long j,
                                          float* c, float* lo, float* hi) {
    if (prim == kSphere) {
        const float4 s = reinterpret_cast<const float4*>(prims)[src];
        if (sorted) reinterpret_cast<float4*>(sorted)[j] = s;
        const float v[3] = {s.x, s.y, s.z};
        for (int k = 0; k < 3; ++k) {
            c[k] = v[k];
            lo[k] = v[k] - s.w;
            hi[k] = v[k] + s.w;
        }
        return;
    }
    float v[9];
    for (int k = 0; k < 9; ++k) v[k] = prims[9 * src + k];
    if (sorted) {
        for (int k = 0; k < 9; ++k) sorted[9 * j + k] = v[k];
    }
    for (int k = 0; k < 3; ++k) {
        lo[k] = amin_step(amin_step(v[k], v[3 + k]), v[6 + k]);
        hi[k] = amax_step(amax_step(v[k], v[3 + k]), v[6 + k]);
        c[k] = 0.5f * (lo[k] + hi[k]);
    }
}

// E2 in one pass: sorted rows, the int32 permutation, boxes (where mins is
// given) and deltas of `kind` (kind < 0: none). Every lane of a warp takes
// part in the shuffles, rows past n included.
__global__ void __launch_bounds__(kThreads)
    gather_deltas_kernel(const float* __restrict__ prims, const long long* __restrict__ perm,
                         const long long* __restrict__ keys, float* __restrict__ sorted,
                         int32_t* __restrict__ perm32, float* __restrict__ mins,
                         float* __restrict__ maxs, void* __restrict__ out, int n, int prim,
                         int kind) {
    const long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    const int lane = threadIdx.x & 31;
    float c[3] = {0.f, 0.f, 0.f}, lo[3] = {0.f, 0.f, 0.f}, hi[3] = {0.f, 0.f, 0.f};
    if (j < n) {
        const long long src = perm[j];
        load_prim(prims, src, prim, sorted, j, c, lo, hi);
        perm32[j] = static_cast<int32_t>(src);
        if (mins) {
            for (int k = 0; k < 3; ++k) {
                mins[3 * j + k] = lo[k];
                maxs[3 * j + k] = hi[k];
            }
        }
    }
    if (kind < 0) return;
    if (kind == kXor30 || kind == kXor63) {
        if (j < n - 1) static_cast<long long*>(out)[j] = xor_delta(keys[j], keys[j + 1], kind);
        return;
    }
    float c1[3], lo1[3], hi1[3];
    for (int k = 0; k < 3; ++k) {
        c1[k] = __shfl_down_sync(0xffffffffu, c[k], 1);
        lo1[k] = __shfl_down_sync(0xffffffffu, lo[k], 1);
        hi1[k] = __shfl_down_sync(0xffffffffu, hi[k], 1);
    }
    if (j >= n - 1) return;
    if (lane == 31) load_prim(prims, perm[j + 1], prim, nullptr, 0, c1, lo1, hi1);
    static_cast<float*>(out)[j] = kind == kEuclidean ? euclidean_delta(c, c1)
                                                     : surface_area_delta(lo, hi, lo1, hi1);
}

__device__ __forceinline__ int load_volatile(const int32_t* p) {
    return *reinterpret_cast<const volatile int32_t*>(p);
}

__device__ __forceinline__ float load_volatile(const float* p) {
    return *reinterpret_cast<const volatile float*>(p);
}

// One arrival at a split's flag; returns the arrivals before it. The
// acquire-release orders the child's writes before it for the sibling, and
// the sibling's writes before what follows for the second arrival.
__device__ __forceinline__ uint32_t arrive_device(uint32_t* flag) {
    cuda::atomic_ref<uint32_t, cuda::thread_scope_device> a(*flag);
    return a.fetch_add(1u, cuda::memory_order_acq_rel);
}

__device__ __forceinline__ uint32_t arrive_block(uint32_t* flag) {
    cuda::atomic_ref<uint32_t, cuda::thread_scope_block> a(*flag);
    return a.fetch_add(1u, cuda::memory_order_acq_rel);
}

// The parent split of the node over items [lo, hi] of a sequence whose last
// item is `last`, given the deltas left of lo (dl) and right of hi (dr),
// which are read only inside the sequence; sets `right` where the node is
// its right child.
template <typename D>
__device__ __forceinline__ int parent_of(int lo, int hi, int last, D dl, D dr, bool& right) {
    right = lo != 0 && (hi == last || dl < dr);
    return right ? lo - 1 : hi;
}

template <typename D>
__device__ __forceinline__ D dmax(D a, D b) {
    return a < b ? b : a;
}

// Routes the k - 1 splits between a block's k items (split i between items
// i and i + 1, delta dsh[i]; dleft and dright the deltas just outside the
// block, where has_left / has_right): route[i] = 0 where the split's range
// lies inside the block, else kDevice. pre and suf (k - 1 each) are scratch
// for the prefix and suffix max. Every thread of the block calls it; at
// most kPer splits a thread.
template <typename D, int kPer>
__device__ void route_splits(const D* dsh, D* pre, D* suf, unsigned char* route, int k,
                             bool has_left, D dleft, bool has_right, D dright) {
    const int m = k - 1, t = threadIdx.x, nt = blockDim.x;
    for (int i = t; i < m; i += nt) {
        pre[i] = dsh[i];
        suf[i] = dsh[i];
    }
    __syncthreads();
    for (int off = 1; off < m; off <<= 1) {
        D a[kPer], b[kPer];
#pragma unroll
        for (int c = 0; c < kPer; ++c) {
            const int i = t + c * nt;
            if (i < m) {
                a[c] = i >= off ? dmax(pre[i - off], pre[i]) : pre[i];
                b[c] = i + off < m ? dmax(suf[i + off], suf[i]) : suf[i];
            }
        }
        __syncthreads();
#pragma unroll
        for (int c = 0; c < kPer; ++c) {
            const int i = t + c * nt;
            if (i < m) {
                pre[i] = a[c];
                suf[i] = b[c];
            }
        }
        __syncthreads();
    }
    for (int i = t; i < m; i += nt) {
        const D v = dsh[i];
        const bool left_in = !has_left || (i > 0 && pre[i - 1] >= v) || dleft >= v;
        const bool right_in = !has_right || (i + 1 < m && suf[i + 1] > v) || dright > v;
        route[i] = left_in && right_in ? 0 : kDevice;
    }
    __syncthreads();
}

// coalesce_leaves' rule at split p over [lo, hi], applied by the thread
// that completes p.
__device__ __forceinline__ void mark_leaves(int p, int lo, int hi, int max_per_leaf,
                                            int32_t* first, int32_t* count, int32_t* mark) {
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
}

// Phase A's shared memory: the staged deltas, the scans' scratch (later
// the arrival words and the queue of tops) and the routes.
struct RangeShared {
    long long d[kBlock];
    long long scan[2 * kBlock];
    unsigned char route[kBlock];
    int n_tops;
};

// Phase B's: the same, the scratch later the range ends and the queue of
// tops, with the arrival flags and the block's leaves' first primitives
// and counts.
struct NodeShared {
    long long d[kBlock];
    long long scan[2 * kBlock];
    uint32_t flag[kBlock];
    unsigned char route[kBlock];
    int n_tops;
    int fsh[kBlock];
    int csh[kBlock];
};

// Phase A's device-scope arrival: one relaxed 64-bit exchange carries the
// child's end of the range (+1, so that 0 means no arrival yet) and, for
// f32 deltas, its boundary delta (left of lo for a left child, right of hi
// for a right child). The first arrival reads 0 and exits; the second reads
// the sibling's word, so no fence orders any other write.
template <typename D>
__device__ __forceinline__ unsigned long long pack_end(int end, D delta) {
    unsigned long long word = static_cast<unsigned long long>(end) + 1ull;
    if constexpr (sizeof(D) == 4) {
        word |= static_cast<unsigned long long>(__float_as_uint(delta)) << 32;
    }
    return word;
}

template <typename D>
__global__ void __launch_bounds__(kRangeThreads)
    ranges_kernel(const D* __restrict__ d, int32_t* __restrict__ l, int32_t* __restrict__ r,
                  int32_t* __restrict__ first, int32_t* __restrict__ count,
                  int32_t* __restrict__ mark, unsigned long long* flags, int n,
                  int max_per_leaf, int block) {
    __shared__ __align__(16) RangeShared sh;
    D* dsh = reinterpret_cast<D*>(sh.d);
    auto* words = reinterpret_cast<unsigned long long*>(sh.scan);
    int* top_lo = reinterpret_cast<int*>(sh.scan + kBlock);
    int* top_hi = top_lo + kBlock;
    const int t = threadIdx.x, nt = blockDim.x;
    const int kb = blockIdx.x * block, k = min(block, n - kb);
    for (int i = t; i < k; i += nt) {
        if (kb + i < n - 1) dsh[i] = d[kb + i];
    }
    if (t == 0) sh.n_tops = 0;
    __syncthreads();
    const bool has_left = kb > 0, has_right = kb + k < n;
    const D dleft = has_left ? d[kb - 1] : D(0);
    const D dright = has_right ? dsh[k - 1] : D(0);
    route_splits<D, kBlock / kRangeThreads>(dsh, reinterpret_cast<D*>(sh.scan),
                                            reinterpret_cast<D*>(sh.scan) + kBlock, sh.route, k,
                                            has_left, dleft, has_right, dright);
    for (int i = t; i < k; i += nt) words[i] = 0ull;
    __syncthreads();
    // stage 1: inside the block; an arrival is one relaxed exchange of the
    // split's shared word, which carries the child's end (+1)
    for (int i0 = t; i0 < k; i0 += nt) {
        int lo = kb + i0, hi = lo;
        while (true) {
            bool right;
            const int p = parent_of(lo, hi, n - 1, lo > kb ? dsh[lo - 1 - kb] : dleft,
                                    dsh[hi - kb], right);
            const int i = p - kb;
            if (i < 0 || i >= k - 1 || sh.route[i] == kDevice) {
                const int q = atomicAdd(&sh.n_tops, 1);
                top_lo[q] = lo;
                top_hi[q] = hi;
                break;
            }
            if (right) {
                r[p] = hi;
            } else {
                l[p] = lo;
            }
            const unsigned long long old =
                atomicExch(&words[i], static_cast<unsigned long long>(right ? hi : lo) + 1ull);
            if (old == 0ull) break;
            const int other = static_cast<int>(old - 1ull);
            lo = right ? other : lo;
            hi = right ? hi : other;
            mark_leaves(p, lo, hi, max_per_leaf, first, count, mark);
            if (lo == 0 && hi == n - 1) break;
        }
    }
    __syncthreads();
    // stage 2: the tops through the splits that cross a block edge; dl and
    // dr are the node's boundary deltas (read only inside the sequence)
    for (int q = t; q < sh.n_tops; q += nt) {
        int lo = top_lo[q], hi = top_hi[q];
        D dl = lo > 0 ? d[lo - 1] : D(0), dr = hi < n - 1 ? d[hi] : D(0);
        while (true) {
            bool right;
            const int p = parent_of(lo, hi, n - 1, dl, dr, right);
            if (right) {
                r[p] = hi;
            } else {
                l[p] = lo;
            }
            const unsigned long long old =
                atomicExch(&flags[p], right ? pack_end(hi, dr) : pack_end(lo, dl));
            if (old == 0ull) break;
            const int other = static_cast<int>(static_cast<uint32_t>(old) - 1u);
            if (right) {
                lo = other;
                if constexpr (sizeof(D) == 4) {
                    dl = __uint_as_float(static_cast<uint32_t>(old >> 32));
                } else {
                    dl = lo > 0 ? d[lo - 1] : D(0);
                }
            } else {
                hi = other;
                if constexpr (sizeof(D) == 4) {
                    dr = __uint_as_float(static_cast<uint32_t>(old >> 32));
                } else {
                    dr = hi < n - 1 ? d[hi] : D(0);
                }
            }
            mark_leaves(p, lo, hi, max_per_leaf, first, count, mark);
            if (lo == 0 && hi == n - 1) break;
        }
    }
}

// A delta as two ints of an ends row, and back (volatile: the sibling's).
template <typename D>
__device__ __forceinline__ void store_delta(int32_t* at, D v) {
    if constexpr (sizeof(D) == 4) {
        at[0] = __float_as_int(v);
    } else {
        at[0] = static_cast<int32_t>(v);
        at[1] = static_cast<int32_t>(v >> 32);
    }
}

template <typename D>
__device__ __forceinline__ D load_delta(const int32_t* at) {
    if constexpr (sizeof(D) == 4) {
        return __int_as_float(load_volatile(at));
    } else {
        const auto lo = static_cast<uint32_t>(load_volatile(at));
        const auto hi = static_cast<uint32_t>(load_volatile(at + 1));
        return static_cast<D>((static_cast<unsigned long long>(hi) << 32) | lo);
    }
}

// Node p's entry and box into slot `side` of its parent `parent`.
__device__ __forceinline__ void write_child(int32_t* children, float* child_aabbs, int parent,
                                            int side, int entry, const float* bmin,
                                            const float* bmax) {
    children[2 * parent + side] = entry;
    float* box = child_aabbs + 12 * static_cast<long long>(parent) + 6 * side;
    for (int k = 0; k < 3; ++k) {
        box[k] = bmin[k];
        box[3 + k] = bmax[k];
    }
}

// The union of split p's two child boxes, left before right.
__device__ __forceinline__ void union_children(const float* child_aabbs, int p, float* bmin,
                                               float* bmax) {
    const float* box = child_aabbs + 12 * static_cast<long long>(p);
    for (int k = 0; k < 3; ++k) {
        bmin[k] = torch_min(load_volatile(box + k), load_volatile(box + 6 + k));
        bmax[k] = torch_max(load_volatile(box + 3 + k), load_volatile(box + 9 + k));
    }
}

template <typename D>
__global__ void __launch_bounds__(kNodeThreads)
    nodes_kernel(const D* __restrict__ d, const int32_t* __restrict__ first,
                 const int32_t* __restrict__ count, const int32_t* __restrict__ mark,
                 const int32_t* __restrict__ scan, const float* __restrict__ mins,
                 const float* __restrict__ maxs, int32_t* children, float* child_aabbs,
                 int32_t* __restrict__ leaves, int32_t* __restrict__ root,
                 int32_t* __restrict__ n_nodes, int32_t* __restrict__ n_leaves,
                 uint32_t* flags, int32_t* ends, int n, int block, int group) {
    __shared__ __align__(16) NodeShared sh;
    int* fsh = sh.fsh;
    int* csh = sh.csh;
    D* dsh = reinterpret_cast<D*>(sh.d);
    int* lsh = reinterpret_cast<int*>(sh.scan);
    int* rsh = lsh + kBlock;
    int* top_lo = rsh + kBlock;
    int* top_hi = top_lo + kBlock;
    const int t = threadIdx.x, nt = blockDim.x;
    const int base = blockIdx.x * block, end = min(base + block, n);
    const int nl = scan[n - 1], last = nl - 1;
    const int kb = base > 0 ? scan[base - 1] : 0, k = scan[end - 1] - kb;
    if (blockIdx.x == 0 && t == 0) {
        *n_leaves = nl;
        *n_nodes = nl - 1;
    }
    const float inf = __int_as_float(0x7f800000);
    // a thread's slots (at most kBlock / kNodeThreads), their loads issued
    // together
    constexpr int kSlots = kBlock / kNodeThreads;
    int slot_mark[kSlots], slot_scan[kSlots], slot_first[kSlots], slot_count[kSlots];
#pragma unroll
    for (int c = 0; c < kSlots; ++c) {
        const int s = base + t + c * nt;
        slot_mark[c] = s < end ? mark[s] : 0;
        slot_scan[c] = s < end ? scan[s] : 0;
        slot_first[c] = s < end ? first[s] : 0;
        slot_count[c] = s < end ? count[s] : 0;
    }
#pragma unroll
    for (int c = 0; c < kSlots; ++c) {
        const int s = base + t + c * nt;
        if (s >= end) break;
        if (s >= nl) {
            leaves[2 * s] = 0;
            leaves[2 * s + 1] = 0;
        }
        if (s < n - 1 && s >= nl - 1) {
            const float pad_min[3] = {inf, inf, inf}, pad_max[3] = {-inf, -inf, -inf};
            write_child(children, child_aabbs, s, 0, 0, pad_min, pad_max);
            write_child(children, child_aabbs, s, 1, 0, pad_min, pad_max);
        }
        if (slot_mark[c]) {
            const int i = slot_scan[c] - 1 - kb;
            fsh[i] = slot_first[c];
            csh[i] = slot_count[c];
        }
    }
    if (t == 0) sh.n_tops = 0;
    __syncthreads();
    if (k == 0) return;
    for (int i = t; i < k; i += nt) {
        leaves[2 * (kb + i)] = fsh[i];
        leaves[2 * (kb + i) + 1] = csh[i];
        if (kb + i < last) dsh[i] = d[fsh[i] + csh[i] - 1];
        sh.flag[i] = 0;
    }
    __syncthreads();
    const bool has_left = kb > 0, has_right = kb + k - 1 < last;
    const D dleft = has_left ? d[fsh[0] - 1] : D(0);
    const D dright = has_right ? dsh[k - 1] : D(0);
    route_splits<D, kBlock / kNodeThreads>(dsh, reinterpret_cast<D*>(sh.scan),
                                           reinterpret_cast<D*>(sh.scan) + kBlock, sh.route, k,
                                           has_left, dleft, has_right, dright);
    // the leaves' boxes, a group of `group` lanes a leaf (32 / group leaves
    // a warp at once), into their parents' slots
    const int lane = t & 31, warp = t >> 5, n_warps = nt >> 5;
    const int sub = lane / group, glane = lane % group, per_warp = 32 / group;
    for (int i0 = warp * per_warp; i0 < k; i0 += n_warps * per_warp) {
        const int i = i0 + sub;
        const int a = i < k ? fsh[i] : 0, c = i < k ? csh[i] : 0, run = (c + group - 1) / group;
        float bmin[3] = {inf, inf, inf}, bmax[3] = {-inf, -inf, -inf};
        for (int q = glane * run; q < min(c, (glane + 1) * run); ++q) {
            for (int e = 0; e < 3; ++e) {
                bmin[e] = torch_min(bmin[e], mins[3 * static_cast<long long>(a + q) + e]);
                bmax[e] = torch_max(bmax[e], maxs[3 * static_cast<long long>(a + q) + e]);
            }
        }
        for (int off = 1; off < group; off <<= 1) {
            const bool upper = (lane & off) != 0;
            for (int e = 0; e < 3; ++e) {
                const float omin = __shfl_xor_sync(0xffffffffu, bmin[e], off);
                const float omax = __shfl_xor_sync(0xffffffffu, bmax[e], off);
                bmin[e] = upper ? torch_min(omin, bmin[e]) : torch_min(bmin[e], omin);
                bmax[e] = upper ? torch_max(omax, bmax[e]) : torch_max(bmax[e], omax);
            }
        }
        if (i < k && glane == 0) {
            const int leaf = kb + i;
            bool right;
            const int p = parent_of(leaf, leaf, last, i > 0 ? dsh[i - 1] : dleft, dsh[i], right);
            write_child(children, child_aabbs, p, right ? 1 : 0, ~leaf, bmin, bmax);
        }
    }
    __threadfence();
    __syncthreads();
    // stage 1: inside the block
    for (int i0 = t; i0 < k; i0 += nt) {
        int lo = kb + i0, hi = lo;
        bool right;
        int p = parent_of(lo, hi, last, i0 > 0 ? dsh[i0 - 1] : dleft, dsh[i0], right);
        while (true) {
            const int i = p - kb;
            if (i < 0 || i >= k - 1 || sh.route[i] == kDevice) {
                const int q = atomicAdd(&sh.n_tops, 1);
                top_lo[q] = lo;
                top_hi[q] = hi;
                break;
            }
            if (right) {
                rsh[i] = hi;
            } else {
                lsh[i] = lo;
            }
            if (arrive_block(&sh.flag[i]) == 0u) break;
            lo = right ? lsh[i] : lo;
            hi = right ? hi : rsh[i];
            float bmin[3], bmax[3];
            union_children(child_aabbs, p, bmin, bmax);
            if (lo == 0 && hi == last) {
                *root = p;
                break;
            }
            const int node = p;
            p = parent_of(lo, hi, last, lo > kb ? dsh[lo - 1 - kb] : dleft, dsh[hi - kb], right);
            write_child(children, child_aabbs, p, right ? 1 : 0, node, bmin, bmax);
        }
    }
    __threadfence();
    __syncthreads();
    // stage 2: the tops through the splits that cross a block edge. Ends
    // row p holds the left child's end lo and its boundary delta (left of
    // its first primitive), then the right child's hi and its boundary
    // delta (right of its last primitive), each delta as two ints; so a
    // step reads no delta of its own.
    for (int q = t; q < sh.n_tops; q += nt) {
        int lo = top_lo[q], hi = top_hi[q];
        const int a = fsh[lo - kb], b = fsh[hi - kb] + csh[hi - kb] - 1;
        D dl = lo > 0 ? d[a - 1] : D(0), dr = hi < last ? d[b] : D(0);
        bool right;
        int p = parent_of(lo, hi, last, dl, dr, right);
        while (true) {
            int32_t* row = ends + 6 * static_cast<long long>(p);
            if (right) {
                row[3] = hi;
                store_delta(row + 4, dr);
            } else {
                row[0] = lo;
                store_delta(row + 1, dl);
            }
            if (arrive_device(&flags[p]) == 0u) break;
            if (right) {
                lo = load_volatile(&row[0]);
                dl = load_delta<D>(row + 1);
            } else {
                hi = load_volatile(&row[3]);
                dr = load_delta<D>(row + 4);
            }
            float bmin[3], bmax[3];
            union_children(child_aabbs, p, bmin, bmax);
            if (lo == 0 && hi == last) {
                *root = p;
                break;
            }
            const int node = p;
            p = parent_of(lo, hi, last, dl, dr, right);
            write_child(children, child_aabbs, p, right ? 1 : 0, node, bmin, bmax);
        }
    }
}

int climb_threads(int block, int most) { return min(most, (block + 31) / 32 * 32); }

}  // namespace

// Resident blocks an SM of each keys kernel that folds its box, by device
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, asked once).
constexpr int kMaxDevices = 64;
int key_blocks_per_sm[kMaxDevices][3][2];
int sm_count[kMaxDevices];

// Morton keys i64[n] (bits 30 or 63) of n points: centroids (rows, `stride`
// floats a row; spheres f32[n, 4] where stride is 4 and the base 16-byte
// aligned) where dirs is null, else the midpoints o + 0.5 l d of rays
// (origins rows and directions dirs at `stride` floats a row, lengths f32[n]),
// in the box (box_min, box_max: f32[3], or a scalar where box_stride is 0)
// or, where both are null, in the points' own box, folded in the same
// launch by a cooperative grid of at most max_blocks resident blocks, their
// partial boxes in parts f32[6 max_blocks].
extern "C" int grace_morton_keys(const float* rows, const float* dirs, const float* lengths,
                                 const float* box_min, const float* box_max, float* parts,
                                 long long* keys, int n, int stride, int box_stride, int bits,
                                 int max_blocks, int device, void* stream) {
    const bool fold = !box_min;
    if (n < 0 || stride < 3 || (bits != 30 && bits != 63) || (!box_min) != (!box_max) ||
        (n > 0 && (!rows || !keys)) || (dirs && !lengths) ||
        (!fold && box_stride != 0 && box_stride != 1) || (fold && (!parts || max_blocks < 1)) ||
        device < 0 || device >= kMaxDevices) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n == 0) return static_cast<int>(cudaGetLastError());
    const int src = dirs ? kRays
                    : (stride == 4 && reinterpret_cast<uintptr_t>(rows) % 16 == 0) ? kSpheres
                                                                                   : kCentroids;
    const KeyArgs a = {rows, dirs, lengths, box_min, box_max, parts, keys, n, stride, box_stride};
    const KeyKernel kernel = key_kernel(src, fold, bits);
    if (!fold) {
        kernel<<<grid(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
        return static_cast<int>(cudaGetLastError());
    }
    int& per_sm = key_blocks_per_sm[device][src][bits == 30];
    if (per_sm == 0) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
        if (err == cudaSuccess) {
            err = cudaDeviceGetAttribute(&sm_count[device], cudaDevAttrMultiProcessorCount,
                                         device);
        }
        if (err != cudaSuccess || per_sm < 1) {
            per_sm = 0;
            return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidConfiguration);
        }
    }
    const int blocks = min(min(min(per_sm, kFoldBlocksPerSm) * sm_count[device], grid(n)),
                           max_blocks);
    void* args[] = {const_cast<KeyArgs*>(&a)};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                                      dim3(kThreads), args, 0,
                                      static_cast<cudaStream_t>(stream));
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
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

// The sort's gather in one launch: prims (prim 0: spheres f32[n, 4], 16-byte
// aligned; 1: triangles f32[n, 3, 3]) taken in the order of perm i64[n] into
// sorted (the same shape) and perm32 i32[n]; where mins is given, the sorted
// rows' boxes into mins, maxs f32[n, 3]; where kind >= 0 (grace_deltas'
// kinds; keys: the sorted keys i64[n] for the XOR kinds), the n - 1 deltas
// into out.
extern "C" int grace_gather_deltas(const float* prims, const long long* perm,
                                   const long long* keys, float* sorted, int32_t* perm32,
                                   float* mins, float* maxs, void* out, int n, int prim,
                                   int kind, int device, void* stream) {
    const bool xor_kind = kind == kXor30 || kind == kXor63;
    if (n < 0 || (prim != kSphere && prim != kTriangle) || kind < -1 || kind > kXor63 ||
        !prims || !perm || !sorted || !perm32 || (!mins) != (!maxs) ||
        (kind >= 0 && !out) || (xor_kind && !keys) ||
        (prim == kSphere && reinterpret_cast<uintptr_t>(prims) % 16 != 0)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n == 0) return static_cast<int>(cudaGetLastError());
    gather_deltas_kernel<<<grid(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        prims, perm, keys, sorted, perm32, mins, maxs, out, n, prim, kind);
    return static_cast<int>(cudaGetLastError());
}

// Phase A over deltas d[n - 1] (f32 where is_float, else i64), `block`
// primitives a block (0: default_block(n); at most 1024): l, r i32[n - 1]
// of every split; first, count i32[n] at the big leaves' slots; scratch
// i32[3n - 2]: the climb's flags u64[n - 1], then mark i32[n] (1 at those
// slots, 0 elsewhere), all zeroed here, in the stream.
extern "C" int grace_lbvh_ranges(const void* d, int32_t* l, int32_t* r, int32_t* first,
                                 int32_t* count, int32_t* scratch, int n, int max_per_leaf,
                                 int is_float, int block, int device, void* stream) {
    if (block == 0) block = default_block(n);
    if (n < 2 || max_per_leaf < 1 || max_per_leaf >= n || block < 2 || block > kBlock || !d ||
        !l || !r || !first || !count || !scratch ||
        reinterpret_cast<uintptr_t>(scratch) % 8 != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const auto s = static_cast<cudaStream_t>(stream);
    err = cudaMemsetAsync(scratch, 0, sizeof(int32_t) * (3 * static_cast<size_t>(n) - 2), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    auto* flags = reinterpret_cast<unsigned long long*>(scratch);
    int32_t* mark = scratch + 2 * (n - 1);
    const int blocks = (n + block - 1) / block, threads = climb_threads(block, kRangeThreads);
    if (is_float) {
        ranges_kernel<float><<<blocks, threads, 0, s>>>(static_cast<const float*>(d), l, r,
                                                        first, count, mark, flags, n,
                                                        max_per_leaf, block);
    } else {
        ranges_kernel<long long><<<blocks, threads, 0, s>>>(
            static_cast<const long long*>(d), l, r, first, count, mark, flags, n, max_per_leaf,
            block);
    }
    return static_cast<int>(cudaGetLastError());
}

// Phase B, `block` primitive slots a block (0: default_block(n); at most
// 1024): the tree over the big leaves that phase A marked (scan i32[n]: the
// inclusive prefix sum of mark; leaves of at most max_per_leaf primitives),
// boxes from mins, maxs f32[n, 3] of the sorted primitives: children i32[n
// - 1, 2], child_aabbs f32[n - 1, 2, 2, 3], leaves i32[n, 2], root,
// n_nodes, n_leaves i32[]. flags u32[n - 1] (zeroed here, in the stream)
// and ends i32[n - 1, 6] are scratch.
extern "C" int grace_lbvh_nodes(const void* d, const int32_t* first, const int32_t* count,
                                const int32_t* mark, const int32_t* scan, const float* mins,
                                const float* maxs, int32_t* children, float* child_aabbs,
                                int32_t* leaves, int32_t* root, int32_t* n_nodes,
                                int32_t* n_leaves, uint32_t* flags, int32_t* ends, int n,
                                int max_per_leaf, int is_float, int block, int device,
                                void* stream) {
    if (block == 0) block = default_block(n);
    if (n < 2 || max_per_leaf < 1 || block < 2 || block > kBlock || !d || !first || !count ||
        !mark || !scan || !mins || !maxs || !children || !child_aabbs || !leaves || !root ||
        !n_nodes || !n_leaves || !flags || !ends) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const auto s = static_cast<cudaStream_t>(stream);
    err = cudaMemsetAsync(flags, 0, sizeof(uint32_t) * (n - 1), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = (n + block - 1) / block, threads = climb_threads(block, kNodeThreads);
    // lanes a leaf: a quarter of the least power of two >= max_per_leaf, at
    // most 8, so that a lane takes up to 4 primitives and a warp 4 leaves or
    // more at once
    int group = 1;
    while (group < 8 && 4 * group < max_per_leaf) group <<= 1;
    if (is_float) {
        nodes_kernel<float><<<blocks, threads, 0, s>>>(
            static_cast<const float*>(d), first, count, mark, scan, mins, maxs, children,
            child_aabbs, leaves, root, n_nodes, n_leaves, flags, ends, n, block, group);
    } else {
        nodes_kernel<long long><<<blocks, threads, 0, s>>>(
            static_cast<const long long*>(d), first, count, mark, scan, mins, maxs, children,
            child_aabbs, leaves, root, n_nodes, n_leaves, flags, ends, n, block, group);
    }
    return static_cast<int>(cudaGetLastError());
}

// What one launch of build kernel `kernel` holds (0 keys, 1 deltas, 2
// gather_deltas, 3 ranges, 4 nodes, 5 the rays' keys; the keys 30-bit,
// their box folded in the launch, 0 on 16-byte sphere rows; the climbs with
// f32 deltas where is_float, at their default block): out = registers a
// thread, shared bytes a block, threads a block, resident blocks and warps
// an SM, local bytes a thread.
extern "C" int grace_build_resources(int* out, int kernel, int is_float, int device,
                                     void* stream) {
    (void)stream;
    if (!out || kernel < 0 || kernel > 5) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const void* fns[6] = {
        reinterpret_cast<const void*>(morton_keys_kernel<kSpheres, true, 30>),
        reinterpret_cast<const void*>(deltas_kernel),
        reinterpret_cast<const void*>(gather_deltas_kernel),
        is_float ? reinterpret_cast<const void*>(ranges_kernel<float>)
                 : reinterpret_cast<const void*>(ranges_kernel<long long>),
        is_float ? reinterpret_cast<const void*>(nodes_kernel<float>)
                 : reinterpret_cast<const void*>(nodes_kernel<long long>),
        reinterpret_cast<const void*>(morton_keys_kernel<kRays, true, 30>)};
    const int threads[6] = {kThreads, kThreads, kThreads, kRangeThreads, kNodeThreads, kThreads};
    cudaFuncAttributes attr;
    int blocks = 0;
    err = cudaFuncGetAttributes(&attr, fns[kernel]);
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fns[kernel],
                                                            threads[kernel], 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.sharedSizeBytes);
    out[2] = threads[kernel];
    out[3] = blocks;
    out[4] = blocks * threads[kernel] / 32;
    out[5] = static_cast<int>(attr.localSizeBytes);
    return 0;
}
