// The generic engine's BVH walk for the stock functor sets: a warp walks its
// 32 rays as one packet.
//
// Not a TPU kernel: it replaces grace_tpu/trace/engine.py:100-175, the body
// of the XLA engine's jax.lax.while_loop, which the port ran as a host loop
// of lockstep steps (trace/engine.py). grace_tpu's engine maps the CUDA
// original's walk (bintree_trace.cuh:52-197) onto all rays stepping together
// because a TPU has no threads. Here a warp shares one stack in shared
// memory, as the original's packet walk does (bintree_trace.cuh:96-102,
// 148-160, 178-191): each entry is a node (or ~leaf) and the mask of the
// lanes whose own walk holds it.
//
// The per-ray walk (walk(), one thread a ray with its own stack) is the
// lockstep walk's order, step for step, as engine.trace: pop the top entry
// (read at the column clamped to stack_size - 1); at an internal node test
// both child boxes, overwrite the popped entry with the left child if it
// was hit, else the right, and push the right child on top if both were; at
// a leaf test its <= max_per_leaf primitives in leaf order (ids clamped to
// the primitive array). Pushes past stack_size are dropped and the ray's
// overflow flag is set (1); a walk in that state can repeat one entry
// forever, so a ray stops after 4 (nodes + leaves) + 64 steps with flag 2.
//
// The packet walk keeps every lane's order. A step pops the top entry (lane
// mask M); the lanes of M test both child boxes, L and R are the ballots of
// their hits within M. Both non-zero: the popped slot takes (left, L) and
// (right, R) goes on top; one non-zero: the popped slot takes that child
// and its mask; none: the entry is popped. For every lane, the entries
// that carry its bit are exactly its own per-ray stack, in the same order
// (an entry without its bit only spawns entries without it), so each ray
// visits the same leaves in the same sequence as walk() and tests the
// same primitives in the same order with the same arithmetic: counts,
// records, ids, t, occlusion and the cumulative sums (a leaf's terms in
// leaf order, then the leaf's sum) are bit-equal to walk()'s. The top entry
// stays in registers; the entries below it sit in shared memory (kMaxStack
// of (i32 node, u32 mask), 1 KB a warp). A node's two boxes are one load of
// the same 48 bytes by every lane (a broadcast); a leaf's primitives are
// staged in shared memory in one coalesced load of up to kChunk (a float4
// a sphere, nine floats a triangle). Where M holds more than kPairLanes
// lanes, each of them tests the staged primitives in leaf order; where
// fewer, the warp tests the (ray, primitive) pairs one a lane (pair_pass:
// a ray fetched by shuffles from its lane, ceil(|M| n / 32) tests a lane
// instead of n) and each lane of M then takes its own pairs' hits in leaf
// order, so either way a ray's hits arrive in walk()'s order.
//
// Stack semantics stay exact: each lane counts its own depth (walk()'s sp).
// Where a lane's depth would pass stack_size, where the packet's entries
// would pass kMaxStack, or at walk()'s step bound, the warp stops and hands
// its 32 rays to walk() (the restart route: a second launch over the rays
// flagged kRedo), which walks them from the start: the truncation and the
// flags 1 and 2 are walk()'s own, and a record mode rewrites the slots the
// packet wrote with the same values. The optional stats output gives each
// warp's restart flag, packet steps and active lanes summed over them.
//
// Closest-hit pruning (triangles, at stacks of at least kPruneStack). A
// lane leaves a child's mask when the child box, widened by delta on every
// side, lies past its best t: its entry distance along the ray exceeds
// t_best (1 + 2^-20). Then no triangle in the box can replace the best:
// the computed hit of a triangle is t, u, v with u, v >= 0 and u + v <= 1,
// so Q = v0 + u (v1 - v0) + v (v2 - v0) lies in the triangle and hence in
// the box (f32 min / max of the vertices, by the builder); o + t d lies
// within the residual |o + t d - Q| of Q, so within the widened box when
// delta bounds the residual, and then t >= the widened box's entry >
// t_best: the strict < of the update keeps the best (ties keep the first
// triangle), now and after t_best falls. delta = 2^-8 (t_best + the box's
// largest extent + max |o|) bounds that residual for a triangle tested at
// |e1| |e2| / det up to about 2^12 (the Moller-Trumbore t, u, v round with
// a relative error of about 16 ulp times that ratio, of |s| <= t + |e|),
// and the f32 rounding of the widened planes (2^-24 of |o| + t + extent).
// The entry is computed as (plane - o) * inv, relative error 3 ulp, which
// the factor 1 + 2^-20 covers; a NaN entry (an origin on a widened plane
// with a zero direction component) prunes nothing. Pruning shortens a
// lane's own stack: below kPruneStack (stack_size 4 in the checks) the walk
// does not prune, so a walk the plain walk overflows restarts exactly;
// at kPruneStack and above a walk the plain walk would overflow may end
// unoverflowed with the true closest hit (trace/walk.py says so).
//
// Any-hit exit (triangles): a lane occluded in a leaf drops out of every
// later mask, and the warp stops when no lane is left. Occlusion is
// bit-equal (once set it stays set); the overflow flag and the visit counts
// of an occluded ray may differ from walk()'s.
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
// Outputs. The record pass writes each hit at its ray's cursor (the
// exclusive scan of the count pass) and drops writes at or past the
// capacity, as functors._scatter_hits does. visits counts each lane's own
// node and primitive tests.
//
// What bounds it on this card: the primitive tests' f32 <-> f64
// conversions. The exact fma_f64 converts its operands and result (a test
// takes tens of conversions; chip_ablation.py walk counts them in the
// compiled kernels), and the card converts 16 values an SM a clock, a
// quarter of its f64 rate, so a test costs the same whatever its lanes
// do. A test step that
// runs with few lanes wastes the rest: spatially sorted and fan-out rays
// share most of their walks (20-24 lanes a step), rays from scattered
// origins do not (3-6), and those leaf steps go by pairs, which fills the
// warp again. The node steps stay one a warp: their boxes are f32 tests.

#include <cstdint>

#include "async_copy.cuh"
#include "common.cuh"

namespace {

constexpr int kMaxStack = 128;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;            // leaf primitives a warp stages a pass
constexpr int kPairLanes = 16;        // leaf steps of at most this many lanes test by pairs
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-7f;         // models/triangle.EPS
constexpr float kInf = __builtin_huge_valf();
constexpr int kRedo = -1;             // overflow flag: handed back to walk()
constexpr int kPruneStack = 64;       // closest pruning at stacks of at least this
constexpr bool kPrune = true;         // closest-hit pruning (chip_ablation.py turns it off)
constexpr bool kAnyExit = true;       // the any-hit exit (likewise)
constexpr float kPruneScale = 0x1p-8f;
constexpr float kPruneSlack = 0x1p-20f;

constexpr int kCount = 0;       // i32 hit counts
constexpr int kCumulative = 1;  // f32 sums of lerp(table, (N-1) sqrt(b2)/h) / h^2
constexpr int kRecords = 2;     // (index, integral, distance) at each hit's cursor
constexpr int kIds = 3;         // (ray, prim) at each hit's cursor
constexpr int kClosest = 0;
constexpr int kAny = 1;
constexpr int kPacket = 0;      // route: the packet walk, restarts on walk()
constexpr int kPerRay = 1;      // route: walk() alone
constexpr int kStats = 3;       // a warp's stats: restarted, packet steps, active lanes summed

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
    float o[3], d[3], inv[3], len, omax;
};

struct Box {
    float lo[3], hi[3];
};

__device__ __forceinline__ Box load_box(const float* __restrict__ b) {
    return Box{{__ldg(b), __ldg(b + 1), __ldg(b + 2)}, {__ldg(b + 3), __ldg(b + 4), __ldg(b + 5)}};
}

// ops/intersect.aabbs_hit on one box.
__device__ __forceinline__ bool box_hit(const Ray& r, const Box& b) {
    float tnear[3], tfar[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float t0 = (b.lo[k] - r.o[k]) * r.inv[k];
        const float t1 = (b.hi[k] - r.o[k]) * r.inv[k];
        tnear[k] = min_nan(t0, t1);
        tfar[k] = max_nan(t0, t1);
    }
    const float tmin = max_nan(max_nan(tnear[0], tnear[1]), max_nan(tnear[2], 0.0f));
    const float tmax = min_nan(min_nan(tfar[0], tfar[1]), min_nan(tfar[2], r.len));
    return tmax >= tmin;
}

// Whether box b, widened by delta on every side, lies past t_best along
// the ray (the pruning test; the header says why delta suffices).
__device__ __forceinline__ bool beyond(const Ray& r, const Box& b, float t_best) {
    const float ext = fmaxf(fmaxf(b.hi[0] - b.lo[0], b.hi[1] - b.lo[1]), b.hi[2] - b.lo[2]);
    const float delta = kPruneScale * ((t_best + ext) + r.omax);
    float entry = -kInf;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float plane = r.inv[k] >= 0.0f ? b.lo[k] - delta : b.hi[k] + delta;
        entry = max_nan(entry, (plane - r.o[k]) * r.inv[k]);
    }
    return entry > t_best * (1.0f + kPruneSlack);
}

struct TreeView {
    const int32_t* __restrict__ children;   // [cap, 2]
    const float* __restrict__ child_aabbs;  // [cap, 2, 2, 3]
    const int32_t* __restrict__ leaves;     // [leaf_cap, 2]
    const int32_t* __restrict__ root;       // [] on the device
    int cap, leaf_cap, max_per_leaf, n_prims, stack_size;
};

__device__ __forceinline__ long long max_steps(const TreeView& t) {
    return 4LL * (t.cap + t.leaf_cap) + 64;
}

// The walk of one ray (the restart route and the per-ray route). leaf(p)
// runs for each primitive id p of a leaf, in leaf order, and leaf_end()
// after the leaf. Returns the per-ray flag: 0, 1 where the stack
// overflowed, 2 where the walk was cut at the step bound (an overflowed
// walk that repeats an entry forever); adds the internal nodes and the
// primitives tested to nodes, tested.
template <class Leaf, class LeafEnd>
__device__ __forceinline__ int walk(const TreeView& t, const Ray& r, Leaf leaf,
                                    LeafEnd leaf_end, int& nodes, int& tested) {
    int stack[kMaxStack];
    const int s = t.stack_size;
    stack[0] = __ldg(t.root);
    int sp = 1;
    int overflow = 0;
    const long long bound = max_steps(t);
    for (long long step = 0; sp > 0; ++step) {
        if (step == bound) return 2;
        const int top_col = sp - 1;
        const int top = stack[min(top_col, s - 1)];
        if (top >= 0) {
            const int node = min(top, t.cap - 1);
            const bool hit_l = box_hit(r, load_box(t.child_aabbs + node * 12));
            const bool hit_r = box_hit(r, load_box(t.child_aabbs + node * 12 + 6));
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

struct WarpStack {
    int node[kMaxStack];
    unsigned mask[kMaxStack];
};

struct PacketCounts {
    int steps = 0, lane_steps = 0;
};

// A leaf's staged primitives tested one (ray, primitive) pair a lane.
struct PairStage {
    int lane_of[32];   // the lane of the k-th ray of the mask
    int hit[32];
    float v0[32], v1[32];
};

// Tests staged primitives [0, n) against the rays of the k lanes of m,
// one pair a lane and round: pair q is (the (q % k)-th lane of m,
// primitive q / k), its ray fetched from that lane by shuffles.
// test(ray, j, v0, v1) gives a pair's hit and values; after each round
// every lane of m applies its own pairs of the round, apply(j, v0, v1), in
// primitive order (j grows with q), so each ray takes its hits in the
// order walk() does. A leaf costs ceil(k n / 32) tests a lane, not n.
template <class Test, class Apply>
__device__ __forceinline__ void pair_pass(const Ray& r, unsigned m, int n, PairStage& ps,
                                          Test test, Apply apply) {
    const int lane = threadIdx.x & 31;
    const unsigned me = 1u << lane;
    const bool in = (m & me) != 0;
    const int slot = __popc(m & (me - 1));
    if (in) ps.lane_of[slot] = lane;
    __syncwarp();
    const int k = __popc(m);
    const int pairs = k * n;
    for (int q0 = 0; q0 < pairs; q0 += 32) {
        const int q = q0 + lane;
        const int j = q / k;
        const int src = q < pairs ? ps.lane_of[q - j * k] : lane;
        Ray pr;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            pr.o[c] = __shfl_sync(kFull, r.o[c], src);
            pr.d[c] = __shfl_sync(kFull, r.d[c], src);
        }
        pr.len = __shfl_sync(kFull, r.len, src);
        float v0 = 0.0f, v1 = 0.0f;
        const bool hit = q < pairs && test(pr, j, v0, v1);
        ps.hit[lane] = hit;
        ps.v0[lane] = v0;
        ps.v1[lane] = v1;
        __syncwarp();
        if (in) {
            int x = slot - q0 % k;   // the round's first pair of this lane's ray
            if (x < 0) x += k;
            for (; x < 32 && q0 + x < pairs; x += k) {
                if (ps.hit[x]) apply((q0 + x) / k, ps.v0[x], ps.v1[x]);
            }
        }
        __syncwarp();
    }
}

// The packet walk of a warp's rays (lanes: the lanes that hold a ray; every
// lane of the warp calls it). prune(box) says whether this lane leaves a
// hit child box; leaf(first, count, m) tests a leaf's primitives, staged
// for the warp, for the lanes of m (every lane calls it) and returns the
// lanes that leave the walk (the any-hit exit). Returns true where the
// warp must hand its rays to walk(); adds this lane's node and primitive
// tests to nodes, tested.
template <class Prune, class LeafFn>
__device__ __forceinline__ bool packet_walk(const TreeView& t, const Ray& r, unsigned lanes,
                                            WarpStack& st, Prune prune, LeafFn leaf, int& nodes,
                                            int& tested, PacketCounts& pc) {
    const int lane = threadIdx.x & 31;
    const unsigned me = 1u << lane;
    const int s = t.stack_size;
    const long long bound = max_steps(t);
    int top = __ldg(t.root);
    unsigned m = lanes, live = lanes;
    int sp = 0;      // entries below the top, in st
    int depth = 1;   // this lane's own stack (walk()'s sp)
    for (;;) {
        if (m != 0) {
            if (pc.steps == bound) return true;
            ++pc.steps;
            pc.lane_steps += __popc(m);
            const bool in = (m & me) != 0;
            if (top >= 0) {
                const int node = min(top, t.cap - 1);
                const float4* nb = reinterpret_cast<const float4*>(t.child_aabbs) + 3 * node;
                const float4 b0 = __ldg(nb), b1 = __ldg(nb + 1), b2 = __ldg(nb + 2);
                const int2 ch = __ldg(reinterpret_cast<const int2*>(t.children) + node);
                const Box bl{{b0.x, b0.y, b0.z}, {b0.w, b1.x, b1.y}};
                const Box br{{b1.z, b1.w, b2.x}, {b2.y, b2.z, b2.w}};
                const bool hit_l = in && box_hit(r, bl) && !prune(bl);
                const bool hit_r = in && box_hit(r, br) && !prune(br);
                const unsigned L = __ballot_sync(kFull, hit_l);
                const unsigned R = __ballot_sync(kFull, hit_r);
                if (in) {
                    depth += static_cast<int>(hit_l) + static_cast<int>(hit_r) - 1;
                    ++nodes;
                }
                if (__any_sync(kFull, depth > s)) return true;
                if (L != 0 && R != 0) {
                    if (sp + 2 > kMaxStack) return true;
                    if (lane == 0) {
                        st.node[sp] = ch.x;
                        st.mask[sp] = L;
                    }
                    ++sp;
                    top = ch.y;
                    m = R;
                    continue;
                }
                if ((L | R) != 0) {
                    top = L != 0 ? ch.x : ch.y;
                    m = L | R;
                    continue;
                }
            } else {
                const int lf = min(max(~top, 0), t.leaf_cap - 1);
                const int2 fc = __ldg(reinterpret_cast<const int2*>(t.leaves) + lf);
                const int count = min(fc.y, t.max_per_leaf);
                live &= ~leaf(fc.x, count, m);
                if (in) {
                    tested += max(count, 0);
                    --depth;
                }
            }
        }
        if (sp == 0 || live == 0) return false;
        __syncwarp();
        --sp;
        top = st.node[sp];
        m = st.mask[sp] & live;
        __syncwarp();
    }
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
    r.omax = fmaxf(fmaxf(fabsf(r.o[0]), fabsf(r.o[1])), fabsf(r.o[2]));
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
    int32_t* stats;
    int n_rays, table_n, capacity;
    int redo;   // the per-ray kernel walks only the rays flagged kRedo
};

// One ray's SPH state: what a hit adds in each mode, and the outputs.
template <int kMode>
struct SphRay {
    int hits = 0, cursor = 0;
    float sum = 0.0f, leaf_sum = 0.0f;

    // Sphere s (weight at *w where the weights are given) against r: the
    // hit, and what it gives (cumulative: the weighted term; records: the
    // integral and the distance).
    static __device__ __forceinline__ bool pair(const Ray& r, float4 s, const float* w,
                                                const SphArgs& a, float& v0, float& v1) {
        float b2, dist;
        if (!sphere_hit(r, s, b2, dist)) return false;
        if (kMode == kCumulative) {
            v0 = sph_integral(b2, s.w, a.table, a.table_n);
            if (a.weights != nullptr) v0 = v0 * *w;
        } else if (kMode == kRecords) {
            v0 = sph_integral(b2, s.w, a.table, a.table_n);
            v1 = dist;
        }
        return true;
    }

    // A hit of sphere p on ray i, in walk order.
    __device__ __forceinline__ void apply(int p, float v0, float v1, const SphArgs& a, int i) {
        if (kMode == kCount) {
            ++hits;
        } else if (kMode == kCumulative) {
            leaf_sum += v0;
        } else {
            if (cursor < a.capacity) {
                if (kMode == kRecords) {
                    static_cast<int32_t*>(a.out0)[cursor] = p;
                    static_cast<float*>(a.out1)[cursor] = v0;
                    static_cast<float*>(a.out2)[cursor] = v1;
                } else {
                    static_cast<int32_t*>(a.out0)[cursor] = i;
                    static_cast<int32_t*>(a.out1)[cursor] = p;
                }
            }
            ++cursor;
        }
    }

    __device__ __forceinline__ void test(const Ray& r, float4 s, int p, const float* w,
                                         const SphArgs& a, int i) {
        float v0 = 0.0f, v1 = 0.0f;
        if (pair(r, s, w, a, v0, v1)) apply(p, v0, v1, a, i);
    }

    __device__ __forceinline__ void leaf_end() {
        if (kMode == kCumulative) {
            sum += leaf_sum;
            leaf_sum = 0.0f;
        }
    }

    __device__ __forceinline__ void finish(const SphArgs& a, int i, int flag, int nodes,
                                           int tested) const {
        a.overflow[i] = flag;
        if (kMode == kCount) static_cast<int32_t*>(a.out0)[i] = hits;
        if (kMode == kCumulative) static_cast<float*>(a.out0)[i] = sum;
        if (a.visits != nullptr) {
            a.visits[2 * i] = nodes;
            a.visits[2 * i + 1] = tested;
        }
    }
};

// walk() over each ray (with a.redo: over the rays the packet flagged kRedo).
template <int kMode>
__global__ void __launch_bounds__(kThreads) walk_sph_kernel(TreeView t, SphArgs a) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= a.n_rays || (a.redo && a.overflow[i] != kRedo)) return;
    const Ray r = load_ray(a.origins, a.directions, a.lengths, i);
    SphRay<kMode> ray;
    if (kMode == kRecords || kMode == kIds) ray.cursor = a.cursors[i];
    int nodes = 0, tested = 0;
    const int flag = walk(t, r, [&](int p) {
        ray.test(r, __ldg(a.spheres + p), p, a.weights == nullptr ? nullptr : a.weights + p, a,
                 i);
    }, [&] { ray.leaf_end(); }, nodes, tested);
    ray.finish(a, i, flag, nodes, tested);
}

struct SphStage {
    float4 s[kChunk];
    float w[kChunk];
    int id[kChunk];
};

// The packet walk: one warp 32 rays.
template <int kMode>
__global__ void __launch_bounds__(kThreads) packet_sph_kernel(TreeView t, SphArgs a) {
    __shared__ WarpStack stacks[kWarps];
    __shared__ SphStage stages[kWarps];
    __shared__ PairStage pairs[kWarps];
    const int lane = threadIdx.x & 31;
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i - lane >= a.n_rays) return;   // the whole warp
    const bool valid = i < a.n_rays;
    const unsigned lanes = __ballot_sync(kFull, valid);
    const Ray r = load_ray(a.origins, a.directions, a.lengths, valid ? i : i - lane);
    SphRay<kMode> ray;
    if ((kMode == kRecords || kMode == kIds) && valid) ray.cursor = a.cursors[i];
    SphStage& sg = stages[threadIdx.x >> 5];
    auto leaf = [&](int first, int count, unsigned m) -> unsigned {
        const bool in = (m >> lane) & 1u;
        for (int base = 0; base < count; base += kChunk) {
            const int n = min(kChunk, count - base);
            __syncwarp();
            if (lane < n) {
                const int p = min(max(first + base + lane, 0), t.n_prims - 1);
                sg.s[lane] = __ldg(a.spheres + p);
                sg.id[lane] = p;
                if (kMode == kCumulative && a.weights != nullptr) sg.w[lane] = __ldg(a.weights + p);
            }
            __syncwarp();
            if (__popc(m) > kPairLanes) {
                if (in) {
                    for (int j = 0; j < n; ++j) ray.test(r, sg.s[j], sg.id[j], &sg.w[j], a, i);
                }
                continue;
            }
            pair_pass(r, m, n, pairs[threadIdx.x >> 5],
                      [&](const Ray& pr, int j, float& v0, float& v1) {
                          return SphRay<kMode>::pair(pr, sg.s[j], &sg.w[j], a, v0, v1);
                      },
                      [&](int j, float v0, float v1) { ray.apply(sg.id[j], v0, v1, a, i); });
        }
        if (in) ray.leaf_end();
        return 0u;
    };
    int nodes = 0, tested = 0;
    PacketCounts pc;
    const bool redo = packet_walk(t, r, lanes, stacks[threadIdx.x >> 5],
                                  [](const Box&) { return false; }, leaf, nodes, tested, pc);
    if (a.stats != nullptr && lane == 0) {
        a.stats[kStats * (i >> 5)] = redo;
        a.stats[kStats * (i >> 5) + 1] = pc.steps;
        a.stats[kStats * (i >> 5) + 2] = pc.lane_steps;
    }
    if (!valid) return;
    if (redo) {
        a.overflow[i] = kRedo;
        return;
    }
    ray.finish(a, i, 0, nodes, tested);
}

// models/triangle.intersect_triangle (Moller-Trumbore with back-face
// culling; only det > eps counts) against the triangle's nine floats at
// tri: hit and t.
__device__ __forceinline__ bool triangle_hit(const Ray& r, const float* tri, float& t) {
    float v0[3], e1[3], e2[3], s[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        v0[k] = tri[k];
        e1[k] = tri[3 + k] - v0[k];
        e2[k] = tri[6 + k] - v0[k];
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
    int32_t* stats;
    int n_rays;
    int redo;
};

// Closest: the least t by a strict < in walk order, so a tie keeps the first
// triangle (trace_closest_hit's argmin a leaf, then a strict < across
// leaves). Any: whether any triangle is hit.
template <int kMode>
struct TriRay {
    float t_min = kInf;
    int best = -1;
    bool occluded = false;

    // A hit of triangle p at t, in walk order.
    __device__ __forceinline__ void apply(int p, float tp) {
        if (kMode == kAny) {
            occluded = true;
        } else if (tp < t_min) {
            t_min = tp;
            best = p;
        }
    }

    __device__ __forceinline__ void test(const Ray& r, const float* tri, int p) {
        float tp;
        if (triangle_hit(r, tri, tp)) apply(p, tp);
    }

    __device__ __forceinline__ void finish(const TriArgs& a, int i, int flag, int nodes,
                                           int tested) const {
        a.overflow[i] = flag;
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
};

// walk() over each ray (with a.redo: over the rays the packet flagged
// kRedo); any-hit runs each walk to its end, as the plain walk does.
template <int kMode>
__global__ void __launch_bounds__(kThreads) walk_tri_kernel(TreeView t, TriArgs a) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= a.n_rays || (a.redo && a.overflow[i] != kRedo)) return;
    const Ray r = load_ray(a.origins, a.directions, a.lengths, i);
    TriRay<kMode> ray;
    int nodes = 0, tested = 0;
    const int flag = walk(t, r, [&](int p) { ray.test(r, a.tris + 9 * p, p); }, [] {}, nodes,
                          tested);
    ray.finish(a, i, flag, nodes, tested);
}

struct TriStage {
    float v[9 * kChunk];
    int id[kChunk];
};

// The packet walk, with closest-hit pruning and the any-hit exit.
template <int kMode>
__global__ void __launch_bounds__(kThreads) packet_tri_kernel(TreeView t, TriArgs a) {
    __shared__ WarpStack stacks[kWarps];
    __shared__ TriStage stages[kWarps];
    __shared__ PairStage pairs[kWarps];
    const int lane = threadIdx.x & 31;
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i - lane >= a.n_rays) return;   // the whole warp
    const bool valid = i < a.n_rays;
    const unsigned lanes = __ballot_sync(kFull, valid);
    const Ray r = load_ray(a.origins, a.directions, a.lengths, valid ? i : i - lane);
    TriRay<kMode> ray;
    TriStage& sg = stages[threadIdx.x >> 5];
    const bool pruning = kPrune && kMode == kClosest && t.stack_size >= kPruneStack;
    auto prune = [&](const Box& b) {
        return pruning && ray.t_min < kInf && beyond(r, b, ray.t_min);
    };
    auto leaf = [&](int first, int count, unsigned m) -> unsigned {
        const bool in = (m >> lane) & 1u;
        for (int base = 0; base < count; base += kChunk) {
            const int n = min(kChunk, count - base);
            __syncwarp();
            for (int k = lane; k < 9 * n; k += 32) {
                const int p = min(max(first + base + k / 9, 0), t.n_prims - 1);
                sg.v[k] = __ldg(a.tris + 9 * p + k % 9);
            }
            if (lane < n) sg.id[lane] = min(max(first + base + lane, 0), t.n_prims - 1);
            __syncwarp();
            if (__popc(m) > kPairLanes) {
                if (in) {
                    for (int j = 0; j < n; ++j) ray.test(r, sg.v + 9 * j, sg.id[j]);
                }
                continue;
            }
            pair_pass(r, m, n, pairs[threadIdx.x >> 5],
                      [&](const Ray& pr, int j, float& v0, float&) {
                          return triangle_hit(pr, sg.v + 9 * j, v0);
                      },
                      [&](int j, float v0, float) { ray.apply(sg.id[j], v0); });
        }
        return kMode == kAny && kAnyExit ? __ballot_sync(kFull, ray.occluded) : 0u;
    };
    int nodes = 0, tested = 0;
    PacketCounts pc;
    const bool redo = packet_walk(t, r, lanes, stacks[threadIdx.x >> 5], prune, leaf, nodes,
                                  tested, pc);
    if (a.stats != nullptr && lane == 0) {
        a.stats[kStats * (i >> 5)] = redo;
        a.stats[kStats * (i >> 5) + 1] = pc.steps;
        a.stats[kStats * (i >> 5) + 2] = pc.lane_steps;
    }
    if (!valid) return;
    if (redo) {
        a.overflow[i] = kRedo;
        return;
    }
    ray.finish(a, i, 0, nodes, tested);
}

bool tree_ok(const TreeView& t) {
    return t.children && t.child_aabbs && t.leaves && t.root && t.cap >= 1 &&
           t.leaf_cap >= 1 && t.max_per_leaf >= 1 && t.n_prims >= 1 && t.stack_size >= 1 &&
           t.stack_size <= kMaxStack && aligned16(t.child_aabbs) &&
           reinterpret_cast<uintptr_t>(t.children) % 8 == 0 &&
           reinterpret_cast<uintptr_t>(t.leaves) % 8 == 0;
}

int blocks(int n_rays) { return (n_rays + kThreads - 1) / kThreads; }

// The packet kernel, then walk() over the rays it handed back (route
// kPacket); walk() over every ray (kPerRay).
template <class Args>
cudaError_t launch_route(void (*packet)(TreeView, Args), void (*per_ray)(TreeView, Args),
                         const TreeView& t, Args a, int route, cudaStream_t s) {
    a.redo = 0;
    if (route == kPacket) {
        packet<<<blocks(a.n_rays), kThreads, 0, s>>>(t, a);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return err;
        a.redo = 1;
    }
    per_ray<<<blocks(a.n_rays), kThreads, 0, s>>>(t, a);
    return cudaGetLastError();
}

}  // namespace

// One launch of the SPH walk. mode 0 (count): out0 i32[R] hit counts.
// mode 1 (cumulative): out0 f32[R] sums over table f32[table_n], times
// weights[p] where weights is not null. mode 2 (records): each hit's
// (index i32, integral f32, distance f32) into out0, out1, out2 at the
// ray's cursor (cursors i32[R], advancing by one a hit), writes at or past
// capacity dropped. mode 3 (ids): (ray i32, prim i32) into out0, out1 the
// same way. overflow i32[R]: 1 where the stack overflowed, 2 where the
// walk was cut at the step bound (walk's flag). visits (i32[R, 2], or
// null): internal nodes tested, primitives tested. route 0: the packet
// walk, stats (i32[ceil(R / 32), 3], or null) its warps' (restarted,
// packet steps, active lanes summed over the steps); route 1: walk() over
// every ray (stats null). child_aabbs 16-byte aligned, children and leaves
// 8-byte aligned, spheres 16-byte aligned.
extern "C" int grace_walk_sph(const float* origins, const float* directions,
                              const float* lengths, const float* spheres,
                              const int32_t* children, const float* child_aabbs,
                              const int32_t* leaves, const int32_t* root, const float* table,
                              const float* weights, const int32_t* cursors, void* out0,
                              void* out1, void* out2, int32_t* visits, int32_t* overflow,
                              int32_t* stats, int n_rays, int n_prims, int cap, int leaf_cap,
                              int max_per_leaf, int stack_size, int table_n, int mode,
                              int capacity, int route, int device, void* stream) {
    const TreeView t{children, child_aabbs, leaves, root, cap, leaf_cap, max_per_leaf, n_prims,
                     stack_size};
    const SphArgs a{origins, directions, lengths, reinterpret_cast<const float4*>(spheres),
                    table, weights, cursors, out0, out1, out2, visits, overflow, stats, n_rays,
                    table_n, capacity, 0};
    const bool uses_table = mode == kCumulative || mode == kRecords;
    const bool writes = mode == kRecords || mode == kIds;
    if (mode < kCount || mode > kIds || n_rays < 0 || !tree_ok(t) || !origins ||
        !directions || !lengths || !spheres || !aligned16(spheres) || !overflow || !out0 ||
        (uses_table && (!table || table_n < 2)) ||
        (writes && (!cursors || !out1 || capacity < 0)) || (mode == kRecords && !out2) ||
        (route != kPacket && route != kPerRay) || (route == kPerRay && stats)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_rays == 0) return static_cast<int>(cudaGetLastError());
    const auto s = static_cast<cudaStream_t>(stream);
    switch (mode) {
        case kCount:
            err = launch_route(packet_sph_kernel<kCount>, walk_sph_kernel<kCount>, t, a, route, s);
            break;
        case kCumulative:
            err = launch_route(packet_sph_kernel<kCumulative>, walk_sph_kernel<kCumulative>, t, a,
                               route, s);
            break;
        case kRecords:
            err = launch_route(packet_sph_kernel<kRecords>, walk_sph_kernel<kRecords>, t, a,
                               route, s);
            break;
        default:
            err = launch_route(packet_sph_kernel<kIds>, walk_sph_kernel<kIds>, t, a, route, s);
            break;
    }
    return static_cast<int>(err);
}

// One launch of the triangle walk over tris f32[n_prims, 3, 3]. mode 0
// (closest): out0 f32[R] least t (inf: no hit), out1 i32[R] its triangle
// (-1: no hit). mode 1 (any): out0 bool[R] occluded. overflow, visits,
// stats and route as grace_walk_sph's.
extern "C" int grace_walk_tri(const float* origins, const float* directions,
                              const float* lengths, const float* tris, const int32_t* children,
                              const float* child_aabbs, const int32_t* leaves,
                              const int32_t* root, void* out0, int32_t* out1, int32_t* visits,
                              int32_t* overflow, int32_t* stats, int n_rays, int n_prims,
                              int cap, int leaf_cap, int max_per_leaf, int stack_size, int mode,
                              int route, int device, void* stream) {
    const TreeView t{children, child_aabbs, leaves, root, cap, leaf_cap, max_per_leaf, n_prims,
                     stack_size};
    const TriArgs a{origins, directions, lengths, tris, out0, out1, visits, overflow, stats,
                    n_rays, 0};
    if ((mode != kClosest && mode != kAny) || n_rays < 0 || !tree_ok(t) || !origins ||
        !directions || !lengths || !tris || !overflow || !out0 ||
        (mode == kClosest && !out1) || (route != kPacket && route != kPerRay) ||
        (route == kPerRay && stats)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_rays == 0) return static_cast<int>(cudaGetLastError());
    const auto s = static_cast<cudaStream_t>(stream);
    if (mode == kClosest) {
        err = launch_route(packet_tri_kernel<kClosest>, walk_tri_kernel<kClosest>, t, a, route, s);
    } else {
        err = launch_route(packet_tri_kernel<kAny>, walk_tri_kernel<kAny>, t, a, route, s);
    }
    return static_cast<int>(err);
}

// What one launch holds: out = registers a thread, shared bytes a block,
// threads a block, resident blocks and warps an SM, local bytes a thread
// (walk()'s stack). kind 0: the SPH walk in mode `mode`; 1: the triangle
// walk in mode `mode`; route 0: the packet kernel, 1: walk()'s kernel.
extern "C" int grace_walk_resources(int* out, int kind, int mode, int route, int device,
                                    void* stream) {
    (void)stream;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const void* kernels[2][2][4] = {
        {{reinterpret_cast<const void*>(packet_sph_kernel<kCount>),
          reinterpret_cast<const void*>(packet_sph_kernel<kCumulative>),
          reinterpret_cast<const void*>(packet_sph_kernel<kRecords>),
          reinterpret_cast<const void*>(packet_sph_kernel<kIds>)},
         {reinterpret_cast<const void*>(packet_tri_kernel<kClosest>),
          reinterpret_cast<const void*>(packet_tri_kernel<kAny>), nullptr, nullptr}},
        {{reinterpret_cast<const void*>(walk_sph_kernel<kCount>),
          reinterpret_cast<const void*>(walk_sph_kernel<kCumulative>),
          reinterpret_cast<const void*>(walk_sph_kernel<kRecords>),
          reinterpret_cast<const void*>(walk_sph_kernel<kIds>)},
         {reinterpret_cast<const void*>(walk_tri_kernel<kClosest>),
          reinterpret_cast<const void*>(walk_tri_kernel<kAny>), nullptr, nullptr}}};
    if (kind < 0 || kind > 1 || mode < 0 || mode > 3 || route < kPacket || route > kPerRay ||
        !kernels[route][kind][mode]) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const void* kernel = kernels[route][kind][mode];
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
    out[5] = static_cast<int>(attr.localSizeBytes);
    return 0;
}
