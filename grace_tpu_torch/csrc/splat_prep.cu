// The splat's two setups on the card: the bucketed splat's instance keys
// and slabs (E4), and the sort-free splat's projection, slabs and overlap
// masks (E5).
//
// Not TPU kernels: both setups are plain XLA in grace_tpu, outside any
// Pallas kernel. E4 replaces grace_tpu/trace/splat.py:122-265
// (bucket_prims_ortho: projection, depth cull, four (row tile x column
// band) keys a particle, one multi-payload lax.sort, _sorted_first_counts
// at :74 and the slab packing); E5 replaces grace_tpu/trace/splat_grad.py
// :108 (project_ortho), :131 (pack_proj_slabs), :141 (projected_overlap)
// and grace_tpu/trace/pallas_broadphase.py:59 (pack_overlap_bits, on the
// overlap and on its transpose). The port ran them as chains of a few
// dozen small torch launches over 2^20 particles and 4 x 2^20 instances.
//
// E4, two launches; a block owns a tile of
// `tile` consecutive particles (BUCKET_TILE, grown where the counters
// would pass BUCKET_COUNTS) in both, and with it four tiles of the instance
// order, q * n + p0 .. q * n + p1 (tile q * blocks + b of block b).
//
// particle_keys: a particle's four keys, slab row and overflow. pu, pv and
// depth are the port's vecmath.dot3 (x * x in f32, then two multiply-adds
// that each take the exact f64 product plus the sum, rounded once to f32:
// fma_f64), the reciprocals IEEE divisions (torch's 1.0 / t is
// reciprocal(t) * 1.0), --fmad=false keeps every other operation rounded
// alone. The band and row-tile quotients are floored and converted to
// int64 as torch's .to(torch.int64) does on the card (cvt.rzi: saturating,
// NaN -> 0), and the int64 arithmetic after them wraps as torch's does.
// Instance q = 2 rr + cc (the torch.cat order) takes key rt * nbx + cb or
// the sentinel n_keys; the row is (pu, pv, invh, scale) as the slabs take
// them (unweighted: invh masked by the depth cull and scale = invh^2, as
// the plain path derives it after the sort).
//
// bucket_keys_kernel (pass 1): a thread loads its next kLoads particles
// (16-byte sphere loads, then the weights) before any arithmetic, takes
// their keys, and for each q groups the warp's 32 lanes by key
// (__match_any_sync); the group's first lane adds its size to the block's
// (q, bin) counter, in shared memory up to kSharedBins bins, else in the
// block's own column of the device counters.
// Integer sums: any order gives the same counts. The block then writes its
// column, counts[bin * tiles + q * blocks + b] (key-major, as the scan
// takes them), every counter once, so nothing is zeroed first; an extra
// row bin = n_bins holds the block's overflow flag. It also zeroes pass
// 2's scan state.
//
// scan_counters, at the start of pass 2: the counters' exclusive scan in
// place gives each (bin, tile) pair its first slot. The blocks take rows
// (a bin's counters) by ticket, scan them and chain them by a decoupled
// look-back, and write each key's range [first, last), slab_lo and n_slabs
// and, from the flag row's total (the number of blocks that overflowed),
// the overflow byte; then every block waits for the last row. Each ticket
// goes to a running block, which waits only on lower tickets, so no block
// waits on one that cannot run.
//
// bucket_pack_kernel (pass 2): the block recomputes its particles' keys
// and rows in the same order (the same device function under the same
// flags: the same bits), with cursors at its pairs' first slots. A round
// is kPrepThreads consecutive particles; for each q a lane's rank is the
// __popc of its lower peers, its warp's offset the sizes of its key's
// groups in the round's lower warps: each group's first lane writes its
// size into byte `warp` of the key's 8-byte word, and a lane sums the
// bytes below its warp's (a multiply by 0x0101...01: at most 7 x 32 <
// 256), one load and no loop. So instances of one key take their slots in
// instance order, as a stable sort puts them. Each writes its row's four
// floats at its slot's slab position; after the round the groups' first
// lanes move the cursors on and clear their bytes. Past kSharedBins bins
// the words and cursors live in device memory (a scratch past the scan
// state, the block's column of the counters). The grid also zeroes the
// slab columns [4 n, cap): no order tensor, no row gather, no memset, no
// launch between the passes.
//
// What bounds E4: memory. The function reads the spheres (16 B a
// particle, the weights 4 B) and writes the slabs (64 B a particle):
// ~84 MB at 2^20 particles. Pass 2 reads the spheres again (16.8 MB,
// cheaper than keeping keys and rows, 67 MB written and read); the
// counters are 4 (n_bins + 1) a block (0.5 MB on the bench).
//
// sortfree_setup_kernel: a block of 32 warps owns 32 segments of 128
// particles, one mask word, and a warp owns a segment, so that 32 warps an
// SM are in flight: a lane's loads and f64 arithmetic are a chain of
// dependent steps, whose latency only many warps hide. Lane l owns
// particles 4 l .. 4 l + 3: it
// issues their four 16-byte sphere loads (and their weights) before any
// arithmetic, projects them with project_ortho's arithmetic, and writes
// each of the eight slab rows (pu, pv, invh, scale, then four of zeros) as
// one float4, a coalesced 512-byte row a warp. The warp then reduces the
// segment's live-masked box (h_eff = 1 / clamp(invh, 1e-30), the +-3.4e38
// sentinels of dead and padding particles). The boxes go to shared memory;
// then one __ballot_sync over the 32 segments against a tile's pixel-centre
// span gives that tile's word of the masks, and one over 32 tiles against
// a segment's box a word of the transposed masks. Min and max of the box
// are exact (the sentinels keep NaN out), and the overlap compares them, so
// neither the lanes' order nor -0 and +0 change a bit.
//
// What bounds E5: memory. Each particle is read once and each output
// written once: at 2^20 particles ~52 MB (spheres 16 MB, slabs 32 MB,
// masks), one launch over all particles, with the camera's constants in a
// small device tensor and no host round trip.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kSeg = 128;            // particles a segment (splat_grad.SEG)
constexpr int kSegsPerBlock = 32;    // segments a setup block: one mask word
constexpr int kSetupWarps = kSegsPerBlock;  // warps a setup block: a warp a segment
constexpr int kLanePrims = kSeg / 32;       // particles a lane: one float4 of a slab row
static_assert(kLanePrims == 4, "a lane's particles fill one float4 of each slab row");
constexpr float kBig = 3.4e38f;      // projected_overlap's box sentinel
constexpr float kTiny = 1e-30f;      // the clamps' floor, as f32

// Constants (f32): 0-2 view_dir, 3-5 v, 6-8 u, 9-11 camera position, 12
// length; the bucketed setup adds 13 x0, 14 y0, 15 dx * band, 16 dy *
// tile_w (splat.BUCKET_CONSTS, splat_grad.SETUP_CONSTS).
constexpr int kViewDir = 0;
constexpr int kV = 3;
constexpr int kU = 6;
constexpr int kCam = 9;
constexpr int kLength = 12;
constexpr int kX0 = 13;
constexpr int kY0 = 14;
constexpr int kBandStep = 15;
constexpr int kTileStep = 16;

// vecmath.fma: the exact f64 product plus c, rounded to f64, then to f32.
__device__ __forceinline__ float fma_f64(float a, float b, float c) {
    return __double2float_rn(static_cast<double>(a) * static_cast<double>(b) +
                             static_cast<double>(c));
}

// vecmath.dot3 of (x, y, z) with consts[k..k+2].
__device__ __forceinline__ float dot3(float x, float y, float z, const float* c) {
    return fma_f64(z, c[2], fma_f64(y, c[1], x * c[0]));
}

// torch.floor(q).to(torch.int64) on the card.
__device__ __forceinline__ long long floor_i64(float q) {
    return static_cast<long long>(floorf(q));
}

// int64 + and - that wrap, as torch's int64 kernels do.
__device__ __forceinline__ long long wrap_add(long long a, long long b) {
    return static_cast<long long>(static_cast<unsigned long long>(a) +
                                  static_cast<unsigned long long>(b));
}

__device__ __forceinline__ long long wrap_sub(long long a, long long b) {
    return static_cast<long long>(static_cast<unsigned long long>(a) -
                                  static_cast<unsigned long long>(b));
}

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPrepThreads = 256;   // threads a block of E4's two passes
constexpr int kPrepWarps = kPrepThreads / 32;
static_assert(kPrepWarps <= 8, "a key's warp counts, a byte a warp, fill one 8-byte word");
constexpr int kLoads = 4;           // particles a thread loads before any arithmetic
constexpr int kSharedBins = 1000;   // bins a block holds in 48 KB of shared memory, at most

struct Particle {
    int key[4];   // instance q's key, the sentinel n_keys where it draws nothing
    float4 row;   // (pu, pv, invh, scale) as the slabs take them
    bool over;    // a live footprint wider than a 2 x 2 neighbourhood
};

__device__ __forceinline__ Particle particle_keys(float4 s, float w, bool weighted,
                                                  const float* __restrict__ consts, int nbx,
                                                  int nty, int n_keys) {
    Particle a;
    const float h = s.w;
    const float pu = dot3(s.x, s.y, s.z, consts + kV);
    const float pv = dot3(s.x, s.y, s.z, consts + kU);
    const float depth = dot3(s.x - consts[kCam], s.y - consts[kCam + 1],
                             s.z - consts[kCam + 2], consts + kViewDir);
    const bool positive = h > 0.0f;
    const float inv_h2 = positive ? 1.0f / fmaxf(h * h, kTiny) : 0.0f;
    const float w_p = weighted ? w * inv_h2 : inv_h2;
    const bool live = positive && depth >= 0.0f && depth < consts[kLength];
    const float scale = live ? w_p : 0.0f;

    const float x0 = consts[kX0], y0 = consts[kY0];
    const float band_step = consts[kBandStep], tile_step = consts[kTileStep];
    const long long cb_lo = floor_i64(((pu - h) - x0) / band_step);
    long long cb_hi = floor_i64(((pu + h) - x0) / band_step);
    const long long rt_lo = floor_i64(((pv + h) - y0) / tile_step);   // rows descend
    long long rt_hi = floor_i64(((pv - h) - y0) / tile_step);
    a.over = live && (wrap_sub(cb_hi, cb_lo) > 1 || wrap_sub(rt_hi, rt_lo) > 1);
    const long long cb_next = wrap_add(cb_lo, 1), rt_next = wrap_add(rt_lo, 1);
    cb_hi = cb_hi < cb_next ? cb_hi : cb_next;
    rt_hi = rt_hi < rt_next ? rt_hi : rt_next;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
            const long long cb = wrap_add(cb_lo, cc), rt = wrap_add(rt_lo, rr);
            const bool ok = cb <= cb_hi && rt <= rt_hi && cb >= 0 && cb < nbx && rt >= 0 &&
                            rt < nty && scale > 0.0f;
            a.key[rr * 2 + cc] = ok ? static_cast<int>(rt * nbx + cb) : n_keys;
        }
    }
    const float invh = positive ? 1.0f / fmaxf(h, kTiny) : 0.0f;
    if (weighted) {
        a.row = make_float4(pu, pv, invh, scale);
    } else {
        const float invh_s = live ? invh : 0.0f;
        a.row = make_float4(pu, pv, invh_s, invh_s * invh_s);
    }
    return a;
}

// Block b's counter of (bin, q) among the key-major counters of 4 x
// gridDim.x tiles.
__device__ __forceinline__ long long counter(int bin, int q, int tiles) {
    return static_cast<long long>(bin) * tiles + q * gridDim.x + blockIdx.x;
}

// A block's particles [p0, p1) and the loop over them, kLoads rounds of
// kPrepThreads at a time: each thread's spheres and weights loaded first.
struct Tile {
    int p0, p1;
    __device__ Tile(int n, int tile) {
        const long long lo = static_cast<long long>(blockIdx.x) * tile;
        p0 = static_cast<int>(lo < n ? lo : n);
        p1 = static_cast<int>(lo + tile < n ? lo + tile : n);
    }
};

__device__ __forceinline__ void load_particles(const float4* __restrict__ spheres,
                                               const float* __restrict__ weights, int base,
                                               int p1, float4* s, float* w) {
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
        const int p = base + k * kPrepThreads + threadIdx.x;
        s[k] = p < p1 ? spheres[p] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
        const int p = base + k * kPrepThreads + threadIdx.x;
        w[k] = weights && p < p1 ? weights[p] : 1.0f;
    }
}

template <bool kShared>
__global__ void __launch_bounds__(kPrepThreads)
    bucket_keys_kernel(const float4* __restrict__ spheres, const float* __restrict__ weights,
                       const float* __restrict__ consts, int* __restrict__ counts, int n,
                       int tile, int nbx, int nty, int n_keys) {
    extern __shared__ int s_counts[];   // [4][n_bins] where kShared
    const int n_bins = n_keys + 1, tiles = 4 * gridDim.x;
    const int lane = threadIdx.x % 32;
    const Tile t(n, tile);
    for (int i = threadIdx.x; i < 4 * n_bins; i += kPrepThreads) {
        if (kShared) {
            s_counts[i] = 0;
        } else {
            counts[counter(i % n_bins, i / n_bins, tiles)] = 0;
        }
    }
    __syncthreads();
    bool over = false;
    for (int base = t.p0; base < t.p1; base += kLoads * kPrepThreads) {
        float4 s[kLoads];
        float w[kLoads];
        load_particles(spheres, weights, base, t.p1, s, w);
#pragma unroll
        for (int k = 0; k < kLoads; ++k) {
            const bool valid = base + k * kPrepThreads + static_cast<int>(threadIdx.x) < t.p1;
            const Particle a = particle_keys(s[k], w[k], weights != nullptr, consts, nbx, nty,
                                             n_keys);
            over |= valid && a.over;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int key = valid ? a.key[q] : -1;
                const unsigned peers = __match_any_sync(kFull, key);
                if (key >= 0 && lane == __ffs(peers) - 1) {
                    if (kShared) {
                        atomicAdd(&s_counts[q * n_bins + key], __popc(peers));
                    } else {
                        atomicAdd(&counts[counter(key, q, tiles)], __popc(peers));
                    }
                }
            }
        }
    }
    over = __syncthreads_or(over);
    if (kShared) {
        for (int i = threadIdx.x; i < 4 * n_bins; i += kPrepThreads) {
            counts[counter(i % n_bins, i / n_bins, tiles)] = s_counts[i];
        }
    }
    if (threadIdx.x < 4) counts[counter(n_bins, threadIdx.x, tiles)] = threadIdx.x == 0 && over;
    // pass 2's scan state, past the counters: the tickets and each row's word
    unsigned long long* state =
        reinterpret_cast<unsigned long long*>(counts + static_cast<long long>(n_bins + 1) * tiles);
    if (threadIdx.x == 0) {
        for (int r = blockIdx.x; r < n_bins + 2; r += gridDim.x) state[r] = 0ull;
    }
}

// Instance g's row into the (cap / (2 chunk), 8, chunk) slabs: chunk
// ci = g / chunk is rows 4 (ci % 2) .. +3 of slab ci / 2.
__device__ __forceinline__ void write_row(float* __restrict__ slabs, int g, int chunk,
                                          float4 v) {
    float* at = slabs + static_cast<long long>(g / chunk) * 4 * chunk + g % chunk;
    at[0] = v.x;
    at[chunk] = v.y;
    at[2 * chunk] = v.z;
    at[3 * chunk] = v.w;
}

// A row's published sum: (flag << 32) | the sum, in one 64-bit word, so a
// reader never sees a flag without its value.
constexpr unsigned long long kAggregate = 1ull << 32;   // the row's own sum
constexpr unsigned long long kInclusive = 2ull << 32;   // the sum of it and every row before

__device__ __forceinline__ unsigned long long load_state(const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void store_state(unsigned long long* p, unsigned long long v) {
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// The decoupled look-back of row t (warp 0 of its block; st the rows'
// words): publishes the row's sum `agg`, then reads its predecessors 32
// at a time (lane l row t - 1 - l, a row before 0 counting as an
// inclusive 0), waits while any of them has published nothing, adds the
// sums up to the nearest inclusive one and stops there, else moves 32
// back; publishes its own inclusive sum. Returns the sum of the rows
// before t. Rows are taken by ticket in order, so every row it waits for
// is held by a running block.
__device__ __forceinline__ unsigned look_back(unsigned long long* st, int t, unsigned agg,
                                              int lane) {
    if (t == 0) {
        if (lane == 0) store_state(st, kInclusive | agg);
        return 0u;
    }
    if (lane == 0) store_state(st + t, kAggregate | agg);
    unsigned base = 0;
    for (int k = t - 1;; k -= 32) {
        unsigned long long w;
        do {
            w = k - lane >= 0 ? load_state(st + k - lane) : kInclusive;
        } while (__any_sync(kFull, (w >> 32) == 0));
        const unsigned inclusive = __ballot_sync(kFull, (w >> 32) == 2);
        const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
        base += __reduce_add_sync(kFull, lane <= stop ? static_cast<unsigned>(w) : 0u);
        if (inclusive) break;
    }
    if (lane == 0) store_state(st + t, kInclusive | (base + agg));
    return base;
}

// A block barrier after the warp's lanes reconverge (lanes part before
// several of them: thread 0 takes the ticket, warp 0 looks back).
__device__ __forceinline__ void block_sync() {
    __syncwarp();
    __syncthreads();
}

// The counters' exclusive scan in place, key-major, by the blocks of pass
// 2 together: a block takes a row (a bin's tiles counters; the flag row
// last) by ticket, sums its entries (each thread a run of them, then a
// warp scan and the warps' sums in shared memory), takes the rows before
// it by look_back and writes each entry's exclusive prefix; the row's
// range (first, last, slab_lo, n_slabs) where it is a key's, the overflow
// byte where it is the flag row's. Then every block waits until each row
// is written. state[0] holds the tickets and the rows done, state[1 + r]
// row r's word (pass 1 zeroed them).
__device__ __forceinline__ void scan_counters(int* counts, unsigned long long* state,
                                              int* ranges, unsigned char* overflow, int n_keys,
                                              int tiles, int chunk) {
    __shared__ int s_row;
    __shared__ unsigned s_base;
    __shared__ unsigned s_warp[kPrepWarps];
    unsigned* tickets = reinterpret_cast<unsigned*>(state);   // [0] taken, [1] rows done
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int rows = n_keys + 2, per = (tiles + kPrepThreads - 1) / kPrepThreads;
    for (;;) {
        if (threadIdx.x == 0) s_row = static_cast<int>(atomicAdd(tickets, 1u));
        block_sync();
        const int row = s_row;
        if (row >= rows) break;
        int* entries = counts + static_cast<long long>(row) * tiles;
        const int j0 = min(static_cast<int>(threadIdx.x) * per, tiles), j1 = min(j0 + per, tiles);
        unsigned mine = 0;
        for (int j = j0; j < j1; ++j) mine += static_cast<unsigned>(entries[j]);
        unsigned incl = mine;
#pragma unroll
        for (int d = 1; d < 32; d *= 2) {
            const unsigned x = __shfl_up_sync(kFull, incl, d);
            if (lane >= d) incl += x;
        }
        if (lane == 31) s_warp[warp] = incl;
        block_sync();
        unsigned agg = 0, below = 0;
#pragma unroll
        for (int v = 0; v < kPrepWarps; ++v) {
            agg += s_warp[v];
            below += v < warp ? s_warp[v] : 0u;
        }
        if (warp == 0) {
            const unsigned base = look_back(state + 1, row, agg, lane);
            if (lane == 0) s_base = base;
        }
        block_sync();
        unsigned run = s_base + below + incl - mine;
        for (int j = j0; j < j1; ++j) {
            const int v = entries[j];
            entries[j] = static_cast<int>(run);
            run += static_cast<unsigned>(v);
        }
        if (threadIdx.x == 0 && row < n_keys) {
            const int per_slab = 2 * chunk;
            const int f = static_cast<int>(s_base), l = static_cast<int>(s_base + agg);
            const int lo = f / per_slab;
            const int count = (l + per_slab - 1) / per_slab - lo;
            ranges[row] = f;
            ranges[n_keys + row] = l;
            ranges[2 * n_keys + row] = lo;
            ranges[3 * n_keys + row] = count > 0 ? count : 0;
        }
        if (threadIdx.x == 0 && row == n_keys + 1) *overflow = agg != 0;
        __threadfence();
        block_sync();   // the row written, and s_row read, before the next ticket
        if (threadIdx.x == 0) atomicAdd(tickets + 1, 1u);
    }
    if (threadIdx.x == 0) {
        unsigned done;
        do {
            asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(done) : "l"(tickets + 1)
                         : "memory");
        } while (done < static_cast<unsigned>(rows));
        __threadfence();
    }
    block_sync();
}

template <bool kShared>
__global__ void __launch_bounds__(kPrepThreads)
    bucket_pack_kernel(const float4* __restrict__ spheres, const float* __restrict__ weights,
                       const float* __restrict__ consts, int* counts, float* __restrict__ slabs,
                       int* __restrict__ ranges, unsigned char* __restrict__ overflow, int n,
                       int cap, int chunk, int tile, int nbx, int nty, int n_keys) {
    // where kShared: the block's warp counts [4][n_bins] (u64: a byte a
    // warp) and cursors [4][n_bins] (i32); else the warp counts in the
    // block's part of the scratch past the scan state, and the cursors in
    // the block's own column of the scanned counters
    extern __shared__ unsigned long long s_prep[];
    const int n_bins = n_keys + 1, tiles = 4 * gridDim.x;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const unsigned below = (1u << lane) - 1u;
    const unsigned long long lower_warps = (1ull << (8 * warp)) - 1ull;
    unsigned long long* state =
        reinterpret_cast<unsigned long long*>(counts + static_cast<long long>(n_bins + 1) * tiles);
    unsigned long long* words =
        kShared ? s_prep : state + n_bins + 2 + static_cast<long long>(blockIdx.x) * 4 * n_bins;
    int* s_cursor = reinterpret_cast<int*>(s_prep + 4 * n_bins);
    const Tile t(n, tile);
    // the grid's zero columns past 4 n, then the counters' scan
    const int gt = blockIdx.x * kPrepThreads + threadIdx.x, stride = gridDim.x * kPrepThreads;
    for (int g = 4 * n + gt; g < cap; g += stride) {
        write_row(slabs, g, chunk, make_float4(0.0f, 0.0f, 0.0f, 0.0f));
    }
    scan_counters(counts, state, ranges, overflow, n_keys, tiles, chunk);
    for (int i = threadIdx.x; i < 4 * n_bins; i += kPrepThreads) {
        if (kShared) s_cursor[i] = __ldcg(&counts[counter(i % n_bins, i / n_bins, tiles)]);
        words[i] = 0ull;
    }
    __syncthreads();
    for (int base = t.p0; base < t.p1; base += kLoads * kPrepThreads) {
        float4 s[kLoads];
        float w[kLoads];
        load_particles(spheres, weights, base, t.p1, s, w);
#pragma unroll
        for (int k = 0; k < kLoads; ++k) {
            const bool valid = base + k * kPrepThreads + static_cast<int>(threadIdx.x) < t.p1;
            const Particle a = particle_keys(s[k], w[k], weights != nullptr, consts, nbx, nty,
                                             n_keys);
            int key[4], rank[4], size[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                key[q] = valid ? a.key[q] : -1;
                const unsigned peers = __match_any_sync(kFull, key[q]);
                rank[q] = __popc(peers & below);
                size[q] = __popc(peers);
                if (key[q] >= 0 && rank[q] == 0) {
                    reinterpret_cast<unsigned char*>(words + q * n_bins + key[q])[warp] =
                        static_cast<unsigned char>(size[q]);
                }
            }
            block_sync();
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                if (key[q] < 0) continue;
                const long long at = q * n_bins + key[q];
                // the key's groups in the round's lower warps: the bytes
                // below this warp's, summed (at most 7 x 32 < 256)
                const unsigned long long word = kShared ? words[at] : __ldcg(words + at);
                const int offset =
                    static_cast<int>(((word & lower_warps) * 0x0101010101010101ull) >> 56);
                const int cursor = kShared ? s_cursor[at] : __ldcg(&counts[counter(key[q], q,
                                                                                  tiles)]);
                write_row(slabs, cursor + offset + rank[q], chunk, a.row);
            }
            block_sync();
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                if (key[q] < 0 || rank[q] != 0) continue;
                const long long at = q * n_bins + key[q];
                reinterpret_cast<unsigned char*>(words + at)[warp] = 0;
                if (kShared) {
                    atomicAdd(&s_cursor[at], size[q]);
                } else {
                    atomicAdd(&counts[counter(key[q], q, tiles)], size[q]);
                }
            }
        }
    }
}

__device__ __forceinline__ float warp_min(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// Segment box (lo_u, hi_u, lo_v, hi_v) against tile (r, c): projected_overlap.
__device__ __forceinline__ bool overlaps(const float* box, const float* tx_lo,
                                         const float* tx_hi, const float* ty_lo,
                                         const float* ty_hi, int r, int c) {
    return box[0] <= tx_hi[c] && box[1] >= tx_lo[c] && box[2] <= ty_hi[r] &&
           box[3] >= ty_lo[r];
}

__global__ void __launch_bounds__(kSetupWarps * 32)
    sortfree_setup_kernel(const float4* __restrict__ spheres, const float* __restrict__ weights,
                          const float* __restrict__ consts, const float* __restrict__ spans,
                          float4* __restrict__ slabs, int* __restrict__ masks,
                          int* __restrict__ masks_t, int n, int n_segs, int ntx, int nty) {
    __shared__ float boxes[kSegsPerBlock][4];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int word = blockIdx.x;
    const int seg0 = word * kSegsPerBlock;
    const int seg = seg0 + warp;
    float lo_u = kBig, hi_u = -kBig, lo_v = kBig, hi_v = -kBig;
    if (seg < n_segs) {
        const int p0 = seg * kSeg + kLanePrims * lane;
        float4 s[kLanePrims];
        float w[kLanePrims];
        for (int k = 0; k < kLanePrims; ++k) {
            s[k] = p0 + k < n ? spheres[p0 + k] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        for (int k = 0; k < kLanePrims; ++k) {
            w[k] = weights && p0 + k < n ? weights[p0 + k] : 1.0f;
        }
        float pu[kLanePrims], pv[kLanePrims], inv_h[kLanePrims], scale[kLanePrims];
        for (int k = 0; k < kLanePrims; ++k) {
            pu[k] = pv[k] = inv_h[k] = scale[k] = 0.0f;
            if (p0 + k < n) {
                const float h = s[k].w;
                pu[k] = dot3(s[k].x, s[k].y, s[k].z, consts + kV);
                pv[k] = dot3(s[k].x, s[k].y, s[k].z, consts + kU);
                const float depth = dot3(s[k].x - consts[kCam], s[k].y - consts[kCam + 1],
                                         s[k].z - consts[kCam + 2], consts + kViewDir);
                inv_h[k] = h > 0.0f ? 1.0f / h : 0.0f;
                const bool live = h > 0.0f && depth >= 0.0f && depth < consts[kLength];
                scale[k] = live ? (w[k] * inv_h[k]) * inv_h[k] : 0.0f;
                if (scale[k] > 0.0f) {
                    const float h_eff = 1.0f / fmaxf(inv_h[k], kTiny);
                    lo_u = fminf(lo_u, pu[k] - h_eff);
                    hi_u = fmaxf(hi_u, pu[k] + h_eff);
                    lo_v = fminf(lo_v, pv[k] - h_eff);
                    hi_v = fmaxf(hi_v, pv[k] + h_eff);
                }
            }
        }
        // slab row r of the segment is float4s 32 r .. 32 r + 31
        float4* slab = slabs + static_cast<long long>(seg) * 8 * (kSeg / 4) + lane;
        const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        slab[0] = make_float4(pu[0], pu[1], pu[2], pu[3]);
        slab[32] = make_float4(pv[0], pv[1], pv[2], pv[3]);
        slab[64] = make_float4(inv_h[0], inv_h[1], inv_h[2], inv_h[3]);
        slab[96] = make_float4(scale[0], scale[1], scale[2], scale[3]);
        for (int r = 4; r < 8; ++r) slab[32 * r] = zero;
        lo_u = warp_min(lo_u);
        hi_u = warp_max(hi_u);
        lo_v = warp_min(lo_v);
        hi_v = warp_max(hi_v);
    }
    if (lane == 0) {
        boxes[warp][0] = lo_u;
        boxes[warp][1] = hi_u;
        boxes[warp][2] = lo_v;
        boxes[warp][3] = hi_v;
    }
    __syncthreads();
    const float* tx_lo = spans;
    const float* tx_hi = spans + ntx;
    const float* ty_lo = spans + 2 * ntx;
    const float* ty_hi = spans + 2 * ntx + nty;
    const int n_tiles = ntx * nty;
    const int words = (n_segs + kSegsPerBlock - 1) / kSegsPerBlock;
    const int words_t = (n_tiles + 31) / 32;
    // masks: tile t's word of this block's 32 segments, lane = segment
    const bool mine = seg0 + lane < n_segs;
    for (int t = warp; t < n_tiles; t += kSetupWarps) {
        const bool bit = mine && overlaps(boxes[lane], tx_lo, tx_hi, ty_lo, ty_hi, t / ntx,
                                          t % ntx);
        const unsigned bits = __ballot_sync(0xffffffffu, bit);
        if (lane == 0) masks[static_cast<long long>(t) * words + word] = static_cast<int>(bits);
    }
    // transposed masks: this warp's segment's word q of tiles 32 q + lane
    if (seg >= n_segs) return;
    for (int q = 0; q < words_t; ++q) {
        const int t = 32 * q + lane;
        const bool bit =
            t < n_tiles && overlaps(boxes[warp], tx_lo, tx_hi, ty_lo, ty_hi, t / ntx, t % ntx);
        const unsigned bits = __ballot_sync(0xffffffffu, bit);
        if (lane == 0) masks_t[static_cast<long long>(seg) * words_t + q] = static_cast<int>(bits);
    }
}

}  // namespace

namespace {

// Blocks of E4's passes over n particles in tiles of `tile` (one for no
// particle), or 0 where the counters, 4 (n_keys + 2) a block, or the
// counts' scan would pass an i32.
int prep_blocks(int n, int tile, int n_keys) {
    const long long blocks = n > tile ? (static_cast<long long>(n) + tile - 1) / tile : 1;
    const long long counters = 4LL * (static_cast<long long>(n_keys) + 2) * blocks;
    return counters + 4LL * n < (1LL << 31) ? static_cast<int>(blocks) : 0;
}

bool prep_valid(int n, int tile, int nbx, int nty, int n_keys) {
    return n >= 0 && tile >= 1 && nbx >= 1 && nty >= 1 &&
           static_cast<long long>(nbx) * nty == n_keys && prep_blocks(n, tile, n_keys) > 0;
}

// Dynamic shared bytes of a block of pass 1 (`per_bin` 16: 4 counters a
// bin) or pass 2 (48: 4 cursors and 4 words of warp counts a bin) where
// n_bins fit (kSharedBins), else none (they stay in device memory).
int prep_shared(int n_bins, int per_bin) { return n_bins <= kSharedBins ? per_bin * n_bins : 0; }

}  // namespace

// Pass 1 over n spheres f32[n, 4] (16-byte aligned), weights f32[n] or
// null, consts f32[17]: counts i32[(n_keys + 2) x 4 blocks], key-major,
// block b's (bin, q) counter at bin * 4 blocks + q * blocks + b (bin
// n_keys the sentinel, bin n_keys + 1 the blocks' overflow flags), blocks
// = ceil(n / tile) (at least 1); then pass 2's scan state, 2 (n_keys + 3)
// i32 (8-byte aligned), zeroed.
extern "C" int grace_splat_bucket_keys(const float* spheres, const float* weights,
                                       const float* consts, int* counts, int n, int tile,
                                       int nbx, int nty, int n_keys, int device, void* stream) {
    if (!prep_valid(n, tile, nbx, nty, n_keys) || !consts || !counts || (n > 0 && !spheres) ||
        reinterpret_cast<uintptr_t>(spheres) % 16 || reinterpret_cast<uintptr_t>(counts) % 8) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const auto s = static_cast<cudaStream_t>(stream);
    const int blocks = prep_blocks(n, tile, n_keys), shared = prep_shared(n_keys + 1, 16);
    const auto* sp = reinterpret_cast<const float4*>(spheres);
    if (shared > 0) {
        bucket_keys_kernel<true><<<blocks, kPrepThreads, shared, s>>>(sp, weights, consts, counts,
                                                                      n, tile, nbx, nty, n_keys);
    } else {
        bucket_keys_kernel<false><<<blocks, kPrepThreads, 0, s>>>(sp, weights, consts, counts, n,
                                                                  tile, nbx, nty, n_keys);
    }
    return static_cast<int>(cudaGetLastError());
}

// Pass 2: slabs f32[cap / (2 chunk), 8, chunk], ranges i32[4, n_keys]
// (first, last, slab_lo, n_slabs) and the overflow byte from the same
// spheres, weights, consts, tile and keys and grace_splat_bucket_keys'
// counts with its scan state, which it scans in place (scratch), followed
// past kSharedBins bins by 8 (n_keys + 1) i32 a block (its words of warp
// counts).
extern "C" int grace_splat_bucket_pack(const float* spheres, const float* weights,
                                       const float* consts, int* counts, float* slabs,
                                       int* ranges, unsigned char* overflow, int n, int cap,
                                       int chunk, int tile, int nbx, int nty, int n_keys,
                                       int device, void* stream) {
    if (!prep_valid(n, tile, nbx, nty, n_keys) || chunk < 1 || cap < 4LL * n ||
        cap % (2LL * chunk) || !consts || !counts || !ranges || !overflow ||
        (n > 0 && !spheres) || (cap > 0 && !slabs) || reinterpret_cast<uintptr_t>(spheres) % 16 ||
        reinterpret_cast<uintptr_t>(counts) % 8) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const auto s = static_cast<cudaStream_t>(stream);
    const int blocks = prep_blocks(n, tile, n_keys), shared = prep_shared(n_keys + 1, 48);
    const auto* sp = reinterpret_cast<const float4*>(spheres);
    if (shared > 0) {
        bucket_pack_kernel<true><<<blocks, kPrepThreads, shared, s>>>(
            sp, weights, consts, counts, slabs, ranges, overflow, n, cap, chunk, tile, nbx, nty,
            n_keys);
    } else {
        bucket_pack_kernel<false><<<blocks, kPrepThreads, 0, s>>>(
            sp, weights, consts, counts, slabs, ranges, overflow, n, cap, chunk, tile, nbx, nty,
            n_keys);
    }
    return static_cast<int>(cudaGetLastError());
}

namespace {

template <typename Kernel>
cudaError_t kernel_resources(Kernel kernel, int threads, int dynamic, int* out) {
    cudaFuncAttributes attr;
    int blocks = 0;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, dynamic);
    }
    if (err != cudaSuccess) return err;
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.sharedSizeBytes) + dynamic;
    out[2] = threads;
    out[3] = blocks;
    out[4] = blocks * threads / 32;
    out[5] = static_cast<int>(attr.localSizeBytes);
    return cudaSuccess;
}

}  // namespace

// What a launch of each of E4's passes holds at n_bins bins (out i32[12]:
// pass 1, then pass 2, each registers a thread, shared bytes a block
// (static and dynamic), threads a block, resident blocks and warps an SM,
// local bytes a thread).
extern "C" int grace_splat_bucket_resources(int* out, int n_bins, int device, void* stream) {
    (void)stream;
    if (!out || n_bins < 2) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_bins <= kSharedBins) {
        err = kernel_resources(bucket_keys_kernel<true>, kPrepThreads, prep_shared(n_bins, 16),
                               out);
        if (err == cudaSuccess) {
            err = kernel_resources(bucket_pack_kernel<true>, kPrepThreads,
                                   prep_shared(n_bins, 48), out + 6);
        }
    } else {
        err = kernel_resources(bucket_keys_kernel<false>, kPrepThreads, 0, out);
        if (err == cudaSuccess) {
            err = kernel_resources(bucket_pack_kernel<false>, kPrepThreads, 0, out + 6);
        }
    }
    return static_cast<int>(err);
}

// The sort-free setup of n spheres f32[n, 4] (16-byte aligned), weights
// f32[n] or null, consts f32[13] and spans f32[2 ntx + 2 nty] (tx_lo,
// tx_hi, ty_lo, ty_hi): slabs f32[n_segs, 8, 128], masks i32[ntx nty,
// ceil(n_segs / 32)] and masks_t i32[n_segs, ceil(ntx nty / 32)].
extern "C" int grace_sortfree_setup(const float* spheres, const float* weights,
                                    const float* consts, const float* spans, float* slabs,
                                    int* masks, int* masks_t, int n, int ntx, int nty,
                                    int device, void* stream) {
    const int n_segs = (n + kSeg - 1) / kSeg;
    if (n < 0 || ntx < 1 || nty < 1 || !consts || !spans ||
        (n > 0 && (!spheres || !slabs || !masks || !masks_t)) ||
        reinterpret_cast<uintptr_t>(spheres) % 16 || reinterpret_cast<uintptr_t>(slabs) % 16) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n == 0) return static_cast<int>(cudaGetLastError());
    const int blocks = (n_segs + kSegsPerBlock - 1) / kSegsPerBlock;
    sortfree_setup_kernel<<<blocks, kSetupWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(spheres), weights, consts, spans,
        reinterpret_cast<float4*>(slabs), masks, masks_t, n, n_segs, ntx, nty);
    return static_cast<int>(cudaGetLastError());
}

// What one launch of sortfree_setup_kernel holds (out i32[6]: registers a
// thread, shared bytes a block, threads a block, resident blocks and warps
// an SM, local bytes a thread).
extern "C" int grace_sortfree_setup_resources(int* out, int device, void* stream) {
    (void)stream;
    if (!out) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaFuncAttributes attr;
    int blocks = 0;
    err = cudaFuncGetAttributes(&attr, sortfree_setup_kernel);
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, sortfree_setup_kernel,
                                                            kSetupWarps * 32, 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.sharedSizeBytes);
    out[2] = kSetupWarps * 32;
    out[3] = blocks;
    out[4] = blocks * kSetupWarps;
    out[5] = static_cast<int>(attr.localSizeBytes);
    return 0;
}
