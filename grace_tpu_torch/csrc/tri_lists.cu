// The triangle trace's segment lists on the card (E7): per ray tile, the
// 128-triangle segments its rays may hit, front to back.
//
// Not a TPU kernel: grace_tpu builds these lists as plain XLA
// (grace_tpu/trace/pallas_tri.py:89, _dense_tile_segments_tri) in front of
// its Pallas triangle kernel. The port ran them as a [tiles, K, segments]
// bool tensor in blocks of tiles, an amin over the intervals and a stable
// torch.sort of every row of segments.
//
// What it computes, per tile of `tile` rays (the plain version's function,
// bit for bit):
//  1. The K + 1 endpoint hulls of the points fma(d, ln * frac[k], o) in
//     vecmath.fma's form (fma_f64: the exact f64 product plus o, rounded to
//     f64, then to f32) with ln = clamp(len, min=0) and frac = arange(K +
//     1) / K as torch computes it on the same device (passed in); the K
//     interval boxes (the union of hulls k and k + 1), the origins' box and
//     the shortest length. Every min, max and clamp takes torch's NaN rule
//     on the card (a NaN operand wins, else fminf / fmaxf).
//  2. A segment is listed when its box meets an interval box; kfirst is the
//     first such interval, and its key max(sqrt(g2) (in f64, as
//     vecmath.sqrt), frac[kfirst] * ln_min), g the box's gap from the
//     origins' box per axis, g2 = fma(gz, gz, fma(gx, gx, gy * gy)).
//  3. The order of torch.sort(key, stable=True) over the whole row, key =
//     BIG where not listed: the keys below BIG, then every segment keyed BIG
//     by ascending id, then the keys above BIG and the NaNs. Only the first
//     keep = min(max_chunks, segments) columns are written; past keep the
//     pads are 0 and BIG. n = min(listed, max_chunks), overflow = listed >
//     max_chunks.
//
// The design (tri_lists_kernel<kVec, kStaged>):
//  - Persistent blocks of 16 warps, two an SM (64 registers): each stages
//    the segment boxes in shared memory once, with 16-byte loads, as they
//    lie ([segment][axis], stride 3: a warp's 32 consecutive segments fall
//    on 32 banks), while n_segs <= stage_segs (past it, kStaged false, the
//    boxes are read from device memory), and each word's hull (32 boxes'
//    min and max, NaN bounds dropped).
//  - A warp a tile (a warp's first tile its index, the next ones by an
//    atomic ticket: tiles differ in what they list), no block barrier
//    inside a tile. The hulls: a lane a ray writes its endpoints
//    (and origins) as order-preserving ints into rows in shared memory, 7
//    groups of 3 rows at a time, and lane j folds row j's min and max over
//    the rays by integer min / max (nan_min / nan_max are exact in any
//    order); a lane a k makes the intervals, their union (NaN bounds
//    dropped) is one redux a bound.
//  - The union against each word's hull (lanes over words), then against
//    the boxes of the words whose hull it meets (lanes over segments): a
//    box that meets an interval meets both, so both culls are exact. The
//    near segments queue in word order and go 32 at a time, a lane each:
//    kfirst four intervals a step (16-byte loads of the intervals) until
//    every lane's is found, then the key.
//  - The segments whose key is not BIG go to the warp's buffer as (order
//    bits of key) << 32 | id, placed by ballot and popc; each word's
//    pushed bits by a segmented or over the batch's lanes (a word's lanes
//    are contiguous), its prefix by a warp scan. Ids are distinct, so every
//    network gives the one order the stable sort gives; NaN keys sort last
//    and -0 with +0, as in torch.sort.
//  - The sort in the warp: up to warp_buf entries (kWarpBuf, 256) a bitonic
//    network in registers, E = next_pow2(m) / 32 keys a lane, by shuffles
//    (csrc/segsort.cu's warp_bitonic on u64); a tile that pushes more spills
//    the entries past warp_buf to its warp's row of a device scratch, where
//    the same network runs over next_pow2(m) entries, in registers a chunk
//    of 256 wherever its comparators stay inside one (scratch_sort).
//  - The row written once, output-stationary: a lane owns aligned groups of
//    four columns (16-byte streaming stores of ids and of distances where
//    max_chunks is a multiple of 4; else a column a lane, 4-byte ones) and
//    works out
//    each column: a sorted entry below BIG, the r-th segment of the BIG
//    group (the r-th id whose bit is clear, from the words' prefix and, in
//    a word with pushed bits, the rank of a clear bit), a sorted entry
//    above BIG, or a pad. Four BIG-group columns in a word without pushed
//    bits are four consecutive ids, so a tile that lists none is one
//    aligned stream of 0..S-1 and BIG.
//
// What bounds it: writing max_chunks ids and distances a tile (134 MB for
// the torus's 8,192 tiles of 2,048 segments; 0.042 ms on an H100); the rays
// and the boxes are read once (the boxes once a block, from L2). On the
// torus the kernel takes 2.7x that on the primary rays and 1.9x on the
// shadow rays: the hulls, the listing and the rows each take a share, and
// the warps' stores overlap their computing only in part (PERF.md, E7).

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 16;            // warps a block, fewer where a warp's area is large
constexpr int kMinBlocks = 2;         // blocks an SM the registers are sized for
constexpr int kMaxIntervals = 64;     // pallas_tri.MAX_INTERVALS
constexpr int kStageSegs = 4096;      // pallas_tri.STAGE_SEGS: the most boxes staged a block
constexpr int kWarpBuf = 256;         // pallas_tri.WARP_BUF: the most a warp sorts in registers
constexpr int kMaxDevices = 16;
constexpr int kHullGroups = 7;        // hull groups (3 rows each) a pass
constexpr int kHullRow = 34;          // ints a hull row (32 rays and a pad, even)
constexpr float kBig = 1e30f;         // pallas_tri.BIG
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kPad = ~0ull;

struct ListArgs {
    const float* seg_min;
    const float* seg_max;
    const float* origins;
    const float* dirs;
    const float* lengths;
    const float* frac;
    int* seg_ids;
    float* seg_dist;
    int* n_out;
    unsigned char* overflow;
    unsigned long long* scratch;   // a row of cap entries a warp (g < n_warps), or null
    unsigned long long* tickets;   // the tiles' ticket counter, zeroed before the launch
    long long n_tiles;
    int tile, n_segs, K, max_chunks, warp_buf, cap;
    long long n_warps;             // warps that take tiles (the rest of the grid idles)
    int warp_bytes;                // a warp's shared area
    int stage_floats;              // floats of each staged box array (3 n_segs, padded to 4)
    int block_bytes;               // the staged boxes and the word hulls, before the warps' areas
};

__device__ __forceinline__ float nan_min(float a, float b) {
    return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

__device__ __forceinline__ float nan_max(float a, float b) {
    return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// torch.clamp(v, min=0) on the card
__device__ __forceinline__ float clamp0(float v) { return isnan(v) ? v : fmaxf(v, 0.0f); }

__device__ __forceinline__ float fma_f64(float a, float b, float c) {
    return __double2float_rn(static_cast<double>(a) * static_cast<double>(b) +
                             static_cast<double>(c));
}

// Bytes of a warp's list region (its sort buffer, pushed words, prefixes
// and queue), which the hulls' rows (kHullGroups x 3 rows of kHullRow
// ints) use before it; the intervals and the hulls' table follow it.
__host__ __device__ constexpr int lists_bytes(int warp_buf, int n_words) {
    const int lists = 8 * warp_buf + 8 * n_words + 4 * 64;
    const int rows = 4 * kHullRow * 3 * kHullGroups;
    return ((lists > rows ? lists : rows) + 15) / 16 * 16;
}

// A float's order-preserving int (-0 below +0) and back.
__device__ __forceinline__ int order_int(float v) {
    const int b = __float_as_int(v);
    return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float from_order_int(int k) {
    return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// The warp's nan_min of its lanes' values in one redux.sync: a NaN maps
// to the reduction's extreme and comes back as a NaN; else the value's
// bits (fminf gives -0 of -0 and +0).
__device__ __forceinline__ float warp_min(float v) {
    return from_order_int(__reduce_min_sync(kFull, isnan(v) ? INT_MIN : order_int(v)));
}

// A key's sort bits: keys are +-0, positive or NaN; -0 sorts with +0 and
// NaN last, as in torch.sort.
__device__ __forceinline__ unsigned order_bits(float key) {
    if (isnan(key)) return kFull;
    return key == 0.0f ? 0u : __float_as_uint(key);
}

__device__ __forceinline__ float key_of(unsigned bits) {
    return bits == kFull ? __int_as_float(0x7fffffff) : __uint_as_float(bits);
}

// The bitonic network over the warp's 32 E distinct u64 values, element
// i = lane E + e in v[e], every comparator ascending (csrc/segsort.cu's
// warp_bitonic): merge phase K first compares i with its mirror i ^ (K -
// 1), then i with i ^ J for J = K / 4, ..., 1.
__device__ __forceinline__ void order_pair(unsigned long long& a, unsigned long long& b) {
    const bool swap = b < a;
    const unsigned long long x = a;
    a = swap ? b : a;
    b = swap ? x : b;
}

__device__ __forceinline__ unsigned long long keep_side(unsigned long long v,
                                                        unsigned long long w, bool low) {
    return (w < v) == low ? w : v;
}

template <int E, int J>
__device__ __forceinline__ void half_clean(unsigned long long (&v)[E], int lane) {
    if constexpr (J >= E) {
        const bool low = (lane & (J / E)) == 0;
#pragma unroll
        for (int e = 0; e < E; ++e) {
            v[e] = keep_side(v[e], __shfl_xor_sync(kFull, v[e], J / E), low);
        }
    } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
            if ((e & J) == 0) order_pair(v[e], v[e | J]);
        }
    }
    if constexpr (J > 1) half_clean<E, J / 2>(v, lane);
}

template <int E, int K = 2>
__device__ __forceinline__ void warp_bitonic(unsigned long long (&v)[E], int lane) {
    if constexpr (K <= E) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
            if ((e & (K / 2)) == 0) order_pair(v[e], v[e ^ (K - 1)]);
        }
    } else {
        const bool low = (lane & (K / E / 2)) == 0;
#pragma unroll
        for (int e = 0; e < (E + 1) / 2; ++e) {
            const unsigned long long a = __shfl_xor_sync(kFull, v[E - 1 - e], K / E - 1);
            const unsigned long long b = __shfl_xor_sync(kFull, v[e], K / E - 1);
            v[e] = keep_side(v[e], a, low);
            if (E - 1 - e != e) v[E - 1 - e] = keep_side(v[E - 1 - e], b, low);
        }
    }
    if constexpr (K >= 4) half_clean<E, K / 4>(v, lane);
    if constexpr (K < 32 * E) warp_bitonic<E, K * 2>(v, lane);
}

// buf[0, m) (m <= 32 E) sorted in place through the registers.
template <int E>
__device__ __forceinline__ void register_sort(unsigned long long* buf, int m, int lane) {
    unsigned long long v[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const int i = lane * E + e;
        v[e] = i < m ? buf[i] : kPad;
    }
    warp_bitonic<E>(v, lane);
    __syncwarp();
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const int i = lane * E + e;
        if (i < m) buf[i] = v[e];
    }
}

// row[0, w) (w a power of 2, past 256; pads ~0 past the entries) sorted
// in place by the same network, a chunk of 256 through the registers
// wherever its comparators stay inside one: phases up to 256 sort each
// chunk (ascending where bit 8 of its start is clear, else descending, as
// the network leaves it: a descending chunk is sorted ascending on the
// complemented values); each later phase k runs its steps j >= 256 in
// device memory (lanes over the pairs) and its steps j < 256 in each chunk,
// in the direction bit k of the chunk's start gives.
constexpr int kChunk = 256;

__device__ __forceinline__ void chunk_load(const unsigned long long* src, unsigned long long flip,
                                           unsigned long long (&v)[8], int lane) {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = src[lane * 8 + e] ^ flip;
}

__device__ __forceinline__ void chunk_store(unsigned long long* dst, unsigned long long flip,
                                            const unsigned long long (&v)[8], int lane) {
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[lane * 8 + e] = v[e] ^ flip;
}

__device__ void scratch_sort(unsigned long long* row, int w, int lane) {
    unsigned long long v[8];
    for (int c = 0; c < w; c += kChunk) {
        const unsigned long long flip = (c & kChunk) ? ~0ull : 0ull;
        chunk_load(row + c, flip, v, lane);
        warp_bitonic<8>(v, lane);
        chunk_store(row + c, flip, v, lane);
    }
    __syncwarp();
    for (int k = 2 * kChunk; k <= w; k <<= 1) {
        for (int j = k >> 1; j >= kChunk; j >>= 1) {
            for (int q = lane; q < w / 2; q += 32) {
                const int i = (q / j) * 2 * j + q % j, p = i + j;
                const unsigned long long x = row[i], y = row[p];
                if ((x > y) == ((i & k) == 0)) {
                    row[i] = y;
                    row[p] = x;
                }
            }
            __syncwarp();
        }
        for (int c = 0; c < w; c += kChunk) {
            const unsigned long long flip = (c & k) ? ~0ull : 0ull;
            chunk_load(row + c, flip, v, lane);
            half_clean<8, kChunk / 2>(v, lane);
            chunk_store(row + c, flip, v, lane);
        }
        __syncwarp();
    }
}

// The segments of a tile's row: the sorted entries (m of them, lt below
// BIG), the BIG group (big = n_segs - m ids whose pushed bit is clear, in
// ascending order) and the pads past keep.
struct Row {
    const unsigned long long* sorted;
    const unsigned* mask;   // pushed bits, a word a 32 segments
    const int* pre;         // pushed entries before each word
    int lt, big, keep, n_words;
};

// The word w that holds the r-th id of the BIG group, and the rank n of
// that id among the word's clear bits. w is the lane's word cursor: a
// lane's columns grow, so it only moves forward; word w holds it where the
// clear bits before word w + 1 pass r.
__device__ __forceinline__ int big_word(const Row& row, int r, int& w) {
    w = max(w, r >> 5);
    while (w + 1 < row.n_words && 32 * (w + 1) - row.pre[w + 1] <= r) ++w;
    return r - (32 * w - row.pre[w]);
}

// The r-th id of the BIG group: in a word without pushed bits directly,
// else the n-th clear bit.
__device__ __forceinline__ int big_id(const Row& row, int r, int& w) {
    int n = big_word(row, r, w);
    const unsigned pushed = row.mask[w];
    if (pushed == 0u) return 32 * w + n;
    unsigned clear = ~pushed;
    for (; n > 0; --n) clear &= clear - 1u;
    return 32 * w + __ffs(clear) - 1;
}

// Whether ranks r..r + 3 of the BIG group lie in one word without pushed
// bits; then id: the first one's id.
__device__ __forceinline__ bool clear_run(const Row& row, int r, int& w, int& id) {
    const int n = big_word(row, r, w);
    id = 32 * w + n;
    return row.mask[w] == 0u && n + 3 < 32;
}

__device__ __forceinline__ void column(const Row& row, int c, int& w, int& id, float& dist) {
    if (c >= row.keep) {
        id = 0;
        dist = kBig;
    } else if (c >= row.lt && c - row.lt < row.big) {
        id = big_id(row, c - row.lt, w);
        dist = kBig;
    } else {
        const unsigned long long e = row.sorted[c < row.lt ? c : c - row.big];
        id = static_cast<int>(e & 0xffffffffu);
        dist = key_of(static_cast<unsigned>(e >> 32));
    }
}

// One tile's list by one warp. area: the warp's shared area (buffer,
// pushed words, prefixes, queue, intervals); bmin / bmax: the boxes (staged
// or in device memory); hulls: the words' hulls; srow: the warp's scratch
// row.
template <int kVec>
__device__ __forceinline__ void list_tile(const ListArgs& a, long long t, const float* bmin,
                                          const float* bmax, const float* hulls,
                                          unsigned char* area, unsigned long long* srow,
                                          int lane) {
    const int S = a.n_segs, K = a.K;
    const int n_words = (S + 31) / 32;
    unsigned long long* buf = reinterpret_cast<unsigned long long*>(area);
    unsigned* mask = reinterpret_cast<unsigned*>(buf + a.warp_buf);
    int* pre = reinterpret_cast<int*>(mask + n_words);
    int* queue = pre + n_words;                             // 64 segment ids
    // the intervals, [K][imin xyz, pad, imax xyz, pad] (two 16-byte loads
    // each), and the hulls' table [K + 2][xyz][min, max]
    float* iv = reinterpret_cast<float*>(area + lists_bytes(a.warp_buf, n_words));
    const float4* iv4 = reinterpret_cast<const float4*>(iv);
    float* hb = iv + 8 * K;

    // 1. the hulls. The rows: group k <= K the endpoints fma(d, ln frac[k],
    // o) per axis, group K + 1 the origins; a lane a ray writes 7 groups'
    // rows at a time as order-preserving ints, a NaN as INT_MAX (rows of 34:
    // the writes, a lane a column, and the reads, a lane a row two columns
    // at a time, fall on 32 banks), then lane j folds row j by integer min
    // and max: where the max is INT_MAX the row holds a NaN, and nan_min /
    // nan_max give NaN for both; else they are the min and max (exact in
    // any order; -0 below +0, as fminf / fmaxf). A tile of more than 32 rays
    // goes 32 rays at a time.
    int* hs = reinterpret_cast<int*>(area);
    const long long r0 = t * a.tile;
    for (int g0 = 0; g0 < K + 2; g0 += kHullGroups) {
        const int g1 = min(g0 + kHullGroups, K + 2);
        int lo[2] = {INT_MAX, INT_MAX}, hi[2] = {INT_MIN, INT_MIN};
        for (int i0 = 0; i0 < a.tile; i0 += 32) {
            const int i = i0 + lane;
            if (i < a.tile) {
                const long long r = r0 + i;
                float o[3], d[3];
#pragma unroll
                for (int x = 0; x < 3; ++x) {
                    o[x] = a.origins[3 * r + x];
                    d[x] = a.dirs[3 * r + x];
                }
                const float ln = clamp0(a.lengths[r]);
                for (int g = g0; g < g1; ++g) {
                    const float tk = g <= K ? ln * a.frac[g] : 0.0f;
#pragma unroll
                    for (int x = 0; x < 3; ++x) {
                        const float v = g <= K ? fma_f64(d[x], tk, o[x]) : o[x];
                        hs[(3 * (g - g0) + x) * kHullRow + lane] =
                            isnan(v) ? INT_MAX : order_int(v);
                    }
                }
            }
            __syncwarp();
            if (lane < 3 * (g1 - g0)) {   // two folds side by side
                const int n = min(32, a.tile - i0);
                const int* row = hs + lane * kHullRow;
                int c = 0;
                for (; c + 1 < n; c += 2) {
                    const int2 v = *reinterpret_cast<const int2*>(row + c);
                    lo[0] = min(lo[0], v.x);
                    hi[0] = max(hi[0], v.x);
                    lo[1] = min(lo[1], v.y);
                    hi[1] = max(hi[1], v.y);
                }
                if (c < n) {
                    lo[0] = min(lo[0], row[c]);
                    hi[0] = max(hi[0], row[c]);
                }
            }
            __syncwarp();
        }
        if (lane < 3 * (g1 - g0)) {
            const int l = min(lo[0], lo[1]), h = max(hi[0], hi[1]);
            const float nan = __int_as_float(0x7fffffff);
            hb[2 * (3 * g0 + lane)] = h == INT_MAX ? nan : from_order_int(l);
            hb[2 * (3 * g0 + lane) + 1] = h == INT_MAX ? nan : from_order_int(h);
        }
    }
    __syncwarp();
    // the intervals (hulls k and k + 1), a lane a k; their union without
    // NaN bounds in every lane (a NaN is the reduction's identity)
    float u_lo[3], u_hi[3];
#pragma unroll
    for (int x = 0; x < 3; ++x) {
        int kl = INT_MAX, kh = INT_MIN;
        for (int k = lane; k < K; k += 32) {
            const float il = nan_min(hb[2 * (3 * k + x)], hb[2 * (3 * k + 3 + x)]);
            const float ih = nan_max(hb[2 * (3 * k + x) + 1], hb[2 * (3 * k + 3 + x) + 1]);
            iv[8 * k + x] = il;
            iv[8 * k + 4 + x] = ih;
            if (!isnan(il)) kl = min(kl, order_int(il));
            if (!isnan(ih)) kh = max(kh, order_int(ih));
        }
        kl = __reduce_min_sync(kFull, kl);
        kh = __reduce_max_sync(kFull, kh);
        u_lo[x] = kl == INT_MAX ? INFINITY : from_order_int(kl);
        u_hi[x] = kh == INT_MIN ? -INFINITY : from_order_int(kh);
    }
    float omin[3], omax[3];
#pragma unroll
    for (int x = 0; x < 3; ++x) {
        omin[x] = hb[2 * (3 * (K + 1) + x)];
        omax[x] = hb[2 * (3 * (K + 1) + x) + 1];
    }
    float ln_min = INFINITY;
    for (int i = lane; i < a.tile; i += 32) ln_min = nan_min(ln_min, clamp0(a.lengths[r0 + i]));
    ln_min = warp_min(ln_min);
    __syncwarp();

    // 2. the segments. The union against each word's hull (lanes over
    // words), then against each box of a word whose hull it meets (lanes
    // over its 32 segments); the segments near it queue in word order and
    // go 32 at a time, a lane each: kfirst and the key, appends by ballot
    // and popc, each word's pushed bits by a segmented or (a batch's lanes
    // of one word are contiguous)
    int m = 0, n_listed = 0, n_lt = 0, nq = 0;
    const unsigned below_me = (1u << lane) - 1u;
    auto batch = [&](int s) {
        bool listed = false, push = false, below = false;
        float key = 0.0f;
        float lo[3], hi[3];   // an idle lane's NaNs meet no interval
#pragma unroll
        for (int x = 0; x < 3; ++x) {
            lo[x] = s >= 0 ? bmin[3 * s + x] : __int_as_float(0x7fffffff);
            hi[x] = s >= 0 ? bmax[3 * s + x] : __int_as_float(0x7fffffff);
        }
        // kfirst: four intervals a step, without branches, until every
        // lane's is found
        int kfirst = K;
        for (int k0 = 0; k0 < K; k0 += 4) {
#pragma unroll
            for (int q = 3; q >= 0; --q) {
                const int k = k0 + q;
                if (k < K) {
                    const float4 l = iv4[2 * k], h = iv4[2 * k + 1];
                    if (l.x <= hi[0] && lo[0] <= h.x && l.y <= hi[1] && lo[1] <= h.y &&
                        l.z <= hi[2] && lo[2] <= h.z) {
                        kfirst = min(kfirst, k);
                    }
                }
            }
            if (__all_sync(kFull, kfirst < K || s < 0)) break;
        }
        if (kfirst < K) {
            listed = true;
            float g[3];
#pragma unroll
            for (int x = 0; x < 3; ++x) {
                g[x] = clamp0(nan_max(lo[x] - omax[x], omin[x] - hi[x]));
            }
            const float g2 = fma_f64(g[2], g[2], fma_f64(g[0], g[0], g[1] * g[1]));
            const float root = __double2float_rn(sqrt(static_cast<double>(g2)));
            key = nan_max(root, a.frac[kfirst] * ln_min);
            push = key != kBig;
            below = key < kBig;
        }
        const unsigned pushed = __ballot_sync(kFull, push);
        n_listed += __popc(__ballot_sync(kFull, listed));
        n_lt += __popc(__ballot_sync(kFull, below));
        if (push) {
            const int p = m + __popc(pushed & below_me);
            const unsigned long long e =
                static_cast<unsigned long long>(order_bits(key)) << 32 | static_cast<unsigned>(s);
            if (p < a.warp_buf) {
                buf[p] = e;
            } else {
                srow[p] = e;
            }
        }
        m += __popc(pushed);
        const int word = s >= 0 ? s >> 5 : -1 - lane;
        unsigned bits = push ? 1u << (s & 31) : 0u;
        for (int o = 1; o < 32; o <<= 1) {
            const unsigned v = __shfl_down_sync(kFull, bits, o);
            const int vw = __shfl_down_sync(kFull, word, o);
            if (lane + o < 32 && vw == word) bits |= v;
        }
        const int up = __shfl_up_sync(kFull, word, 1);
        if (s >= 0 && (lane == 0 || up != word) && bits) mask[word] |= bits;
        __syncwarp();
    };
    for (int w0 = 0; w0 < n_words; w0 += 32) {
        const int w = w0 + lane;
        bool cand = false;
        if (w < n_words) {
            cand = u_lo[0] <= hulls[3 * n_words + w] && hulls[w] <= u_hi[0] &&
                   u_lo[1] <= hulls[4 * n_words + w] && hulls[n_words + w] <= u_hi[1] &&
                   u_lo[2] <= hulls[5 * n_words + w] && hulls[2 * n_words + w] <= u_hi[2];
            mask[w] = 0u;
        }
        unsigned c = __ballot_sync(kFull, cand);
        __syncwarp();
        while (c) {
            const int j = w0 + __ffs(c) - 1;
            c &= c - 1u;
            const int s = 32 * j + lane;
            const bool near = s < S && u_lo[0] <= bmax[3 * s] && bmin[3 * s] <= u_hi[0] &&
                              u_lo[1] <= bmax[3 * s + 1] && bmin[3 * s + 1] <= u_hi[1] &&
                              u_lo[2] <= bmax[3 * s + 2] && bmin[3 * s + 2] <= u_hi[2];
            const unsigned word = __ballot_sync(kFull, near);
            if (near) queue[nq + __popc(word & below_me)] = s;
            nq += __popc(word);
            if (nq >= 32) {
                __syncwarp();
                const int mine = queue[lane];
                __syncwarp();
                if (lane < nq - 32) queue[lane] = queue[32 + lane];
                nq -= 32;
                batch(mine);
            }
        }
    }
    if (nq > 0) {
        __syncwarp();
        batch(lane < nq ? queue[lane] : -1);
    }
    // each word's prefix: the pushed entries before it
    for (int w0 = 0, run = 0; w0 < n_words; w0 += 32) {
        const int w = w0 + lane;
        const int cnt = w < n_words ? __popc(mask[w]) : 0;
        int incl = cnt;
        for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(kFull, incl, o);
            if (lane >= o) incl += v;
        }
        if (w < n_words) pre[w] = run + incl - cnt;
        run += __shfl_sync(kFull, incl, 31);
    }
    __syncwarp();

    // 3. the sort: in registers up to warp_buf entries, else in the scratch
    const unsigned long long* sorted = buf;
    if (m > a.warp_buf) {
        for (int i = lane; i < a.warp_buf; i += 32) srow[i] = buf[i];
        int w = 1;
        while (w < m) w <<= 1;
        for (int i = m + lane; i < w; i += 32) srow[i] = kPad;
        __syncwarp();
        if (w <= kChunk) {
            register_sort<8>(srow, m, lane);
        } else {
            scratch_sort(srow, w, lane);
        }
        sorted = srow;
    } else if (m > 128) {
        register_sort<8>(buf, m, lane);
    } else if (m > 64) {
        register_sort<4>(buf, m, lane);
    } else if (m > 32) {
        register_sort<2>(buf, m, lane);
    } else if (m > 1) {
        register_sort<1>(buf, m, lane);
    }
    __syncwarp();

    // 4. the row, output-stationary
    const Row row{sorted, mask, pre, n_lt, S - m, a.max_chunks < S ? a.max_chunks : S, n_words};
    int* ids = a.seg_ids + t * a.max_chunks;
    float* dist = a.seg_dist + t * a.max_chunks;
    int w = 0;
    if constexpr (kVec == 4) {
        for (int v = lane; 4 * v < a.max_chunks; v += 32) {
            int4 vi;
            float4 vd;
            const int r = 4 * v - row.lt;
            if (r >= 0 && r + 3 < row.big && 4 * v + 3 < row.keep &&
                clear_run(row, r, w, vi.x)) {
                // four ids of one word without pushed bits
                vi.y = vi.x + 1;
                vi.z = vi.x + 2;
                vi.w = vi.x + 3;
                vd = make_float4(kBig, kBig, kBig, kBig);
            } else {
                column(row, 4 * v, w, vi.x, vd.x);
                column(row, 4 * v + 1, w, vi.y, vd.y);
                column(row, 4 * v + 2, w, vi.z, vd.z);
                column(row, 4 * v + 3, w, vi.w, vd.w);
            }
            __stcs(reinterpret_cast<int4*>(ids) + v, vi);   // streaming: read by the next kernel
            __stcs(reinterpret_cast<float4*>(dist) + v, vd);
        }
    } else {
        for (int c = lane; c < a.max_chunks; c += 32) {
            int id;
            float d;
            column(row, c, w, id, d);
            __stcs(ids + c, id);
            __stcs(dist + c, d);
        }
    }
    if (lane == 0) {
        a.n_out[t] = n_listed < a.max_chunks ? n_listed : a.max_chunks;
        a.overflow[t] = n_listed > a.max_chunks;
    }
    __syncwarp();
}

template <int kVec, bool kStaged>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks) tri_lists_kernel(const ListArgs a) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    float* sh_min = reinterpret_cast<float*>(smem);
    float* sh_max = sh_min + a.stage_floats;
    if constexpr (kStaged) {
        // the boxes once a block, 16 bytes a load (3 n_segs floats an array)
        const int nf = 3 * a.n_segs;
        const float4* gmin = reinterpret_cast<const float4*>(a.seg_min);
        const float4* gmax = reinterpret_cast<const float4*>(a.seg_max);
        for (int q = threadIdx.x; q < nf / 4; q += blockDim.x) {
            reinterpret_cast<float4*>(sh_min)[q] = __ldg(gmin + q);
            reinterpret_cast<float4*>(sh_max)[q] = __ldg(gmax + q);
        }
        for (int i = nf / 4 * 4 + static_cast<int>(threadIdx.x); i < nf; i += blockDim.x) {
            sh_min[i] = a.seg_min[i];
            sh_max[i] = a.seg_max[i];
        }
        __syncthreads();
    }
    const float* bmin = kStaged ? sh_min : a.seg_min;
    const float* bmax = kStaged ? sh_max : a.seg_max;
    // each word's hull (min xyz, max xyz, an array each), its NaNs dropped: a
    // box with no NaN bound lies in its word's hull, and only such a box
    // meets the union
    const int n_words = (a.n_segs + 31) / 32;
    float* hulls = sh_min + 2 * a.stage_floats;
    for (int w = warp; w < n_words; w += blockDim.x / 32) {
        const int s = 32 * w + lane;
#pragma unroll
        for (int x = 0; x < 3; ++x) {
            const float lo = s < a.n_segs ? bmin[3 * s + x] : __int_as_float(0x7fffffff);
            const float hi = s < a.n_segs ? bmax[3 * s + x] : __int_as_float(0x7fffffff);
            const int l = __reduce_min_sync(kFull, isnan(lo) ? INT_MAX : order_int(lo));
            const int h = __reduce_max_sync(kFull, isnan(hi) ? INT_MIN : order_int(hi));
            if (lane == 0) {
                hulls[x * n_words + w] = from_order_int(l);
                hulls[(3 + x) * n_words + w] = from_order_int(h);
            }
        }
    }
    __syncthreads();
    const long long g = static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + warp;
    if (g >= a.n_warps) return;
    unsigned char* area = smem + a.block_bytes + static_cast<long long>(warp) * a.warp_bytes;
    unsigned long long* srow = a.scratch ? a.scratch + g * a.cap : nullptr;
    // a warp's first tile is its index; then tiles by ticket (n_warps +
    // the ticket), so warps whose tiles list little take more of them
    for (long long t = g; t < a.n_tiles;) {
        list_tile<kVec>(a, t, bmin, bmax, hulls, area, srow, lane);
        unsigned long long next = 0;
        if (lane == 0) next = atomicAdd(a.tickets, 1ull);
        t = a.n_warps + static_cast<long long>(__shfl_sync(kFull, next, 0));
    }
}

int next_pow2(int n) {
    int p = 1;
    while (p < n) p <<= 1;
    return p;
}

// A launch's shape: the instance, the warps a block, each warp's shared
// area and the block's shared bytes (the staged boxes and the word hulls
// first).
struct Plan {
    bool vec, staged;
    int warps, warp_bytes, stage_floats, block_bytes;
    size_t smem;
    const void* fn;
};

Plan plan_for(int n_segs, int K, int max_chunks, int warp_buf, int stage_segs, int most) {
    Plan p;
    const long long n_words = (n_segs + 31) / 32;
    p.vec = max_chunks % 4 == 0;
    p.staged = n_segs <= stage_segs;
    p.stage_floats = p.staged ? (3 * n_segs + 3) / 4 * 4 : 0;
    const long long area =
        (lists_bytes(warp_buf, static_cast<int>(n_words)) + 32LL * K + 24LL * (K + 2) + 15) /
        16 * 16;
    const long long stage = (8LL * p.stage_floats + 24 * n_words + 15) / 16 * 16;
    const long long fit = (most - stage) / area;
    p.warps = fit < 1 ? 0 : (fit < kWarps ? static_cast<int>(fit) : kWarps);
    p.warp_bytes = static_cast<int>(area);
    p.block_bytes = static_cast<int>(stage);
    p.smem = static_cast<size_t>(stage + area * p.warps);
    const void* fns[2][2] = {
        {reinterpret_cast<const void*>(tri_lists_kernel<1, false>),
         reinterpret_cast<const void*>(tri_lists_kernel<1, true>)},
        {reinterpret_cast<const void*>(tri_lists_kernel<4, false>),
         reinterpret_cast<const void*>(tri_lists_kernel<4, true>)}};
    p.fn = fns[p.vec][p.staged];
    return p;
}

// A plan's instance allowed its shared bytes, and its resident blocks an
// SM (both once a device, instance and shared size).
cudaError_t prepare(const Plan& p, int device, int& blocks) {
    static int cached[kMaxDevices][2][2][3];   // shared bytes, warps, blocks
    int* c = device < kMaxDevices ? cached[device][p.vec][p.staged] : nullptr;
    if (c && c[0] == static_cast<int>(p.smem) && c[1] == p.warps && c[2] > 0) {
        blocks = c[2];
        return cudaSuccess;
    }
    cudaError_t err = cudaFuncSetAttribute(p.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(p.smem));
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, p.fn, 32 * p.warps, p.smem);
    }
    if (err == cudaSuccess && c) {
        c[0] = static_cast<int>(p.smem);
        c[1] = p.warps;
        c[2] = blocks;
    }
    return err;
}

// The plan of a call on `device`: invalid where a warp's area does not fit
// beside the staged boxes.
cudaError_t plan_on(int n_segs, int K, int max_chunks, int warp_buf, int stage_segs, int device,
                    Plan& p) {
    int most = 0;
    const cudaError_t err =
        cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    p = plan_for(n_segs, K, max_chunks, warp_buf, stage_segs, most);
    return p.warps < 1 ? cudaErrorInvalidValue : cudaSuccess;
}

bool valid_shape(int n_segs, int K, int max_chunks, int warp_buf, int stage_segs) {
    return n_segs >= 0 && K >= 1 && K <= kMaxIntervals && max_chunks >= 0 && warp_buf >= 1 &&
           warp_buf <= kWarpBuf && stage_segs >= 0 && stage_segs <= kStageSegs;
}

bool misaligned(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 != 0; }

}  // namespace

// The front-to-back segment lists of n_tiles ray tiles (origins,
// directions f32[n_tiles * tile, 3], lengths f32[n_tiles * tile]) against
// the segment boxes (seg_min, seg_max f32[n_segs, 3]) with K intervals
// (frac f32[K + 1]): seg_ids i32[n_tiles, max_chunks], seg_dist
// f32[n_tiles, max_chunks], n i32[n_tiles] and the overflow bytes.
// warp_buf (1..kWarpBuf) entries a warp sort in registers; a tile that
// pushes more sorts in its warp's row of scratch u64[slots *
// next_pow2(n_segs)] (needed where n_segs > warp_buf; then at most slots
// warps take tiles); tickets: one u64, zeroed here before the launch.
// Boxes are staged in shared memory where n_segs <= stage_segs (<=
// kStageSegs; then 16-byte aligned); rows of a max_chunks that is a
// multiple of 4 are written as 16-byte vectors (then seg_ids and seg_dist
// 16-byte aligned).
extern "C" int grace_tri_tile_lists(const float* seg_min, const float* seg_max,
                                    const float* origins, const float* dirs,
                                    const float* lengths, const float* frac, int* seg_ids,
                                    float* seg_dist, int* n, unsigned char* overflow,
                                    unsigned long long* scratch,
                                    unsigned long long* tickets, int n_tiles, int tile,
                                    int n_segs, int K, int max_chunks, int slots, int warp_buf,
                                    int stage_segs, int device, void* stream) {
    const bool spills = n_segs > warp_buf;
    if (n_tiles < 0 || tile < 1 || !valid_shape(n_segs, K, max_chunks, warp_buf, stage_segs) ||
        slots < 0 || (spills && (!scratch || slots < 1)) || !frac ||
        (n_tiles > 0 && (!origins || !dirs || !lengths || !n || !overflow || !tickets ||
                         (max_chunks > 0 && (!seg_ids || !seg_dist)))) ||
        (n_tiles > 0 && max_chunks > 0 && max_chunks % 4 == 0 &&
         (misaligned(seg_ids) || misaligned(seg_dist))) ||
        (n_segs > 0 && (!seg_min || !seg_max)) ||
        (n_segs > 0 && n_segs <= stage_segs && (misaligned(seg_min) || misaligned(seg_max)))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_tiles == 0) return static_cast<int>(cudaGetLastError());
    Plan p;
    err = plan_on(n_segs, K, max_chunks, warp_buf, stage_segs, device, p);
    int per_sm = 0, sms = 0;
    if (err == cudaSuccess) err = prepare(p, device, per_sm);
    if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    // as many blocks as the card holds at once, fewer where the tiles (or
    // the scratch rows) are fewer
    long long warps = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms * p.warps;
    if (warps > n_tiles) warps = n_tiles;
    if (spills && warps > slots) warps = slots;
    const int grid = static_cast<int>((warps + p.warps - 1) / p.warps);
    ListArgs a{};
    a.seg_min = seg_min;
    a.seg_max = seg_max;
    a.origins = origins;
    a.dirs = dirs;
    a.lengths = lengths;
    a.frac = frac;
    a.seg_ids = seg_ids;
    a.seg_dist = seg_dist;
    a.n_out = n;
    a.overflow = overflow;
    a.scratch = spills ? scratch : nullptr;
    a.tickets = tickets;
    a.n_tiles = n_tiles;
    a.tile = tile;
    a.n_segs = n_segs;
    a.K = K;
    a.max_chunks = max_chunks;
    a.warp_buf = warp_buf;
    a.cap = next_pow2(n_segs > 0 ? n_segs : 1);
    a.n_warps = warps;
    a.warp_bytes = p.warp_bytes;
    a.stage_floats = p.stage_floats;
    a.block_bytes = p.block_bytes;
    err = cudaMemsetAsync(tickets, 0, sizeof(unsigned long long),
                          static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    void* args[] = {&a};
    err = cudaLaunchKernel(p.fn, dim3(grid), dim3(32 * p.warps), args, p.smem,
                           static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

// What one launch of grace_tri_tile_lists at these shapes holds (out
// i32[6]: registers a thread, shared bytes a block, threads a block,
// resident blocks and warps an SM, local bytes a thread): the instance the
// call takes (16-byte rows where max_chunks % 4 == 0, boxes staged where
// n_segs <= stage_segs).
extern "C" int grace_tri_tile_lists_resources(int* out, int n_segs, int K, int max_chunks,
                                              int warp_buf, int stage_segs, int device,
                                              void* stream) {
    (void)stream;
    if (!out || !valid_shape(n_segs, K, max_chunks, warp_buf, stage_segs)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    Plan p;
    err = plan_on(n_segs, K, max_chunks, warp_buf, stage_segs, device, p);
    cudaFuncAttributes attr;
    int blocks = 0;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, p.fn);
    if (err == cudaSuccess) err = prepare(p, device, blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.sharedSizeBytes + p.smem);
    out[2] = 32 * p.warps;
    out[3] = blocks;
    out[4] = blocks * p.warps;
    out[5] = static_cast<int>(attr.localSizeBytes);
    return 0;
}
