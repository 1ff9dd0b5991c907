// The triangle trace's segment lists on the card (E7): per ray tile, the
// 128-triangle segments its rays may hit, front to back.
//
// Not a TPU kernel: grace_tpu builds these lists as plain XLA
// (grace_tpu/trace/pallas_tri.py:89, _dense_tile_segments_tri) in front of
// its Pallas triangle kernel. The port ran them as a [tiles, K, segments]
// bool tensor in blocks of tiles, an amin over the intervals and a stable
// torch.sort of every row of segments.
//
// tri_lists_kernel: one block a tile (or, on the global route, a tile at a
// time, striding over the tiles).
//  1. The tile's K + 1 endpoint hulls: the points fma(d, ln * frac[k], o)
//     in vecmath.fma's form (fma_f64: the exact f64 product plus o,
//     rounded to f64, then to f32) with ln = clamp(len, min=0) and frac =
//     arange(K + 1) / K as torch computes it on the same device (passed in);
//     the K interval boxes (the union of hulls k and k + 1), the origins'
//     box and the shortest length. A warp a (k, axis) hull, lanes over
//     rays.
//  2. A thread a segment: a test against the intervals' union (fminf /
//     fmaxf, without NaN bounds: no interval a segment misses it meets)
//     drops most segments in one test; then kfirst = the first interval
//     whose box meets the segment's; for a listed segment g = clamp(max(smin - omax, omin -
//     smax), min=0) per axis, g2 = fma(gz, gz, fma(gx, gx, gy * gy)),
//     dist = max(sqrt(g2) (in f64, as vecmath.sqrt), frac[kfirst] *
//     ln_min). Every min, max and clamp takes torch's NaN rule on the card
//     (a NaN operand wins, else fminf / fmaxf).
//  3. The order of torch.sort(key, stable=True) over the whole row, with
//     key = dist where listed and BIG elsewhere: the listed segments whose
//     key is not BIG go to a buffer as (order bits of key) << 32 | id,
//     sorted there by a bitonic network (distinct ids, so every network
//     gives this one order; NaN keys sort last, as torch's); the
//     segments whose key is BIG (every unlisted one and any listed at
//     exactly BIG) keep ascending id and sit between the keys below BIG and
//     those above it: a warp takes 32 ids a step, a ballot and the word
//     counts' prefix sum place them. Only the first keep = min(max_chunks,
//     segments) columns are written; past keep the pads are 0 and BIG.
//
// The buffer holds a tile's listed segments, at most all of them: in shared
// memory while next_pow2(segments) <= kSharedSort, else (a mesh of more
// than 4,096 segments, 524,288 triangles) in a global scratch of `slots`
// rows, one a resident block, the same network with the same bits.
//
// What bounds it: writing keep ids and distances a tile (about 134 MB for
// the torus's 8,192 tiles of 2,048 segments), and reading the rays and the
// segment boxes (from L2, once a tile).

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxIntervals = 64;     // pallas_tri.MAX_INTERVALS
constexpr int kSharedSort = 4096;     // pallas_tri.SHARED_SORT: entries in shared memory
constexpr float kBig = 1e30f;         // pallas_tri.BIG
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kPad = ~0ull;

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

// A key's sort bits: keys are +-0, positive or NaN; -0 sorts with +0 and
// NaN last, as in torch.sort.
__device__ __forceinline__ unsigned order_bits(float key) {
    if (isnan(key)) return kFull;
    return key == 0.0f ? 0u : __float_as_uint(key);
}

__device__ __forceinline__ float key_of(unsigned bits) {
    return bits == kFull ? __int_as_float(0x7fffffff) : __uint_as_float(bits);
}

int next_pow2(int n) {
    int p = 1;
    while (p < n) p <<= 1;
    return p;
}

__global__ void __launch_bounds__(kThreads)
    tri_lists_kernel(const float* __restrict__ seg_min, const float* __restrict__ seg_max,
                     const float* __restrict__ origins, const float* __restrict__ dirs,
                     const float* __restrict__ lengths, const float* __restrict__ frac,
                     int* __restrict__ seg_ids, float* __restrict__ seg_dist,
                     int* __restrict__ n_out, unsigned char* __restrict__ overflow,
                     unsigned long long* scratch, int n_tiles, int tile, int n_segs, int K,
                     int max_chunks, int cap) {
    extern __shared__ unsigned long long smem[];
    __shared__ float bmin[kMaxIntervals + 1][3], bmax[kMaxIntervals + 1][3];
    __shared__ float imin[kMaxIntervals][3], imax[kMaxIntervals][3];
    __shared__ float obox[2][3], ubox[2][3], ln_min;
    __shared__ int n_push, n_lt, n_listed;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int n_words = (n_segs + 31) / 32;
    unsigned long long* buf = scratch ? scratch + static_cast<long long>(blockIdx.x) * cap : smem;
    unsigned* mask = reinterpret_cast<unsigned*>(scratch ? smem : smem + cap);
    int* prefix = reinterpret_cast<int*>(mask + n_words);
    const int keep = max_chunks < n_segs ? max_chunks : n_segs;

    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const long long r0 = static_cast<long long>(t) * tile;
        // 1. hulls: (K + 1) x 3 endpoint tasks, 3 origin tasks, 1 length task
        const int n_tasks = 3 * (K + 1) + 4;
        for (int task = warp; task < n_tasks; task += kWarps) {
            float lo = INFINITY, hi = -INFINITY;
            for (int i = lane; i < tile; i += 32) {
                const long long r = r0 + i;
                float v;
                if (task < 3 * (K + 1)) {
                    const int k = task / 3, a = task % 3;
                    v = fma_f64(dirs[3 * r + a], clamp0(lengths[r]) * frac[k], origins[3 * r + a]);
                } else if (task < 3 * (K + 1) + 3) {
                    v = origins[3 * r + task - 3 * (K + 1)];
                } else {
                    v = clamp0(lengths[r]);
                }
                lo = nan_min(lo, v);
                hi = nan_max(hi, v);
            }
            for (int o = 16; o > 0; o >>= 1) {
                lo = nan_min(lo, __shfl_xor_sync(kFull, lo, o));
                hi = nan_max(hi, __shfl_xor_sync(kFull, hi, o));
            }
            if (lane == 0) {
                if (task < 3 * (K + 1)) {
                    bmin[task / 3][task % 3] = lo;
                    bmax[task / 3][task % 3] = hi;
                } else if (task < 3 * (K + 1) + 3) {
                    obox[0][task - 3 * (K + 1)] = lo;
                    obox[1][task - 3 * (K + 1)] = hi;
                } else {
                    ln_min = lo;
                }
            }
        }
        for (int w = tid; w < n_words; w += kThreads) mask[w] = 0u;
        if (tid == 0) n_push = n_lt = n_listed = 0;
        __syncthreads();
        if (tid < 3 * K) {
            const int k = tid / 3, a = tid % 3;
            imin[k][a] = nan_min(bmin[k][a], bmin[k + 1][a]);
            imax[k][a] = nan_max(bmax[k][a], bmax[k + 1][a]);
        }
        __syncthreads();
        // the intervals' union without their NaN bounds: a box that meets
        // an interval meets it, so a segment that misses it is not listed
        if (tid < 3) {
            float lo = INFINITY, hi = -INFINITY;
            for (int k = 0; k < K; ++k) {
                lo = fminf(lo, imin[k][tid]);
                hi = fmaxf(hi, imax[k][tid]);
            }
            ubox[0][tid] = lo;
            ubox[1][tid] = hi;
        }
        __syncthreads();

        // 2. a thread a segment: kfirst, the entry distance, the buffer
        for (int s = tid; s < n_segs; s += kThreads) {
            float lo[3], hi[3];
            for (int a = 0; a < 3; ++a) {
                lo[a] = seg_min[3LL * s + a];
                hi[a] = seg_max[3LL * s + a];
            }
            if (!(ubox[0][0] <= hi[0] && lo[0] <= ubox[1][0] && ubox[0][1] <= hi[1] &&
                  lo[1] <= ubox[1][1] && ubox[0][2] <= hi[2] && lo[2] <= ubox[1][2])) {
                continue;
            }
            int kfirst = K;
            for (int k = 0; k < K; ++k) {
                if (imin[k][0] <= hi[0] && lo[0] <= imax[k][0] && imin[k][1] <= hi[1] &&
                    lo[1] <= imax[k][1] && imin[k][2] <= hi[2] && lo[2] <= imax[k][2]) {
                    kfirst = k;
                    break;
                }
            }
            if (kfirst == K) continue;
            atomicAdd(&n_listed, 1);
            float g[3];
            for (int a = 0; a < 3; ++a) g[a] = clamp0(nan_max(lo[a] - obox[1][a], obox[0][a] - hi[a]));
            const float g2 = fma_f64(g[2], g[2], fma_f64(g[0], g[0], g[1] * g[1]));
            const float root = __double2float_rn(sqrt(static_cast<double>(g2)));
            const float key = nan_max(root, frac[kfirst] * ln_min);
            if (key == kBig) continue;
            if (key < kBig) atomicAdd(&n_lt, 1);
            buf[atomicAdd(&n_push, 1)] =
                static_cast<unsigned long long>(order_bits(key)) << 32 | static_cast<unsigned>(s);
            atomicOr(&mask[s / 32], 1u << (s % 32));
        }
        __syncthreads();

        // 3. sort the buffer: a bitonic network over next_pow2(m) entries
        const int m = n_push;
        int width = 1;
        while (width < m) width <<= 1;
        for (int i = m + tid; i < width; i += kThreads) buf[i] = kPad;
        __syncthreads();
        for (int k = 2; k <= width; k <<= 1) {
            for (int j = k >> 1; j > 0; j >>= 1) {
                for (int i = tid; i < width; i += kThreads) {
                    const int p = i ^ j;
                    if (p > i) {
                        const unsigned long long a = buf[i], b = buf[p];
                        if ((a > b) == ((i & k) == 0)) {
                            buf[i] = b;
                            buf[p] = a;
                        }
                    }
                }
                __syncthreads();
            }
        }

        // the BIG group's word counts and their exclusive prefix sum
        const int big = n_segs - m, lt = n_lt;
        int running = 0;
        for (int base = 0; base < n_words; base += kThreads) {
            const int w = base + tid;
            unsigned in = 0u;
            if (w < n_words) {
                const int bits = n_segs - 32 * w < 32 ? n_segs - 32 * w : 32;
                in = ~mask[w] & (bits == 32 ? kFull : (1u << bits) - 1u);
            }
            const int c = __popc(in);
            int incl = c;
            for (int o = 1; o < 32; o <<= 1) {
                const int v = __shfl_up_sync(kFull, incl, o);
                if (lane >= o) incl += v;
            }
            __shared__ int warp_sums[kWarps];
            if (lane == 31) warp_sums[warp] = incl;
            __syncthreads();
            int before = running;
            for (int v = 0; v < warp; ++v) before += warp_sums[v];
            if (w < n_words) prefix[w] = before + incl - c;
            for (int v = 0; v < kWarps; ++v) running += warp_sums[v];
            __syncthreads();
        }

        // 4. the row: sorted entries around the BIG group, then the pads
        const long long row = static_cast<long long>(t) * max_chunks;
        for (int i = tid; i < m; i += kThreads) {
            const int c = i < lt ? i : i + big;
            if (c < keep) {
                const unsigned long long e = buf[i];
                seg_ids[row + c] = static_cast<int>(e & 0xffffffffu);
                seg_dist[row + c] = key_of(static_cast<unsigned>(e >> 32));
            }
        }
        for (int w = warp; w < n_words && lt + prefix[w] < keep; w += kWarps) {
            const int s = 32 * w + lane;
            const bool in = s < n_segs && !((mask[w] >> lane) & 1u);
            const unsigned vote = __ballot_sync(kFull, in);
            const int c = lt + prefix[w] + __popc(vote & ((1u << lane) - 1u));
            if (in && c < keep) {
                seg_ids[row + c] = s;
                seg_dist[row + c] = kBig;
            }
        }
        for (int c = keep + tid; c < max_chunks; c += kThreads) {
            seg_ids[row + c] = 0;
            seg_dist[row + c] = kBig;
        }
        if (tid == 0) {
            const int listed = n_listed;
            n_out[t] = listed < max_chunks ? listed : max_chunks;
            overflow[t] = listed > max_chunks;
        }
        __syncthreads();
    }
}

}  // namespace

// The front-to-back segment lists of n_tiles ray tiles (origins,
// directions f32[n_tiles * tile, 3], lengths f32[n_tiles * tile]) against
// the segment boxes (seg_min, seg_max f32[n_segs, 3]) with K intervals
// (frac f32[K + 1]): seg_ids i32[n_tiles, max_chunks], seg_dist
// f32[n_tiles, max_chunks], n i32[n_tiles] and the overflow bytes. slots 0
// sorts in shared memory (next_pow2(n_segs) <= kSharedSort); slots > 0 in
// scratch u64[slots * next_pow2(n_segs)], min(n_tiles, slots) blocks.
extern "C" int grace_tri_tile_lists(const float* seg_min, const float* seg_max,
                                    const float* origins, const float* dirs,
                                    const float* lengths, const float* frac, int* seg_ids,
                                    float* seg_dist, int* n, unsigned char* overflow,
                                    unsigned long long* scratch, int n_tiles, int tile,
                                    int n_segs, int K, int max_chunks, int slots, int device,
                                    void* stream) {
    const int cap = next_pow2(n_segs > 0 ? n_segs : 1);
    const int n_words = (n_segs + 31) / 32;
    const bool shared_sort = slots == 0;
    const size_t smem = (shared_sort ? sizeof(unsigned long long) * cap : 0) +
                        sizeof(int) * 2 * static_cast<size_t>(n_words);
    if (n_tiles < 0 || tile < 1 || n_segs < 0 || K < 1 || K > kMaxIntervals || max_chunks < 0 ||
        slots < 0 || (shared_sort && cap > kSharedSort) || (!shared_sort && !scratch) ||
        smem > 48 * 1024 || !frac ||
        (n_tiles > 0 && (!origins || !dirs || !lengths || !n || !overflow ||
                         (max_chunks > 0 && (!seg_ids || !seg_dist)))) ||
        (n_segs > 0 && (!seg_min || !seg_max))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_tiles == 0) return static_cast<int>(cudaGetLastError());
    const int blocks = shared_sort ? n_tiles : (slots < n_tiles ? slots : n_tiles);
    tri_lists_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        seg_min, seg_max, origins, dirs, lengths, frac, seg_ids, seg_dist, n, overflow,
        shared_sort ? nullptr : scratch, n_tiles, tile, n_segs, K, max_chunks, cap);
    return static_cast<int>(cudaGetLastError());
}
