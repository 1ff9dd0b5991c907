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
// bucket_keys_kernel: one thread a particle. pu, pv and depth are the
// port's vecmath.dot3 (x * x in f32, then two multiply-adds that each take
// the exact f64 product plus the sum, rounded once to f32: fma_f64), the
// reciprocals IEEE divisions (torch's 1.0 / t is reciprocal(t) * 1.0),
// --fmad=false keeps every other operation rounded alone. The band and
// row-tile quotients are floored and converted to int64 as torch's
// .to(torch.int64) does on the card (cvt.rzi: saturating, NaN -> 0), and
// the int64 arithmetic after them wraps as torch's does. It writes the
// four keys at q * n + p (q = 2 rr + cc, the torch.cat order) with the
// sentinel n_keys, the particle's (pu, pv, invh, scale) as the slabs take
// them (unweighted: invh masked by the depth cull and scale = invh^2, as
// the plain path derives it after the sort), and sets the overflow byte.
//
// bucket_count_kernel, bucket_scatter_kernel: a stable counting sort of
// the 4 n keys over their n_keys + 1 values (on an H100, torch.sort's
// radix sort took 13 of the setup's 17 launches and most of its device
// time for these 9-bit keys). A warp
// owns a tile of `tile` consecutive instances. Counting, it takes 32 at a
// time; __match_any_sync groups the lanes of one key and the group's
// first lane adds the group's size to counts[key * tiles + warp]. An
// inclusive scan of the counts in that (key-major) order (torch.cumsum)
// gives each (key, warp) pair the end of its slots. Scattering, the warp
// walks its tile backwards, 32 at a time: the group's first lane moves
// the pair's cursor down by the group's size, and lane l of the group
// writes its instance at the new cursor plus the group's lanes below l.
// Only the owning warp touches a pair's counter or cursor (__syncwarp
// orders its lanes' accesses from one round to the next), so every
// position is fixed: instances of one key land in ascending instance
// order, as a stable sort puts them. After the scatter each cursor holds
// its pair's first slot, so cursor[k * tiles] is key k's first instance.
//
// bucket_pack_kernel: one thread a slab instance g (4 slab positions): it
// gathers particle order[g] mod n's row and writes it into the
// (n_slabs_cap, 8, chunk) slabs, zeros past 4 n. Thread k < n_keys also
// writes key k's range [first, last) from the cursors, slab_lo and
// n_slabs: no pad, stack, repeat or searchsorted launch.
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
// What bounds them: memory. Each particle is read once and each output
// written once: at 2^20 particles E4 moves ~150 MB (spheres 16 MB, keys
// 16 MB written and read twice, order 16 MB written and read, rows 16 MB
// gathered, slabs 64 MB, the counts a few MB) and E5 ~52 MB (spheres 16
// MB, slabs 32 MB, masks). The design keeps each step one launch over all
// particles, with the camera's constants in a small device tensor and no
// host round trip.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
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

int grid(long long n) { return static_cast<int>((n + kThreads - 1) / kThreads); }

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

__global__ void __launch_bounds__(kThreads)
    bucket_keys_kernel(const float4* __restrict__ spheres, const float* __restrict__ weights,
                       const float* __restrict__ consts, int* __restrict__ keys,
                       float4* __restrict__ rows, unsigned char* __restrict__ overflow, int n,
                       int nbx, int nty, int n_keys) {
    const int p = blockIdx.x * kThreads + threadIdx.x;
    if (p >= n) return;
    const float4 s = spheres[p];
    const float h = s.w;
    const float pu = dot3(s.x, s.y, s.z, consts + kV);
    const float pv = dot3(s.x, s.y, s.z, consts + kU);
    const float depth = dot3(s.x - consts[kCam], s.y - consts[kCam + 1],
                             s.z - consts[kCam + 2], consts + kViewDir);
    const bool positive = h > 0.0f;
    const float inv_h2 = positive ? 1.0f / fmaxf(h * h, kTiny) : 0.0f;
    const float w_p = weights ? weights[p] * inv_h2 : inv_h2;
    const bool live = positive && depth >= 0.0f && depth < consts[kLength];
    const float scale = live ? w_p : 0.0f;

    const float x0 = consts[kX0], y0 = consts[kY0];
    const float band_step = consts[kBandStep], tile_step = consts[kTileStep];
    const long long cb_lo = floor_i64(((pu - h) - x0) / band_step);
    long long cb_hi = floor_i64(((pu + h) - x0) / band_step);
    const long long rt_lo = floor_i64(((pv + h) - y0) / tile_step);   // rows descend
    long long rt_hi = floor_i64(((pv - h) - y0) / tile_step);
    if (live && (wrap_sub(cb_hi, cb_lo) > 1 || wrap_sub(rt_hi, rt_lo) > 1)) *overflow = 1;
    const long long cb_next = wrap_add(cb_lo, 1), rt_next = wrap_add(rt_lo, 1);
    cb_hi = cb_hi < cb_next ? cb_hi : cb_next;
    rt_hi = rt_hi < rt_next ? rt_hi : rt_next;
    for (int rr = 0; rr < 2; ++rr) {
        for (int cc = 0; cc < 2; ++cc) {
            const long long cb = wrap_add(cb_lo, cc), rt = wrap_add(rt_lo, rr);
            const bool ok = cb <= cb_hi && rt <= rt_hi && cb >= 0 && cb < nbx && rt >= 0 &&
                            rt < nty && scale > 0.0f;
            keys[static_cast<long long>(rr * 2 + cc) * n + p] =
                ok ? static_cast<int>(rt * nbx + cb) : n_keys;
        }
    }
    const float invh = positive ? 1.0f / fmaxf(h, kTiny) : 0.0f;
    float invh_s, scale_s;
    if (weights) {
        invh_s = invh;
        scale_s = scale;
    } else {
        invh_s = live ? invh : 0.0f;
        scale_s = invh_s * invh_s;
    }
    rows[p] = make_float4(pu, pv, invh_s, scale_s);
}

constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
    bucket_count_kernel(const int* __restrict__ keys, int* __restrict__ counts, int m, int tile,
                        int tiles) {
    const int w = (blockIdx.x * kThreads + threadIdx.x) / 32, lane = threadIdx.x % 32;
    if (w >= tiles) return;
    const int start = w * tile;
    const int end = m - start < tile ? m : start + tile;
    for (int base = start; base < end; base += 32) {
        const int i = base + lane;
        const int key = i < end ? keys[i] : -1;
        const unsigned peers = __match_any_sync(kFull, key);
        if (key >= 0 && lane == __ffs(peers) - 1) {
            counts[static_cast<long long>(key) * tiles + w] += __popc(peers);
        }
        __syncwarp();
    }
}

__global__ void __launch_bounds__(kThreads)
    bucket_scatter_kernel(const int* __restrict__ keys, int* __restrict__ cursor,
                          int* __restrict__ order, int m, int tile, int tiles) {
    const int w = (blockIdx.x * kThreads + threadIdx.x) / 32, lane = threadIdx.x % 32;
    if (w >= tiles) return;
    const int start = w * tile;
    const int end = m - start < tile ? m : start + tile;
    for (int base = start + ((end - start - 1) & ~31); base >= start; base -= 32) {
        const int i = base + lane;
        const int key = i < end ? keys[i] : -1;
        const unsigned peers = __match_any_sync(kFull, key);
        const int leader = __ffs(peers) - 1;
        const int size = __popc(peers);
        int top = 0;
        if (key >= 0 && lane == leader) {
            int* c = cursor + static_cast<long long>(key) * tiles + w;
            top = *c;
            *c = top - size;
        }
        top = __shfl_sync(kFull, top, leader);
        if (key >= 0) order[top - size + __popc(peers & ((1u << lane) - 1u))] = i;
        __syncwarp();
    }
}

__global__ void __launch_bounds__(kThreads)
    bucket_pack_kernel(const int* __restrict__ order, const int* __restrict__ cursor,
                       const float4* __restrict__ rows, float* __restrict__ slabs,
                       int* __restrict__ first, int* __restrict__ last,
                       int* __restrict__ slab_lo, int* __restrict__ n_slabs, int n, int cap,
                       int chunk, int n_keys, int tiles) {
    const int g = blockIdx.x * kThreads + threadIdx.x;
    if (g < cap) {
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (g < 4 * n) v = rows[order[g] % n];
        // chunk ci = g / chunk is rows 4 (ci % 2) .. +3 of slab ci / 2
        const long long base = static_cast<long long>(g / chunk) * 4 * chunk + g % chunk;
        slabs[base] = v.x;
        slabs[base + chunk] = v.y;
        slabs[base + 2 * chunk] = v.z;
        slabs[base + 3 * chunk] = v.w;
    }
    if (g < n_keys) {
        const int per_slab = 2 * chunk;
        const int f = cursor[static_cast<long long>(g) * tiles];
        const int l = cursor[static_cast<long long>(g + 1) * tiles];
        const int lo = f / per_slab;
        const int count = (l + per_slab - 1) / per_slab - lo;
        first[g] = f;
        last[g] = l;
        slab_lo[g] = lo;
        n_slabs[g] = count > 0 ? count : 0;
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

// Keys i32[4 n] (key of instance q * n + p, sentinel n_keys), rows
// f32[n, 4] (pu, pv, invh, scale as the slabs take them) and the overflow
// byte (zeroed here, in the stream) of n spheres f32[n, 4] (16-byte
// aligned); weights f32[n] or null; consts f32[17].
extern "C" int grace_splat_bucket_keys(const float* spheres, const float* weights,
                                       const float* consts, int* keys, float* rows,
                                       unsigned char* overflow, int n, int nbx, int nty,
                                       int n_keys, int device, void* stream) {
    if (n < 0 || nbx < 1 || nty < 1 || n_keys != nbx * nty || !consts || !overflow ||
        (n > 0 && (!spheres || !keys || !rows)) ||
        reinterpret_cast<uintptr_t>(spheres) % 16 || reinterpret_cast<uintptr_t>(rows) % 16) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const auto s = static_cast<cudaStream_t>(stream);
    err = cudaMemsetAsync(overflow, 0, 1, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n == 0) return static_cast<int>(cudaGetLastError());
    bucket_keys_kernel<<<grid(n), kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(spheres), weights, consts, keys,
        reinterpret_cast<float4*>(rows), overflow, n, nbx, nty, n_keys);
    return static_cast<int>(cudaGetLastError());
}

// The counting sort's first pass over keys i32[m] (values in [0, n_bins)):
// counts i32[n_bins * tiles] (zeroed here, in the stream), key-major, of
// warp tiles of `tile` instances (tile a multiple of 32, tiles * tile >= m).
extern "C" int grace_splat_bucket_count(const int* keys, int* counts, int m, int tile,
                                        int tiles, int n_bins, int device, void* stream) {
    if (m < 0 || tile < 32 || tile % 32 || tiles < 1 || static_cast<long long>(tiles) * tile < m ||
        n_bins < 1 || !counts || (m > 0 && !keys)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const auto s = static_cast<cudaStream_t>(stream);
    err = cudaMemsetAsync(counts, 0, sizeof(int) * static_cast<size_t>(n_bins) * tiles, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    bucket_count_kernel<<<grid(32LL * tiles), kThreads, 0, s>>>(keys, counts, m, tile, tiles);
    return static_cast<int>(cudaGetLastError());
}

// The counting sort's scatter: order i32[m], the instances in stable key
// order, from the inclusive scan of grace_splat_bucket_count's counts in
// cursor (each left at its (key, tile) pair's first slot).
extern "C" int grace_splat_bucket_scatter(const int* keys, int* cursor, int* order, int m,
                                          int tile, int tiles, int device, void* stream) {
    if (m < 0 || tile < 32 || tile % 32 || tiles < 1 || static_cast<long long>(tiles) * tile < m ||
        !cursor || (m > 0 && (!keys || !order))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    bucket_scatter_kernel<<<grid(32LL * tiles), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        keys, cursor, order, m, tile, tiles);
    return static_cast<int>(cudaGetLastError());
}

// Slabs f32[cap / (2 chunk), 8, chunk] and the key ranges first, last,
// slab_lo, n_slabs i32[n_keys] from the sorted instances order i32[4 n],
// the scattered cursors i32[(n_keys + 1) * tiles] and the rows of
// grace_splat_bucket_keys.
extern "C" int grace_splat_bucket_pack(const int* order, const int* cursor, const float* rows,
                                       float* slabs, int* first, int* last, int* slab_lo,
                                       int* n_slabs, int n, int cap, int chunk, int n_keys,
                                       int tiles, int device, void* stream) {
    if (n < 0 || chunk < 1 || n_keys < 1 || tiles < 1 || cap < 4LL * n || cap % (2 * chunk) ||
        !cursor || !first || !last || !slab_lo || !n_slabs ||
        (n > 0 && (!order || !rows || !slabs)) || reinterpret_cast<uintptr_t>(rows) % 16) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int threads = cap > n_keys ? cap : n_keys;
    bucket_pack_kernel<<<grid(threads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        order, cursor, reinterpret_cast<const float4*>(rows), slabs, first, last, slab_lo,
        n_slabs, n, cap, chunk, n_keys, tiles);
    return static_cast<int>(cudaGetLastError());
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
