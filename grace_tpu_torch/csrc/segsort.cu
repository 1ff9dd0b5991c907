// The per-hit records' post-processing on the card: the record rows' sort
// by distance (E8), the CSR sort by distance (E9) and the flat layout (E10).
//
// Not TPU kernels: grace_tpu runs these as plain XLA after its Pallas
// record kernels. They replace grace_tpu/trace/pallas_records.py:729
// (sort_records_by_distance: one lane-axis lax.sort of the rows),
// grace_tpu/ops/segops.py:70 (sort_by_distance, with offsets_to_segments
// :24 and segmented_sort :57: a lexicographic lax.sort on (segment, key))
// and grace_tpu/trace/pallas_records.py:741 (records_to_flat: a scatter of
// the rows into the flat buffers). The port ran them as torch.sort or two
// stable argsorts plus a gather for every array, and a scatter through
// boolean indexing (a host sync). In the CUDA original this is the
// segmented sort over per-ray hit lists (sort_by_distance over the
// vendored sgpu segmented sort, cuda/sort.cuh:100-131).
//
// The order is grace_tpu's, lax.sort with one key, stable: -0 ties with
// +0 and so does every subnormal (XLA compares with subnormals flushed),
// every NaN ties with every other NaN and sorts after +inf, ties keep
// their input order. Each key becomes one distinct u64: the f32 key
// canonicalized (NaN -> 0x7FC00000, -0 and subnormals -> +0), mapped to the
// order-preserving u32 (all bits flipped for a negative, the sign bit set
// for the rest), shifted up 32, or'ed with the element's position. Any
// sorting network then gives exactly that order. The record rows key a
// sentinel slot (index -1) to +inf, so a real +inf ties with it by column.
//
// warp_sort: a warp sorts a run of up to 32 E elements (E = 1 ... 32, so
// up to kMaxChunk = 1024) in registers: lane l holds elements l E ... l E
// + E - 1, a bitonic network over the next power of two (pads ~0 sort
// last), strides below E inside a lane, the others across lanes by
// shuffles; no block barrier. The run's keys and payloads pass through
// the warp's own padded buffer in shared memory, so every global load and
// store of a warp is coalesced (lane-strided) while the network reads its
// elements blocked.
//
// sort_rows (E8, grace_sort_rows): a warp a record row of width <= 1024,
// the network only over the prefix that ends with the row's last record
// (sort_row: the tail of sentinel slots keeps its place, the prefix's
// NaNs move past it); the indices, integrals and distances are gathered
// by the sorted positions. Wider rows take E9's launches with a segment a
// row.
//
// segmented sort (E9): head flags (grace_seg_heads: offsets[1:] inside
// [1, min(H, total_hits)), a negative one counted from the end, and
// total_hits itself open a segment; repeated
// and unordered starts each open one boundary, as offsets_to_segments's
// marks and cumsum), the segment starts (grace_seg_count a warp a tile of
// kTile flags, torch.cumsum, grace_seg_starts: ballots place the heads),
// then grace_segmented_sort: a warp a segment of at most 512 elements,
// gathered into every payload (up to kMaxPayloads arrays of 4 bytes, f32
// or i32, in one launch). A longer segment (the trailing pseudo-segment of
// capacity padding can be millions long) joins the long list; its chunks
// of `chunk` elements are sorted by warps into a u64 buffer
// (grace_seg_chunks), merged pairwise in device memory (merge path: a
// block a tile of 256 outputs, its co-ranks by a warp's 32-way search, the
// tile's elements ranked in shared memory) until each segment is one run
// (grace_seg_merge, ceil(log2(H / chunk)) rounds, each a launch that ends
// at once where no segment is long; a segment that is one run already is
// left in the buffer that holds it), and gathered from there
// (grace_seg_gather).
//
// records_to_flat (E10, grace_records_to_flat): a warp a row copies its
// first min(count, cap) columns to offsets + col where that is below the
// capacity, coalesced; the offsets are torch.cumsum's (int64, cast to
// int32, as the plain version; rows of fewer than 2^31 slots with the
// sentinel slots, so the cast never wraps). The kernel writes every
// position once: the records, each sentinel slot, and the tail past the
// last row (no fill pass first).
//
// What bounds them: at the limit, memory. E8 and E9 read each key once
// and each payload once and write each payload once (24 B a record slot
// for the rows, 24 B an entry for a flat layout of three arrays); the
// network's compares stay in registers. E10 reads each kept record (12 B)
// and writes every position of the three buffers (12 B). As built, the
// sort kernels are bound by the network's u64 compare-exchanges and shuffles
// (kernels of 80 registers, three blocks of eight warps an SM), and a long
// segment costs a launch of co-rank searches a merge round.

#include <cstdint>
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 1024;       // segops.SEG_CHUNK: the longest run a warp sorts
constexpr int kTile = 1024;           // segops.HEAD_TILE: head flags a warp counts
constexpr int kMaxPayloads = 8;       // segops.MAX_PAYLOADS: arrays one launch gathers
constexpr int kMaxBlocks = 1 << 16;   // grid-stride loops past this many blocks
constexpr int kLongBlocks = 1024;     // the long route's grid-stride grids: they end at once
                                      // where no segment is long
constexpr int kMergeTile = 256;       // segops.MERGE_TILE: outputs a merge block takes at a time
constexpr int kMinChunk = 128;        // chunks of at least half a merge tile
constexpr int kWarpRun = 512;         // segops.WARP_RUN: the segmented sort's longest warp run
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kPad = ~0ull;

struct Payloads {
    const uint32_t* src[kMaxPayloads];
    uint32_t* dst[kMaxPayloads];
    int n;
};

int blocks_for(long long threads) {
    const long long b = (threads + kThreads - 1) / kThreads;
    return static_cast<int>(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

// The order-preserving u32 of a key, as lax.sort orders f32: -0 with +0
// and every subnormal with them (XLA compares with subnormals flushed),
// every NaN after +inf.
__device__ __forceinline__ unsigned order_bits(float key) {
    const unsigned b = __float_as_uint(key);
    const unsigned u = isnan(key) ? 0x7fc00000u : ((b & 0x7f800000u) == 0u ? 0u : b);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// One step (k, j) of the bitonic network over the warp's 32 E elements,
// element i = lane E + e in v[e].
template <int E, int K, int J>
__device__ __forceinline__ void bitonic_step(unsigned long long (&v)[E], int lane) {
    if constexpr (J >= E) {
        constexpr int kLanes = J / E;
        const bool keep_min = ((lane & kLanes) == 0) == (((lane * E) & K) == 0);
#pragma unroll
        for (int e = 0; e < E; ++e) {
            const unsigned long long w = __shfl_xor_sync(kFull, v[e], kLanes);
            v[e] = keep_min ? (w < v[e] ? w : v[e]) : (w < v[e] ? v[e] : w);
        }
    } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
            if ((e & J) == 0) {
                const bool ascending = ((lane * E + e) & K) == 0;
                const unsigned long long a = v[e], b = v[e | J];
                const bool swap = (a > b) == ascending;
                v[e] = swap ? b : a;
                v[e | J] = swap ? a : b;
            }
        }
    }
    if constexpr (J > 1) bitonic_step<E, K, J / 2>(v, lane);
}

template <int E, int K = 2>
__device__ __forceinline__ void warp_bitonic(unsigned long long (&v)[E], int lane) {
    bitonic_step<E, K, K / 2>(v, lane);
    if constexpr (K < 32 * E) warp_bitonic<E, K * 2>(v, lane);
}

// The warp's staging buffer index of run element i: one pad word every 32,
// so the blocked reads (lane E + e) and the coalesced ones (lane + 32 c)
// both fall on 32 banks.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// A run's keys staged in a, coalesced: their order bits.
__device__ __forceinline__ void stage_keys(const float* keys, const int32_t* mask, long long s,
                                           int len, int lane, uint32_t* a) {
    for (int i = lane; i < len; i += 32) {
        const float k = (mask && mask[s + i] == -1) ? INFINITY : keys[s + i];
        a[pad(i)] = order_bits(k);
    }
    __syncwarp();
}

// Sorted element i of a run goes to slot place(i): i itself, or around a
// record row's tail of sentinel slots (sort_row).
struct Identity {
    __device__ int operator()(int i) const { return i; }
};

struct AroundTail {
    int keep, shift;
    __device__ int operator()(int i) const { return i < keep ? i : i + shift; }
};

// The network over the first m staged keys (m <= 32 E), read blocked from
// a: with kChunk the sorted u64 keys to buf[s ...] (through a and b, so
// the stores are coalesced), else each sorted element's run index to
// a[place(i)].
template <int E, bool kChunk, typename Place>
__device__ __forceinline__ void network(long long s, int m, int lane, uint32_t* a, uint32_t* b,
                                        unsigned long long* buf, Place place) {
    unsigned long long v[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const int i = lane * E + e;
        v[e] = i < m ? static_cast<unsigned long long>(a[pad(i)]) << 32 |
                           static_cast<unsigned>(s + i)
                     : kPad;
    }
    warp_bitonic<E>(v, lane);
    __syncwarp();
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const int i = lane * E + e;
        if (i >= m) continue;
        if constexpr (kChunk) {
            a[pad(i)] = static_cast<uint32_t>(v[e]);
            b[pad(i)] = static_cast<uint32_t>(v[e] >> 32);
        } else {
            a[pad(place(i))] = static_cast<uint32_t>(v[e]) - static_cast<uint32_t>(s);
        }
    }
    __syncwarp();
    if constexpr (kChunk) {
        for (int i = lane; i < m; i += 32) {
            buf[s + i] = static_cast<unsigned long long>(b[pad(i)]) << 32 | a[pad(i)];
        }
        __syncwarp();
    }
}

// network with E the next power of two of ceil(m / 32), up to kMaxE (the
// kernel for runs of (512, 1024] has only E = 32).
template <int kMaxE, bool kChunk, typename Place>
__device__ __forceinline__ void network_for(long long s, int m, int lane, uint32_t* a,
                                            uint32_t* b, unsigned long long* buf, Place place) {
    const int per_lane = (m + 31) / 32;
    if constexpr (kMaxE == 32) {
        network<32, kChunk>(s, m, lane, a, b, buf, place);
    } else {
        if (per_lane <= 1) network<1, kChunk>(s, m, lane, a, b, buf, place);
        else if (per_lane <= 2) network<2, kChunk>(s, m, lane, a, b, buf, place);
        else if (per_lane <= 4) network<4, kChunk>(s, m, lane, a, b, buf, place);
        else if (per_lane <= 8) network<8, kChunk>(s, m, lane, a, b, buf, place);
        else network<16, kChunk>(s, m, lane, a, b, buf, place);
    }
}

// Each payload of the run [s, s + len) staged in b, coalesced, and written
// back in the order of the run indices in a: slot q takes b[a[q]].
__device__ __forceinline__ void gather_payloads(const Payloads& pl, long long s, int len,
                                                int lane, const uint32_t* a, uint32_t* b) {
#pragma unroll
    for (int k = 0; k < kMaxPayloads; ++k) {
        if (k >= pl.n) break;
        for (int i = lane; i < len; i += 32) b[pad(i)] = pl.src[k][s + i];
        __syncwarp();
        for (int i = lane; i < len; i += 32) pl.dst[k][s + i] = b[pad(a[pad(i)])];
        __syncwarp();
    }
}

// A segment [s, s + len): staged, sorted, gathered.
template <int kMaxE>
__device__ __forceinline__ void sort_segment(const float* keys, const int32_t* mask, long long s,
                                             int len, int lane, const Payloads& pl, uint32_t* a,
                                             uint32_t* b) {
    if (len == 1) {   // nothing to order: the element stays
        if (lane == 0) {
#pragma unroll
            for (int k = 0; k < kMaxPayloads; ++k) {
                if (k < pl.n) pl.dst[k][s] = pl.src[k][s];
            }
        }
        return;
    }
    stage_keys(keys, mask, s, len, lane, a);
    network_for<kMaxE, false>(s, len, lane, a, b, nullptr, Identity{});
    gather_payloads(pl, s, len, lane, a, b);
}

// A record row [s, s + len) (mask: its indices): the network runs only
// over the prefix [0, m) that ends with the last record (index != -1).
// The tail [m, len) holds sentinel slots, keyed +inf, after every
// prefix position: in the whole row's order they follow the prefix's keys
// up to +inf and precede its NaNs. So the sorted prefix but its n_nan
// NaNs fill slots [0, m - n_nan), the tail keeps its order in [m - n_nan,
// len - n_nan), and the NaNs end the row: the bits of a sort of the whole
// row.
template <int kMaxE>
__device__ __forceinline__ void sort_row(const float* keys, const int32_t* mask, long long s,
                                         int len, int lane, const Payloads& pl, uint32_t* a,
                                         uint32_t* b) {
    int last = -1, nans = 0;
    for (int i = lane; i < len; i += 32) {
        const int32_t id = mask[s + i];
        const float d = keys[s + i];
        a[pad(i)] = order_bits(id == -1 ? INFINITY : d);
        if (id != -1) {
            last = i;
            nans += isnan(d) ? 1 : 0;
        }
    }
    last = __reduce_max_sync(kFull, last);
    nans = __reduce_add_sync(kFull, nans);
    __syncwarp();
    const int m = last + 1;
    if (m > 0) network_for<kMaxE, false>(s, m, lane, a, b, nullptr, AroundTail{m - nans, len - m});
    for (int q = m - nans + lane; q < len - nans; q += 32) a[pad(q)] = m + (q - (m - nans));
    __syncwarp();
    gather_payloads(pl, s, len, lane, a, b);
}

// Warps a block of the kernels that sort runs of up to 32 kMaxE (their
// __launch_bounds__ too): their two staging buffers a warp fill 33.8 KB of
// shared memory a block.
template <int kMaxE>
__host__ __device__ constexpr int block_warps() { return kMaxE == 32 ? 4 : 8; }

template <int kMaxE>
__host__ __device__ constexpr int stage_words() { return 32 * kMaxE + kMaxE; }

// A warp a segment: [starts[i], starts[i + 1]) of the n_seg = *n_seg_ptr
// segments, or with starts null record row i = [i width, (i + 1) width)
// of n_rows (sort_row: mask holds its indices). The kernel sorts the
// segments of (32 kMaxE / 2, min(32 kMaxE, chunk)] elements (kMaxE 16:
// of [1, 512], 32: the rows of (512, 1024]): the registers of the longest
// run set every warp's, so the two lengths are two kernels. With
// `append`, a longer segment joins the long list (the segmented sort runs
// kMaxE 16 only: its segments past 512 take the long route, in one chunk
// up to `chunk`).
template <int kMaxE>
__global__ void __launch_bounds__(kMaxE == 32 ? 128 : 256, kMaxE == 32 ? 2 : 3)
    seg_sort_kernel(const float* __restrict__ keys, const int32_t* __restrict__ mask,
                    const int32_t* __restrict__ starts, const int32_t* __restrict__ n_seg_ptr,
                    Payloads pl, int32_t* __restrict__ long_start,
                    int32_t* __restrict__ long_len, int32_t* __restrict__ n_long, int n_rows,
                    int width, int chunk, int append) {
    constexpr int kW = block_warps<kMaxE>();
    constexpr int kLo = kMaxE == 32 ? 512 : 0;
    __shared__ uint32_t stage[kW][2][stage_words<kMaxE>()];
    const int lane = threadIdx.x % 32;
    uint32_t* a = stage[threadIdx.x / 32][0];
    uint32_t* b = stage[threadIdx.x / 32][1];
    const long long n_seg = starts ? *n_seg_ptr : n_rows;
    const long long warps = static_cast<long long>(gridDim.x) * kW;
    for (long long i = static_cast<long long>(blockIdx.x) * kW + threadIdx.x / 32; i < n_seg;
         i += warps) {
        const long long s = starts ? starts[i] : i * width;
        const int len = static_cast<int>(starts ? starts[i + 1] - s : width);
        if (len > (chunk < 32 * kMaxE ? chunk : 32 * kMaxE)) {
            if (append && lane == 0) {
                const int k = atomicAdd(n_long, 1);
                long_start[k] = static_cast<int32_t>(s);
                long_len[k] = len;
            }
            continue;
        }
        if (len <= kLo) continue;
        if (starts) sort_segment<kMaxE>(keys, mask, s, len, lane, pl, a, b);
        else sort_row<kMaxE>(keys, mask, s, len, lane, pl, a, b);
    }
}

template <int kMaxE>
int sort_blocks(long long warps) {
    const long long b = (warps + block_warps<kMaxE>() - 1) / block_warps<kMaxE>();
    return static_cast<int>(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

// Head flags: position 0, offsets[t] for t >= 1 inside (0, th) (a
// negative offset counts from the end, as offsets_to_segments reads it),
// and th itself where 0 < th < n (th = *total, or n).
__global__ void __launch_bounds__(kThreads)
    seg_heads_kernel(const int32_t* __restrict__ offsets, const int32_t* __restrict__ total,
                     unsigned char* __restrict__ head, int n_off, int n) {
    const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    const int th = total ? *total : n;
    if (t == 0) {
        head[0] = 1;
        if (th > 0 && th < n) head[th] = 1;
    }
    if (t >= 1 && t < n_off) {
        const long long o = offsets[t] < 0 ? static_cast<long long>(offsets[t]) + n : offsets[t];
        if (o > 0 && o < th) head[o] = 1;
    }
}

// A warp a tile of kTile flags: counts[w] = the heads in tile w.
__global__ void __launch_bounds__(kThreads)
    seg_count_kernel(const unsigned char* __restrict__ head, int32_t* __restrict__ counts,
                     int n, int n_tiles) {
    const long long w = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
    const int lane = threadIdx.x % 32;
    if (w >= n_tiles) return;
    int c = 0;
    for (int it = 0; it < kTile / 32; ++it) {
        const long long p = w * kTile + it * 32 + lane;
        c += __popc(__ballot_sync(kFull, p < n && head[p]));
    }
    if (lane == 0) counts[w] = c;
}

// A warp a tile: the heads' positions, ascending, at starts[incl[w - 1] ...];
// the last tile's warp writes starts[n_seg] = n.
__global__ void __launch_bounds__(kThreads)
    seg_starts_kernel(const unsigned char* __restrict__ head, const int32_t* __restrict__ incl,
                      int32_t* __restrict__ starts, int n, int n_tiles) {
    const long long w = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
    const int lane = threadIdx.x % 32;
    if (w >= n_tiles) return;
    int base = w > 0 ? incl[w - 1] : 0;
    for (int it = 0; it < kTile / 32; ++it) {
        const long long p = w * kTile + it * 32 + lane;
        const bool h = p < n && head[p];
        const unsigned vote = __ballot_sync(kFull, h);
        if (h) starts[base + __popc(vote & ((1u << lane) - 1u))] = static_cast<int32_t>(p);
        base += __popc(vote);
    }
    if (w == n_tiles - 1 && lane == 0) starts[base] = n;
}

// The long list's entry holding item k, for ends = the inclusive scan of
// its n entries' item counts (the first n of the list: the rest are empty).
__device__ __forceinline__ int entry_of(const int32_t* ends, int n, long long k) {
    int lo = 0, hi = n - 1;
    while (lo < hi) {
        const int mid = (lo + hi) / 2;
        if (ends[mid] > k) hi = mid;
        else lo = mid + 1;
    }
    return lo;
}

// A warp a chunk of a long segment: chunk c of entry i is
// [start + c chunk, start + min((c + 1) chunk, len)); its sorted keys go
// to buf at their positions.
__global__ void __launch_bounds__(128)
    seg_chunks_kernel(const float* __restrict__ keys, const int32_t* __restrict__ mask,
                      const int32_t* __restrict__ long_start, const int32_t* __restrict__ long_len,
                      const int32_t* __restrict__ chunk_end, const int32_t* __restrict__ n_long,
                      unsigned long long* __restrict__ buf, int chunk) {
    constexpr int kW = block_warps<32>();
    __shared__ uint32_t stage[kW][2][stage_words<32>()];
    const int lane = threadIdx.x % 32;
    uint32_t* a = stage[threadIdx.x / 32][0];
    uint32_t* b = stage[threadIdx.x / 32][1];
    const int n_l = *n_long;
    const long long total = n_l > 0 ? chunk_end[n_l - 1] : 0;
    const long long warps = static_cast<long long>(gridDim.x) * kW;
    for (long long g = static_cast<long long>(blockIdx.x) * kW + threadIdx.x / 32; g < total;
         g += warps) {
        const int i = entry_of(chunk_end, n_l, g);
        const int len = long_len[i];
        const long long c = g - (chunk_end[i] - (len + chunk - 1) / chunk);
        const long long s = long_start[i] + c * chunk;
        const long long rest = len - c * chunk;
        const int len_c = static_cast<int>(rest < chunk ? rest : chunk);
        stage_keys(keys, mask, s, len_c, lane, a);
        if (len_c > 512) network_for<32, true>(s, len_c, lane, a, b, buf, Identity{});
        else network_for<16, true>(s, len_c, lane, a, b, buf, Identity{});
    }
}

// The number of A's elements among the first k of the merge of the
// sorted runs A[0, na) and B[0, nb) (distinct keys), by the warp: the
// smallest i with !(A[i] < B[k - i - 1]), which is monotone in i; 32
// probes a step narrow [lo, hi] 32-fold, then one ballot counts.
__device__ __forceinline__ long long warp_co_rank(const unsigned long long* A, long long na,
                                                  const unsigned long long* B, long long nb,
                                                  long long k, int lane) {
    long long lo = k > nb ? k - nb : 0, hi = k < na ? k : na;
    while (hi - lo > 32) {
        const long long step = (hi - lo + 31) / 32;
        const long long i = lo + (lane + 1) * step - 1;
        const int c = __popc(__ballot_sync(kFull, i < hi && A[i] < B[k - i - 1]));
        const long long top = lo + (c + 1) * step - 1;
        lo += c * step;
        hi = top < hi ? top : hi;
    }
    const long long i = lo + lane;
    return lo + __popc(__ballot_sync(kFull, i < hi && A[i] < B[k - i - 1]));
}

// One merge round over the long segments that are not yet one run (len
// > width): runs of `width` (aligned to each segment's start) merged
// pairwise from `in` into `out`, a block a
// tile of kMergeTile outputs (2 width is a multiple of it, so a tile lies
// in one pair): warps 0 and 1 find the tile's co-ranks, the tile's
// elements of both runs are staged, and each goes to the tile's start +
// its index in its run's part + the other part's elements below it. The
// keys are distinct, so the place is exact and an earlier run's equal
// distance (a smaller position) stays first. tile_end is the inclusive
// scan of ceil(long_len / kMergeTile).
__global__ void __launch_bounds__(kMergeTile)
    seg_merge_kernel(const int32_t* __restrict__ long_start, const int32_t* __restrict__ long_len,
                     const int32_t* __restrict__ tile_end, const int32_t* __restrict__ n_long,
                     const unsigned long long* __restrict__ in,
                     unsigned long long* __restrict__ out, long long width) {
    __shared__ unsigned long long tile[kMergeTile];
    __shared__ long long bounds[2];
    const int t = threadIdx.x, lane = t % 32;
    const int n_l = *n_long;
    const long long total = n_l > 0 ? tile_end[n_l - 1] : 0;
    for (long long g = blockIdx.x; g < total; g += gridDim.x) {
        const int i = entry_of(tile_end, n_l, g);
        const long long len = long_len[i], s = long_start[i];
        if (len <= width) continue;   // one run already: it stays in the buffer that holds it
        const long long k0 = (g - (tile_end[i] - (len + kMergeTile - 1) / kMergeTile)) * kMergeTile;
        const long long p0 = k0 / (2 * width) * (2 * width);
        const long long na = len - p0 < width ? len - p0 : width;
        const long long rest = len - p0 - na;
        const long long nb = rest < width ? rest : width;
        const unsigned long long* A = in + s + p0;
        const unsigned long long* B = A + na;
        const long long kk0 = k0 - p0;
        const long long kk1 = kk0 + kMergeTile < na + nb ? kk0 + kMergeTile : na + nb;
        if (t < 64) {
            const long long r = warp_co_rank(A, na, B, nb, t < 32 ? kk0 : kk1, lane);
            if (lane == 0) bounds[t / 32] = r;
        }
        __syncthreads();
        const long long i0 = bounds[0];
        const int n_a = static_cast<int>(bounds[1] - i0);
        const int n_t = static_cast<int>(kk1 - kk0);
        const long long j0 = kk0 - i0;
        if (t < n_a) tile[t] = A[i0 + t];
        else if (t < n_t) tile[t] = B[j0 + t - n_a];
        __syncthreads();
        if (t < n_t) {
            const unsigned long long x = tile[t];
            const int lo = t < n_a ? n_a : 0, hi = t < n_a ? n_t : n_a;
            int l = lo, h = hi;
            while (l < h) {
                const int mid = (l + h) / 2;
                if (tile[mid] < x) l = mid + 1;
                else h = mid;
            }
            out[s + p0 + kk0 + (t < n_a ? t : t - n_a) + (l - lo)] = x;
        }
        __syncthreads();
    }
}

// The merge rounds that make a segment of len entries one run from
// chunks of `chunk`: its merged keys are in buffer rounds % 2.
__device__ __forceinline__ int rounds_for(long long len, int chunk) {
    int r = 0;
    while ((static_cast<long long>(chunk) << r) < len) ++r;
    return r;
}

// The long segments' payloads gathered by their merged keys' positions,
// each segment's keys from the buffer its last round wrote.
__global__ void __launch_bounds__(kThreads)
    seg_gather_kernel(const int32_t* __restrict__ long_start, const int32_t* __restrict__ long_len,
                      const int32_t* __restrict__ elem_end, const int32_t* __restrict__ n_long,
                      const unsigned long long* __restrict__ in0,
                      const unsigned long long* __restrict__ in1, Payloads pl, int chunk) {
    const int n_l = *n_long;
    const long long total = n_l > 0 ? elem_end[n_l - 1] : 0;
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    for (long long k = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; k < total;
         k += stride) {
        const int i = entry_of(elem_end, n_l, k);
        const long long p = long_start[i] + (k - (elem_end[i] - long_len[i]));
        const unsigned src =
            static_cast<unsigned>((rounds_for(long_len[i], chunk) % 2 ? in1 : in0)[p]);
#pragma unroll
        for (int q = 0; q < kMaxPayloads; ++q) {
            if (q < pl.n) pl.dst[q][p] = pl.src[q][src];
        }
    }
}

// A warp a row: its first counts[r] (clamped) columns to offsets[r] + col
// below the capacity, and its sentinel slot; then the tail [total,
// capacity). The offsets are an exclusive scan of counts + slots, so the
// rows, slots and tail cover each position once.
__global__ void __launch_bounds__(kThreads)
    records_flat_kernel(const int32_t* __restrict__ counts, const int32_t* __restrict__ offsets,
                        const int32_t* __restrict__ idx, const float* __restrict__ intg,
                        const float* __restrict__ dist, int32_t* __restrict__ o_idx,
                        float* __restrict__ o_intg, float* __restrict__ o_dist, int n_rows,
                        int width, long long capacity, int slots, int idx_fill, float val_fill,
                        float dist_fill) {
    const int lane = threadIdx.x % 32;
    const long long warps = static_cast<long long>(gridDim.x) * kWarps;
    for (long long r = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
         r < n_rows; r += warps) {
        const int kept = counts[r];
        const long long off = offsets[r];
        const long long row = r * width;
        for (int c = lane; c < kept && off + c < capacity; c += 32) {
            if (off + c < 0) continue;   // (counts are hit counts, >= 0: never)
            o_idx[off + c] = idx[row + c];
            o_intg[off + c] = intg[row + c];
            o_dist[off + c] = dist[row + c];
        }
        if (slots && lane == 0 && off + kept >= 0 && off + kept < capacity) {
            o_idx[off + kept] = idx_fill;
            o_intg[off + kept] = val_fill;
            o_dist[off + kept] = dist_fill;
        }
    }
    const long long total =
        n_rows > 0 ? static_cast<long long>(offsets[n_rows - 1]) + counts[n_rows - 1] + slots : 0;
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    for (long long q = (total > 0 ? total : 0) + static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
         q < capacity; q += stride) {
        o_idx[q] = idx_fill;
        o_intg[q] = val_fill;
        o_dist[q] = dist_fill;
    }
}

bool load_payloads(Payloads& pl, const unsigned long long* host_ptrs, int n) {
    if (n < 1 || n > kMaxPayloads || !host_ptrs) return false;
    pl = Payloads{};
    pl.n = n;
    for (int k = 0; k < n; ++k) {
        pl.src[k] = reinterpret_cast<const uint32_t*>(host_ptrs[k]);
        pl.dst[k] = reinterpret_cast<uint32_t*>(host_ptrs[n + k]);
        if (!pl.src[k] || !pl.dst[k]) return false;
    }
    return true;
}

float as_float(int bits) {
    float f;
    std::memcpy(&f, &bits, sizeof(f));
    return f;
}

bool valid_chunk(int chunk) {
    return chunk >= kMinChunk && chunk <= kMaxChunk && (chunk & (chunk - 1)) == 0;
}

}  // namespace

// E8: each row of distances f32[n_rows, width] sorted (a sentinel slot,
// indices -1, keyed +inf), its indices i32, integrals and distances f32
// gathered into o_idx, o_intg, o_dist (all [n_rows, width]); width <=
// kMaxChunk, n_rows width < 2^31.
extern "C" int grace_sort_rows(const float* dist, const int32_t* idx, const float* intg,
                               int32_t* o_idx, float* o_intg, float* o_dist, int n_rows,
                               int width, int device, void* stream) {
    if (n_rows < 0 || width < 1 || width > kMaxChunk ||
        static_cast<long long>(n_rows) * width >= (1LL << 31) ||
        (n_rows > 0 && (!dist || !idx || !intg || !o_idx || !o_intg || !o_dist))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_rows == 0) return static_cast<int>(cudaGetLastError());
    Payloads pl{};
    pl.n = 3;
    pl.src[0] = reinterpret_cast<const uint32_t*>(idx);
    pl.src[1] = reinterpret_cast<const uint32_t*>(intg);
    pl.src[2] = reinterpret_cast<const uint32_t*>(dist);
    pl.dst[0] = reinterpret_cast<uint32_t*>(o_idx);
    pl.dst[1] = reinterpret_cast<uint32_t*>(o_intg);
    pl.dst[2] = reinterpret_cast<uint32_t*>(o_dist);
    if (width <= 512) {
        seg_sort_kernel<16><<<sort_blocks<16>(n_rows), 32 * block_warps<16>(), 0,
                              static_cast<cudaStream_t>(stream)>>>(
            dist, idx, nullptr, nullptr, pl, nullptr, nullptr, nullptr, n_rows, width, kMaxChunk,
            0);
    } else {
        seg_sort_kernel<32><<<sort_blocks<32>(n_rows), 32 * block_warps<32>(), 0,
                              static_cast<cudaStream_t>(stream)>>>(
            dist, idx, nullptr, nullptr, pl, nullptr, nullptr, nullptr, n_rows, width, kMaxChunk,
            0);
    }
    return static_cast<int>(cudaGetLastError());
}

// E9's head flags u8[n] (zeroed by the caller) from offsets i32[n_off]
// (offsets[0] ignored) and, where total is not null, the i32 at total
// (clamped to [0, n] by the caller).
extern "C" int grace_seg_heads(const int32_t* offsets, const int32_t* total, unsigned char* head,
                               int n_off, int n, int device, void* stream) {
    if (n_off < 0 || n < 1 || !head || (n_off > 1 && !offsets)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long threads = n_off > 1 ? n_off : 1;
    seg_heads_kernel<<<static_cast<int>((threads + kThreads - 1) / kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(offsets, total, head, n_off, n);
    return static_cast<int>(cudaGetLastError());
}

// The heads in each tile of kTile flags: counts i32[ceil(n / kTile)].
extern "C" int grace_seg_count(const unsigned char* head, int32_t* counts, int n, int device,
                               void* stream) {
    if (n < 1 || !head || !counts) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_tiles = (n + kTile - 1) / kTile;
    seg_count_kernel<<<(n_tiles + kWarps - 1) / kWarps, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(head, counts, n, n_tiles);
    return static_cast<int>(cudaGetLastError());
}

// The segment starts i32[n_seg + 1] (starts[n_seg] = n) from the head
// flags and incl, the inclusive scan of grace_seg_count's counts.
extern "C" int grace_seg_starts(const unsigned char* head, const int32_t* incl, int32_t* starts,
                                int n, int device, void* stream) {
    if (n < 1 || !head || !incl || !starts) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_tiles = (n + kTile - 1) / kTile;
    seg_starts_kernel<<<(n_tiles + kWarps - 1) / kWarps, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(head, incl, starts, n, n_tiles);
    return static_cast<int>(cudaGetLastError());
}

// E9's sort: the *n_seg segments of starts (at most max_segs) sorted by
// keys f32 (with mask, a sentinel index keys +inf), each of the n_payloads
// arrays (host_ptrs: n_payloads source then n_payloads destination
// addresses, 4-byte elements) gathered; a segment longer than min(chunk,
// kWarpRun) is appended to (long_start, long_len) at the counter n_long
// instead.
extern "C" int grace_segmented_sort(const float* keys, const int32_t* mask, const int32_t* starts,
                                    const int32_t* n_seg, const unsigned long long* host_ptrs,
                                    int32_t* long_start, int32_t* long_len, int32_t* n_long,
                                    int n_payloads, int max_segs, int chunk, int device,
                                    void* stream) {
    Payloads pl{};
    if (max_segs < 0 || !valid_chunk(chunk) || !load_payloads(pl, host_ptrs, n_payloads) ||
        (max_segs > 0 && (!keys || !starts || !n_seg || !long_start || !long_len || !n_long))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (max_segs == 0) return static_cast<int>(cudaGetLastError());
    static_assert(kWarpRun == 32 * 16, "the segmented sort's warps are seg_sort_kernel<16>'s");
    seg_sort_kernel<16><<<sort_blocks<16>(max_segs), 32 * block_warps<16>(), 0,
                          static_cast<cudaStream_t>(stream)>>>(
        keys, mask, starts, n_seg, pl, long_start, long_len, n_long, 0, 0, chunk, 1);
    return static_cast<int>(cudaGetLastError());
}

// The long segments' chunks sorted into buf u64[n]: the first *n_long
// entries of (long_start, long_len) are the long segments, chunk_end the
// inclusive scan of ceil(long_len / chunk); n_max bounds *n_long (the
// grid's size).
extern "C" int grace_seg_chunks(const float* keys, const int32_t* mask, const int32_t* long_start,
                                const int32_t* long_len, const int32_t* chunk_end,
                                const int32_t* n_long, unsigned long long* buf, int n_max,
                                int chunk, int n, int device, void* stream) {
    if (n_max < 1 || n < 1 || !valid_chunk(chunk) || !keys || !long_start || !long_len ||
        !chunk_end || !n_long || !buf) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long most = (static_cast<long long>(n) + chunk - 1) / chunk + n_max;
    const int grid = sort_blocks<32>(most) < kLongBlocks ? sort_blocks<32>(most) : kLongBlocks;
    seg_chunks_kernel<<<grid, 32 * block_warps<32>(), 0, static_cast<cudaStream_t>(stream)>>>(
        keys, mask, long_start, long_len, chunk_end, n_long, buf, chunk);
    return static_cast<int>(cudaGetLastError());
}

// One merge round: runs of `width` (a multiple of kMergeTile / 2) merged
// pairwise from in into out (both u64[n]); tile_end is the inclusive scan
// of ceil(long_len / kMergeTile) over the first *n_long entries.
extern "C" int grace_seg_merge(const int32_t* long_start, const int32_t* long_len,
                               const int32_t* tile_end, const int32_t* n_long,
                               const unsigned long long* in, unsigned long long* out, int n_max,
                               int width, int n, int device, void* stream) {
    if (n_max < 1 || n < 1 || width < kMergeTile / 2 || width % (kMergeTile / 2) ||
        !long_start || !long_len || !tile_end || !n_long || !in || !out || in == out) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long tiles = (static_cast<long long>(n) + kMergeTile - 1) / kMergeTile + n_max;
    const int grid = static_cast<int>(tiles < kMaxBlocks ? tiles : kMaxBlocks);
    seg_merge_kernel<<<grid, kMergeTile, 0, static_cast<cudaStream_t>(stream)>>>(
        long_start, long_len, tile_end, n_long, in, out, width);
    return static_cast<int>(cudaGetLastError());
}

// The long segments' payloads (host_ptrs as grace_segmented_sort's)
// gathered by the merged keys: a segment of len entries in in0 or in1
// (u64[n]) as its rounds from chunks of `chunk` end; elem_end is the
// inclusive scan of long_len over the first *n_long entries.
extern "C" int grace_seg_gather(const int32_t* long_start, const int32_t* long_len,
                                const int32_t* elem_end, const int32_t* n_long,
                                const unsigned long long* in0, const unsigned long long* in1,
                                const unsigned long long* host_ptrs, int n_max, int n_payloads,
                                int chunk, int n, int device, void* stream) {
    Payloads pl{};
    if (n_max < 1 || n < 1 || !valid_chunk(chunk) || !long_start || !long_len || !elem_end ||
        !n_long || !in0 || !in1 || !load_payloads(pl, host_ptrs, n_payloads)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    seg_gather_kernel<<<blocks_for(n) < kLongBlocks ? blocks_for(n) : kLongBlocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        long_start, long_len, elem_end, n_long, in0, in1, pl, chunk);
    return static_cast<int>(cudaGetLastError());
}

// E10: rows (idx i32, intg, dist f32 [n_rows, width]) into the flat
// buffers o_* [capacity] at offsets i32[n_rows], counts i32[n_rows]
// (clamped to width) a row; slots: one sentinel slot after each row. The
// offsets are the exclusive scan of counts + slots (n_rows (width + slots)
// < 2^31). The fills are i32 and f32 bit patterns.
extern "C" int grace_records_to_flat(const int32_t* counts, const int32_t* offsets,
                                     const int32_t* idx, const float* intg, const float* dist,
                                     int32_t* o_idx, float* o_intg, float* o_dist, int n_rows,
                                     int width, int capacity, int slots, int idx_fill,
                                     int val_bits, int dist_bits, int device, void* stream) {
    if (n_rows < 0 || width < 0 || capacity < 0 || (slots != 0 && slots != 1) ||
        static_cast<long long>(n_rows) * (width + slots) >= (1LL << 31) ||
        (n_rows > 0 && (!counts || !offsets || (width > 0 && (!idx || !intg || !dist)))) ||
        (capacity > 0 && (!o_idx || !o_intg || !o_dist))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (capacity == 0) return static_cast<int>(cudaGetLastError());
    const long long threads = 32LL * n_rows > capacity ? 32LL * n_rows : capacity;
    records_flat_kernel<<<blocks_for(threads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        counts, offsets, idx, intg, dist, o_idx, o_intg, o_dist, n_rows, width, capacity, slots,
        idx_fill, as_float(val_bits), as_float(dist_bits));
    return static_cast<int>(cudaGetLastError());
}
