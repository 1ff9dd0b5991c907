// The per-hit records' post-processing on the card: the record rows' sort
// by distance (E8), the CSR sort by distance (E9) and the flat layout (E10).
//
// Not TPU kernels: grace_tpu runs these as plain XLA after its Pallas
// record kernels. They replace grace_tpu/trace/pallas_records.py:729
// (sort_records_by_distance: one lane-axis lax.sort of the rows),
// grace_tpu/ops/segops.py:70 (sort_by_distance, with offsets_to_segments
// :24 and segmented_sort :57: a lexicographic lax.sort on (segment, key))
// and grace_tpu/trace/pallas_records.py:741 (records_to_flat: a scatter of
// the rows into the flat buffers). In the CUDA original this is the
// segmented sort over per-ray hit lists (sort_by_distance over the
// vendored sgpu segmented sort, cuda/sort.cuh:100-131).
//
// The order is grace_tpu's, lax.sort with one key, stable: -0 ties with
// +0 and so does every subnormal (XLA compares with subnormals flushed),
// every NaN ties with every other NaN and sorts after +inf, ties keep
// their input order. order_bits maps each f32 key to a u32 in that order
// (NaN -> 0x7FC00000, -0 and subnormals -> +0, then all bits flipped for
// a negative and the sign bit set for the rest); ties stay ties, and every
// sort here is stable on those u32 keys. The record rows key a sentinel
// slot (index -1) to +inf, so a real +inf ties with it by column.
//
// What bounds them: at the limit, memory. E8 and E9 read each key once
// and each payload once and write each payload once (24 B a record slot
// for the rows, 24 B an entry for a flat layout of three arrays); E10
// reads each kept record (12 B) and writes every position of the three
// buffers (12 B). The first sort kernels (a bitonic network of u64 keys,
// order bits << 32 | position, at E of 1 to 16 a lane) were bound by the
// network's instructions: 80 registers, u64 compare-exchanges and two
// shuffles an element a step; and on path 4 by merge rounds over a
// 3.4M-entry segment of equal sentinel keys that was in order already. A
// stable warp merge sort of u32 keys did no better (its serial merge steps
// and searches cost as much as the network). What this design does:
//
// The sort (sort_keys_for, network_sort): a warp sorts a run of m keys of
// up to 512 (1,024 in the kernels that take longer runs). A run whose
// keys are non-decreasing (read once, striped) is already in its stable
// order and is only copied. Else every element becomes a distinct value
// whose order is the stable order: where the keys' span (max - min) and
// the positions fit in 32 bits together, the u32 (key - min) << bits |
// position (path 4's unsorted rows span at most 2^23 with 9 bits of
// position: every one); else the u64 key << 32 | position. A bitonic network sorts those
// in registers, lane l holding elements l E ... l E + E - 1 (E = 16; 32
// past 512; E = 4 for the u64 network's runs of up to 128), with every
// comparator ascending (each merge phase first compares an element with
// its mirror): a compare-exchange inside a lane is a min and a max, one
// across lanes a shuffle and a min or max. The position comes out of the
// low bits. One u32 network size a kernel: smaller ones for the shorter
// runs gained nothing on path 4 (chip_ablation.py segsort).
//
// sort_kernel (E8 grace_sort_rows, E9 grace_segmented_sort): persistent
// warps walk the runs (record rows of `width`, or the segments of
// `starts`: two instances, so neither carries the other's branches);
// while a warp sorts run i it has the next one's arrays in flight into
// its second shared-memory buffer (cp.async: 16-byte copies for the body,
// whose start is aligned by placing element q of a run at word (address /
// 4 + q) % 4 + q of its buffer, 4-byte copies for the ragged ends). The
// arrays staged are the keys, the mask and every payload source, each
// once (E9's distances are its keys and a payload; E8's indices its
// mask). Its run sorted, the warp writes every payload from the stage in
// one pass, 16 bytes a lane between the run's ragged ends. A record row
// sorts only the prefix that ends with its last record (sort_run: the
// tail of sentinel slots keeps its place, the prefix's NaNs move past it:
// a whole-row sort's bits); a segment longer than min(chunk, kWarpRun)
// joins the long list.
//
// The long route (E9, and E8's rows past 1,024): grace_seg_long_scan
// scans the long list (one block), grace_seg_check flags each long
// segment whose keys are not non-decreasing (any adjacent pair, chunk
// boundaries included); such a segment's chunks are sorted by warps
// (grace_seg_chunks; a chunk in order is only copied) into u32 keys and
// i32 positions, merged pairwise until it is one run (grace_seg_merge:
// merge path, a block a tile of 256 outputs, co-ranks by a warp's 32-way
// search, the left run first on ties) and its payloads gathered from the
// buffer its last round wrote (grace_seg_gather). A segment in order
// skips the chunks and the merges and is copied by the gather: path 4's
// trailing pseudo-segment of capacity padding, 3.4M equal sentinel keys,
// costs one read of its keys and one copy of its payloads; the merge
// rounds' launches end at once.
//
// E9's segments come from head bits (grace_seg_heads: offsets[1:] inside
// [1, min(H, total_hits)), a negative one counted from the end, and
// total_hits itself open a segment; repeated and unordered starts each
// open one boundary, as offsets_to_segments's marks and cumsum), then
// grace_seg_count (a warp a tile of kTile positions, a word a lane),
// torch.cumsum and grace_seg_starts (each lane its word's set bits).
//
// records_to_flat (E10, grace_records_to_flat), one launch after a memset
// of its state: the offsets' scan and the copy. Persistent blocks of 16
// warps take tickets in order; a ticket is a range of 128 rows (on path
// 4 0.555 ms against 0.58 for 256 rows in blocks of 8 warps: chip_ablation.py
// records_flat), whose counts a thread a row clamps and scans, and whose
// prefix warp 0 takes from the
// ranges before by a decoupled look-back (each range publishes its own
// sum at once and its inclusive sum after its look-back, flag and sum in
// one 64-bit word); the scan is u32, the low bits of the plain version's
// int64 cumsum, which its cast to int32 keeps. A warp copies a row: where
// the width is a multiple of 4 (path 4's 512) every lane loads its share
// of the row's records as 16-byte vectors, all before any store (a row of
// 512 at once: 4 vectors an array a lane, 12 loads in flight). The
// destination offsets + col starts at any word, so the body goes out as
// aligned 16-byte vectors, each made in registers from two lanes' loaded
// vectors (a shuffle and a select on offsets % 4), and the ragged head and
// tail (3 words at most each) as 4-byte stores. TMA's bulk copies do not
// fit: both ends of one must be 16-byte aligned, and the destination is
// not. Other widths copy 4 bytes a column. Tickets past the ranges fill
// the tail [total, capacity) in chunks of 8,192, 16 bytes a store. Every
// position is written once: the records, each sentinel slot (by lane 0 of
// the row's warp), the tail.

#include <cstdint>

#include "async_copy.cuh"
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 1024;       // segops.SEG_CHUNK: the longest run a warp sorts
constexpr int kTile = 1024;           // segops.HEAD_TILE: positions (head bits) a warp counts,
                                      // a u32 word a lane
constexpr int kMaxPayloads = 8;       // segops.MAX_PAYLOADS: arrays one launch gathers
constexpr int kMaxStaged = kMaxPayloads + 2;   // with the keys and the mask
constexpr int kLongBlocksPerSm = 8;   // the long route's grid-stride grids (they end at
                                      // once where no segment is long and out of order)
constexpr int kScanThreads = 1024;    // the long list's scan: one block
constexpr int kMergeTile = 256;       // segops.MERGE_TILE: outputs a merge block takes at a time
constexpr int kMinChunk = 128;        // chunks of at least half a merge tile
constexpr int kWarpRun = 512;         // segops.WARP_RUN: the segmented sort's longest warp run
constexpr int kSortSmem = 112 * 1024; // a sort block's shared memory at most: two blocks an SM
constexpr int kSortWarps = 7;         // a sort block's warps at most (146 registers a thread)
constexpr int kChunkWarps = 4;        // warps a block of grace_seg_chunks
constexpr int kFlatThreads = 512;     // an E10 block: a range of up to 512 rows (128 from
                                      // the wrapper), a thread a row's count, a warp a
                                      // row's copy
constexpr int kFlatWarps = kFlatThreads / 32;
constexpr int kFlatVecs = 4;          // 16-byte vectors a lane loads of each array a row chunk
constexpr int kFlatChunk = 4 * 32 * kFlatVecs;   // a row chunk's columns: 512
constexpr int kTailChunk = 4 * 4 * kFlatThreads; // E10's tail positions a ticket: 8,192
constexpr int kMaxDevices = 64;       // E10's resident blocks kept for devices below this
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kPadKey = 0xffffffffu;   // above every order key (a NaN's is 0xffc00000)

// E9's and E8's sort arguments: the arrays a warp stages (slot 0 the keys,
// then the mask, then each payload source that is neither; each once) with
// their addresses' word offset mod 4, and each payload's source, slot and
// destination. (The kernels take them as __grid_constant__ and index
// every array by an unrolled constant, so they stay in the parameter
// bank: no local copy.)
struct SortArgs {
    const uint32_t* stage[kMaxStaged];
    int align[kMaxStaged];
    const uint32_t* src[kMaxPayloads];
    uint32_t* dst[kMaxPayloads];
    int slot[kMaxPayloads];
    int palign[kMaxPayloads];
    int n_stage, n_payloads, mask_slot, mask_align;
};

// The order-preserving u32 of a key, as lax.sort orders f32: -0 with +0
// and every subnormal with them (XLA compares with subnormals flushed),
// every NaN after +inf.
__device__ __forceinline__ unsigned order_bits(float key) {
    const unsigned b = __float_as_uint(key);
    const unsigned u = isnan(key) ? 0x7fc00000u : ((b & 0x7f800000u) == 0u ? 0u : b);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The scratch index of run element i: one pad word every 32, so the
// blocked accesses (lane E + e) and the coalesced ones (lane + 32 c) both
// fall on 32 banks.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// Scratch words of a warp sorting runs of up to W: pad(W - 1) + 1.
__host__ __device__ constexpr int scratch_words(int W) { return W + W / 32; }

// The bitonic network over the warp's 32 E distinct values (u32 or u64),
// element i = lane E + e in v[e], with every comparator ascending: merge
// phase K (2, 4, ..., 32 E) first compares i with its mirror i ^ (K - 1),
// then i with i ^ J for J = K / 4, ..., 1, the smaller value to the
// smaller index. Inside a lane (i ^ j below E) a comparator orders two
// registers; across lanes each lane takes its partner's value by a
// shuffle (the mirror of register e is register E - 1 - e) and keeps the
// lesser or the greater as its side of the pair. (With a direction bit a
// comparator inside a lane took two more selects; u32 min and max run at
// half rate.)
__device__ __forceinline__ void order_pair(unsigned& a, unsigned& b) {
    const unsigned lo = min(a, b);
    b = max(a, b);
    a = lo;
}

__device__ __forceinline__ void order_pair(unsigned long long& a, unsigned long long& b) {
    const bool swap = b < a;
    const unsigned long long x = a;
    a = swap ? b : a;
    b = swap ? x : b;
}

__device__ __forceinline__ unsigned keep_side(unsigned v, unsigned w, bool low) {
    return low ? min(v, w) : max(v, w);
}

__device__ __forceinline__ unsigned long long keep_side(unsigned long long v,
                                                        unsigned long long w, bool low) {
    return (w < v) == low ? w : v;
}

template <int E, int J, typename T>
__device__ __forceinline__ void half_clean(T (&v)[E], int lane) {
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

template <int E, int K = 2, typename T>
__device__ __forceinline__ void warp_bitonic(T (&v)[E], int lane) {
    if constexpr (K <= E) {   // the mirror inside the lane
#pragma unroll
        for (int e = 0; e < E; ++e) {
            if ((e & (K / 2)) == 0) order_pair(v[e], v[e ^ (K - 1)]);
        }
    } else {                  // the mirror in lane ^ (K / E - 1), register E - 1 - e
        const bool low = (lane & (K / E / 2)) == 0;
#pragma unroll
        for (int e = 0; e < (E + 1) / 2; ++e) {   // a pair of registers at a time
            const T a = __shfl_xor_sync(kFull, v[E - 1 - e], K / E - 1);
            const T b = __shfl_xor_sync(kFull, v[e], K / E - 1);
            v[e] = keep_side(v[e], a, low);
            if (E - 1 - e != e) v[E - 1 - e] = keep_side(v[E - 1 - e], b, low);
        }
    }
    if constexpr (K >= 4) half_clean<E, K / 4>(v, lane);
    if constexpr (K < 32 * E) warp_bitonic<E, K * 2>(v, lane);
}

// Whether a run's m order keys in ks (padded) are in order, read striped;
// and their min and max.
__device__ __forceinline__ bool keys_in_order(int m, int lane, const unsigned* ks, unsigned& lo,
                                              unsigned& hi) {
    bool in_order = true;
    lo = kPadKey;
    hi = 0;
    for (int i = lane; i < m; i += 32) {
        const unsigned k = ks[pad(i)];
        lo = min(lo, k);
        hi = max(hi, k);
        in_order = in_order && (i + 1 >= m || k <= ks[pad(i + 1)]);
    }
    lo = __reduce_min_sync(kFull, lo);
    hi = __reduce_max_sync(kFull, hi);
    return __all_sync(kFull, in_order);
}

// The m order keys in ks sorted by the network on packed values, E a
// lane: T = u32 packs (key - lo) << bits | position (where the span and
// the positions fit in 32 bits), u64 key << 32 | position; either is
// distinct and in the stable order (pads ~0 last). Sorted element i's run
// index goes to vs[place(i)], place(i) = i below keep and i + shift from
// it (a record row's NaNs past its tail); with kKeys its key to
// ks[place(i)] as well.
template <int E, typename T, bool kKeys>
__device__ __forceinline__ void network_sort(int m, int keep, int shift, int lane, unsigned* ks,
                                             uint16_t* vs, unsigned lo, int bits) {
    constexpr bool kWide = sizeof(T) == 8;
    T p[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const unsigned i = static_cast<unsigned>(lane * E + e);
        const T k = i < static_cast<unsigned>(m) ? ks[pad(i)] : 0u;
        if constexpr (kWide) p[e] = k << 32 | i;
        else p[e] = (k - lo) << bits | i;
        p[e] = i < static_cast<unsigned>(m) ? p[e] : ~T(0);
    }
    __syncwarp();
    warp_bitonic<E>(p, lane);
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const int i = lane * E + e;
        if (i >= m) continue;
        const int q = i < keep ? i : i + shift;
        unsigned key, pos;
        if constexpr (kWide) {
            key = static_cast<unsigned>(p[e] >> 32);
            pos = static_cast<unsigned>(p[e]);
        } else {
            key = lo + (p[e] >> bits);
            pos = p[e] & ((1u << bits) - 1u);
        }
        vs[pad(q)] = static_cast<uint16_t>(pos);
        if constexpr (kKeys) ks[pad(q)] = key;
    }
    __syncwarp();
}

// The first m keys of a run (order keys in ks, padded) sorted stably into
// vs (and with kKeys ks), as network_sort places them. A run in order is
// not sorted. Else the u32 network, E = 16 (32 for the runs past 512
// where kMaxE is 32), where the keys' span (max - min) and the positions
// fit in 32 bits together; else (NaNs or infinities among finite keys, a
// span past 2^22) the u64 network, at twice the registers and
// instructions, E = 4 for the runs of up to 128. One u32 network size a
// kernel (see the note at the top).
template <int kMaxE, bool kKeys>
__device__ __forceinline__ void sort_keys_for(int m, int keep, int shift, int lane, unsigned* ks,
                                              uint16_t* vs) {
    unsigned lo, hi;
    if (keys_in_order(m, lane, ks, lo, hi)) {   // (keys stay where they are)
        for (int i = lane; i < m; i += 32) {
            vs[pad(i < keep ? i : i + shift)] = static_cast<uint16_t>(i);
        }
        __syncwarp();
        return;
    }
    const int bits = 32 - __clz(m - 1);   // m >= 2: a run of one is in order
    const bool narrow = m <= 512 || kMaxE == 16;
    if (hi - lo <= (kPadKey >> bits)) {
        if (narrow) {
            network_sort<16, unsigned, kKeys>(m, keep, shift, lane, ks, vs, lo, bits);
        } else if constexpr (kMaxE == 32) {
            network_sort<32, unsigned, kKeys>(m, keep, shift, lane, ks, vs, lo, bits);
        }
    } else if (m <= 128) {
        network_sort<4, unsigned long long, kKeys>(m, keep, shift, lane, ks, vs, lo, bits);
    } else if (narrow) {
        network_sort<16, unsigned long long, kKeys>(m, keep, shift, lane, ks, vs, lo, bits);
    } else if constexpr (kMaxE == 32) {
        network_sort<32, unsigned long long, kKeys>(m, keep, shift, lane, ks, vs, lo, bits);
    }
}

// A sort warp's shared memory for runs of up to W and n staged arrays:
// two stage buffers of n arrays of W + 4 words, the keys' scratch and the
// run indices' scratch (u16), a multiple of 16 bytes.
__host__ __device__ constexpr int stage_words(int W) { return W + 4; }

__host__ __device__ constexpr int warp_bytes(int W, int n) {
    return (4 * (2 * n * stage_words(W) + scratch_words(W)) + 2 * scratch_words(W) + 15) / 16 *
           16;
}

// The run [s, s + len) of every staged array into buf, asynchronously:
// element q of array j at word (align_j + s) % 4 + q of its W + 4, so the
// 16-byte copies of the body line up on both sides; 4-byte copies for the
// ragged ends. The caller commits.
template <int W>
__device__ __forceinline__ void stage_run(const SortArgs& a, long long s, int len, uint32_t* buf,
                                          int lane) {
#pragma unroll
    for (int j = 0; j < kMaxStaged; ++j) {
        if (j >= a.n_stage) break;
        const int off = (a.align[j] + static_cast<int>(s & 3)) & 3;
        const uint32_t* src = a.stage[j] + s;
        uint32_t* dst = buf + j * stage_words(W) + off;
        const int head = min(len, (4 - off) & 3);
        const int body = head + ((len - head) & ~3);
        for (int q = lane; q < head; q += 32) cp_async4(dst + q, src + q);
        for (int q = head + 4 * lane; q < body; q += 128) cp_async16(dst + q, src + q);
        for (int q = body + lane; q < len; q += 32) cp_async4(dst + q, src + q);
    }
}

// A staged run [s, s + len) sorted: the keys' order bits to ks (a mask of
// -1 keys +inf), then vs[q] = the run index that slot q takes. A record
// row (kRows: the mask holds its indices) sorts only its prefix [0, m)
// that ends with its last record; the tail [m, len) holds sentinel slots,
// keyed +inf, after every prefix position: in the whole row's order they
// follow the prefix's keys up to +inf and precede its NaNs. So the sorted
// prefix but its NaNs fill slots [0, m - nans), the tail keeps its order
// in [m - nans, len - nans), and the NaNs end the row: the bits of a sort
// of the whole row.
template <int kMaxE, bool kRows>
__device__ __forceinline__ void sort_run(const SortArgs& a, const uint32_t* buf, long long s,
                                         int len, int lane, unsigned* ks, uint16_t* vs) {
    constexpr int W = 32 * kMaxE;
    const uint32_t* key = buf + ((a.align[0] + static_cast<int>(s & 3)) & 3);
    const uint32_t* mask = a.mask_slot < 0
                               ? nullptr
                               : buf + a.mask_slot * stage_words(W) +
                                     ((a.mask_align + static_cast<int>(s & 3)) & 3);
    int m = len, nans = 0;
    if constexpr (kRows) {
        int last = -1;
        for (int i = lane; i < len; i += 32) {
            const bool rec = static_cast<int32_t>(mask[i]) != -1;
            const float d = __uint_as_float(key[i]);
            ks[pad(i)] = order_bits(rec ? d : INFINITY);
            if (rec) {
                last = i;
                nans += isnan(d) ? 1 : 0;
            }
        }
        m = __reduce_max_sync(kFull, last) + 1;
        nans = __reduce_add_sync(kFull, nans);
    } else {
        for (int i = lane; i < len; i += 32) {
            const bool sentinel = mask && static_cast<int32_t>(mask[i]) == -1;
            ks[pad(i)] = order_bits(sentinel ? INFINITY : __uint_as_float(key[i]));
        }
    }
    __syncwarp();
    const int keep = m - nans;
    if (m > 0) sort_keys_for<kMaxE, false>(m, keep, len - m, lane, ks, vs);
    for (int q = keep + lane; q < len - nans; q += 32) {
        vs[pad(q)] = static_cast<uint16_t>(m + q - keep);
    }
    __syncwarp();
}

// Every payload of the run [s, s + len) written from the stage in the
// order of vs: slot q takes staged element vs[q]. The destinations are
// 16-byte aligned (make_sort_args checks), so a lane writes four slots
// with one 16-byte store between the run's ragged ends (at most three
// slots each, 4-byte stores).
template <int W>
__device__ __forceinline__ void write_payloads(const SortArgs& a, const uint32_t* buf, long long s,
                                               int len, int lane, const uint16_t* vs) {
    const int head = min(len, static_cast<int>((4 - (s & 3)) & 3));
    const int body = head + ((len - head) & ~3);
    if (lane < head + len - body) {   // the ragged ends
        const int q = lane < head ? lane : body + lane - head;
        const int src = vs[pad(q)];
#pragma unroll
        for (int k = 0; k < kMaxPayloads; ++k) {
            if (k >= a.n_payloads) break;
            const int off = (a.palign[k] + static_cast<int>(s & 3)) & 3;
            a.dst[k][s + q] = buf[a.slot[k] * stage_words(W) + off + src];
        }
    }
    for (int q = head + 4 * lane; q < body; q += 128) {
        const int s0 = vs[pad(q)], s1 = vs[pad(q + 1)], s2 = vs[pad(q + 2)], s3 = vs[pad(q + 3)];
#pragma unroll
        for (int k = 0; k < kMaxPayloads; ++k) {
            if (k >= a.n_payloads) break;
            const uint32_t* st = buf + a.slot[k] * stage_words(W) +
                                 ((a.palign[k] + static_cast<int>(s & 3)) & 3);
            *reinterpret_cast<uint4*>(a.dst[k] + s + q) =
                make_uint4(st[s0], st[s1], st[s2], st[s3]);
        }
    }
}

// Persistent warps over the runs: with kRows record row i = [i width,
// (i + 1) width) of n_rows, else segment i = [starts[i], starts[i + 1]) of
// n_seg = *n_seg_ptr. A run of more than `cap` elements (segments only)
// joins the long list; the others are staged one run ahead (cp.async into
// the warp's other buffer), sorted and written.
template <int kMaxE, bool kRows>
__global__ void __launch_bounds__(32 * kSortWarps, kMaxE == 32 ? 1 : 2)
    sort_kernel(const __grid_constant__ SortArgs a, const int32_t* __restrict__ starts,
                const int32_t* __restrict__ n_seg_ptr, int32_t* __restrict__ long_start,
                int32_t* __restrict__ long_len, int32_t* __restrict__ n_long, int n_rows,
                int width, int cap) {
    constexpr int W = 32 * kMaxE;
    extern __shared__ __align__(16) unsigned char smem[];
    const int lane = threadIdx.x % 32;
    const int warps = blockDim.x / 32;
    unsigned char* mine = smem + (threadIdx.x / 32) * warp_bytes(W, a.n_stage);
    uint32_t* stage = reinterpret_cast<uint32_t*>(mine);
    const int buf_words = a.n_stage * stage_words(W);
    unsigned* ks = stage + 2 * buf_words;
    uint16_t* vs = reinterpret_cast<uint16_t*>(ks + scratch_words(W));
    const long long n_run = kRows ? n_rows : *n_seg_ptr;
    const long long step = static_cast<long long>(gridDim.x) * warps;
    long long i = static_cast<long long>(blockIdx.x) * warps + threadIdx.x / 32;
    long long s = 0;
    int len = 0;
    auto extent = [&](long long r) {
        s = kRows ? r * width : starts[r];
        len = static_cast<int>(kRows ? width : starts[r + 1] - s);
    };
    if (i < n_run) {
        extent(i);
        if (len <= cap) stage_run<W>(a, s, len, stage, lane);
    }
    cp_async_commit();
    for (int b = 0; i < n_run; i += step, b ^= 1) {
        const long long s_i = s;
        const int len_i = len;
        cp_async_wait<0>();
        __syncwarp();   // run i staged; the last run's reads of the other buffer done
        if (i + step < n_run) {
            extent(i + step);
            if (len <= cap) stage_run<W>(a, s, len, stage + (b ^ 1) * buf_words, lane);
        }
        cp_async_commit();
        if (len_i > cap) {
            if (lane == 0) {
                const int k = atomicAdd(n_long, 1);
                long_start[k] = static_cast<int32_t>(s_i);
                long_len[k] = len_i;
            }
            continue;
        }
        if (len_i == 0) continue;
        const uint32_t* buf = stage + b * buf_words;
        sort_run<kMaxE, kRows>(a, buf, s_i, len_i, lane, ks, vs);
        write_payloads<W>(a, buf, s_i, len_i, lane, vs);
    }
    cp_async_wait<0>();
}

// Head bits (u32 words, bit p % 32 of word p / 32): position 0,
// offsets[t] for t >= 1 inside (0, th) (a negative offset counts from the
// end, as offsets_to_segments reads it), and th itself where 0 < th < n
// (th = *total, or n).
__global__ void __launch_bounds__(kThreads)
    seg_heads_kernel(const int32_t* __restrict__ offsets, const int32_t* __restrict__ total,
                     unsigned* __restrict__ head, int n_off, int n) {
    const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    const int th = total ? *total : n;
    if (t == 0) {
        atomicOr(&head[0], 1u);
        if (th > 0 && th < n) atomicOr(&head[th >> 5], 1u << (th & 31));
    }
    if (t >= 1 && t < n_off) {
        const long long o = offsets[t] < 0 ? static_cast<long long>(offsets[t]) + n : offsets[t];
        if (o > 0 && o < th) atomicOr(&head[o >> 5], 1u << (o & 31));
    }
}

// A warp a tile of kTile positions, a word a lane: counts[w] = the heads
// in tile w.
static_assert(kTile == 32 * 32, "a head tile is a warp's 32 words");
__global__ void __launch_bounds__(kThreads)
    seg_count_kernel(const unsigned* __restrict__ head, int32_t* __restrict__ counts,
                     int n_words, int n_tiles) {
    const long long w = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
    const int lane = threadIdx.x % 32;
    if (w >= n_tiles) return;
    const long long word = w * 32 + lane;
    const int c = __reduce_add_sync(kFull, word < n_words ? __popc(head[word]) : 0);
    if (lane == 0) counts[w] = c;
}

// A warp a tile, a word a lane: the heads' positions, ascending, at
// starts[incl[w - 1] + the heads of the lanes below ...]; the last tile's
// warp writes starts[n_seg] = n.
__global__ void __launch_bounds__(kThreads)
    seg_starts_kernel(const unsigned* __restrict__ head, const int32_t* __restrict__ incl,
                      int32_t* __restrict__ starts, int n, int n_tiles) {
    const long long w = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
    const int lane = threadIdx.x % 32;
    if (w >= n_tiles) return;
    const long long word = w * 32 + lane;
    unsigned bits = word * 32 < n ? head[word] : 0u;
    const int c = __popc(bits);
    int below = c;   // inclusive scan of the lanes' heads
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
        const int x = __shfl_up_sync(kFull, below, d);
        if (lane >= d) below += x;
    }
    int q = (w > 0 ? incl[w - 1] : 0) + below - c;
    for (; bits; bits &= bits - 1) starts[q++] = static_cast<int32_t>(word * 32 + __ffs(bits) - 1);
    if (w == n_tiles - 1 && lane == 0) starts[incl[w]] = n;
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

// The long list's three inclusive scans over its first *n_long entries,
// by one block a kScanThreads entries at a time (warp scans, then the
// warps' totals): elem_end of long_len, chunk_end of ceil(long_len /
// chunk) and tile_end of ceil(long_len / kMergeTile).
__global__ void __launch_bounds__(kScanThreads)
    seg_long_scan_kernel(const int32_t* __restrict__ long_len, const int32_t* __restrict__ n_long,
                         int32_t* __restrict__ elem_end, int32_t* __restrict__ chunk_end,
                         int32_t* __restrict__ tile_end, int chunk) {
    __shared__ int totals[3][kScanThreads / 32];
    const int t = threadIdx.x, lane = t % 32, warp = t / 32;
    const int n_l = *n_long;
    int carry[3] = {0, 0, 0};
    for (int base = 0; base < n_l; base += kScanThreads) {
        const int i = base + t;
        const int len = i < n_l ? long_len[i] : 0;
        int v[3] = {len, len / chunk + (len % chunk != 0),
                    len / kMergeTile + (len % kMergeTile != 0)};
#pragma unroll
        for (int j = 0; j < 3; ++j) {
#pragma unroll
            for (int d = 1; d < 32; d *= 2) {
                const int x = __shfl_up_sync(kFull, v[j], d);
                if (lane >= d) v[j] += x;
            }
            if (lane == 31) totals[j][warp] = v[j];
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            int below = 0;
            for (int w = 0; w < warp; ++w) below += totals[j][w];
            v[j] += below + carry[j];
        }
        if (i < n_l) {
            elem_end[i] = v[0];
            chunk_end[i] = v[1];
            tile_end[i] = v[2];
        }
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            int all = 0;
            for (int w = 0; w < kScanThreads / 32; ++w) all += totals[j][w];
            carry[j] += all;
        }
        __syncthreads();
    }
}

// The order key of element p (a mask of -1 keys +inf).
__device__ __forceinline__ unsigned key_at(const float* keys, const int32_t* mask, long long p) {
    return order_bits((mask && mask[p] == -1) ? INFINITY : keys[p]);
}

// A thread an element of the long segments: unsorted[i] = 1 where the
// entry's element and the next one are out of order (elem_end the
// inclusive scan of long_len; unsorted zeroed by the caller).
__global__ void __launch_bounds__(kThreads)
    seg_check_kernel(const float* __restrict__ keys, const int32_t* __restrict__ mask,
                     const int32_t* __restrict__ long_start, const int32_t* __restrict__ long_len,
                     const int32_t* __restrict__ elem_end, const int32_t* __restrict__ n_long,
                     int32_t* __restrict__ unsorted) {
    const int n_l = *n_long;
    const long long total = n_l > 0 ? elem_end[n_l - 1] : 0;
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    for (long long k = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; k < total;
         k += stride) {
        const int i = entry_of(elem_end, n_l, k);
        const long long local = k - (elem_end[i] - long_len[i]);
        const long long p = long_start[i] + local;
        if (local + 1 < long_len[i] && key_at(keys, mask, p) > key_at(keys, mask, p + 1)) {
            unsorted[i] = 1;
        }
    }
}

// A warp a chunk of an unsorted long segment: chunk c of entry i is
// [start + c chunk, start + min((c + 1) chunk, len)); its keys sorted
// (sort_keys_for: a chunk in order is only copied) go to okey and their
// positions to opos, at the chunk's place.
__global__ void __launch_bounds__(32 * kChunkWarps)
    seg_chunks_kernel(const float* __restrict__ keys, const int32_t* __restrict__ mask,
                      const int32_t* __restrict__ long_start, const int32_t* __restrict__ long_len,
                      const int32_t* __restrict__ chunk_end, const int32_t* __restrict__ n_long,
                      const int32_t* __restrict__ unsorted, unsigned* __restrict__ okey,
                      int32_t* __restrict__ opos, int chunk) {
    constexpr int W = kMaxChunk;
    __shared__ unsigned ks_all[kChunkWarps][scratch_words(W)];
    __shared__ uint16_t vs_all[kChunkWarps][scratch_words(W)];
    const int lane = threadIdx.x % 32;
    unsigned* ks = ks_all[threadIdx.x / 32];
    uint16_t* vs = vs_all[threadIdx.x / 32];
    const int n_l = *n_long;
    const long long total = n_l > 0 ? chunk_end[n_l - 1] : 0;
    const long long warps = static_cast<long long>(gridDim.x) * kChunkWarps;
    for (long long g = static_cast<long long>(blockIdx.x) * kChunkWarps + threadIdx.x / 32;
         g < total; g += warps) {
        const int i = entry_of(chunk_end, n_l, g);
        if (!unsorted[i]) continue;
        const int len = long_len[i];
        const long long c = g - (chunk_end[i] - (len + chunk - 1) / chunk);
        const long long s = long_start[i] + c * chunk;
        const long long rest = len - c * chunk;
        const int len_c = static_cast<int>(rest < chunk ? rest : chunk);
        for (int q = lane; q < len_c; q += 32) ks[pad(q)] = key_at(keys, mask, s + q);
        __syncwarp();
        sort_keys_for<32, true>(len_c, len_c, 0, lane, ks, vs);
        for (int q = lane; q < len_c; q += 32) {
            okey[s + q] = ks[pad(q)];
            opos[s + q] = static_cast<int32_t>(s + vs[pad(q)]);
        }
        __syncwarp();
    }
}

// The number of A's elements among the first k of the stable merge of the
// sorted runs A[0, na) and B[0, nb) (A first on ties), by the warp: the
// smallest i with !(A[i] <= B[k - i - 1]), which is monotone in i; 32
// probes a step narrow [lo, hi] 32-fold, then one ballot counts.
__device__ __forceinline__ long long warp_co_rank(const unsigned* A, long long na,
                                                  const unsigned* B, long long nb, long long k,
                                                  int lane) {
    long long lo = k > nb ? k - nb : 0, hi = k < na ? k : na;
    while (hi - lo > 32) {
        const long long step = (hi - lo + 31) / 32;
        const long long i = lo + (lane + 1) * step - 1;
        const int c = __popc(__ballot_sync(kFull, i < hi && A[i] <= B[k - i - 1]));
        const long long top = lo + (c + 1) * step - 1;
        lo += c * step;
        hi = top < hi ? top : hi;
    }
    const long long i = lo + lane;
    return lo + __popc(__ballot_sync(kFull, i < hi && A[i] <= B[k - i - 1]));
}

// One merge round over the unsorted long segments that are not yet one
// run (len > width): runs of `width` (aligned to each segment's start)
// merged pairwise from (ikey, ipos) into (okey, opos), a block a tile of
// kMergeTile outputs (2 width is a multiple of it, so a tile lies in one
// pair): warps 0 and 1 find the tile's co-ranks, the tile's elements of
// both runs are staged, and each goes to the tile's start + its index in
// its part + the other part's elements before it (B's below an A key,
// A's up to a B key: the left run first on ties). tile_end is the
// inclusive scan of ceil(long_len / kMergeTile).
__global__ void __launch_bounds__(kMergeTile)
    seg_merge_kernel(const int32_t* __restrict__ long_start, const int32_t* __restrict__ long_len,
                     const int32_t* __restrict__ tile_end, const int32_t* __restrict__ n_long,
                     const int32_t* __restrict__ unsorted, const unsigned* __restrict__ ikey,
                     const int32_t* __restrict__ ipos, unsigned* __restrict__ okey,
                     int32_t* __restrict__ opos, long long width) {
    __shared__ unsigned tile[kMergeTile];
    __shared__ int32_t tpos[kMergeTile];
    __shared__ long long bounds[2];
    const int t = threadIdx.x, lane = t % 32;
    const int n_l = *n_long;
    const long long total = n_l > 0 ? tile_end[n_l - 1] : 0;
    for (long long g = blockIdx.x; g < total; g += gridDim.x) {
        const int i = entry_of(tile_end, n_l, g);
        const long long len = long_len[i], s = long_start[i];
        if (len <= width || !unsorted[i]) continue;   // one run already, or in order
        const long long k0 = (g - (tile_end[i] - (len + kMergeTile - 1) / kMergeTile)) * kMergeTile;
        const long long p0 = k0 / (2 * width) * (2 * width);
        const long long na = len - p0 < width ? len - p0 : width;
        const long long rest = len - p0 - na;
        const long long nb = rest < width ? rest : width;
        const unsigned* A = ikey + s + p0;
        const unsigned* B = A + na;
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
        if (t < n_a) {
            tile[t] = A[i0 + t];
            tpos[t] = ipos[s + p0 + i0 + t];
        } else if (t < n_t) {
            tile[t] = B[j0 + t - n_a];
            tpos[t] = ipos[s + p0 + na + j0 + t - n_a];
        }
        __syncthreads();
        if (t < n_t) {
            const unsigned x = tile[t];
            const bool in_a = t < n_a;
            int l = in_a ? n_a : 0, h = in_a ? n_t : n_a;
            const int lo = l;
            while (l < h) {   // B's keys below x, or A's keys up to x
                const int mid = (l + h) / 2;
                if (in_a ? tile[mid] < x : tile[mid] <= x) l = mid + 1;
                else h = mid;
            }
            const long long q = s + p0 + kk0 + (in_a ? t : t - n_a) + (l - lo);
            okey[q] = x;
            opos[q] = tpos[t];
        }
        __syncthreads();
    }
}

// The merge rounds that make a segment of len entries one run from
// chunks of `chunk`: its merged positions are in buffer rounds % 2.
__device__ __forceinline__ int rounds_for(long long len, int chunk) {
    int r = 0;
    while ((static_cast<long long>(chunk) << r) < len) ++r;
    return r;
}

// The long segments' payloads gathered by their merged positions, each
// segment's from the buffer its last round wrote; a segment in order is
// copied.
__global__ void __launch_bounds__(kThreads)
    seg_gather_kernel(const int32_t* __restrict__ long_start, const int32_t* __restrict__ long_len,
                      const int32_t* __restrict__ elem_end, const int32_t* __restrict__ n_long,
                      const int32_t* __restrict__ unsorted, const int32_t* __restrict__ pos0,
                      const int32_t* __restrict__ pos1, const __grid_constant__ SortArgs a,
                      int chunk) {
    const int n_l = *n_long;
    const long long total = n_l > 0 ? elem_end[n_l - 1] : 0;
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    for (long long k = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; k < total;
         k += stride) {
        const int i = entry_of(elem_end, n_l, k);
        const long long p = long_start[i] + (k - (elem_end[i] - long_len[i]));
        const long long src =
            unsorted[i] ? (rounds_for(long_len[i], chunk) % 2 ? pos1 : pos0)[p] : p;
#pragma unroll
        for (int q = 0; q < kMaxPayloads; ++q) {
            if (q < a.n_payloads) a.dst[q][p] = a.src[q][src];
        }
    }
}

// E10's arguments: the rows' counts and the three row arrays (i32 and f32
// alike: bits are copied), the outputs (offsets, clamped counts, the
// three flat buffers), the look-back state (word 0 the ticket counter,
// word 1 + k range k's published sum) and each buffer's fill bits.
struct FlatArgs {
    const int32_t* counts;
    const uint32_t* src[3];
    int32_t* offsets;
    int32_t* kept;
    uint32_t* dst[3];
    unsigned long long* state;
    uint32_t fill[3];
    int n_rows, width, capacity, slots, range_rows;
};

// A range's published sum: (flag << 32) | the u32 sum, in one 64-bit word,
// so a reader never sees a flag without its value.
constexpr unsigned long long kAggregate = 1ull << 32;   // the range's own sum
constexpr unsigned long long kInclusive = 2ull << 32;   // the sum of it and every range before

__device__ __forceinline__ unsigned long long load_state(const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void store_state(unsigned long long* p, unsigned long long v) {
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// The decoupled look-back of range t (warp 0 of its block; st the ranges'
// words): publishes the range's sum `agg`, then reads its predecessors 32
// at a time (lane l range k - l, a range before 0 counting as an
// inclusive 0), waits while any of them has published nothing, adds the
// sums up to the nearest inclusive one and stops there, else moves 32
// back; publishes its own inclusive sum. Returns the sum of the ranges
// before t (mod 2^32: the int64 scan's low bits). Tickets are taken in
// order, so every range it waits for is held by a running block.
__device__ __forceinline__ unsigned look_back(unsigned long long* st, long long t, unsigned agg,
                                              int lane) {
    if (t == 0) {
        if (lane == 0) store_state(st, kInclusive | agg);
        return 0u;
    }
    if (lane == 0) store_state(st + t, kAggregate | agg);
    unsigned base = 0;
    for (long long k = t - 1;; k -= 32) {
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

// A block barrier for E10, after the warp's lanes reconverge. Lanes part
// before each of its barriers (thread 0 takes the ticket, lane 31 writes
// its warp's sum, warp 0 looks back, lanes copy different columns), and
// __syncthreads is an aligned bar.sync, after which the compiler takes the
// warp as converged and issues the scan's shuffles without a warp sync.
// (With a store by thread 0 before the loop, which the compiler merged
// into the first ticket's branch, the 4-byte instance built for blocks of
// 512 threads had no reconvergence point around that branch, and its scan
// ran lane 0 apart from lanes 1-31: row 0's count was lost.)
__device__ __forceinline__ void block_sync() {
    __syncwarp();
    __syncthreads();
}

__device__ __forceinline__ uint32_t lane_of(const uint4& v, int e) {
    return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

// Output words h .. h + 3 of the pair (a, b): the 16-byte vector that
// starts h words into a (h is a row's, so the warp takes one branch).
__device__ __forceinline__ uint4 realign(const uint4& a, const uint4& b, int h) {
    switch (h) {
        case 1: return make_uint4(a.y, a.z, a.w, b.x);
        case 2: return make_uint4(a.z, a.w, b.x, b.y);
        case 3: return make_uint4(a.w, b.x, b.y, b.z);
        default: return a;
    }
}

// Row r's records (its first n = kept columns, clipped to the capacity) to
// off + column, by its warp; then its sentinel slot. A negative offset
// (counts that are no hit counts) compares as past the capacity, so no
// store leaves the buffers.
//
// kVec (width % 4 == 0, rows 16-byte aligned): the row in chunks of
// kFlatChunk columns; lane l loads vectors l + 32 t (t < kFlatVecs) of
// each array, lane 0 also the next chunk's first, every load before any
// store. The destination starts at any word, so the body goes out as
// aligned vectors from off + h (h = (4 - off % 4) % 4): body vector M
// takes words h .. 3 of source vector M and 0 .. h - 1 of M + 1, the
// latter from lane l + 1 by a shuffle (lane 31 from lane 0's next
// vector). The ragged head (columns below h) and tail (past the last
// whole vector) are 4-byte stores by the lanes that hold them.
// Else a 4-byte load and store a column, 32 columns a step.
template <bool kVec>
__device__ __forceinline__ void copy_row(const FlatArgs& a, long long r, int off, int kept,
                                         int lane) {
    const int n = kept <= 0 || static_cast<unsigned>(off) >= static_cast<unsigned>(a.capacity)
                      ? 0
                      : min(kept, a.capacity - off);
    const long long row = r * a.width;
    if constexpr (kVec) {
        const int h = (4 - (off & 3)) & 3;
        const int nb = n > h ? (n - h) >> 2 : 0;   // whole body vectors
        const int tail = h + 4 * nb;               // the first column past them
        const long long body = static_cast<long long>(off) + h;
        for (int cb = 0; cb < n; cb += kFlatChunk) {
            uint4 v[3][kFlatVecs + 1];
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                const uint4* s = reinterpret_cast<const uint4*>(a.src[k] + row + cb);
#pragma unroll
                for (int t = 0; t <= kFlatVecs; ++t) {
                    const int q = t < kFlatVecs ? lane + 32 * t : 32 * kFlatVecs;
                    const bool load = (t < kFlatVecs || lane == 0) && cb + 4 * q < n;
                    v[k][t] = load ? __ldg(s + q) : make_uint4(0u, 0u, 0u, 0u);
                }
            }
#pragma unroll
            for (int t = 0; t < kFlatVecs; ++t) {
                const int m = cb / 4 + lane + 32 * t;   // body vector m, source vector m
#pragma unroll
                for (int k = 0; k < 3; ++k) {
                    uint4 out = v[k][t];
                    if (h) {
                        const uint4 give = lane == 0 ? v[k][t + 1] : v[k][t];
                        uint4 b;
                        b.x = __shfl_sync(kFull, give.x, (lane + 1) & 31);
                        b.y = __shfl_sync(kFull, give.y, (lane + 1) & 31);
                        b.z = __shfl_sync(kFull, give.z, (lane + 1) & 31);
                        out = realign(v[k][t], b, h);
                    }
                    if (m < nb) *reinterpret_cast<uint4*>(a.dst[k] + body + 4LL * m) = out;
                }
                const int c0 = 4 * m;   // the columns this lane holds: c0 .. c0 + 3
                if (c0 < min(h, n) || (c0 + 3 >= tail && c0 < n)) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int c = c0 + e;
                        if (c < n && (c < h || c >= tail)) {
#pragma unroll
                            for (int k = 0; k < 3; ++k) a.dst[k][off + c] = lane_of(v[k][t], e);
                        }
                    }
                }
            }
        }
    } else {
        for (int c = lane; c < n; c += 32) {
#pragma unroll
            for (int k = 0; k < 3; ++k) a.dst[k][off + c] = a.src[k][row + c];
        }
    }
    const long long slot = static_cast<long long>(off) + kept;
    if (a.slots && lane == 0 &&
        static_cast<unsigned long long>(slot) < static_cast<unsigned long long>(a.capacity)) {
#pragma unroll
        for (int k = 0; k < 3; ++k) a.dst[k][slot] = a.fill[k];
    }
}

// Tail ticket c: chunk total / kTailChunk + c of kTailChunk positions,
// its part in [total, capacity) filled, 16 bytes a store between its
// ragged ends; total is the last range's inclusive sum (thread 0 waits
// for it: once, later tickets find it published). False where the chunk
// starts past the capacity: no tail is left for this block. Called by
// the whole block.
__device__ __forceinline__ bool fill_tail(const FlatArgs& a, long long c, long long n_ranges,
                                          int* s_total) {
    if (threadIdx.x == 0) {
        unsigned long long w = kInclusive;   // no rows: total 0
        if (n_ranges > 0) {
            do {
                w = load_state(a.state + n_ranges);
            } while ((w >> 32) != 2);
        }
        *s_total = max(static_cast<int>(static_cast<unsigned>(w)), 0);
    }
    block_sync();
    const long long total = *s_total;
    const long long chunk = total / kTailChunk + c;
    const long long lo = max(total, chunk * kTailChunk);
    const long long hi = min(chunk * kTailChunk + kTailChunk, static_cast<long long>(a.capacity));
    if (lo >= hi) return false;
#pragma unroll
    for (int i = 0; i < kTailChunk / (4 * kFlatThreads); ++i) {
        const long long p = chunk * kTailChunk + 4 * (threadIdx.x + kFlatThreads * i);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const uint32_t f = a.fill[k];
            if (p >= lo && p + 4 <= hi) {
                *reinterpret_cast<uint4*>(a.dst[k] + p) = make_uint4(f, f, f, f);
            } else {
                for (long long q = max(p, lo); q < min(p + 4, hi); ++q) a.dst[k][q] = f;
            }
        }
    }
    return true;
}

// E10: persistent blocks take tickets from a counter in order. Ticket t
// below n_ranges is range t, rows [t R, t R + R) (R = range_rows, at most
// kFlatThreads): a thread a row clamps its count to the width and scans
// count + slots over the block (u32: the int64 scan's low bits, which the
// cast to int32 keeps), warp 0 takes the sum of the ranges before by the
// look-back, the offsets and clamped counts are written, and the block's
// warps copy the rows, row i by warp i % kFlatWarps. Later tickets fill
// the tail past the last row, a chunk each. Records, sentinel slots and
// tail cover each position of the buffers once.
template <bool kVec>
__global__ void __launch_bounds__(kFlatThreads)
    records_flat_kernel(const __grid_constant__ FlatArgs a) {
    __shared__ unsigned s_ticket, s_base;
    __shared__ int s_total;
    __shared__ unsigned s_warp[kFlatWarps];
    __shared__ int32_t s_off[kFlatThreads], s_kept[kFlatThreads];
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const long long n_ranges =
        (static_cast<long long>(a.n_rows) + a.range_rows - 1) / a.range_rows;
    for (;;) {
        if (tid == 0) s_ticket = atomicAdd(reinterpret_cast<unsigned*>(a.state), 1u);
        block_sync();
        const long long t = s_ticket;
        if (t >= n_ranges) {
            if (!fill_tail(a, t - n_ranges, n_ranges, &s_total)) break;
        } else {
            const long long r0 = t * a.range_rows;
            const int rows = static_cast<int>(min(static_cast<long long>(a.range_rows),
                                                  a.n_rows - r0));
            int kept = 0;
            unsigned stride = 0, incl = 0;
            if (tid < rows) {
                kept = min(a.counts[r0 + tid], a.width);
                stride = static_cast<unsigned>(kept) + static_cast<unsigned>(a.slots);
            }
            incl = stride;
#pragma unroll
            for (int d = 1; d < 32; d *= 2) {
                const unsigned x = __shfl_up_sync(kFull, incl, d);
                if (lane >= d) incl += x;
            }
            if (lane == 31) s_warp[warp] = incl;
            block_sync();
            unsigned agg = 0, below = 0;
#pragma unroll
            for (int w = 0; w < kFlatWarps; ++w) {
                agg += s_warp[w];
                below += w < warp ? s_warp[w] : 0u;
            }
            if (warp == 0) {
                const unsigned base = look_back(a.state + 1, t, agg, lane);
                if (lane == 0) s_base = base;
            }
            block_sync();
            if (tid < rows) {
                const int off = static_cast<int>(s_base + below + incl - stride);
                a.offsets[r0 + tid] = off;
                a.kept[r0 + tid] = kept;
                s_off[tid] = off;
                s_kept[tid] = kept;
            }
            block_sync();
            for (int i = warp; i < rows; i += kFlatWarps) {
                copy_row<kVec>(a, r0 + i, s_off[i], s_kept[i], lane);
            }
        }
        block_sync();   // the ticket and the range's offsets read before they change
    }
}

// The sort arguments of keys, mask (or null) and n payloads (host_ptrs: n
// source then n destination addresses): every array 4-byte aligned, the
// destinations 16-byte aligned.
bool make_sort_args(SortArgs& a, const float* keys, const int32_t* mask,
                    const unsigned long long* host_ptrs, int n) {
    if (n < 1 || n > kMaxPayloads || !host_ptrs || !keys) return false;
    a = SortArgs{};
    a.n_payloads = n;
    auto add = [&a](const void* p) {
        for (int j = 0; j < a.n_stage; ++j) {
            if (a.stage[j] == p) return j;
        }
        a.stage[a.n_stage] = static_cast<const uint32_t*>(p);
        a.align[a.n_stage] = static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
        return a.n_stage++;
    };
    add(keys);
    a.mask_slot = mask ? add(mask) : -1;
    a.mask_align = mask ? a.align[a.mask_slot] : 0;
    for (int k = 0; k < n; ++k) {
        a.src[k] = reinterpret_cast<const uint32_t*>(host_ptrs[k]);
        a.dst[k] = reinterpret_cast<uint32_t*>(host_ptrs[n + k]);
        if (!a.src[k] || !a.dst[k] || reinterpret_cast<uintptr_t>(a.dst[k]) % 16) return false;
        a.slot[k] = add(a.src[k]);
        a.palign[k] = a.align[a.slot[k]];
    }
    for (int j = 0; j < a.n_stage; ++j) {
        if (reinterpret_cast<uintptr_t>(a.stage[j]) % 4) return false;
    }
    return true;
}

// Warps a block of sort_kernel<kMaxE> for n staged arrays: as many as
// kSortSmem holds, at most kSortWarps.
template <int kMaxE>
int sort_block_warps(int n) {
    const int w = kSortSmem / warp_bytes(32 * kMaxE, n);
    return w < 1 ? 1 : (w > kSortWarps ? kSortWarps : w);
}

// sort_kernel<kMaxE, kRows> over `runs` runs (an upper bound for
// segments): a persistent grid of the blocks the card holds at once.
template <int kMaxE, bool kRows>
cudaError_t launch_sort(const SortArgs& a, const int32_t* starts, const int32_t* n_seg,
                        int32_t* long_start, int32_t* long_len, int32_t* n_long, long long runs,
                        int n_rows, int width, int cap, int device, cudaStream_t stream) {
    const int warps = sort_block_warps<kMaxE>(a.n_stage);
    const int bytes = warps * warp_bytes(32 * kMaxE, a.n_stage);
    cudaError_t err = cudaFuncSetAttribute(sort_kernel<kMaxE, kRows>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    int per_sm = 0, sms = 0;
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sort_kernel<kMaxE, kRows>,
                                                            32 * warps, bytes);
    }
    if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    if (err != cudaSuccess) return err;
    const long long need = (runs + warps - 1) / warps;
    const long long most = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
    const int grid = static_cast<int>(need < 1 ? 1 : (need < most ? need : most));
    sort_kernel<kMaxE, kRows><<<grid, 32 * warps, bytes, stream>>>(
        a, starts, n_seg, long_start, long_len, n_long, n_rows, width, cap);
    return cudaGetLastError();
}

bool valid_chunk(int chunk) {
    return chunk >= kMinChunk && chunk <= kMaxChunk && (chunk & (chunk - 1)) == 0;
}

int long_grid(long long items, int per_block, int device) {
    int sms = 1;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
        sms = 1;
    }
    const long long most = static_cast<long long>(kLongBlocksPerSm) * sms;
    const long long b = (items + per_block - 1) / per_block;
    return static_cast<int>(b < 1 ? 1 : (b > most ? most : b));
}

}  // namespace

// E8: each row of distances f32[n_rows, width] sorted (a sentinel slot,
// indices -1, keyed +inf), its indices i32, integrals and distances f32
// written in that order into o_idx, o_intg, o_dist (all [n_rows, width]);
// width <= kMaxChunk, n_rows width < 2^31.
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
    const unsigned long long ptrs[6] = {
        reinterpret_cast<unsigned long long>(idx), reinterpret_cast<unsigned long long>(intg),
        reinterpret_cast<unsigned long long>(dist), reinterpret_cast<unsigned long long>(o_idx),
        reinterpret_cast<unsigned long long>(o_intg), reinterpret_cast<unsigned long long>(o_dist)};
    SortArgs a{};
    if (!make_sort_args(a, dist, idx, ptrs, 3)) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    err = width <= kWarpRun
              ? launch_sort<16, true>(a, nullptr, nullptr, nullptr, nullptr, nullptr, n_rows,
                                      n_rows, width, width, device, s)
              : launch_sort<32, true>(a, nullptr, nullptr, nullptr, nullptr, nullptr, n_rows,
                                      n_rows, width, width, device, s);
    return static_cast<int>(err);
}

// E9's head bits u32[ceil(n / 32)] (zeroed by the caller) from offsets
// i32[n_off] (offsets[0] ignored) and, where total is not null, the i32
// at total (clamped to [0, n] by the caller).
extern "C" int grace_seg_heads(const int32_t* offsets, const int32_t* total, unsigned* head,
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

// The heads in each tile of kTile positions: counts i32[ceil(n / kTile)]
// from the head bits of n positions.
extern "C" int grace_seg_count(const unsigned* head, int32_t* counts, int n, int device,
                               void* stream) {
    if (n < 1 || !head || !counts) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_tiles = (n + kTile - 1) / kTile;
    seg_count_kernel<<<(n_tiles + kWarps - 1) / kWarps, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(head, counts, (n + 31) / 32, n_tiles);
    return static_cast<int>(cudaGetLastError());
}

// The segment starts i32[n_seg + 1] (starts[n_seg] = n) from the head
// bits and incl, the inclusive scan of grace_seg_count's counts.
extern "C" int grace_seg_starts(const unsigned* head, const int32_t* incl, int32_t* starts,
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
// addresses, 4-byte elements) written in that order; a segment longer
// than min(chunk, kWarpRun) is appended to (long_start, long_len) at the
// counter n_long instead.
extern "C" int grace_segmented_sort(const float* keys, const int32_t* mask, const int32_t* starts,
                                    const int32_t* n_seg, const unsigned long long* host_ptrs,
                                    int32_t* long_start, int32_t* long_len, int32_t* n_long,
                                    int n_payloads, int max_segs, int chunk, int device,
                                    void* stream) {
    SortArgs a{};
    if (max_segs < 0 || !valid_chunk(chunk) ||
        !make_sort_args(a, keys, mask, host_ptrs, n_payloads) ||
        (max_segs > 0 && (!starts || !n_seg || !long_start || !long_len || !n_long))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (max_segs == 0) return static_cast<int>(cudaGetLastError());
    static_assert(kWarpRun == 32 * 16, "the segmented sort's warps are sort_kernel<16>'s");
    err = launch_sort<16, false>(a, starts, n_seg, long_start, long_len, n_long, max_segs, 0, 0,
                          chunk < kWarpRun ? chunk : kWarpRun, device,
                          static_cast<cudaStream_t>(stream));
    return static_cast<int>(err);
}

// The long list's scans (seg_long_scan_kernel): elem_end, chunk_end and
// tile_end i32[n_max] over the first *n_long entries of long_len.
extern "C" int grace_seg_long_scan(const int32_t* long_len, const int32_t* n_long,
                                   int32_t* elem_end, int32_t* chunk_end, int32_t* tile_end,
                                   int n_max, int chunk, int device, void* stream) {
    if (n_max < 1 || !valid_chunk(chunk) || !long_len || !n_long || !elem_end || !chunk_end ||
        !tile_end) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    seg_long_scan_kernel<<<1, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        long_len, n_long, elem_end, chunk_end, tile_end, chunk);
    return static_cast<int>(cudaGetLastError());
}

// The long segments' order: unsorted i32[n_max] (zeroed by the caller)
// set to 1 for each of the first *n_long entries of (long_start, long_len)
// whose keys (with mask, a sentinel index keys +inf) are not
// non-decreasing; elem_end is the inclusive scan of long_len.
extern "C" int grace_seg_check(const float* keys, const int32_t* mask, const int32_t* long_start,
                               const int32_t* long_len, const int32_t* elem_end,
                               const int32_t* n_long, int32_t* unsorted, int n_max, int n,
                               int device, void* stream) {
    if (n_max < 1 || n < 1 || !keys || !long_start || !long_len || !elem_end || !n_long ||
        !unsorted) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    seg_check_kernel<<<long_grid(n, kThreads, device), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        keys, mask, long_start, long_len, elem_end, n_long, unsorted);
    return static_cast<int>(cudaGetLastError());
}

// The unsorted long segments' chunks sorted into okey u32[n] and opos
// i32[n]: the first *n_long entries of (long_start, long_len) are the
// long segments, chunk_end the inclusive scan of ceil(long_len / chunk);
// n_max bounds *n_long.
extern "C" int grace_seg_chunks(const float* keys, const int32_t* mask, const int32_t* long_start,
                                const int32_t* long_len, const int32_t* chunk_end,
                                const int32_t* n_long, const int32_t* unsorted, unsigned* okey,
                                int32_t* opos, int n_max, int chunk, int n, int device,
                                void* stream) {
    if (n_max < 1 || n < 1 || !valid_chunk(chunk) || !keys || !long_start || !long_len ||
        !chunk_end || !n_long || !unsorted || !okey || !opos) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long most = (static_cast<long long>(n) + chunk - 1) / chunk + n_max;
    seg_chunks_kernel<<<long_grid(most, kChunkWarps, device), 32 * kChunkWarps, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        keys, mask, long_start, long_len, chunk_end, n_long, unsorted, okey, opos, chunk);
    return static_cast<int>(cudaGetLastError());
}

// One merge round: runs of `width` (a multiple of kMergeTile / 2) merged
// pairwise from (ikey u32[n], ipos i32[n]) into (okey, opos); tile_end is
// the inclusive scan of ceil(long_len / kMergeTile) over the first
// *n_long entries.
extern "C" int grace_seg_merge(const int32_t* long_start, const int32_t* long_len,
                               const int32_t* tile_end, const int32_t* n_long,
                               const int32_t* unsorted, const unsigned* ikey, const int32_t* ipos,
                               unsigned* okey, int32_t* opos, int n_max, int width, int n,
                               int device, void* stream) {
    if (n_max < 1 || n < 1 || width < kMergeTile / 2 || width % (kMergeTile / 2) ||
        !long_start || !long_len || !tile_end || !n_long || !unsorted || !ikey || !ipos ||
        !okey || !opos || ikey == okey || ipos == opos) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long tiles = (static_cast<long long>(n) + kMergeTile - 1) / kMergeTile + n_max;
    seg_merge_kernel<<<long_grid(tiles, 1, device), kMergeTile, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        long_start, long_len, tile_end, n_long, unsorted, ikey, ipos, okey, opos, width);
    return static_cast<int>(cudaGetLastError());
}

// The long segments' payloads (host_ptrs as grace_segmented_sort's)
// gathered by the merged positions: a segment of len entries in pos0 or
// pos1 (i32[n]) as its rounds from chunks of `chunk` end, or copied where
// unsorted is 0; elem_end is the inclusive scan of long_len over the
// first *n_long entries.
extern "C" int grace_seg_gather(const int32_t* long_start, const int32_t* long_len,
                                const int32_t* elem_end, const int32_t* n_long,
                                const int32_t* unsorted, const int32_t* pos0, const int32_t* pos1,
                                const unsigned long long* host_ptrs, int n_max, int n_payloads,
                                int chunk, int n, int device, void* stream) {
    SortArgs a{};
    const float* any = host_ptrs && n_payloads > 0 ? reinterpret_cast<const float*>(host_ptrs[0])
                                                   : nullptr;
    if (n_max < 1 || n < 1 || !valid_chunk(chunk) || !long_start || !long_len || !elem_end ||
        !n_long || !unsorted || !pos0 || !pos1 ||
        !make_sort_args(a, any, nullptr, host_ptrs, n_payloads)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    seg_gather_kernel<<<long_grid(n, kThreads, device), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        long_start, long_len, elem_end, n_long, unsorted, pos0, pos1, a, chunk);
    return static_cast<int>(cudaGetLastError());
}

// What one launch of segsort kernel `kernel` holds (out: registers, shared
// bytes (the sort kernels' dynamic bytes for n_stage staged arrays
// included), threads, resident blocks and warps an SM, local bytes a
// thread): 0 sort_kernel<16, true> (E8's rows up to 512), 1
// sort_kernel<32, true> (E8's rows up to 1,024), 2 sort_kernel<16, false>
// (E9's segments), 3 heads, 4 count, 5 starts, 6 the long list's scan, 7
// check, 8 chunks, 9 merge, 10 gather, 11 records_to_flat (16-byte rows), 12
// records_to_flat (rows of a width that is no multiple of 4).
extern "C" int grace_segsort_resources(int* out, int kernel, int n_stage, int device,
                                       void* stream) {
    (void)stream;
    if (!out || kernel < 0 || kernel > 12 || n_stage < 1 || n_stage > kMaxStaged) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const void* fns[13] = {reinterpret_cast<const void*>(sort_kernel<16, true>),
                           reinterpret_cast<const void*>(sort_kernel<32, true>),
                           reinterpret_cast<const void*>(sort_kernel<16, false>),
                           reinterpret_cast<const void*>(seg_heads_kernel),
                           reinterpret_cast<const void*>(seg_count_kernel),
                           reinterpret_cast<const void*>(seg_starts_kernel),
                           reinterpret_cast<const void*>(seg_long_scan_kernel),
                           reinterpret_cast<const void*>(seg_check_kernel),
                           reinterpret_cast<const void*>(seg_chunks_kernel),
                           reinterpret_cast<const void*>(seg_merge_kernel),
                           reinterpret_cast<const void*>(seg_gather_kernel),
                           reinterpret_cast<const void*>(records_flat_kernel<true>),
                           reinterpret_cast<const void*>(records_flat_kernel<false>)};
    int threads[13] = {0, 0, 0, kThreads, kThreads, kThreads, kScanThreads, kThreads,
                       32 * kChunkWarps, kMergeTile, kThreads, kFlatThreads, kFlatThreads};
    int dynamic = 0;
    if (kernel < 3) {
        const int warps =
            kernel == 1 ? sort_block_warps<32>(n_stage) : sort_block_warps<16>(n_stage);
        threads[kernel] = 32 * warps;
        dynamic = warps * warp_bytes(kernel == 1 ? 1024 : 512, n_stage);
        err = cudaFuncSetAttribute(fns[kernel], cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   dynamic);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    cudaFuncAttributes attr;
    int blocks = 0;
    err = cudaFuncGetAttributes(&attr, fns[kernel]);
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fns[kernel], threads[kernel],
                                                            dynamic);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.sharedSizeBytes) + dynamic;
    out[2] = threads[kernel];
    out[3] = blocks;
    out[4] = blocks * threads[kernel] / 32;
    out[5] = static_cast<int>(attr.localSizeBytes);
    return 0;
}

// E10: rows (idx i32, intg, dist f32 [n_rows, width]) into the flat
// buffers o_* [capacity]; offsets i32[n_rows] and kept i32[n_rows] are
// written: counts (hit counts, >= 0) clamped to the width, and the
// exclusive scan of kept + slots (one sentinel slot after each row where
// slots is 1; n_rows (width + slots) < 2^31, so the int64 scan's cast to
// int32 never wraps). state: 1 + ceil(n_rows / range_rows) u64 words,
// zeroed here. The fills are i32 and f32 bit patterns. Rows of a width
// that is a multiple of 4 are read 16 bytes at a time and must be 16-byte
// aligned, as the buffers must be.
extern "C" int grace_records_to_flat(const int32_t* counts, const int32_t* idx, const float* intg,
                                     const float* dist, int32_t* offsets, int32_t* kept,
                                     int32_t* o_idx, float* o_intg, float* o_dist,
                                     unsigned long long* state, int n_rows, int width,
                                     int capacity, int slots, int idx_fill, int val_bits,
                                     int dist_bits, int range_rows, int device, void* stream) {
    const bool vec = width % 4 == 0;
    auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
    if (n_rows < 0 || width < 0 || capacity < 0 || (slots != 0 && slots != 1) ||
        range_rows < 1 || range_rows > kFlatThreads || !state ||
        static_cast<long long>(n_rows) * (width + slots) >= (1LL << 31) ||
        (n_rows > 0 && (!counts || !offsets || !kept)) ||
        (n_rows > 0 && width > 0 &&
         (!idx || !intg || !dist ||
          (vec && (misaligned(idx) || misaligned(intg) || misaligned(dist))))) ||
        (capacity > 0 && (!o_idx || !o_intg || !o_dist || misaligned(o_idx) ||
                          misaligned(o_intg) || misaligned(o_dist)))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_rows == 0 && capacity == 0) return static_cast<int>(cudaGetLastError());
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long n_ranges = (static_cast<long long>(n_rows) + range_rows - 1) / range_rows;
    err = cudaMemsetAsync(state, 0, sizeof(unsigned long long) * (1 + n_ranges), s);
    const auto fn = vec ? records_flat_kernel<true> : records_flat_kernel<false>;
    // the blocks the card holds at once (asked once a device and instance),
    // or fewer where the tickets are fewer
    static int resident[kMaxDevices][2];
    int most = device < kMaxDevices ? resident[device][vec] : 0;
    if (err == cudaSuccess && most == 0) {
        int per_sm = 0, sms = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kFlatThreads, 0);
        if (err == cudaSuccess) {
            err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
        }
        most = (per_sm > 0 ? per_sm : 1) * sms;
        if (err == cudaSuccess && device < kMaxDevices) resident[device][vec] = most;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long tickets = n_ranges + (static_cast<long long>(capacity) + kTailChunk - 1) /
                                             kTailChunk + 1;
    const int grid = static_cast<int>(tickets < most ? tickets : most);
    FlatArgs a{};
    a.counts = counts;
    a.src[0] = reinterpret_cast<const uint32_t*>(idx);
    a.src[1] = reinterpret_cast<const uint32_t*>(intg);
    a.src[2] = reinterpret_cast<const uint32_t*>(dist);
    a.offsets = offsets;
    a.kept = kept;
    a.dst[0] = reinterpret_cast<uint32_t*>(o_idx);
    a.dst[1] = reinterpret_cast<uint32_t*>(o_intg);
    a.dst[2] = reinterpret_cast<uint32_t*>(o_dist);
    a.state = state;
    a.fill[0] = static_cast<uint32_t>(idx_fill);
    a.fill[1] = static_cast<uint32_t>(val_bits);
    a.fill[2] = static_cast<uint32_t>(dist_bits);
    a.n_rows = n_rows;
    a.width = width;
    a.capacity = capacity;
    a.slots = slots;
    a.range_rows = range_rows;
    fn<<<grid, kFlatThreads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
}
