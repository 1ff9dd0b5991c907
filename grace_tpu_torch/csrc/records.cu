// Per-hit SPH records in one pass: each ray's (primitive index, line
// integral, distance) rows, over bitmask-culled ray tiles.
//
// Replaces grace_tpu/trace/pallas_records.py::_records_tile_kernel
// (segment words, VMEM-resident slabs, with its drains _records_slab_drain
// and _records_slab_drain_network), ::_records_tile_kernel_stream (the same
// with slabs streamed from HBM) and ::_records_tile_kernel_quarter (quarter
// words). The slabs live in device memory for any scene, so the resident
// and streaming TPU kernels share grace_records_bitmask.
//
// The TPU kernels ranked each slab's hits across lanes and drained them
// rank by rank, because a TPU lane cannot keep a scatter cursor. Here one
// thread is one ray with a cursor in a register, and the cursor counts on
// past the row's capacity, so counts stay exact on overflow. Records come
// out in ascending primitive order, as grace_tpu's do.
//
// Layout: one block per ray tile, one thread per ray (tile <= 1024). Every
// thread walks the tile's mask row in place, in ascending order and across
// word boundaries (the same walk on every thread, so the control flow is
// block-uniform): up to 2 set segments (B15) or 8 listed quarters (B16)
// make a batch of kBatch primitives, whose group ids go to a small shared
// array and whose rows the block stages with 16-byte cp.async copies
// (stage.cuh). Each thread then tests its ray against 32 staged primitives
// at a time into a mask (pass_bits32, the hit test b^2 < h^2 along the
// ray), and only the set bits take the impact again (the same operations,
// so the same bits), the degree-14 integral and the append at the cursor.
//
// What bounds it: on the bench scene (tile 64, 512 records a ray, an H100)
// the work per hit, not the pair tests or the bytes. The tests (1.4 G pairs on
// quarter words, 2.7 G on segment words), walk and staging alone take 1.1
// and 2.1 ms; the 65 M records and 0.8 GB of sentinels about 1.7 ms more
// in both (chip_ablation.py records), against a bound of 0.5 ms for the
// 1.6 GB of rows. What the design does about it:
// - the integral and the stores leave the test loop (pass_bits32 first);
// - a hit is stored by its warp, not its thread: each ray appends to
//   kPending slots in shared memory and, when a lane's slots are full (a
//   warp vote), the warp writes its 32 rays' pending records in turn, its
//   lanes along the records, so a store covers runs of a few rows instead
//   of 32 rows C entries apart (B16 from 5.8 to 3.2 ms);
// - each warp fills its rows' sentinels the same way, with no division;
// - batches of 256 primitives and one staging buffer, so that shared
//   memory (5 KB of primitives and 13 KB of slots at tile 64) holds 12
//   blocks, 24 warps, an SM;
// - tiles list from none to hundreds of groups and a block walks its row
//   serially, so the wrappers launch the tiles longest row first
//   (``order``): block b works on tile order[b] and writes that tile's
//   rows and counts in place.

#include <cstdint>

#include "common.cuh"
#include "stage.cuh"

// Pending slots (kStride a ray): dynamic shared memory, per warp its 32
// rays' index, integral and distance slots.
extern __shared__ __align__(16) unsigned char s_pending[];

namespace {

constexpr int kSegShift = 7;      // 128 primitives a segment
constexpr int kQuarterShift = 5;  // 32 primitives a quarter
// Primitives staged a batch, and staging buffers (a second lets the next
// batch's copies run during this one's tests). On the bench scene 256 and
// one buffer beat 128, 512 and 1024, and two (chip_ablation.py records).
constexpr int kBatch = 256;
constexpr int kStageBuffers = 1;
// Records a ray keeps pending in shared memory before its warp writes them
// out; 16 beat 8 and 32, and 12 on quarter words (a tie on segment words).
// A ray's slots take kPending + 1 words of each field: an odd stride, so
// that 32 lanes appending at the same count fall in 32 banks.
constexpr int kPending = 16;
constexpr int kStride = kPending + 1;
static_assert(kPending > 0 && kPending % 2 == 0, "kPending: a positive even number");

using Staged = StagedRows<kBatch>;

struct RecordRows {
    int32_t* idx;
    float* intg;
    float* dist;
    int cap;
};

// The set segments of a tile's row, ascending; bits of the last word past
// n_segs are not segments.
struct SegmentWalk {
    const int32_t* row;
    int n_words;
    unsigned last_mask;
    int w;
    unsigned bits;

    __device__ SegmentWalk(const int32_t* row_, int n_words_, int n_segs)
        : row(row_), n_words(n_words_),
          last_mask((n_segs % 32) ? (1u << (n_segs % 32)) - 1u : ~0u), w(0),
          bits(n_words_ > 0 ? word(0) : 0u) {}

    __device__ unsigned word(int i) const {
        const unsigned v = static_cast<unsigned>(row[i]);
        return i == n_words - 1 ? v & last_mask : v;
    }

    // The next set segment, -1 when the row is done.
    __device__ int next() {
        while (bits == 0 && w + 1 < n_words) bits = word(++w);
        if (bits == 0) return -1;
        const int s = w * 32 + __ffs(bits) - 1;
        bits &= bits - 1;
        return s;
    }
};

// The quarters a tile's summary and quarter words list, ascending: bit b
// of summary word v names quarter word v * 32 + b; a word id past n_words
// ends the walk (every later one is larger), as the plain version drops
// them.
struct QuarterWalk {
    const int32_t* srow;
    const int32_t* wrow;
    int n_swords, n_words;
    int sw, w;
    unsigned sbits, bits;

    __device__ QuarterWalk(const int32_t* srow_, const int32_t* wrow_, int n_swords_,
                           int n_words_)
        : srow(srow_), wrow(wrow_), n_swords(n_swords_), n_words(n_words_), sw(0), w(0),
          sbits(n_swords_ > 0 ? static_cast<unsigned>(srow_[0]) : 0u), bits(0u) {}

    // The next listed quarter, -1 when the row is done.
    __device__ int next() {
        while (bits == 0) {
            while (sbits == 0) {
                if (sw + 1 >= n_swords) return -1;
                sbits = static_cast<unsigned>(srow[++sw]);
            }
            w = sw * 32 + __ffs(sbits) - 1;
            sbits &= sbits - 1;
            if (w >= n_words) {
                sw = n_swords;
                sbits = 0u;
                return -1;
            }
            bits = static_cast<unsigned>(wrow[w]);
        }
        const int q = w * 32 + __ffs(bits) - 1;
        bits &= bits - 1;
        return q;
    }
};

// One warp's view of its rays' rows: the cursor (hits so far, past the
// capacity too) of this lane's ray, and its records not yet written.
class RowWriter {
  public:
    __device__ RowWriter(const RecordRows& out, int64_t first_row)
        : out_(out), row0_(first_row + (threadIdx.x & ~31)), lane_(threadIdx.x & 31),
          lanes_(min(32, static_cast<int>(blockDim.x - (threadIdx.x & ~31)))),
          members_(lanes_ == 32 ? ~0u : (1u << lanes_) - 1u) {
        constexpr int words = 32 * kStride;
        int* base = reinterpret_cast<int*>(s_pending) + (threadIdx.x >> 5) * 3 * words;
        p_idx_ = base;
        p_intg_ = reinterpret_cast<float*>(base + words);
        p_dist_ = reinterpret_cast<float*>(base + 2 * words);
    }

    // Append the hits whose bits are set in bits, ascending; hit(q, index,
    // integral, distance) gives bit q's record. Called by the whole warp.
    template <typename Hit>
    __device__ __forceinline__ void append(uint32_t bits, Hit hit) {
        for (;;) {
            while (bits && cursor_ < out_.cap && n_ < kPending) {
                const int q = __ffs(bits) - 1;
                bits &= bits - 1;
                const int at = lane_ * kStride + n_;
                hit(q, p_idx_[at], p_intg_[at], p_dist_[at]);
                ++n_;
                ++cursor_;
            }
            if (cursor_ >= out_.cap) {  // past the capacity: counted only
                cursor_ += __popc(bits);
                bits = 0u;
            }
            if (!__any_sync(members_, bits != 0u)) return;
            flush();  // a lane's slots are full
        }
    }

    // The warp's pending records, its rays' in turn: lane i takes the
    // records i, i + lanes, ... of that sequence, so neighbouring lanes
    // write neighbouring columns of a row (a store covers the runs of a
    // few rows). A record's row: the last lane whose exclusive prefix of
    // the pending counts is at most its place (a binary search over lanes).
    __device__ __forceinline__ void flush() {
        __syncwarp(members_);
        int incl = n_;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int v = __shfl_up_sync(members_, incl, d);
            if (lane_ >= d) incl += v;
        }
        const int total = __shfl_sync(members_, incl, lanes_ - 1);
        const int excl = incl - n_;
        for (int e0 = 0; e0 < total; e0 += lanes_) {
            const int e = e0 + lane_;
            int j = 0;
#pragma unroll
            for (int step = 16; step > 0; step >>= 1) {
                const int v = __shfl_sync(members_, excl, min(j + step, lanes_ - 1));
                if (j + step < lanes_ && v <= e) j += step;
            }
            const int k = e - __shfl_sync(members_, excl, j);
            const int c0 = __shfl_sync(members_, col_, j);
            if (e < total) {
                const int64_t at = (row0_ + j) * out_.cap + c0 + k;
                out_.idx[at] = p_idx_[j * kStride + k];
                out_.intg[at] = p_intg_[j * kStride + k];
                out_.dist[at] = p_dist_[j * kStride + k];
            }
        }
        __syncwarp(members_);
        col_ += n_;
        n_ = 0;
    }

    // The rest of the pending records, the sentinels past each row's
    // count (the lanes along the row) and the counts.
    __device__ __forceinline__ void finish(int32_t* counts) {
        if (__any_sync(members_, n_ > 0)) flush();
        const int kept = min(cursor_, out_.cap);
        for (int j = 0; j < lanes_; ++j) {
            const int c0 = __shfl_sync(members_, kept, j);
            const int64_t at = (row0_ + j) * out_.cap;
            for (int c = c0 + lane_; c < out_.cap; c += lanes_) {
                out_.idx[at + c] = -1;
                out_.intg[at + c] = 0.0f;
                out_.dist[at + c] = -1.0f;
            }
        }
        counts[row0_ + lane_] = cursor_;
    }

  private:
    RecordRows out_;
    int64_t row0_;         // the row of the warp's lane 0
    int lane_, lanes_;
    unsigned members_;     // the warp's lanes (a tile may end mid-warp)
    int* p_idx_;
    float* p_intg_;
    float* p_dist_;
    int cursor_ = 0;
    int col_ = 0;          // the column of this ray's first pending record
    int n_ = 0;            // pending records
};

// One tile's records: walk.next() lists its groups of 1 << kShift
// primitives in ascending order.
template <int kShift, typename Walk>
__device__ __forceinline__ void record_tile(Walk& walk, int64_t first_ray,
                                            const float* __restrict__ rays,
                                            const float* __restrict__ prims, int64_t n_pad,
                                            const float* __restrict__ coeffs,
                                            int32_t* __restrict__ counts, const RecordRows& out,
                                            int deg) {
    constexpr int kGroups = kBatch >> kShift;
    __shared__ Staged s[kStageBuffers];
    __shared__ int s_group[kStageBuffers][kGroups];
    __shared__ float s_coeffs[kMaxCoeffs];

    load_coeffs(s_coeffs, coeffs, deg);
    const RaySeg r = load_ray(rays, first_ray + threadIdx.x);
    RowWriter rows(out, first_ray);

    // The next (up to) kGroups listed groups into buffer b; every thread
    // writes the same ids.
    auto stage_next = [&](int b) {
        int* groups = s_group[b];
        int k = 0;
        for (; k < kGroups; ++k) {
            const int g = walk.next();
            if (g < 0) break;
            groups[k] = g;
        }
        if (k > 0) {
            stage_groups(s[b], k, kShift, prims, n_pad,
                         [&](int j) { return static_cast<int64_t>(groups[j]); });
        }
        return k << kShift;
    };
    auto consume = [&](int b, int n) {
        const Staged& sb = s[b];
        const int* groups = s_group[b];
        for (int base = 0; base < n; base += 32) {
            const uint32_t bits = pass_bits32<true>(sb, base, r);
            const int first = (groups[base >> kShift] << kShift) + (base & ((1 << kShift) - 1));
            rows.append(bits, [&](int q, int32_t& id, float& v, float& d) {
                const int i = base + q;
                float bx, by, bz;
                const float b2 = impact(sb.x[i], sb.y[i], sb.z[i], r.ox, r.oy, r.oz, r.dx,
                                        r.dy, r.dz, d, bx, by, bz);
                const float inv_h2 = sb.inv_h2[i];
                v = horner1_integral(b2 * inv_h2, s_coeffs, deg) * inv_h2;
                id = first + q;
            });
        }
    };
    staged_batches<kStageBuffers>(stage_next, consume);
    rows.finish(counts);
}

__global__ void __launch_bounds__(kMaxTile)
records_quarter_kernel(const int32_t* __restrict__ summary, const int32_t* __restrict__ words,
                       const int32_t* __restrict__ order, const float* __restrict__ rays,
                       const float* __restrict__ prims, const float* __restrict__ coeffs,
                       int32_t* __restrict__ counts, RecordRows out, int n_tiles,
                       int n_swords, int n_words, int n_pad, int deg) {
    const int t = order ? order[blockIdx.x] : static_cast<int>(blockIdx.x);
    if (t < 0 || t >= n_tiles) return;
    QuarterWalk walk(summary + static_cast<int64_t>(t) * n_swords,
                     words + static_cast<int64_t>(t) * n_words, n_swords, n_words);
    record_tile<kQuarterShift>(walk, static_cast<int64_t>(t) * blockDim.x, rays, prims, n_pad,
                               coeffs, counts, out, deg);
}

__global__ void __launch_bounds__(kMaxTile)
records_bitmask_kernel(const int32_t* __restrict__ words, const int32_t* __restrict__ order,
                       const float* __restrict__ rays, const float* __restrict__ prims,
                       const float* __restrict__ coeffs, int32_t* __restrict__ counts,
                       RecordRows out, int n_tiles, int n_words, int n_segs, int deg) {
    const int t = order ? order[blockIdx.x] : static_cast<int>(blockIdx.x);
    if (t < 0 || t >= n_tiles) return;
    SegmentWalk walk(words + static_cast<int64_t>(t) * n_words, n_words, n_segs);
    record_tile<kSegShift>(walk, static_cast<int64_t>(t) * blockDim.x, rays, prims,
                           static_cast<int64_t>(n_segs) << kSegShift, coeffs, counts, out, deg);
}

// The pending slots of a block of tile threads (kStride index, integral
// and distance words for each lane of its warps) as its dynamic shared
// memory: *bytes. A tile whose slots and static shared memory do not fit
// the block's limit is refused (at tile 1024, 209 KB of slots fit).
template <typename Kernel>
cudaError_t records_setup(Kernel kernel, int tile, size_t* bytes, int* out) {
    *bytes = static_cast<size_t>((tile + 31) / 32) * 32 * 12 * kStride;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(*bytes));
    if (err != cudaSuccess) return err;
    return trace_kernel_setup(kernel, tile, out, *bytes);
}

bool records_launch_ok(int tile, int cap, int deg, const float* prims) {
    return trace_launch_ok(tile, deg) && deg > 0 && cap >= 1 && aligned16(prims);
}

}  // namespace

// order: i32[n_tiles], block b works on tile order[b] (a permutation of
// [0, n_tiles)); null: block b works on tile b. prims: 16-byte aligned.
extern "C" int grace_records_quarter(const int32_t* summary, const int32_t* words,
                                     const int32_t* order, const float* rays,
                                     const float* prims, const float* coeffs, int32_t* counts,
                                     int32_t* idx, float* intg, float* dist, int n_tiles,
                                     int tile, int n_swords, int n_words, int n_pad, int cap,
                                     int deg, int device, void* stream) {
    if (!records_launch_ok(tile, cap, deg, prims) || n_pad % 128) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    size_t bytes;
    cudaError_t err = cudaSetDevice(device);
    if (err == cudaSuccess) err = records_setup(records_quarter_kernel, tile, &bytes, nullptr);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_tiles > 0) {
        records_quarter_kernel<<<n_tiles, tile, bytes, static_cast<cudaStream_t>(stream)>>>(
            summary, words, order, rays, prims, coeffs, counts,
            RecordRows{idx, intg, dist, cap}, n_tiles, n_swords, n_words, n_pad, deg);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int grace_records_bitmask(const int32_t* words, const int32_t* order,
                                     const float* rays, const float* prims,
                                     const float* coeffs, int32_t* counts, int32_t* idx,
                                     float* intg, float* dist, int n_tiles, int tile,
                                     int n_words, int n_segs, int cap, int deg, int device,
                                     void* stream) {
    if (!records_launch_ok(tile, cap, deg, prims) || n_words != (n_segs + 31) / 32) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    size_t bytes;
    cudaError_t err = cudaSetDevice(device);
    if (err == cudaSuccess) err = records_setup(records_bitmask_kernel, tile, &bytes, nullptr);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_tiles > 0) {
        records_bitmask_kernel<<<n_tiles, tile, bytes, static_cast<cudaStream_t>(stream)>>>(
            words, order, rays, prims, coeffs, counts, RecordRows{idx, intg, dist, cap},
            n_tiles, n_words, n_segs, deg);
    }
    return static_cast<int>(cudaGetLastError());
}

// What a launch of tile threads a block holds (trace_kernel_setup's out).
extern "C" int grace_records_quarter_resources(int* out, int tile, int device, void* stream) {
    (void)stream;
    if (tile < 1 || tile > kMaxTile) return static_cast<int>(cudaErrorInvalidValue);
    size_t bytes;
    cudaError_t err = cudaSetDevice(device);
    if (err == cudaSuccess) err = records_setup(records_quarter_kernel, tile, &bytes, out);
    return static_cast<int>(err);
}

extern "C" int grace_records_bitmask_resources(int* out, int tile, int device, void* stream) {
    (void)stream;
    if (tile < 1 || tile > kMaxTile) return static_cast<int>(cudaErrorInvalidValue);
    size_t bytes;
    cudaError_t err = cudaSetDevice(device);
    if (err == cudaSuccess) err = records_setup(records_bitmask_kernel, tile, &bytes, out);
    return static_cast<int>(err);
}
