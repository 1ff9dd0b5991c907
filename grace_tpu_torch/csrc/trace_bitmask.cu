// Fused SPH trace over bitmask-culled ray tiles, 128-primitive segments.
//
// Replaces grace_tpu/trace/pallas_kernel.py::_trace_tile_kernel_bitmask
// (VMEM-resident slabs) and ::_trace_tile_kernel_bitmask_stream (slabs
// streamed from HBM), the default broadphase="dense" route: here the slabs
// live in device memory for any scene, so one kernel serves both. The TPU
// kernels first decoded a tile's words into a segment list in scalar
// memory; this block walks its words in place instead.
//
// Layout: one block per ray tile, one thread per ray (tile <= 1024). Bit s
// of word w of a tile's row is segment w*32+s (primitives [128 (w*32+s),
// 128 (w*32+s) + 128)). Every thread walks the row flat, in ascending
// order, and gathers the next set segments, up to 8 (1024 primitives),
// across word boundaries; the block stages them with cp.async (stage.cuh),
// one batch ahead, and every thread tests its ray against them. All
// threads compute the same walk, so the control flow is block-uniform.
// Bits of the last word past n_segs are not segments and are never read
// as such.
//
// What bounds it: the pair tests, about 18 operations each, and the
// integral for the 2% of pairs that pass (stage.cuh's two phases). The
// word walk is cheap beside it: at a million particles a row is 257 words,
// read as broadcasts from L1. Rows list from none to hundreds of segments
// on the bench scene, and a block walks its row serially, so the wrapper
// launches the tiles longest row first (``order``): block b traces tile
// order[b] and writes that tile's rays in place.

#include <cstdint>

#include "common.cuh"
#include "stage.cuh"

namespace {

constexpr int kSegShift = 7;
constexpr int kSeg = 1 << kSegShift;      // primitives per segment
constexpr int kBatch = kStage / kSeg;     // segments staged per batch
// Two staging buffers: the next batch's word walk and copies overlap this
// one's tests. On the bench scene (chip_ablation.py) hit counts take 11%
// less time than with one, column densities 0-7% less, although an SM
// then holds 5 blocks instead of 10.
constexpr int kStageBuffers = 2;

// Word w of a row, with the bits past the last segment cleared.
__device__ __forceinline__ unsigned row_word(const int32_t* __restrict__ row,
                                             int w, int n_words,
                                             unsigned last_mask) {
    const unsigned v = static_cast<unsigned>(row[w]);
    return w == n_words - 1 ? v & last_mask : v;
}

__global__ void __launch_bounds__(kMaxTile)
trace_bitmask_kernel(const int32_t* __restrict__ words, const int32_t* __restrict__ order,
                     const float* __restrict__ rays, const float* __restrict__ prims,
                     const float* __restrict__ coeffs, float* __restrict__ out, int n_tiles,
                     int n_words, int n_segs, int deg, int mode) {
    __shared__ StagedPrims s[kStageBuffers];
    __shared__ float s_coeffs[kMaxCoeffs];

    const int t = order ? order[blockIdx.x] : static_cast<int>(blockIdx.x);
    if (t < 0 || t >= n_tiles) return;
    const int64_t ray = static_cast<int64_t>(t) * blockDim.x + threadIdx.x;
    load_coeffs(s_coeffs, coeffs, deg);
    const RaySeg r = load_ray(rays, ray);
    const int32_t* row = words + static_cast<int64_t>(t) * n_words;
    const int64_t n_pad = static_cast<int64_t>(n_segs) * kSeg;
    const unsigned last_mask = (n_segs % 32) ? (1u << (n_segs % 32)) - 1u : ~0u;

    int w = 0;
    unsigned bits = n_words > 0 ? row_word(row, 0, n_words, last_mask) : 0u;
    // The next (up to) kBatch set segments into buf; unrolled so segs
    // stays in registers.
    auto stage_next = [&](StagedPrims& buf) {
        int segs[kBatch];
        int k = 0;
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
            while (bits == 0 && w + 1 < n_words) {
                ++w;
                bits = row_word(row, w, n_words, last_mask);
            }
            segs[j] = 0;
            if (bits != 0) {
                segs[j] = w * 32 + __ffs(bits) - 1;
                bits &= bits - 1;
                k = j + 1;
            }
        }
        if (k > 0) {
            stage_groups(buf, k, kSegShift, prims, n_pad, [&](int j) {
                int seg = segs[0];
#pragma unroll
                for (int jj = 1; jj < kBatch; ++jj) {
                    if (j == jj) seg = segs[jj];
                }
                return static_cast<int64_t>(seg);
            });
        }
        return k * kSeg;
    };
    float acc = 0.0f;
    float comp = 0.0f;  // Kahan compensation
    trace_staged<kStageBuffers>(s, stage_next, r, mode, s_coeffs, deg, acc, comp);
    out[ray] = acc;
}

}  // namespace

// order: i32[n_tiles], block b traces tile order[b] (a permutation of
// [0, n_tiles)); null: block b traces tile b.
extern "C" int grace_trace_bitmask(const int32_t* words, const int32_t* order,
                                   const float* rays, const float* prims,
                                   const float* coeffs, float* out, int n_tiles, int tile,
                                   int n_words, int n_segs, int deg, int mode,
                                   int device, void* stream) {
    if (!trace_launch_ok(tile, deg) || n_words != (n_segs + 31) / 32 || !aligned16(prims)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err == cudaSuccess) err = trace_kernel_setup(trace_bitmask_kernel, tile, nullptr);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_tiles > 0) {
        trace_bitmask_kernel<<<n_tiles, tile, 0, static_cast<cudaStream_t>(stream)>>>(
            words, order, rays, prims, coeffs, out, n_tiles, n_words, n_segs, deg, mode);
    }
    return static_cast<int>(cudaGetLastError());
}

// What a launch of tile threads a block holds (trace_kernel_setup's out).
extern "C" int grace_trace_bitmask_resources(int* out, int tile, int device, void* stream) {
    (void)stream;
    if (tile < 1 || tile > kMaxTile) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err == cudaSuccess) err = trace_kernel_setup(trace_bitmask_kernel, tile, out);
    return static_cast<int>(err);
}
