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
// of word w of the block's row is segment w*32+s (primitives
// [128 (w*32+s), 128 (w*32+s) + 128)). Every thread walks the row flat, in
// ascending order, and gathers the next set segments, up to 8 (1024
// primitives), across word boundaries; the block stages them (stage.cuh)
// and every thread tests its ray against them. All threads compute the
// same walk, so the control flow is block-uniform. Bits of the last word
// past n_segs are not segments and are never read as such.
//
// What bounds it: the pair tests, as in trace_quarter.cu; culling at 128
// primitives lists about twice the pairs the quarter route does on the
// bench scene. The word walk is cheap beside it: at a million particles a
// row is 257 words, read as broadcasts from L1.

#include <cstdint>

#include "common.cuh"
#include "stage.cuh"

namespace {

constexpr int kSeg = 128;                 // primitives per segment
constexpr int kBatch = kStage / kSeg;     // segments staged per batch

// Word w of a row, with the bits past the last segment cleared.
__device__ __forceinline__ unsigned row_word(const int32_t* __restrict__ row,
                                             int w, int n_words,
                                             unsigned last_mask) {
    const unsigned v = static_cast<unsigned>(row[w]);
    return w == n_words - 1 ? v & last_mask : v;
}

__global__ void trace_bitmask_kernel(const int32_t* __restrict__ words,
                                     const float* __restrict__ rays,
                                     const float* __restrict__ prims,
                                     const float* __restrict__ coeffs,
                                     float* __restrict__ out, int n_words,
                                     int n_segs, int deg, int mode) {
    __shared__ StagedPrims s;
    __shared__ float s_coeffs[kMaxCoeffs];

    const int tile = blockDim.x;
    const int tid = threadIdx.x;
    const int64_t ray = static_cast<int64_t>(blockIdx.x) * tile + tid;
    load_coeffs(s_coeffs, coeffs, deg);
    const RaySeg r = load_ray(rays, ray);
    const int32_t* row = words + static_cast<int64_t>(blockIdx.x) * n_words;
    const int64_t n_pad = static_cast<int64_t>(n_segs) * kSeg;
    const unsigned last_mask = (n_segs % 32) ? (1u << (n_segs % 32)) - 1u : ~0u;

    float acc = 0.0f;
    float comp = 0.0f;  // Kahan compensation
    int w = 0;
    unsigned bits = n_words > 0 ? row_word(row, 0, n_words, last_mask) : 0u;
    while (true) {
        // The next (up to) kBatch set segments; unrolled so segs stays in
        // registers.
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
        if (k == 0) break;
        const int n_prims = k * kSeg;
        __syncthreads();  // the previous batch is consumed
        for (int i = tid; i < n_prims; i += tile) {
            const int j = i / kSeg;
            int seg = segs[0];
#pragma unroll
            for (int jj = 1; jj < kBatch; ++jj) {
                if (j == jj) seg = segs[jj];
            }
            stage_prim(s, i, prims, n_pad,
                       static_cast<int64_t>(seg) * kSeg + (i % kSeg));
        }
        __syncthreads();
        accumulate_staged(s, n_prims, r, mode, s_coeffs, deg, acc, comp);
    }
    out[ray] = acc;
}

}  // namespace

extern "C" int grace_trace_bitmask(const int32_t* words, const float* rays,
                                   const float* prims, const float* coeffs,
                                   float* out, int n_tiles, int tile,
                                   int n_words, int n_segs, int deg, int mode,
                                   int device, void* stream) {
    if (!trace_launch_ok(tile, deg) || n_words != (n_segs + 31) / 32) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_tiles > 0) {
        trace_bitmask_kernel<<<n_tiles, tile, 0, static_cast<cudaStream_t>(stream)>>>(
            words, rays, prims, coeffs, out, n_words, n_segs, deg, mode);
    }
    return static_cast<int>(cudaGetLastError());
}
