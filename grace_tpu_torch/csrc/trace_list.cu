// Fused SPH trace over per-tile primitive-group lists.
//
// Replaces four kernels of grace_tpu/trace/pallas_kernel.py that consume a
// per-tile list of primitive groups of G primitives each:
//   _trace_tile_kernel_qlist      G = 32  (quarter lists, broadphase="qlist")
//   _trace_tile_kernel_resident   G = 128 (segment lists: "list", "pallas",
//   _trace_tile_kernel_stream     G = 128  "xla", "dense" with subtiles > 1)
//   _trace_tile_kernel_subtiled   G = 128, launched on the fine tiles
// The resident/stream split was the TPU's VMEM limit: the slabs stay in
// device memory here for any scene. The subtiled kernel ran S fine tiles
// per program only to amortise per-program overhead; one block per fine
// tile gives the same output. The qlist kernel padded its lists to groups
// of four quarters with an appended all-zero slab; here only the first
// count ids of a row are read, so no padding slab is needed.
//
// Layout: one block per ray tile, one thread per ray (tile <= 1024). Row t
// of ids lists group ids g (primitives [G g, G g + G)); the block reads
// its first min(count, max_len) ids, stages kStage / G groups at a time
// (stage.cuh) and every thread tests its ray against them. Block-uniform
// control flow.
//
// What bounds it: the pair tests, as in trace_quarter.cu. With the list
// built beforehand, a tile costs nothing before its first pair test.

#include <cstdint>

#include "common.cuh"
#include "stage.cuh"

namespace {

__global__ void trace_list_kernel(const int32_t* __restrict__ counts,
                                  const int32_t* __restrict__ ids,
                                  const float* __restrict__ rays,
                                  const float* __restrict__ prims,
                                  const float* __restrict__ coeffs,
                                  float* __restrict__ out, int max_len,
                                  int group_shift, int n_pad, int deg,
                                  int mode) {
    __shared__ StagedPrims s;
    __shared__ float s_coeffs[kMaxCoeffs];

    const int tile = blockDim.x;
    const int tid = threadIdx.x;
    const int64_t ray = static_cast<int64_t>(blockIdx.x) * tile + tid;
    load_coeffs(s_coeffs, coeffs, deg);
    const RaySeg r = load_ray(rays, ray);
    const int32_t* row = ids + static_cast<int64_t>(blockIdx.x) * max_len;
    const int n = min(max(counts[blockIdx.x], 0), max_len);
    const int group = 1 << group_shift;
    const int per_batch = kStage >> group_shift;

    float acc = 0.0f;
    float comp = 0.0f;  // Kahan compensation
    for (int base = 0; base < n; base += per_batch) {
        const int n_prims = min(per_batch, n - base) << group_shift;
        __syncthreads();  // the previous batch is consumed
        for (int i = tid; i < n_prims; i += tile) {
            const int64_t g = __ldg(row + base + (i >> group_shift));
            stage_prim(s, i, prims, n_pad, (g << group_shift) + (i & (group - 1)));
        }
        __syncthreads();
        accumulate_staged(s, n_prims, r, mode, s_coeffs, deg, acc, comp);
    }
    out[ray] = acc;
}

}  // namespace

extern "C" int grace_trace_list(const int32_t* counts, const int32_t* ids,
                                const float* rays, const float* prims,
                                const float* coeffs, float* out, int n_tiles,
                                int tile, int max_len, int group, int n_pad,
                                int deg, int mode, int device, void* stream) {
    // group: a power of two in [1, kStage]
    if (!trace_launch_ok(tile, deg) || group < 1 || group > kStage ||
        (group & (group - 1)) != 0 || max_len < 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_tiles > 0) {
        trace_list_kernel<<<n_tiles, tile, 0, static_cast<cudaStream_t>(stream)>>>(
            counts, ids, rays, prims, coeffs, out, max_len, __builtin_ctz(group),
            n_pad, deg, mode);
    }
    return static_cast<int>(cudaGetLastError());
}
