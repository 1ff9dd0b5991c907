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
// with cp.async (stage.cuh) and every thread tests its ray against them.
// Block-uniform control flow.
//
// What bounds it: the pair tests, about 18 operations each, and the
// integral for the 2% of pairs that pass (stage.cuh's two phases). A
// block walks its list serially and segment lists are long-tailed, so the
// wrapper launches segment lists longest first (``order``): block b traces
// tile order[b] and writes that tile's rays in place. Quarter lists keep
// the listed order.

#include <cstdint>

#include "common.cuh"
#include "stage.cuh"

namespace {

// One staging buffer: with a second (the next batch in flight, half the
// resident blocks) the bench scene's column densities took 2-3% longer
// and hit counts 2% less (chip_ablation.py); the list read ahead of the
// copies is short.
constexpr int kStageBuffers = 1;

__global__ void __launch_bounds__(kMaxTile)
trace_list_kernel(const int32_t* __restrict__ counts, const int32_t* __restrict__ ids,
                  const int32_t* __restrict__ order, const float* __restrict__ rays,
                  const float* __restrict__ prims, const float* __restrict__ coeffs,
                  float* __restrict__ out, int n_tiles, int max_len, int group_shift,
                  int n_pad, int deg, int mode) {
    __shared__ StagedPrims s[kStageBuffers];
    __shared__ float s_coeffs[kMaxCoeffs];

    const int t = order ? order[blockIdx.x] : static_cast<int>(blockIdx.x);
    if (t < 0 || t >= n_tiles) return;
    const int64_t ray = static_cast<int64_t>(t) * blockDim.x + threadIdx.x;
    load_coeffs(s_coeffs, coeffs, deg);
    const RaySeg r = load_ray(rays, ray);
    const int32_t* row = ids + static_cast<int64_t>(t) * max_len;
    const int n = min(max(counts[t], 0), max_len);
    const int per_batch = kStage >> group_shift;

    int base = 0;  // list entries staged so far
    auto stage_next = [&](StagedPrims& buf) {
        const int k = min(per_batch, n - base);
        if (k <= 0) return 0;
        const int32_t* batch = row + base;
        stage_groups(buf, k, group_shift, prims, n_pad,
                     [&](int j) { return static_cast<int64_t>(__ldg(batch + j)); });
        base += k;
        return k << group_shift;
    };
    float acc = 0.0f;
    float comp = 0.0f;  // Kahan compensation
    trace_staged<kStageBuffers>(s, stage_next, r, mode, s_coeffs, deg, acc, comp);
    out[ray] = acc;
}

}  // namespace

// order: i32[n_tiles], block b traces tile order[b] (a permutation of
// [0, n_tiles)); null: block b traces tile b.
extern "C" int grace_trace_list(const int32_t* counts, const int32_t* ids, const int32_t* order,
                                const float* rays, const float* prims, const float* coeffs,
                                float* out, int n_tiles, int tile, int max_len, int group,
                                int n_pad, int deg, int mode, int device, void* stream) {
    // group: a power of two in [32, kStage] (whole 32-slot test words)
    if (!trace_launch_ok(tile, deg) || group < 32 || group > kStage ||
        (group & (group - 1)) != 0 || max_len < 0 || n_pad % 4 || !aligned16(prims)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err == cudaSuccess) err = trace_kernel_setup(trace_list_kernel, tile, nullptr);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_tiles > 0) {
        trace_list_kernel<<<n_tiles, tile, 0, static_cast<cudaStream_t>(stream)>>>(
            counts, ids, order, rays, prims, coeffs, out, n_tiles, max_len,
            __builtin_ctz(group), n_pad, deg, mode);
    }
    return static_cast<int>(cudaGetLastError());
}

// What a launch of tile threads a block holds (trace_kernel_setup's out).
extern "C" int grace_trace_list_resources(int* out, int tile, int device, void* stream) {
    (void)stream;
    if (tile < 1 || tile > kMaxTile) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err == cudaSuccess) err = trace_kernel_setup(trace_list_kernel, tile, out);
    return static_cast<int>(err);
}
