// Fused SPH trace over quarter-culled ray tiles.
//
// Replaces grace_tpu/trace/pallas_kernel.py::_trace_tile_kernel_quarter
// (VMEM-resident slabs) and ::_trace_tile_kernel_quarter_stream (slabs
// streamed from HBM): here the particle slabs live in device memory for any
// scene size, so one kernel serves both.
//
// Layout: one block per ray tile, one thread per ray (tile <= 1024). The
// block reads its own row of the summary words and of the quarter words and
// walks them in place, in ascending quarter order: nonzero summary bits,
// then that word's set bits. No quarter list is built: at a million
// particles a tile has 32,768 possible quarters.
//
// What bounds it: the pair tests, about 18 operations each, plus the
// integral for the pairs that pass (stage.cuh's two phases); every ray of
// a tile tests every primitive of every listed quarter. The slabs (8 x
// N_pad f32, 33.6 MB at a million particles) fit the 50 MB L2, so after
// the first tiles the staging loads come from L2.
// What the design does about it: all 32 quarters a word lists are staged
// in shared memory at once (stage.cuh: 1024 primitives, 20 KB), so one
// pair of barriers serves up to 1024 primitives. The control flow is
// block-uniform, so no warp diverges on the mask walk.

#include <cstdint>

#include "common.cuh"
#include "stage.cuh"

namespace {

constexpr int kQuarterPrims = 32;  // primitives per quarter; 32 quarters a word

__global__ void trace_quarter_kernel(const int32_t* __restrict__ summary,
                                     const int32_t* __restrict__ words,
                                     const float* __restrict__ rays,
                                     const float* __restrict__ prims,
                                     const float* __restrict__ coeffs,
                                     float* __restrict__ out, int n_swords,
                                     int n_words, int n_pad, int deg,
                                     int mode) {
    __shared__ StagedPrims s;
    __shared__ float s_coeffs[kMaxCoeffs];

    const int tile = blockDim.x;
    const int tid = threadIdx.x;
    const int64_t ray = static_cast<int64_t>(blockIdx.x) * tile + tid;
    load_coeffs(s_coeffs, coeffs, deg);
    const RaySeg r = load_ray(rays, ray);
    const int32_t* srow = summary + static_cast<int64_t>(blockIdx.x) * n_swords;
    const int32_t* wrow = words + static_cast<int64_t>(blockIdx.x) * n_words;

    float acc = 0.0f;
    float comp = 0.0f;  // Kahan compensation
    for (int sw = 0; sw < n_swords; ++sw) {
        unsigned sbits = static_cast<unsigned>(srow[sw]);
        while (sbits) {
            const int w = sw * 32 + __ffs(sbits) - 1;
            sbits &= sbits - 1;
            if (w >= n_words) break;
            const unsigned word = static_cast<unsigned>(wrow[w]);
            if (word == 0) continue;
            const int n_prims = __popc(word) * kQuarterPrims;
            __syncthreads();  // the previous word's primitives are consumed
            for (int i = tid; i < n_prims; i += tile) {
                unsigned m = word;  // the (i / 32)-th set bit of word
                for (int k = i / kQuarterPrims; k > 0; --k) m &= m - 1;
                const int q = w * 32 + __ffs(m) - 1;
                stage_prim(s, i, prims, n_pad,
                           static_cast<int64_t>(q) * kQuarterPrims + (i % kQuarterPrims));
            }
            __syncthreads();
            accumulate_staged(s, n_prims, r, mode, s_coeffs, deg, acc, comp);
        }
    }
    out[ray] = acc;
}

}  // namespace

extern "C" int grace_trace_quarter(const int32_t* summary, const int32_t* words,
                                   const float* rays, const float* prims,
                                   const float* coeffs, float* out, int n_tiles,
                                   int tile, int n_swords, int n_words,
                                   int n_pad, int deg, int mode, int device,
                                   void* stream) {
    if (!trace_launch_ok(tile, deg)) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_tiles > 0) {
        trace_quarter_kernel<<<n_tiles, tile, 0, static_cast<cudaStream_t>(stream)>>>(
            summary, words, rays, prims, coeffs, out, n_swords, n_words, n_pad,
            deg, mode);
    }
    return static_cast<int>(cudaGetLastError());
}
