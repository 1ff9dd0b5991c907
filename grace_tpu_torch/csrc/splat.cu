// Separable-basis splat of bucketed SPH particles into a column-density image.
//
// Replaces grace_tpu/trace/splat.py::_splat_kernel. For a parallel ray grid
// the image is a sum of per-instance footprints, each approximated by a
// rank-K separable basis: pixel (y, x) of a key's patch gets
//     sum_inst sum_k A_k(t_y) * B_k(t_x) * scale,
//     A_k(t) = (1 - t) q_k(t),  t = min(((y - pv) * invh)^2, 1),
// (B likewise in x, with its own coefficients).
//
// Layout: kRowParts blocks per key = (row tile, column band), each owning
// tile_w / kRowParts rows of the key's tile_w x band output patch, which
// no other block touches, so the image needs no atomics and no second
// pass. A block reads its key's slab_lo, n_slabs, first and last and takes
// the instances of its slabs whose global index is in [first, last) (a
// band's first and last slabs may hold its neighbours' instances), in
// ascending order, sub at a time: each batch's parameters are loaded one
// batch ahead, its footprints found (two threads an instance, rows and
// columns), and splat_common.cuh's run_batch adds its terms into the
// block's rows; an instance whose footprint misses them costs only its
// ranges. Cutting the patch into rows spreads a busy key over several SMs
// (its work is serial within a block) and keeps each pixel's sum whole.
// Blocks take keys in the wrapper's order (most instances first: a busy
// key's blocks start while the card is empty and the light keys fill in
// around them).
//
// What bounds it, and what the design does about it: splat_common.cuh. The
// image is bit-equal to the dense contraction over the whole patch
// (splat_dense.cu).

#include <cstdint>

#include "common.cuh"
#include "splat_common.cuh"

namespace {

using splat::kThreads;
using splat::kRows;

// Blocks a key's patch is cut into along its rows (each adds its rows'
// terms; the others' instances cost it only their footprint ranges).
constexpr int kRowParts = 4;

template <int NT, int DEG>  // tasks a warp holds; the basis degree (0: at run time)
__global__ void __launch_bounds__(kThreads)
splat_kernel(const int32_t* __restrict__ slab_lo, const int32_t* __restrict__ n_slabs,
             const int32_t* __restrict__ first, const int32_t* __restrict__ last,
             const int32_t* __restrict__ order, const float* __restrict__ xcols,
             const float* __restrict__ yrows, const float* __restrict__ slabs,
             const float* __restrict__ a_coeffs, const float* __restrict__ b_coeffs,
             float* __restrict__ out, int nbx, int rows, int parts, int band, int chunk,
             int width, int n_slab_total, int rank, int deg, int sub) {
    extern __shared__ float4 smem[];
    const splat::Layout l = splat::carve(smem, rows, band, rank, deg, sub);
    const int n_c = rank * (deg + 1);
    const int key = order != nullptr ? order[blockIdx.x / parts] : blockIdx.x / parts;
    const int row0 = (key / nbx) * rows * parts + (blockIdx.x % parts) * rows;
    const int col0 = (key % nbx) * band;
    const int tid = threadIdx.x;
    for (int i = tid; i < rows; i += kThreads) l.ys[i] = yrows[row0 + i];
    for (int i = tid; i < band; i += kThreads) l.xs[i] = xcols[col0 + i];
    for (int i = tid; i < n_c; i += kThreads) {
        l.ca[i] = a_coeffs[i];
        l.cb[i] = b_coeffs[i];
    }
    // the instances of slabs [s_lo, s_lo + n_s) (and of the slab array) in
    // [first, last): every half of every slab the dense loop walks
    const int64_t per_slab = 2 * static_cast<int64_t>(chunk);
    const int s_lo = slab_lo[key];
    const int s_hi = min(s_lo + max(n_slabs[key], 0), n_slab_total);
    const int64_t g_lo = first[key] > s_lo * per_slab ? first[key] : s_lo * per_slab;
    const int64_t g_hi = last[key] < s_hi * per_slab ? last[key] : s_hi * per_slab;
    __syncthreads();
    if (tid == 0) splat::finish_patch(l, rows, band);

    float acc[NT][kRows];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[j][r] = 0.0f;
    }
    // instance g's pu, pv, invh, scale: slab g / per_slab, rows 4 * half
    auto load = [&](int64_t g) {
        const int64_t s = g / per_slab;
        const int64_t within = g - s * per_slab;
        const int half = static_cast<int>(within / chunk);
        const float* blk = slabs + (s * 8 + 4 * half) * chunk + (within - half * chunk);
        return make_float4(blk[0], blk[chunk], blk[2 * chunk], blk[3 * chunk]);
    };
    // thread t loads instance t % sub of each batch, one batch ahead, and
    // finds its rows (t < sub) or columns (sub <= t < 2 sub)
    const int mine = tid % sub;
    const int axis = tid / sub;
    float4 next = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (axis < 2 && g_lo + mine < g_hi) next = load(g_lo + mine);
    __syncthreads();  // the patch's centres and steps
    for (int64_t base = g_lo; base < g_hi; base += sub) {
        const int cnt = g_hi - base < sub ? static_cast<int>(g_hi - base) : sub;
        if (axis < 2 && mine < cnt) {
            if (axis == 0) l.prm[mine] = next;
            splat::footprint_axis(l, rows, band, mine, axis, next);
            if (base + sub + mine < g_hi) next = load(base + sub + mine);
        }
        splat::run_batch<NT, DEG>(l, cnt, rows, band, rank, deg, acc);
    }
    splat::store_patch<NT>(acc, out, row0, col0, width, rows, band);
}

// Blocks a key's patch is cut into: kRowParts where tile_w allows it.
int row_parts(int tile_w) { return tile_w % kRowParts == 0 ? kRowParts : 1; }

size_t smem_bytes(int tile_w, int band, int rank, int deg, int sub) {
    return splat::layout_bytes(tile_w / row_parts(tile_w), band, rank, deg, sub, 0);
}

// The kernel instance for a patch and degree, or nullptr if the patch has
// too many tasks.
using Kernel = void (*)(const int32_t*, const int32_t*, const int32_t*, const int32_t*,
                        const int32_t*, const float*, const float*, const float*, const float*,
                        const float*, float*, int, int, int, int, int, int, int, int, int, int);

template <int DEG>
Kernel kernel_for_nt(int nt) {
    switch (nt) {
        case 1: return splat_kernel<1, DEG>;
        case 2: return splat_kernel<2, DEG>;
        case 4: return splat_kernel<4, DEG>;
        case 8: return splat_kernel<8, DEG>;
        case 16: return splat_kernel<16, DEG>;
        default: return nullptr;
    }
}

Kernel kernel_for(int tile_w, int band, int deg) {
    const int nt = splat::tasks_per_warp(tile_w / row_parts(tile_w), band);
    return deg == 8 ? kernel_for_nt<8>(nt)
                    : deg == 10 ? kernel_for_nt<10>(nt) : kernel_for_nt<0>(nt);
}

bool valid(int tile_w, int band, int rank, int deg, int sub) {
    return tile_w >= 1 && band >= 1 && rank >= 1 && deg >= 0 && sub >= 1 &&
           sub <= splat::kMaxBatch && kernel_for(tile_w, band, deg) != nullptr &&
           smem_bytes(tile_w, band, rank, deg, sub) <= splat::kMaxShared;
}

}  // namespace

// Launches parts = kRowParts (1 where it does not divide tile_w) blocks
// per key, blocks b * parts .. b * parts + parts - 1 on key order[b] (order
// null: key b). The patch is tile_w x band; sub instances a batch (at most
// 128, their factors within 227 KB of shared memory).
extern "C" int grace_splat(const int32_t* slab_lo, const int32_t* n_slabs,
                           const int32_t* first, const int32_t* last, const int32_t* order,
                           const float* xcols, const float* yrows, const float* slabs,
                           const float* a_coeffs, const float* b_coeffs, float* out, int n_keys,
                           int nbx, int tile_w, int band, int chunk, int width,
                           int n_slab_total, int rank, int deg, int sub, int device,
                           void* stream) {
    if (!valid(tile_w, band, rank, deg, sub) || chunk < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_keys == 0) return static_cast<int>(cudaGetLastError());
    const Kernel kernel = kernel_for(tile_w, band, deg);
    const size_t smem = smem_bytes(tile_w, band, rank, deg, sub);
    err = splat::kernel_setup(kernel, smem, nullptr);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int parts = row_parts(tile_w);
    kernel<<<n_keys * parts, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        slab_lo, n_slabs, first, last, order, xcols, yrows, slabs, a_coeffs, b_coeffs, out,
        nbx, tile_w / parts, parts, band, chunk, width, n_slab_total, rank, deg, sub);
    return static_cast<int>(cudaGetLastError());
}

// What a launch for this patch and batch holds (splat::kernel_setup's out).
extern "C" int grace_splat_resources(int* out, int tile_w, int band, int rank, int deg, int sub,
                                     int device, void* stream) {
    (void)stream;
    if (!valid(tile_w, band, rank, deg, sub)) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err == cudaSuccess) {
        err = splat::kernel_setup(kernel_for(tile_w, band, deg),
                                  smem_bytes(tile_w, band, rank, deg, sub), out);
    }
    return static_cast<int>(err);
}
