// Asynchronous global -> shared copies and named-barrier votes, shared by
// the kernels that stage ahead (tri.cu, render.cu, stage.cuh's walk,
// splat_sortfree.cu's backward).
//
// cp.async copies 16 bytes a thread without passing through registers; a
// thread commits its copies as a group and waits until at most N of its
// groups are in flight. The data are visible to the other threads of a
// block (or warp group) after that wait and a barrier over them.
#pragma once

#include <cstdint>

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

// The same for one 4-byte element (any 4-byte aligned addresses; cached
// in L1 as well: .ca is the only form below 16 bytes).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Named barrier 1 + slot (slot 0-3) over `threads` threads, a multiple of
// 32. The ids are immediates: with an id in a register the compiler
// reserves all 16 of a block's barriers, and an SM holds only 64, which
// caps it at four such blocks.
#define GRACE_NAMED_SYNC(id) \
    asm volatile("barrier.sync " #id ", %0;\n" ::"r"(threads) : "memory")
__device__ __forceinline__ void named_sync(int slot, int threads) {
    switch (slot) {
        case 0: GRACE_NAMED_SYNC(1); break;
        case 1: GRACE_NAMED_SYNC(2); break;
        case 2: GRACE_NAMED_SYNC(3); break;
        default: GRACE_NAMED_SYNC(4); break;
    }
}
#undef GRACE_NAMED_SYNC

// The same barrier, returning whether `pred` holds on any of the threads.
#define GRACE_NAMED_ANY(id)                          \
    asm volatile(                                    \
        "{\n"                                        \
        "  .reg .pred p, q;\n"                       \
        "  setp.ne.s32 p, %1, 0;\n"                  \
        "  barrier.red.or.pred q, " #id ", %2, p;\n" \
        "  selp.s32 %0, 1, 0, q;\n"                  \
        "}\n"                                        \
        : "=r"(out)                                  \
        : "r"(static_cast<int>(pred)), "r"(threads)  \
        : "memory")
__device__ __forceinline__ bool named_any(int slot, int threads, bool pred) {
    int out;
    switch (slot) {
        case 0: GRACE_NAMED_ANY(1); break;
        case 1: GRACE_NAMED_ANY(2); break;
        case 2: GRACE_NAMED_ANY(3); break;
        default: GRACE_NAMED_ANY(4); break;
    }
    return out != 0;
}
#undef GRACE_NAMED_ANY

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }
