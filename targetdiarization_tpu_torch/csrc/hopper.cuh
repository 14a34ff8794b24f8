// Hopper (sm_90a) primitives shared by the port's tensor-core kernels
// (FFConvM, FLASH): shared-memory descriptors and warpgroup products
// (wgmma, bf16 or fp16 inputs), their fences, cp.async, and the bf16 and
// fp16 splits that carry float32 operands through the 16-bit tensor cores.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace td {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (the leading offset is unused in this mode). A tile is
// rows of 128 bytes (64 bf16 of depth), its 16-byte chunk c of row r at
// r * 128 + ((c ^ (r & 7)) << 4), its base 1024-byte aligned; the k16 step
// j of a chunk starts at base + 32 * j.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
           (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

#define TD_REGS64                                                                          \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "             \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "    \
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "    \
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define TD_REGS32                                                                          \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "             \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define TD_OUT8(i)                                                                         \
    "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),             \
        "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// acc (64 x 128 f32 over the warpgroup) = A (64 x 16) . B (128 x 16)^T, plus acc
// unless scale_d is 0 (which starts a sum without zeroing the registers);
// A and B bf16, or fp16 with kHalf
template <bool kHalf = false>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b,
                                                 int scale_d = 1) {
    if constexpr (kHalf) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " TD_REGS64
            ", %64, %65, p, 1, 1, 0, 0;\n}\n"
            : TD_OUT8(0), TD_OUT8(8), TD_OUT8(16), TD_OUT8(24), TD_OUT8(32), TD_OUT8(40),
              TD_OUT8(48), TD_OUT8(56)
            : "l"(a), "l"(b), "r"(scale_d));
    } else {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TD_REGS64
            ", %64, %65, p, 1, 1, 0, 0;\n}\n"
            : TD_OUT8(0), TD_OUT8(8), TD_OUT8(16), TD_OUT8(24), TD_OUT8(32), TD_OUT8(40),
              TD_OUT8(48), TD_OUT8(56)
            : "l"(a), "l"(b), "r"(scale_d));
    }
}

// acc (64 x 64 f32 over the warpgroup) = A (64 x 16) . B (64 x 16)^T, plus acc
// unless scale_d is 0; A and B bf16, or fp16 with kHalf
template <bool kHalf = false>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a, uint64_t b,
                                                int scale_d = 1) {
    if constexpr (kHalf) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " TD_REGS32
            ", %32, %33, p, 1, 1, 0, 0;\n}\n"
            : TD_OUT8(0), TD_OUT8(8), TD_OUT8(16), TD_OUT8(24)
            : "l"(a), "l"(b), "r"(scale_d));
    } else {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TD_REGS32
            ", %32, %33, p, 1, 1, 0, 0;\n}\n"
            : TD_OUT8(0), TD_OUT8(8), TD_OUT8(16), TD_OUT8(24)
            : "l"(a), "l"(b), "r"(scale_d));
    }
}

#undef TD_OUT8
#undef TD_REGS32
#undef TD_REGS64

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// keeps the compiler from touching the accumulators before the wait
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 16 bytes global -> shared, the first `bytes` of them read, the rest zero
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }
// all but the latest committed group
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }
// generic-proxy writes to shared memory made visible to wgmma's async proxy
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
    __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) = hi + lo with hi, lo bf16 pairs
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 hf = __bfloat1622float2(h);
    hi = *reinterpret_cast<uint32_t*>(&h);
    lo = pack_bf16(a - hf.x, b - hf.y);
}

// (a, b) = hi + lo with hi, lo fp16 pairs: 11 bits each, so hi + lo
// keeps 22 of a float32's 24 where a and b lie within fp16's range
__device__ __forceinline__ void split_f16(float a, float b, uint32_t& hi, uint32_t& lo) {
    __half2 h = __floats2half2_rn(a, b);
    const float2 hf = __half22float2(h);
    hi = *reinterpret_cast<uint32_t*>(&h);
    __half2 l = __floats2half2_rn(a - hf.x, b - hf.y);
    lo = *reinterpret_cast<uint32_t*>(&l);
}

}  // namespace td
