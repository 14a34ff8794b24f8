// Grouped FLASH attention: the gated epilogue of MossFormer2's FlashBlock,
// and the two-output form without the linear term and the gate.
//
// The gated form replaces the TPU kernel targetdiarization_tpu/ops/pallas/
// flash.py (_gated_kernel, _gated_pallas). Per (batch b, group):
//   A     = relu(q k^T / g)^2 * mask[key]   (f32), then rounded to v's type
//   att_v = A v + lq lin_kv                 (f32 accumulation)
//   att_u = A u + lq lin_ku
//   out   = att_u * v * sigmoid(att_v * u)  (f32), stored in v's type
// q, k, lq: (B, G, g, d); v, u, out: (B, G, g, e); mask: (B, G, 1, g)
// over key columns; lin_kv, lin_ku: (B, d, e).
//
// The two-output form (td_flash_group) replaces _kernel / _flash_pallas of
// the same file (public op flash_group_attention): with the same A,
//   out_v = A v,  out_u = A u              (f32 accumulation), stored in v's type.
// It is the same kernel compiled without the lq rows and the gate.
//
// What bounds it on an H100: at 512/24 (g 256, d 128, e 1024) a group
// does 2 g^2 d + 4 g (g + d) e operations on g (3 d + 3 e + 1) elements
// read or written, about 240 operations a byte in bf16: under the card's
// ~295, so in bf16 the bytes bound it (narrowly). In float32 this design
// runs three bf16 passes on the tensor cores, so its bound is three times
// the bf16 operations (about 0.20 ms for B 2, G 79 against 0.17 ms of
// bytes), far under the 0.99 ms the float32 FMA units would need.
//
// Design: both products on the tensor cores (wgmma, sm_90a). float32 goes
// through a bf16 split, as in ffconvm.cu: every operand is split
// x = x_hi + x_lo (both bf16) where it enters shared memory, and each
// product runs three passes, hi.hi + hi.lo + lo.hi, into float32
// accumulators; the lo.lo pass is left out (tests/test_torch_kernels.py::
// test_flash_split_passes_meet_float32_limit holds three passes within the
// 1e-4 limit at the main path's shape and shows one pass missing it). TF32
// would keep 10 bits of mantissa, too few for that limit. bfloat16 inputs
// run one pass, as the TPU kernel does.
//
// One block of two warpgroups (256 threads) per (batch, group, 64 query
// rows); neither A nor att_v / att_u goes to device memory.
//   Stage 1: q's 64 rows and all g rows of k are split into shared memory
//   in the 128-byte-swizzled K-major layout that wgmma reads; warpgroup w
//   takes key blocks w and w + 2 (64 keys each, m64n64k16) and runs
//   S = q k^T over d. relu^2, 1/g and the key mask are applied in
//   registers, A is rounded to v's type, split, and written as the A
//   operand of stage 2 (over q's tiles), beside lq's split rows as the last
//   d columns of the depth: [A | lq] is 64 x (g + d), 96 KB as hi + lo at
//   the main shape.
//   Stage 2: e is walked in slices of 128 columns; the depth (g keys, then
//   the d rows of lin_kv / lin_ku) streams through a two-stage ring of
//   64-deep chunks. A chunk holds, for each warpgroup's 64 columns, those
//   columns of [v ; lin_kv] and then of [u ; lin_ku], so that one m64n128k16
//   product gives the warpgroup att_v and att_u side by side in one
//   accumulator. The threads load each chunk with 16-byte loads a step
//   ahead, transpose it to K-major and split it in registers, and store it
//   while the tensor cores run the previous chunk (one barrier a chunk). The
//   gate (or both outputs, in the two-output form) is applied before the
//   one store of out.
// Why 64 query rows: [A | lq] for 128 rows would take 192 KB as hi + lo and
// leave no room for the ring; held in registers instead (FA3-style) it
// would take about 192 registers a thread. With 64 rows, [A | lq] (96 KB)
// and the two-stage ring (2 x 64 KB as hi + lo) fill 225 KB of the 227 KB a
// block may hold, so one block of 256 threads runs on each SM; ptxas gives
// the gated kernel 216 registers a thread in float32 and 186 in bf16, no
// spills (CUDA 12.8).
// What bounds it now: each group's v and u are read from L2 once per 64
// query rows, g / 64 = 4 times: 1.99 GB a call in float32 at the main
// shape, 0.99 GB in bf16, which the kernel moves at about 2.4 and 2.1 TB/s
// (chip_smoke.py on an NVIDIA H100 80GB HBM3, 700 W); tools/flash_phases.py
// shows the tensor cores issuing on a fifth of a block's cycles. Sharing
// each chunk across the group's blocks (a cluster with TMA multicast) is
// the next step.
// Shapes taken: g a multiple of 64 in [d, 256], d 128, e a multiple of 128
// (both shipped separators: g 256 or 128, d 128, e 1024 or 512); the
// wrapper checks them.

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace td;

constexpr int kThreads = 256;               // two warpgroups
constexpr int kQRows = 64;                  // query rows of a block (one wgmma M)
constexpr int kTile = kQRows * 128;         // 8192 bytes: 64 rows x 64 depth, bf16, swizzled
constexpr int kSlice = 128;                 // e columns of a stage-2 pass, 64 a warpgroup
constexpr int kBTile = kSlice * 128;        // 16384 bytes: 128 e columns x 64 depth, bf16
constexpr int kMaxG = 256;
constexpr int kD = 128;                     // q and k's depth (qk_dim of both shipped separators)

// bf16 halves of a float32 operand (hi, lo), one for bfloat16
template <typename T>
__host__ __device__ constexpr int parts() {
    return std::is_same<T, float>::value ? 2 : 1;
}

// [A | lq] (parts x depth / 64 tiles), then the two ring stages
// ([part][warpgroup][v, u][64 e columns][64 depth]); the ring holds k in
// stage 1
size_t smem_bytes(int g, int d, bool gated, int n_parts) {
    const size_t a = static_cast<size_t>(n_parts) * ((g + (gated ? d : 0)) / 64) * kTile;
    return a + 2 * static_cast<size_t>(n_parts) * 2 * kBTile + 1024;
}

// byte offset of element (r, c) in a K-major operand whose 64-column
// chunks lie chunk_bytes apart
__device__ __forceinline__ int kmajor(int r, int c, int chunk_bytes) {
    return (c >> 6) * chunk_bytes + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

// rows x cols of row-major src into a K-major operand at dst (its lo half
// lo_bytes further for float32), 16 bytes of src a thread-step
template <typename T>
__device__ __forceinline__ void stage_rows(uint8_t* dst, int lo_bytes, int chunk_bytes,
                                           const T* __restrict__ src, int rows, int cols) {
    constexpr int kVec = 16 / sizeof(T);
    const int per_row = cols / kVec;
#pragma unroll 4
    for (int idx = threadIdx.x; idx < rows * per_row; idx += kThreads) {
        const int r = idx / per_row, c = (idx - r * per_row) * kVec;
        const int off = kmajor(r, c, chunk_bytes);
        const void* p = src + static_cast<size_t>(r) * cols + c;
        if constexpr (std::is_same<T, float>::value) {
            const float4 x = __ldg(static_cast<const float4*>(p));
            uint32_t h0, h1, l0, l1;
            split_bf16(x.x, x.y, h0, l0);
            split_bf16(x.z, x.w, h1, l1);
            *reinterpret_cast<uint2*>(dst + off) = make_uint2(h0, h1);
            *reinterpret_cast<uint2*>(dst + lo_bytes + off) = make_uint2(l0, l1);
        } else {
            *reinterpret_cast<uint4*>(dst + off) = __ldg(static_cast<const uint4*>(p));
        }
    }
}

// element c of 16 bytes of T, as float (c a compile-time index once unrolled)
template <typename T>
__device__ __forceinline__ float element(const uint4& v, int c) {
    if constexpr (std::is_same<T, float>::value) {
        return __uint_as_float(c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w);
    } else {
        const uint32_t word = (c >> 1) == 0 ? v.x : (c >> 1) == 1 ? v.y : (c >> 1) == 2 ? v.z : v.w;
        return __uint_as_float((c & 1) ? (word & 0xffff0000u) : (word << 16));
    }
}

__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// kGated: out = gate(...) from A, lq and lin_kv / lin_ku. Otherwise lq and
// lin_* are unused and the kernel writes out = A v and out_u = A u.
template <typename T, bool kGated>
__global__ void __launch_bounds__(kThreads, 1) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ u, const T* __restrict__ mask, const T* __restrict__ lq,
    const T* __restrict__ lin_kv, const T* __restrict__ lin_ku, T* __restrict__ out,
    T* __restrict__ out_u, int n_groups, int g, int d, int e, float inv_g) {
    constexpr bool kSplit = std::is_same<T, float>::value;
    constexpr int kParts = parts<T>();
    constexpr int kStage = kParts * 2 * kBTile;
    extern __shared__ uint8_t smem_raw[];
    // 1024-byte aligned by an offset, so that the compiler keeps shared-memory
    // stores (a pointer cast through an integer would make them generic)
    uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    const int n_chunks = (g + (kGated ? d : 0)) / 64;  // depth chunks of [A | lq]
    const int a_part = n_chunks * kTile;                 // bytes of one half of [A | lq]
    uint8_t* at = smem;
    uint8_t* ring = smem + kParts * a_part;
    const uint32_t at_s = smem_u32(at), ring_s = smem_u32(ring);

    const int tid = threadIdx.x;
    const int wg = tid >> 7;
    const int lane = tid & 31;
    const int r0 = ((tid & 127) >> 5) * 16 + (lane >> 2);  // accumulator rows r0, r0 + 8
    const int q2 = (lane & 3) * 2;                         // accumulator columns 8 j + q2, +1
    const int i0 = blockIdx.x * kQRows;
    const size_t bg = static_cast<size_t>(blockIdx.z) * n_groups + blockIdx.y;
    const T* qg = q + bg * g * d;
    const T* kg = k + bg * g * d;
    const T* vg = v + bg * g * e;
    const T* ug = u + bg * g * e;
    const T* mg = mask + bg * g;
    T* og = out + bg * g * e;

    // stage 2's operand loader
    const T* kvb = kGated ? lin_kv + static_cast<size_t>(blockIdx.z) * d * e : nullptr;
    const T* kub = kGated ? lin_ku + static_cast<size_t>(blockIdx.z) * d * e : nullptr;
    const int n_steps = (e / kSlice) * n_chunks;

    // chunk `step` (slice step / n_chunks, depth chunk step % n_chunks) of v
    // and u. A unit is 8 depth rows (group kgrp) x kVecN e columns of v or u:
    // one 16-byte load of each row, then one 8-deep run a column, split and
    // stored as 16 bytes of each half. Lanes take 4 groups x 8 column
    // vectors, so that a quarter warp's float32 stores hit 8 different
    // 16-byte chunks of the swizzle. fetch loads a step's units into
    // registers, put splits and stores them; a fetch is issued a step before
    // its put, so its loads fly while the tensor cores and the barrier run.
    constexpr int kVecN = 16 / sizeof(T);                       // e columns of a load
    constexpr int kGroupsC = kSlice / kVecN;                    // column vectors of a slice
    constexpr int kUnits = 2 * 8 * kGroupsC / kThreads;          // units of a thread: 2 or 1
    uint4 x[kUnits][8];
    auto unit = [&](int it, int& kgrp, int& col, int& which) {
        const int idx = tid + kThreads * it;
        const int rest = idx / (4 * kGroupsC);                  // 0 .. 3
        kgrp = (idx & 3) + 4 * (rest & 1);
        which = rest >> 1;
        col = ((idx >> 2) & (kGroupsC - 1)) * kVecN;
    };
    auto fetch = [&](int step) {
        const int sl = step / n_chunks, row = (step - sl * n_chunks) * 64;
        const T* sv = (!kGated || row < g) ? vg + static_cast<size_t>(row) * e
                                           : kvb + static_cast<size_t>(row - g) * e;
        const T* su = (!kGated || row < g) ? ug + static_cast<size_t>(row) * e
                                           : kub + static_cast<size_t>(row - g) * e;
#pragma unroll
        for (int it = 0; it < kUnits; ++it) {
            int kgrp, col, which;
            unit(it, kgrp, col, which);
            const T* src = (which ? su : sv) + static_cast<size_t>(kgrp * 8) * e + sl * kSlice + col;
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
                x[it][jj] = __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(jj) * e));
        }
    };
    auto put = [&](int st) {
        uint8_t* dst = ring + st * kStage;
#pragma unroll
        for (int it = 0; it < kUnits; ++it) {
            int kgrp, col, which;
            unit(it, kgrp, col, which);
#pragma unroll
            for (int c = 0; c < kVecN; ++c) {
                const int n = col + c;
                const int nrow = (n >> 6) * 128 + which * 64 + (n & 63);  // [v | u] of 64 columns
                const int off = nrow * 128 + ((kgrp ^ (n & 7)) << 4);
                float f[8];
#pragma unroll
                for (int jj = 0; jj < 8; ++jj) f[jj] = element<T>(x[it][jj], c);
                if constexpr (kSplit) {
                    uint4 hi, lo;
                    split_bf16(f[0], f[1], hi.x, lo.x);
                    split_bf16(f[2], f[3], hi.y, lo.y);
                    split_bf16(f[4], f[5], hi.z, lo.z);
                    split_bf16(f[6], f[7], hi.w, lo.w);
                    *reinterpret_cast<uint4*>(dst + off) = hi;
                    *reinterpret_cast<uint4*>(dst + 2 * kBTile + off) = lo;
                } else {
                    *reinterpret_cast<uint4*>(dst + off) = make_uint4(
                        pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                        pack_bf16(f[6], f[7]));
                }
            }
        }
    };

    fetch(0);  // stage 2's first chunk loads while stage 1 runs

    // ---- stage 1: q's rows over [A | lq]'s first tiles, k into the ring, lq's rows
    const int k_part = g * d * 2;  // bytes of one half of k
    stage_rows(at, a_part, kTile, qg + static_cast<size_t>(i0) * d, kQRows, d);
    stage_rows(ring, k_part, g * 128, kg, g, d);
    if constexpr (kGated)
        stage_rows(at + (g / 64) * kTile, a_part, kTile, lq + bg * g * d + static_cast<size_t>(i0) * d,
                   kQRows, d);
    fence_proxy_async();
    __syncthreads();

    const int n_kb = g / 64;  // key blocks; warpgroup w takes w and w + 2
    float s[2][32];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
        const int kb = wg + 2 * t;
        if (kb >= n_kb) continue;  // uniform over the warpgroup
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kD / 16; ++ks) {
            const uint32_t a = at_s + (ks >> 2) * kTile + 32 * (ks & 3);
            const uint32_t b = ring_s + (ks >> 2) * (g * 128) + kb * kTile + 32 * (ks & 3);
            wgmma_m64n64k16(s[t], gmma_desc(a), gmma_desc(b), ks != 0);
            if constexpr (kSplit) {
                wgmma_m64n64k16(s[t], gmma_desc(a), gmma_desc(b + k_part));
                wgmma_m64n64k16(s[t], gmma_desc(a + a_part), gmma_desc(b));
            }
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(s[t]);
    }
    __syncthreads();  // q and k are read: A goes over q's tiles, the ring takes v and u

    // A = relu(S / g)^2 * mask, rounded to v's type, split, as [A | lq]'s tile kb
#pragma unroll
    for (int t = 0; t < 2; ++t) {
        const int kb = wg + 2 * t;
        if (kb >= n_kb) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int key = kb * 64 + 8 * j + q2;
            const float m0 = to_f(mg[key]), m1 = to_f(mg[key + 1]);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = r0 + 8 * h;
                const float s0 = fmaxf(s[t][4 * j + 2 * h] * inv_g, 0.f);
                const float s1 = fmaxf(s[t][4 * j + 2 * h + 1] * inv_g, 0.f);
                const float a0 = round_to<T>(s0 * s0 * m0), a1 = round_to<T>(s1 * s1 * m1);
                const int off = kb * kTile + r * 128 + ((j ^ (r & 7)) << 4) + q2 * 2;
                if constexpr (kSplit) {
                    uint32_t hi, lo;
                    split_bf16(a0, a1, hi, lo);
                    *reinterpret_cast<uint32_t*>(at + off) = hi;
                    *reinterpret_cast<uint32_t*>(at + a_part + off) = lo;
                } else {
                    *reinterpret_cast<uint32_t*>(at + off) = pack_bf16(a0, a1);
                }
            }
        }
    }

    // ---- stage 2: [A | lq] . [v ; lin_kv] and [A | lq] . [u ; lin_ku]
    // warpgroup w's att_v | att_u for the slice's columns 64 w .. 64 w + 63:
    // acc[0, 32) and acc[32, 64); each slice's first chunk starts them (scale_d 0)
    float acc[64];
    put(0);
    if (n_steps > 1) fetch(1);
    for (int step = 0; step < n_steps; ++step) {
        const int st = step & 1;
        const int sl = step / n_chunks, ch = step - sl * n_chunks;
        fence_proxy_async();
        __syncthreads();  // stage st (and [A | lq]) complete; both warpgroups done with st ^ 1
        wgmma_fence();
        const uint32_t a = at_s + ch * kTile;
        const uint32_t b = ring_s + st * kStage + wg * 128 * 128;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            wgmma_m64n128k16(acc, gmma_desc(a + 32 * j), gmma_desc(b + 32 * j), ch != 0 || j != 0);
            if constexpr (kSplit) {
                wgmma_m64n128k16(acc, gmma_desc(a + 32 * j), gmma_desc(b + 2 * kBTile + 32 * j));
                wgmma_m64n128k16(acc, gmma_desc(a + a_part + 32 * j), gmma_desc(b + 32 * j));
            }
        }
        wgmma_commit();
        if (step + 1 < n_steps) {  // while the tensor cores work
            put(st ^ 1);
            if (step + 2 < n_steps) fetch(step + 2);
        }
        wgmma_wait_all();
        fence_acc(acc);
        if (ch != n_chunks - 1) continue;

        // the slice is summed: the gate (or both outputs), one store; the
        // gate's v and u are loaded four column groups at a time, ahead of
        // their use
#pragma unroll
        for (int j0 = 0; j0 < 8; j0 += 4) {
            float2 vf[4][2], uf[4][2];
            if constexpr (kGated) {
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const size_t o = static_cast<size_t>(i0 + r0 + 8 * h) * e + sl * kSlice +
                                         wg * 64 + 8 * (j0 + j) + q2;
                        vf[j][h] = load2(vg + o);
                        uf[j][h] = load2(ug + o);
                    }
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const size_t o = static_cast<size_t>(i0 + r0 + 8 * h) * e + sl * kSlice +
                                     wg * 64 + 8 * (j0 + j) + q2;
                    const int ai = 4 * (j0 + j) + 2 * h;
                    if constexpr (kGated) {
                        store2(og + o, (acc[ai + 32] * vf[j][h].x) * sigmoid_f(acc[ai] * uf[j][h].x),
                               (acc[ai + 33] * vf[j][h].y) * sigmoid_f(acc[ai + 1] * uf[j][h].y));
                    } else {
                        store2(og + o, acc[ai], acc[ai + 1]);
                        store2(out_u + bg * g * e + o, acc[ai + 32], acc[ai + 33]);
                    }
                }
            }
        }
    }
}

template <typename T, bool kGated>
int launch(const void* q, const void* k, const void* v, const void* u, const void* mask,
           const void* lq, const void* lin_kv, const void* lin_ku, void* out, void* out_u,
           int batch, int n_groups, int g, int d, int e, cudaStream_t stream) {
    if (g % 64 || d != kD || e % kSlice || g > kMaxG || d > g || batch <= 0 ||
        n_groups <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = smem_bytes(g, d, kGated, parts<T>());
    cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, kGated>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(g / kQRows, n_groups, batch);
    flash_kernel<T, kGated><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(u), static_cast<const T*>(mask), static_cast<const T*>(lq),
        static_cast<const T*>(lin_kv), static_cast<const T*>(lin_ku), static_cast<T*>(out),
        static_cast<T*>(out_u), n_groups, g, d, e, 1.0f / static_cast<float>(g));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int td_flash_gated(const void* q, const void* k, const void* v, const void* u,
                              const void* mask, const void* lq, const void* lin_kv,
                              const void* lin_ku, void* out, int batch, int n_groups, int g,
                              int d, int e, int is_bf16, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return launch<__nv_bfloat16, true>(q, k, v, u, mask, lq, lin_kv, lin_ku, out, nullptr,
                                           batch, n_groups, g, d, e, s);
    return launch<float, true>(q, k, v, u, mask, lq, lin_kv, lin_ku, out, nullptr, batch,
                               n_groups, g, d, e, s);
}

extern "C" int td_flash_group(const void* q, const void* k, const void* v, const void* u,
                              const void* mask, void* out_v, void* out_u, int batch,
                              int n_groups, int g, int d, int e, int is_bf16, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return launch<__nv_bfloat16, false>(q, k, v, u, mask, nullptr, nullptr, nullptr, out_v,
                                            out_u, batch, n_groups, g, d, e, s);
    return launch<float, false>(q, k, v, u, mask, nullptr, nullptr, nullptr, out_v, out_u,
                                batch, n_groups, g, d, e, s);
}
