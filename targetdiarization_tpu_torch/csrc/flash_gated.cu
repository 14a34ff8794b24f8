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
// through an fp16 split: every operand is split x = x_hi + x_lo (both
// fp16, 11 bits each) where it enters shared memory, and each product runs
// three passes, hi.hi + hi.lo + lo.hi, into float32 accumulators. fp16's
// range is narrow, so each operand tile is first multiplied by a power of
// two that puts its largest |x| in [2^14, 2^15): q's 64 rows, k's g rows,
// [A | lq]'s rows (one scale for the block), and each 64-deep chunk of
// [v ; lin_kv] and of [u ; lin_ku] over a warpgroup's 64 columns (the
// warpgroup loads them itself, so its four warps agree on the scale at one
// barrier of 128 threads; the running sums are rescaled to it before the
// chunk's products). The scales are exact and come off before A is formed
// and before the gate. A bf16 split (8 bits each, no scales) erred by up
// to 2.2e-4 of max |out| at g 128 (tools/flash_precision.py), over the
// 1e-4 limit: the gate multiplies att_v's error by |u| |att_u v|; this one
// by 1.7e-5 (tests/test_torch_kernels.py::
// test_flash_split_passes_meet_float32_limit emulates both). The scales
// cost 10 % of the float32 time at the main shape (chip_smoke.py's
// check_flash, parent against change). bfloat16 inputs run one pass, as
// the TPU kernel does.
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
// the gated kernel 254 registers a thread in float32 and 199 in bf16 (d
// 128), no spills (CUDA 12.8).
// What bounds it now: each group's v and u are read from L2 once per 64
// query rows, g / 64 = 4 times: 1.99 GB a call in float32 at the main
// shape, 0.99 GB in bf16, which the kernel moves at about 2.2 and 2.1 TB/s
// (chip_smoke.py on an NVIDIA H100 80GB HBM3, 700 W); tools/flash_phases.py
// shows the tensor cores issuing on a fifth of a block's cycles. Sharing
// each chunk across the group's blocks (a cluster with TMA multicast) is
// the next step.
// Shapes taken: g a multiple of 64 in [64, 256], d a multiple of 16 in
// [16, min(g, 128)], e a multiple of 128 (both shipped separators: g 256 or
// 128, d 128, e 1024 or 512; the training recipe's default separator g 64,
// d 32, e 128); the wrapper checks them. d 128 is its own instantiation
// (kFullD): the same code with d a constant and no partial-chunk tests, as
// the shipped separators' shapes were tuned; the general one was 4.8 %
// (float32, then on bf16 halves) and 2.6 % (bf16) slower at g 256, d 128
// (chip_smoke.py's check_flash, parent against change). Any other d runs the
// same design with q, k and lq's depth padded to dpad, a multiple of 64,
// in shared memory: stage 1 issues only the d / 16 products over the
// filled columns, and stage 2's last depth chunk (lq's d rows of [A | lq],
// lin_kv and lin_ku's rows in the ring) issues only the products over its
// filled rows, the ring's other rows being zeros.

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

// d rounded up to whole 64-column chunks of the K-major layout
__host__ __device__ constexpr int padded_depth(int d) { return (d + 63) & ~63; }

// [A | lq] (parts x padded depth / 64 tiles), then the two ring stages
// ([part][warpgroup][v, u][64 e columns][64 depth]; the ring holds k in
// stage 1), then kRed floats for the float32 path's block maxima (32) and
// chunk maxima (2 warpgroups x 4 warps x v, u)
constexpr int kRed = 48;
size_t smem_bytes(int g, int d, bool gated, int n_parts) {
    const size_t a =
        static_cast<size_t>(n_parts) * ((g + (gated ? padded_depth(d) : 0)) / 64) * kTile;
    return a + 2 * static_cast<size_t>(n_parts) * 2 * kBTile + kRed * 4 + 1024;
}

// The float32 path's power-of-two scales: a tile whose largest |x| is m is
// multiplied by 2^scale_exp(m), which puts m in [2^14, 2^15), inside fp16's
// range, before its fp16 split (zeros keep 2^0; the exponent is clamped so
// that 2^e stays a normal float32)
__device__ __forceinline__ int scale_exp(float m) {
    if (!(m > 0.f)) return 0;
    return min(max(14 - (((__float_as_int(m) >> 23) & 0xff) - 127), -100), 100);
}
__device__ __forceinline__ float exp2i(int e) { return __int_as_float((e + 127) << 23); }

// the largest of each thread's v[i] over the block, into every thread's
// v[i]; red holds 8 floats a value, and the caller leaves a barrier
// between its reads and the next write of the same slots
template <int N>
__device__ __forceinline__ void block_max(float (&v)[N], float* red) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v[i] = fmaxf(v[i], __shfl_xor_sync(0xffffffffu, v[i], o));
        if ((threadIdx.x & 31) == 0) red[8 * i + (threadIdx.x >> 5)] = v[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < N; ++i) {
        v[i] = red[8 * i];
#pragma unroll
        for (int w = 1; w < kThreads / 32; ++w) v[i] = fmaxf(v[i], red[8 * i + w]);
    }
}

// the largest |x| of the n floats at src (n a multiple of 4) seen by this thread
__device__ __forceinline__ float absmax(const float* __restrict__ src, int n) {
    float m = 0.f;
    for (int idx = threadIdx.x; idx < n / 4; idx += kThreads) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(src) + idx);
        m = fmaxf(m, fmaxf(fmaxf(fabsf(x.x), fabsf(x.y)), fmaxf(fabsf(x.z), fabsf(x.w))));
    }
    return m;
}

// byte offset of element (r, c) in a K-major operand whose 64-column
// chunks lie chunk_bytes apart
__device__ __forceinline__ int kmajor(int r, int c, int chunk_bytes) {
    return (c >> 6) * chunk_bytes + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

// rows x cols of row-major src into a K-major operand at dst (for float32,
// times `scale` and split into fp16 halves, the lo half lo_bytes further),
// 16 bytes of src a thread-step
template <typename T>
__device__ __forceinline__ void stage_rows(uint8_t* dst, int lo_bytes, int chunk_bytes,
                                           const T* __restrict__ src, int rows, int cols,
                                           float scale = 1.f) {
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
            split_f16(x.x * scale, x.y * scale, h0, l0);
            split_f16(x.z * scale, x.w * scale, h1, l1);
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
// kFullD: d is 128 (kD); otherwise d is any multiple of 16 up to 128.
template <typename T, bool kGated, bool kFullD>
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
    if constexpr (kFullD) d = kD;
    const int dpad = padded_depth(d);
    const int depth = g + (kGated ? d : 0);                // rows of [v ; lin_kv] summed over
    const int n_chunks = (g + (kGated ? dpad : 0)) / 64;  // depth chunks of [A | lq]
    const int a_part = n_chunks * kTile;                 // bytes of one half of [A | lq]
    uint8_t* at = smem;
    uint8_t* ring = smem + kParts * a_part;
    float* red = reinterpret_cast<float*>(ring + 2 * kStage);
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
    // stored as 16 bytes of each half. In bf16, lanes take 4 groups x 8
    // column vectors, so that a quarter warp's stores hit 8 different
    // 16-byte chunks of the swizzle. fetch loads a step's units into
    // registers, put splits and stores them; a fetch is issued a step before
    // its put, so its loads fly while the tensor cores and the barrier run.
    constexpr int kVecN = 16 / sizeof(T);                       // e columns of a load
    constexpr int kGroupsC = kSlice / kVecN;                    // column vectors of a slice
    constexpr int kUnits = 2 * 8 * kGroupsC / kThreads;          // units of a thread: 2 or 1
    uint4 x[kUnits][8];
    // In float32 a warpgroup loads its own 64 columns, v then u (lanes as in
    // bf16: 4 groups x 8 column vectors; warp w: groups 4 (w & 1) on, 32
    // columns w >> 1), so that a chunk's scale needs only its warpgroup
    auto unit = [&](int it, int& kgrp, int& col, int& which) {
        if constexpr (kSplit) {
            const int w = (tid >> 5) & 3;
            kgrp = (lane & 3) + 4 * (w & 1);
            which = it;
            col = wg * 64 + (w >> 1) * 32 + ((lane >> 2) & 7) * kVecN;
        } else {
            const int idx = tid + kThreads * it;
            const int rest = idx / (4 * kGroupsC);              // 0 .. 3
            kgrp = (idx & 3) + 4 * (rest & 1);
            which = rest >> 1;
            col = ((idx >> 2) & (kGroupsC - 1)) * kVecN;
        }
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
            if (!kFullD && row + kgrp * 8 >= depth) {  // past lin_kv's d rows: zeros
#pragma unroll
                for (int jj = 0; jj < 8; ++jj) x[it][jj] = make_uint4(0u, 0u, 0u, 0u);
                continue;
            }
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
                x[it][jj] = __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(jj) * e));
        }
    };
    // float32: a warpgroup's v columns of a chunk take one power-of-two
    // scale, and its u columns another, from their largest |x| (after a
    // slice's first chunk at most 2^64 above the running sum's, whose
    // registers are rescaled to it before the chunk's products)
    int e_nv = 0, e_nu = 0, e_av = 0, e_au = 0;
    auto put = [&](int st, int step) {
        uint8_t* dst = ring + st * kStage;
        float sc[kUnits];
#pragma unroll
        for (int it = 0; it < kUnits; ++it) sc[it] = 1.f;
        if constexpr (kSplit) {  // unit it is v (0) or u (1)
            float* part = red + 32 + wg * 8;
#pragma unroll
            for (int it = 0; it < kUnits; ++it) {
                float m = 0.f;
#pragma unroll
                for (int jj = 0; jj < 8; ++jj)
#pragma unroll
                    for (int c = 0; c < kVecN; ++c) m = fmaxf(m, fabsf(element<T>(x[it][jj], c)));
#pragma unroll
                for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
                if (lane == 0) part[((tid >> 5) & 3) * 2 + it] = m;
            }
            // the warpgroup's four warps (barrier 1 + wg); the loop's barrier
            // comes before the next put writes part again
            asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
            const bool first = step % n_chunks == 0;
#pragma unroll
            for (int it = 0; it < kUnits; ++it) {
                const float m = fmaxf(fmaxf(part[it], part[2 + it]), fmaxf(part[4 + it], part[6 + it]));
                const int prev = it ? e_au : e_av;
                int e = m > 0.f ? scale_exp(m) : (first ? 0 : prev);
                if (!first) e = min(e, prev + 64);
                (it ? e_nu : e_nv) = e;
                sc[it] = exp2i(e);
            }
        }
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
                    const float k = sc[it];
                    uint4 hi, lo;
                    split_f16(f[0] * k, f[1] * k, hi.x, lo.x);
                    split_f16(f[2] * k, f[3] * k, hi.y, lo.y);
                    split_f16(f[4] * k, f[5] * k, hi.z, lo.z);
                    split_f16(f[6] * k, f[7] * k, hi.w, lo.w);
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
    // (float32: q and k each scaled by a power of two, from their largest
    // |x| over the block; lq waits for [A | lq]'s scale, below)
    const int k_part = g * dpad * 2;  // bytes of one half of k
    const T* lqg = kGated ? lq + bg * g * d + static_cast<size_t>(i0) * d : nullptr;
    int e_q = 0, e_k = 0;
    float lq_max = 0.f;
    if constexpr (kSplit) {
        float m[3] = {absmax(qg + static_cast<size_t>(i0) * d, kQRows * d), absmax(kg, g * d),
                      kGated ? absmax(lqg, kQRows * d) : 0.f};
        block_max(m, red);
        e_q = scale_exp(m[0]), e_k = scale_exp(m[1]);
        lq_max = m[2];
    }
    stage_rows(at, a_part, kTile, qg + static_cast<size_t>(i0) * d, kQRows, d, exp2i(e_q));
    stage_rows(ring, k_part, g * 128, kg, g, d, exp2i(e_k));
    if constexpr (kGated && !kSplit) stage_rows(at + (g / 64) * kTile, a_part, kTile, lqg, kQRows, d);
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
            if (!kFullD && ks >= d / 16) break;  // uniform: the filled columns only
            const uint32_t a = at_s + (ks >> 2) * kTile + 32 * (ks & 3);
            const uint32_t b = ring_s + (ks >> 2) * (g * 128) + kb * kTile + 32 * (ks & 3);
            wgmma_m64n64k16<kSplit>(s[t], gmma_desc(a), gmma_desc(b), ks != 0);
            if constexpr (kSplit) {
                wgmma_m64n64k16<kSplit>(s[t], gmma_desc(a), gmma_desc(b + k_part));
                wgmma_m64n64k16<kSplit>(s[t], gmma_desc(a + a_part), gmma_desc(b));
            }
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(s[t]);
    }
    __syncthreads();  // q and k are read: A goes over q's tiles, the ring takes v and u

    // A = relu(S / g)^2 * mask, rounded to v's type, split, as [A | lq]'s tile
    // kb; float32: S unscaled first, and [A | lq] scaled by one power of two
    // from its largest |x| over the block (A's, or lq's), lq staged with it
    const float s_lo = exp2i(-e_q), s_hi = exp2i(-e_k) * inv_g;
    auto attn = [&](int t, int i, float m) {
        const float sv_ = fmaxf((s[t][i] * s_lo) * s_hi, 0.f);
        return round_to<T>(sv_ * sv_ * m);
    };
    int e_row = 0;
    if constexpr (kSplit) {
        float m[1] = {lq_max};
#pragma unroll
        for (int t = 0; t < 2; ++t) {
            const int kb = wg + 2 * t;
            if (kb >= n_kb) continue;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int key = kb * 64 + 8 * j + q2;
                const float m0 = to_f(mg[key]), m1 = to_f(mg[key + 1]);
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    m[0] = fmaxf(m[0], fmaxf(fabsf(attn(t, 4 * j + 2 * h, m0)),
                                             fabsf(attn(t, 4 * j + 2 * h + 1, m1))));
            }
        }
        block_max(m, red + 24);
        e_row = scale_exp(m[0]);
        if constexpr (kGated)
            stage_rows(at + (g / 64) * kTile, a_part, kTile, lqg, kQRows, d, exp2i(e_row));
    }
    const float a_scale = exp2i(e_row);
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
                const float a0 = attn(t, 4 * j + 2 * h, m0), a1 = attn(t, 4 * j + 2 * h + 1, m1);
                const int off = kb * kTile + r * 128 + ((j ^ (r & 7)) << 4) + q2 * 2;
                if constexpr (kSplit) {
                    uint32_t hi, lo;
                    split_f16(a0 * a_scale, a1 * a_scale, hi, lo);
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
    put(0, 0);
    if (n_steps > 1) fetch(1);
    for (int step = 0; step < n_steps; ++step) {
        const int st = step & 1;
        const int sl = step / n_chunks, ch = step - sl * n_chunks;
        fence_proxy_async();
        __syncthreads();  // stage st (and [A | lq]) complete; both warpgroups done with st ^ 1
        if constexpr (kSplit) {  // the running sums to this chunk's scales
            if (ch != 0) {
                const float fv = exp2i(max(e_nv - e_av, -126)), fu = exp2i(max(e_nu - e_au, -126));
#pragma unroll
                for (int i = 0; i < 32; ++i) acc[i] *= fv, acc[i + 32] *= fu;
            }
            e_av = e_nv, e_au = e_nu;
        }
        wgmma_fence();
        const uint32_t a = at_s + ch * kTile;
        const uint32_t b = ring_s + st * kStage + wg * 128 * 128;
        const int n_k16 = kFullD ? 4 : min(4, (depth - ch * 64) / 16);  // filled rows / 16
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (!kFullD && j >= n_k16) break;
            wgmma_m64n128k16<kSplit>(acc, gmma_desc(a + 32 * j), gmma_desc(b + 32 * j),
                                     ch != 0 || j != 0);
            if constexpr (kSplit) {
                wgmma_m64n128k16<kSplit>(acc, gmma_desc(a + 32 * j), gmma_desc(b + 2 * kBTile + 32 * j));
                wgmma_m64n128k16<kSplit>(acc, gmma_desc(a + a_part + 32 * j), gmma_desc(b + 32 * j));
            }
        }
        wgmma_commit();
        if (step + 1 < n_steps) {  // while the tensor cores work
            put(st ^ 1, step + 1);
            if (step + 2 < n_steps) fetch(step + 2);
        }
        wgmma_wait_all();
        fence_acc(acc);
        if (ch != n_chunks - 1) continue;

        // the slice is summed: the gate (or both outputs), one store; the
        // gate's v and u are loaded four column groups at a time, ahead of
        // their use (float32: the sums unscaled first)
        if constexpr (kSplit) {
            const float dv = exp2i(-e_av), du = exp2i(-e_au), dr = exp2i(-e_row);
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[i] = acc[i] * dv * dr, acc[i + 32] = acc[i + 32] * du * dr;
        }
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

template <typename T, bool kGated, bool kFullD>
int launch_d(const void* q, const void* k, const void* v, const void* u, const void* mask,
             const void* lq, const void* lin_kv, const void* lin_ku, void* out, void* out_u,
             int batch, int n_groups, int g, int d, int e, cudaStream_t stream) {
    const size_t smem = smem_bytes(g, d, kGated, parts<T>());
    cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, kGated, kFullD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(g / kQRows, n_groups, batch);
    flash_kernel<T, kGated, kFullD><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(u), static_cast<const T*>(mask), static_cast<const T*>(lq),
        static_cast<const T*>(lin_kv), static_cast<const T*>(lin_ku), static_cast<T*>(out),
        static_cast<T*>(out_u), n_groups, g, d, e, 1.0f / static_cast<float>(g));
    return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kGated>
int launch(const void* q, const void* k, const void* v, const void* u, const void* mask,
           const void* lq, const void* lin_kv, const void* lin_ku, void* out, void* out_u,
           int batch, int n_groups, int g, int d, int e, cudaStream_t stream) {
    if (g % 64 || g < 64 || g > kMaxG || d % 16 || d < 16 || d > kD || d > g ||
        e % kSlice || e <= 0 || batch <= 0 || n_groups <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (d == kD)
        return launch_d<T, kGated, true>(q, k, v, u, mask, lq, lin_kv, lin_ku, out, out_u,
                                         batch, n_groups, g, d, e, stream);
    return launch_d<T, kGated, false>(q, k, v, u, mask, lq, lin_kv, lin_ku, out, out_u, batch,
                                      n_groups, g, d, e, stream);
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
