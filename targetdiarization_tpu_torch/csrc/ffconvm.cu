// FFConvM: row norm -> dense + bias -> SiLU -> h + depthwise 17-tap conv of h.
//
// Replaces the TPU kernel targetdiarization_tpu/ops/pallas/ffconvm.py
// (_kernel, _ffconvm_pallas). For x (B, T, cin) and one output channel
// tile, per row t:
//   y[t]   = norm(x[t]) rounded to x's type   (ScaleNorm or LayerNorm, f32)
//   h[t]   = silu(y[t] . W^T + bias)          (f32 accumulation), 0 for t outside [0, T)
//   out[t] = h[t] + sum_k dwk[k] * h[t + k - 8]    (f32), stored in x's type
// In-array rows that the model masks still contribute silu(bias), as in the
// TPU kernel; only rows outside the array are zero.
//
// What bounds it on an H100: the dense product. On the float32 FMA units
// (67 TFLOP/s) it bounds every main-path shape; on the tensor cores
// (989 TFLOP/s bf16) the wide projections (512->2048, 1024->512) stay
// bound by operations and the narrow ones (512->128, 256->256) by the
// bytes of x and out.
//
// Design: the product runs on the tensor cores (wgmma, sm_90a), with
// float32 kept through a bf16 split rather than TF32:
//   W = W_hi + W_lo, both bf16, prepared once by the caller; W_lo is
//   passed only when W is not bf16-exact (on the main path it is);
//   for float32 x the A operand is split in the loader, y = y_hi + y_lo;
//   acc = y_hi.W_hi + y_lo.W_hi (+ y_hi.W_lo), f32 accumulators.
// Two passes keep about 16 bits of y's mantissa; TF32 keeps 10. For
// bfloat16 x, y is normalised and rounded to bf16 as the TPU kernel does,
// and one pass y.W_hi runs.
//
// One block of three warpgroups (384 threads) computes 192 h rows (176
// output rows plus the 16 halo rows) by 128 output channels. Each
// warpgroup owns 64 rows and issues m64n128k16 wgmma from shared memory.
// cin streams in chunks of 64 through a two-stage ring: W's chunk comes by
// cp.async, x's chunk through the threads, which normalise it (LayerNorm
// from the stats pre-pass; ScaleNorm of bf16 x), split it and store it in
// the 128-byte-swizzled K-major layout that wgmma reads. The next chunk is
// staged while the current one's products run (one barrier per chunk).
// ScaleNorm of float32 x is one scale per row, so it moves to the epilogue
// and the loader only splits raw x. The epilogue applies scale, bias, SiLU
// and the row mask in registers, writes h as f32 into shared memory over
// the ring, and runs the 17 taps and the residual from there: each thread
// takes one channel and 8 output rows at a time from a 24-row register
// window. Neither y nor h goes to device memory; out is stored once.

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace td;  // the Hopper primitives of hopper.cuh

constexpr int kGroups = 3;                      // consumer warpgroups
constexpr int kThreads = 128 * kGroups;         // 384
constexpr int kTaps = 17;
constexpr int kHalo = (kTaps - 1) / 2;          // 8 rows each side
constexpr int kRows = 64 * kGroups;             // 192 h rows of a block
constexpr int kOutRows = kRows - 2 * kHalo;     // 176 output rows
constexpr int kCols = 128;                      // output channels of a block
constexpr int kK = 64;                          // cin per stage: one 128-byte bf16 row
constexpr int kLdH = kCols + 8;                 // h row stride (floats), conflict-free float2 stores
constexpr int kATile = kRows * kK * 2;          // 24576 bytes
constexpr int kBTile = kCols * kK * 2;          // 16384 bytes
constexpr int kStage = 2 * kATile + 2 * kBTile; // A_hi, A_lo, B_hi, B_lo
constexpr int kSmem = 2 * kStage + 1024;        // two stages, plus 1024-byte alignment
static_assert(kRows * kLdH * 4 <= 2 * kStage, "h must fit over the ring");
static_assert(kOutRows % 8 == 0, "the conv takes 8 output rows at a time");

template <typename T>
__global__ void __launch_bounds__(256) row_stats_kernel(
    const T* __restrict__ x, float2* __restrict__ stats, int rows, int cin,
    int layernorm, float eps, float inv_d) {
    const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
    const int lane = threadIdx.x % 32;
    if (row >= rows) return;
    const T* xr = x + static_cast<size_t>(row) * cin;
    if (!layernorm) {
        float ss = 0.f;
        for (int k = lane; k < cin; k += 32) {
            const float v = td::to_f(xr[k]);
            ss += v * v;
        }
        for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
        if (lane == 0) stats[row] = make_float2(sqrtf(fmaxf(ss * inv_d, eps * eps)), 0.f);
        return;
    }
    float s = 0.f;
    for (int k = lane; k < cin; k += 32) s += td::to_f(xr[k]);
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mean = s / cin;
    float q = 0.f;
    for (int k = lane; k < cin; k += 32) {
        const float dv = td::to_f(xr[k]) - mean;
        q += dv * dv;
    }
    for (int o = 16; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
    if (lane == 0) stats[row] = make_float2(mean, 1.0f / sqrtf(q / cin + eps));
}

// T float: the A operand is split (two passes); kLoB: W_lo is given (one more pass)
template <typename T, bool kLoB>
__global__ void __launch_bounds__(kThreads, 1) ffconvm_kernel(
    const T* __restrict__ x, const float2* __restrict__ stats,
    const float* __restrict__ na, const float* __restrict__ nb,
    const __nv_bfloat16* __restrict__ w_hi, const __nv_bfloat16* __restrict__ w_lo,
    const float* __restrict__ bias, const float* __restrict__ dwk, T* __restrict__ out,
    int t_len, int cin, int cout, int layernorm) {
    constexpr bool kSplitA = std::is_same<T, float>::value;
    // A loader: float32 x as 16 slots of 4 k per row, bf16 x as 8 slots of 8
    constexpr int kSlots = kSplitA ? 16 : 8;
    constexpr int kRowStep = kThreads / kSlots;     // 24 or 48
    constexpr int kRowsPer = kRows / kRowStep;      // 8 or 4
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

    const int tid = threadIdx.x;
    const int wg = tid >> 7;
    const int n0 = blockIdx.x * kCols;
    const int t0 = blockIdx.y * kOutRows;
    const int b = blockIdx.z;
    const T* xb = x + static_cast<size_t>(b) * t_len * cin;
    const float2* sb = stats + static_cast<size_t>(b) * t_len;
    const int nk = (cin + kK - 1) / kK;
    const float g = na[0];

    const int slot = tid % kSlots;
    const int arow = tid / kSlots;
    float2 st[kRowsPer];  // LayerNorm (mean, rstd) or ScaleNorm (denom, 0) of the loader's rows
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
        const int t = t0 - kHalo + arow + kRowStep * i;
        st[i] = (t >= 0 && t < t_len) ? sb[t] : make_float2(1.f, 0.f);
    }

    auto stage_a = [&](int kc, int s) {
        uint8_t* ah = smem + s * kStage;
        if constexpr (kSplitA) {
            const int k = kc * kK + slot * 4;
            float4 ga = make_float4(1.f, 1.f, 1.f, 1.f), gb = make_float4(0.f, 0.f, 0.f, 0.f);
            if (layernorm && k < cin) {
                ga = *reinterpret_cast<const float4*>(na + k);
                gb = *reinterpret_cast<const float4*>(nb + k);
            }
#pragma unroll
            for (int i = 0; i < kRowsPer; ++i) {
                const int r = arow + kRowStep * i;
                const int t = t0 - kHalo + r;
                float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
                if (t >= 0 && t < t_len && k < cin)
                    v = __ldg(reinterpret_cast<const float4*>(xb + static_cast<size_t>(t) * cin + k));
                if (layernorm) {
                    v.x = (v.x - st[i].x) * st[i].y * ga.x + gb.x;
                    v.y = (v.y - st[i].x) * st[i].y * ga.y + gb.y;
                    v.z = (v.z - st[i].x) * st[i].y * ga.z + gb.z;
                    v.w = (v.w - st[i].x) * st[i].y * ga.w + gb.w;
                }
                uint32_t h0, h1, l0, l1;
                split_bf16(v.x, v.y, h0, l0);
                split_bf16(v.z, v.w, h1, l1);
                const int off = r * 128 + (((slot >> 1) ^ (r & 7)) << 4) + ((slot & 1) << 3);
                *reinterpret_cast<uint2*>(ah + off) = make_uint2(h0, h1);
                *reinterpret_cast<uint2*>(ah + kATile + off) = make_uint2(l0, l1);
            }
        } else {
            const int k = kc * kK + slot * 8;
            float ga[8], gb[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                ga[e] = (layernorm && k < cin) ? na[k + e] : g;
                gb[e] = (layernorm && k < cin) ? nb[k + e] : 0.f;
            }
#pragma unroll
            for (int i = 0; i < kRowsPer; ++i) {
                const int r = arow + kRowStep * i;
                const int t = t0 - kHalo + r;
                uint4 raw = make_uint4(0u, 0u, 0u, 0u);
                if (t >= 0 && t < t_len && k < cin)
                    raw = __ldg(reinterpret_cast<const uint4*>(xb + static_cast<size_t>(t) * cin + k));
                const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&raw);
                float y[8];
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    const float v = __bfloat162float(xv[e]);
                    y[e] = layernorm ? (v - st[i].x) * st[i].y * ga[e] + gb[e] : v / st[i].x * ga[e];
                }
                const int off = r * 128 + ((slot ^ (r & 7)) << 4);
                *reinterpret_cast<uint4*>(ah + off) = make_uint4(
                    pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]), pack_bf16(y[4], y[5]),
                    pack_bf16(y[6], y[7]));
            }
        }
    };

    auto stage_b = [&](int kc, int s) {
        const uint32_t bh = smem_u32(smem + s * kStage + 2 * kATile);
        for (int idx = tid; idx < kCols * 8; idx += kThreads) {
            const int n = idx >> 3, c = idx & 7;
            const int gn = n0 + n, gk = kc * kK + c * 8;
            const bool ok = gn < cout && gk < cin;
            const size_t src = ok ? static_cast<size_t>(gn) * cin + gk : 0;
            const uint32_t off = n * 128 + ((c ^ (n & 7)) << 4);
            cp_async16(bh + off, w_hi + src, ok ? 16 : 0);
            if constexpr (kLoB) cp_async16(bh + kBTile + off, w_lo + src, ok ? 16 : 0);
        }
        cp_async_commit();
    };

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;

    stage_b(0, 0);
    stage_a(0, 0);
    for (int kc = 0; kc < nk; ++kc) {
        const int s = kc & 1;
        cp_async_wait_all();
        fence_proxy_async();
        __syncthreads();  // stage s is complete; every warpgroup is done with stage s^1
        wgmma_fence();
        const uint32_t ah = smem_u32(smem + s * kStage) + wg * 64 * 128;
        const uint32_t bh = smem_u32(smem + s * kStage + 2 * kATile);
#pragma unroll
        for (int j = 0; j < 4; ++j) wgmma_m64n128k16(acc, gmma_desc(ah + 32 * j), gmma_desc(bh + 32 * j));
        if constexpr (kSplitA) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
                wgmma_m64n128k16(acc, gmma_desc(ah + kATile + 32 * j), gmma_desc(bh + 32 * j));
        }
        if constexpr (kLoB) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
                wgmma_m64n128k16(acc, gmma_desc(ah + 32 * j), gmma_desc(bh + kBTile + 32 * j));
        }
        wgmma_commit();
        if (kc + 1 < nk) {  // the next chunk loads while the tensor cores work
            stage_b(kc + 1, s ^ 1);
            stage_a(kc + 1, s ^ 1);
        }
        wgmma_wait_all();
        fence_acc(acc);
    }
    __syncthreads();  // the ring is free: h goes over it

    // epilogue 1: h = silu(scale * acc + bias), zero outside [0, T), into shared memory
    float* hs = reinterpret_cast<float*>(smem);
    {
        const int lane = tid & 31;
        const int r0 = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
        const int q2 = (lane & 3) * 2;
        float sc[2];
        bool ok[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int t = t0 - kHalo + r0 + 8 * hh;
            ok[hh] = t >= 0 && t < t_len;
            sc[hh] = (kSplitA && !layernorm && ok[hh]) ? g / sb[t].x : 1.f;
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            const int col = 8 * j + q2;
            const int n = n0 + col;
            const float b0 = n < cout ? bias[n] : 0.f;
            const float b1 = n + 1 < cout ? bias[n + 1] : 0.f;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                const float v0 = acc[4 * j + 2 * hh] * sc[hh] + b0;
                const float v1 = acc[4 * j + 2 * hh + 1] * sc[hh] + b1;
                *reinterpret_cast<float2*>(hs + (r0 + 8 * hh) * kLdH + col) =
                    ok[hh] ? make_float2(v0 * td::sigmoid_f(v0), v1 * td::sigmoid_f(v1))
                           : make_float2(0.f, 0.f);
            }
        }
    }
    __syncthreads();

    // epilogue 2: out = h + 17 taps of h, one channel and 8 rows at a time
    const int c = tid % kCols;
    const int n = n0 + c;
    if (n >= cout) return;
    float taps[kTaps];
#pragma unroll
    for (int k = 0; k < kTaps; ++k) taps[k] = dwk[static_cast<size_t>(k) * cout + n];
    T* ob = out + static_cast<size_t>(b) * t_len * cout + n;
    for (int ch = tid / kCols; ch < kOutRows / 8; ch += kGroups) {
        const int i0 = ch * 8;
        float w[8 + 2 * kHalo];
#pragma unroll
        for (int u = 0; u < 8 + 2 * kHalo; ++u) w[u] = hs[(i0 + u) * kLdH + c];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
            const int t = t0 + i0 + u;
            if (t >= t_len) break;
            float a = w[u + kHalo];
#pragma unroll
            for (int k = 0; k < kTaps; ++k) a += w[u + k] * taps[k];
            ob[static_cast<size_t>(t) * cout] = td::Store<T>::from_f(a);
        }
    }
}

template <typename T, bool kLoB>
int launch(const void* x, const float* na, const float* nb, const void* w_hi, const void* w_lo,
           const float* bias, const float* dwk, float2* stats, void* out, int batch, int t_len,
           int cin, int cout, int layernorm, float eps, float inv_d, cudaStream_t stream) {
    const int rows = batch * t_len;
    row_stats_kernel<T><<<(rows + 7) / 8, 256, 0, stream>>>(
        static_cast<const T*>(x), stats, rows, cin, layernorm, eps, inv_d);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    auto kernel = ffconvm_kernel<T, kLoB>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((cout + kCols - 1) / kCols, (t_len + kOutRows - 1) / kOutRows, batch);
    kernel<<<grid, kThreads, kSmem, stream>>>(
        static_cast<const T*>(x), stats, na, nb, static_cast<const __nv_bfloat16*>(w_hi),
        static_cast<const __nv_bfloat16*>(w_lo), bias, dwk, static_cast<T*>(out), t_len, cin,
        cout, layernorm);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, T, cin) float32 or bfloat16; w_hi, w_lo (cout, cin) bf16, w_lo null
// when W is bf16-exact (always null for bf16 x); na, nb (cin,) or g (1,),
// bias (cout,), dwk (17, cout) float32; stats (B*T,) float2 scratch;
// out (B, T, cout) in x's type. cin and cout multiples of 8.
extern "C" int td_ffconvm(const void* x, const void* na, const void* nb, const void* w_hi,
                          const void* w_lo, const void* bias, const void* dwk, void* stats,
                          void* out, int batch, int t_len, int cin, int cout, int layernorm,
                          float eps, float inv_d, int is_bf16, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* fna = static_cast<const float*>(na);
    const float* fnb = static_cast<const float*>(nb);
    const float* fb = static_cast<const float*>(bias);
    const float* fk = static_cast<const float*>(dwk);
    float2* st = static_cast<float2*>(stats);
    if (cin % 8 != 0 || cout % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
    if (is_bf16) {
        if (w_lo != nullptr) return static_cast<int>(cudaErrorInvalidValue);
        return launch<__nv_bfloat16, false>(x, fna, fnb, w_hi, w_lo, fb, fk, st, out, batch,
                                            t_len, cin, cout, layernorm, eps, inv_d, s);
    }
    if (w_lo != nullptr)
        return launch<float, true>(x, fna, fnb, w_hi, w_lo, fb, fk, st, out, batch, t_len, cin,
                                   cout, layernorm, eps, inv_d, s);
    return launch<float, false>(x, fna, fnb, w_hi, w_lo, fb, fk, st, out, batch, t_len, cin,
                                cout, layernorm, eps, inv_d, s);
}
