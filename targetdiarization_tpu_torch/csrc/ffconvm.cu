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
// What bounds it on an H100: at the main path's widths (cin 256..1024,
// cout 128..2048, T up to 20224, B 2) the dense product is the work.
// In bf16 the wider projections (512->2048, 1024->512) are bound by
// tensor-core operations and the narrow ones (512->128, 256->256) by
// the bytes of x and out. In f32 every shape is bound by the 67 TFLOP/s
// of the non-tensor-core float units.
//
// Design, simple first: one block of 256 threads per (112 output rows,
// 64 output channels). It computes h for its rows plus the 16 halo rows
// (128 rows) with a tiled float32 FMA product streamed over cin in chunks
// of 32, keeps h in shared memory as f32 and runs the 17 taps from there,
// so neither y nor h ever goes to device memory. The norm statistics come
// from a pre-pass (one warp per row, 8 bytes per row). The product does
// not use the tensor cores yet (no wgmma, no TMA): that is the next step
// for the bf16 path.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTaps = 17;
constexpr int kHalo = (kTaps - 1) / 2;       // 8 rows each side
constexpr int kRows = 128;                    // h rows of a block
constexpr int kOutRows = kRows - (kTaps - 1); // 112 output rows
constexpr int kCols = 64;                     // output channels of a block
constexpr int kChunk = 32;                    // cin per shared-memory stage
constexpr int kLdA = kRows + 4;
constexpr int kLdB = kCols + 4;

template <typename T>
__global__ void __launch_bounds__(kThreads) row_stats_kernel(
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

struct GemmTiles {
    float a[kChunk][kLdA];  // normalized x, k-major
    float b[kChunk][kLdB];  // W^T chunk, k-major
};
union FfSmem {
    GemmTiles g;
    float h[kRows][kCols];
};

template <typename T>
__global__ void __launch_bounds__(kThreads) ffconvm_kernel(
    const T* __restrict__ x, const float2* __restrict__ stats,
    const T* __restrict__ na, const T* __restrict__ nb,
    const T* __restrict__ w, const T* __restrict__ bias,
    const T* __restrict__ dwk, T* __restrict__ out,
    int t_len, int cin, int cout, int layernorm) {
    __shared__ __align__(16) FfSmem sm;
    const int tid = threadIdx.x;
    const int b = blockIdx.z;
    const int t0 = blockIdx.x * kOutRows;
    const int n0 = blockIdx.y * kCols;
    const T* xb = x + static_cast<size_t>(b) * t_len * cin;

    // loader of the A tile: one h row per thread, 16 of the chunk's 32 k
    const int ar = tid % kRows;
    const int ak = (tid / kRows) * 16;
    const int at = t0 - kHalo + ar;
    const bool a_ok = at >= 0 && at < t_len;
    float s0 = 1.f, s1 = 0.f;
    if (a_ok) {
        const float2 st = stats[static_cast<size_t>(b) * t_len + at];
        s0 = st.x;
        s1 = st.y;
    }
    const float g = layernorm ? 0.f : td::to_f(na[0]);
    const T* xrow = xb + static_cast<size_t>(a_ok ? at : 0) * cin;
    // loader of the B tile: one output channel per thread, 8 of the 32 k
    const int bn = tid % kCols;
    const int bk = (tid / kCols) * 8;
    const bool b_ok = n0 + bn < cout;
    const T* wrow = w + static_cast<size_t>(b_ok ? n0 + bn : 0) * cin;

    // each thread owns 8 rows x 4 channels of the product
    const int ty = tid / 16, tx = tid % 16;
    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

    for (int k0 = 0; k0 < cin; k0 += kChunk) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            const int k = k0 + ak + j;
            float y = 0.f;
            if (a_ok && k < cin) {
                const float xv = td::to_f(xrow[k]);
                y = layernorm ? (xv - s0) * s1 * td::to_f(na[k]) + td::to_f(nb[k])
                              : xv / s0 * g;
                y = td::round_to<T>(y);
            }
            sm.g.a[ak + j][ar] = y;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int k = k0 + bk + j;
            sm.g.b[bk + j][bn] = (b_ok && k < cin) ? td::to_f(wrow[k]) : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < kChunk; ++kk) {
            const float4 a0 = *reinterpret_cast<const float4*>(&sm.g.a[kk][ty * 8]);
            const float4 a1 = *reinterpret_cast<const float4*>(&sm.g.a[kk][ty * 8 + 4]);
            const float4 bv = *reinterpret_cast<const float4*>(&sm.g.b[kk][tx * 4]);
            const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int r = 0; r < 8; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bw[c], acc[r][c]);
        }
        __syncthreads();
    }

    // h = silu(acc + bias), zero outside the array; the union reuses the
    // product's tiles, which the loop's last barrier released
#pragma unroll
    for (int r = 0; r < 8; ++r) {
        const int row = ty * 8 + r;
        const int t = t0 - kHalo + row;
        const bool valid = t >= 0 && t < t_len;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int n = n0 + tx * 4 + c;
            const float hb = acc[r][c] + (n < cout ? td::to_f(bias[n]) : 0.f);
            sm.h[row][tx * 4 + c] = valid ? hb * td::sigmoid_f(hb) : 0.f;
        }
    }
    __syncthreads();

    const int cj = tid % kCols;
    const int n = n0 + cj;
    if (n >= cout) return;
    float taps[kTaps];
#pragma unroll
    for (int k = 0; k < kTaps; ++k) taps[k] = td::to_f(dwk[static_cast<size_t>(k) * cout + n]);
    T* ob = out + static_cast<size_t>(b) * t_len * cout + n;
    for (int i = tid / kCols; i < kOutRows; i += kThreads / kCols) {
        const int t = t0 + i;
        if (t >= t_len) break;
        float a = sm.h[i + kHalo][cj];
#pragma unroll
        for (int k = 0; k < kTaps; ++k) a += sm.h[i + k][cj] * taps[k];
        ob[static_cast<size_t>(t) * cout] = td::Store<T>::from_f(a);
    }
}

template <typename T>
int launch(const void* x, const void* na, const void* nb, const void* w,
           const void* bias, const void* dwk, void* stats, void* out, int batch,
           int t_len, int cin, int cout, int layernorm, float eps, float inv_d,
           cudaStream_t stream) {
    const int rows = batch * t_len;
    const int warps_per_block = kThreads / 32;
    row_stats_kernel<T><<<(rows + warps_per_block - 1) / warps_per_block, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<float2*>(stats), rows, cin, layernorm, eps, inv_d);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((t_len + kOutRows - 1) / kOutRows, (cout + kCols - 1) / kCols, batch);
    ffconvm_kernel<T><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float2*>(stats),
        static_cast<const T*>(na), static_cast<const T*>(nb), static_cast<const T*>(w),
        static_cast<const T*>(bias), static_cast<const T*>(dwk), static_cast<T*>(out),
        t_len, cin, cout, layernorm);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int td_ffconvm(const void* x, const void* na, const void* nb, const void* w,
                          const void* bias, const void* dwk, void* stats, void* out,
                          int batch, int t_len, int cin, int cout, int layernorm,
                          float eps, float inv_d, int is_bf16, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return launch<__nv_bfloat16>(x, na, nb, w, bias, dwk, stats, out, batch, t_len, cin,
                                     cout, layernorm, eps, inv_d, s);
    return launch<float>(x, na, nb, w, bias, dwk, stats, out, batch, t_len, cin, cout,
                         layernorm, eps, inv_d, s);
}
