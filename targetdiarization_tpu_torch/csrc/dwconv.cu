// Depthwise (grouped-to-one) 1-D convolution over time, time-major.
//
// Replaces the TPU kernel targetdiarization_tpu/ops/pallas/dwconv.py
// (_dw_kernel, _dw_fwd_impl). For x (B, T, C*m), w (K, m, C), dilation d
// and zero padding (pad_l, pad_r):
//   out[b, t, c] = sum_i sum_j w[i, j, c] * x[b, t + i*d - pad_l, c*m + j]
// with rows outside [0, T) read as zero, float32 accumulation, and out
// (B, T_out, C) in x's type, T_out = T + pad_l + pad_r - (K - 1) * d.
// Group c reads input channels c*m .. c*m+m-1 inside the kernel, so a
// grouped-input conv (m > 1) is one launch, not m strided ones.
//
// What bounds it on an H100: per output element it does K*m FMAs on the
// float32 units (no tensor cores: a depthwise conv has no reduction over
// channels to feed them), 2*K*m operations against (m + 1) elements read
// and written. At the main path's shapes (K 11..39, m 1..2) that is 7 to
// 52 operations a byte in bf16 and half that in f32, around the card's
// 20 float32 operations a byte: the narrow convs are bound by bytes, the
// 39-tap ones by float32 FMA.
//
// Design, simple first: one block of 256 threads per (64 output rows,
// 32 output channels, batch row). The block copies its input rows plus
// the (K-1)*d halo rows (zero outside [0, T), which takes the explicit or
// SAME padding without a padded copy on the host) and its weights into
// shared memory as float32. Each thread owns one output channel and 8
// rows (strided by 8, so a warp reads one shared-memory row) and sums
// its K*m taps from shared memory. Input rows are read from device
// memory once per block, plus the halo; the tap loop is bound by
// shared-memory loads, one per FMA.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;                       // output rows of a block
constexpr int kCh = 32;                         // output channels of a block
constexpr int kRowGroups = kThreads / kCh;      // 8
constexpr int kRowsPerThread = kRows / kRowGroups;
constexpr size_t kMaxSmem = 232448;             // a block's limit on sm_90
constexpr size_t kDefaultSmem = 48 * 1024;      // usable without the opt-in attribute

size_t smem_bytes(int k, int m, int dil) {
    const size_t rows = kRows + static_cast<size_t>(k - 1) * dil;
    return (rows * kCh * m + static_cast<size_t>(k) * m * kCh) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dwconv_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int t_in,
    int t_out, int c, int m, int k, int dil, int pad_l) {
    extern __shared__ __align__(16) float smem[];
    const int rows = kRows + (k - 1) * dil;
    const int width = kCh * m;                 // input channels of the tile
    float* xs = smem;                          // [rows][width]
    float* ws = smem + static_cast<size_t>(rows) * width;  // [k * m][kCh]

    const int tid = threadIdx.x;
    const int t0 = blockIdx.x * kRows;
    const int c0 = blockIdx.y * kCh;
    const int cin = c * m;
    const T* xb = x + static_cast<size_t>(blockIdx.z) * t_in * cin;

    for (int idx = tid; idx < rows * width; idx += kThreads) {
        const int r = idx / width, col = idx - r * width;
        const int t = t0 - pad_l + r;
        const int ch = c0 * m + col;
        xs[idx] = (t >= 0 && t < t_in && ch < cin)
                      ? td::to_f(xb[static_cast<size_t>(t) * cin + ch]) : 0.f;
    }
    for (int idx = tid; idx < k * m * kCh; idx += kThreads) {
        const int tap = idx / kCh, cl = idx - tap * kCh;  // tap = i * m + j
        ws[idx] = (c0 + cl < c) ? td::to_f(w[static_cast<size_t>(tap) * c + c0 + cl]) : 0.f;
    }
    __syncthreads();

    const int cl = tid % kCh;
    const int rg = tid / kCh;
    float acc[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.f;
    for (int i = 0; i < k; ++i) {
        for (int j = 0; j < m; ++j) {
            const float wv = ws[(i * m + j) * kCh + cl];
            const float* col = xs + static_cast<size_t>(i * dil + rg) * width + cl * m + j;
#pragma unroll
            for (int r = 0; r < kRowsPerThread; ++r)
                acc[r] = fmaf(wv, col[r * kRowGroups * width], acc[r]);
        }
    }
    const int oc = c0 + cl;
    if (oc >= c) return;
    T* ob = out + static_cast<size_t>(blockIdx.z) * t_out * c + oc;
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
        const int t = t0 + rg + r * kRowGroups;
        if (t < t_out) ob[static_cast<size_t>(t) * c] = td::Store<T>::from_f(acc[r]);
    }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int batch, int t_in, int t_out, int c,
           int m, int k, int dil, int pad_l, cudaStream_t stream) {
    const size_t smem = smem_bytes(k, m, dil);
    if (smem > kMaxSmem || batch <= 0 || t_out <= 0 || c <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (smem > kDefaultSmem) {  // the opt-in costs host time: only when the tile needs it
        const cudaError_t err = cudaFuncSetAttribute(
            dwconv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const dim3 grid((t_out + kRows - 1) / kRows, (c + kCh - 1) / kCh, batch);
    dwconv_kernel<T><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), t_in, t_out,
        c, m, k, dil, pad_l);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One block of int64 arguments, so that a call from Python converts one
// pointer instead of thirteen values (at the ASR path's small shapes the
// host's cost per call sets the time): x (B, T, C*m), w (K, m, C) and out
// (B, T_out, C) as addresses, then batch, t_in, t_out, c, m, k, dil, pad_l,
// is_bf16, and the stream.
extern "C" int td_dwconv(const long long* args) {
    const void* x = reinterpret_cast<const void*>(args[0]);
    const void* w = reinterpret_cast<const void*>(args[1]);
    void* out = reinterpret_cast<void*>(args[2]);
    const int batch = static_cast<int>(args[3]), t_in = static_cast<int>(args[4]);
    const int t_out = static_cast<int>(args[5]), c = static_cast<int>(args[6]);
    const int m = static_cast<int>(args[7]), k = static_cast<int>(args[8]);
    const int dil = static_cast<int>(args[9]), pad_l = static_cast<int>(args[10]);
    cudaStream_t s = reinterpret_cast<cudaStream_t>(args[12]);
    if (args[11])
        return launch<__nv_bfloat16>(x, w, out, batch, t_in, t_out, c, m, k, dil, pad_l, s);
    return launch<float>(x, w, out, batch, t_in, t_out, c, m, k, dil, pad_l, s);
}
