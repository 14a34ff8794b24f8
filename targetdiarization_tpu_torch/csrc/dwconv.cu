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
// 20 float32 operations a byte: at the separator's shapes the bytes bound
// it (0.025 and 0.037 ms against 0.012 and 0.024 ms of FMAs).
//
// Design: a block of up to 256 threads takes up to 128 input channels of
// one batch row, and time tiles of that row. It stages a tile's input rows
// plus the (K-1)*d halo rows by cp.async, 16 bytes a copy, zero outside
// [0, T) (which takes the explicit or SAME padding without a padded copy
// on the host), and its taps once as float32, their count rounded up to a
// multiple of 8 with zeros. Each thread owns a vector of 4 input channels
// (4/m output channels; 16 bytes of float32, 8 of bf16, so that the window
// below stays 60 registers) and 8 output rows t, t + d, ..., t + 7d of one
// dilation phase: the inputs of those rows for taps i .. i+7 are the 15
// rows t - pad_l + d*(i .. i+14), so a register window of 15 vectors feeds
// 8 taps x 8 rows of FMAs, one shared-memory load for every 4 to 8 FMAs of
// each channel. The window's loads and the taps' have no branch between
// them (past the last tap a window rereads its last row and meets a zero
// tap), so the compiler hoists them ahead of the FMAs.
// Long inputs (T_out >= 4096, the separator) take 128-row tiles, whose 38
// or 76 halo rows at 39 taps are 30 % or 59 % of the tile, in two staging
// buffers where they fit: one block an SM walks its tiles, the next tile
// loading while this one is summed. On short inputs (the SAN-M and VAD
// memories) latency, not throughput, sets the time: each thread sums 2
// rows, not 8, so that four times as many threads share the work (126
// blocks at SAN-M), and a block takes one tile.
// Phase tiles: where the tile and its (K-1)*d halo rows do not fit in
// shared memory (K 3 above dilation 44 at the 128-row tile: ConvTasNet's
// dilations 64 and 128), the kernel runs as d undilated convs, one over
// each phase t = p (mod d): a tile stages rows p + d*j, p + d*(j+1), ...
// of one phase and its halo is K-1 staged rows, and the same summation
// runs on it at dilation 1. This path is its own instantiation
// (kPhase), so the shapes that fit keep their code.
// Shapes taken: m 1, 2 or 4, and C*m a multiple of 4 (float32) or 8
// (bf16); the wrapper checks them.

#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace td;

constexpr int kThreads = 256;
constexpr int kVec = 4;        // input channels of a thread's vector
constexpr int kRLong = 8;      // output rows of one phase a thread sums, long inputs
constexpr int kRShort = 2;     // ... and short ones
constexpr int kU = 8;          // taps of one register window
constexpr int kRows = 128;     // the time tile (output rows) of long inputs
constexpr int kLong = 4096;    // T_out from which the tile is kRows
constexpr int kMaxDilation = 1 << 16;
constexpr size_t kMaxSmem = 232448;         // a block's limit on sm_90
constexpr size_t kDefaultSmem = 48 * 1024;  // usable without the opt-in attribute

// taps staged: K rounded up to whole register windows, the extra ones zero
__host__ __device__ constexpr int k_padded(int k) { return (k + kU - 1) / kU * kU; }

struct Tiling {
    int rows;     // output rows of one phase a thread sums (kRLong or kRShort)
    int lanes;    // channel vectors of a block (8, 16 or 32)
    int tile;     // output rows of a tile: d * (rows of one phase), a multiple of 8 d;
                  // with phase tiles, rows of one phase
    int threads;  // lanes x rows of threads, at most kThreads
    int n_bufs;   // staging buffers: two where they fit (the next tile loads while one is summed)
    size_t smem;
};

// phase: the tile holds rows of one phase (t = p mod dil), staged at
// dilation 1, at most the phase's ceil(t_out / dil) rows rounded up
template <typename T>
Tiling tiling(int t_out, int cin, int k, int dil, bool phase = false) {
    const int vecs = cin / kVec;
    Tiling tl;
    tl.lanes = vecs >= 32 ? 32 : vecs >= 16 ? 16 : 8;
    const bool long_rows = t_out >= kLong;
    tl.rows = long_rows ? kRLong : kRShort;
    const int target = long_rows ? kRows : std::min(kRows, kThreads / tl.lanes * tl.rows);
    const int d = phase ? 1 : dil;  // the staged rows' dilation
    tl.tile = d * std::max(1, target / (d * tl.rows)) * tl.rows;
    if (phase) {
        const int phase_rows = (t_out + dil - 1) / dil;
        tl.tile = std::min(tl.tile, (phase_rows + tl.rows - 1) / tl.rows * tl.rows);
    }
    tl.threads = tl.lanes * std::min(kThreads / tl.lanes, tl.tile / tl.rows);
    const size_t width = static_cast<size_t>(tl.lanes) * kVec;
    const size_t buf =
        (static_cast<size_t>(tl.tile) + static_cast<size_t>(k - 1) * d) * width * sizeof(T);
    const size_t taps = static_cast<size_t>(k_padded(k)) * width * sizeof(float);
    tl.n_bufs = long_rows && 2 * buf + taps <= kMaxSmem ? 2 : 1;
    tl.smem = tl.n_bufs * buf + taps;
    return tl;
}

__device__ __forceinline__ void load_vec(const float* p, float (&v)[kVec]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[kVec]) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

template <int N>
__device__ __forceinline__ void load_taps(const float* p, float (&w)[N]) {
    if constexpr (N == 4) {
        const float4 x = *reinterpret_cast<const float4*>(p);
        w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
    } else if constexpr (N == 2) {
        const float2 x = *reinterpret_cast<const float2*>(p);
        w[0] = x.x, w[1] = x.y;
    } else {
        w[0] = p[0];
    }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&a)[N]) {
    if constexpr (N == 4) *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
    else if constexpr (N == 2) *reinterpret_cast<float2*>(p) = make_float2(a[0], a[1]);
    else p[0] = a[0];
}
template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&a)[N]) {
    if constexpr (N == 4)
        *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(a[0], a[1]), pack_bf16(a[2], a[3]));
    else if constexpr (N == 2) *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a[0], a[1]);
    else p[0] = __float2bfloat16_rn(a[0]);
}

// With kPhase, dil is 1 and pstride the conv's dilation: tile tt holds
// rows p + pstride * (j0 + i) of phase p = tt / tpp, j0 = (tt mod tpp) * tile.
template <typename T, int M, int kR, bool kPhase>
__global__ void __launch_bounds__(kThreads) dwconv_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int t_in,
    int t_out, int c, int k, int dil, int pad_l, int lanes, int tile, int n_bufs, int pstride,
    int tpp) {
    constexpr int kOut = kVec / M;  // output channels of a thread
    extern __shared__ __align__(16) uint8_t smem[];
    const int cin = c * M;
    const int width = lanes * kVec;  // input channels of the block
    const int rows = tile + (k - 1) * dil;
    const int buf = rows * width;    // elements of one staging buffer [rows][width]
    T* xs = reinterpret_cast<T*>(smem);
    float* ws = reinterpret_cast<float*>(smem + static_cast<size_t>(n_bufs) * buf * sizeof(T));
    const int ocb = width / M;  // ws: [k_padded(k)][M][ocb]
    const int n_tiles = kPhase ? pstride * tpp : (t_out + tile - 1) / tile;
    // the input row staged as row r of tile tt
    auto in_row = [&](int tt, int r) -> int {
        if constexpr (kPhase) {
            const int p = tt / tpp;
            return p + pstride * ((tt - p * tpp) * tile + r) - pad_l;
        } else {
            return tt * tile - pad_l + r;
        }
    };

    const int tid = threadIdx.x;
    const int ci0 = blockIdx.y * width;
    const int co0 = ci0 / M;
    const T* xb = x + static_cast<size_t>(blockIdx.z) * t_in * cin;

    // input rows tt * tile - pad_l .. + rows - 1 of tile tt into buffer b,
    // zero outside [0, T), 16 bytes a copy
    constexpr int kPer16 = 16 / sizeof(T);
    const int row_copies = width / kPer16;  // divides blockDim.x
    const int cc = tid % row_copies;
    const int ch = ci0 + cc * kPer16;
    auto stage = [&](int tt, int b) {
        const uint32_t dst = smem_u32(xs + b * buf) + cc * 16;
        for (int r = tid / row_copies; r < rows; r += blockDim.x / row_copies) {
            const int t = in_row(tt, r);
            const bool ok = t >= 0 && t < t_in && ch < cin;
            cp_async16(dst + r * row_copies * 16, ok ? xb + static_cast<size_t>(t) * cin + ch : xb,
                       ok ? 16 : 0);
        }
        cp_async_commit();
    };

    int tt = blockIdx.x;
    if (tt < n_tiles) stage(tt, 0);
    for (int idx = tid; idx < k_padded(k) * M * ocb; idx += blockDim.x) {
        const int tap = idx / ocb, o = idx - tap * ocb;  // tap = i * M + j
        ws[idx] = tap < k * M && co0 + o < c ? to_f(w[static_cast<size_t>(tap) * c + co0 + o]) : 0.f;
    }

    const int cv = tid % lanes;
    const bool active = ci0 + cv * kVec < cin;
    const int n_rt = blockDim.x / lanes;
    const float* wc = ws + cv * kOut;
    T* ob = out + static_cast<size_t>(blockIdx.z) * t_out * c + co0 + cv * kOut;
    // the block's tiles are blockIdx.x + i * gridDim.x; with two buffers the
    // next tile loads while this one is summed
    for (int it = 0; tt < n_tiles; ++it, tt += gridDim.x) {
        const int b = it % n_bufs;
        const int next = tt + gridDim.x;
        if (n_bufs == 2 && next < n_tiles) {
            stage(next, b ^ 1);
            cp_async_wait_one();
        } else {
            cp_async_wait_all();
        }
        __syncthreads();
        const T* xc = xs + b * buf + cv * kVec;
        const int t0 = tt * tile;
        const int p = kPhase ? tt / tpp : 0;         // phase tiles: the phase,
        const int j0 = kPhase ? (tt - p * tpp) * tile : 0;  // and its first row
        // chunk qc: phase p = qc % d, rows t0 + p + d * (kR * (qc / d) + r), r < kR
        for (int qc = tid / lanes; active && qc < tile / kR; qc += n_rt) {
            const int base = qc % dil + dil * kR * (qc / dil);
            float acc[kR][kOut];
#pragma unroll
            for (int r = 0; r < kR; ++r)
#pragma unroll
                for (int o = 0; o < kOut; ++o) acc[r][o] = 0.f;
            for (int i0 = 0; i0 < k; i0 += kU) {
                // rows past the last tap's are never summed (their taps are
                // zero): they reread the last row, so that no branch splits
                // the window's loads and the taps'
                const int last = kR + min(kU, k - i0) - 2;
                const T* xw = xc + (base + dil * i0) * width;
                const int step = dil * width;
                float win[kR + kU - 1][kVec];
#pragma unroll
                for (int v = 0; v < kR + kU - 1; ++v) load_vec(xw + min(v, last) * step, win[v]);
#pragma unroll
                for (int uu = 0; uu < kU; ++uu) {
#pragma unroll
                    for (int j = 0; j < M; ++j) {
                        float wt[kOut];
                        load_taps(wc + ((i0 + uu) * M + j) * ocb, wt);
#pragma unroll
                        for (int r = 0; r < kR; ++r)
#pragma unroll
                            for (int o = 0; o < kOut; ++o)
                                acc[r][o] = fmaf(wt[o], win[r + uu][o * M + j], acc[r][o]);
                    }
                }
            }
#pragma unroll
            for (int r = 0; r < kR; ++r) {
                const int t = kPhase ? p + pstride * (j0 + base + r) : t0 + base + dil * r;
                if (t < t_out) store_vec(ob + static_cast<size_t>(t) * c, acc[r]);
            }
        }
        __syncthreads();  // buffer b is free
        if (n_bufs == 1 && next < n_tiles) stage(next, 0);
    }
}

template <typename T, int M>
int launch(const void* x, const void* w, void* out, int batch, int t_in, int t_out, int c,
           int k, int dil, int pad_l, cudaStream_t stream) {
    const int cin = c * M;
    if (batch <= 0 || t_out <= 0 || c <= 0 || k <= 0 || dil <= 0 || dil > kMaxDilation ||
        cin % (16 / sizeof(T)))
        return static_cast<int>(cudaErrorInvalidValue);
    if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
        return static_cast<int>(cudaErrorMisalignedAddress);
    Tiling tl = tiling<T>(t_out, cin, k, dil);
    const bool phase = tl.smem > kMaxSmem;  // the halo does not fit: phase tiles
    if (phase) tl = tiling<T>(t_out, cin, k, dil, true);
    if (tl.smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    const int variant = (tl.rows == kRLong) + 2 * phase;
    auto kernel = phase ? (tl.rows == kRLong ? dwconv_kernel<T, M, kRLong, true>
                                             : dwconv_kernel<T, M, kRShort, true>)
                        : (tl.rows == kRLong ? dwconv_kernel<T, M, kRLong, false>
                                             : dwconv_kernel<T, M, kRShort, false>);
    // above 48 KB the block needs the opt-in, and the largest shared-memory
    // carveout; both are set once per card and size, as the calls cost host time
    constexpr int kCards = 64;
    static size_t opted_in[4][kCards];
    static int sms[kCards];
    const bool opt_in = tl.smem > kDefaultSmem;
    int dev = 0;
    if ((opt_in || tl.n_bufs == 2) && (cudaGetDevice(&dev) != cudaSuccess || dev >= kCards))
        return static_cast<int>(cudaErrorInvalidDevice);
    if (opt_in && tl.smem > opted_in[variant][dev]) {
        cudaError_t err = cudaFuncSetAttribute(kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(tl.smem));
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(kernel,
                                       cudaFuncAttributePreferredSharedMemoryCarveout,
                                       cudaSharedmemCarveoutMaxShared);
        if (err != cudaSuccess) return static_cast<int>(err);
        opted_in[variant][dev] = tl.smem;
    }
    const int width = tl.lanes * kVec;
    // phase tiles: tpp tiles of each of the dil phases (phase 0 has the most rows)
    const int tpp = phase ? ((t_out + dil - 1) / dil + tl.tile - 1) / tl.tile : 0;
    const int n_tiles = phase ? dil * tpp : (t_out + tl.tile - 1) / tl.tile;
    const int slices = (cin + width - 1) / width;
    int blocks = n_tiles;  // short inputs: one tile a block
    if (tl.n_bufs == 2) {  // long ones: one block an SM walks its tiles
        if (!sms[dev]) {
            const cudaError_t err =
                cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
            if (err != cudaSuccess) return static_cast<int>(err);
        }
        blocks = std::min(n_tiles, std::max(1, sms[dev] / (slices * batch)));
    }
    const dim3 grid(blocks, slices, batch);
    kernel<<<grid, tl.threads, tl.smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), t_in, t_out,
        c, k, phase ? 1 : dil, pad_l, tl.lanes, tl.tile, tl.n_bufs, dil, tpp);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_m(const void* x, const void* w, void* out, int batch, int t_in, int t_out, int c,
             int m, int k, int dil, int pad_l, cudaStream_t stream) {
    switch (m) {
        case 1: return launch<T, 1>(x, w, out, batch, t_in, t_out, c, k, dil, pad_l, stream);
        case 2: return launch<T, 2>(x, w, out, batch, t_in, t_out, c, k, dil, pad_l, stream);
        case 4: return launch<T, 4>(x, w, out, batch, t_in, t_out, c, k, dil, pad_l, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
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
        return launch_m<__nv_bfloat16>(x, w, out, batch, t_in, t_out, c, m, k, dil, pad_l, s);
    return launch_m<float>(x, w, out, batch, t_in, t_out, c, m, k, dil, pad_l, s);
}
