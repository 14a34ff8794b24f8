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
// It is the same kernel compiled without the lq rows and the gate. It does
// 2 g^2 d + 4 g^2 e operations a group on g (2 d + 4 e + 1) elements, about
// 128 operations a byte in bf16 at g 256, d 128, e 1024: bound by bytes in
// bf16 and by float32 operations in f32.
//
// What bounds it on an H100: at 512/24 (g 256, d 128, e 1024) a group
// does 2 g^2 d + 4 g (g + d) e operations on g (3 d + 3 e + 1) elements
// read or written, about 240 operations a byte in bf16: under the card's
// ~295, so in bf16 the bytes bound it (narrowly), and in f32 (120 a byte
// against 20 for the non-tensor-core units) the operations do.
//
// Design, simple first: A for one group is g x g f32 (256 KB at g 256),
// more than a block's 227 KB of shared memory, so a block takes 64 query
// rows. It computes their 64 x g slice of A once (float32 FMA product over
// d in chunks of 32), keeps it in shared memory beside its 64 x d rows of
// lq (the two products A v and lq lin_kv then run as one product of depth
// g + d), and walks e in slices of 64 columns, producing att_v and att_u
// together and applying the gate before the one write of out. Neither A
// nor att_v / att_u goes to device memory. No tensor cores yet (no wgmma,
// no TMA): that is the next step for the bf16 path.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQRows = 64;   // query rows of a block
constexpr int kCols = 64;    // key columns or e columns per pass
constexpr int kChunk = 32;   // reduction depth per shared-memory stage
constexpr int kLd = kCols + 4;

// shared memory: at[(g + d)][kLd] holds [A | lq]^T (A^T alone for the
// two-output form, d = 0), then two staging tiles
size_t smem_bytes(int g, int d) {
    return (static_cast<size_t>(g + d) * kLd + 2 * kChunk * kLd) * sizeof(float);
}

// kGated: out = gate(...) from A, lq and lin_kv / lin_ku. Otherwise lq and
// lin_* are unused and the kernel writes out = A v and out_u = A u.
template <typename T, bool kGated>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ u, const T* __restrict__ mask, const T* __restrict__ lq,
    const T* __restrict__ lin_kv, const T* __restrict__ lin_ku, T* __restrict__ out,
    T* __restrict__ out_u, int n_groups, int g, int d, int e, float inv_g) {
    extern __shared__ __align__(16) float smem[];
    float (*at)[kLd] = reinterpret_cast<float (*)[kLd]>(smem);
    const int depth = kGated ? g + d : g;  // rows of at: A^T, then lq^T
    float (*s1)[kLd] = reinterpret_cast<float (*)[kLd]>(smem + static_cast<size_t>(depth) * kLd);
    float (*s2)[kLd] = s1 + kChunk;

    const int tid = threadIdx.x;
    const int i0 = blockIdx.x * kQRows;
    const size_t bg = static_cast<size_t>(blockIdx.z) * n_groups + blockIdx.y;
    const T* qg = q + bg * g * d;
    const T* kg = k + bg * g * d;
    const T* lqg = kGated ? lq + bg * g * d : nullptr;
    const T* vg = v + bg * g * e;
    const T* ug = u + bg * g * e;
    const T* mg = mask + bg * g;
    const T* kvb = kGated ? lin_kv + static_cast<size_t>(blockIdx.z) * d * e : nullptr;
    const T* kub = kGated ? lin_ku + static_cast<size_t>(blockIdx.z) * d * e : nullptr;
    T* og = out + bg * g * e;
    T* ogu = kGated ? nullptr : out_u + bg * g * e;

    // staging loader: one column (row of the tile) per thread, 8 of the 32 depth
    const int lc = tid % kCols;
    const int lk = (tid / kCols) * 8;
    // product: each thread owns 4 rows x 4 columns
    const int ty = tid / 16, tx = tid % 16;

    // ---- stage 1: A for rows i0..i0+63 and all g keys, transposed into at
    for (int j0 = 0; j0 < g; j0 += kCols) {
        float acc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
        const int qi = i0 + lc, kj = j0 + lc;
        for (int d0 = 0; d0 < d; d0 += kChunk) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int dd = d0 + lk + j;
                s1[lk + j][lc] = (qi < g && dd < d) ? td::to_f(qg[static_cast<size_t>(qi) * d + dd]) : 0.f;
                s2[lk + j][lc] = (kj < g && dd < d) ? td::to_f(kg[static_cast<size_t>(kj) * d + dd]) : 0.f;
            }
            __syncthreads();
#pragma unroll 8
            for (int kk = 0; kk < kChunk; ++kk) {
                const float4 a = *reinterpret_cast<const float4*>(&s1[kk][ty * 4]);
                const float4 bq = *reinterpret_cast<const float4*>(&s2[kk][tx * 4]);
                const float av[4] = {a.x, a.y, a.z, a.w};
                const float bw[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bw[c], acc[r][c]);
            }
            __syncthreads();
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int key = j0 + tx * 4 + c;
            if (key >= g) continue;
            const float m = td::to_f(mg[key]);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const float sim = fmaxf(acc[r][c] * inv_g, 0.f);
                at[key][ty * 4 + r] = td::round_to<T>(sim * sim * m);
            }
        }
    }
    // lq rows below A: at[g + dd][i] = lq[i0 + i][dd]
    if constexpr (kGated) {
        for (int idx = tid; idx < kQRows * d; idx += kThreads) {
            const int i = idx / d, dd = idx % d;
            at[g + dd][i] = (i0 + i < g) ? td::to_f(lqg[static_cast<size_t>(i0 + i) * d + dd]) : 0.f;
        }
    }
    __syncthreads();

    // ---- stage 2: [A | lq] . [v ; lin_kv] and [A | lq] . [u ; lin_ku] (A v and A u
    // for the two-output form), 64 e columns at a time
    for (int e0 = 0; e0 < e; e0 += kCols) {
        float av_acc[4][4], au_acc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) av_acc[r][c] = au_acc[r][c] = 0.f;
        const int col = e0 + lc;
        for (int k0 = 0; k0 < depth; k0 += kChunk) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int kk = k0 + lk + j;
                float vv = 0.f, uu = 0.f;
                if (col < e && kk < depth) {
                    if (!kGated || kk < g) {
                        vv = td::to_f(vg[static_cast<size_t>(kk) * e + col]);
                        uu = td::to_f(ug[static_cast<size_t>(kk) * e + col]);
                    } else {
                        vv = td::to_f(kvb[static_cast<size_t>(kk - g) * e + col]);
                        uu = td::to_f(kub[static_cast<size_t>(kk - g) * e + col]);
                    }
                }
                s1[lk + j][lc] = vv;
                s2[lk + j][lc] = uu;
            }
            __syncthreads();
            const int kmax = min(kChunk, depth - k0);
#pragma unroll 8
            for (int kk = 0; kk < kmax; ++kk) {
                const float4 a = *reinterpret_cast<const float4*>(&at[k0 + kk][ty * 4]);
                const float4 bv = *reinterpret_cast<const float4*>(&s1[kk][tx * 4]);
                const float4 bu = *reinterpret_cast<const float4*>(&s2[kk][tx * 4]);
                const float aw[4] = {a.x, a.y, a.z, a.w};
                const float vw[4] = {bv.x, bv.y, bv.z, bv.w};
                const float uw[4] = {bu.x, bu.y, bu.z, bu.w};
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        av_acc[r][c] = fmaf(aw[r], vw[c], av_acc[r][c]);
                        au_acc[r][c] = fmaf(aw[r], uw[c], au_acc[r][c]);
                    }
            }
            __syncthreads();
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int i = i0 + ty * 4 + r;
            if (i >= g) continue;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int cc = e0 + tx * 4 + c;
                if (cc >= e) continue;
                const size_t o = static_cast<size_t>(i) * e + cc;
                if constexpr (kGated) {
                    const float vf = td::to_f(vg[o]);
                    const float uf = td::to_f(ug[o]);
                    og[o] = td::Store<T>::from_f((au_acc[r][c] * vf) *
                                                 td::sigmoid_f(av_acc[r][c] * uf));
                } else {
                    og[o] = td::Store<T>::from_f(av_acc[r][c]);
                    ogu[o] = td::Store<T>::from_f(au_acc[r][c]);
                }
            }
        }
    }
}

template <typename T, bool kGated>
int launch(const void* q, const void* k, const void* v, const void* u, const void* mask,
           const void* lq, const void* lin_kv, const void* lin_ku, void* out, void* out_u,
           int batch, int n_groups, int g, int d, int e, cudaStream_t stream) {
    const size_t smem = smem_bytes(g, kGated ? d : 0);
    cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, kGated>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((g + kQRows - 1) / kQRows, n_groups, batch);
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
