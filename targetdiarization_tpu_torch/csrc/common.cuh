// Shared helpers of the port's kernels: float32 math on float32 or
// bfloat16 storage.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace td {

static __device__ __forceinline__ float to_f(float v) { return v; }
static __device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> struct Store;
template <> struct Store<float> {
    static __device__ __forceinline__ float from_f(float v) { return v; }
};
template <> struct Store<__nv_bfloat16> {
    static __device__ __forceinline__ __nv_bfloat16 from_f(float v) { return __float2bfloat16_rn(v); }
};

// v rounded to T's precision, kept as float (the TPU kernels cast an
// intermediate to the input type before a matrix product).
template <typename T>
static __device__ __forceinline__ float round_to(float v) { return to_f(Store<T>::from_f(v)); }

static __device__ __forceinline__ float sigmoid_f(float v) { return 1.0f / (1.0f + expf(-v)); }

}  // namespace td
