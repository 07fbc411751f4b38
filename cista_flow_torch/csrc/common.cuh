// Shared helpers for the port's CUDA kernels: dtype codes, float
// conversion, and the C-interface conventions every kernel follows.
//
// Every exported function takes raw device pointers and the caller's
// cudaStream_t, launches without synchronising, and returns
// cudaGetLastError() so that a refused launch is reported to the caller.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

// dtype codes shared with the Python wrappers (ops/cuda_build.py)
enum { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// torch ReflectionPad semantics for an index at most one step outside
// [0, n); clamped afterwards so that halo reads past a tile's ragged edge
// stay inside the buffer (their results are never stored).
__device__ __forceinline__ int reflect_clamp(int i, int n) {
    if (i < 0) i = -i;
    if (i >= n) i = 2 * n - 2 - i;
    return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

#define CISTA_EXPORT extern "C" __attribute__((visibility("default")))

CISTA_EXPORT const char* cista_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
