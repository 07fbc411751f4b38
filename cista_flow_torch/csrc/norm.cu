// K4: instance norm (+ optional relu), and its stats phase alone.
//
// Replaces the TPU kernels in cista_flow_tpu/ops/pallas_norm.py:
// _instance_norm_pallas (instance_norm_fused) and instance_norm_stats.
// Per (sample, channel) plane of an NCHW tensor: f32 mean, f32 biased
// variance, y = (x - mean) / sqrt(var + eps), optional relu, eps 1e-5.
//
// Bound on the H100: bytes. The work is a few flops per element, so the
// least time is one read of x and one write of y at HBM rate. One block owns
// one contiguous plane (HW elements) and makes three passes over it: sum ->
// mean, sum of squared deviations -> var (the two-pass form, as the JAX
// package's f32 path), then normalize + relu + store. The planes on the
// flow encoders' path are 768..12288 elements (<= 48 KB in f32), so the
// second and third passes are served by L1/L2 and device memory sees about
// one read and one write. No shared-memory staging and no vector loads yet:
// a simple kernel first.
#include "common.cuh"

namespace {

constexpr int NT = 256;

__device__ __forceinline__ float block_sum(float v, float* sh) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    if (lane == 0) sh[wid] = v;
    __syncthreads();
    if (wid == 0) {
        float t = lane < NT / 32 ? sh[lane] : 0.f;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
        if (lane == 0) sh[32] = t;
    }
    __syncthreads();
    const float r = sh[32];
    __syncthreads();  // sh is reused by the next reduction
    return r;
}

template <typename T>
__global__ void __launch_bounds__(NT)
instance_norm_kernel(const T* __restrict__ x, T* __restrict__ y,
                     float* __restrict__ mean_out, float* __restrict__ inv_out,
                     int hw, float eps, int relu) {
    __shared__ float sh[33];
    const long long plane = blockIdx.x;
    const T* xp = x + plane * hw;

    float s = 0.f;
    for (int i = threadIdx.x; i < hw; i += NT) s += to_f(xp[i]);
    const float mean = block_sum(s, sh) / static_cast<float>(hw);

    float q = 0.f;
    for (int i = threadIdx.x; i < hw; i += NT) {
        const float d = to_f(xp[i]) - mean;
        q += d * d;
    }
    const float var = block_sum(q, sh) / static_cast<float>(hw);
    const float inv = 1.0f / sqrtf(var + eps);

    if (mean_out != nullptr && threadIdx.x == 0) {
        mean_out[plane] = mean;
        inv_out[plane] = inv;
    }
    if (y == nullptr) return;
    T* yp = y + plane * hw;
    for (int i = threadIdx.x; i < hw; i += NT) {
        float v = (to_f(xp[i]) - mean) * inv;
        if (relu) v = fmaxf(v, 0.f);
        yp[i] = from_f<T>(v);
    }
}

}  // namespace

// y may be null (stats only); mean/inv may be null (normalize only).
CISTA_EXPORT int cista_instance_norm(int dtype, const void* x, void* y,
                                     void* mean, void* inv, long long planes,
                                     int hw, float eps, int relu,
                                     void* stream) {
    if (planes <= 0 || hw <= 0 || planes > 2147483647LL)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 grid(static_cast<unsigned>(planes));
    if (dtype == DT_F32) {
        instance_norm_kernel<float><<<grid, NT, 0, st>>>(
            static_cast<const float*>(x), static_cast<float*>(y),
            static_cast<float*>(mean), static_cast<float*>(inv), hw, eps, relu);
    } else if (dtype == DT_BF16) {
        instance_norm_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(
            static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
            static_cast<float*>(mean), static_cast<float*>(inv), hw, eps, relu);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
