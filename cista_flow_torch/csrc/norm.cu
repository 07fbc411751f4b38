// K4: instance norm (+ optional relu), and its stats phase alone (K4s).
//
// Replaces the TPU kernels in cista_flow_tpu/ops/pallas_norm.py:
// _instance_norm_pallas (instance_norm_fused) and instance_norm_stats.
// Per (sample, channel) plane of an NCHW tensor: f32 mean, f32 mean of the
// squared deviations (the two-pass form of the JAX package's f32 path),
// inv = 1/sqrt(var + eps), y = (x - mean) * inv, optional relu; the stats
// phase writes mean and inv and no y.
//
// Bound on the H100: bytes, one read of x and one write of y; a few flops
// per element. The encoders' planes are 768, 3072 and 12288 elements (the
// 1/8, 1/4 and 1/2 resolution of a padded 192x256 frame), so most planes
// are small and the old one-block-per-plane design spent its time in block
// barriers and dependent loads, not in bytes. What the design does:
// - Each plane is read once, into registers, with 16-byte loads (8 bf16 or
//   4 f32 values); both sums and the normalisation are taken from the
//   registers, and y is written with 16-byte stores.
// - Small planes get one warp each, four planes a block, and their sums
//   are warp shuffles only: no block barrier. Larger planes get one block
//   of 256 or 512 threads, and each sum one shared-memory exchange of the
//   warp partials. (A f32 plane of 12288 values at 12 vectors a thread left
//   room for three blocks an SM and was slower than at 6 on 512 threads.)
// - The vectors per thread (NV) and the threads per plane (TPP) are
//   template constants. Six are instantiated, the ones the encoders' planes
//   take: bf16 768 -> (3, warp), 3072 -> (12, warp), 12288 -> (6, 256);
//   f32 768 -> (6, warp), 3072 -> (3, 256), 12288 -> (6, 512). The wrapper
//   picks one from the plane size (ops/cuda_norm.launch_rule) and masks the
//   vectors past the plane's end.
// - Planes whose size is not a multiple of the vector width (their starts
//   are not 16-byte aligned), misaligned tensors and planes of more than
//   12288 values take a generic kernel: one block per plane, scalar loads
//   in three passes (the second and third from L1/L2).
#include "common.cuh"

namespace {

constexpr int WARP_PLANES = 4;       // planes per block on the warp route
constexpr int LOOP_THREADS = 256;    // threads per plane on the generic route

// the VEC values of a 16-byte vector, as f32
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {        // a bf16 is the high half of its f32
        f[2 * i] = __uint_as_float(w[i] << 16);
        f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
        w[i] = static_cast<unsigned>(__bfloat16_as_ushort(from_f<__nv_bfloat16>(f[2 * i])))
               | static_cast<unsigned>(__bfloat16_as_ushort(from_f<__nv_bfloat16>(f[2 * i + 1])))
                     << 16;
    return make_uint4(w[0], w[1], w[2], w[3]);
}

// Sum over the TPP threads of a plane; every thread gets the same total.
// TPP = 32: shuffles only. Otherwise the block is the plane: one exchange of
// the warp partials through sh (each reduction its own sh, so no second
// barrier guards its reuse).
template <int TPP>
__device__ __forceinline__ float plane_sum(float v, float* sh) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if constexpr (TPP == 32) {
        return v;
    } else {
        if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
        __syncthreads();
        float t = 0.f;
#pragma unroll
        for (int w = 0; w < TPP / 32; ++w) t += sh[w];
        return t;
    }
}

// Thread t of a plane holds vectors i = j*TPP + t, j < NV, of the plane's
// hw / VEC; vectors past the end are masked.
template <typename T, int NV, int TPP>
__global__ void __launch_bounds__(TPP == 32 ? 32 * WARP_PLANES : TPP)
instance_norm_vec_kernel(const T* __restrict__ x, T* __restrict__ y,
                         float* __restrict__ mean_out, float* __restrict__ inv_out,
                         long long planes, int hw, float eps, int relu) {
    constexpr int VEC = 16 / sizeof(T);
    __shared__ float sh[2][TPP == 32 ? 1 : TPP / 32];
    const int t = TPP == 32 ? (threadIdx.x & 31) : threadIdx.x;
    const long long plane = TPP == 32
        ? static_cast<long long>(blockIdx.x) * WARP_PLANES + (threadIdx.x >> 5)
        : static_cast<long long>(blockIdx.x);
    if (plane >= planes) return;      // warp route only: a whole warp leaves
    const int nvec = hw / VEC;
    const uint4* xp = reinterpret_cast<const uint4*>(x + plane * hw);

    uint4 r[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j)
        if (j * TPP + t < nvec) r[j] = xp[j * TPP + t];

    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
        if (j * TPP + t < nvec) {
            float f[VEC];
            unpack(r[j], f);
#pragma unroll
            for (int e = 0; e < VEC; ++e) s += f[e];
        }
    }
    const float mean = plane_sum<TPP>(s, sh[0]) / static_cast<float>(hw);

    float q = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
        if (j * TPP + t < nvec) {
            float f[VEC];
            unpack(r[j], f);
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
                const float d = f[e] - mean;
                q += d * d;
            }
        }
    }
    const float var = plane_sum<TPP>(q, sh[1]) / static_cast<float>(hw);
    const float inv = 1.0f / sqrtf(var + eps);

    if (mean_out != nullptr && t == 0) {
        mean_out[plane] = mean;
        inv_out[plane] = inv;
    }
    if (y == nullptr) return;
    uint4* yp = reinterpret_cast<uint4*>(y + plane * hw);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
        if (j * TPP + t < nvec) {
            float f[VEC];
            unpack(r[j], f);
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
                f[e] = (f[e] - mean) * inv;
                if (relu) f[e] = fmaxf(f[e], 0.f);
            }
            yp[j * TPP + t] = pack(f);
        }
    }
}

__device__ __forceinline__ float block_sum(float v, float* sh) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    if (lane == 0) sh[wid] = v;
    __syncthreads();
    if (wid == 0) {
        float t = lane < LOOP_THREADS / 32 ? sh[lane] : 0.f;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
        if (lane == 0) sh[32] = t;
    }
    __syncthreads();
    const float r = sh[32];
    __syncthreads();  // sh is reused by the next reduction
    return r;
}

// The generic route: one block per plane, three passes of scalar loads.
template <typename T>
__global__ void __launch_bounds__(LOOP_THREADS)
instance_norm_loop_kernel(const T* __restrict__ x, T* __restrict__ y,
                          float* __restrict__ mean_out, float* __restrict__ inv_out,
                          int hw, float eps, int relu) {
    __shared__ float sh[33];
    const long long plane = blockIdx.x;
    const T* xp = x + plane * hw;

    float s = 0.f;
    for (int i = threadIdx.x; i < hw; i += LOOP_THREADS) s += to_f(xp[i]);
    const float mean = block_sum(s, sh) / static_cast<float>(hw);

    float q = 0.f;
    for (int i = threadIdx.x; i < hw; i += LOOP_THREADS) {
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
    for (int i = threadIdx.x; i < hw; i += LOOP_THREADS) {
        float v = (to_f(xp[i]) - mean) * inv;
        if (relu) v = fmaxf(v, 0.f);
        yp[i] = from_f<T>(v);
    }
}

template <typename T, int NV, int TPP>
int launch_vec(const void* x, void* y, void* mean, void* inv, long long planes, int hw,
               float eps, int relu, cudaStream_t st) {
    constexpr int ppb = TPP == 32 ? WARP_PLANES : 1;
    const long long blocks = (planes + ppb - 1) / ppb;
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    instance_norm_vec_kernel<T, NV, TPP><<<static_cast<unsigned>(blocks), TPP * ppb, 0, st>>>(
        static_cast<const T*>(x), static_cast<T*>(y), static_cast<float*>(mean),
        static_cast<float*>(inv), planes, hw, eps, relu);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, void* y, void* mean, void* inv, long long planes, int hw,
             float eps, int relu, int nv, int tpp, cudaStream_t st) {
    constexpr int VEC = 16 / sizeof(T);
    if (nv == 0) {
        if (tpp != LOOP_THREADS || planes > 2147483647LL)
            return static_cast<int>(cudaErrorInvalidValue);
        instance_norm_loop_kernel<T><<<static_cast<unsigned>(planes), LOOP_THREADS, 0, st>>>(
            static_cast<const T*>(x), static_cast<T*>(y), static_cast<float*>(mean),
            static_cast<float*>(inv), hw, eps, relu);
        return static_cast<int>(cudaGetLastError());
    }
    // the vector route needs whole 16-byte vectors and enough of them
    const bool aligned = reinterpret_cast<size_t>(x) % 16 == 0
                         && reinterpret_cast<size_t>(y) % 16 == 0;
    if (hw % VEC != 0 || !aligned || static_cast<long long>(nv) * tpp * VEC < hw)
        return static_cast<int>(cudaErrorInvalidValue);
#define CISTA_NORM_CASE(TPP_, NV_) \
    if (tpp == TPP_ && nv == NV_) \
        return launch_vec<T, NV_, TPP_>(x, y, mean, inv, planes, hw, eps, relu, st);
    // ops/cuda_norm.VECTOR_ROUTES
    if constexpr (sizeof(T) == 2) {
        CISTA_NORM_CASE(32, 3) CISTA_NORM_CASE(32, 12) CISTA_NORM_CASE(256, 6)
    } else {
        CISTA_NORM_CASE(32, 6) CISTA_NORM_CASE(256, 3) CISTA_NORM_CASE(512, 6)
    }
#undef CISTA_NORM_CASE
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// y may be null (stats only); mean/inv may be null (normalize only).
// nv, tpp: vectors per thread and threads per plane (ops/cuda_norm.py
// launch_rule); nv = 0 is the generic route.
CISTA_EXPORT int cista_instance_norm(int dtype, const void* x, void* y,
                                     void* mean, void* inv, long long planes,
                                     int hw, float eps, int relu, int nv, int tpp,
                                     void* stream) {
    if (planes <= 0 || hw <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == DT_F32)
        return dispatch<float>(x, y, mean, inv, planes, hw, eps, relu, nv, tpp, st);
    if (dtype == DT_BF16)
        return dispatch<__nv_bfloat16>(x, y, mean, inv, planes, hw, eps, relu, nv, tpp, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
