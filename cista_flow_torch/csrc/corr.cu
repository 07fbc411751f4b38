// K1: the RAFT correlation-pyramid window lookup, with the motion
// encoder's convc1 (1x1 conv 324->256 + bias + relu) fused in.
//
// Replaces the TPU kernel cista_flow_tpu/ops/pallas_corr.py
// (_lookup_all_levels / lookup_corr_pallas, proj=). For each 1/8-res sample
// and each of the 4 pyramid levels it takes the 9x9 bilinear window of
// radius 4 at coords/2^l, zeros outside the level (grid_sample zeros
// padding). Channels are level-major, then x-offset-major (the reference's
// meshgrid quirk): k = l*81 + bx*9 + ay samples (x + bx - 4, y + ay - 4).
// The TPU kernel's radix band selection and transposed padded slabs exist
// because the TPU has no cheap gathers; here each tap is four direct loads
// from the level in device memory.
//
// Bound on the H100: with the projection, operations (2*324*256 flops per
// sample against ~2 KB of pyramid reads); without it, bytes. Design: a
// block owns 16 samples. Its 256 threads first assemble the 16 x 324 window
// in shared memory (k-major, so the product reads it as float4 broadcasts);
// then thread t computes output channel t for all 16 samples, streaming the
// pre-transposed (324, 256) weight through shared memory 18 rows at a time.
// The (n, 324) window never reaches device memory. f32 accumulation on the
// CUDA cores; wgmma is later work. Coordinates far outside a level cannot
// index out of bounds: a tap whose position is not in (-1, size) reads 0
// without a load. The same test makes an empty level (h or w of 0, the last
// level of a frame under 64 px) read as zeros: no corner of it is in range.
#include "common.cuh"

namespace {

constexpr int R = 4;
constexpr int WIN = 2 * R + 1;       // 9
constexpr int TAPS = WIN * WIN;      // 81
constexpr int NLV = 4;
constexpr int K = NLV * TAPS;        // 324
constexpr int S = 16;                // samples per block
constexpr int NT = 256;              // threads; == projected channels
constexpr int KC = 18;               // weight rows staged per round (K % KC == 0)

struct Levels {
    const void* p[NLV];
    int h[NLV];
    int w[NLV];
};

template <typename T>
__device__ __forceinline__ float bilinear_zeros(const T* plane, int h, int w,
                                                float px, float py) {
    if (!(px > -1.f && px < static_cast<float>(w) && py > -1.f && py < static_cast<float>(h)))
        return 0.f;
    const float x0f = floorf(px), y0f = floorf(py);
    const float fx = px - x0f, fy = py - y0f;
    const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f);
    const bool xl = x0 >= 0, xh = x0 + 1 < w, yl = y0 >= 0, yh = y0 + 1 < h;
    const float v00 = (xl && yl) ? to_f(plane[y0 * w + x0]) : 0.f;
    const float v01 = (xh && yl) ? to_f(plane[y0 * w + x0 + 1]) : 0.f;
    const float v10 = (xl && yh) ? to_f(plane[(y0 + 1) * w + x0]) : 0.f;
    const float v11 = (xh && yh) ? to_f(plane[(y0 + 1) * w + x0 + 1]) : 0.f;
    return ((1.f - fy) * v00 + fy * v10) * (1.f - fx) + ((1.f - fy) * v01 + fy * v11) * fx;
}

template <typename T, bool PROJ>
__global__ void __launch_bounds__(NT)
corr_lookup_kernel(Levels lv, const float* __restrict__ coords,
                   const T* __restrict__ wt, const T* __restrict__ bias,
                   T* __restrict__ out, int n, int hw1) {
    __shared__ __align__(16) float win[K][S];
    __shared__ float wsm[KC][NT];
    __shared__ float cxy[S][2];

    const int s0 = blockIdx.x * S;
    if (threadIdx.x < 2 * S) {
        const int s = threadIdx.x >> 1, d = threadIdx.x & 1;
        const int nn = s0 + s;
        float v = 0.f;
        if (nn < n) {
            const int b = nn / hw1, p = nn - b * hw1;
            v = coords[(static_cast<long long>(b) * 2 + d) * hw1 + p];
        }
        cxy[s][d] = v;
    }
    __syncthreads();

    for (int i = threadIdx.x; i < K * S; i += NT) {
        const int s = i % S, k = i / S;
        const int nn = s0 + s;
        float v = 0.f;
        if (nn < n) {
            const int l = k / TAPS, j = k - l * TAPS;
            const int bx = j / WIN, ay = j - bx * WIN;
            const float scale = 1.0f / static_cast<float>(1 << l);
            const float px = cxy[s][0] * scale + static_cast<float>(bx - R);
            const float py = cxy[s][1] * scale + static_cast<float>(ay - R);
            const int hl = lv.h[l], wl = lv.w[l];
            const T* plane = static_cast<const T*>(lv.p[l])
                             + static_cast<long long>(nn) * hl * wl;
            v = bilinear_zeros(plane, hl, wl, px, py);
            if (!PROJ) {
                const int b = nn / hw1, p = nn - b * hw1;
                out[(static_cast<long long>(b) * K + k) * hw1 + p] = from_f<T>(v);
            }
        }
        if (PROJ) win[k][s] = v;
    }
    if (!PROJ) return;
    __syncthreads();

    const int co = threadIdx.x;
    float acc[S];
#pragma unroll
    for (int s = 0; s < S; ++s) acc[s] = 0.f;
    for (int k0 = 0; k0 < K; k0 += KC) {
        for (int i = threadIdx.x; i < KC * NT; i += NT) {
            const int kk = i / NT, c = i - kk * NT;
            wsm[kk][c] = to_f(wt[static_cast<long long>(k0 + kk) * NT + c]);
        }
        __syncthreads();
#pragma unroll 6
        for (int kk = 0; kk < KC; ++kk) {
            const float wv = wsm[kk][co];
            const float4* wp = reinterpret_cast<const float4*>(&win[k0 + kk][0]);
#pragma unroll
            for (int q = 0; q < S / 4; ++q) {
                const float4 a = wp[q];
                acc[4 * q + 0] += a.x * wv;
                acc[4 * q + 1] += a.y * wv;
                acc[4 * q + 2] += a.z * wv;
                acc[4 * q + 3] += a.w * wv;
            }
        }
        __syncthreads();
    }
    const float bb = to_f(bias[co]);
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const int nn = s0 + s;
        if (nn < n) {
            const int b = nn / hw1, p = nn - b * hw1;
            out[(static_cast<long long>(b) * NT + co) * hw1 + p] = from_f<T>(fmaxf(acc[s] + bb, 0.f));
        }
    }
}

template <typename T>
int launch(int proj, const Levels& lv, const float* coords, const void* wt,
           const void* bias, void* out, int n, int hw1, cudaStream_t st) {
    const dim3 grid((n + S - 1) / S);
    if (proj)
        corr_lookup_kernel<T, true><<<grid, NT, 0, st>>>(
            lv, coords, static_cast<const T*>(wt), static_cast<const T*>(bias),
            static_cast<T*>(out), n, hw1);
    else
        corr_lookup_kernel<T, false><<<grid, NT, 0, st>>>(
            lv, coords, nullptr, nullptr, static_cast<T*>(out), n, hw1);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Levels l0..l3: (n, h_l, w_l) in dtype, n = B*H1*W1 samples.
// coords: (B, 2, H1, W1) f32 level-0 pixel coords; hw1 = H1*W1.
// proj != 0: wt (324, 256) and bias (256,) in dtype, out (B, 256, H1, W1);
// proj == 0: out (B, 324, H1, W1).
CISTA_EXPORT int cista_corr_lookup(int dtype, int proj,
                                   const void* l0, const void* l1,
                                   const void* l2, const void* l3,
                                   int h0, int h1, int h2, int h3,
                                   int w0, int w1, int w2, int w3,
                                   const void* coords, const void* wt,
                                   const void* bias, void* out,
                                   int n, int hw1, void* stream) {
    if (n <= 0 || hw1 <= 0) return static_cast<int>(cudaErrorInvalidValue);
    Levels lv;
    lv.p[0] = l0; lv.p[1] = l1; lv.p[2] = l2; lv.p[3] = l3;
    lv.h[0] = h0; lv.h[1] = h1; lv.h[2] = h2; lv.h[3] = h3;
    lv.w[0] = w0; lv.w[1] = w1; lv.w[2] = w2; lv.w[3] = w3;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* c = static_cast<const float*>(coords);
    if (dtype == DT_F32) return launch<float>(proj, lv, c, wt, bias, out, n, hw1, st);
    if (dtype == DT_BF16) return launch<__nv_bfloat16>(proj, lv, c, wt, bias, out, n, hw1, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
