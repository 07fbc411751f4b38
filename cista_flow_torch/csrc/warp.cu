// K2: the reflection warp, fused: grid, reflect fold, 4-corner gather and
// f32 blend in one kernel.
//
// Replaces the TPU kernel cista_flow_tpu/ops/pallas_aug.py
// (_build_aug_pallas / build_aug). On the TPU that kernel only stages the
// four corner rows [x[n] | x[n+1] | x[n+W] | x[n+W+1]] of a flat (N, C)
// image so that XLA can fetch all four bilinear corners with ONE row
// gather; gathers are the TPU's slow operation, and the staging exists to
// stream those rows at bandwidth. Hopper gathers from L1/L2 cheaply, so the
// counterpart here computes the function the staging serves: the
// reflection-mode sample_pixel_coords of cista_flow_tpu/ops/warp.py
// (:114-122 fold and clamp, :134-184 corners and blend), with the
// reference's non-standard 2*(x/W - 0.5) grid normalization
// (warp.py:211-222). The four-times-wider staging array is never built.
//
// Bound on the H100: bytes (one read of the image and the flow, one write
// of the output; a few dozen flops per pixel). Layout: NCHW, one thread per
// output pixel. The thread folds its coordinates once, then walks the C
// channel planes; neighbouring threads handle neighbouring pixels, so the
// stores and most corner loads of a warp are coalesced within each plane.
// That serves both callers: C=1 (the frame, full resolution) and C=128 (the
// sparse code, half resolution). A channel-last read would give each
// thread 128 contiguous values but needs the NHWC copy the port does not
// keep.
#include "common.cuh"

namespace {

constexpr int NT = 256;

// torch reflect_coordinates with align_corners=True: fold into [0, span].
__device__ __forceinline__ float reflect_coord(float c, float span) {
    if (span <= 0.f) return 0.f;
    const float two = 2.f * span;
    const float r = fmodf(fabsf(c), two);
    return r > span ? two - r : r;
}

template <typename T>
__global__ void __launch_bounds__(NT)
warp_reflect_kernel(const T* __restrict__ img, const float* __restrict__ flow,
                    T* __restrict__ out, int B, int C, int H, int W, float sign) {
    const long long hw = static_cast<long long>(H) * W;
    const long long idx = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
    if (idx >= B * hw) return;
    const int b = static_cast<int>(idx / hw);
    const long long p = idx - b * hw;
    const int y = static_cast<int>(p / W);
    const int x = static_cast<int>(p - static_cast<long long>(y) * W);

    const float* fb = flow + static_cast<long long>(b) * 2 * hw;
    const float gx = static_cast<float>(x) + sign * fb[p];
    const float gy = static_cast<float>(y) + sign * fb[hw + p];
    // reference normalization, then grid_sample's align_corners=True map
    const float nx = 2.0f * (gx / static_cast<float>(W) - 0.5f);
    const float ny = 2.0f * (gy / static_cast<float>(H) - 0.5f);
    float ux = (nx + 1.0f) * 0.5f * static_cast<float>(W - 1);
    float uy = (ny + 1.0f) * 0.5f * static_cast<float>(H - 1);
    ux = fminf(fmaxf(reflect_coord(ux, static_cast<float>(W - 1)), 0.f),
               static_cast<float>(W - 1));
    uy = fminf(fmaxf(reflect_coord(uy, static_cast<float>(H - 1)), 0.f),
               static_cast<float>(H - 1));

    const float x0f = floorf(ux), y0f = floorf(uy);
    const float wx1 = ux - x0f, wy1 = uy - y0f;
    const float wx0 = 1.f - wx1, wy0 = 1.f - wy1;
    const float w00 = wx0 * wy0, w01 = wx1 * wy0, w10 = wx0 * wy1, w11 = wx1 * wy1;
    // coordinates are folded into range: the +1 corner only leaves the
    // image where its weight is exactly 0
    const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f);
    const int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
    const long long o00 = static_cast<long long>(y0) * W + x0;
    const long long o01 = static_cast<long long>(y0) * W + x1;
    const long long o10 = static_cast<long long>(y1) * W + x0;
    const long long o11 = static_cast<long long>(y1) * W + x1;

    const T* ib = img + static_cast<long long>(b) * C * hw;
    T* ob = out + static_cast<long long>(b) * C * hw;
    for (int c = 0; c < C; ++c) {
        const T* pl = ib + c * hw;
        float v = 0.f;
        v += to_f(pl[o00]) * w00;
        v += to_f(pl[o01]) * w01;
        v += to_f(pl[o10]) * w10;
        v += to_f(pl[o11]) * w11;
        ob[c * hw + p] = from_f<T>(v);
    }
}

}  // namespace

// img, out: (B, C, H, W) in dtype; flow: (B, 2, H, W) f32 pixel flow.
// Samples img at (x + sign*flow_x, y + sign*flow_y).
CISTA_EXPORT int cista_warp_reflect(int dtype, const void* img, const void* flow,
                                    void* out, int B, int C, int H, int W,
                                    float sign, void* stream) {
    if (B <= 0 || C <= 0 || H <= 0 || W <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long n = static_cast<long long>(B) * H * W;
    const dim3 grid(static_cast<unsigned>((n + NT - 1) / NT));
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == DT_F32) {
        warp_reflect_kernel<float><<<grid, NT, 0, st>>>(
            static_cast<const float*>(img), static_cast<const float*>(flow),
            static_cast<float*>(out), B, C, H, W, sign);
    } else if (dtype == DT_BF16) {
        warp_reflect_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(
            static_cast<const __nv_bfloat16*>(img), static_cast<const float*>(flow),
            static_cast<__nv_bfloat16*>(out), B, C, H, W, sign);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
