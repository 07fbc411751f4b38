// K5: stride-1 3x3 convolution C -> C with zeros or reflect padding, bias
// and an optional relu fused, f32 accumulation.
//
// Replaces the TPU kernel cista_flow_tpu/ops/pallas_conv.py (_conv3x3_padded /
// conv3x3). That kernel builds an im2col patch matrix in VMEM so that one
// GEMM of depth 9C fills the TPU's 128-deep matrix unit, and takes an input
// that was padded beforehand. Neither carries over: here the halo is an
// index reflect or a zero test while a tile is staged, so no padded copy is
// made, and the contraction is a direct sum over channels and taps.
//
// Bound on the H100: operations and bytes meet at the encoders' largest
// shape ((8, 64, 96, 128) in bf16: 7.2 GFLOP against 25 MB, about 0.0075 ms
// either way); wider or deeper shapes are bound by operations. Two inner
// products:
//  * f32, and bf16 at widths that are no multiple of 64: the shared direct
//    tile of conv3x3_direct.cuh (CUDA-core f32 FMAs, 16x32 pixels x 16
//    channels per block), far from the tensor-core bound;
//  * bf16 at C % 64 == 0 (the widths the models route here): an implicit
//    GEMM on the tensor cores (nvcuda::wmma, 16x16x16 bf16, f32
//    accumulators). A block of 8 warps owns 8 rows x 32 pixels x 64 output
//    channels; warp r owns row r as two 16-pixel A tiles. Input channels
//    stream through shared memory 16 at a time, staged pixel-major
//    ([row][col][16 ch], halo included), so that for each of the 9 taps the
//    A tile of 16 neighbouring pixels is a row-major 16x16 matrix at a
//    32-byte-aligned address whatever the tap's shift; a thread stages 8
//    channels of one pixel (8 loads, each contiguous along x across the
//    warp) with one 16-byte store. The weights of a stage sit as
//    [tap][16 ch][64 out]; a small kernel first repacks OIHW into that
//    order in scratch ([C/16][tap][16][C]), so that staging them is a
//    16-byte copy. The accumulators leave through a small shared buffer,
//    channel-major, so that the NCHW store is contiguous along x. No
//    double buffering and no TMA yet.
// Blocks are numbered along one grid dimension (channel group fastest, so
// that the blocks sharing an input tile run together), which keeps any
// batch the serving window folds in (T+1 times the streams) inside the
// grid limits.
#include <mma.h>

#include "conv3x3_direct.cuh"

namespace {

using namespace conv3x3;
namespace wm = nvcuda::wmma;

constexpr int MTH = 8, MTW = 32;     // tensor-core tile: one warp per row
constexpr int MNT = MTH * 32;        // 256 threads
constexpr int MK = 16;               // input channels per stage = one mma depth
constexpr int MCO = 64;              // output channels per block

// OIHW (C, C, 3, 3) -> [C/16][tap][16][C]: wt[((s*9 + tap)*16 + k)*C + co]
__global__ void repack_weights_kernel(const __nv_bfloat16* __restrict__ w,
                                      __nv_bfloat16* __restrict__ wt, int C) {
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= C * C * 9) return;
    const int co = idx % C, k = (idx / C) % MK;
    const int tap = (idx / (C * MK)) % 9, s = idx / (C * MK * 9);
    wt[idx] = w[(static_cast<long long>(co) * C + s * MK + k) * 9 + tap];
}

template <bool REFLECT, bool RELU>
__global__ void __launch_bounds__(MNT)
conv3x3_bf16_mma_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ wt,
                        const __nv_bfloat16* __restrict__ bias,
                        __nv_bfloat16* __restrict__ out,
                        int C, int H, int W, int tiles_x, int tiles_y) {
    __shared__ __align__(32) __nv_bfloat16 xs[MTH + 2][MTW + 2][MK];
    __shared__ __align__(32) __nv_bfloat16 ws[9][MK][MCO];
    __shared__ __align__(32) float os[MTH][16][MTW];

    const int groups = C / MCO;
    int i = blockIdx.x;
    const int co0 = (i % groups) * MCO;  i /= groups;
    const int x0 = (i % tiles_x) * MTW;  i /= tiles_x;
    const int y0 = (i % tiles_y) * MTH;
    const int b = i / tiles_y;
    const long long hw = static_cast<long long>(H) * W;
    const __nv_bfloat16* xb = x + static_cast<long long>(b) * C * hw;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    wm::fragment<wm::accumulator, 16, 16, 16, float> acc[2][MCO / 16];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < MCO / 16; ++n) wm::fill_fragment(acc[m][n], 0.f);

    constexpr int PLANE = (MTH + 2) * (MTW + 2);
    for (int c0 = 0; c0 < C; c0 += MK) {
        // a task is one pixel x 8 channels; consecutive threads take
        // consecutive pixels, so each of the 8 loads is contiguous along x
        for (int j = threadIdx.x; j < 2 * PLANE; j += MNT) {
            const int half = j / PLANE, r = j - half * PLANE;
            const int yy = r / (MTW + 2), xx = r - yy * (MTW + 2);
            int gy = y0 + yy - 1, gx = x0 + xx - 1;
            bool inside = true;
            if (REFLECT) {
                gy = reflect_clamp(gy, H);
                gx = reflect_clamp(gx, W);
            } else {
                inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
            }
            __align__(16) __nv_bfloat16 v[8];
            const __nv_bfloat16* src = xb + (c0 + half * 8) * hw
                                       + static_cast<long long>(gy) * W + gx;
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = inside ? src[e * hw] : __float2bfloat16(0.f);
            *reinterpret_cast<uint4*>(&xs[yy][xx][half * 8]) = *reinterpret_cast<const uint4*>(v);
        }
        // this stage's repacked weights: 9*16 rows of this block's 64 outputs
        const __nv_bfloat16* wsrc = wt + static_cast<long long>(c0 / MK) * 9 * MK * C + co0;
        for (int j = threadIdx.x; j < 9 * MK * (MCO / 8); j += MNT) {
            const int row = j / (MCO / 8), q = j - row * (MCO / 8);
            *reinterpret_cast<uint4*>(&ws[0][0][0] + row * MCO + q * 8) =
                *reinterpret_cast<const uint4*>(wsrc + static_cast<long long>(row) * C + q * 8);
        }
        __syncthreads();
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
            for (int kx = 0; kx < 3; ++kx) {
                wm::fragment<wm::matrix_a, 16, 16, 16, __nv_bfloat16, wm::row_major> a[2];
                wm::load_matrix_sync(a[0], &xs[warp + ky][kx][0], MK);
                wm::load_matrix_sync(a[1], &xs[warp + ky][16 + kx][0], MK);
#pragma unroll
                for (int n = 0; n < MCO / 16; ++n) {
                    wm::fragment<wm::matrix_b, 16, 16, 16, __nv_bfloat16, wm::row_major> bf;
                    wm::load_matrix_sync(bf, &ws[ky * 3 + kx][0][n * 16], MCO);
                    wm::mma_sync(acc[0][n], a[0], bf, acc[0][n]);
                    wm::mma_sync(acc[1][n], a[1], bf, acc[1][n]);
                }
            }
        }
        __syncthreads();
    }

    // epilogue: 16 channels at a time through os[warp] as [channel][pixel]
    const int py = y0 + warp, px = x0 + lane;
    const bool inside = py < H && px < W;
#pragma unroll
    for (int n = 0; n < MCO / 16; ++n) {
        wm::store_matrix_sync(&os[warp][0][0], acc[0][n], MTW, wm::mem_col_major);
        wm::store_matrix_sync(&os[warp][0][16], acc[1][n], MTW, wm::mem_col_major);
        __syncwarp();
        if (inside) {
#pragma unroll
            for (int c = 0; c < 16; ++c) {
                const int co = co0 + n * 16 + c;
                float v = os[warp][c][lane];
                if (bias != nullptr) v += __bfloat162float(bias[co]);
                if (RELU) v = fmaxf(v, 0.f);
                out[(static_cast<long long>(b) * C + co) * hw
                    + static_cast<long long>(py) * W + px] = __float2bfloat16(v);
            }
        }
        __syncwarp();
    }
}

int launch_bf16_mma(int reflect, int relu, const void* x, const void* w, const void* bias,
                    void* wscratch, void* out, int B, int C, int H, int W, cudaStream_t st) {
    if (wscratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const int tiles_x = (W + MTW - 1) / MTW, tiles_y = (H + MTH - 1) / MTH;
    const long long blocks = static_cast<long long>(B) * (C / MCO) * tiles_x * tiles_y;
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(blocks));
    const __nv_bfloat16* xt = static_cast<const __nv_bfloat16*>(x);
    __nv_bfloat16* wt = static_cast<__nv_bfloat16*>(wscratch);
    const __nv_bfloat16* bt = static_cast<const __nv_bfloat16*>(bias);
    __nv_bfloat16* ot = static_cast<__nv_bfloat16*>(out);
    repack_weights_kernel<<<(C * C * 9 + 255) / 256, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(w), wt, C);
#define CISTA_LAUNCH(R, A) \
    conv3x3_bf16_mma_kernel<R, A><<<grid, MNT, 0, st>>>(xt, wt, bt, ot, C, H, W, tiles_x, tiles_y)
    if (reflect && relu) CISTA_LAUNCH(true, true);
    else if (reflect) CISTA_LAUNCH(true, false);
    else if (relu) CISTA_LAUNCH(false, true);
    else CISTA_LAUNCH(false, false);
#undef CISTA_LAUNCH
    return static_cast<int>(cudaGetLastError());
}

template <typename T, bool REFLECT, bool RELU>
__global__ void __launch_bounds__(NT)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const T* __restrict__ bias, T* __restrict__ out,
               int C, int H, int W, int tiles_x, int tiles_y) {
    __shared__ Stage sm;
    const int groups = C / CO;
    int i = blockIdx.x;
    const int co0 = (i % groups) * CO;  i /= groups;
    const int x0 = (i % tiles_x) * TW;  i /= tiles_x;
    const int y0 = (i % tiles_y) * TH;
    const int b = i / tiles_y;
    const long long hw = static_cast<long long>(H) * W;

    float acc[PX][CO];
    accumulate<T, REFLECT>(sm, x + static_cast<long long>(b) * C * hw, w, C, H, W,
                           x0, y0, co0, acc);
    store_tile(acc, H, W, x0, y0, [&](int c, long long pix, float v) {
        if (bias != nullptr) v += to_f(bias[co0 + c]);
        if (RELU) v = fmaxf(v, 0.f);
        out[(static_cast<long long>(b) * C + co0 + c) * hw + pix] = from_f<T>(v);
    });
}

template <typename T>
int launch(int reflect, int relu, const void* x, const void* w, const void* bias,
           void* out, int B, int C, int H, int W, cudaStream_t st) {
    const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
    const long long blocks = static_cast<long long>(B) * (C / CO) * tiles_x * tiles_y;
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(blocks));
    const T* xt = static_cast<const T*>(x);
    const T* wt = static_cast<const T*>(w);
    const T* bt = static_cast<const T*>(bias);
    T* ot = static_cast<T*>(out);
#define CISTA_LAUNCH(R, A) \
    conv3x3_kernel<T, R, A><<<grid, NT, 0, st>>>(xt, wt, bt, ot, C, H, W, tiles_x, tiles_y)
    if (reflect && relu) CISTA_LAUNCH(true, true);
    else if (reflect) CISTA_LAUNCH(true, false);
    else if (relu) CISTA_LAUNCH(false, true);
    else CISTA_LAUNCH(false, false);
#undef CISTA_LAUNCH
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (B, C, H, W); w: (C, C, 3, 3); bias: (C,) or null. All in dtype.
// wscratch: for bf16, room for another copy of w (the repacked weights);
// else unused. C % 16 == 0; H, W >= 2 (reflect padding needs two rows and
// columns).
CISTA_EXPORT int cista_conv3x3(int dtype, int reflect, int relu, const void* x,
                               const void* w, const void* bias, void* wscratch,
                               void* out, int B, int C, int H, int W, void* stream) {
    if (B <= 0 || H < 2 || W < 2 || C <= 0 || C % CO != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == DT_F32) return launch<float>(reflect, relu, x, w, bias, out, B, C, H, W, st);
    if (dtype == DT_BF16 && C % MCO == 0)
        return launch_bf16_mma(reflect, relu, x, w, bias, wscratch, out, B, C, H, W, st);
    if (dtype == DT_BF16)
        return launch<__nv_bfloat16>(reflect, relu, x, w, bias, out, B, C, H, W, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
