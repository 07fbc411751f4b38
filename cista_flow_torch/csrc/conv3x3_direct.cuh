// A direct stride-1 3x3 convolution tile, shared by the kernels that are
// 3x3 convs with different epilogues: K6 (ista_loop.cu) in both dtypes, and
// K3/K3a (ista.cu) and K5 (conv3x3.cu) in f32 and at widths that are no
// multiple of 64 (in bf16 at the models' widths those run the tensor-core
// tile of conv3x3_mma.cuh).
//
// A block of NT = 128 threads computes a TH x TW = 16x32 pixel tile of one
// sample for CO = 16 output channels. Input channels stream through shared
// memory CI = 8 at a time, with the 1-pixel halo resolved from indices
// while staging (a reflected index, or a zero outside the frame): no padded
// copy of the input exists anywhere. Each thread keeps PX = 4 pixels
// (strided along x) x 16 channels of f32 accumulators and reads the staged
// weights as float4 broadcasts. The FMAs run on the CUDA cores in f32, also
// for bf16 data (converted while staging). The caller owns the epilogue:
// `store_tile` hands it each accumulator with its channel and pixel.
#pragma once

#include "common.cuh"

namespace conv3x3 {

constexpr int TH = 16, TW = 32;      // output tile
constexpr int PX = 4;                // pixels per thread, strided along x
constexpr int TXN = TW / PX;         // threads along x
constexpr int NT = TH * TXN;         // 128 threads
constexpr int CO = 16;               // output channels per block
constexpr int CI = 8;                // input channels per shared-memory stage

struct Stage {
    float xs[CI][TH + 2][TW + 2];
    alignas(16) float ws[CI][9][CO];
};

// acc[j][c] = sum over Cin and the 9 taps for pixel (y0 + ty, x0 + tx + j*TXN)
// and output channel co0 + c, without the bias. xb: this sample's
// (Cin, H, W) planes; w: OIHW (Cout, Cin, 3, 3). All NT threads must call
// it together; `sm` is free again when it returns. xb carries no
// __restrict__: K6 reads planes that other blocks wrote earlier in the same
// launch, which must not go through the read-only cache.
template <typename T, bool REFLECT>
__device__ __forceinline__ void accumulate(Stage& sm, const T* xb,
                                           const T* __restrict__ w, int Cin,
                                           int H, int W, int x0, int y0, int co0,
                                           float (&acc)[PX][CO]) {
    const int tx = threadIdx.x % TXN, ty = threadIdx.x / TXN;
    const long long hw = static_cast<long long>(H) * W;
#pragma unroll
    for (int j = 0; j < PX; ++j)
#pragma unroll
        for (int c = 0; c < CO; ++c) acc[j][c] = 0.f;

    constexpr int TILE = (TH + 2) * (TW + 2);
    for (int c0 = 0; c0 < Cin; c0 += CI) {
        for (int i = threadIdx.x; i < CI * TILE; i += NT) {
            const int ci = i / TILE, r = i - ci * TILE;
            const int yy = r / (TW + 2), xx = r - yy * (TW + 2);
            int gy = y0 + yy - 1, gx = x0 + xx - 1;
            float v = 0.f;
            if (REFLECT) {
                gy = reflect_clamp(gy, H);
                gx = reflect_clamp(gx, W);
                v = to_f(xb[(c0 + ci) * hw + static_cast<long long>(gy) * W + gx]);
            } else if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
                v = to_f(xb[(c0 + ci) * hw + static_cast<long long>(gy) * W + gx]);
            }
            sm.xs[ci][yy][xx] = v;
        }
        // weights staged as [ci][tap][co]
        for (int i = threadIdx.x; i < CI * 9 * CO; i += NT) {
            const int co = i / (CI * 9), r = i - co * (CI * 9);
            const int ci = r / 9, tap = r - ci * 9;
            sm.ws[ci][tap][co] =
                to_f(w[(static_cast<long long>(co0 + co) * Cin + c0 + ci) * 9 + tap]);
        }
        __syncthreads();
#pragma unroll 2
        for (int ci = 0; ci < CI; ++ci) {
#pragma unroll
            for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
                for (int kx = 0; kx < 3; ++kx) {
                    float xv[PX];
#pragma unroll
                    for (int j = 0; j < PX; ++j) xv[j] = sm.xs[ci][ty + ky][tx + j * TXN + kx];
                    const float4* wp = reinterpret_cast<const float4*>(&sm.ws[ci][ky * 3 + kx][0]);
#pragma unroll
                    for (int q = 0; q < CO / 4; ++q) {
                        const float4 wv = wp[q];
#pragma unroll
                        for (int j = 0; j < PX; ++j) {
                            acc[j][4 * q + 0] += xv[j] * wv.x;
                            acc[j][4 * q + 1] += xv[j] * wv.y;
                            acc[j][4 * q + 2] += xv[j] * wv.z;
                            acc[j][4 * q + 3] += xv[j] * wv.w;
                        }
                    }
                }
            }
        }
        __syncthreads();
    }
}

// Calls epi(c, pix, v) for every accumulator of this thread that lies inside
// the frame: c = channel within the block's CO, pix = y*W + x, v = acc. No
// thread returns early, so a persistent kernel can go on to its next tile.
template <typename Epi>
__device__ __forceinline__ void store_tile(const float (&acc)[PX][CO], int H, int W,
                                           int x0, int y0, Epi epi) {
    const int tx = threadIdx.x % TXN, ty = threadIdx.x / TXN;
    const int py = y0 + ty;
    if (py < H) {
#pragma unroll
        for (int j = 0; j < PX; ++j) {
            const int px = x0 + tx + j * TXN;
            if (px < W) {
#pragma unroll
                for (int c = 0; c < CO; ++c)
                    epi(c, static_cast<long long>(py) * W + px, acc[j][c]);
            }
        }
    }
}

__device__ __forceinline__ float softshrink(float v, float l) {
    return fmaxf(v - l, 0.f) - fmaxf(-v - l, 0.f);
}

}  // namespace conv3x3
