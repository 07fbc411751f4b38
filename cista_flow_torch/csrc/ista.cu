// K3: the CISTA sparse-coding loop plus the Dg conv, as 3x3 reflect-padded
// direct convolutions with their epilogues fused.
//
// Replaces the TPU kernel cista_flow_tpu/ops/pallas_ista2.py
// (_fused_pallas_dg / fused_ista_dg): `depth` tied iterations of
//   z <- softshrink(P(x1 - D(z)) + z, lambda)
// then rec = relu(Dg(z)). D and Dg are 3x3 reflect convs 2C->C, P is C->2C.
// The wrapper (ops/cuda_ista2.py) launches this kernel 2*depth+1 times:
//   mode 0 (D):  out = x1 - (conv(z) + b)
//   mode 1 (P):  out = softshrink(conv(x1 - D(z)) + b + z, lambda)
//   mode 2 (Dg): out = relu(conv(z) + b)
// so no intermediate other than x1 - D(z) and z itself reaches device
// memory. Fusing all launches into one persistent kernel is later work.
//
// Bound on the H100: operations. At the flagship shapes (C=64, 90x120) a
// conv does 2*9*128*64 = 147k flops per pixel against ~0.5 KB of traffic.
// This first kernel runs its FMAs on the CUDA cores in f32 (also for bf16
// data, which is converted on load), so it is far from the bf16 tensor-core
// bound; wgmma tiles are later work. Design: a block computes a 16x32 pixel
// tile for 16 output channels; input channels stream through shared memory
// 8 at a time with the reflect halo resolved from indices (no padded copy);
// each thread keeps 4 pixels x 16 channels of f32 accumulators, reading
// weights as float4 broadcasts.
#include "common.cuh"

namespace {

constexpr int TH = 16, TW = 32;      // output tile
constexpr int PX = 4;                // pixels per thread, strided along x
constexpr int TXN = TW / PX;         // threads along x
constexpr int NT = TH * TXN;         // 128 threads
constexpr int CO = 16;               // output channels per block
constexpr int CI = 8;                // input channels per shared-memory stage

enum { MODE_D = 0, MODE_P = 1, MODE_G = 2 };

template <typename T, int MODE>
__global__ void __launch_bounds__(NT)
conv3x3_reflect_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ bias, const T* aux,
                       const T* __restrict__ lam, T* out,
                       int Cin, int Cout, int H, int W) {
    __shared__ float xs[CI][TH + 2][TW + 2];
    __shared__ __align__(16) float ws[CI][9][CO];

    const int tx = threadIdx.x % TXN, ty = threadIdx.x / TXN;
    const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
    const int groups = Cout / CO;
    const int b = blockIdx.z / groups;
    const int co0 = (blockIdx.z % groups) * CO;
    const long long hw = static_cast<long long>(H) * W;
    const T* xb = x + static_cast<long long>(b) * Cin * hw;

    float acc[PX][CO];
#pragma unroll
    for (int j = 0; j < PX; ++j)
#pragma unroll
        for (int c = 0; c < CO; ++c) acc[j][c] = 0.f;

    constexpr int TILE = (TH + 2) * (TW + 2);
    for (int c0 = 0; c0 < Cin; c0 += CI) {
        for (int i = threadIdx.x; i < CI * TILE; i += NT) {
            const int ci = i / TILE, r = i - ci * TILE;
            const int yy = r / (TW + 2), xx = r - yy * (TW + 2);
            const int gy = reflect_clamp(y0 + yy - 1, H);
            const int gx = reflect_clamp(x0 + xx - 1, W);
            xs[ci][yy][xx] = to_f(xb[(c0 + ci) * hw + static_cast<long long>(gy) * W + gx]);
        }
        // weights are OIHW (Cout, Cin, 3, 3); stage as [ci][tap][co]
        for (int i = threadIdx.x; i < CI * 9 * CO; i += NT) {
            const int co = i / (CI * 9), r = i - co * (CI * 9);
            const int ci = r / 9, tap = r - ci * 9;
            ws[ci][tap][co] = to_f(w[(static_cast<long long>(co0 + co) * Cin + c0 + ci) * 9 + tap]);
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
                    for (int j = 0; j < PX; ++j) xv[j] = xs[ci][ty + ky][tx + j * TXN + kx];
                    const float4* wp = reinterpret_cast<const float4*>(&ws[ci][ky * 3 + kx][0]);
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

    const int py = y0 + ty;
    if (py >= H) return;
#pragma unroll
    for (int j = 0; j < PX; ++j) {
        const int px = x0 + tx + j * TXN;
        if (px >= W) continue;
#pragma unroll
        for (int c = 0; c < CO; ++c) {
            const long long o = (static_cast<long long>(b) * Cout + co0 + c) * hw
                                + static_cast<long long>(py) * W + px;
            float v = acc[j][c] + to_f(bias[co0 + c]);
            if (MODE == MODE_D) {
                v = to_f(aux[o]) - v;
            } else if (MODE == MODE_P) {
                // aux (z) may alias out: each element is read by the thread
                // that overwrites it, just before the store
                v = v + to_f(aux[o]);
                const float l = to_f(lam[co0 + c]);
                v = fmaxf(v - l, 0.f) - fmaxf(-v - l, 0.f);
            } else {
                v = fmaxf(v, 0.f);
            }
            out[o] = from_f<T>(v);
        }
    }
}

template <typename T>
int launch(int mode, const void* x, const void* w, const void* bias,
           const void* aux, const void* lam, void* out,
           int B, int Cin, int Cout, int H, int W, cudaStream_t st) {
    const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * (Cout / CO));
    const T* xt = static_cast<const T*>(x);
    const T* wt = static_cast<const T*>(w);
    const T* bt = static_cast<const T*>(bias);
    const T* at = static_cast<const T*>(aux);
    const T* lt = static_cast<const T*>(lam);
    T* ot = static_cast<T*>(out);
    if (mode == MODE_D)
        conv3x3_reflect_kernel<T, MODE_D><<<grid, NT, 0, st>>>(xt, wt, bt, at, lt, ot, Cin, Cout, H, W);
    else if (mode == MODE_P)
        conv3x3_reflect_kernel<T, MODE_P><<<grid, NT, 0, st>>>(xt, wt, bt, at, lt, ot, Cin, Cout, H, W);
    else if (mode == MODE_G)
        conv3x3_reflect_kernel<T, MODE_G><<<grid, NT, 0, st>>>(xt, wt, bt, at, lt, ot, Cin, Cout, H, W);
    else
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (B, Cin, H, W); w: (Cout, Cin, 3, 3); bias, lam: (Cout,);
// aux, out: (B, Cout, H, W). All in dtype. Cin % 8 == 0, Cout % 16 == 0.
CISTA_EXPORT int cista_ista_conv(int mode, int dtype, const void* x, const void* w,
                                 const void* bias, const void* aux, const void* lam,
                                 void* out, int B, int Cin, int Cout, int H, int W,
                                 void* stream) {
    if (B <= 0 || H < 2 || W < 2 || Cin <= 0 || Cin % CI != 0 || Cout <= 0
        || Cout % CO != 0 || B * (Cout / CO) > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == DT_F32)
        return launch<float>(mode, x, w, bias, aux, lam, out, B, Cin, Cout, H, W, st);
    if (dtype == DT_BF16)
        return launch<__nv_bfloat16>(mode, x, w, bias, aux, lam, out, B, Cin, Cout, H, W, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
