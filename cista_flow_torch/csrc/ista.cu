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
// memory. The whole loop in one persistent launch is K6 (ista_loop.cu).
// K3a (the loop alone, pallas_ista2.py _fused_pallas / fused_ista_v2) is 2*depth
// launches of modes 0 and 1 from its own wrapper in the same module.
//
// Bound on the H100: operations. At the flagship shapes (C=64, 90x120) a
// conv does 2*9*128*64 = 147k flops per pixel against ~0.5 KB of traffic.
// The conv tile (conv3x3_direct.cuh) runs its FMAs on the CUDA cores in f32
// (also for bf16 data, which is converted on load), so it is far from the
// bf16 tensor-core bound.
#include "conv3x3_direct.cuh"

namespace {

using namespace conv3x3;

enum { MODE_D = 0, MODE_P = 1, MODE_G = 2 };

template <typename T, int MODE>
__global__ void __launch_bounds__(NT)
conv3x3_reflect_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ bias, const T* aux,
                       const T* __restrict__ lam, T* out,
                       int Cin, int Cout, int H, int W) {
    __shared__ Stage sm;
    const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
    const int groups = Cout / CO;
    const int b = blockIdx.z / groups;
    const int co0 = (blockIdx.z % groups) * CO;
    const long long hw = static_cast<long long>(H) * W;

    float acc[PX][CO];
    accumulate<T, true>(sm, x + static_cast<long long>(b) * Cin * hw, w, Cin, H, W,
                        x0, y0, co0, acc);
    store_tile(acc, H, W, x0, y0, [&](int c, long long pix, float v) {
        const long long o = (static_cast<long long>(b) * Cout + co0 + c) * hw + pix;
        v += to_f(bias[co0 + c]);
        if (MODE == MODE_D) {
            v = to_f(aux[o]) - v;
        } else if (MODE == MODE_P) {
            // aux (z) may alias out: each element is read by the thread
            // that overwrites it, just before the store
            v = softshrink(v + to_f(aux[o]), to_f(lam[co0 + c]));
        } else {
            v = fmaxf(v, 0.f);
        }
        out[o] = from_f<T>(v);
    });
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
