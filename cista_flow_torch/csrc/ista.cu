// K3: the CISTA sparse-coding loop plus the Dg conv, as 3x3 reflect-padded
// convolutions with their epilogues fused.
//
// Replaces the TPU kernel cista_flow_tpu/ops/pallas_ista2.py
// (_fused_pallas_dg / fused_ista_dg): `depth` tied iterations of
//   z <- softshrink(P(x1 - D(z)) + z, lambda)
// then rec = relu(Dg(z)). D and Dg are 3x3 reflect convs 2C->C, P is C->2C.
// The wrapper (ops/cuda_ista2.py) launches one conv kernel 2*depth+1 times:
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
// Two inner products:
//  * bf16 at C % 64 == 0: the wgmma tile of conv3x3_mma.cuh
//    (cista_ista_conv_mma). x1, x1 - D(z) and the running z are private to
//    one call of the wrapper, so they live channel-grouped, (B, C/8, H, W, 8):
//    a pixel's 8 channels are the 16 bytes that one cp.async moves into the
//    staged tile, reflect halo included, and the epilogue's channel pairs
//    are 4-byte accesses that a warp makes 128 contiguous bytes at a time.
//    The wrapper converts from and to NCHW at the call's two ends
//    (cista_regroup; the Dg launch writes NCHW itself) and hands over the
//    three weight tensors repacked once. Between launches the three arrays
//    (28 MB at batch 8) stay in the L2 cache. A block owns all Cout of
//    8x32-pixel tiles. The sums
//    start from the bias, and an item's aux values (x1 or z) are all loaded
//    before its first store, so that the loads are in flight together.
//  * f32, and bf16 at other widths: the direct tile of conv3x3_direct.cuh
//    on NCHW (cista_ista_conv): CUDA-core f32 FMAs, far from the tensor-core
//    bound; f32 parity needs full f32 products.
#include "conv3x3_direct.cuh"
#include "ista_mma.cuh"

namespace {

namespace mma = conv3x3_mma;
using namespace conv3x3;
using namespace ista_mma;

// x: channel-grouped (B, Cin/8, H, W, 8); wr: the repacked weights.
template <typename TL, int MODE>
__global__ void __launch_bounds__(TL::NT)
ista_conv_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wr,
                     const __nv_bfloat16* __restrict__ bias, const __nv_bfloat16* aux,
                     const __nv_bfloat16* __restrict__ lam, __nv_bfloat16* out,
                     int B, int Cin, int Cout, int H, int W) {
    extern __shared__ __align__(128) unsigned char smem[];
    IstaEpilogue<TL, MODE> epi{bias, aux, lam, out, Cout, H, W};
    mma::conv_tiles<TL, true, true>(smem, x, wr, B, Cin, Cout, H, W, epi);
}

template <typename TL>
int launch_mma_tile(int mode, const void* x, const void* wr, const void* bias, const void* aux,
                    const void* lam, void* out, int B, int Cin, int Cout, int H, int W,
                    cudaStream_t st) {
    auto kernel = mode == MODE_D ? ista_conv_mma_kernel<TL, MODE_D>
                  : mode == MODE_P ? ista_conv_mma_kernel<TL, MODE_P>
                                   : ista_conv_mma_kernel<TL, MODE_G>;
    int blocks = 0;
    const cudaError_t e = mma::grid_blocks<TL>(kernel, mma::Grid<TL>(Cout, H, W).items(B),
                                               &blocks);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<blocks, TL::NT, TL::SMEM_BYTES, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wr),
        static_cast<const __nv_bfloat16*>(bias), static_cast<const __nv_bfloat16*>(aux),
        static_cast<const __nv_bfloat16*>(lam), static_cast<__nv_bfloat16*>(out),
        B, Cin, Cout, H, W);
    return static_cast<int>(cudaGetLastError());
}

template <bool TO_GROUPED>
__global__ void __launch_bounds__(256)
regroup_kernel(const __nv_bfloat16* __restrict__ in, __nv_bfloat16* __restrict__ out,
               long long chunks, int HW) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i < chunks) regroup_chunk<TO_GROUPED>(in, out, i, HW);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(NT)
conv3x3_reflect_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ bias, const T* aux,
                       const T* __restrict__ lam, T* out,
                       int Cin, int Cout, int H, int W) {
    __shared__ Stage sm;
    // (sample, channel group) along x, which has no 65,535 limit, so any
    // batch fits; the tile's row and column along y and z
    const int groups = Cout / CO;
    const int b = blockIdx.x / groups;
    const int co0 = (blockIdx.x % groups) * CO;
    const int y0 = blockIdx.y * TH, x0 = blockIdx.z * TW;
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
    const long long bg = static_cast<long long>(B) * (Cout / CO);
    const int tiles_y = (H + TH - 1) / TH, tiles_x = (W + TW - 1) / TW;
    if (bg > 2147483647LL || tiles_y > 65535 || tiles_x > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(bg), tiles_y, tiles_x);
    const T* xt = static_cast<const T*>(x);
    const T* wt = static_cast<const T*>(w);
    const T* bt = static_cast<const T*>(bias);
    const T* at = static_cast<const T*>(aux);
    const T* lt = static_cast<const T*>(lam);
    T* ot = static_cast<T*>(out);
#define CISTA_LAUNCH(M) \
    conv3x3_reflect_kernel<T, M><<<grid, NT, 0, st>>>(xt, wt, bt, at, lt, ot, Cin, Cout, H, W)
    if (mode == MODE_D) CISTA_LAUNCH(MODE_D);
    else if (mode == MODE_P) CISTA_LAUNCH(MODE_P);
    else CISTA_LAUNCH(MODE_G);
#undef CISTA_LAUNCH
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The direct tile. x: (B, Cin, H, W); w: (Cout, Cin, 3, 3); bias, lam:
// (Cout,); aux, out: (B, Cout, H, W). All in dtype. Cin % 8 == 0,
// Cout % 16 == 0.
CISTA_EXPORT int cista_ista_conv(int mode, int dtype, const void* x, const void* w,
                                 const void* bias, const void* aux, const void* lam,
                                 void* out, int B, int Cin, int Cout, int H, int W,
                                 void* stream) {
    if (B <= 0 || H < 2 || W < 2 || Cin <= 0 || Cin % CI != 0 || Cout <= 0
        || Cout % CO != 0 || mode < MODE_D || mode > MODE_G)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == DT_F32)
        return launch<float>(mode, x, w, bias, aux, lam, out, B, Cin, Cout, H, W, st);
    if (dtype == DT_BF16)
        return launch<__nv_bfloat16>(mode, x, w, bias, aux, lam, out, B, Cin, Cout, H, W, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core tile, bf16. x: (B, Cin/8, H, W, 8); wr: the repacked
// weights (Cin/8, 9, Cout, 8); bias, lam: (Cout,); aux: (B, Cout/8, H, W, 8)
// (unused in mode G); out: as aux in modes D and P, NCHW (B, Cout, H, W) in
// mode G. Cin % 32 == 0, Cout % 64 == 0.
CISTA_EXPORT int cista_ista_conv_mma(int mode, const void* x, const void* wr,
                                     const void* bias, const void* aux, const void* lam,
                                     void* out, int B, int Cin, int Cout, int H, int W,
                                     void* stream) {
    if (B <= 0 || H < 2 || W < 2 || Cin <= 0 || Cin % 32 != 0 || Cout <= 0
        || Cout % 64 != 0 || mode < MODE_D || mode > MODE_G)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    int sms = 0;
    const cudaError_t e = mma::sm_count(&sms);
    if (e != cudaSuccess) return static_cast<int>(e);
    // the large tile where it gives every SM a block, else the small one
    if (Cout % 128 == 0 && mma::Grid<mma::Large128>(Cout, H, W).items(B) >= sms)
        return launch_mma_tile<mma::Large128>(mode, x, wr, bias, aux, lam, out,
                                             B, Cin, Cout, H, W, st);
    if (mma::Grid<mma::Large64>(Cout, H, W).items(B) >= sms)
        return launch_mma_tile<mma::Large64>(mode, x, wr, bias, aux, lam, out,
                                            B, Cin, Cout, H, W, st);
    return launch_mma_tile<mma::Small64>(mode, x, wr, bias, aux, lam, out,
                                         B, Cin, Cout, H, W, st);
}

// bf16 layout passes at the two ends of a call on the tensor-core route.
// to_grouped != 0: x (B, C, H, W) -> out (B, C/8, H, W, 8); else the reverse.
// C % 8 == 0.
CISTA_EXPORT int cista_regroup(int to_grouped, const void* x, void* out, int B, int C,
                               int H, int W, void* stream) {
    if (B <= 0 || C <= 0 || C % 8 != 0 || H <= 0 || W <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long hw = static_cast<long long>(H) * W;
    const long long chunks = static_cast<long long>(B) * (C / 8) * hw;
    const long long blocks = (chunks + 255) / 256;
    if (hw > 2147483647LL || blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const __nv_bfloat16* xt = static_cast<const __nv_bfloat16*>(x);
    __nv_bfloat16* ot = static_cast<__nv_bfloat16*>(out);
    if (to_grouped)
        regroup_kernel<true><<<static_cast<unsigned>(blocks), 256, 0, st>>>(
            xt, ot, chunks, static_cast<int>(hw));
    else
        regroup_kernel<false><<<static_cast<unsigned>(blocks), 256, 0, st>>>(
            xt, ot, chunks, static_cast<int>(hw));
    return static_cast<int>(cudaGetLastError());
}
