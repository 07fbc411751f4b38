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
#include "conv3x3_mma.cuh"

namespace {

namespace mma = conv3x3_mma;
using namespace conv3x3;

enum { MODE_D = 0, MODE_P = 1, MODE_G = 2 };

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The three epilogues of the tensor-core route; the sums start from the
// bias. aux and (modes D, P) out are channel-grouped (B, Cout/8, H, W, 8);
// mode G's out is NCHW. aux (z) may alias out in mode P: each element is
// read by the thread that overwrites it, and all aux pairs of an item are
// loaded before its first store.
template <typename TL, int MODE>
struct IstaEpilogue {
    static constexpr int PAIRS = TL::BN / 8;
    const __nv_bfloat16* bias;
    const __nv_bfloat16* aux;
    const __nv_bfloat16* lam;
    __nv_bfloat16* out;
    int Cout, H, W;

    // the pair (c, c + 1) of pixel 0 in the grouped layout; pair j and pixel
    // pix sit j * 8 * H * W + 8 * pix elements further on
    __device__ __forceinline__ long long offset(int b, int n0) const {
        return (static_cast<long long>(b) * (Cout / 8) + n0 / 8) * H * W * 8
               + mma::pair_channel();
    }

    __device__ __forceinline__ void init(float (&acc)[TL::MT][TL::BN / 2], int n0) const {
        mma::init_bias<TL>(acc, bias, n0);
    }

    __device__ __forceinline__ void store(const float (&acc)[TL::MT][TL::BN / 2],
                                          int b, int y0, int x0, int n0) const {
        const long long hw = static_cast<long long>(H) * W;
        int pix[TL::MT][2];
        mma::thread_pixels<TL>(H, W, y0, x0, pix);
        const int c0 = n0 + mma::pair_channel();
        // every aux pair of the item first, so that the loads fly together
        uint32_t av[TL::MT][2][PAIRS];
        if (MODE != MODE_G) {
            const __nv_bfloat16* a0 = aux + offset(b, n0);
#pragma unroll
            for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    if (pix[mt][h] < 0) continue;
#pragma unroll
                    for (int j = 0; j < PAIRS; ++j)
                        av[mt][h][j] = *reinterpret_cast<const uint32_t*>(
                            a0 + j * 8 * hw + 8 * pix[mt][h]);
                }
        }
#pragma unroll
        for (int j = 0; j < PAIRS; ++j) {
            float2 lv = make_float2(0.f, 0.f);
            if (MODE == MODE_P) lv = load_pair(lam + c0 + 8 * j);
#pragma unroll
            for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    if (pix[mt][h] < 0) continue;
                    float v0 = acc[mt][4 * j + 2 * h], v1 = acc[mt][4 * j + 2 * h + 1];
                    if (MODE == MODE_G) {
                        __nv_bfloat16* o = out + (static_cast<long long>(b) * Cout + c0 + 8 * j) * hw
                                           + pix[mt][h];
                        o[0] = __float2bfloat16(fmaxf(v0, 0.f));
                        o[hw] = __float2bfloat16(fmaxf(v1, 0.f));
                        continue;
                    }
                    const float2 a = __bfloat1622float2(
                        *reinterpret_cast<const __nv_bfloat162*>(&av[mt][h][j]));
                    if (MODE == MODE_D) {
                        v0 = a.x - v0;
                        v1 = a.y - v1;
                    } else {
                        v0 = softshrink(v0 + a.x, lv.x);
                        v1 = softshrink(v1 + a.y, lv.y);
                    }
                    *reinterpret_cast<__nv_bfloat162*>(
                        out + offset(b, n0) + j * 8 * hw + 8 * pix[mt][h]) =
                        __floats2bfloat162_rn(v0, v1);
                }
        }
    }
};

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

// NCHW (B, C, H*W) <-> channel-grouped (B, C/8, H*W, 8): a thread moves the
// 8 channels of one pixel of one group, 8 accesses a plane apart (each
// contiguous across the warp) on the NCHW side and 16 bytes on the other.
template <bool TO_GROUPED>
__global__ void __launch_bounds__(256)
regroup_kernel(const __nv_bfloat16* __restrict__ in, __nv_bfloat16* __restrict__ out,
               long long chunks, int HW) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= chunks) return;
    const long long g = i / HW;                       // sample * C/8 + group
    const long long plane0 = g * 8 * HW + (i - g * HW);
    __align__(16) __nv_bfloat16 v[8];
    if (TO_GROUPED) {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = in[plane0 + static_cast<long long>(e) * HW];
        *reinterpret_cast<uint4*>(out + i * 8) = *reinterpret_cast<const uint4*>(v);
    } else {
        *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(in + i * 8);
#pragma unroll
        for (int e = 0; e < 8; ++e) out[plane0 + static_cast<long long>(e) * HW] = v[e];
    }
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
