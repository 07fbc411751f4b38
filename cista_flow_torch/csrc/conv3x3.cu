// K5: stride-1 3x3 convolution C -> C with zeros or reflect padding, bias
// and an optional relu fused, f32 accumulation.
//
// Replaces the TPU kernel cista_flow_tpu/ops/pallas_conv.py (_conv3x3_padded /
// conv3x3). That kernel builds an im2col patch matrix in its fast memory so
// that one deep GEMM fills the TPU's matrix unit, and takes an input that
// was padded beforehand. Neither carries over: here the halo is an index
// reflect or a zero test while a tile is staged, so no padded copy is made,
// and the 9 taps are 9 shifted views of one staged tile.
//
// Bound on the H100: operations and bytes meet at the encoders' largest
// shape ((8, 64, 96, 128) in bf16: 7.2 GFLOP against 25 MB); wider or deeper
// shapes are bound by operations. Two inner products:
//  * bf16 at C % 64 == 0 (the widths the models route here): the wgmma
//    implicit-GEMM tile of conv3x3_mma.cuh. A block owns all C outputs of
//    8x32-pixel tiles; the NCHW input is turned channel-innermost while it
//    is staged (8 loads a thread, each contiguous along x across the warp,
//    one 16-byte shared store), under the products of the previous stage.
//    The weights come repacked by the wrapper, once per weight tensor. When
//    that grid would leave SMs without a block (the 1/8-resolution shape at
//    a small batch), blocks of one 8x8 sub-tile x 64 outputs are used
//    instead. The sums start from the bias and go from registers to NCHW,
//    8 neighbouring pixels of a channel at a time.
//  * f32, and bf16 at other widths: the direct tile of conv3x3_direct.cuh
//    (CUDA-core f32 FMAs), far from the tensor-core bound; f32 parity needs
//    full f32 products.
// Blocks are numbered along one grid dimension, which keeps any batch the
// serving window folds in (T+1 times the streams) inside the grid limits.
#include "conv3x3_direct.cuh"
#include "conv3x3_mma.cuh"

namespace {

namespace mma = conv3x3_mma;
using namespace conv3x3;

// sums that start from the bias; relu, then NCHW: a warp's store is 8
// neighbouring pixels of 4 channels
template <typename TL>
struct BiasReluStore {
    const __nv_bfloat16* bias;
    __nv_bfloat16* out;
    int C, H, W, relu;

    __device__ __forceinline__ void init(float (&acc)[TL::MT][TL::BN / 2], int n0) const {
        mma::init_bias<TL>(acc, bias, n0);
    }
    __device__ __forceinline__ void store(const float (&acc)[TL::MT][TL::BN / 2],
                                          int b, int y0, int x0, int n0) const {
        const long long hw = static_cast<long long>(H) * W;
        int pix[TL::MT][2];
        mma::thread_pixels<TL>(H, W, y0, x0, pix);
        __nv_bfloat16* o0 = out + (static_cast<long long>(b) * C + n0 + mma::pair_channel()) * hw;
#pragma unroll
        for (int j = 0; j < TL::BN / 8; ++j)
#pragma unroll
            for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    if (pix[mt][h] < 0) continue;
                    float v0 = acc[mt][4 * j + 2 * h], v1 = acc[mt][4 * j + 2 * h + 1];
                    if (relu) {
                        v0 = fmaxf(v0, 0.f);
                        v1 = fmaxf(v1, 0.f);
                    }
                    __nv_bfloat16* o = o0 + 8 * j * hw + pix[mt][h];
                    o[0] = __float2bfloat16(v0);
                    o[hw] = __float2bfloat16(v1);
                }
    }
};

template <typename TL, bool REFLECT>
__global__ void __launch_bounds__(TL::NT)
conv3x3_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wr,
                   const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                   int B, int C, int H, int W, int relu) {
    extern __shared__ __align__(128) unsigned char smem[];
    BiasReluStore<TL> epi{bias, out, C, H, W, relu};
    mma::conv_tiles<TL, false, REFLECT>(smem, x, wr, B, C, C, H, W, epi);
}

template <typename TL>
int launch_mma_tile(int reflect, int relu, const void* x, const void* wr, const void* bias,
                    void* out, int B, int C, int H, int W, cudaStream_t st) {
    auto kernel = reflect ? conv3x3_mma_kernel<TL, true> : conv3x3_mma_kernel<TL, false>;
    int blocks = 0;
    const cudaError_t e = mma::grid_blocks<TL>(kernel, mma::Grid<TL>(C, H, W).items(B), &blocks);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<blocks, TL::NT, TL::SMEM_BYTES, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wr),
        static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out),
        B, C, H, W, relu);
    return static_cast<int>(cudaGetLastError());
}

// The large tile where it gives every SM a block, else the small one.
int launch_mma(int reflect, int relu, const void* x, const void* wr, const void* bias,
               void* out, int B, int C, int H, int W, cudaStream_t st) {
    int sms = 0;
    const cudaError_t e = mma::sm_count(&sms);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (C % 128 == 0 && mma::Grid<mma::Large128>(C, H, W).items(B) >= sms)
        return launch_mma_tile<mma::Large128>(reflect, relu, x, wr, bias, out, B, C, H, W, st);
    if (mma::Grid<mma::Large64>(C, H, W).items(B) >= sms)
        return launch_mma_tile<mma::Large64>(reflect, relu, x, wr, bias, out, B, C, H, W, st);
    return launch_mma_tile<mma::Small64>(reflect, relu, x, wr, bias, out, B, C, H, W, st);
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

// x, out: (B, C, H, W) in dtype; bias: (C,) in dtype or null. `packed` says
// what w is: 0 = OIHW (C, C, 3, 3) in dtype, for the direct tile; 1 = bf16
// repacked as (C/8, 9, C, 8) for the tensor-core tile (dtype bf16 and
// C % 64 == 0 only). C % 16 == 0; H, W >= 2 (reflect padding needs two rows
// and columns).
CISTA_EXPORT int cista_conv3x3(int dtype, int reflect, int relu, int packed, const void* x,
                               const void* w, const void* bias, void* out,
                               int B, int C, int H, int W, void* stream) {
    if (B <= 0 || H < 2 || W < 2 || C <= 0 || C % CO != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (packed) {
        if (dtype != DT_BF16 || C % 64 != 0) return static_cast<int>(cudaErrorInvalidValue);
        return launch_mma(reflect, relu, x, w, bias, out, B, C, H, W, st);
    }
    if (dtype == DT_F32) return launch<float>(reflect, relu, x, w, bias, out, B, C, H, W, st);
    if (dtype == DT_BF16)
        return launch<__nv_bfloat16>(reflect, relu, x, w, bias, out, B, C, H, W, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
