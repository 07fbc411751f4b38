// K6: the whole tied ISTA loop in ONE launch.
//
// Replaces the TPU kernel cista_flow_tpu/ops/pallas_ista.py
// (_ista_kernel / fused_ista_pallas): `depth` iterations of
//   z <- softshrink(P(x1 - D(z)) + z, lambda)
// with D (2C -> C) and P (C -> 2C) 3x3 reflect convs. What the TPU kernel
// buys is that x1, z and the weights of one sample stay in its fast memory
// for the whole loop. A Hopper block has 227 KB of shared memory and one
// sample's z alone is 128 x 90 x 120 values, and every conv needs its
// neighbours' halo, so a block cannot own a sample. Instead the iterations
// are separated by a grid-wide barrier inside one cooperative launch:
//   phase D: every block walks over (sample, tile, channel group) items
//            and writes xd = x1 - (D(z) + db);             grid.sync()
//   phase P: the same walk over 2C channels, z <- softshrink(P(xd) + pb + z)
//            written in place (each element is read only by the thread that
//            overwrites it; z's halo is read only in the next phase D, after
//            the barrier);                                  grid.sync()
// The grid is as many blocks as can be resident at once (occupancy x SMs),
// which the barrier needs. z and xd live in scratch the wrapper allocates
// (33 MB in bf16 at batch 8, inside the 50 MB L2), so between phases the
// data need not reach device memory although it leaves the SM.
//
// Bound on the H100: operations, as K3. Two inner products, by shape:
//  * bf16 at C % 64 == 0: the wgmma tile of conv3x3_mma.cuh, the one K3a
//    runs on, with K3a's epilogues (ista_mma.cuh). Both phases are
//    `conv_tiles` with the Large64 tile (64 outputs of 8x32 pixels an item;
//    phase P's 2C outputs are 2C/64 items a tile). K3a gives phase P the
//    Large128 tile, which alone takes nearly all of a thread's 255
//    registers; inlined beside phase D in one kernel it spilled and ran
//    slower than this (so did out-of-line phases, an epilogue in passes and
//    4-warpgroup tiles), so K6 pays phase P's second staging of each input
//    tile instead. The activations are channel-grouped (B, C/8, H, W, 8)
//    scratch; the moves from and to NCHW at the two ends are phases of the
//    same launch, 8 chunks a thread in flight, so where K3a takes
//    2*depth + 3 launches K6 takes one. Each phase drains its products and
//    copies before the barrier (`conv_tiles` waits for its last wgmma and
//    cp.async group, and its ring prefetches only its own phase's stages);
//    the arrays rewritten inside the launch are read through L2 only
//    (cp.async.cg, __ldcg). The tile's dynamic shared memory is set before
//    the occupancy query and the launch.
//  * f32, and bf16 at other widths: the direct CUDA-core f32 tile
//    (conv3x3_direct.cuh) on NCHW, 16 output channels an item (f32 parity
//    needs full f32 products). xd and z are written and read in the same
//    launch, so they are never read through __restrict__ or the read-only
//    cache.
#include <cooperative_groups.h>

#include "ista_mma.cuh"

namespace {

namespace cg = cooperative_groups;
namespace mma = conv3x3_mma;
using namespace conv3x3;

template <typename T>
__global__ void __launch_bounds__(NT)
ista_loop_kernel(const T* __restrict__ x1, const T* z0, const T* __restrict__ dw,
                 const T* __restrict__ db, const T* __restrict__ pw,
                 const T* __restrict__ pb, const T* __restrict__ lam,
                 T* xd, T* zn, int B, int C, int H, int W, int depth) {
    __shared__ Stage sm;
    cg::grid_group grid = cg::this_grid();
    const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
    const int tiles = tiles_x * tiles_y;
    const long long hw = static_cast<long long>(H) * W;
    float acc[PX][CO];

    const T* zin = z0;
    for (int it = 0; it < depth; ++it) {
        // phase D: xd = x1 - (conv(zin, dw) + db), C output channels
        const int gd = C / CO;
        for (int item = blockIdx.x; item < B * tiles * gd; item += gridDim.x) {
            int i = item;
            const int co0 = (i % gd) * CO;  i /= gd;
            const int x0 = (i % tiles_x) * TW;  i /= tiles_x;
            const int y0 = (i % tiles_y) * TH;
            const int b = i / tiles_y;
            accumulate<T, true>(sm, zin + static_cast<long long>(b) * 2 * C * hw, dw,
                                2 * C, H, W, x0, y0, co0, acc);
            store_tile(acc, H, W, x0, y0, [&](int c, long long pix, float v) {
                const long long o = (static_cast<long long>(b) * C + co0 + c) * hw + pix;
                xd[o] = from_f<T>(to_f(x1[o]) - (v + to_f(db[co0 + c])));
            });
        }
        grid.sync();
        // phase P: zn = softshrink(conv(xd, pw) + pb + zin, lam), 2C channels
        const int gp = 2 * C / CO;
        for (int item = blockIdx.x; item < B * tiles * gp; item += gridDim.x) {
            int i = item;
            const int co0 = (i % gp) * CO;  i /= gp;
            const int x0 = (i % tiles_x) * TW;  i /= tiles_x;
            const int y0 = (i % tiles_y) * TH;
            const int b = i / tiles_y;
            accumulate<T, true>(sm, xd + static_cast<long long>(b) * C * hw, pw,
                                C, H, W, x0, y0, co0, acc);
            store_tile(acc, H, W, x0, y0, [&](int c, long long pix, float v) {
                const long long o = (static_cast<long long>(b) * 2 * C + co0 + c) * hw + pix;
                v = v + to_f(pb[co0 + c]) + to_f(zin[o]);
                zn[o] = from_f<T>(softshrink(v, to_f(lam[co0 + c])));
            });
        }
        zin = zn;
        if (it + 1 < depth) grid.sync();
    }
}

template <typename T>
int launch(const void* x1, const void* z, const void* dw, const void* db,
           const void* pw, const void* pb, const void* lam, void* xd, void* zn,
           int B, int C, int H, int W, int depth, cudaStream_t st) {
    int dev = 0, sms = 0, coop = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ista_loop_kernel<T>, NT, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (!coop || per_sm < 1) return static_cast<int>(cudaErrorNotSupported);
    // no more blocks than phase P has items, and no more than can be resident
    const long long items = static_cast<long long>(B) * ((W + TW - 1) / TW)
                            * ((H + TH - 1) / TH) * (2 * C / CO);
    if (items > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    long long blocks = static_cast<long long>(per_sm) * sms;
    if (blocks > items) blocks = items;
    void* args[] = {&x1, &z, &dw, &db, &pw, &pb, &lam, &xd, &zn, &B, &C, &H, &W, &depth};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(ista_loop_kernel<T>),
                                    dim3(static_cast<unsigned>(blocks)), dim3(NT), args, 0, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

// NCHW <-> grouped over chunks first, first + stride, ... < total, U
// chunks a thread at a time, their loads all in flight before the stores
// (the grid is one block an SM, so each thread must keep many in flight)
template <bool TO_GROUPED, int U>
__device__ __forceinline__ void regroup_range(const __nv_bfloat16* in, __nv_bfloat16* out,
                                              long long first, long long stride,
                                              long long total, int hw) {
    for (long long i = first; i < total; i += U * stride) {
        uint4 c[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
            if (i + u * stride < total) c[u] = ista_mma::regroup_load<TO_GROUPED>(in, i + u * stride, hw);
#pragma unroll
        for (int u = 0; u < U; ++u)
            if (i + u * stride < total) ista_mma::regroup_store<TO_GROUPED>(c[u], out, i + u * stride, hw);
    }
}

// The tensor-core route, both phases on the Large64 tile. x1 (B, C, H, W)
// and z (B, 2C, H, W) NCHW in; x1g, xd (B, C/8, H, W, 8) and zg
// (B, 2C/8, H, W, 8) scratch; zn NCHW out.
using TL = mma::Large64;

__global__ void __launch_bounds__(TL::NT, 1)
ista_loop_mma_kernel(const __nv_bfloat16* __restrict__ x1, const __nv_bfloat16* __restrict__ z,
                     const __nv_bfloat16* __restrict__ dwp, const __nv_bfloat16* __restrict__ db,
                     const __nv_bfloat16* __restrict__ pwp, const __nv_bfloat16* __restrict__ pb,
                     const __nv_bfloat16* __restrict__ lam, __nv_bfloat16* x1g,
                     __nv_bfloat16* xd, __nv_bfloat16* zg, __nv_bfloat16* zn,
                     int B, int C, int H, int W, int depth) {
    extern __shared__ __align__(128) unsigned char smem[];
    cg::grid_group grid = cg::this_grid();
    const int hw = H * W;
    const long long stride = static_cast<long long>(gridDim.x) * TL::NT;
    const long long first = static_cast<long long>(blockIdx.x) * TL::NT + threadIdx.x;
    const long long cx = static_cast<long long>(B) * (C / 8) * hw;     // chunks of x1

    // phase 0: x1 and z to the grouped layout
    regroup_range<true, 8>(x1, x1g, first, stride, cx, hw);
    regroup_range<true, 8>(z, zg, first, stride, 2 * cx, hw);
    grid.sync();
    ista_mma::IstaEpilogue<TL, ista_mma::MODE_D> epi_d{db, x1g, lam, xd, C, H, W};
    ista_mma::IstaEpilogue<TL, ista_mma::MODE_P> epi_p{pb, zg, lam, zg, 2 * C, H, W};
    for (int it = 0; it < depth; ++it) {
        mma::conv_tiles<TL, true, true>(smem, zg, dwp, B, 2 * C, C, H, W, epi_d);
        grid.sync();
        mma::conv_tiles<TL, true, true>(smem, xd, pwp, B, C, 2 * C, H, W, epi_p);
        grid.sync();
    }
    // last phase: z back to NCHW
    regroup_range<false, 8>(zg, zn, first, stride, 2 * cx, hw);
}

int launch_mma(const void* x1, const void* z, const void* dwp, const void* db,
               const void* pwp, const void* pb, const void* lam, void* x1g, void* xd,
               void* zg, void* zn, int B, int C, int H, int W, int depth, cudaStream_t st) {
    int dev = 0, sms = 0, coop = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(ista_loop_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 TL::SMEM_BYTES);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ista_loop_mma_kernel, TL::NT,
                                                          TL::SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (!coop || per_sm < 1) return static_cast<int>(cudaErrorNotSupported);
    // no more blocks than phase P has items, and no more than can be resident
    const long long items = mma::Grid<TL>(2 * C, H, W).items(B);
    if (items > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    long long blocks = static_cast<long long>(per_sm) * sms;
    if (blocks > items) blocks = items;
    void* args[] = {&x1, &z, &dwp, &db, &pwp, &pb, &lam, &x1g, &xd, &zg, &zn,
                    &B, &C, &H, &W, &depth};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(ista_loop_mma_kernel),
                                    dim3(static_cast<unsigned>(blocks)), dim3(TL::NT), args,
                                    TL::SMEM_BYTES, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x1, xd: (B, C, H, W); z, zn: (B, 2C, H, W); dw: (C, 2C, 3, 3); db: (C,);
// pw: (2C, C, 3, 3); pb, lam: (2C,). All in dtype. xd and zn are scratch and
// output the caller allocates; zn holds the result, z is not modified.
// C % 16 == 0; H, W >= 2; depth >= 1.
CISTA_EXPORT int cista_ista_loop(int dtype, const void* x1, const void* z,
                                 const void* dw, const void* db, const void* pw,
                                 const void* pb, const void* lam, void* xd, void* zn,
                                 int B, int C, int H, int W, int depth, void* stream) {
    if (B <= 0 || H < 2 || W < 2 || C <= 0 || C % CO != 0 || depth < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == DT_F32)
        return launch<float>(x1, z, dw, db, pw, pb, lam, xd, zn, B, C, H, W, depth, st);
    if (dtype == DT_BF16)
        return launch<__nv_bfloat16>(x1, z, dw, db, pw, pb, lam, xd, zn, B, C, H, W, depth, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core route, bf16, C % 64 == 0: x1 (B, C, H, W) and z
// (B, 2C, H, W) NCHW; dwp, pwp the repacked D and P weights (Cin/8, 9,
// Cout, 8) (ops/conv_tile.py); db (C,), pb, lam (2C,); x1g, xd
// (B, C/8, H, W, 8) and zg (B, 2C/8, H, W, 8) scratch; zn (B, 2C, H, W) the
// result. z is not modified.
CISTA_EXPORT int cista_ista_loop_mma(const void* x1, const void* z, const void* dwp,
                                     const void* db, const void* pwp, const void* pb,
                                     const void* lam, void* x1g, void* xd, void* zg, void* zn,
                                     int B, int C, int H, int W, int depth, void* stream) {
    if (B <= 0 || H < 2 || W < 2 || C <= 0 || C % 64 != 0 || depth < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    return launch_mma(x1, z, dwp, db, pwp, pb, lam, x1g, xd, zg, zn, B, C, H, W, depth,
                      static_cast<cudaStream_t>(stream));
}
