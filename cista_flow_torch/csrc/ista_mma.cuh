// What the ISTA kernels K3/K3a (ista.cu) and K6 (ista_loop.cu) share on the
// tensor-core route: the conv tile's three epilogues and the move between
// NCHW and the channel-grouped layout (B, C/8, H, W, 8).
//
// K6 runs a whole loop in one launch, so z, x1 - D(z) and the grouped x1
// are written by other blocks of the same launch before they are read.
// Every read of them here is `ld.global.cg` (`__ldcg`: L2, never a stale
// L1 line or the read-only path); the conv tile stages its input with
// `cp.async.cg`, which reads L2 as well.
#pragma once

#include "conv3x3_direct.cuh"
#include "conv3x3_mma.cuh"

namespace ista_mma {

using conv3x3::softshrink;

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
               + conv3x3_mma::pair_channel();
    }

    __device__ __forceinline__ void init(float (&acc)[TL::MT][TL::BN / 2], int n0) const {
        conv3x3_mma::init_bias<TL>(acc, bias, n0);
    }

    __device__ __forceinline__ void store(const float (&acc)[TL::MT][TL::BN / 2],
                                          int b, int y0, int x0, int n0) const {
        const long long hw = static_cast<long long>(H) * W;
        int pix[TL::MT][2];
        conv3x3_mma::thread_pixels<TL>(H, W, y0, x0, pix);
        const int c0 = n0 + conv3x3_mma::pair_channel();
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
                        av[mt][h][j] = __ldcg(reinterpret_cast<const unsigned int*>(
                            a0 + j * 8 * hw + 8 * pix[mt][h]));
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

// NCHW (B, C, H*W) <-> channel-grouped (B, C/8, H*W, 8), chunk i: the 8
// channels of one pixel of one group, 8 accesses a plane apart (each
// contiguous across a warp) on the NCHW side and 16 bytes on the other.
// Loading a chunk and storing it are apart, so that a caller can put the
// loads of several chunks in flight before the first store.
template <bool TO_GROUPED>
__device__ __forceinline__ uint4 regroup_load(const __nv_bfloat16* in, long long i, int HW) {
    if (TO_GROUPED) {
        const long long g = i / HW;                   // sample * C/8 + group
        const __nv_bfloat16* p = in + g * 8 * HW + (i - g * HW);
        __align__(16) __nv_bfloat16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = p[static_cast<long long>(e) * HW];
        return *reinterpret_cast<const uint4*>(v);
    }
    return __ldcg(reinterpret_cast<const uint4*>(in + i * 8));
}

template <bool TO_GROUPED>
__device__ __forceinline__ void regroup_store(uint4 c, __nv_bfloat16* out, long long i, int HW) {
    if (TO_GROUPED) {
        *reinterpret_cast<uint4*>(out + i * 8) = c;
    } else {
        const long long g = i / HW;
        __nv_bfloat16* p = out + g * 8 * HW + (i - g * HW);
        __align__(16) __nv_bfloat16 v[8];
        *reinterpret_cast<uint4*>(v) = c;
#pragma unroll
        for (int e = 0; e < 8; ++e) p[static_cast<long long>(e) * HW] = v[e];
    }
}

template <bool TO_GROUPED>
__device__ __forceinline__ void regroup_chunk(const __nv_bfloat16* in, __nv_bfloat16* out,
                                              long long i, int HW) {
    regroup_store<TO_GROUPED>(regroup_load<TO_GROUPED>(in, i, HW), out, i, HW);
}

}  // namespace ista_mma
