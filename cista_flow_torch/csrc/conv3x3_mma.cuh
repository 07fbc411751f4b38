// A tensor-core stride-1 3x3 convolution tile for Hopper, Cin -> Cout, bf16
// data with f32 accumulation: the inner product of K5 (conv3x3.cu) and of
// K3/K3a (ista.cu) at widths that are multiples of 64. (f32, other widths
// and K6 keep the CUDA-core tile of conv3x3_direct.cuh.)
//
// The conv is an implicit GEMM: M = the pixels of a tile, N = output
// channels, K = 9 taps x Cin. The products are `wgmma.mma_async` m64nNk16
// with both operands read from shared memory and the sums held in
// registers. What the design does about what bounds a 3x3 conv on this card:
//  * One staged input tile serves all 9 taps. A tile is TH = 8 rows by
//    TW = 8*WG*MT pixels and is staged with its 1-pixel halo as
//    [channel group of 8][row][pixel][8 channels], so a pixel's 8 channels
//    are one 16-byte chunk and 8 neighbouring pixels are 128 contiguous
//    bytes: exactly the 8x16-byte "core matrix" of wgmma's unswizzled
//    K-major layout. One m64 operand is an 8x8-pixel sub-tile (8 core
//    matrices, one per row: stride = the staged row; the two halves of a
//    k16 slice: stride = the staged plane), and a tap's shift (ky, kx) only
//    moves the descriptor's start by whole 16-byte chunks, which is legal
//    for any shift. Reads of a core matrix touch every bank once.
//  * A block owns BN = 64 or 128 output channels (all of Cout at the
//    models' widths when the grid is large enough), so the input tile is
//    staged once per block, not once per 16 outputs.
//  * Input channels stream through a ring of shared-memory stages. wgmma is
//    asynchronous: a stage's 9 * KC/16 * MT products are started and
//    committed, then the same threads start filling the slot that the
//    previous stage left, STAGES - 1 stages ahead (cp.async of 16 bytes for
//    the weights and for channel-grouped inputs; for NCHW inputs 8 strided
//    loads and one 16-byte shared store), and only then wait for the
//    products. One __syncthreads per stage.
//  * A block walks over several tiles (as many blocks as the card holds at
//    once), and the ring runs on across them: the next tile's first stages
//    are in flight during this tile's epilogue.
//  * Weights arrive repacked once per weight tensor (ops/conv_tile.py) as
//    [Cin/8][tap][Cout][8]: a stage's weights for a tap are BN contiguous
//    16-byte chunks, again core matrices (8 outputs x 8 channels).
//  * The halo is resolved while staging (a reflected index or a zero), and
//    ragged edges are masked by the epilogue, which the caller owns and
//    which works on the accumulator registers: a thread holds pairs of
//    neighbouring channels of 2*MT pixels (`thread_pixels`).
// Tile shapes: `Large64`/`Large128` (2 warpgroups x 2 sub-tiles: 8x32 pixels)
// and `Small64` (one warpgroup, one 8x8 sub-tile, BN = 64) for grids that
// would otherwise leave most of the card's SMs without a block.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace conv3x3_mma {

constexpr int TH = 8;                // tile rows = rows of an m64 sub-tile
constexpr int THH = TH + 2;          // with the halo

template <int BN_, int WG_, int MT_, int KC_, int STAGES_>
struct Tile {
    static constexpr int BN = BN_;           // output channels per block
    static constexpr int WG = WG_;           // warpgroups per block
    static constexpr int MT = MT_;           // m64 sub-tiles per warpgroup
    static constexpr int KC = KC_;           // input channels per stage
    static constexpr int KG = KC / 8;        // 16-byte channel groups per stage
    static constexpr int STAGES = STAGES_;   // ring of shared-memory stages
    static constexpr int NT = 128 * WG;      // threads
    static constexpr int TW = 8 * WG * MT;   // tile width in pixels
    static constexpr int TWH = TW + 2;
    static constexpr int XS_CHUNKS = KG * THH * TWH;     // 16-byte chunks per stage
    static constexpr int WS_CHUNKS = KG * 9 * BN;
    static constexpr int STAGE_BYTES = (XS_CHUNKS + WS_CHUNKS) * 16;
    static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
};

// 32 channels a stage in a ring of two: measured against 16 channels in a
// ring of three, four or six, the deeper rings bought nothing at the
// models' shapes (the ring already runs on across a block's tiles).
using Large64 = Tile<64, 2, 2, 32, 2>;       // 117,248 bytes of shared memory
using Large128 = Tile<128, 2, 2, 32, 2>;     // 190,976
using Small64 = Tile<64, 1, 1, 32, 2>;       //  86,528

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// makes this thread's shared-memory writes visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Shared-memory matrix descriptor, K-major, no swizzle: rows of a core
// matrix 16 bytes apart; `lbo` = bytes between the two core matrices of a
// k16 slice, `sbo` = bytes between 8-row groups along M or N.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
           | (static_cast<uint64_t>(lbo >> 4) << 16)
           | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// D (64 x N, f32, in registers) += A (64 x 16) * B (16 x N), A and B from
// shared memory through descriptors. Thread t of the warpgroup holds, in
// d[4*j + 2*h + e], row 16*(t/32) + (t%32)/4 + 8*h, column 8*j + 2*(t%4) + e.
__device__ __forceinline__ void wgmma_m64k16(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64k16(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31, "
        " %32, %33, %34, %35, %36, %37, %38, %39, "
        " %40, %41, %42, %43, %44, %45, %46, %47, "
        " %48, %49, %50, %51, %52, %53, %54, %55, "
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
}

inline cudaError_t sm_count(int* sms) {
    int dev = 0;
    const cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// Work item -> (sample, tile origin, first output channel). Items are
// numbered with the channel group fastest, so that items sharing an input
// tile run together; one number keeps any batch inside the grid limits.
template <typename TL>
struct Grid {
    int tiles_x, tiles_y, groups;
    __host__ __device__ Grid(int Cout, int H, int W)
        : tiles_x((W + TL::TW - 1) / TL::TW), tiles_y((H + TH - 1) / TH),
          groups(Cout / TL::BN) {}
    __host__ __device__ long long items(int B) const {
        return static_cast<long long>(B) * tiles_x * tiles_y * groups;
    }
    __device__ void locate(int i, int& b, int& y0, int& x0, int& n0) const {
        n0 = (i % groups) * TL::BN;  i /= groups;
        x0 = (i % tiles_x) * TL::TW;  i /= tiles_x;
        y0 = (i % tiles_y) * TH;
        b = i / tiles_y;
    }
};

// The whole conv for this block: it walks over work items blockIdx.x,
// blockIdx.x + gridDim.x, ... (a grid of at most `items` blocks, usually
// as many as the card holds at once). For each item it sums over Cin and
// the 9 taps into acc[mt][...] (sub-tile wg*MT + mt), which epi.init(acc, n0)
// sets first (to the bias, or to zero), and when the item's sums are
// complete it calls epi.store(acc, b, y0, x0, n0). The stages of all its
// items form one sequence through the ring of shared-memory stages, so the
// first stages of the next item are in flight while this one's epilogue
// runs.
// x: the input, NCHW (B, Cin, H, W), or with SRC_C8 channel-grouped
// (B, Cin/8, H, W, 8). wr: the repacked weights (Cin/8, 9, Cout, 8).
// Cin % KC == 0. `smem`: SMEM_BYTES of dynamic shared memory.
template <typename TL, bool SRC_C8, bool REFLECT, typename Epi>
__device__ __forceinline__ void conv_tiles(unsigned char* smem,
                                           const __nv_bfloat16* __restrict__ x,
                                           const __nv_bfloat16* __restrict__ wr,
                                           int B, int Cin, int Cout, int H, int W, Epi& epi) {
    constexpr int BN = TL::BN, MT = TL::MT, NT = TL::NT, TWH = TL::TWH;
    constexpr int KG = TL::KG, STAGES = TL::STAGES;
    const int tid = threadIdx.x;
    const int wg = tid >> 7;
    const long long hw = static_cast<long long>(H) * W;
    const uint32_t smem_addr = smem_u32(smem);
    const Grid<TL> grid(Cout, H, W);
    const int items = static_cast<int>(grid.items(B));
    const int stages = Cin / TL::KC;                 // per item
    const int total = ((items - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1)
                       / static_cast<int>(gridDim.x)) * stages;

    // Staging walks over the PIX pixels of the halo tile, PT of them a
    // thread; where each lies in its plane (or that it is a zero) is worked
    // out once per item and kept for the item's stages.
    constexpr int PIX = THH * TWH, PT = (PIX + NT - 1) / NT;
    int pixel[PT];                       // gy*W + gx, or -1 for a zero
    int lb = 0, ly0 = 0, lx0 = 0, ln0 = 0;   // the item being staged

    // stage g of this block's sequence -> its ring slot
    auto load_stage = [&](int g) {
        if (g >= total) return;
        const int k = g / stages, s = g - k * stages;
        if (s == 0) {
            grid.locate(blockIdx.x + k * gridDim.x, lb, ly0, lx0, ln0);
#pragma unroll
            for (int i = 0; i < (SRC_C8 ? PT : 0); ++i) {
                const int p = tid + i * NT;
                const int yy = p / TWH, xx = p - yy * TWH;
                int gy = ly0 + yy - 1, gx = lx0 + xx - 1;
                bool inside = true;
                if (REFLECT) {
                    gy = reflect_clamp(gy, H);
                    gx = reflect_clamp(gx, W);
                } else {
                    inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
                }
                pixel[i] = inside ? gy * W + gx : -1;
            }
        }
        const int slot = g % STAGES;
        unsigned char* xs = smem + slot * TL::STAGE_BYTES;
        const uint32_t xs_addr = smem_addr + slot * TL::STAGE_BYTES;
        const uint32_t ws_addr = xs_addr + TL::XS_CHUNKS * 16;
        // weights: chunk (kg, tap, n) <- wr[s*KG + kg][tap][n0 + n]
        const __nv_bfloat16* wsrc = wr + (static_cast<long long>(s) * KG * 9 * Cout + ln0) * 8;
        for (int j = tid; j < TL::WS_CHUNKS; j += NT) {
            const int r = j / BN, n = j - r * BN;
            cp_async16(ws_addr + j * 16, wsrc + (static_cast<long long>(r) * Cout + n) * 8);
        }
        const __nv_bfloat16* xsrc = x + (static_cast<long long>(lb) * Cin + s * TL::KC) * hw;
        if (SRC_C8) {
            // grouped input: chunk (kg, pixel) <- 16 bytes; plane kg of this
            // stage lies 8*hw values on
#pragma unroll
            for (int i = 0; i < PT; ++i) {
                const int p = tid + i * NT;
                if (p < PIX) {
#pragma unroll
                    for (int kg = 0; kg < KG; ++kg) {
                        const int chunk = (kg * PIX + p) * 16;
                        if (pixel[i] >= 0)
                            cp_async16(xs_addr + chunk, xsrc + (kg * hw + pixel[i]) * 8);
                        else
                            *reinterpret_cast<uint4*>(xs + chunk) = make_uint4(0u, 0u, 0u, 0u);
                    }
                }
            }
        } else {
            // NCHW input: chunk (kg, pixel) <- 8 loads a plane apart, each
            // contiguous along x across the warp, and one 16-byte store
            for (int j = tid; j < KG * PIX; j += NT) {
                const int kg = j / PIX, p = j - kg * PIX;
                const int yy = p / TWH, xx = p - yy * TWH;
                int gy = ly0 + yy - 1, gx = lx0 + xx - 1;
                bool inside = true;
                if (REFLECT) {
                    gy = reflect_clamp(gy, H);
                    gx = reflect_clamp(gx, W);
                } else {
                    inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
                }
                __align__(16) __nv_bfloat16 v[8];
                const __nv_bfloat16* src = xsrc + kg * 8 * hw + static_cast<long long>(gy) * W + gx;
#pragma unroll
                for (int e = 0; e < 8; ++e)
                    v[e] = inside ? src[e * hw] : __float2bfloat16(0.f);
                *reinterpret_cast<uint4*>(xs + j * 16) = *reinterpret_cast<const uint4*>(v);
            }
        }
    };

    float acc[MT][BN / 2];
    // one cp.async group per stage, empty past the end, so that the count
    // of groups in flight says which stage has landed
#pragma unroll
    for (int g = 0; g < STAGES - 1; ++g) {
        load_stage(g);
        cp_async_commit();
    }
    for (int g = 0; g < total; ++g) {
        const int k = g / stages, s = g - k * stages;
        // this warpgroup's products of stage g - 1 are done ...
        __syncwarp();
        wgmma_wait_all();
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(acc[mt][i]) :: "memory");
        if (s == 0) {
            int b, y0, x0, n0;
            grid.locate(blockIdx.x + k * gridDim.x, b, y0, x0, n0);
            epi.init(acc, n0);
        }
        // ... stage g has landed and is visible to wgmma, for every thread:
        // after the barrier the slot of stage g - 1 is free for refilling
        cp_async_wait<STAGES - 2>();
        fence_proxy_async();
        __syncthreads();

        const uint32_t xs_addr = smem_addr + (g % STAGES) * TL::STAGE_BYTES;
        const uint32_t ws_addr = xs_addr + TL::XS_CHUNKS * 16;
        const uint64_t da0 = make_desc(xs_addr, THH * TWH * 16, TWH * 16);
        const uint64_t db0 = make_desc(ws_addr, 9 * BN * 16, 128);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < TL::KC / 16; ++ks) {
#pragma unroll
            for (int tap = 0; tap < 9; ++tap) {
                const int ky = tap / 3, kx = tap % 3;
                // descriptor starts move in 16-byte units (the low field)
                const uint64_t db = db0 + static_cast<uint64_t>((2 * ks * 9 + tap) * BN);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    const int sub = wg * MT + mt;
                    const uint64_t da = da0 + static_cast<uint64_t>(
                        (2 * ks * THH + ky) * TWH + 8 * sub + kx);
                    wgmma_m64k16(acc[mt], da, db);
                }
            }
        }
        wgmma_commit();
        // refill the freed slot, STAGES - 1 stages ahead, under the products
        load_stage(g + STAGES - 1);
        cp_async_commit();

        if (s == stages - 1) {
            int b, y0, x0, n0;
            grid.locate(blockIdx.x + k * gridDim.x, b, y0, x0, n0);
            __syncwarp();
            wgmma_wait_all();
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(acc[mt][i]) :: "memory");
            epi.store(acc, b, y0, x0, n0);
        }
    }
    cp_async_wait<0>();
}

// The accumulator registers of one thread: for sub-tile mt and h in {0, 1}
// it holds one pixel, and for it the channel pairs (c, c + 1),
// c = 8*j + pair_channel(), j < BN/8, in acc[mt][4*j + 2*h] and
// acc[mt][4*j + 2*h + 1]. pix[mt][h] = y*W + x of that pixel, or -1 when it
// lies outside the frame (a ragged edge).
template <typename TL>
__device__ __forceinline__ void thread_pixels(int H, int W, int y0, int x0,
                                              int (&pix)[TL::MT][2]) {
    const int t = threadIdx.x & 127, wg = threadIdx.x >> 7;
    const int warp = t >> 5, lane = t & 31;
#pragma unroll
    for (int mt = 0; mt < TL::MT; ++mt) {
        const int px = x0 + 8 * (wg * TL::MT + mt) + (lane >> 2);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int py = y0 + 2 * warp + h;
            pix[mt][h] = (py < H && px < W) ? py * W + px : -1;
        }
    }
}
__device__ __forceinline__ int pair_channel() { return 2 * (threadIdx.x & 3); }

// acc <- the bias of each accumulator's channel (bf16 pairs at bias + n0),
// or zero without one: what an epilogue's init usually is.
template <typename TL>
__device__ __forceinline__ void init_bias(float (&acc)[TL::MT][TL::BN / 2],
                                          const __nv_bfloat16* __restrict__ bias, int n0) {
#pragma unroll
    for (int j = 0; j < TL::BN / 8; ++j) {
        float2 bv = make_float2(0.f, 0.f);
        if (bias != nullptr)
            bv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                bias + n0 + 8 * j + pair_channel()));
#pragma unroll
        for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                acc[mt][4 * j + 2 * h] = bv.x;
                acc[mt][4 * j + 2 * h + 1] = bv.y;
            }
    }
}

// The launch shape: every item its own block, or fewer blocks that walk.
template <typename TL, typename Kernel>
cudaError_t grid_blocks(Kernel kernel, long long items, int* blocks) {
    int sms = 0, per_sm = 0;
    cudaError_t e = sm_count(&sms);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 TL::SMEM_BYTES);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, TL::NT,
                                                          TL::SMEM_BYTES);
    if (e != cudaSuccess) return e;
    if (per_sm < 1 || items < 1 || items > 2147483647LL) return cudaErrorInvalidValue;
    const long long resident = static_cast<long long>(per_sm) * sms;
    *blocks = static_cast<int>(items < resident ? items : resident);
    return cudaSuccess;
}

}  // namespace conv3x3_mma
