// K1: the RAFT correlation-pyramid window lookup, with the motion
// encoder's convc1 (1x1 conv 324->256 + bias + relu) fused in.
//
// Replaces the TPU kernel cista_flow_tpu/ops/pallas_corr.py
// (_lookup_all_levels / lookup_corr_pallas, proj=). For each 1/8-res sample
// and each of the 4 pyramid levels it takes the 9x9 bilinear window of
// radius 4 at coords/2^l, zeros outside the level (grid_sample zeros
// padding). Channels are level-major, then x-offset-major (the reference's
// meshgrid quirk): k = l*81 + bx*9 + ay samples (x + bx - 4, y + ay - 4).
// The TPU kernel's radix band selection and transposed padded slabs exist
// because the TPU has no cheap gathers; here the level is read in place.
//
// The gather, by patch. The 81 taps of one (sample, level) read one 11x11
// patch of the level: rows floor(y) - 4 .. floor(y) + 6 and the same
// columns. (Ten would do if one fraction served all nine offsets; the plain
// version takes frac(c/2^l + d) for each offset d, and where c/2^l + d
// rounds up to an integer its floor moves one on. This kernel computes each
// offset's floor and fraction as the plain version does and picks the
// patch row or column from it, so it reads the same corners.) A thread owns
// one x offset of one (sample, level): the 11 rows of its two patch
// columns, 22 loads that a warp's neighbouring threads make along one row,
// and 9 taps out. Every load is range-tested, so coordinates far out of
// range and an empty level (h or w of 0, the last level of a frame under
// 64 px) read no memory and give zeros.
//
// Bound on the H100: bytes in bf16 (~1 KB of pyramid reads and 512 bytes
// out a sample against 2*324*256 flops at the tensor-core rate), operations
// in f32 with the projection (the CUDA-core rate), bytes without it. What
// holds the wgmma route back is that a tile's gather, products and
// epilogue run in turn: the weight leaves room for one A tile an SM.
//  * bf16 with the projection (the serving route): wgmma. A block keeps the
//    whole weight resident in shared memory (336 x 256, K padded with zero
//    rows from 324 to 21 k16 steps, 172,032 bytes, packed once per weight
//    tensor by ops/corr_tile.py in wgmma's unswizzled K-major core-matrix
//    layout) and walks over tiles of 64 samples, as many blocks as the card
//    holds at once. For each tile its 512 threads gather the window into a
//    64 x 336 A tile in the same layout (rounded to bf16 once, as the JAX
//    kernel's slab dtype does), then 4 warpgroups each take 64 of the 256
//    outputs with 21 m64n64k16 products into f32 registers. The epilogue
//    adds the bias in f32, takes the relu, rounds once, stages the tile as
//    [channel][sample] over the A tile and writes NCHW coalesced along the
//    samples. The (n, 324) window never reaches device memory.
//  * f32 with the projection (parity needs full f32: no TF32): CUDA cores.
//    A block gathers 32 samples' windows into shared memory; thread t then
//    sums output channel t over them, reading its 8 weights of a k group
//    as two 16-byte loads of the packed f32 weight (no staging, no
//    barrier in the loop), and the outputs leave through shared memory,
//    coalesced along the samples.
//  * Without the projection (both dtypes): the same gather, then the 324
//    channels written coalesced along the samples.
#include "conv3x3_mma.cuh"

namespace {

namespace mma = conv3x3_mma;

constexpr int R = 4;
constexpr int WIN = 2 * R + 1;       // 9
constexpr int ROWS = WIN + 2;        // patch rows a tap column reads
constexpr int TAPS = WIN * WIN;      // 81
constexpr int NLV = 4;
constexpr int K = NLV * TAPS;        // 324
constexpr int NOUT = 256;            // projected channels
constexpr int KGS = 42;              // 16-byte K groups of the packed weight (K padded to 336)

struct Levels {
    const void* p[NLV];
    int h[NLV];
    int w[NLV];
};

// One x offset bx of one (sample, level): the two patch columns of its
// floor over the patch's 11 rows, and what picks the taps from them.
struct Column {
    float a[ROWS], b[ROWS];     // columns x0 and x0 + 1, rows y0 .. y0 + 10
    float cys, ybf, fx;
};

template <typename T>
__device__ __forceinline__ void load_column(const Levels& lv, int l, long long nn, float cx,
                                            float cy, int bx, Column& c) {
    const int hl = lv.h[l], wl = lv.w[l];
    const T* plane = static_cast<const T*>(lv.p[l]) + nn * hl * wl;
    const float scale = 1.0f / static_cast<float>(1 << l);      // exact
    const float px = cx * scale + static_cast<float>(bx - R);
    const float x0f = floorf(px);
    c.fx = px - x0f;
    c.cys = cy * scale;
    c.ybf = floorf(c.cys);
    // clamped only where both columns (or all rows) are outside anyway
    const int x0 = static_cast<int>(fminf(fmaxf(x0f, -2.f), static_cast<float>(wl)));
    const int y0 = static_cast<int>(fminf(fmaxf(c.ybf - R, -ROWS - 1.f), static_cast<float>(hl)));
    const bool c0 = x0 >= 0 && x0 < wl, c1 = x0 + 1 >= 0 && x0 + 1 < wl;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
        const int r = y0 + i;
        const bool ok = r >= 0 && r < hl;
        const T* row = plane + static_cast<long long>(r) * wl + x0;
        c.a[i] = (ok && c0) ? to_f(row[0]) : 0.f;
        c.b[i] = (ok && c1) ? to_f(row[1]) : 0.f;
    }
}

__device__ __forceinline__ void zero_column(Column& c) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) c.a[i] = c.b[i] = 0.f;
    c.cys = c.ybf = c.fx = 0.f;
}

// The 9 taps (ay = 0..8) of the column, as the plain version (ops/corr.py
// lookup_corr) computes them: each y offset's own floor and fraction.
__device__ __forceinline__ void blend_column(const Column& c, float (&v)[WIN]) {
    const float gx = 1.f - c.fx;
#pragma unroll
    for (int ay = 0; ay < WIN; ++ay) {
        const float py = c.cys + static_cast<float>(ay - R);
        const float yf = floorf(py), fy = py - yf;
        // this offset's floor lies one row on where cys + d rounded up
        const bool up = yf - c.ybf > static_cast<float>(ay - R) + 0.5f;
        const float v00 = up ? c.a[ay + 1] : c.a[ay], v10 = up ? c.a[ay + 2] : c.a[ay + 1];
        const float v01 = up ? c.b[ay + 1] : c.b[ay], v11 = up ? c.b[ay + 2] : c.b[ay + 1];
        const float gy = 1.f - fy;
        v[ay] = (gy * v00 + fy * v10) * gx + (gy * v01 + fy * v11) * c.fx;
    }
}

// The windows of samples s0 .. s0 + S - 1 (xy: their coords), item i =
// (sample m, level l, x offset bx) with bx fastest, so that a warp's
// neighbouring threads read along one patch row. store(m, l, bx, v) takes
// each item's 9 taps; samples past n give zeros. (Two items a thread with
// all 44 loads in flight, or the wgmma route's outputs stored straight
// from registers, measured no faster.)
template <typename T, int S, int NTH, typename Store>
__device__ __forceinline__ void gather(const Levels& lv, const float* xy, int s0, int n,
                                       Store store) {
    for (int i = threadIdx.x; i < S * NLV * WIN; i += NTH) {
        const int bx = i % WIN, q = i / WIN, l = q % NLV, m = q / NLV;
        Column c;
        if (s0 + m < n)
            load_column<T>(lv, l, s0 + m, xy[2 * m], xy[2 * m + 1], bx, c);
        else
            zero_column(c);
        float v[WIN];
        blend_column(c, v);
        store(m, l, bx, v);
    }
}

// coords (B, 2, H1, W1) of samples s0 .. s0 + S - 1 -> xy[2*m + d]; 0 past n
template <int S>
__device__ __forceinline__ void load_coords(const float* __restrict__ coords, int s0, int n,
                                            int hw1, float* xy) {
    if (threadIdx.x < 2 * S) {
        const int nn = s0 + (threadIdx.x >> 1), d = threadIdx.x & 1;
        float v = 0.f;
        if (nn < n) {
            const int b = nn / hw1, p = nn - b * hw1;
            v = coords[(static_cast<long long>(b) * 2 + d) * hw1 + p];
        }
        xy[threadIdx.x] = v;
    }
}

// ---- bf16 with the projection: wgmma ---------------------------------------
constexpr int MS = 64;                       // samples per tile (wgmma's m64)
constexpr int NWG = 4;                       // warpgroups, 64 outputs each
constexpr int NT_MMA = 128 * NWG;
constexpr int OST = MS + 8;                  // staged output row (bf16)
constexpr int W_BYTES = KGS * NOUT * 16;     // 172,032
constexpr int A_BYTES = KGS * MS * 16;       //  43,008
constexpr int MMA_SMEM = W_BYTES + A_BYTES + 2 * MS * 4 + NOUT * 4;
static_assert(NOUT * OST * 2 <= (K / 8) * MS * 16,
              "the staged output must leave the A tile's K pads alone");

__global__ void __launch_bounds__(NT_MMA, 1)
corr_mma_kernel(Levels lv, const float* __restrict__ coords,
                const __nv_bfloat16* __restrict__ wp, const float* __restrict__ bias,
                __nv_bfloat16* __restrict__ out, int n, int hw1) {
    extern __shared__ __align__(128) unsigned char smem[];
    unsigned char* a_tile = smem + W_BYTES;               // chunk (kg, m) at kg*MS + m
    float* xy = reinterpret_cast<float*>(a_tile + A_BYTES);
    float* bsm = xy + 2 * MS;
    const int tid = threadIdx.x, wg = tid >> 7;
    const int warp = (tid & 127) >> 5, lane = tid & 31;
    const uint32_t w_addr = mma::smem_u32(smem), a_addr = w_addr + W_BYTES;

    // the weight once per block: chunk (kg, o) at kg*NOUT + o, as packed
    for (int j = tid; j < KGS * NOUT; j += NT_MMA)
        mma::cp_async16(w_addr + j * 16, wp + static_cast<long long>(j) * 8);
    mma::cp_async_commit();
    for (int j = tid; j < NOUT; j += NT_MMA) bsm[j] = bias[j];
    // the K pads (k >= 324: the tail of group 40, all of group 41) stay zero
    for (int j = tid; j < 2 * MS; j += NT_MMA)
        *reinterpret_cast<uint4*>(a_tile + ((K / 8) * MS + j) * 16) = make_uint4(0u, 0u, 0u, 0u);

    const int tiles = (n + MS - 1) / MS;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int s0 = t * MS;
        load_coords<MS>(coords, s0, n, hw1, xy);
        __syncthreads();
        gather<__nv_bfloat16, MS, NT_MMA>(
            lv, xy, s0, n, [&](int m, int l, int bx, const float (&v)[WIN]) {
                const int k0 = l * TAPS + bx * WIN;
#pragma unroll
                for (int ay = 0; ay < WIN; ++ay) {
                    const int k = k0 + ay;
                    *reinterpret_cast<__nv_bfloat16*>(
                        a_tile + ((k >> 3) * MS + m) * 16 + (k & 7) * 2) = __float2bfloat16(v[ay]);
                }
            });
        mma::cp_async_wait<0>();             // the weight has landed (first tile)
        mma::fence_proxy_async();
        __syncthreads();

        float acc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.f;
        mma::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KGS / 2; ++ks) {
            const uint64_t da = mma::make_desc(a_addr + ks * 2 * MS * 16, MS * 16, 128);
            const uint64_t db = mma::make_desc(w_addr + (ks * 2 * NOUT + wg * 64) * 16,
                                               NOUT * 16, 128);
            mma::wgmma_m64k16(acc, da, db);
        }
        mma::wgmma_commit();
        __syncwarp();
        mma::wgmma_wait_all();
#pragma unroll
        for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(acc[i]) :: "memory");
        __syncthreads();                     // every warpgroup is done with the A tile

        // bias in f32, relu, one rounding; staged [channel][sample]
        __nv_bfloat16* ost = reinterpret_cast<__nv_bfloat16*>(a_tile);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int m = 16 * warp + (lane >> 2) + 8 * h;
                    const int c = wg * 64 + 8 * j + 2 * (lane & 3) + e;
                    ost[c * OST + m] = __float2bfloat16(fmaxf(acc[4 * j + 2 * h + e] + bsm[c], 0.f));
                }
        __syncthreads();
        {
            const int m = tid % MS, nn = s0 + m;
            if (nn < n) {
                const int b = nn / hw1, p = nn - b * hw1;
                __nv_bfloat16* o = out + static_cast<long long>(b) * NOUT * hw1 + p;
                for (int c = tid / MS; c < NOUT; c += NT_MMA / MS)
                    o[static_cast<long long>(c) * hw1] = ost[c * OST + m];
            }
        }
        __syncthreads();                     // the A tile is free for the next gather
    }
    mma::cp_async_wait<0>();
}

// ---- f32 with the projection, and the gather alone: CUDA cores -------------
constexpr int SC = 32;                       // samples per block
constexpr int SCP = SC + 4;                  // window row in shared memory (16-byte rows)
constexpr int KW = 328;                      // window rows: K and the pads of weight group 40
constexpr int NT = 256;                      // threads; == projected channels

template <typename T, bool PROJ>
__global__ void __launch_bounds__(NT)
corr_core_kernel(Levels lv, const float* __restrict__ coords, const float* __restrict__ wp,
                 const float* __restrict__ bias, T* __restrict__ out, int n, int hw1) {
    __shared__ __align__(16) float win[KW][SCP];
    __shared__ float xy[2 * SC];
    const int tid = threadIdx.x;
    const int s0 = blockIdx.x * SC;
    load_coords<SC>(coords, s0, n, hw1, xy);
    if (PROJ)
        for (int i = tid; i < (KW - K) * SC; i += NT) win[K + i / SC][i % SC] = 0.f;
    __syncthreads();
    gather<T, SC, NT>(lv, xy, s0, n, [&](int m, int l, int bx, const float (&v)[WIN]) {
#pragma unroll
        for (int ay = 0; ay < WIN; ++ay) win[l * TAPS + bx * WIN + ay][m] = v[ay];
    });
    __syncthreads();
    const int m = tid % SC, nn = s0 + m;
    const int b = nn / hw1, p = nn - b * hw1;
    if (!PROJ) {
        if (nn < n) {
            T* o = out + static_cast<long long>(b) * K * hw1 + p;
            for (int k = tid / SC; k < K; k += NT / SC)
                o[static_cast<long long>(k) * hw1] = from_f<T>(win[k][m]);
        }
        return;
    }

    const int co = tid;
    float acc[SC];
#pragma unroll
    for (int s = 0; s < SC; ++s) acc[s] = 0.f;
    for (int g = 0; g < KW / 8; ++g) {
        const float4* wq = reinterpret_cast<const float4*>(wp + (static_cast<long long>(g) * NOUT + co) * 8);
        const float4 w0 = wq[0], w1 = wq[1];
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
            const float4* ap = reinterpret_cast<const float4*>(&win[8 * g + kk][0]);
#pragma unroll
            for (int q = 0; q < SC / 4; ++q) {
                const float4 a = ap[q];
                acc[4 * q + 0] += a.x * wv[kk];
                acc[4 * q + 1] += a.y * wv[kk];
                acc[4 * q + 2] += a.z * wv[kk];
                acc[4 * q + 3] += a.w * wv[kk];
            }
        }
    }
    __syncthreads();                         // the window is read: stage over it
    float* stage = &win[0][0];               // [channel][SC + 1]
    const float bb = bias[co];
#pragma unroll
    for (int s = 0; s < SC; ++s) stage[co * (SC + 1) + s] = fmaxf(acc[s] + bb, 0.f);
    __syncthreads();
    if (nn < n) {
        T* o = out + static_cast<long long>(b) * NOUT * hw1 + p;
        for (int c = tid / SC; c < NOUT; c += NT / SC)
            o[static_cast<long long>(c) * hw1] = from_f<T>(stage[c * (SC + 1) + m]);
    }
}

template <typename T, bool PROJ>
int launch_core(const Levels& lv, const float* coords, const void* wp, const void* bias,
                void* out, int n, int hw1, cudaStream_t st) {
    corr_core_kernel<T, PROJ><<<(n + SC - 1) / SC, NT, 0, st>>>(
        lv, coords, static_cast<const float*>(wp), static_cast<const float*>(bias),
        static_cast<T*>(out), n, hw1);
    return static_cast<int>(cudaGetLastError());
}

int launch_mma(const Levels& lv, const float* coords, const void* wp, const void* bias,
               void* out, int n, int hw1, cudaStream_t st) {
    auto kernel = corr_mma_kernel;
    int sms = 0, per_sm = 0;
    cudaError_t e = mma::sm_count(&sms);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_SMEM);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT_MMA, MMA_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const int tiles = (n + MS - 1) / MS;
    const int blocks = tiles < per_sm * sms ? tiles : per_sm * sms;
    kernel<<<blocks, NT_MMA, MMA_SMEM, st>>>(
        lv, coords, static_cast<const __nv_bfloat16*>(wp), static_cast<const float*>(bias),
        static_cast<__nv_bfloat16*>(out), n, hw1);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Levels l0..l3: (n, h_l, w_l) in dtype, n = B*H1*W1 samples.
// coords: (B, 2, H1, W1) f32 level-0 pixel coords; hw1 = H1*W1.
// proj != 0: wp the convc1 weight packed (42, 256, 8) in dtype with zero pad
// rows (ops/corr_tile.py), bias (256,) f32, out (B, 256, H1, W1);
// proj == 0: out (B, 324, H1, W1).
CISTA_EXPORT int cista_corr_lookup(int dtype, int proj,
                                   const void* l0, const void* l1,
                                   const void* l2, const void* l3,
                                   int h0, int h1, int h2, int h3,
                                   int w0, int w1, int w2, int w3,
                                   const void* coords, const void* wp,
                                   const void* bias, void* out,
                                   int n, int hw1, void* stream) {
    if (n <= 0 || hw1 <= 0) return static_cast<int>(cudaErrorInvalidValue);
    Levels lv;
    lv.p[0] = l0; lv.p[1] = l1; lv.p[2] = l2; lv.p[3] = l3;
    lv.h[0] = h0; lv.h[1] = h1; lv.h[2] = h2; lv.h[3] = h3;
    lv.w[0] = w0; lv.w[1] = w1; lv.w[2] = w2; lv.w[3] = w3;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* c = static_cast<const float*>(coords);
    if (dtype == DT_F32)
        return proj ? launch_core<float, true>(lv, c, wp, bias, out, n, hw1, st)
                    : launch_core<float, false>(lv, c, wp, bias, out, n, hw1, st);
    if (dtype == DT_BF16)
        return proj ? launch_mma(lv, c, wp, bias, out, n, hw1, st)
                    : launch_core<__nv_bfloat16, false>(lv, c, wp, bias, out, n, hw1, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
