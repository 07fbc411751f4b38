// K2: the reflection warp, fused: grid, reflect fold, 4-corner gather, f32
// blend and the zero-flow select in one kernel.
//
// Replaces the TPU kernel cista_flow_tpu/ops/pallas_aug.py
// (_build_aug_pallas / build_aug). On the TPU that kernel only stages the
// four corner rows [x[n] | x[n+1] | x[n+W] | x[n+W+1]] of a flat (N, C)
// image so that XLA can fetch all four bilinear corners with ONE row
// gather; gathers are the TPU's slow operation, and the staging exists to
// stream those rows at bandwidth. Hopper gathers from L1/L2 cheaply, so the
// counterpart here computes the function the staging serves: the
// reflection-mode sample_pixel_coords of cista_flow_tpu/ops/warp.py
// (:114-122 fold and clamp, :134-184 corners and blend), with the
// reference's non-standard 2*(x/W - 0.5) grid normalization
// (warp.py:211-222). The four-times-wider staging array is never built.
// The reference's zero-flow short-circuit (cista_flow_tpu/models/
// composite.py:75-78) is folded in: where the optional device-side gate is
// false, the kernel writes the input unchanged.
//
// Bound on the H100: bytes (one read of the image and the flow, one write
// of the output; a few dozen flops per pixel). What the design does:
// - Parallelism at C = 128 (the sparse code): a thread owns one pixel and a
//   compile-time chunk of CH = 8 channels, unrolled, so that its 32 corner
//   loads are all issued before the first blend; the grid is (x tiles, row
//   tiles x channel chunks, samples). Each block recomputes its pixels'
//   corners and weights (a few dozen flops and one flow read from L2).
//   Chunks of 16 and 32 channels (80 and 155+ registers) and blocks of 8
//   rows were slower; so was loading a corner pair as one 4-byte word.
// - No 64-bit division and no division per pixel: x is on
//   threadIdx.x/blockIdx.x, the row on threadIdx.y/blockIdx.y (with the
//   channel chunk: one 32-bit division of block indices), the sample on
//   blockIdx.z (a batch of more than 65535 samples takes several launches).
// - The fold needs fmodf only beyond two periods (see reflect_coord).
// - A warp is 32 neighbouring pixels of one row, so the stores, the flow
//   loads and most corner loads of a warp are coalesced within each plane.
// - A row band of a sharded step writes its own rows [row0, row0 + rows) of
//   the frame from the whole source: the flow and the output hold the
//   band's rows, the grid, the normalization and the reflection are the
//   frame's (H, W). One process passes row0 = 0, rows = H.
// Layout: NCHW, as everywhere in the port.
#include "common.cuh"

namespace {

constexpr int TX = 32;   // pixels of a row per block (one warp)

// torch reflect_coordinates with align_corners=True: fold into [0, span],
// bit for bit as fmodf. For 0 <= a < 2*two, fmod(a, two) is a or a - two,
// and a - two is exact there (Sterbenz: two/2 <= a <= 2*two).
__device__ __forceinline__ float reflect_coord(float c, float span) {
    if (span <= 0.f) return 0.f;
    const float two = 2.f * span;
    const float a = fabsf(c);
    const float r = a < two ? a : (a < 2.f * two ? a - two : fmodf(a, two));
    return r > span ? two - r : r;
}

// Pixel (x, row0 + yo) of sample b samples img at grid + sign * flow; each
// thread writes its pixel, row yo of the output, in channels [c0, c0 + CH)
// (clipped to C).
template <typename T, int CH>
__global__ void __launch_bounds__(CH == 1 ? 256 : 128)
warp_reflect_kernel(const T* __restrict__ img, const float* __restrict__ flow,
                                    const unsigned char* __restrict__ gate,
                                    T* __restrict__ out, int C, int H, int W, int row0,
                                    int rows, int row_tiles, float sign) {
    const int x = blockIdx.x * TX + threadIdx.x;
    const int chunk = blockIdx.y / row_tiles;
    const int yo = (blockIdx.y - chunk * row_tiles) * blockDim.y + threadIdx.y;
    if (x >= W || yo >= rows) return;
    const int b = blockIdx.z;
    const int c0 = chunk * CH;
    const int y = row0 + yo;                            // the frame's row
    const long long hw = static_cast<long long>(H) * W;     // a source plane
    const long long ohw = static_cast<long long>(rows) * W; // an output and flow plane
    const int p = y * W + x;
    const int q = yo * W + x;
    const T* ib = img + (static_cast<long long>(b) * C + c0) * hw;
    T* ob = out + (static_cast<long long>(b) * C + c0) * ohw;

    if (gate != nullptr && *gate == 0) {    // zero flow: the input, unchanged
#pragma unroll
        for (int k = 0; k < CH; ++k)
            if (c0 + k < C) ob[k * ohw + q] = ib[k * hw + p];
        return;
    }

    const float* fb = flow + static_cast<long long>(b) * 2 * ohw;
    const float gx = static_cast<float>(x) + sign * fb[q];
    const float gy = static_cast<float>(y) + sign * fb[ohw + q];
    // reference normalization (true divisions, as JAX), then grid_sample's
    // align_corners=True map back to pixels
    const float nx = 2.0f * (gx / static_cast<float>(W) - 0.5f);
    const float ny = 2.0f * (gy / static_cast<float>(H) - 0.5f);
    float ux = (nx + 1.0f) * 0.5f * static_cast<float>(W - 1);
    float uy = (ny + 1.0f) * 0.5f * static_cast<float>(H - 1);
    ux = fminf(fmaxf(reflect_coord(ux, static_cast<float>(W - 1)), 0.f),
               static_cast<float>(W - 1));
    uy = fminf(fmaxf(reflect_coord(uy, static_cast<float>(H - 1)), 0.f),
               static_cast<float>(H - 1));

    const float x0f = floorf(ux), y0f = floorf(uy);
    const float wx1 = ux - x0f, wy1 = uy - y0f;
    const float wx0 = 1.f - wx1, wy0 = 1.f - wy1;
    const float w00 = wx0 * wy0, w01 = wx1 * wy0, w10 = wx0 * wy1, w11 = wx1 * wy1;
    // coordinates are folded into range: the +1 corner only leaves the
    // image where its weight is exactly 0
    const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f);
    const int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
    const int o00 = y0 * W + x0, o01 = y0 * W + x1;
    const int o10 = y1 * W + x0, o11 = y1 * W + x1;

    // all corner loads first, so that they are in flight together
    T v[CH][4];
#pragma unroll
    for (int k = 0; k < CH; ++k) {
        if (c0 + k < C) {
            const T* pl = ib + k * hw;
            v[k][0] = pl[o00];
            v[k][1] = pl[o01];
            v[k][2] = pl[o10];
            v[k][3] = pl[o11];
        }
    }
#pragma unroll
    for (int k = 0; k < CH; ++k) {
        if (c0 + k < C) {
            float s = 0.f;
            s += to_f(v[k][0]) * w00;
            s += to_f(v[k][1]) * w01;
            s += to_f(v[k][2]) * w10;
            s += to_f(v[k][3]) * w11;
            ob[k * ohw + q] = from_f<T>(s);
        }
    }
}

template <typename T, int CH>
int launch(const void* img, const void* flow, const void* gate, void* out, int B, int C,
           int H, int W, int row0, int rows, float sign, cudaStream_t st) {
    // one row of 32 pixels per warp; 8 rows a block for the frame (C = 1),
    // 4 for channel chunks (their threads carry 4*CH loads each)
    const int ty = CH == 1 ? 8 : 4;
    const int row_tiles = (rows + ty - 1) / ty;
    const long long ny = static_cast<long long>(row_tiles) * ((C + CH - 1) / CH);
    if (ny > 65535) return static_cast<int>(cudaErrorInvalidValue);
    // the samples are on grid z, at most 65535 a launch
    constexpr int kMaxZ = 65535;
    const long long plane = static_cast<long long>(H) * W;
    const long long oplane = static_cast<long long>(rows) * W;
    for (int b0 = 0; b0 < B; b0 += kMaxZ) {
        const dim3 grid((W + TX - 1) / TX, static_cast<unsigned>(ny), min(B - b0, kMaxZ));
        warp_reflect_kernel<T, CH><<<grid, dim3(TX, ty), 0, st>>>(
            static_cast<const T*>(img) + b0 * plane * C,
            static_cast<const float*>(flow) + b0 * oplane * 2,
            static_cast<const unsigned char*>(gate), static_cast<T*>(out) + b0 * oplane * C,
            C, H, W, row0, rows, row_tiles, sign);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return static_cast<int>(cudaSuccess);
}

template <typename T>
int dispatch(const void* img, const void* flow, const void* gate, void* out, int B, int C,
             int H, int W, int row0, int rows, float sign, cudaStream_t st) {
    if (C == 1) return launch<T, 1>(img, flow, gate, out, B, C, H, W, row0, rows, sign, st);
    return launch<T, 8>(img, flow, gate, out, B, C, H, W, row0, rows, sign, st);
}

}  // namespace

// img: (B, C, H, W) in dtype; flow: (B, 2, rows, W) f32 pixel flow and out:
// (B, C, rows, W), the frame's rows [row0, row0 + rows) (one process: 0 and
// H); gate: null, or one device byte: 0 writes img's rows unchanged, else
// the warp. Samples img at (x + sign*flow_x, y + sign*flow_y).
CISTA_EXPORT int cista_warp_reflect(int dtype, const void* img, const void* flow,
                                    const void* gate, void* out, int B, int C, int H,
                                    int W, int row0, int rows, float sign, void* stream) {
    if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || rows <= 0 || row0 < 0 || row0 > H - rows
        || static_cast<long long>(H) * W > 2147483647LL)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == DT_F32)
        return dispatch<float>(img, flow, gate, out, B, C, H, W, row0, rows, sign, st);
    if (dtype == DT_BF16)
        return dispatch<__nv_bfloat16>(img, flow, gate, out, B, C, H, W, row0, rows, sign, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
