// Bilinear grid sample of NHWC images for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _sample_kernel (grid_sample_pallas) of
// ipercore_tpu/ops/sampling_pallas.py: bilinear, zero padding,
// align_corners=False sample of (N, H, W, C) at (N, h, w, 2); f32 out. The
// TPU kernel's one-hot `Wy @ img` matmul exists because a TPU has no gather
// unit; a GPU has one, so each output pixel is a direct 4-tap gather.
//
// Strides. The grid is read through its pixel stride (the main path hands
// over the UV flow inside the (T, S, S, J, 2) flows, 2J floats a pixel) and
// the output is written through its pixel stride (the main path's output is
// the first 3 channels of the generator's (T, S, S, 6) input), so neither a
// copy of the flow nor a concatenation surrounds the kernel.
//
// Bound. Bytes: the image and grid read once, the output written once; at the
// main path's shape (one 512^2 RGB image under 8 grids) about 45 MB, 0.0135
// ms at 3.35 TB/s. The arithmetic (about 8 f32 operations a channel) is far
// below the card's rate. What costs more than the bytes is the number of
// memory instructions: four taps of C scalar loads and C scalar stores a
// pixel.
//
// Design.
//   rgb4 path (the main path: one f32 RGB image shared by the batch):
//     the image is repacked once per call to 4 channels (3 MB -> 4 MB, resident
//     in the 50 MB L2), so that a tap is one 16-byte read-only load; each
//     thread samples PIX pixels of its block, all grid loads first, for
//     memory-level parallelism; the block stages its outputs in shared memory
//     and writes them back with consecutive threads on consecutive addresses
//     (whole 16-byte vectors when the output is dense).
//   general path (any C, bf16 images, a batch of images): one thread a pixel,
//     C scalar loads a tap, as before.
//
// Arithmetic order is the plain PyTorch version's (ops/sampling_cuda.py) on
// both paths, with explicit round-to-nearest intrinsics so nvcc contracts
// nothing:
//   out = ((t00*(wy0*wx0) + t01*(wy0*wx1)) + t10*(wy1*wx0)) + t11*(wy1*wx1).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// The four taps of one sample: their weights, validity and the top-left
// texel (index 0 where no tap is valid).
struct Taps {
    float w00, w01, w10, w11;
    bool v00, v01, v10, v11;
    long long idx;
};

__device__ __forceinline__ Taps taps(float2 g, int H, int W) {
    const float x = __fsub_rn(__fmul_rn(__fadd_rn(g.x, 1.0f), (float)W * 0.5f), 0.5f);
    const float y = __fsub_rn(__fmul_rn(__fadd_rn(g.y, 1.0f), (float)H * 0.5f), 0.5f);
    const float x0 = floorf(x), y0 = floorf(y);
    const float wx1 = __fsub_rn(x, x0), wy1 = __fsub_rn(y, y0);
    const float wx0 = __fsub_rn(1.0f, wx1), wy0 = __fsub_rn(1.0f, wy1);
    // validity is tested on floats, so NaN and huge coordinates are simply
    // invalid and never converted to an index
    const bool vx0 = (x0 >= 0.0f) && (x0 <= (float)(W - 1));
    const bool vx1 = (x0 >= -1.0f) && (x0 <= (float)(W - 2));
    const bool vy0 = (y0 >= 0.0f) && (y0 <= (float)(H - 1));
    const bool vy1 = (y0 >= -1.0f) && (y0 <= (float)(H - 2));
    const int xi = (vx0 || vx1) ? (int)x0 : 0;
    const int yi = (vy0 || vy1) ? (int)y0 : 0;
    Taps t;
    t.w00 = __fmul_rn(wy0, wx0); t.w01 = __fmul_rn(wy0, wx1);
    t.w10 = __fmul_rn(wy1, wx0); t.w11 = __fmul_rn(wy1, wx1);
    t.v00 = vy0 && vx0; t.v01 = vy0 && vx1; t.v10 = vy1 && vx0; t.v11 = vy1 && vx1;
    t.idx = (long long)yi * W + xi;
    return t;
}

__device__ __forceinline__ float blend(const Taps& t, float t00, float t01, float t10, float t11) {
    float acc = __fadd_rn(__fmul_rn(t00, t.w00), __fmul_rn(t01, t.w01));
    acc = __fadd_rn(acc, __fmul_rn(t10, t.w10));
    return __fadd_rn(acc, __fmul_rn(t11, t.w11));
}

// grid: pixel p's (x, y) at grid + p * grid_ps (8-byte aligned); out: pixel
// p's C channels at out + p * out_ps.
template <typename T>
__global__ void grid_sample_nhwc_kernel(const T* __restrict__ img, const float* __restrict__ grid,
                                        long long grid_ps, float* __restrict__ out, long long out_ps,
                                        long long total, long long img_batch_stride, int H, int W,
                                        int C, int hw) {
    const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= total) return;
    const Taps t = taps(*reinterpret_cast<const float2*>(grid + p * grid_ps), H, W);
    const T* p00 = img + (p / hw) * img_batch_stride + t.idx * C;
    const T* p01 = p00 + C;
    const T* p10 = p00 + (long long)W * C;
    const T* p11 = p10 + C;
    float* o = out + p * out_ps;
    for (int c = 0; c < C; ++c)
        o[c] = blend(t, t.v00 ? to_f32(p00[c]) : 0.0f, t.v01 ? to_f32(p01[c]) : 0.0f,
                     t.v10 ? to_f32(p10[c]) : 0.0f, t.v11 ? to_f32(p11[c]) : 0.0f);
}

__global__ void repack_rgb4_kernel(const float* __restrict__ img, float4* __restrict__ img4, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) img4[i] = make_float4(img[3 * i], img[3 * i + 1], img[3 * i + 2], 0.0f);
}

constexpr int RGB_THREADS = 256;
constexpr int PIX = 4;  // pixels a thread
constexpr int RGB_BLOCK = RGB_THREADS * PIX;

__global__ void __launch_bounds__(RGB_THREADS)
grid_sample_rgb4_kernel(const float4* __restrict__ img4, const float* __restrict__ grid,
                        long long grid_ps, float* __restrict__ out, long long out_ps,
                        long long total, int H, int W) {
    __shared__ __align__(16) float s_out[RGB_BLOCK * 3];
    const long long p0 = (long long)blockIdx.x * RGB_BLOCK;
    const int n_px = (int)min((long long)RGB_BLOCK, total - p0);
    float2 g[PIX];
#pragma unroll
    for (int u = 0; u < PIX; ++u) {
        const int q = u * RGB_THREADS + threadIdx.x;
        g[u] = q < n_px ? *reinterpret_cast<const float2*>(grid + (p0 + q) * grid_ps)
                        : make_float2(-2.0f, -2.0f);
    }
#pragma unroll
    for (int u = 0; u < PIX; ++u) {
        const int q = u * RGB_THREADS + threadIdx.x;
        const Taps t = taps(g[u], H, W);
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 a = t.v00 ? __ldg(img4 + t.idx) : zero;
        const float4 b = t.v01 ? __ldg(img4 + t.idx + 1) : zero;
        const float4 c = t.v10 ? __ldg(img4 + t.idx + W) : zero;
        const float4 d = t.v11 ? __ldg(img4 + t.idx + W + 1) : zero;
        if (q < n_px) {
            s_out[3 * q] = blend(t, a.x, b.x, c.x, d.x);
            s_out[3 * q + 1] = blend(t, a.y, b.y, c.y, d.y);
            s_out[3 * q + 2] = blend(t, a.z, b.z, c.z, d.z);
        }
    }
    __syncthreads();
    const int n_out = n_px * 3;
    if (out_ps == 3 && (reinterpret_cast<size_t>(out) & 15) == 0) {
        // dense: whole 16-byte vectors (p0 * 12 bytes is a multiple of 16)
        float4* o = reinterpret_cast<float4*>(out + p0 * 3);
        const float4* s = reinterpret_cast<const float4*>(s_out);
        for (int i = threadIdx.x; i < n_out / 4; i += RGB_THREADS) o[i] = s[i];
        for (int i = (n_out / 4) * 4 + threadIdx.x; i < n_out; i += RGB_THREADS) out[p0 * 3 + i] = s_out[i];
    } else {
        for (int i = threadIdx.x; i < n_out; i += RGB_THREADS) {
            const int q = i / 3;
            out[(p0 + q) * out_ps + (i - 3 * q)] = s_out[i];
        }
    }
}

template <typename T>
int launch_general(const void* img, long long img_batch_stride, const float* grid, long long grid_ps,
                   float* out, long long out_ps, long long total, int H, int W, int C, int hw,
                   cudaStream_t stream) {
    const int threads = 256;
    const long long blocks = (total + threads - 1) / threads;
    grid_sample_nhwc_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
        (const T*)img, grid, grid_ps, out, out_ps, total, img_batch_stride, H, W, C, hw);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// img: (N, H, W, C) f32 (is_bf16 = 0) or bf16 (is_bf16 = 1), each image dense,
// images img_batch_stride elements apart (0 = one image shared by the batch);
// grid: (N, h, w, 2) f32, pixel p at grid + p * grid_ps, 8-byte aligned;
// out: (N, h, w, C) f32, pixel p at out + p * out_ps. img4: H*W float4 of
// scratch for the rgb4 path, taken when img4 is not null (the caller passes
// it for a shared f32 image with C = 3). Returns cudaGetLastError().
int grid_sample_nhwc_launch(const void* img, int is_bf16, long long img_batch_stride,
                            const float* grid, long long grid_ps, float* out, long long out_ps,
                            void* img4, int N, int H, int W, int C, int h, int w, void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    const long long total = (long long)N * h * w;
    if (total == 0) return 0;
    if (img4 != nullptr) {
        const int n = H * W;
        repack_rgb4_kernel<<<(n + 255) / 256, 256, 0, stream>>>((const float*)img, (float4*)img4, n);
        grid_sample_rgb4_kernel<<<(unsigned)((total + RGB_BLOCK - 1) / RGB_BLOCK), RGB_THREADS, 0, stream>>>(
            (const float4*)img4, grid, grid_ps, out, out_ps, total, H, W);
        return (int)cudaGetLastError();
    }
    if (is_bf16)
        return launch_general<__nv_bfloat16>(img, img_batch_stride, grid, grid_ps, out, out_ps, total,
                                             H, W, C, h * w, stream);
    return launch_general<float>(img, img_batch_stride, grid, grid_ps, out, out_ps, total, H, W, C,
                                 h * w, stream);
}

}  // extern "C"
