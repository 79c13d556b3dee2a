// K5: SPADE's three 3x3 convolutions as a float32 implicit GEMM on NVIDIA
// Hopper (sm_90a), NHWC in and out, with ReLU or the SPADE modulation in the
// epilogue.
//
// Replaces no TPU kernel: the JAX package left these convolutions to XLA.
// It was added because cuDNN's heuristics put SPADE's float32 3x3
// convolutions (TF32 off) on its FFT algorithm, with NHWC <-> NCHW layout
// transforms around each call, and because the module wrote gamma and beta
// to device memory only to read them back through an elementwise chain.
// Two launches a SPADE block (models/networks/blocks.SPADE):
//   RELU:     actv = relu(conv3x3(condmap, Conv_0) + b0), (N, h, w, 128);
//   MODULATE: Conv_1 and Conv_2 as one GEMM whose packed weight columns
//             interleave (gamma_c, beta_c), so that a thread holds both of a
//             channel, and out = (x - mean) * rstd * (1 + gamma) + beta, with
//             mean and rstd the instance-norm statistics of x per (n, c);
//             gamma and beta never reach device memory.
//
// GEMM view: M = N*h*w output pixels, N = output columns, K = 9 * kc in the
// order (tap, input channel), with kc the input channels rounded up to 16, so
// a K tile of 16 lies inside one tap and its A rows are 64 contiguous bytes of
// one input pixel: NHWC keeps channels innermost. Out-of-image taps read as
// zero. Any widths run: where cin is a multiple of 16 and the output columns
// of 4 (the main path's are), tiles move as float4 with no channel test
// (template VEC); otherwise as single floats, channels past cin and columns
// past cout read as zero.
//
// Bound: operations. At the main path's shapes (chunk of 8, 256^2 / 128^2 /
// 64^2, 64 / 128 / 256 channels) each launch does 2 * M * N * K flops = 9.7
// to 19.3 GFLOP a frame against a few hundred MB of traffic, far above the
// card's 20 flops a byte of float32. So it runs at the FFMA rate, 67 TFLOP/s,
// with no TF32 and no split-TF32: every product is one float32 fmaf.
//
// Design: a 128 x 128 output tile a block of 256 threads, each thread an 8 x 8
// register block (rows ty*4 + {0..3, 64..67}, columns tx*4 + {0..3, 64..67},
// so that the fragment loads from shared memory are float4 and conflict-free);
// K in tiles of 16 through two shared-memory stages: while the block works on
// one stage, each thread's global loads of the next tile (two float4 of A,
// two of B) are in flight in registers, and land in the other stage after the
// tile's 1024 fmaf a thread. A is stored transposed (k-major) so that a warp's
// 32 pixels of one k land in 32 banks. Blocks walk the column tiles of one row
// tile together, so A is read from L2 once per row tile.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 16, THREADS = 256;
constexpr int RELU = 0, MODULATE = 1;

struct ConvArgs {
    const float* in;    // (nb, H, W, cin)
    const float* wp;    // (9 * cin, cout), row k = tap * cin + ci, tap = 3 * (dy + 1) + (dx + 1)
    const float* bias;  // (cout)
    float* out;         // RELU: (nb, H, W, cout); MODULATE: (nb, H, W, cout / 2)
    const float* x;     // MODULATE: (nb, H, W, cout / 2), the modulated feature
    const float* mean;  // MODULATE: (nb, cout / 2)
    const float* rstd;  // MODULATE: (nb, cout / 2)
    int nb, H, W, cin, cout;
};

// the first min(n, 4) floats from q, zero after (n may be 0 or less)
__device__ __forceinline__ float4 load_floats(const float* q, int n) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n > 0) v.x = __ldg(q);
    if (n > 1) v.y = __ldg(q + 1);
    if (n > 2) v.z = __ldg(q + 2);
    if (n > 3) v.w = __ldg(q + 3);
    return v;
}

template <int EPI, bool VEC>
__global__ void __launch_bounds__(THREADS, 2) spade_conv3x3_kernel(ConvArgs a) {
    __shared__ __align__(16) float As[2][BK][BM];
    __shared__ __align__(16) float Bs[2][BK][BN];

    const int tid = threadIdx.x;
    const int n_tiles = (a.cout + BN - 1) / BN;
    const long long hw = (long long)a.H * a.W;
    const long long M = (long long)a.nb * hw;
    const long long m0 = (long long)(blockIdx.x / n_tiles) * BM;
    const int n0 = (blockIdx.x % n_tiles) * BN;
    const int kc = VEC ? a.cin : (a.cin + BK - 1) / BK * BK;  // K a tap
    const int KT = 9 * kc / BK;

    // A loads: pixel m0 + lm, channels [4 cg, 4 cg + 4) and [8 + 4 cg, 12 + 4 cg) of a K tile
    const int lm = tid & (BM - 1), cg = tid >> 7;
    const long long pm = m0 + lm;
    const bool p_in = pm < M;
    int py = 0, px = 0;
    if (p_in) {
        const long long r = pm % hw;
        py = (int)(r / a.W);
        px = (int)(r - (long long)py * a.W);
    }
    const float* p_base = a.in + (p_in ? pm : 0) * a.cin + 4 * cg;
    // B loads: rows br and br + 8 of a K tile, columns n0 + bc .. + 3
    const int br = tid >> 5, bc = (tid & 31) * 4;
    const bool b_in = n0 + bc < a.cout;
    const float* b_base = a.wp + (long long)br * a.cout + n0 + bc;

    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 ra0, ra1, rb0, rb1;
    auto load = [&](int kt) {
        const int k0 = kt * BK;
        const int tap = k0 / kc, c0 = k0 - tap * kc;
        const int dy = tap / 3 - 1, dx = tap - 3 * (tap / 3) - 1;
        const int iy = py + dy, ix = px + dx;
        ra0 = zero;
        ra1 = zero;
        if (p_in && iy >= 0 && iy < a.H && ix >= 0 && ix < a.W) {
            const float* p = p_base + ((long long)dy * a.W + dx) * a.cin + c0;
            if (VEC) {
                ra0 = __ldg(reinterpret_cast<const float4*>(p));
                ra1 = __ldg(reinterpret_cast<const float4*>(p + 8));
            } else {
                const int left = a.cin - c0 - 4 * cg;  // channels from p on
                ra0 = load_floats(p, left);
                ra1 = load_floats(p + 8, left - 8);
            }
        }
        rb0 = zero;
        rb1 = zero;
        if (VEC) {
            if (b_in) {
                const float* q = b_base + (long long)k0 * a.cout;
                rb0 = __ldg(reinterpret_cast<const float4*>(q));
                rb1 = __ldg(reinterpret_cast<const float4*>(q + 8LL * a.cout));
            }
        } else {
            // packed row tap * cin + ci of input channel ci = c0 + br
            const float* q = b_base + ((long long)tap * a.cin + c0) * a.cout;
            const int ci = c0 + br, cols = a.cout - n0 - bc;
            if (ci < a.cin) rb0 = load_floats(q, cols);
            if (ci + 8 < a.cin) rb1 = load_floats(q + 8LL * a.cout, cols);
        }
    };
    auto store = [&](int s) {
        As[s][4 * cg + 0][lm] = ra0.x;
        As[s][4 * cg + 1][lm] = ra0.y;
        As[s][4 * cg + 2][lm] = ra0.z;
        As[s][4 * cg + 3][lm] = ra0.w;
        As[s][8 + 4 * cg + 0][lm] = ra1.x;
        As[s][8 + 4 * cg + 1][lm] = ra1.y;
        As[s][8 + 4 * cg + 2][lm] = ra1.z;
        As[s][8 + 4 * cg + 3][lm] = ra1.w;
        *reinterpret_cast<float4*>(&Bs[s][br][bc]) = rb0;
        *reinterpret_cast<float4*>(&Bs[s][br + 8][bc]) = rb1;
    };

    const int ty = tid >> 4, tx = tid & 15;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    load(0);
    store(0);
    __syncthreads();
    for (int kt = 0; kt < KT; ++kt) {
        const int s = kt & 1;
        if (kt + 1 < KT) load(kt + 1);
#pragma unroll
        for (int k = 0; k < BK; ++k) {
            const float4 a0 = *reinterpret_cast<const float4*>(&As[s][k][ty * 4]);
            const float4 a1 = *reinterpret_cast<const float4*>(&As[s][k][ty * 4 + 64]);
            const float4 b0 = *reinterpret_cast<const float4*>(&Bs[s][k][tx * 4]);
            const float4 b1 = *reinterpret_cast<const float4*>(&Bs[s][k][tx * 4 + 64]);
            const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        if (kt + 1 < KT) store(s ^ 1);
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const long long m = m0 + ty * 4 + (i & 3) + (i >> 2) * 64;
        if (m >= M) continue;
#pragma unroll
        for (int g = 0; g < 2; ++g) {
            const int col = n0 + tx * 4 + g * 64;
            if (col >= a.cout) continue;
            const float4 bias = VEC ? __ldg(reinterpret_cast<const float4*>(a.bias + col))
                                    : load_floats(a.bias + col, a.cout - col);
            const float v0 = acc[i][4 * g + 0] + bias.x, v1 = acc[i][4 * g + 1] + bias.y;
            const float v2 = acc[i][4 * g + 2] + bias.z, v3 = acc[i][4 * g + 3] + bias.w;
            if (EPI == RELU) {
                float* o = a.out + m * a.cout + col;
                if (VEC) {
                    *reinterpret_cast<float4*>(o) =
                        make_float4(fmaxf(v0, 0.f), fmaxf(v1, 0.f), fmaxf(v2, 0.f), fmaxf(v3, 0.f));
                } else {
                    o[0] = fmaxf(v0, 0.f);
                    if (col + 1 < a.cout) o[1] = fmaxf(v1, 0.f);
                    if (col + 2 < a.cout) o[2] = fmaxf(v2, 0.f);
                    if (col + 3 < a.cout) o[3] = fmaxf(v3, 0.f);
                }
            } else if (VEC) {
                // columns (gamma, beta) of channels ch and ch + 1
                const int c = a.cout / 2, ch = col / 2;
                const long long n = m / hw;
                const float2 xv = __ldg(reinterpret_cast<const float2*>(a.x + m * c + ch));
                const float2 mu = __ldg(reinterpret_cast<const float2*>(a.mean + n * c + ch));
                const float2 rs = __ldg(reinterpret_cast<const float2*>(a.rstd + n * c + ch));
                const float n0v = __fmul_rn(__fsub_rn(xv.x, mu.x), rs.x);
                const float n1v = __fmul_rn(__fsub_rn(xv.y, mu.y), rs.y);
                *reinterpret_cast<float2*>(a.out + m * c + ch) =
                    make_float2(__fadd_rn(__fmul_rn(n0v, __fadd_rn(1.f, v0)), v1),
                                __fadd_rn(__fmul_rn(n1v, __fadd_rn(1.f, v2)), v3));
            } else {
                // the same, one channel at a time (cout = 2c is even, so col < cout means ch < c)
                const int c = a.cout / 2, ch = col / 2;
                const long long n = m / hw;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    if (ch + h >= c) continue;
                    const float nv = __fmul_rn(__fsub_rn(__ldg(a.x + m * c + ch + h), __ldg(a.mean + n * c + ch + h)),
                                               __ldg(a.rstd + n * c + ch + h));
                    a.out[m * c + ch + h] = __fadd_rn(__fmul_rn(nv, __fadd_rn(1.f, h ? v2 : v0)), h ? v3 : v1);
                }
            }
        }
    }
}

template <int EPI>
void launch_epi(const ConvArgs& a, unsigned blocks, cudaStream_t stream) {
    if (a.cin % BK == 0 && a.cout % 4 == 0)
        spade_conv3x3_kernel<EPI, true><<<blocks, THREADS, 0, stream>>>(a);
    else
        spade_conv3x3_kernel<EPI, false><<<blocks, THREADS, 0, stream>>>(a);
}

int launch(int epi, const ConvArgs& a, cudaStream_t stream) {
    const long long M = (long long)a.nb * a.H * a.W;
    const long long blocks = ((M + BM - 1) / BM) * ((a.cout + BN - 1) / BN);
    if (blocks > 0) {
        if (epi == RELU)
            launch_epi<RELU>(a, (unsigned)blocks, stream);
        else
            launch_epi<MODULATE>(a, (unsigned)blocks, stream);
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// in: (nb, H, W, cin) f32 NHWC; wp: (9 * cin, cout) packed weights; bias: (cout);
// out: (nb, H, W, cout) = relu(conv3x3(in) + bias), zero padding 1. Any
// widths; every pointer 16-byte aligned. Returns cudaGetLastError().
int spade_conv_relu_launch(const float* in, const float* wp, const float* bias, float* out,
                           int nb, int H, int W, int cin, int cout, void* stream) {
    const ConvArgs a{in, wp, bias, out, nullptr, nullptr, nullptr, nb, H, W, cin, cout};
    return launch(RELU, a, (cudaStream_t)stream);
}

// actv: (nb, H, W, cin); wp: (9 * cin, 2c) with columns (gamma_0, beta_0,
// gamma_1, ...); bias: (2c) in the same order; x: (nb, H, W, c); mean, rstd:
// (nb, c); out: (nb, H, W, c) = (x - mean) * rstd * (1 + gamma) + beta. Any
// widths; every pointer 16-byte aligned. Returns cudaGetLastError().
int spade_modulate_launch(const float* actv, const float* wp, const float* bias, const float* x,
                          const float* mean, const float* rstd, float* out,
                          int nb, int H, int W, int cin, int c, void* stream) {
    const ConvArgs a{actv, wp, bias, out, x, mean, rstd, nb, H, W, cin, 2 * c};
    return launch(MODULATE, a, (cudaStream_t)stream);
}

}  // extern "C"
