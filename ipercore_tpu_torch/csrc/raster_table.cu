// Table-binned z-buffer rasterizer with fused flows for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _raster_flow_kernel of
// ipercore_tpu/ops/rasterizer_pallas.py (entry rasterize_flows_pallas): per
// frame and pixel the nearest face among its 8x128 tile's table entries, its
// global id, and the barycentric blend of J per-vertex 2-D coordinate sets.
//
// The table is the function's, not a device detail: each tile keeps at most k
// faces, nearest first by minimum vertex depth (ops/rasterizer_cuda.py::
// bin_faces_table), and drops the rest. So the tile stays 8 rows x 128
// columns, and on equal depth the entry earlier in the table wins.
//
// Design. One block per (frame, tile), one thread per pixel (1024). The block
// stages the tile's kept face ids through shared memory in chunks of CHUNK
// and fetches each id's geometry row [M 9 | z 3 | bbox 4] from the per-face
// table, as csrc/raster.cu does; every thread walks the chunk keeping best
// depth, face id and the winner's three barycentrics in registers, replacing
// the best only on a strictly smaller depth, i.e. in table order. Flows are
// blended once, after the walk. Nothing of the TPU kernel's shape is kept
// beyond the tile: no one-hot winner extraction, no (k, 16 + 6J) table of
// gathered rows, no padding of the table to its capacity.
//
// Bound. Bytes: the face rows and aux read once, fim and flows written once
// (about 0.1 ms at 512^2, T = 8, J = 3). Operations: about 30 f32 per
// (pixel, face whose guarded box covers it). The walk also box-tests the other
// entries of the tile's list (up to k = 2048 per pixel), which is this
// kernel's own cost and no part of the bound.
//
// Arithmetic order is the plain version's (ops/rasterizer_cuda.py), with
// explicit round-to-nearest intrinsics so that nvcc contracts nothing:
//   px = col * f32(2/S) + f32((1-S)/S)     (JAX K4's pixel centres);
//   w  = fma(a, px, b*py) + c              (JAX K4 in interpret mode);
//   depth = (w0*z0 + w1*z1) + w2*z2;  flow = (w0*p0 + w1*p1) + w2*p2.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TILE_H = 8;
constexpr int TILE_W = 128;
constexpr int THREADS = TILE_H * TILE_W;
constexpr int CHUNK = 256;
constexpr int ROW = 16;  // floats per geometry row
constexpr float NEAR_Z = 0.1f;
constexpr float FAR_Z = 25.0f;
constexpr float FLOW_SENTINEL = -2.0f;

__device__ __forceinline__ float bary(float a, float b, float c, float px, float py) {
    return __fadd_rn(__fmaf_rn(a, px, __fmul_rn(b, py)), c);
}

__device__ __forceinline__ float blend3(float w0, float w1, float w2, float v0, float v1, float v2) {
    return __fadd_rn(__fadd_rn(__fmul_rn(w0, v0), __fmul_rn(w1, v1)), __fmul_rn(w2, v2));
}

// geom: (T, F, 16) rows; ids: (T, n_tiles, k) face ids in table order;
// kept: (T, n_tiles) entries to test; aux: (J, F, 3, 2) shared by the batch.
__global__ void __launch_bounds__(THREADS)
raster_table_kernel(const float* __restrict__ geom, const int* __restrict__ ids,
                    const int* __restrict__ kept, const float* __restrict__ aux,
                    int F, int S, int J, int k, int* __restrict__ fim,
                    float* __restrict__ flows) {
    __shared__ float rows[CHUNK][ROW];
    __shared__ int row_fid[CHUNK];

    const int frame = blockIdx.z;
    const long long slot =
        (long long)frame * gridDim.x * gridDim.y + blockIdx.y * gridDim.x + blockIdx.x;
    const int tid = threadIdx.x;
    const int col = blockIdx.x * TILE_W + tid % TILE_W;
    const int rowi = blockIdx.y * TILE_H + tid / TILE_W;

    const float step = (float)(2.0 / (double)S);
    const float off = (float)((1.0 - (double)S) / (double)S);
    const float px = __fadd_rn(__fmul_rn((float)col, step), off);
    const float py = __fadd_rn(__fmul_rn((float)rowi, step), off);
    const float eps = step;  // the bbox guard, 2/S

    const int n = kept[slot];
    const int* list = ids + slot * k;
    const float* g = geom + (long long)frame * F * ROW;

    float best_z = CUDART_INF_F;
    int best_fid = -1;
    float bw0 = 0.f, bw1 = 0.f, bw2 = 0.f;

    for (int base = 0; base < n; base += CHUNK) {
        const int m = min(CHUNK, n - base);
        __syncthreads();  // previous chunk fully consumed
        for (int e = tid; e < m; e += THREADS) row_fid[e] = list[base + e];
        __syncthreads();
        for (int i = tid; i < m * ROW; i += THREADS) {
            const int e = i / ROW, c = i - e * ROW;
            rows[e][c] = g[(long long)row_fid[e] * ROW + c];
        }
        __syncthreads();
        for (int e = 0; e < m; ++e) {
            const float* r = rows[e];
            const bool in_bbox = (px >= __fsub_rn(r[12], eps)) && (px <= __fadd_rn(r[13], eps))
                              && (py >= __fsub_rn(r[14], eps)) && (py <= __fadd_rn(r[15], eps));
            if (!in_bbox) continue;
            const float w0 = bary(r[0], r[1], r[2], px, py);
            const float w1 = bary(r[3], r[4], r[5], px, py);
            const float w2 = bary(r[6], r[7], r[8], px, py);
            if (!(w0 >= -1e-6f && w1 >= -1e-6f && w2 >= -1e-6f)) continue;
            const float depth = blend3(w0, w1, w2, r[9], r[10], r[11]);
            if (!(depth > NEAR_Z && depth < FAR_Z)) continue;
            if (depth < best_z) {  // strict: the earlier entry keeps a tie
                best_z = depth; best_fid = row_fid[e]; bw0 = w0; bw1 = w1; bw2 = w2;
            }
        }
    }

    const long long pix = ((long long)frame * S + rowi) * S + col;
    fim[pix] = best_fid;
    float* o = flows + pix * (2 * J);
    for (int j = 0; j < J; ++j) {
        if (best_fid < 0) {
            o[2 * j] = FLOW_SENTINEL; o[2 * j + 1] = FLOW_SENTINEL;
        } else {
            const float* p = aux + ((long long)j * F + best_fid) * 6;
            o[2 * j] = blend3(bw0, bw1, bw2, p[0], p[2], p[4]);
            o[2 * j + 1] = blend3(bw0, bw1, bw2, p[1], p[3], p[5]);
        }
    }
}

}  // namespace

extern "C" {

int raster_table_tile_shape() { return TILE_H * 1000 + TILE_W; }

// fim: (T, S, S) int32; flows: (T, S, S, J, 2) f32; S a multiple of 128.
// Returns cudaGetLastError().
int raster_flows_table_launch(const float* geom, const int* ids, const int* kept,
                              const float* aux, int T, int F, int S, int J, int k,
                              int* fim, float* flows, void* stream) {
    dim3 grid(S / TILE_W, S / TILE_H, T), block(THREADS);
    raster_table_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        geom, ids, kept, aux, F, S, J, k, fim, flows);
    return (int)cudaGetLastError();
}

}  // extern "C"
