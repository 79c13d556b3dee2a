// What csrc/raster_bin.cu (the device binning) and csrc/raster.cu (the walk
// and the epilogue) must agree on: the tile, the binning's static sizes, the
// layout of a geometry row, and the arithmetic of pixel centres and
// barycentrics; and what the table raster's sources (csrc/raster_table_bin.cu,
// csrc/raster_table.cu) share with them: the geometry row of a face, the
// warp-aggregated walk over a face's tiles, cp.async and the SM count.
// Arithmetic order is the plain PyTorch version's (ops/rasterizer.py),
// spelled with round-to-nearest intrinsics so that nvcc contracts nothing.
#pragma once

#include <cuda_runtime.h>

namespace raster {

constexpr int TILE = 16;        // pixels per tile side
constexpr int E_CAP = 16;       // tile entries one face may write; a larger span goes to its
                                // frame's wide list (JAX `entries_per_face`)
constexpr int ITEM = 64;        // entries per work item of the walk
constexpr int ROW = 16;         // floats per geometry row [M 9 | z 3 | bbox 4]
constexpr int N_STATS = 5;      // max_span, total_entries, listed_entries, max_tile_load, wide_faces
constexpr float BIN_MARGIN_PX = 2.0f;
constexpr float NEAR_Z = 0.1f;
constexpr float FAR_Z = 25.0f;
constexpr float FLOW_SENTINEL = -2.0f;

// Pixel centre (2i + 1 - S) / S, the same float for a column or a row.
__device__ __forceinline__ float pixel_centre(int i, int S) {
    return __fdiv_rn((float)(2 * i + 1 - S), (float)S);
}

// w = a*px + b*py + c as fma(b, py, a*px) + c.
__device__ __forceinline__ float bary(float a, float b, float c, float px, float py) {
    return __fadd_rn(__fmaf_rn(b, py, __fmul_rn(a, px)), c);
}

// (w0*v0 + w1*v1) + w2*v2 with every product and sum rounded.
__device__ __forceinline__ float blend3(float w0, float w1, float w2, float v0, float v1, float v2) {
    return __fadd_rn(__fadd_rn(__fmul_rn(w0, v0), __fmul_rn(w1, v1)), __fmul_rn(w2, v2));
}

// f32 a*b + c rounded once after an exact product and an f64 sum, as
// ops/rasterizer.py::fma32 computes it.
__device__ __forceinline__ float fma32(float a, float b, float c) {
    return __double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

struct FaceBox {
    float xmin, xmax, ymin, ymax, zmin;
    bool valid;
};

// Writes face v's (9 floats: three (x, y, z)) geometry row [M 9 | z 3 | bbox 4]
// to row (16-byte aligned), bit for bit as ops/rasterizer.py::
// _face_bary_matrices and _face_bbox compute it, and returns its box, its
// nearest depth and its validity (not degenerate, in depth range, on screen).
__device__ __forceinline__ FaceBox face_row(const float* __restrict__ v, float* __restrict__ row_out) {
    const float x0 = v[0], y0 = v[1], z0 = v[2];
    const float x1 = v[3], y1 = v[4], z1 = v[5];
    const float x2 = v[6], y2 = v[7], z2 = v[8];
    const float det = fma32(x2, __fsub_rn(y0, y1),
                            fma32(x0, __fsub_rn(y1, y2), -__fmul_rn(x1, __fsub_rn(y0, y2))));
    const bool degenerate = fabsf(det) < 1e-12f;
    const float inv = degenerate ? 0.0f : __frcp_rn(det);
    // rows (1,2), (2,0), (0,1): [yi - yj, xj - xi, fma(xi, yj, -(xj * yi))] * inv
    const float m00 = __fmul_rn(__fsub_rn(y1, y2), inv), m01 = __fmul_rn(__fsub_rn(x2, x1), inv);
    const float m02 = __fmul_rn(fma32(x1, y2, -__fmul_rn(x2, y1)), inv);
    const float m10 = __fmul_rn(__fsub_rn(y2, y0), inv), m11 = __fmul_rn(__fsub_rn(x0, x2), inv);
    const float m12 = __fmul_rn(fma32(x2, y0, -__fmul_rn(x0, y2)), inv);
    const float m20 = __fmul_rn(__fsub_rn(y0, y1), inv), m21 = __fmul_rn(__fsub_rn(x1, x0), inv);
    const float m22 = __fmul_rn(fma32(x0, y1, -__fmul_rn(x1, y0)), inv);
    FaceBox b;
    b.xmin = fminf(fminf(x0, x1), x2); b.xmax = fmaxf(fmaxf(x0, x1), x2);
    b.ymin = fminf(fminf(y0, y1), y2); b.ymax = fmaxf(fmaxf(y0, y1), y2);
    b.zmin = fminf(fminf(z0, z1), z2);
    const float zmax = fmaxf(fmaxf(z0, z1), z2);
    float4* row = reinterpret_cast<float4*>(row_out);
    row[0] = make_float4(m00, m01, m02, m10);
    row[1] = make_float4(m11, m12, m20, m21);
    row[2] = make_float4(m22, z0, z1, z2);
    row[3] = make_float4(b.xmin, b.xmax, b.ymin, b.ymax);
    const bool on_screen = !(b.xmax < -1.5f || b.xmin > 1.5f || b.ymax < -1.5f || b.ymin > 1.5f);
    b.valid = !degenerate && b.zmin < FAR_Z && zmax > NEAR_Z && on_screen;
    return b;
}

// Calls visit(tile, same, leader) once for every (face, tile) entry of the
// warp's listed faces (span <= E_CAP; range = inclusive (tx0, tx1, ty0, ty1),
// tx0 < 0 for none) on a grid of gx tiles a row and n_tiles a frame, the
// warp's lanes in step: `same` is the mask of lanes at the same global tile in
// this step and `leader` its lowest lane, so one atomic per tile and step
// serves them all (neighbouring face ids tend to share tiles, and the densest
// tiles hold thousands of faces). Every lane of the warp must call it.
template <typename Visit>
__device__ __forceinline__ void for_each_listed_tile(long long i, int F, int gx, int n_tiles,
                                                     int4 range, unsigned span, Visit visit) {
    const int n = (range.x >= 0 && span <= E_CAP) ? (int)span : 0;
    const int ntx = range.y - range.x + 1;
    const long long tiles0 = (i / max(F, 1)) * n_tiles;
    for (int it = 0;; ++it) {
        const unsigned active = __ballot_sync(0xffffffffu, it < n);
        if (!active) break;
        if (it < n) {
            const int dy = it / ntx, dx = it - dy * ntx;
            const long long tile = tiles0 + (long long)(range.z + dy) * gx + range.x + dx;
            const unsigned same = __match_any_sync(active, tile);
            visit(tile, same, __ffs(same) - 1);
        }
    }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// Streaming multiprocessors of the current device (persistent grids size by
// it), read on every launch: the wrappers make the inputs' device current, and
// one process may launch on several devices. The runtime caches the attribute.
inline int sm_count() {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
}

}  // namespace raster
