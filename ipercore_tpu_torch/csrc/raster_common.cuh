// What csrc/raster_bin.cu (the device binning) and csrc/raster.cu (the walk
// and the epilogue) must agree on: the tile, the binning's static sizes, the
// layout of a geometry row, and the arithmetic of pixel centres and
// barycentrics. Arithmetic order is the plain PyTorch version's
// (ops/rasterizer.py), spelled with round-to-nearest intrinsics so that nvcc
// contracts nothing.
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

}  // namespace raster
