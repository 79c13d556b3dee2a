// What csrc/raster_table_bin.cu (K4's device binning) and csrc/raster_table.cu
// (K4's walk and epilogue) must agree on: the 8x128 tile of the JAX kernel,
// how a tile's table is cut into work items, and K4's arithmetic of pixel
// centres and barycentrics (the plain version's, ops/rasterizer_cuda.py).
#pragma once

#include "raster_common.cuh"

namespace table {

constexpr int TILE_H = 8;      // the JAX kernel's tile: part of the function once tables have
constexpr int TILE_W = 128;    // a capacity (which faces a tile keeps depends on its extent)
constexpr int WARP_W = 4;      // a warp of the walk owns TILE_H x WARP_W pixels
constexpr int WALK_WARPS = 8;  // a block of the walk covers TILE_H x (WALK_WARPS * WARP_W) pixels
constexpr int PARTS = TILE_W / (WALK_WARPS * WARP_W);  // blocks that cover one tile
constexpr int ITEM = 64;       // table entries per work item of the walk
constexpr int SORT_CAP = 4096; // a tile's candidates sorted whole in shared memory

// The pixel centre of row or column i: i * f32(2/S) + f32((1-S)/S), each step
// rounded (JAX K4's centres).
__device__ __forceinline__ float pixel_centre(int i, float step, float off) {
    return __fadd_rn(__fmul_rn((float)i, step), off);
}

// w = a*px + b*py + c as fma(a, px, b*py) + c: JAX K4 in interpret mode.
__device__ __forceinline__ float bary(float a, float b, float c, float px, float py) {
    return __fadd_rn(__fmaf_rn(a, px, __fmul_rn(b, py)), c);
}

}  // namespace table
