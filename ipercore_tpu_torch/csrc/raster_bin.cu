// Device binning of projected faces into 16x16 pixel tiles, for NVIDIA Hopper
// (sm_90a): the input side of raster_flows and raster_fim (csrc/raster.cu).
//
// Replaces the binning of the two Pallas TPU kernels it feeds
// (ipercore_tpu/ops/rasterizer_pallas.py: `_bin_faces_csr` for
// _raster_flow_kernel_csr, `_bin_faces` for _raster_kernel), which is array
// code at static sizes there. Three kernels, one launch call, no host sync
// and no sort:
//   count: one thread per (frame, face) writes the face's geometry row
//          [M 9 | z 3 | bbox 4] and validity, bit for bit as
//          ops/rasterizer.py::_face_bary_matrices computes them (its
//          f32 fused multiply-add is emulated through f64, as `fma32` does),
//          and its inclusive tile range with the f32 formula of the plain
//          binning (box padded by 2 px); it adds one to the count of every
//          tile of the range, or, when the range holds more than E_CAP
//          tiles, one to its frame's wide count;
//   scan:  one block per frame turns the counts into segment starts inside
//          the frame's region of F * E_CAP slots, and the per-tile number of
//          work items, ceil((count + wide) / ITEM), into item starts;
//   fill:  one thread per (frame, face) writes the face id into its tiles'
//          segments through per-tile atomic cursors, or onto the wide list.
// The count and fill atomics on a tile are aggregated per warp.
// Buffers have static sizes (T*F*E_CAP tile entries, T*F wide ids), so
// nothing is truncated. A tile's list comes out in no fixed order: the walk's
// winner rule (smallest depth, then lowest face id) does not depend on it.
//
// Bound: the kernels read the faces once (36 B each) and write 64 B of
// geometry plus a few entries per face, microseconds at the main path's 110k
// faces; what they cannot avoid is that atomics on one tile serialise (the
// densest holds about 1400 faces at 512^2), hence the warp aggregation.
#include "raster_common.cuh"

namespace {

using namespace raster;

// Inclusive tile range [t0, t1] of the padded extent [vmin, vmax] on a grid
// of g tiles: floor(((v + 1) * S/2 - 0.5 -+ margin) / TILE), clipped.
__device__ __forceinline__ int2 tile_range(float vmin, float vmax, int S, int g) {
    const float half = 0.5f * (float)S;
    const float lo = __fsub_rn(__fsub_rn(__fmul_rn(__fadd_rn(vmin, 1.0f), half), 0.5f), BIN_MARGIN_PX);
    const float hi = __fadd_rn(__fsub_rn(__fmul_rn(__fadd_rn(vmax, 1.0f), half), 0.5f), BIN_MARGIN_PX);
    const float top = (float)(g - 1);
    const float t0 = fminf(fmaxf(floorf(__fdiv_rn(lo, (float)TILE)), 0.0f), top);
    const float t1 = fminf(fmaxf(floorf(__fdiv_rn(hi, (float)TILE)), 0.0f), top);
    return make_int2((int)t0, (int)t1);
}

// frange: (tx0, tx1, ty0, ty1) per face, tx0 = -1 when the face is invalid.
__global__ void __launch_bounds__(256)
raster_count_kernel(const float* __restrict__ fv, int T, int F, int S, int g,
                    float* __restrict__ geom, int4* __restrict__ frange,
                    unsigned* __restrict__ counts, unsigned* __restrict__ wide_count,
                    unsigned* __restrict__ stats) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    unsigned span = 0, wide = 0;
    int4 range = make_int4(-1, -1, -1, -1);
    if (i < (long long)T * F) {
        const FaceBox b = face_row(fv + i * 9, geom + i * ROW);
        if (b.valid) {
            const int2 tx = tile_range(b.xmin, b.xmax, S, g), ty = tile_range(b.ymin, b.ymax, S, g);
            range = make_int4(tx.x, tx.y, ty.x, ty.y);
            span = (unsigned)((tx.y - tx.x + 1) * (ty.y - ty.x + 1));
            if (span > E_CAP) {
                wide = 1;
                atomicAdd(&wide_count[i / F], 1u);
            }
        }
        frange[i] = range;
    }
    for_each_listed_tile(i, F, g, g * g, range, span, [&](long long tile, unsigned same, int leader) {
        if ((threadIdx.x & 31) == leader) atomicAdd(&counts[tile], (unsigned)__popc(same));
    });
    // one atomic per warp for the stats (blockDim is a multiple of 32)
    const unsigned mx = __reduce_max_sync(0xffffffffu, span);
    const unsigned sum = __reduce_add_sync(0xffffffffu, span);
    const unsigned nw = __reduce_add_sync(0xffffffffu, wide);
    if ((threadIdx.x & 31) == 0) {
        if (mx) atomicMax(&stats[0], mx);
        if (sum) atomicAdd(&stats[1], sum);
        if (nw) atomicAdd(&stats[4], nw);
    }
}

__device__ __forceinline__ unsigned n_items(unsigned n) { return (n + ITEM - 1) / ITEM; }

// One block of SCAN_THREADS per frame; each thread owns a run of tiles.
constexpr int SCAN_THREADS = 1024;

__global__ void __launch_bounds__(SCAN_THREADS)
raster_scan_kernel(const unsigned* __restrict__ counts, const unsigned* __restrict__ wide_count,
                   int F, int n_tiles, int* __restrict__ seg, int* __restrict__ cursor,
                   int* __restrict__ items, unsigned* __restrict__ stats) {
    __shared__ unsigned warp_a[32], warp_b[32];
    const int f = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const unsigned w = wide_count[f];
    const long long tiles0 = (long long)f * n_tiles;
    const int per = (n_tiles + SCAN_THREADS - 1) / SCAN_THREADS;
    const int t0 = min(tid * per, n_tiles), t1 = min(t0 + per, n_tiles);
    unsigned a = 0, b = 0, load = 0;
    for (int t = t0; t < t1; ++t) {
        const unsigned n = counts[tiles0 + t];
        a += n;
        b += n_items(n + w);
        load = max(load, n + w);
    }
    // block-wide inclusive scan of (a, b): within warps, then over warp totals
    unsigned ia = a, ib = b;
    for (int o = 1; o < 32; o <<= 1) {
        const unsigned ua = __shfl_up_sync(0xffffffffu, ia, o), ub = __shfl_up_sync(0xffffffffu, ib, o);
        if (lane >= o) { ia += ua; ib += ub; }
    }
    if (lane == 31) { warp_a[warp] = ia; warp_b[warp] = ib; }
    __syncthreads();
    if (warp == 0) {
        unsigned xa = warp_a[lane], xb = warp_b[lane];  // SCAN_THREADS / 32 == 32 warps
        for (int o = 1; o < 32; o <<= 1) {
            const unsigned ua = __shfl_up_sync(0xffffffffu, xa, o), ub = __shfl_up_sync(0xffffffffu, xb, o);
            if (lane >= o) { xa += ua; xb += ub; }
        }
        warp_a[lane] = xa;
        warp_b[lane] = xb;
    }
    __syncthreads();
    unsigned run_a = (warp ? warp_a[warp - 1] : 0u) + ia - a;
    unsigned run_b = (warp ? warp_b[warp - 1] : 0u) + ib - b;
    const long long base = (long long)f * F * E_CAP;
    int* frame_items = items + (long long)f * (n_tiles + 1);
    for (int t = t0; t < t1; ++t) {
        const unsigned n = counts[tiles0 + t];
        seg[tiles0 + t] = (int)(base + run_a);
        cursor[tiles0 + t] = (int)(base + run_a);
        frame_items[t] = (int)run_b;
        run_a += n;
        run_b += n_items(n + w);
    }
    if (tid == 0) frame_items[n_tiles] = (int)warp_b[31];
    const unsigned mx = __reduce_max_sync(0xffffffffu, load);
    const unsigned sum = __reduce_add_sync(0xffffffffu, a);
    if (lane == 0) {
        if (sum) atomicAdd(&stats[2], sum);
        if (mx) atomicMax(&stats[3], mx);
    }
}

__global__ void __launch_bounds__(256)
raster_fill_kernel(const int4* __restrict__ frange, int T, int F, int g, int* __restrict__ cursor,
                   int* __restrict__ ids, unsigned* __restrict__ wide_fill,
                   int* __restrict__ wide_ids) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const int4 r = i < (long long)T * F ? frange[i] : make_int4(-1, -1, -1, -1);
    const unsigned span = r.x < 0 ? 0u : (unsigned)((r.y - r.x + 1) * (r.w - r.z + 1));
    const int f = (int)(i / F), face = (int)(i - (long long)f * F);
    if (span > E_CAP) wide_ids[(long long)f * F + atomicAdd(&wide_fill[f], 1u)] = face;
    const int lane = threadIdx.x & 31;
    for_each_listed_tile(i, F, g, g * g, r, span, [&](long long tile, unsigned same, int leader) {
        int base = 0;
        if (lane == leader) base = atomicAdd(&cursor[tile], __popc(same));
        base = __shfl_sync(same, base, leader);
        ids[base + __popc(same & ((1u << lane) - 1u))] = face;
    });
}

}  // namespace

extern "C" {

// TILE, E_CAP, ITEM, ROW, N_STATS, for the Python side to check.
int raster_bin_constants(int* out) {
    out[0] = raster::TILE; out[1] = raster::E_CAP; out[2] = raster::ITEM; out[3] = raster::ROW;
    out[4] = raster::N_STATS;
    return 0;
}

// face_verts: (T, F, 3, 3) f32. Writes geom (T, F, 16) f32 and, in int32:
// frange (T*F, 4); zeroed = counts (T*n_tiles) | wide_count (T) | wide_fill (T)
// | stats (N_STATS), set to zero here first; seg, cursor (T*n_tiles);
// items (T, n_tiles + 1); ids (T*F*E_CAP); wide_ids (T, F).
// n_tiles = g*g with g = ceil(S / TILE). Returns the first CUDA error.
int raster_bin_launch(const float* face_verts, int T, int F, int S, float* geom, int* frange,
                      int* zeroed, int* seg, int* cursor, int* items, int* ids, int* wide_ids,
                      void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    if (T <= 0) return 0;
    const int g = (S + raster::TILE - 1) / raster::TILE, n_tiles = g * g;
    unsigned* counts = reinterpret_cast<unsigned*>(zeroed);
    unsigned* wide_count = counts + (long long)T * n_tiles;
    unsigned* wide_fill = wide_count + T;
    unsigned* stats = wide_fill + T;
    cudaError_t err = cudaMemsetAsync(zeroed, 0, ((size_t)T * n_tiles + 2 * T + raster::N_STATS) * 4, stream);
    if (err != cudaSuccess) return (int)err;
    const long long faces = (long long)T * F;
    const unsigned blocks = (unsigned)((faces + 255) / 256);
    if (faces > 0)
        raster_count_kernel<<<blocks, 256, 0, stream>>>(
            face_verts, T, F, S, g, geom, reinterpret_cast<int4*>(frange), counts, wide_count, stats);
    raster_scan_kernel<<<T, SCAN_THREADS, 0, stream>>>(counts, wide_count, F, n_tiles, seg, cursor,
                                                       items, stats);
    if (faces > 0)
        raster_fill_kernel<<<blocks, 256, 0, stream>>>(
            reinterpret_cast<const int4*>(frange), T, F, g, cursor, ids, wide_fill, wide_ids);
    return (int)cudaGetLastError();
}

}  // extern "C"
