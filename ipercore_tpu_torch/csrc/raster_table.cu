// Table-binned z-buffer rasterizer with fused flows for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _raster_flow_kernel of
// ipercore_tpu/ops/rasterizer_pallas.py (entry rasterize_flows_pallas): per
// frame and pixel the nearest face among its 8x128 tile's table entries, its
// global id, and the barycentric blend of J per-vertex 2-D coordinate sets.
//
// The table is the function's, not a device detail: each tile keeps at most k
// faces, nearest first by minimum vertex depth, and drops the rest
// (csrc/raster_table_bin.cu builds it on the device). So the tile stays 8 rows
// x 128 columns, and on equal depth the entry earlier in the table wins.
//
// Bound. Bytes: the face rows and aux read once, fim and flows written once
// (about 63 MB, 0.019 ms at 512^2, T = 8, J = 3). Operations: about 30 f32 per
// (pixel, face whose guarded box covers it). An earlier one-block-per-tile
// walk, every pixel box-testing every kept entry of its tile (up to k = 2048),
// ran at 19x that bound: the skewed tiles set its time. What bounds this walk
// is the exact per-pixel tests on the faces that pass a warp's box test.
//
// Design (csrc/raster.cu's for K1, over the table):
//   walk:     a work item is (tile, one of PARTS column blocks of 8 x 32
//             pixels, slice of at most ITEM table entries); the binning gives
//             each frame's item starts, and persistent blocks (8 per SM) take
//             items in order from one counter per frame, so long tables are
//             spread over blocks. A block gathers its slice's geometry rows
//             into shared memory with cp.async; each warp owns 8 x 4 pixels,
//             one lane per staged entry tests the entry's guarded box against
//             the warp's extent, and __ballot_sync keeps the hits, so a pixel
//             runs the exact tests only for faces near it. Each thread keeps
//             its pixel's best key (f32 bits of depth << 32 | table position)
//             and merges it with one 64-bit atomicMin into a z-buffer. Depth
//             lies in (NEAR, FAR), so its bits order as unsigned integers: the
//             smallest key is the smallest depth and, on equal depth, the entry
//             earlier in the table, whatever order the items run in.
//   epilogue: one thread per pixel decodes the winner's table position, looks
//             up its face id, recomputes its three barycentrics with the walk's
//             intrinsics (so they are bit-equal) and writes fim; then the block
//             writes its pixels' flows as one contiguous run, so that every
//             sector is written whole.
// Frames pass through the z-buffer ZBUF frames at a time (the caller sizes
// it); a memset clears it before each pass, so a launch can be repeated on
// the same binning.
//
// Arithmetic order is the plain version's (ops/rasterizer_cuda.py):
//   px = col * f32(2/S) + f32((1-S)/S)     (JAX K4's pixel centres);
//   w  = fma(a, px, b*py) + c              (JAX K4 in interpret mode);
//   depth = (w0*z0 + w1*z1) + w2*z2;  flow = (w0*p0 + w1*p1) + w2*p2.
#include "raster_table.cuh"

namespace {

using namespace table;
using raster::FAR_Z;
using raster::FLOW_SENTINEL;
using raster::NEAR_Z;
using raster::ROW;
using raster::blend3;

constexpr int THREADS = WALK_WARPS * 32;
static_assert(ITEM * 4 == THREADS, "four threads gather each of an item's rows");
constexpr int WALK_BLOCKS_PER_SM = 8;
constexpr unsigned long long NO_FACE = ~0ull;

// One work item: entries [begin, begin + n) of the table row `table_ids` of
// tile `tile`, tested by the block's pixels of column block `part`.
__device__ __forceinline__ void walk_item(
        float (*rows)[ROW], const float* __restrict__ fgeom, const int* __restrict__ table_ids,
        int tile, int part, int begin, int n, int S, int gx, unsigned long long* __restrict__ zb) {
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const float step = (float)(2.0 / (double)S);
    const float off = (float)((1.0 - (double)S) / (double)S);
    const float eps = step;  // the bbox guard, 2/S
    const int c0 = (tile % gx) * TILE_W + part * (WALK_WARPS * WARP_W) + warp * WARP_W;
    const int r0 = (tile / gx) * TILE_H;
    const int col = c0 + lane % WARP_W, row = r0 + lane / WARP_W;
    const float px = pixel_centre(col, step, off), py = pixel_centre(row, step, off);
    // the warp's pixel-centre extent (centres grow with the index)
    const float sx0 = pixel_centre(c0, step, off), sx1 = pixel_centre(c0 + WARP_W - 1, step, off);
    const float sy0 = pixel_centre(r0, step, off), sy1 = pixel_centre(r0 + TILE_H - 1, step, off);

    {  // gather the slice's rows by face id: ITEM rows x 4 pieces of 16 bytes
        const int e = tid >> 2, q = tid & 3;
        if (e < n) raster::cp_async16(&rows[e][q * 4], fgeom + (long long)table_ids[begin + e] * ROW + q * 4);
        raster::cp_async_commit();
        raster::cp_async_wait_all();
    }
    __syncthreads();

    unsigned long long best = NO_FACE;
    for (int kk = 0; kk < n; kk += 32) {
        bool hit = false;
        if (kk + lane < n) {
            const float4 b = *reinterpret_cast<const float4*>(&rows[kk + lane][12]);
            hit = sx1 >= __fsub_rn(b.x, eps) && sx0 <= __fadd_rn(b.y, eps)
               && sy1 >= __fsub_rn(b.z, eps) && sy0 <= __fadd_rn(b.w, eps);
        }
        for (unsigned mask = __ballot_sync(0xffffffffu, hit); mask; mask &= mask - 1) {
            const int e = kk + __ffs(mask) - 1;
            const float4* r = reinterpret_cast<const float4*>(rows[e]);
            const float4 box = r[3];
            const bool in_bbox = (px >= __fsub_rn(box.x, eps)) && (px <= __fadd_rn(box.y, eps))
                              && (py >= __fsub_rn(box.z, eps)) && (py <= __fadd_rn(box.w, eps));
            if (!in_bbox) continue;
            const float4 a = r[0], b = r[1], cz = r[2];
            const float w0 = bary(a.x, a.y, a.z, px, py);
            const float w1 = bary(a.w, b.x, b.y, px, py);
            const float w2 = bary(b.z, b.w, cz.x, px, py);
            if (!(w0 >= -1e-6f && w1 >= -1e-6f && w2 >= -1e-6f)) continue;
            const float depth = blend3(w0, w1, w2, cz.y, cz.z, cz.w);
            if (!(depth > NEAR_Z && depth < FAR_Z)) continue;
            const unsigned long long key =
                ((unsigned long long)__float_as_uint(depth) << 32) | (unsigned)(begin + e);
            best = key < best ? key : best;
        }
    }
    if (best != NO_FACE) atomicMin(zb + (long long)row * S + col, best);
}

// Frames frame0 .. frame0 + nf - 1. items[f*(n_tiles+1) + t] is tile t's first
// work item, items[f*(n_tiles+1) + n_tiles] frame f's item count. Blocks take
// items in order from one counter per frame (next_item, zeroed), starting on
// frame blockIdx.x % nf and moving on when it is drained. The PARTS column
// blocks of one slice are consecutive items.
__global__ void __launch_bounds__(THREADS)
table_walk_kernel(const float* __restrict__ geom, const int* __restrict__ ids,
                  const int* __restrict__ kept, const int* __restrict__ items, int F, int S,
                  int gx, int n_tiles, int k, int frame0, int nf,
                  unsigned long long* __restrict__ zbuf, unsigned* __restrict__ next_item) {
    __shared__ __align__(16) float rows[ITEM][ROW];
    __shared__ int s_item, s_tile;
    for (int kk = 0; kk < nf; ++kk) {
        const int lf = (blockIdx.x + kk) % nf, frame = frame0 + lf;
        const int* frame_items = items + (long long)frame * (n_tiles + 1);
        const int n_items = frame_items[n_tiles];
        for (;;) {
            if (threadIdx.x == 0) {
                const int item = (int)atomicAdd(&next_item[lf], 1u);
                int lo = 0, hi = n_tiles;  // the tile t with frame_items[t] <= item < frame_items[t + 1]
                while (item < n_items && hi - lo > 1) {
                    const int mid = (lo + hi) >> 1;
                    if (frame_items[mid] <= item) lo = mid; else hi = mid;
                }
                s_item = item;
                s_tile = lo;
            }
            __syncthreads();
            const int item = s_item, tile = s_tile;
            if (item >= n_items) break;  // uniform: every thread read the same item
            const int local = item - frame_items[tile];
            const long long ft = (long long)frame * n_tiles + tile;
            const int begin = (local / PARTS) * ITEM;
            walk_item(rows, geom + (long long)frame * F * ROW, ids + ft * k, tile, local % PARTS,
                      begin, min(ITEM, kept[ft] - begin), S, gx, zbuf + lf * (long long)S * S);
        }
        __syncthreads();  // s_item is rewritten for the next frame
    }
}

// One thread per pixel decodes the winner and recomputes its barycentrics
// into shared memory; then the block writes its pixels' contiguous run of
// flows (J pairs a pixel) with consecutive threads on consecutive addresses.
constexpr int EPI = 256;  // pixels per epilogue block; S*S is a multiple of it

__global__ void __launch_bounds__(EPI)
table_epilogue_kernel(const float* __restrict__ geom, const unsigned long long* __restrict__ zbuf,
                      const int* __restrict__ ids, const float* __restrict__ aux, int F, int S,
                      int J, int gx, int n_tiles, int k, int frame0, int* __restrict__ fim,
                      float* __restrict__ flows) {
    __shared__ int s_fid[EPI];
    __shared__ float s_w[EPI][3];
    const long long SS = (long long)S * S;
    const int frame = frame0 + blockIdx.y;
    const long long p0 = (long long)blockIdx.x * EPI, p = p0 + threadIdx.x;
    const unsigned long long key = zbuf[blockIdx.y * SS + p];
    int fid = -1;
    float w0 = 0.f, w1 = 0.f, w2 = 0.f;
    if (key != NO_FACE) {
        const int row = (int)(p / S), col = (int)(p - (long long)row * S);
        const int tile = (row / TILE_H) * gx + col / TILE_W;
        fid = ids[((long long)frame * n_tiles + tile) * k + (unsigned)(key & 0xffffffffull)];
        const float4* r = reinterpret_cast<const float4*>(geom + ((long long)frame * F + fid) * ROW);
        const float4 a = r[0], b = r[1], c = r[2];
        const float step = (float)(2.0 / (double)S);
        const float off = (float)((1.0 - (double)S) / (double)S);
        const float px = pixel_centre(col, step, off), py = pixel_centre(row, step, off);
        w0 = bary(a.x, a.y, a.z, px, py);
        w1 = bary(a.w, b.x, b.y, px, py);
        w2 = bary(b.z, b.w, c.x, px, py);
    }
    fim[frame * SS + p] = fid;
    s_fid[threadIdx.x] = fid;
    s_w[threadIdx.x][0] = w0; s_w[threadIdx.x][1] = w1; s_w[threadIdx.x][2] = w2;
    __syncthreads();
    float2* o = reinterpret_cast<float2*>(flows) + (frame * SS + p0) * J;
    for (int i = threadIdx.x; i < EPI * J; i += EPI) {
        const int q = i / J, j = i - q * J, f = s_fid[q];
        float2 v = make_float2(FLOW_SENTINEL, FLOW_SENTINEL);
        if (f >= 0) {
            const float2* a = reinterpret_cast<const float2*>(aux + ((long long)j * F + f) * 6);
            const float2 a0 = a[0], a1 = a[1], a2 = a[2];
            const float x0 = s_w[q][0], x1 = s_w[q][1], x2 = s_w[q][2];
            v = make_float2(blend3(x0, x1, x2, a0.x, a1.x, a2.x), blend3(x0, x1, x2, a0.y, a1.y, a2.y));
        }
        o[i] = v;
    }
}

}  // namespace

extern "C" {

// TILE_H, TILE_W, raster::E_CAP, ITEM, PARTS, ROW, for the Python side to check.
int raster_table_constants(int* out) {
    out[0] = TILE_H; out[1] = TILE_W; out[2] = raster::E_CAP; out[3] = ITEM; out[4] = PARTS;
    out[5] = ROW;
    return 0;
}

// The binning as csrc/raster_table_bin.cu writes it: geom (T, F, 16), ids
// (T, n_tiles, k), kept (T, n_tiles), items (T, n_tiles + 1); aux (J, F, 3, 2).
// zbuf: zb_frames * S * S u64 scratch followed by zb_frames u32 counters.
// fim: (T, S, S) int32; flows: (T, S, S, J, 2) f32; S a multiple of 128.
// Returns the first CUDA error.
int raster_flows_table_launch(const float* geom, const int* ids, const int* kept, const int* items,
                              const float* aux, int T, int F, int S, int J, int k,
                              unsigned long long* zbuf, int zb_frames, int* fim, float* flows,
                              void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    const int gx = S / TILE_W, n_tiles = gx * (S / TILE_H);
    const long long SS = (long long)S * S;
    unsigned* next_item = reinterpret_cast<unsigned*>(zbuf + zb_frames * SS);
    for (int f0 = 0; f0 < T; f0 += zb_frames) {
        const int nf = min(zb_frames, T - f0);
        cudaError_t err = cudaMemsetAsync(zbuf, 0xff, (size_t)nf * SS * sizeof(unsigned long long), stream);
        if (err == cudaSuccess) err = cudaMemsetAsync(next_item, 0, nf * sizeof(unsigned), stream);
        if (err != cudaSuccess) return (int)err;
        table_walk_kernel<<<WALK_BLOCKS_PER_SM * raster::sm_count(), THREADS, 0, stream>>>(
            geom, ids, kept, items, F, S, gx, n_tiles, k, f0, nf, zbuf, next_item);
        table_epilogue_kernel<<<dim3((unsigned)(SS / EPI), nf), EPI, 0, stream>>>(
            geom, zbuf, ids, aux, F, S, J, gx, n_tiles, k, f0, fim, flows);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

}  // extern "C"
