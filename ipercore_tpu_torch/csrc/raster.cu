// Tile-binned z-buffer rasterizer for NVIDIA Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of ipercore_tpu/ops/rasterizer_pallas.py:
//   raster_flows_launch -> _raster_flow_kernel_csr (rasterize_flows_pallas_csr):
//       per frame and pixel the nearest face, its global id and the
//       barycentric blend of J per-vertex 2-D coordinate sets;
//   raster_fim_launch   -> _raster_kernel (rasterize_pallas): the same z-buffer,
//       emitting the winner's barycentric weights instead of flows.
// Both read the device binning of csrc/raster_bin.cu: per 16x16 tile a list
// of face ids in no fixed order, plus the frame's wide list (faces whose
// padded box spans more than E_CAP tiles), which every tile of the frame
// also walks.
//
// Bound. Bytes: the faces and aux are read once and every output pixel is
// written once (4 + 8J bytes); at 512^2, J = 3, 8 frames that is about 63 MB,
// 0.019 ms on an H100. Operations the function needs: about 30 f32 operations
// per (pixel, face whose guarded box covers it), a few microseconds. What held
// an earlier one-block-per-tile walk back was neither: every one of a tile's
// 256 threads box-tested every face of the tile's list, and the longest lists
// (about 1400 faces at 512^2, against a mean of 34 and a p99 of about 300)
// set the kernel's time. What bounds this walk is the instructions of the
// exact per-pixel tests on faces that pass the warp's box test.
//
// Design.
//   walk:     the work is split by entries: a work item is (tile, slice of at
//             most ITEM entries of its list + wide list); the binning's scan
//             gives each frame's item starts, and the blocks (8 per SM) take
//             items in order from one counter per frame, so no block waits on
//             a long list while others idle, and the item count is read on
//             the device. A block gathers its item's geometry rows into shared
//             memory with cp.async; eight resident blocks per SM hide one
//             another's gathers (on an H100, items of 64 entries in one buffer
//             beat items of 128 in two buffers whose gathers overlapped the
//             tests; PERF.md has the times). Each warp owns an 8x4 pixel block
//             of the tile: one lane per staged face tests the face's guarded
//             box against the block's extent and __ballot_sync keeps the hits,
//             so a pixel runs the exact tests only for faces near it. Each thread keeps
//             its pixel's best key (f32 bits of depth << 32 | face id) in
//             registers and merges it with one 64-bit atomicMin into a
//             z-buffer. Depth lies in (NEAR, FAR), so it is positive and its
//             bits order as unsigned integers: the smallest key is the
//             present rule, smallest depth and on equal depth the lowest face
//             id, whatever order the lists are in.
//   epilogue: one thread per pixel decodes the winner and recomputes its
//             three barycentrics from the winner's row with the same
//             intrinsics (so they are bit-equal to those of the walk) and
//             writes fim; then the block writes its pixels' flows (K1, aux
//             shared or per frame) or wim (K3) as one contiguous run, each
//             thread one flow pair or one float, so that every sector is
//             written whole (a pixel's 8J bytes at a stride of 8J, written
//             pixel by pixel, left the stores half as fast).
// Frames pass through the z-buffer a few at a time (the caller sizes it: 8
// frames from ops/rasterizer_cuda.py), so a long temporal sequence needs no
// z-buffer of its own length.
//
// Arithmetic order is the plain PyTorch version's (ops/rasterizer.py):
//   w = fma(b, py, a*px) + c;  depth = (w0*z0 + w1*z1) + w2*z2;
//   flow = (w0*p0 + w1*p1) + w2*p2.
#include "raster_common.cuh"

namespace {

using namespace raster;

constexpr int THREADS = TILE * TILE;  // one thread per pixel of a tile
static_assert(ITEM * 4 == THREADS, "four threads gather each of an item's rows");
constexpr int WALK_BLOCKS_PER_SM = 8;
constexpr unsigned long long NO_FACE = ~0ull;

// The pixels a warp owns: WARP_H rows x WARP_W columns of the tile, so that
// its box test against a face culls as much as a warp can (taller than wide:
// it cuts the warp-face hits of the main path's faces by about 30 % against
// two full rows).
constexpr int WARP_H = 8, WARP_W = 4;

// One work item: the block walks entries [begin, begin + n) of tile `tile`'s
// list followed by its frame's wide list (n <= ITEM), and merges each pixel's
// best key into the z-buffer.
__device__ __forceinline__ void walk_item(
        float (*rows)[ROW], int* row_fid, const float* __restrict__ fgeom,
        const int* __restrict__ list, int listed, const int* __restrict__ wide, int tile, int begin,
        int n, int S, int g, unsigned long long* __restrict__ zb) {
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const float eps = (float)(2.0 / (double)S);
    const int tile_x = tile % g, tile_y = tile / g;
    const int c0 = tile_x * TILE + (warp % (TILE / WARP_W)) * WARP_W;
    const int r0 = tile_y * TILE + (warp / (TILE / WARP_W)) * WARP_H;
    const int col = c0 + lane % WARP_W, row = r0 + lane / WARP_W;
    const float px = pixel_centre(col, S), py = pixel_centre(row, S);
    // the warp's pixel-centre extent, inside S
    const bool warp_live = c0 < S && r0 < S;
    const float sx0 = pixel_centre(c0, S), sx1 = pixel_centre(min(c0 + WARP_W - 1, S - 1), S);
    const float sy0 = pixel_centre(r0, S), sy1 = pixel_centre(min(r0 + WARP_H - 1, S - 1), S);

    {  // gather the item's rows by face id: ITEM rows x 4 pieces of 16 bytes
        const int e = tid >> 2, q = tid & 3;
        if (e < n) {
            const int li = begin + e;
            const int fid = li < listed ? list[li] : wide[li - listed];
            cp_async16(&rows[e][q * 4], fgeom + (long long)fid * ROW + q * 4);
            if (q == 0) row_fid[e] = fid;
        }
        cp_async_commit();
        cp_async_wait_all();
    }
    __syncthreads();

    unsigned long long best = NO_FACE;
    for (int k = 0; k < n; k += 32) {
        bool hit = false;
        if (warp_live && k + lane < n) {
            const float4 b = *reinterpret_cast<const float4*>(&rows[k + lane][12]);
            hit = sx1 >= __fsub_rn(b.x, eps) && sx0 <= __fadd_rn(b.y, eps)
               && sy1 >= __fsub_rn(b.z, eps) && sy0 <= __fadd_rn(b.w, eps);
        }
        for (unsigned mask = __ballot_sync(0xffffffffu, hit); mask; mask &= mask - 1) {
            const int e = k + __ffs(mask) - 1;
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
                ((unsigned long long)__float_as_uint(depth) << 32) | (unsigned)row_fid[e];
            best = key < best ? key : best;
        }
    }
    if (col < S && row < S && best != NO_FACE) atomicMin(zb + (long long)row * S + col, best);
}

// Frames frame0 .. frame0 + nf - 1. items[f*(n_tiles+1) + t] is tile t's first
// work item, items[f*(n_tiles+1) + n_tiles] frame f's item count. Blocks take
// items in order from one counter per frame (next_item, zeroed), starting on
// frame blockIdx.x % nf and moving on when it is drained.
__global__ void __launch_bounds__(THREADS)
raster_walk_kernel(const float* __restrict__ geom, const int* __restrict__ counts,
                   const int* __restrict__ seg, const int* __restrict__ items,
                   const int* __restrict__ ids, const int* __restrict__ wide_ids,
                   const int* __restrict__ wide_count, int F, int S, int g, int frame0, int nf,
                   unsigned long long* __restrict__ zbuf, unsigned* __restrict__ next_item) {
    __shared__ __align__(16) float rows[ITEM][ROW];
    __shared__ int row_fid[ITEM];
    __shared__ int s_item, s_tile;
    const int n_tiles = g * g;
    for (int k = 0; k < nf; ++k) {
        const int lf = (blockIdx.x + k) % nf, frame = frame0 + lf;
        const int* frame_items = items + (long long)frame * (n_tiles + 1);
        const int n_items = frame_items[n_tiles];
        const int* frame_counts = counts + (long long)frame * n_tiles;
        const int n_wide = wide_count[frame];
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
            const int listed = frame_counts[tile];
            const int begin = (item - frame_items[tile]) * ITEM;
            walk_item(rows, row_fid, geom + (long long)frame * F * ROW,
                      ids + seg[(long long)frame * n_tiles + tile], listed,
                      wide_ids + (long long)frame * F, tile, begin,
                      min(ITEM, listed + n_wide - begin), S, g, zbuf + lf * (long long)S * S);
        }
        __syncthreads();  // s_item is rewritten for the next frame
    }
}

// One thread per pixel decodes the winner and recomputes its barycentrics
// into shared memory; then the block writes its pixels' contiguous run of
// flows (J pairs a pixel) or wim (3 floats a pixel) with consecutive threads
// on consecutive addresses, so every output sector is written whole.
constexpr int EPI = 256;  // pixels per epilogue block

template <bool WIM>
__global__ void __launch_bounds__(EPI)
raster_epilogue_kernel(const float* __restrict__ geom, const unsigned long long* __restrict__ zbuf,
                       const float* __restrict__ aux, long long aux_frame_stride, int F, int S,
                       int J, int frame0, int* __restrict__ fim, float* __restrict__ out) {
    __shared__ int s_fid[EPI];
    __shared__ float s_w[EPI][3];
    const int SS = S * S;
    const int frame = frame0 + blockIdx.y;
    const int p0 = blockIdx.x * EPI, n_px = min(EPI, SS - p0);
    const int p = p0 + threadIdx.x;
    if (threadIdx.x < n_px) {
        const unsigned long long key = zbuf[blockIdx.y * (long long)SS + p];
        const int fid = key == NO_FACE ? -1 : (int)(unsigned)(key & 0xffffffffull);
        float w0 = 0.f, w1 = 0.f, w2 = 0.f;  // zeros on background
        if (fid >= 0) {
            const float4* r = reinterpret_cast<const float4*>(geom + ((long long)frame * F + fid) * ROW);
            const float4 a = r[0], b = r[1], c = r[2];
            const int row = p / S;
            const float px = pixel_centre(p - row * S, S), py = pixel_centre(row, S);
            w0 = bary(a.x, a.y, a.z, px, py);
            w1 = bary(a.w, b.x, b.y, px, py);
            w2 = bary(b.z, b.w, c.x, px, py);
        }
        fim[(long long)frame * SS + p] = fid;
        s_fid[threadIdx.x] = fid;
        s_w[threadIdx.x][0] = w0; s_w[threadIdx.x][1] = w1; s_w[threadIdx.x][2] = w2;
    }
    __syncthreads();
    const long long first = (long long)frame * SS + p0;  // the block's first pixel
    if (WIM) {
        float* o = out + first * 3;
        for (int i = threadIdx.x; i < n_px * 3; i += EPI) o[i] = s_w[i / 3][i % 3];
        return;
    }
    float2* o = reinterpret_cast<float2*>(out) + first * J;
    const float* faux = aux + frame * aux_frame_stride;
    for (int i = threadIdx.x; i < n_px * J; i += EPI) {
        const int q = i / J, j = i - q * J, fid = s_fid[q];
        float2 v = make_float2(FLOW_SENTINEL, FLOW_SENTINEL);
        if (fid >= 0) {
            const float2* a = reinterpret_cast<const float2*>(faux + ((long long)j * F + fid) * 6);
            const float2 a0 = a[0], a1 = a[1], a2 = a[2];
            const float w0 = s_w[q][0], w1 = s_w[q][1], w2 = s_w[q][2];
            v = make_float2(blend3(w0, w1, w2, a0.x, a1.x, a2.x), blend3(w0, w1, w2, a0.y, a1.y, a2.y));
        }
        o[i] = v;
    }
}

// zbuf holds zb_frames frames of S*S keys and then zb_frames counters;
// frames pass through it zb_frames at a time.
template <bool WIM>
int launch(const float* geom, const int* counts, const int* seg, const int* items, const int* ids,
           const int* wide_ids, const int* wide_count, const float* aux,
           long long aux_frame_stride, int T, int F, int S, int J,
           unsigned long long* zbuf, int zb_frames, int* fim, float* out, cudaStream_t stream) {
    const int g = (S + TILE - 1) / TILE;
    const long long SS = (long long)S * S;
    unsigned* next_item = reinterpret_cast<unsigned*>(zbuf + zb_frames * SS);
    for (int f0 = 0; f0 < T; f0 += zb_frames) {
        const int nf = min(zb_frames, T - f0);
        cudaError_t err = cudaMemsetAsync(zbuf, 0xff, (size_t)nf * SS * sizeof(unsigned long long), stream);
        if (err == cudaSuccess) err = cudaMemsetAsync(next_item, 0, nf * sizeof(unsigned), stream);
        if (err != cudaSuccess) return (int)err;
        raster_walk_kernel<<<WALK_BLOCKS_PER_SM * sm_count(), THREADS, 0, stream>>>(
            geom, counts, seg, items, ids, wide_ids, wide_count, F, S, g, f0, nf, zbuf, next_item);
        const dim3 epilogue_grid((unsigned)((SS + EPI - 1) / EPI), nf);
        raster_epilogue_kernel<WIM><<<epilogue_grid, EPI, 0, stream>>>(
            geom, zbuf, aux, aux_frame_stride, F, S, J, f0, fim, out);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

}  // namespace

extern "C" {

// TILE, E_CAP, ITEM, ROW, N_STATS, for the Python side to check.
int raster_constants(int* out) {
    out[0] = raster::TILE; out[1] = raster::E_CAP; out[2] = raster::ITEM; out[3] = raster::ROW;
    out[4] = raster::N_STATS;
    return 0;
}

// The binning's buffers as csrc/raster_bin.cu writes them; zbuf: zb_frames * S * S
// u64 scratch. fim: (T, S, S) int32; flows: (T, S, S, J, 2) f32; aux: (J, F, 3, 2),
// or (T, J, F, 3, 2) with aux_frame_stride = J*F*6. Returns the first CUDA error.
int raster_flows_launch(const float* geom, const int* counts, const int* seg, const int* items,
                        const int* ids, const int* wide_ids, const int* wide_count,
                        const float* aux, long long aux_frame_stride, int T, int F, int S, int J,
                        unsigned long long* zbuf, int zb_frames, int* fim, float* flows,
                        void* stream) {
    return launch<false>(geom, counts, seg, items, ids, wide_ids, wide_count, aux, aux_frame_stride,
                         T, F, S, J, zbuf, zb_frames, fim, flows, (cudaStream_t)stream);
}

// fim: (T, S, S) int32; wim: (T, S, S, 3) f32. Returns the first CUDA error.
int raster_fim_launch(const float* geom, const int* counts, const int* seg, const int* items,
                      const int* ids, const int* wide_ids, const int* wide_count, int T, int F,
                      int S, unsigned long long* zbuf, int zb_frames, int* fim, float* wim,
                      void* stream) {
    return launch<true>(geom, counts, seg, items, ids, wide_ids, wide_count, nullptr, 0, T, F, S, 0,
                        zbuf, zb_frames, fim, wim, (cudaStream_t)stream);
}

}  // extern "C"
