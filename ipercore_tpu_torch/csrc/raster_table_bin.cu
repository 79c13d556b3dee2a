// Device binning of the table raster (K4) for NVIDIA Hopper (sm_90a): each
// 8x128 tile's table of at most k faces, nearest first.
//
// Replaces `_bin_faces` of ipercore_tpu/ops/rasterizer_pallas.py, the binning
// of the Pallas TPU kernel _raster_flow_kernel (rasterize_flows_pallas), which
// is array code there (a stable argsort of the faces' minimum depth and a
// top_k over a dense (tile, face) overlap matrix). The table is part of the
// function: a tile keeps its min(true_count, k) faces of smallest key
// (minimum vertex depth, then face id), in that order; ops/rasterizer_cuda.py::
// bin_faces_table is the plain version, and this binning equals it bit for
// bit (ids, kept, true_counts). Five steps in one launch call, no host sync
// and no sort outside a block:
//   memset: the tile counts, the wide counts, the stats and two counters;
//   count:  one thread per (frame, face) writes the face's geometry row (as
//           csrc/raster_bin.cu does), its 32-bit depth key, and its inclusive
//           tile range (box padded by 1 px, the plain binning's f32 formula);
//           it adds one to the count of each tile of the range, or, when the
//           range holds more than E_CAP tiles, puts the face on its frame's
//           wide list;
//   scan:   one block per frame adds to each tile's count the wide faces
//           whose range holds the tile (the true count), turns the counts
//           into list segments and the kept counts into work-item starts,
//           and orders the tiles for the select, those of more than HEAVY
//           candidates first (the longest sorts then start first instead of
//           ending last: 53 -> 40 us on the main path's chunk, H100);
//   fill:   one thread per (frame, face) writes the face id into its tiles'
//           segments through per-tile atomic cursors (in no fixed order);
//   select: one block per (frame, tile) gathers the tile's candidates (its
//           list and the wide faces that hold it) as 64-bit keys
//           (depth key << 32 | face id) into shared memory, sorts them
//           (bitonic) and writes the first min(true_count, k) ids, then -1 up
//           to k. A tile with more than SORT_CAP candidates first finds its
//           k-th smallest key by a radix select over the list in device
//           memory, keeps the keys up to it and sorts those; only when k
//           itself exceeds SORT_CAP are ranks counted pairwise.
// The count and fill atomics on a tile are aggregated per warp. The depth key
// orders floats as `argsort` compares them: -0.0 is made +0.0 first, and
// the face id breaks ties, as the stable argsort does.
//
// Bound: the kernels read the faces once and write 64 B of geometry, a few
// entries per face and the (T, n_tiles, k) table; at 512^2, T = 8, k = 2048 the
// table's 16.8 MB (mostly its -1 padding) is the largest part, about 5 us at
// 3.35 TB/s. What a block cannot avoid is the sort of the longest lists
// (about 2500 candidates on the main path's densest tile).
#include "raster_table.cuh"

namespace {

using raster::E_CAP;
using raster::ROW;
using table::ITEM;
using table::PARTS;
using table::SORT_CAP;
using table::TILE_H;
using table::TILE_W;

constexpr int N_STATS = 3;  // max_tile_load, n_overflow_tiles, total_entries
constexpr int SCAN_THREADS = 1024;
constexpr int SELECT_THREADS = 512;
constexpr unsigned long long NO_KEY = ~0ull;
constexpr unsigned HEAVY = 512;  // candidates of a tile whose select starts first

// Inclusive range [t0, t1] of tiles of `tile` pixels, on a grid of g, that the
// extent [vmin, vmax] padded by 1 px touches: floor((to_px(v) -+ 1) / tile),
// clipped, with to_px(v) = (v + 1) * (S/2) - 0.5, each step rounded.
__device__ __forceinline__ int2 tile_range(float vmin, float vmax, int S, int tile, int g) {
    const float half = 0.5f * (float)S;
    const float lo = __fsub_rn(__fsub_rn(__fmul_rn(__fadd_rn(vmin, 1.0f), half), 0.5f), 1.0f);
    const float hi = __fadd_rn(__fsub_rn(__fmul_rn(__fadd_rn(vmax, 1.0f), half), 0.5f), 1.0f);
    const float top = (float)(g - 1);
    const float t0 = fminf(fmaxf(floorf(__fdiv_rn(lo, (float)tile)), 0.0f), top);
    const float t1 = fminf(fmaxf(floorf(__fdiv_rn(hi, (float)tile)), 0.0f), top);
    return make_int2((int)t0, (int)t1);
}

// An unsigned key that orders as the float z does, with -0.0 equal to +0.0
// (ops/rasterizer_cuda.py::table_depth_key is the same map).
__device__ __forceinline__ unsigned depth_key(float z) {
    unsigned u = __float_as_uint(z);
    if (u == 0x80000000u) u = 0u;
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// frange: (tx0, tx1, ty0, ty1) per face, tx0 = -1 when the face is invalid.
__global__ void __launch_bounds__(256)
table_count_kernel(const float* __restrict__ fv, int T, int F, int S, int gx, int gy,
                   float* __restrict__ geom, unsigned* __restrict__ zkey, int4* __restrict__ frange,
                   unsigned* __restrict__ counts, unsigned* __restrict__ wide_count,
                   int* __restrict__ wide_ids) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    unsigned span = 0;
    int4 range = make_int4(-1, -1, -1, -1);
    if (i < (long long)T * F) {
        const raster::FaceBox b = raster::face_row(fv + i * 9, geom + i * ROW);
        if (b.valid) {
            const int2 tx = tile_range(b.xmin, b.xmax, S, TILE_W, gx);
            const int2 ty = tile_range(b.ymin, b.ymax, S, TILE_H, gy);
            range = make_int4(tx.x, tx.y, ty.x, ty.y);
            span = (unsigned)((tx.y - tx.x + 1) * (ty.y - ty.x + 1));
            if (span > E_CAP) {
                const long long f = i / F;
                wide_ids[f * F + atomicAdd(&wide_count[f], 1u)] = (int)(i - f * F);
            }
        }
        zkey[i] = depth_key(b.zmin);
        frange[i] = range;
    }
    raster::for_each_listed_tile(i, F, gx, gx * gy, range, span,
                                 [&](long long tile, unsigned same, int leader) {
        if ((threadIdx.x & 31) == leader) atomicAdd(&counts[tile], (unsigned)__popc(same));
    });
}

__device__ __forceinline__ bool holds(int4 r, int tx, int ty) {
    return r.x <= tx && tx <= r.y && r.z <= ty && ty <= r.w;
}

// One block of SCAN_THREADS per frame; each thread owns a run of tiles.
__global__ void __launch_bounds__(SCAN_THREADS)
table_scan_kernel(const unsigned* __restrict__ counts, const unsigned* __restrict__ wide_count,
                  const int* __restrict__ wide_ids, const int4* __restrict__ frange, int F, int gx,
                  int n_tiles, int k, int* __restrict__ seg, int* __restrict__ cursor,
                  int* __restrict__ true_counts, int* __restrict__ kept, int* __restrict__ items,
                  unsigned* __restrict__ stats, unsigned* __restrict__ order_count,
                  int* __restrict__ order, int total_tiles) {
    __shared__ unsigned warp_a[32], warp_b[32];
    const int f = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const unsigned nw = wide_count[f];
    const int* wide = wide_ids + (long long)f * F;
    const int4* franges = frange + (long long)f * F;
    const long long tiles0 = (long long)f * n_tiles;
    const int per = (n_tiles + SCAN_THREADS - 1) / SCAN_THREADS;
    const int t0 = min(tid * per, n_tiles), t1 = min(t0 + per, n_tiles);
    unsigned a = 0, b = 0, load = 0, over = 0, total = 0;
    for (int t = t0; t < t1; ++t) {
        const unsigned n = counts[tiles0 + t];
        unsigned hits = 0;
        for (unsigned j = 0; j < nw; ++j) hits += holds(franges[wide[j]], t % gx, t / gx);
        const unsigned tc = n + hits, kp = min(tc, (unsigned)k);
        true_counts[tiles0 + t] = (int)tc;
        kept[tiles0 + t] = (int)kp;
        // the select's block order: tiles of more than HEAVY candidates first
        if (tc > HEAVY) order[atomicAdd(&order_count[0], 1u)] = (int)(tiles0 + t);
        else order[total_tiles - 1 - (int)atomicAdd(&order_count[1], 1u)] = (int)(tiles0 + t);
        a += n;
        b += PARTS * ((kp + ITEM - 1) / ITEM);
        load = max(load, tc);
        over += tc > (unsigned)k;
        total += tc;
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
        seg[tiles0 + t] = (int)(base + run_a);
        cursor[tiles0 + t] = (int)(base + run_a);
        frame_items[t] = (int)run_b;
        run_a += counts[tiles0 + t];
        run_b += PARTS * ((kept[tiles0 + t] + ITEM - 1) / ITEM);
    }
    if (tid == 0) frame_items[n_tiles] = (int)warp_b[31];
    const unsigned mx = __reduce_max_sync(0xffffffffu, load);
    const unsigned n_over = __reduce_add_sync(0xffffffffu, over);
    const unsigned sum = __reduce_add_sync(0xffffffffu, total);
    if (lane == 0) {
        if (mx) atomicMax(&stats[0], mx);
        if (n_over) atomicAdd(&stats[1], n_over);
        if (sum) atomicAdd(&stats[2], sum);
    }
}

__global__ void __launch_bounds__(256)
table_fill_kernel(const int4* __restrict__ frange, int T, int F, int gx, int n_tiles,
                  int* __restrict__ cursor, int* __restrict__ list_ids) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const int4 r = i < (long long)T * F ? frange[i] : make_int4(-1, -1, -1, -1);
    const unsigned span = r.x < 0 ? 0u : (unsigned)((r.y - r.x + 1) * (r.w - r.z + 1));
    const int face = (int)(i - (i / max(F, 1)) * F);
    const int lane = threadIdx.x & 31;
    raster::for_each_listed_tile(i, F, gx, n_tiles, r, span,
                                 [&](long long tile, unsigned same, int leader) {
        int base = 0;
        if (lane == leader) base = atomicAdd(&cursor[tile], __popc(same));
        base = __shfl_sync(same, base, leader);
        list_ids[base + __popc(same & ((1u << lane) - 1u))] = face;
    });
}

// Ascending bitonic sort of s[0, P), P a power of two; the caller has
// synchronised after filling s, and every thread of the block calls it.
__device__ void bitonic_sort(unsigned long long* s, int P) {
    for (int size = 2; size <= P; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int i = threadIdx.x; i < P / 2; i += blockDim.x) {
                const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
                const unsigned long long a = s[lo], b = s[hi];
                if ((a > b) == ((lo & size) == 0)) { s[lo] = b; s[hi] = a; }
            }
            __syncthreads();
        }
    }
}

__device__ __forceinline__ int pow2_at_least(int n) {
    int p = 1;
    while (p < n) p <<= 1;
    return p;
}

// One block per (frame, tile): the tile's table row ids[(f*n_tiles + t)*k, +k).
__global__ void __launch_bounds__(SELECT_THREADS)
table_select_kernel(const unsigned* __restrict__ zkey, const int4* __restrict__ frange,
                    const unsigned* __restrict__ counts, const int* __restrict__ seg,
                    const int* __restrict__ list_ids, const unsigned* __restrict__ wide_count,
                    const int* __restrict__ wide_ids, const int* __restrict__ true_counts,
                    const int* __restrict__ order, int F, int gx, int n_tiles, int k,
                    int* __restrict__ ids) {
    __shared__ unsigned long long keys[SORT_CAP];
    __shared__ unsigned hist[256];
    __shared__ unsigned s_n, s_digit, s_rank;
    const int tid = threadIdx.x;
    const long long ft = order[blockIdx.x];
    const int f = (int)(ft / n_tiles), t = (int)(ft - (long long)f * n_tiles);
    const int tx = t % gx, ty = t / gx;
    const int n_list = (int)counts[ft], nw = (int)wide_count[f];
    const int* list = list_ids + seg[ft];
    const int* wide = wide_ids + (long long)f * F;
    const unsigned* fkey = zkey + (long long)f * F;
    const int4* franges = frange + (long long)f * F;
    const int tc = true_counts[ft], kp = min(tc, k);
    int* out = ids + ft * k;
    // candidate c of [0, n_list + nw): its key, or false for a wide face that
    // does not hold the tile
    auto candidate = [&](int c, unsigned long long& key) {
        const int fid = c < n_list ? list[c] : wide[c - n_list];
        key = ((unsigned long long)fkey[fid] << 32) | (unsigned)fid;
        return c < n_list || holds(franges[fid], tx, ty);
    };
    const int n_cand = n_list + nw;

    int n_sorted = tc;  // keys to sort in shared memory
    if (tc > SORT_CAP) {
        // radix select, most significant byte first, of the kp-th smallest key
        unsigned long long prefix = 0, mask = 0;
        unsigned rank = (unsigned)kp - 1;
        for (int shift = 56; shift >= 0; shift -= 8) {
            for (int d = tid; d < 256; d += SELECT_THREADS) hist[d] = 0;
            __syncthreads();
            for (int c = tid; c < n_cand; c += SELECT_THREADS) {
                unsigned long long key;
                if (candidate(c, key) && (key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 255], 1u);
            }
            __syncthreads();
            if (tid == 0) {
                unsigned below = 0;
                int d = 0;
                while (below + hist[d] <= rank) below += hist[d++];
                s_digit = (unsigned)d;
                s_rank = rank - below;
            }
            __syncthreads();
            prefix |= (unsigned long long)s_digit << shift;
            mask |= 255ull << shift;
            rank = s_rank;
            __syncthreads();
        }
        if (kp > SORT_CAP) {
            // k > SORT_CAP: each kept candidate's rank by counting
            for (int c = tid; c < n_cand; c += SELECT_THREADS) {
                unsigned long long key, other;
                if (!candidate(c, key) || key > prefix) continue;
                int r = 0;
                for (int d = 0; d < n_cand; ++d) r += candidate(d, other) && other < key;
                out[r] = (int)(unsigned)key;
            }
            for (int i = kp + tid; i < k; i += SELECT_THREADS) out[i] = -1;
            return;
        }
        n_sorted = kp;  // the keys up to the kp-th
        if (tid == 0) s_n = 0;
        __syncthreads();
        for (int c = tid; c < n_cand; c += SELECT_THREADS) {
            unsigned long long key;
            if (candidate(c, key) && key <= prefix) keys[atomicAdd(&s_n, 1u)] = key;
        }
    } else {
        if (tid == 0) s_n = (unsigned)n_list;
        __syncthreads();
        for (int c = tid; c < n_list; c += SELECT_THREADS) candidate(c, keys[c]);
        for (int c = n_list + tid; c < n_cand; c += SELECT_THREADS) {
            unsigned long long key;
            if (candidate(c, key)) keys[atomicAdd(&s_n, 1u)] = key;
        }
    }
    const int P = pow2_at_least(n_sorted);
    for (int i = n_sorted + tid; i < P; i += SELECT_THREADS) keys[i] = NO_KEY;
    __syncthreads();
    bitonic_sort(keys, P);
    for (int i = tid; i < k; i += SELECT_THREADS) out[i] = i < kp ? (int)(unsigned)keys[i] : -1;
}

}  // namespace

extern "C" {

// TILE_H, TILE_W, E_CAP, ITEM, PARTS, ROW, for the Python side to check.
int raster_table_bin_constants(int* out) {
    out[0] = TILE_H; out[1] = TILE_W; out[2] = E_CAP; out[3] = ITEM; out[4] = PARTS; out[5] = ROW;
    return 0;
}

// face_verts: (T, F, 3, 3) f32, S a multiple of TILE_W, gx = S / TILE_W,
// gy = S / TILE_H, n_tiles = gx * gy. Writes geom (T, F, 16) f32 and, in
// int32: zkey, frange (T*F, 4), wide_ids (T, F); zeroed = counts (T*n_tiles)
// | wide_count (T) | stats (3) | order counters (2), set to zero here first;
// seg, cursor, true_counts, kept (T*n_tiles); items (T, n_tiles + 1);
// list_ids (T*F*E_CAP, then T*n_tiles for the select's tile order); ids
// (T, n_tiles, k). Returns the first CUDA error.
int raster_table_bin_launch(const float* face_verts, int T, int F, int S, int k, float* geom,
                            int* zkey, int* frange, int* wide_ids, int* zeroed, int* seg,
                            int* cursor, int* true_counts, int* kept, int* items, int* list_ids,
                            int* ids, void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    if (T <= 0) return 0;
    const int gx = S / TILE_W, gy = S / TILE_H, n_tiles = gx * gy;
    unsigned* counts = reinterpret_cast<unsigned*>(zeroed);
    unsigned* wide_count = counts + (long long)T * n_tiles;
    unsigned* stats = wide_count + T;
    unsigned* order_count = stats + N_STATS;
    int* order = list_ids + (long long)T * F * E_CAP;
    cudaError_t err = cudaMemsetAsync(zeroed, 0, ((size_t)T * n_tiles + T + N_STATS + 2) * 4, stream);
    if (err != cudaSuccess) return (int)err;
    const long long faces = (long long)T * F;
    const unsigned blocks = (unsigned)((faces + 255) / 256);
    if (faces > 0)
        table_count_kernel<<<blocks, 256, 0, stream>>>(
            face_verts, T, F, S, gx, gy, geom, reinterpret_cast<unsigned*>(zkey),
            reinterpret_cast<int4*>(frange), counts, wide_count, wide_ids);
    table_scan_kernel<<<T, SCAN_THREADS, 0, stream>>>(
        counts, wide_count, wide_ids, reinterpret_cast<const int4*>(frange), F, gx, n_tiles, k, seg,
        cursor, true_counts, kept, items, stats, order_count, order, T * n_tiles);
    if (faces > 0)
        table_fill_kernel<<<blocks, 256, 0, stream>>>(
            reinterpret_cast<const int4*>(frange), T, F, gx, n_tiles, cursor, list_ids);
    table_select_kernel<<<(unsigned)((long long)T * n_tiles), SELECT_THREADS, 0, stream>>>(
        reinterpret_cast<const unsigned*>(zkey), reinterpret_cast<const int4*>(frange), counts, seg,
        list_ids, wide_count, wide_ids, true_counts, order, F, gx, n_tiles, k, ids);
    return (int)cudaGetLastError();
}

}  // extern "C"
