// The long-CPI decision shared by the two slow-time kernels, slowtime_
// detect.cu (float32 maps) and slowtime_detect_fixed.cu (int32 maps held
// in float, fmcw::IntInFloat): at n_doppler ND = n2d x 128 (2 <= n2d <= 16,
// the long-CPI Doppler split of the TPU kernels) a tile of whole rows no
// longer fits a block (at ND = 2048 one row is 8 KB of magnitudes), and
// at the dense lengths (dense_cpi: 8, 24 .. 2040, the TPU kernels' dense
// operator; kernel B also every length off a multiple of 8 below 2048) the
// kernels take the same plan, so each entry runs two
// launches: its own magnitude kernel writes the map, then
// the decide kernel here (slowtime_decide_kernel) reads it in tiles of T
// rows x a chunk of W columns, with H halo rows and HC halo columns that
// wrap on both axes (or, in the split entries, the rows of the shard's
// halo-extended slab), and runs the short tiles' cfar_tile.cuh /
// cfar_common.cuh decision on them: the decisions are the plain twin's bit
// for bit on the same magnitudes; a chunk W that does not divide ND
// (kernel B's maps off a multiple of 8) leaves a ragged last chunk, whose
// columns past ND are decided on the wrapped map and not stored
// (cfar_common.cuh's group_store_chunk).  Row maxima combine across chunks
// by atomicMax (float maps: on the float bits; det is never negative or
// NaN).
#pragma once

#include <cuda_runtime.h>

#include "cfar_common.cuh"
#include "cfar_tile.cuh"
#include "slowtime_common.cuh"

namespace fmcw {

constexpr int kDecideThreads = 256;     // the decide kernel's block
constexpr int kInner = 128;             // a long row's inner transform
constexpr int kMaxSplit = 16;           // n2d, as JAX's split
constexpr int kDenseAlign = 8;          // a dense length's multiple
constexpr int kMaxDense = 2048;         // and its ceiling

// ND = n2d x 128, 2 <= n2d <= 16: the long-CPI split.
inline bool long_cpi(int nd) {
    return nd > kInner && nd % kInner == 0 && nd / kInner <= kMaxSplit;
}

// The dense lengths of kernel B (its dense operator, JAX's n2d == 1 branch
// at any n_doppler): a multiple of 8 below 2048 that is neither a short
// row (16, 32, 64, 128) nor a long CPI, ND = o x m with m = ND & -ND in
// 8 .. 64 and o odd (1 .. 255).  8 | ND keeps every row of float32 16-byte
// aligned.  JAX's folded matrices take 16 ND^2 bytes of VMEM, its whole
// limit at 2048, so it runs no dense length there or above.
inline bool dense_cpi(int nd) {
    return nd >= kDenseAlign && nd < kMaxDense && nd % kDenseAlign == 0 &&
           nd % kInner != 0 && nd != 16 && nd != 32 && nd != 64;
}

// The decision tile of a long-CPI map: T + 2H rows of W + 2HC columns, laid
// out as a short map's tile of that width (TileLayout), one count.
__host__ __device__ inline TileLayout chunk_layout(const SlowtimeConfig& c) {
    SlowtimeConfig t = c;
    t.ND = c.W + 2 * c.HC;
    return tile_layout(t, 1);
}

// The decide kernel's column chunks of a map: ceil(ND / W), the last one
// ragged where W does not divide ND.
__host__ __device__ inline int n_chunks(const SlowtimeConfig& c) {
    return (c.ND + c.W - 1) / c.W;
}

// The decide kernel's tile of a map of ND columns (any ND a map kernel
// writes: the long CPIs and the dense lengths, and kernel B's lengths off a
// multiple of 8).  ragged (kernel B's float maps): W need not divide ND,
// the last chunk's columns past ND are decided but not stored.
inline bool decide_config_ok(const SlowtimeConfig& c, bool ragged = false) {
    const int E = c.T + 2 * c.H, WC = c.W + 2 * c.HC;
    const int rows = c.T + 2 * c.pgr;
    if (c.ND < 1 || c.batch < 1 || c.batch > 65535 || c.T < 1 ||
        c.R % c.T || c.W < 1 || c.W > c.ND || (!ragged && c.ND % c.W) ||
        c.pgr < 0 ||
        c.hr + c.pgr > c.H || c.hd + c.pgr > c.HC || c.hd >= c.ND ||
        c.pgr >= c.ND || c.row_off < 0 || c.r_total < c.R + c.row_off ||
        rows < kStrip || c.variant < 0 || c.variant > kSO ||
        (c.variant == 0 && c.n_ref > kMaxPackedRef<float>) ||
        (c.notch_mode != 2 && c.notch_mode != 3))
        return false;
    if (c.block_mode &&
        (c.sb < 1 || c.T % c.sb || c.H % c.sb || c.W % c.sb ||
         c.HC % c.sb || c.ND % c.sb || c.H < 2 * c.sb + c.pgr ||
         c.HC < 2 * c.sb + c.pgr || (E / c.sb) * (WC / c.sb) > kMaxBlk))
        return false;
    return (long long)(c.R / c.T) * n_chunks(c) <= 0x7fffffffLL &&
           (strip_units(rows, c.W + 2 * c.pgr) + kDecideThreads - 1) /
                   kDecideThreads * kStrip <= 64 &&
           (size_t)chunk_layout(c).total * sizeof(float) <= (size_t)kMaxSmem;
}

// The split entries decide with the per-cell scale only, on exactly the
// exchanged halo rows.
inline bool split_decide_ok(const SlowtimeConfig& c) {
    return !c.block_mode && c.H == c.hr + c.pgr;
}

// A map value in the tile: float maps as they are, int32 maps (at most
// 45,056, the fixed chain's largest magnitude) converted exactly.
__device__ __forceinline__ float tile_value(float v) { return v; }
__device__ __forceinline__ float tile_value(int v) { return __int2float_rn(v); }

// A chunk's row maximum (the float bits of a non-negative tile value) into
// the row's output: float bits for a float map, the integer for an int32
// one.
__device__ __forceinline__ void combine_max(float* row_max, int bits) {
    atomicMax(reinterpret_cast<int*>(row_max), bits);
}
__device__ __forceinline__ void combine_max(int* row_max, int bits) {
    atomicMax(row_max, (int)__int_as_float(bits));
}

// The decide kernel's operands: the map M (B, R, ND), or with kHalo the
// split entry's slab (B, R + 2H, ND); det (B, R, ND) and row_max (B, R)
// of the output type O (row_max zeroed by the caller); n_dets (B,).
template <typename M, typename O>
struct DecideArgs {
    const M* map;
    O* det;
    O* row_max;
    int* n_dets;
    SlowtimeConfig c;
};

// The decision of a long-CPI map: one block of kDecideThreads per (frame,
// tile of T rows x chunk of W columns) loads the magnitudes of its T + 2H
// rows (wrapped modulo R, or the slab's) and W + 2HC columns (wrapped
// modulo ND) into a float tile (Sem: MapSem<float>, or IntInFloat for an
// int32 map), so that the windows, block-scale neighbourhoods and grouping
// radius of its cells lie in the tile with no column wrap; decides the T +
// 2 pgr rows and W + 2 pgr columns the grouping reads, with the short
// kernels' calls on a map of WC columns; groups and stores its T x W cells
// (group_store_chunk) and adds its row maxima (combine_max) and detection
// count.
template <typename M, typename Sem, typename O, bool kHalo, bool kMean>
__global__ void __launch_bounds__(kDecideThreads, 2)
slowtime_decide_kernel(const DecideArgs<M, O> p) {
    using A = typename Sem::Acc;
    extern __shared__ float dsm[];
    const SlowtimeConfig& c = p.c;
    const int ND = c.ND, WC = c.W + 2 * c.HC;
    const int E = c.T + 2 * c.H;
    const int rows = c.T + 2 * c.pgr;
    const TileLayout lay = chunk_layout(c);
    float* mag_s = dsm;
    float* det_s = dsm + lay.det;
    float* cs_guard = dsm + lay.cs_guard;
    A* bsum = reinterpret_cast<A*>(dsm + lay.blk);
    A* bnb = bsum + kMaxBlk;
    int* bhi = reinterpret_cast<int*>(bnb + kMaxBlk);
    int* blo = bhi + kMaxBlk;
    int* bscale = blo + kMaxBlk;
    int* rmax_s = reinterpret_cast<int*>(dsm + lay.rmax);
    int* counts = reinterpret_cast<int*>(dsm + lay.counts);
    const int tid = threadIdx.x;
    const int b = blockIdx.y;
    const int chunks = n_chunks(c);
    const int r0 = (int)(blockIdx.x / chunks) * c.T;
    const int c0 = (int)(blockIdx.x % chunks) * c.W;

    for (int i = tid; i < c.T; i += kDecideThreads) rmax_s[i] = 0;
    if (tid == 0) counts[0] = 0;

    // ---- 1. The tile's magnitudes.
    const int map_rows = kHalo ? c.R + 2 * c.H : c.R;
    const M* map = p.map + (size_t)b * map_rows * ND;
    for (int i = tid; i < E * WC; i += kDecideThreads) {
        const int e = i / WC, j = i - e * WC;
        const int g = kHalo ? r0 + e : wrap_mod(r0 - c.H + e, c.R);
        mag_s[i] = tile_value(map[(size_t)g * ND + wrap_mod(c0 - c.HC + j, ND)]);
    }
    __syncthreads();

    // ---- 2. The scale's statistics and the decision, as the short
    //         kernels', of decided rows H-pgr .. and tile columns HC-pgr ..
    const CfarGeom g{c.hr, c.hd, c.gr, c.gd, c.n_ref, c.k,
                     c.scale_min, c.scale_nom, c.scale_max};
    const int e_first = c.H - c.pgr;
    const int* scale_blk = nullptr;
    if (c.block_mode) {
        if (c.so == 0) {
            block_scale_tile<float, Sem>(mag_s, E, WC, c.sb, c.n_blk,
                                         c.k_blk, g, bsum, bnb, bhi, blo,
                                         bscale);
            scale_blk = bscale;
        }
    } else if (!kMean && c.so == 0) {
        tile_colsums(mag_s, WC, e_first, rows, g, det_s, cs_guard);
        __syncthreads();
    }
    if constexpr (kMean) {
        if (mean_needs_sums(c.variant, c.block_mode, c.so)) {
            tile_colsums<float, false>(mag_s, WC, e_first, rows, g, det_s,
                                       nullptr);
            __syncthreads();
        }
    }
    decide_tile<float, Sem, kMean>(mag_s, det_s, e_first, rows, WC, det_s,
                                   cs_guard, scale_blk, c.sb, c.so, g,
                                   c.variant, c.HC - c.pgr, c.W + 2 * c.pgr);

    // ---- 3. Grouping, stores, row maxima and the count.
    group_store_chunk(det_s, WC, c.HC - c.pgr, c.T, c.W, c.pgr, c.r_total,
                      ND, c.row_off + r0, c0,
                      p.det + ((size_t)b * c.R + r0) * ND, rmax_s, counts);
    __syncthreads();
    O* row_max = p.row_max + (size_t)b * c.R + r0;
    for (int t = tid; t < c.T; t += kDecideThreads)
        if (rmax_s[t]) combine_max(row_max + t, rmax_s[t]);
    if (tid == 0 && counts[0]) atomicAdd(&p.n_dets[b], counts[0]);
}

// Launch the decide kernel of the CFAR variant (0: OS by counting, else the
// CA/GO/SO window means).  Returns the CUDA error code.
template <typename M, typename Sem, typename O, bool kHalo>
int launch_decide(const DecideArgs<M, O>& p, cudaStream_t stream) {
    static bool ready[2][kMaxDevices] = {};
    const bool mean = p.c.variant != 0;
    auto* kernel = mean ? slowtime_decide_kernel<M, Sem, O, kHalo, true>
                        : slowtime_decide_kernel<M, Sem, O, kHalo, false>;
    const cudaError_t err = prepare(kernel, ready[mean]);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = (size_t)chunk_layout(p.c).total * sizeof(float);
    const dim3 grid((p.c.R / p.c.T) * n_chunks(p.c), p.c.batch);
    kernel<<<grid, kDecideThreads, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

}  // namespace fmcw
