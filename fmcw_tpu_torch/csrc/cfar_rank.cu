// 2D OS-CFAR with its debug taps (threshold and scale maps) by bit-serial
// radix rank selection, on Hopper, for int32 or float32 magnitude maps, with
// an optional peak-grouping epilogue.
//
// Replaces fmcw_tpu/ops/cfar_pallas.py::_kernel (called through
// cfar_2d_pallas): the k-th largest training value est (k = n_ref -
// rank_idx) is found without sorting by walking the key bits MSB -> LSB,
// keeping a prefix P and setting a bit where count(keys >= P | bit) >= k.
// Keys are the int32 values of integer maps, or the IEEE bit patterns of
// float maps as int32 (monotonic for non-negative floats; NaN, Inf and -0.0
// rank as their patterns do).  Float keys are walked from bit 30 down for
// ``bits`` bits, integer keys from bit bits - 1 down (JAX's rank_bits /
// int_bits); with fewer than 31 float bits est is the order statistic with
// its low key bits cleared (rank_bits=16: under it by < 0.8%), as on the
// TPU.  Then, as os_cfar_2d.vhd:187-220 (the dbg_threshold / dbg_scale
// ports):
//   scale:     est > 1.5 mean -> scale_max, est < 0.5 mean -> scale_min,
//              else scale_nom (integer: mean + (mean >> 1), mean >> 1), the
//              mean from the full-minus-guard box sums of cfar_common.cuh;
//              or, block_mode, a scale map computed outside; scale_override
//              folded in;
//   threshold: est * scale;   det: the CUT where CUT > threshold, else 0.
//
// In:  map (B, R, D) int32 or float32 — or, prepadded, (B, R + 2 hr, D): a
//      range shard with its neighbours' halo_range rows on each side (the
//      sharded CFAR tail, cfar_2d_pallas(prepadded_range=True)); the range
//      axis then does not wrap.  scale_in int32 (B, R, D) when block_mode.
// Out: det and threshold (B, R, D) in the map's type, scale int32.  The
//      grouping entry (pgr >= 0, not prepadded) stores det peak-grouped
//      over a (2 pgr + 1)^2 wrapped neighbourhood (ops/cfar.peak_group, by
//      fmcw::group_store), and row_max (B, R) in the map's type and n_dets
//      (B,) int32 (zeroed by the caller) for DET.topk_detections.
//
// Design: bit-sliced key planes counted with population counts.  Every
// comparison keys >= cand of the walk is decided by the walked bits alone
// once a key is clamped to [0, top mask] (every candidate has a walked bit
// set and zeros below the last: a negative key is under all of them, a key
// above the top mask over all of them), so the clamped keys are cut into
// one bit plane per walked bit.  One block per (frame, tile of T rows)
// loads the T + 2 (hr + pgr) rows its windows reach into shared memory,
// then builds each plane with __ballot_sync over 32 consecutive columns of
// a row, the Doppler wrap replicated (extended column x holds column x - hd
// mod D), stored as word pairs (x: words j, j + 1) so that the 2 hd + 1
// columns of a window row at column d are one funnel shift of one 8-byte
// load (pair d / 32, shift d % 32), the same for the 32 cells of a warp (a
// broadcast).  A cell's walk keeps, per window row, the mask of keys still
// equal to the prefix (the guard columns of the guard rows never in it)
// and the count G of keys already above it:
//   count(keys >= P | bit) = G + sum over rows of popc(mask & field),
// then mask &= field (bit taken) or mask &= ~field, G = count (not taken).
// A thread walks a strip of 4 cells of one column together, so each bit's
// 4 + 2 hr row fields are loaded and shifted once for the 4 cells; windows
// of at most 16 columns pack two rows' fields (one PRMT) and masks into the
// 16-bit halves of a word, one population count for two rows.  Per cell
// and bit on the repository's window: 7 POPC and ~4 integer ops per row
// pair, where the previous design compared all n_ref = 128 keys (a scratch
// A/B against keys held in registers and counted in float, 4 lanes a cell:
// 5.5-6.3x slower; PERF.md, Findings).  Windows over 16 columns, or of
// other heights than 13 and 7 rows, walk one cell a thread, a row at a
// time.  The per-cell scale's box sums come from column sums computed once
// per tile (rows ascending, cfar_tile.cuh's order).
//
// The reflect entry (reflect = 1, CfarParams.edge_mode="reflect") is
// _kernel on the map that JAX's wrapper pads with numpy's "reflect"
// (cfar_pallas.py:378, :382): the edge cell not repeated, row -1 reads row
// 1 and row R reads row R - 2, likewise the columns.  Only the tile's load
// changes: tile row e holds map row reflect(r0 - hr + e) (a prepadded
// shard's row r0 + e, its range halo mirrored by the halo exchange), the
// bit planes' extended column x holds map column reflect(x - hd) in place
// of x - hd mod D, and the per-cell scale's box sums add the column sums of
// the mirrored columns, in the same order.  So est, the scale, threshold
// and det are bit-identical to ops/cfar_rank.cfar_rank_plain on
// ops/cfar._reflect_pad's map.  A single mirror: hr < R (whole maps) and
// hd < D.  No grouping: peak grouping wraps whatever the edges (the plain
// ops/cfar.peak_group follows, ops/cfar_rank.cfar_rank_then_group).
//
// Column chunks (W < D: maps wider than a tile of whole rows fits, at
// the repository's window 584 columns and up with the grouping entry's 16
// key bits): a block takes a tile of T rows x a chunk of W columns, the
// model of the decide kernel (slowtime_long.cuh).  It loads T + 2 (hr +
// pgr) rows of W + 2 (hd + pgr) columns, tile column x holding map column
// c0 - pgr - hd + x wrapped modulo D (the reflect entry: mirrored,
// fmcw::chunk_col), so every window and grouping neighbourhood of its
// cells lies in the tile unwrapped; builds the bit planes over those
// columns (extended column x = tile column x), the column sums over them,
// and decides its T + 2 pgr rows x W + 2 pgr columns with the same walks;
// the box sums add the same column sums in the same order, so est, scale,
// threshold and det are the whole-row tile's bit for bit.  It stores its T
// x W cells (a ragged last chunk only the columns below D), groups them
// with fmcw::group_store_chunk and combines its row maxima by atomicMax on
// the ordered image into a row_max the caller zeroed.  The tile's layout
// then depends on W, not on D.  Whole rows (W = D) keep the launches they
// had (ops/cfar_rank.tile_plan picks W).
//
// Bound on an H100: the POPC pipe — per cell bits x ceil((2 hr + 1) / 2)
// population counts (16 a clock an SM), ~2.5 integer ops beside each (64
// a clock) — against 16 bytes in and out per cell (20 with a scale map).

#include <cuda_runtime.h>
#include <stdint.h>

#include "cfar_common.cuh"

// Mirrors CfarRankConfig in kernels.py (ctypes.Structure, all int32).
struct CfarRankConfig {
    int batch, R, D, T;
    int hr, hd, gr, gd, n_ref, k;
    int scale_min, scale_nom, scale_max;
    int block_mode, so, integer, prepadded, bits;
    int pgr;    // grouping radius; -1: no grouping (det as decided)
    int reflect;    // numpy's "reflect" edges (rows too unless prepadded)
    int W;      // columns a block decides: D (whole rows), or a chunk
};

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 31;    // window rows 2 hr + 1 of the generic walk
constexpr int kStrip = 4;       // cells a thread walks together (packed walk)

// Shared memory layout, in 4-byte words (the C entry checks its total).
struct Layout {
    int tile, planes, cs_full, cs_guard, det_s, rmax, counts, total;
};

// The tile's row pitch P and the columns NC its block decides: whole rows
// (P = NC = D, columns wrapped or mirrored where they are read), or a chunk
// (P = W + 2 (hd + pgr) columns that carry the window and grouping halo,
// NC = W + 2 pgr).
__host__ __device__ inline bool chunked(const CfarRankConfig& c) {
    return c.W < c.D;
}

__host__ __device__ inline int pitch(const CfarRankConfig& c) {
    const int pg = c.pgr > 0 ? c.pgr : 0;
    return chunked(c) ? c.W + 2 * (c.hd + pg) : c.D;
}

__host__ __device__ inline int decided_cols(const CfarRankConfig& c) {
    const int pg = c.pgr > 0 ? c.pgr : 0;
    return chunked(c) ? c.W + 2 * pg : c.D;
}

__host__ __device__ inline Layout layout(const CfarRankConfig& c) {
    const int pg = c.pgr > 0 ? c.pgr : 0;
    const int E = c.T + 2 * (c.hr + pg);        // tile rows
    const int rows = c.T + 2 * pg;              // decided rows
    const int P = pitch(c), NC = decided_cols(c);
    const int npair = (NC + 31) / 32;
    const bool colsums = !c.block_mode && c.so == 0;
    Layout l;
    l.tile = 0;
    l.planes = (E * P + 1) & ~1;                // 8-byte aligned pairs
    l.cs_full = l.planes + 2 * c.bits * npair * E;
    l.cs_guard = l.cs_full + (colsums ? rows * P : 0);
    l.det_s = l.cs_guard + (colsums ? rows * P : 0);
    l.rmax = l.det_s + (c.pgr >= 0 ? rows * NC : 0);
    l.counts = l.rmax + (c.pgr >= 0 ? c.T : 0);
    l.total = l.counts + (c.pgr >= 0 ? 2 : 0);
    return l;
}

__device__ __forceinline__ int key_of(float v) { return __float_as_int(v); }
__device__ __forceinline__ int key_of(int v) { return v; }
__device__ __forceinline__ float from_key(int k, float*) {
    return __int_as_float(k);
}
__device__ __forceinline__ int from_key(int k, int*) { return k; }
__device__ __forceinline__ float scaled(float est, int sc) {
    return __fmul_rn(est, (float)sc);
}
// Wraps as the twin's int32 product does.
__device__ __forceinline__ int scaled(int est, int sc) {
    return (int)((unsigned)est * (unsigned)sc);
}

// The rank walk of one cell: planes points at pair j of the walk's first
// bit for the cell's first window row (consecutive rows are consecutive
// pairs, consecutive bits ``bit_stride`` pairs apart); one field, mask and
// population count per window row.  NR > 0: the window's 2 hr + 1 rows at
// compile time; NR = 0: nrows rows (<= kMaxRows) at run time.  Returns the
// prefix.
template <int NR>
__device__ __forceinline__ int rank_walk(const uint2* planes, int bit_stride,
                                         int s, int nrows, int gr0, int gr1,
                                         unsigned field_mask,
                                         unsigned guard_mask, int bits,
                                         int top, int k) {
    constexpr int M = NR > 0 ? NR : kMaxRows;
    unsigned eq[M];
#pragma unroll
    for (int r = 0; r < M; ++r)
        eq[r] = (r >= gr0 && r <= gr1) ? field_mask & ~guard_mask
                                       : field_mask;
    int above = 0;
    int prefix = 0;
    for (int i = 0; i < bits; ++i) {
        unsigned f[M];
        int cnt = above;
#pragma unroll
        for (int r = 0; r < M; ++r) {
            if (NR > 0 || r < nrows) {
                const uint2 w = planes[r];
                f[r] = __funnelshift_r(w.x, w.y, s);
                cnt += __popc(eq[r] & f[r]);
            }
        }
        const bool take = cnt >= k;
        const unsigned flip = take ? 0u : ~0u;
#pragma unroll
        for (int r = 0; r < M; ++r)
            if (NR > 0 || r < nrows) eq[r] &= f[r] ^ flip;
        above = take ? above : cnt;
        prefix |= take ? (1 << (top - i)) : 0;
        planes += bit_stride;
    }
    return prefix;
}

// The rank walks of a strip of S cells of one column (decided rows t0 ..
// t0 + S - 1), windows of NR rows and at most 16 columns: planes points at
// pair j of the first bit for tile row t0.  Each bit's S + NR - 1 row
// fields are extracted once for the strip, and window rows go in pairs:
// the fields of rows r and r + 1 packed as two 16-bit halves (one PRMT),
// each cell's mask of such a pair packed the same way, so that one
// population count covers two window rows (the last row of an odd window
// alone).  Writes the S prefixes.
template <int NR, int S>
__device__ __forceinline__ void rank_walk_packed(
        const uint2* planes, int bit_stride, int s, int gr0, int gr1,
        unsigned field_mask, unsigned guard_mask, int bits, int top, int k,
        int (&prefix)[S]) {
    constexpr int NP = (NR + 1) / 2;        // row pairs
    constexpr int NF = S + NR - 1;          // row fields of a bit
    unsigned eq[S][NP];
    int above[S];
#pragma unroll
    for (int c = 0; c < S; ++c) {
#pragma unroll
        for (int p = 0; p < NP; ++p) {
            const int r = 2 * p;
            const unsigned lo = (r >= gr0 && r <= gr1)
                                    ? field_mask & ~guard_mask : field_mask;
            const unsigned hi = r + 1 >= NR ? 0u
                                : ((r + 1 >= gr0 && r + 1 <= gr1)
                                       ? field_mask & ~guard_mask
                                       : field_mask);
            eq[c][p] = lo | (hi << 16);
        }
        above[c] = 0;
        prefix[c] = 0;
    }
    for (int i = 0; i < bits; ++i) {
        unsigned f[NF];
#pragma unroll
        for (int r = 0; r < NF; ++r) {
            const uint2 w = planes[r];
            f[r] = __funnelshift_r(w.x, w.y, s);
        }
        // h[r]: the low halves of rows r and r + 1.
        unsigned h[NF - 1];
#pragma unroll
        for (int r = 0; r < NF - 1; ++r) h[r] = __byte_perm(f[r], f[r + 1],
                                                            0x5410);
        const int bit = 1 << (top - i);
#pragma unroll
        for (int c = 0; c < S; ++c) {
            int cnt = above[c];
#pragma unroll
            for (int p = 0; p < NP; ++p)
                cnt += __popc(eq[c][p] &
                              (2 * p + 1 < NR ? h[c + 2 * p] : f[c + 2 * p]));
            const bool take = cnt >= k;
            const unsigned flip = take ? 0u : ~0u;
#pragma unroll
            for (int p = 0; p < NP; ++p)
                eq[c][p] &= (2 * p + 1 < NR ? h[c + 2 * p] : f[c + 2 * p])
                            ^ flip;
            above[c] = take ? above[c] : cnt;
            prefix[c] |= take ? bit : 0;
        }
        planes += bit_stride;
    }
}

// The walks of the decided rows 0 .. rows - 1, consecutive threads
// consecutive columns; decide(t, d, prefix) finishes a cell.  kPacked:
// strips of S cells (rows t0 = min(st S, rows - S); the last strip
// overlaps its neighbour, its cells decided twice with equal results) by
// rank_walk_packed; else one cell a thread by rank_walk.
template <int NR, int S, bool kPacked, typename Decide>
__device__ __forceinline__ void walk_cells(const uint2* planes, int E,
                                           int rows, int D, int bit_stride,
                                           int nrows, int gr0, int gr1,
                                           unsigned field_mask,
                                           unsigned guard_mask, int bits,
                                           int top, int k, Decide decide) {
    const int units = (rows + S - 1) / S * D;
    for (int u = threadIdx.x; u < units; u += blockDim.x) {
        const int d = u % D;
        const int t0 = min((u / D) * S, rows - S);
        const uint2* pl = planes + (d >> 5) * E + t0;
        if constexpr (kPacked) {
            int prefix[S];
            rank_walk_packed<NR, S>(pl, bit_stride, d & 31, gr0, gr1,
                                    field_mask, guard_mask, bits, top, k,
                                    prefix);
#pragma unroll
            for (int c = 0; c < S; ++c) decide(t0 + c, d, prefix[c]);
        } else {
            decide(t0, d, rank_walk<NR>(pl, bit_stride, d & 31, nrows, gr0,
                                        gr1, field_mask, guard_mask, bits,
                                        top, k));
        }
    }
}

// kReflect: the reflect entry (mirrored rows, plane columns and box-sum
// columns); the wrap instantiations keep their code.  kChunk: a chunk of
// W columns (chunked(c)); whole rows keep their code.  A chunk's walk of
// a window whose rows are known at run time only (NR = 0) takes the
// registers of one block an SM (at two it spills).
template <typename V, int NR, bool kReflect, bool kChunk>
__global__ void __launch_bounds__(kThreads, kChunk && NR == 0 ? 1 : 2)
cfar_rank_kernel(const V* __restrict__ map, const int* __restrict__ scale_in,
                 V* __restrict__ det, V* __restrict__ thr,
                 int* __restrict__ scale_out, V* __restrict__ row_max,
                 int* __restrict__ n_dets, const CfarRankConfig c) {
    extern __shared__ int smem_i[];
    const Layout lay = layout(c);
    V* tile = reinterpret_cast<V*>(smem_i + lay.tile);
    uint2* planes = reinterpret_cast<uint2*>(smem_i + lay.planes);
    V* cs_full = reinterpret_cast<V*>(smem_i + lay.cs_full);
    V* cs_guard = reinterpret_cast<V*>(smem_i + lay.cs_guard);
    V* det_s = reinterpret_cast<V*>(smem_i + lay.det_s);
    int* rmax_s = smem_i + lay.rmax;
    int* counts = smem_i + lay.counts;
    const bool group = c.pgr >= 0;
    const int pg = group ? c.pgr : 0;
    const int H = c.hr + pg;                    // tile row of map row r0
    const int E = c.T + 2 * H;
    const int rows = c.T + 2 * pg;              // decided rows
    const int D = c.D;
    const int P = kChunk ? pitch(c) : D;        // the tile's row pitch
    const int NC = kChunk ? decided_cols(c) : D;
    const int npair = (NC + 31) / 32;
    const int b = blockIdx.y;
    const int n_chunks = kChunk ? (D + c.W - 1) / c.W : 1;
    const int r0 = (kChunk ? blockIdx.x / n_chunks : blockIdx.x) * c.T;
    // The chunk's first column, and the map column of tile column 0.
    const int c0 = kChunk ? (blockIdx.x % n_chunks) * c.W : 0;
    const int x0 = c0 - pg - c.hd;
    const int tid = threadIdx.x;
    const int rows_in = c.prepadded ? c.R + 2 * c.hr : c.R;
    const V* src = map + (size_t)b * rows_in * D;

    // ---- 1. The tile: map rows r0 - H .. r0 + T + H - 1 (wrapped, or the
    //         prepadded shard's rows), 16 bytes a load where rows allow.
    auto map_row = [&](int e) {
        if (c.prepadded) return r0 + e;     // the map's row r0 - hr + e
        return kReflect ? fmcw::reflect_mod(r0 - H + e, c.R)
                        : fmcw::wrap_mod(r0 - H + e, c.R);
    };
    if (kChunk) {
        for (int idx = tid; idx < E * P; idx += kThreads) {
            const int e = idx / P;
            tile[idx] = src[(size_t)map_row(e) * D +
                            fmcw::chunk_col(x0 + idx - e * P, D, kReflect)];
        }
    } else if ((D & 3) == 0 && ((uintptr_t)src & 15) == 0) {
        const int D4 = D >> 2;
#pragma unroll 4
        for (int idx = tid; idx < E * D4; idx += kThreads) {
            const int e = idx / D4;
            reinterpret_cast<int4*>(tile)[idx] = reinterpret_cast<
                const int4*>(src + (size_t)map_row(e) * D)[idx - e * D4];
        }
    } else {
        for (int idx = tid; idx < E * D; idx += kThreads) {
            const int e = idx / D;
            tile[idx] = src[(size_t)map_row(e) * D + idx - e * D];
        }
    }
    if (group) {
        for (int i = tid; i < c.T; i += kThreads) rmax_s[i] = 0;
        if (tid < 2) counts[tid] = 0;
    }
    __syncthreads();

    // ---- 2. Bit planes of the clamped keys: for tile row e and word w
    //         (extended columns 32 w .. 32 w + 31), lane i keeps plane i's
    //         ballot and stores it as word w of pair w and word w - 1 ... of
    //         pair w - 1.  Planes are [bit][pair][tile row].  Extended
    //         column x holds column x - hd mod D, or reflect(x - hd); in a
    //         chunk tile column x (keys past the tile 0: no window reaches
    //         them).
    const int top = c.integer ? c.bits - 1 : 30;
    const int kmax = (int)((2u << top) - 1u);
    {
        const int lane = tid & 31;
        const int nw = npair + 1;
        for (int u = tid >> 5; u < E * nw; u += kThreads / 32) {
            const int e = u / nw;
            const int w = u % nw;
            int key;
            if (kChunk) {
                const int x = 32 * w + lane;
                key = x < P ? key_of(tile[e * P + x]) : 0;
            } else {
                const int x = 32 * w + lane - c.hd;
                const int col = kReflect ? fmcw::reflect_mod(x, D)
                                         : fmcw::wrap_mod(x, D);
                key = key_of(tile[e * D + col]);
            }
            const int kc = key < 0 ? 0 : (key > kmax ? kmax : key);
            unsigned mine = 0;
            for (int i = 0; i < c.bits; ++i) {
                const unsigned bal =
                    __ballot_sync(0xffffffffu, (kc >> (top - i)) & 1);
                if (lane == i) mine = bal;
            }
            if (lane < c.bits) {
                uint2* pl = planes + (size_t)lane * npair * E + e;
                if (w < npair) pl[w * E].x = mine;
                if (w > 0) pl[(w - 1) * E].y = mine;
            }
        }
    }
    //         Column sums of the per-cell scale: rows e - hr .. e + hr and
    //         e - gr .. e + gr of each decided tile row e, ascending, over
    //         every column of the tile.
    const bool colsums = !c.block_mode && c.so == 0;
    if (colsums) {
        for (int idx = tid; idx < rows * P; idx += kThreads) {
            const int t = idx / P;
            const int d = idx % P;
            const V* col = tile + t * P + d;    // window row 0 of row t + hr
            V f = col[0];
            for (int i = 1; i <= 2 * c.hr; ++i) f = fmcw::vadd(f, col[i * P]);
            V gs = col[(c.hr - c.gr) * P];
            for (int i = c.hr - c.gr + 1; i <= c.hr + c.gr; ++i)
                gs = fmcw::vadd(gs, col[i * P]);
            cs_full[idx] = f;
            cs_guard[idx] = gs;
        }
    }
    __syncthreads();

    // ---- 3. Per cell: the rank walk, the scale, threshold and decision.
    const int W = 2 * c.hd + 1;
    const unsigned field_mask = W >= 32 ? 0xffffffffu : (1u << W) - 1u;
    const unsigned guard_mask = ((1u << (2 * c.gd + 1)) - 1u)
                                << (c.hd - c.gd);
    const int bit_stride = npair * E;
    const size_t out0 = ((size_t)b * c.R + r0) * D;
    // The column of window column d + j: wrapped, or mirrored (hd < D); in
    // a chunk, decided column d's window column j lies at tile column d +
    // hd + j.
    auto wcol = [&](int d, int j) {
        if (kChunk) return d + c.hd + j;
        return kReflect ? fmcw::mirror_col(d + j, D)
                        : fmcw::wrap_col(d + j, D);
    };
    const int off = kChunk ? c.hd : 0;          // tile column of column 0
    auto decide = [&](int t, int d, int prefix) {
        const V est = from_key(prefix, (V*)nullptr);
        const int mrow = r0 - pg + t;           // map row of the cell
        const int mcol = kChunk ? c0 - pg + d : d;  // map column (< D:
                                                // stored, or whole rows)
        int sc;
        if (c.so != 0) {
            sc = c.so;
        } else if (c.block_mode) {
            int rr = mrow % c.R;
            if (rr < 0) rr += c.R;
            sc = scale_in[((size_t)b * c.R + rr) * D +
                          (kChunk ? fmcw::wrap_mod(mcol, D) : d)];
        } else {
            const V* cf = cs_full + t * P;
            const V* cg = cs_guard + t * P;
            V full = cf[wcol(d, -c.hd)];
            for (int j = -c.hd + 1; j <= c.hd; ++j)
                full = fmcw::vadd(full, cf[wcol(d, j)]);
            V guard = cg[wcol(d, -c.gd)];
            for (int j = -c.gd + 1; j <= c.gd; ++j)
                guard = fmcw::vadd(guard, cg[wcol(d, j)]);
            V t_hi, t_lo;
            fmcw::scale_thresholds(fmcw::vsub(full, guard), c.n_ref, t_hi,
                                   t_lo);
            sc = est > t_hi ? c.scale_max
                            : (est < t_lo ? c.scale_min : c.scale_nom);
        }
        const V cut = tile[(t + c.hr) * P + off + d];
        const V threshold = scaled(est, sc);
        const bool pass = cut > threshold;
        const bool own = t >= pg && t < pg + c.T &&
                         (!kChunk || (d >= pg && d < pg + c.W && mcol < D));
        if (own) {
            const size_t o = out0 + (size_t)(t - pg) * D + mcol;
            thr[o] = threshold;
            scale_out[o] = sc;
            if (!group) det[o] = pass ? cut : V(0);
        }
        // Grouping drops what peak_group drops: with a radius, a
        // non-positive CUT (an integer threshold that wrapped) never stays.
        if (group)
            det_s[t * NC + d] = pass && (pg == 0 || cut > V(0)) ? cut : V(0);
    };
    const int nrows = 2 * c.hr + 1;
    bool done = false;
    if constexpr (NR > 0) {
        if (rows >= kStrip && W <= 16) {
            walk_cells<NR, kStrip, true>(planes, E, rows, NC, bit_stride,
                                         nrows, c.hr - c.gr, c.hr + c.gr,
                                         field_mask, guard_mask, c.bits, top,
                                         c.k, decide);
            done = true;
        }
    }
    if (!done)
        walk_cells<NR, 1, false>(planes, E, rows, NC, bit_stride, nrows,
                                 c.hr - c.gr, c.hr + c.gr, field_mask,
                                 guard_mask, c.bits, top, c.k, decide);
    if (!group) return;
    __syncthreads();

    // ---- 4. Peak grouping of the T rows, row maxima and the count (a
    //         chunk's row maxima combined with the other chunks').
    if constexpr (kChunk)
        fmcw::group_store_chunk(det_s, c.W + 2 * pg, 0, c.T, c.W, pg, c.R,
                                D, r0, c0, det + ((size_t)b * c.R + r0) * D,
                                rmax_s, counts);
    else
        fmcw::group_store(det_s, tile, c.T, H, pg, c.R, D, r0, out0, det,
                          (V*)nullptr, rmax_s, counts);
    __syncthreads();
    for (int t = tid; t < c.T; t += kThreads) {
        if constexpr (kChunk)
            fmcw::merge_row_max(row_max + (size_t)b * c.R + r0 + t,
                                rmax_s[t]);
        else
            row_max[(size_t)b * c.R + r0 + t] =
                from_key(rmax_s[t], (V*)nullptr);
    }
    if (tid == 0 && counts[0]) atomicAdd(&n_dets[b], counts[0]);
}

template <typename V, int NR, bool kReflect = false, bool kChunk = false>
int launch_nr(const void* map, const void* scale_in, void* det, void* thr,
              void* scale_out, void* row_max, void* n_dets,
              const CfarRankConfig& c, cudaStream_t stream) {
    const size_t smem = (size_t)layout(c).total * 4;
    auto* kernel = cfar_rank_kernel<V, NR, kReflect, kChunk>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((c.R / c.T) * ((c.D + c.W - 1) / c.W), c.batch);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const V*>(map), static_cast<const int*>(scale_in),
        static_cast<V*>(det), static_cast<V*>(thr),
        static_cast<int*>(scale_out), static_cast<V*>(row_max),
        static_cast<int*>(n_dets), c);
    return (int)cudaGetLastError();
}

// The repository's windows (hr 6: 13 rows; hr 3: 7 rows) walk unrolled;
// the reflect entry and the chunks unroll only the default window (each
// unrolled variant costs build time; the hr 3 window's maps, 128 x 32,
// never chunk).
template <typename V>
int launch(const void* map, const void* scale_in, void* det, void* thr,
           void* scale_out, void* row_max, void* n_dets,
           const CfarRankConfig& c, cudaStream_t s) {
    if (chunked(c)) {
        if (c.reflect)
            return c.hr == 6
                       ? launch_nr<V, 13, true, true>(map, scale_in, det, thr,
                                                      scale_out, row_max,
                                                      n_dets, c, s)
                       : launch_nr<V, 0, true, true>(map, scale_in, det, thr,
                                                     scale_out, row_max,
                                                     n_dets, c, s);
        if (c.hr == 6)
            return launch_nr<V, 13, false, true>(map, scale_in, det, thr,
                                                 scale_out, row_max, n_dets,
                                                 c, s);
        return launch_nr<V, 0, false, true>(map, scale_in, det, thr,
                                            scale_out, row_max, n_dets, c, s);
    }
    if (c.reflect)
        return c.hr == 6
                   ? launch_nr<V, 13, true>(map, scale_in, det, thr,
                                            scale_out, row_max, n_dets, c, s)
                   : launch_nr<V, 0, true>(map, scale_in, det, thr,
                                           scale_out, row_max, n_dets, c, s);
    if (c.hr == 6)
        return launch_nr<V, 13>(map, scale_in, det, thr, scale_out, row_max,
                                n_dets, c, s);
    if (c.hr == 3)
        return launch_nr<V, 7>(map, scale_in, det, thr, scale_out, row_max,
                               n_dets, c, s);
    return launch_nr<V, 0>(map, scale_in, det, thr, scale_out, row_max,
                           n_dets, c, s);
}

}  // namespace

// Shared memory bytes of a configuration (ops/cfar_rank.tile_bytes mirrors
// it; chip_smoke.py holds the two equal).
extern "C" int fmcw_cfar_rank_smem(const CfarRankConfig* cfg) {
    return layout(*cfg).total * 4;
}

// map: int32 (integer != 0) or float32 (batch, R, D), or (batch, R + 2 hr,
// D) with prepadded; det, thr: the map's type (batch, R, D); scale_in: int32
// (batch, R, D) with block_mode, else null; scale_out: int32 (batch, R, D);
// with pgr >= 0 (grouping; not prepadded) row_max: the map's type (batch,
// R) and n_dets: int32 (batch,), zeroed by the caller, else null.  W: D
// (whole rows) or a chunk of fewer columns (row_max then zeroed by the
// caller too).
// reflect: numpy's mirror in place of the wrap (hr < R unless prepadded,
// hd < D; no grouping).  Returns the CUDA error code of the launch (0 on
// success).
extern "C" int fmcw_cfar_rank(const void* map, const void* scale_in,
                              void* det, void* thr, void* scale_out,
                              void* row_max, void* n_dets,
                              const CfarRankConfig* cfg, void* stream) {
    const CfarRankConfig c = *cfg;
    const bool group = c.pgr >= 0;
    if (c.batch < 1 || c.batch > 65535 || c.T < 1 || c.R % c.T != 0 ||
        c.W < 1 || c.W > c.D ||
        c.hd >= c.D || 2 * c.hd + 1 > 32 || c.hr < c.gr || c.hd < c.gd ||
        c.gr < 0 || c.gd < 0 || 2 * c.hr + 1 > kMaxRows || c.so < 0 ||
        c.k < 1 || c.k > c.n_ref || c.bits < 1 || c.bits > 31 ||
        c.pgr < -1 || (group && (c.prepadded || c.reflect ||
                                 row_max == nullptr || n_dets == nullptr)) ||
        (c.reflect != 0 && c.reflect != 1) ||
        (c.reflect && !c.prepadded && c.hr >= c.R) ||
        (size_t)layout(c).total * 4 > 227 * 1024 ||
        (c.block_mode && scale_in == nullptr))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    return c.integer
               ? launch<int>(map, scale_in, det, thr, scale_out, row_max,
                             n_dets, c, s)
               : launch<float>(map, scale_in, det, thr, scale_out, row_max,
                               n_dets, c, s);
}
