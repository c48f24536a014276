// Register-blocked 2D OS-CFAR decision on a map tile in shared memory:
// the counting form of cfar_common.cuh, organised so that each value of the
// tile is loaded once per strip of cells rather than once per cell; and,
// a separate compile-time path of decide_tile (kMean: kernel B and the
// fixed slow-time kernel), the CA/GO/SO variants' window-mean decision on
// the same strips.
//
// A thread owns a strip of kStrip cells of one Doppler column (consecutive
// rows; the threads of a warp own neighbouring columns, so every shared
// load of a warp is one row of consecutive words).  For each window column
// it walks the window's rows once (walk_rows): kStrip + 2 hr loads, each
// compared with the thresholds of every cell of the strip whose window
// holds it.  Per cell:
//   * per-cell scale: the full-window and guard-window column sums of the
//     decided rows are computed once per tile (tile_colsums: each a sum
//     over rows ascending, from -0, which adds exactly as taking the first
//     term), each cell's box sum adds 2 hd + 1 of them ascending, so the
//     mean is the twin's bit for bit (ops/cfar._box_sum); then one pass
//     counts hi and lo packed in one count (count_hi_lo), which keeps every
//     compare as it is (> t_hi, >= t_lo; a NaN value or threshold counts in
//     neither);
//   * block scale: the cell's block's scale (block_scale_tile);
//   * then a second pass counts refs >= q for the scale's detect_threshold
//     q, and the cell passes when that count is below k and cut > 0.
// The guard rows of a guard column are skipped as whole steps of the walk,
// the same for every cell of the strip (at compile time for the windows
// walked unrolled, walk_training).
//
// Templated on the map type, float maps (every add __fadd_rn, as the
// twin's) or int maps, and on how its thresholds are computed
// (cfar_common.cuh: MapSem, the map type's own arithmetic; IntInFloat, the
// fixed chain's integer semantics on an integer map held in float).
#pragma once

#include <stdint.h>

#include "cfar_common.cuh"

namespace fmcw {

constexpr int kStrip = 8;       // cells per thread, one Doppler column

// Tile copies: cp.async copies of 16 and 4 bytes from global into shared
// memory (cp.async.wait_all ends them); rows are wrapped by
// cfar_common.cuh's wrap_mod.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"(s), "l"(src) : "memory");
}

// Compare-and-count.  A float map's compare gives 1.0f / 0.0f (one FSET on
// the integer pipe: an ordered compare, false with a NaN operand) and the
// count adds on the FMA pipe, where an integer count's select and add would
// both take the integer pipe, the counting loops' bottleneck; counts of
// at most n_ref are exact in float.  hi and lo are packed in one count,
// hi * 4096 + lo for floats (exact while n_ref <= 4094, kMaxPackedRef),
// hi * 0x10000 + lo for integers.
template <typename V> struct CountOf { using type = int; };
template <> struct CountOf<float> { using type = float; };
template <typename V> using Count = typename CountOf<V>::type;

__device__ __forceinline__ float is_ge(float a, float b) {
    float r;
    asm("set.ge.f32.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}
__device__ __forceinline__ float is_gt(float a, float b) {
    float r;
    asm("set.gt.f32.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}
__device__ __forceinline__ int is_ge(int a, int b) { return a >= b; }
__device__ __forceinline__ int is_gt(int a, int b) { return a > b; }

__device__ __forceinline__ float count_add(float c, float x) {
    return __fadd_rn(c, x);
}
__device__ __forceinline__ int count_add(int c, int x) { return c + x; }

// c + (a > t_hi) * kPack + (a >= t_lo).
__device__ __forceinline__ float count_hi_lo(float c, float a, float t_hi,
                                             float t_lo) {
    return __fadd_rn(__fmaf_rn(is_gt(a, t_hi), 4096.f, c), is_ge(a, t_lo));
}
__device__ __forceinline__ int count_hi_lo(int c, int a, int t_hi, int t_lo) {
    return c + (a > t_hi ? 0x10000 : 0) + (a >= t_lo ? 1 : 0);
}
__device__ __forceinline__ void unpack_hi_lo(float c, int& hi, int& lo) {
    const int v = __float2int_rz(c);
    hi = v >> 12;
    lo = v & 4095;
}
__device__ __forceinline__ void unpack_hi_lo(int c, int& hi, int& lo) {
    hi = c >> 16;
    lo = c & 0xffff;
}
__device__ __forceinline__ int as_int(float c) { return __float2int_rz(c); }
__device__ __forceinline__ int as_int(int c) { return c; }

// The largest n_ref the packed count holds for a map of type V.
template <typename V> constexpr int kMaxPackedRef = 65535;
template <> constexpr int kMaxPackedRef<float> = 4094;

// The identity of the twin's sums: -0 + x == x for every float x.
template <typename V>
__device__ __forceinline__ V sum_identity();
template <>
__device__ __forceinline__ float sum_identity<float>() { return -0.0f; }
template <>
__device__ __forceinline__ int sum_identity<int>() { return 0; }

// Walks W window rows for a strip of S cells of one column: col points at
// the window's first row for cell 0 (tile row e0 - hr) and the strip's
// cells are col + (s + hr) * D.  At step dr (ascending) it calls visit(dr,
// s, v) for s = 0 .. S-1 with v = col[(s + dr) * D], when use(dr); every
// row is loaded once, into a ring of S registers (slot: row mod S, all
// indices compile-time).
template <int S, typename V, typename Use, typename Visit>
__device__ __forceinline__ void walk_rows(const V* col, int D, int W, Use use,
                                          Visit visit) {
    V ring[S];
#pragma unroll
    for (int i = 0; i < S - 1; ++i) ring[i] = col[i * D];
    for (int dr0 = 0; dr0 < W; dr0 += S) {
#pragma unroll
        for (int j = 0; j < S; ++j) {
            const int dr = dr0 + j;
            if (dr < W) {
                ring[(j + S - 1) % S] = col[(dr + S - 1) * D];
                if (use(dr)) {
#pragma unroll
                    for (int s = 0; s < S; ++s)
                        visit(dr, s, ring[(s + j) % S]);
                }
            }
        }
    }
}

// The strips of the decided rows i = 0 .. rows-1 (tile rows e_first + i):
// strip st covers rows i0 .. i0 + kStrip - 1, i0 = min(st kStrip, rows -
// kStrip) (the last strip overlaps its neighbour: its cells are decided
// twice, with equal results).  Unit u = st * D + d; a block walks its units
// with stride blockDim.x.
__host__ __device__ inline int strip_units(int rows, int D) {
    return (rows + kStrip - 1) / kStrip * D;
}

__device__ __forceinline__ int strip_row0(int u, int rows, int D) {
    const int i0 = (u / D) * kStrip;
    return i0 < rows - kStrip ? i0 : rows - kStrip;
}

// Per-cell scale, step 1: the full (rows e - hr .. e + hr) and guard (e -
// gr .. e + gr) column sums of every decided cell, rows ascending, into
// cs_full / cs_guard (rows x D); kGuard false: the full ones only (the
// CA/GO/SO epilogue, which sums its guard boxes itself).  All threads of
// the block call it.
template <typename V, bool kGuard = true>
__device__ void tile_colsums(const V* mag_s, int D, int e_first, int rows,
                             const CfarGeom& g, V* cs_full, V* cs_guard) {
    constexpr int S = kStrip;
    const int units = strip_units(rows, D);
    for (int u = threadIdx.x; u < units; u += blockDim.x) {
        const int d = u % D;
        const int i0 = strip_row0(u, rows, D);
        V f[S], gs[S];
#pragma unroll
        for (int s = 0; s < S; ++s) f[s] = gs[s] = sum_identity<V>();
        walk_rows<S>(mag_s + (e_first + i0 - g.hr) * D + d, D, 2 * g.hr + 1,
                     [](int) { return true; },
                     [&](int dr, int s, V v) {
                         f[s] = vadd(f[s], v);
                         if (kGuard && dr >= g.hr - g.gr && dr <= g.hr + g.gr)
                             gs[s] = vadd(gs[s], v);
                     });
#pragma unroll
        for (int s = 0; s < S; ++s) {
            cs_full[(i0 + s) * D + d] = f[s];
            if constexpr (kGuard) cs_guard[(i0 + s) * D + d] = gs[s];
        }
    }
}

// walk_rows with the window's rows known at compile time (HR, GR): every
// step unrolled and, in a guard column (kGuard), the guard rows left out,
// so the walk has no branch.
template <int S, int HR, int GR, bool kGuard, typename V, typename Visit>
__device__ __forceinline__ void walk_rows_fixed(const V* col, int D,
                                                Visit visit) {
    V ring[S];
#pragma unroll
    for (int i = 0; i < S - 1; ++i) ring[i] = col[i * D];
#pragma unroll
    for (int dr = 0; dr <= 2 * HR; ++dr) {
        ring[(dr + S - 1) % S] = col[(dr + S - 1) * D];
        if (kGuard && dr >= HR - GR && dr <= HR + GR) continue;
#pragma unroll
        for (int s = 0; s < S; ++s) visit(dr, s, ring[(s + dr) % S]);
    }
}

template <int S, int HR, int GR, typename V, typename Visit>
__device__ __forceinline__ void walk_training_fixed(const V* row0, int D,
                                                    int d, const CfarGeom& g,
                                                    Visit visit) {
    for (int dd = -g.hd; dd <= g.hd; ++dd) {
        const V* col = row0 + wrap_col(d + dd, D);
        if (dd >= -g.gd && dd <= g.gd)
            walk_rows_fixed<S, HR, GR, true>(col, D, visit);
        else
            walk_rows_fixed<S, HR, GR, false>(col, D, visit);
    }
}

// walk_training_fixed with the guard box optional: with guard false every
// row of every window column is walked (the beam planes of a 3D window
// outside its guard planes, cfar_3d_detect.cu).  row0: the window's first
// row, column 0.  kWrap false: the tile's rows carry the column halo (the
// flat-stream entry of cfar_detect.cu), D is only their pitch and column
// d + dd is read at row0 + d + dd, unwrapped.
template <int S, int HR, int GR, bool kWrap = true, typename V,
          typename Visit>
__device__ __forceinline__ void walk_window_fixed(const V* row0, int D, int d,
                                                  const CfarGeom& g,
                                                  bool guard, Visit visit) {
    for (int dd = -g.hd; dd <= g.hd; ++dd) {
        const V* col = row0 + (kWrap ? wrap_col(d + dd, D) : d + dd);
        if (guard && dd >= -g.gd && dd <= g.gd)
            walk_rows_fixed<S, HR, GR, true>(col, D, visit);
        else
            walk_rows_fixed<S, HR, GR, false>(col, D, visit);
    }
}

// The same for a window whose rows are known at run time only.
template <int S, bool kWrap = true, typename V, typename Visit>
__device__ __forceinline__ void walk_window(const V* row0, int D, int d,
                                            const CfarGeom& g, bool guard,
                                            Visit visit) {
    for (int dd = -g.hd; dd <= g.hd; ++dd) {
        const bool gcol = guard && dd >= -g.gd && dd <= g.gd;
        walk_rows<S>(row0 + (kWrap ? wrap_col(d + dd, D) : d + dd), D,
                     2 * g.hr + 1,
                     [&](int dr) {
                         return !(gcol && dr >= g.hr - g.gr &&
                                  dr <= g.hr + g.gr);
                     },
                     visit);
    }
}

// walk_window_fixed where the window's rows are template constants (HR >
// 0), else walk_window: the kernels' variants pick the walk at compile
// time.
template <int S, int HR, int GR, bool kWrap = true, typename V,
          typename Visit>
__device__ __forceinline__ void walk_window_t(const V* row0, int D, int d,
                                              const CfarGeom& g, bool guard,
                                              Visit visit) {
    if constexpr (HR > 0)
        walk_window_fixed<S, HR, GR, kWrap>(row0, D, d, g, guard, visit);
    else
        walk_window<S, kWrap>(row0, D, d, g, guard, visit);
}

// Counts over the training cells of a strip's windows: for each window
// column (ascending) a walk of its 2 hr + 1 rows, the guard rows of the
// guard columns skipped.  col0: the strip's column d at the window's first
// row (tile row e0 - hr, column d; columns wrap modulo D).  The windows of
// the repository's configurations (hr, gr) = (6, 2) and (3, 1) walk
// unrolled.
template <int S, typename V, typename Visit>
__device__ __forceinline__ void walk_training(const V* col0, int D, int d,
                                              const CfarGeom& g,
                                              Visit visit) {
    const V* row0 = col0 - d;
    if (g.hr == 6 && g.gr == 2)
        return walk_training_fixed<S, 6, 2>(row0, D, d, g, visit);
    if (g.hr == 3 && g.gr == 1)
        return walk_training_fixed<S, 3, 1>(row0, D, d, g, visit);
    for (int dd = -g.hd; dd <= g.hd; ++dd) {
        const bool gcol = dd >= -g.gd && dd <= g.gd;
        walk_rows<S>(row0 + wrap_col(d + dd, D), D, 2 * g.hr + 1,
                     [&](int dr) {
                         return !(gcol && dr >= g.hr - g.gr &&
                                  dr <= g.hr + g.gr);
                     },
                     visit);
    }
}

// The decisions of one strip (cells at tile rows e0 .. e0 + kStrip - 1,
// column d) as bits (bit s: the cell passes).  Per-cell scale (bscale
// null): the thresholds (Sem::thresholds) from the box sums (in Sem::Acc)
// of the column sums of decided rows i0 .. (tile rows e0 ..); block scale:
// bscale[(e / sb) * (D / sb) + d / sb]; so != 0 overrides the scale (and
// skips the scale's pass).
template <typename V, typename Sem>
__device__ __forceinline__ unsigned strip_decide(
        const V* mag_s, int D, int e0, int i0, int d, const V* cs_full,
        const V* cs_guard, const int* bscale, int sb, int so,
        const CfarGeom& g) {
    constexpr int S = kStrip;
    const V* col0 = mag_s + (e0 - g.hr) * D + d;
    int sc[S];
    if (so != 0) {
#pragma unroll
        for (int s = 0; s < S; ++s) sc[s] = so;
    } else if (bscale) {
        const int nbd = D / sb;
#pragma unroll
        for (int s = 0; s < S; ++s)
            sc[s] = bscale[((e0 + s) / sb) * nbd + d / sb];
    } else {
        using A = typename Sem::Acc;
        V t_hi[S], t_lo[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
            const V* cf = cs_full + (i0 + s) * D;
            const V* cg = cs_guard + (i0 + s) * D;
            A full = sum_identity<A>(), guard = sum_identity<A>();
            for (int j = -g.hd; j <= g.hd; ++j)
                full = vadd(full, Sem::acc(cf[wrap_col(d + j, D)]));
            for (int j = -g.gd; j <= g.gd; ++j)
                guard = vadd(guard, Sem::acc(cg[wrap_col(d + j, D)]));
            Sem::thresholds(vsub(full, guard), g.n_ref, t_hi[s], t_lo[s]);
        }
        Count<V> hl[S];
#pragma unroll
        for (int s = 0; s < S; ++s) hl[s] = 0;
        walk_training<S>(col0, D, d, g, [&](int, int s, V v) {
            hl[s] = count_hi_lo(hl[s], v, t_hi[s], t_lo[s]);
        });
#pragma unroll
        for (int s = 0; s < S; ++s) {
            int hi, lo;
            unpack_hi_lo(hl[s], hi, lo);
            sc[s] = classify(hi, lo, g.k, g);
        }
    }
    V q[S];
#pragma unroll
    for (int s = 0; s < S; ++s)
        q[s] = Sem::q(mag_s[(e0 + s) * D + d], sc[s]);
    Count<V> cnt[S];
#pragma unroll
    for (int s = 0; s < S; ++s) cnt[s] = 0;
    walk_training<S>(col0, D, d, g, [&](int, int s, V v) {
        cnt[s] = count_add(cnt[s], is_ge(v, q[s]));
    });
    unsigned bits = 0;
#pragma unroll
    for (int s = 0; s < S; ++s)
        if (as_int(cnt[s]) < g.k && mag_s[(e0 + s) * D + d] > V(0))
            bits |= 1u << s;
    return bits;
}

// ---------------------------------------------------------------------------
// CA / GO / SO: the estimate a training-window mean, decided directly
// (cut > est * scale, no counting), templated on the semantics (Sem) as
// strip_decide is.
//
// Float maps (MapSem<float>, kernel B): the semantics and the association
// orders of fmcw_tpu/ops/cfar.py::cfar_2d's non-OS branch and its _ref_sums
// (the twin: ops/cfar.py's cfar_2d), so the decisions are the twin's bit
// for bit:
//   * sum_refs = full box - guard box, each box its columns' sums (rows
//     ascending) added columns ascending (_box2d_sum; strip_ref_sums: the
//     full columns' sums from tile_colsums<float, false>, the guard box
//     walked by the strip, as cheap as a third of a column walk);
//   * GO / SO halves: each row's 2 hd + 1 columns ascending first, then
//     those row sums, rows ascending (_ref_sums' lead / lag;
//     strip_half_sums, unrolled for the repository's windows), over
//     n_half = ref_range x win_doppler cells;
//   * every add __fadd_rn from -0, IEEE __fdiv_rn by the counts; GO / SO
//     take the greater / smaller mean, NaN propagating (jnp.maximum);
//   * per-cell scale: est against 1.5x / 0.5x the training mean.
// Integer maps held in float (IntInFloat, the fixed slow-time kernel;
// fmcw_tpu/ops/frontend_pallas.py::_detect_epilogue with integer=True):
//   * a column's or a row's partial sum (at most 2 hr + 1 or 2 hd + 1
//     magnitudes, below 2^24) stays in float, exact; every sum across
//     partial sums (the boxes, the halves) accumulates in int (Sem::Acc),
//     so every sum is exact in any order and any window size;
//   * floor means (integer division of sums >= 0), t_hi = mean + (mean >>
//     1), t_lo = mean >> 1;
//   * the decision est < ceil(cut / sc) (Sem::q's integer), never est * sc
//     in float (which passes 2^24 under a large override).
// ---------------------------------------------------------------------------

enum MeanVariant { kCA = 1, kGO = 2, kSO = 3 };     // SlowtimeConfig.variant

// sum_refs of the strip's cells (tile rows e0 .. e0 + S - 1, decided rows
// i0 .., column d): each full box the 2 hd + 1 column sums cs_full of its
// row (tile_colsums) added ascending, as strip_decide adds them; each
// guard box its 2 gd + 1 guard columns walked here (2 gr + 1 rows
// ascending from -0, tile_colsums' guard sums), added ascending; the adds
// across columns in Sem::Acc.
template <int S, typename Sem>
__device__ __forceinline__ void strip_ref_sums(
        const float* mag_s, const float* cs_full, int D, int e0, int i0,
        int d, const CfarGeom& g, typename Sem::Acc (&sum_refs)[S]) {
    using A = typename Sem::Acc;
    A guard[S];
#pragma unroll
    for (int s = 0; s < S; ++s) guard[s] = sum_identity<A>();
    const float* row0 = mag_s + (e0 - g.gr) * D;
    for (int dd = -g.gd; dd <= g.gd; ++dd) {
        float gs[S];
#pragma unroll
        for (int s = 0; s < S; ++s) gs[s] = -0.0f;
        walk_rows<S>(row0 + wrap_col(d + dd, D), D, 2 * g.gr + 1,
                     [](int) { return true; },
                     [&](int, int s, float v) {
                         gs[s] = __fadd_rn(gs[s], v);
                     });
#pragma unroll
        for (int s = 0; s < S; ++s)
            guard[s] = vadd(guard[s], Sem::acc(gs[s]));
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const float* cf = cs_full + (i0 + s) * D;
        A full = sum_identity<A>();
        for (int j = -g.hd; j <= g.hd; ++j)
            full = vadd(full, Sem::acc(cf[wrap_col(d + j, D)]));
        sum_refs[s] = vsub(full, guard[s]);
    }
}

// The lead (window rows 0 .. hr - gr - 1) and lag (hr + gr + 1 .. 2 hr)
// sums of the strip's cells: each tile row's sum across the window's
// columns once (in float), added into every cell whose half holds that row
// (in Sem::Acc).
template <int S, typename Sem>
__device__ __forceinline__ void strip_half_sums(
        const float* mag_s, int D, int e0, int d, const CfarGeom& g,
        typename Sem::Acc (&lead)[S], typename Sem::Acc (&lag)[S]) {
    using A = typename Sem::Acc;
#pragma unroll
    for (int s = 0; s < S; ++s) lead[s] = lag[s] = sum_identity<A>();
    const int W = 2 * g.hr + 1;
    const int lead_end = g.hr - g.gr, lag_begin = g.hr + g.gr + 1;
    for (int w = 0; w < S - 1 + W; ++w) {
        const float* row = mag_s + (e0 - g.hr + w) * D;
        float rs = -0.0f;
        for (int dd = -g.hd; dd <= g.hd; ++dd)
            rs = __fadd_rn(rs, row[wrap_col(d + dd, D)]);
        const A ra = Sem::acc(rs);
#pragma unroll
        for (int s = 0; s < S; ++s) {
            const int dr = w - s;               // the row in cell s's window
            if (dr >= 0 && dr < lead_end)
                lead[s] = vadd(lead[s], ra);
            else if (dr >= lag_begin && dr < W)
                lag[s] = vadd(lag[s], ra);
        }
    }
}

// strip_half_sums with the window's rows known at compile time (HR, GR;
// the repository's windows): the column loop outside, each of the S - 1 +
// 2 HR + 1 row sums a register that adds its columns ascending (the same
// sequence of adds per row, column wraps once per column), then each
// cell's halves from those registers, all indices compile-time.
template <int S, int HR, int GR, typename Sem>
__device__ __forceinline__ void strip_half_sums_fixed(
        const float* mag_s, int D, int e0, int d, const CfarGeom& g,
        typename Sem::Acc (&lead)[S], typename Sem::Acc (&lag)[S]) {
    using A = typename Sem::Acc;
    constexpr int NR = S - 1 + 2 * HR + 1;
    float rs[NR];
#pragma unroll
    for (int w = 0; w < NR; ++w) rs[w] = -0.0f;
    const float* row0 = mag_s + (e0 - HR) * D;
    for (int dd = -g.hd; dd <= g.hd; ++dd) {
        const float* col = row0 + wrap_col(d + dd, D);
#pragma unroll
        for (int w = 0; w < NR; ++w) rs[w] = __fadd_rn(rs[w], col[w * D]);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
        A a = sum_identity<A>(), b = sum_identity<A>();
#pragma unroll
        for (int r = 0; r < HR - GR; ++r) a = vadd(a, Sem::acc(rs[s + r]));
#pragma unroll
        for (int r = HR + GR + 1; r <= 2 * HR; ++r)
            b = vadd(b, Sem::acc(rs[s + r]));
        lead[s] = a;
        lag[s] = b;
    }
}

// max / min that return NaN when either operand is NaN (fmaxf / fminf
// return the other operand); integers have none.
__device__ __forceinline__ float max_nan(float a, float b) {
    return (isnan(a) || isnan(b)) ? __fadd_rn(a, b) : fmaxf(a, b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
    return (isnan(a) || isnan(b)) ? __fadd_rn(a, b) : fminf(a, b);
}
__device__ __forceinline__ int max_nan(int a, int b) { return max(a, b); }
__device__ __forceinline__ int min_nan(int a, int b) { return min(a, b); }

// A window mean: IEEE division for floats, the floor for integer sums.
__device__ __forceinline__ float window_mean(float sum, int n) {
    return __fdiv_rn(sum, (float)n);
}
__device__ __forceinline__ int window_mean(int sum, int n) {
    return floor_div(sum, n);
}

// cut > est * sc: the rounded float product, or for integers est < ceil(cut
// / sc) (sc > 0; sc = 0 leaves cut > 0).
__device__ __forceinline__ bool mean_passes(float cut, float est, int sc) {
    return cut > __fmul_rn(est, (float)sc);
}
__device__ __forceinline__ bool mean_passes(int cut, int est, int sc) {
    return sc > 0 ? est < detect_threshold(cut, sc) : cut > 0;
}

// Does the CA/GO/SO epilogue need sum_refs (and so tile_colsums' full
// column sums): for CA's estimate, or for the per-cell scale.  GO / SO
// with a block scale or the override skip it (as JAX's fused epilogue).
__device__ __forceinline__ bool mean_needs_sums(int variant, bool block,
                                                int so) {
    return variant == kCA || (!block && so == 0);
}

// The CA/GO/SO decisions of one strip as bits (as strip_decide): the scale
// is the override (so != 0), the block scale (bscale) or, per cell, est
// against the training mean.  cs_full: tile_colsums' full column sums of
// the decided rows, where mean_needs_sums.
template <typename Sem>
__device__ __forceinline__ unsigned strip_decide_mean(
        const float* mag_s, const float* cs_full, int D, int e0, int i0,
        int d, const int* bscale, int sb, int so, int variant,
        const CfarGeom& g) {
    using A = typename Sem::Acc;
    constexpr int S = kStrip;
    A sum_refs[S];
    if (mean_needs_sums(variant, bscale != nullptr, so)) {
        strip_ref_sums<S, Sem>(mag_s, cs_full, D, e0, i0, d, g, sum_refs);
    } else {
#pragma unroll
        for (int s = 0; s < S; ++s) sum_refs[s] = A(0);
    }
    A est[S];
    if (variant == kCA) {
#pragma unroll
        for (int s = 0; s < S; ++s) est[s] = window_mean(sum_refs[s], g.n_ref);
    } else {
        A lead[S], lag[S];
        if (g.hr == 6 && g.gr == 2)
            strip_half_sums_fixed<S, 6, 2, Sem>(mag_s, D, e0, d, g, lead,
                                                lag);
        else if (g.hr == 3 && g.gr == 1)
            strip_half_sums_fixed<S, 3, 1, Sem>(mag_s, D, e0, d, g, lead,
                                                lag);
        else
            strip_half_sums<S, Sem>(mag_s, D, e0, d, g, lead, lag);
        const int n_half = (g.hr - g.gr) * (2 * g.hd + 1);
#pragma unroll
        for (int s = 0; s < S; ++s) {
            const A ml = window_mean(lead[s], n_half);
            const A mg = window_mean(lag[s], n_half);
            est[s] = variant == kGO ? max_nan(ml, mg) : min_nan(ml, mg);
        }
    }
    unsigned bits = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
        int sc;
        if (so != 0) {
            sc = so;
        } else if (bscale) {
            sc = bscale[((e0 + s) / sb) * (D / sb) + d / sb];
        } else {
            A t_hi, t_lo;
            scale_thresholds(sum_refs[s], g.n_ref, t_hi, t_lo);
            sc = est[s] > t_hi ? g.scale_max
                               : (est[s] < t_lo ? g.scale_min : g.scale_nom);
        }
        if (mean_passes(Sem::acc(mag_s[(e0 + s) * D + d]), est[s], sc))
            bits |= 1u << s;
    }
    return bits;
}

// The CFAR decision of the decided rows i = 0 .. rows-1 (tile rows
// e_first + i) into det_s (rows x D): the CUT where it passes, else 0.
// OS (kMean false): per-cell scale from cs_full / cs_guard of
// tile_colsums (may alias det_s: every thread has finished reading them
// before det_s is written), block scale from bscale.  kMean (float tiles:
// float maps, or IntInFloat): the CA/GO/SO epilogue of ``variant``
// (strip_decide_mean<Sem>), with cs_full the full column sums of
// tile_colsums<float, false> where mean_needs_sums.  At most 64 / kStrip
// units a thread (the decisions are held as bits across a barrier).  n_cols
// > 0 decides columns d0 .. d0 + n_cols - 1 only (a tile that is a column
// window of its map, every decided cell's window inside it: kernel B's
// long-CPI chunks); 0, every column.  All threads of the block call it.
template <typename V, typename Sem = MapSem<V>, bool kMean = false>
__device__ void decide_tile(const V* mag_s, V* det_s, int e_first, int rows,
                            int D, const V* cs_full, const V* cs_guard,
                            const int* bscale, int sb, int so,
                            const CfarGeom& g, int variant = 0, int d0 = 0,
                            int n_cols = 0) {
    const int nc = n_cols > 0 ? n_cols : D;
    const int units = strip_units(rows, nc);
    uint64_t bits = 0;
    int sh = 0;
    for (int u = threadIdx.x; u < units; u += blockDim.x, sh += kStrip) {
        const int i0 = strip_row0(u, rows, nc);
        unsigned b;
        if constexpr (kMean)
            b = strip_decide_mean<Sem>(mag_s, cs_full, D, e_first + i0,
                                       i0, d0 + u % nc, bscale, sb, so,
                                       variant, g);
        else
            b = strip_decide<V, Sem>(mag_s, D, e_first + i0, i0,
                                     d0 + u % nc, cs_full, cs_guard, bscale,
                                     sb, so, g);
        bits |= (uint64_t)b << sh;
    }
    __syncthreads();
    sh = 0;
    for (int u = threadIdx.x; u < units; u += blockDim.x, sh += kStrip) {
        const int d = d0 + u % nc;
        const int i0 = strip_row0(u, rows, nc);
#pragma unroll
        for (int s = 0; s < kStrip; ++s)
            det_s[(i0 + s) * D + d] = ((bits >> (sh + s)) & 1)
                                          ? mag_s[(e_first + i0 + s) * D + d]
                                          : V(0);
    }
    __syncthreads();
}

}  // namespace fmcw
