// Register-blocked 2D OS-CFAR decision on a map tile in shared memory:
// the counting form of cfar_common.cuh, organised so that each value of the
// tile is loaded once per strip of cells rather than once per cell.
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

// Tile copies: a row index wrapped modulo n, and cp.async copies of 16 and
// 4 bytes from global into shared memory (cp.async.wait_all ends them).
__device__ __forceinline__ int wrap_mod(int i, int n) {
    const int r = i % n;
    return r < 0 ? r + n : r;
}

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
// cs_full / cs_guard (rows x D).  All threads of the block call it.
template <typename V>
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
                         if (dr >= g.hr - g.gr && dr <= g.hr + g.gr)
                             gs[s] = vadd(gs[s], v);
                     });
#pragma unroll
        for (int s = 0; s < S; ++s) {
            cs_full[(i0 + s) * D + d] = f[s];
            cs_guard[(i0 + s) * D + d] = gs[s];
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

// The CFAR decision of the decided rows i = 0 .. rows-1 (tile rows
// e_first + i) into det_s (rows x D): the CUT where it passes, else 0.
// Per-cell scale: cs_full / cs_guard from tile_colsums (may alias det_s:
// every thread has finished reading them before det_s is written);
// block scale: bscale.  At most 64 / kStrip units a thread (the decisions
// are held as bits across a barrier).  All threads of the block call it.
template <typename V, typename Sem = MapSem<V>>
__device__ void decide_tile(const V* mag_s, V* det_s, int e_first, int rows,
                            int D, const V* cs_full, const V* cs_guard,
                            const int* bscale, int sb, int so,
                            const CfarGeom& g) {
    const int units = strip_units(rows, D);
    uint64_t bits = 0;
    int sh = 0;
    for (int u = threadIdx.x; u < units; u += blockDim.x, sh += kStrip) {
        const int i0 = strip_row0(u, rows, D);
        bits |= (uint64_t)strip_decide<V, Sem>(mag_s, D, e_first + i0, i0,
                                               u % D, cs_full, cs_guard,
                                               bscale, sb, so, g)
                << sh;
    }
    __syncthreads();
    sh = 0;
    for (int u = threadIdx.x; u < units; u += blockDim.x, sh += kStrip) {
        const int d = u % D;
        const int i0 = strip_row0(u, rows, D);
#pragma unroll
        for (int s = 0; s < kStrip; ++s)
            det_s[(i0 + s) * D + d] = ((bits >> (sh + s)) & 1)
                                          ? mag_s[(e_first + i0 + s) * D + d]
                                          : V(0);
    }
    __syncthreads();
}

}  // namespace fmcw
