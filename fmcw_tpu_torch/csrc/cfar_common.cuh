// Shared device code of the CFAR decision: the 2D OS-CFAR decided by
// counting (per-cell or block adaptive scale) and peak grouping, on a map
// tile held in shared memory: the thresholds, scale classes and q of the
// decision (cfar_tile.cuh counts with them), the block scale and the
// grouping epilogue.  Used by slowtime_detect.cu (float32 maps),
// slowtime_detect_fixed.cu (integer maps held in float), cfar_detect.cu and
// cfar_3d_detect.cu (float32 and int32 maps) and cfar_rank.cu (its scale
// thresholds and grouping).
//
// The counting form (fmcw_tpu/ops/cfar_pallas.py::_kernel_detect): for the
// k-th largest training value est (k = n_ref - rank_idx),
//     est >  T      <=>  count(refs >  T) >= k
//     est <  T      <=>  count(refs >= T) <  k
//     cut > est*s   <=>  count(refs >= q) <  k,
// with q = ceil(cut / s) for integer maps (exact integer division) and, for
// float maps, the smallest float whose rounded product with s reaches the
// CUT (probed over the bit patterns just below cut / s).
//
// The decision is bit-identical to the plain twin (ops/cfar.py) on the same
// map: every float operation is written with the _rn intrinsics (no
// contraction into FMA, IEEE division), in the twin's order:
//   * per-cell mean = (full box - guard box) / n_ref, each box an inner sum
//     over rows ascending inside an outer sum over columns ascending;
//   * block sums: rows of a block ascending, then its columns ascending;
//     3x3-block neighbourhood Doppler-offset-major, range-offset-minor;
//   * columns wrap modulo D (or, in the reflect entries, mirror); grouping
//     ties go to the lower linear index.
// Integer maps: floor mean, t_hi = mean + (mean >> 1), t_lo = mean >> 1
// (fmcw_tpu/ops/cfar.py::cfar_2d, integer=True).
//
// A tile is E rows of D columns, row-major, whose rows are consecutive map
// rows (the caller wraps rows modulo R when it fills the tile); a cell's
// window must lie inside the tile's rows.
#pragma once

#include <cuda_runtime.h>

namespace fmcw {

struct CfarGeom {
    int hr, hd, gr, gd, n_ref, k;
    int scale_min, scale_nom, scale_max;
};

__device__ __forceinline__ int wrap_col(int c, int D) {
    return c < 0 ? c + D : (c >= D ? c - D : c);
}

// An index wrapped modulo n (any i), and numpy's "reflect" of index i into
// [0, n): the edge not repeated (-1 -> 1, n -> n - 2), periodic with period
// 2 (n - 1) beyond one mirror (indices that only a last block's discarded
// rows, or a bit plane's padding columns, reach).  The reflect entries of
// cfar_detect.cu, cfar_rank.cu and cfar_3d_detect.cu load their tiles
// through it.
__device__ __forceinline__ int wrap_mod(int i, int n) {
    const int r = i % n;
    return r < 0 ? r + n : r;
}

__device__ __forceinline__ int reflect_mod(int i, int n) {
    if (n == 1) return 0;
    const int j = wrap_mod(i, 2 * (n - 1));
    return j < n ? j : 2 * (n - 1) - j;
}

// reflect_mod within a single mirror (-n < c < 2 n - 1), without the
// division: a window column d + j with hd < D.
__device__ __forceinline__ int mirror_col(int c, int n) {
    return c < 0 ? -c : (c >= n ? 2 * (n - 1) - c : c);
}

// The map column of column x of a column chunk's tile (x counted from the
// chunk's first loaded column, which may lie before column 0 or past D - 1):
// wrapped modulo D, or numpy's "reflect" (the reflect entries).  The chunked
// entries of cfar_rank.cu, cfar_detect.cu and cfar_3d_detect.cu load a
// tile of T + 2 (hr + pgr) rows x W + 2 (hd + pgr) columns through it.
__device__ __forceinline__ int chunk_col(int x, int D, bool reflect) {
    if ((unsigned)x < (unsigned)D) return x;
    return reflect ? reflect_mod(x, D) : wrap_mod(x, D);
}

__device__ __forceinline__ float vadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ int vadd(int a, int b) { return a + b; }
__device__ __forceinline__ float vsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ int vsub(int a, int b) { return a - b; }

__device__ __forceinline__ int floor_div(int a, int b) {
    const int q = a / b;
    return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// Thresholds of the adaptive-scale classification from a sum over n cells.
__device__ __forceinline__ void scale_thresholds(float sum, int n, float& t_hi,
                                                 float& t_lo) {
    const float mean = __fdiv_rn(sum, (float)n);
    t_hi = __fmul_rn(1.5f, mean);
    t_lo = __fmul_rn(0.5f, mean);
}

__device__ __forceinline__ void scale_thresholds(int sum, int n, int& t_hi,
                                                 int& t_lo) {
    const int mean = floor_div(sum, n);
    t_hi = mean + (mean >> 1);
    t_lo = mean >> 1;
}

__device__ __forceinline__ int classify(int hi, int lo, int k,
                                        const CfarGeom& g) {
    return hi >= k ? g.scale_max : (lo < k ? g.scale_min : g.scale_nom);
}

// q with (ref >= q  <=>  ref * sc >= cut): the smallest float whose rounded
// product with sc reaches cut (within two ulps below RN(cut / sc)) ...
__device__ __forceinline__ float detect_threshold(float cut, int sc) {
    const float sf = (float)sc;
    const unsigned ti = (unsigned)__float_as_int(__fdiv_rn(cut, sf));
    float q = __int_as_float((int)(ti + 1u));
    for (int delta = 0; delta >= -2; --delta) {
        const float cand = __int_as_float((int)(ti + (unsigned)delta));
        if (__fmul_rn(cand, sf) >= cut) q = cand;
    }
    return q;
}

// ... and ceil(cut / sc) for integers (sc > 0).
__device__ __forceinline__ int detect_threshold(int cut, int sc) {
    return floor_div(cut - 1, sc) + 1;
}

// How a tile's CFAR statistics are computed.  MapSem<V>: in the map's own
// type (float maps: the _rn operations above; int maps: integer
// arithmetic).  IntInFloat: an integer map held in float, so that its
// compares count on the FMA pipe (cfar_tile.cuh).  Its values and column
// sums must stay below 2^24 (exact in float); box and block sums
// accumulate in int (Acc), and the thresholds are the integer semantics'
// (floor mean, mean + (mean >> 1), mean >> 1, ceil(cut / sc)), converted
// exactly: every compare is then the integer one.
template <typename V>
struct MapSem {
    using Acc = V;
    __device__ static V acc(V v) { return v; }
    __device__ static void thresholds(V sum, int n, V& t_hi, V& t_lo) {
        scale_thresholds(sum, n, t_hi, t_lo);
    }
    __device__ static V q(V cut, int sc) { return detect_threshold(cut, sc); }
};

struct IntInFloat {
    using Acc = int;
    __device__ static int acc(float v) { return __float2int_rn(v); }
    __device__ static void thresholds(int sum, int n, float& t_hi,
                                      float& t_lo) {
        int hi, lo;
        scale_thresholds(sum, n, hi, lo);
        t_hi = __int2float_rn(hi);
        t_lo = __int2float_rn(lo);
    }
    __device__ static float q(float cut, int sc) {
        return __int2float_rn(detect_threshold(__float2int_rn(cut), sc));
    }
};

// Block (clutter-map) scale of the block rows of an E x D tile whose
// 3x3-block neighbourhood lies inside it (block rows 2 .. E/sb - 3).  The
// tile's first row must start a block.  bsum/bnb hold E/sb * D/sb sums
// (Sem::Acc), bhi/blo/bscale as many ints; bscale[lb * (D/sb) + db] is the
// result.  All threads of the block call it.
template <typename V, typename Sem = MapSem<V>>
__device__ void block_scale_tile(const V* mag_s, int E, int D, int sb,
                                 int n_blk, int k_blk, const CfarGeom& g,
                                 typename Sem::Acc* bsum,
                                 typename Sem::Acc* bnb, int* bhi, int* blo,
                                 int* bscale) {
    using A = typename Sem::Acc;
    const int nbd = D / sb;
    const int nbr = E / sb;
    const int nblk = nbr * nbd;
    for (int idx = threadIdx.x; idx < nblk; idx += blockDim.x) {
        const int lb = idx / nbd, db = idx % nbd;
        A s = A(0);
        for (int j = 0; j < sb; ++j) {
            const V* col = mag_s + lb * sb * D + db * sb + j;
            A rs = Sem::acc(col[0]);
            for (int i = 1; i < sb; ++i) rs = vadd(rs, Sem::acc(col[i * D]));
            s = (j == 0) ? rs : vadd(s, rs);
        }
        bsum[idx] = s;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < nblk; idx += blockDim.x) {
        const int lb = idx / nbd, db = idx % nbd;
        if (lb < 1 || lb >= nbr - 1) continue;
        A acc = A(0);
        bool first = true;
        for (int di = -1; di <= 1; ++di) {
            const int dbn = (db + di + nbd) % nbd;
            for (int dr = -1; dr <= 1; ++dr) {
                const A v = bsum[(lb + dr) * nbd + dbn];
                acc = first ? v : vadd(acc, v);
                first = false;
            }
        }
        bnb[idx] = acc;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < nblk; idx += blockDim.x) {
        const int lb = idx / nbd, db = idx % nbd;
        if (lb < 1 || lb >= nbr - 1) continue;
        A t_hi, t_lo;
        scale_thresholds(bnb[idx], n_blk, t_hi, t_lo);
        int hi = 0, lo = 0;
        for (int i = 0; i < sb; ++i) {
            const V* row = mag_s + (lb * sb + i) * D + db * sb;
            for (int j = 0; j < sb; ++j) {
                const A v = Sem::acc(row[j]);
                hi += v > t_hi;
                lo += v >= t_lo;
            }
        }
        bhi[idx] = hi;
        blo[idx] = lo;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < nblk; idx += blockDim.x) {
        const int lb = idx / nbd, db = idx % nbd;
        if (lb < 2 || lb >= nbr - 2) continue;
        int hi = 0, lo = 0;
        for (int di = -1; di <= 1; ++di) {
            const int dbn = (db + di + nbd) % nbd;
            for (int dr = -1; dr <= 1; ++dr) {
                hi += bhi[(lb + dr) * nbd + dbn];
                lo += blo[(lb + dr) * nbd + dbn];
            }
        }
        bscale[idx] = classify(hi, lo, k_blk, g);
    }
    __syncthreads();
}

// Peak grouping: is the detection m at det_s row er (map row r), column d
// the strict maximum of its (2 pgr + 1)^2 wrapped neighbourhood, ties going
// to the lower linear index?
template <typename V>
__device__ __forceinline__ bool group_keep(const V* det_s, int D, int er,
                                           int r, int d, int R, int pgr,
                                           V m) {
    const int id = r * D + d;
    for (int dr = -pgr; dr <= pgr; ++dr) {
        const int nr = ((r + dr) % R + R) % R;
        for (int dd = -pgr; dd <= pgr; ++dd) {
            if (dr == 0 && dd == 0) continue;
            const int ndc = wrap_col(d + dd, D);
            const V v = det_s[(er + dr) * D + ndc];
            if (v > m || (v == m && nr * D + ndc < id)) return false;
        }
    }
    return true;
}

// Order-preserving int image of a non-negative value (for atomicMax).
__device__ __forceinline__ int ordered(float v) { return __float_as_int(v); }
__device__ __forceinline__ int ordered(int v) { return v; }
__device__ __forceinline__ void from_ordered(int b, float* out) {
    *out = __int_as_float(b);
}
__device__ __forceinline__ void from_ordered(int b, int* out) { *out = b; }
__device__ __forceinline__ bool nonfinite(float v) { return !isfinite(v); }
__device__ __forceinline__ bool nonfinite(int) { return false; }

// A chunk's row maximum (ordered int image, 0 where the chunk's row has no
// detection) into a row of row_max, which the caller zeroed: the chunks of
// a row combine by atomicMax on the ordered image (float maps: on the
// float bits; det is never negative or NaN).
template <typename V>
__device__ __forceinline__ void merge_row_max(V* row_max, int ord) {
    if (ord) atomicMax(reinterpret_cast<int*>(row_max), ord);
}

// Grouping and stores of a kernel tile's T rows (map rows r0 .. r0+T-1):
// det_s holds the decisions of map rows r0-pgr .. r0+T+pgr-1, mag_s the
// magnitudes with the tile's first row at mag_s row H.  Writes det (and
// mag when non-null) at out0, converted to the output type O, the row
// maxima into rmax_s[T] (ordered ints of V, zeroed by the caller) and adds
// the detection and non-finite counts into counts[0] and counts[1].
template <typename V, typename O>
__device__ void group_store(const V* det_s, const V* mag_s, int T, int H,
                            int pgr, int R, int D, int r0, size_t out0,
                            O* det, O* mag, int* rmax_s, int* counts) {
    int my_dets = 0, my_nf = 0;
    for (int idx = threadIdx.x; idx < T * D; idx += blockDim.x) {
        const int t = idx / D;
        const int d = idx % D;
        const int er = t + pgr;
        const V m = det_s[er * D + d];
        V out = m;
        if (pgr > 0 && m > V(0) &&
            !group_keep(det_s, D, er, r0 + t, d, R, pgr, m))
            out = V(0);
        det[out0 + idx] = static_cast<O>(out);
        if (out > V(0)) {
            ++my_dets;
            atomicMax(&rmax_s[t], ordered(out));
        }
        const V mg = mag_s[(H + t) * D + d];
        if (nonfinite(mg)) ++my_nf;
        if (mag) mag[out0 + idx] = static_cast<O>(mg);
    }
    if (my_dets) atomicAdd(&counts[0], my_dets);
    if (my_nf) atomicAdd(&counts[1], my_nf);
}

// Grouping and stores of a column chunk's T x W cells (map rows r0 ..
// r0 + T - 1, map columns c0 .. c0 + W - 1): det_s (T + 2 pgr rows at a
// pitch of `pitch` values) holds from tile column col0 on the decisions of
// map rows r0 - pgr .. and map columns c0 - pgr .. (wrapped modulo D), so
// every neighbour lies in it unwrapped.  As group_store (the strict maximum
// of the (2 pgr + 1)^2 wrapped neighbourhood, ties to the lower linear
// index of the map), with global row ids row_id0 + t (a range shard's,
// wrapping modulo r_total), storing only columns below D (a ragged last
// chunk); det points at the chunk's first map row (row t at det + t D),
// the row maxima go into rmax_s[T] (ordered ints, zeroed by the caller),
// the detection count into counts[0].
template <typename V, typename O>
__device__ void group_store_chunk(const V* det_s, int pitch, int col0, int T,
                                  int W, int pgr, int r_total, int D,
                                  int row_id0, int c0, O* det, int* rmax_s,
                                  int* counts) {
    const int wn = min(W, D - c0);              // columns stored
    int my_dets = 0;
    for (int idx = threadIdx.x; idx < T * wn; idx += blockDim.x) {
        const int t = idx / wn;
        const int j = idx - t * wn;
        const V* cell = det_s + (t + pgr) * pitch + col0 + pgr + j;
        const V m = *cell;
        V out = m;
        if (pgr > 0 && m > V(0)) {
            const int r = row_id0 + t, d = c0 + j;
            const int id = r * D + d;
            for (int dr = -pgr; dr <= pgr && out > V(0); ++dr) {
                const int nr = wrap_mod(r + dr, r_total);
                for (int dd = -pgr; dd <= pgr; ++dd) {
                    if (dr == 0 && dd == 0) continue;
                    const V v = cell[dr * pitch + dd];
                    const int nid = nr * D + wrap_mod(d + dd, D);
                    if (v > m || (v == m && nid < id)) {
                        out = V(0);
                        break;
                    }
                }
            }
        }
        det[(size_t)t * D + c0 + j] = static_cast<O>(out);
        if (out > V(0)) {
            ++my_dets;
            atomicMax(&rmax_s[t], ordered(out));
        }
    }
    if (my_dets) atomicAdd(&counts[0], my_dets);
}

}  // namespace fmcw
