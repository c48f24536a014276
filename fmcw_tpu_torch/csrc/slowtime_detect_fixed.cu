// Fixed-point slow-time half of the radar front-end on Hopper: saturating
// MTI, Q15 Doppler window with saturation count, Doppler FFT, block-
// floating-point quantization per range bin, integer magnitude, integer 2D
// CFAR (OS, or CA / GO / SO) and peak grouping on a tile of range rows.
//
// Replaces the slow-time half of fmcw_tpu/ops/frontend_pallas.py::
// _kernel_fixed (steps 6-10: quantized range rows through the saturating
// MTI and the integer Doppler window, the Doppler DFT, BFP per range bin,
// alpha-max-beta-min magnitude, the integer CFAR epilogues _block_scale /
// _detect_epilogue with integer=True, _peak_group_epilogue, row maxima,
// n_dets and the saturation count) and its split counterpart
// fmcw_tpu/ops/split_frontend.py::_kernel_slowtime_fixed: the split entry
// point fmcw_slowtime_detect_fixed_split takes a range shard of a frame and
// the H rows beyond each of its edges, exchanged from the neighbouring
// shards (slowtime_common.cuh), and breaks grouping ties by global row ids.
// The Doppler window's saturations are counted on the tile's own rows
// only: a halo row is counted by the tile (or shard) that owns it.
//
// In:  int16 re/im planes, range-major (B, R, ND), from range_fft_fixed.cu;
//      the int32 Q15 Doppler window (ND,); the float64 twiddles tw[m] =
//      W_ND^m (ops/fft.twiddles64: exact at the quarter turns).
// Out: det int32 (B, R, ND) zero-suppressed detections, row_max int32
//      (B, R), n_dets and sat (B,) int32 (sat: the Doppler window's
//      saturated samples of the tile's own rows, I and Q counted
//      separately), and the int32 magnitude map (B, R, ND) when asked for.
//
// Kernel B's design (slowtime_detect.cu) with the fixed chain's integer
// semantics.  One block of 384 threads per (frame, tile of T range rows),
// two blocks an SM (two per-cell tiles of 1024 x 128, 110,860 B each, fit
// the SM's 228 KB): the warps take the tile's E = T + 2H rows (per-cell H
// = halo_range + peak_group_radius, block scale H = (ceil(pgr / sb) + 2)
// sb; slowtime_common.cuh), each row's chain on the L = min(32, ND) lanes
// of a lane group (P = ND / L chirps a lane, chirp s = l P + p;
// slowtime_row):
//   1. the saturating MTI in int32 (x[s] - x[s-1], or x[s] - 2 x[s-1] +
//      x[s-2], clipped to int16; the chirps before a lane's first from its
//      neighbours by shuffle; missing history reads 0, "zero" zeroes the
//      first notch - 1 outputs; runtime bypass), the Q15 window
//      (fmcw::window_q15, both roundings; saturations counted on the
//      tile's own rows);
//   2. conversion to FP64 (exact), an L-point radix-2 DIF across the lanes
//      by xor shuffles (the lower lane of a pair takes a + b, the upper (b
//      - a) W_2h^(l mod h)), the twiddles W_ND^(p k1) (k1 =
//      bit_reverse(l)), a P-point transform in registers: lane l holds
//      X[k1 + L k2], k2 < P.  FP64, as range_fft_fixed.cu: in FP32 the
//      pre-BFP values (up to ~5e6) move by 1 LSB near a rounding boundary;
//      in FP64 a value lands on the golden model's side of every boundary
//      it does not sit on exactly;
//   3. the eighth-turn bins k = m ND/8 (m odd) recomputed exactly, before
//      the BFP peak (which reads them; eighth_bin);
//   4. the BFP exponent from the row's peak (a max over the lane group,
//      fmcw::bfp_scale), round half to even and clip (fmcw::bfp_quantize),
//      the magnitude max + (min >> 2) + (min >> 3) into the shared tile.
// Every FP64 operation is an explicit _rn intrinsic, so a row's values are
// the same instruction sequence in every entry and tile (the split entry is
// bit-equal to the whole-frame launch).
//
// The exact bins.  Values that can sit exactly on a half-LSB tie of the
// BFP rounding are those the golden model (np.fft.fft of integers)
// computes as exact integers: the quarter-turn bins k = m ND/4 and the
// eighth-turn bins whose sqrt(2)/2 terms cancel.
//  * Quarter turns: k1 = k mod L is a multiple of L/4, so bit_reverse(k1)
//    = l < 4: on its path through the DIF the lane is the lower one (a
//    sum) at every stage h >= 4, and the upper one only at h = 2 (W_4^(l
//    mod 2), 1 or -i) and h = 1 (W_2^0 = 1).  Its twiddle W_ND^(p k1) is 1
//    (P = 1, or k1 = 0 at P = 4) or W_4^p (P = 2, k1 = L/2); the P-point
//    transform (P <= 4) multiplies by +-1 and +-i only.  Products with the
//    table's exact 0 and +-1 are exact (fma(a, 1, -(b 0)) = a), so those
//    bins are exact integers, as the golden model's.
//  * Eighth turns: X[m ND/8] = E + c P, c = cos(pi/4), E and P Gaussian
//    integers (ops/fft._eighth_turn_bins); the FFT's separately rounded c
//    products need not cancel where P = 0.  So the lanes that hold those
//    bins (k1 an odd multiple of ND/8 mod ND/4: lane 1 at ND = 128, lanes 2
//    and 3 at 64, lanes 4..7 at 32 and 16) recompute them from exact
//    integers: at P >= 2 from their own DIF outputs Y_p[k1] before the
//    twiddle (exact: k1 is a multiple of L/4, the path above), X = sum_p
//    Y_p W_8^(p m); at P = 1 from the class sums u_r = T_r - T_(r+4) (T_r
//    the windowed chirps s = r mod 8; warp sums of integers).  E and P in
//    int32, then E + RN(c P) in FP64, the twin's operations.
//
// The decision is cfar_tile.cuh on the shared tile, as kernel B's: column
// sums once per tile, strips of 8 cells a thread, hi and lo packed in one
// count; block scale by block_scale_tile; then group_store.  The integer
// magnitudes are held in float (fmcw::IntInFloat): they are at most 32768
// + 8192 + 4096 = 45,056 and a column sum at most 128 of them (the tile's
// rows), 5.8e6, below 2^24 and exact; box and block sums accumulate in
// int, and the thresholds are the integer semantics' (floor mean, mean +
// (mean >> 1), mean >> 1, ceil(cut / sc)) converted exactly, so every
// compare is the integer one.
// So each compare is one FSET and its count an add on the FMA pipe, as
// kernel B counts, where integer counts would take the integer pipe
// twice.  Bit-identical to the plain integer CFAR and grouping
// (ops/cfar.py) on the same magnitudes.
//
// The CA/GO/SO variants (_detect_epilogue with integer=True,
// frontend_pallas.py:466-507, and split_frontend.py:283-375) are a second
// instantiation (kMean), as kernel B's: cfar_tile.cuh's window-mean
// epilogue on the same tile with IntInFloat, column and row sums in float
// (exact), the boxes and halves summed in int, floor means and the
// decision est < ceil(cut / sc).  It counts nothing, so no packed-count
// limit on n_ref, and its int sums are exact for every window (JAX's
// fused kernel carries them in float32, below 2^24 only).
//
// Bound on an H100: operations (the CFAR's compares, then the FP64 FFT);
// the bytes are 0.5 MiB in and 0.5 MiB out per 1024x128 frame.
//
// Long CPIs (ND = n2d x 128, 2 <= n2d <= 16): the long-CPI Doppler split of
// the TPU kernels (frontend_pallas.py _kernel_fixed :835-840 and its n2d >
// 1 branch :971-1006, split_frontend.py _kernel_slowtime_fixed :640-642
// and :709-733).  Every entry runs two launches there, as kernel B's:
// slowtime_map_kernel writes the int32 magnitude map, one warp a row
// (split_row<128>: the MTI and window over the whole row, then per class
// k2 the outer DFT_n2d, the twiddle W_ND^(j1 k2) and the short rows' 128-
// point lane transform, the spectrum class-major in shared memory; the
// BFP exponent from the whole row's peak; natural-order stores), then
// slowtime_long.cuh's decide kernel decides it on IntInFloat tiles of T
// rows x a chunk of W columns.  The exact quarter- and eighth-turn bins
// all lie on class 0, whose outer DFT is a sum of integers (split_row);
// where 3 divides n2d, the sixth- and twelfth-turn bins (cos and sin
// half-integers or multiples of sqrt(3)/2) are recomputed exactly from
// class sums (twelfth_bins), in the kernel and its twin alike.
// Sixteenth-turn bins (k = m ND/16, m odd, at n2d >= 2) and the n2d-th
// turns of n2d = 5, 7, ... are not treated as exact, as the short rows'
// sixteenth turns are not.
//
// Dense lengths (fmcw::dense_cpi: ND a multiple of 8 below 2048 that is
// neither a short row nor a long CPI, 8, 24, 40 .. 2040): the dense
// slow-time operator of the TPU kernels (the n2d == 1 branch of
// _kernel_fixed, frontend_pallas.py:958-965, and of _kernel_slowtime_fixed,
// split_frontend.py:700-706, which contract the chirp axis with the dense
// DFT matrix).  Here the same two launches, the map from split_row<m>:
// ND = o x m with m = ND & -ND (8 .. 64) and o = ND / m odd (1 .. 255),
// kernel B's dense_row plan in FP64 (the outer DFT_o as direct sums over
// the blocks of m chirps, the twiddle W_ND^(j1 k2), an m-point lane
// transform, G = 32 / min(32, m) classes a warp at once, bin q of class k2
// at Doppler bin o q + k2).  Its exact bins: every quarter- and eighth-turn
// bin j ND/8 lies on class 0 (o divides ND/8, since 8 | m), whose outer sums
// are integers below 255 x 32768 < 2^23 and whose eighth-turn E and P stay
// below 2040 x 32768 < 2^27 in int32; at m = 8 .. 32 (one point a lane)
// class 0's eighth-turn lanes take their class sums over their own group of
// L lanes.  Where 3 divides o (80 of the 237 lengths, 24, 96, 120 .. 2040)
// 12 divides ND and the twelve bins j ND/12 lie on classes 0, o/3 and 2o/3,
// recomputed from the chirps' class sums mod 12 (twelfth_bins at the class
// pitch).  So the map equals the twin's dense FP64 product (with ops/fft.
// _eighth_turn_bins and _twelfth_turn_bins) bit for bit.  Its cost: the
// direct sums take o - 1 complex FP64 multiply-adds a sample (126 at 1016,
// 254 at 2040) against the ~log2(ND) of an FFT that the bound counts, and
// the map's extra write and read (8 B a cell).  Shared memory: o x (m +
// pad) double2 and 2 ND int16 a warp, 44,880 B at 2040, four warps a block
// (179,520 B, one block an SM).

#include <cuda_runtime.h>
#include <stdint.h>

#include "cfar_common.cuh"
#include "cfar_tile.cuh"
#include "fixed_point.cuh"
#include "slowtime_common.cuh"
#include "slowtime_long.cuh"

namespace {

using fmcw::kInner;
using fmcw::kMaxBlk;
using fmcw::kMaxSmem;
using fmcw::long_cpi;
using fmcw::Row;
using Mag = float;                      // the tile: integers held in float
using Sem = fmcw::IntInFloat;
constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr int kLongWarps = 4;           // long-CPI magnitude kernel
constexpr int kLongBlocks = 8192;       // its grid (rows striding)
constexpr unsigned kFull = 0xffffffffu;
// cos(pi/4) = ops/fft.twiddles64(8)[1].real.
constexpr double kC8 = 0x1.6a09e667f3bcdp-1;
// sqrt(3)/2 rounded to nearest = ops/fft.C3.
constexpr double kC3 = 0x1.bb67ae8584caap-1;

struct Params {
    const int16_t* xr;
    const int16_t* xi;
    const int16_t* lo_r;            // split entry: H exchanged rows below
    const int16_t* lo_i;            // and above the shard, (B, H, ND);
    const int16_t* hi_r;            // null: rows wrap within the frame
    const int16_t* hi_i;
    const int* win;
    const double2* tw;
    int* det;
    int* mag;
    int* row_max;
    int* n_dets;
    int* sat;
    SlowtimeConfig c;
};

// ---------------------------------------------------------------------------
// The slow-time chain of one range row
// ---------------------------------------------------------------------------

// A lane's twiddles and window values are read per row (fmcw::ld_nc), not
// held in registers across it.
using fmcw::ld_nc;

// Chirps l P .. l P + P - 1 of an int16 row.
template <int P>
__device__ __forceinline__ void load_points(const int16_t* row, int l,
                                            int (&x)[P]) {
    if constexpr (P == 4) {
        const uint2 v = *reinterpret_cast<const uint2*>(row + 4 * l);
        x[0] = (int16_t)(v.x & 0xffffu);
        x[1] = (int16_t)(v.x >> 16);
        x[2] = (int16_t)(v.y & 0xffffu);
        x[3] = (int16_t)(v.y >> 16);
    } else if constexpr (P == 2) {
        const unsigned v = *reinterpret_cast<const unsigned*>(row + 2 * l);
        x[0] = (int16_t)(v & 0xffffu);
        x[1] = (int16_t)(v >> 16);
    } else {
        x[0] = row[l];
    }
}

// (a + i b)(c + i d) as the twin's model writes it: re = fma(a, c, -(b d)),
// im = fma(a, d, b c).
__device__ __forceinline__ void cmul(double& re, double& im, double2 w) {
    const double a = re, b = im;
    re = __fma_rn(a, w.x, -__dmul_rn(b, w.y));
    im = __fma_rn(a, w.y, __dmul_rn(b, w.x));
}

// X = u0 + (-i)^m u2 + W_8^m u1 + W_8^(3m) u3 (m odd) as E + c P with E and
// P exact integers (ops/fft._eighth_turn_bins): u = {u0r, u0i, u1r, u1i,
// u2r, u2i, u3r, u3i}.
__device__ __forceinline__ void eighth_bin(const int (&u)[8], int m,
                                           double& xr, double& xi) {
    // W_8^k / c = a + i b for k odd.
    const int k1 = m & 7, k3 = (3 * m) & 7;
    const int a1 = k1 == 1 || k1 == 7 ? 1 : -1;
    const int b1 = k1 == 5 || k1 == 7 ? 1 : -1;
    const int a3 = k3 == 1 || k3 == 7 ? 1 : -1;
    const int b3 = k3 == 5 || k3 == 7 ? 1 : -1;
    const int g = (m & 3) == 1 ? 1 : -1;
    const int pr = a1 * u[2] - b1 * u[3] + (a3 * u[6] - b3 * u[7]);
    const int pi = a1 * u[3] + b1 * u[2] + (a3 * u[7] + b3 * u[6]);
    const int er = u[0] + g * u[5];
    const int ei = u[1] - g * u[4];
    xr = __dadd_rn((double)er, __dmul_rn(kC8, (double)pr));
    xi = __dadd_rn((double)ei, __dmul_rn(kC8, (double)pi));
}

// The lane transform of an N-point row held P = N / L points a lane (point
// s = l P + p, L = min(32, N); all 32 lanes of the warp call it together),
// in FP64: the L-point radix-2 DIF across the lanes, the twiddles W_N^(p
// k1) (k1 = bit_reverse(l)) and the P-point transform.  tw[stride m] =
// W_N^m (the whole row's table: stride 1, or n2d for a long row's inner
// transform).  Lane l ends with X[k1 + L k2], k2 < P, in (xo, yo).  With
// exact_bins, the eighth-turn bins k = m N/8 (m odd) are recomputed
// exactly (eighth_bin) from u: the class sums given at P = 1, the lane's
// own DIF outputs at P >= 2 (exact integers for integer inputs: k1 is a
// multiple of L/4, on the quarter-turn path).
template <int N>
__device__ __forceinline__ void lane_dft(double (&yr)[Row<N>::P],
                                         double (&yi)[Row<N>::P],
                                         const double2* tw, int stride,
                                         int l, bool exact_bins, int (&u)[8],
                                         double (&xo)[Row<N>::P],
                                         double (&yo)[Row<N>::P]) {
    using R = Row<N>;
    constexpr int P = R::P, L = R::L;
    const int k1 = (int)(__brev((unsigned)l) >> (32 - R::kLog2L));
    const bool eighth = exact_bins && (k1 & (N / 4 - 1)) == N / 8;
    // The L-point DIF across the lanes, one transform per p: lane l ends
    // with bin k1 of each.
#pragma unroll
    for (int st = 0; st < R::kLog2L; ++st) {
        const int h = L >> (st + 1);
        const bool upper = (l & h) != 0;
        const double2 w = ld_nc(tw + (l & (h - 1)) * (N / (2 * h)) * stride);
#pragma unroll
        for (int p = 0; p < P; ++p) {
            const double br = __shfl_xor_sync(kFull, yr[p], h, L);
            const double bi = __shfl_xor_sync(kFull, yi[p], h, L);
            if (upper) {
                yr[p] = __dsub_rn(br, yr[p]);
                yi[p] = __dsub_rn(bi, yi[p]);
                cmul(yr[p], yi[p], w);
            } else {
                yr[p] = __dadd_rn(yr[p], br);
                yi[p] = __dadd_rn(yi[p], bi);
            }
        }
    }
    // At P >= 2 an eighth-turn lane's Y_p[k1] are exact integers: X[k1 + L
    // k2] = sum_p Y_p W_8^(p m), so u_p = Y_p (P = 4) or u = {Y_0, Y_1, 0,
    // 0} (P = 2).
    if constexpr (P >= 2) {
        if (eighth) {
#pragma unroll
            for (int p = 0; p < P; ++p) {
                u[2 * p] = __double2int_rn(yr[p]);
                u[2 * p + 1] = __double2int_rn(yi[p]);
            }
        }
    }
    //    X[k1 + L k2] = sum_p Y_p[k1] W_N^(p k1) W_P^(p k2).
#pragma unroll
    for (int p = 1; p < P; ++p)
        cmul(yr[p], yi[p], ld_nc(tw + p * k1 * stride));
    if constexpr (P == 1) {
        xo[0] = yr[0];
        yo[0] = yi[0];
    } else if constexpr (P == 2) {
        xo[0] = __dadd_rn(yr[0], yr[1]);
        yo[0] = __dadd_rn(yi[0], yi[1]);
        xo[1] = __dsub_rn(yr[0], yr[1]);
        yo[1] = __dsub_rn(yi[0], yi[1]);
    } else {
        const double s0r = __dadd_rn(yr[0], yr[2]), s0i = __dadd_rn(yi[0], yi[2]);
        const double d0r = __dsub_rn(yr[0], yr[2]), d0i = __dsub_rn(yi[0], yi[2]);
        const double s1r = __dadd_rn(yr[1], yr[3]), s1i = __dadd_rn(yi[1], yi[3]);
        const double d1r = __dsub_rn(yr[1], yr[3]), d1i = __dsub_rn(yi[1], yi[3]);
        xo[0] = __dadd_rn(s0r, s1r);
        yo[0] = __dadd_rn(s0i, s1i);
        xo[1] = __dadd_rn(d0r, d1i);
        yo[1] = __dsub_rn(d0i, d1r);
        xo[2] = __dsub_rn(s0r, s1r);
        yo[2] = __dsub_rn(s0i, s1i);
        xo[3] = __dsub_rn(d0r, d1i);
        yo[3] = __dadd_rn(d0i, d1r);
    }
    // The eighth-turn bins, exactly: bin k1 + L k2 = m N / 8.
    if (eighth) {
#pragma unroll
        for (int k2 = 0; k2 < P; ++k2)
            eighth_bin(u, (k1 + L * k2) / (N / 8), xo[k2], yo[k2]);
    }
}

// The exact parts u of the eighth-turn bins of an L-point transform held one
// integer point (tr, ti) a lane (all 32 lanes call it, L lanes a group):
// the class sums T_r (r = l mod 8) over the lane group, u_r = T_r -
// T_(r+4) on lanes r < 4, gathered from them.
template <int L>
__device__ __forceinline__ void eighth_sums(int tr, int ti, int (&u)[8]) {
#pragma unroll
    for (int o = L / 2; o >= 8; o >>= 1) {
        tr += __shfl_xor_sync(kFull, tr, o, L);
        ti += __shfl_xor_sync(kFull, ti, o, L);
    }
    const int ur = tr - __shfl_xor_sync(kFull, tr, 4, L);
    const int ui = ti - __shfl_xor_sync(kFull, ti, 4, L);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        u[2 * j] = __shfl_sync(kFull, ur, j, L);
        u[2 * j + 1] = __shfl_sync(kFull, ui, j, L);
    }
}

// The magnitude max + (min >> 2) + (min >> 3) of a bin quantized with the
// BFP scale sc (magnitude_calc.vhd:70-88).
__device__ __forceinline__ int int_magnitude(double xr, double xi,
                                             double sc) {
    const int ar = abs(fmcw::bfp_quantize(xr, sc));
    const int ai = abs(fmcw::bfp_quantize(xi, sc));
    const int mx = ar > ai ? ar : ai;
    const int mn = ar > ai ? ai : ar;
    return mx + (mn >> 2) + (mn >> 3);
}

// The fixed slow-time chain of the row (rr, ri) on the L lanes l = 0 .. L-1
// of a lane group (all 32 lanes of the warp call it together): lane l holds
// chirps s = l P + p.  Calls sink(k, magnitude) for its P Doppler bins k =
// k1 + L k2, k1 = bit_reverse(l); returns the lane's Doppler-window
// saturations.
template <int ND, typename Sink>
__device__ __forceinline__ int slowtime_row(const int16_t* rr,
                                            const int16_t* ri, const int* win,
                                            const double2* tw, int l,
                                            const SlowtimeConfig& c,
                                            Sink sink) {
    using R = Row<ND>;
    constexpr int P = R::P, L = R::L;
    int xr[P], xi[P];
    load_points<P>(rr, l, xr);
    load_points<P>(ri, l, xi);
    // 1. Saturating pulse canceller: the chirps just before the lane's
    //    first come from the lower lanes; missing history reads 0.
    if (!c.bypass) {
        int p1r = __shfl_up_sync(kFull, xr[P - 1], 1, L);
        int p1i = __shfl_up_sync(kFull, xi[P - 1], 1, L);
        int p2r, p2i;
        if constexpr (P >= 2) {
            p2r = __shfl_up_sync(kFull, xr[P - 2], 1, L);
            p2i = __shfl_up_sync(kFull, xi[P - 2], 1, L);
            if (l < 1) p2r = p2i = 0;
        } else {
            p2r = __shfl_up_sync(kFull, xr[0], 2, L);
            p2i = __shfl_up_sync(kFull, xi[0], 2, L);
            if (l < 2) p2r = p2i = 0;
        }
        if (l < 1) p1r = p1i = 0;
#pragma unroll
        for (int p = P - 1; p >= 0; --p) {
            const int i1 = p >= 1 ? p - 1 : 0, i2 = p >= 2 ? p - 2 : 0;
            const int a1r = p >= 1 ? xr[i1] : p1r;
            const int a1i = p >= 1 ? xi[i1] : p1i;
            const int a2r = p >= 2 ? xr[i2] : (p == 1 ? p1r : p2r);
            const int a2i = p >= 2 ? xi[i2] : (p == 1 ? p1i : p2i);
            int yr, yi;
            if (c.notch_mode == 2) {
                yr = xr[p] - a1r;
                yi = xi[p] - a1i;
            } else {
                yr = xr[p] - 2 * a1r + a2r;
                yi = xi[p] - 2 * a1i + a2i;
            }
            yr = min(max(yr, -32768), 32767);
            yi = min(max(yi, -32768), 32767);
            if (c.transient_zero && l * P + p < c.notch_mode - 1) yr = yi = 0;
            xr[p] = yr;
            xi[p] = yi;
        }
    }
    //    The Q15 Doppler window.
    int sat = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
        const int w = ld_nc(win + l * P + p);
        int s;
        xr[p] = fmcw::window_q15(xr[p], w, c.rnd, c.shift, &s);
        sat += s;
        xi[p] = fmcw::window_q15(xi[p], w, c.rnd, c.shift, &s);
        sat += s;
    }
    // u: the exact parts of the lane's eighth-turn bins (eighth_bin).
    int u[8] = {};
    if constexpr (P == 1) eighth_sums<L>(xr[0], xi[0], u);
    // 2-3. FP64 (exact), the lane transform, the exact eighth-turn bins.
    double yr[P], yi[P], xo[P], yo[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
        yr[p] = (double)xr[p];
        yi[p] = (double)xi[p];
    }
    lane_dft<ND>(yr, yi, tw, 1, l, true, u, xo, yo);
    // 4. BFP over the row, quantize, integer magnitude.
    double pk = 0.0;
#pragma unroll
    for (int k2 = 0; k2 < P; ++k2)
        pk = fmax(pk, fmax(fabs(xo[k2]), fabs(yo[k2])));
    const double sc = fmcw::bfp_scale(fmcw::warp_max<L>(pk));
    const int k1 = (int)(__brev((unsigned)l) >> (32 - R::kLog2L));
#pragma unroll
    for (int k2 = 0; k2 < P; ++k2)
        sink(k1 + L * k2, int_magnitude(xo[k2], yo[k2], sc));
    return sat;
}

// ---------------------------------------------------------------------------
// The fixed slow-time chain of a long or dense row (ND = o x M)
// ---------------------------------------------------------------------------

// A two-launch length's inner transform M: 128 at a long CPI (o = n2d), ND
// & -ND (8 .. 64) at a dense length (o = ND / M, odd).
inline int inner_len(int nd) { return long_cpi(nd) ? kInner : nd & -nd; }

// The pitch, in complex values, of a class of a long or dense row's
// spectrum in shared memory: M bins and a pad, so that the eight lanes of
// a quarter-warp that read eight consecutive natural bins (classes k mod o,
// bins k / o) reach eight different 16-byte bank groups at o = 1, 2, 3, 4,
// 8 and 16 (and mostly above 8: an odd pitch).
__host__ __device__ inline int class_pitch(int m, int o) {
    return m + (8 + o - 1) / o;
}

// A warp's shared memory at a two-launch length ND = o x m: the spectrum (o
// classes of double2) and the windowed chirps (int16 I and Q); a multiple
// of 16 bytes (8 | ND).  ops/frontend_fixed.map_warp_bytes mirrors it.
__host__ __device__ inline size_t map_warp_bytes(int nd, int m) {
    const int o = nd / m;
    return (size_t)o * class_pitch(m, o) * sizeof(double2) +
           2 * (size_t)nd * sizeof(int16_t);
}

// W_12^j = cos(pi j / 6) - i sin(pi j / 6), its cos and sin each written
// c2 / 2 + c3 sqrt(3)/2: {c2 of the cos, c3 of the cos, c2 of the sin, c3
// of the sin} (ops/fft.W12_PARTS).
__constant__ int4 kW12[12] = {
    {2, 0, 0, 0},  {0, 1, 1, 0},   {1, 0, 0, 1},   {0, 0, 2, 0},
    {-1, 0, 0, 1}, {0, -1, 1, 0},  {-2, 0, 0, 0},  {0, -1, -1, 0},
    {-1, 0, 0, -1}, {0, 0, -2, 0}, {1, 0, 0, -1},  {0, 1, -1, 0}};

// The twelve bins k = m ND/12 (m = lane < 12) of a row that 12 divides (o
// a multiple of 3), exactly, over the transform's values in the spectrum
// spec (o classes at pitch `pitch`; ops/fft._twelfth_turn_bins): with T_r
// the windowed chirps (zr, zi) summed over s = r (mod 12), X = sum_r T_r
// W_12^(r m) = E / 2 + (sqrt(3)/2) B, E and B sums of integers (below
// 2^28 at ND = 2040), then E / 2 + RN(kC3 B) in FP64, the twin's
// operations.  Where B is 0 the part is the half-integer E / 2, a
// round-half tie of the BFP scaling that the transform's rounded twiddles
// need not give exactly.  All 32 lanes call it.
__device__ __forceinline__ void twelfth_bins(const int16_t* zr,
                                             const int16_t* zi, int nd,
                                             int l, int o, int pitch,
                                             double2* spec) {
    int tr = 0, ti = 0;
    if (l < 12) {
        for (int s = l; s < nd; s += 12) {
            tr += zr[s];
            ti += zi[s];
        }
    }
    int er = 0, ei = 0, br = 0, bi = 0;
    for (int r = 0; r < 12; ++r) {
        const int a = __shfl_sync(kFull, tr, r);
        const int b = __shfl_sync(kFull, ti, r);
        const int4 w = kW12[(r * l) % 12];
        er += w.x * a + w.z * b;
        ei += w.x * b - w.z * a;
        br += w.y * a + w.w * b;
        bi += w.y * b - w.w * a;
    }
    if (l < 12) {
        const double xr = __dadd_rn(0.5 * (double)er,
                                    __dmul_rn(kC3, (double)br));
        const double xi = __dadd_rn(0.5 * (double)ei,
                                    __dmul_rn(kC3, (double)bi));
        const int k = l * (nd / 12);
        spec[(k % o) * pitch + k / o] = make_double2(xr, xi);
    }
}

// acc += z w in the order (z.re w.re - z.im w.im) as two fmas each, as
// slowtime_detect.cu's long and dense rows.
__device__ __forceinline__ void cmac(double& ar, double& ai, double zr,
                                     double zi, double2 w) {
    ar = __fma_rn(zr, w.x, __fma_rn(-zi, w.y, ar));
    ai = __fma_rn(zr, w.y, __fma_rn(zi, w.x, ai));
}

// Chirps l P .. l P + P - 1 of an int16 row as doubles.
template <int P>
__device__ __forceinline__ void load_points64(const int16_t* row, int l,
                                              double (&x)[P]) {
    int v[P];
    load_points<P>(row, l, v);
#pragma unroll
    for (int q = 0; q < P; ++q) x[q] = (double)v[q];
}

// The fixed slow-time chain of a long or dense row (rr, ri) on the 32 lanes
// of a warp, ND = o x M, chirp s = M j2 + j1 (a long CPI: M = 128, o = n2d,
// JAX's long-CPI split; a dense length: M = ND & -ND, 8 .. 64, o = ND / M,
// odd, 1 .. 255, kernel B's dense_row plan), into the int32 magnitudes
// out[ND] (natural order); returns the lane's Doppler-window saturations:
//   1. the saturating MTI in int32 over the whole row in blocks of 128
//      chirps (lane l takes chirps s = 128 i + 4 l + q; the two chirps
//      before its first from the lane below, lane 0's from lane 31 of the
//      block before, at a long CPI, or read from the row at a dense
//      length, whose last block is partial), the Q15 window
//      (fmcw::window_q15) into the warp's int16 buffers zr / zi;
//   2. for the classes k2 = 0 .. o-1, G = 32 / L at a time (L = min(32, M)
//      lanes a class, P = M / L points a lane; lane group g = lane / L
//      takes k2 = k0 + g, and past o computes class o - 1 again and stores
//      nothing, so every lane stays in the shuffles), in FP64: lane l's
//      points j1 = l P + p of the outer DFT_o over the blocks, sum_j2 z[M
//      j2 + j1] W_o^(j2 k2) (j2 ascending, W_o^e = tw[e M], direct sums),
//      the twiddle W_ND^(j1 k2) (none at k2 = 0) and the M-point lane
//      transform (lane_dft<M>, stride o), whose bin q is the row's Doppler
//      bin o q + k2, stored class-major in spec (pitch class_pitch(M, o)).
//      The quarter- and eighth-turn bins k = j ND/8 are multiples of o (8 |
//      M): they lie on class 0, whose outer DFT is a sum of integers (W =
//      tw[0] = 1, exact) with no twiddle, so the short rows' exact-bin
//      argument and eighth_bin hold there (on class 0 only: the other
//      classes' inputs are not integers); at P = 1 class 0's u comes from
//      its class sums over the lane group (eighth_sums).  Class 0's sums
//      stay below 255 x 32768 (dense) or 16 x 32768 (long) and its
//      eighth-turn E and P below 2^27, inside int32;
//   3. where 3 divides o, the twelve bins m ND/12 (on classes 0, o/3 and
//      2o/3) recomputed exactly over the transform's (twelfth_bins);
//   4. the BFP exponent from the peak of the whole row, every class (JAX's
//      per-row peak across its parity planes), then quantization and the
//      integer magnitude of each natural bin k, read from class k mod o
//      (two passes over the spectrum).
// Every FP64 operation an _rn intrinsic, so a row is the same instruction
// sequence in every entry.  All 32 lanes call it.
template <int M>
__device__ __forceinline__ int split_row(const int16_t* rr, const int16_t* ri,
                                         const int* win, const double2* tw,
                                         int lane, const SlowtimeConfig& c,
                                         double2* spec, int16_t* zr,
                                         int16_t* zi, int* out) {
    using R = Row<M>;
    constexpr int P = R::P, L = R::L, G = R::G;
    const int nd = c.ND, o = nd / M;
    const int pitch = class_pitch(M, o);
    int sat = 0;
    int h1r = 0, h1i = 0, h2r = 0, h2i = 0;
#pragma unroll 1
    for (int b0 = 0; b0 < nd; b0 += 4 * 32) {
        const int s0 = b0 + 4 * lane;
        if (s0 >= nd) break;
        int xr[4], xi[4];
        load_points<4>(rr + b0, lane, xr);
        load_points<4>(ri + b0, lane, xi);
        if (!c.bypass) {
            int p1r = 0, p1i = 0, p2r = 0, p2i = 0;
            if constexpr (M == kInner) {
                // A long row's blocks are whole: the history from the lane
                // below, lane 0's from lane 31 of the block before.
                p1r = __shfl_up_sync(kFull, xr[3], 1);
                p1i = __shfl_up_sync(kFull, xi[3], 1);
                p2r = __shfl_up_sync(kFull, xr[2], 1);
                p2i = __shfl_up_sync(kFull, xi[2], 1);
                if (lane == 0) {
                    p1r = h1r; p1i = h1i; p2r = h2r; p2i = h2i;
                }
                h1r = __shfl_sync(kFull, xr[3], 31);
                h1i = __shfl_sync(kFull, xi[3], 31);
                h2r = __shfl_sync(kFull, xr[2], 31);
                h2i = __shfl_sync(kFull, xi[2], 31);
            } else if (s0 > 0) {
                // A dense row's last block is partial: from the row.
                p1r = rr[s0 - 1]; p1i = ri[s0 - 1];
                p2r = rr[s0 - 2]; p2i = ri[s0 - 2];
            }
#pragma unroll
            for (int q = 3; q >= 0; --q) {
                const int i1 = q >= 1 ? q - 1 : 0, i2 = q >= 2 ? q - 2 : 0;
                const int a1r = q >= 1 ? xr[i1] : p1r;
                const int a1i = q >= 1 ? xi[i1] : p1i;
                const int a2r = q >= 2 ? xr[i2] : (q == 1 ? p1r : p2r);
                const int a2i = q >= 2 ? xi[i2] : (q == 1 ? p1i : p2i);
                int yr, yi;
                if (c.notch_mode == 2) {
                    yr = xr[q] - a1r;
                    yi = xi[q] - a1i;
                } else {
                    yr = xr[q] - 2 * a1r + a2r;
                    yi = xi[q] - 2 * a1i + a2i;
                }
                yr = min(max(yr, -32768), 32767);
                yi = min(max(yi, -32768), 32767);
                if (c.transient_zero && s0 + q < c.notch_mode - 1)
                    yr = yi = 0;
                xr[q] = yr;
                xi[q] = yi;
            }
        }
        unsigned pr[2], pi[2];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int w = ld_nc(win + s0 + q);
            int s;
            xr[q] = fmcw::window_q15(xr[q], w, c.rnd, c.shift, &s);
            sat += s;
            xi[q] = fmcw::window_q15(xi[q], w, c.rnd, c.shift, &s);
            sat += s;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            pr[h] = (xr[2 * h] & 0xffffu) | ((unsigned)xr[2 * h + 1] << 16);
            pi[h] = (xi[2 * h] & 0xffffu) | ((unsigned)xi[2 * h + 1] << 16);
        }
        *reinterpret_cast<uint2*>(zr + s0) = make_uint2(pr[0], pr[1]);
        *reinterpret_cast<uint2*>(zi + s0) = make_uint2(pi[0], pi[1]);
    }
    __syncwarp();
    const int g = lane / L, l = lane % L;
    const int k1 = (int)(__brev((unsigned)l) >> (32 - R::kLog2L));
#pragma unroll 1
    for (int k0 = 0; k0 < o; k0 += G) {
        const bool own = k0 + g < o;
        const int k2 = own ? k0 + g : o - 1;
        double yr[P], yi[P];
        load_points64<P>(zr, l, yr);
        load_points64<P>(zi, l, yi);
        int e = 0;
#pragma unroll 2
        for (int j2 = 1; j2 < o; ++j2) {
            e += k2;
            if (e >= o) e -= o;
            const double2 w = ld_nc(tw + e * M);
            double br[P], bi[P];
            load_points64<P>(zr + j2 * M, l, br);
            load_points64<P>(zi + j2 * M, l, bi);
#pragma unroll
            for (int q = 0; q < P; ++q) cmac(yr[q], yi[q], br[q], bi[q], w);
        }
        if (k2 > 0) {
#pragma unroll
            for (int q = 0; q < P; ++q)
                cmul(yr[q], yi[q], ld_nc(tw + (l * P + q) * k2));
        }
        // Class 0's outer sums are integers: at P = 1 its eighth-turn lanes
        // read their class sums (every group runs the shuffles; only class
        // 0 reads u).
        int u[8] = {};
        if constexpr (P == 1)
            eighth_sums<L>(__double2int_rn(yr[0]), __double2int_rn(yi[0]),
                           u);
        double xo[P], yo[P];
        lane_dft<M>(yr, yi, tw, o, l, k2 == 0, u, xo, yo);
        if (own) {
            double2* cls = spec + k2 * pitch;
#pragma unroll
            for (int q = 0; q < P; ++q)
                cls[k1 + L * q] = make_double2(xo[q], yo[q]);
        }
    }
    __syncwarp();
    if (o % 3 == 0) twelfth_bins(zr, zi, nd, lane, o, pitch, spec);
    __syncwarp();
    double pk = 0.0;
    for (int k = lane; k < nd; k += 32) {
        const double2 v = spec[(k % o) * pitch + k / o];
        pk = fmax(pk, fmax(fabs(v.x), fabs(v.y)));
    }
    const double sc = fmcw::bfp_scale(fmcw::warp_max<32>(pk));
    for (int k = lane; k < nd; k += 32) {
        const double2 v = spec[(k % o) * pitch + k / o];
        out[k] = int_magnitude(v.x, v.y, sc);
    }
    __syncwarp();
    return sat;
}

// ---------------------------------------------------------------------------
// Detection kernel
// ---------------------------------------------------------------------------

// Shared memory, in 4-byte words (fmcw::TileLayout), with three counts:
// n_dets, the non-finite cells (none) and the saturations.
__host__ __device__ inline fmcw::TileLayout layout(const SlowtimeConfig& c) {
    return fmcw::tile_layout(c, 3);
}

inline bool detect_config_ok(const SlowtimeConfig& c) {
    const int rows = c.T + 2 * c.pgr;
    return fmcw::slowtime_config_ok(c) && rows >= fmcw::kStrip &&
           c.variant >= 0 && c.variant <= fmcw::kSO &&
           (c.variant != 0 || c.n_ref <= fmcw::kMaxPackedRef<Mag>) &&
           (c.notch_mode == 2 || c.notch_mode == 3) && c.shift >= 1 &&
           c.shift <= 30 &&
           (fmcw::strip_units(rows, c.ND) + kThreads - 1) / kThreads *
                   fmcw::kStrip <= 64 &&
           (size_t)layout(c).total * sizeof(int) <= (size_t)kMaxSmem;
}

template <int ND, bool kHalo, bool kMean>
__global__ void __launch_bounds__(kThreads, 2)
slowtime_detect_fixed_kernel(const Params p) {
    extern __shared__ int smem[];
    const SlowtimeConfig& c = p.c;
    const int E = c.T + 2 * c.H;
    const int rows = c.T + 2 * c.pgr;
    const fmcw::TileLayout lay = layout(c);
    Mag* mag_s = reinterpret_cast<Mag*>(smem);
    Mag* det_s = mag_s + lay.det;
    Mag* cs_guard = mag_s + lay.cs_guard;
    Sem::Acc* bsum = reinterpret_cast<Sem::Acc*>(smem + lay.blk);
    Sem::Acc* bnb = bsum + kMaxBlk;
    int* bhi = smem + lay.blk + 2 * kMaxBlk;
    int* blo = bhi + kMaxBlk;
    int* bscale = blo + kMaxBlk;
    int* rmax_s = smem + lay.rmax;
    int* counts = smem + lay.counts;            // n_dets, -, sat
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int b = blockIdx.y;
    const int r0 = blockIdx.x * c.T;

    for (int i = tid; i < c.T; i += kThreads) rmax_s[i] = 0;
    if (tid < 3) counts[tid] = 0;

    // ---- 1. Slow-time chain and magnitude, rows r0-H .. r0+T+H.
    {
        using R = Row<ND>;
        const int l = lane % R::L;
        const auto frame = fmcw::frame_rows<kHalo>(
            p.xr, p.xi, p.lo_r, p.lo_i, p.hi_r, p.hi_i, b, c.R, c.H, ND);
        int my_sat = 0;
        // At ND = 16 a warp takes two rows; past the tile's last row it
        // computes that row again and stores and counts nothing, so the
        // whole warp stays in the shuffles.
        for (int e0 = (tid >> 5) * R::G; e0 < E; e0 += kWarps * R::G) {
            const int e = e0 + lane / R::L;
            const int ec = e < E ? e : E - 1;
            const int16_t* rr;
            const int16_t* ri;
            frame.row(r0 - c.H + ec, rr, ri);
            Mag* out = mag_s + ec * ND;
            const int s = slowtime_row<ND>(rr, ri, p.win, p.tw, l, c,
                                           [&](int k, int m) {
                                               if (e < E) out[k] = Mag(m);
                                           });
            if (e >= c.H && e < c.H + c.T) my_sat += s;
        }
        my_sat = fmcw::warp_sum(my_sat);
        if (lane == 0 && my_sat) atomicAdd(&counts[2], my_sat);
    }
    __syncthreads();

    // ---- 2. The scale's statistics, then the decision of tile rows
    //         H-pgr .. H+T+pgr: OS by counting, or (kMean) the CA/GO/SO
    //         window means.
    const fmcw::CfarGeom g{c.hr, c.hd, c.gr, c.gd, c.n_ref, c.k,
                           c.scale_min, c.scale_nom, c.scale_max};
    const int e_first = c.H - c.pgr;
    const int* scale_blk = nullptr;
    if (c.block_mode) {
        if (c.so == 0) {
            fmcw::block_scale_tile<Mag, Sem>(mag_s, E, ND, c.sb, c.n_blk,
                                             c.k_blk, g, bsum, bnb, bhi, blo,
                                             bscale);
            scale_blk = bscale;
        }
    } else if (!kMean && c.so == 0) {
        fmcw::tile_colsums(mag_s, ND, e_first, rows, g, det_s, cs_guard);
        __syncthreads();
    }
    if constexpr (kMean) {
        // The full-window column sums, into det_s, where the training sum
        // is needed (CA, or the per-cell scale).
        if (fmcw::mean_needs_sums(c.variant, c.block_mode, c.so)) {
            fmcw::tile_colsums<Mag, false>(mag_s, ND, e_first, rows, g,
                                           det_s, nullptr);
            __syncthreads();
        }
    }
    fmcw::decide_tile<Mag, Sem, kMean>(mag_s, det_s, e_first, rows, ND,
                                       det_s, cs_guard, scale_blk, c.sb,
                                       c.so, g, c.variant);

    // ---- 3. Peak grouping (global row ids), outputs, row maxima and
    //         counts for the T rows.
    const size_t out0 = ((size_t)b * c.R + r0) * ND;
    fmcw::group_store(det_s, mag_s, c.T, c.H, c.pgr, c.r_total, ND,
                      c.row_off + r0, out0, p.det, p.mag, rmax_s, counts);
    __syncthreads();
    for (int t = tid; t < c.T; t += kThreads)
        p.row_max[(size_t)b * c.R + r0 + t] = (int)__int_as_float(rmax_s[t]);
    if (tid == 0) {
        if (counts[0]) atomicAdd(&p.n_dets[b], counts[0]);
        if (counts[2]) atomicAdd(&p.sat[b], counts[2]);
    }
}

// ---------------------------------------------------------------------------
// Long and dense CPIs: the map, then the decision in chunks
// (slowtime_long.cuh)
// ---------------------------------------------------------------------------

// The int32 magnitude map of a long-CPI (M = kInner) or dense (M = ND &
// -ND) batch: warp w of a block takes rows blockIdx.x kLongWarps + w,
// striding by the grid, each row's chain (split_row<M>) in the warp's
// map_warp_bytes of shared memory, with the frame's Doppler-window
// saturations.  kHalo (the split entry): the map is the shard's
// halo-extended slab (B, R + 2H, ND), slab row e from FrameRows row e - H;
// only the shard's own rows are counted.
template <int M, bool kHalo>
__global__ void __launch_bounds__(kLongWarps * 32)
slowtime_map_kernel(const Params p) {
    extern __shared__ double2 lsm[];
    const SlowtimeConfig& c = p.c;
    const int ND = c.ND, o = ND / M;
    const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
    double2* spec = lsm + warp * (map_warp_bytes(ND, M) / sizeof(double2));
    int16_t* zr = reinterpret_cast<int16_t*>(spec + o * class_pitch(M, o));
    int16_t* zi = zr + ND;
    const int map_rows = kHalo ? c.R + 2 * c.H : c.R;
    const long long total = (long long)c.batch * map_rows;
    for (long long row = (long long)blockIdx.x * kLongWarps + warp;
         row < total; row += (long long)gridDim.x * kLongWarps) {
        const int b = (int)(row / map_rows), e = (int)(row % map_rows);
        const int16_t* rr;
        const int16_t* ri;
        fmcw::frame_rows<kHalo>(p.xr, p.xi, p.lo_r, p.lo_i, p.hi_r, p.hi_i,
                                b, c.R, c.H, ND)
            .row(kHalo ? e - c.H : e, rr, ri);
        int sat = split_row<M>(rr, ri, p.win, p.tw, l, c, spec, zr, zi,
                               p.mag + row * ND);
        sat = fmcw::warp_sum(sat);
        const bool own = !kHalo || (e >= c.H && e < c.H + c.R);
        if (l == 0 && sat && own) atomicAdd(&p.sat[b], sat);
    }
}

template <int ND, bool kHalo, bool kMean>
int launch_decision(const Params& p, cudaStream_t stream) {
    static bool ready[fmcw::kMaxDevices] = {};
    auto* kernel = slowtime_detect_fixed_kernel<ND, kHalo, kMean>;
    const cudaError_t err = fmcw::prepare(kernel, ready);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = (size_t)layout(p.c).total * sizeof(int);
    const dim3 grid(p.c.R / p.c.T, p.c.batch);
    kernel<<<grid, kThreads, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

// The OS counting epilogue (variant 0) or the CA/GO/SO one.
template <int ND, bool kHalo>
int launch(const Params& p, cudaStream_t stream) {
    return p.c.variant ? launch_decision<ND, kHalo, true>(p, stream)
                       : launch_decision<ND, kHalo, false>(p, stream);
}

template <bool kHalo>
int launch_nd(const Params& p, cudaStream_t stream) {
    switch (p.c.ND) {
        case 16: return launch<16, kHalo>(p, stream);
        case 32: return launch<32, kHalo>(p, stream);
        case 64: return launch<64, kHalo>(p, stream);
        case 128: return launch<128, kHalo>(p, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <int M, bool kHalo>
int launch_map(const Params& p, cudaStream_t stream) {
    static bool ready[fmcw::kMaxDevices] = {};
    auto* kernel = slowtime_map_kernel<M, kHalo>;
    const cudaError_t err = fmcw::prepare(kernel, ready);
    if (err != cudaSuccess) return (int)err;
    const long long rows =
        (long long)p.c.batch * (p.c.R + (kHalo ? 2 * p.c.H : 0));
    long long blocks = (rows + kLongWarps - 1) / kLongWarps;
    if (blocks > kLongBlocks) blocks = kLongBlocks;
    const size_t smem = kLongWarps * map_warp_bytes(p.c.ND, M);
    kernel<<<(unsigned)blocks, kLongWarps * 32, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

// A long or dense CPI's detection: the int32 map (p.mag) from
// split_row<inner_len(ND)>, then its decision on IntInFloat tiles.
template <bool kHalo>
int launch_two(const Params& p, cudaStream_t stream) {
    int err;
    switch (inner_len(p.c.ND)) {
        case 8: err = launch_map<8, kHalo>(p, stream); break;
        case 16: err = launch_map<16, kHalo>(p, stream); break;
        case 32: err = launch_map<32, kHalo>(p, stream); break;
        case 64: err = launch_map<64, kHalo>(p, stream); break;
        case kInner: err = launch_map<kInner, kHalo>(p, stream); break;
        default: return (int)cudaErrorInvalidValue;
    }
    if (err) return err;
    return fmcw::launch_decide<int, Sem, int, kHalo>(
        {p.mag, p.det, p.row_max, p.n_dets, p.c}, stream);
}

// The lengths that run two launches, the map kernel then the decide kernel:
// the long CPIs and the dense lengths (as kernel B's).
inline bool two_launch(int nd) { return long_cpi(nd) || fmcw::dense_cpi(nd); }

// The fixed entries' two-launch lengths: the decide kernel's tile
// (decide_config_ok), the Q15 window's shift, E = T + 2H <= kMaxRows rows,
// so that an IntInFloat column sum (at most E magnitudes of 45,056: 5.8e6)
// stays below 2^24, exact in float, and the map kernel's shared memory.
inline bool two_launch_config_ok(const SlowtimeConfig& c) {
    return two_launch(c.ND) && fmcw::decide_config_ok(c) &&
           c.T + 2 * c.H <= fmcw::kMaxRows && c.shift >= 1 &&
           c.shift <= 30 &&
           kLongWarps * map_warp_bytes(c.ND, inner_len(c.ND)) <=
               (size_t)kMaxSmem;
}

}  // namespace

// xr/xi: int16 (batch, R, ND), 8-byte aligned; win: int32 (ND,); tw:
// complex float64 (ND,) with tw[m] = exp(-2 pi i m / ND), exact at the
// quarter turns; det: int32 (batch, R, ND); mag: same or null; row_max:
// int32 (batch, R); n_dets/sat: int32 (batch,), zeroed by the caller.
// cfg's variant selects the CFAR (0 OS, 1 CA, 2 GO, 3 SO).  A long CPI
// (ND = n2d x 128, n2d 2 .. 16: split_row<128>) or a dense length
// (fmcw::dense_cpi, 8, 24 .. 2040: split_row<m>, ND = o x m, m = ND & -ND)
// takes cfg's chunk W and column halo HC, needs mag (the map the decision
// reads) and row_max zeroed by the caller, and runs two launches.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int fmcw_slowtime_detect_fixed(const void* xr, const void* xi,
                                          const void* win, const void* tw,
                                          void* det, void* mag, void* row_max,
                                          void* n_dets, void* sat,
                                          const SlowtimeConfig* cfg,
                                          void* stream) {
    const SlowtimeConfig c = *cfg;
    const bool two = two_launch(c.ND);
    if (!(two ? two_launch_config_ok(c) && mag : detect_config_ok(c)) ||
        !win || !tw)
        return (int)cudaErrorInvalidValue;
    Params p{static_cast<const int16_t*>(xr), static_cast<const int16_t*>(xi),
             nullptr, nullptr, nullptr, nullptr,
             static_cast<const int*>(win),    static_cast<const double2*>(tw),
             static_cast<int*>(det),          static_cast<int*>(mag),
             static_cast<int*>(row_max),      static_cast<int*>(n_dets),
             static_cast<int*>(sat),          c};
    if (two) return launch_two<false>(p, (cudaStream_t)stream);
    return launch_nd<false>(p, (cudaStream_t)stream);
}

// The split entry (a range shard on a sequence-parallel mesh): xr/xi int16
// (batch, R, ND) are the shard's rows, lo_r/lo_i and hi_r/hi_i int16
// (batch, H, ND) the H = halo_range + peak_group_radius rows just below and
// above it, exchanged from the neighbouring shards, all 8-byte aligned;
// cfg's row_off and r_total place the shard in the frame.  Per-cell scale
// only, any variant.  Outputs as fmcw_slowtime_detect_fixed, for the
// shard's R rows; sat counts the Doppler window's saturations of those
// rows only.  At a long CPI or a dense length (the whole-frame entry's
// split_row plans) mag is the halo-extended slab (batch, R + 2H, ND)
// whose rows H .. H + R - 1 are the shard's magnitudes (the map the
// decision reads) and row_max is zeroed by the caller.
extern "C" int fmcw_slowtime_detect_fixed_split(
        const void* xr, const void* xi, const void* lo_r, const void* lo_i,
        const void* hi_r, const void* hi_i, const void* win, const void* tw,
        void* det, void* mag, void* row_max, void* n_dets, void* sat,
        const SlowtimeConfig* cfg, void* stream) {
    const SlowtimeConfig c = *cfg;
    const bool two = two_launch(c.ND);
    const bool ok = two ? fmcw::split_decide_ok(c) &&
                              two_launch_config_ok(c) && mag
                        : fmcw::split_config_ok(c) && detect_config_ok(c);
    if (!ok || !lo_r || !lo_i || !hi_r || !hi_i || !win || !tw)
        return (int)cudaErrorInvalidValue;
    Params p{static_cast<const int16_t*>(xr),   static_cast<const int16_t*>(xi),
             static_cast<const int16_t*>(lo_r), static_cast<const int16_t*>(lo_i),
             static_cast<const int16_t*>(hi_r), static_cast<const int16_t*>(hi_i),
             static_cast<const int*>(win),      static_cast<const double2*>(tw),
             static_cast<int*>(det),            static_cast<int*>(mag),
             static_cast<int*>(row_max),        static_cast<int*>(n_dets),
             static_cast<int*>(sat),            c};
    if (two) return launch_two<true>(p, (cudaStream_t)stream);
    return launch_nd<true>(p, (cudaStream_t)stream);
}
