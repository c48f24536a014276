// Fixed-point slow-time half of the radar front-end on Hopper: saturating
// MTI, Q15 Doppler window with saturation count, Doppler FFT, block-
// floating-point quantization per range bin, integer magnitude, integer 2D
// OS-CFAR and peak grouping on a tile of range rows.
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
// Bound on an H100: operations (the CFAR's compares, then the FP64 FFT);
// the bytes are 0.5 MiB in and 0.5 MiB out per 1024x128 frame.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cfar_common.cuh"
#include "cfar_tile.cuh"
#include "fixed_point.cuh"
#include "slowtime_common.cuh"

namespace {

using fmcw::kMaxBlk;
using fmcw::kMaxSmem;
using fmcw::Row;
using Mag = float;                      // the tile: integers held in float
using Sem = fmcw::IntInFloat;
constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// cos(pi/4) = ops/fft.twiddles64(8)[1].real.
constexpr double kC8 = 0x1.6a09e667f3bcdp-1;

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
    const int k1 = (int)(__brev((unsigned)l) >> (32 - R::kLog2L));
    const bool eighth = (k1 & (ND / 4 - 1)) == ND / 8;
    // u: the exact parts of the lane's eighth-turn bins (eighth_bin).  At
    // P = 1 the class sums T_r (r = l mod 8) over the lane group, u_r =
    // T_r - T_(r+4) on lanes r < 4, gathered from them.
    int u[8] = {};
    if constexpr (P == 1) {
        int tr = xr[0], ti = xi[0];
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
    // 2. FP64 (exact), the L-point DIF across the lanes, one transform per
    //    p: lane l ends with bin k1 of each.
    double yr[P], yi[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
        yr[p] = (double)xr[p];
        yi[p] = (double)xi[p];
    }
#pragma unroll
    for (int st = 0; st < R::kLog2L; ++st) {
        const int h = L >> (st + 1);
        const bool upper = (l & h) != 0;
        const double2 w = ld_nc(tw + (l & (h - 1)) * (ND / (2 * h)));
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
    //    X[k1 + L k2] = sum_p Y_p[k1] W_ND^(p k1) W_P^(p k2).
#pragma unroll
    for (int p = 1; p < P; ++p) cmul(yr[p], yi[p], ld_nc(tw + p * k1));
    double xo[P], yo[P];                    // X[k1 + L k2], k2 = 0 .. P-1
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
    // 3. The eighth-turn bins, exactly: bin k1 + L k2 = m ND / 8.
    if (eighth) {
#pragma unroll
        for (int k2 = 0; k2 < P; ++k2)
            eighth_bin(u, (k1 + L * k2) / (ND / 8), xo[k2], yo[k2]);
    }
    // 4. BFP over the row, quantize, integer magnitude
    //    (magnitude_calc.vhd:70-88).
    double pk = 0.0;
#pragma unroll
    for (int k2 = 0; k2 < P; ++k2)
        pk = fmax(pk, fmax(fabs(xo[k2]), fabs(yo[k2])));
    const double sc = fmcw::bfp_scale(fmcw::warp_max<L>(pk));
#pragma unroll
    for (int k2 = 0; k2 < P; ++k2) {
        const int ar = abs(fmcw::bfp_quantize(xo[k2], sc));
        const int ai = abs(fmcw::bfp_quantize(yo[k2], sc));
        const int mx = ar > ai ? ar : ai;
        const int mn = ar > ai ? ai : ar;
        sink(k1 + L * k2, mx + (mn >> 2) + (mn >> 3));
    }
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
           c.n_ref <= fmcw::kMaxPackedRef<Mag> &&
           (c.notch_mode == 2 || c.notch_mode == 3) && c.shift >= 1 &&
           c.shift <= 30 &&
           (fmcw::strip_units(rows, c.ND) + kThreads - 1) / kThreads *
                   fmcw::kStrip <= 64 &&
           (size_t)layout(c).total * sizeof(int) <= (size_t)kMaxSmem;
}

template <int ND, bool kHalo>
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
    //         H-pgr .. H+T+pgr.
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
    } else if (c.so == 0) {
        fmcw::tile_colsums(mag_s, ND, e_first, rows, g, det_s, cs_guard);
        __syncthreads();
    }
    fmcw::decide_tile<Mag, Sem>(mag_s, det_s, e_first, rows, ND, det_s,
                                cs_guard, scale_blk, c.sb, c.so, g);

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

template <int ND, bool kHalo>
int launch(const Params& p, cudaStream_t stream) {
    static bool ready[fmcw::kMaxDevices] = {};
    auto* kernel = slowtime_detect_fixed_kernel<ND, kHalo>;
    const cudaError_t err = fmcw::prepare(kernel, ready);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = (size_t)layout(p.c).total * sizeof(int);
    const dim3 grid(p.c.R / p.c.T, p.c.batch);
    kernel<<<grid, kThreads, smem, stream>>>(p);
    return (int)cudaGetLastError();
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

}  // namespace

// xr/xi: int16 (batch, R, ND), 8-byte aligned; win: int32 (ND,); tw:
// complex float64 (ND,) with tw[m] = exp(-2 pi i m / ND), exact at the
// quarter turns; det: int32 (batch, R, ND); mag: same or null; row_max:
// int32 (batch, R); n_dets/sat: int32 (batch,), zeroed by the caller.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int fmcw_slowtime_detect_fixed(const void* xr, const void* xi,
                                          const void* win, const void* tw,
                                          void* det, void* mag, void* row_max,
                                          void* n_dets, void* sat,
                                          const SlowtimeConfig* cfg,
                                          void* stream) {
    const SlowtimeConfig c = *cfg;
    if (!detect_config_ok(c) || !win || !tw)
        return (int)cudaErrorInvalidValue;
    Params p{static_cast<const int16_t*>(xr), static_cast<const int16_t*>(xi),
             nullptr, nullptr, nullptr, nullptr,
             static_cast<const int*>(win),    static_cast<const double2*>(tw),
             static_cast<int*>(det),          static_cast<int*>(mag),
             static_cast<int*>(row_max),      static_cast<int*>(n_dets),
             static_cast<int*>(sat),          c};
    return launch_nd<false>(p, (cudaStream_t)stream);
}

// The split entry (a range shard on a sequence-parallel mesh): xr/xi int16
// (batch, R, ND) are the shard's rows, lo_r/lo_i and hi_r/hi_i int16
// (batch, H, ND) the H = halo_range + peak_group_radius rows just below and
// above it, exchanged from the neighbouring shards, all 8-byte aligned;
// cfg's row_off and r_total place the shard in the frame.  Per-cell scale
// only.  Outputs as fmcw_slowtime_detect_fixed, for the shard's R rows; sat
// counts the Doppler window's saturations of those rows only.
extern "C" int fmcw_slowtime_detect_fixed_split(
        const void* xr, const void* xi, const void* lo_r, const void* lo_i,
        const void* hi_r, const void* hi_i, const void* win, const void* tw,
        void* det, void* mag, void* row_max, void* n_dets, void* sat,
        const SlowtimeConfig* cfg, void* stream) {
    const SlowtimeConfig c = *cfg;
    if (!fmcw::split_config_ok(c) || !detect_config_ok(c) || !lo_r ||
        !lo_i || !hi_r || !hi_i || !win || !tw)
        return (int)cudaErrorInvalidValue;
    Params p{static_cast<const int16_t*>(xr),   static_cast<const int16_t*>(xi),
             static_cast<const int16_t*>(lo_r), static_cast<const int16_t*>(lo_i),
             static_cast<const int16_t*>(hi_r), static_cast<const int16_t*>(hi_i),
             static_cast<const int*>(win),      static_cast<const double2*>(tw),
             static_cast<int*>(det),            static_cast<int*>(mag),
             static_cast<int*>(row_max),        static_cast<int*>(n_dets),
             static_cast<int*>(sat),            c};
    return launch_nd<true>(p, (cudaStream_t)stream);
}
