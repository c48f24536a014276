// Kernel B of the radar front-end on Hopper: slow-time chain (MTI, Doppler
// window, Doppler FFT), magnitude, 2D CFAR decision (OS, or CA / GO / SO)
// and peak grouping on a tile of range rows.
//
// Replaces the second half of fmcw_tpu/ops/frontend_pallas.py::_kernel
// (stage 5, the fused slow-time operator; stage 6, the magnitude; the
// epilogues _block_scale, _detect_epilogue and _peak_group_epilogue; the
// per-row maxima, n_dets and non-finite count) and its split counterpart
// fmcw_tpu/ops/split_frontend.py::_kernel_slowtime: the split entry point
// fmcw_slowtime_detect_split takes a range shard of a frame and the H rows
// beyond each of its edges, exchanged from the neighbouring shards, in place
// of the rows wrapped within the frame (slowtime_common.cuh), and breaks
// grouping ties by global row ids.  Row maxima and counts cover the shard's
// own rows.
//
// In:  planar float32 re/im, range-major (B, R, ND), from kernel A; the
//      Doppler window w[ND] (float32, hamming_float) and the twiddles
//      tw[m] = exp(-2 pi i m / ND) (float32 pairs, from float64).
// Out: det (B, R, ND) zero-suppressed detections, row_max (B, R),
//      n_dets and nonfinite (B,) int32 (integer atomics: exact), and the
//      magnitude map (B, R, ND) when asked for.
//
// The slow-time chain of a range row (slowtime_row) runs on L = min(32, ND)
// lanes of a warp, P = ND / L chirps a lane (16-byte loads at ND = 128):
// the pulse canceller in FP32 (x[s] - x[s-1], or (x[s] - 2 x[s-1]) +
// x[s-2]; the chirps before a lane's first from its neighbour by shuffle),
// the window, an L-point radix-2 DIF transform across the lanes by xor
// shuffles (one per value and stage), the twiddles W_ND^(p k1) and a P-point
// transform in registers, then the magnitude.  Every float operation is an
// explicit _rn intrinsic, so a row's magnitudes are the same instruction
// sequence in every entry, whether the row is a tile's own, a halo row or
// an exchanged one (the split entry is bit-equal to the whole-frame launch);
// they are held to the plain twin (ops/fft.doppler_apply, the chain folded
// into one float32 matrix) by tolerance (1e-5 of the peak).
//
// One block of 384 threads per (frame, tile of T range rows), two blocks an
// SM: the warps transform the tile's T + 2H rows (wrapped modulo R) into a
// shared magnitude tile, the CFAR window, the block-scale neighbourhood and
// the grouping radius reaching H rows beyond the tile
//   per-cell scale: H = halo_range + peak_group_radius  (6 + 2 = 8)
//   block scale:    H = (ceil(radius / sb) + 2) * sb    (24 at sb = 8);
// then decide the T + 2 pgr rows the grouping needs (cfar_tile.cuh: column
// sums once per tile, strips of 8 cells a thread, packed hi/lo counts kept
// in float so that each compare's add runs on the FMA pipe, the common
// windows walked unrolled) and group and store the T rows
// (cfar_common.cuh).  While one block counts, the other's loads and
// transforms proceed.  The CA/GO/SO variants (the fused body's non-OS
// detect epilogue, frontend_pallas.py:470-507 and split_frontend.py:
// 350-370) are a second instantiation of the kernel (kMean): the same
// tile, with cfar_tile.cuh's window-mean decision in place of the counting
// walks; no compare passes, so no packed-count limit on n_ref.
//
// Bound on an H100: operations.  Per 1024x128 frame the CFAR's compares
// (per-cell: 3 x 128 a cell over 131,072 cells) outweigh the slow-time FFT
// (~49 flops a cell) and the bytes (1 MiB in, 0.5 MiB out).  The compares
// set the pace: one FSET each on the integer pipe, which issues at half
// the FP32 rate.  The design loads each training value once per strip of 8
// cells and keeps the decision's arithmetic and order the plain twin's
// (ops/cfar.py), so the decisions are bit-identical to it on the same
// magnitudes.
//
// A second entry point, fmcw_slowtime_mag (slowtime_mag_kernel), is the TPU
// kernel's magnitude-only mode (rdm_frontend(detect=False)): the same
// slow-time chain of each row, written out with the non-finite count, for
// the array model's angle-extended CFAR (cfar_3d_detect.cu), whose training
// set spans beams.  Bound: bytes.
//
// Long CPIs (n_doppler ND = n2d x 128, 2 <= n2d <= 16): the long-CPI
// Doppler split of the TPU kernel (frontend_pallas.py _ct_split_rows and
// the n2d > 1 branches of _kernel, :633-654 and :719-773, and of
// split_frontend.py _kernel_slowtime, :518-570).  A row's chain
// (dense_row<128>) is the split: chirp s = 128 j2 + j1; the pulse canceller and
// the window over the whole row first, into the warp's shared buffers
// (the history crossing block edges by shuffles); then for each k2d the
// outer DFT_n2d over the blocks (direct sums), the twiddle W_ND^(j1 k2d)
// and the 128-point lane transform of the short rows (lane_fft<128>),
// whose bin q is Doppler bin n2d q + k2d, stored in natural order (the
// TPU's parity planes are its layout, not the map's).  A tile of whole
// rows no longer fits a block (at ND = 2048 one row is 8 KB of
// magnitudes), so every entry runs two launches there: the magnitude-only
// kernel at long CPIs (slowtime_map_kernel<128>) writes the map, then the
// decide kernel (slowtime_long.cuh's slowtime_decide_kernel, shared with
// the fixed kernel) reads it in tiles of T rows x a chunk of W columns,
// with H halo rows and HC halo columns that wrap on both axes (or, in the
// split entry, the rows of the halo-extended slab), and runs the same
// cfar_tile.cuh / cfar_common.cuh decision on them: the decisions are the
// plain twin's bit for bit on the same magnitudes.  The extra map write
// and read (8 B a cell) is the cost of the design; the TPU kernel keeps
// the frame in VMEM.
//
// Dense lengths (fmcw::dense_cpi: n_doppler ND a multiple of 8 below 2048
// that is neither a short row nor a long CPI, 8, 24, 40 .. 2040): the dense
// slow-time operator of the TPU kernel (the n2d == 1 branch of _kernel,
// frontend_pallas.py:719-725, and of _kernel_slowtime, split_frontend.py:
// 562-568, which contract the chirp axis with the folded matrices
// doppler_matrices(ND)).  Here a row runs the long row's plan with smaller
// inner transforms (dense_row): ND = o x m, m = ND & -ND (8 .. 64), o odd
// (1 .. 255); the outer DFT_o as direct sums over the blocks of m chirps,
// the twiddle W_ND^(j1 k2), then an m-point lane transform (lane_fft<m>,
// G = 32 / min(32, m) classes a warp at once), bin q of class k2 stored at
// Doppler bin o q + k2.  An FFT, not the folded matrix: the kernel stays on
// the accurate side of the twin under strong stationary clutter
// (tests/test_torch_slowtime_plan.py, tests/test_torch_dense_doppler.py).
// The same two launches as at long CPIs: the map kernel (slowtime_map_
// kernel<m>), then the decide kernel in tiles of T rows x W columns (W a
// multiple of 8 up to 128 that divides ND: 96 at 96 and 192, 8 at 1016 =
// 8 x 127).  Bound on an
// H100: the direct sums cost o - 1 complex multiply-adds a sample (126 at
// 1016, 254 at 2040), against the ~log2(ND) of an FFT that the bound
// counts; at the small lengths, the map's extra write and read.
//
// Lengths off a multiple of 8 (unaligned_cpi: every ND below 2048 with 8
// not dividing it, 1 .. 2047; JAX's dense operator takes them as any
// other): the same dense_row<m> with m = ND & -ND in 1, 2, 4 (L = m lanes a
// class, G = 32 / m classes a warp, lane_fft<1> the identity) and o up to
// 2047, so at an odd ND the row is one direct DFT (O(ND^2), as JAX's
// folded matrices).  Rows of ND floats are no longer 16-byte aligned: the
// canceller and window loads and the map's stores take kRowVec<m> floats
// (4, 2 or 1), the ragged row end reads 0, and the warp buffers keep a
// pitch of a multiple of 4 (map_pitch).  The decide kernel takes a chunk W
// that need not divide ND (a ragged last chunk whose columns past ND are
// decided, on the map's wrapped columns, but not stored).

#include <cuda_runtime.h>
#include <stdint.h>

#include "cfar_common.cuh"
#include "cfar_tile.cuh"
#include "slowtime_common.cuh"
#include "slowtime_long.cuh"

namespace {

using fmcw::kInner;
using fmcw::kMaxBlk;
using fmcw::kMaxSmem;
using fmcw::long_cpi;
using fmcw::Row;
constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr int kMagWarps = 8;            // magnitude-only kernel
constexpr int kMagRowsPerWarp = 4;
constexpr int kLongWarps = 4;           // the map kernel (long, dense)
constexpr int kLongBlocks = 8192;       // its grid (rows striding)
constexpr unsigned kFull = 0xffffffffu;

struct Params {
    const float* xr;
    const float* xi;
    const float* lo_r;              // split entry: H exchanged rows below
    const float* lo_i;              // and above the shard, (B, H, ND);
    const float* hi_r;              // null: rows wrap within the frame
    const float* hi_i;
    const float* win;               // (ND,) Doppler window
    const float2* tw;               // (ND,) exp(-2 pi i m / ND)
    float* det;
    float* mag;
    float* row_max;
    int* n_dets;
    int* nonfinite;
    SlowtimeConfig c;
};

// ---------------------------------------------------------------------------
// The slow-time chain of one range row
// ---------------------------------------------------------------------------

// A lane's constants: the DIF stage twiddles W_2h^(l mod h) (upper lanes),
// W_ND^(p k1) for its output column k1 = bit_reverse(l), its window values.
template <int ND>
struct LaneTables {
    float2 stw[Row<ND>::kLog2L > 0 ? Row<ND>::kLog2L : 1];
    float2 ptw[Row<ND>::P];
    float w[Row<ND>::P];
};

template <int ND>
__device__ __forceinline__ LaneTables<ND> lane_tables(const float* win,
                                                      const float2* tw,
                                                      int l) {
    using R = Row<ND>;
    LaneTables<ND> t;
#pragma unroll
    for (int st = 0; st < R::kLog2L; ++st) {
        const int h = R::L >> (st + 1);
        t.stw[st] = tw[(l & (h - 1)) * (ND / (2 * h))];
    }
    const int k1 = R::bin(l);
#pragma unroll
    for (int p = 0; p < R::P; ++p) {
        t.ptw[p] = tw[p * k1];
        t.w[p] = win[l * R::P + p];
    }
    return t;
}

// (a + i b)(c + i d) as the numpy model of the tests writes it: re = fma(a,
// c, -(b d)), im = fma(a, d, b c).
__device__ __forceinline__ void cmul(float& re, float& im, float2 w) {
    const float a = re, b = im;
    re = __fmaf_rn(a, w.x, __fmul_rn(-b, w.y));
    im = __fmaf_rn(a, w.y, __fmul_rn(b, w.x));
}

__device__ __forceinline__ float magnitude(float yr, float yi, bool exact) {
    if (exact) return hypotf(yr, yi);
    const float ar = fabsf(yr), ai = fabsf(yi);
    return __fadd_rn(fmaxf(ar, ai), __fmul_rn(0.375f, fminf(ar, ai)));
}

template <int P>
__device__ __forceinline__ void load_points(const float* row, int l,
                                            float (&x)[P]) {
    if constexpr (P == 4) {
        const float4 v = *reinterpret_cast<const float4*>(row + 4 * l);
        x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    } else if constexpr (P == 2) {
        const float2 v = *reinterpret_cast<const float2*>(row + 2 * l);
        x[0] = v.x; x[1] = v.y;
    } else {
        x[0] = row[l];
    }
}

// The transform of a windowed row held P values a lane (chirp s = l P + p)
// and its magnitude: calls sink(k, magnitude) for the lane's P Doppler
// bins k = k1 + L k2, k1 = bit_reverse(l).
template <int ND, typename Sink>
__device__ __forceinline__ void lane_fft(float (&xr)[Row<ND>::P],
                                         float (&xi)[Row<ND>::P],
                                         const LaneTables<ND>& t, int l,
                                         bool exact, Sink sink) {
    using R = Row<ND>;
    constexpr int P = R::P, L = R::L;
    // L-point DIF across the lanes, one transform per p: the lower lane of
    // each pair takes a + b, the upper (b - a) W; lane l ends with bin
    // bit_reverse(l).
#pragma unroll
    for (int st = 0; st < R::kLog2L; ++st) {
        const int h = L >> (st + 1);
        const bool upper = (l & h) != 0;
#pragma unroll
        for (int p = 0; p < P; ++p) {
            const float br = __shfl_xor_sync(kFull, xr[p], h, L);
            const float bi = __shfl_xor_sync(kFull, xi[p], h, L);
            if (upper) {
                xr[p] = __fsub_rn(br, xr[p]);
                xi[p] = __fsub_rn(bi, xi[p]);
                cmul(xr[p], xi[p], t.stw[st]);
            } else {
                xr[p] = __fadd_rn(xr[p], br);
                xi[p] = __fadd_rn(xi[p], bi);
            }
        }
    }
    // X[k1 + L k2] = sum_p Y_p[k1] W_ND^(p k1) W_P^(p k2).
#pragma unroll
    for (int p = 1; p < P; ++p) cmul(xr[p], xi[p], t.ptw[p]);
    const int k1 = R::bin(l);
    if constexpr (P == 1) {
        sink(k1, magnitude(xr[0], xi[0], exact));
    } else if constexpr (P == 2) {
        sink(k1, magnitude(__fadd_rn(xr[0], xr[1]), __fadd_rn(xi[0], xi[1]),
                           exact));
        sink(k1 + L, magnitude(__fsub_rn(xr[0], xr[1]),
                               __fsub_rn(xi[0], xi[1]), exact));
    } else {
        const float s0r = __fadd_rn(xr[0], xr[2]), s0i = __fadd_rn(xi[0], xi[2]);
        const float d0r = __fsub_rn(xr[0], xr[2]), d0i = __fsub_rn(xi[0], xi[2]);
        const float s1r = __fadd_rn(xr[1], xr[3]), s1i = __fadd_rn(xi[1], xi[3]);
        const float d1r = __fsub_rn(xr[1], xr[3]), d1i = __fsub_rn(xi[1], xi[3]);
        sink(k1, magnitude(__fadd_rn(s0r, s1r), __fadd_rn(s0i, s1i), exact));
        sink(k1 + L, magnitude(__fadd_rn(d0r, d1i), __fsub_rn(d0i, d1r),
                               exact));
        sink(k1 + 2 * L, magnitude(__fsub_rn(s0r, s1r), __fsub_rn(s0i, s1i),
                                   exact));
        sink(k1 + 3 * L, magnitude(__fsub_rn(d0r, d1i), __fadd_rn(d0i, d1r),
                                   exact));
    }
}

// The slow-time chain of the row (rr, ri) on the L lanes l = 0 .. L-1 of a
// lane group (all 32 lanes of the warp call it together): lane l holds
// chirps s = l P + p.  Calls sink(k, magnitude) for its P Doppler bins k =
// k1 + L k2, k1 = bit_reverse(l).
template <int ND, typename Sink>
__device__ __forceinline__ void slowtime_row(const float* rr, const float* ri,
                                             const LaneTables<ND>& t, int l,
                                             const SlowtimeConfig& c,
                                             Sink sink) {
    using R = Row<ND>;
    constexpr int P = R::P, L = R::L;
    float xr[P], xi[P];
    load_points<P>(rr, l, xr);
    load_points<P>(ri, l, xi);
    // Pulse canceller: the chirps just before the lane's first come from
    // the lower lanes; missing history reads 0 (transient "passthrough"),
    // "zero" zeroes the first notch - 1 outputs.
    if (!c.bypass) {
        float p1r = __shfl_up_sync(kFull, xr[P - 1], 1, L);
        float p1i = __shfl_up_sync(kFull, xi[P - 1], 1, L);
        float p2r, p2i;
        if constexpr (P >= 2) {
            p2r = __shfl_up_sync(kFull, xr[P - 2], 1, L);
            p2i = __shfl_up_sync(kFull, xi[P - 2], 1, L);
            if (l < 1) p2r = p2i = 0.f;
        } else {
            p2r = __shfl_up_sync(kFull, xr[0], 2, L);
            p2i = __shfl_up_sync(kFull, xi[0], 2, L);
            if (l < 2) p2r = p2i = 0.f;
        }
        if (l < 1) p1r = p1i = 0.f;
#pragma unroll
        for (int p = P - 1; p >= 0; --p) {
            const int i1 = p >= 1 ? p - 1 : 0, i2 = p >= 2 ? p - 2 : 0;
            const float a1r = p >= 1 ? xr[i1] : p1r;
            const float a1i = p >= 1 ? xi[i1] : p1i;
            const float a2r = p >= 2 ? xr[i2] : (p == 1 ? p1r : p2r);
            const float a2i = p >= 2 ? xi[i2] : (p == 1 ? p1i : p2i);
            float yr, yi;
            if (c.notch_mode == 2) {
                yr = __fsub_rn(xr[p], a1r);
                yi = __fsub_rn(xi[p], a1i);
            } else {
                yr = __fadd_rn(__fmaf_rn(-2.f, a1r, xr[p]), a2r);
                yi = __fadd_rn(__fmaf_rn(-2.f, a1i, xi[p]), a2i);
            }
            if (c.transient_zero && l * P + p < c.notch_mode - 1)
                yr = yi = 0.f;
            xr[p] = yr;
            xi[p] = yi;
        }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
        xr[p] = __fmul_rn(xr[p], t.w[p]);
        xi[p] = __fmul_rn(xi[p], t.w[p]);
    }
    lane_fft<ND>(xr, xi, t, l, c.exact_mag != 0, sink);
}

// ---------------------------------------------------------------------------
// The slow-time chain of a long or dense row (ND = o x M)
// ---------------------------------------------------------------------------

// A long or dense row's lane constants for its M-point inner transforms
// (M = 128 at a long CPI, m at a dense length), read from the ND-point
// table tw[m] = exp(-2 pi i m / ND) at stride = ND / M: the stage twiddles
// W_2h^j = tw[j (M / 2h) stride] and W_M^(p k1) = tw[p k1 stride].  The
// window runs over the whole row first (dense_row), so w is unused.
template <int M>
__device__ __forceinline__ LaneTables<M> inner_lane_tables(const float2* tw,
                                                           int l, int stride) {
    using R = Row<M>;
    LaneTables<M> t;
#pragma unroll
    for (int st = 0; st < R::kLog2L; ++st) {
        const int h = R::L >> (st + 1);
        t.stw[st] = tw[(l & (h - 1)) * (M / (2 * h)) * stride];
    }
    const int k1 = R::bin(l);
#pragma unroll
    for (int p = 0; p < R::P; ++p) {
        t.ptw[p] = tw[p * k1 * stride];
        t.w[p] = 1.f;
    }
    return t;
}

// acc += z w in the order (z.re w.re - z.im w.im) as two fmas each.
__device__ __forceinline__ void cmac(float& ar, float& ai, float zr, float zi,
                                     float2 w) {
    ar = __fmaf_rn(zr, w.x, __fmaf_rn(-zi, w.y, ar));
    ai = __fmaf_rn(zr, w.y, __fmaf_rn(zi, w.x, ai));
}

// The widest load a row of ND floats allows, V = min(4, ND & -ND) floats: a
// row whose base is 16-byte aligned (the entries' aligned16) then starts at
// a multiple of 4 V bytes.
template <int M>
constexpr int kRowVec = M >= 4 ? 4 : M;

// Inner transforms below 8 points (the lengths off a multiple of 8): the
// outer sums' twiddles W_o^e = tw[e M], e < o, are read from a copy in
// shared memory (a warp's 32 classes gather 32 of them a step: from global
// memory through L1 up to 32 cache lines a load).
template <int M>
constexpr bool kSharedTw = M < 8;

// x[q] = row[s0 + q], q < 4, for s0 a multiple of 4 below nd, in loads of
// V floats; 0 past the row's end (V < 4: a row of nd = 4 i + V ... values).
template <int V>
__device__ __forceinline__ void load_run(const float* row, int s0, int nd,
                                         float (&x)[4]) {
    if constexpr (V == 4) {
        const float4 v = *reinterpret_cast<const float4*>(row + s0);
        x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    } else if constexpr (V == 2) {
        const float2 a = *reinterpret_cast<const float2*>(row + s0);
        x[0] = a.x; x[1] = a.y;
        x[2] = x[3] = 0.f;
        if (s0 + 2 < nd) {
            const float2 b = *reinterpret_cast<const float2*>(row + s0 + 2);
            x[2] = b.x; x[3] = b.y;
        }
    } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) x[q] = s0 + q < nd ? row[s0 + q] : 0.f;
    }
}

// The slow-time chain and magnitude of a long or dense row (rr, ri) on the
// 32 lanes of a warp: ND = o x M, chirp s = M j2 + j1; at a long CPI M =
// kInner = 128 and o = n2d (JAX's long-CPI split), at a dense length M = ND
// & -ND (1 .. 64) and o = ND / M odd (1 .. 2047):
//   1. the pulse canceller and the window over the whole row into the
//      warp's buffers zr / zi (ND floats each, at a pitch of a multiple of
//      4): lane l takes chirps s = 128 i + 4 l + q, in loads of
//      kRowVec<M> floats (a ragged row end reads 0 and its values are never
//      read); the history before its first chirp at a long CPI by shuffles
//      (from the lane below, lane 0's from lane 31 of the block before), at
//      a dense length read from the row;
//   2. for the classes k2 = 0 .. o-1, G = 32 / L at a time (L = min(32, M)
//      lanes a class, P = M / L points a lane; lane group g = lane / L takes
//      k2 = k0 + g, and past o computes class o - 1 again and stores
//      nothing, so every lane stays in the shuffles): lane l's points j1 =
//      l P + p of the outer DFT_o over the blocks, sum_j2 z[M j2 + j1]
//      W_o^(j2 k2) (j2 ascending, W_o^e = tw[e M], direct sums), the
//      twiddle W_ND^(j1 k2), and the M-point lane transform (lane_fft<M>;
//      M = 1: none), whose bin q is the row's Doppler bin o q + k2: its
//      magnitude goes to out[o q + k2], natural order.  kSharedTw<M>: W_o^e
//      from tw_o[e], the block's copy in shared memory.
// Every float operation an _rn intrinsic, so a row is the same instruction
// sequence in every entry: an FFT, not the folded matrix of the twin (which
// is up to 2.1e-4 of the peak off a float64 chain under strong stationary
// clutter).  All 32 lanes call it.
template <int M>
__device__ __forceinline__ void dense_row(
        const float* rr, const float* ri, const float* win, const float2* tw,
        const LaneTables<M>& t, int lane, const SlowtimeConfig& c,
        float* zr, float* zi, float* out, const float2* tw_o) {
    using R = Row<M>;
    constexpr int P = R::P, L = R::L, G = R::G, V = kRowVec<M>;
    const int nd = c.ND, o = nd / M;
    float h1r = 0.f, h1i = 0.f, h2r = 0.f, h2i = 0.f;
    for (int b0 = 0; b0 < nd; b0 += 4 * 32) {
        const int s0 = b0 + 4 * lane;
        if constexpr (M != kInner) {
            if (s0 >= nd) break;
        }
        float xr[4], xi[4], w[4];
        load_run<V>(rr, s0, nd, xr);
        load_run<V>(ri, s0, nd, xi);
        load_run<V>(win, s0, nd, w);
        if (!c.bypass) {
            float p1r = 0.f, p1i = 0.f, p2r = 0.f, p2i = 0.f;
            if constexpr (M == kInner) {
                // The long row's shuffles (fewer registers than reading
                // the history from the row).
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
                p1r = rr[s0 - 1]; p1i = ri[s0 - 1];
                p2r = rr[s0 - 2]; p2i = ri[s0 - 2];
            }
#pragma unroll
            for (int q = 3; q >= 0; --q) {
                const int i1 = q >= 1 ? q - 1 : 0, i2 = q >= 2 ? q - 2 : 0;
                const float a1r = q >= 1 ? xr[i1] : p1r;
                const float a1i = q >= 1 ? xi[i1] : p1i;
                const float a2r = q >= 2 ? xr[i2] : (q == 1 ? p1r : p2r);
                const float a2i = q >= 2 ? xi[i2] : (q == 1 ? p1i : p2i);
                float yr, yi;
                if (c.notch_mode == 2) {
                    yr = __fsub_rn(xr[q], a1r);
                    yi = __fsub_rn(xi[q], a1i);
                } else {
                    yr = __fadd_rn(__fmaf_rn(-2.f, a1r, xr[q]), a2r);
                    yi = __fadd_rn(__fmaf_rn(-2.f, a1i, xi[q]), a2i);
                }
                if (c.transient_zero && s0 + q < c.notch_mode - 1)
                    yr = yi = 0.f;
                xr[q] = yr;
                xi[q] = yi;
            }
        }
        *reinterpret_cast<float4*>(zr + s0) = make_float4(
            __fmul_rn(xr[0], w[0]), __fmul_rn(xr[1], w[1]),
            __fmul_rn(xr[2], w[2]), __fmul_rn(xr[3], w[3]));
        *reinterpret_cast<float4*>(zi + s0) = make_float4(
            __fmul_rn(xi[0], w[0]), __fmul_rn(xi[1], w[1]),
            __fmul_rn(xi[2], w[2]), __fmul_rn(xi[3], w[3]));
    }
    __syncwarp();
    const bool exact = c.exact_mag != 0;
    const int g = lane / L, l = lane % L;
    for (int k0 = 0; k0 < o; k0 += G) {
        const bool own = k0 + g < o;
        const int k2 = own ? k0 + g : o - 1;
        float xr[P], xi[P];
        load_points<P>(zr, l, xr);
        load_points<P>(zi, l, xi);
        int e = 0;
        for (int j2 = 1; j2 < o; ++j2) {
            e += k2;
            if (e >= o) e -= o;
            const float2 w = kSharedTw<M> ? tw_o[e] : tw[e * M];
            float br[P], bi[P];
            load_points<P>(zr + j2 * M, l, br);
            load_points<P>(zi + j2 * M, l, bi);
#pragma unroll
            for (int q = 0; q < P; ++q) cmac(xr[q], xi[q], br[q], bi[q], w);
        }
        if (k2 > 0) {
#pragma unroll
            for (int q = 0; q < P; ++q)
                cmul(xr[q], xi[q], tw[(l * P + q) * k2]);
        }
        lane_fft<M>(xr, xi, t, l, exact, [&](int k, float v) {
            if (own) out[k * o + k2] = v;
        });
    }
    __syncwarp();
}

// ---------------------------------------------------------------------------
// Detection kernel
// ---------------------------------------------------------------------------

// Shared memory, in floats (fmcw::TileLayout), with two counts: n_dets and
// the non-finite cells.
__host__ __device__ inline fmcw::TileLayout layout(const SlowtimeConfig& c) {
    return fmcw::tile_layout(c, 2);
}

inline bool detect_config_ok(const SlowtimeConfig& c) {
    const int rows = c.T + 2 * c.pgr;
    return fmcw::slowtime_config_ok(c) && rows >= fmcw::kStrip &&
           c.variant >= 0 && c.variant <= fmcw::kSO &&
           (c.variant != 0 || c.n_ref <= fmcw::kMaxPackedRef<float>) &&
           (c.notch_mode == 2 || c.notch_mode == 3) &&
           (fmcw::strip_units(rows, c.ND) + kThreads - 1) / kThreads *
                   fmcw::kStrip <= 64 &&
           (size_t)layout(c).total * sizeof(float) <= (size_t)kMaxSmem;
}

template <int ND, bool kHalo, bool kMean>
__global__ void __launch_bounds__(kThreads, 2)
slowtime_detect_kernel(const Params p) {
    extern __shared__ float smem[];
    const SlowtimeConfig& c = p.c;
    const int E = c.T + 2 * c.H;
    const int rows = c.T + 2 * c.pgr;
    const fmcw::TileLayout lay = layout(c);
    float* mag_s = smem;
    float* det_s = smem + lay.det;
    float* cs_guard = smem + lay.cs_guard;
    float* bsum = smem + lay.blk;
    float* bnb = bsum + kMaxBlk;
    int* bhi = reinterpret_cast<int*>(bnb + kMaxBlk);
    int* blo = bhi + kMaxBlk;
    int* bscale = blo + kMaxBlk;
    int* rmax_s = reinterpret_cast<int*>(smem + lay.rmax);
    int* counts = reinterpret_cast<int*>(smem + lay.counts);
    const int tid = threadIdx.x;
    const int b = blockIdx.y;
    const int r0 = blockIdx.x * c.T;

    for (int i = tid; i < c.T; i += kThreads) rmax_s[i] = 0;
    if (tid < 2) counts[tid] = 0;

    // ---- 1. Slow-time chain and magnitude, rows r0-H .. r0+T+H.
    {
        using R = Row<ND>;
        const int lane = tid & 31;
        const int l = lane % R::L;
        const LaneTables<ND> tabs = lane_tables<ND>(p.win, p.tw, l);
        const auto frame = fmcw::frame_rows<kHalo>(
            p.xr, p.xi, p.lo_r, p.lo_i, p.hi_r, p.hi_i, b, c.R, c.H, ND);
        // At ND = 16 a warp takes two rows; past the tile's last row it
        // computes that row again and stores nothing, so the whole warp
        // stays in the shuffles.
        for (int e0 = (tid >> 5) * R::G; e0 < E; e0 += kWarps * R::G) {
            const int e = e0 + lane / R::L;
            const int ec = e < E ? e : E - 1;
            const float* rr;
            const float* ri;
            frame.row(r0 - c.H + ec, rr, ri);
            float* out = mag_s + ec * ND;
            slowtime_row<ND>(rr, ri, tabs, l, c, [&](int k, float m) {
                if (e < E) out[k] = m;
            });
        }
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
            fmcw::block_scale_tile(mag_s, E, ND, c.sb, c.n_blk, c.k_blk, g,
                                   bsum, bnb, bhi, blo, bscale);
            scale_blk = bscale;
        }
    } else if (!kMean && c.so == 0) {
        fmcw::tile_colsums(mag_s, ND, e_first, rows, g, det_s, cs_guard);
        __syncthreads();
    }
    if constexpr (kMean) {
        // The full-window column sums, into det_s, where the training sum
        // is needed (CA, or the per-cell scale); the strips sum their
        // guard boxes and the GO/SO halves themselves.
        if (fmcw::mean_needs_sums(c.variant, c.block_mode, c.so)) {
            fmcw::tile_colsums<float, false>(mag_s, ND, e_first, rows, g,
                                             det_s, nullptr);
            __syncthreads();
        }
    }
    fmcw::decide_tile<float, fmcw::MapSem<float>, kMean>(
        mag_s, det_s, e_first, rows, ND, det_s, cs_guard, scale_blk, c.sb,
        c.so, g, c.variant);

    // ---- 3. Peak grouping (global row ids), outputs, row maxima and
    //         counts for the T rows.
    const size_t out0 = ((size_t)b * c.R + r0) * ND;
    fmcw::group_store(det_s, mag_s, c.T, c.H, c.pgr, c.r_total, ND,
                      c.row_off + r0, out0, p.det, p.mag, rmax_s, counts);
    __syncthreads();
    for (int t = tid; t < c.T; t += kThreads)
        p.row_max[(size_t)b * c.R + r0 + t] = __int_as_float(rmax_s[t]);
    if (tid == 0) {
        if (counts[0]) atomicAdd(&p.n_dets[b], counts[0]);
        if (counts[1]) atomicAdd(&p.nonfinite[b], counts[1]);
    }
}

// ---------------------------------------------------------------------------
// Magnitude only
// ---------------------------------------------------------------------------

// rdm_frontend(detect=False) of the TPU kernel, the array model's
// angle-extended path: the slow-time chain and magnitude of every row of
// the batch, written to mag (B, R, ND), with the per-frame non-finite
// count; no CFAR.  A warp takes kMagRowsPerWarp x G rows.
template <int ND>
__global__ void __launch_bounds__(kMagWarps * 32)
slowtime_mag_kernel(const Params p) {
    using R = Row<ND>;
    const SlowtimeConfig& c = p.c;
    const int lane = threadIdx.x & 31;
    const int l = lane % R::L;
    const LaneTables<ND> tabs = lane_tables<ND>(p.win, p.tw, l);
    const long long total = (long long)c.batch * c.R;
    const long long base = (long long)blockIdx.x * kMagWarps * R::G *
                           kMagRowsPerWarp;
    for (int i = 0; i < kMagRowsPerWarp; ++i) {
        const long long row = base + (i * kMagWarps + (threadIdx.x >> 5)) *
                                         R::G + lane / R::L;
        // A row past the end computes the last row again and stores
        // nothing, so the whole warp stays in the shuffles.
        const long long rc = row < total ? row : total - 1;
        float* out = p.mag + rc * ND;
        int nf = 0;
        slowtime_row<ND>(p.xr + rc * ND, p.xi + rc * ND, tabs, l, c,
                         [&](int k, float m) {
                             if (row < total) {
                                 out[k] = m;
                                 nf += !isfinite(m);
                             }
                         });
        if (nf) atomicAdd(&p.nonfinite[rc / c.R], nf);
    }
}

// ---------------------------------------------------------------------------
// Long and dense CPIs: the map, then the decision in chunks
// ---------------------------------------------------------------------------

// A map-kernel warp's buffers: three rows of ND floats at a pitch of a
// multiple of 4 floats (16-byte aligned rows for dense_row's stores).
__host__ __device__ inline int map_pitch(int nd) { return (nd + 3) & ~3; }

// The magnitude map of a long-CPI (M = kInner) or dense (M = m) batch
// (dense_row<M>): warp w of a block takes rows blockIdx.x kLongWarps + w,
// striding by the grid; each row's chain in the warp's 3 map_pitch(ND)
// floats of shared memory (kSharedTw<M>: then the block's o outer
// twiddles), the magnitudes stored row-major (stores of
// kRowVec<M> floats: 16 bytes where 4 | ND) with the frame's non-finite
// count.  kHalo (the split entry): the map is the shard's halo-extended
// slab (B, R + 2H, ND), slab row e from FrameRows row e - H; only the
// shard's own rows are counted.
template <int M, bool kHalo>
__global__ void __launch_bounds__(kLongWarps * 32)
slowtime_map_kernel(const Params p) {
    extern __shared__ float smem[];
    constexpr int V = kRowVec<M>;
    const SlowtimeConfig& c = p.c;
    const int ND = c.ND, pitch = map_pitch(ND);
    const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
    float* zr = smem + warp * 3 * pitch;
    float* zi = zr + pitch;
    float* out = zi + pitch;
    float2* tw_o = reinterpret_cast<float2*>(smem + kLongWarps * 3 * pitch);
    if constexpr (kSharedTw<M>) {
        for (int e = threadIdx.x; e < ND / M; e += kLongWarps * 32)
            tw_o[e] = p.tw[e * M];
        __syncthreads();
    }
    const LaneTables<M> tabs =
        inner_lane_tables<M>(p.tw, l % Row<M>::L, ND / M);
    const int map_rows = kHalo ? c.R + 2 * c.H : c.R;
    const long long total = (long long)c.batch * map_rows;
    for (long long row = (long long)blockIdx.x * kLongWarps + warp;
         row < total; row += (long long)gridDim.x * kLongWarps) {
        const int b = (int)(row / map_rows), e = (int)(row % map_rows);
        const float* rr;
        const float* ri;
        fmcw::frame_rows<kHalo>(p.xr, p.xi, p.lo_r, p.lo_i, p.hi_r, p.hi_i,
                                b, c.R, c.H, ND)
            .row(kHalo ? e - c.H : e, rr, ri);
        dense_row<M>(rr, ri, p.win, p.tw, tabs, l, c, zr, zi, out, tw_o);
        float* dst = p.mag + row * ND;
        int nf = 0;
        for (int s = V * l; s < ND; s += 32 * V) {
            if constexpr (V == 4) {
                const float4 v = *reinterpret_cast<const float4*>(out + s);
                *reinterpret_cast<float4*>(dst + s) = v;
                nf += !isfinite(v.x) + !isfinite(v.y) + !isfinite(v.z) +
                      !isfinite(v.w);
            } else if constexpr (V == 2) {
                const float2 v = *reinterpret_cast<const float2*>(out + s);
                *reinterpret_cast<float2*>(dst + s) = v;
                nf += !isfinite(v.x) + !isfinite(v.y);
            } else {
                dst[s] = out[s];
                nf += !isfinite(out[s]);
            }
        }
        nf = __reduce_add_sync(kFull, nf);
        const bool own = !kHalo || (e >= c.H && e < c.H + c.R);
        if (l == 0 && nf && own) atomicAdd(&p.nonfinite[b], nf);
        __syncwarp();
    }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <int ND, bool kHalo, bool kMean>
int launch_decision(const Params& p, cudaStream_t stream) {
    static bool ready[fmcw::kMaxDevices] = {};
    auto* kernel = slowtime_detect_kernel<ND, kHalo, kMean>;
    const cudaError_t err = fmcw::prepare(kernel, ready);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = (size_t)layout(p.c).total * sizeof(float);
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

template <int ND>
int launch_mag(const Params& p, cudaStream_t stream) {
    const long long rows = (long long)p.c.batch * p.c.R;
    const long long per_block = kMagWarps * Row<ND>::G * kMagRowsPerWarp;
    const long long blocks = (rows + per_block - 1) / per_block;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    slowtime_mag_kernel<ND><<<(unsigned)blocks, kMagWarps * 32, 0, stream>>>(
        p);
    return (int)cudaGetLastError();
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
    const size_t smem =
        (size_t)kLongWarps * 3 * map_pitch(p.c.ND) * sizeof(float) +
        (kSharedTw<M> ? (size_t)(p.c.ND / M) * sizeof(float2) : 0);
    kernel<<<(unsigned)blocks, kLongWarps * 32, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

// The map of a two-launch length (two_launch): dense_row<128> at a long
// CPI, dense_row<m> at a dense length, m = ND & -ND.
template <bool kHalo>
int launch_map_nd(const Params& p, cudaStream_t stream) {
    if (long_cpi(p.c.ND)) return launch_map<kInner, kHalo>(p, stream);
    switch (p.c.ND & -p.c.ND) {
        case 1: return launch_map<1, kHalo>(p, stream);
        case 2: return launch_map<2, kHalo>(p, stream);
        case 4: return launch_map<4, kHalo>(p, stream);
        case 8: return launch_map<8, kHalo>(p, stream);
        case 16: return launch_map<16, kHalo>(p, stream);
        case 32: return launch_map<32, kHalo>(p, stream);
        case 64: return launch_map<64, kHalo>(p, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

// A long or dense CPI's detection: the map (p.mag), then its decision.
template <bool kHalo>
int launch_two(const Params& p, cudaStream_t stream) {
    const int err = launch_map_nd<kHalo>(p, stream);
    if (err) return err;
    return fmcw::launch_decide<float, fmcw::MapSem<float>, float, kHalo>(
        {p.mag, p.det, p.row_max, p.n_dets, p.c}, stream);
}

// The lengths off a multiple of kDenseAlign below kMaxDense (1 .. 2047,
// m = ND & -ND in 1, 2, 4): this kernel's dense operator takes them too (the
// fixed slow-time kernel does not yet), with a ragged last decide chunk.
inline bool unaligned_cpi(int nd) {
    return nd >= 1 && nd < fmcw::kMaxDense && nd % fmcw::kDenseAlign != 0;
}

// The lengths that run two launches, the map kernel then the decide kernel:
// the long CPIs, the dense lengths and the lengths off a multiple of 8.
inline bool two_launch(int nd) {
    return long_cpi(nd) || fmcw::dense_cpi(nd) || unaligned_cpi(nd);
}

// The map kernel reads rows of ND floats in loads of kRowVec<m> floats
// (16 bytes where 4 | ND): their bases must be 16-byte aligned.
template <typename... T>
bool aligned16(const T*... ptrs) {
    return (((((uintptr_t)ptrs) & 15) == 0) && ...);
}

}  // namespace

// xr/xi: float32 (batch, R, ND), 16-byte aligned; win: float32 (ND,) Doppler
// window; tw: float32 (ND, 2) twiddles exp(-2 pi i m / ND); det: float32
// (batch, R, ND); mag: same or null; row_max: float32 (batch, R);
// n_dets/nonfinite: int32 (batch,), zeroed by the caller.  cfg's notch_mode
// (2 or 3), transient_zero and bypass select the pulse canceller, its
// variant the CFAR (0 OS, 1 CA, 2 GO, 3 SO).  A long CPI (ND = n2d x 128,
// n2d 2 .. 16), a dense length (fmcw::dense_cpi: 8, 24 .. 2040) or a
// length off a multiple of 8 (unaligned_cpi: 1 .. 2047) takes
// cfg's chunk W and column halo HC, needs mag (the map the decision reads)
// and row_max zeroed by the caller, and runs two launches.  Returns the
// CUDA error code of the launches (0 on success).
extern "C" int fmcw_slowtime_detect(const void* xr, const void* xi,
                                    const void* win, const void* tw,
                                    void* det, void* mag, void* row_max,
                                    void* n_dets, void* nonfinite,
                                    const SlowtimeConfig* cfg, void* stream) {
    const SlowtimeConfig c = *cfg;
    const bool two = two_launch(c.ND);
    if (!(two ? fmcw::decide_config_ok(c, true) && mag &&
                    aligned16(xr, xi, win, mag)
              : detect_config_ok(c)) ||
        !win || !tw)
        return (int)cudaErrorInvalidValue;
    Params p{static_cast<const float*>(xr), static_cast<const float*>(xi),
             nullptr, nullptr, nullptr, nullptr,
             static_cast<const float*>(win), static_cast<const float2*>(tw),
             static_cast<float*>(det),       static_cast<float*>(mag),
             static_cast<float*>(row_max),   static_cast<int*>(n_dets),
             static_cast<int*>(nonfinite),   c};
    const cudaStream_t s = (cudaStream_t)stream;
    if (two) return launch_two<false>(p, s);
    switch (c.ND) {
        case 16: return launch<16, false>(p, s);
        case 32: return launch<32, false>(p, s);
        case 64: return launch<64, false>(p, s);
        case 128: return launch<128, false>(p, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// Magnitude only: xr/xi float32 (batch, R, ND), 16-byte aligned; win/tw as
// fmcw_slowtime_detect; mag float32 (batch, R, ND); nonfinite int32
// (batch,), zeroed by the caller.  Reads cfg's batch, R, ND, exact_mag,
// notch_mode, transient_zero and bypass; ND 16, 32, 64, 128, n2d x 128
// (n2d 2 .. 16), a dense length (fmcw::dense_cpi) or a length off a
// multiple of 8 (unaligned_cpi).  Returns the CUDA error code of the launch
// (0 on success).
extern "C" int fmcw_slowtime_mag(const void* xr, const void* xi,
                                 const void* win, const void* tw, void* mag,
                                 void* nonfinite, const SlowtimeConfig* cfg,
                                 void* stream) {
    const SlowtimeConfig c = *cfg;
    if (c.batch < 1 || c.R < 1 || !win || !tw ||
        (c.notch_mode != 2 && c.notch_mode != 3))
        return (int)cudaErrorInvalidValue;
    Params p{static_cast<const float*>(xr), static_cast<const float*>(xi),
             nullptr, nullptr, nullptr, nullptr,
             static_cast<const float*>(win), static_cast<const float2*>(tw),
             nullptr,                        static_cast<float*>(mag),
             nullptr,                        nullptr,
             static_cast<int*>(nonfinite),   c};
    const cudaStream_t s = (cudaStream_t)stream;
    if (two_launch(c.ND))
        return aligned16(xr, xi, win, mag) ? launch_map_nd<false>(p, s)
                                           : (int)cudaErrorInvalidValue;
    switch (c.ND) {
        case 16: return launch_mag<16>(p, s);
        case 32: return launch_mag<32>(p, s);
        case 64: return launch_mag<64>(p, s);
        case 128: return launch_mag<128>(p, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// The split entry (a range shard on a sequence-parallel mesh): xr/xi float32
// (batch, R, ND) are the shard's rows, lo_r/lo_i and hi_r/hi_i float32
// (batch, H, ND) the H = halo_range + peak_group_radius rows just below and
// above it, exchanged from the neighbouring shards, all 16-byte aligned;
// cfg's row_off is the shard's first row in the frame and r_total the
// frame's rows (grouping ties break by global row ids).  Per-cell scale
// only, any variant.  Outputs as fmcw_slowtime_detect, for the shard's R
// rows; at a long CPI or a dense length mag is the halo-extended slab
// (batch, R + 2H, ND) whose rows H .. H + R - 1 are the shard's magnitudes
// (the map the decision reads) and row_max is zeroed by the caller.
extern "C" int fmcw_slowtime_detect_split(
        const void* xr, const void* xi, const void* lo_r, const void* lo_i,
        const void* hi_r, const void* hi_i, const void* win, const void* tw,
        void* det, void* mag, void* row_max, void* n_dets, void* nonfinite,
        const SlowtimeConfig* cfg, void* stream) {
    const SlowtimeConfig c = *cfg;
    const bool two = two_launch(c.ND);
    const bool ok =
        two ? fmcw::decide_config_ok(c, true) && fmcw::split_decide_ok(c) &&
                  mag && aligned16(xr, xi, lo_r, lo_i, hi_r, hi_i, win, mag)
            : fmcw::split_config_ok(c) && detect_config_ok(c);
    if (!ok || !lo_r || !lo_i || !hi_r || !hi_i || !win || !tw)
        return (int)cudaErrorInvalidValue;
    Params p{static_cast<const float*>(xr),   static_cast<const float*>(xi),
             static_cast<const float*>(lo_r), static_cast<const float*>(lo_i),
             static_cast<const float*>(hi_r), static_cast<const float*>(hi_i),
             static_cast<const float*>(win),  static_cast<const float2*>(tw),
             static_cast<float*>(det),        static_cast<float*>(mag),
             static_cast<float*>(row_max),    static_cast<int*>(n_dets),
             static_cast<int*>(nonfinite),    c};
    const cudaStream_t s = (cudaStream_t)stream;
    if (two) return launch_two<true>(p, s);
    switch (c.ND) {
        case 16: return launch<16, true>(p, s);
        case 32: return launch<32, true>(p, s);
        case 64: return launch<64, true>(p, s);
        case 128: return launch<128, true>(p, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
