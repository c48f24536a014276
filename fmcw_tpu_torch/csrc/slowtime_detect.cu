// Kernel B of the radar front-end on Hopper: slow-time chain (MTI, Doppler
// window, Doppler FFT), magnitude, 2D OS-CFAR decision and peak grouping on
// a tile of range rows.
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
// transforms proceed.
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

#include <cuda_runtime.h>
#include <stdint.h>

#include "cfar_common.cuh"
#include "cfar_tile.cuh"
#include "slowtime_common.cuh"

namespace {

using fmcw::kMaxBlk;
using fmcw::kMaxSmem;
using fmcw::Row;
constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr int kMagWarps = 8;            // magnitude-only kernel
constexpr int kMagRowsPerWarp = 4;
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
    float2 stw[Row<ND>::kLog2L];
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
    const int k1 = (int)(__brev((unsigned)l) >> (32 - R::kLog2L));
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
    const int k1 = (int)(__brev((unsigned)l) >> (32 - R::kLog2L));
    const bool exact = c.exact_mag != 0;
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
           c.n_ref <= fmcw::kMaxPackedRef<float> &&
           (c.notch_mode == 2 || c.notch_mode == 3) &&
           (fmcw::strip_units(rows, c.ND) + kThreads - 1) / kThreads *
                   fmcw::kStrip <= 64 &&
           (size_t)layout(c).total * sizeof(float) <= (size_t)kMaxSmem;
}

template <int ND, bool kHalo>
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
    //         H-pgr .. H+T+pgr.
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
    } else if (c.so == 0) {
        fmcw::tile_colsums(mag_s, ND, e_first, rows, g, det_s, cs_guard);
        __syncthreads();
    }
    fmcw::decide_tile(mag_s, det_s, e_first, rows, ND, det_s, cs_guard,
                      scale_blk, c.sb, c.so, g);

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
// Launch
// ---------------------------------------------------------------------------

template <int ND, bool kHalo>
int launch(const Params& p, cudaStream_t stream) {
    static bool ready[fmcw::kMaxDevices] = {};
    auto* kernel = slowtime_detect_kernel<ND, kHalo>;
    const cudaError_t err = fmcw::prepare(kernel, ready);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = (size_t)layout(p.c).total * sizeof(float);
    const dim3 grid(p.c.R / p.c.T, p.c.batch);
    kernel<<<grid, kThreads, smem, stream>>>(p);
    return (int)cudaGetLastError();
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

}  // namespace

// xr/xi: float32 (batch, R, ND), 16-byte aligned; win: float32 (ND,) Doppler
// window; tw: float32 (ND, 2) twiddles exp(-2 pi i m / ND); det: float32
// (batch, R, ND); mag: same or null; row_max: float32 (batch, R);
// n_dets/nonfinite: int32 (batch,), zeroed by the caller.  cfg's notch_mode
// (2 or 3), transient_zero and bypass select the pulse canceller.  Returns
// the CUDA error code of the launch (0 on success).
extern "C" int fmcw_slowtime_detect(const void* xr, const void* xi,
                                    const void* win, const void* tw,
                                    void* det, void* mag, void* row_max,
                                    void* n_dets, void* nonfinite,
                                    const SlowtimeConfig* cfg, void* stream) {
    const SlowtimeConfig c = *cfg;
    if (!detect_config_ok(c) || !win || !tw)
        return (int)cudaErrorInvalidValue;
    Params p{static_cast<const float*>(xr), static_cast<const float*>(xi),
             nullptr, nullptr, nullptr, nullptr,
             static_cast<const float*>(win), static_cast<const float2*>(tw),
             static_cast<float*>(det),       static_cast<float*>(mag),
             static_cast<float*>(row_max),   static_cast<int*>(n_dets),
             static_cast<int*>(nonfinite),   c};
    const cudaStream_t s = (cudaStream_t)stream;
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
// notch_mode, transient_zero and bypass.  Returns the CUDA error code of
// the launch (0 on success).
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
// only.  Outputs as fmcw_slowtime_detect, for the shard's R rows.
extern "C" int fmcw_slowtime_detect_split(
        const void* xr, const void* xi, const void* lo_r, const void* lo_i,
        const void* hi_r, const void* hi_i, const void* win, const void* tw,
        void* det, void* mag, void* row_max, void* n_dets, void* nonfinite,
        const SlowtimeConfig* cfg, void* stream) {
    const SlowtimeConfig c = *cfg;
    if (!fmcw::split_config_ok(c) || !detect_config_ok(c) || !lo_r ||
        !lo_i || !hi_r || !hi_i || !win || !tw)
        return (int)cudaErrorInvalidValue;
    Params p{static_cast<const float*>(xr),   static_cast<const float*>(xi),
             static_cast<const float*>(lo_r), static_cast<const float*>(lo_i),
             static_cast<const float*>(hi_r), static_cast<const float*>(hi_i),
             static_cast<const float*>(win),  static_cast<const float2*>(tw),
             static_cast<float*>(det),        static_cast<float*>(mag),
             static_cast<float*>(row_max),    static_cast<int*>(n_dets),
             static_cast<int*>(nonfinite),    c};
    const cudaStream_t s = (cudaStream_t)stream;
    switch (c.ND) {
        case 16: return launch<16, true>(p, s);
        case 32: return launch<32, true>(p, s);
        case 64: return launch<64, true>(p, s);
        case 128: return launch<128, true>(p, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
