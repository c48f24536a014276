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
// The Doppler window's saturations are counted on the shard's own rows
// only: a halo row is counted by the shard that owns it.
//
// In:  int16 re/im planes, range-major (B, R, ND), from range_fft_fixed.cu;
//      the int32 Q15 Doppler window (ND,); the float64 twiddles tw[m] =
//      W_ND^m.
// Out: det int32 (B, R, ND) zero-suppressed detections, row_max int32
//      (B, R), n_dets and sat (B,) int32 (sat: the Doppler window's
//      saturated samples of the tile's own rows, I and Q counted
//      separately), and the int32 magnitude map (B, R, ND) when asked for.
//
// Tiles as slowtime_detect.cu (slowtime_common.cuh): one block per (frame,
// T = 64 range rows) computes the magnitudes of E = T + 2H rows.  Every step
// before the CFAR is local to a range row — the BFP exponent is taken over
// the row's own Doppler spectrum — so a halo row's magnitudes are exactly
// the ones its own tile computes.  Unlike the float kernel, MTI and the
// window do not fold into one slow-time matrix (MTI saturates, the window
// rounds); they run elementwise on integers before a plain ND-point FFT,
// as _kernel_fixed does.
//
// Bound on an H100: operations (integer CFAR counting, then the FFT); the
// bytes are 0.5 MiB in and 0.5 MiB out per 1024x128 frame.  Design: the FFT
// is the FP64 Stockham transform of fft_stockham.cuh (FP64 for the reason
// range_fft_fixed.cu gives), over kChunk rows at a time so that the FP64
// buffers fit in shared memory beside the E x ND int magnitudes; the
// buffers then hold the decision rows.  The decision is cfar_common.cuh on
// the shared int32 magnitude tile, bit-identical to the plain integer CFAR
// (ops/cfar.py) on the same magnitudes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cfar_common.cuh"
#include "fft_stockham.cuh"
#include "slowtime_common.cuh"

namespace {

using fmcw::kMaxBlk;
using fmcw::kMaxRows;
constexpr int kThreads = 512;
constexpr int kChunk = 32;      // rows per FFT pass

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

// Shared memory: tws (ND double2), the FFT buffers (2 x kChunk x ND doubles,
// later the int decision rows: T + 2 pgr <= kMaxRows rows of ND ints fit),
// kChunk BFP scales, the E x ND int magnitudes, the block statistics, T row
// maxima and 3 counters.
size_t smem_bytes(const SlowtimeConfig& c) {
    const int E = c.T + 2 * c.H;
    return (size_t)c.ND * sizeof(double2) +
           (size_t)(2 * kChunk * c.ND + kChunk) * sizeof(double) +
           (size_t)(E * c.ND + 5 * kMaxBlk + c.T + 3) * 4;
}

template <int ND, bool kHalo>
__global__ void __launch_bounds__(kThreads, 1)
slowtime_detect_fixed_kernel(const Params p) {
    static_assert(2 * kChunk * ND * sizeof(double) >=
                  kMaxRows * ND * sizeof(int), "decision rows fit");
    extern __shared__ double2 smem2[];
    const SlowtimeConfig& c = p.c;
    const int E = c.T + 2 * c.H;
    double2* tws = smem2;                             // ND twiddles
    double* bre = reinterpret_cast<double*>(tws + ND);
    double* bim = bre + kChunk * ND;                  // FFT, then det rows
    double* bsc = bim + kChunk * ND;                  // kChunk BFP scales
    int* mag_s = reinterpret_cast<int*>(bsc + kChunk);  // E x ND
    int* bsum = mag_s + E * ND;
    int* bnb = bsum + kMaxBlk;
    int* bhi = bnb + kMaxBlk;
    int* blo = bhi + kMaxBlk;
    int* bscale = blo + kMaxBlk;
    int* rmax_s = bscale + kMaxBlk;                   // T row maxima
    int* counts = rmax_s + c.T;                       // n_dets, -, sat
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int b = blockIdx.y;
    const int r0 = blockIdx.x * c.T;
    const auto frame = fmcw::frame_rows<kHalo>(p.xr, p.xi, p.lo_r, p.lo_i,
                                               p.hi_r, p.hi_i, b, c.R, c.H,
                                               ND);
    constexpr int kLog2 = ND == 16 ? 4 : ND == 32 ? 5 : ND == 64 ? 6 : 7;

    for (int i = tid; i < c.T; i += kThreads) rmax_s[i] = 0;
    if (tid < 3) counts[tid] = 0;
    for (int i = tid; i < ND; i += kThreads) tws[i] = p.tw[i];

    // ---- 1-4 over the E rows r0-H .. r0+T+H-1, kChunk rows at a time.
    int my_sat = 0;
    for (int e0 = 0; e0 < E; e0 += kChunk) {
        const int rows = E - e0 < kChunk ? E - e0 : kChunk;
        // 1. Saturating MTI + integer Doppler window.
        for (int idx = tid; idx < rows * ND; idx += kThreads) {
            const int e = e0 + idx / ND;
            const int ch = idx % ND;
            const int16_t* row_r;
            const int16_t* row_i;
            frame.row(r0 - c.H + e, row_r, row_i);
            const bool own = e >= c.H && e < c.H + c.T;
            const int w = p.win[ch];
#pragma unroll
            for (int part = 0; part < 2; ++part) {
                const int16_t* row = part ? row_i : row_r;
                const int x0 = row[ch];
                int y = x0;
                if (!c.bypass) {
                    const int x1 = ch >= 1 ? row[ch - 1] : 0;
                    if (c.notch_mode == 2) {
                        y = x0 - x1;
                    } else {
                        const int x2 = ch >= 2 ? row[ch - 2] : 0;
                        y = x0 - 2 * x1 + x2;
                    }
                    y = y > 32767 ? 32767 : (y < -32768 ? -32768 : y);
                    if (c.transient_zero && ch < c.notch_mode - 1) y = 0;
                }
                int s;
                const int v = fmcw::window_q15(y, w, c.rnd, c.shift, &s);
                if (own) my_sat += s;
                (part ? bim : bre)[idx] = (double)v;
            }
        }
        __syncthreads();                    // counters, tws, FFT inputs
        // 2. Doppler FFT of the chunk's rows.
        fmcw::stockham_fft<kChunk * ND, kThreads>(bre, bim, tws, rows, ND,
                                                  kLog2);
        // 3. BFP exponent per range bin: one warp per row.
        for (int e = warp; e < rows; e += kThreads / 32) {
            double pk = 0.0;
            for (int ch = lane; ch < ND; ch += 32)
                pk = fmax(pk, fmax(fabs(bre[e * ND + ch]),
                                   fabs(bim[e * ND + ch])));
            pk = fmcw::warp_max(pk);
            if (lane == 0) bsc[e] = fmcw::bfp_scale(pk);
        }
        __syncthreads();
        // 4. Quantize and take the integer magnitude
        //    max + (min >> 2) + (min >> 3) (magnitude_calc.vhd:70-88).
        for (int idx = tid; idx < rows * ND; idx += kThreads) {
            const double sc = bsc[idx / ND];
            const int ar = abs(fmcw::bfp_quantize(bre[idx], sc));
            const int ai = abs(fmcw::bfp_quantize(bim[idx], sc));
            const int mx = ar > ai ? ar : ai;
            const int mn = ar > ai ? ai : ar;
            mag_s[e0 * ND + idx] = mx + (mn >> 2) + (mn >> 3);
        }
        __syncthreads();                    // the buffers are reused
    }
    my_sat = fmcw::warp_sum(my_sat);
    if (lane == 0 && my_sat) atomicAdd(&counts[2], my_sat);

    // ---- 5. Integer CFAR (block or per-cell scale), grouping, outputs.
    const fmcw::CfarGeom g{c.hr, c.hd, c.gr, c.gd, c.n_ref, c.k,
                           c.scale_min, c.scale_nom, c.scale_max};
    if (c.block_mode)
        fmcw::block_scale_tile(mag_s, E, ND, c.sb, c.n_blk, c.k_blk, g, bsum,
                               bnb, bhi, blo, bscale);
    int* det_s = reinterpret_cast<int*>(bre);
    fmcw::decide_rows(mag_s, det_s, c.H - c.pgr, c.T + 2 * c.pgr, ND, bscale,
                      c.sb, c.block_mode != 0, c.so, g);
    __syncthreads();
    const size_t out0 = ((size_t)b * c.R + r0) * ND;
    fmcw::group_store(det_s, mag_s, c.T, c.H, c.pgr, c.r_total, ND,
                      c.row_off + r0, out0, p.det, p.mag, rmax_s, counts);
    __syncthreads();
    for (int t = tid; t < c.T; t += kThreads)
        p.row_max[(size_t)b * c.R + r0 + t] = rmax_s[t];
    if (tid == 0) {
        if (counts[0]) atomicAdd(&p.n_dets[b], counts[0]);
        if (counts[2]) atomicAdd(&p.sat[b], counts[2]);
    }
}

template <int ND, bool kHalo>
int launch(const Params& p, cudaStream_t stream) {
    const size_t smem = smem_bytes(p.c);
    cudaError_t err = cudaFuncSetAttribute(
        slowtime_detect_fixed_kernel<ND, kHalo>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(p.c.R / p.c.T, p.c.batch);
    slowtime_detect_fixed_kernel<ND, kHalo>
        <<<grid, kThreads, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

}  // namespace

// xr/xi: int16 (batch, R, ND); win: int32 (ND,); tw: complex float64 (ND,)
// with tw[m] = exp(-2 pi i m / ND); det: int32 (batch, R, ND); mag: same or
// null; row_max: int32 (batch, R); n_dets/sat: int32 (batch,), zeroed by
// the caller.  Returns the CUDA error code of the launch (0 on success).
extern "C" int fmcw_slowtime_detect_fixed(const void* xr, const void* xi,
                                          const void* win, const void* tw,
                                          void* det, void* mag, void* row_max,
                                          void* n_dets, void* sat,
                                          const SlowtimeConfig* cfg,
                                          void* stream) {
    const SlowtimeConfig c = *cfg;
    if (!fmcw::slowtime_config_ok(c) ||
        (c.notch_mode != 2 && c.notch_mode != 3) || c.shift < 1 ||
        c.shift > 30)
        return (int)cudaErrorInvalidValue;
    Params p{static_cast<const int16_t*>(xr), static_cast<const int16_t*>(xi),
             nullptr, nullptr, nullptr, nullptr,
             static_cast<const int*>(win),    static_cast<const double2*>(tw),
             static_cast<int*>(det),          static_cast<int*>(mag),
             static_cast<int*>(row_max),      static_cast<int*>(n_dets),
             static_cast<int*>(sat),          c};
    const cudaStream_t s = (cudaStream_t)stream;
    switch (c.ND) {
        case 16: return launch<16, false>(p, s);
        case 32: return launch<32, false>(p, s);
        case 64: return launch<64, false>(p, s);
        case 128: return launch<128, false>(p, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// The split entry (a range shard on a sequence-parallel mesh): xr/xi int16
// (batch, R, ND) are the shard's rows, lo_r/lo_i and hi_r/hi_i int16
// (batch, H, ND) the H = halo_range + peak_group_radius rows just below and
// above it, exchanged from the neighbouring shards; cfg's row_off and
// r_total place the shard in the frame.  Per-cell scale only.  Outputs as
// fmcw_slowtime_detect_fixed, for the shard's R rows; sat counts the
// Doppler window's saturations of those rows only.
extern "C" int fmcw_slowtime_detect_fixed_split(
        const void* xr, const void* xi, const void* lo_r, const void* lo_i,
        const void* hi_r, const void* hi_i, const void* win, const void* tw,
        void* det, void* mag, void* row_max, void* n_dets, void* sat,
        const SlowtimeConfig* cfg, void* stream) {
    const SlowtimeConfig c = *cfg;
    if (!fmcw::split_config_ok(c) || (c.notch_mode != 2 && c.notch_mode != 3) ||
        c.shift < 1 || c.shift > 30 || !lo_r || !lo_i || !hi_r || !hi_i)
        return (int)cudaErrorInvalidValue;
    Params p{static_cast<const int16_t*>(xr),   static_cast<const int16_t*>(xi),
             static_cast<const int16_t*>(lo_r), static_cast<const int16_t*>(lo_i),
             static_cast<const int16_t*>(hi_r), static_cast<const int16_t*>(hi_i),
             static_cast<const int*>(win),      static_cast<const double2*>(tw),
             static_cast<int*>(det),            static_cast<int*>(mag),
             static_cast<int*>(row_max),        static_cast<int*>(n_dets),
             static_cast<int*>(sat),            c};
    const cudaStream_t s = (cudaStream_t)stream;
    switch (c.ND) {
        case 16: return launch<16, true>(p, s);
        case 32: return launch<32, true>(p, s);
        case 64: return launch<64, true>(p, s);
        case 128: return launch<128, true>(p, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
