// Fixed-point range half of the radar front-end on Hopper: Q15 window with
// saturation count, range FFT, block-floating-point quantization per chirp
// and corner turn.
//
// Replaces the range half of fmcw_tpu/ops/frontend_pallas.py::_kernel_fixed
// (steps 1-5: integer window with saturation counting, range DFT, BFP
// quantize over each chirp's range transform) and its split counterpart
// fmcw_tpu/ops/split_frontend.py::_kernel_range_fixed.
//
// In:  iq int16 (B, nd, n, 2), I/Q interleaved (read as one 32-bit word);
//      the int32 Q15 window (n,); the float64 twiddle table tw[m] = W_n^m.
// Out: int16 re/im planes, RANGE-major (B, n, nd) — the quantized values are
//      int16 by construction; sat (B,) int32 += the window's saturated
//      samples, I and Q counted separately (zeroed by the caller).
//
// Per chirp: (x * w + rnd) >> shift (arithmetic) clipped to int16, counted
// when clipped (window_multiplier.vhd:119-163); kernel A's Stockham FFT
// (fft_stockham.cuh) in FP64; s = max(0, ceil(log2(peak / 2^15))) over the
// chirp's n bins, read from the bits of the peak; each value rounded half to
// even at 2^-s and clipped to int16 (ops/fft.bfp_quantize).
//
// Why FP64: the pre-BFP values reach ~3e7, where an FP32 ulp is 2, so an
// FP32 FFT moves a value near a rounding boundary by 1 LSB and, on a noisy
// frame, a detection with it (the TPU kernel's bf16x6 FFT has the same
// 1-LSB contract).  In FP64, with the twiddles exact at the quarter turns
// (ops/fft.twiddles64), the quantized values are the float64 golden
// model's, and the plain twin's (dense FP64 product) too.
//
// Bound on an H100: bytes.  Per 1024x128 frame 0.5 MiB is read and 0.5 MiB
// written; the FFT is 5 n log2 n FP64 flops per chirp.  Design: kernel A's
// (one block per 8 chirps, the window in the load, the FFT in shared memory,
// the corner turn in the store — 8 consecutive int16 per range row and
// plane), with 512 threads so that a stage's FP64 butterflies fit in
// registers, plus one warp per chirp for its BFP peak.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_stockham.cuh"

namespace {

constexpr int kChirps = 8;      // chirps per block, one warp each for BFP
constexpr int kThreads = 512;
constexpr int kPad = 4;         // row pad of the planar shared buffers
constexpr int kMaxRange = 1024;

__global__ void __launch_bounds__(kThreads)
range_fft_fixed_kernel(const uint32_t* __restrict__ iq,
                       const int* __restrict__ win,
                       const double2* __restrict__ tw,
                       int16_t* __restrict__ out_re,
                       int16_t* __restrict__ out_im, int* __restrict__ sat,
                       int nd, int log2n, int rnd, int shift) {
    extern __shared__ double smem[];
    const int n = 1 << log2n;
    const int stride = n + kPad;
    double* bre = smem;
    double* bim = smem + kChirps * stride;
    double2* tws = reinterpret_cast<double2*>(bim + kChirps * stride);
    double* scale_s = reinterpret_cast<double*>(tws + n);   // kChirps
    int* sat_s = reinterpret_cast<int*>(scale_s + kChirps);
    const int b = blockIdx.y;
    const int c0 = blockIdx.x * kChirps;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;

    if (threadIdx.x == 0) *sat_s = 0;
    for (int i = threadIdx.x; i < n; i += kThreads) tws[i] = tw[i];
    // 1. Integer window with saturation count.
    const uint32_t* src = iq + ((size_t)b * nd + c0) * n;
    int my_sat = 0;
    for (int idx = threadIdx.x; idx < kChirps * n; idx += kThreads) {
        const int g = idx >> log2n;
        const int s = idx & (n - 1);
        const uint32_t word = src[idx];
        const int w = win[s];
        int si, sq;
        const int vi = fmcw::window_q15((int16_t)(word & 0xffffu), w, rnd,
                                        shift, &si);
        const int vq = fmcw::window_q15((int16_t)(word >> 16), w, rnd, shift,
                                        &sq);
        my_sat += si + sq;
        bre[g * stride + s] = (double)vi;
        bim[g * stride + s] = (double)vq;
    }
    my_sat = fmcw::warp_sum(my_sat);
    __syncthreads();                    // *sat_s = 0 and the window stores
    if (lane == 0 && my_sat) atomicAdd(sat_s, my_sat);
    // 2. Range FFT.
    fmcw::stockham_fft<kChirps * kMaxRange, kThreads>(bre, bim, tws, kChirps,
                                                      stride, log2n);
    // 3. BFP exponent per chirp: warp g takes chirp g.
    if (warp < kChirps) {
        const double* pr = bre + warp * stride;
        const double* pi = bim + warp * stride;
        double pk = 0.0;
        for (int s = lane; s < n; s += 32)
            pk = fmax(pk, fmax(fabs(pr[s]), fabs(pi[s])));
        pk = fmcw::warp_max(pk);
        if (lane == 0) scale_s[warp] = fmcw::bfp_scale(pk);
    }
    __syncthreads();
    // 4. Quantize and corner-turn: range-major, kChirps int16 per row.
    int16_t* dst_re = out_re + (size_t)b * n * nd + c0;
    int16_t* dst_im = out_im + (size_t)b * n * nd + c0;
    for (int idx = threadIdx.x; idx < kChirps * n; idx += kThreads) {
        const int g = idx & (kChirps - 1);
        const int s = idx / kChirps;
        const double sc = scale_s[g];
        dst_re[(size_t)s * nd + g] =
            (int16_t)fmcw::bfp_quantize(bre[g * stride + s], sc);
        dst_im[(size_t)s * nd + g] =
            (int16_t)fmcw::bfp_quantize(bim[g * stride + s], sc);
    }
    if (threadIdx.x == 0 && *sat_s) atomicAdd(&sat[b], *sat_s);
}

}  // namespace

// iq: int16 (batch, nd, n, 2); win: int32 (n,) Q15 coefficients; tw: complex
// float64 (n,) with tw[m] = exp(-2 pi i m / n); out_re/out_im: int16
// (batch, n, nd); sat: int32 (batch,), zeroed by the caller.  rnd/shift: the
// window's rounding constant and extraction shift.  Returns the CUDA error
// code of the launch (0 on success).
extern "C" int fmcw_range_fft_fixed(const void* iq, const void* win,
                                    const void* tw, void* out_re,
                                    void* out_im, void* sat, int batch,
                                    int nd, int n, int rnd, int shift,
                                    void* stream) {
    int log2n = 0;
    while ((1 << log2n) < n) ++log2n;
    if (batch < 1 || batch > 65535 || n != (1 << log2n) || n < 16 ||
        n > kMaxRange || nd < kChirps || nd % kChirps != 0 || shift < 1 ||
        shift > 30)
        return (int)cudaErrorInvalidValue;
    const size_t smem = 2 * kChirps * (n + kPad) * sizeof(double) +
                        n * sizeof(double2) + kChirps * sizeof(double) +
                        sizeof(int);
    cudaError_t err = cudaFuncSetAttribute(
        range_fft_fixed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(nd / kChirps, batch);
    range_fft_fixed_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        static_cast<const uint32_t*>(iq), static_cast<const int*>(win),
        static_cast<const double2*>(tw), static_cast<int16_t*>(out_re),
        static_cast<int16_t*>(out_im), static_cast<int*>(sat), nd, log2n, rnd,
        shift);
    return (int)cudaGetLastError();
}
