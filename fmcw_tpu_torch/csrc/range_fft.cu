// Kernel A of the radar front-end on Hopper: Hamming window, range FFT and
// corner turn.
//
// Replaces the first half of fmcw_tpu/ops/frontend_pallas.py::_kernel
// (stages 1-4 of its docstring: window, outer DFT over the lane slices,
// twiddle, inner 128-point DFT on the MXU) and its split counterpart
// fmcw_tpu/ops/split_frontend.py::_kernel_range.  The TPU kernel keeps the
// whole 1 MiB frame in VMEM; an SM holds at most 227 KB, so the frame is cut
// along the chirp axis instead: one block transforms kChirps chirps, and the
// slow-time half runs as kernel B (slowtime_detect.cu) on range tiles.
//
// In:  iq int16 (B, nd, n, 2), I/Q interleaved (read as one 32-bit word),
//      or (fmcw_range_fft_float, the array model's beamformed data) planar
//      float32 re/im (B, nd, n) — the TPU kernel casts either type to f32
//      before the window (frontend_pallas.py:672-673).
// Out: planar float32 re/im, RANGE-major (B, n, nd) — the corner turn is this
//      kernel's store.
//
// Bound on an H100: bytes.  Per 1024x128 frame 0.5 MiB is read (1 MiB for
// float input) and 1 MiB written (~0.47 us at 3.35 TB/s); the FFT is 5 n log2 n flops per chirp,
// ~6.6 MFLOP per frame (~0.1 us at 67 TFLOP/s FP32).  Design against it:
//  * each sample is read once, coalesced, and each output written once;
//  * the FFT runs in shared memory as a Stockham radix-4 (radix-2 for an odd
//    power) autosort transform, in place: each stage reads its butterflies
//    into registers, synchronises, and writes them back, so one buffer
//    serves all stages and the output comes out in natural order
//    (fft_stockham.cuh, shared with the fixed-point kernels);
//  * twiddles W_n^m are a float32 table computed in float64 on the host
//    (the way fmcw_tpu/ops/frontend_pallas.py::_ct_split builds its table);
//  * the corner-turned store writes kChirps = 8 consecutive floats (one
//    32-byte sector) per range row and plane; the planar shared buffers are
//    padded by kPad floats per row so that read is free of bank conflicts.
// FP32 throughout; agreement with the plain twin (window times dense DFT
// matmul) is held to 1e-5 of the map peak, not bit-exact.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_stockham.cuh"

namespace {

constexpr int kChirps = 8;      // chirps per block
constexpr int kThreads = 256;
constexpr int kPad = 4;         // row pad of the planar shared buffers
constexpr int kMaxRange = 1024;

// kFloat: the input is two float32 planes (src0 = re, src1 = im); else
// src0 is the int16 I/Q pairs.
template <bool kFloat>
__global__ void __launch_bounds__(kThreads)
range_fft_kernel(const void* __restrict__ src0, const void* __restrict__ src1,
                 const float* __restrict__ win, const float2* __restrict__ tw,
                 float* __restrict__ out_re, float* __restrict__ out_im,
                 int nd, int log2n) {
    extern __shared__ float smem[];
    const int n = 1 << log2n;
    const int stride = n + kPad;
    float* bre = smem;
    float* bim = smem + kChirps * stride;
    float2* tws = reinterpret_cast<float2*>(bim + kChirps * stride);
    const int b = blockIdx.y;
    const int c0 = blockIdx.x * kChirps;

    for (int i = threadIdx.x; i < n; i += kThreads) tws[i] = tw[i];
    // 1. Window (one coalesced pass over the block's kChirps chirps).
    const size_t off = ((size_t)b * nd + c0) * n;
    for (int idx = threadIdx.x; idx < kChirps * n; idx += kThreads) {
        const int g = idx >> log2n;
        const int s = idx & (n - 1);
        float xr, xi;
        if constexpr (kFloat) {
            xr = static_cast<const float*>(src0)[off + idx];
            xi = static_cast<const float*>(src1)[off + idx];
        } else {
            const uint32_t word = static_cast<const uint32_t*>(src0)[off + idx];
            xr = (float)(int16_t)(word & 0xffffu);
            xi = (float)(int16_t)(word >> 16);
        }
        const float w = win[s];
        bre[g * stride + s] = __fmul_rn(xr, w);
        bim[g * stride + s] = __fmul_rn(xi, w);
    }
    __syncthreads();
    // 2. Range FFT: radix-4 stages, one radix-2 stage for an odd power.
    fmcw::stockham_fft<kChirps * kMaxRange, kThreads>(bre, bim, tws, kChirps,
                                                      stride, log2n);
    // 3. Corner turn: range-major store, kChirps consecutive floats per row.
    float* dst_re = out_re + (size_t)b * n * nd + c0;
    float* dst_im = out_im + (size_t)b * n * nd + c0;
    for (int idx = threadIdx.x; idx < kChirps * n; idx += kThreads) {
        const int g = idx & (kChirps - 1);
        const int s = idx / kChirps;
        dst_re[(size_t)s * nd + g] = bre[g * stride + s];
        dst_im[(size_t)s * nd + g] = bim[g * stride + s];
    }
}

template <bool kFloat>
int launch(const void* src0, const void* src1, const void* win,
           const void* tw, void* out_re, void* out_im, int batch, int nd,
           int n, void* stream) {
    int log2n = 0;
    while ((1 << log2n) < n) ++log2n;
    if (batch < 1 || batch > 65535 || n != (1 << log2n) || n < 16 ||
        n > kMaxRange || nd < kChirps || nd % kChirps != 0)
        return (int)cudaErrorInvalidValue;
    const size_t smem =
        2 * kChirps * (n + kPad) * sizeof(float) + n * sizeof(float2);
    cudaError_t err = cudaFuncSetAttribute(
        range_fft_kernel<kFloat>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(nd / kChirps, batch);
    range_fft_kernel<kFloat><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        src0, src1, static_cast<const float*>(win),
        static_cast<const float2*>(tw), static_cast<float*>(out_re),
        static_cast<float*>(out_im), nd, log2n);
    return (int)cudaGetLastError();
}

}  // namespace

// iq: int16 (batch, nd, n, 2); win: float32 (n,); tw: complex float32 (n,)
// with tw[m] = exp(-2 pi i m / n); out_re/out_im: float32 (batch, n, nd).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int fmcw_range_fft(const void* iq, const void* win, const void* tw,
                              void* out_re, void* out_im, int batch, int nd,
                              int n, void* stream) {
    return launch<false>(iq, nullptr, win, tw, out_re, out_im, batch, nd, n,
                         stream);
}

// The same for planar float32 input re/im (batch, nd, n).
extern "C" int fmcw_range_fft_float(const void* re, const void* im,
                                    const void* win, const void* tw,
                                    void* out_re, void* out_im, int batch,
                                    int nd, int n, void* stream) {
    return launch<true>(re, im, win, tw, out_re, out_im, batch, nd, n,
                        stream);
}
