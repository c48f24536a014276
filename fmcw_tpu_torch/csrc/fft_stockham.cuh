// Shared device code of the transforms: an in-place Stockham autosort FFT
// over rows held in shared memory (radix-4 stages, one radix-2 stage for an
// odd power of two), and the block-floating-point quantizer and Q15 window
// of the fixed-point chain.  Used by range_fft.cu (float), range_fft_fixed.cu
// and slowtime_detect_fixed.cu (double).
//
// The FFT is templated on its real type T (float or double): twiddles W_n^m
// are a table of T pairs computed in float64 on the host.  Each stage reads
// its butterflies into registers, synchronises and writes them back, so one
// buffer serves all stages and the output is in natural order.
#pragma once

#include <cuda_runtime.h>

namespace fmcw {

template <typename T> struct Cplx;
template <> struct Cplx<float> { using type = float2; };
template <> struct Cplx<double> { using type = double2; };

// Forward R-point DFT (R = 2 or 4) in registers.
template <int R, typename T>
__device__ __forceinline__ void dft_small(T (&vr)[R], T (&vi)[R]) {
    if constexpr (R == 2) {
        const T ar = vr[0], ai = vi[0];
        vr[0] = ar + vr[1];
        vi[0] = ai + vi[1];
        vr[1] = ar - vr[1];
        vi[1] = ai - vi[1];
    } else {
        // Forward 4-point DFT, W_4 = -i.
        const T t0r = vr[0] + vr[2], t0i = vi[0] + vi[2];
        const T t1r = vr[0] - vr[2], t1i = vi[0] - vi[2];
        const T t2r = vr[1] + vr[3], t2i = vi[1] + vi[3];
        const T t3r = vr[1] - vr[3], t3i = vi[1] - vi[3];
        vr[0] = t0r + t2r;  vi[0] = t0i + t2i;
        vr[2] = t0r - t2r;  vi[2] = t0i - t2i;
        vr[1] = t1r + t3i;  vi[1] = t1i - t3r;   // t1 - i t3
        vr[3] = t1r - t3i;  vi[3] = t1i + t3r;   // t1 + i t3
    }
}

// One Stockham radix-R stage over `rows` rows of n = 2^log2n points (row g
// at bre/bim + g * stride), in place; all kThreads threads of the block call
// it.  ns = product of the radices already applied.  Butterfly j of a row
// reads x[j + r n/R], twiddles it by W_{ns R}^{r (j mod ns)} = tws[r (j mod
// ns) n/(ns R)] (tws[m] = W_n^m), and writes the R-point DFT to
// x[(j - j mod ns) R + j mod ns + r ns].  kMaxPoints bounds rows * n.
template <int R, int kMaxPoints, int kThreads, typename T>
__device__ __forceinline__ void stockham_stage(
        T* bre, T* bim, const typename Cplx<T>::type* tws, int rows,
        int stride, int log2n, int log2ns) {
    constexpr int kLog2R = R == 4 ? 2 : 1;
    constexpr int kMax = (kMaxPoints / R + kThreads - 1) / kThreads;
    const int ns = 1 << log2ns;
    const int log2nb = log2n - kLog2R;
    const int nb = 1 << log2nb;
    const int total = rows * nb;
    const int tw_shift = log2n - log2ns - kLog2R;   // n / (ns R)
    T vr[kMax][R], vi[kMax][R];
#pragma unroll
    for (int it = 0; it < kMax; ++it) {
        const int idx = threadIdx.x + it * kThreads;
        if (idx < total) {
            const int g = idx >> log2nb;
            const int j = idx & (nb - 1);
            const int k = j & (ns - 1);
            const T* pr = bre + g * stride;
            const T* pi = bim + g * stride;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                T xr = pr[j + r * nb];
                T xi = pi[j + r * nb];
                if (r > 0) {
                    const auto w = tws[(r * k) << tw_shift];
                    const T tr = xr * w.x - xi * w.y;
                    const T ti = xr * w.y + xi * w.x;
                    xr = tr;
                    xi = ti;
                }
                vr[it][r] = xr;
                vi[it][r] = xi;
            }
            dft_small<R, T>(vr[it], vi[it]);
        }
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < kMax; ++it) {
        const int idx = threadIdx.x + it * kThreads;
        if (idx < total) {
            const int g = idx >> log2nb;
            const int j = idx & (nb - 1);
            const int k = j & (ns - 1);
            const int dst = (j - k) * R + k;
            T* pr = bre + g * stride;
            T* pi = bim + g * stride;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                pr[dst + r * ns] = vr[it][r];
                pi[dst + r * ns] = vi[it][r];
            }
        }
    }
    __syncthreads();
}

// Forward FFT of `rows` rows of n = 2^log2n points in place (see
// stockham_stage); all kThreads threads call it.
template <int kMaxPoints, int kThreads, typename T>
__device__ __forceinline__ void stockham_fft(T* bre, T* bim,
                                             const typename Cplx<T>::type* tws,
                                             int rows, int stride, int log2n) {
    int log2ns = 0;
    while (log2n - log2ns >= 2) {
        stockham_stage<4, kMaxPoints, kThreads>(bre, bim, tws, rows, stride,
                                                log2n, log2ns);
        log2ns += 2;
    }
    if (log2n - log2ns == 1)
        stockham_stage<2, kMaxPoints, kThreads>(bre, bim, tws, rows, stride,
                                                log2n, log2ns);
}

// Block-floating-point scale 2^-s, s = max(0, ceil(log2(max(peak, 1) /
// 2^15))), read exactly from the double's bits: for p >= 1, ceil(log2 p) =
// unbiased exponent + (mantissa != 0).  (fmcw_tpu/ops/frontend_pallas.py
// ::_bfp_scale reads float32 bits the same way; the twin is
// ops/fft.bfp_quantize.)
__device__ __forceinline__ double bfp_scale(double peak) {
    const long long bits = __double_as_longlong(fmax(peak, 1.0));
    const int cl2 = (int)(bits >> 52) - 1023 +
                    ((bits & 0xfffffffffffffLL) != 0);
    const int s = cl2 > 15 ? cl2 - 15 : 0;
    return __longlong_as_double((long long)(1023 - s) << 52);
}

// round half to even (x * scale), clipped to int16; the scale is a power of
// two, so the product is exact.
__device__ __forceinline__ int bfp_quantize(double x, double scale) {
    const double v = rint(__dmul_rn(x, scale));
    return (int)fmin(fmax(v, -32768.0), 32767.0);
}

// Q15 window multiply of the fixed chain (window_multiplier.vhd:119-163):
// (x * w + rnd) >> shift, arithmetic; *sat is set when it leaves int16.
__device__ __forceinline__ int window_q15(int x, int w, int rnd, int shift,
                                          int* sat) {
    const int v = (x * w + rnd) >> shift;
    *sat = (v > 32767) | (v < -32768);
    return v > 32767 ? 32767 : (v < -32768 ? -32768 : v);
}

// Max over a warp of non-negative values.
__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// Sum over a warp.
__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

}  // namespace fmcw
