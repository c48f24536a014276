// Shared device code of the fixed-point chain: the block-floating-point
// scale and quantizer, the Q15 window multiply, table loads and warp
// reductions.  Used by range_fft_fixed.cu and slowtime_detect_fixed.cu.
#pragma once

#include <cuda_runtime.h>

namespace fmcw {

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

// Max of non-negative values over each group of W lanes of a warp (W a
// power of two up to 32; all 32 lanes call it).
template <int W = 32>
__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
    for (int o = W / 2; o > 0; o >>= 1)
        v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o, W));
    return v;
}

// Loads the compiler may not hoist out of a loop (a volatile asm), for
// tables read anew each iteration rather than held in registers across it.
__device__ __forceinline__ int ld_nc(const int* p) {
    int v;
    asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(v) : "l"(p));
    return v;
}

__device__ __forceinline__ double2 ld_nc(const double2* p) {
    double2 v;
    asm volatile("ld.global.nc.v2.f64 {%0, %1}, [%2];"
                 : "=d"(v.x), "=d"(v.y) : "l"(p));
    return v;
}

// Sum over a warp.
__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

}  // namespace fmcw
