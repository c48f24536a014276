// 2D OS-CFAR with its debug taps (threshold and scale maps) by bit-serial
// radix rank selection, on Hopper, for int32 or float32 magnitude maps.
//
// Replaces fmcw_tpu/ops/cfar_pallas.py::_kernel (called through
// cfar_2d_pallas): the k-th largest training value est (k = n_ref -
// rank_idx) is found without sorting by walking the key bits MSB -> LSB,
// keeping a prefix P and setting a bit where count(keys >= P | bit) >= k.
// Keys are the int32 values of integer maps, or the IEEE bit patterns of
// float maps as int32 (monotonic for non-negative floats; NaN, Inf and -0.0
// rank as their patterns do).  Float keys are walked from bit 30 down for
// ``bits`` bits, integer keys from bit bits - 1 down (JAX's rank_bits /
// int_bits); with fewer than 31 float bits est is the order statistic with
// its low key bits cleared (rank_bits=16: under it by < 0.8%), as on the
// TPU.  Then, as os_cfar_2d.vhd:187-220 (the dbg_threshold / dbg_scale
// ports):
//   scale:     est > 1.5 mean -> scale_max, est < 0.5 mean -> scale_min,
//              else scale_nom (integer: mean + (mean >> 1), mean >> 1), the
//              mean from the full-minus-guard box sums of cfar_common.cuh;
//              or, block_mode, a scale map computed outside; scale_override
//              folded in;
//   threshold: est * scale;   det: the CUT where CUT > threshold, else 0.
//
// In:  map (B, R, D) int32 or float32 — or, prepadded, (B, R + 2 hr, D): a
//      range shard with its neighbours' halo_range rows on each side (the
//      sharded CFAR tail, cfar_2d_pallas(prepadded_range=True)); the range
//      axis then does not wrap.  scale_in int32 (B, R, D) when block_mode.
// Out: det and threshold (B, R, D) in the map's type, scale int32.
//
// One block per (frame, tile of T rows) loads the T + 2 hr rows its windows
// reach into shared memory once (cfar_detect.cu's tile, columns wrapped
// modulo D); each thread then takes cells, consecutive threads consecutive
// columns.  Per cell: the box-sum mean (per-cell scale), then ``bits``
// counting passes over the n_ref training values in shared memory.
//
// Bound on an H100: operations — bits x n_ref compare-adds per cell (16 x
// 128 at the float default, 31 x 128 exact) against 16 bytes in and out per
// cell; every pass re-reads the training values from shared memory.  The
// TPU kernel's lane-rotated scratch planes are not carried over: shared
// memory serves any column offset at full rate.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cfar_common.cuh"

// Mirrors CfarRankConfig in kernels.py (ctypes.Structure, all int32).
struct CfarRankConfig {
    int batch, R, D, T;
    int hr, hd, gr, gd, n_ref, k;
    int scale_min, scale_nom, scale_max;
    int block_mode, so, integer, prepadded, bits;
};

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int key_of(float v) { return __float_as_int(v); }
__device__ __forceinline__ int key_of(int v) { return v; }
__device__ __forceinline__ void from_key(int k, float* v) {
    *v = __int_as_float(k);
}
__device__ __forceinline__ void from_key(int k, int* v) { *v = k; }
__device__ __forceinline__ float scaled(float est, int sc) {
    return __fmul_rn(est, (float)sc);
}
__device__ __forceinline__ int scaled(int est, int sc) { return est * sc; }

// count(training keys >= cand) of the cell at tile row e, column d: the
// window's columns, each walked down around the guard box.
template <typename V>
__device__ __forceinline__ int count_ge(const V* t, int D, int e, int d,
                                        int cand, const CfarRankConfig& c) {
    const int n_out = c.hr - c.gr;                // rows above / below guard
    int cnt = 0;
    for (int dd = -c.hd; dd <= c.hd; ++dd) {
        const V* col = t + (e - c.hr) * D + fmcw::wrap_col(d + dd, D);
        if (dd >= -c.gd && dd <= c.gd) {
            const V* below = col + (c.hr + c.gr + 1) * D;
#pragma unroll 4
            for (int i = 0; i < n_out; ++i) cnt += key_of(col[i * D]) >= cand;
#pragma unroll 4
            for (int i = 0; i < n_out; ++i)
                cnt += key_of(below[i * D]) >= cand;
        } else {
#pragma unroll 4
            for (int i = 0; i <= 2 * c.hr; ++i)
                cnt += key_of(col[i * D]) >= cand;
        }
    }
    return cnt;
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
cfar_rank_kernel(const V* __restrict__ map, const int* __restrict__ scale_in,
                 V* __restrict__ det, V* __restrict__ thr,
                 int* __restrict__ scale_out, const CfarRankConfig c) {
    extern __shared__ int smem_i[];
    V* tile = reinterpret_cast<V*>(smem_i);
    const int E = c.T + 2 * c.hr;
    const int b = blockIdx.y;
    const int r0 = blockIdx.x * c.T;
    const int rows_in = c.prepadded ? c.R + 2 * c.hr : c.R;
    const V* src = map + (size_t)b * rows_in * c.D;
    for (int idx = threadIdx.x; idx < E * c.D; idx += kThreads) {
        const int e = idx / c.D;
        const int d = idx % c.D;
        int row;
        if (c.prepadded) {
            row = r0 + e;                   // the map's row r0 - hr + e
        } else {
            row = (r0 - c.hr + e) % c.R;
            if (row < 0) row += c.R;
        }
        tile[idx] = src[(size_t)row * c.D + d];
    }
    __syncthreads();
    const int top = c.integer ? c.bits - 1 : 30;
    const size_t out0 = ((size_t)b * c.R + r0) * c.D;
    for (int idx = threadIdx.x; idx < c.T * c.D; idx += kThreads) {
        const int e = c.hr + idx / c.D;
        const int d = idx % c.D;
        // The rank select: the largest prefix with >= k keys at or above.
        int prefix = 0;
        for (int i = 0; i < c.bits; ++i) {
            const int cand = prefix | (1 << (top - i));
            if (count_ge(tile, c.D, e, d, cand, c) >= c.k) prefix = cand;
        }
        V est;
        from_key(prefix, &est);
        int sc;
        if (c.block_mode) {
            sc = scale_in[out0 + idx];
        } else {
            const V full = fmcw::box_sum(tile, c.D, e, d, c.hr, c.hd);
            const V guard = fmcw::box_sum(tile, c.D, e, d, c.gr, c.gd);
            V t_hi, t_lo;
            fmcw::scale_thresholds(fmcw::vsub(full, guard), c.n_ref, t_hi,
                                   t_lo);
            sc = est > t_hi ? c.scale_max
                            : (est < t_lo ? c.scale_min : c.scale_nom);
        }
        if (c.so != 0) sc = c.so;
        const V cut = tile[e * c.D + d];
        const V threshold = scaled(est, sc);
        det[out0 + idx] = cut > threshold ? cut : V(0);
        thr[out0 + idx] = threshold;
        scale_out[out0 + idx] = sc;
    }
}

template <typename V>
int launch(const void* map, const void* scale_in, void* det, void* thr,
           void* scale_out, const CfarRankConfig& c, cudaStream_t stream) {
    const size_t smem = (size_t)(c.T + 2 * c.hr) * c.D * sizeof(V);
    cudaError_t err = cudaFuncSetAttribute(
        cfar_rank_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(c.R / c.T, c.batch);
    cfar_rank_kernel<V><<<grid, kThreads, smem, stream>>>(
        static_cast<const V*>(map), static_cast<const int*>(scale_in),
        static_cast<V*>(det), static_cast<V*>(thr),
        static_cast<int*>(scale_out), c);
    return (int)cudaGetLastError();
}

}  // namespace

// map: int32 (integer != 0) or float32 (batch, R, D), or (batch, R + 2 hr,
// D) with prepadded; det, thr: the map's type (batch, R, D); scale_in: int32
// (batch, R, D) with block_mode, else null; scale_out: int32 (batch, R, D).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int fmcw_cfar_rank(const void* map, const void* scale_in,
                              void* det, void* thr, void* scale_out,
                              const CfarRankConfig* cfg, void* stream) {
    const CfarRankConfig c = *cfg;
    if (c.batch < 1 || c.batch > 65535 || c.T < 1 || c.R % c.T != 0 ||
        c.hd >= c.D || c.hr < c.gr || c.hd < c.gd || c.so < 0 ||
        c.k < 1 || c.k > c.n_ref || c.bits < 1 || c.bits > 31 ||
        (size_t)(c.T + 2 * c.hr) * c.D * 4 > 200 * 1024 ||
        (c.block_mode && scale_in == nullptr))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    return c.integer ? launch<int>(map, scale_in, det, thr, scale_out, c, s)
                     : launch<float>(map, scale_in, det, thr, scale_out, c,
                                     s);
}
