// Standalone 2D OS-CFAR detection by counting, on Hopper, for int32 or
// float32 magnitude maps.
//
// Replaces fmcw_tpu/ops/cfar_pallas.py::_kernel_detect (per-cell scale:
// mean pass, hi/lo pass, threshold pass) and ::_kernel_detect_scaled (the
// threshold pass alone, with a scale map computed outside the kernel — the
// block scale of ops/cfar.block_scale_map), both called through
// cfar_2d_pallas_detect.  One kernel with a flag: block_mode reads the
// scale map.
//
// In:  map (B, R, D) int32 or float32 — or, prepadded, (B, R + 2 hr, D):
//      a range shard with the halo_range rows beyond each edge exchanged
//      from its neighbours on a sequence-parallel mesh (the sharded CFAR of
//      fmcw_tpu/parallel/sharded.py, cfar_2d_pallas_detect(prepadded_range=
//      True)); the range axis then does not wrap.  scale_in int32 (B, R, D)
//      when block_mode (else null).
// Out: det (B, R, D) in the map's type — the CUT where CUT > est * scale,
//      else 0 — and scale_out int32 (B, R, D), scale_override folded in.
//
// One block per (frame, tile of T rows) loads the T + 2 hr rows its windows
// reach (wrapped modulo R) into shared memory once; each thread then decides
// cells straight from the tile with the device code of cfar_common.cuh,
// which slowtime_detect.cu and slowtime_detect_fixed.cu share.  Integer
// maps decide with the exact ceiling q = ceil(cut / scale) (no float
// division, exact at any width); float maps probe the smallest float q with
// RN(q * scale) >= cut.  Decisions and scales are bit-identical to
// ops/cfar.cfar_2d on the same map.
//
// Bound on an H100: operations — per cell, for the per-cell scale, two box
// sums (the 13 x 11 and 5 x 3 windows), the mean and 3 compare-adds per
// training cell (2 for hi/lo, 1 for the decision); for a scale map, the
// decision's compare-adds alone.  The bytes are 8 (12 with a scale map) in
// and out per cell.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cfar_common.cuh"

// Mirrors CfarDetectConfig in kernels.py (ctypes.Structure, all int32).
struct CfarDetectConfig {
    int batch, R, D, T;
    int hr, hd, gr, gd, n_ref, k;
    int scale_min, scale_nom, scale_max;
    int block_mode, so, integer, prepadded;
};

namespace {

constexpr int kThreads = 256;

template <typename V>
__global__ void __launch_bounds__(kThreads)
cfar_detect_kernel(const V* __restrict__ map, const int* __restrict__ scale_in,
                   V* __restrict__ det, int* __restrict__ scale_out,
                   const CfarDetectConfig c) {
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
    const fmcw::CfarGeom g{c.hr, c.hd, c.gr, c.gd, c.n_ref, c.k,
                           c.scale_min, c.scale_nom, c.scale_max};
    const size_t out0 = ((size_t)b * c.R + r0) * c.D;
    for (int idx = threadIdx.x; idx < c.T * c.D; idx += kThreads) {
        const int e = c.hr + idx / c.D;
        const int d = idx % c.D;
        const V cut = tile[e * c.D + d];
        int sc = c.block_mode ? scale_in[out0 + idx]
                              : fmcw::percell_scale(tile, c.D, e, d, g);
        if (c.so != 0) sc = c.so;
        det[out0 + idx] = fmcw::os_detect(tile, c.D, e, d, cut, sc, g)
                              ? cut : V(0);
        scale_out[out0 + idx] = sc;
    }
}

template <typename V>
int launch(const void* map, const void* scale_in, void* det, void* scale_out,
           const CfarDetectConfig& c, cudaStream_t stream) {
    const size_t smem = (size_t)(c.T + 2 * c.hr) * c.D * sizeof(V);
    cudaError_t err = cudaFuncSetAttribute(
        cfar_detect_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(c.R / c.T, c.batch);
    cfar_detect_kernel<V><<<grid, kThreads, smem, stream>>>(
        static_cast<const V*>(map), static_cast<const int*>(scale_in),
        static_cast<V*>(det), static_cast<int*>(scale_out), c);
    return (int)cudaGetLastError();
}

}  // namespace

// map: int32 (integer != 0) or float32 (batch, R, D), or (batch, R + 2 hr,
// D) with prepadded; det: the map's type (batch, R, D); scale_in: int32
// (batch, R, D) with block_mode, else null; scale_out: int32 (batch, R, D).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int fmcw_cfar_detect(const void* map, const void* scale_in,
                                void* det, void* scale_out,
                                const CfarDetectConfig* cfg, void* stream) {
    const CfarDetectConfig c = *cfg;
    if (c.batch < 1 || c.batch > 65535 || c.T < 1 || c.R % c.T != 0 ||
        c.hd >= c.D || c.hr < c.gr || c.hd < c.gd || c.so < 0 ||
        (size_t)(c.T + 2 * c.hr) * c.D * 4 > 200 * 1024 ||
        (c.block_mode && scale_in == nullptr))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    return c.integer ? launch<int>(map, scale_in, det, scale_out, c, s)
                     : launch<float>(map, scale_in, det, scale_out, c, s);
}
