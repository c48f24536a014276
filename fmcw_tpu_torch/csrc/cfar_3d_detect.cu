// Angle-extended (3D) OS-CFAR detection by counting, on Hopper, for float32
// or int32 beam cubes.
//
// Replaces fmcw_tpu/ops/cfar_pallas.py::_kernel_detect_3d (called through
// cfar_3d_pallas_detect): the decision of ops/cfar.cfar_3d with
// ref_angle > 0, whose training set is the 3D box of +-ha = +-(ref_angle +
// guard_angle) beam planes around the CUT minus the guard box on the planes
// within +-guard_angle, every axis wrapped (the beam axis too).  The
// adaptive scale is per cell whatever the CfarParams' scale mode, as in
// JAX's XLA body.
//
// In:  cube (B, A, R, D) int32 or float32 — or, prepadded, (B, A + 2 ha, R,
//      D): a beam shard with ha = ref_angle + guard_angle planes of its
//      neighbours on each side (the sharded array model's beam-halo
//      exchange, cfar_3d(prepadded_angle=True)); the beam axis then does not
//      wrap.  A scalar scale_override.
// Out: det (B, A, R, D) in the cube's type — the CUT where CUT > est * scale,
//      else 0 — and scale (B, A, R, D) int32, scale_override folded in; for
//      a prepadded shard, its A interior planes.
//
// One block per (cube, beam plane, tile of T range rows) loads the 2 ha + 1
// beam planes' T + 2 hr rows its windows reach (wrapped) into shared memory
// once, then the planes' column sums over the 2 hr + 1 window rows.  Each
// thread decides cells straight from shared memory: the training-set sum
// (column sums added dd ascending per plane, planes ascending, then the
// guard cells subtracted one by one — the order of JAX's kernel and of the
// plain twin ops/cfar.cfar_3d), then the counting passes of cfar_common.cuh
// (hi/lo classification counts, then the threshold count against
// q = the smallest value whose product with the scale reaches the CUT).
// Decisions and scales are bit-identical to ops/cfar.cfar_3d on the same
// cube; integer cubes take the exact q = floor((cut - 1) / s) + 1.
//
// Bound on an H100: operations — per cell the column and plane sums, the
// mean, and 3 compare-adds per training cell (2 for hi/lo, 1 for the
// decision; n_ref = 414 at the default window with ref_angle 1).  The bytes
// are 12 per cell (the cube in, det and scale out).  Design against it: the
// tile and its column sums stay in shared memory (T chosen on the host so
// that three blocks fit an SM), consecutive threads take consecutive
// Doppler columns (no bank conflicts), and no training value leaves shared
// memory; the counting loops test the guard box once per column and walk
// down it.  Each training value is read from shared memory twice
// per CUT (the hi/lo pass, then the decision pass).

#include <cuda_runtime.h>
#include <stdint.h>

#include "cfar_common.cuh"

// Mirrors Cfar3dConfig in kernels.py (ctypes.Structure, all int32).
struct Cfar3dConfig {
    int batch, A, R, D, T;
    int ha, ga;
    int hr, hd, gr, gd, n_ref, k;
    int scale_min, scale_nom, scale_max;
    int so, integer, prepadded;
};

namespace {

constexpr int kThreads = 256;

__host__ __device__ inline size_t smem_elems(const Cfar3dConfig& c) {
    const int np = 2 * c.ha + 1;
    return (size_t)np * (c.T + 2 * c.hr) * c.D + (size_t)np * c.T * c.D;
}

__device__ __forceinline__ int wrap_mod(int i, int n) {
    const int r = i % n;
    return r < 0 ? r + n : r;
}

// Calls f(v) for every training value of the CUT at tile row e, column d:
// planes ascending, columns dd ascending, rows dr ascending, skipping the
// guard box on the |da| <= ga planes (tested once per column).  Counting is
// order-free, so any order serves; the inner loops walk down a column.
template <typename V, typename F>
__device__ __forceinline__ void for_training(const V* tile, int E, int D,
                                             int e, int d,
                                             const Cfar3dConfig& c, F f) {
    const int np = 2 * c.ha + 1;
    const int n_out = c.hr - c.gr;               // rows above / below guard
    for (int p = 0; p < np; ++p) {
        const V* pl = tile + ((size_t)p * E + e - c.hr) * D;
        const bool gplane = p >= c.ha - c.ga && p <= c.ha + c.ga;
        for (int dd = -c.hd; dd <= c.hd; ++dd) {
            const V* col = pl + fmcw::wrap_col(d + dd, D);
            if (gplane && dd >= -c.gd && dd <= c.gd) {
                const V* below = col + (c.hr + c.gr + 1) * D;
#pragma unroll 4
                for (int i = 0; i < n_out; ++i) f(col[i * D]);
#pragma unroll 4
                for (int i = 0; i < n_out; ++i) f(below[i * D]);
            } else {
#pragma unroll 4
                for (int i = 0; i <= 2 * c.hr; ++i) f(col[i * D]);
            }
        }
    }
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
cfar3d_detect_kernel(const V* __restrict__ cube, V* __restrict__ det,
                     int* __restrict__ scale_out, const Cfar3dConfig c) {
    extern __shared__ int smem_i[];
    const int np = 2 * c.ha + 1;
    const int E = c.T + 2 * c.hr;
    const int D = c.D;
    V* tile = reinterpret_cast<V*>(smem_i);       // np planes x E rows x D
    V* cs = tile + (size_t)np * E * D;            // np planes x T rows x D
    const int r0 = blockIdx.x * c.T;
    const int a = blockIdx.y;
    const int b = blockIdx.z;

    // 1. The 2 ha + 1 planes' rows r0 - hr .. r0 + T + hr - 1, wrapped
    //    (planes too, unless the shard carries them).
    const int a_in = c.prepadded ? c.A + 2 * c.ha : c.A;
    for (int idx = threadIdx.x; idx < np * E * D; idx += kThreads) {
        const int p = idx / (E * D);
        const int rem = idx - p * E * D;
        const int e = rem / D;
        const int d = rem - e * D;
        const int plane = c.prepadded ? a + p : wrap_mod(a - c.ha + p, c.A);
        const int row = wrap_mod(r0 - c.hr + e, c.R);
        tile[idx] = cube[(((size_t)b * a_in + plane) * c.R + row) * D + d];
    }
    __syncthreads();
    // 2. Column sums over the window's rows, dr ascending.
    for (int idx = threadIdx.x; idx < np * c.T * D; idx += kThreads) {
        const int p = idx / (c.T * D);
        const int rem = idx - p * c.T * D;
        const int t = rem / D;
        const int d = rem - t * D;
        const V* col = tile + ((size_t)p * E + t) * D + d;
        V s = col[0];
        for (int i = 1; i <= 2 * c.hr; ++i) s = fmcw::vadd(s, col[i * D]);
        cs[idx] = s;
    }
    __syncthreads();

    const fmcw::CfarGeom g{c.hr, c.hd, c.gr, c.gd, c.n_ref, c.k,
                           c.scale_min, c.scale_nom, c.scale_max};
    const size_t out0 = (((size_t)b * c.A + a) * c.R + r0) * D;
    for (int idx = threadIdx.x; idx < c.T * D; idx += kThreads) {
        const int t = idx / D;
        const int d = idx - t * D;
        const int e = t + c.hr;
        // 3. Training-set sum: planes ascending, in each the column sums
        //    dd ascending; then the guard cells of the |da| <= ga planes,
        //    dd outer, dr inner.
        V sum = V(0);
        bool first = true;
        for (int p = 0; p < np; ++p) {
            const V* row = cs + ((size_t)p * c.T + t) * D;
            for (int dd = -c.hd; dd <= c.hd; ++dd) {
                const V v = row[fmcw::wrap_col(d + dd, D)];
                sum = first ? v : fmcw::vadd(sum, v);
                first = false;
            }
        }
        for (int p = c.ha - c.ga; p <= c.ha + c.ga; ++p) {
            const V* pl = tile + (size_t)p * E * D;
            for (int dd = -c.gd; dd <= c.gd; ++dd) {
                const V* col = pl + fmcw::wrap_col(d + dd, D);
                for (int dr = -c.gr; dr <= c.gr; ++dr)
                    sum = fmcw::vsub(sum, col[(e + dr) * D]);
            }
        }
        V t_hi, t_lo;
        fmcw::scale_thresholds(sum, c.n_ref, t_hi, t_lo);
        // 4. Hi/lo classification counts over the training set.
        int hi = 0, lo = 0;
        for_training(tile, E, D, e, d, c, [&](V v) {
            hi += v > t_hi;
            lo += v >= t_lo;
        });
        int sc = fmcw::classify(hi, lo, c.k, g);
        if (c.so != 0) sc = c.so;
        // 5. The decision cut > est * sc by counting.
        const V cut = tile[((size_t)c.ha * E + e) * D + d];
        const V q = fmcw::detect_threshold(cut, sc);
        int cnt = 0;
        for_training(tile, E, D, e, d, c, [&](V v) { cnt += v >= q; });
        det[out0 + idx] = (cnt < c.k && cut > V(0)) ? cut : V(0);
        scale_out[out0 + idx] = sc;
    }
}

template <typename V>
int launch(const void* cube, void* det, void* scale_out,
           const Cfar3dConfig& c, cudaStream_t stream) {
    const size_t smem = smem_elems(c) * sizeof(V);
    cudaError_t err = cudaFuncSetAttribute(
        cfar3d_detect_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(c.R / c.T, c.A, c.batch);
    cfar3d_detect_kernel<V><<<grid, kThreads, smem, stream>>>(
        static_cast<const V*>(cube), static_cast<V*>(det),
        static_cast<int*>(scale_out), c);
    return (int)cudaGetLastError();
}

}  // namespace

// cube/det: int32 (integer != 0) or float32 (batch, A, R, D) — the cube
// (batch, A + 2 ha, R, D) with prepadded; scale_out: int32 (batch, A, R,
// D).  Returns the CUDA error code of the launch (0 on
// success).
extern "C" int fmcw_cfar_3d_detect(const void* cube, void* det,
                                   void* scale_out, const Cfar3dConfig* cfg,
                                   void* stream) {
    const Cfar3dConfig c = *cfg;
    if (c.batch < 1 || c.batch > 65535 || c.A < 1 || c.A > 65535 ||
        c.T < 1 || c.R % c.T != 0 || c.hd >= c.D || c.hr < c.gr ||
        c.hd < c.gd || c.ha < 1 || c.ga < 0 || c.ga >= c.ha || c.so < 0 ||
        smem_elems(c) * 4 > 227 * 1024)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    return c.integer ? launch<int>(cube, det, scale_out, c, s)
                     : launch<float>(cube, det, scale_out, c, s);
}
