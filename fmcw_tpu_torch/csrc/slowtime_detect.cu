// Kernel B of the radar front-end on Hopper: slow-time operator, magnitude,
// 2D OS-CFAR decision and peak grouping on a tile of range rows.
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
//      ND x ND complex slow-time matrix M[c][k] (MTI + Doppler window +
//      Doppler DFT folded together, chosen by mti_bypass on the host).
// Out: det (B, R, ND) zero-suppressed detections, row_max (B, R),
//      n_dets and nonfinite (B,) int32 (integer atomics: exact), and the
//      magnitude map (B, R, ND) when asked for.
//
// One block per (frame, tile of T range rows).  The CFAR window, the
// block-scale neighbourhood and the grouping radius reach H rows beyond the
// tile, so the block computes the magnitudes of T + 2H rows (wrapped modulo
// R) and keeps them in shared memory; nothing but the input planes, the
// matrix and the outputs touches device memory.
//   per-cell scale: H = halo_range + peak_group_radius  (6 + 2 = 8)
//   block scale:    H = (ceil(radius / sb) + 2) * sb    (24 at sb = 8)
//
// Bound on an H100: operations.  Per 1024x128 frame the slow-time product is
// 16.8 M complex MACs (134 MFLOP) and the per-cell CFAR ~3 x 128 compares and
// adds per cell over 131,072 cells; the bytes are 1 MiB in and 0.5 MiB out.
// Design against it: the product is an FP32 register-tiled GEMM (each of 512
// threads holds 4 rows x ND/16 columns of complex accumulators, operands
// staged through shared memory 16 chirps at a time); the decision counts
// straight from the shared magnitude tile.
//
// The decision (cfar_common.cuh, shared with slowtime_detect_fixed.cu and
// cfar_detect.cu) is bit-identical to the plain twin (ops/cfar.py) on the
// same magnitudes; the product itself is held to the twin by tolerance
// (1e-5 of the peak).
//
// A second entry point, fmcw_slowtime_mag (slowtime_mag_kernel), is the TPU
// kernel's magnitude-only mode (rdm_frontend(detect=False)): the same
// product and magnitude on T <= 128 rows per block with no halo, written
// out with the non-finite count, for the array model's angle-extended CFAR
// (cfar_3d_detect.cu), whose training set spans beams.  Bound: the product's
// operations, as above.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cfar_common.cuh"
#include "slowtime_common.cuh"

namespace {

using fmcw::kMaxBlk;
constexpr int kThreads = 512;
constexpr int kKC = 16;         // chirps per GEMM step

struct Params {
    const float* xr;
    const float* xi;
    const float* lo_r;              // split entry: H exchanged rows below
    const float* lo_i;              // and above the shard, (B, H, ND);
    const float* hi_r;              // null: rows wrap within the frame
    const float* hi_i;
    const float* mr;
    const float* mi;
    float* det;
    float* mag;
    float* row_max;
    int* n_dets;
    int* nonfinite;
    SlowtimeConfig c;
};

__host__ __device__ inline int staging_floats(int E, int ND) {
    return 2 * E * kKC + 2 * kKC * ND;
}

__host__ __device__ inline int work_floats(const SlowtimeConfig& c) {
    const int E = c.T + 2 * c.H;
    const int det_rows = c.T + 2 * c.pgr;
    const int a = staging_floats(E, c.ND);
    const int b = det_rows * c.ND;
    return a > b ? a : b;
}

size_t smem_bytes(const SlowtimeConfig& c) {
    const int E = c.T + 2 * c.H;
    return (size_t)(E * c.ND + work_floats(c) + 5 * kMaxBlk + c.T + 2) *
           sizeof(float);
}

// The slow-time product y = x M of E range rows g0 .. g0+E-1 (wrapped modulo
// R, or from the exchanged halos: FrameRows) of one frame's planes and their
// magnitudes: each of 512 threads holds 4 rows x ND/16 columns of complex
// accumulators, operands staged through shared memory (work,
// staging_floats(E, ND)) 16 chirps at a time.  Calls sink(e, col, magnitude)
// once per cell.  All threads of the block call it.
template <int ND, typename Rows, typename Sink>
__device__ __forceinline__ void slowtime_product(
        const Rows& x, const float* mr, const float* mi, float* work, int g0,
        int E, bool exact_mag, Sink sink) {
    constexpr int NC = ND / 16;
    const int tid = threadIdx.x;
    const int cg = tid & 15;
    const int rg = tid >> 4;                      // 32 row groups
    float acc_r[4][NC], acc_i[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc_r[i][j] = acc_i[i][j] = 0.f;
    float* xs_r = work;
    float* xs_i = xs_r + E * kKC;
    float* ms_r = xs_i + E * kKC;
    float* ms_i = ms_r + kKC * ND;
    for (int c0 = 0; c0 < ND; c0 += kKC) {
        for (int idx = tid; idx < E * kKC; idx += kThreads) {
            const int e = idx / kKC;
            const int cc = idx % kKC;
            const float* rr;
            const float* ri;
            x.row(g0 + e, rr, ri);
            xs_r[idx] = rr[c0 + cc];
            xs_i[idx] = ri[c0 + cc];
        }
        for (int idx = tid; idx < kKC * ND; idx += kThreads) {
            ms_r[idx] = mr[c0 * ND + idx];
            ms_i[idx] = mi[c0 * ND + idx];
        }
        __syncthreads();
#pragma unroll 4
        for (int cc = 0; cc < kKC; ++cc) {
            float m_r[NC], m_i[NC];
#pragma unroll
            for (int j = 0; j < NC; ++j) {
                m_r[j] = ms_r[cc * ND + cg + 16 * j];
                m_i[j] = ms_i[cc * ND + cg + 16 * j];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int e = rg + 32 * i;
                if (e < E) {
                    const float a_r = xs_r[e * kKC + cc];
                    const float a_i = xs_i[e * kKC + cc];
#pragma unroll
                    for (int j = 0; j < NC; ++j) {
                        acc_r[i][j] = fmaf(a_r, m_r[j], acc_r[i][j]);
                        acc_r[i][j] = fmaf(-a_i, m_i[j], acc_r[i][j]);
                        acc_i[i][j] = fmaf(a_r, m_i[j], acc_i[i][j]);
                        acc_i[i][j] = fmaf(a_i, m_r[j], acc_i[i][j]);
                    }
                }
            }
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int e = rg + 32 * i;
        if (e < E) {
#pragma unroll
            for (int j = 0; j < NC; ++j) {
                const float yr = acc_r[i][j], yi = acc_i[i][j];
                float m;
                if (exact_mag) {
                    m = hypotf(yr, yi);
                } else {
                    const float ar = fabsf(yr), ai = fabsf(yi);
                    m = __fadd_rn(fmaxf(ar, ai),
                                  __fmul_rn(0.375f, fminf(ar, ai)));
                }
                sink(e, cg + 16 * j, m);
            }
        }
    }
}

template <int ND, bool kHalo>
__global__ void __launch_bounds__(kThreads, 1)
slowtime_detect_kernel(const Params p) {
    extern __shared__ float smem[];
    const SlowtimeConfig& c = p.c;
    const int E = c.T + 2 * c.H;
    float* mag_s = smem;                          // E x ND magnitudes
    float* work = mag_s + E * ND;                 // GEMM staging, then det
    float* bsum = work + work_floats(c);          // block sums
    float* bnb = bsum + kMaxBlk;                  // 3x3-block sums
    int* bhi = reinterpret_cast<int*>(bnb + kMaxBlk);
    int* blo = bhi + kMaxBlk;
    int* bscale = blo + kMaxBlk;
    int* rmax_s = bscale + kMaxBlk;               // T row maxima (float bits)
    int* counts = rmax_s + c.T;                   // n_dets, nonfinite
    const int tid = threadIdx.x;
    const int b = blockIdx.y;
    const int r0 = blockIdx.x * c.T;

    for (int i = tid; i < c.T; i += kThreads) rmax_s[i] = 0;
    if (tid < 2) counts[tid] = 0;

    // ---- 1. Slow-time product y = x M and magnitude, rows r0-H .. r0+T+H.
    const auto rows = fmcw::frame_rows<kHalo>(p.xr, p.xi, p.lo_r, p.lo_i,
                                              p.hi_r, p.hi_i, b, c.R, c.H,
                                              ND);
    slowtime_product<ND>(rows, p.mr, p.mi, work, r0 - c.H, E,
                         c.exact_mag != 0,
                         [&](int e, int col, float m) {
                             mag_s[e * ND + col] = m;
                         });
    __syncthreads();

    // ---- 2a. Block (clutter-map) scale for the tile's block rows.
    const fmcw::CfarGeom g{c.hr, c.hd, c.gr, c.gd, c.n_ref, c.k,
                           c.scale_min, c.scale_nom, c.scale_max};
    if (c.block_mode)
        fmcw::block_scale_tile(mag_s, E, ND, c.sb, c.n_blk, c.k_blk, g, bsum,
                               bnb, bhi, blo, bscale);

    // ---- 2b. CFAR decision for rows H-pgr .. H+T+pgr of the tile.
    float* det_s = work;
    fmcw::decide_rows(mag_s, det_s, c.H - c.pgr, c.T + 2 * c.pgr, ND, bscale,
                      c.sb, c.block_mode != 0, c.so, g);
    __syncthreads();

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

// Magnitude only (rdm_frontend(detect=False) of the TPU kernel, the array
// model's angle-extended path): the slow-time product and magnitude of T
// rows per block, no halo, written to mag (B, R, ND) with the per-frame
// non-finite count; no CFAR.
template <int ND>
__global__ void __launch_bounds__(kThreads, 1)
slowtime_mag_kernel(const Params p) {
    extern __shared__ float smem[];
    __shared__ int nf_s;
    const SlowtimeConfig& c = p.c;
    const int b = blockIdx.y;
    const int r0 = blockIdx.x * c.T;
    if (threadIdx.x == 0) nf_s = 0;
    float* out = p.mag + ((size_t)b * c.R + r0) * ND;
    int my_nf = 0;
    const auto rows = fmcw::frame_rows<false>(p.xr, p.xi, p.lo_r, p.lo_i,
                                              p.hi_r, p.hi_i, b, c.R, 0, ND);
    slowtime_product<ND>(rows, p.mr, p.mi, smem, r0, c.T, c.exact_mag != 0,
                         [&](int e, int col, float m) {
                             out[e * ND + col] = m;
                             my_nf += !isfinite(m);
                         });
    if (my_nf) atomicAdd(&nf_s, my_nf);
    __syncthreads();
    if (threadIdx.x == 0 && nf_s) atomicAdd(&p.nonfinite[b], nf_s);
}

template <int ND, bool kHalo>
int launch(const Params& p, cudaStream_t stream) {
    const size_t smem = smem_bytes(p.c);
    cudaError_t err = cudaFuncSetAttribute(
        slowtime_detect_kernel<ND, kHalo>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(p.c.R / p.c.T, p.c.batch);
    slowtime_detect_kernel<ND, kHalo><<<grid, kThreads, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

template <int ND>
int launch_mag(const Params& p, cudaStream_t stream) {
    const size_t smem = staging_floats(p.c.T, ND) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        slowtime_mag_kernel<ND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(p.c.R / p.c.T, p.c.batch);
    slowtime_mag_kernel<ND><<<grid, kThreads, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

}  // namespace

// xr/xi: float32 (batch, R, ND); mr/mi: float32 (ND, ND); det: float32
// (batch, R, ND); mag: same or null; row_max: float32 (batch, R);
// n_dets/nonfinite: int32 (batch,), zeroed by the caller.  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int fmcw_slowtime_detect(const void* xr, const void* xi,
                                    const void* mr, const void* mi, void* det,
                                    void* mag, void* row_max, void* n_dets,
                                    void* nonfinite, const SlowtimeConfig* cfg,
                                    void* stream) {
    const SlowtimeConfig c = *cfg;
    if (!fmcw::slowtime_config_ok(c)) return (int)cudaErrorInvalidValue;
    Params p{static_cast<const float*>(xr), static_cast<const float*>(xi),
             nullptr, nullptr, nullptr, nullptr,
             static_cast<const float*>(mr), static_cast<const float*>(mi),
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

// Magnitude only: xr/xi float32 (batch, R, ND); mag float32 (batch, R, ND);
// nonfinite int32 (batch,), zeroed by the caller.  Reads cfg's batch, R, ND,
// T (rows per block, <= 128, dividing R) and exact_mag.  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int fmcw_slowtime_mag(const void* xr, const void* xi,
                                 const void* mr, const void* mi, void* mag,
                                 void* nonfinite, const SlowtimeConfig* cfg,
                                 void* stream) {
    const SlowtimeConfig c = *cfg;
    if (c.batch < 1 || c.batch > 65535 || c.T < 1 || c.T > fmcw::kMaxRows ||
        c.R % c.T != 0)
        return (int)cudaErrorInvalidValue;
    Params p{static_cast<const float*>(xr), static_cast<const float*>(xi),
             nullptr, nullptr, nullptr, nullptr,
             static_cast<const float*>(mr), static_cast<const float*>(mi),
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
// above it, exchanged from the neighbouring shards; cfg's row_off is the
// shard's first row in the frame and r_total the frame's rows (grouping
// ties break by global row ids).  Per-cell scale only.  Outputs as
// fmcw_slowtime_detect, for the shard's R rows.
extern "C" int fmcw_slowtime_detect_split(
        const void* xr, const void* xi, const void* lo_r, const void* lo_i,
        const void* hi_r, const void* hi_i, const void* mr, const void* mi,
        void* det, void* mag, void* row_max, void* n_dets, void* nonfinite,
        const SlowtimeConfig* cfg, void* stream) {
    const SlowtimeConfig c = *cfg;
    if (!fmcw::split_config_ok(c) || !lo_r || !lo_i || !hi_r || !hi_i)
        return (int)cudaErrorInvalidValue;
    Params p{static_cast<const float*>(xr),   static_cast<const float*>(xi),
             static_cast<const float*>(lo_r), static_cast<const float*>(lo_i),
             static_cast<const float*>(hi_r), static_cast<const float*>(hi_i),
             static_cast<const float*>(mr),   static_cast<const float*>(mi),
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
