// The tile geometry shared by the two slow-time kernels, slowtime_detect.cu
// (float32) and slowtime_detect_fixed.cu (fixed point): one block per
// (frame, tile of T range rows) computes the magnitudes of T + 2H rows
// (wrapped modulo R) so that the CFAR window, the block-scale neighbourhood
// and the grouping radius of its T rows lie in shared memory.
//
// The split entry points (fmcw_slowtime_detect_split, ..._fixed_split) take
// a range shard of a frame on a sequence-parallel mesh: its R rows plus the
// H rows just below and above it, exchanged from the neighbouring shards
// (FrameRows), so no row wraps; grouping breaks ties by GLOBAL row ids
// (row_off + r, modulo r_total).
//
// Both kernels run a row's slow-time FFT on the lanes of a warp (Row), keep
// the tile in shared memory as TileLayout says, and set their shared-memory
// limit once per process and device (prepare).
#pragma once

#include <cuda_runtime.h>

// Mirrors SlowtimeConfig in kernels.py (ctypes.Structure, all int32).
struct SlowtimeConfig {
    int batch, R, ND, T, H;
    int hr, hd, gr, gd, n_ref, k;
    int scale_min, scale_nom, scale_max;
    int block_mode, sb, n_blk, k_blk;
    int so, pgr, exact_mag;
    // MTI (2- or 3-pulse, transient zeroed or passed, runtime bypass);
    // fixed-point kernel only: the Q15 window's rounding constant and
    // extraction shift.
    int notch_mode, transient_zero, bypass, rnd, shift;
    // The map's first row in the whole frame and the frame's rows (a range
    // shard's place; 0 and R for a whole frame).
    int row_off, r_total;
    // The CFAR variant: 0 OS (counting), 1 CA, 2 GO, 3 SO (cfar_tile.cuh's
    // window means), in both kernels.
    int variant;
    // Long and dense CPIs (kernel B's two-launch lengths, slowtime_long.
    // cuh): the decision's column chunk W and its column halo HC
    // (slowtime_detect.cu's decide kernel).
    int W, HC;
};

namespace fmcw {

constexpr int kMaxRows = 128;   // T + 2H
constexpr int kMaxBlk = 256;    // block-grid cells of a tile
constexpr int kMaxSmem = 232448;        // 227 KB, an H100 block's most
constexpr int kMaxDevices = 64;

// The lane plan of a row's slow-time FFT: L = min(32, ND) lanes a row, P =
// ND / L chirps a lane (chirp s = l P + p), G = 32 / L rows a warp.  ND 1
// is the dense rows' smallest inner transform (slowtime_detect.cu; 8 in
// slowtime_detect_fixed.cu), the identity.
template <int ND>
struct Row {
    static constexpr int L = ND < 32 ? ND : 32;     // lanes per row
    static constexpr int P = ND / L;                // chirps per lane
    static constexpr int G = 32 / L;                // rows per warp
    static constexpr int kLog2L = L == 32 ? 5 : L == 16 ? 4 : L == 8 ? 3
                                  : L == 4  ? 2 : L == 2  ? 1 : 0;
    // Lane l's bin of the L-point transform across the lanes:
    // bit_reverse(l) over kLog2L bits.
    static __device__ __forceinline__ int bin(int l) {
        if constexpr (kLog2L == 0) return 0;
        else return (int)(__brev((unsigned)l) >> (32 - kLog2L));
    }
};

// A detection tile's shared memory, in 4-byte words: the E x ND magnitude
// tile; the decided rows' det tile (rows = T + 2 pgr) with, per-cell (and
// no override), the guard column sums after it (the full column sums
// alias the det tile) or, block scale, the block statistics; the T row
// maxima and n_counts counters.
struct TileLayout {
    int det, cs_guard, blk, rmax, counts, total;
};

__host__ __device__ inline TileLayout tile_layout(const SlowtimeConfig& c,
                                                  int n_counts) {
    const int E = c.T + 2 * c.H;
    const int rows = c.T + 2 * c.pgr;
    TileLayout s;
    s.det = E * c.ND;
    s.cs_guard = s.blk = s.det + rows * c.ND;
    const int region = c.block_mode ? rows * c.ND + 5 * kMaxBlk
                                    : (c.so ? 1 : 2) * rows * c.ND;
    s.rmax = s.det + region;
    s.counts = s.rmax + c.T;
    s.total = s.counts + n_counts;
    return s;
}

// The shared-memory limit and carve-out of a kernel, set once per process
// and device (every configuration's layout fits kMaxSmem; two per-cell
// tiles of 1024 x 128 fit an SM).
template <typename K>
cudaError_t prepare(K* kernel, bool (&ready)[kMaxDevices]) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!ready[dev]) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(
                kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                cudaSharedmemCarveoutMaxShared);
        if (err != cudaSuccess) return err;
        ready[dev] = true;
    }
    return cudaSuccess;
}

// One frame's re/im planes, row-major (R, ND): row g of a tile (r0 - H <=
// g < r0 + T + H) wraps modulo R, or, with kHalo (a range shard), comes
// from the H exchanged rows below row 0 (lo) or above row R-1 (hi).  A
// template flag, so that the whole-frame kernels compile as they did
// without the halo pointers.
template <typename X, bool kHalo>
struct FrameRows {
    const X* xr;
    const X* xi;
    const X* lo_r;
    const X* lo_i;
    const X* hi_r;
    const X* hi_i;
    int R, H, ND;

    __device__ __forceinline__ void row(int g, const X*& re,
                                        const X*& im) const {
        if constexpr (!kHalo) {
            g %= R;
            if (g < 0) g += R;
            re = xr + (size_t)g * ND;
            im = xi + (size_t)g * ND;
        } else if (g < 0) {
            re = lo_r + (size_t)(g + H) * ND;
            im = lo_i + (size_t)(g + H) * ND;
        } else if (g >= R) {
            re = hi_r + (size_t)(g - R) * ND;
            im = hi_i + (size_t)(g - R) * ND;
        } else {
            re = xr + (size_t)g * ND;
            im = xi + (size_t)g * ND;
        }
    }
};

// Frame b's rows of batched planes (B, R, ND) and, with kHalo, of the
// halos (B, H, ND).
template <bool kHalo, typename X>
__device__ __forceinline__ FrameRows<X, kHalo> frame_rows(
        const X* xr, const X* xi, const X* lo_r, const X* lo_i,
        const X* hi_r, const X* hi_i, int b, int R, int H, int ND) {
    const size_t f = (size_t)b * R * ND;
    if constexpr (!kHalo)
        return {xr + f, xi + f, nullptr, nullptr, nullptr, nullptr, R, H, ND};
    const size_t h = (size_t)b * H * ND;
    return {xr + f, xi + f, lo_r + h, lo_i + h, hi_r + h, hi_i + h, R, H, ND};
}

inline bool slowtime_config_ok(const SlowtimeConfig& c) {
    const int E = c.T + 2 * c.H;
    if (c.batch < 1 || c.batch > 65535 || c.T < 1 || c.R % c.T != 0 ||
        E > kMaxRows || c.pgr < 0 || c.hr + c.pgr > c.H || c.hd >= c.ND ||
        c.pgr >= c.ND || c.row_off < 0 || c.r_total < c.R + c.row_off)
        return false;
    if (c.block_mode) {
        if (c.sb < 1 || c.T % c.sb || c.H % c.sb || c.ND % c.sb ||
            c.H < 2 * c.sb + c.pgr || (E / c.sb) * (c.ND / c.sb) > kMaxBlk)
            return false;
    }
    return true;
}

// The split entries decide with the per-cell scale only, on exactly the
// exchanged halo rows (H = halo_range + peak_group_radius).
inline bool split_config_ok(const SlowtimeConfig& c) {
    return slowtime_config_ok(c) && !c.block_mode && c.H == c.hr + c.pgr;
}

}  // namespace fmcw
