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
#pragma once

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
};

namespace fmcw {

constexpr int kMaxRows = 128;   // T + 2H
constexpr int kMaxBlk = 256;    // block-grid cells of a tile

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
