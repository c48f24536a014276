// The tile geometry shared by the two slow-time kernels, slowtime_detect.cu
// (float32) and slowtime_detect_fixed.cu (fixed point): one block per
// (frame, tile of T range rows) computes the magnitudes of T + 2H rows
// (wrapped modulo R) so that the CFAR window, the block-scale neighbourhood
// and the grouping radius of its T rows lie in shared memory.
#pragma once

// Mirrors SlowtimeConfig in ops/frontend.py (ctypes.Structure, all int32).
struct SlowtimeConfig {
    int batch, R, ND, T, H;
    int hr, hd, gr, gd, n_ref, k;
    int scale_min, scale_nom, scale_max;
    int block_mode, sb, n_blk, k_blk;
    int so, pgr, exact_mag;
    // fixed-point kernel only: MTI (2- or 3-pulse, transient zeroed or
    // passed, runtime bypass) and the Q15 window's rounding constant and
    // extraction shift.
    int notch_mode, transient_zero, bypass, rnd, shift;
};

namespace fmcw {

constexpr int kMaxRows = 128;   // T + 2H
constexpr int kMaxBlk = 256;    // block-grid cells of a tile

inline bool slowtime_config_ok(const SlowtimeConfig& c) {
    const int E = c.T + 2 * c.H;
    if (c.batch < 1 || c.batch > 65535 || c.T < 1 || c.R % c.T != 0 ||
        E > kMaxRows || c.pgr < 0 || c.hr + c.pgr > c.H || c.hd >= c.ND ||
        c.pgr >= c.ND)
        return false;
    if (c.block_mode) {
        if (c.sb < 1 || c.T % c.sb || c.H % c.sb || c.ND % c.sb ||
            c.H < 2 * c.sb + c.pgr || (E / c.sb) * (c.ND / c.sb) > kMaxBlk)
            return false;
    }
    return true;
}

}  // namespace fmcw
