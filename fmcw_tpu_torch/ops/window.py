"""Hamming window constants (numpy), as ``fmcw_tpu/ops/window.py`` builds
them (rtl/src/window_multiplier.vhd)."""

from __future__ import annotations

import numpy as np

from ..golden import fixed_point as fx


def hamming_q15(n: int, coef_width: int = 16) -> np.ndarray:
    """Full-length Q15 integer Hamming coefficients — the reference ROM
    contents + symmetric addressing (window_multiplier.vhd:34-53, 96-104)."""
    return fx.hamming_coeffs(n, coef_width)


def hamming_float(n: int, coef_width: int = 16) -> np.ndarray:
    """Float window equal to the Q15 ROM contents scaled by the hardware's
    effective Q14 extraction gain (coef / 2^14, up to ~2.0)."""
    return hamming_q15(n, coef_width).astype(np.float32) / float(1 << (coef_width - 2))
