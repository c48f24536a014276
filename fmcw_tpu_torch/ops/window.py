"""Hamming window constants (numpy), as ``fmcw_tpu/ops/window.py`` builds
them (rtl/src/window_multiplier.vhd), and the integer window multiply of the
fixed-point chain in plain PyTorch."""

from __future__ import annotations

import numpy as np
import torch

from ..golden import fixed_point as fx


def hamming_q15(n: int, coef_width: int = 16) -> np.ndarray:
    """Full-length Q15 integer Hamming coefficients — the reference ROM
    contents + symmetric addressing (window_multiplier.vhd:34-53, 96-104)."""
    return fx.hamming_coeffs(n, coef_width)


def hamming_float(n: int, coef_width: int = 16) -> np.ndarray:
    """Float window equal to the Q15 ROM contents scaled by the hardware's
    effective Q14 extraction gain (coef / 2^14, up to ~2.0)."""
    return hamming_q15(n, coef_width).astype(np.float32) / float(1 << (coef_width - 2))


def window_rounding_constant(coef_width: int = 16,
                             rounding: str = "unbiased") -> int:
    """The constant added before the >> (coef_width-2) extraction:
    2^(coef_width-2) for the reference's "biased" rounding, half of it for
    "unbiased" (window_multiplier.vhd:146-149)."""
    shift = coef_width - 2
    if rounding == "biased":
        return 1 << shift
    if rounding == "unbiased":
        return 1 << (shift - 1)
    raise ValueError(f"rounding must be 'biased' or 'unbiased', got "
                     f"{rounding!r}")


def window_apply_fixed(i: torch.Tensor, q: torch.Tensor, coeffs,
                       coef_width: int = 16, rounding: str = "unbiased"):
    """Bit-exact integer window multiply (window_multiplier.vhd:119-163):
    int32 product, rounding constant, arithmetic >> (coef_width-2), int16
    saturation.  Port of ``fmcw_tpu/ops/window.window_apply_fixed``.

    ``i``, ``q``: integer tensors (..., A, B); ``coeffs`` broadcasts against
    them.  Returns (i_out, q_out, sat) with int32 outputs and ``sat`` the
    number of saturated samples over the last two axes, I and Q counted
    separately — int32 of shape (...)."""
    shift = coef_width - 2
    rnd = window_rounding_constant(coef_width, rounding)
    c = torch.as_tensor(np.asarray(coeffs), dtype=torch.int32,
                        device=i.device)

    def one(x):
        s = (x.to(torch.int32) * c + rnd) >> shift
        sat = ((s > fx.INT16_MAX) | (s < fx.INT16_MIN)).sum(dim=(-2, -1))
        return s.clamp(fx.INT16_MIN, fx.INT16_MAX), sat.to(torch.int32)

    i_out, si = one(i)
    q_out, sq = one(q)
    return i_out, q_out, si + sq
