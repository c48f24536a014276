"""MTI clutter notch of the fixed-point chain in plain PyTorch — port of
``fmcw_tpu/ops/notch.mti_notch_fixed`` (rtl/src/doppler_notch.vhd:75-93).

The per-range-bin delay line becomes a shifted difference along the chirp
axis: zero-padded delays (the delay line resets per range bin), int16
saturation, the first notch_mode-1 outputs zeroed unless
``transient="passthrough"``, and ``bypass`` as the runtime mti_bypass
control (radar_core.vhd:48)."""

from __future__ import annotations

import torch

from ..golden.fixed_point import INT16_MIN, INT16_MAX


def _delayed(x: torch.Tensor, k: int) -> torch.Tensor:
    """x delayed by k samples along the last axis, zeros shifted in."""
    out = torch.zeros_like(x)
    out[..., k:] = x[..., :x.shape[-1] - k]
    return out


def check_notch(mode: int, transient: str) -> None:
    if mode not in (2, 3):
        raise ValueError(f"notch_mode must be 2 or 3, got {mode}")
    if transient not in ("zero", "passthrough"):
        raise ValueError(f"transient must be 'zero' or 'passthrough', got "
                         f"{transient!r}")


def mti_notch_fixed(i: torch.Tensor, q: torch.Tensor, mode: int = 2,
                    bypass: bool = False, transient: str = "zero"):
    """Bit-exact saturating 2- or 3-pulse canceller along the LAST axis
    (the chirp axis of the range-major (..., n_range, n_doppler) layout).
    Integer tensors in, int32 out."""
    check_notch(mode, transient)

    def one(x):
        x = x.to(torch.int32)
        if bypass:
            return x
        if mode == 2:
            y = x - _delayed(x, 1)
        else:
            y = x - 2 * _delayed(x, 1) + _delayed(x, 2)
        y = y.clamp(INT16_MIN, INT16_MAX)
        if transient == "zero":
            y[..., :mode - 1] = 0
        return y

    return one(i), one(q)
