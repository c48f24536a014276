"""Golden stimulus and fixed-point chain (pure numpy), copied from
``fmcw_tpu/golden/reference.py``.

``two_target_frame``  <- rtl/old/tb_radar_core.vhd:37-44,101-141 — targets at
range bin 100 (Doppler 5.0, amp 8000) and range bin 500 (Doppler -10.0, amp
5000), uniform noise +-20.
``process_frame_fixed`` — the fixed-point chain composed of the
``fixed_point`` stages: the oracle of the port's ``mode="fixed"``.
"""

from __future__ import annotations

import numpy as np

from ..params import RadarParams
from . import fixed_point as fx


def two_target_frame(params: RadarParams | None = None, seed: int = 1,
                     noise_floor: float = 20.0, targets=None) -> np.ndarray:
    """Synthesize the golden two-target CPI (rtl/old/tb_radar_core.vhd:101-141).

    Returns complex I/Q as an int16-valued complex128 array of shape
    (n_doppler, n_range) — chirp-major, as streamed into the core.

    phase_t = 2*pi*(range_bin * s / n_range + doppler * c / n_doppler);
    I += amp*cos, Q += amp*sin, plus uniform noise in [-noise_floor,
    +noise_floor], saturated to int16.

    ``targets``: list of (range_bin, doppler_bins, amplitude).  The default is
    the golden pair — range bins 100/500, Doppler 5/-10 at 1024x128 — scaled
    proportionally for other map shapes so bins stay in range.
    """
    p = params or RadarParams()
    if targets is None:
        targets = golden_targets(p)
    c = np.arange(p.n_doppler)[:, None]
    s = np.arange(p.n_range)[None, :]
    i_acc = np.zeros((p.n_doppler, p.n_range))
    q_acc = np.zeros((p.n_doppler, p.n_range))
    for rbin, dopp, amp in targets:
        phase = 2.0 * np.pi * (rbin * s / p.n_range + dopp * c / p.n_doppler)
        i_acc += amp * np.cos(phase)
        q_acc += amp * np.sin(phase)
    rng = np.random.default_rng(seed)
    i_acc += noise_floor * (rng.random(i_acc.shape) - 0.5) * 2.0
    q_acc += noise_floor * (rng.random(q_acc.shape) - 0.5) * 2.0
    i_v = np.clip(np.trunc(i_acc), fx.INT16_MIN, fx.INT16_MAX)
    q_v = np.clip(np.trunc(q_acc), fx.INT16_MIN, fx.INT16_MAX)
    return i_v + 1j * q_v


def golden_targets(p: RadarParams):
    """The default (range_bin, doppler_bins, amplitude) pair of
    ``two_target_frame`` for the map shape of ``p``."""
    return [(100 * p.n_range // 1024, 5.0 * p.n_doppler / 128, 8000.0),
            (500 * p.n_range // 1024, -10.0 * p.n_doppler / 128, 5000.0)]


def process_frame_fixed(frame_iq: np.ndarray, params: RadarParams | None = None,
                        mti_bypass: bool = False, scale_override: int = 0,
                        mti_transient: str = "zero",
                        window_rounding: str = "unbiased"):
    """Run the fixed-point chain on one (n_doppler, n_range) complex int frame.

    With ``window_rounding="biased"`` and ``mti_transient="passthrough"`` every
    stage is bit-faithful to the reference hardware; the defaults use the
    framework's cleaned-up numerics.  The FFTs are the block-floating-point
    ``bfp_fft`` (the stage-scaled variant is not ported; ROADMAP.md).
    Returns (mag_map, det_map) int64 arrays of shape (n_range, n_doppler).
    """
    p = params or RadarParams()
    z = np.asarray(frame_iq)
    i_v, q_v = z.real.astype(np.int64), z.imag.astype(np.int64)

    cr = fx.hamming_coeffs(p.n_range, p.coef_width)
    i_v, q_v, _ = fx.window_apply(i_v, q_v, cr[None, :], p.coef_width,
                                  rounding=window_rounding)
    i_v, q_v = fx.bfp_fft(i_v, q_v, axis=1)

    i_v, q_v = i_v.T, q_v.T  # corner turn -> (n_range, n_doppler)

    i_v, q_v = fx.mti_notch(i_v, q_v, axis=1, mode=p.notch_mode,
                            bypass=mti_bypass, transient=mti_transient)

    cd = fx.hamming_coeffs(p.n_doppler, p.coef_width)
    i_v, q_v, _ = fx.window_apply(i_v, q_v, cd[None, :], p.coef_width,
                                  rounding=window_rounding)
    i_v, q_v = fx.bfp_fft(i_v, q_v, axis=1)

    mag = fx.magnitude(i_v, q_v)
    det = fx.os_cfar_2d(mag, p.cfar, scale_override)
    return mag, det
