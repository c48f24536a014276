"""Window ROM and CFAR window geometry (pure numpy).

Copied from ``fmcw_tpu/golden/fixed_point.py``; only what the float main path
needs:

* ``hamming_rom`` / ``hamming_coeffs``  <- rtl/src/window_multiplier.vhd:34-53
  (Q15 coefficient ROM, half-length with symmetric addressing)
* ``_window_offsets``                   <- rtl/src/os_cfar_2d.vhd:155-167
  (training-cell gather order of the 2D OS-CFAR)
"""

from __future__ import annotations

import numpy as np

from ..params import CfarParams

INT16_MIN = -32768
INT16_MAX = 32767


def hamming_rom(n_samples: int, coef_width: int = 16) -> np.ndarray:
    """Half-length Q15 Hamming ROM (window_multiplier.vhd:34-49).

    coef[i] = round(32767 * (0.54 - 0.46*cos(2*pi*i/(N-1)))), clamped to
    [0, 2^(coef_width-1)-1].  VHDL ``integer()`` rounds to nearest with ties
    away from zero; coefficients are positive so floor(x+0.5) matches.
    """
    i = np.arange(n_samples // 2, dtype=np.float64)
    angle = 2.0 * np.pi * i / float(n_samples - 1)
    coef_real = 0.54 - 0.46 * np.cos(angle)
    full_scale = float(2 ** (coef_width - 1) - 1)
    coef_int = np.floor(coef_real * full_scale + 0.5).astype(np.int64)
    return np.clip(coef_int, 0, 2 ** (coef_width - 1) - 1)


def hamming_coeffs(n_samples: int, coef_width: int = 16) -> np.ndarray:
    """Full-length coefficient vector via the reference's symmetric addressing
    (window_multiplier.vhd:96-104): addr = i for i < N/2 else N-1-i, clamped."""
    rom = hamming_rom(n_samples, coef_width)
    idx = np.arange(n_samples)
    addr = np.where(idx < n_samples // 2, idx, n_samples - 1 - idx)
    addr = np.minimum(addr, n_samples // 2 - 1)
    return rom[addr]


def _window_offsets(cfar: CfarParams):
    """(dr, dd) offsets of the reference (training) cells relative to the CUT,
    in the reference's gather order: Doppler-major, range-minor, skipping the
    guard region (os_cfar_2d.vhd:155-167)."""
    offs = []
    for d in range(cfar.win_doppler):
        for r in range(cfar.win_range):
            d_dist = abs(d - (cfar.ref_doppler + cfar.guard_doppler))
            r_dist = abs(r - (cfar.ref_range + cfar.guard_range))
            if d_dist <= cfar.guard_doppler and r_dist <= cfar.guard_range:
                continue
            offs.append((r - (cfar.ref_range + cfar.guard_range),
                         d - (cfar.ref_doppler + cfar.guard_doppler)))
    if len(offs) != cfar.n_ref:
        raise ValueError(f"window offsets {len(offs)} != n_ref {cfar.n_ref}")
    return offs
