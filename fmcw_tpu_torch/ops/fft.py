"""DFT and slow-time operator matrices (numpy) and their plain PyTorch
application.

The matrices are built exactly as ``fmcw_tpu/ops/fft.py`` builds them
(float64, then float32), so the port's constants are bit-identical to the
JAX package's.  ``dft_apply`` / ``doppler_apply`` are the plain versions of
the transforms, used by the kernels' twins in ``ops/frontend.py``; the main
path on the card runs them inside the CUDA kernels instead.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .window import hamming_float


@functools.lru_cache(maxsize=16)
def dft_matrices(n: int):
    """(cos, -sin) DFT matrices C[s, k] = exp(-2j*pi*s*k/n)."""
    s = np.arange(n)[:, None].astype(np.float64)
    k = np.arange(n)[None, :].astype(np.float64)
    ang = -2.0 * np.pi * s * k / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=16)
def doppler_matrices(n: int, notch_mode: int = 2, transient: str = "zero",
                     coef_width: int = 16):
    """The whole slow-time chain folded into one matrix pair.

    Window multiply, MTI notch and Doppler DFT are all linear along the
    chirp axis, so they compose into ``M = H^T @ diag(w) @ E`` with
    ``E[s, k] = exp(-2j*pi*s*k/n)``, ``w`` the Q15 Hamming window and ``H``
    the pulse canceller (doppler_notch.vhd:72-94: y[s] = x[s] - x[s-1] or
    x[s] - 2x[s-1] + x[s-2]; missing history reads as 0 = the "passthrough"
    transient, and ``transient="zero"`` zeroes the first notch_mode-1 output
    rows instead).  Contracting the chirp axis of the range-FFT output with
    M applies all three stages.  Returns (Mr_mti, Mi_mti, Mr_plain,
    Mi_plain); the plain pair folds only the window, for ``mti_bypass``.
    """
    if notch_mode not in (2, 3):
        raise ValueError(f"notch_mode must be 2 or 3, got {notch_mode}")
    if transient not in ("zero", "passthrough"):
        raise ValueError(f"transient must be 'zero' or 'passthrough', "
                         f"got {transient!r}")
    s = np.arange(n)[:, None].astype(np.float64)
    k = np.arange(n)[None, :].astype(np.float64)
    ang = -2.0 * np.pi * s * k / n
    er, ei = np.cos(ang), np.sin(ang)
    w = hamming_float(n, coef_width).astype(np.float64)[:, None]
    er_w, ei_w = er * w, ei * w                      # diag(w) @ E
    h = np.zeros((n, n))
    for r in range(n):
        h[r, r] = 1.0
        if r >= 1:
            h[r, r - 1] = -1.0 if notch_mode == 2 else -2.0
        if notch_mode == 3 and r >= 2:
            h[r, r - 2] = 1.0
    if transient == "zero":
        h[: notch_mode - 1, :] = 0.0
    return (np.ascontiguousarray((h.T @ er_w).astype(np.float32)),
            np.ascontiguousarray((h.T @ ei_w).astype(np.float32)),
            np.ascontiguousarray(er_w.astype(np.float32)),
            np.ascontiguousarray(ei_w.astype(np.float32)))


def _cmatmul(xr, xi, cr, ci):
    """(xr + i xi) @ (cr + i ci) as four real float32 matrix products."""
    return xr @ cr - xi @ ci, xr @ ci + xi @ cr


def dft_apply(re: torch.Tensor, im: torch.Tensor):
    """Forward DFT along the LAST axis of a complex tensor given as a float32
    (re, im) pair."""
    cr, ci = dft_matrices(re.shape[-1])
    cr = torch.as_tensor(cr, device=re.device)
    ci = torch.as_tensor(ci, device=re.device)
    return _cmatmul(re, im, cr, ci)


def doppler_apply(re: torch.Tensor, im: torch.Tensor, bypass: bool,
                  notch_mode: int = 2, transient: str = "zero"):
    """Fused slow-time stage (window + MTI + Doppler DFT) along the LAST
    axis, the chirp axis of the range-major ``(..., n_range, n_doppler)``
    layout; ``bypass`` selects the window-only matrix (``mti_bypass``)."""
    mr1, mi1, mr0, mi0 = doppler_matrices(re.shape[-1], notch_mode, transient)
    mr, mi = (mr0, mi0) if bypass else (mr1, mi1)
    return _cmatmul(re, im, torch.as_tensor(mr, device=re.device),
                    torch.as_tensor(mi, device=re.device))
