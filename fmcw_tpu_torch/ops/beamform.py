"""Beamforming — element-space to beam-space, in plain PyTorch.

Port of ``fmcw_tpu/ops/beamform.py``: a uniform-linear-array phase-shift
(delay-and-sum) beamformer expressed as one complex matrix product over the
element axis, a (n_beams, n_elems) steering matrix against (n_elems, ...)
element-space I/Q.  JAX leaves the product to XLA (``dot_general`` at
``HIGHEST``, outside any Pallas kernel), so here it is a plain float32
``torch.matmul`` in IEEE float32 (``ops/fft.full_fp32``: no TF32).

Conventions: element spacing ``spacing_wl`` in wavelengths (default λ/2),
beams steered to ``sin(theta)`` values ``u`` in [-sin(max_angle),
+sin(max_angle)], conventional weights with an optional amplitude taper.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .fft import full_fp32
from .magnitude import magnitude_float
from .window import hamming_float


@functools.lru_cache(maxsize=16)
def steering_matrix(n_elems: int, n_beams: int, spacing_wl: float = 0.5,
                    max_angle_deg: float = 60.0, taper: str | None = None,
                    dtype=np.float32):
    """(real, imag) of the (n_beams, n_elems) conventional beamforming weight
    matrix W[b, e] = t[e] * exp(-j*2*pi*spacing_wl*e*u_b), with u_b the beam's
    steering sine, uniformly spaced over [-sin(max_angle), sin(max_angle)];
    numpy, built exactly as ``fmcw_tpu/ops/beamform.steering_matrix`` builds
    it (float64, cast last).

    ``taper``: None (uniform) or "hamming" (``ops/window.hamming_float``
    across the elements)."""
    if n_beams == 1:
        # A single beam points broadside (linspace(-a, a, 1) would return
        # [-a] and steer it to -max_angle).
        u = np.zeros(1)
    else:
        u = np.linspace(-np.sin(np.deg2rad(max_angle_deg)),
                        np.sin(np.deg2rad(max_angle_deg)), n_beams)
    e = np.arange(n_elems)
    phase = -2.0 * np.pi * spacing_wl * np.outer(u, e)
    t = np.ones(n_elems)
    if taper == "hamming":
        t = np.asarray(hamming_float(n_elems), dtype=np.float64)
    elif taper is not None:
        raise ValueError(taper)
    wr = (np.cos(phase) * t).astype(dtype)
    wi = (np.sin(phase) * t).astype(dtype)
    return wr, wi


def beamform(re: torch.Tensor, im: torch.Tensor, n_beams: int,
             spacing_wl: float = 0.5, max_angle_deg: float = 60.0,
             taper: str | None = None, elem_dim: int = 0):
    """Element-space to beam-space: float32 I/Q pair with the element axis
    at ``elem_dim`` (0, as in JAX: (n_elems, ...); 1 for a batch of cubes
    (batch, n_elems, ...)) -> the same shape with n_beams there, via
    y_b = sum_e W[b, e] * x_e (four real float32 matrix products in IEEE
    float32).  The outputs are contiguous."""
    lead, n_elems, rest = (re.shape[:elem_dim], re.shape[elem_dim],
                           re.shape[elem_dim + 1:])
    wr, wi = (torch.as_tensor(w, device=re.device)
              for w in steering_matrix(n_elems, n_beams, spacing_wl,
                                       max_angle_deg, taper))
    xr = re.reshape(*lead, n_elems, -1)
    xi = im.reshape(*lead, n_elems, -1)
    with full_fp32():
        br = wr @ xr - wi @ xi
        bi = wr @ xi + wi @ xr
    return br.reshape(*lead, n_beams, *rest), bi.reshape(*lead, n_beams, *rest)


def beam_cube(re: torch.Tensor, im: torch.Tensor, n_beams: int,
              magnitude_exact: bool = False, **kw) -> torch.Tensor:
    """Element-space I/Q (n_elems, ...) -> per-beam magnitude cube
    (n_beams, ...) ready for ``ops/cfar.cfar_3d``."""
    br, bi = beamform(re, im, n_beams, **kw)
    return magnitude_float(br, bi, exact=magnitude_exact)
