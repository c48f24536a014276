"""Staggered-PRF Doppler ambiguity resolution (numpy copy of
``fmcw_tpu/utils/ambiguity.py``; the port imports nothing of the JAX
package).

The reference staggers three PRFs across scans (8/9/10 kHz,
rtl/src/tb_tactical.vhd:211 and the ADR scenario) — the classic reason to
stagger is to resolve the Doppler (blind-speed) ambiguity, but the
reference stops at generating the stagger; its visualizer converts bins to
velocity with a single PRF and wraps at v_amb = PRF*lambda/2 (= 400 m/s at
8 kHz — below Mach 1.2, so the scenario's fighters alias).  This module
implements the resolver: given the same target's Doppler bins measured at
two or more PRFs, recover the unambiguous radial velocity.

Method: each measurement constrains v ≡ v_k (mod v_amb_k).  Enumerate the
unfolding candidates of the first measurement over [-v_max, v_max] and
score each by the summed circular residual against every other PRF's
measurement; the minimizer is the resolved velocity (averaged over the
per-PRF unfolded estimates for a sub-bin answer).  With the reference's
8/9/10 kHz stagger the joint ambiguity extends to lcm-like km/s scales —
far beyond any airborne target.
"""

from __future__ import annotations

import numpy as np


def apparent_velocity(doppler_bin, n_doppler: int, prf: float,
                      wavelength: float = 0.1,
                      centered: bool = True) -> np.ndarray:
    """Doppler bin -> apparent (wrapped) radial velocity in m/s, wrapped to
    [-v_amb/2, v_amb/2) with v_amb = prf*wavelength/2 (the visualizer's
    convention, utils/viz.doppler_bin_to_mps)."""
    b = np.asarray(doppler_bin, np.float64)
    if centered:
        b = b - n_doppler / 2
    else:
        b = np.where(b >= n_doppler / 2, b - n_doppler, b)
    return b * prf * wavelength / (2.0 * n_doppler)


def unfold_velocity(doppler_bins, prfs, n_doppler: int,
                    wavelength: float = 0.1, v_max: float = 1200.0,
                    centered: bool = True):
    """Resolve the unambiguous radial velocity from >= 2 staggered-PRF
    measurements of the same target.

    Returns ``(v_mps, residual_mps)``: the resolved velocity and the RMS
    circular residual of the measurements against it (large residuals flag
    mis-associated detections).  Bin quantization limits accuracy to about
    ``max(v_amb_k)/n_doppler`` per measurement.
    """
    bins = np.asarray(doppler_bins, np.float64)
    prfs = np.asarray(prfs, np.float64)
    if bins.shape != prfs.shape or bins.size < 2:
        raise ValueError("need one doppler bin per PRF, at least two")
    v_amb = prfs * wavelength / 2.0
    v_app = np.array([apparent_velocity(b, n_doppler, p, wavelength,
                                        centered)
                      for b, p in zip(bins, prfs)])

    # Candidates: unfoldings of measurement 0 across [-v_max, v_max].
    m_lo = int(np.floor((-v_max - v_app[0]) / v_amb[0]))
    m_hi = int(np.ceil((v_max - v_app[0]) / v_amb[0]))
    cands = v_app[0] + v_amb[0] * np.arange(m_lo, m_hi + 1)
    cands = cands[(cands >= -v_max) & (cands <= v_max)]
    if cands.size == 0:
        cands = np.array([v_app[0]])

    def wrap_res(v):
        # circular distance of each measurement to v, per its own v_amb
        r = (v_app - v + v_amb / 2.0) % v_amb - v_amb / 2.0
        return r

    scores = np.array([np.sqrt(np.mean(wrap_res(v) ** 2)) for v in cands])
    v0 = cands[int(np.argmin(scores))]
    # Refine: average the per-PRF estimates unfolded to v0's interval.
    v_hat = float(np.mean(v0 + wrap_res(v0)))
    return v_hat, float(np.sqrt(np.mean(wrap_res(v_hat) ** 2)))
