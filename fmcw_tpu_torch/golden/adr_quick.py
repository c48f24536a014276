"""Exact reproduction of the reference's quick-validation stimulus.

Numpy copy of ``fmcw_tpu/golden/adr_quick.py``'s generator (the port
imports nothing of the JAX package).  ``rtl/old/ADR_tb_quick.vhd``
generated the reference's quick-scenario expected-behavior artifacts: a
128x32 map, 5 scans, 2 fighters (80/82 km, Mach 1) + 1 attacker (70 km,
-220 m/s), notch on scan 3 with resume on scan 4, Gaussian noise sigma=50,
no clutter (ADR_tb_quick.vhd:53-68,180-277).

Its random source is IEEE 1076.2 ``UNIFORM`` -- the L'Ecuyer (1988)
combined multiplicative LCG mandated by the standard -- with both seeds
fixed at 42 (ADR_tb_quick.vhd:130), so the I/Q stimulus is exactly
reproducible in software: this module regenerates it bit for bit
(double-precision real arithmetic in the same per-cell order, VHDL
integer() round-to-nearest quantization).  ``golden_frame_exact``
regenerates the golden two-target stimulus the same way.

The chain that consumed the quick stimulus (the old ADR core's unscaled
inverse XFFTs and its pre-fix CFAR) is not reproducible bit for bit, so
the artifacts themselves compare at cluster level only; the artifact
loaders, which read the reference's files, are not copied.  The faithful
quick run here is the stimulus through ``mode="fixed"``,
``cfar_geometry="hw_stream"``, ``window_rounding="biased"`` and
``mti_transient="passthrough"``, held to ``fixed_point.
os_cfar_2d_hw_stream``.
"""

from __future__ import annotations

import numpy as np

from ..params import RadarParams

MAX_RANGE_M = 120000.0
WAVELENGTH = 0.1
PRF_HZ = 10000.0
NOISE_SIGMA = 50.0
NUM_SCANS = 5
NOTCH_SCAN = 3


def ieee_uniform(s1: int, s2: int):
    """One draw of IEEE 1076.2 UNIFORM (L'Ecuyer 1988 combined MLCG).
    Returns (s1', s2', x) with x in (0, 1)."""
    k = s1 // 53668
    s1 = 40014 * (s1 - k * 53668) - k * 12211
    if s1 < 0:
        s1 += 2147483563
    k = s2 // 52774
    s2 = 40692 * (s2 - k * 52774) - k * 3791
    if s2 < 0:
        s2 += 2147483399
    z = s1 - s2
    if z < 1:
        z += 2147483562
    return s1, s2, z * 4.656613e-10


def uniform_block(s1: int, s2: int, n: int):
    """n sequential draws.  Returns (s1', s2', float64[n])."""
    out = np.empty(n, dtype=np.float64)
    for i in range(n):
        s1, s2, out[i] = ieee_uniform(s1, s2)
    return s1, s2, out


def _vhdl_int(x: np.ndarray) -> np.ndarray:
    """VHDL integer(real): round to nearest, ties away from zero."""
    x = np.asarray(x, dtype=np.float64)
    return (np.floor(np.abs(x) + 0.5) * np.sign(x)).astype(np.int64)


def _range_to_bin(r: float, n_range: int) -> int:
    return int(_vhdl_int((r / MAX_RANGE_M) * n_range))


def _vel_to_doppler(v: float, n_doppler: int) -> int:
    """ADR_tb_quick.vhd:149-157: real-valued wrap, then integer() round."""
    fd = 2.0 * v / WAVELENGTH
    b = (fd / PRF_HZ) * n_doppler + n_doppler / 2.0
    if b < 0.0:
        b += n_doppler
    if b >= n_doppler:
        b -= n_doppler
    return int(_vhdl_int(b))


def _rcs_to_amp(rcs: float, rng: float) -> float:
    if rng < 1000.0:
        return 25000.0
    return float(np.sqrt(rcs) * 15000.0 / np.sqrt((rng / 10000.0) ** 4))


def quick_params() -> RadarParams:
    """The DUT generics of ADR_tb_quick.vhd:108-111 (== params.quick())."""
    from .. import params as P
    return P.quick()


def quick_frames():
    """Regenerate the 5 quick-scenario CPI frames bit-exactly.

    Returns (frames, truths): frames complex128[(5, 32, 128)] holding
    int16-ranged I/Q (chirp-major, as streamed into the core), truths a
    per-scan list of (range_bin, doppler_bin, amp) for the active targets.
    """
    n_range, n_doppler = 128, 32
    s1 = s2 = 42
    targets = [
        # range_m, vel_mps, rcs  (ADR_tb_quick.vhd:181-183)
        [80000.0, -340.0, 12.0],
        [82000.0, -340.0, 12.0],
        [70000.0, -220.0, 20.0],
    ]
    c = np.arange(n_doppler)[:, None]
    s = np.arange(n_range)[None, :]
    frames = np.empty((NUM_SCANS, n_doppler, n_range), dtype=np.complex128)
    truths = []
    for scan in range(1, NUM_SCANS + 1):
        # Kinematics update BEFORE the notch switch (ADR_tb_quick.vhd:192-205)
        for t in targets:
            t[0] += t[1] * 0.5
        if scan == NOTCH_SCAN:
            targets[0][1] = targets[1][1] = 0.0
        elif scan == NOTCH_SCAN + 1:
            targets[0][1] = targets[1][1] = -340.0

        i_acc = np.zeros((n_doppler, n_range))
        q_acc = np.zeros((n_doppler, n_range))
        truth = []
        for rng_m, vel, rcs in targets:
            rb = _range_to_bin(rng_m, n_range)
            db = _vel_to_doppler(vel, n_doppler)
            amp = _rcs_to_amp(rcs, rng_m)
            truth.append((rb, db, amp))
            # 3-sample burst, full amplitude (no skirt attenuation in the
            # quick TB), phase = 2*pi*(rb*s/NR + db*c/ND)
            gate = np.abs(s - rb) < 2
            phase = 2.0 * np.pi * (rb * s / n_range + db * c / n_doppler)
            i_acc += np.where(gate, amp * np.cos(phase), 0.0)
            q_acc += np.where(gate, amp * np.sin(phase), 0.0)
        truths.append(truth)

        # Noise: gauss() consumes two uniforms per cell, c-outer s-inner.
        s1, s2, u = uniform_block(s1, s2, 2 * n_doppler * n_range)
        u = u.reshape(n_doppler, n_range, 2)
        u1 = np.maximum(u[..., 0], 1.0e-10)
        g1 = np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u[..., 1])
        g2 = np.sqrt(-2.0 * np.log(u1)) * np.sin(2.0 * np.pi * u[..., 1])
        i_acc += g1 * NOISE_SIGMA
        q_acc += g2 * NOISE_SIGMA

        i_v = _vhdl_int(np.clip(i_acc, -32000.0, 32000.0))
        q_v = _vhdl_int(np.clip(q_acc, -32000.0, 32000.0))
        frames[scan - 1] = i_v + 1j * q_v
    return frames, truths


def golden_frame_exact(cpi: int = 0):
    """Bit-exact regeneration of the golden-data stimulus that produced
    ``data/radar_output.txt`` (rtl/old/tb_radar_core.vhd:85-145): 2 CPIs of
    two full-length target tones — (range 100, Doppler 5.0, amp 8000) and
    (range 500, Doppler -10.0, amp 5000) — plus uniform noise in +-20,
    IEEE 1076.2 UNIFORM seeds (1, 1) running continuously across both
    CPIs, VHDL integer() rounding then int16 clip.

    Returns the requested CPI's (128, 1024) complex frame (the checked-in
    map is CPI 0: its 131,072 rows label from (0,0) in stream order and
    the monitor's early-exit truncated CPI 1).

    The MAP itself is still not bit-reproducible from this stimulus: the
    v3-era core drove its xfft IP with config x"01" (forward, scale
    schedule 0 — radar_core_v3.vhd:201), i.e. UNSCALED fixed-point
    transforms whose strong-signal stages wrap; see design_notes §3 for
    the overflow forensics the map's structure confirms.
    """
    nr, nd = 1024, 128
    s1 = s2 = 1
    s1, s2, u = uniform_block(s1, s2, 2 * 2 * nd * nr)
    u = u.reshape(2, nd, nr, 2)[cpi]
    c = np.arange(nd)[:, None]
    s = np.arange(nr)[None, :]
    ph1 = 2.0 * np.pi * (100.0 * s / nr + 5.0 * c / nd)
    ph2 = 2.0 * np.pi * (500.0 * s / nr + (-10.0) * c / nd)
    i_acc = (8000.0 * np.cos(ph1) + 5000.0 * np.cos(ph2)
             + 20.0 * (u[..., 0] - 0.5) * 2.0)
    q_acc = (8000.0 * np.sin(ph1) + 5000.0 * np.sin(ph2)
             + 20.0 * (u[..., 1] - 0.5) * 2.0)
    iv = np.clip(_vhdl_int(i_acc), -32768, 32767)
    qv = np.clip(_vhdl_int(q_acc), -32768, 32767)
    return iv + 1j * qv
