"""Bit-faithful fixed-point golden model (pure numpy).

Copied from ``fmcw_tpu/golden/fixed_point.py`` (the port imports nothing of
the JAX package); the oracle ``chip_smoke.py`` holds the fixed-mode chain
against on the card.  Each function reproduces the integer arithmetic of
the corresponding VHDL component of the reference design:

* ``hamming_rom`` / ``hamming_coeffs``  <- rtl/src/window_multiplier.vhd:34-53
  (Q15 coefficient ROM, half-length with symmetric addressing)
* ``window_apply``                      <- rtl/src/window_multiplier.vhd:119-163
  (Q15 multiply, round, >>14 extract, saturate to int16, sticky flag)
* ``bfp_fft``                           - the framework's block-floating-point
  FFT semantics (unscaled float64 DFT, one per-transform exponent putting the
  peak in the top octave of int16, round half to even, exponent discarded)
* ``scaled_fft`` / ``bit_reverse_permutation`` - the stage-scaled FFT of
  the QUICK-mode XFFT variants (radix-2 DIF, Q15 twiddles, convergent
  rounding, per-stage shifts, int16 wrap)
* ``mti_notch``                         <- rtl/src/doppler_notch.vhd:52-112
* ``magnitude``                         <- rtl/src/magnitude_calc.vhd:45-88
* ``os_cfar_2d``                        <- rtl/src/os_cfar_2d.vhd:150-217
  (2D ordered-statistic CFAR, named axes, wrap edges), with
  ``block_scale_map`` (the clutter-map scale, no VHDL counterpart)
* ``peak_group`` / ``extract_detections`` - grouping and stream-order list
* ``_window_offsets``                   <- rtl/src/os_cfar_2d.vhd:155-167
* ``os_cfar_2d_hw_stream``              <- rtl/src/os_cfar_2d.vhd +
  rtl/src/radar_core.vhd:396-418 (the AS-BUILT streaming CFAR: crossed-axis
  window over the flat stream, startup skip, label offset, line buffer
  carried across frames), with ``_hw_stream_offsets`` and ``hw_stream_lag``
* ``os_cfar_1d``                        <- rtl/old/os_cfar.vhd (the 1D
  lineage detector)
"""

from __future__ import annotations

import numpy as np

from ..params import CfarParams

INT16_MIN = -32768
INT16_MAX = 32767


# ---------------------------------------------------------------------------
# Window (rtl/src/window_multiplier.vhd)
# ---------------------------------------------------------------------------

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


def window_apply(i: np.ndarray, q: np.ndarray, coeffs: np.ndarray,
                 coef_width: int = 16, rounding: str = "biased"):
    """Bit-exact Q15 window multiply (window_multiplier.vhd:119-163).

    product = x * coef (int16 x Q15); shifted = (product + rnd) >>
    (coef_width-2) (arithmetic); saturate to int16.  The extraction is >> 14,
    so the effective window gain is coef / 2^14 (up to ~2.0) and full-scale
    inputs can saturate.  ``rounding``: "biased" (reference-exact, rnd =
    2^14, window_multiplier.vhd:146-149) or "unbiased" (rnd = 2^13, the
    framework default).

    Returns (i_out, q_out, saturated): int16-valued int64 arrays and a bool
    array marking saturated samples (sticky OR of I and Q,
    window_multiplier.vhd:151-158).
    """
    shift = coef_width - 2
    if rounding == "biased":
        rnd = 1 << shift
    elif rounding == "unbiased":
        rnd = 1 << (shift - 1)
    else:
        raise ValueError(rounding)

    def one(x):
        p = x.astype(np.int64) * coeffs.astype(np.int64)
        shifted = (p + rnd) >> shift  # arithmetic shift (numpy >> floors)
        sat = (shifted > INT16_MAX) | (shifted < INT16_MIN)
        return np.clip(shifted, INT16_MIN, INT16_MAX), sat

    i_out, sat_i = one(np.asarray(i))
    q_out, sat_q = one(np.asarray(q))
    return i_out, q_out, (sat_i | sat_q)


# ---------------------------------------------------------------------------
# Block-floating-point FFT (defined semantics; see module docstring)
# ---------------------------------------------------------------------------

def _round_half_even_to_int(x: np.ndarray) -> np.ndarray:
    """Convergent rounding (round half to even), matching the XFFT config."""
    return np.rint(x).astype(np.int64)


def bfp_fft(i: np.ndarray, q: np.ndarray, axis: int = -1):
    """Forward DFT with per-transform block-floating-point normalization.

    Each transform (each 1D slice along ``axis``) is scaled by 2^-s with
    s = max(0, ceil(log2(peak/2^15))), peak the largest |Re|/|Im| of the
    unscaled float64 DFT.  The exact-power-of-two corner: a positive peak of
    exactly 2^15 * 2^k scales to +32768 and saturates to 32767, while a
    -32768 peak survives (int16's asymmetry); every twin in the port
    reproduces it.  The block exponent is discarded, as the reference
    discards the XFFT tuser field (rtl/src/radar_core.vhd:310).

    Returns (i_out, q_out) int64 arrays holding int16-ranged values.
    """
    z = np.asarray(i, dtype=np.float64) + 1j * np.asarray(q, dtype=np.float64)
    zf = np.fft.fft(z, axis=axis)
    peak = np.maximum(np.abs(zf.real), np.abs(zf.imag))
    peak = np.max(peak, axis=axis, keepdims=True)
    s = np.ceil(np.log2(np.maximum(peak, 1.0) / 32768.0))
    s = np.maximum(s, 0.0)
    zf = zf / (2.0 ** s)
    i_out = np.clip(_round_half_even_to_int(zf.real), INT16_MIN, INT16_MAX)
    q_out = np.clip(_round_half_even_to_int(zf.imag), INT16_MIN, INT16_MAX)
    return i_out, q_out


def bit_reverse_permutation(n: int) -> np.ndarray:
    """Index permutation ``perm`` with perm[k] = bit-reverse of k (log2 n
    bits).  Self-inverse."""
    m = n.bit_length() - 1
    perm = np.zeros(n, dtype=np.int64)
    for k in range(n):
        r = 0
        for b in range(m):
            if k >> b & 1:
                r |= 1 << (m - 1 - b)
        perm[k] = r
    return perm


def q15_twiddles(L: int):
    """The Q15 phase factors of a length-L DIF stage: int64 (wr, wi) of
    ``rint(32768 e^(-2 pi i k / L))`` clipped to int16, k < L / 2, built in
    float64 on the host."""
    ang = -2.0 * np.pi * np.arange(L >> 1) / L
    wr = np.clip(np.rint(32768.0 * np.cos(ang)), -32768, 32767)
    wi = np.clip(np.rint(32768.0 * np.sin(ang)), -32768, 32767)
    return wr.astype(np.int64), wi.astype(np.int64)


def rhe_shift(x, sh: int):
    """Convergent (round-half-even) arithmetic right shift of integers by
    ``sh``: numpy arrays or torch tensors."""
    if sh == 0:
        return x
    half = 1 << (sh - 1)
    fl = x >> sh
    rem = x - (fl << sh)
    return fl + (rem > half) + ((rem == half) & ((fl & 1) == 1))


def wrap16(x):
    """Two's-complement wrap of integers to int16's range."""
    return ((x + 32768) & 65535) - 32768


def scaled_fft(i: np.ndarray, q: np.ndarray, axis: int = -1,
               scale_sch=None, output_order: str = "natural"):
    """Stage-scaled fixed-point FFT: the arithmetic family of the
    QUICK-mode XFFT variants (xfft_128.xci / xfft_32.xci:
    scaling_options="scaled", convergent rounding, 16-bit phase factors;
    xfft_128 emits bit_reversed_order), the alternative to the production
    instances' block-floating-point ``bfp_fft``.

    The pinned semantics (a radix-2 DIF network in the XFFT's parameter
    space; the closed IP's internal pipeline is not observable):

    * radix-2 decimation-in-frequency stages, natural-order input;
    * butterfly sums exact; the twiddle leg multiplies by Q15 phase factors
      (``q15_twiddles``), the trivial k = 0 twiddle bypassed (no multiply),
      and the product convergent-rounded back by 2^-15;
    * after each stage both legs shift right by ``scale_sch[stage]``
      (convergent rounding) and WRAP to int16 (no saturation);
    * ``scale_sch``: one shift per stage, stage 0 the largest-block stage.
      None = all zeros, what the reference's config word x"0001" programs
      (rtl/src/radar_core.vhd:247: no scaling, wraps); [1]*log2(n) is the
      conventional 1/N scaling;
    * ``output_order``: "bit_reversed" (the DIF network's native order) or
      "natural".

    Returns (i_out, q_out) int64 arrays of int16-ranged values.
    """
    ir = np.moveaxis(np.asarray(i, dtype=np.int64), axis, -1).copy()
    qr = np.moveaxis(np.asarray(q, dtype=np.int64), axis, -1).copy()
    n = ir.shape[-1]
    m = n.bit_length() - 1
    if 1 << m != n:
        raise ValueError(f"scaled_fft needs a power-of-two length, got {n}")
    if scale_sch is None:
        scale_sch = [0] * m
    if len(scale_sch) != m:
        raise ValueError(f"scale_sch needs {m} entries, got {len(scale_sch)}")
    if output_order not in ("natural", "bit_reversed"):
        raise ValueError(output_order)

    for s in range(m):
        L = n >> s
        h = L >> 1
        sh = ir.shape[:-1] + (n // L, L)
        ar, br = ir.reshape(sh)[..., :h], ir.reshape(sh)[..., h:]
        ai, bi = qr.reshape(sh)[..., :h], qr.reshape(sh)[..., h:]
        ur, ui = ar + br, ai + bi
        vr, vi = ar - br, ai - bi
        wr, wi = q15_twiddles(L)
        tr = rhe_shift(vr * wr - vi * wi, 15)
        ti = rhe_shift(vr * wi + vi * wr, 15)
        # k = 0 twiddle bypass: W^0 = 1 exactly (no Q15 product).
        tr[..., 0] = vr[..., 0]
        ti[..., 0] = vi[..., 0]
        ssh = int(scale_sch[s])
        out_r = np.concatenate([rhe_shift(ur, ssh), rhe_shift(tr, ssh)],
                               axis=-1)
        out_i = np.concatenate([rhe_shift(ui, ssh), rhe_shift(ti, ssh)],
                               axis=-1)
        ir = wrap16(out_r).reshape(ir.shape)
        qr = wrap16(out_i).reshape(qr.shape)

    if output_order == "natural":
        perm = bit_reverse_permutation(n)
        ir, qr = ir[..., perm], qr[..., perm]
    return np.moveaxis(ir, -1, axis), np.moveaxis(qr, -1, axis)


# ---------------------------------------------------------------------------
# MTI notch (rtl/src/doppler_notch.vhd)
# ---------------------------------------------------------------------------

def mti_notch(i: np.ndarray, q: np.ndarray, axis: int = 0, mode: int = 2,
              bypass: bool = False, transient: str = "zero"):
    """Saturating MTI clutter canceller along the slow-time (chirp) axis.

    2-pulse: y[c] = sat16(x[c] - x[c-1]); 3-pulse: y[c] = sat16(x[c] - 2x[c-1]
    + x[c-2]) (doppler_notch.vhd:72-94).  ``transient``: "zero" emits 0 for
    the first mode-1 chirps; "passthrough" is reference-exact (the delay
    line resets per range bin, so x[-1] = x[-2] = 0, doppler_notch.vhd:99-102).
    """
    if bypass:
        return np.asarray(i).copy(), np.asarray(q).copy()
    if transient not in ("zero", "passthrough"):
        raise ValueError(transient)

    def delay(x, k):
        x = np.asarray(x, dtype=np.int64)
        pad = [(0, 0)] * x.ndim
        pad[axis] = (k, 0)
        xp = np.pad(x, pad)
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(0, x.shape[axis])
        return xp[tuple(sl)]

    def one(x):
        x = np.asarray(x, dtype=np.int64)
        if mode == 2:
            y = x - delay(x, 1)
        elif mode == 3:
            y = x - 2 * delay(x, 1) + delay(x, 2)
        else:
            raise ValueError(f"notch mode must be 2 or 3, got {mode}")
        y = np.clip(y, INT16_MIN, INT16_MAX)
        if transient == "zero":
            sl = [slice(None)] * x.ndim
            sl[axis] = slice(0, mode - 1)
            y[tuple(sl)] = 0
        return y

    return one(i), one(q)


# ---------------------------------------------------------------------------
# Magnitude (rtl/src/magnitude_calc.vhd)
# ---------------------------------------------------------------------------

def magnitude(i: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Alpha-max-beta-min magnitude: max(|I|,|Q|) + min/4 + min/8 with
    truncating shifts (magnitude_calc.vhd:70-88); abs(-32768) = +32768."""
    ai = np.abs(np.asarray(i, dtype=np.int64))
    aq = np.abs(np.asarray(q, dtype=np.int64))
    mx = np.maximum(ai, aq)
    mn = np.minimum(ai, aq)
    return mx + (mn >> 2) + (mn >> 3)


# ---------------------------------------------------------------------------
# 2D OS-CFAR (rtl/src/os_cfar_2d.vhd)
# ---------------------------------------------------------------------------

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


def _gather_refs(mag_map: np.ndarray, cfar: CfarParams) -> np.ndarray:
    """Stack the n_ref training cells for every CUT: (n_ref, R, D)."""
    m = np.asarray(mag_map, dtype=np.int64)
    if cfar.edge_mode == "wrap":
        shifted = [np.roll(m, (-dr, -dd), axis=(0, 1))
                   for dr, dd in _window_offsets(cfar)]
    elif cfar.edge_mode == "reflect":
        hr, hd = cfar.halo_range, cfar.halo_doppler
        mp = np.pad(m, ((hr, hr), (hd, hd)), mode="reflect")
        shifted = [mp[hr + dr: hr + dr + m.shape[0],
                      hd + dd: hd + dd + m.shape[1]]
                   for dr, dd in _window_offsets(cfar)]
    else:
        raise ValueError(cfar.edge_mode)
    return np.stack(shifted, axis=0)


def cfar_threshold_stats(mag_map: np.ndarray, cfar: CfarParams):
    """Per-cell (ranked_or_estimate, mean) used by thresholding: the
    rank_idx-th ascending order statistic of the n_ref training cells for
    "os" (os_cfar_2d.vhd:172-183); the training mean for "ca"; the
    greater/smaller of the lead/lag range-block means for "go"/"so"."""
    refs = _gather_refs(mag_map, cfar)
    mean = np.sum(refs, axis=0) // cfar.n_ref  # truncating (os_cfar_2d.vhd:189)
    if cfar.variant == "os":
        part = np.partition(refs, cfar.rank_idx, axis=0)
        est = part[cfar.rank_idx]
    elif cfar.variant == "ca":
        est = mean
    elif cfar.variant in ("go", "so"):
        offs = np.array(_window_offsets(cfar))
        lead = refs[offs[:, 0] < -cfar.guard_range]
        lag = refs[offs[:, 0] > cfar.guard_range]
        n_half = cfar.ref_range * cfar.win_doppler
        m_lead = np.sum(lead, axis=0) // n_half
        m_lag = np.sum(lag, axis=0) // n_half
        est = (np.maximum if cfar.variant == "go" else np.minimum)(m_lead, m_lag)
    else:
        raise ValueError(cfar.variant)
    return est, mean


def cfar_scale(est: np.ndarray, mean: np.ndarray, cfar: CfarParams,
               scale_override: int = 0) -> np.ndarray:
    """Adaptive threshold scale selection (os_cfar_2d.vhd:187-199):
    estimate > 1.5*mean -> scale_max (high clutter); estimate < 0.5*mean ->
    scale_min (uniform noise); else scale_nom.  Non-zero override wins."""
    if scale_override != 0:
        return np.full_like(est, int(scale_override))
    hi = est > mean + (mean >> 1)
    lo = est < (mean >> 1)
    return np.where(hi, cfar.scale_max, np.where(lo, cfar.scale_min, cfar.scale_nom))


def block_scale_map(mag_map: np.ndarray, cfar: CfarParams,
                    scale_override: int = 0) -> np.ndarray:
    """Block-granular ("clutter-map") adaptive scale (see
    CfarParams.scale_mode).  Per scale_block x scale_block tile: a truncating
    mean over the 3x3-block neighborhood (9*B*B cells); a cell exceeds-hi iff
    v > its own block's mean + mean>>1 and counts-lo iff v >= mean>>1; the
    tile takes scale_max when >= k of its neighborhood's cells exceed hi,
    scale_min when < k of them count lo, else scale_nom (k = 9*B*B -
    rank_idx)."""
    m = np.asarray(mag_map, dtype=np.int64)
    B = cfar.scale_block
    R, D = m.shape
    if R % B or D % B:
        raise ValueError(f"scale_block={B} must divide map shape {(R, D)}")
    if scale_override != 0:
        return np.full((R, D), int(scale_override))
    Rb, Db = R // B, D // B
    N = 9 * B * B
    rank_idx = min((N * cfar.rank_pct) // 100, N - 1)
    k = N - rank_idx

    def shift(a, i, j):
        """grid[b] <- grid[b + (i, j)] on the (Rb, Db) block grid."""
        if cfar.edge_mode == "wrap":
            return np.roll(a, (-i, -j), axis=(0, 1))
        ri = np.clip(np.arange(Rb) + i, 0, Rb - 1)
        rj = np.clip(np.arange(Db) + j, 0, Db - 1)
        return a[ri][:, rj]

    offs = [(i, j) for i in (-1, 0, 1) for j in (-1, 0, 1)]

    def nb9(a):
        return sum(shift(a, i, j) for i, j in offs)

    def block_reduce(x):
        return x.reshape(Rb, B, Db, B).sum(axis=(1, 3))

    mean = nb9(block_reduce(m)) // N                      # (Rb, Db)
    t_hi = np.repeat(np.repeat(mean + (mean >> 1), B, 0), B, 1)
    t_lo = np.repeat(np.repeat(mean >> 1, B, 0), B, 1)
    cnt_hi = nb9(block_reduce(m > t_hi))
    cnt_lo = nb9(block_reduce(m >= t_lo))
    hi = cnt_hi >= k
    lo = cnt_lo < k
    scale_b = np.where(hi, cfar.scale_max,
                       np.where(lo, cfar.scale_min, cfar.scale_nom))
    return np.repeat(np.repeat(scale_b, B, 0), B, 1)


def os_cfar_2d(mag_map: np.ndarray, cfar: CfarParams, scale_override: int = 0,
               return_debug: bool = False):
    """Full 2D CFAR over a (n_range, n_doppler) magnitude map.

    Returns the zero-suppressed detection map: cell magnitude where
    CUT > threshold, else 0 (os_cfar_2d.vhd:204-217).  With
    ``return_debug``, also returns (threshold, scale) maps — the dbg_threshold/
    dbg_scale taps of os_cfar_2d.vhd:219-220.
    """
    m = np.asarray(mag_map, dtype=np.int64)
    est, mean = cfar_threshold_stats(m, cfar)
    if cfar.scale_mode == "block":
        scale = block_scale_map(m, cfar, scale_override)
    else:
        scale = cfar_scale(est, mean, cfar, scale_override)
    threshold = est * scale
    out = np.where(m > threshold, m, 0)
    if return_debug:
        return out, threshold, scale
    return out


def _hw_stream_offsets(cfar: CfarParams):
    """Flat-stream training-cell offsets of the AS-BUILT streaming CFAR.

    The reference's streaming implementation has a crossed-axis geometry
    (SURVEY.md §2a): the stream into the CFAR is range-major (one Doppler row
    per tlast, rtl/src/radar_core.vhd:396-411), its line buffer steps one
    *range row* per wrap of WIN_DOPPLER rows, and its along-stream shift
    register spans the *Doppler* axis — so window(d, r) holds the cell at
    flat-stream offset (d - CUT_D)*N_DOPPLER + (CUT_R - r) from the CUT
    (rtl/src/os_cfar_2d.vhd:50-57,118-147).  Net: the REF_DOPPLER/
    GUARD_DOPPLER generics govern the range axis and REF_RANGE/GUARD_RANGE
    the along-stream (Doppler) axis, and the Doppler-axis neighborhood runs
    across row boundaries as a flat stream (cell (r, 0)'s left neighbor is
    (r-1, D-1), not (r, D-1)).

    Returns (row_delta, stream_delta) pairs in the hardware gather order
    (os_cfar_2d.vhd:155-167): row_delta steps the range axis in units of
    one Doppler row, stream_delta steps along the flat stream.
    """
    offs = []
    for d in range(cfar.win_doppler):       # line-buffer rows == RANGE axis
        for r in range(cfar.win_range):     # along-stream   == DOPPLER axis
            if (abs(d - cfar.halo_doppler) <= cfar.guard_doppler
                    and abs(r - cfar.halo_range) <= cfar.guard_range):
                continue
            offs.append((d - cfar.halo_doppler, cfar.halo_range - r))
    assert len(offs) == cfar.n_ref
    return offs


def hw_stream_lag(cfar: CfarParams, n_doppler: int) -> int:
    """How far the streaming CFAR's CUT trails the input sample, in flat
    stream cells: (CUT_D + 1)*N_DOPPLER + CUT_R.  The window holds rows
    R-WIN_DOPPLER..R-1 (the current sample never enters its own cycle's
    window — VHDL signal semantics: the line-buffer write at os_cfar_2d.vhd:120
    commits after the read at :145), so the CUT sits CUT_D + 1 rows behind.
    The startup skip STARTUP_DELAY = lag + 2 (os_cfar_2d.vhd:66-68) and the
    2-deep valid/data pipelines (:207-227) then place the first emitted
    output at flat cell index 3 for *every* geometry."""
    return (cfar.halo_doppler + 1) * n_doppler + cfar.halo_range


def os_cfar_2d_hw_stream(frames: np.ndarray, cfar: CfarParams,
                         scale_override: int = 0, return_debug: bool = False):
    """Bit-exact model of the AS-BUILT streaming 2D CFAR + detection labeler
    (rtl/src/os_cfar_2d.vhd + rtl/src/radar_core.vhd:396-418) — the opt-in
    hw-compat mode (docs/design_notes.md §4).  Differences from the named-axis
    ``os_cfar_2d``:

    * crossed-axis window geometry over the flat range-major stream
      (``_hw_stream_offsets``), with the Doppler-axis window running across
      row boundaries instead of wrapping within the row;
    * cells before the stream start read as 0 (the zero-initialized line
      buffer), and consecutive frames bleed into each other's windows (the
      line buffer persists across frames);
    * the startup skip drops the first 3 cells and the final ``lag`` cells
      of the stream are never emitted (they would be emitted while the
      *next* frame streams in);
    * detection coordinates carry the as-built label offset: the hardware's
      doppler-fast output counter starts at the first *emitted* cell, so
      label_flat = (true_flat - 3) mod frame_size — true positions sit 3
      Doppler bins (with carry into the next range row) above their labels.

    ``frames``: one (R, D) map or a (n_frames, R, D) stack processed as one
    continuous multi-frame stream (the steady-state hardware behavior: each
    frame's head cells re-label the previous frame's tail).

    Returns (label_range, label_doppler, mag) detection arrays in emission
    order; with ``return_debug`` a dict adding the emitted CUT flat positions
    (``cells``), per-output threshold/scale/mean/est and the zero-suppressed
    output stream (``out``) for bit-level stream comparison.
    """
    f = np.asarray(frames, dtype=np.int64)
    if f.ndim == 2:
        f = f[None]
    n_frames, R, D = f.shape
    if cfar.scale_mode != "cell":
        raise ValueError("hw-compat streaming CFAR is per-cell by definition")
    stream = f.reshape(-1)
    S = stream.size
    lag = hw_stream_lag(cfar, D)
    frame_size = R * D
    cs = np.arange(3, S - lag)          # emitted CUT flat positions
    offs = np.array([dr * D + dc for dr, dc in _hw_stream_offsets(cfar)],
                    dtype=np.int64)

    n = len(cs)
    thr = np.empty(n, dtype=np.int64)
    scl = np.empty(n, dtype=np.int64)
    est_a = np.empty(n, dtype=np.int64)
    mean_a = np.empty(n, dtype=np.int64)
    # Chunked over the stream to bound the (chunk, n_ref) gather.
    chunk = max(1, (1 << 22) // max(1, cfar.n_ref))
    for lo in range(0, n, chunk):
        c = cs[lo: lo + chunk]
        idx = c[:, None] + offs[None, :]
        vals = np.where(idx >= 0, stream[np.maximum(idx, 0)], 0)
        s = vals.sum(axis=1)
        ranked = np.partition(vals, cfar.rank_idx, axis=1)[:, cfar.rank_idx]
        mean = s // cfar.n_ref          # truncating (os_cfar_2d.vhd:189)
        if scale_override != 0:
            sc = np.full(len(c), int(scale_override), dtype=np.int64)
        else:
            hi = ranked > mean + (mean >> 1)
            lo_ = ranked < (mean >> 1)
            sc = np.where(hi, cfar.scale_max,
                          np.where(lo_, cfar.scale_min, cfar.scale_nom))
        sl = slice(lo, lo + len(c))
        thr[sl] = ranked * sc
        scl[sl] = sc
        est_a[sl] = ranked
        mean_a[sl] = mean

    mag = stream[cs]
    det = mag > thr
    labels = (cs - 3) % frame_size
    if return_debug:
        return {
            "cells": cs, "labels": labels, "mag": mag,
            "threshold": thr, "scale": scl, "est": est_a, "mean": mean_a,
            "det": det, "out": np.where(det, mag, 0),
            "label_range": labels // D, "label_doppler": labels % D,
        }
    lr, ld = labels[det] // D, labels[det] % D
    return lr, ld, mag[det]


def os_cfar_1d(x: np.ndarray, ref_cells: int = 8, guard_cells: int = 2,
               rank_idx: int = 12, scaling_mult: int = 4,
               scaling_div: int = 1, edge_mode: str = "wrap") -> np.ndarray:
    """1D OS-CFAR (rtl/old/os_cfar.vhd, the lineage detector kept as the DUT
    of rtl/src/tb_os_cfar.vhd): sliding 2*(ref+guard)+1 window, ascending
    rank over the 2*ref_cells training cells, fixed threshold
    ranked * scaling_mult / scaling_div, zero-suppressed output."""
    x = np.asarray(x, dtype=np.int64)
    offs = ([-(guard_cells + i) - 1 for i in range(ref_cells)]
            + [guard_cells + i + 1 for i in range(ref_cells)])
    if edge_mode == "wrap":
        refs = np.stack([np.roll(x, -o) for o in offs])
    else:
        h = ref_cells + guard_cells
        xp = np.pad(x, (h, h), mode="reflect")
        refs = np.stack([xp[h + o: h + o + len(x)] for o in offs])
    ranked = np.sort(refs, axis=0)[rank_idx]
    threshold = (ranked * scaling_mult) // scaling_div
    return np.where(x > threshold, x, 0)


def peak_group(det_map: np.ndarray, radius: int = 1) -> np.ndarray:
    """Keep only detections that are the local maximum of the detection map
    within a (2*radius+1)^2 wrapped neighborhood; ties break toward the
    lower (range, doppler) index, so one cell per tied plateau survives."""
    m = np.asarray(det_map, dtype=np.int64)
    best = np.full_like(m, np.iinfo(np.int64).min)
    r_ids = np.arange(m.shape[0])[:, None] * m.shape[1] + np.arange(m.shape[1])
    best_id = np.zeros_like(m)
    for dr in range(-radius, radius + 1):
        for dd in range(-radius, radius + 1):
            nb = np.roll(m, (-dr, -dd), axis=(0, 1))
            nb_id = np.roll(r_ids, (-dr, -dd), axis=(0, 1))
            take = (nb > best) | ((nb == best) & (nb_id < best_id))
            best = np.where(take, nb, best)
            best_id = np.where(take, nb_id, best_id)
    keep = (m > 0) & (best == m) & (best_id == r_ids)
    return np.where(keep, m, 0)


def extract_detections(det_map: np.ndarray):
    """Zero-suppressed detection list in stream order — Doppler-fast,
    range-slow, matching the reference's coordinate counters
    (rtl/src/radar_core.vhd:396-418).  Returns (range_bin, doppler_bin, mag)
    int arrays."""
    m = np.asarray(det_map)
    r, d = np.nonzero(m)
    order = np.lexsort((d, r))
    return r[order], d[order], m[r[order], d[order]]
