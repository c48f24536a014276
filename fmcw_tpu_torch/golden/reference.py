"""Golden stimulus and fixed-point chain (pure numpy), copied from
``fmcw_tpu/golden/reference.py``.

``two_target_frame``  <- rtl/old/tb_radar_core.vhd:37-44,101-141 — targets at
range bin 100 (Doppler 5.0, amp 8000) and range bin 500 (Doppler -10.0, amp
5000), uniform noise +-20.
``process_frame_fixed`` — the fixed-point chain composed of the
``fixed_point`` stages: the oracle of the port's ``mode="fixed"``.
``doppler_eighth_tie_frames`` / ``doppler_eighth_tie_planes`` (the port's
own) — frames, or range-major planes, that put exact round-half ties on
eighth-turn Doppler bins: the stimuli that tell an exact Doppler transform
from a rounded one; ``eighth_turn_ties`` finds those ties in windowed rows.
``rank_adversarial_maps`` (the port's own) — magnitude maps of tied,
non-finite, negative and out-of-range keys for the rank-select CFAR.
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
    return process_rows_fixed(i_v, q_v, p, mti_bypass, scale_override,
                              mti_transient, window_rounding)


def process_rows_fixed(i_v: np.ndarray, q_v: np.ndarray,
                       params: RadarParams | None = None,
                       mti_bypass: bool = False, scale_override: int = 0,
                       mti_transient: str = "zero",
                       window_rounding: str = "unbiased"):
    """The slow-time half of ``process_frame_fixed`` on one range-major
    (n_range, n_doppler) pair of integer planes (the range stage's output):
    MTI, Doppler window, BFP FFT, magnitude, OS-CFAR.  Returns (mag_map,
    det_map) int64."""
    p = params or RadarParams()
    i_v, q_v = fx.mti_notch(i_v, q_v, axis=1, mode=p.notch_mode,
                            bypass=mti_bypass, transient=mti_transient)

    cd = fx.hamming_coeffs(p.n_doppler, p.coef_width)
    i_v, q_v, _ = fx.window_apply(i_v, q_v, cd[None, :], p.coef_width,
                                  rounding=window_rounding)
    i_v, q_v = fx.bfp_fft(i_v, q_v, axis=1)

    mag = fx.magnitude(i_v, q_v)
    det = fx.os_cfar_2d(mag, p.cfar, scale_override)
    return mag, det


def doppler_eighth_tie_frames(p: RadarParams, n_frames: int, seed: int = 0):
    """Frames (n_doppler, n_range) complex whose chirp s is a constant c_s
    (I only) but for its first sample x_s: range bin 0 of chirp s is then the
    integer D_s = sum of the windowed samples (below 2^15, so the range
    stage's BFP leaves it as it is: n_range <= 256), and x_s sets it to any
    integer near the constant's.  D_4, D_5 and D_7 are chosen so that, with
    the MTI bypassed, the Doppler-windowed row 0 has class sums (over chirps
    s = r mod 8) V_1 = V_5 and V_3 = V_7 (the sqrt(2)/2 terms of its
    eighth-turn bins cancel) and bin n_doppler/8's real part V_0 - V_4 is an
    exact half-LSB tie of the row's BFP scaling (exponent >= 1).  Unbiased
    window rounding; n_doppler <= 64 (at 128 the edge chirps reach too
    little: ``doppler_eighth_tie_planes``)."""
    nd, nr, cw = p.n_doppler, p.n_range, p.coef_width
    coef_r = fx.hamming_coeffs(nr, cw)
    coef_d = fx.hamming_coeffs(nd, cw)
    xs = np.arange(-32768, 32768)

    def win(x, coef):
        x = np.asarray(x, np.int64)
        return fx.window_apply(x, np.zeros_like(x),
                               np.broadcast_to(coef, x.shape), cw,
                               "unbiased")[0]

    def shift_of(w):
        z = np.fft.fft(w.astype(float))
        peak = np.maximum(np.abs(z.real), np.abs(z.imag)).max()
        return int(np.ceil(np.log2(peak / 32768.0)))

    first = win(xs, coef_r[0])                    # windowed first sample
    rng = np.random.default_rng(seed)
    frames = []
    while len(frames) < n_frames:
        cs = rng.integers(60, 200, nd)
        base = np.array([win(np.full(nr - 1, c), coef_r[1:]).sum()
                         for c in cs])
        x0 = cs.copy()
        ok = True

        def row():
            return base + first[x0 + 32768]

        def set_v(s, want):
            """x0[s] so that chirp s's windowed D_s is ``want``."""
            hit = np.flatnonzero(win(base[s] + first, coef_d[s]) == want)
            if hit.size:
                x0[s] = xs[hit[np.abs(xs[hit] - x0[s]).argmin()]]
            return hit.size > 0

        for _ in range(3):
            for src, dst in ((1, 5), (3, 7)):
                w = win(row(), coef_d)
                cls = w.reshape(-1, 8).sum(0)
                ok &= set_v(dst, int(w[dst] + cls[src] - cls[dst]))
            w = win(row(), coef_d)
            cls = w.reshape(-1, 8).sum(0)
            sh = max(1, shift_of(w))
            ok &= set_v(4, int(w[4] + (int(cls[0] - cls[4])
                                        - (1 << (sh - 1))) % (1 << sh)))
        w = win(row(), coef_d)
        cls = w.reshape(-1, 8).sum(0)
        sh = shift_of(w)
        if (ok and row().max() < 32768 and cls[1] == cls[5]
                and cls[3] == cls[7] and sh > 0
                and int(cls[0] - cls[4]) % (1 << sh) == 1 << (sh - 1)):
            z = np.repeat(cs[:, None], nr, 1)
            z[:, 0] = x0
            frames.append(z.astype(np.complex128))
    return frames


def doppler_eighth_tie_planes(seed: int, batch: int, n_range: int,
                              n_doppler: int, rounding: str = "unbiased",
                              coef_width: int = 16):
    """Range-major int16 planes (re, im), each (batch, n_range, n_doppler),
    for the slow-time stage with the MTI bypassed: small noise on a DC
    offset in I (DC is each row's Doppler peak), with the last chirps of
    classes 4 and 7 (s = n_doppler - 8 + r, where the window is small
    enough to reach every integer) chosen so that, with T_r the class sums
    of the Doppler-windowed chirps s = r (mod 8) and u_r = T_r - T_(r+4),
    u_3 = -i u_1: the sqrt(2)/2 terms of bin n_doppler/8 cancel although
    each is not 0 (u_1 comes from the noise), and its real part u_0 +
    Im u_2 is an exact half-LSB tie of the row's BFP scaling."""
    nd = n_doppler
    rng = np.random.default_rng(seed)
    x = rng.integers(-60, 60, (batch, n_range, nd, 2)) + np.array([8000, 0])
    coef = fx.hamming_coeffs(nd, coef_width)
    xs = np.arange(-32768, 32768)

    def classes(v):
        w = fx.window_apply(v, v, coef, coef_width, rounding)[0]
        return w, w.reshape(-1, 8).sum(0)

    at = {r: nd - 8 + r for r in (4, 7)}
    reach = {r: fx.window_apply(xs, xs, np.full(xs.shape, coef[at[r]]),
                                coef_width, rounding)[0] for r in at}

    def set_class(v, r, want):
        """Chirp at[r] of v so that class r sums to ``want``."""
        w, t = classes(v)
        ok = np.flatnonzero(reach[r] == want - (t[r] - w[at[r]]))
        v[at[r]] = xs[ok[np.abs(xs[ok] - v[at[r]]).argmin()]]

    for b in range(batch):
        for r in range(n_range):
            vi, vq = x[b, r, :, 0], x[b, r, :, 1]
            (_, ti), (_, tq) = classes(vi), classes(vq)
            set_class(vi, 7, ti[3] - (tq[1] - tq[5]))     # u3 = -i u1
            set_class(vq, 7, tq[3] + (ti[1] - ti[5]))
            for _ in range(3):
                (wi, ti), (_, tq) = classes(vi), classes(vq)
                er = int(ti[0] - ti[4] + tq[2] - tq[6])
                s = max(1, int(wi.sum() - 1).bit_length() - 15)
                set_class(vi, 4, int(ti[4]) + (er - (1 << (s - 1))) % (1 << s))
    return x[..., 0].astype(np.int16), x[..., 1].astype(np.int16)


def eighth_turn_ties(i_w: np.ndarray, q_w: np.ndarray):
    """Which Doppler-windowed int rows (..., n_doppler) hold an eighth-turn
    tie, from exact integer class sums: with T_r the sums of chirps s = r
    (mod 8) and u_r = T_r - T_(r+4), bin k = m n_doppler/8 (m odd) is E +
    cos(pi/4) P, E = u_0 + (-i)^m u_2 and P = u_1 W^m + u_3 W^3m (W = W_8 /
    cos(pi/4)); a part of it ties where its P is 0 and its E is an exact
    half-LSB tie of the row's BFP scaling (exponent >= 1).  Returns boolean
    arrays (...,): ``tie``, and ``live`` (a tie whose sqrt(2)/2 terms are
    not 0 each: u_1 != 0)."""
    nd = i_w.shape[-1]
    t = [np.asarray(v, np.int64).reshape(*v.shape[:-1], nd // 8, 8).sum(-2)
         for v in (i_w, q_w)]
    u = [(t[0][..., r] - t[0][..., r + 4], t[1][..., r] - t[1][..., r + 4])
         for r in range(4)]
    z = np.fft.fft(i_w + 1j * q_w, axis=-1)
    peak = np.maximum(np.abs(z.real), np.abs(z.imag)).max(-1)
    s = np.maximum(np.ceil(np.log2(np.maximum(peak, 1) / 32768)), 0)
    s = s.astype(np.int64)
    half = np.where(s > 0, 1 << np.maximum(s - 1, 0), -1)

    def w8(k):
        return (1 if k % 8 in (1, 7) else -1), (1 if k % 8 in (5, 7) else -1)

    tie = np.zeros(s.shape, bool)
    for m in (1, 3, 5, 7):
        (a1, b1), (a3, b3) = w8(m), w8(3 * m)
        g = 1 if m % 4 == 1 else -1
        pr = a1 * u[1][0] - b1 * u[1][1] + a3 * u[3][0] - b3 * u[3][1]
        pi = a1 * u[1][1] + b1 * u[1][0] + a3 * u[3][1] + b3 * u[3][0]
        for e, pp in ((u[0][0] + g * u[2][1], pr),
                      (u[0][1] - g * u[2][0], pi)):
            tie |= (pp == 0) & (e % (1 << s) == half)
    return tie, tie & ((u[1][0] != 0) | (u[1][1] != 0))


def rank_adversarial_maps(shape, integer: bool, seed: int = 0) -> np.ndarray:
    """Magnitude maps (float32, or int32 with ``integer``) of the given
    (..., R, D) shape whose keys stress a rank select's compares: seeded
    exponential noise, then plateaus of one value (every training value of
    a window tied, and two-valued plateaus: ties at the k-th value), and
    scattered special keys — floats: NaN (both signs), +-Inf, -0.0,
    negative values, denormals and the largest finite value; integers:
    values at and above 2^16 (up to 2^31 - 1), negative ones (down to
    -2^31) and zeros."""
    rng = np.random.default_rng(seed)
    *lead, R, D = shape
    m = rng.exponential(1000.0, shape)
    flat = m.reshape(-1, R, D)
    hr, hd = min(16, R), min(16, D)
    for f in flat:
        # A plateau of one value, and one of two values half and half.
        r0, d0 = rng.integers(0, R - hr + 1), rng.integers(0, D - hd + 1)
        f[r0:r0 + hr, d0:d0 + hd] = 2500.0
        r1, d1 = rng.integers(0, R - hr + 1), rng.integers(0, D - hd + 1)
        f[r1:r1 + hr, d1:d1 + hd] = np.where(
            rng.random((hr, hd)) < 0.5, 3000.0, 3001.0)
    if integer:
        out = np.round(m).astype(np.int64)
        specials = np.array([65535, 65536, 70000, 2 ** 20, 2 ** 31 - 1, -1,
                             -70000, -2 ** 31, 0], dtype=np.int64)
        pick = rng.random(shape) < 0.08
        out[pick] = rng.choice(specials, int(pick.sum()))
        return out.astype(np.int32)
    out = m.astype(np.float32)
    bits = np.array([0x7FC00000, 0xFFC00000, 0x7F800000, 0xFF800000,
                     0x80000000, 0xC47A0000, 0x00000400, 0x007FFFFF,
                     0x7F7FFFFF], dtype=np.uint32)
    pick = rng.random(shape) < 0.08
    out[pick] = rng.choice(bits, int(pick.sum())).view(np.float32)
    return out
