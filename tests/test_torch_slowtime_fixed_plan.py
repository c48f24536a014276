"""A numpy model of the fixed slow-time kernel's plan
(fmcw_tpu_torch/csrc/slowtime_detect_fixed.cu and csrc/cfar_tile.cuh on an
int32 tile), held bit for bit against the JAX package's golden model, the
port's plain twins and JAX's fused fixed kernel on the CPU.

The kernel runs only on the card; its arithmetic and order are modelled
here step by step:

* the chain of a range row (``slowtime_row``): the saturating MTI in
  integers (x[s] - x[s-1], or x[s] - 2 x[s-1] + x[s-2], clipped to int16,
  missing history 0, the first notch - 1 outputs zeroed for transient
  "zero"), the Q15 window from the kernel's table (``ops/frontend_fixed.
  _tables``), saturations counted per row, I and Q apart; L = min(32, nd)
  lanes, P = nd / L chirps a lane (chirp s = l P + p); conversion to
  float64; an L-point radix-2 DIF across the lanes (stage h = L/2 .. 1:
  the lower lane of a pair takes a + b, the upper (b - a) W_2h^(l mod h)
  from the table at (l mod h) nd / 2h); the twiddle W_nd^(p k1) (k1 =
  bit_reverse(l)) and a P-point transform;
* the eighth-turn bins k = m nd/8 (m odd), recomputed on the lanes that
  hold them (k1 mod nd/4 = nd/8) from exact integers: at P >= 2 the lane's
  own DIF outputs before the twiddle (asserted integer-valued), at P = 1
  the class sums of the windowed chirps; E + RN(c P) with c the source's
  constant kC8;
* the BFP exponent from the bits of the row's peak, round half to even and
  clip, the magnitude max + (min >> 2) + (min >> 3);
* the decision on a tile (``decide_tile`` with ``fmcw::IntInFloat``: the
  integer magnitudes held in float32, asserted exact): tiles of T = 64 rows
  with H halo rows each side (``ops/frontend._kernel_halo``); the T + 2 pgr
  decided rows in strips of 8 cells (the last strip overlapping its
  neighbour); full and guard column sums once per tile, in float32 from
  -0 (asserted below 2^24); each cell's box sums over its columns in int;
  the floor mean, t_hi = mean + (mean >> 1), t_lo = mean >> 1 converted to
  float32; hi and lo counted in float32, packed as hi 4096 + lo; q =
  ceil(cut / scale) in float32 and the detection count; then the grouping
  of the tile's rows with global row ids.  Block scale takes the twin's
  ``block_scale_map`` (the kernel's ``block_scale_tile`` is shared code
  the kernels have used since the port began).

Arithmetic: numpy float64 in the kernel's order, its fused multiply-adds
rounded once (``_fma``: an exact product and a round-to-odd sum, checked
against exact rationals), so the model's spectrum is the card's bit for
bit.  The fused products are what leave a residue at an eighth-turn bin
whose sqrt(2)/2 terms should cancel (fma(y, c, -RN(c y)) is the rounding
error of c y, not 0); the model without the exact bins shows it (the
mutation check).  The model is held to the golden chain and the twins bit for bit
(magnitudes, saturation counts, decisions, row maxima, counts), on the
golden frames, saturating frames, quarter-turn and eighth-turn half-LSB
ties and integer maps whose training values equal t_hi, t_lo and q; to
JAX's fused fixed kernel (interpret mode; float32 transforms) on its own
contract (tests/test_torch_fixed.py: detections, counts and saturation
exact, magnitudes within 8 LSB).
"""

import dataclasses
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import fmcw_tpu
import fmcw_tpu_torch
from fmcw_tpu.golden import fixed_point as jfx, reference as jref
from fmcw_tpu.models import pipeline as jpl
from fmcw_tpu.ops import cfar as JC
from fmcw_tpu_torch.golden import reference as tref
from fmcw_tpu_torch.models import pipeline as tpl
from fmcw_tpu_torch.ops import cfar as C, fft as TF, frontend as F
from fmcw_tpu_torch.ops import frontend_fixed as FX
from fmcw_tpu_torch.ops import split_frontend as SF
from fmcw_tpu_torch.ops.window import window_rounding_constant

# Share the CPU with the other test workers (the suite runs 6 at once).
torch.set_num_threads(2)

SRC = (Path(__file__).resolve().parents[1] / "fmcw_tpu_torch" / "csrc"
       / "slowtime_detect_fixed.cu").read_text()
CW = 16
STRIP = 8
F32 = np.float32
LSB = 8          # magnitudes against JAX's float32 fused kernel
NDS = (16, 32, 64, 128)


def _kc8():
    """The source's cos(pi/4), parsed from its hex literal."""
    m = re.search(r"constexpr double kC8 = (\S+);", SRC)
    return float.fromhex(m.group(1))


def _brev(x, bits):
    return np.array([int(format(int(v), f"0{bits}b")[::-1], 2) for v in x])


def _plan(nd):
    L = min(32, nd)
    return L, nd // L, L.bit_length() - 1


# ---------------------------------------------------------------------------
# The chain of a range row
# ---------------------------------------------------------------------------

def _shift(x, n):
    out = np.zeros_like(x)
    out[..., n:] = x[..., :x.shape[-1] - n]
    return out


def _two_sum(a, b):
    """a + b = s + e exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """a b = p + e exactly (Dekker's split)."""
    p = a * b

    def split(x):
        c = 134217729.0 * x                       # 2^27 + 1
        hi = c - (c - x)
        return hi, x - hi
    ah, al = split(a)
    bh, bl = split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _fma(a, b, c):
    """RN(a b + c) in float64, rounded once as the card's FMA: the exact
    product, then the three-term sum rounded once through a round-to-odd
    step (Boldo and Melquiond, 2008)."""
    a, b, c = np.broadcast_arrays(*(np.asarray(v, np.float64)
                                    for v in (a, b, c)))
    p, e = _two_prod(a, b)
    uh, ul = _two_sum(e, c)
    th, tl = _two_sum(p, uh)
    v, err = _two_sum(tl, ul)
    even = (v.view(np.int64) & 1) == 0
    v = np.where((err != 0) & even,
                 np.nextafter(v, np.where(err > 0, np.inf, -np.inf)), v)
    return th + v


def _cmul(a, b, wr, wi):
    """(a + i b)(wr + i wi) as the kernel's cmul: fma(a, wr, -(b wi)),
    fma(a, wi, b wr)."""
    return _fma(a, wr, -(b * wi)), _fma(a, wi, b * wr)


def _w8(k):
    """W_8^k / cos(pi/4) = a + i b for k odd."""
    return (1 if k % 8 in (1, 7) else -1), (1 if k % 8 in (5, 7) else -1)


def _eighth_bin(u, m):
    """The kernel's eighth_bin: u = (u0r, u0i, u1r, u1i, u2r, u2i, u3r,
    u3i) int arrays, m odd -> (xr, xi) float64."""
    (a1, b1), (a3, b3) = _w8(m), _w8(3 * m)
    g = 1 if m % 4 == 1 else -1
    pr = a1 * u[2] - b1 * u[3] + (a3 * u[6] - b3 * u[7])
    pi = a1 * u[3] + b1 * u[2] + (a3 * u[7] + b3 * u[6])
    er = u[0] + g * u[5]
    ei = u[1] - g * u[4]
    c = _kc8()
    return (er.astype(np.float64) + c * pr.astype(np.float64),
            ei.astype(np.float64) + c * pi.astype(np.float64))


def _bfp_scale(peak):
    """fmcw::bfp_scale: 2^-s from the bits of max(peak, 1)."""
    bits = np.maximum(peak, 1.0).view(np.int64)
    cl2 = (bits >> 52) - 1023 + ((bits & ((1 << 52) - 1)) != 0)
    return (((1023 - np.maximum(cl2 - 15, 0)) << 52)).view(np.float64)


def _windowed(re, im, notch, transient, bypass, rounding):
    """Step 1 on int16 rows (..., nd): the saturating MTI and the Q15
    window in integers; ([I, Q] int64, saturations per row)."""
    win = FX._tables(re.shape[-1], CW, "cpu")[0].numpy().astype(np.int64)
    rnd = window_rounding_constant(CW, rounding)
    x = [re.astype(np.int64), im.astype(np.int64)]
    if not bypass:
        for i, v in enumerate(x):
            y = (v - _shift(v, 1) if notch == 2
                 else v - 2 * _shift(v, 1) + _shift(v, 2))
            y = np.clip(y, -32768, 32767)
            if transient == "zero":
                y[..., :notch - 1] = 0
            x[i] = y
    sat = np.zeros(re.shape[:-1], np.int64)
    for i, v in enumerate(x):
        w = (v * win + rnd) >> (CW - 2)
        sat += ((w > 32767) | (w < -32768)).sum(-1)
        x[i] = np.clip(w, -32768, 32767)
    return x, sat


def kernel_rows(re, im, notch=2, transient="zero", bypass=False,
                rounding="unbiased", exact=True):
    """The kernel's chain on every row of int16 planes (..., nd): (mag
    int64 (..., nd), Doppler-window saturations per row, the spectrum
    (xr, xi) before quantization).  ``exact=False``: without the exact
    eighth-turn bins (the mutation check)."""
    nd = re.shape[-1]
    L, P, lg = _plan(nd)
    tw = FX._tables(nd, CW, "cpu")[1].numpy()
    x, sat = _windowed(re, im, notch, transient, bypass, rounding)
    lane = np.arange(L)
    k1 = _brev(lane, lg)
    eighth = np.flatnonzero(k1 % (nd // 4) == nd // 8)
    if P == 1:
        # Class sums T_r (r = l mod 8) over the lane group; u_r = T_r -
        # T_(r+4), gathered from lanes 0..3.
        t = [v.reshape(*v.shape[:-1], nd // 8, 8).sum(-2) for v in x]
        u1 = [t[j][..., r] - t[j][..., r + 4] for r in range(4)
              for j in (0, 1)]
    xr = x[0].astype(np.float64).reshape(*re.shape[:-1], L, P)
    xi = x[1].astype(np.float64).reshape(*re.shape[:-1], L, P)
    for st in range(lg):
        h = L >> (st + 1)
        partner = lane ^ h
        br, bi = xr[..., partner, :], xi[..., partner, :]
        upper = ((lane & h) != 0)[:, None]
        j = (lane & (h - 1)) * (nd // (2 * h))
        ur, ui = _cmul(br - xr, bi - xi, tw[j, 0][:, None], tw[j, 1][:, None])
        xr = np.where(upper, ur, xr + br)
        xi = np.where(upper, ui, xi + bi)
    if P >= 2:
        y = np.stack([xr[..., eighth, :], xi[..., eighth, :]])
        assert np.array_equal(y, np.round(y)), "eighth-turn lanes inexact"
        y = y.astype(np.int64)
    for p in range(1, P):
        xr[..., p], xi[..., p] = _cmul(xr[..., p], xi[..., p],
                                       tw[p * k1, 0], tw[p * k1, 1])
    v = [(xr[..., p], xi[..., p]) for p in range(P)]
    if P == 1:
        bins = v
    elif P == 2:
        bins = [(v[0][0] + v[1][0], v[0][1] + v[1][1]),
                (v[0][0] - v[1][0], v[0][1] - v[1][1])]
    else:
        s0 = (v[0][0] + v[2][0], v[0][1] + v[2][1])
        d0 = (v[0][0] - v[2][0], v[0][1] - v[2][1])
        s1 = (v[1][0] + v[3][0], v[1][1] + v[3][1])
        d1 = (v[1][0] - v[3][0], v[1][1] - v[3][1])
        bins = [(s0[0] + s1[0], s0[1] + s1[1]),
                (d0[0] + d1[1], d0[1] - d1[0]),
                (s0[0] - s1[0], s0[1] - s1[1]),
                (d0[0] - d1[1], d0[1] + d1[0])]
    out_r = np.zeros(re.shape, np.float64)
    out_i = np.zeros(re.shape, np.float64)
    for k2, (b_r, b_i) in enumerate(bins):
        out_r[..., k1 + L * k2] = b_r
        out_i[..., k1 + L * k2] = b_i
    if exact:
        zero = np.zeros(re.shape[:-1], np.int64)
        for n, l in enumerate(eighth):
            if P == 1:
                u = u1
            else:
                u = [y[j, ..., n, p] for p in range(P) for j in (0, 1)]
                u += [zero] * (8 - len(u))
            for k2 in range(P):
                k = k1[l] + L * k2
                out_r[..., k], out_i[..., k] = _eighth_bin(u, k // (nd // 8))
    peak = np.maximum(np.abs(out_r), np.abs(out_i)).max(-1, keepdims=True)
    scale = _bfp_scale(peak)
    qr = np.abs(np.clip(np.rint(out_r * scale), -32768, 32767)).astype(int)
    qi = np.abs(np.clip(np.rint(out_i * scale), -32768, 32767)).astype(int)
    mx, mn = np.maximum(qr, qi), np.minimum(qr, qi)
    return mx + (mn >> 2) + (mn >> 3), sat, (out_r, out_i), x


def _exact_quarter_bins(x):
    """X[m nd/4], m < 4, of windowed integer rows (I, Q), exactly in
    integers: sum_s x[s] (-i)^(s m)."""
    nd = x[0].shape[-1]
    s = np.arange(nd)
    out = []
    for m in range(4):
        ph = [(1, 0), (0, -1), (-1, 0), (0, 1)]
        c = np.array([ph[(k * m) % 4][0] for k in s])
        d = np.array([ph[(k * m) % 4][1] for k in s])
        out.append(((x[0] * c - x[1] * d).sum(-1),
                    (x[0] * d + x[1] * c).sum(-1)))
    return out


def golden_rows(re, im, notch, transient, bypass, rounding):
    """The JAX package's golden slow-time stages on range-major rows
    (..., nd): mti_notch, window_apply (saturations counted per plane, as
    the port counts them), bfp_fft, magnitude."""
    nd = re.shape[-1]
    i_v, q_v = jfx.mti_notch(re.astype(np.int64), im.astype(np.int64),
                             axis=-1, mode=notch, bypass=bypass,
                             transient=transient)
    coef = jfx.hamming_coeffs(nd, CW)
    i_w, q_w, _ = jfx.window_apply(i_v, q_v, coef, CW, rounding)
    zero = np.zeros_like(i_v)
    sat = sum(jfx.window_apply(v, zero, coef, CW, rounding)[2].sum(-1)
              for v in (i_v, q_v))
    yr, yi = jfx.bfp_fft(i_w, q_w, axis=-1)
    return jfx.magnitude(yr, yi), sat


# ---------------------------------------------------------------------------
# Stimuli: range-major int16 planes (B, R, nd)
# ---------------------------------------------------------------------------

def _hot(z):
    """A frame x 40, each component clipped to int16: the window
    saturates."""
    return (np.clip(z.real * 40, -32768, 32767)
            + 1j * np.clip(z.imag * 40, -32768, 32767))


def _frame_planes(nd, rng, nr=64, hot=False):
    """The golden range stage of golden two-target frames (x 40, clipped,
    when ``hot``): the slow-time kernel's input."""
    p = fmcw_tpu_torch.RadarParams(n_range=nr, n_doppler=nd)
    seed = int(rng.integers(100))
    out = []
    for b in range(2):
        z = np.asarray(tref.two_target_frame(p, seed=seed + b))
        if hot:
            z = _hot(z)
        i_w, q_w, _ = jfx.window_apply(
            z.real.astype(np.int64), z.imag.astype(np.int64),
            jfx.hamming_coeffs(nr, CW)[None, :], CW, "unbiased")
        r, i = jfx.bfp_fft(i_w, q_w, axis=1)
        out.append((r.T, i.T))
    return (np.stack([o[0] for o in out]).astype(np.int16),
            np.stack([o[1] for o in out]).astype(np.int16))


def _quarter_ties(nd, rng, notch, transient, bypass, rounding, rows=16):
    """Rows whose quarter-turn peak bin is an exact half-LSB tie of the BFP
    rounding: a DC offset in I with the MTI bypassed (bin 0), else an
    alternating chirp pattern that the canceller passes (bin nd/2), plus
    noise; the central chirp chosen (over a few thousand candidates) so
    that the bin's real part X satisfies X mod 2^s = 2^(s - 1)."""
    s_idx = np.arange(nd)
    k = 0 if bypass else nd // 2
    amp = 8000 if bypass else (6000 if notch == 2 else 3000)
    sign = np.ones(nd) if bypass else (-1.0) ** s_idx
    re = (amp * sign + rng.integers(-300, 300, (rows, nd))).astype(np.int64)
    im = rng.integers(-300, 300, (rows, nd)).astype(np.int64)
    j = nd // 2
    ph = np.where((s_idx * k) % nd == 0, 1, -1)
    for r in range(rows):
        cand = np.clip(re[r, j] + np.arange(-1500, 1501), -32768, 32767)
        rows_c = np.repeat(re[r][None], cand.size, 0)
        rows_c[:, j] = cand
        (wi, wq), _ = _windowed(rows_c, np.repeat(im[r][None], cand.size, 0),
                                notch, transient, bypass, rounding)
        x = (wi * ph).sum(-1)
        z = np.fft.fft(wi + 1j * wq, axis=-1)
        peak = np.maximum(np.abs(z.real), np.abs(z.imag)).max(-1)
        s = np.maximum(np.ceil(np.log2(np.maximum(peak, 1) / 32768)), 0)
        s = s.astype(np.int64)
        ok = np.flatnonzero((s > 0) & (x % (1 << s) == 1 << np.maximum(s - 1,
                                                                      0)))
        if ok.size:
            re[r, j] = cand[ok[np.abs(ok - 1500).argmin()]]
    return re.astype(np.int16)[None], im.astype(np.int16)[None]


def _count_quarter_ties(x):
    """Half-LSB ties at the quarter-turn bins of windowed rows x = (I, Q)."""
    z = np.fft.fft(x[0] + 1j * x[1], axis=-1)
    peak = np.maximum(np.abs(z.real), np.abs(z.imag)).max(-1)
    s = np.maximum(np.ceil(np.log2(np.maximum(peak, 1) / 32768)), 0)
    s = s.astype(np.int64)
    half = np.where(s > 0, 1 << np.maximum(s - 1, 0), -1)
    return sum(int(((s > 0) & (v % (1 << s) == half)).sum())
               for pair in _exact_quarter_bins(x) for v in pair)


def _check_rows(re, im, notch, transient, bypass, rounding):
    """The model's magnitudes and saturation counts equal the golden
    chain's and the twin's; its quarter-turn bins are the exact integers.
    Returns the windowed rows."""
    mag, sat, (xr, xi), x = kernel_rows(re, im, notch, transient, bypass,
                                        rounding)
    g_mag, g_sat = golden_rows(re, im, notch, transient, bypass, rounding)
    assert np.array_equal(mag, g_mag), (notch, transient, bypass, rounding)
    t_mag, t_sat = FX.slowtime_mag_fixed_plain(
        torch.as_tensor(re), torch.as_tensor(im), bypass, notch, transient,
        CW, rounding)
    assert np.array_equal(mag, t_mag.numpy())
    assert np.array_equal(sat.sum(-1), t_sat.numpy())
    assert np.array_equal(sat, g_sat)
    nd = re.shape[-1]
    for m, (er, ei) in enumerate(_exact_quarter_bins(x)):
        assert np.array_equal(xr[..., m * nd // 4], er)
        assert np.array_equal(xi[..., m * nd // 4], ei)
    return x


OPTIONS = [(notch, transient, bypass, rounding)
           for notch in (2, 3) for transient in ("zero", "passthrough")
           for bypass in (False, True) for rounding in ("unbiased", "biased")]


@pytest.mark.parametrize("nd", NDS)
@pytest.mark.parametrize("stimulus", ["frame", "hot"])
def test_row_model_equals_golden_and_twin(nd, stimulus):
    """Golden two-target frames and their saturating x40 copies through the
    golden range stage, every MTI and window option: the model's
    magnitudes and saturation counts equal the golden chain's and the
    plain twin's bit for bit; its quarter-turn bins are exact integers."""
    rng = np.random.default_rng(nd)
    re, im = _frame_planes(nd, rng, hot=stimulus == "hot")
    sats = 0
    for opts in OPTIONS:
        _check_rows(re, im, *opts)
        sats += int(kernel_rows(re, im, *opts)[1].sum())
    if stimulus == "hot":
        assert sats > 0


@pytest.mark.parametrize("nd", NDS)
def test_row_model_on_quarter_turn_ties(nd):
    """Rows whose quarter-turn peak bin (DC bypassed, nd/2 through the
    canceller) is an exact half-LSB tie: the model equals the golden
    chain and the twin (the tie rounds half to even the same way)."""
    rng = np.random.default_rng(100 + nd)
    for notch, transient, bypass, rounding in (
            (2, "zero", True, "unbiased"), (2, "zero", False, "unbiased"),
            (3, "passthrough", False, "biased"),
            (3, "zero", True, "biased")):
        re, im = _quarter_ties(nd, rng, notch, transient, bypass, rounding)
        x = _check_rows(re, im, notch, transient, bypass, rounding)
        assert _count_quarter_ties(x) >= 12


@pytest.mark.parametrize("nd", NDS)
def test_row_model_on_eighth_turn_ties(nd):
    """Rows whose bin nd/8 has sqrt(2)/2 terms that cancel without being
    0 each and is an exact half-LSB tie (``golden.reference.
    doppler_eighth_tie_planes``, MTI bypassed), both roundings: the model
    equals the golden chain and the twin."""
    for rounding in ("unbiased", "biased"):
        re, im = tref.doppler_eighth_tie_planes(nd, 1, 32, nd, rounding)
        x = _check_rows(re, im, 2, "zero", True, rounding)
        assert tref.eighth_turn_ties(*x)[1].all()


def test_mutation_without_exact_eighth_bins_misses_ties():
    """The mutation check: the model without the exact eighth-turn bins
    misses ties of ``doppler_eighth_tie_planes`` (128 rows each) that the
    golden chain rounds the other way, at nd 16, 32 and 128, where the tie
    bin sums fused products (the DIF's W_8 twiddles; u_1 W_8 and u_3 W_8^3)
    whose rounding residues need not cancel.  At nd = 64 it misses none:
    there the bin is Y_0 + W_8^m Y_1 with Y_1 = u_1 -+ i u_3, which is 0
    whenever the bin's sqrt(2)/2 terms cancel, and a product with 0 is
    exact."""
    missed = {}
    for nd in NDS:
        re, im = tref.doppler_eighth_tie_planes(nd, 1, 128, nd)
        g_mag, _ = golden_rows(re, im, 2, "zero", True, "unbiased")
        got, _, _, _ = kernel_rows(re, im, 2, "zero", True)
        mut, _, _, _ = kernel_rows(re, im, 2, "zero", True, exact=False)
        assert np.array_equal(got, g_mag)
        missed[nd] = int((mut != g_mag).any(-1).sum())
    assert min(missed[16], missed[32], missed[128]) > 0, missed
    assert missed[64] == 0, missed


@pytest.mark.parametrize("nd", (16, 32, 64))
def test_chirp_axis_eighth_tie_frames(nd):
    """The chirp-axis eighth-turn tie frames (``golden.reference.
    doppler_eighth_tie_frames``, those of tests/test_torch_fixed.py)
    through the golden range stage and the model, MTI
    bypassed: magnitudes and decisions equal JAX's golden
    ``process_frame_fixed``.  (Their sqrt(2)/2 terms are 0 each, u_1 = u_3
    = 0, which the transform computes exactly with or without the exact
    bins; the dense product does not: tests/test_torch_fixed.py.)"""
    p = fmcw_tpu_torch.RadarParams(n_range=64, n_doppler=nd)
    jp = fmcw_tpu.RadarParams(n_range=64, n_doppler=nd)
    for z in tref.doppler_eighth_tie_frames(p, 6, seed=nd):
        mag, det = jref.process_frame_fixed(z, jp, mti_bypass=True)
        i_w, q_w, _ = jfx.window_apply(
            z.real.astype(np.int64), z.imag.astype(np.int64),
            jfx.hamming_coeffs(64, CW)[None, :], CW, "unbiased")
        r, i = (v.T for v in jfx.bfp_fft(i_w, q_w, axis=1))
        got, _, _, _ = kernel_rows(r[None], i[None], bypass=True)
        assert np.array_equal(got[0], mag)
        d, _, _ = kernel_decide(got, p.cfar, 0, 0)
        assert np.array_equal(d[0], det)


def test_source_constants_and_quarter_turn_paths():
    """kC8 is ops/fft.twiddles64(8)[1].real; the kernel's tables are the
    Q15 window and twiddles64(nd).  Every twiddle on the path of a lane
    that holds a quarter-turn bin (k1 = k mod L a multiple of L/4: the DIF
    stages where it is the upper lane, then W_nd^(p k1)) is exactly 1, -1,
    i or -i, and the P-point transform multiplies by those only; every
    eighth-turn bin lies on a lane whose DIF path is such a path (P >= 2)
    or on lanes 4..7 (P = 1, whose bins come from the class sums)."""
    assert _kc8() == TF.twiddles64(8)[1].real
    exact = {(1.0, 0.0), (0.0, -1.0), (-1.0, 0.0), (0.0, 1.0)}
    for nd in NDS:
        win, tw = (x.numpy() for x in FX._tables(nd, CW, "cpu"))
        assert np.array_equal(tw[:, 0] + 1j * tw[:, 1], TF.twiddles64(nd))
        assert np.array_equal(win, jfx.hamming_coeffs(nd, CW))
        L, P, lg = _plan(nd)
        k1 = _brev(np.arange(L), lg)
        for k in range(0, nd, nd // 4):
            lanes = np.flatnonzero(k1 == k % L)
            assert lanes.size == 1 and lanes[0] < 4
            l = int(lanes[0])
            for st in range(lg):
                h = L >> (st + 1)
                if l & h:
                    j = (l & (h - 1)) * (nd // (2 * h))
                    assert (tw[j, 0], tw[j, 1]) in exact
            for p in range(P):
                assert (tw[p * (k % L), 0], tw[p * (k % L), 1]) in exact
        for m in (1, 3, 5, 7):
            l = int(np.flatnonzero(k1 == (m * nd // 8) % L)[0])
            assert l < 4 if P >= 2 else 4 <= l < 8


# ---------------------------------------------------------------------------
# The decision on an int32 tile
# ---------------------------------------------------------------------------

def kernel_decide(mag, cfar, so, pgr, tile=F.TILE_ROWS):
    """The kernel's decision, grouping and counts of (B, R, D) integer
    magnitudes: (det, row_max, n_dets), int64."""
    assert cfar.n_ref <= F.MAX_PACKED_REFS
    mag = mag.astype(np.int64)
    B, R, D = mag.shape
    T = min(tile, R)
    H = F._kernel_halo(cfar, pgr)
    E, rows = T + 2 * H, T + 2 * pgr
    hr, hd, gr, gd = (cfar.halo_range, cfar.halo_doppler, cfar.guard_range,
                      cfar.guard_doppler)
    k = cfar.n_ref - cfar.rank_idx
    block = (C.block_scale_map(torch.as_tensor(mag), cfar).numpy()
             if cfar.scale_mode == "block" and not so else None)
    strips = sorted({min(st * STRIP, rows - STRIP)
                     for st in range(-(-rows // STRIP))})
    cols = np.arange(D)
    det = np.zeros_like(mag)
    for r0 in range(0, R, T):
        m = mag[:, (r0 - H + np.arange(E)) % R]           # the tile
        e_first = H - pgr
        # The tile in float (IntInFloat): exact below 2^24.
        mf = m.astype(F32)
        assert np.array_equal(mf.astype(np.int64), m)
        ef = np.full((B, rows, D), -0.0, F32)            # column sums
        eg = np.full((B, rows, D), -0.0, F32)
        for dr in range(2 * hr + 1):
            v = mf[:, e_first - hr + dr:e_first - hr + dr + rows]
            ef = ef + v
            if abs(dr - hr) <= gr:
                eg = eg + v
        assert ef.max() < 2 ** 24
        det_t = np.zeros((B, rows, D), np.int64)
        for i0 in strips:
            e0 = e_first + i0
            cut = m[:, e0:e0 + STRIP]                     # (B, S, D)

            def walk(visit):
                for dd in range(-hd, hd + 1):
                    for dr in range(2 * hr + 1):
                        if abs(dd) <= gd and abs(dr - hr) <= gr:
                            continue
                        visit(mf[:, e0 - hr + dr:e0 - hr + dr + STRIP]
                              [..., (cols + dd) % D])
            if so:
                sc = np.full(cut.shape, so, np.int64)
            elif block is not None:
                sc = block[:, (r0 - pgr + i0 + np.arange(STRIP)) % R]
            else:
                # Box sums in int from the column sums; the thresholds in
                # the integer semantics, then in float.
                full = sum(ef[:, i0:i0 + STRIP][..., (cols + j) % D]
                           .astype(np.int64) for j in range(-hd, hd + 1))
                guard = sum(eg[:, i0:i0 + STRIP][..., (cols + j) % D]
                            .astype(np.int64) for j in range(-gd, gd + 1))
                mean = (full - guard) // cfar.n_ref            # floor_div
                t_hi = (mean + (mean >> 1)).astype(F32)
                t_lo = (mean >> 1).astype(F32)
                hl = np.zeros(cut.shape, F32)

                def count_hl(v):
                    nonlocal hl
                    hl = (hl + np.where(v > t_hi, F32(4096), F32(0))
                          + (v >= t_lo).astype(F32))
                walk(count_hl)
                hl = hl.astype(np.int64)
                hi, lo = hl >> 12, hl & 4095
                sc = np.where(hi >= k, cfar.scale_max,
                              np.where(lo < k, cfar.scale_min,
                                       cfar.scale_nom))
            q = ((cut - 1) // sc + 1).astype(F32)            # ceil
            cnt = np.zeros(cut.shape, F32)

            def count(v):
                nonlocal cnt
                cnt = cnt + (v >= q).astype(F32)
            walk(count)
            det_t[:, i0:i0 + STRIP] = np.where((cnt < k) & (cut > 0), cut, 0)
        # Grouping of the tile's T rows (det_t row t + pgr), global ids.
        own = det_t[:, pgr:pgr + T]
        keep = own > 0
        rid = (r0 + np.arange(T))[:, None]
        ids = rid * D + cols
        for dr in range(-pgr, pgr + 1):
            for dd in range(-pgr, pgr + 1):
                if dr == 0 and dd == 0:
                    continue
                v = det_t[:, pgr + dr:pgr + dr + T][..., (cols + dd) % D]
                nid = ((rid + dr) % R) * D + (cols + dd) % D
                keep &= ~((v > own) | ((v == own) & (nid < ids)))
        det[:, r0:r0 + T] = np.where(keep, own, 0)
    return det, det.max(-1), (det > 0).sum((-2, -1))


INT_VALUES = np.array([0, 1, 2, 3, 4, 5, 6, 8, 10, 12, 16])


def int_tie_map(rng, B, R, D):
    """Small integers and a few targets (64, 128, 45056): floor means,
    t_hi, t_lo and ceil(cut / 4) often equal a training value."""
    m = rng.choice(INT_VALUES, size=(B, R, D), p=np.linspace(2, 1, 11) / 16.5)
    n = max(2, R * D // 512)
    m[rng.integers(0, B, n), rng.integers(0, R, n),
      rng.integers(0, D, n)] = rng.choice([64, 128, 45056], n)
    return m.astype(np.int64)


def _int_ties(mag, cfar):
    """Training values equal to their cell's t_hi or t_lo, and to
    ceil(cut / 4)."""
    m = torch.as_tensor(mag)
    hr, hd = cfar.halo_range, cfar.halo_doppler
    pad = C._wrap_pad(m, hr, hd)
    t_hi, t_lo = C.percell_thresholds(pad, cfar)
    q = (m - 1) // 4 + 1
    R, D = m.shape[-2:]
    n = np.zeros(3, int)
    from fmcw_tpu_torch.golden.fixed_point import _window_offsets
    for dr, dd in _window_offsets(cfar):
        v = pad[..., hr + dr:hr + dr + R, hd + dd:hd + dd + D]
        n += [int((v == t).sum()) for t in (t_hi, t_lo, q)]
    return n


@pytest.mark.parametrize("mode", ["cell", "block"])
@pytest.mark.parametrize("so", [0, 4])
@pytest.mark.parametrize("pgr", [0, 1, 2])
def test_decision_model_bitwise_on_int_ties(mode, so, pgr):
    """At 256x64 (the entry's CFAR, four tiles) the model equals the plain
    integer CFAR and grouping (``detect_plain``: det, row maxima, counts)
    and JAX's XLA cfar_2d(integer=True) + peak_group bit for bit on an
    integer map whose training values meet t_hi, t_lo and q, with targets
    at the largest magnitude the chain makes (45,056)."""
    p = fmcw_tpu_torch.RadarParams(n_range=256, n_doppler=64)
    jp = fmcw_tpu.RadarParams(n_range=256, n_doppler=64)
    cfar = dataclasses.replace(p.cfar, scale_mode=mode)
    jcfar = dataclasses.replace(jp.cfar, scale_mode=mode)
    mag = int_tie_map(np.random.default_rng(10 * so + pgr), 2, 256, 64)
    if mode == "cell" and so == 0 and pgr == 0:
        assert (_int_ties(mag, cfar) > 0).all()
    got = kernel_decide(mag, cfar, so, pgr)
    want = F.detect_plain(torch.as_tensor(mag, dtype=torch.int32), cfar, so,
                          pgr)
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
    jdet = []
    for frame in mag:
        d, _, _ = JC.cfar_2d(jax.numpy.asarray(frame, jax.numpy.int32), so,
                             jcfar, integer=True)
        jdet.append(np.asarray(JC.peak_group(d, pgr) if pgr else d))
    assert np.array_equal(got[0], np.stack(jdet))
    assert got[2].min() > 0


# (ref_range, guard_range, ref_doppler, guard_doppler) of a window with
# n_ref training cells that fits the tile of a 32 x 128 map.
_WIDE = {4094: (8, 0, 119, 1), 4096: (5, 3, 119, 2)}


@pytest.mark.parametrize("n_ref", sorted(_WIDE))
def test_fixed_entries_take_at_most_4094_training_cells(n_ref):
    """The float packed count (hi 4096 + lo, exact while n_ref <= 4094:
    ``kMaxPackedRef<float>`` in csrc/cfar_tile.cuh) bounds the training
    set of both fixed entries: their config step (``frontend_fixed.
    fixed_config``, run before each launch) raises NotImplementedError
    above it and ``fused_fixed_detect_supported`` is then False.  A window
    always has an even n_ref, so 4096 is the first refused."""
    rr, gr, rd, gd = _WIDE[n_ref]
    cfar = fmcw_tpu_torch.CfarParams(ref_range=rr, guard_range=gr,
                                     ref_doppler=rd, guard_doppler=gd)
    assert cfar.n_ref == n_ref
    p = fmcw_tpu_torch.RadarParams(n_range=32, n_doppler=128, cfar=cfar)
    shard = torch.zeros((1, 16, 128), dtype=torch.int16)
    bases = {"slowtime_detect_fixed": lambda name: F._slowtime_config(
                 1, 32, 128, cfar, 0, 0, name=name),
             "slowtime_detect_fixed_split": lambda name: SF._split_config(
                 shard, cfar, 0, 0, False, 16, 32, name)}
    for name, base in bases.items():
        def step():
            return FX.fixed_config(base(name), cfar, 2, "zero", False, CW,
                                   "unbiased", name)
        if n_ref <= F.MAX_PACKED_REFS:
            assert step().n_ref == n_ref
        else:
            with pytest.raises(NotImplementedError,
                               match=f"{name} kernel: at most 4094"):
                step()
    assert FX.fused_fixed_detect_supported(p) == (n_ref <= 4094)


# ---------------------------------------------------------------------------
# The plan end to end
# ---------------------------------------------------------------------------

def _jparams(p):
    return fmcw_tpu.RadarParams(
        n_range=p.n_range, n_doppler=p.n_doppler, notch_mode=p.notch_mode,
        cfar=fmcw_tpu.CfarParams(**dataclasses.asdict(p.cfar)))


@pytest.mark.parametrize("shape", ["quick", "256x64"])
def test_plan_end_to_end_vs_golden_twin_and_jax_kernel(shape):
    """Golden frames through the golden range stage, the row model and the
    decision model: equal to JAX's golden ``process_frame_fixed`` (per-cell
    scale, magnitudes and decisions), to the port's fused twins through the
    processor (``frontend="plain"``, grouping radius 2) and, on JAX's fused
    fixed kernel (interpret mode), to its contract: detections, counts and
    saturation exact, magnitudes within 8 LSB."""
    if shape == "quick":
        p = fmcw_tpu_torch.quick()
    else:
        p = fmcw_tpu_torch.RadarParams(
            n_range=256, n_doppler=64,
            cfar=fmcw_tpu_torch.CfarParams(scale_mode="block",
                                           scale_block=2))
    jp = _jparams(p)
    frames = [np.asarray(tref.two_target_frame(p, seed=3)),
              _hot(np.asarray(tref.two_target_frame(p, seed=5)))]
    tproc = tpl.make_processor(p, mode="fixed", frontend="plain",
                               peak_group_radius=2, device="cpu")
    jproc = jpl.make_processor(jp, mode="fixed", frontend="pallas",
                               include_maps=True, peak_group_radius=2)
    for z in frames:
        i_w, q_w, _ = jfx.window_apply(
            z.real.astype(np.int64), z.imag.astype(np.int64),
            jfx.hamming_coeffs(p.n_range, CW)[None, :], CW, "unbiased")
        sat_r = sum(jfx.window_apply(v, np.zeros_like(v),
                                     jfx.hamming_coeffs(p.n_range, CW)[None, :],
                                     CW, "unbiased")[2].sum()
                    for v in (z.real.astype(np.int64),
                              z.imag.astype(np.int64)))
        r, i = (v.T for v in jfx.bfp_fft(i_w, q_w, axis=1))
        mag, sat, _, _ = kernel_rows(r[None], i[None])
        if p.cfar.scale_mode == "cell":
            gmag, gdet = jref.process_frame_fixed(z, jp)
            assert np.array_equal(mag[0], gmag)
            assert np.array_equal(kernel_decide(mag, p.cfar, 0, 0)[0][0],
                                  gdet)
        det, row_max, n_dets = kernel_decide(mag, p.cfar, 0, 2)
        iq = tpl.complex_to_iq(z)
        out = tproc(iq)
        assert np.array_equal(out["mag_map"].numpy(), mag[0])
        assert np.array_equal(out["det_map"].numpy(), det[0])
        assert int(out["n_dets"]) == int(n_dets[0])
        assert int(out["saturation_count"]) == int(sat.sum() + sat_r)
        ref = jax.tree.map(np.asarray, jproc(iq))
        assert np.array_equal(det[0] > 0, ref["det_map"] > 0)
        assert int(n_dets[0]) == int(ref["n_dets"])
        assert int(sat.sum() + sat_r) == int(ref["saturation_count"])
        assert np.abs(mag[0] - ref["mag_map"]).max() <= LSB


def test_fma_model_rounds_once():
    """``_fma`` equals a b + c computed in exact rationals and rounded once
    to float64, on random operands and on products that cancel against
    their own rounding (the eighth-turn residue)."""
    from fractions import Fraction
    rng = np.random.default_rng(7)
    a = rng.standard_normal(400) * 2.0 ** rng.integers(-30, 30, 400)
    b = rng.standard_normal(400) * 2.0 ** rng.integers(-30, 30, 400)
    c = rng.standard_normal(400) * 2.0 ** rng.integers(-30, 30, 400)
    y = rng.integers(-2 ** 22, 2 ** 22, 400).astype(np.float64)
    a = np.concatenate([a, y])
    b = np.concatenate([b, np.full(400, _kc8())])
    c = np.concatenate([c, -(y * _kc8())])
    got = _fma(a, b, c)
    want = [float(Fraction(x) * Fraction(w) + Fraction(z))
            for x, w, z in zip(a, b, c)]
    assert np.array_equal(got, np.array(want))
    assert (got[400:] != 0).any()


def test_decision_model_wide_window_large_sums():
    """A window of 25 x 63 cells (1,550 training cells) on a map with
    23.5% of its cells at the chain's largest magnitude (45,056) and the
    rest near 1,000: its box sums (~1.8e7) pass 2^24, where a float sum
    would round, so the model sums the boxes in int, as the kernel's
    IntInFloat does, and equals the plain integer CFAR bit for bit, with
    detections where the training set takes the low scale."""
    p = fmcw_tpu_torch.RadarParams(n_range=256, n_doppler=64)
    cfar = dataclasses.replace(p.cfar, ref_range=10, guard_range=2,
                               ref_doppler=29, guard_doppler=2)
    rng = np.random.default_rng(3)
    mag = rng.integers(800, 1200, (1, 256, 64))
    mag[rng.random(mag.shape) < 0.235] = 45056
    assert cfar.win_range * cfar.win_doppler * mag.mean() > 2 ** 24
    got = kernel_decide(mag, cfar, 0, 1)
    want = F.detect_plain(torch.as_tensor(mag, dtype=torch.int32), cfar, 0, 1)
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
    assert got[2].min() > 0
