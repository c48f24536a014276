"""The fixed range kernel at n_range = n2 x 128 beyond the powers of two
(384, 640, ..., 1920 and 2048; fmcw_tpu_torch/csrc/range_fft_fixed.cu's
dense stage, TPU rows 2 and 4) and the fused fixed route that reaches it,
held against the JAX package on the CPU.

The kernel runs each length as n = o x m (kernel A's split: o = 2 at
2048, else the odd factor 3 .. 15) and each group of 8 chirps as:

* the window in place: every 32-bit I/Q word of the group windowed in Q15
  integers (saturations counted once a sample), int16 by construction;
* where 3 divides n, the sixth- and twelfth-turn bins k = j n / 12 of each
  chirp from the exact class sums of its windowed samples (mod 12), E / 2
  + RN(sqrt(3)/2 B), the twin's operations;
* the classes k2 < o, kSlices at once in kRounds rounds (each slice its
  own exchange regions): the dense stage y[i1] = W_n^(i1 k2) sum_i2
  x[i1 + m i2] W_o^(i2 k2) with the table's twiddles64 values, then the
  m-point FP64 plan of the powers of two (pass 1, exchange, pass 2), class
  0's eighth-turn bins from its column 0, the sixth- and twelfth-turn
  bins replaced by the exact ones; the first sweep only takes each
  thread's peak key (lanes of a chirp, then every slice's warps), the
  second recomputes the class and stores it quantized to row o k1 + k2.

``kernel_model`` below models that plan in numpy, indices and stores
included (each output written once, each warp instruction 4 rows x 8
consecutive chirps), with numpy's separate multiplies and adds where the
kernel fuses them: the values differ by ~1e-16 relative and only at bins
whose value is irrational, while the round-half ties that decide bit
equality sit at the exact bins, which both compute exactly.  Here:

* the model bit for bit against the port's plain twin
  (``range_fft_fixed_plain``, a dense FP64 product with the exact bins) at
  all 12 new lengths, saturation counts included, on seeded full-scale
  noise, the saturating x40 frame and tie planes (exact half-LSB ties on
  the quarter-, eighth- and, where 3 divides n, sixth- and twelfth-turn
  bins); against the JAX package's golden ``bfp_fft``: equal at 2048 and
  elsewhere except at exact bins k (24 k / n whole: quarter, eighth,
  sixth and twelfth turns), whose ties its mixed-radix np.fft.fft rounds
  the other way (ROADMAP fault 5), at every length beyond the powers of
  two, not only where 3 divides n;
* mutation checks: W_o conjugated (W_n at 2048), or the exact twelfth-turn
  bins left out, puts the model off the twin;
* the plan's shared memory and threads at every length, the powers of two
  unchanged; the tables' layout, the powers of two unchanged;
* the fused fixed route on the CPU (its twins) at 384x32 and 2048x16 —
  per-cell, block 8 and 16, GO, a long CPI — equal to the port's golden
  model, its detections to JAX's XLA fixed chain (magnitudes within 8
  LSB, ROADMAP fault 3); ``fused_fixed_detect_supported`` against JAX's
  gate; a LocalMesh at sp 2 equal to one device.
"""

import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

import fmcw_tpu
import fmcw_tpu_torch
from fmcw_tpu.golden import fixed_point as jfx
from fmcw_tpu.models import pipeline as jpl
from fmcw_tpu_torch import kernels
from fmcw_tpu_torch.golden import fixed_point as tfx, reference as tref
from fmcw_tpu_torch.models import pipeline as tpl
from fmcw_tpu_torch.ops import fft as TF, frontend as F
from fmcw_tpu_torch.ops import frontend_fixed as FX
from fmcw_tpu_torch.ops.window import window_rounding_constant
from fmcw_tpu_torch.parallel import LocalMesh, make_sharded_processor

from test_torch_fixed_longcpi import int_tie_map, kernel_decide_long
from test_torch_range_fft_fixed_plan import (
    COEF_WIDTH, K_CHIRPS, SHIFT, SRC, _abs_key, _bfp_scale, _brev, _dft,
    _eighth_turn_bins, _full_scale, _hot, _quantize, _scale_from_key,
    count_eighth_ties, count_ties, golden)

# Share the CPU with the other test workers (the suite runs 6 at once).
torch.set_num_threads(2)

NEW = [n for n in range(384, 2049, 128) if n & (n - 1)] + [2048]
POW2 = [1 << k for k in range(4, 11)]
LSB = 8                 # magnitudes against JAX's FP32 XLA fixed chain
SMEM_CAP = int(re.search(r"kSmemCap = (\d+);", SRC).group(1))
C3 = float.fromhex(re.search(r"kC3 = (0x[0-9a-fA-F.p+-]+);",
                             SRC).group(1))


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

def plan(n):
    """``Plan<log2 m, o>`` of csrc/range_fft_fixed.cu."""
    o, m = F.range_fft_split(n)
    n1, n2 = F.range_fft_plan(m)
    lanes = K_CHIRPS * n2
    most = 1 if lanes >= 256 else 256 // lanes
    rounds = -(-o // most)
    slices = -(-o // rounds)
    threads = slices * lanes
    warps = threads // 32
    region = m + (18 - m % 16) % 16
    exchange = K_CHIRPS * region
    in_bytes = K_CHIRPS * n * 4
    rest = (2 * slices * exchange * 8 + warps * K_CHIRPS * 4
            + (K_CHIRPS * 12 * 16 if o % 3 == 0 else 0)
            + (warps * 4 + 15) // 16 * 16)
    stages = 2 if o == 1 or 2 * in_bytes + rest + 16 <= SMEM_CAP else 1
    return dict(o=o, m=m, n1=n1, n2=n2, lanes=lanes, rounds=rounds,
                slices=slices, threads=threads, warps=warps, region=region,
                exchange=exchange, stages=stages,
                smem=stages * in_bytes + rest + stages * 8)


def _window(x, coef, rnd):
    v = (x.astype(np.int64) * coef + rnd) >> SHIFT
    return np.clip(v, -32768, 32767), (v > 32767) | (v < -32768)


def twelfth_exact(vi, vq):
    """twelfth_bins: the windowed chirps (..., n) -> {j: (re, im)} for the
    bins j n / 12, j < 12 not a multiple of 3, E / 2 + RN(C3 B)."""
    n = vi.shape[-1]
    tr = vi.reshape(*vi.shape[:-1], n // 12, 12).sum(-2)
    ti = vq.reshape(*vq.shape[:-1], n // 12, 12).sum(-2)
    out = {}
    for j in range(12):
        if j % 3 == 0:
            continue
        er = ei = br = bi = 0
        for r in range(12):
            c2, c3, s2, s3 = TF.W12_PARTS[r * j % 12]
            er = er + c2 * tr[..., r] + s2 * ti[..., r]
            ei = ei + c2 * ti[..., r] - s2 * tr[..., r]
            br = br + c3 * tr[..., r] + s3 * ti[..., r]
            bi = bi + c3 * ti[..., r] - s3 * tr[..., r]
        out[j] = (0.5 * er.astype(np.float64) + C3 * br.astype(np.float64),
                  0.5 * ei.astype(np.float64) + C3 * bi.astype(np.float64))
    return out


def kernel_model(iq, rnd, table=None, exact12=True):
    """The kernel on int16 iq (B, nd, n, 2) at n = o x m, o > 1 ->
    int16-valued re/im (B, n, nd) and the saturation count (B,).
    ``table`` replaces the twiddle table (the mutation checks);
    ``exact12=False`` leaves out the exact sixth- and twelfth-turn bins."""
    B, nd, n, _ = iq.shape
    P = plan(n)
    o, m, n1, n2 = P["o"], P["m"], P["n1"], P["n2"]
    l1, l2 = n1.bit_length() - 1, n2.bit_length() - 1
    assert o > 1 and o * m == n
    win, tw = (x.numpy() for x in FX._range_tables(n, COEF_WIDTH, "cpu"))
    if table is not None:
        tw = table
    sub, twn, two = tw[:m], tw[m:m + n], tw[m + n:]
    assert len(two) == o
    groups = B * nd // K_CHIRPS
    gi = np.arange(groups)
    b, c0 = gi // (nd // K_CHIRPS), gi % (nd // K_CHIRPS) * K_CHIRPS
    # The bulk copy (I in the low half of each word), then the window in
    # place: word w is sample w mod n of chirp w / n.
    words = np.ascontiguousarray(iq).view(np.uint32).reshape(groups, -1)
    coef = win[np.arange(K_CHIRPS * n) % n].astype(np.int64)
    vi, si = _window((words & 0xFFFF).astype(np.uint16).view(np.int16), coef,
                     rnd)
    vq, sq = _window((words >> 16).astype(np.uint16).view(np.int16), coef,
                     rnd)
    sat = np.zeros(B, np.int64)
    np.add.at(sat, b, (si.sum(-1) + sq.sum(-1)))
    vi = vi.reshape(groups, K_CHIRPS, n)
    vq = vq.reshape(groups, K_CHIRPS, n)
    exact = twelfth_exact(vi, vq) if o % 3 == 0 else {}
    # The threads of one slice (a class): lane l.
    lane = np.arange(P["lanes"])
    t, c1 = lane & (n2 - 1), lane >> l2               # pass 1
    c2, q = lane % K_CHIRPS, lane // K_CHIRPS         # pass 2
    classes = []
    for k2 in range(o):
        # The dense stage: point i1 = t + N2 m' of chirp c1.
        xr = np.zeros((groups, P["lanes"], n1))
        xi = np.zeros_like(xr)
        for mv in range(n1):
            i1 = t + n2 * mv
            ar = np.zeros((groups, P["lanes"]))
            ai = np.zeros_like(ar)
            for i2 in range(o):
                cr, ci = two[i2 * k2 % o]
                r = vi[:, c1, i1 + m * i2].astype(np.float64)
                im = vq[:, c1, i1 + m * i2].astype(np.float64)
                ar = ar + r * cr
                ar = ar + (-im) * ci
                ai = ai + r * ci
                ai = ai + im * cr
            w = twn[k2 * m + i1]
            xr[..., mv] = ar * w[:, 0] - ai * w[:, 1]
            xi[..., mv] = ar * w[:, 1] + ai * w[:, 0]
        if k2 == 0:                    # a sum of integers, exactly
            assert np.array_equal(xr, np.round(xr))
            assert np.array_equal(xi, np.round(xi))
        # The m-point plan: N1-point DFT, W_m^(t ka) = tw[ka N2 + t].
        _dft(xr, xi, n1, 0)
        for ka in range(1, n1):
            p = _brev(ka, l1)
            w = sub[ka * n2 + t]
            xr[..., p], xi[..., p] = (xr[..., p] * w[:, 0]
                                      - xi[..., p] * w[:, 1],
                                      xr[..., p] * w[:, 1]
                                      + xi[..., p] * w[:, 0])
        # The exchange through the slice's regions (the slice offset is
        # the same for every thread of a class).
        for x in (xr, xi):
            xch = np.full((groups, P["exchange"]), np.nan)
            for ka in range(n1):
                put = c1 * P["region"] + t * n1 + ((ka + t) & (n1 - 1))
                xch[:, put] = x[..., _brev(ka, l1)]
            for j in range(n1 // n2):
                for tp in range(n2):
                    get = (c2 * P["region"] + tp * n1
                           + ((q + n2 * j + tp) & (n1 - 1)))
                    x[..., j * n2 + tp] = xch[:, get]
        assert np.isfinite(xr).all() and np.isfinite(xi).all()
        col0 = xr[:, :K_CHIRPS, :n2].copy(), xi[:, :K_CHIRPS, :n2].copy()
        for j in range(n1 // n2):
            _dft(xr, xi, n2, j * n2)
        if k2 == 0:
            _eighth_turn_bins(xr, xi, *col0, l2)
        for j, (er, ei) in exact.items() if exact12 else ():
            k = j * n // 12
            if k % o != k2:
                continue
            k1 = k // o
            p = (k1 // n2) % (n1 // n2) * n2 + _brev(k1 // n1, l2)
            sel = q == k1 % n2
            xr[:, sel, p] = er[:, c2[sel]]
            xi[:, sel, p] = ei[:, c2[sel]]
        classes.append((xr, xi))
    # Sweep 1: the thread's key over its classes (class k2 on slice k2 mod
    # kSlices), lanes xor 8 and 16, then every warp of every slice.
    key = np.zeros((groups, P["slices"], P["lanes"]), np.int64)
    for k2, (xr, xi) in enumerate(classes):
        key[:, k2 % P["slices"]] = np.maximum(
            key[:, k2 % P["slices"]],
            np.maximum(_abs_key(xr), _abs_key(xi)).max(-1))
    key = key.reshape(groups, -1, 4, K_CHIRPS).max(axis=(1, 2))
    peak = np.max([np.maximum(np.abs(xr), np.abs(xi)).max(-1).reshape(
        groups, -1, K_CHIRPS).max(1) for xr, xi in classes], axis=0)
    assert np.array_equal(_scale_from_key(key), _bfp_scale(peak))
    scale = _scale_from_key(key)[:, c2]               # (groups, lanes)
    # Sweep 2: quantize, store row o (q + N2 j + N1 kb) + k2 of chirp c0 +
    # c2 straight from registers, each warp instruction 4 rows x 8 chirps.
    out = np.full((2, B, n, nd), -99999, np.int64)
    stored = np.zeros((B, n, nd), int)
    col = c0[:, None] + c2
    bb = np.broadcast_to(b[:, None], col.shape)
    by_warp = lane.reshape(-1, 32)
    for k2, (xr, xi) in enumerate(classes):
        qr, qi = _quantize(xr, scale[..., None]), _quantize(xi, scale[..., None])
        for j in range(n1 // n2):
            for kb in range(n2):
                k = o * (q + n2 * j + n1 * kb) + k2
                runs = np.sort((k * nd + c2)[by_warp], axis=-1).reshape(
                    -1, 4, K_CHIRPS)
                assert (np.diff(runs, axis=-1) == 1).all()
                assert (np.diff(runs[..., 0], axis=-1) == o * nd).all()
                p = j * n2 + _brev(kb, l2)
                kk = np.broadcast_to(k, col.shape)
                out[0, bb, kk, col] = qr[..., p]
                out[1, bb, kk, col] = qi[..., p]
                np.add.at(stored, (bb, kk, col), 1)
    assert (stored == 1).all()
    return out[0], out[1], sat


# ---------------------------------------------------------------------------
# Stimuli
# ---------------------------------------------------------------------------

def count_twelfth_ties(i_w, q_w):
    """Half-LSB ties of the real parts of the bins j n/12 (j not a multiple
    of 3) whose sqrt(3)/2 part is 0, from exact integer class sums."""
    n = i_w.shape[-1]
    z = np.fft.fft(i_w.astype(float) + 1j * q_w.astype(float), axis=-1)
    peak = np.maximum(np.abs(z.real), np.abs(z.imag)).max(-1)
    s = np.maximum(np.ceil(np.log2(np.maximum(peak, 1.0) / 32768.0)), 0)
    s = s.astype(np.int64)
    tr = i_w.astype(np.int64).reshape(*i_w.shape[:-1], n // 12, 12).sum(-2)
    ti = q_w.astype(np.int64).reshape(*q_w.shape[:-1], n // 12, 12).sum(-2)
    ties = 0
    for j in range(12):
        if j % 3 == 0:
            continue
        e, b = tref.twelfth_parts(j)
        er, br = tr @ e[0] + ti @ e[1], tr @ b[0] + ti @ b[1]
        # E / 2 an integer = 2^(s-1) (mod 2^s), s >= 1.
        ties += int(((br == 0) & (s > 0) & (er % 2 == 0)
                     & ((er // 2) % (1 << s) == 1 << np.maximum(s - 1, 0)))
                    .sum())
    return ties


def _tie_frames(kind):
    def make(rng, B, nd, n, rounding):
        return tref.range_tie_frames(int(rng.integers(1 << 30)), B, nd, n,
                                     kind, rounding)
    return make


STIMULI = {"full_scale": _full_scale, "hot": _hot,
           "ties": _tie_frames("quarter"), "eighth_ties": _tie_frames("eighth"),
           "twelfth_ties": _tie_frames("twelfth")}
TIE_COUNTS = {"ties": count_ties, "eighth_ties": count_eighth_ties,
              "twelfth_ties": count_twelfth_ties}


def _exact_bin(k, n):
    """A quarter-, eighth-, sixth- or twelfth-turn bin (24 k / n whole)."""
    return k * 24 % n == 0


@pytest.mark.parametrize("n", NEW)
def test_plan_equals_twin_and_golden(n):
    """The model equals the plain twin bit for bit, saturation counts
    included, on every stimulus (one group of 8 chirps; ties: one a chirp
    at the bins the stimulus aims at, counted exactly); the golden
    bfp_fft (np.fft.fft, mixed radix but at 2048) gives every value the
    model gives except at exact bins, and at 2048 every value."""
    rng = np.random.default_rng(n)
    gold_off = 0
    for i, (name, make) in enumerate(sorted(STIMULI.items())):
        if name == "twelfth_ties" and n % 3:
            continue
        rounding = ("unbiased", "biased")[i % 2]
        iq = (make(rng, 1, K_CHIRPS, n, rounding) if "ties" in name
              else make(rng, 1, K_CHIRPS, n))
        rnd = window_rounding_constant(COEF_WIDTH, rounding)
        got_re, got_im, got_sat = kernel_model(iq, rnd)
        p_re, p_im, p_sat = FX.range_fft_fixed_plain(
            torch.as_tensor(iq), COEF_WIDTH, rounding)
        assert np.array_equal(got_re, p_re.numpy()), name
        assert np.array_equal(got_im, p_im.numpy()), name
        assert np.array_equal(got_sat, p_sat.numpy())
        g_re, g_im, g_sat, windowed = golden(iq, rounding)
        assert np.array_equal(got_sat, g_sat)
        rows = np.argwhere((got_re != g_re) | (got_im != g_im))[:, 1]
        assert n & (n - 1) or rows.size == 0, (name, rows)
        assert all(_exact_bin(int(k), n) for k in rows), (name, rows)
        gold_off += rows.size
        want = TIE_COUNTS.get(name)
        if want:
            assert want(*windowed) >= K_CHIRPS, name
        if name == "hot":
            assert got_sat.min() > 0
    TF.dft64_matrices.cache_clear()


@pytest.mark.parametrize("n", [384, 1920, 2048])
def test_plan_needs_its_dense_twiddles_and_exact_bins(n):
    """Mutation checks: W_o^e conjugated (o odd: the classes come out
    mirrored) or W_n^(i1 k2) conjugated (2048, where W_2 is real) puts the
    model far off the twin; where 3 divides n, the model without its exact
    sixth- and twelfth-turn bins misses ties that the twin rounds the exact
    way."""
    o, m = F.range_fft_split(n)
    tw = FX._range_tables(n, COEF_WIDTH, "cpu")[1].numpy()
    bad = tw.copy()
    bad[(m + n if o > 2 else m):(m + n + o if o > 2 else m + n), 1] *= -1
    rng = np.random.default_rng(7)
    iq = _full_scale(rng, 1, K_CHIRPS, n)
    rnd = window_rounding_constant(COEF_WIDTH, "unbiased")
    p_re = FX.range_fft_fixed_plain(torch.as_tensor(iq))[0].numpy()
    assert (kernel_model(iq, rnd, bad)[0] != p_re).mean() > 0.3
    if n % 3 == 0:
        iq = tref.range_tie_frames(3, 1, K_CHIRPS, n, "twelfth")
        p_re = FX.range_fft_fixed_plain(torch.as_tensor(iq))[0].numpy()
        missed = kernel_model(iq, rnd, exact12=False)[0] != p_re
        assert missed.any()
        assert all(_exact_bin(int(k), n) for k in np.argwhere(missed)[:, 1])
    TF.dft64_matrices.cache_clear()


def test_plan_fits_a_block():
    """Every length's plan fits the kernel's shared-memory cap (196 KiB,
    the carve-out's 60 KB of L1) with at most 256 threads, the classes in
    rounds with no idle slice in the first; two input buffers except at
    1536 and 2048; the powers of two keep one slice, two buffers and their
    shared memory as it was (input ring, exchange, peaks, saturations,
    barriers)."""
    for n in NEW + POW2:
        P = plan(n)
        assert P["smem"] <= SMEM_CAP and P["threads"] <= 256, (n, P)
        assert P["o"] <= 15 and P["m"] in POW2 and P["o"] * P["m"] == n
        assert P["slices"] <= P["o"] <= P["slices"] * P["rounds"]
        assert P["rounds"] * P["slices"] - P["o"] < P["slices"]
        assert P["stages"] == (1 if n in (1536, 2048) else 2), n
        if n in POW2:
            old = (2 * K_CHIRPS * n * 4 + 2 * K_CHIRPS * P["region"] * 8
                   + P["warps"] * K_CHIRPS * 4
                   + (P["warps"] * 4 + 15) // 16 * 16 + 2 * 8)
            assert (P["o"], P["slices"], P["rounds"], P["smem"]) == (
                1, 1, 1, old)
    assert plan(1024)["smem"] == 197168 and plan(2048)["smem"] == 197160


def test_tables_layout():
    """n = o x m: tw[ka N2 + t] = twiddles64(m)[t ka] (the m-point plan's
    table), then W_n^(i1 k2) = twiddles64(n)[i1 k2 mod n] at [m + k2 m +
    i1] and W_o^e = twiddles64(n)[e m] at [m + n + e], so that class 0
    multiplies by exactly 1; the window is the int32 Q15 ROM; at the powers
    of two the table is the one it was, n entries."""
    assert tref._W12_PARTS == TF.W12_PARTS     # the tie frames' copy
    for n in NEW + POW2:
        o, m = F.range_fft_split(n)
        n1, n2 = F.range_fft_plan(m)
        win, tw = (x.numpy() for x in FX._range_tables(n, COEF_WIDTH, "cpu"))
        assert win.dtype == np.int32 and tw.dtype == np.float64
        assert np.array_equal(win, jfx.hamming_coeffs(n, COEF_WIDTH))
        ka, t = np.divmod(np.arange(m), n2)
        want = [TF.twiddles64(m)[t * ka]]
        if o > 1:
            k2, i1 = np.divmod(np.arange(n), m)
            want += [TF.twiddles64(n)[i1 * k2 % n],
                     TF.twiddles64(n)[np.arange(o) * m]]
            assert np.array_equal(tw[m], [1.0, 0.0])
            assert np.array_equal(tw[m + n], [1.0, 0.0])
        want = np.concatenate(want)
        assert np.array_equal(tw[:, 0], want.real)
        assert np.array_equal(tw[:, 1], want.imag), n
        assert len(tw) == (n if o == 1 else m + n + o)


# ---------------------------------------------------------------------------
# The fused fixed route
# ---------------------------------------------------------------------------

def _jparams(p):
    return fmcw_tpu.RadarParams(
        n_range=p.n_range, n_doppler=p.n_doppler,
        cfar=fmcw_tpu.CfarParams(**dataclasses.asdict(p.cfar)))


def _params(nr, nd, mode="cell", sb=1, variant="os"):
    return fmcw_tpu_torch.RadarParams(
        n_range=nr, n_doppler=nd, cfar=fmcw_tpu_torch.CfarParams(
            variant=variant, scale_mode=mode, scale_block=sb))


def assert_golden_but_exact_bins(mag, g_mag, det, g_det, reach):
    """The route's maps against the golden model's: the magnitudes equal
    but in range rows k at exact bins (24 k / n whole, ROADMAP fault 5: the
    golden np.fft.fft rounds some of their ties the other way), the
    detections equal but within ``reach`` rows of such a row (the CFAR
    window and grouping).  Returns the rows that differ."""
    nr = mag.shape[0]
    rows = np.unique(np.argwhere(mag != g_mag)[:, 0])
    assert all(_exact_bin(int(k), nr) for k in rows), rows
    near = np.zeros(nr, bool)
    for k in rows:
        near[np.arange(k - reach, k + reach + 1) % nr] = True
    assert not ((det != g_det).any(-1) & ~near).any()
    return rows


@pytest.mark.parametrize("nr,nd,mode,sb,variant,pg", [
    (384, 32, "cell", 1, "os", 2), (384, 32, "block", 8, "os", 0),
    (384, 32, "cell", 1, "go", 2), (384, 256, "cell", 1, "os", 2),
    (2048, 16, "cell", 1, "os", 0), (2048, 16, "block", 16, "os", 2)])
def test_fused_fixed_route_matches_golden_and_xla_chain(nr, nd, mode, sb,
                                                        variant, pg):
    """Fixed "fused" at the new lengths (its twins here): the route is
    "fused" and ``fused_fixed_detect_supported`` says so; det_map, mag_map
    and saturation_count equal the port's golden model bit for bit; the
    detection set, valid detections and n_dets equal JAX's XLA fixed chain,
    its magnitudes within 8 LSB and its saturation count equal."""
    p = _params(nr, nd, mode, sb, variant)
    z = np.asarray(tref.two_target_frame(p, seed=3))
    frame = tpl.complex_to_iq(z)
    assert FX.fused_fixed_detect_supported(p, pg)
    proc = tpl.make_batch_processor(p, mode="fixed", frontend="fused",
                                    include_maps=True, peak_group_radius=pg,
                                    device="cpu")
    assert proc.route == "fused"
    out = {k: v[0] for k, v in proc(frame[None]).items()}
    mag, det = tref.process_frame_fixed(z, p)
    if pg:
        det = tfx.peak_group(det, pg)
    assert_golden_but_exact_bins(out["mag_map"].numpy(), mag,
                                 out["det_map"].numpy(), det,
                                 p.cfar.halo_range + pg)
    base = dict(mode="fixed", include_maps=True, peak_group_radius=pg)
    ref = jax.tree.map(np.asarray, jpl.make_processor(_jparams(p), **base)(
        frame))
    assert (set(zip(*np.nonzero(out["det_map"].numpy())))
            == set(zip(*np.nonzero(ref["det_map"]))))
    assert int(out["n_dets"]) == int(ref["n_dets"]) > 0
    assert np.abs(out["mag_map"].numpy().astype(np.int64)
                  - ref["mag_map"].astype(np.int64)).max() <= LSB
    assert int(out["saturation_count"]) == int(ref["saturation_count"])
    v = out["valid"].numpy()
    assert np.array_equal(v, ref["valid"])


def test_fused_fixed_gate_against_jax():
    """At every n2 x 128 beyond the powers of two ``fused_fixed_detect_
    supported`` is True where JAX's is: per-cell at n_doppler 32 and 128
    and at the long CPIs 256 and 2048; both refuse n_range 320 and 4096.
    JAX's kernel takes the block scale only at scale_block = n_range / 128
    (here: 16 at 2048); the port's kernels take block 8 and 16 at every
    length (their row tile of 64, 32, 16 or 8)."""
    for nr in NEW:
        for nd in (32, 128, 256, 2048):
            p = _params(nr, nd)
            assert jpl.fused_fixed_detect_supported(_jparams(p)), (nr, nd)
            assert FX.fused_fixed_detect_supported(p, 2), (nr, nd)
        for sb in (8, 16):
            p = _params(nr, 128, "block", sb)
            assert jpl.fused_fixed_detect_supported(_jparams(p)) == (
                sb == nr // 128)
            assert FX.fused_fixed_detect_supported(p, 2), (nr, sb)
    for nr in (320, 4096):
        p = _params(nr, 32)
        assert not jpl.fused_fixed_detect_supported(_jparams(p))
        assert not FX.fused_fixed_detect_supported(p)


def test_fixed_long_decide_tile_at_block_16():
    """JAX's block scale 16 (48 halo rows) at a long CPI: the fixed
    kernels' decide tile keeps T + 2 H within 128 rows (``_slowtime_config
    (..., int_map=True)``: T = 32, so an integer column sum held in float
    stays exact), where kernel B's float tile takes 64; so the fixed route
    takes 2048x256 and 2048x2048 at block 16, as JAX's gate does (and
    1024x256, which JAX's kernel does not: its block is n_range / 128);
    where T = 64 fits the fixed tile is kernel B's.  The decide model at
    that tile (128x256, four row tiles) equals the plain integer CFAR bit
    for bit on an integer tie map."""
    b16 = fmcw_tpu_torch.CfarParams(scale_mode="block", scale_block=16)
    for nr, nd in ((2048, 256), (2048, 2048), (1024, 256)):
        fixed = F._slowtime_config(1, nr, nd, b16, 0, 2, int_map=True)
        flt = F._slowtime_config(1, nr, nd, b16, 0, 2)
        assert fixed.T + 2 * fixed.H <= kernels.MAX_ROWS < flt.T + 2 * flt.H
        p = _params(nr, nd, "block", 16)
        assert FX.fused_fixed_detect_supported(p, 2)
        assert jpl.fused_fixed_detect_supported(_jparams(p), 2) == (
            nr == 2048)
    for cfar in (fmcw_tpu_torch.CfarParams(),
                 fmcw_tpu_torch.CfarParams(scale_mode="block")):
        for nd in (256, 2048):
            assert (F._slowtime_config(1, 1024, nd, cfar, 0, 2,
                                       int_map=True).T
                    == F._slowtime_config(1, 1024, nd, cfar, 0, 2).T)
    assert F._slowtime_config(1, 128, 256, b16, 0, 2, int_map=True).T == 32
    mag = int_tie_map(np.random.default_rng(16), 1, 128, 256)
    got = kernel_decide_long(mag, b16, 0, 2)
    want = F.detect_plain(torch.as_tensor(mag, dtype=torch.int32), b16, 0, 2)
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
    assert got[2].min() > 0


def test_local_mesh_equals_single_device():
    """The sharded processor on a LocalMesh at sp 2 (the fixed range
    kernel's chirp shards of 384 x 16, the fixed split entry on 192-row
    range shards with their halo rows: their twins here) equals the
    single-device fused fixed route at 384x32, every output; fixed "auto"
    stays the staged route."""
    p = _params(384, 32)
    iq = np.stack([tpl.complex_to_iq(tref.two_target_frame(p, seed=s))
                   for s in range(2)])
    kw = dict(mode="fixed", frontend="fused", peak_group_radius=2,
              include_maps=True)
    proc = make_sharded_processor(LocalMesh(1, 2, "cpu"), p, **kw)
    assert proc.route == "fused"
    got = proc(iq)
    want = tpl.make_batch_processor(p, device="cpu", **kw)(iq)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert int(want["n_dets"].min()) > 0
    assert tpl.make_batch_processor(p, mode="fixed",
                                    device="cpu").route == "staged"
