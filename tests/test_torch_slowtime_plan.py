"""Numpy models of kernel B's plan (fmcw_tpu_torch/csrc/slowtime_detect.cu
and csrc/cfar_tile.cuh), held against the port's plain twins and the JAX
package on the CPU.

The kernel runs only on the card; its arithmetic and order are modelled
here step by step:

* the slow-time chain of a range row (``slowtime_row``): L = min(32, nd)
  lanes, P = nd / L chirps a lane (chirp s = l P + p); the pulse canceller
  in float32 (x[s] - x[s-1], or fma(-2, x[s-1], x[s]) + x[s-2], missing
  history 0, the first notch - 1 outputs zeroed for transient "zero"); the
  window; an L-point radix-2 DIF across the lanes (stage h = L/2 .. 1: the
  lower lane of a pair takes a + b, the upper (b - a) W_2h^(l mod h) read
  from the table at (l mod h) nd / 2h); the twiddle W_nd^(p k1) (k1 =
  bit_reverse(l)) and a P-point transform; complex products as fma(a, c,
  -(b d)) and fma(a, d, b c).  The fused multiply-adds are modelled in
  float64 then rounded (a double rounding that can differ from the card's
  fma by an ulp, far inside the 1e-5 tolerance the model is held to);
* the CFAR decision on a tile (``decide_tile``): tiles of T = 64 rows with
  H halo rows each side (``ops/frontend._kernel_halo``); the T + 2 pgr
  decided rows in strips of 8 cells (the last strip overlapping its
  neighbour); full and guard column sums once per tile, rows ascending
  from -0; each cell's box sums over its columns ascending; hi and lo
  counted packed in one int; the detection count against q; then the
  grouping of the tile's rows with global row ids.  Block scale takes the
  twin's ``block_scale_map`` (the kernel's ``block_scale_tile`` is the
  shared code the kernels have used since the port began).

The models are held to ``ops/fft.doppler_apply`` and JAX's
``fmcw_tpu.ops.fft.doppler_matrices`` within 1e-5 of the peak, and to the
plain CFAR (``ops/cfar.cfar_2d`` + ``peak_group``) and JAX's bit for bit on
tie-heavy maps, NaN and inf cells included (JAX's XLA ``cfar_2d`` on finite
maps; on NaN / inf maps its order statistic sorts NaN high, so there the
decisions are held to JAX's counting kernel, ``cfar_2d_pallas_detect`` in
interpret mode, at quick()'s 128x32).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fmcw_tpu
import fmcw_tpu_torch
from fmcw_tpu.ops import cfar as JC
from fmcw_tpu.ops import cfar_pallas as JP
from fmcw_tpu.ops import fft as JFFT
from fmcw_tpu_torch.golden import reference as tref
from fmcw_tpu_torch.models import pipeline as tpl
from fmcw_tpu_torch.ops import cfar as C
from fmcw_tpu_torch.ops import fft as TF
from fmcw_tpu_torch.ops import frontend as F
from fmcw_tpu_torch.ops.window import hamming_float

TOL = 1e-5
STRIP = 8
F32 = np.float32


# ---------------------------------------------------------------------------
# The slow-time chain
# ---------------------------------------------------------------------------

def _fma(a, b, c):
    """fma in float32, modelled as the exact float64 product plus c, then
    rounded to float32."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


def _cmul(a, b, wr, wi):
    """(a + i b)(wr + i wi) as the kernel's cmul."""
    return _fma(a, wr, (-b) * wi), _fma(a, wi, b * wr)


def _brev(x, bits):
    return np.array([int(format(int(v), f"0{bits}b")[::-1], 2) for v in x])


def kernel_slowtime(re, im, notch=2, transient="zero", bypass=False):
    """The kernel's slow-time chain of every row of (..., nd) float32 planes
    with its host tables: the complex spectrum (Xr, Xi), natural bin
    order."""
    nd = re.shape[-1]
    win, tw = (x.numpy() for x in F._slowtime_tables(nd, "cpu"))
    L = min(32, nd)
    P = nd // L
    lg = L.bit_length() - 1
    xr, xi = re.astype(F32), im.astype(F32)
    if not bypass:
        def shift(x, n):
            out = np.zeros_like(x)
            out[..., n:] = x[..., :nd - n]
            return out
        if notch == 2:
            xr, xi = xr - shift(xr, 1), xi - shift(xi, 1)
        else:
            xr = _fma(-2.0, shift(xr, 1), xr) + shift(xr, 2)
            xi = _fma(-2.0, shift(xi, 1), xi) + shift(xi, 2)
        if transient == "zero":
            xr[..., :notch - 1] = 0
            xi[..., :notch - 1] = 0
    xr, xi = xr * win, xi * win
    xr = xr.reshape(*xr.shape[:-1], L, P)
    xi = xi.reshape(*xi.shape[:-1], L, P)
    lane = np.arange(L)
    for st in range(lg):
        h = L >> (st + 1)
        partner = lane ^ h
        br, bi = xr[..., partner, :], xi[..., partner, :]
        upper = ((lane & h) != 0)[:, None]
        j = (lane & (h - 1)) * (nd // (2 * h))
        ur, ui = _cmul(br - xr, bi - xi, tw[j, 0][:, None], tw[j, 1][:, None])
        xr = np.where(upper, ur, xr + br)
        xi = np.where(upper, ui, xi + bi)
    k1 = _brev(lane, lg)
    for p in range(1, P):
        xr[..., p], xi[..., p] = _cmul(xr[..., p], xi[..., p],
                                       tw[p * k1, 0], tw[p * k1, 1])
    x = [(xr[..., p], xi[..., p]) for p in range(P)]
    if P == 1:
        bins = x
    elif P == 2:
        bins = [(x[0][0] + x[1][0], x[0][1] + x[1][1]),
                (x[0][0] - x[1][0], x[0][1] - x[1][1])]
    else:
        s0 = (x[0][0] + x[2][0], x[0][1] + x[2][1])
        d0 = (x[0][0] - x[2][0], x[0][1] - x[2][1])
        s1 = (x[1][0] + x[3][0], x[1][1] + x[3][1])
        d1 = (x[1][0] - x[3][0], x[1][1] - x[3][1])
        bins = [(s0[0] + s1[0], s0[1] + s1[1]),
                (d0[0] + d1[1], d0[1] - d1[0]),
                (s0[0] - s1[0], s0[1] - s1[1]),
                (d0[0] - d1[1], d0[1] + d1[0])]
    out_r = np.zeros(re.shape, F32)
    out_i = np.zeros(re.shape, F32)
    for k2, (br, bi) in enumerate(bins):
        out_r[..., k1 + L * k2] = br
        out_i[..., k1 + L * k2] = bi
    return out_r, out_i


def _planes(nd, kind, rng, rows=64):
    """Range-major float32 planes (rows, nd): the range FFT of quick()'s
    two-target frame (its rows 0..rows), seeded noise, or noise riding on
    strong stationary clutter (1e4 x the noise at every chirp)."""
    if kind == "frame":
        p = fmcw_tpu_torch.RadarParams(n_range=128, n_doppler=nd)
        iq = torch.as_tensor(tpl.complex_to_iq(tref.two_target_frame(p)))[None]
        re, im = F.range_fft_plain(iq)
        return re[0, :rows].numpy(), im[0, :rows].numpy()
    re = rng.standard_normal((rows, nd)).astype(F32) * 100
    im = rng.standard_normal((rows, nd)).astype(F32) * 100
    if kind == "clutter":
        re += F32(1e6)
        im -= F32(3e5)
    return re, im


def _spectra_close(got, want):
    peak = max(np.abs(want[0]).max(), np.abs(want[1]).max())
    err = max(np.abs(got[0] - want[0]).max(), np.abs(got[1] - want[1]).max())
    return err / peak


def float64_chain(re, im, notch, transient, bypass):
    """The slow-time chain evaluated in float64: pulse canceller, window,
    ``np.fft.fft``."""
    nd = re.shape[-1]
    x = re.astype(np.float64) + 1j * im.astype(np.float64)
    if not bypass:
        p1 = np.zeros_like(x)
        p1[..., 1:] = x[..., :-1]
        p2 = np.zeros_like(x)
        p2[..., 2:] = x[..., :-2]
        x = x - p1 if notch == 2 else x - 2 * p1 + p2
        if transient == "zero":
            x[..., :notch - 1] = 0
    z = np.fft.fft(x * hamming_float(nd).astype(np.float64), axis=-1)
    return z.real, z.imag


@pytest.mark.parametrize("nd", [16, 32, 64, 128])
@pytest.mark.parametrize("kind", ["frame", "noise", "clutter"])
def test_slowtime_fft_model_matches_twins(nd, kind):
    """The model's spectrum within 1e-5 of the peak of the float64 chain,
    of the port's twin (``doppler_apply``) and of JAX's folded matrices,
    for notch 2 and 3, both transients and the bypass.  On strong
    stationary clutter with the MTI on, the folded float32 matrices (the
    twin's and JAX's) are themselves up to 2.1e-4 of the peak off the
    float64 chain (transient "zero"; up to 1.3e-5 "passthrough"), where the
    model stays within 3e-7: the fold rounds the canceller's cancellation
    into each entry, the kernel subtracts the chirps exactly first.  There
    the model is held to the float64 chain, and closer to it than both."""
    rng = np.random.default_rng(nd)
    re, im = _planes(nd, kind, rng)
    for notch in (2, 3):
        for transient in ("zero", "passthrough"):
            for bypass in (False, True):
                got = kernel_slowtime(re, im, notch, transient, bypass)
                exact = float64_chain(re, im, notch, transient, bypass)
                assert _spectra_close(got, exact) <= TOL
                twin = [t.numpy() for t in TF.doppler_apply(
                    torch.as_tensor(re), torch.as_tensor(im), bypass, notch,
                    transient)]
                mats = JFFT.doppler_matrices(nd, notch, transient)
                mr, mi = (mats[2], mats[3]) if bypass else (mats[0], mats[1])
                z = ((re.astype(np.float64) + 1j * im)
                     @ (mr.astype(np.float64) + 1j * mi))
                if kind == "clutter" and not bypass:
                    off = _spectra_close(got, exact)
                    assert off < _spectra_close(twin, exact)
                    assert off < _spectra_close((z.real, z.imag), exact)
                    continue
                assert _spectra_close(got, twin) <= TOL
                assert _spectra_close(got, (z.real, z.imag)) <= TOL, \
                    (notch, transient, bypass)


def test_slowtime_tables_layout():
    """The host tables: the float Q15 window, and tw[m] = exp(-2 pi i m /
    nd) rounded once from float64 to float32."""
    for nd in (16, 32, 64, 128):
        win, tw = (x.numpy() for x in F._slowtime_tables(nd, "cpu"))
        assert win.dtype == F32 and tw.dtype == F32 and tw.shape == (nd, 2)
        assert np.array_equal(win, hamming_float(nd))
        m = np.arange(nd)
        exact = np.exp(-2j * np.pi * m / nd)
        assert np.array_equal(tw[:, 0], exact.real.astype(F32))
        assert np.array_equal(tw[:, 1], exact.imag.astype(F32))
        assert np.abs(tw[:, 0] - exact.real).max() <= 2.0 ** -24
        assert np.abs(tw[:, 1] - exact.imag).max() <= 2.0 ** -24


# ---------------------------------------------------------------------------
# The CFAR decision
# ---------------------------------------------------------------------------

def _q_min(cut, sc):
    """detect_threshold on float32 arrays (bit probing below cut / sc)."""
    sf = sc.astype(F32)
    ti = (cut / sf).view(np.int32)
    q = (ti + 1).view(F32)
    for delta in (0, -1, -2):
        cand = (ti + delta).view(F32)
        q = np.where(cand * sf >= cut, cand, q)
    return q


def kernel_decide(mag, cfar, so, pgr, tile=F.TILE_ROWS):
    """The kernel's decision, grouping and counts of (B, R, D) float32
    magnitudes: (det, row_max, n_dets, nonfinite)."""
    with np.errstate(invalid="ignore", over="ignore"):
        return _kernel_decide(mag, cfar, so, pgr, tile)


def _kernel_decide(mag, cfar, so, pgr, tile):
    B, R, D = mag.shape
    T = min(tile, R)
    H = F._kernel_halo(cfar, pgr)
    E, rows = T + 2 * H, T + 2 * pgr
    hr, hd, gr, gd = (cfar.halo_range, cfar.halo_doppler, cfar.guard_range,
                      cfar.guard_doppler)
    k = cfar.n_ref - cfar.rank_idx
    n_ref = F32(cfar.n_ref)
    block = (C.block_scale_map(torch.as_tensor(mag), cfar).numpy()
             if cfar.scale_mode == "block" and not so else None)
    strips = sorted({min(st * STRIP, rows - STRIP)
                     for st in range(-(-rows // STRIP))})
    cols = np.arange(D)
    det = np.zeros_like(mag)
    for r0 in range(0, R, T):
        m = mag[:, (r0 - H + np.arange(E)) % R]           # the tile
        e_first = H - pgr
        ef = np.full((B, rows, D), -0.0, F32)            # column sums
        eg = np.full((B, rows, D), -0.0, F32)
        for dr in range(2 * hr + 1):
            v = m[:, e_first - hr + dr:e_first - hr + dr + rows]
            ef = ef + v
            if abs(dr - hr) <= gr:
                eg = eg + v
        det_t = np.zeros((B, rows, D), F32)
        for i0 in strips:
            e0 = e_first + i0
            cut = m[:, e0:e0 + STRIP]                     # (B, S, D)

            def walk(visit):
                for dd in range(-hd, hd + 1):
                    for dr in range(2 * hr + 1):
                        if abs(dd) <= gd and abs(dr - hr) <= gr:
                            continue
                        visit(m[:, e0 - hr + dr:e0 - hr + dr + STRIP]
                              [..., (cols + dd) % D])
            if so:
                sc = np.full(cut.shape, so, np.int32)
            elif block is not None:
                sc = block[:, (r0 - pgr + i0 + np.arange(STRIP)) % R]
            else:
                full = np.full(cut.shape, -0.0, F32)
                guard = np.full(cut.shape, -0.0, F32)
                for j in range(-hd, hd + 1):
                    full = full + ef[:, i0:i0 + STRIP][..., (cols + j) % D]
                for j in range(-gd, gd + 1):
                    guard = guard + eg[:, i0:i0 + STRIP][..., (cols + j) % D]
                mean = (full - guard) / n_ref
                t_hi, t_lo = F32(1.5) * mean, F32(0.5) * mean
                hl = np.zeros(cut.shape, np.int32)

                def count_hl(v):
                    nonlocal hl
                    hl = hl + np.where(v > t_hi, 0x10000, 0) + (v >= t_lo)
                walk(count_hl)
                hi, lo = hl >> 16, hl & 0xFFFF
                sc = np.where(hi >= k, cfar.scale_max,
                              np.where(lo < k, cfar.scale_min,
                                       cfar.scale_nom)).astype(np.int32)
            q = _q_min(cut, sc)
            cnt = np.zeros(cut.shape, np.int32)

            def count(v):
                nonlocal cnt
                cnt = cnt + (v >= q)
            walk(count)
            det_t[:, i0:i0 + STRIP] = np.where((cnt < k) & (cut > 0), cut,
                                               F32(0))
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
        det[:, r0:r0 + T] = np.where(keep, own, F32(0))
    row_max = np.where(det > 0, det, F32(0)).max(-1)
    n_dets = (det > 0).sum((-2, -1)).astype(np.int32)
    nonfinite = (~np.isfinite(mag)).sum((-2, -1)).astype(np.int32)
    return det, row_max, n_dets, nonfinite


VALUES = np.array([0, 0.25, 0.5, 1, 1.5, 2, 3, 4, 6, 8, 12, 16], F32)


def tie_map(rng, B, R, D, nonfinite=False):
    """Values from a small dyadic set, and a few targets (64, 128): every
    window sum is exact (so the sum order does not matter and JAX's stack
    sums agree), and training values often equal t_hi, t_lo or q.
    ``nonfinite``: a few NaN and inf cells too."""
    m = rng.choice(VALUES, size=(B, R, D), p=np.linspace(2, 1, 12) / 18)
    n = max(2, R * D // 512)                      # targets
    m[rng.integers(0, B, n), rng.integers(0, R, n),
      rng.integers(0, D, n)] = rng.choice(F32([64, 128]), n)
    if nonfinite:
        for v in (np.nan, np.inf):
            n = max(2, R * D // 256)
            m[rng.integers(0, B, n), rng.integers(0, R, n),
              rng.integers(0, D, n)] = v
    return m.astype(F32)


def _ties(mag, cfar):
    """Training values equal to their cell's t_hi or t_lo, and to q under
    scale 4."""
    m = torch.as_tensor(mag)
    hr, hd = cfar.halo_range, cfar.halo_doppler
    pad = C._wrap_pad(m, hr, hd)
    t_hi, t_lo = C.percell_thresholds(pad, cfar)
    q = C._q_min(m, torch.full_like(m, 4.0))
    R, D = m.shape[-2:]
    n = np.zeros(3, int)
    from fmcw_tpu_torch.golden.fixed_point import _window_offsets
    for dr, dd in _window_offsets(cfar):
        v = pad[..., hr + dr:hr + dr + R, hd + dd:hd + dd + D]
        n += [int((v == t).sum()) for t in (t_hi, t_lo, q)]
    return n


def _jax_decide(mag, jcfar, so, pgr, pallas=False):
    out = []
    for frame in mag:
        if pallas:
            d, _ = JP.cfar_2d_pallas_detect(jnp.asarray(frame), so, jcfar,
                                            interpret=True)
        else:
            d, _, _ = JC.cfar_2d(jnp.asarray(frame), so, jcfar)
        if pgr:
            d = JC.peak_group(d, pgr)
        out.append(np.asarray(d))
    return np.stack(out)


def _cfars(p, jp, mode):
    """The port's and JAX's CfarParams of ``p`` / ``jp`` in scale mode
    ``mode``."""
    return (dataclasses.replace(p.cfar, scale_mode=mode),
            dataclasses.replace(jp.cfar, scale_mode=mode))


@pytest.mark.parametrize("mode", ["cell", "block"])
@pytest.mark.parametrize("so", [0, 4])
@pytest.mark.parametrize("pgr", [0, 1, 2])
def test_decision_model_bitwise_on_ties(mode, so, pgr):
    """At 256x64 (the entry's CFAR, four tiles) the model equals the plain
    CFAR (``detect_plain``: cfar_2d, peak_group, row maxima, counts) and
    JAX's XLA cfar_2d + peak_group bit for bit on a tie-heavy map; the map
    meets ties at t_hi, t_lo and q."""
    p = fmcw_tpu_torch.RadarParams(n_range=256, n_doppler=64)
    cfar, jcfar = _cfars(p, fmcw_tpu.RadarParams(n_range=256, n_doppler=64),
                         mode)
    mag = tie_map(np.random.default_rng(10 * so + pgr), 2, 256, 64)
    if mode == "cell" and so == 0 and pgr == 0:
        assert (_ties(mag, cfar) > 0).all()
    got = kernel_decide(mag, cfar, so, pgr)
    want = F.detect_plain(torch.as_tensor(mag), cfar, so, pgr)
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
    assert np.array_equal(got[0], _jax_decide(mag, jcfar, so, pgr))
    assert got[2].min() > 0


@pytest.mark.parametrize("mode", ["cell", "block"])
def test_decision_model_bitwise_with_nonfinite(mode):
    """quick()'s 128x32 (two tiles of 64 rows) with NaN and inf cells: the
    model equals the plain CFAR bit for bit (decision, row maxima, counts,
    non-finite count) and JAX's counting kernel (interpret mode).  (JAX's
    XLA cfar_2d sorts a NaN training value above every other, where a count
    never counts it, so its order statistic differs there.)"""
    p = fmcw_tpu_torch.quick()
    cfar, jcfar = _cfars(p, fmcw_tpu.quick(), mode)
    for so, pgr in ((0, 1), (4, 2)):
        mag = tie_map(np.random.default_rng(so + pgr), 2, 128, 32, True)
        got = kernel_decide(mag, cfar, so, pgr)
        want = F.detect_plain(torch.as_tensor(mag), cfar, so, pgr)
        for g, w in zip(got, want):
            assert np.array_equal(g, w.numpy())
        assert got[3].min() > 0
        assert np.array_equal(got[0], _jax_decide(mag, jcfar, so, pgr, True))


def test_decision_model_on_the_frame():
    """The model's decision on the kernel model's own magnitudes of quick()'s
    two-target frame equals the plain CFAR's on them: the chain end to end,
    with the detections the golden targets give."""
    p = fmcw_tpu_torch.quick()
    iq = torch.as_tensor(tpl.complex_to_iq(tref.two_target_frame(p)))[None]
    re, im = (x.numpy() for x in F.range_fft_plain(iq))
    xr, xi = kernel_slowtime(re, im)
    mag = np.maximum(np.abs(xr), np.abs(xi)) + F32(0.375) * np.minimum(
        np.abs(xr), np.abs(xi))
    got = kernel_decide(mag.astype(F32), p.cfar, 0, 1)
    want = F.detect_plain(torch.as_tensor(mag), p.cfar, 0, 1)
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
    assert got[2][0] > 0
