"""Long CPIs (n_doppler = n2d x 128, n2d 2..16) in the fixed slow-time
kernel (fmcw_tpu_torch/csrc/slowtime_detect_fixed.cu's long row, then
csrc/slowtime_long.cuh's decide kernel on IntInFloat tiles) and the fused
fixed route that reaches it, held against the JAX package on the CPU.

* A numpy model of the long row in the kernel's order (``kernel_rows_long``:
  the saturating MTI and the Q15 window over the whole row, then per plane
  k2d the outer DFT_n2d over blocks of 128 chirps with the card's fused
  multiply-adds, the twiddle W_nd^(j1 k2d), the short rows' 128-point lane
  transform with the whole row's table at stride n2d, the exact eighth-turn
  bins on plane 0 only; the BFP exponent from the whole row), bit for bit
  against the JAX package's golden slow-time stages and the port's twin at
  nd 256, 512 and 2048 on frames, saturating frames, quarter-turn ties and
  eighth-turn tie planes; with a mutation check (without the plane-0
  exact bins).
* A numpy model of the decide kernel's chunks with the fixed semantics
  (``kernel_decide_long``: tiles of T rows x W columns, wrapped halos on
  both axes, the integer magnitudes held in float, box sums in int, the
  integer thresholds), bit for bit against the plain integer CFAR and JAX's
  XLA ``cfar_2d(integer=True)`` + ``peak_group`` on integer tie maps.
* JAX's tests/test_longcpi.py fixed cases at 256x256 (per-cell radius 0,
  block radius 2) on the port's fused fixed route: equal to the port's
  golden model bit for bit, detection sets, counts and saturations equal
  to JAX's XLA fixed chain, magnitudes within its 8 LSB; a LocalMesh at sp
  2 equal to one device.
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
from fmcw_tpu.golden import reference as jref
from fmcw_tpu.models import pipeline as jpl
from fmcw_tpu.ops import cfar as JC
from fmcw_tpu_torch.golden import fixed_point as tfx, reference as tref
from fmcw_tpu_torch.models import pipeline as tpl
from fmcw_tpu_torch.ops import cfar as C, fft as TF, frontend as F
from fmcw_tpu_torch.ops import frontend_fixed as FX
from fmcw_tpu_torch.parallel import LocalMesh, make_sharded_processor

from test_torch_slowtime_fixed_plan import (
    CW, F32, LSB, STRIP, _cmul, _count_quarter_ties, _exact_quarter_bins,
    _fma, _quarter_ties, _windowed, bfp_magnitude, golden_rows, int_tie_map,
    lane_dft)

# Share the CPU with the other test workers (the suite runs 6 at once).
torch.set_num_threads(2)

INNER = 128
NDS = (256, 512, 2048)
SRC = (Path(__file__).resolve().parents[1] / "fmcw_tpu_torch" / "csrc"
       / "slowtime_detect_fixed.cu").read_text()


def _kc3():
    """The source's sqrt(3)/2, parsed from its hex literal."""
    m = re.search(r"constexpr double kC3 = (\S+);", SRC)
    return float.fromhex(m.group(1))


# ---------------------------------------------------------------------------
# The long row
# ---------------------------------------------------------------------------

def kernel_rows_long(re, im, notch=2, transient="zero", bypass=False,
                     rounding="unbiased", exact=True):
    """The kernel's long row (``split_row<128>``) on every row of int16 planes
    (..., nd), nd = n2d x 128: (mag int64 (..., nd), Doppler-window
    saturations per row, the spectrum (xr, xi) before quantization, the
    windowed rows).  ``exact=False``: without the exact eighth-turn bins
    of plane 0 (the mutation check)."""
    nd = re.shape[-1]
    n2d = nd // INNER
    tw = FX._tables(nd, CW, "cpu")[1].numpy()
    x, sat = _windowed(re, im, notch, transient, bypass, rounding)
    zr = x[0].astype(np.float64).reshape(*re.shape[:-1], n2d, INNER)
    zi = x[1].astype(np.float64).reshape(*re.shape[:-1], n2d, INNER)
    j1 = np.arange(INNER)
    out_r = np.zeros(re.shape, np.float64)
    out_i = np.zeros(re.shape, np.float64)
    for k2d in range(n2d):
        ar, ai = zr[..., 0, :].copy(), zi[..., 0, :].copy()
        m = 0
        for j2 in range(1, n2d):
            m = (m + k2d) % n2d
            wr, wi = tw[m * INNER]
            br, bi = zr[..., j2, :], zi[..., j2, :]
            ar = _fma(br, wr, _fma(-bi, wi, ar))
            ai = _fma(br, wi, _fma(bi, wr, ai))
        if k2d:
            ar, ai = _cmul(ar, ai, tw[j1 * k2d, 0], tw[j1 * k2d, 1])
        else:
            # Plane 0: sums of integers, exact.
            assert np.array_equal(ar, np.round(ar))
        xr, xi = lane_dft(ar, ai, tw, n2d, exact and k2d == 0)
        out_r[..., k2d::n2d] = xr
        out_i[..., k2d::n2d] = xi
    if exact and n2d % 3 == 0:
        # twelfth_bins: all twelve bins m nd/12 from the class sums mod 12.
        t = [v.reshape(*v.shape[:-1], nd // 12, 12).sum(-2) for v in x]
        for m in range(12):
            er = ei = br = bi = 0
            for r in range(12):
                c2, c3, s2, s3 = TF.W12_PARTS[r * m % 12]
                er = er + (c2 * t[0][..., r] + s2 * t[1][..., r])
                ei = ei + (c2 * t[1][..., r] - s2 * t[0][..., r])
                br = br + (c3 * t[0][..., r] + s3 * t[1][..., r])
                bi = bi + (c3 * t[1][..., r] - s3 * t[0][..., r])
            out_r[..., m * nd // 12] = 0.5 * er + _kc3() * br
            out_i[..., m * nd // 12] = 0.5 * ei + _kc3() * bi
    return bfp_magnitude(out_r, out_i), sat, (out_r, out_i), x


def _hot(z):
    return (np.clip(z.real * 40, -32768, 32767)
            + 1j * np.clip(z.imag * 40, -32768, 32767))


def _frame_planes(nd, seed, nr=32, hot=False):
    """The golden range stage of a golden two-target frame (x 40, clipped,
    when ``hot``): range-major int16 planes (1, nr, nd)."""
    p = fmcw_tpu_torch.RadarParams(n_range=nr, n_doppler=nd)
    z = np.asarray(tref.two_target_frame(p, seed=seed))
    if hot:
        z = _hot(z)
    coef = tfx.hamming_coeffs(nr, CW)[None, :]
    i_w, q_w, _ = tfx.window_apply(z.real.astype(np.int64),
                                   z.imag.astype(np.int64), coef, CW,
                                   "unbiased")
    r, i = tfx.bfp_fft(i_w, q_w, axis=1)
    return r.T[None].astype(np.int16), i.T[None].astype(np.int16)


def _check_long_rows(re, im, notch, transient, bypass, rounding):
    """The long model's magnitudes and saturation counts equal the golden
    chain's and the twin's; its quarter-turn bins are the exact integers.
    Returns the windowed rows."""
    mag, sat, (xr, xi), x = kernel_rows_long(re, im, notch, transient,
                                             bypass, rounding)
    g_mag, g_sat = golden_rows(re, im, notch, transient, bypass, rounding)
    assert np.array_equal(mag, g_mag), (notch, transient, bypass, rounding)
    assert np.array_equal(sat, g_sat)
    t_mag, t_sat = FX.slowtime_mag_fixed_plain(
        torch.as_tensor(re), torch.as_tensor(im), bypass, notch, transient,
        CW, rounding)
    assert np.array_equal(mag, t_mag.numpy())
    assert np.array_equal(sat.sum(-1), t_sat.numpy())
    nd = re.shape[-1]
    for m, (er, ei) in enumerate(_exact_quarter_bins(x)):
        assert np.array_equal(xr[..., m * nd // 4], er)
        assert np.array_equal(xi[..., m * nd // 4], ei)
    return x


@pytest.mark.parametrize("nd", NDS)
def test_long_row_model_equals_golden_and_twin(nd):
    """A golden two-target frame and a saturating x40 copy through the
    golden range stage; every MTI option on the frame (the first two at
    2048), the default chain and the bypass (where the window saturates)
    on the hot copy; quarter-turn ties (bin 0 with the MTI bypassed,
    ``golden.reference.doppler_quarter_tie_planes``, both roundings; bin
    nd/2 through the 3-pulse canceller, below 2048) and eighth-turn tie
    planes (bin
    nd/8, both roundings): the long model equals the golden chain and the
    twin bit for bit, and the ties tie."""
    opts = [(2, "zero", False, "unbiased"), (3, "passthrough", False,
                                             "biased"),
            (2, "zero", True, "unbiased"), (3, "zero", True, "biased")]
    re, im = _frame_planes(nd, nd)
    for o in (opts if nd < 2048 else opts[:2]):
        _check_long_rows(re, im, *o)
    re, im = _frame_planes(nd, nd + 1, hot=True)
    sats = 0
    for o in (opts[0], opts[2]):
        _check_long_rows(re, im, *o)
        sats += int(kernel_rows_long(re, im, *o)[1].sum())
    assert sats > 0
    for rounding in ("unbiased", "biased"):
        re, im = tref.doppler_quarter_tie_planes(nd, 1, 8, nd, rounding)
        x = _check_long_rows(re, im, 2, "zero", True, rounding)
        assert _count_quarter_ties(x) == 8
    if nd < 2048:       # the search below takes ~2.5 s a row at 2048
        o = (3, "passthrough", False, "biased")
        re, im = _quarter_ties(nd, np.random.default_rng(100 + nd), *o,
                               rows=8)
        x = _check_long_rows(re, im, *o)
        assert _count_quarter_ties(x) >= 2
    for rounding in ("unbiased", "biased"):
        re, im = tref.doppler_eighth_tie_planes(nd, 1, 8, nd, rounding)
        x = _check_long_rows(re, im, 2, "zero", True, rounding)
        assert tref.eighth_turn_ties(*x)[1].all()


def test_mutation_without_plane0_exact_bins():
    """The mutation check: without the exact eighth-turn bins of plane 0
    the long model misses ties of ``doppler_eighth_tie_planes`` (128 rows
    at nd 256 and 512, 32 at 2048) that the golden chain rounds the other
    way (the bin sums the inner transform's fused W_8 products, whose
    rounding residues need not cancel).  With them it equals the golden
    chain."""
    missed = {}
    for nd, rows in ((256, 128), (512, 128), (2048, 32)):
        re, im = tref.doppler_eighth_tie_planes(nd, 1, rows, nd)
        g_mag, _ = golden_rows(re, im, 2, "zero", True, "unbiased")
        got = kernel_rows_long(re, im, bypass=True)[0]
        mut = kernel_rows_long(re, im, bypass=True, exact=False)[0]
        assert np.array_equal(got, g_mag)
        missed[nd] = int((mut != g_mag).any(-1).sum())
    assert min(missed.values()) > 0, missed


def _noisy_planes(nd, seed, nr=128, rows=96):
    """The golden range stage of the golden two-target frame plus seeded
    +-8 noise (chip_smoke.make_batch's stimulus), its first ``rows`` range
    rows: many noise rows small enough to quantize with no BFP shift, where
    a sixth- or twelfth-turn bin whose sqrt(3)/2 part is 0 is an exact
    half-LSB tie."""
    p = fmcw_tpu_torch.RadarParams(n_range=nr, n_doppler=nd)
    rng = np.random.default_rng(seed)
    iq = tpl.complex_to_iq(tref.two_target_frame(p))
    iq = iq + rng.integers(-8, 8, iq.shape).astype(np.int16)
    coef = tfx.hamming_coeffs(nr, CW)[None, :]
    i_w, q_w, _ = tfx.window_apply(iq[..., 0].astype(np.int64),
                                   iq[..., 1].astype(np.int64), coef, CW,
                                   "unbiased")
    r, i = tfx.bfp_fft(i_w, q_w, axis=1)
    return r.T[None, :rows].astype(np.int16), i.T[None, :rows].astype(np.int16)


@pytest.mark.parametrize("nd", [384, 768])
def test_long_row_model_where_3_divides_n2d(nd):
    """n2d = 3 and 6 (nd 384, 768): the long model equals the twin bit for
    bit (the sixth- and twelfth-turn bins exact in both, ``ops/fft.
    _twelfth_turn_bins``) on noisy frames, every MTI option; without the
    exact bins it differs (the mutation check).  The golden chain's
    np.fft.fft (mixed radix at these lengths) need not give the exact bins
    exactly and rounds some of their exact ties the other way: every
    magnitude it gives otherwise is the model's, and the ones that differ
    sit at bins k with 24 k / nd whole (quarter, eighth, sixth and twelfth
    turns)."""
    missed = off_bins = 0
    for seed, o in enumerate(((2, "zero", False, "unbiased"),
                              (3, "passthrough", False, "biased"),
                              (2, "zero", True, "unbiased"))):
        re, im = _noisy_planes(nd, seed)
        mag, sat = kernel_rows_long(re, im, *o)[:2]
        t_mag, t_sat = FX.slowtime_mag_fixed_plain(
            torch.as_tensor(re), torch.as_tensor(im), o[2], o[0], o[1], CW,
            o[3])
        assert np.array_equal(mag, t_mag.numpy())
        assert np.array_equal(sat.sum(-1), t_sat.numpy())
        missed += int((kernel_rows_long(re, im, *o, exact=False)[0]
                       != mag).sum())
        g_mag, g_sat = golden_rows(re, im, *o)
        assert np.array_equal(sat, g_sat)
        bins = np.argwhere(g_mag != mag)[:, -1]
        assert (bins * 24 % nd == 0).all(), bins
        off_bins += bins.size
    assert missed > 0


def test_source_constants():
    """The fixed kernel's sqrt(3)/2 is the nearest double to it and the
    twin's (``ops/fft.C3``; np.cos(pi / 6) is one ulp above); its W_12
    table is the twin's and holds cos and sin of pi j / 6."""
    from decimal import Decimal, getcontext
    getcontext().prec = 50
    c3 = _kc3()
    assert c3 == TF.C3
    exact = Decimal(3).sqrt() / 2
    for other in (np.nextafter(c3, 0), np.nextafter(c3, 1)):
        assert abs(Decimal(c3) - exact) < abs(Decimal(float(other)) - exact)
    m = re.search(r"kW12\[12\] = \{(.*?)\};", SRC, re.S)
    rows = [tuple(int(v) for v in t.split(","))
            for t in re.findall(r"\{([-\d, ]+)\}", m.group(1))]
    assert rows == list(TF.W12_PARTS)
    for j, (c2, cc, s2, sc) in enumerate(rows):
        assert np.isclose(c2 / 2 + cc * c3, np.cos(np.pi * j / 6))
        assert np.isclose(s2 / 2 + sc * c3, np.sin(np.pi * j / 6))


def test_long_tables_and_exact_plane():
    """The long row reads the whole row's table (ops/fft.twiddles64(nd)):
    W_n2d^m at tw[128 m] and the inner transform's W_128^j at tw[j n2d]
    are the exact quarter turns wherever j is a multiple of 32 (so plane
    0's quarter-turn path multiplies by 1, -1, i and -i only); every
    quarter- and eighth-turn bin m nd/8 is a multiple of n2d, so it lies
    on plane 0."""
    exact = {(1.0, 0.0), (0.0, -1.0), (-1.0, 0.0), (0.0, 1.0)}
    for nd in range(256, 2049, 128):
        n2d = nd // INNER
        tw = FX._tables(nd, CW, "cpu")[1].numpy()
        for j in range(0, INNER, 32):
            assert (tw[j * n2d, 0], tw[j * n2d, 1]) in exact
        for m in range(8):
            assert (m * nd // 8) % n2d == 0
        if n2d in (2, 4):
            assert (tw[INNER * (n2d // 2), 0], tw[INNER * (n2d // 2), 1]) \
                == (-1.0, 0.0)


# ---------------------------------------------------------------------------
# The decide kernel's chunks on an int32 map
# ---------------------------------------------------------------------------

def kernel_decide_long(mag, cfar, so, pgr, hc=None):
    """The decide kernel's decision, grouping and counts of (B, R, D)
    integer magnitudes at a long CPI with the fixed semantics: tiles of T
    rows x W columns (``ops/frontend._slowtime_config``, the fixed
    kernels' tile: ``int_map``) with H halo rows
    and HC halo columns (``hc`` overrides it), wrapped; the T + 2 pgr rows
    and W + 2 pgr columns the grouping reads decided in strips of 8 cells;
    full and guard column sums once per tile in float32 (asserted exact);
    box sums in int, the floor mean, t_hi, t_lo and q in the integer
    semantics, converted to float32; hi and lo counted in float32, packed
    as hi 4096 + lo; the grouping with global ids.  Block scale takes the
    twin's ``block_scale_map``.  Returns (det, row_max, n_dets), int64."""
    mag = mag.astype(np.int64)
    B, R, D = mag.shape
    cfg = F._slowtime_config(B, R, D, cfar, so, pgr, int_map=True)
    T, W, H = cfg.T, cfg.W, cfg.H
    HC = cfg.HC if hc is None else hc
    E, WC, rows = T + 2 * H, W + 2 * HC, T + 2 * pgr
    assert E <= 128
    hr, hd, gr, gd = (cfar.halo_range, cfar.halo_doppler, cfar.guard_range,
                      cfar.guard_doppler)
    k = cfar.n_ref - cfar.rank_idx
    block = (C.block_scale_map(torch.as_tensor(mag), cfar).numpy()
             if cfar.scale_mode == "block" and not so else None)
    strips = sorted({min(st * STRIP, rows - STRIP)
                     for st in range(-(-rows // STRIP))})
    dcols = HC - pgr + np.arange(W + 2 * pgr)
    det = np.zeros_like(mag)
    for r0 in range(0, R, T):
        for c0 in range(0, D, W):
            gcols = (c0 - HC + np.arange(WC)) % D
            m = mag[:, (r0 - H + np.arange(E)) % R][..., gcols]
            mf = m.astype(F32)
            assert np.array_equal(mf.astype(np.int64), m)
            e_first = H - pgr
            ef = np.full((B, rows, WC), -0.0, F32)
            eg = np.full((B, rows, WC), -0.0, F32)
            for dr in range(2 * hr + 1):
                v = mf[:, e_first - hr + dr:e_first - hr + dr + rows]
                ef = ef + v
                if abs(dr - hr) <= gr:
                    eg = eg + v
            assert ef.max() < 2 ** 24
            det_t = np.zeros((B, rows, WC), np.int64)
            for i0 in strips:
                e0 = e_first + i0
                cut = m[:, e0:e0 + STRIP][..., dcols]

                def walk(visit):
                    for dd in range(-hd, hd + 1):
                        # The plan's windows stay inside the tile; a short
                        # halo (the mutation) wraps within it.
                        assert hc is not None or (
                            0 <= dcols[0] + dd and dcols[-1] + dd < WC)
                        for dr in range(2 * hr + 1):
                            if abs(dd) <= gd and abs(dr - hr) <= gr:
                                continue
                            visit(mf[:, e0 - hr + dr:e0 - hr + dr + STRIP]
                                  [..., (dcols + dd) % WC])
                if so:
                    sc = np.full(cut.shape, so, np.int64)
                elif block is not None:
                    sc = block[:, (r0 - pgr + i0 + np.arange(STRIP)) % R][
                        ..., gcols[dcols]]
                else:
                    full = sum(ef[:, i0:i0 + STRIP][..., (dcols + j) % WC]
                               .astype(np.int64) for j in range(-hd, hd + 1))
                    guard = sum(eg[:, i0:i0 + STRIP][..., (dcols + j) % WC]
                                .astype(np.int64) for j in range(-gd, gd + 1))
                    mean = (full - guard) // cfar.n_ref
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
                q = ((cut - 1) // sc + 1).astype(F32)
                cnt = np.zeros(cut.shape, F32)

                def count(v):
                    nonlocal cnt
                    cnt = cnt + (v >= q).astype(F32)
                walk(count)
                blk = det_t[:, i0:i0 + STRIP]
                blk[..., dcols] = np.where((cnt < k) & (cut > 0), cut, 0)
            own = det_t[:, pgr:pgr + T, HC:HC + W]
            keep = own > 0
            rid = (r0 + np.arange(T))[:, None]
            cid = c0 + np.arange(W)
            ids = rid * D + cid
            for dr in range(-pgr, pgr + 1):
                for dd in range(-pgr, pgr + 1):
                    if dr == 0 and dd == 0:
                        continue
                    v = det_t[:, pgr + dr:pgr + dr + T, HC + dd:HC + dd + W]
                    nid = ((rid + dr) % R) * D + (cid + dd) % D
                    keep &= ~((v > own) | ((v == own) & (nid < ids)))
            det[:, r0:r0 + T, c0:c0 + W] = np.where(keep, own, 0)
    return det, det.max(-1), (det > 0).sum((-2, -1))


def _jax_int_decide(mag, jcfar, so, pgr):
    out = []
    for frame in mag:
        d, _, _ = JC.cfar_2d(jax.numpy.asarray(frame, jax.numpy.int32), so,
                             jcfar, integer=True)
        out.append(np.asarray(JC.peak_group(d, pgr) if pgr else d))
    return np.stack(out)


@pytest.mark.parametrize("mode,so,pgr", [
    ("cell", 0, 0), ("cell", 0, 2), ("cell", 4, 1), ("block", 0, 2),
    ("block", 6, 0)])
def test_decide_model_bitwise_on_int_ties(mode, so, pgr):
    """At 128x256 (two row tiles, two or four column chunks, the entry's
    window; block scale at sb 2) the fixed decide model equals the plain
    integer CFAR and grouping (``detect_plain``: det, row maxima, counts)
    and JAX's XLA cfar_2d(integer=True) + peak_group bit for bit on an
    integer map whose training values meet t_hi, t_lo and q, with targets
    at the chain's largest magnitude (45,056)."""
    cfar = fmcw_tpu_torch.CfarParams(scale_mode=mode, scale_block=2)
    mag = int_tie_map(np.random.default_rng(10 * so + pgr), 1, 128, 256)
    got = kernel_decide_long(mag, cfar, so, pgr)
    want = F.detect_plain(torch.as_tensor(mag, dtype=torch.int32), cfar, so,
                          pgr)
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
    jcfar = fmcw_tpu.CfarParams(**dataclasses.asdict(cfar))
    assert np.array_equal(got[0], _jax_int_decide(mag, jcfar, so, pgr))
    assert got[2].min() > 0


def test_decide_model_needs_its_column_halo():
    """Mutation check on the int map: ones with a wall of 1000s in the
    column a chunk's first cells see last (hd columns to their left, in the
    chunk before) and a 3 at one such cell: the wall lowers that cell's
    scale class to scale_min (3 > 1 x 2, detected).  The model equals the
    plain integer CFAR; with a column halo one short it differs."""
    cfar = fmcw_tpu_torch.CfarParams()
    cfg = F._slowtime_config(1, 128, 256, cfar, 0, 0)
    mag = np.ones((1, 128, 256), np.int64)
    mag[0, :, cfg.W - cfar.halo_doppler] = 1000
    mag[0, 40, cfg.W] = 3
    want = F.detect_plain(torch.as_tensor(mag, dtype=torch.int32), cfar, 0,
                          0)
    assert want[0][0, 40, cfg.W] == 3
    got = kernel_decide_long(mag, cfar, 0, 0)
    assert all(np.array_equal(g, w.numpy()) for g, w in zip(got, want))
    got = kernel_decide_long(mag, cfar, 0, 0, hc=cfg.HC - 1)
    assert got[0][0, 40, cfg.W] == 0


def test_fixed_long_geometry_fits_the_kernel():
    """Every long CPI (n2d 2..16) at the repository's windows, per-cell and
    block, radius 0..8, gets a decide tile that the fixed entries take
    (``frontend_fixed.fixed_config``: T + 2H <= 128 rows, so an IntInFloat
    column sum of 45,056s stays below 2^24), and
    ``fused_fixed_detect_supported`` says so; 100 and 4096 chirps are
    refused (192, a dense length, is taken: tests/test_torch_fixed_dense.
    py)."""
    for nd in range(256, 2049, 128):
        for cfar in (fmcw_tpu_torch.CfarParams(),
                     fmcw_tpu_torch.CfarParams(scale_mode="block"),
                     fmcw_tpu_torch.quick().cfar):
            for pgr in (0, 2, 8):
                c = FX.fixed_config(
                    F._slowtime_config(1, 1024, nd, cfar, 0, pgr), cfar, 2,
                    "zero", False, CW, "unbiased", "t")
                assert c.T + 2 * c.H <= 128
                assert (c.T + 2 * c.H) * 45056 < 2 ** 24
                p = fmcw_tpu_torch.RadarParams(n_doppler=nd, cfar=cfar)
                assert FX.fused_fixed_detect_supported(p, pgr)
    for nd in (100, 4096):
        p = fmcw_tpu_torch.RadarParams(n_doppler=nd)
        assert not FX.fused_fixed_detect_supported(p)
    assert FX.fused_fixed_detect_supported(
        fmcw_tpu_torch.RadarParams(n_doppler=192))


# ---------------------------------------------------------------------------
# The fused fixed route
# ---------------------------------------------------------------------------

P = fmcw_tpu_torch.RadarParams(n_range=256, n_doppler=256)


def _jparams(p):
    return fmcw_tpu.RadarParams(
        n_range=p.n_range, n_doppler=p.n_doppler,
        cfar=fmcw_tpu.CfarParams(**dataclasses.asdict(p.cfar)))


@pytest.mark.parametrize("scale_mode,pg", [("cell", 0), ("block", 2)])
def test_fused_fixed_route_matches_golden_and_xla_chain(scale_mode, pg):
    """JAX's test_longcpi_fixed_fused_matches_xla_chain cases (256x256,
    scale_block 2) on the port's fused fixed route (its twins here): the
    route is "fused", no plain stage but the twins; det_map, mag_map and
    saturation_count equal the port's golden model bit for bit; the
    detection set, valid detections and n_dets equal JAX's XLA fixed chain
    (``make_processor(mode="fixed", include_maps=True)``), its magnitudes
    within that test's 8 LSB and its saturation count equal."""
    p = P.replace(cfar=dataclasses.replace(P.cfar, scale_mode=scale_mode,
                                           scale_block=2))
    z = np.asarray(tref.two_target_frame(p, seed=3))
    frame = tpl.complex_to_iq(z)
    proc = tpl.make_batch_processor(p, mode="fixed", frontend="fused",
                                    include_maps=True, peak_group_radius=pg,
                                    device="cpu")
    assert proc.route == "fused"
    out = {k: v[0] for k, v in proc(frame[None]).items()}
    mag, det = tref.process_frame_fixed(z, p)
    if pg:
        det = tfx.peak_group(det, pg)
    assert np.array_equal(out["det_map"].numpy(), det)
    assert np.array_equal(out["mag_map"].numpy(), mag)
    gmag, gdet = jref.process_frame_fixed(z, _jparams(p))
    assert np.array_equal(mag, gmag)
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
    assert (set(zip(out["range_bin"].numpy()[v].tolist(),
                    out["doppler_bin"].numpy()[v].tolist()))
            == set(zip(ref["range_bin"][v].tolist(),
                       ref["doppler_bin"][v].tolist())))


def test_local_mesh_equals_single_device():
    """The sharded processor on a LocalMesh at sp 2 (the fixed range
    kernel's chirp shards, the fixed split entry on the range shards with
    its halo rows: their twins here) equals the single-device fused fixed
    route at 128x256, every output; fixed "auto" stays the staged route."""
    p = fmcw_tpu_torch.RadarParams(n_range=128, n_doppler=256)
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
