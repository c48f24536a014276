"""The dense lengths in fixed mode (n_doppler a multiple of 8 below 2048
that is neither 16, 32, 64, 128 nor n2d x 128): the fixed slow-time
kernel's dense operator (fmcw_tpu_torch/csrc/slowtime_detect_fixed.cu
``split_row<m>``, then csrc/slowtime_long.cuh's decide kernel on
IntInFloat tiles) and the fused fixed route that reaches it, held against
the JAX package on the CPU.

JAX's fixed kernels contract the chirp axis with the dense DFT matrix
there (``_doppler_split`` is 1); the port's twin is the dense float64
product (``ops/fft.dft64_apply``, with the exact eighth- and twelfth-turn
bins), and the kernel runs an o x m FFT instead:

* a numpy model of the kernel's row plan, step by step
  (``kernel_rows_dense``): nd = o x m with m = nd & -nd (8 .. 64), o odd;
  the saturating MTI and the Q15 window over the whole row; for every
  class k2 < o the outer DFT_o over the blocks of m chirps as direct sums
  with the card's fused multiply-adds in the kernel's order (W_o^e = tw[e
  m]), the twiddle W_nd^(j1 k2), the short rows' m-point lane transform on
  the whole row's table at stride o, the exact eighth-turn bins on class 0
  only (at m 8 .. 32 from class 0's class sums), bin q of class k2 at o q
  + k2; where 3 divides o the twelve bins nd/12 from the chirps' class
  sums; the BFP exponent from the whole row — bit for bit against the
  port's twin at 8, 24, 40, 48, 80, 96, 120, 160, 192, 320, 360, 1016,
  1984 and 2040 (o 1 .. 255, every m, 3 | o) on noisy frames, the
  saturating x40 batch and quarter-, eighth- and (3 | o) twelfth-turn tie
  planes; the golden model (np.fft.fft) differs only at exact bins; the
  mutation checks (without class 0's exact eighth-turn bins, without the
  twelve exact bins nd/12) fail;
* the map kernel's shared memory (``ops/frontend_fixed.map_warp_bytes``)
  and the int32 map's decide tile at all 237 lengths, whole frame and sp 2
  shards;
* fixed "fused" on the CPU (the kernels' twins) at 256x96 and 128x24,
  per-cell, block and CA, against JAX's XLA fixed chain on its own
  contract (tests/test_frontend_fixed.py: detection set and count, valid
  top-K, saturation count, magnitudes within 8 LSB) and against the port's
  golden model, equal but at located exact bins; once JAX's fused fixed
  kernel (interpret mode) at 128x24; the launches under the ``as_if_cuda``
  stand-in; a LocalMesh at sp 2 equal to one device.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import fmcw_tpu
import fmcw_tpu_torch
from fmcw_tpu.models import pipeline as jpl
from fmcw_tpu_torch import kernels
from fmcw_tpu_torch.golden import fixed_point as tfx, reference as tref
from fmcw_tpu_torch.models import pipeline as tpl
from fmcw_tpu_torch.ops import fft as TF, frontend as F
from fmcw_tpu_torch.ops import frontend_fixed as FX
from fmcw_tpu_torch.ops import split_frontend as SF
from fmcw_tpu_torch.parallel import LocalMesh, make_sharded_processor
from fmcw_tpu_torch.parallel import sharded as SH

from test_torch_fixed_longcpi import _kc3, _noisy_planes, _frame_planes
from test_torch_isolation import as_if_cuda  # noqa: F401 (a fixture)
from test_torch_slowtime_fixed_plan import (
    CW, LSB, SRC, _cmul, _fma, _windowed, bfp_magnitude, golden_rows,
    lane_dft)

# Share the CPU with the other test workers (the suite runs 6 at once).
torch.set_num_threads(2)

DENSE = tuple(nd for nd in range(8, 2049, 8) if F.dense_cpi(nd))
# Every inner transform m (8 .. 64), o from 1 to 255, and 3 | o (24, 48,
# 96, 120, 192, 360, 2040).
MODEL_NDS = (8, 24, 40, 48, 80, 96, 120, 160, 192, 320, 360, 1016, 1984,
             2040)
MTI = ((2, "zero", False, "unbiased"), (3, "passthrough", False, "biased"),
       (3, "zero", False, "unbiased"), (2, "passthrough", True, "biased"))


def exact_bin(k, nd):
    """A quarter-, eighth-, sixth- or twelfth-turn bin: 24 k / nd whole
    (ROADMAP fault 5: the golden model's mixed-radix np.fft.fft need not
    give these exactly)."""
    return k * 24 % nd == 0


# ---------------------------------------------------------------------------
# The dense row
# ---------------------------------------------------------------------------

def kernel_rows_dense(re, im, notch=2, transient="zero", bypass=False,
                      rounding="unbiased", eighth=True, twelfth=True):
    """The kernel's dense row (``split_row<m>``) on every row of int16
    planes (..., nd), every class at once: (mag int64 (..., nd),
    Doppler-window saturations per row, the spectrum (xr, xi) before
    quantization, the windowed rows).  ``eighth=False``, ``twelfth=False``:
    without class 0's exact eighth-turn bins, without the exact twelve
    bins nd/12 (the mutation checks)."""
    nd = re.shape[-1]
    o, m = FX.map_split(nd)
    assert o * m == nd and o % 2 == 1 and m in (8, 16, 32, 64)
    tw = FX._tables(nd, CW, "cpu")[1].numpy()
    x, sat = _windowed(re, im, notch, transient, bypass, rounding)
    zr = x[0].astype(np.float64).reshape(*re.shape[:-1], o, m)
    zi = x[1].astype(np.float64).reshape(*re.shape[:-1], o, m)
    k2 = np.arange(o)
    ar = np.repeat(zr[..., :1, :], o, axis=-2)
    ai = np.repeat(zi[..., :1, :], o, axis=-2)
    for j2 in range(1, o):
        e = (j2 * k2) % o                       # the kernel's e += k2 mod o
        wr, wi = tw[e * m, 0][:, None], tw[e * m, 1][:, None]
        br, bi = zr[..., j2:j2 + 1, :], zi[..., j2:j2 + 1, :]
        ar, ai = (_fma(br, wr, _fma(-bi, wi, ar)),
                  _fma(br, wi, _fma(bi, wr, ai)))
    j = np.outer(k2, np.arange(m)) % nd         # W_nd^(j1 k2)
    tr, ti = _cmul(ar, ai, tw[j, 0], tw[j, 1])
    ar = np.where(k2[:, None] > 0, tr, ar)
    ai = np.where(k2[:, None] > 0, ti, ai)
    # Class 0: sums of integers, exact.
    y0 = np.stack([ar[..., 0, :], ai[..., 0, :]])
    assert np.array_equal(y0, np.round(y0))
    u1 = None
    if m <= 32:
        # One point a lane: class sums T_r over the lane group, u_r = T_r
        # - T_(r+4) (eighth_sums).
        t = [v.astype(np.int64).reshape(*v.shape[:-1], m // 8, 8).sum(-2)
             for v in y0]
        u1 = [t[c][..., r] - t[c][..., r + 4] for r in range(4)
              for c in (0, 1)]
    out_r = np.zeros(re.shape, np.float64)
    out_i = np.zeros(re.shape, np.float64)
    xr, xi = lane_dft(ar[..., 0, :], ai[..., 0, :], tw, o, eighth, u1)
    out_r[..., 0::o], out_i[..., 0::o] = xr, xi
    if o > 1:
        xr, xi = lane_dft(ar[..., 1:, :], ai[..., 1:, :], tw, o, False)
        for c in range(1, o):
            out_r[..., c::o] = xr[..., c - 1, :]
            out_i[..., c::o] = xi[..., c - 1, :]
    if twelfth and o % 3 == 0:
        # twelfth_bins: all twelve bins j nd/12 from the class sums mod 12.
        t = [v.reshape(*v.shape[:-1], nd // 12, 12).sum(-2) for v in x]
        for q in range(12):
            er = ei = br = bi = 0
            for r in range(12):
                c2, c3, s2, s3 = TF.W12_PARTS[r * q % 12]
                er = er + (c2 * t[0][..., r] + s2 * t[1][..., r])
                ei = ei + (c2 * t[1][..., r] - s2 * t[0][..., r])
                br = br + (c3 * t[0][..., r] + s3 * t[1][..., r])
                bi = bi + (c3 * t[1][..., r] - s3 * t[0][..., r])
            out_r[..., q * nd // 12] = 0.5 * er + _kc3() * br
            out_i[..., q * nd // 12] = 0.5 * ei + _kc3() * bi
    return bfp_magnitude(out_r, out_i), sat, (out_r, out_i), x


def _twin(re, im, notch, transient, bypass, rounding):
    mag, sat = FX.slowtime_mag_fixed_plain(
        torch.as_tensor(re), torch.as_tensor(im), bypass, notch, transient,
        CW, rounding)
    return mag.numpy(), sat.numpy()


def _check_dense_rows(re, im, notch, transient, bypass, rounding):
    """The dense model's magnitudes and saturations equal the twin's bit
    for bit; the golden chain's (np.fft.fft) saturations equal and its
    magnitudes differ at exact bins only.  Returns the windowed rows."""
    mag, sat, _, x = kernel_rows_dense(re, im, notch, transient, bypass,
                                       rounding)
    t_mag, t_sat = _twin(re, im, notch, transient, bypass, rounding)
    o = (notch, transient, bypass, rounding)
    assert np.array_equal(mag, t_mag), (re.shape[-1], o)
    assert np.array_equal(sat.sum(-1), t_sat)
    g_mag, g_sat = golden_rows(re, im, notch, transient, bypass, rounding)
    assert np.array_equal(sat, g_sat)
    bins = np.argwhere(g_mag != mag)[:, -1]
    assert all(exact_bin(int(k), re.shape[-1]) for k in bins), bins
    return x


def _eighth_ties(nd, rows, rounding="unbiased"):
    """doppler_eighth_tie_planes from the first seed at nd that reaches
    its ties (none at 8: too few chirps)."""
    for seed in range(nd, nd + 8):
        try:
            return tref.doppler_eighth_tie_planes(seed, 1, rows, nd,
                                                  rounding)
        except ValueError:
            continue
    return None


@pytest.mark.parametrize("nd", MODEL_NDS)
def test_dense_row_model_equals_the_twin(nd):
    """At each length: the golden two-target frame with seeded +-8 noise
    through the golden range stage (noise rows that quantize with no BFP
    shift, where a sixth- or twelfth-turn bin whose sqrt(3)/2 part is 0 is
    an exact half-LSB tie), an MTI and window option in turn; the
    saturating x40 frame with the MTI on and bypassed (the window
    saturates); quarter-turn tie planes (bin 0), eighth-turn tie planes
    (bin nd/8) and, where 3 divides o, twelfth-turn tie planes (bins j
    nd/12), MTI bypassed: the dense model equals the twin bit for bit, the
    golden chain but at exact bins, and the ties tie."""
    i = MODEL_NDS.index(nd)
    rows = 24 if nd <= 512 else 6
    re, im = _noisy_planes(nd, nd, nr=64, rows=rows)
    _check_dense_rows(re, im, *MTI[i % len(MTI)])
    re, im = _frame_planes(nd, nd + 1, nr=32, hot=True)
    re, im = re[:, :rows], im[:, :rows]
    sats = 0
    for o in (MTI[0], (2, "zero", True, "unbiased")):
        _check_dense_rows(re, im, *o)
        sats += int(kernel_rows_dense(re, im, *o)[1].sum())
    assert sats > 0
    rounding = ("unbiased", "biased")[i % 2]
    re, im = tref.doppler_quarter_tie_planes(nd, 1, 8, nd, rounding)
    _check_dense_rows(re, im, 2, "zero", True, rounding)
    ties = _eighth_ties(nd, 8, rounding)
    assert (ties is None) == (nd == 8)
    if ties is not None:
        x = _check_dense_rows(*ties, 2, "zero", True, rounding)
        assert tref.eighth_turn_ties(*x)[1].all()
    if FX.map_split(nd)[0] % 3 == 0:
        re, im = tref.doppler_twelfth_tie_planes(nd, 1, 8, nd, rounding)
        _check_dense_rows(re, im, 2, "zero", True, rounding)


@pytest.mark.parametrize("kind", ["eighth", "twelfth"])
def test_mutation_without_class0_exact_bins(kind):
    """The mutation checks: without class 0's exact eighth-turn bins the
    dense model misses ties of ``doppler_eighth_tie_planes`` that the twin
    rounds the exact way, at m = 8, 16, 32 (class sums) and 64 (the DIF
    outputs); without the twelve exact bins nd/12, ties of
    ``doppler_twelfth_tie_planes`` at 3 | o (m = 8 .. 64, o 3 .. 45); with
    them it equals the twin."""
    missed = {}
    for nd in ((40, 48, 96, 192) if kind == "eighth"
               else (24, 48, 96, 192, 360)):
        re, im = (_eighth_ties(nd, 64) if kind == "eighth"
                  else tref.doppler_twelfth_tie_planes(nd, 1, 32, nd))
        t_mag, _ = _twin(re, im, 2, "zero", True, "unbiased")
        got = kernel_rows_dense(re, im, bypass=True)[0]
        mut = kernel_rows_dense(re, im, bypass=True,
                                **{kind: False})[0]
        assert np.array_equal(got, t_mag)
        missed[nd] = int((mut != t_mag).any(-1).sum())
    assert len([v for v in missed.values() if v]) >= 3, missed


def test_dense_tables_and_exact_class():
    """The dense row reads the whole row's table (ops/fft.twiddles64(nd)):
    W_o^e at tw[e m] (W_o^0 = tw[0] = 1 exactly: class 0's outer sums are
    integer sums) and the inner transform's W_m^j at tw[j o], exact at the
    quarter turns j = m/4 ...; every quarter- and eighth-turn bin j nd/8
    is a multiple of o (class 0), and where 3 divides o every twelfth-turn
    bin j nd/12 lies on class 0, o/3 or 2o/3."""
    exact = {(1.0, 0.0), (0.0, -1.0), (-1.0, 0.0), (0.0, 1.0)}
    threes = 0
    for nd in DENSE:
        o, m = FX.map_split(nd)
        tw = FX._tables(nd, CW, "cpu")[1].numpy()
        assert (tw[0, 0], tw[0, 1]) == (1.0, 0.0)
        for j in range(0, m, m // 4):
            assert (tw[j * o, 0], tw[j * o, 1]) in exact
        w_o = np.exp(-2j * np.pi * np.arange(o) / o)
        assert np.abs(tw[np.arange(o) * m, 0] - w_o.real).max() < 1e-15
        for j in range(8):
            assert (j * nd // 8) % o == 0
        if o % 3 == 0:
            threes += 1
            assert {(j * nd // 12) % o for j in range(12)} <= {
                0, o // 3, 2 * o // 3}
    assert threes == 80


# ---------------------------------------------------------------------------
# Shared memory and the decide tile
# ---------------------------------------------------------------------------

def test_map_and_decide_geometry_at_every_dense_length():
    """At all 237 dense lengths: the map kernel's four warps of
    ``map_warp_bytes`` (o x (m + ceil(8 / o)) double2 and 2 nd int16)
    within an H100 block's 227 KB (179,520 B at 2040, the most); the int32
    map's decide tile (``int_map``: T + 2H <= 128 rows, an IntInFloat
    column sum of 45,056s below 2^24) per-cell, block and CA, radius 0 and
    2, on 1024 rows and on the split entry's 512-row sp 2 shard (per-cell
    and CA), each taken by ``fixed_config``; ``fused_fixed_detect_supported``
    True; ``split_detect_supported(fixed=True)`` at sp 2 exactly where nd
    / 2 is a multiple of 8 (the range kernel's chirp shards)."""
    ca = fmcw_tpu_torch.CfarParams(variant="ca")
    block = fmcw_tpu_torch.CfarParams(scale_mode="block")
    most = 0
    for nd in DENSE:
        o, m = FX.map_split(nd)
        assert FX.map_warp_bytes(nd) == (o * (m + -(-8 // o)) * 16
                                         + 2 * 2 * nd)
        most = max(most, kernels.MAP_WARPS * FX.map_warp_bytes(nd))
        for cfar in (fmcw_tpu_torch.CfarParams(), block, ca):
            for pgr in (0, 2):
                c = FX.fixed_config(
                    F._slowtime_config(1, 1024, nd, cfar, 0, pgr,
                                       int_map=True),
                    cfar, 2, "zero", False, CW, "unbiased", "t")
                assert nd % c.W == 0 and c.W % 8 == 0 and 1024 % c.T == 0
                assert (c.T + 2 * c.H) * 45056 < 2 ** 24
                assert c.H >= cfar.halo_range + pgr
                assert c.HC >= cfar.halo_doppler + pgr
                p = fmcw_tpu_torch.RadarParams(n_doppler=nd, cfar=cfar)
                assert FX.fused_fixed_detect_supported(p, pgr)
                if cfar is block:
                    continue
                s = FX.fixed_config(
                    SF._split_config(torch.zeros((1, 512, nd)), cfar, 0,
                                     pgr, False, 512, 1024, "t",
                                     int_map=True),
                    cfar, 2, "zero", False, CW, "unbiased", "t")
                assert s.T + 2 * s.H <= 128 and s.H == cfar.halo_range + pgr
                assert SH.split_detect_supported(p, 2, pgr, fixed=True) == (
                    nd % 16 == 0)
    assert most == kernels.MAX_SMEM - 52928 == 179520
    assert FX.map_warp_bytes(2040) == 44880
    # The host's MAP_WARPS is the fixed source's kLongWarps too.
    assert f"constexpr int kLongWarps = {kernels.MAP_WARPS};" in SRC
    for nd in (100, 2056):
        assert not FX.fused_fixed_detect_supported(
            fmcw_tpu_torch.RadarParams(n_doppler=nd))


# ---------------------------------------------------------------------------
# The fused fixed route
# ---------------------------------------------------------------------------

def _jparams(p):
    return fmcw_tpu.RadarParams(
        n_range=p.n_range, n_doppler=p.n_doppler, notch_mode=p.notch_mode,
        cfar=fmcw_tpu.CfarParams(**dataclasses.asdict(p.cfar)))


def _params(nr, nd, config):
    cfar = {"cell": fmcw_tpu_torch.CfarParams(),
            "block": fmcw_tpu_torch.CfarParams(scale_mode="block"),
            "ca": fmcw_tpu_torch.CfarParams(variant="ca")}[config]
    return fmcw_tpu_torch.RadarParams(n_range=nr, n_doppler=nd, cfar=cfar)


def _det_set(out):
    return set(zip(*np.nonzero(np.asarray(out["det_map"]))))


def _jax_contract(out, ref):
    """JAX's fixed-fused contract (tests/test_frontend_fixed.py:56-76):
    the detection set and count, the valid top-K as a set, the saturation
    count equal; magnitudes within 8 LSB."""
    assert _det_set(out) == _det_set(ref)
    assert int(out["n_dets"]) == int(ref["n_dets"]) > 0
    assert int(out["saturation_count"]) == int(ref["saturation_count"])
    assert np.abs(np.asarray(out["mag_map"]).astype(np.int64)
                  - ref["mag_map"].astype(np.int64)).max() <= LSB
    v = np.asarray(out["valid"])
    assert np.array_equal(v, ref["valid"])
    assert (set(zip(np.asarray(out["range_bin"])[v].tolist(),
                    np.asarray(out["doppler_bin"])[v].tolist()))
            == set(zip(ref["range_bin"][v].tolist(),
                       ref["doppler_bin"][v].tolist())))


def _golden_located(z, p, pgr, mag, det):
    """The port's golden process_frame_fixed (and peak_group) against the
    route's maps: magnitude columns that differ all at exact Doppler bins,
    detections that differ all within the window's Doppler halo and the
    grouping radius of such a column.  Returns the columns that differ."""
    gmag, gdet = tref.process_frame_fixed(z, p)
    if pgr:
        gdet = tfx.peak_group(gdet, pgr)
    nd = p.n_doppler
    cols = np.unique(np.argwhere(gmag != mag)[:, 1])
    assert all(exact_bin(int(k), nd) for k in cols), cols
    near = np.zeros(nd, bool)
    reach = p.cfar.halo_doppler + pgr
    for k in cols:
        near[np.arange(k - reach, k + reach + 1) % nd] = True
    assert not ((gdet != det).any(0) & ~near).any()
    return cols.size


@pytest.mark.parametrize("config", ["cell", "block", "ca"])
@pytest.mark.parametrize("nr,nd", [(256, 96), (128, 24)])
def test_fused_fixed_route_vs_jax_xla_and_golden(nr, nd, config):
    """Fixed "fused" at a dense length (the route's twins here: the fixed
    range twin, the dense float64 slow-time twin, the plain decision),
    radius 2, on a two-target frame and its saturating x40 copy: JAX's
    XLA fixed chain's contract, and the port's golden model but at
    located exact bins."""
    p = _params(nr, nd, config)
    proc = tpl.make_processor(p, mode="fixed", frontend="fused",
                              include_maps=True, peak_group_radius=2,
                              device="cpu")
    jproc = jpl.make_processor(_jparams(p), mode="fixed", frontend="xla",
                               include_maps=True, peak_group_radius=2)
    z = np.asarray(tref.two_target_frame(p, seed=3))
    hot = np.clip(z.real * 40, -32768, 32767) + 1j * np.clip(
        z.imag * 40, -32768, 32767)
    for frame in (z, hot):
        iq = tpl.complex_to_iq(frame)
        out = proc(iq)
        _jax_contract(out, jax.tree.map(np.asarray, jproc(iq)))
        _golden_located(frame, p, 2, out["mag_map"].numpy(),
                        out["det_map"].numpy())
    assert int(out["saturation_count"]) > 0


def test_jax_fused_fixed_kernel_interpret_at_128x24():
    """JAX's fused fixed kernel (interpret mode) at 128x24, its dense
    operator, per-cell, radius 2: the port's fused fixed route (its twins)
    meets its contract, as against the XLA chain."""
    p = _params(128, 24, "cell")
    iq = tpl.complex_to_iq(tref.two_target_frame(p, seed=3))
    ref = jax.tree.map(np.asarray, jpl.make_processor(
        _jparams(p), mode="fixed", frontend="pallas", include_maps=True,
        peak_group_radius=2)(iq))
    out = tpl.make_processor(p, mode="fixed", frontend="fused",
                             include_maps=True, peak_group_radius=2,
                             device="cpu")(iq)
    _jax_contract(out, ref)


def test_dense_lengths_launch_range_then_map_and_decide(as_if_cuda):
    """Under the stand-in library at 1024x96: the fixed range kernel, then
    the fixed slow-time kernel's whole-frame entry, two launches (the map
    handed over though no magnitudes are asked for, the row maxima zeroed
    for the chunks' atomicMax), with the decide tile in its config: T 64,
    W 96, H 8, HC 7 per-cell; the block scale's and CA's; at 1016 W 8; the
    split entry at 96 and 1016 on a 256-row shard, its map the
    halo-extended slab; no twin."""
    p = fmcw_tpu_torch.RadarParams(n_doppler=96)
    iq = torch.zeros((2, 96, 1024, 2), dtype=torch.int16)
    re, im, _ = FX.range_fft_fixed(iq)
    det, mag, rmax, _, _ = FX.slowtime_detect_fixed(re, im, cfar=p.cfar,
                                                    peak_group_radius=2)
    assert [c[0] for c in as_if_cuda.calls] == ["range_fft_fixed",
                                                "slowtime_detect_fixed"]
    args = as_if_cuda.calls[-1][1]
    cfg = args[9]._obj
    assert (cfg.ND, cfg.T, cfg.W, cfg.H, cfg.HC) == (96, 64, 96, 8, 7)
    assert (cfg.rnd, cfg.shift) == (1 << 13, 14)
    assert mag is None and args[5] is not None and not rmax.any()
    assert det.dtype == rmax.dtype == torch.int32
    assert (FX.range_fft_fixed.launches,
            FX.slowtime_detect_fixed.launches) == (1, 2)
    geo = {}
    for name, cfar in (("block", fmcw_tpu_torch.fast().cfar),
                       ("ca", fmcw_tpu_torch.CfarParams(variant="ca"))):
        FX.slowtime_detect_fixed(re, im, cfar=cfar, peak_group_radius=2)
        c = as_if_cuda.calls[-1][1][9]._obj
        geo[name] = (c.T, c.W, c.H, c.HC, c.block_mode, c.variant)
        assert c.T + 2 * c.H <= kernels.MAX_ROWS
    assert geo == {"block": (64, 96, 24, 24, 1, 0),
                   "ca": (64, 96, 8, 7, 0, 1)}
    assert FX.slowtime_detect_fixed.launches == 6
    h = p.cfar.halo_range + 2
    for nd in (96, 1016):
        x = torch.zeros((1, 256, nd), dtype=torch.int16)
        halo = (x[:, :h], x[:, :h])
        _, smag, srmax, _, _ = SF.slowtime_detect_fixed_split(
            x, x, halo, halo, False, 0, 256, cfar=p.cfar, n_range_total=1024,
            peak_group_radius=2, emit_mag=True)
        name, args = as_if_cuda.calls[-1]
        assert name == "slowtime_detect_fixed_split"
        c = args[13]._obj
        assert (c.T, c.W, c.H, c.HC) == (64, 96 if nd == 96 else 8, h, 7)
        assert tuple(smag.shape) == (1, 256, nd) and not srmax.any()
        assert smag.data_ptr() == args[9] + 4 * h * nd    # the slab's rows
    assert SF.slowtime_detect_fixed_split.launches == 4
    assert len(as_if_cuda.calls) == 6


def test_local_mesh_equals_single_device():
    """The sharded processor on a LocalMesh at sp 2 (the fixed range
    kernel's 48-chirp shards, the fixed split entry on the range shards
    with their halo rows: their twins here) equals the single-device fused
    fixed route at 256x96, every output; fixed "auto" stays staged."""
    p = fmcw_tpu_torch.RadarParams(n_range=256, n_doppler=96)
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
