"""Long CPIs (n_doppler = n2d x 128, n2d 2..16): kernel B's long-CPI
split (fmcw_tpu_torch/csrc/slowtime_detect.cu) and every float route that
reaches it, held against the JAX package on the CPU.

JAX's fused kernel at a long CPI is not run here (its interpret mode takes
about a minute a frame); its contract, tests/test_longcpi.py, holds it to
the XLA chain, and so does this file hold the port:

* numpy models of the kernel's plan, step by step: the long row (the MTI
  and the window over the whole row, the outer DFT_n2d over blocks of 128
  chirps in the kernel's order, the twiddle W_nd^(j1 k2d), the short rows'
  lane transform with the whole row's table, natural bin order), within
  1e-5 of the peak of the float64 chain, of the twin (``doppler_apply``),
  of JAX's folded matrices and of JAX's split (``_ct_split_rows``)
  evaluated in float64; and the decide kernel's tiles of T rows x a chunk
  of W columns with wrapped halos on both axes (per-cell scale, the block
  scale computed on the tile, the override), bit for bit against the plain
  CFAR and JAX's XLA ``cfar_2d`` + ``peak_group`` on tie-heavy maps, with a
  mutation check (a column halo one short differs);
* the plain decision (``detect_plain``) bit for bit against JAX's XLA
  chain for all four variants, per-cell and block;
* the processors on the CPU (the kernels' twins): the batch processor at
  128x256, 128x384 and 128x512 (n2d 2, 3, 4; reflect edges at 128x256)
  against JAX's ``make_processor(frontend="xla")`` by the margin gate,
  with float "auto" resolving to "fused"; the array model at
  ``ref_angle`` 0 and 1 by
  the array gate; a LocalMesh at sp 2 equal to one device, debug taps
  included.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fmcw_tpu
import fmcw_tpu_torch
from fmcw_tpu.models import pipeline as jpl
from fmcw_tpu.ops import cfar as JC
from fmcw_tpu.ops import fft as JFFT
from fmcw_tpu.ops.frontend_pallas import _ct_split_rows
from fmcw_tpu_torch import parity
from fmcw_tpu_torch.golden import reference as tref
from fmcw_tpu_torch.models import pipeline as tpl
from fmcw_tpu_torch.ops import cfar as C
from fmcw_tpu_torch.ops import fft as TF
from fmcw_tpu_torch.ops import frontend as F
from fmcw_tpu_torch.ops import frontend_fixed as FX
from fmcw_tpu_torch.parallel import LocalMesh, make_sharded_processor

from test_torch_slowtime_plan import (F32, STRIP, _cmul, _fma, _planes,
                                      _q_min, _spectra_close, float64_chain,
                                      lane_fft, mti_window, tie_map)

# Share the CPU with the other test workers (the suite runs 6 at once).
torch.set_num_threads(2)

TOL = 1e-5
INNER = 128


# ---------------------------------------------------------------------------
# The long row
# ---------------------------------------------------------------------------

def kernel_slowtime_long(re, im, notch=2, transient="zero", bypass=False):
    """The kernel's chain of every long row of (..., nd) float32 planes
    (``long_row``) with its host tables: the complex spectrum, natural bin
    order."""
    nd = re.shape[-1]
    n2d = nd // INNER
    win, tw = (x.numpy() for x in F._slowtime_tables(nd, "cpu"))
    zr, zi = mti_window(re, im, win, notch, transient, bypass)
    zr = zr.reshape(*zr.shape[:-1], n2d, INNER)
    zi = zi.reshape(*zi.shape[:-1], n2d, INNER)
    j1 = np.arange(INNER)
    out_r = np.zeros(re.shape, F32)
    out_i = np.zeros(re.shape, F32)
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
        xr, xi = lane_fft(ar, ai, tw, stride=n2d)
        out_r[..., k2d::n2d] = xr
        out_i[..., k2d::n2d] = xi
    return out_r, out_i


def jax_split(re, im, notch, transient, bypass):
    """JAX's long-CPI split (``_ct_split_rows``: its W_n2d and twiddle
    matrices, float32) evaluated in float64, the inner DFT_128 exact: the
    spectrum its kernel computes up to its bf16x3 products."""
    nd = re.shape[-1]
    n1d, n2d, c2r, c2i, twr, twi = _ct_split_rows(nd)
    # MTI and window as the XLA chain's H and diag(w), in float64.
    z = (re.astype(np.float64) + 1j * im.astype(np.float64))
    if not bypass:
        p1 = np.zeros_like(z)
        p1[..., 1:] = z[..., :-1]
        p2 = np.zeros_like(z)
        p2[..., 2:] = z[..., :-2]
        z = z - p1 if notch == 2 else z - 2 * p1 + p2
        if transient == "zero":
            z[..., :notch - 1] = 0
    z = z * F._slowtime_tables(nd, "cpu")[0].numpy().astype(np.float64)
    blocks = z.reshape(*z.shape[:-1], n2d, n1d)
    w2 = c2r.astype(np.float64) + 1j * c2i
    tw = (twr.astype(np.float64) + 1j * twi).reshape(n2d, n1d)
    dft = np.exp(-2j * np.pi * np.outer(np.arange(n1d), np.arange(n1d))
                 / n1d)
    out = np.zeros(z.shape, complex)
    for k2d in range(n2d):
        b = np.einsum("...jq,j->...q", blocks, w2[:, k2d]) * tw[k2d]
        out[..., k2d::n2d] = b @ dft
    return out.real, out.imag


@pytest.mark.parametrize("nd", [256, 384, 512])
@pytest.mark.parametrize("kind", ["frame", "noise", "clutter"])
def test_long_row_model_matches_twins(nd, kind):
    """The long row's model within 1e-5 of the peak of the float64 chain,
    of the port's twin (``doppler_apply``, the chain folded into one
    float32 matrix), of JAX's folded matrices and of JAX's split, for
    notch 2 and 3, both transients and the bypass.  On stationary clutter
    with the MTI on, the folded matrices are themselves off the float64
    chain by more than the model (the fold rounds the canceller's
    cancellation into each entry; the kernel subtracts the chirps first,
    as JAX's split does): there the model is held to the float64 chain and
    JAX's split, and closer to the chain than the folds."""
    rng = np.random.default_rng(nd)
    re, im = _planes(nd, kind, rng, rows=16)
    for notch, transient, bypass in ((2, "zero", False),
                                     (3, "passthrough", False),
                                     (3, "zero", False), (2, "zero", True)):
        got = kernel_slowtime_long(re, im, notch, transient, bypass)
        exact = float64_chain(re, im, notch, transient, bypass)
        assert _spectra_close(got, exact) <= TOL
        assert _spectra_close(got, jax_split(re, im, notch, transient,
                                             bypass)) <= TOL
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
        assert _spectra_close(got, (z.real, z.imag)) <= TOL


def test_long_tables_are_jax_split_constants():
    """The one table the long row reads, tw[m] = exp(-2 pi i m / nd) from
    float64, holds JAX's split constants: W_n2d^m at tw[128 m] and the
    twiddle W_nd^(j1 k2d) at tw[j1 k2d], within a float32 rounding."""
    for nd in (256, 384, 2048):
        _, tw = (x.numpy() for x in F._slowtime_tables(nd, "cpu"))
        n1d, n2d, c2r, c2i, twr, twi = _ct_split_rows(nd)
        j2 = np.arange(n2d)
        idx = (np.outer(j2, j2) % n2d) * INNER
        assert np.abs(tw[idx, 0] - c2r).max() <= 2.0 ** -24
        assert np.abs(tw[idx, 1] - c2i).max() <= 2.0 ** -24
        m = np.outer(j2, np.arange(n1d)).ravel()
        assert np.abs(tw[m, 0] - twr[:, 0]).max() <= 2.0 ** -24
        assert np.abs(tw[m, 1] - twi[:, 0]).max() <= 2.0 ** -24


# ---------------------------------------------------------------------------
# The decide kernel's tiles
# ---------------------------------------------------------------------------

def block_scale_tile(m, cfar):
    """The block scale of a tile (B, E, WC) as ``block_scale_tile`` computes
    it, (B, E / sb, WC / sb) int32; valid on the blocks two from each
    edge."""
    sb = cfar.scale_block
    B, E, WC = m.shape
    n_blk = 9 * sb * sb
    k_blk = n_blk - min(n_blk * cfar.rank_pct // 100, n_blk - 1)
    blocks = m.reshape(B, E // sb, sb, WC // sb, sb)
    bsum = blocks.sum(axis=(2, 4), dtype=F32)

    def nb(x):
        acc = 0
        for di in (-1, 0, 1):
            for dr in (-1, 0, 1):
                acc = acc + np.roll(x, (-dr, -di), axis=(1, 2))
        return acc
    mean = nb(bsum).astype(F32) / F32(n_blk)
    t_hi, t_lo = F32(1.5) * mean, F32(0.5) * mean
    hi = (blocks > t_hi[:, :, None, :, None]).sum(axis=(2, 4))
    lo = (blocks >= t_lo[:, :, None, :, None]).sum(axis=(2, 4))
    hi, lo = nb(hi), nb(lo)
    return np.where(hi >= k_blk, cfar.scale_max,
                    np.where(lo < k_blk, cfar.scale_min,
                             cfar.scale_nom)).astype(np.int32)


def kernel_decide_long(mag, cfar, so, pgr, hc=None):
    """The decide kernel's decision, grouping and counts of (B, R, D)
    float32 magnitudes at a long CPI: tiles of T rows x W columns
    (``ops/frontend._slowtime_config``) with H halo rows and HC halo
    columns (``hc`` overrides it), both wrapped; the T + 2 pgr rows and W +
    2 pgr columns the grouping reads decided in strips of 8 cells, column
    sums once per tile, the window's columns read in the tile (a column
    index past the tile's edge would wrap within it: the plan needs none);
    the grouping of the T x W cells with global ids.  Returns (det,
    row_max, n_dets)."""
    with np.errstate(invalid="ignore", over="ignore"):
        B, R, D = mag.shape
        cfg = F._slowtime_config(B, R, D, cfar, so, pgr)
        T, W, H = cfg.T, cfg.W, cfg.H
        HC = cfg.HC if hc is None else hc
        E, WC, rows = T + 2 * H, W + 2 * HC, T + 2 * pgr
        hr, hd, gr, gd = (cfar.halo_range, cfar.halo_doppler,
                          cfar.guard_range, cfar.guard_doppler)
        sb = cfar.scale_block
        k = cfar.n_ref - cfar.rank_idx
        strips = sorted({min(st * STRIP, rows - STRIP)
                         for st in range(-(-rows // STRIP))})
        dcols = HC - pgr + np.arange(W + 2 * pgr)
        det = np.zeros_like(mag)
        for r0 in range(0, R, T):
            for c0 in range(0, D, W):
                m = mag[:, (r0 - H + np.arange(E)) % R][
                    ..., (c0 - HC + np.arange(WC)) % D]
                e_first = H - pgr
                ef = np.full((B, rows, WC), -0.0, F32)
                eg = np.full((B, rows, WC), -0.0, F32)
                for dr in range(2 * hr + 1):
                    v = m[:, e_first - hr + dr:e_first - hr + dr + rows]
                    ef = ef + v
                    if abs(dr - hr) <= gr:
                        eg = eg + v
                bs = (block_scale_tile(m, cfar)
                      if cfar.scale_mode == "block" and not so else None)
                det_t = np.zeros((B, rows, WC), F32)
                for i0 in strips:
                    e0 = e_first + i0
                    cut = m[:, e0:e0 + STRIP][..., dcols]

                    def walk(visit):
                        for dd in range(-hd, hd + 1):
                            for dr in range(2 * hr + 1):
                                if abs(dd) <= gd and abs(dr - hr) <= gr:
                                    continue
                                visit(m[:, e0 - hr + dr:e0 - hr + dr + STRIP]
                                      [..., (dcols + dd) % WC])
                    if so:
                        sc = np.full(cut.shape, so, np.int32)
                    elif bs is not None:
                        sc = bs[:, (e0 + np.arange(STRIP)) // sb][
                            ..., dcols // sb]
                    else:
                        full = np.full(cut.shape, -0.0, F32)
                        guard = np.full(cut.shape, -0.0, F32)
                        for j in range(-hd, hd + 1):
                            full = full + ef[:, i0:i0 + STRIP][
                                ..., (dcols + j) % WC]
                        for j in range(-gd, gd + 1):
                            guard = guard + eg[:, i0:i0 + STRIP][
                                ..., (dcols + j) % WC]
                        mean = (full - guard) / F32(cfar.n_ref)
                        t_hi, t_lo = F32(1.5) * mean, F32(0.5) * mean
                        hl = [np.zeros(cut.shape, np.int32)]

                        def count_hl(v):
                            hl[0] = (hl[0] + np.where(v > t_hi, 0x10000, 0)
                                     + (v >= t_lo))
                        walk(count_hl)
                        hi, lo = hl[0] >> 16, hl[0] & 0xFFFF
                        sc = np.where(hi >= k, cfar.scale_max,
                                      np.where(lo < k, cfar.scale_min,
                                               cfar.scale_nom))
                    q = _q_min(cut, sc.astype(np.int32))
                    cnt = [np.zeros(cut.shape, np.int32)]

                    def count(v):
                        cnt[0] = cnt[0] + (v >= q)
                    walk(count)
                    blk = det_t[:, i0:i0 + STRIP]
                    blk[..., dcols] = np.where((cnt[0] < k) & (cut > 0), cut,
                                               F32(0))
                own = det_t[:, pgr:pgr + T, HC:HC + W]
                keep = own > 0
                rid = (r0 + np.arange(T))[:, None]
                cid = c0 + np.arange(W)
                ids = rid * D + cid
                for dr in range(-pgr, pgr + 1):
                    for dd in range(-pgr, pgr + 1):
                        if dr == 0 and dd == 0:
                            continue
                        v = det_t[:, pgr + dr:pgr + dr + T,
                                  HC + dd:HC + dd + W]
                        nid = ((rid + dr) % R) * D + (cid + dd) % D
                        keep &= ~((v > own) | ((v == own) & (nid < ids)))
                det[:, r0:r0 + T, c0:c0 + W] = np.where(keep, own, F32(0))
        row_max = np.where(det > 0, det, F32(0)).max(-1)
        n_dets = (det > 0).sum((-2, -1)).astype(np.int32)
        return det, row_max, n_dets


def _jax_decide(mag, jcfar, so, pgr):
    out = []
    for frame in mag:
        d, _, _ = JC.cfar_2d(jnp.asarray(frame), so, jcfar)
        out.append(np.asarray(JC.peak_group(d, pgr) if pgr else d))
    return np.stack(out)


def _jcfar(cfar):
    return fmcw_tpu.CfarParams(**dataclasses.asdict(cfar))


@pytest.mark.parametrize("mode,so,pgr", [
    ("cell", 0, 0), ("cell", 0, 2), ("cell", 4, 1), ("block", 0, 2),
    ("block", 0, 0), ("block", 6, 2)])
def test_decide_model_bitwise_on_ties(mode, so, pgr):
    """At 128x256 (two row tiles, two or four column chunks, the entry's
    window) the decide kernel's model equals the plain CFAR
    (``detect_plain``: decision, grouping, row maxima, counts) and JAX's
    XLA cfar_2d + peak_group bit for bit on a tie-heavy map."""
    cfar = fmcw_tpu_torch.CfarParams(scale_mode=mode)
    mag = tie_map(np.random.default_rng(10 * so + pgr), 1, 128, 256)
    got = kernel_decide_long(mag, cfar, so, pgr)
    want = F.detect_plain(torch.as_tensor(mag), cfar, so, pgr)
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
    assert np.array_equal(got[0], _jax_decide(mag, _jcfar(cfar), so, pgr))
    assert got[2].min() > 0


def test_decide_model_needs_its_column_halo():
    """Mutation check: a map of ones with a wall of 1000s in the column a
    chunk's first cells see last (hd columns to their left, in the
    chunk before) and a 3 at one such cell: the wall lowers that cell's
    scale class to scale_min, so it is detected (3 > 1 x 2).  The model
    equals the plain CFAR; with a column halo one short of hd + pgr its
    window reads a one in place of the wall (scale_nom, no detection) and
    differs.  With quick()'s window at 128x384 (three chunks) the model
    agrees on a tie-heavy map."""
    cfar = fmcw_tpu_torch.CfarParams()
    cfg = F._slowtime_config(1, 128, 256, cfar, 0, 0)
    mag = np.ones((1, 128, 256), F32)
    mag[0, :, cfg.W - cfar.halo_doppler] = 1000
    mag[0, 40, cfg.W] = 3
    want = F.detect_plain(torch.as_tensor(mag), cfar, 0, 0)
    assert want[0][0, 40, cfg.W] == 3
    got = kernel_decide_long(mag, cfar, 0, 0)
    assert all(np.array_equal(g, w.numpy()) for g, w in zip(got, want))
    got = kernel_decide_long(mag, cfar, 0, 0, hc=cfg.HC - 1)
    assert got[0][0, 40, cfg.W] == 0
    quick = fmcw_tpu_torch.quick().cfar
    mag = tie_map(np.random.default_rng(4), 1, 128, 384)
    got = kernel_decide_long(mag, quick, 0, 1)
    want = F.detect_plain(torch.as_tensor(mag), quick, 0, 1)
    assert all(np.array_equal(g, w.numpy()) for g, w in zip(got, want))


def test_decide_geometry_fits_the_kernel():
    """Every long CPI the split takes (n2d 2..16) gets a decide tile at the
    repository's windows, per-cell and block, radius 0..8: W divides nd,
    T the rows, at most 64 cells a thread, the block grid within 256 blocks
    and the shared memory within an H100 block's 227 KB; n2d 32 and 2056
    chirps (above 2048) are refused, and 192 chirps (a dense length,
    tests/test_torch_dense_doppler.py) and 100 chirps (off a multiple of 8:
    one ragged-free chunk of 100 columns, tests/test_torch_odd_doppler.py)
    take the same decide kernel's tile; the fixed kernel's int32 map
    refuses 100."""
    for nd in range(256, 2049, 128):
        for cfar in (fmcw_tpu_torch.CfarParams(),
                     fmcw_tpu_torch.CfarParams(scale_mode="block"),
                     fmcw_tpu_torch.quick().cfar):
            for pgr in (0, 2, 8):
                c = F._slowtime_config(1, 1024, nd, cfar, 0, pgr)
                block = cfar.scale_mode == "block"
                words = F._chunk_words(c.T, c.W, c.H, c.HC, pgr, block, 0)
                assert nd % c.W == 0 and 1024 % c.T == 0
                assert 4 * words <= 232448
                assert c.H >= cfar.halo_range + pgr
                assert c.HC >= cfar.halo_doppler + pgr
                if block:
                    sb = cfar.scale_block
                    assert (c.T + 2 * c.H) // sb * ((c.W + 2 * c.HC) // sb) \
                        <= 256
    for nd in (4096, 2056):
        with pytest.raises(NotImplementedError):
            F._slowtime_config(1, 1024, nd, fmcw_tpu_torch.CfarParams(), 0,
                               2)
    c = F._slowtime_config(1, 1024, 192, fmcw_tpu_torch.CfarParams(), 0, 2)
    assert (c.T, c.W, c.H, c.HC) == (64, 96, 8, 7)
    c = F._slowtime_config(1, 1024, 100, fmcw_tpu_torch.CfarParams(), 0, 2)
    assert (c.T, c.W, c.H, c.HC) == (64, 100, 8, 7)
    with pytest.raises(NotImplementedError):
        F._slowtime_config(1, 1024, 100, fmcw_tpu_torch.CfarParams(), 0, 2,
                           int_map=True)


@pytest.mark.parametrize("variant", ["os", "ca", "go", "so"])
def test_plain_decision_equals_jax_for_every_variant(variant):
    """The twin the kernel is held to on the card (``detect_plain``) equals
    JAX's XLA cfar_2d + peak_group bit for bit at a long CPI, per-cell and
    block, on the magnitudes of a two-target frame at 64x256."""
    p = fmcw_tpu_torch.RadarParams(n_range=64, n_doppler=256)
    iq = torch.as_tensor(tpl.complex_to_iq(tref.two_target_frame(p)))[None]
    mag = F.slowtime_mag_plain(*F.range_fft_plain(iq), False)
    for mode in ("cell", "block"):
        cfar = fmcw_tpu_torch.CfarParams(variant=variant, scale_mode=mode,
                                         scale_block=4)
        det = F.detect_plain(mag, cfar, 0, 2)[0].numpy()
        assert np.array_equal(det, _jax_decide(mag.numpy(), _jcfar(cfar), 0,
                                               2))
        assert (det > 0).sum() > 0


# ---------------------------------------------------------------------------
# The processors
# ---------------------------------------------------------------------------

def _jparams(p):
    return fmcw_tpu.RadarParams(
        n_range=p.n_range, n_doppler=p.n_doppler,
        cfar=fmcw_tpu.CfarParams(**dataclasses.asdict(p.cfar)),
        tracker=fmcw_tpu.TrackerParams(**dataclasses.asdict(p.tracker)))


@pytest.mark.parametrize("nd,mode,edge", [
    (256, "cell", "wrap"), (384, "block", "wrap"), (512, "cell", "wrap"),
    (256, "cell", "reflect")])
def test_batch_processor_margin_gate_vs_jax_xla(nd, mode, edge):
    """Float "auto" resolves to the fused route at a long CPI (kernel B's
    split; under reflect its magnitude-only entry, then the standalone
    CFAR's reflect entry); on the CPU its twins against JAX's XLA chain
    through the margin gate (det map and top-K), magnitudes within 1e-5 of
    the peak."""
    p = fmcw_tpu_torch.RadarParams(
        n_range=128, n_doppler=nd,
        cfar=fmcw_tpu_torch.CfarParams(scale_mode=mode, scale_block=4,
                                       edge_mode=edge))
    iq = tpl.complex_to_iq(tref.two_target_frame(p))
    ref = jax.tree.map(np.asarray, jpl.make_processor(
        _jparams(p), frontend="xla", include_debug=True,
        peak_group_radius=2)(iq))
    proc = tpl.make_processor(p, peak_group_radius=2, device="cpu")
    assert tpl.make_batch_processor(p, device="cpu").route == "fused"
    out = proc(iq)
    maps = (ref["mag_map"], ref["threshold_map"], ref["scale_map"])
    targets = tref.golden_targets(p)
    for a, b in ((parity.map_set(out["det_map"].numpy()),
                  parity.map_set(ref["det_map"])),
                 (parity.detection_set(out), parity.detection_set(ref))):
        ok, report = parity.margin_gate(a, b, *maps, radius=2,
                                        targets=targets,
                                        capacity=p.tracker.max_dets)
        assert ok, report
    mag = out["mag_map"].numpy()
    assert np.max(np.abs(mag - ref["mag_map"])) <= TOL * ref["mag_map"].max()


N_ELEMS, N_BEAMS = 8, 4


@pytest.mark.parametrize("ref_angle", [0, 1])
def test_array_model_gate_vs_jax_xla(ref_angle):
    """The array model at 128x256 (8 elements, 4 beams): "auto" is the
    fused route (kernel B's detect entry per beam, or its magnitude-only
    entry and the 3D CFAR); its twins against JAX's XLA array processor
    through the array gate, the point source at its matched beam."""
    p = fmcw_tpu_torch.RadarParams(n_range=128, n_doppler=256)
    u0 = 0.4
    rng = np.random.default_rng(13)
    z = np.asarray(tref.two_target_frame(p, seed=13,
                                         targets=[(60, 20, 12000)]))
    iq = np.stack([tpl.complex_to_iq(
        z * np.exp(2j * np.pi * 0.5 * e * u0)
        + rng.normal(0, 8, z.shape) + 1j * rng.normal(0, 8, z.shape))
        for e in range(N_ELEMS)])
    kw = (dict(peak_group_radius=2, beam_group_radius=1) if ref_angle == 0
          else dict(ref_angle=1))
    ref = jax.tree.map(np.asarray, jpl.make_array_processor(
        _jparams(p), n_elems=N_ELEMS, n_beams=N_BEAMS, frontend="xla",
        **kw)(iq))
    M = ref["mag_cube"]
    _, T, S = C.cfar_3d(torch.tensor(M), 0, p.cfar, ref_angle, 0,
                        need_debug=True)
    proc = tpl.make_array_processor(p, n_elems=N_ELEMS, n_beams=N_BEAMS,
                                    device="cpu", **kw)
    assert proc.route == "fused"
    out = proc(iq)
    u = np.linspace(-np.sin(np.deg2rad(60.0)), np.sin(np.deg2rad(60.0)),
                    N_BEAMS)
    beam = int(np.argmin(np.abs(u - u0)))
    ok, report = parity.array_gate(
        parity.array_set(out), parity.array_set(ref), M, T.numpy(),
        S.numpy(), radius=kw.get("peak_group_radius", 0),
        beam_radius=kw.get("beam_group_radius", 0),
        targets=[(60, 20, 12000)], target_beam=beam,
        capacity=p.tracker.max_dets)
    assert ok, report
    assert int(out["beam_bin"][0]) == beam
    assert np.max(np.abs(out["mag_cube"].numpy() - M)) <= TOL * float(M.max())


@pytest.mark.parametrize("kw", [dict(), dict(include_debug=True)],
                         ids=["frames", "debug"])
def test_local_mesh_equals_single_device(kw):
    """The sharded processor on a LocalMesh at sp 2 (kernel B's split entry
    on the range shards, its twin here; the debug taps' tail) equals the
    single-device processor at 128x256, every output."""
    p = fmcw_tpu_torch.RadarParams(n_range=128, n_doppler=256)
    iq = np.stack([tpl.complex_to_iq(tref.two_target_frame(p, seed=s))
                   for s in range(2)])
    kw = dict(peak_group_radius=2, include_maps=True, **kw)
    proc = make_sharded_processor(LocalMesh(1, 2, "cpu"), p, **kw)
    assert proc.route == "fused"
    got = proc(iq)
    want = tpl.make_batch_processor(p, device="cpu", **kw)(iq)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_fixed_fused_long_cpi_names_the_next_slice():
    """Fixed "fused" at a long CPI (the fixed slow-time kernel's long-CPI
    split, tests/test_torch_fixed_longcpi.py) is the route on one device
    and on a mesh, sp 1 and 2; fixed "auto" there stays the staged route,
    as JAX's; 100 chirps (off a multiple of 8) and n2d 32 stay refused,
    before any launch, and 192 (a dense length: the fixed dense operator,
    tests/test_torch_fixed_dense.py) is the fused route too."""
    p = fmcw_tpu_torch.RadarParams(n_range=128, n_doppler=256)
    kw = dict(mode="fixed", frontend="fused")
    assert tpl.make_batch_processor(p, device="cpu", **kw).route == "fused"
    for sp in (1, 2):
        assert make_sharded_processor(LocalMesh(1, sp, "cpu"), p,
                                      **kw).route == "fused"
    assert tpl.make_batch_processor(p, mode="fixed",
                                    device="cpu").route == "staged"
    for nd in (100, 4096):
        q = p.replace(n_doppler=nd)
        assert not FX.fused_fixed_detect_supported(q)
        with pytest.raises(NotImplementedError):
            tpl.make_batch_processor(q, device="cpu", **kw)
        with pytest.raises(NotImplementedError):
            make_sharded_processor(LocalMesh(1, 2, "cpu"), q, **kw)
    q = p.replace(n_doppler=192)
    assert FX.fused_fixed_detect_supported(q)
    assert tpl.make_batch_processor(q, device="cpu", **kw).route == "fused"


# The host's copies of the kernel sources' constants (fmcw_tpu_torch/
# kernels.py), by the source and constexpr each mirrors.
MIRRORED = {
    "MAX_ROWS": ("slowtime_common.cuh", "kMaxRows"),
    "MAX_BLK": ("slowtime_common.cuh", "kMaxBlk"),
    "MAX_SMEM": ("slowtime_common.cuh", "kMaxSmem"),
    "STRIP": ("cfar_tile.cuh", "kStrip"),
    "DECIDE_THREADS": ("slowtime_long.cuh", "kDecideThreads"),
    "LONG_CPI_INNER": ("slowtime_long.cuh", "kInner"),
    "LONG_CPI_MAX_SPLIT": ("slowtime_long.cuh", "kMaxSplit"),
    "DENSE_ALIGN": ("slowtime_long.cuh", "kDenseAlign"),
    "DENSE_MAX": ("slowtime_long.cuh", "kMaxDense"),
    "MAP_WARPS": ("slowtime_detect.cu", "kLongWarps"),
    "RANGE_MIN_LOG2": ("range_fft.cu", "kMinLog2N"),
    "RANGE_MAX_LOG2": ("range_fft.cu", "kMaxLog2N"),
    "RANGE_SLICE": ("range_fft.cu", "kSlice"),
    "RANGE_MAX_SLICES": ("range_fft.cu", "kMaxSlices"),
    # The fixed range kernel takes kernel A's lengths: the same constants.
    "RANGE_MIN_LOG2:fixed": ("range_fft_fixed.cu", "kMinLog2N"),
    "RANGE_MAX_LOG2:fixed": ("range_fft_fixed.cu", "kMaxLog2N"),
    "RANGE_SLICE:fixed": ("range_fft_fixed.cu", "kSlice"),
    "RANGE_MAX_SLICES:fixed": ("range_fft_fixed.cu", "kMaxSlices"),
}


@pytest.mark.parametrize("name", sorted(MIRRORED))
def test_host_geometry_constants_match_the_sources(name):
    """Each constant the host picks kernel B's tile or the range kernels'
    lengths with equals the constexpr of the CUDA source it mirrors (a
    name with a ``:`` suffix: the same host constant in another source),
    so the two cannot drift."""
    from fmcw_tpu_torch import kernels
    src, cname = MIRRORED[name]
    text = (kernels.CSRC / src).read_text()
    found = re.findall(rf"constexpr\s+int\s+{cname}\s*=\s*(\d+)\s*;", text)
    assert len(found) == 1, (src, cname, found)
    assert int(found[0]) == getattr(kernels, name.split(":")[0])
