"""The dense lengths (n_doppler a multiple of 8 below 2048 that is neither
16, 32, 64, 128 nor n2d x 128): kernel B's dense operator
(fmcw_tpu_torch/csrc/slowtime_detect.cu ``dense_row``) and every float
route that reaches it, held against the JAX package on the CPU.

JAX's fused kernel contracts the chirp axis with the dense folded matrices
there (``fmcw_tpu/ops/fft.doppler_matrices``; ``_doppler_split`` is 1);
the port's twin (``ops/fft.doppler_apply``) is the same matrix, and kernel
B runs an o x m FFT instead:

* a numpy model of the kernel's row plan, step by step: nd = o x m with m
  = nd & -nd (8 .. 64), o odd; the pulse canceller and the window over the
  whole row; for every class k2 < o the outer DFT_o over the blocks of m
  chirps as direct sums in the kernel's order (W_o^e = tw[e m]), the
  twiddle W_nd^(j1 k2), the short rows' m-point lane transform on the
  whole row's table, bin q stored at o q + k2 — within 1e-5 of the peak of
  the float64 chain at every dense length, and of the twin at every dense
  length to 512 and at 1016 (the twin's folded matrices take ~2 minutes
  to build at all 237 lengths); on strong clutter with the MTI on
  the model is held to the float64 chain and closer to it than the twin
  (the folded matrix rounds the canceller's cancellation into each entry);
  a mutation check (W_o conjugated) fails;
* the map kernel's shared memory and the decide kernel's tile at every
  dense length;
* the processors on the CPU (the kernels' twins): 256x96 and 256x192,
  per-cell and block, against JAX's ``make_processor(frontend="xla")``
  through the margin gate, float "auto" resolving to "fused"; JAX's fused
  kernel in interpret mode at 128x24 against the port's twin; the array
  model at 128x48 against JAX's XLA array processor; a LocalMesh at sp 2
  equal to one device; the launches under the ``as_if_cuda`` stand-in
  (kernel A, then kernel B's map and decide kernels in one entry); fixed
  "fused" built at the dense lengths (the fixed slow-time kernel's dense
  operator, tests/test_torch_fixed_dense.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fmcw_tpu
import fmcw_tpu_torch
from fmcw_tpu.models import pipeline as jpl
from fmcw_tpu.ops import fft as JFFT
from fmcw_tpu.ops.frontend_pallas import rdm_frontend
from fmcw_tpu_torch import kernels, parity
from fmcw_tpu_torch.golden import reference as tref
from fmcw_tpu_torch.models import pipeline as tpl
from fmcw_tpu_torch.ops import cfar as C
from fmcw_tpu_torch.ops import fft as TF
from fmcw_tpu_torch.ops import frontend as F
from fmcw_tpu_torch.ops import frontend_fixed as FX
from fmcw_tpu_torch.parallel import LocalMesh, make_sharded_processor

from test_torch_isolation import as_if_cuda  # noqa: F401 (a fixture)
from test_torch_slowtime_plan import (F32, _cmul, _fma, _planes,
                                      _spectra_close, float64_chain,
                                      lane_fft, mti_window)

# Share the CPU with the other test workers (the suite runs 6 at once).
torch.set_num_threads(2)

TOL = 1e-5
DENSE = tuple(nd for nd in range(8, 2049, 8) if F.dense_cpi(nd))
MTI = ((2, "zero", False), (3, "passthrough", False), (3, "zero", False),
       (2, "zero", True))


def dense_split(nd):
    """The kernel's nd = o x m: m = nd & -nd, o = nd / m."""
    m = nd & -nd
    return nd // m, m


# ---------------------------------------------------------------------------
# The dense row
# ---------------------------------------------------------------------------

def kernel_slowtime_dense(re, im, notch=2, transient="zero", bypass=False,
                          conj_outer=False):
    """The kernel's chain of every dense row of (..., nd) float32 planes
    (``dense_row``) with its host tables, every class at once: the complex
    spectrum, natural bin order.  ``conj_outer`` conjugates W_o (the
    mutation check)."""
    nd = re.shape[-1]
    o, m = dense_split(nd)
    win, tw = (x.numpy() for x in F._slowtime_tables(nd, "cpu"))
    zr, zi = mti_window(re, im, win, notch, transient, bypass)
    zr = zr.reshape(*zr.shape[:-1], o, m)
    zi = zi.reshape(*zi.shape[:-1], o, m)
    k2 = np.arange(o)
    ar = np.repeat(zr[..., :1, :], o, axis=-2)
    ai = np.repeat(zi[..., :1, :], o, axis=-2)
    for j2 in range(1, o):
        e = (j2 * k2) % o                       # the kernel's e += k2 mod o
        wr = tw[e * m, 0][:, None]
        wi = tw[e * m, 1][:, None] * (-1 if conj_outer else 1)
        br, bi = zr[..., j2:j2 + 1, :], zi[..., j2:j2 + 1, :]
        ar, ai = (_fma(br, wr, _fma(-bi, wi, ar)),
                  _fma(br, wi, _fma(bi, wr, ai)))
    j = np.outer(k2, np.arange(m))              # W_nd^(j1 k2)
    tr, ti = _cmul(ar, ai, tw[j, 0], tw[j, 1])
    ar = np.where(k2[:, None] > 0, tr, ar)
    ai = np.where(k2[:, None] > 0, ti, ai)
    xr, xi = lane_fft(ar, ai, tw, stride=o)     # (..., o classes, m bins)
    return (np.swapaxes(xr, -1, -2).reshape(re.shape),
            np.swapaxes(xi, -1, -2).reshape(re.shape))


def test_dense_lengths_are_jax_dense_operator():
    """The 237 dense lengths: every multiple of 8 below 2048 but the short
    rows and the long CPIs; at each JAX's kernel takes the dense operator
    (``_doppler_split`` 1); lengths off 8 and from 2048 up are not dense:
    kernel B refuses those from 2048 up (2048 is a long CPI), the fixed
    slow-time kernel also those off 8 (kernel B takes them,
    tests/test_torch_odd_doppler.py)."""
    assert len(DENSE) == 237 and DENSE[:4] == (8, 24, 40, 48)
    assert DENSE[-1] == 2040 and 96 in DENSE and 1016 in DENSE
    for nd in DENSE:
        o, m = dense_split(nd)
        assert m in (8, 16, 32, 64) and o % 2 == 1 and o * m == nd
        assert jpl._doppler_split(fmcw_tpu.RadarParams(n_doppler=nd)) == 1
        assert F.two_launch(nd) and not F.long_cpi(nd)
    for nd in (4, 12, 100, 2044, 2056, 4096, 2048 + 128):
        assert not F.dense_cpi(nd)
        with pytest.raises(NotImplementedError):
            F.check_doppler(nd, "slowtime_detect_fixed", int_map=True)
        if nd < 2048:
            F.check_doppler(nd, "slowtime_detect")
        else:
            with pytest.raises(NotImplementedError):
                F.check_doppler(nd, "slowtime_detect")
    assert not F.dense_cpi(2048) and F.long_cpi(2048)


@pytest.mark.parametrize("m", [8, 16, 32, 64])
def test_dense_row_model_within_float64_chain(m):
    """At every dense length of inner transform m, the row model within
    1e-5 of the peak of the float64 chain (MTI, window, ``np.fft.fft``) on
    seeded noise rows, the four MTI settings taken in turn across the
    lengths."""
    for i, nd in enumerate(n for n in DENSE if dense_split(n)[1] == m):
        rng = np.random.default_rng(nd)
        re, im = _planes(nd, "noise", rng, rows=2)
        notch, transient, bypass = MTI[i % len(MTI)]
        got = kernel_slowtime_dense(re, im, notch, transient, bypass)
        exact = float64_chain(re, im, notch, transient, bypass)
        assert _spectra_close(got, exact) <= TOL, (nd, notch, transient)


TWIN_NDS = {"to256": tuple(nd for nd in DENSE if nd <= 256),
            "to512": tuple(nd for nd in DENSE if 256 < nd <= 512),
            "1016": (1016,)}


@pytest.mark.parametrize("group", sorted(TWIN_NDS))
def test_dense_row_model_matches_the_twin(group):
    """The row model within 1e-5 of the peak of the twin (``doppler_apply``,
    the chain folded into one float32 matrix, JAX's matrix) and of the
    float64 chain, on a two-target frame's range rows and on noise, at
    every dense length to 512 and at 1016 (o = 127), the MTI settings in
    turn (at 1016 notch 2 with and without the bypass, whose matrices
    share a build; 2040, o = 255, is held to the float64 chain above).  On stationary clutter (every
    fourth length) with the MTI on, the folded matrix is itself off the
    float64 chain by more than the model: there the model is held to the
    chain and is closer to it than the twin."""
    for i, nd in enumerate(TWIN_NDS[group]):
        settings = MTI[::3] if nd > 512 else (MTI[i % len(MTI)],)
        for kind in ("frame", "noise", "clutter")[:3 if i % 4 == 0 else 2]:
            rng = np.random.default_rng(nd + 1)
            re, im = _planes(nd, kind, rng, rows=4)
            for notch, transient, bypass in settings:
                got = kernel_slowtime_dense(re, im, notch, transient, bypass)
                exact = float64_chain(re, im, notch, transient, bypass)
                twin = [t.numpy() for t in TF.doppler_apply(
                    torch.as_tensor(re), torch.as_tensor(im), bypass, notch,
                    transient)]
                assert _spectra_close(got, exact) <= TOL
                if kind == "clutter" and not bypass:
                    assert (_spectra_close(got, exact)
                            < _spectra_close(twin, exact))
                    continue
                assert _spectra_close(got, twin) <= TOL, (nd, kind, notch)


def test_dense_row_model_needs_its_outer_twiddles():
    """Mutation check: with W_o conjugated the model is far off the
    float64 chain wherever o > 1 (and unchanged at nd = 8, o = 1)."""
    for nd in (8, 24, 96, 1016):
        rng = np.random.default_rng(3)
        re, im = _planes(nd, "noise", rng, rows=2)
        exact = float64_chain(re, im, 2, "zero", False)
        off = _spectra_close(kernel_slowtime_dense(re, im, conj_outer=True),
                             exact)
        assert (off <= TOL) == (nd == 8), (nd, off)


def test_dense_tables_hold_the_plan_constants():
    """The one table the dense row reads, tw[e] = exp(-2 pi i e / nd) from
    float64, holds W_o^e at tw[e m] and JAX's folded matrices' DFT
    factors within a float32 rounding."""
    for nd in (24, 96, 1016):
        o, m = dense_split(nd)
        _, tw = (x.numpy() for x in F._slowtime_tables(nd, "cpu"))
        w_o = np.exp(-2j * np.pi * np.arange(o) / o)
        assert np.abs(tw[np.arange(o) * m, 0] - w_o.real).max() <= 2.0 ** -24
        assert np.abs(tw[np.arange(o) * m, 1] - w_o.imag).max() <= 2.0 ** -24
    _, _, mr, mi = JFFT.doppler_matrices(96)
    _, tw = (x.numpy() for x in F._slowtime_tables(96, "cpu"))
    w = F._slowtime_tables(96, "cpu")[0].numpy().astype(np.float64)
    k = (np.outer(np.arange(96), np.arange(96)) % 96)
    assert np.abs(mr - (tw[k, 0] * w[:, None])).max() <= 2.0 ** -23
    assert np.abs(mi - (tw[k, 1] * w[:, None])).max() <= 2.0 ** -23


# ---------------------------------------------------------------------------
# Shared memory and the decide tile
# ---------------------------------------------------------------------------

def test_map_and_decide_geometry_at_every_dense_length():
    """At every dense length: the map kernel's 4 warps x 3 nd floats within
    an H100 block's 227 KB; the decide kernel's tile at the repository's
    windows (entry, block 8, quick()), radius 0, 2, 8 (below nd), 1024
    rows: W a multiple of 8 dividing nd (at the entry config the largest
    up to 128: 96 at 96 and 192, 8 at 1016 = 8 x 127), T the rows, the
    halos hold the window and the grouping, at most 64 cells a thread, the
    block grid within 256 blocks, shared memory within 227 KB.  Block 16
    needs 16 | nd, as JAX's ``kernel_scale_supported``."""
    b16 = fmcw_tpu_torch.CfarParams(scale_mode="block", scale_block=16)
    for nd in DENSE:
        # The map kernel: MAP_WARPS warps of 3 nd floats (re, im, out).
        assert kernels.MAP_WARPS * 3 * nd * 4 <= kernels.MAX_SMEM
        for cfar in (fmcw_tpu_torch.CfarParams(),
                     fmcw_tpu_torch.CfarParams(scale_mode="block"),
                     fmcw_tpu_torch.quick().cfar):
            for pgr in (0, 2, 8):
                if pgr >= nd:           # the grouping radius, as JAX's
                    with pytest.raises(NotImplementedError):
                        F._slowtime_config(1, 1024, nd, cfar, 0, pgr)
                    continue
                c = F._slowtime_config(1, 1024, nd, cfar, 0, pgr)
                block = cfar.scale_mode == "block"
                words = F._chunk_words(c.T, c.W, c.H, c.HC, pgr, block, 0)
                assert nd % c.W == 0 and c.W % 8 == 0 and 1024 % c.T == 0
                assert 4 * words <= kernels.MAX_SMEM
                assert c.H >= cfar.halo_range + pgr
                assert c.HC >= cfar.halo_doppler + pgr
                units = -(-(c.T + 2 * pgr) // 8) * (c.W + 2 * pgr)
                assert -(-units // kernels.DECIDE_THREADS) * 8 <= 64
                if block:
                    sb = cfar.scale_block
                    assert c.W % sb == 0 and c.H >= 2 * sb + pgr
                    assert c.HC >= 2 * sb + pgr
                    assert (c.T + 2 * c.H) // sb * ((c.W + 2 * c.HC) // sb) \
                        <= kernels.MAX_BLK
        if nd % 16:
            with pytest.raises(NotImplementedError):
                F._slowtime_config(1, 2048, nd, b16, 0, 2)
        else:
            assert F._slowtime_config(1, 2048, nd, b16, 0, 2).W % 16 == 0
    assert kernels.MAP_WARPS * 3 * 2040 * 4 == 97920
    for nd in DENSE:
        c = F._slowtime_config(1, 1024, nd, fmcw_tpu_torch.CfarParams(), 0, 2)
        assert c.W == max(w for w in range(8, 129, 8) if nd % w == 0)


# ---------------------------------------------------------------------------
# The processors
# ---------------------------------------------------------------------------

def _jparams(p):
    return fmcw_tpu.RadarParams(
        n_range=p.n_range, n_doppler=p.n_doppler, notch_mode=p.notch_mode,
        cfar=fmcw_tpu.CfarParams(**dataclasses.asdict(p.cfar)),
        tracker=fmcw_tpu.TrackerParams(**dataclasses.asdict(p.tracker)))


@pytest.mark.parametrize("nd,mode", [(96, "cell"), (96, "block"),
                                     (192, "cell"), (192, "block")])
def test_batch_processor_margin_gate_vs_jax_xla(nd, mode):
    """Float "auto" resolves to the fused route at a dense length (kernel
    B's dense operator, two launches); on the CPU its twins against JAX's
    XLA chain through the margin gate (det map and top-K), magnitudes
    within 1e-5 of the peak."""
    p = fmcw_tpu_torch.RadarParams(
        n_range=256, n_doppler=nd,
        cfar=fmcw_tpu_torch.CfarParams(scale_mode=mode))
    iq = tpl.complex_to_iq(tref.two_target_frame(p))
    ref = jax.tree.map(np.asarray, jpl.make_processor(
        _jparams(p), frontend="xla", peak_group_radius=2)(iq))
    proc = tpl.make_processor(p, peak_group_radius=2, device="cpu")
    assert tpl.make_batch_processor(p, device="cpu").route == "fused"
    out = proc(iq)
    # The taps of JAX's magnitudes: the plain CFAR's, JAX's XLA cfar_2d's
    # bit for bit (tests/test_torch_longcpi.py).
    _, T, S = C.cfar_2d(torch.tensor(ref["mag_map"]), 0, p.cfar,
                        need_debug=True)
    maps = (ref["mag_map"], T.numpy(), S.numpy())
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


def test_jax_fused_kernel_interpret_vs_twin():
    """JAX's fused kernel (interpret mode) at 128x24, one frame, its dense
    operator (o = 3, m = 8 in kernel B), per-cell scale, radius 2, 3-pulse
    MTI: the port's twins' magnitudes within 2e-4 of its peak (its bf16x3
    products, the contract of tests/test_torch_array.py: 3.7e-5 here); the
    port's plain decision on JAX's magnitudes equal to JAX's detections bit
    for bit; the route's detections at JAX's cells, their values within the
    same 2e-4 (the margin gate's 1e-5 is the float32 chains' contract)."""
    p = fmcw_tpu_torch.RadarParams(n_range=128, n_doppler=24, notch_mode=3)
    iq = tpl.complex_to_iq(tref.two_target_frame(p))
    det_s, jmag, nf, _, n_dets = rdm_frontend(
        jnp.asarray(iq), jnp.asarray(False), notch_mode=3, interpret=True,
        cfar=_jparams(p).cfar, detect=True, peak_group_radius=2)
    jmag = np.asarray(jmag)
    jdet = np.swapaxes(np.asarray(det_s), 0, 1).reshape(128, 24)
    out = tpl.make_processor(p, peak_group_radius=2, device="cpu")(iq)
    assert int(nf) == 0 and int(n_dets) == int((jdet > 0).sum()) > 0
    mag = out["mag_map"].numpy()
    assert np.max(np.abs(mag - jmag)) <= 2e-4 * jmag.max()
    det, _, count, _ = F.detect_plain(torch.tensor(jmag)[None], p.cfar, 0,
                                      2)
    assert np.array_equal(det[0].numpy(), jdet) and int(count) == int(n_dets)
    got, want = parity.map_set(out["det_map"].numpy()), parity.map_set(jdet)
    assert got.keys() == want.keys()
    assert all(abs(got[k] - want[k]) <= 2e-4 * jmag.max() for k in got)


@pytest.mark.parametrize("ref_angle", [0, 1])
def test_array_model_gate_vs_jax_xla(ref_angle):
    """The array model at 128x48 (8 elements, 4 beams; ref_angle 1 with
    quick()'s window): "auto" is the fused route (kernel B's detect entry
    per beam, or its magnitude-only entry and the 3D CFAR); its twins
    against JAX's XLA array processor through the array gate, the point
    source at its matched beam."""
    p = fmcw_tpu_torch.RadarParams(n_range=128, n_doppler=48)
    if ref_angle:
        p = p.replace(cfar=fmcw_tpu_torch.quick().cfar)
    u0, n_elems, n_beams = 0.4, 8, 4
    rng = np.random.default_rng(13)
    z = np.asarray(tref.two_target_frame(p, seed=13,
                                         targets=[(60, 20, 12000)]))
    iq = np.stack([tpl.complex_to_iq(
        z * np.exp(2j * np.pi * 0.5 * e * u0)
        + rng.normal(0, 8, z.shape) + 1j * rng.normal(0, 8, z.shape))
        for e in range(n_elems)])
    kw = (dict(peak_group_radius=2, beam_group_radius=1) if ref_angle == 0
          else dict(ref_angle=1))
    ref = jax.tree.map(np.asarray, jpl.make_array_processor(
        _jparams(p), n_elems=n_elems, n_beams=n_beams, frontend="xla",
        **kw)(iq))
    M = ref["mag_cube"]
    _, T, S = C.cfar_3d(torch.tensor(M), 0, p.cfar, ref_angle, 0,
                        need_debug=True)
    proc = tpl.make_array_processor(p, n_elems=n_elems, n_beams=n_beams,
                                    device="cpu", **kw)
    assert proc.route == "fused"
    out = proc(iq)
    u = np.linspace(-np.sin(np.deg2rad(60.0)), np.sin(np.deg2rad(60.0)),
                    n_beams)
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
    on the range shards, the 48-chirp shards through kernel A; its twins
    here; the debug taps' tail) equals the single-device processor at
    128x96, every output."""
    p = fmcw_tpu_torch.RadarParams(n_range=128, n_doppler=96)
    iq = np.stack([tpl.complex_to_iq(tref.two_target_frame(p, seed=s))
                   for s in range(2)])
    kw = dict(peak_group_radius=2, include_maps=True, **kw)
    proc = make_sharded_processor(LocalMesh(1, 2, "cpu"), p, **kw)
    assert proc.route == "fused"
    got = proc(iq)
    want = tpl.make_batch_processor(p, device="cpu", **kw)(iq)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_dense_lengths_launch_map_then_decide(as_if_cuda):
    """Under the stand-in library at 1024x96: kernel A, then kernel B's
    detect entry, which launches the map kernel and the decide kernel (two
    launches), with the decide tile in its config, the map handed over
    though no magnitudes are asked for, the row maxima zeroed for the
    chunks' atomicMax; the magnitude-only entry and the split entry at 96
    and 1016 likewise, the split's map the halo-extended slab."""
    p = fmcw_tpu_torch.RadarParams(n_doppler=96)
    iq = torch.zeros((2, 96, 1024, 2), dtype=torch.int16)
    re, im = F.range_fft(iq)
    det, mag, rmax, _, _ = F.slowtime_detect(re, im, cfar=p.cfar,
                                             peak_group_radius=2)
    assert [c[0] for c in as_if_cuda.calls] == ["range_fft",
                                                "slowtime_detect"]
    args = as_if_cuda.calls[-1][1]
    cfg = args[9]._obj
    assert (cfg.ND, cfg.T, cfg.W, cfg.H, cfg.HC) == (96, 64, 96, 8, 7)
    assert mag is None and args[5] is not None and not rmax.any()
    assert (F.range_fft.launches, F.slowtime_detect.launches) == (1, 2)
    F.slowtime_mag(re, im)
    assert as_if_cuda.calls[-1][0] == "slowtime_mag"
    assert F.slowtime_mag.launches == 1
    from fmcw_tpu_torch.ops import split_frontend as SF
    for nd in (96, 1016):
        x = torch.zeros((1, 256, nd))
        h = p.cfar.halo_range + 2
        halo = (x[:, :h], x[:, :h])
        _, smag, _, _, _ = SF.slowtime_detect_split(
            x, x, halo, halo, False, 0, 256, cfar=p.cfar, n_range_total=1024,
            peak_group_radius=2, emit_mag=True)
        name, args = as_if_cuda.calls[-1]
        assert name == "slowtime_detect_split"
        assert args[13]._obj.W == (96 if nd == 96 else 8)
        assert tuple(smag.shape) == (1, 256, nd)
        assert smag.data_ptr() == args[9] + 4 * h * nd    # the slab's rows
    assert SF.slowtime_detect_split.launches == 4


def test_fixed_fused_builds_at_the_dense_lengths():
    """Fixed "fused" at 96 and 192 builds on one device and on a mesh (sp 1
    and 2), its route "fused", and ``fused_fixed_detect_supported`` says
    so (the fixed slow-time kernel's dense operator); fixed "auto" stays
    the staged route.  Fixed "fused" raises where the card would (100
    chirps: the fixed kernels' multiple of 8; 2056: above 2048), float
    "fused" at 2056 (100 chirps build fused, tests/test_torch_odd_doppler
    .py), on the CPU too, on one device and on a mesh."""
    kw = dict(mode="fixed", frontend="fused")
    for nd in (96, 192):
        p = fmcw_tpu_torch.RadarParams(n_range=128, n_doppler=nd)
        assert FX.fused_fixed_detect_supported(p)
        assert F.fused_detect_supported(p, 2)
        assert tpl.make_batch_processor(p, device="cpu",
                                        **kw).route == "fused"
        for sp in (1, 2):
            assert make_sharded_processor(LocalMesh(1, sp, "cpu"), p,
                                          **kw).route == "fused"
        assert tpl.make_batch_processor(p, mode="fixed",
                                        device="cpu").route == "staged"
    for nd in (100, 2056):
        q = fmcw_tpu_torch.RadarParams(n_range=256, n_doppler=nd)
        assert not FX.fused_fixed_detect_supported(q)
        if nd < 2048:
            assert tpl.make_batch_processor(
                q, frontend="fused", device="cpu").route == "fused"
        else:
            assert tpl.make_batch_processor(q, device="cpu").route == \
                "staged"
            with pytest.raises(NotImplementedError):
                tpl.make_batch_processor(q, frontend="fused", device="cpu")
        with pytest.raises(NotImplementedError):
            tpl.make_batch_processor(q, device="cpu", **kw)
        with pytest.raises(NotImplementedError):
            make_sharded_processor(LocalMesh(1, 2, "cpu"), q, **kw)
