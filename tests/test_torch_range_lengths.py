"""The range lengths n_range = n2 x 128 (n2 <= 16: 384, 640, ..., 2048) in
kernel A (fmcw_tpu_torch/csrc/range_fft.cu) and kernel B
(csrc/slowtime_detect.cu), held against the JAX package on the CPU.

JAX's fused front end takes these lengths (``fmcw_tpu/ops/frontend_pallas.
py::_ct_split``); kernel A runs each as n = o x m: a dense o-point stage
(o = 2 at 2048, else the odd factor 3 .. 15), then the power-of-two plan
of m, o classes a group in rounds of slices.  Here:

* a numpy model of that plan in float32 arithmetic, every index: the
  slices and rounds, the dense stage's loads, window and W_o^(i2 k2) sums,
  the W_n^(i1 k2) twiddle, the m-point plan's DFTs, table and exchange
  (one region per slice), the store to row o k1 + k2 (each output written
  once, 32-byte runs of 8 chirps), against ``np.fft.fft`` at every new
  length, both entries; a wrong odd-stage twiddle fails (mutation check);
  the plan's shared memory fits a block; the tables' layout, and the
  powers of two's tables unchanged;
* kernel B's row tile: 64 where it fits today, 32 for 2048 rows at the
  block scale 16 and for shards of 96 and 352 rows; a model of the decide
  tiled at T = 32 on tie maps at R = 384 bit for bit against
  ``detect_plain``;
* the processors on the CPU (the kernels' twins) against JAX's
  ``make_processor(frontend="xla")``: the batch processor at 384x32 and
  2048x16, per-cell and block (scale_block 8 and 16), through the margin
  gate, float "auto" resolving to "fused"; the array model at 384 through
  the array gate; a LocalMesh at sp 2 equal to one device; fixed "auto"
  and fixed "fused" at 384 equal to the golden model, on one device and
  on a mesh; 320 and 4096 refused;
* JAX's fused kernel in interpret mode at 384x16 against the model's
  range output through the slow-time twin.
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
from fmcw_tpu.ops.frontend_pallas import rdm_frontend
from fmcw_tpu_torch import kernels, parity
from fmcw_tpu_torch.golden import reference as tref
from fmcw_tpu_torch.models import pipeline as tpl
from fmcw_tpu_torch.ops import cfar as C
from fmcw_tpu_torch.ops import frontend as F
from fmcw_tpu_torch.ops import frontend_fixed as FX
from fmcw_tpu_torch.ops.window import hamming_float
from fmcw_tpu_torch.parallel import LocalMesh, make_sharded_processor

from test_torch_range_fft_plan import F32, F64, K_CHIRPS, _brev, _dft, _fma
from test_torch_slowtime_plan import kernel_decide, tie_map

# Share the CPU with the other test workers (the suite runs 6 at once).
torch.set_num_threads(2)

TOL = 1e-5
SMEM = 232448                   # an H100 block's most shared memory
NEW = [n for n in range(384, 2049, 128) if n & (n - 1)] + [2048]
POW2 = [1 << k for k in range(4, 11)]


# ---------------------------------------------------------------------------
# Kernel A: the plan of n = o x m
# ---------------------------------------------------------------------------

def plan(n, is_float):
    """``Plan<kFloat, log2 m, o>`` of csrc/range_fft.cu."""
    o, m = F.range_fft_split(n)
    n1, n2 = F.range_fft_plan(m)
    lanes = K_CHIRPS * n2
    most = 1 if lanes >= 256 else 256 // lanes
    rounds = -(-o // most)
    slices = -(-o // rounds)
    row = n1 + 1
    region = n2 * row + (36 - n2 * row % 32) % 32
    exchange = K_CHIRPS * region
    words = K_CHIRPS * n * (2 if is_float else 1) + 2 * slices * exchange
    return dict(o=o, m=m, n1=n1, n2=n2, lanes=lanes, rounds=rounds,
                slices=slices, threads=slices * lanes, row=row,
                region=region, exchange=exchange, smem=words * 4 + 16)


def kernel_model(pre, pim, win, tw):
    """Kernel A on planes pre/pim (B, nd, n) at n = o x m, o > 1 ->
    (B, n, nd) re/im, thread by thread of each round."""
    B, nd, n = pre.shape
    P = plan(n, False)
    o, m, n1, n2 = P["o"], P["m"], P["n1"], P["n2"]
    l1, l2 = n1.bit_length() - 1, n2.bit_length() - 1
    assert o > 1 and o * m == n
    tid = np.arange(P["threads"])
    s, lane = tid // P["lanes"], tid & (P["lanes"] - 1)
    t, c1 = lane & (n2 - 1), lane >> l2               # pass 1
    c2, q = lane % K_CHIRPS, lane // K_CHIRPS         # pass 2
    warps = tid.reshape(-1, 32)
    assert (s[warps] == s[warps][:, :1]).all()        # a warp in one slice
    groups = B * nd // K_CHIRPS
    gi = np.arange(groups)
    b, c0 = gi // (nd // K_CHIRPS), gi % (nd // K_CHIRPS) * K_CHIRPS
    buf_re = pre.reshape(groups, K_CHIRPS * n)
    buf_im = pim.reshape(groups, K_CHIRPS * n)
    sub, twn, two = tw[:m], tw[m:m + n], tw[m + n:]
    assert len(two) == o
    out_re = np.full((B, n, nd), np.nan, F32)
    out_im = out_re.copy()
    stored = np.zeros((B, n, nd), int)
    for rnd in range(P["rounds"]):
        k2 = rnd * P["slices"] + s                    # (threads,)
        active = k2 < o
        k2c = np.minimum(k2, o - 1)
        # The dense stage: point i1 = t + N2 m' of chirp c1.
        xr = np.zeros((groups, len(tid), n1), F32)
        xi = np.zeros_like(xr)
        for mv in range(n1):
            i1 = t + n2 * mv
            ar = np.zeros((groups, len(tid)), F32)
            ai = np.zeros_like(ar)
            for i2 in range(o):
                w = two[i2 * k2c % o]                 # (threads, 2)
                i = i1 + m * i2
                r = buf_re[:, c1 * n + i].astype(F32) * win[i]
                im = buf_im[:, c1 * n + i].astype(F32) * win[i]
                ar = _fma(r, w[:, 0], ar)
                ar = _fma(-im, w[:, 1], ar)
                ai = _fma(r, w[:, 1], ai)
                ai = _fma(im, w[:, 0], ai)
            w = twn[k2c * m + i1]
            xr[..., mv] = _fma(ar, w[:, 0], -(ai * w[:, 1]))
            xi[..., mv] = _fma(ar, w[:, 1], ai * w[:, 0])
        # The m-point plan: N1-point DFT, W_m^(t ka) = tw[ka N2 + t].
        _dft(xr, xi, n1, 0)
        for ka in range(1, n1):
            p = _brev(ka, l1)
            w = sub[ka * n2 + t]
            r = _fma(xr[..., p], w[:, 0], -(xi[..., p] * w[:, 1]))
            xi[..., p] = _fma(xr[..., p], w[:, 1], xi[..., p] * w[:, 0])
            xr[..., p] = r
        # The exchange, in the slice's regions.
        for x in (xr, xi):
            xch = np.full((groups, P["slices"] * P["exchange"]), np.nan, F32)
            for ka in range(n1):
                put = s * P["exchange"] + c1 * P["region"] + t * P["row"] + ka
                xch[:, put] = x[..., _brev(ka, l1)]
            for j in range(n1 // n2):
                for tp in range(n2):
                    get = (s * P["exchange"] + c2 * P["region"]
                           + tp * P["row"] + q + n2 * j)
                    x[..., j * n2 + tp] = xch[:, get]
        assert np.isfinite(xr).all() and np.isfinite(xi).all()
        for j in range(n1 // n2):
            _dft(xr, xi, n2, j * n2)
        for j in range(n1 // n2):
            for kb in range(n2):
                k = o * (q + n2 * j + n1 * kb) + k2   # row o k1 + k2
                col = c0[:, None] + c2
                act = warps[active[warps[:, 0]]]      # active warps' lanes
                flat = (k * nd + c2)[act]
                runs = np.sort(flat, axis=-1).reshape(-1, 4, K_CHIRPS)
                assert (np.diff(runs, axis=-1) == 1).all()
                p = j * n2 + _brev(kb, l2)
                sel = np.flatnonzero(active)
                bb = np.broadcast_to(b[:, None], col.shape)[:, sel]
                kk = np.broadcast_to(k, col.shape)[:, sel]
                out_re[bb, kk, col[:, sel]] = xr[:, sel, p]
                out_im[bb, kk, col[:, sel]] = xi[:, sel, p]
                np.add.at(stored, (bb, kk, col[:, sel]), 1)
    assert (stored == 1).all()
    return out_re, out_im


def _stimuli(n, seed):
    rng = np.random.default_rng(seed)
    iq = rng.integers(-2048, 2048, (1, 16, n, 2)).astype(np.int16)
    flt = rng.standard_normal((2, 1, 16, n)).astype(F32) * 1000
    return ((iq[..., 0], iq[..., 1]), tuple(flt))


def _fft_err(got_re, got_im, pre, pim, win):
    z = (pre.astype(F64) + 1j * pim.astype(F64)) * win.astype(F64)
    want = np.fft.fft(z, axis=-1).transpose(0, 2, 1)
    peak = np.abs(np.concatenate([want.real, want.imag])).max()
    return max(np.abs(got_re - want.real).max(),
               np.abs(got_im - want.imag).max()) / peak


@pytest.mark.parametrize("n", NEW)
def test_plan_equals_fft(n):
    """Both entries (int16 I/Q and float planes) through the model against
    np.fft.fft of the windowed chirps, within 1e-6 of the peak; two groups
    of 8 chirps."""
    win, tw = (x.numpy() for x in F._tables(n, "cpu"))
    assert np.array_equal(win, hamming_float(n))
    for pre, pim in _stimuli(n, n):
        got = kernel_model(pre, pim, win, tw)
        assert _fft_err(*got, pre, pim, win) <= 1e-6, n


@pytest.mark.parametrize("n", [384, 1920, 2048])
def test_plan_needs_its_dense_stage_twiddles(n):
    """Mutation check: W_o^e conjugated (o odd; the classes come out
    mirrored) or W_n^(i1 k2) conjugated (2048) puts the model far off
    np.fft.fft."""
    win, tw = (x.numpy() for x in F._tables(n, "cpu"))
    o, m = F.range_fft_split(n)
    bad = tw.copy()
    if o > 2:
        bad[m + n:, 1] *= -1
    else:
        bad[m:m + n, 1] *= -1
    pre, pim = _stimuli(n, 7)[0]
    assert _fft_err(*kernel_model(pre, pim, win, bad), pre, pim, win) > 0.1


@pytest.mark.parametrize("is_float", [False, True], ids=["int16", "float"])
def test_plan_fits_a_block(is_float):
    """Every length's plan: a group fits an H100 block's shared memory
    (the kernel's static_assert), at most 256 threads, no idle slice in the
    first round, the m-point plan one of the powers of two's; the powers of
    two keep one slice of one round."""
    for n in NEW + POW2:
        P = plan(n, is_float)
        assert P["smem"] <= SMEM and P["threads"] <= 256, (n, P)
        assert P["o"] <= 15 and P["m"] in POW2 and P["o"] * P["m"] == n
        assert P["slices"] <= P["o"] <= P["slices"] * P["rounds"]
        assert (P["o"] == 1) == (n in POW2)
        assert P["rounds"] * P["slices"] - P["o"] < P["slices"]
    assert plan(2048, True)["smem"] == 198928


def test_tables_layout():
    """n = o x m: tw[ka N2 + t] = W_m^(t ka) (the m-point plan's table),
    then W_n^(i1 k2) at [m + k2 m + i1], then W_o^e at [m + n + e], each
    float64 cos/sin rounded to float32; at the powers of two 16 .. 1024
    the table is the one it was, n entries tw[ka N2 + t] = W_n^(t ka)."""
    def w(x):
        return np.stack([np.cos(-2 * np.pi * x), np.sin(-2 * np.pi * x)],
                        -1).astype(F32)
    for n in NEW + POW2:
        o, m = F.range_fft_split(n)
        n1, n2 = F.range_fft_plan(m)
        tw = F._tables(n, "cpu")[1].numpy()
        ka, t = np.divmod(np.arange(m), n2)
        want = [w(t * ka / m)]
        if o > 1:
            k2, i1 = np.divmod(np.arange(n), m)
            want += [w(i1 * k2 / n), w(np.arange(o) / o)]
        assert np.array_equal(tw, np.concatenate(want)), n
        assert len(tw) == (n if o == 1 else m + n + o)


def test_lengths_kernel_a_takes():
    """Kernel A's lengths: the powers of two 16 .. 1024 and every n2 x
    128 with n2 <= 16 (JAX's gate); 320, 4096, 48 and 2176 refused, as
    JAX refuses 320 and 4096."""
    taken = [n for n in range(1, 4097) if F.range_length_ok(n)]
    assert taken == sorted(set(POW2 + list(range(128, 2049, 128))))
    for n in taken:
        jp = fmcw_tpu.RadarParams(n_range=n)
        assert jpl.frontend_kernel_supported(jp) or n < 128
    for n in (320, 4096, 48, 2176):
        assert not F.range_length_ok(n)
        assert not F.fused_detect_supported(
            fmcw_tpu_torch.RadarParams(n_range=n, n_doppler=16))


# ---------------------------------------------------------------------------
# Kernel B: the row tile
# ---------------------------------------------------------------------------

def test_tile_choice():
    """T = 64 wherever it fits (today's shapes launch as before: the old
    rule was min(64, R)); 32 for 2048 rows at JAX's block scale 16 (48
    halo rows) and for range shards of 96 (384 / 4) and 352 (1408 / 4)
    rows."""
    cell = fmcw_tpu_torch.CfarParams()
    b16 = fmcw_tpu_torch.CfarParams(scale_mode="block", scale_block=16)
    cfg = F._slowtime_config(1, 2048, 128, b16, 0, 2)
    assert (cfg.T, cfg.H) == (32, 48)
    for rows in (96, 352):
        assert F._slowtime_config(1, rows, 128, cell, 0, 2).T == 32
    for R in (16, 32, 64, 128, 256, 512, 1024, 384, 1536, 2048):
        for cfar in (cell, fmcw_tpu_torch.fast().cfar,
                     fmcw_tpu_torch.quick().cfar,
                     fmcw_tpu_torch.CfarParams(scale_mode="block",
                                               scale_block=max(R // 128, 2))):
            for nd, pgr in ((128, 0), (128, 2), (64, 1), (32, 2)):
                if _old_tile_fits(R, nd, cfar, pgr):
                    assert F._slowtime_config(1, R, nd, cfar, 0,
                                              pgr).T == min(64, R)


def _old_tile_fits(nr, nd, cfar, pgr):
    """The rule before the tile search: T = min(64, R) or no tile."""
    tile, halo = min(64, nr), F._kernel_halo(cfar, pgr)
    sb = cfar.scale_block
    return (nr % tile == 0 and tile + 2 * halo <= kernels.MAX_ROWS
            and cfar.halo_doppler < nd and pgr < nd
            and (cfar.scale_mode != "block"
                 or (tile % sb == 0 and nd % sb == 0
                     and (tile + 2 * halo) // sb * (nd // sb)
                     <= kernels.MAX_BLK)))


@pytest.mark.parametrize("mode,sb,pgr", [("cell", 1, 2), ("block", 8, 2),
                                         ("block", 8, 0), ("cell", 1, 0)])
def test_decide_model_at_384_rows_tiled_by_32(mode, sb, pgr):
    """The kernel's decide (``kernel_decide``: column sums, strips of 8,
    the wrapped halo rows) tiled at T = 32 on tie-heavy maps of 384 rows
    equals ``detect_plain`` bit for bit: decisions, grouping, row maxima,
    counts."""
    cfar = fmcw_tpu_torch.CfarParams(scale_mode=mode, scale_block=sb)
    mag = tie_map(np.random.default_rng(sb + pgr), 2, 384, 32)
    got = kernel_decide(mag, cfar, 0, pgr, tile=32)
    want = F.detect_plain(torch.as_tensor(mag), cfar, 0, pgr)
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
    assert got[2].min() > 0


# ---------------------------------------------------------------------------
# The processors
# ---------------------------------------------------------------------------

def _jparams(p):
    return fmcw_tpu.RadarParams(
        n_range=p.n_range, n_doppler=p.n_doppler,
        cfar=fmcw_tpu.CfarParams(**dataclasses.asdict(p.cfar)),
        tracker=fmcw_tpu.TrackerParams(**dataclasses.asdict(p.tracker)))


def _params(nr, nd, mode="cell", sb=1):
    return fmcw_tpu_torch.RadarParams(
        n_range=nr, n_doppler=nd,
        cfar=fmcw_tpu_torch.CfarParams(scale_mode=mode, scale_block=sb))


@pytest.mark.parametrize("nr,nd,mode,sb", [
    (384, 32, "cell", 1), (384, 32, "block", 8), (2048, 16, "cell", 1),
    (2048, 16, "block", 16)])
def test_batch_processor_margin_gate_vs_jax_xla(nr, nd, mode, sb):
    """Float "auto" is the fused route at the new lengths (kernel A, then
    kernel B: both take the frame); on the CPU its twins against JAX's XLA
    chain through the margin gate (det map and top-K), magnitudes within
    1e-5 of the peak."""
    p = _params(nr, nd, mode, sb)
    iq = tpl.complex_to_iq(tref.two_target_frame(p))
    ref = jax.tree.map(np.asarray, jpl.make_processor(
        _jparams(p), frontend="xla", include_debug=True,
        peak_group_radius=2)(iq))
    assert tpl.make_batch_processor(p, device="cpu").route == "fused"
    out = tpl.make_processor(p, peak_group_radius=2, device="cpu")(iq)
    maps = (ref["mag_map"], ref["threshold_map"], ref["scale_map"])
    for a, b in ((parity.map_set(out["det_map"].numpy()),
                  parity.map_set(ref["det_map"])),
                 (parity.detection_set(out), parity.detection_set(ref))):
        ok, report = parity.margin_gate(a, b, *maps, radius=2,
                                        targets=tref.golden_targets(p),
                                        capacity=p.tracker.max_dets)
        assert ok, report
    mag = out["mag_map"].numpy()
    assert np.max(np.abs(mag - ref["mag_map"])) <= TOL * ref["mag_map"].max()


def test_array_model_gate_vs_jax_xla():
    """The array model at 384x32 (8 elements, 4 beams): "auto" is the
    fused route (kernel A's float entry, kernel B per beam); its twins
    against JAX's XLA array processor through the array gate, the point
    source at its matched beam."""
    p = _params(384, 32)
    n_elems, n_beams, u0 = 8, 4, 0.4
    rng = np.random.default_rng(13)
    z = np.asarray(tref.two_target_frame(p, seed=13,
                                         targets=[(200, 20, 12000)]))
    iq = np.stack([tpl.complex_to_iq(
        z * np.exp(2j * np.pi * 0.5 * e * u0)
        + rng.normal(0, 8, z.shape) + 1j * rng.normal(0, 8, z.shape))
        for e in range(n_elems)])
    kw = dict(peak_group_radius=2, beam_group_radius=1)
    ref = jax.tree.map(np.asarray, jpl.make_array_processor(
        _jparams(p), n_elems=n_elems, n_beams=n_beams, frontend="xla",
        **kw)(iq))
    M = ref["mag_cube"]
    _, T, S = C.cfar_3d(torch.tensor(M), 0, p.cfar, 0, 0, need_debug=True)
    proc = tpl.make_array_processor(p, n_elems=n_elems, n_beams=n_beams,
                                    device="cpu", **kw)
    assert proc.route == "fused"
    out = proc(iq)
    u = np.linspace(-np.sin(np.deg2rad(60.0)), np.sin(np.deg2rad(60.0)),
                    n_beams)
    beam = int(np.argmin(np.abs(u - u0)))
    ok, report = parity.array_gate(
        parity.array_set(out), parity.array_set(ref), M, T.numpy(),
        S.numpy(), radius=2, beam_radius=1, targets=[(200, 20, 12000)],
        target_beam=beam, capacity=p.tracker.max_dets)
    assert ok, report
    assert int(out["beam_bin"][0]) == beam
    assert np.max(np.abs(out["mag_cube"].numpy() - M)) <= TOL * float(M.max())


@pytest.mark.parametrize("kw", [dict(), dict(include_debug=True)],
                         ids=["frames", "debug"])
def test_local_mesh_equals_single_device(kw):
    """The sharded processor on a LocalMesh at sp 2 (kernel A on chirp
    shards, kernel B's split entry on the 192-row range shards, their
    twins here; the debug taps' tail) equals the single-device processor
    at 384x32, every output."""
    p = _params(384, 32)
    iq = np.stack([tpl.complex_to_iq(tref.two_target_frame(p, seed=s))
                   for s in range(2)])
    kw = dict(peak_group_radius=2, include_maps=True, **kw)
    proc = make_sharded_processor(LocalMesh(1, 2, "cpu"), p, **kw)
    assert proc.route == "fused"
    got = proc(iq)
    want = tpl.make_batch_processor(p, device="cpu", **kw)(iq)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_fixed_mode_at_384():
    """Fixed "auto" at 384x32 is the staged route, and fixed "fused" the
    fixed kernels' route (their twins here) on one device and on a
    LocalMesh at sp 1 and 2; each equals the golden model bit for bit;
    ``fused_fixed_detect_supported`` agrees with JAX's gate (both True:
    JAX's fused fixed kernel takes 384 x 32 per-cell)."""
    p = _params(384, 32)
    z = tref.two_target_frame(p)
    iq = tpl.complex_to_iq(z)[None]
    mag, det = tref.process_frame_fixed(z, p)
    assert FX.fused_fixed_detect_supported(p)
    assert jpl.fused_fixed_detect_supported(_jparams(p))
    for fe, route in (("auto", "staged"), ("fused", "fused")):
        proc = tpl.make_batch_processor(p, mode="fixed", frontend=fe,
                                        device="cpu")
        assert proc.route == route
        out = proc(iq)
        assert np.array_equal(out["det_map"][0].numpy(), det)
        assert np.array_equal(out["mag_map"][0].numpy(), mag)
    for sp in (1, 2):
        out = make_sharded_processor(LocalMesh(1, sp, "cpu"), p,
                                     mode="fixed", frontend="fused",
                                     include_maps=True)(iq)
        assert np.array_equal(out["det_map"][0].numpy(), det)
        assert np.array_equal(out["mag_map"][0].numpy(), mag)


def test_refused_lengths_take_the_staged_route():
    """320 and 4096 (JAX's refusals): float "auto" is the staged route,
    the array model's too, and kernel A's check raises (the wrappers ask it
    before any launch, tests/test_torch_isolation.py)."""
    for nr in (320, 4096):
        p = _params(nr, 16)
        assert tpl.make_batch_processor(p, device="cpu").route == "staged"
        assert tpl.make_array_processor(p, n_elems=2, n_beams=2,
                                        device="cpu").route == "staged"
        with pytest.raises(NotImplementedError):
            F.check_range_geometry(nr, 16)


def test_plan_through_the_twin_vs_jax_interpret_kernel():
    """JAX's fused kernel (rdm_frontend, interpret mode) at 384x16 against
    the model of kernel A's plan through kernel B's magnitude twin: within
    2e-4 of the peak (the bf16x3 contract, tests/test_torch_array.py), and
    the model within 1e-5 of the twin's magnitudes."""
    p = fmcw_tpu_torch.RadarParams(n_range=384, n_doppler=16)
    iq = tpl.complex_to_iq(tref.two_target_frame(p))
    jk = np.asarray(rdm_frontend(jnp.asarray(iq), interpret=True))
    win, tw = (x.numpy() for x in F._tables(384, "cpu"))
    re, im = kernel_model(iq[None, ..., 0], iq[None, ..., 1], win, tw)
    mag = F.slowtime_mag_plain(torch.as_tensor(re), torch.as_tensor(im),
                               False)[0].numpy()
    twin = F.slowtime_mag_plain(*F.range_fft_plain(torch.as_tensor(iq)[None]),
                                False)[0].numpy()
    assert np.max(np.abs(mag - jk)) <= 2e-4 * float(jk.max())
    assert np.max(np.abs(mag - twin)) <= TOL * float(twin.max())
