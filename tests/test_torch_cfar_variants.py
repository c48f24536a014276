"""The CA/GO/SO CFAR variants of the port against the JAX package and the
golden model, on the CPU.

* Plain ``cfar_2d``: decisions and scales equal to JAX's XLA ``cfar_2d``,
  per-cell and block scale, override 0 and 6, on a whole map and a
  prepadded range shard; thresholds bit for bit on int32 maps.  Float32
  thresholds are not always bit-equal to JAX's: the sums are
  (``test_window_estimate_orders``: JAX's association orders), but XLA:CPU
  multiplies by the rounded reciprocal of a constant count where the port
  (and kernel B) divide, IEEE, so the means differ by up to 1 ulp, and a
  scale of 6 makes that up to 2 ulps of the threshold.  They equal JAX's
  sums divided IEEE (numpy) bit for bit.  Integer maps also equal the
  golden ``os_cfar_2d`` (threshold and detections).
* ``cfar_3d`` (ref_angle 0 and 1) and ``cfar_1d`` (wrap, reflect)
  against JAX's; ``cfar_1d`` also against golden ``os_cfar_1d``.
* Kernel B's twin: on the magnitudes of JAX's fused kernel (interpret
  mode, 256x64) its decisions equal the kernel's, per-cell and block; the
  split twin equals the whole-frame twin on every shard.
* The processors: the float routes within the margin gate of JAX's XLA
  chain, fixed ``auto`` equal to the golden model, a LocalMesh at sp 2
  equal to the single device (frame and array processors).
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import fmcw_tpu
import fmcw_tpu_torch
from fmcw_tpu.golden import fixed_point as jfx
from fmcw_tpu.models import pipeline as jpl
from fmcw_tpu.ops import cfar as JC
from fmcw_tpu.ops.frontend_pallas import rdm_frontend
from fmcw_tpu_torch import parity
from fmcw_tpu_torch.golden import fixed_point as tfx, reference as tref
from fmcw_tpu_torch.models import pipeline as tpl
from fmcw_tpu_torch.ops import cfar as TC, frontend as F
from fmcw_tpu_torch.ops import split_frontend as SF
from fmcw_tpu_torch.parallel import LocalMesh, sharded

# Share the CPU with the other test workers (the suite runs 6 at once).
torch.set_num_threads(2)

MEAN_VARIANTS = ("ca", "go", "so")
SMALL = fmcw_tpu_torch.CfarParams(ref_range=2, ref_doppler=2, guard_range=1,
                                  guard_doppler=1)


def _jcfar(cfar):
    return fmcw_tpu.CfarParams(**dataclasses.asdict(cfar))


def _jparams(p):
    return fmcw_tpu.RadarParams(
        n_range=p.n_range, n_doppler=p.n_doppler, notch_mode=p.notch_mode,
        cfar=_jcfar(p.cfar),
        tracker=fmcw_tpu.TrackerParams(**dataclasses.asdict(p.tracker)))


def _golden_map(seed=0, shape=(64, 32)):
    """tests/test_cfar_variants.py's integer map: noise and two targets."""
    rng = np.random.default_rng(seed)
    m = rng.integers(80, 121, shape).astype(np.int32)
    m[20, 10] += 4000
    m[45, 25] += 3000
    return m


def _clutter(shape, seed, integer):
    """Exponential noise with a clutter band (every scale class occurs),
    equal values and bright targets."""
    rng = np.random.default_rng(seed)
    m = rng.exponential(100.0, shape)
    r = shape[-2]
    m[..., r // 4:r // 2, :] *= np.where(
        rng.random(m[..., r // 4:r // 2, :].shape) < 0.3, 12.0, 1.0)
    q = rng.random(shape) < 0.2
    m[q] = np.round(m[q] / 25.0) * 25.0
    m[..., 7, 5] = m[..., 9, 20] = 6000.0
    return m.astype(np.int32 if integer else np.float32)


def _ulps(a, b):
    """|a - b| in float32 units in the last place (finite values)."""
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32))


def _thresholds_agree(got, want, integer):
    """Bit for bit (integer), or within 2 ulp where finite (float; the
    module docstring) and equal where not."""
    if integer:
        assert np.array_equal(got, want)
        return
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    assert _ulps(got[fin], want[fin]).max() <= 2
    assert np.array_equal(got[~fin], want[~fin], equal_nan=True)


def _ieee_thresholds(m, cfar, scale, prepadded):
    """JAX's formula with IEEE division: its ``_ref_sums`` (bit-equal to the
    port's) over the counts in numpy float32, times ``scale``."""
    f32 = np.float32
    s, lead, lag, n_half = JC._ref_sums(jnp.asarray(m), _jcfar(cfar),
                                        prepadded)
    if cfar.variant == "ca":
        est = np.asarray(s) / f32(cfar.n_ref)
    else:
        pick = np.maximum if cfar.variant == "go" else np.minimum
        est = pick(np.asarray(lead) / f32(n_half),
                   np.asarray(lag) / f32(n_half))
    return est * scale.astype(f32)


@pytest.mark.parametrize("variant", MEAN_VARIANTS)
@pytest.mark.parametrize("integer", [True, False], ids=["int32", "float32"])
@pytest.mark.parametrize("scale_mode", ["cell", "block"])
def test_cfar_2d_vs_jax_xla(variant, integer, scale_mode):
    """Decisions and scales equal, thresholds bit for bit (int32; float32:
    to JAX's sums divided IEEE, within 2 ulp of JAX's), override 0 and 6,
    on a 128x64 map and a prepadded range shard of it (block scale given
    as the scale map, as the sharded processor gives it)."""
    cfar = dataclasses.replace(SMALL, variant=variant, scale_mode=scale_mode,
                               scale_block=4)
    m = _clutter((128, 64), 3, integer)
    hr = cfar.halo_range
    shard = m[32 - hr:64 + hr]
    for so in (0, 6):
        det, thr, sc = TC.cfar_2d(torch.as_tensor(m), so, cfar,
                                  need_debug=True)
        jd, jt, js = JC.cfar_2d(jnp.asarray(m), so, cfar=_jcfar(cfar),
                                integer=integer)
        assert np.array_equal(det.numpy(), np.asarray(jd))
        assert np.array_equal(sc.numpy(), np.asarray(js).astype(np.int32))
        assert thr.dtype == det.dtype
        _thresholds_agree(thr.numpy(), np.asarray(jt), integer)
        if not integer:
            assert np.array_equal(thr.numpy(), _ieee_thresholds(
                m, cfar, np.asarray(js), False))
        assert int((det > 0).sum()) > 0
        smap = None if scale_mode == "cell" else sc[32:64]
        det, thr, sc = TC.cfar_2d(torch.as_tensor(shard), so, cfar,
                                  need_debug=True, scale_map=smap,
                                  prepadded_range=True)
        jd, jt, js = JC.cfar_2d(
            jnp.asarray(shard), so, cfar=_jcfar(cfar), integer=integer,
            prepadded_range=True,
            scale_map=None if smap is None else jnp.asarray(smap.numpy()))
        assert np.array_equal(det.numpy(), np.asarray(jd))
        _thresholds_agree(thr.numpy(), np.asarray(jt), integer)
        if not integer:
            assert np.array_equal(thr.numpy(), _ieee_thresholds(
                shard, cfar, np.asarray(js), True))
        assert np.array_equal(sc.numpy(), np.asarray(js).astype(np.int32))


@pytest.mark.parametrize("shape,cfar,seed", [
    ((64, 32), SMALL, 0),
    ((128, 128), fmcw_tpu_torch.CfarParams(), 9)], ids=["64x32", "128x128"])
def test_cfar_2d_int_vs_golden(shape, cfar, seed):
    """tests/test_cfar_variants.py's cases against the port's golden
    model: threshold and detection maps equal, every variant."""
    if shape == (64, 32):
        m = _golden_map(seed, shape)
    else:
        rng = np.random.default_rng(seed)
        m = rng.integers(50, 2000, shape).astype(np.int32)
        m[64, 64] = 40000
    for variant in ("os",) + MEAN_VARIANTS:
        cf = dataclasses.replace(cfar, variant=variant)
        det, thr, _ = TC.cfar_2d(torch.as_tensor(m), 0, cf, need_debug=True)
        gdet, gthr, _ = tfx.os_cfar_2d(m.astype(np.int64), cf,
                                       return_debug=True)
        assert np.array_equal(thr.numpy(), gthr), variant
        assert np.array_equal(det.numpy(), gdet), variant


def test_window_estimate_orders():
    """The sums' association orders: sum_refs the box sums (rows, then
    columns), lead / lag the row sums (columns, then rows) — against
    JAX's _ref_sums bit for bit on a float map with a wide dynamic
    range, where another order rounds differently."""
    rng = np.random.default_rng(11)
    m = (rng.exponential(1.0, (64, 32))
         * 10.0 ** rng.integers(-3, 4, (64, 32))).astype(np.float32)
    cfar = fmcw_tpu_torch.CfarParams()
    p = TC._wrap_pad(torch.as_tensor(m), cfar.halo_range, cfar.halo_doppler)
    lead, lag, n_half = TC._half_sums(p, cfar)
    js, jl, jg, jn = JC._ref_sums(jnp.asarray(m), _jcfar(cfar))
    assert n_half == jn == cfar.ref_range * cfar.win_doppler
    assert np.array_equal(TC._sum_refs(p, cfar).numpy(), np.asarray(js))
    assert np.array_equal(lead.numpy(), np.asarray(jl))
    assert np.array_equal(lag.numpy(), np.asarray(jg))
    # The lead sums with the column sums reused (rows first, then columns)
    # round differently on this map: the order is what makes them equal.
    cols = p[..., 0:cfar.ref_range, :]
    cols = sum(p[..., i:i + 64, :] for i in range(1, cfar.ref_range)) + \
        p[..., 0:64, :]
    other = cols[..., 0:32]
    for j in range(1, cfar.win_doppler):
        other = other + cols[..., j:j + 32]
    assert not np.array_equal(other.numpy(), lead.numpy())


def test_nan_and_inf_propagate_as_jax():
    """Non-finite cells: GO / SO take NaN when either half is NaN (as
    jnp.maximum / minimum) and no NaN or inf threshold detects."""
    m = _clutter((64, 32), 5, False)
    m[10, 3] = np.nan
    m[40, 20] = np.inf
    m[41, 20] = -np.inf
    for variant in MEAN_VARIANTS:
        cfar = dataclasses.replace(SMALL, variant=variant)
        det, thr, sc = TC.cfar_2d(torch.as_tensor(m), 0, cfar,
                                  need_debug=True)
        jd, jt, js = JC.cfar_2d(jnp.asarray(m), 0, cfar=_jcfar(cfar))
        assert np.array_equal(det.numpy(), np.asarray(jd), equal_nan=True)
        _thresholds_agree(thr.numpy(), np.asarray(jt), False)
        assert np.array_equal(sc.numpy(), np.asarray(js).astype(np.int32))
        assert np.isnan(thr.numpy()).any()


@pytest.mark.parametrize("ref_angle", [0, 1])
@pytest.mark.parametrize("integer", [True, False], ids=["int32", "float32"])
def test_cfar_3d_variants_vs_jax(ref_angle, integer):
    """Integer cubes bit for bit.  Float cubes: at ref_angle 0 (cfar_2d
    per plane) thresholds within 2 ulp (the module docstring) and decisions
    equal; at ref_angle 1 thresholds within 2e-6 and decisions equal
    outside cuts that close to them (JAX sums the 3D training stack in one
    XLA reduction, the port in the 3D kernel's order)."""
    cube = np.stack([_clutter((64, 32), s, integer) for s in range(4)])
    for variant in MEAN_VARIANTS:
        cfar = dataclasses.replace(SMALL, variant=variant)
        # The override only at ref_angle 1 (cfar_2d's is tested above).
        for so in ((0, 2) if ref_angle else (0,)):
            d, t, s = TC.cfar_3d(torch.as_tensor(cube), so, cfar,
                                 ref_angle=ref_angle, need_debug=True)
            if so == 0:
                assert int((d > 0).sum()) > 0
            jd, jt, js = JC.cfar_3d(jnp.asarray(cube), so, cfar=_jcfar(cfar),
                                    integer=integer, ref_angle=ref_angle,
                                    method="xla")
            jd, jt, js = map(np.asarray, (jd, jt, js))
            assert np.array_equal(s.numpy(), js.astype(np.int32))
            if integer or ref_angle == 0:
                assert np.array_equal(d.numpy(), jd), (variant, so)
                _thresholds_agree(t.numpy(), jt, integer)
            else:
                assert np.allclose(t.numpy(), jt, rtol=2e-6, atol=0), \
                    (variant, so)
                near = np.abs(cube - jt) <= 2e-6 * np.abs(jt)
                assert np.array_equal((d.numpy() > 0)[~near],
                                      (jd > 0)[~near]), (variant, so)


@pytest.mark.parametrize("edge_mode", ["wrap", "reflect"])
def test_cfar_1d_vs_jax_and_golden(edge_mode):
    rng = np.random.default_rng(2)
    x = rng.integers(0, 200, (6, 96)).astype(np.int32)
    x[:, 40] = 5000
    x[2, 0] = x[3, 95] = 4000                   # at the edges
    for kw in (dict(), dict(ref_cells=4, guard_cells=1, rank_idx=5,
                            scaling_mult=3, scaling_div=2)):
        got = TC.cfar_1d(torch.as_tensor(x), edge_mode=edge_mode, **kw)
        want = JC.cfar_1d(jnp.asarray(x), edge_mode=edge_mode, **kw)
        assert np.array_equal(got.numpy(), np.asarray(want))
        for row in range(x.shape[0]):
            g = tfx.os_cfar_1d(x[row], edge_mode=edge_mode, **kw)
            assert np.array_equal(g, jfx.os_cfar_1d(x[row],
                                                    edge_mode=edge_mode,
                                                    **kw))
            assert np.array_equal(got.numpy()[row], g)
        if not kw:
            xf = x.astype(np.float32) * 0.37
            got = TC.cfar_1d(torch.as_tensor(xf).T, axis=0,
                             edge_mode=edge_mode)
            want = JC.cfar_1d(jnp.asarray(xf).T, axis=0, edge_mode=edge_mode)
            assert np.array_equal(got.numpy(), np.asarray(want))
    # An int16 signal: the threshold is taken wide (no wrap), as golden's.
    x16 = (x * 6).astype(np.int16)
    got = TC.cfar_1d(torch.as_tensor(x16), edge_mode=edge_mode)
    assert got.dtype == torch.int16
    assert np.array_equal(got.numpy()[1], tfx.os_cfar_1d(x16[1],
                                                         edge_mode=edge_mode))


P256 = fmcw_tpu_torch.RadarParams(n_range=256, n_doppler=64)


@pytest.mark.parametrize("variant,scale_mode,so", [
    ("ca", "cell", 0), ("go", "cell", 0), ("so", "cell", 6),
    ("go", "block", 0)])
def test_twin_vs_jax_fused_kernel_interpret(variant, scale_mode, so):
    """Kernel B's twin (``detect_plain``) on the magnitudes of JAX's fused
    kernel (interpret mode) makes the kernel's decisions, row maxima and
    counts (tests/test_frontend_pallas.py's variant test): per-cell at
    quick() (its QUICK window), block at 256x64 (the kernel's own block
    grid, scale_block = n_range / 128); the override on one case.  The
    cases are cut to these four for time (each compiles the kernel)."""
    base = fmcw_tpu_torch.quick() if scale_mode == "cell" else P256
    p = base.replace(cfar=dataclasses.replace(
        base.cfar, variant=variant, scale_mode=scale_mode, scale_block=2))
    iq = tpl.complex_to_iq(tref.two_target_frame(p))
    det_s, mag, nf, row_max, n_dets = rdm_frontend(
        jnp.asarray(iq), jnp.asarray(False), interpret=True,
        cfar=_jcfar(p.cfar), detect=True,
        scale_override=jnp.asarray(so, jnp.int32))
    want = np.swapaxes(np.asarray(det_s), 0, 1).reshape(p.n_range,
                                                        p.n_doppler)
    det, rmax, ndet, nonf = F.detect_plain(
        torch.tensor(np.asarray(mag))[None], p.cfar, so)
    assert np.array_equal(det[0].numpy(), want)
    assert int(ndet[0]) == int(n_dets) == int((want > 0).sum()) > 0
    assert np.array_equal(np.sort(rmax[0].numpy()),
                          np.sort(np.asarray(row_max).ravel()))
    assert int(nonf[0]) == int(nf) == 0


@pytest.mark.parametrize("variant,pgr", [("ca", 0), ("go", 2), ("so", 1)])
@pytest.mark.parametrize("sp", [2, 4])
def test_split_twin_equals_whole_frame(variant, pgr, sp):
    """The split twin on range shards with exchanged halo rows equals the
    whole-frame twin's rows bit for bit (tests/test_split_frontend.py's
    monolithic comparison): det, magnitudes, row maxima, counts."""
    p = P256.replace(cfar=dataclasses.replace(P256.cfar, variant=variant))
    iq = torch.as_tensor(np.stack([tpl.complex_to_iq(
        tref.two_target_frame(p, seed=s)) for s in (1, 2)]))
    re, im = F.range_fft(iq)
    kw = dict(cfar=p.cfar, peak_group_radius=pgr, emit_mag=True)
    det, mag, rmax, ndet, nf = F.slowtime_detect(re, im, False, 0, **kw)
    nr, nrl = p.n_range, p.n_range // sp
    h = p.cfar.halo_range + pgr
    total = 0
    for s in range(sp):
        rows = torch.arange(s * nrl - h, (s + 1) * nrl + h) % nr
        lo, hi = rows[:h], rows[-h:]
        core = slice(s * nrl, (s + 1) * nrl)
        d, m, r, n, f = SF.slowtime_detect_split(
            re[:, core], im[:, core], (re[:, lo], im[:, lo]),
            (re[:, hi], im[:, hi]), False, 0, s * nrl, n_range_total=nr,
            **kw)
        assert torch.equal(d, det[:, core]) and torch.equal(m, mag[:, core])
        assert torch.equal(r, rmax[:, core])
        total = total + n
    assert torch.equal(total, ndet) and int(ndet.min()) > 0


def _xla_ref(p, iq, radius):
    jp = _jparams(p)
    ref = jpl.make_processor(jp, frontend="xla", include_debug=True,
                             peak_group_radius=radius)(iq)
    return jax.tree.map(np.asarray, ref)


@pytest.mark.parametrize("variant", MEAN_VARIANTS)
@pytest.mark.parametrize("scale_mode", ["cell", "block"])
def test_processor_routes_margin_gate_vs_xla(variant, scale_mode):
    """Float "auto" (kernel B's twin), "staged" and the debug taps at 256x64
    within the margin gate of JAX's XLA chain; the debug taps' threshold
    within 1e-5 of the peak of JAX's, their scale equal on all but the
    cells whose classification lies inside that tolerance."""
    p = P256.replace(cfar=dataclasses.replace(
        P256.cfar, variant=variant, scale_mode=scale_mode, scale_block=4))
    iq = tpl.complex_to_iq(tref.two_target_frame(p))
    ref = _xla_ref(p, iq, 2)
    maps = (ref["mag_map"], ref["threshold_map"], ref["scale_map"])
    tol = 1e-5 * float(ref["mag_map"].max())
    for kw in (dict(), dict(frontend="staged"), dict(include_debug=True)):
        out = tpl.make_processor(p, peak_group_radius=2, device="cpu",
                                 **kw)(iq)
        for a, b in ((parity.map_set(out["det_map"].numpy()),
                      parity.map_set(ref["det_map"])),
                     (parity.detection_set(out), parity.detection_set(ref))):
            ok, report = parity.margin_gate(
                a, b, *maps, radius=2, targets=tref.golden_targets(p),
                capacity=p.tracker.max_dets)
            assert ok, (kw, report)
        if kw.get("include_debug"):
            # Where the scales agree the thresholds are est * scale with
            # est within the magnitudes' tolerance; a scale may flip only
            # where est lies that close to 1.5x or 0.5x the mean.
            same = out["scale_map"].numpy() == ref["scale_map"]
            thr = out["threshold_map"].numpy()
            assert same.mean() > 0.999
            assert np.abs(thr - ref["threshold_map"])[same].max() <= \
                p.cfar.scale_max * tol


@pytest.mark.parametrize("variant", MEAN_VARIANTS)
def test_fixed_auto_equals_golden(variant):
    """Fixed ``auto`` (the staged route, the plain integer cfar_2d) equals
    the golden model's detections bit for bit, per-cell and block."""
    for scale_mode in ("cell", "block"):
        p = P256.replace(cfar=dataclasses.replace(
            P256.cfar, variant=variant, scale_mode=scale_mode,
            scale_block=4))
        z = tref.two_target_frame(p, seed=3)
        out = tpl.make_processor(p, mode="fixed", device="cpu")(
            tpl.complex_to_iq(z))
        _, det = tref.process_frame_fixed(z, p)
        assert np.array_equal(out["det_map"].numpy(), det), scale_mode
        assert int(out["n_dets"]) == int((det > 0).sum()) > 0


@pytest.mark.parametrize("variant", MEAN_VARIANTS)
def test_local_mesh_equals_single_device(variant):
    """make_sharded_processor on a LocalMesh at sp 2 equals the single
    device bit for bit: float "fused" per-cell (the split entry's twin)
    and block (the plain tail), fixed "auto"; the array model at sp 2
    (2D per-beam and 3D ref_angle 1)."""
    p = fmcw_tpu_torch.quick()
    iq = np.stack([tpl.complex_to_iq(tref.two_target_frame(p, seed=s))
                   for s in range(2)])
    for scale_mode, mode in (("cell", "float32"), ("block", "float32"),
                             ("cell", "fixed")):
        pv = p.replace(cfar=dataclasses.replace(
            p.cfar, variant=variant, scale_mode=scale_mode, scale_block=4))
        kw = dict(mode=mode, peak_group_radius=1, include_maps=True)
        a = sharded.make_sharded_processor(LocalMesh(1, 2, "cpu"), pv,
                                           **kw)(iq)
        b = tpl.make_batch_processor(pv, device="cpu", **kw)(iq)
        for k in b:
            assert torch.equal(a[k], b[k]), (scale_mode, mode, k)
    pv = p.replace(cfar=dataclasses.replace(p.cfar, variant=variant))
    z = tref.two_target_frame(p)
    cubes = np.stack([tpl.complex_to_iq(z * np.exp(2j * np.pi * 0.5 * e
                                                   * 0.3))
                      for e in range(4)])[None]
    for kw in (dict(peak_group_radius=1, beam_group_radius=1),
               dict(ref_angle=1)):
        kw.update(include_maps=True)
        a = sharded.make_sharded_array_processor(
            LocalMesh(1, 2, "cpu"), pv, n_elems=4, n_beams=4, **kw)(cubes)
        b = tpl.make_batch_array_processor(pv, n_elems=4, n_beams=4,
                                           device="cpu", **kw)(cubes)
        for k in b:
            assert torch.equal(a[k], b[k]), (kw, k)
