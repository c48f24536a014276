"""Fixed mode of the port (the reference's 16-bit chain) against the JAX
package, on the CPU.

The port's fixed chain transforms in float64 (fmcw_tpu_torch/ops/fft.py), so
its quantized values, magnitudes and detections equal the golden numpy
model's bit for bit; that is asserted directly.  The JAX package's fixed
routes transform in float32 (its XLA chain at HIGHEST, its fused kernel in
bf16x6): against them the detection sets, counts and saturation counts are
exact on these stimuli, and the magnitudes are held to 8 LSB, the tolerance
tests/test_frontend_fixed.py holds JAX's own two routes to (its XLA chain is
up to 6 LSB from its golden model on the full-size frames here).

Inputs are made with numpy from seeds; JAX stays on the CPU and its fused
kernel runs in interpret mode, at quick() and 256x64 only.
"""

import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import fmcw_tpu
import fmcw_tpu_torch
from fmcw_tpu.golden import fixed_point as jfx, reference as jref
from fmcw_tpu.models import pipeline as jpl
from fmcw_tpu.ops import fft as JF, magnitude as JM, notch as JN
from fmcw_tpu.ops import window as JW
from fmcw_tpu_torch import parity
from fmcw_tpu_torch.golden import fixed_point as tfx, reference as tref
from fmcw_tpu_torch.models import pipeline as tpl
from fmcw_tpu_torch.ops import fft as TF, magnitude as TM, notch as TN
from fmcw_tpu_torch.ops import frontend_fixed as FX
from fmcw_tpu_torch.ops import window as TW

# Share the CPU with the other test workers (the suite runs 6 at once).
torch.set_num_threads(2)

LSB = 8          # magnitudes against JAX's float32 routes (see above)


def _jparams(p):
    return fmcw_tpu.RadarParams(
        n_range=p.n_range, n_doppler=p.n_doppler, notch_mode=p.notch_mode,
        cfar=fmcw_tpu.CfarParams(**dataclasses.asdict(p.cfar)),
        tracker=fmcw_tpu.TrackerParams(**dataclasses.asdict(p.tracker)))


def _ints(seed, shape, lo=-32768, hi=32768):
    return np.random.default_rng(seed).integers(lo, hi, shape)


def _hot(p, seed):
    """The saturating stimulus of tests/test_frontend_fixed.py: the golden
    frame x 40, clipped to int16."""
    z = np.clip(np.asarray(tref.two_target_frame(p, seed=seed)) * 40,
                -32768, 32767)
    return tpl.complex_to_iq(z)


def _noisy(p, seed):
    """The golden frame plus seeded +-8 noise (chip_smoke.make_batch)."""
    frame = tpl.complex_to_iq(tref.two_target_frame(p))
    return frame + np.random.default_rng(seed).integers(
        -8, 8, frame.shape).astype(np.int16)


def _det_set(det_map):
    return set(zip(*np.nonzero(np.asarray(det_map))))


# ---------------------------------------------------------------------------
# Stage ops, bitwise against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rounding", ["unbiased", "biased"])
@pytest.mark.parametrize("amp", [300, 32768], ids=["small", "full-scale"])
def test_window_apply_fixed_bitwise(rounding, amp):
    i, q = _ints(1, (8, 64), -amp, amp), _ints(2, (8, 64), -amp, amp)
    c = TW.hamming_q15(64)
    assert np.array_equal(c, JW.hamming_q15(64))
    ji, jq, js = JW.window_apply_fixed(jnp.asarray(i), jnp.asarray(q),
                                       c[None, :], 16, rounding)
    ti, tq, ts = TW.window_apply_fixed(torch.as_tensor(i), torch.as_tensor(q),
                                       c[None, :], 16, rounding)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert int(ts) == int(js)
    assert (int(ts) > 0) == (amp == 32768)


@pytest.mark.parametrize("mode", [2, 3])
@pytest.mark.parametrize("transient", ["zero", "passthrough"])
@pytest.mark.parametrize("bypass", [False, True])
def test_mti_notch_fixed_bitwise(mode, transient, bypass):
    """Full-scale int16 inputs, so the differences saturate."""
    i, q = _ints(3, (16, 32)), _ints(4, (16, 32))
    ji, jq = JN.mti_notch_fixed(jnp.asarray(i), jnp.asarray(q), axis=-1,
                                mode=mode, bypass=bypass, transient=transient)
    ti, tq = TN.mti_notch_fixed(torch.as_tensor(i), torch.as_tensor(q), mode,
                                bypass, transient)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    if not bypass:
        assert ti.numpy().max() == 32767 and ti.numpy().min() == -32768


def test_magnitude_fixed_bitwise():
    i, q = _ints(5, (64, 32)), _ints(6, (64, 32))
    j = np.asarray(JM.magnitude_fixed(jnp.asarray(i), jnp.asarray(q)))
    t = TM.magnitude_fixed(torch.as_tensor(i), torch.as_tensor(q))
    assert t.dtype == torch.int32
    assert np.array_equal(t.numpy(), j)
    assert np.array_equal(t.numpy(), tfx.magnitude(i, q))


def test_bfp_quantize_bitwise_vs_jax():
    """Random float32 spectra over many octaves: the port's bfp_quantize
    (exponent from the float bits) against JAX's (jnp.log2)."""
    rng = np.random.default_rng(7)
    scale = 2.0 ** rng.integers(0, 26, (32, 1))
    re = (rng.standard_normal((32, 128)) * scale).astype(np.float32)
    im = (rng.standard_normal((32, 128)) * scale).astype(np.float32)
    jr, ji = JF.bfp_quantize(jnp.asarray(re), jnp.asarray(im), axis=1)
    tr, ti = TF.bfp_quantize(torch.as_tensor(re), torch.as_tensor(im))
    assert np.array_equal(tr.numpy(), np.asarray(jr))
    assert np.array_equal(ti.numpy(), np.asarray(ji))


def _golden_q(peak: float) -> float:
    """The golden model's quantized value of a slice whose peak is
    ``peak`` (bfp_fft's exponent: float64 ceil(log2))."""
    s = max(np.ceil(np.log2(max(peak, 1.0) / 32768.0)), 0.0)
    return float(np.clip(np.rint(peak / 2.0 ** s), -32768, 32767))


@pytest.mark.parametrize("k", range(12))
def test_bfp_power_of_two_peaks(k):
    """Peaks of exactly 2^(15+k) (the saturating corner: +32768 clips to
    32767), 2^(15+k)*(1+2^-23) and 2^(15+k)-1, in float32 and float64.

    The one disagreement, written down in PERF.md: for 2^(15+k)*(1+2^-23)
    with k >= 3, JAX's float32 jnp.log2 rounds down to 15+k, so its
    exponent is one short and the peak clips to 32767; the port reads the
    exponent from the bits and gives 16384, as the golden model's float64
    log2 does.  In float64 the same corner sits at (1+2^-52), where the
    golden model's own log2 rounds down and the port's bits do not."""
    base = 2.0 ** (15 + k)
    for name, v in (("pow2", base), ("pow2+ulp", base * (1 + 2.0 ** -23)),
                    ("pow2-1", base - 1)):
        v32 = np.float32(v)
        x = np.asarray([v32, 1.0], np.float32)
        zero = np.zeros(2, np.float32)
        tq = float(TF.bfp_quantize(torch.as_tensor(x),
                                   torch.as_tensor(zero))[0][0])
        jq = float(JF.bfp_quantize(jnp.asarray(x), jnp.asarray(zero),
                                   axis=0)[0][0])
        gq = _golden_q(float(v32))
        assert tq == gq, (name, tq, gq)
        if name == "pow2+ulp" and k >= 3:
            assert (jq, tq) == (32767.0, 16384.0)
        else:
            assert jq == tq, (name, jq, tq)
        t64 = float(TF.bfp_quantize(torch.as_tensor(x.astype(np.float64)),
                                    torch.as_tensor(zero.astype(
                                        np.float64)))[0][0])
        assert t64 == gq
    v = base * (1 + 2.0 ** -52)
    t64 = float(TF.bfp_quantize(torch.tensor([v, 1.0], dtype=torch.float64),
                                torch.zeros(2, dtype=torch.float64))[0][0])
    assert t64 == 16384.0
    assert _golden_q(v) == (16384.0 if k < 4 else 32767.0)


# ---------------------------------------------------------------------------
# The golden copy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, dict(mti_bypass=True, scale_override=3),
    dict(mti_transient="passthrough", window_rounding="biased"),
], ids=["default", "bypass-so3", "hw-exact"])
@pytest.mark.parametrize("scale_mode", ["cell", "block"])
def test_golden_copy_bitwise(kw, scale_mode):
    """The port's golden fixed chain and its parts == fmcw_tpu.golden's, at
    256x64."""
    p = fmcw_tpu_torch.RadarParams(
        n_range=256, n_doppler=64,
        cfar=fmcw_tpu_torch.CfarParams(scale_mode=scale_mode, scale_block=2))
    jp = _jparams(p)
    z = tref.two_target_frame(p, seed=2)
    assert np.array_equal(z, jref.two_target_frame(jp, seed=2))
    tm, td = tref.process_frame_fixed(z, p, **kw)
    jm, jd = jref.process_frame_fixed(z, jp, **kw)
    assert np.array_equal(tm, jm) and np.array_equal(td, jd)
    assert np.array_equal(tfx.block_scale_map(tm, p.cfar, 3),
                          jfx.block_scale_map(jm, jp.cfar, 3))
    for radius in (1, 2):
        tg, jg = tfx.peak_group(td, radius), jfx.peak_group(jd, radius)
        assert np.array_equal(tg, jg)
        for a, b in zip(tfx.extract_detections(tg),
                        jfx.extract_detections(jg)):
            assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# The staged route (JAX's frontend="xla") at full size
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_fixed(preset):
    """JAX's fixed XLA chain for a preset, compiled once per module."""
    return jpl.make_processor(_jparams(getattr(fmcw_tpu_torch, preset)()),
                              mode="fixed", include_maps=True)


@pytest.mark.parametrize("preset,stimulus", [
    ("full", "golden"), ("full", "x40"), ("fast", "noisy")])
def test_staged_fixed_full_size_vs_jax_and_golden(preset, stimulus):
    """make_batch_processor(p, mode="fixed", device="cpu") (the staged
    route) against JAX's make_processor(mode="fixed") at 1024x128: the same
    detection set, n_dets, saturation count and top-K set, magnitudes within
    LSB; and bit for bit the golden model's magnitude and detection maps."""
    p = getattr(fmcw_tpu_torch, preset)()
    iq = {"golden": lambda: tpl.complex_to_iq(tref.two_target_frame(p)),
          "noisy": lambda: _noisy(p, 9),
          "x40": lambda: _hot(p, 5)}[stimulus]()
    out = tpl.make_batch_processor(p, mode="fixed", device="cpu")(iq[None])
    out = {k: v[0].numpy() for k, v in out.items()}
    ref = jax.tree.map(np.asarray, _jax_fixed(preset)(iq))
    assert out["det_map"].dtype == np.int32 and out["mag"].dtype == np.int32
    assert _det_set(out["det_map"]) == _det_set(ref["det_map"])
    assert int(out["n_dets"]) == int(ref["n_dets"])
    assert int(out["saturation_count"]) == int(ref["saturation_count"])
    assert (int(out["saturation_count"]) > 0) == (stimulus == "x40")
    d = np.abs(out["mag_map"].astype(np.int64) - ref["mag_map"])
    assert d.max() <= LSB, d.max()
    if stimulus != "x40":
        z = iq[..., 0].astype(np.int64) + 1j * iq[..., 1]
        gm, gd = tref.process_frame_fixed(z, p)
        assert np.array_equal(out["mag_map"], gm)
        assert np.array_equal(out["det_map"], gd)
    v = out["valid"]
    assert np.array_equal(v, ref["valid"])
    assert set(zip(out["range_bin"][v], out["doppler_bin"][v])) == \
        set(zip(ref["range_bin"][v], ref["doppler_bin"][v]))


# ---------------------------------------------------------------------------
# The fused route's twins against JAX's fused fixed kernel (interpret mode)
# ---------------------------------------------------------------------------

def _pair(p, frames, pg=0, **kw):
    """Port frontend="plain" (the fused kernels' twins) and JAX
    frontend="pallas" (interpret mode) on each (iq, controls) of frames."""
    jproc = jpl.make_processor(_jparams(p), mode="fixed", frontend="pallas",
                               include_maps=True, peak_group_radius=pg, **kw)
    tproc = tpl.make_processor(p, mode="fixed", frontend="plain",
                               peak_group_radius=pg, device="cpu", **kw)
    for iq, ctl in frames:
        out = {k: v.numpy() for k, v in tproc(iq, **ctl).items()}
        yield out, jax.tree.map(np.asarray, jproc(iq, **ctl))


def _check_exact(out, ref):
    """tests/test_frontend_fixed.py's contract: exact set and count, integer
    dtypes, magnitudes within LSB, exact saturation, the top-K set."""
    assert _det_set(out["det_map"]) == _det_set(ref["det_map"])
    assert int(out["n_dets"]) == int(ref["n_dets"])
    assert out["mag"].dtype == np.int32 and out["mag_map"].dtype == np.int32
    d = np.abs(out["mag_map"].astype(np.int64) - ref["mag_map"])
    assert d.max() <= LSB, d.max()
    assert int(out["saturation_count"]) == int(ref["saturation_count"])
    v = out["valid"]
    assert np.array_equal(v, ref["valid"])
    assert set(zip(out["range_bin"][v], out["doppler_bin"][v])) == \
        set(zip(ref["range_bin"][v], ref["doppler_bin"][v]))


def test_fused_twin_vs_kernel_256x64_controls_and_saturation():
    """At 256x64, block scale on JAX's kernel grid (scale_block 2) with peak
    grouping: the golden-style frame under the runtime controls, and the
    x40 saturating stimulus.  (The per-cell scale: the quick() test.)"""
    pg = 2
    p = fmcw_tpu_torch.RadarParams(
        n_range=256, n_doppler=64,
        cfar=fmcw_tpu_torch.CfarParams(scale_mode="block", scale_block=2))
    frame = tpl.complex_to_iq(tref.two_target_frame(p, seed=3))
    frames = [(frame, {}), (frame, dict(mti_bypass=True)),
              (frame, dict(scale_override=3)), (_hot(p, 5), {}),
              (_hot(p, 5), dict(mti_bypass=True))]
    sats = []
    for out, ref in _pair(p, frames, pg=pg):
        _check_exact(out, ref)
        sats.append(int(out["saturation_count"]))
    assert sats[0] == 0 and min(sats[3:]) > 0


def test_fused_twin_vs_kernel_quick():
    p = fmcw_tpu_torch.quick()
    frame = tpl.complex_to_iq(tref.two_target_frame(p, seed=3))
    for out, ref in _pair(p, [(frame, {}), (frame, dict(mti_bypass=True)),
                              (_hot(p, 6), {})]):
        _check_exact(out, ref)


def test_fused_twin_vs_kernel_numeric_options():
    """3-pulse MTI, passthrough transient and biased rounding at quick(),
    with test_frontend_fixed.py's tolerance for these options (the 3-pulse
    canceller doubles the slow-time gain, so a float32 route's 1-LSB range
    differences may flip marginal cells); the top-K set stays exact."""
    p = fmcw_tpu_torch.quick().replace(notch_mode=3)
    frame = tpl.complex_to_iq(tref.two_target_frame(p, seed=11))
    kw = dict(mti_transient="passthrough", window_rounding="biased")
    [(out, ref)] = _pair(p, [(frame, {})], **kw)
    sym = _det_set(out["det_map"]) ^ _det_set(ref["det_map"])
    assert len(sym) <= max(2, int(ref["n_dets"]) // 100), sorted(sym)
    assert abs(int(out["n_dets"]) - int(ref["n_dets"])) <= 4
    assert int(out["saturation_count"]) == int(ref["saturation_count"])
    v, vr = out["valid"], ref["valid"]
    assert set(zip(out["range_bin"][v], out["doppler_bin"][v])) == \
        set(zip(ref["range_bin"][vr], ref["doppler_bin"][vr]))
    z = frame[..., 0].astype(np.int64) + 1j * frame[..., 1]
    _, gd = tref.process_frame_fixed(z, p, **kw)
    assert np.array_equal(out["det_map"], gd)


@pytest.mark.parametrize("pg", [0, 2])
def test_fixed_routes_agree(pg):
    """staged, plain (the fused twins) and the golden model give the same
    detections, counts and saturation on a noisy batch."""
    p = fmcw_tpu_torch.RadarParams(n_range=256, n_doppler=64)
    batch = np.stack([_noisy(p, s) for s in range(3)] + [_hot(p, 7)])
    outs = [tpl.make_batch_processor(p, mode="fixed", frontend=fe,
                                     peak_group_radius=pg, device="cpu")(batch)
            for fe in ("auto", "plain")]
    for key in ("det_map", "mag_map", "n_dets", "saturation_count",
                "range_bin", "doppler_bin", "mag", "valid"):
        assert torch.equal(outs[0][key], outs[1][key]), key
    for f in range(3):
        z = batch[f, ..., 0].astype(np.int64) + 1j * batch[f, ..., 1]
        _, gd = tref.process_frame_fixed(z, p)
        gd = tfx.peak_group(gd, pg) if pg else gd
        ok, rep = parity.fixed_gate(parity.map_set(outs[0]["det_map"][f]),
                                    parity.map_set(gd))
        assert ok, rep


# ---------------------------------------------------------------------------
# The float32 staged route, and precision flags
# ---------------------------------------------------------------------------

def test_float_staged_vs_jax_xla():
    """frontend="staged" in float32 (JAX's frontend="xla" chain, the CFAR
    step through cfar_detect's twin): magnitudes within 1e-5 of the peak of
    JAX's and the detections through the margin gate
    (tests/test_torch_pipeline.py)."""
    p = fmcw_tpu_torch.RadarParams()
    iq = tpl.complex_to_iq(tref.two_target_frame(p))
    ref = jax.tree.map(np.asarray, jpl.make_processor(
        _jparams(p), frontend="xla", include_debug=True,
        peak_group_radius=2)(iq))
    out = tpl.make_processor(p, frontend="staged", peak_group_radius=2,
                             device="cpu")(iq)
    mag = out["mag_map"].numpy()
    assert np.max(np.abs(mag - ref["mag_map"])) <= 1e-5 * ref["mag_map"].max()
    ok, report = parity.margin_gate(
        parity.map_set(out["det_map"].numpy()), parity.map_set(ref["det_map"]),
        ref["mag_map"], ref["threshold_map"], ref["scale_map"], radius=2,
        targets=tref.golden_targets(p))
    assert ok, report


def test_results_do_not_depend_on_matmul_precision_flags():
    """The staged and plain routes give the same outputs whatever the
    caller's TF32 / float32-matmul-precision settings, and leave those
    settings as they found them."""
    p = fmcw_tpu_torch.RadarParams(n_range=256, n_doppler=64)
    iq = np.stack([_noisy(p, 1), _hot(p, 2)])
    procs = [tpl.make_batch_processor(p, mode=m, frontend=fe, device="cpu")
             for m, fe in (("float32", "staged"), ("float32", "plain"),
                           ("fixed", "staged"), ("fixed", "plain"))]
    base = [proc(iq) for proc in procs]
    prec = torch.get_float32_matmul_precision()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    knobs = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)
    try:
        torch.set_float32_matmul_precision("medium")
        torch.backends.cuda.matmul.allow_tf32 = True
        before = [k.fp32_precision for k in knobs]
        assert before == ["tf32", "bf16"]
        for proc, want in zip(procs, base):
            got = proc(iq)
            for key in want:
                assert torch.equal(got[key], want[key]), key
        assert [k.fp32_precision for k in knobs] == before
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.set_float32_matmul_precision(prec)
        torch.backends.cuda.matmul.allow_tf32 = tf32


def test_fixed_mode_options_and_gates():
    p = fmcw_tpu_torch.quick()
    # fixed_fft="scaled" is ported: it has no fused kernel (ValueError, as
    # JAX's "pallas") and applies to fixed mode only.
    with pytest.raises(ValueError, match="fused"):
        tpl.make_processor(p, mode="fixed", device="cpu", fixed_fft="scaled",
                           frontend="fused")
    with pytest.raises(ValueError, match="mode='fixed'"):
        tpl.make_processor(p, device="cpu", fixed_fft="scaled")
    # The hw-compat streaming CFAR runs on the staged and plain routes (and
    # has its continuous-stream call); it has no fused fixed kernel.
    for fe in ("auto", "staged", "plain"):
        assert hasattr(tpl.make_processor(p, mode="fixed", frontend=fe,
                                          cfar_geometry="hw_stream",
                                          device="cpu"), "stream")
    with pytest.raises(ValueError):
        tpl.make_processor(p, mode="fixed", frontend="fused",
                           cfar_geometry="hw_stream", device="cpu")
    # CA/GO/SO run on fixed "auto" (the staged route, the plain integer
    # cfar_2d) and on the fused fixed route (the fixed kernels' twins on
    # the CPU), both equal to the golden model.
    for variant in ("ca", "go", "so"):
        pv = p.replace(cfar=dataclasses.replace(p.cfar, variant=variant))
        z = tref.two_target_frame(p)
        _, det = tref.process_frame_fixed(z, pv)
        for fe in ("auto", "fused"):
            out = tpl.make_processor(pv, mode="fixed", frontend=fe,
                                     device="cpu")(tpl.complex_to_iq(z))
            assert np.array_equal(out["det_map"].numpy(), det), (variant, fe)
    for kw in (dict(window_rounding="nearest"), dict(mti_transient="hold"),
               dict(frontend="pallas")):
        with pytest.raises(ValueError):
            tpl.make_processor(p, mode="fixed", device="cpu", **kw)
    # Debug taps: the staged route runs the rank-select CFAR; the fused
    # fixed kernels compute none and raise, as JAX's frontend="pallas".
    tpl.make_processor(p, mode="fixed", frontend="staged",
                       include_debug=True, device="cpu")
    with pytest.raises(ValueError, match="debug taps"):
        tpl.make_processor(p, mode="fixed", frontend="fused",
                           include_debug=True, device="cpu")
    assert tpl.resolve_frontend("fixed", "auto") == "staged"
    assert tpl.resolve_frontend("float32", "auto") == "fused"


# The window of tests/test_frontend_fixed.py's 2^24 case: 17x23 cells.
WIDE = dict(ref_range=6, guard_range=2, ref_doppler=9, guard_doppler=2)


@pytest.mark.parametrize("scale_mode,cfar_kw,port,jax_", [
    ("cell", {}, True, True),
    ("block", {}, True, True),
    ("cell", WIDE, True, False),
    ("block", WIDE, True, True),
    ("cell", dict(edge_mode="reflect"), False, False),
    ("cell", dict(variant="ca"), True, True),
], ids=["cell", "block", "wide-cell", "wide-block", "reflect", "ca"])
def test_fused_fixed_gate_vs_jax(scale_mode, cfar_kw, port, jax_):
    """The fused fixed route's gate against JAX's at 1024x128.  One answer
    differs on purpose: JAX's per-cell window limit (its sum below 2^24) is
    for the TPU's float32 sums and the port's kernels sum in int32.  A wide
    per-cell window that the port takes gives the golden model's
    detections exactly on the CPU (at 256x64)."""
    p = fmcw_tpu_torch.RadarParams(cfar=fmcw_tpu_torch.CfarParams(
        scale_mode=scale_mode, **cfar_kw))
    assert FX.fused_fixed_detect_supported(p) is port
    assert jpl.fused_fixed_detect_supported(_jparams(p)) is jax_
    assert not FX.fused_fixed_detect_supported(p, include_debug=True)
    if cfar_kw is WIDE and scale_mode == "cell":
        p = p.replace(n_range=256, n_doppler=64)
        z = tref.two_target_frame(p)
        out = tpl.make_processor(p, mode="fixed", frontend="fused",
                                 device="cpu")(tpl.complex_to_iq(z))
        _, det = tref.process_frame_fixed(z, p)
        assert _det_set(out["det_map"]) == _det_set(det)
        assert int(out["n_dets"]) == int((det > 0).sum()) > 0


def test_fixed_twins_equal_golden_at_doppler_eighth_turn_ties():
    """A chirp-axis round-half tie at an eighth-turn Doppler bin: the fixed
    slow-time twin and the staged fixed route (CPU) equal the golden fixed
    chain bit for bit (magnitudes and detections), where the dense float64
    product alone rounds the tie away on some frame."""
    p = fmcw_tpu_torch.RadarParams(n_range=64, n_doppler=32)
    jp = _jparams(p)
    frames = tref.doppler_eighth_tie_frames(p, 16)
    proc = tpl.make_processor(p, mode="fixed", frontend="staged",
                              device="cpu")
    missed = 0
    for z in frames:
        mag, det = jref.process_frame_fixed(z, jp, mti_bypass=True)
        i_v, q_v, _ = jfx.window_apply(
            z.real.astype(np.int64), z.imag.astype(np.int64),
            jfx.hamming_coeffs(p.n_range, p.coef_width)[None, :],
            p.coef_width, "unbiased")
        re, im = (torch.as_tensor(x.T.copy()) for x in jfx.bfp_fft(
            i_v, q_v, axis=1))
        twin, _ = FX.slowtime_mag_fixed_plain(re[None], im[None], True)
        assert np.array_equal(twin[0].numpy(), mag)
        out = proc(tpl.complex_to_iq(z), mti_bypass=True)
        assert np.array_equal(out["mag_map"].numpy(), mag)
        assert np.array_equal(out["det_map"].numpy(), det)
        # The dense product without the exact eighth-turn bins.
        cr, ci = TF.dft64_matrices(p.n_doppler)
        wi, wq, _ = TW.window_apply_fixed(
            re, im, TW.hamming_q15(p.n_doppler, p.coef_width)[None, :],
            p.coef_width)
        wi, wq = wi.double(), wq.double()
        yr, yi = TF.bfp_quantize(wi @ cr - wq @ ci, wi @ ci + wq @ cr)
        missed += not np.array_equal(
            TM.magnitude_fixed(yr.long(), yi.long()).numpy(), mag)
    assert missed > 0
