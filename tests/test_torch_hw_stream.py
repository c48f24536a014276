"""The hw-compat streaming CFAR (cfar_geometry="hw_stream") of the port
against the JAX package, on the CPU.

* The port's golden ``os_cfar_2d_hw_stream`` (numpy copy) equals
  ``fmcw_tpu.golden.fixed_point``'s and the cycle-level oracle
  ``vhdl_cfar_stream`` of tests/test_hw_compat.py on random geometries,
  one-shot and over 3-frame streams, with its debug taps.
* The twin ``ops/cfar.cfar_2d_hw_stream`` (decisions by counting on the
  stream's padded buffer, the kernel's formulation) against JAX's
  ``method="xla"`` in every framing, override 0 and 3, int32 and float32:
  det, scale, new_hist and the threshold tap bit-equal; against
  ``method="pallas"`` (interpret mode) on the QUICK geometry; narrow
  integer maps.
* The processors: ``make_processor(..., cfar_geometry="hw_stream")`` and
  its ``stream`` against JAX's on ``quick()``.  JAX's fixed XLA chain
  transforms in FP32 and lands up to a few LSB off the golden model, where
  the port's fixed chain equals it bit for bit (ROADMAP.md), so the
  processors are held to each other on detection positions, counts and
  the carry's positions, and the port's values to the golden chain; float
  mode by ``parity.margin_gate`` (1e-5 of the peak).
"""

import dataclasses

import numpy as np
import pytest
import torch

import fmcw_tpu
import fmcw_tpu_torch
from fmcw_tpu.golden import fixed_point as jfx
from fmcw_tpu.models import pipeline as jpl
from fmcw_tpu.ops import cfar as JC
from fmcw_tpu_torch import parity
from fmcw_tpu_torch.golden import fixed_point as tfx, reference as tref
from fmcw_tpu_torch.models import pipeline as tpl
from fmcw_tpu_torch.ops import cfar as TC, cfar_detect as CD
from test_hw_compat import GEOMETRIES, _stim, vhdl_cfar_stream

# Share the CPU with the other test workers (the suite runs 6 at once).
torch.set_num_threads(2)

Q, JQ = fmcw_tpu_torch.quick(), fmcw_tpu.quick()
FIXED_KW = dict(window_rounding="biased", mti_transient="passthrough")


def _tcfar(cfar):
    return fmcw_tpu_torch.CfarParams(**dataclasses.asdict(cfar))


def _framings(hist):
    return (dict(), dict(streaming=True, first=True),
            dict(hist=hist, streaming=True))


def _golden_labels(out):
    return sorted(zip(*(a.tolist() for a in out)))


def _random_geometries(n, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        cfar = fmcw_tpu.CfarParams(
            ref_range=int(rng.integers(1, 4)),
            ref_doppler=int(rng.integers(1, 4)),
            guard_range=int(rng.integers(0, 3)),
            guard_doppler=int(rng.integers(0, 3)))
        D = int(rng.choice([8, 16]))
        yield cfar, int(rng.integers(3, 7)) * 4, D, int(rng.integers(1 << 30))


@pytest.mark.parametrize("gi", range(4))
def test_golden_equals_jax_golden_and_vhdl_oracle(gi):
    cfar, R, D, seed = list(_random_geometries(4, 7))[gi]
    f = _stim(R, D, 3, seed)
    tc = _tcfar(cfar)
    assert tfx.hw_stream_lag(tc, D) == jfx.hw_stream_lag(cfar, D)
    for frames in (f[0], f):
        for so in (0, 3):
            a = tfx.os_cfar_2d_hw_stream(frames, tc, so)
            b = jfx.os_cfar_2d_hw_stream(frames, cfar, so)
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
            da = tfx.os_cfar_2d_hw_stream(frames, tc, so, return_debug=True)
            db = jfx.os_cfar_2d_hw_stream(frames, cfar, so, return_debug=True)
            assert da.keys() == db.keys()
            assert all(np.array_equal(da[k], db[k]) for k in da)
    outputs, dets = vhdl_cfar_stream(f, cfar, scale_override=3)
    dbg = tfx.os_cfar_2d_hw_stream(f, tc, 3, return_debug=True)
    assert np.array_equal(np.array([o for o, _ in outputs]), dbg["out"])
    lr, ld, lm = tfx.os_cfar_2d_hw_stream(f, tc, 3)
    assert [(int(a), int(b), int(c)) for a, b, c in zip(lr, ld, lm)] == dets


@pytest.mark.parametrize("gi", range(len(GEOMETRIES)))
@pytest.mark.parametrize("integer", [True, False])
def test_twin_equals_jax_xla(gi, integer):
    """Every framing, override 0 and 3: det, scale and new_hist bit-equal
    to JAX's XLA method, and the threshold tap (the order statistic over
    the flat views) to its taps.  The full window (whose JAX compiles take
    ~3 s each) skips the first-frame framing, which differs from the
    carried one only in the zero history and the startup skip that the
    two smaller windows cover."""
    cfar, R, D = GEOMETRIES[gi]
    tc = _tcfar(cfar)
    f = _stim(R, D, 2, seed=80 + gi)
    lag = jfx.hw_stream_lag(cfar, D)
    dt = np.int32 if integer else np.float32
    hist = f[0].reshape(-1)[-2 * lag:].astype(dt)
    framings = _framings(hist)
    if gi == 2:
        framings = framings[::2]
    for so in (0, 3):
        for kw in framings:
            a = JC.cfar_2d_hw_stream(f[1].astype(dt), so, cfar=cfar,
                                     integer=integer, method="xla", **kw)
            tkw = dict(kw, hist=torch.as_tensor(hist)) if "hist" in kw else kw
            b = TC.cfar_2d_hw_stream(torch.as_tensor(f[1].astype(dt)), so,
                                     cfar=tc, integer=integer,
                                     need_debug=True, **tkw)
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert np.array_equal(np.asarray(x), y.numpy())
            assert b[0].dtype == b[1].dtype == torch.as_tensor(dt(0)).dtype


@pytest.mark.parametrize("integer", [True, False])
def test_twin_equals_jax_pallas_interpret(integer):
    """The TPU kernel's own formulation (row-carry-baked padded buffer,
    swapped CfarParams, _kernel_detect in interpret mode) on the QUICK
    geometry: det, scale and new_hist bit-equal (int32: the carried
    framing with the override; float32: one-shot without it); also through
    the kernel wrapper's CPU branch."""
    cfar, R, D = GEOMETRIES[1]
    tc = _tcfar(cfar)
    f = _stim(R, D, 2, seed=81)
    lag = jfx.hw_stream_lag(cfar, D)
    dt = np.int32 if integer else np.float32
    hist = f[0].reshape(-1)[-2 * lag:].astype(dt)
    so, kw = (3, dict(hist=hist, streaming=True)) if integer else (0, {})
    a = JC.cfar_2d_hw_stream(f[1].astype(dt), so, cfar=cfar, integer=integer,
                             need_debug=False, method="pallas", **kw)
    tkw = dict(kw, hist=torch.as_tensor(hist)) if "hist" in kw else kw
    for decide in (None, CD.cfar_detect_hw_stream):
        b = TC.cfar_2d_hw_stream(torch.as_tensor(f[1].astype(dt)), so,
                                 cfar=tc, integer=integer, decide=decide,
                                 **tkw)
        assert b[1] is None
        for i in (0, 2, 3)[:len(a) - 1]:
            assert np.array_equal(np.asarray(a[i]), b[i].numpy())
    assert CD.cfar_detect_hw_stream.launches == 0


def test_narrow_int_upcast():
    """int16 maps near full scale decide as their int32 view (sums and the
    ceil-division probe in int32); det and new_hist return int16, as JAX's
    XLA method."""
    cfar, R, D = GEOMETRIES[1]
    tc = _tcfar(cfar)
    rng = np.random.default_rng(5)
    f = rng.integers(20000, 32700, size=(2, R, D)).astype(np.int64)
    f[1, R // 2, D // 2] = 32767
    lag = jfx.hw_stream_lag(cfar, D)
    hist16 = f[0].reshape(-1)[-2 * lag:].astype(np.int16)
    for kw in _framings(hist16):
        a = JC.cfar_2d_hw_stream(f[1].astype(np.int16), 0, cfar=cfar,
                                 integer=True, need_debug=False,
                                 method="xla", **kw)
        tkw = dict(kw, hist=torch.as_tensor(hist16)) if "hist" in kw else kw
        b = TC.cfar_2d_hw_stream(torch.as_tensor(f[1].astype(np.int16)), 0,
                                 cfar=tc, integer=True, **tkw)
        c = TC.cfar_2d_hw_stream(torch.as_tensor(f[1].astype(np.int32)), 0,
                                 cfar=tc, integer=True, **tkw)
        assert b[0].dtype == torch.int16
        assert np.array_equal(np.asarray(a[0]), b[0].numpy())
        assert np.array_equal(np.asarray(a[2]), b[2].numpy())
        assert torch.equal(b[0].to(torch.int32), c[0])
        if len(a) == 4:
            assert b[3].dtype == torch.int16
            assert np.array_equal(np.asarray(a[3]), b[3].numpy())


def test_zero_halo_and_batch():
    """A zero halo (JAX's Pallas route refuses it; the port's entry and
    twin take it) equals the golden model; a batch of maps equals each map
    alone."""
    cfar = fmcw_tpu_torch.CfarParams(ref_range=0, ref_doppler=2,
                                     guard_range=0, guard_doppler=1)
    f = _stim(16, 8, 3, seed=4)
    det, _, _ = TC.cfar_2d_hw_stream(torch.as_tensor(f[0].astype(np.int32)),
                                     cfar=cfar)
    m = det.numpy()
    r, d = np.nonzero(m)
    assert sorted(zip(r.tolist(), d.tolist(), m[r, d].tolist())) == \
        _golden_labels(tfx.os_cfar_2d_hw_stream(f[0], cfar))
    maps = torch.as_tensor(f.astype(np.float32))
    hist = torch.as_tensor(np.random.default_rng(1).integers(
        0, 400, (3, 2 * tfx.hw_stream_lag(Q.cfar, 8))).astype(np.float32))
    both = TC.cfar_2d_hw_stream(maps, 2, cfar=Q.cfar, integer=False,
                                hist=hist, streaming=True, need_debug=True)
    for i in range(3):
        one = TC.cfar_2d_hw_stream(maps[i], 2, cfar=Q.cfar, integer=False,
                                   hist=hist[i], streaming=True,
                                   need_debug=True)
        assert all(torch.equal(x[i], y) for x, y in zip(both, one))


def _det_set(out):
    v = out["valid"].numpy() if isinstance(out["valid"], torch.Tensor) \
        else np.asarray(out["valid"])
    return sorted(zip(*(np.asarray(out[k])[v].tolist()
                        for k in ("range_bin", "doppler_bin"))))


@pytest.fixture(scope="module")
def jax_fixed():
    return jpl.make_processor(JQ, mode="fixed", frontend="xla",
                              cfar_geometry="hw_stream", **FIXED_KW)


@pytest.mark.parametrize("frontend", ["auto", "plain"])
def test_fixed_processor_vs_jax_and_golden(frontend, jax_fixed):
    """Fixed mode: the port's top-K arrays, n_dets and det_map equal the
    golden chain + golden hw-stream CFAR bit for bit; JAX's processor finds
    the same cells (its FP32 chain's values are within a few LSB)."""
    proc = tpl.make_processor(Q, mode="fixed", frontend=frontend,
                              cfar_geometry="hw_stream", device="cpu",
                              **FIXED_KW)
    for seed in (5, 11):
        frame = tref.two_target_frame(Q, seed=seed)
        iq = tpl.complex_to_iq(frame)
        out, jout = proc(iq), jax_fixed(iq)
        mag, _ = tref.process_frame_fixed(frame, Q, **FIXED_KW)
        assert np.array_equal(out["mag_map"].numpy(), mag)
        want = _golden_labels(tfx.os_cfar_2d_hw_stream(mag, Q.cfar))
        m = out["det_map"].numpy()
        r, d = np.nonzero(m)
        assert sorted(zip(r.tolist(), d.tolist(), m[r, d].tolist())) == want
        v = out["valid"].numpy()
        got = sorted(zip(*(out[k].numpy()[v].tolist()
                           for k in ("range_bin", "doppler_bin", "mag"))))
        assert len(want) <= Q.tracker.max_dets and got == want
        assert int(out["n_dets"]) == len(want) == int(jout["n_dets"])
        for k in ("range_bin", "doppler_bin", "valid"):
            assert np.array_equal(out[k].numpy(), np.asarray(jout[k])), k
        assert np.array_equal(m != 0, np.asarray(jout["det_map"]) != 0)
        assert np.abs(out["mag"].numpy()
                      - np.asarray(jout["mag"])).max() <= 8


@pytest.mark.parametrize("frontend", ["fused", "staged"])
def test_float_processor_vs_jax(frontend):
    """Float mode against JAX's XLA chain: the margin gate on JAX's
    threshold and scale taps; the decisions on the port's own maps equal
    the twin's."""
    jp = jpl.make_processor(JQ, frontend="xla", cfar_geometry="hw_stream",
                            include_debug=True)
    proc = tpl.make_processor(Q, frontend=frontend, cfar_geometry="hw_stream",
                              include_debug=True, device="cpu")
    for seed in (5, 21):
        iq = tpl.complex_to_iq(tref.two_target_frame(Q, seed=seed))
        out, jout = proc(iq), jp(iq)
        ok, report = parity.margin_gate(
            parity.detection_set(out), parity.detection_set(jout),
            np.asarray(jout["mag_map"]), np.asarray(jout["threshold_map"]),
            np.asarray(jout["scale_map"]), radius=0,
            capacity=Q.tracker.max_dets)
        assert ok, report
        det, thr, scale = TC.cfar_2d_hw_stream(out["mag_map"], cfar=Q.cfar,
                                               integer=False, need_debug=True)
        assert torch.equal(det, out["det_map"])
        assert torch.equal(thr, out["threshold_map"])
        assert torch.equal(scale.float(), out["scale_map"])


def test_stream_vs_jax_and_golden(jax_fixed):
    """process.stream over 3 CPIs: each call's detection positions, counts
    and carry length equal JAX's stream; the port's detections over the
    run equal the golden multi-frame stream model on the golden chain's
    maps, minus the last frame's tail (emitted only when a 4th frame
    arrives); the carry is the frame's last 2 lag cells."""
    proc = tpl.make_processor(Q, mode="fixed", cfar_geometry="hw_stream",
                              include_maps=False, device="cpu", **FIXED_KW)
    frames = [tref.two_target_frame(Q, seed=s) for s in (11, 12, 13)]
    mags = np.stack([tref.process_frame_fixed(f, Q, **FIXED_KW)[0]
                     for f in frames])
    lag = tfx.hw_stream_lag(Q.cfar, Q.n_doppler)
    got, hist, jhist = [], None, None
    for i, f in enumerate(frames):
        iq = tpl.complex_to_iq(f)
        out, hist = proc.stream(iq, hist=hist)
        jout, jhist = jax_fixed.stream(iq, hist=jhist)
        assert _det_set(out) == _det_set(jout)
        assert int(out["n_dets"]) == int(jout["n_dets"])
        assert hist.dtype == torch.int32 and hist.shape == jhist.shape
        assert np.array_equal(hist.numpy(), mags[i].reshape(-1)[-2 * lag:])
        v = out["valid"].numpy()
        got += list(zip(*(out[k].numpy()[v].tolist()
                          for k in ("range_bin", "doppler_bin", "mag"))))
    S = Q.n_range * Q.n_doppler
    dbg = tfx.os_cfar_2d_hw_stream(mags, Q.cfar, return_debug=True)
    keep = dbg["cells"][dbg["det"]] < 3 * S - lag
    want = [(int(a), int(b), int(c)) for a, b, c, k in zip(
        *tfx.os_cfar_2d_hw_stream(mags, Q.cfar), keep) if k]
    assert sorted(got) == sorted(want)


def test_groups_in_decision_order():
    """Peak grouping runs on the decision-order det map, then the roll into
    label space (JAX's test_pipeline_hw_compat_groups_in_decision_order
    stimulus), one-shot and streaming; equal to JAX's processor."""
    proc = tpl.make_processor(Q, mode="fixed", cfar_geometry="hw_stream",
                              peak_group_radius=1, device="cpu")
    jp = jpl.make_processor(JQ, mode="fixed", cfar_geometry="hw_stream",
                            peak_group_radius=1, include_maps=True)
    iq = tpl.complex_to_iq(tref.two_target_frame(Q, seed=21))
    for streaming in (False, True):
        if streaming:
            (out, _), (jout, _) = proc.stream(iq), jp.stream(iq)
        else:
            out, jout = proc(iq), jp(iq)
        det, _, _, *_ = TC.cfar_2d_hw_stream(
            out["mag_map"], cfar=Q.cfar, streaming=streaming,
            label_roll=False)
        det = TC.peak_group(det, 1)
        shift = TC.hw_stream_label_shift(Q.cfar, Q.n_doppler, streaming)
        assert shift == JC.hw_stream_label_shift(JQ.cfar, JQ.n_doppler,
                                                 streaming)
        want = torch.roll(det.reshape(-1), -shift).reshape(det.shape)
        assert torch.equal(out["det_map"], want)
        assert np.array_equal(out["det_map"].numpy() != 0,
                              np.asarray(jout["det_map"]) != 0)


def test_rejects_bad_config():
    """The ValueError cases of JAX's test_pipeline_hw_compat_rejects_bad_
    config: block scale, CA/GO/SO, fixed mode on the fused route."""
    blk = Q.replace(cfar=dataclasses.replace(Q.cfar, scale_mode="block"))
    ca = Q.replace(cfar=dataclasses.replace(Q.cfar, variant="ca"))
    for p, kw in ((blk, {}), (ca, {}), (Q, dict(mode="fixed",
                                                 frontend="fused"))):
        with pytest.raises(ValueError):
            tpl.make_processor(p, cfar_geometry="hw_stream", device="cpu",
                               **kw)
        with pytest.raises(ValueError):
            jpl.make_processor(JQ if p is Q else jpl_params(p),
                               cfar_geometry="hw_stream",
                               **({"mode": "fixed", "frontend": "pallas"}
                                  if kw else {}))
    with pytest.raises(ValueError):
        tpl.make_processor(Q, cfar_geometry="named_axes", device="cpu")
    assert not hasattr(tpl.make_processor(Q, device="cpu"), "stream")
    proc = tpl.make_processor(Q, cfar_geometry="hw_stream", device="cpu")
    iq = tpl.complex_to_iq(tref.two_target_frame(Q))
    with pytest.raises(ValueError):
        proc.stream(iq, hist=np.zeros(7, np.float32))
    with pytest.raises(ValueError):
        TC.cfar_2d_hw_stream(torch.zeros((8, 8)), cfar=Q.cfar, integer=True)


def jpl_params(p):
    return JQ.replace(cfar=fmcw_tpu.CfarParams(**dataclasses.asdict(p.cfar)))
