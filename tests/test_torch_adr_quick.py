"""The quick-validation stimulus (``golden/adr_quick.py``) in the port,
held against the JAX package's generator, and the faithful quick run.

* The IEEE 1076.2 UNIFORM generator, the VHDL ``integer()`` rounding, the
  range / velocity / RCS mappings and the constants equal JAX's;
  ``quick_frames()`` (the 5 CPIs and their truths) and
  ``golden_frame_exact(0 / 1)`` equal JAX's bit for bit (tolerance 0).
* The faithful quick run (JAX's ``tests/test_reference_artifacts.py``
  fixture): the 5 quick CPIs through ``make_processor(quick(),
  mode="fixed", cfar_geometry="hw_stream", window_rounding="biased",
  mti_transient="passthrough")``, frame after frame through ``.stream``.
  Its magnitudes equal the port's and JAX's golden chains, and its
  detections over the run equal the port's and JAX's golden
  ``os_cfar_2d_hw_stream`` over the 5-frame stream (less the last frame's
  tail, emitted only when a 6th frame arrives), exactly.
"""

import numpy as np
import pytest
import torch

import fmcw_tpu
import fmcw_tpu_torch
from fmcw_tpu.golden import adr_quick as jaq
from fmcw_tpu.golden import fixed_point as jfx, reference as jref
from fmcw_tpu_torch.golden import adr_quick as taq
from fmcw_tpu_torch.golden import fixed_point as tfx, reference as tref
from fmcw_tpu_torch.models import pipeline as tpl

# Share the CPU with the other test workers (the suite runs 6 at once).
torch.set_num_threads(2)

FAITHFUL = dict(window_rounding="biased", mti_transient="passthrough")


def test_constants_and_params_equal_jax():
    for name in ("MAX_RANGE_M", "WAVELENGTH", "PRF_HZ", "NOISE_SIGMA",
                 "NUM_SCANS", "NOTCH_SCAN"):
        assert getattr(taq, name) == getattr(jaq, name), name
    assert taq.quick_params() == fmcw_tpu_torch.quick()
    tp, jp = taq.quick_params(), jaq.quick_params()
    assert (tp.n_range, tp.n_doppler) == (jp.n_range, jp.n_doppler)


@pytest.mark.parametrize("seeds", [(42, 42), (1, 1), (2147483562, 7),
                                   (53668, 52774)])
def test_uniform_generator_equals_jax(seeds):
    s1, s2 = seeds
    for _ in range(50):
        a = taq.ieee_uniform(s1, s2)
        b = jaq.ieee_uniform(s1, s2)
        assert a == b
        s1, s2 = a[0], a[1]
    a, b = taq.uniform_block(*seeds, 4096), jaq.uniform_block(*seeds, 4096)
    assert a[:2] == b[:2] and np.array_equal(a[2], b[2])
    assert 0.0 < a[2].min() and a[2].max() < 1.0


def test_mappings_equal_jax():
    """VHDL integer() (ties away from zero) and the range, velocity and
    RCS mappings, on a grid that includes the ties and the wraps."""
    x = np.concatenate([np.arange(-40, 41) / 4.0,
                        np.random.default_rng(0).normal(0, 1e4, 500)])
    assert np.array_equal(taq._vhdl_int(x), jaq._vhdl_int(x))
    assert taq._vhdl_int(np.array([2.5, -2.5, 0.5])).tolist() == [3, -3, 1]
    for r in np.linspace(0.0, 130000.0, 97):
        assert taq._range_to_bin(r, 128) == jaq._range_to_bin(r, 128)
        assert taq._rcs_to_amp(12.0, r) == jaq._rcs_to_amp(12.0, r)
    for v in np.linspace(-900.0, 900.0, 181):
        assert taq._vel_to_doppler(v, 32) == jaq._vel_to_doppler(v, 32)


def test_quick_frames_equal_jax():
    frames, truths = taq.quick_frames()
    jframes, jtruths = jaq.quick_frames()
    assert frames.shape == (taq.NUM_SCANS, 32, 128)
    assert np.array_equal(frames, jframes)
    assert truths == jtruths
    # JAX's pinned truth bins (tests/test_reference_artifacts.py).
    assert [t[:2] for t in truths[0]] == [(85, 26), (87, 26), (75, 2)]
    assert (np.abs(frames.real) <= 32000).all()


@pytest.mark.parametrize("cpi", [0, 1])
def test_golden_frame_exact_equals_jax(cpi):
    z = taq.golden_frame_exact(cpi)
    assert z.shape == (128, 1024)
    assert np.array_equal(z, jaq.golden_frame_exact(cpi))


def test_faithful_quick_run_equals_golden_stream():
    frames, _ = taq.quick_frames()
    p, jp = fmcw_tpu_torch.quick(), fmcw_tpu.quick()
    mags = np.stack([tref.process_frame_fixed(f, p, **FAITHFUL)[0]
                     for f in frames])
    jmags = np.stack([jref.process_frame_fixed(f, jp, **FAITHFUL)[0]
                      for f in frames])
    assert np.array_equal(mags, jmags)
    proc = tpl.make_processor(p, mode="fixed", cfar_geometry="hw_stream",
                              device="cpu", **FAITHFUL)
    lag = tfx.hw_stream_lag(p.cfar, p.n_doppler)
    got, hist = [], None
    for k, f in enumerate(frames):
        out, hist = proc.stream(tpl.complex_to_iq(f), hist=hist)
        assert np.array_equal(out["mag_map"].numpy(), mags[k])
        m = out["det_map"].numpy()
        r, d = np.nonzero(m)
        assert int(out["n_dets"]) == len(r)
        got += list(zip(r.tolist(), d.tolist(), m[r, d].tolist()))
    S = p.n_range * p.n_doppler
    dbg = tfx.os_cfar_2d_hw_stream(mags, p.cfar, return_debug=True)
    keep = dbg["cells"][dbg["det"]] < len(frames) * S - lag
    want = [(int(a), int(b), int(c)) for a, b, c, k in zip(
        *tfx.os_cfar_2d_hw_stream(mags, p.cfar), keep) if k]
    jwant = [(int(a), int(b), int(c)) for a, b, c, k in zip(
        *jfx.os_cfar_2d_hw_stream(jmags, jp.cfar), keep) if k]
    assert len(want) == 29          # pinned, as the golden model gives it
    assert sorted(got) == sorted(want) == sorted(jwant)
