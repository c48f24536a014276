"""The port's Pd / Pfa harness (fmcw_tpu_torch/utils/eval.py) against JAX's
(fmcw_tpu/utils/eval.py), on the CPU.

* The stimuli: ``synth_trial_frame`` and ``synth_trial_cube`` give JAX's
  frames and cubes bit for bit from the same seed (numpy, JAX's draw
  order).
* ``pd_pfa`` at 256x64 over all four variants against JAX's: the port's
  plain path and JAX's XLA chain agree on the magnitudes to ~1e-5 of the
  peak, not bit for bit, so a trial near the threshold may go either way:
  Pd within one trial per SNR, Pfa within 20% or 2 detections.
* The envelope of tests/test_detection_eval.py (Pd a rising curve, low
  below threshold and high above it, Pfa <= 1e-3) for every variant; the
  3D harness and the hw-compat arm; ``format_table`` as JAX's.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import fmcw_tpu
import fmcw_tpu_torch
from fmcw_tpu.utils import eval as jev
from fmcw_tpu_torch.golden.fixed_point import hw_stream_lag
from fmcw_tpu_torch.utils import eval as tev

# Share the CPU with the other test workers (the suite runs 6 at once).
torch.set_num_threads(2)

VARIANTS = ("os", "ca", "go", "so")
P256 = fmcw_tpu_torch.RadarParams(
    n_range=256, n_doppler=64, cfar=fmcw_tpu_torch.CfarParams(scale_block=2))


def _jparams(p):
    return fmcw_tpu.RadarParams(
        n_range=p.n_range, n_doppler=p.n_doppler,
        cfar=fmcw_tpu.CfarParams(**dataclasses.asdict(p.cfar)))


def test_stimuli_bit_identical_to_jax():
    p, jp = P256, _jparams(P256)
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    for snr, rbin, dbin in ((None, 0, 0), (-20.0, 100.3, 20.7),
                            (3.0, 5.5, 60.1)):
        x = tev.synth_trial_frame(p, a, snr, rbin, dbin)
        y = jev.synth_trial_frame(jp, b, snr, rbin, dbin)
        assert x.dtype == y.dtype == np.int16 and np.array_equal(x, y)
    q, jq = fmcw_tpu_torch.quick(), fmcw_tpu.quick()
    for snr in (None, -25.0):
        x = tev.synth_trial_cube(q, a, snr, 2.4, 40.2, 10.6, 8, 8)
        y = jev.synth_trial_cube(jq, b, snr, 2.4, 40.2, 10.6, 8, 8)
        assert x.shape == (8, q.n_doppler, q.n_range, 2)
        assert np.array_equal(x, y)
    assert a.uniform() == b.uniform()       # the same draws were taken


def test_pd_pfa_vs_jax():
    """All four variants, 3 SNRs, 8 trials and 8 noise frames each."""
    kw = dict(snr_dbs=(-35, -24, -18), trials=8, noise_trials=8, seed=1)
    got = tev.pd_pfa(P256, device="cpu", **kw)
    want = jev.pd_pfa(_jparams(P256), **kw)
    assert list(got) == list(want) == list(VARIANTS)
    cells = P256.n_range * P256.n_doppler * 8
    for v in VARIANTS:
        for snr in kw["snr_dbs"]:
            assert abs(got[v]["pd"][snr] - want[v]["pd"][snr]) <= 1 / 8, v
        n_got, n_want = got[v]["pfa"] * cells, want[v]["pfa"] * cells
        assert abs(n_got - n_want) <= max(2, 0.2 * n_want), v
    assert tev.format_table(got).splitlines()[0] == \
        jev.format_table(want).splitlines()[0]
    if got == want:
        assert tev.format_table(got) == jev.format_table(want)


def test_pd_curve_and_pfa_envelope():
    """tests/test_detection_eval.py's envelope, for every variant."""
    res = tev.pd_pfa(P256, snr_dbs=(-35, -24, -18), trials=16,
                     noise_trials=8, seed=1, device="cpu")
    assert list(res) == list(VARIANTS)
    for v, r in res.items():
        pd = r["pd"]
        assert pd[-35] <= 0.25, (v, pd)          # below threshold
        assert pd[-18] >= 0.9, (v, pd)           # comfortably above
        assert pd[-35] <= pd[-24] <= pd[-18] + 1e-9, (v, pd)
        assert r["pfa"] <= 1e-3, (v, r["pfa"])   # noise-only false alarms
    table = tev.format_table(res).splitlines()
    assert len(table) == 2 + len(VARIANTS) and table[2].startswith("os")


def test_pd_pfa_3d_and_hw_stream_arm():
    """The 3D harness (the array model at ref_angle 1, quick(), 8 x 8): a
    rising Pd curve that reaches 1 and a low Pfa.  The hw-compat arm
    (labels 3 cells behind the truth, the one-shot framing's tail kept
    clear, as tools/detection_eval.py runs it) against JAX's at quick():
    Pd within one trial, Pfa within 2 detections."""
    q = fmcw_tpu_torch.quick()
    res = tev.pd_pfa_3d(q, snr_dbs=(-40, -20), trials=6, noise_trials=4,
                        seed=2, device="cpu")
    r = res["os"]
    assert r["pd"][-40] <= 0.5 and r["pd"][-20] == 1.0
    assert r["pfa"] <= 5e-3
    ca = q.replace(cfar=dataclasses.replace(q.cfar, variant="ca"))
    assert list(tev.pd_pfa_3d(ca, snr_dbs=(-20,), trials=2, noise_trials=1,
                              device="cpu")) == ["ca"]
    margin = math.ceil(hw_stream_lag(q.cfar, q.n_doppler) / q.n_doppler) + 1
    kw = dict(snr_dbs=(-30, -20, -15), variants=("os",), trials=8,
              noise_trials=4, seed=3, truth_doppler_offset=-3,
              range_hi_margin=margin,
              processor_kw=dict(cfar_geometry="hw_stream"))
    got = tev.pd_pfa(q, device="cpu", **kw)["os"]
    want = jev.pd_pfa(fmcw_tpu.quick(), **kw)["os"]
    assert got["pd"][-15] == 1.0
    for snr in kw["snr_dbs"]:
        assert abs(got["pd"][snr] - want["pd"][snr]) <= 1 / 8
    cells = q.n_range * q.n_doppler * 4
    assert abs(got["pfa"] - want["pfa"]) * cells <= 2
    with pytest.raises(ValueError):                 # hw_stream is OS only
        tev.pd_pfa(q, variants=("ca",), trials=1, noise_trials=1,
                   device="cpu", processor_kw=dict(cfar_geometry="hw_stream"))
