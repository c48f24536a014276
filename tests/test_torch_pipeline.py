"""The port's slice as a whole against the JAX package, on the CPU.

Two float32 implementations of the chain cannot promise the same detection
set: the port's plain path and JAX's XLA chain (HIGHEST) or fused kernel
(bf16x3) agree on the magnitude map to ~1e-5 of its peak, and a cell whose
CFAR decision or grouping tie lies inside that difference may flip.  The
margin gate (fmcw_tpu_torch/parity.py) accepts exactly those flips, with
M, T, S = JAX's XLA-chain magnitude, threshold and scale maps and
tol = 1e-5 * max(M); at most 20% of the set may differ and both golden
targets must be found.

The tracker carries no float: port and JAX are bit-equal over 6 scans.
"""

import dataclasses

import numpy as np
import pytest
import jax
import torch

import fmcw_tpu
import fmcw_tpu_torch
from fmcw_tpu.golden import reference as jref
from fmcw_tpu.models import pipeline as jpl, tracker as jtrk
from fmcw_tpu_torch import parity
from fmcw_tpu_torch.golden import reference as tref
from fmcw_tpu_torch.models import pipeline as tpl, tracker as ttrk

# Share the CPU with the other test workers (the suite runs 6 at once).
torch.set_num_threads(2)

TOL = 1e-5


def _jparams(p):
    return fmcw_tpu.RadarParams(
        n_range=p.n_range, n_doppler=p.n_doppler,
        cfar=fmcw_tpu.CfarParams(**dataclasses.asdict(p.cfar)),
        tracker=fmcw_tpu.TrackerParams(**dataclasses.asdict(p.tracker)))


def _gate(p, radius, bypass, jax_frontend):
    """Port plain path vs JAX (``jax_frontend``), gated on the XLA chain's
    maps; checks both the full det-map sets and the top-K lists."""
    iq = tpl.complex_to_iq(tref.two_target_frame(p))
    jp = _jparams(p)
    ref = jpl.make_processor(jp, frontend="xla", include_debug=True,
                             peak_group_radius=radius)(iq, mti_bypass=bypass)
    ref = jax.tree.map(np.asarray, ref)
    if jax_frontend == "xla":
        other = ref
    else:
        other = jax.tree.map(np.asarray, jpl.make_processor(
            jp, frontend=jax_frontend, peak_group_radius=radius)(
                iq, mti_bypass=bypass))
    out = tpl.make_processor(p, peak_group_radius=radius, device="cpu")(
        iq, mti_bypass=bypass)
    maps = (ref["mag_map"], ref["threshold_map"], ref["scale_map"])
    targets = tref.golden_targets(p)
    ok, report = parity.margin_gate(
        parity.map_set(out["det_map"].numpy()), parity.map_set(other["det_map"]),
        *maps, radius=radius, targets=targets)
    assert ok, report
    ok, report = parity.margin_gate(
        parity.detection_set(out), parity.detection_set(other), *maps,
        radius=radius, targets=targets,
        capacity=p.tracker.max_dets)
    assert ok, report
    # The magnitude maps themselves: within tol of the XLA chain's.
    mag = out["mag_map"].numpy()
    assert np.max(np.abs(mag - ref["mag_map"])) <= TOL * ref["mag_map"].max()
    assert int(out["nonfinite_count"]) == 0


@pytest.mark.parametrize("bypass", [False, True])
def test_entry_config_margin_gate_vs_xla(bypass):
    """The entry: RadarParams(), per-cell scale, peak_group_radius=2,
    1024x128."""
    _gate(fmcw_tpu_torch.RadarParams(), 2, bypass, "xla")


def test_fast_config_margin_gate_vs_xla():
    _gate(fmcw_tpu_torch.fast(), 2, False, "xla")


@pytest.mark.parametrize("p", [
    fmcw_tpu_torch.quick(),
    fmcw_tpu_torch.RadarParams(n_range=256, n_doppler=64)],
    ids=["quick", "256x64"])
def test_margin_gate_vs_fused_kernel_interpret(p):
    """Against the fused Pallas kernel (interpret mode), the path the JAX
    entry takes."""
    _gate(p, 2, False, "pallas")


def test_batch_processor_equals_single_calls():
    p = fmcw_tpu_torch.RadarParams(n_range=256, n_doppler=64)
    rng = np.random.default_rng(4)
    frames = np.stack([tpl.complex_to_iq(tref.two_target_frame(p, seed=s))
                       for s in range(4)])
    frames = frames + rng.integers(-8, 8, frames.shape).astype(np.int16)
    kw = dict(peak_group_radius=2, device="cpu")
    batched = tpl.make_batch_processor(p, **kw)(frames, scale_override=4)
    single = tpl.make_processor(p, **kw)
    for b in range(4):
        one = single(frames[b], scale_override=4)
        assert one.keys() == batched.keys()
        for key, v in one.items():
            assert np.array_equal(v.numpy(), batched[key][b].numpy()), key


def test_processor_rejects_wrong_shape_and_unported_modes():
    p = fmcw_tpu_torch.quick()
    proc = tpl.make_processor(p, device="cpu")
    with pytest.raises(ValueError):
        proc(np.zeros((2, p.n_doppler, p.n_range, 2), np.int16))
    # fixed_fft="scaled" is ported; an unknown transform and the fused
    # route with it raise ValueError, as JAX's.
    with pytest.raises(ValueError, match="bfp"):
        tpl.make_processor(p, mode="fixed", fixed_fft="xfft", device="cpu")
    with pytest.raises(ValueError, match="fused"):
        tpl.make_processor(p, mode="fixed", fixed_fft="scaled",
                           frontend="fused", device="cpu")
    # The hw-compat streaming CFAR is ported: a valid mode; an unknown
    # geometry and one it cannot take (block scale) raise ValueError.
    tpl.make_processor(p, mode="fixed", cfar_geometry="hw_stream",
                       device="cpu")
    with pytest.raises(ValueError):
        tpl.make_processor(p, cfar_geometry="flat", device="cpu")
    with pytest.raises(ValueError):
        tpl.make_processor(fmcw_tpu_torch.fast(), cfar_geometry="hw_stream",
                           device="cpu")
    # The CA/GO/SO variants are ported: a processor builds and detects.
    for variant in ("ca", "go", "so"):
        pv = p.replace(cfar=dataclasses.replace(p.cfar, variant=variant))
        out = tpl.make_processor(pv, device="cpu")(
            tpl.complex_to_iq(tref.two_target_frame(p)))
        assert int(out["n_dets"]) > 0, variant
    with pytest.raises(ValueError):
        tpl.make_processor(p, frontend="pallas", device="cpu")


def _scan_stream(n_scans, k, seed):
    """Detection arrays (range, doppler, mag, valid) of k entries per scan:
    three moving targets, clutter near them (association conflicts) and
    random false alarms; some entries invalid."""
    rng = np.random.default_rng(seed)
    scans = []
    for s in range(n_scans):
        dets = [(200 - 5 * s, 40, 5000.0), (600, 80 + s, 8000.0),
                (400 + 3 * s, 60, 3000.0)]
        for r, d, _ in list(dets):
            for _ in range(3):
                dets.append((r + int(rng.integers(-6, 7)),
                             d + int(rng.integers(-3, 4)),
                             float(rng.integers(1000, 9000))))
        while len(dets) < k:
            dets.append((int(rng.integers(0, 1024)), int(rng.integers(0, 128)),
                         float(rng.uniform(500, 4000))))
        r, d, m = map(np.asarray, zip(*dets[:k]))
        valid = rng.random(k) < 0.9
        valid[:3] = True
        scans.append((r.astype(np.int32), d.astype(np.int32),
                      m.astype(np.float32), valid))
    return scans


@pytest.mark.parametrize("assoc", ["nearest", "hw"])
def test_tracker_bit_equal_to_jax(assoc):
    tp = fmcw_tpu_torch.TrackerParams(assoc=assoc)
    jtp = fmcw_tpu.TrackerParams(assoc=assoc)
    jstate = jtrk.init_state(jtp)
    tstate = ttrk.state_from_numpy(jax.tree.map(np.asarray, jstate),
                                   device="cpu")
    for r, d, m, v in _scan_stream(6, 80, seed=len(assoc)):
        jstate, jrep = jtrk.step(jstate, r, d, m, v, tp=jtp)
        tstate, trep = ttrk.step(tstate, r, d, m, v, tp=tp)
        jn = jax.tree.map(np.asarray, jstate)
        tn = ttrk.state_to_numpy(tstate)
        assert jn.keys() == tn.keys()
        for key in jn:
            assert np.array_equal(jn[key], tn[key]), key
        for key in jrep:
            assert np.array_equal(np.asarray(jrep[key]),
                                  trep[key].numpy()), key
    assert int(trep["report_mask"].sum()) >= 3       # targets went firm


def test_tracker_saturates_float_magnitudes_as_jax():
    """A float det_mag beyond int32 saturates (2^31 and up to 2^31 - 1,
    -3e9 to -2^31) and NaN becomes 0, as JAX's astype(int32): on
    initiation (scan 1) and on update (scan 2, the same detections)."""
    tp, jtp = fmcw_tpu_torch.TrackerParams(), fmcw_tpu.TrackerParams()
    r = np.array([100, 300, 500, 700, 900], np.int32)
    d = np.array([10, 30, 50, 70, 90], np.int32)
    m = np.array([9.93e9, 2.0 ** 31, -3e9, np.nan, 4096.0], np.float32)
    v = np.ones(5, bool)
    jstate = jtrk.init_state(jtp)
    tstate = ttrk.state_from_numpy(jax.tree.map(np.asarray, jstate),
                                   device="cpu")
    for _ in range(2):
        jstate, _ = jtrk.step(jstate, r, d, m, v, tp=jtp)
        tstate, _ = ttrk.step(tstate, torch.as_tensor(r), torch.as_tensor(d),
                              torch.as_tensor(m), torch.as_tensor(v), tp=tp)
        jn = jax.tree.map(np.asarray, jstate)
        tn = ttrk.state_to_numpy(tstate)
        assert jn.keys() == tn.keys()
        for key in jn:
            assert np.array_equal(jn[key], tn[key]), key
    assert sorted(tn["last_mag"][tn["active"] == 1].tolist()) == [
        -2 ** 31, 0, 4096, 2 ** 31 - 1, 2 ** 31 - 1]
