"""The array-radar model of the port (ops/beamform, the float-input and
magnitude-only front end, make_array_processor) against the JAX package on
the CPU.

* steering_matrix: equal to JAX's (np.array_equal).
* beamform: within 1e-6 of the peak of JAX's HIGHEST product (both sum 8
  float32 products, in another order).
* The float-input range transform (kernel A's twin) and the magnitude-only
  slow-time stage (kernel B's): within 2e-4 of the peak of JAX's fused
  kernel rdm_frontend(detect=False) in interpret mode (its bf16x3
  contract, tests/test_array_pipeline.py) and within 1e-5 of JAX's XLA
  chain (HIGHEST).
* The slice as a whole: make_array_processor on the "plain" and "staged"
  routes against JAX's make_array_processor(frontend="xla") at
  tests/test_array_pipeline.py's 256x64, 8 elements, 8 beams, for
  ref_angle 0, per-beam plus cross-beam grouping, and ref_angle 1 (quick
  CFAR): the array gate (fmcw_tpu_torch/parity.py) with M = JAX's magnitude
  cube and T, S the plain cfar_3d's taps on it, the same strongest
  detection, the point source at its matched beam, and magnitude cubes
  within 1e-5 of the peak.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import fmcw_tpu
import fmcw_tpu_torch
from fmcw_tpu.models import pipeline as jpl
from fmcw_tpu.ops import beamform as JBF
from fmcw_tpu.ops.frontend_pallas import rdm_frontend
from fmcw_tpu_torch import parity
from fmcw_tpu_torch.golden import reference as tref
from fmcw_tpu_torch.models import pipeline as tpl
from fmcw_tpu_torch.ops import beamform as BF, cfar as TC
from fmcw_tpu_torch.ops import frontend as F

# Share the CPU with the other test workers (the suite runs 6 at once).
torch.set_num_threads(2)

P = fmcw_tpu_torch.RadarParams(n_range=256, n_doppler=64,
                               cfar=fmcw_tpu_torch.CfarParams(scale_block=2))
N_ELEMS = N_BEAMS = 8
TOL = 1e-5


def _jparams(p):
    return fmcw_tpu.RadarParams(
        n_range=p.n_range, n_doppler=p.n_doppler,
        cfar=fmcw_tpu.CfarParams(**dataclasses.asdict(p.cfar)))


def _matched_beam(u0, n_beams=N_BEAMS):
    u = np.linspace(-np.sin(np.deg2rad(60.0)), np.sin(np.deg2rad(60.0)),
                    n_beams)
    return int(np.argmin(np.abs(u - u0)))


def _element_iq(p, u0, seed, targets=((60, 20, 12000),)):
    """A point source at steering sine ``u0``: per-element phase-shifted
    copies of a target frame plus independent noise, int16
    (N_ELEMS, n_doppler, n_range, 2) (tests/test_array_pipeline.py's
    stimulus)."""
    rng = np.random.default_rng(seed)
    z = np.asarray(tref.two_target_frame(p, seed=seed, targets=targets))
    return np.stack([tpl.complex_to_iq(
        z * np.exp(2j * np.pi * 0.5 * e * u0)
        + rng.normal(0, 8, z.shape) + 1j * rng.normal(0, 8, z.shape))
        for e in range(N_ELEMS)])


@pytest.mark.parametrize("n_elems,n_beams,taper", [
    (8, 8, None), (4, 16, None), (16, 4, None), (8, 1, None),
    (8, 8, "hamming"), (5, 3, "hamming")])
def test_steering_matrix_equals_jax(n_elems, n_beams, taper):
    for kw in ({}, dict(spacing_wl=0.45, max_angle_deg=45.0)):
        wr, wi = BF.steering_matrix(n_elems, n_beams, taper=taper, **kw)
        jr, ji = JBF.steering_matrix(n_elems, n_beams, taper=taper, **kw)
        assert np.array_equal(wr, jr) and np.array_equal(wi, ji)
        assert wr.dtype == jr.dtype == np.float32
    with pytest.raises(ValueError):
        BF.steering_matrix(4, 4, taper="kaiser")


def test_beamform_matches_jax_highest():
    iq = _element_iq(P, 0.4, seed=11).astype(np.float32)
    re, im = iq[..., 0], iq[..., 1]
    jr, ji = JBF.beamform(jnp.asarray(re), jnp.asarray(im), N_BEAMS,
                          taper="hamming")
    br, bi = BF.beamform(torch.as_tensor(re), torch.as_tensor(im), N_BEAMS,
                         taper="hamming")
    peak = float(np.maximum(np.abs(jr).max(), np.abs(ji).max()))
    assert np.max(np.abs(br.numpy() - np.asarray(jr))) <= 1e-6 * peak
    assert np.max(np.abs(bi.numpy() - np.asarray(ji))) <= 1e-6 * peak
    # A batch of cubes (elem_dim=1) is each cube's beamforming.
    b2r, b2i = BF.beamform(torch.as_tensor(np.stack([re, re[::-1].copy()])),
                           torch.as_tensor(np.stack([im, im[::-1].copy()])),
                           N_BEAMS, taper="hamming", elem_dim=1)
    assert torch.equal(b2r[0], br) and torch.equal(b2i[0], bi)
    mag = BF.beam_cube(torch.as_tensor(re), torch.as_tensor(im), N_BEAMS)
    jmag = JBF.beam_cube(jnp.asarray(re), jnp.asarray(im), N_BEAMS)
    assert np.max(np.abs(mag.numpy() - np.asarray(jmag))) <= 1e-6 * peak


@pytest.mark.parametrize("bypass", [False, True])
def test_float_and_magnitude_only_frontend_vs_jax(bypass):
    """quick() beamformed float I/Q through the twins of kernel A's float
    entry point and kernel B's magnitude-only one (what the wrappers run on
    a CPU tensor) against JAX's fused kernel (interpret) and XLA chain."""
    p = fmcw_tpu_torch.quick()
    iq = _element_iq(p, -0.25, seed=9, targets=((40, 10, 12000),))
    iq = iq.astype(np.float32)
    br, bi = BF.beamform(torch.as_tensor(iq[..., 0]),
                         torch.as_tensor(iq[..., 1]), 4)
    re, im = F.range_fft_float(br, bi)
    mag, nonfinite = F.slowtime_mag(re, im, bypass)
    assert torch.equal(mag, F.slowtime_mag_plain(
        *F.range_fft_float_plain(br, bi), bypass))
    assert int(nonfinite.sum()) == 0
    biq = jnp.stack([jnp.asarray(br.numpy()), jnp.asarray(bi.numpy())], -1)
    jk = np.asarray(jax.vmap(lambda x: rdm_frontend(
        x, bypass, interpret=True))(biq))
    peak = float(jk.max())
    assert np.max(np.abs(mag.numpy() - jk)) <= 2e-4 * peak
    jx = np.asarray(jpl.make_array_processor(
        _jparams(p), n_elems=N_ELEMS, n_beams=4, frontend="xla")(
            iq.astype(np.int16), mti_bypass=bypass)["mag_cube"])
    assert np.max(np.abs(mag.numpy() - jx)) <= TOL * float(jx.max())


CONFIGS = {
    "ref_angle0": (P, dict()),
    "grouped": (P, dict(peak_group_radius=2, beam_group_radius=1)),
    "ref_angle1_quick_cfar": (P.replace(cfar=fmcw_tpu_torch.quick().cfar),
                              dict(ref_angle=1, guard_angle=0)),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_array_processor_gate_vs_jax_xla(name):
    p, kw = CONFIGS[name]
    u0 = 0.4
    iq = _element_iq(p, u0, seed=13)
    ref = jax.tree.map(np.asarray, jpl.make_array_processor(
        _jparams(p), n_elems=N_ELEMS, n_beams=N_BEAMS, frontend="xla",
        **kw)(iq))
    M = ref["mag_cube"]
    _, T, S = TC.cfar_3d(torch.tensor(M), 0, p.cfar,
                         kw.get("ref_angle", 0), kw.get("guard_angle", 0),
                         need_debug=True)
    want = parity.array_set(ref)
    for fe in ("plain", "staged"):
        out = tpl.make_array_processor(p, n_elems=N_ELEMS, n_beams=N_BEAMS,
                                       frontend=fe, device="cpu", **kw)(iq)
        ok, report = parity.array_gate(
            parity.array_set(out), want, M, T.numpy(), S.numpy(),
            radius=kw.get("peak_group_radius", 0),
            beam_radius=kw.get("beam_group_radius", 0),
            targets=[(60, 20, 12000)], target_beam=_matched_beam(u0),
            capacity=p.tracker.max_dets)
        assert ok, (fe, report)
        mag = out["mag_cube"].numpy()
        assert mag.shape == (N_BEAMS, p.n_range, p.n_doppler)
        assert np.max(np.abs(mag - M)) <= TOL * float(M.max())
        assert int(out["beam_bin"][0]) == _matched_beam(u0)
        assert int(out["nonfinite_count"]) == 0
        assert int(out["saturation_count"]) == 0
        assert abs(int(out["n_dets"]) - int(ref["n_dets"])) <= max(
            2, int(ref["n_dets"]) // 50)
        det = out["det_cube"].numpy()
        assert int(out["n_dets"]) == int((det > 0).sum())


def test_grouping_collapses_cross_beam_duplicates():
    p, kw = CONFIGS["grouped"]
    iq = _element_iq(p, 0.25, seed=6)
    raw = tpl.make_array_processor(p, device="cpu")(iq)
    out = tpl.make_array_processor(p, device="cpu", **kw)(iq)
    assert int(out["n_dets"]) < int(raw["n_dets"])
    cells = {}
    for b, r, d in parity.array_set(out):
        cells.setdefault((r, d), []).append(b)
    for beams in cells.values():
        beams = sorted(beams)
        assert all(b2 - b1 > 1 for b1, b2 in zip(beams, beams[1:]))


def test_batch_array_processor_equals_single_calls():
    p = fmcw_tpu_torch.quick()
    cubes = np.stack([_element_iq(p, u, seed=s, targets=((40, 10, 9000),))
                      for s, u in ((1, 0.3), (2, -0.5), (3, 0.0))])
    for kw in (dict(peak_group_radius=1, beam_group_radius=1),
               dict(ref_angle=1)):
        kw = dict(n_beams=4, device="cpu", **kw)
        batched = tpl.make_batch_array_processor(p, **kw)(cubes, False, 4)
        single = tpl.make_array_processor(p, **kw)
        for b in range(len(cubes)):
            one = single(cubes[b], False, 4)
            assert one.keys() == batched.keys()
            for key, v in one.items():
                assert np.array_equal(v.numpy(), batched[key][b].numpy()), key


def test_array_processor_routes_and_rejections():
    p = fmcw_tpu_torch.quick()
    assert tpl.make_array_processor(p, device="cpu").route == "fused"
    assert tpl.resolve_array_frontend("auto") == "fused"
    assert tpl.resolve_array_frontend("staged") == "staged"
    # A map the kernels cannot take (n_doppler 256) still takes the fused
    # route: no quiet fallback to the staged chain (the kernels raise on the
    # card, tests/test_torch_isolation.py).
    long_cpi = p.replace(n_doppler=256)
    for ref_angle in (0, 1):
        assert tpl.make_array_processor(long_cpi, ref_angle=ref_angle,
                                        device="cpu").route == "fused"
    with pytest.raises(ValueError):
        tpl.make_array_processor(p, frontend="pallas", device="cpu")
    proc = tpl.make_array_processor(p, device="cpu")
    with pytest.raises(ValueError):
        proc(np.zeros((4, p.n_doppler, p.n_range, 2), np.int16))
    ca = p.replace(cfar=dataclasses.replace(p.cfar, variant="ca"))
    with pytest.raises(NotImplementedError):
        tpl.make_array_processor(ca, device="cpu")
