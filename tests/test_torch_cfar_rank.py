"""The rank-select CFAR behind the debug taps (TPU kernel row 9) and the
processors' debug routes, against the JAX package on the CPU.

* ``ops/cfar_rank.cfar_rank_plain`` (the plain twin of ``csrc/cfar_rank.cu``)
  equals ``fmcw_tpu.ops.cfar_pallas.cfar_2d_pallas`` (interpret mode, quick
  window, 256x64) bit for bit in det, threshold and scale: integer maps
  (int_bits 16) with a scale override, float maps exact on a prepadded
  range shard, float maps on 16 key bits.
* The block-scale taps (a given scale map, exact ranking) equal JAX's XLA
  ``cfar_2d`` bit for bit, float and integer.
* Exact ranking decides as the counting twin ``ops/cfar.cfar_2d``; 16 key
  bits give thresholds at most 0.8% under and a det map that holds the
  counting one.
* ``make_batch_processor(include_debug=True, device="cpu")``: float, per-cell
  and block, on the "fused" (kernel twins) and "staged" routes with
  ``cfar_rank_bits=None``: the taps and det map bit-equal to JAX's XLA
  ``cfar_2d`` on the port's own magnitudes, the detections through the margin
  gate against JAX's ``frontend="xla"`` processor; fixed mode's det map the
  golden model's and its taps JAX's XLA ``cfar_2d``'s on it bit for bit, its
  detection set JAX's XLA chain's.
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
from fmcw_tpu.ops import cfar as JC
from fmcw_tpu.ops.cfar_pallas import cfar_2d_pallas
from fmcw_tpu_torch import parity
from fmcw_tpu_torch.golden import reference as tref
from fmcw_tpu_torch.models import pipeline as tpl
from fmcw_tpu_torch.ops import cfar as TC, cfar_rank as RK

# Share the CPU with the other test workers (the suite runs 6 at once).
torch.set_num_threads(2)

QUICK = fmcw_tpu_torch.quick().cfar
P256 = fmcw_tpu_torch.RadarParams(n_range=256, n_doppler=64)


def _jcfar(cfar):
    return fmcw_tpu.CfarParams(**dataclasses.asdict(cfar))


def _jparams(p):
    return fmcw_tpu.RadarParams(
        n_range=p.n_range, n_doppler=p.n_doppler,
        cfar=_jcfar(p.cfar),
        tracker=fmcw_tpu.TrackerParams(**dataclasses.asdict(p.tracker)))


def _map(shape=(256, 64), seed=0):
    """A float32 map of exponential noise with a clutter band (every scale
    class occurs), plateaus of equal values and one bright target."""
    rng = np.random.default_rng(seed)
    r, d = shape
    m = rng.exponential(100.0, shape)
    m[r // 4:r // 2] *= np.where(rng.random((r // 4, d)) < 0.2, 20.0, 1.0)
    q = rng.random(shape) < 0.2
    m[q] = np.round(m[q] / 25.0) * 25.0 + 25.0
    m[10, 10] = 9e4
    return m.astype(np.float32)


# name: (map kind, JAX keywords, port bits, scale_override, prepadded)
PALLAS_CASES = {
    "int16-override3": ("int", dict(integer=True, int_bits=16), 16, 3, False),
    "float-exact-prepadded": ("float", dict(rank_bits=None), None, 0, True),
    "float-16bits": ("float", dict(rank_bits=16), 16, 0, False),
}


@pytest.mark.parametrize("name", list(PALLAS_CASES))
def test_rank_twin_bitwise_vs_pallas_interpret(name):
    kind, jkw, bits, so, pre = PALLAS_CASES[name]
    m = _map(seed=len(name))
    if kind == "int":
        m = (m / m.max() * 45000).astype(np.int32)
    if pre:
        # A range shard: halo rows that are not the map's own wrap.
        hr = QUICK.halo_range
        halo = np.random.default_rng(1).exponential(300.0, (2 * hr, 64))
        m = np.concatenate([halo[:hr], m, halo[hr:]]).astype(m.dtype)
    jd, jt, js = (np.asarray(x) for x in cfar_2d_pallas(
        jnp.asarray(m), so, cfar=_jcfar(QUICK), prepadded_range=pre,
        interpret=True, **jkw))
    det, thr, scale = RK.cfar_rank_plain(torch.as_tensor(m), so, cfar=QUICK,
                                         bits=bits, prepadded_range=pre)
    assert det.dtype == thr.dtype == torch.as_tensor(m).dtype
    assert np.array_equal(det.numpy(), jd)
    assert np.array_equal(thr.numpy(), jt)
    assert np.array_equal(scale.numpy(), js.astype(np.int32))
    assert (det > 0).sum() > 0
    if so:
        assert set(np.unique(scale.numpy())) == {so}
    else:
        assert len(np.unique(scale.numpy())) == 3


@pytest.mark.parametrize("integer,so", [(False, 0), (True, 4)],
                         ids=["float", "int-override4"])
def test_block_taps_bitwise_vs_xla(integer, so):
    """Block scale: exact ranking with block_scale_map's scale, the taps of
    JAX's XLA cfar_2d."""
    m = _map(seed=5)
    if integer:
        m = (m / m.max() * 45000).astype(np.int32)
    cfar = fmcw_tpu_torch.fast().cfar
    det, thr, scale = RK.cfar_rank_plain(torch.as_tensor(m), so, cfar=cfar)
    jd, jt, js = (np.asarray(x) for x in JC.cfar_2d(
        jnp.asarray(m), so, cfar=_jcfar(cfar), integer=integer))
    assert np.array_equal(det.numpy(), jd)
    assert np.array_equal(thr.numpy(), jt)
    assert np.array_equal(scale.numpy(), js.astype(np.int32))
    sm = TC.block_scale_map(torch.as_tensor(m), cfar)
    again = RK.cfar_rank_plain(torch.as_tensor(m), so, cfar=cfar,
                               scale_map=sm)
    assert all(torch.equal(a, b) for a, b in zip(again, (det, thr, scale)))


def test_exact_rank_decides_as_counting_and_16_bits_under_it():
    m = torch.as_tensor(_map(seed=7))
    cfar = fmcw_tpu_torch.CfarParams()
    det, thr, scale = RK.cfar_rank_plain(m, 0, cfar=cfar)
    cdet, cthr, cscale = TC.cfar_2d(m, 0, cfar, need_debug=True)
    assert torch.equal(det, cdet) and torch.equal(scale, cscale)
    assert torch.equal(thr, cthr)
    det16, thr16, scale16 = RK.cfar_rank_plain(m, 0, cfar=cfar, bits=16)
    same = scale16 == scale
    assert bool(same.float().mean() > 0.99)
    ratio = thr16[same] / thr[same]
    assert bool((ratio <= 1).all()) and bool((ratio > 1 - 2 ** -7).all())
    keep = same & (det > 0)
    assert bool((det16[keep] == det[keep]).all())
    with pytest.raises(ValueError):
        RK.cfar_rank_plain(m, 0, cfar=cfar, bits=32)
    with pytest.raises(ValueError, match="scale_map"):
        RK.cfar_rank_plain(m, 0, cfar=cfar, scale_map=scale)


def _frames(p, n=2, seed=3):
    rng = np.random.default_rng(seed)
    out = np.stack([tpl.complex_to_iq(tref.two_target_frame(p, seed=s))
                    for s in range(n)])
    return out + rng.integers(-8, 8, out.shape).astype(np.int16)


@pytest.mark.parametrize("scale,frontend", [("cell", "fused"),
                                            ("block", "staged")])
def test_float_debug_processor_vs_jax(scale, frontend):
    p = P256.replace(cfar=dataclasses.replace(P256.cfar, scale_mode=scale))
    iq = _frames(p)
    out = tpl.make_batch_processor(p, frontend=frontend, include_debug=True,
                                   cfar_rank_bits=None, peak_group_radius=2,
                                   device="cpu")(iq, False, 0)
    refs = jax.tree.map(np.asarray, jpl.make_batch_processor(
        _jparams(p), frontend="xla", include_debug=True,
        peak_group_radius=2)(iq))
    # The scale tap in JAX's type (float32), the magnitude map's.
    assert out["scale_map"].numpy().dtype == refs["scale_map"].dtype
    assert out["scale_map"].dtype == out["mag_map"].dtype == torch.float32
    for b in range(iq.shape[0]):
        mag = out["mag_map"][b].numpy()
        jd, jt, js = JC.cfar_2d(jnp.asarray(mag), 0, cfar=_jcfar(p.cfar))
        jd = JC.peak_group(jd, radius=2)
        assert np.array_equal(out["threshold_map"][b].numpy(), np.asarray(jt))
        assert np.array_equal(out["scale_map"][b].numpy(), np.asarray(js))
        assert np.array_equal(out["det_map"][b].numpy(), np.asarray(jd))
        ref = {k: v[b] for k, v in refs.items()}
        ok, report = parity.margin_gate(
            parity.detection_set(out, b), parity.detection_set(ref),
            ref["mag_map"], ref["threshold_map"], ref["scale_map"], radius=2,
            capacity=p.tracker.max_dets, targets=tref.golden_targets(p))
        assert ok, report
    assert int(out["nonfinite_count"].sum()) == 0


@pytest.mark.parametrize("scale", ["cell"])
def test_fixed_debug_processor_vs_jax_and_golden(scale):
    """Fixed mode's debug route (auto = staged: the plain stages, then the
    rank select on int32 maps, 16 key bits): the det map the golden model's
    and the taps JAX's XLA cfar_2d's on it, bit for bit; the detection set
    and count those of JAX's XLA chain (whose FP32 magnitudes may differ
    from the golden model's by a few LSB, tests/test_torch_fixed.py)."""
    p = P256.replace(cfar=dataclasses.replace(P256.cfar, scale_mode=scale))
    iq = _frames(p, n=1)
    out = tpl.make_processor(p, mode="fixed", include_debug=True,
                             device="cpu")(iq[0])
    z = iq[0, ..., 0].astype(np.int64) + 1j * iq[0, ..., 1]
    gmag, gdet = tref.process_frame_fixed(z, p)
    assert np.array_equal(out["mag_map"].numpy(), gmag)
    assert np.array_equal(out["det_map"].numpy(), gdet)
    jd, jt, js = (np.asarray(x) for x in JC.cfar_2d(
        jnp.asarray(gmag), 0, cfar=_jcfar(p.cfar), integer=True))
    assert np.array_equal(out["det_map"].numpy(), jd)
    assert np.array_equal(out["threshold_map"].numpy(), jt)
    assert np.array_equal(out["scale_map"].numpy(), js)
    ref = jax.tree.map(lambda v: np.asarray(v)[0], jpl.make_batch_processor(
        _jparams(p), mode="fixed", frontend="xla", include_debug=True)(iq))
    # The scale tap in JAX's type (int32), the magnitude map's.
    assert out["scale_map"].numpy().dtype == ref["scale_map"].dtype
    assert out["scale_map"].dtype == out["mag_map"].dtype == torch.int32
    ok, report = parity.fixed_gate(parity.map_set(out["det_map"].numpy()),
                                   parity.map_set(ref["det_map"]))
    assert ok, report
    assert int(out["n_dets"]) == int(ref["n_dets"]) > 0
