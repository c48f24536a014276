"""The port's plain CFAR, peak grouping and top-K against the JAX package,
fed the SAME float32 maps.

* Per-cell scale: the port decides by counting with the box-sum mean of
  fmcw_tpu/ops/cfar_pallas._kernel_detect, so its det map is bitwise equal
  to cfar_2d_pallas_detect (interpret mode); against the XLA cfar_2d (rank
  stack + top_k) the detection set is equal.
* Block scale: the port's det map and scale map are bitwise equal to the
  XLA cfar_2d / block_scale_map.
* Peak grouping and top-K: exact, including ties and their order.
"""

import dataclasses
import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import fmcw_tpu
import fmcw_tpu_torch
from fmcw_tpu.golden import reference as jref
from fmcw_tpu.models import pipeline as jpl
from fmcw_tpu.ops import cfar as JC, cfar_pallas as JCP, detect as JD
from fmcw_tpu_torch.ops import cfar as TC, detect as TD

# Share the CPU with the other test workers (the suite runs 6 at once).
torch.set_num_threads(2)


def _jcfar(cfar):
    return fmcw_tpu.CfarParams(**dataclasses.asdict(cfar))


def _tied_map(shape, seed):
    """Positive float32 map with plateaus of equal values, exact duplicates
    and a few bright targets."""
    rng = np.random.default_rng(seed)
    m = rng.exponential(100.0, shape).astype(np.float32)
    q = rng.random(shape) < 0.3
    m[q] = np.round(m[q] / 25.0) * 25.0 + 25.0       # many equal values
    r, d = shape
    for _ in range(6):
        i, j = rng.integers(0, r), rng.integers(0, d)
        m[i, j] = m[(i + 1) % r, j] = 3000.0             # tied peak pair
        m[i, (j + 2) % d] = 2500.0
    return m


def _clutter_map(seed):
    """A 256x64 map whose range quarters are uniform noise, a heavy-tailed
    clutter patch and a sparse one, so every block scale class occurs."""
    rng = np.random.default_rng(seed)
    m = _tied_map((256, 64), seed)
    hot = rng.random((64, 64)) < 0.3
    m[64:128] = np.where(hot, 10.0, 1.0) * rng.uniform(90, 110, (64, 64))
    sparse = rng.random((64, 64)) < 0.1
    m[128:192] = np.where(sparse, 100.0, 1.0) * rng.uniform(9, 11, (64, 64))
    return m.astype(np.float32)


@functools.lru_cache(maxsize=4)
def _jax_map(n_range, n_doppler):
    """JAX's own magnitude map of two_target_frame (XLA chain); the map does
    not depend on the CFAR settings."""
    jp = fmcw_tpu.RadarParams(n_range=n_range, n_doppler=n_doppler)
    iq = jpl.complex_to_iq(jref.two_target_frame(jp))
    out = jpl.make_processor(jp, frontend="xla", include_maps=True)(iq)
    m = np.array(out["mag_map"])
    m.setflags(write=False)
    return m


@pytest.mark.parametrize("source,so", [("tied-1", 0), ("tied-2", 4),
                                       ("jax-quick", 0), ("jax-quick", 4)])
def test_percell_bitwise_vs_counting_kernel(source, so):
    if source == "jax-quick":
        m = _jax_map(128, 32).copy()
        cfar = fmcw_tpu_torch.quick().cfar
    else:
        m = _tied_map((128, 64), int(source[-1]))
        cfar = fmcw_tpu_torch.CfarParams(ref_range=3, ref_doppler=2)
    det, _, scale = TC.cfar_2d(torch.as_tensor(m), so, cfar)
    jdet, jscale = JCP.cfar_2d_pallas_detect(
        jnp.asarray(m), so, cfar=_jcfar(cfar), interpret=True)
    assert np.array_equal(det.numpy().view(np.int32),
                          np.asarray(jdet).view(np.int32))
    assert np.array_equal(scale.numpy(), np.asarray(jscale).astype(np.int32))
    assert (det.numpy() > 0).sum() > 0


@pytest.mark.parametrize("so", [0, 4])
def test_percell_full_size_same_set_as_xla(so):
    """1024x128 JAX map, default 13x11 window: same detections (and so the
    same cut values) as the XLA rank-stack cfar_2d."""
    m = _jax_map(1024, 128).copy()
    cfar = fmcw_tpu_torch.CfarParams()
    det, thr, scale = TC.cfar_2d(torch.as_tensor(m), so, cfar,
                                 need_debug=True)
    jdet, jthr, jscale = JC.cfar_2d(jnp.asarray(m), so, cfar=_jcfar(cfar))
    assert np.array_equal(det.numpy(), np.asarray(jdet))
    assert np.array_equal(scale.numpy(), np.asarray(jscale).astype(np.int32))
    # Debug tap: the k-th largest training cell times the scale.
    assert np.array_equal(thr.numpy(), np.asarray(jthr))


@pytest.mark.parametrize("so", [0, 4])
@pytest.mark.parametrize("source", ["clutter", "jax-full"])
def test_block_scale_bitwise_vs_xla(source, so):
    if source == "clutter":
        m = _clutter_map(5)
    else:
        m = _jax_map(1024, 128).copy()
    cfar = fmcw_tpu_torch.fast().cfar
    det, _, scale = TC.cfar_2d(torch.as_tensor(m), so, cfar)
    jdet, _, jscale = JC.cfar_2d(jnp.asarray(m), so, cfar=_jcfar(cfar))
    assert np.array_equal(det.numpy().view(np.int32),
                          np.asarray(jdet).view(np.int32))
    assert np.array_equal(scale.numpy(), np.asarray(jscale).astype(np.int32))
    bs = TC.block_scale_map(torch.as_tensor(m), cfar).numpy()
    jbs = np.asarray(JC.block_scale_map(jnp.asarray(m), _jcfar(cfar), False))
    assert np.array_equal(bs, jbs)
    if source == "clutter":
        assert set(np.unique(bs)) == {cfar.scale_min, cfar.scale_nom,
                                      cfar.scale_max}


@pytest.mark.parametrize("radius", [1, 2])
def test_peak_group_ties_match_jax(radius):
    """Integer-valued det maps with dense ties exercise the lower-index tie
    break and the wrap seams (the scenario of the fused kernel's epilogue
    test)."""
    rng = np.random.default_rng(radius)
    det = np.where(rng.random((64, 128)) < 0.25,
                   rng.integers(1, 4, (64, 128)), 0).astype(np.float32)
    got = TC.peak_group(torch.as_tensor(det), radius).numpy()
    want = np.asarray(JC.peak_group(jnp.asarray(det), radius=radius))
    assert (want > 0).sum() > 10
    assert np.array_equal(got, want)


@pytest.mark.parametrize("shape", [(64, 32), (1024, 128)])
@pytest.mark.parametrize("with_row_max", [False, True])
def test_topk_matches_jax_order_with_ties(shape, with_row_max):
    """Same entries in the same order as lax.top_k's extraction, for the
    flat path (small maps) and the row-select path (large maps), with many
    equal values including ties at the K-th entry."""
    rng = np.random.default_rng(shape[0])
    det = np.where(rng.random(shape) < 0.05,
                   rng.integers(1, 6, shape), 0).astype(np.float32)
    det[3, :] = 5.0                                   # a row of ties
    row_max = det.max(axis=1) if with_row_max else None
    got = TD.topk_detections(
        torch.as_tensor(det), 64,
        row_max=None if row_max is None else torch.as_tensor(row_max))
    want = JD.topk_detections(
        jnp.asarray(det), 64,
        row_max=None if row_max is None else jnp.asarray(row_max))
    for key in ("range_bin", "doppler_bin", "mag", "valid", "n_dets"):
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key


def test_topk_batched_equals_per_frame():
    rng = np.random.default_rng(3)
    det = np.where(rng.random((3, 512, 64)) < 0.02,
                   rng.integers(1, 4, (3, 512, 64)), 0).astype(np.float32)
    got = TD.topk_detections(torch.as_tensor(det), 64)
    for b in range(3):
        one = TD.topk_detections(torch.as_tensor(det[b]), 64)
        for key in one:
            assert torch.equal(got[key][b], one[key]), key
