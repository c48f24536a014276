"""The standalone CFAR step (ops/cfar_detect.py: the cfar_detect kernel's
wrapper, whose plain twin is ops/cfar.cfar_2d) and the integer CFAR,
grouping and top-K of fixed mode, against the JAX package on the SAME maps.

* Integer maps: det and scale maps bitwise equal to JAX's cfar_2d(integer=
  True) and to cfar_2d_pallas_detect(integer=True) in interpret mode (the
  TPU kernels _kernel_detect and _kernel_detect_scaled), per-cell and block
  scale, with and without scale_override.
* Float maps: bitwise equal to cfar_2d_pallas_detect(integer=False).
* Peak grouping and top-K on int32 maps: exact, ties and their order too.
"""

import dataclasses
import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import fmcw_tpu
import fmcw_tpu_torch
from fmcw_tpu.ops import cfar as JC, cfar_pallas as JCP, detect as JD
from fmcw_tpu_torch.golden import reference as tref
from fmcw_tpu_torch.models import pipeline as tpl
from fmcw_tpu_torch.ops import cfar as TC, cfar_detect as CD, detect as TD

# Share the CPU with the other test workers (the suite runs 6 at once).
torch.set_num_threads(2)


def _jcfar(cfar):
    return fmcw_tpu.CfarParams(**dataclasses.asdict(cfar))


def _int_map(shape, seed):
    """int32 magnitudes in the fixed chain's range (at most 45056): noise
    with plateaus of equal values and a few bright tied peaks."""
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 400, shape)
    q = rng.random(shape) < 0.3
    m[q] = (m[q] // 50) * 50 + 50
    r, d = shape
    for _ in range(6):
        i, j = rng.integers(0, r), rng.integers(0, d)
        m[i, j] = m[(i + 1) % r, j] = 30000
        m[i, (j + 2) % d] = 45056
    return m.astype(np.int32)


@functools.lru_cache(maxsize=2)
def _fixed_mag(preset):
    """The fixed chain's magnitude map of the golden frame (the port's
    staged route, bit-equal to the golden model)."""
    p = getattr(fmcw_tpu_torch, preset)()
    iq = tpl.complex_to_iq(tref.two_target_frame(p))
    out = tpl.make_processor(p, mode="fixed", device="cpu")(iq)
    m = out["mag_map"].numpy()
    m.setflags(write=False)
    return m


def _cfar(scale_mode):
    """quick()'s CFAR window, with the block scale on 4x4 blocks."""
    return dataclasses.replace(fmcw_tpu_torch.quick().cfar,
                               scale_mode=scale_mode, scale_block=4)


@pytest.mark.parametrize("source,scale_mode,so", [
    ("tied", "cell", 0), ("tied", "cell", 4), ("tied", "block", 0),
    ("tied", "block", 4), ("fixed", "cell", 0), ("fixed", "block", 4)])
def test_integer_cfar_bitwise_vs_xla(source, scale_mode, so):
    """cfar_detect (CPU: cfar_2d) on int32 maps == JAX cfar_2d(integer=True):
    det map, scale map, and the block scale map alone."""
    m = (_int_map((128, 32), 1) if source == "tied"
         else _fixed_mag("quick").copy())
    cfar = _cfar(scale_mode)
    det, scale = CD.cfar_detect(torch.as_tensor(m), so, cfar=cfar)
    jdet, _, jscale = JC.cfar_2d(jnp.asarray(m), so, _jcfar(cfar),
                                 integer=True)
    assert det.dtype == torch.int32 and scale.dtype == torch.int32
    assert np.array_equal(det.numpy(), np.asarray(jdet))
    assert np.array_equal(scale.numpy(), np.asarray(jscale))
    assert int((det > 0).sum()) > 0
    if scale_mode == "block":
        assert np.array_equal(
            TC.block_scale_map(torch.as_tensor(m), cfar).numpy(),
            np.asarray(JC.block_scale_map(jnp.asarray(m), _jcfar(cfar),
                                          True)))


@pytest.mark.parametrize("scale_mode,so,integer", [
    ("cell", 0, True), ("cell", 4, True), ("block", 0, True),
    ("block", 4, True), ("cell", 0, False), ("block", 0, False)])
def test_bitwise_vs_counting_kernels_interpret(scale_mode, so, integer):
    """Against cfar_2d_pallas_detect in interpret mode at quick(): per-cell
    scale runs _kernel_detect, block scale _kernel_detect_scaled."""
    m = _int_map((128, 32), 2)
    if not integer:
        m = m.astype(np.float32)
    cfar = _cfar(scale_mode)
    det, scale = CD.cfar_detect(torch.as_tensor(m), so, cfar=cfar)
    jdet, jscale = JCP.cfar_2d_pallas_detect(
        jnp.asarray(m), so, _jcfar(cfar), integer=integer, tile_rows=32,
        interpret=True)
    assert det.dtype == (torch.int32 if integer else torch.float32)
    assert np.array_equal(det.numpy(), np.asarray(jdet))
    assert np.array_equal(scale.numpy(), np.asarray(jscale).astype(np.int32))


def test_scale_map_argument():
    """A given block scale map is used as is (scale_override folded in);
    per-cell mode refuses one."""
    m = torch.as_tensor(_int_map((128, 32), 3))
    cfar = _cfar("block")
    smap = TC.block_scale_map(m, cfar)
    for so in (0, 4):
        got = CD.cfar_detect(m, so, cfar=cfar, scale_map=smap)
        want = CD.cfar_detect(m, so, cfar=cfar)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    flat = torch.full_like(smap, 5)
    det, scale = CD.cfar_detect(m, cfar=cfar, scale_map=flat)
    assert torch.equal(scale, flat)
    with pytest.raises(ValueError):
        CD.cfar_detect(m, cfar=_cfar("cell"), scale_map=smap)


def test_batched_equals_per_map():
    maps = torch.as_tensor(np.stack([_int_map((128, 32), s)
                                     for s in range(3)]))
    for cfar in (_cfar("cell"), _cfar("block")):
        det, scale = CD.cfar_detect(maps, 2, cfar=cfar)
        for b in range(3):
            d1, s1 = CD.cfar_detect(maps[b], 2, cfar=cfar)
            assert torch.equal(det[b], d1) and torch.equal(scale[b], s1)


def test_unported_variants_raise():
    m = torch.as_tensor(_int_map((128, 32), 4))
    for variant in ("ca", "go", "so"):
        with pytest.raises(NotImplementedError):
            CD.cfar_detect(m, cfar=dataclasses.replace(
                _cfar("cell"), variant=variant))


@pytest.mark.parametrize("radius", [1, 2])
def test_peak_group_int_maps_vs_jax(radius):
    m = _int_map((128, 32), 5)
    det = np.where(m > 200, m, 0).astype(np.int32)
    got = TC.peak_group(torch.as_tensor(det), radius)
    want = JC.peak_group(jnp.asarray(det), radius)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(64, 32), (1024, 128)])
@pytest.mark.parametrize("with_row_max", [False, True])
def test_topk_int32_ties_vs_jax(shape, with_row_max):
    """Small integer magnitudes tie often: the same entries in lax.top_k's
    lower-index-first order, int32 mag out."""
    rng = np.random.default_rng(shape[0] + 1)
    det = np.where(rng.random(shape) < 0.05,
                   rng.integers(1, 6, shape), 0).astype(np.int32)
    det[3, :] = 5
    row_max = det.max(axis=1) if with_row_max else None
    got = TD.topk_detections(
        torch.as_tensor(det), 64,
        row_max=None if row_max is None else torch.as_tensor(row_max))
    want = JD.topk_detections(
        jnp.asarray(det), 64,
        row_max=None if row_max is None else jnp.asarray(row_max))
    assert got["mag"].dtype == torch.int32
    for key in ("range_bin", "doppler_bin", "mag", "valid", "n_dets"):
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key


def _float_map(shape, seed):
    """float32 noise with plateaus of equal values and bright tied peaks."""
    rng = np.random.default_rng(seed)
    m = rng.exponential(100.0, shape)
    q = rng.random(shape) < 0.3
    m[q] = np.floor(m[q] / 50) * 50 + 50
    r, d = shape
    for _ in range(6):
        i, j = rng.integers(0, r), rng.integers(0, d)
        m[i, j] = m[(i + 1) % r, j] = 3e4
        m[i, (j + 2) % d] = 4.5e4
    return m.astype(np.float32)


@pytest.mark.parametrize("radius", [0, 1, 2])
@pytest.mark.parametrize("scale_mode", ["cell", "block"])
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("shape", [(64, 32), (256, 64)])
def test_detect_group_vs_jax(shape, integer, scale_mode, radius):
    """cfar_detect_group (CPU: its twin) == JAX cfar_2d then peak_group:
    the grouped det map and the scale map bit for bit, the row maxima of
    the grouped map and its detection count."""
    seed = shape[0] + radius
    m = _int_map(shape, seed) if integer else _float_map(shape, seed)
    cfar = _cfar(scale_mode)
    det, scale, row_max, n_dets = CD.cfar_detect_group(
        torch.as_tensor(m), cfar=cfar, peak_group_radius=radius)
    jdet, _, jscale = JC.cfar_2d(jnp.asarray(m), 0, _jcfar(cfar),
                                 integer=integer)
    want = np.asarray(JC.peak_group(jdet, radius) if radius else jdet)
    assert det.dtype == torch.as_tensor(m).dtype
    assert np.array_equal(det.numpy().view(np.int32), want.view(np.int32))
    assert np.array_equal(scale.numpy(), np.asarray(jscale).astype(np.int32))
    assert np.array_equal(row_max.numpy(), np.maximum(want, 0).max(axis=-1))
    assert int(n_dets) == int((want > 0).sum()) > 0
