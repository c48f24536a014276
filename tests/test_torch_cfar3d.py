"""The array model's CFAR and grouping (ops/cfar.cfar_3d, the plain twin of
the angle-extended CFAR kernel csrc/cfar_3d_detect.cu; ops/cfar.
peak_group_beams and ops/beam_group, the twin of csrc/beam_group.cu)
against the JAX package on the SAME cubes.

* cfar_3d against JAX's cfar_3d(method="xla"): integer cubes exact (det and
  scale), float cubes equal decisions (JAX's XLA body sums the training set
  in another order, so equal decisions are what the stimulus shows).
* cfar_3d against JAX's angle-extended kernel cfar_3d_pallas_detect in
  interpret mode: bitwise on float and integer cubes (the twin sums in the
  kernel's order).
* peak_group_beams against JAX's fast path, its beam_ids path and
  peak_group_beams_pallas in interpret mode: exact, row maxima and counts
  included.
"""

import dataclasses
import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import fmcw_tpu
import fmcw_tpu_torch
from fmcw_tpu.ops import cfar as JC, cfar_pallas as JCP
from fmcw_tpu_torch.golden import reference as tref
from fmcw_tpu_torch.models import pipeline as tpl
from fmcw_tpu_torch.ops import beam_group as BG
from fmcw_tpu_torch.ops import cfar as TC, cfar3d_detect as C3

# Share the CPU with the other test workers (the suite runs 6 at once).
torch.set_num_threads(2)

QUICK = fmcw_tpu_torch.quick().cfar
FULL = fmcw_tpu_torch.CfarParams()


def _jcfar(cfar):
    return fmcw_tpu.CfarParams(**dataclasses.asdict(cfar))


@functools.lru_cache(maxsize=2)
def _beam_cube(n_range, n_doppler):
    """Float magnitudes of 4 beams, (4, n_range, n_doppler): the golden
    two-target frame on an 8-element array at steering sine 0.3 plus
    seeded noise, beamformed (the port's plain path up to the magnitude)."""
    p = fmcw_tpu_torch.RadarParams(n_range=n_range, n_doppler=n_doppler)
    rng = np.random.default_rng(3)
    z = np.asarray(tref.two_target_frame(p))
    iq = np.stack([tpl.complex_to_iq(
        z * np.exp(2j * np.pi * 0.5 * e * 0.3)
        + rng.normal(0, 8, z.shape) + 1j * rng.normal(0, 8, z.shape))
        for e in range(8)])
    out = tpl.make_array_processor(p, n_beams=4, frontend="plain",
                                   device="cpu")(iq)
    m = out["mag_cube"].numpy()
    m.setflags(write=False)
    return m


def _int_cube(shape, seed):
    """int32 cube with plateaus of equal values and bright tied peaks."""
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 400, shape)
    q = rng.random(shape) < 0.3
    m[q] = (m[q] // 50) * 50 + 50
    a, r, d = shape
    for _ in range(8):
        i, j, k = rng.integers(0, a), rng.integers(0, r), rng.integers(0, d)
        m[i, j, k] = m[(i + 1) % a, j, k] = 30000
        m[i, (j + 1) % r, k] = 45056
    return m.astype(np.int32)


@pytest.mark.parametrize("ra,ga", [(1, 0), (2, 1)])
def test_offsets_3d_equal_jax(ra, ga):
    for cfar in (QUICK, FULL):
        assert TC._offsets_3d(cfar, ra, ga) == JC._offsets_3d(
            _jcfar(cfar), ra, ga)


@pytest.mark.parametrize("cube_kind", ["float", "int"])
@pytest.mark.parametrize("ra,ga,so", [(1, 0, 0), (2, 1, 0), (1, 0, 4)])
def test_cfar_3d_vs_jax_xla(cube_kind, ra, ga, so):
    """Quick CFAR on the (4, 64, 32) beam cube; integer: exact det and
    scale; float: equal decisions and scales."""
    if cube_kind == "float":
        cube = _beam_cube(64, 32)
    else:
        cube = _int_cube((4, 64, 32), seed=ra + ga)
    integer = cube_kind == "int"
    jdet, jthr, jscale = JC.cfar_3d(jnp.asarray(cube), so,
                                    cfar=_jcfar(QUICK), integer=integer,
                                    ref_angle=ra, guard_angle=ga,
                                    method="xla")
    det, thr, scale = TC.cfar_3d(torch.tensor(cube), so, QUICK, ra, ga,
                                 need_debug=True)
    assert np.array_equal(det.numpy(), np.asarray(jdet))
    assert np.array_equal(scale.numpy(), np.asarray(jscale).astype(np.int32))
    # The threshold tap: the same rank value times the same scale.
    assert np.array_equal(thr.numpy(), np.asarray(jthr))
    assert int((det > 0).sum()) > 0


def test_cfar_3d_full_window_vs_jax_xla():
    """The default 13x11 window at ref_angle 1 (n_ref = 414) on a
    (4, 64, 32) integer cube: exact."""
    cube = _int_cube((4, 64, 32), seed=9)
    jdet, _, jscale = JC.cfar_3d(jnp.asarray(cube), 0, cfar=_jcfar(FULL),
                                 integer=True, ref_angle=1, method="xla",
                                 need_debug=False)
    det, _, scale = TC.cfar_3d(torch.tensor(cube), 0, FULL, 1, 0)
    assert np.array_equal(det.numpy(), np.asarray(jdet))
    assert np.array_equal(scale.numpy(), np.asarray(jscale))


@pytest.mark.parametrize("cube_kind", ["float", "int"])
def test_cfar_3d_twin_vs_jax_kernel_interpret(cube_kind):
    """The twin against the TPU kernel itself (interpret mode), quick CFAR
    at (4, 64, 32), ref_angle 1: bitwise, scale included."""
    integer = cube_kind == "int"
    cube = _int_cube((4, 64, 32), 5) if integer else _beam_cube(64, 32)
    jdet, jscale = JCP.cfar_3d_pallas_detect(
        jnp.asarray(cube), 0, cfar=_jcfar(QUICK), integer=integer,
        ref_angle=1, guard_angle=0, interpret=True)
    det, scale = C3.cfar3d_detect(torch.tensor(cube), 0, cfar=QUICK,
                                  ref_angle=1)
    assert np.array_equal(det.numpy(), np.asarray(jdet))
    assert np.array_equal(scale.numpy(), np.asarray(jscale).astype(np.int32))
    assert int((det > 0).sum()) > 0


def test_cfar_3d_ref_angle_0_is_cfar_2d_per_beam():
    cube = torch.tensor(_beam_cube(64, 32))
    det, thr, scale = TC.cfar_3d(cube, 0, QUICK, 0, 0, need_debug=True)
    for a in range(cube.shape[0]):
        d2, t2, s2 = TC.cfar_2d(cube[a], 0, QUICK, need_debug=True)
        assert torch.equal(det[a], d2) and torch.equal(scale[a], s2)
        assert torch.equal(thr[a], t2)


def test_cfar_3d_ignores_block_scale_mode_and_wraps_beams():
    """ref_angle > 0 decides per cell in either scale mode (JAX's XLA
    body); the beam axis wraps: a bright cell on the last beam raises the
    threshold of the same cell on beam 0."""
    cube = torch.tensor(_beam_cube(64, 32))
    block = dataclasses.replace(QUICK, scale_mode="block", scale_block=2)
    a = TC.cfar_3d(cube, 0, QUICK, 1, 0)
    b = TC.cfar_3d(cube, 0, block, 1, 0)
    assert all(torch.equal(x, y) for x, y in zip(a[::2], b[::2]))
    c = torch.zeros((4, 16, 16))
    c[0, 5, 5] = 10.0
    det0 = TC.cfar_3d(c, 0, QUICK, 1, 0)[0]
    c[3, :, :] = 100.0
    det1 = TC.cfar_3d(c, 0, QUICK, 1, 0)[0]
    assert det0[0, 5, 5] == 10.0 and det1[0, 5, 5] == 0.0
    # The prepadded layout (a beam shard with one exchanged plane per side)
    # gives the whole cube's planes: the wrapped neighbour arrives as a halo.
    ext = c[[3, 0, 1, 2, 3, 0]]
    pre = TC.cfar_3d(ext, 0, QUICK, 1, 0, prepadded_angle=True)[0]
    assert torch.equal(pre, det1) and pre[0, 5, 5] == 0.0


def _sparse_stack(shape, seed, p=0.05):
    rng = np.random.default_rng(seed)
    return np.where(rng.random(shape) < p,
                    rng.integers(1, 6, shape).astype(np.float32), 0.0
                    ).astype(np.float32)


@pytest.mark.parametrize("radius", [1, 2])
def test_peak_group_beams_vs_jax_paths_and_kernel(radius):
    """(8, 64, 128) sparse stack with dense ties: the port's fast path and
    beam_ids path equal JAX's fast path, its beam_ids path and the TPU
    kernel in interpret mode, with the kernel's row maxima and count."""
    det = _sparse_stack((8, 64, 128), 41 + radius)
    want = np.asarray(JC.peak_group_beams(jnp.asarray(det), radius=radius))
    jgen = np.asarray(JC.peak_group_beams(jnp.asarray(det), radius=radius,
                                          beam_ids=jnp.arange(8)))
    jker, jrmax, jn = JCP.peak_group_beams_pallas(jnp.asarray(det),
                                                  radius=radius,
                                                  interpret=True)
    assert np.array_equal(want, jgen) and np.array_equal(want,
                                                         np.asarray(jker))
    t = torch.as_tensor(det)
    assert np.array_equal(TC.peak_group_beams(t, radius).numpy(), want)
    assert np.array_equal(TC.peak_group_beams(
        t, radius, beam_ids=torch.arange(8)).numpy(), want)
    g, rmax, n = BG.beam_group(t[None], radius)
    assert np.array_equal(g[0].numpy(), want)
    assert np.array_equal(rmax[0].numpy(), np.asarray(jrmax))
    assert int(n[0]) == int(jn)


def test_peak_group_beams_semantics_and_batch():
    """Same-cell collapse to the strongest beam, ties toward the lower
    beam, no wrap between the first and last beams; a batch of cubes is
    grouped cube by cube (no beam of one cube reaches the next)."""
    det = np.zeros((4, 3, 3), np.float32)
    det[0, 0, 0] = det[1, 0, 0] = 5
    det[2, 1, 1], det[3, 1, 1] = 6, 7
    det[0, 2, 2] = 4
    out = TC.peak_group_beams(torch.as_tensor(det), 1).numpy()
    assert out[0, 0, 0] == 5 and out[1, 0, 0] == 0
    assert out[3, 1, 1] == 7 and out[2, 1, 1] == 0 and out[0, 2, 2] == 4
    two = np.stack([det, det[::-1].copy()])
    g, rmax, n = BG.beam_group(torch.as_tensor(two), 1)
    for b in range(2):
        one = TC.peak_group_beams(torch.as_tensor(two[b]), 1)
        assert torch.equal(g[b], one)
        assert int(n[b]) == int((one > 0).sum())
    # Radius beyond the beam count: every neighbour is missing or compared.
    wide = TC.peak_group_beams(torch.as_tensor(det), 5).numpy()
    gen = np.asarray(JC.peak_group_beams(jnp.asarray(det), radius=3,
                                         beam_ids=jnp.arange(4)))
    assert np.array_equal(wide, gen)
