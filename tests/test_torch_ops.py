"""The port's stage ops (fmcw_tpu_torch.ops) against the JAX package.

Constants (window, DFT and slow-time matrices) must be bit-identical: both
sides build them in float64 with numpy and round once to float32.  The plain
transforms are float32 matrix products on both sides (JAX at HIGHEST) and
agree to 1e-5 of the output peak; the alpha-max-beta-min magnitude is the
same three float32 operations on both sides and agrees exactly.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import fmcw_tpu
import fmcw_tpu_torch
from fmcw_tpu.golden import fixed_point as jfx, reference as jref
from fmcw_tpu.ops import fft as JF, magnitude as JM, window as JW
from fmcw_tpu_torch.golden import fixed_point as tfx, reference as tref
from fmcw_tpu_torch.ops import fft as TF, frontend as TFE, magnitude as TM
from fmcw_tpu_torch.ops import window as TW

# Share the CPU with the other test workers (the suite runs 6 at once).
torch.set_num_threads(2)

TOL = 1e-5          # transforms: max abs error relative to the output peak


@pytest.mark.parametrize("preset", ["full", "quick", "fast"])
def test_params_copy_matches(preset):
    a = getattr(fmcw_tpu, preset)()
    b = getattr(fmcw_tpu_torch, preset)()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (a.cfar.n_ref, a.cfar.rank_idx, a.cfar.halo_range) == \
        (b.cfar.n_ref, b.cfar.rank_idx, b.cfar.halo_range)


@pytest.mark.parametrize("n", [32, 64, 128, 256, 1024])
def test_window_bitwise(n):
    assert np.array_equal(TW.hamming_q15(n), JW.hamming_q15(n))
    a, b = TW.hamming_float(n), JW.hamming_float(n)
    assert a.dtype == b.dtype == np.float32
    assert np.array_equal(a.view(np.int32), b.view(np.int32))
    assert np.array_equal(tfx.hamming_rom(n), jfx.hamming_rom(n))


@pytest.mark.parametrize("cfar", [fmcw_tpu_torch.CfarParams(),
                                  fmcw_tpu_torch.quick().cfar])
def test_window_offsets_copy(cfar):
    jc = fmcw_tpu.CfarParams(**dataclasses.asdict(cfar))
    assert tfx._window_offsets(cfar) == jfx._window_offsets(jc)


def test_two_target_frame_copy():
    for p in (fmcw_tpu_torch.full(), fmcw_tpu_torch.quick()):
        jp = fmcw_tpu.RadarParams(n_range=p.n_range, n_doppler=p.n_doppler)
        assert np.array_equal(tref.two_target_frame(p, seed=3),
                              jref.two_target_frame(jp, seed=3))


@pytest.mark.parametrize("n", [32, 128, 1024])
def test_dft_matrices_bitwise(n):
    for a, b in zip(TF.dft_matrices(n), JF.dft_matrices(n)):
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("n", [32, 64, 128])
@pytest.mark.parametrize("notch_mode", [2, 3])
@pytest.mark.parametrize("transient", ["zero", "passthrough"])
def test_doppler_matrices_bitwise(n, notch_mode, transient):
    got = TF.doppler_matrices(n, notch_mode, transient)
    want = JF.doppler_matrices(n, notch_mode, transient)
    assert len(got) == len(want) == 4          # MTI pair + bypass pair
    for a, b in zip(got, want):
        assert np.array_equal(a.view(np.int32), b.view(np.int32))


def _rel_err(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("nr,nd", [(1024, 128), (128, 32)])
def test_range_transform_matches_jax(nr, nd):
    """Plain twin of kernel A (window x dense DFT, range-major out) vs JAX's
    windowed dft_apply along the sample axis at HIGHEST precision."""
    rng = np.random.default_rng(nr)
    iq = rng.integers(-3000, 3000, (nd, nr, 2)).astype(np.int16)
    re, im = TFE.range_fft_plain(torch.as_tensor(iq[None]))
    jr, ji = JF.dft_apply(jnp.asarray(iq[..., 0], jnp.float32),
                          jnp.asarray(iq[..., 1], jnp.float32), axis=1,
                          window=True)
    want = np.concatenate([np.asarray(jr).T, np.asarray(ji).T])
    got = np.concatenate([re[0].numpy(), im[0].numpy()])
    assert _rel_err(got, want) < TOL


@pytest.mark.parametrize("bypass", [False, True])
@pytest.mark.parametrize("notch_mode,transient", [(2, "zero"),
                                                  (3, "passthrough")])
def test_slowtime_transform_matches_jax(bypass, notch_mode, transient):
    """Plain slow-time operator (range-major in, contraction over the chirp
    axis) vs JAX's doppler_apply on the chirp-major layout."""
    nr, nd = 256, 128
    rng = np.random.default_rng(7)
    xr = rng.normal(size=(nd, nr)).astype(np.float32) * 1e4
    xi = rng.normal(size=(nd, nr)).astype(np.float32) * 1e4
    yr, yi = TF.doppler_apply(torch.as_tensor(xr.T.copy()),
                              torch.as_tensor(xi.T.copy()), bypass,
                              notch_mode, transient)
    jr, ji = JF.doppler_apply(jnp.asarray(xr), jnp.asarray(xi), axis=0,
                              bypass=jnp.asarray(bypass),
                              notch_mode=notch_mode, transient=transient)
    got = np.concatenate([yr.numpy(), yi.numpy()])
    want = np.concatenate([np.asarray(jr), np.asarray(ji)])
    assert _rel_err(got, want) < TOL


@pytest.mark.parametrize("exact", [False, True])
def test_magnitude_matches_jax(exact):
    rng = np.random.default_rng(11)
    re = (rng.normal(size=(64, 128)) * 1e5).astype(np.float32)
    im = (rng.normal(size=(64, 128)) * 1e5).astype(np.float32)
    re[0, :4] = [0.0, -0.0, 3.0, -3.0]
    im[0, :4] = [0.0, 5.0, -3.0, 3.0]
    got = TM.magnitude_float(torch.as_tensor(re), torch.as_tensor(im),
                             exact=exact).numpy()
    want = np.asarray(JM.magnitude_float(jnp.asarray(re), jnp.asarray(im),
                                         exact=exact))
    if exact:
        # hypot: both libraries round to within one ulp of the true value.
        np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)
    else:
        assert np.array_equal(got, want)
