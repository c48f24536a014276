"""The stage-scaled fixed-point FFT (``fixed_fft="scaled"``, the QUICK-mode
XFFT variants' arithmetic) in the port, held against the JAX package.

* The port's golden ``scaled_fft`` and ``bit_reverse_permutation`` equal
  JAX's golden model, and the port's ``ops/fft.scaled_fft_apply`` equals
  both and JAX's XLA twin, bit for bit (tolerance 0), at n = 2 .. 1024 on
  full-scale inputs that wrap, with the schedules None (no scaling),
  [1]*m, a mixed one and zeros, in both output orders; and on JAX's
  ``tests/test_scaled_fft.py`` cases.
* The port's golden ``process_frame_fixed(fft="scaled")`` equals JAX's.
* ``make_processor(quick(), mode="fixed", fixed_fft="scaled")`` on the
  "auto" (staged) and "plain" routes equals JAX's ``frontend="xla"``
  scaled processor on every output (maps, detections, counts, the debug
  taps), and the golden model's maps: per-cell and block scale, the
  debug taps, a zeros schedule whose transforms wrap, reflect edges, and
  ``cfar_geometry="hw_stream"`` in one-shot batches and through
  ``process.stream``.  Tolerance 0 throughout.
* The refusals: float32, ``frontend="fused"`` and an unknown
  ``fixed_fft`` raise ValueError, as JAX's.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import fmcw_tpu
import fmcw_tpu_torch
from fmcw_tpu.golden import fixed_point as jfx, reference as jref
from fmcw_tpu.models import pipeline as jpl
from fmcw_tpu.ops import fft as JF
from fmcw_tpu_torch.golden import fixed_point as tfx, reference as tref
from fmcw_tpu_torch.models import pipeline as tpl
from fmcw_tpu_torch.ops import fft as TF

# Share the CPU with the other test workers (the suite runs 6 at once).
torch.set_num_threads(2)

Q, JQ = fmcw_tpu_torch.quick(), fmcw_tpu.quick()
ZEROS = ([0] * 7, [0] * 5)          # quick(): 128 range, 32 Doppler points


def _schedule(kind: str, m: int, seed: int):
    if kind == "none":
        return None
    if kind == "ones":
        return [1] * m
    if kind == "zeros":
        return [0] * m
    return [int(v) for v in np.random.default_rng(seed).integers(0, 3, m)]


KINDS = ("none", "ones", "mixed", "zeros")
ORDERS = ("natural", "bit_reversed")


def _rows(n: int):
    """Full-scale int16 rows (they wrap under small shifts), 3 of them."""
    rng = np.random.default_rng(n)
    return (rng.integers(-32768, 32768, (3, n)),
            rng.integers(-32768, 32768, (3, n)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [1 << k for k in range(1, 11)])
def test_scaled_fft_bit_equal_to_jax_golden(n, kind):
    """The port's golden model and twin equal JAX's golden model bit for
    bit, in both orders; the permutation equals JAX's."""
    i, q = _rows(n)
    sch = _schedule(kind, n.bit_length() - 1, n)
    assert np.array_equal(tfx.bit_reverse_permutation(n),
                          jfx.bit_reverse_permutation(n))
    for order in ORDERS:
        gi, gq = tfx.scaled_fft(i, q, scale_sch=sch, output_order=order)
        ji, jq = jfx.scaled_fft(i, q, scale_sch=sch, output_order=order)
        ti, tq = TF.scaled_fft_apply(torch.as_tensor(i), torch.as_tensor(q),
                                     -1, scale_sch=sch, output_order=order)
        assert ti.dtype == torch.int64
        for a, b in ((gi, ji), (gq, jq), (gi, ti.numpy()), (gq, tq.numpy())):
            assert np.array_equal(a, b), (n, kind, order)
        assert gi.min() >= -32768 and gi.max() <= 32767


@pytest.mark.parametrize("n", [2, 8, 32, 128, 1024])
def test_scaled_fft_apply_equals_jax_xla_twin(n):
    """The port's twin equals JAX's XLA twin (its int32 8-bit twiddle
    split) bit for bit: every schedule kind, both orders, one jitted JAX
    call a length."""
    i, q = _rows(n)
    cases = [(_schedule(k, n.bit_length() - 1, n), o)
             for k in KINDS for o in ORDERS]
    want = jax.jit(lambda a, b: [
        JF.scaled_fft_apply(a, b, axis=-1, scale_sch=sch, output_order=o)
        for sch, o in cases])(i, q)
    for (sch, o), (xi, xq) in zip(cases, want):
        ti, tq = TF.scaled_fft_apply(torch.as_tensor(i), torch.as_tensor(q),
                                     -1, scale_sch=sch, output_order=o)
        assert np.array_equal(ti.numpy(), np.asarray(xi)), (n, sch, o)
        assert np.array_equal(tq.numpy(), np.asarray(xq)), (n, sch, o)


def test_scaled_fft_along_another_axis():
    """``dim`` / ``axis`` picks the transform axis, as in JAX."""
    rng = np.random.default_rng(7)
    i = rng.integers(-32768, 32768, (16, 5))
    q = rng.integers(-32768, 32768, (16, 5))
    gi, gq = tfx.scaled_fft(i, q, axis=0, scale_sch=[1, 0, 2, 1])
    ji, jq = jfx.scaled_fft(i, q, axis=0, scale_sch=[1, 0, 2, 1])
    ti, tq = TF.scaled_fft_apply(torch.as_tensor(i), torch.as_tensor(q), 0,
                                 scale_sch=[1, 0, 2, 1])
    assert np.array_equal(gi, ji) and np.array_equal(gq, jq)
    assert np.array_equal(ti.numpy(), gi) and np.array_equal(tq.numpy(), gq)


def test_jax_closed_form_cases():
    """JAX's closed-form cases (no rounding): a DC vector halved each
    stage -> [c, 0, ...]; an impulse with the zero schedule -> A at every
    bin; the port's golden model and twin as JAX's."""
    n, m, c, a = 32, 5, 1234, 21111
    i = np.full(n, c, np.int64)
    want = np.zeros(n, np.int64)
    want[0] = c
    i2 = np.zeros(n, np.int64)
    i2[0] = a
    for x, sch, wi in ((i, [1] * m, want), (i2, [0] * m, np.full(n, a))):
        z = np.zeros(n, np.int64)
        gi, gq = tfx.scaled_fft(x, z, scale_sch=sch)
        ti, tq = TF.scaled_fft_apply(torch.as_tensor(x), torch.as_tensor(z),
                                     scale_sch=sch)
        ji, jq = jfx.scaled_fft(x, z, scale_sch=sch)
        for r, s in ((gi, gq), (ti.numpy(), tq.numpy()), (ji, jq)):
            assert np.array_equal(r, wi) and np.array_equal(s, z)


def test_jax_rounding_wrap_and_order_cases():
    """JAX's remaining cases: the 1/N schedule within 8 LSB of fft(x)/n;
    the zero schedule wraps (int16-ranged, not the true transform); the
    natural order is the bit-reversed one permuted.  Each bit-equal to
    JAX's golden model."""
    rng = np.random.default_rng(0)
    i, q = rng.integers(-20000, 20000, 128), rng.integers(-20000, 20000, 128)
    ir, qr = tfx.scaled_fft(i, q, scale_sch=[1] * 7)
    zf = np.fft.fft(i + 1j * q) / 128
    assert np.max(np.abs(ir - zf.real)) < 8
    assert np.max(np.abs(qr - zf.imag)) < 8
    assert all(np.array_equal(a, b) for a, b in
               zip((ir, qr), jfx.scaled_fft(i, q, scale_sch=[1] * 7)))
    rng = np.random.default_rng(1)
    i, q = rng.integers(-32000, 32000, 64), rng.integers(-32000, 32000, 64)
    ir, qr = tfx.scaled_fft(i, q)
    assert ir.min() >= -32768 and ir.max() <= 32767
    zf = np.fft.fft(i + 1j * q)
    assert np.max(np.abs(zf.real)) > 32767
    assert not np.allclose(ir, np.clip(zf.real, -32768, 32767), atol=4)
    assert all(np.array_equal(a, b) for a, b in
               zip((ir, qr), jfx.scaled_fft(i, q)))
    rng = np.random.default_rng(2)
    i, q = rng.integers(-1000, 1000, 16), rng.integers(-1000, 1000, 16)
    nat = TF.scaled_fft_apply(torch.as_tensor(i), torch.as_tensor(q),
                              scale_sch=[1] * 4)
    rev = TF.scaled_fft_apply(torch.as_tensor(i), torch.as_tensor(q),
                              scale_sch=[1] * 4, output_order="bit_reversed")
    perm = tfx.bit_reverse_permutation(16)
    assert np.array_equal(nat[0].numpy(), rev[0].numpy()[perm])
    assert np.array_equal(nat[1].numpy(), rev[1].numpy()[perm])
    assert np.array_equal(perm[perm], np.arange(16))


def test_scaled_fft_refusals():
    for fn in (lambda *a, **k: tfx.scaled_fft(*a, **k),
               lambda i, q, **k: TF.scaled_fft_apply(
                   torch.as_tensor(i), torch.as_tensor(q), **k)):
        with pytest.raises(ValueError):
            fn(np.zeros(12, np.int64), np.zeros(12, np.int64))
        with pytest.raises(ValueError):
            fn(np.zeros(8, np.int64), np.zeros(8, np.int64),
               scale_sch=[1, 1])
        with pytest.raises(ValueError):
            fn(np.zeros(8, np.int64), np.zeros(8, np.int64),
               output_order="reversed")


@pytest.mark.parametrize("sch", [None, ZEROS, ([1, 0, 2, 0, 1, 1, 0],
                                                [2, 1, 0, 1, 1])])
def test_golden_chain_equals_jax(sch):
    """The port's golden process_frame_fixed(fft="scaled") equals JAX's,
    with the default [1]*m schedules, zeros and a mixed pair."""
    for seed in (5, 6):
        z = tref.two_target_frame(Q, seed=seed)
        a = tref.process_frame_fixed(z, Q, fft="scaled", fft_scale_sch=sch)
        b = jref.process_frame_fixed(z, JQ, fft="scaled", fft_scale_sch=sch)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    # The BFP default is unchanged.
    a = tref.process_frame_fixed(z, Q)
    b = jref.process_frame_fixed(z, JQ)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


# Processor cases: (processor keywords, CfarParams fields).
CASES = {
    "cell": (dict(peak_group_radius=2), {}),
    "block": (dict(), dict(scale_mode="block")),
    "debug": (dict(include_debug=True, peak_group_radius=1), {}),
    "zeros": (dict(fixed_fft_scale_sch=ZEROS, peak_group_radius=2), {}),
    "hw_stream": (dict(cfar_geometry="hw_stream", peak_group_radius=2), {}),
    "reflect": (dict(peak_group_radius=2, fixed_fft_scale_sch=ZEROS),
                dict(edge_mode="reflect")),
}


def _frames(n: int = 3):
    rng = np.random.default_rng(3)
    f = np.stack([tpl.complex_to_iq(tref.two_target_frame(Q, seed=s))
                  for s in range(n)])
    return f + rng.integers(-8, 8, f.shape).astype(np.int16)


def _params(case):
    fields = CASES[case][1]
    return (Q.replace(cfar=dataclasses.replace(Q.cfar, **fields)),
            JQ.replace(cfar=dataclasses.replace(JQ.cfar, **fields)))


@functools.lru_cache(maxsize=None)
def _jax_processor(case):
    return jpl.make_processor(_params(case)[1], mode="fixed",
                              fixed_fft="scaled", frontend="xla",
                              **CASES[case][0])


def _numpy(out):
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("frontend", ["auto", "plain"])
@pytest.mark.parametrize("case", list(CASES))
def test_processor_bit_equal_to_jax_and_golden(case, frontend):
    """Every output of the port's scaled processor equals JAX's XLA scaled
    processor's, frame by frame; its maps equal the golden chain's (the
    named geometry: det_map the golden decision, grouped; the debug taps
    the golden threshold and scale)."""
    p, _ = _params(case)
    kw = CASES[case][0]
    proc = tpl.make_batch_processor(p, mode="fixed", fixed_fft="scaled",
                                    frontend=frontend, device="cpu", **kw)
    assert proc.route == ("staged" if frontend == "auto" else "plain")
    proc = tpl.make_processor(p, mode="fixed", fixed_fft="scaled",
                              frontend=frontend, device="cpu", **kw)
    sch = kw.get("fixed_fft_scale_sch")
    for iq in _frames():
        out = _numpy(proc(iq))
        want = _numpy(jax.tree.map(np.asarray, _jax_processor(case)(iq)))
        assert sorted(out) == sorted(want)
        for k in want:
            assert np.array_equal(out[k], want[k]), (case, k)
        z = iq[..., 0].astype(np.int64) + 1j * iq[..., 1].astype(np.int64)
        mag, det = tref.process_frame_fixed(z, p, fft="scaled",
                                            fft_scale_sch=sch)
        assert np.array_equal(out["mag_map"], mag)
        if case == "hw_stream":
            continue
        assert np.array_equal(out["det_map"], tfx.peak_group(
            det, kw.get("peak_group_radius", 0)))
        if case == "debug":
            _, thr, scale = tfx.os_cfar_2d(mag, p.cfar, return_debug=True)
            assert np.array_equal(out["threshold_map"], thr)
            assert np.array_equal(out["scale_map"], scale)
    if case == "zeros":
        # The unscaled transforms wrap, and the windows saturate after.
        assert out["saturation_count"] > 0


@pytest.mark.parametrize("frontend", ["auto", "plain"])
def test_hw_stream_batch_and_stream_equal_jax(frontend):
    """cfar_geometry="hw_stream": a batch of one-shot frames through
    make_batch_processor equals JAX's processor frame by frame, and
    process.stream over 3 CPIs equals JAX's stream, carries included."""
    p, _ = _params("hw_stream")
    kw = dict(mode="fixed", fixed_fft="scaled", cfar_geometry="hw_stream",
              peak_group_radius=2)
    frames = _frames()
    batch = _numpy(tpl.make_batch_processor(p, frontend=frontend,
                                            device="cpu", **kw)(frames))
    jp = _jax_processor("hw_stream")
    for b, iq in enumerate(frames):
        want = _numpy(jax.tree.map(np.asarray, jp(iq)))
        for k in want:
            assert np.array_equal(batch[k][b], want[k]), k
    proc = tpl.make_processor(p, frontend=frontend, device="cpu", **kw)
    hist = jhist = None
    for iq in frames:
        out, hist = proc.stream(iq, hist=hist)
        want, jhist = jp.stream(iq, hist=jhist)
        want = _numpy(jax.tree.map(np.asarray, want))
        for k in want:
            assert np.array_equal(out[k].numpy(), want[k]), k
        assert np.array_equal(hist.numpy(), np.asarray(jhist))


def test_processor_refusals_as_jax():
    """float32, the fused route and an unknown name raise ValueError, as
    JAX's make_processor; so does a schedule of the wrong length."""
    with pytest.raises(ValueError, match="mode='fixed'"):
        tpl.make_processor(Q, mode="float32", fixed_fft="scaled",
                           device="cpu")
    with pytest.raises(ValueError, match="fused"):
        tpl.make_processor(Q, mode="fixed", fixed_fft="scaled",
                           frontend="fused", device="cpu")
    with pytest.raises(ValueError, match="bfp"):
        tpl.make_processor(Q, mode="fixed", fixed_fft="nope", device="cpu")
    with pytest.raises(ValueError, match="shifts"):
        tpl.make_processor(Q, mode="fixed", fixed_fft="scaled",
                           fixed_fft_scale_sch=([1] * 6, [1] * 5),
                           device="cpu")
    with pytest.raises(ValueError, match="mode='fixed'"):
        jpl.make_processor(JQ, mode="float32", fixed_fft="scaled")
    with pytest.raises(ValueError, match="fused"):
        jpl.make_processor(JQ, mode="fixed", fixed_fft="scaled",
                           frontend="pallas")
