"""The CA/GO/SO variants of the port's fixed slow-time kernel (TPU rows 2
and 6, ``csrc/slowtime_detect_fixed.cu``'s integer window-mean epilogue)
against the JAX package and the golden model, on the CPU, through the
kernels' twins.

* The twin's decision on the int32 magnitudes of JAX's fused fixed kernel
  (``rdm_frontend_fixed``, interpret mode) equals the kernel's decisions,
  row maxima and detection count: CA / GO / SO per-cell at ``quick()``,
  a block case at 256x64 (``scale_block=2``) and a ``scale_override``
  case.  JAX divides its integer sums as ``floor(s / float32(n))``, which
  XLA:CPU may rewrite as a product with the rounded reciprocal; the twin
  equals the golden model's floor division in every case here.
* The fused fixed processor (``frontend="plain"``, the fused kernels'
  twins) against JAX's ``frontend="pallas"`` with
  ``tests/test_torch_fixed.py``'s exactness contract, and equal to
  ``golden.reference.process_frame_fixed`` bit for bit.
* The split twin at sp 2 and 4 equals the whole-frame twin's rows; a
  LocalMesh at sp 2 on the fixed fused route equals the single device.
* A window over 372 cells (JAX's float32-sum limit) passes the port's gate
  and equals the golden model.
* The plain integer decision holds under a large ``scale_override`` (the
  golden model's int64 product, where an int32 product wraps).
"""

import dataclasses

import numpy as np
import pytest
import jax
import torch

import fmcw_tpu
import fmcw_tpu_torch
from fmcw_tpu.models import pipeline as jpl
from fmcw_tpu.ops.frontend_pallas import rdm_frontend_fixed
from fmcw_tpu_torch.golden import fixed_point as tfx, reference as tref
from fmcw_tpu_torch.models import pipeline as tpl
from fmcw_tpu_torch.ops import cfar as TC, frontend as F
from fmcw_tpu_torch.ops import frontend_fixed as FX
from fmcw_tpu_torch.ops import split_frontend as SF
from fmcw_tpu_torch.parallel import LocalMesh, sharded

# Share the CPU with the other test workers (the suite runs 6 at once).
torch.set_num_threads(2)

MEAN_VARIANTS = ("ca", "go", "so")
LSB = 8          # magnitudes against JAX's float32 fused kernel
P256 = fmcw_tpu_torch.RadarParams(n_range=256, n_doppler=64)
# The window of tests/test_frontend_fixed.py's 2^24 case: 17x23 cells.
WIDE = dict(ref_range=6, guard_range=2, ref_doppler=9, guard_doppler=2)


def _variant(p, variant, **kw):
    return p.replace(cfar=dataclasses.replace(p.cfar, variant=variant, **kw))


def _jparams(p):
    return fmcw_tpu.RadarParams(
        n_range=p.n_range, n_doppler=p.n_doppler, notch_mode=p.notch_mode,
        cfar=fmcw_tpu.CfarParams(**dataclasses.asdict(p.cfar)),
        tracker=fmcw_tpu.TrackerParams(**dataclasses.asdict(p.tracker)))


def _noisy(p, seed):
    """The golden frame plus seeded +-8 noise (chip_smoke.make_batch)."""
    frame = tpl.complex_to_iq(tref.two_target_frame(p))
    return frame + np.random.default_rng(seed).integers(
        -8, 8, frame.shape).astype(np.int16)


def _det_set(det_map):
    return set(zip(*np.nonzero(np.asarray(det_map))))


def _golden_det(iq, p, pgr=0, **kw):
    """The golden fixed chain's det map of an int16 I/Q frame, grouped."""
    z = iq[..., 0].astype(np.int64) + 1j * iq[..., 1]
    _, det = tref.process_frame_fixed(z, p, **kw)
    return tfx.peak_group(det, pgr) if pgr else det


def _jax_kernel(iq, p, so, pgr):
    """JAX's fused fixed kernel in interpret mode: (det map, mag map, row
    maxima, n_dets) in natural (range, Doppler) order."""
    det_s, mag, _, rmax, n_dets = rdm_frontend_fixed(
        iq, False, so, notch_mode=p.notch_mode, interpret=True,
        cfar=_jparams(p).cfar, emit_mag=True, peak_group_radius=pgr)
    n2 = max(p.n_range // 128, 1)
    rows = min(p.n_range, 128)
    # Sliced row i of slice k2 is map row i n2 + k2.
    det = np.transpose(np.asarray(det_s).reshape(n2, rows, p.n_doppler),
                       (1, 0, 2)).reshape(p.n_range, p.n_doppler)
    rmax = np.asarray(rmax).reshape(n2, rows).T.reshape(-1)
    return (det.astype(np.int32), np.asarray(mag).astype(np.int32),
            rmax.astype(np.int32), int(n_dets))


@pytest.mark.parametrize("case", [
    ("ca", "cell", 0), ("go", "cell", 0), ("so", "cell", 0),
    ("go", "block", 0), ("ca", "cell", 3)],
    ids=["ca", "go", "so", "go-block-256x64", "ca-override"])
def test_twin_decides_as_jax_fixed_kernel(case):
    """On the magnitudes of JAX's fused fixed kernel, the twin's decision
    (the plain integer cfar_2d and grouping) gives the kernel's det map,
    row maxima and count, and equals the golden os_cfar_2d."""
    variant, mode, so = case
    pgr = 2
    if mode == "block":
        p = _variant(P256, variant, scale_mode="block", scale_block=2)
    else:
        p = _variant(fmcw_tpu_torch.quick(), variant)
    iq = _noisy(p, 5)
    det, mag, rmax, n_dets = _jax_kernel(iq, p, so, pgr)
    assert n_dets > 0
    d2, r2, n2, _ = F.detect_plain(torch.as_tensor(mag)[None], p.cfar, so,
                                   pgr)
    assert np.array_equal(d2[0].numpy(), det)
    assert np.array_equal(r2[0].numpy(), rmax)
    assert int(n2[0]) == n_dets
    want = tfx.peak_group(tfx.os_cfar_2d(mag, p.cfar, so), pgr)
    assert np.array_equal(d2[0].numpy(), want)


@pytest.mark.parametrize("variant", MEAN_VARIANTS)
def test_fused_fixed_twins_vs_jax_fused_kernel(variant):
    """The port's fused fixed route (frontend="plain": the two kernels'
    twins) against JAX's frontend="pallas" at quick(), under the runtime
    controls: exact detection set and count, magnitudes within LSB,
    exact saturation and top-K set; its det maps equal the golden model's
    bit for bit."""
    p = _variant(fmcw_tpu_torch.quick(), variant)
    pgr = 2
    jproc = jpl.make_processor(_jparams(p), mode="fixed", frontend="pallas",
                               include_maps=True, peak_group_radius=pgr)
    tproc = tpl.make_processor(p, mode="fixed", frontend="plain",
                               peak_group_radius=pgr, device="cpu")
    iq = tpl.complex_to_iq(tref.two_target_frame(p, seed=3))
    for ctl in ({}, dict(mti_bypass=True), dict(scale_override=3)):
        out = {k: v.numpy() for k, v in tproc(iq, **ctl).items()}
        ref = jax.tree.map(np.asarray, jproc(iq, **ctl))
        assert _det_set(out["det_map"]) == _det_set(ref["det_map"]), ctl
        assert int(out["n_dets"]) == int(ref["n_dets"]) > 0
        assert out["mag"].dtype == np.int32
        d = np.abs(out["mag_map"].astype(np.int64) - ref["mag_map"])
        assert d.max() <= LSB, d.max()
        assert int(out["saturation_count"]) == int(ref["saturation_count"])
        v = out["valid"]
        assert np.array_equal(v, ref["valid"])
        assert set(zip(out["range_bin"][v], out["doppler_bin"][v])) == \
            set(zip(ref["range_bin"][v], ref["doppler_bin"][v]))
        want = _golden_det(iq, p, pgr,
                           mti_bypass=ctl.get("mti_bypass", False),
                           scale_override=ctl.get("scale_override", 0))
        assert np.array_equal(out["det_map"], want), ctl


@pytest.mark.parametrize("variant", MEAN_VARIANTS)
def test_fused_fixed_route_equals_golden_256x64(variant):
    """The fused fixed batch route at 256x64 (a noisy batch with the
    saturating frame), per-cell and block scale (scale_block 8: the
    kernel's tile holds at most 256 blocks), equals the golden model
    frame by frame and the staged route bit for bit."""
    pgr = 2
    batch = np.stack([_noisy(P256, s) for s in range(2)]
                     + [tpl.complex_to_iq(np.clip(np.asarray(
                         tref.two_target_frame(P256, seed=7)) * 40,
                         -32768, 32767))])
    for mode in ("cell", "block"):
        p = _variant(P256, variant, scale_mode=mode)
        assert FX.fused_fixed_detect_supported(p, pgr)
        outs = [tpl.make_batch_processor(p, mode="fixed", frontend=fe,
                                         peak_group_radius=pgr,
                                         device="cpu")(batch)
                for fe in ("fused", "staged")]
        for key in outs[1]:
            assert torch.equal(outs[0][key], outs[1][key]), (mode, key)
        for f in range(len(batch)):
            assert np.array_equal(outs[0]["det_map"][f].numpy(),
                                  _golden_det(batch[f], p, pgr)), (mode, f)


@pytest.mark.parametrize("variant", MEAN_VARIANTS)
def test_split_twin_equals_whole_frame_twin(variant):
    """The fixed split twin at sp 2 and 4, fed its neighbours' halo rows,
    gives the whole-frame twin's det, magnitudes and row maxima on its
    rows, and their counts sum to the whole frame's."""
    p = _variant(P256, variant)
    pgr = 2
    batch = torch.as_tensor(np.stack([_noisy(p, s) for s in range(2)]))
    re, im, _ = FX.range_fft_fixed(batch)
    kw = dict(cfar=p.cfar, peak_group_radius=pgr, emit_mag=True)
    det, mag, rmax, n_dets, sat = FX.slowtime_detect_fixed(re, im, **kw)
    nr, h = p.n_range, p.cfar.halo_range + pgr
    for sp in (2, 4):
        nrl = nr // sp
        total_d = total_s = 0
        for s in range(sp):
            rows = slice(s * nrl, (s + 1) * nrl)
            ext = torch.arange(s * nrl - h, (s + 1) * nrl + h) % nr
            lo, hi = ext[:h], ext[h + nrl:]
            d, m, r, n, st = SF.slowtime_detect_fixed_split(
                re[:, rows], im[:, rows], (re[:, lo], im[:, lo]),
                (re[:, hi], im[:, hi]), False, 0, s * nrl,
                n_range_total=nr, **kw)
            assert torch.equal(d, det[:, rows]), (sp, s)
            assert torch.equal(m, mag[:, rows]) and torch.equal(
                r, rmax[:, rows])
            total_d = total_d + n
            total_s = total_s + st
        assert torch.equal(total_d, n_dets) and torch.equal(total_s, sat)
        assert int(n_dets.min()) > 0


@pytest.mark.parametrize("variant", MEAN_VARIANTS)
def test_local_mesh_fixed_fused_equals_single_device(variant):
    """make_sharded_processor on a LocalMesh at sp 2, fixed "fused" with the
    per-cell scale (the fixed split entry's twin), equals the single
    device bit for bit; the gate admits it at sp 2 and 4."""
    p = _variant(P256, variant)
    pgr = 2
    assert sharded.split_detect_supported(p, 2, pgr)
    assert sharded.split_detect_supported(p, 4, pgr)
    iq = np.stack([_noisy(p, s) for s in range(2)])
    kw = dict(mode="fixed", frontend="fused", peak_group_radius=pgr,
              include_maps=True)
    a = sharded.make_sharded_processor(LocalMesh(1, 2, "cpu"), p, **kw)(iq)
    b = tpl.make_batch_processor(p, device="cpu", **kw)(iq)
    for k in b:
        assert torch.equal(a[k], b[k]), k
    assert int(a["n_dets"].min()) > 0


def test_wide_window_passes_port_gate_and_equals_golden():
    """A 17x23 CA window (391 cells, over JAX's 372-cell float32-sum limit):
    the port's fused fixed gate takes it (int32 sums), JAX's refuses it;
    the fused route equals the golden model at 256x64."""
    cfar = fmcw_tpu_torch.CfarParams(variant="ca", **WIDE)
    p = fmcw_tpu_torch.RadarParams(cfar=cfar)
    assert cfar.win_range * cfar.win_doppler > 372
    assert FX.fused_fixed_detect_supported(p)
    assert not jpl.fused_fixed_detect_supported(_jparams(p))
    p = P256.replace(cfar=cfar)
    iq = _noisy(p, 9)
    out = tpl.make_processor(p, mode="fixed", frontend="fused",
                             device="cpu")(iq)
    want = _golden_det(iq, p)
    assert np.array_equal(out["det_map"].numpy(), want)
    assert int(out["n_dets"]) == int((want > 0).sum()) > 0


@pytest.mark.parametrize("variant", MEAN_VARIANTS)
def test_plain_integer_decision_under_large_override(variant):
    """The plain integer cfar_2d of CA/GO/SO equals the golden os_cfar_2d
    (an int64 product) under overrides where est * scale passes 2^31; an
    int32 product wraps there and passes cells the golden model refuses."""
    rng = np.random.default_rng(4)
    m = rng.integers(0, 2000, (64, 32)).astype(np.int32)
    m[10:12, 5] = 45056                         # the fixed chain's largest
    m[40, 20] = 40000
    cfar = fmcw_tpu_torch.CfarParams(variant=variant)
    for so in (0, 6, 1 << 20, 100000, (1 << 31) - 1):
        det, thr, _ = TC.cfar_2d(torch.as_tensor(m), so, cfar,
                                 need_debug=True)
        want = tfx.os_cfar_2d(m, cfar, so)
        assert np.array_equal(det.numpy(), want), so
        assert det.dtype == thr.dtype == torch.int32
    assert (tfx.os_cfar_2d(m, cfar, 0) > 0).sum() > 0


def test_integer_floor_means_where_xla_cpu_rounds_low():
    """The integer means' floor division: the port (the twins' ``_div``, and
    the kernel's int floor_div) and the golden model divide exactly, where
    JAX's fused fixed kernels take ``floor(s / float32(n))`` (its
    ``fdiv``), which XLA:CPU computes with the rounded reciprocal of n: for
    n = 55 (a GO/SO half of a 5-row, 11-column training half) or 110 (a CA
    window) exact multiples of n floor one below.  A reference-side fault
    (ROADMAP.md §3, fault 5); no decision of the stimuli above reaches it."""
    for n in (55, 110):
        k = np.arange(0, (1 << 24) // n, dtype=np.int64)
        s = k * n
        port = TC._div(torch.as_tensor(s, dtype=torch.int32), n).numpy()
        assert np.array_equal(port, k) and np.array_equal(s // n, k)
        fdiv = jax.jit(lambda x: jax.numpy.floor(x / np.float32(n)))
        low = np.asarray(fdiv(s.astype(np.float32))) < k
        assert low.any(), n
