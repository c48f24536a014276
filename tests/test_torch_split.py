"""The split front-end and the sharded processor's pieces against the JAX
package and the port's own single-device path, on the CPU, in one process.

* ``split_frontend_frame`` (the split entries composed with a self-halo)
  against JAX's ``split_frontend_frame`` (Pallas interpret mode) at 256x64:
  float by the margin gate (fmcw_tpu_torch/parity.py: M, T, S from JAX's
  XLA chain, tol = 1e-5 * max(M)), fixed by an equal detection set; and
  against the port's whole-frame fused route, bit for bit.
* ``make_sharded_processor`` on a ``LocalMesh`` (the sp shards of each frame
  run one after another, the all-to-all and the halo exchange done by
  slicing, so every kernel entry sees exactly a mesh's inputs) equal to the
  port's single-device processor bit for bit, for sp 2 and 4 and every
  route.
* ``peak_group(row_ids=...)`` and ``cfar_2d(prepadded_range=True)`` on range
  shards bit-equal to JAX's, including a grouping tie across the wrap seam;
  ``block_scale_map_sharded`` equal to ``block_scale_map``.
* The fixed split path with a saturating tone on the top range bin, the
  seam of the shards' ring (after tests/test_split_frontend.py:98-118):
  the halo rows' Doppler-window saturations are counted once.

On the CPU every kernel wrapper takes its plain twin.
"""

import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import fmcw_tpu
import fmcw_tpu_torch
from fmcw_tpu.models import pipeline as jpl
from fmcw_tpu.ops import cfar as JC, cfar_pallas as JCP
from fmcw_tpu.ops import split_frontend as JSF
from fmcw_tpu_torch import parity
from fmcw_tpu_torch.golden import reference as tref
from fmcw_tpu_torch.models import pipeline as tpl
from fmcw_tpu_torch.ops import cfar as TC, frontend as TF
from fmcw_tpu_torch.ops import frontend_fixed as TFX, split_frontend as TSF
from fmcw_tpu_torch.parallel import mesh as TM, sharded as TSH

# Share the CPU with the other test workers (the suite runs 6 at once).
torch.set_num_threads(2)

P256 = fmcw_tpu_torch.RadarParams(n_range=256, n_doppler=64)
BLOCK = P256.replace(cfar=fmcw_tpu_torch.CfarParams(scale_mode="block"))
PGR = 2


def _jparams(p):
    return fmcw_tpu.RadarParams(
        n_range=p.n_range, n_doppler=p.n_doppler, notch_mode=p.notch_mode,
        cfar=fmcw_tpu.CfarParams(**dataclasses.asdict(p.cfar)),
        tracker=fmcw_tpu.TrackerParams(**dataclasses.asdict(p.tracker)))


def _jcfar(cfar):
    return fmcw_tpu.CfarParams(**dataclasses.asdict(cfar))


@functools.lru_cache(maxsize=2)
def _batch(p, n=4):
    rng = np.random.default_rng(11)
    frames = np.stack([tpl.complex_to_iq(tref.two_target_frame(p, seed=s))
                       for s in range(n)])
    out = frames + rng.integers(-8, 8, frames.shape).astype(np.int16)
    out.setflags(write=False)
    return out


def _seam_frame(p):
    """A near-full-scale tone on the top range bin (the wrap seam of the
    shards' ring, so inside shard 0's lower halo) with a Doppler ramp the
    MTI notch passes: the Doppler window saturates in those rows."""
    nr, nd = p.n_range, p.n_doppler
    n = np.arange(nr)[None, :]
    c = np.arange(nd)[:, None]
    z = 32000.0 * np.exp(2j * np.pi * ((nr - 1) * n / nr + 0.23 * c))
    return tpl.complex_to_iq(z.astype(np.complex64))


def _dein_jax(det_s, p):
    """JAX's split kernel B det planes (n2l, 128, nd) -> the (nr, nd) map
    (tests/test_split_frontend.py:48-55, n_doppler <= 128)."""
    return np.asarray(det_s).reshape(p.n_range, p.n_doppler)


# ---------------------------------------------------------------------------
# split_frontend_frame against JAX's and the port's whole-frame route
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=2)
def _jax_split(fixed):
    iq = tpl.complex_to_iq(tref.two_target_frame(P256))
    jp = _jparams(P256)
    out = JSF.split_frontend_frame(iq, cfar=jp.cfar, fixed=fixed,
                                   peak_group_radius=PGR,
                                   notch_mode=jp.notch_mode, interpret=True,
                                   emit_mag=True)
    return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("fixed", [False, True], ids=["float", "fixed"])
def test_split_frontend_frame_vs_jax_split(fixed):
    iq = tpl.complex_to_iq(tref.two_target_frame(P256))
    det, mag, stat, _, n_dets = TSF.split_frontend_frame(
        torch.as_tensor(iq[None]), cfar=P256.cfar, fixed=fixed,
        peak_group_radius=PGR, emit_mag=True)
    jdet_s, jmag, jstat, _, jn = _jax_split(fixed)
    jdet = _dein_jax(jdet_s, P256)
    got = parity.map_set(det[0].numpy())
    want = parity.map_set(jdet)
    if fixed:
        ok, report = parity.fixed_gate(got, want)
        assert int(stat[0]) == int(jstat)
    else:
        ref = jax.tree.map(np.asarray, jpl.make_processor(
            _jparams(P256), frontend="xla", include_debug=True,
            peak_group_radius=PGR)(iq))
        ok, report = parity.margin_gate(
            got, want, ref["mag_map"], ref["threshold_map"],
            ref["scale_map"], radius=PGR,
            targets=tref.golden_targets(P256))
        # The magnitudes within 1e-5 of the peak of JAX's XLA chain (its
        # bf16x3 kernel itself sits ~1e-5 from that chain).
        mref = ref["mag_map"]
        assert np.max(np.abs(mag[0].numpy() - mref)) <= 1e-5 * mref.max()
        assert int(stat[0]) == int(jstat) == 0
    assert ok, report
    assert len(got) > 0 and int(n_dets[0]) == len(got)


@pytest.mark.parametrize("fixed", [False, True], ids=["float", "fixed"])
def test_split_frontend_frame_equals_whole_frame_route(fixed):
    iq = torch.as_tensor(_batch(P256))
    kw = dict(cfar=P256.cfar, peak_group_radius=PGR, emit_mag=True)
    split = TSF.split_frontend_frame(iq, 1, 4, fixed=fixed, **kw)
    if fixed:
        whole = TFX.rdm_frontend_fixed_detect(iq, True, 4, **kw)
    else:
        whole = TF.rdm_frontend_detect(iq, True, 4, **kw)
    for a, b in zip(split, whole):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The sharded processor on a LocalMesh against the single device
# ---------------------------------------------------------------------------

ROUTES = [
    ("cell", "float32", "fused"), ("cell", "float32", "staged"),
    ("cell", "float32", "plain"), ("cell", "fixed", "fused"),
    ("cell", "fixed", "auto"), ("cell", "fixed", "plain"),
    ("block", "float32", "fused"), ("block", "float32", "plain"),
    ("block", "fixed", "auto"),
]


@functools.lru_cache(maxsize=4)
def _jax_scale_tap_dtype(p, mode):
    """The dtype of JAX's scale_map debug tap (traced, not run)."""
    fn = jpl.make_batch_processor(_jparams(p), mode=mode, frontend="xla",
                                  include_debug=True)
    shape = jax.ShapeDtypeStruct((1, p.n_doppler, p.n_range, 2), np.int16)
    return np.dtype(jax.eval_shape(fn, shape)["scale_map"].dtype)


@pytest.mark.parametrize("dp,sp", [(1, 2), (1, 4)])
@pytest.mark.parametrize("scale,mode,frontend", ROUTES)
def test_local_mesh_equals_single_device(scale, mode, frontend, dp, sp):
    p = P256 if scale == "cell" else BLOCK
    kw = dict(mode=mode, frontend=frontend, peak_group_radius=PGR,
              include_maps=True, include_debug=frontend == "plain")
    batch = _batch(P256)
    for bypass, so in ((False, 0), (True, 3)):
        ref = tpl.make_batch_processor(p, device="cpu", **kw)(batch, bypass,
                                                              so)
        proc = TSH.make_sharded_processor(TM.LocalMesh(dp, sp, "cpu"), p,
                                          **kw)
        out = proc(batch, bypass, so)
        assert out.keys() == ref.keys()
        for key in ref:
            assert torch.equal(out[key], ref[key]), key
        assert int(ref["n_dets"].min()) > 0
        if kw["include_debug"]:
            # The scale tap in JAX's type, the magnitude map's.
            assert out["scale_map"].dtype == out["mag_map"].dtype
            assert out["scale_map"].numpy().dtype == _jax_scale_tap_dtype(
                p, mode)


@pytest.mark.parametrize("sp", [2, 4])
def test_local_mesh_fixed_seam_saturations_counted_once(sp):
    """The seam tone saturates the Doppler window in rows that are another
    shard's halo: counted once, the whole-frame count, on both fixed
    routes."""
    iq = np.stack([_seam_frame(P256), _batch(P256)[0]])
    for frontend in ("fused", "auto"):
        kw = dict(mode="fixed", frontend=frontend, peak_group_radius=PGR,
                  include_maps=True)
        ref = tpl.make_batch_processor(P256, device="cpu", **kw)(iq)
        out = TSH.make_sharded_processor(TM.LocalMesh(1, sp, "cpu"), P256,
                                         **kw)(iq)
        assert int(ref["saturation_count"][0]) > 0
        for key in ref:
            assert torch.equal(out[key], ref[key]), key


@pytest.mark.parametrize("sp", [2, 4])
def test_split_fixed_seam_halo_not_counted(sp):
    """Each shard's fixed kernel-B entry alone: the shards' saturation
    counts add up to the whole frame's, although their halo rows saturate
    too (counting those would double-count the seam)."""
    iq = torch.as_tensor(_seam_frame(P256)[None])
    re, im, _ = TSF.range_frontend_fixed(iq)
    _, sat_whole = TFX.slowtime_mag_fixed_plain(re, im)
    nr = P256.n_range
    nrl, h = nr // sp, P256.cfar.halo_range + PGR
    sats = halo_sats = 0
    for s in range(sp):
        ext = torch.arange(s * nrl - h, (s + 1) * nrl + h) % nr
        lo, core, hi = ext[:h], ext[h:h + nrl], ext[h + nrl:]
        out = TSF.slowtime_detect_fixed_split(
            re[:, core], im[:, core], (re[:, lo], im[:, lo]),
            (re[:, hi], im[:, hi]), False, 0, s * nrl, cfar=P256.cfar,
            n_range_total=nr, peak_group_radius=PGR)
        sats += int(out[4][0])
        halo = torch.cat([lo, hi])
        halo_sats += int(TFX.slowtime_mag_fixed_plain(re[:, halo],
                                                      im[:, halo])[1][0])
    assert halo_sats > 0
    assert sats == int(sat_whole[0]) > 0


# ---------------------------------------------------------------------------
# The CFAR pieces on range shards against JAX
# ---------------------------------------------------------------------------

def _shard_with_halo(m, s, sp, h):
    """Rows s*nrl - h .. (s+1)*nrl + h (wrapped) of map m."""
    nr = m.shape[0]
    nrl = nr // sp
    return m[np.arange(s * nrl - h, (s + 1) * nrl + h) % nr]


def _map(seed, shape=(256, 64), integer=False):
    rng = np.random.default_rng(seed)
    m = rng.exponential(100.0, shape)
    q = rng.random(shape) < 0.3
    m[q] = np.round(m[q] / 25.0) * 25.0 + 25.0       # many equal values
    m[rng.random(shape) < 0.01] *= 40.0              # targets
    return m.astype(np.int32) if integer else m.astype(np.float32)


def _clutter(seed, integer):
    """_map with a heavy-tailed clutter patch and a sparse one in two range
    quarters (tests/test_torch_cfar.py's _clutter_map), so that every block
    scale class occurs."""
    rng = np.random.default_rng(seed)
    m = _map(seed).astype(np.float64)
    hot = rng.random((64, 64)) < 0.3
    m[64:128] = np.where(hot, 10.0, 1.0) * rng.uniform(90, 110, (64, 64))
    sparse = rng.random((64, 64)) < 0.1
    m[128:192] = np.where(sparse, 100.0, 1.0) * rng.uniform(9, 11, (64, 64))
    return m.astype(np.int32) if integer else m.astype(np.float32)


@pytest.mark.parametrize("radius", [1, 2])
def test_peak_group_row_ids_vs_jax_across_the_seam(radius):
    """A tie straddling the global wrap seam (rows nr-1 and 0) on the shard
    that holds row 0: global row ids keep the single map's choice."""
    rng = np.random.default_rng(radius)
    nr, nd, sp = 128, 32, 4
    det = np.where(rng.random((nr, nd)) < 0.25,
                   rng.integers(1, 4, (nr, nd)), 0).astype(np.float32)
    det[nr - 1, 5] = det[0, 5] = 9.0                  # the seam tie
    whole = TC.peak_group(torch.as_tensor(det), radius).numpy()
    assert whole[nr - 1, 5] == 0 and whole[0, 5] == 9.0
    nrl = nr // sp
    for s in range(sp):
        ext = _shard_with_halo(det, s, sp, radius)
        ids = (s * nrl + np.arange(-radius, nrl + radius)) % nr
        got = TC.peak_group(torch.as_tensor(ext), radius,
                            row_ids=torch.as_tensor(ids)).numpy()
        want = np.asarray(JC.peak_group(jnp.asarray(ext), radius=radius,
                                        row_ids=jnp.asarray(ids)))
        assert np.array_equal(got, want)
        core = got[radius:radius + nrl]
        assert np.array_equal(core, whole[s * nrl:(s + 1) * nrl])


@pytest.mark.parametrize("integer", [False, True], ids=["float", "int"])
@pytest.mark.parametrize("so", [0, 4])
def test_cfar_2d_prepadded_cell_vs_jax(integer, so):
    """Per-cell scale on a prepadded shard: int maps bit-equal to JAX's XLA
    cfar_2d(prepadded_range=True); float maps to its counting kernel
    (cfar_2d_pallas_detect, interpret mode), whose box-sum mean the port
    shares; both equal the whole map's rows."""
    cfar = P256.cfar
    m = _map(3, integer=integer)
    whole, _, _ = TC.cfar_2d(torch.as_tensor(m), so, cfar)
    sp = 4
    nrl = m.shape[0] // sp
    for s in (0, sp - 1):
        ext = _shard_with_halo(m, s, sp, cfar.halo_range)
        det, _, scale = TC.cfar_2d(torch.as_tensor(ext), so, cfar,
                                   prepadded_range=True)
        if integer:
            jdet, _, jscale = JC.cfar_2d(jnp.asarray(ext), so,
                                         cfar=_jcfar(cfar), integer=True,
                                         prepadded_range=True)
        else:
            jdet, jscale = JCP.cfar_2d_pallas_detect(
                jnp.asarray(ext), so, cfar=_jcfar(cfar),
                prepadded_range=True, interpret=True)
        assert np.array_equal(det.numpy().view(np.int32),
                              np.asarray(jdet).view(np.int32))
        assert np.array_equal(scale.numpy(),
                              np.asarray(jscale).astype(np.int32))
        assert torch.equal(det, whole[s * nrl:(s + 1) * nrl])
        assert (det.numpy() > 0).sum() > 0


@pytest.mark.parametrize("integer", [False, True], ids=["float", "int"])
@pytest.mark.parametrize("sp", [2, 4])
def test_block_scale_sharded_and_prepadded_block_vs_jax(integer, sp):
    """block_scale_map_sharded on the shards equals block_scale_map on the
    whole map; cfar_2d(prepadded_range=True, scale_map=...) then equals
    JAX's XLA cfar_2d on the same prepadded shard and scale map."""
    cfar = BLOCK.cfar
    m = _clutter(5, integer)
    nrl = m.shape[0] // sp
    shards = [torch.as_tensor(m[s * nrl:(s + 1) * nrl]) for s in range(sp)]
    scales = TC.block_scale_map_sharded(shards, cfar,
                                        TSH.LocalRing(sp).halo)
    whole = TC.block_scale_map(torch.as_tensor(m), cfar)
    assert torch.equal(torch.cat(scales), whole)
    assert set(np.unique(whole.numpy())) >= {cfar.scale_min, cfar.scale_max}
    for s in range(sp):
        ext = _shard_with_halo(m, s, sp, cfar.halo_range)
        det, _, scale = TC.cfar_2d(torch.as_tensor(ext), 0, cfar,
                                   scale_map=scales[s], prepadded_range=True)
        jdet, _, jscale = JC.cfar_2d(jnp.asarray(ext), 0, cfar=_jcfar(cfar),
                                     integer=integer, prepadded_range=True,
                                     scale_map=jnp.asarray(scales[s].numpy()))
        assert np.array_equal(det.numpy().view(np.int32),
                              np.asarray(jdet).view(np.int32))
        assert np.array_equal(scale.numpy(), np.asarray(jscale))


def test_prepadded_block_needs_a_scale_map():
    ext = torch.zeros((2, 64 + 2 * BLOCK.cfar.halo_range, 64))
    with pytest.raises(ValueError, match="scale_map"):
        TC.cfar_2d(ext, 0, BLOCK.cfar, prepadded_range=True)


def test_split_entries_reject_bad_inputs():
    re = torch.zeros((1, 64, 64))
    h = P256.cfar.halo_range + PGR
    halo = (torch.zeros((1, h, 64)), torch.zeros((1, h, 64)))
    kw = dict(cfar=P256.cfar, n_range_total=256, peak_group_radius=PGR)
    with pytest.raises(ValueError, match="halo"):
        TSF.slowtime_detect_split(re, re, halo, halo[:1], **kw)
    with pytest.raises(ValueError, match="frame"):
        TSF.slowtime_detect_split(re, re, halo, halo, False, 0, 224, **kw)
    with pytest.raises(NotImplementedError):
        TSF.slowtime_detect_fixed_split(re.short(), re.short(), detect=False,
                                        **kw)
    mag, nf = TSF.slowtime_detect_split(re, re, detect=False)
    assert tuple(mag.shape) == (1, 64, 64) and int(nf[0]) == 0
