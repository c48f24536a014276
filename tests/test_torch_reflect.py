"""Reflect edges (``CfarParams.edge_mode="reflect"``) on the port's 2D frame
path, against the JAX package and the golden model, on the CPU.

* The plain ``cfar_2d`` against JAX's XLA ``cfar_2d``: int32 and float32,
  OS / CA / GO / SO, per-cell and block scale, whole maps and prepadded
  range shards, and random shapes down to ``halo_doppler = D - 1`` and
  ``halo_range = R - 1``.  Integer results (det, threshold, scale) equal;
  float32 OS decisions equal (JAX's per-cell mean sums the rank stack, the
  port's the box sums, so a scale may differ only at an exact class
  boundary; the block scale equals); CA / GO / SO decisions and scales
  equal, thresholds within 2 ulp, the tolerance that
  ``tests/test_torch_cfar_variants.py`` states (XLA:CPU divides by a
  constant count through its rounded reciprocal).  Integer maps also equal
  the golden ``os_cfar_2d``, and the port's golden model JAX's.
* ``block_scale_map`` (it clips at the edges) and ``block_scale_map_sharded``
  (sp 2 and 4 on a ``LocalRing``) equal JAX's ``block_scale_map`` with
  reflect, float32 too.
* The standalone kernel's twins (``cfar_detect_plain``,
  ``cfar_detect_group_plain``) against JAX's ``cfar_2d_pallas_detect`` in
  interpret mode at 256x64 (the map padded with ``cfar.edge_mode``, TPU
  rows 7 and 8), then JAX's ``peak_group``; bit for bit.
* A numpy model of the kernel's reflect entry (``csrc/cfar_detect.cu``):
  the tile's rows mirrored at the map's first and last rows, a prepadded
  shard's rows straight, each row carrying its mirrored column halo (pitch
  D + 2 hd), then the whole-map entry's counting plan on halo-carrying rows
  (``tests/test_torch_cfar_detect_plan.py``'s ``_decide``), against
  ``np.pad(mode="reflect")`` and the twin bit for bit; the wrapped tile
  (the mutation) disagrees.
* The processors: float ``auto`` (kernel A, the magnitude-only entry, the
  reflect entry, the plain grouping) within the margin gate of JAX's XLA
  chain; fixed ``auto`` equal to the golden model bit for bit, with JAX's
  detection positions and counts; the sharded processor on a LocalMesh (sp
  2 and 4) and on gloo ranks (sp 4, ``DistRing``) equal to one device;
  ``ValueError`` where ``halo_range + 1 > n_range / sp``; the surveillance
  runtime and ``pd_pfa``.
* Refusals: fixed ``fused`` (ValueError, as JAX's), the array model's
  "fused" at ref_angle 0 (ValueError, as JAX's "pallas"), the sharded
  array model's beam halo beyond ``n_beams / sp - 1`` (ValueError); the
  kernels that wrap in JAX too (kernel B's detect and split entries, the
  fixed slow-time kernel, the standalone and rank-select kernels' grouping
  entries) raise NotImplementedError; the rank-select and 3D CFARs, the
  OS debug taps and the array model run reflect (tests/
  test_torch_reflect_taps_array.py holds them against JAX); no reflect
  route reaches kernel B's detect entry; ``cfar_geometry="hw_stream"``
  ignores the edge mode.
"""

import dataclasses
import time

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.multiprocessing as mp

import fmcw_tpu
import fmcw_tpu_torch
from fmcw_tpu.golden import fixed_point as jfx, reference as jref
from fmcw_tpu.models import pipeline as jpl
from fmcw_tpu.ops import cfar as JC, cfar_pallas as JCP
from fmcw_tpu_torch import parity
from fmcw_tpu_torch.golden import fixed_point as tfx, reference as tref
from fmcw_tpu_torch.golden.reference import rank_adversarial_maps
from fmcw_tpu_torch.models import pipeline as tpl, scenario
from fmcw_tpu_torch.ops import cfar as TC, cfar_detect as CD
from fmcw_tpu_torch.ops import cfar3d_detect as C3, cfar_rank as CR
from fmcw_tpu_torch.ops import frontend as F, frontend_fixed as FX
from fmcw_tpu_torch.ops import split_frontend as SF
from fmcw_tpu_torch.parallel import LocalMesh, sharded
from fmcw_tpu_torch.runtime import surveillance
from fmcw_tpu_torch.utils import eval as ev
from test_torch_cfar_detect_plan import _bits, _colsums, _decide, _noise
import torch_reflect_ranks

# Share the CPU with the other test workers (the suite runs 6 at once).
torch.set_num_threads(2)

MEAN_VARIANTS = ("ca", "go", "so")
SMALL = fmcw_tpu_torch.CfarParams(ref_range=2, ref_doppler=2, guard_range=1,
                                  guard_doppler=1)
QUICK = fmcw_tpu_torch.quick()
P256 = fmcw_tpu_torch.RadarParams(n_range=256, n_doppler=64)


def _reflect(cfar, **kw):
    return dataclasses.replace(cfar, edge_mode="reflect", **kw)


def _rp(p, **kw):
    return p.replace(cfar=_reflect(p.cfar, **kw))


def _jcfar(cfar):
    return fmcw_tpu.CfarParams(**dataclasses.asdict(cfar))


def _jparams(p):
    return fmcw_tpu.RadarParams(
        n_range=p.n_range, n_doppler=p.n_doppler, notch_mode=p.notch_mode,
        cfar=_jcfar(p.cfar),
        tracker=fmcw_tpu.TrackerParams(**dataclasses.asdict(p.tracker)))


def _edge_map(shape, seed, integer):
    """Exponential noise with a clutter band, plateaus of equal values and
    targets in the first and last rows and columns, where the mirror and
    the wrap differ."""
    rng = np.random.default_rng(seed)
    m = rng.exponential(100.0, shape)
    r, d = shape[-2:]
    m[..., r // 4:r // 2, :] *= np.where(
        rng.random(m[..., r // 4:r // 2, :].shape) < 0.3, 12.0, 1.0)
    q = rng.random(shape) < 0.2
    m[q] = np.round(m[q] / 25.0) * 25.0
    for i, j in ((0, 0), (1, d - 1), (r - 1, 2), (r - 2, d - 2), (0, d // 2),
                 (r // 2, 0)):
        m[..., i, j] = 6000.0
    m[..., min(2, r - 1), min(1, d - 1)] = 2500.0
    m[..., max(r - 3, 0), d - 1] = 2500.0
    return m.astype(np.int32 if integer else np.float32)


def _edge_frame(p, seed=1):
    """The golden two-target frame with two more targets on the first and
    last range bins but one, whose windows reach across the map's edges."""
    return tref.two_target_frame(p, seed=seed, targets=tref.golden_targets(p)
                                 + [(1, 3.0, 6000.0),
                                    (p.n_range - 2, -5.0, 6000.0)])


def _ulps(a, b):
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32))


def _shard(m, lo, hi, hr):
    """Rows lo .. hi of ``m`` with hr halo rows on each side, mirrored at the
    map's edges (the sharded processor's exchanged halo)."""
    p = np.pad(m, ((hr, hr), (0, 0)), mode="reflect")
    return p[lo:hi + 2 * hr]


# ---------------------------------------------------------------------------
# The plain CFAR and block scale
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ("os",) + MEAN_VARIANTS)
@pytest.mark.parametrize("integer", [True, False], ids=["int32", "float32"])
@pytest.mark.parametrize("scale_mode", ["cell", "block"])
def test_cfar_2d_vs_jax(variant, integer, scale_mode):
    """Whole map (override 0 and 6) and a prepadded shard at the map's top
    edge and one in its middle (block: the whole map's scale rows given),
    against JAX's XLA cfar_2d with reflect; the shards also against the
    whole map's rows."""
    cfar = _reflect(SMALL, variant=variant, scale_mode=scale_mode,
                    scale_block=4)
    m = _edge_map((128, 64), 3, integer)
    jc = _jcfar(cfar)
    hr = cfar.halo_range
    for so in (0, 6):
        det, thr, sc = TC.cfar_2d(torch.as_tensor(m), so, cfar,
                                  need_debug=True)
        jd, jt, js = (np.asarray(x) for x in JC.cfar_2d(
            jnp.asarray(m), so, cfar=jc, integer=integer))
        assert np.array_equal(det.numpy(), jd)
        assert int((det > 0).sum()) > 0
        if integer:
            assert np.array_equal(thr.numpy(), jt)
            assert np.array_equal(sc.numpy(), js)
        elif variant != "os":
            assert np.array_equal(sc.numpy(), js.astype(np.int32))
            assert _ulps(thr.numpy(), jt).max() <= 2
        elif scale_mode == "block":
            assert np.array_equal(sc.numpy(), js.astype(np.int32))
        for lo, hi in ((0, 32), (64, 96)) if so == 0 else ():
            s = _shard(m, lo, hi, hr)
            smap = sc.numpy()[lo:hi] if scale_mode == "block" else None
            d2, _, s2 = TC.cfar_2d(
                torch.as_tensor(s), so, cfar, prepadded_range=True,
                scale_map=None if smap is None else torch.as_tensor(smap))
            assert np.array_equal(_bits(d2.numpy()), _bits(det.numpy()[lo:hi]))
            assert np.array_equal(s2.numpy(), sc.numpy()[lo:hi])
            jd2, _, _ = JC.cfar_2d(
                jnp.asarray(s), so, cfar=jc, integer=integer,
                prepadded_range=True,
                scale_map=None if smap is None else jnp.asarray(smap))
            assert np.array_equal(d2.numpy(), np.asarray(jd2))


@pytest.mark.parametrize("seed", range(4))
def test_cfar_2d_random_shapes_down_to_single_mirror(seed):
    """Random windows and shapes, halos up to D - 1 and R - 1 (and beyond
    them in the twin, numpy's repeated mirror): int32 equal to JAX and the
    golden os_cfar_2d; float32 OS decisions equal to JAX."""
    rng = np.random.default_rng(40 + seed)
    for _ in range(2):
        rr, gr = int(rng.integers(1, 4)), int(rng.integers(0, 2))
        rd, gd = int(rng.integers(1, 4)), int(rng.integers(0, 2))
        cfar = _reflect(fmcw_tpu_torch.CfarParams(
            ref_range=rr, guard_range=gr, ref_doppler=rd, guard_doppler=gd,
            variant=str(rng.choice(["os", "ca"]))))
        hr, hd = cfar.halo_range, cfar.halo_doppler
        shape = (int(rng.integers(hr + 1, hr + 9)),
                 int(rng.integers(hd + 1, hd + 9)))
        if seed == 0:
            shape = (hr + 1, hd + 1)            # hr = R - 1, hd = D - 1
        for integer in (True, False):
            m = _edge_map(shape, seed, integer)
            det, thr, sc = TC.cfar_2d(torch.as_tensor(m), 0, cfar,
                                      need_debug=True)
            jd, jt, js = (np.asarray(x) for x in JC.cfar_2d(
                jnp.asarray(m), 0, cfar=_jcfar(cfar), integer=integer))
            assert np.array_equal(det.numpy(), jd), (cfar, shape)
            if integer:
                assert np.array_equal(sc.numpy(), js)
                gd_, gt, gs = tfx.os_cfar_2d(m, cfar, return_debug=True)
                assert np.array_equal(det.numpy(), gd_)
                assert np.array_equal(thr.numpy(), gt)
                assert np.array_equal(sc.numpy(), gs)


def test_golden_models_agree():
    """The port's golden os_cfar_2d and block_scale_map (its reflect pad
    and clipped block neighbourhood) equal JAX's golden model's."""
    m = _edge_map((64, 32), 7, True)
    for scale_mode in ("cell", "block"):
        for variant in ("os", "ca", "go"):
            cfar = _reflect(SMALL, variant=variant, scale_mode=scale_mode,
                            scale_block=4)
            got = tfx.os_cfar_2d(m, cfar, return_debug=True)
            want = jfx.os_cfar_2d(m, _jcfar(cfar), return_debug=True)
            assert all(np.array_equal(a, b) for a, b in zip(got, want))
        assert np.array_equal(tfx.block_scale_map(m, cfar),
                              jfx.block_scale_map(m, _jcfar(cfar)))


@pytest.mark.parametrize("integer", [True, False], ids=["int32", "float32"])
def test_block_scale_map_and_sharded_vs_jax(integer):
    """block_scale_map clips at the edges (differs from the wrap's on this
    map), and block_scale_map_sharded over a LocalRing at sp 2 and 4 gives
    its rows bit for bit; both equal JAX's block_scale_map."""
    cfar = _reflect(SMALL, scale_mode="block", scale_block=4)
    m = _edge_map((128, 64), 11, integer)
    m[..., :8, :] *= 9                       # the edge blocks' clutter
    want = np.asarray(JC.block_scale_map(jnp.asarray(m), _jcfar(cfar),
                                         integer))
    got = TC.block_scale_map(torch.as_tensor(m), cfar).numpy()
    assert np.array_equal(got, want)
    wrap = TC.block_scale_map(torch.as_tensor(m),
                              dataclasses.replace(cfar, edge_mode="wrap"))
    assert not np.array_equal(wrap.numpy(), got)
    for sp in (2, 4):
        n = 128 // sp
        shards = [torch.as_tensor(m[s * n:(s + 1) * n]) for s in range(sp)]
        out = TC.block_scale_map_sharded(shards, cfar,
                                         sharded.LocalRing(sp).halo)
        assert np.array_equal(torch.cat(out).numpy(), want)


# ---------------------------------------------------------------------------
# The standalone kernel's twins and a model of its reflect plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("integer,scale_mode", [
    (True, "cell"), (False, "cell"), (True, "block"), (False, "block")])
def test_twins_vs_interpret_kernels(integer, scale_mode):
    """cfar_detect_plain against JAX's _kernel_detect / _kernel_detect_scaled
    in interpret mode on the reflect-padded map (256x64, override 0), and
    cfar_detect_group_plain against it grouped by JAX's peak_group (radius
    2): det and scale bit for bit; integer maps also against the golden
    os_cfar_2d."""
    cfar = _reflect(QUICK.cfar, scale_mode=scale_mode, scale_block=4)
    m = _edge_map((256, 64), 5, integer)
    jd, js = (np.asarray(x) for x in JCP.cfar_2d_pallas_detect(
        jnp.asarray(m), 0, _jcfar(cfar), integer=integer, tile_rows=128,
        interpret=True))
    det, sc = CD.cfar_detect_plain(torch.as_tensor(m), cfar=cfar)
    assert np.array_equal(_bits(det.numpy()), _bits(jd))
    assert np.array_equal(sc.numpy(), js.astype(np.int32))
    g, gs, row_max, n = CD.cfar_detect_group_plain(
        torch.as_tensor(m), cfar=cfar, peak_group_radius=2)
    want = np.asarray(JC.peak_group(jnp.asarray(jd), 2))
    assert np.array_equal(_bits(g.numpy()), _bits(want))
    assert np.array_equal(gs.numpy(), sc.numpy())
    assert np.array_equal(row_max.numpy(), np.maximum(want, 0).max(-1))
    assert int(n) == int((want > 0).sum()) > 0
    if integer:
        assert np.array_equal(det.numpy(), tfx.os_cfar_2d(m, cfar))


def model_reflect(m, so, cfar, *, scale_map=None, prepadded=False,
                  T=None, strip=None, wrap_columns=False):
    """(det, scale) of the kernel's reflect entry on (B, R, D) numpy maps
    ((B, R + 2 hr, D) prepadded): blocks of T rows from r0 = block T; tile
    row e is map row reflect(r0 - hr + e) (prepadded: row r0 + e, modulo
    the shard's rows past its end) and carries its mirrored column halo,
    tile column j = map column reflect(j - hd); then the counting plan of
    the whole-map entry on rows of pitch D + 2 hd with columns unwrapped
    (``_decide`` on the halo-carrying tile; its column indices never wrap
    for the decided columns hd .. hd + D - 1), int32 tiles within float_max
    counted in float.  ``wrap_columns``: the mutation, a wrapped halo."""
    integer = m.dtype != np.float32
    B, R_in, D = m.shape
    hr, hd = cfar.halo_range, cfar.halo_doppler
    R = R_in - 2 * hr if prepadded else R_in
    cfg = CD.detect_config(B, R, D, cfar, so, integer, prepadded,
                           scale_map is not None)
    assert cfg.reflect == 1
    T = cfg.T if T is None else T
    S = cfg.strip if strip is None else strip
    packed = bool(cfg.packed)
    E = T + 2 * hr
    nblk = -(-R // T)
    r0s = np.arange(nblk) * T
    if prepadded:
        rix = (r0s[:, None] + np.arange(E)) % R_in
    else:
        rix = TC.reflect_index(torch.as_tensor(r0s[:, None] - hr
                                               + np.arange(E)), R).numpy()
    cols = np.arange(-hd, D + hd)
    cix = cols % D if wrap_columns else np.abs(cols)
    cix = np.where(cix >= D, 2 * (D - 1) - cix, cix)
    tile = m[:, rix][..., cix].reshape(B * nblk, E, D + 2 * hd)
    sc_given = None
    if scale_map is not None:
        # The halo columns' decisions are not kept: any scale there.
        sc_given = np.pad(np.asarray(scale_map)[:, (r0s[:, None]
                                                    + np.arange(T)) % R],
                          ((0, 0), (0, 0), (0, 0), (hd, hd)),
                          constant_values=cfar.scale_nom)
        sc_given = sc_given.reshape(B * nblk, T, D + 2 * hd)
    args = (so, cfar, cfg.k, cfg.n_ref, S, T, packed)

    def decide(t, gv, sem):
        zero = np.float32(-0.0) if sem != "int" else np.int32(0)
        f, g = _colsums(t, cfar, T, zero)
        return _decide(t, f, g, gv, *args, sem=sem)

    if not integer:
        det, sc, t_idx = decide(tile, sc_given, "float")
    else:
        det, sc, t_idx = decide(tile, sc_given, "int")
        fits = (np.abs(tile.astype(np.int64)) <= cfg.float_max).all(
            axis=(1, 2))
        if S == 8 and packed and fits.any():
            fdet, fsc, _ = decide(
                tile[fits].astype(np.float32),
                None if sc_given is None else sc_given[fits], "intinfloat")
            det[fits] = fdet.astype(np.int64).astype(det.dtype)
            sc[fits] = fsc
    det = det.astype(m.dtype).reshape(B, nblk, *det.shape[1:])
    sc = sc.reshape(B, nblk, *sc.shape[1:])
    out_det = np.zeros((B, R, D), m.dtype)
    out_sc = np.zeros((B, R, D), np.int32)
    for st in range(t_idx.shape[0]):
        for s in range(S):
            i = t_idx[st, s]
            for blk in range(nblk):
                if blk * T + i < R:
                    out_det[:, blk * T + i] = det[:, blk, st, s, hd:hd + D]
                    out_sc[:, blk * T + i] = sc[:, blk, st, s, hd:hd + D]
    return out_det, out_sc


def test_plan_rows_and_column_halo_match_numpy_pad():
    """The kernel's row map (reflect of r0 - hr + e, numpy's period beyond
    one mirror for a last block's discarded rows) and its column halo
    (one mirror) give np.pad(mode="reflect") of the map."""
    for R, D, hr, hd in ((7, 5, 6, 4), (37, 12, 3, 2), (1, 3, 0, 2)):
        m = np.arange(R * D).reshape(R, D)
        want = np.pad(m, ((hr, hr), (hd, hd)), mode="reflect")
        rows = TC.reflect_index(torch.arange(-hr, R + hr), R).numpy()
        cols = np.abs(np.arange(-hd, D + hd))
        cols = np.where(cols >= D, 2 * (D - 1) - cols, cols)
        assert np.array_equal(m[rows][:, cols], want)
        assert np.array_equal(TC._reflect_pad(torch.as_tensor(m), hr,
                                              hd).numpy(), want)
        # Beyond one mirror the twin keeps numpy's semantics.
        assert np.array_equal(
            TC._reflect_pad(torch.as_tensor(m), 3 * R, 2 * D).numpy(),
            np.pad(m, ((3 * R, 3 * R), (2 * D, 2 * D)), mode="reflect"))


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("window", ["full", "quick", "runtime"])
def test_plan_equals_twin(window, dtype):
    """The reflect plan against the twin bit for bit: per-cell and a given
    block scale map, override 0 and 4, a whole map of 37 rows (a last block
    past R), a prepadded shard, and adversarial maps (NaN, Inf, -0.0, ties,
    int keys to 2^31); a wrapped column halo disagrees."""
    cfar = _reflect({"full": fmcw_tpu_torch.CfarParams(),
                     "quick": QUICK.cfar,
                     "runtime": fmcw_tpu_torch.CfarParams(
                         ref_range=3, ref_doppler=2, guard_range=1,
                         guard_doppler=2)}[window])
    integer = dtype == "int32"
    maps = [_noise((2, 37, 24), integer, 3),
            rank_adversarial_maps((2, 48, 32), integer, 9)]
    for m in maps:
        for so in (0, 4):
            got = model_reflect(m, so, cfar)
            want = CD.cfar_detect(torch.as_tensor(m), so, cfar=cfar)
            assert all(np.array_equal(_bits(a), _bits(b.numpy()))
                       for a, b in zip(got, want))
        smap = np.random.default_rng(2).choice([2, 4, 6], m.shape).astype(
            np.int32)
        blk = dataclasses.replace(cfar, scale_mode="block")
        got = model_reflect(m, 0, blk, scale_map=smap)
        want = CD.cfar_detect(torch.as_tensor(m), cfar=blk,
                              scale_map=torch.as_tensor(smap))
        assert all(np.array_equal(_bits(a), _bits(b.numpy()))
                   for a, b in zip(got, want))
    m = maps[0]
    hr = cfar.halo_range
    ext = np.stack([_shard(x, 8, 24, hr) for x in m])
    got = model_reflect(ext, 0, cfar, prepadded=True)
    want = CD.cfar_detect(torch.as_tensor(ext), cfar=cfar,
                          prepadded_range=True)
    assert all(np.array_equal(_bits(a), _bits(b.numpy()))
               for a, b in zip(got, want))
    assert np.array_equal(_bits(want[0].numpy()), _bits(
        CD.cfar_detect(torch.as_tensor(m), cfar=cfar)[0].numpy()[:, 8:24]))
    mutant = model_reflect(_edge_map((2, 37, 24), 1, integer), 0, cfar,
                           wrap_columns=True)
    twin = CD.cfar_detect(torch.as_tensor(_edge_map((2, 37, 24), 1,
                                                    integer)), cfar=cfar)
    assert not np.array_equal(mutant[0], twin[0].numpy())


def test_kernel_config_and_limits():
    """The reflect entry's config: the flag, the tile planned at pitch D +
    2 hd; a single mirror (halo_range >= R raises NotImplementedError for a
    whole map, not for a prepadded shard); no grouping entry."""
    cfar = _reflect(fmcw_tpu_torch.CfarParams())
    cfg = CD.detect_config(128, 1024, 128, cfar)
    assert cfg.reflect == 1 and cfg.flat == 0
    assert (cfg.T, cfg.strip, cfg.W) == CD.tile_plan(1024, 128, 6, 5,
                                                     mode="reflect")
    assert CD.tile_bytes(cfg.T, 128, 6, pitch=138) * 3 <= 227 * 1024
    assert CD.detect_config(128, 1024, 128, cfar.__class__()).reflect == 0
    m = torch.zeros((2, 6, 32), dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        CD.kernel_inputs(m, 0, cfar, None, False, "cfar_detect")
    CD.kernel_inputs(torch.zeros((2, 13, 32), dtype=torch.int32), 0, cfar,
                     None, True, "cfar_detect")
    with pytest.raises(NotImplementedError):
        CD.detect_config(2, 64, 32, cfar, pgr=2)
    with pytest.raises(NotImplementedError):
        CD.cfar_detect_group(torch.zeros((2, 64, 32)), cfar=cfar,
                             peak_group_radius=2)


# ---------------------------------------------------------------------------
# The processors
# ---------------------------------------------------------------------------

def _xla_ref(p, iq, radius):
    ref = jpl.make_processor(_jparams(p), frontend="xla", include_debug=True,
                             peak_group_radius=radius)(iq)
    return jax.tree.map(np.asarray, ref)


def _no_kernel_b(monkeypatch):
    """Kernel B's and the fixed kernels' detect entries fail if called."""
    def boom(*a, **k):
        raise AssertionError("a reflect route reached a wrap-only kernel")
    for mod, name in ((tpl, "rdm_frontend_detect"),
                      (FX, "rdm_frontend_fixed_detect"),
                      (F, "slowtime_detect"), (SF, "slowtime_detect_split"),
                      (tpl, "cfar_detect_group")):
        monkeypatch.setattr(mod, name, boom)


@pytest.mark.parametrize("scale_mode", ["cell", "block"])
def test_float_auto_margin_gate_vs_xla(scale_mode, monkeypatch):
    """Float "auto" and "staged" at quick() within the margin gate of
    JAX's XLA chain (radius 2); "auto" is the magnitude-only route and
    never calls kernel B's detect entry; "plain" equals "auto" on the
    CPU."""
    _no_kernel_b(monkeypatch)
    p = _rp(QUICK, scale_mode=scale_mode, scale_block=4)
    assert not F.fused_detect_supported(p, 2)
    assert F.fused_detect_supported(p, 2, mag_only=True)
    assert tpl.resolve_frontend("float32", "auto", p, 2) == "fused"
    iq = tpl.complex_to_iq(_edge_frame(p))
    ref = _xla_ref(p, iq, 2)
    maps = (ref["mag_map"], ref["threshold_map"], ref["scale_map"])
    outs = {}
    for fe in ("auto", "staged", "plain"):
        out = tpl.make_processor(p, frontend=fe, peak_group_radius=2,
                                 device="cpu")(iq)
        ok, report = parity.margin_gate(
            parity.detection_set(out), parity.detection_set(ref), *maps,
            radius=2, targets=tref.golden_targets(p),
            capacity=p.tracker.max_dets)
        assert ok, (fe, report)
        outs[fe] = out
    assert all(torch.equal(outs["auto"][k], outs["plain"][k])
               for k in outs["auto"])


@pytest.mark.parametrize("scale_mode", ["cell", "block"])
def test_fixed_auto_equals_golden_and_jax(scale_mode, monkeypatch):
    """Fixed "auto" (the FP64 stages, then the reflect entry's twin and the
    plain grouping) equals the golden model bit for bit (magnitudes and the
    grouped det map), and JAX's fixed XLA chain's detection positions and
    counts (its values are the golden model's within its FP32 LSBs)."""
    _no_kernel_b(monkeypatch)
    p = _rp(QUICK, scale_mode=scale_mode, scale_block=4)
    for seed in (1, 4):
        z = _edge_frame(p, seed)
        iq = tpl.complex_to_iq(z)
        out = tpl.make_processor(p, mode="fixed", peak_group_radius=2,
                                 device="cpu")(iq)
        mag, det = tref.process_frame_fixed(z, p)
        assert np.array_equal(out["mag_map"].numpy(), mag)
        assert np.array_equal(out["det_map"].numpy(), tfx.peak_group(det, 2))
        j = jax.tree.map(np.asarray, jpl.make_processor(
            _jparams(p), mode="fixed", frontend="xla",
            peak_group_radius=2)(iq))
        assert np.array_equal(out["det_map"].numpy() > 0, j["det_map"] > 0)
        assert int(out["n_dets"]) == int(j["n_dets"]) > 0


@pytest.mark.parametrize("mode,scale_mode", [
    ("float32", "cell"), ("float32", "block"), ("fixed", "cell"),
    ("fixed", "block")])
def test_localmesh_equals_single_device(mode, scale_mode):
    """tests/test_sharded.py's reflect case on the port: a LocalMesh at sp 2
    and 4 (dp 2) equals make_batch_processor bit for bit in every output;
    the float route feeds the sharded tail from the magnitude-only kernel."""
    p = _rp(QUICK, scale_mode=scale_mode, scale_block=4)
    rng = np.random.default_rng(3)
    iq = np.stack([tpl.complex_to_iq(_edge_frame(p, s)) for s in range(2)])
    iq = iq + rng.integers(-8, 8, iq.shape).astype(np.int16)
    kw = dict(mode=mode, peak_group_radius=2, include_maps=True)
    single = tpl.make_batch_processor(p, device="cpu", **kw)(iq)
    wrap = tpl.make_batch_processor(
        p.replace(cfar=dataclasses.replace(p.cfar, edge_mode="wrap")),
        device="cpu", **kw)(iq)
    assert not torch.equal(wrap["det_map"], single["det_map"])
    for sp in (2, 4):
        out = sharded.make_sharded_processor(LocalMesh(2, sp, "cpu"), p,
                                             **kw)(iq)
        assert all(torch.equal(out[k], single[k]) for k in single), sp


def test_sharded_halo_limit():
    """halo_range + 1 > n_range / sp raises ValueError under reflect (the
    edge shards' mirror), not with wrap edges."""
    p = QUICK.replace(cfar=dataclasses.replace(QUICK.cfar, ref_range=24,
                                               guard_range=8))   # halo 32
    mesh = LocalMesh(1, 4, "cpu")                             # n_range/sp 32
    sharded.make_sharded_processor(mesh, p, frontend="staged")
    with pytest.raises(ValueError, match="reflect"):
        sharded.make_sharded_processor(mesh, _rp(p), frontend="staged")


DEADLINE_S = 90


def test_distring_equals_single_device(tmp_path):
    """Four gloo ranks (``DistRing``: each rank knows whether it holds an
    edge shard): every rank's detections equal the single device's and its
    map shards the single device's rows; block_scale_map_sharded equals
    block_scale_map."""
    world = 4
    ctx = mp.start_processes(
        torch_reflect_ranks.run_rank, args=(world, f"file://{tmp_path}/pg",
                        str(tmp_path / "rank{}.pt")),
        nprocs=world, join=False, start_method="spawn")
    try:
        end = time.monotonic() + DEADLINE_S
        while not ctx.join(timeout=2):
            if time.monotonic() > end:
                pytest.fail(f"ranks still running after {DEADLINE_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    res = [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]
    iq = torch_reflect_ranks.frames()
    n = QUICK.n_range // world
    for key in torch_reflect_ranks.CASES:
        mode, scale = key.split("/")
        p = torch_reflect_ranks.params(scale)
        single = tpl.make_batch_processor(p, mode=mode, peak_group_radius=2,
                                          include_maps=True,
                                          device="cpu")(iq)
        for r, out in enumerate(res):
            for k, v in out[key].items():
                want = single[k]
                if k in ("mag_map", "det_map"):
                    want = want[:, r * n:(r + 1) * n]
                assert torch.equal(v, want), (key, r, k)
    want = TC.block_scale_map(torch_reflect_ranks.block_map(),
                              torch_reflect_ranks.BLOCK)
    assert torch.equal(torch.cat([r["block_scale"] for r in res]), want)


def test_surveillance_and_pd_pfa():
    """A reflect configuration through run_surveillance (fixed mode, the
    tactical scenario, firm tracks) and through pd_pfa (one variant)."""
    p = _rp(QUICK)
    frames = [tpl.complex_to_iq(f) for _, f, _ in
              scenario.TacticalScenario(p, scenario.quick_scenario()).run()]
    proc = tpl.make_batch_processor(p, mode="fixed", peak_group_radius=2,
                                    include_maps=False, device="cpu")
    res = list(surveillance.run_surveillance(proc, frames, p, batch_scans=3,
                                             device="cpu"))
    assert len(res) == len(frames)
    assert sum(r.n_dets for r in res) > 0 and res[-1].active_tracks > 0
    table = ev.pd_pfa(P256.replace(cfar=_reflect(P256.cfar, scale_block=2)),
                      snr_dbs=(-18,), variants=("ca",), trials=4,
                      noise_trials=2, seed=1, device="cpu")
    assert table["ca"]["pd"][-18] >= 0.75 and table["ca"]["pfa"] < 1e-2


# ---------------------------------------------------------------------------
# Refusals and the hw-compat geometry
# ---------------------------------------------------------------------------

def test_refusals():
    """What wraps in JAX too refuses reflect, on the CPU as on the card;
    the rank-select and 3D CFARs, the OS debug taps and the array model
    (single device and sharded) run it."""
    p = _rp(QUICK)
    with pytest.raises(ValueError, match="wrap"):
        tpl.make_processor(p, mode="fixed", frontend="fused", device="cpu")
    assert not FX.fused_fixed_detect_supported(p)
    assert jpl.fused_fixed_detect_supported(_jparams(p)) is False
    iq = tpl.complex_to_iq(_edge_frame(p))
    for mode in ("float32", "fixed"):
        out = tpl.make_processor(p, mode=mode, include_debug=True,
                                 device="cpu")(iq)
        assert int(out["n_dets"]) > 0
    out = sharded.make_sharded_processor(LocalMesh(1, 2, "cpu"), p,
                                         include_debug=True)(iq[None])
    assert int(out["n_dets"][0]) > 0
    with pytest.raises(ValueError):
        sharded.make_sharded_processor(LocalMesh(1, 2, "cpu"), p,
                                       mode="fixed", frontend="fused")
    cubes = np.stack([iq] * 4)[None]
    for make in (tpl.make_batch_array_processor,
                 lambda q, **k: sharded.make_sharded_array_processor(
                     LocalMesh(1, 2, "cpu"), q, **k)):
        for ra in (0, 1):
            out = make(p, n_elems=4, n_beams=4, ref_angle=ra,
                       device="cpu")(cubes)
            assert int(out["n_dets"][0]) > 0
        with pytest.raises(ValueError, match="wrap"):
            make(p, n_elems=4, n_beams=4, frontend="fused", device="cpu")
    # The sharded array model mirrors its beam halo on the edge shards:
    # ref_angle + guard_angle + 1 <= n_beams / sp, as JAX's.
    with pytest.raises(ValueError, match="reflect"):
        sharded.make_sharded_array_processor(
            LocalMesh(1, 4, "cpu"), p, n_elems=4, n_beams=8, ref_angle=2,
            device="cpu")
    sharded.make_sharded_array_processor(
        LocalMesh(1, 4, "cpu"), QUICK, n_elems=4, n_beams=8, ref_angle=2,
        device="cpu")
    assert not sharded.split_detect_supported(p, 2, 2)
    mag = torch.as_tensor(_edge_map((2, 64, 32), 0, False))
    planes = torch.zeros((2, 64, 32)), torch.zeros((2, 64, 32))
    runs = [
        lambda: CR.cfar_rank(mag, cfar=p.cfar),
        lambda: CR.cfar_rank_plain(mag, cfar=p.cfar),
        lambda: CR.cfar_rank_then_group(mag, cfar=p.cfar,
                                        peak_group_radius=2),
        lambda: C3.cfar3d_detect(mag[None], cfar=p.cfar, ref_angle=1),
        lambda: C3.cfar3d_detect_plain(mag[None], cfar=p.cfar, ref_angle=1),
        lambda: TC.cfar_3d(mag[None], cfar=p.cfar, ref_angle=1)]
    for fn in runs:
        assert int((fn()[0] > 0).sum()) > 0
    refusals = [
        lambda: CR.cfar_rank_group(mag, cfar=p.cfar, peak_group_radius=2),
        lambda: CD.cfar_detect_group(mag, cfar=p.cfar),
        lambda: F.slowtime_detect(*planes, cfar=p.cfar),
        lambda: FX.slowtime_detect_fixed(*(x.to(torch.int16)
                                           for x in planes), cfar=p.cfar),
        lambda: SF.slowtime_detect_split(
            *planes, (planes[0][:, :3], planes[1][:, :3]),
            (planes[0][:, :3], planes[1][:, :3]), cfar=p.cfar,
            n_range_total=64),
        lambda: F._slowtime_config(1, 1024, 128, p.cfar, 0, 2)]
    for fn in refusals:
        with pytest.raises(NotImplementedError, match="reflect"):
            fn()
    # CA/GO/SO debug taps decide in the plain cfar_2d, which reflects.
    ca = _rp(QUICK, variant="ca")
    out = tpl.make_processor(ca, include_debug=True, peak_group_radius=2,
                             device="cpu")(
        tpl.complex_to_iq(tref.two_target_frame(ca)))
    assert int(out["n_dets"]) > 0


def test_hw_stream_ignores_edge_mode():
    """cfar_geometry="hw_stream" decides the as-built crossed window on the
    flat stream whatever edge_mode says, as JAX's cfar_2d_hw_stream."""
    z = tref.two_target_frame(QUICK)
    iq = tpl.complex_to_iq(z)
    outs = [tpl.make_processor(q, mode="fixed", cfar_geometry="hw_stream",
                               device="cpu")(iq)
            for q in (QUICK, _rp(QUICK))]
    assert all(torch.equal(outs[0][k], outs[1][k]) for k in outs[0])
    assert int(outs[1]["n_dets"]) > 0
