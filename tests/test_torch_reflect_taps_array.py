"""Reflect edges (``CfarParams.edge_mode="reflect"``) in the rank-select and
3D CFARs (TPU rows 9 and 10): the debug taps and the array model, against
the JAX package and the golden model, on the CPU.

* ``cfar_rank_plain`` (the twin of ``csrc/cfar_rank.cu``'s reflect entry)
  against JAX's ``cfar_2d_pallas`` in interpret mode (the map padded with
  ``cfar.edge_mode``) at quick()'s 128x32 with a 3 x 3 window, whole maps
  and prepadded range shards with mirrored halo rows, float on 16 key bits
  and exact, int32 on 16 bits: det, threshold and scale bit for bit.
* Numpy models of the two new tile plans: the rank select's rows
  reflect(r - hr + i) and bit-plane columns reflect(x - hd), the 3D CFAR's
  planes reflect(a - ha + p), rows reflect(r0 - hr + e) and its rows'
  mirrored column halo, each against ``np.pad(mode="reflect")``, and the
  whole plans (``tests/test_torch_rank_plan.py``'s and
  ``tests/test_torch_cfar3d_plan.py``'s models with reflect edges) against
  the twins bit for bit, prepadded shards too; a wrapped column mutation
  disagrees.
* The plain ``cfar_3d`` under reflect, OS / CA / GO / SO, ref_angle 1 and
  2, guard_angle 0 and 1, whole cubes and prepadded beam shards, against
  JAX's XLA ``cfar_3d`` and (OS) its interpret-mode
  ``cfar_3d_pallas_detect``.  Integer cubes: det, threshold and scale
  equal.  Float cubes: JAX sums a reflect window in ``_offsets_3d`` order,
  the port in the wrap kernel's separable order, so the means differ in
  their last bits; decisions and scales are equal except at cells within
  ``parity.py``'s margin (``tol = 1e-5 * max``): the cut within (1 + S) tol
  of the threshold, or the order statistic within tol of a class boundary
  (1.5 / 0.5 x the float64 mean).
* The debug-tap processors under reflect: float ``auto`` / ``staged`` /
  ``plain`` within the margin gate of JAX's XLA chain; fixed ``auto``: its
  det map and taps equal to the golden ``os_cfar_2d`` bit for bit and
  JAX's detection positions and count.
* The array model under reflect (4 elements x 4 beams x 256x64, the quick
  window, ref_angle 0 and 1): "auto" (the twins of kernel A's float entry
  and the magnitude-only entry, then the standalone or 3D CFAR's reflect
  entry) and "staged" within the array gate of JAX's array processor;
  "fused" at ref_angle 0 raises ValueError, as JAX's "pallas".
* A LocalMesh at sp 2 equals the single device for the sharded debug taps
  (float and fixed) and the sharded array model (ref_angle 0 and 1).
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import fmcw_tpu
import fmcw_tpu_torch
from fmcw_tpu.golden import fixed_point as jfx
from fmcw_tpu.models import pipeline as jpl
from fmcw_tpu.ops import cfar as JC
from fmcw_tpu.ops.cfar_pallas import cfar_2d_pallas, cfar_3d_pallas_detect
from fmcw_tpu_torch import parity
from fmcw_tpu_torch.golden import fixed_point as tfx, reference as tref
from fmcw_tpu_torch.golden.reference import rank_adversarial_maps
from fmcw_tpu_torch.models import pipeline as tpl
from fmcw_tpu_torch.ops import cfar as TC, cfar3d_detect as C3
from fmcw_tpu_torch.ops import cfar_rank as RK
from fmcw_tpu_torch.parallel import LocalMesh, sharded
from test_torch_cfar3d_plan import model_cfar3d
from test_torch_rank_plan import model_cfar_rank, reflect_idx

# Share the CPU with the other test workers (the suite runs 6 at once).
torch.set_num_threads(2)

QUICK = fmcw_tpu_torch.quick()
P256 = fmcw_tpu_torch.RadarParams(n_range=256, n_doppler=64)
SMALL = fmcw_tpu_torch.CfarParams(ref_range=2, ref_doppler=2, guard_range=1,
                                  guard_doppler=1)
# A 3 x 3 window (halo 1, no guard): interpret-mode Pallas compiles its
# kernels in ~2 s (the quick window's take ~10 s each).
TINY = fmcw_tpu_torch.CfarParams(ref_range=1, ref_doppler=1, guard_range=0,
                                 guard_doppler=0)
REL_TOL = 1e-5          # parity.py's margin: tol = REL_TOL * max(map)


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
    strong cells in the first and last rows and columns (and planes),
    where the mirror and the wrap differ."""
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
    if len(shape) >= 3:
        m[..., 0, 3, 3] = m[..., -1, r - 4, d - 4] = 9000.0
    return m.astype(np.int32 if integer else np.float32)


def _edge_frame(p, seed=1):
    """The golden two-target frame with two more targets on the first and
    last range bins but one, whose windows reach across the map's edges."""
    return tref.two_target_frame(p, seed=seed, targets=tref.golden_targets(p)
                                 + [(1, 3.0, 6000.0),
                                    (p.n_range - 2, -5.0, 6000.0)])


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _rows_shard(m, lo, hi, hr):
    """Rows lo .. hi of ``m`` with hr halo rows on each side, mirrored at
    the map's edges (the sharded debug tail's exchanged halo)."""
    return np.pad(m, ((hr, hr), (0, 0)), mode="reflect")[lo:hi + 2 * hr]


def _beam_shard(cube, lo, hi, ha):
    """Planes lo .. hi of a (A, R, D) cube with ha halo planes on each
    side, mirrored at the cube's edges (the sharded array model's
    exchange)."""
    pad = ((ha, ha),) + ((0, 0),) * (cube.ndim - 1)
    return np.pad(cube, pad, mode="reflect")[lo:hi + 2 * ha]


# ---------------------------------------------------------------------------
# The rank select's twin against JAX's interpret-mode kernel
# ---------------------------------------------------------------------------

# name: (integer, JAX keywords, port bits, scale_override, prepadded)
RANK_CASES = {
    "float-16bits": (False, dict(rank_bits=16), 16, 0, False),
    "float-exact-prepadded": (False, dict(rank_bits=None), None, 0, True),
    "int32-16bits-prepadded-override3": (
        True, dict(integer=True, int_bits=16), 16, 3, True),
}


@pytest.mark.parametrize("name", list(RANK_CASES))
def test_rank_twin_bitwise_vs_pallas_interpret(name):
    """cfar_rank_plain under reflect against JAX's cfar_2d_pallas (the map
    padded with numpy's reflect) at 128x32, a 3 x 3 window: det, threshold
    and scale bit for bit; a prepadded shard at the map's top edge (its
    halo rows mirrored) also equals the whole map's rows."""
    integer, jkw, bits, so, pre = RANK_CASES[name]
    cfar = _reflect(TINY)
    m = _edge_map((128, 32), len(name), False)
    if integer:
        m = (m / m.max() * 45000).astype(np.int32)
    whole = RK.cfar_rank_plain(torch.as_tensor(m), so, cfar=cfar, bits=bits)
    if pre:
        m = _rows_shard(m, 0, 64, cfar.halo_range)
    jd, jt, js = (np.asarray(x) for x in cfar_2d_pallas(
        jnp.asarray(m), so, cfar=_jcfar(cfar), prepadded_range=pre,
        tile_rows=128, interpret=True, **jkw))
    det, thr, scale = RK.cfar_rank_plain(torch.as_tensor(m), so, cfar=cfar,
                                         bits=bits, prepadded_range=pre)
    assert np.array_equal(_bits(det.numpy()), _bits(jd))
    assert np.array_equal(_bits(thr.numpy()), _bits(jt))
    assert np.array_equal(scale.numpy(), js.astype(np.int32))
    assert (det > 0).sum() > 0
    if pre:
        assert all(torch.equal(a, b[:64]) for a, b in zip((det, thr, scale),
                                                          whole))
    # The wrap taps differ on this map: the edges are exercised.
    wrap = RK.cfar_rank_plain(torch.as_tensor(m), so, cfar=TINY, bits=bits,
                              prepadded_range=pre)
    assert not torch.equal(wrap[1], thr)


# ---------------------------------------------------------------------------
# Numpy models of the two reflect tile plans
# ---------------------------------------------------------------------------

def test_plans_index_maps_match_numpy_pad():
    """The rank select's row map (reflect of r - hr + i) and bit-plane
    columns (reflect of x - hd, periodic past one mirror for the padding
    words), and the 3D CFAR's plane, row and column maps give
    np.pad(mode="reflect"), numpy's period beyond one mirror included."""
    for R, D, hr, hd in ((7, 6, 6, 5), (37, 12, 3, 2), (2, 3, 1, 2)):
        m = np.arange(R * D).reshape(R, D)
        want = np.pad(m, ((hr, hr), (hd, hd)), mode="reflect")
        rows = reflect_idx(np.arange(-hr, R + hr), R)
        cols = reflect_idx(np.arange(-hd, D + hd), D)
        assert np.array_equal(m[rows][:, cols], want)
        # The bit planes' 32 (npair + 1) extended columns, past the map.
        nw = (D + 31) // 32 + 1
        ext = reflect_idx(np.arange(32 * nw) - hd, D)
        far = np.pad(m, ((0, 0), (hd, 32 * nw)), mode="reflect")
        assert np.array_equal(m[:, ext], far[:, :32 * nw])
    for A, ha in ((2, 1), (8, 3), (5, 4)):
        cube = np.arange(A * 4 * 3).reshape(A, 4, 3)
        want = np.pad(cube, ((ha, ha), (2, 2), (1, 1)), mode="reflect")
        planes = reflect_idx(np.arange(-ha, A + ha), A)
        got = cube[planes][:, reflect_idx(np.arange(-2, 6), 4)][
            ..., reflect_idx(np.arange(-1, 4), 3)]
        assert np.array_equal(got, want)


def _twin_rank(m, so, cfar, bits, smap=None, pre=False):
    return RK.cfar_rank(torch.as_tensor(m), so, cfar=cfar, bits=bits,
                        scale_map=None if smap is None
                        else torch.as_tensor(smap), prepadded_range=pre)


def _same(model, twin):
    return all(np.array_equal(_bits(a), _bits(b.numpy()))
               for a, b in zip(model, twin))


@pytest.mark.parametrize("integer", [False, True], ids=["float", "int32"])
def test_rank_plan_equals_twin(integer):
    """The reflect rank plan against the twin bit for bit: the full and
    quick windows, 16 key bits and exact, override 0 and 4, a given scale
    map, noise with edge targets and adversarial maps (NaN, Inf, -0.0,
    ties, int keys to 2^31), 7 rows (hr = R - 1) and 6 columns (hd = D -
    1); a prepadded shard; planes with wrapped columns disagree."""
    full = _reflect(fmcw_tpu_torch.CfarParams())
    quick = _reflect(QUICK.cfar)
    maps = [(_edge_map((2, 40, 16), 3, integer), full),
            (rank_adversarial_maps((2, 48, 32), integer, 9), quick),
            (_edge_map((2, 7, 6), 4, integer), full)]
    for m, cfar in maps:
        for bits, so in ((16, 0), (None, 4)):
            assert _same(model_cfar_rank(m, so, cfar, bits),
                         _twin_rank(m, so, cfar, bits))
        blk = dataclasses.replace(cfar, scale_mode="block")
        smap = np.random.default_rng(2).choice([2, 4, 6], m.shape).astype(
            np.int32)
        assert _same(model_cfar_rank(m, 0, blk, None, scale_map=smap),
                     _twin_rank(m, 0, blk, None, smap))
    m = _edge_map((2, 40, 16), 5, integer)
    ext = np.stack([_rows_shard(x, 8, 24, full.halo_range) for x in m])
    got = model_cfar_rank(ext, 0, full, 16, prepadded=True)
    assert _same(got, _twin_rank(ext, 0, full, 16, pre=True))
    assert _same(got, [x[:, 8:24] for x in _twin_rank(m, 0, full, 16)])
    mutant = model_cfar_rank(m, 0, full, 16, reflect_planes=False)
    assert not np.array_equal(mutant[1], _twin_rank(m, 0, full, 16)[1])


def _twin_3d(cube, so, cfar, ra, ga, pre=False):
    det, scale = C3.cfar3d_detect(torch.as_tensor(cube), so, cfar=cfar,
                                  ref_angle=ra, guard_angle=ga,
                                  prepadded_angle=pre)
    return det.numpy(), scale.numpy()


@pytest.mark.parametrize("integer", [False, True], ids=["float", "int32"])
def test_cfar3d_plan_equals_twin(integer):
    """The reflect 3D plan (its config's T, strips of 8 or of one cell)
    against the twin bit for bit: ref_angle 1 and (2, 1), override 0 and
    4, 2 beams at a single mirror, adversarial cubes, a tile geometry of
    12 rows; the sp 4 beam shards with mirrored halo planes, equal to the
    whole cube's planes; a wrapped column halo disagrees."""
    full = _reflect(fmcw_tpu_torch.CfarParams())
    quick = _reflect(QUICK.cfar)
    cases = [(_edge_map((1, 6, 40, 16), 6, integer), full, 1, 0, {}),
             (_edge_map((1, 6, 40, 16), 7, integer), quick, 2, 1, {}),
             (_edge_map((1, 2, 7, 6), 8, integer), full, 1, 0, {}),
             (rank_adversarial_maps((1, 4, 32, 16), integer, 10), full, 1, 0,
              {}),
             (_edge_map((1, 4, 30, 16), 9, integer), quick, 1, 0,
              dict(T=12, strip=8)),
             (_edge_map((1, 4, 30, 16), 9, integer), quick, 1, 0,
              dict(T=5, strip=1, packed=False))]
    for cube, cfar, ra, ga, geo in cases:
        for so in (0, 4):
            got = model_cfar3d(cube, so, cfar, ra, ga, **geo)
            assert _same(got, [torch.as_tensor(x) for x in
                               _twin_3d(cube, so, cfar, ra, ga)])
    cube = _edge_map((1, 8, 40, 16), 11, integer)
    whole = _twin_3d(cube, 0, full, 1, 0)
    for s in range(4):
        x = np.stack([_beam_shard(c, 2 * s, 2 * s + 2, 1) for c in cube])
        got = model_cfar3d(x, 0, full, 1, 0, prepadded=True)
        assert _same(got, [torch.as_tensor(v) for v in
                           _twin_3d(x, 0, full, 1, 0, pre=True)])
        assert _same(got, [torch.as_tensor(v[:, 2 * s:2 * s + 2])
                           for v in whole])
    mutant = model_cfar3d(cube, 0, full, 1, 0, wrap_columns=True)
    assert not np.array_equal(mutant[1], whole[1])


def test_kernel_configs_and_limits():
    """The reflect entries' configs: the flag; the 3D tile planned at pitch
    D + 2 hd (the default window's T = 16 tile, 72.9 KB, still three blocks
    an SM); a single mirror (ha >= A, hr >= R refused for a whole cube, not
    ha for a prepadded shard); the grouping entry wraps only."""
    cfar = _reflect(fmcw_tpu_torch.CfarParams())
    cfg = C3.cfar3d_config((16, 8, 1024, 128), cfar, 1, 0)
    assert cfg.reflect == 1 and (cfg.T, cfg.strip, cfg.W) == C3.tile_plan(
        1024, 128, 1, 6, 5, reflect=True) == (16, 8, 128)
    assert C3._tile_bytes(cfg.T, 138, 1, 6) * 3 <= 227 * 1024
    assert C3.cfar3d_config((16, 8, 1024, 128), cfar.__class__(), 1,
                            0).reflect == 0
    with pytest.raises(NotImplementedError, match="single mirror"):
        C3.cfar3d_config((1, 2, 64, 32), cfar, 2, 0)
    with pytest.raises(NotImplementedError, match="single mirror"):
        C3.cfar3d_config((1, 4, 6, 32), cfar, 1, 0)
    C3.cfar3d_config((1, 2 + 4, 64, 32), cfar, 2, 0, prepadded_angle=True)
    with pytest.raises(NotImplementedError):
        RK.cfar_rank_group(torch.zeros((2, 64, 32)), cfar=cfar,
                           peak_group_radius=2)
    # The twin takes numpy's semantics beyond one mirror.
    m = _edge_map((1, 2, 7, 6), 1, False)
    det, _, _ = TC.cfar_3d(torch.as_tensor(m), 0, cfar, 3, 1)
    assert det.shape == m.shape


# ---------------------------------------------------------------------------
# The plain cfar_3d against JAX
# ---------------------------------------------------------------------------

def _margin_ok(m, det, scale, jdet, jthr, jscale, cfar, ra, ga, pre):
    """Cells whose decision or scale differs from JAX's lie within the
    margin: the cut within (1 + S) tol of JAX's threshold, or the order
    statistic (CA/GO/SO: the estimate, JAX's threshold / scale) within tol
    of 1.5x / 0.5x the float64 training mean.  Returns the number of such
    cells."""
    diff = (_bits(det) != _bits(jdet)) | (scale != jscale)
    if not diff.any():
        return 0
    tol = REL_TOL * float(np.max(m))
    ha = ra + ga
    hr, hd = cfar.halo_range, cfar.halo_doppler
    pad = (((0, 0) if pre else (ha, ha)), (hr, hr), (hd, hd))
    p = np.pad(m.astype(np.float64), pad, mode="reflect")
    cut = m[ha:-ha] if pre else m
    A, R, D = cut.shape
    total = sum(p[ha + da:ha + da + A, hr + dr:hr + dr + R,
                  hd + dd:hd + dd + D]
                for da, dr, dd in TC._offsets_3d(cfar, ra, ga))
    mean = total / len(TC._offsets_3d(cfar, ra, ga))
    est = jthr.astype(np.float64) / jscale
    near_thr = np.abs(cut - jthr) <= (1 + jscale) * tol
    near_class = np.minimum(np.abs(est - 1.5 * mean),
                            np.abs(est - 0.5 * mean)) <= tol
    assert (near_thr | near_class)[diff].all()
    return int(diff.sum())


# Every variant at both angle windows, each once on a whole cube and once on
# a prepadded shard.
CFAR3D_CASES = [(v, ra, ga, (v in ("os", "go")) == (ra == 2))
                for v in ("os", "ca", "go", "so")
                for ra, ga in ((1, 0), (2, 1))]


@pytest.mark.parametrize("variant,ra,ga,pre", CFAR3D_CASES)
def test_cfar_3d_vs_jax_xla(variant, ra, ga, pre):
    """The plain cfar_3d under reflect against JAX's XLA cfar_3d on a cube
    of 6 beams (a prepadded shard: beams 0-1 of it with the mirrored
    halo planes, as the sharded exchange gives them, also equal to the
    whole cube's planes): int32 det, threshold and scale equal; float32 by
    the margin rule of the module docstring."""
    cfar = _reflect(SMALL, variant=variant)
    for integer in (True, False):
        cube = _edge_map((6, 32, 16), 20 + ra, integer)
        whole = TC.cfar_3d(torch.as_tensor(cube), 0, cfar, ra, ga,
                           need_debug=True)
        x = _beam_shard(cube, 0, 2, ra + ga) if pre else cube
        det, thr, sc = (t.numpy() for t in TC.cfar_3d(
            torch.as_tensor(x), 0, cfar, ra, ga, need_debug=True,
            prepadded_angle=pre))
        if pre:
            assert all(np.array_equal(_bits(a), _bits(b.numpy()[:2]))
                       for a, b in zip((det, thr, sc), whole))
        jd, jt, js = (np.asarray(v) for v in JC.cfar_3d(
            jnp.asarray(x), 0, cfar=_jcfar(cfar), integer=integer,
            ref_angle=ra, guard_angle=ga, method="xla",
            prepadded_angle=pre, need_debug=True))
        assert int((det > 0).sum()) > 0
        if integer:
            assert np.array_equal(det, jd) and np.array_equal(thr, jt)
            assert np.array_equal(sc, js)
        else:
            assert _margin_ok(x, det, sc, jd, jt, js.astype(np.int32), cfar,
                              ra, ga, pre) <= det.size // 1000


@pytest.mark.parametrize("integer,pre", [(True, False), (False, True)],
                         ids=["int32-whole", "float32-prepadded"])
def test_cfar3d_twin_vs_pallas_interpret(integer, pre):
    """The 3D kernel's twin (cfar3d_detect_plain) under reflect against
    JAX's cfar_3d_pallas_detect in interpret mode (its direct loop over the
    reflect training offsets; every axis padded with numpy's reflect, or a
    prepadded shard's beam halo mirrored by the exchange), ref_angle 1 with
    a 3 x 3 window: int32 det and scale equal; float32 by the margin rule
    (JAX's kernel sums in offset order)."""
    cfar = _reflect(TINY)
    cube = _edge_map((6, 16, 16), 31, integer)
    x = _beam_shard(cube, 2, 4, 1) if pre else cube
    det, sc = (t.numpy() for t in C3.cfar3d_detect_plain(
        torch.as_tensor(x), cfar=cfar, ref_angle=1, prepadded_angle=pre))
    jd, js = (np.asarray(v) for v in cfar_3d_pallas_detect(
        jnp.asarray(x), 0, cfar=_jcfar(cfar), integer=integer, ref_angle=1,
        prepadded_angle=pre, tile_rows=16, interpret=True))
    js = js.astype(np.int32)
    if integer:
        assert np.array_equal(det, jd) and np.array_equal(sc, js)
    else:
        _, jt, _ = (np.asarray(v) for v in JC.cfar_3d(
            jnp.asarray(x), 0, cfar=_jcfar(cfar), ref_angle=1, method="xla",
            prepadded_angle=pre, need_debug=True))
        assert _margin_ok(x, det, sc, jd, jt, js, cfar, 1, 0,
                          pre) <= det.size // 1000
    assert int((det > 0).sum()) > 0


# ---------------------------------------------------------------------------
# The debug-tap processors and the array model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale_mode", ["cell", "block"])
def test_float_debug_processor_vs_jax(scale_mode):
    """Float debug taps under reflect on "auto" (the magnitude-only twin,
    the rank select's reflect twin, the plain grouping), "staged" and
    "plain" at quick() within the margin gate of JAX's XLA chain (radius 2);
    "plain" equals "auto" on the CPU; a LocalMesh at sp 2 equals the single
    device in every output."""
    p = _rp(QUICK, scale_mode=scale_mode, scale_block=4)
    iq = tpl.complex_to_iq(_edge_frame(p))
    ref = jax.tree.map(np.asarray, jpl.make_processor(
        _jparams(p), frontend="xla", include_debug=True,
        peak_group_radius=2)(iq))
    maps = (ref["mag_map"], ref["threshold_map"], ref["scale_map"])
    outs = {}
    for fe in ("auto", "staged", "plain"):
        out = tpl.make_processor(p, frontend=fe, include_debug=True,
                                 peak_group_radius=2, device="cpu")(iq)
        ok, report = parity.margin_gate(
            parity.detection_set(out), parity.detection_set(ref), *maps,
            radius=2, targets=tref.golden_targets(p),
            capacity=p.tracker.max_dets)
        assert ok, (fe, report)
        outs[fe] = out
    assert all(torch.equal(outs["auto"][k], outs["plain"][k])
               for k in outs["auto"])
    batch = np.stack([iq, tpl.complex_to_iq(_edge_frame(p, 2))])
    kw = dict(include_debug=True, peak_group_radius=2, include_maps=True)
    single = tpl.make_batch_processor(p, device="cpu", **kw)(batch)
    out = sharded.make_sharded_processor(LocalMesh(1, 2, "cpu"), p,
                                         **kw)(batch)
    assert all(torch.equal(out[k], single[k]) for k in single)


def test_fixed_debug_processor_equals_golden_and_jax():
    """Fixed "auto" debug taps under reflect (the FP64 stages, the rank
    select's reflect twin on 16 key bits, the plain grouping): the
    magnitudes, det map and taps equal to the golden os_cfar_2d bit for
    bit, JAX's detection positions and count; a LocalMesh at sp 2 equals
    the single device."""
    p = _rp(QUICK)
    z = _edge_frame(p, 4)
    iq = tpl.complex_to_iq(z)
    out = tpl.make_processor(p, mode="fixed", include_debug=True,
                             peak_group_radius=2, device="cpu")(iq)
    mag, _ = tref.process_frame_fixed(z, p)
    gd, gt, gs = tfx.os_cfar_2d(mag, p.cfar, return_debug=True)
    assert np.array_equal(out["mag_map"].numpy(), mag)
    assert np.array_equal(out["det_map"].numpy(), tfx.peak_group(gd, 2))
    assert np.array_equal(out["threshold_map"].numpy(), gt)
    assert np.array_equal(out["scale_map"].numpy(), gs)
    jgd = jfx.os_cfar_2d(mag, _jcfar(p.cfar))
    assert np.array_equal(gd, jgd)
    j = jax.tree.map(np.asarray, jpl.make_processor(
        _jparams(p), mode="fixed", frontend="xla", include_debug=True,
        peak_group_radius=2)(iq))
    assert np.array_equal(out["det_map"].numpy() > 0, j["det_map"] > 0)
    assert int(out["n_dets"]) == int(j["n_dets"]) > 0
    batch = np.stack([iq, tpl.complex_to_iq(_edge_frame(p, 5))])
    kw = dict(mode="fixed", include_debug=True, peak_group_radius=2,
              include_maps=True)
    single = tpl.make_batch_processor(p, device="cpu", **kw)(batch)
    shard = sharded.make_sharded_processor(LocalMesh(1, 2, "cpu"), p,
                                           **kw)(batch)
    assert all(torch.equal(shard[k], single[k]) for k in single)


N_ELEMS = N_BEAMS = 4
U0 = 0.6


def _matched_beam():
    u = np.linspace(-np.sin(np.deg2rad(60.0)), np.sin(np.deg2rad(60.0)),
                    N_BEAMS)
    return int(np.argmin(np.abs(u - U0)))


def _element_iq(p, seed):
    """The golden targets and two edge targets as a point source at
    steering sine U0 on every element, with independent noise: int16
    (N_ELEMS, n_doppler, n_range, 2)."""
    rng = np.random.default_rng(seed)
    z = np.asarray(_edge_frame(p, seed))
    return np.stack([tpl.complex_to_iq(
        z * np.exp(2j * np.pi * 0.5 * e * U0)
        + rng.normal(0, 8, z.shape) + 1j * rng.normal(0, 8, z.shape))
        for e in range(N_ELEMS)])


@pytest.mark.parametrize("ra", [0, 1])
def test_array_processor_vs_jax_and_localmesh(ra):
    """The array model under reflect (4 elements x 4 beams x 256x64, the
    quick window, radius 2, beam radius 1): "auto" and "staged" within the
    array gate of JAX's XLA array processor (M its magnitude cube, T and S
    the plain cfar_3d's taps on it), the targets at the matched beam; a
    LocalMesh at sp 2
    equals the single device in every output; "fused" at ref_angle 0
    raises ValueError, as JAX's "pallas"."""
    p = _rp(P256.replace(cfar=QUICK.cfar))
    kw = dict(n_elems=N_ELEMS, n_beams=N_BEAMS, ref_angle=ra,
              peak_group_radius=2, beam_group_radius=1)
    iq = _element_iq(p, 7)
    ref = jax.tree.map(np.asarray, jpl.make_array_processor(
        _jparams(p), frontend="xla", **kw)(iq))
    M = ref["mag_cube"]
    _, T, S = TC.cfar_3d(torch.tensor(M), 0, p.cfar, ra, need_debug=True)
    for fe in ("auto", "staged"):
        proc = tpl.make_array_processor(p, frontend=fe, device="cpu", **kw)
        out = proc(iq)
        ok, report = parity.array_gate(
            parity.array_set(out), parity.array_set(ref), M, T.numpy(),
            S.numpy(), radius=2, beam_radius=1,
            targets=tref.golden_targets(p), target_beam=_matched_beam(),
            capacity=p.tracker.max_dets)
        assert ok, (fe, report)
        assert int(out["beam_bin"][0]) == _matched_beam()
    assert proc.route == "staged"
    assert tpl.make_array_processor(p, device="cpu", **kw).route == "fused"
    batch = np.stack([iq, _element_iq(p, 8)])
    single = tpl.make_batch_array_processor(p, include_maps=True,
                                            device="cpu", **kw)(batch)
    out = sharded.make_sharded_array_processor(
        LocalMesh(1, 2, "cpu"), p, include_maps=True, **kw)(batch)
    assert all(torch.equal(out[k], single[k]) for k in single)
    wrap = tpl.make_batch_array_processor(
        P256.replace(cfar=QUICK.cfar), include_maps=True, device="cpu",
        **kw)(batch)
    assert not torch.equal(wrap["det_cube"], single["det_cube"])
    if ra == 0:
        for make in (tpl.make_array_processor,
                     lambda q, **k: sharded.make_sharded_array_processor(
                         LocalMesh(1, 2, "cpu"), q, **k)):
            with pytest.raises(ValueError, match="wrap"):
                make(p, frontend="fused", device="cpu", **kw)
