"""Wide maps in the three standalone CFAR kernels: the column chunks of
``csrc/cfar_rank.cu``, ``csrc/cfar_detect.cu`` and ``csrc/cfar_3d_detect.cu``
(TPU rows 7-10), their host plans, and the processors that ask those plans
when they are built, held against the JAX package on the CPU.

A kernel block takes T rows x a chunk of W columns with the window's and
the grouping's halo columns (hd + pgr each side, wrapped or mirrored), and
stores its own W columns (a ragged last chunk only those below D); the
grouping entries group by the map's global ids and combine row maxima by
max.  Here:

* a Python emulation of that blocking (the plain twin run on each chunk's
  wrap- or reflect-extended columns, the grouping with global ids, stitched,
  row maxima merged by max, counts summed) equals the whole-map twin bit
  for bit on 16-row maps of 584, 1016, 1816 and 2048 columns: float and
  int32 (tie-heavy), per-cell and block, OS and CA, radius 0 and 2, wrap
  and reflect, prepadded shards, W = 32, 64 and 96 with ragged last chunks;
  one halo column fewer differs (the halo widths are the kernels' own);
* every plan returns a tile within its shared memory for every D a
  multiple of 8 up to 4096 at the repository's windows, and the parent's
  whole-row tile (W = D) wherever the parent's plan fit;
* the processors build at the wide maps and match JAX's XLA chain on the
  CPU at 64 range rows: the float debug taps at 64x1016 (margin gate),
  fixed "auto" at 64x2048 (the golden model's detections exactly), the
  array model's 3D CFAR at ref_angle 2 at 64x1016 (array gate);
* the launches under the stand-in library carry the chunk (W < D) and a
  zeroed row_max; a window the kernels refuse raises when a kernel route is
  built, on the CPU, and builds on "plain".
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import fmcw_tpu
import fmcw_tpu_torch
from fmcw_tpu.golden import reference as jref
from fmcw_tpu.models import pipeline as jpl
from fmcw_tpu_torch import parity
from fmcw_tpu_torch.golden import reference as tref
from fmcw_tpu_torch.models import pipeline as tpl
from fmcw_tpu_torch.ops import cfar as C
from fmcw_tpu_torch.ops import cfar3d_detect as C3
from fmcw_tpu_torch.ops import cfar_detect as CD
from fmcw_tpu_torch.ops import cfar_rank as RK
from fmcw_tpu_torch.parallel import (LocalMesh, make_sharded_array_processor,
                                     make_sharded_processor)

from test_torch_isolation import as_if_cuda  # noqa: F401 (a fixture)

# Share the CPU with the other test workers (the suite runs 6 at once).
torch.set_num_threads(2)

WIDTHS = (584, 1016, 1816, 2048)
FULL = fmcw_tpu_torch.CfarParams()


def _cfar(**kw):
    return dataclasses.replace(FULL, **kw)


def _map(shape, integer: bool, seed: int) -> torch.Tensor:
    """Noise with strong cells; integer maps of few values (ties within
    windows and between grouping neighbours), float maps on a 0.5 grid."""
    rng = np.random.default_rng(seed)
    m = rng.exponential(8.0, shape)
    m[rng.random(shape) < 0.02] *= 40
    if integer:
        return torch.as_tensor(np.minimum(m, 200).astype(np.int32) // 4)
    return torch.as_tensor((np.round(m * 2) / 2).astype(np.float32))


# ---------------------------------------------------------------------------
# The chunked blocking, emulated with the twins
# ---------------------------------------------------------------------------

def _cols(c0: int, W: int, halo: int, D: int, reflect: bool):
    """Map columns of a chunk's tile: c0 - halo .. c0 + W + halo - 1,
    wrapped or mirrored (numpy's reflect, as fmcw::chunk_col)."""
    x = np.arange(c0 - halo, c0 + W + halo)
    if reflect:
        j = np.mod(x, 2 * (D - 1))
        x = np.where(j < D, j, 2 * (D - 1) - j)
    return torch.as_tensor(np.mod(x, D))


def _group(det: torch.Tensor, radius: int, ids: torch.Tensor):
    """ops/cfar.peak_group with every cell's linear id given (the chunk's
    global ids, as fmcw::group_store_chunk): rows wrap, columns are read
    inside the region only (the caller keeps cells at least ``radius``
    from its column edges)."""
    if radius <= 0:
        return det
    R, D = det.shape[-2:]
    pad = torch.cat([det[..., R - radius:, :], det, det[..., :radius, :]], -2)
    pid = torch.cat([ids[R - radius:], ids, ids[:radius]], 0)
    pad = torch.nn.functional.pad(pad, (radius, radius))
    pid = torch.nn.functional.pad(pid, (radius, radius), value=-1)
    lowest = (float("-inf") if det.is_floating_point()
              else torch.iinfo(det.dtype).min)
    best = torch.full_like(det, lowest)
    best_id = torch.zeros(det.shape, dtype=ids.dtype)
    for dr in range(2 * radius + 1):
        for dd in range(2 * radius + 1):
            nb = pad[..., dr:dr + R, dd:dd + D]
            nid = pid[dr:dr + R, dd:dd + D]
            take = (nb > best) | ((nb == best) & (nid < best_id))
            best = torch.where(take, nb, best)
            best_id = torch.where(take, nid, best_id)
    keep = (det > 0) & (best == det) & (best_id == ids)
    return torch.where(keep, det, torch.zeros_like(det))


def chunked(twin, m, W: int, halo: int, pgr: int = -1, reflect=False,
            scale_map=None, global_ids=True):
    """The kernels' blocking on map m (..., R_in, D): for each chunk c0 =
    0, W, .. the twin ``twin(x, scale_map)`` -> (det, *maps) on the chunk's
    extended columns (``halo`` = hd + pg each side), its own W columns
    below D stitched into the outputs; with ``pgr`` >= 0 the det map
    grouped by the map's global ids, the row maxima of each chunk's stored
    cells merged by max and their counts summed (``global_ids`` False: the
    chunk's own column order, the mutation check).  Returns (det, *maps,
    row_max, n_dets)."""
    D = m.shape[-1]
    pg = max(pgr, 0)
    outs, row_max, n_dets = None, None, None
    for c0 in range(0, D, W):
        wn = min(W, D - c0)
        cols = _cols(c0, W, halo, D, reflect)
        got = twin(m[..., cols],
                   None if scale_map is None else scale_map[..., cols])
        det = got[0]
        if pgr >= 0:
            R = det.shape[-2]
            cols = (_cols(c0, W, halo, D, False) if global_ids
                    else torch.arange(W + 2 * halo))
            ids = torch.arange(R)[:, None] * D + cols[None, :]
            det = _group(det, pg, ids)
        keep = slice(halo, halo + wn)
        got = [det[..., keep]] + [x[..., keep] for x in got[1:]]
        if outs is None:
            outs = [torch.zeros(x.shape[:-1] + (D,), dtype=x.dtype)
                    for x in got]
            row_max = torch.zeros(det.shape[:-1], dtype=det.dtype)
            n_dets = torch.zeros(det.shape[:-2], dtype=torch.int32)
        for o, x in zip(outs, got):
            o[..., c0:c0 + wn] = x
        row_max = torch.maximum(row_max, got[0].clamp(min=0).amax(-1))
        n_dets += (got[0] > 0).sum(dim=(-2, -1)).to(torch.int32)
    return (*outs, row_max, n_dets)


def _equal(got, want) -> bool:
    return len(got) == len(want) and all(
        torch.equal(a, b) for a, b in zip(got, want))


# (integer, cfar, pgr, W, prepadded): the 2D cases at every width.
DETECT_CASES = (
    (False, FULL, 2, 32, False),
    (True, _cfar(scale_mode="block"), 0, 64, False),
    (True, FULL, -1, 96, True),
    (False, _cfar(edge_mode="reflect"), -1, 64, False),
    (True, _cfar(edge_mode="reflect", scale_mode="block"), -1, 32, False),
    (False, _cfar(variant="ca"), -1, 64, False),
    (True, _cfar(variant="ca", scale_mode="block"), 2, 32, False))


@pytest.mark.parametrize("D", WIDTHS)
def test_detect_chunks_equal_the_whole_map(D):
    """csrc/cfar_detect.cu's chunks (and the plain CA/GO/SO step on the
    same blocking): det, scale, grouped det, row maxima and counts of the
    stitched chunks equal the whole-map twin's bit for bit."""
    for i, (integer, cfar, pgr, W, pre) in enumerate(DETECT_CASES):
        hr, hd = cfar.halo_range, cfar.halo_doppler
        reflect = cfar.edge_mode == "reflect"
        m = _map((2, 16 + (2 * hr if pre else 0), D), integer, D + i)
        sm = (C.block_scale_map(m, cfar) if cfar.scale_mode == "block"
              else None)
        so = 4 if i == 2 else 0

        def twin(x, s):
            det, _, scale = C.cfar_2d(x, so, cfar, scale_map=s,
                                      prepadded_range=pre)
            return det, scale

        got = chunked(twin, m, W, hd + max(pgr, 0), pgr, reflect, sm)
        det, _, scale = C.cfar_2d(m, so, cfar, scale_map=sm,
                                  prepadded_range=pre)
        if pgr < 0:
            assert _equal(got[:2], (det, scale)), (D, i)
            continue
        want = C.cfar_2d_group(m, so, cfar=cfar, scale_map=sm,
                               peak_group_radius=pgr)
        assert _equal(got[:2], want[:2]), (D, i)
        assert _equal(got[2:], want[2:]), (D, i)
        assert int(want[3].sum()) > 0


# (integer, cfar, bits, pgr, W, prepadded): the rank-select cases.
RANK_CASES = (
    (False, FULL, 16, 2, 64, False),
    (True, _cfar(scale_mode="block"), 16, 0, 32, False),
    (False, _cfar(edge_mode="reflect"), None, -1, 64, False),
    (False, FULL, 16, -1, 32, True),
    (True, _cfar(edge_mode="reflect", scale_mode="block"), 16, -1, 96,
     False))


@pytest.mark.parametrize("D", WIDTHS)
def test_rank_chunks_equal_the_whole_map(D):
    """csrc/cfar_rank.cu's chunks: det, threshold and scale (and the
    grouping entry's grouped det, row maxima and counts) of the stitched
    chunks equal the whole-map twin's bit for bit."""
    for i, (integer, cfar, bits, pgr, W, pre) in enumerate(RANK_CASES):
        hr, hd = cfar.halo_range, cfar.halo_doppler
        reflect = cfar.edge_mode == "reflect"
        m = _map((2, 16 + (2 * hr if pre else 0), D), integer, 7 * D + i)
        sm = (C.block_scale_map(m, cfar) if cfar.scale_mode == "block"
              else None)

        def twin(x, s):
            return RK.cfar_rank_plain(x, cfar=cfar, bits=bits, scale_map=s,
                                      prepadded_range=pre)

        got = chunked(twin, m, W, hd + max(pgr, 0), pgr, reflect, sm)
        if pgr < 0:
            want = RK.cfar_rank_plain(m, cfar=cfar, bits=bits, scale_map=sm,
                                      prepadded_range=pre)
            assert _equal(got[:3], want), (D, i)
            continue
        want = RK.cfar_rank_group_plain(m, cfar=cfar, bits=bits,
                                        scale_map=sm, peak_group_radius=pgr)
        assert _equal(got, want), (D, i)
        assert int(want[4].sum()) > 0


# (integer, cfar, ref_angle, W, prepadded): the 3D cases.
CFAR3D_CASES = (
    (False, FULL, 1, 64, False),
    (True, _cfar(edge_mode="reflect"), 2, 96, False),
    (False, FULL, 1, 96, True))


@pytest.mark.parametrize("D", WIDTHS)
def test_cfar3d_chunks_equal_the_whole_cube(D):
    """csrc/cfar_3d_detect.cu's chunks over the 2 ha + 1 beam planes
    (wrap, reflect, a prepadded beam shard): det and scale of the stitched
    chunks equal the whole-cube twin's bit for bit."""
    for i, (integer, cfar, ra, W, pre) in enumerate(CFAR3D_CASES):
        reflect = cfar.edge_mode == "reflect"
        cube = _map((1, 2 * ra + 1 + (2 * ra if pre else 0), 16, D),
                    integer, 11 * D + i)
        kw = dict(cfar=cfar, ref_angle=ra, prepadded_angle=pre)
        got = chunked(lambda x, s: C3.cfar3d_detect_plain(x, **kw), cube, W,
                      cfar.halo_doppler, reflect=reflect)
        assert _equal(got[:2], C3.cfar3d_detect_plain(cube, **kw)), (D, i)


def test_mutations_differ():
    """The mutation checks: chunks loaded with one window halo column fewer
    than hd differ from the whole map in each kernel's emulation, and so
    does grouping by the chunk's own column order in place of the map's
    ids (ties across the wrap seam)."""
    m = _map((2, 16, 1016), False, 5)
    det, _, scale = C.cfar_2d(m, 0, FULL)

    def twin(x, s):
        d, _, sc = C.cfar_2d(x, 0, FULL)
        return d, sc

    hd = FULL.halo_doppler
    assert not _equal(chunked(twin, m, 64, hd - 1)[:2], (det, scale))
    im = _map((2, 16, 1016), True, 5) // 8
    im[:, 5, 0] = im[:, 5, -1] = 90         # a tie across the seam
    want = C.cfar_2d_group(im, 0, cfar=FULL, peak_group_radius=2)
    assert want[0][0, 5, 0] == 90 and want[0][0, 5, -1] == 0
    assert _equal(chunked(twin, im, 64, hd + 2, 2), want)
    assert not _equal(chunked(twin, im, 64, hd + 2, 2, global_ids=False),
                      want)
    rank = RK.cfar_rank_plain(m, cfar=FULL, bits=16)
    assert not _equal(chunked(lambda x, s: RK.cfar_rank_plain(
        x, cfar=FULL, bits=16), m, 32, hd - 1)[:3], rank)
    cube = _map((1, 5, 16, 1016), False, 6)
    kw = dict(cfar=FULL, ref_angle=1)
    assert not _equal(chunked(lambda x, s: C3.cfar3d_detect_plain(x, **kw),
                              cube, 64, hd - 1)[:2],
                      C3.cfar3d_detect_plain(cube, **kw))


# ---------------------------------------------------------------------------
# The host plans
# ---------------------------------------------------------------------------

def _parent_detect_plan(R, D, hr, pgr, block, pitch):
    """ops/cfar_detect.tile_plan before the chunks: (T, strip) or None."""
    pg = max(pgr, 0)

    def steps(t):
        units = -(-(t + 2 * pg) // 8) * D
        return -(-R // t) * -(-units // 256)

    def fits(t, limit):
        return CD.tile_bytes(t, D, hr, pgr, block, pitch) <= limit

    cands = [t for t in range(8, min(64, max(R, 8)) + 1)
             if fits(t, 72 * 1024)]
    if cands:
        return min(cands, key=lambda t: (steps(t), -t)), 8
    if fits(8, 227 * 1024):
        return 8, 8
    for t in range(7, 0, -1):
        if fits(t, 227 * 1024):
            return t, 1
    return None


def _parent_3d_plan(R, D, ha, hr, pitch):
    """ops/cfar3d_detect.tile_plan before the chunks: (T, strip) or None."""
    def strip_rows(t):
        return (R + t - 1) // t * ((t + 7) // 8)

    fits = [t for t in range(8, min(64, max(R, 8)) + 1)
            if C3._tile_bytes(t, pitch, ha, hr) <= 72 * 1024]
    if fits:
        return min(fits, key=lambda t: (strip_rows(t), -t)), 8
    if C3._tile_bytes(8, pitch, ha, hr) <= 227 * 1024:
        return 8, 8
    for t in range(7, 0, -1):
        if C3._tile_bytes(t, pitch, ha, hr) <= 227 * 1024:
            return t, 1
    return None


def _parent_rank_plan(R, D, hr, hd, pgr, bits, colsums):
    """ops/cfar_rank._launch's halving before the chunks: T or None."""
    t = min(R & -R, 32)
    while t > 1 and RK.tile_bytes(t, D, D, hr, hd, pgr, bits,
                                  colsums) > 112 * 1024:
        t //= 2
    return t if RK.tile_bytes(t, D, D, hr, hd, pgr, bits,
                              colsums) <= 112 * 1024 else None


WINDOWS = (FULL, fmcw_tpu_torch.quick().cfar)
WIDTHS_8 = range(8, 4097, 8)


def test_detect_plan_at_every_width():
    """cfar_detect's plan at every D = 8 .. 4096 (multiples of 8), R 1024,
    the repository's windows, per-cell and block, radius -1 / 0 / 2, wrap
    and reflect: a tile within 227 KB (strips of 8 with T >= 8, or of one
    cell), the parent's whole-row tile wherever the parent's plan fit,
    chunks of a multiple of 32 columns where it did not; the flat-stream
    entry keeps whole rows and refuses where they do not fit."""
    chunked_at = {}
    for cfar in WINDOWS:
        hr, hd = cfar.halo_range, cfar.halo_doppler
        for pgr, block, mode in ((-1, False, "wrap"), (2, False, "wrap"),
                                 (0, True, "wrap"), (-1, True, "reflect"),
                                 (-1, False, "reflect")):
            pg = max(pgr, 0)
            for D in WIDTHS_8:
                T, strip, W = CD.tile_plan(1024, D, hr, hd, pgr, block, mode)
                P = D if mode == "wrap" else D + 2 * hd
                parent = _parent_detect_plan(1024, D, hr, pgr, block, P)
                if parent is not None:
                    assert (T, strip, W) == (*parent, D), (D, pgr, mode)
                    continue
                chunked_at.setdefault((hr, pgr, block, mode), D)
                assert W < D and W % 32 == 0
                assert CD.tile_bytes(T, W + 2 * pg, hr, pgr, block,
                                     W + 2 * (hd + pg)) <= 227 * 1024
                assert strip == 1 or T >= strip == 8
    # The parent's limits at the default window: 1808 columns grouped.
    assert chunked_at[(6, 2, False, "wrap")] == 1816
    sw = C.hw_stream_params(FULL)
    for D in (128, 2048):
        assert CD.tile_plan(1024, D, sw.halo_range, sw.halo_doppler,
                            mode="flat")[2] == D
        CD.check_flat_kernel(1024, D, FULL)
    with pytest.raises(NotImplementedError):
        CD.tile_plan(1024, 8192, sw.halo_range, sw.halo_doppler, mode="flat")


def test_rank_plan_at_every_width():
    """cfar_rank's plan at every D = 8 .. 4096: the parent's whole rows (T
    halved within 112 KB) wherever they fit, else chunks within 112 KB
    (two blocks an SM).  The parent's limits at the default window with grouping:
    576 columns (16 key bits), 728 (block), 432 (31 bits), 512 (block, 31
    bits: the processors' block taps); 1024 without grouping."""
    first = {}
    for cfar in WINDOWS:
        hr, hd = cfar.halo_range, cfar.halo_doppler
        for pgr, bits, colsums in ((2, 16, True), (2, 16, False),
                                   (2, 31, True), (-1, 16, True),
                                   (2, 31, False), (0, 16, True)):
            for D in WIDTHS_8:
                T, W = RK.tile_plan(1024, D, hr, hd, pgr, bits, colsums)
                parent = _parent_rank_plan(1024, D, hr, hd, pgr, bits,
                                           colsums)
                if parent is not None:
                    assert (T, W) == (parent, D)
                    continue
                first.setdefault((hr, pgr, bits, colsums), D)
                assert W < D and W % 32 == 0 and 1024 % T == 0
                assert RK.tile_bytes(T, D, W, hr, hd, pgr, bits,
                                     colsums) <= 112 * 1024
    assert [first[(6, 2, 16, True)], first[(6, 2, 16, False)],
            first[(6, 2, 31, True)], first[(6, 2, 31, False)],
            first[(6, -1, 16, True)]] == [584, 736, 440, 520, 1032]


def test_cfar3d_plan_at_every_width():
    """The 3D CFAR's plan at every D = 8 .. 4096 with 3, 5 and 7 beam
    planes, wrap and reflect: the parent's whole rows wherever the parent's
    plan fit (1376 / 824 / 592 columns at the default window), chunks
    within 227 KB beyond."""
    first = {}
    for cfar in WINDOWS:
        hr, hd = cfar.halo_range, cfar.halo_doppler
        for ha in (1, 2, 3):
            for reflect in (False, True):
                for D in WIDTHS_8:
                    T, strip, W = C3.tile_plan(1024, D, ha, hr, hd, reflect)
                    parent = _parent_3d_plan(1024, D, ha, hr,
                                             D + 2 * hd if reflect else D)
                    if parent is not None:
                        assert (T, strip, W) == (*parent, D)
                        continue
                    first.setdefault((hr, ha, reflect), D)
                    assert W < D and W % 32 == 0
                    assert C3._tile_bytes(T, W + 2 * hd, ha,
                                          hr) <= 227 * 1024
                    assert strip == 1 or T >= strip == 8
    assert [first[(6, ha, False)] for ha in (1, 2, 3)] == [1384, 832, 600]


# ---------------------------------------------------------------------------
# The processors
# ---------------------------------------------------------------------------

def _jparams(p):
    return fmcw_tpu.RadarParams(
        n_range=p.n_range, n_doppler=p.n_doppler, notch_mode=p.notch_mode,
        cfar=fmcw_tpu.CfarParams(**dataclasses.asdict(p.cfar)),
        tracker=fmcw_tpu.TrackerParams(**dataclasses.asdict(p.tracker)))


def test_debug_taps_at_1016_margin_gate_vs_jax_xla():
    """The float debug taps at 64x1016 (the rank-select CFAR's grouping
    entry, chunked on the card): the processor builds on its kernel route;
    on the CPU its twins against JAX's XLA chain through the margin gate
    (det map and top-K), its taps on JAX's magnitudes."""
    p = fmcw_tpu_torch.RadarParams(n_range=64, n_doppler=1016)
    iq = tpl.complex_to_iq(tref.two_target_frame(p))
    ref = jax.tree.map(np.asarray, jpl.make_processor(
        _jparams(p), frontend="xla", peak_group_radius=2,
        include_debug=True)(iq))
    proc = tpl.make_processor(p, peak_group_radius=2, include_debug=True,
                              device="cpu")
    out = proc(iq)
    maps = (ref["mag_map"], ref["threshold_map"], ref["scale_map"])
    targets = tref.golden_targets(p)
    for a, b in ((parity.map_set(out["det_map"].numpy()),
                  parity.map_set(ref["det_map"])),
                 (parity.detection_set(out), parity.detection_set(ref))):
        ok, report = parity.margin_gate(a, b, *maps, radius=2,
                                        targets=targets,
                                        capacity=p.tracker.max_dets)
        assert ok, report


def test_fixed_auto_at_2048_equals_the_golden_model():
    """Fixed "auto" (the staged route: the standalone CFAR's grouping
    entry, chunked on the card) at 64x2048: its detections are the golden
    model's exactly (JAX's fmcw_tpu.golden), peak-grouped, and its det map
    and top-K the route's twin's."""
    p = fmcw_tpu_torch.RadarParams(n_range=64, n_doppler=2048)
    assert CD.tile_plan(64, 2048, 6, 5, 2)[2] < 2048
    z = tref.two_target_frame(p)
    proc = tpl.make_processor(p, mode="fixed", peak_group_radius=2,
                              device="cpu")
    out = proc(tpl.complex_to_iq(z))
    _, det = jref.process_frame_fixed(np.asarray(z), _jparams(p))
    want = C.peak_group(torch.as_tensor(det), 2).numpy()
    assert np.array_equal(out["det_map"].numpy(), want)
    assert int(out["n_dets"]) == int((want > 0).sum()) > 0
    r, d = np.nonzero(want)
    top = sorted(zip(-want[r, d], r * 2048 + d))[:p.tracker.max_dets]
    v = out["valid"].numpy()
    assert sorted(zip(out["range_bin"].numpy()[v],
                      out["doppler_bin"].numpy()[v])) == sorted(
        (i // 2048, i % 2048) for _, i in top)


def test_array_3d_at_1016_gate_vs_jax_xla():
    """The array model's 3D CFAR at ref_angle 2 (5 beam planes, chunked on
    the card above 824 columns) at 16x1016, 4 elements, 2 beams (JAX's XLA
    3D CFAR sorts 670 training values a cell): the processor
    builds; its twins against JAX's XLA array processor through the array
    gate."""
    p = fmcw_tpu_torch.RadarParams(n_range=16, n_doppler=1016)
    u0, n_elems, n_beams = 0.4, 4, 2
    assert C3.tile_plan(1024, 1016, 2, 6, 5)[2] < 1016
    rng = np.random.default_rng(13)
    z = np.asarray(tref.two_target_frame(p, seed=13,
                                         targets=[(10, 200, 12000)]))
    iq = np.stack([tpl.complex_to_iq(
        z * np.exp(2j * np.pi * 0.5 * e * u0)
        + rng.normal(0, 8, z.shape) + 1j * rng.normal(0, 8, z.shape))
        for e in range(n_elems)])
    kw = dict(ref_angle=2)
    ref = jax.tree.map(np.asarray, jpl.make_array_processor(
        _jparams(p), n_elems=n_elems, n_beams=n_beams, frontend="xla",
        **kw)(iq))
    M = ref["mag_cube"]
    _, T, S = C.cfar_3d(torch.tensor(M), 0, p.cfar, 2, 0, need_debug=True)
    out = tpl.make_array_processor(p, n_elems=n_elems, n_beams=n_beams,
                                   device="cpu", **kw)(iq)
    u = np.linspace(-np.sin(np.deg2rad(60.0)), np.sin(np.deg2rad(60.0)),
                    n_beams)
    beam = int(np.argmin(np.abs(u - u0)))
    ok, report = parity.array_gate(
        parity.array_set(out), parity.array_set(ref), M, T.numpy(),
        S.numpy(), radius=0, beam_radius=0, targets=[(10, 200, 12000)],
        target_beam=beam, capacity=p.tracker.max_dets)
    assert ok, report


def test_wide_launches_carry_the_chunk(as_if_cuda):
    """Under the stand-in library at 1024x2048: the standalone CFAR's
    grouping entry, the rank-select CFAR's grouping entry and the 3D CFAR
    launch with their plans' chunk (W < D) and, for the grouping entries,
    a zeroed row_max (the chunks combine into it); at 1024x128 the whole
    rows (W = D) as before."""
    for D in (128, 2048):
        mag = torch.zeros((2, 1024, D), dtype=torch.int32)
        *_, row_max, _ = CD.cfar_detect_group(mag, cfar=FULL,
                                              peak_group_radius=2)
        cfg = as_if_cuda.calls[-1][1][6]._obj
        assert (cfg.T, cfg.strip, cfg.W) == CD.tile_plan(1024, D, 6, 5, 2)
        *_, rmax, _ = RK.cfar_rank_group(mag.float(), cfar=FULL, bits=16,
                                         peak_group_radius=2)
        cfg = as_if_cuda.calls[-1][1][7]._obj
        assert (cfg.T, cfg.W) == RK.tile_plan(1024, D, 6, 5, 2, 16, True)
        C3.cfar3d_detect(mag.reshape(2, 4, 256, D).float(), cfar=FULL,
                         ref_angle=1)
        cfg3 = as_if_cuda.calls[-1][1][3]._obj
        assert (cfg3.T, cfg3.strip, cfg3.W) == C3.tile_plan(256, D, 1, 6, 5)
        if D == 2048:
            assert cfg.W < D and cfg3.W < D
            assert not row_max.any() and not rmax.any()
        else:
            assert cfg.W == cfg3.W == D
    assert (CD.cfar_detect_group.launches, RK.cfar_rank_group.launches,
            C3.cfar3d_detect.launches) == (2, 2, 2)


def _reflect(p):
    return dataclasses.replace(p, cfar=dataclasses.replace(
        p.cfar, edge_mode="reflect"))


@pytest.mark.parametrize("build", [
    lambda p, **kw: tpl.make_batch_processor(p, include_debug=True, **kw),
    lambda p, **kw: tpl.make_batch_processor(p, mode="fixed", **kw),
    lambda p, **kw: tpl.make_batch_array_processor(p, ref_angle=1, **kw),
    lambda p, **kw: make_sharded_processor(LocalMesh(1, 2, "cpu"), p,
                                           include_debug=True, **kw),
    lambda p, **kw: tpl.make_batch_array_processor(_reflect(p), **kw),
    lambda p, **kw: make_sharded_processor(LocalMesh(1, 2, "cpu"), p,
                                           mode="fixed", **kw),
    lambda p, **kw: make_sharded_array_processor(LocalMesh(1, 2, "cpu"), p,
                                                 ref_angle=1, **kw)],
    ids=["debug", "fixed-auto", "array-3d", "sharded-debug",
         "array-2d-reflect", "sharded-fixed-auto", "sharded-array-3d"])
def test_refused_windows_raise_at_build(build):
    """A window the kernels refuse (405 x 405 cells: more than a
    bit-plane word's 32 columns for the rank select; a tile of one row and
    a chunk of 32 columns with its halo passes 227 KB in the standalone
    and 3D CFARs) raises NotImplementedError when a kernel route is built,
    on the CPU; "plain" builds."""
    wide = fmcw_tpu_torch.CfarParams(ref_doppler=200, guard_doppler=2,
                                     ref_range=200, guard_range=2)
    p = fmcw_tpu_torch.RadarParams(n_range=1024, n_doppler=4096, cfar=wide)
    with pytest.raises(NotImplementedError):
        build(p, device="cpu")
    build(p, device="cpu", frontend="plain")
