"""A numpy model of the standalone CFAR kernel's plan
(fmcw_tpu_torch/csrc/cfar_detect.cu: strips of cells counted in float, an
optional grouping epilogue), held bit for bit against its plain twins
``ops/cfar.cfar_2d`` and ``ops/cfar_detect.cfar_detect_group_plain``
(which tests/test_torch_cfar_detect.py holds against JAX's XLA body and
JAX's interpret-mode kernels) on the CPU.

The kernel runs only on the card; its arithmetic is modelled here step by
step, with the block and strip geometry that ``ops/cfar_detect.
detect_config`` hands it (or another one, to cover every geometry the
kernel takes):

* blocks of T range rows from r0 = block * T; the tile holds map rows r0 -
  H .. r0 + T + H - 1, H = hr + pgr (pgr = 0 without grouping), rows
  wrapped modulo R (a prepadded shard: its rows r0 .. straight); rows of
  the last block past R are decided and not stored;
* int32 tiles whose values all lie within ``float_max`` are converted to
  float32 and counted in float with the integer semantics (box sums in int
  from the float column sums, the integer thresholds and q converted);
  any other int32 tile counts in int;
* column sums of the T + 2 pgr decided rows over the window's 2 hr + 1
  rows and the guard's 2 gr + 1 rows, rows ascending from -0 (float32, or
  int32 wrapping);
* strips of S cells of one column (S = 8, or 1 when 8 rows do not fit),
  strip st at decided row i0 = min(st S, rows - S): the last strip overlaps
  its neighbour when S does not divide the decided rows, and its cells are
  decided twice, alike;
* per cell the full and guard box sums from the column sums, columns
  ascending, the thresholds 1.5 / 0.5 x mean (integer: floor mean, mean +
  (mean >> 1), mean >> 1) or the given scale map's scale;
* the walks: window columns dd ascending, rows dr ascending, the guard rows
  of the guard columns left out; hi and lo counted in float (1.0 / 0.0
  compares, the adds rounded to float32) packed as hi * 4096 + lo while
  n_ref <= 4094, else in two counts; int tiles in int, packed as hi *
  65536 + lo under the same limit;
* the float q (the smallest float32 whose rounded product with the scale
  reaches the CUT) and the integer q = floor((cut - 1) / scale) + 1; det =
  CUT where count(refs >= q) < k and CUT > 0; a scale override skips the
  hi/lo pass;
* the grouping entry: each stored cell kept where no cell of its (2 pgr +
  1)^2 wrapped neighbourhood (decided in the tile's halo rows) is larger,
  or equal at a lower linear index; the row maxima of the kept cells (0
  where none) and their count.

Maps: seeded noise with bright cells and plateaus; int32 maps with values
near 2^31 in some tiles only (those tiles count in int, the others in
float); and ``golden.reference.rank_adversarial_maps`` (NaN, +-Inf, -0.0,
negative values, denormals, ties at the k-th value, int keys beyond 2^16
and down to -2^31).  Mutation checks show that the model with hi and lo
packed above 4094 training cells, counting in float beyond float_max, or
grouping without the halo rows' decisions, disagrees with the twin.
"""

import dataclasses

import numpy as np
import pytest
import torch

import fmcw_tpu_torch as P
from fmcw_tpu_torch.golden.reference import rank_adversarial_maps
from fmcw_tpu_torch.ops import cfar as C, cfar_detect as CD

torch.set_num_threads(2)

FULL = P.RadarParams().cfar
QUICK = P.quick().cfar
# A window outside the unrolled walks (hr 4, gr 1).
RUNTIME = P.CfarParams(ref_range=3, ref_doppler=2, guard_range=1,
                       guard_doppler=2)
WINDOWS = {"full": FULL, "quick": QUICK, "runtime": RUNTIME}
# n_ref = 65 x 65 - 9 = 4216 > 4094.
LARGE = P.CfarParams(ref_range=31, ref_doppler=31, guard_range=1,
                     guard_doppler=1)


def _wrap32(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64).astype(np.int32)


def _bits(x: np.ndarray) -> np.ndarray:
    return x.view(np.int32)


def _decide(tile, cs_f, cs_g, sc_given, so, cfar, k, n_ref, S, rows,
            packed, sem):
    """Decisions and scales of the strips of tiles ``tile`` (N, E, D):
    (det (N, nst, S, D), sc (N, nst, S, D), t_idx (nst, S)).  ``sem``:
    "float" (float32 map), "int" (int32 map in int) or "intinfloat" (an
    int32 tile held in float32, the integer semantics)."""
    hr, hd, gr, gd = (cfar.halo_range, cfar.halo_doppler, cfar.guard_range,
                      cfar.guard_doppler)
    D = tile.shape[-1]
    nst = -(-rows // S)
    t_idx = np.minimum(np.arange(nst) * S, rows - S)[:, None] + np.arange(S)

    def at(x, r_idx, dd):
        """x[:, r_idx, d + dd]: (N, nst, S, D)."""
        return x[:, r_idx][..., (np.arange(D) + dd) % D]

    def walk():
        for dd in range(-hd, hd + 1):
            for dr in range(2 * hr + 1):
                if abs(dd) <= gd and hr - gr <= dr <= hr + gr:
                    continue
                yield at(tile, t_idx + dr, dd)

    cut = at(tile, t_idx + hr, 0)
    flt = sem != "int"
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        if so:
            sc = np.full(cut.shape, so, dtype=np.int64)
        elif sc_given is not None:
            sc = sc_given[:, t_idx].astype(np.int64)
        else:
            if sem == "float":
                full = np.full(cut.shape, np.float32(-0.0))
                guard = np.full(cut.shape, np.float32(-0.0))
            else:
                full = np.zeros(cut.shape, np.int64)
                guard = np.zeros(cut.shape, np.int64)
            acc = ((lambda x: x) if sem == "float" else
                   (lambda x: x.astype(np.int64)))
            for dd in range(-hd, hd + 1):
                full = full + acc(at(cs_f, t_idx, dd))
            for dd in range(-gd, gd + 1):
                guard = guard + acc(at(cs_g, t_idx, dd))
            total = full - guard
            if sem == "float":
                mean = total / np.float32(n_ref)
                t_hi, t_lo = np.float32(1.5) * mean, np.float32(0.5) * mean
            else:
                mean = _wrap32(total).astype(np.int64) // n_ref
                t_hi, t_lo = _wrap32(mean + (mean >> 1)), _wrap32(mean >> 1)
                if sem == "intinfloat":
                    t_hi, t_lo = t_hi.astype(np.float32), t_lo.astype(
                        np.float32)
            if flt and packed:
                c = np.zeros(cut.shape, np.float32)
                for v in walk():
                    c = (c + np.float32(4096) * (v > t_hi)).astype(np.float32)
                    c = (c + (v >= t_lo)).astype(np.float32)
                ci = c.astype(np.int64)
                hi, lo = ci >> 12, ci & 4095
            elif flt:
                hi = np.zeros(cut.shape, np.float32)
                lo = np.zeros(cut.shape, np.float32)
                for v in walk():
                    hi = (hi + (v > t_hi)).astype(np.float32)
                    lo = (lo + (v >= t_lo)).astype(np.float32)
                hi, lo = hi.astype(np.int64), lo.astype(np.int64)
            else:
                hi = np.zeros(cut.shape, np.int64)
                lo = np.zeros(cut.shape, np.int64)
                for v in walk():
                    hi += v > t_hi
                    lo += v >= t_lo
                if packed:
                    c = hi * 65536 + lo
                    hi, lo = c >> 16, c & 0xFFFF
            sc = np.where(hi >= k, cfar.scale_max,
                          np.where(lo < k, cfar.scale_min, cfar.scale_nom))
        if sem == "float":
            scf = sc.astype(np.float32)
            ti = (cut / scf).view(np.uint32)
            q = (ti + np.uint32(1)).view(np.float32)
            for delta in (0, 1, 2):
                cand = (ti - np.uint32(delta)).view(np.float32)
                q = np.where(cand * scf >= cut, cand, q)
        else:
            ci = cut.astype(np.int64)
            q = _wrap32(np.floor_divide(_wrap32(ci - 1), sc) + 1)
            if sem == "intinfloat":
                q = q.astype(np.float32)
        cnt = np.zeros(cut.shape, np.int64)
        for v in walk():
            cnt += v >= q
    det = np.where((cnt < k) & (cut > 0), cut, 0)
    return det, sc, t_idx


def _colsums(tile, cfar, rows, zero):
    """Full and guard column sums of the decided rows, rows ascending from
    -0 (float) or 0 (int32, wrapping); a one-row window's are its rows."""
    hr, gr = cfar.halo_range, cfar.guard_range
    if hr == 0:
        return tile[:, :rows], tile[:, :rows]
    f = np.full(tile[:, :rows].shape, zero)
    g = np.full(tile[:, :rows].shape, zero)
    with np.errstate(invalid="ignore", over="ignore"):
        for i in range(2 * hr + 1):
            f = f + tile[:, i:i + rows]
            if hr - gr <= i <= hr + gr:
                g = g + tile[:, i:i + rows]
    return f, g


def model_cfar_detect(m: np.ndarray, so: int, cfar, *, scale_map=None,
                      prepadded: bool = False, pgr: int = -1,
                      T: int | None = None, strip: int | None = None,
                      packed: bool | None = None, float_tiles: str = "plan",
                      halo_decisions: bool = True):
    """(det, scale) of the kernel's plan on (B, R, D) numpy maps ((B, R + 2
    hr, D) with ``prepadded``), and (det, scale, row_max, n_dets) with
    ``pgr >= 0``.  T / strip / packed default to the wrapper's config.
    Mutations: ``float_tiles="all"`` counts every int32 tile in float,
    ``halo_decisions=False`` groups with the halo rows' decisions zeroed."""
    integer = m.dtype != np.float32
    B, R_in, D = m.shape
    hr = cfar.halo_range
    R = R_in - 2 * hr if prepadded else R_in
    block = scale_map is not None
    cfg = CD.detect_config(B, R, D, cfar, so, integer, prepadded, block, pgr)
    T = cfg.T if T is None else T
    S = cfg.strip if strip is None else strip
    packed = bool(cfg.packed) if packed is None else packed
    pg = max(pgr, 0)
    H = hr + pg
    E = T + 2 * H
    rows = T + 2 * pg
    nblk = -(-R // T)

    # 1. The tiles: (B * nblk, E, D).
    r0s = np.arange(nblk) * T
    if prepadded:
        rix = (r0s[:, None] + np.arange(E)) % R_in
    else:
        rix = (r0s[:, None] - H + np.arange(E)) % R
    tile = m[:, rix].reshape(B * nblk, E, D)
    sc_given = None
    if block:
        srow = (r0s[:, None] - pg + np.arange(rows)) % R
        sc_given = np.asarray(scale_map)[:, srow].reshape(B * nblk, rows, D)
    args = (so, cfar, cfg.k, cfg.n_ref, S, rows, packed)
    if not integer:
        f, g = _colsums(tile, cfar, rows, np.float32(-0.0))
        det, sc, t_idx = _decide(tile, f, g, sc_given, *args,
                                 sem="float")
    else:
        f, g = _colsums(tile, cfar, rows, np.int32(0))
        det, sc, t_idx = _decide(tile, f, g, sc_given, *args,
                                 sem="int")
        # 2. Tiles within float_max (strips of 8, packed) count in float.
        fits = (np.abs(tile.astype(np.int64)) <= cfg.float_max).all(
            axis=(1, 2))
        if float_tiles == "all":
            fits[:] = True
        if S == 8 and packed and fits.any():
            ft = tile[fits].astype(np.float32)
            ff, fg = _colsums(ft, cfar, rows, np.float32(-0.0))
            fdet, fsc, _ = _decide(
                ft, ff, fg, None if sc_given is None else sc_given[fits],
                *args,
                sem="intinfloat")
            det[fits] = fdet.astype(np.int64).astype(det.dtype)
            sc[fits] = fsc
    det = det.astype(m.dtype).reshape(B, nblk, *det.shape[1:])
    sc = sc.reshape(B, nblk, *sc.shape[1:])

    # 3. The decided rows of each block, (B, nblk, rows, D); cells decided
    #    twice agree.
    dec = np.zeros((B, nblk, rows, D), m.dtype)
    dsc = np.full((B, nblk, rows, D), -1, np.int64)
    for st in range(t_idx.shape[0]):
        for s in range(S):
            i = t_idx[st, s]
            if (dsc[:, :, i] >= 0).any():
                assert np.array_equal(_bits(dec[:, :, i]),
                                      _bits(det[:, :, st, s]))
                assert np.array_equal(dsc[:, :, i], sc[:, :, st, s])
            dec[:, :, i], dsc[:, :, i] = det[:, :, st, s], sc[:, :, st, s]
    assert (dsc >= 0).all()

    # 4. Stores of the rows below R (and grouping).
    out_det = np.zeros((B, R, D), m.dtype)
    out_sc = np.full((B, R, D), -1, np.int32)
    if pgr >= 0 and not halo_decisions:
        dec[:, :, :pg] = 0
        dec[:, :, pg + T:] = 0
    for blk in range(nblk):
        n_out = min(T, R - blk * T)
        own = slice(blk * T, blk * T + n_out)
        out_sc[:, own] = dsc[:, blk, pg:pg + n_out]
        d_s = dec[:, blk]
        mine = d_s[:, pg:pg + n_out]
        if pgr > 0:
            keep = mine > 0
            t = np.arange(n_out)[:, None]
            col = np.arange(D)[None, :]
            ids = ((blk * T + t) % R) * D + col
            for dr in range(-pgr, pgr + 1):
                for dd in range(-pgr, pgr + 1):
                    if dr == 0 and dd == 0:
                        continue
                    v = d_s[:, pg + dr:pg + dr + n_out][..., (col[0] + dd) % D]
                    nid = ((blk * T + t + dr) % R) * D + (col + dd) % D
                    keep &= ~((v > mine) | ((v == mine) & (nid < ids)))
            mine = np.where(keep, mine, 0).astype(m.dtype)
        out_det[:, own] = mine
    assert (out_sc >= 0).all()
    if pgr < 0:
        return out_det, out_sc
    row_max = np.where(out_det > 0, out_det, 0).max(axis=-1).astype(m.dtype)
    n_dets = (out_det > 0).sum(axis=(-2, -1)).astype(np.int32)
    return out_det, out_sc, row_max, n_dets


def _twin(m, so, cfar, scale_map=None, prepadded=False, pgr=-1):
    sm = None if scale_map is None else torch.as_tensor(scale_map)
    if pgr < 0:
        out = CD.cfar_detect(torch.as_tensor(m), so, cfar=cfar, scale_map=sm,
                             prepadded_range=prepadded)
    else:
        out = CD.cfar_detect_group(torch.as_tensor(m), so, cfar=cfar,
                                   scale_map=sm, peak_group_radius=pgr)
    return tuple(x.numpy() for x in out)


def _equal(model, twin) -> bool:
    return len(model) == len(twin) and all(
        np.array_equal(_bits(a) if a.dtype == np.float32 else a,
                       _bits(b) if b.dtype == np.float32 else b)
        for a, b in zip(model, twin))


def _noise(shape, integer: bool, seed: int) -> np.ndarray:
    """Exponential noise with a band of bright cells, plateaus of equal
    values and a few strong targets."""
    rng = np.random.default_rng(seed)
    m = rng.exponential(500.0, shape)
    m[..., 5:9, :] *= np.where(rng.random(m[..., 5:9, :].shape) < 0.3,
                               30.0, 1.0)
    m[..., 20:26, 2:9] = 700.0
    for f in m.reshape(-1, *shape[-2:]):
        f[rng.integers(0, shape[-2]), rng.integers(0, shape[-1])] = 4e4
    return m.astype(np.int32) if integer else m.astype(np.float32)


def _mixed_int(shape, seed: int) -> np.ndarray:
    """int32 noise whose rows 60..63 of each map hold values near 2^31
    (the tiles that reach them count in int, the others in float)."""
    m = _noise(shape, True, seed)
    rng = np.random.default_rng(seed + 1)
    band = m[..., 60:64, :]
    big = rng.integers(2 ** 30, 2 ** 31 - 1, band.shape)
    m[..., 60:64, :] = np.where(rng.random(band.shape) < 0.5, big, band)
    return m


def _scale_map(shape, cfar, seed):
    rng = np.random.default_rng(seed)
    return rng.choice([cfar.scale_min, cfar.scale_nom, cfar.scale_max],
                      shape).astype(np.int32)


DTYPES = {"float": False, "int32": True}


@pytest.mark.parametrize("so", [0, 4])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("R", [37, 6, 100])
@pytest.mark.parametrize("window", list(WINDOWS))
def test_model_equals_twin(window, R, dtype, so):
    """Per-cell scale, whole maps: odd R (a last block past R), R below
    the strip (T = 8 > R), R over one block."""
    cfar = WINDOWS[window]
    m = _noise((2, R, 16), DTYPES[dtype], 10 + R)
    got = model_cfar_detect(m, so, cfar)
    assert _equal(got, _twin(m, so, cfar))
    if R > 6:
        assert (got[0] > 0).sum() > 0
        if so == 0:
            assert len(np.unique(got[1])) >= 2


@pytest.mark.parametrize("so", [0, 4])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("window", list(WINDOWS))
def test_model_block_scale_equals_twin(window, dtype, so):
    """A given scale map (the block scale), R = 37 and 100."""
    cfar = dataclasses.replace(WINDOWS[window], scale_mode="block")
    for R in (37, 100):
        m = _noise((2, R, 16), DTYPES[dtype], 20 + R)
        smap = _scale_map(m.shape, cfar, R)
        got = model_cfar_detect(m, so, cfar, scale_map=smap)
        assert _equal(got, _twin(m, so, cfar, scale_map=smap))
        assert (got[0] > 0).sum() > 0


@pytest.mark.parametrize("so", [0, 4])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("window", list(WINDOWS))
def test_model_adversarial_equals_twin(window, dtype, so):
    """NaN, +-Inf, -0.0, negative values, denormals, ties at the k-th value,
    int keys beyond 2^16 and down to -2^31 (every int32 tile counts in
    int); per-cell and grouped."""
    cfar = WINDOWS[window]
    m = rank_adversarial_maps((2, 64, 32), DTYPES[dtype], 30 + so)
    assert _equal(model_cfar_detect(m, so, cfar), _twin(m, so, cfar))
    got = model_cfar_detect(m, so, cfar, pgr=2)
    assert _equal(got, _twin(m, so, cfar, pgr=2))
    assert (got[0] > 0).sum() > 0


@pytest.mark.parametrize("pgr", [0, 1, 2])
@pytest.mark.parametrize("mode", ["cell", "block"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_model_grouping_equals_twin(dtype, mode, pgr):
    """The grouping entry: halo rows decided for pgr 0, 1, 2; grouped det,
    scale, row maxima and counts against cfar_2d, peak_group and the
    twin's reductions, on R = 37 (a last block past R) and 100."""
    for R in (37, 100):
        m = _noise((2, R, 32), DTYPES[dtype], 40 + R + pgr)
        cfar = dataclasses.replace(FULL, scale_mode=mode)
        smap = _scale_map(m.shape, cfar, R) if mode == "block" else None
        got = model_cfar_detect(m, 0, cfar, scale_map=smap, pgr=pgr)
        assert _equal(got, _twin(m, 0, cfar, scale_map=smap, pgr=pgr))
        assert got[3].min() > 0


@pytest.mark.parametrize("pgr", [-1, 2])
@pytest.mark.parametrize("so", [0, 4])
def test_model_int32_tiles_beyond_float(so, pgr):
    """int32 maps with values near 2^31 in rows 60..63 only: the tiles that
    reach them count in int, the others in float; both equal the twin."""
    m = _mixed_int((2, 256, 16), 50)
    cfg = CD.detect_config(2, 256, 16, FULL, so, True, pgr=pgr)
    r0 = np.arange(-(-256 // cfg.T)) * cfg.T
    H = FULL.halo_range + max(pgr, 0)
    reach = [((np.arange(r - H, r + cfg.T + H) % 256) // 4 == 15).any()
             for r in r0]
    assert any(reach) and not all(reach)
    got = model_cfar_detect(m, so, FULL, pgr=pgr)
    assert _equal(got, _twin(m, so, FULL, pgr=pgr))
    assert (got[0] > 0).sum() > 0


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("sp", [2, 4])
def test_model_prepadded_equals_twin_and_whole_map(sp, dtype):
    """Range shards with their neighbours' halo rows (per-cell, and a
    given block scale map): equal to the twin's prepadded entry and to the
    whole map's rows."""
    m = rank_adversarial_maps((2, 96, 16), DTYPES[dtype], 60 + sp)
    hr = FULL.halo_range
    rl = 96 // sp
    block = dataclasses.replace(FULL, scale_mode="block")
    smap = _scale_map(m.shape, block, sp)
    for cfar, sm in ((FULL, None), (block, smap)):
        whole = model_cfar_detect(m, 0, cfar, scale_map=sm)
        for s in range(sp):
            idx = np.arange(s * rl - hr, (s + 1) * rl + hr) % 96
            shard = np.ascontiguousarray(m[:, idx])
            ssm = None if sm is None else sm[:, s * rl:(s + 1) * rl]
            got = model_cfar_detect(shard, 0, cfar, scale_map=ssm,
                                    prepadded=True)
            assert _equal(got, _twin(shard, 0, cfar, scale_map=ssm,
                                     prepadded=True))
            assert _equal(got, (whole[0][:, s * rl:(s + 1) * rl],
                                whole[1][:, s * rl:(s + 1) * rl]))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("T,strip", [(8, 8), (12, 8), (24, 8), (64, 8),
                                     (5, 1), (1, 1)])
def test_model_tile_geometries_equal_twin(T, strip, dtype):
    """Every block and strip geometry the kernel takes: T a multiple of 8,
    T with an overlapping last strip (12), a last block past R (24, 64 on
    40 rows), strips of one cell (T < 8); grouped too."""
    m = _noise((1, 40, 16), DTYPES[dtype], 70 + T)
    packed = False if strip == 1 else None
    assert _equal(model_cfar_detect(m, 0, FULL, T=T, strip=strip,
                                    packed=packed), _twin(m, 0, FULL))
    assert _equal(model_cfar_detect(m, 0, FULL, pgr=2, T=T, strip=strip,
                                    packed=packed), _twin(m, 0, FULL, pgr=2))


def _flat(shape, integer: bool, seed: int) -> np.ndarray:
    """Values within 0.1% of one level, a few strong cells: lo counts
    every training value (lo = n_ref)."""
    rng = np.random.default_rng(seed)
    m = 1000.0 + rng.random(shape)
    for f in m.reshape(-1, *shape[-2:]):
        f[rng.integers(0, shape[-2]), rng.integers(0, shape[-1])] = 3e4
    return np.round(m).astype(np.int32) if integer else m.astype(np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_model_large_training_set(dtype):
    """n_ref = 4216 > 4094: hi and lo counted apart (float and int)."""
    integer = DTYPES[dtype]
    cfg = CD.detect_config(2, 64, 64, LARGE, 0, integer)
    assert cfg.n_ref == 4216 and cfg.strip == 8 and cfg.packed == 0
    for m in (_noise((2, 64, 64), integer, 80), _flat((2, 64, 64), integer,
                                                      81)):
        got = model_cfar_detect(m, 0, LARGE)
        assert _equal(got, _twin(m, 0, LARGE))
        assert (got[0] > 0).sum() > 0


@pytest.mark.parametrize("mutation", ["packed-above-4094",
                                      "float-beyond-float-max",
                                      "no-halo-decisions"])
def test_mutations_disagree(mutation):
    """The model fails when it packs hi and lo for more than 4094 training
    cells (lo overflows into hi's field), counts an int32 tile in float
    beyond float_max, or groups without the halo rows' decisions."""
    if mutation == "packed-above-4094":
        m, cfar, kw, pgr = _flat((2, 64, 64), False, 81), LARGE, {
            "packed": True}, -1
    elif mutation == "float-beyond-float-max":
        m, cfar, kw, pgr = _mixed_int((2, 256, 16), 50), FULL, {
            "float_tiles": "all"}, -1
    else:
        # Two bright cells astride the blocks' seam (T = 60): the lower one
        # is grouped away by a decision of the next block's rows.
        m, cfar, kw, pgr = _noise((2, 100, 32), False, 42), FULL, {
            "halo_decisions": False}, 2
        assert CD.detect_config(2, 100, 32, cfar, pgr=2).T == 60
        m[:, 59, 10], m[:, 60, 10] = 3e4, 4e4
    want = _twin(m, 0, cfar, pgr=pgr)
    assert _equal(model_cfar_detect(m, 0, cfar, pgr=pgr), want)
    assert not _equal(model_cfar_detect(m, 0, cfar, pgr=pgr, **kw), want)


def _parent_takes(R, D, hr) -> bool:
    """The parent kernel's rule (ops/cfar_detect.tile_rows before the
    redesign): T a power of two dividing R, halved until (T + 2 hr) D 4
    bytes fit 96 KB; it took the map when one row did."""
    return (1 + 2 * hr) * D * 4 <= 96 * 1024


def test_tile_plan_takes_every_configuration_the_parent_took():
    """Across map sizes and windows, per-cell and a scale map: wherever the
    parent kernel took the map (and beyond: the new kernel takes tiles up
    to 227 KB), the plan gives whole rows (W = D) in a tile that fits 227
    KB, with strips of 8 where 8 rows fit and T at least 8 then; the
    defaults are T = 32 (per-cell), 28 (grouped, radius 2) and 64 (a scale
    map), packed, three blocks an SM.  Where whole rows do not fit, the map
    is cut into column chunks (25 rows of 24576 columns: W < D); a window
    whose one row of a 32-column chunk passes 227 KB is refused."""
    taken = 0
    for R in (1, 6, 7, 8, 37, 64, 100, 1000, 1024, 4096):
        for D in (8, 16, 128, 1024, 4096, 8192, 24576):
            for hr in (0, 1, 3, 6, 12, 40):
                for block in (False, True):
                    if not _parent_takes(R, D, hr):
                        continue
                    taken += 1
                    T, strip, W = CD.tile_plan(R, D, hr, 0, -1, block)
                    assert W == D
                    assert CD.tile_bytes(T, D, hr, -1, block) <= 227 * 1024
                    eight = CD.tile_bytes(8, D, hr, -1, block) <= 227 * 1024
                    assert (strip, T >= 8) == ((8, True) if eight
                                               else (1, False))
    assert taken > 500
    assert CD.tile_plan(1024, 24576, 12, 5)[2] < 24576  # 25 rows: chunks
    with pytest.raises(NotImplementedError):        # 2001 rows of 32 + 2 hd
        CD.tile_plan(4096, 24576, 1000, 5)
    for pgr, block, T in ((-1, False, 32), (2, False, 28), (-1, True, 64)):
        cfg = CD.detect_config(128, 1024, 128, FULL, 0, True, block=block,
                               pgr=pgr)
        assert (cfg.T, cfg.strip, cfg.packed, cfg.n_ref) == (T, 8, 1, 128)
        assert 3 * CD.tile_bytes(T, 128, 6, pgr, block) <= 227 * 1024
    assert CD.float_max(FULL) == (1 << 24) // 13 >= 45056
