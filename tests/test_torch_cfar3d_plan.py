"""A numpy model of the 3D CFAR kernel's plan
(fmcw_tpu_torch/csrc/cfar_3d_detect.cu: strips of cells counted in float),
held bit for bit against its plain twin ``ops/cfar.cfar_3d`` (which
tests/test_torch_cfar3d.py holds against JAX's XLA body and JAX's
interpret-mode kernel) on the CPU.

The kernel runs only on the card; its arithmetic is modelled here step by
step, with the block and strip geometry that ``ops/cfar3d_detect.
cfar3d_config`` hands it (or another one, to cover every geometry the
kernel takes):

* blocks of T range rows from r0 = block * T; the tile holds the 2 ha + 1
  beam planes' rows r0 - hr .. r0 + T + hr - 1, rows wrapped modulo R,
  planes wrapped modulo A (a prepadded shard: its carried planes in
  order); rows of the last block past R are decided and not stored;
* column sums of each plane over the window's 2 hr + 1 rows, rows
  ascending from -0 (float32, or int32 wrapping);
* strips of S cells of one column (S = 8, or 1 when T < 8), strip st at
  tile row i0 = min(st S, T - S): the last strip overlaps its neighbour
  when S does not divide T, and its cells are decided twice, alike;
* per cell the training-set sum in the twin's order: planes ascending, the
  column sums added dd ascending; then each guard cell of the |da| <= ga
  planes subtracted, dd outer, dr inner; the thresholds 1.5 / 0.5 x mean
  (integer: floor mean, mean + (mean >> 1), mean >> 1);
* the walks: for each plane, each window column dd ascending, rows dr
  ascending, the guard rows of the guard columns left out on the guard
  planes only; hi and lo counted in float (1.0 / 0.0 compares, the adds
  rounded to float32) packed as hi * 4096 + lo while n_ref <= 4094, else
  in two counts; integer cubes in int, packed as hi * 65536 + lo while
  n_ref <= 32767;
* the float q (the smallest float32 whose rounded product with the scale
  reaches the CUT, probed over the patterns within two ulps below
  RN(cut / scale)) and the integer q = floor((cut - 1) / scale) + 1; det =
  CUT where count(refs >= q) < k and CUT > 0; a scale override skips the
  hi/lo pass.

Cubes: seeded noise with bright cells and plateaus; and
``golden.reference.rank_adversarial_maps`` (NaN, +-Inf, -0.0, negative
values, denormals, ties at the k-th value, int keys beyond 2^16 and down to
-2^31).  A mutation check shows that the model with hi and lo packed above
4094 training cells, or with the guard box left out of every plane's walk,
disagrees with the twin.
"""

import dataclasses

import numpy as np
import pytest
import torch

import fmcw_tpu_torch as P
from fmcw_tpu_torch.golden.reference import rank_adversarial_maps
from fmcw_tpu_torch.ops import cfar as C, cfar3d_detect as C3
from test_torch_rank_plan import reflect_idx

torch.set_num_threads(2)

FULL = P.RadarParams().cfar
QUICK = P.quick().cfar
WINDOWS = {"full": FULL, "quick": QUICK}


def _wrap32(x: np.ndarray) -> np.ndarray:
    return x.astype(np.int64).astype(np.int32)


def model_cfar3d(cube: np.ndarray, so: int, cfar, ra: int, ga: int,
                 prepadded: bool = False, *, T: int | None = None,
                 strip: int | None = None, packed: bool | None = None,
                 guard_everywhere: bool = False,
                 wrap_columns: bool = False):
    """(det, scale) of the kernel's plan on a (B, A, R, D) numpy cube
    (A + 2 ha planes with ``prepadded``).  T / strip / packed default to
    the wrapper's config; ``guard_everywhere`` is a mutation.  With
    ``cfar.edge_mode == "reflect"`` the reflect entry's plan: planes
    reflect(a - ha + p) (a prepadded shard's a + p), rows reflect(r0 - hr
    + e), each tile row carrying its mirrored column halo (tile column j =
    column reflect(j - hd), pitch D + 2 hd), column sums over every column
    and the window columns read unwrapped; ``wrap_columns`` is its
    mutation, a wrapped column halo."""
    integer = cube.dtype != np.float32
    reflect = cfar.edge_mode == "reflect"
    cfg = C3.cfar3d_config(cube.shape, cfar, ra, ga, so, integer, prepadded)
    assert cfg.reflect == int(reflect)
    T = cfg.T if T is None else T
    S = cfg.strip if strip is None else strip
    packed = bool(cfg.packed) if packed is None else packed
    n_ref, k = cfg.n_ref, cfg.k
    hr, hd, gr, gd = (cfar.halo_range, cfar.halo_doppler, cfar.guard_range,
                      cfar.guard_doppler)
    B, _, R, D = cube.shape
    A, ha = cfg.A, cfg.ha
    npl = 2 * ha + 1
    E = T + 2 * hr
    nblk = -(-R // T)
    zero = np.int32(0) if integer else np.float32(-0.0)

    # 1. The tiles: (B, A, block, plane, tile row, P).
    fold = ((lambda i, n: reflect_idx(i, n)) if reflect
            else (lambda i, n: np.asarray(i) % n))
    rows = fold(np.arange(nblk)[:, None] * T - hr + np.arange(E), R)
    planes = np.arange(A)[:, None] + np.arange(npl)
    if not prepadded:
        planes = fold(planes - ha, A)
    tile = cube[:, planes[:, None, :, None], rows[None, :, None, :], :]
    off = 0
    if reflect:
        cols = np.arange(-hd, D + hd)
        tile = tile[..., cols % D if wrap_columns else reflect_idx(cols, D)]
        off = hd
    # 2. Column sums, rows ascending.
    cs = np.full(tile[..., :T, :].shape, zero)
    with np.errstate(invalid="ignore", over="ignore"):
        for i in range(2 * hr + 1):
            cs = cs + tile[..., i:i + T, :]
    # 3. Strips: decided tile rows t = i0 + s, (nst, S).
    nst = -(-T // S)
    t_idx = np.minimum(np.arange(nst) * S, T - S)[:, None] + np.arange(S)

    def at(x, p, r_idx, dd):
        """x[..., p, r_idx, d + dd]: (B, A, block, nst, S, D); the tile
        columns of a reflect tile unwrapped."""
        c = np.arange(D) + dd
        return x[:, :, :, p][:, :, :, r_idx][..., off + c if reflect
                                              else c % D]

    def gplane(p):
        return guard_everywhere or ha - ga <= p <= ha + ga

    def walk():
        for p in range(npl):
            for dd in range(-hd, hd + 1):
                for dr in range(2 * hr + 1):
                    if (gplane(p) and abs(dd) <= gd
                            and hr - gr <= dr <= hr + gr):
                        continue
                    yield at(tile, p, t_idx + dr, dd)

    cut = at(tile, ha, t_idx + hr, 0)
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        if so:
            sc = np.full(cut.shape, so, dtype=np.int64)
        else:
            total = np.full(cut.shape, zero)
            for p in range(npl):
                for dd in range(-hd, hd + 1):
                    total = total + at(cs, p, t_idx, dd)
            for p in range(ha - ga, ha + ga + 1):
                for dd in range(-gd, gd + 1):
                    for dr in range(-gr, gr + 1):
                        total = total - at(tile, p, t_idx + hr + dr, dd)
            if integer:
                mean = total.astype(np.int64) // n_ref
                t_hi, t_lo = _wrap32(mean + (mean >> 1)), _wrap32(mean >> 1)
            else:
                mean = total / np.float32(n_ref)
                t_hi, t_lo = np.float32(1.5) * mean, np.float32(0.5) * mean
            if integer:
                hi = np.zeros(cut.shape, np.int64)
                lo = np.zeros(cut.shape, np.int64)
                for v in walk():
                    hi += v > t_hi
                    lo += v >= t_lo
                if packed:
                    c = hi * 65536 + lo
                    assert c.max() < 2 ** 31
                    hi, lo = c >> 16, c & 0xFFFF
            elif packed:
                c = np.zeros(cut.shape, np.float32)
                for v in walk():
                    c = (c + np.float32(4096) * (v > t_hi)).astype(np.float32)
                    c = (c + (v >= t_lo)).astype(np.float32)
                ci = c.astype(np.int64)
                hi, lo = ci >> 12, ci & 4095
            else:
                hi = np.zeros(cut.shape, np.float32)
                lo = np.zeros(cut.shape, np.float32)
                for v in walk():
                    hi = (hi + (v > t_hi)).astype(np.float32)
                    lo = (lo + (v >= t_lo)).astype(np.float32)
                hi, lo = hi.astype(np.int64), lo.astype(np.int64)
            sc = np.where(hi >= k, cfar.scale_max,
                          np.where(lo < k, cfar.scale_min, cfar.scale_nom))
        if integer:
            q = _wrap32(np.floor_divide(_wrap32(cut.astype(np.int64) - 1),
                                        sc) + 1)
        else:
            scf = sc.astype(np.float32)
            ti = (cut / scf).view(np.uint32)
            q = (ti + np.uint32(1)).view(np.float32)
            for delta in (0, 1, 2):
                cand = (ti - np.uint32(delta)).view(np.float32)
                q = np.where(cand * scf >= cut, cand, q)
        cnt = np.zeros(cut.shape, np.int64)
        for v in walk():
            cnt += v >= q
    det = np.where((cnt < k) & (cut > 0), cut, 0).astype(cube.dtype)
    # 4. Stores: the cells of rows below R; cells decided twice agree.
    out_det = np.zeros((B, A, R, D), cube.dtype)
    out_sc = np.full((B, A, R, D), -1, np.int32)
    for blk in range(nblk):
        for st in range(nst):
            for s in range(S):
                r = blk * T + t_idx[st, s]
                if r >= R:
                    continue
                d_new, s_new = det[:, :, blk, st, s], sc[:, :, blk, st, s]
                if (out_sc[:, :, r] >= 0).any():
                    assert np.array_equal(_bits(out_det[:, :, r]),
                                          _bits(d_new))
                    assert np.array_equal(out_sc[:, :, r], s_new)
                out_det[:, :, r], out_sc[:, :, r] = d_new, s_new
    assert (out_sc >= 0).all()
    return out_det, out_sc


def _bits(x: np.ndarray) -> np.ndarray:
    return x.view(np.int32)


def _twin(cube, so, cfar, ra, ga, prepadded=False):
    det, scale = C3.cfar3d_detect(torch.as_tensor(cube), so, cfar=cfar,
                                  ref_angle=ra, guard_angle=ga,
                                  prepadded_angle=prepadded)
    return det.numpy(), scale.numpy()


def _equal(model, twin) -> bool:
    return (np.array_equal(_bits(model[0]), _bits(twin[0]))
            and np.array_equal(model[1], twin[1]))


def _noise(shape, integer: bool, seed: int) -> np.ndarray:
    """Exponential noise with a band of bright cells, plateaus of equal
    values and a few strong targets."""
    rng = np.random.default_rng(seed)
    m = rng.exponential(500.0, shape)
    m[..., 5:9, :] *= np.where(rng.random(m[..., 5:9, :].shape) < 0.3,
                               30.0, 1.0)
    m[..., 20:26, 2:9] = 700.0
    flat = m.reshape(-1, *shape[-2:])
    for f in flat:
        f[rng.integers(0, shape[-2]), rng.integers(0, shape[-1])] = 4e4
    return m.astype(np.int32) if integer else m.astype(np.float32)


DTYPES = {"float": False, "int32": True}


@pytest.mark.parametrize("so", [0, 4])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("beams", [4, 8, 16])
@pytest.mark.parametrize("ra,ga", [(1, 0), (2, 1)])
@pytest.mark.parametrize("window", list(WINDOWS))
def test_model_equals_twin(window, ra, ga, beams, dtype, so):
    cube = _noise((2, beams, 32, 16), DTYPES[dtype], 10 + beams + ra)
    cfar = WINDOWS[window]
    got = model_cfar3d(cube, so, cfar, ra, ga)
    assert _equal(got, _twin(cube, so, cfar, ra, ga))
    assert (got[0] > 0).sum() > 0
    if so == 0:
        assert len(np.unique(got[1])) >= 2


@pytest.mark.parametrize("so", [0, 4])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("window", list(WINDOWS))
def test_model_adversarial_equals_twin(window, dtype, so):
    """NaN, +-Inf, -0.0, negative values, denormals, ties at the k-th value,
    int keys beyond 2^16 and down to -2^31."""
    cfar = WINDOWS[window]
    cube = rank_adversarial_maps((2, 8, 32, 16), DTYPES[dtype], 20 + so)
    for ra, ga in ((1, 0), (2, 1)):
        got = model_cfar3d(cube, so, cfar, ra, ga)
        assert _equal(got, _twin(cube, so, cfar, ra, ga))
        assert (got[0] > 0).sum() > 0


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("T,strip", [(8, 8), (12, 8), (24, 8), (40, 8),
                                     (64, 8), (5, 1), (1, 1)])
def test_model_tile_geometries_equal_twin(T, strip, dtype):
    """Every block and strip geometry the kernel takes: T a multiple of 8,
    T with an overlapping last strip (12), a last block past R (24, 64
    on 40 rows), strips of one cell (T < 8)."""
    cube = _noise((1, 4, 40, 16), DTYPES[dtype], 30 + T)
    want = _twin(cube, 0, FULL, 1, 0)
    assert _equal(model_cfar3d(cube, 0, FULL, 1, 0, T=T, strip=strip,
                               packed=False if strip == 1 else None), want)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("sp", [2, 4])
def test_model_prepadded_equals_twin_and_whole_cube(sp, dtype):
    """Beam shards with their ring neighbours' planes: equal to the twin's
    prepadded entry and to the whole cube's interior planes."""
    cube = rank_adversarial_maps((2, 8, 32, 16), DTYPES[dtype], 40 + sp)
    whole = model_cfar3d(cube, 0, FULL, 1, 0)
    bl = 8 // sp
    for s in range(sp):
        idx = np.arange(s * bl - 1, (s + 1) * bl + 1) % 8
        shard = np.ascontiguousarray(cube[:, idx])
        got = model_cfar3d(shard, 0, FULL, 1, 0, prepadded=True)
        assert _equal(got, _twin(shard, 0, FULL, 1, 0, prepadded=True))
        assert _equal(got, (whole[0][:, s * bl:(s + 1) * bl],
                            whole[1][:, s * bl:(s + 1) * bl]))


def _flat(shape, integer: bool, seed: int) -> np.ndarray:
    """Values within 0.1% of one level, a few strong cells: lo counts
    every training value (lo = n_ref)."""
    rng = np.random.default_rng(seed)
    m = 1000.0 + rng.random(shape)
    flat = m.reshape(-1, *shape[-2:])
    for f in flat:
        f[rng.integers(0, shape[-2]), rng.integers(0, shape[-1])] = 3e4
    return np.round(m).astype(np.int32) if integer else m.astype(np.float32)


@pytest.mark.parametrize("so", [0, 4])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_model_large_training_set(dtype, so):
    """ref_angle 14 on a 4-beam cube at 32 x 16: 29 planes (each beam seen
    7 or 8 times), n_ref = 4132 > 4094, so a float cube counts hi and lo
    apart; an int32 cube still packs them."""
    integer = DTYPES[dtype]
    cfg = C3.cfar3d_config((2, 4, 32, 16), FULL, 14, 0, so, integer)
    assert cfg.n_ref == 4132 and cfg.strip == 8
    assert cfg.packed == int(integer)
    for cube in (_noise((2, 4, 32, 16), integer, 50),
                 _flat((2, 4, 32, 16), integer, 51)):
        got = model_cfar3d(cube, so, FULL, 14, 0)
        assert _equal(got, _twin(cube, so, FULL, 14, 0))
        assert (got[0] > 0).sum() > 0


@pytest.mark.parametrize("mutation", ["packed-above-4094",
                                      "guard-on-every-plane"])
def test_mutations_disagree(mutation):
    """The model fails when it packs hi and lo for more than 4094 training
    cells (lo overflows into hi's field), or leaves the guard box out of
    every plane's walk."""
    if mutation == "packed-above-4094":
        cube = _flat((2, 4, 32, 16), False, 51)
        args, kw = (FULL, 14, 0), {"packed": True}
    else:
        cube = _noise((2, 8, 32, 16), False, 18)
        args, kw = (FULL, 1, 0), {"guard_everywhere": True}
    want = _twin(cube, 0, *args)
    assert _equal(model_cfar3d(cube, 0, *args), want)
    assert not _equal(model_cfar3d(cube, 0, *args, **kw), want)


def _parent_takes(R, D, ha, hr) -> bool:
    """The parent kernel's shared-memory rule: it took a tile of one row
    when that fit 227 KB (its T: a power of two dividing R)."""
    return (2 * ha + 1) * ((1 + 2 * hr) * D + D) * 4 <= 227 * 1024


def test_tile_plan_takes_every_configuration_the_parent_took():
    """Across map sizes, windows and beam halos: wherever the parent kernel
    took the cube, the plan gives whole rows (W = D) in a tile that fits,
    with strips of 8 when 8 rows fit and T at least 8 then; elsewhere
    column chunks (W < D, a multiple of 32) that fit, or a refusal where
    one row of a 32-column chunk does not; the default is T = 16 (three
    blocks an SM) and packed."""
    taken = 0
    for R in (1, 6, 7, 8, 37, 64, 100, 1000, 1024, 4096):
        for D in (8, 16, 128, 256, 1024):
            for ha in (1, 2, 3, 8, 14, 20):
                for hr in (1, 3, 6, 12):
                    if not _parent_takes(R, D, ha, hr):
                        if not _parent_takes(R, 32 + 2 * 5, ha, hr):
                            with pytest.raises(NotImplementedError):
                                C3.tile_plan(R, D, ha, hr, 5)
                            continue
                        T, strip, W = C3.tile_plan(R, D, ha, hr, 5)
                        assert W < D and W % 32 == 0
                        assert C3._tile_bytes(T, W + 10, ha,
                                              hr) <= 227 * 1024
                        continue
                    taken += 1
                    T, strip, W = C3.tile_plan(R, D, ha, hr, 5)
                    assert W == D
                    assert C3._tile_bytes(T, D, ha, hr) <= 227 * 1024
                    eight = C3._tile_bytes(8, D, ha, hr) <= 227 * 1024
                    assert (strip, T >= 8) == ((8, True) if eight
                                               else (1, False))
    assert taken > 500
    cfg = C3.cfar3d_config((16, 8, 1024, 128), FULL, 1, 0)
    assert (cfg.T, cfg.strip, cfg.packed, cfg.n_ref) == (16, 8, 1, 414)
    assert C3._tile_bytes(16, 128, 1, 6) == 67584
    block = dataclasses.replace(FULL, scale_mode="block")
    assert C3.cfar3d_config((1, 8, 1024, 128), block, 1, 0).T == 16
