"""A numpy model of the rank-select CFAR kernel's plan
(fmcw_tpu_torch/csrc/cfar_rank.cu: bit planes of clamped keys counted with
population counts), held bit for bit against its plain twin
``ops/cfar_rank.cfar_rank_plain`` (which tests/test_torch_cfar_rank.py holds
against JAX's interpret-mode Pallas kernel) on the CPU.

The kernel runs only on the card; its arithmetic is modelled here step by
step:

* keys: the int32 values of integer maps, the IEEE patterns of float maps;
  clamped to [0, 2^(top+1) - 1] (top = 30 for float walks, bits - 1 for
  integer walks), which keeps every ``key >= candidate`` of the walk;
* bit planes: for each walked bit, tile row and word w, the ballot of 32
  consecutive extended columns (extended column x holds column x - hd mod
  D), stored as word pairs (w, w + 1);
* a cell at column d takes pair d // 32 of each window row, funnel-shifted
  right by d % 32; its masks of keys still equal to the prefix start as the
  window's 2 hd + 1 columns, the guard columns left out on the guard rows;
  windows of at most 16 columns pack two rows' fields and masks in the 16-bit
  halves of a word (the last row of an odd window alone); per walked bit
  count = above + sum popcount(mask & field); the bit is taken when count
  >= k (mask &= field), else above = count and mask &= ~field (the kernel
  walks strips of 4 cells of a column at once, which shares the fields and
  changes no count);
* the per-cell scale from column sums (rows ascending, float32 or int) and
  box sums (columns ascending), est > 1.5 mean / est < 0.5 mean (integer:
  mean + (mean >> 1), mean >> 1); a given block scale map; the override;
  threshold = est * scale (float32, or int32 wrapping), det = CUT where CUT
  > threshold;
* the grouping entry: the decisions of the T rows and pgr rows on each
  side, a detection kept when it is the strict maximum of its (2 pgr +
  1)^2 wrapped neighbourhood (ties to the lower linear index; a
  non-positive CUT dropped with a radius), the row maxima of the kept
  positive cells (0 when none) and their count.

Maps: seeded noise at 2x64x32 and 1x40x16 with the repository's window
(13 x 11, n_ref 128), the quick window and a 13 x 19 window, and
``golden.reference.rank_adversarial_maps`` (NaN, +-Inf, -0.0, negative
floats, denormals, the largest float, plateaus of ties at the k-th value,
int keys at and above 2^16 and below 0).  A mutation check shows that the
model without the clamp, or with the guard columns counted, disagrees with
the twin.
"""

import dataclasses

import numpy as np
import pytest
import torch

import fmcw_tpu_torch as P
from fmcw_tpu_torch.golden.reference import rank_adversarial_maps
from fmcw_tpu_torch.ops import cfar as C, cfar_rank as RK

torch.set_num_threads(2)

FULL = P.RadarParams().cfar
QUICK = P.quick().cfar
# 19 Doppler columns: wider than a 16-bit half, walked a row at a time.
WIDE = P.CfarParams(ref_doppler=8)
WINDOWS = {"full": FULL, "quick": QUICK, "wide": WIDE}


def _keys(m: np.ndarray) -> np.ndarray:
    return m.view(np.int32) if m.dtype == np.float32 else m.astype(np.int32)


def reflect_idx(i, n: int) -> np.ndarray:
    """numpy's "reflect" of indices ``i`` into [0, n), periodic beyond one
    mirror (cfar_common.cuh's reflect_mod)."""
    i = np.asarray(i)
    if n == 1:
        return np.zeros_like(i)
    j = i % (2 * (n - 1))
    return np.where(j < n, j, 2 * (n - 1) - j)


def _fold(reflect: bool):
    """The kernel's index map of rows and extended columns: the wrap, or
    the reflect entry's mirror."""
    return reflect_idx if reflect else (lambda i, n: np.asarray(i) % n)


def _planes(kc: np.ndarray, bits: int, top: int, hd: int,
            reflect: bool = False) -> np.ndarray:
    """(..., rows, npair, bits, 2) uint32 word pairs of the bit planes:
    extended column x holds column x - hd mod D, or reflect(x - hd)."""
    D = kc.shape[-1]
    npair = (D + 31) // 32
    nw = npair + 1
    ext = kc[..., _fold(reflect)(np.arange(32 * nw) - hd, D)]
    ext = ext.reshape(*ext.shape[:-1], nw, 32).astype(np.int64)
    lane = np.arange(32, dtype=np.uint64)
    words = np.stack([(((ext >> (top - i)) & 1).astype(np.uint64) << lane)
                      .sum(axis=-1) for i in range(bits)], axis=-1)
    return np.stack([words[..., :npair, :], words[..., 1:, :]], axis=-1)


def model_rank(m: np.ndarray, cfar, bits: int, prepadded: bool = False, *,
               clamp: bool = True, guard: bool = True,
               reflect_planes: bool | None = None) -> np.ndarray:
    """est keys (..., R, D) of the kernel's walk; with ``cfar.edge_mode ==
    "reflect"`` the reflect entry's (window rows reflect(r - hr + i) of a
    whole map, bit-plane columns reflect(x - hd)); ``reflect_planes=False``
    is its mutation, the planes' columns wrapped."""
    reflect = cfar.edge_mode == "reflect"
    if reflect_planes is None:
        reflect_planes = reflect
    integer = m.dtype != np.float32
    hr, hd, gr, gd = (cfar.halo_range, cfar.halo_doppler, cfar.guard_range,
                      cfar.guard_doppler)
    k = cfar.n_ref - cfar.rank_idx
    top = bits - 1 if integer else 30
    keys = _keys(m).astype(np.int64)
    kc = np.clip(keys, 0, (2 << top) - 1) if clamp else keys & 0xFFFFFFFF
    R_in, D = m.shape[-2:]
    R = R_in - 2 * hr if prepadded else R_in
    rows = np.arange(R)[:, None] + np.arange(2 * hr + 1)[None, :]
    rows = rows % R_in if prepadded else _fold(reflect)(rows - hr, R)
    pl = _planes(kc, bits, top, hd, reflect_planes)[..., rows, :, :, :]
    # (..., R, 2hr+1, npair, bits, 2) -> per cell: its pair d // 32.
    d = np.arange(D)
    pl = pl[..., d // 32, :, :]                  # (..., R, W_r, D, bits, 2)
    pl = np.swapaxes(pl, -4, -3)                 # (..., R, D, W_r, bits, 2)
    v = (pl[..., 1] << np.uint64(32)) | pl[..., 0]
    fields = ((v >> (d % 32).astype(np.uint64)[:, None, None])
              & np.uint64(0xFFFFFFFF))           # (..., R, D, W_r, bits)
    W = 2 * hd + 1
    field_mask = (1 << W) - 1
    guard_mask = ((1 << (2 * gd + 1)) - 1) << (hd - gd)
    eq = np.full(fields.shape[:-1], field_mask, dtype=np.uint64)
    if guard:
        eq[..., hr - gr:hr + gr + 1] &= np.uint64(field_mask & ~guard_mask)
    if W <= 16:
        # Window rows in pairs: fields and masks of rows 2p and 2p + 1 as
        # the low and high 16-bit halves of one word (the kernel's PRMT),
        # the last row of an odd window alone.
        lo16 = np.uint64(0xFFFF)
        nr = 2 * hr + 1
        fields = np.stack(
            [(fields[..., 2 * p, :] & lo16)
             | ((fields[..., 2 * p + 1, :] & lo16) << np.uint64(16))
             if 2 * p + 1 < nr else fields[..., 2 * p, :]
             for p in range((nr + 1) // 2)], axis=-2)
        eq = np.stack([eq[..., 2 * p] | (eq[..., 2 * p + 1] << np.uint64(16))
                       if 2 * p + 1 < nr else eq[..., 2 * p]
                       for p in range((nr + 1) // 2)], axis=-1)
    above = np.zeros(eq.shape[:-1], dtype=np.int64)
    prefix = np.zeros(eq.shape[:-1], dtype=np.int64)
    for i in range(bits):
        f = fields[..., i]
        cnt = above + np.bitwise_count(eq & f).sum(axis=-1)
        take = cnt >= k
        eq = np.where(take[..., None], eq & f, eq & ~f)
        above = np.where(take, above, cnt)
        prefix |= np.where(take, 1 << (top - i), 0)
    return prefix.astype(np.int32)


def _colsum(x: np.ndarray, r0: int, n: int) -> np.ndarray:
    acc = x[..., r0, :]
    for i in range(1, n):
        acc = acc + x[..., r0 + i, :]
    return acc


def model_cfar_rank(m: np.ndarray, so: int, cfar, bits: int | None, *,
                    scale_map: np.ndarray | None = None,
                    prepadded: bool = False, **mutation):
    """(det, threshold, scale) of the kernel on a numpy map."""
    b = RK.check_bits(bits)
    with np.errstate(invalid="ignore", over="ignore"):
        return _model_taps(m, so, cfar, model_rank(
            m, cfar, b, prepadded, **mutation), scale_map, prepadded)


def _model_taps(m, so, cfar, est_k, scale_map, prepadded):
    integer = m.dtype != np.float32
    fold = _fold(cfar.edge_mode == "reflect")
    hr, hd, gr, gd = (cfar.halo_range, cfar.halo_doppler, cfar.guard_range,
                      cfar.guard_doppler)
    est = est_k if integer else est_k.view(np.float32)
    R_in, D = m.shape[-2:]
    R = R_in - 2 * hr if prepadded else R_in
    # Tile rows of each cell's window: rows t .. t + 2 hr around row t + hr.
    ext = m if prepadded else m[..., fold(np.arange(-hr, R + hr), R), :]
    cut = ext[..., hr:hr + R, :]
    if scale_map is not None:
        sc = scale_map.astype(np.int64)
    else:
        win = np.stack([ext[..., t:t + 2 * hr + 1, :] for t in range(R)],
                       axis=-3)                          # (..., R, 2hr+1, D)
        cs_full = _colsum(win, 0, 2 * hr + 1)
        cs_guard = _colsum(win, hr - gr, 2 * gr + 1)
        cols = lambda cs, h: [cs[..., fold(np.arange(D) + j, D)]
                              for j in range(-h, h + 1)]
        full = cols(cs_full, hd)
        gsum = cols(cs_guard, gd)
        full_s, guard_s = full[0], gsum[0]
        for x in full[1:]:
            full_s = full_s + x
        for x in gsum[1:]:
            guard_s = guard_s + x
        if integer:
            # int32 sums and difference, wrapping as the kernel's and the
            # twin's; then the floor mean.
            mean = (full_s - guard_s).astype(np.int64) // cfar.n_ref
            t_hi, t_lo = mean + (mean >> 1), mean >> 1
        else:
            mean = (full_s - guard_s) / np.float32(cfar.n_ref)
            t_hi, t_lo = np.float32(1.5) * mean, np.float32(0.5) * mean
        sc = np.where(est > t_hi, cfar.scale_max,
                      np.where(est < t_lo, cfar.scale_min, cfar.scale_nom))
    if so:
        sc = np.full(est.shape, so)
    if integer:
        thr = ((est.astype(np.int64) * sc) & 0xFFFFFFFF).astype(
            np.uint32).view(np.int32)
    else:
        thr = est * sc.astype(np.float32)
    det = np.where(cut > thr, cut, 0).astype(m.dtype)
    return det, thr, sc.astype(np.int32)


def model_group(det: np.ndarray, cut_pos: np.ndarray, pgr: int):
    """The grouping entry's epilogue on a whole (..., R, D) det map:
    (grouped det, row maxima, count)."""
    R, D = det.shape[-2:]
    d = np.where(cut_pos | (pgr == 0), det, 0)
    ids = np.arange(R * D).reshape(R, D)
    keep = d > 0
    for dr in range(-pgr, pgr + 1):
        for dd in range(-pgr, pgr + 1):
            if dr == 0 and dd == 0:
                continue
            v = np.roll(d, (-dr, -dd), axis=(-2, -1))
            nid = np.roll(ids, (-dr, -dd), axis=(-2, -1))
            keep &= ~((v > d) | ((v == d) & (nid < ids)))
    out = np.where((d > 0) & ~keep & (pgr > 0), 0, d).astype(det.dtype)
    pos = np.where(out > 0, out, 0).astype(det.dtype)
    return out, pos.max(axis=-1), (out > 0).sum(axis=(-2, -1))


def _noise(shape, integer, seed):
    rng = np.random.default_rng(seed)
    m = rng.exponential(500.0, shape)
    m[..., 5:15, :] *= np.where(rng.random(m[..., 5:15, :].shape) < 0.3,
                                30.0, 1.0)
    return (m.astype(np.int32) if integer else m.astype(np.float32))


def _equal(model, twin):
    return all(np.array_equal(np.asarray(a), b.numpy())
               for a, b in zip(model, twin))


MAPS = {
    "noise-2x64x32": lambda integer: _noise((2, 64, 32), integer, 1),
    "noise-1x40x16": lambda integer: _noise((1, 40, 16), integer, 2),
    "adversarial-2x64x32": lambda integer: rank_adversarial_maps(
        (2, 64, 32), integer, 3),
    "adversarial-1x40x16": lambda integer: rank_adversarial_maps(
        (1, 40, 16), integer, 4),
}
# name: (integer, bits, scale override, block scale)
VARIANTS = {
    "float-16": (False, 16, 0, False),
    "float-exact": (False, None, 0, False),
    "float-exact-scale-map": (False, None, 0, True),
    "int32-16": (True, 16, 0, False),
    "float-16-override4": (False, 16, 4, False),
    "int32-exact-override4": (True, None, 4, False),
}


@pytest.mark.parametrize("window", list(WINDOWS))
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("maps", list(MAPS))
def test_model_equals_twin(maps, variant, window):
    integer, bits, so, block = VARIANTS[variant]
    cfar = WINDOWS[window]
    if block:
        cfar = dataclasses.replace(cfar, scale_mode="block")
    m = MAPS[maps](integer)
    if block and m.shape[-2] % cfar.scale_block:
        pytest.skip("the block scale needs scale_block | R")
    smap = C.block_scale_map(torch.as_tensor(m), cfar) if block else None
    twin = RK.cfar_rank_plain(torch.as_tensor(m), so, cfar=cfar, bits=bits,
                              scale_map=smap)
    got = model_cfar_rank(m, so, cfar, bits, scale_map=(
        None if smap is None else smap.numpy()))
    assert _equal(got, twin)
    assert (got[0] > 0).sum() > 0


@pytest.mark.parametrize("integer", [False, True], ids=["float", "int32"])
def test_model_prepadded_equals_twin_and_whole_map(integer):
    """A range shard with its neighbours' rows: equal to the twin's
    prepadded entry and to the whole map's rows."""
    m = rank_adversarial_maps((2, 64, 32), integer, 5)
    hr = FULL.halo_range
    rows = np.arange(16 - hr, 32 + hr)
    shard = m[:, rows]
    twin = RK.cfar_rank_plain(torch.as_tensor(shard), cfar=FULL, bits=16,
                              prepadded_range=True)
    got = model_cfar_rank(shard, 0, FULL, 16, prepadded=True)
    assert _equal(got, twin)
    whole = model_cfar_rank(m, 0, FULL, 16)
    assert all(np.array_equal(a, w[:, 16:32]) for a, w in zip(got, whole))


@pytest.mark.parametrize("pgr", [0, 1, 2])
@pytest.mark.parametrize("integer", [False, True], ids=["float", "int32"])
def test_model_grouping_entry_equals_group_twin(integer, pgr):
    """The grouping entry against cfar_rank_plain, ops/cfar.peak_group, the
    row maxima and the count (cfar_rank_group_plain), on adversarial maps
    with many tied detections."""
    m = rank_adversarial_maps((2, 64, 32), integer, 6 + pgr)
    bits = 16
    twin = RK.cfar_rank_group_plain(torch.as_tensor(m), cfar=FULL, bits=bits,
                                    peak_group_radius=pgr)
    det, thr, sc = model_cfar_rank(m, 0, FULL, bits)
    out, rmax, n = model_group(det, m > 0, pgr)
    assert _equal((out, thr, sc, rmax, n), twin)
    assert n.sum() > 0


def test_clamp_preserves_every_compare():
    """Every candidate of a walk has a walked bit set and zeros below the
    last, so clamping the keys to [0, top mask] keeps key >= candidate for
    every int32 key, the adversarial ones included."""
    keys = np.concatenate([
        _keys(rank_adversarial_maps((1, 64, 32), False, 8)).ravel(),
        _keys(rank_adversarial_maps((1, 64, 32), True, 9)).ravel(),
        np.array([-2 ** 31, -1, 0, 1, 2 ** 16 - 1, 2 ** 16, 2 ** 31 - 1])])
    keys = keys.astype(np.int64)
    rng = np.random.default_rng(0)
    for bits, top in ((16, 15), (16, 30), (31, 30)):
        kc = np.clip(keys, 0, (2 << top) - 1)
        for _ in range(200):
            walked = rng.integers(0, 2, bits)
            walked[rng.integers(0, bits)] = 1
            cand = sum(int(w) << (top - i) for i, w in enumerate(walked))
            assert np.array_equal(keys >= cand, kc >= cand)


@pytest.mark.parametrize("mutation", ["no-clamp", "guard-counted"])
def test_mutations_disagree(mutation):
    """The model fails when it drops the clamp of the keys (negative floats
    and int keys beyond the walked bits then miscompare) or counts the guard
    columns of the guard rows."""
    kw = ({"clamp": False} if mutation == "no-clamp" else {"guard": False})
    bad = 0
    for integer, bits in ((False, 31), (False, 16), (True, 16)):
        m = rank_adversarial_maps((2, 64, 32), integer, 10)
        twin = RK.cfar_rank_plain(torch.as_tensor(m), cfar=FULL, bits=bits)
        assert _equal(model_cfar_rank(m, 0, FULL, bits), twin)
        bad += not _equal(model_cfar_rank(m, 0, FULL, bits, **kw), twin)
    assert bad == 3
