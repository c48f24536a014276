"""n_doppler off a multiple of 8 (every length below 2048 that 8 does not
divide, down to the smallest the CFAR window admits): kernel A's partial
last group of 8 chirps a frame (fmcw_tpu_torch/csrc/range_fft.cu), kernel B's
``dense_row<m>`` with m = nd & -nd in 1, 2, 4 and the decide kernel's ragged
last chunk (csrc/slowtime_detect.cu, csrc/slowtime_long.cuh), and every
float route that reaches them, held against the JAX package on the CPU.

JAX's fused kernel takes these lengths with its dense operator
(``_doppler_split`` is 1 below 2048); the port's twin is the same folded
matrix:

* the length set against JAX's; the fixed kernels still refuse it;
* numpy models of the kernels' new index arithmetic: ``dense_row<m>`` (the
  canceller and window in 4-chirp lane blocks with loads of min(4, m)
  floats and a ragged row end, the lane split, the class order o q + k2)
  against a float64 chain at o up to 2047; kernel A's groups (every
  (frame, row, chirp) stored once, the bulk copies tiling the input); the
  decide kernel's ragged chunks (column masks, halo columns
  wrapping into column 0) bit-equal to the plain decision, a mutation
  without the mask failing;
* ``_decide_geometry`` at every new length, and unchanged tiles at the
  multiples of 8;
* the processors on the CPU (the kernels' twins): margin gate against
  JAX's XLA chain at 1024x100 and 256x250; JAX's fused kernel in interpret
  mode at 128x20; a LocalMesh at sp 2 and 4; the launches under the
  ``as_if_cuda`` stand-in; fixed "fused" refusing 100 chirps.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fmcw_tpu
import fmcw_tpu_torch
from fmcw_tpu.models import pipeline as jpl
from fmcw_tpu.ops.frontend_pallas import rdm_frontend
from fmcw_tpu_torch import kernels, parity
from fmcw_tpu_torch.golden import reference as tref
from fmcw_tpu_torch.models import pipeline as tpl
from fmcw_tpu_torch.ops import cfar as C
from fmcw_tpu_torch.ops import fft as TF
from fmcw_tpu_torch.ops import frontend as F
from fmcw_tpu_torch.ops import frontend_fixed as FX
from fmcw_tpu_torch.ops import split_frontend as SF
from fmcw_tpu_torch.parallel import LocalMesh, make_sharded_processor

from test_torch_dense_doppler import kernel_slowtime_dense
from test_torch_isolation import as_if_cuda  # noqa: F401 (a fixture)
from test_torch_slowtime_plan import (F32, _fma, _planes, _spectra_close,
                                      float64_chain, mti_window, tie_map)

# Share the CPU with the other test workers (the suite runs 6 at once).
torch.set_num_threads(2)

TOL = 1e-5
CSRC = Path(F.__file__).resolve().parent.parent / "csrc"
ENTRY = fmcw_tpu_torch.CfarParams()
# Every length off a multiple of 8 below 2048 that the entry window
# admits (halo_doppler 5 and the grouping radius 2 below n_doppler).
ODD = tuple(nd for nd in range(1, 2048)
            if nd % 8 and nd > max(ENTRY.halo_doppler, 2))
MTI = ((2, "zero", False), (3, "passthrough", False), (3, "zero", False),
       (2, "zero", True))


def test_odd_lengths_are_jax_dense_operator():
    """1787 lengths (6 .. 2047 off a multiple of 8): at each JAX's fused
    kernel takes the dense operator (``_doppler_split`` 1); kernel B takes
    them (``unaligned_cpi``, two launches), the fixed slow-time kernel and
    the fixed range kernel refuse them; kernel A takes any chirp count.
    The dense lengths (8 | nd) stay the fixed kernels' too."""
    assert len(ODD) == 1787 and ODD[:3] == (6, 7, 9) and ODD[-1] == 2047
    for nd in ODD:
        assert jpl._doppler_split(fmcw_tpu.RadarParams(n_doppler=nd)) == 1
        assert F.unaligned_cpi(nd) and F.two_launch(nd)
        assert not F.dense_cpi(nd) and not F.long_cpi(nd)
        F.check_doppler(nd, "slowtime_detect")
        F.check_range_geometry(1024, nd)
    for nd in (1, 5, 100, 1021, 2047):
        with pytest.raises(NotImplementedError):
            F.check_doppler(nd, "slowtime_detect_fixed", int_map=True)
        with pytest.raises(NotImplementedError):
            FX.check_range_geometry_fixed(1024, nd)
    for nd in (2049, 2056, 4096):
        assert not F.unaligned_cpi(nd)
        with pytest.raises(NotImplementedError):
            F.check_doppler(nd, "slowtime_detect")
    for nd in (96, 1016, 2040):
        F.check_doppler(nd, "slowtime_detect_fixed", int_map=True)
        FX.check_range_geometry_fixed(1024, nd)
    # The host constants the kernels mirror.
    src = (CSRC / "slowtime_detect.cu").read_text()
    assert "nd % fmcw::kDenseAlign != 0" in src
    assert "case 1: return launch_map<1, kHalo>" in src
    assert "(nd + 3) & ~3" in src


# ---------------------------------------------------------------------------
# Kernel B's dense row at m = 1, 2, 4
# ---------------------------------------------------------------------------

def kernel_canceller_blocks(re, im, win, notch=2, transient="zero",
                            bypass=False):
    """The canceller and window of ``dense_row<m>`` at a dense length off a
    multiple of 8: lane l of block b0 takes chirps s0 = b0 + 4 l .. s0 + 3
    (lanes from s0 >= nd stop), loaded in runs of V = min(4, m) floats
    (``load_run<V>``: 0 past the row's end, no load past it), the two
    chirps before s0 read from the row; stored into buffers of a pitch of
    a multiple of 4 (``map_pitch``).  Returns the buffers (rows, pitch)
    and asserts every load is V-aligned and inside the row."""
    rows, nd = re.shape
    V = min(4, nd & -nd)
    pitch = (nd + 3) & ~3
    zr = np.full((rows, pitch), np.nan, F32)
    zi = np.full((rows, pitch), np.nan, F32)
    for b0 in range(0, nd, 128):
        for lane in range(32):
            s0 = b0 + 4 * lane
            if s0 >= nd:
                break
            x = np.zeros((3, rows, 4), F32)          # re, im, window
            for v0 in range(s0, s0 + 4, V):
                if V < 4 and v0 >= nd:
                    continue                        # the ragged end: 0
                assert v0 % V == 0 and v0 + V <= nd   # an aligned load
                for src, dst in ((re, x[0]), (im, x[1]), (win[None], x[2])):
                    dst[:, v0 - s0:v0 - s0 + V] = src[:, v0:v0 + V]
            xr, xi, w = x[0], x[1], x[2]
            if not bypass:
                hist = [(re[:, s0 - d], im[:, s0 - d]) if s0 >= d
                        else (np.zeros(rows, F32),) * 2 for d in (1, 2)]
                yr, yi = np.empty_like(xr), np.empty_like(xi)
                for q in range(3, -1, -1):
                    a1 = (xr[:, q - 1], xi[:, q - 1]) if q >= 1 else hist[0]
                    a2 = ((xr[:, q - 2], xi[:, q - 2]) if q >= 2
                          else hist[0] if q == 1 else hist[1])
                    if notch == 2:
                        yr[:, q], yi[:, q] = xr[:, q] - a1[0], xi[:, q] - a1[1]
                    else:
                        yr[:, q] = _fma(-2.0, a1[0], xr[:, q]) + a2[0]
                        yi[:, q] = _fma(-2.0, a1[1], xi[:, q]) + a2[1]
                    if transient == "zero" and s0 + q < notch - 1:
                        yr[:, q] = yi[:, q] = 0
                xr, xi = yr, yi
            zr[:, s0:s0 + 4] = xr * w
            zi[:, s0:s0 + 4] = xi * w
    return zr, zi


@pytest.mark.parametrize("nd", [6, 7, 9, 10, 12, 20, 100, 250, 1021, 2046,
                                2047])
def test_canceller_blocks_ragged_tail(nd):
    """The lane blocks of the canceller and window, with the ragged row end
    (loads of 4, 2 or 1 floats, 0 past nd), equal the whole-row chain
    (``mti_window``) bit for bit in the row's nd values for every MTI
    setting; the class loop reads z[m j2 + l P + p] < o m = nd only, so the
    padding (pitch - nd values) is never read."""
    rng = np.random.default_rng(nd)
    re, im = _planes(nd, "noise", rng, rows=3)
    win, _ = (x.numpy() for x in F._slowtime_tables(nd, "cpu"))
    for notch, transient, bypass in MTI:
        zr, zi = kernel_canceller_blocks(re, im, win, notch, transient,
                                         bypass)
        wr, wi = mti_window(re, im, win, notch, transient, bypass)
        assert np.array_equal(zr[:, :nd], wr)
        assert np.array_equal(zi[:, :nd], wi)
    m = nd & -nd
    o, L = nd // m, min(32, m)
    reads = (m * np.arange(o)[:, None, None] + (m // L) * np.arange(L)[:, None]
             + np.arange(m // L)).ravel()
    assert np.array_equal(np.sort(reads), np.arange(nd))


def _odd_sample(m):
    """Lengths of inner transform m, o up to 2047: every m = 4, 2 length to
    300, the primes beside a few composite o, and the largest."""
    if m == 1:
        return (7, 9, 15, 101, 255, 257, 999, 1021, 1023, 2045, 2047)
    return tuple(nd for nd in ODD if nd & -nd == m and nd <= 300) + (
        (1020, 2044) if m == 4 else (1022, 2046))


@pytest.mark.parametrize("m", [1, 2, 4])
def test_dense_row_model_within_float64_chain(m):
    """``dense_row<m>``'s row model (the outer DFT_o as direct sums in the
    kernel's order, W_o^e = tw[e m], the twiddle W_nd^(j1 k2), the m-point
    lane transform on the whole row's table, bin q of class k2 at o q +
    k2; ``lane_fft<1>`` the identity) within 1e-5 of the peak of the
    float64 chain at every sampled length of inner transform m (o up to
    2047, the MTI settings in turn; at most 2.2e-6 measured, m = 1), and
    within 1e-5 of the twin (the folded matrix) at the lengths to 300."""
    worst = 0.0
    for i, nd in enumerate(_odd_sample(m)):
        rng = np.random.default_rng(nd)
        re, im = _planes(nd, "frame" if i % 3 == 0 else "noise", rng,
                         rows=2)
        notch, transient, bypass = MTI[i % len(MTI)]
        got = kernel_slowtime_dense(re, im, notch, transient, bypass)
        exact = float64_chain(re, im, notch, transient, bypass)
        err = _spectra_close(got, exact)
        worst = max(worst, err)
        assert err <= TOL, (nd, err)
        if nd <= 300:
            twin = [t.numpy() for t in TF.doppler_apply(
                torch.as_tensor(re), torch.as_tensor(im), bypass, notch,
                transient)]
            assert _spectra_close(got, twin) <= TOL, nd
    assert worst <= 3e-6


def test_dense_row_model_needs_its_outer_twiddles():
    """Mutation check: with W_o conjugated the model is far off the float64
    chain at every m (o > 1)."""
    for nd in (7, 10, 100, 2047):
        rng = np.random.default_rng(3)
        re, im = _planes(nd, "noise", rng, rows=2)
        exact = float64_chain(re, im, 2, "zero", False)
        assert _spectra_close(kernel_slowtime_dense(re, im, conj_outer=True),
                              exact) > 1e-2


# ---------------------------------------------------------------------------
# Kernel A's partial groups
# ---------------------------------------------------------------------------

def kernel_a_stores(B, nd, n):
    """Kernel A's groups of B frames of nd chirps: per_frame = ceil(nd / 8)
    groups a frame; group gi is frame b = gi // per_frame, chirps c0 = 8
    (gi - b per_frame) .. min(c0 + 8, nd), its bulk copy their n words a
    chirp from word (b nd + c0) n; thread chirp c2 stores the n rows of
    column c0 + c2 of out (B, n, nd) where c0 + c2 < nd.  Returns
    (per-element store counts of out, the groups, the copies (first word,
    words))."""
    per_frame = -(-nd // 8)
    groups = B * per_frame
    hits = np.zeros(B * n * nd, np.int64)
    copies = []
    for gi in range(groups):
        b = gi // per_frame
        c0 = (gi - b * per_frame) * 8
        copies.append(((b * nd + c0) * n, min(8, nd - c0) * n))
        for c2 in range(8):
            if c0 + c2 < nd:
                np.add.at(hits, b * n * nd + c0 + c2 + np.arange(n) * nd, 1)
    return hits, groups, copies


@pytest.mark.parametrize("nd", [100, 250, 1021, 3, 96, 128])
def test_kernel_a_groups_store_each_chirp_once(nd):
    """At nd = 100, 250, 1021 and 3 (one partial group a frame; and 96,
    128), batch 1-3, n = 16 and 384: every (frame, range row, chirp) of the
    output is stored exactly once; each bulk copy is a multiple of 16 bytes
    inside its frame (n 4-byte words a chirp), the copies tile the input;
    only a frame's last group is partial.  At 8 | nd the launch is the
    whole-group one (B nd / 8 groups, group gi's copy from word 8 gi n: the
    kernel's kWhole instantiation)."""
    src = (CSRC / "range_fft.cu").read_text()
    assert "constexpr int kChirps = 8;" in src
    assert "kWhole ? nd / kChirps : (nd + kChirps - 1) / kChirps" in src
    assert "if (kWhole || c0 + c2 < nd)" in src
    for B in (1, 2, 3):
        for n in (16, 384):
            hits, groups, copies = kernel_a_stores(B, nd, n)
            assert hits.min() == hits.max() == 1
            assert groups == B * -(-nd // 8)
            words = 0
            for i, (w0, size) in enumerate(copies):
                assert (4 * size) % 16 == 0 and (4 * w0) % 16 == 0
                assert w0 == words            # the copies tile the input
                words += size
                last = (i + 1) % -(-nd // 8) == 0
                assert size == 8 * n or last
            assert words == B * nd * n
            if nd % 8 == 0:
                assert groups == B * nd // 8
                assert all(w0 == 8 * gi * n
                           for gi, (w0, _) in enumerate(copies))


# ---------------------------------------------------------------------------
# The decide kernel's ragged chunks
# ---------------------------------------------------------------------------

def decide_ragged(mag, cfar, so, pgr, W=None, mask=True):
    """The decide kernel's chunks at a length off a multiple of 8, on the
    plain decision of each cell (the kernel decides a tile cell as the
    twin decides its wrapped map cell, tests/test_torch_longcpi.py): ceil(nd
    / W) chunks of T rows x W columns, the tile's W + 2 HC columns (c0 - HC
    + x) mod nd (the last chunk's halo wraps into column 0); grouping as
    ``fmcw::group_store_chunk`` (pitch W + 2 HC, the chunk's decisions from
    tile column HC - pgr, global ids, ties to the lower index) storing the
    columns below nd only (``mask=False``: all W, the store running into
    the next row).  Returns (det (B, R, nd), store counts)."""
    B, R, D = mag.shape
    cfg = F._slowtime_config(B, R, D, cfar, so, pgr)
    T, HC = cfg.T, cfg.HC
    W = cfg.W if W is None else W
    d0 = C.cfar_2d(torch.as_tensor(mag), so, cfar)[0].numpy()
    det = np.zeros((B, R * D + W), F32)
    count = np.zeros(R * D + W, np.int64)
    for r0 in range(0, R, T):
        for c0 in range(0, D, W):
            rows = (r0 - pgr + np.arange(T + 2 * pgr)) % R
            cols = (c0 - HC + np.arange(W + 2 * HC)) % D
            tile = d0[:, rows][..., cols]
            wn = min(W, D - c0) if mask else W
            t, j = np.meshgrid(np.arange(T), np.arange(wn), indexing="ij")
            x = HC + j                              # col0 + pgr + j
            cell = tile[:, t + pgr, x]
            keep = cell > 0
            r, d = r0 + t, c0 + j
            ids = r * D + d
            for dr in range(-pgr, pgr + 1):
                for dd in range(-pgr, pgr + 1):
                    if dr == 0 and dd == 0:
                        continue
                    v = tile[:, t + pgr + dr, x + dd]
                    nid = ((r + dr) % R) * D + (d + dd) % D
                    keep &= ~((v > cell) | ((v == cell) & (nid < ids)))
            at = (r * D + d).ravel()
            det[:, at] = np.where(keep, cell, F32(0)).reshape(B, -1)
            np.add.at(count, at, 1)
    return det[:, :R * D].reshape(B, R, D), count[:R * D]


@pytest.mark.parametrize("nd,W", [(250, None), (100, 24), (1021, None),
                                  (37, 8), (13, 7)])
def test_ragged_decide_model_bitwise(nd, W):
    """The ragged chunks (250: 84, 84, 82 columns; 1021: eight of 114 and
    109; 100 in chunks of 24, the last 4 columns narrower than its halo; 37
    and 13 at W 8 and 7) equal the plain decision with grouping
    (``detect_plain``) bit for bit on tie-heavy maps, each cell stored once;
    without the mask the last chunk's extra columns land in the next row's
    first columns and differ."""
    for cfar, pgr in ((ENTRY, 2), (fmcw_tpu_torch.quick().cfar, 1),
                      (fmcw_tpu_torch.CfarParams(variant="ca"), 2)):
        mag = tie_map(np.random.default_rng(nd + pgr), 2, 64, nd)
        got, count = decide_ragged(mag, cfar, 0, pgr, W)
        want = F.detect_plain(torch.as_tensor(mag), cfar, 0, pgr)[0]
        assert np.array_equal(got, want.numpy()) and (count == 1).all()
        assert (got > 0).any()
    cfg = F._slowtime_config(2, 64, nd, ENTRY, 0, 2)
    if nd % (cfg.W if W is None else W):
        bad, _ = decide_ragged(mag, cfar, 0, pgr, W, mask=False)
        assert not np.array_equal(bad, want.numpy())


def test_decide_geometry_at_every_odd_length():
    """At every new length: per-cell (radius 0 and 2, 1024 rows and the sp
    2 shard's 512), CA, and the block scale where scale_block divides nd
    (4 or 2; 8 never does, and is refused): W at most 128 and nd, the
    fewest chunks for it (W = ceil(nd / ceil(nd / W)), a multiple of the
    block), T the rows, the halos hold the window and the grouping, at
    most 64 cells a thread, the block grid within 256 blocks, shared
    memory within 227 KB; the map kernel's 4 warps of 3 x map_pitch(nd)
    floats and its o outer twiddles within it too."""
    cells = fmcw_tpu_torch.CfarParams
    for nd in ODD:
        pitch = (nd + 3) & ~3
        o = nd // (nd & -nd)
        assert (kernels.MAP_WARPS * 3 * pitch * 4 + 8 * o
                <= kernels.MAX_SMEM // 2)
        sb = 4 if nd % 4 == 0 else 2 if nd % 2 == 0 else None
        configs = [(ENTRY, 0, 1024), (ENTRY, 2, 1024), (ENTRY, 2, 512),
                   (cells(variant="ca"), 2, 1024)]
        if sb:
            configs.append((cells(scale_mode="block", scale_block=sb), 2,
                            1024))
        for cfar, pgr, nr in configs:
            c = F._slowtime_config(1, nr, nd, cfar, 0, pgr)
            block = cfar.scale_mode == "block"
            n_chunks = -(-nd // c.W)
            assert c.W <= min(128, nd) and nr % c.T == 0
            s = cfar.scale_block if block else 1
            assert c.W == -(-(-(-nd // n_chunks)) // s) * s
            words = F._chunk_words(c.T, c.W, c.H, c.HC, pgr, block, 0)
            assert 4 * words <= kernels.MAX_SMEM
            assert c.H >= cfar.halo_range + pgr
            assert c.HC >= cfar.halo_doppler + pgr
            units = -(-(c.T + 2 * pgr) // 8) * (c.W + 2 * pgr)
            assert -(-units // kernels.DECIDE_THREADS) * 8 <= 64
            if block:
                assert c.W % sb == 0 and nd % sb == 0
                assert (c.T + 2 * c.H) // sb * ((c.W + 2 * c.HC) // sb) \
                    <= kernels.MAX_BLK
        with pytest.raises(NotImplementedError):
            F._slowtime_config(1, 1024, nd, cells(scale_mode="block"), 0, 2)


# The decide tiles (T, W, H, HC) at multiples of 8, each for the
# entry window (cell), fast() (block) and CA, radius 0 and 2, at 1024 rows
# and the sp 2 shard's 512.
ALIGNED_TILES = {
    (96, "cell", 0): (64, 96, 6, 5), (96, "cell", 2): (64, 96, 8, 7),
    (96, "block", 0): (64, 96, 16, 16), (96, "block", 2): (64, 96, 24, 24),
    (1016, "cell", 0): (64, 8, 6, 5), (1016, "cell", 2): (64, 8, 8, 7),
    (1016, "block", 0): (64, 8, 16, 16), (1016, "block", 2): (64, 8, 24, 24),
    (2040, "cell", 0): (64, 120, 6, 5), (2040, "cell", 2): (64, 120, 8, 7),
    (2040, "block", 0): (64, 120, 16, 16),
    (2040, "block", 2): (64, 40, 24, 24),
    (256, "cell", 0): (64, 128, 6, 5), (256, "cell", 2): (64, 64, 8, 7),
    (256, "block", 0): (64, 128, 16, 16), (256, "block", 2): (64, 64, 24, 24),
}


def test_decide_geometry_keeps_the_aligned_tiles():
    """At 96, 192, 1016, 2040 and 256 the decide tile is the one chosen
    before ragged chunks existed (192 as 96; CA as the per-cell OS window),
    at 1024 rows and 512: the ragged chunks open only off a multiple of
    8."""
    cfars = {"cell": ENTRY, "block": fmcw_tpu_torch.fast().cfar,
             "ca": fmcw_tpu_torch.CfarParams(variant="ca")}
    for nd in (96, 192, 1016, 2040, 256):
        for name, cfar in cfars.items():
            for pgr in (0, 2):
                want = ALIGNED_TILES[(96 if nd == 192 else nd,
                                     "cell" if name == "ca" else name, pgr)]
                for nr in (1024, 512):
                    c = F._slowtime_config(1, nr, nd, cfar, 0, pgr)
                    assert (c.T, c.W, c.H, c.HC) == want, (nd, name, pgr)


# ---------------------------------------------------------------------------
# The processors
# ---------------------------------------------------------------------------

def _jparams(p):
    return fmcw_tpu.RadarParams(
        n_range=p.n_range, n_doppler=p.n_doppler, notch_mode=p.notch_mode,
        cfar=fmcw_tpu.CfarParams(**dataclasses.asdict(p.cfar)),
        tracker=fmcw_tpu.TrackerParams(**dataclasses.asdict(p.tracker)))


@pytest.mark.parametrize("nr,nd,variant", [(1024, 100, "os"),
                                           (1024, 100, "ca"),
                                           (256, 250, "os"),
                                           (256, 250, "ca")])
def test_batch_processor_margin_gate_vs_jax_xla(nr, nd, variant):
    """Float "auto" and "fused" resolve to the fused route off a multiple
    of 8 (kernel A's groups, kernel B's two launches); on the CPU its twins
    against JAX's XLA chain through the margin gate (det map and top-K),
    magnitudes within 1e-5 of the peak."""
    p = fmcw_tpu_torch.RadarParams(
        n_range=nr, n_doppler=nd,
        cfar=fmcw_tpu_torch.CfarParams(variant=variant))
    iq = tpl.complex_to_iq(tref.two_target_frame(p))
    ref = jax.tree.map(np.asarray, jpl.make_processor(
        _jparams(p), frontend="xla", peak_group_radius=2)(iq))
    for fe in ("auto", "fused"):
        assert tpl.make_batch_processor(p, frontend=fe,
                                        device="cpu").route == "fused"
    out = tpl.make_processor(p, peak_group_radius=2, device="cpu")(iq)
    _, T, S = C.cfar_2d(torch.tensor(ref["mag_map"]), 0, p.cfar,
                        need_debug=True)
    maps = (ref["mag_map"], T.numpy(), S.numpy())
    targets = tref.golden_targets(p)
    for a, b in ((parity.map_set(out["det_map"].numpy()),
                  parity.map_set(ref["det_map"])),
                 (parity.detection_set(out), parity.detection_set(ref))):
        ok, report = parity.margin_gate(a, b, *maps, radius=2,
                                        targets=targets,
                                        capacity=p.tracker.max_dets)
        assert ok, report
    mag = out["mag_map"].numpy()
    assert np.max(np.abs(mag - ref["mag_map"])) <= TOL * ref["mag_map"].max()


def test_jax_fused_kernel_interpret_vs_twin():
    """JAX's fused kernel (interpret mode) at 128x20, one frame, its dense
    operator (m = 4, o = 5 in kernel B), per-cell scale, radius 2, 3-pulse
    MTI: the port's twins' magnitudes within 2e-4 of its peak (its bf16x3
    products); the port's plain decision on JAX's magnitudes equal to JAX's
    detections bit for bit; the route's detections at JAX's cells, their
    values within the same 2e-4."""
    p = fmcw_tpu_torch.RadarParams(n_range=128, n_doppler=20, notch_mode=3)
    iq = tpl.complex_to_iq(tref.two_target_frame(p))
    det_s, jmag, nf, _, n_dets = rdm_frontend(
        jnp.asarray(iq), jnp.asarray(False), notch_mode=3, interpret=True,
        cfar=_jparams(p).cfar, detect=True, peak_group_radius=2)
    jmag = np.asarray(jmag)
    jdet = np.swapaxes(np.asarray(det_s), 0, 1).reshape(128, 20)
    out = tpl.make_processor(p, peak_group_radius=2, device="cpu")(iq)
    assert int(nf) == 0 and int(n_dets) == int((jdet > 0).sum()) > 0
    mag = out["mag_map"].numpy()
    assert np.max(np.abs(mag - jmag)) <= 2e-4 * jmag.max()
    det, _, count, _ = F.detect_plain(torch.tensor(jmag)[None], p.cfar, 0,
                                      2)
    assert np.array_equal(det[0].numpy(), jdet) and int(count) == int(n_dets)
    got, want = parity.map_set(out["det_map"].numpy()), parity.map_set(jdet)
    assert got.keys() == want.keys()
    assert all(abs(got[k] - want[k]) <= 2e-4 * jmag.max() for k in got)


@pytest.mark.parametrize("sp", [2, 4])
def test_local_mesh_equals_single_device(sp):
    """The sharded processor on a LocalMesh at sp 2 and 4 (kernel A on
    chirp shards of 50 and 25 chirps, kernel B's split entry on the range
    shards; their twins here) equals the single-device processor at
    256x100, every output; "auto" is the fused route."""
    p = fmcw_tpu_torch.RadarParams(n_range=256, n_doppler=100)
    iq = np.stack([tpl.complex_to_iq(tref.two_target_frame(p, seed=s))
                   for s in range(2)])
    kw = dict(peak_group_radius=2, include_maps=True)
    proc = make_sharded_processor(LocalMesh(1, sp, "cpu"), p, **kw)
    assert proc.route == "fused"
    got = proc(iq)
    want = tpl.make_batch_processor(p, device="cpu", **kw)(iq)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("ref_angle", [0, 1])
def test_array_model_routes_fused(ref_angle):
    """The array model at 128x100 (4 elements, 4 beams; ref_angle 1 with
    quick()'s window): "auto" is the fused route (kernel A's float entry,
    kernel B's detect or magnitude-only entry) and its twins equal the
    plain route, every output."""
    p = fmcw_tpu_torch.RadarParams(n_range=128, n_doppler=100)
    if ref_angle:
        p = p.replace(cfar=fmcw_tpu_torch.quick().cfar)
    z = np.asarray(tref.two_target_frame(p, seed=2))
    iq = np.stack([tpl.complex_to_iq(z * np.exp(2j * np.pi * 0.2 * e))
                   for e in range(4)])
    kw = dict(n_elems=4, n_beams=4, ref_angle=ref_angle, device="cpu")
    proc = tpl.make_array_processor(p, **kw)
    assert proc.route == "fused"
    got = proc(iq)
    want = tpl.make_array_processor(p, frontend="plain", **kw)(iq)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_odd_lengths_launch_kernel_a_then_map_and_decide(as_if_cuda):
    """Under the stand-in library at 1024x100: kernel A (any chirp count),
    then kernel B's detect entry, two launches, with the decide tile of one
    100-column chunk in its config, the map handed over though no
    magnitudes are asked for, the row maxima zeroed; at 250 three ragged
    chunks of 84; the magnitude-only entry and the split entry likewise
    (the split's map the halo-extended slab); the fixed kernels refuse 100
    before any launch."""
    p = fmcw_tpu_torch.RadarParams(n_doppler=100)
    iq = torch.zeros((2, 100, 1024, 2), dtype=torch.int16)
    re, im = F.range_fft(iq)
    det, mag, rmax, _, _ = F.slowtime_detect(re, im, cfar=p.cfar,
                                             peak_group_radius=2)
    assert [c[0] for c in as_if_cuda.calls] == ["range_fft",
                                                "slowtime_detect"]
    args = as_if_cuda.calls[-1][1]
    cfg = args[9]._obj
    assert (cfg.ND, cfg.T, cfg.W, cfg.H, cfg.HC) == (100, 64, 100, 8, 7)
    assert mag is None and args[5] is not None and not rmax.any()
    assert (F.range_fft.launches, F.slowtime_detect.launches) == (1, 2)
    x = torch.zeros((1, 128, 250))
    F.slowtime_detect(x, x, cfar=p.cfar, peak_group_radius=2)
    assert as_if_cuda.calls[-1][1][9]._obj.W == 84
    F.slowtime_mag(re, im)
    assert as_if_cuda.calls[-1][0] == "slowtime_mag"
    assert F.slowtime_mag.launches == 1
    x = torch.zeros((1, 256, 100))
    h = p.cfar.halo_range + 2
    halo = (x[:, :h], x[:, :h])
    _, smag, _, _, _ = SF.slowtime_detect_split(
        x, x, halo, halo, False, 0, 256, cfar=p.cfar, n_range_total=1024,
        peak_group_radius=2, emit_mag=True)
    name, args = as_if_cuda.calls[-1]
    assert name == "slowtime_detect_split" and args[13]._obj.W == 100
    assert smag.data_ptr() == args[9] + 4 * h * 100
    assert SF.slowtime_detect_split.launches == 2
    n = len(as_if_cuda.calls)
    with pytest.raises(NotImplementedError):
        FX.range_fft_fixed(iq)
    i16 = torch.zeros((1, 128, 100), dtype=torch.int16)
    with pytest.raises(NotImplementedError):
        FX.slowtime_detect_fixed(i16, i16, cfar=p.cfar)
    assert len(as_if_cuda.calls) == n


def test_fixed_fused_refuses_odd_lengths():
    """Fixed "fused" at 1024x100 raises NotImplementedError when the
    processor is built, on the CPU too, naming the fixed kernel, on one
    device and on a mesh (sp 2, 50 chirps a shard); fixed "auto" stays the
    staged route; ``fused_fixed_detect_supported`` is False.  The float
    processors build "fused" at 1024x100, 250, 1021 and 2047, and on sp 2
    and 4 at 1024x100 and sp 4 at 1024x1016 (254 chirps a shard)."""
    p = fmcw_tpu_torch.RadarParams(n_doppler=100)
    kw = dict(mode="fixed", frontend="fused")
    assert not FX.fused_fixed_detect_supported(p)
    with pytest.raises(NotImplementedError, match="slowtime_detect_fixed"):
        tpl.make_batch_processor(p, device="cpu", **kw)
    with pytest.raises(NotImplementedError):
        make_sharded_processor(LocalMesh(1, 2, "cpu"), p, **kw)
    assert tpl.make_batch_processor(p, mode="fixed",
                                    device="cpu").route == "staged"
    for nd in (100, 250, 1021, 2047):
        q = fmcw_tpu_torch.RadarParams(n_doppler=nd)
        for fe in ("auto", "fused"):
            assert tpl.make_batch_processor(q, frontend=fe,
                                            device="cpu").route == "fused"
    for sp, nd in ((2, 100), (4, 100), (4, 1016)):
        q = fmcw_tpu_torch.RadarParams(n_doppler=nd)
        assert make_sharded_processor(LocalMesh(1, sp, "cpu"),
                                      q).route == "fused"


@pytest.mark.parametrize("nd", [100, 251])
def test_debug_taps_reflect_and_hw_routes_fused(nd):
    """The other float routes at 256x100 and 256x251: the debug taps and
    the hw-compat CFAR (kernel B's magnitude-only entry) and reflect edges
    resolve "auto" to the fused route; on the CPU each equals its plain
    route, every output."""
    p = fmcw_tpu_torch.RadarParams(n_range=256, n_doppler=nd)
    iq = tpl.complex_to_iq(tref.two_target_frame(p))[None]
    reflect = p.replace(cfar=dataclasses.replace(p.cfar,
                                                 edge_mode="reflect"))
    for q, kw in ((p, dict(include_debug=True)),
                  (p, dict(cfar_geometry="hw_stream")),
                  (reflect, {})):
        proc = tpl.make_batch_processor(q, peak_group_radius=2,
                                        device="cpu", **kw)
        assert proc.route == "fused"
        got = proc(iq)
        want = tpl.make_batch_processor(q, peak_group_radius=2,
                                        frontend="plain", device="cpu",
                                        **kw)(iq)
        assert all(torch.equal(got[k], want[k]) for k in want)
