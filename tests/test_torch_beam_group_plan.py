"""A numpy model of csrc/beam_group.cu's plan, bit for bit against its plain
twin ``ops/beam_group.beam_group_plain`` (the port of
``fmcw_tpu/ops/cfar_pallas.py::_kernel_beam_group``).

The kernel runs only on the card; this model walks as it does, so that the
plan's arithmetic is checked here:

* one warp a (cube, range row), walking the beam axis; its lanes hold 4
  adjacent cells (float4) where D is a multiple of 4, else 1, and a row
  wider than 32 lanes' cells walks once per chunk of columns, the row
  maximum stored by the first chunk and raised by the later ones;
* radius 0-3: a sliding window of 2 radius + 1 planes, planes past either
  end of the (shard's) cube loading as 0, the plane after next loaded
  before the decision; radius 4 and up: the neighbours read directly;
* the neighbour at offset o counts only if gid + o < n_total (above) or
  gid - o >= 0 (below), gid the plane's global beam id, advanced by one a
  plane and wrapped at n_total: the whole cube and the halo-extended shards
  (global ids, the cube's edges) alike;
* the counts summed a warp, a block of 8 rows, then over the cube's
  blocks.

Mutations of the plan (ties toward the upper beam, an edge one beam off, a
global id that does not wrap, a row maximum stored by every chunk) must
each make the model disagree with the twin on one of the cases.
"""

import numpy as np
import pytest
import torch

from fmcw_tpu_torch.ops import beam_group as BG

ROWS = 8               # map rows a block walks (kWarps)
WINDOW_RADIUS = 3      # kMaxWindowRadius


def plan(det: np.ndarray, radius: int, halo: int = 0, id0: int = 0,
         n_total: int | None = None, mutate: str | None = None):
    """The kernel's outputs, as its plan computes them."""
    B, nb_in, R, D = det.shape
    NB = nb_in - 2 * halo
    n_total = NB if n_total is None else n_total
    V = 4 if D % 4 == 0 else 1
    out = np.zeros((B, NB, R, D), np.float32)
    rmax = np.zeros((B, NB, R), np.float32)
    kept = np.zeros((B, R), np.int64)
    gid0 = (id0 + halo) % n_total
    for c0 in range(0, D, 32 * V):
        cols = slice(c0, min(D, c0 + 32 * V))
        width = cols.stop - cols.start

        def plane(j):
            if 0 <= j < nb_in:
                return det[:, j, :, cols]
            return np.zeros((B, R, width), np.float32)

        if radius <= WINDOW_RADIUS:
            w = [plane(halo - radius + k) for k in range(2 * radius + 1)]
            nxt = plane(halo + radius + 1 if NB > 1 else -1)
        gid = gid0
        for i in range(NB):
            q = halo + i
            if radius <= WINDOW_RADIUS:
                nxt2 = plane(q + radius + 2 if i + 2 < NB else -1)
                m = w[radius]
                up = lambda o: w[radius + o]            # noqa: E731
                dn = lambda o: w[radius - o]            # noqa: E731
                up_lim, dn_lim = n_total - 1 - gid, gid
            else:
                m = plane(q)
                up = lambda o: plane(q + o)             # noqa: E731
                dn = lambda o: plane(q - o)             # noqa: E731
                up_lim = min(n_total - 1 - gid, nb_in - 1 - q)
                dn_lim = min(gid, q)
            if mutate == "edge":
                up_lim += 1
            keep = m > 0
            for o in range(1, radius + 1):
                if o <= up_lim:
                    keep &= (m > up(o)) if mutate == "ties" else (m >= up(o))
                if o <= dn_lim:
                    keep &= (m >= dn(o)) if mutate == "ties" else (m > dn(o))
            g = np.where(keep, m, np.float32(0))
            out[:, i, :, cols] = g
            # Lanes past D hold 0: the warp's maximum starts from 0.
            mx = np.maximum(g.max(axis=-1), np.float32(0))
            if c0 == 0 or mutate == "rowmax":
                rmax[:, i] = mx
            else:
                rmax[:, i] = np.fmax(rmax[:, i], mx)
            kept += keep.sum(axis=-1)
            if radius <= WINDOW_RADIUS:
                w, nxt = w[1:] + [nxt], nxt2
            gid = gid + 1
            if gid == n_total and mutate != "wrap":
                gid = 0
    # Warps -> blocks of ROWS rows -> the cube's partials, summed.
    nblk = -(-R // ROWS)
    per_row = np.zeros((B, nblk * ROWS), np.int64)
    per_row[:, :R] = kept
    partials = per_row.reshape(B, nblk, ROWS).sum(axis=-1)
    return (out, rmax.reshape(B, NB * R),
            partials.sum(axis=-1).astype(np.int32))


def stimulus(shape, seed: int, kind: str) -> np.ndarray:
    """Sparse detection cubes: small integers (dense ties across beams),
    real-valued magnitudes, or adversarial values (NaN, +-inf, -0.0,
    negatives) among ties."""
    rng = np.random.default_rng(seed)
    x = np.where(rng.random(shape) < 0.3,
                 rng.integers(1, 4, shape), 0).astype(np.float32)
    if kind == "real":
        x = np.where(x > 0, rng.random(shape) * 1e4, 0).astype(np.float32)
    elif kind == "adversarial":
        bad = np.array([np.nan, np.inf, -np.inf, -0.0, -2.0, 3.0],
                       np.float32)
        pick = rng.random(shape) < 0.08
        x[pick] = bad[rng.integers(0, len(bad), int(pick.sum()))]
    return x


def twin(det: np.ndarray, radius: int, beam_offset=None, n_beams=0):
    g, rmax, n = BG.beam_group_plain(torch.as_tensor(det), radius,
                                     beam_offset, n_beams)
    return g.numpy(), rmax.numpy(), n.numpy()


def shard_of(cube: np.ndarray, sp: int, s: int, halo: int) -> np.ndarray:
    n_beams = cube.shape[1]
    bl = n_beams // sp
    idx = np.arange(s * bl - halo, (s + 1) * bl + halo) % n_beams
    return np.ascontiguousarray(cube[:, idx])


def bit_equal(a, b) -> bool:
    return all(np.array_equal(x.view(np.int32) if x.dtype == np.float32
                              else x,
                              y.view(np.int32) if y.dtype == np.float32
                              else y)
               for x, y in zip(a, b))


# (n_beams, R, D, radius, kind): radius 0-3 in the window and 4-5 read
# directly; NB 1, 3 and 8; D 128 (float4), 130 and 6 (one cell a lane; 130
# in 5 chunks); R 37, not a multiple of the 8 rows a block takes.
WHOLE = [(nb, 37, d, r, kind)
         for nb, d, r, kind in (
             (8, 128, 0, "ties"), (8, 128, 1, "ties"), (8, 128, 2, "ties"),
             (8, 128, 3, "ties"), (8, 128, 5, "ties"), (8, 128, 1, "real"),
             (8, 128, 2, "adversarial"), (3, 128, 1, "ties"),
             (3, 130, 2, "ties"), (3, 6, 3, "adversarial"),
             (1, 128, 1, "ties"), (1, 6, 2, "ties"), (8, 130, 1, "ties"),
             (8, 6, 2, "real"), (8, 136, 4, "adversarial"),
             (3, 256, 2, "ties"))]


@pytest.mark.parametrize("nb,R,D,radius,kind", WHOLE)
def test_plan_whole_cube_matches_twin(nb, R, D, radius, kind):
    det = stimulus((2, nb, R, D), seed=nb * 7 + radius + D, kind=kind)
    got = plan(det, radius)
    want = twin(det, radius)
    assert bit_equal(got, want)


# Shards of an 8-beam cube at sp 2 and 4, radius 1 and 2, each shard with
# its ring neighbours' planes (the global beam edges fall inside shards 0
# and sp - 1); also D 130 and 6.
SHARDS = [(sp, r, d) for sp in (2, 4) for r in (1, 2) for d in (128, 130)
          if r <= 8 // sp] + [(4, 2, 6)]


@pytest.mark.parametrize("sp,radius,D", SHARDS)
def test_plan_shards_match_twin_and_whole_cube(sp, radius, D):
    cube = stimulus((2, 8, 21, D), seed=sp * 10 + radius, kind="ties")
    whole = twin(cube, radius)
    bl = 8 // sp
    for s in range(sp):
        x = shard_of(cube, sp, s, radius)
        got = plan(x, radius, halo=radius, id0=s * bl - radius, n_total=8)
        want = twin(x, radius, beam_offset=s * bl, n_beams=8)
        assert bit_equal(got, want)
        cut = slice(s * bl, (s + 1) * bl)
        assert np.array_equal(got[0], whole[0][:, cut])
        assert np.array_equal(
            got[1], whole[1].reshape(2, 8, 21)[:, cut].reshape(2, -1))


def test_plan_shard_radius_beyond_window():
    """A shard with radius 4 (read directly, not in the window) of a
    16-beam cube at sp 2."""
    cube = stimulus((1, 16, 13, 128), seed=3, kind="adversarial")
    for s in range(2):
        x = shard_of(cube, 2, s, 4)
        got = plan(x, 4, halo=4, id0=s * 8 - 4, n_total=16)
        want = twin(x, 4, beam_offset=s * 8, n_beams=16)
        assert bit_equal(got, want)


def wrapped_shard(radius: int, D: int = 128):
    """A shard whose own planes run across the cube's end: beams 6, 7, 0, 1
    of an 8-beam cube (beam_offset 6), its global ids wrapping mid-walk."""
    cube = stimulus((2, 8, 11, D), seed=40 + radius, kind="ties")
    idx = np.arange(6 - radius, 10 + radius) % 8
    return cube, np.ascontiguousarray(cube[:, idx])


@pytest.mark.parametrize("radius", [1, 2, 4])
def test_plan_shard_across_the_cube_end(radius):
    cube, x = wrapped_shard(radius)
    got = plan(x, radius, halo=radius, id0=6 - radius, n_total=8)
    want = twin(x, radius, beam_offset=6, n_beams=8)
    assert bit_equal(got, want)
    whole = twin(cube, radius)
    assert np.array_equal(got[0], whole[0][:, [6, 7, 0, 1]])


MUTATIONS = ("ties", "edge", "wrap", "rowmax")


@pytest.mark.parametrize("mutate", MUTATIONS)
def test_plan_mutation_is_caught(mutate):
    """Each mutation disagrees with the twin on one of the cases."""
    caught = False
    for nb, R, D, radius, kind in WHOLE:
        det = stimulus((2, nb, R, D), seed=nb * 7 + radius + D, kind=kind)
        caught |= not bit_equal(plan(det, radius, mutate=mutate),
                                twin(det, radius))
    for sp, radius, D in SHARDS:
        cube = stimulus((2, 8, 21, D), seed=sp * 10 + radius, kind="ties")
        for s in range(sp):
            x = shard_of(cube, sp, s, radius)
            got = plan(x, radius, halo=radius, id0=s * (8 // sp) - radius,
                       n_total=8, mutate=mutate)
            caught |= not bit_equal(got, twin(x, radius,
                                              beam_offset=s * (8 // sp),
                                              n_beams=8))
    for radius in (1, 2):
        _, x = wrapped_shard(radius)
        got = plan(x, radius, halo=radius, id0=6 - radius, n_total=8,
                   mutate=mutate)
        caught |= not bit_equal(got, twin(x, radius, beam_offset=6,
                                          n_beams=8))
    assert caught, f"mutation {mutate!r} went unnoticed"
