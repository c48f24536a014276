"""The port's sharded array model (``parallel/sharded.
make_sharded_array_processor``: cubes over dp, beams over sp) on a
LocalMesh in this process, and its two kernel entries' twins, at 256x64,
8 elements x 8 beams.

* Every output equals the port's single-device ``make_batch_array_processor
  (device="cpu")`` bit for bit, for (dp, sp) in (1, 2), (2, 4), (1, 4):
  per-cell 2D CFAR with per-beam and cross-beam grouping, the 3D CFAR
  (ref_angle 1), and a beam halo of the full local beam extent (ref_angle +
  guard_angle and beam_group_radius = n_beams / sp); on the default route
  ("fused", the kernels' twins here), and on "staged" at dp 1, sp 4.
* The sharded model passes ``parity.array_gate`` against JAX's single-chip
  ``make_array_processor(frontend="xla")``.
* ``cfar_3d(prepadded_angle=True)`` and ``beam_group(beam_offset=)`` on a
  shard with its neighbours' planes equal the whole cube's interior planes;
  the prepadded twin equals JAX's ``cfar_3d(prepadded_angle=True)``.
* The halo gates raise ``ValueError``.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import fmcw_tpu
import fmcw_tpu_torch
from fmcw_tpu.models import pipeline as jpl
from fmcw_tpu.ops import cfar as JC
from fmcw_tpu_torch import parity
from fmcw_tpu_torch.golden import reference as tref
from fmcw_tpu_torch.models import pipeline as tpl
from fmcw_tpu_torch.ops import beam_group as BG, cfar as TC
from fmcw_tpu_torch.parallel import LocalMesh, make_sharded_array_processor

# Share the CPU with the other test workers (the suite runs 6 at once).
torch.set_num_threads(2)

P = fmcw_tpu_torch.RadarParams(n_range=256, n_doppler=64)
QUICK_P = P.replace(cfar=fmcw_tpu_torch.quick().cfar)
N_ELEMS = N_BEAMS = 8
U0 = 0.4                                   # the source's steering sine

CONFIGS = {
    "grouped": (P, dict(peak_group_radius=2, beam_group_radius=1)),
    "ref_angle1": (QUICK_P, dict(ref_angle=1)),
    "full-halo": (QUICK_P, dict(ref_angle=1, guard_angle=1,
                                beam_group_radius=2, peak_group_radius=1)),
}
MESHES = [(1, 2), (2, 4), (1, 4)]


def _matched_beam(u0, n_beams=N_BEAMS):
    u = np.linspace(-np.sin(np.deg2rad(60.0)), np.sin(np.deg2rad(60.0)),
                    n_beams)
    return int(np.argmin(np.abs(u - u0)))


def _cubes(p, n=2, seed=13):
    """Point sources at steering sine U0: per-element phase-shifted target
    frames plus independent noise, int16 (n, N_ELEMS, nd, nr, 2)
    (tests/test_torch_array.py's stimulus)."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n):
        z = np.asarray(tref.two_target_frame(p, seed=seed + b,
                                             targets=((60, 20, 12000),)))
        out.append(np.stack([tpl.complex_to_iq(
            z * np.exp(2j * np.pi * 0.5 * e * U0)
            + rng.normal(0, 8, z.shape) + 1j * rng.normal(0, 8, z.shape))
            for e in range(N_ELEMS)]))
    return np.stack(out)


def _jparams(p):
    return fmcw_tpu.RadarParams(
        n_range=p.n_range, n_doppler=p.n_doppler,
        cfar=fmcw_tpu.CfarParams(**dataclasses.asdict(p.cfar)))


# Every mesh on the default route; the staged route at dp 1, sp 4.
CASES = ([(m, name, "auto") for m in MESHES for name in CONFIGS]
         + [((1, 4), name, "staged") for name in CONFIGS])


@pytest.mark.parametrize("mesh,name,frontend", CASES,
                         ids=[f"dp{m[0]}sp{m[1]}-{n}-{f}"
                              for m, n, f in CASES])
def test_sharded_array_equals_single_device(mesh, name, frontend):
    p, kw = CONFIGS[name]
    iq = _cubes(p)
    kw = dict(kw, n_elems=N_ELEMS, n_beams=N_BEAMS, include_maps=True,
              frontend=frontend)
    if name == "full-halo" and mesh[1] != 4:
        kw.update(guard_angle=8 // mesh[1] - 1,
                  beam_group_radius=8 // mesh[1])
    want = tpl.make_batch_array_processor(p, device="cpu", **kw)(iq, True, 0)
    proc = make_sharded_array_processor(LocalMesh(*mesh, "cpu"), p, **kw)
    got = proc(iq, True, 0)
    assert got.keys() == want.keys()
    for key, v in want.items():
        assert torch.equal(got[key], v), key
    assert int(want["n_dets"].min()) > 0
    assert bool((want["beam_bin"][:, 0] == _matched_beam(U0)).all())
    if mesh == (1, 4) and name == "grouped":
        again = proc(iq, False, 3)
        ref = tpl.make_batch_array_processor(p, device="cpu", **kw)(
            iq, False, 3)
        assert all(torch.equal(again[k], ref[k]) for k in ref)


def test_sharded_array_gate_vs_jax_xla():
    """dp 1, sp 4, the 3D CFAR with cross-beam grouping, against JAX's
    single-chip XLA array model: the array gate with M = JAX's magnitude
    cube, T and S the plain cfar_3d's taps on it."""
    p, kw = QUICK_P, dict(ref_angle=1, beam_group_radius=1)
    iq = _cubes(p, n=1)
    ref = jax.tree.map(np.asarray, jpl.make_array_processor(
        _jparams(p), n_elems=N_ELEMS, n_beams=N_BEAMS, frontend="xla",
        **kw)(iq[0]))
    M = ref["mag_cube"]
    _, T, S = TC.cfar_3d(torch.tensor(M), 0, p.cfar, kw.get("ref_angle", 0),
                         kw.get("guard_angle", 0), need_debug=True)
    out = make_sharded_array_processor(
        LocalMesh(1, 4, "cpu"), p, n_elems=N_ELEMS, n_beams=N_BEAMS,
        include_maps=True, **kw)(iq)
    ok, report = parity.array_gate(
        parity.array_set(out, 0), parity.array_set(ref), M, T.numpy(),
        S.numpy(), radius=kw.get("peak_group_radius", 0),
        beam_radius=kw.get("beam_group_radius", 0),
        targets=[(60, 20, 12000)], target_beam=_matched_beam(U0),
        capacity=p.tracker.max_dets)
    assert ok, report
    assert np.max(np.abs(out["mag_cube"][0].numpy() - M)) <= 1e-5 * M.max()


def _ring_ext(x, s, bl, h, dim=-3):
    """Shard s of bl planes along ``dim`` with h planes of each neighbour,
    wrapped."""
    n = x.shape[dim]
    idx = torch.arange(s * bl - h, (s + 1) * bl + h) % n
    return x.index_select(dim, idx)


@pytest.mark.parametrize("sp", [2, 4])
def test_shard_entries_equal_whole_cube(sp):
    """The prepadded 3D CFAR and the global-ids beam grouping on each shard
    with its exchanged planes equal the whole cube's interior planes; the
    prepadded twin equals JAX's cfar_3d(prepadded_angle=True)."""
    rng = np.random.default_rng(sp)
    cube = torch.as_tensor(rng.exponential(100.0, (2, N_BEAMS, 64, 32))
                           .astype(np.float32))
    cfar = fmcw_tpu_torch.quick().cfar
    bl = N_BEAMS // sp
    for ra, ga in ((1, 0), (1, bl - 1)):
        ha = ra + ga
        det, scale = TC.cfar_3d(cube, 2 if ga else 0, cfar, ra, ga)[::2]
        for s in range(sp):
            ext = _ring_ext(cube, s, bl, ha)
            d, _, sc = TC.cfar_3d(ext, 2 if ga else 0, cfar, ra, ga,
                                  prepadded_angle=True)
            assert torch.equal(d, det[:, s * bl:(s + 1) * bl])
            assert torch.equal(sc, scale[:, s * bl:(s + 1) * bl])
            if s == 0 and not ga and sp == 2:
                jd, _, js = JC.cfar_3d(jnp.asarray(ext[0].numpy()), 0,
                                       cfar=fmcw_tpu.CfarParams(
                                           **dataclasses.asdict(cfar)),
                                       ref_angle=ra, guard_angle=ga,
                                       method="xla", prepadded_angle=True)
                assert np.array_equal(d[0].numpy(), np.asarray(jd))
    dets = torch.where(cube > 150.0, cube, torch.zeros_like(cube))
    dets[:, :, 5, 5] = 500.0                     # ties across every beam
    for r in range(1, bl + 1):
        g, rmax, n = BG.beam_group(dets, r)
        for s in range(sp):
            gs, rs, ns = BG.beam_group(_ring_ext(dets, s, bl, r), r,
                                       beam_offset=s * bl, n_beams=N_BEAMS)
            assert torch.equal(gs, g[:, s * bl:(s + 1) * bl])
            assert torch.equal(
                rs, rmax.reshape(2, N_BEAMS, -1)[:, s * bl:(s + 1) * bl]
                .reshape(2, -1))
            assert torch.equal(ns, (gs > 0).sum(dim=(1, 2, 3)).int())
        assert int(n.sum()) > 0
    with pytest.raises(ValueError):
        TC.cfar_3d(cube, 0, cfar, 0, 0, prepadded_angle=True)


def test_halo_gates_raise():
    mesh = LocalMesh(1, 4, "cpu")
    with pytest.raises(ValueError, match="angle halo"):
        make_sharded_array_processor(mesh, QUICK_P, ref_angle=2,
                                     guard_angle=1)
    with pytest.raises(ValueError, match="beam_group_radius"):
        make_sharded_array_processor(mesh, P, beam_group_radius=3)
    with pytest.raises(ValueError, match="divide"):
        make_sharded_array_processor(LocalMesh(1, 3, "cpu"), P)
    proc = make_sharded_array_processor(LocalMesh(2, 2, "cpu"), QUICK_P)
    with pytest.raises(ValueError, match="divisible by dp"):
        proc(_cubes(QUICK_P, n=3))
    with pytest.raises(ValueError, match="element-space"):
        proc(_cubes(QUICK_P)[:, :4])
    # One mesh of a single shard per frame block: the single device's path.
    one = make_sharded_array_processor(LocalMesh(2, 1, "cpu"), QUICK_P,
                                       ref_angle=2, guard_angle=1)
    assert one.route == "fused"
