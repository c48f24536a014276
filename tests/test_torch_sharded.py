"""The port's sharded processor on a real process group: gloo on the CPU,
one process per rank (torch.multiprocessing), for (dp, sp) = (1, 2) and
(2, 2) at 256x64 and (1, 4) at 512x64.

* Every rank's detection arrays, n_dets, saturation and non-finite counts
  (the whole batch, gathered over dp) and its map shards equal the port's
  single-device ``make_batch_processor(device="cpu")`` bit for bit, on the
  per-cell float, block-scale float, fused fixed and staged fixed routes,
  ``peak_group_radius`` 0 and 2, with and without ``mti_bypass`` and
  ``scale_override``.  Frame 0 saturates the Doppler window on the seam of
  the shards' ring.
* ``block_scale_map_sharded`` over the ring equals ``block_scale_map``.
* The sharded array model (``make_sharded_array_processor``: cubes over dp,
  beams over sp; the 3D CFAR on exchanged beam planes and cross-beam
  grouping by global beam ids) equals ``make_batch_array_processor(
  device="cpu")`` bit for bit, maps per (dp, beam) shard.
* Fixed mode's detection set equals JAX's ``make_sharded_processor(
  frontend="xla")`` on the conftest's 8-device CPU mesh, computed here.

Against hangs: the group meets through a file under the test's tmp path (no
ports), has a timeout, and the ranks must finish by a deadline.  The ranks
run ``run_rank`` of this module, which a spawned child imports: so this
module imports JAX and fmcw_tpu only inside the test that compares with
them, and the ranks import neither.
"""

import dataclasses
import datetime
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import fmcw_tpu_torch
from fmcw_tpu_torch import parity
from fmcw_tpu_torch.models import pipeline as tpl
from fmcw_tpu_torch.ops import cfar as TC
from fmcw_tpu_torch.parallel import mesh as TM, sharded as TSH

# Share the CPU with the other test workers (the suite runs 6 at once).
torch.set_num_threads(2)

DEADLINE_S = 120
PG_TIMEOUT_S = 60
P256 = fmcw_tpu_torch.RadarParams(n_range=256, n_doppler=64)
P512 = fmcw_tpu_torch.RadarParams(n_range=512, n_doppler=64)
WORLDS = {(1, 2): P256, (2, 2): P256, (1, 4): P512}

ROUTES = {
    "float-cell": ("cell", dict(mode="float32", frontend="fused")),
    "float-block": ("block", dict(mode="float32", frontend="fused")),
    "fixed-fused": ("cell", dict(mode="fixed", frontend="fused")),
    "fixed-staged": ("cell", dict(mode="fixed", frontend="auto")),
}
CONTROLS = {"plain": (False, 0), "bypass-so3": (True, 3)}
CASES = [(route, pgr, ctl) for route in ROUTES for pgr in (0, 2)
         for ctl in CONTROLS]


# ---------------------------------------------------------------------------
# The ranks (spawned processes)
# ---------------------------------------------------------------------------

def frames(p, n=4, seed=11):
    """Seeded noisy two-target frames, int16 (n, nd, nr, 2), the first with
    a near-full-scale tone on the top range bin (the seam of the shards'
    ring) whose Doppler window saturates."""
    from fmcw_tpu_torch.golden import reference
    rng = np.random.default_rng(seed)
    out = np.stack([tpl.complex_to_iq(reference.two_target_frame(p, seed=s))
                    for s in range(n)])
    out = out + rng.integers(-8, 8, out.shape).astype(np.int16)
    nr, nd = p.n_range, p.n_doppler
    z = 32000.0 * np.exp(2j * np.pi * ((nr - 1) * np.arange(nr)[None, :] / nr
                                       + 0.23 * np.arange(nd)[:, None]))
    out[0] = tpl.complex_to_iq(z.astype(np.complex64))
    return out


def clutter_map(nr, nd, seed=5):
    """A float32 map whose range quarters hold noise, a heavy-tailed clutter
    patch and a sparse one, so every block scale class occurs."""
    rng = np.random.default_rng(seed)
    m = rng.exponential(100.0, (nr, nd))
    q = nr // 4
    m[q:2 * q] = (np.where(rng.random((q, nd)) < 0.3, 10.0, 1.0)
                  * rng.uniform(90, 110, (q, nd)))
    m[2 * q:3 * q] = (np.where(rng.random((q, nd)) < 0.1, 100.0, 1.0)
                      * rng.uniform(9, 11, (q, nd)))
    return m.astype(np.float32)


# The array case: 8 elements x 8 beams, the 3D CFAR (quick window) and
# cross-beam grouping, 2 cubes.
ARRAY_KW = dict(n_elems=8, n_beams=8, ref_angle=1, beam_group_radius=1,
                peak_group_radius=1, include_maps=True)


def array_params(p):
    return p.replace(cfar=fmcw_tpu_torch.quick().cfar)


def cubes(p, n=2, seed=13):
    """A point source at steering sine 0.4 over 8 elements, int16 (n, 8,
    nd, nr, 2)."""
    from fmcw_tpu_torch.golden import reference
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n):
        z = np.asarray(reference.two_target_frame(p, seed=seed + b))
        out.append(np.stack([tpl.complex_to_iq(
            z * np.exp(2j * np.pi * 0.5 * e * 0.4)
            + rng.normal(0, 8, z.shape)) for e in range(8)]))
    return np.stack(out)


def run_rank(rank, world, init_method, dp, sp, cases, out_path):
    """Join the gloo group, build make_mesh(dp, sp, device="cpu") and run
    every case ``(name, params, kw, mti_bypass, scale_override)`` on the
    same full batch; also block_scale_map_sharded on this rank's shard of
    clutter_map, and the sharded array model on ``cubes``.  Saves {name:
    outputs} with torch.save to ``out_path.format(rank)``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        mesh = TM.make_mesh(dp, sp, device="cpu")
        results = {}
        for name, p, kw, bypass, so in cases:
            proc = TSH.make_sharded_processor(mesh, p, **kw)
            results[name] = proc(frames(p), bypass, so)
        p = cases[0][1]
        nrl = p.n_range // sp
        s = mesh.get_local_rank("sp")
        m = torch.as_tensor(clutter_map(p.n_range, p.n_doppler))
        block = p.cfar.__class__(scale_mode="block")
        for integer in (False, True):
            shard = m[s * nrl:(s + 1) * nrl]
            if integer:
                shard = shard.to(torch.int32)
            results[f"block_scale_map_sharded/{integer}"] = \
                TC.block_scale_map_sharded([shard], block,
                                           TSH.sp_ring(mesh).halo)[0]
        pa = array_params(p)
        results["array"] = TSH.make_sharded_array_processor(
            mesh, pa, **ARRAY_KW)(cubes(pa))
        results["modules"] = sorted({m.split(".")[0] for m in sys.modules})
        torch.save(results, out_path.format(rank))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------

def _params(p, scale):
    return p.replace(cfar=dataclasses.replace(p.cfar, scale_mode=scale))


def _case_kw(route, pgr):
    scale, kw = ROUTES[route]
    return scale, dict(kw, peak_group_radius=pgr, include_maps=True)


def _name(route, pgr, ctl):
    return f"{route}/r{pgr}/{ctl}"


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run every world's ranks once: {(dp, sp): [results of rank r]}."""
    out = {}
    for (dp, sp), p in WORLDS.items():
        d = tmp_path_factory.mktemp(f"dp{dp}sp{sp}")
        cases = []
        for route, pgr, ctl in CASES:
            scale, kw = _case_kw(route, pgr)
            cases.append((_name(route, pgr, ctl), _params(p, scale), kw,
                          *CONTROLS[ctl]))
        world = dp * sp
        ctx = mp.start_processes(
            run_rank, args=(world, f"file://{d}/pg", dp, sp, cases,
                              str(d / "rank{}.pt")),
            nprocs=world, join=False, start_method="spawn")
        try:
            end = time.monotonic() + DEADLINE_S
            while not ctx.join(timeout=2):
                if time.monotonic() > end:
                    pytest.fail(f"dp={dp} sp={sp}: ranks still running "
                                f"after {DEADLINE_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        out[(dp, sp)] = [torch.load(d / f"rank{r}.pt")
                         for r in range(world)]
    return out


def _single(p, route, pgr, ctl):
    scale, kw = _case_kw(route, pgr)
    return tpl.make_batch_processor(_params(p, scale), device="cpu", **kw)(
        frames(p), *CONTROLS[ctl])


@pytest.mark.parametrize("world", list(WORLDS), ids=lambda w: f"dp{w[0]}sp{w[1]}")
@pytest.mark.parametrize("route,pgr,ctl", CASES)
def test_sharded_equals_single_device(ranks, world, route, pgr, ctl):
    dp, sp = world
    p = WORLDS[world]
    want = _single(p, route, pgr, ctl)
    bl, nrl = 4 // dp, p.n_range // sp
    for rank, res in enumerate(ranks[world]):
        got = res[_name(route, pgr, ctl)]
        assert got.keys() == want.keys()
        d, s = divmod(rank, sp)
        for key, v in want.items():
            if key.endswith("_map"):
                v = v[d * bl:(d + 1) * bl, s * nrl:(s + 1) * nrl]
            assert torch.equal(got[key], v), (rank, key)
    assert int(want["n_dets"].min()) > 0
    if route.startswith("fixed") and ctl == "plain":
        assert int(want["saturation_count"][0]) > 0      # the seam frame


@pytest.mark.parametrize("integer", [False, True], ids=["float", "int"])
@pytest.mark.parametrize("world", list(WORLDS), ids=lambda w: f"dp{w[0]}sp{w[1]}")
def test_block_scale_map_sharded_equals_block_scale_map(ranks, world,
                                                        integer):
    dp, sp = world
    p = WORLDS[world]
    m = torch.as_tensor(clutter_map(p.n_range, p.n_doppler))
    if integer:
        m = m.to(torch.int32)
    want = TC.block_scale_map(m, fmcw_tpu_torch.CfarParams(
        scale_mode="block"))
    nrl = p.n_range // sp
    for rank, res in enumerate(ranks[world]):
        s = rank % sp
        got = res[f"block_scale_map_sharded/{integer}"]
        assert torch.equal(got, want[s * nrl:(s + 1) * nrl]), rank
    assert len(torch.unique(want)) == 3


@pytest.mark.parametrize("world", list(WORLDS), ids=lambda w: f"dp{w[0]}sp{w[1]}")
def test_sharded_array_equals_single_device(ranks, world):
    dp, sp = world
    pa = array_params(WORLDS[world])
    want = tpl.make_batch_array_processor(pa, device="cpu", **ARRAY_KW)(
        cubes(pa))
    bl, nbl = 2 // dp, 8 // sp
    for rank, res in enumerate(ranks[world]):
        got = res["array"]
        assert got.keys() == want.keys()
        d, s = divmod(rank, sp)
        for key, v in want.items():
            if key.endswith("_cube"):
                v = v[d * bl:(d + 1) * bl, s * nbl:(s + 1) * nbl]
            assert torch.equal(got[key], v), (rank, key)
    assert int(want["n_dets"].min()) > 0


def test_ranks_import_neither_jax_nor_fmcw_tpu(ranks):
    for world, results in ranks.items():
        for rank, res in enumerate(results):
            bad = {"jax", "jaxlib", "fmcw_tpu"} & set(res["modules"])
            assert not bad, (world, rank, bad)
            assert "fmcw_tpu_torch" in res["modules"]


def _jparams(p):
    import fmcw_tpu
    return fmcw_tpu.RadarParams(
        n_range=p.n_range, n_doppler=p.n_doppler, notch_mode=p.notch_mode,
        cfar=fmcw_tpu.CfarParams(**dataclasses.asdict(p.cfar)),
        tracker=fmcw_tpu.TrackerParams(**dataclasses.asdict(p.tracker)))


@pytest.mark.parametrize("world", list(WORLDS), ids=lambda w: f"dp{w[0]}sp{w[1]}")
def test_fixed_detection_set_equals_jax_sharded_xla(ranks, world):
    """Fixed mode, radius 2: every frame's detection set (the det map's
    cells) equals JAX's sharded XLA chain on the same mesh shape."""
    import jax
    from fmcw_tpu.parallel import mesh as JM, sharded as JSH
    dp, sp = world
    p = WORLDS[world]
    mesh = JM.make_mesh(dp=dp, sp=sp, devices=jax.devices()[:dp * sp])
    jout = JSH.make_sharded_processor(mesh, _jparams(p), mode="fixed",
                                      frontend="xla", peak_group_radius=2,
                                      include_maps=True)(frames(p))
    jdet = np.asarray(jout["det_map"])
    got = ranks[world]
    bl, nrl = 4 // dp, p.n_range // sp
    det = np.zeros_like(jdet)
    for rank, res in enumerate(got):
        d, s = divmod(rank, sp)
        det[d * bl:(d + 1) * bl, s * nrl:(s + 1) * nrl] = \
            res[_name("fixed-staged", 2, "plain")]["det_map"].numpy()
    for b in range(4):
        ok, report = parity.fixed_gate(parity.map_set(det[b]),
                                       parity.map_set(jdet[b]))
        assert ok, (b, report)
    assert np.array_equal(np.asarray(jout["n_dets"]),
                          ranks[world][0][_name("fixed-staged", 2, "plain")][
                              "n_dets"].numpy())


def test_processor_validates_mesh_shape_and_input():
    p = P256
    with pytest.raises(ValueError, match="must divide"):
        TSH.make_sharded_processor(TM.LocalMesh(1, 3, "cpu"), p)
    with pytest.raises(ValueError, match="halo_range"):
        TSH.make_sharded_processor(TM.LocalMesh(1, 64, "cpu"), p)
    proc = TSH.make_sharded_processor(TM.LocalMesh(2, 2, "cpu"), p)
    with pytest.raises(ValueError, match="divisible by dp"):
        proc(frames(p, n=3))
    with pytest.raises(ValueError, match="expected iq batch"):
        proc(frames(p)[:, :, :128])
    with pytest.raises(ValueError, match="per-cell"):
        TSH.make_sharded_processor(TM.LocalMesh(1, 2, "cpu"),
                                   _params(p, "block"), mode="fixed",
                                   frontend="fused")
    # The debug taps run on the kernel routes (the rank-select CFAR tail),
    # equal to the single device; fixed "fused" has none, as on one device.
    kw = dict(include_debug=True, include_maps=True, peak_group_radius=2)
    dbg = TSH.make_sharded_processor(TM.LocalMesh(1, 2, "cpu"), p, **kw)
    want = tpl.make_batch_processor(p, device="cpu", **kw)(frames(p))
    got = dbg(frames(p))
    assert dbg.route == "fused" and got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    # The scale tap in the magnitude map's type, float32 as JAX's
    # (tests/test_torch_split.py holds it against JAX's traced dtype).
    assert got["scale_map"].dtype == want["scale_map"].dtype == torch.float32
    with pytest.raises(ValueError, match="debug taps"):
        TSH.make_sharded_processor(TM.LocalMesh(1, 2, "cpu"), p,
                                   mode="fixed", frontend="fused",
                                   include_debug=True)
    with pytest.raises(NotImplementedError):
        TSH.make_sharded_processor(TM.LocalMesh(1, 2, "cpu"),
                                   p.replace(n_doppler=256))
    # The sharded array model is ported (tests/test_torch_sharded_array.py).
    assert TSH.make_sharded_array_processor(
        TM.LocalMesh(1, 2, "cpu"), p).route == "fused"
    with pytest.raises(ValueError):
        TM.LocalMesh(0, 2, "cpu")
