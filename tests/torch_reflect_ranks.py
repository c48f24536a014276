"""The gloo ranks of ``tests/test_torch_reflect.py``'s DistRing case, in a
module of their own so that the spawned ranks import neither JAX nor the
JAX package: each rank joins a (1, world) mesh, runs the reflect-edge
sharded processors on ``frames()`` and ``block_scale_map_sharded`` on its
shard of ``block_map()``, and saves the outputs with torch.save."""

import dataclasses
import datetime

import numpy as np
import torch
import torch.distributed as dist

import fmcw_tpu_torch
from fmcw_tpu_torch.golden import reference
from fmcw_tpu_torch.models import pipeline
from fmcw_tpu_torch.ops import cfar as C
from fmcw_tpu_torch.parallel import mesh as M, sharded

QUICK = fmcw_tpu_torch.quick()
# "mode/scale_mode" of each sharded processor the ranks run.
CASES = ("float32/cell", "float32/block", "fixed/cell")
BLOCK = fmcw_tpu_torch.CfarParams(ref_range=2, ref_doppler=2, guard_range=1,
                                  guard_doppler=1, edge_mode="reflect",
                                  scale_mode="block", scale_block=4)


def params(scale_mode: str):
    return QUICK.replace(cfar=dataclasses.replace(
        QUICK.cfar, edge_mode="reflect", scale_mode=scale_mode,
        scale_block=4))


def frames() -> np.ndarray:
    """Two frames of the golden targets and two on the first and last range
    bins but one, whose windows reach across the map's edges."""
    targets = reference.golden_targets(QUICK) + [(1, 3.0, 6000.0),
                                                 (126, -5.0, 6000.0)]
    return np.stack([pipeline.complex_to_iq(reference.two_target_frame(
        QUICK, seed=s, targets=targets)) for s in range(2)])


def block_map() -> torch.Tensor:
    """A float32 map with clutter in its first rows (the clipped edge)."""
    m = np.random.default_rng(11).exponential(100.0, (128, 64))
    m[:8] *= 9
    return torch.as_tensor(m.astype(np.float32))


def run_rank(rank, world, init_method, out_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = M.make_mesh(1, world, device="cpu")
        res = {}
        for key in CASES:
            mode, scale = key.split("/")
            res[key] = sharded.make_sharded_processor(
                mesh, params(scale), mode=mode, peak_group_radius=2,
                include_maps=True)(frames())
        n = 128 // world
        res["block_scale"] = C.block_scale_map_sharded(
            [block_map()[rank * n:(rank + 1) * n]], BLOCK,
            sharded.sp_ring(mesh).halo)[0]
        torch.save(res, out_path.format(rank))
    finally:
        dist.destroy_process_group()
