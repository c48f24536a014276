"""The (dp, sp) mesh of the sharded frame processor.

Port of ``fmcw_tpu/parallel/mesh.py``.  Two parallel axes:

* ``dp`` — frames: each group of shards processes whole frames of its own;
* ``sp`` — within a frame: chirps sharded for the range FFT, the corner
  turn as an all-to-all, range bins sharded for the slow-time step and the
  CFAR (rtl/src/corner_turner.vhd:79-80).

Two kinds of mesh run the same processor (``parallel/sharded.py``):

* ``make_mesh`` — a ``torch.distributed`` DeviceMesh over the ranks of the
  default process group, one (dp, sp) shard per rank: NCCL with one GPU
  per rank (``device=None`` or "cuda"), or gloo on the CPU ("cpu").  On a
  machine with N GPUs, start one rank per GPU with
  ``torchrun --nproc_per_node=N script.py``; ``make_mesh`` starts the
  process group from torchrun's environment (``maybe_init_distributed``),
  or uses the one the caller started with ``init_process_group``.
* ``LocalMesh`` — every shard in this process, one after another; the
  collectives become slices of the shards' tensors, so each kernel sees
  exactly the inputs it would see on a mesh of dp x sp devices.  It runs
  the sharded path on one GPU (or the CPU).
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from ..device import resolve_device


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def _bind_gpu(dev: torch.device) -> None:
    """Make this rank's GPU current: LOCAL_RANK (torchrun), else the rank
    modulo the visible GPUs."""
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                                   if dist.is_initialized() else 0))
        torch.cuda.set_device(local % torch.cuda.device_count())


def maybe_init_distributed(device=None, timeout=None) -> bool:
    """Start the default process group from torchrun's environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK) when it is set and no
    group is up: NCCL on cuda:LOCAL_RANK for ``device`` None or "cuda"
    (raises without a GPU), gloo for "cpu".  Returns whether a default
    group is up."""
    if dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    dev = resolve_device(device)
    _bind_gpu(dev)
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(_backend(dev), **kw)
    return True


def mesh_shape(n: int, dp: int | None = None,
               sp: int | None = None) -> tuple[int, int]:
    """(dp, sp) for ``n`` shards, JAX's defaults: sp = n and dp = 1 when
    neither is given, else the other one fills n; dp * sp must be n."""
    if sp is None and dp is None:
        dp, sp = 1, n
    elif sp is None:
        sp = n // dp
    elif dp is None:
        dp = n // sp
    if dp < 1 or sp < 1 or dp * sp != n:
        raise ValueError(f"dp*sp = {dp}*{sp} != {n} ranks")
    return dp, sp


def make_mesh(dp: int | None = None, sp: int | None = None, device=None):
    """A ('dp', 'sp') DeviceMesh over the default process group's ranks:
    ``device`` None means NCCL on CUDA (raises without a GPU, and never
    falls back to gloo); "cpu" means gloo.  Defaults: sp = the world size,
    dp = 1; dp * sp must equal the world size.  Starts the process group
    from torchrun's environment if none is up, else raises."""
    dev = resolve_device(device)
    if not maybe_init_distributed(dev):
        raise RuntimeError(
            "make_mesh needs torch.distributed: run under torchrun or call "
            "torch.distributed.init_process_group first")
    backend = dist.get_backend()
    if backend != _backend(dev):
        raise ValueError(f"a {dev.type} mesh needs the {_backend(dev)} "
                         f"backend, the process group runs {backend}")
    dp, sp = mesh_shape(dist.get_world_size(), dp, sp)
    _bind_gpu(dev)
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, (dp, sp), mesh_dim_names=("dp", "sp"))


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """A dp x sp mesh whose shards all run in this process, one after
    another, on ``device`` (None means CUDA; raises without a GPU)."""

    dp: int = 1
    sp: int = 1
    device: torch.device | str | None = None

    def __post_init__(self):
        mesh_shape(self.dp * self.sp, self.dp, self.sp)
        object.__setattr__(self, "device", resolve_device(self.device))
