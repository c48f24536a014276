"""Cross-beam peak grouping with the top-K epilogues: the CUDA kernel
``csrc/beam_group.cu`` and its plain twin.

Port of ``fmcw_tpu/ops/cfar_pallas.peak_group_beams_pallas`` (kernel
``_kernel_beam_group``): ``ops/cfar.peak_group_beams`` on (batch, n_beams,
R, D) detection cubes, plus each row's maximum and each cube's detection
count, which ``ops/detect.topk_detections(row_max=, n_dets=)`` takes
directly.  ``beam_group`` launches the kernel for a CUDA tensor and takes
``beam_group_plain`` for a CPU tensor; both are bit-identical.

With ``beam_offset`` it is the sharded array model's entry (JAX runs
``peak_group_beams(beam_ids=)`` there, ``fmcw_tpu/parallel/sharded.py:
604-616``): a beam shard of a cube of ``n_beams`` beams, extended by
``radius`` neighbour planes on each side, grouped by global beam ids with the
cube's non-periodic edges; the shard's own planes come out.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from . import cfar as C
from . import frontend as F


def shard_beam_ids(n_in: int, radius: int, beam_offset: int,
                   n_beams: int) -> torch.Tensor:
    """Global beam ids of a shard's ``n_in`` planes, whose first own plane
    is beam ``beam_offset``, extended by ``radius`` planes on each side."""
    return (beam_offset + torch.arange(-radius, n_in - radius)) % n_beams


def beam_group_plain(det: torch.Tensor, radius: int = 1,
                     beam_offset: int | None = None, n_beams: int = 0):
    """Plain twin: ``peak_group_beams`` (by the global ids of a shard with
    ``beam_offset``, then its own planes), the row maxima (batch, NB * R)
    and the kept count (batch,) int32."""
    if beam_offset is None:
        g = C.peak_group_beams(det, radius)
    else:
        n_in = det.shape[-3]
        ids = shard_beam_ids(n_in, radius, beam_offset, n_beams)
        g = C.peak_group_beams(det, radius, beam_ids=ids)[
            ..., radius:n_in - radius, :, :]
    B = det.shape[0]
    return (g, g.amax(dim=-1).reshape(B, -1),
            (g > 0).sum(dim=(-3, -2, -1)).to(torch.int32))


@kernels.counted
def beam_group(det: torch.Tensor, radius: int = 1,
               beam_offset: int | None = None, n_beams: int = 0):
    """Cross-beam grouping of float32 (batch, NB, R, D) detection cubes:
    returns ``(grouped det, row_max (batch, NB * R), n_dets (batch,)
    int32)``.  With ``beam_offset``: ``det`` is a shard (batch, NB + 2
    radius, R, D) of a cube of ``n_beams`` beams, its first own plane beam
    ``beam_offset``, and the outputs cover its NB own planes (see the
    module docstring).  Launches the CUDA kernel for a CUDA tensor; the
    plain twin for a CPU tensor."""
    if det.dim() != 4:
        raise ValueError(f"expected det (batch, n_beams, R, D), got "
                         f"{tuple(det.shape)}")
    if int(radius) < 0:
        raise ValueError(f"radius must be >= 0, got {radius}")
    halo = 0 if beam_offset is None else int(radius)
    if det.shape[1] <= 2 * halo or (halo and n_beams < 1):
        raise ValueError(f"a beam shard with {halo} halo planes per side "
                         f"needs n_beams and more than {2 * halo} planes, "
                         f"got {tuple(det.shape)}, n_beams={n_beams}")
    if F._device_kind(det) == "cpu":
        return beam_group_plain(det, radius, beam_offset, n_beams)
    if halo > 32:
        raise NotImplementedError(f"beam_group kernel: a shard's radius is "
                                  f"at most 32, got {radius}")
    if det.dtype != torch.float32:
        raise NotImplementedError(f"beam_group kernel takes float32 cubes "
                                  f"(the float array model), got {det.dtype}")
    B, NB_in, R, D = det.shape
    NB = NB_in - 2 * halo
    m = det.contiguous()
    out = torch.empty((B, NB, R, D), dtype=torch.float32, device=m.device)
    row_max = torch.empty((B, NB * R), dtype=torch.float32, device=m.device)
    n_dets = torch.empty((B,), dtype=torch.int32, device=m.device)
    cfg = kernels.BeamGroupConfig(
        batch=B, NB=NB, R=R, D=D, radius=int(radius), halo=halo,
        id0=(int(beam_offset) - halo) if halo else 0,
        n_total=int(n_beams) if halo else NB)
    lib = kernels.load()
    err = lib.fmcw_beam_group(
        m.data_ptr(), out.data_ptr(), row_max.data_ptr(), n_dets.data_ptr(),
        ctypes.byref(cfg), torch.cuda.current_stream(m.device).cuda_stream)
    kernels.check(err, "beam_group")
    beam_group.launches += 1
    return out, row_max, n_dets
