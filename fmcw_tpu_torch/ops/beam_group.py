"""Cross-beam peak grouping with the top-K epilogues: the CUDA kernel
``csrc/beam_group.cu`` and its plain twin.

Port of ``fmcw_tpu/ops/cfar_pallas.peak_group_beams_pallas`` (kernel
``_kernel_beam_group``): ``ops/cfar.peak_group_beams`` on (batch, n_beams,
R, D) detection cubes, plus each row's maximum and each cube's detection
count, which ``ops/detect.topk_detections(row_max=, n_dets=)`` takes
directly.  ``beam_group`` launches the kernel for a CUDA tensor and takes
``beam_group_plain`` for a CPU tensor; both are bit-identical.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from . import cfar as C
from . import frontend as F


def beam_group_plain(det: torch.Tensor, radius: int = 1):
    """Plain twin: ``peak_group_beams``, then the row maxima (batch,
    n_beams * R) and the kept count (batch,) int32."""
    g = C.peak_group_beams(det, radius)
    B = det.shape[0]
    return (g, g.amax(dim=-1).reshape(B, -1),
            (g > 0).sum(dim=(-3, -2, -1)).to(torch.int32))


@kernels.counted
def beam_group(det: torch.Tensor, radius: int = 1):
    """Cross-beam grouping of float32 (batch, n_beams, R, D) detection
    cubes: returns ``(grouped det, row_max (batch, n_beams * R), n_dets
    (batch,) int32)``.  Launches the CUDA kernel for a CUDA tensor; the
    plain twin for a CPU tensor."""
    if det.dim() != 4:
        raise ValueError(f"expected det (batch, n_beams, R, D), got "
                         f"{tuple(det.shape)}")
    if int(radius) < 0:
        raise ValueError(f"radius must be >= 0, got {radius}")
    if F._device_kind(det) == "cpu":
        return beam_group_plain(det, radius)
    if det.dtype != torch.float32:
        raise NotImplementedError(f"beam_group kernel takes float32 cubes "
                                  f"(the float array model), got {det.dtype}")
    B, NB, R, D = det.shape
    m = det.contiguous()
    out = torch.empty_like(m)
    row_max = torch.empty((B, NB * R), dtype=torch.float32, device=m.device)
    n_dets = torch.zeros((B,), dtype=torch.int32, device=m.device)
    cfg = kernels.BeamGroupConfig(batch=B, NB=NB, R=R, D=D,
                                  radius=int(radius))
    lib = kernels.load()
    err = lib.fmcw_beam_group(
        m.data_ptr(), out.data_ptr(), row_max.data_ptr(), n_dets.data_ptr(),
        ctypes.byref(cfg), torch.cuda.current_stream(m.device).cuda_stream)
    kernels.check(err, "beam_group")
    beam_group.launches += 1
    return out, row_max, n_dets
