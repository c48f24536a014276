"""Standalone 2D OS-CFAR detection by counting: the CUDA kernel
``csrc/cfar_detect.cu`` and its plain twin ``ops/cfar.cfar_2d``.

Port of ``fmcw_tpu/ops/cfar_pallas.cfar_2d_pallas_detect`` (kernels
``_kernel_detect``, per-cell scale, and ``_kernel_detect_scaled``, a scale
map computed outside the kernel) and of the dispatch of
``fmcw_tpu/ops/cfar.cfar_2d_auto(need_debug=False)``.  It is the CFAR step
of the staged chains (``frontend="staged"``): the fixed-point chain on int32
magnitude maps and JAX's float ``frontend="xla"`` chain on float32 maps.

``cfar_detect`` launches the kernel for a CUDA tensor and takes the plain
``cfar_2d`` for a CPU tensor; both return the same det and scale maps bit for
bit.  Block scale: the clutter-map scale comes from ``ops/cfar.
block_scale_map`` (a few plain PyTorch map passes, as JAX computes it in XLA
outside its kernel) unless the caller passes ``scale_map``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import kernels
from ..params import CfarParams
from . import cfar as C
from . import frontend as F

# Rows per block, and the most shared memory a tile may take.
TILE_ROWS = 64
_TILE_BYTES = 96 * 1024


def cfar_detect_plain(mag: torch.Tensor, scale_override: int = 0, *,
                      cfar: CfarParams,
                      scale_map: torch.Tensor | None = None):
    """Plain twin: ``ops/cfar.cfar_2d`` -> (det, scale)."""
    det, _, scale = C.cfar_2d(mag, scale_override, cfar, scale_map=scale_map)
    return det, scale


def _tile_rows(R: int, D: int, hr: int) -> int:
    t = math.gcd(R, TILE_ROWS)
    while t > 1 and (t + 2 * hr) * D * 4 > _TILE_BYTES:
        t //= 2
    if (t + 2 * hr) * D * 4 > _TILE_BYTES:
        raise NotImplementedError(
            f"cfar_detect kernel: a {R}x{D} map with halo {hr} does not fit "
            f"its shared-memory tile")
    return t


@kernels.counted
def cfar_detect(mag: torch.Tensor, scale_override: int = 0, *,
                cfar: CfarParams, scale_map: torch.Tensor | None = None):
    """2D OS-CFAR detection of (..., R, D) int32 or float32 magnitude maps.
    Returns ``(det, scale)``: the zero-suppressed detection map in the map's
    type and the int32 scale map (``scale_override`` folded in), equal to
    ``ops/cfar.cfar_2d``'s.  Launches the CUDA kernel for a CUDA tensor;
    the plain twin for a CPU tensor."""
    if F._device_kind(mag) == "cpu":
        return cfar_detect_plain(mag, scale_override, cfar=cfar,
                                 scale_map=scale_map)
    C.check_supported(cfar)
    if mag.dtype not in (torch.int32, torch.float32):
        raise ValueError(f"cfar_detect kernel takes int32 or float32 maps, "
                         f"got {mag.dtype}")
    if int(scale_override) < 0:
        raise ValueError(f"scale_override must be >= 0, got {scale_override}")
    *lead, R, D = mag.shape
    if cfar.halo_doppler >= D:
        raise NotImplementedError(
            f"cfar_detect kernel: Doppler halo {cfar.halo_doppler} >= {D}")
    m = mag.reshape(-1, R, D).contiguous()
    B = m.shape[0]
    block = cfar.scale_mode == "block"
    if block:
        if scale_map is None:
            scale_map = C.block_scale_map(m, cfar)
        scale_in = scale_map.reshape(B, R, D).to(torch.int32).contiguous()
    elif scale_map is not None:
        raise ValueError("scale_map applies to scale_mode='block'")
    cfg = kernels.CfarDetectConfig(
        batch=B, R=R, D=D, T=_tile_rows(R, D, cfar.halo_range),
        hr=cfar.halo_range, hd=cfar.halo_doppler, gr=cfar.guard_range,
        gd=cfar.guard_doppler, n_ref=cfar.n_ref,
        k=cfar.n_ref - cfar.rank_idx, scale_min=cfar.scale_min,
        scale_nom=cfar.scale_nom, scale_max=cfar.scale_max,
        block_mode=int(block), so=int(scale_override),
        integer=int(m.dtype == torch.int32))
    det = torch.empty_like(m)
    scale = torch.empty((B, R, D), dtype=torch.int32, device=m.device)
    lib = kernels.load()
    err = lib.fmcw_cfar_detect(
        m.data_ptr(), scale_in.data_ptr() if block else None, det.data_ptr(),
        scale.data_ptr(), ctypes.byref(cfg),
        torch.cuda.current_stream(m.device).cuda_stream)
    kernels.check(err, "cfar_detect")
    cfar_detect.launches += 1
    return det.reshape(*lead, R, D), scale.reshape(*lead, R, D)
