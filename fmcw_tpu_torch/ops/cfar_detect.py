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

``prepadded_range=True`` is the CFAR step of the sharded processor
(``parallel/sharded.py``, JAX's ``parallel/sharded.py:401-411``): the map is
a range shard with ``halo_range`` rows exchanged from each neighbour on each
side, (..., R + 2 halo_range, D); the range axis does not wrap and the
outputs have the shard's R rows.  Block scale then takes the shard's
``scale_map`` (``ops/cfar.block_scale_map_sharded``).
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
                      scale_map: torch.Tensor | None = None,
                      prepadded_range: bool = False):
    """Plain twin: ``ops/cfar.cfar_2d`` -> (det, scale)."""
    det, _, scale = C.cfar_2d(mag, scale_override, cfar, scale_map=scale_map,
                              prepadded_range=prepadded_range)
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
                cfar: CfarParams, scale_map: torch.Tensor | None = None,
                prepadded_range: bool = False):
    """2D OS-CFAR detection of (..., R, D) int32 or float32 magnitude maps
    (with ``prepadded_range``, (..., R + 2 halo_range, D) range shards; see
    the module docstring).  Returns ``(det, scale)``: the zero-suppressed
    detection map in the map's type and the int32 scale map
    (``scale_override`` folded in), each (..., R, D), equal to
    ``ops/cfar.cfar_2d``'s.  Launches the CUDA kernel for a CUDA tensor;
    the plain twin for a CPU tensor."""
    if F._device_kind(mag) == "cpu":
        return cfar_detect_plain(mag, scale_override, cfar=cfar,
                                 scale_map=scale_map,
                                 prepadded_range=prepadded_range)
    C.check_supported(cfar)
    if mag.dtype not in (torch.int32, torch.float32):
        raise ValueError(f"cfar_detect kernel takes int32 or float32 maps, "
                         f"got {mag.dtype}")
    if int(scale_override) < 0:
        raise ValueError(f"scale_override must be >= 0, got {scale_override}")
    *lead, R_in, D = mag.shape
    pad = cfar.halo_range if prepadded_range else 0
    R = R_in - 2 * pad
    if cfar.halo_doppler >= D or R < 1:
        raise NotImplementedError(
            f"cfar_detect kernel: a {R_in}x{D} map with halo "
            f"({cfar.halo_range}, {cfar.halo_doppler})"
            f"{' prepadded' if prepadded_range else ''}")
    m = mag.reshape(-1, R_in, D).contiguous()
    B = m.shape[0]
    block = cfar.scale_mode == "block"
    if block:
        if scale_map is None and prepadded_range:
            raise ValueError(
                "scale_mode='block' on a prepadded (sharded) map needs the "
                "scale_map of block_scale_map_sharded")
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
        integer=int(m.dtype == torch.int32), prepadded=int(prepadded_range))
    det = torch.empty((B, R, D), dtype=m.dtype, device=m.device)
    scale = torch.empty((B, R, D), dtype=torch.int32, device=m.device)
    lib = kernels.load()
    err = lib.fmcw_cfar_detect(
        m.data_ptr(), scale_in.data_ptr() if block else None, det.data_ptr(),
        scale.data_ptr(), ctypes.byref(cfg),
        torch.cuda.current_stream(m.device).cuda_stream)
    kernels.check(err, "cfar_detect")
    cfar_detect.launches += 1
    return det.reshape(*lead, R, D), scale.reshape(*lead, R, D)
