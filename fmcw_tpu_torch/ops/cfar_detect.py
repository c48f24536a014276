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


def tile_rows(R: int, D: int, hr: int, name: str = "cfar_detect") -> int:
    """Rows per block: a divisor of R whose tile fits ``_TILE_BYTES``."""
    t = math.gcd(R, TILE_ROWS)
    while t > 1 and (t + 2 * hr) * D * 4 > _TILE_BYTES:
        t //= 2
    if (t + 2 * hr) * D * 4 > _TILE_BYTES:
        raise NotImplementedError(
            f"{name} kernel: a {R}x{D} map with halo {hr} does not fit its "
            f"shared-memory tile")
    return t


def kernel_inputs(mag: torch.Tensor, scale_override: int, cfar: CfarParams,
                  scale_map: torch.Tensor | None, prepadded_range: bool,
                  name: str):
    """Validate a CFAR kernel's map and lay it out for the kernel (shared
    with ``ops/cfar_rank``): returns ``(m (B, R_in, D) contiguous, lead
    dims, R, D, block mode, the int32 (B, R, D) scale map or None)``; the
    block scale map is computed here when none is given."""
    C.check_supported(cfar)
    if mag.dtype not in (torch.int32, torch.float32):
        raise ValueError(f"{name} kernel takes int32 or float32 maps, got "
                         f"{mag.dtype}")
    if int(scale_override) < 0:
        raise ValueError(f"scale_override must be >= 0, got {scale_override}")
    *lead, R_in, D = mag.shape
    pad = cfar.halo_range if prepadded_range else 0
    R = R_in - 2 * pad
    if cfar.halo_doppler >= D or R < 1:
        raise NotImplementedError(
            f"{name} kernel: a {R_in}x{D} map with halo "
            f"({cfar.halo_range}, {cfar.halo_doppler})"
            f"{' prepadded' if prepadded_range else ''}")
    m = mag.reshape(-1, R_in, D).contiguous()
    scale_in = C.block_scale(m, cfar, scale_map, prepadded_range)
    block = scale_in is not None
    if block:
        scale_in = scale_in.reshape(m.shape[0], R, D).contiguous()
    return m, lead, R, D, block, scale_in


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
    m, lead, R, D, block, scale_in = kernel_inputs(
        mag, scale_override, cfar, scale_map, prepadded_range, "cfar_detect")
    B = m.shape[0]
    cfg = kernels.CfarDetectConfig(
        batch=B, R=R, D=D, T=tile_rows(R, D, cfar.halo_range),
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
