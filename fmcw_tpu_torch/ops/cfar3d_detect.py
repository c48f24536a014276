"""Angle-extended (3D) OS-CFAR detection by counting: the CUDA kernel
``csrc/cfar_3d_detect.cu`` and its plain twin ``ops/cfar.cfar_3d``.

Port of ``fmcw_tpu/ops/cfar_pallas.cfar_3d_pallas_detect`` (kernel
``_kernel_detect_3d``): the decision of ``cfar_3d`` with ``ref_angle > 0``
on (batch, A, R, D) beam cubes, float32 or int32, with a scalar
``scale_override``.  ``cfar3d_detect`` launches the kernel for a CUDA tensor
and takes the plain ``cfar_3d`` for a CPU tensor; both return the same det
and scale cubes bit for bit.  ``prepadded_angle=True`` is the sharded array
model's entry (JAX's ``cfar_3d(prepadded_angle=True)``): a beam shard with
``ref_angle + guard_angle`` exchanged planes on each side, the beam axis not
wrapped, its interior planes out.  The adaptive scale is per cell whatever
``cfar.scale_mode`` says (as JAX's XLA body computes it); JAX's kernel
refuses block mode, this one serves it, since the function is the same.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..params import CfarParams
from . import cfar as C
from . import frontend as F

# Rows per block are the largest power of two dividing R, at most 64, whose
# tile (2 ha + 1 planes of T + 2 hr rows, and their column sums) fits this
# many bytes of shared memory — three blocks per SM at the default window.
_TILE_BYTES = 72 * 1024
_MAX_BYTES = 227 * 1024


def cfar3d_detect_plain(cube: torch.Tensor, scale_override: int = 0, *,
                        cfar: CfarParams, ref_angle: int,
                        guard_angle: int = 0, prepadded_angle: bool = False):
    """Plain twin: ``ops/cfar.cfar_3d`` -> (det, scale)."""
    det, _, scale = C.cfar_3d(cube, scale_override, cfar, ref_angle,
                              guard_angle, prepadded_angle=prepadded_angle)
    return det, scale


def _tile_bytes(T: int, D: int, ha: int, hr: int) -> int:
    np_ = 2 * ha + 1
    return np_ * ((T + 2 * hr) * D + T * D) * 4


def _tile_rows(R: int, D: int, ha: int, hr: int) -> int:
    t = 64
    while t > 1 and (R % t or _tile_bytes(t, D, ha, hr) > _TILE_BYTES):
        t //= 2
    if _tile_bytes(t, D, ha, hr) > _MAX_BYTES:
        raise NotImplementedError(
            f"cfar3d_detect kernel: a {R}x{D} map with {2 * ha + 1} beam "
            f"planes and range halo {hr} does not fit its shared-memory tile")
    return t


def _check_angles(ref_angle: int, guard_angle: int) -> None:
    if ref_angle < 1 or guard_angle < 0:
        raise ValueError(f"cfar3d_detect takes ref_angle >= 1 and "
                         f"guard_angle >= 0 (ref_angle 0 is cfar_detect), "
                         f"got {ref_angle}, {guard_angle}")


def cfar3d_config(shape, cfar: CfarParams, ref_angle: int, guard_angle: int,
                  scale_override: int = 0, integer: bool = False,
                  prepadded_angle: bool = False):
    """The kernel's config for a (batch, A, R, D) cube (A + 2 ha planes
    with ``prepadded_angle``); raises NotImplementedError for what the
    kernel does not take."""
    C.check_supported(cfar)
    _check_angles(ref_angle, guard_angle)
    if int(scale_override) < 0:
        raise ValueError(f"scale_override must be >= 0, got {scale_override}")
    B, A, R, D = shape
    if cfar.halo_doppler >= D:
        raise NotImplementedError(
            f"cfar3d_detect kernel: Doppler halo {cfar.halo_doppler} >= {D}")
    ha = ref_angle + guard_angle
    if prepadded_angle:
        A -= 2 * ha
        if A < 1:
            raise ValueError(f"a prepadded cube needs more than 2 x {ha} "
                             f"planes, got {shape[1]}")
    offs = C._offsets_3d(cfar, ref_angle, guard_angle)
    n_ref = len(offs)
    k = n_ref - min((n_ref * cfar.rank_pct) // 100, n_ref - 1)
    return kernels.Cfar3dConfig(
        batch=B, A=A, R=R, D=D, T=_tile_rows(R, D, ha, cfar.halo_range),
        ha=ha, ga=guard_angle, hr=cfar.halo_range, hd=cfar.halo_doppler,
        gr=cfar.guard_range, gd=cfar.guard_doppler, n_ref=n_ref, k=k,
        scale_min=cfar.scale_min, scale_nom=cfar.scale_nom,
        scale_max=cfar.scale_max, so=int(scale_override),
        integer=int(integer), prepadded=int(prepadded_angle))


@kernels.counted
def cfar3d_detect(cube: torch.Tensor, scale_override: int = 0, *,
                  cfar: CfarParams, ref_angle: int, guard_angle: int = 0,
                  prepadded_angle: bool = False):
    """Angle-extended OS-CFAR detection of (..., A, R, D) int32 or float32
    beam cubes (``ref_angle >= 1``; with ``prepadded_angle``, beam shards
    (..., A + 2 ha, R, D), see the module docstring).  Returns ``(det,
    scale)``, each (..., A, R, D): the zero-suppressed detection cube in the
    cube's type and the int32 scale cube (``scale_override`` folded in),
    equal to ``ops/cfar.cfar_3d``'s.  Launches the CUDA kernel for a CUDA
    tensor; the plain twin for a CPU tensor."""
    if cube.dim() < 3:
        raise ValueError(f"expected a (..., A, R, D) cube, got "
                         f"{tuple(cube.shape)}")
    _check_angles(ref_angle, guard_angle)
    if F._device_kind(cube) == "cpu":
        return cfar3d_detect_plain(cube, scale_override, cfar=cfar,
                                   ref_angle=ref_angle,
                                   guard_angle=guard_angle,
                                   prepadded_angle=prepadded_angle)
    if cube.dtype not in (torch.int32, torch.float32):
        raise ValueError(f"cfar3d_detect kernel takes int32 or float32 "
                         f"cubes, got {cube.dtype}")
    *lead, A_in, R, D = cube.shape
    m = cube.reshape(-1, A_in, R, D).contiguous()
    cfg = cfar3d_config(tuple(m.shape), cfar, ref_angle, guard_angle,
                        scale_override, m.dtype == torch.int32,
                        prepadded_angle)
    A = cfg.A
    det = torch.empty((m.shape[0], A, R, D), dtype=m.dtype, device=m.device)
    scale = torch.empty(det.shape, dtype=torch.int32, device=m.device)
    lib = kernels.load()
    err = lib.fmcw_cfar_3d_detect(
        m.data_ptr(), det.data_ptr(), scale.data_ptr(), ctypes.byref(cfg),
        torch.cuda.current_stream(m.device).cuda_stream)
    kernels.check(err, "cfar3d_detect")
    cfar3d_detect.launches += 1
    return det.reshape(*lead, A, R, D), scale.reshape(*lead, A, R, D)
