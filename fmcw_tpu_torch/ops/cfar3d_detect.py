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

# Rows per block (T) are chosen so that the tile (2 ha + 1 planes of T + 2
# hr rows, and their column sums) fits this many bytes of shared memory —
# three blocks per SM at the default window (T = 16: 67.6 KB) — with the
# least strip work over the map's rows; the kernel's thread takes a strip
# of STRIP rows of one column (csrc/cfar_tile.cuh's kStrip).  A tile whose
# 8 rows do not fit in _MAX_BYTES takes strips of one cell.
_TILE_BYTES = 72 * 1024
_MAX_BYTES = 227 * 1024
STRIP = 8
# The largest training set whose hi and lo counts the kernel packs in one
# count: float hi * 4096 + lo (cfar_tile.cuh's kMaxPackedRef<float>), int
# hi * 65536 + lo below 2^31.
MAX_PACKED_REF = {False: 4094, True: 32767}


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


def tile_plan(R: int, D: int, ha: int, hr: int) -> tuple[int, int]:
    """(T, strip) of the kernel's blocks for an R x D map with 2 ha + 1
    beam planes and range halo hr.  Strips of STRIP rows: T from STRIP to
    min(64, max(R, STRIP)) within _TILE_BYTES, the least strip rows over the
    map (ceil(R / T) blocks of ceil(T / STRIP) strips), ties to the larger T;
    a last block past R decides wrapped rows and stores none of them.  When
    no such T fits, T = STRIP within _MAX_BYTES; then strips of one cell, T
    < STRIP; else NotImplementedError."""
    def strip_rows(t):
        return (R + t - 1) // t * ((t + STRIP - 1) // STRIP)

    fits = [t for t in range(STRIP, min(64, max(R, STRIP)) + 1)
            if _tile_bytes(t, D, ha, hr) <= _TILE_BYTES]
    if fits:
        return min(fits, key=lambda t: (strip_rows(t), -t)), STRIP
    if _tile_bytes(STRIP, D, ha, hr) <= _MAX_BYTES:
        return STRIP, STRIP
    for t in range(STRIP - 1, 0, -1):
        if _tile_bytes(t, D, ha, hr) <= _MAX_BYTES:
            return t, 1
    raise NotImplementedError(
        f"cfar3d_detect kernel: a {R}x{D} map with {2 * ha + 1} beam "
        f"planes and range halo {hr} does not fit its shared-memory tile")


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
    T, strip = tile_plan(R, D, ha, cfar.halo_range)
    return kernels.Cfar3dConfig(
        batch=B, A=A, R=R, D=D, T=T,
        ha=ha, ga=guard_angle, hr=cfar.halo_range, hd=cfar.halo_doppler,
        gr=cfar.guard_range, gd=cfar.guard_doppler, n_ref=n_ref, k=k,
        scale_min=cfar.scale_min, scale_nom=cfar.scale_nom,
        scale_max=cfar.scale_max, so=int(scale_override),
        integer=int(integer), prepadded=int(prepadded_angle), strip=strip,
        packed=int(strip == STRIP
                   and n_ref <= MAX_PACKED_REF[bool(integer)]))


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
