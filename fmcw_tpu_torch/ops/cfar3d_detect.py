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

Reflect edges (``CfarParams.edge_mode="reflect"``, numpy's mirror on all
three axes, the beam axis not for a prepadded shard) are the kernel's
reflect entry: the same counting on tile rows that carry their mirrored
column halo (pitch D + 2 halo_doppler), the beam planes and rows mirrored
at the cube's edges.  It takes a single mirror: ref_angle + guard_angle <
A (a whole cube), halo_range < R and halo_doppler < D; the twin
(``ops/cfar.cfar_3d`` on the mirrored cube) takes numpy's semantics beyond
that too.  Both sum the training set in the wrap kernel's separable order
on the mirrored cube (``ops/cfar.cfar_3d``'s docstring).

Planes wider than a tile of whole rows fits (above 1376 / 824 / 592
columns at the default window with 3 / 5 / 7 beam planes) are cut into
column chunks of W columns with their window halo, at the reflect entry's
layout (the whole cube's decisions bit for bit).  ``cfar3d_config`` plans
the tile on the host, so that the array processors ask it at build.
"""

from __future__ import annotations

import bisect
import ctypes
import functools

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
# Column chunks are multiples of this many columns.
CHUNK = 32


def cfar3d_detect_plain(cube: torch.Tensor, scale_override: int = 0, *,
                        cfar: CfarParams, ref_angle: int,
                        guard_angle: int = 0, prepadded_angle: bool = False):
    """Plain twin: ``ops/cfar.cfar_3d`` -> (det, scale); OS only, as the
    kernel (``ops/cfar.check_os_supported``), wrap or reflect edges."""
    C.check_os_supported(cfar)
    det, _, scale = C.cfar_3d(cube, scale_override, cfar, ref_angle,
                              guard_angle, prepadded_angle=prepadded_angle)
    return det, scale


def _tile_bytes(T: int, P: int, ha: int, hr: int) -> int:
    np_ = 2 * ha + 1
    return np_ * ((T + 2 * hr) * P + T * P) * 4


def _plan(R: int, ha: int, hr: int, shapes):
    """(T, strip, W) for the first tier that fits among ``shapes``, (W,
    pitch, chunks a tile of rows), widest first; None where none does.
    Strips of STRIP rows: T from STRIP to min(64, max(R, STRIP)) within
    _TILE_BYTES, the least strip columns over the map (ceil(R / T) blocks
    of ceil(T / STRIP) strips, times the chunks' W columns), ties to the
    larger W, then T; a last block past R decides wrapped rows and stores
    none of them.  Then T = STRIP within _MAX_BYTES; then strips of one
    cell, T < STRIP."""
    def strip_cols(t, w, n):
        return (R + t - 1) // t * ((t + STRIP - 1) // STRIP) * n * w

    # A tile grows with T: the rows that fit are STRIP .. the largest.
    top = range(STRIP, min(64, max(R, STRIP)) + 1)
    cands = [(strip_cols(t, w, n), -w, -t) for w, p, n in shapes
             for t in top[:bisect.bisect_right(
                 top, False,
                 key=lambda t: _tile_bytes(t, p, ha, hr) > _TILE_BYTES)]]
    if cands:
        _, w, t = min(cands)
        return -t, STRIP, -w
    for t, strip in [(STRIP, STRIP)] + [(t, 1) for t in range(STRIP - 1, 0,
                                                                -1)]:
        for w, p, _ in shapes:
            if _tile_bytes(t, p, ha, hr) <= _MAX_BYTES:
                return t, strip, w
    return None


@functools.lru_cache(maxsize=None)
def tile_plan(R: int, D: int, ha: int, hr: int, hd: int,
              reflect: bool = False) -> tuple[int, int, int]:
    """(T, strip, W) of the kernel's blocks for an R x D map with 2 ha + 1
    beam planes and halo (hr, hd): whole rows (W = D; tile rows of D cells,
    the reflect entry's D + 2 hd) by ``_plan``'s tiers, as the kernel has
    always taken them; else column chunks, W a multiple of CHUNK below D,
    tile rows of W + 2 hd cells; else NotImplementedError."""
    plan = _plan(R, ha, hr, [(D, D + 2 * hd if reflect else D, 1)])
    if plan is None:
        plan = _plan(R, ha, hr, [(w, w + 2 * hd, -(-D // w)) for w in
                                 range((D - 1) // CHUNK * CHUNK, 0, -CHUNK)])
    if plan is None:
        raise NotImplementedError(
            f"cfar3d_detect kernel: a {R}x{D} map with {2 * ha + 1} beam "
            f"planes and halo ({hr}, {hd}) does not fit its shared-memory "
            f"tile")
    return plan


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
    kernel does not take (under reflect, more than a single mirror)."""
    C.check_os_supported(cfar)
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
    reflect = cfar.edge_mode == "reflect"
    if reflect and (cfar.halo_range >= R or (not prepadded_angle
                                              and ha >= A)):
        raise NotImplementedError(
            f"cfar3d_detect kernel: reflect edges take a single mirror: "
            f"halo_range {cfar.halo_range} < {R} rows and ref_angle + "
            f"guard_angle {ha} < {A} beams")
    offs = C._offsets_3d(cfar, ref_angle, guard_angle)
    n_ref = len(offs)
    k = n_ref - min((n_ref * cfar.rank_pct) // 100, n_ref - 1)
    T, strip, W = tile_plan(R, D, ha, cfar.halo_range, cfar.halo_doppler,
                            reflect)
    return kernels.Cfar3dConfig(
        batch=B, A=A, R=R, D=D, T=T,
        ha=ha, ga=guard_angle, hr=cfar.halo_range, hd=cfar.halo_doppler,
        gr=cfar.guard_range, gd=cfar.guard_doppler, n_ref=n_ref, k=k,
        scale_min=cfar.scale_min, scale_nom=cfar.scale_nom,
        scale_max=cfar.scale_max, so=int(scale_override),
        integer=int(integer), prepadded=int(prepadded_angle), strip=strip,
        packed=int(strip == STRIP
                   and n_ref <= MAX_PACKED_REF[bool(integer)]),
        reflect=int(reflect), W=W)


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
