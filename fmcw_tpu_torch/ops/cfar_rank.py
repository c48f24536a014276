"""2D OS-CFAR with its debug taps by bit-serial rank selection: the CUDA
kernel ``csrc/cfar_rank.cu`` and its plain twin ``cfar_rank_plain``.

Port of ``fmcw_tpu/ops/cfar_pallas.cfar_2d_pallas`` (kernel ``_kernel``, TPU
kernel row 9): the OS-CFAR over (..., R, D) float32 or int32 maps returning
``(det, threshold, scale)``, the threshold and scale maps being the
``dbg_threshold`` / ``dbg_scale`` taps of ``os_cfar_2d.vhd:34-35``.  Unlike
the counting kernels (``ops/cfar_detect``, kernel B) it forms the order
statistic ``est`` itself, by rank selection over the key bits:

* keys: integer maps by value; float maps by their IEEE bit patterns as
  int32 (so NaN, Inf and -0.0 rank as their patterns, as on the TPU);
* ``bits`` key bits are walked, float keys from bit 30 down, integer keys
  from bit ``bits - 1`` down (JAX's ``rank_bits`` / ``int_bits``); None is
  31, exact for any non-negative map.  With fewer float bits ``est`` is the
  order statistic with its low key bits cleared (16 bits, the production
  float default: under it by < 0.8%), so the det map may hold cells that
  the counting kernels reject — JAX on the TPU behaves the same way;
* the per-cell scale compares ``est`` with 1.5x / 0.5x the box-sum mean
  (``mean + (mean >> 1)`` / ``mean >> 1`` for integer maps), the mean from
  the full-minus-guard box sums in ``ops/cfar``'s order; a ``scale_map``
  (block scale) replaces it; ``scale_override`` folds in;
* ``threshold = est * scale``; ``det`` is the CUT where CUT > threshold.

``prepadded_range=True``: a range shard with ``halo_range`` exchanged rows on
each side, (..., R + 2 halo_range, D), the range axis not wrapped (the
sharded processor's CFAR tail).  ``cfar_rank`` launches the kernel for a
CUDA tensor and takes ``cfar_rank_plain`` for a CPU tensor; both give the
same three maps bit for bit.  The twin ranks by an exact top-k over the
(..., R, D, n_ref) training stack and then clears the key bits the walk
does not reach, so it needs n_ref values per cell of memory; the kernel
never builds the stack: it cuts the keys into bit planes and counts them
with population counts (``csrc/cfar_rank.cu``).

``cfar_rank_group`` is the kernel's grouping entry, the single-device debug
routes' CFAR step: the same maps with the det map peak-grouped
(``ops/cfar.peak_group``) in the kernel's epilogue, and the row maxima and
detection counts ``ops/detect.topk_detections`` takes; its twin is
``cfar_rank_group_plain``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import kernels
from ..golden.fixed_point import _window_offsets
from ..params import CfarParams
from . import cfar as C
from . import cfar_detect as CD
from . import frontend as F

# Key bits of the fixed chain's integer maps: its magnitudes are below 2^16
# (alpha-max-beta-min of int16, at most 45056), fmcw_tpu's int_bits=16.
INT_BITS = 16


def check_bits(bits: int | None) -> int:
    """The number of key bits walked: ``bits``, None meaning 31."""
    b = 31 if bits is None else int(bits)
    if not 1 <= b <= 31:
        raise ValueError(f"bits must be in [1, 31] or None, got {bits}")
    return b


def debug_bits(cfar: CfarParams, integer: bool,
               rank_bits: int | None) -> int | None:
    """The key bits the processors' debug taps rank on: exact for the block
    scale (JAX takes those taps from its exact XLA chain), ``INT_BITS`` for
    integer maps, ``rank_bits`` (``cfar_rank_bits``) for float maps."""
    if cfar.scale_mode == "block":
        return None
    return INT_BITS if integer else rank_bits


def cfar_rank_plain(mag: torch.Tensor, scale_override: int = 0, *,
                    cfar: CfarParams, bits: int | None = None,
                    scale_map: torch.Tensor | None = None,
                    prepadded_range: bool = False):
    """Plain twin of ``cfar_rank``: ``(det, threshold, scale)`` of (..., R,
    D) maps (see the module docstring)."""
    C.check_supported(cfar)
    b = check_bits(bits)
    hr, hd = cfar.halo_range, cfar.halo_doppler
    m = C._as_map(mag)
    integer = not m.is_floating_point()
    if prepadded_range:
        p = C._wrap_pad(m, 0, hd)
        m = m[..., hr:m.shape[-2] - hr, :]
    else:
        p = C._wrap_pad(m, hr, hd)
    R, D = m.shape[-2:]
    k = cfar.n_ref - cfar.rank_idx
    keys = p if integer else p.view(torch.int32)
    refs = torch.stack([keys[..., hr + dr:hr + dr + R, hd + dd:hd + dd + D]
                        for dr, dd in _window_offsets(cfar)], dim=-1)
    kth = torch.topk(refs, k, dim=-1).values[..., -1]
    del refs
    # What the walk reaches: no bit above the top one, none below the last.
    top = (1 << b) - 1 if integer else 0x7FFFFFFF
    low = 0 if integer else (1 << (31 - b)) - 1
    est = kth.clamp(0, top) & (top & ~low)
    if not integer:
        est = est.view(torch.float32)
    scale = C.block_scale(m, cfar, scale_map, prepadded_range)
    if scale is None:
        t_hi, t_lo = C.percell_thresholds(p, cfar)
        scale = torch.where(est > t_hi, cfar.scale_max,
                            torch.where(est < t_lo, cfar.scale_min,
                                        cfar.scale_nom)).to(torch.int32)
    scale = C._fold_override(scale, scale_override)
    threshold = est * (scale if integer else scale.to(torch.float32))
    det = torch.where(m > threshold, m, torch.zeros_like(m))
    return det, threshold, scale


def cfar_rank_group_plain(mag: torch.Tensor, scale_override: int = 0, *,
                          cfar: CfarParams, bits: int | None = None,
                          scale_map: torch.Tensor | None = None,
                          peak_group_radius: int = 0):
    """Plain twin of ``cfar_rank_group``: ``cfar_rank_plain``, then
    ``ops/cfar.peak_group`` of its det map, the row maxima of the grouped
    map's positive cells (0 where a row has none) and its detection
    count: ``(det, threshold, scale, row_max, n_dets)``."""
    det, threshold, scale = cfar_rank_plain(mag, scale_override, cfar=cfar,
                                            bits=bits, scale_map=scale_map)
    det = C.peak_group(det, peak_group_radius)
    row_max = det.clamp(min=0).amax(dim=-1)
    n_dets = (det > 0).sum(dim=(-2, -1)).to(torch.int32)
    return det, threshold, scale, row_max, n_dets


# Rows per block at most, and the shared memory a block may take so that
# two blocks share an SM.
TILE_ROWS = 32
_TILE_BYTES = 112 * 1024


def _launch(mag, scale_override, cfar, bits, scale_map, prepadded_range,
            pgr, name):
    """Launch csrc/cfar_rank.cu on a CUDA map: (det, threshold, scale,
    row_max, n_dets), the last two None without grouping (pgr = -1)."""
    b = check_bits(bits)
    hr, hd = cfar.halo_range, cfar.halo_doppler
    if 2 * hd + 1 > 32 or 2 * hr + 1 > 31:
        raise NotImplementedError(
            f"{name} kernel: a window of {2 * hr + 1} x {2 * hd + 1} cells "
            f"(at most 31 rows and 32 columns)")
    m, lead, R, D, block, scale_in = CD.kernel_inputs(
        mag, scale_override, cfar, scale_map, prepadded_range, name)
    B = m.shape[0]
    lib = kernels.load()
    cfg = kernels.CfarRankConfig(
        batch=B, R=R, D=D, T=math.gcd(R, TILE_ROWS), hr=hr, hd=hd,
        gr=cfar.guard_range, gd=cfar.guard_doppler, n_ref=cfar.n_ref,
        k=cfar.n_ref - cfar.rank_idx, scale_min=cfar.scale_min,
        scale_nom=cfar.scale_nom, scale_max=cfar.scale_max,
        block_mode=int(block), so=int(scale_override),
        integer=int(m.dtype == torch.int32), prepadded=int(prepadded_range),
        bits=b, pgr=pgr)
    while cfg.T > 1 and lib.fmcw_cfar_rank_smem(ctypes.byref(cfg)) > \
            _TILE_BYTES:
        cfg.T //= 2
    if lib.fmcw_cfar_rank_smem(ctypes.byref(cfg)) > _TILE_BYTES:
        raise NotImplementedError(
            f"{name} kernel: a {R}x{D} map with halo {hr} does not fit its "
            f"shared-memory tile")
    det = torch.empty((B, R, D), dtype=m.dtype, device=m.device)
    thr = torch.empty_like(det)
    scale = torch.empty((B, R, D), dtype=torch.int32, device=m.device)
    row_max = n_dets = None
    if pgr >= 0:
        row_max = torch.empty((B, R), dtype=m.dtype, device=m.device)
        n_dets = torch.zeros(B, dtype=torch.int32, device=m.device)
    err = lib.fmcw_cfar_rank(
        m.data_ptr(), scale_in.data_ptr() if block else None, det.data_ptr(),
        thr.data_ptr(), scale.data_ptr(),
        None if row_max is None else row_max.data_ptr(),
        None if n_dets is None else n_dets.data_ptr(), ctypes.byref(cfg),
        torch.cuda.current_stream(m.device).cuda_stream)
    kernels.check(err, name)
    maps = tuple(x.reshape(*lead, R, D) for x in (det, thr, scale))
    if pgr < 0:
        return maps
    return maps + (row_max.reshape(*lead, R), n_dets.reshape(*lead))


@kernels.counted
def cfar_rank(mag: torch.Tensor, scale_override: int = 0, *,
              cfar: CfarParams, bits: int | None = None,
              scale_map: torch.Tensor | None = None,
              prepadded_range: bool = False):
    """OS-CFAR with its debug taps over (..., R, D) int32 or float32 maps
    (with ``prepadded_range``, (..., R + 2 halo_range, D) range shards).
    Returns ``(det, threshold, scale)``, each (..., R, D): det and threshold
    in the map's type, scale int32 (``scale_override`` folded in).  ``bits``:
    the key bits ranked (module docstring), None = exact.  Block scale
    takes ``scale_map``, or computes ``ops/cfar.block_scale_map`` (not on a
    prepadded shard).  Launches the CUDA kernel for a CUDA tensor; the plain
    twin for a CPU tensor."""
    if F._device_kind(mag) == "cpu":
        return cfar_rank_plain(mag, scale_override, cfar=cfar, bits=bits,
                               scale_map=scale_map,
                               prepadded_range=prepadded_range)
    out = _launch(mag, scale_override, cfar, bits, scale_map,
                  prepadded_range, -1, "cfar_rank")
    cfar_rank.launches += 1
    return out


@kernels.counted
def cfar_rank_group(mag: torch.Tensor, scale_override: int = 0, *,
                    cfar: CfarParams, bits: int | None = None,
                    scale_map: torch.Tensor | None = None,
                    peak_group_radius: int = 0):
    """``cfar_rank`` with the peak grouping of the processors' debug routes
    in the kernel's epilogue: ``(det, threshold, scale, row_max, n_dets)``
    with det grouped as ``ops/cfar.peak_group(det, peak_group_radius)``,
    row_max (..., R) in the map's type and n_dets (...,) int32 for
    ``ops/detect.topk_detections``.  Whole maps only (no prepadded shard).
    Launches the CUDA kernel's grouping entry for a CUDA tensor; the plain
    twin for a CPU tensor."""
    if int(peak_group_radius) < 0:
        raise ValueError(f"peak_group_radius must be >= 0, got "
                         f"{peak_group_radius}")
    if F._device_kind(mag) == "cpu":
        return cfar_rank_group_plain(mag, scale_override, cfar=cfar,
                                     bits=bits, scale_map=scale_map,
                                     peak_group_radius=peak_group_radius)
    out = _launch(mag, scale_override, cfar, bits, scale_map, False,
                  int(peak_group_radius), "cfar_rank_group")
    cfar_rank_group.launches += 1
    return out
