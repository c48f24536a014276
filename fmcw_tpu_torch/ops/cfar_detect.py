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

``cfar_detect_group`` is the kernel's grouping entry, the single-device
staged routes' CFAR step: the same maps with the det map peak-grouped
(``ops/cfar.peak_group``) in the kernel's epilogue, and the row maxima and
detection counts ``ops/detect.topk_detections`` takes; its twin is
``cfar_detect_group_plain``.

``cfar_detect_hw_stream`` is the kernel's flat-stream entry, the decision
of the hw-compat streaming CFAR (``cfar_geometry="hw_stream"``; JAX's
``_kernel_detect`` with ``prepadded_range="both"`` behind
``fmcw_tpu/ops/cfar._hw_stream_decide_pallas``): the per-cell decisions of
R x D cells of a batch of flat ext streams with the crossed window, read
straight from the streams (no padded copy); its twin is
``ops/cfar.hw_stream_decide_plain``, and ``ops/cfar.cfar_2d_hw_stream``
frames the streams around either.

The kernel's blocks (``tile_plan``): T range rows a block, strips of
``STRIP`` cells of one column a thread, the tile within ``_TILE_BYTES`` of
shared memory so that three blocks share an SM; an int32 tile whose values
lie within ``float_max`` is counted in float (``csrc/cfar_detect.cu``).
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..params import CfarParams
from . import cfar as C
from . import frontend as F

# A block's threads, the cells of a thread's strip (csrc/cfar_tile.cuh's
# kStrip), the shared memory a block's tile takes when three blocks share an
# SM and the most a block may take, and the largest training set whose hi
# and lo counts the kernel packs in one count (float hi * 4096 + lo).
THREADS = 256
STRIP = 8
_TILE_BYTES = 72 * 1024
_MAX_BYTES = 227 * 1024
MAX_PACKED_REF = 4094


def cfar_detect_plain(mag: torch.Tensor, scale_override: int = 0, *,
                      cfar: CfarParams,
                      scale_map: torch.Tensor | None = None,
                      prepadded_range: bool = False):
    """Plain twin: ``ops/cfar.cfar_2d`` -> (det, scale)."""
    det, _, scale = C.cfar_2d(mag, scale_override, cfar, scale_map=scale_map,
                              prepadded_range=prepadded_range)
    return det, scale


def cfar_detect_group_plain(mag: torch.Tensor, scale_override: int = 0, *,
                            cfar: CfarParams,
                            scale_map: torch.Tensor | None = None,
                            peak_group_radius: int = 0):
    """Plain twin of ``cfar_detect_group``: ``cfar_detect_plain``, then
    ``ops/cfar.peak_group`` of its det map, the row maxima of the grouped
    map's positive cells (0 where a row has none) and its detection
    count: ``(det, scale, row_max, n_dets)``."""
    det, scale = cfar_detect_plain(mag, scale_override, cfar=cfar,
                                   scale_map=scale_map)
    det = C.peak_group(det, peak_group_radius)
    row_max = det.clamp(min=0).amax(dim=-1)
    n_dets = (det > 0).sum(dim=(-2, -1)).to(torch.int32)
    return det, scale, row_max, n_dets


def tile_bytes(T: int, D: int, hr: int, pgr: int = -1,
               block: bool = False, pitch: int | None = None) -> int:
    """Shared memory of a block of T rows (``csrc/cfar_detect.cu``'s
    layout): the tile's T + 2 (hr + pgr) rows of ``pitch`` cells (D; the
    flat-stream entry's D + 2 hd); per-cell scale with hr > 0, the full and
    guard column sums of the T + 2 pgr decided rows; grouping (pgr >= 0),
    their decisions, T row maxima and 2 counts."""
    pg = max(pgr, 0)
    P = pitch or D
    rows = T + 2 * pg
    words = (T + 2 * (hr + pg)) * P
    if not block and hr > 0:
        words += 2 * rows * P
    if pgr >= 0:
        words += rows * D + T + 2
    return 4 * words


def tile_plan(R: int, D: int, hr: int, pgr: int = -1,
              block: bool = False,
              pitch: int | None = None) -> tuple[int, int]:
    """(T, strip) of the kernel's blocks for an R x D map with range halo
    hr and grouping radius pgr (-1: none).  Strips of STRIP rows: T from
    STRIP to min(64, max(R, STRIP)) within _TILE_BYTES, the fewest strip
    steps a thread takes over the map (ceil(R / T) blocks of ceil(units /
    THREADS) steps, a unit a strip of one column of the T + 2 pgr decided
    rows), ties to the larger T; a last block past R decides wrapped rows
    and stores none of them.  When no such T fits, T = STRIP within
    _MAX_BYTES; then strips of one cell, T < STRIP; else
    NotImplementedError."""
    pg = max(pgr, 0)

    def steps(t):
        units = -(-(t + 2 * pg) // STRIP) * D
        return -(-R // t) * -(-units // THREADS)

    def fits(t, limit):
        return tile_bytes(t, D, hr, pgr, block, pitch) <= limit

    cands = [t for t in range(STRIP, min(64, max(R, STRIP)) + 1)
             if fits(t, _TILE_BYTES)]
    if cands:
        return min(cands, key=lambda t: (steps(t), -t)), STRIP
    if fits(STRIP, _MAX_BYTES):
        return STRIP, STRIP
    for t in range(STRIP - 1, 0, -1):
        if fits(t, _MAX_BYTES):
            return t, 1
    raise NotImplementedError(
        f"cfar_detect kernel: a {R}x{D} map with halo {hr}"
        f"{f' and grouping radius {pgr}' if pgr > 0 else ''} does not fit "
        f"its shared-memory tile")


def float_max(cfar: CfarParams) -> int:
    """The largest |value| of an int32 tile that the kernel counts in float
    with the integer semantics: below 2^23, so that values, thresholds and
    q are exact in float; a column sum of 2 hr + 1 values at most 2^24,
    exact too; a box sum of (2 hr + 1) x (2 hd + 1) values below 2^31, so
    that no sum wraps."""
    nr, nd = 2 * cfar.halo_range + 1, 2 * cfar.halo_doppler + 1
    return min((1 << 23) - 1, (1 << 24) // nr, ((1 << 31) - 1) // (nr * nd))


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


def detect_config(B: int, R: int, D: int, cfar: CfarParams,
                  scale_override: int = 0, integer: bool = False,
                  prepadded: bool = False, block: bool = False,
                  pgr: int = -1):
    """The kernel's config for B maps of R x D (``block``: a scale map is
    given; ``pgr`` >= 0: the grouping entry); raises NotImplementedError
    for a tile that does not fit."""
    T, strip = tile_plan(R, D, cfar.halo_range, pgr, block)
    return kernels.CfarDetectConfig(
        batch=B, R=R, D=D, T=T, hr=cfar.halo_range, hd=cfar.halo_doppler,
        gr=cfar.guard_range, gd=cfar.guard_doppler, n_ref=cfar.n_ref,
        k=cfar.n_ref - cfar.rank_idx, scale_min=cfar.scale_min,
        scale_nom=cfar.scale_nom, scale_max=cfar.scale_max,
        block_mode=int(block), so=int(scale_override), integer=int(integer),
        prepadded=int(prepadded), strip=strip,
        packed=int(strip == STRIP and cfar.n_ref <= MAX_PACKED_REF),
        pgr=pgr, float_max=float_max(cfar))


def _launch(mag, scale_override, cfar, scale_map, prepadded_range, pgr,
            name):
    """Launch csrc/cfar_detect.cu on a CUDA map: (det, scale), then
    row_max and n_dets with grouping (pgr >= 0)."""
    m, lead, R, D, block, scale_in = kernel_inputs(
        mag, scale_override, cfar, scale_map, prepadded_range, name)
    B = m.shape[0]
    cfg = detect_config(B, R, D, cfar, scale_override,
                        m.dtype == torch.int32, prepadded_range, block, pgr)
    det = torch.empty((B, R, D), dtype=m.dtype, device=m.device)
    scale = torch.empty((B, R, D), dtype=torch.int32, device=m.device)
    lib = kernels.load()
    stream = torch.cuda.current_stream(m.device).cuda_stream
    maps = (m.data_ptr(), scale_in.data_ptr() if block else None,
            det.data_ptr(), scale.data_ptr())
    if pgr < 0:
        err = lib.fmcw_cfar_detect(*maps, ctypes.byref(cfg), stream)
        kernels.check(err, name)
        return det.reshape(*lead, R, D), scale.reshape(*lead, R, D)
    row_max = torch.empty((B, R), dtype=m.dtype, device=m.device)
    n_dets = torch.zeros(B, dtype=torch.int32, device=m.device)
    err = lib.fmcw_cfar_detect_group(*maps, row_max.data_ptr(),
                                     n_dets.data_ptr(), ctypes.byref(cfg),
                                     stream)
    kernels.check(err, name)
    return (det.reshape(*lead, R, D), scale.reshape(*lead, R, D),
            row_max.reshape(*lead, R), n_dets.reshape(lead))


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
    out = _launch(mag, scale_override, cfar, scale_map, prepadded_range, -1,
                  "cfar_detect")
    cfar_detect.launches += 1
    return out


@kernels.counted
def cfar_detect_group(mag: torch.Tensor, scale_override: int = 0, *,
                      cfar: CfarParams,
                      scale_map: torch.Tensor | None = None,
                      peak_group_radius: int = 0):
    """``cfar_detect`` with the peak grouping of the staged routes in the
    kernel's epilogue: ``(det, scale, row_max, n_dets)`` with det grouped
    as ``ops/cfar.peak_group(det, peak_group_radius)``, row_max (..., R) in
    the map's type and n_dets (...,) int32 for
    ``ops/detect.topk_detections``.  Whole maps only (no prepadded shard).
    Launches the CUDA kernel's grouping entry for a CUDA tensor; the plain
    twin for a CPU tensor."""
    if int(peak_group_radius) < 0:
        raise ValueError(f"peak_group_radius must be >= 0, got "
                         f"{peak_group_radius}")
    if F._device_kind(mag) == "cpu":
        return cfar_detect_group_plain(mag, scale_override, cfar=cfar,
                                       scale_map=scale_map,
                                       peak_group_radius=peak_group_radius)
    out = _launch(mag, scale_override, cfar, scale_map, False,
                  int(peak_group_radius), "cfar_detect_group")
    cfar_detect_group.launches += 1
    return out


def flat_config(B: int, R: int, D: int, start0: int, stride: int,
                cfar: CfarParams, scale_override: int = 0,
                integer: bool = False):
    """The flat-stream entry's config for B ext streams of ``stride`` cells
    (R x D cells decided from ``start0``), the window ``cfar`` crossed
    (``ops/cfar.hw_stream_params``); raises ValueError where a window would
    read beyond a stream and NotImplementedError for a tile that does not
    fit."""
    sw = C.hw_stream_params(cfar)
    hr, hd = sw.halo_range, sw.halo_doppler
    if start0 - hr * D - hd < 0 or start0 + (R + hr) * D + hd > stride:
        raise ValueError(f"ext streams of {stride} cells do not hold the "
                         f"windows of {R}x{D} cells from {start0}")
    T, strip = tile_plan(R, D, hr, pitch=D + 2 * hd)
    return kernels.CfarDetectConfig(
        batch=B, R=R, D=D, T=T, hr=hr, hd=hd, gr=sw.guard_range,
        gd=sw.guard_doppler, n_ref=sw.n_ref, k=sw.n_ref - sw.rank_idx,
        scale_min=sw.scale_min, scale_nom=sw.scale_nom,
        scale_max=sw.scale_max, block_mode=0, so=int(scale_override),
        integer=int(integer), prepadded=0, strip=strip,
        packed=int(strip == STRIP and sw.n_ref <= MAX_PACKED_REF), pgr=-1,
        float_max=float_max(sw), flat=1, start0=start0, stride=stride)


@kernels.counted
def cfar_detect_hw_stream(ext: torch.Tensor, start0: int, R: int, D: int,
                          scale_override: int = 0, *, cfar: CfarParams,
                          integer: bool):
    """The hw-compat streaming CFAR's decisions: R x D cells from
    ``start0`` of each of the ext streams (..., L) (int32 for ``integer``,
    else float32; ``ops/cfar.cfar_2d_hw_stream`` builds them), decided
    with the crossed window by counting.  Returns ``(det, scale)``, each
    (..., R, D) in decision order: det in the stream's type, scale int32
    (``scale_override`` folded in), equal to
    ``ops/cfar.hw_stream_decide_plain``'s.  Launches the kernel's
    flat-stream entry for a CUDA tensor; the plain twin for a CPU
    tensor."""
    if F._device_kind(ext) == "cpu":
        return C.hw_stream_decide_plain(ext, start0, R, D, scale_override,
                                        cfar=cfar, integer=integer)
    C.check_hw_stream(cfar)
    C.check_hw_stream_ext(ext, integer)
    if int(scale_override) < 0:
        raise ValueError(f"scale_override must be >= 0, got {scale_override}")
    *lead, L = ext.shape
    e = ext.reshape(-1, L).contiguous()
    B = e.shape[0]
    cfg = flat_config(B, R, D, start0, L, cfar, scale_override, integer)
    det = torch.empty((B, R, D), dtype=e.dtype, device=e.device)
    scale = torch.empty((B, R, D), dtype=torch.int32, device=e.device)
    lib = kernels.load()
    stream = torch.cuda.current_stream(e.device).cuda_stream
    err = lib.fmcw_cfar_detect_flat(e.data_ptr(), det.data_ptr(),
                                    scale.data_ptr(), ctypes.byref(cfg),
                                    stream)
    kernels.check(err, "cfar_detect_hw_stream")
    cfar_detect_hw_stream.launches += 1
    return det.reshape(*lead, R, D), scale.reshape(*lead, R, D)
