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

Reflect edges (``CfarParams.edge_mode="reflect"``, numpy's mirror) are
the kernel's reflect entry: the same counting on tile rows that carry
their mirrored column halo (the flat-stream entry's row pitch, D + 2
halo_doppler), the rows of a whole map mirrored at its first and last row
(a prepadded shard's rows arrive mirrored from the halo exchange).  It
takes a single mirror, halo_range < R and halo_doppler < D; the twin
(``ops/cfar.cfar_2d`` on ``ops/cfar._reflect_pad``) takes numpy's
semantics beyond that too.

``cfar_detect_group`` is the kernel's grouping entry, the single-device
staged routes' CFAR step: the same maps with the det map peak-grouped
(``ops/cfar.peak_group``) in the kernel's epilogue, and the row maxima and
detection counts ``ops/detect.topk_detections`` takes; its twin is
``cfar_detect_group_plain``.  It wraps only: grouping wraps whatever the
edges, so a reflect tile at the seam would need the windows of both edges
in one contiguous row window.  Reflect maps take ``cfar_detect_then_group``
(the reflect entry, then the plain ``peak_group``, as JAX groups in XLA
after its standalone kernel).

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
Maps wider than a tile of whole rows fits (above 1808 columns at the
default window with grouping radius 2) are cut into column chunks of W
columns with their window and grouping halo (the whole map's decisions
bit for bit); the flat-stream entry keeps whole rows.  ``check_kernel``
asks the same on the host, so that the processors refuse at build what
the kernel would refuse at the call.
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

# A block's threads, the cells of a thread's strip (csrc/cfar_tile.cuh's
# kStrip), the shared memory a block's tile takes when three blocks share an
# SM and the most a block may take, and the largest training set whose hi
# and lo counts the kernel packs in one count (float hi * 4096 + lo).
THREADS = 256
STRIP = 8
_TILE_BYTES = 72 * 1024
_MAX_BYTES = 227 * 1024
MAX_PACKED_REF = 4094
# Column chunks are multiples of this many columns.
CHUNK = 32


def cfar_detect_plain(mag: torch.Tensor, scale_override: int = 0, *,
                      cfar: CfarParams,
                      scale_map: torch.Tensor | None = None,
                      prepadded_range: bool = False):
    """Plain twin: ``ops/cfar.cfar_2d`` -> (det, scale); OS only, as the
    kernel (``ops/cfar.check_os_supported``)."""
    C.check_os_supported(cfar)
    det, _, scale = C.cfar_2d(mag, scale_override, cfar, scale_map=scale_map,
                              prepadded_range=prepadded_range)
    return det, scale


def cfar_detect_group_plain(mag: torch.Tensor, scale_override: int = 0, *,
                            cfar: CfarParams,
                            scale_map: torch.Tensor | None = None,
                            peak_group_radius: int = 0):
    """Plain twin of ``cfar_detect_group``: ``ops/cfar.cfar_2d_group``
    (``cfar_2d``, ``peak_group``, the row maxima and the detection count),
    ``(det, scale, row_max, n_dets)``; OS only, as the kernel.  It also
    takes reflect edges: the twin of ``cfar_detect_then_group``."""
    C.check_os_supported(cfar)
    return C.cfar_2d_group(mag, scale_override, cfar=cfar,
                           scale_map=scale_map,
                           peak_group_radius=peak_group_radius)


def tile_bytes(T: int, D: int, hr: int, pgr: int = -1,
               block: bool = False, pitch: int | None = None) -> int:
    """Shared memory of a block of T rows (``csrc/cfar_detect.cu``'s
    layout) that decides D columns: the tile's T + 2 (hr + pgr) rows of
    ``pitch`` cells (D; rows that carry their column halo: the flat-stream
    and reflect entries' D + 2 hd, a chunk's W + 2 (hd + pgr) for D = W +
    2 pgr decided columns); per-cell scale with hr > 0, the full and guard
    column sums of the T + 2 pgr decided rows; grouping (pgr >= 0), their
    decisions, T row maxima and 2 counts."""
    pg = max(pgr, 0)
    P = pitch or D
    rows = T + 2 * pg
    words = (T + 2 * (hr + pg)) * P
    if not block and hr > 0:
        words += 2 * rows * P
    if pgr >= 0:
        words += rows * D + T + 2
    return 4 * words


def _plan(R: int, hr: int, pgr: int, block: bool, shapes):
    """(T, strip, W) for the first tier that fits among ``shapes``, (W,
    decided columns, pitch, blocks a tile of rows), widest first; None
    where none does.  Strips of STRIP rows: T from STRIP to min(64, max(R,
    STRIP)) within _TILE_BYTES, the fewest strip steps a thread takes over
    the map (ceil(R / T) x chunks blocks of ceil(units / THREADS) steps, a
    unit a strip of one column of the T + 2 pgr decided rows), ties to the
    larger W, then T; a last block past R decides wrapped rows and stores
    none of them.  Then T = STRIP within _MAX_BYTES; then strips of one
    cell, T < STRIP."""
    pg = max(pgr, 0)

    def steps(t, nc, n):
        units = -(-(t + 2 * pg) // STRIP) * nc
        return -(-R // t) * n * -(-units // THREADS)

    def fits(t, nc, p, limit):
        return tile_bytes(t, nc, hr, pgr, block, p) <= limit

    # A tile grows with T: the rows that fit are STRIP .. the largest.
    top = range(STRIP, min(64, max(R, STRIP)) + 1)
    cands = [(steps(t, nc, n), -w, -t) for w, nc, p, n in shapes
             for t in top[:bisect.bisect_right(
                 top, False, key=lambda t: not fits(t, nc, p, _TILE_BYTES))]]
    if cands:
        _, w, t = min(cands)
        return -t, STRIP, -w
    for t, strip in [(STRIP, STRIP)] + [(t, 1) for t in range(STRIP - 1, 0,
                                                                -1)]:
        for w, nc, p, _ in shapes:
            if fits(t, nc, p, _MAX_BYTES):
                return t, strip, w
    return None


@functools.lru_cache(maxsize=None)
def tile_plan(R: int, D: int, hr: int, hd: int, pgr: int = -1,
              block: bool = False,
              mode: str = "wrap") -> tuple[int, int, int]:
    """(T, strip, W) of the kernel's blocks for an R x D map with halo (hr,
    hd) and grouping radius pgr (-1: none): whole rows (W = D; tile rows of
    D cells, or D + 2 hd for the reflect and flat-stream entries, ``mode``
    "reflect" / "flat") by ``_plan``'s tiers, as the kernel has always
    taken them; else (not "flat") column chunks, W a multiple of CHUNK
    below D, tile rows of W + 2 (hd + pgr) cells; else
    NotImplementedError."""
    pg = max(pgr, 0)
    plan = _plan(R, hr, pgr, block,
                 [(D, D, D if mode == "wrap" else D + 2 * hd, 1)])
    if plan is None and mode != "flat":
        plan = _plan(R, hr, pgr, block,
                     [(w, w + 2 * pg, w + 2 * (hd + pg), -(-D // w))
                      for w in range((D - 1) // CHUNK * CHUNK, 0, -CHUNK)])
    if plan is None:
        raise NotImplementedError(
            f"cfar_detect kernel: a {R}x{D} map with halo ({hr}, {hd})"
            f"{f' and grouping radius {pgr}' if pgr > 0 else ''} does not "
            f"fit its shared-memory tile")
    return plan


def float_max(cfar: CfarParams) -> int:
    """The largest |value| of an int32 tile that the kernel counts in float
    with the integer semantics: below 2^23, so that values, thresholds and
    q are exact in float; a column sum of 2 hr + 1 values at most 2^24,
    exact too; a box sum of (2 hr + 1) x (2 hd + 1) values below 2^31, so
    that no sum wraps."""
    nr, nd = 2 * cfar.halo_range + 1, 2 * cfar.halo_doppler + 1
    return min((1 << 23) - 1, (1 << 24) // nr, ((1 << 31) - 1) // (nr * nd))


def check_map(R: int, D: int, cfar: CfarParams, prepadded: bool,
              name: str) -> None:
    """The maps the CFAR kernels take (this one and ``ops/cfar_rank``'s):
    R >= 1 rows (a prepadded shard's own), halo_doppler < D, and under
    reflect edges a single mirror, halo_range < R for a whole map;
    NotImplementedError otherwise."""
    if (cfar.halo_doppler >= D or R < 1
            or (cfar.edge_mode == "reflect" and not prepadded
                and cfar.halo_range >= R)):
        raise NotImplementedError(
            f"{name} kernel: a {R}x{D} map with halo "
            f"({cfar.halo_range}, {cfar.halo_doppler})"
            f"{' prepadded' if prepadded else ''}")


def kernel_inputs(mag: torch.Tensor, scale_override: int, cfar: CfarParams,
                  scale_map: torch.Tensor | None, prepadded_range: bool,
                  name: str):
    """Validate a CFAR kernel's map and lay it out for the kernel (shared
    with ``ops/cfar_rank``, which refuses reflect edges itself): returns
    ``(m (B, R_in, D) contiguous, lead dims, R, D, block mode, the int32
    (B, R, D) scale map or None)``; the block scale map is computed here
    when none is given.  Reflect edges take a single mirror: halo_range <
    R (a whole map) and halo_doppler < D (``check_map``)."""
    C.check_os_supported(cfar)
    if mag.dtype not in (torch.int32, torch.float32):
        raise ValueError(f"{name} kernel takes int32 or float32 maps, got "
                         f"{mag.dtype}")
    if int(scale_override) < 0:
        raise ValueError(f"scale_override must be >= 0, got {scale_override}")
    *lead, R_in, D = mag.shape
    pad = cfar.halo_range if prepadded_range else 0
    R = R_in - 2 * pad
    check_map(R, D, cfar, prepadded_range, name)
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
    given; ``pgr`` >= 0: the grouping entry, wrap edges only;
    ``cfar.edge_mode == "reflect"``: the reflect entry, its rows carrying
    the mirrored column halo); raises NotImplementedError for a tile that
    does not fit."""
    reflect = cfar.edge_mode == "reflect"
    if reflect and pgr >= 0:
        C.check_wrap(cfar, "cfar_detect_group")
    T, strip, W = tile_plan(R, D, cfar.halo_range, cfar.halo_doppler, pgr,
                            block, "reflect" if reflect else "wrap")
    return kernels.CfarDetectConfig(
        batch=B, R=R, D=D, T=T, hr=cfar.halo_range, hd=cfar.halo_doppler,
        gr=cfar.guard_range, gd=cfar.guard_doppler, n_ref=cfar.n_ref,
        k=cfar.n_ref - cfar.rank_idx, scale_min=cfar.scale_min,
        scale_nom=cfar.scale_nom, scale_max=cfar.scale_max,
        block_mode=int(block), so=int(scale_override), integer=int(integer),
        prepadded=int(prepadded), strip=strip,
        packed=int(strip == STRIP and cfar.n_ref <= MAX_PACKED_REF),
        pgr=pgr, float_max=float_max(cfar), reflect=int(reflect), W=W)


def check_kernel(R: int, D: int, cfar: CfarParams, pgr: int = -1,
                 block: bool = False, prepadded: bool = False,
                 name: str = "cfar_detect") -> None:
    """What the kernel takes, asked on the host (any device): OS, the map
    (``check_map``), the grouping entry's wrap edges and a tile
    (``detect_config``); raises NotImplementedError otherwise (ValueError
    for a variant other than OS)."""
    C.check_os_supported(cfar)
    check_map(R, D, cfar, prepadded, name)
    detect_config(1, R, D, cfar, prepadded=prepadded, block=block, pgr=pgr)


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
    # Chunks combine their row maxima into a zeroed row_max.
    row_max = (torch.empty if cfg.W == D else torch.zeros)(
        (B, R), dtype=m.dtype, device=m.device)
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
    ``ops/cfar.cfar_2d``'s, with ``cfar.edge_mode``'s edges (wrap or
    reflect).  Launches the CUDA kernel for a CUDA tensor; the plain twin
    for a CPU tensor."""
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
    ``ops/detect.topk_detections``.  Whole maps only (no prepadded shard),
    wrap edges only (``cfar_detect_then_group`` takes reflect).  Launches
    the CUDA kernel's grouping entry for a CUDA tensor; the plain twin for
    a CPU tensor."""
    if int(peak_group_radius) < 0:
        raise ValueError(f"peak_group_radius must be >= 0, got "
                         f"{peak_group_radius}")
    C.check_wrap(cfar, "cfar_detect_group")
    if F._device_kind(mag) == "cpu":
        return cfar_detect_group_plain(mag, scale_override, cfar=cfar,
                                       scale_map=scale_map,
                                       peak_group_radius=peak_group_radius)
    out = _launch(mag, scale_override, cfar, scale_map, False,
                  int(peak_group_radius), "cfar_detect_group")
    cfar_detect_group.launches += 1
    return out


def cfar_detect_then_group(mag: torch.Tensor, scale_override: int = 0, *,
                           cfar: CfarParams,
                           scale_map: torch.Tensor | None = None,
                           peak_group_radius: int = 0):
    """The reflect maps' CFAR step, with ``cfar_detect_group``'s outputs
    ``(det, scale, row_max, n_dets)``: ``cfar_detect`` (the kernel's
    reflect entry), then the plain ``ops/cfar.peak_group``, the row maxima
    and the detection count (``ops/cfar.group_and_count``).  Its twin is
    ``cfar_detect_group_plain``."""
    det, scale = cfar_detect(mag, scale_override, cfar=cfar,
                             scale_map=scale_map)
    return C.group_and_count(det, scale, peak_group_radius)


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
    T, strip, W = tile_plan(R, D, hr, hd, mode="flat")
    return kernels.CfarDetectConfig(
        batch=B, R=R, D=D, T=T, hr=hr, hd=hd, gr=sw.guard_range,
        gd=sw.guard_doppler, n_ref=sw.n_ref, k=sw.n_ref - sw.rank_idx,
        scale_min=sw.scale_min, scale_nom=sw.scale_nom,
        scale_max=sw.scale_max, block_mode=0, so=int(scale_override),
        integer=int(integer), prepadded=0, strip=strip,
        packed=int(strip == STRIP and sw.n_ref <= MAX_PACKED_REF), pgr=-1,
        float_max=float_max(sw), flat=1, start0=start0, stride=stride, W=W)


def check_flat_kernel(R: int, D: int, cfar: CfarParams) -> None:
    """The flat-stream entry's tile for R x D maps under ``cfar``'s crossed
    window (``flat_config``'s plan, whole rows), asked on the host;
    NotImplementedError where none fits."""
    sw = C.hw_stream_params(cfar)
    tile_plan(R, D, sw.halo_range, sw.halo_doppler, mode="flat")


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
