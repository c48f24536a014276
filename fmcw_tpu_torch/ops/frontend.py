"""The fused radar front-end as two CUDA kernels, with their plain twins.

Port of ``fmcw_tpu/ops/frontend_pallas.py::rdm_frontend(detect=True)``.  The
TPU kernel keeps a whole frame in VMEM; on the GPU it is split at the corner
turn, as ``fmcw_tpu/ops/split_frontend.py`` splits it across chips:

* ``range_fft`` (kernel A, ``csrc/range_fft.cu``): Hamming window and range
  FFT per chirp, stored range-major — int16 (B, nd, nr, 2) -> planar float32
  re/im (B, nr, nd); ``range_fft_float``, the same kernel's entry point for
  float32 planes (B, nd, nr) (the array model's beamformed data: the TPU
  kernel takes int16 or float32); n_range a power of two 16 .. 1024 or
  JAX's n2 x 128 with n2 <= 16 (``range_length_ok``: a dense o-point
  stage, then the power-of-two plan, ``range_fft_split``);
* ``slowtime_detect`` (kernel B, ``csrc/slowtime_detect.cu``): the
  slow-time chain (MTI, Doppler window, an FP32 Doppler FFT per range row),
  magnitude, 2D CFAR with per-cell or block scale (``csrc/cfar_tile.cuh``:
  OS by counting, CA/GO/SO from the training-window means), peak
  grouping, per-row maxima, detection and non-finite counts;
  ``slowtime_mag``, its magnitude-only entry point
  (``rdm_frontend(detect=False)``: the magnitude and the non-finite count,
  no CFAR).  Its twin folds the slow-time chain into one float32 matrix
  (``ops/fft.doppler_apply``); the two agree within 1e-5 of the peak.
  n_doppler 16, 32, 64 and 128, the long CPIs n2d x 128 (n2d 2 .. 16,
  JAX's long-CPI Doppler split, ``long_cpi``), the dense lengths (every
  other multiple of 8 below 2048, JAX's dense operator, ``dense_cpi``)
  and every length below 2048 off a multiple of 8 (the same operator,
  ``unaligned_cpi``; the fixed kernels do not take them yet): at the last
  three every entry runs the row transform into the magnitude map, then a
  decide kernel over tiles of rows x chunks of Doppler columns
  (``two_launch``, ``_slowtime_config``; csrc/slowtime_long.cuh, shared
  with the fixed kernel; off a multiple of 8 the last chunk is ragged),
  two launches that ``launches`` both counts.  Kernel A takes any chirp
  count (``check_range_geometry``).
  Short CPIs decide in tiles of 64 rows, or 32, 16 or 8 where 64 does not
  divide the rows or fit (``_short_tile``).

Each wrapper launches its kernel for a CUDA tensor and takes its plain
PyTorch twin (``range_fft_plain``, ``range_fft_float_plain``,
``slowtime_detect_plain``, ``slowtime_mag_plain``) only for a CPU tensor;
any other device raises.  Each wrapper's ``launches`` counts its kernel
launches (reset with ``reset_launch_counts``, which resets every kernel
wrapper of the port).
The fixed-point counterparts are in ``ops/frontend_fixed.py``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import kernels
from ..params import CfarParams, RadarParams
from . import cfar as C
from .fft import dft_apply, doppler_apply
from .magnitude import magnitude_float
from .notch import check_notch
from .window import hamming_float

# Range rows per kernel-B block.
TILE_ROWS = 64

# Kernel B's Doppler lengths: the short rows one warp transforms, the long
# CPIs n2d x kernels.LONG_CPI_INNER with 2 <= n2d <=
# kernels.LONG_CPI_MAX_SPLIT (JAX's long-CPI split,
# fmcw_tpu/models/pipeline.py _doppler_split, and its cap), and the dense
# lengths between (``dense_cpi``).
SHORT_CPIS = (16, 32, 64, 128)


reset_launch_counts = kernels.reset_launch_counts


def range_fft_plan(n: int) -> tuple[int, int]:
    """The two-pass factorisation of a power of two n = N1 x N2 (``Plan``
    in csrc/range_fft.cu, and the fixed range kernel's): N2 =
    2^floor(log2(n) / 2) lanes per chirp, N1 = n / N2 points per lane."""
    n2 = 1 << (n.bit_length() - 1) // 2
    return n // n2, n2


def range_length_ok(n: int) -> bool:
    """Does kernel A take n_range ``n``: a power of two 16 .. 1024, or
    JAX's n2 x 128 with n2 <= 16 (``fmcw_tpu/ops/frontend_pallas.py::
    _ct_split``, ``fmcw_tpu/models/pipeline.frontend_kernel_supported``)?"""
    pow2 = n > 0 and not n & (n - 1)
    return ((pow2 and 1 << kernels.RANGE_MIN_LOG2 <= n
             <= 1 << kernels.RANGE_MAX_LOG2)
            or (n > 0 and n % kernels.RANGE_SLICE == 0
                and n // kernels.RANGE_SLICE <= kernels.RANGE_MAX_SLICES))


def range_fft_split(n: int) -> tuple[int, int]:
    """Kernel A's n = o x m: the dense o-point stage before the radix-2
    m-point transform (``range_fft_plan(m)``).  o = 1 for the powers of
    two to 1024, 2 for 2048 (two 1024-point transforms), else the odd
    factor of n (3 .. 15)."""
    if n > 1 << kernels.RANGE_MAX_LOG2 and not n & (n - 1):
        return n >> kernels.RANGE_MAX_LOG2, 1 << kernels.RANGE_MAX_LOG2
    m = n & -n                          # the largest power of two in n
    return n // m, m


@functools.lru_cache(maxsize=32)
def _tables(n: int, device: str):
    """Kernel A constants on ``device``: the float window, and the twiddle
    table, computed in float64 then float32, (entries, 2) re/im pairs.
    With n = o x m (``range_fft_split``) and m = N1 x N2
    (``range_fft_plan``): first tw[ka N2 + t] = exp(-2 pi i t ka / m) for
    ka < N1, t < N2, between the m-point transform's two passes (a warp
    reads one ka's row coalesced); for o > 1 then the dense stage's
    exp(-2 pi i i1 k2 / n) at [m + k2 m + i1] (i1 < m, k2 < o) and
    exp(-2 pi i e / o) at [m + n + e] (e < o)."""
    o, m = range_fft_split(n)
    n1, n2 = range_fft_plan(m)
    ang = [np.outer(np.arange(n1), np.arange(n2)).ravel() / m]
    if o > 1:
        ang += [np.outer(np.arange(o), np.arange(m)).ravel() / n,
                np.arange(o) / o]
    ang = -2.0 * np.pi * np.concatenate(ang).astype(np.float64)
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    return (torch.as_tensor(hamming_float(n), device=device),
            torch.as_tensor(tw, device=device))


@functools.lru_cache(maxsize=32)
def _slowtime_tables(nd: int, device: str):
    """Kernel B constants on ``device``: the float Doppler window
    (``hamming_float``) and the twiddles tw[m] = exp(-2 pi i m / nd), m < nd,
    computed in float64 then float32 (nd, 2) re/im pairs: the lanes of the
    slow-time FFT read their stage twiddles W_2h^j = tw[j nd / 2h] and
    W_nd^(p k1) = tw[p k1] from it."""
    ang = -2.0 * np.pi * np.arange(nd, dtype=np.float64) / nd
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    return (torch.as_tensor(hamming_float(nd), device=device),
            torch.as_tensor(tw, device=device))


# Kernel B and the fixed slow-time kernel count the OS variant's training
# cells in float, hi and lo packed as hi * 4096 + lo (csrc/cfar_tile.cuh):
# exact up to this many.  The CA/GO/SO epilogue counts nothing.
MAX_PACKED_REFS = 4094

# SlowtimeConfig.variant: kernel B's decision epilogue (csrc/cfar_tile.cuh:
# the OS counting walks, or the CA/GO/SO window means).
VARIANT_CODES = {"os": 0, "ca": 1, "go": 2, "so": 3}


def _detect_config(cfg, cfar: CfarParams, notch_mode: int, transient: str,
                   mti_bypass, name: str):
    """The slow-time detection entries (kernel B's and the fixed kernel's):
    the shared tile geometry ``cfg`` (``_slowtime_config``) with the MTI
    fields set; raises NotImplementedError for an OS training set the
    packed count does not hold."""
    if cfar.variant == "os" and cfar.n_ref > MAX_PACKED_REFS:
        raise NotImplementedError(
            f"{name} kernel: at most {MAX_PACKED_REFS} training cells, got "
            f"{cfar.n_ref}")
    return _pulse_canceller(cfg, notch_mode, transient, mti_bypass)


def _pulse_canceller(cfg, notch_mode: int, transient: str, mti_bypass):
    """Set the slow-time kernels' MTI fields of ``cfg`` (2- or 3-pulse,
    transient zeroed or passed, runtime bypass)."""
    check_notch(notch_mode, transient)
    cfg.notch_mode = notch_mode
    cfg.transient_zero = int(transient == "zero")
    cfg.bypass = int(bool(mti_bypass))
    return cfg


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


# ---------------------------------------------------------------------------
# Kernel A: window + range FFT + corner turn
# ---------------------------------------------------------------------------

def check_range_geometry(nr: int, nd: int, name: str = "range_fft"):
    """Raises NotImplementedError for a frame that kernel A does not take:
    n_range off ``range_length_ok``; any chirp count nd >= 1 (the batch's
    chirps run in groups of 8, csrc/range_fft.cu).  The fixed range kernel
    takes the same n_range with n_doppler a multiple of 8
    (``frontend_fixed.check_range_geometry_fixed``)."""
    if not range_length_ok(nr) or nd < 1:
        raise NotImplementedError(
            f"{name} kernel needs n_range a power of two in [16, 1024] or "
            f"n2 x 128 with n2 <= 16, and n_doppler >= 1; got {nr}x{nd}")


def range_fft_plain(iq: torch.Tensor):
    """Plain twin of kernel A: window times the dense DFT (four float32
    matrix products), transposed to range-major.  iq int16 (B, nd, nr, 2)
    -> (re, im), each float32 (B, nr, nd)."""
    w = torch.as_tensor(hamming_float(iq.shape[-2]), device=iq.device)
    x = iq.to(torch.float32)
    re, im = dft_apply(x[..., 0] * w, x[..., 1] * w)
    return (re.transpose(-1, -2).contiguous(),
            im.transpose(-1, -2).contiguous())


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous at a 16-byte aligned address, as kernel A's bulk
    copies read it (a copy only for a view that starts elsewhere)."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def check_iq(iq: torch.Tensor):
    if iq.dim() != 4 or iq.shape[-1] != 2 or iq.dtype != torch.int16:
        raise ValueError(f"expected int16 iq (B, nd, nr, 2), got "
                         f"{tuple(iq.shape)} {iq.dtype}")


@kernels.counted
def range_fft(iq: torch.Tensor):
    """Window + range FFT + corner turn of int16 frames (B, nd, nr, 2):
    returns planar float32 (re, im), each (B, nr, nd).  Launches the CUDA
    kernel for a CUDA tensor; the plain twin for a CPU tensor."""
    check_iq(iq)
    if _device_kind(iq) == "cpu":
        return range_fft_plain(iq)
    out = launch_range_fft(iq)
    range_fft.launches += 1
    return out


def launch_range_fft(iq: torch.Tensor):
    """Launch kernel A on CUDA int16 frames (B, nd, nr, 2); the caller
    counts the launch.  Each chirp's arithmetic depends on that chirp alone,
    so a chirp shard (B, nd/sp, nr, 2) gives exactly the matching columns of
    the whole frame's output."""
    B, nd, nr, _ = iq.shape
    check_range_geometry(nr, nd)
    iq = _aligned(iq)
    win, tw = _tables(nr, str(iq.device))
    re = torch.empty((B, nr, nd), dtype=torch.float32, device=iq.device)
    im = torch.empty_like(re)
    lib = kernels.load()
    err = lib.fmcw_range_fft(
        iq.data_ptr(), win.data_ptr(), tw.data_ptr(), re.data_ptr(),
        im.data_ptr(), B, nd, nr,
        torch.cuda.current_stream(iq.device).cuda_stream)
    kernels.check(err, "range_fft")
    return re, im


def range_fft_float_plain(re: torch.Tensor, im: torch.Tensor):
    """Plain twin of kernel A on float32 planes (B, nd, nr): the window
    times the dense DFT, transposed to range-major -> (re, im), each
    float32 (B, nr, nd)."""
    w = torch.as_tensor(hamming_float(re.shape[-1]), device=re.device)
    yr, yi = dft_apply(re.to(torch.float32) * w, im.to(torch.float32) * w)
    return (yr.transpose(-1, -2).contiguous(),
            yi.transpose(-1, -2).contiguous())


@kernels.counted
def range_fft_float(re: torch.Tensor, im: torch.Tensor):
    """Window + range FFT + corner turn of float32 planes re/im, each
    (B, nd, nr) (the beamformer's output, no stacking copy): returns planar
    float32 (re, im), each (B, nr, nd).  Launches kernel A's float entry
    point for CUDA tensors; the plain twin for CPU tensors."""
    if re.dim() != 3 or re.shape != im.shape:
        raise ValueError(f"expected float re/im (B, nd, nr), got "
                         f"{tuple(re.shape)} and {tuple(im.shape)}")
    if re.dtype != torch.float32 or im.dtype != torch.float32:
        raise ValueError(f"expected float32 planes, got {re.dtype}, "
                         f"{im.dtype}")
    if _device_kind(re) == "cpu":
        return range_fft_float_plain(re, im)
    B, nd, nr = re.shape
    check_range_geometry(nr, nd, "range_fft_float")
    re, im = _aligned(re), _aligned(im)
    win, tw = _tables(nr, str(re.device))
    out_re = torch.empty((B, nr, nd), dtype=torch.float32, device=re.device)
    out_im = torch.empty_like(out_re)
    lib = kernels.load()
    err = lib.fmcw_range_fft_float(
        re.data_ptr(), im.data_ptr(), win.data_ptr(), tw.data_ptr(),
        out_re.data_ptr(), out_im.data_ptr(), B, nd, nr,
        torch.cuda.current_stream(re.device).cuda_stream)
    kernels.check(err, "range_fft_float")
    range_fft_float.launches += 1
    return out_re, out_im


# ---------------------------------------------------------------------------
# Kernel B: slow-time chain + magnitude + CFAR + peak grouping
# ---------------------------------------------------------------------------

def slowtime_mag_plain(re: torch.Tensor, im: torch.Tensor, mti_bypass: bool,
                       notch_mode: int = 2, transient: str = "zero",
                       exact_mag: bool = False) -> torch.Tensor:
    """Plain twin of kernel B's first half: slow-time operator and
    magnitude of range-major (B, nr, nd) planes -> (B, nr, nd) magnitudes."""
    yr, yi = doppler_apply(re, im, bool(mti_bypass), notch_mode, transient)
    return magnitude_float(yr, yi, exact=exact_mag)


def detect_plain(mag: torch.Tensor, cfar: CfarParams, scale_override: int = 0,
                 peak_group_radius: int = 0):
    """Plain twin of kernel B's second half on (B, nr, nd) magnitudes:
    returns (det, row_max (B, nr), n_dets (B,) int32, nonfinite (B,) int32).
    Bit-identical to the kernel's decision on the same magnitudes."""
    det, _, _ = C.cfar_2d(mag, scale_override, cfar)
    det = C.peak_group(det, peak_group_radius)
    return (det, det.amax(dim=-1),
            (det > 0).sum(dim=(-2, -1)).to(torch.int32),
            (~torch.isfinite(mag)).sum(dim=(-2, -1)).to(torch.int32))


def slowtime_detect_plain(re, im, mti_bypass=False, scale_override=0, *,
                          cfar: CfarParams, notch_mode: int = 2,
                          transient: str = "zero", exact_mag: bool = False,
                          peak_group_radius: int = 0, emit_mag: bool = False):
    """Plain twin of kernel B: see ``slowtime_detect``."""
    mag = slowtime_mag_plain(re, im, mti_bypass, notch_mode, transient,
                             exact_mag)
    det, row_max, n_dets, nonfinite = detect_plain(mag, cfar, scale_override,
                                                   peak_group_radius)
    return det, (mag if emit_mag else None), row_max, n_dets, nonfinite


def long_cpi(nd: int) -> bool:
    """Is ``nd`` a long CPI of kernel B: n2d x 128 chirps, 2 <= n2d <=
    16?"""
    inner = kernels.LONG_CPI_INNER
    return (nd > inner and nd % inner == 0
            and nd // inner <= kernels.LONG_CPI_MAX_SPLIT)


def dense_cpi(nd: int) -> bool:
    """Is ``nd`` a dense length of both slow-time kernels
    (``fmcw::dense_cpi``): a multiple of ``kernels.DENSE_ALIGN`` below
    ``kernels.DENSE_MAX`` that is neither in ``SHORT_CPIS`` nor a long CPI
    (8, 24, 40 .. 2040)?  There JAX's fused kernel contracts with the dense
    folded matrices (``_doppler_split`` returns 1); kernel B runs an o x m
    FFT (csrc/slowtime_detect.cu ``dense_row``), the fixed kernel the same
    plan in FP64."""
    return (kernels.DENSE_ALIGN <= nd < kernels.DENSE_MAX
            and nd % kernels.DENSE_ALIGN == 0 and nd not in SHORT_CPIS
            and not long_cpi(nd))


def unaligned_cpi(nd: int) -> bool:
    """Is ``nd`` a length of kernel B off a multiple of
    ``kernels.DENSE_ALIGN`` below ``kernels.DENSE_MAX`` (1 .. 2047; csrc/
    slowtime_detect.cu ``unaligned_cpi``)?  JAX's dense operator takes them
    as any other; kernel B runs ``dense_row`` with m = nd & -nd in 1, 2, 4
    and a ragged last decide chunk.  The fixed slow-time kernel does not
    take them (``check_doppler(int_map=True)``)."""
    return 1 <= nd < kernels.DENSE_MAX and nd % kernels.DENSE_ALIGN != 0


def two_launch(nd: int) -> bool:
    """Does kernel B run two launches at ``nd`` (the map kernel, then the
    decide kernel): a long CPI, a dense length or a length off a multiple
    of 8 (the fixed kernel: one of the first two, which its
    ``check_doppler`` leaves it)?"""
    return long_cpi(nd) or dense_cpi(nd) or unaligned_cpi(nd)


def check_doppler(nd: int, name: str, int_map: bool = False) -> None:
    """Raises NotImplementedError for an n_doppler that kernel B (or, with
    ``int_map``, the fixed slow-time kernel; ``name`` either) does not take:
    both take ``SHORT_CPIS``, the long CPIs and the dense lengths; kernel B
    also every length below 2048 off a multiple of 8 (``unaligned_cpi``)."""
    if nd in SHORT_CPIS or long_cpi(nd) or dense_cpi(nd):
        return
    if not int_map and unaligned_cpi(nd):
        return
    rule = ("a multiple of 8 below 2048" if int_map
            else "any other length below 2048")
    raise NotImplementedError(
        f"{name} kernel: n_doppler 16, 32, 64, 128, n2d x 128 with n2d in "
        f"2..16, or {rule}, got {nd} (JAX's fused kernel runs no dense "
        f"length at or above 2048 either: its folded matrices take 16 nd^2 "
        f"bytes of VMEM, its whole 64 MiB limit at 2048)")


def _kernel_halo(cfar: CfarParams, peak_group_radius: int,
                 halo: int | None = None) -> int:
    """Rows beyond its tile whose magnitudes a kernel-B block computes: the
    CFAR window plus the grouping radius (per-cell scale), or two blocks for
    the 3x3-block scale neighbourhood plus the blocks the grouping radius
    reaches (block scale).  ``halo`` (default the window's range halo): the
    same for the Doppler columns of a long-CPI chunk, with the Doppler
    halo."""
    h = (cfar.halo_range if halo is None else halo) + peak_group_radius
    if cfar.scale_mode == "block":
        sb = cfar.scale_block
        h = max(h, (-(-peak_group_radius // sb) + 2) * sb)
        h = -(-h // sb) * sb              # whole blocks
    return h


def _chunk_words(t: int, w: int, h: int, hc: int, pgr: int, block: bool,
                 so: int) -> int:
    """The long-CPI decide kernel's shared memory in 4-byte words
    (csrc/slowtime_detect.cu ``chunk_layout``: a short tile's
    ``tile_layout`` of W + 2 HC columns, one count)."""
    wc, rows = w + 2 * hc, t + 2 * pgr
    region = (rows * wc + 5 * kernels.MAX_BLK if block
              else (1 if so else 2) * rows * wc)
    return (t + 2 * h) * wc + region + t + 1


@functools.lru_cache(maxsize=4096)
def _chunk_widths(nd: int, sb: int) -> tuple[int, ...]:
    """The decide kernel's chunk widths W at ``nd``, in order of preference
    (the largest first, at most 128).  A long CPI: the powers of two 128 ..
    8 (the multiples of 8 dividing nd would change the tile at 1024x384
    and other long CPIs where 128 does not fit: 96 before 64).  A dense
    length: the multiples of 8 that divide nd (96 at 96 and 192, 8 at 1016
    = 8 x 127).  A length off a multiple of 8 (``unaligned_cpi``): for k =
    1, 2 .. chunks, the smallest W (a multiple of the block scale's ``sb``,
    which divides nd there) with ceil(nd / W) = k, a ragged last chunk
    where W does not divide nd (100: 100, 50, 34 .. at the per-cell
    scale)."""
    if long_cpi(nd):
        return (128, 64, 32, 16, 8)
    if not unaligned_cpi(nd):
        return tuple(w for w in range(128, 0, -kernels.DENSE_ALIGN)
                     if nd % w == 0)
    widths = []
    for w in range(min(128, nd) // sb * sb, 0, -sb):
        k = -(-nd // w)                        # chunks of at most w
        w = -(-(-(-nd // k)) // sb) * sb        # the smallest that many
        if w not in widths:
            widths.append(w)
    return tuple(widths)


def _decide_geometry(nr, nd, cfar, scale_override, pgr, name,
                     int_map=False):
    """The decide kernel's tile at a two-launch length (a long CPI, a dense
    length or, kernel B, a length off a multiple of 8): (T rows, W
    columns, H halo rows, HC halo columns), W from ``_chunk_widths`` (a
    ragged last chunk off a multiple of 8).  The largest T, then W, of a
    block whose shared memory lets two blocks share an SM, else one;
    within the strips a thread holds (64 cells) and, block scale, whole
    blocks and the block grid a tile holds; the kernel's own arithmetic
    (``decide_config_ok``).  ``int_map`` (the fixed kernels' int32 maps):
    T + 2 H at most ``kernels.MAX_ROWS`` rows, so that an integer column
    sum held in float stays exact (``frontend_fixed.fixed_config``)."""
    block = cfar.scale_mode == "block"
    sb = cfar.scale_block
    h = _kernel_halo(cfar, pgr)
    hc = _kernel_halo(cfar, pgr, cfar.halo_doppler)

    def fits(t, w, limit):
        rows, wc = t + 2 * pgr, w + 2 * hc
        units = -(-rows // kernels.STRIP) * (w + 2 * pgr)
        return (nr % t == 0 and rows >= kernels.STRIP
                and (not int_map or t + 2 * h <= kernels.MAX_ROWS)
                and -(-units // kernels.DECIDE_THREADS) * kernels.STRIP <= 64
                and (not block or (t % sb == 0 and w % sb == 0
                                   and nd % sb == 0
                                   and (t + 2 * h) // sb * (wc // sb)
                                   <= kernels.MAX_BLK))
                and 4 * _chunk_words(t, w, h, hc, pgr, block,
                                     int(scale_override)) <= limit)

    if cfar.halo_doppler < nd and pgr < nd:
        widths = _chunk_widths(nd, sb if block else 1)
        for limit in (kernels.MAX_SMEM // 2, kernels.MAX_SMEM):
            for t in (64, 32, 16, 8):
                for w in widths:
                    if fits(t, w, limit):
                        return t, w, h, hc
    raise NotImplementedError(
        f"{name} kernel: no decide tile of a {nr}x{nd} map with {cfar} and "
        f"peak_group_radius={pgr} fits a block")


def _tiles(nr: int) -> tuple[int, ...]:
    """Kernel B's row tiles of a short CPI, in order of preference:
    ``TILE_ROWS`` (or all rows, fewer), then 32, 16, 8."""
    return tuple(dict.fromkeys((min(TILE_ROWS, nr), 32, 16, 8)))


def _short_tile(nr, nd, halo, cfar, pgr):
    """The largest row tile T of ``_tiles`` that divides the map's ``nr``
    rows and fits a block with ``halo`` rows on each side (T + 2 halo <=
    MAX_ROWS; block scale: whole blocks and at most MAX_BLK of them), or
    None.  T = 64 wherever it fits: 2048 rows at the block scale 16 (48
    halo rows) take 32, and so do range shards of 96 or 352 rows."""
    block = cfar.scale_mode == "block"
    sb = cfar.scale_block
    if cfar.halo_doppler >= nd or pgr >= nd:
        return None
    for tile in _tiles(nr):
        if (nr % tile == 0 and tile + 2 * halo <= kernels.MAX_ROWS
                and (not block
                     or (tile % sb == 0 and nd % sb == 0
                         and (tile + 2 * halo) // sb * (nd // sb)
                         <= kernels.MAX_BLK))):
            return tile
    return None


def _slowtime_config(B, nr, nd, cfar, scale_override, peak_group_radius,
                     exact_mag=False, name="slowtime_detect", row_off=0,
                     r_total=None, int_map=False):
    """The kernel-B tile geometry (shared with the fixed-point kernel and
    the split entries, whose map is a range shard of ``r_total`` rows
    starting at ``row_off``), with the CFAR variant (``VARIANT_CODES``,
    taken by both kernels); raises NotImplementedError for what the
    kernels do not take, reflect edges among it (``ops/cfar.check_wrap``:
    their detect epilogues wrap, as JAX's fused kernels; the
    magnitude-only entry takes any edges).  A long CPI or a dense length
    takes the decide kernel's tile of rows x a chunk of columns
    (``_decide_geometry``; ``int_map``: the fixed kernels' int32 map)."""
    C.check_wrap(cfar, name)
    check_doppler(nd, name, int_map)
    if int(scale_override) < 0:
        raise ValueError(f"scale_override must be >= 0, got {scale_override}")
    block = cfar.scale_mode == "block"
    sb = cfar.scale_block
    n_blk = 9 * sb * sb
    chunk = halo_cols = 0
    if two_launch(nd):
        tile, chunk, halo, halo_cols = _decide_geometry(
            nr, nd, cfar, scale_override, peak_group_radius, name, int_map)
    else:
        halo = _kernel_halo(cfar, peak_group_radius)
        tile = _short_tile(nr, nd, halo, cfar, peak_group_radius)
        if tile is None:
            raise NotImplementedError(
                f"{name} kernel: {nr}x{nd} map with {cfar} and "
                f"peak_group_radius={peak_group_radius} fits no tile (T rows "
                f"+ 2 x {halo} halo rows <= 128, T in {_tiles(nr)} dividing "
                f"{nr})")
    return kernels.SlowtimeConfig(
        batch=B, R=nr, ND=nd, T=tile, H=halo, W=chunk, HC=halo_cols,
        hr=cfar.halo_range, hd=cfar.halo_doppler, gr=cfar.guard_range,
        gd=cfar.guard_doppler, n_ref=cfar.n_ref,
        k=cfar.n_ref - cfar.rank_idx, scale_min=cfar.scale_min,
        scale_nom=cfar.scale_nom, scale_max=cfar.scale_max,
        block_mode=int(block), sb=sb, n_blk=n_blk,
        k_blk=n_blk - min((n_blk * cfar.rank_pct) // 100, n_blk - 1),
        so=int(scale_override), pgr=int(peak_group_radius),
        exact_mag=int(bool(exact_mag)), row_off=int(row_off),
        r_total=nr if r_total is None else int(r_total),
        variant=VARIANT_CODES[cfar.variant])


@kernels.counted
def slowtime_detect(re: torch.Tensor, im: torch.Tensor, mti_bypass=False,
                    scale_override=0, *, cfar: CfarParams,
                    notch_mode: int = 2, transient: str = "zero",
                    exact_mag: bool = False, peak_group_radius: int = 0,
                    emit_mag: bool = False):
    """Slow-time operator, magnitude, CFAR and peak grouping of range-major
    planes (B, nr, nd).  Returns ``(det (B, nr, nd), mag | None,
    row_max (B, nr), n_dets (B,) int32, nonfinite (B,) int32)``; ``mag`` only
    with ``emit_mag``.  ``mti_bypass`` and ``scale_override`` are runtime
    controls.  Wrap edges only (``ops/cfar.check_wrap``, on either
    device).  Launches the CUDA kernel for CUDA tensors; the plain twin for
    CPU tensors."""
    if re.dim() != 3 or re.shape != im.shape:
        raise ValueError(f"expected re/im (B, nr, nd), got "
                         f"{tuple(re.shape)} and {tuple(im.shape)}")
    C.check_wrap(cfar, "slowtime_detect")
    if _device_kind(re) == "cpu":
        return slowtime_detect_plain(
            re, im, mti_bypass, scale_override, cfar=cfar,
            notch_mode=notch_mode, transient=transient, exact_mag=exact_mag,
            peak_group_radius=peak_group_radius, emit_mag=emit_mag)
    B, nr, nd = re.shape
    cfg = _detect_config(
        _slowtime_config(B, nr, nd, cfar, scale_override, peak_group_radius,
                         exact_mag), cfar, notch_mode, transient, mti_bypass,
        "slowtime_detect")
    # A long CPI or a dense length decides on its magnitude map (always
    # written) and combines its chunks' row maxima into zeros.
    two = two_launch(nd)
    dev = re.device
    re = _aligned(re.to(torch.float32))
    im = _aligned(im.to(torch.float32))
    win, tw = _slowtime_tables(nd, str(dev))
    det = torch.empty((B, nr, nd), dtype=torch.float32, device=dev)
    mag = torch.empty_like(det) if emit_mag or two else None
    row_max = (torch.zeros if two else torch.empty)(
        (B, nr), dtype=torch.float32, device=dev)
    n_dets = torch.zeros((B,), dtype=torch.int32, device=dev)
    nonfinite = torch.zeros((B,), dtype=torch.int32, device=dev)
    lib = kernels.load()
    err = lib.fmcw_slowtime_detect(
        re.data_ptr(), im.data_ptr(), win.data_ptr(), tw.data_ptr(),
        det.data_ptr(), mag.data_ptr() if mag is not None else None,
        row_max.data_ptr(), n_dets.data_ptr(), nonfinite.data_ptr(),
        ctypes.byref(cfg), torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "slowtime_detect")
    slowtime_detect.launches += 2 if two else 1
    return det, (mag if emit_mag else None), row_max, n_dets, nonfinite


def check_mag_geometry(nr: int, nd: int) -> None:
    """Raises NotImplementedError for an nr x nd map that the
    magnitude-only kernel (one range row per lane group, or per warp at a
    long CPI or a dense length; any number of rows) does not take."""
    check_doppler(nd, "slowtime_mag")


@kernels.counted
def slowtime_mag(re: torch.Tensor, im: torch.Tensor, mti_bypass=False, *,
                 notch_mode: int = 2, transient: str = "zero",
                 exact_mag: bool = False):
    """Slow-time operator and magnitude of range-major planes (B, nr, nd),
    without CFAR: returns ``(mag (B, nr, nd), nonfinite (B,) int32)``.
    Launches kernel B's magnitude-only entry point for CUDA tensors; the
    plain twin (``slowtime_mag_plain``) for CPU tensors."""
    if re.dim() != 3 or re.shape != im.shape:
        raise ValueError(f"expected re/im (B, nr, nd), got "
                         f"{tuple(re.shape)} and {tuple(im.shape)}")
    if _device_kind(re) == "cpu":
        mag = slowtime_mag_plain(re, im, mti_bypass, notch_mode, transient,
                                 exact_mag)
        return mag, (~torch.isfinite(mag)).sum(dim=(-2, -1)).to(torch.int32)
    B, nr, nd = re.shape
    check_mag_geometry(nr, nd)
    dev = re.device
    re = _aligned(re.to(torch.float32))
    im = _aligned(im.to(torch.float32))
    win, tw = _slowtime_tables(nd, str(dev))
    mag = torch.empty((B, nr, nd), dtype=torch.float32, device=dev)
    nonfinite = torch.zeros((B,), dtype=torch.int32, device=dev)
    cfg = _pulse_canceller(
        kernels.SlowtimeConfig(batch=B, R=nr, ND=nd,
                               exact_mag=int(bool(exact_mag))),
        notch_mode, transient, mti_bypass)
    lib = kernels.load()
    err = lib.fmcw_slowtime_mag(
        re.data_ptr(), im.data_ptr(), win.data_ptr(), tw.data_ptr(),
        mag.data_ptr(), nonfinite.data_ptr(), ctypes.byref(cfg),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "slowtime_mag")
    slowtime_mag.launches += 1
    return mag, nonfinite


# ---------------------------------------------------------------------------
# The fused front-end
# ---------------------------------------------------------------------------

def check_fused_detect(p: RadarParams, peak_group_radius: int = 0,
                       mag_only: bool = False) -> None:
    """Raises NotImplementedError, with the kernel's reason, unless the
    front-end kernels take ``p``'s frame and CFAR: kernel A's frame, and
    kernel B's tile (``mag_only``: its magnitude-only entry, which the
    debug taps and the hw-compat CFAR run), long CPIs and dense lengths
    included.  The kernels' own checks, before any launch and on any
    device: explicit float ``frontend="fused"`` asks it on the CPU too
    (``models/pipeline.resolve_frontend``), so it raises where the card
    would."""
    check_range_geometry(p.n_range, p.n_doppler)
    if mag_only:
        check_mag_geometry(p.n_range, p.n_doppler)
    else:
        _detect_config(_slowtime_config(1, p.n_range, p.n_doppler, p.cfar, 0,
                                        peak_group_radius),
                       p.cfar, p.notch_mode, "zero", False, "slowtime_detect")


def fused_detect_supported(p: RadarParams, peak_group_radius: int = 0,
                           mag_only: bool = False) -> bool:
    """Do the front-end kernels take ``p``'s frame and CFAR
    (``check_fused_detect``)?  The counterpart of
    ``fmcw_tpu/models/pipeline.frontend_kernel_supported``.  The fixed
    kernels share these checks
    (``frontend_fixed.fused_fixed_detect_supported``)."""
    try:
        check_fused_detect(p, peak_group_radius, mag_only)
    except NotImplementedError:
        return False
    return True


def rdm_frontend_detect(iq: torch.Tensor, mti_bypass=False, scale_override=0,
                        *, cfar: CfarParams, notch_mode: int = 2,
                        transient: str = "zero", exact_mag: bool = False,
                        peak_group_radius: int = 0, emit_mag: bool = False,
                        plain: bool = False):
    """iq int16 (B, nd, nr, 2) -> ``(det (B, nr, nd), mag | None,
    nonfinite (B,), row_max (B, nr), n_dets (B,))`` — the outputs of
    ``fmcw_tpu/ops/frontend_pallas.rdm_frontend(detect=True)``, with the
    det map in natural (range, Doppler) layout.  ``plain=True`` runs the
    plain twins on whatever device ``iq`` is on (the reference the kernels
    are held against on the card)."""
    kw = dict(cfar=cfar, notch_mode=notch_mode, transient=transient,
              exact_mag=exact_mag, peak_group_radius=peak_group_radius,
              emit_mag=emit_mag)
    if plain:
        re, im = range_fft_plain(iq)
        out = slowtime_detect_plain(re, im, mti_bypass, scale_override, **kw)
    else:
        re, im = range_fft(iq)
        out = slowtime_detect(re, im, mti_bypass, scale_override, **kw)
    det, mag, row_max, n_dets, nonfinite = out
    return det, mag, nonfinite, row_max, n_dets
