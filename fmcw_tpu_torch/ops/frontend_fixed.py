"""The fused fixed-point front-end as two CUDA kernels, with their plain
twins.

Port of ``fmcw_tpu/ops/frontend_pallas.rdm_frontend_fixed`` (the Pallas
kernel ``_kernel_fixed``): the integer chain of the reference's 16-bit data
path, split at the corner turn like the float kernels of ``ops/frontend.py``:

* ``range_fft_fixed`` (``csrc/range_fft_fixed.cu``): Q15 range window with
  saturation count, range FFT, block-floating-point quantization per chirp,
  range-major store — int16 (B, nd, nr, 2) -> int16 re/im (B, nr, nd) and
  the window's saturation count (B,);
* ``slowtime_detect_fixed`` (``csrc/slowtime_detect_fixed.cu``): saturating
  MTI, Q15 Doppler window with saturation count, Doppler FFT, BFP per range
  bin, integer magnitude, integer 2D CFAR (OS by counting, or the CA / GO
  / SO window means; per-cell or block scale), peak grouping, row maxima
  and counts.  n_doppler 16 .. 128, the long CPIs n2d x 128 (n2d 2 .. 16,
  JAX's long-CPI split) and the dense lengths (every other multiple of 8
  below 2048, JAX's dense operator, ``frontend.dense_cpi``): at the last
  two the kernel writes the int32 magnitude map (an o x m split of the
  row, ``map_split``), then kernel B's decide kernel
  (csrc/slowtime_long.cuh) decides it in tiles of rows x chunks of Doppler
  columns, two launches that ``launches`` both counts.

The twins compose the stage ops of the staged chain (``ops/window``,
``ops/fft``, ``ops/notch``, ``ops/magnitude``, ``ops/cfar``), with the
transforms as dense float64 matrix products.  The kernels transform with a
float64 FFT over the same exact-quarter-turn twiddle table
(``ops/fft.twiddles64``), the eighth-turn bins summed exactly in both
(``ops/fft._eighth_turn_bins``), so both quantize to the float64 golden
model's values; integer decisions on the same magnitudes are
bit-identical.

Each wrapper launches its kernel for a CUDA tensor and takes its twin only
for a CPU tensor; ``launches`` counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import kernels
from ..params import CfarParams, RadarParams
from . import cfar as C
from . import frontend as F
from .fft import bfp_quantize, dft64_apply, scaled_fft_apply, twiddles64
from .magnitude import magnitude_fixed
from .notch import check_notch, mti_notch_fixed
from .window import hamming_q15, window_apply_fixed, window_rounding_constant


def check_range_geometry_fixed(nr: int, nd: int,
                               name: str = "range_fft_fixed") -> None:
    """Raises NotImplementedError for a frame that the fixed range kernel
    does not take: kernel A's n_range (``frontend.range_length_ok``) and
    n_doppler a multiple of 8 (its groups of 8 chirps are whole frames'
    chirps; kernel A takes any count, ``frontend.check_range_geometry``)."""
    if not F.range_length_ok(nr) or nd < 8 or nd % 8:
        raise NotImplementedError(
            f"{name} kernel needs n_range a power of two in [16, 1024] or "
            f"n2 x 128 with n2 <= 16, and n_doppler a multiple of 8; got "
            f"{nr}x{nd}")


@functools.lru_cache(maxsize=32)
def _tables(n: int, coef_width: int, device: str):
    """The int32 Q15 window and the float64 twiddles tw[m] = exp(-2 pi i m
    / n) (``ops/fft.twiddles64``, as (n, 2) re/im pairs) on ``device``."""
    tw = twiddles64(n)
    tw = np.stack([tw.real, tw.imag], axis=-1)
    return (torch.as_tensor(hamming_q15(n, coef_width).astype(np.int32),
                            device=device),
            torch.as_tensor(tw, device=device))


@functools.lru_cache(maxsize=32)
def _range_tables(n: int, coef_width: int, device: str):
    """The range kernel's constants on ``device``: the int32 Q15 window, and
    the float64 twiddles as (entries, 2) re/im pairs.  With n = o x m
    (``ops/frontend.range_fft_split``) and m = N1 x N2
    (``ops/frontend.range_fft_plan``): first the m-point plan's twiddles
    between its two passes, tw[ka N2 + t] = exp(-2 pi i t ka / m) =
    ``twiddles64(m)[t ka]`` for ka < N1, t < N2 (a warp reads one ka's row
    coalesced); for o > 1 then the dense stage's W_n^(i1 k2) =
    ``twiddles64(n)[i1 k2 mod n]`` at [m + k2 m + i1] (i1 < m, k2 < o) and
    W_o^e = ``twiddles64(n)[e m]`` at [m + n + e] (e < o).  Exact at the
    quarter turns, so class 0's dense stage multiplies by exactly 1; the
    powers of two 16 .. 1024 keep their n-entry table."""
    o, m = F.range_fft_split(n)
    n1, n2 = F.range_fft_plan(m)
    tw = [twiddles64(m)[np.outer(np.arange(n1), np.arange(n2)).ravel()]]
    if o > 1:
        k2, i1 = np.divmod(np.arange(n), m)
        full = twiddles64(n)
        tw += [full[i1 * k2 % n], full[np.arange(o) * m]]
    tw = np.concatenate(tw)
    tw = np.stack([tw.real, tw.imag], axis=-1)
    return (torch.as_tensor(hamming_q15(n, coef_width).astype(np.int32),
                            device=device),
            torch.as_tensor(tw, device=device))


# ---------------------------------------------------------------------------
# Range half
# ---------------------------------------------------------------------------

def fixed_transform(i_v: torch.Tensor, q_v: torch.Tensor, scale_sch=None):
    """The fixed chain's transform along the last axis: with ``scale_sch``
    None the dense float64 DFT, then BFP per transform; with a per-stage
    shift schedule the stage-scaled ``ops/fft.scaled_fft_apply``
    (``fixed_fft="scaled"``), natural order.  Integer-valued (re, im)."""
    if scale_sch is None:
        return bfp_quantize(*dft64_apply(i_v, q_v))
    return scaled_fft_apply(i_v, q_v, -1, scale_sch)


def range_fft_fixed_plain(iq: torch.Tensor, coef_width: int = 16,
                          rounding: str = "unbiased", scale_sch=None):
    """Plain twin of ``range_fft_fixed``: integer window, dense float64 DFT,
    BFP per chirp (``fmcw_tpu/models/pipeline.fixed_path``'s range stage),
    transposed to range-major.  With ``scale_sch`` the stage-scaled
    transform in place of DFT and BFP (``fixed_transform``)."""
    F.check_iq(iq)
    w = hamming_q15(iq.shape[-2], coef_width)
    i_v, q_v, sat = window_apply_fixed(iq[..., 0], iq[..., 1], w[None, :],
                                       coef_width, rounding)
    re, im = fixed_transform(i_v, q_v, scale_sch)
    return (re.to(torch.int16).transpose(-1, -2).contiguous(),
            im.to(torch.int16).transpose(-1, -2).contiguous(), sat)


@kernels.counted
def range_fft_fixed(iq: torch.Tensor, coef_width: int = 16,
                    rounding: str = "unbiased"):
    """Q15 window + range FFT + BFP + corner turn of int16 frames
    (B, nd, nr, 2): returns int16 (re, im), each (B, nr, nd), and the
    window's saturation count (B,) int32.  Launches the CUDA kernel for a
    CUDA tensor; the plain twin for a CPU tensor."""
    F.check_iq(iq)
    if F._device_kind(iq) == "cpu":
        return range_fft_fixed_plain(iq, coef_width, rounding)
    out = launch_range_fft_fixed(iq, coef_width, rounding)
    range_fft_fixed.launches += 1
    return out


def launch_range_fft_fixed(iq: torch.Tensor, coef_width: int = 16,
                           rounding: str = "unbiased"):
    """Launch ``range_fft_fixed``'s kernel on CUDA int16 frames; the caller
    counts the launch.  The kernel (csrc/range_fft_fixed.cu) is kernel A's
    two-pass register plan in FP64: each group of 8 chirps arrives by one
    TMA bulk copy (so ``iq`` is passed 16-byte aligned), pass 1 windows in
    integers and transforms N1 points a lane, one exchange through shared
    memory, pass 2 transforms N2 points, the BFP exponent comes from a
    shuffle and shared integer max.  Where nd is a multiple of 16, two
    groups' quantized tiles are staged in shared memory and copied out as
    whole 32-byte sectors; otherwise the corner turn is stored from
    registers.  Its bound is the bytes (0.0401 ms at batch 128 of 1024x128
    on an H100), with the FP64 pipe close behind.  At n_range = n2 x 128
    beyond the powers of two (384 .. 2048, kernel A's lengths) the group is
    windowed in place, a dense o-point FP64 stage comes first (n = o x m,
    ``ops/frontend.range_fft_split``), and the classes run twice, the
    first sweep for the BFP peak over all n bins, the second to quantize
    and store.  Window, FFT and BFP are per chirp, so a chirp shard gives
    exactly the matching columns (and its share of the saturation count)
    of the whole frame's output."""
    B, nd, nr, _ = iq.shape
    check_range_geometry_fixed(nr, nd)
    rnd = window_rounding_constant(coef_width, rounding)
    iq = F._aligned(iq)
    win, tw = _range_tables(nr, coef_width, str(iq.device))
    re = torch.empty((B, nr, nd), dtype=torch.int16, device=iq.device)
    im = torch.empty_like(re)
    sat = torch.zeros((B,), dtype=torch.int32, device=iq.device)
    lib = kernels.load()
    err = lib.fmcw_range_fft_fixed(
        iq.data_ptr(), win.data_ptr(), tw.data_ptr(), re.data_ptr(),
        im.data_ptr(), sat.data_ptr(), B, nd, nr, rnd, coef_width - 2,
        torch.cuda.current_stream(iq.device).cuda_stream)
    kernels.check(err, "range_fft_fixed")
    return re, im, sat


# ---------------------------------------------------------------------------
# Slow-time half
# ---------------------------------------------------------------------------

def slowtime_mag_fixed_plain(re: torch.Tensor, im: torch.Tensor,
                             mti_bypass: bool = False, notch_mode: int = 2,
                             transient: str = "zero", coef_width: int = 16,
                             rounding: str = "unbiased", scale_sch=None):
    """Plain twin of the kernel's first half on range-major integer planes
    (B, nr, nd): saturating MTI, integer Doppler window, dense float64 DFT,
    BFP per range bin, integer magnitude.  Returns (mag int32 (B, nr, nd),
    Doppler-window saturation count (B,) int32).  With ``scale_sch`` the
    stage-scaled transform in place of DFT and BFP (``fixed_transform``)."""
    i_v, q_v = mti_notch_fixed(re, im, notch_mode, bool(mti_bypass),
                               transient)
    w = hamming_q15(re.shape[-1], coef_width)
    i_v, q_v, sat = window_apply_fixed(i_v, q_v, w[None, :], coef_width,
                                       rounding)
    yr, yi = fixed_transform(i_v, q_v, scale_sch)
    return magnitude_fixed(yr, yi), sat


def slowtime_detect_fixed_plain(re, im, mti_bypass=False, scale_override=0,
                                *, cfar: CfarParams, notch_mode: int = 2,
                                transient: str = "zero", coef_width: int = 16,
                                rounding: str = "unbiased",
                                peak_group_radius: int = 0,
                                emit_mag: bool = False):
    """Plain twin of ``slowtime_detect_fixed``."""
    mag, sat = slowtime_mag_fixed_plain(re, im, mti_bypass, notch_mode,
                                        transient, coef_width, rounding)
    det, row_max, n_dets, _ = F.detect_plain(mag, cfar, scale_override,
                                             peak_group_radius)
    return det, (mag if emit_mag else None), row_max, n_dets, sat


def map_split(nd: int) -> tuple[int, int]:
    """The fixed map kernel's nd = o x m at a two-launch length
    (``frontend.two_launch``; csrc/slowtime_detect_fixed.cu ``inner_len``):
    m = 128 and o = n2d at a long CPI, m = nd & -nd (8 .. 64) and o = nd /
    m (odd, 1 .. 255) at a dense length."""
    m = kernels.LONG_CPI_INNER if F.long_cpi(nd) else nd & -nd
    return nd // m, m


def map_warp_bytes(nd: int) -> int:
    """A map-kernel warp's shared memory at a two-launch length, as the
    kernel's ``map_warp_bytes`` counts it: o classes of m + ceil(8 / o)
    double2 (the spectrum, padded against bank conflicts) and the row's
    windowed int16 I and Q.  44,880 B at 2040; ``kernels.MAP_WARPS`` warps
    a block."""
    o, m = map_split(nd)
    return o * (m + -(-8 // o)) * 16 + 4 * nd


def fixed_config(cfg, cfar: CfarParams, notch_mode: int, transient: str,
                 mti_bypass, coef_width: int, rounding: str, name: str):
    """The fixed slow-time entries' kernel config: the tile geometry
    ``cfg`` (with the CFAR variant's code) with the MTI and Q15 window
    fields set; raises NotImplementedError for what the kernel does not
    take (an OS training set over ``frontend.MAX_PACKED_REFS`` cells, or
    at a long CPI or a dense length a decide tile of more than
    ``kernels.MAX_ROWS`` rows, whose integer column sums would leave
    float's exact range, or a map kernel over its shared memory, among
    it).  ``cfg``'s n_doppler was checked where it was built
    (``frontend._slowtime_config``)."""
    cfg = F._detect_config(cfg, cfar, notch_mode, transient, mti_bypass,
                           name)
    if F.two_launch(cfg.ND):
        if cfg.T + 2 * cfg.H > kernels.MAX_ROWS:
            raise NotImplementedError(
                f"{name} kernel: a decide tile of {cfg.T} + 2 x {cfg.H} "
                f"rows, more than {kernels.MAX_ROWS}")
        if kernels.MAP_WARPS * map_warp_bytes(cfg.ND) > kernels.MAX_SMEM:
            raise NotImplementedError(
                f"{name} kernel: the map kernel's {kernels.MAP_WARPS} x "
                f"{map_warp_bytes(cfg.ND)} B of shared memory at "
                f"{cfg.ND} chirps")
    cfg.rnd = window_rounding_constant(coef_width, rounding)
    cfg.shift = coef_width - 2
    return cfg


@kernels.counted
def slowtime_detect_fixed(re: torch.Tensor, im: torch.Tensor,
                          mti_bypass=False, scale_override=0, *,
                          cfar: CfarParams, notch_mode: int = 2,
                          transient: str = "zero", coef_width: int = 16,
                          rounding: str = "unbiased",
                          peak_group_radius: int = 0, emit_mag: bool = False):
    """Fixed-point slow-time chain, CFAR and peak grouping of range-major
    int16 planes (B, nr, nd).  Returns ``(det int32 (B, nr, nd), mag | None,
    row_max int32 (B, nr), n_dets (B,) int32, sat (B,) int32)`` with ``sat``
    the Doppler window's saturation count.  ``mti_bypass`` and
    ``scale_override`` are runtime controls.  Every CFAR variant: OS by
    counting, CA / GO / SO by the kernel's integer window-mean epilogue
    (its ``kMean`` instantiation).  At a long CPI or a dense length the
    kernel writes the magnitude map, which its decision reads (two
    launches).  Launches the CUDA kernel for CUDA tensors; the plain twin
    for CPU tensors."""
    if re.dim() != 3 or re.shape != im.shape:
        raise ValueError(f"expected re/im (B, nr, nd), got "
                         f"{tuple(re.shape)} and {tuple(im.shape)}")
    check_notch(notch_mode, transient)
    C.check_wrap(cfar, "slowtime_detect_fixed")
    if F._device_kind(re) == "cpu":
        return slowtime_detect_fixed_plain(
            re, im, mti_bypass, scale_override, cfar=cfar,
            notch_mode=notch_mode, transient=transient,
            coef_width=coef_width, rounding=rounding,
            peak_group_radius=peak_group_radius, emit_mag=emit_mag)
    if re.dtype != torch.int16 or im.dtype != torch.int16:
        raise ValueError(f"slowtime_detect_fixed kernel takes int16 planes, "
                         f"got {re.dtype}")
    B, nr, nd = re.shape
    cfg = fixed_config(
        F._slowtime_config(B, nr, nd, cfar, scale_override,
                           peak_group_radius, name="slowtime_detect_fixed",
                           int_map=True),
        cfar, notch_mode, transient, mti_bypass, coef_width, rounding,
        "slowtime_detect_fixed")
    # A long CPI or a dense length decides on its magnitude map (always
    # written) and combines its chunks' row maxima into zeros.
    two = F.two_launch(nd)
    dev = re.device
    re, im = F._aligned(re), F._aligned(im)
    win, tw = _tables(nd, coef_width, str(dev))
    det = torch.empty((B, nr, nd), dtype=torch.int32, device=dev)
    mag = torch.empty_like(det) if emit_mag or two else None
    row_max = (torch.zeros if two else torch.empty)(
        (B, nr), dtype=torch.int32, device=dev)
    n_dets = torch.zeros((B,), dtype=torch.int32, device=dev)
    sat = torch.zeros((B,), dtype=torch.int32, device=dev)
    lib = kernels.load()
    err = lib.fmcw_slowtime_detect_fixed(
        re.data_ptr(), im.data_ptr(), win.data_ptr(), tw.data_ptr(),
        det.data_ptr(), mag.data_ptr() if mag is not None else None,
        row_max.data_ptr(), n_dets.data_ptr(), sat.data_ptr(),
        ctypes.byref(cfg), torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "slowtime_detect_fixed")
    slowtime_detect_fixed.launches += 2 if two else 1
    return det, (mag if emit_mag else None), row_max, n_dets, sat


# ---------------------------------------------------------------------------
# The fused fixed-point front-end
# ---------------------------------------------------------------------------

def fused_fixed_detect_supported(p: RadarParams, peak_group_radius: int = 0,
                                 include_debug: bool = False) -> bool:
    """Can ``mode="fixed"`` run as the two fixed-point kernels
    (``frontend="fused"``)?  The counterpart of ``fmcw_tpu/models/pipeline.
    fused_fixed_detect_supported``, asked of the kernels' own checks: no
    debug taps, and a frame and CFAR (any variant, wrap edges: reflect
    gives False, and ``frontend="fused"`` then raises ValueError, as JAX's)
    that both kernels take, long CPIs and dense lengths included.  JAX's
    limit on the window (its sums below 2^24, for the TPU's float32 sums)
    does not apply: these kernels sum in int32; the OS variant's float
    packed count takes at most ``frontend.MAX_PACKED_REFS`` training
    cells, the CA/GO/SO epilogue counts nothing."""
    if include_debug:
        return False
    try:
        check_range_geometry_fixed(p.n_range, p.n_doppler)
        fixed_config(F._slowtime_config(1, p.n_range, p.n_doppler, p.cfar,
                                        0, peak_group_radius, int_map=True),
                     p.cfar, p.notch_mode, "zero", False, p.coef_width,
                     "unbiased", "")
    except NotImplementedError:
        return False
    return True


def rdm_frontend_fixed_detect(iq: torch.Tensor, mti_bypass=False,
                              scale_override=0, *, cfar: CfarParams,
                              notch_mode: int = 2, transient: str = "zero",
                              coef_width: int = 16,
                              window_rounding: str = "unbiased",
                              peak_group_radius: int = 0,
                              emit_mag: bool = False, plain: bool = False):
    """iq int16 (B, nd, nr, 2) -> ``(det int32 (B, nr, nd), mag | None,
    saturation_count (B,), row_max (B, nr), n_dets (B,))`` — the outputs of
    ``fmcw_tpu/ops/frontend_pallas.rdm_frontend_fixed`` with the det map in
    natural (range, Doppler) layout.  ``plain=True`` runs the plain twins on
    whatever device ``iq`` is on."""
    kw = dict(cfar=cfar, notch_mode=notch_mode, transient=transient,
              coef_width=coef_width, rounding=window_rounding,
              peak_group_radius=peak_group_radius, emit_mag=emit_mag)
    if plain:
        re, im, sat_r = range_fft_fixed_plain(iq, coef_width, window_rounding)
        out = slowtime_detect_fixed_plain(re, im, mti_bypass, scale_override,
                                          **kw)
    else:
        re, im, sat_r = range_fft_fixed(iq, coef_width, window_rounding)
        out = slowtime_detect_fixed(re, im, mti_bypass, scale_override, **kw)
    det, mag, row_max, n_dets, sat_d = out
    return det, mag, sat_r + sat_d, row_max, n_dets
