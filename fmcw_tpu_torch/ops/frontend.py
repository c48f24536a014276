"""The fused radar front-end as two CUDA kernels, with their plain twins.

Port of ``fmcw_tpu/ops/frontend_pallas.py::rdm_frontend(detect=True)``.  The
TPU kernel keeps a whole frame in VMEM; on the GPU it is split at the corner
turn, as ``fmcw_tpu/ops/split_frontend.py`` splits it across chips:

* ``range_fft`` (kernel A, ``csrc/range_fft.cu``): Hamming window and range
  FFT per chirp, stored range-major — int16 (B, nd, nr, 2) -> planar float32
  re/im (B, nr, nd); ``range_fft_float``, the same kernel's entry point for
  float32 planes (B, nd, nr) (the array model's beamformed data: the TPU
  kernel takes int16 or float32);
* ``slowtime_detect`` (kernel B, ``csrc/slowtime_detect.cu``): the
  slow-time chain (MTI, Doppler window, an FP32 Doppler FFT per range row),
  magnitude, 2D OS-CFAR with per-cell or block scale (``csrc/cfar_tile.cuh``),
  peak grouping, per-row maxima, detection and non-finite counts;
  ``slowtime_mag``, its magnitude-only entry point
  (``rdm_frontend(detect=False)``: the magnitude and the non-finite count,
  no CFAR).  Its twin folds the slow-time chain into one float32 matrix
  (``ops/fft.doppler_apply``); the two agree within 1e-5 of the peak.

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
from ..params import CfarParams
from . import cfar as C
from .fft import dft_apply, doppler_apply
from .magnitude import magnitude_float
from .notch import check_notch
from .window import hamming_float

# Range rows per kernel-B block.
TILE_ROWS = 64


reset_launch_counts = kernels.reset_launch_counts


def range_fft_plan(n: int) -> tuple[int, int]:
    """Kernel A's factorisation n = N1 x N2 (``Plan`` in csrc/range_fft.cu):
    N2 = 2^floor(log2(n) / 2) lanes per chirp, N1 = n / N2 points per
    lane."""
    n2 = 1 << (n.bit_length() - 1) // 2
    return n // n2, n2


@functools.lru_cache(maxsize=32)
def _tables(n: int, device: str):
    """Kernel A constants on ``device``: the float window, and the twiddle
    table between its two passes, tw[ka N2 + t] = exp(-2 pi i t ka / n)
    for ka < N1, t < N2 (``range_fft_plan``), computed in float64 then
    float32: a warp reads one ka's row coalesced."""
    n1, n2 = range_fft_plan(n)
    m = np.outer(np.arange(n1), np.arange(n2)).ravel().astype(np.float64)
    ang = -2.0 * np.pi * m / n
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


# Kernel B and the fixed slow-time kernel count the training cells in
# float, hi and lo packed as hi * 4096 + lo (csrc/cfar_tile.cuh): exact up
# to this many.
MAX_PACKED_REFS = 4094


def _detect_config(cfg, cfar: CfarParams, notch_mode: int, transient: str,
                   mti_bypass, name: str):
    """The slow-time detection entries (kernel B's and the fixed kernel's):
    the shared tile geometry ``cfg`` (``_slowtime_config``) with the MTI
    fields set; raises NotImplementedError for a training set the packed
    count does not hold."""
    if cfar.n_ref > MAX_PACKED_REFS:
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
    """Raises NotImplementedError for a frame that the range kernels (kernel
    A and the fixed-point one) do not take."""
    if nr & (nr - 1) or not 16 <= nr <= 1024 or nd % 8:
        raise NotImplementedError(
            f"{name} kernel needs n_range a power of two in [16, 1024] "
            f"and n_doppler a multiple of 8; got {nr}x{nd}")


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


def _kernel_halo(cfar: CfarParams, peak_group_radius: int) -> int:
    """Rows beyond its tile whose magnitudes a kernel-B block computes: the
    CFAR window plus the grouping radius (per-cell scale), or two blocks for
    the 3x3-block scale neighbourhood plus the blocks the grouping radius
    reaches (block scale)."""
    h = cfar.halo_range + peak_group_radius
    if cfar.scale_mode == "block":
        sb = cfar.scale_block
        h = max(h, (-(-peak_group_radius // sb) + 2) * sb)
        h = -(-h // sb) * sb              # whole blocks
    return h


def _slowtime_config(B, nr, nd, cfar, scale_override, peak_group_radius,
                     exact_mag=False, name="slowtime_detect", row_off=0,
                     r_total=None):
    """The kernel-B tile geometry (shared with the fixed-point kernel and
    the split entries, whose map is a range shard of ``r_total`` rows
    starting at ``row_off``); raises NotImplementedError for what the
    kernels do not take."""
    if cfar.variant != "os" or cfar.edge_mode != "wrap":
        raise NotImplementedError(
            f"{name} kernel: OS variant with wrap edges only "
            f"(CA/GO/SO are queued in ROADMAP.md)")
    if nd not in (16, 32, 64, 128):
        raise NotImplementedError(
            f"{name} kernel: n_doppler in (16, 32, 64, 128), got "
            f"{nd} (long CPIs are queued in ROADMAP.md)")
    if int(scale_override) < 0:
        raise ValueError(f"scale_override must be >= 0, got {scale_override}")
    tile = min(TILE_ROWS, nr)
    halo = _kernel_halo(cfar, peak_group_radius)
    block = cfar.scale_mode == "block"
    sb = cfar.scale_block
    n_blk = 9 * sb * sb
    ok = (nr % tile == 0 and tile + 2 * halo <= 128
          and cfar.halo_doppler < nd and peak_group_radius < nd
          and (not block or (tile % sb == 0 and nd % sb == 0
                             and (tile + 2 * halo) // sb * (nd // sb) <= 256)))
    if not ok:
        raise NotImplementedError(
            f"{name} kernel: {nr}x{nd} map with {cfar} and "
            f"peak_group_radius={peak_group_radius} does not fit its tile "
            f"({tile} rows + 2 x {halo} halo rows <= 128)")
    return kernels.SlowtimeConfig(
        batch=B, R=nr, ND=nd, T=tile, H=halo,
        hr=cfar.halo_range, hd=cfar.halo_doppler, gr=cfar.guard_range,
        gd=cfar.guard_doppler, n_ref=cfar.n_ref,
        k=cfar.n_ref - cfar.rank_idx, scale_min=cfar.scale_min,
        scale_nom=cfar.scale_nom, scale_max=cfar.scale_max,
        block_mode=int(block), sb=sb, n_blk=n_blk,
        k_blk=n_blk - min((n_blk * cfar.rank_pct) // 100, n_blk - 1),
        so=int(scale_override), pgr=int(peak_group_radius),
        exact_mag=int(bool(exact_mag)), row_off=int(row_off),
        r_total=nr if r_total is None else int(r_total))


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
    controls.  Launches the CUDA kernel for CUDA tensors; the plain twin for
    CPU tensors."""
    if re.dim() != 3 or re.shape != im.shape:
        raise ValueError(f"expected re/im (B, nr, nd), got "
                         f"{tuple(re.shape)} and {tuple(im.shape)}")
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
    dev = re.device
    re = _aligned(re.to(torch.float32))
    im = _aligned(im.to(torch.float32))
    win, tw = _slowtime_tables(nd, str(dev))
    det = torch.empty((B, nr, nd), dtype=torch.float32, device=dev)
    mag = torch.empty_like(det) if emit_mag else None
    row_max = torch.empty((B, nr), dtype=torch.float32, device=dev)
    n_dets = torch.zeros((B,), dtype=torch.int32, device=dev)
    nonfinite = torch.zeros((B,), dtype=torch.int32, device=dev)
    lib = kernels.load()
    err = lib.fmcw_slowtime_detect(
        re.data_ptr(), im.data_ptr(), win.data_ptr(), tw.data_ptr(),
        det.data_ptr(), mag.data_ptr() if mag is not None else None,
        row_max.data_ptr(), n_dets.data_ptr(), nonfinite.data_ptr(),
        ctypes.byref(cfg), torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "slowtime_detect")
    slowtime_detect.launches += 1
    return det, mag, row_max, n_dets, nonfinite


def check_mag_geometry(nr: int, nd: int) -> None:
    """Raises NotImplementedError for an nr x nd map that the
    magnitude-only kernel (one range row per lane group, any number of
    rows) does not take."""
    if nd not in (16, 32, 64, 128):
        raise NotImplementedError(
            f"slowtime_mag kernel: n_doppler in (16, 32, 64, 128), got "
            f"{nr}x{nd} (long CPIs are queued in ROADMAP.md)")


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
