"""The split front-end: the fused front-end kernels' entry points for a
sequence-parallel mesh, cut at the corner turn.

Port of ``fmcw_tpu/ops/split_frontend.py``.  JAX cuts its monolithic Pallas
kernel (whole frame in VMEM) in two around the all-to-all of an ``sp > 1``
mesh.  The port's single-GPU front end is already cut there (a frame does
not fit an SM, ``ops/frontend.py``), so its kernels serve the mesh through
these entry points:

* ``range_frontend`` (TPU row 3, ``_kernel_range``) and
  ``range_frontend_fixed`` (row 4, ``_kernel_range_fixed``): kernel A
  (``csrc/range_fft.cu``) and the fixed-point range kernel
  (``csrc/range_fft_fixed.cu``) on a chirp shard (B, nd/sp, nr, 2).  Each
  block transforms its own 8 chirps, and the fixed kernel's window,
  saturation count and BFP exponent are per chirp, so a shard's output is
  bit for bit the matching columns of the whole frame's (and its share of
  the count): the kernels serve unchanged.  Their range-major store
  (B, nr, nd/sp) keeps each destination shard's nr/sp range rows together
  for the all-to-all.
* ``slowtime_detect_split`` (row 5, ``_kernel_slowtime``) and
  ``slowtime_detect_fixed_split`` (row 6, ``_kernel_slowtime_fixed``):
  kernel B's split entry points (``fmcw_slowtime_detect_split`` in
  ``csrc/slowtime_detect.cu``, ``..._fixed_split`` in
  ``csrc/slowtime_detect_fixed.cu``) on a range shard (B, nrl, nd) after
  the corner turn, with the ``h = halo_range + peak_group_radius`` rows
  just below and above it exchanged from the neighbouring shards
  (``halo_lo``, ``halo_hi``: (re, im) pairs, each (B, h, nd)).  The blocks
  at the shard's edges read those rows where the whole-frame kernel wraps
  within the frame; grouping ties break by GLOBAL row ids (``row_offset``,
  ``n_range_total``).  Row maxima, counts and the fixed kernel's
  Doppler-window saturations cover the shard's own rows: a halo row is
  counted by the shard that owns it.  Per-cell scale only, as JAX's; the
  block scale runs the magnitude-only kernel (``detect=False``,
  ``ops/frontend.slowtime_mag``), ``ops/cfar.block_scale_map_sharded`` and
  ``ops/cfar_detect.cfar_detect(prepadded_range=True)``
  (``parallel/sharded.py``).
* ``split_frontend_frame``: the ``sp == 1`` composition with a self-halo.

Every slow-time step before the CFAR is local to a range row and the halo
rows are exact copies of the neighbours' rows, so the split kernels equal
the whole-frame kernels' matching rows bit for bit at any sp (JAX's
``split_frontend.py:26-34`` contract).  JAX's kernel B writes its det planes
in a sliced layout that ``split_topk_remap`` maps back to map rows; the
port's writes natural (B, nrl, nd) rows, so that function has no
counterpart.

Each wrapper launches its kernel for a CUDA tensor and takes its plain twin
(``range_fft_plain``, ``range_fft_fixed_plain``,
``slowtime_detect_split_plain``, ``slowtime_detect_fixed_split_plain``: the
whole-frame twins on the shard, the slow-time ones on the halo-extended
slab) only for a CPU tensor; ``launches`` counts its kernel launches.  The
names differ from the whole-frame wrappers' so that each wrapper's count
stands alone in ``kernels.launch_counts()``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..params import CfarParams
from . import cfar as C
from . import frontend as F
from . import frontend_fixed as FX
from .notch import check_notch


# ---------------------------------------------------------------------------
# Rows 3 and 4: the range kernels on a chirp shard
# ---------------------------------------------------------------------------

@kernels.counted
def range_frontend(iq: torch.Tensor):
    """Window + range FFT of a chirp shard, int16 (B, nd/sp, nr, 2) ->
    float32 (re, im), each range-major (B, nr, nd/sp).  Launches kernel A
    for a CUDA tensor; the plain twin (``ops/frontend.range_fft_plain``)
    for a CPU tensor."""
    F.check_iq(iq)
    if F._device_kind(iq) == "cpu":
        return F.range_fft_plain(iq)
    out = F.launch_range_fft(iq)
    range_frontend.launches += 1
    return out


@kernels.counted
def range_frontend_fixed(iq: torch.Tensor, coef_width: int = 16,
                         rounding: str = "unbiased"):
    """Q15 window + range FFT + BFP of a chirp shard: int16 (B, nd/sp, nr,
    2) -> int16 (re, im), each (B, nr, nd/sp), and the shard's window
    saturation count (B,).  Launches the fixed range kernel for a CUDA
    tensor (at sp = 4 a batch of 128 is 256 pairs of groups, about two a
    block: the kernel's persistent blocks keep the next copies in flight);
    the plain twin for a CPU tensor."""
    F.check_iq(iq)
    if F._device_kind(iq) == "cpu":
        return FX.range_fft_fixed_plain(iq, coef_width, rounding)
    out = FX.launch_range_fft_fixed(iq, coef_width, rounding)
    range_frontend_fixed.launches += 1
    return out


# ---------------------------------------------------------------------------
# Rows 5 and 6: kernel B on a range shard with exchanged halo rows
# ---------------------------------------------------------------------------

def _check_shard(re, im, halo_lo, halo_hi, h, row_offset, n_range_total,
                 name):
    if re.dim() != 3 or re.shape != im.shape:
        raise ValueError(f"{name}: expected re/im (B, nrl, nd), got "
                         f"{tuple(re.shape)} and {tuple(im.shape)}")
    B, nrl, nd = re.shape
    for pair in (halo_lo, halo_hi):
        if pair is None or len(pair) != 2 or any(
                tuple(x.shape) != (B, h, nd) or x.dtype != re.dtype
                for x in pair):
            raise ValueError(
                f"{name}: halo_lo and halo_hi must be (re, im) pairs of "
                f"{re.dtype} ({B}, {h}, {nd}) (halo_range + "
                f"peak_group_radius rows)")
    if not 0 <= row_offset <= n_range_total - nrl:
        raise ValueError(f"{name}: rows {row_offset}..{row_offset + nrl} do "
                         f"not lie in a frame of {n_range_total} rows")


def _extend(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    return torch.cat([lo, x, hi], dim=-2)


def detect_halo_plain(mag: torch.Tensor, cfar: CfarParams,
                      scale_override: int, peak_group_radius: int,
                      row_offset: int, n_range_total: int):
    """CFAR decision and peak grouping of a range shard's rows from its
    magnitudes extended by ``h = halo_range + peak_group_radius`` rows on
    each side, (..., nrl + 2h, nd): returns (det (..., nrl, nd), row_max,
    n_dets).  The decision covers the shard's rows and the ``radius`` rows
    beyond each edge (``cfar_2d(prepadded_range=True)``), so grouping sees
    the neighbours' decisions; ties break by global row ids."""
    pgr = peak_group_radius
    det, _, _ = C.cfar_2d(mag, scale_override, cfar, prepadded_range=True)
    if pgr > 0:
        nrl = det.shape[-2] - 2 * pgr
        ids = (row_offset + torch.arange(-pgr, nrl + pgr)) % n_range_total
        det = C.peak_group(det, pgr, row_ids=ids)[..., pgr:pgr + nrl, :]
    return (det, det.amax(dim=-1),
            (det > 0).sum(dim=(-2, -1)).to(torch.int32))


def slowtime_detect_split_plain(re, im, halo_lo, halo_hi, mti_bypass=False,
                                scale_override=0, row_offset=0, *,
                                cfar: CfarParams, n_range_total: int,
                                notch_mode: int = 2, transient: str = "zero",
                                exact_mag: bool = False,
                                peak_group_radius: int = 0,
                                emit_mag: bool = False):
    """Plain twin of ``slowtime_detect_split``: kernel B's twin on the
    halo-extended slab, keeping the shard's rows."""
    h = cfar.halo_range + peak_group_radius
    mag = F.slowtime_mag_plain(_extend(re, halo_lo[0], halo_hi[0]),
                               _extend(im, halo_lo[1], halo_hi[1]),
                               mti_bypass, notch_mode, transient, exact_mag)
    det, row_max, n_dets = detect_halo_plain(
        mag, cfar, scale_override, peak_group_radius, row_offset,
        n_range_total)
    core = mag[..., h:mag.shape[-2] - h, :]
    nonfinite = (~torch.isfinite(core)).sum(dim=(-2, -1)).to(torch.int32)
    return det, (core if emit_mag else None), row_max, n_dets, nonfinite


def _split_config(re, cfar, scale_override, peak_group_radius, exact_mag,
                  row_offset, n_range_total, name):
    if cfar.scale_mode != "cell":
        raise NotImplementedError(
            f"{name} kernel: per-cell scale only (the block scale runs the "
            f"magnitude-only kernel and the sharded CFAR tail)")
    B, nrl, nd = re.shape
    return F._slowtime_config(B, nrl, nd, cfar, scale_override,
                              peak_group_radius, exact_mag, name=name,
                              row_off=row_offset, r_total=n_range_total)


@kernels.counted
def slowtime_detect_split(re: torch.Tensor, im: torch.Tensor,
                          halo_lo=None, halo_hi=None, mti_bypass=False,
                          scale_override=0, row_offset: int = 0, *,
                          cfar: CfarParams | None = None,
                          n_range_total: int = 0, detect: bool = True,
                          notch_mode: int = 2, transient: str = "zero",
                          exact_mag: bool = False, peak_group_radius: int = 0,
                          emit_mag: bool = False):
    """Kernel B on a range shard (B, nrl, nd) of float32 planes after the
    corner turn, with the exchanged halo rows ``halo_lo`` / ``halo_hi``
    ((re, im), each (B, halo_range + peak_group_radius, nd)); the shard is
    rows ``row_offset`` .. ``row_offset + nrl`` of a frame of
    ``n_range_total`` rows.  Returns ``(det (B, nrl, nd), mag | None,
    row_max (B, nrl), n_dets (B,), nonfinite (B,))`` for the shard's rows.

    ``detect=False`` is the magnitude-only form (JAX's
    ``slowtime_detect(detect=False)``, the block-scale front end): no halo,
    ``(mag (B, nrl, nd), nonfinite (B,))`` from ``ops/frontend.
    slowtime_mag``.  Launches the split kernel for CUDA tensors; the plain
    twin for CPU tensors."""
    if not detect:
        return F.slowtime_mag(re, im, mti_bypass, notch_mode=notch_mode,
                              transient=transient, exact_mag=exact_mag)
    if cfar is None:
        raise ValueError("slowtime_detect_split(detect=True) needs cfar")
    h = cfar.halo_range + peak_group_radius
    _check_shard(re, im, halo_lo, halo_hi, h, row_offset, n_range_total,
                 "slowtime_detect_split")
    kw = dict(cfar=cfar, n_range_total=n_range_total, notch_mode=notch_mode,
              transient=transient, exact_mag=exact_mag,
              peak_group_radius=peak_group_radius, emit_mag=emit_mag)
    if F._device_kind(re) == "cpu":
        return slowtime_detect_split_plain(re, im, halo_lo, halo_hi,
                                           mti_bypass, scale_override,
                                           row_offset, **kw)
    cfg = F._detect_config(
        _split_config(re, cfar, scale_override, peak_group_radius, exact_mag,
                      row_offset, n_range_total, "slowtime_detect_split"),
        cfar, notch_mode, transient, mti_bypass, "slowtime_detect_split")
    if re.dtype != torch.float32:
        raise ValueError(f"slowtime_detect_split kernel takes float32 "
                         f"planes, got {re.dtype}")
    B, nrl, nd = re.shape
    dev = re.device
    planes = [F._aligned(x) for x in (re, im, *halo_lo, *halo_hi)]
    win, tw = F._slowtime_tables(nd, str(dev))
    det = torch.empty((B, nrl, nd), dtype=torch.float32, device=dev)
    mag = torch.empty_like(det) if emit_mag else None
    row_max = torch.empty((B, nrl), dtype=torch.float32, device=dev)
    n_dets = torch.zeros((B,), dtype=torch.int32, device=dev)
    nonfinite = torch.zeros((B,), dtype=torch.int32, device=dev)
    lib = kernels.load()
    err = lib.fmcw_slowtime_detect_split(
        *(x.data_ptr() for x in planes), win.data_ptr(), tw.data_ptr(),
        det.data_ptr(), mag.data_ptr() if mag is not None else None,
        row_max.data_ptr(), n_dets.data_ptr(), nonfinite.data_ptr(),
        ctypes.byref(cfg), torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "slowtime_detect_split")
    slowtime_detect_split.launches += 1
    return det, mag, row_max, n_dets, nonfinite


def slowtime_detect_fixed_split_plain(re, im, halo_lo, halo_hi,
                                      mti_bypass=False, scale_override=0,
                                      row_offset=0, *, cfar: CfarParams,
                                      n_range_total: int, notch_mode: int = 2,
                                      transient: str = "zero",
                                      coef_width: int = 16,
                                      rounding: str = "unbiased",
                                      peak_group_radius: int = 0,
                                      emit_mag: bool = False):
    """Plain twin of ``slowtime_detect_fixed_split``: the fixed slow-time
    twin on the shard's rows (whose saturations it counts) and, uncounted,
    on the halo rows, then the decision on the extended slab."""
    h = cfar.halo_range + peak_group_radius
    kw = dict(mti_bypass=mti_bypass, notch_mode=notch_mode,
              transient=transient, coef_width=coef_width, rounding=rounding)
    mag, sat = FX.slowtime_mag_fixed_plain(re, im, **kw)
    halo, _ = FX.slowtime_mag_fixed_plain(
        torch.cat([halo_lo[0], halo_hi[0]], dim=-2),
        torch.cat([halo_lo[1], halo_hi[1]], dim=-2), **kw)
    det, row_max, n_dets = detect_halo_plain(
        _extend(mag, halo[..., :h, :], halo[..., h:, :]), cfar,
        scale_override, peak_group_radius, row_offset, n_range_total)
    return det, (mag if emit_mag else None), row_max, n_dets, sat


@kernels.counted
def slowtime_detect_fixed_split(re: torch.Tensor, im: torch.Tensor,
                                halo_lo=None, halo_hi=None, mti_bypass=False,
                                scale_override=0, row_offset: int = 0, *,
                                cfar: CfarParams | None = None,
                                n_range_total: int = 0, detect: bool = True,
                                notch_mode: int = 2, transient: str = "zero",
                                coef_width: int = 16,
                                rounding: str = "unbiased",
                                peak_group_radius: int = 0,
                                emit_mag: bool = False):
    """The fixed-point kernel B on a range shard of int16 planes (B, nrl,
    nd), with exchanged int16 halo rows, as ``slowtime_detect_split``.
    Returns
    ``(det int32 (B, nrl, nd), mag | None, row_max int32 (B, nrl), n_dets
    (B,), sat (B,))``, ``sat`` the Doppler window's saturations of the
    shard's own rows.  ``detect=False`` (a fixed magnitude-only kernel)
    does not exist, as in JAX's split path: it raises.  Launches the split
    kernel for CUDA tensors; the plain twin for CPU tensors."""
    if not detect:
        raise NotImplementedError(
            "slowtime_detect_fixed_split(detect=False): the fixed split path "
            "is per-cell scale only, as JAX's (no fixed magnitude-only "
            "kernel)")
    if cfar is None:
        raise ValueError("slowtime_detect_fixed_split needs cfar")
    check_notch(notch_mode, transient)
    h = cfar.halo_range + peak_group_radius
    _check_shard(re, im, halo_lo, halo_hi, h, row_offset, n_range_total,
                 "slowtime_detect_fixed_split")
    if F._device_kind(re) == "cpu":
        return slowtime_detect_fixed_split_plain(
            re, im, halo_lo, halo_hi, mti_bypass, scale_override, row_offset,
            cfar=cfar, n_range_total=n_range_total, notch_mode=notch_mode,
            transient=transient, coef_width=coef_width, rounding=rounding,
            peak_group_radius=peak_group_radius, emit_mag=emit_mag)
    if re.dtype != torch.int16:
        raise ValueError(f"slowtime_detect_fixed_split kernel takes int16 "
                         f"planes, got {re.dtype}")
    cfg = FX.fixed_config(
        _split_config(re, cfar, scale_override, peak_group_radius, False,
                      row_offset, n_range_total,
                      "slowtime_detect_fixed_split"),
        cfar, notch_mode, transient, mti_bypass, coef_width, rounding,
        "slowtime_detect_fixed_split")
    B, nrl, nd = re.shape
    dev = re.device
    planes = [F._aligned(x) for x in (re, im, *halo_lo, *halo_hi)]
    win, tw = FX._tables(nd, coef_width, str(dev))
    det = torch.empty((B, nrl, nd), dtype=torch.int32, device=dev)
    mag = torch.empty_like(det) if emit_mag else None
    row_max = torch.empty((B, nrl), dtype=torch.int32, device=dev)
    n_dets = torch.zeros((B,), dtype=torch.int32, device=dev)
    sat = torch.zeros((B,), dtype=torch.int32, device=dev)
    lib = kernels.load()
    err = lib.fmcw_slowtime_detect_fixed_split(
        *(x.data_ptr() for x in planes), win.data_ptr(), tw.data_ptr(),
        det.data_ptr(), mag.data_ptr() if mag is not None else None,
        row_max.data_ptr(), n_dets.data_ptr(), sat.data_ptr(),
        ctypes.byref(cfg), torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "slowtime_detect_fixed_split")
    slowtime_detect_fixed_split.launches += 1
    return det, mag, row_max, n_dets, sat


# ---------------------------------------------------------------------------
# The sp == 1 composition
# ---------------------------------------------------------------------------

def split_frontend_frame(iq: torch.Tensor, mti_bypass=False,
                         scale_override=0, *, cfar: CfarParams,
                         fixed: bool = False, peak_group_radius: int = 0,
                         notch_mode: int = 2, transient: str = "zero",
                         coef_width: int = 16,
                         window_rounding: str = "unbiased",
                         exact_mag: bool = False, emit_mag: bool = False):
    """The split entries composed on whole frames (the ``sp == 1`` mesh):
    the range kernel on all chirps, then kernel B's split entry with a
    self-halo (the frame's own last / first rows, the torus of the
    whole-frame kernel).  iq int16 (B, nd, nr, 2) -> ``(det (B, nr, nd),
    mag | None, stat (B,), row_max (B, nr), n_dets (B,))`` with ``stat``
    the non-finite count (float) or the saturation count of both windows
    (fixed).  Bit-identical to ``ops/frontend.rdm_frontend_detect`` /
    ``ops/frontend_fixed.rdm_frontend_fixed_detect``."""
    nr = iq.shape[2]
    h = cfar.halo_range + peak_group_radius
    kw = dict(cfar=cfar, n_range_total=nr, notch_mode=notch_mode,
              transient=transient, peak_group_radius=peak_group_radius,
              emit_mag=emit_mag)
    if fixed:
        re, im, sat_r = range_frontend_fixed(iq, coef_width, window_rounding)
    else:
        re, im = range_frontend(iq)
    lo = (re[:, nr - h:], im[:, nr - h:])
    hi = (re[:, :h], im[:, :h])
    if fixed:
        det, mag, row_max, n_dets, sat = slowtime_detect_fixed_split(
            re, im, lo, hi, mti_bypass, scale_override, 0,
            coef_width=coef_width, rounding=window_rounding, **kw)
        return det, mag, sat_r + sat, row_max, n_dets
    det, mag, row_max, n_dets, nonfinite = slowtime_detect_split(
        re, im, lo, hi, mti_bypass, scale_override, 0, exact_mag=exact_mag,
        **kw)
    return det, mag, nonfinite, row_max, n_dets
