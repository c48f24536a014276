#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fmcw_tpu_torch) on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py

It builds the CUDA kernels from fmcw_tpu_torch/csrc/ (into build/), holds
each kernel against its plain PyTorch twin on the card, drives the float32
main path (int16 frames -> detections, batch 128 at 1024x128, the
reference-exact per-cell scale and the block scale of fast()) through the
processor a user calls, checks its detections against the plain path with
the margin gate of fmcw_tpu_torch/parity.py, runs the tracker over 6 scans,
and times the kernels and the path with CUDA events.  Then the same for
fixed mode (the reference's 16-bit chain): its two kernels and the CFAR
kernel against their twins, its main path on both routes (staged: plain
stages and the CFAR kernel; fused: the two fixed-point kernels) at batch
128, the golden frame's detections against the golden numpy model, and
the kernels' timings.  It prints the card's name and power limit, one JSON
line listing the kernels, and as its last line {"ok": true, "device":
{...}}.  Any failed check raises, and the script then exits non-zero;
without CUDA it exits non-zero at once.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12     # FP32 outside the tensor cores, dense
# INT32 outside the tensor cores: 64 INT32 lanes per SM (half the FP32
# lanes, one op each) x 132 SMs x 1.98 GHz, the clock behind the data
# sheet's 67 TFLOP/s FP32 (= 128 lanes x 2 x 132 x 1.98 GHz).
H100_INT32_OPS_PER_S = 16.7e12
H100_FP64_OPS_PER_S = 34e12     # FP64 outside the tensor cores, data sheet
BATCH = 128
TOL = 1e-5                      # transforms: relative to the map peak


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events over ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_batch(p, batch: int, seed: int = 0):
    """bench.py's stimulus: the golden two-target frame plus seeded +-8
    noise per frame, int16 (batch, nd, nr, 2)."""
    import numpy as np
    from fmcw_tpu_torch.golden import reference
    from fmcw_tpu_torch.models import pipeline as pl
    rng = np.random.default_rng(seed)
    frame = pl.complex_to_iq(reference.two_target_frame(p))
    out = np.stack([frame] * batch)
    return out + rng.integers(-8, 8, out.shape).astype(np.int16)


def bound_range_fft(B: int, nd: int, nr: int):
    """Least time for kernel A: each int16 I/Q sample read once, re/im
    written once; 5 n log2 n flops per chirp FFT plus the window."""
    nbytes = B * nd * nr * 4 + B * nr * nd * 8
    ops = B * nd * (5 * nr * math.log2(nr) + 2 * nr)
    return _bound(nbytes, ops)


def bound_slowtime(B: int, nr: int, nd: int, cfar):
    """Least time for kernel B: re/im read once, the matrix once, det and
    row maxima written once; 8 flops per complex MAC of the slow-time
    product, the magnitude, and the CFAR's adds and compares per cell
    (``_cfar_ops``).  Peak grouping (only on CFAR-passing cells) is left
    out."""
    cells = B * nr * nd
    nbytes = cells * 8 + nd * nd * 8 + cells * 4 + B * nr * 4 + B * 8
    ops = cells * (8 * nd + 4 + _cfar_ops(cfar))
    return _bound(nbytes, ops)


def _cfar_ops(cfar) -> int:
    """The CFAR's adds and compares per cell that the function needs:
    per-cell scale, the full and guard box sums as separable running sums
    (4 adds per cell per box), mean and hi/lo thresholds (4), 2 hi/lo and 1
    detection compare-add per training cell, the classification (8); block
    scale, the detection compare-adds and the block statistics."""
    if cfar.scale_mode == "cell":
        return 2 * 4 + 4 + 6 * cfar.n_ref + 8
    return 2 * cfar.n_ref + 16


def bound_range_fft_fixed(B: int, nd: int, nr: int):
    """Least time for range_fft_fixed: each int16 I/Q sample read once, the
    int16 re/im planes written once; the FFT's 5 n log2 n flops and 10 per
    bin of BFP peak and quantization (FP64, the kernel's type), 10 integer
    ops per sample for the Q15 window, its saturation test and clip
    (INT32)."""
    nbytes = B * nd * nr * 4 * 2 + B * 4
    fp64 = B * nd * (5 * nr * math.log2(nr) + 10 * nr)
    return _bound(nbytes, 0, B * nd * nr * 10, fp64)


def bound_slowtime_fixed(B: int, nr: int, nd: int, cfar):
    """Least time for slowtime_detect_fixed: int16 re/im read once, det and
    row maxima written once; FFT and BFP flops as above (FP64); MTI (8),
    window (10), magnitude (6) and the CFAR's compare-adds per cell
    (INT32).  Peak grouping is left out."""
    cells = B * nr * nd
    nbytes = cells * 4 + cells * 4 + B * nr * 4 + B * 8
    fp64 = B * nr * (5 * nd * math.log2(nd) + 10 * nd)
    return _bound(nbytes, 0, cells * (24 + _cfar_ops(cfar)), fp64)


def bound_cfar_detect(B: int, nr: int, nd: int, cfar, integer: bool):
    """Least time for cfar_detect: the map read once (and the scale map in
    block mode), det and scale written once; the CFAR's compare-adds per
    cell, INT32 for integer maps, FP32 for float maps."""
    cells = B * nr * nd
    nbytes = cells * (12 + (4 if cfar.scale_mode == "block" else 0))
    ops = cells * _cfar_ops(cfar)
    return _bound(nbytes, 0 if integer else ops, ops if integer else 0)


def _bound(nbytes: float, ops: float, int_ops: float = 0,
           fp64_ops: float = 0):
    """(ms, what bounds it): the larger of bytes over the memory rate and
    the busiest pipe's operations over its peak rate (FP32, INT32 and FP64
    are separate units that run at the same time)."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = max(ops / H100_FP32_OPS_PER_S, int_ops / H100_INT32_OPS_PER_S,
                fp64_ops / H100_FP64_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def hot_batch(p, batch: int):
    """The saturating stimulus of tests/test_frontend_fixed.py: the golden
    frame x 40, clipped to int16, one seed per frame."""
    import numpy as np
    from fmcw_tpu_torch.golden import reference
    from fmcw_tpu_torch.models import pipeline as pl
    frames = [np.clip(np.asarray(reference.two_target_frame(p, seed=5 + i))
                      * 40, -32768, 32767) for i in range(batch)]
    return np.stack([pl.complex_to_iq(z) for z in frames])


def fixed_kernel_checks(dev, pgr: int):
    """Phase 7: range_fft_fixed and slowtime_detect_fixed against their
    twins at batch 128, 1024x128: quantized values within 1 LSB (range) and
    magnitudes within 2 LSB (the kernels' FP64 FFTs against the twins' dense
    FP64 products; both quantize to the golden model's values, so the
    differences are expected to be 0, and are counted), saturation counts
    exact, the decision bit-identical to the plain integer CFAR and grouping
    on the kernel's own magnitudes.  Returns ({row: max_abs_err}, the range
    planes)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.ops import frontend as F, frontend_fixed as FX
    errs = {}
    iq = torch.as_tensor(make_batch(P.RadarParams(), BATCH, seed=3),
                         device=dev)
    re, im, sat = FX.range_fft_fixed(iq)
    pre, pim, psat = FX.range_fft_fixed_plain(iq)
    torch.cuda.synchronize()
    err = int(torch.maximum((re.int() - pre.int()).abs().max(),
                            (im.int() - pim.int()).abs().max()))
    n_off = int((re != pre).sum() + (im != pim).sum())
    log(f"range_fft_fixed vs plain: max {err} LSB ({n_off} of "
        f"{2 * re.numel()} values differ), saturation "
        f"{'exact' if torch.equal(sat, psat) else 'DIFFERS'}")
    if err > 1 or not torch.equal(sat, psat):
        raise AssertionError("range_fft_fixed disagrees with its plain twin")
    errs["range_fft_fixed"] = float(err)
    for p in (P.RadarParams(), P.fast()):
        name = f"slowtime_detect_fixed[{p.cfar.scale_mode}]"
        worst = 0
        for bypass in (False, True):
            for so in (0, 4):
                det, mag, rmax, ndet, sat_d = FX.slowtime_detect_fixed(
                    re, im, bypass, so, cfar=p.cfar, peak_group_radius=pgr,
                    emit_mag=True)
                pmag, psat_d = FX.slowtime_mag_fixed_plain(re, im, bypass)
                d2, r2, n2, _ = F.detect_plain(mag, p.cfar, so, pgr)
                torch.cuda.synchronize()
                err = int((mag - pmag).abs().max())
                n_off = int((mag != pmag).sum())
                worst = max(worst, err)
                same = (torch.equal(det, d2) and torch.equal(rmax, r2)
                        and torch.equal(ndet, n2))
                log(f"slowtime_detect_fixed {p.cfar.scale_mode} bypass="
                    f"{bypass} so={so}: mag max {err} LSB ({n_off} differ), "
                    f"saturation "
                    f"{'exact' if torch.equal(sat_d, psat_d) else 'DIFFERS'}"
                    f", decision {'bit-identical' if same else 'DIFFERS'}, "
                    f"n_dets {int(ndet.min())}..{int(ndet.max())}")
                if err > 2 or not torch.equal(sat_d, psat_d) or not same:
                    raise AssertionError(f"{name} disagrees with its twin")
        errs[name] = float(worst)
    # The numeric options at 256x64: 3-pulse MTI, passthrough transient,
    # the reference's biased window rounding.
    p = P.RadarParams(n_range=256, n_doppler=64, notch_mode=3)
    kw = dict(transient="passthrough", rounding="biased")
    iq = torch.as_tensor(make_batch(p, 8, seed=4), device=dev)
    sre, sim, s1 = FX.range_fft_fixed(iq, rounding="biased")
    pre, pim, ps1 = FX.range_fft_fixed_plain(iq, rounding="biased")
    det, mag, rmax, ndet, s2 = FX.slowtime_detect_fixed(
        sre, sim, cfar=p.cfar, notch_mode=3, peak_group_radius=pgr,
        emit_mag=True, **kw)
    pmag, ps2 = FX.slowtime_mag_fixed_plain(sre, sim, False, 3, **kw)
    d2, r2, n2, _ = F.detect_plain(mag, p.cfar, 0, pgr)
    torch.cuda.synchronize()
    err_a = int(torch.maximum((sre.int() - pre.int()).abs().max(),
                              (sim.int() - pim.int()).abs().max()))
    err_b = int((mag - pmag).abs().max())
    same = (torch.equal(det, d2) and torch.equal(rmax, r2)
            and torch.equal(ndet, n2) and torch.equal(s1, ps1)
            and torch.equal(s2, ps2))
    log(f"fixed kernels at 256x64 notch 3 {kw}: range {err_a} LSB, mag "
        f"{err_b} LSB, saturation and decision "
        f"{'exact' if same else 'DIFFER'}")
    if err_a > 1 or err_b > 2 or not same:
        raise AssertionError("fixed kernels disagree at 256x64 notch 3")
    return errs, (re, im)


def saturation_check(dev):
    """Phase 7b: the saturating stimulus through both fixed kernels, their
    twins and the staged route: equal, nonzero saturation counts."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.models import pipeline as pl
    from fmcw_tpu_torch.ops import frontend_fixed as FX
    for p in (P.RadarParams(), P.RadarParams(n_range=256, n_doppler=64)):
        iq = torch.as_tensor(hot_batch(p, 8), device=dev)
        _, _, sat, _, _ = FX.rdm_frontend_fixed_detect(iq, cfar=p.cfar)
        _, _, psat, _, _ = FX.rdm_frontend_fixed_detect(iq, cfar=p.cfar,
                                                        plain=True)
        staged = pl.make_batch_processor(p, mode="fixed", include_maps=False,
                                         device=dev)(iq)["saturation_count"]
        torch.cuda.synchronize()
        log(f"saturation x40 at {p.n_range}x{p.n_doppler}: kernels "
            f"{sat.tolist()}, twins {psat.tolist()}, staged "
            f"{staged.tolist()}")
        if (not torch.equal(sat, psat) or not torch.equal(sat, staged)
                or int(sat.min()) <= 0):
            raise AssertionError("saturation counts differ or are zero")


def cfar_kernel_checks(dev, planes):
    """Phase 8: cfar_detect against ops/cfar.cfar_2d on int32 maps (the
    fixed chain's) and float32 maps (the float staged chain's), both scale
    modes, scale_override 0 and 4: det and scale bit-identical.  Returns
    ({row: largest |det - det_plain| or |scale - scale_plain|}, the int32
    magnitudes)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.models import pipeline as pl
    from fmcw_tpu_torch.ops import cfar as C, cfar_detect as CD
    from fmcw_tpu_torch.ops import frontend_fixed as FX
    imag, _ = FX.slowtime_mag_fixed_plain(*planes)
    iq = torch.as_tensor(make_batch(P.RadarParams(), BATCH, seed=5),
                         device=dev)
    fmag = pl.make_batch_processor(frontend="staged", device=dev)(
        iq)["mag_map"]
    errs = {}
    for mag in (imag, fmag):
        for p in (P.RadarParams(), P.fast()):
            name = f"cfar_detect[{p.cfar.scale_mode}]"
            for so in (0, 4):
                det, scale = CD.cfar_detect(mag, so, cfar=p.cfar)
                d2, _, s2 = C.cfar_2d(mag, so, p.cfar)
                torch.cuda.synchronize()
                same = torch.equal(det, d2) and torch.equal(scale, s2)
                err = max(float((det.double() - d2.double()).abs().max()),
                          float((scale - s2).abs().max()))
                errs[name] = max(errs.get(name, 0.0), err)
                log(f"cfar_detect {mag.dtype} {p.cfar.scale_mode} so={so}: "
                    f"det and scale {'bit-identical' if same else 'DIFFER'},"
                    f" {int((det > 0).sum())} detections")
                if not same:
                    raise AssertionError("cfar_detect disagrees with cfar_2d")
    return errs, imag


def fixed_main_path(card: str, dev):
    """Phase 9: make_batch_processor(p, mode="fixed") for RadarParams() and
    fast(), peak_group_radius 0 and 2, frontend "auto" (staged) and "fused",
    at batch 128: the kernels each route launches, the detections of the
    golden frame and of the noisy batch's frame 0 against the golden numpy
    model, the two routes against each other on the whole noisy batch,
    frames/s.  The staged route runs the same plain stage code the fused
    kernels' twins are made of, so staged against fused repeats the
    kernel-against-twin check on the whole path; the golden numpy model is
    the independent witness.  Returns (launches, frames/s, report)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch import kernels, parity
    from fmcw_tpu_torch.golden import fixed_point as fx, reference
    from fmcw_tpu_torch.models import pipeline as pl
    launches, fps, report = {}, {}, {}
    for p in (P.RadarParams(), P.fast()):
        mode = p.cfar.scale_mode
        golden = pl.complex_to_iq(reference.two_target_frame(p))[None]
        _, gdet = reference.process_frame_fixed(reference.two_target_frame(p),
                                                p)
        noisy = make_batch(p, BATCH)
        _, ndet = reference.process_frame_fixed(
            noisy[0, ..., 0] + 1j * noisy[0, ..., 1].astype(float), p)
        batch = torch.as_tensor(noisy, device=dev)
        for pgr in (0, 2):
            want = parity.map_set(fx.peak_group(gdet, pgr) if pgr else gdet)
            want0 = parity.map_set(fx.peak_group(ndet, pgr) if pgr else ndet)
            outs = {}
            for fe in ("auto", "fused"):
                proc = pl.make_batch_processor(p, mode="fixed", frontend=fe,
                                               peak_group_radius=pgr,
                                               device=dev)
                kernels.reset_launch_counts()
                out = proc(batch)
                torch.cuda.synchronize()
                counts = kernels.launch_counts()
                need = (("cfar_detect",) if fe == "auto"
                        else ("range_fft_fixed", "slowtime_detect_fixed"))
                log(f"fixed main path {mode} r={pgr} {fe}: launches "
                    + ", ".join(f"{k}={v}" for k, v in counts.items() if v))
                if any(counts[k] < 1 for k in need):
                    raise AssertionError(f"fixed {fe} path skipped a kernel")
                for k, v in counts.items():
                    key = (k if k == "range_fft_fixed"
                           else f"{k}[{mode}]")
                    if k in need:
                        launches[key] = launches.get(key, 0) + v
                for key in ("range_bin", "doppler_bin", "mag", "valid"):
                    if tuple(out[key].shape) != (BATCH, p.tracker.max_dets):
                        raise AssertionError(f"{key} shape "
                                             f"{tuple(out[key].shape)}")
                if out["mag"].dtype != torch.int32:
                    raise AssertionError(f"fixed mag dtype {out['mag'].dtype}")
                outs[fe] = out
                ok, rep = parity.fixed_gate(
                    parity.map_set(out["det_map"][0].cpu().numpy()), want0)
                log(f"noisy frame 0 {mode} r={pgr} {fe} vs golden model: "
                    f"{rep}")
                if not ok:
                    raise AssertionError(f"fixed {fe} path differs from the "
                                         f"golden model on noisy frame 0")
                one = proc(torch.as_tensor(golden, device=dev))
                ok, rep = parity.fixed_gate(
                    parity.map_set(one["det_map"][0].cpu().numpy()), want)
                log(f"golden frame {mode} r={pgr} {fe} vs golden model: "
                    f"{rep}")
                if not ok:
                    raise AssertionError(f"fixed {fe} path misses the golden "
                                         f"model's detections")
                if pgr == 2:
                    # Timed without the maps, as the float path is.
                    lean = pl.make_batch_processor(
                        p, mode="fixed", frontend=fe, peak_group_radius=pgr,
                        include_maps=False, device=dev)
                    fps[f"{mode}/{fe}"] = BATCH * 1e3 / cuda_ms(
                        lambda: lean(batch), 10)
                    log(f"fixed main path {mode} {fe}: "
                        f"{fps[f'{mode}/{fe}']:.1f} frames/s at batch "
                        f"{BATCH} ({card})")
            a = [parity.map_set(m) for m in
                 outs["auto"]["det_map"].cpu().numpy()]
            b = [parity.map_set(m) for m in
                 outs["fused"]["det_map"].cpu().numpy()]
            ok0, rep0 = parity.fixed_gate(a[0], b[0])
            inexact, worst = 0, 0
            for x, y in zip(a, b):
                ok, _ = parity.fixed_gate(x, y, exact=False)
                if not ok:
                    raise AssertionError(f"fixed routes {mode} r={pgr}: "
                                         f"{parity.fixed_gate(x, y, False)}")
                sym = len(set(x) ^ set(y))
                inexact += sym > 0
                worst = max(worst, sym)
            sat_same = torch.equal(outs["auto"]["saturation_count"],
                                   outs["fused"]["saturation_count"])
            log(f"fixed routes {mode} r={pgr}, staged vs fused: frame 0 "
                f"{rep0}; {inexact} of {BATCH} frames not exact (worst "
                f"{worst} one-sided); saturation "
                f"{'equal' if sat_same else 'DIFFERS'}")
            if not ok0 or not sat_same:
                raise AssertionError(f"fixed routes differ on frame 0 "
                                     f"({mode} r={pgr})")
            report[f"{mode}/r{pgr}"] = {"frames_not_exact": inexact,
                                        "worst_one_sided": worst}
    return launches, fps, report


def fixed_mode(card: str, dev):
    """Phases 7-11 (fixed mode); returns (kernel rows, summary)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.ops import cfar as C, cfar_detect as CD
    from fmcw_tpu_torch.ops import detect as DET, frontend_fixed as FX
    from fmcw_tpu_torch.ops.window import hamming_q15, window_apply_fixed
    pgr = 2
    errs, planes = fixed_kernel_checks(dev, pgr)
    saturation_check(dev)
    cerrs, imag = cfar_kernel_checks(dev, planes)
    launches, fps, report = fixed_main_path(card, dev)

    # 10. Timings at batch 128 (CUDA events), with bounds.
    entry = P.RadarParams()
    nd, nr = entry.n_doppler, entry.n_range
    batch = torch.as_tensor(make_batch(entry, BATCH), device=dev)
    rows, times = [], {}
    ms = cuda_ms(lambda: FX.range_fft_fixed(batch))
    plain = cuda_ms(lambda: FX.range_fft_fixed_plain(batch), 5)
    times.update({"range_fft_fixed": ms, "range_fft_fixed plain": plain})
    wi, wq, _ = window_apply_fixed(batch[..., 0], batch[..., 1],
                                   hamming_q15(nr)[None, :])
    zw = torch.complex(wi.double(), wq.double())     # the kernel's FP64
    lib = cuda_ms(lambda: torch.fft.fft(zw, dim=-1))
    bound, by = bound_range_fft_fixed(BATCH, nd, nr)
    log(f"range_fft_fixed: {ms:.4f} ms, plain {plain:.4f} ms, torch.fft.fft "
        f"{lib:.4f} ms, bound {bound:.4f} ms ({by}) at batch {BATCH} "
        f"({card})")
    src = "fmcw_tpu_torch/csrc/"
    rows.append(dict(name="range_fft_fixed", route="cuda",
                     source=src + "range_fft_fixed.cu",
                     replaces="fmcw_tpu/ops/frontend_pallas.py:813",
                     launches=launches["range_fft_fixed"],
                     max_abs_err=errs["range_fft_fixed"], ms=ms,
                     plain_ms=plain, bound_ms=bound, bound_by=by,
                     library_ms=lib))
    re, im = planes
    for p in (entry, P.fast()):
        mode = p.cfar.scale_mode
        name = f"slowtime_detect_fixed[{mode}]"
        kw = dict(cfar=p.cfar, peak_group_radius=pgr)
        ms = cuda_ms(lambda: FX.slowtime_detect_fixed(re, im, False, 0, **kw))
        plain = cuda_ms(lambda: FX.slowtime_detect_fixed_plain(
            re, im, False, 0, **kw), 2, 1)
        bound, by = bound_slowtime_fixed(BATCH, nr, nd, p.cfar)
        log(f"{name}: {ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.4f} "
            f"ms ({by}) at batch {BATCH} ({card})")
        times[name] = ms
        rows.append(dict(name=name, route="cuda",
                         source=src + "slowtime_detect_fixed.cu",
                         replaces="fmcw_tpu/ops/frontend_pallas.py:813",
                         launches=launches[name], max_abs_err=errs[name],
                         ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                         library_ms=None))
    for p, line in ((entry, 155), (P.fast(), 279)):
        mode = p.cfar.scale_mode
        name = f"cfar_detect[{mode}]"
        # Block scale: the kernel alone, on a scale map computed beforehand
        # (the wrapper computes it with plain PyTorch passes when none is
        # given; timed separately below).
        smap = C.block_scale_map(imag, p.cfar) if mode == "block" else None
        ms = cuda_ms(lambda: CD.cfar_detect(imag, 0, cfar=p.cfar,
                                            scale_map=smap))
        plain = cuda_ms(lambda: CD.cfar_detect_plain(
            imag, 0, cfar=p.cfar, scale_map=smap), 2, 1)
        bound, by = bound_cfar_detect(BATCH, nr, nd, p.cfar, True)
        log(f"{name} (int32 maps): {ms:.4f} ms, plain {plain:.4f} ms, "
            f"bound {bound:.4f} ms ({by}) at batch {BATCH} ({card})")
        times[name] = ms
        rows.append(dict(name=name, route="cuda",
                         source=src + "cfar_detect.cu",
                         replaces=f"fmcw_tpu/ops/cfar_pallas.py:{line}",
                         launches=launches[name], max_abs_err=cerrs[name],
                         ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                         library_ms=None))

    # 11. Where the time goes on each fixed route, per batch of 128, each
    #     stage timed alone.
    stages = {}
    for p in (entry, P.fast()):
        mode = p.cfar.scale_mode
        k = p.tracker.max_dets
        det, _, rmax, ndet, _ = FX.slowtime_detect_fixed(
            re, im, cfar=p.cfar, peak_group_radius=pgr)
        sdet, _ = CD.cfar_detect(imag, 0, cfar=p.cfar)
        stages[mode] = {
            "fused": {
                "range_fft_fixed_ms": times["range_fft_fixed"],
                "slowtime_detect_fixed_ms":
                    times[f"slowtime_detect_fixed[{mode}]"],
                "topk_ms": cuda_ms(lambda: DET.topk_detections(
                    det, k, row_max=rmax, n_dets=ndet)),
                "path_ms": BATCH * 1e3 / fps[f"{mode}/fused"]},
            "staged": {
                "range_stages_ms": times["range_fft_fixed plain"],
                "slowtime_stages_ms": cuda_ms(
                    lambda: FX.slowtime_mag_fixed_plain(re, im), 5),
                "block_scale_map_ms": (cuda_ms(lambda: C.block_scale_map(
                    imag, p.cfar)) if mode == "block" else 0.0),
                "cfar_detect_ms": times[f"cfar_detect[{mode}]"],
                "group_topk_ms": cuda_ms(lambda: DET.topk_detections(
                    C.peak_group(sdet, pgr), k)),
                "path_ms": BATCH * 1e3 / fps[f"{mode}/auto"]}}
        for route, st in stages[mode].items():
            log(f"fixed {route} {mode} per batch of {BATCH}: "
                + ", ".join(f"{key} {v:.4f}" for key, v in st.items()))
    return rows, {"frames_per_s": fps, "routes": report,
                  "stages_ms": stages}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on a CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch import kernels, parity
    from fmcw_tpu_torch.golden import reference
    from fmcw_tpu_torch.golden.tracker import FIRM
    from fmcw_tpu_torch.models import pipeline as pl, tracker as trk
    from fmcw_tpu_torch.ops import detect as DET
    from fmcw_tpu_torch.ops import frontend as F
    from fmcw_tpu_torch.ops.window import hamming_float

    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    # The plain twins' matrix products in full float32 (no TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. Build.
    kernels.load()
    log(f"build: {kernels.build_info.seconds:.1f} s -> "
        f"{kernels.build_info.path}")
    for line in kernels.build_info.log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("---"):
            log(f"  {line.strip()}")

    entry = P.RadarParams()
    block = P.fast()
    pgr = 2
    results = {}

    # 2. Kernel A against its plain twin at the main path's shapes.
    iq = torch.as_tensor(make_batch(entry, BATCH, seed=1), device=dev)
    re, im = F.range_fft(iq)
    pre, pim = F.range_fft_plain(iq)
    torch.cuda.synchronize()
    peak = float(torch.maximum(pre.abs().max(), pim.abs().max()))
    err_a = float(torch.maximum((re - pre).abs().max(),
                                (im - pim).abs().max()))
    log(f"kernel A vs plain: max abs err {err_a:.6g} = "
        f"{err_a / peak:.3g} of peak {peak:.6g} (tol {TOL})")
    if not err_a <= TOL * peak:
        raise AssertionError("range_fft disagrees with its plain twin")
    results["range_fft"] = {"max_abs_err": err_a}

    # 3. Kernel B against its plain twin: transforms by tolerance, the
    #    decision bit for bit on the kernel's own magnitudes.
    for p in (entry, block):
        name = f"slowtime_detect[{p.cfar.scale_mode}]"
        worst = 0.0
        for bypass in (False, True):
            for so in (0, 4):
                det, mag, rmax, ndet, nf = F.slowtime_detect(
                    re, im, bypass, so, cfar=p.cfar, peak_group_radius=pgr,
                    emit_mag=True)
                pmag = F.slowtime_mag_plain(re, im, bypass)
                d2, r2, n2, f2 = F.detect_plain(mag, p.cfar, so, pgr)
                torch.cuda.synchronize()
                mpeak = float(pmag.abs().max())
                err = float((mag - pmag).abs().max())
                worst = max(worst, err)
                same = (torch.equal(det, d2) and torch.equal(rmax, r2)
                        and torch.equal(ndet, n2) and torch.equal(nf, f2))
                log(f"kernel B {p.cfar.scale_mode} bypass={bypass} so={so}: "
                    f"mag err {err / mpeak:.3g} of peak, decision "
                    f"{'bit-identical' if same else 'DIFFERS'}, n_dets "
                    f"{int(ndet.min())}..{int(ndet.max())} per frame")
                if not err <= TOL * mpeak:
                    raise AssertionError(f"{name}: magnitudes disagree")
                if not same:
                    raise AssertionError(f"{name}: decision differs from "
                                         f"the plain CFAR on its magnitudes")
        results[name] = {"max_abs_err": worst}
    # The other map shapes the kernels take (n_doppler 32 and 64), and the
    # 3-pulse MTI with the passthrough transient and the exact magnitude.
    for p, radius, kw in (
            (P.quick(), 1, {}),
            (P.RadarParams(n_range=256, n_doppler=64), pgr, {}),
            (P.RadarParams(n_range=256, n_doppler=64, notch_mode=3), pgr,
             dict(transient="passthrough", exact_mag=True))):
        iq = torch.as_tensor(make_batch(p, 4, seed=2), device=dev)
        sre, sim = F.range_fft(iq)
        pre, pim = F.range_fft_plain(iq)
        det, mag, rmax, ndet, nf = F.slowtime_detect(
            sre, sim, cfar=p.cfar, notch_mode=p.notch_mode,
            peak_group_radius=radius, emit_mag=True, **kw)
        pmag = F.slowtime_mag_plain(sre, sim, False, p.notch_mode, **kw)
        d2, r2, n2, f2 = F.detect_plain(mag, p.cfar, 0, radius)
        torch.cuda.synchronize()
        err_a = float(torch.maximum((sre - pre).abs().max(),
                                    (sim - pim).abs().max()))
        err_b = float((mag - pmag).abs().max())
        same = (torch.equal(det, d2) and torch.equal(rmax, r2)
                and torch.equal(ndet, n2) and torch.equal(nf, f2))
        log(f"kernels at {p.n_range}x{p.n_doppler} notch {p.notch_mode} "
            f"{kw}: A err {err_a / float(pre.abs().max()):.3g}, B mag err "
            f"{err_b / float(pmag.abs().max()):.3g} of peak, decision "
            f"{'bit-identical' if same else 'DIFFERS'}")
        if not (err_a <= TOL * float(torch.maximum(pre.abs().max(),
                                                   pim.abs().max()))
                and err_b <= TOL * float(pmag.abs().max()) and same):
            raise AssertionError(f"kernels disagree at {p.n_range}x"
                                 f"{p.n_doppler} {kw}")

    # 4. The main path: batch 128, both scale modes, through the processor.
    launches = {}
    frames_per_s = {}
    for p in (entry, block):
        mode = p.cfar.scale_mode
        proc = pl.make_batch_processor(p, peak_group_radius=pgr,
                                       include_maps=False, device=dev)
        batch = torch.as_tensor(make_batch(p, BATCH), device=dev)
        F.reset_launch_counts()
        out = proc(batch)
        torch.cuda.synchronize()
        launches[mode] = (F.range_fft.launches, F.slowtime_detect.launches)
        log(f"main path {mode}: launches range_fft={launches[mode][0]} "
            f"slowtime_detect={launches[mode][1]}")
        if min(launches[mode]) < 1:
            raise AssertionError(f"main path {mode} skipped a kernel")
        for key in ("range_bin", "doppler_bin", "mag", "valid"):
            if tuple(out[key].shape) != (BATCH, p.tracker.max_dets):
                raise AssertionError(f"{key} shape {tuple(out[key].shape)}")
        if not bool(torch.isfinite(out["mag"]).all()):
            raise AssertionError("non-finite detection magnitudes")
        if int(out["nonfinite_count"].sum()) != 0:
            raise AssertionError("non-finite cells in the magnitude map")
        ref = pl.make_processor(p, peak_group_radius=pgr, frontend="plain",
                                include_debug=True, device=dev)(batch[0])
        ok, report = parity.margin_gate(
            parity.detection_set(out, 0), parity.detection_set(ref),
            ref["mag_map"].cpu().numpy(), ref["threshold_map"].cpu().numpy(),
            ref["scale_map"].cpu().numpy(), radius=pgr,
            capacity=p.tracker.max_dets,
            targets=reference.golden_targets(p))
        log(f"main path {mode} frame 0 vs plain path: {report}")
        if not ok:
            raise AssertionError(f"main path {mode}: margin gate failed")
        frames_per_s[mode] = BATCH * 1e3 / cuda_ms(lambda: proc(batch), 10)
        log(f"main path {mode}: {frames_per_s[mode]:.1f} frames/s at batch "
            f"{BATCH} ({card})")

    # 5. Tracker over 6 scans of two moving targets: each ends in a firm
    #    track at its last position.
    proc = pl.make_batch_processor(entry, peak_group_radius=pgr,
                                   include_maps=False, device=dev)
    moves = [(100, 5.0, 1), (500, -10.0, -1)]
    scans = np.stack([pl.complex_to_iq(reference.two_target_frame(
        entry, seed=s, targets=[(r + v * s, d, a) for (r, d, v), a
                                in zip(moves, (8000.0, 5000.0))]))
        for s in range(6)])
    out = proc(torch.as_tensor(scans, device=dev))
    state = trk.init_state(entry.tracker, device=dev)
    for s in range(6):
        state, rep = trk.step(state, out["range_bin"][s],
                              out["doppler_bin"][s], out["mag"][s],
                              out["valid"][s], tp=entry.tracker)
    firm = ((state["status"] == FIRM) & (state["active"] == 1)).cpu().numpy()
    pos = (state["range_pos"] >> 2).cpu().numpy()
    for r, _, v in moves:
        if not any(firm & (np.abs(pos - (r + 5 * v)) <= 3)):
            raise AssertionError(f"tracker: no firm track at range {r + 5 * v}")
    log(f"tracker: {int(firm.sum())} firm tracks ({int(rep['active_tracks'])} "
        f"active) after 6 scans, both targets held")

    # 6. Kernel timings at batch 128 (CUDA events), with bounds.
    batch = torch.as_tensor(make_batch(entry, BATCH), device=dev)
    nd, nr = entry.n_doppler, entry.n_range
    ms_a = cuda_ms(lambda: F.range_fft(batch))
    plain_a = cuda_ms(lambda: F.range_fft_plain(batch), 5)
    win = torch.as_tensor(hamming_float(nr), device=dev)
    zw = torch.complex(batch[..., 0].float() * win, batch[..., 1].float() * win)
    lib_a = cuda_ms(lambda: torch.fft.fft(zw, dim=-1))
    b_a, by_a = bound_range_fft(BATCH, nd, nr)
    results["range_fft"].update(ms=ms_a, plain_ms=plain_a, library_ms=lib_a,
                                bound_ms=b_a, bound_by=by_a)
    log(f"range_fft: {ms_a:.4f} ms, plain {plain_a:.4f} ms, torch.fft.fft "
        f"{lib_a:.4f} ms, bound {b_a:.4f} ms ({by_a}) at batch {BATCH} "
        f"({card})")
    re, im = F.range_fft(batch)
    stages = {}
    for p in (entry, block):
        name = f"slowtime_detect[{p.cfar.scale_mode}]"
        kw = dict(cfar=p.cfar, peak_group_radius=pgr)
        ms_b = cuda_ms(lambda: F.slowtime_detect(re, im, False, 0, **kw))
        plain_b = cuda_ms(
            lambda: F.slowtime_detect_plain(re, im, False, 0, **kw), 2, 1)
        b_b, by_b = bound_slowtime(BATCH, nr, nd, p.cfar)
        results[name].update(ms=ms_b, plain_ms=plain_b, library_ms=None,
                             bound_ms=b_b, bound_by=by_b)
        log(f"{name}: {ms_b:.4f} ms, plain {plain_b:.4f} ms, bound "
            f"{b_b:.4f} ms ({by_b}) at batch {BATCH} ({card})")
        det, _, row_max, n_dets, _ = F.slowtime_detect(re, im, False, 0, **kw)
        topk_ms = cuda_ms(lambda: DET.topk_detections(
            det, p.tracker.max_dets, row_max=row_max, n_dets=n_dets))
        stages[p.cfar.scale_mode] = {
            "range_fft_ms": ms_a, "slowtime_detect_ms": ms_b,
            "topk_ms": topk_ms,
            "path_ms": BATCH * 1e3 / frames_per_s[p.cfar.scale_mode]}
        log(f"main path {p.cfar.scale_mode} per batch of {BATCH}: "
            + ", ".join(f"{k} {v:.4f}"
                        for k, v in stages[p.cfar.scale_mode].items()))

    # 7-11. Fixed mode: kernels, main path, timings.
    fixed_rows, fixed_summary = fixed_mode(card, dev)

    # 12. The kernels line.
    replaces = "fmcw_tpu/ops/frontend_pallas.py:623"
    rows = [dict(name="range_fft", route="cuda",
                 source="fmcw_tpu_torch/csrc/range_fft.cu",
                 replaces=replaces,
                 launches=launches["cell"][0] + launches["block"][0],
                 **results["range_fft"])]
    for mode in ("cell", "block"):
        rows.append(dict(name=f"slowtime_detect[{mode}]", route="cuda",
                         source="fmcw_tpu_torch/csrc/slowtime_detect.cu",
                         replaces=replaces, launches=launches[mode][1],
                         **results[f"slowtime_detect[{mode}]"]))
    rows += fixed_rows
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows],
                    "frames_per_s": frames_per_s, "stages_ms": stages,
                    "fixed": fixed_summary, "batch": BATCH,
                    "card": card}))
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
