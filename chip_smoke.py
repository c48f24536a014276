#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fmcw_tpu_torch) on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py

It builds the CUDA kernels from fmcw_tpu_torch/csrc/ (into build/), holds
each kernel against its plain PyTorch twin on the card, drives the main path
(int16 frames -> detections, batch 128 at 1024x128, the reference-exact
per-cell scale and the block scale of fast()) through the processor a user
calls, checks its detections against the plain path with the margin gate of
fmcw_tpu_torch/parity.py, runs the tracker over 6 scans, and times the
kernels and the path with CUDA events.  It prints the card's name and power
limit, one JSON line listing the kernels, and as its last line
{"ok": true, "device": {...}}.  Any failed check raises, and the script then
exits non-zero; without CUDA it exits non-zero at once.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12     # FP32 outside the tensor cores, dense
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
    (per-cell scale: box sums, mean, 2 hi/lo and 1 detection compare-add
    per training cell; block scale: the detection compare-adds).  Peak
    grouping (only on CFAR-passing cells) is left out."""
    cells = B * nr * nd
    nbytes = cells * 8 + nd * nd * 8 + cells * 4 + B * nr * 4 + B * 8
    if cfar.scale_mode == "cell":
        gw = (2 * cfar.guard_range + 1) * (2 * cfar.guard_doppler + 1)
        cfar_ops = (cfar.win_range * cfar.win_doppler + gw + 4
                    + 6 * cfar.n_ref + 8)
    else:
        cfar_ops = 2 * cfar.n_ref + 16
    ops = cells * (8 * nd + 4 + cfar_ops)
    return _bound(nbytes, ops)


def _bound(nbytes: float, ops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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

    # 7. The kernels line.
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
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows],
                    "frames_per_s": frames_per_s, "stages_ms": stages,
                    "batch": BATCH,
                    "card": card}))
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
