#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fmcw_tpu_torch) on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py
    python3 chip_smoke.py --nccl-only   # with 2+ GPUs: the NCCL mesh alone

It builds the CUDA kernels from fmcw_tpu_torch/csrc/ (into build/; the two
range kernels, both slow-time kernels, the rank-select CFAR and the 3D
CFAR's variants of the repository's windows without spills), holds each
kernel against its plain PyTorch
twin on the card (kernel A and the fixed range kernel also at every size
they take: n_range 16..1024 with 8, 40 and 128 chirps, both entries of
each; kernel B at n_doppler 16..128, both scale modes, notch 2 and 3,
both transients, the bypass, the override and grouping radii 0..2, and on
a tie-heavy stimulus whose training values equal their thresholds), drives
the float32 main path (int16 frames ->
detections, batch 128 at 1024x128, the reference-exact per-cell scale and
the block scale of fast()) through the processor a user calls, checks its
detections against the plain path with the margin gate of
fmcw_tpu_torch/parity.py, runs the tracker over 6 scans, and times the
kernels and the path with CUDA events (kernel B's entries and the range
kernels by CUDA-graph replay, eager beside them).  Then the same for
fixed mode (the reference's 16-bit chain): its two kernels against their
twins (0 values differing), the standalone CFAR kernel (TPU rows 7 and 8)
and its grouping entry against their twins bit for bit (int32 and float32
maps, adversarial maps, int32 values beyond 2^24, a prepadded shard, odd
map heights, training sets over 4094 cells, a run-time window, strips of
one cell), the slow-time kernel and its split entry on exact round-half
ties at eighth-turn Doppler bins against the golden numpy model, its main
path on both routes (staged: plain stages and the CFAR kernel's grouping
entry; fused: the two fixed-point kernels) at batch 128, the golden
frame's detections against the golden numpy model, the float staged route
against its twin, and the kernels' timings.  Then the array-radar model (8 elements, 8 beams,
1024x128, batches of 16 cubes = 128 beam maps): the float-input and
magnitude-only entry points of the front-end kernels, the angle-extended
3D CFAR kernel (TPU row 10; float32 and int32 cubes, adversarial cubes of
NaN, Inf, -0.0, ties and out-of-range keys, training sets over 4094 cells,
every tile geometry) and the cross-beam grouping kernel against their
twins, at full width and at small shapes; three configurations through
make_batch_array_processor (per-cell and block scale with per-beam and
cross-beam grouping; the 3D CFAR at ref_angle 1), each checked with the
array gate against the plain path; stage and kernel timings.  Then the
sharded frame processor (fmcw_tpu_torch/parallel/): the split entries of
the front-end kernels (TPU rows 3-6: the range kernels on chirp shards,
kernel B and its fixed twin on range shards with exchanged halo rows) at
full width, sp 2 and 4, the shards of each frame one after another on
this card, each bit-equal to the matching part of the whole-frame kernel
and held against its plain twin; make_sharded_processor on a LocalMesh
(collectives by slicing) equal to the single-card path bit for bit; the
shards' kernel timings; and, with two or more GPUs, the NCCL mesh
(torch.multiprocessing, one rank per GPU; the frame and the array
processors) equal to the single GPU.  Then TPU kernel row 9, the rank-select
CFAR behind the debug taps (csrc/cfar_rank.cu), bit-equal to its twin on 8
frames (float 31 and 16 key bits, int32, override, a given block scale map,
a prepadded range shard, four windows, adversarial maps of NaN, Inf, -0.0,
negative, tied and out-of-range keys), and its grouping entry bit-equal to
the twin's rank select, peak grouping, row maxima and counts; the debug-tap
processors at batch 128 (float per-cell and block on the fused and staged
routes, fixed on auto) through the grouping entry with no plain grouping,
against the twin, the plain grouping's outputs, the margin gate and the
golden model; the sharded debug taps on a LocalMesh against the single
card; row 9's timings beside its bound and its earlier compare-add bound;
the sharded array
model's kernel entries (the prepadded 3D CFAR, the global-ids beam grouping)
against the whole-cube kernels, and make_sharded_array_processor on a
LocalMesh (sp 2 and 4) equal to the single card, with cubes/s; the
cross-beam grouping kernel (TPU row 11, csrc/beam_group.cu) on its edge
cases bit for bit against its twin (radius 0-3 and 5, 1, 3 and 8 beams, D
128, 130 and 6, an unaligned cube, 37 rows, ties and non-finite values;
shards at sp 2 and 4 and one across the cube's end), both its entries timed by graph replay.  Then the
surveillance runtime (fmcw_tpu_torch/runtime/) at 1024x128 on 48 scenario
scans, 16 a batch: fixed mode's kernel route with logs byte-identical to
its plain route, the float main path holding the targets in firm tracks,
a run resumed from a checkpoint with logs byte-identical to the unbroken
one, the array model, stream and stream_batched (block and drop) against a
plain loop, and scans/s with the frame-batch / tracker split.  Then the
hw-compat streaming CFAR (cfar_geometry="hw_stream", phase 27): the
flat-stream entry of csrc/cfar_detect.cu (TPU row 7 with
prepadded_range="both") against its twin bit for bit (int32 and float32
maps, the one-shot, first-frame and carried framings, the full, QUICK and
zero-halo windows, override 0 and 3, adversarial, zero and end-spike
maps), make_batch_processor(cfar_geometry="hw_stream") at batch 128 (fixed
"auto" against the golden model frame by frame, float "fused" against the
twin), run_surveillance_stream over 48 fixed-mode CPIs read through the
port's FileFrameStreamer (kernel and plain routes and a resumed run
logging byte-identically, firm tracks), and timings.  It prints
the card's name and power limit, one JSON line listing the kernels, and as
its last line {"ok": true, "device": {...}}.  Any failed check raises,
and the script then exits non-zero; without CUDA it exits non-zero at
once.
"""

from __future__ import annotations

import dataclasses
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


def graph_ms(fn, iters: int = 20) -> float:
    """Device time of fn() in ms: one call captured in a CUDA graph and
    replayed ``iters`` times (CUDA events), so that the host's per-call
    overhead, which back-to-back calls of a kernel of a few tens of
    microseconds cannot hide, is not counted.  Used for the range kernels'
    entries and their torch.fft.fft and copy yardsticks."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters)


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


RANGE_SIZES = tuple(1 << k for k in range(4, 11))   # n_range 16 .. 1024
RANGE_CHIRPS = (8, 40, 128)     # 1, 5 (ragged) and 16 groups of 8 chirps


def range_fft_size_checks(dev):
    """Phase 2b: kernel A at every size it takes — n_range 16..1024, nd 8,
    40 and 128, batch 2 — both entries (int16 I/Q and float planes) within
    TOL of the peak of their twins, on seeded full-scale noise.  Logs the
    resident blocks per SM at n = 1024."""
    import numpy as np
    import torch
    from fmcw_tpu_torch import kernels
    from fmcw_tpu_torch.ops import frontend as F
    lib = kernels.load()
    occ = [lib.fmcw_range_fft_blocks_per_sm(f) for f in (0, 1)]
    log(f"kernel A n=1024: {occ[0]} (int16) / {occ[1]} (float) resident "
        f"blocks of 256 threads per SM")
    rng = np.random.default_rng(5)
    for n in RANGE_SIZES:
        rel = 0.0
        for nd in RANGE_CHIRPS:
            iq = torch.as_tensor(rng.integers(-32768, 32768, (2, nd, n, 2),
                                              dtype=np.int16), device=dev)
            planes = torch.as_tensor(rng.standard_normal((2, 2, nd, n)) * 1e3,
                                     dtype=torch.float32, device=dev)
            for got, want in ((F.range_fft(iq), F.range_fft_plain(iq)),
                              (F.range_fft_float(*planes),
                               F.range_fft_float_plain(*planes))):
                torch.cuda.synchronize()
                peak = float(torch.maximum(want[0].abs().max(),
                                           want[1].abs().max()))
                err = float(torch.maximum((got[0] - want[0]).abs().max(),
                                          (got[1] - want[1]).abs().max()))
                rel = max(rel, err / peak)
                if not err <= TOL * peak:
                    raise AssertionError(f"range_fft at n={n} nd={nd}: err "
                                         f"{err / peak:.3g} of peak")
        log(f"kernel A n={n} nd {RANGE_CHIRPS} batch 2, int16 and float: "
            f"worst err {rel:.3g} of peak (tol {TOL})")


NO_SPILL_SOURCES = (" range_fft.cu", " range_fft_fixed.cu",
                    " slowtime_detect.cu", " slowtime_detect_fixed.cu",
                    " cfar_rank.cu")
# cfar_3d_detect.cu's variants of the repository's windows (strips of 8,
# the (6, 2) and (3, 1) walks unrolled, hi and lo packed; float, int32).
NO_SPILL_ENTRIES = tuple(f"cfar3d_detect_kernelI{v}Li8ELi{hr}ELi{gr}ELb1E"
                         for v in "fi" for hr, gr in ((6, 2), (3, 1)))
# cfar_detect.cu's variants of the repository's windows, likewise, and the
# flat-stream entry's crossed default window (5, 1).
NO_SPILL_ENTRIES += tuple(f"cfar_detect_kernelI{v}Li8ELi{hr}ELi{gr}ELb1E"
                          for v in "fi" for hr, gr in ((6, 2), (3, 1), (5, 1)))


def log_build(info) -> None:
    """The compiler's register and spill lines of every kernel, with the
    entry names; fails if an instantiation of the two range kernels
    (kernel A and the fixed one), kernel B, the fixed slow-time kernel or
    the rank-select CFAR, or a variant of the 3D CFAR or of the standalone
    CFAR that the repository's windows run, spills or keeps an array in
    local memory (a stack frame)."""
    section, entry, bad = "", "", []
    for line in info.log.splitlines():
        if line.startswith("---"):
            section, entry = line, ""
        if "Compiling entry" in line:
            entry = line.split("'")[1] if "'" in line else line
        checked = (section.endswith(NO_SPILL_SOURCES)
                   or any(e in entry for e in NO_SPILL_ENTRIES))
        if ("registers" in line or "spill" in line
                or "Compiling entry" in line or line.startswith("---")):
            log(f"  {line.strip()}")
        if (checked and "spill" in line
                and "0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                    "spill loads" not in line):
            bad.append(f"{section[4:]} {entry}: {line.strip()}")
    if bad:
        raise AssertionError(f"kernel spills: {bad}")


def bound_range_fft(B: int, nd: int, nr: int):
    """Least time for kernel A: each int16 I/Q sample read once, re/im
    written once; 5 n log2 n flops per chirp FFT plus the window."""
    nbytes = B * nd * nr * 4 + B * nr * nd * 8
    ops = B * nd * (5 * nr * math.log2(nr) + 2 * nr)
    return _bound(nbytes, ops)


def _slowtime_ops(B: int, nr: int, nd: int) -> float:
    """FP32 operations of the float slow-time step and magnitude: an FFT,
    5 nd log2 nd per range row, plus MTI (8), window (2) and magnitude (4)
    per cell."""
    return B * nr * (5 * nd * math.log2(nd) + 14 * nd)


def bound_slowtime(B: int, nr: int, nd: int, cfar):
    """Least time for kernel B: re/im read once, det and row maxima written
    once; the slow-time step (``_slowtime_ops``) and the CFAR's adds and
    compares per cell (``_cfar_ops``).  Peak grouping (only on CFAR-passing
    cells) is left out."""
    cells = B * nr * nd
    nbytes = cells * 8 + cells * 4 + B * nr * 4 + B * 8
    ops = _slowtime_ops(B, nr, nd) + cells * _cfar_ops(cfar)
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
    window (10) and magnitude (6) per cell (INT32); the CFAR's compare-adds
    per cell (FP32: the kernel counts the integer magnitudes in float, as
    kernel B counts its map).  Peak grouping is left out."""
    cells = B * nr * nd
    nbytes = cells * 4 + cells * 4 + B * nr * 4 + B * 8
    fp64 = B * nr * (5 * nd * math.log2(nd) + 10 * nd)
    return _bound(nbytes, cells * _cfar_ops(cfar), cells * 24, fp64)


def bound_cfar_detect(B: int, nr: int, nd: int, cfar, in_float: bool,
                      group: bool = False):
    """Least time for cfar_detect: the map read once (and the scale map in
    block mode), det and scale written once (the grouping entry: and its
    row maxima and counts); the CFAR's compare-adds per cell at the FP32
    rate where the kernel counts in float (float maps, and int32 maps
    within ops/cfar_detect.float_max, as this run's data decides), else at
    the INT32 rate.  Peak grouping is left out."""
    cells = B * nr * nd
    nbytes = cells * (12 + (4 if cfar.scale_mode == "block" else 0))
    if group:
        nbytes += B * nr * 4 + B * 4
    ops = cells * _cfar_ops(cfar)
    return _bound(nbytes, ops if in_float else 0, 0 if in_float else ops)


def fset_floor_cfar_detect(B: int, nr: int, nd: int, cfar) -> float:
    """The floor of cfar_detect.cu's design in ms: one FSET (or integer
    compare) on the integer pipe per training value and cell for each
    compare — 3 with the per-cell scale (hi, lo, the decision), 1 with a
    scale map — at the INT32 rate."""
    per = 3 if cfar.scale_mode == "cell" else 1
    return B * nr * nd * per * cfar.n_ref / H100_INT32_OPS_PER_S * 1e3


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
    twins at batch 128, 1024x128: quantized range values and magnitudes
    equal (0 values differ: the kernels' FP64 FFTs and the twins' dense
    FP64 products both quantize to the golden model's values, the
    eighth-turn bins exact in both), saturation counts exact, the decision
    bit-identical to the plain integer CFAR and grouping on the kernel's
    own magnitudes; range_fft_fixed also equal to the golden numpy model
    on this batch and on seed 6's; then at 256x64 the numeric options
    (3-pulse MTI, passthrough, biased rounding) and a CFAR window outside
    the unrolled walks on saturating frames.  Returns ({row:
    max_abs_err}, the range planes)."""
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
    if n_off or not torch.equal(sat, psat):
        raise AssertionError("range_fft_fixed disagrees with its plain twin")
    errs["range_fft_fixed"] = float(err)
    # The golden numpy model itself, on this batch and on seed 6's, whose
    # frame 90 holds a round-half tie at the eighth-turn bin 7n/8 (the
    # sqrt(2)/2 terms of its sum cancel): the kernel computes those bins
    # exactly, the twin's dense product need not.
    for seed, frames in ((3, iq), (6, None)):
        if frames is None:
            frames = torch.as_tensor(make_batch(P.RadarParams(), BATCH,
                                                seed=seed), device=dev)
        got = FX.range_fft_fixed(frames)
        twin = FX.range_fft_fixed_plain(frames)
        want = golden_range(frames.cpu().numpy())
        off = [int(sum((x[k].cpu().numpy() != want[k]).sum() for k in (0, 1)))
               for x in (got, twin)]
        log(f"range_fft_fixed batch seed {seed} vs the golden model: kernel "
            f"{off[0]}, plain twin {off[1]} of {2 * got[0].numel()} values "
            f"differ")
        if off[0]:
            raise AssertionError("range_fft_fixed differs from the golden "
                                 "model")
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
                if n_off or not torch.equal(sat_d, psat_d) or not same:
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
    off_b = int((mag != pmag).sum())
    same = (torch.equal(det, d2) and torch.equal(rmax, r2)
            and torch.equal(ndet, n2) and torch.equal(s1, ps1)
            and torch.equal(s2, ps2))
    log(f"fixed kernels at 256x64 notch 3 {kw}: range {err_a} LSB, mag "
        f"{err_b} LSB ({off_b} differ), saturation and decision "
        f"{'exact' if same else 'DIFFER'}")
    if err_a > 1 or off_b or not same:
        raise AssertionError("fixed kernels disagree at 256x64 notch 3")
    # A window outside the unrolled walks (13 x 23 cells), on the
    # saturating stimulus: the slow-time kernel against its twin.
    p = P.RadarParams(n_range=256, n_doppler=64, cfar=P.CfarParams(
        ref_range=6, guard_range=2, ref_doppler=9, guard_doppler=2))
    sre, sim, _ = FX.range_fft_fixed(torch.as_tensor(hot_batch(p, 8),
                                                     device=dev))
    det, mag, rmax, ndet, s2 = FX.slowtime_detect_fixed(
        sre, sim, cfar=p.cfar, peak_group_radius=pgr, emit_mag=True)
    pmag, ps2 = FX.slowtime_mag_fixed_plain(sre, sim)
    d2, r2, n2, _ = F.detect_plain(mag, p.cfar, 0, pgr)
    torch.cuda.synchronize()
    off_b = int((mag != pmag).sum())
    same = (torch.equal(det, d2) and torch.equal(rmax, r2)
            and torch.equal(ndet, n2) and torch.equal(s2, ps2))
    log(f"slowtime_detect_fixed at 256x64, 13x23 window, x40 frames: mag "
        f"{off_b} differ, saturation {int(s2.sum())} and decision "
        f"{'exact' if same else 'DIFFER'}, n_dets "
        f"{int(ndet.min())}..{int(ndet.max())}")
    if off_b or not same:
        raise AssertionError("slowtime_detect_fixed disagrees with its twin "
                             "on the wide window")
    return errs, (re, im)


def golden_range(iq, rounding: str = "unbiased"):
    """The golden numpy model's range stage of int16 frames (B, nd, n, 2):
    Q15 window, bfp_fft along range, transposed to range-major int16."""
    import numpy as np
    from fmcw_tpu_torch.golden import fixed_point as gfx
    coef = gfx.hamming_coeffs(iq.shape[-2])
    i_w, q_w, _ = gfx.window_apply(iq[..., 0], iq[..., 1], coef, 16, rounding)
    re, im = gfx.bfp_fft(i_w, q_w, axis=-1)
    return (np.ascontiguousarray(re.transpose(0, 2, 1)).astype(np.int16),
            np.ascontiguousarray(im.transpose(0, 2, 1)).astype(np.int16))


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


def range_fft_fixed_size_checks(dev):
    """Phase 7c: the fixed range kernel at every size it takes — n_range
    16..1024, nd 8, 40 and 128, batch 2, both window roundings — through
    both entries (range_fft_fixed on the frames, the row 4 chirp-shard
    entry on their first half where that is whole groups of 8), on seeded
    full-scale noise and on the saturating x40 stimulus: the quantized
    values equal the plain twin's (0 values differ) and the saturation
    counts are exact."""
    import numpy as np
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.ops import frontend_fixed as FX
    from fmcw_tpu_torch.ops import split_frontend as SF
    rng = np.random.default_rng(8)
    for n in RANGE_SIZES:
        checked = 0
        for nd in RANGE_CHIRPS:
            hot = hot_batch(P.RadarParams(n_range=n, n_doppler=nd), 2)
            for stim in (rng.integers(-32768, 32768, (2, nd, n, 2),
                                      dtype=np.int16), hot):
                iq = torch.as_tensor(stim, device=dev)
                half = iq[:, :nd // 2] if nd // 2 % 8 == 0 else iq
                for rounding in ("unbiased", "biased"):
                    for entry, x in ((FX.range_fft_fixed, iq),
                                     (SF.range_frontend_fixed, half)):
                        got = entry(x, rounding=rounding)
                        want = FX.range_fft_fixed_plain(x, rounding=rounding)
                        torch.cuda.synchronize()
                        n_off = int((got[0] != want[0]).sum()
                                    + (got[1] != want[1]).sum())
                        checked += 2 * got[0].numel()
                        if n_off or not torch.equal(got[2], want[2]):
                            raise AssertionError(
                                f"{entry.__name__} at n={n} nd={nd} "
                                f"{rounding}: {n_off} values differ, "
                                f"saturation {got[2].tolist()} vs "
                                f"{want[2].tolist()}")
        log(f"range_fft_fixed n={n} nd {RANGE_CHIRPS} batch 2, both entries, "
            f"noise and x40, both roundings: 0 of {checked} values differ, "
            f"saturation exact")


def eighth_ties(re, im, rounding: str = "unbiased"):
    """``golden.reference.eighth_turn_ties`` of int16 planes (B, R, nd),
    windowed with the MTI bypassed: boolean (B, R) arrays of the rows that
    hold an eighth-turn tie, and of those whose sqrt(2)/2 terms are not 0
    each."""
    import numpy as np
    from fmcw_tpu_torch.golden import fixed_point as gfx, reference
    nd = re.shape[-1]
    i_w, q_w, _ = gfx.window_apply(re.astype(np.int64), im.astype(np.int64),
                                   gfx.hamming_coeffs(nd), 16, rounding)
    return reference.eighth_turn_ties(i_w, q_w)


def fixed_tie_checks(dev):
    """Phase 7d: the fixed slow-time kernel and its split entry (sp 2 and 4,
    neighbour halo rows sliced from the frame) on exact round-half ties at
    eighth-turn Doppler bins, the MTI bypassed, against the port's golden
    numpy model: magnitudes and detections equal (0 values differ), each
    shard bit-equal to the whole-frame launch's rows.  Range-major planes
    at 256x128 whose bin 16 ties in every row, its sqrt(2)/2 terms
    cancelling without being 0 (golden.reference.doppler_eighth_tie_planes,
    8 frames); the chirp-axis tie frames at 64x32 (doppler_eighth_tie_frames,
    16 frames: the generator's chirp constants keep each range-bin-0 sum
    below 2^15 only for short frames and few chirps) through the fixed range
    kernel first.  Grouping radius 0, as the golden model."""
    import numpy as np
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.golden import reference
    from fmcw_tpu_torch.models import pipeline as pl
    from fmcw_tpu_torch.ops import frontend_fixed as FX
    from fmcw_tpu_torch.ops import split_frontend as SF
    p = P.RadarParams(n_range=256, n_doppler=128)
    re, im = reference.doppler_eighth_tie_planes(11, 8, 256, 128)
    gold = [reference.process_rows_fixed(a.astype(np.int64),
                                         b.astype(np.int64), p,
                                         mti_bypass=True)
            for a, b in zip(re, im)]
    cases = [("planes 256x128", p, torch.as_tensor(re, device=dev),
              torch.as_tensor(im, device=dev), gold)]
    q = P.RadarParams(n_range=64, n_doppler=32)
    frames = reference.doppler_eighth_tie_frames(q, 16)
    iq = torch.as_tensor(np.stack([pl.complex_to_iq(z) for z in frames]),
                         device=dev)
    fre, fim, _ = FX.range_fft_fixed(iq)
    cases.append(("frames 64x32", q, fre, fim,
                  [reference.process_frame_fixed(z, q, mti_bypass=True)
                   for z in frames]))
    for name, p, re, im, gold in cases:
        tie, live = eighth_ties(re.cpu().numpy(), im.cpu().numpy())
        # Every row of the planes ties with terms not 0 each; every frame
        # has a tie row (its range bin 0).
        tied = live.all() if name.startswith("planes") else \
            tie.any(-1).all()
        det, mag, _, ndet, _ = FX.slowtime_detect_fixed(
            re, im, True, 0, cfar=p.cfar, emit_mag=True)
        torch.cuda.synchronize()
        off_m = int((mag.cpu().numpy() != np.stack([g[0] for g in gold]))
                    .sum())
        off_d = int((det.cpu().numpy() != np.stack([g[1] for g in gold]))
                    .sum())
        nr, h = p.n_range, p.cfar.halo_range
        same = True
        for sp in SPLIT_SPS:
            nrl = nr // sp
            for s in range(sp):
                rows = slice(s * nrl, (s + 1) * nrl)
                ext = torch.arange(s * nrl - h, (s + 1) * nrl + h,
                                   device=dev) % nr
                lo, hi = ext[:h], ext[h + nrl:]
                d_s, m_s, _, _, _ = SF.slowtime_detect_fixed_split(
                    re[:, rows], im[:, rows], (re[:, lo], im[:, lo]),
                    (re[:, hi], im[:, hi]), True, 0, s * nrl, cfar=p.cfar,
                    n_range_total=nr, emit_mag=True)
                same &= (torch.equal(d_s, det[:, rows])
                         and torch.equal(m_s, mag[:, rows]))
        torch.cuda.synchronize()
        log(f"eighth-turn ties, {name}: {int(tie.sum())} tie rows "
            f"({int(live.sum())} with sqrt(2)/2 terms not 0 each) of "
            f"{tie.size}; slowtime_detect_fixed vs the "
            f"golden model: {off_m} magnitudes, {off_d} detections differ "
            f"({int(ndet.sum())} detections); split sp {SPLIT_SPS} "
            f"{'bit-equal' if same else 'DIFFER'}")
        if off_m or off_d or not same or not tied:
            raise AssertionError(f"slowtime_detect_fixed on the eighth-turn "
                                 f"ties ({name}) differs from the golden "
                                 f"model or its split entry, or the "
                                 f"stimulus does not tie")


def bits_equal(a, b) -> bool:
    """Bit-identical tensors (float32 by their bit patterns)."""
    import torch
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return a.dtype == b.dtype and torch.equal(a, b)


def detect_case(what: str, mag, so: int, cfar, scale_map=None,
                pgrs=(2,), prepadded: bool = False) -> float:
    """cfar_detect on one batch of maps against its twin (det and scale),
    and its grouping entry for each radius of ``pgrs`` against the twin's
    grouping (det, scale, row maxima, counts): bit for bit, or raises.
    Returns the largest |difference| (0)."""
    import torch
    from fmcw_tpu_torch.ops import cfar_detect as CD
    kw = dict(cfar=cfar, scale_map=scale_map)
    pairs = [(CD.cfar_detect(mag, so, prepadded_range=prepadded, **kw),
              CD.cfar_detect_plain(mag, so, prepadded_range=prepadded,
                                   **kw))]
    for pgr in () if prepadded else pgrs:
        pairs.append((CD.cfar_detect_group(mag, so, peak_group_radius=pgr,
                                           **kw),
                      CD.cfar_detect_group_plain(mag, so,
                                                 peak_group_radius=pgr,
                                                 **kw)))
    torch.cuda.synchronize()
    same = all(bits_equal(a, b) for got, want in pairs
               for a, b in zip(got, want))
    err = max(float((a.double() - b.double()).nan_to_num().abs().max())
              for got, want in pairs for a, b in zip(got, want))
    ndet = int((pairs[0][0][0] > 0).sum())
    log(f"cfar_detect {what} {tuple(mag.shape)} {mag.dtype} "
        f"{cfar.scale_mode} so={so}{' prepadded' if prepadded else ''}, "
        f"grouping radius {list(pgrs) if not prepadded else '-'}: "
        f"{'bit-identical' if same else 'DIFFERS'} ({ndet} detections)")
    if not same:
        raise AssertionError(f"cfar_detect ({what}) disagrees with its twin")
    return err


def cfar_kernel_checks(dev, planes):
    """Phase 8: cfar_detect (TPU rows 7 and 8) and its grouping entry
    against their twins (ops/cfar.cfar_2d; then peak_group, the row maxima
    and counts): det, scale, row_max and n_dets bit-identical, both scale
    modes, scale_override 0 and 4, on int32 maps (the fixed chain's, which
    count in float) and float32 maps (the float staged chain's) at batch
    128; adversarial maps (golden.reference.rank_adversarial_maps: NaN,
    Inf, -0.0, ties, int32 keys up to +-2^31), int32 maps with values
    beyond 2^24 in some tiles (those count in int), a prepadded range
    shard (also against the whole map's rows), 37, 6 and 100 rows (a last
    block past R), a training set over 4094 cells, a window outside the
    unrolled walks (hr 4, gr 1) and a map too wide for strips of 8.
    Returns ({row: largest |difference|}, the int32 and float32
    magnitudes)."""
    import dataclasses
    import numpy as np
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.golden.reference import rank_adversarial_maps
    from fmcw_tpu_torch.models import pipeline as pl
    from fmcw_tpu_torch.ops import cfar as C, cfar_detect as CD
    from fmcw_tpu_torch.ops import frontend_fixed as FX
    imag, _ = FX.slowtime_mag_fixed_plain(*planes)
    iq = torch.as_tensor(make_batch(P.RadarParams(), BATCH, seed=5),
                         device=dev)
    fmag = pl.make_batch_processor(frontend="staged", include_maps=True,
                                   device=dev)(iq)["mag_map"]
    errs = {}
    for mag, tag in ((imag, ""), (fmag, ",float32")):
        for p in (P.RadarParams(), P.fast()):
            mode = p.cfar.scale_mode
            for so in (0, 4):
                err = detect_case("main-path maps", mag, so, p.cfar,
                                  pgrs=(0, 1, 2) if so == 0 else (2,))
                for name in (f"cfar_detect[{mode}{tag}]",
                             f"cfar_detect_group[{mode}{tag}]"):
                    errs[name] = max(errs.get(name, 0.0), err)
    gen = np.random.default_rng(8)

    def noise(shape, integer):
        m = gen.exponential(500.0, shape)
        m[..., 3:5, 7:9] = 4e4
        return torch.as_tensor(m.astype(np.int32 if integer else np.float32),
                               device=dev)

    def smap_of(shape, cfar):
        return torch.as_tensor(gen.choice(
            [cfar.scale_min, cfar.scale_nom, cfar.scale_max], shape).astype(
                np.int32), device=dev)

    full = P.RadarParams().cfar
    # n_ref = 65 x 65 - 9 = 4216 > 4094: hi and lo in two counts.
    large = P.CfarParams(ref_range=31, ref_doppler=31, guard_range=1,
                         guard_doppler=1)
    runtime = P.CfarParams(ref_range=3, ref_doppler=2, guard_range=1,
                           guard_doppler=2)
    big = imag[:8].clone()                  # rows 500..503 beyond 2^24
    big[:, 500:504] = big[:, 500:504] * 1000 + (1 << 25)
    for integer in (False, True):
        adv = torch.as_tensor(rank_adversarial_maps((8, 1024, 128), integer,
                                                    13), device=dev)
        cases = [("adversarial", adv, full)]
        if integer:
            cases.append(("int32 beyond 2^24", big, full))
        for R in (37, 6, 100):
            cases.append((f"{R} rows", noise((8, R, 128), integer), full))
        cases += [("n_ref 4216", noise((4, 64, 64), integer), large),
                  ("hr 4 gr 1", noise((8, 256, 64), integer), runtime)]
        # 2048 columns: 8 rows do not fit (the grouping entry takes
        # radius 0 there; radius 2's tile does not fit at all).
        wide = ("strips of one cell", noise((2, 64, 2048), integer), full)
        for what, mag, cfar in cases + [wide]:
            for mode in ("cell", "block"):
                c = dataclasses.replace(cfar, scale_mode=mode)
                smap = smap_of(mag.shape, c) if mode == "block" else None
                for so in (0, 4):
                    detect_case(what, mag, so, c, smap,
                                pgrs=(0,) if mag.shape[-1] == 2048 else (2,))
    # A prepadded sp 4 range shard (rows 256..511 and their halo rows),
    # per-cell and with the block scale map's rows, against the twin and
    # the whole map's rows.
    hr = full.halo_range
    ext = torch.arange(256 - hr, 512 + hr, device=dev) % 1024
    for mag in (imag, fmag):
        shard = mag[:, ext].contiguous()
        for p in (P.RadarParams(), P.fast()):
            smap = (C.block_scale_map(mag, p.cfar)[:, 256:512].contiguous()
                    if p.cfar.scale_mode == "block" else None)
            for so in (0, 4):
                detect_case("sp 4 shard", shard, so, p.cfar, smap,
                            prepadded=True)
                whole = CD.cfar_detect(mag, so, cfar=p.cfar)
                part = CD.cfar_detect(shard, so, cfar=p.cfar, scale_map=smap,
                                      prepadded_range=True)
                if not all(bits_equal(a[:, 256:512], b)
                           for a, b in zip(whole, part)):
                    raise AssertionError("prepadded cfar_detect differs from "
                                         "the whole map's rows")
    return errs, imag, fmag


def fixed_main_path(card: str, dev):
    """Phase 9: make_batch_processor(p, mode="fixed") for RadarParams() and
    fast(), peak_group_radius 0 and 2, frontend "auto" (staged: the plain
    stages and cfar_detect's grouping entry, no plain peak_group) and
    "fused", at batch 128: the kernels each route launches, the detections
    of the
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
                need = (("cfar_detect_group",) if fe == "auto"
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


def staged_float_path(card: str, dev, pgr: int):
    """Phase 9b: the float staged route, make_batch_processor(p,
    frontend="staged") for RadarParams() and fast() at batch 128 with
    peak_group_radius 2: the plain float transforms, then cfar_detect's
    grouping entry (no plain peak_group); its det map and detections
    against the twin's CFAR, grouping and top-K on the route's own
    magnitudes, bit for bit; frames/s.  Returns (launches, frames/s)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch import kernels
    from fmcw_tpu_torch.models import pipeline as pl
    from fmcw_tpu_torch.ops import cfar_detect as CD, detect as DET
    launches, fps = {}, {}
    for p in (P.RadarParams(), P.fast()):
        mode = p.cfar.scale_mode
        batch = torch.as_tensor(make_batch(p, BATCH, seed=6), device=dev)
        proc = pl.make_batch_processor(p, frontend="staged",
                                       peak_group_radius=pgr, device=dev)
        kernels.reset_launch_counts()
        out = proc(batch)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        log(f"float staged {mode}: launches "
            + ", ".join(f"{k}={v}" for k, v in counts.items() if v))
        if counts["cfar_detect_group"] < 1 or counts["cfar_detect"]:
            raise AssertionError("float staged route: not through the "
                                 "grouping entry")
        launches[f"cfar_detect_group[{mode},float32]"] = counts[
            "cfar_detect_group"]
        det, _, rmax, ndet = CD.cfar_detect_group_plain(
            out["mag_map"], cfar=p.cfar, peak_group_radius=pgr)
        want = DET.topk_detections(det, p.tracker.max_dets, row_max=rmax,
                                   n_dets=ndet)
        same = bits_equal(out["det_map"], det) and all(
            bits_equal(out[k], want[k]) for k in want)
        log(f"float staged {mode}: det map and detections "
            f"{'bit-identical' if same else 'DIFFER'} to the twin's CFAR, "
            f"grouping and top-K on the route's magnitudes "
            f"({int(ndet.sum())} detections)")
        if not same:
            raise AssertionError(f"float staged {mode} differs from its twin")
        lean = pl.make_batch_processor(p, frontend="staged",
                                       peak_group_radius=pgr,
                                       include_maps=False, device=dev)
        fps[mode] = BATCH * 1e3 / cuda_ms(lambda: lean(batch), 10)
        log(f"float staged {mode}: {fps[mode]:.1f} frames/s at batch "
            f"{BATCH} ({card})")
    return launches, fps


def fixed_mode(card: str, dev):
    """Phases 7-11 (fixed mode; 9b the float staged route); returns (kernel
    rows, summary)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.ops import cfar as C, cfar_detect as CD
    from fmcw_tpu_torch.ops import detect as DET, frontend_fixed as FX
    from fmcw_tpu_torch.ops.window import hamming_q15, window_apply_fixed
    pgr = 2
    errs, planes = fixed_kernel_checks(dev, pgr)
    saturation_check(dev)
    range_fft_fixed_size_checks(dev)
    fixed_tie_checks(dev)
    cerrs, imag, fmag = cfar_kernel_checks(dev, planes)
    launches, fps, report = fixed_main_path(card, dev)
    staged_launches, staged_fps = staged_float_path(card, dev, pgr)
    launches.update(staged_launches)

    # 10. Timings at batch 128 (CUDA events), with bounds.
    entry = P.RadarParams()
    nd, nr = entry.n_doppler, entry.n_range
    batch = torch.as_tensor(make_batch(entry, BATCH), device=dev)
    rows, times = [], {}
    # Device times by CUDA-graph replay (kernel A's rows are timed so);
    # the eager back-to-back time beside it.
    ms = graph_ms(lambda: FX.range_fft_fixed(batch))
    eager = cuda_ms(lambda: FX.range_fft_fixed(batch))
    plain = cuda_ms(lambda: FX.range_fft_fixed_plain(batch), 5)
    times.update({"range_fft_fixed": ms, "range_fft_fixed plain": plain})
    wi, wq, _ = window_apply_fixed(batch[..., 0], batch[..., 1],
                                   hamming_q15(nr)[None, :])
    zw = torch.complex(wi.double(), wq.double())     # the kernel's FP64
    lib = graph_ms(lambda: torch.fft.fft(zw, dim=-1))
    del zw, wi, wq
    # A memory-only yardstick that moves the kernel's bytes, itself a
    # corner turn: 4 bytes a sample read and written.
    turn = graph_ms(lambda: batch.transpose(1, 2).contiguous())
    bound, by = bound_range_fft_fixed(BATCH, nd, nr)
    log(f"range_fft_fixed: {ms:.4f} ms (graph; eager {eager:.4f}), plain "
        f"{plain:.4f} ms, torch.fft.fft complex128 {lib:.4f} ms, corner-turn "
        f"copy {turn:.4f} ms, bound {bound:.4f} ms ({by}) at batch {BATCH} "
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
    # The slow-time transform's share: torch.fft.fft of the same planes in
    # the kernel's FP64 (no PyTorch call computes the whole entry).
    zf = torch.complex(re.double(), im.double())
    fft_st = graph_ms(lambda: torch.fft.fft(zf, dim=-1))
    del zf
    st_eager = {}
    for p in (entry, P.fast()):
        mode = p.cfar.scale_mode
        name = f"slowtime_detect_fixed[{mode}]"
        kw = dict(cfar=p.cfar, peak_group_radius=pgr)
        ms = graph_ms(lambda: FX.slowtime_detect_fixed(re, im, False, 0, **kw))
        st_eager[mode] = cuda_ms(
            lambda: FX.slowtime_detect_fixed(re, im, False, 0, **kw))
        plain = cuda_ms(lambda: FX.slowtime_detect_fixed_plain(
            re, im, False, 0, **kw), 2, 1)
        bound, by = bound_slowtime_fixed(BATCH, nr, nd, p.cfar)
        log(f"{name}: {ms:.4f} ms (graph; eager {st_eager[mode]:.4f}), plain "
            f"{plain:.4f} ms, torch.fft.fft complex128 of its planes "
            f"{fft_st:.4f} ms, bound {bound:.4f} ms ({by}) at batch {BATCH} "
            f"({card})")
        times[name] = ms
        rows.append(dict(name=name, route="cuda",
                         source=src + "slowtime_detect_fixed.cu",
                         replaces="fmcw_tpu/ops/frontend_pallas.py:813",
                         launches=launches[name], max_abs_err=errs[name],
                         ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                         library_ms=None))
    # Rows 7 and 8 (cfar_detect) by graph replay, eager beside: int32 maps
    # (the fixed chain's: within float_max, so counted in float) and
    # float32 maps (the float staged chain's); the plain entry and the
    # grouping entry (radius 2, as the staged routes launch it).  Block
    # scale: the kernel alone, on a scale map computed beforehand (the
    # wrapper computes it with plain PyTorch passes when none is given;
    # timed separately below).
    cd_eager = {}
    for p, line in ((entry, 155), (P.fast(), 279)):
        mode = p.cfar.scale_mode
        for mag, tag in ((imag, ""), (fmag, ",float32")):
            smap = (C.block_scale_map(mag, p.cfar) if mode == "block"
                    else None)
            in_float = (mag.is_floating_point() or int(mag.abs().max())
                        <= CD.float_max(p.cfar))
            kw = dict(cfar=p.cfar, scale_map=smap)
            gkw = dict(kw, peak_group_radius=pgr)
            for entry_name, call, plain_call, group in (
                    ("cfar_detect",
                     lambda: CD.cfar_detect(mag, 0, **kw),
                     lambda: CD.cfar_detect_plain(mag, 0, **kw), False),
                    ("cfar_detect_group",
                     lambda: CD.cfar_detect_group(mag, 0, **gkw),
                     lambda: CD.cfar_detect_group_plain(mag, 0, **gkw),
                     True)):
                name = f"{entry_name}[{mode}{tag}]"
                ms = graph_ms(call)
                cd_eager[name] = cuda_ms(call)
                plain = cuda_ms(plain_call, 2, 1)
                bound, by = bound_cfar_detect(BATCH, nr, nd, p.cfar, in_float,
                                              group)
                int_bound, _ = bound_cfar_detect(BATCH, nr, nd, p.cfar, False,
                                                 group)
                floor = fset_floor_cfar_detect(BATCH, nr, nd, p.cfar)
                log(f"{name} ({mag.dtype} maps, counted in "
                    f"{'float' if in_float else 'int'}): {ms:.4f} ms "
                    f"(graph; eager {cd_eager[name]:.4f}), plain "
                    f"{plain:.4f} ms, bound {bound:.4f} ms ({by}; at the "
                    f"INT32 rate {int_bound:.4f}; the design's FSET floor "
                    f"{floor:.4f}) at batch {BATCH} ({card})")
                times[name] = ms
                rows.append(dict(name=name, route="cuda",
                                 source=src + "cfar_detect.cu",
                                 replaces=("fmcw_tpu/ops/cfar_pallas.py:"
                                           f"{line}"),
                                 launches=launches.get(name, 0),
                                 max_abs_err=cerrs[name], ms=ms,
                                 plain_ms=plain, bound_ms=bound, bound_by=by,
                                 library_ms=None))

    # 11. Where the time goes on each fixed route, per batch of 128, each
    #     stage timed alone.
    stages = {}
    for p in (entry, P.fast()):
        mode = p.cfar.scale_mode
        k = p.tracker.max_dets
        det, _, rmax, ndet, _ = FX.slowtime_detect_fixed(
            re, im, cfar=p.cfar, peak_group_radius=pgr)
        sdet, _, srmax, sndet = CD.cfar_detect_group(
            imag, 0, cfar=p.cfar, peak_group_radius=pgr)
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
                "cfar_detect_group_ms": times[f"cfar_detect_group[{mode}]"],
                "topk_ms": cuda_ms(lambda: DET.topk_detections(
                    sdet, k, row_max=srmax, n_dets=sndet)),
                "path_ms": BATCH * 1e3 / fps[f"{mode}/auto"]}}
        for route, st in stages[mode].items():
            log(f"fixed {route} {mode} per batch of {BATCH}: "
                + ", ".join(f"{key} {v:.4f}" for key, v in st.items()))
    return rows, {"frames_per_s": fps, "routes": report,
                  "float_staged_frames_per_s": staged_fps,
                  "stages_ms": stages,
                  "cfar_detect": {"graph_ms": {k: v for k, v in times.items()
                                               if k.startswith("cfar_detect")},
                                  "eager_ms": cd_eager},
                  "range_fft_fixed": {"graph_ms": times["range_fft_fixed"],
                                      "eager_ms": eager,
                                      "corner_turn_copy_ms": turn},
                  "slowtime_detect_fixed": {
                      "graph_ms": {m: times[f"slowtime_detect_fixed[{m}]"]
                                   for m in st_eager},
                      "eager_ms": st_eager, "fft_complex128_ms": fft_st}}


# ---------------------------------------------------------------------------
# The array-radar model
# ---------------------------------------------------------------------------

ARRAY_BATCH = 16                # cubes: 16 x 8 beams = 128 beam maps
N_ELEMS = N_BEAMS = 8
U0 = 0.3                        # the stimulus's steering sine


def make_cubes(p, batch: int, seed: int = 0, n_elems: int = N_ELEMS):
    """tools/array_bench.py's stimulus: on each element the golden
    two-target frame times exp(2j pi 0.5 e 0.3), plus seeded +-8 noise per
    cube, int16 (batch, n_elems, nd, nr, 2)."""
    import numpy as np
    from fmcw_tpu_torch.golden import reference
    from fmcw_tpu_torch.models import pipeline as pl
    rng = np.random.default_rng(seed)
    z = np.asarray(reference.two_target_frame(p, seed=3))
    elems = np.stack([pl.complex_to_iq(z * np.exp(2j * np.pi * 0.5 * e * U0))
                      for e in range(n_elems)])
    out = np.stack([elems] * batch)
    return out + rng.integers(-8, 8, out.shape).astype(np.int16)


def matched_beam(n_beams: int = N_BEAMS) -> int:
    import numpy as np
    u = np.linspace(-np.sin(np.deg2rad(60.0)), np.sin(np.deg2rad(60.0)),
                    n_beams)
    return int(np.argmin(np.abs(u - U0)))


def beam_planes(iq, n_beams: int = N_BEAMS):
    """Beamformed float32 planes of element-space cubes, each
    (batch * n_beams, nd, nr), as the array processor makes them."""
    import torch
    from fmcw_tpu_torch.ops import beamform as BF
    br, bi = BF.beamform(iq[..., 0].to(torch.float32),
                         iq[..., 1].to(torch.float32), n_beams, elem_dim=1)
    return br.flatten(0, 1), bi.flatten(0, 1)


def bound_range_fft_float(B: int, nd: int, nr: int):
    """Least time for kernel A on float planes: re/im read once (8 B per
    sample), the range-major re/im written once; the FFT as for int16."""
    nbytes = B * nd * nr * 8 + B * nr * nd * 8
    ops = B * nd * (5 * nr * math.log2(nr) + 2 * nr)
    return _bound(nbytes, ops)


def bound_slowtime_mag(B: int, nr: int, nd: int):
    """Least time for the magnitude-only kernel: re/im read once, the
    magnitudes and counts written once; the slow-time step
    (``_slowtime_ops``)."""
    cells = B * nr * nd
    return _bound(cells * 8 + cells * 4 + B * 4, _slowtime_ops(B, nr, nd))


def _cfar3d_ops(cfar, n_ref: int, n_planes: int, n_guard_planes: int):
    """The 3D CFAR's adds and compares per cell: separable running sums of
    the window box on each plane and of the guard box on each guard plane
    (4 adds each), the planes' sum, mean and thresholds (4), 3 compare-adds
    per training cell, the classification (8)."""
    return (4 * (n_planes + n_guard_planes) + n_planes + 4 + 6 * n_ref + 8)


def bound_cfar3d(cells: int, cfar, ref_angle: int, guard_angle: int,
                 integer: bool):
    """Least time for cfar_3d_detect: the cube read once, det and scale
    written once (12 B per cell); the CFAR's per-cell operations, INT32 for
    integer cubes, FP32 for float cubes."""
    from fmcw_tpu_torch.ops import cfar as C
    n_ref = len(C._offsets_3d(cfar, ref_angle, guard_angle))
    ops = cells * _cfar3d_ops(cfar, n_ref, 2 * (ref_angle + guard_angle) + 1,
                              2 * guard_angle + 1)
    return _bound(cells * 12, 0 if integer else ops, ops if integer else 0)


def bound_beam_group(B: int, NB: int, R: int, D: int, radius: int,
                     halo: int = 0):
    """Least time for beam_group: every input plane read once (a shard's NB
    own planes and its 2 halo halo planes), the grouped planes written
    once, the row maxima and counts written once; 2 radius + 2 compares per
    cell."""
    cells = B * NB * R * D
    return _bound(B * (NB + 2 * halo) * R * D * 4 + cells * 4
                  + B * NB * R * 4 + B * 4, cells * (2 * radius + 2))


def array_kernel_checks(dev):
    """Phase 12: the array model's kernels against their twins at full
    width (16 cubes, 8 beams, 1024x128): range_fft_float and slowtime_mag
    within TOL of the peak (non-finite counts equal); cfar3d_detect on the
    kernel path's own magnitude cube, and on that cube * 16 as int32,
    bit-identical to the plain cfar_3d for scale_override 0 and 4;
    beam_group bit-identical to the plain
    peak_group_beams (det, row maxima, counts) for radius 1 and 2, on real
    det cubes and on random sparse stacks with dense ties.  Returns
    ({row: max_abs_err}, the planes, the magnitude cube)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.ops import beam_group as BG, cfar3d_detect as C3
    from fmcw_tpu_torch.ops import frontend as F
    p = P.RadarParams()
    nr, nd = p.n_range, p.n_doppler
    errs = {}
    iq = torch.as_tensor(make_cubes(p, ARRAY_BATCH, seed=1), device=dev)
    br, bi = beam_planes(iq)
    re, im = F.range_fft_float(br, bi)
    pre, pim = F.range_fft_float_plain(br, bi)
    torch.cuda.synchronize()
    peak = float(torch.maximum(pre.abs().max(), pim.abs().max()))
    err = float(torch.maximum((re - pre).abs().max(), (im - pim).abs().max()))
    log(f"range_fft[float] vs plain: max abs err {err:.6g} = "
        f"{err / peak:.3g} of peak {peak:.6g} (tol {TOL})")
    if not err <= TOL * peak:
        raise AssertionError("range_fft_float disagrees with its plain twin")
    errs["range_fft[float]"] = err
    worst = 0.0
    for bypass in (True, False):        # the last, no bypass, is kept
        mag, nf = F.slowtime_mag(re, im, bypass)
        pmag = F.slowtime_mag_plain(re, im, bypass)
        pnf = (~torch.isfinite(pmag)).sum(dim=(-2, -1)).to(torch.int32)
        torch.cuda.synchronize()
        mpeak = float(pmag.abs().max())
        err = float((mag - pmag).abs().max())
        worst = max(worst, err)
        log(f"slowtime_mag bypass={bypass}: mag err {err / mpeak:.3g} of "
            f"peak, non-finite counts "
            f"{'equal' if torch.equal(nf, pnf) else 'DIFFER'}")
        if not err <= TOL * mpeak or not torch.equal(nf, pnf):
            raise AssertionError("slowtime_mag disagrees with its twin")
    errs["slowtime_mag"] = worst
    cube = mag.reshape(ARRAY_BATCH, N_BEAMS, nr, nd)
    worst = 0.0
    for so in (0, 4):
        det, scale = C3.cfar3d_detect(cube, so, cfar=p.cfar, ref_angle=1)
        d2, s2 = C3.cfar3d_detect_plain(cube, so, cfar=p.cfar, ref_angle=1)
        torch.cuda.synchronize()
        same = torch.equal(det, d2) and torch.equal(scale, s2)
        worst = max(worst, float((det - d2).abs().max()),
                    float((scale - s2).abs().max()))
        log(f"cfar_3d_detect ref_angle=1 so={so}: det and scale "
            f"{'bit-identical' if same else 'DIFFER'}, "
            f"{int((det > 0).sum())} detections")
        if not same:
            raise AssertionError("cfar3d_detect disagrees with cfar_3d")
    # The int32 cube at full width (phase 13's cube * 16: values up to the
    # int32 range, integer counts in the kernel).
    icube = (cube * 16).to(torch.int32)
    for so in (0, 4):
        det, scale = C3.cfar3d_detect(icube, so, cfar=p.cfar, ref_angle=1)
        d2, s2 = C3.cfar3d_detect_plain(icube, so, cfar=p.cfar, ref_angle=1)
        torch.cuda.synchronize()
        same = torch.equal(det, d2) and torch.equal(scale, s2)
        log(f"cfar_3d_detect int32 cube ref_angle=1 so={so}: det and scale "
            f"{'bit-identical' if same else 'DIFFER'}, "
            f"{int((det > 0).sum())} detections")
        if not same:
            raise AssertionError("cfar3d_detect disagrees with cfar_3d on "
                                 "an int32 cube")
    del icube, det, scale, d2, s2
    errs["cfar_3d_detect"] = worst
    det2d = F.slowtime_detect(re, im, cfar=p.cfar, peak_group_radius=2)[0]
    gen = torch.Generator(device=dev).manual_seed(7)
    shape = (ARRAY_BATCH, N_BEAMS, nr, nd)
    sparse = torch.where(
        torch.rand(shape, generator=gen, device=dev) < 0.05,
        torch.randint(1, 6, shape, generator=gen, device=dev).float(), 0.0)
    worst = 0.0
    for name, stack in (("real det cubes", det2d.reshape(shape)),
                        ("sparse ties", sparse)):
        for radius in (1, 2):
            out = BG.beam_group(stack, radius)
            want = BG.beam_group_plain(stack, radius)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(out, want))
            worst = max(worst, float((out[0] - want[0]).abs().max()),
                        float((out[1] - want[1]).abs().max()))
            log(f"beam_group {name} radius={radius}: "
                f"{'bit-identical' if same else 'DIFFERS'}, n_dets "
                f"{int(out[2].min())}..{int(out[2].max())} per cube")
            if not same:
                raise AssertionError("beam_group disagrees with its twin")
    errs["beam_group"] = worst
    beam_group_cases(dev)
    return errs, (br, bi, re, im), cube


def group_stimulus(shape, seed: int, kind: str):
    """Sparse float32 detection cubes (numpy): small integers, dense ties
    across beams; real magnitudes; or adversarial values (NaN, +-inf,
    -0.0, negatives) among ties."""
    import numpy as np
    rng = np.random.default_rng(seed)
    x = np.where(rng.random(shape) < 0.3, rng.integers(1, 4, shape),
                 0).astype(np.float32)
    if kind == "real":
        x = np.where(x > 0, rng.random(shape) * 1e4, 0).astype(np.float32)
    elif kind == "adversarial":
        bad = np.array([np.nan, np.inf, -np.inf, -0.0, -2.0, 3.0],
                       np.float32)
        pick = rng.random(shape) < 0.08
        x[pick] = bad[rng.integers(0, len(bad), int(pick.sum()))]
    return x


def group_bits_equal(got, want) -> bool:
    """beam_group's three outputs equal bit for bit (floats as int32)."""
    import torch
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               if a.dtype == torch.float32 else torch.equal(a, b)
               for a, b in zip(got, want))


def beam_group_cases(dev):
    """Phase 12b: csrc/beam_group.cu's shapes and edges against its twin,
    bit for bit: radius 0-3
    (the register window) and 5 (neighbours read directly); NB 1, 3 and 8;
    D 128 (float4), 130 and 6 (a cell a lane), an unaligned cube; R 37
    (not a multiple of the 8 rows a block takes); ties across beams; NaN,
    +-inf, -0.0 and negatives; batch 3."""
    import torch
    from fmcw_tpu_torch.ops import beam_group as BG
    cases = [(nb, d, r, kind) for nb, d, r, kind in (
        (8, 128, 0, "ties"), (8, 128, 1, "ties"), (8, 128, 2, "ties"),
        (8, 128, 3, "ties"), (8, 128, 5, "adversarial"),
        (8, 128, 2, "adversarial"), (8, 128, 1, "real"), (3, 128, 1, "ties"),
        (3, 130, 2, "ties"), (3, 6, 3, "adversarial"), (1, 128, 1, "ties"),
        (1, 6, 2, "ties"), (8, 130, 1, "real"), (8, 6, 2, "ties"))]
    n = 0
    for i, (nb, d, r, kind) in enumerate(cases):
        x = torch.as_tensor(group_stimulus((3, nb, 37, d), 100 + i, kind),
                            device=dev)
        for t in (x, torch.cat([x.new_zeros(1), x.flatten()])[1:]
                  .view(x.shape)):                # aligned, then not
            ok = group_bits_equal(BG.beam_group(t, r),
                                  BG.beam_group_plain(t, r))
            n += 1
            if not ok:
                raise AssertionError(
                    f"beam_group differs: NB {nb} D {d} radius {r} {kind} "
                    f"aligned={t.data_ptr() % 16 == 0}")
    torch.cuda.synchronize()
    log(f"beam_group cases: {n} cubes (radius 0-3 and 5, NB 1/3/8, D "
        f"128/130/6, R 37, ties and adversarial values, unaligned) "
        f"bit-identical to the twin")


def array_small_checks(dev):
    """Phase 13: the same kernels at small shapes — the quick CFAR at
    128x32, ref_angle 2 with guard_angle 1 at 256x64, 4 and 16 beams, and
    int32 cubes for the 3D CFAR; then the 3D CFAR's own cases
    (``cfar3d_cases``)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.ops import beam_group as BG, cfar3d_detect as C3
    from fmcw_tpu_torch.ops import frontend as F
    mid = P.RadarParams(n_range=256, n_doppler=64)
    cases = ((P.quick(), 8, 1, 0), (mid, 8, 2, 1), (mid, 4, 1, 0),
             (mid, 16, 1, 0), (mid, 16, 2, 1))
    for p, n_beams, ra, ga in cases:
        iq = torch.as_tensor(make_cubes(p, 4, seed=2), device=dev)
        br, bi = beam_planes(iq, n_beams)
        re, im = F.range_fft_float(br, bi)
        pre, pim = F.range_fft_float_plain(br, bi)
        mag, nf = F.slowtime_mag(re, im)
        pmag = F.slowtime_mag_plain(re, im, False)
        cube = mag.reshape(4, n_beams, p.n_range, p.n_doppler)
        ok = True
        for c in (cube, (cube * 16).to(torch.int32)):
            for so in (0, 4):
                a = C3.cfar3d_detect(c, so, cfar=p.cfar, ref_angle=ra,
                                     guard_angle=ga)
                b = C3.cfar3d_detect_plain(c, so, cfar=p.cfar, ref_angle=ra,
                                           guard_angle=ga)
                ok &= all(torch.equal(x, y) for x, y in zip(a, b))
        det = C3.cfar3d_detect(cube, cfar=p.cfar, ref_angle=ra,
                               guard_angle=ga)[0]
        for radius in (1, 2):
            ok &= all(torch.equal(x, y) for x, y in zip(
                BG.beam_group(det, radius), BG.beam_group_plain(det, radius)))
        torch.cuda.synchronize()
        err_a = float(torch.maximum((re - pre).abs().max(),
                                    (im - pim).abs().max()))
        peak_a = float(torch.maximum(pre.abs().max(), pim.abs().max()))
        err_b = float((mag - pmag).abs().max())
        log(f"array kernels at {p.n_range}x{p.n_doppler}, {n_beams} beams, "
            f"ref_angle={ra} guard_angle={ga}: A err {err_a / peak_a:.3g}, "
            f"mag err {err_b / float(pmag.max()):.3g} of peak; 3D CFAR "
            f"(float and int32, so 0/4) and grouping "
            f"{'bit-identical' if ok else 'DIFFER'}; "
            f"{int((det > 0).sum())} detections")
        if (not ok or not err_a <= TOL * peak_a
                or not err_b <= TOL * float(pmag.max())):
            raise AssertionError(f"array kernels disagree at {p.n_range}x"
                                 f"{p.n_doppler}, {n_beams} beams")
    cfar3d_cases(dev)


def noise_cube(shape, integer: bool, seed: int, flat: bool = False):
    """A seeded (B, A, R, D) cube: exponential noise with a band of bright
    cells, a plateau and strong cells; or (flat) values within 0.1% of one
    level with a few strong cells (every training value >= half the mean,
    lo = n_ref)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    if flat:
        m = 1000.0 + rng.random(shape)
    else:
        m = rng.exponential(500.0, shape)
        m[..., 5:9, :] *= np.where(rng.random(m[..., 5:9, :].shape) < 0.3,
                                   30.0, 1.0)
        m[..., 20:26, 2:9] = 700.0
    for f in m.reshape(-1, *shape[-2:]):
        f[rng.integers(0, shape[-2]), rng.integers(0, shape[-1])] = 3e4
    return np.round(m).astype(np.int32) if integer else m.astype(np.float32)


def cfar3d_cases(dev):
    """Phase 13, the 3D CFAR kernel's own cases, each float32 and int32,
    scale_override 0 and 4, det and scale bit for bit against the twin:
    adversarial cubes at full width (golden.reference.rank_adversarial_maps:
    NaN, +-Inf, -0.0, negative values, denormals, ties at the k-th value,
    int keys beyond 2^16 and down to -2^31) at ref_angle 1 and 2 / guard 1;
    training sets over 4094 cells (ref_angle 14 on 4 beams: n_ref 4132,
    hi and lo counted apart for float cubes); and the tile geometries —
    37 rows (one block, an overlapping last strip), 6 rows (a block past
    R), 100 rows (a last block past R), strips of one cell (ref_angle 8 at
    128 Doppler bins: 8 rows of 17 planes do not fit), a window walked at
    run time (hr 4, gr 1)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.golden.reference import rank_adversarial_maps
    from fmcw_tpu_torch.ops import cfar3d_detect as C3
    full = P.RadarParams().cfar
    quick = P.quick().cfar
    odd = P.CfarParams(ref_range=3, ref_doppler=2, guard_range=1,
                       guard_doppler=2)
    cases = []
    for integer in (False, True):
        adv = rank_adversarial_maps((4, N_BEAMS, 1024, 128), integer, 11)
        cases += [("adversarial 4x8x1024x128", adv, full, 1, 0),
                  ("adversarial 4x8x1024x128", adv, full, 2, 1)]
        for shape in ((2, 4, 32, 16), (2, 4, 256, 64)):
            for flat in (False, True):
                cases.append((f"n_ref>4094 {'flat' if flat else 'noise'} "
                              f"{'x'.join(map(str, shape))}",
                              noise_cube(shape, integer, 12, flat), full,
                              14, 0))
        cases += [("37 rows", noise_cube((2, 8, 37, 16), integer, 13),
                   full, 1, 0),
                  ("6 rows", noise_cube((2, 8, 6, 16), integer, 14),
                   quick, 1, 0),
                  ("100 rows", noise_cube((2, 8, 100, 128), integer, 15),
                   full, 1, 0),
                  ("strips of one cell", noise_cube((1, 8, 64, 128),
                                                    integer, 16), full, 8, 0),
                  ("window hr 4 gr 1", noise_cube((2, 8, 256, 64), integer,
                                                  17), odd, 2, 1)]
    for name, cube, cfar, ra, ga in cases:
        x = torch.as_tensor(cube, device=dev)
        cfg = C3.cfar3d_config(tuple(x.shape), cfar, ra, ga,
                               integer=x.dtype == torch.int32)
        ok, dets = True, 0
        for so in (0, 4):
            a = C3.cfar3d_detect(x, so, cfar=cfar, ref_angle=ra,
                                 guard_angle=ga)
            b = C3.cfar3d_detect_plain(x, so, cfar=cfar, ref_angle=ra,
                                       guard_angle=ga)
            ok &= all(torch.equal(u, v) for u, v in zip(a, b))
            dets += int((a[0] > 0).sum()) if so == 0 else 0
        torch.cuda.synchronize()
        log(f"cfar_3d_detect {name} {x.dtype} ref_angle={ra} "
            f"guard_angle={ga} (n_ref {cfg.n_ref}, T {cfg.T}, strip "
            f"{cfg.strip}, packed {cfg.packed}): so 0/4 "
            f"{'bit-identical' if ok else 'DIFFER'}, {dets} detections")
        if not ok:
            raise AssertionError(f"cfar3d_detect disagrees with cfar_3d: "
                                 f"{name} {x.dtype}")


ARRAY_CONFIGS = (
    # name, params, processor keywords, the kernels the route runs
    ("percell/grouped", "RadarParams",
     dict(peak_group_radius=2, beam_group_radius=1),
     ("range_fft_float", "slowtime_detect", "beam_group")),
    ("block/grouped", "fast",
     dict(peak_group_radius=2, beam_group_radius=1),
     ("range_fft_float", "slowtime_detect", "beam_group")),
    ("ref_angle1", "RadarParams", dict(ref_angle=1, guard_angle=0),
     ("range_fft_float", "slowtime_mag", "cfar3d_detect")),
)


def array_main_path(card: str, dev):
    """Phase 14: the three array configurations through
    make_batch_array_processor(..., include_maps=False) at 16 cubes: the
    kernels each launches, cube 0 against the plain path with the array
    gate (taps from the plain cfar_3d / cfar_2d with need_debug), no
    non-finite cells, the strongest detection at the matched beam, cubes/s.
    Returns (launches, cubes/s)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch import kernels, parity
    from fmcw_tpu_torch.golden import reference
    from fmcw_tpu_torch.models import pipeline as pl
    from fmcw_tpu_torch.ops import cfar as C
    launches, cubes_per_s = {}, {}
    beam = matched_beam()
    for name, preset, kw, need in ARRAY_CONFIGS:
        p = getattr(P, preset)()
        proc = pl.make_batch_array_processor(
            p, n_elems=N_ELEMS, n_beams=N_BEAMS, include_maps=False,
            device=dev, **kw)
        batch = torch.as_tensor(make_cubes(p, ARRAY_BATCH), device=dev)
        kernels.reset_launch_counts()
        out = proc(batch)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        log(f"array {name}: route {proc.route}, launches "
            + ", ".join(f"{k}={v}" for k, v in counts.items() if v))
        if proc.route != "fused" or any(counts[k] < 1 for k in need):
            raise AssertionError(f"array {name} skipped a kernel")
        for k in need:
            launches[k] = launches.get(k, 0) + counts[k]
        for key in ("range_bin", "doppler_bin", "mag", "valid", "beam_bin"):
            if tuple(out[key].shape) != (ARRAY_BATCH, p.tracker.max_dets):
                raise AssertionError(f"{key} shape {tuple(out[key].shape)}")
        if not bool(torch.isfinite(out["mag"]).all()):
            raise AssertionError("non-finite detection magnitudes")
        if int(out["nonfinite_count"].sum()) != 0:
            raise AssertionError("non-finite cells in the magnitude cubes")
        if not bool((out["beam_bin"][:, 0] == beam).all()):
            raise AssertionError(f"array {name}: strongest detection off "
                                 f"the matched beam {beam}")
        ref = pl.make_array_processor(p, n_elems=N_ELEMS, n_beams=N_BEAMS,
                                      frontend="plain", device=dev,
                                      **kw)(batch[0])
        M = ref["mag_cube"]
        _, T, S = C.cfar_3d(M, 0, p.cfar, kw.get("ref_angle", 0),
                            kw.get("guard_angle", 0), need_debug=True)
        ok, report = parity.array_gate(
            parity.array_set(out, 0), parity.array_set(ref),
            M.cpu().numpy(), T.cpu().numpy(), S.cpu().numpy(),
            radius=kw.get("peak_group_radius", 0),
            beam_radius=kw.get("beam_group_radius", 0),
            targets=reference.golden_targets(p), target_beam=beam,
            capacity=p.tracker.max_dets)
        del T, S
        log(f"array {name} cube 0 vs plain path: {report}")
        if not ok:
            raise AssertionError(f"array {name}: array gate failed")
        cubes_per_s[name] = ARRAY_BATCH * 1e3 / cuda_ms(lambda: proc(batch),
                                                        10)
        log(f"array {name}: {cubes_per_s[name]:.1f} cubes/s = "
            f"{cubes_per_s[name] * N_BEAMS:.1f} beam maps/s at "
            f"{ARRAY_BATCH} cubes ({card})")
    return launches, cubes_per_s


def array_model(card: str, dev):
    """Phases 12-15 (the array model); returns (kernel rows, summary)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.ops import beam_group as BG, cfar3d_detect as C3
    from fmcw_tpu_torch.ops import detect as DET, frontend as F
    from fmcw_tpu_torch.ops.window import hamming_float
    errs, (br, bi, re, im), cube = array_kernel_checks(dev)
    array_small_checks(dev)
    launches, cubes_per_s = array_main_path(card, dev)

    # 15. Kernel and stage timings per batch of 16 cubes (CUDA events).
    p = P.RadarParams()
    nr, nd = p.n_range, p.n_doppler
    B = ARRAY_BATCH * N_BEAMS
    src = "fmcw_tpu_torch/csrc/"
    rows, t = [], {}
    iq = torch.as_tensor(make_cubes(p, ARRAY_BATCH), device=dev)
    t["beamform"] = cuda_ms(lambda: beam_planes(iq))
    ms = graph_ms(lambda: F.range_fft_float(br, bi))
    plain = cuda_ms(lambda: F.range_fft_float_plain(br, bi), 5)
    win = torch.as_tensor(hamming_float(nr), device=dev)
    zw = torch.complex(br * win, bi * win)
    lib = graph_ms(lambda: torch.fft.fft(zw, dim=-1))
    del zw
    bound, by = bound_range_fft_float(B, nd, nr)
    t["range_fft_float"] = ms
    log(f"range_fft[float]: {ms:.4f} ms, plain {plain:.4f} ms, torch.fft.fft "
        f"{lib:.4f} ms, bound {bound:.4f} ms ({by}) at {B} beam maps "
        f"({card})")
    rows.append(dict(name="range_fft[float]", route="cuda",
                     source=src + "range_fft.cu",
                     replaces="fmcw_tpu/ops/frontend_pallas.py:623",
                     launches=launches["range_fft_float"],
                     max_abs_err=errs["range_fft[float]"], ms=ms,
                     plain_ms=plain, bound_ms=bound, bound_by=by,
                     library_ms=lib))
    ms = graph_ms(lambda: F.slowtime_mag(re, im))
    eager = cuda_ms(lambda: F.slowtime_mag(re, im))
    plain = cuda_ms(lambda: F.slowtime_mag_plain(re, im, False), 5)
    bound, by = bound_slowtime_mag(B, nr, nd)
    t["slowtime_mag"] = ms
    log(f"slowtime_mag: {ms:.4f} ms (graph; eager {eager:.4f}), plain "
        f"{plain:.4f} ms, bound {bound:.4f} ms ({by}) at {B} beam maps "
        f"({card})")
    rows.append(dict(name="slowtime_mag", route="cuda",
                     source=src + "slowtime_detect.cu",
                     replaces="fmcw_tpu/ops/frontend_pallas.py:623",
                     launches=launches["slowtime_mag"],
                     max_abs_err=errs["slowtime_mag"], ms=ms, plain_ms=plain,
                     bound_ms=bound, bound_by=by, library_ms=None))
    ms = graph_ms(lambda: C3.cfar3d_detect(cube, cfar=p.cfar, ref_angle=1))
    eager = cuda_ms(lambda: C3.cfar3d_detect(cube, cfar=p.cfar, ref_angle=1))
    plain = cuda_ms(lambda: C3.cfar3d_detect_plain(cube, cfar=p.cfar,
                                                   ref_angle=1), 2, 1)
    bound, by = bound_cfar3d(cube.numel(), p.cfar, 1, 0, False)
    t["cfar_3d_detect"] = ms
    icube = (cube * 16).to(torch.int32)
    t["cfar_3d_detect_int32"] = graph_ms(
        lambda: C3.cfar3d_detect(icube, cfar=p.cfar, ref_angle=1))
    del icube
    log(f"cfar_3d_detect: {ms:.4f} ms (graph; eager {eager:.4f}; int32 cube "
        f"{t['cfar_3d_detect_int32']:.4f}), plain {plain:.4f} ms, bound "
        f"{bound:.4f} ms ({by}) at {B} beam maps ({card})")
    rows.append(dict(name="cfar_3d_detect", route="cuda",
                     source=src + "cfar_3d_detect.cu",
                     replaces="fmcw_tpu/ops/cfar_pallas.py:569",
                     launches=launches["cfar3d_detect"],
                     max_abs_err=errs["cfar_3d_detect"], ms=ms,
                     plain_ms=plain, bound_ms=bound, bound_by=by,
                     library_ms=None))
    det3d = C3.cfar3d_detect(cube, cfar=p.cfar, ref_angle=1)[0]
    t["topk_3d"] = cuda_ms(lambda: DET.topk_detections(
        det3d.reshape(ARRAY_BATCH, N_BEAMS * nr, nd), p.tracker.max_dets))
    shape = (ARRAY_BATCH, N_BEAMS, nr, nd)
    dets = {}
    for q in (p, P.fast()):
        mode = q.cfar.scale_mode
        t[f"slowtime_detect[{mode}]"] = cuda_ms(lambda: F.slowtime_detect(
            re, im, cfar=q.cfar, peak_group_radius=2))
        det = dets[mode] = F.slowtime_detect(
            re, im, cfar=q.cfar, peak_group_radius=2)[0].reshape(shape)
        t[f"beam_group[{mode}]"] = graph_ms(lambda: BG.beam_group(det, 1))
        t[f"beam_group_eager[{mode}]"] = cuda_ms(
            lambda: BG.beam_group(det, 1))
        g, rmax, ndet = BG.beam_group(det, 1)
        t[f"topk[{mode}]"] = cuda_ms(lambda: DET.topk_detections(
            g.reshape(ARRAY_BATCH, N_BEAMS * nr, nd), p.tracker.max_dets,
            row_max=rmax, n_dets=ndet))
    plain = cuda_ms(lambda: BG.beam_group_plain(dets["cell"], 1), 5)
    bound, by = bound_beam_group(ARRAY_BATCH, N_BEAMS, nr, nd, 1)
    ms = t["beam_group[cell]"]
    log(f"beam_group: {ms:.4f} ms (graph; eager "
        f"{t['beam_group_eager[cell]']:.4f}), plain {plain:.4f} ms, bound "
        f"{bound:.4f} ms ({by}) at {B} beam maps ({card})")
    rows.append(dict(name="beam_group", route="cuda",
                     source=src + "beam_group.cu",
                     replaces="fmcw_tpu/ops/cfar_pallas.py:824",
                     launches=launches["beam_group"],
                     max_abs_err=errs["beam_group"], ms=ms, plain_ms=plain,
                     bound_ms=bound, bound_by=by, library_ms=None))
    stages = {}
    for name, _, _, _ in ARRAY_CONFIGS:
        st = {"beamform_ms": t["beamform"],
              "range_fft_float_ms": t["range_fft_float"]}
        if name == "ref_angle1":
            st.update(slowtime_mag_ms=t["slowtime_mag"],
                      cfar_3d_detect_ms=t["cfar_3d_detect"],
                      topk_ms=t["topk_3d"])
        else:
            mode = "cell" if name.startswith("percell") else "block"
            st.update(slowtime_detect_ms=t[f"slowtime_detect[{mode}]"],
                      beam_group_ms=t[f"beam_group[{mode}]"],
                      topk_ms=t[f"topk[{mode}]"])
        st["path_ms"] = ARRAY_BATCH * 1e3 / cubes_per_s[name]
        stages[name] = st
        log(f"array {name} per batch of {ARRAY_BATCH} cubes: "
            + ", ".join(f"{k} {v:.4f}" for k, v in st.items()))
    return rows, {"cubes_per_s": cubes_per_s,
                  "beam_maps_per_s": {k: v * N_BEAMS
                                      for k, v in cubes_per_s.items()},
                  "stages_ms": stages,
                  "cfar_3d_detect_int32_ms": t["cfar_3d_detect_int32"],
                  "cubes": ARRAY_BATCH,
                  "beams": N_BEAMS}


# ---------------------------------------------------------------------------
# The sharded frame processor
# ---------------------------------------------------------------------------

SPLIT_SPS = (2, 4)


def seam_batch(p, batch: int):
    """A saturating frame whose energy sits on the top range bin, the seam
    of the range shards' ring (tests/test_split_frontend.py:98-118: a
    near-full-scale tone whose Doppler ramp the MTI notch passes), plus
    hot_batch's x40 golden frames: Doppler-window saturations in halo
    rows."""
    import numpy as np
    from fmcw_tpu_torch.models import pipeline as pl
    nr, nd = p.n_range, p.n_doppler
    n = np.arange(nr)[None, :]
    c = np.arange(nd)[:, None]
    z = 32000.0 * np.exp(2j * np.pi * ((nr - 1) * n / nr + 0.23 * c))
    tone = pl.complex_to_iq(z.astype(np.complex64))[None]
    return np.concatenate([tone, hot_batch(p, batch - 1)])


def bound_slowtime_split(B: int, nrl: int, nd: int, h: int, cfar):
    """Least time for kernel B's split entry on a range shard: its rows and
    the 2h halo rows read once, det and row maxima written once; the
    slow-time step on all nrl + 2h rows (the halo rows' magnitudes feed the
    CFAR windows) and the CFAR per cell of the shard."""
    cells = B * nrl * nd
    nbytes = B * (nrl + 2 * h) * nd * 8 + cells * 4 + B * nrl * 4 + B * 8
    ops = _slowtime_ops(B, nrl + 2 * h, nd) + cells * _cfar_ops(cfar)
    return _bound(nbytes, ops)


def bound_slowtime_fixed_split(B: int, nrl: int, nd: int, h: int, cfar):
    """Least time for the fixed split entry: int16 rows and halo rows read
    once, det and row maxima written once; FFT and BFP (FP64) and MTI,
    window and magnitude (INT32) on all nrl + 2h rows, the CFAR on the
    shard's cells (FP32, as ``bound_slowtime_fixed``)."""
    rows = B * (nrl + 2 * h)
    cells = B * nrl * nd
    nbytes = rows * nd * 4 + cells * 4 + B * nrl * 4 + B * 8
    fp64 = rows * (5 * nd * math.log2(nd) + 10 * nd)
    return _bound(nbytes, cells * _cfar_ops(cfar), rows * nd * 24, fp64)


def split_kernel_checks(dev, pgr: int):
    """Phase 16: TPU rows 3-6 at full width (batch 128, 1024x128, sp 2 and
    4), the sp shards of each frame one after another on this card.  Each
    shard's range kernel (float and fixed) bit-equal to the matching
    columns of the whole-frame launch, the shards' saturation counts summing
    to the frame's; each shard's split kernel B (float and fixed, mti_bypass
    off and on, scale_override 0 and 4), fed the neighbour halo rows sliced
    from the frame, bit-equal to the matching rows of the whole-frame
    kernel (det, mag, row maxima) with counts summing to the frame's; the
    shards' top-K merged in shard order equal to the frame's top-K; each
    entry against its plain twin (magnitudes within TOL, fixed ones equal,
    the decision bit for bit on the kernel's magnitudes).  The fixed checks
    also run on seam_batch.  Returns ({row: max_abs_err}, the inputs)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.ops import detect as DET, frontend as F
    from fmcw_tpu_torch.ops import frontend_fixed as FX
    from fmcw_tpu_torch.ops import split_frontend as SF
    p = P.RadarParams()
    nr, nd = p.n_range, p.n_doppler
    K = p.tracker.max_dets
    h = p.cfar.halo_range + pgr
    errs = {"range_frontend": 0.0, "range_frontend_fixed": 0.0,
            "slowtime_detect_split": 0.0, "slowtime_detect_fixed_split": 0.0}
    iq = torch.as_tensor(make_batch(p, BATCH, seed=6), device=dev)
    seam = torch.as_tensor(seam_batch(p, 8), device=dev)
    for fixed, frames in ((False, iq), (True, iq), (True, seam)):
        name = "fixed" if fixed else "float"
        if fixed:
            re, im, sat_r = FX.range_fft_fixed(frames)
        else:
            re, im = F.range_fft(frames)
        for bypass, so in ((False, 0), (True, 4)):
            kw = dict(cfar=p.cfar, peak_group_radius=pgr, emit_mag=True)
            if fixed:
                det, mag, rmax, ndet, stat = FX.slowtime_detect_fixed(
                    re, im, bypass, so, **kw)
                stat = stat + sat_r
            else:
                det, mag, rmax, ndet, stat = F.slowtime_detect(
                    re, im, bypass, so, **kw)
            whole = DET.topk_detections(det, K, row_max=rmax, n_dets=ndet)
            if frames is seam and not bypass and int(stat.min()) <= 0:
                raise AssertionError("the seam batch does not saturate")
            for sp in SPLIT_SPS:
                ndc, nrl = nd // sp, nr // sp
                same, parts = True, []
                stat_sum = ndet_sum = 0
                for s in range(sp):
                    # Row 3 / 4: the chirp shard against the frame's columns.
                    cols = slice(s * ndc, (s + 1) * ndc)
                    if fixed:
                        a_re, a_im, a_sat = SF.range_frontend_fixed(
                            frames[:, cols])
                        stat_sum = stat_sum + a_sat
                    else:
                        a_re, a_im = SF.range_frontend(frames[:, cols])
                    same &= (torch.equal(a_re, re[..., cols])
                             and torch.equal(a_im, im[..., cols]))
                    # Row 5 / 6: the range shard with neighbour halo rows.
                    rows = slice(s * nrl, (s + 1) * nrl)
                    ext = torch.arange(s * nrl - h, (s + 1) * nrl + h,
                                       device=dev) % nr
                    lo, hi = ext[:h], ext[h + nrl:]
                    args = (re[:, rows], im[:, rows], (re[:, lo], im[:, lo]),
                            (re[:, hi], im[:, hi]), bypass, so, s * nrl)
                    skw = dict(cfar=p.cfar, n_range_total=nr,
                               peak_group_radius=pgr, emit_mag=True)
                    if fixed:
                        out = SF.slowtime_detect_fixed_split(*args, **skw)
                        twin = SF.slowtime_detect_fixed_split_plain(*args,
                                                                    **skw)
                    else:
                        out = SF.slowtime_detect_split(*args, **skw)
                        twin = SF.slowtime_detect_split_plain(*args, **skw)
                    d_s, m_s, r_s, n_s, st_s = out
                    same &= (torch.equal(d_s, det[:, rows])
                             and torch.equal(m_s, mag[:, rows])
                             and torch.equal(r_s, rmax[:, rows]))
                    stat_sum = stat_sum + st_s
                    ndet_sum = ndet_sum + n_s
                    # The twin: magnitudes by tolerance, the decision bit for
                    # bit on the kernel's own (whole-frame, equal) magnitudes.
                    d2, r2, n2 = SF.detect_halo_plain(mag[:, ext], p.cfar,
                                                      so, pgr, s * nrl, nr)
                    torch.cuda.synchronize()
                    twin_ok = (torch.equal(d_s, d2) and torch.equal(r_s, r2)
                               and torch.equal(n_s, n2)
                               and torch.equal(st_s, twin[4]))
                    merr = float((m_s.double() - twin[1].double()).abs().max())
                    mpeak = float(twin[1].abs().max())
                    key = ("slowtime_detect_fixed_split" if fixed
                           else "slowtime_detect_split")
                    errs[key] = max(errs[key], merr)
                    if not twin_ok or merr > (0 if fixed else TOL * mpeak):
                        raise AssertionError(
                            f"{key} sp={sp} shard {s} disagrees with its "
                            f"plain twin (mag err {merr:g})")
                    loc = DET.topk_detections(d_s, K, row_max=r_s, n_dets=n_s)
                    loc["range_bin"] = loc["range_bin"] + s * nrl
                    parts.append(loc)
                vals, idx = DET.top_k(torch.cat([q["mag"] for q in parts],
                                                dim=-1), K)
                merged = {"mag": vals, "n_dets": ndet_sum,
                          **{k: torch.gather(torch.cat(
                              [q[k] for q in parts], dim=-1), -1, idx)
                             for k in ("range_bin", "doppler_bin")}}
                same_k = all(torch.equal(merged[k], whole[k]) for k in merged)
                same_stat = torch.equal(stat_sum, stat)
                torch.cuda.synchronize()
                log(f"split {name} {'seam' if frames is seam else 'batch'} "
                    f"sp={sp} bypass={bypass} so={so}: shards "
                    f"{'bit-equal' if same else 'DIFFER'} to the whole-frame "
                    f"kernels, merged top-K {'equal' if same_k else 'DIFFERS'}"
                    f", {'saturation' if fixed else 'non-finite'} counts "
                    f"{int(stat_sum.sum())} vs {int(stat.sum())}, n_dets "
                    f"{int(ndet.min())}..{int(ndet.max())}")
                if not (same and same_k and same_stat):
                    raise AssertionError(f"split {name} sp={sp} differs from "
                                         f"the whole-frame kernels")
    # Rows 3 / 4 against their twins (the range kernels' columns equal the
    # whole-frame launch's, checked above, which phase 2 / 7 hold against
    # the same twins): the shard's own twin once more.
    for s in range(2):
        chirps = iq[:, s * nd // 2:(s + 1) * nd // 2]
        a = SF.range_frontend(chirps)
        b = F.range_fft_plain(chirps)
        peak = float(torch.maximum(b[0].abs().max(), b[1].abs().max()))
        err = float(torch.maximum((a[0] - b[0]).abs().max(),
                                  (a[1] - b[1]).abs().max()))
        errs["range_frontend"] = max(errs["range_frontend"], err)
        fa = SF.range_frontend_fixed(chirps)
        fb = FX.range_fft_fixed_plain(chirps)
        ferr = int(torch.maximum((fa[0].int() - fb[0].int()).abs().max(),
                                 (fa[1].int() - fb[1].int()).abs().max()))
        errs["range_frontend_fixed"] = max(errs["range_frontend_fixed"], ferr)
        torch.cuda.synchronize()
        if err > TOL * peak or ferr > 1 or not torch.equal(fa[2], fb[2]):
            raise AssertionError("range_frontend(_fixed) disagrees with its "
                                 "plain twin")
    log(f"split entries vs plain twins: {errs}")
    return errs, iq


def split_main_path(card: str, dev, pgr: int):
    """Phase 17: make_sharded_processor on a LocalMesh (the sp shards of each
    frame one after another on this card, the all-to-all and the halo
    exchange done by slicing) at batch 128, for sp 2 and 4: float per-cell
    (kernel A on chirp shards, kernel B's split entry), float block (kernel
    A, the magnitude-only kernel, block_scale_map_sharded, cfar_detect on
    prepadded shards), fixed (the fixed range kernel and the fixed split
    kernel B); the kernels each launches, all detection outputs bit-equal
    to the single-card fused processor, frames/s.  Returns (launches,
    frames/s)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch import kernels
    from fmcw_tpu_torch.models import pipeline as pl
    from fmcw_tpu_torch.parallel import mesh as M, sharded as SH
    configs = (
        ("float/cell", P.RadarParams(), "float32",
         ("range_frontend", "slowtime_detect_split")),
        ("float/block", P.fast(), "float32",
         ("range_frontend", "slowtime_mag", "cfar_detect")),
        ("fixed/cell", P.RadarParams(), "fixed",
         ("range_frontend_fixed", "slowtime_detect_fixed_split")))
    launches, fps = {}, {}
    for name, p, mode, need in configs:
        batch = torch.as_tensor(make_batch(p, BATCH, seed=7), device=dev)
        kw = dict(mode=mode, frontend="fused", peak_group_radius=pgr,
                  include_maps=False)
        ref = pl.make_batch_processor(p, device=dev, **kw)(batch)
        for sp in SPLIT_SPS:
            proc = SH.make_sharded_processor(M.LocalMesh(1, sp, dev), p, **kw)
            kernels.reset_launch_counts()
            out = proc(batch)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            log(f"split main path {name} sp={sp}: launches "
                + ", ".join(f"{k}={v}" for k, v in counts.items() if v))
            if any(counts[k] < 1 for k in need):
                raise AssertionError(f"split {name} sp={sp} skipped a kernel")
            for k in need:
                key = f"{k}[prepadded]" if k == "cfar_detect" else k
                launches[key] = launches.get(key, 0) + counts[k]
            diff = [k for k in ref if not torch.equal(out[k], ref[k])]
            if diff or out.keys() != ref.keys():
                raise AssertionError(f"split {name} sp={sp} differs from the "
                                     f"single-card path in {diff}")
            fps[f"{name}/sp{sp}"] = BATCH * 1e3 / cuda_ms(lambda: proc(batch),
                                                          5)
            log(f"split main path {name} sp={sp}: all outputs bit-equal to "
                f"the single-card fused path ({int(ref['n_dets'].sum())} "
                f"detections), {fps[f'{name}/sp{sp}']:.1f} frames/s on one "
                f"card ({card})")
    return launches, fps


def split_timings(card: str, dev, pgr: int, iq, errs, launches):
    """Phase 18: per-shard kernel times at sp = 4 (a 256-row range shard of
    128 frames; a 32-chirp shard), CUDA events, against their bounds and
    plain twins; the prepadded cfar_detect entry on a block-scale shard.
    Returns the kernel rows."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.ops import cfar as C, cfar_detect as CD
    from fmcw_tpu_torch.ops import frontend as F, frontend_fixed as FX
    from fmcw_tpu_torch.ops import split_frontend as SF
    from fmcw_tpu_torch.ops.window import hamming_float, hamming_q15
    from fmcw_tpu_torch.ops.window import window_apply_fixed
    p = P.RadarParams()
    nr, nd = p.n_range, p.n_doppler
    sp = SPLIT_SPS[-1]
    ndc, nrl = nd // sp, nr // sp
    h = p.cfar.halo_range + pgr
    src = "fmcw_tpu_torch/csrc/"
    chirps = iq[:, ndc:2 * ndc].contiguous()            # shard 1
    rows = []
    ms = graph_ms(lambda: SF.range_frontend(chirps))
    plain = cuda_ms(lambda: F.range_fft_plain(chirps), 5)
    win = torch.as_tensor(hamming_float(nr), device=dev)
    zw = torch.complex(chirps[..., 0].float() * win,
                       chirps[..., 1].float() * win)
    lib = graph_ms(lambda: torch.fft.fft(zw, dim=-1))
    bound, by = bound_range_fft(BATCH, ndc, nr)
    log(f"range_frontend (chirp shard {BATCH}x{ndc}x{nr}): {ms:.4f} ms, "
        f"plain {plain:.4f} ms, torch.fft.fft {lib:.4f} ms, bound "
        f"{bound:.4f} ms ({by}) ({card})")
    rows.append(dict(name="range_frontend", route="cuda",
                     source=src + "range_fft.cu",
                     replaces="fmcw_tpu/ops/split_frontend.py:73",
                     launches=launches["range_frontend"],
                     max_abs_err=errs["range_frontend"], ms=ms,
                     plain_ms=plain, bound_ms=bound, bound_by=by,
                     library_ms=lib))
    ms = graph_ms(lambda: SF.range_frontend_fixed(chirps))
    eager = cuda_ms(lambda: SF.range_frontend_fixed(chirps))
    plain = cuda_ms(lambda: FX.range_fft_fixed_plain(chirps), 5)
    wi, wq, _ = window_apply_fixed(chirps[..., 0], chirps[..., 1],
                                   hamming_q15(nr)[None, :])
    zw = torch.complex(wi.double(), wq.double())
    lib = graph_ms(lambda: torch.fft.fft(zw, dim=-1))
    del zw
    turn = graph_ms(lambda: chirps.transpose(1, 2).contiguous())
    bound, by = bound_range_fft_fixed(BATCH, ndc, nr)
    log(f"range_frontend_fixed (chirp shard): {ms:.4f} ms (graph; eager "
        f"{eager:.4f}), plain {plain:.4f} ms, torch.fft.fft complex128 "
        f"{lib:.4f} ms, corner-turn copy {turn:.4f} ms, bound {bound:.4f} ms "
        f"({by}) ({card})")
    rows.append(dict(name="range_frontend_fixed", route="cuda",
                     source=src + "range_fft_fixed.cu",
                     replaces="fmcw_tpu/ops/split_frontend.py:111",
                     launches=launches["range_frontend_fixed"],
                     max_abs_err=errs["range_frontend_fixed"], ms=ms,
                     plain_ms=plain, bound_ms=bound, bound_by=by,
                     library_ms=lib))
    s = 1
    ext = torch.arange(s * nrl - h, (s + 1) * nrl + h, device=dev) % nr
    lo, hi, core = ext[:h], ext[h + nrl:], ext[h:h + nrl]
    skw = dict(cfar=p.cfar, n_range_total=nr, peak_group_radius=pgr)
    for fixed in (False, True):
        if fixed:
            re, im, _ = FX.range_fft_fixed(iq)
            kern, twin = (SF.slowtime_detect_fixed_split,
                          SF.slowtime_detect_fixed_split_plain)
            name = "slowtime_detect_fixed_split"
            line = 625
            bound, by = bound_slowtime_fixed_split(BATCH, nrl, nd, h, p.cfar)
        else:
            re, im = F.range_fft(iq)
            kern, twin = SF.slowtime_detect_split, SF.slowtime_detect_split_plain
            name = "slowtime_detect_split"
            line = 518
            bound, by = bound_slowtime_split(BATCH, nrl, nd, h, p.cfar)
        args = (re[:, core].contiguous(), im[:, core].contiguous(),
                (re[:, lo].contiguous(), im[:, lo].contiguous()),
                (re[:, hi].contiguous(), im[:, hi].contiguous()), False, 0,
                s * nrl)
        # By graph replay, eager beside it; the fixed entry also beside
        # torch.fft.fft (complex128) of its planes, the halo rows included.
        eager = cuda_ms(lambda: kern(*args, **skw))
        ms = graph_ms(lambda: kern(*args, **skw))
        plain = cuda_ms(lambda: twin(*args, **skw), 2, 1)
        fft = ""
        if fixed:
            zf = torch.complex(re[:, ext].double(), im[:, ext].double())
            fft = (f", torch.fft.fft complex128 of its planes "
                   f"{graph_ms(lambda: torch.fft.fft(zf, dim=-1)):.4f} ms")
            del zf
        log(f"{name} (range shard {BATCH}x{nrl}x{nd}, halo {h}): {ms:.4f} "
            f"ms (graph; eager {eager:.4f}), plain {plain:.4f} ms{fft}, "
            f"bound {bound:.4f} ms ({by}) ({card})")
        rows.append(dict(name=name, route="cuda",
                         source=src + ("slowtime_detect_fixed.cu" if fixed
                                       else "slowtime_detect.cu"),
                         replaces=f"fmcw_tpu/ops/split_frontend.py:{line}",
                         launches=launches[name], max_abs_err=errs[name],
                         ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                         library_ms=None))
    # The prepadded cfar_detect entry (rows 7/8's kernel) on a block-scale
    # range shard with its halo_range exchanged rows.
    q = P.fast()
    re, im = F.range_fft(iq)
    mag, _ = F.slowtime_mag(re, im)
    hr = q.cfar.halo_range
    ext = torch.arange(s * nrl - hr, (s + 1) * nrl + hr, device=dev) % nr
    m_h = mag[:, ext].contiguous()
    smap = C.block_scale_map(mag, q.cfar)[:, s * nrl:(s + 1) * nrl]
    det, scale = CD.cfar_detect(m_h, 0, cfar=q.cfar, scale_map=smap,
                                prepadded_range=True)
    d2, s2 = CD.cfar_detect_plain(m_h, 0, cfar=q.cfar, scale_map=smap,
                                  prepadded_range=True)
    torch.cuda.synchronize()
    if not (torch.equal(det, d2) and torch.equal(scale, s2)
            and torch.equal(det, CD.cfar_detect(mag, 0, cfar=q.cfar)[0][
                :, s * nrl:(s + 1) * nrl])):
        raise AssertionError("prepadded cfar_detect disagrees with cfar_2d "
                             "or with the whole map's decision")
    def call():
        return CD.cfar_detect(m_h, 0, cfar=q.cfar, scale_map=smap,
                              prepadded_range=True)
    ms = graph_ms(call)
    eager = cuda_ms(call)
    plain = cuda_ms(lambda: CD.cfar_detect_plain(
        m_h, 0, cfar=q.cfar, scale_map=smap, prepadded_range=True), 2, 1)
    bound, by = bound_cfar_detect(BATCH, nrl, nd, q.cfar, True)
    log(f"cfar_detect prepadded block (range shard {BATCH}x{nrl}+2x{hr}): "
        f"{ms:.4f} ms (graph; eager {eager:.4f}), plain {plain:.4f} ms, "
        f"bound {bound:.4f} ms ({by}); bit-identical to cfar_2d and to the "
        f"whole map's rows ({card})")
    rows.append(dict(name="cfar_detect[prepadded]", route="cuda",
                     source=src + "cfar_detect.cu",
                     replaces="fmcw_tpu/ops/cfar_pallas.py:279",
                     launches=launches["cfar_detect[prepadded]"],
                     max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bound,
                     bound_by=by, library_ms=None))
    return rows


# ---------------------------------------------------------------------------
# Row 9 (the debug taps' rank select), the debug routes, the sharded array
# model
# ---------------------------------------------------------------------------

RANK_FRAMES = 8                 # frames the rank twin takes: 67 MB a frame
RANK_PGR = 2                    # the grouping radius of the debug routes
# Population counts: 16 a clock an SM (the CUDA C++ Programming Guide's
# arithmetic instruction throughput, compute capability 9.0) x 132 SMs x
# 1.98 GHz.
H100_POPC_PER_S = 16 * 132 * 1.98e9


def bound_cfar_rank(B: int, nr: int, nd: int, cfar, bits: int,
                    integer: bool, block: bool, group: bool = False):
    """Least time for cfar_rank's design (bit planes counted with
    population counts): the map read once (and the scale map with the block
    scale), det, threshold and scale written once (with grouping row_max
    and n_dets too); per cell and walked bit one population count per
    window-row pair (ceil((2 hr + 1) / 2), the POPC pipe; one per row for
    windows over 16 columns, which the kernel walks a row at a time), 2.5
    integer ops beside each (the AND, the mask update and half an IADD3),
    the threshold and decision (4), plus, for the per-cell scale, the box
    sums, mean and classification (20, FP32 for float maps)."""
    cells = B * nr * nd
    nbytes = cells * (16 + (4 if block else 0)) + (
        B * nr * 4 + B * 4 if group else 0)
    rows = 2 * cfar.halo_range + 1
    units = (rows + 1) // 2 if 2 * cfar.halo_doppler + 1 <= 16 else rows
    popc = cells * bits * units
    scale_ops = 0 if block else 20
    int_ops = 2.5 * popc + cells * (4 + (scale_ops if integer else 0))
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = max(popc / H100_POPC_PER_S,
                int_ops / H100_INT32_OPS_PER_S,
                (0 if integer else cells * scale_ops) / H100_FP32_OPS_PER_S
                ) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_cfar_rank_compares(B: int, nr: int, nd: int, cfar, bits: int,
                             integer: bool, block: bool):
    """The bound cfar_rank was held to before its bit planes (kept beside
    the new one): ``bits`` x n_ref compare-adds a cell on int32 keys
    (INT32, 2 ops each), the threshold and decision (4) and the per-cell
    scale (20, FP32 for float maps); 16 bytes a cell (20 with a scale
    map)."""
    cells = B * nr * nd
    nbytes = cells * (16 + (4 if block else 0))
    scale_ops = 0 if block else 20
    int_ops = cells * (2 * bits * cfar.n_ref + 4
                       + (scale_ops if integer else 0))
    return _bound(nbytes, 0 if integer else cells * scale_ops, int_ops)


def _rank_stack(mag, cfar):
    """The (..., R, D, n_ref) int32 training stack of float maps, keys as
    bit patterns (what torch.topk would rank)."""
    import torch
    from fmcw_tpu_torch.golden.fixed_point import _window_offsets
    from fmcw_tpu_torch.ops import cfar as C
    hr, hd = cfar.halo_range, cfar.halo_doppler
    R, D = mag.shape[-2:]
    p = C._wrap_pad(mag.view(torch.int32), hr, hd)
    return torch.stack([p[..., hr + dr:hr + dr + R, hd + dd:hd + dd + D]
                        for dr, dd in _window_offsets(cfar)], dim=-1)


def rank_kernel_checks(dev):
    """Phase 20: cfar_rank (TPU row 9) against cfar_rank_plain on the card,
    on 8 frames of the float main path's magnitudes (kernel A and kernel
    B's magnitude-only entry) and of the fixed chain's int32 magnitudes:
    float with 31 and 16 key bits, int32 with 16, scale_override 4, the
    block scale with a given block_scale_map (float and int32), a prepadded
    256-row range shard (equal too to the whole map's rows), the quick
    window (hr 3), a window outside the unrolled walks (hr 4, gd 2) and
    one of 19 Doppler columns (walked a row at a time);
    then 8 adversarial frames (golden.reference.rank_adversarial_maps:
    NaN, +-Inf, -0.0, negative floats, denormals, plateaus of ties at the
    k-th value; int keys at and above 2^16 and below 0) float and int32 on
    16 and 31 key bits and the block scale: det, threshold and scale bit for
    bit.  The grouping entry (cfar_rank_group) against its twin on every
    whole-map case at radius 2 (and 0 and 1 on two): det, threshold, scale,
    row maxima and counts bit for bit.  Returns ({case: largest |kernel -
    twin|}, the float and int32 magnitudes of 128 frames)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.golden import reference
    from fmcw_tpu_torch.models import pipeline as pl
    from fmcw_tpu_torch.ops import cfar as C, cfar_rank as RK
    from fmcw_tpu_torch.ops import frontend as F
    p, fast = P.RadarParams(), P.fast()
    iq = torch.as_tensor(make_batch(p, BATCH, seed=3), device=dev)
    fmag, _ = F.slowtime_mag(*F.range_fft(iq))
    imag, _ = pl._staged_fixed(iq, False, p, "zero", "unbiased")
    f8, i8 = fmag[:RANK_FRAMES], imag[:RANK_FRAMES]
    nrl, hr = p.n_range // 4, p.cfar.halo_range
    ext = torch.arange(nrl - hr, 2 * nrl + hr, device=dev) % p.n_range
    shape = (RANK_FRAMES, p.n_range, p.n_doppler)
    af = torch.as_tensor(reference.rank_adversarial_maps(shape, False, 11),
                         device=dev)
    ai = torch.as_tensor(reference.rank_adversarial_maps(shape, True, 12),
                         device=dev)
    wide = P.CfarParams(ref_range=3, ref_doppler=2, guard_range=1,
                        guard_doppler=2)
    cases = (
        ("float/31", f8, p.cfar, None, 0, None, False),
        ("float/16", f8, p.cfar, 16, 0, None, False),
        ("float/16/so4", f8, p.cfar, 16, 4, None, False),
        ("int32/16", i8, p.cfar, 16, 0, None, False),
        ("float/block", f8, fast.cfar, None, 0,
         C.block_scale_map(f8, fast.cfar), False),
        ("int32/block", i8, fast.cfar, None, 0,
         C.block_scale_map(i8, fast.cfar), False),
        ("float/16/prepadded", f8[:, ext], p.cfar, 16, 0, None, True),
        ("float/16/quick-window", f8, P.quick().cfar, 16, 0, None, False),
        ("int32/16/generic-window", i8, wide, 16, 0, None, False),
        ("float/16/wide-window", f8, P.CfarParams(ref_doppler=8), 16, 0,
         None, False),
        ("float/31/adversarial", af, p.cfar, None, 0, None, False),
        ("float/16/adversarial", af, p.cfar, 16, 0, None, False),
        ("int32/16/adversarial", ai, p.cfar, 16, 0, None, False),
        ("int32/31/adversarial/so4", ai, p.cfar, None, 4, None, False),
        ("float/block/adversarial", af, fast.cfar, None, 0,
         C.block_scale_map(af, fast.cfar), False))
    errs = {}
    for name, mag, cfar, bits, so, smap, pre in cases:
        kw = dict(cfar=cfar, bits=bits, scale_map=smap)
        got = RK.cfar_rank(mag, so, prepadded_range=pre, **kw)
        want = RK.cfar_rank_plain(mag, so, prepadded_range=pre, **kw)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        errs[name] = max(float((a.double() - b.double()).abs().max())
                         for a, b in zip(got, want))
        classes = torch.unique(got[2]).tolist()
        log(f"cfar_rank {name}: det, threshold and scale "
            f"{'bit-identical' if same else 'DIFFER'} to the twin on "
            f"{RANK_FRAMES} frames; {int((got[0] > 0).sum())} detections, "
            f"scale classes {classes}")
        if not same or int((got[0] > 0).sum()) == 0:
            raise AssertionError(f"cfar_rank {name} disagrees with its twin")
        if pre:
            whole = RK.cfar_rank(f8, so, cfar=cfar, bits=bits)
            if not all(torch.equal(a, b[:, nrl:2 * nrl])
                       for a, b in zip(got, whole)):
                raise AssertionError("prepadded cfar_rank differs from the "
                                     "whole map's rows")
            continue
        for pgr in ((0, 1, RANK_PGR) if name in ("float/16", "int32/16")
                    else (RANK_PGR,)):
            g = RK.cfar_rank_group(mag, so, peak_group_radius=pgr, **kw)
            gw = RK.cfar_rank_group_plain(mag, so, peak_group_radius=pgr,
                                          **kw)
            torch.cuda.synchronize()
            gsame = (all(torch.equal(a, b) for a, b in zip(g, gw))
                     and all(torch.equal(a, b) for a, b in zip(g[1:3],
                                                                got[1:3])))
            errs[f"group/{name}"] = max(
                errs.get(f"group/{name}", 0.0),
                max(float((a.double() - b.double()).abs().max())
                    for a, b in zip(g, gw)))
            log(f"cfar_rank_group {name} pgr={pgr}: det, threshold, scale, "
                f"row maxima and counts "
                f"{'bit-identical' if gsame else 'DIFFER'} to the twin; "
                f"{int(g[4].sum())} grouped detections")
            if not gsame or int(g[4].sum()) == 0:
                raise AssertionError(f"cfar_rank_group {name} pgr={pgr} "
                                     f"disagrees with its twin")
    return errs, fmag, imag


def debug_main_path(card: str, dev, pgr: int):
    """Phase 21: the debug-tap processors, make_batch_processor(...,
    include_debug=True) at batch 128, 1024x128: float per-cell and block on
    "fused" (kernel A, the magnitude-only kernel, cfar_rank_group) and
    "staged" (plain transforms, cfar_rank_group), fixed per-cell on "auto"
    (plain stages, cfar_rank_group on int32 maps); the kernels each
    launches, and no plain ops/cfar.peak_group call (the grouping is the
    kernel's epilogue); the taps and det map of frames 0-7 bit-equal to
    cfar_rank_plain and peak_group on the route's own magnitudes, every
    output of the batch (detections, counts, maps) bit-equal to the plain
    route's grouping on the same magnitudes; float frame 0 through the
    margin gate against the plain route (its 16-bit taps), fixed frame 0
    bit for bit the golden model's det map; frames/s.  Returns (launches,
    frames/s)."""
    import numpy as np
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch import kernels, parity
    from fmcw_tpu_torch.golden import fixed_point as fx, reference
    from fmcw_tpu_torch.models import pipeline as pl
    from fmcw_tpu_torch.ops import cfar as C, cfar_rank as RK
    from fmcw_tpu_torch.ops import detect as DET
    peak_group = C.peak_group
    configs = (("float/cell", P.RadarParams(), "float32", ("fused", "staged")),
               ("float/block", P.fast(), "float32", ("fused", "staged")),
               ("fixed/cell", P.RadarParams(), "fixed", ("auto",)))
    launches, fps = {}, {}
    for name, p, mode, routes in configs:
        fixed = mode == "fixed"
        noisy = make_batch(p, BATCH, seed=4)
        batch = torch.as_tensor(noisy, device=dev)
        bits = RK.debug_bits(p.cfar, fixed, 16)
        row = ("cfar_rank_group[int32,16 bits]" if fixed else
               "cfar_rank_group[float,16 bits]" if bits == 16 else
               "cfar_rank_group[float,exact,scale map]")
        kw = dict(mode=mode, peak_group_radius=pgr, include_debug=True)
        if fixed:
            _, gdet = reference.process_frame_fixed(
                noisy[0, ..., 0] + 1j * noisy[0, ..., 1].astype(float), p)
            gdet = fx.peak_group(gdet, pgr)
        else:
            ref = pl.make_processor(p, frontend="plain", device=dev,
                                    **kw)(batch[0])
        for fe in routes:
            proc = pl.make_batch_processor(p, frontend=fe, device=dev, **kw)
            plain_groups = []
            C.peak_group = lambda *a, **k: (plain_groups.append(1),
                                            peak_group(*a, **k))[1]
            try:
                kernels.reset_launch_counts()
                out = proc(batch)
                torch.cuda.synchronize()
                counts = kernels.launch_counts()
            finally:
                C.peak_group = peak_group
            need = ("cfar_rank_group",) + (("range_fft", "slowtime_mag")
                                           if fe == "fused" else ())
            log(f"debug main path {name} {fe}: launches "
                + ", ".join(f"{k}={v}" for k, v in counts.items() if v)
                + f"; plain peak_group calls {len(plain_groups)}")
            if any(counts[k] < 1 for k in need):
                raise AssertionError(f"debug {name} {fe} skipped a kernel")
            if plain_groups or counts["cfar_rank"]:
                raise AssertionError(f"debug {name} {fe} grouped outside "
                                     f"the kernel")
            launches[row] = launches.get(row, 0) + counts["cfar_rank_group"]
            # Every output against the dataflow before the grouping entry
            # on the route's own magnitudes: cfar_rank_plain, plain
            # peak_group, top-K (in chunks of RANK_FRAMES frames).
            outs_ok = True
            for i in range(0, BATCH, RANK_FRAMES):
                dp, tp, sp = RK.cfar_rank_plain(
                    out["mag_map"][i:i + RANK_FRAMES], cfar=p.cfar,
                    bits=bits)
                dp = peak_group(dp, pgr)
                want = DET.topk_detections(dp, p.tracker.max_dets)
                want.update(det_map=dp, threshold_map=tp,
                            scale_map=sp.to(dp.dtype))
                outs_ok &= all(torch.equal(out[k][i:i + RANK_FRAMES], v)
                               for k, v in want.items())
                del dp, tp, sp, want
            mag8 = out["mag_map"][:RANK_FRAMES]
            det, thr, scale = RK.cfar_rank_plain(mag8, cfar=p.cfar, bits=bits)
            # The scale tap comes in the magnitude map's type, as JAX's.
            taps_ok = (torch.equal(out["threshold_map"][:RANK_FRAMES], thr)
                       and out["scale_map"].dtype == mag8.dtype
                       and torch.equal(out["scale_map"][:RANK_FRAMES],
                                       scale.to(mag8.dtype))
                       and torch.equal(out["det_map"][:RANK_FRAMES],
                                       C.peak_group(det, pgr)))
            del det, thr, scale
            if fixed:
                ok = np.array_equal(out["det_map"][0].cpu().numpy(), gdet)
                report = (f"frame 0 det map {'equal' if ok else 'DIFFERS'} "
                          f"to the golden model's ({int((gdet > 0).sum())} "
                          f"detections)")
            else:
                ok, report = parity.margin_gate(
                    parity.detection_set(out, 0), parity.detection_set(ref),
                    ref["mag_map"].cpu().numpy(),
                    ref["threshold_map"].cpu().numpy(),
                    ref["scale_map"].cpu().numpy(), radius=pgr,
                    capacity=p.tracker.max_dets,
                    targets=reference.golden_targets(p))
            log(f"debug main path {name} {fe}: taps of frames 0-"
                f"{RANK_FRAMES - 1} {'bit-equal' if taps_ok else 'DIFFER'} "
                f"to the twin on the route's magnitudes; every output "
                f"{'bit-equal' if outs_ok else 'DIFFERS'} to the plain "
                f"grouping's; {report}")
            if not (taps_ok and outs_ok and ok):
                raise AssertionError(f"debug {name} {fe} failed its check")
            if int(out["nonfinite_count"].sum()) != 0:
                raise AssertionError("non-finite cells in the magnitude map")
            del out
            lean = pl.make_batch_processor(p, frontend=fe, include_maps=False,
                                           device=dev, **kw)
            fps[f"{name}/{fe}"] = BATCH * 1e3 / cuda_ms(lambda: lean(batch), 5)
            log(f"debug main path {name} {fe}: {fps[f'{name}/{fe}']:.1f} "
                f"frames/s at batch {BATCH} ({card})")
    return launches, fps


def sharded_debug_path(card: str, dev, pgr: int, launches):
    """Phase 22: make_sharded_processor(include_debug=True) on a LocalMesh,
    sp 2 and 4, batch 128: float per-cell and block on "fused" (kernel A on
    chirp shards, the magnitude-only kernel, cfar_rank on prepadded range
    shards), fixed per-cell on "auto"; the kernels each launches; every
    output — taps, det and mag maps, detections — equal to the single card
    bit for bit; frames/s.  Adds its cfar_rank launches to ``launches``;
    returns frames/s."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch import kernels
    from fmcw_tpu_torch.models import pipeline as pl
    from fmcw_tpu_torch.parallel import mesh as M, sharded as SH
    configs = (("float/cell", P.RadarParams(), "float32", "fused",
                "cfar_rank[float,16 bits]"),
               ("float/block", P.fast(), "float32", "fused",
                "cfar_rank[float,exact,scale map]"),
               ("fixed/cell", P.RadarParams(), "fixed", "auto",
                "cfar_rank[int32,16 bits]"))
    fps = {}
    for name, p, mode, fe, row in configs:
        batch = torch.as_tensor(make_batch(p, BATCH, seed=6), device=dev)
        kw = dict(mode=mode, frontend=fe, peak_group_radius=pgr,
                  include_debug=True)
        ref = pl.make_batch_processor(p, include_maps=True, device=dev,
                                      **kw)(batch)
        need = ("cfar_rank",) + (("range_frontend", "slowtime_mag")
                                 if fe == "fused" else ())
        for sp in SPLIT_SPS:
            proc = SH.make_sharded_processor(M.LocalMesh(1, sp, dev), p,
                                             include_maps=True, **kw)
            kernels.reset_launch_counts()
            out = proc(batch)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            log(f"sharded debug {name} sp={sp}: launches "
                + ", ".join(f"{k}={v}" for k, v in counts.items() if v))
            if any(counts[k] < 1 for k in need):
                raise AssertionError(f"sharded debug {name} sp={sp} skipped "
                                     f"a kernel")
            launches[row] = launches.get(row, 0) + counts["cfar_rank"]
            diff = [k for k in ref if not torch.equal(out[k], ref[k])]
            if diff or out.keys() != ref.keys():
                raise AssertionError(f"sharded debug {name} sp={sp} differs "
                                     f"from the single card in {diff}")
            del out
            lean = SH.make_sharded_processor(M.LocalMesh(1, sp, dev), p, **kw)
            fps[f"{name}/sp{sp}"] = BATCH * 1e3 / cuda_ms(
                lambda: lean(batch), 5)
            log(f"sharded debug {name} sp={sp}: taps, maps and detections "
                f"bit-equal to the single card ({int(ref['n_dets'].sum())} "
                f"detections), {fps[f'{name}/sp{sp}']:.1f} frames/s on one "
                f"card ({card})")
    return fps


def rank_timings(card: str, dev, fmag, imag, errs, launches):
    """Phase 23: cfar_rank per launch at batch 128 (CUDA events) for float
    16 key bits, float exact (per-cell and with a given block scale map)
    and int32 16 bits, and the grouping entry cfar_rank_group (radius 2) on
    the three the debug routes launch, each against bound_cfar_rank (and
    the compare-add bound it was held to before, bound_cfar_rank_compares)
    and its twin run over the batch in 8-frame chunks; the yardstick
    torch.topk over a prebuilt 8-frame training stack against the kernel on
    the same 8 frames.  Returns (kernel rows, summary)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.ops import cfar as C, cfar_rank as RK
    p, fast = P.RadarParams(), P.fast()
    nr, nd = p.n_range, p.n_doppler
    src = "fmcw_tpu_torch/csrc/cfar_rank.cu"
    fsmap = C.block_scale_map(fmag, fast.cfar)
    variants = (
        ("float,16 bits", fmag, p.cfar, 16, None, "float/16"),
        ("float,exact", fmag, p.cfar, None, None, "float/31"),
        ("float,exact,scale map", fmag, fast.cfar, None, fsmap,
         "float/block"),
        ("int32,16 bits", imag, p.cfar, 16, None, "int32/16"))
    rows, summary = [], {}
    for entry in ("cfar_rank", "cfar_rank_group"):
        for what, mag, cfar, bits, smap, case in variants:
            name = f"{entry}[{what}]"
            group = entry == "cfar_rank_group"
            if group and name not in launches:
                continue
            kw = dict(cfar=cfar, bits=bits)
            if group:
                kw["peak_group_radius"] = RANK_PGR
            kernel = RK.cfar_rank_group if group else RK.cfar_rank
            twin = RK.cfar_rank_group_plain if group else RK.cfar_rank_plain

            def plain():
                for i in range(0, BATCH, RANK_FRAMES):
                    twin(mag[i:i + RANK_FRAMES], scale_map=(
                        None if smap is None else smap[i:i + RANK_FRAMES]),
                        **kw)

            ms = cuda_ms(lambda: kernel(mag, scale_map=smap, **kw), 5)
            plain_ms = cuda_ms(plain, 1, 1)
            args = (BATCH, nr, nd, cfar, bits or 31,
                    not mag.is_floating_point(), smap is not None)
            bound, by = bound_cfar_rank(*args, group=group)
            old, old_by = bound_cfar_rank_compares(*args)
            summary[name] = {"ms": ms, "plain_ms": plain_ms,
                             "bound_ms": bound, "compare_bound_ms": old}
            log(f"{name}: {ms:.4f} ms, plain (16 x {RANK_FRAMES} frames) "
                f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}; the "
                f"compare-add bound {old:.4f} ms, {old_by}) at batch "
                f"{BATCH} ({card})")
            if ms < bound:
                raise AssertionError(f"{name} reads under its bound")
            if name in launches:
                rows.append(dict(
                    name=name, route="cuda", source=src,
                    replaces="fmcw_tpu/ops/cfar_pallas.py:58",
                    launches=launches[name],
                    max_abs_err=errs[f"group/{case}" if group else case],
                    ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                    library_ms=None))
    # The yardstick: torch.topk over a prebuilt training stack computes the
    # order statistic alone (no stack building, mean, scale or threshold).
    f8 = fmag[:RANK_FRAMES]
    stack = _rank_stack(f8, p.cfar)
    k = p.cfar.n_ref - p.cfar.rank_idx
    topk_ms = cuda_ms(lambda: torch.topk(stack, k, dim=-1), 5)
    del stack
    k8 = {b: cuda_ms(lambda: RK.cfar_rank(f8, cfar=p.cfar, bits=b), 5)
          for b in (16, None)}
    summary["topk_8_frames"] = {"topk_ms": topk_ms, "kernel_16_ms": k8[16],
                                "kernel_exact_ms": k8[None]}
    log(f"torch.topk over a prebuilt {RANK_FRAMES}-frame training stack "
        f"(the order statistic only): {topk_ms:.4f} ms; cfar_rank on the same "
        f"frames {k8[16]:.4f} ms (16 bits), {k8[None]:.4f} ms (exact) "
        f"({card})")
    return rows, summary


def shard_entry_checks(card: str, dev):
    """Phase 24: the sharded array model's kernel entries at full width
    (16 cubes x 8 beams x 1024x128, phase 12's magnitude cube), sp 2 and
    4: cfar3d_detect(
    prepadded_angle=True) on each beam shard with its ring neighbours' planes
    and beam_group(beam_offset=) (radius 1 and 2, global beam ids) on each
    halo-extended shard, bit-equal to the whole-cube kernels' interior
    planes (and their row maxima and counts) and to their twins on shard 0;
    one sp=4 shard timed against its bound and twin (the 3D CFAR by graph
    replay, eager beside it).  Returns the kernel
    rows (bit-equal, so max_abs_err 0; launches added by phase 25)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.ops import beam_group as BG, cfar3d_detect as C3
    from fmcw_tpu_torch.ops import frontend as F
    p = P.RadarParams()
    nr, nd = p.n_range, p.n_doppler
    br, bi = beam_planes(torch.as_tensor(make_cubes(p, ARRAY_BATCH, seed=1),
                                         device=dev))
    cube = F.slowtime_mag(*F.range_fft_float(br, bi))[0].reshape(
        ARRAY_BATCH, N_BEAMS, nr, nd)
    del br, bi
    whole = C3.cfar3d_detect(cube, cfar=p.cfar, ref_angle=1)
    det = whole[0]

    def ext(x, s, bl, h):
        idx = torch.arange(s * bl - h, (s + 1) * bl + h, device=dev) % N_BEAMS
        return x[:, idx].contiguous()

    for sp in SPLIT_SPS:
        bl = N_BEAMS // sp
        for s in range(sp):
            cut = slice(s * bl, (s + 1) * bl)
            got = C3.cfar3d_detect(ext(cube, s, bl, 1), cfar=p.cfar,
                                   ref_angle=1, prepadded_angle=True)
            ok = all(torch.equal(a, b[:, cut]) for a, b in zip(got, whole))
            if s == 0:
                twin = C3.cfar3d_detect_plain(ext(cube[:2], s, bl, 1),
                                              cfar=p.cfar, ref_angle=1,
                                              prepadded_angle=True)
                ok = ok and all(torch.equal(a[:2], b)
                                for a, b in zip(got, twin))
            if not ok:
                raise AssertionError(f"prepadded cfar3d_detect sp={sp} "
                                     f"shard {s} differs")
            for r in (1, 2):
                if r > bl:
                    continue
                g, rmax, n = BG.beam_group(det, r)
                gs, rs, ns = BG.beam_group(ext(det, s, bl, r), r,
                                           beam_offset=s * bl,
                                           n_beams=N_BEAMS)
                ok = (torch.equal(gs, g[:, cut])
                      and torch.equal(rs, rmax.reshape(
                          ARRAY_BATCH, N_BEAMS, nr)[:, cut].reshape(
                              ARRAY_BATCH, -1))
                      and torch.equal(ns, (gs > 0).sum(dim=(1, 2, 3)).int()))
                twin = BG.beam_group_plain(ext(det, s, bl, r), r,
                                           beam_offset=s * bl,
                                           n_beams=N_BEAMS)
                ok = ok and all(torch.equal(a, b) for a, b in
                                zip((gs, rs, ns), twin))
                if not ok:
                    raise AssertionError(f"beam_group ids sp={sp} shard {s} "
                                         f"radius {r} differs")
        log(f"shard entries sp={sp}: prepadded cfar_3d_detect and the "
            f"global-ids beam_group (radius 1, 2) bit-equal to the whole "
            f"cube's interior planes on every shard and to their twins")
    shard_group_cases(dev)
    torch.cuda.synchronize()
    # Timing: shard 1 of sp = 4.
    sp, s = SPLIT_SPS[-1], 1
    bl = N_BEAMS // sp
    src = "fmcw_tpu_torch/csrc/"
    rows = []
    x = ext(cube, s, bl, 1)
    ms = graph_ms(lambda: C3.cfar3d_detect(x, cfar=p.cfar, ref_angle=1,
                                           prepadded_angle=True))
    eager = cuda_ms(lambda: C3.cfar3d_detect(x, cfar=p.cfar, ref_angle=1,
                                             prepadded_angle=True))
    plain = cuda_ms(lambda: C3.cfar3d_detect_plain(
        x, cfar=p.cfar, ref_angle=1, prepadded_angle=True), 2, 1)
    bound, by = bound_cfar3d(ARRAY_BATCH * bl * nr * nd, p.cfar, 1, 0, False)
    log(f"cfar_3d_detect[prepadded] (beam shard {ARRAY_BATCH}x{bl}+2x1 "
        f"planes): {ms:.4f} ms (graph; eager {eager:.4f}), plain "
        f"{plain:.4f} ms, bound {bound:.4f} ms ({by}) ({card})")
    rows.append(dict(name="cfar_3d_detect[prepadded]", route="cuda",
                     source=src + "cfar_3d_detect.cu",
                     replaces="fmcw_tpu/ops/cfar_pallas.py:569",
                     max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bound,
                     bound_by=by, library_ms=None))
    x = ext(det, s, bl, 1)
    ms = graph_ms(lambda: BG.beam_group(x, 1, beam_offset=s * bl,
                                        n_beams=N_BEAMS))
    eager = cuda_ms(lambda: BG.beam_group(x, 1, beam_offset=s * bl,
                                          n_beams=N_BEAMS))
    plain = cuda_ms(lambda: BG.beam_group_plain(x, 1, beam_offset=s * bl,
                                                n_beams=N_BEAMS), 5)
    bound, by = bound_beam_group(ARRAY_BATCH, bl, nr, nd, 1, halo=1)
    log(f"beam_group[ids] (beam shard {ARRAY_BATCH}x{bl}+2x1 planes): "
        f"{ms:.4f} ms (graph; eager {eager:.4f}), plain {plain:.4f} ms, "
        f"bound {bound:.4f} ms ({by}; the 2 halo planes read) ({card})")
    rows.append(dict(name="beam_group[ids]", route="cuda",
                     source=src + "beam_group.cu",
                     replaces="fmcw_tpu/ops/cfar_pallas.py:824",
                     max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bound,
                     bound_by=by, library_ms=None))
    return rows


def shard_group_cases(dev):
    """Phase 24b: the shard entry of beam_group (global beam ids) on
    small cubes of 8 beams, bit for bit against the twin and the whole
    cube's interior planes: sp 2 and 4 with radius 1 and 2 at D 128, 130
    and 6, R 37, ties and adversarial values, and a shard whose own planes
    run across the cube's end (beams 6, 7, 0, 1; radius 1, 2 and 4)."""
    import torch
    from fmcw_tpu_torch.ops import beam_group as BG
    n = 0
    for i, (d, kind) in enumerate(((128, "ties"), (130, "adversarial"),
                                   (6, "ties"))):
        cube = torch.as_tensor(group_stimulus((2, 8, 37, d), 200 + i, kind),
                               device=dev)
        for sp in (2, 4):
            bl = 8 // sp
            for r in (1, 2):
                whole = BG.beam_group(cube, r)
                for s in range(sp):
                    idx = torch.arange(s * bl - r, (s + 1) * bl + r,
                                       device=dev) % 8
                    x = cube[:, idx].contiguous()
                    got = BG.beam_group(x, r, beam_offset=s * bl, n_beams=8)
                    ok = group_bits_equal(got, BG.beam_group_plain(
                        x, r, beam_offset=s * bl, n_beams=8))
                    cut = slice(s * bl, (s + 1) * bl)
                    ok = ok and torch.equal(got[0], whole[0][:, cut])
                    n += 1
                    if not ok:
                        raise AssertionError(f"beam_group shard differs: D "
                                             f"{d} sp {sp} shard {s} radius "
                                             f"{r} {kind}")
        for r in (1, 2, 4):
            idx = torch.arange(6 - r, 10 + r, device=dev) % 8
            x = cube[:, idx].contiguous()
            got = BG.beam_group(x, r, beam_offset=6, n_beams=8)
            ok = group_bits_equal(got, BG.beam_group_plain(
                x, r, beam_offset=6, n_beams=8))
            ok = ok and torch.equal(got[0],
                                    BG.beam_group(cube, r)[0][:, [6, 7, 0, 1]])
            n += 1
            if not ok:
                raise AssertionError(f"beam_group wrapped shard differs: D "
                                     f"{d} radius {r}")
    torch.cuda.synchronize()
    log(f"beam_group shard cases: {n} shards (sp 2/4, radius 1/2, D "
        f"128/130/6, R 37, ties and adversarial values; beams 6, 7, 0, 1 "
        f"at radius 1/2/4) bit-identical to the twin and the whole cube")


def sharded_array_main_path(card: str, dev):
    """Phase 25: make_sharded_array_processor on a LocalMesh, dp 1, sp 2 and
    4, the three array configurations at 16 cubes (tools/array_bench.py's
    input): the kernels each launches (the prepadded 3D CFAR and the
    global-ids beam grouping at sp > 1), every output — detections, counts,
    magnitude and det cubes — equal to make_batch_array_processor on the
    card bit for bit, cubes/s.  Returns (launches, cubes/s)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch import kernels
    from fmcw_tpu_torch.models import pipeline as pl
    from fmcw_tpu_torch.parallel import mesh as M, sharded as SH
    launches, cps = {}, {}
    for name, preset, kw, need in ARRAY_CONFIGS:
        p = getattr(P, preset)()
        batch = torch.as_tensor(make_cubes(p, ARRAY_BATCH, seed=2),
                                device=dev)
        akw = dict(kw, n_elems=N_ELEMS, n_beams=N_BEAMS)
        ref = pl.make_batch_array_processor(p, include_maps=True, device=dev,
                                            **akw)(batch)
        for sp in SPLIT_SPS:
            proc = SH.make_sharded_array_processor(
                M.LocalMesh(1, sp, dev), p, include_maps=True, **akw)
            kernels.reset_launch_counts()
            out = proc(batch)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            log(f"sharded array {name} sp={sp}: launches "
                + ", ".join(f"{k}={v}" for k, v in counts.items() if v))
            if any(counts[k] < 1 for k in need):
                raise AssertionError(f"sharded array {name} sp={sp} skipped "
                                     f"a kernel")
            for k, row in (("cfar3d_detect", "cfar_3d_detect[prepadded]"),
                           ("beam_group", "beam_group[ids]")):
                launches[row] = launches.get(row, 0) + counts[k]
            diff = [k for k in ref if not torch.equal(out[k], ref[k])]
            if diff or out.keys() != ref.keys():
                raise AssertionError(f"sharded array {name} sp={sp} differs "
                                     f"from the single card in {diff}")
            del out
            lean = SH.make_sharded_array_processor(M.LocalMesh(1, sp, dev),
                                                   p, **akw)
            cps[f"{name}/sp{sp}"] = ARRAY_BATCH * 1e3 / cuda_ms(
                lambda: lean(batch), 5)
            log(f"sharded array {name} sp={sp}: every output bit-equal to "
                f"the single card ({int(ref['n_dets'].sum())} detections), "
                f"{cps[f'{name}/sp{sp}']:.1f} cubes/s on one card ({card})")
    return launches, cps


def _nccl_rank(rank: int, world: int, port: int, dp: int, sp: int,
               out_dir: str, pgr: int) -> None:
    """One rank of the NCCL phase: make_mesh(dp, sp) over the world, the
    sharded processor for each configuration against the single-GPU fused
    path on this rank's GPU, frames/s of the mesh, the sharded array model
    against the single-GPU one and its cubes/s, and the all-to-all and
    halo-exchange times."""
    import datetime
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        import fmcw_tpu_torch as P
        from fmcw_tpu_torch.models import pipeline as pl
        from fmcw_tpu_torch.parallel import mesh as M, sharded as SH
        dev = torch.device("cuda", rank)
        mesh = M.make_mesh(dp, sp)
        res = {"configs": {}}
        for name, p, mode in (("float/cell", P.RadarParams(), "float32"),
                              ("float/block", P.fast(), "float32"),
                              ("fixed/cell", P.RadarParams(), "fixed")):
            batch = torch.as_tensor(make_batch(p, BATCH, seed=8), device=dev)
            kw = dict(mode=mode, frontend="fused", peak_group_radius=pgr,
                      include_maps=False)
            proc = SH.make_sharded_processor(mesh, p, **kw)
            out = proc(batch)
            ref = pl.make_batch_processor(p, device=dev, **kw)(batch)
            diff = [k for k in ref if not torch.equal(out[k], ref[k])]
            for _ in range(2):
                proc(batch)
            n = 10
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(n):
                proc(batch)
            torch.cuda.synchronize()
            dist.barrier()
            dt = (time.perf_counter() - t0) / n
            res["configs"][name] = {"diff": diff, "frames_per_s": BATCH / dt,
                                    "n_dets": int(ref["n_dets"].sum())}
        res["array"] = {}
        for name, preset, kw, _ in ARRAY_CONFIGS:
            p = getattr(P, preset)()
            cubes = torch.as_tensor(make_cubes(p, ARRAY_BATCH, seed=8),
                                    device=dev)
            akw = dict(kw, n_elems=N_ELEMS, n_beams=N_BEAMS)
            proc = SH.make_sharded_array_processor(mesh, p, **akw)
            out = proc(cubes)
            ref = pl.make_batch_array_processor(p, include_maps=False,
                                                device=dev, **akw)(cubes)
            diff = [k for k in ref if not torch.equal(out[k], ref[k])]
            for _ in range(2):
                proc(cubes)
            n = 10
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(n):
                proc(cubes)
            torch.cuda.synchronize()
            dist.barrier()
            dt = (time.perf_counter() - t0) / n
            res["array"][name] = {"diff": diff,
                                  "cubes_per_s": ARRAY_BATCH / dt}
        if sp > 1:
            ring = SH.sp_ring(mesh)
            bl = BATCH // dp
            p = P.RadarParams()
            x = torch.randn(bl, p.n_range, p.n_doppler // sp, device=dev)
            y = torch.randn(bl, p.n_range // sp, p.n_doppler, device=dev)
            h = p.cfar.halo_range + pgr
            res["all_to_all_ms"] = cuda_ms(lambda: ring.corner_turn([x]))
            res["halo_ms"] = cuda_ms(lambda: ring.halo([y], h))
            res["all_to_all_mib"] = x.numel() * 4 / 2 ** 20
        with open(f"{out_dir}/rank{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def nccl_phase(card: str, pgr: int, deadline_s: float = 420.0):
    """Phase 19, with two or more GPUs: torch.multiprocessing spawns one rank
    per GPU for (dp, sp) = (1, 2), (2, 1) and (1, N <= 4); on each,
    make_sharded_processor at full width (batch 128, 1024x128; float
    per-cell, float block, fixed) equals the single-GPU fused path bit for
    bit, and make_sharded_array_processor (16 cubes, the three array
    configurations) the single-GPU array model; prints frames/s, cubes/s
    and the all-to-all and halo-exchange times.  Any
    failure, or a rank still running at the deadline, fails the run.
    Returns the summary, or None with one card."""
    import socket
    import tempfile
    from pathlib import Path
    import torch
    import torch.multiprocessing as mp
    n_gpu = torch.cuda.device_count()
    if n_gpu < 2:
        log(f"NCCL phase not run: {n_gpu} GPU visible, the NCCL mesh needs "
            f"two or more (one card runs the split phases 16-18 instead)")
        return None
    shapes = []
    for shape in ((1, 2), (2, 1), (1, min(n_gpu, 4))):
        if shape not in shapes:
            shapes.append(shape)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    summary = {"gpus": n_gpu}
    for dp, sp in shapes:
        world = dp * sp
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        out_dir = tempfile.mkdtemp(prefix="nccl_", dir=build)
        ctx = mp.start_processes(_nccl_rank, args=(world, port, dp, sp,
                                                   out_dir, pgr),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        t_end = time.monotonic() + deadline_s
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > t_end:
                    raise AssertionError(f"NCCL mesh dp={dp} sp={sp}: ranks "
                                         f"still running after {deadline_s} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        ranks = [json.loads((Path(out_dir) / f"rank{r}.json").read_text())
                 for r in range(world)]
        for r, res in enumerate(ranks):
            for name, c in (list(res["configs"].items())
                            + list(res["array"].items())):
                if c["diff"]:
                    raise AssertionError(f"NCCL mesh dp={dp} sp={sp} rank {r} "
                                         f"{name} differs from the single GPU "
                                         f"in {c['diff']}")
        res = ranks[0]
        summary[f"dp{dp}_sp{sp}"] = res
        log(f"NCCL mesh dp={dp} sp={sp} on {world} GPUs: every rank equals "
            f"the single-GPU fused path bit for bit; frames/s "
            + ", ".join(f"{k} {v['frames_per_s']:.1f}"
                        for k, v in res["configs"].items())
            + "; array cubes/s "
            + ", ".join(f"{k} {v['cubes_per_s']:.1f}"
                        for k, v in res["array"].items())
            + (f"; all-to-all {res['all_to_all_ms']:.4f} ms for "
               f"{res['all_to_all_mib']:.1f} MiB per rank, halo exchange "
               f"{res['halo_ms']:.4f} ms" if sp > 1 else "")
            + f" ({card})")
    return summary


def tie_planes(batch: int, nr: int, nd: int, seed: int = 9):
    """Phase 3's tie-heavy stimulus: float planes (batch, nr, nd) whose
    range row r is an impulse A_r at chirp 0 (A_r from {0, 1, 2, 3, 4, 6,
    8}, and 64 on 2% of the rows, which detect; imaginary part 0).  With the
    MTI bypassed a row's magnitudes are all |A_r w[0]|, a multiple of 2^-15
    (the window is Q15), so every window sum and threshold is exact and
    many equal a training value: t_lo = 0.5 mean where the training
    amplitudes sum to 256 A', t_hi = 1.5 mean where they sum to 256 A' / 3,
    q = cut / 4 under scale 4; the detections of a row tie for the
    grouping.  With the MTI on, rows still repeat exactly."""
    import numpy as np
    rng = np.random.default_rng(seed)
    amp = rng.choice(np.array([0, 1, 2, 3, 4, 6, 8], np.float32),
                     size=(batch, nr))
    amp[rng.random((batch, nr)) < 0.02] = 64
    re = np.zeros((batch, nr, nd), np.float32)
    re[..., 0] = amp
    return re, np.zeros_like(re)


def tie_counts(mag, cfar, so: int):
    """Training values equal to their cell's t_hi, t_lo (per-cell scale) or
    detection threshold q (scale ``so`` > 0), counted over the map."""
    import torch
    from fmcw_tpu_torch.golden.fixed_point import _window_offsets
    from fmcw_tpu_torch.ops import cfar as C
    hr, hd = cfar.halo_range, cfar.halo_doppler
    pad = C._wrap_pad(mag, hr, hd)
    t_hi, t_lo = C.percell_thresholds(pad, cfar)
    q = C._q_min(mag, torch.full_like(mag, float(so))) if so else None
    R, D = mag.shape[-2:]
    n = [0, 0, 0]
    for dr, dd in _window_offsets(cfar):
        v = pad[..., hr + dr:hr + dr + R, hd + dd:hd + dd + D]
        n[0] += int((v == t_hi).sum())
        n[1] += int((v == t_lo).sum())
        if q is not None:
            n[2] += int((v == q).sum())
    return n


def tie_checks(dev, entry, block, pgr: int) -> None:
    """Phase 3, ties: kernel B on the tie-heavy planes (``tie_planes``, 4
    frames at 1024x128), both scale modes, MTI on and bypassed, override 0
    and 4: the decision bit for bit against the plain CFAR on the kernel's
    magnitudes, the magnitudes within TOL of the peak of the twin's; the
    bypassed per-cell runs must meet ties at t_hi, t_lo and q."""
    import torch
    from fmcw_tpu_torch.ops import frontend as F
    re, im = (torch.as_tensor(x, device=dev)
              for x in tie_planes(4, entry.n_range, entry.n_doppler))
    for p in (entry, block):
        for bypass in (True, False):
            for so in (0, 4):
                det, mag, rmax, ndet, nf = F.slowtime_detect(
                    re, im, bypass, so, cfar=p.cfar, peak_group_radius=pgr,
                    emit_mag=True)
                pmag = F.slowtime_mag_plain(re, im, bypass)
                d2, r2, n2, f2 = F.detect_plain(mag, p.cfar, so, pgr)
                torch.cuda.synchronize()
                err = float((mag - pmag).abs().max())
                peak = float(pmag.abs().max())
                same = (torch.equal(det, d2) and torch.equal(rmax, r2)
                        and torch.equal(ndet, n2) and torch.equal(nf, f2))
                ties = tie_counts(mag, p.cfar, so)
                log(f"kernel B ties {p.cfar.scale_mode} bypass={bypass} "
                    f"so={so}: {len(torch.unique(mag))} distinct magnitudes, "
                    f"training values equal to t_hi / t_lo / q: "
                    f"{ties[0]} / {ties[1]} / {ties[2]}; mag err "
                    f"{err / peak:.3g} of peak; decision "
                    f"{'bit-identical' if same else 'DIFFERS'}, n_dets "
                    f"{int(ndet.min())}..{int(ndet.max())}")
                if not err <= TOL * peak:
                    raise AssertionError("kernel B: tie magnitudes disagree")
                if not same:
                    raise AssertionError("kernel B: decision differs from "
                                         "the plain CFAR on the tie stimulus")
                need = ties[:2] + (ties[2:] if so else [])
                if bypass and p.cfar.scale_mode == "cell" and min(need) == 0:
                    raise AssertionError("tie stimulus met no tie")


# ---------------------------------------------------------------------------
# The surveillance runtime
# ---------------------------------------------------------------------------

SURV_SCANS = 48
SURV_BATCH = 16
ARRAY_SURV_SCANS = 16
DROP_SLEEP_CYCLES = 40_000_000   # about 24 ms of device time a frame
DROP_PACE_S = 0.0005             # a frame every 0.5 ms from the source


def firm_ranges(state) -> list:
    """Range bins of the firm active tracks of a (numpy) tracker state:
    range_pos is a 12-bit Q2 register, so unwrapped modulo 1024 bins."""
    from fmcw_tpu_torch.golden.tracker import FIRM
    firm = (state["status"] == FIRM) & (state["active"] == 1)
    return sorted(int(r) for r in (state["range_pos"][firm] & 4095) >> 2)


def surveillance_phase(card: str, dev):
    """Phase 26: the surveillance runtime on the card at 1024x128
    (RadarParams()), TacticalScenario frames (seed 42, point targets: the
    reference-faithful 5-sample burst smears a target over ~200 range bins
    at this width, and the 64-detection buffer then fills with clutter), 48
    scans, 16 a batch:
    * fixed mode, run_surveillance through the kernel route (frontend
      "auto") and the plain route: byte-identical detection and track logs,
      equal final tracker states;
    * the float main path (peak_group_radius 2): kernel A and kernel B
      launched, the tracker on the card (run_scans: one CUDA-graph replay a
      scan), both target groups held by firm tracks at the end;
    * resume: a checkpoint after scan 24, then the rest from it: logs
      byte-identical to the unbroken run, the final state equal;
    * the array model (make_batch_array_processor, 8 elements x 8 beams,
      beam_group_radius 1), 16 element-space scans;
    * stream (single frames) and stream_batched (16 a batch), policies
      block and drop, on the main path: results in order, each equal to a
      plain loop over the processor, drop counts adding up; the drop run
      overloads its window (a frame every 0.5 ms, about 24 ms of device
      time each, several times the host's time a frame) and must drop
      frames;
    * timings: scans/s of the loop, the frame batch (dispatch and readback)
      and the tracker (graph replays; an eager loop of step beside it, its
      final state and every scan's report equal to the graph's) per
      batch.  Returns the summary."""
    import numpy as np
    import torch
    from pathlib import Path
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch import kernels
    from fmcw_tpu_torch.models import pipeline as pl, scenario as sc
    from fmcw_tpu_torch.models import tracker as trk
    from fmcw_tpu_torch.runtime import stream as rs, surveillance as sv
    from fmcw_tpu_torch.utils import checkpoint as ck
    p = P.RadarParams()
    t0 = time.perf_counter()
    scen = sc.TacticalScenario(p, sc.ScenarioConfig(num_scans=SURV_SCANS,
                                                    burst_synthesis=False))
    data = [(pl.complex_to_iq(f), truth) for _, f, truth in scen.run()]
    frames = [f for f, _ in data]
    log(f"surveillance: {SURV_SCANS} scenario frames made in "
        f"{time.perf_counter() - t0:.1f} s")
    out_dir = Path(__file__).resolve().parent / "build" / "surveillance"
    out_dir.mkdir(parents=True, exist_ok=True)

    def run(proc, tag, fr, **kw):
        d, t = out_dir / f"{tag}_det.txt", out_dir / f"{tag}_trk.txt"
        kw.setdefault("det_log", str(d))
        kw.setdefault("trk_log", str(t))
        res = list(sv.run_surveillance(proc, fr, p, batch_scans=SURV_BATCH,
                                       device=dev, **kw))
        return res, d, t

    def counted(tag, fn, need=()):
        kernels.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        log(f"surveillance {tag}: launches "
            + (", ".join(f"{k}={v}" for k, v in counts.items()) or "none"))
        missing = [k for k in need if not counts.get(k)]
        if missing:
            raise AssertionError(f"surveillance {tag} skipped {missing}")
        return out

    # Fixed mode: the kernel route against the plain route.
    fixed = {}
    for fe in ("auto", "plain"):
        proc = pl.make_batch_processor(p, mode="fixed", frontend=fe,
                                       peak_group_radius=2,
                                       include_maps=False, device=dev)
        need = ("cfar_detect_group",) if fe == "auto" else ()
        fixed[fe] = counted(f"fixed {fe}", lambda: run(proc, f"fixed_{fe}",
                                                       frames), need)
    (ra, da, ta), (rp, dp_, tp_) = fixed["auto"], fixed["plain"]
    same_logs = (da.read_bytes() == dp_.read_bytes()
                 and ta.read_bytes() == tp_.read_bytes())
    sa, sp_ = ra[-1].tracker_state, rp[-1].tracker_state
    same_state = all(np.array_equal(sa[k], sp_[k]) for k in sa)
    n_fixed = sum(r.n_dets for r in ra)
    log(f"surveillance fixed: kernel route vs plain route over {len(ra)} "
        f"scans: logs {'byte-identical' if same_logs else 'DIFFER'} "
        f"({da.stat().st_size} + {ta.stat().st_size} bytes), final state "
        f"{'equal' if same_state else 'DIFFERS'}, {n_fixed} detections, "
        f"{ra[-1].active_tracks} active tracks")
    if not (same_logs and same_state and len(ra) == SURV_SCANS):
        raise AssertionError("surveillance fixed: the kernel route differs "
                             "from the plain route")

    # The float main path, timed, with the batches' health lines.
    proc = pl.make_batch_processor(p, peak_group_radius=2,
                                   include_maps=False, device=dev)
    run(proc, "warm", frames[:SURV_BATCH])             # capture, warm up
    health = []
    t0 = time.perf_counter()
    res, d_full, t_full = counted(
        "float", lambda: run(proc, "float", frames, health=health.append),
        ("range_fft", "slowtime_detect"))
    loop_s = time.perf_counter() - t0
    final = res[-1].tracker_state
    held = firm_ranges(final)
    truth = sorted({tr for tr, _, _ in data[-1][1]})
    log(f"surveillance float: {len(res)} scans, "
        f"{sum(r.n_dets for r in res)} detections, {res[-1].active_tracks} "
        f"active tracks; firm tracks at range bins {held}; targets at "
        f"{truth}")
    for tr in truth:
        if not any(abs(h - tr) <= 3 for h in held):
            raise AssertionError(f"surveillance float: no firm track near "
                                 f"the target at range bin {tr}")
    for line in health:
        log(f"  {line}")

    # Resume from a checkpoint after scan 24.
    half = SURV_SCANS // 2
    d_r, t_r = out_dir / "resumed_det.txt", out_dir / "resumed_trk.txt"
    first, _, _ = run(proc, "resumed", frames[:half])
    ck_path = str(out_dir / "checkpoint.npz")
    ck.save(ck_path, first[-1].tracker_state, scan_index=first[-1].scan,
            runtime_state=ck.log_positions(str(d_r), str(t_r)))
    with open(d_r, "a") as fh:                 # a crashed batch's tail
        fh.write("0 0 0\n")
    state, scan, _, rt = ck.load(ck_path)
    ck.restore_logs(rt, str(d_r), str(t_r))
    rest, _, _ = run(proc, "resumed", frames[scan:], tracker_state=state,
                     start_scan=scan)
    same_logs = (d_r.read_bytes() == d_full.read_bytes()
                 and t_r.read_bytes() == t_full.read_bytes())
    fr = rest[-1].tracker_state
    same_state = all(np.array_equal(fr[k], final[k]) for k in final)
    log(f"surveillance resume after scan {scan}: logs "
        f"{'byte-identical' if same_logs else 'DIFFER'} to the unbroken "
        f"run, final state {'equal' if same_state else 'DIFFERS'}")
    if not (same_logs and same_state and rest[-1].scan == SURV_SCANS):
        raise AssertionError("surveillance: the resumed run differs")

    # The array model.
    scen = sc.TacticalScenario(p, sc.ScenarioConfig(
        num_scans=ARRAY_SURV_SCANS, burst_synthesis=False))
    cubes = [pl.complex_to_iq(f)
             for _, f, _ in scen.run_elements(n_elems=N_ELEMS)]
    aproc = pl.make_batch_array_processor(
        p, n_elems=N_ELEMS, n_beams=N_BEAMS, peak_group_radius=2,
        beam_group_radius=1, include_maps=False, device=dev)
    ares, _, _ = counted("array", lambda: run(aproc, "array", cubes),
                         ("range_fft_float", "slowtime_detect",
                          "beam_group"))
    log(f"surveillance array: {len(ares)} scans, "
        f"{sum(r.n_dets for r in ares)} detections, "
        f"{ares[-1].active_tracks} active tracks")
    if not (len(ares) == ARRAY_SURV_SCANS and ares[-1].active_tracks > 0
            and all(r.n_dets > 0 for r in ares)):
        raise AssertionError("surveillance array: no detections or tracks")

    # Streaming on the main path against a plain loop.
    one = pl.make_processor(p, peak_group_radius=2, include_maps=False,
                            device=dev)
    sub = frames[:SURV_SCANS // 2]
    plain = [one(torch.as_tensor(f, device=dev)) for f in sub]

    def same(a, b):
        return a.keys() >= b.keys() and all(torch.equal(a[k], b[k])
                                            for k in b)

    def slow(x, **kw):
        """The processor on a card slower than the source: each frame's
        work is followed by DROP_SLEEP_CYCLES of device time."""
        out = one(x, **kw)
        torch.cuda._sleep(DROP_SLEEP_CYCLES)
        return out

    def paced(fs):
        for f in fs:                        # a frame every DROP_PACE_S
            time.sleep(DROP_PACE_S)
            yield f

    stream_stats = {}
    for policy in ("block", "drop"):
        stats = rs.StreamStats()
        # "drop" overloads the window, so that the Event.query readiness
        # test and the drop branch run on the card.
        fn, src = (one, sub) if policy == "block" else (slow, paced(sub))
        t0 = time.perf_counter()
        outs = counted(f"stream {policy}", lambda: list(rs.stream(
            fn, src, depth=2, policy=policy, stats=stats, device=dev)),
            ("range_fft", "slowtime_detect"))
        frame_ms = (time.perf_counter() - t0) * 1e3 / len(sub)
        j = 0                       # the outputs, in order, among the plain
        for o in outs:
            while j < len(plain) and not same(o, plain[j]):
                j += 1
            if j == len(plain):
                raise AssertionError(f"stream {policy}: an output out of "
                                     f"order or unequal to the plain loop")
            j += 1
        ok = (stats.frames_in == len(sub)
              and stats.frames_processed == len(outs)
              and stats.frames_processed + stats.frames_dropped == len(sub)
              and (len(outs) == len(sub) if policy == "block"
                   else 0 < stats.frames_dropped < len(sub)))
        stream_stats[policy] = dict(vars(stats), ms_per_frame=frame_ms)
        log(f"stream {policy}: {vars(stats)}, {frame_ms:.4f} ms a frame "
            f"(host clock), outputs in order and equal to the plain loop")
        if not ok:
            raise AssertionError(f"stream {policy}: accounting is off")
    stats = rs.StreamStats()
    n_in = 2 * SURV_BATCH + SURV_BATCH // 2     # a padded last batch
    sub = frames[:n_in]
    bouts = counted("stream_batched", lambda: list(rs.stream_batched(
        proc, sub, SURV_BATCH, depth=2, stats=stats, device=dev)),
        ("range_fft", "slowtime_detect"))
    for i, o in enumerate(bouts):
        chunk = sub[i * SURV_BATCH:(i + 1) * SURV_BATCH]
        chunk = chunk + [np.zeros_like(chunk[0])] * (SURV_BATCH - len(chunk))
        if not same(o, proc(torch.as_tensor(np.stack(chunk), device=dev))):
            raise AssertionError("stream_batched: a batch differs")
    if ([o["batch_valid"] for o in bouts]
            != [SURV_BATCH, SURV_BATCH, SURV_BATCH // 2]
            or stats.frames_processed != n_in or stats.frames_in != n_in):
        raise AssertionError("stream_batched: padding or accounting is off")
    stream_stats["batched"] = vars(stats)
    log(f"stream_batched: {vars(stats)}, batch_valid "
        f"{[o['batch_valid'] for o in bouts]}, equal to the processor")

    # Timings: the frame batch (dispatch + readback, host clock) and the
    # tracker per batch of 16 scans (graph replays; an eager loop beside).
    batch = np.stack(frames[:SURV_BATCH])

    def frame_batch():
        out = proc(batch)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def host_ms(fn, n):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / n

    frame_ms = host_ms(frame_batch, 10)
    frame_event_ms = cuda_ms(
        lambda: proc(torch.as_tensor(batch, device=dev)), 10)
    out = frame_batch()
    dets = (out["range_bin"], out["doppler_bin"],
            out["mag"].astype(np.int32), out["valid"])
    st0 = trk.state_from_numpy(final, dev)
    tracker_ms = host_ms(lambda: trk.run_scans(*dets, tp=p.tracker,
                                               state=st0), 5)

    def eager():
        s, reps = st0, []
        for i in range(SURV_BATCH):
            s, r = trk.step(s, *(torch.as_tensor(x[i], device=dev)
                                 for x in dets), tp=p.tracker)
            reps.append(r)
        return s, reps

    eager_ms = host_ms(eager, 2)
    g, g_reps = trk.run_scans(*dets, tp=p.tracker, state=st0)
    e, e_reps = eager()
    e_reps = {k: torch.stack([r[k] for r in e_reps]) for k in e_reps[0]}
    if not (all(torch.equal(g[k], e[k]) for k in g)
            and g_reps.keys() == e_reps.keys()
            and all(torch.equal(g_reps[k], e_reps[k]) for k in e_reps)):
        raise AssertionError("tracker: the CUDA graph's state or reports "
                             "differ from step's")
    log(f"tracker: the CUDA graph's final state and {SURV_BATCH} scans' "
        f"reports equal an eager loop of step")
    batch_s = [float(h.split("batch_s=")[1].split()[0]) for h in health]
    summary = {
        "scans": SURV_SCANS, "batch_scans": SURV_BATCH,
        "scans_per_s": SURV_SCANS / loop_s,
        "frame_batch_ms": frame_ms, "frame_batch_event_ms": frame_event_ms,
        "tracker_ms_per_batch": tracker_ms,
        "tracker_ms_per_scan": tracker_ms / SURV_BATCH,
        "tracker_eager_ms_per_batch": eager_ms,
        "health_batch_s": batch_s,
        "stream": stream_stats, "card": card}
    log(f"surveillance loop: {summary['scans_per_s']:.1f} scans/s over "
        f"{SURV_SCANS} scans ({loop_s * 1e3:.1f} ms, logs included); per "
        f"batch of {SURV_BATCH}: frame batch {frame_ms:.4f} ms (copy in, "
        f"dispatch and readback, host clock; {frame_event_ms:.4f} ms by CUDA "
        f"events, the copy in included), tracker "
        f"{tracker_ms:.4f} ms ({tracker_ms / SURV_BATCH:.4f} ms a scan, "
        f"graph replays; eager step loop {eager_ms:.4f} ms) ({card})")
    return summary


# ---------------------------------------------------------------------------
# The hw-compat streaming CFAR (cfar_geometry="hw_stream")
# ---------------------------------------------------------------------------

HW_CASE_BATCH = 16              # frames of each kernel-against-twin case
HW_SCANS = 48


def hw_geometries():
    """(name, CfarParams) of the flat-stream cases: the default window
    (crossed: 5 rows x 6 lanes, lag 774 at 1024x128), the QUICK window
    (tests/test_hw_compat.py's) and one with a zero lane halo."""
    import fmcw_tpu_torch as P
    return (("full", P.CfarParams()),
            ("quick", P.quick().cfar),
            ("zero halo", P.CfarParams(ref_range=0, ref_doppler=2,
                                       guard_range=0, guard_doppler=1)))


def recorded(fn, calls: list):
    """A decision function for ops/cfar.cfar_2d_hw_stream that records each
    call's arguments and results in ``calls``."""
    def decide(ext, start0, R, D, so, **kw):
        out = fn(ext, start0, R, D, so, **kw)
        calls.append(((ext, start0, R, D, so), kw, out))
        return out
    return decide


def hw_stream_case(what: str, mag, so: int, cfar) -> float:
    """The flat-stream entry against its twin on a batch of maps in the
    three framings (one-shot, the stream's first frame, carried: each
    frame's history the previous frame's tail, the first's the last's):
    the raw decisions (det and scale of every cell, decision order) and
    the framed outputs (det at label coordinates, scale, new_hist) bit for
    bit, or raises.  Returns the largest |difference| (0)."""
    import torch
    from fmcw_tpu_torch.golden.fixed_point import hw_stream_lag
    from fmcw_tpu_torch.ops import cfar as C, cfar_detect as CD
    integer = not mag.is_floating_point()
    B, R, D = mag.shape
    lag = hw_stream_lag(cfar, D)
    hist = torch.roll(mag.reshape(B, -1)[:, -2 * lag:], 1, 0).contiguous()
    err, ndet = 0.0, 0
    for framing, kw in (("one-shot", {}), ("first", dict(streaming=True)),
                        ("carried", dict(streaming=True, hist=hist))):
        calls = {"kernel": [], "twin": []}
        outs = {name: C.cfar_2d_hw_stream(
            mag, so, cfar=cfar, integer=integer,
            decide=recorded(fn, calls[name]), **kw)
            for name, fn in (("kernel", CD.cfar_detect_hw_stream),
                             ("twin", C.hw_stream_decide_plain))}
        torch.cuda.synchronize()
        pairs = [(a, b) for a, b in zip(calls["kernel"][0][2],
                                        calls["twin"][0][2])]
        pairs += [(a, b) for a, b in zip(outs["kernel"], outs["twin"])
                  if a is not None]
        same = all(bits_equal(a, b) for a, b in pairs)
        err = max([err] + [float((a.double() - b.double()).nan_to_num()
                                 .abs().max()) for a, b in pairs])
        ndet = int((outs["kernel"][0] != 0).sum())
        if not same:
            raise AssertionError(f"cfar_detect_hw_stream ({what}, {framing}, "
                                 f"so={so}) disagrees with its twin")
    log(f"cfar_detect_hw_stream {what} {tuple(mag.shape)} {mag.dtype} so={so}"
        f" (crossed hr {cfar.halo_doppler} hd {cfar.halo_range}), one-shot /"
        f" first / carried: bit-identical ({ndet} detections carried)")
    return err


def hw_stream_cases(dev):
    """Phase 27a: the flat-stream entry of csrc/cfar_detect.cu (TPU row 7,
    prepadded_range="both") against its twin: int32 maps (the fixed
    chain's) and float32 maps (the float fused route's) at 1024x128, 16
    frames, the full, QUICK and zero-halo windows, override 0 and 3, the
    three framings; adversarial maps (NaN, Inf, -0.0, ties, int32 keys up
    to +-2^31), a zero map and spikes at each frame's first and last 3
    cells (the startup skip and the tail); and each of the entry's other
    variants: a window walked at run time, n_ref 4216, 4096 columns.  Returns ({row: largest
    |difference|}, the int32 and float32 maps)."""
    import numpy as np
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.golden.reference import rank_adversarial_maps
    from fmcw_tpu_torch.models import pipeline as pl
    p = P.RadarParams()
    iq = torch.as_tensor(make_batch(p, HW_CASE_BATCH, seed=6), device=dev)
    imag = pl.make_batch_processor(p, mode="fixed", device=dev)(iq)["mag_map"]
    fmag = pl.make_batch_processor(p, device=dev)(iq)["mag_map"]
    errs = {}
    full = p.cfar
    gen = np.random.default_rng(27)
    for mag in (imag, fmag):
        name = f"cfar_detect_hw_stream[{str(mag.dtype)[6:]}]"
        integer = not mag.is_floating_point()
        spikes = gen.exponential(500.0, (4, p.n_range, p.n_doppler))
        flat = spikes.reshape(4, -1)
        flat[:, :3] = flat[:, -3:] = 4e4
        cases = [(g, mag, cfar, so) for g, cfar in hw_geometries()
                 for so in (0, 3)]
        cases += [("adversarial", torch.as_tensor(rank_adversarial_maps(
                      (4, p.n_range, p.n_doppler), integer, 17), device=dev),
                   full, 0),
                  ("zero map", torch.zeros_like(mag[:2]), full, 3),
                  ("spikes at the ends", torch.as_tensor(spikes.astype(
                      np.int32 if integer else np.float32), device=dev),
                   full, 0)]
        # The variants the windows above do not reach: a crossed window
        # of 4 rows with guard 2 (its rows walked at run time), n_ref 4216
        # (hi and lo counted apart) and 4096 columns (strips of one cell).
        noise = gen.exponential(500.0, (2, 128, 4096))
        noise[..., 3:5, 7:9] = 4e4
        dt = np.int32 if integer else np.float32
        cases += [("hr 4 gr 2", mag[:4], P.CfarParams(
                      ref_range=3, ref_doppler=2, guard_range=1,
                      guard_doppler=2), 0),
                  ("n_ref 4216", mag[:2, :256], P.CfarParams(
                      ref_range=31, ref_doppler=31, guard_range=1,
                      guard_doppler=1), 3),
                  ("4096 columns", torch.as_tensor(noise.astype(dt),
                                                   device=dev), full, 0)]
        for what, m, cfar, so in cases:
            errs[name] = max(errs.get(name, 0.0),
                             hw_stream_case(what, m, so, cfar))
    return errs, imag, fmag


def golden_hw_labels(job):
    """The golden hw-stream CFAR's label-coordinate detections of one map
    (a worker process's job: (map, CfarParams))."""
    from fmcw_tpu_torch.golden.fixed_point import os_cfar_2d_hw_stream
    mag, cfar = job
    return sorted(zip(*(a.tolist() for a in os_cfar_2d_hw_stream(mag,
                                                                 cfar))))


def hw_stream_main_path(card: str, dev):
    """Phase 27b: make_batch_processor(cfar_geometry="hw_stream") at batch
    128: fixed "auto" (the FP64 stages, then the flat-stream entry), its
    label-coordinate detection sets and n_dets equal to the golden
    os_cfar_2d_hw_stream on the same magnitudes frame by frame (the golden
    model in worker processes); float "fused" (kernel A, the magnitude-only
    entry of kernel B, the flat-stream entry), its det maps equal to the
    twin's on the route's own magnitudes.  Returns the launches."""
    import concurrent.futures as cf
    import multiprocessing as mp
    import os
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch import kernels
    from fmcw_tpu_torch.models import pipeline as pl
    from fmcw_tpu_torch.ops import cfar as C
    p = P.RadarParams()
    iq = torch.as_tensor(make_batch(p, BATCH, seed=7), device=dev)
    launches = {}
    for mode, need in (("fixed", ("cfar_detect_hw_stream",)),
                       ("float32", ("range_fft", "slowtime_mag",
                                    "cfar_detect_hw_stream"))):
        proc = pl.make_batch_processor(p, mode=mode,
                                       cfar_geometry="hw_stream", device=dev)
        kernels.reset_launch_counts()
        out = proc(iq)
        torch.cuda.synchronize()
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        launches[mode] = counts
        log(f"hw_stream {mode} main path: launches "
            + ", ".join(f"{k}={v}" for k, v in counts.items()))
        missing = [k for k in need if not counts.get(k)]
        if missing:
            raise AssertionError(f"hw_stream {mode} skipped {missing}")
        mag = out["mag_map"]
        if mode == "fixed":
            t0 = time.perf_counter()
            ctx = mp.get_context("spawn")
            with cf.ProcessPoolExecutor(min(8, os.cpu_count() or 1),
                                        mp_context=ctx) as pool:
                want = list(pool.map(golden_hw_labels,
                                     [(m, p.cfar) for m in
                                      mag.cpu().numpy()]))
            det = out["det_map"].cpu().numpy()
            n = out["n_dets"].cpu().numpy()
            bad = []
            for b, w in enumerate(want):
                r, d = det[b].nonzero()
                got = sorted(zip(r.tolist(), d.tolist(),
                                 det[b][r, d].tolist()))
                if got != w or int(n[b]) != len(w):
                    bad.append(b)
            log(f"hw_stream fixed auto, batch {BATCH}: detection sets and "
                f"n_dets vs the golden hw-stream CFAR: "
                f"{'equal' if not bad else f'DIFFER in frames {bad[:8]}'} "
                f"on every frame ({sum(map(len, want))} detections; golden "
                f"{time.perf_counter() - t0:.1f} s)")
            if bad:
                raise AssertionError("hw_stream fixed auto differs from the "
                                     "golden model")
        else:
            det, _, _ = C.cfar_2d_hw_stream(mag, cfar=p.cfar, integer=False)
            same = bits_equal(det, out["det_map"])
            log(f"hw_stream float fused, batch {BATCH}: det maps vs the twin "
                f"on the route's magnitudes: "
                f"{'bit-identical' if same else 'DIFFER'} "
                f"({int((det != 0).sum())} detections)")
            if not same:
                raise AssertionError("hw_stream float fused differs from the "
                                     "twin")
    return launches


def hw_stream_runner(card: str, dev):
    """Phase 27c: run_surveillance_stream over 48 consecutive fixed-mode
    CPIs of TacticalScenario at 1024x128 (peak_group_radius 2), read back
    through the port's FileFrameStreamer from raw int16 files in a
    temporary directory: the kernel route ("auto") and the plain route
    byte-identical logs; a run checkpointed after scan 24 (tracker state,
    scan counter, stream_hist in runtime_state) and resumed logs
    byte-identical to the unbroken run; both target groups end in firm
    tracks.  Returns (scans/s of the kernel route's unbroken run, the
    launches of that run)."""
    import tempfile
    from pathlib import Path
    import numpy as np
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch import kernels
    from fmcw_tpu_torch.models import pipeline as pl, scenario as sc
    from fmcw_tpu_torch.runtime import native, surveillance as sv
    from fmcw_tpu_torch.utils import checkpoint as ck
    p = P.RadarParams()
    scen = sc.TacticalScenario(p, sc.ScenarioConfig(num_scans=HW_SCANS,
                                                    burst_synthesis=False))
    data = [(pl.complex_to_iq(f), truth) for _, f, truth in scen.run()]
    frames = np.stack([f for f, _ in data])
    half = HW_SCANS // 2
    shape = frames.shape[1:]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for name, part in (("all", frames), ("head", frames[:half]),
                           ("tail", frames[half:])):
            part.tofile(tmp / f"{name}.bin")

        def streamed(name):
            s = native.FileFrameStreamer(str(tmp / f"{name}.bin"), shape)
            try:
                yield from s.frames()
            finally:
                s.close()

        def run(frontend, name, tag, **kw):
            proc = pl.make_processor(p, mode="fixed", frontend=frontend,
                                     cfar_geometry="hw_stream",
                                     peak_group_radius=2, include_maps=False,
                                     device=dev)
            d, t = tmp / f"{tag}_det.txt", tmp / f"{tag}_trk.txt"
            res = list(sv.run_surveillance_stream(
                proc, streamed(name), p, det_log=str(d), trk_log=str(t),
                device=dev, **kw))
            return res, d, t

        run("auto", "head", "warm")                 # capture, warm up
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        full, d_full, t_full = run("auto", "all", "auto")
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        log(f"hw_stream runner: launches "
            + ", ".join(f"{k}={v}" for k, v in counts.items()))
        if counts.get("cfar_detect_hw_stream", 0) < HW_SCANS:
            raise AssertionError("hw_stream runner skipped the flat-stream "
                                 "entry")
        plain, d_p, t_p = run("plain", "all", "plain")
        same_plain = (d_full.read_bytes() == d_p.read_bytes()
                      and t_full.read_bytes() == t_p.read_bytes())
        first, d_r, t_r = run("auto", "head", "resumed")
        ck_path = str(tmp / "checkpoint.npz")
        ck.save(ck_path, first[-1].tracker_state, scan_index=first[-1].scan,
                runtime_state={"stream_hist": first[-1].stream_hist,
                               **ck.log_positions(str(d_r), str(t_r))})
        with open(d_r, "a") as fh:                 # a crashed scan's tail
            fh.write("0 0 0\n")
        state, scan, _, rt = ck.load(ck_path)
        ck.restore_logs(rt, str(d_r), str(t_r))
        rest, _, _ = run("auto", "tail", "resumed", tracker_state=state,
                         stream_hist=rt["stream_hist"], start_scan=scan)
        same_resume = (d_r.read_bytes() == d_full.read_bytes()
                       and t_r.read_bytes() == t_full.read_bytes())
        n_bytes = d_full.stat().st_size + t_full.stat().st_size
    final = full[-1].tracker_state
    held = firm_ranges(final)
    truth = sorted({tr for tr, _, _ in data[-1][1]})
    ok_tracks = all(any(abs(h - tr) <= 3 for h in held) for tr in truth)
    same_state = all(np.array_equal(rest[-1].tracker_state[k], final[k])
                     for k in final)
    log(f"hw_stream runner: {len(full)} scans from FileFrameStreamer, "
        f"{sum(r.n_dets for r in full)} detections, {full[-1].active_tracks} "
        f"active tracks, firm tracks at range bins {held} (targets {truth}); "
        f"kernel vs plain route logs "
        f"{'byte-identical' if same_plain else 'DIFFER'} ({n_bytes} bytes); "
        f"resumed after scan {scan} with stream_hist: logs "
        f"{'byte-identical' if same_resume else 'DIFFER'}, final state "
        f"{'equal' if same_state else 'DIFFERS'}")
    if not (same_plain and same_resume and same_state and ok_tracks
            and len(full) == len(plain) == HW_SCANS
            and rest[-1].scan == HW_SCANS):
        raise AssertionError("hw_stream runner: logs, resume or tracks off")
    return HW_SCANS / loop_s, counts


def hw_stream_phase(card: str, dev):
    """Phase 27: the hw-compat streaming CFAR on the card (27a-c above),
    then 27d, timings at batch 128: the flat-stream entry by graph replay
    and eager beside its bound (bound_cfar_detect with the crossed window)
    and its twin; the hw-stream batch route's frames/s (fixed "auto" and
    float "fused", peak_group_radius 2) with the plain grouping's share;
    process.stream's ms a CPI; the runner's scans/s.  Returns (kernel
    rows, summary)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.models import pipeline as pl
    from fmcw_tpu_torch.ops import cfar as C, cfar_detect as CD
    t0 = time.perf_counter()
    errs, _, _ = hw_stream_cases(dev)
    t1 = time.perf_counter()
    launches = hw_stream_main_path(card, dev)
    t2 = time.perf_counter()
    scans_per_s, runner_launches = hw_stream_runner(card, dev)
    t3 = time.perf_counter()
    log(f"hw_stream phase: 27a {t1 - t0:.1f} s, 27b {t2 - t1:.1f} s, 27c "
        f"{t3 - t2:.1f} s")
    p = P.RadarParams()
    nd, nr = p.n_doppler, p.n_range
    iq = torch.as_tensor(make_batch(p, BATCH, seed=7), device=dev)
    rows, fps, group_ms, entry = [], {}, {}, {}
    for mode, route in (("fixed", "auto"), ("float32", "fused")):
        proc = pl.make_batch_processor(p, mode=mode, frontend=route,
                                       cfar_geometry="hw_stream",
                                       peak_group_radius=2,
                                       include_maps=True, device=dev)
        out = proc(iq)
        mag = out["mag_map"]
        integer = mode == "fixed"
        calls = []
        det, _, _ = C.cfar_2d_hw_stream(
            mag, cfar=p.cfar, integer=integer, label_roll=False,
            decide=recorded(CD.cfar_detect_hw_stream, calls))
        (ext, start0, R, D, _), _, _ = calls[0]
        kw = dict(cfar=p.cfar, integer=integer)
        ms = graph_ms(lambda: CD.cfar_detect_hw_stream(ext, start0, R, D, 0,
                                                       **kw))
        eager = cuda_ms(lambda: CD.cfar_detect_hw_stream(ext, start0, R, D, 0,
                                                         **kw))
        plain = cuda_ms(lambda: C.hw_stream_decide_plain(ext, start0, R, D,
                                                         0, **kw), 2, 1)
        in_float = not integer or int(mag.abs().max()) <= CD.float_max(
            C.hw_stream_params(p.cfar))
        bound, by = bound_cfar_detect(BATCH, nr, nd,
                                      C.hw_stream_params(p.cfar), in_float)
        name = f"cfar_detect_hw_stream[{str(mag.dtype)[6:]}]"
        log(f"{name} ({mag.dtype} maps, counted in "
            f"{'float' if in_float else 'int'}; ext streams of "
            f"{ext.shape[-1]} cells): {ms:.4f} ms (graph; eager "
            f"{eager:.4f}), plain {plain:.4f} ms, bound {bound:.4f} ms ({by}) "
            f"at batch {BATCH} ({card})")
        rows.append(dict(name=name, route="cuda",
                         source="fmcw_tpu_torch/csrc/cfar_detect.cu",
                         replaces="fmcw_tpu/ops/cfar_pallas.py:155",
                         launches=launches[mode].get("cfar_detect_hw_stream",
                                                     0),
                         max_abs_err=errs[name], ms=ms, plain_ms=plain,
                         bound_ms=bound, bound_by=by, library_ms=None))
        entry[name] = {"graph_ms": ms, "eager_ms": eager}
        path = pl.make_batch_processor(p, mode=mode, frontend=route,
                                       cfar_geometry="hw_stream",
                                       peak_group_radius=2,
                                       include_maps=False, device=dev)
        path_ms = cuda_ms(lambda: path(iq), 5)
        fps[f"{mode}/{route}"] = BATCH * 1e3 / path_ms
        shift = C.hw_stream_label_shift(p.cfar, nd, False)
        group_ms[f"{mode}/{route}"] = cuda_ms(lambda: torch.roll(
            C.peak_group(det, 2).reshape(BATCH, -1), -shift, dims=-1))
        log(f"hw_stream {mode} {route} route, peak_group_radius 2: "
            f"{fps[f'{mode}/{route}']:.1f} frames/s at batch {BATCH} "
            f"({path_ms:.4f} ms a batch; the plain grouping and roll "
            f"{group_ms[f'{mode}/{route}']:.4f} ms, "
            f"{100 * group_ms[f'{mode}/{route}'] / path_ms:.0f}%) ({card})")
    one = pl.make_processor(p, mode="fixed", cfar_geometry="hw_stream",
                            peak_group_radius=2, include_maps=False,
                            device=dev)
    frame = iq[0]
    _, hist = one.stream(frame)
    stream_ms = cuda_ms(lambda: one.stream(frame, hist=hist), 10)
    log(f"hw_stream process.stream (fixed auto): {stream_ms:.4f} ms a CPI; "
        f"run_surveillance_stream {scans_per_s:.1f} scans/s ({card}); 27d "
        f"{time.perf_counter() - t3:.1f} s")
    return rows, {"frames_per_s": fps, "grouping_ms": group_ms,
                  "entry": entry, "stream_ms_per_cpi": stream_ms,
                  "runner_scans_per_s": scans_per_s,
                  "launches": launches, "runner_launches": runner_launches}


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
    log_build(kernels.build_info)

    entry = P.RadarParams()
    block = P.fast()
    pgr = 2
    results = {}
    if "--nccl-only" in sys.argv[1:]:
        # Phase 19 alone, for a multi-GPU machine: the NCCL mesh against
        # the single GPU, nothing else.
        summary = nccl_phase(card, pgr)
        if summary is None:
            raise AssertionError("--nccl-only needs two or more GPUs")
        log(json.dumps({"nccl": summary, "card": card}))
        return 0

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
    range_fft_size_checks(dev)

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
    # The other map shapes the kernels take (n_doppler 16, 32 and 64), both
    # scale modes, the 3-pulse MTI with the passthrough transient and the
    # exact magnitude, the bypass and the override, grouping radii 0-2.
    b16 = P.RadarParams(n_range=256, n_doppler=16)
    for p, radius, kw, bypass, so in (
            (P.quick(), 1, {}, False, 0),
            (P.quick().replace(cfar=dataclasses.replace(
                P.quick().cfar, scale_mode="block")), 0, {}, True, 4),
            (P.RadarParams(n_range=256, n_doppler=64), pgr, {}, False, 0),
            (P.RadarParams(n_range=256, n_doppler=64, notch_mode=3), pgr,
             dict(transient="passthrough", exact_mag=True), False, 0),
            (P.RadarParams(n_range=256, n_doppler=64, notch_mode=3), 1,
             dict(transient="zero"), False, 4),
            (b16, 0, {}, False, 0),
            (b16.replace(cfar=dataclasses.replace(b16.cfar,
                                                  scale_mode="block")),
             pgr, {}, False, 0),
            (b16, 1, dict(transient="passthrough"), True, 4),
            # A window outside the unrolled walks (hr 4, gr 1).
            (P.RadarParams(n_range=256, n_doppler=64, cfar=P.CfarParams(
                ref_range=3, ref_doppler=2, guard_range=1,
                guard_doppler=2)), pgr, {}, False, 0)):
        iq = torch.as_tensor(make_batch(p, 4, seed=2), device=dev)
        sre, sim = F.range_fft(iq)
        pre, pim = F.range_fft_plain(iq)
        det, mag, rmax, ndet, nf = F.slowtime_detect(
            sre, sim, bypass, so, cfar=p.cfar, notch_mode=p.notch_mode,
            peak_group_radius=radius, emit_mag=True, **kw)
        pmag = F.slowtime_mag_plain(sre, sim, bypass, p.notch_mode, **kw)
        d2, r2, n2, f2 = F.detect_plain(mag, p.cfar, so, radius)
        torch.cuda.synchronize()
        err_a = float(torch.maximum((sre - pre).abs().max(),
                                    (sim - pim).abs().max()))
        err_b = float((mag - pmag).abs().max())
        same = (torch.equal(det, d2) and torch.equal(rmax, r2)
                and torch.equal(ndet, n2) and torch.equal(nf, f2))
        log(f"kernels at {p.n_range}x{p.n_doppler} notch {p.notch_mode} "
            f"{p.cfar.scale_mode} pgr={radius} bypass={bypass} so={so} "
            f"{kw}: A err {err_a / float(pre.abs().max()):.3g}, B mag err "
            f"{err_b / float(pmag.abs().max()):.3g} of peak, decision "
            f"{'bit-identical' if same else 'DIFFERS'}")
        if not (err_a <= TOL * float(torch.maximum(pre.abs().max(),
                                                   pim.abs().max()))
                and err_b <= TOL * float(pmag.abs().max()) and same):
            raise AssertionError(f"kernels disagree at {p.n_range}x"
                                 f"{p.n_doppler} {kw}")
    tie_checks(dev, entry, block, pgr)

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
        # The plain route's exact taps (cfar_rank_bits=None): the order
        # statistic the counting kernels decide against.
        ref = pl.make_processor(p, peak_group_radius=pgr, frontend="plain",
                                include_debug=True, cfar_rank_bits=None,
                                device=dev)(batch[0])
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
    ms_a = graph_ms(lambda: F.range_fft(batch))
    plain_a = cuda_ms(lambda: F.range_fft_plain(batch), 5)
    win = torch.as_tensor(hamming_float(nr), device=dev)
    zw = torch.complex(batch[..., 0].float() * win, batch[..., 1].float() * win)
    lib_a = graph_ms(lambda: torch.fft.fft(zw, dim=-1))
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
        ms_b = graph_ms(lambda: F.slowtime_detect(re, im, False, 0, **kw))
        eager_b = cuda_ms(lambda: F.slowtime_detect(re, im, False, 0, **kw))
        plain_b = cuda_ms(
            lambda: F.slowtime_detect_plain(re, im, False, 0, **kw), 2, 1)
        b_b, by_b = bound_slowtime(BATCH, nr, nd, p.cfar)
        results[name].update(ms=ms_b, plain_ms=plain_b, library_ms=None,
                             bound_ms=b_b, bound_by=by_b)
        log(f"{name}: {ms_b:.4f} ms (graph; eager {eager_b:.4f}), plain "
            f"{plain_b:.4f} ms, bound {b_b:.4f} ms ({by_b}) at batch "
            f"{BATCH} ({card})")
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

    # 12-15. The array model: kernels, main path, timings.
    array_rows, array_summary = array_model(card, dev)

    # 16-19. The sharded frame processor: the split entries (TPU rows 3-6)
    #        on one card, the processor on a LocalMesh, timings, and the
    #        NCCL mesh when two or more GPUs are visible.
    split_errs, split_iq = split_kernel_checks(dev, pgr)
    split_launches, split_fps = split_main_path(card, dev, pgr)
    split_rows = split_timings(card, dev, pgr, split_iq, split_errs,
                               split_launches)
    nccl = nccl_phase(card, pgr)

    # 20-25. Row 9 (the debug taps' rank select) against its twin, the
    #        debug-tap processors, the sharded debug taps, row 9's timings;
    #        the sharded array model's kernel entries and the model on a
    #        LocalMesh.
    rank_errs, fmag, imag = rank_kernel_checks(dev)
    rank_launches, debug_fps = debug_main_path(card, dev, pgr)
    sharded_debug_fps = sharded_debug_path(card, dev, pgr, rank_launches)
    rank_rows, rank_summary = rank_timings(card, dev, fmag, imag, rank_errs,
                                           rank_launches)
    del fmag, imag
    entry_rows = shard_entry_checks(card, dev)
    sa_launches, sa_cubes_per_s = sharded_array_main_path(card, dev)
    for row in entry_rows:
        row["launches"] = sa_launches[row["name"]]

    # 26. The surveillance runtime on the card.
    surveillance = surveillance_phase(card, dev)

    # 27. The hw-compat streaming CFAR: the flat-stream entry against its
    #     twin, the hw-stream routes and the streaming runner, timings.
    log(f"phases 1-26: {time.perf_counter() - t_start:.1f} s")
    hw_rows, hw_summary = hw_stream_phase(card, dev)

    # 28. The kernels line.
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
    rows += (fixed_rows + array_rows + split_rows + rank_rows + entry_rows
             + hw_rows)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows],
                    "frames_per_s": frames_per_s, "stages_ms": stages,
                    "fixed": fixed_summary, "array": array_summary,
                    "split": {"frames_per_s": split_fps,
                              "sp": list(SPLIT_SPS)},
                    "debug": {"frames_per_s": debug_fps,
                              "sharded_frames_per_s": sharded_debug_fps,
                              "cfar_rank": rank_summary},
                    "sharded_array": {"cubes_per_s": sa_cubes_per_s,
                                      "cubes": ARRAY_BATCH,
                                      "sp": list(SPLIT_SPS)},
                    "nccl": nccl,
                    "surveillance": surveillance,
                    "hw_stream": hw_summary,
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
