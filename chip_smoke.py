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
logging byte-identically, firm tracks), and timings.  Then the CA/GO/SO
CFAR variants (phase 28): kernel B's mean epilogue against its twin bit
for bit on the kernel's magnitudes (batch 128 of 1024x128, two-target and
noise batches, per-cell and block, override, MTI bypass, grouping radius
0 and 2; the small shapes of phase 3; NaN and Inf planes) and its split
entry at sp 2 and 4 against the whole-frame entry; every route of each
variant at batch 128 (float auto, staged, debug taps against the margin
gate; fixed auto against the golden model on all 128 frames, in worker
processes), the array model (2D, 3D at ref_angle 1) against the array
gate, a LocalMesh at sp 2 against the single card; the Pd/Pfa sweep of
the four variants (utils/eval.pd_pfa, 16 trials a SNR, kernel and plain
routes; pd_pfa_3d); then the fixed slow-time kernel's CA/GO/SO
instantiation (28f) against its twin bit for bit (full width per-cell and
block, overrides 0, 6 and 2^20, the MTI bypassed, grouping radii 0-2, the
saturating batch, n_doppler 16-64, the 3-pulse MTI, a 17x23 window; its
split entry at sp 2 and 4) and the fused fixed route of each variant
(28g: bit-equal to fixed auto, its det maps equal to the golden model on
all 128 frames, no plain stage; a LocalMesh at sp 2 and 4 equal to the
single card); timings.  Then reflect edges (phase 29,
CfarParams.edge_mode="reflect"): the reflect entry of csrc/cfar_detect.cu
(TPU rows 7 and 8: mirrored rows carrying their mirrored column halo)
against its twin bit for bit (int32 and float32 maps of the reflect
routes at batch 128, per-cell and a given scale map, override 0 and 4,
adversarial maps, targets in the edge rows and columns, 37 rows, hr = R -
1, hd = D - 1, a run-time window, 4216 training cells, strips of one cell,
the sp 4 range shards with mirrored and exchanged halos), the float and
fixed "auto" reflect routes at batch 128 (kernel A, the magnitude-only
entry and the reflect entry, then the plain grouping; frame 0 through the
margin gate; fixed against the golden model on all 128 frames) and a
LocalMesh at sp 2 and 4 against the single card; the reflect entry's
times beside the wrap entry's and the plain grouping's.  Then reflect
edges in the rank-select CFAR (phase 30: the reflect entry of
csrc/cfar_rank.cu, TPU row 9, against its twin bit for bit on the debug
routes' float32 and int32 maps, 16 key bits and exact, a given scale map,
adversarial and edge-target maps, 37 / 7 rows, 6 columns, the quick, a
run-time and a 19-column window, the sp 4 range shards; the debug routes
under reflect at batch 128 — float fused / staged through the margin gate,
fixed auto's taps equal to the golden model on all 128 frames — and a
LocalMesh at sp 2 and 4; the entry beside the wrap entry and the plain
grouping) and in the 3D CFAR (phase 31: the reflect entry of
csrc/cfar_3d_detect.cu, TPU row 10, against its twin bit for bit on the
array route's cube, its int32 copy, adversarial and small cubes, the sp 4
beam shards; the array model under reflect at full width, ref_angle 0 and
1, through the array gate, and a LocalMesh at sp 2 and 4; the entry beside
the wrap entry).  Then long CPIs (phase 32, n_doppler = n2d x 128: kernel
B's split transform and decide kernel): its entries against their twins
at n_doppler 256, 384, 512, 1024 and 2048 (magnitudes within TOL of the
peak, decisions, row maxima and counts bit for bit on the kernel's own
magnitudes; OS, CA, GO, SO, per-cell and block, override, bypass, the
3-pulse MTI, radius 0 and 2; the magnitude-only entry bit-equal to the
detect entry's magnitudes; the split entry at sp 2 and 4 bit-equal to
the whole frame), the main path at BASELINE config 2 (1024x256, batch 128:
float auto now fused, per-cell, block and GO through the margin gate,
frames/s and samples/s beside the staged route), the debug taps, reflect,
the hw-compat float route and the array model (ref_angle 0 and 1) at
1024x256, a LocalMesh at sp 2 and 4, and the entries' times at 1024x256
and 1024x2048.  Then long CPIs in fixed mode (phase 33: the fixed
slow-time kernel's long-CPI split and its int32 map's decision by kernel
B's decide kernel): its entries against their twins at n_doppler 256,
384, 512, 1024 and 2048, bit for bit (values, magnitudes, decisions, row
maxima, counts, saturations; OS, CA, GO, SO, per-cell and block,
overrides, the bypass, the 3-pulse MTI, both transients and roundings,
radius 0-2, the saturating batch), eighth- and quarter-turn tie planes
against the golden numpy model, the split entry at sp 2 and 4 bit-equal
to the whole frame; the fused fixed route at 1024x256, batch 128
(per-cell, fast() block, CA): no plain stage, bit-equal to fixed auto,
equal to the golden process_frame_fixed on every frame of the per-cell
run and 32 of each other (worker processes),
frames/s beside the staged route; a LocalMesh at sp 2 and 4; the
entries' times at 1024x256 and 1024x2048.  Then fixed_fft="scaled"
(phase 34, the stage-scaled XFFT arithmetic): ops/fft.scaled_fft_apply
on the card bit-equal to the golden scaled_fft at n 8..1024 (wraps
included); the scaled routes at 1024x128, batch 128 (fixed auto
per-cell, fast() block, hw-compat batch and process.stream, the debug
taps, a zeros schedule): their CFAR kernels launched and no fused kernel,
every output bit-equal to frontend="plain" on the card, the maps of 8
frames each equal to the golden process_frame_fixed(fft="scaled");
frames/s, the plain scaled stages' ms, the CFAR entries on the scaled
maps.  Then the quick stimulus and the demo (phase 35): the faithful
quick run (golden/adr_quick) through process.stream equal to the golden
hw-stream model; the demo's run function (tools/visualize.run_demo) at
--full for 16 scans in float, fixed, hw-compat fixed, --array 8 and
--sharded 4 (a LocalMesh): each mode's kernels launched, the fixed logs
byte-identical to the same scans on the CPU, the sharded logs to the
single card's, scans/s; the demo's kernels at its shapes against their
twins, timed.  Then the range lengths n_range = n2 x 128 (phase 36, n2
<= 16: JAX's fused kernel's set): kernel A at every n2 x 128 (both
entries, nd 8, 40 and 128, within TOL of the twins; chirp shards at sp 2
and 4 bit-equal to the whole frame); kernel B at 2048, 1536 and 384 rows
(per-cell, block at scale_block 8 and 16, CA/GO/SO, bypass, override,
radius 0 and 2: magnitudes within TOL, decisions bit for bit on the
kernel's own magnitudes; the magnitude-only entry bit-equal to the
detect entry's magnitudes; the split entry at sp 2 and 4; a 2048x256
long CPI); the main path at those lengths (batch 128, per-cell and
fast(): float auto now fused, through the margin gate, frames/s beside
the staged route); the debug taps, reflect, hw-compat float and the
array model at 2048x128; LocalMesh at sp 2 and 4; the entries' times.
Then the fixed kernels at those lengths (phase 37): the fixed range
kernel at every n2 x 128 (nd 8, 40 and 128, noise and x40, both window
roundings, values and saturation counts equal to the twin; chirp shards
at sp 2 and 4 bit-equal to the whole frame) and on tie frames
(golden.reference.range_tie_frames: exact half-LSB ties on the quarter,
eighth, sixth and twelfth turns) equal to the twin, its differences from
the golden model counted and all at exact bins (ROADMAP fault 5); the
fixed slow-time kernel at 2048, 1536 and 384 rows against its twin (kernel
B's cases, block 16 at T = 32, the split entry at sp 2 and 4 with 96-row
shards, a 2048x256 long CPI); fixed "fused" at batch 128 at those lengths
(per-cell, fast() and at 2048 block 16: only the two fixed kernels, no
plain stage, every output bit-equal to frontend="plain", the golden
model on every per-cell frame and 32 of the others, in worker processes,
but at located exact bins; frames/s beside the staged route); float auto
at 2048x128 with block 16 through the margin gate; LocalMesh at sp 2 and
4; the entries' times with bounds, kernel B's and the fixed slow-time
kernel's block 16 among them.
Then kernel B's dense lengths (phase 38: n_doppler a multiple of 8 below
2048 that is neither 16..128 nor n2d x 128): every one of the 237 on a
64-row map against the twins (detect per-cell and block, the bypass, the
override, magnitude-only, the split entry; notch 3 and CA/GO/SO at a
spread of lengths); float auto at batch 128 at 1024x96, 1024x192 and
1024x1016, per-cell and fast() (only kernel A, kernel B's two launches and
the top-K; the margin gate; det maps bit-equal to the plain decision on
the kernel's magnitudes; frames/s beside the staged route); the debug taps,
reflect, hw-compat float and the array model at 1024x96; LocalMesh at sp 2
and 4; the entries' times with bounds.
Then wide maps in the standalone CFAR kernels (phase 39: column chunks in
cfar_rank.cu, cfar_detect.cu and cfar_3d_detect.cu): the rank layout's
host mirror against fmcw_cfar_rank_smem; every chunked entry against its
twin bit for bit at 1024 x 584 .. 4096 (sp 4 shards included); the float
and fixed debug taps at 1024x1016 and 1024x2048, fixed auto at 1024x1920
and 1024x2048 (the golden model), the 3D array model at ref_angle 1 and 2
at 1024x1016 and 1024x1024, a LocalMesh at sp 4 on the debug taps at
1024x2048; the entries' times and the rank plan's two choices.
(--wide-cfar-only runs phase 39 alone.)
Then the fixed dense operator (phase 40: the fixed slow-time kernel at the
dense lengths, an o x m FFT row in FP64 into the int32 map, then the
decide kernel): both its entries at all 237 dense lengths on 64-row maps
against the twin bit for bit (per-cell and block, the bypass, the
override; at a spread of lengths covering o = 1, 3 | o and each m 8..64
also notch 3, passthrough, biased rounding, CA/GO/SO, radius 0-2, the x40
saturating batch, the split entry at sp 4); quarter-, eighth- and
twelfth-turn tie planes equal to the twin, their differences from the
golden model all at exact bins; fixed "fused" at batch 128 at 1024x96,
1024x192 and 1024x1016 (per-cell, fast() block, CA: only the fixed
kernels, bit-equal to frontend="plain", the golden model but at located
exact bins, frames/s beside the staged route); a LocalMesh at sp 2 and 4;
the entries' times with bounds.  (--fixed-dense-only runs phase 40 alone.)
Then n_doppler off a multiple of 8 in the float kernels (phase 41: kernel
A's partial last group of 8 chirps a frame, kernel B's dense row with m = nd
& -nd in 1, 2, 4 and the decide kernel's ragged last chunk): kernel A's
both entries at 1024x100 (batch 128), 1024x250 (batch 3) and 1024x2047
(batch 1) and its chirp shards of 100 / 4 and 1016 / 4 (bit-equal to the
whole frame); kernel B's detect and magnitude-only entries at every such
length 6 .. 2047 on 16-row maps (magnitudes within TOL of a float64
chain on the card, and of the twin at every length to 256, every prime
and 2047; decisions bit for bit); float auto per-cell and "fused" CA at
1024x100, 1024x250, 1024x1021 and 1024x2047 (the margin gate, frames/s
beside the staged route); the debug taps, reflect, hw-compat float and
the array model at 1024x100; LocalMesh at sp 2 and 4 at 1024x100 and
1024x1016; fixed "fused" refused at build; the entries' times with
bounds.  (--odd-doppler-only runs phase 41 alone.)
It prints the card's name and
power limit, one JSON line listing the kernels, and as its last line
{"ok": true, "device": {...}}.
Any failed check raises, and the script then exits non-zero; without CUDA
it exits non-zero at once.
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
    """The CFAR's adds and compares per cell that the function needs.  OS:
    per-cell scale, the full and guard box sums as separable running sums
    (4 adds per cell per box), mean and hi/lo thresholds (4), 2 hi/lo and 1
    detection compare-add per training cell, the classification (8); block
    scale, the detection compare-adds and the block statistics (16).
    CA/GO/SO count nothing: the box sums (8, and the subtraction) for CA
    or the per-cell scale; for GO/SO the row sums across the window (2, a
    running sum) and the lead and lag sums down it (4), two divisions and
    the max or min (3); CA one division; est * scale and the decision (2);
    the per-cell mean, thresholds and classification (8) or the block
    statistics (16)."""
    if cfar.variant == "os":
        if cfar.scale_mode == "cell":
            return 2 * 4 + 4 + 6 * cfar.n_ref + 8
        return 2 * cfar.n_ref + 16
    ops = 2 + (8 if cfar.scale_mode == "cell" else 16)
    if cfar.variant == "ca" or cfar.scale_mode == "cell":
        ops += 2 * 4 + 1
    ops += 1 if cfar.variant == "ca" else 2 + 4 + 3
    return ops


def bound_range_fft_fixed(B: int, nd: int, nr: int):
    """Least time for range_fft_fixed: each int16 I/Q sample read once, the
    int16 re/im planes written once; the FFT's 5 n log2 n flops and 10 per
    bin of BFP peak and quantization (FP64, the kernel's type), 10 integer
    ops per sample for the Q15 window, its saturation test and clip
    (INT32)."""
    nbytes = B * nd * nr * 4 * 2 + B * 4
    fp64 = B * nd * (5 * nr * math.log2(nr) + 10 * nr)
    return _bound(nbytes, 0, B * nd * nr * 10, fp64)


def _fixed_cfar_ops(cells: int, cfar):
    """(FP32, INT32) operations of the fixed kernels' CFAR on ``cells``
    cells (``_cfar_ops`` a cell), each at the rate of the unit that does
    it: OS's compare-adds at FP32 (the kernel counts the integer
    magnitudes in float, as kernel B counts its map).  The CA/GO/SO mean
    epilogue adds its partial sums in float: the box sums' sums down a
    column (2 of each box's 4 adds, where the box sums are needed) and
    GO/SO's row sums across the window (2), at FP32; the sums across
    those partial sums, the floor divisions, the classification and the
    decision are integer, at INT32."""
    ops = cells * _cfar_ops(cfar)
    if cfar.variant == "os":
        return ops, 0
    f32 = 0
    if cfar.variant == "ca" or cfar.scale_mode == "cell":
        f32 += 2 * 2
    if cfar.variant != "ca":
        f32 += 2
    return cells * f32, ops - cells * f32


def bound_slowtime_fixed(B: int, nr: int, nd: int, cfar):
    """Least time for slowtime_detect_fixed: int16 re/im read once, det and
    row maxima written once; FFT and BFP flops as above (FP64); MTI (8),
    window (10) and magnitude (6) per cell (INT32); the CFAR per cell
    (``_fixed_cfar_ops``).  Peak grouping is left out."""
    cells = B * nr * nd
    nbytes = cells * 4 + cells * 4 + B * nr * 4 + B * 8
    fp64 = B * nr * (5 * nd * math.log2(nd) + 10 * nd)
    f32, i32 = _fixed_cfar_ops(cells, cfar)
    return _bound(nbytes, f32, cells * 24 + i32, fp64)


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
    shard's cells (``_fixed_cfar_ops``, as ``bound_slowtime_fixed``)."""
    rows = B * (nrl + 2 * h)
    cells = B * nrl * nd
    nbytes = rows * nd * 4 + cells * 4 + B * nrl * 4 + B * 8
    fp64 = rows * (5 * nd * math.log2(nd) + 10 * nd)
    f32, i32 = _fixed_cfar_ops(cells, cfar)
    return _bound(nbytes, f32, rows * nd * 24 + i32, fp64)


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


# ---------------------------------------------------------------------------
# The CA/GO/SO CFAR variants (kernel B's mean epilogue, the routes, Pd/Pfa)
# ---------------------------------------------------------------------------

MEAN_VARIANTS = ("ca", "go", "so")


def variant_params(p, variant: str, scale_mode: str | None = None):
    """``p`` with the CFAR variant (and scale mode) replaced."""
    kw = dict(variant=variant)
    if scale_mode is not None:
        kw["scale_mode"] = scale_mode
    return p.replace(cfar=dataclasses.replace(p.cfar, **kw))


def noise_batch(p, batch: int, seed: int = 11):
    """Receiver noise alone: complex Gaussian, sigma 64 per component, int16
    (batch, nd, nr, 2), the Pd/Pfa harness's noise frames."""
    import numpy as np
    rng = np.random.default_rng(seed)
    z = rng.normal(0.0, 64.0, (batch, p.n_doppler, p.n_range, 2))
    return np.clip(np.round(z), -32768, 32767).astype(np.int16)


def golden_variant_check(job):
    """A worker process's job: (magnitude maps, det maps, CfarParams,
    grouping radius) of fixed mode; True where the golden os_cfar_2d and
    peak_group give every det map exactly, and the detection count."""
    import numpy as np
    from fmcw_tpu_torch.golden.fixed_point import os_cfar_2d, peak_group
    mags, dets, cfar, radius = job
    ok, n = True, 0
    for m, d in zip(mags, dets):
        want = peak_group(os_cfar_2d(m, cfar), radius)
        ok &= bool(np.array_equal(want, d))
        n += int((want > 0).sum())
    return ok, n


def _b_case(what, re, im, p, bypass, so, pgr, kw=None):
    """Kernel B on planes (re, im) against its twin: magnitudes within TOL
    of the peak, the decision (det, row maxima, n_dets, non-finite count)
    bit for bit on the kernel's magnitudes.  Returns the largest absolute
    magnitude error."""
    import torch
    from fmcw_tpu_torch.ops import frontend as F
    kw = kw or {}
    det, mag, rmax, ndet, nf = F.slowtime_detect(
        re, im, bypass, so, cfar=p.cfar, notch_mode=p.notch_mode,
        peak_group_radius=pgr, emit_mag=True, **kw)
    pmag = F.slowtime_mag_plain(re, im, bypass, p.notch_mode, **kw)
    d2, r2, n2, f2 = F.detect_plain(mag, p.cfar, so, pgr)
    torch.cuda.synchronize()
    fin = torch.isfinite(pmag)
    peak = float(pmag[fin].abs().max())
    err = float((mag - pmag)[fin].abs().max())
    same = (bits_equal(det, d2) and bits_equal(rmax, r2)
            and torch.equal(ndet, n2) and torch.equal(nf, f2)
            and torch.equal(fin, torch.isfinite(mag)))
    log(f"kernel B {p.cfar.variant} {what} {p.n_range}x{p.n_doppler} "
        f"{p.cfar.scale_mode} bypass={bypass} so={so} pgr={pgr} {kw}: mag "
        f"err {err / peak:.3g} of peak, decision "
        f"{'bit-identical' if same else 'DIFFERS'}, n_dets "
        f"{int(ndet.min())}..{int(ndet.max())}, non-finite "
        f"{int(nf.sum())}")
    if not err <= TOL * peak:
        raise AssertionError(f"kernel B {p.cfar.variant}: magnitudes "
                             f"disagree")
    if not same:
        raise AssertionError(f"kernel B {p.cfar.variant} {what}: decision "
                             f"differs from the twin on its magnitudes")
    return err


def variant_kernel_checks(dev, pgr: int):
    """Phase 28a: kernel B's CA/GO/SO epilogue against its twin on the
    kernel's own magnitudes, at full width (batch 128 of 1024x128, the
    two-target batch and a noise batch): each variant, per-cell and block
    scale, override 0 and 6, the MTI on and bypassed, grouping radius 0
    and 2; then the small shapes phase 3 walks (n_doppler 16, 32, 64, a
    window outside the unrolled walks) and planes holding NaN and Inf.
    Returns {variant: largest absolute magnitude error at full width}."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.ops import frontend as F
    entry = P.RadarParams()
    errs = {}
    batches = {"two-target": make_batch(entry, BATCH, seed=21),
               "noise": noise_batch(entry, BATCH)}
    planes = {k: F.range_fft(torch.as_tensor(v, device=dev))
              for k, v in batches.items()}
    for variant in MEAN_VARIANTS:
        worst = 0.0
        for mode in ("cell", "block"):
            p = variant_params(entry, variant, mode)
            for what, (re, im) in planes.items():
                for bypass, so, radius in ((False, 0, pgr), (True, 6, 0)):
                    if what == "noise" and so:
                        continue
                    worst = max(worst, _b_case(what, re, im, p, bypass, so,
                                               radius))
        errs[variant] = worst
    b16 = P.RadarParams(n_range=256, n_doppler=16)
    for variant in MEAN_VARIANTS:
        for base, radius, kw, bypass, so, mode in (
                (P.quick(), 1, {}, False, 0, "cell"),
                (P.quick(), 0, {}, True, 4, "block"),
                (P.RadarParams(n_range=256, n_doppler=64), pgr, {}, False, 0,
                 "cell"),
                (P.RadarParams(n_range=256, n_doppler=64, notch_mode=3), 1,
                 dict(transient="passthrough", exact_mag=True), False, 0,
                 "block"),
                (b16, 0, {}, False, 0, "cell"),
                (b16, pgr, {}, False, 0, "block"),
                (P.RadarParams(n_range=256, n_doppler=64, cfar=P.CfarParams(
                    ref_range=3, ref_doppler=2, guard_range=1,
                    guard_doppler=2)), pgr, {}, False, 0, "cell")):
            p = variant_params(base, variant, mode)
            re, im = F.range_fft(torch.as_tensor(make_batch(p, 4, seed=2),
                                                 device=dev))
            _b_case("small", re, im, p, bypass, so, radius, kw)
        # Non-finite planes: NaN and Inf samples make whole rows of NaN /
        # Inf magnitudes, in windows, in halves and at cuts.
        p = variant_params(entry, variant)
        re, im = (x.clone() for x in planes["two-target"])
        re[:2, 100, 3] = float("nan")
        re[:2, 300, 7] = float("inf")
        im[1, 512, 0] = float("-inf")
        for mode in ("cell", "block"):
            _b_case("nan/inf", re[:4], im[:4], variant_params(p, variant,
                                                              mode),
                    False, 0, pgr)
    return errs


def variant_split_checks(dev, pgr: int):
    """Phase 28b: kernel B's split entry with the CA/GO/SO epilogue (per-cell
    scale, as JAX's split body) at sp 2 and 4, the shards of 128 frames
    fed their neighbours' halo rows: det, magnitudes and row maxima
    bit-equal to the whole-frame entry's rows, counts summing to its; each
    shard's decision bit for bit against the twin on its magnitudes, and
    its magnitudes within TOL of the peak of the twin's.  Returns the
    planes, for the timings, and {variant: largest absolute magnitude
    error of the shards against the twin}."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.ops import frontend as F
    from fmcw_tpu_torch.ops import split_frontend as SF
    entry = P.RadarParams()
    nr = entry.n_range
    h = entry.cfar.halo_range + pgr
    re, im = F.range_fft(torch.as_tensor(make_batch(entry, BATCH, seed=22),
                                         device=dev))
    pmag = F.slowtime_mag_plain(re, im, False)
    peak = float(pmag.abs().max())
    errs = {}
    for variant in MEAN_VARIANTS:
        errs[variant] = 0.0
        p = variant_params(entry, variant)
        kw = dict(cfar=p.cfar, peak_group_radius=pgr, emit_mag=True)
        det, mag, rmax, ndet, _ = F.slowtime_detect(re, im, False, 0, **kw)
        for sp in SPLIT_SPS:
            nrl = nr // sp
            same, total = True, 0
            for s in range(sp):
                rows = slice(s * nrl, (s + 1) * nrl)
                ext = torch.arange(s * nrl - h, (s + 1) * nrl + h,
                                   device=dev) % nr
                lo, hi = ext[:h], ext[h + nrl:]
                d_s, m_s, r_s, n_s, _ = SF.slowtime_detect_split(
                    re[:, rows], im[:, rows], (re[:, lo], im[:, lo]),
                    (re[:, hi], im[:, hi]), False, 0, s * nrl,
                    n_range_total=nr, **kw)
                d2, r2, n2 = SF.detect_halo_plain(mag[:, ext], p.cfar, 0,
                                                  pgr, s * nrl, nr)
                torch.cuda.synchronize()
                errs[variant] = max(errs[variant], float(
                    (m_s - pmag[:, rows]).abs().max()))
                same &= (bits_equal(d_s, det[:, rows])
                         and bits_equal(m_s, mag[:, rows])
                         and bits_equal(r_s, rmax[:, rows])
                         and bits_equal(d_s, d2) and bits_equal(r_s, r2)
                         and torch.equal(n_s, n2))
                total = total + n_s
            same &= (torch.equal(total, ndet)
                     and errs[variant] <= TOL * peak)
            log(f"split {variant} sp={sp}: shards "
                f"{'bit-equal' if same else 'DIFFER'} to the whole-frame "
                f"entry and its twin ({int(ndet.sum())} detections)")
            if not same:
                raise AssertionError(f"slowtime_detect_split {variant} "
                                     f"sp={sp} differs")
    return re, im, errs


# A scale_override whose product est * scale passes 2^24 (the float32
# carrier of JAX's fused kernels) and 2^31 (an int32 product).
LARGE_SO = 1 << 20


def _fx_case(what, re, im, p, bypass, so, pgr, kw=None, quiet=False):
    """The fixed slow-time kernel on int16 planes (re, im) against its twin:
    magnitudes and the Doppler window's saturations equal, the decision
    (det, row maxima, n_dets) bit for bit on the kernel's magnitudes; the
    case logged unless ``quiet``.  Returns the largest absolute magnitude
    difference (0)."""
    import torch
    from fmcw_tpu_torch.ops import frontend as F, frontend_fixed as FX
    kw = kw or {}
    det, mag, rmax, ndet, sat = FX.slowtime_detect_fixed(
        re, im, bypass, so, cfar=p.cfar, notch_mode=p.notch_mode,
        peak_group_radius=pgr, emit_mag=True, **kw)
    pmag, psat = FX.slowtime_mag_fixed_plain(re, im, bypass, p.notch_mode,
                                             **kw)
    d2, r2, n2, _ = F.detect_plain(mag, p.cfar, so, pgr)
    torch.cuda.synchronize()
    err = int((mag - pmag).abs().max())
    same = (err == 0 and torch.equal(sat, psat) and torch.equal(det, d2)
            and torch.equal(rmax, r2) and torch.equal(ndet, n2))
    if not quiet or not same:
        log(f"slowtime_detect_fixed {p.cfar.variant} {what} {p.n_range}x"
            f"{p.n_doppler} {p.cfar.scale_mode} bypass={bypass} so={so} "
            f"pgr={pgr} {kw}: mag {err} LSB, saturation {int(sat.sum())}, "
            f"decision {'bit-identical' if same else 'DIFFERS'}, n_dets "
            f"{int(ndet.min())}..{int(ndet.max())}")
    if not same:
        raise AssertionError(f"slowtime_detect_fixed {p.cfar.variant} "
                             f"{what}: differs from its twin")
    return float(err)


def fixed_variant_kernel_checks(dev, pgr: int):
    """Phase 28f: the fixed slow-time kernel's CA/GO/SO instantiation
    (kMean) against its twin, bit for bit (det, mag, row maxima, n_dets,
    saturations): at full width (batch 128 of 1024x128) each variant,
    per-cell and block, override 0, 6 and LARGE_SO, the MTI on and
    bypassed, grouping radius 0, 1 and 2; the saturating hot_batch (16
    frames); n_doppler 16, 32 and 64 at 256 rows; the 3-pulse MTI with
    the passthrough transient and biased rounding; the WIDE 17x23 window
    (over JAX's 372-cell limit).  Then the split entry at sp 2 and 4, the
    shards of 128 frames fed their neighbours' halo rows: det, magnitudes
    and row maxima bit-equal to the whole-frame entry's rows, n_dets and
    saturations summing to its, each shard's magnitudes equal to the
    twin's on its rows and its decision bit for bit against the twin's on
    the twin's halo-extended magnitudes.  Returns ({variant: largest
    magnitude difference} of the whole-frame entry, the same of the split
    entry, the full-width planes)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.ops import frontend_fixed as FX
    from fmcw_tpu_torch.ops import split_frontend as SF
    entry = P.RadarParams()
    iq = torch.as_tensor(make_batch(entry, BATCH, seed=31), device=dev)
    re, im, _ = FX.range_fft_fixed(iq)
    hre, him, _ = FX.range_fft_fixed(torch.as_tensor(hot_batch(entry, 16),
                                                     device=dev))
    errs = {}
    for variant in MEAN_VARIANTS:
        worst = 0.0
        for mode in ("cell", "block"):
            p = variant_params(entry, variant, mode)
            for bypass, so, radius in ((False, 0, pgr), (True, 6, 0),
                                       (False, LARGE_SO, 1)):
                worst = max(worst, _fx_case("batch", re, im, p, bypass, so,
                                            radius))
            worst = max(worst, _fx_case("hot", hre, him, p, False, 0, pgr))
        errs[variant] = worst
        wide = P.CfarParams(variant=variant, ref_range=6, guard_range=2,
                            ref_doppler=9, guard_doppler=2)
        for base, radius, kw, bypass, so, mode, cfar in (
                (P.RadarParams(n_range=256, n_doppler=16), 0, {}, False, 0,
                 "cell", None),
                (P.RadarParams(n_range=256, n_doppler=16), pgr, {}, True, 6,
                 "block", None),
                (P.RadarParams(n_range=256, n_doppler=32), 1, {}, False, 0,
                 "cell", None),
                (P.RadarParams(n_range=256, n_doppler=32), pgr, {}, False,
                 LARGE_SO, "block", None),
                (P.RadarParams(n_range=256, n_doppler=64, notch_mode=3), 1,
                 dict(transient="passthrough", rounding="biased"), False, 0,
                 "cell", None),
                (P.RadarParams(n_range=256, n_doppler=64), pgr, {}, False, 0,
                 "block", None),
                (P.RadarParams(n_range=256, n_doppler=64), pgr, {}, False, 0,
                 "cell", wide)):
            p = variant_params(base, variant, mode)
            if cfar is not None:
                p = p.replace(cfar=cfar)
            batch = hot_batch(p, 4) if cfar is not None else make_batch(
                p, 4, seed=2)
            sre, sim, _ = FX.range_fft_fixed(
                torch.as_tensor(batch, device=dev),
                rounding=kw.get("rounding", "unbiased"))
            _fx_case("small" if cfar is None else "wide 17x23", sre, sim, p,
                     bypass, so, radius, kw)
    # The split entry (row 6) at sp 2 and 4; the twin's magnitudes of each
    # MTI setting (a row's depend on that row alone).
    nr = entry.n_range
    h = entry.cfar.halo_range + pgr
    cases = ((False, 0), (True, LARGE_SO))
    twin_mag = {bypass: FX.slowtime_mag_fixed_plain(re, im, bypass,
                                                    entry.notch_mode)[0]
                for bypass, _ in cases}
    split_errs = {}
    for variant in MEAN_VARIANTS:
        p = variant_params(entry, variant)
        kw = dict(cfar=p.cfar, peak_group_radius=pgr, emit_mag=True)
        worst = 0
        for bypass, so in cases:
            det, mag, rmax, ndet, sat = FX.slowtime_detect_fixed(
                re, im, bypass, so, **kw)
            pmag = twin_mag[bypass]
            for sp in SPLIT_SPS:
                nrl = nr // sp
                same, n_sum, s_sum = True, 0, 0
                for s in range(sp):
                    rows = slice(s * nrl, (s + 1) * nrl)
                    ext = torch.arange(s * nrl - h, (s + 1) * nrl + h,
                                       device=dev) % nr
                    lo, hi = ext[:h], ext[h + nrl:]
                    d_s, m_s, r_s, n_s, st = SF.slowtime_detect_fixed_split(
                        re[:, rows], im[:, rows], (re[:, lo], im[:, lo]),
                        (re[:, hi], im[:, hi]), bypass, so, s * nrl,
                        n_range_total=nr, **kw)
                    d2, r2, n2 = SF.detect_halo_plain(pmag[:, ext], p.cfar,
                                                      so, pgr, s * nrl, nr)
                    torch.cuda.synchronize()
                    err = int((m_s - pmag[:, rows]).abs().max())
                    worst = max(worst, err)
                    same &= (err == 0 and torch.equal(d_s, det[:, rows])
                             and torch.equal(m_s, mag[:, rows])
                             and torch.equal(r_s, rmax[:, rows])
                             and torch.equal(d_s, d2)
                             and torch.equal(r_s, r2)
                             and torch.equal(n_s, n2))
                    n_sum, s_sum = n_sum + n_s, s_sum + st
                same &= torch.equal(n_sum, ndet) and torch.equal(s_sum, sat)
                log(f"fixed split {variant} sp={sp} bypass={bypass} so={so}: "
                    f"shards {'bit-equal' if same else 'DIFFER'} to the "
                    f"whole-frame entry and the twin (mag {worst} LSB, "
                    f"{int(ndet.sum())} detections)")
                if not same:
                    raise AssertionError(f"slowtime_detect_fixed_split "
                                         f"{variant} sp={sp} differs")
        split_errs[variant] = float(worst)
    return errs, split_errs, (re, im)


class PlainStages:
    """Counts the calls of the plain stages and twins a kernel route must
    not run (the fixed twins, the plain CFAR and grouping), by wrapping
    them in their modules while the context is open."""

    def __init__(self):
        from fmcw_tpu_torch.ops import cfar as C, frontend as F
        from fmcw_tpu_torch.ops import frontend_fixed as FX
        from fmcw_tpu_torch.ops import split_frontend as SF
        self.targets = [
            (FX, "range_fft_fixed_plain"), (FX, "slowtime_mag_fixed_plain"),
            (FX, "slowtime_detect_fixed_plain"), (F, "detect_plain"),
            (SF, "slowtime_detect_fixed_split_plain"), (C, "cfar_2d"),
            (C, "cfar_2d_group"), (C, "peak_group")]
        self.calls = {}

    def __enter__(self):
        self.saved = [getattr(m, n) for m, n in self.targets]
        for (m, n), fn in zip(self.targets, self.saved):
            def counted(*a, _fn=fn, _n=n, **k):
                self.calls[_n] = self.calls.get(_n, 0) + 1
                return _fn(*a, **k)
            setattr(m, n, counted)
        return self

    def __exit__(self, *exc):
        for (m, n), fn in zip(self.targets, self.saved):
            setattr(m, n, fn)
        return False


def fixed_variant_sharded(card: str, dev, pgr: int):
    """Phase 28g, sharded: make_sharded_processor(mode="fixed",
    frontend="fused") on a LocalMesh at sp 2 and 4, each variant per-cell,
    batch 128: the fixed range kernel's chirp-shard entry and the fixed
    split entry (kMean) launched, no plain stage, every output bit-equal to
    the single card's fused route; frames/s on one card.  Returns
    (launches, frames/s)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch import kernels
    from fmcw_tpu_torch.models import pipeline as pl
    from fmcw_tpu_torch.parallel import mesh as M, sharded as SH
    launches, fps = {}, {}
    kw = dict(mode="fixed", frontend="fused", peak_group_radius=pgr,
              include_maps=False)
    for variant in MEAN_VARIANTS:
        p = variant_params(P.RadarParams(), variant)
        batch = torch.as_tensor(make_batch(p, BATCH, seed=23), device=dev)
        single = pl.make_batch_processor(p, device=dev, **kw)(batch)
        for sp in SPLIT_SPS:
            sproc = SH.make_sharded_processor(M.LocalMesh(1, sp, dev), p,
                                              **kw)
            kernels.reset_launch_counts()
            with PlainStages() as plain:
                out = sproc(batch)
                torch.cuda.synchronize()
            counts = {k: v for k, v in kernels.launch_counts().items() if v}
            key = f"{variant}/cell/fixed-sharded-sp{sp}"
            launches[key] = counts
            need = ("range_frontend_fixed", "slowtime_detect_fixed_split")
            diff = [k for k in single if not torch.equal(out[k], single[k])]
            if diff or plain.calls or any(not counts.get(k) for k in need):
                raise AssertionError(f"{key}: differs from the single card "
                                     f"in {diff} (launches {counts}, plain "
                                     f"stages {plain.calls})")
            fps[key] = BATCH * 1e3 / cuda_ms(lambda: sproc(batch), 5, 1)
            log(f"{key}: launches "
                + ", ".join(f"{k}={v}" for k, v in counts.items())
                + f", no plain stage; all outputs bit-equal to the single "
                f"card; {fps[key]:.1f} frames/s on one card ({card})")
    return launches, fps


STANDALONE_KERNELS = ("cfar_detect", "cfar_detect_group", "cfar_rank",
                      "cfar_rank_group", "cfar3d_detect")


def variant_fixed_routes(card: str, dev, pgr: int, pool):
    """Phases 28c and 28g, fixed mode on one card (run first, so that the
    golden model works in the worker processes meanwhile):
    make_batch_processor(mode="fixed") at batch 128, each variant,
    per-cell and block.  "auto" (28c: the FP64 stages, the plain integer
    cfar_2d; no kernel) and "fused" (28g: range_fft_fixed and
    slowtime_detect_fixed's CA/GO/SO instantiation, no plain stage); every
    output of the two routes bit-equal, and the fused route's det maps
    held to the golden os_cfar_2d and peak_group on all 128 frames by the
    workers (collected by the caller).  Timed with CUDA events.  Returns
    (launches, frames/s, golden futures)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch import kernels
    from fmcw_tpu_torch.models import pipeline as pl
    launches, fps, golden = {}, {}, []
    for variant in MEAN_VARIANTS:
        for mode in ("cell", "block"):
            p = variant_params(P.RadarParams(), variant, mode)
            batch = torch.as_tensor(make_batch(p, BATCH, seed=23),
                                    device=dev)
            outs = {}
            for fe in ("auto", "fused"):
                key = f"{variant}/{mode}/fixed/{fe}"
                proc = pl.make_batch_processor(p, mode="fixed", frontend=fe,
                                               peak_group_radius=pgr,
                                               device=dev)
                kernels.reset_launch_counts()
                with PlainStages() as plain:
                    out = proc(batch)
                    torch.cuda.synchronize()
                counts = {k: v for k, v in kernels.launch_counts().items()
                          if v}
                launches[key] = counts
                if fe == "auto" and counts:
                    raise AssertionError(f"route {key}: launches {counts}")
                if fe == "fused" and (
                        plain.calls or set(counts) != {
                            "range_fft_fixed", "slowtime_detect_fixed"}):
                    raise AssertionError(f"route {key}: launches {counts}, "
                                         f"plain stages {plain.calls}")
                outs[fe] = out
                lean = pl.make_batch_processor(p, mode="fixed", frontend=fe,
                                               peak_group_radius=pgr,
                                               include_maps=False, device=dev)
                fps[key] = BATCH * 1e3 / cuda_ms(lambda: lean(batch), 5, 1)
                log(f"route {key}: launches "
                    + (", ".join(f"{k}={v}" for k, v in counts.items())
                       or "none")
                    + f"; {fps[key]:.1f} frames/s at batch {BATCH} "
                    f"({int(out['n_dets'].sum())} detections) ({card})")
            diff = [k for k in outs["auto"]
                    if not torch.equal(outs["auto"][k], outs["fused"][k])]
            if diff:
                raise AssertionError(f"fixed {variant}/{mode}: fused and "
                                     f"auto differ in {diff}")
            log(f"fixed {variant}/{mode}: fused route bit-equal to auto in "
                f"every output")
            key = f"{variant}/{mode}/fixed/fused"
            golden.append((key, pool.submit(
                golden_variant_check,
                (outs["fused"]["mag_map"].cpu().numpy(),
                 outs["fused"]["det_map"].cpu().numpy(), p.cfar, pgr))))
            del outs
    return launches, fps, golden


def variant_routes(card: str, dev, pgr: int):
    """Phase 28c, float: the routes of every variant at full width.
    make_batch_processor at batch 128, per-cell and block: float "auto"
    (kernel A and kernel B's mean epilogue), "staged" (the plain stages and
    the plain cfar_2d on the card) and include_debug=True (kernel A, the
    magnitude-only entry, the plain cfar_2d's taps), frame 0 of each held to
    the margin gate against the twin route's exact taps.  The array model
    at 16 cubes (2D per-beam grouped; 3D ref_angle 1, the plain cfar_3d)
    held to the array gate against the plain path; make_sharded_processor
    on a LocalMesh at sp 2 (per-cell: the split entry; block: the
    magnitude-only entry and the plain tail) equal to the single card.
    Each route timed with CUDA events.  Returns (launches, frames/s,
    cubes/s)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch import kernels, parity
    from fmcw_tpu_torch.golden import reference
    from fmcw_tpu_torch.models import pipeline as pl
    from fmcw_tpu_torch.ops import cfar as C
    from fmcw_tpu_torch.parallel import mesh as M, sharded as SH
    routes = (("float/auto", dict(), ("range_fft", "slowtime_detect")),
              ("float/staged", dict(frontend="staged"), ()),
              ("float/debug", dict(include_debug=True),
               ("range_fft", "slowtime_mag")))
    launches, fps, cps = {}, {}, {}
    for variant in MEAN_VARIANTS:
        for mode in ("cell", "block"):
            p = variant_params(P.RadarParams(), variant, mode)
            batch = torch.as_tensor(make_batch(p, BATCH, seed=23),
                                    device=dev)
            ref = pl.make_processor(p, peak_group_radius=pgr,
                                    frontend="plain", include_debug=True,
                                    cfar_rank_bits=None, device=dev)(batch[0])
            single = None
            for name, kw, need in routes:
                key = f"{variant}/{mode}/{name}"
                proc = pl.make_batch_processor(
                    p, peak_group_radius=pgr, include_maps=False,
                    device=dev, **kw)
                kernels.reset_launch_counts()
                out = proc(batch)
                torch.cuda.synchronize()
                counts = {k: v for k, v in kernels.launch_counts().items()
                          if v}
                launches[key] = counts
                missing = [k for k in need if not counts.get(k)]
                wrong = [k for k in STANDALONE_KERNELS if counts.get(k)]
                if missing or wrong:
                    raise AssertionError(f"route {key}: launches {counts}")
                if name == "float/auto":
                    single = out
                ok, report = parity.margin_gate(
                    parity.detection_set(out, 0), parity.detection_set(ref),
                    ref["mag_map"].cpu().numpy(),
                    ref["threshold_map"].cpu().numpy(),
                    ref["scale_map"].cpu().numpy(), radius=pgr,
                    capacity=p.tracker.max_dets,
                    targets=reference.golden_targets(p))
                if not ok:
                    raise AssertionError(f"route {key}: margin gate failed: "
                                         f"{report}")
                if not bool(torch.isfinite(out["mag"]).all()):
                    raise AssertionError(f"route {key}: non-finite "
                                         f"detections")
                fps[key] = BATCH * 1e3 / cuda_ms(lambda: proc(batch), 5, 1)
                log(f"route {key}: launches "
                    + ", ".join(f"{k}={v}" for k, v in counts.items())
                    + f"; {fps[key]:.1f} frames/s at batch {BATCH} "
                    f"({int(out['n_dets'].sum())} detections) ({card})")
            # The sharded processor on a LocalMesh at sp 2.
            sproc = SH.make_sharded_processor(
                M.LocalMesh(1, 2, dev), p, frontend="fused",
                peak_group_radius=pgr, include_maps=False)
            kernels.reset_launch_counts()
            out = sproc(batch)
            torch.cuda.synchronize()
            counts = {k: v for k, v in kernels.launch_counts().items() if v}
            key = f"{variant}/{mode}/sharded-sp2"
            launches[key] = counts
            need = ("slowtime_detect_split" if mode == "cell"
                    else "slowtime_mag")
            diff = [k for k in single if not torch.equal(out[k], single[k])]
            if diff or not counts.get(need):
                raise AssertionError(f"{key}: differs from the single card "
                                     f"in {diff} (launches {counts})")
            fps[key] = BATCH * 1e3 / cuda_ms(lambda: sproc(batch), 5, 1)
            log(f"{key}: launches "
                + ", ".join(f"{k}={v}" for k, v in counts.items())
                + f"; all outputs bit-equal to the single card; "
                f"{fps[key]:.1f} frames/s on one card ({card})")
        # The array model: per-beam 2D grouped (kernel B's epilogue) and 3D
        # at ref_angle 1 (the plain cfar_3d; no kernel takes CA/GO/SO).
        beam = matched_beam()
        p = variant_params(P.RadarParams(), variant)
        cubes = torch.as_tensor(make_cubes(p, ARRAY_BATCH, seed=24),
                                device=dev)
        for name, kw, need in (
                ("2d", dict(peak_group_radius=pgr, beam_group_radius=1),
                 ("range_fft_float", "slowtime_detect", "beam_group")),
                ("3d", dict(ref_angle=1, peak_group_radius=pgr),
                 ("range_fft_float", "slowtime_mag"))):
            key = f"{variant}/array-{name}"
            proc = pl.make_batch_array_processor(
                p, n_elems=N_ELEMS, n_beams=N_BEAMS, include_maps=False,
                device=dev, **kw)
            kernels.reset_launch_counts()
            out = proc(cubes)
            torch.cuda.synchronize()
            counts = {k: v for k, v in kernels.launch_counts().items() if v}
            launches[key] = counts
            if any(not counts.get(k) for k in need) or counts.get(
                    "cfar3d_detect"):
                raise AssertionError(f"{key}: launches {counts}")
            ref = pl.make_array_processor(p, n_elems=N_ELEMS,
                                          n_beams=N_BEAMS, frontend="plain",
                                          device=dev, **kw)(cubes[0])
            mc = ref["mag_cube"]
            _, T, S = C.cfar_3d(mc, 0, p.cfar, kw.get("ref_angle", 0),
                                need_debug=True)
            ok, report = parity.array_gate(
                parity.array_set(out, 0), parity.array_set(ref),
                mc.cpu().numpy(), T.cpu().numpy(), S.cpu().numpy(),
                radius=pgr, beam_radius=kw.get("beam_group_radius", 0),
                targets=reference.golden_targets(p), target_beam=beam,
                capacity=p.tracker.max_dets)
            del T, S
            if not ok:
                raise AssertionError(f"{key}: array gate failed: {report}")
            cps[key] = ARRAY_BATCH * 1e3 / cuda_ms(lambda: proc(cubes), 5, 1)
            log(f"{key}: launches "
                + ", ".join(f"{k}={v}" for k, v in counts.items())
                + f"; cube 0 vs plain path: {report}; {cps[key]:.1f} "
                f"cubes/s at {ARRAY_BATCH} cubes ({card})")
    return launches, fps, cps


# Pd/Pfa sweeps on the card: trials cut from the harness's default (32 a
# SNR, 16 noise frames) to keep the script's time; the 3D sweep to 3 SNRs.
PD_TRIALS, PD_NOISE = 16, 8
PD3_TRIALS, PD3_NOISE, PD3_SNRS = 8, 4, (-36, -30, -24)


def variant_pd_pfa(card: str, dev):
    """Phase 28d: utils/eval.pd_pfa at RadarParams() (1024x128) over the
    four variants through the kernel route, its table, the envelope per
    variant (Pfa <= 1e-3, Pd non-decreasing in SNR, Pd >= 0.9 at the
    highest SNR), the same sweep through frontend="plain" on the card
    (Pd within one trial per SNR, Pfa within 20% or 2 detections), and
    pd_pfa_3d at 8 x 8.  Returns the results and seconds."""
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.utils import eval as ev
    p = P.RadarParams()
    kw = dict(trials=PD_TRIALS, noise_trials=PD_NOISE, device=dev)
    t0 = time.perf_counter()
    res = ev.pd_pfa(p, **kw)
    t1 = time.perf_counter()
    plain = ev.pd_pfa(p, processor_kw=dict(frontend="plain"), **kw)
    t2 = time.perf_counter()
    res3 = ev.pd_pfa_3d(p, trials=PD3_TRIALS, noise_trials=PD3_NOISE,
                        snr_dbs=PD3_SNRS, device=dev)
    t3 = time.perf_counter()
    log(f"Pd/Pfa, 1024x128, {PD_TRIALS} trials a SNR, {PD_NOISE} noise "
        f"frames, kernel route ({t1 - t0:.1f} s; plain route {t2 - t1:.1f} "
        f"s) ({card}):")
    for line in ev.format_table(res).splitlines():
        log("  " + line)
    log(f"Pd/Pfa 3D (ref_angle 1, 8 elements x 8 beams), {PD3_TRIALS} "
        f"trials, {PD3_NOISE} noise cubes ({t3 - t2:.1f} s):")
    for line in ev.format_table(res3).splitlines():
        log("  " + line)
    cells = p.n_range * p.n_doppler * PD_NOISE
    for v, r in res.items():
        pd = [r["pd"][s] for s in sorted(r["pd"])]
        if not (r["pfa"] <= 1e-3 and pd[-1] >= 0.9
                and all(a <= b for a, b in zip(pd, pd[1:]))):
            raise AssertionError(f"Pd/Pfa {v} outside its envelope: {r}")
        q = plain[v]
        n_k, n_p = r["pfa"] * cells, q["pfa"] * cells
        if not (all(abs(r["pd"][s] - q["pd"][s]) <= 1 / PD_TRIALS
                    for s in r["pd"])
                and abs(n_k - n_p) <= max(2, 0.2 * n_p)):
            raise AssertionError(f"Pd/Pfa {v}: kernel route {r} vs plain "
                                 f"route {q}")
    log("Pd/Pfa: every variant inside the envelope; the plain route within "
        "one trial per SNR and its Pfa within 20% or 2 detections")
    return ({"pd_pfa": res, "pd_pfa_plain": plain, "pd_pfa_3d": res3,
             "trials": PD_TRIALS, "noise_trials": PD_NOISE},
            {"kernel_s": t1 - t0, "plain_s": t2 - t1, "3d_s": t3 - t2})


def variant_timings(card: str, dev, pgr: int, re, im, errs, split_errs,
                    launches, fixed_planes, fixed_errs, fixed_split_errs):
    """Phase 28e: kernel B's CA/GO/SO entries at batch 128 (per-cell and
    block) and its split entry at sp 4 (a 256-row shard), then the fixed
    slow-time kernel's (kMean, TPU rows 2 and 6) the same way, by
    CUDA-graph replay and eager, beside their bounds and twins.  Returns
    the kernel rows."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.ops import frontend as F
    from fmcw_tpu_torch.ops import split_frontend as SF
    entry = P.RadarParams()
    nr, nd = entry.n_range, entry.n_doppler
    src = "fmcw_tpu_torch/csrc/slowtime_detect.cu"
    rows = []
    for variant in MEAN_VARIANTS:
        for mode in ("cell", "block"):
            p = variant_params(entry, variant, mode)
            kw = dict(cfar=p.cfar, peak_group_radius=pgr)
            ms = graph_ms(lambda: F.slowtime_detect(re, im, False, 0, **kw))
            eager = cuda_ms(lambda: F.slowtime_detect(re, im, False, 0, **kw))
            plain = cuda_ms(lambda: F.slowtime_detect_plain(re, im, False, 0,
                                                            **kw), 2, 1)
            bound, by = bound_slowtime(BATCH, nr, nd, p.cfar)
            name = f"slowtime_detect[{variant}, {mode}]"
            log(f"{name}: {ms:.4f} ms (graph; eager {eager:.4f}), plain "
                f"{plain:.4f} ms, bound {bound:.4f} ms ({by}) at batch "
                f"{BATCH} ({card})")
            rows.append(dict(
                name=name, route="cuda", source=src,
                replaces="fmcw_tpu/ops/frontend_pallas.py:623",
                launches=launches[f"{variant}/{mode}/float/auto"].get(
                    "slowtime_detect", 0),
                max_abs_err=errs[variant], ms=ms, plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=None))
    sp = SPLIT_SPS[-1]
    nrl = nr // sp
    h = entry.cfar.halo_range + pgr
    rows_s = slice(nrl, 2 * nrl)                          # shard 1
    ext = torch.arange(nrl - h, 2 * nrl + h, device=dev) % nr
    args = (re[:, rows_s].contiguous(), im[:, rows_s].contiguous(),
            (re[:, ext[:h]].contiguous(), im[:, ext[:h]].contiguous()),
            (re[:, ext[h + nrl:]].contiguous(),
             im[:, ext[h + nrl:]].contiguous()), False, 0, nrl)
    for variant in MEAN_VARIANTS:
        p = variant_params(entry, variant)
        kw = dict(cfar=p.cfar, n_range_total=nr, peak_group_radius=pgr)
        ms = graph_ms(lambda: SF.slowtime_detect_split(*args, **kw))
        plain = cuda_ms(lambda: SF.slowtime_detect_split_plain(*args, **kw),
                        2, 1)
        bound, by = bound_slowtime_split(BATCH, nrl, nd, h, p.cfar)
        name = f"slowtime_detect_split[{variant}]"
        log(f"{name} (sp {sp} shard {BATCH}x{nrl}x{nd}): {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {bound:.4f} ms ({by}) ({card})")
        rows.append(dict(
            name=name, route="cuda", source=src,
            replaces="fmcw_tpu/ops/split_frontend.py:518",
            launches=launches[f"{variant}/cell/sharded-sp2"].get(
                "slowtime_detect_split", 0),
            max_abs_err=split_errs[variant], ms=ms, plain_ms=plain,
            bound_ms=bound, bound_by=by, library_ms=None))
    # The fixed slow-time kernel's CA/GO/SO instantiation (rows 2 and 6).
    from fmcw_tpu_torch.ops import frontend_fixed as FX
    fre, fim = fixed_planes
    src = "fmcw_tpu_torch/csrc/slowtime_detect_fixed.cu"
    for variant in MEAN_VARIANTS:
        for mode in ("cell", "block"):
            p = variant_params(entry, variant, mode)
            kw = dict(cfar=p.cfar, peak_group_radius=pgr)
            ms = graph_ms(lambda: FX.slowtime_detect_fixed(fre, fim, False, 0,
                                                           **kw))
            eager = cuda_ms(lambda: FX.slowtime_detect_fixed(fre, fim, False,
                                                             0, **kw))
            plain = cuda_ms(lambda: FX.slowtime_detect_fixed_plain(
                fre, fim, False, 0, **kw), 2, 1)
            bound, by = bound_slowtime_fixed(BATCH, nr, nd, p.cfar)
            name = f"slowtime_detect_fixed[{variant}, {mode}]"
            log(f"{name}: {ms:.4f} ms (graph; eager {eager:.4f}), plain "
                f"{plain:.4f} ms, bound {bound:.4f} ms ({by}) at batch "
                f"{BATCH} ({card})")
            rows.append(dict(
                name=name, route="cuda", source=src,
                replaces="fmcw_tpu/ops/frontend_pallas.py:813",
                launches=launches[f"{variant}/{mode}/fixed/fused"].get(
                    "slowtime_detect_fixed", 0),
                max_abs_err=fixed_errs[variant], ms=ms, plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=None))
    fargs = (fre[:, rows_s].contiguous(), fim[:, rows_s].contiguous(),
             (fre[:, ext[:h]].contiguous(), fim[:, ext[:h]].contiguous()),
             (fre[:, ext[h + nrl:]].contiguous(),
              fim[:, ext[h + nrl:]].contiguous()), False, 0, nrl)
    for variant in MEAN_VARIANTS:
        p = variant_params(entry, variant)
        kw = dict(cfar=p.cfar, n_range_total=nr, peak_group_radius=pgr)
        ms = graph_ms(lambda: SF.slowtime_detect_fixed_split(*fargs, **kw))
        plain = cuda_ms(lambda: SF.slowtime_detect_fixed_split_plain(
            *fargs, **kw), 2, 1)
        bound, by = bound_slowtime_fixed_split(BATCH, nrl, nd, h, p.cfar)
        name = f"slowtime_detect_fixed_split[{variant}]"
        log(f"{name} (sp {sp} shard {BATCH}x{nrl}x{nd}): {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {bound:.4f} ms ({by}) ({card})")
        rows.append(dict(
            name=name, route="cuda", source=src,
            replaces="fmcw_tpu/ops/split_frontend.py:625",
            launches=launches[f"{variant}/cell/fixed-sharded-sp2"].get(
                "slowtime_detect_fixed_split", 0),
            max_abs_err=fixed_split_errs[variant], ms=ms, plain_ms=plain,
            bound_ms=bound, bound_by=by, library_ms=None))
    return rows


def variant_phase(card: str, dev, pgr: int):
    """Phase 28: the CA/GO/SO variants (28a-28g above); the fixed routes
    first, whose golden checks run in worker processes during the rest.
    Returns (kernel rows, summary)."""
    import concurrent.futures as cf
    import multiprocessing as mp
    import os
    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    workers = max(1, min(7, (os.cpu_count() or 2) - 1))
    with cf.ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        launches, fps, golden = variant_fixed_routes(card, dev, pgr, pool)
        t_fixed = time.perf_counter()
        fixed_errs, fixed_split_errs, fixed_planes = (
            fixed_variant_kernel_checks(dev, pgr))
        t_28f = time.perf_counter()
        errs = variant_kernel_checks(dev, pgr)
        t1 = time.perf_counter()
        re, im, split_errs = variant_split_checks(dev, pgr)
        t2 = time.perf_counter()
        more = variant_routes(card, dev, pgr)
        launches.update(more[0])
        fps.update(more[1])
        cps = more[2]
        more = fixed_variant_sharded(card, dev, pgr)
        launches.update(more[0])
        fps.update(more[1])
        t3 = time.perf_counter()
        pd, pd_s = variant_pd_pfa(card, dev)
        t4 = time.perf_counter()
        rows = variant_timings(card, dev, pgr, re, im, errs, split_errs,
                               launches, fixed_planes, fixed_errs,
                               fixed_split_errs)
        t5 = time.perf_counter()
        for key, fut in golden:
            ok, n = fut.result()
            log(f"route {key}: det maps vs the golden os_cfar_2d on all "
                f"{BATCH} frames: {'equal' if ok else 'DIFFER'} ({n} "
                f"detections)")
            if not ok:
                raise AssertionError(f"route {key} differs from the golden "
                                     f"model")
    t6 = time.perf_counter()
    log(f"variants phase: 28c/28g fixed {t_fixed - t0:.1f} s, 28f "
        f"{t_28f - t_fixed:.1f} s, 28a {t1 - t_28f:.1f} s, 28b "
        f"{t2 - t1:.1f} s, 28c float and 28g sharded {t3 - t2:.1f} s, 28d "
        f"{t4 - t3:.1f} s, 28e {t5 - t4:.1f} s, golden wait "
        f"{t6 - t5:.1f} s")
    return rows, {"frames_per_s": fps, "cubes_per_s": cps,
                  "launches": launches, "pd": pd, "pd_seconds": pd_s}


# ---------------------------------------------------------------------------
# Reflect edges (CfarParams.edge_mode="reflect": the reflect entry of
# csrc/cfar_detect.cu, TPU rows 7 and 8)
# ---------------------------------------------------------------------------

def reflect_params(p, scale_mode: str | None = None):
    """``p`` with reflect edges (and the scale mode replaced)."""
    kw = dict(edge_mode="reflect")
    if scale_mode is not None:
        kw["scale_mode"] = scale_mode
    return p.replace(cfar=dataclasses.replace(p.cfar, **kw))


def edge_batch(p, batch: int, seed: int = 0):
    """bench.py's stimulus with two more targets, on the first and last
    range bins but one, whose windows reach across the map's edges: int16
    (batch, nd, nr, 2).  Amplitude 2000: stronger ones raise the fixed
    chain's block-floating-point noise floor into hundreds of detections a
    frame (the golden model's too)."""
    import numpy as np
    from fmcw_tpu_torch.golden import reference
    from fmcw_tpu_torch.models import pipeline as pl
    rng = np.random.default_rng(seed)
    targets = reference.golden_targets(p) + [(1, 3.0, 2000.0),
                                             (p.n_range - 2, -5.0, 2000.0)]
    frame = pl.complex_to_iq(reference.two_target_frame(p, targets=targets))
    out = np.stack([frame] * batch)
    return out + rng.integers(-8, 8, out.shape).astype(np.int16)


def reflect_case(what: str, mag, so: int, cfar, scale_map=None,
                 prepadded: bool = False, pgr: int = 2) -> float:
    """cfar_detect's reflect entry on one batch of maps against its twin
    (det and scale) bit for bit; on whole maps also the reflect routes'
    CFAR step (the entry, then the plain peak_group, its row maxima and
    counts: cfar_detect_then_group) against the twin's.  Returns the
    largest |difference| (0), or raises."""
    import torch
    from fmcw_tpu_torch.ops import cfar_detect as CD
    kw = dict(cfar=cfar, scale_map=scale_map)
    pairs = [(CD.cfar_detect(mag, so, prepadded_range=prepadded, **kw),
              CD.cfar_detect_plain(mag, so, prepadded_range=prepadded,
                                   **kw))]
    if not prepadded:
        gkw = dict(kw, peak_group_radius=pgr)
        pairs.append((CD.cfar_detect_then_group(mag, so, **gkw),
                      CD.cfar_detect_group_plain(mag, so, **gkw)))
    torch.cuda.synchronize()
    same = all(bits_equal(a, b) for got, want in pairs
               for a, b in zip(got, want))
    err = max(float((a.double() - b.double()).nan_to_num().abs().max())
              for got, want in pairs for a, b in zip(got, want))
    ndet = int((pairs[0][0][0] > 0).sum())
    log(f"cfar_detect reflect {what} {tuple(mag.shape)} {mag.dtype} "
        f"{cfar.scale_mode} so={so}{' prepadded' if prepadded else ''}: "
        f"{'bit-identical' if same else 'DIFFERS'} ({ndet} detections)")
    if not same:
        raise AssertionError(f"cfar_detect reflect ({what}) disagrees with "
                             f"its twin")
    return err


def reflect_kernel_checks(dev):
    """Phase 29a: the reflect entry of cfar_detect (TPU rows 7 and 8)
    against its twin bit for bit: the reflect routes' own int32 (the fixed
    chain's) and float32 (kernel A and the magnitude-only entry) maps of
    ``edge_batch`` at batch 128, per-cell and block, override 0 and 4;
    adversarial maps (NaN, Inf, -0.0, ties, int keys to 2^31); maps with
    targets in the first and last hr rows and hd columns; 37 rows (a last
    block past R), hr = R - 1 (7 rows) and hd = D - 1 (6 columns), a
    run-time window, 4216 training cells, strips of one cell; the sp 4
    range shards 0 and 1 with their mirrored (edge) and exchanged halos,
    also against the whole map's rows.  Returns ({row: largest
    |difference|}, the int32 and float32 maps)."""
    import numpy as np
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.golden.reference import rank_adversarial_maps
    from fmcw_tpu_torch.models import pipeline as pl
    from fmcw_tpu_torch.ops import cfar as C, cfar_detect as CD
    from fmcw_tpu_torch.ops import frontend as F
    entry = reflect_params(P.RadarParams())
    iq = torch.as_tensor(edge_batch(entry, BATCH, seed=29), device=dev)
    imag, _ = pl._staged_fixed(iq, False, entry, "zero", "unbiased")
    fmag, _ = F.slowtime_mag(*F.range_fft(iq))
    errs = {}
    for mag, tag in ((imag, ""), (fmag, ",float32")):
        for p in (entry, reflect_params(P.fast())):
            mode = p.cfar.scale_mode
            name = f"cfar_detect_reflect[{mode}{tag}]"
            for so in (0, 4):
                errs[name] = max(errs.get(name, 0.0), reflect_case(
                    "main-path maps", mag, so, p.cfar))
    gen = np.random.default_rng(29)

    def noise(shape, integer):
        m = gen.exponential(500.0, shape)
        for i, j in ((0, 0), (1, -1), (-1, 2), (-2, -3), (3, 4)):
            m[..., i, j] = 4e4                 # within hr rows / hd columns
        return torch.as_tensor(m.astype(np.int32 if integer else np.float32),
                               device=dev)

    full = entry.cfar
    large = dataclasses.replace(P.CfarParams(
        ref_range=31, ref_doppler=31, guard_range=1, guard_doppler=1),
        edge_mode="reflect")
    runtime = dataclasses.replace(P.CfarParams(
        ref_range=3, ref_doppler=2, guard_range=1, guard_doppler=2),
        edge_mode="reflect")
    for integer in (False, True):
        adv = torch.as_tensor(rank_adversarial_maps((8, 1024, 128), integer,
                                                    29), device=dev)
        cases = [("adversarial", adv, full),
                 ("edge targets", noise((8, 1024, 128), integer), full),
                 ("37 rows", noise((8, 37, 128), integer), full),
                 ("hr = R - 1", noise((8, 7, 128), integer), full),
                 ("hd = D - 1", noise((8, 64, 6), integer), full),
                 ("n_ref 4216", noise((4, 64, 64), integer), large),
                 ("hr 4 gr 1", noise((8, 256, 64), integer), runtime),
                 ("strips of one cell", noise((2, 64, 2048), integer),
                  full)]
        for what, mag, cfar in cases:
            for mode in ("cell", "block"):
                c = dataclasses.replace(cfar, scale_mode=mode)
                smap = None
                if mode == "block":
                    smap = torch.as_tensor(gen.choice(
                        [c.scale_min, c.scale_nom, c.scale_max],
                        tuple(mag.shape)).astype(np.int32), device=dev)
                for so in (0, 4):
                    reflect_case(what, mag, so, c, smap)
    # The sp 4 range shards 0 (the global edge: its lower halo mirrored)
    # and 1, per-cell and with the block scale map's rows.
    hr, nrl = full.halo_range, 256
    for mag, tag in ((imag, ""), (fmag, ",float32")):
        for p in (entry, reflect_params(P.fast())):
            for s in (0, 1):
                ext = C.reflect_index(torch.arange(s * nrl - hr,
                                                   (s + 1) * nrl + hr,
                                                   device=dev), 1024)
                shard = mag[:, ext].contiguous()
                rows = slice(s * nrl, (s + 1) * nrl)
                smap = (C.block_scale_map(mag, p.cfar)[:, rows].contiguous()
                        if p.cfar.scale_mode == "block" else None)
                err = reflect_case(f"sp 4 shard {s}", shard, 0, p.cfar, smap,
                                   prepadded=True)
                name = f"cfar_detect_reflect[prepadded{tag}]"
                errs[name] = max(errs.get(name, 0.0), err)
                whole = CD.cfar_detect(mag, 0, cfar=p.cfar)
                part = CD.cfar_detect(shard, 0, cfar=p.cfar, scale_map=smap,
                                      prepadded_range=True)
                if not all(bits_equal(a[:, rows], b)
                           for a, b in zip(whole, part)):
                    raise AssertionError("prepadded reflect cfar_detect "
                                         "differs from the whole map's rows")
    return errs, imag, fmag


def reflect_main_path(card: str, dev, pgr: int, pool):
    """Phase 29b: the reflect processors at batch 128 of ``edge_batch``,
    per-cell and block: float "auto" (kernel A, the magnitude-only entry,
    the reflect entry, the plain grouping; kernel B's detect entry never
    launched), frame 0 through the margin gate against the plain route
    (its order statistic from the plain cfar_2d); fixed "auto" (the FP64
    stages, the reflect entry), its det maps held to the golden os_cfar_2d
    and peak_group on all 128 frames by the worker ``pool`` (collected by
    the caller); a LocalMesh at sp 2 and 4 equal to the single card in
    every output.  Returns (launches, frames/s, golden futures)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch import kernels, parity
    from fmcw_tpu_torch.golden import reference
    from fmcw_tpu_torch.models import pipeline as pl
    from fmcw_tpu_torch.ops import cfar as C
    from fmcw_tpu_torch.parallel import LocalMesh, sharded
    launches, fps, golden = {}, {}, []
    for p in (reflect_params(P.RadarParams()), reflect_params(P.fast())):
        mode = p.cfar.scale_mode
        batch = torch.as_tensor(edge_batch(p, BATCH, seed=31), device=dev)
        for fm, need in (("fixed", {"cfar_detect"}),
                         ("float32", {"range_fft", "slowtime_mag",
                                      "cfar_detect"})):
            key = f"{mode}/{fm}/auto"
            proc = pl.make_batch_processor(p, mode=fm, peak_group_radius=pgr,
                                           device=dev)
            kernels.reset_launch_counts()
            out = proc(batch)
            torch.cuda.synchronize()
            counts = {k: v for k, v in kernels.launch_counts().items() if v}
            launches[key] = counts
            if set(counts) != need:
                raise AssertionError(f"reflect route {key}: launches "
                                     f"{counts}, want {sorted(need)}")
            if fm == "fixed":
                mags = out["mag_map"].cpu().numpy()
                dets = out["det_map"].cpu().numpy()
                for i in range(0, BATCH, 16):       # 16 frames a job
                    golden.append((key, pool.submit(
                        golden_variant_check,
                        (mags[i:i + 16], dets[i:i + 16], p.cfar, pgr))))
            else:
                if not bool(torch.isfinite(out["mag"]).all()):
                    raise AssertionError("non-finite detection magnitudes")
                ref = pl.make_processor(p, frontend="plain",
                                        peak_group_radius=pgr,
                                        device=dev)(batch[0])
                _, thr, sc = C.cfar_2d(ref["mag_map"], 0, p.cfar,
                                       need_debug=True)
                ok, report = parity.margin_gate(
                    parity.detection_set(out, 0), parity.detection_set(ref),
                    ref["mag_map"].cpu().numpy(), thr.cpu().numpy(),
                    sc.cpu().numpy(), radius=pgr,
                    capacity=p.tracker.max_dets,
                    targets=reference.golden_targets(p))
                log(f"reflect route {key} frame 0 vs plain path: {report}")
                if not ok:
                    raise AssertionError(f"reflect route {key}: margin gate "
                                         f"failed")
            lean = pl.make_batch_processor(p, mode=fm, peak_group_radius=pgr,
                                           include_maps=False, device=dev)
            fps[key] = BATCH * 1e3 / cuda_ms(lambda: lean(batch), 5, 1)
            log(f"reflect route {key}: launches "
                + ", ".join(f"{k}={v}" for k, v in counts.items())
                + f"; {fps[key]:.1f} frames/s at batch {BATCH} "
                f"({int(out['n_dets'].sum())} detections) ({card})")
            single = {k: v for k, v in out.items()}
            for sp in SPLIT_SPS if not (fm == "fixed" and mode == "block") \
                    else ():
                skey = f"{key}/sp{sp}"
                sproc = sharded.make_sharded_processor(
                    LocalMesh(1, sp, dev), p, mode=fm, peak_group_radius=pgr,
                    include_maps=True)
                kernels.reset_launch_counts()
                sout = sproc(batch)
                torch.cuda.synchronize()
                launches[skey] = {k: v for k, v in
                                  kernels.launch_counts().items() if v}
                diff = [k for k in single if not torch.equal(sout[k],
                                                             single[k])]
                if diff or not launches[skey].get("cfar_detect"):
                    raise AssertionError(f"reflect LocalMesh {skey}: "
                                         f"differs in {diff}, launches "
                                         f"{launches[skey]}")
                lean_s = sharded.make_sharded_processor(
                    LocalMesh(1, sp, dev), p, mode=fm, peak_group_radius=pgr)
                fps[skey] = BATCH * 1e3 / cuda_ms(lambda: lean_s(batch), 3, 1)
                log(f"reflect LocalMesh {skey}: equal to the single card in "
                    f"every output; launches "
                    + ", ".join(f"{k}={v}"
                                for k, v in launches[skey].items())
                    + f"; {fps[skey]:.1f} frames/s ({card})")
    return launches, fps, golden


def reflect_timings(card: str, dev, pgr: int, imag, fmag, errs, launches):
    """Phase 29c: the reflect entry by graph replay (eager beside it) next
    to the wrap entry on the same maps (rows 7 and 8, batch 128 of
    1024x128, the block scale map given), its bound (bound_cfar_detect,
    the wrap entry's operations), its twin; the sp 4 edge shard (float32,
    block); the plain grouping that follows the entry on the reflect
    routes, beside the wrap grouping entry.  Returns the kernel rows."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.ops import cfar as C, cfar_detect as CD
    src = "fmcw_tpu_torch/csrc/"
    nr, nd = 1024, 128
    rows, summary = [], {}
    for p, line in ((P.RadarParams(), 155), (P.fast(), 279)):
        mode = p.cfar.scale_mode
        rc = reflect_params(p).cfar
        for mag, tag, fm in ((imag, "", "fixed"),
                             (fmag, ",float32", "float32")):
            smap = C.block_scale_map(mag, rc) if mode == "block" else None
            wmap = (C.block_scale_map(mag, p.cfar) if mode == "block"
                    else None)
            in_float = (mag.is_floating_point() or int(mag.abs().max())
                        <= CD.float_max(rc))
            name = f"cfar_detect_reflect[{mode}{tag}]"
            ms = graph_ms(lambda: CD.cfar_detect(mag, 0, cfar=rc,
                                                 scale_map=smap))
            eager = cuda_ms(lambda: CD.cfar_detect(mag, 0, cfar=rc,
                                                   scale_map=smap))
            wrap = graph_ms(lambda: CD.cfar_detect(mag, 0, cfar=p.cfar,
                                                   scale_map=wmap))
            plain = cuda_ms(lambda: CD.cfar_detect_plain(
                mag, 0, cfar=rc, scale_map=smap), 2, 1)
            bound, by = bound_cfar_detect(BATCH, nr, nd, rc, in_float)
            det, _ = CD.cfar_detect(mag, 0, cfar=rc, scale_map=smap)
            group = cuda_ms(lambda: C.peak_group(det, pgr))
            wrap_group = graph_ms(lambda: CD.cfar_detect_group(
                mag, 0, cfar=p.cfar, scale_map=wmap, peak_group_radius=pgr))
            log(f"{name} ({mag.dtype} maps, counted in "
                f"{'float' if in_float else 'int'}): {ms:.4f} ms (graph; "
                f"eager {eager:.4f}), the wrap entry {wrap:.4f} ms in the "
                f"same run ({ms / wrap:.3f}x), plain {plain:.4f} ms, bound "
                f"{bound:.4f} ms ({by}); then the plain peak_group "
                f"{group:.4f} ms (the wrap grouping entry, CFAR and "
                f"grouping: {wrap_group:.4f} ms) at batch {BATCH} ({card})")
            summary[name] = {"graph_ms": ms, "eager_ms": eager,
                             "wrap_graph_ms": wrap,
                             "plain_peak_group_ms": group,
                             "wrap_group_entry_ms": wrap_group}
            rows.append(dict(name=name, route="cuda",
                             source=src + "cfar_detect.cu",
                             replaces=f"fmcw_tpu/ops/cfar_pallas.py:{line}",
                             launches=launches[f"{mode}/{fm}/auto"].get(
                                 "cfar_detect", 0),
                             max_abs_err=errs[name], ms=ms, plain_ms=plain,
                             bound_ms=bound, bound_by=by, library_ms=None))
    # The sp 4 edge shard (shard 0: its lower halo mirrored), float32,
    # block scale given, as the sharded block route launches it.
    q = reflect_params(P.fast())
    hr, nrl = q.cfar.halo_range, nr // 4
    ext = C.reflect_index(torch.arange(-hr, nrl + hr, device=dev), nr)
    m_h = fmag[:, ext].contiguous()
    smap = C.block_scale_map(fmag, q.cfar)[:, :nrl].contiguous()
    wq = P.fast()
    w_h = fmag[:, torch.arange(-hr, nrl + hr, device=dev) % nr].contiguous()
    wmap = C.block_scale_map(fmag, wq.cfar)[:, :nrl].contiguous()
    kw = dict(cfar=q.cfar, scale_map=smap, prepadded_range=True)
    ms = graph_ms(lambda: CD.cfar_detect(m_h, 0, **kw))
    eager = cuda_ms(lambda: CD.cfar_detect(m_h, 0, **kw))
    wrap = graph_ms(lambda: CD.cfar_detect(w_h, 0, cfar=wq.cfar,
                                           scale_map=wmap,
                                           prepadded_range=True))
    plain = cuda_ms(lambda: CD.cfar_detect_plain(m_h, 0, **kw), 2, 1)
    bound, by = bound_cfar_detect(BATCH, nrl, nd, q.cfar, True)
    name = "cfar_detect_reflect[prepadded,float32]"
    log(f"{name} (sp 4 edge shard {BATCH}x{nrl}+2x{hr}, block): {ms:.4f} ms "
        f"(graph; eager {eager:.4f}), the wrap entry {wrap:.4f} ms, plain "
        f"{plain:.4f} ms, bound {bound:.4f} ms ({by}) ({card})")
    summary[name] = {"graph_ms": ms, "eager_ms": eager, "wrap_graph_ms": wrap}
    rows.append(dict(name=name, route="cuda", source=src + "cfar_detect.cu",
                     replaces="fmcw_tpu/ops/cfar_pallas.py:279",
                     launches=launches["block/float32/auto/sp4"].get(
                         "cfar_detect", 0),
                     max_abs_err=errs[name], ms=ms, plain_ms=plain,
                     bound_ms=bound, bound_by=by, library_ms=None))
    return rows, summary


def reflect_phase(card: str, dev, pgr: int):
    """Phase 29: reflect edges on the card (29a-c above), the fixed routes'
    golden checks in worker processes meanwhile.  Returns (kernel rows,
    summary)."""
    import concurrent.futures as cf
    import multiprocessing as mp
    import os
    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    workers = max(1, min(7, (os.cpu_count() or 2) - 1))
    with cf.ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        launches, fps, golden = reflect_main_path(card, dev, pgr, pool)
        t1 = time.perf_counter()
        errs, imag, fmag = reflect_kernel_checks(dev)
        t2 = time.perf_counter()
        rows, entry = reflect_timings(card, dev, pgr, imag, fmag, errs,
                                      launches)
        t3 = time.perf_counter()
        verdict = {}
        for key, fut in golden:
            ok, n = fut.result()
            was = verdict.get(key, (True, 0))
            verdict[key] = (was[0] and ok, was[1] + n)
        for key, (ok, n) in verdict.items():
            log(f"reflect route {key}: det maps vs the golden os_cfar_2d "
                f"and peak_group on all {BATCH} frames: "
                f"{'equal' if ok else 'DIFFER'} ({n} detections)")
            if not ok:
                raise AssertionError(f"reflect route {key} differs from the "
                                     f"golden model")
    log(f"reflect phase: 29b {t1 - t0:.1f} s, 29a {t2 - t1:.1f} s, 29c "
        f"{t3 - t2:.1f} s, golden wait {time.perf_counter() - t3:.1f} s")
    return rows, {"frames_per_s": fps, "launches": launches, "entry": entry}


# ---------------------------------------------------------------------------
# Reflect edges in the rank-select and 3D CFARs (the reflect entries of
# csrc/cfar_rank.cu, TPU row 9, and csrc/cfar_3d_detect.cu, TPU row 10):
# the debug taps and the array model under edge_mode="reflect"
# ---------------------------------------------------------------------------

def golden_taps_check(job):
    """A worker process's job: (magnitude, det, threshold and scale maps,
    CfarParams, grouping radius) of the fixed debug route; True where the
    golden os_cfar_2d with its debug taps and peak_group give every map
    exactly, and the detection count."""
    import numpy as np
    from fmcw_tpu_torch.golden.fixed_point import os_cfar_2d, peak_group
    mags, dets, thrs, scales, cfar, radius = job
    ok, n = True, 0
    for m, d, t, s in zip(mags, dets, thrs, scales):
        gd, gt, gs = os_cfar_2d(m, cfar, return_debug=True)
        want = peak_group(gd, radius)
        ok &= bool(np.array_equal(want, d) and np.array_equal(gt, t)
                   and np.array_equal(gs, s))
        n += int((want > 0).sum())
    return ok, n


def rank_reflect_case(what: str, mag, so: int, cfar, bits, scale_map=None,
                      prepadded: bool = False, pgr: int = RANK_PGR) -> float:
    """cfar_rank's reflect entry on one batch of maps against its twin
    (det, threshold and scale) bit for bit; on whole maps also the reflect
    debug routes' CFAR step (the entry, then the plain peak_group, its row
    maxima and counts: cfar_rank_then_group) against the twin's.  Returns
    the largest |difference| (0), or raises."""
    import torch
    from fmcw_tpu_torch.ops import cfar_rank as RK
    kw = dict(cfar=cfar, bits=bits, scale_map=scale_map)
    pairs = [(RK.cfar_rank(mag, so, prepadded_range=prepadded, **kw),
              RK.cfar_rank_plain(mag, so, prepadded_range=prepadded, **kw))]
    if not prepadded:
        gkw = dict(kw, peak_group_radius=pgr)
        pairs.append((RK.cfar_rank_then_group(mag, so, **gkw),
                      RK.cfar_rank_group_plain(mag, so, **gkw)))
    torch.cuda.synchronize()
    same = all(bits_equal(a, b) for got, want in pairs
               for a, b in zip(got, want))
    err = max(float((a.double() - b.double()).nan_to_num().abs().max())
              for got, want in pairs for a, b in zip(got, want))
    ndet = int((pairs[0][0][0] > 0).sum())
    log(f"cfar_rank reflect {what} {tuple(mag.shape)} {mag.dtype} "
        f"{cfar.scale_mode} bits={bits} so={so}"
        f"{' prepadded' if prepadded else ''}: det, threshold and scale "
        f"{'bit-identical' if same else 'DIFFER'} ({ndet} detections)")
    if not same:
        raise AssertionError(f"cfar_rank reflect ({what}) disagrees with "
                             f"its twin")
    return err


def _reflect_rows(mag, s: int, nrl: int, hr: int):
    """Range shard s (nrl rows) of (B, R, D) maps with hr halo rows on each
    side mirrored at the map's edges, as the sharded tail exchanges them."""
    import torch
    from fmcw_tpu_torch.ops import cfar as C
    R = mag.shape[-2]
    idx = C.reflect_index(torch.arange(s * nrl - hr, (s + 1) * nrl + hr,
                                       device=mag.device), R)
    return mag[:, idx].contiguous()


def rank_reflect_checks(dev):
    """Phase 30a: the reflect entry of cfar_rank (TPU row 9) against its
    twin bit for bit (det, threshold and scale): the debug routes' own
    float32 (kernel A and the magnitude-only entry) and int32 (the fixed
    chain's) maps of ``edge_batch``, 16 key bits and exact, per-cell and a
    given block scale map, override 0 and 4; adversarial maps (NaN, Inf,
    -0.0, ties, int keys to 2^31), targets in the edge rows and columns, 37
    rows, hr = R - 1, hd = D - 1, the quick window (7 rows unrolled), a
    window walked at run time (hr 4), one of 19 columns (a row at a time);
    the sp 4 range shards 0 and 3 (the global edges, their halos mirrored)
    and 1 (exchanged), also against the whole map's rows.  On whole maps
    also cfar_rank_then_group against its twin.  Returns {row: largest
    |difference|}."""
    import numpy as np
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.golden.reference import rank_adversarial_maps
    from fmcw_tpu_torch.models import pipeline as pl
    from fmcw_tpu_torch.ops import cfar as C, cfar_rank as RK
    from fmcw_tpu_torch.ops import frontend as F
    entry, fast = reflect_params(P.RadarParams()), reflect_params(P.fast())
    iq = torch.as_tensor(edge_batch(entry, RANK_FRAMES, seed=30), device=dev)
    imag, _ = pl._staged_fixed(iq, False, entry, "zero", "unbiased")
    fmag, _ = F.slowtime_mag(*F.range_fft(iq))
    errs = {}
    main = (("float,16 bits", fmag, entry.cfar, 16),
            ("float,exact", fmag, entry.cfar, None),
            ("float,exact,scale map", fmag, fast.cfar, None),
            ("int32,16 bits", imag, entry.cfar, 16),
            ("int32,exact,scale map", imag, fast.cfar, None))
    for what, mag, cfar, bits in main:
        smap = (C.block_scale_map(mag, cfar) if cfar.scale_mode == "block"
                else None)
        name = f"cfar_rank_reflect[{what}]"
        for so in (0, 4):
            errs[name] = max(errs.get(name, 0.0), rank_reflect_case(
                "route maps", mag, so, cfar, bits, smap))
        # The sp 4 range shards 0, 1 and 3 (edge, interior, edge).
        nrl, hr = mag.shape[-2] // 4, cfar.halo_range
        whole = RK.cfar_rank(mag, 0, cfar=cfar, bits=bits, scale_map=smap)
        for s in (0, 1, 3):
            rows = slice(s * nrl, (s + 1) * nrl)
            shard = _reflect_rows(mag, s, nrl, hr)
            ssmap = None if smap is None else smap[:, rows].contiguous()
            err = rank_reflect_case(f"sp 4 shard {s}", shard, 0, cfar, bits,
                                    ssmap, prepadded=True)
            pname = f"cfar_rank_reflect[prepadded,{what}]"
            errs[pname] = max(errs.get(pname, 0.0), err)
            part = RK.cfar_rank(shard, 0, cfar=cfar, bits=bits,
                                scale_map=ssmap, prepadded_range=True)
            if not all(bits_equal(a[:, rows], b) for a, b in zip(whole, part)):
                raise AssertionError("prepadded reflect cfar_rank differs "
                                     "from the whole map's rows")
    gen = np.random.default_rng(30)

    def noise(shape, integer):
        m = gen.exponential(500.0, shape)
        for i, j in ((0, 0), (1, -1), (-1, 2), (-2, -3), (3, 4)):
            m[..., i, j] = 4e4                 # within hr rows / hd columns
        return torch.as_tensor(m.astype(np.int32 if integer else np.float32),
                               device=dev)

    full = entry.cfar
    quick = reflect_params(P.quick()).cfar
    runtime = dataclasses.replace(P.CfarParams(
        ref_range=3, ref_doppler=2, guard_range=1, guard_doppler=2),
        edge_mode="reflect")
    wide = dataclasses.replace(P.CfarParams(ref_doppler=8),
                               edge_mode="reflect")
    for integer in (False, True):
        adv = torch.as_tensor(rank_adversarial_maps(
            (RANK_FRAMES, 1024, 128), integer, 30), device=dev)
        cases = [("adversarial", adv, full),
                 ("edge targets", noise((RANK_FRAMES, 1024, 128), integer),
                  full),
                 ("37 rows", noise((8, 37, 128), integer), full),
                 ("hr = R - 1", noise((8, 7, 128), integer), full),
                 ("hd = D - 1", noise((8, 64, 6), integer), full),
                 ("quick window", noise((8, 256, 64), integer), quick),
                 ("hr 4 gd 2", noise((8, 256, 64), integer), runtime),
                 ("19 columns", noise((8, 256, 64), integer), wide)]
        for what, mag, cfar in cases:
            for bits in (16, None):
                rank_reflect_case(what, mag, 4 if bits else 0, cfar, bits)
            c = dataclasses.replace(cfar, scale_mode="block")
            smap = torch.as_tensor(gen.choice(
                [c.scale_min, c.scale_nom, c.scale_max],
                tuple(mag.shape)).astype(np.int32), device=dev)
            rank_reflect_case(what, mag, 0, c, None, smap)
    return errs


def rank_reflect_routes(card: str, dev, pgr: int, pool):
    """Phases 30b and 30c: the debug-tap processors under reflect at batch
    128 of ``edge_batch``: float per-cell and block on "fused" (kernel A,
    the magnitude-only entry, cfar_rank's reflect entry) and "staged" (the
    plain transforms, the reflect entry), fixed per-cell on "auto" (the
    FP64 stages, the reflect entry), each then the plain grouping (no
    grouping entry and no kernel B detect entry launched); every output of
    the batch bit-equal to cfar_rank_plain, peak_group and the top-K on the
    route's own magnitudes; float frame 0 through the margin gate against
    the plain route; fixed det, threshold and scale maps of all 128 frames
    against the golden os_cfar_2d by the worker ``pool`` (collected by the
    caller); frames/s.  30c: make_sharded_processor(include_debug=True) on
    a LocalMesh at sp 2 and 4 (cfar_rank's reflect entry on prepadded
    shards with mirrored edge halos) equal to the single card in every
    output.  Returns (launches by kernel row, frames/s, golden futures)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch import kernels, parity
    from fmcw_tpu_torch.golden import reference
    from fmcw_tpu_torch.models import pipeline as pl
    from fmcw_tpu_torch.ops import cfar as C, cfar_rank as RK
    from fmcw_tpu_torch.ops import detect as DET
    from fmcw_tpu_torch.parallel import mesh as M, sharded as SH
    configs = (("float/cell", reflect_params(P.RadarParams()), "float32",
                ("fused", "staged"), "float,16 bits"),
               ("float/block", reflect_params(P.fast()), "float32",
                ("fused", "staged"), "float,exact,scale map"),
               ("fixed/cell", reflect_params(P.RadarParams()), "fixed",
                ("auto",), "int32,16 bits"))
    launches, fps, golden = {}, {}, []
    for name, p, mode, routes, row in configs:
        fixed = mode == "fixed"
        batch = torch.as_tensor(edge_batch(p, BATCH, seed=32), device=dev)
        bits = RK.debug_bits(p.cfar, fixed, 16)
        kw = dict(mode=mode, peak_group_radius=pgr, include_debug=True)
        if not fixed:
            ref = pl.make_processor(p, frontend="plain", device=dev,
                                    **kw)(batch[0])
        for fe in routes:
            key = f"{name}/{fe}"
            proc = pl.make_batch_processor(p, frontend=fe, device=dev, **kw)
            kernels.reset_launch_counts()
            out = proc(batch)
            torch.cuda.synchronize()
            counts = {k: v for k, v in kernels.launch_counts().items() if v}
            need = {"cfar_rank"} | ({"range_fft", "slowtime_mag"}
                                    if fe == "fused" else set())
            log(f"reflect debug {key}: launches "
                + ", ".join(f"{k}={v}" for k, v in counts.items()))
            if set(counts) != need:
                raise AssertionError(f"reflect debug {key}: launches "
                                     f"{counts}, want {sorted(need)}")
            rname = f"cfar_rank_reflect[{row}]"
            launches[rname] = launches.get(rname, 0) + counts["cfar_rank"]
            outs_ok = True
            for i in range(0, BATCH, RANK_FRAMES):
                dp, tp, sp = RK.cfar_rank_plain(
                    out["mag_map"][i:i + RANK_FRAMES], cfar=p.cfar,
                    bits=bits)
                dp = C.peak_group(dp, pgr)
                want = DET.topk_detections(dp, p.tracker.max_dets)
                want.update(det_map=dp, threshold_map=tp,
                            scale_map=sp.to(dp.dtype))
                outs_ok &= all(torch.equal(out[k][i:i + RANK_FRAMES], v)
                               for k, v in want.items())
                del dp, tp, sp, want
            if fixed:
                ok, report = True, (f"taps of {BATCH} frames to the golden "
                                    f"model")
                arrays = [out[k].cpu().numpy() for k in (
                    "mag_map", "det_map", "threshold_map", "scale_map")]
                for i in range(0, BATCH, 16):       # 16 frames a job
                    golden.append((key, pool.submit(golden_taps_check, (
                        *(a[i:i + 16] for a in arrays), p.cfar, pgr))))
            else:
                ok, report = parity.margin_gate(
                    parity.detection_set(out, 0), parity.detection_set(ref),
                    ref["mag_map"].cpu().numpy(),
                    ref["threshold_map"].cpu().numpy(),
                    ref["scale_map"].cpu().numpy(), radius=pgr,
                    capacity=p.tracker.max_dets,
                    targets=reference.golden_targets(p))
            log(f"reflect debug {key}: every output "
                f"{'bit-equal' if outs_ok else 'DIFFERS'} to cfar_rank_plain,"
                f" peak_group and the top-K on the route's magnitudes; "
                f"frame 0: {report}")
            if not (outs_ok and ok):
                raise AssertionError(f"reflect debug {key} failed its check")
            if int(out["nonfinite_count"].sum()) != 0:
                raise AssertionError("non-finite cells in the magnitude map")
            lean = pl.make_batch_processor(p, frontend=fe, include_maps=False,
                                           device=dev, **kw)
            fps[key] = BATCH * 1e3 / cuda_ms(lambda: lean(batch), 5, 1)
            log(f"reflect debug {key}: {fps[key]:.1f} frames/s at batch "
                f"{BATCH} ({int(out['n_dets'].sum())} detections) ({card})")
            if fe != routes[0]:
                del out
                continue
            # 30c: the sharded debug taps on a LocalMesh.
            sfe = "fused" if not fixed else "auto"
            for sp in SPLIT_SPS:
                skey = f"{name}/sp{sp}"
                sproc = SH.make_sharded_processor(
                    M.LocalMesh(1, sp, dev), p, frontend=sfe,
                    include_maps=True, **kw)
                kernels.reset_launch_counts()
                sout = sproc(batch)
                torch.cuda.synchronize()
                scounts = {k: v for k, v in kernels.launch_counts().items()
                           if v}
                diff = [k for k in out if not torch.equal(sout[k], out[k])]
                if diff or sout.keys() != out.keys() or \
                        not scounts.get("cfar_rank") or \
                        scounts.get("cfar_rank_group"):
                    raise AssertionError(f"reflect sharded debug {skey}: "
                                         f"differs in {diff}, launches "
                                         f"{scounts}")
                pname = f"cfar_rank_reflect[prepadded,{row}]"
                launches[pname] = launches.get(pname, 0) + scounts["cfar_rank"]
                lean_s = SH.make_sharded_processor(
                    M.LocalMesh(1, sp, dev), p, frontend=sfe, **kw)
                fps[skey] = BATCH * 1e3 / cuda_ms(lambda: lean_s(batch), 3, 1)
                log(f"reflect sharded debug {skey}: taps, maps and "
                    f"detections bit-equal to the single card; launches "
                    + ", ".join(f"{k}={v}" for k, v in scounts.items())
                    + f"; {fps[skey]:.1f} frames/s on one card ({card})")
                del sout
            del out
    return launches, fps, golden


def rank_reflect_timings(card: str, dev, pgr: int, errs, launches):
    """Phase 30d: the reflect entry of cfar_rank by graph replay beside the
    wrap entry on the same maps (batch 128 of ``edge_batch``'s float32 and
    int32 magnitudes, 1024x128): float 16 key bits, float exact (per-cell
    and a given block scale map), int32 16 bits; its bound (bound_cfar_rank,
    the wrap entry's) and its twin in 8-frame chunks; the plain grouping
    that follows it on the reflect debug routes, beside the wrap grouping
    entry (CFAR and grouping); the sp 4 edge shard (float32, 16 bits) beside
    the wrap shard.  Returns (kernel rows, summary)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.models import pipeline as pl
    from fmcw_tpu_torch.ops import cfar as C, cfar_rank as RK
    from fmcw_tpu_torch.ops import frontend as F
    p, fast = P.RadarParams(), P.fast()
    rp, rfast = reflect_params(p), reflect_params(fast)
    nr, nd = p.n_range, p.n_doppler
    iq = torch.as_tensor(edge_batch(rp, BATCH, seed=34), device=dev)
    fmag, _ = F.slowtime_mag(*F.range_fft(iq))
    imag, _ = pl._staged_fixed(iq, False, rp, "zero", "unbiased")
    del iq
    src = "fmcw_tpu_torch/csrc/cfar_rank.cu"
    variants = (("float,16 bits", fmag, rp.cfar, p.cfar, 16),
                ("float,exact", fmag, rp.cfar, p.cfar, None),
                ("float,exact,scale map", fmag, rfast.cfar, fast.cfar, None),
                ("int32,16 bits", imag, rp.cfar, p.cfar, 16))
    rows, summary = [], {}
    for what, mag, rc, wc, bits in variants:
        block = rc.scale_mode == "block"
        smap = C.block_scale_map(mag, rc) if block else None
        wmap = C.block_scale_map(mag, wc) if block else None
        name = f"cfar_rank_reflect[{what}]"
        ms = graph_ms(lambda: RK.cfar_rank(mag, cfar=rc, bits=bits,
                                           scale_map=smap))
        wrap = graph_ms(lambda: RK.cfar_rank(mag, cfar=wc, bits=bits,
                                             scale_map=wmap))

        def plain():
            for i in range(0, BATCH, RANK_FRAMES):
                RK.cfar_rank_plain(mag[i:i + RANK_FRAMES], cfar=rc, bits=bits,
                                   scale_map=None if smap is None
                                   else smap[i:i + RANK_FRAMES])

        plain_ms = cuda_ms(plain, 1, 1)
        bound, by = bound_cfar_rank(BATCH, nr, nd, rc, bits or 31,
                                    not mag.is_floating_point(), block)
        det = RK.cfar_rank(mag, cfar=rc, bits=bits, scale_map=smap)[0]
        group = cuda_ms(lambda: C.peak_group(det, pgr), 5)
        del det
        wrap_group = graph_ms(lambda: RK.cfar_rank_group(
            mag, cfar=wc, bits=bits, scale_map=wmap, peak_group_radius=pgr))
        log(f"{name}: {ms:.4f} ms (graph), the wrap entry {wrap:.4f} ms in "
            f"the same run ({ms / wrap:.3f}x), plain (16 x {RANK_FRAMES} "
            f"frames) {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}); then "
            f"the plain peak_group {group:.4f} ms (the wrap grouping entry, "
            f"CFAR and grouping: {wrap_group:.4f} ms) at batch {BATCH} "
            f"({card})")
        if ms < bound:
            raise AssertionError(f"{name} reads under its bound")
        summary[name] = {"graph_ms": ms, "wrap_graph_ms": wrap,
                         "plain_peak_group_ms": group,
                         "wrap_group_entry_ms": wrap_group}
        rows.append(dict(name=name, route="cuda", source=src,
                         replaces="fmcw_tpu/ops/cfar_pallas.py:58",
                         launches=launches.get(name, 0),
                         max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=by, library_ms=None))
    # The sp 4 edge shard 0 (its lower halo mirrored), float32, 16 bits, as
    # the sharded debug tail launches it, beside the wrap shard.
    hr, nrl = rp.cfar.halo_range, nr // 4
    m_h = _reflect_rows(fmag, 0, nrl, hr)
    w_h = fmag[:, torch.arange(-hr, nrl + hr, device=dev) % nr].contiguous()
    ms = graph_ms(lambda: RK.cfar_rank(m_h, cfar=rp.cfar, bits=16,
                                       prepadded_range=True))
    wrap = graph_ms(lambda: RK.cfar_rank(w_h, cfar=p.cfar, bits=16,
                                         prepadded_range=True))
    plain_ms = cuda_ms(lambda: [RK.cfar_rank_plain(
        m_h[i:i + RANK_FRAMES], cfar=rp.cfar, bits=16, prepadded_range=True)
        for i in range(0, BATCH, RANK_FRAMES)], 1, 1)
    bound, by = bound_cfar_rank(BATCH, nrl, nd, rp.cfar, 16, False, False)
    name = "cfar_rank_reflect[prepadded,float,16 bits]"
    log(f"{name} (sp 4 edge shard {BATCH}x{nrl}+2x{hr}): {ms:.4f} ms "
        f"(graph), the wrap shard {wrap:.4f} ms ({ms / wrap:.3f}x), plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}) ({card})")
    summary[name] = {"graph_ms": ms, "wrap_graph_ms": wrap}
    rows.append(dict(name=name, route="cuda", source=src,
                     replaces="fmcw_tpu/ops/cfar_pallas.py:58",
                     launches=launches.get(name, 0), max_abs_err=errs[name],
                     ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                     library_ms=None))
    return rows, summary


def rank_reflect_phase(card: str, dev, pgr: int):
    """Phase 30: reflect edges in the rank-select CFAR (30a-d above), the
    fixed route's golden checks in worker processes meanwhile.  Returns
    (kernel rows, summary)."""
    import concurrent.futures as cf
    import multiprocessing as mp
    import os
    t0 = time.perf_counter()
    workers = max(1, min(7, (os.cpu_count() or 2) - 1))
    with cf.ProcessPoolExecutor(workers,
                                mp_context=mp.get_context("spawn")) as pool:
        launches, fps, golden = rank_reflect_routes(card, dev, pgr, pool)
        t1 = time.perf_counter()
        errs = rank_reflect_checks(dev)
        t2 = time.perf_counter()
        rows, entry = rank_reflect_timings(card, dev, pgr, errs, launches)
        t3 = time.perf_counter()
        ok, n = True, 0
        for key, fut in golden:
            good, cnt = fut.result()
            ok, n = ok and good, n + cnt
        log(f"reflect debug fixed/cell/auto: det, threshold and scale maps "
            f"vs the golden os_cfar_2d and peak_group on all {BATCH} frames: "
            f"{'equal' if ok else 'DIFFER'} ({n} detections)")
        if not ok:
            raise AssertionError("the fixed reflect debug route differs from "
                                 "the golden model")
    log(f"rank reflect phase: 30b/c {t1 - t0:.1f} s, 30a {t2 - t1:.1f} s, "
        f"30d {t3 - t2:.1f} s, golden wait {time.perf_counter() - t3:.1f} s")
    return rows, {"frames_per_s": fps, "launches": launches, "entry": entry}


def edge_cubes(p, batch: int, seed: int = 0):
    """``make_cubes``'s stimulus with ``edge_batch``'s two edge targets (on
    the first and last range bins but one) on every element: int16 (batch,
    N_ELEMS, nd, nr, 2)."""
    import numpy as np
    from fmcw_tpu_torch.golden import reference
    from fmcw_tpu_torch.models import pipeline as pl
    rng = np.random.default_rng(seed)
    targets = reference.golden_targets(p) + [(1, 3.0, 2000.0),
                                             (p.n_range - 2, -5.0, 2000.0)]
    z = np.asarray(reference.two_target_frame(p, seed=3, targets=targets))
    elems = np.stack([pl.complex_to_iq(z * np.exp(2j * np.pi * 0.5 * e * U0))
                      for e in range(N_ELEMS)])
    out = np.stack([elems] * batch)
    return out + rng.integers(-8, 8, out.shape).astype(np.int16)


def cfar3d_reflect_case(what: str, cube, so: int, cfar, ra: int, ga: int,
                        prepadded: bool = False) -> float:
    """cfar3d_detect's reflect entry on one batch of cubes against its twin
    (det and scale) bit for bit.  Returns the largest |difference| (0), or
    raises."""
    import torch
    from fmcw_tpu_torch.ops import cfar3d_detect as C3
    kw = dict(cfar=cfar, ref_angle=ra, guard_angle=ga,
              prepadded_angle=prepadded)
    got = C3.cfar3d_detect(cube, so, **kw)
    want = C3.cfar3d_detect_plain(cube, so, **kw)
    torch.cuda.synchronize()
    same = all(bits_equal(a, b) for a, b in zip(got, want))
    err = max(float((a.double() - b.double()).nan_to_num().abs().max())
              for a, b in zip(got, want))
    cfg = C3.cfar3d_config(tuple(cube.shape), cfar, ra, ga, so,
                           cube.dtype == torch.int32, prepadded)
    log(f"cfar_3d_detect reflect {what} {tuple(cube.shape)} {cube.dtype} "
        f"ref_angle={ra} guard_angle={ga} so={so}"
        f"{' prepadded' if prepadded else ''} (n_ref {cfg.n_ref}, T {cfg.T}, "
        f"strip {cfg.strip}, packed {cfg.packed}): det and scale "
        f"{'bit-identical' if same else 'DIFFER'} "
        f"({int((got[0] > 0).sum())} detections)")
    if not same:
        raise AssertionError(f"cfar3d_detect reflect ({what}) disagrees with "
                             f"its twin")
    return err


def _beam_shard(cube, s: int, bl: int, h: int, edge: str):
    """Beam shard s (bl planes) of (B, A, R, D) cubes with h halo planes on
    each side: mirrored at the cube's edges ("reflect", as the sharded
    array model exchanges them) or wrapped."""
    import torch
    from fmcw_tpu_torch.ops import cfar as C
    A = cube.shape[1]
    idx = torch.arange(s * bl - h, (s + 1) * bl + h, device=cube.device)
    idx = C.reflect_index(idx, A) if edge == "reflect" else idx % A
    return cube[:, idx].contiguous()


def cfar3d_reflect_checks(dev):
    """Phase 31a: the reflect entry of cfar3d_detect (TPU row 10) against
    its twin bit for bit (det and scale): the array route's own magnitude
    cube of ``edge_cubes`` (16 cubes x 8 beams x 1024x128, kernel A's float
    entry and the magnitude-only entry) and that cube * 16 as int32,
    override 0 and 4, ref_angle 1 and (2, guard 1); adversarial cubes;
    small cubes at a single mirror (2 beams, 7 rows, 6 columns), 37 rows,
    6 rows with the quick window, a window walked at run time (hr 4), a
    training set over 4094 cells (ref_angle 14 on 32 beams), strips of one
    cell (ref_angle 8); the sp 4 beam shards 0 and 3 (the cube's edges,
    their halo planes mirrored) and 1, also against the whole cube's
    interior planes.  Returns ({row: largest |difference|}, the float
    cube)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.golden.reference import rank_adversarial_maps
    from fmcw_tpu_torch.ops import cfar3d_detect as C3
    from fmcw_tpu_torch.ops import frontend as F
    p = reflect_params(P.RadarParams())
    nr, nd = p.n_range, p.n_doppler
    br, bi = beam_planes(torch.as_tensor(edge_cubes(p, ARRAY_BATCH, seed=31),
                                         device=dev))
    cube = F.slowtime_mag(*F.range_fft_float(br, bi))[0].reshape(
        ARRAY_BATCH, N_BEAMS, nr, nd)
    del br, bi
    errs = {"cfar_3d_detect_reflect": 0.0}
    icube = (cube * 16).to(torch.int32)
    for x in (cube, icube):
        for so in (0, 4):
            errs["cfar_3d_detect_reflect"] = max(
                errs["cfar_3d_detect_reflect"],
                cfar3d_reflect_case("array cube", x, so, p.cfar, 1, 0))
        cfar3d_reflect_case("array cube", x, 0, p.cfar, 2, 1)
    del icube
    full = p.cfar
    quick = reflect_params(P.quick()).cfar
    odd = dataclasses.replace(P.CfarParams(
        ref_range=3, ref_doppler=2, guard_range=1, guard_doppler=2),
        edge_mode="reflect")
    for integer in (False, True):
        adv = torch.as_tensor(rank_adversarial_maps(
            (2, N_BEAMS, 1024, 128), integer, 31), device=dev)
        cases = [("adversarial", adv, full, 1, 0),
                 ("adversarial", adv, full, 2, 1),
                 ("single mirror", noise_cube((2, 2, 7, 6), integer, 32),
                  full, 1, 0),
                 ("37 rows", noise_cube((2, 8, 37, 16), integer, 33),
                  full, 1, 0),
                 ("6 rows", noise_cube((2, 8, 6, 16), integer, 34), quick,
                  1, 0),
                 ("window hr 4 gr 1", noise_cube((2, 8, 256, 64), integer,
                                                 35), odd, 2, 1),
                 ("n_ref>4094", noise_cube((1, 32, 32, 16), integer, 36),
                  full, 14, 0),
                 ("strips of one cell", noise_cube((1, 16, 64, 128),
                                                   integer, 37), full, 8, 0)]
        for what, x, cfar, ra, ga in cases:
            x = torch.as_tensor(x, device=dev)
            for so in (0, 4):
                cfar3d_reflect_case(what, x, so, cfar, ra, ga)
    # The sp 4 beam shards 0, 1 and 3, ref_angle 1, and the 2-plane halo of
    # (2, 1) on shard 0 of sp 2.
    whole = C3.cfar3d_detect(cube, cfar=full, ref_angle=1)
    errs["cfar_3d_detect_reflect[prepadded]"] = 0.0
    for sp, s, ra, ga in ((4, 0, 1, 0), (4, 1, 1, 0), (4, 3, 1, 0),
                          (2, 0, 2, 1)):
        bl = N_BEAMS // sp
        x = _beam_shard(cube, s, bl, ra + ga, "reflect")
        err = cfar3d_reflect_case(f"sp {sp} beam shard {s}", x, 0, full, ra,
                                  ga, prepadded=True)
        errs["cfar_3d_detect_reflect[prepadded]"] = max(
            errs["cfar_3d_detect_reflect[prepadded]"], err)
        w = (whole if (ra, ga) == (1, 0) else
             C3.cfar3d_detect(cube, cfar=full, ref_angle=ra, guard_angle=ga))
        got = C3.cfar3d_detect(x, cfar=full, ref_angle=ra, guard_angle=ga,
                               prepadded_angle=True)
        cut = slice(s * bl, (s + 1) * bl)
        if not all(bits_equal(a[:, cut].contiguous(), b)
                   for a, b in zip(w, got)):
            raise AssertionError(f"prepadded reflect cfar3d_detect sp={sp} "
                                 f"shard {s} differs from the whole cube")
    return errs, cube


def cfar3d_reflect_routes(card: str, dev, pgr: int):
    """Phases 31b and 31c: the array model under reflect at full width
    (``edge_cubes``: 16 cubes of 8 elements x 8 beams x 1024x128, radius 2,
    beam radius 1) at ref_angle 0 (kernel A's float entry, the
    magnitude-only entry, cfar_detect's reflect entry per beam, the plain
    grouping, beam_group) and ref_angle 1 (the 3D CFAR's reflect entry, the
    plain per-beam grouping, beam_group): the kernels each launches (no
    kernel B detect entry), cube 0 through the array gate against the plain
    path (taps from the plain cfar_3d with need_debug), the strongest
    detection at the matched beam, cubes/s and the plain grouping's time.
    31c: make_sharded_array_processor on a LocalMesh at sp 2 and 4 (the
    beam halo mirrored at the cube's edges) equal to the single card in
    every output.  Returns (launches by kernel row, cubes/s, stages)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch import kernels, parity
    from fmcw_tpu_torch.golden import reference
    from fmcw_tpu_torch.models import pipeline as pl
    from fmcw_tpu_torch.ops import cfar as C
    from fmcw_tpu_torch.parallel import mesh as M, sharded as SH
    p = reflect_params(P.RadarParams())
    beam = matched_beam()
    batch = torch.as_tensor(edge_cubes(p, ARRAY_BATCH, seed=35), device=dev)
    launches, cps, stages = {}, {}, {}
    common = {"range_fft_float", "slowtime_mag", "beam_group"}
    for ra, cfar_kernel in ((0, "cfar_detect"), (1, "cfar3d_detect")):
        name = f"percell/grouped/ref_angle{ra}"
        kw = dict(n_elems=N_ELEMS, n_beams=N_BEAMS, ref_angle=ra,
                  peak_group_radius=pgr, beam_group_radius=1)
        proc = pl.make_batch_array_processor(p, include_maps=True,
                                             device=dev, **kw)
        kernels.reset_launch_counts()
        out = proc(batch)
        torch.cuda.synchronize()
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        log(f"reflect array {name}: route {proc.route}, launches "
            + ", ".join(f"{k}={v}" for k, v in counts.items()))
        if proc.route != "fused" or set(counts) != common | {cfar_kernel}:
            raise AssertionError(f"reflect array {name}: launches {counts}")
        if ra:
            launches["cfar_3d_detect_reflect"] = counts["cfar3d_detect"]
        for key in ("range_bin", "doppler_bin", "mag", "valid", "beam_bin"):
            if tuple(out[key].shape) != (ARRAY_BATCH, p.tracker.max_dets):
                raise AssertionError(f"{key} shape {tuple(out[key].shape)}")
        if not bool(torch.isfinite(out["mag"]).all()) or \
                int(out["nonfinite_count"].sum()) != 0:
            raise AssertionError("non-finite magnitudes in the array model")
        if not bool((out["beam_bin"][:, 0] == beam).all()):
            raise AssertionError(f"reflect array {name}: strongest detection "
                                 f"off the matched beam {beam}")
        ref = pl.make_array_processor(p, frontend="plain", device=dev,
                                      **kw)(batch[0])
        Mc = ref["mag_cube"]
        _, T, S = C.cfar_3d(Mc, 0, p.cfar, ra, 0, need_debug=True)
        ok, report = parity.array_gate(
            parity.array_set(out, 0), parity.array_set(ref),
            Mc.cpu().numpy(), T.cpu().numpy(), S.cpu().numpy(), radius=pgr,
            beam_radius=1, targets=reference.golden_targets(p),
            target_beam=beam, capacity=p.tracker.max_dets)
        del T, S
        log(f"reflect array {name} cube 0 vs plain path: {report}")
        if not ok:
            raise AssertionError(f"reflect array {name}: array gate failed")
        lean = pl.make_batch_array_processor(p, include_maps=False,
                                             device=dev, **kw)
        cps[name] = ARRAY_BATCH * 1e3 / cuda_ms(lambda: lean(batch), 5, 1)
        group_ms = cuda_ms(lambda: C.peak_group(out["det_cube"], pgr), 5)
        stages[name] = {"path_ms": ARRAY_BATCH * 1e3 / cps[name],
                        "plain_peak_group_ms": group_ms}
        log(f"reflect array {name}: {cps[name]:.1f} cubes/s at "
            f"{ARRAY_BATCH} cubes ({int(out['n_dets'].sum())} detections), "
            f"the plain per-beam peak_group {group_ms:.4f} ms of "
            f"{stages[name]['path_ms']:.4f} ms a batch ({card})")
        for sp in SPLIT_SPS:
            skey = f"{name}/sp{sp}"
            sproc = SH.make_sharded_array_processor(
                M.LocalMesh(1, sp, dev), p, include_maps=True, **kw)
            kernels.reset_launch_counts()
            sout = sproc(batch)
            torch.cuda.synchronize()
            scounts = {k: v for k, v in kernels.launch_counts().items() if v}
            diff = [k for k in out if not torch.equal(sout[k], out[k])]
            if diff or sout.keys() != out.keys() or \
                    not scounts.get(cfar_kernel):
                raise AssertionError(f"reflect sharded array {skey}: differs "
                                     f"in {diff}, launches {scounts}")
            if ra:
                launches["cfar_3d_detect_reflect[prepadded]"] = (
                    launches.get("cfar_3d_detect_reflect[prepadded]", 0)
                    + scounts["cfar3d_detect"])
            lean_s = SH.make_sharded_array_processor(M.LocalMesh(1, sp, dev),
                                                     p, **kw)
            cps[skey] = ARRAY_BATCH * 1e3 / cuda_ms(lambda: lean_s(batch), 3,
                                                    1)
            log(f"reflect sharded array {skey}: every output bit-equal to "
                f"the single card; launches "
                + ", ".join(f"{k}={v}" for k, v in scounts.items())
                + f"; {cps[skey]:.1f} cubes/s on one card ({card})")
            del sout
        del out
    return launches, cps, stages


def cfar3d_reflect_timings(card: str, dev, cube, errs, launches):
    """Phase 31d: the reflect entry of cfar3d_detect by graph replay beside
    the wrap entry on the same cubes (16 cubes x 8 beams x 1024x128, float32
    and int32, ref_angle 1), its bound (bound_cfar3d, the wrap entry's) and
    its twin; the sp 4 edge beam shard (shard 0, its lower halo plane
    mirrored) beside the wrap shard.  Returns (kernel rows, summary)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.ops import cfar3d_detect as C3
    src = "fmcw_tpu_torch/csrc/cfar_3d_detect.cu"
    wc = P.RadarParams().cfar
    rc = reflect_params(P.RadarParams()).cfar
    rows, summary = [], {}
    icube = (cube * 16).to(torch.int32)
    for x, tag in ((cube, ""), (icube, "int32")):
        ms = graph_ms(lambda: C3.cfar3d_detect(x, cfar=rc, ref_angle=1))
        wrap = graph_ms(lambda: C3.cfar3d_detect(x, cfar=wc, ref_angle=1))
        summary[f"cfar_3d_detect_reflect{tag}"] = {"graph_ms": ms,
                                                   "wrap_graph_ms": wrap}
        log(f"cfar_3d_detect_reflect {x.dtype} cube: {ms:.4f} ms (graph), "
            f"the wrap entry {wrap:.4f} ms in the same run "
            f"({ms / wrap:.3f}x) ({card})")
        if tag:
            continue
        plain = cuda_ms(lambda: C3.cfar3d_detect_plain(x, cfar=rc,
                                                       ref_angle=1), 2, 1)
        bound, by = bound_cfar3d(x.numel(), rc, 1, 0, False)
        log(f"cfar_3d_detect_reflect: plain {plain:.4f} ms, bound "
            f"{bound:.4f} ms ({by}) at {ARRAY_BATCH * N_BEAMS} beam maps "
            f"({card})")
        rows.append(dict(name="cfar_3d_detect_reflect", route="cuda",
                         source=src,
                         replaces="fmcw_tpu/ops/cfar_pallas.py:569",
                         launches=launches.get("cfar_3d_detect_reflect", 0),
                         max_abs_err=errs["cfar_3d_detect_reflect"], ms=ms,
                         plain_ms=plain, bound_ms=bound, bound_by=by,
                         library_ms=None))
    del icube
    bl = N_BEAMS // 4
    x = _beam_shard(cube, 0, bl, 1, "reflect")
    w = _beam_shard(cube, 0, bl, 1, "wrap")
    kw = dict(ref_angle=1, prepadded_angle=True)
    ms = graph_ms(lambda: C3.cfar3d_detect(x, cfar=rc, **kw))
    wrap = graph_ms(lambda: C3.cfar3d_detect(w, cfar=wc, **kw))
    plain = cuda_ms(lambda: C3.cfar3d_detect_plain(x, cfar=rc, **kw), 2, 1)
    bound, by = bound_cfar3d(ARRAY_BATCH * bl * cube.shape[-2]
                             * cube.shape[-1], rc, 1, 0, False)
    name = "cfar_3d_detect_reflect[prepadded]"
    log(f"{name} (sp 4 edge beam shard {ARRAY_BATCH}x{bl}+2x1 planes): "
        f"{ms:.4f} ms (graph), the wrap shard {wrap:.4f} ms "
        f"({ms / wrap:.3f}x), plain {plain:.4f} ms, bound {bound:.4f} ms "
        f"({by}) ({card})")
    summary[name] = {"graph_ms": ms, "wrap_graph_ms": wrap}
    rows.append(dict(name=name, route="cuda", source=src,
                     replaces="fmcw_tpu/ops/cfar_pallas.py:569",
                     launches=launches.get(name, 0), max_abs_err=errs[name],
                     ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                     library_ms=None))
    return rows, summary


def cfar3d_reflect_phase(card: str, dev, pgr: int):
    """Phase 31: reflect edges in the 3D CFAR and the array model (31a-d
    above).  Returns (kernel rows, summary)."""
    t0 = time.perf_counter()
    launches, cps, stages = cfar3d_reflect_routes(card, dev, pgr)
    t1 = time.perf_counter()
    errs, cube = cfar3d_reflect_checks(dev)
    t2 = time.perf_counter()
    rows, entry = cfar3d_reflect_timings(card, dev, cube, errs, launches)
    log(f"3D reflect phase: 31b/c {t1 - t0:.1f} s, 31a {t2 - t1:.1f} s, "
        f"31d {time.perf_counter() - t2:.1f} s")
    return rows, {"cubes_per_s": cps, "stages_ms": stages,
                  "launches": launches, "entry": entry}


# ---------------------------------------------------------------------------
# Long CPIs: kernel B at n_doppler = n2d x 128 (phase 32)
# ---------------------------------------------------------------------------

LONG_NDS = (256, 384, 512, 1024, 2048)
LONG_NR = 1024                  # BASELINE config 2: 256 chirps x 1024
LONG_ND = 256
LONG_SRC = "fmcw_tpu_torch/csrc/slowtime_detect.cu"
# Kernel B's entries at each long n_doppler (32a): (variant, scale mode,
# bypass, scale override, grouping radius, notch mode, transform keywords).
LONG_CASES = {
    256: (("os", "cell", False, 0, 2, 2, {}),
          ("os", "cell", True, 4, 0, 2, {}),
          ("os", "block", False, 0, 2, 2, {}),
          ("os", "cell", False, 0, 2, 3,
           dict(transient="passthrough", exact_mag=True)),
          ("os", "block", True, 0, 0, 3, dict(transient="zero")),
          ("ca", "cell", False, 0, 2, 2, {}),
          ("go", "block", False, 0, 0, 2, {}),
          ("so", "cell", False, 6, 2, 2, {})),
    384: (("os", "cell", False, 0, 2, 2, {}),
          ("os", "block", False, 0, 2, 2, {}),
          ("go", "cell", False, 0, 2, 2, {})),
    512: (("os", "cell", False, 0, 2, 2, {}),
          ("os", "block", False, 4, 2, 2, {}),
          ("so", "block", False, 0, 2, 2, {})),
    1024: (("os", "cell", False, 0, 0, 2, {}),
           ("os", "block", False, 0, 2, 2, {}),
           ("ca", "block", False, 0, 2, 2, {})),
    2048: (("os", "cell", False, 0, 2, 2, {}),
           ("os", "block", False, 0, 2, 2, {}),
           ("ca", "cell", True, 0, 2, 2, {})),
}
LONG_SPLIT_NDS = (256, 2048)


def long_params(nd: int, variant: str = "os", scale_mode: str = "cell",
                notch_mode: int = 2):
    import fmcw_tpu_torch as P
    return P.RadarParams(n_range=LONG_NR, n_doppler=nd, notch_mode=notch_mode,
                         cfar=P.CfarParams(variant=variant,
                                           scale_mode=scale_mode))


def long_kernel_checks(dev, pgr: int):
    """Phase 32a: kernel B's long-CPI entries against their twins at
    n_range 1024 and n_doppler 256, 384, 512, 1024, 2048 (batch 16 at 256,
    8 above), on kernel A's planes of bench.py's stimulus: kernel A within
    TOL; each case of LONG_CASES (_b_case: magnitudes within TOL of the
    peak, the decision, row maxima and counts bit for bit against
    detect_plain on the kernel's own magnitudes; at 256 also planes
    holding NaN and Inf); the magnitude-only entry
    within TOL and bit-equal to the detect entry's emitted magnitudes; at
    256 and 2048 the split entry at sp 2 and 4 (OS and CA, per-cell) bit-
    equal to the whole-frame launch's rows and to the twin's decision on
    them.  Returns {entry: largest absolute magnitude error}."""
    import torch
    from fmcw_tpu_torch.ops import frontend as F
    errs = {"detect": 0.0, "mag": 0.0, "split": 0.0}
    for nd in LONG_NDS:
        batch = 16 if nd == 256 else 8
        iq = torch.as_tensor(make_batch(long_params(nd), batch, seed=31),
                             device=dev)
        re, im = F.range_fft(iq)
        pre, pim = F.range_fft_plain(iq)
        torch.cuda.synchronize()
        peak = float(torch.maximum(pre.abs().max(), pim.abs().max()))
        err_a = float(torch.maximum((re - pre).abs().max(),
                                    (im - pim).abs().max()))
        if not err_a <= TOL * peak:
            raise AssertionError(f"range_fft disagrees at {nd} chirps")
        del pre, pim
        for variant, mode, bypass, so, radius, notch, kw in LONG_CASES[nd]:
            p = long_params(nd, variant, mode, notch)
            errs["detect"] = max(errs["detect"], _b_case(
                "long", re, im, p, bypass, so, radius, kw))
        if nd == LONG_ND:
            # NaN and Inf samples: whole rows of non-finite magnitudes, in
            # windows and at a chunk's edge columns.
            nre, nim = re[:4].clone(), im[:4].clone()
            nr = re.shape[1]
            nre[:2, nr // 10, 3] = float("nan")
            nre[:2, 3 * nr // 10, 127] = float("inf")
            nim[1, nr // 2, 0] = float("-inf")
            for variant, mode in (("os", "cell"), ("go", "block")):
                _b_case("nan/inf", nre, nim, long_params(nd, variant, mode),
                        False, 0, pgr)
        det, emitted, _, _, nf = F.slowtime_detect(
            re, im, cfar=long_params(nd).cfar, peak_group_radius=pgr,
            emit_mag=True)
        mag, nf2 = F.slowtime_mag(re, im)
        pmag = F.slowtime_mag_plain(re, im, False)
        torch.cuda.synchronize()
        err = float((mag - pmag).abs().max())
        peak = float(pmag.abs().max())
        errs["mag"] = max(errs["mag"], err)
        same = bits_equal(mag, emitted) and torch.equal(nf, nf2)
        log(f"slowtime_mag {LONG_NR}x{nd} batch {batch}: err "
            f"{err / peak:.3g} of peak, "
            f"{'bit-equal' if same else 'DIFFERS'} to the detect entry's "
            f"magnitudes")
        if not (err <= TOL * peak and same):
            raise AssertionError(f"slowtime_mag disagrees at {nd}")
        del mag, pmag, emitted
        if nd in LONG_SPLIT_NDS:
            errs["split"] = max(errs["split"], long_split_case(
                dev, re, im, nd, pgr))
        del re, im
    return errs


def long_split_case(dev, re, im, nd: int, pgr: int,
                    variants=("os", "ca"), sps=SPLIT_SPS,
                    tag: str = "long") -> float:
    """The split entry on the sp 2 and 4 (``sps``) shards of (re, im), their
    neighbours' rows as halos, against the whole-frame launch (det,
    magnitudes, row maxima bit-equal, counts summing) and the twin's
    decision on the whole frame's magnitudes, for OS and CA
    (``variants``).  Returns the largest absolute magnitude error against
    the twin."""
    import torch
    from fmcw_tpu_torch.ops import frontend as F
    from fmcw_tpu_torch.ops import split_frontend as SF
    nr = re.shape[1]
    h = long_params(nd).cfar.halo_range + pgr
    pmag = F.slowtime_mag_plain(re, im, False)
    peak = float(pmag.abs().max())
    worst = 0.0
    for variant in variants:
        p = long_params(nd, variant)
        kw = dict(cfar=p.cfar, peak_group_radius=pgr, emit_mag=True)
        det, mag, rmax, ndet, nf = F.slowtime_detect(re, im, False, 0, **kw)
        for sp in sps:
            nrl = nr // sp
            same, total, total_nf = True, 0, 0
            for s in range(sp):
                rows = slice(s * nrl, (s + 1) * nrl)
                ext = torch.arange(s * nrl - h, (s + 1) * nrl + h,
                                   device=dev) % nr
                lo, hi = ext[:h], ext[h + nrl:]
                d_s, m_s, r_s, n_s, f_s = SF.slowtime_detect_split(
                    re[:, rows], im[:, rows], (re[:, lo], im[:, lo]),
                    (re[:, hi], im[:, hi]), False, 0, s * nrl,
                    n_range_total=nr, **kw)
                d2, r2, n2 = SF.detect_halo_plain(mag[:, ext], p.cfar, 0,
                                                  pgr, s * nrl, nr)
                torch.cuda.synchronize()
                worst = max(worst, float((m_s - pmag[:, rows]).abs().max()))
                same &= (bits_equal(d_s, det[:, rows])
                         and bits_equal(m_s, mag[:, rows])
                         and bits_equal(r_s, rmax[:, rows])
                         and bits_equal(d_s, d2) and bits_equal(r_s, r2)
                         and torch.equal(n_s, n2))
                total = total + n_s
                total_nf = total_nf + f_s
            same &= (torch.equal(total, ndet) and torch.equal(total_nf, nf)
                     and worst <= TOL * peak)
            log(f"split {tag} {variant} {nr}x{nd} sp={sp}: shards "
                f"{'bit-equal' if same else 'DIFFER'} to the whole-frame "
                f"entry and its twin ({int(ndet.sum())} detections)")
            if not same:
                raise AssertionError(f"slowtime_detect_split {variant} at "
                                     f"{nd} sp={sp} differs")
    return worst


def long_main_path(card: str, dev, pgr: int):
    """Phase 32b: BASELINE config 2 (1024x256) at batch 128 of bench.py's
    stimulus through make_batch_processor(include_maps=False): the entry
    config (per-cell), fast() (block) and GO per-cell.  Float "auto" is now
    the fused route; the kernels it launches; frame 0 through the margin
    gate against the plain route's exact taps; frames/s and samples/s beside
    the staged route (the route long CPIs took before), timed in the same
    run.  Returns ({row: launches}, summary)."""
    import torch
    from fmcw_tpu_torch import kernels, parity
    from fmcw_tpu_torch.golden import reference
    from fmcw_tpu_torch.models import pipeline as pl
    launches, summary = {}, {}
    for name, p in (("cell", long_params(LONG_ND)),
                    ("block", long_params(LONG_ND, scale_mode="block")),
                    ("go", long_params(LONG_ND, "go"))):
        proc = pl.make_batch_processor(p, peak_group_radius=pgr,
                                       include_maps=False, device=dev)
        if proc.route != "fused":
            raise AssertionError(f"long CPI auto is {proc.route}, not fused")
        batch = torch.as_tensor(make_batch(p, BATCH), device=dev)
        kernels.reset_launch_counts()
        out = proc(batch)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        log(f"long main path {name}: launches "
            + ", ".join(f"{k}={v}" for k, v in counts.items() if v))
        if counts["range_fft"] < 1 or counts["slowtime_detect"] < 1:
            raise AssertionError(f"long main path {name} skipped a kernel")
        launches[name] = counts["slowtime_detect"]
        launches["range_fft"] = launches.get("range_fft", 0) + \
            counts["range_fft"]
        if not bool(torch.isfinite(out["mag"]).all()) or int(
                out["nonfinite_count"].sum()) != 0:
            raise AssertionError("non-finite magnitudes")
        ref = pl.make_processor(p, peak_group_radius=pgr, frontend="plain",
                                include_debug=True, cfar_rank_bits=None,
                                device=dev)(batch[0])
        ok, report = parity.margin_gate(
            parity.detection_set(out, 0), parity.detection_set(ref),
            ref["mag_map"].cpu().numpy(), ref["threshold_map"].cpu().numpy(),
            ref["scale_map"].cpu().numpy(), radius=pgr,
            capacity=p.tracker.max_dets,
            targets=reference.golden_targets(p))
        log(f"long main path {name} frame 0 vs plain path: {report}")
        if not ok:
            raise AssertionError(f"long main path {name}: margin gate failed")
        del ref, out
        staged = pl.make_batch_processor(p, frontend="staged",
                                         peak_group_radius=pgr,
                                         include_maps=False, device=dev)
        fps = BATCH * 1e3 / cuda_ms(lambda: proc(batch), 10)
        fps_staged = BATCH * 1e3 / cuda_ms(lambda: staged(batch), 3)
        cells = p.n_range * p.n_doppler
        summary[name] = {"frames_per_s": fps, "samples_per_s": fps * cells,
                         "staged_frames_per_s": fps_staged,
                         "staged_samples_per_s": fps_staged * cells}
        log(f"long main path {name} {LONG_NR}x{LONG_ND}: {fps:.1f} frames/s "
            f"= {fps * cells:.4g} samples/s (fused), staged route "
            f"{fps_staged:.1f} frames/s = {fps_staged * cells:.4g} samples/s "
            f"at batch {BATCH} ({card})")
    return launches, summary


def mag_route_case(dev, pgr: int, p, batch, tag: str,
                   reflect: bool = False) -> int:
    """A float route on ``batch`` through kernel B's magnitude-only entry,
    frame 0 through the margin gate against the plain route's: the debug
    taps on the fused route (kernel A, the magnitude-only entry, the
    rank-select CFAR's grouping entry) or, with ``reflect``, float "auto"
    under reflect edges (kernel A, the magnitude-only entry, the standalone
    CFAR's reflect entry, the plain grouping).  Returns the magnitude-only
    entry's launches in that run."""
    import torch
    from fmcw_tpu_torch import kernels, parity
    from fmcw_tpu_torch.golden import reference
    from fmcw_tpu_torch.models import pipeline as pl
    kw = dict(peak_group_radius=pgr, include_debug=True)
    if reflect:
        what, need = "reflect auto", ("range_fft", "slowtime_mag",
                                      "cfar_detect")
        p = p.replace(cfar=dataclasses.replace(p.cfar, edge_mode="reflect"))
        proc = pl.make_batch_processor(p, peak_group_radius=pgr, device=dev)
    else:
        what, need = "debug taps", ("range_fft", "slowtime_mag",
                                    "cfar_rank_group")
        proc = pl.make_batch_processor(p, device=dev, **kw)
    kernels.reset_launch_counts()
    out = proc(batch)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    log(f"{tag} {what}: route {proc.route}, launches "
        + ", ".join(f"{k}={v}" for k, v in counts.items() if v))
    if proc.route != "fused" or min(counts[k] for k in need) < 1:
        raise AssertionError(f"{tag} {what} skipped a kernel")
    ref = pl.make_processor(p, frontend="plain", device=dev, **kw)(batch[0])
    ok, report = parity.margin_gate(
        parity.detection_set(out, 0), parity.detection_set(ref),
        ref["mag_map"].cpu().numpy(), ref["threshold_map"].cpu().numpy(),
        ref["scale_map"].cpu().numpy(), radius=pgr,
        capacity=p.tracker.max_dets, targets=reference.golden_targets(p))
    log(f"{tag} {what} frame 0 vs plain path: {report}")
    if not ok:
        raise AssertionError(f"{tag} {what}: margin gate failed")
    return counts["slowtime_mag"]


def long_other_routes(card: str, dev, pgr: int, p=None,
                      tag: str = "long"):
    """Phase 32c: at 1024x256 and batch 16 the float debug taps on the
    fused route (kernel A, kernel B's magnitude-only entry, the rank-select
    CFAR's grouping entry) and float "auto" under reflect edges (the
    magnitude-only entry, the standalone CFAR's reflect entry), frame 0
    through the margin gate against the plain route's; the hw-compat float
    route (the magnitude-only entry, the flat-stream entry), its det maps
    bit for bit the twin's on its magnitudes; the array model (8 elements x
    8 beams, 16 cubes) at
    ref_angle 0 (kernel B's detect entry per beam, cross-beam grouping) and
    1 (the magnitude-only entry, the 3D CFAR), cube 0 through the array
    gate against the plain route.  Returns {kernel: launches} of one path:
    the magnitude-only entry's in the debug taps' run.  Phase 36c runs it
    at another frame (``p``), its lines and errors tagged ``tag``."""
    import torch
    from fmcw_tpu_torch import kernels, parity
    from fmcw_tpu_torch.golden import reference
    from fmcw_tpu_torch.models import pipeline as pl
    from fmcw_tpu_torch.ops import cfar as C
    launches = {}
    p = p or long_params(LONG_ND)
    batch = torch.as_tensor(make_batch(p, ARRAY_BATCH, seed=4), device=dev)
    kw = dict(peak_group_radius=pgr, include_debug=True)
    launches["slowtime_mag"] = mag_route_case(dev, pgr, p, batch, tag)
    # Reflect edges (the magnitude-only entry, then the standalone CFAR's
    # reflect entry and the plain grouping) through the margin gate, and
    # the hw-compat float route (the magnitude-only entry, then the
    # flat-stream entry) bit for bit against the twin on its magnitudes.
    r = p.replace(cfar=dataclasses.replace(p.cfar, edge_mode="reflect"))
    proc = pl.make_batch_processor(r, peak_group_radius=pgr, device=dev)
    kernels.reset_launch_counts()
    out = proc(batch)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    if proc.route != "fused" or min(counts["slowtime_mag"],
                                    counts["cfar_detect"]) < 1:
        raise AssertionError(f"{tag} reflect route skipped a kernel")
    ref = pl.make_processor(r, frontend="plain", device=dev, **kw)(batch[0])
    ok, report = parity.margin_gate(
        parity.detection_set(out, 0), parity.detection_set(ref),
        ref["mag_map"].cpu().numpy(), ref["threshold_map"].cpu().numpy(),
        ref["scale_map"].cpu().numpy(), radius=pgr,
        capacity=p.tracker.max_dets, targets=reference.golden_targets(p))
    log(f"{tag} reflect auto: launches "
        + ", ".join(f"{k}={v}" for k, v in counts.items() if v)
        + f"; frame 0 vs plain path: {report}")
    if not ok:
        raise AssertionError(f"{tag} reflect: margin gate failed")
    del out, ref
    proc = pl.make_batch_processor(p, cfar_geometry="hw_stream", device=dev)
    kernels.reset_launch_counts()
    out = proc(batch)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    det, _, _ = C.cfar_2d_hw_stream(out["mag_map"], cfar=p.cfar,
                                    integer=False)
    same = bits_equal(det, out["det_map"])
    log(f"{tag} hw_stream float fused: launches "
        + ", ".join(f"{k}={v}" for k, v in counts.items() if v)
        + f"; det maps {'bit-identical' if same else 'DIFFER'} to the twin "
        f"on the route's magnitudes ({int((det != 0).sum())} detections)")
    if (proc.route != "fused" or not same
            or min(counts["slowtime_mag"], counts["cfar_detect_hw_stream"])
            < 1):
        raise AssertionError(f"{tag} hw_stream route failed its check")
    del out, det
    beam = matched_beam()
    cubes = torch.as_tensor(make_cubes(p, ARRAY_BATCH), device=dev)
    for name, akw, need in (
            ("percell/grouped", dict(peak_group_radius=2, beam_group_radius=1),
             ("range_fft_float", "slowtime_detect", "beam_group")),
            ("ref_angle1", dict(ref_angle=1, guard_angle=0),
             ("range_fft_float", "slowtime_mag", "cfar3d_detect"))):
        aproc = pl.make_batch_array_processor(
            p, n_elems=N_ELEMS, n_beams=N_BEAMS, include_maps=False,
            device=dev, **akw)
        kernels.reset_launch_counts()
        out = aproc(cubes)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        log(f"{tag} array {name}: route {aproc.route}, launches "
            + ", ".join(f"{k}={v}" for k, v in counts.items() if v))
        if aproc.route != "fused" or any(counts[k] < 1 for k in need):
            raise AssertionError(f"{tag} array {name} skipped a kernel")
        if name == "percell/grouped":
            launches["range_fft_float"] = counts["range_fft_float"]
        if not bool((out["beam_bin"][:, 0] == beam).all()) or int(
                out["nonfinite_count"].sum()) != 0:
            raise AssertionError(f"{tag} array {name}: strongest detection "
                                 f"off beam {beam} or non-finite cells")
        ref = pl.make_array_processor(p, n_elems=N_ELEMS, n_beams=N_BEAMS,
                                      frontend="plain", device=dev,
                                      **akw)(cubes[0])
        M = ref["mag_cube"]
        _, T, S = C.cfar_3d(M, 0, p.cfar, akw.get("ref_angle", 0),
                            akw.get("guard_angle", 0), need_debug=True)
        ok, report = parity.array_gate(
            parity.array_set(out, 0), parity.array_set(ref),
            M.cpu().numpy(), T.cpu().numpy(), S.cpu().numpy(),
            radius=akw.get("peak_group_radius", 0),
            beam_radius=akw.get("beam_group_radius", 0),
            targets=reference.golden_targets(p), target_beam=beam,
            capacity=p.tracker.max_dets)
        del T, S, M, ref, out
        log(f"{tag} array {name} cube 0 vs plain path: {report} ({card})")
        if not ok:
            raise AssertionError(f"{tag} array {name}: array gate failed")
    return launches


def long_local_mesh(card: str, dev, pgr: int, configs=None,
                    tag: str = "long"):
    """Phase 32d: make_sharded_processor on a LocalMesh at sp 2 and 4 at
    1024x256 (batch 16): per-cell (kernel B's split entry), block (the
    magnitude-only entry, the sharded block tail) and the debug taps, every
    output bit-equal to the single card's.  Returns {kernel: launches} of
    one path: the split entry's in the per-cell run at sp 4.  Phase 36c
    runs it on other ``configs`` (name, params, keywords, kernel), its
    lines tagged ``tag``."""
    import torch
    from fmcw_tpu_torch import kernels
    from fmcw_tpu_torch.models import pipeline as pl
    from fmcw_tpu_torch.parallel import mesh as M, sharded as SH
    launches = {}
    for name, p, kw, need in configs or (
            ("cell", long_params(LONG_ND), {}, "slowtime_detect_split"),
            ("block", long_params(LONG_ND, scale_mode="block"), {},
             "slowtime_mag"),
            ("debug", long_params(LONG_ND), dict(include_debug=True),
             "slowtime_mag")):
        batch = torch.as_tensor(make_batch(p, ARRAY_BATCH, seed=7),
                                device=dev)
        kw = dict(peak_group_radius=pgr, include_maps=True, **kw)
        ref = pl.make_batch_processor(p, device=dev, **kw)(batch)
        for sp in SPLIT_SPS:
            proc = SH.make_sharded_processor(M.LocalMesh(1, sp, dev), p, **kw)
            kernels.reset_launch_counts()
            out = proc(batch)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            diff = [k for k in ref if not torch.equal(out[k], ref[k])]
            log(f"{tag} LocalMesh {name} sp={sp}: launches "
                + ", ".join(f"{k}={v}" for k, v in counts.items() if v)
                + f"; {'all outputs bit-equal' if not diff else diff} to "
                f"the single card")
            if diff or out.keys() != ref.keys() or counts[need] < 1:
                raise AssertionError(f"{tag} LocalMesh {name} sp={sp} "
                                     f"differs or skipped {need}")
            if name == "cell" and sp == SPLIT_SPS[-1]:
                launches[need] = counts[need]
                launches["range_frontend"] = counts["range_frontend"]
    return launches


def long_timings(card: str, dev, pgr: int, errs, launches):
    """Phase 32e: graph-replay times of the long-CPI entries at 1024x256,
    batch 128 (the kernels line) and 1024x2048, batch 16 (the summary),
    each beside its bound (bound_slowtime, bound_slowtime_mag,
    bound_slowtime_split: the function's least work, an nd-point FFT per
    row, whatever transform the kernel runs), its plain twin and
    torch.fft.fft of its complex planes (the summary).  Returns (rows,
    summary)."""
    import torch
    from fmcw_tpu_torch.ops import frontend as F
    from fmcw_tpu_torch.ops import split_frontend as SF
    rows, summary = [], {}
    for nd, batch in ((LONG_ND, BATCH), (2048, 16)):
        iq = torch.as_tensor(make_batch(long_params(nd), batch, seed=33),
                             device=dev)
        re, im = F.range_fft(iq)
        del iq
        z = torch.complex(re, im)
        fft = graph_ms(lambda: torch.fft.fft(z, dim=-1))
        del z
        entries = []
        for name, p in (("cell", long_params(nd)),
                        ("block", long_params(nd, scale_mode="block")),
                        ("go", long_params(nd, "go"))):
            kw = dict(cfar=p.cfar, peak_group_radius=pgr)
            entries.append((
                f"slowtime_detect[long,{name}]",
                lambda kw=kw: F.slowtime_detect(re, im, False, 0, **kw),
                lambda kw=kw: F.slowtime_detect_plain(re, im, False, 0,
                                                      **kw),
                bound_slowtime(batch, LONG_NR, nd, p.cfar),
                launches.get(name, 0), errs["detect"],
                "fmcw_tpu/ops/frontend_pallas.py:719"))
        entries.append((
            "slowtime_mag[long]", lambda: F.slowtime_mag(re, im),
            lambda: F.slowtime_mag_plain(re, im, False),
            bound_slowtime_mag(batch, LONG_NR, nd),
            launches.get("slowtime_mag", 0), errs["mag"],
            "fmcw_tpu/ops/frontend_pallas.py:633"))
        cfar = long_params(nd).cfar
        sp, s = 4, 1
        nrl, h = LONG_NR // sp, cfar.halo_range + pgr
        ext = torch.arange(s * nrl - h, (s + 1) * nrl + h, device=dev) % LONG_NR
        lo, hi, core = ext[:h], ext[h + nrl:], ext[h:h + nrl]
        args = (re[:, core].contiguous(), im[:, core].contiguous(),
                (re[:, lo].contiguous(), im[:, lo].contiguous()),
                (re[:, hi].contiguous(), im[:, hi].contiguous()), False, 0,
                s * nrl)
        skw = dict(cfar=cfar, n_range_total=LONG_NR, peak_group_radius=pgr)
        z = torch.complex(re[:, ext], im[:, ext])
        fft_shard = graph_ms(lambda: torch.fft.fft(z, dim=-1))
        del z
        entries.append((
            "slowtime_detect_split[long]",
            lambda: SF.slowtime_detect_split(*args, **skw),
            lambda: SF.slowtime_detect_split_plain(*args, **skw),
            bound_slowtime_split(batch, nrl, nd, h, cfar),
            launches.get("slowtime_detect_split", 0), errs["split"],
            "fmcw_tpu/ops/split_frontend.py:518"))
        for name, call, plain, (bound, by), n, err, line in entries:
            ms = graph_ms(call)
            plain_ms = cuda_ms(plain, 2, 1)
            lib = fft_shard if "split" in name else fft
            log(f"{name} {LONG_NR}x{nd} batch {batch}: {ms:.4f} ms (graph), "
                f"plain {plain_ms:.4f} ms, torch.fft.fft of its planes "
                f"{lib:.4f} ms, bound {bound:.4f} ms ({by}) ({card})")
            summary[f"{name}@{nd}x{batch}"] = {
                "ms": ms, "plain_ms": plain_ms, "fft_ms": lib,
                "bound_ms": bound, "bound_by": by}
            if nd == LONG_ND:
                # No PyTorch call computes an entry: torch.fft.fft is only
                # its transform's share (the summary's fft_ms).
                rows.append(dict(name=name, route="cuda", source=LONG_SRC,
                                 replaces=line, launches=n, max_abs_err=err,
                                 ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                 bound_by=by, library_ms=None))
        del re, im, args
    return rows, summary


def long_cpi_phase(card: str, dev, pgr: int):
    """Phase 32: kernel B's long-CPI split (32a-e above).  Returns (kernel
    rows, summary)."""
    import torch
    t0 = time.perf_counter()
    errs = long_kernel_checks(dev, pgr)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    launches, summary = long_main_path(card, dev, pgr)
    t2 = time.perf_counter()
    launches.update(long_other_routes(card, dev, pgr))
    t3 = time.perf_counter()
    launches.update(long_local_mesh(card, dev, pgr))
    t4 = time.perf_counter()
    rows, timings = long_timings(card, dev, pgr, errs, launches)
    log(f"long-CPI phase: 32a {t1 - t0:.1f} s, 32b {t2 - t1:.1f} s, 32c "
        f"{t3 - t2:.1f} s, 32d {t4 - t3:.1f} s, 32e "
        f"{time.perf_counter() - t4:.1f} s")
    return rows, {"main_path": summary, "timings": timings,
                  "launches": launches}


# ---------------------------------------------------------------------------
# Long CPIs in fixed mode: the fixed slow-time kernel at n_doppler = n2d x
# 128 (phase 33)
# ---------------------------------------------------------------------------

FIXED_LONG_SRC = "fmcw_tpu_torch/csrc/slowtime_detect_fixed.cu"
# The fixed slow-time kernel's long-CPI cases (33a): (variant, scale mode,
# bypass, scale override, grouping radius, notch mode, chain keywords).
FIXED_LONG_CASES = (
    ("os", "cell", False, 0, 2, 2, {}),
    ("os", "block", False, 0, 2, 2, {}),
    ("ca", "cell", True, 0, 0, 2, {}),
    ("go", "block", False, 4, 2, 2, {}),
    ("so", "cell", False, LARGE_SO, 1, 2, {}),
    ("os", "cell", False, 0, 1, 3,
     dict(transient="passthrough", rounding="biased")),
    ("os", "block", False, 0, 0, 3, dict(transient="zero")))


def fixed_long_tie_checks(dev, nd: int) -> int:
    """The fixed slow-time kernel on exact round-half ties at a long CPI,
    MTI bypassed, radius 0, against the golden numpy model: eighth-turn
    tie planes (bin nd/8, golden.reference.doppler_eighth_tie_planes) and
    quarter-turn tie planes (bin 0, doppler_quarter_tie_planes), 64 rows
    each;
    the kernel bit-equal to its twin.  Where nd is not a power of two the
    golden model's np.fft.fft (mixed radix) need not give the exact bins
    (quarter, eighth and, where 12 divides nd, sixth and twelfth turns)
    exactly, and may round their exact ties the other way: there values
    may differ at bins k with 24 k / nd whole only, and are counted.
    Returns those values."""
    import numpy as np
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.golden import reference
    from fmcw_tpu_torch.ops import frontend_fixed as FX
    p = P.RadarParams(n_range=64, n_doppler=nd)
    for seed in range(nd, nd + 8):
        try:
            eighth = reference.doppler_eighth_tie_planes(seed, 1, 64, nd)
            break
        except ValueError:          # a row the last chirps cannot reach
            continue
    tw_bins = 0
    for name, (re, im) in (("eighth", eighth),
                           ("quarter", reference.doppler_quarter_tie_planes(
                               nd, 1, 64, nd))):
        gold = [reference.process_rows_fixed(a.astype(np.int64),
                                             b.astype(np.int64), p,
                                             mti_bypass=True)
                for a, b in zip(re, im)]
        det, mag, _, ndet, _ = FX.slowtime_detect_fixed(
            torch.as_tensor(re, device=dev), torch.as_tensor(im, device=dev),
            True, 0, cfar=p.cfar, emit_mag=True)
        tmag, _ = FX.slowtime_mag_fixed_plain(torch.as_tensor(re),
                                              torch.as_tensor(im), True)
        mag = mag.cpu().numpy()
        off = np.argwhere(mag != np.stack([g[0] for g in gold]))[:, -1]
        exact_bins = nd & (nd - 1) and bool((off * 24 % nd == 0).all())
        off_d = int((det.cpu().numpy() != np.stack([g[1] for g in gold]))
                    .sum())
        same_twin = np.array_equal(mag, tmag.numpy())
        log(f"fixed long {name}-turn ties at 64x{nd}: "
            f"{off.size} magnitudes, {off_d} detections differ from the "
            f"golden model ({int(ndet.sum())} detections), twin "
            f"{'bit-equal' if same_twin else 'DIFFERS'}")
        if not same_twin or (off.size or off_d) and not exact_bins:
            raise AssertionError(f"fixed long {name}-turn ties at {nd} "
                                 f"differ")
        tw_bins += off.size
    return tw_bins


def fixed_long_kernel_checks(dev, pgr: int):
    """Phase 33a: the fixed slow-time kernel's long CPIs against its twin,
    bit for bit (values, magnitudes, decisions, row maxima, counts,
    saturations), at n_range 1024 and n_doppler 256, 384, 512, 1024, 2048
    (batch 8 at 256, 4 above): the fixed range kernel's planes of
    bench.py's stimulus (the range kernel equal to its twin there) through
    FIXED_LONG_CASES (OS, CA, GO, SO; per-cell and block; overrides 0, 4
    and 2^20; the bypass; notch 2 and 3, both transients and roundings;
    radius 0-2), the saturating x40 batch with the MTI on and bypassed;
    the tie planes (fixed_long_tie_checks); then the split entry at sp 2
    and 4 at 256 and 2048 (OS and CA, the MTI on and bypassed): shards
    bit-equal to the whole-frame launch's rows, counts and saturations
    summing, the decision equal to the twin's on the twin's halo-extended
    magnitudes.  Returns ({entry: largest magnitude difference}, the
    golden model's differences at exact bins of nd 384)."""
    import torch
    from fmcw_tpu_torch.ops import frontend_fixed as FX
    errs = {"detect": 0.0, "split": 0.0}
    tw_bins = 0
    for nd in LONG_NDS:
        batch = 8 if nd == LONG_ND else 4
        iq = torch.as_tensor(make_batch(long_params(nd), batch, seed=41),
                             device=dev)
        re, im, sat_r = FX.range_fft_fixed(iq)
        pre, pim, psat = FX.range_fft_fixed_plain(iq)
        torch.cuda.synchronize()
        if not (torch.equal(re, pre) and torch.equal(im, pim)
                and torch.equal(sat_r, psat)):
            raise AssertionError(f"range_fft_fixed differs at {nd} chirps")
        log(f"range_fft_fixed {LONG_NR}x{nd} batch {batch}: values and "
            f"saturations equal to the twin")
        del pre, pim
        cases = FIXED_LONG_CASES if nd in (LONG_ND, 2048) else \
            FIXED_LONG_CASES[:4]
        for variant, mode, bypass, so, radius, notch, kw in cases:
            p = long_params(nd, variant, mode, notch)
            if kw.get("rounding"):
                pr, pi, _ = FX.range_fft_fixed(iq, rounding=kw["rounding"])
            else:
                pr, pi = re, im
            errs["detect"] = max(errs["detect"], _fx_case(
                "long", pr, pi, p, bypass, so, radius, kw))
        hot = torch.as_tensor(hot_batch(long_params(nd), 2), device=dev)
        hre, him, _ = FX.range_fft_fixed(hot)
        for bypass in (False, True):
            _fx_case("long x40", hre, him, long_params(nd), bypass, 0, pgr)
        tw_bins += fixed_long_tie_checks(dev, nd)
        if nd in LONG_SPLIT_NDS:
            errs["split"] = max(errs["split"], fixed_long_split_case(
                dev, re, im, nd, pgr))
        del re, im, hre, him
    return errs, tw_bins


def fixed_long_split_case(dev, re, im, nd: int, pgr: int,
                          tag: str = "fixed split long",
                          variants=("os", "ca"), sps=SPLIT_SPS,
                          bypasses=(False, True),
                          quiet: bool = False) -> float:
    """The fixed split entry on the sp 2 and 4 (``sps``) shards of (re,
    im), their neighbours' rows as halos, against the whole-frame launch
    and the twin (fixed_variant_kernel_checks' comparison), OS and CA
    (``variants``), the MTI on and bypassed (``bypasses``); each case
    logged unless ``quiet``.  Returns the largest magnitude difference
    against the twin (0)."""
    import torch
    from fmcw_tpu_torch.ops import frontend_fixed as FX
    from fmcw_tpu_torch.ops import split_frontend as SF
    nr = re.shape[1]
    h = long_params(nd).cfar.halo_range + pgr
    worst = 0
    for bypass in bypasses:
        pmag = FX.slowtime_mag_fixed_plain(re, im, bypass)[0]
        for variant in variants:
            p = long_params(nd, variant)
            kw = dict(cfar=p.cfar, peak_group_radius=pgr, emit_mag=True)
            det, mag, rmax, ndet, sat = FX.slowtime_detect_fixed(
                re, im, bypass, 0, **kw)
            for sp in sps:
                nrl = nr // sp
                same, n_sum, s_sum = True, 0, 0
                for s in range(sp):
                    rows = slice(s * nrl, (s + 1) * nrl)
                    ext = torch.arange(s * nrl - h, (s + 1) * nrl + h,
                                       device=dev) % nr
                    lo, hi = ext[:h], ext[h + nrl:]
                    d_s, m_s, r_s, n_s, st = SF.slowtime_detect_fixed_split(
                        re[:, rows], im[:, rows], (re[:, lo], im[:, lo]),
                        (re[:, hi], im[:, hi]), bypass, 0, s * nrl,
                        n_range_total=nr, **kw)
                    d2, r2, n2 = SF.detect_halo_plain(pmag[:, ext], p.cfar,
                                                      0, pgr, s * nrl, nr)
                    torch.cuda.synchronize()
                    err = int((m_s - pmag[:, rows]).abs().max())
                    worst = max(worst, err)
                    same &= (err == 0 and torch.equal(d_s, det[:, rows])
                             and torch.equal(m_s, mag[:, rows])
                             and torch.equal(r_s, rmax[:, rows])
                             and torch.equal(d_s, d2)
                             and torch.equal(r_s, r2)
                             and torch.equal(n_s, n2))
                    n_sum, s_sum = n_sum + n_s, s_sum + st
                same &= torch.equal(n_sum, ndet) and torch.equal(s_sum, sat)
                if not quiet or not same:
                    log(f"{tag} {variant} {nr}x{nd} sp={sp} "
                        f"bypass={bypass}: shards "
                        f"{'bit-equal' if same else 'DIFFER'} to the "
                        f"whole-frame entry and the twin "
                        f"({int(ndet.sum())} detections, saturation "
                        f"{int(sat.sum())})")
                if not same:
                    raise AssertionError(f"slowtime_detect_fixed_split long "
                                         f"{variant} at {nd} sp={sp} differs")
    return float(worst)


def golden_frames_check(job):
    """A worker process's job: (int16 frames (B, nd, nr, 2), the route's
    mag and det maps, RadarParams, grouping radius); True where the golden
    process_frame_fixed (and peak_group) gives every map exactly, and the
    detection count."""
    import numpy as np
    from fmcw_tpu_torch.golden import fixed_point as gfx, reference
    frames, mags, dets, p, radius = job
    ok, n = True, 0
    for f, m, d in zip(frames, mags, dets):
        gmag, gdet = reference.process_frame_fixed(
            f[..., 0] + 1j * f[..., 1].astype(np.float64), p)
        if radius:
            gdet = gfx.peak_group(gdet, radius)
        ok &= bool(np.array_equal(gmag, m) and np.array_equal(gdet, d))
        n += int((gdet > 0).sum())
    return ok, n


def fixed_long_main_path(card: str, dev, pgr: int, pool):
    """Phase 33b: BASELINE config 2 (1024x256, batch 128 of bench.py's
    stimulus) through make_batch_processor(mode="fixed", frontend="fused")
    for the entry config (per-cell), fast() (block) and CA per-cell: only
    range_fft_fixed and slowtime_detect_fixed launch, no plain stage
    (PlainStages); every output bit-equal to fixed "auto" (the staged
    route); the mag and det maps of every frame (the entry config; the
    first 32 of the others) held to the golden process_frame_fixed by
    worker processes (collected by the caller); frames/s beside the staged
    route's, both without the maps.  Returns ({config:
    slowtime_detect_fixed launches}, summary, golden futures)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch import kernels
    from fmcw_tpu_torch.models import pipeline as pl
    launches, summary, golden = {}, {}, []
    for name, p in (("cell", long_params(LONG_ND)),
                    ("block", P.fast().replace(n_doppler=LONG_ND)),
                    ("ca", long_params(LONG_ND, "ca"))):
        frames = make_batch(p, BATCH, seed=43)
        batch = torch.as_tensor(frames, device=dev)
        outs = {}
        for fe in ("fused", "auto"):
            proc = pl.make_batch_processor(p, mode="fixed", frontend=fe,
                                           peak_group_radius=pgr, device=dev)
            kernels.reset_launch_counts()
            with PlainStages() as plain:
                out = proc(batch)
                torch.cuda.synchronize()
            counts = {k: v for k, v in kernels.launch_counts().items() if v}
            log(f"fixed long main path {name} {fe} ({proc.route}): launches "
                + (", ".join(f"{k}={v}" for k, v in counts.items())
                   or "none") + f"; plain stages {plain.calls or 'none'}")
            if fe == "fused" and (
                    proc.route != "fused" or plain.calls or set(counts) != {
                        "range_fft_fixed", "slowtime_detect_fixed"}):
                raise AssertionError(f"fixed long {name}: the fused route "
                                     f"ran {counts}, {plain.calls}")
            if fe == "fused":
                launches[name] = counts["slowtime_detect_fixed"]
                launches["range_fft_fixed"] = (
                    launches.get("range_fft_fixed", 0)
                    + counts["range_fft_fixed"])
            outs[fe] = out
        diff = [k for k in outs["auto"]
                if not torch.equal(outs["auto"][k], outs["fused"][k])]
        if diff or int(outs["fused"]["n_dets"].min()) <= 0:
            raise AssertionError(f"fixed long {name}: fused and auto differ "
                                 f"in {diff}")
        # Every frame of the entry config; the first 32 of the others (the
        # golden model takes ~1.8 s a frame at 1024x256 on one core).
        n_gold = BATCH if name == "cell" else 32
        mags = outs["fused"]["mag_map"][:n_gold].cpu().numpy()
        dets = outs["fused"]["det_map"][:n_gold].cpu().numpy()
        for i in range(0, n_gold, 16):
            golden.append((name, pool.submit(
                golden_frames_check, (frames[i:i + 16], mags[i:i + 16],
                                      dets[i:i + 16], p, pgr))))
        del outs, mags, dets
        lean = {fe: pl.make_batch_processor(
            p, mode="fixed", frontend=fe, peak_group_radius=pgr,
            include_maps=False, device=dev) for fe in ("fused", "auto")}
        fps = BATCH * 1e3 / cuda_ms(lambda: lean["fused"](batch), 10)
        fps_staged = BATCH * 1e3 / cuda_ms(lambda: lean["auto"](batch), 3, 1)
        cells = p.n_range * p.n_doppler
        summary[name] = {"frames_per_s": fps, "samples_per_s": fps * cells,
                         "staged_frames_per_s": fps_staged}
        log(f"fixed long main path {name} {LONG_NR}x{LONG_ND}: fused route "
            f"bit-equal to auto in every output; {fps:.1f} frames/s = "
            f"{fps * cells:.4g} samples/s (fused), staged {fps_staged:.1f} "
            f"frames/s ({fps / fps_staged:.2f}x) at batch {BATCH} ({card})")
    return launches, summary, golden


def fixed_long_local_mesh(card: str, dev, pgr: int, configs=None,
                          tag: str = "fixed long"):
    """Phase 33c: make_sharded_processor(mode="fixed", frontend="fused") on
    a LocalMesh at sp 2 and 4 at 1024x256 (batch 16), OS and CA per-cell:
    the fixed range kernel's chirp shards and the fixed split entry, no
    plain stage, every output bit-equal to the single card's fused route.
    Returns {kernel: launches} of the first config's run at sp 4.  Phase
    37e runs it on other ``configs`` (variant, params), its lines tagged
    ``tag``."""
    import torch
    from fmcw_tpu_torch import kernels
    from fmcw_tpu_torch.models import pipeline as pl
    from fmcw_tpu_torch.parallel import mesh as M, sharded as SH
    launches = None
    kw = dict(mode="fixed", frontend="fused", peak_group_radius=pgr,
              include_maps=True)
    for variant, p in configs or (("os", long_params(LONG_ND, "os")),
                                  ("ca", long_params(LONG_ND, "ca"))):
        batch = torch.as_tensor(make_batch(p, ARRAY_BATCH, seed=45),
                                device=dev)
        ref = pl.make_batch_processor(p, device=dev, **kw)(batch)
        for sp in SPLIT_SPS:
            proc = SH.make_sharded_processor(M.LocalMesh(1, sp, dev), p, **kw)
            kernels.reset_launch_counts()
            with PlainStages() as plain:
                out = proc(batch)
                torch.cuda.synchronize()
            counts = {k: v for k, v in kernels.launch_counts().items() if v}
            diff = [k for k in ref if not torch.equal(out[k], ref[k])]
            log(f"{tag} LocalMesh {variant} sp={sp}: launches "
                + ", ".join(f"{k}={v}" for k, v in counts.items())
                + f"; {'all outputs bit-equal' if not diff else diff} to the "
                f"single card")
            if (diff or plain.calls or not counts.get("range_frontend_fixed")
                    or not counts.get("slowtime_detect_fixed_split")):
                raise AssertionError(f"{tag} LocalMesh {variant} "
                                     f"sp={sp}: {diff}, {counts}, "
                                     f"{plain.calls}")
            if launches is None and sp == SPLIT_SPS[-1]:
                launches = counts
    return launches


def fixed_long_timings(card: str, dev, pgr: int, errs, launches):
    """Phase 33d: graph-replay times of the fixed slow-time kernel's
    long-CPI entries at 1024x256, batch 128 (the kernels line) and
    1024x2048, batch 16 (the summary): per-cell, block, CA, and the split
    entry on an sp 4 shard; each beside its bound (bound_slowtime_fixed,
    bound_slowtime_fixed_split: the function's least work, an nd-point
    FP64 FFT a row), its plain twin and torch.fft.fft (complex128) of its
    planes.  Returns (rows, summary)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.ops import frontend_fixed as FX
    from fmcw_tpu_torch.ops import split_frontend as SF
    rows, summary = [], {}
    for nd, batch in ((LONG_ND, BATCH), (2048, 16)):
        iq = torch.as_tensor(make_batch(long_params(nd), batch, seed=47),
                             device=dev)
        re, im, _ = FX.range_fft_fixed(iq)
        del iq
        z = torch.complex(re.double(), im.double())
        fft = graph_ms(lambda: torch.fft.fft(z, dim=-1))
        del z
        entries = []
        for name, p in (("cell", long_params(nd)),
                        ("block", P.fast().replace(n_doppler=nd)),
                        ("ca", long_params(nd, "ca"))):
            kw = dict(cfar=p.cfar, peak_group_radius=pgr)
            entries.append((
                f"slowtime_detect_fixed[long,{name}]",
                lambda kw=kw: FX.slowtime_detect_fixed(re, im, False, 0,
                                                       **kw),
                lambda kw=kw: FX.slowtime_detect_fixed_plain(re, im, False,
                                                             0, **kw),
                bound_slowtime_fixed(batch, LONG_NR, nd, p.cfar),
                launches.get(name, 0), errs["detect"],
                "fmcw_tpu/ops/frontend_pallas.py:971"))
        cfar = long_params(nd).cfar
        sp, s = 4, 1
        nrl, h = LONG_NR // sp, cfar.halo_range + pgr
        ext = torch.arange(s * nrl - h, (s + 1) * nrl + h, device=dev) % LONG_NR
        lo, hi, core = ext[:h], ext[h + nrl:], ext[h:h + nrl]
        args = (re[:, core].contiguous(), im[:, core].contiguous(),
                (re[:, lo].contiguous(), im[:, lo].contiguous()),
                (re[:, hi].contiguous(), im[:, hi].contiguous()), False, 0,
                s * nrl)
        skw = dict(cfar=cfar, n_range_total=LONG_NR, peak_group_radius=pgr)
        z = torch.complex(re[:, ext].double(), im[:, ext].double())
        fft_shard = graph_ms(lambda: torch.fft.fft(z, dim=-1))
        del z
        entries.append((
            "slowtime_detect_fixed_split[long]",
            lambda: SF.slowtime_detect_fixed_split(*args, **skw),
            lambda: SF.slowtime_detect_fixed_split_plain(*args, **skw),
            bound_slowtime_fixed_split(batch, nrl, nd, h, cfar),
            launches.get("split", 0), errs["split"],
            "fmcw_tpu/ops/split_frontend.py:709"))
        for name, call, plain, (bound, by), n, err, line in entries:
            ms = graph_ms(call)
            plain_ms = cuda_ms(plain, 2, 1)
            lib = fft_shard if "split" in name else fft
            log(f"{name} {LONG_NR}x{nd} batch {batch}: {ms:.4f} ms (graph), "
                f"plain {plain_ms:.4f} ms, torch.fft.fft complex128 of its "
                f"planes {lib:.4f} ms, bound {bound:.4f} ms ({by}) ({card})")
            summary[f"{name}@{nd}x{batch}"] = {
                "ms": ms, "plain_ms": plain_ms, "fft_ms": lib,
                "bound_ms": bound, "bound_by": by}
            if nd == LONG_ND:
                # No PyTorch call computes an entry: torch.fft.fft is only
                # its transform's share (the summary's fft_ms).
                rows.append(dict(name=name, route="cuda",
                                 source=FIXED_LONG_SRC, replaces=line,
                                 launches=n, max_abs_err=err, ms=ms,
                                 plain_ms=plain_ms, bound_ms=bound,
                                 bound_by=by, library_ms=None))
        del re, im, args
    return rows, summary


def fixed_long_phase(card: str, dev, pgr: int):
    """Phase 33: the fixed slow-time kernel's long CPIs (33a-d above); the
    main path first, whose golden checks run in worker processes during
    the rest.  Returns (kernel rows, summary)."""
    import concurrent.futures as cf
    import multiprocessing as mp
    import os
    import torch
    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    workers = max(1, min(7, (os.cpu_count() or 2) - 1))
    with cf.ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        launches, summary, golden = fixed_long_main_path(card, dev, pgr,
                                                         pool)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        errs, tw_bins = fixed_long_kernel_checks(dev, pgr)
        t2 = time.perf_counter()
        launches["split"] = fixed_long_local_mesh(card, dev, pgr)[
            "slowtime_detect_fixed_split"]
        t3 = time.perf_counter()
        rows, timings = fixed_long_timings(card, dev, pgr, errs, launches)
        t4 = time.perf_counter()
        done = {}
        for name, fut in golden:
            ok, n = fut.result()
            okn = done.setdefault(name, [True, 0])
            okn[0] &= ok
            okn[1] += n
        for name, (ok, n) in done.items():
            log(f"fixed long main path {name}: mag and det maps vs the "
                f"golden process_frame_fixed on "
                f"{BATCH if name == 'cell' else 32} frames: "
                f"{'equal' if ok else 'DIFFER'} ({n} detections)")
            if not ok:
                raise AssertionError(f"fixed long {name} differs from the "
                                     f"golden model")
    t5 = time.perf_counter()
    log(f"fixed long-CPI phase: 33b {t1 - t0:.1f} s, 33a {t2 - t1:.1f} s, "
        f"33c {t3 - t2:.1f} s, 33d {t4 - t3:.1f} s, golden wait "
        f"{t5 - t4:.1f} s")
    return rows, {"main_path": summary, "timings": timings,
                  "launches": launches,
                  "golden_exact_bin_differences": tw_bins}


# ---------------------------------------------------------------------------
# fixed_fft="scaled": the stage-scaled XFFT arithmetic (phase 34)
# ---------------------------------------------------------------------------

SCALED_SIZES = tuple(1 << k for k in range(3, 11))  # n 8 .. 1024
SCALED_GOLDEN = 8               # frames of each scaled route held to golden
FUSED_WRAPPERS = ("range_fft", "slowtime_detect", "slowtime_mag",
                  "range_fft_fixed", "slowtime_detect_fixed")


def scaled_fft_checks(dev) -> int:
    """Phase 34a: ops/fft.scaled_fft_apply on CUDA int64 tensors against
    the golden scaled_fft at n = 8 .. 1024: 64 rows of full-scale int16
    values (the zero and mixed schedules wrap), schedules None (no
    scaling), [1]*m, a mixed one and zeros, both output orders; bit for
    bit, or raises.  Returns the number of values compared."""
    import numpy as np
    import torch
    from fmcw_tpu_torch.golden import fixed_point as gfx
    from fmcw_tpu_torch.ops import fft as FT
    rng = np.random.default_rng(34)
    n_values, wraps = 0, 0
    for n in SCALED_SIZES:
        m = n.bit_length() - 1
        i = rng.integers(-32768, 32768, (64, n))
        q = rng.integers(-32768, 32768, (64, n))
        ti, tq = torch.as_tensor(i, device=dev), torch.as_tensor(q, device=dev)
        for sch in (None, [1] * m, list(rng.integers(0, 3, m)), [0] * m):
            for order in ("natural", "bit_reversed"):
                gi, gq = gfx.scaled_fft(i, q, scale_sch=sch,
                                        output_order=order)
                ci, cq = FT.scaled_fft_apply(ti, tq, -1, scale_sch=sch,
                                             output_order=order)
                if not (np.array_equal(ci.cpu().numpy(), gi)
                        and np.array_equal(cq.cpu().numpy(), gq)):
                    raise AssertionError(f"scaled_fft_apply on the card "
                                         f"differs from the golden model (n "
                                         f"{n}, schedule {sch}, {order})")
                n_values += 2 * gi.size
        full = np.fft.fft(i + 1j * q, axis=-1)
        wraps += int((np.abs(full.real) > 32767).sum())
    log(f"scaled_fft_apply (CUDA, int64) vs the golden scaled_fft at n "
        f"{SCALED_SIZES[0]}..{SCALED_SIZES[-1]}, 4 schedules, both orders: "
        f"bit-identical ({n_values} values; {wraps} unscaled bins beyond "
        f"int16, wrapped under the zero schedule)")
    return n_values


def golden_scaled_check(job):
    """A worker process's job: (int16 frames, the route's maps, RadarParams,
    grouping radius, the schedule pair or None, hw-stream, debug taps);
    True where the golden process_frame_fixed(fft="scaled") gives every
    magnitude map exactly, and (named geometry) every grouped det map and
    the debug taps; with the golden detection count."""
    import numpy as np
    from fmcw_tpu_torch.golden import fixed_point as gfx, reference
    frames, mags, dets, taps, p, radius, sch, hw = job
    ok, n = True, 0
    for k, f in enumerate(frames):
        gmag, gdet = reference.process_frame_fixed(
            f[..., 0] + 1j * f[..., 1].astype(np.float64), p, fft="scaled",
            fft_scale_sch=sch)
        ok &= bool(np.array_equal(gmag, mags[k]))
        n += int((gdet > 0).sum())
        if hw:
            continue
        ok &= bool(np.array_equal(gfx.peak_group(gdet, radius), dets[k]))
        if taps is not None:
            _, thr, scale = gfx.os_cfar_2d(gmag, p.cfar, return_debug=True)
            ok &= bool(np.array_equal(thr, taps[0][k])
                       and np.array_equal(scale, taps[1][k]))
    return ok, n


def scaled_configs():
    """(name, RadarParams, processor keywords, kernels the route needs)."""
    import fmcw_tpu_torch as P
    zeros = ([0] * 10, [0] * 7)
    return (("cell", P.RadarParams(), {}, ("cfar_detect_group",)),
            ("block", P.fast(), {}, ("cfar_detect_group",)),
            ("hw_stream", P.RadarParams(), dict(cfar_geometry="hw_stream"),
             ("cfar_detect_hw_stream",)),
            ("debug", P.RadarParams(), dict(include_debug=True),
             ("cfar_rank_group",)),
            ("zeros", P.RadarParams(), dict(fixed_fft_scale_sch=zeros),
             ("cfar_detect_group",)))


def scaled_routes(card: str, dev, pgr: int, pool):
    """Phase 34b: make_batch_processor(mode="fixed", fixed_fft="scaled") at
    batch 128 of bench.py's stimulus (1024x128): fixed "auto" per-cell,
    fast() block, hw-compat (the batch call and process.stream over two
    CPIs, carries compared), the debug taps and a zeros schedule (no
    scaling: the transforms wrap), grouping radius 2.  Each launches its
    CFAR kernel (the grouping entry, the flat-stream entry, the rank
    select) and no fused kernel; every output, stream carries included,
    bit-equal to frontend="plain" on the card (the same plain stages, then
    the kernels' twins: decisions, groupings, row maxima and counts); the
    maps of SCALED_GOLDEN frames each against the golden process_frame_
    fixed(fft="scaled") in worker processes.  Returns (launches per config,
    golden futures, the routes' magnitude maps)."""
    import torch
    from fmcw_tpu_torch import kernels
    from fmcw_tpu_torch.models import pipeline as pl
    launches, golden, mags = {}, [], {}
    for name, p, kw, need in scaled_configs():
        batch = make_batch(p, BATCH, seed=34)
        iq = torch.as_tensor(batch, device=dev)
        kw = dict(kw, mode="fixed", fixed_fft="scaled", peak_group_radius=pgr)
        proc = pl.make_batch_processor(p, device=dev, **kw)
        plain = pl.make_batch_processor(p, frontend="plain", device=dev, **kw)
        calls = [("batch", lambda f: (f(iq), None))]
        if name == "hw_stream":
            calls += [("stream", lambda f: f.stream(iq)),
                      ("carried", lambda f: f.stream(
                          torch.roll(iq, 1, 0),
                          hist=f.stream(iq)[1]))]
        outs = {}
        for call, run in calls:
            kernels.reset_launch_counts()
            out, hist = run(proc)
            outs[call] = out
            torch.cuda.synchronize()
            counts = {k: v for k, v in kernels.launch_counts().items() if v}
            want, whist = run(plain)
            log(f"scaled {name} {call}: route {proc.route}, launches "
                + ", ".join(f"{k}={v}" for k, v in counts.items()))
            if (proc.route != "staged" or any(not counts.get(k) for k in need)
                    or any(counts.get(k) for k in FUSED_WRAPPERS)):
                raise AssertionError(f"scaled {name} {call}: wrong kernels")
            for k, v in counts.items():
                launches.setdefault(name, {})
                launches[name][k] = launches[name].get(k, 0) + v
            diff = [k for k in want if not bits_equal(out[k], want[k])]
            if hist is not None and not bits_equal(hist, whist):
                diff.append("hist")
            if diff or out.keys() != want.keys():
                raise AssertionError(f"scaled {name} {call} differs from "
                                     f"the plain route in {diff}")
            log(f"scaled {name} {call}: every output bit-equal to the plain "
                f"route on the card ({int(out['n_dets'].sum())} detections, "
                f"saturations {int(out['saturation_count'].sum())})")
        g, out = slice(0, SCALED_GOLDEN), outs["batch"]
        taps = ((out["threshold_map"][g].cpu().numpy(),
                 out["scale_map"][g].cpu().numpy())
                if name == "debug" else None)
        golden.append((name, pool.submit(golden_scaled_check, (
            batch[g], out["mag_map"][g].cpu().numpy(),
            out["det_map"][g].cpu().numpy(), taps, p, pgr,
            kw.get("fixed_fft_scale_sch"), name == "hw_stream"))))
        mags[name] = out["mag_map"]
    return launches, golden, mags


def scaled_timings(card: str, dev, pgr: int, mags, launches):
    """Phase 34c: at batch 128, frames/s of each scaled route (no maps) and
    its plain scaled stages (the range and slow-time halves, beside the BFP
    stages of fixed "auto" in the same run); the CFAR kernels the routes
    launch, on the routes' own scaled magnitude maps, against their twins
    bit for bit and timed (graph replay; the rank select eagerly, its twin
    in 8-frame chunks) beside their bounds; the per-cell grouping entry on
    the zeros schedule's maps (under [1]*m the noise rounds to 0).
    Returns (kernel rows, summary)."""
    import torch
    from fmcw_tpu_torch.models import pipeline as pl
    from fmcw_tpu_torch.ops import cfar as C, cfar_detect as CD
    from fmcw_tpu_torch.ops import cfar_rank as RK
    from fmcw_tpu_torch.ops import frontend_fixed as FX
    fps = {}
    iq = None
    for name, p, kw, _ in scaled_configs():
        iq = torch.as_tensor(make_batch(p, BATCH, seed=34), device=dev)
        proc = pl.make_batch_processor(p, mode="fixed", fixed_fft="scaled",
                                       peak_group_radius=pgr,
                                       include_maps=False, device=dev, **kw)
        fps[name] = BATCH * 1e3 / cuda_ms(lambda: proc(iq), 5, 2)
        log(f"scaled {name} route: {fps[name]:.1f} frames/s at batch "
            f"{BATCH} ({card})")
    p = scaled_configs()[0][1]
    nr, nd = p.n_range, p.n_doppler
    sch = pl.scaled_schedules(p, "scaled", "fixed", "auto")
    re, im, _ = FX.range_fft_fixed_plain(iq, scale_sch=sch[0])
    stages = {
        "scaled_range_ms": cuda_ms(
            lambda: FX.range_fft_fixed_plain(iq, scale_sch=sch[0]), 5, 2),
        "scaled_slowtime_ms": cuda_ms(
            lambda: FX.slowtime_mag_fixed_plain(re, im, scale_sch=sch[1]),
            5, 2),
        "bfp_range_ms": cuda_ms(lambda: FX.range_fft_fixed_plain(iq), 5, 2),
        "bfp_slowtime_ms": cuda_ms(
            lambda: FX.slowtime_mag_fixed_plain(re, im), 5, 2)}
    del re, im
    log(f"scaled plain stages per batch of {BATCH}: " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items()) + f" ({card})")
    src = "fmcw_tpu_torch/csrc/"
    rows, entry_ms = [], {}
    for name, p, kw, need in scaled_configs()[:4]:
        # The per-cell entry on the zeros schedule's maps: under [1]*m the
        # 1/N scaling rounds the noise to 0, and the map is sparse.
        mag = mags["zeros" if name == "cell" else name]
        kernel = need[0]
        in_float = int(mag.abs().max()) <= CD.float_max(
            C.hw_stream_params(p.cfar) if name == "hw_stream" else p.cfar)
        if kernel == "cfar_detect_group":
            smap = (C.block_scale_map(mag, p.cfar)
                    if p.cfar.scale_mode == "block" else None)
            gkw = dict(cfar=p.cfar, scale_map=smap, peak_group_radius=pgr)
            call = lambda: CD.cfar_detect_group(mag, 0, **gkw)
            twin = lambda: CD.cfar_detect_group_plain(mag, 0, **gkw)
            bound, by = bound_cfar_detect(BATCH, nr, nd, p.cfar, in_float,
                                          True)
            line, file, timer = (155 if smap is None else 279,
                                 "cfar_detect.cu", graph_ms)
        elif kernel == "cfar_detect_hw_stream":
            rec = []
            C.cfar_2d_hw_stream(mag, cfar=p.cfar, integer=True,
                                label_roll=False,
                                decide=recorded(CD.cfar_detect_hw_stream,
                                                rec))
            (ext, start0, R, D, _), _, _ = rec[0]
            hkw = dict(cfar=p.cfar, integer=True)
            call = lambda: CD.cfar_detect_hw_stream(ext, start0, R, D, 0,
                                                    **hkw)
            twin = lambda: C.hw_stream_decide_plain(ext, start0, R, D, 0,
                                                    **hkw)
            bound, by = bound_cfar_detect(BATCH, nr, nd,
                                          C.hw_stream_params(p.cfar),
                                          in_float)
            line, file, timer = 155, "cfar_detect.cu", graph_ms
        else:
            rkw = dict(cfar=p.cfar, bits=16, peak_group_radius=RANK_PGR)
            call = lambda: RK.cfar_rank_group(mag, 0, **rkw)
            twin = lambda: [RK.cfar_rank_group_plain(
                mag[i:i + RANK_FRAMES], 0, **rkw)
                for i in range(0, BATCH, RANK_FRAMES)]
            bound, by = bound_cfar_rank(BATCH, nr, nd, p.cfar, 16, True,
                                        False, group=True)
            line, file = 58, "cfar_rank.cu"
            timer = lambda f: cuda_ms(f, 5)
        got, want = call(), twin()
        if kernel == "cfar_rank_group":
            want = [torch.cat(parts) for parts in zip(*want)]
        torch.cuda.synchronize()
        if not all(bits_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{kernel} on the scaled {name} maps "
                                 f"differs from its twin")
        err = max(float((a.double() - b.double()).abs().max())
                  for a, b in zip(got, want))
        ms = timer(call)
        plain_ms = cuda_ms(twin, 1, 1)
        row = {"cell": "cfar_detect_group[cell,scaled]",
               "block": "cfar_detect_group[block,scaled]",
               "hw_stream": "cfar_detect_hw_stream[int32,scaled]",
               "debug": "cfar_rank_group[int32,16 bits,scaled]"}[name]
        n = sum(v.get(kernel, 0) for k, v in launches.items()
                if k == name or (name == "cell" and k == "zeros"))
        entry_ms[row] = ms
        log(f"{row} (the scaled route's maps, counted in "
            f"{'float' if in_float else 'int'}): {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}); bit-identical "
            f"to its twin; {n} launches on the scaled routes ({card})")
        rows.append(dict(name=row, route="cuda", source=src + file,
                         replaces=f"fmcw_tpu/ops/cfar_pallas.py:{line}",
                         launches=n, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                         library_ms=None))
    return rows, {"frames_per_s": fps, "stages_ms": stages,
                  "entry_ms": entry_ms}


def scaled_phase(card: str, dev, pgr: int):
    """Phase 34 (34a-c above); the golden checks run in worker processes
    during the timings.  Returns (kernel rows, summary)."""
    import concurrent.futures as cf
    import multiprocessing as mp
    import os
    t0 = time.perf_counter()
    n_values = scaled_fft_checks(dev)
    t1 = time.perf_counter()
    ctx = mp.get_context("spawn")
    workers = max(1, min(5, (os.cpu_count() or 2) - 1))
    with cf.ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        launches, golden, mags = scaled_routes(card, dev, pgr, pool)
        t2 = time.perf_counter()
        rows, summary = scaled_timings(card, dev, pgr, mags, launches)
        del mags
        t3 = time.perf_counter()
        for name, fut in golden:
            ok, n = fut.result()
            log(f"scaled {name}: maps vs the golden process_frame_fixed("
                f"fft='scaled') on {SCALED_GOLDEN} frames: "
                f"{'equal' if ok else 'DIFFER'} ({n} golden detections)")
            if not ok:
                raise AssertionError(f"scaled {name} differs from the "
                                     f"golden model")
    log(f"scaled phase: 34a {t1 - t0:.1f} s, 34b {t2 - t1:.1f} s, 34c "
        f"{t3 - t2:.1f} s, golden wait {time.perf_counter() - t3:.1f} s")
    return rows, dict(summary, launches=launches, fft_values=n_values)


# ---------------------------------------------------------------------------
# The quick-validation stimulus and the demo (phase 35)
# ---------------------------------------------------------------------------

DEMO_SCANS = 16
DEMO_MODES = (
    ("float", {}, ("range_fft", "slowtime_detect")),
    ("fixed", dict(mode="fixed"), ("cfar_detect_group",)),
    ("hw-compat fixed", dict(mode="fixed", hw_compat=True),
     ("cfar_detect_hw_stream",)),
    ("array 8", dict(array=8), ("range_fft_float", "slowtime_detect",
                                "beam_group")),
    ("sharded 4", dict(sharded=4), ("range_frontend",
                                    "slowtime_detect_split")))


def quick_run_check(card: str, dev) -> int:
    """Phase 35a: the faithful quick run (golden/adr_quick.quick_frames:
    the reference's quick-testbench I/Q, 5 CPIs of 128x32) through
    make_processor(quick(), mode="fixed", cfar_geometry="hw_stream",
    window_rounding="biased", mti_transient="passthrough") on the card,
    frame after frame through process.stream: the flat-stream entry
    launched every CPI, the magnitudes equal to the golden chain's, the
    detections over the run equal to the golden os_cfar_2d_hw_stream over
    the 5-frame stream (less the last frame's tail).  Returns the
    detections."""
    import numpy as np
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch import kernels
    from fmcw_tpu_torch.golden import adr_quick, fixed_point as gfx
    from fmcw_tpu_torch.golden import reference
    from fmcw_tpu_torch.models import pipeline as pl
    kw = dict(window_rounding="biased", mti_transient="passthrough")
    frames, _ = adr_quick.quick_frames()
    p = P.quick()
    mags = np.stack([reference.process_frame_fixed(f, p, **kw)[0]
                     for f in frames])
    proc = pl.make_processor(p, mode="fixed", cfar_geometry="hw_stream",
                             device=dev, **kw)
    kernels.reset_launch_counts()
    got, hist = [], None
    for k, f in enumerate(frames):
        out, hist = proc.stream(pl.complex_to_iq(f), hist=hist)
        if not np.array_equal(out["mag_map"].cpu().numpy(), mags[k]):
            raise AssertionError("quick run: magnitudes differ from the "
                                 "golden chain")
        m = out["det_map"].cpu().numpy()
        r, d = np.nonzero(m)
        got += list(zip(r.tolist(), d.tolist(), m[r, d].tolist()))
    torch.cuda.synchronize()
    n = kernels.launch_counts()["cfar_detect_hw_stream"]
    lag = gfx.hw_stream_lag(p.cfar, p.n_doppler)
    dbg = gfx.os_cfar_2d_hw_stream(mags, p.cfar, return_debug=True)
    keep = dbg["cells"][dbg["det"]] < len(frames) * p.n_range * p.n_doppler \
        - lag
    want = [(int(a), int(b), int(c)) for a, b, c, k in zip(
        *gfx.os_cfar_2d_hw_stream(mags, p.cfar), keep) if k]
    same = sorted(got) == sorted(want)
    log(f"quick run (adr_quick, 5 CPIs, faithful hw-compat stream): "
        f"cfar_detect_hw_stream launches {n}; {len(got)} detections "
        f"{'equal to' if same else 'DIFFER from'} the golden stream model's "
        f"{len(want)} ({card})")
    if n < len(frames) or not same:
        raise AssertionError("quick run differs from the golden model")
    return len(got)


def demo_runs(card: str, dev, tmp):
    """Phase 35b: the demo's run function (fmcw_tpu_torch.tools.visualize.
    run_demo) at --full (1024x128, the full tactical scenario) for
    DEMO_SCANS scans in each DEMO_MODES mode on the card, the launch counts
    set to 0 just before each run and read just after (each mode's kernels
    launched); the fixed and hw-compat logs byte-identical to the same
    scans with device="cpu" (the plain path), the sharded (LocalMesh sp 4)
    logs to the single card's float logs; every run's logs parse, with
    firm tracks.  Returns (launches per mode, scans/s per mode)."""
    from pathlib import Path
    from fmcw_tpu_torch import kernels
    from fmcw_tpu_torch.tools import visualize as V
    from fmcw_tpu_torch.utils import viz
    launches, sps, logs = {}, {}, {}
    quiet = dict(quick=False, scans=DEMO_SCANS, echo=lambda *_: None)
    for name, kw, need in DEMO_MODES:
        out = Path(tmp) / name.replace(" ", "_")
        kernels.reset_launch_counts()
        res = V.run_demo(out=str(out), device=dev, **quiet, **kw)
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        launches[name], sps[name] = counts, res["scans_per_s"]
        logs[name] = [Path(res[k]).read_bytes()
                      for k in ("det_log", "trk_log")]
        tracks, actives = viz.load_tracks(res["trk_log"])
        n_dets = len(viz.load_detections(res["det_log"]))
        log(f"demo {name}: {res['scans']} scans, {sps[name]:.1f} scans/s "
            f"({res['seconds']:.2f} s, the first scan's set-up included), "
            f"{n_dets} detections, active tracks {actives[-1]}, "
            f"{len(res['velocity_lines'])} unfolded velocities; launches "
            + ", ".join(f"{k}={v}" for k, v in counts.items()) + f" ({card})")
        if (any(counts.get(k, 0) < DEMO_SCANS for k in need)
                or res["scans"] != DEMO_SCANS or len(actives) != DEMO_SCANS
                or not tracks or n_dets == 0):
            raise AssertionError(f"demo {name}: kernels, scans or logs off")
        if kw.get("mode") == "fixed":
            res = V.run_demo(out=str(out) + "_cpu", device="cpu", **quiet,
                             **kw)
            same = logs[name] == [Path(res[k]).read_bytes()
                                  for k in ("det_log", "trk_log")]
            log(f"demo {name}: logs {'byte-identical to' if same else 'DIFFER from'}"
                f" the CPU run's ({sum(map(len, logs[name]))} bytes; CPU "
                f"{res['scans_per_s']:.1f} scans/s)")
            if not same:
                raise AssertionError(f"demo {name}: card and CPU logs differ")
    same = logs["sharded 4"] == logs["float"]
    log(f"demo sharded 4: logs {'byte-identical to' if same else 'DIFFER from'}"
        f" the single card's")
    if not same:
        raise AssertionError("demo sharded 4: logs differ from one card")
    return launches, sps


def _within_tol(pairs, what: str) -> float:
    """Transform outputs against their twin's: within TOL of the twin's
    peak, or raises.  Returns the largest |difference|."""
    peak = max(float(b.double().abs().max()) for _, b in pairs)
    err = max(float((a.double() - b.double()).abs().max()) for a, b in pairs)
    if not err <= TOL * peak:
        raise AssertionError(f"{what}: {err:g} off its twin (peak {peak:g})")
    return err


def _identical(pairs, what: str) -> float:
    if not all(bits_equal(a, b) for a, b in pairs):
        raise AssertionError(f"{what} disagrees with its twin")
    return 0.0


def demo_kernel_rows(card: str, dev, launches):
    """Phase 35c: the kernels the demo launches, at the demo's shapes (one
    1024x128 frame of the full scenario a scan; the array mode's 8 beams of
    one cube; the sp 4 shards): each against its twin (transforms within
    TOL of the peak; decisions, groupings, row maxima and counts bit for
    bit, the detect entries' on their own magnitudes; the split entry's
    rows bit-equal to the whole frame's) and timed (graph replay) beside
    its bound and twin.  ``launches`` are the demo runs' (phase 35b).
    Returns the kernel rows."""
    import torch
    from fmcw_tpu_torch.models import pipeline as pl, scenario as sc
    from fmcw_tpu_torch.ops import cfar as C, cfar_detect as CD
    from fmcw_tpu_torch.ops import frontend as F, frontend_fixed as FX
    from fmcw_tpu_torch.ops import split_frontend as SF
    from fmcw_tpu_torch.ops.beam_group import beam_group, beam_group_plain
    from fmcw_tpu_torch.tools.visualize import demo_params
    p = demo_params(quick=False)
    nr, nd, cfar, pgr = p.n_range, p.n_doppler, p.cfar, 2
    cfg = sc.ScenarioConfig(num_scans=1)
    _, frame, _ = next(sc.TacticalScenario(p, cfg).run())
    iq = torch.as_tensor(pl.complex_to_iq(frame)[None], device=dev)
    _, cube, _ = next(sc.TacticalScenario(p, cfg).run_elements(8))
    br, bi = beam_planes(torch.as_tensor(pl.complex_to_iq(cube)[None],
                                         device=dev), 8)
    re, im = F.range_fft(iq)
    fre, fim = F.range_fft_float(br, bi)
    imag, _ = FX.slowtime_mag_fixed_plain(*FX.range_fft_fixed_plain(iq)[:2])
    rec = []
    C.cfar_2d_hw_stream(imag, cfar=cfar, integer=True, streaming=True,
                        label_roll=False,
                        decide=recorded(CD.cfar_detect_hw_stream, rec))
    (ext, start0, R, D, _), hkw, _ = rec[0]
    dkw = dict(cfar=cfar, peak_group_radius=pgr)
    bdet = F.slowtime_detect(fre, fim, False, 0, **dkw)[0].reshape(
        1, 8, nr, nd)
    sp, s = 4, 1
    ndc, nrl, h = nd // sp, nr // sp, cfar.halo_range + pgr
    chirps = iq[:, s * ndc:(s + 1) * ndc].contiguous()
    ext_r = torch.arange(s * nrl - h, (s + 1) * nrl + h, device=dev) % nr
    lo, hi, core = ext_r[:h], ext_r[h + nrl:], ext_r[h:h + nrl]
    sargs = (re[:, core].contiguous(), im[:, core].contiguous(),
             (re[:, lo].contiguous(), im[:, lo].contiguous()),
             (re[:, hi].contiguous(), im[:, hi].contiguous()), False, 0,
             s * nrl)
    skw = dict(cfar=cfar, n_range_total=nr, peak_group_radius=pgr)
    in_float = int(imag.abs().max()) <= CD.float_max(cfar)
    hw_float = int(imag.abs().max()) <= CD.float_max(
        C.hw_stream_params(cfar))

    def detect_check(re, im, what):
        det, mag, rmax, ndet, nf = F.slowtime_detect(re, im, False, 0,
                                                     emit_mag=True, **dkw)
        err = _within_tol([(mag, F.slowtime_mag_plain(re, im, False))], what)
        _identical(zip((det, rmax, ndet, nf),
                       F.detect_plain(mag, cfar, 0, pgr)), what)
        return err

    def split_check():
        d_s, m_s, r_s, _, _ = SF.slowtime_detect_split(*sargs, emit_mag=True,
                                                       **skw)
        det, mag, rmax, _, _ = F.slowtime_detect(re, im, False, 0,
                                                 emit_mag=True, **dkw)
        rows = slice(s * nrl, (s + 1) * nrl)
        _identical([(d_s, det[:, rows]), (m_s, mag[:, rows]),
                    (r_s, rmax[:, rows])], "slowtime_detect_split (demo)")
        return _within_tol(
            [(m_s, F.slowtime_mag_plain(re, im, False)[:, rows])],
            "slowtime_detect_split (demo)")

    # (row, demo mode, wrapper, timed call, twin, check, bound, source,
    #  TPU kernel)
    cases = (
        ("range_fft[demo]", "float", "range_fft", lambda: F.range_fft(iq),
         lambda: F.range_fft_plain(iq),
         lambda: _within_tol(list(zip(F.range_fft(iq),
                                      F.range_fft_plain(iq))), "range_fft"),
         bound_range_fft(1, nd, nr), "range_fft.cu", "frontend_pallas.py:623"),
        ("slowtime_detect[cell,demo]", "float", "slowtime_detect",
         lambda: F.slowtime_detect(re, im, False, 0, **dkw),
         lambda: F.slowtime_detect_plain(re, im, False, 0, **dkw),
         lambda: detect_check(re, im, "slowtime_detect (demo)"),
         bound_slowtime(1, nr, nd, cfar), "slowtime_detect.cu",
         "frontend_pallas.py:623"),
        ("cfar_detect_group[cell,int32,demo]", "fixed", "cfar_detect_group",
         lambda: CD.cfar_detect_group(imag, 0, **dkw),
         lambda: CD.cfar_detect_group_plain(imag, 0, **dkw),
         lambda: _identical(zip(CD.cfar_detect_group(imag, 0, **dkw),
                                CD.cfar_detect_group_plain(imag, 0, **dkw)),
                            "cfar_detect_group (demo)"),
         bound_cfar_detect(1, nr, nd, cfar, in_float, True),
         "cfar_detect.cu", "cfar_pallas.py:155"),
        ("cfar_detect_hw_stream[int32,demo]", "hw-compat fixed",
         "cfar_detect_hw_stream",
         lambda: CD.cfar_detect_hw_stream(ext, start0, R, D, 0, **hkw),
         lambda: C.hw_stream_decide_plain(ext, start0, R, D, 0, **hkw),
         lambda: _identical(zip(
             CD.cfar_detect_hw_stream(ext, start0, R, D, 0, **hkw),
             C.hw_stream_decide_plain(ext, start0, R, D, 0, **hkw)),
             "cfar_detect_hw_stream (demo)"),
         bound_cfar_detect(1, nr, nd, C.hw_stream_params(cfar), hw_float),
         "cfar_detect.cu", "cfar_pallas.py:155"),
        ("range_fft_float[demo array 8]", "array 8", "range_fft_float",
         lambda: F.range_fft_float(br, bi),
         lambda: F.range_fft_float_plain(br, bi),
         lambda: _within_tol(list(zip(F.range_fft_float(br, bi),
                                      F.range_fft_float_plain(br, bi))),
                             "range_fft_float (demo)"),
         bound_range_fft_float(8, nd, nr), "range_fft.cu",
         "frontend_pallas.py:623"),
        ("slowtime_detect[cell,demo array 8]", "array 8", "slowtime_detect",
         lambda: F.slowtime_detect(fre, fim, False, 0, **dkw),
         lambda: F.slowtime_detect_plain(fre, fim, False, 0, **dkw),
         lambda: detect_check(fre, fim, "slowtime_detect (demo array)"),
         bound_slowtime(8, nr, nd, cfar), "slowtime_detect.cu",
         "frontend_pallas.py:623"),
        ("beam_group[demo array 8]", "array 8", "beam_group",
         lambda: beam_group(bdet, 1), lambda: beam_group_plain(bdet, 1),
         lambda: _identical(zip(beam_group(bdet, 1),
                                beam_group_plain(bdet, 1)),
                            "beam_group (demo)"),
         bound_beam_group(1, 8, nr, nd, 1), "beam_group.cu",
         "cfar_pallas.py:824"),
        ("range_frontend[demo sp 4]", "sharded 4", "range_frontend",
         lambda: SF.range_frontend(chirps),
         lambda: F.range_fft_plain(chirps),
         lambda: _within_tol(list(zip(SF.range_frontend(chirps),
                                      F.range_fft_plain(chirps))),
                             "range_frontend (demo)"),
         bound_range_fft(1, ndc, nr), "range_fft.cu",
         "split_frontend.py:73"),
        ("slowtime_detect_split[demo sp 4]", "sharded 4",
         "slowtime_detect_split",
         lambda: SF.slowtime_detect_split(*sargs, **skw),
         lambda: SF.slowtime_detect_split_plain(*sargs, **skw), split_check,
         bound_slowtime_split(1, nrl, nd, h, cfar), "slowtime_detect.cu",
         "split_frontend.py:518"))
    rows = []
    for (row, mode, wrapper, call, twin, check, (bound, by), src,
         tpu) in cases:
        err = check()
        torch.cuda.synchronize()
        ms = graph_ms(call)
        plain_ms = cuda_ms(twin, 2, 1)
        n = launches[mode].get(wrapper, 0)
        rows.append(dict(name=row, route="cuda",
                         source="fmcw_tpu_torch/csrc/" + src,
                         replaces="fmcw_tpu/ops/" + tpu, launches=n,
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=by, library_ms=None))
        log(f"{row}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound:.4f} ms ({by}); against its twin: max abs err "
            f"{err:.3g}; {n} launches in the demo's {mode} run ({card})")
    return rows


def demo_phase(card: str, dev):
    """Phase 35 (35a-c above).  Returns (kernel rows, summary)."""
    import tempfile
    t0 = time.perf_counter()
    n_quick = quick_run_check(card, dev)
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        launches, sps = demo_runs(card, dev, tmp)
    t2 = time.perf_counter()
    rows = demo_kernel_rows(card, dev, launches)
    t3 = time.perf_counter()
    log(f"demo phase: 35a {t1 - t0:.1f} s, 35b {t2 - t1:.1f} s, 35c "
        f"{t3 - t2:.1f} s")
    return rows, {"quick_run_detections": n_quick, "scans_per_s": sps,
                  "scans": DEMO_SCANS, "launches": launches}


# ---------------------------------------------------------------------------
# Range lengths n2 x 128: kernel A at 384 .. 2048 and kernel B at those rows
# (phase 36)
# ---------------------------------------------------------------------------

LENGTHS = tuple(n2 * 128 for n2 in range(1, 17))   # JAX's n2 x 128, n2 <= 16
LENGTH_NRS = (2048, 1536, 384)
LENGTH_BATCH = 16               # frames of each kernel-B case
LENGTH_SRC_A = "fmcw_tpu_torch/csrc/range_fft.cu"
LENGTH_SRC_B = "fmcw_tpu_torch/csrc/slowtime_detect.cu"
# Kernel B's cases at each length (36b): (variant, scale mode, scale block,
# bypass, scale override, grouping radius).
LENGTH_CASES = (("os", "cell", 8, False, 0, 2),
                ("os", "cell", 8, True, 4, 0),
                ("os", "block", 8, False, 0, 2),
                ("os", "block", 16, False, 0, 2),
                ("os", "block", 16, True, 6, 0),
                ("ca", "cell", 8, False, 0, 2),
                ("go", "block", 16, False, 0, 2),
                ("so", "cell", 8, False, 6, 2))


def length_params(nr: int, nd: int = 128, variant: str = "os",
                  scale_mode: str = "cell", sb: int = 8):
    import fmcw_tpu_torch as P
    return P.RadarParams(n_range=nr, n_doppler=nd, cfar=P.CfarParams(
        variant=variant, scale_mode=scale_mode, scale_block=sb))


def length_kernel_a_checks(dev):
    """Phase 36a: kernel A at every n2 x 128 (n2 1..16: the powers of two
    128 .. 1024 as before, and the dense stage's 384 .. 2048), nd 8, 40
    and 128, batch 2, both entries (int16 I/Q and float planes) within TOL
    of their twins' peak, on seeded full-scale noise; at nd 128 the chirp
    shards of sp 2 and 4 (``split_frontend.range_frontend``, row 3) bit-
    equal to the whole frame's columns.  Returns {entry: largest absolute
    error}."""
    import numpy as np
    import torch
    from fmcw_tpu_torch.ops import frontend as F
    from fmcw_tpu_torch.ops import split_frontend as SF
    rng = np.random.default_rng(23)
    errs = {"range_fft": 0.0, "range_fft_float": 0.0}
    for n in LENGTHS:
        rel = 0.0
        for nd in RANGE_CHIRPS:
            iq = torch.as_tensor(rng.integers(-32768, 32768, (2, nd, n, 2),
                                              dtype=np.int16), device=dev)
            planes = torch.as_tensor(rng.standard_normal((2, 2, nd, n)) * 1e3,
                                     dtype=torch.float32, device=dev)
            whole = F.range_fft(iq)
            for name, got, want in (
                    ("range_fft", whole, F.range_fft_plain(iq)),
                    ("range_fft_float", F.range_fft_float(*planes),
                     F.range_fft_float_plain(*planes))):
                torch.cuda.synchronize()
                peak = float(torch.maximum(want[0].abs().max(),
                                           want[1].abs().max()))
                err = float(torch.maximum((got[0] - want[0]).abs().max(),
                                          (got[1] - want[1]).abs().max()))
                errs[name] = max(errs[name], err)
                rel = max(rel, err / peak)
                if not err <= TOL * peak:
                    raise AssertionError(f"{name} at n={n} nd={nd}: err "
                                         f"{err / peak:.3g} of peak")
            if nd == RANGE_CHIRPS[-1]:
                for sp in SPLIT_SPS:
                    ndl = nd // sp
                    for s in range(sp):
                        cols = slice(s * ndl, (s + 1) * ndl)
                        part = SF.range_frontend(iq[:, cols])
                        if not all(bits_equal(x, w[..., cols])
                                   for x, w in zip(part, whole)):
                            raise AssertionError(
                                f"range_frontend n={n} sp={sp} shard {s} "
                                f"differs from the whole frame")
        log(f"kernel A n={n} nd {RANGE_CHIRPS} batch 2, int16 and float: "
            f"worst err {rel:.3g} of peak (tol {TOL}); chirp shards sp "
            f"{SPLIT_SPS} bit-equal to the whole frame")
    return errs


def length_kernel_b_checks(dev, pgr: int):
    """Phase 36b: kernel B at n_range 2048, 1536 and 384 (x 128, batch 16
    of bench.py's stimulus through kernel A): each case of LENGTH_CASES
    (_b_case: magnitudes within TOL of the twin's peak, the decision, row
    maxima and counts bit for bit against detect_plain on the kernel's own
    magnitudes; per-cell, block at scale_block 8 and 16, CA/GO/SO, bypass,
    override, radius 0 and 2), with the tile each launched; the
    magnitude-only entry within TOL and bit-equal to the detect entry's
    magnitudes; the split entry at sp 2 and 4 (OS and CA) bit-equal to the
    whole frame (``long_split_case``); and one long CPI, 2048x256 (per-cell
    and block 16).  Returns {entry: largest absolute magnitude error}."""
    import torch
    from fmcw_tpu_torch.ops import frontend as F
    errs = {"detect": 0.0, "mag": 0.0, "split": 0.0}
    for nr in LENGTH_NRS:
        iq = torch.as_tensor(make_batch(length_params(nr), LENGTH_BATCH,
                                        seed=36), device=dev)
        re, im = F.range_fft(iq)
        del iq
        tiles = []
        for variant, mode, sb, bypass, so, radius in LENGTH_CASES:
            p = length_params(nr, 128, variant, mode, sb)
            tiles.append(F._slowtime_config(1, nr, 128, p.cfar, so,
                                            radius).T)
            errs["detect"] = max(errs["detect"], _b_case(
                f"n={nr}", re, im, p, bypass, so, radius))
        log(f"kernel B n={nr}: tiles {tiles} rows for the cases "
            f"{[c[:3] for c in LENGTH_CASES]}")
        p = length_params(nr)
        _, emitted, _, _, nf = F.slowtime_detect(
            re, im, cfar=p.cfar, peak_group_radius=pgr, emit_mag=True)
        mag, nf2 = F.slowtime_mag(re, im)
        pmag = F.slowtime_mag_plain(re, im, False)
        torch.cuda.synchronize()
        err = float((mag - pmag).abs().max())
        peak = float(pmag.abs().max())
        errs["mag"] = max(errs["mag"], err)
        same = bits_equal(mag, emitted) and torch.equal(nf, nf2)
        log(f"slowtime_mag {nr}x128 batch {LENGTH_BATCH}: err "
            f"{err / peak:.3g} of peak, "
            f"{'bit-equal' if same else 'DIFFERS'} to the detect entry's "
            f"magnitudes")
        if not (err <= TOL * peak and same):
            raise AssertionError(f"slowtime_mag disagrees at n={nr}")
        del mag, pmag, emitted
        errs["split"] = max(errs["split"],
                            long_split_case(dev, re, im, 128, pgr))
        del re, im
    iq = torch.as_tensor(make_batch(length_params(2048, 256), 8, seed=37),
                         device=dev)
    re, im = F.range_fft(iq)
    for mode, sb in (("cell", 8), ("block", 16)):
        errs["detect"] = max(errs["detect"], _b_case(
            "long", re, im, length_params(2048, 256, "os", mode, sb), False,
            0, pgr))
    return errs


def length_main_path(card: str, dev, pgr: int):
    """Phase 36c, the main path: batch 128 of bench.py's stimulus at
    2048x128, 1536x128 and 384x128 through make_batch_processor
    (include_maps=False), the entry config (per-cell) and fast() (block,
    scale_block 8): float "auto" is the fused route (before: staged); the
    kernels it launches; frame 0 through the margin gate against the plain
    route's exact taps; frames/s beside the staged route, timed in the
    same run.  Returns ({(kernel, n): launches}, summary)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch import kernels, parity
    from fmcw_tpu_torch.golden import reference
    from fmcw_tpu_torch.models import pipeline as pl
    launches, summary = {}, {}
    for nr in LENGTH_NRS:
        for name, p in (("cell", P.RadarParams(n_range=nr)),
                        ("block", P.fast().replace(n_range=nr))):
            proc = pl.make_batch_processor(p, peak_group_radius=pgr,
                                           include_maps=False, device=dev)
            if proc.route != "fused":
                raise AssertionError(f"{nr}x128 auto is {proc.route}")
            batch = torch.as_tensor(make_batch(p, BATCH), device=dev)
            kernels.reset_launch_counts()
            out = proc(batch)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            log(f"main path {name} {nr}x128: launches "
                + ", ".join(f"{k}={v}" for k, v in counts.items() if v))
            if counts["range_fft"] < 1 or counts["slowtime_detect"] < 1:
                raise AssertionError(f"main path {name} {nr} skipped a "
                                     f"kernel")
            launches[("range_fft", nr)] = launches.get(
                ("range_fft", nr), 0) + counts["range_fft"]
            launches[(name, nr)] = counts["slowtime_detect"]
            for key in ("range_bin", "doppler_bin", "mag", "valid"):
                if tuple(out[key].shape) != (BATCH, p.tracker.max_dets):
                    raise AssertionError(f"{key} shape "
                                         f"{tuple(out[key].shape)}")
            if not bool(torch.isfinite(out["mag"]).all()) or int(
                    out["nonfinite_count"].sum()) != 0:
                raise AssertionError("non-finite magnitudes")
            ref = pl.make_processor(p, peak_group_radius=pgr,
                                    frontend="plain", include_debug=True,
                                    cfar_rank_bits=None, device=dev)(
                                        batch[0])
            ok, report = parity.margin_gate(
                parity.detection_set(out, 0), parity.detection_set(ref),
                ref["mag_map"].cpu().numpy(),
                ref["threshold_map"].cpu().numpy(),
                ref["scale_map"].cpu().numpy(), radius=pgr,
                capacity=p.tracker.max_dets,
                targets=reference.golden_targets(p))
            log(f"main path {name} {nr}x128 frame 0 vs plain path: {report}")
            if not ok:
                raise AssertionError(f"main path {name} {nr}: margin gate "
                                     f"failed")
            del ref, out
            staged = pl.make_batch_processor(p, frontend="staged",
                                             peak_group_radius=pgr,
                                             include_maps=False, device=dev)
            fps = BATCH * 1e3 / cuda_ms(lambda: proc(batch), 10)
            fps_staged = BATCH * 1e3 / cuda_ms(lambda: staged(batch), 3)
            summary[f"{name}@{nr}"] = {"frames_per_s": fps,
                                       "staged_frames_per_s": fps_staged}
            log(f"main path {name} {nr}x128: {fps:.1f} frames/s (fused), "
                f"staged route {fps_staged:.1f} frames/s at batch {BATCH} "
                f"({card})")
            del batch
    return launches, summary


def length_timings(card: str, dev, pgr: int, errs, launches):
    """Phase 36d: graph-replay times at 2048x128, 1536x128 and 384x128,
    batch 128: kernel A (int16; the float entry at 2048, the array model's
    shape), its chirp-shard entry at sp 4 (row 3), kernel B per-cell and
    block (fast()) and its split entry on the sp 4 range shard (row 5),
    each beside its bound (bound_range_fft, bound_range_fft_float,
    bound_slowtime, bound_slowtime_split: an n-point FFT a chirp, whatever
    the kernel runs), its plain twin and torch.fft.fft of the same planes.
    Returns (kernel rows, summary)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.ops import frontend as F
    from fmcw_tpu_torch.ops import split_frontend as SF
    from fmcw_tpu_torch.ops.window import hamming_float
    rows, summary = [], {}
    line_a = "fmcw_tpu/ops/frontend_pallas.py:623"
    line_3 = "fmcw_tpu/ops/split_frontend.py:73"
    line_5 = "fmcw_tpu/ops/split_frontend.py:518"
    for nr in LENGTH_NRS:
        nd, sp = 128, 4
        iq = torch.as_tensor(make_batch(P.RadarParams(n_range=nr), BATCH,
                                        seed=38), device=dev)
        win = torch.as_tensor(hamming_float(nr), device=dev)
        zw = torch.complex(iq[..., 0].float() * win, iq[..., 1].float() * win)
        fft_a = graph_ms(lambda: torch.fft.fft(zw, dim=-1))
        ndl = nd // sp
        shard = iq[:, ndl:2 * ndl].contiguous()
        zs = zw[:, ndl:2 * ndl].contiguous()
        fft_3 = graph_ms(lambda: torch.fft.fft(zs, dim=-1))
        del zw, zs
        entries = [
            (f"range_fft[n={nr}]", LENGTH_SRC_A, line_a,
             lambda: F.range_fft(iq), lambda: F.range_fft_plain(iq),
             bound_range_fft(BATCH, nd, nr),
             launches.get(("range_fft", nr), 0), errs["range_fft"], fft_a),
            (f"range_frontend[n={nr},sp4]", LENGTH_SRC_A, line_3,
             lambda: SF.range_frontend(shard),
             lambda: F.range_fft_plain(shard),
             bound_range_fft(BATCH, ndl, nr),
             launches.get(("range_frontend", nr), 0), errs["range_fft"],
             fft_3)]
        if nr == LENGTH_NRS[0]:
            br = iq[..., 0].float().contiguous()
            bi = iq[..., 1].float().contiguous()
            entries.append((
                f"range_fft_float[n={nr}]", LENGTH_SRC_A, line_a,
                lambda: F.range_fft_float(br, bi),
                lambda: F.range_fft_float_plain(br, bi),
                bound_range_fft_float(BATCH, nd, nr),
                launches.get(("range_fft_float", nr), 0),
                errs["range_fft_float"], fft_a))
        re, im = F.range_fft(iq)
        z = torch.complex(re, im)
        fft_b = graph_ms(lambda: torch.fft.fft(z, dim=-1))
        del z
        for name, p in (("cell", P.RadarParams(n_range=nr)),
                        ("block", P.fast().replace(n_range=nr))):
            kw = dict(cfar=p.cfar, peak_group_radius=pgr)
            entries.append((
                f"slowtime_detect[{name},n={nr}]", LENGTH_SRC_B, line_a,
                lambda kw=kw: F.slowtime_detect(re, im, False, 0, **kw),
                lambda kw=kw: F.slowtime_detect_plain(re, im, False, 0,
                                                      **kw),
                bound_slowtime(BATCH, nr, nd, p.cfar),
                launches.get((name, nr), 0), errs["detect"], fft_b))
        cfar = P.RadarParams().cfar
        nrl, h = nr // sp, cfar.halo_range + pgr
        ext = torch.arange(nrl - h, 2 * nrl + h, device=dev) % nr
        lo, hi, core = ext[:h], ext[h + nrl:], ext[h:h + nrl]
        args = (re[:, core].contiguous(), im[:, core].contiguous(),
                (re[:, lo].contiguous(), im[:, lo].contiguous()),
                (re[:, hi].contiguous(), im[:, hi].contiguous()), False, 0,
                nrl)
        skw = dict(cfar=cfar, n_range_total=nr, peak_group_radius=pgr)
        z = torch.complex(re[:, ext], im[:, ext])
        fft_5 = graph_ms(lambda: torch.fft.fft(z, dim=-1))
        del z
        entries.append((
            f"slowtime_detect_split[n={nr},sp4]", LENGTH_SRC_B, line_5,
            lambda: SF.slowtime_detect_split(*args, **skw),
            lambda: SF.slowtime_detect_split_plain(*args, **skw),
            bound_slowtime_split(BATCH, nrl, nd, h, cfar),
            launches.get(("slowtime_detect_split", nr), 0), errs["split"],
            fft_5))
        for name, src, line, call, plain, (bound, by), n, err, lib in entries:
            ms = graph_ms(call)
            plain_ms = cuda_ms(plain, 2, 1)
            log(f"{name} batch {BATCH}: {ms:.4f} ms (graph), plain "
                f"{plain_ms:.4f} ms, torch.fft.fft of its planes {lib:.4f} "
                f"ms, bound {bound:.4f} ms ({by}), {n} launches on the "
                f"path ({card})")
            summary[name] = {"ms": ms, "plain_ms": plain_ms, "fft_ms": lib,
                             "bound_ms": bound, "bound_by": by}
            # torch.fft.fft computes kernel A's transform (the window
            # applied); of kernel B's entries it is the transform's share.
            rows.append(dict(name=name, route="cuda", source=src,
                             replaces=line, launches=n, max_abs_err=err,
                             ms=ms, plain_ms=plain_ms, bound_ms=bound,
                             bound_by=by,
                             library_ms=lib if "range" in name else None))
        del iq, re, im, args, shard
        torch.cuda.empty_cache()
    return rows, summary


def length_phase(card: str, dev, pgr: int):
    """Phase 36: kernel A at every n2 x 128 and kernel B at those rows
    (36a-d above; 36c also runs phase 32's other routes (the debug taps,
    reflect, hw-compat float, the array model) and LocalMesh at 2048x128,
    and the LocalMesh per-cell route at 1536 and 384).  Returns (kernel
    rows, summary)."""
    import torch
    t0 = time.perf_counter()
    errs = length_kernel_a_checks(dev)
    t1 = time.perf_counter()
    errs.update(length_kernel_b_checks(dev, pgr))
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    launches, summary = length_main_path(card, dev, pgr)
    p = length_params(2048)
    other = long_other_routes(card, dev, pgr, p, tag="2048x128")
    mesh = long_local_mesh(card, dev, pgr, (
        ("cell", p, {}, "slowtime_detect_split"),
        ("block", length_params(2048, scale_mode="block", sb=16), {},
         "slowtime_mag"),
        ("debug", p, dict(include_debug=True), "slowtime_mag")),
        tag="2048x128")
    launches.update({(k, 2048): v for k, v in mesh.items()})
    for nr in LENGTH_NRS[1:]:
        mesh = long_local_mesh(card, dev, pgr, (
            ("cell", length_params(nr), {}, "slowtime_detect_split"),),
            tag=f"{nr}x128")
        launches.update({(k, nr): v for k, v in mesh.items()})
    launches[("range_fft_float", 2048)] = other.get("range_fft_float", 0)
    t3 = time.perf_counter()
    rows, timings = length_timings(card, dev, pgr, errs, launches)
    log(f"range-length phase: 36a {t1 - t0:.1f} s, 36b {t2 - t1:.1f} s, "
        f"36c {t3 - t2:.1f} s, 36d {time.perf_counter() - t3:.1f} s")
    return rows, {"main_path": summary, "timings": timings,
                  "launches": {f"{k[0]}@{k[1]}": v
                               for k, v in launches.items()}}


# ---------------------------------------------------------------------------
# The fixed kernels at the range lengths n2 x 128 (phase 37)
# ---------------------------------------------------------------------------

FIXED_LENGTH_SRC = "fmcw_tpu_torch/csrc/range_fft_fixed.cu"
FIXED_LENGTH_NEW = tuple(n for n in LENGTHS if n & (n - 1)) + (2048,)


def exact_bin(k: int, n: int) -> bool:
    """A quarter-, eighth-, sixth- or twelfth-turn bin of an n-point
    transform: 24 k / n whole (ROADMAP fault 5: the golden model's
    mixed-radix np.fft.fft need not give these exactly, and may round their
    exact ties the other way)."""
    return k * 24 % n == 0


def fixed_length_range_checks(dev) -> int:
    """Phase 37a: the fixed range kernel at every n2 x 128 (n2 1..16: the
    powers of two 128 .. 1024 as before, and the dense stage's 384 ..
    2048), nd 8, 40 and 128, batch 2, on seeded full-scale noise and the
    saturating x40 stimulus, both window roundings: values and saturation
    counts equal to the twin (0 values differ); at nd 128 the chirp shards
    of sp 2 and 4 (``split_frontend.range_frontend_fixed``, row 4)
    bit-equal to the whole frame's columns, their saturation counts
    summing to the frame's.  Returns the number of values checked."""
    import numpy as np
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.ops import frontend_fixed as FX
    from fmcw_tpu_torch.ops import split_frontend as SF
    rng = np.random.default_rng(37)
    checked = 0
    for n in LENGTHS:
        for nd in RANGE_CHIRPS:
            hot = hot_batch(P.RadarParams(n_range=n, n_doppler=nd), 2)
            for stim in (rng.integers(-32768, 32768, (2, nd, n, 2),
                                      dtype=np.int16), hot):
                iq = torch.as_tensor(stim, device=dev)
                for rounding in ("unbiased", "biased"):
                    got = FX.range_fft_fixed(iq, rounding=rounding)
                    want = FX.range_fft_fixed_plain(iq, rounding=rounding)
                    torch.cuda.synchronize()
                    n_off = int((got[0] != want[0]).sum()
                                + (got[1] != want[1]).sum())
                    checked += 2 * got[0].numel()
                    if n_off or not torch.equal(got[2], want[2]):
                        raise AssertionError(
                            f"range_fft_fixed at n={n} nd={nd} {rounding}: "
                            f"{n_off} values differ, saturation "
                            f"{got[2].tolist()} vs {want[2].tolist()}")
                    if nd != RANGE_CHIRPS[-1] or rounding != "unbiased":
                        continue
                    for sp in SPLIT_SPS:
                        ndl, sat = nd // sp, 0
                        for k in range(sp):
                            cols = slice(k * ndl, (k + 1) * ndl)
                            part = SF.range_frontend_fixed(iq[:, cols])
                            sat = sat + part[2]
                            if not all(bits_equal(x, w[..., cols]) for x, w
                                       in zip(part[:2], got[:2])):
                                raise AssertionError(
                                    f"range_frontend_fixed n={n} sp={sp} "
                                    f"shard {k} differs from the frame")
                        if not torch.equal(sat, got[2]):
                            raise AssertionError(
                                f"range_frontend_fixed n={n} sp={sp}: "
                                f"saturations do not sum to the frame's")
        log(f"range_fft_fixed n={n} nd {RANGE_CHIRPS} batch 2, noise and "
            f"x40, both roundings: 0 values differ from the twin, "
            f"saturation exact; chirp shards sp {SPLIT_SPS} bit-equal")
    return checked


def fixed_length_tie_checks(dev):
    """Phase 37b: tie frames (golden.reference.range_tie_frames, 2 frames x
    16 chirps, each chirp an exact half-LSB tie at bin 0, at bin n/8 with
    its sqrt(2)/2 terms cancelling, and where 12 divides n at bin n/12 or
    n/6 with its sqrt(3)/2 part 0) at every n2 x 128 beyond the powers of
    two and at 2048: the fixed range kernel bit-equal to its twin; against
    the golden numpy model (golden_range) the values that differ all lie
    at exact bins (``exact_bin``) and at 2048 none.  Returns {n: values
    that differ from the golden model}."""
    import numpy as np
    import torch
    from fmcw_tpu_torch.golden import reference
    from fmcw_tpu_torch.ops import frontend_fixed as FX
    counts = {}
    for n in FIXED_LENGTH_NEW:
        kinds = ("quarter", "eighth") + (("twelfth",) if n % 12 == 0
                                         else ())
        where = {}
        for kind in kinds:
            frames = reference.range_tie_frames(n + len(kind), 2, 16, n, kind)
            iq = torch.as_tensor(frames, device=dev)
            got = FX.range_fft_fixed(iq)
            want = FX.range_fft_fixed_plain(iq)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"range_fft_fixed on {kind}-turn ties "
                                     f"at n={n} differs from its twin")
            g_re, g_im = golden_range(frames)
            re, im = got[0].cpu().numpy(), got[1].cpu().numpy()
            off = np.argwhere((re != g_re) | (im != g_im))[:, 1]
            where[kind] = sorted({int(k) for k in off})
            counts[n] = counts.get(n, 0) + off.size
            if (not all(exact_bin(int(k), n) for k in off)
                    or off.size and not n & (n - 1)):
                raise AssertionError(f"range_fft_fixed on {kind}-turn ties "
                                     f"at n={n}: golden differences off the "
                                     f"exact bins: {where[kind]}")
        log(f"range_fft_fixed tie frames n={n} ({', '.join(kinds)}): twin "
            f"bit-equal; {counts[n]} values differ from the golden model, "
            f"at exact bins {where}")
    return counts


def golden_frames_located(job):
    """A worker process's job: golden_frames_check's, with the golden
    model's fault-5 differences allowed where they are located: magnitude
    rows (the range axis; with a sixth item "doppler" in the job, columns)
    that differ all at exact bins (``exact_bin``), detections that differ
    all within ``reach`` rows (columns) of such a row.  Returns (ok, the
    detections, the magnitude rows that differ)."""
    import numpy as np
    from fmcw_tpu_torch.golden import fixed_point as gfx, reference
    frames, mags, dets, p, radius, *axis = job
    doppler = axis == ["doppler"]
    n_bins = p.n_doppler if doppler else p.n_range
    reach = (p.cfar.halo_doppler if doppler else p.cfar.halo_range) + radius
    ok, n, off = True, 0, 0
    for f, m, d in zip(frames, mags, dets):
        gmag, gdet = reference.process_frame_fixed(
            f[..., 0] + 1j * f[..., 1].astype(np.float64), p)
        if radius:
            gdet = gfx.peak_group(gdet, radius)
        if doppler:
            gmag, m, gdet, d = gmag.T, m.T, gdet.T, d.T
        rows = np.unique(np.argwhere(gmag != m)[:, 0])
        near = np.zeros(n_bins, bool)
        for k in rows:
            near[np.arange(k - reach, k + reach + 1) % n_bins] = True
        ok &= bool(all(exact_bin(int(k), n_bins) for k in rows)
                   and not ((gdet != d).any(-1) & ~near).any())
        n += int((gdet > 0).sum())
        off += rows.size
    return ok, n, off


def fixed_length_main_path(card: str, dev, pgr: int, pool):
    """Phase 37c, the slice's main path: batch 128 of bench.py's stimulus
    at 2048x128, 1536x128 and 384x128 through make_batch_processor(mode=
    "fixed", frontend="fused"), the entry config (per-cell), fast() (block,
    scale_block 8) and at 2048 JAX's own block 16 (T = 32): only
    range_fft_fixed and slowtime_detect_fixed launch, no plain stage
    (PlainStages); every output bit-equal to frontend="plain" on the card;
    the mag and det maps of every per-cell frame and the first 32 of the
    others held to the golden model by worker processes
    (golden_frames_located, collected by the caller); frames/s beside fixed
    "auto" (the staged route), both without the maps.  Then float "auto"
    at 2048x128 with scale_block 16 (kernel B at T = 32), its launches and
    frame 0 through the margin gate.  Returns ({(kernel or config, n):
    launches}, summary, golden futures)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch import kernels, parity
    from fmcw_tpu_torch.golden import reference
    from fmcw_tpu_torch.models import pipeline as pl
    launches, summary, golden = {}, {}, []
    for nr in LENGTH_NRS:
        configs = [("cell", P.RadarParams(n_range=nr)),
                   ("block", P.fast().replace(n_range=nr))]
        if nr == 2048:
            configs.append(("block16", length_params(nr, scale_mode="block",
                                                     sb=16)))
        for name, p in configs:
            frames = make_batch(p, BATCH, seed=47)
            batch = torch.as_tensor(frames, device=dev)
            proc = pl.make_batch_processor(p, mode="fixed", frontend="fused",
                                           peak_group_radius=pgr, device=dev)
            kernels.reset_launch_counts()
            with PlainStages() as plain:
                out = proc(batch)
                torch.cuda.synchronize()
            counts = {k: v for k, v in kernels.launch_counts().items() if v}
            log(f"fixed main path {name} {nr}x128: launches "
                + ", ".join(f"{k}={v}" for k, v in counts.items())
                + f"; plain stages {plain.calls or 'none'}")
            if (proc.route != "fused" or plain.calls or set(counts) != {
                    "range_fft_fixed", "slowtime_detect_fixed"}):
                raise AssertionError(f"fixed main path {name} {nr}: the "
                                     f"fused route ran {counts}, "
                                     f"{plain.calls}")
            launches[("range_fft_fixed", nr)] = (
                launches.get(("range_fft_fixed", nr), 0)
                + counts["range_fft_fixed"])
            launches[(name, nr)] = counts["slowtime_detect_fixed"]
            ref = pl.make_batch_processor(p, mode="fixed", frontend="plain",
                                          peak_group_radius=pgr,
                                          device=dev)(batch)
            diff = [k for k in ref if not torch.equal(ref[k], out[k])]
            if diff or out.keys() != ref.keys() or int(
                    out["n_dets"].min()) <= 0:
                raise AssertionError(f"fixed main path {name} {nr}: fused "
                                     f"and plain differ in {diff}")
            del ref
            n_gold = BATCH if name == "cell" else 32
            mags = out["mag_map"][:n_gold].cpu().numpy()
            dets = out["det_map"][:n_gold].cpu().numpy()
            for i in range(0, n_gold, 16):
                golden.append(((name, nr), pool.submit(
                    golden_frames_located, (frames[i:i + 16],
                                            mags[i:i + 16], dets[i:i + 16],
                                            p, pgr))))
            del out, mags, dets
            lean = {fe: pl.make_batch_processor(
                p, mode="fixed", frontend=fe, peak_group_radius=pgr,
                include_maps=False, device=dev) for fe in ("fused", "auto")}
            fps = BATCH * 1e3 / cuda_ms(lambda: lean["fused"](batch), 10)
            fps_staged = BATCH * 1e3 / cuda_ms(lambda: lean["auto"](batch), 2,
                                               1)
            summary[f"{name}@{nr}"] = {"frames_per_s": fps,
                                       "staged_frames_per_s": fps_staged}
            log(f"fixed main path {name} {nr}x128: fused bit-equal to plain "
                f"in every output; {fps:.1f} frames/s, staged "
                f"{fps_staged:.1f} frames/s ({fps / fps_staged:.2f}x) at "
                f"batch {BATCH} ({card})")
            del batch, lean
            torch.cuda.empty_cache()
    p = length_params(2048, scale_mode="block", sb=16)
    batch = torch.as_tensor(make_batch(p, BATCH, seed=48), device=dev)
    proc = pl.make_batch_processor(p, peak_group_radius=pgr,
                                   include_maps=False, device=dev)
    kernels.reset_launch_counts()
    out = proc(batch)
    torch.cuda.synchronize()
    launches[("float_block16", 2048)] = kernels.launch_counts()[
        "slowtime_detect"]
    ref = pl.make_processor(p, peak_group_radius=pgr, frontend="plain",
                            include_debug=True, cfar_rank_bits=None,
                            device=dev)(batch[0])
    ok, report = parity.margin_gate(
        parity.detection_set(out, 0), parity.detection_set(ref),
        ref["mag_map"].cpu().numpy(), ref["threshold_map"].cpu().numpy(),
        ref["scale_map"].cpu().numpy(), radius=pgr,
        capacity=p.tracker.max_dets, targets=reference.golden_targets(p))
    log(f"float main path block 16 2048x128 ({proc.route}, slowtime_detect "
        f"launched {launches[('float_block16', 2048)]}x) frame 0 vs plain "
        f"path: {report}")
    if proc.route != "fused" or not ok:
        raise AssertionError("float block 16 at 2048: margin gate failed")
    return launches, summary, golden


def fixed_length_slowtime_checks(dev, pgr: int):
    """Phase 37d: the fixed slow-time kernel at 2048, 1536 and 384 rows (x
    128, batch 16 of bench.py's stimulus through the fixed range kernel):
    each case of LENGTH_CASES (_fx_case: magnitudes and saturations equal
    to the twin, the decision bit for bit on the kernel's magnitudes;
    per-cell, block 8 and 16 (2048 rows at block 16: T = 32), CA / GO / SO,
    bypass, overrides, radius 0 and 2) with the tile each launched; the
    split entry at sp 2 and 4 (fixed_long_split_case: OS and CA, MTI on and
    bypassed; 384 / 4 = 96-row shards at T = 32) bit-equal to the whole
    frame and the twin; a 2048x256 long CPI per-cell and block 16.
    Returns {entry: largest magnitude difference}."""
    import torch
    from fmcw_tpu_torch.ops import frontend as F, frontend_fixed as FX
    errs = {"detect": 0.0, "split": 0.0}
    for nr in LENGTH_NRS:
        iq = torch.as_tensor(make_batch(length_params(nr), LENGTH_BATCH,
                                        seed=37), device=dev)
        re, im, _ = FX.range_fft_fixed(iq)
        del iq
        tiles = []
        for variant, mode, sb, bypass, so, radius in LENGTH_CASES:
            p = length_params(nr, 128, variant, mode, sb)
            tiles.append(F._slowtime_config(1, nr, 128, p.cfar, so,
                                            radius).T)
            errs["detect"] = max(errs["detect"], _fx_case(
                f"n={nr}", re, im, p, bypass, so, radius))
        log(f"slowtime_detect_fixed n={nr}: tiles {tiles} rows for the "
            f"cases {[c[:3] for c in LENGTH_CASES]}")
        errs["split"] = max(errs["split"], fixed_long_split_case(
            dev, re, im, 128, pgr, tag="fixed split"))
        del re, im
    iq = torch.as_tensor(make_batch(length_params(2048, 256), 8, seed=38),
                         device=dev)
    re, im, _ = FX.range_fft_fixed(iq)
    for mode, sb in (("cell", 8), ("block", 16)):
        errs["detect"] = max(errs["detect"], _fx_case(
            "long", re, im, length_params(2048, 256, "os", mode, sb), False,
            0, pgr))
    return errs


def fixed_length_timings(card: str, dev, pgr: int, errs, launches):
    """Phase 37f: graph-replay times at 2048x128, 1536x128 and 384x128,
    batch 128: the fixed range kernel and its chirp-shard entry at sp 4
    (row 4); the fixed slow-time kernel per-cell, block (fast()) and, at
    2048, block 16 (T = 32), and its split entry on the sp 4 range shard
    (row 6); kernel B at block 16 at 2048 (T = 32); each beside its bound
    (bound_range_fft_fixed: the function's least work, an n-point FFT a
    chirp, whatever the kernel runs; bound_slowtime_fixed,
    bound_slowtime_fixed_split, bound_slowtime), its plain twin and
    torch.fft.fft of its planes (complex128 for the fixed kernels).
    Returns (kernel rows, summary)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.ops import frontend as F, frontend_fixed as FX
    from fmcw_tpu_torch.ops import split_frontend as SF
    from fmcw_tpu_torch.ops.window import hamming_q15, window_apply_fixed
    rows, summary = [], {}
    line_2 = "fmcw_tpu/ops/frontend_pallas.py:813"
    line_4 = "fmcw_tpu/ops/split_frontend.py:111"
    line_6 = "fmcw_tpu/ops/split_frontend.py:625"
    for nr in LENGTH_NRS:
        nd, sp = 128, 4
        ndl = nd // sp
        iq = torch.as_tensor(make_batch(P.RadarParams(n_range=nr), BATCH,
                                        seed=39), device=dev)
        shard = iq[:, ndl:2 * ndl].contiguous()
        wi, wq, _ = window_apply_fixed(iq[..., 0], iq[..., 1],
                                       hamming_q15(nr)[None, :])
        z = torch.complex(wi.double(), wq.double())
        del wi, wq
        fft_r = graph_ms(lambda: torch.fft.fft(z, dim=-1))
        zs = z[:, ndl:2 * ndl].contiguous()
        fft_4 = graph_ms(lambda: torch.fft.fft(zs, dim=-1))
        del z, zs
        entries = [
            (f"range_fft_fixed[n={nr}]", FIXED_LENGTH_SRC, line_2,
             lambda: FX.range_fft_fixed(iq),
             lambda: FX.range_fft_fixed_plain(iq),
             bound_range_fft_fixed(BATCH, nd, nr),
             launches.get(("range_fft_fixed", nr), 0), 0.0, fft_r, True),
            (f"range_frontend_fixed[n={nr},sp4]", FIXED_LENGTH_SRC, line_4,
             lambda: SF.range_frontend_fixed(shard),
             lambda: FX.range_fft_fixed_plain(shard),
             bound_range_fft_fixed(BATCH, ndl, nr),
             launches.get(("range_frontend_fixed", nr), 0), 0.0, fft_4,
             True)]
        re, im, _ = FX.range_fft_fixed(iq)
        z = torch.complex(re.double(), im.double())
        fft_b = graph_ms(lambda: torch.fft.fft(z, dim=-1))
        del z
        configs = [("cell", P.RadarParams(n_range=nr)),
                   ("block", P.fast().replace(n_range=nr))]
        if nr == 2048:
            configs.append(("block16", length_params(nr, scale_mode="block",
                                                     sb=16)))
        for name, p in configs:
            kw = dict(cfar=p.cfar, peak_group_radius=pgr)
            entries.append((
                f"slowtime_detect_fixed[{name},n={nr}]", FIXED_LONG_SRC,
                line_2,
                lambda kw=kw: FX.slowtime_detect_fixed(re, im, False, 0,
                                                       **kw),
                lambda kw=kw: FX.slowtime_detect_fixed_plain(re, im, False,
                                                             0, **kw),
                bound_slowtime_fixed(BATCH, nr, nd, p.cfar),
                launches.get((name, nr), 0), errs["detect"], fft_b, False))
        cfar = P.RadarParams().cfar
        nrl, h = nr // sp, cfar.halo_range + pgr
        ext = torch.arange(nrl - h, 2 * nrl + h, device=dev) % nr
        lo, hi, core = ext[:h], ext[h + nrl:], ext[h:h + nrl]
        args = (re[:, core].contiguous(), im[:, core].contiguous(),
                (re[:, lo].contiguous(), im[:, lo].contiguous()),
                (re[:, hi].contiguous(), im[:, hi].contiguous()), False, 0,
                nrl)
        skw = dict(cfar=cfar, n_range_total=nr, peak_group_radius=pgr)
        z = torch.complex(re[:, ext].double(), im[:, ext].double())
        fft_6 = graph_ms(lambda: torch.fft.fft(z, dim=-1))
        del z
        entries.append((
            f"slowtime_detect_fixed_split[n={nr},sp4]", FIXED_LONG_SRC,
            line_6, lambda: SF.slowtime_detect_fixed_split(*args, **skw),
            lambda: SF.slowtime_detect_fixed_split_plain(*args, **skw),
            bound_slowtime_fixed_split(BATCH, nrl, nd, h, cfar),
            launches.get(("slowtime_detect_fixed_split", nr), 0),
            errs["split"], fft_6, False))
        if nr == 2048:
            fre, fim = F.range_fft(iq)
            z = torch.complex(fre, fim)
            fft_f = graph_ms(lambda: torch.fft.fft(z, dim=-1))
            del z
            p = length_params(nr, scale_mode="block", sb=16)
            kw = dict(cfar=p.cfar, peak_group_radius=pgr)
            entries.append((
                f"slowtime_detect[block16,n={nr}]", LENGTH_SRC_B,
                "fmcw_tpu/ops/frontend_pallas.py:623",
                lambda: F.slowtime_detect(fre, fim, False, 0, **kw),
                lambda: F.slowtime_detect_plain(fre, fim, False, 0, **kw),
                bound_slowtime(BATCH, nr, nd, p.cfar),
                launches.get(("float_block16", nr), 0), 0.0, fft_f, False))
        for name, src, line, call, plain, (bound, by), n, err, lib, whole in (
                entries):
            ms = graph_ms(call)
            plain_ms = cuda_ms(plain, 2, 1)
            log(f"{name} batch {BATCH}: {ms:.4f} ms (graph), plain "
                f"{plain_ms:.4f} ms, torch.fft.fft of its planes {lib:.4f} "
                f"ms, bound {bound:.4f} ms ({by}), "
                f"{'not on a path' if n is None else f'{n} launches'} "
                f"({card})")
            summary[name] = {"ms": ms, "plain_ms": plain_ms, "fft_ms": lib,
                             "bound_ms": bound, "bound_by": by}
            # torch.fft.fft of the windowed chirps computes the range
            # kernel's transform (not its BFP); of the slow-time entries it
            # is the transform's share (the summary's fft_ms).
            rows.append(dict(name=name, route="cuda", source=src,
                             replaces=line, launches=n, max_abs_err=err,
                             ms=ms, plain_ms=plain_ms, bound_ms=bound,
                             bound_by=by, library_ms=lib if whole else None))
        del iq, re, im, args, shard
        torch.cuda.empty_cache()
    return rows, summary


def fixed_length_phase(card: str, dev, pgr: int):
    """Phase 37: the fixed kernels at the range lengths n2 x 128 (37a-f
    above; 37e: make_sharded_processor(mode="fixed", frontend="fused") on
    a LocalMesh at sp 2 and 4 at 2048x128, 1536x128 and 384x128, per-cell,
    fixed_long_local_mesh); the main path first, whose golden checks run in
    worker processes during the rest.  Returns (kernel rows, summary)."""
    import concurrent.futures as cf
    import multiprocessing as mp
    import os
    import torch
    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    workers = max(1, min(7, (os.cpu_count() or 2) - 1))
    with cf.ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        launches, summary, golden = fixed_length_main_path(card, dev, pgr,
                                                           pool)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        checked = fixed_length_range_checks(dev)
        ties = fixed_length_tie_checks(dev)
        t2 = time.perf_counter()
        errs = fixed_length_slowtime_checks(dev, pgr)
        torch.cuda.empty_cache()
        t3 = time.perf_counter()
        for nr in LENGTH_NRS:
            mesh = fixed_long_local_mesh(
                card, dev, pgr, (("os", length_params(nr)),),
                tag=f"fixed {nr}x128")
            launches.update({(k, nr): v for k, v in mesh.items()})
        t4 = time.perf_counter()
        rows, timings = fixed_length_timings(card, dev, pgr, errs, launches)
        t5 = time.perf_counter()
        done = {}
        for key, fut in golden:
            ok, n, off = fut.result()
            acc = done.setdefault(key, [True, 0, 0, 0])
            acc[0] &= ok
            acc[1] += n
            acc[2] += off
            acc[3] += 16
        for (name, nr), (ok, n, off, frames) in done.items():
            log(f"fixed main path {name} {nr}x128: mag and det maps vs the "
                f"golden process_frame_fixed on {frames} frames: "
                f"{'equal' if ok else 'DIFFER'} but at located exact bins "
                f"({off} magnitude rows there; {n} detections)")
            if not ok:
                raise AssertionError(f"fixed main path {name} {nr} differs "
                                     f"from the golden model")
    t6 = time.perf_counter()
    log(f"fixed range-length phase: 37c {t1 - t0:.1f} s, 37a-b "
        f"{t2 - t1:.1f} s ({checked} values), 37d {t3 - t2:.1f} s, 37e "
        f"{t4 - t3:.1f} s, 37f {t5 - t4:.1f} s, golden wait "
        f"{t6 - t5:.1f} s")
    return rows, {"main_path": summary, "timings": timings,
                  "golden_tie_differences": ties,
                  "golden_frame_rows_at_exact_bins": {
                      f"{k[0]}@{k[1]}": v[2] for k, v in done.items()},
                  "launches": {f"{k[0]}@{k[1]}": v
                               for k, v in launches.items()}}


# ---------------------------------------------------------------------------
# The dense lengths: kernel B's dense operator (phase 38)
# ---------------------------------------------------------------------------

DENSE_NR = 1024
DENSE_NDS = (96, 192, 1016)     # the slice's full-width lengths
DENSE_SRC = "fmcw_tpu_torch/csrc/slowtime_detect.cu"
DENSE_ROWS, DENSE_FRAMES = 64, 2        # each length's small map (38a)
# The 3-pulse MTI, the exact magnitude and CA/GO/SO at a spread of lengths
# (38a): every inner transform m (8 .. 64), o from 1 to 255.
DENSE_SPREAD = (8, 24, 40, 48, 96, 136, 192, 200, 504, 1016, 1984, 2040)
DENSE_LINES = {"detect": "fmcw_tpu/ops/frontend_pallas.py:719",
               "mag": "fmcw_tpu/ops/frontend_pallas.py:719",
               "split": "fmcw_tpu/ops/split_frontend.py:562"}


def dense_lengths():
    """Kernel B's dense lengths (ops/frontend.dense_cpi): 8, 24 .. 2040."""
    from fmcw_tpu_torch.ops import frontend as F
    return tuple(nd for nd in range(8, 2049, 8) if F.dense_cpi(nd))


def dense_params(nd: int, variant: str = "os", scale_mode: str = "cell",
                 notch_mode: int = 2, nr: int = DENSE_NR):
    import fmcw_tpu_torch as P
    return P.RadarParams(n_range=nr, n_doppler=nd, notch_mode=notch_mode,
                         cfar=P.CfarParams(variant=variant,
                                           scale_mode=scale_mode))


def dense_kernel_checks(dev, pgr: int):
    """Phase 38a: kernel B at every dense length (237: 8, 24 .. 2040) on 64
    rows x 2 frames of bench.py's stimulus through kernel A (within TOL of
    its twin): the detect entry per-cell (MTI on, notch 2, radius pgr) and
    block (the bypass, override 4, radius 1) through _b_case (magnitudes
    within TOL of the twin's peak, decisions, row maxima and counts bit for
    bit on the kernel's magnitudes); the magnitude-only entry within TOL and
    bit-equal to the detect entry's magnitudes; the split entry at sp 2 (OS;
    at DENSE_SPREAD OS and CA at sp 2 and 4) bit-equal to the whole-frame
    launch's rows and the twin's decision on them.  At DENSE_SPREAD also
    notch 3 with both transients and the exact magnitude, and CA / GO / SO
    per-cell and block.  Returns {entry: largest absolute magnitude
    error}."""
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from fmcw_tpu_torch.ops import fft as TF
    from fmcw_tpu_torch.ops import frontend as F
    errs = {"detect": 0.0, "mag": 0.0, "split": 0.0}
    # The twin's folded matrices (float64 on the host, O(nd^3)) are built
    # ahead on worker threads while the card checks the lengths before;
    # each length waits for its own, then finds it in the twin's cache.
    lengths = dense_lengths()
    pool = ThreadPoolExecutor(4)
    ahead = {nd: pool.submit(TF.doppler_matrices, nd) for nd in lengths[:8]}
    for i, nd in enumerate(lengths):
        if i + 8 < len(lengths):
            ahead[lengths[i + 8]] = pool.submit(TF.doppler_matrices,
                                                lengths[i + 8])
        ahead.pop(nd).result()
        p = dense_params(nd, nr=DENSE_ROWS)
        iq = torch.as_tensor(make_batch(p, DENSE_FRAMES, seed=nd),
                             device=dev)
        re, im = F.range_fft(iq)
        pre, pim = F.range_fft_plain(iq)
        torch.cuda.synchronize()
        peak = float(torch.maximum(pre.abs().max(), pim.abs().max()))
        if not float(torch.maximum((re - pre).abs().max(),
                                   (im - pim).abs().max())) <= TOL * peak:
            raise AssertionError(f"range_fft disagrees at {nd} chirps")
        cases = [(p, False, 0, pgr, {}),
                 (dense_params(nd, scale_mode="block", nr=DENSE_ROWS), True,
                  4, 1, {})]
        if nd in DENSE_SPREAD:
            cases += [(dense_params(nd, notch_mode=3, nr=DENSE_ROWS), False,
                       0, pgr, dict(transient="passthrough", exact_mag=True)),
                      (dense_params(nd, "os", "block", 3, DENSE_ROWS), False,
                       0, pgr, dict(transient="zero"))]
            cases += [(dense_params(nd, v, mode, nr=DENSE_ROWS), False, 0,
                       pgr, {}) for v, mode in (
                          ("ca", "cell"), ("go", "block"), ("so", "cell"),
                          ("ca", "block"))]
        for q, bypass, so, radius, kw in cases:
            errs["detect"] = max(errs["detect"], _b_case(
                "dense", re, im, q, bypass, so, radius, kw))
        _, emitted, _, _, nf = F.slowtime_detect(
            re, im, cfar=p.cfar, peak_group_radius=pgr, emit_mag=True)
        mag, nf2 = F.slowtime_mag(re, im)
        pmag = F.slowtime_mag_plain(re, im, False)
        torch.cuda.synchronize()
        err = float((mag - pmag).abs().max())
        errs["mag"] = max(errs["mag"], err)
        if not (err <= TOL * float(pmag.abs().max())
                and bits_equal(mag, emitted) and torch.equal(nf, nf2)):
            raise AssertionError(f"slowtime_mag disagrees at {nd}")
        spread = nd in DENSE_SPREAD
        errs["split"] = max(errs["split"], long_split_case(
            dev, re, im, nd, pgr, ("os", "ca") if spread else ("os",),
            SPLIT_SPS if spread else (2,), tag="dense"))
        del re, im, pre, pim, mag, pmag, emitted
    pool.shutdown()
    log(f"dense lengths: {len(lengths)} checked, errors {errs}")
    return errs


def dense_main_path(card: str, dev, pgr: int, errs):
    """Phase 38b, the slice's main path: batch 128 of bench.py's stimulus at
    1024x96, 1024x192 and 1024x1016 (o = 127, the outer sums' worst case
    here) through make_batch_processor(include_maps=False), the entry
    config (per-cell) and fast() (block): float "auto" is the fused route
    (before: staged); only kernel A, kernel B's two launches and the top-K
    run; kernel B on the whole batch's planes (131,072 rows: the map
    kernel's row-striding loop, the decide kernel's 16 row tiles) through
    _b_case, magnitudes within TOL of the twin and the decision bit for bit
    on them (the largest error joins errs["detect"]); frame 0 through the
    margin gate against the plain route's exact taps; on 4 frames with the
    maps the route's det maps bit-equal to the plain decision (detect_plain)
    on its magnitudes; frames/s beside the staged route, timed in the same
    run.  Returns ({(kernel, nd): launches}, summary)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch import kernels, parity
    from fmcw_tpu_torch.golden import reference
    from fmcw_tpu_torch.models import pipeline as pl
    from fmcw_tpu_torch.ops import frontend as F
    launches, summary = {}, {}
    for nd in DENSE_NDS:
        for name, p in (("cell", P.RadarParams(n_doppler=nd)),
                        ("block", P.fast().replace(n_doppler=nd))):
            proc = pl.make_batch_processor(p, peak_group_radius=pgr,
                                           include_maps=False, device=dev)
            if proc.route != "fused":
                raise AssertionError(f"1024x{nd} auto is {proc.route}")
            batch = torch.as_tensor(make_batch(p, BATCH), device=dev)
            kernels.reset_launch_counts()
            out = proc(batch)
            torch.cuda.synchronize()
            counts = {k: v for k, v in kernels.launch_counts().items() if v}
            log(f"dense main path {name} 1024x{nd}: launches "
                + ", ".join(f"{k}={v}" for k, v in counts.items()))
            if counts != {"range_fft": 1, "slowtime_detect": 2}:
                raise AssertionError(f"dense main path {name} {nd}: "
                                     f"launches {counts}")
            launches[("range_fft", nd)] = launches.get(
                ("range_fft", nd), 0) + counts["range_fft"]
            launches[(name, nd)] = counts["slowtime_detect"]
            re, im = F.range_fft(batch)
            errs["detect"] = max(errs["detect"], _b_case(
                f"main path batch {BATCH}", re, im, p, False, 0, pgr))
            del re, im
            for key in ("range_bin", "doppler_bin", "mag", "valid"):
                if tuple(out[key].shape) != (BATCH, p.tracker.max_dets):
                    raise AssertionError(f"{key} shape "
                                         f"{tuple(out[key].shape)}")
            if not bool(torch.isfinite(out["mag"]).all()) or int(
                    out["nonfinite_count"].sum()) != 0:
                raise AssertionError("non-finite magnitudes")
            ref = pl.make_processor(p, peak_group_radius=pgr,
                                    frontend="plain", include_debug=True,
                                    cfar_rank_bits=None, device=dev)(
                                        batch[0])
            ok, report = parity.margin_gate(
                parity.detection_set(out, 0), parity.detection_set(ref),
                ref["mag_map"].cpu().numpy(),
                ref["threshold_map"].cpu().numpy(),
                ref["scale_map"].cpu().numpy(), radius=pgr,
                capacity=p.tracker.max_dets,
                targets=reference.golden_targets(p))
            log(f"dense main path {name} 1024x{nd} frame 0 vs plain path: "
                f"{report}")
            if not ok:
                raise AssertionError(f"dense main path {name} {nd}: margin "
                                     f"gate failed")
            del ref, out
            maps = pl.make_batch_processor(p, peak_group_radius=pgr,
                                           device=dev)(batch[:4])
            det = F.detect_plain(maps["mag_map"], p.cfar, 0, pgr)[0]
            torch.cuda.synchronize()
            if not bits_equal(det, maps["det_map"]):
                raise AssertionError(f"dense main path {name} {nd}: det maps "
                                     f"differ from the plain decision")
            del maps, det
            staged = pl.make_batch_processor(p, frontend="staged",
                                             peak_group_radius=pgr,
                                             include_maps=False, device=dev)
            fps = BATCH * 1e3 / cuda_ms(lambda: proc(batch), 10)
            fps_staged = BATCH * 1e3 / cuda_ms(lambda: staged(batch), 3)
            summary[f"{name}@{nd}"] = {"frames_per_s": fps,
                                       "staged_frames_per_s": fps_staged}
            log(f"dense main path {name} 1024x{nd}: {fps:.1f} frames/s "
                f"(fused; det maps bit-equal to the plain decision on 4 "
                f"frames), staged route {fps_staged:.1f} frames/s at batch "
                f"{BATCH} ({card})")
            del batch
            torch.cuda.empty_cache()
    return launches, summary


def dense_timings(card: str, dev, pgr: int, errs, launches):
    """Phase 38e: graph-replay times at 1024x96 and 1024x192 (batch 128)
    and 1024x1016 (batch 16): kernel B's detect entry per-cell and block
    (fast()), its magnitude-only entry and its split entry on the sp 4
    range shard (rows 256..512 with their halo rows), each beside its bound
    (bound_slowtime, bound_slowtime_mag, bound_slowtime_split: an nd-point
    FFT a row, whatever the kernel runs), its plain twin and torch.fft.fft
    of its complex planes along Doppler (no PyTorch call computes an entry:
    the FFT is its transform's share).  An entry joins the kernels line
    only at a length where phases 38b-d counted its launches on a path
    (the split entry at 1016, which no mesh takes, stays in the summary).
    Returns (kernel rows, summary)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.ops import frontend as F
    from fmcw_tpu_torch.ops import split_frontend as SF
    rows, summary = [], {}
    for nd, batch in ((96, BATCH), (192, BATCH), (1016, 16)):
        iq = torch.as_tensor(make_batch(P.RadarParams(n_doppler=nd), batch,
                                        seed=39), device=dev)
        re, im = F.range_fft(iq)
        del iq
        z = torch.complex(re, im)
        fft = graph_ms(lambda: torch.fft.fft(z, dim=-1))
        del z
        entries = []
        for name, p in (("cell", P.RadarParams(n_doppler=nd)),
                        ("block", P.fast().replace(n_doppler=nd))):
            kw = dict(cfar=p.cfar, peak_group_radius=pgr)
            entries.append((
                f"slowtime_detect[dense,{name},{nd}]",
                lambda kw=kw: F.slowtime_detect(re, im, False, 0, **kw),
                lambda kw=kw: F.slowtime_detect_plain(re, im, False, 0,
                                                      **kw),
                bound_slowtime(batch, DENSE_NR, nd, p.cfar),
                (name, nd), errs["detect"],
                DENSE_LINES["detect"], fft))
        entries.append((
            f"slowtime_mag[dense,{nd}]", lambda: F.slowtime_mag(re, im),
            lambda: F.slowtime_mag_plain(re, im, False),
            bound_slowtime_mag(batch, DENSE_NR, nd),
            ("slowtime_mag", nd), errs["mag"],
            DENSE_LINES["mag"], fft))
        cfar = P.RadarParams().cfar
        sp, s = 4, 1
        nrl, h = DENSE_NR // sp, cfar.halo_range + pgr
        ext = torch.arange(s * nrl - h, (s + 1) * nrl + h,
                           device=dev) % DENSE_NR
        lo, hi, core = ext[:h], ext[h + nrl:], ext[h:h + nrl]
        args = (re[:, core].contiguous(), im[:, core].contiguous(),
                (re[:, lo].contiguous(), im[:, lo].contiguous()),
                (re[:, hi].contiguous(), im[:, hi].contiguous()), False, 0,
                s * nrl)
        skw = dict(cfar=cfar, n_range_total=DENSE_NR, peak_group_radius=pgr)
        z = torch.complex(re[:, ext], im[:, ext])
        fft_shard = graph_ms(lambda: torch.fft.fft(z, dim=-1))
        del z
        entries.append((
            f"slowtime_detect_split[dense,{nd},sp4]",
            lambda: SF.slowtime_detect_split(*args, **skw),
            lambda: SF.slowtime_detect_split_plain(*args, **skw),
            bound_slowtime_split(batch, nrl, nd, h, cfar),
            ("slowtime_detect_split", nd), errs["split"],
            DENSE_LINES["split"], fft_shard))
        for name, call, plain, (bound, by), key, err, line, lib in entries:
            n = launches.get(key)
            ms = graph_ms(call, 10 if nd > 512 else 20)
            plain_ms = cuda_ms(plain, 2, 1)
            log(f"{name} batch {batch}: {ms:.4f} ms (graph), plain "
                f"{plain_ms:.4f} ms, torch.fft.fft of its planes {lib:.4f} "
                f"ms, bound {bound:.4f} ms ({by}), "
                f"{'not on a path' if n is None else f'{n} launches'} "
                f"({card})")
            summary[f"{name}x{batch}"] = {
                "ms": ms, "plain_ms": plain_ms, "fft_ms": lib,
                "bound_ms": bound, "bound_by": by}
            if n is None:
                continue
            rows.append(dict(name=name, route="cuda", source=DENSE_SRC,
                             replaces=line, launches=n, max_abs_err=err,
                             ms=ms, plain_ms=plain_ms, bound_ms=bound,
                             bound_by=by, library_ms=None))
        del re, im, args
        torch.cuda.empty_cache()
    return rows, summary


def dense_phase(card: str, dev, pgr: int):
    """Phase 38: kernel B's dense operator (38a-e: 38a every dense length
    against the twins; 38b the main path at 1024x96, 1024x192, 1024x1016;
    38c phase 32's other routes (the debug taps, reflect, hw-compat float,
    the array model at ref_angle 0 and 1) at 1024x96, the debug taps at
    1024x192 and 1024x1016; 38d a LocalMesh at sp 2 and 4 at 1024x96
    (per-cell, block, debug) and 1024x192 (per-cell; 1016 / sp is no
    multiple of 8, so no mesh takes 1016); 38e the entries' times, on the
    kernels line where 38b-d counted the entry's launches at that length).
    Returns (kernel rows, summary)."""
    import torch
    t0 = time.perf_counter()
    errs = dense_kernel_checks(dev, pgr)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    launches, summary = dense_main_path(card, dev, pgr, errs)
    t2 = time.perf_counter()
    p96 = dense_params(96)
    other = long_other_routes(card, dev, pgr, p96, tag="1024x96")
    launches[("slowtime_mag", 96)] = other["slowtime_mag"]
    # The magnitude-only entry's count at the other timed lengths: the
    # debug taps at 192 and 1016 (the rank-select CFAR's chunks there).
    # Float "auto" under reflect edges at 1016 runs too; its count is
    # logged only.
    for nd, reflect in ((192, False), (1016, False), (1016, True)):
        p = dense_params(nd)
        batch = torch.as_tensor(make_batch(p, ARRAY_BATCH, seed=4),
                                device=dev)
        n = mag_route_case(dev, pgr, p, batch, f"1024x{nd}", reflect)
        if not reflect:
            launches[("slowtime_mag", nd)] = n
        del batch
    t3 = time.perf_counter()
    for nd, configs in (
            (96, (("cell", p96, {}, "slowtime_detect_split"),
                  ("block", dense_params(96, scale_mode="block"), {},
                   "slowtime_mag"),
                  ("debug", p96, dict(include_debug=True), "slowtime_mag"))),
            (192, (("cell", dense_params(192), {},
                    "slowtime_detect_split"),))):
        mesh = long_local_mesh(card, dev, pgr, configs, tag=f"1024x{nd}")
        launches[("slowtime_detect_split", nd)] = mesh[
            "slowtime_detect_split"]
    t4 = time.perf_counter()
    rows, timings = dense_timings(card, dev, pgr, errs, launches)
    log(f"dense phase: 38a {t1 - t0:.1f} s, 38b {t2 - t1:.1f} s, 38c "
        f"{t3 - t2:.1f} s, 38d {t4 - t3:.1f} s, 38e "
        f"{time.perf_counter() - t4:.1f} s")
    return rows, {"main_path": summary, "timings": timings,
                  "launches": {f"{k[0]}@{k[1]}": v
                               for k, v in launches.items()}}


# ---------------------------------------------------------------------------
# Wide maps in the standalone CFAR kernels: column chunks (phase 39)
# ---------------------------------------------------------------------------

WIDE_NR = 1024
WIDE_DS = (584, 768, 1016, 1024, 1816, 2048, 4096)
WIDE_SRC = {"cfar_rank": "fmcw_tpu_torch/csrc/cfar_rank.cu",
            "cfar_detect": "fmcw_tpu_torch/csrc/cfar_detect.cu",
            "cfar3d_detect": "fmcw_tpu_torch/csrc/cfar_3d_detect.cu"}
WIDE_LINES = {"cfar_rank": "fmcw_tpu/ops/cfar_pallas.py:58",
              "cfar_detect": "fmcw_tpu/ops/cfar_pallas.py:155",
              "cfar3d_detect": "fmcw_tpu/ops/cfar_pallas.py:569"}


def wide_map(B: int, D: int, integer: bool, seed: int, dev):
    """(B, 1024, D) maps made on the card from a seeded generator:
    exponential noise (mean 8), 2% of the cells x 40; int32 maps truncated
    (ties within windows and between grouping neighbours), float maps on a
    0.5 grid with a NaN, a +Inf and a -0.0 in frame 0."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    m = torch.empty((B, WIDE_NR, D), device=dev).exponential_(
        1 / 8, generator=g)
    strong = torch.rand(m.shape, generator=g, device=dev) < 0.02
    m = torch.where(strong, m * 40, m)
    if integer:
        return m.to(torch.int32)
    m = torch.round(m * 2) / 2
    m[0, 3, 5], m[0, 7, D - 1], m[0, 9, 0] = float("nan"), float("inf"), -0.0
    return m


def wide_shard(m, hr: int, reflect: bool):
    """The sp 4 range shard 0 of maps m (B, R, D) with its hr halo rows on
    each side, as the sharded tail gets it: the neighbours' rows, wrapped
    or (reflect, at the global edge) mirrored; and its own rows."""
    import torch
    R = m.shape[-2]
    nrl = R // 4
    rows = torch.arange(-hr, nrl + hr, device=m.device)
    rows = rows.abs() if reflect else rows % R
    return m[:, rows].contiguous(), slice(0, nrl)


def wide_pair(what: str, got, want) -> float:
    """Kernel outputs against the twin's, bit for bit, or raises; returns
    the largest |difference| (0)."""
    import torch
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    same = len(got) == len(want) and all(
        bits_equal(a, b) for a, b in zip(got, want))
    if not same:
        raise AssertionError(f"{what} disagrees with its twin")
    return max(float((a.double() - b.double()).nan_to_num().abs().max())
               for a, b in zip(got, want))


def wide_rank_check(dev):
    """Phase 39a: ops/cfar_rank.tile_bytes, the host mirror of
    csrc/cfar_rank.cu's layout() that plans the rank tiles, equal to
    fmcw_cfar_rank_smem over a grid of widths, chunks, tile rows, windows,
    grouping radii, key bits and scale modes.  Returns the configurations
    checked."""
    import ctypes
    import itertools
    from fmcw_tpu_torch import kernels
    from fmcw_tpu_torch.ops import cfar_rank as RK
    lib = kernels.load()
    n = 0
    for D, W, T, (hr, hd), pgr, bits, block in itertools.product(
            (96, 584, 1016, 4096), (32, 96, 128, None), (1, 8, 32),
            ((6, 5), (3, 3), (12, 15)), (-1, 0, 2), (16, 31),
            (False, True)):
        W = D if W is None or W > D else W
        cfg = kernels.CfarRankConfig(
            batch=1, R=1024, D=D, T=T, hr=hr, hd=hd, gr=1, gd=1, n_ref=8,
            k=4, block_mode=int(block), bits=bits, pgr=pgr, W=W)
        want = lib.fmcw_cfar_rank_smem(ctypes.byref(cfg))
        got = RK.tile_bytes(T, D, W, hr, hd, pgr, bits, not block)
        if got != want:
            raise AssertionError(f"cfar_rank tile_bytes {got} != the "
                                 f"kernel's {want} at {cfg}")
        n += 1
    log(f"cfar_rank tile_bytes: the kernel's layout() on {n} "
        f"configurations")
    return n


def wide_entry_checks(dev):
    """Phase 39b: the chunked entries of the three kernels against their
    twins bit for bit at 1024 rows x each width of WIDE_DS (batch 4, 2 above
    1024 columns; the plans there in the log): the rank select (float 16
    and 31 key bits, int32, the override, a given block scale map, wrap
    and reflect, the 7- and 9-row windows too; its grouping entry at radius
    0-2), the standalone CFAR
    (int32 and float, per-cell and a scale map, the override, wrap and
    reflect; its grouping entry at radius 0-2), their sp 4 prepadded range
    shards (wrap, and the reflect edge shard), and the 3D CFAR at
    ref_angle 1-3 on 4-plane cubes (float and int32, wrap and reflect, a
    prepadded beam shard).  Returns {entry: largest error} (0)."""
    import dataclasses as dc
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.ops import cfar as C, cfar3d_detect as C3
    from fmcw_tpu_torch.ops import cfar_detect as CD, cfar_rank as RK
    full, fast = P.RadarParams().cfar, P.fast().cfar
    refl = dc.replace(full, edge_mode="reflect")
    rblk = dc.replace(fast, edge_mode="reflect")
    # Windows of 7 and 9 rows: the rank select's chunks of a window it does
    # not unroll (from 1816 columns on; with grouping from 768 or 1016).
    w3 = P.quick().cfar
    w4 = dc.replace(w3, ref_range=3)
    hr = full.halo_range
    errs = {}
    for D in WIDE_DS:
        B = 4 if D <= 1024 else 2
        fm = wide_map(B, D, False, D, dev)
        im = wide_map(B, D, True, D + 1, dev)
        fs, is_ = C.block_scale_map(fm, fast), C.block_scale_map(im, fast)
        ir = C.block_scale_map(im, rblk)
        rank = [("float,16 bits", fm, 0, full, 16, None),
                ("int32,16 bits,so 4", im, 4, full, 16, None),
                ("float,exact,scale map", fm, 0, fast, None, fs),
                ("reflect,float,16 bits", fm, 0, refl, 16, None),
                ("reflect,int32,exact,scale map", im, 0, rblk, None, ir),
                ("hr 3,float,16 bits", fm, 0, w3, 16, None),
                ("hr 4,int32,exact", im, 2, w4, None, None),
                ("reflect,hr 3,int32,16 bits", im, 0,
                 dc.replace(w3, edge_mode="reflect"), 16, None),
                ("reflect,hr 4,float,exact", fm, 0,
                 dc.replace(w4, edge_mode="reflect"), None, None)]
        for what, m, so, cfar, bits, sm in rank:
            kw = dict(cfar=cfar, bits=bits, scale_map=sm)
            key = f"cfar_rank[{what}]"
            errs[key] = max(errs.get(key, 0.0), wide_pair(
                f"{key} 1024x{D}", RK.cfar_rank(m, so, **kw),
                RK.cfar_rank_plain(m, so, **kw)))
            if cfar.edge_mode == "wrap":
                for pgr in (0, 1, 2):
                    key = f"cfar_rank_group[{what}]"
                    errs[key] = max(errs.get(key, 0.0), wide_pair(
                        f"{key} radius {pgr} 1024x{D}",
                        RK.cfar_rank_group(m, so, peak_group_radius=pgr,
                                           **kw),
                        RK.cfar_rank_group_plain(m, so,
                                                 peak_group_radius=pgr,
                                                 **kw)))
        det = [("int32", im, 0, full, None), ("float,so 4", fm, 4, full, None),
               ("int32,scale map", im, 0, fast, is_),
               ("float,scale map", fm, 0, fast, fs),
               ("reflect,int32", im, 0, refl, None),
               ("reflect,float,scale map", fm, 4, rblk,
                C.block_scale_map(fm, rblk))]
        for what, m, so, cfar, sm in det:
            key = f"cfar_detect[{what}]"
            errs[key] = max(errs.get(key, 0.0), detect_case(
                f"wide 1024x{D} {what}", m, so, cfar, scale_map=sm,
                pgrs=(0, 1, 2) if cfar.edge_mode == "wrap" else ()))
        # The sp 4 range shards of the sharded tails: wrap (rows 256 ..
        # of 1024 wrap to the last rows at shard 0) and the reflect edge
        # shard; a block shard with its rows of the whole map's scale.
        for what, m, cfar, sm, reflect in (
                ("float", fm, full, None, False),
                ("int32,scale map", im, fast, is_, False),
                ("reflect,float", fm, refl, None, True)):
            m_h, own = wide_shard(m, hr, reflect)
            sm = None if sm is None else sm[:, own].contiguous()
            key = f"cfar_detect[prepadded,{what}]"
            errs[key] = max(errs.get(key, 0.0), detect_case(
                f"wide 1024x{D} sp 4 shard {what}", m_h, 0, cfar,
                scale_map=sm, prepadded=True))
            kw = dict(cfar=cfar, bits=16, scale_map=sm, prepadded_range=True)
            key = f"cfar_rank[prepadded,{what}]"
            errs[key] = max(errs.get(key, 0.0), wide_pair(
                f"{key} 1024x{D}", RK.cfar_rank(m_h, **kw),
                RK.cfar_rank_plain(m_h, **kw)))
        del fm, im, fs, is_, ir
        cube = wide_map(4, D, False, 3 * D, dev)[None]
        icube = wide_map(4, D, True, 3 * D + 1, dev)[None]
        for what, c, cfar, ra, pre in (
                ("float,ref_angle 1", cube, full, 1, False),
                ("int32,ref_angle 2,reflect", icube, refl, 2, False),
                ("float,ref_angle 3", cube, full, 3, False),
                ("int32,ref_angle 1,reflect", icube, refl, 1, False),
                ("float,prepadded,ref_angle 1", cube, full, 1, True)):
            kw = dict(cfar=cfar, ref_angle=ra, prepadded_angle=pre)
            key = f"cfar3d_detect[{what}]"
            errs[key] = max(errs.get(key, 0.0), wide_pair(
                f"{key} 1024x{D}", C3.cfar3d_detect(c, **kw),
                C3.cfar3d_detect_plain(c, **kw)))
        del cube, icube
        torch.cuda.empty_cache()
        log(f"wide 1024x{D}: every entry bit-identical to its twin; plans "
            f"cfar_detect_group (T, strip, W) "
            f"{CD.tile_plan(WIDE_NR, D, hr, full.halo_doppler, 2)}, "
            f"cfar_rank_group (T, W) "
            f"{RK.tile_plan(WIDE_NR, D, hr, full.halo_doppler, 2, 16, True)}"
            f", cfar3d_detect ref_angle 1 / 2 "
            f"{C3.tile_plan(WIDE_NR, D, 1, hr, full.halo_doppler)} / "
            f"{C3.tile_plan(WIDE_NR, D, 2, hr, full.halo_doppler)}")
    return errs


def wide_paths(card: str, dev, pgr: int, pool):
    """Phase 39c: the processors at batch 16 (16 cubes), each path's
    launches counted (reset just before it, read just after):
    * the float debug taps (kernel A, the magnitude-only entry, the
      rank-select CFAR's grouping entry, chunked) at 1024x1016 and
      1024x2048, frame 0 through the margin gate against the plain route;
      fixed mode's debug taps there (the staged route's plain stages, the
      grouping entry on int32 maps), every output bit-equal to the plain
      route;
    * fixed "auto" per-cell (the standalone CFAR's grouping entry,
      chunked) at 1024x1920 and 1024x2048: every output bit-equal to the
      plain route, the mag and det maps of 4 frames to the golden
      process_frame_fixed (worker processes), at 1920 but at located exact
      Doppler bins (ROADMAP fault 5: 1920 = 15 x 128 is mixed radix);
    * the array model's 3D CFAR at ref_angle 1 and 2 at 1024x1016 and
      1024x1024 (8 elements x 8 beams), cube 0 through the array gate;
    * a LocalMesh at sp 4 on the debug taps at 1024x2048 (the sharded tail's
      prepadded rank select), every output bit-equal to the single card.
    Returns ({(entry, nd): launches}, maps for the timings, golden
    futures)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch import kernels, parity
    from fmcw_tpu_torch.golden import reference
    from fmcw_tpu_torch.models import pipeline as pl
    from fmcw_tpu_torch.ops import cfar as C
    from fmcw_tpu_torch.parallel import mesh as M, sharded as SH
    launches, maps, golden = {}, {}, []

    def counted(proc, batch):
        kernels.reset_launch_counts()
        out = proc(batch)
        torch.cuda.synchronize()
        return out, {k: v for k, v in kernels.launch_counts().items() if v}

    for nd in (1016, 2048):
        p = P.RadarParams(n_doppler=nd)
        batch = torch.as_tensor(make_batch(p, ARRAY_BATCH, seed=39),
                                device=dev)
        kw = dict(peak_group_radius=pgr, include_debug=True)
        proc = pl.make_batch_processor(p, device=dev, **kw)
        out, counts = counted(proc, batch)
        log(f"wide 1024x{nd} float debug taps: route {proc.route}, launches "
            + ", ".join(f"{k}={v}" for k, v in counts.items()))
        if proc.route != "fused" or "cfar_rank_group" not in counts:
            raise AssertionError(f"1024x{nd} debug taps skipped a kernel")
        launches[("cfar_rank_group[float,16 bits]", nd)] = counts[
            "cfar_rank_group"]
        ref = pl.make_processor(p, frontend="plain", device=dev,
                                **kw)(batch[0])
        ok, report = parity.margin_gate(
            parity.detection_set(out, 0), parity.detection_set(ref),
            ref["mag_map"].cpu().numpy(), ref["threshold_map"].cpu().numpy(),
            ref["scale_map"].cpu().numpy(), radius=pgr,
            capacity=p.tracker.max_dets, targets=reference.golden_targets(p))
        log(f"wide 1024x{nd} float debug taps frame 0 vs plain path: "
            f"{report}")
        if not ok:
            raise AssertionError(f"1024x{nd} debug taps: margin gate failed")
        maps[("float", nd)] = out["mag_map"]
        del out, ref
    # Fixed mode: the debug taps at 1016 and 2048, "auto" at 1920 and 2048
    # (the golden model on 4 frames of each of the latter).
    for nd, name, kw in ((1016, "debug", dict(include_debug=True)),
                         (2048, "debug", dict(include_debug=True)),
                         (1920, "auto", {}), (2048, "auto", {})):
        p = P.RadarParams(n_doppler=nd)
        frames = make_batch(p, ARRAY_BATCH, seed=41)
        batch = torch.as_tensor(frames, device=dev)
        proc = pl.make_batch_processor(p, mode="fixed", device=dev,
                                       peak_group_radius=pgr, **kw)
        out, counts = counted(proc, batch)
        entry = "cfar_rank_group" if name == "debug" else "cfar_detect_group"
        log(f"wide 1024x{nd} fixed {name}: route {proc.route}, launches "
            + ", ".join(f"{k}={v}" for k, v in counts.items()))
        if entry not in counts:
            raise AssertionError(f"1024x{nd} fixed {name} skipped {entry}")
        launches[(f"{entry}[int32,16 bits]" if name == "debug"
                  else f"{entry}[int32]", nd)] = counts[entry]
        want = pl.make_batch_processor(p, mode="fixed", device=dev,
                                       frontend="plain",
                                       peak_group_radius=pgr, **kw)(batch)
        diff = [k for k in want if not torch.equal(out[k], want[k])]
        log(f"wide 1024x{nd} fixed {name}: "
            f"{'every output bit-equal' if not diff else diff} to the "
            f"plain route, {int(out['n_dets'].min())}.."
            f"{int(out['n_dets'].max())} detections a frame")
        if diff:
            raise AssertionError(f"1024x{nd} fixed {name} differs")
        if name == "auto":
            for i in (0, 2):
                golden.append((nd, pool.submit(golden_frames_located, (
                    frames[i:i + 2], out["mag_map"][i:i + 2].cpu().numpy(),
                    out["det_map"][i:i + 2].cpu().numpy(), p, pgr,
                    "doppler"))))
        maps[("int32", nd)] = out["mag_map"]
        del out, want, batch
    # The array model's 3D CFAR.
    beam = matched_beam()
    for nd in (1016, 1024):
        p = P.RadarParams(n_doppler=nd)
        batch = torch.as_tensor(make_cubes(p, ARRAY_BATCH), device=dev)
        for ra in (1, 2):
            kw = dict(ref_angle=ra, peak_group_radius=pgr)
            proc = pl.make_batch_array_processor(
                p, n_elems=N_ELEMS, n_beams=N_BEAMS, device=dev, **kw)
            out, counts = counted(proc, batch)
            log(f"wide 1024x{nd} array ref_angle {ra}: route {proc.route}, "
                f"launches " + ", ".join(f"{k}={v}" for k, v in
                                          counts.items()))
            if "cfar3d_detect" not in counts:
                raise AssertionError(f"1024x{nd} array skipped the 3D CFAR")
            launches[(f"cfar3d_detect[ref_angle {ra}]", nd)] = counts[
                "cfar3d_detect"]
            ref = pl.make_array_processor(
                p, n_elems=N_ELEMS, n_beams=N_BEAMS, frontend="plain",
                device=dev, **kw)(batch[0])
            Mc = ref["mag_cube"]
            _, T, S = C.cfar_3d(Mc, 0, p.cfar, ra, 0, need_debug=True)
            ok, report = parity.array_gate(
                parity.array_set(out, 0), parity.array_set(ref),
                Mc.cpu().numpy(), T.cpu().numpy(), S.cpu().numpy(),
                radius=pgr, beam_radius=0,
                targets=reference.golden_targets(p), target_beam=beam,
                capacity=p.tracker.max_dets)
            log(f"wide 1024x{nd} array ref_angle {ra} cube 0 vs plain path: "
                f"{report}")
            if not ok:
                raise AssertionError(f"1024x{nd} array ref_angle {ra}: "
                                     f"array gate failed")
            maps[("cube", nd)] = out["mag_cube"]
            del out, ref, Mc, T, S
        del batch
        torch.cuda.empty_cache()
    # A LocalMesh at sp 4 on the debug taps.
    p = P.RadarParams(n_doppler=2048)
    batch = torch.as_tensor(make_batch(p, ARRAY_BATCH, seed=7), device=dev)
    kw = dict(peak_group_radius=pgr, include_debug=True, include_maps=True)
    want = pl.make_batch_processor(p, device=dev, **kw)(batch)
    proc = SH.make_sharded_processor(M.LocalMesh(1, 4, dev), p, **kw)
    out, counts = counted(proc, batch)
    diff = [k for k in want if not torch.equal(out[k], want[k])]
    log(f"wide 1024x2048 LocalMesh debug sp=4: launches "
        + ", ".join(f"{k}={v}" for k, v in counts.items())
        + f"; {'all outputs bit-equal' if not diff else diff} to the "
        f"single card")
    if diff or "cfar_rank" not in counts:
        raise AssertionError("1024x2048 LocalMesh debug sp 4 differs or "
                             "skipped the rank select")
    launches[("cfar_rank[prepadded,float,16 bits]", 2048)] = counts[
        "cfar_rank"]
    del out, want, batch
    torch.cuda.empty_cache()
    return launches, maps, golden


def wide_timings(card: str, dev, pgr: int, errs, launches, maps):
    """Phase 39d: each entry that phase 39c counted, at its width and batch
    16 (16 cubes for the 3D CFAR) on that path's maps: the kernel (CUDA
    events, eager; 3 launches), its twin (one call), the bound
    (bound_cfar_rank, bound_cfar_detect, bound_cfar3d); no PyTorch call
    computes an entry (library_ms null).  Returns (kernel rows,
    summary)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.ops import cfar3d_detect as C3
    from fmcw_tpu_torch.ops import cfar_detect as CD, cfar_rank as RK
    full = P.RadarParams().cfar
    hr, hd = full.halo_range, full.halo_doppler
    rows, summary = [], {}
    for (entry, nd), n in sorted(launches.items()):
        base = entry.split("[")[0]
        kernel_name = base.replace("_group", "")
        if base.startswith("cfar_rank"):
            bits, group = 16, base == "cfar_rank_group"
            if entry.startswith("cfar_rank[prepadded"):
                m, _ = wide_shard(maps[("float", nd)], hr, False)
                kw = dict(cfar=full, bits=bits, prepadded_range=True)
                R = m.shape[-2] - 2 * hr
            else:
                m = maps[("int32" if "int32" in entry else "float", nd)]
                kw = dict(cfar=full, bits=bits)
                R = WIDE_NR
                if group:
                    kw["peak_group_radius"] = pgr
            call = RK.cfar_rank_group if group else RK.cfar_rank
            twin = RK.cfar_rank_group_plain if group else RK.cfar_rank_plain
            run = (lambda: call(m, **kw))
            plain = (lambda: twin(m, **kw))
            bound, by = bound_cfar_rank(m.shape[0], R, nd, full, bits,
                                        not m.is_floating_point(), False,
                                        group)
            plan = RK.tile_plan(R, nd, hr, hd, pgr if group else -1, bits,
                                True)
        elif base.startswith("cfar_detect"):
            m = maps[("int32", nd)]
            kw = dict(cfar=full, peak_group_radius=pgr)
            run = (lambda: CD.cfar_detect_group(m, **kw))
            plain = (lambda: CD.cfar_detect_group_plain(m, **kw))
            in_float = int(m.abs().max()) <= CD.float_max(full)
            bound, by = bound_cfar_detect(m.shape[0], WIDE_NR, nd, full,
                                          in_float, group=True)
            plan = CD.tile_plan(WIDE_NR, nd, hr, hd, pgr)
        else:
            ra = int(entry.split()[-1].rstrip("]"))
            m = maps[("cube", nd)]
            kw = dict(cfar=full, ref_angle=ra)
            run = (lambda: C3.cfar3d_detect(m, **kw))
            plain = (lambda: C3.cfar3d_detect_plain(m, **kw))
            bound, by = bound_cfar3d(m.numel(), full, ra, 0, False)
            plan = C3.tile_plan(WIDE_NR, nd, ra, hr, hd)
        ms = cuda_ms(run, 3, 1)
        plain_ms = cuda_ms(plain, 1, 0)
        name = f"{entry},1024x{nd}"
        log(f"{name} batch {m.shape[0]}: {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, bound {bound:.4f} ms ({by}), {n} launches, plan {plan} "
            f"({card})")
        summary[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                         "bound_by": by, "plan": list(plan)}
        # 39b held each entry of this kernel bit for bit (errors 0).
        err = max(v for k, v in errs.items() if k.startswith(kernel_name))
        rows.append(dict(name=name, route="cuda",
                         source=WIDE_SRC[kernel_name],
                         replaces=WIDE_LINES[kernel_name], launches=n,
                         max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                         library_ms=None))
    return rows, summary


def wide_phase(card: str, dev, pgr: int):
    """Phase 39: the standalone CFAR kernels on wide maps (39a the rank
    layout's host mirror; 39b every chunked entry against its twin; 39c the
    processors at the wide maps; 39d timings);
    the golden checks of 39c run in worker processes during 39d.  Returns
    (kernel rows, summary)."""
    import concurrent.futures as cf
    import multiprocessing as mp
    import os
    import torch
    t0 = time.perf_counter()
    n_layouts = wide_rank_check(dev)
    errs = wide_entry_checks(dev)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ctx = mp.get_context("spawn")
    workers = max(1, min(4, (os.cpu_count() or 2) - 1))
    with cf.ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        launches, maps, golden = wide_paths(card, dev, pgr, pool)
        t2 = time.perf_counter()
        rows, timings = wide_timings(card, dev, pgr, errs, launches, maps)
        del maps
        torch.cuda.empty_cache()
        t3 = time.perf_counter()
        for nd, fut in golden:
            ok, n, off = fut.result()
            log(f"wide 1024x{nd} fixed auto: mag and det maps of 2 frames "
                f"vs the golden process_frame_fixed: "
                f"{'equal' if ok else 'DIFFER'} ({n} detections; {off} "
                f"magnitude columns differ"
                f"{', all at exact Doppler bins' if off else ''})")
            if nd == 2048 and off:
                raise AssertionError("1024x2048 fixed auto: magnitudes "
                                     "differ from the golden model")
            if not ok:
                raise AssertionError(f"1024x{nd} fixed auto differs from "
                                     f"the golden model")
    log(f"wide phase: 39a-b {t1 - t0:.1f} s, 39c {t2 - t1:.1f} s, 39d "
        f"{t3 - t2:.1f} s, golden wait {time.perf_counter() - t3:.1f} s")
    return rows, {"rank_layouts_checked": n_layouts, "timings": timings,
                  "launches": {f"{k[0]}@{k[1]}": v
                               for k, v in launches.items()}}


# ---------------------------------------------------------------------------
# The fixed dense operator: the fixed slow-time kernel at the dense lengths
# (phase 40)
# ---------------------------------------------------------------------------

FIXED_DENSE_SRC = "fmcw_tpu_torch/csrc/slowtime_detect_fixed.cu"
FIXED_DENSE_LINES = {"detect": "fmcw_tpu/ops/frontend_pallas.py:958",
                     "split": "fmcw_tpu/ops/split_frontend.py:700"}
# 40a's option cases: o = 1 (8), 3 | o (24, 48, 96, 120, 192, 360, 2040),
# every inner transform m (8: 8 .. 2040, 16: 48, 32: 96, 64: 192, 1984).
FIXED_DENSE_SPREAD = (8, 24, 40, 48, 96, 120, 136, 192, 360, 1016, 1984,
                      2040)
# 40b's golden frames a config (the golden model takes ~0.5 / 1 / 5 s a
# frame at 96 / 192 / 1016 chirps, in worker processes).
FIXED_DENSE_GOLDEN = {96: 16, 192: 16, 1016: 4}


def fixed_dense_tie_checks(dev, nd: int) -> int:
    """Phase 40a's ties: the fixed slow-time kernel on exact round-half
    ties at a dense length, MTI bypassed, radius 0, 64 rows each:
    quarter-turn tie planes (bin 0, golden.reference.
    doppler_quarter_tie_planes), eighth-turn tie planes (bin nd/8,
    doppler_eighth_tie_planes; none at 8) and, where 3 divides o,
    twelfth-turn tie planes (bins j nd/12, doppler_twelfth_tie_planes):
    the kernel bit-equal to its twin (magnitudes and decisions); against
    the golden numpy model (np.fft.fft, mixed radix) values may differ at
    exact bins only (``exact_bin``; ROADMAP fault 5), detections within the
    window's Doppler halo of such a bin, and are counted.  Returns those
    values."""
    import numpy as np
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.golden import reference
    from fmcw_tpu_torch.ops import frontend as F, frontend_fixed as FX
    p = P.RadarParams(n_range=64, n_doppler=nd)
    planes = {"quarter": reference.doppler_quarter_tie_planes(nd, 1, 64, nd)}
    for seed in range(nd, nd + 8):
        try:
            planes["eighth"] = reference.doppler_eighth_tie_planes(seed, 1,
                                                                   64, nd)
            break
        except ValueError:          # too few chirps (8)
            continue
    if FX.map_split(nd)[0] % 3 == 0:
        planes["twelfth"] = reference.doppler_twelfth_tie_planes(nd, 1, 64,
                                                                 nd)
    off_all = 0
    reach = p.cfar.halo_doppler
    for name, (re, im) in planes.items():
        gold = [reference.process_rows_fixed(a.astype(np.int64),
                                             b.astype(np.int64), p,
                                             mti_bypass=True)
                for a, b in zip(re, im)]
        tre, tim = torch.as_tensor(re, device=dev), torch.as_tensor(
            im, device=dev)
        det, mag, _, ndet, _ = FX.slowtime_detect_fixed(
            tre, tim, True, 0, cfar=p.cfar, emit_mag=True)
        tmag, _ = FX.slowtime_mag_fixed_plain(tre, tim, True)
        tdet = F.detect_plain(tmag, p.cfar, 0, 0)[0]
        same_twin = bits_equal(mag, tmag) and bits_equal(det, tdet)
        mag, det = mag.cpu().numpy(), det.cpu().numpy()
        gmag = np.stack([g[0] for g in gold])
        gdet = np.stack([g[1] for g in gold])
        off = np.unique(np.argwhere(mag != gmag)[:, -1])
        near = np.zeros(nd, bool)
        for k in off:
            near[np.arange(k - reach, k + reach + 1) % nd] = True
        located = (all(exact_bin(int(k), nd) for k in off)
                   and not ((det != gdet).any((0, 1)) & ~near).any())
        n_off = int((mag != gmag).sum())
        log(f"fixed dense {name}-turn ties at 64x{nd}: {n_off} magnitudes "
            f"differ from the golden model (Doppler bins "
            f"{off.tolist()[:8]}), twin "
            f"{'bit-equal' if same_twin else 'DIFFERS'}")
        if not same_twin or not located:
            raise AssertionError(f"fixed dense {name}-turn ties at {nd} "
                                 f"differ")
        off_all += n_off
    return off_all


def fixed_dense_kernel_checks(dev, pgr: int):
    """Phase 40a: the fixed slow-time kernel at every dense length (237: 8,
    24 .. 2040) on 64 rows x 2 frames of bench.py's stimulus through the
    fixed range kernel (equal to its twin): the whole-frame entry per-cell
    (MTI on, notch 2, radius pgr) and block (the bypass, override 4,
    radius 1) through _fx_case (magnitudes and saturations equal to the
    twin, the decision bit for bit on the kernel's magnitudes); the split
    entry at sp 2 (OS, MTI on) bit-equal to the whole-frame launch's rows
    and the twin's decision.  At FIXED_DENSE_SPREAD also notch 3 with the
    passthrough transient and biased rounding, the 3-pulse block route,
    override 6 with radius 0, CA / GO / SO per-cell and block, the
    saturating x40 batch (MTI on and bypassed), the split entry at sp 2
    and 4 (OS and CA, MTI on and bypassed) and the tie planes
    (fixed_dense_tie_checks).  Returns ({entry: largest magnitude
    difference}, the golden model's differences at exact bins)."""
    import torch
    from fmcw_tpu_torch.ops import frontend_fixed as FX
    errs = {"detect": 0.0, "split": 0.0}
    tie_bins = 0
    for nd in dense_lengths():
        p = dense_params(nd, nr=DENSE_ROWS)
        iq = torch.as_tensor(make_batch(p, DENSE_FRAMES, seed=nd),
                             device=dev)
        re, im, sat_r = FX.range_fft_fixed(iq)
        want = FX.range_fft_fixed_plain(iq)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip((re, im, sat_r), want)):
            raise AssertionError(f"range_fft_fixed differs at {nd} chirps")
        spread = nd in FIXED_DENSE_SPREAD
        cases = [(p, False, 0, pgr, {}),
                 (dense_params(nd, scale_mode="block", nr=DENSE_ROWS), True,
                  4, 1, {})]
        if spread:
            cases += [
                (dense_params(nd, notch_mode=3, nr=DENSE_ROWS), False, 0,
                 pgr, dict(transient="passthrough", rounding="biased")),
                (dense_params(nd, "os", "block", 3, DENSE_ROWS), False, 0,
                 pgr, dict(transient="zero")),
                (p, False, 6, 0, {})]
            cases += [(dense_params(nd, v, mode, nr=DENSE_ROWS), False, 0,
                       pgr, {}) for v, mode in (
                          ("ca", "cell"), ("go", "block"), ("so", "cell"),
                          ("ca", "block"))]
        for q, bypass, so, radius, kw in cases:
            errs["detect"] = max(errs["detect"], _fx_case(
                "dense", re, im, q, bypass, so, radius, kw, quiet=True))
        if spread:
            hot = torch.as_tensor(hot_batch(p, 2), device=dev)
            hre, him, _ = FX.range_fft_fixed(hot)
            for bypass in (False, True):
                _fx_case("dense x40", hre, him, p, bypass, 0, pgr,
                         quiet=True)
            del hot, hre, him
            tie_bins += fixed_dense_tie_checks(dev, nd)
        errs["split"] = max(errs["split"], fixed_long_split_case(
            dev, re, im, nd, pgr, "fixed dense split",
            ("os", "ca") if spread else ("os",),
            SPLIT_SPS if spread else (2,),
            (False, True) if spread else (False,), quiet=True))
        log(f"fixed dense {DENSE_ROWS}x{nd} (o x m = "
            f"{' x '.join(map(str, FX.map_split(nd)))}): range kernel, "
            f"{len(cases)} whole-frame cases"
            f"{', x40, ties' if spread else ''} and the split entry "
            f"bit-equal to the twins")
        del re, im, want
    log(f"fixed dense lengths: {len(dense_lengths())} checked, errors "
        f"{errs}, golden differences at exact bins {tie_bins}")
    return errs, tie_bins


def fixed_dense_main_path(card: str, dev, pgr: int, pool):
    """Phase 40b, the slice's main path: batch 128 of bench.py's stimulus
    at 1024x96, 1024x192 and 1024x1016 through make_batch_processor(mode=
    "fixed", frontend="fused"), the entry config (per-cell), fast() (block)
    and CA: only range_fft_fixed and the fixed slow-time kernel's two
    launches, no plain stage (PlainStages); every output bit-equal to
    frontend="plain" on the card; the mag and det maps of the first
    FIXED_DENSE_GOLDEN frames held to the golden process_frame_fixed by
    worker processes (golden_frames_located on the Doppler axis: equal but
    at located exact bins; collected by the caller); frames/s beside fixed
    "auto" (the staged route), both without the maps.  Returns ({(config,
    nd): launches}, summary, golden futures)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch import kernels
    from fmcw_tpu_torch.models import pipeline as pl
    launches, summary, golden = {}, {}, []
    for nd in DENSE_NDS:
        for name, p in (("cell", P.RadarParams(n_doppler=nd)),
                        ("block", P.fast().replace(n_doppler=nd)),
                        ("ca", dense_params(nd, "ca"))):
            frames = make_batch(p, BATCH, seed=49)
            batch = torch.as_tensor(frames, device=dev)
            proc = pl.make_batch_processor(p, mode="fixed", frontend="fused",
                                           peak_group_radius=pgr, device=dev)
            kernels.reset_launch_counts()
            with PlainStages() as plain:
                out = proc(batch)
                torch.cuda.synchronize()
            counts = {k: v for k, v in kernels.launch_counts().items() if v}
            log(f"fixed dense main path {name} 1024x{nd}: launches "
                + ", ".join(f"{k}={v}" for k, v in counts.items())
                + f"; plain stages {plain.calls or 'none'}")
            if (proc.route != "fused" or plain.calls or counts != {
                    "range_fft_fixed": 1, "slowtime_detect_fixed": 2}):
                raise AssertionError(f"fixed dense main path {name} {nd}: "
                                     f"the fused route ran {counts}, "
                                     f"{plain.calls}")
            launches[("range_fft_fixed", nd)] = (
                launches.get(("range_fft_fixed", nd), 0)
                + counts["range_fft_fixed"])
            launches[(name, nd)] = counts["slowtime_detect_fixed"]
            ref = pl.make_batch_processor(p, mode="fixed", frontend="plain",
                                          peak_group_radius=pgr,
                                          device=dev)(batch)
            diff = [k for k in ref if not torch.equal(ref[k], out[k])]
            if diff or out.keys() != ref.keys() or int(
                    out["n_dets"].min()) <= 0:
                raise AssertionError(f"fixed dense main path {name} {nd}: "
                                     f"fused and plain differ in {diff}")
            del ref
            n_gold = FIXED_DENSE_GOLDEN[nd]
            mags = out["mag_map"][:n_gold].cpu().numpy()
            dets = out["det_map"][:n_gold].cpu().numpy()
            for i in range(0, n_gold, 4):
                golden.append(((name, nd), pool.submit(
                    golden_frames_located, (frames[i:i + 4], mags[i:i + 4],
                                            dets[i:i + 4], p, pgr,
                                            "doppler"))))
            del out, mags, dets
            lean = {fe: pl.make_batch_processor(
                p, mode="fixed", frontend=fe, peak_group_radius=pgr,
                include_maps=False, device=dev) for fe in ("fused", "auto")}
            fps = BATCH * 1e3 / cuda_ms(lambda: lean["fused"](batch), 10)
            fps_staged = BATCH * 1e3 / cuda_ms(lambda: lean["auto"](batch), 2,
                                               1)
            summary[f"{name}@{nd}"] = {"frames_per_s": fps,
                                       "staged_frames_per_s": fps_staged}
            log(f"fixed dense main path {name} 1024x{nd}: fused bit-equal "
                f"to plain in every output; {fps:.1f} frames/s, staged "
                f"{fps_staged:.1f} frames/s ({fps / fps_staged:.2f}x) at "
                f"batch {BATCH} ({card})")
            del batch, lean
            torch.cuda.empty_cache()
    return launches, summary, golden


def fixed_dense_timings(card: str, dev, pgr: int, errs, launches):
    """Phase 40d: graph-replay times at 1024x96 and 1024x192 (batch 128)
    and 1024x1016 (batch 16): the fixed slow-time kernel's whole-frame
    entry per-cell, block (fast()) and CA, and its split entry on the sp 4
    range shard (rows 256..512 with their halo rows), each beside its
    bound (bound_slowtime_fixed, bound_slowtime_fixed_split: an nd-point
    FP64 FFT a row, whatever the kernel runs), its plain twin and
    torch.fft.fft (complex128) of its planes along Doppler, the
    transform's share (no PyTorch call computes an entry).  An entry joins
    the kernels line only at a length where 40b-c counted its launches on
    a path.  Returns (kernel rows, summary)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.ops import frontend_fixed as FX
    from fmcw_tpu_torch.ops import split_frontend as SF
    rows, summary = [], {}
    for nd, batch in ((96, BATCH), (192, BATCH), (1016, 16)):
        iq = torch.as_tensor(make_batch(P.RadarParams(n_doppler=nd), batch,
                                        seed=51), device=dev)
        re, im, _ = FX.range_fft_fixed(iq)
        del iq
        z = torch.complex(re.double(), im.double())
        fft = graph_ms(lambda: torch.fft.fft(z, dim=-1))
        del z
        entries = []
        for name, p in (("cell", P.RadarParams(n_doppler=nd)),
                        ("block", P.fast().replace(n_doppler=nd)),
                        ("ca", dense_params(nd, "ca"))):
            kw = dict(cfar=p.cfar, peak_group_radius=pgr)
            entries.append((
                f"slowtime_detect_fixed[dense,{name},{nd}]",
                lambda kw=kw: FX.slowtime_detect_fixed(re, im, False, 0,
                                                       **kw),
                lambda kw=kw: FX.slowtime_detect_fixed_plain(re, im, False,
                                                             0, **kw),
                bound_slowtime_fixed(batch, DENSE_NR, nd, p.cfar),
                (name, nd), errs["detect"], FIXED_DENSE_LINES["detect"],
                fft))
        cfar = P.RadarParams().cfar
        sp, s = 4, 1
        nrl, h = DENSE_NR // sp, cfar.halo_range + pgr
        ext = torch.arange(s * nrl - h, (s + 1) * nrl + h,
                           device=dev) % DENSE_NR
        lo, hi, core = ext[:h], ext[h + nrl:], ext[h:h + nrl]
        args = (re[:, core].contiguous(), im[:, core].contiguous(),
                (re[:, lo].contiguous(), im[:, lo].contiguous()),
                (re[:, hi].contiguous(), im[:, hi].contiguous()), False, 0,
                s * nrl)
        skw = dict(cfar=cfar, n_range_total=DENSE_NR, peak_group_radius=pgr)
        z = torch.complex(re[:, ext].double(), im[:, ext].double())
        fft_shard = graph_ms(lambda: torch.fft.fft(z, dim=-1))
        del z
        entries.append((
            f"slowtime_detect_fixed_split[dense,{nd},sp4]",
            lambda: SF.slowtime_detect_fixed_split(*args, **skw),
            lambda: SF.slowtime_detect_fixed_split_plain(*args, **skw),
            bound_slowtime_fixed_split(batch, nrl, nd, h, cfar),
            ("slowtime_detect_fixed_split", nd), errs["split"],
            FIXED_DENSE_LINES["split"], fft_shard))
        for name, call, plain, (bound, by), key, err, line, lib in entries:
            n = launches.get(key)
            ms = graph_ms(call, 10 if nd > 512 else 20)
            plain_ms = cuda_ms(plain, 2, 1)
            log(f"{name} batch {batch}: {ms:.4f} ms (graph), plain "
                f"{plain_ms:.4f} ms, torch.fft.fft complex128 of its planes "
                f"{lib:.4f} ms, bound {bound:.4f} ms ({by}), "
                f"{'not on a path' if n is None else f'{n} launches'} "
                f"({card})")
            summary[f"{name}x{batch}"] = {
                "ms": ms, "plain_ms": plain_ms, "fft_ms": lib,
                "bound_ms": bound, "bound_by": by}
            if n is None:
                continue
            rows.append(dict(name=name, route="cuda", source=FIXED_DENSE_SRC,
                             replaces=line, launches=n, max_abs_err=err,
                             ms=ms, plain_ms=plain_ms, bound_ms=bound,
                             bound_by=by, library_ms=None))
        del re, im, args
        torch.cuda.empty_cache()
    return rows, summary


def fixed_dense_phase(card: str, dev, pgr: int):
    """Phase 40: the fixed slow-time kernel's dense operator (40a every
    dense length against the twins and the tie planes; 40b the main path
    at 1024x96, 1024x192 and 1024x1016; 40c make_sharded_processor(mode=
    "fixed", frontend="fused") on a LocalMesh at sp 2 and 4 at 1024x96 (OS
    and CA) and 1024x192 (OS), equal to the single card
    (fixed_long_local_mesh; 1016 / sp is no multiple of 8, so no mesh
    takes 1016); 40d the entries' times); the main path first, whose
    golden checks run in worker processes during the rest.  Returns
    (kernel rows, summary)."""
    import concurrent.futures as cf
    import multiprocessing as mp
    import os
    import torch
    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    workers = max(1, min(7, (os.cpu_count() or 2) - 1))
    with cf.ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        launches, summary, golden = fixed_dense_main_path(card, dev, pgr,
                                                          pool)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        errs, tie_bins = fixed_dense_kernel_checks(dev, pgr)
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        for nd, configs in ((96, (("os", dense_params(96)),
                                  ("ca", dense_params(96, "ca")))),
                            (192, (("os", dense_params(192)),))):
            mesh = fixed_long_local_mesh(card, dev, pgr, configs,
                                         tag=f"fixed dense 1024x{nd}")
            launches[("slowtime_detect_fixed_split", nd)] = mesh[
                "slowtime_detect_fixed_split"]
        t3 = time.perf_counter()
        rows, timings = fixed_dense_timings(card, dev, pgr, errs, launches)
        t4 = time.perf_counter()
        done = {}
        for key, fut in golden:
            ok, n, off = fut.result()
            acc = done.setdefault(key, [True, 0, 0, 0])
            acc[0] &= ok
            acc[1] += n
            acc[2] += off
            acc[3] += 4
        for (name, nd), (ok, n, off, frames) in done.items():
            log(f"fixed dense main path {name} 1024x{nd}: mag and det maps "
                f"vs the golden process_frame_fixed on {frames} frames: "
                f"{'equal' if ok else 'DIFFER'} but at located exact bins "
                f"({off} magnitude columns there; {n} detections)")
            if not ok:
                raise AssertionError(f"fixed dense main path {name} {nd} "
                                     f"differs from the golden model")
    t5 = time.perf_counter()
    log(f"fixed dense phase: 40b {t1 - t0:.1f} s, 40a {t2 - t1:.1f} s, 40c "
        f"{t3 - t2:.1f} s, 40d {t4 - t3:.1f} s, golden wait "
        f"{t5 - t4:.1f} s")
    return rows, {"main_path": summary, "timings": timings,
                  "golden_tie_differences": tie_bins,
                  "golden_frame_columns_at_exact_bins": {
                      f"{k[0]}@{k[1]}": v[2] for k, v in done.items()},
                  "launches": {f"{k[0]}@{k[1]}": v
                               for k, v in launches.items()}}


# ---------------------------------------------------------------------------
# n_doppler off a multiple of 8 (phase 41)
# ---------------------------------------------------------------------------

ODD_NR = 1024
ODD_NDS = (100, 250, 1021, 2047)        # the slice's full-width lengths
ODD_SWEEP_ROWS, ODD_SWEEP_FRAMES = 16, 2        # 41b's small maps
# 41b's lengths held to the plain twin too (its folded matrices are built
# on the host, O(nd^3)): every length to 256 (every m in 1, 2, 4), every
# prime, a few m = 2 and 4 lengths above, and 2047.
ODD_TWIN_MORE = (500, 502, 1020, 1022, 1500, 1502, 2044, 2046)
ODD_SRC = {"range": "fmcw_tpu_torch/csrc/range_fft.cu",
           "slowtime": "fmcw_tpu_torch/csrc/slowtime_detect.cu"}
ODD_LINES = {"range": "fmcw_tpu/ops/frontend_pallas.py:623",
             "shard": "fmcw_tpu/ops/split_frontend.py:73",
             "detect": "fmcw_tpu/ops/frontend_pallas.py:719",
             "split": "fmcw_tpu/ops/split_frontend.py:562"}
ODD_MTI = ((2, "zero", False), (3, "passthrough", False), (3, "zero", False),
           (2, "zero", True))


def odd_lengths():
    """Kernel B's lengths off a multiple of 8 (ops/frontend.unaligned_cpi)
    that the entry window admits (halo_doppler 5 below nd): 6, 7, 9 ..
    2047, 1787 of them."""
    from fmcw_tpu_torch.ops import frontend as F
    return tuple(nd for nd in range(6, 2048) if F.unaligned_cpi(nd))


def odd_batch(nd: int) -> int:
    return BATCH if nd < 512 else ARRAY_BATCH


def odd_twin_lengths(lengths):
    """41b's lengths held to the plain twin (``ODD_TWIN_MORE``)."""
    def prime(n):
        return n > 1 and all(n % q for q in range(2, int(n ** 0.5) + 1))
    return tuple(nd for nd in lengths if nd <= 256 or prime(nd)
                 or nd in ODD_TWIN_MORE or nd == lengths[-1])


def chain64_mag(re, im, notch: int, transient: str, bypass: bool):
    """The slow-time chain of range-major planes in float64 on the card
    (pulse canceller, window, torch.fft.fft complex128) and the kernel's
    magnitude formula (max + 0.375 min): the reference of the 41b lengths
    that are not held to the twin."""
    import torch
    from fmcw_tpu_torch.ops.window import hamming_float
    nd = re.shape[-1]
    x = torch.complex(re.double(), im.double())
    if not bypass:
        p1 = torch.nn.functional.pad(x[..., :-1], (1, 0))
        p2 = torch.nn.functional.pad(x[..., :-2], (2, 0))
        x = x - p1 if notch == 2 else x - 2 * p1 + p2
        if transient == "zero":
            x[..., :notch - 1] = 0
    w = torch.as_tensor(hamming_float(nd), dtype=torch.float64,
                        device=re.device)
    z = torch.fft.fft(x * w, dim=-1)
    a, b = z.real.abs(), z.imag.abs()
    return torch.maximum(a, b) + 0.375 * torch.minimum(a, b)


def odd_kernel_a_checks(dev):
    """Phase 41a: kernel A at lengths off a multiple of 8, both entries
    (int16 I/Q, float32 planes) within TOL of the peak of their twins:
    1024x100 at batch 128 (13 groups a frame, the last of 4 chirps),
    1024x250 at batch 3 (the last of 2) and
    1024x2047 at batch 1; the chirp shards of 100 / 4 (25 chirps) and 1016
    / 4 (254) through split_frontend.range_frontend (batch 16), each
    bit-equal to the whole frame's columns and within TOL of the twin.
    Returns {entry: largest absolute error}."""
    import numpy as np
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.ops import frontend as F
    from fmcw_tpu_torch.ops import split_frontend as SF
    errs = {"range_fft": 0.0, "range_fft_float": 0.0, "range_frontend": 0.0}
    rng = np.random.default_rng(41)

    def close(got, want, what):
        torch.cuda.synchronize()
        peak = float(torch.maximum(want[0].abs().max(), want[1].abs().max()))
        err = float(torch.maximum((got[0] - want[0]).abs().max(),
                                  (got[1] - want[1]).abs().max()))
        if not err <= TOL * peak:
            raise AssertionError(f"{what}: err {err / peak:.3g} of peak")
        return err, err / peak

    for nd, batch in ((100, BATCH), (250, 3), (2047, 1)):
        iq = torch.as_tensor(make_batch(P.RadarParams(n_doppler=nd), batch,
                                        seed=nd), device=dev)
        planes = torch.as_tensor(rng.standard_normal((2, batch, nd, ODD_NR))
                                 * 1e3, dtype=torch.float32, device=dev)
        e1, r1 = close(F.range_fft(iq), F.range_fft_plain(iq),
                       f"range_fft 1024x{nd}")
        e2, r2 = close(F.range_fft_float(*planes),
                       F.range_fft_float_plain(*planes),
                       f"range_fft_float 1024x{nd}")
        errs["range_fft"] = max(errs["range_fft"], e1)
        errs["range_fft_float"] = max(errs["range_fft_float"], e2)
        log(f"kernel A 1024x{nd} batch {batch}: int16 err {r1:.3g}, float "
            f"err {r2:.3g} of peak (tol {TOL})")
    for nd in (100, 1016):
        iq = torch.as_tensor(make_batch(P.RadarParams(n_doppler=nd),
                                        ARRAY_BATCH, seed=nd), device=dev)
        whole = F.range_fft(iq)
        ndl = nd // 4
        for s in range(4):
            shard = iq[:, s * ndl:(s + 1) * ndl].contiguous()
            got = SF.range_frontend(shard)
            cols = slice(s * ndl, (s + 1) * ndl)
            if not (bits_equal(got[0], whole[0][..., cols])
                    and bits_equal(got[1], whole[1][..., cols])):
                raise AssertionError(f"range_frontend 1024x{nd} shard {s} "
                                     f"differs from the whole frame")
            e, _ = close(got, F.range_fft_plain(shard),
                         f"range_frontend 1024x{nd} shard {s}")
            errs["range_frontend"] = max(errs["range_frontend"], e)
        log(f"kernel A chirp shards of 1024x{nd} (sp 4, {ndl} chirps, "
            f"batch {ARRAY_BATCH}): bit-equal to the whole frame, within "
            f"TOL of the twin")
    return errs


def odd_sweep(dev, pgr: int):
    """Phase 41b: at every length off a multiple of 8 (6 .. 2047, 1787) on
    a 16-row map of 2 frames (kernel A's last group of 8 chirps a frame
    partial; the twin within TOL), kernel B's detect entry and its map
    kernel's entry (slowtime_mag): magnitudes within TOL of the peak of the
    float64 chain on the card (chain64_mag) and, at odd_twin_lengths, of
    the plain twin; the decision, row maxima and counts bit for bit the
    twin's on the kernel's own magnitudes; the magnitude-only entry
    bit-equal to the detect entry's magnitudes.  The MTI settings, the
    CFAR variants (OS, CA, GO, SO) and radii 0-2 rotate across the lengths.
    Returns {check: largest absolute magnitude error}."""
    from concurrent.futures import ThreadPoolExecutor
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.ops import fft as TF
    from fmcw_tpu_torch.ops import frontend as F
    lengths = odd_lengths()
    twins = odd_twin_lengths(lengths)
    errs = {"detect": 0.0, "mag": 0.0, "chain64": 0.0,
            "sweep_range_fft": 0.0}
    rel = {"twin": 0.0, "chain64": 0.0}
    plan = [(nd, *ODD_MTI[i % len(ODD_MTI)], ("os", "ca", "go", "so")[
        i // 4 % 4], i % 3) for i, nd in enumerate(lengths)]
    # The twin's folded matrices (the twin's cache holds 16), built ahead
    # on worker threads, 8 lengths at a time.
    pool = ThreadPoolExecutor(4)
    queue = [(nd, notch, transient) for nd, notch, transient, *_ in plan
             if nd in twins]
    ahead = {key: pool.submit(TF.doppler_matrices, *key)
             for key in queue[:8]}
    queue = queue[8:]
    for nd, notch, transient, bypass, variant, radius in plan:
        p = P.RadarParams(n_range=ODD_SWEEP_ROWS, n_doppler=nd,
                          notch_mode=notch,
                          cfar=P.CfarParams(variant=variant))
        iq = torch.as_tensor(make_batch(p, ODD_SWEEP_FRAMES, seed=nd),
                             device=dev)
        re, im = F.range_fft(iq)
        pre, pim = F.range_fft_plain(iq)
        kw = dict(notch_mode=notch, transient=transient)
        det, mag, rmax, ndet, nf = F.slowtime_detect(
            re, im, bypass, 0, cfar=p.cfar, peak_group_radius=radius,
            emit_mag=True, **kw)
        mag2, nf2 = F.slowtime_mag(re, im, bypass, **kw)
        d2, r2, n2, f2 = F.detect_plain(mag, p.cfar, 0, radius)
        ref = chain64_mag(re, im, notch, transient, bypass)
        torch.cuda.synchronize()
        peak_a = float(torch.maximum(pre.abs().max(), pim.abs().max()))
        err_a = float(torch.maximum((re - pre).abs().max(),
                                    (im - pim).abs().max()))
        peak = float(ref.max())
        err64 = float((mag.double() - ref).abs().max())
        ok = (err_a <= TOL * peak_a and err64 <= TOL * peak
              and bits_equal(det, d2) and bits_equal(rmax, r2)
              and torch.equal(ndet, n2) and torch.equal(nf, f2)
              and bits_equal(mag, mag2) and torch.equal(nf, nf2))
        errs["sweep_range_fft"] = max(errs["sweep_range_fft"], err_a)
        errs["chain64"] = max(errs["chain64"], err64)
        rel["chain64"] = max(rel["chain64"], err64 / peak)
        if (nd, notch, transient) in ahead:
            ahead.pop((nd, notch, transient)).result()
            if queue:
                key = queue.pop(0)
                ahead[key] = pool.submit(TF.doppler_matrices, *key)
            pmag = F.slowtime_mag_plain(re, im, bypass, **kw)
            torch.cuda.synchronize()
            err = float((mag - pmag).abs().max())
            ppeak = float(pmag.abs().max())
            ok &= err <= TOL * ppeak
            errs["detect"] = max(errs["detect"], err)
            errs["mag"] = max(errs["mag"], err)
            rel["twin"] = max(rel["twin"], err / ppeak)
        if not ok:
            raise AssertionError(
                f"kernel B at 16x{nd} {variant} notch {notch} {transient} "
                f"bypass={bypass} pgr={radius}: A err {err_a / peak_a:.3g}, "
                f"mag err {err64 / peak:.3g} of the float64 chain's peak, "
                f"decision {'same' if bits_equal(det, d2) else 'DIFFERS'}")
    pool.shutdown(cancel_futures=True)
    log(f"odd lengths: {len(lengths)} checked (6 .. 2047; {len(twins)} "
        f"also against the plain twin): magnitudes within "
        f"{rel['chain64']:.3g} of the float64 chain's peak, "
        f"{rel['twin']:.3g} of the twin's; decisions bit-identical")
    return errs


def odd_main_path(card: str, dev, pgr: int, errs):
    """Phase 41c, the slice's main path: bench.py's stimulus at 1024x100
    and 1024x250 (batch 128), 1024x1021 and 1024x2047 (batch 16) through
    make_batch_processor(include_maps=False): float "auto" per-cell and
    "fused" with CA, each the fused route (before: staged, "fused"
    raised); only kernel A and kernel B's two launches and the top-K run;
    kernel B on the whole batch through _b_case (magnitudes within TOL,
    decisions bit for bit); frame 0 through the margin gate against the
    plain route's exact taps; frames/s beside the staged route.  Returns
    ({(kernel, nd): launches}, summary)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch import kernels, parity
    from fmcw_tpu_torch.golden import reference
    from fmcw_tpu_torch.models import pipeline as pl
    from fmcw_tpu_torch.ops import frontend as F
    launches, summary = {}, {}
    for nd in ODD_NDS:
        B = odd_batch(nd)
        for name, p, fe in (
                ("cell", P.RadarParams(n_doppler=nd), "auto"),
                ("ca", P.RadarParams(n_doppler=nd, cfar=P.CfarParams(
                    variant="ca")), "fused")):
            proc = pl.make_batch_processor(p, frontend=fe,
                                           peak_group_radius=pgr,
                                           include_maps=False, device=dev)
            if proc.route != "fused":
                raise AssertionError(f"1024x{nd} {fe} is {proc.route}")
            batch = torch.as_tensor(make_batch(p, B), device=dev)
            kernels.reset_launch_counts()
            out = proc(batch)
            torch.cuda.synchronize()
            counts = {k: v for k, v in kernels.launch_counts().items() if v}
            log(f"odd main path {name} ({fe}) 1024x{nd}: launches "
                + ", ".join(f"{k}={v}" for k, v in counts.items()))
            if counts != {"range_fft": 1, "slowtime_detect": 2}:
                raise AssertionError(f"odd main path {name} {nd}: launches "
                                     f"{counts}")
            launches[("range_fft", nd)] = launches.get(
                ("range_fft", nd), 0) + 1
            launches[(name, nd)] = counts["slowtime_detect"]
            re, im = F.range_fft(batch)
            errs["detect"] = max(errs["detect"], _b_case(
                f"main path batch {B}", re, im, p, False, 0, pgr))
            del re, im
            for key in ("range_bin", "doppler_bin", "mag", "valid"):
                if tuple(out[key].shape) != (B, p.tracker.max_dets):
                    raise AssertionError(f"{key} shape "
                                         f"{tuple(out[key].shape)}")
            if not bool(torch.isfinite(out["mag"]).all()) or int(
                    out["nonfinite_count"].sum()) != 0:
                raise AssertionError("non-finite magnitudes")
            ref = pl.make_processor(p, peak_group_radius=pgr,
                                    frontend="plain", include_debug=True,
                                    cfar_rank_bits=None, device=dev)(
                                        batch[0])
            ok, report = parity.margin_gate(
                parity.detection_set(out, 0), parity.detection_set(ref),
                ref["mag_map"].cpu().numpy(),
                ref["threshold_map"].cpu().numpy(),
                ref["scale_map"].cpu().numpy(), radius=pgr,
                capacity=p.tracker.max_dets,
                targets=reference.golden_targets(p))
            log(f"odd main path {name} 1024x{nd} frame 0 vs plain path: "
                f"{report}")
            if not ok:
                raise AssertionError(f"odd main path {name} {nd}: margin "
                                     f"gate failed")
            del ref, out
            staged = pl.make_batch_processor(p, frontend="staged",
                                             peak_group_radius=pgr,
                                             include_maps=False, device=dev)
            fps = B * 1e3 / cuda_ms(lambda: proc(batch), 5, 2)
            fps_staged = B * 1e3 / cuda_ms(lambda: staged(batch), 3, 1)
            summary[f"{name}@{nd}"] = {"frames_per_s": fps,
                                       "staged_frames_per_s": fps_staged,
                                       "batch": B}
            log(f"odd main path {name} 1024x{nd}: {fps:.1f} frames/s "
                f"(fused), staged route {fps_staged:.1f} frames/s at batch "
                f"{B} ({card})")
            del batch
            torch.cuda.empty_cache()
    return launches, summary


def odd_fixed_refuses(dev):
    """Phase 41c: fixed "fused" at 1024x100 raises NotImplementedError when
    the processor is built, on one card and on a LocalMesh at sp 2, before
    any launch (the fixed kernels' multiple of 8: the next slice); fixed
    "auto" stays the staged route."""
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch import kernels
    from fmcw_tpu_torch.models import pipeline as pl
    from fmcw_tpu_torch.parallel import mesh as M, sharded as SH
    p = P.RadarParams(n_doppler=100)
    kernels.reset_launch_counts()
    for what, build in (
            ("one card", lambda: pl.make_batch_processor(
                p, mode="fixed", frontend="fused", device=dev)),
            ("LocalMesh sp 2", lambda: SH.make_sharded_processor(
                M.LocalMesh(1, 2, dev), p, mode="fixed", frontend="fused"))):
        try:
            build()
        except NotImplementedError as e:
            log(f"fixed fused 1024x100 on {what}: refused at build ({e})")
        else:
            raise AssertionError(f"fixed fused 1024x100 built on {what}")
    if any(kernels.launch_counts().values()):
        raise AssertionError("a refused fixed build launched a kernel")
    if pl.make_batch_processor(p, mode="fixed", device=dev).route != "staged":
        raise AssertionError("fixed auto at 1024x100 is not staged")


def odd_timings(card: str, dev, pgr: int, errs, launches):
    """Phase 41d: graph-replay times at 1024x100, 1024x250 (batch 128),
    1024x1021 and 1024x2047 (batch 16): kernel A (int16; float at 100), its
    chirp shard at 100 / 4 and 1016 / 4, kernel B's detect entry per-cell
    and CA (the map kernel, then the decide kernel), its magnitude-only
    entry (the map kernel alone; the decide kernel's share is the
    difference, logged) and its split entry on the sp 4 range shard at
    1024x100 and 1024x1016, each beside its bound (an nd-point FFT a row,
    whatever the kernel runs), its plain twin and torch.fft.fft of its
    planes (kernel A's library_ms; beside kernel B's entries logged only:
    no PyTorch call computes them).  An entry joins the kernels line where
    41c counted its launches on a path.  Returns (kernel rows, summary)."""
    import torch
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch.ops import frontend as F
    from fmcw_tpu_torch.ops import split_frontend as SF
    from fmcw_tpu_torch.ops.window import hamming_float
    rows, summary = [], {}
    win = torch.as_tensor(hamming_float(ODD_NR), device=dev)

    def add(name, src, line, key, err, call, plain, bound, lib, lib_row):
        n = launches.get(key)
        ms = graph_ms(call, 5 if "1021" in name or "2047" in name else 10)
        plain_ms = cuda_ms(plain, 1, 1)
        b, by = bound
        log(f"{name}: {ms:.4f} ms (graph), plain {plain_ms:.4f} ms, "
            f"torch.fft.fft {lib:.4f} ms, bound {b:.4f} ms ({by}), "
            f"{'not on a path' if n is None else f'{n} launches'} ({card})")
        summary[name] = {"ms": ms, "plain_ms": plain_ms, "fft_ms": lib,
                         "bound_ms": b, "bound_by": by}
        if n is not None:
            rows.append(dict(name=name, route="cuda", source=src,
                             replaces=line, launches=n, max_abs_err=err,
                             ms=ms, plain_ms=plain_ms, bound_ms=b,
                             bound_by=by,
                             library_ms=lib if lib_row else None))
        return ms

    for nd in ODD_NDS + (1016,):
        B = odd_batch(nd)
        p = P.RadarParams(n_doppler=nd)
        iq = torch.as_tensor(make_batch(p, B, seed=41), device=dev)
        zw = torch.complex(iq[..., 0].float() * win, iq[..., 1].float() * win)
        lib_a = graph_ms(lambda: torch.fft.fft(zw, dim=-1))
        del zw
        if nd != 1016:
            add(f"range_fft[odd,{nd}]", ODD_SRC["range"], ODD_LINES["range"],
                ("range_fft", nd), errs["range_fft"],
                lambda: F.range_fft(iq), lambda: F.range_fft_plain(iq),
                bound_range_fft(B, nd, ODD_NR), lib_a, True)
        if nd in (100, 1016):
            ndl = nd // 4
            shard = iq[:, ndl:2 * ndl].contiguous()
            zs = torch.complex(shard[..., 0].float() * win,
                               shard[..., 1].float() * win)
            lib_s = graph_ms(lambda: torch.fft.fft(zs, dim=-1))
            add(f"range_frontend[odd,{nd},sp4]", ODD_SRC["range"],
                ODD_LINES["shard"], ("range_frontend", nd),
                errs["range_frontend"], lambda: SF.range_frontend(shard),
                lambda: F.range_fft_plain(shard),
                bound_range_fft(B, ndl, ODD_NR), lib_s, True)
            del zs
        re, im = F.range_fft(iq)
        del iq
        if nd == 100:
            beams = (re.transpose(1, 2).contiguous(),
                     im.transpose(1, 2).contiguous())
            add(f"range_fft_float[odd,{nd}]", ODD_SRC["range"],
                ODD_LINES["range"], ("range_fft_float", nd),
                errs["range_fft_float"], lambda: F.range_fft_float(*beams),
                lambda: F.range_fft_float_plain(*beams),
                bound_range_fft_float(B, nd, ODD_NR), lib_a, True)
            del beams
        z = torch.complex(re, im)
        fft = graph_ms(lambda: torch.fft.fft(z, dim=-1))
        del z
        if nd != 1016:
            ms = {}
            for name, q in (("cell", p), ("ca", p.replace(
                    cfar=P.CfarParams(variant="ca")))):
                kw = dict(cfar=q.cfar, peak_group_radius=pgr)
                ms[name] = add(
                    f"slowtime_detect[odd,{name},{nd}]", ODD_SRC["slowtime"],
                    ODD_LINES["detect"], (name, nd), errs["detect"],
                    lambda kw=kw: F.slowtime_detect(re, im, False, 0, **kw),
                    lambda kw=kw: F.slowtime_detect_plain(re, im, False, 0,
                                                          **kw),
                    bound_slowtime(B, ODD_NR, nd, q.cfar), fft, False)
            ms["mag"] = add(
                f"slowtime_mag[odd,{nd}]", ODD_SRC["slowtime"],
                ODD_LINES["detect"], ("slowtime_mag", nd), errs["mag"],
                lambda: F.slowtime_mag(re, im),
                lambda: F.slowtime_mag_plain(re, im, False),
                bound_slowtime_mag(B, ODD_NR, nd), fft, False)
            log(f"1024x{nd} batch {B}: the map kernel {ms['mag']:.4f} ms, "
                f"the decide kernel per-cell {ms['cell'] - ms['mag']:.4f} / "
                f"CA {ms['ca'] - ms['mag']:.4f} ms (the detect entry's "
                f"time less the map's) ({card})")
            summary[f"decide[cell,{nd}]"] = ms["cell"] - ms["mag"]
            summary[f"decide[ca,{nd}]"] = ms["ca"] - ms["mag"]
        if nd in (100, 1016):
            cfar = p.cfar
            sp, s = 4, 1
            nrl, h = ODD_NR // sp, cfar.halo_range + pgr
            ext = torch.arange(s * nrl - h, (s + 1) * nrl + h,
                               device=dev) % ODD_NR
            lo, hi, core = ext[:h], ext[h + nrl:], ext[h:h + nrl]
            args = (re[:, core].contiguous(), im[:, core].contiguous(),
                    (re[:, lo].contiguous(), im[:, lo].contiguous()),
                    (re[:, hi].contiguous(), im[:, hi].contiguous()), False,
                    0, s * nrl)
            skw = dict(cfar=cfar, n_range_total=ODD_NR, peak_group_radius=pgr)
            zsh = torch.complex(re[:, ext], im[:, ext])
            fft_shard = graph_ms(lambda: torch.fft.fft(zsh, dim=-1))
            del zsh
            add(f"slowtime_detect_split[odd,{nd},sp4]", ODD_SRC["slowtime"],
                ODD_LINES["split"], ("slowtime_detect_split", nd),
                errs["detect"], lambda: SF.slowtime_detect_split(*args, **skw),
                lambda: SF.slowtime_detect_split_plain(*args, **skw),
                bound_slowtime_split(B, nrl, nd, h, cfar), fft_shard, False)
            del args
        del re, im
        torch.cuda.empty_cache()
    return rows, summary


def odd_phase(card: str, dev, pgr: int):
    """Phase 41: n_doppler off a multiple of 8 in the float kernels (41a
    kernel A's partial groups and its chirp shards; 41b kernel
    B's map and detect entries at every such length below 2048; 41c the
    main path at 1024x100, 250, 1021 and 2047 (float auto per-cell,
    "fused" CA), the debug taps, reflect, hw-compat float and the array
    model at 1024x100, LocalMesh sp 2 and 4 at 1024x100 (per-cell, debug)
    and 1024x1016 (per-cell, 254 chirps a shard at sp 4), fixed "fused"
    refused at build; 41d the entries' times).  Returns (kernel rows,
    summary)."""
    import torch
    import fmcw_tpu_torch as P
    t0 = time.perf_counter()
    errs = odd_kernel_a_checks(dev)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    errs.update(odd_sweep(dev, pgr))
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    launches, summary = odd_main_path(card, dev, pgr, errs)
    p100 = P.RadarParams(n_doppler=100)
    other = long_other_routes(card, dev, pgr, p100, tag="odd 1024x100")
    launches[("slowtime_mag", 100)] = other["slowtime_mag"]
    launches[("range_fft_float", 100)] = other["range_fft_float"]
    for nd, configs in (
            (100, (("cell", p100, {}, "slowtime_detect_split"),
                   ("debug", p100, dict(include_debug=True),
                    "slowtime_mag"))),
            (1016, (("cell", P.RadarParams(n_doppler=1016), {},
                     "slowtime_detect_split"),))):
        mesh = long_local_mesh(card, dev, pgr, configs,
                               tag=f"odd 1024x{nd}")
        launches[("slowtime_detect_split", nd)] = mesh[
            "slowtime_detect_split"]
        launches[("range_frontend", nd)] = mesh["range_frontend"]
    odd_fixed_refuses(dev)
    t3 = time.perf_counter()
    rows, timings = odd_timings(card, dev, pgr, errs, launches)
    log(f"odd phase: 41a {t1 - t0:.1f} s, 41b {t2 - t1:.1f} s, 41c "
        f"{t3 - t2:.1f} s, 41d {time.perf_counter() - t3:.1f} s")
    return rows, {"main_path": summary, "timings": timings,
                  "errors": errs,
                  "launches": {f"{k[0]}@{k[1]}": v
                               for k, v in launches.items()}}


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
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for flag, phase, summary_key in (
            ("--wide-cfar-only", wide_phase, "wide_cfar"),
            ("--fixed-dense-only", fixed_dense_phase, "fixed_dense"),
            ("--odd-doppler-only", odd_phase, "odd_doppler")):
        if flag in sys.argv[1:]:
            # Phase 39 (the standalone CFAR kernels on wide maps), 40 (the
            # fixed dense operator) or 41 (n_doppler off a multiple of 8)
            # alone.
            t0 = time.perf_counter()
            rows, summary = phase(card, dev, pgr)
            log(json.dumps({"kernels": [{k: r[k] for k in keys}
                                        for r in rows],
                            summary_key: summary, "card": card}))
            log(f"chip_smoke {flag}: passed in "
                f"{time.perf_counter() - t0:.1f} s")
            return 0
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

    # 28. The CA/GO/SO variants: kernel B's mean epilogue and its split
    #     entry against the twins, the routes, Pd/Pfa on the card, timings.
    log(f"phases 1-27: {time.perf_counter() - t_start:.1f} s")
    variant_rows, variant_summary = variant_phase(card, dev, pgr)

    # 29. Reflect edges: the reflect entry of cfar_detect against its twin,
    #     the reflect routes and a LocalMesh, timings.
    log(f"phases 1-28: {time.perf_counter() - t_start:.1f} s")
    reflect_rows, reflect_summary = reflect_phase(card, dev, pgr)

    # 30. Reflect edges in the rank-select CFAR (TPU row 9): its reflect
    #     entry against its twin, the debug routes, a LocalMesh, timings.
    log(f"phases 1-29: {time.perf_counter() - t_start:.1f} s")
    rank_reflect_rows, rank_reflect_summary = rank_reflect_phase(card, dev,
                                                                 pgr)

    # 31. Reflect edges in the 3D CFAR (TPU row 10): its reflect entry
    #     against its twin, the array model, a LocalMesh, timings.
    log(f"phases 1-30: {time.perf_counter() - t_start:.1f} s")
    cfar3d_reflect_rows, cfar3d_reflect_summary = cfar3d_reflect_phase(
        card, dev, pgr)

    # 32. Long CPIs: kernel B's split transform and decide kernel against
    #     the twins, the main path at 1024x256, the other routes, a
    #     LocalMesh, timings.
    log(f"phases 1-31: {time.perf_counter() - t_start:.1f} s")
    long_rows, long_summary = long_cpi_phase(card, dev, pgr)

    # 33. Long CPIs in fixed mode: the fixed slow-time kernel's long-CPI
    #     entries against the twin and the golden model, the fused fixed
    #     route at 1024x256, a LocalMesh, timings.
    log(f"phases 1-32: {time.perf_counter() - t_start:.1f} s")
    fixed_long_rows, fixed_long_summary = fixed_long_phase(card, dev, pgr)

    # 34. fixed_fft="scaled": the stage-scaled transform on the card
    #     against the golden model, the scaled routes against the plain
    #     route and the golden model, timings.
    log(f"phases 1-33: {time.perf_counter() - t_start:.1f} s")
    scaled_rows, scaled_summary = scaled_phase(card, dev, pgr)

    # 35. The quick-validation stimulus and the demo: the faithful quick
    #     run, the demo's run function in five modes, its kernels at its
    #     shapes.
    log(f"phases 1-34: {time.perf_counter() - t_start:.1f} s")
    demo_rows, demo_summary = demo_phase(card, dev)

    # 36. Range lengths n2 x 128: kernel A at every length against its
    #     twin, kernel B at 2048, 1536 and 384 rows, the routes there,
    #     timings.
    log(f"phases 1-35: {time.perf_counter() - t_start:.1f} s")
    length_rows, length_summary = length_phase(card, dev, pgr)

    # 37. The fixed kernels at the range lengths n2 x 128: the fixed range
    #     kernel at every length against its twin and on tie frames against
    #     the golden model, the fixed slow-time kernel at those rows, the
    #     fused fixed route there, a LocalMesh, timings.
    log(f"phases 1-36: {time.perf_counter() - t_start:.1f} s")
    fixed_length_rows, fixed_length_summary = fixed_length_phase(card, dev,
                                                                 pgr)

    # 38. The dense lengths (n_doppler a multiple of 8 below 2048, neither
    #     16..128 nor n2d x 128): kernel B's dense operator at every such
    #     length against its twins, the main path at 1024x96, 1024x192 and
    #     1024x1016, the other routes and a LocalMesh, timings.
    log(f"phases 1-37: {time.perf_counter() - t_start:.1f} s")
    dense_rows, dense_summary = dense_phase(card, dev, pgr)

    # 39. Wide maps in the standalone CFAR kernels (column chunks): the rank
    #     layout's host mirror, every chunked entry against its twin at
    #     584 .. 4096 columns, the debug taps, fixed auto, the 3D array
    #     model and a LocalMesh at wide maps, timings.
    log(f"phases 1-38: {time.perf_counter() - t_start:.1f} s")
    wide_rows, wide_summary = wide_phase(card, dev, pgr)

    # 40. The fixed dense operator: the fixed slow-time kernel at every
    #     dense length against its twin and on tie planes, fixed "fused" at
    #     1024x96, 1024x192 and 1024x1016, a LocalMesh, timings.
    log(f"phases 1-39: {time.perf_counter() - t_start:.1f} s")
    fixed_dense_rows, fixed_dense_summary = fixed_dense_phase(card, dev, pgr)

    # 41. n_doppler off a multiple of 8 in the float kernels: kernel A's
    #     partial groups, kernel B at every such length below
    #     2048, the main path at 1024x100, 250, 1021 and 2047, the other
    #     routes, a LocalMesh (1016 / 4 = 254 chirps a shard), fixed
    #     "fused" refused, timings.
    log(f"phases 1-40: {time.perf_counter() - t_start:.1f} s")
    odd_rows, odd_summary = odd_phase(card, dev, pgr)

    # The kernels line.
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
             + hw_rows + variant_rows + reflect_rows + rank_reflect_rows
             + cfar3d_reflect_rows + long_rows + fixed_long_rows
             + scaled_rows + demo_rows + length_rows + fixed_length_rows
             + dense_rows + wide_rows + fixed_dense_rows + odd_rows)
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
                    "variants": variant_summary,
                    "reflect": reflect_summary,
                    "rank_reflect": rank_reflect_summary,
                    "cfar3d_reflect": cfar3d_reflect_summary,
                    "long_cpi": long_summary,
                    "fixed_long_cpi": fixed_long_summary,
                    "scaled": scaled_summary,
                    "demo": demo_summary,
                    "range_lengths": length_summary,
                    "fixed_range_lengths": fixed_length_summary,
                    "dense_doppler": dense_summary,
                    "wide_cfar": wide_summary,
                    "fixed_dense": fixed_dense_summary,
                    "odd_doppler": odd_summary,
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
