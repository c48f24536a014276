"""Single-device radar pipeline — the port's "model".

Port of ``fmcw_tpu/models/pipeline.py``, in its two numeric modes:

    window -> range FFT -> corner turn -> MTI -> window -> Doppler FFT
           -> magnitude -> 2D OS-CFAR -> peak group -> top-K detections

* ``float32`` (production): windows and MTI folded into the transforms,
  float magnitude and CFAR;
* ``fixed`` (parity): the reference's 16-bit chain — integer Q15 windows
  with saturation counts, per-transform block-floating-point quantization,
  saturating MTI, integer magnitude and CFAR (``golden.reference.
  process_frame_fixed`` is its oracle).

and three routes (``frontend``):

* ``"fused"`` — the front-end kernels: for float32 ``range_fft`` and
  ``slowtime_detect`` (``ops/frontend.py``), for fixed ``range_fft_fixed``
  and ``slowtime_detect_fixed`` (``ops/frontend_fixed.py``); the counterpart
  of JAX's ``frontend="pallas"``;
* ``"staged"`` — JAX's ``frontend="xla"`` chain: the stages as plain
  PyTorch (dense DFTs, as XLA's matrix products: float32 for the float32
  chain, float64 for the fixed chain, see ``ops/fft.py``) and the CFAR step
  and peak grouping as the ``cfar_detect`` kernel's grouping entry
  (``ops/cfar_detect.cfar_detect_group``, which also hands the row maxima
  and counts to the top-K);
* ``"plain"`` — the kernels' plain twins on ``device`` (the reference the
  kernels are held against).

``"auto"`` takes "fused" for float32 where the front-end kernels take the
configuration (``ops/frontend.fused_detect_supported``: kernel A's frame,
kernel B's tile), else "staged", as JAX's ``auto`` falls back to its XLA
chain; and "staged" for fixed, as JAX's ``auto`` keeps fixed mode on its
XLA chain.  The decision is made when the processor is built, before any
launch; a kernel that fails to build or launch raises.  In the port both
fixed routes transform in float64 and quantize to the golden model's
values, so they give the same detections.  The fixed staged route's
stages up to the magnitude are the same plain code the fused kernels'
twins are made of (``ops/frontend_fixed.*_plain``): staged against fused
repeats the kernel-against-twin check, and only ``golden.reference.
process_frame_fixed`` is an independent witness.
On a CPU tensor every kernel wrapper takes its plain twin.  The top-K
selection is a stable PyTorch sort.

The CFAR debug taps (``include_debug``: the threshold and scale maps, the
``dbg_threshold`` / ``dbg_scale`` ports) need the order statistic itself,
which the counting kernels never form: with them every route runs JAX's
standalone-CFAR dataflow — the route's magnitudes (float32 "fused": kernel A
and kernel B's magnitude-only entry; "staged" and fixed: the plain stages),
then the rank-select CFAR ``ops/cfar_rank`` (TPU kernel row 9) with the
peak grouping in its epilogue (``cfar_rank_group``, which also hands the
row maxima and counts to the top-K; on "plain" its twin ``cfar_rank_plain``
and the plain ``ops/cfar.peak_group``), then the top-K.  Float per-cell
taps rank on ``cfar_rank_bits`` key bits (16, JAX's default: the threshold
is the order statistic truncated, under it by < 0.8%, and so is the
decision; None is exact), integer maps on 16 bits (exact below 2^16), the
block scale exactly with ``ops/cfar.block_scale_map``'s scale.  Fixed
mode's "fused" route has no debug taps (it raises, as JAX's
``frontend="pallas"``).

Runtime controls (``mti_bypass``, ``scale_override``) are call arguments —
the radar_core control ports (rtl/src/radar_core.vhd:48-49).

The array-radar model (``make_array_processor``,
``make_batch_array_processor``; port of JAX's) runs element-space cubes
through the ULA beamformer (``ops/beamform``, a plain float32 matrix
product), the per-beam front end and either the per-beam 2D CFAR
(``ref_angle == 0``) or the angle-extended 3D CFAR (``ref_angle > 0``),
then per-beam and cross-beam peak grouping and a top-K over
(beam, range, Doppler).  Its routes: "fused" — kernel A's float entry
point, then kernel B (2D) or its magnitude-only entry point and the 3D CFAR
kernel (``ops/cfar3d_detect``), then the cross-beam grouping kernel
(``ops/beam_group``); "staged" — the plain float transforms per beam, the
``cfar_detect`` kernel's grouping entry (2D) or the 3D CFAR kernel and
plain per-beam grouping, then the cross-beam grouping kernel; "plain" — the
twins.  "auto" is "fused" where kernel A and kernel B (or its
magnitude-only entry, with the 3D CFAR) take the configuration, else
"staged" (``resolve_array_frontend``).

``cfar_geometry="hw_stream"`` reproduces the reference's as-built streaming
CFAR (crossed-axis window over the flat range-major stream, startup skip,
the -3-cell label offset, the line buffer carried across frames; golden
``os_cfar_2d_hw_stream`` is its oracle): the route's magnitudes (float32
"fused": kernel A and kernel B's magnitude-only entry; "staged" and fixed:
the plain stages), then the flat-stream entry of ``csrc/cfar_detect.cu``
(``ops/cfar_detect.cfar_detect_hw_stream``; on "plain" its twin) framed by
``ops/cfar.cfar_2d_hw_stream``, the plain ``peak_group`` in decision order,
the roll into label space and the top-K, in JAX's order.  Each frame of a
batch is its own one-shot stream; ``process.stream`` carries the line
buffer (``hist``) from one CPI to the next.  Its debug taps are the
decisions' scale and the plain order statistic over the flat-stream views
(as JAX's XLA method), not the rank-select kernel.  Per-cell OS only, and no
fused fixed route (``ValueError``, as JAX).

The CFAR variants (``CfarParams.variant``: "os", "ca", "go", "so") take
JAX's dispatch.  Kernel B decides every variant (its CA/GO/SO epilogue,
``csrc/cfar_tile.cuh``): the float "fused" route and the array model's
per-beam 2D route.  No standalone kernel takes CA/GO/SO (JAX's
``cfar_2d_auto`` sends them to its XLA formulation, and its standalone
Pallas kernels are OS only), so the staged routes, the debug taps and the
3D CFAR decide them in the plain ``ops/cfar.cfar_2d`` / ``cfar_3d`` on the
device (``cfar_group_route``, ``cfar3d_route``), then the plain grouping;
the OS variant keeps its kernels.  The fused fixed route decides every
variant in the fixed slow-time kernel (its integer window-mean epilogue,
as JAX's ``_kernel_fixed``); fixed ``auto`` is the staged route, as in
JAX.

Reflect edges (``CfarParams.edge_mode="reflect"``, numpy's mirror on both
axes; the block scale clips its neighbourhood; peak grouping still wraps)
take JAX's standalone-CFAR dataflow, since the front-end kernels' detect
epilogues wrap only: the route's magnitudes (float32 "auto" / "fused":
kernel A and kernel B's magnitude-only entry, ``resolve_frontend`` asks
for that entry; "staged" and fixed: the plain stages), then the reflect
entry of ``csrc/cfar_detect.cu`` (``ops/cfar_detect.cfar_detect``; on
"plain" its twin) and the plain ``peak_group``
(``cfar_detect_then_group``), then the top-K; CA/GO/SO decide in the plain
``cfar_2d_group``.  The OS debug taps run the reflect entry of
``csrc/cfar_rank.cu`` on the same magnitudes, then the plain grouping
(``cfar_rank_then_group``; on "plain" ``cfar_rank_plain``).  The array
model takes reflect on every route: at ``ref_angle == 0`` the per-beam
magnitudes (kernel A's float entry and kernel B's magnitude-only entry,
or the plain stages), then ``cfar_group_route`` per beam (an explicit
"fused" raises ValueError there, as JAX's "pallas": kernel B's detect
entry wraps only); at ``ref_angle > 0`` the reflect entry of
``csrc/cfar_3d_detect.cu`` (``cfar3d_route``; CA/GO/SO the plain
``cfar_3d``), the beam axis mirrored too.  The grouping entries stay wrap
only, so the reflect routes group in plain PyTorch.  Fixed "fused" raises
ValueError, as JAX's.  ``cfar_geometry="hw_stream"`` ignores the edge
mode, as JAX's.

Long CPIs (n_doppler = n2d x 128, n2d 2..16, JAX's long-CPI Doppler
split): kernel B takes them on every float route that reaches it (the
split transform into the magnitude map, then its decide kernel over tiles
of rows x chunks of Doppler columns, ``ops/frontend.py``), so float
"auto" is "fused" there, as JAX's "auto" takes its kernel; the debug taps,
reflect edges and the array model (``ref_angle`` 0 and > 0) run its
entries as at short CPIs.  So do the dense lengths (every other multiple
of 8 below 2048, 8, 24 .. 2040, ``ops/frontend.dense_cpi``: JAX's dense
operator), an o x m FFT row into the same map, and every other n_doppler
below 2048 (off a multiple of 8, 1 .. 2047 as the CFAR window admits,
``ops/frontend.unaligned_cpi``: kernel A with a partial last group of
8 chirps a frame, kernel B's row with m = nd & -nd in 1, 2, 4 and a ragged last
decide chunk), on one device and on an sp mesh where sp divides
n_doppler.  Other n_doppler (from 2048 up but the long CPIs) take the
staged route under "auto", and "fused" raises.  The block scale keeps its
rule: n_doppler a multiple of scale_block.  The fixed slow-time kernel
takes the long CPIs and the dense lengths too (the same plans in FP64,
the BFP exponent from the whole row, its int32 map decided by kernel B's
decide kernel): fixed "fused" runs ``range_fft_fixed`` and
``slowtime_detect_fixed`` there, per-cell and block, every variant; off a
multiple of 8 it raises NotImplementedError when the processor is built,
on every device.  Fixed "auto" stays the staged route, as JAX's "auto"
stays on its XLA chain.

Range lengths: kernel A takes the powers of two 16 .. 1024 and JAX's n2 x
128 with n2 <= 16 (384, 640, ..., 2048; ``ops/frontend.range_length_ok``,
its dense o-point stage before a power-of-two transform), and kernel B
any number of rows its tile of 64, 32, 16 or 8 rows divides
(``ops/frontend._short_tile``).  So float "auto" is "fused" at those
lengths on every float route (the debug taps, reflect, hw-compat, the
array model), as JAX's "auto" takes its kernel.  The fixed range kernel
takes the same lengths (the dense stage in FP64, its classes run twice
for the BFP peak over the whole chirp): fixed "fused" runs
``range_fft_fixed`` and ``slowtime_detect_fixed`` there, on one device
and on a mesh, per-cell and block, every variant, long CPIs included;
fixed "auto" stays the staged route, as at every length.

``fixed_fft="scaled"`` (fixed mode) swaps the fixed chain's transforms for
the QUICK-mode XFFT variants' stage-scaled integer arithmetic
(``ops/fft.scaled_fft_apply``; ``fixed_fft_scale_sch`` = (range_sch,
doppler_sch), None meaning [1]*log2(n) per transform).  It has no fused
kernel, as in JAX: "auto" and "staged" run the staged route with the
scaled transforms in place of the float64 DFT and BFP, then the route's
CFAR kernels as above (the grouping entry, the flat-stream entry, the
rank-select CFAR for the debug taps, the reflect entries); "plain" runs
their twins; "fused" raises ValueError.

The sharded processors are in ``parallel/sharded.py`` (they take no
``fixed_fft``, as JAX's).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from ..params import RadarParams
from ..ops import beamform as BF, cfar as C, detect as DET
from ..ops import cfar3d_detect as C3, cfar_detect as CD, cfar_rank as RK
from ..ops import frontend as F, frontend_fixed as FX
from ..ops.beam_group import beam_group, beam_group_plain
from ..ops.cfar3d_detect import cfar3d_detect, cfar3d_detect_plain
from ..golden.fixed_point import hw_stream_lag
from ..ops.cfar_detect import (cfar_detect_group, cfar_detect_group_plain,
                               cfar_detect_hw_stream, cfar_detect_then_group)
from ..ops.cfar_rank import (cfar_rank_group, cfar_rank_plain,
                             cfar_rank_then_group, debug_bits)
from ..ops.fft import dft_apply, doppler_apply
from ..ops.frontend import rdm_frontend_detect
from ..ops.magnitude import magnitude_float
from ..ops.notch import check_notch
from ..ops.window import window_rounding_constant

FRONTENDS = ("auto", "staged", "fused", "plain")


def complex_to_iq(frame: np.ndarray) -> np.ndarray:
    """Pack a complex frame into the ingest format: int16 (..., 2) I/Q pairs
    (== the reference's 32-bit interleaved s_axis_tdata, radar_core.vhd:26)."""
    z = np.asarray(frame)
    return np.stack([z.real, z.imag], axis=-1).astype(np.int16)


def resolve_frontend(mode: str, frontend: str,
                     p: RadarParams | None = None,
                     peak_group_radius: int = 0,
                     mag_only: bool = False) -> str:
    """The route ``frontend`` names.  "auto" is "staged" for fixed; for
    float32 it is "fused" where the front-end kernels take ``p``
    (``ops/frontend.fused_detect_supported``, with ``peak_group_radius``
    and ``mag_only`` as there, and the magnitude-only entry for edges other
    than wrap; decided here, before any launch), else "staged", as JAX's
    "auto" falls back to its XLA chain.  An explicit float32 "fused" asks
    the same checks on every device (``ops/frontend.check_fused_detect``)
    and raises their NotImplementedError where the kernels do not take
    ``p``, so the CPU refuses what the card would.  Without ``p`` the
    float32 "auto" is "fused"."""
    if frontend not in FRONTENDS:
        raise ValueError(f"frontend must be one of {FRONTENDS}, got "
                         f"{frontend!r}")
    mag_only = mag_only or (p is not None and p.cfar.edge_mode != "wrap")
    if frontend == "fused" and mode == "float32" and p is not None:
        F.check_fused_detect(p, peak_group_radius, mag_only)
    if frontend != "auto":
        return frontend
    if mode != "float32":
        return "staged"
    if p is None or F.fused_detect_supported(p, peak_group_radius, mag_only):
        return "fused"
    return "staged"


def _staged_float(re, im, mti_bypass, p: RadarParams, transient: str,
                  exact_mag: bool):
    """JAX's float ``frontend="xla"`` transforms of float32 (..., nd, nr)
    planes: the window folded into the range DFT matrix, the slow-time
    chain as one matrix, the magnitude — (..., nr, nd) float32."""
    re, im = dft_apply(re, im, window=True)
    yr, yi = doppler_apply(re.transpose(-1, -2), im.transpose(-1, -2),
                           bool(mti_bypass), p.notch_mode, transient)
    return magnitude_float(yr, yi, exact=exact_mag)


def _staged_fixed(iq, mti_bypass, p: RadarParams, transient: str,
                  rounding: str, sch=(None, None)):
    """JAX's fixed ``frontend="xla"`` transforms (``fixed_path``): the
    fixed chain's stages up to the integer magnitude, the same plain PyTorch
    stages the fused kernels' twins are made of, with the stage-scaled
    transforms where ``sch`` holds (range_sch, doppler_sch) — ((B, nr, nd)
    int32, saturation count (B,))."""
    re, im, sat_r = FX.range_fft_fixed_plain(iq, p.coef_width, rounding,
                                             sch[0])
    mag, sat_d = FX.slowtime_mag_fixed_plain(
        re, im, mti_bypass, p.notch_mode, transient, p.coef_width, rounding,
        sch[1])
    return mag, sat_r + sat_d


def scaled_schedules(p: RadarParams, fixed_fft: str, mode: str,
                     frontend: str, fixed_fft_scale_sch=None):
    """Check ``fixed_fft`` as JAX's ``make_processor`` does and return the
    fixed chain's (range_sch, doppler_sch): (None, None) for "bfp"; for
    "scaled" the given pair, or [1]*log2(n) per transform."""
    if fixed_fft not in ("bfp", "scaled"):
        raise ValueError(f"fixed_fft must be 'bfp' or 'scaled', got "
                         f"{fixed_fft!r}")
    if fixed_fft == "bfp":
        return None, None
    if mode != "fixed":
        raise ValueError("fixed_fft='scaled' applies to mode='fixed'")
    if frontend == "fused":
        raise ValueError("fixed_fft='scaled' has no fused kernel; use "
                         "frontend='auto', 'staged' or 'plain'")
    sch = tuple(tuple(int(v) for v in s) for s in (fixed_fft_scale_sch or (
        [1] * (p.n_range.bit_length() - 1),
        [1] * (p.n_doppler.bit_length() - 1))))
    for s, n in zip(sch, (p.n_range, p.n_doppler)):
        if len(s) != n.bit_length() - 1:
            raise ValueError(f"fixed_fft_scale_sch: {len(s)} shifts for a "
                             f"{n}-point transform")
    return sch


def cfar_group_route(cfar, plain: bool, shape,
                     peak_group_radius: int = 0) -> Callable:
    """The CFAR and grouping of a route that decides on its magnitude maps
    (the staged routes, and every route under reflect edges), with
    ``cfar_detect_group``'s signature and outputs: for OS its grouping
    entry with wrap edges, the reflect entry then the plain grouping
    (``cfar_detect_then_group``) with reflect edges, the twins on "plain"
    (``plain``); the plain ``ops/cfar.cfar_2d_group`` for CA/GO/SO.  The
    kernel it returns is asked on the host, on every device, whether it
    takes the (R, D) maps ``shape`` the step will take
    (``ops/cfar_detect.check_kernel``: its window checks and tile plan), so
    that a processor refuses at build, with its NotImplementedError, what
    the card would refuse at the call."""
    if cfar.variant != "os":
        return C.cfar_2d_group
    if plain:
        return cfar_detect_group_plain
    wrap = cfar.edge_mode == "wrap"
    CD.check_kernel(*shape, cfar, peak_group_radius if wrap else -1,
                    cfar.scale_mode == "block")
    return cfar_detect_group if wrap else cfar_detect_then_group


def cfar_decide_route(cfar, route: str, shape, peak_group_radius: int,
                      include_debug: bool, bits: int | None) -> Callable:
    """``make_batch_processor``'s CFAR and grouping on (R, D) magnitude maps
    (``shape``) for the routes that decide on them (the staged routes, the
    debug taps, reflect edges): ``fn(mag, so) -> (det, threshold, scale,
    row_max, n_dets)``, threshold and scale the debug taps (None without
    them), row_max and n_dets None where the grouping is plain.  Without
    the taps ``cfar_group_route``; with them the rank-select CFAR (its
    grouping entry, or under reflect the reflect entry then the plain
    grouping), its twin on "plain", the plain ``ops/cfar.cfar_2d`` for
    CA/GO/SO.  The kernel chosen is asked at once whether it takes the maps
    (``cfar_group_route``, ``ops/cfar_rank.check_kernel``)."""
    plain = route == "plain"
    pgr = peak_group_radius
    if not include_debug:
        step = cfar_group_route(cfar, plain, shape, pgr)

        def decide(mag, so):
            det, scale, row_max, n_dets = step(mag, so, cfar=cfar,
                                               peak_group_radius=pgr)
            return det, None, scale, row_max, n_dets
        return decide
    if cfar.variant == "os" and not plain:
        wrap = cfar.edge_mode == "wrap"
        RK.check_kernel(*shape, cfar, bits, pgr if wrap else -1,
                        cfar.scale_mode == "block")
        step = cfar_rank_group if wrap else cfar_rank_then_group
        return lambda mag, so: step(mag, so, cfar=cfar, bits=bits,
                                    peak_group_radius=pgr)

    def decide_plain(mag, so):
        if cfar.variant != "os":
            det, threshold, scale = C.cfar_2d(mag, so, cfar, need_debug=True)
        else:
            det, threshold, scale = cfar_rank_plain(mag, so, cfar=cfar,
                                                    bits=bits)
        return C.peak_group(det, pgr), threshold, scale, None, None
    return decide_plain


def _plain_cfar3d(cube, scale_override=0, *, cfar, ref_angle,
                  guard_angle=0, prepadded_angle=False):
    det, _, scale = C.cfar_3d(cube, scale_override, cfar, ref_angle,
                              guard_angle, prepadded_angle=prepadded_angle)
    return det, scale


def cfar3d_route(cfar, plain: bool, shape, ref_angle: int,
                 guard_angle: int = 0, prepadded: bool = False) -> Callable:
    """The angle-extended CFAR's decision, ``cfar3d_detect``'s signature:
    the 3D CFAR kernel (its twin on "plain") for OS, the plain
    ``ops/cfar.cfar_3d`` for CA/GO/SO (JAX's ``cfar_3d`` sends them to its
    XLA body).  The kernel is asked on the host, on every device, whether
    it takes the (n_beams, R, D) planes ``shape`` of a cube (a beam shard's
    own planes, its halo planes added, with ``prepadded``;
    ``ops/cfar3d_detect.cfar3d_config``), as ``cfar_group_route`` asks."""
    if cfar.variant != "os":
        return _plain_cfar3d
    if plain:
        return cfar3d_detect_plain
    A, R, D = shape
    ha = ref_angle + guard_angle
    C3.cfar3d_config((1, A + (2 * ha if prepadded else 0), R, D), cfar,
                     ref_angle, guard_angle, prepadded_angle=prepadded)
    return cfar3d_detect


def make_batch_processor(params: RadarParams | None = None,
                         mode: str = "float32", frontend: str = "auto",
                         window_rounding: str = "unbiased",
                         mti_transient: str = "zero",
                         peak_group_radius: int = 0,
                         magnitude_exact: bool = False,
                         include_maps: bool = True,
                         include_debug: bool = False,
                         cfar_rank_bits: int | None = 16,
                         fixed_fft: str = "bfp",
                         fixed_fft_scale_sch=None,
                         cfar_geometry: str = "named",
                         device=None) -> Callable:
    """Multi-frame processor: iq int16 (batch, n_doppler, n_range, 2)
    (numpy or tensor) -> dict of batched outputs.  The whole batch goes
    through each kernel in one launch.

    Returned callable: ``fn(iq, mti_bypass=False, scale_override=0) -> dict``
    with, as ``fmcw_tpu.models.pipeline.make_processor``'s output and a
    leading batch axis on every entry:

      range_bin/doppler_bin/mag/valid  top-K detection arrays (max_dets,);
                        mag is float32, or int32 in fixed mode
      n_dets            total CFAR detection count
      saturation_count  the windows' saturated samples, I and Q counted
                        separately (fixed mode; 0 in float32)
      nonfinite_count   NaN/Inf cells in the magnitude map (0 in fixed)
      mag_map, det_map  (n_range, n_doppler)     [if include_maps]
      threshold_map, scale_map  CFAR debug taps, in the magnitude map's
                        type (float32, or int32 in fixed mode)
                        [if include_debug]

    ``device``: None means "cuda" (raises without one); pass "cpu" for the
    plain path.  ``frontend``: "auto", "staged", "fused" or "plain" (see the
    module docstring, also for the debug taps and ``cfar_rank_bits``, the
    key bits their float per-cell rank select walks: 16 or None = exact).
    ``window_rounding`` ("unbiased" or the reference's "biased") applies to
    fixed mode, ``magnitude_exact`` to float32, as in JAX.
    ``fixed_fft``: "bfp" or "scaled", with ``fixed_fft_scale_sch`` (the
    module docstring; ValueError for float32, "fused" or another name).
    ``cfar_geometry``: "named" or "hw_stream" (the module docstring; the
    detections and det_map at the hardware's label coordinates), which also
    gives the callable ``stream(iq, mti_bypass=False, scale_override=0,
    hist=None) -> (out, hist)`` for a batch of continuous streams.
    """
    p = params or RadarParams()
    dev = resolve_device(device)
    if mode not in ("float32", "fixed"):
        raise ValueError(f"mode must be 'float32' or 'fixed', got {mode!r}")
    if cfar_geometry not in ("named", "hw_stream"):
        raise ValueError(f"cfar_geometry must be 'named' or 'hw_stream', got "
                         f"{cfar_geometry!r}")
    sch = scaled_schedules(p, fixed_fft, mode, frontend, fixed_fft_scale_sch)
    # The stage-scaled transforms run on the staged route's dataflow.
    scaled = sch[0] is not None
    hw = cfar_geometry == "hw_stream"
    # Reflect maps decide in the standalone CFAR (module docstring).
    standalone = not hw and p.cfar.edge_mode != "wrap"
    route = resolve_frontend(mode, frontend, p, peak_group_radius,
                             mag_only=hw or include_debug)
    if hw:
        C.check_hw_stream(p.cfar)
        if mode == "fixed" and route == "fused":
            raise ValueError("cfar_geometry='hw_stream' has no fused fixed "
                             "kernel; use frontend='auto' or 'staged' with "
                             "mode='fixed'")
    else:
        C.check_supported(p.cfar)
    if mode == "fixed":
        check_notch(p.notch_mode, mti_transient)
        window_rounding_constant(p.coef_width, window_rounding)
        if route == "fused" and not FX.fused_fixed_detect_supported(
                p, peak_group_radius, include_debug):
            # A Doppler length the fixed kernels do not take (n2d > 16,
            # off a multiple of 8) raises NotImplementedError, as their
            # wrappers and the mesh.
            F.check_doppler(p.n_doppler, "slowtime_detect_fixed",
                            int_map=True)
            raise ValueError(
                "frontend='fused' with mode='fixed' runs the fused "
                "fixed-point kernels, which need a wrap-edge CfarParams "
                "fitting their tile and no debug taps "
                "(fused_fixed_detect_supported)")
    max_dets = p.tracker.max_dets
    bits = debug_bits(p.cfar, mode == "fixed", cfar_rank_bits)
    # The standalone CFAR step, chosen here, its kernel asked at once
    # whether it takes the maps: the flat-stream entry for hw-compat, else
    # on the routes that decide on their magnitude maps.
    hw_decide = cfar_detect_hw_stream
    if hw and route == "plain":
        hw_decide = C.hw_stream_decide_plain
    elif hw:
        CD.check_flat_kernel(p.n_range, p.n_doppler, p.cfar)
    decide = None
    if not hw and (route == "staged" or include_debug or standalone
                   or scaled):
        decide = cfar_decide_route(p.cfar, route, (p.n_range, p.n_doppler),
                                   peak_group_radius, include_debug, bits)
    hlen = 2 * hw_stream_lag(p.cfar, p.n_doppler)

    def magnitudes(iq, bypass):
        """The route's magnitude maps for the standalone CFAR: (mag,
        saturation count, non-finite count)."""
        zeros = torch.zeros(iq.shape[0], dtype=torch.int32, device=dev)
        if mode == "fixed":
            mag, sat = _staged_fixed(iq, bypass, p, mti_transient,
                                     window_rounding, sch)
            return mag, sat, zeros
        tf_kw = dict(notch_mode=p.notch_mode, transient=mti_transient,
                     exact_mag=magnitude_exact)
        if route == "fused":
            mag, nonfinite = F.slowtime_mag(*F.range_fft(iq), bypass,
                                            **tf_kw)
            return mag, zeros, nonfinite
        if route == "staged":
            mag = _staged_float(iq[..., 0].to(torch.float32),
                                iq[..., 1].to(torch.float32), bypass, p,
                                mti_transient, magnitude_exact)
        else:
            mag = F.slowtime_mag_plain(*F.range_fft_plain(iq), bypass,
                                       **tf_kw)
        return (mag, zeros,
                (~torch.isfinite(mag)).sum(dim=(-2, -1)).to(torch.int32))

    def hw_stream(iq, bypass, so, hist, streaming):
        """The hw-compat streaming CFAR on the route's magnitudes: the
        decisions (the kernel's flat-stream entry, or its twin on
        "plain"), the plain grouping in decision order, then the roll
        into label space (JAX's order)."""
        mag, sat, nonfinite = magnitudes(iq, bypass)
        det, threshold, scale, *carry = C.cfar_2d_hw_stream(
            mag, so, cfar=p.cfar, integer=mode == "fixed", hist=hist,
            streaming=streaming, need_debug=include_debug, label_roll=False,
            decide=hw_decide)
        det = C.peak_group(det, peak_group_radius)
        shift = C.hw_stream_label_shift(p.cfar, p.n_doppler, streaming)
        det = torch.roll(det.reshape(det.shape[0], -1), -shift,
                         dims=-1).reshape(det.shape)
        return det, mag, sat, nonfinite, threshold, scale, carry

    def run(iq, mti_bypass, scale_override, hist=None, streaming=False):
        if tuple(iq.shape[1:]) != (p.n_doppler, p.n_range, 2):
            raise ValueError(
                f"expected iq batch of shape (batch, {p.n_doppler}, "
                f"{p.n_range}, 2), got {tuple(iq.shape)}")
        iq = torch.as_tensor(iq).to(dev)
        bypass, so = bool(mti_bypass), int(scale_override)
        row_max = n_dets = None
        carry = []
        if hw:
            det, mag, sat, nonfinite, threshold, scale, carry = hw_stream(
                iq, bypass, so, hist, streaming)
        elif decide is not None:
            mag, sat, nonfinite = magnitudes(iq, bypass)
            det, threshold, scale, row_max, n_dets = decide(mag, so)
        elif mode == "fixed":
            det, mag, sat, row_max, n_dets = FX.rdm_frontend_fixed_detect(
                iq, bypass, so, cfar=p.cfar, notch_mode=p.notch_mode,
                transient=mti_transient, coef_width=p.coef_width,
                window_rounding=window_rounding,
                peak_group_radius=peak_group_radius, emit_mag=include_maps,
                plain=route == "plain")
            nonfinite = torch.zeros_like(sat)
        else:
            det, mag, nonfinite, row_max, n_dets = rdm_frontend_detect(
                iq, bypass, so, cfar=p.cfar, notch_mode=p.notch_mode,
                transient=mti_transient, exact_mag=magnitude_exact,
                peak_group_radius=peak_group_radius, emit_mag=include_maps,
                plain=route == "plain")
            sat = torch.zeros_like(nonfinite)
        out = DET.topk_detections(det, max_dets=max_dets, row_max=row_max,
                                  n_dets=n_dets)
        out["saturation_count"] = sat
        out["nonfinite_count"] = nonfinite
        if include_maps:
            out["mag_map"] = mag
            out["det_map"] = det
        if include_debug:
            out["threshold_map"] = threshold
            # The map's type, as JAX's tap (float32 or fixed mode's int32).
            out["scale_map"] = scale.to(mag.dtype)
        return out, carry

    def process(iq, mti_bypass=False, scale_override=0) -> dict:
        return run(iq, mti_bypass, scale_override)[0]

    if hw:
        def stream(iq, mti_bypass=False, scale_override=0, hist=None):
            """One CPI of each of a batch of continuous hw-compat streams:
            ``hist`` (batch, 2 lag) is the previous call's carry (None:
            each stream's first frame, a zero line buffer and the startup
            skip).  Returns (out, hist): out covers the hardware's outputs
            for this frame's input window (the previous frame's tail,
            re-labelled, and this frame's head), det_map at label
            coordinates; hist in the map's type, on the device."""
            if hist is not None:
                hist = torch.as_tensor(hist, device=dev)
                if tuple(hist.shape) != (iq.shape[0], hlen):
                    raise ValueError(f"expected hist of shape "
                                     f"({iq.shape[0]}, {hlen}), got "
                                     f"{tuple(hist.shape)}")
            out, carry = run(iq, mti_bypass, scale_override, hist, True)
            return out, carry[0]

        process.stream = stream
    process.route = route
    return process


def make_processor(params: RadarParams | None = None, **kw) -> Callable:
    """Single-frame processor: ``fn(iq, mti_bypass=False, scale_override=0)``
    with iq int16 (n_doppler, n_range, 2); the keywords and outputs of
    ``make_batch_processor`` without the batch axis.  With
    ``cfar_geometry="hw_stream"`` also ``fn.stream(iq, mti_bypass=False,
    scale_override=0, hist=None) -> (out, hist)``, the continuous-stream
    call (``fmcw_tpu.models.pipeline.make_processor``'s
    ``process.stream``): ``hist`` the previous call's carry (2 lag cells),
    None for the stream's first frame."""
    p = params or RadarParams()
    batched = make_batch_processor(p, **kw)

    def check(iq):
        # Strict single-frame shape: a batch would pass a trailing-dims check.
        if tuple(iq.shape) != (p.n_doppler, p.n_range, 2):
            raise ValueError(
                f"expected iq frame of shape (n_doppler={p.n_doppler}, "
                f"n_range={p.n_range}, 2), got {tuple(iq.shape)}")

    def process(iq, mti_bypass=False, scale_override=0) -> dict:
        check(iq)
        out = batched(iq[None], mti_bypass, scale_override)
        return {k: v[0] for k, v in out.items()}

    if hasattr(batched, "stream"):
        def stream(iq, mti_bypass=False, scale_override=0, hist=None):
            check(iq)
            if hist is not None:
                hist = torch.as_tensor(hist).reshape(1, -1)
            out, hist = batched.stream(iq[None], mti_bypass, scale_override,
                                       hist)
            return {k: v[0] for k, v in out.items()}, hist[0]

        process.stream = stream
    return process


# ---------------------------------------------------------------------------
# The array-radar model
# ---------------------------------------------------------------------------

def resolve_array_frontend(frontend: str, p: RadarParams | None = None,
                           ref_angle: int = 0,
                           peak_group_radius: int = 0) -> str:
    """The array model's route: "fused", "staged" or "plain"; "auto" is
    "fused" where kernel A and kernel B (``ref_angle == 0``) or its
    magnitude-only entry (``ref_angle > 0``, or edges other than wrap) take
    ``p``, else "staged" (``resolve_frontend``), as JAX's falls back to its
    XLA chain.  An explicit "fused" at ``ref_angle == 0`` with reflect edges
    raises ValueError, as JAX's "pallas" (kernel B's detect entry wraps
    only; "auto" takes the magnitude-only entry there)."""
    if (frontend == "fused" and ref_angle == 0 and p is not None
            and p.cfar.edge_mode != "wrap"):
        raise ValueError(
            "frontend='fused' on the array model at ref_angle == 0 runs "
            "kernel B's detect entry, which takes wrap edges only; use "
            "frontend='auto' (the magnitude-only entry, then the standalone "
            "CFAR's reflect entry) or 'staged'")
    return resolve_frontend("float32", frontend, p, peak_group_radius,
                            mag_only=ref_angle > 0)


def make_batch_array_processor(params: RadarParams | None = None,
                               n_elems: int = 8, n_beams: int = 8,
                               mti_transient: str = "zero",
                               magnitude_exact: bool = False,
                               ref_angle: int = 0, guard_angle: int = 0,
                               spacing_wl: float = 0.5,
                               max_angle_deg: float = 60.0,
                               taper: str | None = None,
                               include_maps: bool = True,
                               frontend: str = "auto",
                               peak_group_radius: int = 0,
                               beam_group_radius: int = 0,
                               device=None) -> Callable:
    """Array-radar model over a batch of element-space cubes: iq int16
    (batch, n_elems, n_doppler, n_range, 2) -> ULA phase-shift beamformer
    (``ops/beamform``) -> per-beam range-Doppler front end -> per-beam 2D
    CFAR (``ref_angle == 0``) or the angle-extended 3D CFAR (``ref_angle >
    0``, ``guard_angle`` guard planes, ``ops/cfar.cfar_3d``) -> per-beam
    peak grouping (``peak_group_radius``) -> cross-beam grouping
    (``beam_group_radius``, ``ops/cfar.peak_group_beams``) -> the top-K
    (beam, range, Doppler) detections.  Port of
    ``fmcw_tpu.models.pipeline.make_batch_array_processor``; every cube of
    the batch goes through each kernel in one launch.

    Returned callable: ``fn(iq, mti_bypass=False, scale_override=0) ->
    dict`` with, for each cube, the detection arrays of
    ``make_batch_processor`` (range_bin, doppler_bin, mag, valid, n_dets,
    saturation_count = 0, nonfinite_count over the magnitude cube) plus
    ``beam_bin``, and with ``include_maps`` the (n_beams, n_range,
    n_doppler) ``mag_cube`` and ``det_cube``.

    ``frontend``: "auto", "fused", "staged" or "plain" (module docstring,
    ``resolve_array_frontend``).  ``device``: None means "cuda" (raises
    without one); pass "cpu" for the plain path.  ``p.cfar.edge_mode``:
    wrap, or reflect (the module docstring: the per-beam magnitudes, then
    the standalone CFAR's reflect entry per beam, or the 3D CFAR's with the
    beam axis mirrored too)."""
    p = params or RadarParams()
    dev = resolve_device(device)
    C.check_supported(p.cfar)
    reflect = p.cfar.edge_mode != "wrap"
    route = resolve_array_frontend(frontend, p, ref_angle, peak_group_radius)
    BF.steering_matrix(n_elems, n_beams, spacing_wl, max_angle_deg, taper)
    nr, nd, nb = p.n_range, p.n_doppler, n_beams
    max_dets = p.tracker.max_dets
    plain = route == "plain"
    tf_kw = dict(notch_mode=p.notch_mode, transient=mti_transient,
                 exact_mag=magnitude_exact)
    range_fft = F.range_fft_float_plain if plain else F.range_fft_float
    detect = F.slowtime_detect_plain if plain else F.slowtime_detect
    # The standalone CFAR per beam (staged, reflect) or the 3D CFAR, their
    # kernels asked at once whether they take the maps.
    cfar3d = cfar2d = None
    if ref_angle > 0:
        cfar3d = cfar3d_route(p.cfar, plain, (nb, nr, nd), ref_angle,
                              guard_angle)
    elif route == "staged" or reflect:
        cfar2d = cfar_group_route(p.cfar, plain, (nr, nd), peak_group_radius)
    group = beam_group_plain if plain else beam_group

    def process(iq, mti_bypass=False, scale_override=0) -> dict:
        if tuple(iq.shape[1:]) != (n_elems, nd, nr, 2):
            raise ValueError(
                f"expected element-space iq batch of shape (batch, "
                f"{n_elems}, {nd}, {nr}, 2), got {tuple(iq.shape)}")
        iq = torch.as_tensor(iq).to(dev)
        bypass, so = bool(mti_bypass), int(scale_override)
        batch = iq.shape[0]
        br, bi = BF.beamform(iq[..., 0].to(torch.float32),
                             iq[..., 1].to(torch.float32), nb,
                             spacing_wl=spacing_wl,
                             max_angle_deg=max_angle_deg, taper=taper,
                             elem_dim=1)
        br = br.reshape(batch * nb, nd, nr)
        bi = bi.reshape(batch * nb, nd, nr)
        row_max = n_dets = None
        if route != "staged" and ref_angle == 0 and not reflect:
            # Per-beam 2D decision with in-kernel grouping.
            det, mag, rmax, ndet, nonfinite = detect(
                *range_fft(br, bi), bypass, so, cfar=p.cfar,
                peak_group_radius=peak_group_radius, emit_mag=include_maps,
                **tf_kw)
            row_max = rmax.reshape(batch, nb * nr)
            n_dets = ndet.reshape(batch, nb).sum(dim=1)
        else:
            # The magnitudes alone, then the standalone CFAR per beam (its
            # grouping entry, or under reflect its reflect entry and the
            # plain grouping) or the 3D CFAR.
            if route == "staged":
                mag = _staged_float(br, bi, bypass, p, mti_transient,
                                    magnitude_exact)
                nonfinite = (~torch.isfinite(mag)).sum(dim=(-2, -1))
            elif plain:
                mag = F.slowtime_mag_plain(*range_fft(br, bi), bypass,
                                           **tf_kw)
                nonfinite = (~torch.isfinite(mag)).sum(dim=(-2, -1))
            else:
                mag, nonfinite = F.slowtime_mag(*range_fft(br, bi), bypass,
                                                **tf_kw)
            mag = mag.reshape(batch, nb, nr, nd)
            if ref_angle == 0:
                det, _, rmax, ndet = cfar2d(
                    mag, so, cfar=p.cfar, peak_group_radius=peak_group_radius)
                row_max = rmax.reshape(batch, nb * nr)
                n_dets = ndet.sum(dim=1)
            else:
                det, _ = cfar3d(mag, so, cfar=p.cfar, ref_angle=ref_angle,
                                guard_angle=guard_angle)
                det = C.peak_group(det, peak_group_radius)
        det = det.reshape(batch, nb, nr, nd)
        if beam_group_radius > 0:
            det, row_max, n_dets = group(det, beam_group_radius)
        out = DET.topk_detections(det.reshape(batch, nb * nr, nd),
                                  max_dets=max_dets, row_max=row_max,
                                  n_dets=n_dets)
        out["beam_bin"] = torch.div(out["range_bin"], nr,
                                    rounding_mode="floor")
        out["range_bin"] = out["range_bin"] % nr
        out["saturation_count"] = torch.zeros(batch, dtype=torch.int32,
                                              device=dev)
        out["nonfinite_count"] = nonfinite.reshape(batch, nb).sum(
            dim=1).to(torch.int32)
        if include_maps:
            out["mag_cube"] = mag.reshape(batch, nb, nr, nd)
            out["det_cube"] = det
        return out

    process.route = route
    return process


def make_array_processor(params: RadarParams | None = None,
                         **kw) -> Callable:
    """Single-cube array processor: ``fn(iq, mti_bypass=False,
    scale_override=0)`` with iq int16 (n_elems, n_doppler, n_range, 2); the
    keywords and outputs of ``make_batch_array_processor`` without the
    batch axis (``fmcw_tpu.models.pipeline.make_array_processor``)."""
    p = params or RadarParams()
    batched = make_batch_array_processor(p, **kw)
    n_elems = kw.get("n_elems", 8)

    def process(iq, mti_bypass=False, scale_override=0) -> dict:
        if tuple(iq.shape) != (n_elems, p.n_doppler, p.n_range, 2):
            raise ValueError(
                f"expected element-space iq of shape ({n_elems}, "
                f"{p.n_doppler}, {p.n_range}, 2), got {tuple(iq.shape)}")
        out = batched(iq[None], mti_bypass, scale_override)
        return {k: v[0] for k, v in out.items()}

    process.route = batched.route
    return process
