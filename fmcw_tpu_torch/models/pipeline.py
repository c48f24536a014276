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

``"auto"`` takes "fused" for float32 and "staged" for fixed, as JAX's
``auto`` keeps fixed mode on its XLA chain.  In the port both fixed routes
transform in float64 and quantize to the golden model's values, so they
give the same detections.  The fixed staged route's stages up to the
magnitude are the same plain code the fused kernels' twins are made of
(``ops/frontend_fixed.*_plain``): staged against fused repeats the
kernel-against-twin check, and only ``golden.reference.
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
twins.  "auto" is "fused": a
shape the kernels cannot take raises their ``NotImplementedError`` at the
first call on the card and never falls back to the plain transforms.

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

Not yet ported (they raise ``NotImplementedError``, ROADMAP.md): the
CA/GO/SO variants and reflect edges, ``fixed_fft="scaled"``, on the
kernels long CPIs (n_doppler > 128).  The sharded processors are in
``parallel/sharded.py``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from ..params import RadarParams
from ..ops import beamform as BF, cfar as C, detect as DET
from ..ops import frontend as F, frontend_fixed as FX
from ..ops.beam_group import beam_group, beam_group_plain
from ..ops.cfar3d_detect import cfar3d_detect, cfar3d_detect_plain
from ..golden.fixed_point import hw_stream_lag
from ..ops.cfar_detect import cfar_detect_group, cfar_detect_hw_stream
from ..ops.cfar_rank import cfar_rank_group, cfar_rank_plain, debug_bits
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


def resolve_frontend(mode: str, frontend: str) -> str:
    """The route ``frontend`` names: "auto" is "fused" for float32 and
    "staged" for fixed."""
    if frontend not in FRONTENDS:
        raise ValueError(f"frontend must be one of {FRONTENDS}, got "
                         f"{frontend!r}")
    if frontend == "auto":
        return "fused" if mode == "float32" else "staged"
    return frontend


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
                  rounding: str):
    """JAX's fixed ``frontend="xla"`` transforms (``fixed_path``): the
    fixed chain's stages up to the integer magnitude, the same plain PyTorch
    stages the fused kernels' twins are made of — ((B, nr, nd) int32,
    saturation count (B,))."""
    re, im, sat_r = FX.range_fft_fixed_plain(iq, p.coef_width, rounding)
    mag, sat_d = FX.slowtime_mag_fixed_plain(
        re, im, mti_bypass, p.notch_mode, transient, p.coef_width, rounding)
    return mag, sat_r + sat_d


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
    ``cfar_geometry``: "named" or "hw_stream" (the module docstring; the
    detections and det_map at the hardware's label coordinates), which also
    gives the callable ``stream(iq, mti_bypass=False, scale_override=0,
    hist=None) -> (out, hist)`` for a batch of continuous streams.
    """
    p = params or RadarParams()
    dev = resolve_device(device)
    if mode not in ("float32", "fixed"):
        raise ValueError(f"mode must be 'float32' or 'fixed', got {mode!r}")
    if fixed_fft != "bfp":
        if fixed_fft != "scaled":
            raise ValueError(f"fixed_fft must be 'bfp' or 'scaled', got "
                             f"{fixed_fft!r}")
        raise NotImplementedError(
            "fixed_fft='scaled' (the stage-scaled XFFT arithmetic) is not "
            "ported yet (ROADMAP.md)")
    if cfar_geometry not in ("named", "hw_stream"):
        raise ValueError(f"cfar_geometry must be 'named' or 'hw_stream', got "
                         f"{cfar_geometry!r}")
    hw = cfar_geometry == "hw_stream"
    route = resolve_frontend(mode, frontend)
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
            raise ValueError(
                "frontend='fused' with mode='fixed' runs the fused "
                "fixed-point kernels, which need an OS wrap-edge CfarParams "
                "fitting their tile and no debug taps "
                "(fused_fixed_detect_supported)")
    max_dets = p.tracker.max_dets
    bits = debug_bits(p.cfar, mode == "fixed", cfar_rank_bits)
    hlen = 2 * hw_stream_lag(p.cfar, p.n_doppler)
    decide = (C.hw_stream_decide_plain if route == "plain"
              else cfar_detect_hw_stream)

    def magnitudes(iq, bypass):
        """The route's magnitude maps for the standalone CFAR: (mag,
        saturation count, non-finite count)."""
        zeros = torch.zeros(iq.shape[0], dtype=torch.int32, device=dev)
        if mode == "fixed":
            mag, sat = _staged_fixed(iq, bypass, p, mti_transient,
                                     window_rounding)
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
            decide=decide)
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
        elif route == "staged" or include_debug:
            mag, sat, nonfinite = magnitudes(iq, bypass)
            if include_debug and route != "plain":
                det, threshold, scale, row_max, n_dets = cfar_rank_group(
                    mag, so, cfar=p.cfar, bits=bits,
                    peak_group_radius=peak_group_radius)
            elif include_debug:
                det, threshold, scale = cfar_rank_plain(mag, so, cfar=p.cfar,
                                                        bits=bits)
                det = C.peak_group(det, peak_group_radius)
            else:
                det, _, row_max, n_dets = cfar_detect_group(
                    mag, so, cfar=p.cfar, peak_group_radius=peak_group_radius)
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

def resolve_array_frontend(frontend: str) -> str:
    """The array model's route: "fused", "staged" or "plain"; "auto" is
    "fused", whatever the configuration.  Unlike JAX's, which falls back to
    its XLA chain, a shape the kernels cannot take is not routed around:
    their wrappers raise ``NotImplementedError`` on the card."""
    return resolve_frontend("float32", frontend)


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
    without one); pass "cpu" for the plain path."""
    p = params or RadarParams()
    dev = resolve_device(device)
    C.check_supported(p.cfar)
    route = resolve_array_frontend(frontend)
    BF.steering_matrix(n_elems, n_beams, spacing_wl, max_angle_deg, taper)
    nr, nd, nb = p.n_range, p.n_doppler, n_beams
    max_dets = p.tracker.max_dets
    plain = route == "plain"
    tf_kw = dict(notch_mode=p.notch_mode, transient=mti_transient,
                 exact_mag=magnitude_exact)
    range_fft = F.range_fft_float_plain if plain else F.range_fft_float
    detect = F.slowtime_detect_plain if plain else F.slowtime_detect
    cfar3d = cfar3d_detect_plain if plain else cfar3d_detect
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
        if route == "staged":
            mag = _staged_float(br, bi, bypass, p, mti_transient,
                                magnitude_exact).reshape(batch, nb, nr, nd)
            nonfinite = (~torch.isfinite(mag)).sum(dim=(-2, -1))
            if ref_angle == 0:
                det, _, rmax, ndet = cfar_detect_group(
                    mag, so, cfar=p.cfar, peak_group_radius=peak_group_radius)
                row_max = rmax.reshape(batch, nb * nr)
                n_dets = ndet.sum(dim=1)
            else:
                det, _ = cfar3d_detect(mag, so, cfar=p.cfar,
                                       ref_angle=ref_angle,
                                       guard_angle=guard_angle)
                det = C.peak_group(det, peak_group_radius)
        elif ref_angle == 0:
            # Per-beam 2D decision with in-kernel grouping.
            det, mag, rmax, ndet, nonfinite = detect(
                *range_fft(br, bi), bypass, so, cfar=p.cfar,
                peak_group_radius=peak_group_radius, emit_mag=include_maps,
                **tf_kw)
            row_max = rmax.reshape(batch, nb * nr)
            n_dets = ndet.reshape(batch, nb).sum(dim=1)
        else:
            # The front end alone, feeding the 3D CFAR.
            re, im = range_fft(br, bi)
            if plain:
                mag = F.slowtime_mag_plain(re, im, bypass, **tf_kw)
                nonfinite = (~torch.isfinite(mag)).sum(dim=(-2, -1))
            else:
                mag, nonfinite = F.slowtime_mag(re, im, bypass, **tf_kw)
            det, _ = cfar3d(mag.reshape(batch, nb, nr, nd), so,
                            cfar=p.cfar, ref_angle=ref_angle,
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
