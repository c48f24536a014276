"""Single-device radar pipeline — the port's "model".

Port of ``fmcw_tpu/models/pipeline.py`` for the float32 main path:

    window -> range FFT -> corner turn -> MTI -> window -> Doppler FFT
           -> magnitude -> 2D OS-CFAR -> peak group -> top-K detections

On the card the chain up to the grouped detection map is two CUDA kernels
(``ops/frontend.py``: ``range_fft`` then ``slowtime_detect``); the top-K
selection is a stable PyTorch sort fed by the kernel's per-row maxima.  On
the CPU the same wrappers take their plain PyTorch twins.

Runtime controls (``mti_bypass``, ``scale_override``) are call arguments —
the radar_core control ports (rtl/src/radar_core.vhd:48-49).

Not yet ported (they raise ``NotImplementedError``): ``mode="fixed"``, the
CA/GO/SO variants and reflect edges; on the kernels also long CPIs
(n_doppler > 128).  The hw-compat streaming CFAR, the array model and
sharding are not here yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..params import RadarParams
from ..ops import cfar as C, detect as DET
from ..ops.frontend import rdm_frontend_detect


def complex_to_iq(frame: np.ndarray) -> np.ndarray:
    """Pack a complex frame into the ingest format: int16 (..., 2) I/Q pairs
    (== the reference's 32-bit interleaved s_axis_tdata, radar_core.vhd:26)."""
    z = np.asarray(frame)
    return np.stack([z.real, z.imag], axis=-1).astype(np.int16)


def _resolve_device(device=None) -> torch.device:
    """The device a processor runs on: CUDA unless the caller names another.
    Raises when CUDA is asked for (or implied) and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fmcw_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' for the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def make_batch_processor(params: RadarParams | None = None,
                         mode: str = "float32", frontend: str = "auto",
                         mti_transient: str = "zero",
                         peak_group_radius: int = 0,
                         magnitude_exact: bool = False,
                         include_maps: bool = True,
                         include_debug: bool = False,
                         device=None) -> Callable:
    """Multi-frame processor: iq int16 (batch, n_doppler, n_range, 2)
    (numpy or tensor) -> dict of batched outputs.  The whole batch goes
    through each kernel in one launch.

    Returned callable: ``fn(iq, mti_bypass=False, scale_override=0) -> dict``
    with, as ``fmcw_tpu.models.pipeline.make_processor``'s output and a
    leading batch axis on every entry:

      range_bin/doppler_bin/mag/valid  top-K detection arrays (max_dets,)
      n_dets            total CFAR detection count
      saturation_count  0 (float mode)
      nonfinite_count   NaN/Inf cells in the magnitude map
      mag_map, det_map  (n_range, n_doppler)     [if include_maps]
      threshold_map, scale_map  CFAR debug taps  [if include_debug]

    ``device``: None means "cuda" (raises without one); pass "cpu" for the
    plain path.  ``frontend``: "auto" runs the kernel wrappers (the CUDA
    kernels on a CUDA device, their plain twins on the CPU); "plain" runs
    the plain twins on ``device`` — the reference the kernels are held
    against, and the only path with debug taps.
    """
    p = params or RadarParams()
    dev = _resolve_device(device)
    if mode != "float32":
        raise NotImplementedError(
            f"mode={mode!r}: the port implements mode='float32' only so far "
            f"(fixed mode is queued in ROADMAP.md)")
    if frontend not in ("auto", "plain"):
        raise ValueError(f"frontend must be 'auto' or 'plain', got "
                         f"{frontend!r}")
    C.check_supported(p.cfar)
    if include_debug and frontend != "plain":
        raise ValueError("include_debug (threshold/scale taps) needs "
                         "frontend='plain': the kernels decide by counting "
                         "and compute no threshold")
    max_dets = p.tracker.max_dets

    def process(iq, mti_bypass=False, scale_override=0) -> dict:
        if tuple(iq.shape[1:]) != (p.n_doppler, p.n_range, 2):
            raise ValueError(
                f"expected iq batch of shape (batch, {p.n_doppler}, "
                f"{p.n_range}, 2), got {tuple(iq.shape)}")
        iq = torch.as_tensor(iq).to(dev)
        det, mag, nonfinite, row_max, n_dets = rdm_frontend_detect(
            iq, bool(mti_bypass), int(scale_override), cfar=p.cfar,
            notch_mode=p.notch_mode, transient=mti_transient,
            exact_mag=magnitude_exact, peak_group_radius=peak_group_radius,
            emit_mag=include_maps or include_debug,
            plain=frontend == "plain")
        out = DET.topk_detections(det, max_dets=max_dets, row_max=row_max,
                                  n_dets=n_dets)
        out["saturation_count"] = torch.zeros_like(n_dets)
        out["nonfinite_count"] = nonfinite
        if include_maps:
            out["mag_map"] = mag
            out["det_map"] = det
        if include_debug:
            _, threshold, scale = C.cfar_2d(mag, int(scale_override), p.cfar,
                                            need_debug=True)
            out["threshold_map"] = threshold
            out["scale_map"] = scale
        return out

    return process


def make_processor(params: RadarParams | None = None, **kw) -> Callable:
    """Single-frame processor: ``fn(iq, mti_bypass=False, scale_override=0)``
    with iq int16 (n_doppler, n_range, 2); the keywords and outputs of
    ``make_batch_processor`` without the batch axis."""
    p = params or RadarParams()
    batched = make_batch_processor(p, **kw)

    def process(iq, mti_bypass=False, scale_override=0) -> dict:
        # Strict single-frame shape: a batch would pass a trailing-dims check.
        if tuple(iq.shape) != (p.n_doppler, p.n_range, 2):
            raise ValueError(
                f"expected iq frame of shape (n_doppler={p.n_doppler}, "
                f"n_range={p.n_range}, 2), got {tuple(iq.shape)}")
        out = batched(iq[None], mti_bypass, scale_override)
        return {k: v[0] for k, v in out.items()}

    return process
