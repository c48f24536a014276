"""Surveillance runtime: scan-rate frame batching + tracker loop.

BASELINE config 5 ("many-frame batch (tracking-rate) throughput"): frames
arrive at kHz rates while the tracker runs at scan rate (~Hz).  This runtime
ties the pieces together for a long-running air picture:

* frames are processed in device batches (single-chip batch processor or the
  sharded multi-chip processor) — one dispatch covers many scans' CPIs;
* the tracker consumes one frame's detections per scan, advancing its carried
  pytree state (host-side step per scan; the tracker costs microseconds next
  to the frame pipeline);
* detection/track logs stream out in the reference text formats, so
  model/visualize_radar_targets.py-style analysis works on the output.

The port of ``fmcw_tpu/runtime/surveillance.py``: the same batching, logs,
checkpoint boundary, watchdog and health lines, driving the port's
processors (``make_batch_processor``, ``make_batch_array_processor`` and
the sharded processors, which gather their dp blocks themselves).  The
detections come back to the host inside the watchdog's dispatch, and the
magnitudes are converted to int32 there with numpy, as JAX does
(``.astype(np.int32)``: INT_MIN for a float beyond int32), before the
tracker (``models/tracker.run_scans``, on ``device``) steps the batch's
scans.  ``run_surveillance_stream`` is the hw-compat streaming runner: one
CPI at a time through a ``cfar_geometry="hw_stream"`` processor's
``stream``, the CFAR's line-buffer carry (``stream_hist``) kept between
scans and checkpointable beside the tracker state.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from ..device import resolve_device
from ..params import RadarParams
from ..models import tracker as jt
from ..utils import io as rio


def _to_host(a) -> np.ndarray:
    """A tensor (on any device) or array -> host numpy.  The sharded
    processors return every dp block already gathered, so each rank drives
    the same tracker state and writes identical logs."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


def _state_on(state: dict, device: torch.device) -> dict:
    """A tracker state of numpy arrays or tensors as int32 tensors on
    ``device``."""
    if all(isinstance(v, torch.Tensor) for v in state.values()):
        return {k: v.to(device=device, dtype=torch.int32)
                for k, v in state.items()}
    return jt.state_from_numpy(state, device)


class SurveillanceStallError(RuntimeError):
    """A frame-batch dispatch (or its device->host readback) exceeded the
    watchdog timeout — the runtime analog of the reference testbenches'
    cycle-count watchdog processes (tb_radar_core.vhd:136-146), which abort
    a hung simulation instead of blocking forever."""


def _with_watchdog(fn: Callable, timeout: float | None, what: str):
    """Run ``fn`` under a wall-clock watchdog.  On timeout the stalled call
    keeps running on a daemon thread (a hung device call cannot be
    cancelled), but the runtime surfaces SurveillanceStallError immediately
    so the caller can fail over / restart instead of hanging.  Only None
    disables the watchdog (a zero/near-zero budget still guards — it trips
    unless fn is already done — rather than silently running unguarded)."""
    if timeout is None:
        return fn()
    box: dict = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # surfaced in the caller's thread
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        raise SurveillanceStallError(
            f"{what} exceeded the {timeout:.3g}s watchdog timeout")
    if "error" in box:
        raise box["error"]
    return box["value"]


def _write_scan_logs(det_log: str | None, trk_log: str | None,
                     range_bin, doppler_bin, mag, v, rep) -> None:
    """Append one scan's detections + track reports in the reference text
    formats — the single place the log line layout lives (both the batched
    and the hw-compat streaming runners write through here, so the
    byte-identical-logs resume contract cannot drift between them)."""
    if det_log:
        rio.write_detections(det_log, range_bin[v], doppler_bin[v], mag[v],
                             append=True)
    if trk_log:
        ids = np.nonzero(rep["report_mask"])[0]
        rio.write_tracks(trk_log, [
            {"id": t, "range_pos": rep["range_pos"][t],
             "dopp_pos": rep["dopp_pos"][t],
             "range_vel": rep["range_vel"][t],
             "quality": rep["quality"][t],
             "status": rep["status"][t]} for t in ids],
            active_count=int(rep["active_tracks"]), append=True)


@dataclasses.dataclass
class ScanResult:
    scan: int
    n_dets: int
    active_tracks: int
    report: dict
    tracker_state: dict | None  # populated on each batch's final scan (the
    # checkpoint boundary — utils.checkpoint); None on intermediate scans
    stream_hist: np.ndarray | None = None  # hw-compat streaming CFAR carry
    # (run_surveillance_stream only): part of the checkpointable runtime
    # state — resuming without it replays the startup-skip transient


def run_surveillance(proc: Callable, frames: Iterable[np.ndarray],
                     params: RadarParams, batch_scans: int = 8,
                     det_log: str | None = None, trk_log: str | None = None,
                     mti_bypass: bool = False, scale_override: int = 0,
                     tracker_state: dict | None = None,
                     start_scan: int = 0,
                     watchdog_timeout: float | None = None,
                     health: Callable[[str], None] | None = None,
                     device=None) -> Iterator[ScanResult]:
    """Drive ``proc`` (a make_batch_processor / make_sharded_processor
    callable) over ``frames``, batching ``batch_scans`` CPIs per dispatch and
    stepping the TWS tracker once per scan.  Yields a ScanResult per scan.

    ``tracker_state``/``start_scan`` allow resuming from a checkpoint
    (utils/checkpoint.py): numpy arrays (a checkpoint of this package or of
    the JAX package) or tensors.  ``tracker_state`` in each batch's last
    ScanResult is numpy, as JAX's.

    ``device``: where the tracker runs (None means CUDA; raises without a
    card — pass "cpu" for the CPU).  The processor keeps its own device.

    ``watchdog_timeout``: wall-clock seconds a single frame-batch dispatch
    (including its device->host readback — where tunnel/device stalls
    surface) may take before the runtime raises SurveillanceStallError
    instead of blocking forever — the TB watchdog analog
    (tb_radar_core.vhd:136-146).  None disables it.  First-dispatch
    compilation counts toward the budget; size it to cover compile time or
    warm the processor first.

    ``health``: optional callback receiving one status line per batch
    (scan counter, detections, active tracks, batch wall time and scan
    rate) — the runtime's live observability tap, mirroring the reference
    TBs' periodic ``report`` progress lines (tb_tactical.vhd:239-244).
    """
    if batch_scans < 1:
        raise ValueError(f"batch_scans must be >= 1, got {batch_scans}")
    tp = params.tracker
    dev = resolve_device(device)
    state = (_state_on(tracker_state, dev) if tracker_state is not None
             else jt.init_state(tp, dev))
    resuming = tracker_state is not None or start_scan > 0
    # A fresh run starts new logs; a resumed run appends to the existing ones.
    if not resuming:
        if det_log:
            open(det_log, "w").close()
        if trk_log:
            open(trk_log, "w").close()

    scan = start_scan
    buf: list[np.ndarray] = []

    def flush(buf):
        nonlocal scan, state
        n_valid = len(buf)
        # Zero-pad the final partial batch: keeps the dispatch shape constant
        # (one compiled executable; sharded processors need batch % dp == 0)
        # at the cost of processing a few dummy frames once per run.
        if n_valid < batch_scans:
            buf = buf + [np.zeros_like(buf[0])] * (batch_scans - n_valid)
        batch = np.stack(buf)
        t0 = time.perf_counter()

        def dispatch():
            o = proc(batch, mti_bypass=mti_bypass,
                     scale_override=scale_override)
            return {k: _to_host(v) for k, v in o.items()}

        out = _with_watchdog(dispatch, watchdog_timeout,
                             f"frame batch ending at scan {scan + n_valid}")
        batch_dt = time.perf_counter() - t0
        # All of the batch's scans advance the tracker in one call
        # (models/tracker.run_scans: on CUDA one graph replay a scan), then
        # reports stream out per scan.  The magnitudes become int32 here,
        # on the host, with numpy, as in JAX (fault 1 of ROADMAP.md).
        state, reps = jt.run_scans(
            out["range_bin"][:n_valid], out["doppler_bin"][:n_valid],
            out["mag"][:n_valid].astype(np.int32), out["valid"][:n_valid],
            tp=tp, state=state)
        reps = {k: _to_host(v) for k, v in reps.items()}
        host_state = jt.state_to_numpy(state)
        if health is not None:
            n_dets_batch = int(out["valid"][:n_valid].sum())
            act = int(reps["active_tracks"][n_valid - 1])
            health(f"HEALTH scans={scan + 1}-{scan + n_valid} "
                   f"dets={n_dets_batch} active={act} "
                   f"batch_s={batch_dt:.3f} "
                   f"scan_rate={n_valid / max(batch_dt, 1e-9):.1f}/s")
        for i in range(n_valid):
            scan += 1
            v = out["valid"][i]
            rep = {k: val[i] for k, val in reps.items()}
            _write_scan_logs(det_log, trk_log, out["range_bin"][i],
                             out["doppler_bin"][i], out["mag"][i], v, rep)
            # tracker_state after intermediate scans is not materialized by
            # the fused scan; expose it on the batch's final scan (the
            # checkpointing boundary).
            st = host_state if i == n_valid - 1 else None
            yield ScanResult(scan=scan, n_dets=int(np.sum(v)),
                             active_tracks=int(rep["active_tracks"]),
                             report=rep, tracker_state=st)

    for f in frames:
        buf.append(f)
        if len(buf) == batch_scans:
            yield from flush(buf)
            buf = []
    if buf:
        yield from flush(buf)


def run_surveillance_stream(proc, frames: Iterable[np.ndarray],
                            params: RadarParams,
                            det_log: str | None = None,
                            trk_log: str | None = None,
                            mti_bypass: bool = False,
                            scale_override: int = 0,
                            tracker_state: dict | None = None,
                            stream_hist: np.ndarray | None = None,
                            start_scan: int = 0,
                            device=None) -> Iterator[ScanResult]:
    """Hw-compat STREAMING surveillance: one CPI at a time through
    ``proc.stream`` (``make_processor(cfar_geometry="hw_stream")``, the
    continuous-stream behaviour of the hardware's free-running CFAR,
    os_cfar_2d.vhd:66-68/130-135), the tracker stepped once a scan
    (``models/tracker.run_scans``, on ``device``: None means CUDA, raising
    without a card; "cpu" for the CPU), logs in the reference text formats
    through ``_write_scan_logs``.  Port of ``fmcw_tpu/runtime/surveillance.
    run_surveillance_stream``.

    The run's state between scans is (tracker_state, scan counter,
    ``stream_hist``, the CFAR's inter-frame line-buffer tail): each
    ScanResult carries the tracker state and ``stream_hist`` as numpy, so
    ``utils.checkpoint.save(..., runtime_state={"stream_hist": ...,
    **checkpoint.log_positions(...)})`` saves all three (a checkpoint of
    this package or of the JAX package), and a run resumed from them
    continues the stream exactly: the same detections, byte-identical
    logs."""
    tp = params.tracker
    dev = resolve_device(device)
    state = (_state_on(tracker_state, dev) if tracker_state is not None
             else jt.init_state(tp, dev))
    hist = None if stream_hist is None else np.asarray(stream_hist)
    # Any carried state means "resuming" (run_surveillance's convention):
    # the existing logs are appended to, not truncated.
    resuming = (tracker_state is not None or stream_hist is not None
                or start_scan > 0)
    if not resuming:
        if det_log:
            open(det_log, "w").close()
        if trk_log:
            open(trk_log, "w").close()
    scan = start_scan
    for f in frames:
        out, hist = proc.stream(f, mti_bypass=mti_bypass,
                                scale_override=scale_override, hist=hist)
        out = {k: _to_host(v) for k, v in out.items()}
        scan += 1
        v = out["valid"]
        state, reps = jt.run_scans(
            out["range_bin"][None], out["doppler_bin"][None],
            out["mag"][None].astype(np.int32), v[None], tp=tp, state=state)
        rep = {k: _to_host(val)[0] for k, val in reps.items()}
        _write_scan_logs(det_log, trk_log, out["range_bin"],
                         out["doppler_bin"], out["mag"], v, rep)
        yield ScanResult(scan=scan, n_dets=int(np.sum(v)),
                         active_tracks=int(rep["active_tracks"]),
                         report=rep, tracker_state=jt.state_to_numpy(state),
                         stream_hist=_to_host(hist))
