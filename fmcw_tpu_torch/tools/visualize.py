"""End-to-end demo CLI: the tactical scenario through the radar processor
and the TWS tracker, reference-format logs, analysis PNGs and the
staggered-PRF velocity unfolding.

    python -m fmcw_tpu_torch.tools.visualize [--quick|--full] [--scans N]
        [--out DIR] [--cpu] [--sharded SP] [--mode float32|fixed]
        [--array E] [--faithful] [--hw-compat] [--iq-file BIN]
        [--record BIN]
    python -m fmcw_tpu_torch.tools.visualize --logs DIR   # re-render only

Port of ``tools/visualize.py``, with its flags, logs and printed lines.  It
runs on the card; ``--cpu`` runs the processor and the tracker on the CPU
(the plain PyTorch path) instead, and without it the tool raises where
there is no card.  ``--sharded SP`` runs the sharded processor on a
``LocalMesh(dp=1, sp=SP)``: every shard on the one device, in this
process.  ``--iq-file`` reads raw int16 frames through the port's
``runtime/native.FileFrameStreamer`` (host memory; the processor copies
each frame to the device).

``run_demo`` is the run itself (scenario -> processor -> ``tracker.step``
-> logs -> unfolding) and returns a summary; ``main`` calls it and then
renders the PNGs with ``utils/viz.render`` (matplotlib, imported there
only).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..device import resolve_device


def check_options(array: int = 0, sharded: int = 0, hw_compat: bool = False,
                  mode: str = "float32", iq_file=None, record=None) -> None:
    """The option combinations the demo refuses (ValueError), as
    ``tools/visualize.py``'s ``ap.error`` calls."""
    if hw_compat and (array or sharded):
        raise ValueError("--hw-compat is single-device by design (the "
                         "as-built streaming semantics are one sequential "
                         "stream)")
    if array and (iq_file or record or mode != "float32"):
        raise ValueError("--array is float32/synthetic-scenario only "
                         "(no --iq-file/--record/--mode fixed)")


def demo_params(quick: bool = True):
    """The demo's RadarParams: quick() with the demo CFAR geometry (the
    guard band covers the scenario's +-2-bin target spread, else the
    training cells self-mask), or full()."""
    import fmcw_tpu_torch as P
    if not quick:
        return P.full()
    return P.quick().replace(cfar=P.CfarParams(
        ref_range=4, ref_doppler=3, guard_range=2, guard_doppler=1))


def _to_numpy(out: dict, keys) -> dict:
    return {k: out[k].cpu().numpy() for k in keys if k in out}


def run_demo(quick: bool = True, scans: int | None = None,
             out: str = "demo_out", mode: str = "float32", array: int = 0,
             faithful: bool = False, hw_compat: bool = False,
             sharded: int = 0, iq_file: str | None = None,
             record: str | None = None, device=None, echo=print) -> dict:
    """Run the demo: frames (the tactical scenario, its element-space
    variant with ``array``, or ``iq_file``) through the processor the
    options name, ``tracker.step`` a scan, the detection and track logs in
    ``out`` (tac_detections.txt, tac_tracks.txt), and the staggered-PRF
    unfolding of each track's raw per-PRF detection bins.  ``echo`` prints
    the per-scan lines.  ``device``: None means CUDA (raises without one).

    Returns a summary: scans, seconds, scans_per_s, velocities {track:
    (v_mps, residual_mps)}, velocity_lines and azimuth_lines (the lines
    ``main`` prints after rendering), det_log, trk_log, last_map (numpy),
    params and notch_scan."""
    check_options(array, sharded, hw_compat, mode, iq_file, record)
    dev = resolve_device(device)
    from ..models import pipeline as pl, scenario as sc, tracker as trk
    from ..utils import ambiguity as amb, io as rio, viz

    p = demo_params(quick)
    cfg = sc.quick_scenario() if quick else sc.ScenarioConfig()
    cfg.burst_synthesis = faithful
    if scans:
        cfg.num_scans = scans
    os.makedirs(out, exist_ok=True)
    det_log = os.path.join(out, "tac_detections.txt")
    trk_log = os.path.join(out, "tac_tracks.txt")
    open(det_log, "w").close()
    open(trk_log, "w").close()

    if array or sharded:
        from ..parallel import LocalMesh, sharded as sh

        def first(fn):
            return lambda iq: {k: v[0] for k, v in fn(iq[None]).items()}
    if array:
        if sharded:
            proc = first(sh.make_sharded_array_processor(
                LocalMesh(1, sharded, dev), p, n_elems=array, n_beams=array,
                include_maps=True, peak_group_radius=2, beam_group_radius=1))
            echo(f"array mesh: {array} beams over dp=1 sp={sharded} on "
                 f"{dev.type}")
        else:
            proc = pl.make_array_processor(p, n_elems=array, n_beams=array,
                                           peak_group_radius=2,
                                           beam_group_radius=1, device=dev)
            echo(f"array single device ({array} elems -> {array} beams): "
                 f"{dev}")
    elif sharded:
        proc = first(sh.make_sharded_processor(
            LocalMesh(1, sharded, dev), p, mode=mode, peak_group_radius=2,
            include_maps=True))
        echo(f"mesh: dp=1 sp={sharded} on {dev.type}")
    elif hw_compat:
        hproc = pl.make_processor(p, mode=mode, cfar_geometry="hw_stream",
                                  peak_group_radius=2, include_maps=True,
                                  device=dev)
        hw_carry = {"hist": None}

        def proc(iq):
            res, hw_carry["hist"] = hproc.stream(iq, hist=hw_carry["hist"])
            return res

        echo(f"single device, hw-compat streaming CFAR: {dev}")
    else:
        proc = pl.make_processor(p, mode=mode, peak_group_radius=2,
                                 device=dev)
        echo(f"single device: {dev}")

    streamer = None
    if iq_file:
        from ..runtime.native import FileFrameStreamer
        streamer = FileFrameStreamer(iq_file, (p.n_doppler, p.n_range, 2))
        frames_iter = ((scan, iq, ())
                       for scan, iq in enumerate(streamer.frames(), 1))
        cfg.num_scans = 0      # unknown until the file drains: no notch
    elif array:
        frames_iter = ((scan, pl.complex_to_iq(frames), truth)
                       for scan, frames, truth in
                       sc.TacticalScenario(p, cfg).run_elements(array))
    else:
        frames_iter = ((scan, pl.complex_to_iq(frame), truth)
                       for scan, frame, truth in
                       sc.TacticalScenario(p, cfg).run())
    state = trk.init_state(p.tracker, device=dev)
    t0 = time.perf_counter()
    last_map = None
    n_scans = 0
    # Per-track raw detection Doppler bins keyed by PRF index: the
    # unfolder needs the measured bin at each PRF, not the tracker's
    # alpha-filtered position (which blends bins across the stagger).
    raw_bins: dict[int, dict[int, float]] = {}
    # Array mode: per-track associated detection beams (azimuth estimate).
    track_beams: dict[int, list] = {}
    rec = open(record, "wb") if record else None
    try:
        for scan, iq, truth in frames_iter:
            n_scans = scan
            if rec is not None:
                np.ascontiguousarray(iq, dtype=np.int16).tofile(rec)
            res = proc(torch.as_tensor(iq))
            last_map = res.get("mag_map", res.get("mag_cube"))
            state, rep = trk.step(state, res["range_bin"],
                                  res["doppler_bin"], res["mag"],
                                  res["valid"], tp=p.tracker)
            o = _to_numpy(res, ("range_bin", "doppler_bin", "mag", "valid",
                                "beam_bin"))
            rep = _to_numpy(rep, ("range_pos", "dopp_pos", "range_vel",
                                  "quality", "status", "report_mask",
                                  "active_tracks"))
            v = o["valid"]
            rio.write_detections(det_log, o["range_bin"][v],
                                 o["doppler_bin"][v], o["mag"][v],
                                 append=True)
            ids = np.nonzero(rep["report_mask"])[0]
            # Associate each reported track with this scan's nearest raw
            # detection within the tracker's gate, and keep its measured
            # Doppler bin under this scan's PRF index.
            if np.any(v):
                det_r = o["range_bin"][v].astype(np.float64)
                det_d = o["doppler_bin"][v].astype(np.float64)
                prf_idx = (scan - 1) % len(cfg.prf_hz)
                for i in ids:
                    # Undo the tracker's 12/9-bit Q2 register wrap.
                    tr = float(viz.unwrap_range_q2(rep["range_pos"][i],
                                                   p.n_range)) / 4.0
                    td = float(viz.unwrap_dopp_q2(rep["dopp_pos"][i],
                                                  p.n_doppler)) / 4.0
                    dist = np.abs(det_r - tr) + np.abs(det_d - td)
                    j = int(np.argmin(dist))
                    if (abs(det_r[j] - tr) <= p.tracker.assoc_gate_r
                            and abs(det_d[j] - td) <= p.tracker.assoc_gate_d):
                        raw_bins.setdefault(int(i), {})[prf_idx] = det_d[j]
                        if array:
                            track_beams.setdefault(int(i), []).append(
                                int(o["beam_bin"][v][j]))
            rio.write_tracks(trk_log, [
                {"id": i, "range_pos": rep["range_pos"][i],
                 "dopp_pos": rep["dopp_pos"][i],
                 "range_vel": rep["range_vel"][i],
                 "quality": rep["quality"][i], "status": rep["status"][i]}
                for i in ids], active_count=int(rep["active_tracks"]),
                append=True)
            echo(f"scan {scan:3d}: dets={int(np.sum(v)):3d} "
                 f"tracks={int(rep['active_tracks']):2d} "
                 f"truth={len(truth)}")
    finally:
        if rec is not None:
            rec.close()
        if streamer is not None:
            streamer.close()
    if rec is not None:
        echo(f"recorded {n_scans} frames to {record}")
    dt = time.perf_counter() - t0
    echo(f"{n_scans} scans in {dt:.1f}s ({n_scans / max(dt, 1e-9):.1f} "
         f"scans/s)")
    if last_map is not None:
        last_map = last_map.cpu().numpy()
        if last_map.ndim == 3:
            # Array mode: the strongest beam's range-Doppler map.
            last_map = last_map[int(np.argmax(last_map.max(axis=(1, 2))))]

    # Staggered-PRF velocity unfolding (utils/ambiguity.py) of the raw
    # per-PRF detection bins associated above.  The tracker gates in bin
    # space (as the reference), so a target whose Doppler bin hops more
    # than assoc_gate_d across the stagger holds no track to unfold.
    quant = max(cfg.prf_hz) * cfg.wavelength / 2.0 / p.n_doppler
    velocities, velocity_lines = {}, []
    for tid in sorted(raw_bins):
        meas = raw_bins[tid]
        if len(meas) < 2:
            continue
        idx = sorted(meas)
        vel, resid = amb.unfold_velocity(
            [meas[i] for i in idx], [cfg.prf_hz[i] for i in idx],
            p.n_doppler, wavelength=cfg.wavelength, centered=True)
        velocities[tid] = (vel, resid)
        flag = "" if resid <= 1.5 * quant else "  [low confidence]"
        velocity_lines.append(
            f"track {tid:2d}: radial {vel:+7.1f} m/s "
            f"({vel * 1.94384:+7.1f} kts, stagger residual {resid:.1f} m/s)"
            f"{flag}")
    azimuth_lines = []
    if array and track_beams:
        # Beam index -> steering sine -> azimuth (ops/beamform's steering
        # grid at the model's default 60-degree span).
        u = np.linspace(-np.sin(np.deg2rad(60.0)), np.sin(np.deg2rad(60.0)),
                        array)
        azimuth_lines.append("track azimuth estimates (modal detection "
                             "beam):")
        for tid in sorted(track_beams):
            beams = np.asarray(track_beams[tid])
            b = int(np.bincount(beams, minlength=array).argmax())
            az = float(np.degrees(np.arcsin(u[b])))
            azimuth_lines.append(f"track {tid:2d}: beam {b} -> azimuth "
                                 f"{az:+6.1f} deg ({len(beams)} scans)")
    return {"scans": n_scans, "seconds": dt,
            "scans_per_s": n_scans / max(dt, 1e-9),
            "velocities": velocities, "velocity_lines": velocity_lines,
            "azimuth_lines": azimuth_lines, "det_log": det_log,
            "trk_log": trk_log, "last_map": last_map, "params": p,
            "notch_scan": cfg.notch_scan}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fmcw_tpu_torch.tools.visualize",
        description="End-to-end demo: tactical scenario -> processor -> TWS "
                    "tracker -> reference-format logs -> PNGs")
    ap.add_argument("--quick", action="store_true", default=True)
    ap.add_argument("--full", dest="quick", action="store_false",
                    help="full 1024x128 resolution, 120 scans")
    ap.add_argument("--scans", type=int, default=None)
    ap.add_argument("--out", default="demo_out")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain PyTorch path; default: "
                         "the card)")
    ap.add_argument("--sharded", type=int, default=0, metavar="SP",
                    help="run the sp-sharded processor on a LocalMesh "
                         "(dp=1, sp=SP) on the one device")
    ap.add_argument("--mode", default="float32", choices=["float32", "fixed"])
    ap.add_argument("--array", type=int, default=0, metavar="E",
                    help="array-radar mode: E-element ULA scenario through "
                         "the beamformed pipeline (E beams); tracks gain "
                         "an azimuth estimate from their detections' beams")
    ap.add_argument("--faithful", action="store_true",
                    help="reference-faithful burst target synthesis "
                         "(tb_tactical.vhd:252-266) instead of point targets")
    ap.add_argument("--hw-compat", action="store_true",
                    help="as-built streaming CFAR (cfar_geometry="
                         "'hw_stream'): crossed-axis geometry, startup "
                         "skip, hardware label coordinates; frames drive "
                         "the stateful proc.stream so inter-frame bleed "
                         "matches the real hardware")
    ap.add_argument("--logs", default=None,
                    help="skip processing; render existing logs in DIR")
    ap.add_argument("--iq-file", default=None, metavar="BIN",
                    help="process recorded frames (raw int16 I/Q, one "
                         "(n_doppler, n_range, 2) frame after another) "
                         "through the native streaming loader instead of "
                         "the synthetic scenario")
    ap.add_argument("--record", default=None, metavar="BIN",
                    help="also append every processed frame's raw int16 I/Q "
                         "to BIN (replayable later with --iq-file)")
    args = ap.parse_args(argv)
    from ..utils import viz

    if args.logs:
        files = viz.render(
            det_path=os.path.join(args.logs, "tac_detections.txt"),
            trk_path=os.path.join(args.logs, "tac_tracks.txt"),
            out_prefix=os.path.join(args.logs, "radar"))
        print("rendered:", ", ".join(files))
        return 0
    try:
        check_options(args.array, args.sharded, args.hw_compat, args.mode,
                      args.iq_file, args.record)
    except ValueError as e:
        ap.error(str(e))
    # Raises here, before any work, where the card is asked for and absent.
    device = resolve_device("cpu" if args.cpu else None)
    res = run_demo(quick=args.quick, scans=args.scans, out=args.out,
                   mode=args.mode, array=args.array, faithful=args.faithful,
                   hw_compat=args.hw_compat, sharded=args.sharded,
                   iq_file=args.iq_file, record=args.record, device=device)
    p = res["params"]
    files = viz.render(det_path=res["det_log"], trk_path=res["trk_log"],
                       mag_map=res["last_map"],
                       out_prefix=os.path.join(args.out, "radar"),
                       n_range=p.n_range, n_doppler=p.n_doppler,
                       notch_scan=res["notch_scan"])
    print("rendered:", ", ".join(files))
    for line in res["velocity_lines"] + res["azimuth_lines"]:
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
