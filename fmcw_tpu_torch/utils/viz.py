"""Visualization — the framework's analysis layer (numpy copy of
``fmcw_tpu/utils/viz.py``; the port imports nothing of the JAX package).

Equivalent of model/visualize_radar_targets.py: parses the framework's (or
the reference simulator's) detection/track logs, converts bins to physical
units, and renders the RDM heatmap, track-history, quality and active-count
plots plus the notch-maneuver survival analysis.

Log formats are identical to the reference's (utils/io.py), so this module
works on reference xsim output and the reference visualizer works on ours.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

MAX_RANGE_KM = 120.0
WAVELENGTH_M = 0.1
PRF_HZ = 8000.0
KTS_PER_MPS = 1.94384


def bin_to_km(range_bin, n_range: int) -> np.ndarray:
    """Range bin -> km (model/visualize_radar_targets.py:170-176)."""
    return np.asarray(range_bin, dtype=np.float64) * MAX_RANGE_KM / n_range


def unwrap_range_q2(q2, n_range: int) -> np.ndarray:
    """Undo the tracker's Q2 register wrap for display/analysis.

    The reference's track record stores range as signed(11 downto 0) Q2
    (tws_tracker.vhd:52) — only bins -512..511.75 are representable, so on
    the full 1024-bin map every track beyond bin 512 logs NEGATIVE R=
    values (an as-built quirk the bit-faithful tracker reproduces; the
    reference's checked-in demo ran the 128x32 quick map and never hit
    it).  Bins < 1024 map one-to-one onto the 12-bit space, so the
    analysis layer recovers them exactly: q2 mod (4*n_range)."""
    return np.mod(np.asarray(q2, dtype=np.int64), 4 * n_range)


def unwrap_dopp_q2(q2, n_doppler: int) -> np.ndarray:
    """Doppler twin of unwrap_range_q2: signed(8 downto 0) Q2
    (tws_tracker.vhd:53) wraps bins >= 64 negative on the 128-bin map."""
    return np.mod(np.asarray(q2, dtype=np.int64), 4 * n_doppler)


def doppler_bin_to_mps(dopp_bin, n_doppler: int, prf: float = PRF_HZ,
                       centered: bool = True) -> np.ndarray:
    """Doppler bin -> radial m/s: v = (bin - N/2) * PRF * lambda / (2N)
    (model/visualize_radar_targets.py:417-423).  ``centered=False`` for
    natural-order bins (no +N/2 offset).  One implementation shared with
    the PRF unfolder (utils/ambiguity.apparent_velocity)."""
    from .ambiguity import apparent_velocity
    return apparent_velocity(dopp_bin, n_doppler, prf,
                             wavelength=WAVELENGTH_M, centered=centered)


@dataclasses.dataclass
class TrackHistory:
    scans: list
    range_q2: list
    dopp_q2: list
    vel_r: list
    quality: list
    status: list


def load_detections(path: str) -> np.ndarray:
    """Parse "range doppler mag" lines -> (N, 3) int array."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 3:
                rows.append([int(x) for x in parts])
    return np.asarray(rows, dtype=np.int64).reshape(-1, 3)


_TRK_RE = re.compile(
    r"TRK\s+(\d+)\s+R=(-?\d+)\s+D=(-?\d+)(?:\s+VR=(-?\d+))?\s+Q=(\d+)"
    r"(?:\s+S=(\d+))?")


def load_tracks(path: str):
    """Parse TRK/SCAN_END lines (tb_tactical.vhd:344-365 format) ->
    ({trk_id: TrackHistory}, [active_count per scan])."""
    tracks: dict[int, TrackHistory] = {}
    scan_counts = []
    scan = 0
    with open(path) as f:
        for line in f:
            m = _TRK_RE.match(line.strip())
            if m:
                tid = int(m.group(1))
                t = tracks.setdefault(tid, TrackHistory([], [], [], [], [], []))
                t.scans.append(scan)
                t.range_q2.append(int(m.group(2)))
                t.dopp_q2.append(int(m.group(3)))
                t.vel_r.append(int(m.group(4) or 0))
                t.quality.append(int(m.group(5)))
                t.status.append(int(m.group(6) or 0, 2) if m.group(6) else 0)
            elif line.startswith("SCAN_END"):
                scan_counts.append(int(line.split("ACTIVE=")[1]))
                scan += 1
    return tracks, scan_counts


def resolve_track_velocities(tracks: dict, n_doppler: int,
                             prfs=(8000.0, 9000.0, 10000.0),
                             wavelength: float = WAVELENGTH_M,
                             v_max: float = 1200.0) -> dict:
    """Unambiguous radial velocity per track from the scan-staggered PRFs
    (utils/ambiguity.py — the resolution step the reference's stagger
    exists for but its visualizer never performs).  Scan s (0-based, the
    load_tracks counter) used PRF ``prfs[s % len(prfs)]`` — matching
    models/scenario's 1-based ``prf_hz[(scan - 1) % 3]``.

    CAVEATS — this is the log-only estimate: track positions are
    alpha-filtered, so each "per-PRF" sample blends bins measured at
    different PRFs (expect a few bins of bias; prefer raw per-scan
    detection bins when available — the port's ``tools/visualize.py``
    does that in its live loop).  And the tracker gates in bin space
    (reference-faithful, assoc_gate_d bins), so targets whose bin hops across the stagger
    exceed the gate never hold a track to unfold.  Returns
    ``{trk_id: (v_mps, residual_mps)}`` for tracks seen at >= 2 distinct
    PRFs (large residuals flag stagger-inconsistent estimates)."""
    from .ambiguity import unfold_velocity

    out = {}
    for tid, t in tracks.items():
        latest = {}
        for s, dq2 in zip(t.scans, t.dopp_q2):
            # Q2 -> bins, undoing the 9-bit register wrap (bins >= 64 log
            # negative on the full map — unwrap_dopp_q2).
            latest[s % len(prfs)] = float(
                unwrap_dopp_q2(dq2, n_doppler)) / 4.0
        if len(latest) < 2:
            continue
        idx = sorted(latest)
        out[tid] = unfold_velocity([latest[i] for i in idx],
                                   [prfs[i] for i in idx], n_doppler,
                                   wavelength=wavelength, v_max=v_max)
    return out


def notch_analysis(tracks: dict, scan_counts: list, notch_scan: int) -> dict:
    """Notch-maneuver survival analysis (visualize_radar_targets.py:324-366):
    how many tracks survive (coast) through the notch window vs drop."""
    survived, lost = 0, 0
    for tid, t in tracks.items():
        before = any(s < notch_scan for s in t.scans)
        during_or_after = any(s >= notch_scan + 3 for s in t.scans)
        if before:
            if during_or_after:
                survived += 1
            else:
                lost += 1
    # Guard both ends: a notch in the first two scans has no "before"
    # sample (a negative index would silently wrap to the END of the run),
    # and the 3-scan notch window needs scans through notch_scan+2.
    pre = notch_scan - 2
    active_before = scan_counts[pre] if 0 <= pre < len(scan_counts) else 0
    active_during = (min(scan_counts[notch_scan:notch_scan + 3])
                     if len(scan_counts) >= notch_scan + 3 else 0)
    return {"tracks_survived": survived, "tracks_lost": lost,
            "active_before_notch": active_before,
            "min_active_during_notch": active_during}


def render(det_path: str | None = None, trk_path: str | None = None,
           mag_map: np.ndarray | None = None, out_prefix: str = "radar",
           n_range: int = 1024, n_doppler: int = 128,
           notch_scan: int | None = None) -> list[str]:
    """Render PNGs (detection map, track history, quality/active plots).
    Returns the list of files written."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    written = []

    if mag_map is not None or det_path:
        fig, ax = plt.subplots(figsize=(10, 6))
        if mag_map is not None:
            db = 20 * np.log10(np.maximum(np.asarray(mag_map, float), 1.0))
            im = ax.imshow(db.T, aspect="auto", origin="lower",
                           cmap="viridis",
                           extent=[0, MAX_RANGE_KM, 0, n_doppler])
            fig.colorbar(im, ax=ax, label="magnitude (dB)")
        if det_path:
            d = load_detections(det_path)
            if len(d):
                ax.scatter(bin_to_km(d[:, 0], n_range), d[:, 1], s=12,
                           c="red", marker="x", label=f"{len(d)} detections")
                ax.legend()
        ax.set_xlabel("range (km)")
        ax.set_ylabel("Doppler bin")
        ax.set_title("Range-Doppler map")
        path = f"{out_prefix}_detections.png"
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        written.append(path)

    if trk_path:
        tracks, scan_counts = load_tracks(trk_path)
        fig, axes = plt.subplots(1, 3, figsize=(16, 5))
        colors = plt.cm.tab10(np.linspace(0, 1, 10))
        for tid, t in tracks.items():
            km = bin_to_km(unwrap_range_q2(t.range_q2, n_range) / 4.0,
                           n_range)
            axes[0].plot(t.scans, km, ".-", color=colors[tid % 10],
                         label=f"T{tid}")
            axes[1].plot(t.scans, t.quality, ".-", color=colors[tid % 10])
        axes[0].set_xlabel("scan"); axes[0].set_ylabel("range (km)")
        axes[0].set_title("Track range history")
        if len(tracks) <= 10:
            axes[0].legend(fontsize=7)
        axes[1].set_xlabel("scan"); axes[1].set_ylabel("quality")
        axes[1].set_title("Track quality")
        axes[2].step(range(len(scan_counts)), scan_counts, where="mid")
        axes[2].set_xlabel("scan"); axes[2].set_ylabel("active tracks")
        axes[2].set_title("Active track count")
        if notch_scan:
            for ax in axes:
                ax.axvspan(notch_scan, notch_scan + 3, alpha=0.15, color="red")
            info = notch_analysis(tracks, scan_counts, notch_scan)
            fig.suptitle(
                f"notch: {info['tracks_survived']} survived / "
                f"{info['tracks_lost']} lost", fontsize=10)
        path = f"{out_prefix}_tracks.png"
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        written.append(path)

    return written
