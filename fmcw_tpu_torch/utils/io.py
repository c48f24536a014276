"""Golden-file readers and detection/track log writers.

Text formats follow the reference exactly so the reference's Python analysis
layer (model/visualize_radar_targets.py) can consume this framework's output:

* input chirp:  "I Q" int16 pairs per line        (data/golden_input_chirp.txt)
* RDM map:      "range doppler 0 0 mag" per line  (data/radar_output.txt,
                written by rtl/old/tb_radar_core.vhd:173-208 — the two zero
                columns are unused fields of the v3 monitor)
* detections:   "range doppler mag" per line      (tb_tactical.vhd:331-342)
* tracks:       "TRK id R= D= VR= Q= S=" lines and "SCAN_END ACTIVE=n"
                (tb_tactical.vhd:344-365)

A copy of ``fmcw_tpu/utils/io.py`` (numpy only), so that the port's logs
are byte-identical to the JAX package's.  The golden-file accessors read
the reference design's ``data/`` directory: ``FMCW_REFERENCE_DATA`` names
it (default ``reference/data`` under the working directory).
"""

from __future__ import annotations

import os

import numpy as np

REFERENCE_DATA = os.environ.get("FMCW_REFERENCE_DATA", "reference/data")


def read_iq_pairs(path: str) -> np.ndarray:
    """Read an "I Q" pairs file into a complex128 array of int16 values."""
    d = np.loadtxt(path, dtype=np.int64)
    return d[:, 0].astype(np.float64) + 1j * d[:, 1].astype(np.float64)


def read_rdm_map(path: str, n_range: int = 1024, n_doppler: int = 128) -> np.ndarray:
    """Read a "range doppler [0 0] mag" map file into an (n_range, n_doppler)
    int64 array.  Later duplicate cells win (multi-CPI logs overwrite)."""
    d = np.loadtxt(path, dtype=np.int64)
    m = np.zeros((n_range, n_doppler), dtype=np.int64)
    m[d[:, 0], d[:, 1]] = d[:, -1]
    return m


def golden_input_chirp() -> np.ndarray:
    return read_iq_pairs(os.path.join(REFERENCE_DATA, "golden_input_chirp.txt"))


def golden_output_map() -> np.ndarray:
    return read_rdm_map(os.path.join(REFERENCE_DATA, "radar_output.txt"))


def write_rdm_map(path: str, mag_map: np.ndarray) -> None:
    """Write the full map in the golden v3 monitor format (range-major,
    Doppler-fast stream order, two zero filler columns)."""
    m = np.asarray(mag_map)
    with open(path, "w") as f:
        for r in range(m.shape[0]):
            for d in range(m.shape[1]):
                f.write(f"{r} {d} 0 0 {int(m[r, d])}\n")


def write_detections(path: str, range_bins, doppler_bins, mags,
                     append: bool = False) -> None:
    """Append detection triplets in the tactical log format."""
    with open(path, "a" if append else "w") as f:
        for r, d, m in zip(range_bins, doppler_bins, mags):
            f.write(f"{int(r)} {int(d)} {int(m)}\n")


def write_tracks(path: str, tracks, active_count: int | None = None,
                 append: bool = False) -> None:
    """Append track reports for one scan.

    ``tracks``: iterable of dicts with keys id, range_pos, dopp_pos, range_vel,
    quality, status (status as 2-bit int; logged as the VHDL's 2-char binary,
    cf. tb_tactical.vhd:356).  Ends with a SCAN_END line when ``active_count``
    is given.
    """
    with open(path, "a" if append else "w") as f:
        for t in tracks:
            f.write("TRK {id} R={r} D={d} VR={vr} Q={q} S={s:02b}\n".format(
                id=int(t["id"]), r=int(t["range_pos"]), d=int(t["dopp_pos"]),
                vr=int(t["range_vel"]), q=int(t["quality"]), s=int(t["status"])))
        if active_count is not None:
            f.write(f"SCAN_END ACTIVE={int(active_count)}\n")
