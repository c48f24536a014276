"""Configuration dataclasses for the PyTorch/CUDA radar port.

A copy of ``fmcw_tpu/params.py`` (the port imports nothing of the JAX
package).  These are the software equivalents of the reference design's
VHDL generics and testbench constants:

* shape / width generics        -> ``RadarParams``    (cf. rtl/src/radar_core.vhd:12-20)
* CFAR generics                 -> ``CfarParams``     (cf. rtl/src/os_cfar_2d.vhd:10-21)
* tracker generics              -> ``TrackerParams``  (cf. rtl/src/tws_tracker.vhd:10-20)
* QUICK_MODE testbench constant -> ``quick()`` preset (cf. rtl/src/tb_tactical.vhd:28-40)

Static (shape) parameters are frozen-dataclass fields; the runtime controls
(``mti_bypass``, ``scale_override``) are arguments of the processor calls,
mirroring the reference's split between generics and control ports
(rtl/src/radar_core.vhd:48-49).
"""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class CfarParams:
    """2D CFAR window geometry and thresholding parameters.

    Mirrors the generics of rtl/src/os_cfar_2d.vhd:10-21, with the *named*
    axis semantics: ``ref_range``/``guard_range`` extend along the range
    axis, ``ref_doppler``/``guard_doppler`` along Doppler.
    """

    ref_range: int = 4          # reference cells per side, range axis
    ref_doppler: int = 4        # reference cells per side, Doppler axis
    guard_range: int = 2        # guard cells per side, range axis
    guard_doppler: int = 1      # guard cells per side, Doppler axis
    rank_pct: int = 75          # OS-CFAR order statistic percentile
    scale_min: int = 2          # adaptive threshold scale, low/uniform noise
    scale_max: int = 6          # adaptive threshold scale, high clutter
    scale_nom: int = 4          # adaptive threshold scale, nominal
    variant: Literal["os", "ca", "go", "so"] = "os"
    # Edge handling for the 2D window: "wrap" treats the map as a torus,
    # "reflect" mirrors at the edges.
    edge_mode: Literal["wrap", "reflect"] = "wrap"
    # Adaptive-scale granularity.  "cell": the reference's per-cell rule
    # (est vs mean of each CUT's own training set, os_cfar_2d.vhd:187-199).
    # "block": clutter-map style, one scale per scale_block x scale_block
    # tile from the exceedance counts of its 3x3-block neighborhood.  The OS
    # threshold decision itself stays exact per cell.
    scale_mode: Literal["cell", "block"] = "cell"
    scale_block: int = 8        # block edge, must divide n_range and n_doppler

    @property
    def win_range(self) -> int:
        return 2 * self.ref_range + 2 * self.guard_range + 1

    @property
    def win_doppler(self) -> int:
        return 2 * self.ref_doppler + 2 * self.guard_doppler + 1

    @property
    def guard_area(self) -> int:
        return (2 * self.guard_range + 1) * (2 * self.guard_doppler + 1)

    @property
    def n_ref(self) -> int:
        """Number of reference (training) cells (os_cfar_2d.vhd:41-47)."""
        return self.win_range * self.win_doppler - self.guard_area

    @property
    def rank_idx(self) -> int:
        """0-based ascending-order rank index (os_cfar_2d.vhd:181-182)."""
        return min((self.n_ref * self.rank_pct) // 100, self.n_ref - 1)

    @property
    def halo_range(self) -> int:
        """Cells of range-axis halo a tile needs from each neighbor."""
        return self.ref_range + self.guard_range

    @property
    def halo_doppler(self) -> int:
        return self.ref_doppler + self.guard_doppler


@dataclasses.dataclass(frozen=True)
class TrackerParams:
    """TWS alpha-beta tracker parameters (rtl/src/tws_tracker.vhd:10-20)."""

    max_tracks: int = 32
    max_dets: int = 64          # detection buffer per scan (tws_tracker.vhd:66)
    init_hits: int = 2          # hits before a tentative track confirms
    coast_max: int = 5          # consecutive misses before drop
    assoc_gate_r: int = 10      # association gate, range bins
    assoc_gate_d: int = 5       # association gate, Doppler bins
    alpha_gain: int = 128       # position gain, Q8 (128/256 = 0.5)
    beta_gain: int = 64         # velocity gain, Q8 (64/256 = 0.25)
    # Association semantics.  "nearest": clean nearest-neighbor, first
    # detection wins ties.  "hw": bit-faithful to the VHDL, whose
    # best_distance/best_det_idx are *signals* (tws_tracker.vhd:84-85) —
    # each candidate compares against the stale value carried from the
    # previous active track's association, and the last qualifying
    # detection wins.
    assoc: str = "nearest"


@dataclasses.dataclass(frozen=True)
class RadarParams:
    """Top-level radar chain parameters (rtl/src/radar_core.vhd:12-20).

    A frame (one CPI) is ``(n_doppler, n_range)`` complex samples: ``n_doppler``
    chirps of ``n_range`` fast-time samples each.
    """

    n_range: int = 1024         # fast-time samples per chirp / range bins
    n_doppler: int = 128        # chirps per CPI / Doppler bins
    data_width: int = 16        # I/Q sample width (bits)
    coef_width: int = 16        # window coefficient width (Q15)
    mag_width: int = 17         # magnitude output width
    notch_mode: int = 2         # MTI canceller: 2- or 3-pulse (doppler_notch.vhd:14)
    cfar: CfarParams = dataclasses.field(default_factory=CfarParams)
    tracker: TrackerParams = dataclasses.field(default_factory=TrackerParams)

    @property
    def frame_size(self) -> int:
        return self.n_range * self.n_doppler

    def replace(self, **kw) -> "RadarParams":
        return dataclasses.replace(self, **kw)


def full() -> RadarParams:
    """Full-resolution production configuration (QUICK_MODE = false)."""
    return RadarParams()


def quick() -> RadarParams:
    """Reduced-resolution configuration mirroring QUICK_MODE
    (rtl/src/tb_tactical.vhd:31-40): 128x32 map, smaller CFAR window."""
    return RadarParams(
        n_range=128,
        n_doppler=32,
        cfar=CfarParams(ref_range=2, ref_doppler=2, guard_range=1, guard_doppler=1),
        tracker=TrackerParams(max_tracks=16),
    )


def fast() -> RadarParams:
    """Full-resolution throughput configuration: clutter-map (block) CFAR
    scale, which removes the per-cell mean and hi/lo counting passes from
    the detection kernel."""
    return RadarParams(cfar=CfarParams(scale_mode="block"))
