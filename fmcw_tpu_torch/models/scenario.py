"""Tactical air-defense scenario generator (numpy).

Port of the *math* of rtl/src/tb_tactical.vhd:129-329 (not the process/FSM):
N_FIGHTERS Su-27-class targets at Mach 1 in fingertip formation executing a
mid-scenario notch maneuver, N_ATTACKERS Su-25-class at Mach 0.65, sea
clutter, Gaussian thermal noise, R^4-law amplitudes, 3-PRF stagger.

Used as the integration-test stimulus and demo data source — the reference
embeds this simulator in its testbench (SURVEY.md §4); here it is a library
component so tests, benchmarks and the CLI share it.

A numpy copy of ``fmcw_tpu/models/scenario.py`` on the port's params: the
same seed gives the same frames, bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..params import RadarParams

MACH_MPS = 340.29
NM_TO_M = 1852.0


def _vhdl_int(x) -> int:
    """VHDL integer() conversion: round to nearest, ties away from zero."""
    return int(np.floor(abs(x) + 0.5) * np.sign(x)) if x else 0


@dataclasses.dataclass
class ScenarioConfig:
    """Physics constants of tb_tactical.vhd:44-63 with quick/full counts."""
    n_fighters: int = 6
    n_attackers: int = 4
    num_scans: int = 120
    wavelength: float = 0.1          # S-band ~10 cm
    max_range_m: float = 120000.0
    scan_rate: float = 2.0           # scans/s
    prf_hz: tuple = (8000.0, 9000.0, 10000.0)
    thermal_noise: float = 50.0
    sea_clutter: float = 200.0
    clutter_rng_m: float = 20000.0
    range_res_m: float = 150.0
    seed: int = 42
    # Reference-faithful target synthesis paints a 5-sample time-domain burst
    # at s ~ range_bin (tb_tactical.vhd:252-266) whose spectrum smears over
    # ~n_range/5 range bins.  False = physically-correct point target: a
    # full-length tone (energy concentrated in one range bin).
    burst_synthesis: bool = True

    @property
    def notch_scan(self) -> int:
        return self.num_scans // 2


def quick_scenario() -> "ScenarioConfig":
    """QUICK_MODE counts (tb_tactical.vhd:31-40)."""
    return ScenarioConfig(n_fighters=2, n_attackers=1, num_scans=5)


@dataclasses.dataclass
class Target:
    range_m: float
    vel_radial: float
    rcs_m2: float
    active: bool = True
    is_notching: bool = False
    # Steering sine sin(azimuth) for element-space synthesis
    # (element_frames); the reference's single-channel testbench has no
    # angle dimension, so frame() ignores it.
    bearing_u: float = 0.0


def _rcs_to_amp(rcs: float, rng: float) -> float:
    """R^4 radar-equation amplitude (tb_tactical.vhd:158-162)."""
    if rng < 1000.0:
        return 30000.0
    return np.sqrt(rcs) * 20000.0 / np.sqrt((rng / 10000.0) ** 4)


def _vel_to_doppler_bin(vel: float, prf: float, cfg: ScenarioConfig,
                        n_doppler: int) -> int:
    """Doppler bin with +N/2 offset and wrap (tb_tactical.vhd:164-171);
    VHDL integer() rounds to nearest (not truncation)."""
    b = _vhdl_int((2.0 * vel / cfg.wavelength / prf) * n_doppler) + n_doppler // 2
    return b % n_doppler


def _range_to_bin(rng: float, cfg: ScenarioConfig, n_range: int) -> int:
    return _vhdl_int((rng / cfg.max_range_m) * n_range)


class TacticalScenario:
    """Stateful scenario: call ``frame(scan)``... or iterate ``run()``.

    Kinematics update once per scan (tb_tactical.vhd:208-236): fighters notch
    (radial velocity -> 0) at scan ``notch_scan`` and resume 3 scans later;
    targets deactivate below 5 km.
    """

    FTR_OFFSET = (0.0, -50.0, -50.0, -100.0, -100.0, -150.0)

    def __init__(self, params: RadarParams | None = None,
                 cfg: ScenarioConfig | None = None):
        self.p = params or RadarParams()
        self.cfg = cfg or ScenarioConfig()
        self.rng = np.random.default_rng(self.cfg.seed)
        # Bearings (steering sines) only matter for element_frames: the
        # fighter formation approaches off one bow, the attackers the other.
        self.fighters = [
            Target(45.0 * NM_TO_M + self.FTR_OFFSET[i % 6], -MACH_MPS, 12.0,
                   bearing_u=0.30 + 0.02 * i)
            for i in range(self.cfg.n_fighters)]
        self.attackers = [
            Target(39.0 * NM_TO_M, -0.65 * MACH_MPS, 20.0,
                   bearing_u=-0.35 - 0.03 * i)
            for i in range(self.cfg.n_attackers)]

    def _advance(self, scan: int) -> None:
        cfg = self.cfg
        if scan == cfg.notch_scan:
            for f in self.fighters:
                f.vel_radial, f.is_notching = 0.0, True
        elif scan == cfg.notch_scan + 3:
            for f in self.fighters:
                f.vel_radial, f.is_notching = -MACH_MPS, False
        for t in self.fighters + self.attackers:
            t.range_m += t.vel_radial / cfg.scan_rate
            if t.range_m < 5000.0:
                t.active = False

    def truth(self, prf: float):
        """Active targets as (range_bin, doppler_bin, amp) ground truth."""
        out = []
        for t in self.fighters + self.attackers:
            if not t.active:
                continue
            rb = _range_to_bin(t.range_m, self.cfg, self.p.n_range)
            db = _vel_to_doppler_bin(t.vel_radial, prf, self.cfg,
                                     self.p.n_doppler)
            out.append((rb, db, _rcs_to_amp(t.rcs_m2, t.range_m)))
        return out

    def _target_tone(self, rb: int, db: int, amp: float) -> np.ndarray:
        """One target's (n_doppler, n_range) complex contribution."""
        p, cfg = self.p, self.cfg
        s = np.arange(p.n_range)
        c = np.arange(p.n_doppler)
        if cfg.burst_synthesis:
            # Reference-faithful: amplitude-gated 5-sample burst at
            # s ~ rb, amp*0.3/|ds| at the skirts (tb_tactical.vhd:252-266).
            amp_s = np.zeros(p.n_range)
            for ds in range(-2, 3):
                if 0 <= rb + ds < p.n_range:
                    amp_s[rb + ds] = amp if ds == 0 else amp * 0.3 / abs(ds)
        else:
            # Physically-correct point target: full-length tone.
            amp_s = np.full(p.n_range, amp)
        tone_s = amp_s * np.exp(2j * np.pi * rb * s / p.n_range)
        tone_c = np.exp(2j * np.pi * db * c / p.n_doppler)
        return tone_c[:, None] * tone_s[None, :]

    def _clutter_noise(self) -> np.ndarray:
        """One (n_doppler, n_range) clutter+thermal realization (draw order
        matches the original in-frame sequence: clutter amplitude, clutter
        phase, thermal re/im)."""
        p, cfg = self.p, self.cfg
        s = np.arange(p.n_range)
        c = np.arange(p.n_doppler)
        acc = np.zeros((p.n_doppler, p.n_range), dtype=np.complex128)
        # Sea clutter where s * range_res < clutter_rng strictly
        # (tb_tactical.vhd:290): the cell count is ceil(rng/res).
        n_clut = min(int(np.ceil(cfg.clutter_rng_m / cfg.range_res_m)),
                     p.n_range)
        if n_clut > 0:
            sc = s[:n_clut]
            camp = (cfg.sea_clutter * (1.0 - sc / p.n_range)
                    * self.rng.random((p.n_doppler, n_clut)))
            cphase = 2.0 * np.pi * (
                sc[None, :] ** 2 / (p.n_range * 10.0)
                + (self.rng.random((p.n_doppler, n_clut)) - 0.5) * 4.0
                * c[:, None] / p.n_doppler)
            acc[:, :n_clut] += camp * np.exp(1j * cphase)
        # Thermal noise (Box-Muller in the TB; Gaussian here).
        acc += (self.rng.normal(0.0, cfg.thermal_noise, acc.shape)
                + 1j * self.rng.normal(0.0, cfg.thermal_noise, acc.shape))
        return acc

    @staticmethod
    def _quantize(acc: np.ndarray) -> np.ndarray:
        """Quantize like the TB: clip to +-32000 then VHDL integer()
        round-to-nearest (tb_tactical.vhd:306-312)."""
        re = np.clip(acc.real, -32000, 32000)
        im = np.clip(acc.imag, -32000, 32000)
        re = np.floor(np.abs(re) + 0.5) * np.sign(re)
        im = np.floor(np.abs(im) + 0.5) * np.sign(im)
        return re + 1j * im

    def frame(self, scan: int) -> tuple[np.ndarray, list]:
        """Synthesize the scan's CPI.  Returns (complex frame (n_doppler,
        n_range), truth list).  Vectorized equivalent of the per-sample loop
        tb_tactical.vhd:247-319."""
        p, cfg = self.p, self.cfg
        self._advance(scan)
        prf = cfg.prf_hz[(scan - 1) % len(cfg.prf_hz)]
        truth = self.truth(prf)
        acc = np.zeros((p.n_doppler, p.n_range), dtype=np.complex128)
        for rb, db, amp in truth:
            acc += self._target_tone(rb, db, amp)
        acc += self._clutter_noise()
        return self._quantize(acc), truth

    def element_frames(self, scan: int, n_elems: int,
                       spacing_wl: float = 0.5) -> tuple[np.ndarray, list]:
        """Element-space CPI for an ``n_elems``-element ULA: the array-radar
        stimulus (models/pipeline.make_array_processor).  Returns
        (complex (n_elems, n_doppler, n_range), truth list of
        (range_bin, doppler_bin, amp, bearing_u)).

        Each target arrives as a plane wave from its ``bearing_u``: element
        ``e`` sees its tone advanced by exp(+j 2*pi*spacing_wl*e*u) — the
        conjugate of the steering weights ops/beamform.steering_matrix
        applies, so the matched beam coheres.  Sea clutter is diffuse
        scattering (decorrelated across the aperture) and thermal noise is
        receiver-local: both draw independent realizations per element.
        With ``n_elems == 1`` the draw sequence equals ``frame``'s exactly
        (same RNG consumption), so a 1-element array reproduces the
        single-channel stimulus bit-for-bit."""
        p, cfg = self.p, self.cfg
        self._advance(scan)
        prf = cfg.prf_hz[(scan - 1) % len(cfg.prf_hz)]
        truth = []
        tones = []
        for t in self.fighters + self.attackers:
            if not t.active:
                continue
            rb = _range_to_bin(t.range_m, cfg, p.n_range)
            db = _vel_to_doppler_bin(t.vel_radial, prf, cfg, p.n_doppler)
            amp = _rcs_to_amp(t.rcs_m2, t.range_m)
            truth.append((rb, db, amp, t.bearing_u))
            tones.append((self._target_tone(rb, db, amp), t.bearing_u))
        frames = np.empty((n_elems, p.n_doppler, p.n_range),
                          dtype=np.complex128)
        for e in range(n_elems):
            acc = np.zeros((p.n_doppler, p.n_range), dtype=np.complex128)
            for tone, u in tones:
                acc += tone * np.exp(2j * np.pi * spacing_wl * e * u)
            acc += self._clutter_noise()
            frames[e] = self._quantize(acc)
        return frames, truth

    def run(self):
        """Yield (scan, frame, truth) for every scan (1-based scans)."""
        for scan in range(1, self.cfg.num_scans + 1):
            frame, truth = self.frame(scan)
            yield scan, frame, truth

    def run_elements(self, n_elems: int, spacing_wl: float = 0.5):
        """Yield (scan, element_frames, truth) for every scan — the
        element-space analog of ``run`` (see element_frames)."""
        for scan in range(1, self.cfg.num_scans + 1):
            frames, truth = self.element_frames(scan, n_elems, spacing_wl)
            yield scan, frames, truth
