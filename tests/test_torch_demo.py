"""The demo path of the port: the analysis layer (``utils/ambiguity``,
``utils/viz``) and the end-to-end CLI ``python -m
fmcw_tpu_torch.tools.visualize``, held against the JAX package.

* ``ambiguity`` and ``viz`` equal JAX's on JAX's ``test_ambiguity.py`` and
  ``test_notch_analysis.py`` inputs (the numbers exactly: both are the same
  numpy arithmetic), and parse logs as JAX's does; ``render`` writes the
  file names JAX's writes.
* The CLI in fixed mode (``--quick --cpu --scans 6``, plain and
  ``--hw-compat``) writes detection and track logs byte-identical to JAX's
  ``tools/visualize.py`` with the same flags, and prints the same
  unfolding lines.  The port's fixed chain equals the golden model bit for
  bit; on these scans JAX's FP32 fixed chain (``ROADMAP.md`` fault 3, up to
  5 LSB off the golden model) lands on the same logs.
* ``--sharded 2`` (a LocalMesh) logs equal the single device's; a
  ``--record`` then ``--iq-file`` replay logs equal the recorded run's.
* ``--array 4`` and float32 runs (two float chains agree to ~1e-5 of the
  peak, not bit for bit, so these are not held line for line to JAX):
  their logs parse, every synthesized target is detected within 3 range
  bins on at least 2 scans, and the active track count ramps
  monotonically to at least the 3 targets, as JAX's
  ``test_tactical_quick.py`` asserts.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fmcw_tpu.models import scenario as jsc
from fmcw_tpu.utils import ambiguity as jamb, viz as jviz
from fmcw_tpu_torch.models import scenario as tsc
from fmcw_tpu_torch.tools import visualize as V
from fmcw_tpu_torch.utils import ambiguity as tamb, viz as tviz

# Share the CPU with the other test workers (the suite runs 6 at once).
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CFG = jsc.ScenarioConfig()
PRFS = CFG.prf_hz
ND = 128
QUANT = max(PRFS) * CFG.wavelength / 2.0 / ND


# ---------------------------------------------------------------------------
# The analysis layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("v_true", [0.0, 120.0, -340.0, 455.0, -700.0,
                                    1050.0])
def test_unfold_equals_jax(v_true):
    """JAX's stimuli: the scenario's bins at the three PRFs (and two of
    them, and one corrupted); equal results, and JAX's bounds hold."""
    bins = [jsc._vel_to_doppler_bin(v_true, p, CFG, ND) for p in PRFS]
    assert bins == [tsc._vel_to_doppler_bin(v_true, p, tsc.ScenarioConfig(),
                                            ND) for p in PRFS]
    for b, prfs in ((bins, PRFS), (bins[:2], PRFS[:2]),
                    ([bins[0], (bins[1] + 37) % ND, bins[2]], PRFS)):
        got = tamb.unfold_velocity(b, prfs, ND, wavelength=CFG.wavelength)
        assert got == jamb.unfold_velocity(b, prfs, ND,
                                           wavelength=CFG.wavelength)
    v_hat, res = tamb.unfold_velocity(bins, PRFS, ND,
                                      wavelength=CFG.wavelength)
    assert abs(v_hat - v_true) <= 2 * QUANT and res <= 2 * QUANT
    for centered in (True, False):
        assert np.array_equal(
            tamb.apparent_velocity(np.arange(ND), ND, PRFS[0],
                                   CFG.wavelength, centered),
            jamb.apparent_velocity(np.arange(ND), ND, PRFS[0],
                                   CFG.wavelength, centered))
        assert np.array_equal(
            tviz.doppler_bin_to_mps(np.arange(ND), ND, centered=centered),
            jviz.doppler_bin_to_mps(np.arange(ND), ND, centered=centered))
    with pytest.raises(ValueError):
        tamb.unfold_velocity([5], [8000.0], ND)


def test_resolve_track_velocities_equals_jax():
    v_true = -520.0
    scans = list(range(6))
    bins = [jsc._vel_to_doppler_bin(v_true, PRFS[s % 3], CFG, ND)
            for s in scans]
    kw = dict(scans=scans, range_q2=[400 * 4] * 6,
              dopp_q2=[b * 4 for b in bins], vel_r=[0] * 6,
              quality=[10] * 6, status=[2] * 6)
    got = tviz.resolve_track_velocities({3: tviz.TrackHistory(**kw)}, ND,
                                        prfs=PRFS, wavelength=CFG.wavelength)
    want = jviz.resolve_track_velocities({3: jviz.TrackHistory(**kw)}, ND,
                                         prfs=PRFS,
                                         wavelength=CFG.wavelength)
    assert got == want and abs(got[3][0] - v_true) <= 2 * QUANT
    one = dict(scans=[0], range_q2=[0], dopp_q2=[bins[0] * 4], vel_r=[0],
               quality=[5], status=[1])
    assert tviz.resolve_track_velocities({0: tviz.TrackHistory(**one)}, ND,
                                         prfs=PRFS) == {}


def test_notch_analysis_and_unwraps_equal_jax():
    notch = 6
    hists = {0: [1, 2, 3, 4, 5, 9, 10], 1: [2, 3, 4, 5], 2: range(1, 12),
             3: [7, 8], 4: [10, 11], 5: [5, 9]}
    counts = [2, 3, 3, 3, 3, 3, 2, 2, 2, 3, 3, 3]
    for n, c in ((notch, counts), (1, counts), (11, counts), (6, counts[:7])):
        got = tviz.notch_analysis(
            {k: tviz.TrackHistory(list(v), [], [], [], [], [])
             for k, v in hists.items()}, c, n)
        want = jviz.notch_analysis(
            {k: jviz.TrackHistory(list(v), [], [], [], [], [])
             for k, v in hists.items()}, c, n)
        assert got == want
        if (n, c) == (notch, counts):
            assert (got["tracks_survived"], got["tracks_lost"]) == (3, 1)

    def wrap(v, bits):
        m = 1 << bits
        return ((np.asarray(v) + (m >> 1)) % m) - (m >> 1)

    rq2 = wrap(np.arange(1024) * 4 + 3, 12)
    dq2 = wrap(np.arange(128) * 4 + 1, 9)
    assert np.array_equal(tviz.unwrap_range_q2(rq2, 1024),
                          np.arange(1024) * 4 + 3)
    assert np.array_equal(tviz.unwrap_dopp_q2(dq2, 128),
                          jviz.unwrap_dopp_q2(dq2, 128))
    assert np.array_equal(tviz.bin_to_km(np.arange(1024), 1024),
                          jviz.bin_to_km(np.arange(1024), 1024))
    for name in ("MAX_RANGE_KM", "WAVELENGTH_M", "PRF_HZ", "KTS_PER_MPS"):
        assert getattr(tviz, name) == getattr(jviz, name)


def test_log_parsers_and_render_equal_jax(tmp_path):
    """load_detections / load_tracks parse a log (signed Q2 values,
    missing VR / S fields) as JAX's; render writes JAX's file names."""
    det, trk = tmp_path / "d.txt", tmp_path / "t.txt"
    det.write_text("12 5 300\n100 120 70000\nbad line\n7 0 1\n")
    trk.write_text("TRK 0 R=400 D=-20 VR=3 Q=5 S=10\nSCAN_END ACTIVE=1\n"
                   "TRK 0 R=-2044 D=100 Q=6\nTRK 3 R=8 D=4 VR=-1 Q=1 S=01\n"
                   "SCAN_END ACTIVE=2\n")
    assert np.array_equal(tviz.load_detections(str(det)),
                          jviz.load_detections(str(det)))
    (tt, tc), (jt, jc) = (tviz.load_tracks(str(trk)),
                          jviz.load_tracks(str(trk)))
    assert tc == jc and sorted(tt) == sorted(jt)
    for k in tt:
        assert vars(tt[k]) == vars(jt[k])
    mag = np.random.default_rng(0).exponential(100.0, (128, 32))
    names = []
    for mod, sub in ((tviz, "port"), (jviz, "jax")):
        (tmp_path / sub).mkdir()
        files = mod.render(det_path=str(det), trk_path=str(trk),
                           mag_map=mag, out_prefix=str(tmp_path / sub / "r"),
                           n_range=128, n_doppler=32, notch_scan=1)
        assert all(os.path.getsize(f) > 0 for f in files)
        names.append([os.path.basename(f) for f in files])
    assert names[0] == names[1] == ["r_detections.png", "r_tracks.png"]


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def _port_cli(capsys, argv):
    assert V.main(argv) == 0
    return capsys.readouterr().out.splitlines()


def _jax_cli(argv):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "tools/visualize.py", *argv],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    return res.stdout.splitlines()


def _logs(d):
    return [(Path(d) / n).read_bytes()
            for n in ("tac_detections.txt", "tac_tracks.txt")]


def _track_lines(lines):
    return [ln for ln in lines if ln.startswith("track ")]


@pytest.mark.parametrize("extra", [[], ["--hw-compat"]])
def test_cli_fixed_mode_equals_jax_cli(tmp_path, capsys, extra):
    argv = ["--quick", "--cpu", "--scans", "6", "--mode", "fixed", *extra]
    mine = _port_cli(capsys, argv + ["--out", str(tmp_path / "port")])
    theirs = _jax_cli(argv + ["--out", str(tmp_path / "jax")])
    assert _logs(tmp_path / "port") == _logs(tmp_path / "jax")
    assert _track_lines(mine) == _track_lines(theirs)
    assert len(_track_lines(mine)) >= 2
    scan = [ln for ln in mine if ln.startswith("scan ")]
    assert scan == [ln for ln in theirs if ln.startswith("scan ")]
    assert len(scan) == 6
    pngs = sorted(p.name for p in (tmp_path / "port").glob("*.png"))
    assert pngs == sorted(p.name for p in (tmp_path / "jax").glob("*.png"))
    assert pngs == ["radar_detections.png", "radar_tracks.png"]
    # --logs re-renders them.
    assert any("rendered:" in ln for ln in _port_cli(
        capsys, ["--logs", str(tmp_path / "port")]))


def test_cli_sharded_and_record_replay_equal_single_device(tmp_path):
    kw = dict(scans=6, mode="fixed", device="cpu", echo=lambda *_: None)
    one = V.run_demo(out=str(tmp_path / "one"),
                     record=str(tmp_path / "rec.bin"), **kw)
    two = V.run_demo(out=str(tmp_path / "sp2"), sharded=2, **kw)
    assert _logs(tmp_path / "one") == _logs(tmp_path / "sp2")
    assert one["velocity_lines"] == two["velocity_lines"]
    size = (tmp_path / "rec.bin").stat().st_size
    assert size == 6 * 32 * 128 * 2 * 2
    kw.pop("scans")
    rep = V.run_demo(out=str(tmp_path / "replay"),
                     iq_file=str(tmp_path / "rec.bin"), **kw)
    assert rep["scans"] == 6 and rep["notch_scan"] == 0
    assert _logs(tmp_path / "replay") == _logs(tmp_path / "one")
    assert rep["velocity_lines"] == one["velocity_lines"]


@pytest.mark.parametrize("array", [0, 4])
def test_cli_float_and_array_runs_cover_targets(tmp_path, array):
    lines = []
    res = V.run_demo(scans=6, out=str(tmp_path), array=array, device="cpu",
                     echo=lines.append)
    counts = [int(ln.split("dets=")[1].split()[0]) for ln in lines
              if ln.startswith("scan ")]
    dets = tviz.load_detections(res["det_log"])
    assert len(counts) == 6 and len(dets) == sum(counts)
    cfg = tsc.quick_scenario()
    cfg.num_scans, cfg.burst_synthesis = 6, False
    scen = tsc.TacticalScenario(res["params"], cfg)
    runs = scen.run_elements(array) if array else scen.run()
    covered = {}
    for (scan, _, truth), d in zip(runs, np.split(dets, np.cumsum(counts))):
        for t, target in enumerate(truth):
            if np.any(np.abs(d[:, 0] - target[0]) <= 3):
                covered.setdefault(t, []).append(scan)
    assert set(covered) == {0, 1, 2}
    assert all(len(s) >= 2 for s in covered.values())
    tracks, actives = tviz.load_tracks(res["trk_log"])
    assert len(actives) == 6 and actives == sorted(actives)
    assert 3 <= actives[-1] <= res["params"].tracker.max_tracks
    assert res["last_map"].shape == (128, 32)
    assert bool(res["azimuth_lines"]) == bool(array)


def test_cli_refusals(tmp_path):
    for kw in (dict(hw_compat=True, sharded=2), dict(hw_compat=True, array=4),
               dict(array=4, mode="fixed")):
        with pytest.raises(ValueError):
            V.run_demo(out=str(tmp_path), device="cpu", **kw)
    with pytest.raises(SystemExit):
        V.main(["--cpu", "--hw-compat", "--array", "4",
                "--out", str(tmp_path)])
