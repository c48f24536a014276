"""The port's surveillance runtime (``fmcw_tpu_torch.runtime.surveillance``)
against the JAX package's, on the CPU.

* The runtime alone: both runtimes are fed the SAME processor outputs (a
  callable that replays precomputed numpy top-K arrays), so that only the
  runtime is compared: the logs are byte-identical and the final tracker
  states equal — on the golden fixed chain's detections of moving
  two-target frames, and on seeded detections whose float magnitudes lie
  beyond int32 (both convert on the host with numpy: INT_MIN, fault 1).
  JAX's own fixed chains are within 8 LSB of the golden model, so their
  logs cannot be byte-equal to the port's golden-exact ones.
* The real processors in fixed mode (the port's plain route against JAX's
  ``make_batch_processor(mode="fixed")``): the same detection positions
  per scan, magnitudes within test_frontend_fixed's 8 LSB.
* Float mode, checkpoint/resume, the array model, the watchdog and the
  health lines, as ``tests/test_surveillance.py`` holds JAX's runtime.
* The port's numpy ``TacticalScenario``, which makes the stimuli here and
  in ``chip_smoke.py``, against JAX's: the same frames and truth, bit for
  bit.
* The hw-compat streaming runner (``run_surveillance_stream``) with the
  real ``cfar_geometry="hw_stream"`` processors on JAX's own stream test
  stimulus (a target whose skirt rides the inter-frame carry): logs
  byte-identical to JAX's runner, and a JAX checkpoint (tracker state,
  scan counter, ``stream_hist``) resumed by the port logs byte-identically
  to JAX's unbroken run.
"""

import numpy as np
import pytest
import torch

import fmcw_tpu
import fmcw_tpu_torch
from fmcw_tpu.models import pipeline as jpl
from fmcw_tpu.runtime import surveillance as jsv
from fmcw_tpu.utils import checkpoint as jck, viz
from fmcw_tpu_torch.golden import reference
from fmcw_tpu_torch.models import pipeline as tpl, scenario as tsc
from fmcw_tpu_torch.runtime import surveillance as tsv
from fmcw_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(2)

Q = fmcw_tpu_torch.quick()
JQ = fmcw_tpu.quick()
MOVES = [(20, 5.0, 1), (90, -10.0, -1)]      # (range bin, doppler, range/scan)


def moving_frames(n: int):
    """Two targets moving one range bin a scan at quick()'s size."""
    return [tpl.complex_to_iq(reference.two_target_frame(
        Q, seed=s, targets=[(r + v * s, d, a) for (r, d, v), a
                            in zip(MOVES, (8000.0, 5000.0))]))
        for s in range(n)]


class Replay:
    """A batch processor that replays precomputed top-K arrays: frame i is
    the int16 array filled with i + 1 (0 is the runtime's padding, which
    gives no detections)."""

    def __init__(self, dets: dict):
        self.dets = dets

    def __call__(self, batch, mti_bypass=False, scale_override=0):
        idx = np.asarray(batch).reshape(len(batch), -1)[:, 0].astype(int)
        out = {}
        for k, v in self.dets.items():
            rows = np.zeros((len(idx),) + v.shape[1:], v.dtype)
            rows[idx > 0] = v[idx[idx > 0] - 1]
            out[k] = rows
        return out

    @staticmethod
    def frames(n: int):
        return [np.full((2, 2), i + 1, np.int16) for i in range(n)]


@pytest.fixture(scope="module")
def golden_dets():
    """The golden fixed chain's top-K detections of 7 moving two-target
    frames (the port's plain fixed route equals the golden model bit for
    bit)."""
    proc = tpl.make_batch_processor(Q, mode="fixed", frontend="plain",
                                    include_maps=False, peak_group_radius=2,
                                    device="cpu")
    out = proc(np.stack(moving_frames(7)))
    return {k: out[k].numpy() for k in ("range_bin", "doppler_bin", "mag",
                                        "valid", "n_dets")}


def random_dets(n: int, k: int, seed: int):
    """Seeded detections with float32 magnitudes, some beyond int32."""
    rng = np.random.default_rng(seed)
    valid = rng.random((n, k)) < 0.5
    mag = (rng.random((n, k)) * 5e4).astype(np.float32)
    mag[:, 0] = 3.0e9
    mag[::2, 1] = -3.5e9
    rb = np.where(valid, rng.integers(0, 128, (n, k)) // 4 * 4, 0)
    rb[:, :2] = [40, 80]
    valid[:, :2] = True
    return {"range_bin": rb.astype(np.int32),
            "doppler_bin": np.where(valid, rng.integers(0, 32, (n, k)) // 4
                                    * 4, 0).astype(np.int32),
            "mag": np.where(valid, mag, 0).astype(np.float32),
            "valid": valid,
            "n_dets": valid.sum(axis=1).astype(np.int32)}


def run_both(tmp_path, dets, n, batch_scans, **kw):
    logs = {}
    results = {}
    for name, mod, p, extra in (("port", tsv, Q, dict(device="cpu")),
                                ("jax", jsv, JQ, {})):
        d, t = str(tmp_path / f"{name}_d.txt"), str(tmp_path / f"{name}_t.txt")
        results[name] = list(mod.run_surveillance(
            Replay(dets), Replay.frames(n), p, batch_scans=batch_scans,
            det_log=d, trk_log=t, **kw, **extra))
        logs[name] = (open(d, "rb").read(), open(t, "rb").read())
    return results, logs


@pytest.mark.parametrize("stimulus", ["golden", "random"])
def test_runtime_alone_byte_identical_to_jax(tmp_path, golden_dets,
                                             stimulus):
    dets = golden_dets if stimulus == "golden" else random_dets(9, 64, 4)
    n = len(dets["valid"])
    with np.errstate(invalid="ignore"):
        res, logs = run_both(tmp_path, dets, n, batch_scans=3)
    assert logs["port"] == logs["jax"]
    assert logs["port"][0] and logs["port"][1]
    port, jax_ = res["port"], res["jax"]
    assert [(r.scan, r.n_dets, r.active_tracks) for r in port] == \
        [(r.scan, r.n_dets, r.active_tracks) for r in jax_]
    for a, b in zip(port, jax_):
        assert (a.tracker_state is None) == (b.tracker_state is None)
        assert a.report.keys() == b.report.keys()
        assert all(np.array_equal(a.report[k], b.report[k])
                   for k in b.report)
    fa, fb = port[-1].tracker_state, jax_[-1].tracker_state
    assert fa.keys() == fb.keys()
    assert all(np.array_equal(fa[k], fb[k]) for k in fb)
    if stimulus == "random":           # fault 1: numpy's INT_MIN carried
        assert (fa["last_mag"] == np.iinfo(np.int32).min).any()
    else:
        assert port[-1].active_tracks > 0


def _parse_dets(path):
    rows = [list(map(int, ln.split())) for ln in open(path)]
    return np.array(rows, np.int64).reshape(-1, 3)


@pytest.fixture(scope="module")
def fixed_procs():
    kw = dict(mode="fixed", include_maps=False, peak_group_radius=2)
    return (tpl.make_batch_processor(Q, frontend="plain", device="cpu", **kw),
            jpl.make_batch_processor(JQ, **kw))


def test_fixed_processors_same_detections_as_jax(tmp_path, fixed_procs):
    port_proc, jax_proc = fixed_procs
    frames = moving_frames(5)
    res = {}
    for name, mod, proc, p, extra in (
            ("port", tsv, port_proc, Q, dict(device="cpu")),
            ("jax", jsv, jax_proc, JQ, {})):
        res[name] = list(mod.run_surveillance(
            proc, frames, p, batch_scans=2,
            det_log=str(tmp_path / f"{name}.txt"), **extra))
    assert [r.n_dets for r in res["port"]] == [r.n_dets for r in res["jax"]]
    a, b = (_parse_dets(tmp_path / f"{n}.txt") for n in ("port", "jax"))
    assert a.shape == b.shape and len(a) > 0
    # Per scan, in log order: the same cells, magnitudes within 8 LSB.
    assert np.array_equal(a[:, :2], b[:, :2])
    assert np.abs(a[:, 2] - b[:, 2]).max() <= 8


def test_float_mode_logs_parse(tmp_path):
    proc = tpl.make_batch_processor(Q, include_maps=False,
                                    peak_group_radius=2, device="cpu")
    trk = str(tmp_path / "t.txt")
    res = list(tsv.run_surveillance(proc, moving_frames(7), Q, batch_scans=3,
                                    det_log=str(tmp_path / "d.txt"),
                                    trk_log=trk, device="cpu"))
    assert [r.scan for r in res] == list(range(1, 8))
    tracks, counts = viz.load_tracks(trk)
    assert len(counts) == 7 and counts[-1] == res[-1].active_tracks
    assert any(t.status and max(t.status) == 2 for t in tracks.values())


def test_checkpoint_resume_byte_identical(tmp_path, fixed_procs):
    proc = fixed_procs[0]
    frames = moving_frames(6)
    logs = {k: (str(tmp_path / f"{k}_d.txt"), str(tmp_path / f"{k}_t.txt"))
            for k in ("full", "resumed")}
    full = list(tsv.run_surveillance(proc, frames, Q, batch_scans=2,
                                     det_log=logs["full"][0],
                                     trk_log=logs["full"][1], device="cpu"))
    d, t = logs["resumed"]
    first = list(tsv.run_surveillance(proc, frames[:2], Q, batch_scans=2,
                                      det_log=d, trk_log=t, device="cpu"))
    assert first[0].tracker_state is None      # only a batch's last scan
    path = str(tmp_path / "ck.npz")
    tck.save(path, first[-1].tracker_state, scan_index=first[-1].scan,
             runtime_state=tck.log_positions(d, t))
    # A crashed batch leaves half-written lines; the resume drops them.
    for f in (d, t):
        with open(f, "a") as fh:
            fh.write("9 9 9\n")
    state, scan, _, rt = tck.load(path)
    tck.restore_logs(rt, d, t)
    rest = list(tsv.run_surveillance(proc, frames[scan:], Q, batch_scans=2,
                                     det_log=d, trk_log=t,
                                     tracker_state=state, start_scan=scan,
                                     device="cpu"))
    assert [r.scan for r in rest] == [3, 4, 5, 6]
    for i in (0, 1):
        assert open(logs["full"][i], "rb").read() == \
            open(logs["resumed"][i], "rb").read()
    fa, fb = full[-1].tracker_state, rest[-1].tracker_state
    assert all(np.array_equal(fa[k], fb[k]) for k in fa)
    assert full[-1].active_tracks > 0


@pytest.mark.parametrize("burst", [True, False])
@pytest.mark.parametrize("size", ["quick", "full"])
def test_scenario_bit_identical_to_jax(size, burst):
    """The port's numpy scenario gives JAX's frames and truth, bit for bit,
    single-channel and element-space, at quick() and RadarParams()."""
    from fmcw_tpu.models import scenario as jsc
    tp, jp = ((Q, JQ) if size == "quick" else
              (fmcw_tpu_torch.RadarParams(), fmcw_tpu.RadarParams()))
    tcfg, jcfg = tsc.quick_scenario(), jsc.quick_scenario()
    tcfg.burst_synthesis = jcfg.burst_synthesis = burst
    runs = [(tsc.TacticalScenario(tp, tcfg).run(),
             jsc.TacticalScenario(jp, jcfg).run()),
            (tsc.TacticalScenario(tp, tcfg).run_elements(n_elems=4),
             jsc.TacticalScenario(jp, jcfg).run_elements(n_elems=4))]
    for port, ref in runs:
        port, ref = list(port), list(ref)
        assert len(port) == len(ref) == jcfg.num_scans
        for (ts, tf, tt), (js, jf, jt) in zip(port, ref):
            assert ts == js
            assert tf.dtype == jf.dtype and tf.shape == jf.shape
            assert np.array_equal(tf, jf)
            assert tt == jt


def test_array_model(tmp_path):
    p = fmcw_tpu_torch.RadarParams(
        n_range=256, n_doppler=64,
        cfar=fmcw_tpu_torch.CfarParams(ref_range=4, ref_doppler=3,
                                       guard_range=2, guard_doppler=1,
                                       scale_block=2))
    cfg = tsc.quick_scenario()
    cfg.burst_synthesis = False
    cfg.num_scans = 5
    frames = [tpl.complex_to_iq(f) for _, f, _ in
              tsc.TacticalScenario(p, cfg).run_elements(n_elems=4)]
    proc = tpl.make_batch_array_processor(p, n_elems=4, n_beams=4,
                                          peak_group_radius=2,
                                          beam_group_radius=1,
                                          include_maps=False, device="cpu")
    trk = str(tmp_path / "t.txt")
    res = list(tsv.run_surveillance(proc, frames, p, batch_scans=2,
                                    det_log=str(tmp_path / "d.txt"),
                                    trk_log=trk, device="cpu"))
    assert len(res) == 5
    assert any(r.n_dets > 0 for r in res)
    assert res[-1].active_tracks > 0
    _, counts = viz.load_tracks(trk)
    assert len(counts) == 5


def test_watchdog_surfaces_stall_and_propagates_errors(golden_dets):
    import time

    def hung_proc(batch, mti_bypass=False, scale_override=0):
        time.sleep(30.0)
        raise AssertionError("unreachable")

    t0 = time.perf_counter()
    with pytest.raises(tsv.SurveillanceStallError):
        list(tsv.run_surveillance(hung_proc, Replay.frames(2), Q,
                                  batch_scans=2, watchdog_timeout=0.3,
                                  device="cpu"))
    assert time.perf_counter() - t0 < 5.0

    def bad_proc(batch, mti_bypass=False, scale_override=0):
        raise RuntimeError("device exploded")

    with pytest.raises(RuntimeError, match="device exploded"):
        list(tsv.run_surveillance(bad_proc, Replay.frames(3), Q,
                                  batch_scans=3, watchdog_timeout=10.0,
                                  device="cpu"))
    # A generous budget changes nothing.
    proc = Replay(golden_dets)
    a = list(tsv.run_surveillance(proc, Replay.frames(7), Q, batch_scans=3,
                                  watchdog_timeout=300.0, device="cpu"))
    b = list(tsv.run_surveillance(proc, Replay.frames(7), Q, batch_scans=3,
                                  device="cpu"))
    assert [(r.scan, r.n_dets, r.active_tracks) for r in a] == \
        [(r.scan, r.n_dets, r.active_tracks) for r in b]


def test_health_lines_match_jax(golden_dets):
    lines = {"port": [], "jax": []}
    for name, mod, p, extra in (("port", tsv, Q, dict(device="cpu")),
                                ("jax", jsv, JQ, {})):
        res = list(mod.run_surveillance(
            Replay(golden_dets), Replay.frames(5), p, batch_scans=2,
            health=lines[name].append, **extra))
        assert len(res) == 5
    assert len(lines["port"]) == 3          # 2 + 2 + 1 scans
    assert lines["port"][0].startswith("HEALTH scans=1-2 ")
    assert lines["port"][-1].startswith("HEALTH scans=5-5 ")
    for a, b in zip(lines["port"], lines["jax"]):
        # Everything but the wall-clock fields is the same.
        assert a.split(" batch_s=")[0] == b.split(" batch_s=")[0]
        assert "scan_rate=" in a and a.endswith("/s")


def _stream_frames(n: int):
    """JAX's test_surveillance_stream_checkpoint_resume stimulus: a target
    at range bin 124 of 128, whose skirt rides the inter-frame line-buffer
    carry, and one at 60."""
    return [tpl.complex_to_iq(reference.two_target_frame(
        Q, seed=s % 3, targets=((124, 10 + s % 3, 14000), (60, 20, 12000))))
        for s in range(n)]


@pytest.fixture(scope="module")
def stream_procs():
    kw = dict(mode="fixed", include_maps=False, cfar_geometry="hw_stream")
    return (tpl.make_processor(Q, device="cpu", **kw),
            jpl.make_processor(JQ, **kw))


def test_stream_runner_not_ported():
    """The hw-compat streaming runner, which raised NotImplementedError
    before the streaming CFAR was ported, runs: on CUDA unless asked for
    the CPU, with a processor that has ``stream``."""
    proc = tpl.make_processor(Q, mode="fixed", cfar_geometry="hw_stream",
                              include_maps=False, device="cpu")
    frames = _stream_frames(2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            next(tsv.run_surveillance_stream(proc, frames, Q))
    res = list(tsv.run_surveillance_stream(proc, frames, Q, device="cpu"))
    assert [r.scan for r in res] == [1, 2]
    assert res[-1].stream_hist.shape == (2 * (4 * Q.n_doppler + 3),)
    with pytest.raises(AttributeError):
        next(tsv.run_surveillance_stream(
            tpl.make_processor(Q, device="cpu"), frames, Q, device="cpu"))


def test_stream_runner_byte_identical_to_jax(tmp_path, stream_procs):
    frames = _stream_frames(6)
    res, logs = {}, {}
    for name, mod, proc, p, extra in (
            ("port", tsv, stream_procs[0], Q, dict(device="cpu")),
            ("jax", jsv, stream_procs[1], JQ, {})):
        d, t = str(tmp_path / f"{name}_d.txt"), str(tmp_path / f"{name}_t.txt")
        res[name] = list(mod.run_surveillance_stream(
            proc, frames, p, det_log=d, trk_log=t, **extra))
        logs[name] = (open(d, "rb").read(), open(t, "rb").read())
    assert logs["port"] == logs["jax"]
    assert all(r.n_dets for r in res["port"])
    for a, b in zip(res["port"], res["jax"]):
        assert (a.scan, a.n_dets, a.active_tracks) == \
            (b.scan, b.n_dets, b.active_tracks)
        assert all(np.array_equal(a.tracker_state[k], b.tracker_state[k])
                   for k in b.tracker_state)
        # The carry: the frame's last 2 lag golden magnitudes (JAX's FP32
        # chain's are within a few LSB of them).
        assert a.stream_hist.dtype == np.int32
        assert a.stream_hist.shape == b.stream_hist.shape
        assert np.abs(a.stream_hist - b.stream_hist).max() <= 8


def test_stream_resume_from_jax_checkpoint(tmp_path, stream_procs):
    """JAX runs 3 scans and checkpoints the whole runtime state (tracker,
    scan counter, stream_hist, log positions); a crash appends a line; the
    port restores the logs and resumes from JAX's checkpoint: the logs and
    the final tracker state equal JAX's unbroken run."""
    port, jproc = stream_procs
    frames = _stream_frames(6)
    d0, t0 = str(tmp_path / "d0.txt"), str(tmp_path / "t0.txt")
    full = list(jsv.run_surveillance_stream(jproc, frames, JQ, det_log=d0,
                                            trk_log=t0))
    d1, t1 = str(tmp_path / "d1.txt"), str(tmp_path / "t1.txt")
    first = list(jsv.run_surveillance_stream(jproc, frames[:3], JQ,
                                             det_log=d1, trk_log=t1))
    path = str(tmp_path / "ck.npz")
    jck.save(path, first[-1].tracker_state, scan_index=first[-1].scan,
             runtime_state={"stream_hist": first[-1].stream_hist,
                            **jck.log_positions(d1, t1)})
    with open(d1, "a") as fh:
        fh.write("999 999 12345\n")
    state, scan, _, rt = tck.load(path)
    assert scan == 3
    tck.restore_logs(rt, det_log=d1, trk_log=t1)
    rest = list(tsv.run_surveillance_stream(
        port, frames[3:], Q, det_log=d1, trk_log=t1, tracker_state=state,
        stream_hist=rt["stream_hist"], start_scan=scan, device="cpu"))
    assert [r.scan for r in rest] == [4, 5, 6]
    assert open(d1, "rb").read() == open(d0, "rb").read()
    assert open(t1, "rb").read() == open(t0, "rb").read()
    for k in full[-1].tracker_state:
        assert np.array_equal(rest[-1].tracker_state[k],
                              full[-1].tracker_state[k]), k
    # Without the carry the resumed run replays the startup skip and logs
    # other detections.
    d2 = str(tmp_path / "d2.txt")
    list(tsv.run_surveillance_stream(port, frames[3:], Q, det_log=d2,
                                     tracker_state=state, start_scan=scan,
                                     device="cpu"))
    assert open(d2, "rb").read() != \
        open(d0, "rb").read()[int(rt["det_log_pos"]):]
