"""The port's runtime pieces against the JAX package's, on the CPU:

* ``models/tracker.run_scans`` equal to JAX's ``run_scans`` (final state
  and every scan's report) on seeded detections, both association modes,
  with magnitudes beyond int32 converted on the host as JAX's runtime does
  (numpy's ``astype(np.int32)``) and as raw floats (saturated by ``step``);
* ``utils/io``'s writers byte-equal to JAX's, its readers equal;
* checkpoints crossing both ways (``utils/checkpoint``);
* ``runtime/stream``: ``stream`` / ``stream_batched`` / ``FrameAssembler``
  against JAX's: order, padding, ``batch_valid``, drop accounting under one
  readiness pattern, and chunking (hypothesis);
* ``runtime/native``: ``FrameRing`` and ``FileFrameStreamer`` against
  JAX's on temporary files, with the committed library and with the
  pure-Python fallback (frames, a partial frame dropped, a missing file,
  an early cancel), the parsers and writer, and ``close()`` in a
  ``finally`` keeping the exception in flight while ``join()`` raises the
  producer's error.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import fmcw_tpu
import fmcw_tpu_torch
from fmcw_tpu.models import tracker as jtrk
from fmcw_tpu.runtime import native as jnative, stream as jrs
from fmcw_tpu.utils import checkpoint as jck, io as jio
from fmcw_tpu_torch.golden import reference
from fmcw_tpu_torch.models import pipeline as tpl, tracker as ttrk
from fmcw_tpu_torch.runtime import native as tnative, stream as trs
from fmcw_tpu_torch.utils import checkpoint as tck, io as tio

torch.set_num_threads(2)

Q = fmcw_tpu_torch.quick()
JQ = fmcw_tpu.quick()


def seeded_detections(n_scans: int, k: int, seed: int, float_mag=False):
    """Detections that form, move and lose tracks: a few targets drifting
    in range, plus clutter, over a small grid (so gates are hit)."""
    rng = np.random.default_rng(seed)
    rb = np.zeros((n_scans, k), np.int32)
    db = np.zeros((n_scans, k), np.int32)
    mag = np.zeros((n_scans, k), np.float32)
    valid = np.zeros((n_scans, k), bool)
    for s in range(n_scans):
        n = int(rng.integers(3, k))
        tgt = [(100 + 2 * s, 10), (300 - 3 * s, 40), (200, 20 + (s % 3))]
        cells = [t for t in tgt if rng.random() < 0.85]
        cells += [(int(rng.integers(0, 512)), int(rng.integers(0, 64)))
                  for _ in range(n - len(cells))]
        for i, (r, d) in enumerate(cells[:k]):
            rb[s, i], db[s, i] = r, d
            mag[s, i] = rng.integers(1, 60000)
            valid[s, i] = True
    if float_mag:
        # Beyond int32 both ways, and large but within it.
        mag[:, 0] = 3.5e9
        mag[1::2, 1] = -4.0e9
        mag[:, 2] = 2.0e9
    return rb, db, mag, valid


def _jax_run(rb, db, mag, valid, tp, state=None):
    import jax.numpy as jnp
    st_ = None if state is None else {k: jnp.asarray(v)
                                      for k, v in state.items()}
    final, reps = jtrk.run_scans(jnp.asarray(rb), jnp.asarray(db),
                                 jnp.asarray(mag), jnp.asarray(valid),
                                 tp=tp, state=st_)
    return ({k: np.asarray(v) for k, v in final.items()},
            {k: np.asarray(v) for k, v in reps.items()})


@pytest.mark.parametrize("assoc", ["nearest", "hw"])
@pytest.mark.parametrize("mag_kind", ["int", "host_int32", "float"])
def test_run_scans_matches_jax(assoc, mag_kind):
    import dataclasses
    tp = dataclasses.replace(Q.tracker, assoc=assoc)
    jtp = dataclasses.replace(JQ.tracker, assoc=assoc)
    rb, db, mag, valid = seeded_detections(9, tp.max_dets, seed=3,
                                           float_mag=mag_kind != "int")
    if mag_kind == "int":
        mag = mag.astype(np.int32)
    elif mag_kind == "host_int32":
        with np.errstate(invalid="ignore"):
            mag = mag.astype(np.int32)          # JAX's runtime: INT_MIN
        assert (mag[:, 0] == np.iinfo(np.int32).min).all()
    # Two calls, the state carried between them (a surveillance batch
    # boundary), against one JAX call of each.
    s1, r1 = ttrk.run_scans(rb[:5], db[:5], mag[:5], valid[:5], tp=tp,
                            device="cpu")
    s2, r2 = ttrk.run_scans(rb[5:], db[5:], mag[5:], valid[5:], tp=tp,
                            state=s1)
    j1, jr1 = _jax_run(rb[:5], db[:5], mag[:5], valid[:5], jtp)
    j2, jr2 = _jax_run(rb[5:], db[5:], mag[5:], valid[5:], jtp, state=j1)
    for got, want in ((s1, j1), (s2, j2)):
        got = ttrk.state_to_numpy(got)
        assert got.keys() == want.keys()
        for k in want:
            assert np.array_equal(got[k], want[k]), k
    for got, want in ((r1, jr1), (r2, jr2)):
        assert got.keys() == want.keys()
        for k in want:
            assert np.array_equal(got[k].numpy(), want[k]), k
    assert int(r2["active_tracks"].max()) > 0
    if mag_kind == "host_int32":
        assert (ttrk.state_to_numpy(s2)["last_mag"]
                == np.iinfo(np.int32).min).any()


def test_run_scans_defaults_and_checks():
    rb, db, mag, valid = seeded_detections(3, 64, seed=1)
    state, reps = ttrk.run_scans(rb, db, mag.astype(np.int32), valid,
                                 device="cpu")
    assert reps["range_pos"].shape == (3, fmcw_tpu_torch.TrackerParams()
                                       .max_tracks)
    assert state["active"].device.type == "cpu"
    with pytest.raises(ValueError):
        ttrk.run_scans(rb[:0], db[:0], mag[:0], valid[:0], device="cpu")


def test_io_writers_byte_equal_to_jax(tmp_path):
    rng = np.random.default_rng(5)
    rb = rng.integers(0, 1024, 40)
    db = rng.integers(0, 128, 40)
    mags = [rng.integers(0, 2 ** 31 - 1, 20).astype(np.int32),
            (rng.random(20) * 1e5).astype(np.float32)]
    tracks = [{"id": i, "range_pos": int(rng.integers(-2048, 2048)),
               "dopp_pos": int(rng.integers(-256, 256)),
               "range_vel": int(rng.integers(-512, 512)),
               "quality": int(rng.integers(0, 16)),
               "status": int(rng.integers(0, 4))} for i in range(5)]
    for name, mod in (("t", tio), ("j", jio)):
        for i, m in enumerate(mags):
            mod.write_detections(str(tmp_path / f"{name}d.txt"),
                                 rb[i * 20:(i + 1) * 20],
                                 db[i * 20:(i + 1) * 20], m, append=i > 0)
        mod.write_tracks(str(tmp_path / f"{name}t.txt"), tracks,
                         active_count=5)
        mod.write_tracks(str(tmp_path / f"{name}t.txt"), tracks[:2],
                         active_count=None, append=True)
        mod.write_rdm_map(str(tmp_path / f"{name}m.txt"),
                          np.arange(6 * 4).reshape(6, 4) * 1000)
    for f in ("d", "t", "m"):
        assert ((tmp_path / f"t{f}.txt").read_bytes()
                == (tmp_path / f"j{f}.txt").read_bytes())
    m = tio.read_rdm_map(str(tmp_path / "tm.txt"), 6, 4)
    assert np.array_equal(m, jio.read_rdm_map(str(tmp_path / "tm.txt"), 6, 4))
    assert np.array_equal(m, np.arange(24).reshape(6, 4) * 1000)
    (tmp_path / "iq.txt").write_text("1 -2\n-32768 32767\n0 5\n")
    assert np.array_equal(tio.read_iq_pairs(str(tmp_path / "iq.txt")),
                          jio.read_iq_pairs(str(tmp_path / "iq.txt")))


def test_checkpoints_cross_both_ways(tmp_path):
    rb, db, mag, valid = seeded_detections(4, 64, seed=2)
    state, _ = ttrk.run_scans(rb, db, mag.astype(np.int32), valid,
                              device="cpu")
    det_log, trk_log = tmp_path / "d.txt", tmp_path / "t.txt"
    det_log.write_text("1 2 3\n")
    trk_log.write_text("SCAN_END ACTIVE=0\n")
    rt = {"stream_hist": np.arange(6, dtype=np.int32),
          **tck.log_positions(str(det_log), str(trk_log))}
    assert rt == {"stream_hist": rt["stream_hist"],
                  **jck.log_positions(str(det_log), str(trk_log))}
    port = str(tmp_path / "port.npz")
    tck.save(port, state, scan_index=4, metadata={"run": "port"},
             runtime_state=rt)
    st_j, scan_j, meta_j, rt_j = jck.load(port)
    host = ttrk.state_to_numpy(state)
    assert scan_j == 4 and meta_j == {"run": "port"}
    assert all(np.array_equal(st_j[k], host[k]) for k in host)
    assert st_j.keys() == host.keys()
    assert np.array_equal(rt_j["stream_hist"], rt["stream_hist"])
    # A JAX checkpoint loads in the port and lands on the tracker's device.
    jax_path = str(tmp_path / "jax.npz")
    jck.save(jax_path, st_j, scan_index=9, metadata={"run": "jax"},
             runtime_state=rt_j)
    st_t, scan_t, meta_t, rt_t = tck.load(jax_path)
    assert (scan_t, meta_t) == (9, {"run": "jax"})
    back = ttrk.state_from_numpy(st_t, device="cpu")
    assert all(torch.equal(back[k], state[k]) for k in state)
    assert int(rt_t["det_log_pos"]) == 6
    # restore_logs truncates to the checkpointed positions, as JAX's.
    with open(det_log, "a") as f:
        f.write("4 5 6\n")
    tck.restore_logs(rt_t, str(det_log), str(trk_log))
    assert det_log.read_text() == "1 2 3\n"


# --- runtime/stream -------------------------------------------------------

def _frames(n):
    return [tpl.complex_to_iq(reference.two_target_frame(Q, seed=s))
            for s in range(n)]


@pytest.fixture(scope="module")
def procs():
    return (tpl.make_processor(Q, include_maps=False, device="cpu"),
            tpl.make_batch_processor(Q, include_maps=False, device="cpu"))


def test_stream_yields_all_in_order(procs):
    proc, _ = procs
    frames = _frames(5)
    stats = trs.StreamStats()
    outs = list(trs.stream(proc, frames, depth=2, stats=stats, device="cpu"))
    assert (stats.frames_in, stats.frames_processed,
            stats.frames_dropped) == (5, 5, 0)
    for f, o in zip(frames, outs):
        want = proc(f)
        assert all(torch.equal(o[k], want[k]) for k in want)
    jstats = jrs.StreamStats()
    assert len(list(jrs.stream(lambda x: {"n_dets": 0}, frames, depth=2,
                               stats=jstats))) == 5
    assert vars(jstats) == vars(stats)


class _Readiness:
    """One readiness pattern for both runtimes: the n-th probe of the
    oldest in-flight result answers ``pattern[n % len]``."""

    def __init__(self, pattern):
        self.pattern, self.n = pattern, 0

    def __call__(self, *_):
        ready = self.pattern[self.n % len(self.pattern)]
        self.n += 1
        return ready


@pytest.mark.parametrize("pattern,depth", [((False,), 2), ((True,), 2),
                                           ((False, True, True), 2),
                                           ((False, False, True), 3)])
def test_stream_drop_accounting_matches_jax(monkeypatch, pattern, depth):
    frames = [np.full((2, 2), i, np.int16) for i in range(11)]

    def proc(x):
        return {"frame": int(np.asarray(x)[0, 0])}

    probe = _Readiness(pattern)
    monkeypatch.setattr(trs, "_ready", lambda done: probe())
    stats = trs.StreamStats()
    got = [o["frame"] for o in trs.stream(proc, frames, depth, "drop",
                                          stats, device="cpu")]

    jprobe = _Readiness(pattern)

    class Out(dict):
        pass

    def jproc(x):
        o = Out(frame=int(np.asarray(x)[0, 0]))
        o["n_dets"] = type("R", (), {"is_ready": lambda self: jprobe()})()
        return o

    jstats = jrs.StreamStats()
    want = [o["frame"] for o in jrs.stream(jproc, frames, depth, "drop",
                                           jstats)]
    assert got == want
    assert vars(stats) == vars(jstats)
    assert stats.frames_processed + stats.frames_dropped == len(frames)


def test_stream_batched_pads_and_masks(procs):
    _, bproc = procs
    frames = _frames(5)
    stats = trs.StreamStats()
    outs = list(trs.stream_batched(bproc, frames, batch_size=2, depth=2,
                                   stats=stats, device="cpu"))
    assert [o["batch_valid"] for o in outs] == [2, 2, 1]
    assert stats.frames_processed == 5 and stats.frames_in == 5
    want = bproc(np.stack(frames[4:] + [np.zeros_like(frames[0])]))
    assert all(torch.equal(outs[-1][k], want[k]) for k in want)
    jstats = jrs.StreamStats()
    jouts = list(jrs.stream_batched(
        lambda x: {"n": np.asarray(x).shape[0]}, frames, batch_size=2,
        depth=2, stats=jstats))
    assert [o["batch_valid"] for o in jouts] == [2, 2, 1]
    assert vars(jstats) == vars(stats)


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(min_value=1, max_value=700), min_size=1,
                max_size=40))
def test_frame_assembler_chunking_matches_jax(cuts):
    nd, nr = 4, 64
    total = 3 * nd * nr + 17
    samples = np.random.default_rng(len(cuts)).integers(
        -32768, 32767, (total, 2)).astype(np.int16)
    port, ref = trs.FrameAssembler(nd, nr), jrs.FrameAssembler(nd, nr)
    got, want, pos, i = [], [], 0, 0
    while pos < total:
        step = cuts[i % len(cuts)]
        chunk = samples[pos:pos + step]
        got += port.push(chunk)
        want += ref.push(chunk)
        assert port.pending_samples == ref.pending_samples
        pos += step
        i += 1
    assert len(got) == len(want) == 3
    for g, w, k in zip(got, want, range(3)):
        assert np.array_equal(g, w)
        assert np.array_equal(
            g, samples[k * nd * nr:(k + 1) * nd * nr].reshape(nd, nr, 2))
    assert port.pending_samples == 17


@pytest.fixture(params=["native", "fallback"])
def native_mods(request, monkeypatch):
    """The port's and JAX's native modules, with their libraries where they
    load, or both on the pure-Python fallback."""
    if request.param == "fallback":
        monkeypatch.setattr(tnative, "_load", lambda: None)
        monkeypatch.setattr(jnative, "_load", lambda: None)
    return tnative, jnative


def test_native_library_never_writes_under_native(monkeypatch):
    """The loader opens the committed native/fmcwio.so as it is, or builds
    native/fmcwio.cpp under build/; native/ is left untouched either way."""
    native_dir = tnative._SO.parent
    before = {f.name: f.stat().st_mtime_ns for f in native_dir.iterdir()}
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", False)
    lib = tnative._load()
    assert {f.name: f.stat().st_mtime_ns
            for f in native_dir.iterdir()} == before
    if lib is not None:
        path = Path(lib._name)
        assert path == tnative._SO or \
            path.parent == tnative._ROOT / "build" / "fmcw_tpu_torch"


def test_file_frame_streamer_matches_jax(tmp_path, native_mods):
    rng = np.random.default_rng(0)
    shape = (8, 16, 2)
    frames = rng.integers(-1000, 1000, (5,) + shape).astype(np.int16)
    path = str(tmp_path / "frames.bin")
    frames.tofile(path)
    # A trailing partial frame is dropped.
    with open(path, "ab") as fh:
        fh.write(np.arange(7, dtype=np.int16).tobytes())
    got = {}
    for mod in native_mods:
        s = mod.FileFrameStreamer(path, shape, capacity=2, loops=3)
        got[mod] = list(s.frames())
        assert s.join() == 15 and s.join() == 15
    port, ref = got.values()
    assert len(port) == len(ref) == 15
    for i, (a, b) in enumerate(zip(port, ref)):
        assert np.array_equal(a, b) and np.array_equal(a, frames[i % 5])


def test_file_frame_streamer_missing_file_and_cancel(tmp_path, native_mods):
    for mod in native_mods:
        with pytest.raises(FileNotFoundError):
            s = mod.FileFrameStreamer(str(tmp_path / "nope.bin"), (4, 4, 2))
            s.join()
    shape = (2, 2, 2)
    path = str(tmp_path / "g.bin")
    np.arange(2 * 8, dtype=np.int16).tofile(path)
    for mod in native_mods:
        # An early consumer-side cancel unblocks the producer.
        s = mod.FileFrameStreamer(path, shape, capacity=1, loops=100000)
        assert next(iter(s.frames())) is not None
        s.close()
        s.close()                                   # idempotent


def test_frame_ring_matches_jax(native_mods):
    for mod in native_mods:
        ring = mod.FrameRing((2, 2, 2), capacity=2)
        f = np.zeros((2, 2, 2), np.int16)
        assert ring.try_push(f) and ring.try_push(f)
        assert not ring.try_push(f)                 # full: the drop
        assert ring.pop() is not None and ring.try_push(f + 1)
        ring.close()
        assert ring.push(f) is False and ring.try_push(f) is False
        assert ring.pop() is not None and ring.pop()[0, 0, 0] == 1
        assert ring.pop() is None
        with pytest.raises(ValueError):
            mod.FrameRing((4,), capacity=1).push(np.zeros(3, np.int16))


def test_native_parsers_match_jax(tmp_path, native_mods):
    m = np.arange(64 * 8, dtype=np.int64).reshape(64, 8) * 37 - 500
    paths = {}
    for mod, tag in zip(native_mods, ("port", "jax")):
        paths[tag] = str(tmp_path / f"{tag}.txt")
        mod.write_rdm_map(paths[tag], m)
    assert open(paths["port"], "rb").read() == open(paths["jax"], "rb").read()
    tmod, jmod = native_mods
    assert np.array_equal(tmod.read_rdm_map(paths["port"], 64, 8), m)
    iq = str(tmp_path / "iq.txt")
    with open(iq, "w") as fh:
        fh.write("".join(f"{i} {-2 * i}\n" for i in range(-5, 40)))
    assert np.array_equal(tmod.read_iq_pairs(iq), jmod.read_iq_pairs(iq))
    assert np.array_equal(tmod.parse_ints(iq, 1000),
                          jmod.parse_ints(iq, 1000))


def test_close_in_finally_keeps_the_exception(tmp_path, monkeypatch):
    """The producer fails (a directory where the file should be): the
    port's close() in a finally leaves the exception in flight, and join()
    raises the producer's error on every call; JAX's close() re-raises the
    producer's error over it (fault 3 of ROADMAP.md)."""
    monkeypatch.setattr(tnative, "_load", lambda: None)
    monkeypatch.setattr(jnative, "_load", lambda: None)
    s = tnative.FileFrameStreamer(str(tmp_path), (2, 2, 2))
    with pytest.raises(KeyError, match="in flight"):
        try:
            raise KeyError("in flight")
        finally:
            s.close()
    for _ in range(2):
        with pytest.raises(IsADirectoryError):
            s.join()
    j = jnative.FileFrameStreamer(str(tmp_path), (2, 2, 2))
    with pytest.raises(IsADirectoryError):
        try:
            raise KeyError("in flight")
        finally:
            j.close()
