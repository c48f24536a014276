"""ctypes bindings for the native fmcwio library (native/fmcwio.cpp).

Port of ``fmcw_tpu/runtime/native.py``: fast parsers of the reference text
formats, a blocking SPSC ring of int16 frames and a threaded file streamer
(a C++ producer thread filling the ring, so disk reads overlap the
processor), with a pure-Python fallback when the library cannot be loaded
or built.

The library is the repository's committed ``native/fmcwio.so``, loaded
read-only.  If it does not load (another platform), ``native/fmcwio.cpp``
is built with ``g++`` into the gitignored ``build/`` beside the package;
nothing is ever written under ``native/``.  If that fails too, the numpy
and Python-thread fallbacks serve (host file I/O, no device path).

One difference from JAX's module: ``FileFrameStreamer.close()`` swallows
the producer's error, so a ``close()`` in a ``finally`` never replaces an
exception already in flight; ``join()`` raises it, on every call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
_SRC = _ROOT / "native" / "fmcwio.cpp"
_SO = _ROOT / "native" / "fmcwio.so"
_lock = threading.Lock()
_lib = None
_tried = False


def _built() -> Path:
    """Build native/fmcwio.cpp into build/ (named by its source's hash, so
    an edited source is rebuilt) and return the library's path."""
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    out = _ROOT / "build" / "fmcw_tpu_torch" / f"fmcwio_{tag}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                        "-o", str(tmp), str(_SRC), "-lpthread"],
                       check=True, capture_output=True)
        tmp.replace(out)
    return out


def _declare(lib) -> None:
    lib.fmcwio_parse_ints.restype = ctypes.c_long
    lib.fmcwio_parse_ints.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_long]
    lib.fmcwio_write_rdm.restype = ctypes.c_int
    lib.fmcwio_write_rdm.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.c_int]
    lib.fmcwio_ring_create.restype = ctypes.c_void_p
    lib.fmcwio_ring_create.argtypes = [ctypes.c_long, ctypes.c_int]
    lib.fmcwio_ring_destroy.argtypes = [ctypes.c_void_p]
    for fn in ("fmcwio_ring_push", "fmcwio_ring_try_push",
               "fmcwio_ring_pop"):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16)]
    lib.fmcwio_ring_close.argtypes = [ctypes.c_void_p]
    lib.fmcwio_ring_size.restype = ctypes.c_int
    lib.fmcwio_ring_size.argtypes = [ctypes.c_void_p]
    lib.fmcwio_stream_file.restype = ctypes.c_void_p
    lib.fmcwio_stream_file.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.fmcwio_stream_join.restype = ctypes.c_long
    lib.fmcwio_stream_join.argtypes = [ctypes.c_void_p]


def _load():
    """The library (the committed one, else one built into build/), or
    None: the fallbacks then serve."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        for path in (lambda: _SO, _built):
            try:
                lib = ctypes.CDLL(str(path()))
                _declare(lib)
                _lib = lib
                break
            except (OSError, AttributeError, subprocess.SubprocessError):
                continue
        return _lib


def available() -> bool:
    return _load() is not None


def parse_ints(path: str, max_values: int) -> np.ndarray:
    """Parse all integers in a text file (native if available)."""
    lib = _load()
    if lib is None:
        return np.loadtxt(path, dtype=np.int64).ravel().astype(np.int32)
    out = np.empty(max_values, dtype=np.int32)
    n = lib.fmcwio_parse_ints(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        max_values)
    if n < 0:
        raise FileNotFoundError(path)
    return out[:n]


def read_iq_pairs(path: str, max_samples: int = 1 << 22) -> np.ndarray:
    """Native-speed version of utils.io.read_iq_pairs."""
    v = parse_ints(path, 2 * max_samples)
    v = v.reshape(-1, 2)
    return v[:, 0].astype(np.float64) + 1j * v[:, 1].astype(np.float64)


def read_rdm_map(path: str, n_range: int = 1024,
                 n_doppler: int = 128) -> np.ndarray:
    """Native-speed version of utils.io.read_rdm_map (5-column format).

    The value cap is sized from the file (every int token including its
    separator is >= 2 bytes) so a log holding many CPIs parses completely
    and the numpy path's "later duplicate cells win" overwrite contract
    holds identically here — a fixed cap would silently keep the EARLY
    CPIs' magnitudes instead."""
    cap = max(os.path.getsize(path) // 2 + 8, 5)
    v = parse_ints(path, cap)
    v = v[: (len(v) // 5) * 5].reshape(-1, 5)
    m = np.zeros((n_range, n_doppler), dtype=np.int64)
    m[v[:, 0], v[:, 1]] = v[:, 4]
    return m


def write_rdm_map(path: str, mag_map: np.ndarray) -> None:
    lib = _load()
    m = np.ascontiguousarray(np.asarray(mag_map), dtype=np.int32)
    if lib is None:
        from ..utils.io import write_rdm_map as slow
        return slow(path, m)
    rc = lib.fmcwio_write_rdm(
        path.encode(), m.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        m.shape[0], m.shape[1])
    if rc != 0:
        raise IOError(f"write failed: {path}")


class FrameRing:
    """Blocking SPSC ring of int16 frames (native; python-queue fallback).

    Producer thread synthesizes/reads frames; consumer feeds the device.
    ``try_push`` returning False is the overflow condition (frame drop)."""

    def __init__(self, frame_shape: tuple, capacity: int = 4):
        self.frame_shape = tuple(frame_shape)
        self.elems = int(np.prod(frame_shape))
        self._lib = _load()
        if self._lib is not None:
            self._ring = self._lib.fmcwio_ring_create(self.elems, capacity)
        else:
            import queue
            self._q = queue.Queue(maxsize=capacity)
            self._closed = threading.Event()

    def _ptr(self, arr):
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))

    def _checked(self, frame) -> np.ndarray:
        # The native side memcpys exactly frame_elems*2 bytes from the raw
        # pointer — an undersized array would be an out-of-bounds read, so
        # the shape contract is enforced here, on both backends alike.
        f = np.ascontiguousarray(frame, dtype=np.int16)
        if f.shape != self.frame_shape:
            raise ValueError(
                f"frame shape {f.shape} != ring frame shape "
                f"{self.frame_shape}")
        return f

    def push(self, frame: np.ndarray) -> bool:
        """Blocking push; False once the ring is closed (native semantics,
        mirrored by the fallback via a poll so close() always cancels)."""
        import queue
        f = self._checked(frame)
        if self._lib is not None:
            return self._lib.fmcwio_ring_push(self._ring, self._ptr(f)) == 0
        while not self._closed.is_set():
            try:
                self._q.put(f.copy(), timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def try_push(self, frame: np.ndarray) -> bool:
        import queue
        f = self._checked(frame)
        if self._lib is not None:
            return self._lib.fmcwio_ring_try_push(self._ring, self._ptr(f)) == 1
        if self._closed.is_set():
            return False
        try:
            self._q.put_nowait(f.copy())
            return True
        except queue.Full:      # ONLY the overflow condition reads as a drop
            return False

    def pop(self) -> np.ndarray | None:
        import queue
        if self._lib is not None:
            out = np.empty(self.frame_shape, dtype=np.int16)
            rc = self._lib.fmcwio_ring_pop(self._ring, self._ptr(out))
            return out if rc == 0 else None
        while True:
            try:
                item = self._q.get(timeout=0.05)
            except queue.Empty:
                if self._closed.is_set():
                    return None
                continue
            return item

    def close(self):
        if self._lib is not None:
            self._lib.fmcwio_ring_close(self._ring)
        else:
            self._closed.set()

    def __del__(self):
        try:
            if self._lib is not None:
                self._lib.fmcwio_ring_destroy(self._ring)
        except Exception:
            pass


class FileFrameStreamer:
    """Native threaded data loader: streams fixed-size int16 frames from a
    raw binary file into a FrameRing on a C++ thread (no GIL), so disk IO
    overlaps preprocessing and device compute.  Python-thread fallback when
    the native library is unavailable.

    Usage::

        s = FileFrameStreamer(path, (n_doppler, n_range, 2), loops=4)
        for frame in s.frames():
            ...                       # blocking-pop until the file drains
        pushed = s.join()             # frames produced (raises on IO error)
    """

    def __init__(self, path: str, frame_shape: tuple, capacity: int = 4,
                 loops: int = 1):
        self.ring = FrameRing(frame_shape, capacity=capacity)
        self._path = path
        self._loops = loops
        self._joined = None
        if self.ring._lib is not None:
            if not os.path.exists(path):   # fail fast, not on the C++ thread
                raise FileNotFoundError(path)
            self._job = self.ring._lib.fmcwio_stream_file(
                self.ring._ring, path.encode(), loops)
        else:
            self._job = None
            self._pushed = 0
            self._err = None

            def _produce():
                try:
                    elems = self.ring.elems
                    for _ in range(loops):
                        # Stream one frame per read (the native thread's
                        # behavior): a multi-GB capture never materializes
                        # whole in memory; a trailing partial frame is
                        # dropped, same as the C++ loop.
                        with open(path, "rb") as fh:
                            while True:
                                buf = np.fromfile(fh, dtype=np.int16,
                                                  count=elems)
                                if len(buf) < elems:
                                    break
                                if not self.ring.push(
                                        buf.reshape(frame_shape)):
                                    return
                                self._pushed += 1
                except Exception as e:  # surfaced by join()
                    self._err = e
                finally:
                    self.ring.close()

            self._th = threading.Thread(target=_produce, daemon=True)
            self._th.start()

    def frames(self):
        """Yield frames until the file (all loops) is drained."""
        while (f := self.ring.pop()) is not None:
            yield f

    def join(self) -> int:
        """Wait for the producer; return the number of frames pushed.
        Raises the producer's IO error — on EVERY call, not just the first
        (the -1 sentinel survives, so a later close()/join() re-raises
        instead of dereferencing a thread handle native mode never had)."""
        if self._joined is None:
            if self._job is not None:
                self._joined = int(self.ring._lib.fmcwio_stream_join(
                    self._job))
                self._job = None
            else:
                self._th.join()
                self._joined = -1 if self._err is not None else self._pushed
        if self._joined == -1:
            if getattr(self, "_err", None) is not None:
                raise self._err
            raise FileNotFoundError(self._path)
        return self._joined

    def close(self) -> None:
        """Cancel the stream: close the ring (unblocks the producer) and
        join the producer thread.  Idempotent; called by __del__ so the
        native thread can never outlive the ring it writes into.  The
        producer's error is swallowed here (``join()`` raises it): a
        ``close()`` in a ``finally`` must not replace an exception already
        in flight."""
        self.ring.close()
        try:
            self.join()
        except Exception:
            pass

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
