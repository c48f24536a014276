"""Streaming multi-frame runtime: double-buffered ingest + overlapped dispatch.

The reference overlaps everything in hardware: while the corner turner's
write bank fills with frame N, the read bank drains frame N-1, and an
``overflow_error`` fires if the consumer lags (rtl/src/corner_turner.vhd:
31-36,94-96).  The port of ``fmcw_tpu/runtime/stream.py`` on CUDA streams:

* each frame is staged in a pinned host buffer and copied to the card on a
  copy stream (``non_blocking``), while earlier frames compute; the
  compute stream (the caller's current stream) waits on the copy's event,
  and the device tensor is recorded on the compute stream, so that the
  allocator does not hand its memory back to the copy stream early;
* a pinned buffer goes back to the pool only when its frame's results are
  retired, so it is never overwritten while its copy may still run;
* a bounded in-flight window provides backpressure; in ``drop`` mode an
  overloaded pipeline skips input frames and counts them (the
  overflow_error analog) instead of stalling the source.  A result is
  ready when the event recorded after its dispatch has fired
  (``torch.cuda.Event.query``), as JAX's ``is_ready``; waiting for it is
  ``Event.synchronize``.

On the CPU (``device="cpu"``) the processor runs synchronously and every
result is ready at once.  Use ``stream()`` for a simple generator pipeline
or ``StreamStats`` for the accounting.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass
class StreamStats:
    frames_in: int = 0
    frames_processed: int = 0
    frames_dropped: int = 0   # overflow_error analog


class _Ingest:
    """Host -> device copies for one stream: pinned staging buffers, a copy
    stream, and one event a dispatch.  On the CPU a plain conversion."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.free: list[torch.Tensor] = []
        if self.cuda:
            self.copy_stream = torch.cuda.Stream(device)
            self.compute = torch.cuda.current_stream(device)

    def put(self, arr: np.ndarray):
        """Stage ``arr`` and copy it to the device; returns (device tensor,
        pinned buffer or None)."""
        if not self.cuda:
            return torch.as_tensor(np.asarray(arr)), None
        arr = np.asarray(arr)
        dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
        buf = next((b for b in self.free
                    if b.shape == arr.shape and b.dtype == dtype), None)
        if buf is None:
            buf = torch.empty(arr.shape, dtype=dtype, pin_memory=True)
        else:
            self.free.remove(buf)
        buf.numpy()[...] = arr
        with torch.cuda.stream(self.copy_stream):
            dev = buf.to(self.device, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self.copy_stream)
        self.compute.wait_event(copied)
        dev.record_stream(self.compute)
        return dev, buf

    def dispatched(self):
        """An event recorded on the compute stream after a dispatch (None
        on the CPU)."""
        if not self.cuda:
            return None
        done = torch.cuda.Event()
        done.record(self.compute)
        return done

    def retire(self, buf) -> None:
        """The results of ``buf``'s frame are complete: so is its copy."""
        if buf is not None:
            self.free.append(buf)


def _ready(done) -> bool:
    return done is None or done.query()


def _wait(done) -> None:
    if done is not None:
        done.synchronize()


def stream(proc: Callable, frames: Iterable[np.ndarray], depth: int = 2,
           policy: str = "block", stats: StreamStats | None = None,
           device=None, **proc_kw) -> Iterator[dict]:
    """Pipeline ``frames`` (int16 iq arrays) through ``proc``.

    Yields output dicts in order.  At most ``depth`` frames are in flight:
    transfers and compute for later frames overlap the consumer's use of
    earlier results.  ``policy``:

    * ``"block"`` — backpressure the source (the AXI-Stream ready/valid
      analog): wait for the oldest result before admitting a new frame.
    * ``"drop"`` — if the window is full and the oldest result is not ready,
      drop the incoming frame and count it (frame-drop accounting under
      overload, cf. corner_turner.vhd:94-96).

    ``device``: where the frames go (None means CUDA; raises without a
    card — pass "cpu" for the CPU); ``proc`` should run there.
    """
    if policy not in ("block", "drop"):
        raise ValueError(policy)
    st = stats if stats is not None else StreamStats()
    ingest = _Ingest(resolve_device(device))
    inflight: deque = deque()

    for f in frames:
        st.frames_in += 1
        if len(inflight) >= depth:
            if policy == "drop" and not _ready(inflight[0][1]):
                st.frames_dropped += 1
                continue
            out, done, buf = inflight.popleft()
            _wait(done)
            ingest.retire(buf)
            st.frames_processed += 1
            yield out
        dev, buf = ingest.put(f)                          # async H2D
        out = proc(dev, **proc_kw)                        # async dispatch
        inflight.append((out, ingest.dispatched(), buf))
    while inflight:
        out, done, buf = inflight.popleft()
        _wait(done)
        ingest.retire(buf)
        st.frames_processed += 1
        yield out


class FrameAssembler:
    """Assemble whole CPI frames from arbitrarily-chunked sample streams.

    The reference ingests one sample per clock with tvalid gaps and
    backpressure (every TB exercises this — SURVEY.md §4); the framework
    ingests whole frames, so this adapter reassembles them: feed int16 I/Q
    sample chunks of any length (the AXI-Stream analog), get complete
    (n_doppler, n_range, 2) frames out.  Chunk boundaries never affect the
    result (property-tested in tests/test_torch_runtime.py).
    """

    def __init__(self, n_doppler: int, n_range: int):
        self.shape = (n_doppler, n_range, 2)
        self._frame_samples = n_doppler * n_range
        self._buf = np.zeros((self._frame_samples, 2), dtype=np.int16)
        self._fill = 0

    def push(self, chunk: np.ndarray) -> list[np.ndarray]:
        """``chunk``: (k, 2) int16 I/Q samples.  Returns the list of frames
        completed by this chunk (usually empty or one)."""
        chunk = np.asarray(chunk, dtype=np.int16).reshape(-1, 2)
        done = []
        pos = 0
        while pos < len(chunk):
            take = min(len(chunk) - pos, self._frame_samples - self._fill)
            self._buf[self._fill: self._fill + take] = chunk[pos: pos + take]
            self._fill += take
            pos += take
            if self._fill == self._frame_samples:
                done.append(self._buf.reshape(self.shape).copy())
                self._fill = 0
        return done

    @property
    def pending_samples(self) -> int:
        return self._fill


def stream_batched(proc: Callable, frames: Iterable[np.ndarray],
                   batch_size: int, depth: int = 2,
                   stats: StreamStats | None = None, device=None, **proc_kw
                   ) -> Iterator[dict]:
    """Accumulate frames into device batches for a batch processor — the
    throughput configuration (amortizes dispatch overhead over batch_size
    frames).  The final partial batch is zero-padded and its pad results
    masked off via the "batch_valid" key added to each yielded dict.
    ``device`` as ``stream``."""
    st = stats if stats is not None else StreamStats()
    ingest = _Ingest(resolve_device(device))
    buf: list = []

    def batches():
        nonlocal buf
        for f in frames:
            st.frames_in += 1
            buf.append(f)
            if len(buf) == batch_size:
                yield np.stack(buf), batch_size
                buf = []
        if buf:
            pad = [np.zeros_like(buf[0])] * (batch_size - len(buf))
            yield np.stack(buf + pad), len(buf)

    inflight: deque = deque()
    for arr, n_valid in batches():
        dev, pinned = ingest.put(arr)
        out = proc(dev, **proc_kw)
        out["batch_valid"] = n_valid
        inflight.append((out, ingest.dispatched(), pinned))
        if len(inflight) >= depth:
            o, done, pinned = inflight.popleft()
            _wait(done)
            ingest.retire(pinned)
            st.frames_processed += o["batch_valid"]
            yield o
    while inflight:
        o, done, pinned = inflight.popleft()
        _wait(done)
        ingest.retire(pinned)
        st.frames_processed += o["batch_valid"]
        yield o
