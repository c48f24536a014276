"""TWS alpha-beta tracker in plain PyTorch — bit-exact vs
``fmcw_tpu/models/tracker.py`` (and so vs the golden model of
rtl/src/tws_tracker.vhd).

The scan FSM as integer tensor ops on the tracker's device:

* PREDICT/UPDATE are vectorized int32 ops over the track file;
* the sequential nearest-neighbor ASSOCIATE loop (earlier tracks claim
  detections first, tws_tracker.vhd:159-231) is a Python loop over track
  index carrying the claimed-detection mask;
* INITIATE's "first free slot" allocation (tws_tracker.vhd:233-263) is a
  rank match: the k-th unassociated detection (stream order) takes the k-th
  free slot (index order);
* fields wrap at the VHDL register widths (masked two's complement).

The TPU side has no kernel here either: the tracker runs at scan rate.
The state is a dict of int32 tensors; ``state_from_numpy`` /
``state_to_numpy`` carry a state across from (and back to) the JAX
package's numpy arrays.

``run_scans`` steps a batch of scans, as JAX's ``lax.scan`` over ``step``:
on the CPU a plain loop; on CUDA one ``step`` captured in a CUDA graph over
static buffers (``StepGraph``) and replayed once a scan, since ``step`` is
some thousands of small operations whose launches would otherwise lead the
surveillance loop.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from ..device import resolve_device
from ..params import TrackerParams
from ..golden.tracker import FREE, TENTATIVE, FIRM, COAST

_NO_DIST = (1 << 16) - 1


def _wrap(v, bits):
    m = 1 << bits
    half = m >> 1
    return ((v + half) & (m - 1)) - half


def _wrapu(v, bits):
    return v & ((1 << bits) - 1)


def _to_int32_saturating(x: torch.Tensor) -> torch.Tensor:
    """int32 as JAX's ``astype(jnp.int32)`` gives it: a float saturates to
    [-2^31, 2^31 - 1] and NaN maps to 0 (clamped in float64, which holds
    both ends exactly); an integer is cast as is."""
    if x.is_floating_point():
        x = x.double().nan_to_num(0.0).clamp(-2.0 ** 31, 2.0 ** 31 - 1)
    return x.to(torch.int32)


def init_state(tp: TrackerParams | None = None, device=None) -> dict:
    """An empty track file on ``device`` (None means CUDA; raises without
    a card — pass device="cpu" for the CPU)."""
    tp = tp or TrackerParams()
    device = resolve_device(device)
    z = torch.zeros(tp.max_tracks, dtype=torch.int32, device=device)
    st = {k: z.clone() for k in (
        "active", "status", "range_pos", "dopp_pos", "range_vel",
        "dopp_vel", "hit_count", "miss_count", "quality", "age",
        "last_mag")}
    st["assoc_best"] = torch.full((1,), _NO_DIST, dtype=torch.int32,
                                  device=device)
    return st


def state_from_numpy(state: dict, device=None) -> dict:
    """A tracker state of numpy (or JAX) int arrays -> int32 tensors on
    ``device`` (None means CUDA, as ``init_state``)."""
    device = resolve_device(device)
    return {k: torch.as_tensor(np.array(v), device=device).to(torch.int32)
            for k, v in state.items()}


def state_to_numpy(state: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in state.items()}


def step(state: dict, det_range: torch.Tensor, det_doppler: torch.Tensor,
         det_mag: torch.Tensor, det_valid: torch.Tensor,
         tp: TrackerParams = TrackerParams()):
    """One scan update.  Detection arrays are 1-D (length <= max_dets is
    used; longer arrays are truncated as the hardware's buffer would).
    Returns (new_state, report) with report carrying per-slot arrays plus a
    ``report_mask`` (firm/coast emissions) and ``active_tracks``."""
    s = {k: v.to(torch.int32).clone() for k, v in state.items()}
    dev = s["active"].device
    n = tp.max_tracks
    dr = torch.as_tensor(det_range, device=dev)[: tp.max_dets].to(torch.int32)
    dd = torch.as_tensor(det_doppler, device=dev)[: tp.max_dets].to(torch.int32)
    dm = _to_int32_saturating(
        torch.as_tensor(det_mag, device=dev)[: tp.max_dets])
    dv = torch.as_tensor(det_valid, device=dev)[: tp.max_dets].to(torch.bool)
    n_det = dv.shape[0]
    det_idx = torch.arange(n_det, device=dev)
    meas_r = _wrap(dr << 2, 12)
    meas_d = _wrap(dd << 2, 9)

    # PREDICT.
    act = s["active"] == 1
    s["range_pos"] = torch.where(act, _wrap(s["range_pos"] + s["range_vel"], 12),
                                 s["range_pos"])
    s["dopp_pos"] = torch.where(act, _wrap(s["dopp_pos"] + s["dopp_vel"], 9),
                                s["dopp_pos"])
    s["age"] = torch.where(act, _wrapu(s["age"] + 1, 8), s["age"])

    # ASSOCIATE + UPDATE, sequential over track index.  The chosen
    # detection is read with torch.take: indexing with a 0-d tensor would
    # bring the index to the host, which a CUDA graph cannot capture.
    claimed = torch.zeros_like(dv)
    for ti in range(n):
        active = s["active"][ti] == 1
        dist_r = (s["range_pos"][ti] - meas_r).abs()
        dist_d = (s["dopp_pos"][ti] - meas_d).abs()
        in_gate = (dv & ~claimed & (dist_r < tp.assoc_gate_r * 4)
                   & (dist_d < tp.assoc_gate_d * 4))
        dist = torch.where(in_gate, dist_r + dist_d, _NO_DIST)
        if tp.assoc == "hw":
            # VHDL signal semantics (tws_tracker.vhd:159-178): candidates
            # compare against the stale best carried from the previous
            # active track; the last qualifying detection index wins.
            qual = in_gate & (dist < s["assoc_best"][0])
            any_q = qual.any()
            best_i = torch.where(qual, det_idx, -1).max().clamp(min=0)
            best_d = torch.where(any_q, torch.take(dist, best_i), _NO_DIST)
            found = active & any_q
            s["assoc_best"] = torch.where(active, best_d.reshape(1),
                                          s["assoc_best"])
        else:
            best_i = torch.argmin(dist)        # first minimum wins ties
            found = active & (torch.take(dist, best_i) < _NO_DIST)

        innov_r = _wrap(torch.take(meas_r, best_i) - s["range_pos"][ti], 12)
        innov_d = _wrap(torch.take(meas_d, best_i) - s["dopp_pos"][ti], 9)
        old_hits = s["hit_count"][ti]
        old_miss = s["miss_count"][ti]
        status = s["status"][ti]
        hit_status = torch.where(
            (status == TENTATIVE) & (old_hits >= tp.init_hits), FIRM,
            torch.where(status == COAST, FIRM, status))
        miss_status = torch.where(old_miss >= tp.coast_max, FREE,
                                  torch.where(status == FIRM, COAST, status))
        new = {
            "range_pos": (_wrap(s["range_pos"][ti]
                                + ((innov_r * tp.alpha_gain) >> 8), 12),
                          s["range_pos"][ti]),
            "dopp_pos": (_wrap(s["dopp_pos"][ti]
                               + ((innov_d * tp.alpha_gain) >> 8), 9),
                         s["dopp_pos"][ti]),
            "range_vel": (_wrap(s["range_vel"][ti]
                                + ((innov_r * tp.beta_gain) >> 8), 10),
                          s["range_vel"][ti]),
            "dopp_vel": (_wrap(s["dopp_vel"][ti]
                               + ((innov_d * tp.beta_gain) >> 8), 8),
                         s["dopp_vel"][ti]),
            "hit_count": (_wrapu(old_hits + 1, 4), old_hits),
            "miss_count": (torch.zeros_like(old_miss), _wrapu(old_miss + 1, 4)),
            "last_mag": (torch.take(dm, best_i), s["last_mag"][ti]),
            "status": (hit_status, miss_status),
            "active": (s["active"][ti],
                       torch.where(old_miss >= tp.coast_max, 0,
                                   s["active"][ti])),
            "quality": ((s["quality"][ti] + 1).clamp(max=15),
                        (s["quality"][ti] - 1).clamp(min=0)),
        }
        for field, (hit_val, miss_val) in new.items():
            cur = s[field][ti]
            s[field][ti] = torch.where(found, hit_val,
                                       torch.where(active, miss_val, cur))
        claimed = claimed | ((det_idx == best_i) & found)

    # INITIATE: k-th unassociated detection -> k-th free slot.
    candidate = dv & ~claimed
    inactive = s["active"] == 0
    k_pairs = min(n, n_det)
    free_order = torch.argsort((~inactive).to(torch.int32), stable=True)
    det_order = torch.argsort((~candidate).to(torch.int32), stable=True)
    k = torch.arange(k_pairs, device=dev)
    pair_ok = (k < inactive.sum()) & (k < candidate.sum())
    slots = free_order[:k_pairs]
    dets = det_order[:k_pairs]
    ones = torch.ones(k_pairs, dtype=torch.int32, device=dev)
    zeros = torch.zeros_like(ones)
    for field, newvals in (
            ("active", ones), ("status", ones * TENTATIVE),
            ("range_pos", meas_r[dets]), ("dopp_pos", meas_d[dets]),
            ("range_vel", zeros), ("dopp_vel", zeros), ("hit_count", ones),
            ("miss_count", zeros), ("quality", ones), ("age", zeros),
            ("last_mag", dm[dets])):
        s[field][slots] = torch.where(pair_ok, newvals, s[field][slots])

    # MAINTAIN + OUTPUT.
    report_mask = (s["active"] == 1) & ((s["status"] == FIRM)
                                        | (s["status"] == COAST))
    report = {"id": torch.arange(n, dtype=torch.int32, device=dev),
              "range_pos": s["range_pos"], "dopp_pos": s["dopp_pos"],
              "range_vel": s["range_vel"], "dopp_vel": s["dopp_vel"],
              "quality": s["quality"], "status": s["status"],
              "report_mask": report_mask,
              "active_tracks": (s["active"] == 1).sum().to(torch.int32)}
    return s, report


class StepGraph:
    """One ``step`` captured in a CUDA graph: static input buffers (the
    state and one scan's K detections), the step, then its new state copied
    back into the input state inside the graph, so that a replay advances
    the carried state in place.  ``__call__`` copies one scan's detections
    in, replays, and returns the report's static tensors (overwritten by
    the next replay).  Its buffers are shared by every caller: hold
    ``lock`` from ``load`` until the results are cloned."""

    def __init__(self, tp: TrackerParams, device: torch.device, k: int,
                 mag_dtype: torch.dtype):
        self.lock = threading.Lock()
        self.state = init_state(tp, device)
        self.det = (torch.zeros(k, dtype=torch.int32, device=device),
                    torch.zeros(k, dtype=torch.int32, device=device),
                    torch.zeros(k, dtype=mag_dtype, device=device),
                    torch.zeros(k, dtype=torch.bool, device=device))
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(2):       # warm the allocator and the sort
                step(self.state, *self.det, tp=tp)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            new, self.report = step(self.state, *self.det, tp=tp)
            for key, val in new.items():
                self.state[key].copy_(val)

    def load(self, state: dict) -> None:
        for key, val in state.items():
            self.state[key].copy_(val)

    def __call__(self, dr, dd, dm, dv) -> dict:
        for buf, x in zip(self.det, (dr, dd, dm, dv)):
            buf.copy_(x)
        self.graph.replay()
        return self.report


@functools.lru_cache(maxsize=8)
def step_graph(tp: TrackerParams, device: torch.device, k: int,
               mag_dtype: torch.dtype) -> StepGraph:
    """The StepGraph of (tp, device, K, magnitude type), captured once and
    reused, as JAX's jitted scan is compiled once for its static ``tp``."""
    return StepGraph(tp, device, k, mag_dtype)


def run_scans(det_range, det_doppler, det_mag, det_valid,
              tp: TrackerParams | None = None, state: dict | None = None,
              device=None):
    """Step a batch of scans: inputs are (n_scans, K) arrays (numpy or
    tensors); returns (final_state, stacked reports), each report entry
    with a leading scan axis — ``fmcw_tpu.models.tracker.run_scans``.  The
    state's device is the tracker's; with no state, an empty one on
    ``device`` (None means CUDA, as ``init_state``).  On CUDA each scan is
    one replay of ``step_graph``; elsewhere a loop of ``step``.

    The graph's state and report buffers are shared between callers with
    the same (tp, device, K, magnitude type), so a call holds the graph's
    lock from loading the state until its results are cloned: threads may
    call at once, and are served one after another.  The first call for a
    key captures the graph, and no other thread may launch work on the card
    while it does (a dispatch that the watchdog gave up on still may)."""
    tp = tp or TrackerParams()
    if state is None:
        state = init_state(tp, device)
    dev = state["active"].device
    dets = [torch.as_tensor(x, device=dev)
            for x in (det_range, det_doppler, det_mag, det_valid)]
    n_scans = dets[0].shape[0]
    if n_scans == 0:
        raise ValueError("run_scans needs at least one scan")
    reports = []
    if dev.type == "cuda":
        # The graph takes K <= max_dets, as step truncates; copy_ casts.
        dets = [x[:, :tp.max_dets] for x in dets]
        graph = step_graph(tp, dev, dets[0].shape[1], dets[2].dtype)
        with graph.lock:
            graph.load(state)
            for i in range(n_scans):
                rep = graph(*(x[i] for x in dets))
                reports.append({key: v.clone() for key, v in rep.items()})
            state = {key: v.clone() for key, v in graph.state.items()}
    else:
        for i in range(n_scans):
            state, rep = step(state, *(x[i] for x in dets), tp=tp)
            reports.append(rep)
    return state, {key: torch.stack([r[key] for r in reports])
                   for key in reports[0]}
