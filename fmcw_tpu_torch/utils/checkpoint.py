"""Checkpoint/resume for long-lived processing state.

The reference's only long-lived state is the tracker's track file, lost on
reset (SURVEY.md §5 "checkpoint/resume: none").  The framework checkpoints
the WHOLE runtime state, so a multi-hour surveillance run (120+ scans)
resumes exactly where it stopped:

* tracker state — the carried pytree (tws_tracker.vhd:44-64's track file);
* scan counter — also fixes the PRF-stagger phase (``prf_hz[(scan-1) % 3]``,
  tb_tactical.vhd:211) and the scenario clock, both pure functions of it;
* ``runtime_state`` — everything else the run carries between frames: the
  hw-compat streaming CFAR's inter-frame line-buffer tail (``stream_hist``,
  models/pipeline.process_stream — without it a resumed stream would replay
  the 776-cell startup skip, os_cfar_2d.vhd:66-68, and emit a different
  detection set than an uninterrupted run), and the detection/track log byte
  positions (so a resume after a mid-batch crash truncates half-written log
  tails instead of duplicating them).

A copy of ``fmcw_tpu/utils/checkpoint.py`` with the same ``.npz`` layout,
so that a checkpoint of the port loads in the JAX package and one of the
JAX package loads here: tensors (a tracker state on the card) are saved
as the numpy arrays ``models.tracker.state_to_numpy`` gives; ``load``
returns numpy arrays, which ``run_surveillance`` (or
``tracker.state_from_numpy``) puts on the device.
tests/test_torch_surveillance.py pins resume-equivalence: a run
checkpointed mid-stream and resumed emits byte-identical logs and the same
final state as an uninterrupted run.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def save(path: str, tracker_state: dict, scan_index: int = 0,
         metadata: dict | None = None,
         runtime_state: dict | None = None) -> None:
    """Save tracker state + scan counter + arbitrary JSON metadata + extra
    runtime arrays (``runtime_state``: e.g. ``stream_hist``, log byte
    positions from :func:`log_positions`) to an .npz file."""
    arrays = {k: _host(v) for k, v in tracker_state.items()}
    arrays["__scan_index__"] = np.asarray(scan_index)
    arrays["__metadata__"] = np.frombuffer(
        json.dumps(metadata or {}).encode(), dtype=np.uint8)
    for k, v in (runtime_state or {}).items():
        arrays[f"__rt__{k}"] = _host(v)
    np.savez(path, **arrays)


def load(path: str):
    """Load a checkpoint -> (tracker_state, scan_index, metadata,
    runtime_state)."""
    with np.load(path) as z:
        scan_index = int(z["__scan_index__"])
        metadata = json.loads(bytes(z["__metadata__"]).decode())
        state = {k: z[k] for k in z.files if not k.startswith("__")}
        runtime = {k[len("__rt__"):]: z[k] for k in z.files
                   if k.startswith("__rt__")}
    return state, scan_index, metadata, runtime


def log_positions(det_log: str | None = None,
                  trk_log: str | None = None) -> dict:
    """Current byte positions of the run's log files, for ``runtime_state``.
    Call at the checkpoint boundary (after the checkpointed scan's lines
    are flushed)."""
    out = {}
    if det_log:
        out["det_log_pos"] = os.path.getsize(det_log)
    if trk_log:
        out["trk_log_pos"] = os.path.getsize(trk_log)
    return out


def restore_logs(runtime_state: dict, det_log: str | None = None,
                 trk_log: str | None = None) -> None:
    """Truncate log files back to the checkpointed byte positions — drops
    any lines written after the checkpoint (e.g. by a crashed batch), so
    the resumed run's appends continue the logs exactly."""
    for path, key in ((det_log, "det_log_pos"), (trk_log, "trk_log_pos")):
        if path and key in runtime_state and os.path.exists(path):
            with open(path, "r+b") as fh:
                fh.truncate(int(runtime_state[key]))
