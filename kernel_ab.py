#!/usr/bin/env python3
"""Time the float front-end kernels of one checkout of fmcw_tpu_torch.

    python3 kernel_ab.py --root DIR

Imports fmcw_tpu_torch from DIR (which builds its kernels under DIR/build),
then times kernel A (``range_fft``) and kernel B (``slowtime_detect``, per-cell
and block scale, ``peak_group_radius=2``) with CUDA events at the main path's
shapes: batch 128 of 1024x128 frames, chip_smoke.py's stimulus.  Prints the
card's name and power limit and one JSON line.  To compare two commits on
one card, unpack the other commit into a directory (``git archive``) and run
this script on both in one session, alternating: A, B, B, A.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

BATCH = 128


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--root", required=True, type=Path,
                    help="checkout whose fmcw_tpu_torch is timed")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve()))
    import numpy as np
    import fmcw_tpu_torch as P
    from fmcw_tpu_torch import kernels
    from fmcw_tpu_torch.golden import reference
    from fmcw_tpu_torch.models import pipeline as pl
    from fmcw_tpu_torch.ops import frontend as F

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    kernels.load()

    def cuda_ms(fn, iters=50, warmup=5):
        for _ in range(warmup):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    entry = P.RadarParams()
    rng = np.random.default_rng(0)
    frame = pl.complex_to_iq(reference.two_target_frame(entry))
    iq = np.stack([frame] * BATCH)
    iq = iq + rng.integers(-8, 8, iq.shape).astype(np.int16)
    iq = torch.as_tensor(iq, device="cuda")
    re, im = F.range_fft(iq)
    ms = {"range_fft": cuda_ms(lambda: F.range_fft(iq))}
    for p in (entry, P.fast()):
        kw = dict(cfar=p.cfar, peak_group_radius=2)
        ms[f"slowtime_detect[{p.cfar.scale_mode}]"] = cuda_ms(
            lambda: F.slowtime_detect(re, im, False, 0, **kw))
    print(json.dumps({"root": str(args.root), "ms": ms,
                      "batch": BATCH, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
