"""Pd/Pfa detection-quality sweep CLI (BASELINE config 4 flavor).

    python -m fmcw_tpu_torch.tools.detection_eval [--full] [--trials N]
        [--cpu] [--variants os,ca,go,so] [--scale-mode cell|block]
        [--json OUT] [--artifact OUT]

Port of ``tools/detection_eval.py``, with its flags and outputs: prints a
Pd-vs-SNR / Pfa table per CFAR variant (``fmcw_tpu_torch/utils/eval.py``).
It runs on the card; ``--cpu`` runs the plain PyTorch path on the CPU
instead, and without it the tool raises where there is no card.  Quick
mode (default) is a 256x64 map.

Each configuration takes the processor's float "auto" route, as JAX's
tool does: the kernels where kernel B's tile takes it, else the staged
route (``models/pipeline.resolve_frontend``), and the tool prints which: a
block scale of ``scale_block=2`` on the 256x64 map (the default and the
artifact's block section) has more blocks than kernel B's tile holds.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

from ..device import resolve_device
from ..golden.fixed_point import hw_stream_lag
from ..models.pipeline import resolve_frontend
from ..params import CfarParams, RadarParams
from ..utils import eval as ev

# The canonical artifact's spec (EVAL.json, tools/detection_eval.py:46-48):
# a 256x64 map, seed 0, both scale modes, all variants; and its 3D arm's
# (:93-95): per-element SNRs ~9 dB below the 2D spec's (the 8-element
# array gain), so that the curves probe the same region.
ARTIFACT_SPEC = dict(n_range=256, n_doppler=64, trials=64, noise_trials=32,
                     seed=0, sigma=64.0, tolerance=1, mti_bypass=True,
                     snr_dbs=[-35, -30, -27, -24, -21, -18])
ARTIFACT_SPEC_3D = dict(n_elems=8, n_beams=8, ref_angle=1, guard_angle=0,
                        trials=32, noise_trials=16,
                        snr_dbs=[-44, -40, -36, -33, -30, -27])


def _summary(res: dict) -> dict:
    return {v: {"pfa": r["pfa"],
                "pd": {str(k): pd for k, pd in r["pd"].items()}}
            for v, r in res.items()}


def _sweep(p: RadarParams, device, **kw) -> dict:
    route = resolve_frontend("float32", "auto", p)
    print(f"route: frontend='auto' -> {route!r} ({p.n_range}x{p.n_doppler}, "
          f"scale_mode={p.cfar.scale_mode}, scale_block="
          f"{p.cfar.scale_block}, device {device})", file=sys.stderr)
    return ev.pd_pfa(p, device=device, **kw)


def write_artifact(path: str, device) -> dict:
    """The canonical pinned eval artifact, EVAL.json's layout: both scale
    modes over all variants, the hw-compat detector and the 3D
    (ref_angle 1) detector, each table printed."""
    spec, spec3d = ARTIFACT_SPEC, ARTIFACT_SPEC_3D
    common = dict(trials=spec["trials"], noise_trials=spec["noise_trials"],
                  seed=spec["seed"], sigma=spec["sigma"],
                  tolerance=spec["tolerance"],
                  snr_dbs=tuple(spec["snr_dbs"]))
    art = {"spec": dict(spec), "results": {}}
    for mode in ("cell", "block"):
        p = RadarParams(n_range=spec["n_range"], n_doppler=spec["n_doppler"],
                        cfar=CfarParams(scale_mode=mode, scale_block=2))
        res = _sweep(p, device, variants=("os", "ca", "go", "so"), **common)
        art["results"][mode] = _summary(res)
        print(f"--- scale_mode={mode} ---")
        print(ev.format_table(res))
    # The as-built (hw-compat) detector: crossed-axis streaming geometry at
    # label coordinates -- truth matching compensates the -3-cell label
    # offset, placement avoids the one-shot framing's never-emitted tail
    # rows (utils/eval.pd_pfa docstring).
    p_hw = RadarParams(n_range=spec["n_range"], n_doppler=spec["n_doppler"],
                       cfar=CfarParams())
    margin = math.ceil(hw_stream_lag(p_hw.cfar, p_hw.n_doppler)
                       / p_hw.n_doppler) + 1
    res = ev.pd_pfa(p_hw, variants=("os",),
                    processor_kw={"cfar_geometry": "hw_stream"},
                    truth_doppler_offset=-3, range_hi_margin=margin,
                    device=device, **common)
    art["results"]["hw_stream"] = _summary(res)
    print("--- hw-compat (as-built streaming geometry) ---")
    print(ev.format_table(res))
    # The angle-extended (3D, ref_angle=1) detector: 8-element ULA -> 8
    # beams, the training set spanning neighbour beams; per-element SNRs
    # (utils/eval.pd_pfa_3d docstring).
    art["spec_3d"] = dict(spec3d)
    p3 = RadarParams(n_range=spec["n_range"], n_doppler=spec["n_doppler"],
                     cfar=CfarParams())
    res = ev.pd_pfa_3d(p3, n_elems=spec3d["n_elems"],
                       n_beams=spec3d["n_beams"],
                       ref_angle=spec3d["ref_angle"],
                       guard_angle=spec3d["guard_angle"],
                       trials=spec3d["trials"],
                       noise_trials=spec3d["noise_trials"],
                       seed=spec["seed"], sigma=spec["sigma"],
                       tolerance=spec["tolerance"],
                       snr_dbs=tuple(spec3d["snr_dbs"]), device=device)
    art["results"]["angle_ref1"] = _summary(res)
    print("--- angle-extended 3D (ref_angle=1, per-element SNR) ---")
    print(ev.format_table(res))
    with open(path, "w") as f:
        json.dump(art, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {path}", file=sys.stderr)
    return art


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fmcw_tpu_torch.tools.detection_eval",
        description="Pd/Pfa sweep per CFAR variant")
    ap.add_argument("--full", action="store_true",
                    help="full 1024x128 CPI (default: 256x64)")
    ap.add_argument("--trials", type=int, default=32)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU (default: "
                         "the card)")
    ap.add_argument("--variants", default="os,ca,go,so")
    ap.add_argument("--scale-mode", default="cell", choices=["cell", "block"])
    ap.add_argument("--json", default=None, metavar="OUT")
    ap.add_argument("--artifact", default=None, metavar="OUT",
                    help="write the canonical pinned eval artifact "
                         "(EVAL.json's layout): 256x64 map, seed 0, both "
                         "scale modes, all variants, the hw-compat and 3D "
                         "detectors")
    args = ap.parse_args(argv)
    # Raises here, before any work, where the card is asked for and absent.
    device = resolve_device("cpu" if args.cpu else None)

    if args.artifact:
        write_artifact(args.artifact, device)
        return 0

    cfar = CfarParams(scale_mode=args.scale_mode,
                      scale_block=8 if args.full else 2)
    p = (RadarParams(cfar=cfar) if args.full
         else RadarParams(n_range=256, n_doppler=64, cfar=cfar))
    res = _sweep(p, device, variants=tuple(args.variants.split(",")),
                 trials=args.trials)
    print(ev.format_table(res))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(_summary(res), f, indent=1)
        print(f"wrote {args.json}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
