#!/usr/bin/env python3
"""Time the front-end kernels and the main path of one checkout of
fmcw_tpu_torch.

    python3 kernel_ab.py --root DIR

Imports fmcw_tpu_torch from DIR (which builds its kernels under DIR/build),
then times with CUDA events, at the main path's shapes (chip_smoke.py's
stimulus, 1024x128 frames):

* kernel A's three entries — ``range_fft`` on a batch of 128 int16 frames,
  ``range_fft_float`` on 128 float32 beam maps (the array model's 16 cubes
  x 8 beams), and the row-3 chirp shard (``split_frontend.range_frontend``
  on a 32-chirp slice, sp = 4) — each beside ``torch.fft.fft`` of the same
  windowed chirps (complex64), as back-to-back calls and as one call
  replayed from a CUDA graph (the device time, without the host's per-call
  overhead); and the first two beside a memory-only PyTorch call that moves
  the same bytes (an int16 -> float32 conversion; a copy of the two float32
  planes);
* kernel B's four entries — ``slowtime_detect`` per-cell and block scale
  (``peak_group_radius=2``), ``slowtime_mag`` and the row-5 range shard
  (``split_frontend.slowtime_detect_split`` on rows 256..512 with their
  halo rows, sp = 4) — and the fixed slow-time kernel's three —
  ``slowtime_detect_fixed`` per-cell and block and the row-6 range shard
  (``split_frontend.slowtime_detect_fixed_split``, the same rows) — as
  back-to-back calls and by graph replay, each beside
  ``torch.fft.fft(dim=-1)`` of the same planes (complex64; complex128 for
  the fixed kernel's int16 planes), the slow-time transform's share: no
  PyTorch call computes a whole entry;
* the fixed range kernel's two entries — ``range_fft_fixed`` at batch 128 and
  the row-4 chirp shard (``split_frontend.range_frontend_fixed``, sp = 4)
  — as back-to-back calls and by graph replay, each beside
  ``torch.fft.fft`` (complex128) of the same windowed chirps and a
  memory-only corner turn of its input (``iq.transpose(1, 2).contiguous()``,
  4 bytes a sample read and written);
* the rank-select CFAR behind the debug taps (``csrc/cfar_rank.cu``,
  ``ops/cfar_rank.cfar_rank``) at batch 128 on the float main path's
  magnitudes and the fixed chain's int32 magnitudes: float 16 key bits,
  float exact, float exact with a given block scale map, int32 16 bits —
  and, where the checkout has it, the grouping entry ``cfar_rank_group``
  (radius 2) on the three the debug routes launch — as back-to-back calls
  and by graph replay;
* the 3D CFAR (TPU row 10, ``csrc/cfar_3d_detect.cu``,
  ``ops/cfar3d_detect.cfar3d_detect``) at the 3D array route's shapes:
  ``ref_angle=1`` on the magnitude cubes of 16 cubes x 8 beams
  (chip_smoke.py's array stimulus: the golden two-target frame on 8
  elements at steering sine 0.3, beamformed, ``range_fft_float``,
  ``slowtime_mag``), and its prepadded entry on the sp = 4 beam shard (2
  beams and one neighbour plane on each side), as back-to-back calls and by
  graph replay;
* main-path frames/s through ``make_batch_processor``, per-cell and block,
  float and fixed mode's fused route; the debug-tap routes
  (``include_debug=True``): float per-cell and block on "fused", fixed
  per-cell on "auto"; and the 3D array route's cubes/s
  (``make_batch_array_processor(ref_angle=1)``, 16 cubes).

* the standalone CFAR (TPU rows 7 and 8, ``csrc/cfar_detect.cu``,
  ``ops/cfar_detect.cfar_detect``) at batch 128: per-cell and with a given
  block scale map, on the fixed chain's int32 magnitudes and the float
  staged chain's float32 magnitudes, and, where the checkout has it, its
  grouping entry ``cfar_detect_group`` (radius 2) on the same four; its
  prepadded entry on the sp = 4 range shard of a block-scale map (rows
  256..512 and their halo rows); as back-to-back calls and by graph replay;
  and the staged routes' frames/s: fixed ``auto`` and float ``staged``,
  per-cell and block, radius 2; where the checkout has it, the
  flat-stream entry ``cfar_detect_hw_stream`` (TPU row 7 with
  ``prepadded_range="both"``, the hw-compat streaming CFAR) on the
  one-shot ext streams of the same int32 and float32 maps, and the
  hw-compat routes' frames/s (``cfar_geometry="hw_stream"``, fixed
  ``auto`` and float ``fused``, radius 2).

With ``--cfar3d-only`` it times the 3D CFAR's two entries and the 3D array
route alone, with ``--cfar-detect-only`` the standalone CFAR's entries and
the staged routes alone, with ``--beam-group-only`` the cross-beam
grouping (TPU row 11, ``csrc/beam_group.cu``) alone: its whole-cube entry
(radius 1 on kernel B's per-cell det cubes of 16 cubes x 8 beams) and its
sp = 4 shard entry (2 beams and one halo plane on each side, global beam
ids), eager and by graph replay, and the array route it ends, per-cell
grouped, in cubes/s (a design step's A/B).  Prints the card's name and
power limit
and one JSON line.  To compare two
commits on one card, unpack the other commit into a directory (``git
archive``) and run this script on both, one after the other on the same
card, alternating: A, B, B, A.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

BATCH = 128
SP = 4


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--root", required=True, type=Path,
                    help="checkout whose fmcw_tpu_torch is timed")
    ap.add_argument("--cfar3d-only", action="store_true",
                    help="time the 3D CFAR and the 3D array route alone")
    ap.add_argument("--cfar-detect-only", action="store_true",
                    help="time the standalone CFAR and the staged routes "
                         "alone")
    ap.add_argument("--beam-group-only", action="store_true",
                    help="time the cross-beam grouping and the array route "
                         "it ends alone")
    args = ap.parse_args()
    everything = not (args.cfar3d_only or args.cfar_detect_only
                      or args.beam_group_only)
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
    from fmcw_tpu_torch.ops import frontend as F, frontend_fixed as FX
    from fmcw_tpu_torch.ops import split_frontend as SF
    from fmcw_tpu_torch.ops.window import hamming_float

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

    def graph_ms(fn, iters=50):
        """fn() captured once in a CUDA graph and replayed: its device time
        without the host's per-call overhead, which a launch of a few tens
        of microseconds cannot hide."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return cuda_ms(graph.replay, iters)

    def make_batch(p, seed=0):
        rng = np.random.default_rng(seed)
        frame = pl.complex_to_iq(reference.two_target_frame(p))
        iq = np.stack([frame] * BATCH)
        iq = iq + rng.integers(-8, 8, iq.shape).astype(np.int16)
        return torch.as_tensor(iq, device="cuda")

    entry = P.RadarParams()
    ms, fft, graph, fft_graph, copy, fps = {}, {}, {}, {}, {}, {}
    if everything:
        iq = make_batch(entry)
        win = torch.as_tensor(hamming_float(entry.n_range), device="cuda")

        # Kernel A's three entries, each beside torch.fft.fft of the same
        # windowed chirps; each timed as back-to-back calls and as a replayed
        # CUDA graph.
        br = iq[..., 0].float().contiguous()
        bi = iq[..., 1].float().contiguous()
        nd4 = entry.n_doppler // SP
        shard = iq[:, nd4:2 * nd4].contiguous()
        calls = {"range_fft": (lambda: F.range_fft(iq), iq[..., 0],
                               iq[..., 1]),
                 "range_fft_float": (lambda: F.range_fft_float(br, bi), br,
                                     bi),
                 "range_frontend[sp4]": (lambda: SF.range_frontend(shard),
                                         shard[..., 0], shard[..., 1])}
        for name, (call, re, im) in calls.items():
            z = torch.complex(re.float() * win, im.float() * win)
            ms[name] = cuda_ms(call)
            fft[name] = cuda_ms(lambda: torch.fft.fft(z, dim=-1))
            graph[name] = graph_ms(call)
            fft_graph[name] = graph_ms(lambda: torch.fft.fft(z, dim=-1))
            del z
        # Memory-only yardsticks that move kernel A's bytes: an int16 ->
        # float32 conversion (64 MiB read, 128 MiB written, as range_fft)
        # and a copy of the two float32 planes (128 + 128 MiB, as
        # range_fft_float).
        copy.update({"range_fft": cuda_ms(lambda: iq.float()),
                     "range_fft_float": cuda_ms(
                         lambda: (br.clone(), bi.clone()))})
        del br, bi
        # The fixed range kernel's two entries, each beside torch.fft.fft of
        # the same Q15-windowed chirps in FP64 and a corner turn of its
        # input.
        from fmcw_tpu_torch.ops.window import hamming_q15, window_apply_fixed
        fixed = {"range_fft_fixed": (lambda: FX.range_fft_fixed(iq), iq),
                 "range_frontend_fixed[sp4]": (
                     lambda: SF.range_frontend_fixed(shard), shard)}
        for name, (call, x) in fixed.items():
            wi, wq, _ = window_apply_fixed(x[..., 0], x[..., 1],
                                           hamming_q15(entry.n_range)[None, :])
            z = torch.complex(wi.double(), wq.double())
            del wi, wq
            ms[name] = cuda_ms(call)
            fft[name] = cuda_ms(lambda: torch.fft.fft(z, dim=-1))
            graph[name] = graph_ms(call)
            fft_graph[name] = graph_ms(lambda: torch.fft.fft(z, dim=-1))
            copy[name] = graph_ms(lambda: x.transpose(1, 2).contiguous())
            del z
        # Kernel B's four entries and the fixed slow-time kernel's three, each
        # beside torch.fft.fft of its planes (complex64; complex128 for the
        # fixed kernel's int16 planes, its FP64 transform).
        re, im = F.range_fft(iq)
        fre, fim, _ = FX.range_fft_fixed(iq)
        nr, pgr = entry.n_range, 2
        h, nrl = entry.cfar.halo_range + pgr, nr // SP
        ext = torch.arange(nrl - h, 2 * nrl + h, device="cuda") % nr
        lo, hi, core = ext[:h], ext[h + nrl:], ext[h:h + nrl]

        def shard_of(xr, xi):
            return (xr[:, core].contiguous(), xi[:, core].contiguous(),
                    (xr[:, lo].contiguous(), xi[:, lo].contiguous()),
                    (xr[:, hi].contiguous(), xi[:, hi].contiguous()), False, 0,
                    nrl)
        shard, fshard = shard_of(re, im), shard_of(fre, fim)
        skw = dict(cfar=entry.cfar, n_range_total=nr, peak_group_radius=pgr)
        entries = {"slowtime_mag": (lambda: F.slowtime_mag(re, im), re, im),
                   "slowtime_detect_split[sp4]": (
                       lambda: SF.slowtime_detect_split(*shard, **skw),
                       re[:, ext], im[:, ext]),
                   "slowtime_detect_fixed_split[sp4]": (
                       lambda: SF.slowtime_detect_fixed_split(*fshard, **skw),
                       fre[:, ext], fim[:, ext])}
        for p in (entry, P.fast()):
            kw = dict(cfar=p.cfar, peak_group_radius=pgr)
            mode = p.cfar.scale_mode
            entries[f"slowtime_detect[{mode}]"] = (
                lambda kw=kw: F.slowtime_detect(re, im, False, 0, **kw), re,
                im)
            entries[f"slowtime_detect_fixed[{mode}]"] = (
                lambda kw=kw: FX.slowtime_detect_fixed(fre, fim, False, 0,
                                                       **kw),
                fre, fim)
        for name, (call, xr, xi) in entries.items():
            z = (torch.complex(xr.double(), xi.double())
                 if xr.dtype == torch.int16 else torch.complex(xr, xi))
            ms[name] = cuda_ms(call)
            graph[name] = graph_ms(call)
            fft[name] = cuda_ms(lambda: torch.fft.fft(z, dim=-1))
            fft_graph[name] = graph_ms(lambda: torch.fft.fft(z, dim=-1))
            del z
        del re, im, fre, fim, shard, fshard
        # The rank-select CFAR's four variants and, where the checkout has it,
        # its grouping entry on the three the debug routes launch.
        from fmcw_tpu_torch.ops import cfar as C, cfar_rank as RK
        fast = P.fast()
        fmag, _ = F.slowtime_mag(*F.range_fft(iq))
        imag, _ = pl._staged_fixed(iq, False, entry, "zero", "unbiased")
        fsmap = C.block_scale_map(fmag, fast.cfar)
        rank = {"float,16 bits": (fmag, entry.cfar, 16, None),
                "float,exact": (fmag, entry.cfar, None, None),
                "float,exact,scale map": (fmag, fast.cfar, None, fsmap),
                "int32,16 bits": (imag, entry.cfar, 16, None)}
        for what, (mag, cfar, bits, smap) in rank.items():
            kw = dict(cfar=cfar, bits=bits, scale_map=smap)
            calls = {f"cfar_rank[{what}]":
                     lambda kw=kw: RK.cfar_rank(mag, **kw)}
            if hasattr(RK, "cfar_rank_group") and what != "float,exact":
                calls[f"cfar_rank_group[{what}]"] = (
                    lambda kw=kw: RK.cfar_rank_group(mag, peak_group_radius=2,
                                                     **kw))
            for name, call in calls.items():
                ms[name] = cuda_ms(call, 10, 2)
                graph[name] = graph_ms(call, 10)
        del fmag, imag, fsmap
    if everything or args.cfar_detect_only:
        # The standalone CFAR's entries on the fixed chain's int32 and the
        # float staged chain's float32 magnitudes, its prepadded entry on
        # an sp = 4 block-scale shard; the staged routes' frames/s.
        from fmcw_tpu_torch.ops import cfar as C, cfar_detect as CD
        fast = P.fast()
        iq = make_batch(entry)
        imag, _ = pl._staged_fixed(iq, False, entry, "zero", "unbiased")
        fmag = pl.make_batch_processor(entry, frontend="staged",
                                       device="cuda")(iq)["mag_map"]
        grouping = hasattr(CD, "cfar_detect_group")
        for tag, mag in (("int32", imag), ("float32", fmag)):
            for p in (entry, fast):
                mode = p.cfar.scale_mode
                smap = (C.block_scale_map(mag, p.cfar) if mode == "block"
                        else None)
                kw = dict(cfar=p.cfar, scale_map=smap)
                calls = {f"cfar_detect[{mode},{tag}]":
                         lambda kw=kw, mag=mag: CD.cfar_detect(mag, 0, **kw)}
                if grouping:
                    calls[f"cfar_detect_group[{mode},{tag}]"] = (
                        lambda kw=kw, mag=mag: CD.cfar_detect_group(
                            mag, 0, peak_group_radius=2, **kw))
                for name, call in calls.items():
                    ms[name] = cuda_ms(call, 20, 3)
                    graph[name] = graph_ms(call, 20)
        nrl, hr = entry.n_range // SP, entry.cfar.halo_range
        smag, _ = F.slowtime_mag(*F.range_fft(iq))
        ext = torch.arange(nrl - hr, 2 * nrl + hr, device="cuda") % \
            entry.n_range
        shard = smag[:, ext].contiguous()
        smap = C.block_scale_map(smag, fast.cfar)[:, nrl:2 * nrl].contiguous()

        def call():
            return CD.cfar_detect(shard, 0, cfar=fast.cfar, scale_map=smap,
                                  prepadded_range=True)
        ms["cfar_detect[prepadded,sp4]"] = cuda_ms(call, 20, 3)
        graph["cfar_detect[prepadded,sp4]"] = graph_ms(call, 20)
        hw_stream = hasattr(CD, "cfar_detect_hw_stream")
        if hw_stream:
            # The flat-stream entry on the one-shot framing's ext streams,
            # recorded from ops/cfar.cfar_2d_hw_stream's call.
            for tag, mag in (("int32", imag), ("float32", fmag)):
                seen = []

                def record(ext, start0, R, D, so, **kw):
                    seen.append((ext, start0, R, D, kw))
                    return CD.cfar_detect_hw_stream(ext, start0, R, D, so,
                                                    **kw)
                C.cfar_2d_hw_stream(mag, cfar=entry.cfar,
                                    integer=tag == "int32", decide=record)
                ext, start0, R, D, kw = seen[0]

                def call(ext=ext, start0=start0, R=R, D=D, kw=kw):
                    return CD.cfar_detect_hw_stream(ext, start0, R, D, 0,
                                                    **kw)
                name = f"cfar_detect_hw_stream[{tag}]"
                ms[name] = cuda_ms(call, 20, 3)
                graph[name] = graph_ms(call, 20)
        del imag, fmag, smag, shard, smap
        for p in (entry, fast):
            batch = make_batch(p)
            for key, kw in ((f"fixed/{p.cfar.scale_mode}/auto",
                             dict(mode="fixed", frontend="auto")),
                            (f"float/{p.cfar.scale_mode}/staged",
                             dict(frontend="staged"))):
                proc = pl.make_batch_processor(p, peak_group_radius=2,
                                               include_maps=False,
                                               device="cuda", **kw)
                fps[key] = BATCH * 1e3 / cuda_ms(lambda: proc(batch), 5, 2)
        if hw_stream:
            batch = make_batch(entry)
            for key, kw in (("hw_stream/fixed/auto",
                             dict(mode="fixed", frontend="auto")),
                            ("hw_stream/float/fused",
                             dict(frontend="fused"))):
                proc = pl.make_batch_processor(entry, peak_group_radius=2,
                                               cfar_geometry="hw_stream",
                                               include_maps=False,
                                               device="cuda", **kw)
                fps[key] = BATCH * 1e3 / cuda_ms(lambda: proc(batch), 5, 2)
    if args.beam_group_only:
        from fmcw_tpu_torch.ops import beam_group as BG
        from fmcw_tpu_torch.ops import beamform as BF
        n_beams, n_cubes = 8, 16
        z = np.asarray(reference.two_target_frame(entry, seed=3))
        elems = np.stack([pl.complex_to_iq(
            z * np.exp(2j * np.pi * 0.5 * e * 0.3)) for e in range(n_beams)])
        cubes = np.stack([elems] * n_cubes)
        cubes = torch.as_tensor(cubes + np.random.default_rng(0).integers(
            -8, 8, cubes.shape).astype(np.int16), device="cuda")
        br, bi = BF.beamform(cubes[..., 0].float(), cubes[..., 1].float(),
                             n_beams, elem_dim=1)
        det = F.slowtime_detect(*F.range_fft_float(br.flatten(0, 1),
                                                   bi.flatten(0, 1)),
                                cfar=entry.cfar, peak_group_radius=2)[0]
        det = det.reshape(n_cubes, n_beams, entry.n_range, entry.n_doppler)
        del br, bi
        bl = n_beams // SP
        shard = det[:, torch.arange(bl - 1, 2 * bl + 1, device="cuda")
                    % n_beams].contiguous()
        for name, call in (
                ("beam_group", lambda: BG.beam_group(det, 1)),
                ("beam_group[ids,sp4]", lambda: BG.beam_group(
                    shard, 1, beam_offset=bl, n_beams=n_beams))):
            ms[name] = cuda_ms(call, 50, 5)
            graph[name] = graph_ms(call, 50)
        proc = pl.make_batch_array_processor(
            entry, n_elems=n_beams, n_beams=n_beams, peak_group_radius=2,
            beam_group_radius=1, include_maps=False, device="cuda")
        cps = {"percell_grouped": n_cubes * 1e3 / cuda_ms(
            lambda: proc(cubes), 10, 2)}
        print(json.dumps({"root": str(args.root), "ms": ms,
                          "graph_ms": graph, "cubes_per_s": cps,
                          "card": card}), flush=True)
        return 0
    if args.cfar_detect_only:
        print(json.dumps({"root": str(args.root), "ms": ms,
                          "graph_ms": graph, "frames_per_s": fps,
                          "batch": BATCH, "card": card}), flush=True)
        return 0
    # The 3D CFAR's two entries at the 3D route's shapes.
    from fmcw_tpu_torch.ops import beamform as BF, cfar3d_detect as C3
    n_beams, n_cubes = 8, 16
    z = np.asarray(reference.two_target_frame(entry, seed=3))
    elems = np.stack([pl.complex_to_iq(z * np.exp(2j * np.pi * 0.5 * e * 0.3))
                      for e in range(n_beams)])
    cubes = np.stack([elems] * n_cubes)
    cubes = torch.as_tensor(cubes + np.random.default_rng(0).integers(
        -8, 8, cubes.shape).astype(np.int16), device="cuda")
    br, bi = BF.beamform(cubes[..., 0].float(), cubes[..., 1].float(),
                         n_beams, elem_dim=1)
    cube = F.slowtime_mag(*F.range_fft_float(br.flatten(0, 1),
                                             bi.flatten(0, 1)))[0]
    cube = cube.reshape(n_cubes, n_beams, entry.n_range, entry.n_doppler)
    del br, bi
    bl = n_beams // SP
    shard = cube[:, torch.arange(bl - 1, 2 * bl + 1, device="cuda")
                 % n_beams].contiguous()
    for name, call in (
            ("cfar3d_detect", lambda: C3.cfar3d_detect(
                cube, cfar=entry.cfar, ref_angle=1)),
            ("cfar3d_detect[prepadded,sp4]", lambda: C3.cfar3d_detect(
                shard, cfar=entry.cfar, ref_angle=1, prepadded_angle=True))):
        ms[name] = cuda_ms(call, 20, 3)
        graph[name] = graph_ms(call, 20)
    del cube, shard
    if everything:
        # The main path, per-cell and block scale; fixed mode's fused route.
        for p in (entry, P.fast()):
            batch = make_batch(p)
            for key, kw in ((p.cfar.scale_mode, {}),
                            (f"fixed/{p.cfar.scale_mode}/fused",
                             dict(mode="fixed", frontend="fused"))):
                proc = pl.make_batch_processor(p, peak_group_radius=2,
                                               include_maps=False,
                                               device="cuda", **kw)
                fps[key] = BATCH * 1e3 / cuda_ms(lambda: proc(batch), 10, 2)
        # The debug-tap routes.
        for key, p, kw in (("debug/float/cell/fused", entry, {}),
                           ("debug/float/block/fused", P.fast(), {}),
                           ("debug/fixed/cell/auto", entry,
                            dict(mode="fixed", frontend="auto"))):
            batch = make_batch(p, seed=4)
            proc = pl.make_batch_processor(p, peak_group_radius=2,
                                           include_maps=False,
                                           include_debug=True,
                                           device="cuda", **kw)
            fps[key] = BATCH * 1e3 / cuda_ms(lambda: proc(batch), 5, 2)
    # The 3D array route, cubes/s at 16 cubes.
    proc = pl.make_batch_array_processor(entry, n_elems=n_beams,
                                         n_beams=n_beams, ref_angle=1,
                                         include_maps=False, device="cuda")
    cps = {"3d/ref_angle1": n_cubes * 1e3 / cuda_ms(lambda: proc(cubes),
                                                      10, 2)}
    print(json.dumps({"root": str(args.root), "ms": ms, "fft_ms": fft,
                      "graph_ms": graph, "fft_graph_ms": fft_graph,
                      "copy_ms": copy, "frames_per_s": fps,
                      "cubes_per_s": cps, "batch": BATCH, "card": card}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
