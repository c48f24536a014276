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
  (``split_frontend.slowtime_detect_fixed_split``, the same rows), and,
  where the checkout's fixed kernel takes them, its CA / GO / SO
  instantiation on the same three — as
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

With ``--front-end-only`` it times kernel A's three entries (int16,
float, the sp = 4 chirp shard) and kernel B's four (per-cell, block,
magnitude-only, the sp = 4 range shard) by graph replay, with the float
main path's frames/s per-cell and block, at 1024x128 and, where the
checkout's kernel A takes them, at the n2 x 128 range lengths 2048, 1536
and 384.  With ``--fixed-range-only`` it times the fixed range kernel's
two entries (``range_fft_fixed``, the sp = 4 chirp shard) by graph replay
and the fused fixed route's frames/s, per-cell, at 1024x128 and, where the
checkout's fixed kernels take them, at 2048, 1536 and 384.  With
``--slowtime-only`` it times the two slow-time kernels'
entries alone by graph replay: at 1024x128 kernel B per-cell and block,
the fixed kernel
per-cell, block and CA and its row-6 shard; at the long CPI 1024x256
kernel B per-cell, block and GO and, where the checkout's fixed kernel
takes long CPIs, the fixed kernel per-cell, block and CA, with the fused
fixed route's frames/s there; and, where the checkout's kernel B takes
them (``ops/frontend.dense_cpi``), at the dense lengths 1024x96, 1024x192
and 1024x1016 kernel B per-cell, block, GO and its magnitude-only
entry.  With ``--cfar3d-only`` it times the 3D
CFAR's two entries and the 3D array
route alone, with ``--cfar-detect-only`` the standalone CFAR's entries and
the staged routes alone, with ``--beam-group-only`` the cross-beam
grouping (TPU row 11, ``csrc/beam_group.cu``) alone: its whole-cube entry
(radius 1 on kernel B's per-cell det cubes of 16 cubes x 8 beams) and its
sp = 4 shard entry (2 beams and one halo plane on each side, global beam
ids), eager and by graph replay, and the array route it ends, per-cell
grouped, in cubes/s (a design step's A/B).  With ``--wide-cfar-only``
it times the standalone CFAR kernels' entries (TPU rows 7-10) by graph
replay on seeded noise maps: the rank select's grouping entry (float and
int32, 16 key bits, radius 2), the standalone CFAR's grouping entry (int32,
radius 2) and its entry with a block scale map (float), the 3D CFAR at
ref_angle 1 and 2 (8-beam cubes), and the reflect entries (the
standalone CFAR's on float and int32 maps, the rank select's float 16
bits, the 3D CFAR's at ref_angle 1) — at 1024x128 (batch 128, 16 cubes) and,
where the checkout's plans take them (its wrapper raises
NotImplementedError where they do not: "not taken"), at 1024x1016 and
1024x2048 (batch 16, 2 cubes); there, where the checkout plans the rank
tiles on the host (``ops/cfar_rank.tile_bytes``), also the rank select's
grouping entry with its tiles grown from 112 KB to 227 KB (whole rows
first, then chunks: "227 KB plan").  With ``--fixed-dense-only`` it
times the fixed slow-time kernel's entries by graph replay: per-cell,
block (fast()) and CA, and the row-6 range shard (sp = 4), at 1024x128
and the long CPI 1024x256 (batch 128) and, where the checkout's kernel
takes them ("not taken" elsewhere), at the dense lengths 1024x96,
1024x192 (batch 128) and 1024x1016 (batch 16), with the fused fixed
route's frames/s per-cell.  With ``--odd-doppler-only`` it times kernel
A's three entries (int16, float, the sp = 4 chirp shard where sp divides
n_doppler) and kernel B's (per-cell, block, CA, magnitude-only, the sp = 4
range shard) by graph replay, with the float main path's frames/s
per-cell, at 1024x128, 1024x96, 1024x256 (batch 128) and 1024x1016 (batch
16) and, where the checkout's kernels take them ("not taken" elsewhere),
at the lengths off a multiple of 8 1024x100, 1024x250 (batch 128),
1024x1021 and 1024x2047 (batch 16).  Prints the card's name and
power limit
and one JSON line.  To compare two
commits on one card, unpack the other commit into a directory (``git
archive``) and run this script on both, one after the other on the same
card, alternating: A, B, B, A.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
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
    ap.add_argument("--slowtime-only", action="store_true",
                    help="time the slow-time kernels' entries alone, short "
                         "and long CPIs")
    ap.add_argument("--front-end-only", action="store_true",
                    help="time kernel A's and kernel B's entries alone, at "
                         "1024x128 and the n2 x 128 range lengths")
    ap.add_argument("--wide-cfar-only", action="store_true",
                    help="time the standalone CFAR kernels' entries alone, "
                         "at 1024x128 and the wide maps 1024x1016, "
                         "1024x2048")
    ap.add_argument("--fixed-dense-only", action="store_true",
                    help="time the fixed slow-time kernel's entries alone, "
                         "at 1024x128, 1024x256 and the dense lengths "
                         "1024x96, 1024x192, 1024x1016")
    ap.add_argument("--odd-doppler-only", action="store_true",
                    help="time kernel A's and kernel B's entries alone, at "
                         "1024x128, 96, 256, 1016 and the lengths off a "
                         "multiple of 8 1024x100, 250, 1021, 2047")
    ap.add_argument("--fixed-range-only", action="store_true",
                    help="time the fixed range kernel's entries and the "
                         "fused fixed route alone, at 1024x128 and the n2 "
                         "x 128 range lengths")
    args = ap.parse_args()
    everything = not (args.cfar3d_only or args.cfar_detect_only
                      or args.beam_group_only or args.wide_cfar_only)
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

    def make_batch(p, seed=0, batch=BATCH):
        rng = np.random.default_rng(seed)
        frame = pl.complex_to_iq(reference.two_target_frame(p))
        iq = np.stack([frame] * batch)
        iq = iq + rng.integers(-8, 8, iq.shape).astype(np.int16)
        return torch.as_tensor(iq, device="cuda")

    entry = P.RadarParams()
    ms, fft, graph, fft_graph, copy, fps = {}, {}, {}, {}, {}, {}
    if args.wide_cfar_only:
        from fmcw_tpu_torch.ops import cfar as C, cfar3d_detect as C3
        from fmcw_tpu_torch.ops import cfar_detect as CD, cfar_rank as RK
        full, fast = entry.cfar, P.fast().cfar
        refl = dataclasses.replace(full, edge_mode="reflect")

        def noise(B, D, integer, seed):
            g = torch.Generator(device="cuda").manual_seed(seed)
            m = torch.empty((B, 1024, D), device="cuda").exponential_(
                1 / 8, generator=g)
            strong = torch.rand(m.shape, generator=g, device="cuda") < 0.02
            m = torch.where(strong, m * 40, m)
            return m.to(torch.int32) if integer else m

        def rank_plan_smem(R, D, hr, hd, pgr, bits, colsums):
            """The rank plan grown to kernels.MAX_SMEM (one block an SM)
            in place of its 112 KB: whole rows with the largest T that
            fits, else the chunks with the fewest cells loaded."""
            best = None
            for w in [D] + list(range(RK.CHUNK, D, RK.CHUNK)):
                t = math.gcd(R, RK.TILE_ROWS)
                while t > 1 and RK.tile_bytes(t, D, w, hr, hd, pgr, bits,
                                              colsums) > kernels.MAX_SMEM:
                    t //= 2
                if RK.tile_bytes(t, D, w, hr, hd, pgr, bits,
                                 colsums) > kernels.MAX_SMEM:
                    continue
                if w == D:
                    return t, D
                pg = max(pgr, 0)
                cells = (R // t) * -(-D // w) * (t + 2 * (hr + pg)) * (
                    w + 2 * (hd + pg))
                if best is None or cells <= best[0]:
                    best = (cells, t, w)
            return best[1:]

        def with_rank_plan(plan, call):
            """call() with the rank wrapper's plan swapped for ``plan``."""
            def run():
                saved, RK.tile_plan = RK.tile_plan, plan
                try:
                    return call()
                finally:
                    RK.tile_plan = saved
            return run

        for D, B in ((128, BATCH), (1016, 16), (2048, 16)):
            fm, im = noise(B, D, False, D), noise(B, D, True, D + 1)
            fs = C.block_scale_map(fm, fast)
            cube = fm.reshape(B // 8, 8, 1024, D)
            calls = {
                f"cfar_rank_group[float,16 bits,{D}]": lambda: (
                    RK.cfar_rank_group(fm, cfar=full, bits=16,
                                       peak_group_radius=2)),
                f"cfar_rank_group[int32,16 bits,{D}]": lambda: (
                    RK.cfar_rank_group(im, cfar=full, bits=16,
                                       peak_group_radius=2)),
                f"cfar_detect_group[int32,{D}]": lambda: (
                    CD.cfar_detect_group(im, cfar=full,
                                         peak_group_radius=2)),
                f"cfar_detect[float,scale map,{D}]": lambda: (
                    CD.cfar_detect(fm, cfar=fast, scale_map=fs)),
                f"cfar3d_detect[ref_angle 1,{D}]": lambda: (
                    C3.cfar3d_detect(cube, cfar=full, ref_angle=1)),
                f"cfar3d_detect[ref_angle 2,{D}]": lambda: (
                    C3.cfar3d_detect(cube, cfar=full, ref_angle=2)),
                f"cfar_detect[reflect,float,{D}]": lambda: (
                    CD.cfar_detect(fm, cfar=refl)),
                f"cfar_detect[reflect,int32,{D}]": lambda: (
                    CD.cfar_detect(im, cfar=refl)),
                f"cfar_rank[reflect,float,16 bits,{D}]": lambda: (
                    RK.cfar_rank(fm, cfar=refl, bits=16)),
                f"cfar3d_detect[reflect,ref_angle 1,{D}]": lambda: (
                    C3.cfar3d_detect(cube, cfar=refl, ref_angle=1))}
            if D > 128 and hasattr(RK, "tile_bytes"):
                # The rank plan's other choice: tiles grown to 227 KB.
                calls[f"cfar_rank_group[float,16 bits,{D},227 KB plan]"] = (
                    with_rank_plan(rank_plan_smem, calls[
                        f"cfar_rank_group[float,16 bits,{D}]"]))
            for name, call in calls.items():
                try:
                    call()
                    torch.cuda.synchronize()
                except NotImplementedError:
                    graph[name] = None
                    continue
                graph[name] = graph_ms(call, 10 if D > 128 else 20)
            del fm, im, fs, cube
            torch.cuda.empty_cache()
        for name, t in graph.items():
            print(f"{name}: " + ("not taken" if t is None
                                 else f"{t:.4f} ms (graph)"), flush=True)
        print(json.dumps({"root": str(args.root), "graph_ms": graph,
                          "card": card}), flush=True)
        return 0
    if args.front_end_only:
        pgr = 2
        for nr in (1024, 2048, 1536, 384):
            # The lengths the checkout's kernel A takes.
            if nr != 1024 and not getattr(F, "range_length_ok",
                                          lambda n: False)(nr):
                continue
            ep = entry.replace(n_range=nr)
            iq = make_batch(ep)
            br = iq[..., 0].float().contiguous()
            bi = iq[..., 1].float().contiguous()
            nd4 = ep.n_doppler // SP
            shard = iq[:, nd4:2 * nd4].contiguous()
            re, im = F.range_fft(iq)
            h, nrl = ep.cfar.halo_range + pgr, nr // SP
            ext = torch.arange(nrl - h, 2 * nrl + h, device="cuda") % nr
            lo, hi, core = ext[:h], ext[h + nrl:], ext[h:h + nrl]
            rshard = (re[:, core].contiguous(), im[:, core].contiguous(),
                      (re[:, lo].contiguous(), im[:, lo].contiguous()),
                      (re[:, hi].contiguous(), im[:, hi].contiguous()),
                      False, 0, nrl)
            skw = dict(cfar=ep.cfar, n_range_total=nr, peak_group_radius=pgr)
            calls = {
                f"range_fft[{nr}]": lambda: F.range_fft(iq),
                f"range_fft_float[{nr}]": lambda: F.range_fft_float(br, bi),
                f"range_frontend[{nr},sp4]": lambda: SF.range_frontend(shard),
                f"slowtime_mag[{nr}]": lambda: F.slowtime_mag(re, im),
                f"slowtime_detect_split[{nr},sp4]": (
                    lambda: SF.slowtime_detect_split(*rshard, **skw))}
            for name, p in (("cell", ep), ("block", P.fast().replace(
                    n_range=nr))):
                kw = dict(cfar=p.cfar, peak_group_radius=pgr)
                calls[f"slowtime_detect[{name},{nr}]"] = (
                    lambda kw=kw: F.slowtime_detect(re, im, False, 0, **kw))
                proc = pl.make_batch_processor(p, peak_group_radius=pgr,
                                               include_maps=False,
                                               device="cuda")
                fps[f"float/{name}/{proc.route},{nr}"] = BATCH * 1e3 / cuda_ms(
                    lambda: proc(iq), 10, 2)
            for name, call in calls.items():
                graph[name] = graph_ms(call)
            del iq, br, bi, shard, re, im, rshard
            torch.cuda.empty_cache()
        print(json.dumps({"root": str(args.root), "graph_ms": graph,
                          "frames_per_s": fps, "batch": BATCH,
                          "card": card}), flush=True)
        return 0
    if args.fixed_range_only:
        pgr = 2
        for nr in (1024, 2048, 1536, 384):
            ep = entry.replace(n_range=nr)
            # The lengths the checkout's fixed kernels take.
            if not FX.fused_fixed_detect_supported(ep, pgr):
                continue
            iq = make_batch(ep)
            nd4 = ep.n_doppler // SP
            shard = iq[:, nd4:2 * nd4].contiguous()
            graph[f"range_fft_fixed[{nr}]"] = graph_ms(
                lambda: FX.range_fft_fixed(iq))
            graph[f"range_frontend_fixed[{nr},sp4]"] = graph_ms(
                lambda: SF.range_frontend_fixed(shard))
            proc = pl.make_batch_processor(
                ep, mode="fixed", frontend="fused", peak_group_radius=pgr,
                include_maps=False, device="cuda")
            fps[f"fixed/cell/fused,{nr}"] = BATCH * 1e3 / cuda_ms(
                lambda: proc(iq), 10, 2)
            del iq, shard
            torch.cuda.empty_cache()
        print(json.dumps({"root": str(args.root), "graph_ms": graph,
                          "frames_per_s": fps, "batch": BATCH,
                          "card": card}), flush=True)
        return 0
    if args.odd_doppler_only:
        pgr = 2
        for nd in (entry.n_doppler, 96, 256, 1016, 100, 250, 1021, 2047):
            batch = 16 if nd > 512 else BATCH
            ep = entry.replace(n_doppler=nd)
            iq = make_batch(ep, batch=batch)
            calls = {}
            try:
                re, im = F.range_fft(iq)
            except NotImplementedError:
                # A length the checkout's kernel A does not take.
                print(f"{nd}: not taken", flush=True)
                graph[f"range_fft[{nd}]"] = None
                continue
            beams = (re.transpose(1, 2).contiguous(),
                     im.transpose(1, 2).contiguous())
            calls[f"range_fft[{nd}]"] = lambda: F.range_fft(iq)
            calls[f"range_fft_float[{nd}]"] = lambda: F.range_fft_float(
                *beams)
            if nd % SP == 0:
                shard = iq[:, nd // SP:2 * nd // SP].contiguous()
                calls[f"range_frontend[{nd},sp4]"] = (
                    lambda: SF.range_frontend(shard))
            for name, p in (("cell", ep), ("block", P.fast().replace(
                    n_doppler=nd)), ("ca", ep.replace(cfar=dataclasses.replace(
                        ep.cfar, variant="ca")))):
                kw = dict(cfar=p.cfar, peak_group_radius=pgr)
                calls[f"slowtime_detect[{name},{nd}]"] = (
                    lambda kw=kw: F.slowtime_detect(re, im, False, 0, **kw))
            calls[f"slowtime_mag[{nd}]"] = lambda: F.slowtime_mag(re, im)
            nr = ep.n_range
            h, nrl = ep.cfar.halo_range + pgr, nr // SP
            ext = torch.arange(nrl - h, 2 * nrl + h, device="cuda") % nr
            lo, hi, core = ext[:h], ext[h + nrl:], ext[h:h + nrl]
            rshard = (re[:, core].contiguous(), im[:, core].contiguous(),
                      (re[:, lo].contiguous(), im[:, lo].contiguous()),
                      (re[:, hi].contiguous(), im[:, hi].contiguous()),
                      False, 0, nrl)
            skw = dict(cfar=ep.cfar, n_range_total=nr, peak_group_radius=pgr)
            calls[f"slowtime_detect_split[{nd},sp4]"] = (
                lambda: SF.slowtime_detect_split(*rshard, **skw))
            for name, call in calls.items():
                # The entries the checkout's kernels take at nd (their
                # wrappers raise NotImplementedError elsewhere).
                try:
                    call()
                    torch.cuda.synchronize()
                except NotImplementedError:
                    graph[name] = None
                    continue
                graph[name] = graph_ms(call, 10 if nd > 512 else 50)
            if F.fused_detect_supported(ep, pgr):
                proc = pl.make_batch_processor(
                    ep, peak_group_radius=pgr, include_maps=False,
                    device="cuda")
                fps[f"float/cell/{proc.route},{nd}"] = batch * 1e3 / cuda_ms(
                    lambda: proc(iq), 10, 2)
            del iq, re, im, beams, rshard
            torch.cuda.empty_cache()
        for name, t in graph.items():
            print(f"{name}: " + ("not taken" if t is None
                                 else f"{t:.4f} ms (graph)"), flush=True)
        print(json.dumps({"root": str(args.root), "graph_ms": graph,
                          "frames_per_s": fps, "card": card}), flush=True)
        return 0
    if args.fixed_dense_only:
        pgr = 2
        for nd in (entry.n_doppler, 256, 96, 192, 1016):
            batch = 16 if nd > 512 else BATCH
            ep = entry.replace(n_doppler=nd)
            iq = make_batch(ep, batch=batch)
            re, im, _ = FX.range_fft_fixed(iq)
            calls = {}
            for name, p in (("cell", ep), ("block", P.fast().replace(
                    n_doppler=nd)), ("ca", ep.replace(cfar=dataclasses.replace(
                        ep.cfar, variant="ca")))):
                kw = dict(cfar=p.cfar, peak_group_radius=pgr)
                calls[f"slowtime_detect_fixed[{name},{nd}]"] = (
                    lambda kw=kw: FX.slowtime_detect_fixed(re, im, False, 0,
                                                           **kw))
            nr = ep.n_range
            h, nrl = ep.cfar.halo_range + pgr, nr // SP
            ext = torch.arange(nrl - h, 2 * nrl + h, device="cuda") % nr
            lo, hi, core = ext[:h], ext[h + nrl:], ext[h:h + nrl]
            fshard = (re[:, core].contiguous(), im[:, core].contiguous(),
                      (re[:, lo].contiguous(), im[:, lo].contiguous()),
                      (re[:, hi].contiguous(), im[:, hi].contiguous()),
                      False, 0, nrl)
            skw = dict(cfar=ep.cfar, n_range_total=nr, peak_group_radius=pgr)
            calls[f"slowtime_detect_fixed_split[{nd},sp4]"] = (
                lambda: SF.slowtime_detect_fixed_split(*fshard, **skw))
            for name, call in calls.items():
                # The lengths the checkout's fixed kernel takes (its
                # wrapper raises NotImplementedError elsewhere).
                try:
                    call()
                    torch.cuda.synchronize()
                except NotImplementedError:
                    graph[name] = None
                    continue
                graph[name] = graph_ms(call, 10 if nd > 512 else 50)
            if FX.fused_fixed_detect_supported(ep, pgr):
                proc = pl.make_batch_processor(
                    ep, mode="fixed", frontend="fused", peak_group_radius=pgr,
                    include_maps=False, device="cuda")
                fps[f"fixed/cell/fused,{nd}"] = batch * 1e3 / cuda_ms(
                    lambda: proc(iq), 10, 2)
            del iq, re, im, fshard
            torch.cuda.empty_cache()
        for name, t in graph.items():
            print(f"{name}: " + ("not taken" if t is None
                                 else f"{t:.4f} ms (graph)"), flush=True)
        print(json.dumps({"root": str(args.root), "graph_ms": graph,
                          "frames_per_s": fps, "card": card}), flush=True)
        return 0
    if args.slowtime_only:
        pgr = 2
        dense = getattr(F, "dense_cpi", lambda n: False)
        for nd in (entry.n_doppler, 256, 96, 192, 1016):
            # The dense lengths where the checkout's kernel B takes them.
            if nd in (96, 192, 1016) and not dense(nd):
                continue
            lng = nd != entry.n_doppler         # two launches
            ep = entry.replace(n_doppler=nd)
            iq = make_batch(ep)
            re, im = F.range_fft(iq)
            fre, fim, _ = FX.range_fft_fixed(iq)
            calls = {}
            for p in (ep, P.fast().replace(n_doppler=nd),
                      ep.replace(cfar=dataclasses.replace(
                          ep.cfar, variant="go" if lng else "ca"))):
                tag = f"{p.cfar.variant},{p.cfar.scale_mode},{nd}"
                kw = dict(cfar=p.cfar, peak_group_radius=pgr)
                if not lng or p.cfar.variant != "ca":
                    calls[f"slowtime_detect[{tag}]"] = (
                        lambda kw=kw: F.slowtime_detect(re, im, False, 0,
                                                        **kw))
                pf = p.replace(cfar=dataclasses.replace(
                    p.cfar, variant="ca")) if p.cfar.variant == "go" else p
                if FX.fused_fixed_detect_supported(pf, pgr):
                    fkw = dict(cfar=pf.cfar, peak_group_radius=pgr)
                    ftag = f"{pf.cfar.variant},{pf.cfar.scale_mode},{nd}"
                    calls[f"slowtime_detect_fixed[{ftag}]"] = (
                        lambda fkw=fkw: FX.slowtime_detect_fixed(
                            fre, fim, False, 0, **fkw))
            if dense(nd):
                calls[f"slowtime_mag[{nd}]"] = lambda: F.slowtime_mag(re, im)
            if not lng:
                nr = ep.n_range
                h, nrl = ep.cfar.halo_range + pgr, nr // SP
                ext = torch.arange(nrl - h, 2 * nrl + h, device="cuda") % nr
                lo, hi, core = ext[:h], ext[h + nrl:], ext[h:h + nrl]
                fshard = (fre[:, core].contiguous(), fim[:, core].contiguous(),
                          (fre[:, lo].contiguous(), fim[:, lo].contiguous()),
                          (fre[:, hi].contiguous(), fim[:, hi].contiguous()),
                          False, 0, nrl)
                skw = dict(cfar=ep.cfar, n_range_total=nr,
                           peak_group_radius=pgr)
                calls["slowtime_detect_fixed_split[sp4]"] = (
                    lambda: SF.slowtime_detect_fixed_split(*fshard, **skw))
            for name, call in calls.items():
                graph[name] = graph_ms(call)
            if lng and FX.fused_fixed_detect_supported(ep, pgr):
                proc = pl.make_batch_processor(
                    ep, mode="fixed", frontend="fused", peak_group_radius=pgr,
                    include_maps=False, device="cuda")
                fps[f"fixed/cell/fused,{nd}"] = BATCH * 1e3 / cuda_ms(
                    lambda: proc(iq), 10, 2)
            del iq, re, im, fre, fim
        print(json.dumps({"root": str(args.root), "graph_ms": graph,
                          "frames_per_s": fps, "batch": BATCH,
                          "card": card}), flush=True)
        return 0
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
            # The fixed kernel's CA/GO/SO instantiation beside OS, where the
            # checkout's fused fixed route takes the variants.
            for variant in ("ca", "go", "so"):
                pv = p.replace(cfar=dataclasses.replace(p.cfar,
                                                        variant=variant))
                if not FX.fused_fixed_detect_supported(pv, pgr):
                    continue
                vkw = dict(cfar=pv.cfar, peak_group_radius=pgr)
                entries[f"slowtime_detect_fixed[{variant}, {mode}]"] = (
                    lambda vkw=vkw: FX.slowtime_detect_fixed(
                        fre, fim, False, 0, **vkw), fre, fim)
                if mode == "cell":
                    entries[f"slowtime_detect_fixed_split[{variant}, sp4]"] = (
                        lambda vkw=vkw: SF.slowtime_detect_fixed_split(
                            *fshard, **dict(skw, cfar=vkw["cfar"])),
                        fre[:, ext], fim[:, ext])
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
