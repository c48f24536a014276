"""The sharded frame processor: the radar chain on a (dp, sp) mesh.

Port of ``fmcw_tpu/parallel/sharded.py`` (``make_sharded_processor``).  The
single-device dataflow maps onto the mesh as in JAX:

* frames -> ``dp``;
* within a frame (``sp > 1``), chirps are sharded for the range FFT, and
  the **corner turn is an all-to-all** (``all_to_all_single``): afterwards
  each shard holds a contiguous block of ``nrl = n_range / sp`` range bins
  with every chirp (rtl/src/corner_turner.vhd:79-117);
* the CFAR window and the grouping radius need rows of the neighbouring
  shards: a **ring exchange of range rows** (send/recv around the sp ring)
  supplies them, the torus of the single-device wrap edges;
* detections: each shard's top-K with global range bins, an **all-gather**
  over sp and a global top-K — a stable descending sort, so equal values
  keep the single device's order (lower shard, then lower local index:
  ``lax.top_k``'s order over JAX's shard-ordered gather).

Routes for ``sp > 1`` (``frontend`` as in ``models/pipeline.
make_batch_processor``):

* "fused", float32, per-cell scale: kernel A on the chirp shard
  (``ops/split_frontend.range_frontend``) -> all-to-all -> halo of ``h =
  halo_range + peak_group_radius`` rows -> kernel B's split entry
  (``split_frontend.slowtime_detect_split``) -> local top-K;
* "fused", float32, block scale: kernel A -> all-to-all -> the
  magnitude-only kernel (``ops/frontend.slowtime_mag``) -> the sharded
  CFAR tail below;
* "fused", fixed (per-cell scale only, as JAX): the fixed range kernel
  (``range_frontend_fixed``) -> all-to-all ->
  ``slowtime_detect_fixed_split``; saturation counts summed over sp;
* "staged" (float32 staged; fixed ``auto``): the plain stages of
  ``models/pipeline.py`` split at the corner turn -> the sharded CFAR tail
  with the ``cfar_detect`` kernel;
* "plain": the same dataflow with the twins, the CFAR tail as plain
  ``cfar_2d``.

The sharded CFAR tail (JAX's ``sharded.py:396-422``): for the block scale
``ops/cfar.block_scale_map_sharded`` (one block-grid row exchanged per
side), then ``halo_range`` exchanged magnitude rows and
``cfar_detect(prepadded_range=True)``, then ``peak_group_radius`` exchanged
decision rows and ``peak_group`` with global row ids.  With
``include_debug`` (the threshold and scale taps) the tail's CFAR is the
rank-select kernel ``ops/cfar_rank.cfar_rank(prepadded_range=True)`` (its
twin on "plain"), and the float "fused" route feeds it from the
magnitude-only kernel in place of kernel B's split detect (JAX's
``use_split_detect = not include_debug``); fixed "fused" has no taps, as on
one device.

With ``sp == 1`` each group of ranks runs ``make_batch_processor`` on its
frames.  Every route equals the single-device route of the same name bit
for bit: the range stages are per chirp, the slow-time stages per range
row, the halo rows are exact copies, and every sum keeps its order.

Two kinds of mesh (``parallel/mesh.py``): a DeviceMesh, one shard per rank
(NCCL on GPUs, gloo on the CPU); or a ``LocalMesh``, every shard in this
process one after another, the collectives done by slicing.  The processor
body is written for a list of shards: all of them on a LocalMesh, the
rank's own one on a DeviceMesh.

Input: every rank passes the same full batch (JAX's replicated-input
contract) and takes its own (dp, sp) block.  Output: the detection arrays,
``n_dets``, ``saturation_count`` and ``nonfinite_count`` of the whole batch
on every rank (an all-gather over dp); the maps (``include_maps``,
``include_debug``) are the rank's own (batch/dp, n_range/sp, n_doppler)
shard — on a LocalMesh, which holds every shard, the whole maps.

``make_sharded_array_processor`` is the array model on the mesh: cubes over
``dp``, beams over ``sp`` (see its docstring).

The CFAR variants as on one device: CA/GO/SO per-cell on the float
"fused" route decide in kernel B's split entry, on the fixed "fused"
route in the fixed kernel's split entry; the block scale, the staged and
plain tails and the debug taps decide them in the plain
``ops/cfar.cfar_2d(prepadded_range=True)`` (JAX's ``sharded.py:98-103``:
its standalone kernel is OS only).

Reflect edges (``CfarParams.edge_mode="reflect"``, JAX's ``sharded.py:57-75,
170-173, 402-406``): the CFAR tail's halo rows come from the neighbours at
interior shard boundaries and mirror locally on the global edge shards
(shard 0's lower halo is its rows 1..hr flipped, the last shard's upper
halo its rows before the last, flipped), which needs ``halo_range + 1 <=
n_range / sp`` (else ValueError); the block scale's exchanged block-grid
row clips at the global edges; the grouping halo stays the ring, since
grouping wraps.  The float "fused" route then feeds the tail from the
magnitude-only kernel, not kernel B's split detect entry (which wraps
only), as JAX's; fixed "fused" raises (the fixed kernels wrap only).  The
debug taps' tail runs the reflect entry of the rank-select kernel on the
mirrored range halo (``cfar_rank(prepadded_range=True)``), then the plain
grouping.  The sharded array model mirrors its exchanged beam planes at the
global edges for the 3D CFAR's reflect entry (shard 0's lower halo is its
planes 1..ha flipped), which needs ``ref_angle + guard_angle + 1 <=
n_beams / sp`` (else ValueError); at ``ref_angle == 0`` each beam's map
takes the magnitude-only entry and the standalone CFAR's reflect entry, as
on one device.

Long CPIs (n_doppler = n2d x 128, n2d 2..16): the float routes take them
as on one device (kernel B's split entry decides on its halo-extended
slab, the magnitude-only entry feeds the block, reflect and debug tails;
JAX's ``sharded.py:78-91``), and so does fixed ``"fused"`` (the fixed
split entry on its int32 slab, per-cell scale only, as JAX's).  So do the
float routes at every n_doppler below 2048 that sp divides, off a
multiple of 8 too (1024x100 at sp 2 and 4, 50 and 25 chirps a shard;
1024x1016 at sp 4, 254 a shard: kernel A's last group of 8 chirps a
frame is partial there); fixed ``"fused"`` needs n_doppler / sp a multiple of 8
(``split_frontend_supported(fixed=True)``) and raises NotImplementedError
elsewhere.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..models import pipeline as PL
from ..ops import beamform as BF, cfar as C, detect as DET
from ..ops import cfar_detect as CD, cfar_rank as RK
from ..ops import frontend as F, frontend_fixed as FX
from ..ops import split_frontend as SF
from ..ops.beam_group import beam_group, beam_group_plain
from ..ops.cfar_rank import debug_bits
from ..ops.fft import dft_apply, doppler_apply
from ..ops.magnitude import magnitude_float
from ..ops.notch import check_notch
from ..ops.window import window_rounding_constant
from ..params import RadarParams
from .mesh import LocalMesh, make_mesh

DETECTION_KEYS = ("range_bin", "doppler_bin", "mag", "valid", "n_dets",
                  "saturation_count", "nonfinite_count")


# ---------------------------------------------------------------------------
# The sp-axis collectives, on lists of per-shard tensors
# ---------------------------------------------------------------------------

def _wire(x: torch.Tensor) -> torch.Tensor:
    """A byte view for the data-moving collectives (NCCL has no int16)."""
    return x.contiguous().view(torch.uint8)


EDGES = ("wrap", "reflect", "clip")


def _global_edges(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                  h: int, edge: str, first: bool, last: bool):
    """Shard ``x``'s ring halos (lo, hi) with the global edges of ``edge``:
    "wrap" keeps the ring's rows; on the first shard's lower and the last
    shard's upper side "reflect" mirrors the shard's own rows (numpy's: the
    row before row 0 is row 1; the shard holds h + 1 rows or more) and
    "clip" repeats its edge row."""
    if edge not in EDGES:
        raise ValueError(f"edge must be one of {EDGES}, got {edge!r}")
    if edge == "wrap" or h == 0:
        return lo, hi
    R = x.shape[-2]
    rows = (*x.shape[:-2], h, x.shape[-1])
    if first:
        lo = (x[..., 1:h + 1, :].flip(-2) if edge == "reflect"
              else x[..., :1, :].expand(rows))
    if last:
        hi = (x[..., R - h - 1:R - 1, :].flip(-2) if edge == "reflect"
              else x[..., R - 1:, :].expand(rows))
    return lo, hi


class LocalRing:
    """The sp ring with every shard in this process: each method takes the
    shards' tensors in shard order and returns one result per shard."""

    def __init__(self, n: int):
        self.n = n

    def corner_turn(self, xs):
        """Range-major chirp-shard planes (B, nr, nd/sp) -> range-shard
        planes (B, nr/sp, nd): shard j gets rows j*nrl .. (j+1)*nrl of
        every shard, in chirp order."""
        nrl = xs[0].shape[-2] // self.n
        return [torch.cat([x[..., j * nrl:(j + 1) * nrl, :] for x in xs],
                          dim=-1) for j in range(self.n)]

    def halo(self, xs, h: int, edge: str = "wrap"):
        """(the previous shard's last h rows, the next shard's first h rows)
        for each shard, around the ring; ``edge`` at the global edges
        (``_global_edges``)."""
        n = self.n
        return [_global_edges(
            xs[j], xs[(j - 1) % n][..., xs[j].shape[-2] - h:, :],
            xs[(j + 1) % n][..., :h, :], h, edge, j == 0, j == n - 1)
            for j in range(n)]

    def gather(self, xs):
        """(B, k) per shard -> (B, n*k), the shards' entries in shard
        order, for every shard."""
        g = torch.cat(xs, dim=-1)
        return [g] * self.n

    def sum(self, xs):
        s = xs[0]
        for x in xs[1:]:
            s = s + x
        return [s] * self.n


class DistRing:
    """The sp ring over a process group: each rank holds one shard, so
    every method takes and returns a list of one tensor.  NCCL on GPUs,
    gloo on the CPU; data moves as bytes."""

    def __init__(self, group):
        self.group = group
        self.n = dist.get_world_size(group)
        self.rank = r = dist.get_rank(group)      # the rank's shard
        self.prev = dist.get_global_rank(group, (r - 1) % self.n)
        self.next = dist.get_global_rank(group, (r + 1) % self.n)

    def corner_turn(self, xs):
        (x,) = xs
        B, nr, ndc = x.shape
        nrl = nr // self.n
        src = x.reshape(B, self.n, nrl, ndc).transpose(0, 1).contiguous()
        dst = torch.empty_like(src)                # (source shard, B, nrl, ndc)
        dist.all_to_all_single(_wire(dst), _wire(src), group=self.group)
        return [dst.permute(1, 2, 0, 3).reshape(B, nrl, self.n * ndc)]

    def halo(self, xs, h: int, edge: str = "wrap"):
        (x,) = xs
        if h == 0:
            return [(x[..., :0, :], x[..., :0, :])]
        up = x[..., x.shape[-2] - h:, :].contiguous()   # -> next's lo
        down = x[..., :h, :].contiguous()               # -> prev's hi
        lo, hi = torch.empty_like(up), torch.empty_like(down)
        # At sp == 2 prev and next are one rank: the two sends pair with
        # the two receives by order (NCCL) and by tag (gloo).
        ops = [dist.P2POp(dist.isend, _wire(up), self.next, self.group, 0),
               dist.P2POp(dist.isend, _wire(down), self.prev, self.group, 1),
               dist.P2POp(dist.irecv, _wire(lo), self.prev, self.group, 0),
               dist.P2POp(dist.irecv, _wire(hi), self.next, self.group, 1)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [_global_edges(x, lo, hi, h, edge, self.rank == 0,
                              self.rank == self.n - 1)]

    def gather(self, xs):
        (x,) = xs
        out = _gather_frames(x, self.group, self.n)     # (n*B, k)
        return [out.unflatten(0, (self.n, -1)).movedim(0, -2).flatten(-2)]

    def sum(self, xs):
        (x,) = xs
        s = x.clone()
        dist.all_reduce(s, group=self.group)
        return [s]


def _gather_frames(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """(b, ...) per rank of ``group`` -> (n*b, ...) in rank order."""
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(_wire(out), _wire(x), group=group)
    return out


def sp_ring(mesh):
    """The sp-axis collectives of ``mesh``: a ``LocalRing`` on a LocalMesh,
    a ``DistRing`` over the mesh's sp group on a DeviceMesh."""
    if isinstance(mesh, LocalMesh):
        return LocalRing(mesh.sp)
    return DistRing(mesh.get_group("sp"))


# ---------------------------------------------------------------------------
# Gates
# ---------------------------------------------------------------------------

def split_frontend_supported(p: RadarParams, sp: int,
                             fixed: bool = False) -> bool:
    """Can the kernels run the split front end of an sp-sharded mesh: the
    range kernel on chirp shards (n_range a power of two in [16, 1024] or
    n2 x 128 with n2 <= 16; kernel A any n_doppler/sp,
    ``ops/frontend.check_range_geometry``, with ``fixed`` the fixed range
    kernel's n_doppler/sp a multiple of 8,
    ``ops/frontend_fixed.check_range_geometry_fixed``) and the
    magnitude-only kernel on range shards
    (``ops/frontend.check_mag_geometry``)?  (JAX's 128-lane rule is the
    TPU's and does not apply.)"""
    if p.n_range % sp or p.n_doppler % sp:
        return False
    try:
        if fixed:
            FX.check_range_geometry_fixed(p.n_range, p.n_doppler // sp)
        else:
            F.check_range_geometry(p.n_range, p.n_doppler // sp)
        F.check_mag_geometry(p.n_range // sp, p.n_doppler)
    except NotImplementedError:
        return False
    return True


def split_detect_supported(p: RadarParams, sp: int,
                           peak_group_radius: int = 0,
                           fixed: bool = False) -> bool:
    """Can the split entry (kernel B's, float32, or with ``fixed`` the
    fixed kernel's) decide on the range shards:
    ``split_frontend_supported``, wrap edges and per-cell scale (any
    variant), its tile (``ops/frontend._slowtime_config``: 64, 32, 16 or 8
    rows dividing the shard's + 2 (halo_range + peak_group_radius) halo
    rows <= 128, or at a long CPI or a dense length the decide kernel's
    tile, with ``fixed`` the int32 map's), and a halo that one neighbour
    holds?"""
    h = p.cfar.halo_range + peak_group_radius
    if (not split_frontend_supported(p, sp, fixed)
            or p.cfar.scale_mode != "cell"
            or h > p.n_range // sp):
        return False
    try:
        F._slowtime_config(1, p.n_range // sp, p.n_doppler, p.cfar, 0,
                           peak_group_radius, int_map=fixed)
    except NotImplementedError:
        return False
    return True


# ---------------------------------------------------------------------------
# The processor
# ---------------------------------------------------------------------------

def _mesh_info(mesh, device):
    """(mesh, is local, dp, sp, device, dp rank, sp rank) of ``mesh``
    (None: ``make_mesh(device=device)``); the ranks are None on a
    LocalMesh, which holds every shard."""
    if mesh is None:
        mesh = make_mesh(device=device)
    if isinstance(mesh, LocalMesh):
        return mesh, True, mesh.dp, mesh.sp, mesh.device, None, None
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))
    return (mesh, False, mesh["dp"].size(), mesh["sp"].size(), dev,
            mesh.get_local_rank("dp"), mesh.get_local_rank("sp"))


def _gather_dp(outs, mesh, local: bool, dp: int, keys) -> dict:
    """The dp blocks' outputs as one batch: concatenated on a LocalMesh;
    on a DeviceMesh the rank's own block, with ``keys`` gathered over dp."""
    if local:
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
    out = outs[0]
    if dp > 1:
        group = mesh.get_group("dp")
        for k in keys:
            out[k] = _gather_frames(out[k], group, dp)
    return out


def shard_cfar_route(p: RadarParams, route: str, include_debug: bool,
                     bits: int | None, rows: int) -> Callable:
    """The sharded tail's CFAR on a range shard of ``rows`` rows prepadded
    with its halo rows: ``fn(m_h, so, scale_map) -> (det, threshold,
    scale)`` (threshold None without the debug taps): with the taps the
    rank-select CFAR's prepadded entry (its twin on "plain"), else the
    standalone CFAR's; CA/GO/SO and "plain" without the taps the plain
    ``ops/cfar.cfar_2d``.  The kernel chosen is asked at once, on the host
    and every device, whether it takes the shard (``check_kernel`` of
    ``ops/cfar_rank`` or ``ops/cfar_detect``), so that the processor
    refuses at build what the card would refuse at the call."""
    cfar = p.cfar
    pre = dict(prepadded_range=True)
    if cfar.variant != "os" or (route == "plain" and not include_debug):
        return lambda m_h, so, sm: C.cfar_2d(
            m_h, so, cfar, need_debug=include_debug, scale_map=sm, **pre)
    block = cfar.scale_mode == "block"
    if include_debug:
        rank = RK.cfar_rank_plain
        if route != "plain":
            RK.check_kernel(rows, p.n_doppler, cfar, bits, block=block,
                            prepadded=True)
            rank = RK.cfar_rank
        return lambda m_h, so, sm: rank(m_h, so, cfar=cfar, bits=bits,
                                        scale_map=sm, **pre)
    CD.check_kernel(rows, p.n_doppler, cfar, block=block, prepadded=True)

    def detect(m_h, so, sm):
        det, scale = CD.cfar_detect(m_h, so, cfar=cfar, scale_map=sm, **pre)
        return det, None, scale
    return detect


def make_sharded_processor(mesh=None, params: RadarParams | None = None,
                           mode: str = "float32", frontend: str = "auto",
                           window_rounding: str = "unbiased",
                           mti_transient: str = "zero",
                           peak_group_radius: int = 0,
                           magnitude_exact: bool = False,
                           include_maps: bool = False,
                           include_debug: bool = False,
                           cfar_rank_bits: int | None = 16,
                           device=None) -> Callable:
    """Build the sharded frame-batch processor on ``mesh`` (a DeviceMesh
    from ``make_mesh`` or a ``LocalMesh``; None: ``make_mesh(device=
    device)``, NCCL on CUDA, raising without a GPU).

    Returned callable: ``fn(iq, mti_bypass=False, scale_override=0) ->
    dict`` with iq int16 (batch, n_doppler, n_range, 2), batch divisible by
    dp, n_doppler and n_range by sp; the outputs of ``make_batch_processor``
    (see the module docstring for where each lives).  The keywords are
    ``make_batch_processor``'s."""
    p = params or RadarParams()
    mesh, local, dp, sp, dev, dp_rank, sp_rank = _mesh_info(mesh, device)
    if mode not in ("float32", "fixed"):
        raise ValueError(f"mode must be 'float32' or 'fixed', got {mode!r}")
    if p.n_doppler % sp or p.n_range % sp:
        raise ValueError(f"n_doppler={p.n_doppler} and n_range={p.n_range} "
                         f"must divide the sp axis ({sp})")
    C.check_supported(p.cfar)
    reflect = p.cfar.edge_mode == "reflect"
    route = PL.resolve_frontend(mode, frontend)
    fixed = mode == "fixed"
    if fixed:
        check_notch(p.notch_mode, mti_transient)
        window_rounding_constant(p.coef_width, window_rounding)
        if include_debug and route == "fused":
            raise ValueError(
                "frontend='fused' with mode='fixed' runs the fused "
                "fixed-point kernels, which compute no debug taps (as on "
                "one device)")
    nrl = p.n_range // sp
    ndc = p.n_doppler // sp
    hr, pgr = p.cfar.halo_range, peak_group_radius
    block = p.cfar.scale_mode == "block"
    if sp > 1 and max(hr, pgr) > nrl:
        # One ring hop supplies at most a neighbour shard's rows per side.
        raise ValueError(
            f"CFAR halo_range ({hr}) and peak_group_radius ({pgr}) must not "
            f"exceed the local range extent (n_range/sp = {nrl})")
    if sp > 1 and reflect and hr + 1 > nrl:
        raise ValueError(
            f"edge_mode='reflect' needs halo_range + 1 <= n_range/sp "
            f"({hr + 1} > {nrl}) for the edge shards' local mirror")
    if sp > 1 and block and nrl % p.cfar.scale_block:
        raise ValueError(
            f"scale_mode='block' needs the local range extent ({nrl} = "
            f"n_range/sp) divisible by scale_block={p.cfar.scale_block}")
    split_detect = (sp > 1 and route == "fused" and not block
                    and not include_debug and not reflect)
    if sp > 1 and route == "fused":
        if fixed and (block or reflect):
            raise ValueError(
                "frontend='fused' with mode='fixed' on an sp-sharded mesh "
                "runs the split fixed kernels, which take the per-cell "
                "scale and wrap edges only (as JAX's)")
        ok = (split_detect_supported(p, sp, pgr, fixed) if split_detect
              else split_frontend_supported(p, sp, fixed))
        if not ok:
            raise NotImplementedError(
                f"the split front-end kernels do not take a "
                f"{p.n_range}x{p.n_doppler} frame at sp={sp} with {p.cfar} "
                f"and peak_group_radius={pgr} (split_detect_supported / "
                f"split_frontend_supported)")
    max_dets = p.tracker.max_dets
    single = None
    if sp == 1:
        single = PL.make_batch_processor(
            p, mode=mode, frontend=frontend, window_rounding=window_rounding,
            mti_transient=mti_transient, peak_group_radius=pgr,
            magnitude_exact=magnitude_exact, include_maps=include_maps,
            include_debug=include_debug, cfar_rank_bits=cfar_rank_bits,
            device=dev)
    bits = debug_bits(p.cfar, fixed, cfar_rank_bits)
    tail_cfar = None
    if sp > 1 and not split_detect:
        tail_cfar = shard_cfar_route(p, route, include_debug, bits, nrl)
    ring = sp_ring(mesh) if sp > 1 else None
    my_shards = list(range(sp)) if local else [sp_rank]
    offsets = [s * nrl for s in my_shards]

    def range_stage(x):
        """A chirp shard's range-major planes (B, nr, nd/sp) and, in fixed
        mode, its window saturations."""
        if fixed:
            rng = (SF.range_frontend_fixed if route == "fused"
                   else FX.range_fft_fixed_plain)
            return rng(x, p.coef_width, window_rounding)
        if route == "staged":
            re, im = dft_apply(x[..., 0].to(torch.float32),
                               x[..., 1].to(torch.float32), window=True)
            return re.transpose(-1, -2), im.transpose(-1, -2)
        return (SF.range_frontend if route == "fused"
                else F.range_fft_plain)(x)

    def slowtime_stage(re, im, bypass):
        """A range shard's magnitudes (B, nrl, nd) and its count: the
        non-finite cells, or the Doppler window's saturations."""
        if fixed:
            return FX.slowtime_mag_fixed_plain(
                re, im, bypass, p.notch_mode, mti_transient, p.coef_width,
                window_rounding)
        if route == "fused":
            return SF.slowtime_detect_split(
                re, im, mti_bypass=bypass, detect=False,
                notch_mode=p.notch_mode, transient=mti_transient,
                exact_mag=magnitude_exact)
        if route == "staged":
            mag = magnitude_float(*doppler_apply(re, im, bypass, p.notch_mode,
                                                 mti_transient),
                                  exact=magnitude_exact)
        else:
            mag = F.slowtime_mag_plain(re, im, bypass, p.notch_mode,
                                       mti_transient, magnitude_exact)
        return mag, (~torch.isfinite(mag)).sum(dim=(-2, -1)).to(torch.int32)

    def cfar_tail(mags, so):
        """The sharded CFAR and grouping of the range shards' magnitudes:
        [(det, debug maps)] per shard.  The CFAR halo mirrors at the global
        edges under reflect; the grouping halo is the ring's."""
        scales = (C.block_scale_map_sharded(mags, p.cfar, ring.halo)
                  if block else [None] * len(mags))
        out = []
        for m, (lo, hi), sm in zip(mags, ring.halo(mags, hr,
                                                   p.cfar.edge_mode), scales):
            det, thr, scale = tail_cfar(torch.cat([lo, m, hi], dim=-2), so,
                                        sm)
            if include_debug:
                scale = scale.to(m.dtype)       # the map's type, as JAX's tap
            out.append((det, {"threshold_map": thr, "scale_map": scale}))
        if pgr > 0:
            dets = [d for d, _ in out]
            for i, (d, (lo, hi), off) in enumerate(zip(
                    dets, ring.halo(dets, pgr), offsets)):
                ids = (off + torch.arange(-pgr, nrl + pgr)) % p.n_range
                g = C.peak_group(torch.cat([lo, d, hi], dim=-2), pgr,
                                 row_ids=ids)[..., pgr:pgr + nrl, :]
                out[i] = (g, out[i][1])
        return out

    def block_fn(shards, bypass, so) -> dict:
        """One dp block of frames, its chirp shards ``shards``: the
        detection outputs (replicated over sp) and the shards' maps."""
        outs = [range_stage(x) for x in shards]
        re = ring.corner_turn([o[0] for o in outs])
        im = ring.corner_turn([o[1] for o in outs])
        sat_r = [o[2] if fixed else 0 for o in outs]
        if split_detect:
            h = hr + pgr
            kw = dict(cfar=p.cfar, n_range_total=p.n_range,
                      notch_mode=p.notch_mode, transient=mti_transient,
                      peak_group_radius=pgr, emit_mag=include_maps)
            if fixed:
                kern = SF.slowtime_detect_fixed_split
                kw.update(coef_width=p.coef_width, rounding=window_rounding)
            else:
                kern = SF.slowtime_detect_split
                kw.update(exact_mag=magnitude_exact)
            locs, stats, maps = [], [], []
            for s_re, s_im, (lo_re, hi_re), (lo_im, hi_im), off, sr in zip(
                    re, im, ring.halo(re, h), ring.halo(im, h), offsets,
                    sat_r):
                det, mag, rmax, ndet, stat = kern(
                    s_re, s_im, (lo_re, lo_im), (hi_re, hi_im), bypass, so,
                    off, **kw)
                locs.append(DET.topk_detections(det, max_dets, row_max=rmax,
                                                n_dets=ndet))
                stats.append(stat + sr)
                maps.append({"mag_map": mag, "det_map": det})
        else:
            mags = [slowtime_stage(a, b, bypass) for a, b in zip(re, im)]
            stats = [stat + sr for (_, stat), sr in zip(mags, sat_r)]
            tail = cfar_tail([m for m, _ in mags], so)
            locs = [DET.topk_detections(det, max_dets) for det, _ in tail]
            maps = [{"mag_map": m, "det_map": det, **dbg}
                    for (m, _), (det, dbg) in zip(mags, tail)]
        # Global top-K: each shard's K strongest with global range bins,
        # gathered in shard order, then a stable descending sort.
        vals = ring.gather([d["mag"] for d in locs])[0]
        rbin = ring.gather([d["range_bin"] + off
                            for d, off in zip(locs, offsets)])[0]
        dbin = ring.gather([d["doppler_bin"] for d in locs])[0]
        vals, idx = DET.top_k(vals, max_dets)
        zeros = torch.zeros_like(locs[0]["n_dets"])
        count = ring.sum(stats)[0]
        out = {"range_bin": torch.gather(rbin, -1, idx),
               "doppler_bin": torch.gather(dbin, -1, idx),
               "mag": vals, "valid": vals > 0,
               "n_dets": ring.sum([d["n_dets"] for d in locs])[0],
               "saturation_count": count if fixed else zeros,
               "nonfinite_count": zeros if fixed else count}
        keys = ((("mag_map", "det_map") if include_maps else ())
                + (("threshold_map", "scale_map") if include_debug else ()))
        for key in keys:
            out[key] = torch.cat([m[key] for m in maps], dim=-2)
        return out

    expected = (p.n_doppler, p.n_range, 2)

    def process(iq, mti_bypass=False, scale_override=0) -> dict:
        if iq.ndim != 4 or tuple(iq.shape[1:]) != expected:
            raise ValueError(
                f"expected iq batch of shape (batch, {p.n_doppler}, "
                f"{p.n_range}, 2), got {tuple(iq.shape)}")
        if iq.shape[0] % dp:
            raise ValueError(f"batch {iq.shape[0]} not divisible by dp={dp}")
        iq = torch.as_tensor(iq)
        bl = iq.shape[0] // dp
        bypass, so = bool(mti_bypass), int(scale_override)
        outs = []
        for d in (range(dp) if local else [dp_rank]):
            frames = iq[d * bl:(d + 1) * bl]
            if sp == 1:
                outs.append(single(frames, bypass, so))
            else:
                outs.append(block_fn(
                    [frames[:, s * ndc:(s + 1) * ndc].to(dev)
                     for s in my_shards], bypass, so))
        return _gather_dp(outs, mesh, local, dp, DETECTION_KEYS)

    process.route = route
    return process


ARRAY_KEYS = DETECTION_KEYS + ("beam_bin",)


def make_sharded_array_processor(mesh=None, params: RadarParams | None = None,
                                 n_elems: int = 8, n_beams: int = 8,
                                 mti_transient: str = "zero",
                                 magnitude_exact: bool = False,
                                 ref_angle: int = 0, guard_angle: int = 0,
                                 spacing_wl: float = 0.5,
                                 max_angle_deg: float = 60.0,
                                 taper: str | None = None,
                                 include_maps: bool = False,
                                 frontend: str = "auto",
                                 peak_group_radius: int = 0,
                                 beam_group_radius: int = 0,
                                 device=None) -> Callable:
    """The array-radar model on ``mesh`` (as ``make_sharded_processor``
    takes it): cubes over ``dp``, BEAMS over ``sp``.  Port of
    ``fmcw_tpu/parallel/sharded.make_sharded_array_processor``.

    Every sp shard gets the whole element-space cube (every beam needs
    every element), runs the full beamformer (``ops/beamform.beamform``, the
    same call as ``models/pipeline.make_batch_array_processor`` makes, so
    the local beams' numbers are the single device's) and keeps its
    ``n_beams/sp`` beams.  Per beam, as on one device (route ``frontend``:
    "fused" — "auto" — "staged" or "plain"): the front end and the 2D CFAR
    with per-beam grouping (``ref_angle == 0``), or the magnitudes and the
    3D CFAR, whose training set spans neighbour beams: a **ring exchange of
    ``ref_angle + guard_angle`` beam planes** feeds
    ``cfar3d_detect(prepadded_angle=True)``, the beam axis wrapping as on
    one device (under reflect edges mirrored at the global edges: the edge
    shards' own planes, flipped); then per-beam ``peak_group``.
    Cross-beam grouping (``beam_group_radius``) exchanges that many planes
    and groups by global beam ids with the cube's non-periodic edges
    (``ops/beam_group``'s ``beam_offset`` entry).  Detections: each shard's
    top-K with global beam ids, gathered over sp in shard order, a stable
    global top-K; ``n_dets`` and ``nonfinite_count`` summed over sp,
    ``saturation_count`` 0.  Every output equals ``make_batch_array_processor``'s on the same
    route bit for bit.

    Returned callable: ``fn(iq, mti_bypass=False, scale_override=0) ->
    dict`` with iq int16 (batch, n_elems, n_doppler, n_range, 2), batch
    divisible by dp; the outputs of ``make_batch_array_processor``: the
    detection arrays of the whole batch on every rank, and with
    ``include_maps`` the rank's own (batch/dp, n_beams/sp, n_range,
    n_doppler) ``mag_cube`` / ``det_cube`` shard (on a LocalMesh the whole
    cubes).  The keywords are ``make_batch_array_processor``'s; the
    exchanges reach one neighbour, so ``ref_angle + guard_angle`` (with
    ``ref_angle > 0``, plus one under reflect edges) and
    ``beam_group_radius`` must not exceed ``n_beams/sp``."""
    p = params or RadarParams()
    mesh, local, dp, sp, dev, dp_rank, sp_rank = _mesh_info(mesh, device)
    if n_beams % sp:
        raise ValueError(f"n_beams={n_beams} must divide the sp axis ({sp})")
    bl = n_beams // sp
    ha = ref_angle + guard_angle
    if ref_angle > 0 and sp > 1 and ha > bl:
        # Single-hop ring exchange: at most one neighbour shard's planes.
        raise ValueError(
            f"angle halo (ref_angle+guard_angle = {ha}) must not exceed "
            f"the local beam extent (n_beams/sp = {bl})")
    C.check_supported(p.cfar)
    reflect = p.cfar.edge_mode != "wrap"
    if ref_angle > 0 and sp > 1 and reflect and ha + 1 > bl:
        raise ValueError(
            f"edge_mode='reflect' needs ref_angle+guard_angle+1 <= "
            f"n_beams/sp ({ha + 1} > {bl}) for the edge shards' mirror")
    if sp > 1 and beam_group_radius > bl:
        raise ValueError(
            f"beam_group_radius ({beam_group_radius}) must not exceed the "
            f"local beam extent (n_beams/sp = {bl})")
    route = PL.resolve_array_frontend(frontend, p, ref_angle,
                                      peak_group_radius)
    BF.steering_matrix(n_elems, n_beams, spacing_wl, max_angle_deg, taper)
    nr, nd = p.n_range, p.n_doppler
    max_dets = p.tracker.max_dets
    plain = route == "plain"
    tf_kw = dict(notch_mode=p.notch_mode, transient=mti_transient,
                 exact_mag=magnitude_exact)
    range_fft = F.range_fft_float_plain if plain else F.range_fft_float
    detect = F.slowtime_detect_plain if plain else F.slowtime_detect
    # The shards' 3D CFAR or standalone CFAR per beam (staged, reflect),
    # their kernels asked at once whether they take the shards' maps.
    cfar3d = cfar2d = None
    if sp > 1 and ref_angle > 0:
        cfar3d = PL.cfar3d_route(p.cfar, plain, (bl, nr, nd), ref_angle,
                                 guard_angle, prepadded=True)
    elif sp > 1 and (route == "staged" or reflect):
        cfar2d = PL.cfar_group_route(p.cfar, plain, (nr, nd),
                                     peak_group_radius)
    group = beam_group_plain if plain else beam_group
    single = None
    if sp == 1:
        single = PL.make_batch_array_processor(
            p, n_elems=n_elems, n_beams=n_beams, mti_transient=mti_transient,
            magnitude_exact=magnitude_exact, ref_angle=ref_angle,
            guard_angle=guard_angle, spacing_wl=spacing_wl,
            max_angle_deg=max_angle_deg, taper=taper,
            include_maps=include_maps, frontend=frontend,
            peak_group_radius=peak_group_radius,
            beam_group_radius=beam_group_radius, device=dev)
    ring = sp_ring(mesh) if sp > 1 else None
    my_shards = list(range(sp)) if local else [sp_rank]

    def halo_planes(cubes, h, edge="wrap"):
        """Each shard's (B, bl, R, D) cube extended by ``h`` planes of its
        ring neighbours on each side: the ring's row halo on the (B, bl,
        R*D) view, ``edge`` at the global edges (``_global_edges``)."""
        flat = [c.reshape(c.shape[0], bl, nr * nd) for c in cubes]
        return [torch.cat([lo, f, hi], dim=-2).reshape(-1, bl + 2 * h, nr, nd)
                for f, (lo, hi) in zip(flat, ring.halo(flat, h, edge))]

    def front(br, bi, bypass, so):
        """One shard's beam planes (B, bl, nd, nr) -> (det (B, bl, nr, nd),
        or None where the 3D CFAR still has to run; mag or None; row_max
        (B, bl*nr) and n_dets (B,) from the 2D CFAR; nonfinite (B,))
        — ``make_batch_array_processor``'s per-beam steps."""
        B = br.shape[0]
        br = br.reshape(B * bl, nd, nr)
        bi = bi.reshape(B * bl, nd, nr)
        det = row_max = n_dets = None
        if route == "staged":
            mag = PL._staged_float(br, bi, bypass, p, mti_transient,
                                   magnitude_exact).reshape(B, bl, nr, nd)
            nonfinite = (~torch.isfinite(mag)).sum(dim=(-2, -1))
        elif ref_angle == 0 and not reflect:
            det, mag, rmax, ndet, nonfinite = detect(
                *range_fft(br, bi), bypass, so, cfar=p.cfar,
                peak_group_radius=peak_group_radius, emit_mag=include_maps,
                **tf_kw)
            det = det.reshape(B, bl, nr, nd)
            row_max = rmax.reshape(B, bl * nr)
            n_dets = ndet.reshape(B, bl).sum(dim=1)
        elif plain:
            mag = F.slowtime_mag_plain(*range_fft(br, bi), bypass, **tf_kw)
            nonfinite = (~torch.isfinite(mag)).sum(dim=(-2, -1))
        else:
            mag, nonfinite = F.slowtime_mag(*range_fft(br, bi), bypass,
                                            **tf_kw)
        if mag is not None:
            mag = mag.reshape(B, bl, nr, nd)
        if det is None and ref_angle == 0:
            # The staged route, or reflect edges: the standalone CFAR per
            # beam (its reflect entry under reflect).
            det, _, rmax, ndet = cfar2d(
                mag, so, cfar=p.cfar, peak_group_radius=peak_group_radius)
            row_max = rmax.reshape(B, bl * nr)
            n_dets = ndet.sum(dim=1)
        return (det, mag, row_max, n_dets,
                nonfinite.reshape(B, bl).sum(dim=1).to(torch.int32))

    def cube_fn(iq, bypass, so) -> dict:
        """One dp block of cubes on sp > 1 shards: the detection outputs
        (replicated over sp) and the shards' cubes."""
        br, bi = BF.beamform(iq[..., 0].to(torch.float32),
                             iq[..., 1].to(torch.float32), n_beams,
                             spacing_wl=spacing_wl,
                             max_angle_deg=max_angle_deg, taper=taper,
                             elem_dim=1)
        dets, mags, row_max, n_dets, nonfinite = map(list, zip(*(
            front(br[:, s * bl:(s + 1) * bl], bi[:, s * bl:(s + 1) * bl],
                  bypass, so) for s in my_shards)))
        if ref_angle > 0:
            dets = [C.peak_group(cfar3d(c, so, cfar=p.cfar,
                                        ref_angle=ref_angle,
                                        guard_angle=guard_angle,
                                        prepadded_angle=True)[0],
                                 peak_group_radius)
                    for c in halo_planes(mags, ha, p.cfar.edge_mode)]
        if beam_group_radius > 0:
            dets, row_max, n_dets = map(list, zip(*(
                group(e, beam_group_radius, beam_offset=s * bl,
                      n_beams=n_beams)
                for e, s in zip(halo_planes(dets, beam_group_radius),
                                my_shards))))
        B = iq.shape[0]
        locs = [DET.topk_detections(d.reshape(B, bl * nr, nd), max_dets,
                                    row_max=rm, n_dets=n)
                for d, rm, n in zip(dets, row_max, n_dets)]
        # Global top-K: each shard's K strongest with global beam ids,
        # gathered in shard order, then a stable descending sort.
        vals = ring.gather([d["mag"] for d in locs])[0]
        bbin = ring.gather([torch.div(d["range_bin"], nr,
                                      rounding_mode="floor") + s * bl
                            for d, s in zip(locs, my_shards)])[0]
        rbin = ring.gather([d["range_bin"] % nr for d in locs])[0]
        dbin = ring.gather([d["doppler_bin"] for d in locs])[0]
        vals, idx = DET.top_k(vals, max_dets)
        out = {"range_bin": torch.gather(rbin, -1, idx),
               "doppler_bin": torch.gather(dbin, -1, idx),
               "mag": vals, "valid": vals > 0,
               "n_dets": ring.sum([d["n_dets"] for d in locs])[0],
               "beam_bin": torch.gather(bbin, -1, idx),
               "saturation_count": torch.zeros_like(locs[0]["n_dets"]),
               "nonfinite_count": ring.sum(nonfinite)[0]}
        if include_maps:
            out["mag_cube"] = torch.cat(mags, dim=1)
            out["det_cube"] = torch.cat(dets, dim=1)
        return out

    expected = (n_elems, nd, nr, 2)

    def process(iq, mti_bypass=False, scale_override=0) -> dict:
        if iq.ndim != 5 or tuple(iq.shape[1:]) != expected:
            raise ValueError(
                f"expected element-space iq batch of shape (batch, "
                f"{n_elems}, {nd}, {nr}, 2), got {tuple(iq.shape)}")
        if iq.shape[0] % dp:
            raise ValueError(f"batch {iq.shape[0]} not divisible by dp={dp}")
        iq = torch.as_tensor(iq)
        b = iq.shape[0] // dp
        bypass, so = bool(mti_bypass), int(scale_override)
        outs = []
        for d in (range(dp) if local else [dp_rank]):
            cubes = iq[d * b:(d + 1) * b].to(dev)
            outs.append(single(cubes, bypass, so) if sp == 1
                        else cube_fn(cubes, bypass, so))
        return _gather_dp(outs, mesh, local, dp, ARRAY_KEYS)

    process.route = route
    return process
