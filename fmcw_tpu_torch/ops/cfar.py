"""2D OS-CFAR and peak grouping in plain PyTorch.

The plain twin of the decision half of the CUDA kernel
``csrc/slowtime_detect.cu`` (and of the epilogues ``_detect_epilogue``,
``_block_scale`` and ``_peak_group_epilogue`` of
``fmcw_tpu/ops/frontend_pallas.py``).  The decision is made by COUNTING,
never by sorting: for the k-th largest training value ``est``
(k = n_ref - rank_idx),

    est >  T      <=>  count(refs >  T) >= k
    est <  T      <=>  count(refs >= T) <  k
    cut > est*s   <=>  count(refs >= q_min) < k,

where q_min is the smallest float whose rounded product with the scale
reaches the CUT (found by probing the bit patterns just below cut/s).  Every
float sum (the per-cell adaptive-scale mean, the block sums) is taken in one
fixed association order, which the CUDA kernel repeats exactly, so kernel
and twin make bit-identical decisions on the same magnitudes:

* per-cell mean: full-window minus guard-window box sums, each an inner sum
  over dr ascending inside an outer sum over dd ascending (the tree of
  ``fmcw_tpu/ops/cfar._box2d_sum`` and ``cfar_pallas._boxsum``);
* block sums: rows of a block ascending, then its columns ascending; the
  3x3-block neighborhood summed Doppler-offset-major, range-offset-minor
  (the term order of ``fmcw_tpu/ops/cfar.block_scale_map``).

Integer maps (the fixed-point chain; any integer dtype) take the integer
semantics of ``fmcw_tpu/ops/cfar.cfar_2d(integer=True)``: floor mean,
t_hi = mean + (mean>>1), t_lo = mean>>1, and the exact decision
cut > est*scale  <=>  count(refs >= ceil(cut/scale)) < k.  Float maps are
float32.  The plain twin of ``csrc/cfar_detect.cu`` too (``ops/cfar_detect``).

All functions take maps with any leading batch dimensions, ``(..., R, D)``,
and ``CfarParams.edge_mode``'s edges: "wrap" (the torus of the reference's
line buffers) or "reflect" (numpy's: the edge cell not repeated, row -1
reads row 1; ``_reflect_pad``, JAX's ``_pad2d``).  The block scale clips
its 3x3-block neighbourhood at the edges under any edge mode other than
wrap (JAX's ``block_scale_map``), and peak grouping always wraps, as JAX's.

The sharded processor's pieces (``parallel/sharded.py``, after
``fmcw_tpu/parallel/sharded.py``): ``cfar_2d(prepadded_range=True)`` on a
range shard that carries ``halo_range`` exchanged rows on each side,
``peak_group(row_ids=...)`` with global row ids on a halo-extended shard, and
``block_scale_map_sharded``, the block scale of range shards from one
exchanged block-grid row per side.

The array model's pieces: ``cfar_3d`` (the angle-extended CFAR over
(..., A, R, D) beam cubes, the plain twin of ``csrc/cfar_3d_detect.cu``, its
training-set sum in that kernel's order) and ``peak_group_beams`` (cross-beam
grouping, the plain twin of ``csrc/beam_group.cu``).

The hw-compat streaming CFAR (``cfar_geometry="hw_stream"``, port of
``fmcw_tpu/ops/cfar.cfar_2d_hw_stream``): ``cfar_2d_hw_stream`` frames one
map or a batch of maps as flat streams (``[hist or zeros, frame, zeros]``),
decides every cell on the stream's row-carry-baked padded buffer with the
axes swapped (``hw_stream_decide_plain``: ``cfar_2d(prepadded_range=
"both")``, the plain twin of ``csrc/cfar_detect.cu``'s flat-stream entry),
then applies the emission window, the label roll and the line-buffer
carry.
"""

from __future__ import annotations

import dataclasses

import torch

from ..params import CfarParams
from ..golden.fixed_point import (_hw_stream_offsets, _window_offsets,
                                  hw_stream_lag)


def _wrap_pad(m: torch.Tensor, hr: int, hd: int) -> torch.Tensor:
    """Pad the last two axes of ``m`` circularly by ``hr`` rows and ``hd``
    columns on each side."""
    if hr:
        m = torch.cat([m[..., -hr:, :], m, m[..., :hr, :]], dim=-2)
    if hd:
        m = torch.cat([m[..., -hd:], m, m[..., :hd]], dim=-1)
    return m


def reflect_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """numpy's "reflect" of indices ``i`` into [0, n): the edge not
    repeated (-1 -> 1, n -> n - 2), periodic with period 2 (n - 1) beyond
    one mirror, as ``np.pad(mode="reflect")`` pads any width."""
    if n == 1:
        return torch.zeros_like(i)
    j = i % (2 * (n - 1))
    return torch.where(j < n, j, 2 * (n - 1) - j)


def _reflect_pad(m: torch.Tensor, hr: int, hd: int) -> torch.Tensor:
    """Pad the last two axes of ``m`` by reflection (``np.pad(mode=
    "reflect")``) by ``hr`` rows and ``hd`` columns on each side."""
    for dim, h in ((-2, hr), (-1, hd)):
        if h:
            n = m.shape[dim]
            idx = reflect_index(torch.arange(-h, n + h, device=m.device), n)
            m = m.index_select(dim, idx)
    return m


def _pad(m: torch.Tensor, hr: int, hd: int, cfar: CfarParams) -> torch.Tensor:
    """The map padded by the window's halos with ``cfar.edge_mode``."""
    return (_reflect_pad if cfar.edge_mode == "reflect" else _wrap_pad)(
        m, hr, hd)


def _box_sum(p: torch.Tensor, win_r: int, win_d: int) -> torch.Tensor:
    """Sum over a win_r x win_d window of a map padded by the half-windows:
    inner sum over rows ascending, outer over columns ascending."""
    R = p.shape[-2] - win_r + 1
    D = p.shape[-1] - win_d + 1
    col = p[..., 0:R, :]
    for i in range(1, win_r):
        col = col + p[..., i:i + R, :]
    acc = col[..., 0:D]
    for j in range(1, win_d):
        acc = acc + col[..., j:j + D]
    return acc


VARIANTS = ("os", "ca", "go", "so")
EDGE_MODES = ("wrap", "reflect")


def check_supported(cfar: CfarParams):
    """The plain CFAR functions take every variant (OS, CA, GO, SO) with
    wrap or reflect edges."""
    if cfar.variant not in VARIANTS:
        raise ValueError(f"CFAR variant must be one of {VARIANTS}, got "
                         f"{cfar.variant!r}")
    if cfar.edge_mode not in EDGE_MODES:
        raise ValueError(f"edge_mode must be one of {EDGE_MODES}, got "
                         f"{cfar.edge_mode!r}")


def check_wrap(cfar: CfarParams, name: str):
    """The kernels that wrap in JAX too raise NotImplementedError for any
    other edge mode: kernel B's and the fixed slow-time kernel's detect and
    split entries (JAX's front-end detect epilogues wrap only), and every
    grouping entry (``cfar_detect_group``, ``cfar_rank_group``: peak
    grouping wraps whatever the edges).  A reflect map never reaches them:
    the routes run the magnitude-only entry or the plain stages, then the
    reflect entries of ``csrc/cfar_detect.cu``, ``csrc/cfar_rank.cu`` or
    ``csrc/cfar_3d_detect.cu``, then the plain grouping."""
    check_supported(cfar)
    if cfar.edge_mode != "wrap":
        raise NotImplementedError(
            f"{name}: edge_mode {cfar.edge_mode!r}: this kernel takes wrap "
            f"edges only, as JAX's (reflect maps take the magnitude-only "
            f"entry or the plain stages, then the standalone, rank-select "
            f"or 3D CFAR's reflect entry and the plain grouping)")


def check_os_supported(cfar: CfarParams):
    """The standalone CFAR kernels (``csrc/cfar_detect.cu``,
    ``csrc/cfar_rank.cu``, ``csrc/cfar_3d_detect.cu``) and their twins
    decide the OS variant only, as JAX's standalone Pallas kernels
    (``fmcw_tpu/ops/cfar_pallas.py``); CA/GO/SO decide in kernel B or in
    the plain ``cfar_2d`` / ``cfar_3d``.  Edges: wrap or reflect
    (``check_wrap`` guards the grouping entries, which wrap only)."""
    check_supported(cfar)
    if cfar.variant != "os":
        raise NotImplementedError(
            f"CFAR variant {cfar.variant!r}: the standalone CFAR kernels "
            f"decide the OS variant only (CA/GO/SO run in kernel B or the "
            f"plain ops/cfar.cfar_2d / cfar_3d)")


def _q_min(cut: torch.Tensor, scale_f: torch.Tensor) -> torch.Tensor:
    """Smallest float32 q with RN(q * scale) >= cut: it lies within two ulps
    below RN(cut / scale), so probe those bit patterns."""
    ti = (cut / scale_f).view(torch.int32)
    q = (ti + 1).view(torch.float32)
    for delta in (0, -1, -2):
        c = (ti + delta).view(torch.float32)
        q = torch.where(c * scale_f >= cut, c, q)
    return q


def _div(a: torch.Tensor, n: int) -> torch.Tensor:
    """IEEE a / n elementwise for float maps (a Python scalar divisor would
    let PyTorch's CUDA path multiply by its reciprocal instead, which can
    differ by an ulp from the kernel's division); floor division for
    integer maps."""
    if not a.is_floating_point():
        return torch.div(a, n, rounding_mode="floor")
    return a / torch.full_like(a, float(n))


def _thresholds(mean: torch.Tensor):
    """(t_hi, t_lo) of the adaptive-scale classification: 1.5x / 0.5x the
    mean, or mean + (mean>>1) / mean>>1 for integer maps."""
    if not mean.is_floating_point():
        return mean + (mean >> 1), mean >> 1
    return 1.5 * mean, 0.5 * mean


def _as_map(mag: torch.Tensor) -> torch.Tensor:
    """float32 for float maps, int32 for integer maps."""
    return mag.to(torch.float32 if mag.is_floating_point() else torch.int32)


def _fold_override(scale: torch.Tensor, scale_override: int) -> torch.Tensor:
    if int(scale_override) < 0:
        raise ValueError(f"scale_override must be >= 0 (0 = adaptive), got "
                         f"{scale_override}")
    if int(scale_override) != 0:
        return torch.full_like(scale, int(scale_override))
    return scale


def _block_k(cfar: CfarParams):
    n = 9 * cfar.scale_block * cfar.scale_block
    return n, n - min((n * cfar.rank_pct) // 100, n - 1)


def _clipped(a: torch.Tensor, dim: int, off: int) -> torch.Tensor:
    """a[b] <- a[b + off] along ``dim``, the index clipped to the axis: the
    edge block stands in for a missing neighbour."""
    n = a.shape[dim]
    idx = (torch.arange(n, device=a.device) + off).clamp(0, n - 1)
    return a.index_select(dim, idx)


def _nb9(a: torch.Tensor, clip: bool = False) -> torch.Tensor:
    """Sum of the 3x3 neighborhood on a (..., Rb, Db) block grid,
    Doppler-block offset outer, range-block offset inner: wrapped, or
    ``clip``ped at the edges (JAX's ``block_scale_map`` for any edge mode
    but wrap)."""
    acc = None
    for di in (-1, 0, 1):
        for dr in (-1, 0, 1):
            if clip:
                t = _clipped(_clipped(a, -2, dr), -1, di)
            else:
                t = torch.roll(a, shifts=(-dr, -di), dims=(-2, -1))
            acc = t if acc is None else acc + t
    return acc


def _block_reduce(x: torch.Tensor, b: int) -> torch.Tensor:
    """(..., R, D) -> (..., R/b, D/b) block sums: the b rows of a block
    ascending, then its b columns ascending."""
    *lead, R, D = x.shape
    rows = x.reshape(*lead, R // b, b, D)
    acc = rows[..., 0, :]
    for i in range(1, b):
        acc = acc + rows[..., i, :]
    cols = acc.reshape(*lead, R // b, D // b, b)
    acc = cols[..., 0]
    for j in range(1, b):
        acc = acc + cols[..., j]
    return acc


def _to_cells(a: torch.Tensor, b: int) -> torch.Tensor:
    return a.repeat_interleave(b, dim=-2).repeat_interleave(b, dim=-1)


def block_scale_map(mag: torch.Tensor, cfar: CfarParams) -> torch.Tensor:
    """Block-granular ("clutter-map") adaptive scale, int32 (..., R, D).

    Per scale_block x scale_block tile: a clutter level from the 3x3-block
    neighborhood mean; each cell exceeds-hi iff v > 1.5 x its own block's
    mean and counts-lo iff v >= 0.5 x its own block's mean; the tile takes
    scale_max when >= k of its neighborhood's 9*B^2 cells exceed hi,
    scale_min when < k of them count lo, else scale_nom
    (k = 9*B^2 - rank_idx).  The neighbourhood wraps with wrap edges and
    clips at the map's edges otherwise.  Semantics of
    fmcw_tpu/ops/cfar.block_scale_map (integer mode for integer maps)."""
    b = cfar.scale_block
    R, D = mag.shape[-2:]
    if R % b or D % b:
        raise ValueError(f"scale_block={b} must divide map shape {(R, D)}")
    n, k = _block_k(cfar)
    clip = cfar.edge_mode != "wrap"
    m = _as_map(mag)
    t_hi, t_lo = _thresholds(_to_cells(_div(_nb9(_block_reduce(m, b), clip),
                                            n), b))
    cnt_hi = _nb9(_block_reduce((m > t_hi).to(torch.int32), b), clip)
    cnt_lo = _nb9(_block_reduce((m >= t_lo).to(torch.int32), b), clip)
    scale_b = torch.where(cnt_hi >= k, cfar.scale_max,
                          torch.where(cnt_lo < k, cfar.scale_min,
                                      cfar.scale_nom))
    return _to_cells(scale_b, b).to(torch.int32)


def block_scale_map_sharded(mags: list, cfar: CfarParams,
                            exchange) -> list:
    """``block_scale_map`` of a map cut into range shards: ``mags`` is the
    list of shards (..., R_i, D) held here (every shard, in order, or one
    rank's own), and ``exchange(xs, h)`` returns, for each tensor of the
    list ``xs``, the pair (the previous shard's last ``h`` rows, the next
    shard's first ``h`` rows) around the ring of shards
    (``parallel/sharded.py``), with ``exchange(xs, h, "clip")`` the global
    edge shards' own edge rows in place of the missing ones.  The 3x3-block
    neighbourhood needs one block-grid row from each neighbour: block sums
    and the hi/lo counts are exchanged, and the neighbourhood is summed in
    ``_nb9``'s term order, so float maps too give ``block_scale_map``'s
    scales bit for bit.  With edges other than wrap the range-block axis
    clips through the exchange and the Doppler-block axis clips locally.
    Returns the int32 scale maps, one per shard.  Port of
    ``fmcw_tpu/ops/cfar.block_scale_map_sharded``."""
    b = cfar.scale_block
    n, k = _block_k(cfar)
    clip = cfar.edge_mode != "wrap"
    ms = [_as_map(m) for m in mags]
    for m in ms:
        if m.shape[-2] % b or m.shape[-1] % b:
            raise ValueError(f"scale_block={b} must divide the shard shape "
                             f"{tuple(m.shape[-2:])}")

    def nb9(grids):
        out = []
        for g, (lo, hi) in zip(grids, exchange(grids, 1,
                                               "clip" if clip else "wrap")):
            e = torch.cat([lo, g, hi], dim=-2)
            rb = g.shape[-2]
            acc = None
            for di in (-1, 0, 1):
                for dr in (-1, 0, 1):
                    t = e[..., 1 + dr:1 + dr + rb, :]
                    t = _clipped(t, -1, di) if clip else torch.roll(t, -di, -1)
                    acc = t if acc is None else acc + t
            out.append(acc)
        return out

    means = nb9([_block_reduce(m, b) for m in ms])
    counts = []
    for m, mean in zip(ms, means):
        t_hi, t_lo = _thresholds(_to_cells(_div(mean, n), b))
        counts.append(torch.stack([
            _block_reduce((m > t_hi).to(torch.int32), b),
            _block_reduce((m >= t_lo).to(torch.int32), b)]))
    out = []
    for cnt_hi, cnt_lo in nb9(counts):
        scale_b = torch.where(cnt_hi >= k, cfar.scale_max,
                              torch.where(cnt_lo < k, cfar.scale_min,
                                          cfar.scale_nom))
        out.append(_to_cells(scale_b, b).to(torch.int32))
    return out


def block_scale(m: torch.Tensor, cfar: CfarParams,
                scale_map: torch.Tensor | None, prepadded_range: bool):
    """The int32 block scale of map ``m`` (``scale_map`` when given, else
    ``block_scale_map``; a prepadded shard needs the given one), or None
    for the per-cell scale, which takes no ``scale_map``."""
    if cfar.scale_mode != "block":
        if scale_map is not None:
            raise ValueError("scale_map applies to scale_mode='block'")
        return None
    if scale_map is None and prepadded_range:
        raise ValueError(
            "scale_mode='block' on a prepadded (sharded) map needs the "
            "scale_map of block_scale_map_sharded")
    return (block_scale_map(m, cfar) if scale_map is None
            else scale_map.to(torch.int32))


def _sum_refs(p: torch.Tensor, cfar: CfarParams) -> torch.Tensor:
    """The training-cell sums of the map padded by the halos in ``p``: the
    full-window minus the guard-window box sum (``_box_sum``'s order, that
    of ``fmcw_tpu/ops/cfar._box2d_sum``)."""
    hr, hd = cfar.halo_range, cfar.halo_doppler
    gr, gd = cfar.guard_range, cfar.guard_doppler
    R, D = p.shape[-2] - 2 * hr, p.shape[-1] - 2 * hd
    pg = p[..., hr - gr:hr + gr + R, hd - gd:hd + gd + D]
    return (_box_sum(p, cfar.win_range, cfar.win_doppler)
            - _box_sum(pg, 2 * gr + 1, 2 * gd + 1))


def percell_thresholds(p: torch.Tensor, cfar: CfarParams):
    """(t_hi, t_lo) of the per-cell adaptive scale of the map padded by the
    halos in ``p``: the mean of ``_sum_refs`` over n_ref, 1.5x / 0.5x it
    (integer: mean + (mean >> 1), mean >> 1)."""
    return _thresholds(_div(_sum_refs(p, cfar), cfar.n_ref))


def _half_sums(p: torch.Tensor, cfar: CfarParams):
    """(lead, lag, n_half) of the GO/SO estimates: the sums over the
    ref_range training rows below (lead: dr in [-hr, -gr-1]) and above
    (lag: dr in [gr+1, hr]) the CUT across the whole window width,
    ``n_half = ref_range * win_doppler`` cells each.  The association
    order of ``fmcw_tpu/ops/cfar._ref_sums``: each row's 2 hd + 1 columns
    ascending first, then those row sums, rows ascending."""
    hr, hd, gr = cfar.halo_range, cfar.halo_doppler, cfar.guard_range
    R, D = p.shape[-2] - 2 * hr, p.shape[-1] - 2 * hd
    rows = p[..., 0:D]
    for j in range(1, cfar.win_doppler):
        rows = rows + p[..., j:j + D]

    def half(r0):
        acc = rows[..., r0:r0 + R, :]
        for i in range(1, cfar.ref_range):
            acc = acc + rows[..., r0 + i:r0 + i + R, :]
        return acc

    return half(0), half(hr + gr + 1), cfar.ref_range * cfar.win_doppler


def _window_estimate(p: torch.Tensor, cfar: CfarParams, need_sum: bool):
    """(est, sum_refs) of the CA/GO/SO variants on the map padded by the
    halos in ``p`` (``fmcw_tpu/ops/cfar.cfar_2d``): CA the training mean;
    GO / SO the greater / smaller of the lead and lag means (NaN
    propagating, as ``jnp.maximum``).  Integer maps divide by floor.
    ``sum_refs`` (``_sum_refs``) only for CA or ``need_sum`` (the per-cell
    scale), else None."""
    sum_refs = (_sum_refs(p, cfar) if cfar.variant == "ca" or need_sum
                else None)
    if cfar.variant == "ca":
        return _div(sum_refs, cfar.n_ref), sum_refs
    lead, lag, n_half = _half_sums(p, cfar)
    ml, mg = _div(lead, n_half), _div(lag, n_half)
    pick = torch.maximum if cfar.variant == "go" else torch.minimum
    return pick(ml, mg), sum_refs


def _classify(est, t_hi, t_lo, cfar: CfarParams) -> torch.Tensor:
    return torch.where(est > t_hi, cfar.scale_max,
                       torch.where(est < t_lo, cfar.scale_min,
                                   cfar.scale_nom)).to(torch.int32)


def _decide_direct(m, est, scale, scale_override: int, need_debug: bool):
    """The CA/GO/SO decision of the map (or cube) ``m``: the override folded
    into ``scale``, then cut > est * scale directly (no counting).  Returns
    ``(det, threshold | None, scale)``.  Integer maps compare in int64, as
    the golden model does: est * scale wraps int32 once a large override
    passes 2^31 / est."""
    scale = _fold_override(scale, scale_override)
    threshold = est * scale.to(m.dtype)
    if m.is_floating_point():
        keep = m > threshold
    else:
        keep = m.to(torch.int64) > est.to(torch.int64) * scale.to(torch.int64)
    det = torch.where(keep, m, torch.zeros_like(m))
    return det, (threshold if need_debug else None), scale


def cfar_2d(mag: torch.Tensor, scale_override: int = 0,
            cfar: CfarParams = CfarParams(), need_debug: bool = False,
            scale_map: torch.Tensor | None = None,
            prepadded_range: bool | str = False):
    """2D CFAR over (..., R, D) magnitude maps, float32 or integer, of
    ``cfar.variant``: OS (decided by counting) or CA / GO / SO (the
    estimate a training-window mean, ``_window_estimate``, and cut > est
    * scale decided directly, as ``fmcw_tpu/ops/cfar.cfar_2d``).

    Returns ``(det, threshold, scale)``: the zero-suppressed detection map
    (the CUT where it exceeds est*scale, else 0, os_cfar_2d.vhd:204-217;
    float32 or int32 like the map), the threshold est*scale (only with
    ``need_debug``, else None — for OS it needs the rank stack, (..., R, D,
    n_ref) values) and the int32 scale map.  ``scale_override`` != 0
    replaces the adaptive scale (the cfar_scale_ovr control port,
    radar_core.vhd:49).
    ``scale_map`` (block scale only): a precomputed int32 scale map, as
    ``fmcw_tpu/ops/cfar.cfar_2d(scale_map=...)`` takes it.

    ``cfar.edge_mode``: "wrap" or "reflect" pads the map (``_pad``), and
    every sum runs in the same order on the padded map.

    ``prepadded_range``: the map carries ``halo_range`` extra rows on each
    side (a range shard with its neighbours' rows, mirrored at the global
    edges under reflect) and only the Doppler axis is padded; the outputs
    have the unpadded rows.  Block scale then needs
    ``scale_map`` (``block_scale_map_sharded``), as in JAX.  ``"both"``:
    the map carries the halos of both axes, (..., R + 2 halo_range, D + 2
    halo_doppler), and neither axis wraps (OS with the per-cell scale only;
    the hw-compat streaming CFAR's padded buffer,
    ``hw_stream_decide_plain``; the edge mode does not apply)."""
    check_supported(cfar)
    hr, hd = cfar.halo_range, cfar.halo_doppler
    m = _as_map(mag)
    integer = not m.is_floating_point()
    if prepadded_range == "both":
        if cfar.scale_mode != "cell" or cfar.variant != "os":
            raise ValueError("prepadded_range='both' takes the OS variant "
                             "with the per-cell scale")
        p = m
        m = m[..., hr:m.shape[-2] - hr, hd:m.shape[-1] - hd]
    elif prepadded_range:
        p = _pad(m, 0, hd, cfar)
        m = m[..., hr:m.shape[-2] - hr, :]
    else:
        p = _pad(m, hr, hd, cfar)
    R, D = m.shape[-2:]
    k = cfar.n_ref - cfar.rank_idx
    offsets = _window_offsets(cfar)

    def ref(dr, dd):
        return p[..., hr + dr:hr + dr + R, hd + dd:hd + dd + D]

    scale = block_scale(m, cfar, scale_map, prepadded_range)
    if cfar.variant != "os":
        est, sum_refs = _window_estimate(p, cfar, scale is None)
        if scale is None:
            scale = _classify(est, *_thresholds(_div(sum_refs, cfar.n_ref)),
                              cfar)
        return _decide_direct(m, est, scale, scale_override, need_debug)
    if scale is None:
        t_hi, t_lo = percell_thresholds(p, cfar)
        cnt_hi = torch.zeros(m.shape, dtype=torch.int32, device=m.device)
        cnt_lo = torch.zeros_like(cnt_hi)
        for dr, dd in offsets:
            v = ref(dr, dd)
            cnt_hi += v > t_hi
            cnt_lo += v >= t_lo
        scale = torch.where(cnt_hi >= k, cfar.scale_max,
                            torch.where(cnt_lo < k, cfar.scale_min,
                                        cfar.scale_nom)).to(torch.int32)
    scale = _fold_override(scale, scale_override)
    if integer:
        # refs*scale >= cut  <=>  refs >= ceil(cut/scale), exactly.
        q = torch.div(m - 1, scale, rounding_mode="floor") + 1
    else:
        q = _q_min(m, scale.to(torch.float32))
    cnt = torch.zeros(m.shape, dtype=torch.int32, device=m.device)
    for dr, dd in offsets:
        cnt += ref(dr, dd) >= q
    det = torch.where((cnt < k) & (m > 0), m, torch.zeros_like(m))
    threshold = None
    if need_debug:
        refs = torch.stack([ref(dr, dd) for dr, dd in offsets], dim=-1)
        est = torch.topk(refs, k, dim=-1).values[..., -1]
        threshold = est * (scale if integer else scale.to(torch.float32))
    return det, threshold, scale


def _offsets_3d(cfar: CfarParams, ref_angle: int, guard_angle: int):
    """Training offsets (da, dr, dd) of ``cfar_3d``'s box-minus-guard-box
    neighbourhood, in the construction order of
    ``fmcw_tpu/ops/cfar._offsets_3d``."""
    offs = []
    for da in range(-(ref_angle + guard_angle), ref_angle + guard_angle + 1):
        for d in range(cfar.win_doppler):
            for r in range(cfar.win_range):
                if (abs(da) <= guard_angle
                        and abs(d - cfar.halo_doppler) <= cfar.guard_doppler
                        and abs(r - cfar.halo_range) <= cfar.guard_range):
                    continue
                offs.append((da, r - cfar.halo_range, d - cfar.halo_doppler))
    return offs


def _axis_pad(m: torch.Tensor, dim: int, h: int,
              edge_mode: str) -> torch.Tensor:
    """Pad axis ``dim`` of ``m`` by ``h`` on each side, periodically
    ("wrap") or by reflection ("reflect"), for any ``h``, also beyond the
    axis length, as numpy's ``np.pad``."""
    n = m.shape[dim]
    idx = torch.arange(-h, n + h, device=m.device)
    idx = reflect_index(idx, n) if edge_mode == "reflect" else idx % n
    return m.index_select(dim, idx)


def cfar_3d(cube: torch.Tensor, scale_override: int = 0,
            cfar: CfarParams = CfarParams(), ref_angle: int = 0,
            guard_angle: int = 0, need_debug: bool = False,
            prepadded_angle: bool = False):
    """Angle-extended CFAR over (..., A, R, D) magnitude cubes, one
    (range, Doppler) map per beam, float32 or integer; for the OS variant
    the plain twin of ``csrc/cfar_3d_detect.cu``.  Semantics of
    ``fmcw_tpu/ops/cfar.cfar_3d``:

    * ``ref_angle == 0``: ``cfar_2d`` on each beam's map;
    * ``ref_angle > 0``: the training set is the 3D box of +-(ref_angle +
      guard_angle) beam planes minus the guard box on the planes within
      +-guard_angle (``_offsets_3d``), every axis padded with
      ``cfar.edge_mode`` (the beam axis too: with wrap edges beam 0's da=-1
      neighbour is beam A-1, with reflect beam 1); the rank follows
      ``cfar.rank_pct`` on the enlarged n_ref, and the adaptive scale is
      always per cell (``cfar.scale_mode`` does not apply, as in JAX).

    CA / GO / SO (``ref_angle > 0``, no kernel; JAX's XLA body): CA the
    training mean; GO / SO the greater / smaller of the means of the lead
    and lag sets, the training offsets with dr < -guard_range and dr >
    guard_range on every plane, each summed in offset order; then cut >
    est * scale directly.

    Returns ``(det, threshold, scale)`` like ``cfar_2d`` (``threshold`` only
    with ``need_debug``: for OS it stacks n_ref values per cell).  OS is
    decided by counting.  The training-set sum is taken in the order of JAX's
    angle-extended kernel with wrap edges (``cfar_pallas._kernel_detect_3d``)
    on the padded cube, under either edge mode: planes da ascending, in each
    the column sums (dr ascending) of the padded columns d + dd added dd
    ascending, then each guard cell of the |da| <= guard_angle planes
    subtracted, dd outer and dr inner.  Under reflect JAX sums the training
    offsets in ``_offsets_3d`` order instead (its kernel's direct loop, its
    XLA body's ``jnp.sum``): integer sums are the same, but a float mean
    may differ from JAX's in its last bits, and with it a float scale at
    an exact class boundary.  ``csrc/cfar_3d_detect.cu``'s reflect entry
    keeps this function's order, bit for bit.

    ``prepadded_angle`` (``ref_angle > 0``): the cube is a beam shard that
    carries ``ref_angle + guard_angle`` planes of its neighbours on each side
    (the sharded array model's beam-halo exchange), (..., A + 2 ha, R, D);
    the beam axis is not padded (a reflect shard's halo planes arrive
    mirrored at the global edges) and the outputs cover the A interior
    planes."""
    if prepadded_angle and ref_angle == 0:
        raise ValueError("prepadded_angle needs ref_angle > 0")
    if ref_angle < 0 or guard_angle < 0:
        raise ValueError(f"ref_angle and guard_angle must be >= 0, got "
                         f"{ref_angle}, {guard_angle}")
    if ref_angle == 0:
        return cfar_2d(cube, scale_override, cfar, need_debug)
    check_supported(cfar)
    m = _as_map(cube)
    offs = _offsets_3d(cfar, ref_angle, guard_angle)
    n_ref = len(offs)
    k = n_ref - min((n_ref * cfar.rank_pct) // 100, n_ref - 1)
    ha = ref_angle + guard_angle
    hr, hd = cfar.halo_range, cfar.halo_doppler
    edge = cfar.edge_mode
    p = _axis_pad(_axis_pad(m, -2, hr, edge), -1, hd, edge)
    if prepadded_angle:
        m = m[..., ha:m.shape[-3] - ha, :, :]
    else:
        p = _axis_pad(p, -3, ha, edge)
    A, R, D = m.shape[-3:]

    def view(da, dr, dd):
        return p[..., ha + da:ha + da + A, hr + dr:hr + dr + R,
                 hd + dd:hd + dd + D]

    das = sorted({da for da, _, _ in offs})
    acc = None
    for da in das:
        # Column sums of every padded column; t[d] = col[hd + d + dd].
        col = p[..., ha + da:ha + da + A, 0:R, :]
        for dr in range(-hr + 1, hr + 1):
            col = col + p[..., ha + da:ha + da + A, hr + dr:hr + dr + R, :]
        for dd in range(-hd, hd + 1):
            t = col[..., hd + dd:hd + dd + D]
            acc = t if acc is None else acc + t
    for da in das:
        if abs(da) > guard_angle:
            continue
        for dd in range(-cfar.guard_doppler, cfar.guard_doppler + 1):
            for dr in range(-cfar.guard_range, cfar.guard_range + 1):
                acc = acc - view(da, dr, dd)
    t_hi, t_lo = _thresholds(_div(acc, n_ref))
    if cfar.variant != "os":
        if cfar.variant == "ca":
            est = _div(acc, n_ref)
        else:
            gr = cfar.guard_range
            lead = [o for o in offs if o[1] < -gr]
            lag = [o for o in offs if o[1] > gr]
            means = []
            for half in (lead, lag):
                s = view(*half[0])
                for o in half[1:]:
                    s = s + view(*o)
                means.append(_div(s, len(half)))
            pick = torch.maximum if cfar.variant == "go" else torch.minimum
            est = pick(*means)
        return _decide_direct(m, est, _classify(est, t_hi, t_lo, cfar),
                              scale_override, need_debug)
    cnt_hi = torch.zeros(m.shape, dtype=torch.int32, device=m.device)
    cnt_lo = torch.zeros_like(cnt_hi)
    for o in offs:
        v = view(*o)
        cnt_hi += v > t_hi
        cnt_lo += v >= t_lo
    scale = torch.where(cnt_hi >= k, cfar.scale_max,
                        torch.where(cnt_lo < k, cfar.scale_min,
                                    cfar.scale_nom)).to(torch.int32)
    scale = _fold_override(scale, scale_override)
    if m.is_floating_point():
        q = _q_min(m, scale.to(torch.float32))
    else:
        q = torch.div(m - 1, scale, rounding_mode="floor") + 1
    cnt = torch.zeros(m.shape, dtype=torch.int32, device=m.device)
    for o in offs:
        cnt += view(*o) >= q
    det = torch.where((cnt < k) & (m > 0), m, torch.zeros_like(m))
    threshold = None
    if need_debug:
        refs = torch.stack([view(*o) for o in offs], dim=-1)
        est = torch.topk(refs, k, dim=-1).values[..., -1]
        threshold = est * (scale.to(m.dtype))
    return det, threshold, scale


def cfar_1d(x: torch.Tensor, ref_cells: int = 8, guard_cells: int = 2,
            rank_idx: int = 12, scaling_mult: int = 4, scaling_div: int = 1,
            axis: int = -1, edge_mode: str = "wrap") -> torch.Tensor:
    """1D OS-CFAR along ``axis`` (rtl/old/os_cfar.vhd: the rank_idx-th
    ascending value of the 2 ref_cells training cells beyond guard_cells
    on each side, a fixed threshold est * scaling_mult / scaling_div), the
    CUT kept where it exceeds the threshold, else 0.  Port of
    ``fmcw_tpu/ops/cfar.cfar_1d``: integer inputs floor-divide the
    threshold (in int32 or wider, so that est * scaling_mult cannot wrap),
    float inputs multiply by scaling_mult / scaling_div.  ``edge_mode``
    "wrap" or "reflect" (numpy's: the edge cell not repeated)."""
    x = x.movedim(axis, -1)
    n = x.shape[-1]
    offs = ([-(guard_cells + i) - 1 for i in range(ref_cells)]
            + [guard_cells + i + 1 for i in range(ref_cells)])
    pos = torch.arange(n, device=x.device)
    if edge_mode == "wrap":
        idx = [(pos + o) % n for o in offs]
    elif edge_mode == "reflect":
        if ref_cells + guard_cells >= n:
            raise ValueError(f"reflect edges need more than "
                             f"{ref_cells + guard_cells} cells, got {n}")
        idx = []
        for o in offs:
            i = (pos + o).abs()
            idx.append(torch.where(i >= n, 2 * (n - 1) - i, i))
    else:
        raise ValueError(f"edge_mode must be 'wrap' or 'reflect', got "
                         f"{edge_mode!r}")
    refs = torch.stack([x[..., i] for i in idx], dim=-1)
    est = torch.sort(refs, dim=-1).values[..., rank_idx]
    if x.is_floating_point():
        threshold = est * (scaling_mult / scaling_div)
    else:
        wide = torch.promote_types(x.dtype, torch.int32)
        threshold = torch.div(est.to(wide) * scaling_mult, scaling_div,
                              rounding_mode="floor")
    out = torch.where(x > threshold, x, torch.zeros_like(x))
    return out.movedim(-1, axis)


def cfar_2d_group(mag: torch.Tensor, scale_override: int = 0, *,
                  cfar: CfarParams, scale_map: torch.Tensor | None = None,
                  peak_group_radius: int = 0):
    """The staged routes' CFAR step in plain PyTorch: ``cfar_2d``, then
    ``peak_group`` of its det map, the row maxima of the grouped map's
    positive cells (0 where a row has none) and its detection count:
    ``(det, scale, row_max, n_dets)``, the outputs of
    ``ops/cfar_detect.cfar_detect_group``."""
    det, _, scale = cfar_2d(mag, scale_override, cfar, scale_map=scale_map)
    return group_and_count(det, scale, peak_group_radius)


def group_and_count(det: torch.Tensor, scale: torch.Tensor, radius: int):
    """``(peak_group(det, radius), scale, row maxima of the grouped map's
    positive cells (0 where a row has none), its detection count)``: the
    outputs of a grouping CFAR step."""
    det = peak_group(det, radius)
    return (det, scale, det.clamp(min=0).amax(dim=-1),
            (det > 0).sum(dim=(-2, -1)).to(torch.int32))


def peak_group(det: torch.Tensor, radius: int = 1,
               row_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Peak grouping: keep detections that are the strict local max of their
    (2r+1)^2 wrapped neighborhood, ties broken toward the lower linear index
    (row * D + col) — the semantics of fmcw_tpu/ops/cfar.peak_group.  Float
    or integer maps.

    ``row_ids``: the global row index of each row (R,) — for a range shard
    extended by ``radius`` halo rows on each side, so that ties break by
    the same ids as on the whole map, also across its wrap seam; only the
    rows at least ``radius`` from the shard's edges are then meaningful."""
    if radius <= 0:
        return det
    R, D = det.shape[-2:]
    p = _wrap_pad(det, radius, radius)
    rows = (torch.arange(R, device=det.device, dtype=torch.int32)
            if row_ids is None else
            torch.as_tensor(row_ids, device=det.device).to(torch.int32))
    ids = (rows[:, None] * D
           + torch.arange(D, device=det.device, dtype=torch.int32)[None, :])
    pid = _wrap_pad(ids, radius, radius)
    lowest = (float("-inf") if det.is_floating_point()
              else torch.iinfo(det.dtype).min)
    best = torch.full_like(det, lowest)
    best_id = torch.zeros(det.shape, dtype=torch.int32, device=det.device)
    for dr in range(2 * radius + 1):
        for dd in range(2 * radius + 1):
            nb = p[..., dr:dr + R, dd:dd + D]
            nid = pid[dr:dr + R, dd:dd + D]
            take = (nb > best) | ((nb == best) & (nid < best_id))
            best = torch.where(take, nb, best)
            best_id = torch.where(take, nid, best_id)
    keep = (det > 0) & (best == det) & (best_id == ids)
    return torch.where(keep, det, torch.zeros_like(det))


def peak_group_beams(det: torch.Tensor, radius: int = 1,
                     beam_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Beam-axis peak grouping of (..., n_beams, R, D) detection cubes: keep
    det[b, r, d] only if it is the maximum over beams b-radius..b+radius at
    the SAME (r, d) cell, ties toward the lower beam.  The beam axis is not
    periodic: a missing neighbour beyond an edge counts as 0, which never
    beats a detection.  Semantics of ``fmcw_tpu/ops/cfar.peak_group_beams``;
    the plain twin of ``csrc/beam_group.cu``.

    ``beam_ids``: the global beam index of each plane (a halo-extended beam
    shard), so that the strict-compare direction follows global beam
    order; None is the contiguous case."""
    m = det
    B = m.shape[-3]
    keep = m > 0
    if beam_ids is None:
        for o in range(1, radius + 1):
            up = torch.zeros_like(m)                     # beam b + o
            dn = torch.zeros_like(m)                     # beam b - o
            if o < B:
                up[..., :B - o, :, :] = m[..., o:, :, :]
                dn[..., o:, :, :] = m[..., :B - o, :, :]
            # Tie toward the lower beam: a lower-index neighbour wins equals.
            keep &= (m >= up) & (m > dn)
        return torch.where(keep, m, torch.zeros_like(m))
    b_ids = torch.as_tensor(beam_ids, device=m.device).to(torch.int64)
    for o in range(-radius, radius + 1):
        if o == 0:
            continue
        nb = torch.roll(m, -o, dims=-3)
        nid = torch.roll(b_ids, -o)
        # Rolled-in wrap planes do not count: the beam axis has edges.
        valid = ((nid - b_ids) == o)[:, None, None]
        nb = torch.where(valid, nb, torch.zeros_like(nb))
        keep &= (m > nb) if o < 0 else (m >= nb)
    return torch.where(keep, m, torch.zeros_like(m))


# ---------------------------------------------------------------------------
# The hw-compat streaming CFAR (the as-built os_cfar_2d.vhd)
# ---------------------------------------------------------------------------

def check_hw_stream(cfar: CfarParams) -> None:
    if cfar.variant != "os" or cfar.scale_mode != "cell":
        raise ValueError(
            "the hw-compat streaming CFAR reproduces the as-built hardware "
            "detector: per-cell OS variant only (os_cfar_2d.vhd has no "
            "CA/GO/SO or block-scale counterpart)")


def hw_stream_params(cfar: CfarParams) -> CfarParams:
    """The crossed geometry as named-axis CfarParams over the padded
    buffer's rows (the range axis, governed by the Doppler generics) and
    lanes (the stream's Doppler axis, governed by the range generics)."""
    return dataclasses.replace(cfar, ref_range=cfar.ref_doppler,
                               ref_doppler=cfar.ref_range,
                               guard_range=cfar.guard_doppler,
                               guard_doppler=cfar.guard_range)


def hw_stream_padded(ext: torch.Tensor, start0: int, R: int, D: int,
                     cfar: CfarParams) -> torch.Tensor:
    """The row-carry-baked padded buffer of ``fmcw_tpu/ops/cfar.
    _hw_stream_decide_pallas`` as a view of the ext streams (..., L):
    (..., R + 2 Hr, D + 2 Hd), row e the stream cells [base + e D - Hd,
    base + e D + D + Hd), base = start0 - Hr D, with Hr = halo_doppler
    rows and Hd = halo_range lanes (the crossed axes).  A padded lane j < 0
    of row r is lane D + j of row r - 1: the flat stream's row carry."""
    hr, hd = cfar.halo_doppler, cfar.halo_range
    lo = start0 - hr * D - hd
    if lo < 0 or start0 + (R + hr) * D + hd > ext.shape[-1]:
        raise ValueError(f"ext streams of {ext.shape[-1]} cells do not hold "
                         f"the windows of {R}x{D} cells from {start0}")
    return ext[..., lo:].unfold(-1, D + 2 * hd, D)[..., :R + 2 * hr, :]


def check_hw_stream_ext(ext: torch.Tensor, integer: bool) -> None:
    want = torch.int32 if integer else torch.float32
    if ext.dtype != want:
        raise ValueError(f"integer={integer} takes {want} ext streams, got "
                         f"{ext.dtype}")


def hw_stream_decide_plain(ext: torch.Tensor, start0: int, R: int, D: int,
                           scale_override: int = 0, *, cfar: CfarParams,
                           integer: bool):
    """Plain twin of ``csrc/cfar_detect.cu``'s flat-stream entry: the
    per-cell decisions of R x D stream cells from ``start0`` of the ext
    streams (..., L) (int32 for ``integer``, else float32), by counting on
    ``hw_stream_padded`` with ``hw_stream_params`` — ``cfar_2d``'s mean (box
    sums of column sums) and counts.  Returns ``(det, scale)``, each (...,
    R, D) in decision (true-cell) order: det in the stream's type, scale
    int32 (``scale_override`` folded in)."""
    check_hw_stream(cfar)
    check_hw_stream_ext(ext, integer)
    det, _, scale = cfar_2d(hw_stream_padded(ext, start0, R, D, cfar),
                            scale_override, hw_stream_params(cfar),
                            prepadded_range="both")
    return det, scale


def _hw_stream_est(ext: torch.Tensor, start0: int, S: int, D: int,
                   cfar: CfarParams) -> torch.Tensor:
    """The order statistic over the n_ref flat-stream views (the
    dbg_threshold tap's est, ``_hw_stream_decide_xla``), a frame at a time:
    a full-size frame stacks S x n_ref values (64 MiB at 1024x128)."""
    offs = [dr * D + dc for dr, dc in _hw_stream_offsets(cfar)]
    k = cfar.n_ref - cfar.rank_idx
    *lead, L = ext.shape
    flat = ext.reshape(-1, L)
    out = torch.empty((flat.shape[0], S), dtype=ext.dtype, device=ext.device)
    for b in range(flat.shape[0]):
        refs = torch.stack([flat[b, start0 + o:start0 + o + S] for o in offs],
                           dim=-1)
        out[b] = torch.topk(refs, k, dim=-1).values[..., -1]
    return out.reshape(*lead, S)


def cfar_2d_hw_stream(mag: torch.Tensor, scale_override: int = 0, *,
                      cfar: CfarParams = CfarParams(), integer: bool = True,
                      hist: torch.Tensor | None = None,
                      streaming: bool = False, first: bool = False,
                      need_debug: bool = False, label_roll: bool = True,
                      decide=None):
    """As-built streaming-CFAR geometry over (..., R, D) maps, each its own
    stream; port of ``fmcw_tpu/ops/cfar.cfar_2d_hw_stream`` (its framings,
    emission window, label roll and carry; golden ``os_cfar_2d_hw_stream``
    is the bit-exact oracle).  ``integer``: integer maps (any integer dtype,
    decided in int32) or float32 maps.

    * ``streaming=False``: the frame is the whole stream (one-shot / first
      frame); the final ``lag`` cells are never emitted.
    * ``streaming=True`` with ``hist`` (..., 2 lag), the previous frame's
      last 2 lag cells: decides stream positions [-lag, S - lag) and also
      returns ``new_hist``.  Without ``hist`` it is the stream's first
      frame (zero history and the startup skip).

    Returns ``(det, threshold, scale[, new_hist])``: det (..., R, D) at
    the hardware's label coordinates (``label_roll=False``: in decision
    order; apply ``hw_stream_label_shift`` after grouping) in the map's
    dtype; threshold (decision order, int32 or float32) only with
    ``need_debug``, else None; scale int32 in decision order; new_hist in
    the map's dtype.  ``decide``: the decision function,
    ``hw_stream_decide_plain`` (default) or the kernel wrapper
    ``ops/cfar_detect.cfar_detect_hw_stream``, with its signature."""
    check_hw_stream(cfar)
    if integer == mag.is_floating_point():
        raise ValueError(f"integer={integer} does not fit a {mag.dtype} map")
    *lead, R, D = mag.shape
    S = R * D
    lag = hw_stream_lag(cfar, D)
    work = torch.int32 if integer else torch.float32
    flat = mag.reshape(*lead, S).to(work)
    zeros = flat.new_zeros((*lead, 2 * lag))
    if streaming and hist is None:
        first = True            # no history IS the stream's first frame
    h = (torch.as_tensor(hist, device=flat.device).to(work).reshape(
        *lead, 2 * lag) if streaming and hist is not None else zeros)
    ext = torch.cat([h, flat, zeros[..., :lag]], dim=-1)
    base = -lag if streaming else 0
    start0 = 2 * lag + base
    det, scale = (decide or hw_stream_decide_plain)(
        ext, start0, R, D, scale_override, cfar=cfar, integer=integer)
    det = det.reshape(*lead, S)
    scale = scale.reshape(*lead, S)
    threshold = None
    if need_debug:
        est = _hw_stream_est(ext, start0, S, D, cfar)
        threshold = (est * scale.to(work)).reshape(*lead, R, D)
    pos = torch.arange(S, device=flat.device) + base     # stream positions
    if streaming:
        emitted = pos >= 3 if first else None
        shift = lag + 3
    else:
        emitted = (pos >= 3) & (pos < S - lag)
        shift = 3
    if emitted is not None:
        det = torch.where(emitted, det, torch.zeros_like(det))
    if label_roll:
        det = torch.roll(det, -shift, dims=-1)
    out = (det.reshape(*lead, R, D).to(mag.dtype), threshold,
           scale.reshape(*lead, R, D))
    if streaming:
        return out + (flat[..., -2 * lag:].to(mag.dtype),)
    return out


def hw_stream_label_shift(cfar: CfarParams, n_doppler: int,
                          streaming: bool) -> int:
    """Flat-cell shift from decision order to the hardware's label
    coordinates for ``cfar_2d_hw_stream(label_roll=False)``: roll each
    map's flat cells by -shift after peak grouping, which runs in decision
    order (physical adjacency)."""
    return (hw_stream_lag(cfar, n_doppler) + 3) if streaming else 3
